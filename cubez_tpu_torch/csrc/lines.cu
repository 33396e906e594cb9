// Line relaxation on the unpacked field for Hopper (sm_90a): the CUDA
// counterpart of the JAX package's fused line kernel K6,
// cubez_tpu/pallas_kernels/lines.py:441 (make_line_step -> _line_kernel),
// in its two kinds, each with constant coefficients or MAF and a zero or a
// streamed right-hand side:
//
// line_jacobi_kernel (kind pcr_j, the reference's pcr_j_esa): every inner
// line from the pre-sweep field, OUT OF PLACE: it writes every value of
// ``out`` (boundary lines and planes copied) and never ``x``.  The forward
// values of the Thomas pass go to ``out`` itself (each is read back before
// it is overwritten), so the constant form needs no scratch and the MAF
// form one field for its factors e_k.
// line_rb_color_kernel (kind pcr_rb, the odd-I fallback of K5): the lines
// of one colour, (i + j + offset) % 2 == colour, in place; two launches
// make an iteration, and colour 1 sees colour 0's update.  A line's four
// neighbours are all of the other colour, so in place is safe.
//
// Layout: the (K, I, J) field as it is, J contiguous.  The TPU kernel's
// (I+4, Kp, Jp) line layout, its (8, 128) padding, its I-halo and its VMEM
// slab sizing are dropped.  One thread per (i, j) line, consecutive
// threads on consecutive j, so a warp reads a contiguous row at each k.
//
// The solve (lines.cuh): Thomas, O(n) per line, in place of the TPU
// kernel's dense T^-1 d / fast-diagonalization matmuls (2n flops per point
// on the MXU; here about 8, and no (n, n) matrix to hold on chip).
//
// What bounds them on an H100: a pass reads x's five lines and b, and
// writes and reads the scratch once; at 128^3 float32 the field and the
// scratch (8.4 MB each) stay in the 50 MB L2, and the 16,384 lines (8,192
// a colour) are too few threads to hide its latency along the serial k
// loop: latency bounds them (H100 80GB HBM3: line_jacobi_kernel 61 us at
// 128^3, about 240 ns per k step).  At 512^3 the 262,144 lines fill the
// card and the bytes bound it (about 2.1 GB in 1.25 ms).  Keeping lines on
// chip, or more loads in flight per thread, is later work.
//
// Residuals: each block reduces its sum of dp^2 in a fixed order into
// partials[block] (T); no atomics.  The host folds the partials in
// float64.

#include <cuda_runtime.h>

#include <cstddef>

#include "lines.cuh"

namespace {

using namespace cz;

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kLineThreads) line_jacobi_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ lt, T* out,
    T* e, T* partials, int K, int I, int J, T omega) {
  const unsigned line = blockIdx.x * kLineThreads + threadIdx.x;
  const size_t plane = size_t(I) * J;
  T acc = 0;
  if (line < plane) {
    const unsigned i = line / unsigned(J);
    const unsigned j = line % unsigned(J);
    if (i >= 1 && i + 2 <= unsigned(I) && j >= 1 && j + 2 <= unsigned(J)) {
      out[line] = x[line];
      out[line + size_t(K - 1) * plane] = x[line + size_t(K - 1) * plane];
      const LineAt at{line, line + J, line - J, line + 1, line - 1, plane, line};
      acc = relax_line<T, kMaf>(x, x, out, b, out, e, at, lt, K, I, J, i, j, omega);
    } else {
      for (int k = 0; k < K; ++k) out[line + k * plane] = x[line + k * plane];
    }
  }
  const T tot = block_sum<kLineThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// One colour of one red-black line iteration, in place; thread t of the
// I * ceil(J/2) takes row i = t / ceil(J/2) and the colour's j of pair
// t % ceil(J/2).
template <typename T, bool kMaf>
__global__ void __launch_bounds__(kLineThreads) line_rb_color_kernel(
    T* x, const T* __restrict__ b, const T* __restrict__ lt, T* g, T* e, T* partials, int K,
    int I, int J, int colour, int offset, T omega) {
  const unsigned half = (unsigned(J) + 1) / 2;
  const unsigned t = blockIdx.x * kLineThreads + threadIdx.x;
  T acc = 0;
  if (t < unsigned(I) * half) {
    const unsigned i = t / half;
    // (i + j + offset) % 2 == colour
    const unsigned j = 2 * (t % half) + ((i + unsigned(offset + colour)) & 1u);
    if (i >= 1 && i + 2 <= unsigned(I) && j >= 1 && j + 2 <= unsigned(J)) {
      const size_t p = size_t(i) * J + j;
      const LineAt at{p, p + J, p - J, p + 1, p - 1, size_t(I) * J, p};
      acc = relax_line<T, kMaf>(x, x, x, b, g, e, at, lt, K, I, J, i, j, omega);
    }
  }
  const T tot = block_sum<kLineThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

unsigned blocks(size_t threads) { return unsigned((threads + kLineThreads - 1) / kLineThreads); }

template <typename T>
int launch_jacobi(const void* x, const void* b, const void* lt, void* out, void* e,
                  void* partials, int K, int I, int J, double omega, int maf, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = maf ? line_jacobi_kernel<T, true> : line_jacobi_kernel<T, false>;
  kernel<<<blocks(size_t(I) * J), kLineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(lt),
      static_cast<T*>(out), static_cast<T*>(e), static_cast<T*>(partials), K, I, J,
      T(omega));
  return cudaGetLastError();
}

template <typename T>
int launch_rb_color(void* x, const void* b, const void* lt, void* g, void* e, void* partials,
                    int K, int I, int J, int colour, int offset, double omega, int maf,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = maf ? line_rb_color_kernel<T, true> : line_rb_color_kernel<T, false>;
  kernel<<<blocks(size_t(I) * ((J + 1) / 2)), kLineThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<const T*>(b), static_cast<const T*>(lt),
      static_cast<T*>(g), static_cast<T*>(e), static_cast<T*>(partials), K, I, J, colour,
      offset, T(omega));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_line_threads_per_block(void) { return kLineThreads; }

int cz_line_j_f32(const void* x, const void* b, const void* lt, void* out, void* e,
                  void* partials, int K, int I, int J, double omega, int maf, int device,
                  void* stream) {
  return launch_jacobi<float>(x, b, lt, out, e, partials, K, I, J, omega, maf, device,
                              stream);
}

int cz_line_j_f64(const void* x, const void* b, const void* lt, void* out, void* e,
                  void* partials, int K, int I, int J, double omega, int maf, int device,
                  void* stream) {
  return launch_jacobi<double>(x, b, lt, out, e, partials, K, I, J, omega, maf, device,
                               stream);
}

int cz_line_rb_color_f32(void* x, const void* b, const void* lt, void* g, void* e,
                         void* partials, int K, int I, int J, int colour, int offset,
                         double omega, int maf, int device, void* stream) {
  return launch_rb_color<float>(x, b, lt, g, e, partials, K, I, J, colour, offset, omega,
                                maf, device, stream);
}

int cz_line_rb_color_f64(void* x, const void* b, const void* lt, void* g, void* e,
                         void* partials, int K, int I, int J, int colour, int offset,
                         double omega, int maf, int device, void* stream) {
  return launch_rb_color<double>(x, b, lt, g, e, partials, K, I, J, colour, offset, omega,
                                 maf, device, stream);
}

}  // extern "C"
