// Unpacked point sweeps for Hopper (sm_90a): the CUDA counterpart of the
// JAX package's fused sweep kernel K4, cubez_tpu/pallas_kernels/sweeps.py:416
// (make_fused_sweep -> _sweep_kernel), in its four forms: Jacobi and
// red-black, constant coefficients and MAF, each with a zero or a streamed
// right-hand side.
//
// Layout: the (K, I, J) field as it is, J contiguous, no padding (the TPU
// kernel's K pad of 2 and (8, 128) tile padding were for its DMA slabs).
// One block per (k, i) row, its threads striding over j, so no thread
// divides a flat index; the kernels mask on the true bounds and never read
// outside the array.
//
// jacobi_kernel: one iteration, OUT OF PLACE.  The TPU kernel updates in
// place only because its slab pipeline reads every row before it writes
// it; here blocks run in no order and would read neighbours that another
// block has already updated.  It writes every point of ``out`` (the
// boundary shell copied), never ``x``.
// rb_color_unpacked_kernel: one colour of one red-black iteration, in
// place (a colour reads only the other colour).  Colour c holds the points
// with (i + j + k + offset + 1) % 2 == c, as the TPU kernel's _iota_masks.
//
// Arithmetic contracts: common.cuh const_dp and maf_dp, bitwise equal to
// the plain twins in float32 (cuda_kernels/sweeps.py).
//
// What bounds them on an H100: the Jacobi pass reads the field once and
// writes it once (a colour pass reads it and writes half); at 128^3
// float32 (8.4 MB a field) both fields stay in the 50 MB L2, so launch
// latency and per-point instructions bound it, and at 512^3 the HBM bytes
// do.  A colour pass touches every cache line of the row for half the
// points.  The design is the simple one: one launch per pass, no shared
// memory tiling; keeping planes on chip is later work.
//
// Residuals: each block reduces its sum of dp^2 in a fixed order into
// partials[block] (float for float fields, double for double); no atomics.
// The host folds the partials in float64.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

using namespace cz;

constexpr int kJacobiThreads = 128;
constexpr int kColourThreads = 64;

// dp at interior point p = (k, i, j) of the unpacked field x.
template <typename T, bool kMaf>
__device__ __forceinline__ T point_dp(const T* __restrict__ x, const T* __restrict__ b,
                                      const T* __restrict__ tab, size_t p, unsigned k,
                                      unsigned i, unsigned j, unsigned K, unsigned I,
                                      unsigned J, T omega) {
  const size_t plane = size_t(I) * J;
  const T* bp = b != nullptr ? b + p : nullptr;
  if constexpr (kMaf) {
    const MafTables<T> w(tab, K, I, J);
    return maf_dp(w, k, i, j, x[p - plane], x[p + plane], x[p + J], x[p - J], x[p + 1],
                  x[p - 1], bp, x[p], omega);
  } else {
    return const_dp(x[p - plane], x[p + plane], x[p + J], x[p - J], x[p + 1], x[p - 1], bp,
                    x[p], omega);
  }
}

// One Jacobi iteration, x -> out; one block per (k, i) row of all K*I.
template <typename T, bool kMaf>
__global__ void __launch_bounds__(kJacobiThreads) jacobi_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ tab,
    T* __restrict__ out, T* partials, int K, int I, int J, T omega) {
  const unsigned k = blockIdx.x / unsigned(I);
  const unsigned i = blockIdx.x % unsigned(I);
  const bool row_inner = k >= 1 && k + 2 <= unsigned(K) && i >= 1 && i + 2 <= unsigned(I);
  const size_t base = (size_t(k) * I + i) * J;
  T acc = 0;
  for (unsigned j = threadIdx.x; j < unsigned(J); j += kJacobiThreads) {
    const size_t p = base + j;
    if (row_inner && j >= 1 && j + 2 <= unsigned(J)) {
      const T dp = point_dp<T, kMaf>(x, b, tab, p, k, i, j, K, I, J, omega);
      out[p] = add_rn(x[p], dp);
      acc += dp * dp;
    } else {
      out[p] = x[p];
    }
  }
  const T tot = block_sum<kJacobiThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// One colour of one red-black iteration, in place; one block per interior
// (k, i) row, its threads on that row's points of the colour.
template <typename T, bool kMaf>
__global__ void __launch_bounds__(kColourThreads) rb_color_unpacked_kernel(
    T* x, const T* __restrict__ b, const T* __restrict__ tab,
    T* partials, int K, int I, int J, int colour, int offset, T omega) {
  const unsigned k = 1 + blockIdx.x / unsigned(I - 2);
  const unsigned i = 1 + blockIdx.x % unsigned(I - 2);
  // (i + j + k + offset + 1) % 2 == colour  <=>  j % 2 == jpar
  const unsigned jpar = (unsigned(colour) + i + k + unsigned(offset) + 1u) & 1u;
  const size_t base = (size_t(k) * I + i) * J;
  T acc = 0;
  for (unsigned j = (jpar ? 1u : 2u) + 2u * threadIdx.x; j + 2 <= unsigned(J);
       j += 2u * kColourThreads) {
    const size_t p = base + j;
    const T dp = point_dp<T, kMaf>(x, b, tab, p, k, i, j, K, I, J, omega);
    x[p] = add_rn(x[p], dp);
    acc += dp * dp;
  }
  const T tot = block_sum<kColourThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

template <typename T>
int launch_jacobi(const void* x, const void* b, const void* tab, void* out, void* partials,
                  int K, int I, int J, double omega, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  auto kernel = tab != nullptr ? jacobi_kernel<T, true> : jacobi_kernel<T, false>;
  kernel<<<unsigned(K) * unsigned(I), kJacobiThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(tab),
      static_cast<T*>(out), static_cast<T*>(partials), K, I, J, T(omega));
  return cudaGetLastError();
}

template <typename T>
int launch_rb_color(void* x, const void* b, const void* tab, void* partials, int K, int I,
                    int J, int colour, int offset, double omega, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  auto kernel =
      tab != nullptr ? rb_color_unpacked_kernel<T, true> : rb_color_unpacked_kernel<T, false>;
  kernel<<<unsigned(K - 2) * unsigned(I - 2), kColourThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<const T*>(b), static_cast<const T*>(tab),
      static_cast<T*>(partials), K, I, J, colour, offset, T(omega));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_k4_jacobi_f32(const void* x, const void* b, const void* tab, void* out,
                     void* partials, int K, int I, int J, double omega, int device,
                     void* stream) {
  return launch_jacobi<float>(x, b, tab, out, partials, K, I, J, omega, device, stream);
}

int cz_k4_jacobi_f64(const void* x, const void* b, const void* tab, void* out,
                     void* partials, int K, int I, int J, double omega, int device,
                     void* stream) {
  return launch_jacobi<double>(x, b, tab, out, partials, K, I, J, omega, device, stream);
}

int cz_k4_rb_color_f32(void* x, const void* b, const void* tab, void* partials, int K,
                       int I, int J, int colour, int offset, double omega, int device,
                       void* stream) {
  return launch_rb_color<float>(x, b, tab, partials, K, I, J, colour, offset, omega, device,
                                stream);
}

int cz_k4_rb_color_f64(void* x, const void* b, const void* tab, void* partials, int K,
                       int I, int J, int colour, int offset, double omega, int device,
                       void* stream) {
  return launch_rb_color<double>(x, b, tab, partials, K, I, J, colour, offset, omega,
                                 device, stream);
}

}  // extern "C"
