// Red-black line relaxation on the colour-packed line layout for Hopper
// (sm_90a): the CUDA counterpart of the JAX package's packed line kernel
// K5, cubez_tpu/pallas_kernels/rblines.py:407 (make_rbl_step ->
// _rbl_kernel), with constant coefficients or MAF and a zero or a streamed
// right-hand side.
//
// Layout (cuda_kernels/rblines.py::pack_rb_lines): (2, K, I/2, J), J
// contiguous.  Colour c, row i2, lane j holds the line at physical
// i = 2 i2 + s with s = (j + offset + c) % 2, so colour c holds the lines
// with (i + j + offset) % 2 == c and each colour is dense.  A line's colour
// does not depend on k, so the fold is the same on every plane.  Its
// neighbours are all of the other colour: j +- 1 at the same row i2, i + 1
// at row i2 + s and i - 1 at row i2 + s - 1 (rblines.py:24-29).  The TPU
// kernel's I-halo, (8, 128) padding and VMEM slab sizing are dropped.
//
// rbl_color_kernel: the lines of one colour, in place; two launches make
// an iteration, and colour 1 reads colour 0's update.  One thread per
// packed (i2, j) line, consecutive threads on consecutive j; the solve is
// lines.cuh's Thomas pass, with a scratch of one colour's size, (K, I/2,
// J), for the forward values and a second for the MAF factors.  The MAF
// tables are indexed by the physical i.
//
// What bounds it on an H100: per colour it reads the other colour's four
// lines and b, and writes and reads the scratch; at 128^3 float32 all of
// it sits in the 50 MB L2 and the 8,192 lines of a colour are too few
// threads to hide the latency of the serial k loop, so latency bounds it
// (H100 80GB HBM3: 54 us a colour at 128^3, about 214 ns per k step).  At
// 512^3 (131,072 lines a colour) the bytes do (about 2.7 GB an iteration
// in 1.35 ms).
//
// Residuals: per-block partials of dp^2 in a fixed order, no atomics; the
// host folds them in float64.

#include <cuda_runtime.h>

#include <cstddef>

#include "lines.cuh"

namespace {

using namespace cz;

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kLineThreads) rbl_color_kernel(
    T* xp, const T* __restrict__ bp, const T* __restrict__ lt, T* g, T* e, T* partials,
    int K, int I2, int J, int colour, int offset, T omega) {
  const unsigned line = blockIdx.x * kLineThreads + threadIdx.x;
  const size_t plane = size_t(I2) * J;
  T acc = 0;
  if (line < plane) {
    const unsigned i2 = line / unsigned(J);
    const unsigned j = line % unsigned(J);
    const unsigned s = (j + unsigned(offset + colour)) & 1u;
    const unsigned i = 2 * i2 + s;
    if (i >= 1 && i + 2 <= 2 * unsigned(I2) && j >= 1 && j + 2 <= unsigned(J)) {
      const size_t own = size_t(colour) * K * plane + line;
      const size_t oth = size_t(1 - colour) * K * plane;
      const LineAt at{own,
                      oth + size_t(i2 + s) * J + j,
                      oth + size_t(i2 + s - 1) * J + j,
                      oth + line + 1,
                      oth + line - 1,
                      plane,
                      line};
      acc = relax_line<T, kMaf>(xp, xp, xp, bp, g, e, at, lt, K, 2 * I2, J, i, j, omega);
    }
  }
  const T tot = block_sum<kLineThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

template <typename T>
int launch(void* xp, const void* bp, const void* lt, void* g, void* e, void* partials, int K,
           int I2, int J, int colour, int offset, double omega, int maf, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = maf ? rbl_color_kernel<T, true> : rbl_color_kernel<T, false>;
  const size_t lines = size_t(I2) * J;
  kernel<<<unsigned((lines + kLineThreads - 1) / kLineThreads), kLineThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(xp), static_cast<const T*>(bp), static_cast<const T*>(lt),
      static_cast<T*>(g), static_cast<T*>(e), static_cast<T*>(partials), K, I2, J, colour,
      offset, T(omega));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_rbl_color_f32(void* xp, const void* bp, const void* lt, void* g, void* e,
                     void* partials, int K, int I2, int J, int colour, int offset,
                     double omega, int maf, int device, void* stream) {
  return launch<float>(xp, bp, lt, g, e, partials, K, I2, J, colour, offset, omega, maf,
                       device, stream);
}

int cz_rbl_color_f64(void* xp, const void* bp, const void* lt, void* g, void* e,
                     void* partials, int K, int I2, int J, int colour, int offset,
                     double omega, int maf, int device, void* stream) {
  return launch<double>(xp, bp, lt, g, e, partials, K, I2, J, colour, offset, omega, maf,
                        device, stream);
}

}  // extern "C"
