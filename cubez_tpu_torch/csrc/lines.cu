// Line relaxation on the unpacked field for Hopper (sm_90a): the CUDA
// counterpart of the JAX package's fused line kernel K6,
// cubez_tpu/pallas_kernels/lines.py:441 (make_line_step -> _line_kernel),
// in its two kinds, each with constant coefficients or MAF and a zero or a
// streamed right-hand side:
//
// line_jacobi_kernel (kind pcr_j, the reference's pcr_j_esa): every inner
// line from the pre-sweep field, OUT OF PLACE: it writes every value of
// ``out`` (face lines and the k = 0 and K-1 planes copied) and never
// ``x``.
// line_rb_color_kernel (kind pcr_rb, the odd-I fallback of K5): the lines
// of one colour, (i + j + offset) % 2 == colour, in place; two launches
// make an iteration, and colour 1 sees colour 0's update.  A line's four
// neighbours are all of the other colour, so in place is safe.
//
// Layout: the (K, I, J) field as it is, J contiguous.  The TPU kernel's
// (I+4, Kp, Jp) line layout, its (8, 128) padding, its I-halo and its VMEM
// slab sizing are dropped.
//
// The solve: Thomas, O(n) per line, in place of the TPU kernel's dense
// T^-1 d / fast-diagonalization matmuls (2n flops per point on the MXU;
// here about 8, and no (n, n) matrix to hold on chip), on line_tile.cuh's
// shared-memory tile: a CTA takes L lines along j of one row i (every j
// for line-Jacobi, every other j for a colour), whole in K, builds their
// right-hand sides with all its threads, runs the recurrences a thread a
// line out of shared memory and writes the lines back once.  No global
// scratch.
//
// What bounds them on an H100: a line-Jacobi pass must read x and write
// out once, 2 fields (1.07 GB at 512^3 float32, 320 us at 3.35 TB/s); a
// colour pass reads both colours and writes its own.  Before the tile
// (one thread a line, the forward values in a global scratch) the serial
// k loop waited out an L2 round trip a step: 61 us at 128^3, about 240 ns
// a k step, and about 1.25 ms at 512^3 (H100 80GB HBM3).
//
// Residuals: each tile folds its sum of dp^2 in a fixed order into
// partials[tile] (T); no atomics.  The host folds the partials in float64.
// K9's 'fastdiag' form (dist_pcr.cu) runs the same tile on its ghosted
// blocks.

#include <cuda_runtime.h>

#include "line_tile.cuh"

namespace {

using namespace cz;

// Line-Jacobi: row i, lane j, every line of the plane.
struct JacobiLines {
  unsigned I, J;
  __device__ __forceinline__ TileLine at(unsigned i, unsigned j) const {
    TileLine t{};
    t.i = i;
    t.j = j;
    t.valid = j < J;
    t.inner = t.valid && i >= 1 && i + 2 <= I && j >= 1 && j + 2 <= J;
    t.own = i * J + j;
    t.ip = t.own + J;
    t.im = t.own - J;
    t.jp = t.own + 1;
    t.jm = t.own - 1;
    return t;
  }
};

// One colour: row i, lane p, the colour's j = 2 p + (i + offset + colour) % 2.
struct ColourLines {
  unsigned I, J, parity;  // parity = offset + colour
  __device__ __forceinline__ TileLine at(unsigned i, unsigned p) const {
    TileLine t{};
    const unsigned j = 2 * p + ((i + parity) & 1u);
    t.i = i;
    t.j = j;
    t.valid = j < J;
    t.inner = t.valid && i >= 1 && i + 2 <= I && j >= 1 && j + 2 <= J;
    t.own = i * J + j;
    t.ip = t.own + J;
    t.im = t.own - J;
    t.jp = t.own + 1;
    t.jm = t.own - 1;
    return t;
  }
};

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kTileMaxThreads) line_jacobi_kernel(JacobiLines g,
                                                                       TileArgs<T> a) {
  relax_tile<T, kMaf, true>(g, a);
}

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kTileMaxThreads) line_rb_color_kernel(ColourLines g,
                                                                         TileArgs<T> a) {
  relax_tile<T, kMaf, false>(g, a);
}

template <typename T>
int launch_jacobi(const void* x, const void* b, const void* lt, void* out, void* partials,
                  int K, int I, int J, double omega, int maf, int lines, int threads,
                  int tiles, int device, void* stream) {
  const TileArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out),
                      static_cast<const T*>(b), static_cast<const T*>(lt),
                      static_cast<T*>(partials), unsigned(I) * J, K, I, J, unsigned(J), lines,
                      T(omega)};
  const JacobiLines g{unsigned(I), unsigned(J)};
  auto kernel = maf ? line_jacobi_kernel<T, true> : line_jacobi_kernel<T, false>;
  return launch_tiles<T>(kernel, unsigned(tiles), tile_count(I, J, lines), threads, K, lines,
                         maf, device, stream, g, a);
}

template <typename T>
int launch_rb_color(void* x, const void* b, const void* lt, void* partials, int K, int I,
                    int J, int colour, int offset, double omega, int maf, int lines,
                    int threads, int tiles, int device, void* stream) {
  const unsigned half = (unsigned(J) + 1) / 2;
  // x is both the neighbours (the other colour, read only) and the
  // relaxed field (this colour's inner values): see line_tile.cuh
  const TileArgs<T> a{static_cast<const T*>(x), static_cast<T*>(x),
                      static_cast<const T*>(b), static_cast<const T*>(lt),
                      static_cast<T*>(partials), unsigned(I) * J, K, I, J, half, lines,
                      T(omega)};
  const ColourLines g{unsigned(I), unsigned(J), unsigned(offset + colour)};
  auto kernel = maf ? line_rb_color_kernel<T, true> : line_rb_color_kernel<T, false>;
  return launch_tiles<T>(kernel, unsigned(tiles), tile_count(I, half, lines), threads, K,
                         lines, maf, device, stream, g, a);
}

}  // namespace

extern "C" {

int cz_line_j_f32(const void* x, const void* b, const void* lt, void* out, void* partials,
                  int K, int I, int J, double omega, int maf, int lines, int threads,
                  int tiles, int device, void* stream) {
  return launch_jacobi<float>(x, b, lt, out, partials, K, I, J, omega, maf, lines, threads,
                              tiles, device, stream);
}

int cz_line_j_f64(const void* x, const void* b, const void* lt, void* out, void* partials,
                  int K, int I, int J, double omega, int maf, int lines, int threads,
                  int tiles, int device, void* stream) {
  return launch_jacobi<double>(x, b, lt, out, partials, K, I, J, omega, maf, lines, threads,
                               tiles, device, stream);
}

int cz_line_rb_color_f32(void* x, const void* b, const void* lt, void* partials, int K, int I,
                         int J, int colour, int offset, double omega, int maf, int lines,
                         int threads, int tiles, int device, void* stream) {
  return launch_rb_color<float>(x, b, lt, partials, K, I, J, colour, offset, omega, maf,
                                lines, threads, tiles, device, stream);
}

int cz_line_rb_color_f64(void* x, const void* b, const void* lt, void* partials, int K, int I,
                         int J, int colour, int offset, double omega, int maf, int lines,
                         int threads, int tiles, int device, void* stream) {
  return launch_rb_color<double>(x, b, lt, partials, K, I, J, colour, offset, omega, maf,
                                 lines, threads, tiles, device, stream);
}

}  // extern "C"
