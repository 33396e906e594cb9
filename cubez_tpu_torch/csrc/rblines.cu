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
// an iteration, and colour 1 reads colour 0's update.  The solve is
// line_tile.cuh's shared-memory tile: a CTA takes L consecutive packed
// lines (i2, j0 .. j0 + L - 1) of the colour, whole in K, so every load
// and store of a k row is L consecutive values.  No global scratch.  The
// MAF tables are indexed by the physical i.
//
// What bounds it on an H100: an iteration must read the field and write
// it once, 2 fields (1.07 GB at 512^3 float32, 320 us at 3.35 TB/s); the
// two colour launches move 3 (each reads both colours and writes its own:
// 1.61 GB, 480 us).  Before the tile (one thread a line, the forward
// values and the MAF factors in a global scratch) the serial k loop waited
// out an L2 round trip a step: 54 us a colour at 128^3, about 214 ns a k
// step, and at 512^3 2.7 GB an iteration in 1.35 ms (H100 80GB HBM3).
//
// Residuals: per-tile partials of dp^2 in a fixed order, no atomics; the
// host folds them in float64.

#include <cuda_runtime.h>

#include "line_tile.cuh"

namespace {

using namespace cz;

// One colour of the packed layout: row i2, lane j; own0 and oth0 are the
// first values of this colour's and the other colour's (K, I2, J) planes.
struct PackedLines {
  unsigned I2, J, parity;  // parity = offset + colour
  unsigned own0, oth0;
  __device__ __forceinline__ TileLine at(unsigned i2, unsigned j) const {
    TileLine t{};
    const unsigned s = (j + parity) & 1u;
    t.i = 2 * i2 + s;
    t.j = j;
    t.valid = j < J;
    t.inner = t.valid && t.i >= 1 && t.i + 2 <= 2 * I2 && j >= 1 && j + 2 <= J;
    const unsigned line = i2 * J + j;
    t.own = own0 + line;
    t.ip = oth0 + (i2 + s) * J + j;
    t.im = oth0 + (i2 + s - 1) * J + j;
    t.jp = oth0 + line + 1;
    t.jm = oth0 + line - 1;
    return t;
  }
};

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kTileMaxThreads) rbl_color_kernel(PackedLines g,
                                                                     TileArgs<T> a) {
  relax_tile<T, kMaf, false>(g, a);
}

template <typename T>
int launch(void* xp, const void* bp, const void* lt, void* partials, int K, int I2, int J,
           int colour, int offset, double omega, int maf, int lines, int threads, int tiles,
           int device, void* stream) {
  const unsigned plane = unsigned(I2) * J;
  // xp is both the neighbours (the other colour, read only) and the
  // relaxed field (this colour's inner values): see line_tile.cuh
  const TileArgs<T> a{static_cast<const T*>(xp), static_cast<T*>(xp),
                      static_cast<const T*>(bp), static_cast<const T*>(lt),
                      static_cast<T*>(partials), plane, K, 2 * I2, J, unsigned(J), lines,
                      T(omega)};
  const PackedLines g{unsigned(I2), unsigned(J), unsigned(offset + colour),
                      unsigned(colour) * K * plane, unsigned(1 - colour) * K * plane};
  auto kernel = maf ? rbl_color_kernel<T, true> : rbl_color_kernel<T, false>;
  return launch_tiles<T>(kernel, unsigned(tiles), tile_count(I2, J, lines), threads, K, lines,
                         maf, device, stream, g, a);
}

}  // namespace

extern "C" {

int cz_rbl_color_f32(void* xp, const void* bp, const void* lt, void* partials, int K, int I2,
                     int J, int colour, int offset, double omega, int maf, int lines,
                     int threads, int tiles, int device, void* stream) {
  return launch<float>(xp, bp, lt, partials, K, I2, J, colour, offset, omega, maf, lines,
                       threads, tiles, device, stream);
}

int cz_rbl_color_f64(void* xp, const void* bp, const void* lt, void* partials, int K, int I2,
                     int J, int colour, int offset, double omega, int maf, int lines,
                     int threads, int tiles, int device, void* stream) {
  return launch<double>(xp, bp, lt, partials, K, I2, J, colour, offset, omega, maf, lines,
                        threads, tiles, device, stream);
}

}  // extern "C"
