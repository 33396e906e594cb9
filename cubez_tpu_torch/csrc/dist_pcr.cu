// Block-local K-line relaxation of the distributed path for Hopper (sm_90a):
// every mesh block of a card in one launch, each with width-1 ghosts (K9).
//
// Replaces cubez_tpu/pallas_kernels/dist_pcr.py:379 (make_block_pcr ->
// _dist_pcr_kernel): one colour of a red-black line sweep, or the
// line-Jacobi pass, on (lk+2, li+2, lj+2) blocks whose ghost faces the
// caller refreshed (parallel/dist_fused.py).  It runs on K8's ghosted
// block, not on the TPU kernel's (li+2, lkp, ljp) line layout with its
// (8, 128) padding and J ghost-lane option.
//
// A line is the column of a block at an owned (i, j) whose global (gi, gj)
// is inner; colour c holds the lines with (gi + gj + offset) % 2 == c.
// Colour 0/1 relaxes that colour's lines in place (a colour line reads only
// lines of the other colour and ghost columns; a CTA takes L lines of one
// colour in one row); colour -1 relaxes every line from the pre-pass block,
// OUT OF PLACE into ``out``, and writes every value of ``out``.
//
// Two forms (the TPU kernel's ``solver``):
//   'pcr' (any mesh): the line is the block's lk owned rows and its two
//     ghost rows, n = lk + 2.  Ghost rows and rows on a physical K wall are
//     identity equations (a = c = 0, d = x), the reference's multi-rank end
//     fold (cz_solver.f90:578-579); the others carry the stencil equation,
//     a = c = -1/6 and d = (((x[i+1] + x[i-1]) + x[j+1]) + x[j-1] - b) / 6
//     (MAF: dw = 0.5 / ((c1 + c2) + c3), a = -(wzm dw), c = -(wzp dw),
//     d = ((((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym x[j-1]) - b)
//     dw), solved by PCR (num_stage(lk + 2) stages); the residual covers
//     the updated rows only.
//     block_pcr_tab_kernel (constant coefficients): every line of a block
//       has the same a and c, set by the block's (k0, lk, K) alone (which
//       of its two end rows lie on a physical wall), so the host evolves
//       that wall pattern's stage coefficients once, by pcr_solve_var's
//       own operations in the field's type (cuda_kernels/dist_pcr.py::
//       pattern_table), and a line runs only the d chain, pcr.cuh's
//       pcr_solve_tab: 2 n values a line in shared memory, 5 operations
//       and no division a row a stage, bitwise pcr_solve_var's d.
//     block_pcr_var_kernel (MAF): a and c depend on the line's (i, j), so
//       each line runs pcr.cuh's pcr_solve_var (6 n values a line).
//   'fastdiag' (K-unsplit meshes, lk == K), block_tile_kernel: every line
//     spans the full K extent, so the serial line relaxation applies per
//     block unchanged: line_tile.cuh's shared-memory Thomas tile, as K5
//     and K6 run it (the Dirichlet walls at block rows 1 and lk folded into
//     the ends, MAF through the block's MafTables indexed by its (i, j)).
//     The TPU kernel solves these lines with dense eigen/inverse tables on
//     the MXU (dist_pcr.py:169-182, 204-230); Thomas is K5/K6's
//     counterpart of that.
//
// Arithmetic: one round-to-nearest intrinsic per operation, built with
// --fmad=false; cuda_kernels/dist_pcr.py's plain twin does the same
// operations in the same order (bitwise equal in float32 and float64).
//
// What bounds it on an H100: a 64^3 block (n = 66, pn = 7) is 4,096 lines
// of 66 rows, 2,048 a colour; its bytes (1.2 MB read, half the owned cells
// written) take about 0.5 us a block at 3.35 TB/s, 3.9 us for the eight
// blocks of 128^3, so any of the forms is a chain of dependent steps, not
// a stream: Thomas walks n steps a line, PCR pn stages of a barrier each.
// What the design does about it:
//   - one launch takes every block of the card (up to kMaxBlocks; the
//     wrapper splits above that), their pointers and origins by value in a
//     __grid_constant__ parameter struct, blockIdx.z ('pcr') or blockIdx.y
//     ('fastdiag') picking the block;
//   - 'fastdiag' keeps a tile's lines in shared memory: the serial steps
//     wait on shared memory, not on an L2 round trip and a global scratch
//     (the one-thread Thomas it replaced took 214 ns a step, line_tile.cuh);
//   - the constant 'pcr' form drops the coefficient half of each stage (11
//     of 16 operations a row, its division among them, and 6 of 9 shared
//     loads), and with a third of the shared memory a line more CTAs
//     share an SM;
//   - a thread builds its rows' system one row at a time: loads issued in
//     batches of rows before any is used measured slower in both forms
//     (tools/prof_dist.py --k9).
//
// Residuals: one partial of dp^2 per CTA in the field's type, in a fixed
// order, into a buffer that dist_halo.cu's fold sums in float64.

#include <cuda_runtime.h>

#include <cstddef>

#include "line_tile.cuh"
#include "pcr.cuh"

namespace {

using namespace cz;

constexpr int kMaxBlocks = 32;  // blocks in one launch (dist_halo.cu)

struct BlockGeom {
  int k0, i0, j0;  // global origin of the owned cells
  int Kg, Ig, Jg;  // global shape
  int offset;      // colour offset
};

template <typename T>
struct Block {
  const T* x;
  const T* b;    // nullptr for a zero right-hand side
  const T* tab;  // MAF: the block's tables (block_maf_tables); constant
                 // 'pcr': its wall pattern's stage tables; else nullptr
  T* out;        // x for a colour pass, else the line-Jacobi output
  int k0, i0, j0;
};

template <typename T>
struct Args {
  Block<T> blk[kMaxBlocks];
  T* partials;   // one slot per CTA
  const T* lt;   // 'fastdiag', constant coefficients: the Thomas factors
  T omega;
  int lk, li, lj;
  int Kg, Ig, Jg, offset;
  int L, colour, pn;
};

__device__ __forceinline__ bool inner(int g, int G) { return g >= 1 && g <= G - 2; }

template <typename T>
__device__ __forceinline__ BlockGeom geom_of(const Args<T>& a, const Block<T>& B) {
  return BlockGeom{B.k0, B.i0, B.j0, a.Kg, a.Ig, a.Jg, a.offset};
}

// The column (i, j) of the block that lane ``m`` of row ``row`` sits in,
// for the colour launch (the colour's j of pair ``m`` in row i) or the
// line-Jacobi launch (any column).  ``column``: the lane has a column of
// the block.
template <bool kJacobi>
__device__ __forceinline__ void place(int row, int m, int li, int lj, int colour,
                                      const BlockGeom& g, int& i, int& j, bool& column) {
  if (kJacobi) {
    i = row;
    j = m;
    column = j <= lj + 1;
  } else {
    i = row + 1;
    const int gi = g.i0 + i - 1;
    // (gi + g.j0 + j - 1 + offset) % 2 == colour
    j = (((colour + gi + g.j0 + 1 + g.offset) & 1) ? 1 : 2) + 2 * m;
    column = j <= lj;
  }
}

// A column at (i, j) is a line: owned, and inner in global (gi, gj).
__device__ __forceinline__ bool is_line(bool column, int i, int j, int li, int lj,
                                        const BlockGeom& g) {
  return column && i >= 1 && i <= li && j >= 1 && j <= lj && inner(g.i0 + i - 1, g.Ig) &&
         inner(g.j0 + j - 1, g.Jg);
}

// Row k of a 'pcr' line carries the stencil equation (else identity).
__device__ __forceinline__ bool stencil_row(int k, int lk, const BlockGeom& g) {
  return k >= 1 && k <= lk && inner(g.k0 + k - 1, g.Kg);
}

// ---- 'pcr' ------------------------------------------------------------------

// Phase A of both 'pcr' kernels: the system of this thread's rows k = r0
// + m rs of its line into the tile, one row at a time (d; under MAF a, c
// and d); a column that is no line gets an all-zero system it solves and
// never writes back.  x and b are read through the read-only path:
// nothing this launch writes is read here (other colours' lines, ghost
// and wall rows).
template <typename T, bool kMaf>
__device__ __forceinline__ void pcr_system(const Args<T>& a, const Block<T>& B, bool line,
                                           int i, int j, size_t col, T* s0, int n, int L) {
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kPcrThreads / L;
  const size_t nL = size_t(n) * L;
  const int lk = a.lk, Jp = a.lj + 2;
  const size_t plane = size_t(a.li + 2) * Jp;
  const BlockGeom g = geom_of(a, B);
  const T* __restrict__ x = B.x;
  const T* __restrict__ b = B.b;
  const T R6 = T(1.0 / 6.0);
  const MafTables<T> w(B.tab, n, a.li + 2, Jp);  // read under kMaf only
  for (int k = r0; k < n; k += rs) {
    T a_ = 0, c = 0, d = 0;
    if (line) {
      const size_t p = size_t(k) * plane + col;
      if (stencil_row(k, lk, g)) {
        if constexpr (kMaf) {
          const T dw = div_rn(T(0.5), add_rn(add_rn(w.c1[i], w.c2[j]), w.c3[k]));
          a_ = -mul_rn(w.wzm[k], dw);
          c = -mul_rn(w.wzp[k], dw);
          T t = add_rn(mul_rn(w.wxp[i], __ldg(x + p + Jp)), mul_rn(w.wxm[i], __ldg(x + p - Jp)));
          t = add_rn(t, mul_rn(w.wyp[j], __ldg(x + p + 1)));
          t = add_rn(t, mul_rn(w.wym[j], __ldg(x + p - 1)));
          if (b != nullptr) t = sub_rn(t, __ldg(b + p));
          d = mul_rn(t, dw);
        } else {
          T t = add_rn(add_rn(add_rn(__ldg(x + p + Jp), __ldg(x + p - Jp)), __ldg(x + p + 1)),
                       __ldg(x + p - 1));
          if (b != nullptr) t = sub_rn(t, __ldg(b + p));
          d = mul_rn(t, R6);
        }
      } else {
        d = __ldg(x + p);  // identity row: x = its current value
      }
    }
    const int q = k * L + l;
    if constexpr (kMaf) {
      s0[q] = a_;
      s0[nL + q] = c;
      s0[2 * nL + q] = d;
    } else {
      s0[q] = d;
    }
  }
}

// Phase D of both 'pcr' kernels: relax the line's stencil rows by the
// solution ``sol`` (the line-Jacobi pass copies every other value of its
// column), and the CTA's partial sum of dp^2.
template <typename T, bool kJacobi>
__device__ __forceinline__ void pcr_relax(const Args<T>& a, const Block<T>& B, bool line,
                                          bool column, size_t col, const T* sol, int n,
                                          int L) {
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kPcrThreads / L;
  const size_t plane = size_t(a.li + 2) * (a.lj + 2);
  const BlockGeom g = geom_of(a, B);
  const T* x = B.x;
  T* out = B.out;
  T acc = 0;
  if (line) {
    for (int k = r0; k < n; k += rs) {
      const size_t p = size_t(k) * plane + col;
      const T xv = x[p];
      if (stencil_row(k, a.lk, g)) {
        const T dp = mul_rn(sub_rn(sol[k * L + l], xv), a.omega);
        out[p] = add_rn(xv, dp);
        acc = add_rn(acc, mul_rn(dp, dp));
      } else if (kJacobi) {
        out[p] = xv;
      }
    }
  } else if (kJacobi && column) {
    for (int k = r0; k < n; k += rs) out[size_t(k) * plane + col] = x[size_t(k) * plane + col];
  }
  const T tot = block_sum<kPcrThreads>(acc);
  if (threadIdx.x == 0)
    a.partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = tot;
}

// Constant coefficients: d in two buffers of n L values, the block's
// stage tables (B.tab) read through the read-only path.
// grid (tiles of L lines, rows, blocks)
template <typename T, bool kJacobi>
__global__ void __launch_bounds__(kPcrThreads) block_pcr_tab_kernel(
    const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s0 = reinterpret_cast<T*>(smem);
  const Block<T>& B = a.blk[blockIdx.z];
  const int L = a.L, n = a.lk + 2;
  const BlockGeom g = geom_of(a, B);
  int i, j;
  bool column;
  place<kJacobi>(blockIdx.y, blockIdx.x * L + threadIdx.x % L, a.li, a.lj, a.colour, g, i, j,
                 column);
  const bool line = is_line(column, i, j, a.li, a.lj, g);
  const size_t col = size_t(i) * (a.lj + 2) + j;
  pcr_system<T, false>(a, B, line, i, j, col, s0, n, L);
  __syncthreads();
  const T* sol = pcr_solve_tab(s0, s0 + size_t(n) * L, B.tab, n, a.pn, L);
  pcr_relax<T, kJacobi>(a, B, line, column, col, sol, n, L);
}

// MAF: a, c and d in two buffers of 3 n L values (pcr_solve_var).
// grid (tiles of L lines, rows, blocks)
template <typename T, bool kJacobi>
__global__ void __launch_bounds__(kPcrThreads) block_pcr_var_kernel(
    const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s0 = reinterpret_cast<T*>(smem);
  const Block<T>& B = a.blk[blockIdx.z];
  const int L = a.L, n = a.lk + 2;
  const BlockGeom g = geom_of(a, B);
  int i, j;
  bool column;
  place<kJacobi>(blockIdx.y, blockIdx.x * L + threadIdx.x % L, a.li, a.lj, a.colour, g, i, j,
                 column);
  const bool line = is_line(column, i, j, a.li, a.lj, g);
  const size_t col = size_t(i) * (a.lj + 2) + j;
  pcr_system<T, true>(a, B, line, i, j, col, s0, n, L);
  __syncthreads();
  const T* sol = pcr_solve_var(s0, s0 + 3 * size_t(n) * L, n, a.pn, L);
  pcr_relax<T, kJacobi>(a, B, line, column, col, sol, n, L);
}

// ---- 'fastdiag' -------------------------------------------------------------

// line_tile.cuh's Lines policy on the ghosted block: row ``row`` and lane
// ``m`` as ``place`` puts them; a line's k = 0 value is block row 1, the
// global K wall.
template <bool kJacobi>
struct BlockLines {
  BlockGeom g;
  int li, lj, colour;
  unsigned plane;  // (li + 2)(lj + 2)
  __device__ __forceinline__ TileLine at(unsigned row, unsigned m) const {
    int i, j;
    bool column;
    place<kJacobi>(int(row), int(m), li, lj, colour, g, i, j, column);
    const unsigned Jp = unsigned(lj) + 2;
    TileLine t{};
    t.i = unsigned(i);
    t.j = unsigned(j);
    t.valid = column;
    t.inner = is_line(column, i, j, li, lj, g);
    t.own = plane + unsigned(i) * Jp + unsigned(j);
    t.ip = t.own + Jp;
    t.im = t.own - Jp;
    t.jp = t.own + 1;
    t.jm = t.own - 1;
    return t;
  }
};

// Rows and lanes of a 'fastdiag' launch: the colour's li rows of ceil(lj/2)
// lines, or the line-Jacobi pass's every column of the ghosted block.
template <bool kJacobi>
__host__ __device__ inline unsigned tile_rows(int li) { return kJacobi ? li + 2 : li; }
template <bool kJacobi>
__host__ __device__ inline unsigned tile_lanes(int lj) {
  return kJacobi ? lj + 2 : (lj + 1) / 2;
}

// grid (tiles a block, blocks); the block's tiles write partials
// blockIdx.y * gridDim.x + tile.
template <typename T, bool kMaf, bool kJacobi>
__global__ void __launch_bounds__(kTileMaxThreads) block_tile_kernel(
    const __grid_constant__ Args<T> a) {
  const Block<T>& B = a.blk[blockIdx.y];
  const int lk = a.lk, li = a.li, lj = a.lj, L = a.L;
  const unsigned plane = unsigned(li + 2) * unsigned(lj + 2);
  const unsigned lanes = tile_lanes<kJacobi>(lj);
  const BlockLines<kJacobi> lines{geom_of(a, B), li, lj, a.colour, plane};
  if (kJacobi && int(threadIdx.x) < 2 * L) {
    // the two ghost rows of the tile's columns, which the tile leaves
    const unsigned per_row = (lanes + unsigned(L) - 1) / unsigned(L);
    const TileLine ln = lines.at(blockIdx.x / per_row,
                                 (blockIdx.x % per_row) * unsigned(L) + threadIdx.x % L);
    if (ln.valid) {
      const unsigned p = ln.own - plane + (int(threadIdx.x) < L ? 0u : unsigned(lk + 1) * plane);
      B.out[p] = B.x[p];
    }
  }
  const TileArgs<T> t{B.x,
                      B.out,
                      B.b,
                      kMaf ? B.tab : a.lt,
                      a.partials + size_t(blockIdx.y) * gridDim.x,
                      plane,
                      lk,
                      li + 2,
                      lj + 2,
                      lanes,
                      L,
                      a.omega};
  relax_tile<T, kMaf, kJacobi>(lines, t);
}

// ---- launch -----------------------------------------------------------------

template <typename T, bool kJacobi>
int launch_pcr(const Args<T>& a, bool maf, dim3 grid, cudaStream_t s) {
  const int n = a.lk + 2;
  const size_t smem = (maf ? 6 : 2) * size_t(n) * a.L * sizeof(T);
  auto kernel = maf ? block_pcr_var_kernel<T, kJacobi> : block_pcr_tab_kernel<T, kJacobi>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kPcrThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kMaf, bool kJacobi>
int launch_tile(const Args<T>& a, unsigned gx, int n, cudaStream_t s) {
  if (a.lk < 4 || gx != tile_count(tile_rows<kJacobi>(a.li), tile_lanes<kJacobi>(a.lj), a.L))
    return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(a.lk, a.L, sizeof(T), kMaf);
  auto kernel = block_tile_kernel<T, kMaf, kJacobi>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(gx, n), kTileMaxThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// ptrs: x, b, tab, out per block, then lt (the Thomas factors of the
// constant 'fastdiag' form).  iargs: n, form (0 'pcr': grid gx x gy x n of
// kPcrThreads, L lines a CTA; 1 'fastdiag': gx tiles a block x n CTAs of
// kTileMaxThreads), colour (-1: line-Jacobi into out, else one colour in
// place, out == x), L, pn, maf, gx, gy, device, lk, li, lj, Kg, Ig, Jg,
// offset, then k0, i0, j0 per block.  The wrapper builds both arrays once
// for a set of blocks.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* partials, void* stream) {
  const int n = iargs[0], form = iargs[1], colour = iargs[2], L = iargs[3];
  const int maf = iargs[5], gx = iargs[6], gy = iargs[7];
  if (n < 1 || n > kMaxBlocks || L < 1 || kPcrThreads % L != 0 || kTileMaxThreads % L != 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(iargs[8]);
  if (e != cudaSuccess) return e;
  Args<T> a{};
  const int* org = iargs + 16;
  for (int b = 0; b < n; ++b) {
    void* const* q = ptrs + 4 * b;
    a.blk[b] = Block<T>{static_cast<const T*>(q[0]), static_cast<const T*>(q[1]),
                        static_cast<const T*>(q[2]), static_cast<T*>(q[3]),
                        org[3 * b], org[3 * b + 1], org[3 * b + 2]};
    if (form == 0 && a.blk[b].tab == nullptr) return cudaErrorInvalidValue;
  }
  a.partials = static_cast<T*>(partials);
  a.lt = static_cast<const T*>(ptrs[4 * n]);
  a.omega = T(omega);
  a.lk = iargs[9];
  a.li = iargs[10];
  a.lj = iargs[11];
  a.Kg = iargs[12];
  a.Ig = iargs[13];
  a.Jg = iargs[14];
  a.offset = iargs[15];
  a.L = L;
  a.colour = colour;
  a.pn = iargs[4];
  auto s = static_cast<cudaStream_t>(stream);
  const bool jac = colour < 0;
  if (form == 0) {
    const unsigned lanes = jac ? a.lj + 2 : (a.lj + 1) / 2;
    if (unsigned(gx) != (lanes + L - 1) / L || gy != (jac ? a.li + 2 : a.li))
      return cudaErrorInvalidValue;
    const dim3 grid(gx, gy, n);
    return jac ? launch_pcr<T, true>(a, maf, grid, s) : launch_pcr<T, false>(a, maf, grid, s);
  }
  if (!maf && a.lt == nullptr) return cudaErrorInvalidValue;
  if (maf) {
    return jac ? launch_tile<T, true, true>(a, gx, n, s)
               : launch_tile<T, true, false>(a, gx, n, s);
  }
  return jac ? launch_tile<T, false, true>(a, gx, n, s)
             : launch_tile<T, false, false>(a, gx, n, s);
}

}  // namespace

extern "C" {

int cz_block_pcr_f32(void* const* ptrs, const int* iargs, double omega, void* partials,
                     void* stream) {
  return launch<float>(ptrs, iargs, omega, partials, stream);
}

int cz_block_pcr_f64(void* const* ptrs, const int* iargs, double omega, void* partials,
                     void* stream) {
  return launch<double>(ptrs, iargs, omega, partials, stream);
}

}  // extern "C"
