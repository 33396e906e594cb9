// Unpacked point sweeps for Hopper (sm_90a): the CUDA counterpart of the
// JAX package's fused sweep kernel K4, cubez_tpu/pallas_kernels/sweeps.py:416
// (make_fused_sweep -> _sweep_kernel), in its four forms: Jacobi and
// red-black, constant coefficients and MAF, each with a zero or a streamed
// right-hand side.
//
// Layout: the (K, I, J) field as it is, J contiguous, no padding (the TPU
// kernel's K pad of 2 and (8, 128) tile padding were for its DMA slabs).
//
// Both kernels work on shared-memory plane tiles.  A work item is an
// (i, j) tile of ti x tj owned columns and a chunk of kchunk owned planes;
// the CTA walks k over the chunk (and a few planes past each end, which
// it recomputes, so that chunks need nothing from each other) and keeps a
// ring of planes of the tile and its halo in shared memory.  A warp takes
// a row of the region (tile and halo) at a time and its lanes the row's
// cells, so a thread's cell costs no division, and neighbouring lanes
// touch neighbouring addresses in global and shared memory (a region row
// is kRow = 64 cells at most, two a lane, loaded before they compute; a
// plane copies in aligned 16-byte pieces where the field's rows allow).
// Both are OUT OF PLACE:
// CTAs run in no order and a neighbour's halo must read the old field, so
// they read x and write every point of ``out`` (the Dirichlet shell
// copied), never x.  The host plans the tiles
// (cuda_kernels/sweeps.py::tile_plan).
//
// rb_tile_kernel: one red-black iteration in one pass, as the TPU kernel
// does it (sweeps.py:5-9,14-17: colour 1 runs one row behind colour 0).
// Colour c holds the points with (i + j + k + offset + 1) % 2 == c.  A ring
// of four planes (k - 2 .. k + 1, and kAhead more in flight) with a halo of 2
// in i and j; at step k it loads plane k + 1, updates colour 0 at plane k on
// the tile and its ring
// of width 1 (colour 1 reads those), then colour 1 at plane k - 1 on the
// tile, and writes plane k - 1 once.  The ring's colour-0 values are
// recomputed from the same inputs by the neighbouring tile, so they are
// bitwise the same.  In a colour pass lane l takes cell 2 l or 2 l + 1 of
// a row, whichever has the colour.
//
// jacobi_tile_kernel<N>: N Jacobi iterations a launch (temporal blocking).
// Level 0 is x, level t the field after t iterations; level t runs t planes
// behind the loads, on the tile and a halo of N - t, from level t - 1's
// ring of three planes; each level 0 .. N-1 keeps its ring in shared
// memory ((3N + kAhead) planes of (ti + 2N) rows: level 0 has kAhead more
// for the planes in flight), and level N goes straight to ``out``.  Points
// that are not global inner points never change, so every level carries x
// there.
//
// Both kernels copy the planes of x kAhead steps ahead into shared memory
// with cp.async while they compute the current one, so that a step's loads
// do not wait out the memory latency behind a barrier.
//
// Arithmetic contracts: common.cuh const_dp and maf_dp, the same operations
// in the same order as the plain twins (cuda_kernels/sweeps.py): float32
// fields are bitwise n applications of jacobi_plain, and bitwise
// sor2sma_plain (two in-place colour passes).
//
// What bounds them on an H100: at 128^3 float32 (8.4 MB a field) the field
// stays in the 50 MB L2, and the host's launch and reduction per iteration
// dominated the old one-launch-a-pass kernels (21.5 us of device work in a
// 64 us iteration); here a Jacobi launch runs N iterations and folds its
// residuals itself, and a red-black iteration is one launch.  At 512^3 the
// HBM bytes bound them: a launch reads x and writes out once, where the
// pass-per-launch Jacobi moved both N times and each colour launch read
// every cache line of a row to update half of it.  Shared memory traffic
// (seven loads an update) and the recomputed halos are the price.
//
// Residuals: each CTA sums dp^2 over the points it owns (tile and chunk)
// in the field's type, one partial a level; after a grid-wide sync (the
// launch is cooperative and persistent: CTAs loop over the work items)
// the CTAs fold the partials of each level in float64 in a fixed order,
// as dist_halo.cu's fold: no atomics, the history is the same bit for bit
// from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Args {
  const T* x;
  const T* b;    // nullptr for a zero right-hand side
  const T* tab;  // MAF tables, nullptr for constant coefficients
  T* out;
  T* partials;   // (levels, gridDim.x) per-CTA sums of dp^2
  double* r2;    // (levels,) their float64 folds
  T omega;
  int K, I, J;
  int ti, tj;            // a tile's owned extents
  int tiles_i, tiles_j;  // tiles across i and j
  int kchunk, nwork;     // owned planes a work item, work items
  int offset;            // colour offset (red-black)
};

// Cells of a region row in shared memory (a multiple of 64: kRow / 32 a
// lane of a warp), and rows of a region at most.
constexpr int kRow = 64;
constexpr int kRegionRows = 32;

// A plane's (axis 0), a row's (axis 1) or a column's (axis 2) MAF weights
// from the tables (cuda_kernels/rbpack.py::maf_tables' layout); zeros for
// an index outside the field (no update there reads them).
template <typename T>
__device__ __forceinline__ AxisWeights<T> axis_weights(const Args<T>& a, int axis, int idx) {
  const int n = axis == 0 ? a.K : axis == 1 ? a.I : a.J;
  if (idx < 0 || idx >= n) return AxisWeights<T>{T(0), T(0), T(0)};
  const T* t = a.tab + (axis == 0 ? 0 : axis == 1 ? 3 * a.K : 3 * (a.K + a.I)) + idx;
  return AxisWeights<T>{t[0], t[n], t[2 * n]};
}

// dp at shared-memory index s of plane c (zm, zp the planes below and
// above, rs the row stride), physical point (k, i, j); wk, wi, wj its MAF
// weights (unused for constant coefficients).
template <typename T, bool kMaf>
__device__ __forceinline__ T tile_dp(const T* __restrict__ zm, const T* __restrict__ c,
                                     const T* __restrict__ zp, int s, int rs, const Args<T>& a,
                                     int k, int i, int j, const AxisWeights<T>& wk,
                                     const AxisWeights<T>& wi, const AxisWeights<T>& wj) {
  const T* bp = a.b != nullptr ? a.b + (size_t(k) * a.I + i) * a.J + j : nullptr;
  if constexpr (kMaf)
    return maf_dp(wk, wi, wj, zm[s], zp[s], c[s + rs], c[s - rs], c[s + 1], c[s - 1], bp, c[s],
                  a.omega);
  else
    return const_dp(zm[s], zp[s], c[s + rs], c[s - rs], c[s + 1], c[s - 1], bp, c[s], a.omega);
}

// The work item's tile: global origin (i0, j0), owned extents (ni, nj),
// owned planes [k_lo, k_hi).
struct Tile {
  int i0, j0, ni, nj, k_lo, k_hi;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const Args<T>& a, int w) {
  const int tiles = a.tiles_i * a.tiles_j;
  const int kc = w / tiles;
  const int tt = w - kc * tiles;
  const int ty = tt / a.tiles_j;
  Tile t;
  t.i0 = ty * a.ti;
  t.j0 = (tt - ty * a.tiles_j) * a.tj;
  t.ni = min(a.ti, a.I - t.i0);
  t.nj = min(a.tj, a.J - t.j0);
  t.k_lo = kc * a.kchunk;
  t.k_hi = min(t.k_lo + a.kchunk, a.K);
  return t;
}

// Planes of x in flight while the CTA computes: each step issues the plane
// kAhead steps ahead, one cp.async group a step (empty past the chunk).
constexpr int kAhead = 2;

// Values a 16-byte copy moves.
template <typename T>
constexpr int kVec = 16 / int(sizeof(T));

// The shared-memory column of a region's column 0, whose global column is
// j0: j0 mod kVec where rows are 16-byte aligned in the field (J a
// multiple of kVec), so that a plane copies in aligned 16-byte pieces;
// else 0.
template <typename T>
__device__ __forceinline__ int col_shift(const Args<T>& a, int j0) {
  return a.J % kVec<T> == 0 ? ((j0 % kVec<T>) + kVec<T>) % kVec<T> : 0;
}

// Copying one plane of a work item's region (the tile and a halo of h,
// rows of kRow, region column q at column q + col_shift) into shared
// memory, each thread's share worked out once a work item so that a
// plane's copy is a few instructions a piece.  kAligned (the field's rows
// 16-byte aligned: J a multiple of kVec): 16-byte pieces, each a
// shared-memory offset and an offset in a plane of x.  Else one value a
// piece, a warp a row: the thread's rows (r = warp + kWarps m) and
// columns (q = lane + 32 c) apart.  An offset of -1 marks a piece outside
// the array (zero-filled: no update reads it).
template <typename T, bool kAligned>
struct PlaneCopy;

template <typename T>
struct PlaneCopy<T, true> {
  static constexpr int kMax = kRegionRows * (kRow / kVec<T>) / kThreads;
  int n = 0;
  int soff[kMax], goff[kMax];

  __device__ __forceinline__ PlaneCopy(const Args<T>& a, const Tile& t, int h) {
    const int j0 = t.j0 - h, sh = col_shift(a, j0);
    const int rows = t.ni + 2 * h, base = j0 - sh;
    const int per_row = (t.nj + 2 * h + sh + kVec<T> - 1) / kVec<T>;
#pragma unroll
    for (int m = 0; m < kMax; ++m) {
      const int pc = threadIdx.x + m * kThreads;
      if (pc < rows * per_row) {
        const int r = pc / per_row, q = (pc - r * per_row) * kVec<T>;
        const int gi = t.i0 - h + r, gj = base + q;
        soff[m] = r * kRow + q;
        // a piece lies wholly inside [0, J) or wholly outside
        goff[m] = gi >= 0 && gi < a.I && gj >= 0 && gj < a.J ? gi * a.J + gj : -1;
        n = m + 1;
      }
    }
  }

  // Start copying plane k into dst; the caller commits the group.
  __device__ __forceinline__ void issue(T* dst, const Args<T>& a, int k) const {
    const T* src = a.x + size_t(k) * a.I * a.J;
#pragma unroll
    for (int m = 0; m < kMax; ++m) {
      if (m >= n) break;
      const bool ok = goff[m] >= 0;
      cp_async16(dst + soff[m], ok ? src + goff[m] : a.x, ok);
    }
  }
};

template <typename T>
struct PlaneCopy<T, false> {
  static constexpr int kRows = kRegionRows / kWarps, kCols = kRow / 32;
  int row0, nrows;
  int grow[kRows];  // gi * J, -1 outside the array
  int gcol[kCols];  // gj, -1 outside the array, -2 past the region

  __device__ __forceinline__ PlaneCopy(const Args<T>& a, const Tile& t, int h) {
    const int lane = threadIdx.x & 31;
    row0 = threadIdx.x >> 5;
    nrows = t.ni + 2 * h;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int gi = t.i0 - h + row0 + kWarps * m;
      grow[m] = gi >= 0 && gi < a.I ? gi * a.J : -1;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int q = lane + 32 * c, gj = t.j0 - h + q;
      gcol[c] = q >= t.nj + 2 * h ? -2 : gj >= 0 && gj < a.J ? gj : -1;
    }
  }

  __device__ __forceinline__ void issue(T* dst, const Args<T>& a, int k) const {
    const T* src = a.x + size_t(k) * a.I * a.J;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int r = row0 + kWarps * m;
      if (r >= nrows) break;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (gcol[c] == -2) continue;
        const bool ok = grow[m] >= 0 && gcol[c] >= 0;
        cp_async(dst + r * kRow + lane + 32 * c, ok ? src + grow[m] + gcol[c] : a.x, ok);
      }
    }
  }
};

// Fold the per-CTA partials of each of ``levels`` levels in float64, in a
// fixed order, after every CTA wrote its own.
template <typename T>
__device__ void fold_levels(const Args<T>& a, int levels) {
  cg::this_grid().sync();
  for (int t = blockIdx.x; t < levels; t += gridDim.x) {
    double s = 0;
    for (int q = threadIdx.x; q < int(gridDim.x); q += kThreads)
      s += double(a.partials[size_t(t) * gridDim.x + q]);
    s = block_sum<kThreads>(s);
    if (threadIdx.x == 0) a.r2[t] = s;
  }
}

// Level t's ring slot of plane p (p >= 0): level 0 keeps 3 + kAhead planes
// (three in use and those in flight), the others three.
__device__ __forceinline__ int ring_slot(int t, int p) {
  return t == 0 ? p % (3 + kAhead) : 3 + kAhead + (t - 1) * 3 + p % 3;
}

// Level t of the Jacobi kernel at plane p from level t - 1's planes pm,
// p0, pp: the cells [t, rows - t) x [t, cols - t) of the region (level 0's
// local cells, origin (i0, j0) in the field) into cur, or (kLast) the owned
// ones into out.  A lane's cells of a row (kRow / 32) load before they
// compute and store; returns the sum of dp^2 over the owned cells.
template <typename T, bool kMaf, bool kLast>
__device__ __forceinline__ T jacobi_level(const T* __restrict__ pm, const T* __restrict__ p0,
                                          const T* __restrict__ pp, T* __restrict__ cur,
                                          const Args<T>& a, const Tile& tl, int N, int t,
                                          int p, bool k_in, bool k_own) {
  const int lane = threadIdx.x & 31;
  const int rows = tl.ni + 2 * N, cols = tl.nj + 2 * N;
  const int i0 = tl.i0 - N, j0 = tl.j0 - N, sh = col_shift(a, j0);
  // MAF: the plane's weights, and the lane's columns', once a level
  AxisWeights<T> wk{}, wj[kRow / 32]{};
  if constexpr (kMaf) {
    wk = axis_weights(a, 0, p);
#pragma unroll
    for (int c = 0; c < kRow / 32; ++c) wj[c] = axis_weights(a, 2, j0 + t + lane + 32 * c);
  }
  T sum = 0;
  for (int r = t + (threadIdx.x >> 5); r < rows - t; r += kWarps) {
    const int gi = i0 + r;
    const bool row_in = k_in && gi >= 1 && gi <= a.I - 2;
    AxisWeights<T> wi{};
    if constexpr (kMaf) wi = axis_weights(a, 1, gi);
    const bool row_own = k_own && r >= N && r < N + tl.ni;
    T* __restrict__ dst = kLast ? a.out + (size_t(p) * a.I + gi) * a.J : nullptr;
    T v[kRow / 32], dp[kRow / 32];
    bool on[kRow / 32], upd[kRow / 32];
#pragma unroll
    for (int c = 0; c < kRow / 32; ++c) {
      const int q = t + lane + 32 * c, gj = j0 + q, si = r * kRow + q + sh;
      on[c] = q < cols - t;
      upd[c] = on[c] && row_in && gj >= 1 && gj <= a.J - 2;
      v[c] = on[c] ? p0[si] : T(0);
      dp[c] = upd[c] ? tile_dp<T, kMaf>(pm, p0, pp, si, kRow, a, p, gi, gj, wk, wi, wj[c])
                     : T(0);
    }
#pragma unroll
    for (int c = 0; c < kRow / 32; ++c) {
      const int q = t + lane + 32 * c;
      if (!on[c]) continue;
      if (upd[c]) {
        v[c] = add_rn(v[c], dp[c]);
        if (row_own && q >= N && q < N + tl.nj) sum += dp[c] * dp[c];
      }
      if (kLast)
        dst[j0 + q] = v[c];
      else
        cur[r * kRow + q + sh] = v[c];
    }
  }
  return sum;
}

// N Jacobi iterations, x -> out (see the header).
template <typename T, bool kMaf, int N, bool kAligned>
__global__ void __launch_bounds__(kThreads) jacobi_tile_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int area = (a.ti + 2 * N) * kRow;
  T acc[N];
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t] = 0;
  for (int w = blockIdx.x; w < a.nwork; w += gridDim.x) {
    const Tile tl = tile_of(a, w);
    const int s_lo = max(tl.k_lo - N, 0), s_hi = min(tl.k_hi + N, a.K);
    const PlaneCopy<T, kAligned> copy(a, tl, N);
    for (int d = 0; d < kAhead; ++d) {
      if (s_lo + d < s_hi) copy.issue(sm + ring_slot(0, s_lo + d) * area, a, s_lo + d);
      cp_async_commit();
    }
    for (int s = s_lo; s < tl.k_hi + N; ++s) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();  // plane s has landed; every read of the slot s + kAhead takes is done
      if (s + kAhead < s_hi)
        copy.issue(sm + ring_slot(0, s + kAhead) * area, a, s + kAhead);
      cp_async_commit();
#pragma unroll
      for (int t = 1; t <= N; ++t) {
        const int p = s - t;  // level t's plane at this step
        const int h = N - t;  // level t's halo
        if (p >= max(tl.k_lo - h, 0) && p < min(tl.k_hi + h, a.K)) {
          const T* pm = sm + ring_slot(t - 1, max(p - 1, 0)) * area;  // read where p >= 1
          const T* p0 = sm + ring_slot(t - 1, p) * area;
          const T* pp = sm + ring_slot(t - 1, p + 1) * area;
          const bool k_in = p >= 1 && p <= a.K - 2;
          const bool k_own = p >= tl.k_lo && p < tl.k_hi;
          if (t < N)
            acc[t - 1] += jacobi_level<T, kMaf, false>(pm, p0, pp, sm + ring_slot(t, p) * area,
                                                       a, tl, N, t, p, k_in, k_own);
          else
            acc[t - 1] += jacobi_level<T, kMaf, true>(pm, p0, pp, nullptr, a, tl, N, t, p,
                                                      k_in, k_own);
        }
        if (t < N) __syncthreads();  // the loop's next sync follows level N
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the last level's reads before the next item's loads
  }
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const T tot = block_sum<kThreads>(acc[t]);
    if (threadIdx.x == 0) a.partials[size_t(t) * gridDim.x + blockIdx.x] = tot;
  }
  fold_levels(a, N);
}

// Colour c at plane k in place in shared memory (planes zm, c0, zp, rows
// of kRow), on the rows [o, o + nr) x columns [o, o + nc) of the tile's
// region (halo 2); the sum of dp^2 over the owned ones.  A lane takes the
// colour's cells 2 lane + parity (+ 64 m) of a row.
template <typename T, bool kMaf>
__device__ __forceinline__ T colour_pass(const T* __restrict__ zm, T* __restrict__ c0,
                                         const T* __restrict__ zp, const Args<T>& a,
                                         const Tile& tl, int k, int colour, int o, int nr,
                                         int nc, bool k_own) {
  const int lane = threadIdx.x & 31;
  const int i0 = tl.i0 - 2, j0 = tl.j0 - 2, sh = col_shift(a, j0);
  // MAF: the plane's weights, and those of the lane's two columns of each
  // parity, once a pass
  AxisWeights<T> wk{}, wj[2][kRow / 64]{};
  if constexpr (kMaf) {
    wk = axis_weights(a, 0, k);
#pragma unroll
    for (int m = 0; m < kRow / 64; ++m)
#pragma unroll
      for (int par = 0; par < 2; ++par)
        wj[par][m] = axis_weights(a, 2, j0 + 2 * lane + par + 64 * m);
  }
  T sum = 0;
  for (int r = o + (threadIdx.x >> 5); r < o + nr; r += kWarps) {
    const int gi = i0 + r;
    if (gi < 1 || gi > a.I - 2) continue;
    const bool row_own = k_own && r >= 2 && r < 2 + tl.ni;
    AxisWeights<T> wi{};
    if constexpr (kMaf) wi = axis_weights(a, 1, gi);
    // (gi + gj + k + offset + 1) % 2 == colour, gj = j0 + q
    const int par = (gi + j0 + k + a.offset + 1 + colour) & 1;
    const int q0 = 2 * lane + par;
#pragma unroll
    for (int m = 0; m < kRow / 64; ++m) {
      const int q = q0 + 64 * m, gj = j0 + q;
      if (q < o || q >= o + nc || gj < 1 || gj > a.J - 2) continue;
      const int si = r * kRow + q + sh;
      const T dp = tile_dp<T, kMaf>(zm, c0, zp, si, kRow, a, k, gi, gj, wk, wi,
                                    par ? wj[1][m] : wj[0][m]);
      c0[si] = add_rn(c0[si], dp);
      if (row_own && q >= 2 && q < 2 + tl.nj) sum += dp * dp;
    }
  }
  return sum;
}

// One red-black iteration, x -> out, both colours in one pass (see the
// header).
template <typename T, bool kMaf, bool kAligned>
__global__ void __launch_bounds__(kThreads) rb_tile_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31;
  const int area = (a.ti + 4) * kRow;
  // planes k - 3 .. k in use and kAhead more in flight
  auto plane = [&](int k) { return sm + (k % (4 + kAhead)) * area; };
  T acc = 0;
  for (int w = blockIdx.x; w < a.nwork; w += gridDim.x) {
    const Tile tl = tile_of(a, w);
    const int s_lo = max(tl.k_lo - 2, 0), s_hi = min(tl.k_hi + 2, a.K);
    const PlaneCopy<T, kAligned> copy(a, tl, 2);
    for (int d = 0; d < kAhead; ++d) {
      if (s_lo + d < s_hi) copy.issue(plane(s_lo + d), a, s_lo + d);
      cp_async_commit();
    }
    for (int s = s_lo; s <= tl.k_hi + 1; ++s) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();  // plane s has landed; every read of the slot s + kAhead takes is done
      if (s + kAhead < s_hi) copy.issue(plane(s + kAhead), a, s + kAhead);
      cp_async_commit();
      const int c0 = s - 1;  // colour 0 on the tile and its ring of 1
      if (c0 >= max(tl.k_lo - 1, 1) && c0 <= min(tl.k_hi, a.K - 2))
        acc += colour_pass<T, kMaf>(plane(c0 - 1), plane(c0), plane(c0 + 1), a, tl, c0, 0, 1,
                                    tl.ni + 2, tl.nj + 2, c0 >= tl.k_lo && c0 < tl.k_hi);
      __syncthreads();
      const int c1 = s - 2;  // colour 1 on the tile, one plane behind
      if (c1 >= max(tl.k_lo, 1) && c1 <= min(tl.k_hi - 1, a.K - 2))
        acc += colour_pass<T, kMaf>(plane(c1 - 1), plane(c1), plane(c1 + 1), a, tl, c1, 1, 2,
                                    tl.ni, tl.nj, true);
      __syncthreads();
      if (c1 >= tl.k_lo && c1 < tl.k_hi) {  // write plane c1's owned cells once
        const T* src = plane(c1);
        const int sh = col_shift(a, tl.j0 - 2);
        for (int r = threadIdx.x >> 5; r < tl.ni; r += kWarps) {
          T* dst = a.out + (size_t(c1) * a.I + tl.i0 + r) * a.J + tl.j0;
          for (int q = lane; q < tl.nj; q += 32) dst[q] = src[(r + 2) * kRow + q + 2 + sh];
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the last stores read the ring the next item loads into
  }
  const T tot = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = tot;
  fold_levels(a, 1);
}

// The kernel of (kind 0 Jacobi with n iterations, 1 red-black; MAF; rows
// 16-byte aligned).
template <typename T, bool kMaf, bool kAligned>
const void* kernel_of(int kind, int n) {
  switch (kind == 1 ? 0 : n) {
    case 0:
      return reinterpret_cast<const void*>(rb_tile_kernel<T, kMaf, kAligned>);
    case 1:
      return reinterpret_cast<const void*>(jacobi_tile_kernel<T, kMaf, 1, kAligned>);
    case 2:
      return reinterpret_cast<const void*>(jacobi_tile_kernel<T, kMaf, 2, kAligned>);
    default:
      return nullptr;
  }
}

template <typename T>
const void* kernel_of(int kind, int n, bool maf, bool aligned) {
  if (maf)
    return aligned ? kernel_of<T, true, true>(kind, n) : kernel_of<T, true, false>(kind, n);
  return aligned ? kernel_of<T, false, true>(kind, n) : kernel_of<T, false, false>(kind, n);
}

// CTAs of the kernel co-resident on the card at ``smem`` bytes of dynamic
// shared memory each (the cooperative launch's limit).  Raises the
// kernel's dynamic shared-memory limit to what the card allows first.
template <typename T>
int max_blocks(int kind, int n, int maf, int aligned, int smem, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* k = kernel_of<T>(kind, n, maf != 0, aligned != 0);
  if (k == nullptr) return cudaErrorInvalidValue;
  int optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - int(attr.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, size_t(smem));
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// ptrs: x, b, tab, out, partials, r2.  iargs: kind, n, K, I, J, ti, tj,
// tiles_i, tiles_j, kchunk, nwork, offset, grid, smem, device.  The
// wrapper builds both arrays once for a set of fields.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* stream) {
  const int kind = iargs[0], n = iargs[1], grid = iargs[12], smem = iargs[13];
  cudaError_t e = cudaSetDevice(iargs[14]);
  if (e != cudaSuccess) return e;
  Args<T> a;
  a.x = static_cast<const T*>(ptrs[0]);
  a.b = static_cast<const T*>(ptrs[1]);
  a.tab = static_cast<const T*>(ptrs[2]);
  a.out = static_cast<T*>(ptrs[3]);
  a.partials = static_cast<T*>(ptrs[4]);
  a.r2 = static_cast<double*>(ptrs[5]);
  a.omega = T(omega);
  a.K = iargs[2];
  a.I = iargs[3];
  a.J = iargs[4];
  a.ti = iargs[5];
  a.tj = iargs[6];
  a.tiles_i = iargs[7];
  a.tiles_j = iargs[8];
  a.kchunk = iargs[9];
  a.nwork = iargs[10];
  a.offset = iargs[11];
  const void* k = kernel_of<T>(kind, n, a.tab != nullptr, a.J % kVec<T> == 0);
  const int halo = kind == 1 ? 2 : n;
  if (k == nullptr || grid < 1 || grid > a.nwork || a.tj + 2 * halo + kVec<T> - 1 > kRow ||
      a.ti + 2 * halo > kRegionRows)
    return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args, size_t(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_k4_max_blocks_f32(int kind, int n, int maf, int aligned, int smem, int device,
                         int* out) {
  return max_blocks<float>(kind, n, maf, aligned, smem, device, out);
}

int cz_k4_max_blocks_f64(int kind, int n, int maf, int aligned, int smem, int device,
                         int* out) {
  return max_blocks<double>(kind, n, maf, aligned, smem, device, out);
}

int cz_k4_sweep_f32(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<float>(ptrs, iargs, omega, stream);
}

int cz_k4_sweep_f64(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<double>(ptrs, iargs, omega, stream);
}

}  // extern "C"
