// Packed red-black SOR sweeps for Hopper (sm_90a): the CUDA counterparts of
// the JAX package's colour-packed Pallas kernels.
//
// Layout (cubez_tpu_torch/cuda_kernels/rbpack.py::pack_rb): the (K, I, J)
// field folded along I into two dense colour halves, x[2][K][I/2][J], J
// contiguous, no padding.  Colour 0 ("red") holds the points with
// (i + j + k + offset + 1) % 2 == 0; packed row i2 of colour c at (k, j)
// holds physical row i = 2*i2 + s with s = (k + j + offset + 1 + c) & 1.
// K and J neighbours of a point are the other colour's same (k, i2, j)
// shifted by one row or lane; the I neighbours are the other colour's rows
// i2 and i2 - 1 + 2s: x[i+1] = s ? o[i2+1] : o[i2], x[i-1] = s ? o[i2] :
// o[i2-1].  Since s flips with j, the lanes of a warp that walk a row in
// steps of 32 each keep one s, and with it one pair of I-neighbour rows.
//
// Arithmetic contracts (bitwise equal to the plain twin,
// cuda_kernels/rbpack.py::rb_color_plain; common.cuh const_dp and maf_dp):
//   constant: ss = ((zm + zp) + (xm + xp)) + (ym + yp), ss -= b,
//             dp = fma(ss, 1/6, -centre) * omega;
//   MAF:      r = fma(wzm, zm, wzp*zp), fma for x+, x-, y+, y-, r += b,
//             dp = (r / (2 ((c1 + c2) + c3)) - centre) * omega;
//   centre += dp.
// The MAF weights are per-axis vectors indexed by the physical k, i = 2*i2
// + s and j of the point (the kMaf template flag selects that form).
//
// K1, cubez_tpu/pallas_kernels/rbpack.py:732 (make_packed_sweep ->
// _packed_kernel, one red-black iteration), K3, sweeps2x.py:480 (build_nx
// -> _sweepnx_kernel, n iterations with a zero right-hand side), and K2,
// sweeps2x.py:552 (build_2x -> _sweep2x_kernel, n = 2 with an optional
// streamed b), run n full red-black iterations in one cooperative launch
// (K1: n = 1, both colours and the residual in one launch), OUT OF PLACE:
// they read x and write every point of ``out`` (the Dirichlet shell
// copied), never x.  Two forms, chosen on the host from the field's size
// (cuda_kernels/rbpack.py::tile_plan):
//
// rb_tile_sweeps_kernel, one pass over the field for all n iterations (the
// TPU kernel's lagged windows, sweeps2x.py:1-22, and K1's own lag of a
// plane between the colours, rbpack.py:673-790, on Hopper's terms), built
// for n = kTileN with a zero b and for n = 1 (K1) with or without a
// streamed b, which each update reads from global memory.  A work item is an (i2, j) tile of ti x tj
// owned cells and a chunk of kchunk owned planes; the CTA walks k.  The 2n
// colour half-steps are levels: level h (1..2n) updates colour (h - 1) & 1
// at plane s - h while the loads reach plane s, from level h - 1 (the
// other colour: planes p - 1, p, p + 1) and level h - 2 (its own colour's
// centre at p); level 0 is x, copied with cp.async kAhead planes ahead of
// the one in use.  The dependence of a half-step reaches one physical cell
// in k, i and j, so x is loaded with a halo of 2n planes and columns and
// n + 1 packed rows (a packed row holds two physical rows); the
// neighbouring tile recomputes those cells from the same inputs, so they
// are bitwise the same.  A thread owns the same cells at every level, so
// what a level needs from the thread's own column (its k neighbours, the
// centre two levels down, the I neighbour in the cell's own packed row)
// stays in registers; a level publishes each plane in shared memory only
// for its row and column neighbours, and reads the plane its neighbours
// published a step earlier, so a step takes one barrier for all 2n levels
// and an update three shared loads.  Every cell of the region is computed
// at every level without a branch (inner points update, the others carry):
// a cell off a level's cone holds a value that reaches no owned cell.  No
// division or modulo per point, one parity a lane.
//
// rb_row_sweeps_kernel, the 2n half-steps as grid-stride passes with a
// grid-wide sync between them: a warp takes a (k, i2) row (one division a
// row), its lanes the row's j, several points of a lane at once.  The
// first two half-steps write ``out`` from x (the shell copied), the others
// update ``out`` in place.
//
// What bounds them on an H100 (float32): at 512^3 (537 MB a field) the
// kernel this replaces moved the field once a colour (1151 us an
// iteration, 41% of the 3.35 TB/s peak); the row form moves it 1.5 times
// a half-step, the tile form about 1.3 times a launch of n iterations (the
// halos read again), and is held by its instructions an update and the
// cells it recomputes (about 1.5 a cell owned at n = 2).  At 128^3 the
// packed field (8.4 MB) stays in the 50 MB L2: bytes do not bound it, the
// row form's grid syncs and per-point latency do, and the tiles'
// recomputed halos cost more than the syncs they save (the plan takes the
// row form where x, out and b fit the L2; tools/prof_rbpack.py --depths).
//
// Residuals: each CTA sums dp^2 over the cells it owns in the field's
// type, one partial a colour (row form) or a level pair (tile form) and
// iteration; after a grid-wide sync the CTAs fold each iteration's
// partials in float64 in a fixed order: no atomics, so histories repeat
// bitwise from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- K1, K2 and K3: n iterations a launch ---------------------------------

// Cells of a region row in shared memory (a multiple of 32: kRow / 32 a
// lane), rows of a region at most, planes of x in flight, iterations a
// launch at most (make_packed_sweepnx's bound), threads of a tile CTA.
constexpr int kRow = 64;
constexpr int kRegionRows = 32;
constexpr int kAhead = 2;
constexpr int kMaxN = 9;
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;

// Values a 16-byte copy moves.
template <typename T>
constexpr int kVec = 16 / int(sizeof(T));

template <typename T>
struct Args {
  const T* x;
  const T* b;    // nullptr for a zero right-hand side
  const T* tab;  // MAF tables, nullptr for constant coefficients
  T* out;
  T* partials;   // per-CTA sums of dp^2: (2n, grid) rows, (n, grid) tiles
  double* r2;    // (n,) their float64 folds
  T omega;
  int K, I2, J, n, offset;
  // the tile form's plan: owned extents, tiles across i2 and j, owned
  // planes a work item, work items
  int ti, tj, tiles_i, tiles_j, kchunk, nwork;
};

// A plane's (axis 0), a row's (axis 1) or a column's (axis 2) MAF weights
// at a physical index of the (K, I, J) field; zeros outside the field (no
// update there reads them).
template <typename T>
__device__ __forceinline__ AxisWeights<T> axis_weights(const Args<T>& a, int axis, int idx) {
  const int I = 2 * a.I2;
  const int n = axis == 0 ? a.K : axis == 1 ? I : a.J;
  if (idx < 0 || idx >= n) return AxisWeights<T>{T(0), T(0), T(0)};
  const T* t = a.tab + (axis == 0 ? 0 : axis == 1 ? 3 * a.K : 3 * (a.K + I)) + idx;
  return AxisWeights<T>{t[0], t[n], t[2 * n]};
}

// dp of one point from its neighbours (kB: b points at its right-hand
// side) and weights (kMaf).
template <typename T, bool kMaf, bool kB>
__device__ __forceinline__ T point_dp(const AxisWeights<T>& wk, const AxisWeights<T>& wi,
                                      const AxisWeights<T>& wj, T zm, T zp, T xp, T xm, T yp,
                                      T ym, const T* b, T cen, T omega) {
  if constexpr (kMaf)
    return maf_dp(wk, wi, wj, zm, zp, xp, xm, yp, ym, kB ? b : nullptr, cen, omega);
  else
    return const_dp(zm, zp, xp, xm, yp, ym, kB ? b : nullptr, cen, omega);
}

// Fold each iteration's ``per`` x gridDim.x partials in float64 in a fixed
// order, after every CTA wrote its own.
template <int kT, typename T>
__device__ void fold_iterations(const Args<T>& a, int per) {
  cg::this_grid().sync();
  const int m = per * int(gridDim.x);
  for (int it = blockIdx.x; it < a.n; it += gridDim.x) {
    double s = 0;
    for (int q = threadIdx.x; q < m; q += kT) s += double(a.partials[size_t(it) * m + q]);
    s = block_sum<kT>(s);
    if (threadIdx.x == 0) a.r2[it] = s;
  }
}

// n iterations as 2n grid-stride half-steps (see the header); a lane takes
// kCells points of a row at once, so that their loads go out together.
template <typename T, bool kMaf, bool kB, int kCells>
__global__ void __launch_bounds__(kThreads) rb_row_sweeps_kernel(const __grid_constant__ Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t step = size_t(a.I2) * a.J;  // one k step
  const size_t half = a.K * step;          // one colour
  const int I = 2 * a.I2;
  for (int hs = 0; hs < 2 * a.n; ++hs) {
    const int c = hs & 1;
    const bool first = hs < 2;  // out's first write of colour c: every point
    const T* cs = (first ? a.x : a.out) + c * half;
    const T* __restrict__ o = hs == 0 ? a.x + half : a.out + (1 - c) * half;
    T* d = a.out + c * half;
    const T* bc = kB ? a.b + c * half : nullptr;
    const int k0 = first ? 0 : 1;
    const int rows = (first ? a.K : a.K - 2) * a.I2;
    T acc = 0;
    for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
      const int km = row / a.I2;
      const int k = k0 + km, i2 = row - km * a.I2;
      // the lane's points j = lane + 32 m share s, so their I neighbours
      // come from one pair of o's rows
      const int s = (k + lane + a.offset + 1 + c) & 1;
      const int i = 2 * i2 + s;
      const bool row_in = k >= 1 && k <= a.K - 2 && i >= 1 && i <= I - 2;
      if (!first && !row_in) continue;
      const size_t base = k * step + size_t(i2) * a.J;
      const T* up = o + base + (s ? a.J : 0);  // x[i+1]
      const T* dn = o + base - (s ? 0 : a.J);  // x[i-1], read where i >= 1
      AxisWeights<T> wk{}, wi{};
      if constexpr (kMaf) {
        wk = axis_weights(a, 0, k);
        wi = axis_weights(a, 1, i);
      }
      for (int j0 = lane; j0 < a.J; j0 += 32 * kCells) {
        T v[kCells], dp[kCells];
        bool on[kCells], upd[kCells];
#pragma unroll
        for (int m = 0; m < kCells; ++m) {
          const int j = j0 + 32 * m;
          const size_t p = base + j;
          upd[m] = row_in && j >= 1 && j <= a.J - 2;
          on[m] = j < a.J && (first || upd[m]);
          v[m] = on[m] ? cs[p] : T(0);
          dp[m] = T(0);
          if (upd[m]) {
            AxisWeights<T> wj{};
            if constexpr (kMaf) wj = axis_weights(a, 2, j);
            dp[m] = point_dp<T, kMaf, kB>(wk, wi, wj, o[p - step], o[p + step], up[j], dn[j],
                                          o[p + 1], o[p - 1], kB ? bc + p : nullptr, v[m],
                                          a.omega);
          }
        }
#pragma unroll
        for (int m = 0; m < kCells; ++m) {
          if (!on[m]) continue;
          if (upd[m]) {
            v[m] = add_rn(v[m], dp[m]);
            acc += dp[m] * dp[m];
          }
          d[base + j0 + 32 * m] = v[m];
        }
      }
    }
    const T tot = block_sum<kThreads>(acc);
    if (threadIdx.x == 0) a.partials[size_t(hs) * gridDim.x + blockIdx.x] = tot;
    grid.sync();
  }
  fold_iterations<kThreads>(a, 2);
}

// The work item's tile: packed row origin r0, column origin j0, owned
// extents (ni, nj), owned planes [k_lo, k_hi).
struct Tile {
  int r0, j0, ni, nj, k_lo, k_hi;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const Args<T>& a, int w) {
  const int tiles = a.tiles_i * a.tiles_j;
  const int kc = w / tiles;
  const int tt = w - kc * tiles;
  const int ty = tt / a.tiles_j;
  Tile t;
  t.r0 = ty * a.ti;
  t.j0 = (tt - ty * a.tiles_j) * a.tj;
  t.ni = min(a.ti, a.I2 - t.r0);
  t.nj = min(a.tj, a.J - t.j0);
  t.k_lo = kc * a.kchunk;
  t.k_hi = min(t.k_lo + a.kchunk, a.K);
  return t;
}

// A work item's region, the tile with a halo of n + 1 packed rows and 2n
// columns: region cell (r, q) is global packed (gr + r, gc + q) and sits
// at (r + 1) * kRow + q + sh in a shared plane (row 0 and row rows + 1 of
// a plane are padding, which the edge rows' neighbour reads may touch,
// and two rows more follow the last plane: a lane's cells past the
// region read up to a row and a few cells beyond their own).
// sh = gc mod kVec where the field's rows are 16-byte aligned (J a
// multiple of kVec), so that a plane copies in aligned 16-byte pieces;
// else 0.
struct Region {
  int gr, gc, rows, cols, sh;
};

// Copying one colour plane of a region into shared memory, each thread's
// share worked out once a work item.  ``aligned``: 16-byte pieces, each a
// shared-memory offset and an offset in a plane of x.  Else one value a
// piece, a warp a row.  An offset of -1 marks a piece outside the array
// (zero-filled: no cell that reaches ``out`` reads it).
template <typename T>
struct RegionCopy {
  static constexpr int kPieces = kRegionRows * (kRow / kVec<T>) / kTileThreads;
  static constexpr int kRows = kRegionRows / kTileWarps, kCols = kRow / 32;
  static_assert(kPieces >= kRows * kCols / kVec<T>, "a thread's share of a plane");
  bool aligned;
  int n = 0;
  int soff[kRows * kCols], goff[kRows * kCols];

  __device__ __forceinline__ RegionCopy(const Region& g, int I2, int J) {
    aligned = J % kVec<T> == 0;
    if (aligned) {
      const int base = g.gc - g.sh;
      const int per_row = (g.cols + g.sh + kVec<T> - 1) / kVec<T>;
#pragma unroll
      for (int m = 0; m < kPieces; ++m) {
        const int pc = threadIdx.x + m * kTileThreads;
        if (pc < g.rows * per_row) {
          const int r = pc / per_row, q = (pc - r * per_row) * kVec<T>;
          const int gi = g.gr + r, gj = base + q;
          soff[m] = (r + 1) * kRow + q;
          // a piece lies wholly inside [0, J) or wholly outside
          goff[m] = gi >= 0 && gi < I2 && gj >= 0 && gj < J ? gi * J + gj : -1;
          n = m + 1;
        }
      }
      return;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int r = warp + kTileWarps * m, q = lane + 32 * c;
        const int gi = g.gr + r, gj = g.gc + q;
        if (r < g.rows && q < g.cols) {
          soff[n] = (r + 1) * kRow + q;
          goff[n] = gi >= 0 && gi < I2 && gj >= 0 && gj < J ? gi * J + gj : -1;
          ++n;
        }
      }
    }
  }

  // Start copying the plane at src into dst; the caller commits the group.
  __device__ __forceinline__ void issue(T* dst, const T* src) const {
#pragma unroll
    for (int m = 0; m < kRows * kCols; ++m) {
      if (m >= n) break;
      const bool ok = goff[m] >= 0;
      if (aligned)
        cp_async16(dst + soff[m], ok ? src + goff[m] : src, ok);
      else
        cp_async(dst + soff[m], ok ? src + goff[m] : src, ok);
    }
  }
};

// N iterations in one pass over the field, x -> out (see the header).
// A thread's cells are rows warp and warp + kTileWarps and columns lane
// and lane + 32 of the region; each level keeps its last three planes at
// them in registers (fifo[h][0] is plane s - h, [1] and [2] the two
// before) and publishes its plane in shared memory (two slots a level, by
// plane parity) for its neighbours to read at the next step.  kB: a
// streamed b, read at the cells a level updates.
template <typename T, bool kMaf, int N, bool kB>
__global__ void __launch_bounds__(kTileThreads) rb_tile_sweeps_kernel(
    const __grid_constant__ Args<T> a) {
  constexpr int H = 2 * N, R = N + 1;
  constexpr int kRowsT = 2, kColsT = kRow / 32;  // a thread's rows and columns
  static_assert(kRowsT * kTileWarps >= kRegionRows, "rows a thread takes");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int area = (a.ti + 2 * R + 2) * kRow;
  const size_t plane = size_t(a.I2) * a.J, half = a.K * plane;
  // x's planes of colour c: three in use and kAhead in flight (a work
  // item's first steps run levels below plane 0: their cells reach nothing
  // owned, but their slots must lie in shared memory); level h's published
  // planes: two
  constexpr int kX = 3 + kAhead;
  auto xs = [&](int c, int p) { return sm + (c * kX + (p + 4 * kX) % kX) * area; };
  auto ls = [&](int h, int p) { return sm + (2 * kX + (h - 1) * 2 + (p & 1)) * area; };
  T acc[N];
#pragma unroll
  for (int it = 0; it < N; ++it) acc[it] = 0;
  // level h's last three planes at the thread's cells; set once, so that
  // every value the step loop carries is defined
  T fifo[H][3][kRowsT][kColsT];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < kRowsT; ++i)
#pragma unroll
        for (int j = 0; j < kColsT; ++j) fifo[h][d][i][j] = T(0);
  for (int w = blockIdx.x; w < a.nwork; w += gridDim.x) {
    const Tile t = tile_of(a, w);
    Region g;
    g.gr = t.r0 - R;
    g.gc = t.j0 - H;
    g.rows = t.ni + 2 * R;
    g.cols = t.nj + 2 * H;
    g.sh = a.J % kVec<T> == 0 ? ((g.gc % kVec<T>) + kVec<T>) % kVec<T> : 0;
    const RegionCopy<T> copy(g, a.I2, a.J);
    // the thread's cells: shared index, whether the row lies in the region,
    // inner for each parity of the row, inner column, owned, offset in a
    // plane of out
    int idx[kRowsT][kColsT], gofs[kRowsT][kColsT];
    bool live[kRowsT], in0[kRowsT], in1[kRowsT], own_r[kRowsT], cin[kColsT], own_c[kColsT];
#pragma unroll
    for (int i = 0; i < kRowsT; ++i) {
      const int r = warp + kTileWarps * i, gr = g.gr + r;
      live[i] = r < g.rows;
      in0[i] = gr >= 1 && gr <= a.I2 - 1;  // physical 2 gr inner
      in1[i] = gr >= 0 && gr <= a.I2 - 2;  // physical 2 gr + 1 inner
      own_r[i] = r >= R && r < R + t.ni;
#pragma unroll
      for (int j = 0; j < kColsT; ++j) {
        const int q = lane + 32 * j;
        idx[i][j] = (r + 1) * kRow + q + g.sh;
        gofs[i][j] = gr * a.J + g.gc + q;
      }
    }
#pragma unroll
    for (int j = 0; j < kColsT; ++j) {
      const int q = lane + 32 * j, gj = g.gc + q;
      cin[j] = q < g.cols && gj >= 1 && gj <= a.J - 2;
      own_c[j] = q >= H && q < H + t.nj;
    }
    // MAF: the cells' column weights and their rows' for each parity
    AxisWeights<T> wj[kColsT]{}, wi[2][kRowsT]{};
    if constexpr (kMaf) {
#pragma unroll
      for (int j = 0; j < kColsT; ++j) wj[j] = axis_weights(a, 2, g.gc + lane + 32 * j);
#pragma unroll
      for (int i = 0; i < kRowsT; ++i) {
        const int gr = g.gr + warp + kTileWarps * i;
        wi[0][i] = axis_weights(a, 1, 2 * gr);
        wi[1][i] = axis_weights(a, 1, 2 * gr + 1);
      }
    }
    auto load = [&](int p) {
      copy.issue(xs(0, p), a.x + p * plane);
      copy.issue(xs(1, p), a.x + half + p * plane);
    };
    const int s_lo = max(t.k_lo - H, 0), s_hi = min(t.k_hi + H, a.K);
    for (int d = 0; d < kAhead; ++d) {
      if (s_lo + d < s_hi) load(s_lo + d);
      cp_async_commit();
    }
    for (int s = s_lo; s < t.k_hi + H; ++s) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();  // plane s has landed; last step's planes are published;
                        // every read of the slots written below is done
      if (s + kAhead < s_hi) load(s + kAhead);
      cp_async_commit();
#pragma unroll
      for (int h = 1; h <= H; ++h) {
        const int p = s - h, c = (h - 1) & 1;
        const bool k_in = p >= 1 && p <= a.K - 2;
        const bool k_own = p >= t.k_lo && p < t.k_hi;
        // the other colour's plane p (x's colour 1 for level 1), published
        const T* __restrict__ op = h == 1 ? xs(1, p) : ls(h - 1, p);
        const int sp = (p + g.gc + lane + a.offset + 1 + c) & 1;  // the lane's parity
        const int ro = sp ? kRow : -kRow;  // the other I neighbour's row
        AxisWeights<T> wk{};
        if constexpr (kMaf) wk = axis_weights(a, 0, p);
        T* outp = a.out + c * half + p * plane;
#pragma unroll
        for (int i = 0; i < kRowsT; ++i) {
          if (!live[i]) continue;
          const bool rin = k_in && (sp ? in1[i] : in0[i]);
#pragma unroll
          for (int j = 0; j < kColsT; ++j) {
            const int x = idx[i][j];
            // the other colour at (p, own row), (p + 1) and (p - 1) and the
            // centre (level h - 2 at p), from registers or x's planes
            T o0, zp, zm, cen;
            if (h == 1) {
              o0 = op[x];
              zp = xs(1, p + 1)[x];
              zm = xs(1, p - 1)[x];
              cen = xs(0, p)[x];
            } else {
              o0 = fifo[h - 1][1][i][j];
              zp = fifo[h - 1][0][i][j];
              zm = fifo[h - 1][2][i][j];
              cen = h == 2 ? xs(1, p)[x] : fifo[h - 2][2][i][j];
            }
            const T other = op[x + ro];
            const bool u = rin && cin[j];
            AxisWeights<T> wij{};
            if constexpr (kMaf) wij = sp ? wi[1][i] : wi[0][i];
            // b only where the cell updates: off the field its offset is not
            const T* bp = nullptr;
            if constexpr (kB) {
              if (u) bp = a.b + c * half + size_t(p) * plane + gofs[i][j];
            }
            T dp = point_dp<T, kMaf, kB>(wk, wij, wj[j], zm, zp, sp ? other : o0,
                                         sp ? o0 : other, op[x + 1], op[x - 1], bp, cen,
                                         a.omega);
            dp = u ? dp : T(0);
            const T v = u ? add_rn(cen, dp) : cen;
            const bool own = k_own && own_r[i] && own_c[j];
            if (own) acc[(h - 1) >> 1] += dp * dp;
            if (h < H) {
              fifo[h][2][i][j] = fifo[h][1][i][j];
              fifo[h][1][i][j] = fifo[h][0][i][j];
              fifo[h][0][i][j] = v;
              ls(h, p)[x] = v;
            }
            if (h >= H - 1 && own) outp[gofs[i][j]] = v;
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the last reads of the slots before the next item's loads
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const T tot = block_sum<kTileThreads>(acc[it]);
    if (threadIdx.x == 0) a.partials[size_t(it) * gridDim.x + blockIdx.x] = tot;
  }
  fold_iterations<kTileThreads>(a, 1);
}

// Forms: 0 rows, 1 tiles (n = kTileN with a zero right-hand side; n = 1,
// K1's single iteration, with or without one).
constexpr int kTileN = 2;

__host__ __device__ constexpr int form_threads(int form) {
  return form == 0 ? kThreads : kTileThreads;
}

template <typename T, bool kMaf, bool kB>
const void* form_kernel(int form, int n) {
  if (form == 0)
    return reinterpret_cast<const void*>(rb_row_sweeps_kernel<T, kMaf, kB, kMaf ? 1 : 4>);
  if (form == 1 && n == 1)
    return reinterpret_cast<const void*>(rb_tile_sweeps_kernel<T, kMaf, 1, kB>);
  if (form == 1 && n == kTileN && !kB)
    return reinterpret_cast<const void*>(rb_tile_sweeps_kernel<T, kMaf, kTileN, false>);
  return nullptr;
}

// The kernel of (form, n; MAF; a right-hand side); nullptr where none is
// built.
template <typename T>
const void* sweeps_kernel(int form, int n, bool maf, bool has_b) {
  if (maf)
    return has_b ? form_kernel<T, true, true>(form, n) : form_kernel<T, true, false>(form, n);
  return has_b ? form_kernel<T, false, true>(form, n) : form_kernel<T, false, false>(form, n);
}

// CTAs of the kernel co-resident on the card at ``smem`` bytes of dynamic
// shared memory each (the cooperative launch's limit).  Raises the
// kernel's dynamic shared-memory limit to what the card allows first.
template <typename T>
int max_blocks(int form, int n, int maf, int has_b, int smem, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* k = sweeps_kernel<T>(form, n, maf != 0, has_b != 0);
  if (k == nullptr) return cudaErrorInvalidValue;
  int optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - int(attr.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, form_threads(form),
                                                    size_t(smem));
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// ptrs: x, b, tab, out, partials, r2.  iargs: form, n, K, I2, J, offset,
// ti, tj, tiles_i, tiles_j, kchunk, nwork, grid, smem, device.  The
// wrapper builds both arrays once for a set of fields.
template <typename T>
int launch_sweeps(void* const* ptrs, const int* iargs, double omega, void* stream) {
  const int form = iargs[0], grid = iargs[12], smem = iargs[13];
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
  a.n = iargs[1];
  a.K = iargs[2];
  a.I2 = iargs[3];
  a.J = iargs[4];
  a.offset = iargs[5];
  a.ti = iargs[6];
  a.tj = iargs[7];
  a.tiles_i = iargs[8];
  a.tiles_j = iargs[9];
  a.kchunk = iargs[10];
  a.nwork = iargs[11];
  const void* k = sweeps_kernel<T>(form, a.n, a.tab != nullptr, a.b != nullptr);
  if (k == nullptr || a.n < 1 || a.n > kMaxN || grid < 1) return cudaErrorInvalidValue;
  if (form != 0 && (grid > a.nwork || a.tj + 4 * a.n + kVec<T> - 1 > kRow ||
                    a.ti + 2 * (a.n + 1) > kRegionRows))
    return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(form_threads(form)), args, size_t(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_threads_per_block() { return kThreads; }

const char* cz_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int cz_rbn_max_blocks_f32(int form, int n, int maf, int has_b, int smem, int device,
                          int* out) {
  return max_blocks<float>(form, n, maf, has_b, smem, device, out);
}

int cz_rbn_max_blocks_f64(int form, int n, int maf, int has_b, int smem, int device,
                          int* out) {
  return max_blocks<double>(form, n, maf, has_b, smem, device, out);
}

int cz_rbn_sweeps_f32(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch_sweeps<float>(ptrs, iargs, omega, stream);
}

int cz_rbn_sweeps_f64(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch_sweeps<double>(ptrs, iargs, omega, stream);
}

}  // extern "C"
