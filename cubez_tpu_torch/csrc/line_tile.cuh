// The shared-memory line tile of the line kernels K5 (rblines.cu), K6
// (lines.cu) and K9's 'fastdiag' form (dist_pcr.cu): Thomas line
// relaxation laid out for an H100.
//
// A line is the column of the K values at one (i, j).  Relaxing an inner
// line solves its K-tridiagonal system for the n = K - 2 inner values,
// with the Dirichlet values x[0] and x[K-1] folded into the ends, and
// moves the line by omega towards the solution.  The systems are strictly
// diagonally dominant (constant: diagonal 1, off-diagonals -1/6; MAF:
// 2 c3_k + lambda_ij against wzm_k + wzp_k, lambda_ij = 2 (c1_i + c2_j) >
// 0), so Thomas needs no pivoting and is stable in float32.
//
// Arithmetic contract (cuda_kernels/lines.py states it once more for the
// plain twins): every operation is one explicit round-to-nearest
// intrinsic and the sources are built with --fmad=false, so there is no
// fused multiply-add anywhere and a float32 line is bitwise the twin's.
//
// constant coefficients, R6 = 1/6 rounded to T, tables Q_k = 1/m_k and
// E_k = (1/6)/m_k of the Thomas factors m_1 = 1, m_k = 1 - E_{k-1}/6
// (computed on the host in float64, E_{K-2} = 0, then rounded to T):
//   d   = (((x[i+1] + x[i-1]) + x[j+1]) + x[j-1] - b) * R6
//   d  += x[k=0] * R6 at k = 1;  d += x[k=K-1] * R6 at k = K-2
//   g_k = (d + R6 * g_{k-1}) * Q_k                    (g_0 = 0)
//   s_k = g_k + E_k * s_{k+1}                          (s_{K-1} = 0)
// MAF, the weights of MafTables (common.cuh):
//   d   = ((wxp_i x[i+1] + wxm_i x[i-1]) + wyp_j x[j+1]) + wym_j x[j-1] - b
//   d  += wzm_1 x[k=0] at k = 1;  d += wzp_{K-2} x[k=K-1] at k = K-2
//   m_k = 2 ((c1_i + c2_j) + c3_k) - wzm_k e_{k-1}     (e_0 = 0)
//   q_k = 1 / m_k;  e_k = wzp_k q_k;  g_k = (d + wzm_k g_{k-1}) q_k
//   s_k = g_k + e_k s_{k+1}
// then for each inner k: dp = (s_k - x) * omega, x += dp.
// The MAF diagonal 2 ((c1 + c2) + c3) is the point sweeps' dd: a line
// solver and a point sweep see the same operator.
//
// Why a tile.  One thread walking a line's k values, loading the
// neighbours and b from global memory at every step and writing the
// forward values to a global scratch that the backward pass reads again,
// waits out an L2 round trip a step (214 ns a step for K5 at 128^3, H100
// 80GB HBM3), and at 512^3 the scratch is 40% of the bytes.  Here a CTA
// takes L lines of one colour, consecutive along j, whole, and keeps their
// right-hand sides in shared memory:
//
//   A (all threads)  d[k][l] for every inner (k, l) of the tile: the four
//                    neighbours, b, the scaling and the Dirichlet folds, in
//                    the contract's order; every load independent, in
//                    batches; the k tables, copied to shared memory;
//   B (a thread a line)  the forward recurrence out of shared memory, g
//                    over d in place (each d is read before it is
//                    overwritten); MAF: the factor chain m_k, q_k, e_k
//                    beside it, e in a second array;
//   C (the same threads)  the backward substitution, s over g;
//   D (all threads)  dp = (s - x) * omega, x += dp, read and written once,
//                    coalesced; per-thread sums of dp^2 folded in a fixed
//                    order into partials[tile] (no atomics).
//
// No global scratch is left, and a serial step of B or C is a few
// dependent operations on values already in shared memory (MAF's chain a
// division more), the next chunk of steps' loads in flight while a chunk's
// chain runs.  A thread keeps one lane l = t % L in phases A and D
// (blockDim.x is a multiple of L), so its line's position is computed
// once.  Only the residual's sum runs in another order than the twins'
// (per thread over its k values, then over the CTA).
//
// Aliasing.  ``nb`` (const __restrict__, read through the read-only path)
// holds the neighbours and the lines' two Dirichlet values.  Within one
// launch nothing writes them: a colour pass (K5, K6's red-black form, K9)
// updates only the inner values of its own colour's lines, whose
// neighbours are all of the other colour, and the line-Jacobi pass writes
// ``out``, never the field it reads.  So an update in place may pass the
// same field as ``nb`` and ``xw``.  Indices are 32-bit: the wrappers take
// fields of fewer than 2^31 values.

#pragma once

#include <cstddef>

#include "common.cuh"

namespace cz {

// The most threads a tile's CTA has (cuda_kernels/lines.py keeps the same
// bound for the static shared memory of the fold).
constexpr int kTileMaxThreads = 256;
// Steps of a line that phases B and C move between shared memory and
// registers at a time: the next chunk's loads are issued before this
// chunk's chain runs.  MAF's steps are longer (a division), so fewer of
// them hide the loads, in fewer registers.
template <bool kMaf>
constexpr int kChain = kMaf ? 4 : 8;

// Cells a thread loads before it computes: phase A ``A`` cells (five
// values each), phase D ``D`` values of x.  Half as many in float64.
template <typename T>
struct TileBatch {
  static constexpr int A = sizeof(T) == 4 ? 4 : 2;
  static constexpr int D = sizeof(T) == 4 ? 8 : 4;
};

// One line of a tile: the index in x (and b) of its k = 0 value and of its
// four transverse neighbours' (set for an inner line), its physical
// (i, j), whether it exists (a tile's last lanes may run past a row) and
// whether it is an inner line, which is relaxed.  Face lines only move in
// the line-Jacobi pass, which copies them.
struct TileLine {
  unsigned own, ip, im, jp, jm;
  unsigned i, j;
  bool valid, inner;
};

// The arguments of a tile launch; ``Lines::at(row, lane)`` places a line,
// the tile's L lines lying on one row of ``lanes`` lines.
template <typename T>
struct TileArgs {
  const T* __restrict__ nb;  // neighbours, Dirichlet values (and x for kOut)
  T* xw;                     // the relaxed field (x in place, or out)
  const T* __restrict__ b;   // right-hand side, nullptr for zero
  const T* __restrict__ lt;  // MafTables, or Q then E (the contract above)
  T* partials;               // one per tile
  unsigned ks;               // stride along k
  int K, I, J;               // I, J physical, for the MAF tables
  unsigned lanes;            // lines a row
  int L;                     // lines a tile
  T omega;
};

// The k tables of the recurrences, copied to shared memory: Q and E (2K
// values), or MAF's wzm, wzp and c3 (3K, MafTables' first three).
__host__ __device__ inline int tile_tables(int K, bool maf) { return (maf ? 3 : 2) * K; }

// Bytes of dynamic shared memory a tile of L lines takes: the tables,
// then d (g, s) and, for MAF, e, (K - 2) L values each.
__host__ __device__ inline size_t tile_smem_bytes(int K, int L, size_t tsize, bool maf) {
  return (size_t(tile_tables(K, maf)) + size_t(K - 2) * size_t(L) * (maf ? 2 : 1)) * tsize;
}

// Tiles of a launch over ``rows`` rows of ``lanes`` lines.
__host__ __device__ inline unsigned tile_count(unsigned rows, unsigned lanes, int L) {
  return rows * ((lanes + unsigned(L) - 1) / unsigned(L));
}

// kChain<kMaf> forward steps' inputs from step k: d, and Q (const) or c3, wzm,
// wzp (MAF); ``col`` is a line's column of d (k = 1 at col[0], stride L).
template <typename T, bool kMaf>
struct ForwardChunk {
  static constexpr int N = kChain<kMaf>;
  T d[N], t0[N], t1[N], t2[N];
  __device__ __forceinline__ void load(const T* col, const T* tsm, int k, int K, int L) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      d[c] = col[(k - 1 + c) * L];
      if constexpr (kMaf) {
        t0[c] = tsm[2 * K + k + c];  // c3
        t1[c] = tsm[k + c];          // wzm
        t2[c] = tsm[K + k + c];      // wzp
      } else {
        t0[c] = tsm[k + c];  // Q
      }
    }
  }
};

// kChain<kMaf> backward steps' inputs from step k down: g and the factor f (E
// from the tables, or MAF's e).
template <typename T, bool kMaf>
struct BackwardChunk {
  static constexpr int N = kChain<kMaf>;
  T g[N], f[N];
  __device__ __forceinline__ void load(const T* col, const T* ecol, const T* tsm, int k, int K,
                                       int L) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      g[c] = col[(k - 1 - c) * L];
      if constexpr (kMaf) {
        f[c] = ecol[(k - 1 - c) * L];
      } else {
        f[c] = tsm[K + k - c];  // E
      }
    }
  }
};

// One forward step of the Thomas recurrence: g_k from d_k and g_{k-1} (``gp``), and
// for MAF e_k from e_{k-1} (``ep``); ``q_or_c3`` is Q_k, or MAF's c3_k.
template <typename T, bool kMaf>
__device__ __forceinline__ void forward_step(T d, T q_or_c3, T wzm, T wzp, T s12, T& gp,
                                             T& ep) {
  if constexpr (kMaf) {
    const T m = sub_rn(mul_rn(T(2), add_rn(s12, q_or_c3)), mul_rn(wzm, ep));
    const T q = div_rn(T(1), m);
    gp = mul_rn(add_rn(d, mul_rn(wzm, gp)), q);
    ep = mul_rn(wzp, q);
  } else {
    gp = mul_rn(add_rn(d, mul_rn(T(1.0 / 6.0), gp)), q_or_c3);
  }
}

// Relax the L lines of tile blockIdx.x; kOut: out of place (the line-Jacobi
// pass, which also copies every face line and the k = 0 and K-1 values of
// the inner lines into ``xw``), else in place on the inner lines.
template <typename T, bool kMaf, bool kOut, class Lines>
__device__ __forceinline__ void relax_tile(const Lines& lines, const TileArgs<T>& a) {
  constexpr int kA = TileBatch<T>::A, kD = TileBatch<T>::D;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  __shared__ T warp_sums[kTileMaxThreads / 32];
  const int K = a.K, L = a.L;
  const unsigned ks = a.ks;
  T* const tsm = reinterpret_cast<T*>(tile_smem);  // the k tables
  T* const dsm = tsm + tile_tables(K, kMaf);       // d, then g, then s
  T* const esm = dsm + (K - 2) * L;                // MAF: e
  const unsigned per_row = (a.lanes + unsigned(L) - 1) / unsigned(L);
  const unsigned row = blockIdx.x / per_row;
  const int l = int(threadIdx.x) % L;
  const int krow = int(threadIdx.x) / L;  // this thread's first k - 1
  const int kstep = int(blockDim.x) / L;
  const TileLine ln = lines.at(row, (blockIdx.x % per_row) * unsigned(L) + unsigned(l));
  const MafTables<T> w(a.lt, K, a.I, a.J);
  const T R6 = T(1.0 / 6.0);

  // ---- A: the right-hand sides, every cell at once; the k tables ---------
  for (int t = int(threadIdx.x); t < tile_tables(K, kMaf); t += int(blockDim.x))
    tsm[t] = __ldg(a.lt + t);
  if (ln.inner) {
    const T x0 = __ldg(a.nb + ln.own);
    const T xK = __ldg(a.nb + ln.own + unsigned(K - 1) * ks);
    T wxp = 0, wxm = 0, wyp = 0, wym = 0;
    if constexpr (kMaf) {
      wxp = w.wxp[ln.i];
      wxm = w.wxm[ln.i];
      wyp = w.wyp[ln.j];
      wym = w.wym[ln.j];
    }
    for (int k = 1 + krow; k < K - 1; k += kA * kstep) {
      T v[kA][5];
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int kk = k + u * kstep;
        if (kk < K - 1) {
          const unsigned p = unsigned(kk) * ks;
          v[u][0] = __ldg(a.nb + ln.ip + p);
          v[u][1] = __ldg(a.nb + ln.im + p);
          v[u][2] = __ldg(a.nb + ln.jp + p);
          v[u][3] = __ldg(a.nb + ln.jm + p);
          v[u][4] = a.b != nullptr ? __ldg(a.b + ln.own + p) : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int kk = k + u * kstep;
        if (kk < K - 1) {
          T d;
          if constexpr (kMaf) {
            d = add_rn(mul_rn(wxp, v[u][0]), mul_rn(wxm, v[u][1]));
            d = add_rn(d, mul_rn(wyp, v[u][2]));
            d = add_rn(d, mul_rn(wym, v[u][3]));
            if (a.b != nullptr) d = sub_rn(d, v[u][4]);
            if (kk == 1) d = add_rn(d, mul_rn(w.wzm[kk], x0));
            if (kk == K - 2) d = add_rn(d, mul_rn(w.wzp[kk], xK));
          } else {
            d = add_rn(add_rn(add_rn(v[u][0], v[u][1]), v[u][2]), v[u][3]);
            if (a.b != nullptr) d = sub_rn(d, v[u][4]);
            d = mul_rn(d, R6);
            if (kk == 1) d = add_rn(d, mul_rn(x0, R6));
            if (kk == K - 2) d = add_rn(d, mul_rn(xK, R6));
          }
          dsm[(kk - 1) * L + l] = d;
        }
      }
    }
  }
  __syncthreads();

  // ---- B, C: the Thomas recurrences, a thread a line ---------------------
  if (int(threadIdx.x) < L && ln.inner) {
    T* const col = dsm + l;  // this line's d, k = 1 at col[0], stride L
    T* const ecol = esm + l;
    constexpr int kC = kChain<kMaf>;
    const int chunks = (K - 2) / kC;
    // forward, g over d (and e): whole chunks, the next one's loads issued
    // before this one's chain, then the last steps one by one
    {
      T gp = 0, ep = 0, s12 = 0;
      if constexpr (kMaf) s12 = add_rn(w.c1[ln.i], w.c2[ln.j]);
      ForwardChunk<T, kMaf> cur, nxt;
      if (chunks > 0) cur.load(col, tsm, 1, K, L);
      for (int ch = 0; ch < chunks; ++ch) {
        const int k = 1 + ch * kC;
        if (ch + 1 < chunks) nxt.load(col, tsm, k + kC, K, L);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          forward_step<T, kMaf>(cur.d[c], cur.t0[c], cur.t1[c], cur.t2[c], s12, gp, ep);
          cur.d[c] = gp;
          cur.t0[c] = ep;  // e_k (MAF)
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          col[(k - 1 + c) * L] = cur.d[c];
          if constexpr (kMaf) ecol[(k - 1 + c) * L] = cur.t0[c];
        }
        cur = nxt;
      }
      for (int k = 1 + chunks * kC; k < K - 1; ++k) {
        if constexpr (kMaf) {
          forward_step<T, kMaf>(col[(k - 1) * L], tsm[2 * K + k], tsm[k], tsm[K + k], s12, gp,
                                ep);
          ecol[(k - 1) * L] = ep;
        } else {
          forward_step<T, kMaf>(col[(k - 1) * L], tsm[k], T(0), T(0), s12, gp, ep);
        }
        col[(k - 1) * L] = gp;
      }
    }
    // backward, s_k = g_k + f_k s_{k+1} from k = K-2 down, s over g
    {
      BackwardChunk<T, kMaf> cur, nxt;
      T s = 0;
      if (chunks > 0) cur.load(col, ecol, tsm, K - 2, K, L);
      for (int ch = 0; ch < chunks; ++ch) {
        const int k = K - 2 - ch * kC;
        if (ch + 1 < chunks) nxt.load(col, ecol, tsm, k - kC, K, L);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          s = add_rn(cur.g[c], mul_rn(cur.f[c], s));
          cur.g[c] = s;
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) col[(k - 1 - c) * L] = cur.g[c];
        cur = nxt;
      }
      for (int k = K - 2 - chunks * kC; k >= 1; --k) {
        T f;
        if constexpr (kMaf) {
          f = ecol[(k - 1) * L];
        } else {
          f = tsm[K + k];
        }
        s = add_rn(col[(k - 1) * L], mul_rn(f, s));
        col[(k - 1) * L] = s;
      }
    }
  }
  __syncthreads();

  // ---- D: relax, write once, sum dp^2 ------------------------------------
  T acc = 0;
  if (kOut ? ln.valid : ln.inner) {
    // out of place every k (faces and the Dirichlet planes copied), in
    // place the inner k
    const int k_end = kOut ? K : K - 1;
    for (int k = (kOut ? 0 : 1) + krow; k < k_end; k += kD * kstep) {
      T xv[kD];
#pragma unroll
      for (int u = 0; u < kD; ++u) {
        const int kk = k + u * kstep;
        const unsigned p = ln.own + unsigned(kk) * ks;
        if (kk < k_end) xv[u] = kOut ? __ldg(a.nb + p) : a.xw[p];
      }
#pragma unroll
      for (int u = 0; u < kD; ++u) {
        const int kk = k + u * kstep;
        if (kk < k_end) {
          T xn = xv[u];
          if (ln.inner && kk >= 1 && kk <= K - 2) {
            const T dp = mul_rn(sub_rn(dsm[(kk - 1) * L + l], xv[u]), a.omega);
            xn = add_rn(xv[u], dp);
            acc = add_rn(acc, mul_rn(dp, dp));
          }
          a.xw[ln.own + unsigned(kk) * ks] = xn;
        }
      }
    }
  }
  // the CTA's sum in a fixed order: each warp by shuffles, then thread 0
  // over the warps
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T tot = 0;
    for (unsigned wi = 0; wi < blockDim.x / 32; ++wi) tot += warp_sums[wi];
    a.partials[blockIdx.x] = tot;
  }
}

// Launch ``kernel`` (a __global__ wrapper of relax_tile) over ``tiles``
// CTAs of ``threads`` threads with the tile's dynamic shared memory;
// ``expect`` is the tile count of the launch's geometry, which the host
// sized its partials by.  Returns a cudaError_t.
template <typename T, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, unsigned tiles, unsigned expect, int threads, int K, int L,
                 bool maf, int device, void* stream, Args... args) {
  if (tiles != expect || L < 1 || threads < 32 || threads > kTileMaxThreads ||
      threads % 32 != 0 || threads % L != 0 || K < 4)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t bytes = tile_smem_bytes(K, L, sizeof(T), maf);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  if (tiles == 0) return cudaSuccess;
  kernel<<<tiles, threads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace cz
