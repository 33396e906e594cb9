// n lexicographic line Gauss-Seidel sweeps in one launch for Hopper
// (sm_90a), kernel P2.  It takes the place of the JAX package's
// diagonal-wavefront pcr step, cubez_tpu/ops/pcr_gs.py:33
// (make_pcr_gs_diag_step), which XLA runs as a fori_loop over the
// diagonals with the PCR stage tables a diagonal: no pallas_call computes
// it.
//
// The reference's pcr, pcr_eda and pcr_esa (cz_solver.f90:848-856; MAF
// cz_maf.f90:519-572) relax each K-line in place inside the (j, i) loop:
// serial line Gauss-Seidel.  On the skewed layout S[d, k, i] = X[k, i,
// d - i] (ops/psor_scan.py make_skew) line (i, j = d - i) reads the lines
// of diagonal d - 1 new and those of d + 1 old, so the diagonals d = 2 ...
// I + J - 4 run in order and the lines of one diagonal together.  A line's
// tridiagonal system over its n = K - 2 inner rows is solved by parallel
// cyclic reduction, K10's solve (pcr.cu) reused as it stands:
//   - up to 512 rows (MAF: 32 cuda_kernels/pcr.py MAF_SLABS rows), the line
//     form: a warp a line, its rows in registers, the stages by shuffles
//     (pcr_warp.cuh), the constant stage tables in shared memory padded
//     with zeros to 32 M rows (cuda_kernels/pcr.py::stage_tables);
//   - longer lines, the tile form: L lines of a CTA whole in shared memory,
//     a barrier a stage (pcr.cuh).
// The right-hand sides follow the JAX step (pcr_gs.py:90-114), not K10:
//   constant: d = ((((x[i-1] + x[j-1]) + x[i+1]) + x[j+1]) - b) * R6,
//     d += x[k=0] * R6 at the first inner row, d += x[k=K-1] * R6 at the last;
//   MAF: dw = 0.5 / ((c1 + c2) + c3), a = -(wzm dw) (0 on the first row),
//     c = -(wzp dw) (0 on the last), d = ((((wxp x[i+1] + wxm x[i-1])
//     + wyp x[j+1]) + wym x[j-1]) - b) dw, d += (wzm dw) x[k=0] on the
//     first row, d += (wzp dw) x[k=K-1] on the last;
// then the solve, dp = (s - x) * omega, x += dp, one round-to-nearest
// intrinsic an operation under --fmad=false: bitwise the plain twin
// (ops/pcr_gs.py::pcr_gs_diag_plain: K10's table solve, or
// ops/pcr.py::pcr_reduce_var under MAF).  The residual is the float64 sum
// of dp^2.
//
// A work item is kGsLines (line form) or L (tile form) consecutive lines of
// a diagonal.  Its rows lie I values apart in S, so the CTA stages the
// item's (K, lines) slab: it builds the right-hand sides with all its
// threads, a line's values of a row contiguous in i (coalesced loads, the
// line form's kBuild rows a thread in flight at once, each row's own x
// kept in a register for the write), into shared memory, solves, and
// writes the item back.
//
// One cooperative launch runs n sweeps, in place.  Task (s, d) relaxes the
// lines of diagonal d in sweep s; its inputs, the tasks that write what it
// reads, are (s, d - 1) (the upstream lines, new) and (s - 1, d + 1) (the
// downstream lines, sweep s - 1's; on the last diagonal (s - 1, d), its
// own old lines, which otherwise comes before (s - 1, d + 1)).  The values
// (s, d) overwrites, sweep s - 1's of diagonal d, are read by (s - 1, d + 1)
// (new there), (s, d - 1) (old there) and (s, d) itself: exactly its
// inputs, so running every task after its inputs orders the writes after
// the reads too, and every line sees the values of the serial order: n
// launches of one sweep, bit for bit.  A sweep has its own CTAs, each
// taking the items it, it + G, ... of each diagonal (G CTAs a sweep).
// The schedule: each sweep's CTAs walk their diagonals, and after each add
// one to their sweep's counter (progress.cuh); before diagonal d a CTA's
// thread 0 waits for its own sweep's counter to show d - 1 done by all G
// of them (G (d - 2): each waits for that, so no CTA of a sweep runs two
// diagonals ahead of another) and sweep s - 1's to show d + 1 done.  No
// grid-wide barrier; the counters are zeroed after the launch's last
// grid-wide sync, ready for the next.  cuda_kernels/pcr_gs.py states the
// inputs and the waits in Python (``inputs``, ``flag_waits``), and the CPU
// tests replay the CTAs in random orders the counters allow on the plain
// line relaxation.  The longest chain of waits is I + J - 5 + 2 (n - 1)
// diagonals for n sweeps, against n (I + J - 5) for n launches (128^3,
// n = 16: 281 against 4016).  (A grid-wide barrier a step of that chain
// in place of the counters measured slower at every n, PERF.md section 6.)
// Each CTA folds its threads' float64 sums of dp^2 in order, and after the
// last grid-wide sync the first CTA folds each sweep's CTA partials in
// order into r2[s] on the card: no atomics in the sums.
//
// What bounds it on an H100: a launch reads S and B and writes S once,
// 3 fields whatever its n (7.5 us at 128^3 float32 at 3.35 TB/s, 0.47 us
// a sweep at n = 16), and a sweep does K10's 42 operations a line row
// (MAF 122; 1.25 us at 128^3 at 67 TFLOP/s).  What bounds it more is the chain of 251 diagonals at 128^3, each a build, a
// PCR solve of log2(n) dependent stages and a write, with a
// synchronisation between two; n sweeps in flight share that chain's
// synchronisations and use n times the CTAs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "pcr.cuh"
#include "pcr_warp.cuh"
#include "progress.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kGsThreads = kPcrThreads;  // 256, as pcr.cuh's tile takes
constexpr int kGsWarps = kGsThreads / 32;
constexpr int kGsLines = kGsWarps;  // lines of a line-form item, a warp each
constexpr int kBuild = 4;           // rows a thread loads at once

template <typename T>
struct GsArgs {
  T* s;                       // S[d, k, i], updated in place
  const T* __restrict__ b;    // B, the same layout
  const T* __restrict__ tab;  // the stage tables, or the MAF weights
  double* partials;           // a float64 sum of dp^2 a CTA
  double* r2;                 // their fold, one a sweep
  unsigned* prog;             // a counter a sweep, zero at launch
  T omega;
  int K, I, J, pn, L;  // L: lines of a tile-form item
  int sweeps;          // n, sweeps of the launch
  int per_sweep;       // G, CTAs of a sweep
};

// A row's loads in LineRows::load.
enum { kXim, kXjm, kXip, kXjp, kBb, kOwn, kRowIn };

// The right-hand side (and under MAF the off-diagonals a, c) of row r of
// line (i, j) on the diagonal whose slab starts at sc (sdm, sdp: the
// diagonals either side, slab_ values from it; bd: B's slab).  x_lo,
// x_hi: the line's Dirichlet ends.  S's values are read through L2 (other
// CTAs wrote them before the counters the CTA waited for).

template <typename T, bool kMaf>
struct LineRows {
  const T *sdm, *sdp, *bd;
  size_t slab_;
  int I, n, i, j;
  T x_lo, x_hi;
  T c12, wxp, wxm, wyp, wym;  // MAF: the line's own weights

  __device__ __forceinline__ LineRows(const T* sc, const T* sdm_, const T* sdp_, const T* bd_,
                                      const MafTables<T>& w, int K, int I_, int i_, int j_)
      : sdm(sdm_), sdp(sdp_), bd(bd_), slab_(size_t(K) * I_), I(I_), n(K - 2), i(i_),
        j(j_) {
    x_lo = __ldcg(sc + i);
    x_hi = __ldcg(sc + size_t(K - 1) * I + i);
    c12 = wxp = wxm = wyp = wym = T(0);
    if constexpr (kMaf) {
      c12 = add_rn(__ldg(w.c1 + i), __ldg(w.c2 + j));
      wxp = __ldg(w.wxp + i);
      wxm = __ldg(w.wxm + i);
      wyp = __ldg(w.wyp + j);
      wym = __ldg(w.wym + j);
    }
  }

  // The loads of row r: x[i-1], x[j-1], x[i+1], x[j+1], b and the line's
  // own old x, into v.
  __device__ __forceinline__ void load(int r, T (&v)[kRowIn]) const {
    const size_t p = size_t(r + 1) * I + i;
    v[kXim] = __ldcg(sdm + p - 1);
    v[kXjm] = __ldcg(sdm + p);
    v[kXip] = __ldcg(sdp + p + 1);
    v[kXjp] = __ldcg(sdp + p);
    v[kBb] = __ldg(bd + p);
    v[kOwn] = __ldcg(sdm + slab_ + p);
  }

  // d of row r from its loads; under MAF also a and c.
  __device__ __forceinline__ T rhs(int r, const T (&v)[kRowIn], const MafTables<T>& w,
                                   T* av = nullptr, T* cv = nullptr) const {
    const int k = r + 1;
    T d;
    if constexpr (kMaf) {
      const T dw = div_rn(T(0.5), add_rn(c12, __ldg(w.c3 + k)));
      const T wzm = mul_rn(__ldg(w.wzm + k), dw), wzp = mul_rn(__ldg(w.wzp + k), dw);
      T t = add_rn(mul_rn(wxp, v[kXip]), mul_rn(wxm, v[kXim]));
      t = add_rn(t, mul_rn(wyp, v[kXjp]));
      t = add_rn(t, mul_rn(wym, v[kXjm]));
      d = mul_rn(sub_rn(t, v[kBb]), dw);
      if (r == 0) d = add_rn(d, mul_rn(wzm, x_lo));
      if (r == n - 1) d = add_rn(d, mul_rn(wzp, x_hi));
      if (av != nullptr) {
        *av = r == 0 ? T(0) : -wzm;
        *cv = r == n - 1 ? T(0) : -wzp;
      }
    } else {
      const T R6 = T(1.0 / 6.0);
      const T t = add_rn(add_rn(add_rn(v[kXim], v[kXjm]), v[kXip]), v[kXjp]);
      d = mul_rn(sub_rn(t, v[kBb]), R6);
      if (r == 0) d = add_rn(d, mul_rn(x_lo, R6));
      if (r == n - 1) d = add_rn(d, mul_rn(x_hi, R6));
    }
    return d;
  }

  // d of row r (and a, c under MAF), loading its row.
  __device__ __forceinline__ T rhs(int r, const MafTables<T>& w, T* av = nullptr,
                                   T* cv = nullptr) const {
    T v[kRowIn];
    load(r, v);
    return rhs(r, v, w, av, cv);
  }
};

// dp = (s - x) omega; x + dp stored at row r of line i of the slab sc;
// returns dp^2.
template <typename T>
__device__ __forceinline__ double relax_row(T* sc, int I, int i, int r, T s, T x, T omega) {
  const T dp = mul_rn(sub_rn(s, x), omega);
  sc[size_t(r + 1) * I + i] = add_rn(x, dp);
  return double(mul_rn(dp, dp));
}

// Runs diagonal(d) for the tasks (s, d) of this CTA's sweep s, each after
// its inputs.
template <typename T, typename F>
__device__ __forceinline__ void run_sweeps(const GsArgs<T>& a, int s, F&& diagonal) {
  const int d_last = a.I + a.J - 4;
  unsigned* p = a.prog + s;
  const unsigned G = a.per_sweep;
  for (int d = 2; d <= d_last; ++d) {
    if (threadIdx.x == 0) {
      if (d > 2) wait_at_least(p, G * (d - 2));                       // (s, d - 1)
      if (s > 0) wait_at_least(p - 1, G * (min(d + 1, d_last) - 1));  // (s - 1, d + 1)
    }
    __syncthreads();
    diagonal(d);  // its items each end with a __syncthreads
    if (threadIdx.x == 0) release_add(p);
  }
}

template <typename T>
__device__ __forceinline__ void fold(const GsArgs<T>& a, double acc) {
  const double tot = block_sum<kGsThreads>(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = tot;
  cg::this_grid().sync();
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < a.sweeps; q += kGsThreads) {
      double r = 0;
      for (int p = 0; p < a.per_sweep; ++p) r += a.partials[q * a.per_sweep + p];
      a.r2[q] = r;
      a.prog[q] = 0;  // every wait of the launch is over
    }
}

// ---- the line form ---------------------------------------------------------

template <typename T, bool kMaf, int M>
__global__ void __launch_bounds__(kGsThreads) pcr_gs_lines_kernel(
    const __grid_constant__ GsArgs<T> a) {
  constexpr int LS = 32 * M + 1;  // a line's stride in shared memory (odd)
  constexpr int kRowStep = kGsThreads / kGsLines;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.K, I = a.I, J = a.J, n = K - 2;
  const size_t slab = size_t(K) * I;
  // constant coefficients: the padded stage tables, once a launch
  T* tab = reinterpret_cast<T*>(smem);
  T* sm = tab;
  if constexpr (!kMaf) {
    const int nt = (3 * (a.pn - 1) + 3) * 32 * M;
    for (int q = threadIdx.x; q < nt; q += kGsThreads) tab[q] = a.tab[q];
    sm = tab + nt;
    __syncthreads();
  }
  const MafTables<T> w(a.tab, K, I, J);  // read only under kMaf
  // the build and the relaxation: line l of the item, rows r0, r0 + 32, ...
  const int l = threadIdx.x % kGsLines, r0 = threadIdx.x / kGsLines;
  // this CTA's sweep and first item of a diagonal
  const int s = blockIdx.x / a.per_sweep, item0 = blockIdx.x - s * a.per_sweep;
  double acc = 0;
  run_sweeps(a, s, [&](int d) {
    const int i_lo = max(1, d - (J - 2)), i_hi = min(I - 2, d - 1);
    const int items = (i_hi - i_lo + kGsLines) / kGsLines;
    T* sc = a.s + size_t(d) * slab;
    const T* bd = a.b + size_t(d) * slab;
    for (int it = item0; it < items; it += a.per_sweep) {
      const int i0 = i_lo + it * kGsLines;
      const int i = i0 + l;
      // 1. the right-hand sides of the item's lines into shared memory,
      // kBuild rows' loads in flight at once; a row's own x stays in a
      // register for the relaxation
      T own[M];
      if (i <= i_hi) {
        const LineRows<T, kMaf> lr(sc, sc - slab, sc + slab, bd, w, K, I, i, d - i);
#pragma unroll
        for (int t0 = 0; t0 < M; t0 += kBuild) {
          T v[kBuild][kRowIn];
#pragma unroll
          for (int u = 0; u < kBuild && t0 + u < M; ++u) {
            const int r = r0 + kRowStep * (t0 + u);
            if (r < n) lr.load(r, v[u]);
          }
#pragma unroll
          for (int u = 0; u < kBuild && t0 + u < M; ++u) {
            const int r = r0 + kRowStep * (t0 + u);
            if (r < n) {
              sm[l * LS + r] = lr.rhs(r, v[u], w);
              own[t0 + u] = v[u][kOwn];
            }
          }
        }
      }
      __syncthreads();
      // 2. a warp a line: the stages in registers, the solution back
      const int il = i0 + warp;
      if (il <= i_hi) {  // warp-uniform
        T dv[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int k = lane + 32 * m;
          dv[m] = k < n ? sm[warp * LS + k] : T(0);
        }
        if constexpr (kMaf) {
          const T c12 = add_rn(__ldg(w.c1 + il), __ldg(w.c2 + (d - il)));
          T av[M], cv[M];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int r = lane + 32 * m, k = r + 1;
            av[m] = cv[m] = T(0);
            if (r < n) {
              const T dw = div_rn(T(0.5), add_rn(c12, __ldg(w.c3 + k)));
              if (r > 0) av[m] = -mul_rn(__ldg(w.wzm + k), dw);
              if (r < n - 1) cv[m] = -mul_rn(__ldg(w.wzp + k), dw);
            }
          }
          pcr_warp_var<M>(av, cv, dv, n, a.pn, lane);
        } else {
          pcr_warp_tab<M>(dv, tab, a.pn, lane);
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int k = lane + 32 * m;
          if (k < n) sm[warp * LS + k] = dv[m];
        }
      }
      __syncthreads();
      // 3. the relaxation of the item's lines
      if (i <= i_hi) {
#pragma unroll
        for (int t = 0; t < M; ++t) {
          const int r = r0 + kRowStep * t;
          if (r < n) acc += relax_row(sc, I, i, r, sm[l * LS + r], own[t], a.omega);
        }
      }
      __syncthreads();  // the solutions are read before the next item's rows land
    }
  });
  fold(a, acc);
}

// ---- the tile form ---------------------------------------------------------

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kGsThreads) pcr_gs_tile_kernel(
    const __grid_constant__ GsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int K = a.K, I = a.I, J = a.J, n = K - 2, L = a.L;
  const size_t slab = size_t(K) * I, nL = size_t(n) * L;
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kGsThreads / L;
  const MafTables<T> w(a.tab, K, I, J);  // read only under kMaf
  const int s = blockIdx.x / a.per_sweep, item0 = blockIdx.x - s * a.per_sweep;
  double acc = 0;
  run_sweeps(a, s, [&](int d) {
    const int i_lo = max(1, d - (J - 2)), i_hi = min(I - 2, d - 1);
    const int items = (i_hi - i_lo + L) / L;
    T* sc = a.s + size_t(d) * slab;
    const T* bd = a.b + size_t(d) * slab;
    for (int it = item0; it < items; it += a.per_sweep) {
      const int i = i_lo + it * L + l;
      const bool line = i <= i_hi;
      const LineRows<T, kMaf> lr(sc, sc - slab, sc + slab, bd, w, K, I, line ? i : i_lo,
                                 line ? d - i : d - i_lo);
      const T* sol;
      if constexpr (kMaf) {
        for (int r = r0; r < n; r += rs) {
          T av = 0, cv = 0, dv = 0;
          if (line) dv = lr.rhs(r, w, &av, &cv);
          const size_t q = size_t(r) * L + l;
          sm[q] = av;
          sm[nL + q] = cv;
          sm[2 * nL + q] = dv;
        }
        __syncthreads();
        sol = pcr_solve_var(sm, sm + 3 * nL, n, a.pn, L);
      } else {
        for (int r = r0; r < n; r += rs) sm[size_t(r) * L + l] = line ? lr.rhs(r, w) : T(0);
        __syncthreads();
        sol = pcr_solve_tab(sm, sm + nL, a.tab, n, a.pn, L);
      }
      if (line)
        for (int r = r0; r < n; r += rs)
          acc += relax_row(sc, I, i, r, sol[size_t(r) * L + l],
                           __ldcg(sc + size_t(r + 1) * I + i), a.omega);
      __syncthreads();
    }
  });
  fold(a, acc);
}

// MAF lines of more than 32 bytes a lane (pcr.py MAF_SLABS: 8 slabs in
// float32, 4 in float64) take the tile form: no line-form kernel is built
// for them.
template <typename T, bool kMaf, int M>
const void* lines_kernel_if() {
  if constexpr (kMaf && M * sizeof(T) > 32)
    return nullptr;
  else
    return reinterpret_cast<const void*>(pcr_gs_lines_kernel<T, kMaf, M>);
}

template <typename T, bool kMaf>
const void* lines_kernel_m(int slabs) {
  switch (slabs) {
    case 1: return lines_kernel_if<T, kMaf, 1>();
    case 2: return lines_kernel_if<T, kMaf, 2>();
    case 4: return lines_kernel_if<T, kMaf, 4>();
    case 8: return lines_kernel_if<T, kMaf, 8>();
    case 16: return lines_kernel_if<T, kMaf, 16>();
    default: return nullptr;
  }
}

// slabs 0: the tile form.
template <typename T>
const void* gs_kernel(int slabs, bool maf) {
  if (slabs == 0)
    return maf ? reinterpret_cast<const void*>(pcr_gs_tile_kernel<T, true>)
               : reinterpret_cast<const void*>(pcr_gs_tile_kernel<T, false>);
  return maf ? lines_kernel_m<T, true>(slabs) : lines_kernel_m<T, false>(slabs);
}

// CTAs of the form co-resident on the card at ``smem`` bytes each (the
// cooperative launch's limit), after raising its dynamic shared-memory
// limit to what the card allows.
template <typename T>
int max_blocks(int slabs, int maf, int smem, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* k = gs_kernel<T>(slabs, maf != 0);
  if (k == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return e;
  int optin = 0, per_sm = 0, sms = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - int(attr.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kGsThreads, size_t(smem));
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// ptrs: s, b, tab, partials, r2, prog.  iargs: slabs (0: tile), maf, K, I,
// J, pn, L, grid, smem, device, sweeps, per_sweep.  The wrapper
// builds both arrays once for a set of fields.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* stream) {
  const int slabs = iargs[0], maf = iargs[1], grid = iargs[7], smem = iargs[8];
  cudaError_t e = cudaSetDevice(iargs[9]);
  if (e != cudaSuccess) return e;
  GsArgs<T> a;
  a.s = static_cast<T*>(ptrs[0]);
  a.b = static_cast<const T*>(ptrs[1]);
  a.tab = static_cast<const T*>(ptrs[2]);
  a.partials = static_cast<double*>(ptrs[3]);
  a.r2 = static_cast<double*>(ptrs[4]);
  a.prog = static_cast<unsigned*>(ptrs[5]);
  a.omega = T(omega);
  a.K = iargs[2];
  a.I = iargs[3];
  a.J = iargs[4];
  a.pn = iargs[5];
  a.L = iargs[6];
  a.sweeps = iargs[10];
  a.per_sweep = iargs[11];
  const void* k = gs_kernel<T>(slabs, maf != 0);
  if (k == nullptr || grid < 1 || a.K < 3 || a.I < 3 || a.J < 3 || a.b == nullptr ||
      a.tab == nullptr || (slabs > 0 && a.K - 2 > 32 * slabs) ||
      (slabs == 0 && (a.L < 1 || kGsThreads % a.L != 0)) || a.sweeps < 1 ||
      a.per_sweep < 1 || size_t(grid) != size_t(a.sweeps) * a.per_sweep ||
      a.prog == nullptr)
    return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kGsThreads), args, size_t(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_pcr_gs_max_blocks_f32(int slabs, int maf, int smem, int device, int* out) {
  return max_blocks<float>(slabs, maf, smem, device, out);
}

int cz_pcr_gs_max_blocks_f64(int slabs, int maf, int smem, int device, int* out) {
  return max_blocks<double>(slabs, maf, smem, device, out);
}

int cz_pcr_gs_sweep_f32(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<float>(ptrs, iargs, omega, stream);
}

int cz_pcr_gs_sweep_f64(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<double>(ptrs, iargs, omega, stream);
}

}  // extern "C"
