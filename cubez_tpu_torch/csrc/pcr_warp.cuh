// The warp-resident parallel cyclic reduction (PCR) line solve of K10's
// line form (pcr.cu): one warp holds one line of n <= 32 M rows in its
// registers, row k = lane + 32 m in register m ("slab" m) of lane
// lane, rows past n zero.  A stage needs rows k - s and k + s of every
// row: for a stride s < 32 they are a lane rotation by s of the same slab
// (__shfl_sync), the lanes that wrap taking the neighbouring slab's
// rotated value (slab m - 1 below, m + 1 above); for s >= 32 they are the
// lane's own register m -+ s / 32.  So a stage is shuffles and registers,
// with no shared memory and no barrier; the strides are compile-time
// (Int<>), the stage count pn = num_stage(n) a run-time guard.
//
// Rows outside [0, n) read as zero (the reference's zero extension,
// cz_solver.f90:919-929): below row 0 by construction (slab -1 does not
// exist); above row n - 1 by an explicit test (variable coefficients) or
// because the rows past n stay +0 (the tables' zero padding).
//
// Arithmetic: that of pcr.cuh (pcr_solve_var, pcr_solve_tab), operation
// for operation, one round-to-nearest intrinsic each, so a line comes out
// bitwise as from the shared-memory solve and from the plain twins
// (cuda_kernels/pcr.py::pcr_solve, ops/pcr.py::pcr_reduce_var).

#pragma once

#include <cstddef>

#include "common.cuh"

namespace cz {

constexpr unsigned kFullMask = 0xffffffffu;

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<B>{}), f(Int<B + 1>{}), ..., f(Int<E - 1>{}).
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(Int<B>{});
    static_for<B + 1, E>(f);
  }
}

// log2 of the rows a line of M slabs holds (M a power of two, <= 16).
template <int M>
constexpr int kLogRows = M == 1 ? 5 : M == 2 ? 6 : M == 4 ? 7 : M == 8 ? 8 : 9;

// lo[m] = row k - S of the line (k = lane + 32 m), zero below row 0.
template <int S, int M, typename T>
__device__ __forceinline__ void rows_below(const T (&v)[M], T (&lo)[M], int lane) {
  if constexpr (S < 32) {
    T r[M];
#pragma unroll
    for (int m = 0; m < M; ++m) r[m] = __shfl_sync(kFullMask, v[m], (lane - S) & 31);
#pragma unroll
    for (int m = 0; m < M; ++m) lo[m] = lane >= S ? r[m] : (m > 0 ? r[m > 0 ? m - 1 : 0] : T(0));
  } else {
    constexpr int t = S / 32;
#pragma unroll
    for (int m = 0; m < M; ++m) lo[m] = m >= t ? v[m >= t ? m - t : 0] : T(0);
  }
}

// hi[m] = row k + S of the line, zero from row n on (kZero; else zero
// only past the registers' 32 M rows).
template <int S, int M, bool kZero, typename T>
__device__ __forceinline__ void rows_above(const T (&v)[M], T (&hi)[M], int lane, int n) {
  if constexpr (S < 32) {
    T r[M];
#pragma unroll
    for (int m = 0; m < M; ++m) r[m] = __shfl_sync(kFullMask, v[m], (lane + S) & 31);
#pragma unroll
    for (int m = 0; m < M; ++m)
      hi[m] = lane + S < 32 ? r[m] : (m + 1 < M ? r[m + 1 < M ? m + 1 : 0] : T(0));
  } else {
    constexpr int t = S / 32;
#pragma unroll
    for (int m = 0; m < M; ++m) hi[m] = m + t < M ? v[m + t < M ? m + t : 0] : T(0);
  }
  if constexpr (kZero) {
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (lane + 32 * m + S >= n) hi[m] = T(0);
  }
}

// Constant coefficients: the right-hand sides d of the line, solved in
// place with the stage tables ``tab`` in shared memory
// (cuda_kernels/pcr.py::build_tables: ap, cp, e of each stage, then c_lo,
// a_hi, jj), each row padded with zeros to 32 M values.  The padding keeps
// the rows past n at +0 through every stage (e = 0 there), which is what a
// row reading past the line's end must see, so no stage tests a row
// against n.  Every lane of the warp must call it.
template <int M, typename T>
__device__ __forceinline__ void pcr_warp_tab(T (&d)[M], const T* tab, int pn, int lane) {
  constexpr int TS = 32 * M;  // a padded table row
  static_for<0, kLogRows<M>>([&](auto P) {
    constexpr int p = decltype(P)::value, S = 1 << p;
    if (p + 1 >= pn) return;
    const T* ap = tab + 3 * p * TS;
    const T* cp = ap + TS;
    const T* e = cp + TS;
    T lo[M], hi[M];
    rows_below<S, M>(d, lo, lane);
    rows_above<S, M, false>(d, hi, lane, 0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = lane + 32 * m;
      d[m] = mul_rn(e[k], sub_rn(sub_rn(d[m], mul_rn(ap[k], lo[m])), mul_rn(cp[k], hi[m])));
    }
  });
  const T* c_lo = tab + 3 * (pn - 1) * TS;
  const T* a_hi = c_lo + TS;
  const T* jj = a_hi + TS;
  static_for<0, kLogRows<M> + 1>([&](auto P) {
    constexpr int S = 1 << decltype(P)::value;
    if (S != 1 << (pn - 1)) return;
    T lo[M], hi[M];
    rows_below<S, M>(d, lo, lane);
    rows_above<S, M, false>(d, hi, lane, 0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = lane + 32 * m;
      if (k < S)
        d[m] = mul_rn(sub_rn(d[m], mul_rn(c_lo[k], hi[m])), jj[k]);
      else
        d[m] = mul_rn(sub_rn(d[m], mul_rn(a_hi[k - S], lo[m])), jj[k - S]);
    }
  });
}

// Variable coefficients: a[k] x[k-1] + x[k] + c[k] x[k+1] = d[k], solved
// into d.  Every lane of the warp must call it.
template <int M, typename T>
__device__ __forceinline__ void pcr_warp_var(T (&a)[M], T (&c)[M], T (&d)[M], int n, int pn,
                                             int lane) {
  static_for<0, kLogRows<M>>([&](auto P) {
    constexpr int p = decltype(P)::value, S = 1 << p;
    if (p + 1 >= pn) return;
    T al[M], ar[M], cl[M], cr[M], dl[M], dr[M];
    rows_below<S, M>(a, al, lane);
    rows_above<S, M, true>(a, ar, lane, n);
    rows_below<S, M>(c, cl, lane);
    rows_above<S, M, true>(c, cr, lane, n);
    rows_below<S, M>(d, dl, lane);
    rows_above<S, M, true>(d, dr, lane, n);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const T e = div_rn(T(1), sub_rn(sub_rn(T(1), mul_rn(a[m], cl[m])), mul_rn(c[m], ar[m])));
      const T an = mul_rn(mul_rn(-e, a[m]), al[m]);
      const T cn = mul_rn(mul_rn(-e, c[m]), cr[m]);
      d[m] = mul_rn(e, sub_rn(sub_rn(d[m], mul_rn(a[m], dl[m])), mul_rn(c[m], dr[m])));
      a[m] = an;
      c[m] = cn;
    }
  });
  static_for<0, kLogRows<M> + 1>([&](auto P) {
    constexpr int S = 1 << decltype(P)::value;
    if (S != 1 << (pn - 1)) return;
    T ah[M], cl[M], dl[M], dh[M];
    rows_above<S, M, true>(a, ah, lane, n);
    rows_below<S, M>(c, cl, lane);
    rows_below<S, M>(d, dl, lane);
    rows_above<S, M, true>(d, dh, lane, n);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int k = lane + 32 * m;
      if (k < S) {
        const T jj = div_rn(T(1), sub_rn(T(1), mul_rn(ah[m], c[m])));
        d[m] = mul_rn(sub_rn(d[m], mul_rn(c[m], dh[m])), jj);
      } else {
        const T jj = div_rn(T(1), sub_rn(T(1), mul_rn(a[m], cl[m])));
        d[m] = mul_rn(sub_rn(d[m], mul_rn(a[m], dl[m])), jj);
      }
    }
  });
}

}  // namespace cz
