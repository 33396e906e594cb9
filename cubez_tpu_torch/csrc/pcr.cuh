// The parallel cyclic reduction (PCR) line solve shared by the line-PCR
// kernels, pcr.cu (K10) and dist_pcr.cu (K9's 'pcr' form).
//
// A tile of L lines of n rows each sits in shared memory, value (k, l) of
// an array at [k * L + l].  A CTA has kPcrThreads threads; thread t owns
// line t % L and the rows k = t / L + m * (kPcrThreads / L).  A stage reads
// one buffer, writes the other, and ends in __syncthreads(); the final 2x2
// pair inversion writes the solution into the second buffer.
//
// PCR reduces the tridiagonal system a[k] x[k-1] + x[k] + c[k] x[k+1] =
// d[k] (unit diagonal) in num_stage(n) - 1 stages at strides s = 1, 2, 4,
// ... and inverts the 2x2 pairs (k, k + s) at s = 2^(pn-1).  Every stage
// updates every row from rows k +- s, so a line's n rows go in parallel:
// log2(n) steps against Thomas's n serial ones.  Rows outside [0, n) read
// as zero (the reference's zero extension, cz_solver.f90:919-929; the TPU
// kernel rolls instead and relies on a[k] = 0 for k < s and c[k] = 0 for
// k >= n - s to multiply the wrapped values by zero).
//
// Arithmetic contract (cuda_kernels/pcr.py and ops/pcr.py hold the plain
// twins to it): one round-to-nearest intrinsic per operation, no fused
// multiply-add, in this order.
//   variable (pcr_solve_var), per stage:
//     e  = 1 / ((1 - a[k] c[k-s]) - c[k] a[k+s])
//     a' = (-e a[k]) a[k-s];  c' = (-e c[k]) c[k+s]
//     d' = e ((d[k] - a[k] d[k-s]) - c[k] d[k+s])
//   final, k < s:  x = (d[k] - c[k] d[k+s]) / (1 - a[k+s] c[k]) as
//                  (d[k] - c[k] d[k+s]) * (1 / (1 - a[k+s] c[k]))
//          k >= s: x = (d[k] - a[k] d[k-s]) * (1 / (1 - a[k] c[k-s]))
//   tables (pcr_solve_tab), stage p: d' = e_p ((d - ap_p d[k-s]) - cp_p d[k+s]),
//   final: x = (d - c_lo d[k+s]) jj (k < s), (d - a_hi[k-s] d[k-s]) jj[k-s]
//   (k >= s), the tables of cuda_kernels/pcr.py::build_tables (K10, evolved
//   in float64), or of cuda_kernels/dist_pcr.py::pattern_table (K9, evolved
//   by the variable stage's own operations in the field's type, so that a
//   line is bitwise pcr_solve_var's).

#pragma once

#include <cstddef>

#include "common.cuh"

namespace cz {

constexpr int kPcrThreads = 256;

// Variable-coefficient PCR on the tile whose a, c, d arrays (n * L values
// each, in that order) are in ``s0``; ``s1`` is a second buffer of the
// same size.  Returns the solution array (in one of the two buffers).
// Every thread of the CTA must call it.
template <typename T>
__device__ const T* pcr_solve_var(T* s0, T* s1, int n, int pn, int L) {
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kPcrThreads / L;
  const size_t nL = size_t(n) * L;
  for (int p = 0; p + 1 < pn; ++p) {
    const int s = 1 << p;
    const int sL = s * L;
    const T *a = s0, *c = s0 + nL, *d = s0 + 2 * nL;
    T *an = s1, *cn = s1 + nL, *dn = s1 + 2 * nL;
    for (int k = r0; k < n; k += rs) {
      const int q = k * L + l;
      const bool lo = k >= s, hi = k + s < n;
      const T al = lo ? a[q - sL] : T(0), cl = lo ? c[q - sL] : T(0);
      const T dl = lo ? d[q - sL] : T(0);
      const T ar = hi ? a[q + sL] : T(0), cr = hi ? c[q + sL] : T(0);
      const T dr = hi ? d[q + sL] : T(0);
      const T ak = a[q], ck = c[q];
      const T e = div_rn(T(1), sub_rn(sub_rn(T(1), mul_rn(ak, cl)), mul_rn(ck, ar)));
      an[q] = mul_rn(mul_rn(-e, ak), al);
      cn[q] = mul_rn(mul_rn(-e, ck), cr);
      dn[q] = mul_rn(e, sub_rn(sub_rn(d[q], mul_rn(ak, dl)), mul_rn(ck, dr)));
    }
    __syncthreads();
    T* t = s0;
    s0 = s1;
    s1 = t;
  }
  const int s = 1 << (pn - 1);
  const int sL = s * L;
  const T *a = s0, *c = s0 + nL, *d = s0 + 2 * nL;
  T* x = s1 + 2 * nL;
  for (int k = r0; k < n; k += rs) {
    const int q = k * L + l;
    if (k < s) {
      const bool hi = k + s < n;
      const T dh = hi ? d[q + sL] : T(0), ah = hi ? a[q + sL] : T(0);
      const T jj = div_rn(T(1), sub_rn(T(1), mul_rn(ah, c[q])));
      x[q] = mul_rn(sub_rn(d[q], mul_rn(c[q], dh)), jj);
    } else {
      const T jj = div_rn(T(1), sub_rn(T(1), mul_rn(a[q], c[q - sL])));
      x[q] = mul_rn(sub_rn(d[q], mul_rn(a[q], d[q - sL])), jj);
    }
  }
  __syncthreads();
  return x;
}

// Constant-coefficient PCR on the right-hand sides in ``d0`` (n * L
// values; ``d1`` a second buffer) with the stage tables ``tab``
// ((3 (pn - 1) + 3) rows of n values: ap, cp, e per stage, then c_lo,
// a_hi, jj).  Returns the solution array.  Every thread must call it.
template <typename T>
__device__ const T* pcr_solve_tab(T* d0, T* d1, const T* __restrict__ tab, int n, int pn,
                                  int L) {
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kPcrThreads / L;
  for (int p = 0; p + 1 < pn; ++p) {
    const int s = 1 << p;
    const int sL = s * L;
    const T* ap = tab + size_t(3 * p) * n;
    const T* cp = ap + n;
    const T* e = cp + n;
    for (int k = r0; k < n; k += rs) {
      const int q = k * L + l;
      const T dr = k >= s ? d0[q - sL] : T(0);     // d[k-s]
      const T dl = k + s < n ? d0[q + sL] : T(0);  // d[k+s]
      d1[q] = mul_rn(e[k], sub_rn(sub_rn(d0[q], mul_rn(ap[k], dr)), mul_rn(cp[k], dl)));
    }
    __syncthreads();
    T* t = d0;
    d0 = d1;
    d1 = t;
  }
  const int s = 1 << (pn - 1);
  const int sL = s * L;
  const T* c_lo = tab + size_t(3 * (pn - 1)) * n;
  const T* a_hi = c_lo + n;
  const T* jj = a_hi + n;
  for (int k = r0; k < n; k += rs) {
    const int q = k * L + l;
    if (k < s) {
      const T dh = k + s < n ? d0[q + sL] : T(0);
      d1[q] = mul_rn(sub_rn(d0[q], mul_rn(c_lo[k], dh)), jj[k]);
    } else {
      d1[q] = mul_rn(sub_rn(d0[q], mul_rn(a_hi[k - s], d0[q - sL])), jj[k - s]);
    }
  }
  __syncthreads();
  return d1;
}

}  // namespace cz
