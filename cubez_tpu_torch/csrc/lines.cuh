// The one-thread line relaxation of K9's 'fastdiag' form (dist_pcr.cu).
// K5 (rblines.cu) and K6 (lines.cu) run the same arithmetic on
// line_tile.cuh's shared-memory tile.
//
// A line is the column of the K values at one (i, j).  Relaxing an inner
// line solves its K-tridiagonal system for the n = K - 2 inner values,
// with the Dirichlet values x[0] and x[K-1] folded into the ends, and
// moves the line by omega towards the solution.  One thread relaxes one
// line: a forward pass builds the right-hand side from the transverse
// neighbours and runs the Thomas elimination, keeping its intermediate
// values in a scratch field; a backward pass substitutes, relaxes and sums
// dp^2.  The systems are strictly diagonally dominant (constant: diagonal
// 1, off-diagonals -1/6; MAF: 2 c3_k + lambda_ij against wzm_k + wzp_k,
// lambda_ij = 2 (c1_i + c2_j) > 0), so Thomas needs no pivoting and is
// stable in float32.
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

#pragma once

#include <cstddef>

#include "common.cuh"

namespace cz {

constexpr int kLineThreads = 64;

// Where a line and its four transverse neighbours lie: the index of each
// one's k = 0 value in x (and b), the stride from k to k + 1 there and in
// the scratch, and the index of the line's k = 0 value in the scratch.
struct LineAt {
  size_t own, ip, im, jp, jm;  // the line; the lines at i+1, i-1, j+1, j-1
  size_t ks;                    // stride along k
  size_t s;                     // the line's k = 0 index in the scratch
};

// Relax the line ``at`` and return its sum of dp^2.  ``nb`` is read for
// the neighbours and the line's two Dirichlet values (never written while
// the kernel runs); the line's own inner values are read from ``xo`` and
// the relaxed ones written to ``xw`` (both x for an update in place).
// ``g`` holds the forward values (it may be xw: each is read before it is
// overwritten), ``e`` the MAF factors e_k.  ``lt``: the MAF tables
// (MafTables) for kMaf, else Q (K values) then E (K values).  (i, j) is
// the line's physical position, which indexes the MAF tables.
template <typename T, bool kMaf>
__device__ __forceinline__ T relax_line(const T* __restrict__ nb, const T* xo, T* xw,
                                        const T* __restrict__ b, T* g, T* e,
                                        const LineAt& at, const T* __restrict__ lt, int K,
                                        int I, int J, unsigned i, unsigned j, T omega) {
  const T R6 = T(1.0 / 6.0);
  const size_t ks = at.ks;
  const T x0 = nb[at.own];
  const T xK = nb[at.own + size_t(K - 1) * ks];
  const MafTables<T> w(lt, K, I, J);
  T s12 = 0, wxp = 0, wxm = 0, wyp = 0, wym = 0;
  if constexpr (kMaf) {
    s12 = add_rn(w.c1[i], w.c2[j]);
    wxp = w.wxp[i];
    wxm = w.wxm[i];
    wyp = w.wyp[j];
    wym = w.wym[j];
  }
  T gp = 0, ep = 0;
  for (int k = 1; k + 1 < K; ++k) {
    const size_t p = size_t(k) * ks;
    T d;
    if constexpr (kMaf) {
      d = add_rn(mul_rn(wxp, nb[at.ip + p]), mul_rn(wxm, nb[at.im + p]));
      d = add_rn(d, mul_rn(wyp, nb[at.jp + p]));
      d = add_rn(d, mul_rn(wym, nb[at.jm + p]));
      if (b != nullptr) d = sub_rn(d, b[at.own + p]);
      if (k == 1) d = add_rn(d, mul_rn(w.wzm[k], x0));
      if (k == K - 2) d = add_rn(d, mul_rn(w.wzp[k], xK));
      const T m = sub_rn(mul_rn(T(2), add_rn(s12, w.c3[k])), mul_rn(w.wzm[k], ep));
      const T q = div_rn(T(1), m);
      gp = mul_rn(add_rn(d, mul_rn(w.wzm[k], gp)), q);
      ep = mul_rn(w.wzp[k], q);
      e[at.s + p] = ep;
    } else {
      d = add_rn(add_rn(add_rn(nb[at.ip + p], nb[at.im + p]), nb[at.jp + p]), nb[at.jm + p]);
      if (b != nullptr) d = sub_rn(d, b[at.own + p]);
      d = mul_rn(d, R6);
      if (k == 1) d = add_rn(d, mul_rn(x0, R6));
      if (k == K - 2) d = add_rn(d, mul_rn(xK, R6));
      gp = mul_rn(add_rn(d, mul_rn(R6, gp)), lt[k]);
    }
    g[at.s + p] = gp;
  }
  T s = 0, acc = 0;
  for (int k = K - 2; k >= 1; --k) {
    const size_t p = size_t(k) * ks;
    T f;
    if constexpr (kMaf) {
      f = e[at.s + p];
    } else {
      f = lt[K + k];
    }
    s = add_rn(g[at.s + p], mul_rn(f, s));
    const T x = xo[at.own + p];
    const T dp = mul_rn(sub_rn(s, x), omega);
    xw[at.own + p] = add_rn(x, dp);
    acc = add_rn(acc, mul_rn(dp, dp));
  }
  return acc;
}

}  // namespace cz
