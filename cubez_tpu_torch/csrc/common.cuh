// Helpers shared by the port's kernels (rbpack.cu, sweeps.cu, lines.cu,
// rblines.cu).
//
// Every floating-point operation of a sweep goes through an explicit
// round-to-nearest intrinsic, and the sources are built with --fmad=false,
// so the compiler contracts nothing: the only fused multiply-adds are the
// fma_rn calls the arithmetic contracts name (cuda_kernels/rbpack.py).

#pragma once

#include <cuda_runtime.h>

namespace cz {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// The MAF weight vectors (cuda_kernels/rbpack.py::maf_tables): one array,
// wzm, wzp, c3 of length K, then wxp, wxm, c1 of length I, then wyp, wym,
// c2 of length J, indexed by the physical k, i and j of a point.
template <typename T>
struct MafTables {
  const T *wzm, *wzp, *c3, *wxp, *wxm, *c1, *wyp, *wym, *c2;
  __device__ __forceinline__ MafTables(const T* t, unsigned K, unsigned I, unsigned J)
      : wzm(t), wzp(t + K), c3(t + 2 * K), wxp(t + 3 * K), wxm(t + 3 * K + I),
        c1(t + 3 * K + 2 * I), wyp(t + 3 * K + 3 * I), wym(t + 3 * K + 3 * I + J),
        c2(t + 3 * K + 3 * I + 2 * J) {}
};

// One axis's MAF weights at an index: (wzm, wzp, c3) of a plane k,
// (wxp, wxm, c1) of a row i, (wyp, wym, c2) of a column j.
template <typename T>
struct AxisWeights {
  T w0, w1, c;
};

// dp of the MAF contract at a point from its axes' weights, its six
// neighbours and centre: r = fma(wzm, zm, wzp*zp), then fma for x+, x-,
// y+, y- in that order, r += b (with a right-hand side, b != nullptr),
// dp = (r / dd - centre) * omega with dd = 2 ((c1 + c2) + c3).
template <typename T>
__device__ __forceinline__ T maf_dp(const AxisWeights<T>& wk, const AxisWeights<T>& wi,
                                    const AxisWeights<T>& wj, T zm, T zp, T xp, T xm, T yp,
                                    T ym, const T* b, T cen, T omega) {
  T r = fma_rn(wk.w0, zm, mul_rn(wk.w1, zp));
  r = fma_rn(wi.w0, xp, r);
  r = fma_rn(wi.w1, xm, r);
  r = fma_rn(wj.w0, yp, r);
  r = fma_rn(wj.w1, ym, r);
  if (b != nullptr) r = add_rn(r, *b);
  const T dd = mul_rn(T(2), add_rn(add_rn(wi.c, wj.c), wk.c));
  return mul_rn(sub_rn(div_rn(r, dd), cen), omega);
}

// The same at physical point (k, i, j), its weights read from the tables.
template <typename T>
__device__ __forceinline__ T maf_dp(const MafTables<T>& w, unsigned k, unsigned i, unsigned j,
                                    T zm, T zp, T xp, T xm, T yp, T ym, const T* b, T cen,
                                    T omega) {
  return maf_dp(AxisWeights<T>{w.wzm[k], w.wzp[k], w.c3[k]},
                AxisWeights<T>{w.wxp[i], w.wxm[i], w.c1[i]},
                AxisWeights<T>{w.wyp[j], w.wym[j], w.c2[j]}, zm, zp, xp, xm, yp, ym, b, cen,
                omega);
}

// dp of the constant-coefficient contract: ss = ((zm+zp) + (xm+xp)) +
// (ym+yp), ss -= b, dp = fma(ss, 1/6, -centre) * omega.
template <typename T>
__device__ __forceinline__ T const_dp(T zm, T zp, T xp, T xm, T yp, T ym, const T* b, T cen,
                                      T omega) {
  T ss = add_rn(add_rn(add_rn(zm, zp), add_rn(xm, xp)), add_rn(ym, yp));
  if (b != nullptr) ss = sub_rn(ss, *b);
  return mul_rn(fma_rn(ss, T(1.0 / 6.0), -cen), omega);
}

// dp at packed point p of a colour plane (cuda_kernels/rbpack.py's layout,
// planes of (K, I2, J)): physical (k, i = 2*i2 + s, j), centre value cen,
// ``o`` the other colour's plane.  Its K and J neighbours are o's same
// (k, i2, j) one row or lane away; its I neighbours o's rows i2 and
// i2 - 1 + 2s.  The caller keeps i in [1, 2*I2 - 2].  kMaf takes the MAF
// weights of a (K, 2*I2, J) field.
template <typename T, bool kMaf>
__device__ __forceinline__ T packed_dp(const T* __restrict__ o, const T* b,
                                       const T* __restrict__ tab, T cen, size_t p,
                                       unsigned k, unsigned i2, unsigned j, unsigned s,
                                       unsigned K, unsigned I2, unsigned J, T omega) {
  const size_t row = size_t(I2) * J;  // one k step
  const T xp = s ? o[p + J] : o[p];
  const T xm = s ? o[p] : o[p - J];
  if constexpr (kMaf) {
    const MafTables<T> w(tab, K, 2 * I2, J);
    return maf_dp(w, k, 2 * i2 + s, j, o[p - row], o[p + row], xp, xm, o[p + 1],
                  o[p - 1], b, cen, omega);
  } else {
    return const_dp(o[p - row], o[p + row], xp, xm, o[p + 1], o[p - 1], b, cen, omega);
  }
}

// An asynchronous copy of one value from global to shared memory
// (cp.async, sm_80+), zero-filled where ``valid`` is false (src is then
// not read); commit_group closes the copies issued so far into a group,
// wait_all waits for every group of this thread.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte values");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 8 : 0));
}

// 16 bytes, both addresses 16-byte aligned; zero-filled where ``valid``
// is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most ``kPending`` of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Sum over a block of kThreads threads (a multiple of 32) in a fixed
// order; the result is valid in thread 0.  Every thread must call it.
template <int kThreads, typename A>
__device__ A block_sum(A v) {
  __shared__ A warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  A tot = 0;
  if (warp == 0) {
    tot = lane < kThreads / 32 ? warp_sums[lane] : A(0);
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_down_sync(0xffffffffu, tot, o);
  }
  __syncthreads();  // warp_sums is reused by the next call
  return tot;
}

// The sum of v over the CTA's threads (blockDim.x, a multiple of 32, at
// most 1024) in a fixed order: a warp's lanes by shuffles, then the
// warps in order.  Thread 0 holds the result.
template <typename A>
__device__ A block_sum_any(A v) {
  __shared__ A warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  A tot = 0;
  if (warp == 0) {
    tot = lane < int(blockDim.x >> 5) ? warp_sums[lane] : A(0);
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_down_sync(0xffffffffu, tot, o);
  }
  __syncthreads();  // warp_sums is reused by the next call
  return tot;
}

}  // namespace cz
