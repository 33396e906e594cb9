// Serial line-PCR pass for Hopper (sm_90a): the CUDA counterpart of the JAX
// package's fused line-PCR kernel K10, cubez_tpu/pallas_kernels/pcr.py:414
// (make_fused_pcr -> _pcr_kernel).
//
// One pass relaxes the inner K-lines of the (K, I, J) field: it builds
// each line's tridiagonal system over its n = K - 2 inner rows from the
// transverse neighbours (the Dirichlet values x[0] and x[K-1] folded into
// its ends), solves it by PCR (pcr.cuh) and moves the line by omega
// towards the solution: the reference's pcr family (cz_solver.f90:497-
// 1676).  Constant coefficients run the table-driven solve (the stage
// tables of cuda_kernels/pcr.py::build_tables, one row of n values per
// table); MAF the variable one, on the unit-diagonal system normalised by
// dw = 0.5 / ((c1 + c2) + c3) (cz_maf.f90:519-572).
//
//   colour 0 or 1: the lines with (i + j + offset) % 2 == colour, in place
//     (a colour line reads only lines of the other colour); a CTA takes L
//     lines of one colour in one row i, so half the lines cost nothing;
//   colour -1: every inner line from the pre-pass field, OUT OF PLACE into
//     ``out`` (the line-Jacobi pass); every value of ``out`` is written,
//     the boundary lines and planes copied.
//
// Layout: the (K, I, J) field as it is, J contiguous, as K6; the TPU
// kernel's (I+2, Kp, Jp) line layout and (8, 128) padding are dropped.
//
// Arithmetic (cuda_kernels/pcr.py states it for the plain twin), one
// round-to-nearest intrinsic per operation, built with --fmad=false:
//   constant: d = ((((x[i+1] + x[i-1]) + x[j+1]) + x[j-1]) - b) * R6,
//     d += x[k=0] * R6 at k = 1, d += x[k=K-1] * R6 at k = K-2;
//   MAF: dw = 0.5 / ((c1 + c2) + c3), a = -(wzm dw) (0 at k = 1),
//     c = -(wzp dw) (0 at k = K-2),
//     d = ((((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym x[j-1]) - b) dw,
//     d += (wzm dw) x[k=0] at k = 1, d += (wzp dw) x[k=K-1] at k = K-2;
//   then the PCR solve of pcr.cuh, dp = (s - x) * omega, x + dp.
//
// What bounds it on an H100: at 128^3 the field (8.4 MB) sits in L2 and a
// colour pass reads it once and writes half the inner cells, 12.4 MB, 3.7
// us at 3.35 TB/s.  The work is 4 + 5 (pn - 1) + 8 operations an updated
// row with tables, 15 + 16 (pn - 1) + 11 under MAF (pn = 7 at 128^3),
// about 0.04 and 0.12 GFLOP a colour pass, 0.6 and 1.8 us at 67 TFLOP/s:
// bytes bound it, and in practice shared-memory traffic and the stages'
// __syncthreads().  One thread per (line, row) keeps 256 threads a CTA busy
// in every stage.
//
// Residuals: each CTA reduces its sum of dp^2 in a fixed order into
// partials[block]; the host folds the partials in float64.

#include <cuda_runtime.h>

#include <cstddef>

#include "pcr.cuh"

namespace {

using namespace cz;

template <typename T, bool kMaf, bool kJacobi>
__global__ void __launch_bounds__(kPcrThreads) fused_pcr_kernel(
    const T* x, const T* __restrict__ b, const T* __restrict__ tab, T* out, T* partials,
    int K, int I, int J, int L, int colour, int offset, int pn, T omega) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int n = K - 2;
  const size_t nL = size_t(n) * L;
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kPcrThreads / L;
  const size_t plane = size_t(I) * J;
  int i, j;
  bool column;
  if (kJacobi) {
    i = blockIdx.y;
    j = blockIdx.x * L + l;
    column = j < J;
  } else {
    i = blockIdx.y + 1;
    j = (((colour + i + offset) & 1) ? 1 : 2) + 2 * int(blockIdx.x * L + l);
    column = j <= J - 2;
  }
  const bool line = column && i >= 1 && i <= I - 2 && j >= 1 && j <= J - 2;
  const size_t col = size_t(i) * J + j;
  const size_t top = col + size_t(K - 1) * plane;
  const T R6 = T(1.0 / 6.0);

  const T* sol;
  if constexpr (kMaf) {
    const MafTables<T> w(tab, K, I, J);
    T* s0 = sm;
    for (int r = r0; r < n; r += rs) {
      T a = 0, c = 0, d = 0;
      if (line) {
        const int k = r + 1;
        const size_t p = size_t(k) * plane + col;
        const T dw = div_rn(T(0.5), add_rn(add_rn(w.c1[i], w.c2[j]), w.c3[k]));
        const T wzm = mul_rn(w.wzm[k], dw), wzp = mul_rn(w.wzp[k], dw);
        a = r == 0 ? T(0) : -wzm;
        c = r == n - 1 ? T(0) : -wzp;
        T t = add_rn(mul_rn(w.wxp[i], x[p + J]), mul_rn(w.wxm[i], x[p - J]));
        t = add_rn(t, mul_rn(w.wyp[j], x[p + 1]));
        t = add_rn(t, mul_rn(w.wym[j], x[p - 1]));
        if (b != nullptr) t = sub_rn(t, b[p]);
        d = mul_rn(t, dw);
        if (r == 0) d = add_rn(d, mul_rn(wzm, x[col]));
        if (r == n - 1) d = add_rn(d, mul_rn(wzp, x[top]));
      }
      const int q = r * L + l;
      s0[q] = a;
      s0[nL + q] = c;
      s0[2 * nL + q] = d;
    }
    __syncthreads();
    sol = pcr_solve_var(s0, s0 + 3 * nL, n, pn, L);
  } else {
    for (int r = r0; r < n; r += rs) {
      T d = 0;
      if (line) {
        const size_t p = size_t(r + 1) * plane + col;
        T t = add_rn(add_rn(add_rn(x[p + J], x[p - J]), x[p + 1]), x[p - 1]);
        if (b != nullptr) t = sub_rn(t, b[p]);
        d = mul_rn(t, R6);
        if (r == 0) d = add_rn(d, mul_rn(x[col], R6));
        if (r == n - 1) d = add_rn(d, mul_rn(x[top], R6));
      }
      sm[r * L + l] = d;
    }
    __syncthreads();
    sol = pcr_solve_tab(sm, sm + nL, tab, n, pn, L);
  }

  T acc = 0;
  if (line) {
    for (int r = r0; r < n; r += rs) {
      const size_t p = size_t(r + 1) * plane + col;
      const T xv = x[p];
      const T dp = mul_rn(sub_rn(sol[r * L + l], xv), omega);
      out[p] = add_rn(xv, dp);
      acc = add_rn(acc, mul_rn(dp, dp));
    }
    if (kJacobi && r0 == 0) {
      out[col] = x[col];
      out[top] = x[top];
    }
  } else if (kJacobi && column) {
    for (int k = r0; k < K; k += rs) out[col + size_t(k) * plane] = x[col + size_t(k) * plane];
  }
  const T tot = block_sum<kPcrThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

template <typename T, bool kMaf, bool kJacobi>
int launch_one(const void* x, const void* b, const void* tab, void* out, void* partials, int K,
               int I, int J, int L, int colour, int offset, int pn, T omega, dim3 grid,
               size_t smem, cudaStream_t s) {
  auto kernel = fused_pcr_kernel<T, kMaf, kJacobi>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kPcrThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(tab),
      static_cast<T*>(out), static_cast<T*>(partials), K, I, J, L, colour, offset, pn, omega);
  return cudaGetLastError();
}

// colour -1: line-Jacobi into out; 0/1: one colour in place (out == x).
template <typename T>
int launch(const void* x, const void* b, const void* tab, void* out, void* partials, int K,
           int I, int J, int L, int colour, int offset, int pn, double omega, int maf,
           int gx, int gy, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = size_t(maf ? 6 : 2) * size_t(K - 2) * L * sizeof(T);
  const dim3 grid(gx, gy);
  auto s = static_cast<cudaStream_t>(stream);
  const T om = T(omega);
  if (colour < 0) {
    return maf ? launch_one<T, true, true>(x, b, tab, out, partials, K, I, J, L, colour, offset,
                                           pn, om, grid, smem, s)
               : launch_one<T, false, true>(x, b, tab, out, partials, K, I, J, L, colour,
                                            offset, pn, om, grid, smem, s);
  }
  return maf ? launch_one<T, true, false>(x, b, tab, out, partials, K, I, J, L, colour, offset,
                                          pn, om, grid, smem, s)
             : launch_one<T, false, false>(x, b, tab, out, partials, K, I, J, L, colour, offset,
                                           pn, om, grid, smem, s);
}

}  // namespace

extern "C" {

int cz_pcr_threads_per_block(void) { return kPcrThreads; }

int cz_fused_pcr_f32(const void* x, const void* b, const void* tab, void* out, void* partials,
                     int K, int I, int J, int L, int colour, int offset, int pn, double omega,
                     int maf, int gx, int gy, int device, void* stream) {
  return launch<float>(x, b, tab, out, partials, K, I, J, L, colour, offset, pn, omega, maf,
                       gx, gy, device, stream);
}

int cz_fused_pcr_f64(const void* x, const void* b, const void* tab, void* out, void* partials,
                     int K, int I, int J, int L, int colour, int offset, int pn, double omega,
                     int maf, int gx, int gy, int device, void* stream) {
  return launch<double>(x, b, tab, out, partials, K, I, J, L, colour, offset, pn, omega, maf,
                        gx, gy, device, stream);
}

}  // extern "C"
