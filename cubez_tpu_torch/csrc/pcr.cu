// Serial line-PCR pass for Hopper (sm_90a): the CUDA counterpart of the JAX
// package's fused line-PCR kernel K10, cubez_tpu/pallas_kernels/pcr.py:414
// (make_fused_pcr -> _pcr_kernel; make_fused_pcr_step, :460).
//
// One pass relaxes the inner K-lines of the (K, I, J) field: it builds
// each line's tridiagonal system over its n = K - 2 inner rows from the
// transverse neighbours (the Dirichlet values x[0] and x[K-1] folded into
// its ends), solves it by PCR and moves the line by omega towards the
// solution: the reference's pcr family (cz_solver.f90:497-1676).
// Constant coefficients run the table-driven solve (the stage tables of
// cuda_kernels/pcr.py::build_tables, one row of n values per table); MAF
// the variable one, on the unit-diagonal system normalised by
// dw = 0.5 / ((c1 + c2) + c3) (cz_maf.f90:519-572).
//
//   colour 0 or 1: the lines with (i + j + offset) % 2 == colour, in place
//     (a colour line reads only lines of the other colour);
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
//   then the PCR solve, dp = (s - x) * omega, x + dp.
//
// Two forms, chosen on the host (cuda_kernels/pcr.py::line_plan):
//
// pcr_lines_kernel, the line form, for lines of n <= 512 rows (MAF: 256
// in float32, 128 in float64, where a lane's registers still hold a line):
// the PCR stages run in a warp's registers (pcr_warp.cuh), shuffles and no
// barrier a stage; the constant coefficients' stage tables sit in shared
// memory, loaded once a launch.  A work item is a window of 32 columns of one row i: a
// colour pass's 16 lines there (one of each pair of columns), or the
// line-Jacobi pass's 32.  The CTA builds the window's right-hand sides, a
// warp a plane and a lane a column, into shared memory (a line's rows
// contiguous, LS = 32 M + 1 apart), each warp loads its lines from there
// into registers (row k = lane + 32 m), solves them and puts the solutions
// back, and the CTA writes the window's lines a plane at a time: shared
// memory is crossed twice a pass, with three barriers a work item.  MAF's
// a and c are recomputed in registers from the weights, not stored.  The
// launch is persistent and cooperative: its CTAs walk the work items of
// one or two passes (pcr_rb: colour 0, a grid-wide sync, colour 1, which
// reads colour 0's new values), then fold the passes' partial sums of dp^2
// in float64 in a fixed order into r2 on the card: one launch a step.
//
// fused_pcr_kernel, the tile form, for longer lines: a CTA takes L lines of
// one row whole in shared memory and runs pcr.cuh's stages there, one
// barrier a stage; its partials are folded on the host.
//
// What bounds it on an H100: at 128^3 the field (8.4 MB) sits in L2 and a
// colour pass reads it once and writes half the inner cells, 12.4 MB, 3.7
// us at 3.35 TB/s.  The work is 4 + 5 (pn - 1) + 8 operations an updated
// row with tables, 15 + 16 (pn - 1) + 11 under MAF (pn = 7 at 128^3),
// about 0.04 and 0.12 GFLOP a colour pass, 0.6 and 1.8 us at 67 TFLOP/s:
// bytes bound it on paper.  Measured (tools/prof_pcr.py): the tile form
// ran 24.4 us a colour launch there; the line form 16.5 (MAF 30.0),
// issue-bound: a row and stage is two shuffles and their wrap selects
// beside the five operations of the table stage, six and a division more
// under MAF.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "pcr.cuh"
#include "pcr_warp.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

// ---- the line form ---------------------------------------------------------

constexpr int kWarpLineThreads = 256;
constexpr int kWarpLineWarps = kWarpLineThreads / 32;
constexpr int kWindow = 32;  // columns of a work item
// CTAs an SM must hold (__launch_bounds__): short lines need few registers,
// and the phases that move the field hide their latency only with many
// warps in flight; a long line keeps up to 3 M values a lane
template <int M, typename T>
constexpr int kLineMinBlocks = M * sizeof(T) <= 16 ? 4 : M * sizeof(T) <= 32 ? 2 : 1;
constexpr int kRelax = 4;  // planes a warp relaxes at once
constexpr int kBuild = 4;  // planes a warp builds at once

template <typename T>
struct LineArgs {
  const T* x;
  const T* __restrict__ b;    // nullptr for a zero right-hand side
  const T* __restrict__ tab;  // the padded stage tables, or the MAF weights
  T* out;                     // x for the colour passes
  T* partials;                // (npass, grid) per-CTA sums of dp^2
  double* r2;                 // their float64 fold
  T omega;
  int K, I, J, offset, pn, npass;
  int colour[2];  // of each pass: 0, 1, or -1 for the line-Jacobi pass
};

// A line's column in a work item: the colour pass's line ll sits in the
// pair of columns j0 + 2 ll, j0 + 2 ll + 1 at the one of its colour.
__device__ __forceinline__ int line_column(int i, int j0, int ll, int colour, int offset) {
  if (colour < 0) return j0 + ll;
  const int j = j0 + 2 * ll;
  return ((i + j + offset) & 1) == colour ? j : j + 1;
}

// Values of the padded stage tables (pcr_warp_tab) of a line of n rows
// held in M slabs: 3 (pn - 1) + 3 rows of 32 M.
template <int M>
__host__ __device__ constexpr int stage_table_values(int pn) {
  return (3 * (pn - 1) + 3) * 32 * M;
}

template <typename T, bool kMaf, int M>
__global__ void __launch_bounds__(kWarpLineThreads, kLineMinBlocks<M, T>) pcr_lines_kernel(
    const __grid_constant__ LineArgs<T> a) {
  constexpr int LS = 32 * M + 1;  // a line's stride in shared memory (odd)
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = a.K - 2, I = a.I, J = a.J;
  const size_t plane = size_t(I) * J;
  const T R6 = T(1.0 / 6.0);
  // constant coefficients: the stage tables, once a launch, then the lines
  T* tab = reinterpret_cast<T*>(smem);
  T* sm = tab;
  if constexpr (!kMaf) {
    const int nt = stage_table_values<M>(a.pn);
    for (int q = threadIdx.x; q < nt; q += kWarpLineThreads) tab[q] = a.tab[q];
    sm = tab + nt;
    __syncthreads();
  }
  const MafTables<T> wt(a.tab, a.K, I, J);  // read only under kMaf
  for (int ps = 0; ps < a.npass; ++ps) {
    const int colour = a.colour[ps];
    const bool jac = colour < 0;
    // the line-Jacobi pass covers every column and row (it copies the
    // boundary); a colour pass the inner ones
    const int j_first = jac ? 0 : 1;
    const int wins = (J - j_first + kWindow - 1) / kWindow;
    const int rows = jac ? I : I - 2;
    const int lines = jac ? kWindow : kWindow / 2;
    T acc = 0;
    for (int w = blockIdx.x; w < rows * wins; w += gridDim.x) {
      const int wi = w / wins;
      const int i = jac ? wi : wi + 1;
      const int j0 = j_first + kWindow * (w - wi * wins);
      const int j = j0 + lane;
      const bool row_in = i >= 1 && i <= I - 2;
      const bool line = row_in && j >= 1 && j <= J - 2 &&
                        (jac || ((i + j + a.offset) & 1) == colour);
      const int l = jac ? lane : lane >> 1;  // the lane's line in the window
      const size_t col = size_t(i) * J + j;
      const size_t top = col + size_t(a.K - 1) * plane;
      // 1. the right-hand sides, a warp a plane, into the lines' rows:
      // kBuild planes' loads in flight at once
      if (line) {
        const T x_lo = a.x[col], x_hi = a.x[top];  // the Dirichlet ends
        T c1 = 0, c2 = 0, wxp = 0, wxm = 0, wyp = 0, wym = 0;
        if constexpr (kMaf) {
          c1 = __ldg(wt.c1 + i);
          c2 = __ldg(wt.c2 + j);
          wxp = __ldg(wt.wxp + i);
          wxm = __ldg(wt.wxm + i);
          wyp = __ldg(wt.wyp + j);
          wym = __ldg(wt.wym + j);
        }
        for (int r0 = warp; r0 < n; r0 += kBuild * kWarpLineWarps) {
          T v[kBuild][5];
#pragma unroll
          for (int u = 0; u < kBuild; ++u) {
            const int r = r0 + u * kWarpLineWarps;
            const size_t p = size_t(r + 1) * plane + col;
            const bool in = r < n;
            v[u][0] = in ? a.x[p + J] : T(0);
            v[u][1] = in ? a.x[p - J] : T(0);
            v[u][2] = in ? a.x[p + 1] : T(0);
            v[u][3] = in ? a.x[p - 1] : T(0);
            v[u][4] = in && a.b != nullptr ? __ldg(a.b + p) : T(0);
          }
#pragma unroll
          for (int u = 0; u < kBuild; ++u) {
            const int r = r0 + u * kWarpLineWarps, k = r + 1;
            if (r >= n) break;
            T d;
            if constexpr (kMaf) {
              const T dw = div_rn(T(0.5), add_rn(add_rn(c1, c2), __ldg(wt.c3 + k)));
              T t = add_rn(mul_rn(wxp, v[u][0]), mul_rn(wxm, v[u][1]));
              t = add_rn(t, mul_rn(wyp, v[u][2]));
              t = add_rn(t, mul_rn(wym, v[u][3]));
              if (a.b != nullptr) t = sub_rn(t, v[u][4]);
              d = mul_rn(t, dw);
              if (r == 0) d = add_rn(d, mul_rn(mul_rn(__ldg(wt.wzm + k), dw), x_lo));
              if (r == n - 1) d = add_rn(d, mul_rn(mul_rn(__ldg(wt.wzp + k), dw), x_hi));
            } else {
              T t = add_rn(add_rn(add_rn(v[u][0], v[u][1]), v[u][2]), v[u][3]);
              if (a.b != nullptr) t = sub_rn(t, v[u][4]);
              d = mul_rn(t, R6);
              if (r == 0) d = add_rn(d, mul_rn(x_lo, R6));
              if (r == n - 1) d = add_rn(d, mul_rn(x_hi, R6));
            }
            sm[l * LS + r] = d;
          }
        }
      }
      __syncthreads();
      // 2. a warp a line: the stages in registers, the solution back
      for (int ll = warp; ll < lines; ll += kWarpLineWarps) {
        const int jl = line_column(i, j0, ll, colour, a.offset);
        if (!row_in || jl < 1 || jl > J - 2) continue;  // warp-uniform
        T d[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int k = lane + 32 * m;
          d[m] = k < n ? sm[ll * LS + k] : T(0);
        }
        if constexpr (kMaf) {
          const T c12 = add_rn(__ldg(wt.c1 + i), __ldg(wt.c2 + jl));
          T av[M], cv[M];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int r = lane + 32 * m, k = r + 1;
            av[m] = cv[m] = T(0);
            if (r < n) {
              const T dw = div_rn(T(0.5), add_rn(c12, __ldg(wt.c3 + k)));
              if (r > 0) av[m] = -mul_rn(__ldg(wt.wzm + k), dw);
              if (r < n - 1) cv[m] = -mul_rn(__ldg(wt.wzp + k), dw);
            }
          }
          pcr_warp_var<M>(av, cv, d, n, a.pn, lane);
        } else {
          pcr_warp_tab<M>(d, tab, a.pn, lane);
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int k = lane + 32 * m;
          if (k < n) sm[ll * LS + k] = d[m];
        }
      }
      __syncthreads();
      // 3. the relaxation, a warp a plane; the line-Jacobi pass copies the
      // rest of its window.  x may be out: kRelax planes' loads go out
      // before their stores
      const bool copy = !line && jac && j < J;
      for (int r0 = warp; r0 < n; r0 += kRelax * kWarpLineWarps) {
        T xv[kRelax];
#pragma unroll
        for (int u = 0; u < kRelax; ++u) {
          const int r = r0 + u * kWarpLineWarps;
          xv[u] = r < n && (line || copy) ? a.x[size_t(r + 1) * plane + col] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kRelax; ++u) {
          const int r = r0 + u * kWarpLineWarps;
          const size_t p = size_t(r + 1) * plane + col;
          if (r >= n) break;
          if (line) {
            const T dp = mul_rn(sub_rn(sm[l * LS + r], xv[u]), a.omega);
            a.out[p] = add_rn(xv[u], dp);
            acc = add_rn(acc, mul_rn(dp, dp));
          } else if (copy) {
            a.out[p] = xv[u];
          }
        }
      }
      if (jac && warp == 0 && j < J) {
        a.out[col] = a.x[col];
        a.out[top] = a.x[top];
      }
      __syncthreads();  // the window's solutions are read before the next one's rows land
    }
    const T tot = block_sum<kWarpLineThreads>(acc);
    if (threadIdx.x == 0) a.partials[size_t(ps) * gridDim.x + blockIdx.x] = tot;
    cg::this_grid().sync();  // the pass is written before the next reads it
  }
  if (blockIdx.x == 0) {
    double s = 0;
    const int m = a.npass * int(gridDim.x);
    for (int q = threadIdx.x; q < m; q += kWarpLineThreads) s += double(a.partials[q]);
    s = block_sum<kWarpLineThreads>(s);
    if (threadIdx.x == 0) *a.r2 = s;
  }
}

template <typename T, bool kMaf>
const void* lines_kernel_m(int slabs) {
  switch (slabs) {
    case 1: return reinterpret_cast<const void*>(pcr_lines_kernel<T, kMaf, 1>);
    case 2: return reinterpret_cast<const void*>(pcr_lines_kernel<T, kMaf, 2>);
    case 4: return reinterpret_cast<const void*>(pcr_lines_kernel<T, kMaf, 4>);
    case 8: return reinterpret_cast<const void*>(pcr_lines_kernel<T, kMaf, 8>);
    case 16: return reinterpret_cast<const void*>(pcr_lines_kernel<T, kMaf, 16>);
    default: return nullptr;
  }
}

template <typename T>
const void* lines_kernel(int slabs, bool maf) {
  return maf ? lines_kernel_m<T, true>(slabs) : lines_kernel_m<T, false>(slabs);
}

// CTAs of the line kernel co-resident on the card at ``smem`` bytes each
// (the cooperative launch's limit), after raising its dynamic shared-memory
// limit to what the card allows (launches of other sizes share it).
template <typename T>
int lines_max_blocks(int slabs, int maf, int smem, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* k = lines_kernel<T>(slabs, maf != 0);
  if (k == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return e;
  int optin = 0, per_sm = 0, sms = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - int(attr.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kWarpLineThreads, size_t(smem));
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// ptrs: x, b, tab, out, partials, r2.  iargs: slabs, maf, K, I, J, offset,
// pn, npass, colour 0, colour 1, grid, smem, device.  The wrapper builds
// both arrays once for a set of fields.
template <typename T>
int launch_lines(void* const* ptrs, const int* iargs, double omega, void* stream) {
  const int slabs = iargs[0], maf = iargs[1], grid = iargs[10], smem = iargs[11];
  cudaError_t e = cudaSetDevice(iargs[12]);
  if (e != cudaSuccess) return e;
  LineArgs<T> a;
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
  a.offset = iargs[5];
  a.pn = iargs[6];
  a.npass = iargs[7];
  a.colour[0] = iargs[8];
  a.colour[1] = iargs[9];
  const void* k = lines_kernel<T>(slabs, maf != 0);
  if (k == nullptr || grid < 1 || a.npass < 1 || a.npass > 2 || a.K - 2 > 32 * slabs ||
      a.K < 3 || a.I < 3 || a.J < 3)
    return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kWarpLineThreads), args, size_t(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---- the tile form ---------------------------------------------------------

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

int cz_pcr_lines_max_blocks_f32(int slabs, int maf, int smem, int device, int* out) {
  return lines_max_blocks<float>(slabs, maf, smem, device, out);
}

int cz_pcr_lines_max_blocks_f64(int slabs, int maf, int smem, int device, int* out) {
  return lines_max_blocks<double>(slabs, maf, smem, device, out);
}

int cz_pcr_lines_f32(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch_lines<float>(ptrs, iargs, omega, stream);
}

int cz_pcr_lines_f64(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch_lines<double>(ptrs, iargs, omega, stream);
}

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
