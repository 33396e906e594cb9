// Block-local K-line relaxation of the distributed path for Hopper (sm_90a):
// every mesh block of a card in one launch, each with width-1 ghosts (K9).
//
// Replaces cubez_tpu/pallas_kernels/dist_pcr.py:379 (make_block_pcr ->
// _dist_pcr_kernel): one colour of a red-black line sweep, or the
// line-Jacobi pass, on (lk+2, li+2, lj+2) blocks whose ghost faces the
// caller refreshed (parallel/dist_fused.py).  It runs on K8's ghosted
// block, not on the TPU kernel's (li+2, lkp, ljp) line layout with its
// (8, 128) padding and J ghost-lane option.
//
// A line is the column of a block at an owned (i, j) whose global (gi, gj)
// is inner; colour c holds the lines with (gi + gj + offset) % 2 == c.
// Colour 0/1 relaxes that colour's lines in place (a colour line reads only
// lines of the other colour and ghost columns; a CTA takes L lines of one
// colour in one row); colour -1 relaxes every line from the pre-pass block,
// OUT OF PLACE into ``out``, and writes every value of ``out``.
//
// Two forms (the TPU kernel's ``solver``):
//   block_pcr_kernel ('pcr', any mesh): the line is the block's lk owned
//     rows and its two ghost rows, n = lk + 2.  Ghost rows and rows on a
//     physical K wall are identity equations (a = c = 0, d = x), the
//     reference's multi-rank end fold (cz_solver.f90:578-579); the others
//     carry the stencil equation, a = c = -1/6 and d = (((x[i+1] + x[i-1])
//     + x[j+1]) + x[j-1] - b) / 6 (MAF: dw = 0.5 / ((c1 + c2) + c3),
//     a = -(wzm dw), c = -(wzp dw), d = ((((wxp x[i+1] + wxm x[i-1]) + wyp
//     x[j+1]) + wym x[j-1]) - b) dw).  The system is data-dependent, so it
//     runs the variable-coefficient PCR of pcr.cuh (num_stage(lk + 2)
//     stages); the residual covers the updated rows only.
//   block_thomas_kernel ('fastdiag', K-unsplit meshes, lk == K): every line
//     spans the full K extent, so the serial line relaxation applies per
//     block unchanged: lines.cuh's relax_line (Thomas, one thread a line,
//     the Dirichlet walls at block rows 1 and lk folded into the ends,
//     MAF through MafTables indexed by the block's (i, j)).  The TPU kernel
//     solves these lines with dense eigen/inverse tables on the MXU
//     (dist_pcr.py:169-182, 204-230); Thomas is K5/K6's counterpart of that.
//
// Arithmetic: one round-to-nearest intrinsic per operation, built with
// --fmad=false; cuda_kernels/dist_pcr.py's plain twin does the same
// operations in the same order (bitwise equal in float32 and float64).
//
// What bounds it on an H100: a 64^3 block (n = 66, pn = 7) is 4,096 lines
// of 66 rows, 2,048 a colour.  The PCR form does about 4 + 16 (pn - 1) + 11
// operations an updated row (15 for the 4 under MAF), about 14 MFLOP a
// colour of such a block: 0.2 us at 67 TFLOP/s, under the 0.5 us its 1.7 MB
// take at 3.35 TB/s and far under a launch's own few microseconds.  So one
// launch takes every block of the card (up to kMaxBlocks; the wrapper
// splits above that), their pointers and origins by value in a
// __grid_constant__ parameter struct, blockIdx.z (the 'pcr' form) or
// blockIdx.y ('fastdiag') picking the block: 128^3 over (2, 2, 2) is 16,384
// lines a colour, 512 CTAs of 32 lines, where one block alone filled half
// the SMs; over (1, 2, 2) the 'fastdiag' form runs 8,192 Thomas lines a
// colour in one launch in place of 2,048 four times.
//
// Residuals: one partial of dp^2 per CTA in the field's type, in a fixed
// order, into a buffer that dist_halo.cu's fold sums in float64.

#include <cuda_runtime.h>

#include <cstddef>

#include "lines.cuh"
#include "pcr.cuh"

namespace {

using namespace cz;

constexpr int kMaxBlocks = 32;  // blocks in one launch (dist_halo.cu)

struct BlockGeom {
  int k0, i0, j0;  // global origin of the owned cells
  int Kg, Ig, Jg;  // global shape
  int offset;      // colour offset
};

template <typename T>
struct Block {
  const T* x;
  const T* b;    // nullptr for a zero right-hand side
  const T* tab;  // the block's MAF tables (block_maf_tables), nullptr for constant
  T* out;        // x for a colour pass, else the line-Jacobi output
  T* gs;         // 'fastdiag': the Thomas scratch (g, then e under MAF)
  T* es;
  int k0, i0, j0;
};

template <typename T>
struct Args {
  Block<T> blk[kMaxBlocks];
  T* partials;   // one slot per CTA
  const T* lt;   // 'fastdiag', constant coefficients: the Thomas factors
  T omega;
  int lk, li, lj;
  int Kg, Ig, Jg, offset;
  int L, colour, pn;
};

__device__ __forceinline__ bool inner(int g, int G) { return g >= 1 && g <= G - 2; }

template <typename T>
__device__ __forceinline__ BlockGeom geom_of(const Args<T>& a, const Block<T>& B) {
  return BlockGeom{B.k0, B.i0, B.j0, a.Kg, a.Ig, a.Jg, a.offset};
}

// The column (i, j) of the block that this thread's line sits in, for the
// colour launch (the colour's j of pair ``m`` in row i) or the line-Jacobi
// launch (any column).  ``column``: the thread has a column of the block.
template <bool kJacobi>
__device__ __forceinline__ void place(int row, int m, int li, int lj, int colour,
                                      const BlockGeom& g, int& i, int& j, bool& column) {
  if (kJacobi) {
    i = row;
    j = m;
    column = j <= lj + 1;
  } else {
    i = row + 1;
    const int gi = g.i0 + i - 1;
    // (gi + g.j0 + j - 1 + offset) % 2 == colour
    j = (((colour + gi + g.j0 + 1 + g.offset) & 1) ? 1 : 2) + 2 * m;
    column = j <= lj;
  }
}

// grid (tiles of L lines, rows, blocks)
template <typename T, bool kMaf, bool kJacobi>
__global__ void __launch_bounds__(kPcrThreads) block_pcr_kernel(
    const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s0 = reinterpret_cast<T*>(smem);
  const Block<T>& B = a.blk[blockIdx.z];
  const T* x = B.x;
  const T* __restrict__ b = B.b;
  T* out = B.out;
  const int lk = a.lk, li = a.li, lj = a.lj, L = a.L;
  const BlockGeom g = geom_of(a, B);
  const int n = lk + 2;
  const size_t nL = size_t(n) * L;
  const int l = threadIdx.x % L, r0 = threadIdx.x / L, rs = kPcrThreads / L;
  const int Jp = lj + 2;
  const size_t plane = size_t(li + 2) * Jp;
  int i, j;
  bool column;
  place<kJacobi>(blockIdx.y, blockIdx.x * L + l, li, lj, a.colour, g, i, j, column);
  const bool line = column && i >= 1 && i <= li && j >= 1 && j <= lj &&
                    inner(g.i0 + i - 1, g.Ig) && inner(g.j0 + j - 1, g.Jg);
  const size_t col = size_t(i) * Jp + j;
  const T R6 = T(1.0 / 6.0);
  const MafTables<T> w(B.tab, n, li + 2, Jp);

  for (int k = r0; k < n; k += rs) {
    T a_ = 0, c = 0, d = 0;
    if (line) {
      const size_t p = size_t(k) * plane + col;
      if (k >= 1 && k <= lk && inner(g.k0 + k - 1, g.Kg)) {
        T t;
        if constexpr (kMaf) {
          const T dw = div_rn(T(0.5), add_rn(add_rn(w.c1[i], w.c2[j]), w.c3[k]));
          a_ = -mul_rn(w.wzm[k], dw);
          c = -mul_rn(w.wzp[k], dw);
          t = add_rn(mul_rn(w.wxp[i], x[p + Jp]), mul_rn(w.wxm[i], x[p - Jp]));
          t = add_rn(t, mul_rn(w.wyp[j], x[p + 1]));
          t = add_rn(t, mul_rn(w.wym[j], x[p - 1]));
          if (b != nullptr) t = sub_rn(t, b[p]);
          d = mul_rn(t, dw);
        } else {
          a_ = c = -R6;
          t = add_rn(add_rn(add_rn(x[p + Jp], x[p - Jp]), x[p + 1]), x[p - 1]);
          if (b != nullptr) t = sub_rn(t, b[p]);
          d = mul_rn(t, R6);
        }
      } else {
        d = x[p];  // identity row: x = its current value
      }
    }
    const int q = k * L + l;
    s0[q] = a_;
    s0[nL + q] = c;
    s0[2 * nL + q] = d;
  }
  __syncthreads();
  const T* sol = pcr_solve_var(s0, s0 + 3 * nL, n, a.pn, L);

  T acc = 0;
  if (line) {
    for (int k = r0; k < n; k += rs) {
      const size_t p = size_t(k) * plane + col;
      const T xv = x[p];
      if (k >= 1 && k <= lk && inner(g.k0 + k - 1, g.Kg)) {
        const T dp = mul_rn(sub_rn(sol[k * L + l], xv), a.omega);
        out[p] = add_rn(xv, dp);
        acc = add_rn(acc, mul_rn(dp, dp));
      } else if (kJacobi) {
        out[p] = xv;
      }
    }
  } else if (kJacobi && column) {
    for (int k = r0; k < n; k += rs) out[size_t(k) * plane + col] = x[size_t(k) * plane + col];
  }
  const T tot = block_sum<kPcrThreads>(acc);
  if (threadIdx.x == 0)
    a.partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = tot;
}

// One thread a line (a column of the block for the line-Jacobi launch);
// grid (CTAs a block, blocks).
template <typename T, bool kMaf, bool kJacobi>
__global__ void __launch_bounds__(kLineThreads) block_thomas_kernel(
    const __grid_constant__ Args<T> a) {
  const Block<T>& B = a.blk[blockIdx.y];
  const T* x = B.x;
  T* out = B.out;
  const int lk = a.lk, li = a.li, lj = a.lj;
  const BlockGeom g = geom_of(a, B);
  const int Jp = lj + 2;
  const size_t plane = size_t(li + 2) * Jp;
  const int per_row = kJacobi ? Jp : (lj + 1) / 2;
  const int rows = kJacobi ? li + 2 : li;
  const int t = blockIdx.x * kLineThreads + threadIdx.x;
  int i = 0, j = 0;
  bool column = false;
  if (t < rows * per_row) place<kJacobi>(t / per_row, t % per_row, li, lj, a.colour, g, i, j, column);
  const bool line = column && i >= 1 && i <= li && j >= 1 && j <= lj &&
                    inner(g.i0 + i - 1, g.Ig) && inner(g.j0 + j - 1, g.Jg);
  const size_t col = size_t(i) * Jp + j;
  T acc = 0;
  if (line) {
    // the line starts at block row 1, the global K wall k = 0
    const size_t own = plane + col;
    const LineAt at{own, own + Jp, own - Jp, own + 1, own - 1, plane, own};
    T* gw = kJacobi ? out : B.gs;
    acc = relax_line<T, kMaf>(x, x, out, B.b, gw, B.es, at, kMaf ? B.tab : a.lt, lk, li + 2,
                              Jp, unsigned(i), unsigned(j), a.omega);
    if (kJacobi) {  // the ghost and wall rows, which relax_line leaves
      const int fixed[4] = {0, 1, lk, lk + 1};
      for (int m = 0; m < 4; ++m) {
        const size_t p = col + size_t(fixed[m]) * plane;
        out[p] = x[p];
      }
    }
  } else if (kJacobi && column) {
    for (int k = 0; k < lk + 2; ++k) out[col + size_t(k) * plane] = x[col + size_t(k) * plane];
  }
  const T tot = block_sum<kLineThreads>(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

template <typename T, bool kMaf, bool kJacobi>
int launch_pcr(const Args<T>& a, dim3 grid, size_t smem, cudaStream_t s) {
  auto kernel = block_pcr_kernel<T, kMaf, kJacobi>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kPcrThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kMaf, bool kJacobi>
int launch_thomas(const Args<T>& a, dim3 grid, cudaStream_t s) {
  block_thomas_kernel<T, kMaf, kJacobi><<<grid, kLineThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// ptrs: x, b, tab, out, gs, es per block, then lt (the Thomas factors of
// the constant 'fastdiag' form).  iargs: n, form (0 'pcr': grid gx x gy x
// n of kPcrThreads, L lines a CTA; 1 'fastdiag': gx x n CTAs of
// kLineThreads), colour (-1: line-Jacobi into out, else one colour in
// place, out == x), L, pn, maf, gx, gy, device, lk, li, lj, Kg, Ig, Jg,
// offset, then k0, i0, j0 per block.  The wrapper builds both arrays once
// for a set of blocks.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* partials, void* stream) {
  const int n = iargs[0], form = iargs[1], colour = iargs[2], L = iargs[3];
  const int maf = iargs[5], gx = iargs[6], gy = iargs[7];
  if (n < 1 || n > kMaxBlocks) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(iargs[8]);
  if (e != cudaSuccess) return e;
  Args<T> a{};
  const int* org = iargs + 16;
  for (int b = 0; b < n; ++b) {
    void* const* q = ptrs + 6 * b;
    a.blk[b] = Block<T>{static_cast<const T*>(q[0]), static_cast<const T*>(q[1]),
                        static_cast<const T*>(q[2]), static_cast<T*>(q[3]),
                        static_cast<T*>(q[4]), static_cast<T*>(q[5]),
                        org[3 * b], org[3 * b + 1], org[3 * b + 2]};
  }
  a.partials = static_cast<T*>(partials);
  a.lt = static_cast<const T*>(ptrs[6 * n]);
  a.omega = T(omega);
  a.lk = iargs[9];
  a.li = iargs[10];
  a.lj = iargs[11];
  a.Kg = iargs[12];
  a.Ig = iargs[13];
  a.Jg = iargs[14];
  a.offset = iargs[15];
  a.L = L;
  a.colour = colour;
  a.pn = iargs[4];
  auto s = static_cast<cudaStream_t>(stream);
  const bool jac = colour < 0;
  if (form == 0) {
    const size_t smem = 6 * size_t(a.lk + 2) * L * sizeof(T);
    const dim3 grid(gx, gy, n);
    if (maf) {
      return jac ? launch_pcr<T, true, true>(a, grid, smem, s)
                 : launch_pcr<T, true, false>(a, grid, smem, s);
    }
    return jac ? launch_pcr<T, false, true>(a, grid, smem, s)
               : launch_pcr<T, false, false>(a, grid, smem, s);
  }
  const dim3 grid(gx, n);
  if (maf) {
    return jac ? launch_thomas<T, true, true>(a, grid, s) : launch_thomas<T, true, false>(a, grid, s);
  }
  return jac ? launch_thomas<T, false, true>(a, grid, s) : launch_thomas<T, false, false>(a, grid, s);
}

}  // namespace

extern "C" {

int cz_block_pcr_f32(void* const* ptrs, const int* iargs, double omega, void* partials,
                     void* stream) {
  return launch<float>(ptrs, iargs, omega, partials, stream);
}

int cz_block_pcr_f64(void* const* ptrs, const int* iargs, double omega, void* partials,
                     void* stream) {
  return launch<double>(ptrs, iargs, omega, partials, stream);
}

}  // extern "C"
