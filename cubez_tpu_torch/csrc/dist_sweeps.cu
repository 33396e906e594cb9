// Block-local point sweeps of the distributed path for Hopper (sm_90a): every
// mesh block of a card in one launch, each with width-1 ghosts (K8).
//
// Replaces cubez_tpu/pallas_kernels/dist_sweeps.py:269 (make_block_sweep ->
// _block_kernel): a Jacobi pass, one red-black colour, or both colours in
// one pass, on (lk+2, li+2, lj+2) blocks whose ghost faces the caller
// refreshed (parallel/dist_fused.py).  The TPU kernel's layout
// (lk+4, Ip, Jp), with its K pad and (8, 128) tile padding, is dropped.
//
// A point updates where it is an owned cell and a global inner point, from
// the block's global origin (k0, i0, j0) and the global shape passed as
// arguments (the TPU kernel reads them from SMEM); red-black colour c holds
// the points with (gi + gj + gk + offset + 1) % 2 == c.  ``region`` 1 keeps
// only the cells off the one-cell local shell (the TPU kernel's
// shrink_shell: the interior pass of the halo/compute overlap), ``region`` 2
// only the shell (the overlap's second pass, after the ghosts land), 0 all.
//
//   kind 0, Jacobi: OUT OF PLACE, x -> out, every cell of out written (the
//     ones not updated copied), as K4's jacobi_kernel;
//   kind 1, one colour (colour 0 or 1): in place (a colour reads only the
//     other colour and ghosts);
//   kind 1, colour -1: colour 0, a grid-wide sync, colour 1, in place, in one
//     cooperative launch: the ghosts keep their pre-iteration values, the
//     reference's one-exchange-per-iteration semantics
//     (cz_Poisson.cpp:194-215; the TPU kernel's color=None).
//
// Arithmetic (the TPU kernel's _delta, dist_sweeps.py:88-100, as XLA
// contracts it): ss = ((((zm + zp) + xm) + xp) + ym) + yp, ss -= b,
// dp = fma(ss, 1/6, -centre) * omega, centre + dp.  Note the neighbour sum
// is a left-to-right chain, not the pairwise sum of K4.  Bitwise equal to
// the plain twin (cuda_kernels/dist_sweeps.py::block_sweep_plain) in
// float32.
//
// What bounds it on an H100: bytes at large blocks (a pass reads the block
// once and writes it, or half of it, once); at 64^3 blocks (128^3 over
// (2,2,2), 1.1 MB a block, 8.9 MB for all eight) the blocks sit in L2 and
// launch latency and the host bound it.  So one launch takes every block of
// the card (up to kMaxBlocks; the wrapper splits above that): their
// pointers and origins go by value in a __grid_constant__ parameter struct,
// with no table to copy to the device and no state to re-allocate.  A work
// item is (block, k-chunk, a run of kThreads consecutive columns of the
// padded (li+2) x (lj+2) plane); its thread owns one (i, j) column (one
// div per thread, none per point), j fastest, so a warp reads 32 adjacent
// cells, and walks k over the chunk with x[k-1], x[k] and x[k+1] in
// registers.  The chunk length comes from the block count and the card's
// SMs (cuda_kernels/dist_sweeps.py::launch_geometry).  A colour pass runs
// in place without races: an updated cell reads only the other colour.
//
// Residuals: one partial of dp^2 per CTA (and colour) in the field's type,
// in a fixed order, into a buffer that dist_halo.cu's fold sums in float64.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;  // blocks in one launch (dist_halo.cu)

template <typename T>
struct Block {
  T* x;        // the ghosted block (updated in place by a colour pass)
  const T* b;  // its right-hand side, nullptr for zero
  T* out;      // the Jacobi pass's output
  int k0, i0, j0;  // global origin of the owned cells
};

template <typename T>
struct Args {
  Block<T> blk[kMaxBlocks];
  T* partials;  // one slot per CTA (and colour)
  T omega;
  int lk, li, lj;
  int Kg, Ig, Jg;  // global shape
  int offset;      // colour offset
  int region;      // 0 all, 1 interior, 2 shell
  int col_ctas;    // CTAs across the padded plane of columns
  int kchunk, nkc; // rows of a work item, chunks of a block
  int nwork;       // col_ctas * nkc * blocks
};

// One pass over every work item of the launch; returns this CTA's sum of
// dp^2.  kJacobi: x -> out; otherwise colour ``colour`` in place.
template <typename T, bool kJacobi>
__device__ __forceinline__ T pass(const Args<T>& a, int colour) {
  const int Jp = a.lj + 2;
  const int cols = (a.li + 2) * Jp;
  const size_t plane = size_t(cols);
  const int per_blk = a.col_ctas * a.nkc;
  T acc = 0;
  for (int w = blockIdx.x; w < a.nwork; w += gridDim.x) {
    const int bi = w / per_blk;
    const int r = w - bi * per_blk;
    const int kc = r / a.col_ctas;
    const int c = (r - kc * a.col_ctas) * kThreads + threadIdx.x;
    if (c >= cols) continue;
    const Block<T>& B = a.blk[bi];
    const T* x = B.x;
    T* out = kJacobi ? B.out : B.x;
    const int i = c / Jp, j = c - i * Jp;
    const int gi = B.i0 + i - 1, gj = B.j0 + j - 1;
    const bool col = i >= 1 && i <= a.li && j >= 1 && j <= a.lj && gi >= 1 &&
                     gi <= a.Ig - 2 && gj >= 1 && gj <= a.Jg - 2;
    const bool col_inner = i >= 2 && i <= a.li - 1 && j >= 2 && j <= a.lj - 1;
    const int k_lo = kc * a.kchunk;
    const int k_hi = min(k_lo + a.kchunk, a.lk + 2);
    T zm = k_lo >= 1 ? x[size_t(k_lo - 1) * plane + c] : T(0);
    T cen = x[size_t(k_lo) * plane + c];
    for (int k = k_lo; k < k_hi; ++k) {
      const size_t p = size_t(k) * plane + c;
      const T zp = k <= a.lk ? x[p + plane] : T(0);
      const int gk = B.k0 + k - 1;
      bool upd = col && k >= 1 && k <= a.lk && gk >= 1 && gk <= a.Kg - 2;
      if (a.region != 0) {
        const bool inner = col_inner && k >= 2 && k <= a.lk - 1;
        upd = upd && (a.region == 1 ? inner : !inner);
      }
      if (!kJacobi) upd = upd && ((gk + gi + gj + a.offset + 1) & 1) == colour;
      if (upd) {
        T ss = add_rn(add_rn(add_rn(add_rn(add_rn(zm, zp), x[p - Jp]), x[p + Jp]), x[p - 1]),
                      x[p + 1]);
        if (B.b != nullptr) ss = sub_rn(ss, B.b[p]);
        const T dp = mul_rn(fma_rn(ss, T(1.0 / 6.0), -cen), a.omega);
        out[p] = add_rn(cen, dp);
        acc += dp * dp;
      } else if (kJacobi) {
        out[p] = cen;
      }
      zm = cen;
      cen = zp;
    }
  }
  return block_sum<kThreads>(acc);
}

// Jacobi or one colour: one pass, partials[blockIdx.x].
template <typename T, bool kJacobi>
__global__ void __launch_bounds__(kThreads) sweep_kernel(const __grid_constant__ Args<T> a,
                                                         int colour) {
  const T tot = pass<T, kJacobi>(a, colour);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = tot;
}

// Both colours in one cooperative launch, the grid synchronised across all
// the launch's blocks between them: partials[colour * gridDim.x + CTA].
template <typename T>
__global__ void __launch_bounds__(kThreads) sweep_rb_kernel(const __grid_constant__ Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  for (int colour = 0; colour < 2; ++colour) {
    const T tot = pass<T, false>(a, colour);
    if (threadIdx.x == 0) a.partials[colour * gridDim.x + blockIdx.x] = tot;
    if (colour == 0) grid.sync();
  }
}

template <typename T>
int max_blocks(int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_rb_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// ptrs: x, b, out per block.  iargs: n, kind (0 Jacobi, 1 red-black),
// colour (-1: both colours, cooperative, ``grid`` CTAs at most
// co-resident), region, lk, li, lj, Kg, Ig, Jg, offset, kchunk, grid,
// device, then k0, i0, j0 per block.  The wrapper builds both arrays once
// for a set of blocks.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* partials, void* stream) {
  const int n = iargs[0], kind = iargs[1], colour = iargs[2], grid = iargs[12];
  if (n < 1 || n > kMaxBlocks) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(iargs[13]);
  if (e != cudaSuccess) return e;
  auto s = static_cast<cudaStream_t>(stream);
  Args<T> a{};
  const int* org = iargs + 14;
  for (int b = 0; b < n; ++b) {
    a.blk[b] = Block<T>{static_cast<T*>(ptrs[3 * b]), static_cast<const T*>(ptrs[3 * b + 1]),
                        static_cast<T*>(ptrs[3 * b + 2]), org[3 * b], org[3 * b + 1],
                        org[3 * b + 2]};
  }
  a.partials = static_cast<T*>(partials);
  a.omega = T(omega);
  a.region = iargs[3];
  a.lk = iargs[4];
  a.li = iargs[5];
  a.lj = iargs[6];
  a.Kg = iargs[7];
  a.Ig = iargs[8];
  a.Jg = iargs[9];
  a.offset = iargs[10];
  a.kchunk = iargs[11];
  a.col_ctas = ((a.li + 2) * (a.lj + 2) + kThreads - 1) / kThreads;
  a.nkc = (a.lk + 2 + a.kchunk - 1) / a.kchunk;
  a.nwork = a.col_ctas * a.nkc * n;
  if (grid < 1 || grid > a.nwork) return cudaErrorInvalidValue;
  if (kind == 0) {
    sweep_kernel<T, true><<<grid, kThreads, 0, s>>>(a, 0);
  } else if (colour >= 0) {
    sweep_kernel<T, false><<<grid, kThreads, 0, s>>>(a, colour);
  } else {
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sweep_rb_kernel<T>), dim3(grid),
                                    dim3(kThreads), args, 0, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_block_sweep_max_blocks_f32(int device, int* out) {
  return max_blocks<float>(device, out);
}

int cz_block_sweep_max_blocks_f64(int device, int* out) {
  return max_blocks<double>(device, out);
}

int cz_block_sweep_f32(void* const* ptrs, const int* iargs, double omega, void* partials,
                       void* stream) {
  return launch<float>(ptrs, iargs, omega, partials, stream);
}

int cz_block_sweep_f64(void* const* ptrs, const int* iargs, double omega, void* partials,
                       void* stream) {
  return launch<double>(ptrs, iargs, omega, partials, stream);
}

}  // extern "C"
