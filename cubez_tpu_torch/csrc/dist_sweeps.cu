// Block-local point sweeps of the distributed path for Hopper (sm_90a): one
// mesh block with width-1 ghosts (K8).
//
// Replaces cubez_tpu/pallas_kernels/dist_sweeps.py:269 (make_block_sweep ->
// _block_kernel): a Jacobi pass, one red-black colour, or both colours in
// one pass, on a (lk+2, li+2, lj+2) block whose ghost planes the caller
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
// (2,2,2), 1.1 MB a block) it sits in L2 and launch latency bounds it.  One
// thread per cell of the padded block, grid-stride; the simple design.
//
// Residuals: per-block partials of dp^2 in the field's type in a fixed
// order (one slot per pass and block), folded in float64 on the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kThreads = 256;

struct BlockGeom {
  int k0, i0, j0;  // global origin of the owned cells
  int Kg, Ig, Jg;  // global shape
  int offset;      // colour offset
};

// One pass over every cell of the padded block.  kJacobi: x -> out;
// otherwise colour ``colour`` in place (out == x).
template <typename T, bool kJacobi>
__device__ __forceinline__ T pass(const T* x, const T* __restrict__ b, T* out, int colour,
                                  int region, int lk, int li, int lj, T omega,
                                  const BlockGeom& g) {
  const unsigned Jp = lj + 2, Ip = li + 2;
  const unsigned n_cells = unsigned(lk + 2) * Ip * Jp;
  const size_t plane = size_t(Ip) * Jp;
  T acc = 0;
  for (unsigned idx = blockIdx.x * kThreads + threadIdx.x; idx < n_cells;
       idx += gridDim.x * kThreads) {
    const int j = idx % Jp;
    const unsigned r = idx / Jp;
    const int i = r % Ip;
    const int k = r / Ip;
    // local owned index l - 1 in [0, l); global g = origin + l - 1
    const int gk = g.k0 + k - 1, gi = g.i0 + i - 1, gj = g.j0 + j - 1;
    bool upd = k >= 1 && k <= lk && i >= 1 && i <= li && j >= 1 && j <= lj &&
               gk >= 1 && gk <= g.Kg - 2 && gi >= 1 && gi <= g.Ig - 2 && gj >= 1 &&
               gj <= g.Jg - 2;
    if (region != 0) {
      const bool inner = k >= 2 && k <= lk - 1 && i >= 2 && i <= li - 1 && j >= 2 &&
                         j <= lj - 1;
      upd = upd && (region == 1 ? inner : !inner);
    }
    if (!kJacobi) upd = upd && ((gk + gi + gj + g.offset + 1) & 1) == colour;
    if (!upd) {
      if (kJacobi) out[idx] = x[idx];
      continue;
    }
    const T cen = x[idx];
    T ss = add_rn(add_rn(add_rn(add_rn(add_rn(x[idx - plane], x[idx + plane]),
                                       x[idx - Jp]),
                                x[idx + Jp]),
                         x[idx - 1]),
                  x[idx + 1]);
    if (b != nullptr) ss = sub_rn(ss, b[idx]);
    const T dp = mul_rn(fma_rn(ss, T(1.0 / 6.0), -cen), omega);
    out[idx] = add_rn(cen, dp);
    acc += dp * dp;
  }
  return block_sum<kThreads>(acc);
}

// kind 0 (Jacobi) or one colour: one pass, partials[blockIdx.x].
template <typename T, bool kJacobi>
__global__ void __launch_bounds__(kThreads) block_pass_kernel(
    const T* x, const T* b, T* out, T* partials, int colour, int region, int lk, int li,
    int lj, T omega, BlockGeom g) {
  const T tot = pass<T, kJacobi>(x, b, out, colour, region, lk, li, lj, omega, g);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// Both colours in one cooperative launch: partials[c * gridDim.x + block].
template <typename T>
__global__ void __launch_bounds__(kThreads) block_rb_kernel(
    T* x, const T* b, T* partials, int region, int lk, int li, int lj, T omega,
    BlockGeom g) {
  cg::grid_group grid = cg::this_grid();
  for (int colour = 0; colour < 2; ++colour) {
    const T tot = pass<T, false>(x, b, x, colour, region, lk, li, lj, omega, g);
    if (threadIdx.x == 0) partials[colour * gridDim.x + blockIdx.x] = tot;
    if (colour == 0) grid.sync();
  }
}

template <typename T>
int max_blocks(int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_rb_kernel<T>,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// kind 0 Jacobi, 1 red-black; colour -1 both colours (cooperative).
template <typename T>
int launch(void* x, const void* b, void* out, void* partials, int kind, int colour,
           int region, int lk, int li, int lj, double omega, const int* geom,
           int nblocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  auto s = static_cast<cudaStream_t>(stream);
  BlockGeom g{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6]};
  T* xp = static_cast<T*>(x);
  const T* bp = static_cast<const T*>(b);
  T* pp = static_cast<T*>(partials);
  T om = T(omega);
  if (kind == 0) {
    block_pass_kernel<T, true><<<nblocks, kThreads, 0, s>>>(
        xp, bp, static_cast<T*>(out), pp, 0, region, lk, li, lj, om, g);
  } else if (colour >= 0) {
    block_pass_kernel<T, false><<<nblocks, kThreads, 0, s>>>(
        xp, bp, xp, pp, colour, region, lk, li, lj, om, g);
  } else {
    void* args[] = {&xp, &bp, &pp, &region, &lk, &li, &lj, &om, &g};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(block_rb_kernel<T>),
                                    dim3(nblocks), dim3(kThreads), args, 0, s);
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

// geom: k0, i0, j0, Kg, Ig, Jg, offset
int cz_block_sweep_f32(void* x, const void* b, void* out, void* partials, int kind,
                       int colour, int region, int lk, int li, int lj, double omega,
                       const int* geom, int nblocks, int device, void* stream) {
  return launch<float>(x, b, out, partials, kind, colour, region, lk, li, lj, omega,
                       geom, nblocks, device, stream);
}

int cz_block_sweep_f64(void* x, const void* b, void* out, void* partials, int kind,
                       int colour, int region, int lk, int li, int lj, double omega,
                       const int* geom, int nblocks, int device, void* stream) {
  return launch<double>(x, b, out, partials, kind, colour, region, lk, li, lj, omega,
                        geom, nblocks, device, stream);
}

}  // extern "C"
