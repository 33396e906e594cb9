// Distributed packed red-black SOR for Hopper (sm_90a): the window chain
// of one mesh block extended by a deep ghost ring (K7).
//
// Replaces cubez_tpu/pallas_kernels/sweeps2x.py:480 (build_nx, the window
// chain K3) as reached through cubez_tpu/pallas_kernels/dist_rbpack.py:299
// (make_dist_packed_sweepnx -> _dist_rb_pair_packed and its MAF form).
//
// State: one block's owned (lk, li, lj) cells extended by a ring of depth
// (hz, hx, hy) (h = 2n on each split mesh axis, 0 on the others), folded by
// colour as cuda_kernels/rbpack.py::pack_rb does: x[2][Ke][Ie/2][Je].
// Block extents and depths are even, so every block origin is even and the
// extended-local colour parity is the global one.
//
// One cooperative launch runs n full red-black iterations (grid.sync()
// between colours, as rb_sweeps_kernel in rbpack.cu).  A point updates
// where its 7-point neighbourhood lies inside the extended array AND it is
// a global inner point: the block's global origin (k0, i0, j0) and the
// global shape arrive as arguments (the TPU kernel reads them from SMEM,
// traced from lax.axis_index).  The ring is recomputed redundantly; after
// m iterations the exact cells reach h - 2m outside the owned box, so with
// h >= 2n the owned cells are bitwise the serial n-iteration result, and
// the next exchange rewrites the ring.  The residual sums dp^2 over the
// owned box only, so no cell counts twice across blocks.
//
// Arithmetic: common.cuh packed_dp (const_dp / maf_dp), bitwise equal to the
// serial packed kernels and to the plain twin
// (cuda_kernels/dist_rbpack.py::dist_sweeps_plain).  The MAF weights are
// the serial tables sliced at the block's extended origin (guard entries
// 1.0 outside the grid, where no point updates).
//
// What bounds it on an H100: the same as rb_sweeps_kernel, on the extended
// block: at 128^3 over (2,2,2) a block is 64^3 owned, 88^3 extended with
// n = 6 (2.6x the owned cells), and stays in the 50 MB L2, so per-point
// instructions and grid syncs bound it; at 512^3 a 280^3 block (88 MB)
// streams from HBM on each colour pass.  Blocks of one card run one launch
// after another; batching them is later work.
//
// Residuals: per-block partials in the field's type in a fixed order,
// folded in float64 by block 0 after the last grid sync (no atomics).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kThreads = 256;

// The block's place in the global grid.
struct DistGeom {
  int hz, hx, hy;  // ring depth per axis
  int lk, li, lj;  // owned extents
  int k0, i0, j0;  // global origin of the owned cells
  int Kg, Ig, Jg;  // global shape
};

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kThreads) dist_rb_sweeps_kernel(
    T* x, const T* tab, T* partials, double* r2, int K, int I2, int J, int n,
    int offset, T omega, unsigned n_cells, DistGeom g) {
  cg::grid_group grid = cg::this_grid();
  const size_t plane = size_t(K) * I2 * J;
  const unsigned nb = gridDim.x;
  const unsigned stride = nb * kThreads;
  const unsigned jm = J - 2;
  const int Ie = 2 * I2;
  for (int it = 0; it < n; ++it) {
    for (int colour = 0; colour < 2; ++colour) {
      T* c = x + colour * plane;
      const T* o = x + (1 - colour) * plane;
      T acc = 0;
      for (unsigned idx = blockIdx.x * kThreads + threadIdx.x; idx < n_cells;
           idx += stride) {
        const int j = 1 + int(idx % jm);
        const unsigned r = idx / jm;
        const int i2 = int(r % unsigned(I2));
        const int k = 1 + int(r / unsigned(I2));
        const int s = (k + j + offset + 1 + colour) & 1;
        const int i = 2 * i2 + s;
        const int gk = k + g.k0 - g.hz;
        const int gi = i + g.i0 - g.hx;
        const int gj = j + g.j0 - g.hy;
        if (i < 1 || i > Ie - 2 || gk < 1 || gk > g.Kg - 2 || gi < 1 ||
            gi > g.Ig - 2 || gj < 1 || gj > g.Jg - 2)
          continue;
        const size_t p = (size_t(k) * I2 + i2) * J + j;
        const T cen = c[p];
        const T dp = packed_dp<T, kMaf>(o, nullptr, tab, cen, p, k, i2, j, s, K,
                                        I2, J, omega);
        c[p] = add_rn(cen, dp);
        // the owned box is whole pair-rows (even depths and extents)
        if (k >= g.hz && k < g.hz + g.lk && 2 * i2 >= g.hx &&
            2 * i2 < g.hx + g.li && j >= g.hy && j < g.hy + g.lj)
          acc += dp * dp;
      }
      const T tot = block_sum<kThreads>(acc);
      if (threadIdx.x == 0) partials[(size_t(it) * 2 + colour) * nb + blockIdx.x] = tot;
      grid.sync();
    }
  }
  if (blockIdx.x == 0) {
    for (int it = 0; it < n; ++it) {
      double s = 0;
      for (unsigned q = threadIdx.x; q < 2 * nb; q += kThreads)
        s += double(partials[size_t(it) * 2 * nb + q]);
      s = block_sum<kThreads>(s);
      if (threadIdx.x == 0) r2[it] = s;
    }
  }
}

template <typename T>
int max_blocks(int maf, int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, maf ? dist_rb_sweeps_kernel<T, true> : dist_rb_sweeps_kernel<T, false>,
      kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch(void* x, const void* tab, void* partials, void* r2, int K, int I2, int J,
           int n, int offset, double omega, unsigned n_cells, const int* geom,
           int nblocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  T* xp = static_cast<T*>(x);
  const T* tp = static_cast<const T*>(tab);
  auto* pp = static_cast<T*>(partials);
  double* rp = static_cast<double*>(r2);
  T om = T(omega);
  DistGeom g{geom[0], geom[1], geom[2], geom[3], geom[4],  geom[5],
             geom[6], geom[7], geom[8], geom[9], geom[10], geom[11]};
  void* args[] = {&xp, &tp, &pp, &rp, &K, &I2, &J, &n, &offset, &om, &n_cells, &g};
  void* kernel = tab != nullptr
                     ? reinterpret_cast<void*>(dist_rb_sweeps_kernel<T, true>)
                     : reinterpret_cast<void*>(dist_rb_sweeps_kernel<T, false>);
  e = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_dist_rb_max_blocks_f32(int maf, int device, int* out) {
  return max_blocks<float>(maf, device, out);
}

int cz_dist_rb_max_blocks_f64(int maf, int device, int* out) {
  return max_blocks<double>(maf, device, out);
}

// geom: 12 ints, DistGeom's fields in order
int cz_dist_rb_sweeps_f32(void* x, const void* tab, void* partials, void* r2, int K,
                          int I2, int J, int n, int offset, double omega,
                          unsigned n_cells, const int* geom, int nblocks, int device,
                          void* stream) {
  return launch<float>(x, tab, partials, r2, K, I2, J, n, offset, omega, n_cells, geom,
                       nblocks, device, stream);
}

int cz_dist_rb_sweeps_f64(void* x, const void* tab, void* partials, void* r2, int K,
                          int I2, int J, int n, int offset, double omega,
                          unsigned n_cells, const int* geom, int nblocks, int device,
                          void* stream) {
  return launch<double>(x, tab, partials, r2, K, I2, J, n, offset, omega, n_cells, geom,
                        nblocks, device, stream);
}

}  // extern "C"
