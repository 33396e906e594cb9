// Distributed packed red-black SOR for Hopper (sm_90a): the window chain
// on the mesh blocks of one card, each extended by a deep ghost ring (K7),
// and the ring's refresh.
//
// Replaces cubez_tpu/pallas_kernels/sweeps2x.py:480 (build_nx, the window
// chain K3) as reached through cubez_tpu/pallas_kernels/dist_rbpack.py:299
// (make_dist_packed_sweepnx -> _dist_rb_pair_packed and its MAF form), and
// for blocks that share a card the slab copies of the ring
// (parallel/dist_pack.py::exchange_ghosts_packed, the port's counterpart
// of the JAX package's lax.ppermute).
//
// State: each block's owned (lk, li, lj) cells extended by a ring of depth
// (hz, hx, hy) (h = 2n on each split mesh axis, 0 on the others), folded
// by colour as cuda_kernels/rbpack.py::pack_rb does: x[2][Ke][Ie/2][Je].
// Block extents and depths are even, so every block origin is even and the
// extended-local colour parity is the global one.
//
// dist_rb_sweeps_kernel: one cooperative launch over every block of the
// card runs n full red-black iterations, with a grid-wide sync between
// colours: 2n syncs a call.  The blocks' pointers, MAF tables and origins
// go by value in a __grid_constant__ struct (up to kMaxBlocks).  A work
// item is one (block, k, i2) row with the lanes of a warp over j: the row
// costs a few divisions, a point none.  A point updates where its 7-point
// neighbourhood lies inside the extended array AND it is a global inner
// point.  The ring is recomputed redundantly; after m iterations the exact
// cells reach h - 2m outside the owned box, so with h >= 2n the owned
// cells are bitwise the serial n-iteration result, and the next exchange
// rewrites the ring.  The residual sums dp^2 over the owned boxes only,
// so no cell counts twice across blocks.
//
// pack_exchange_kernel: the ring refresh of every block of the mesh (all
// on this card) in one launch: every ring cell on a split axis, edges and
// corners included, is copied from the block that owns its global cell
// (one hop along up to three axes, since h <= the block extent); cells
// past the grid are left as they are.  That is bitwise what the
// three-phase transitive slab copy gives (phase Z, then X, then Y, each
// carrying the axes already refreshed): the last phase to write a cell
// wrote the owner's value.  Reads touch owned cells only and writes ring
// cells only, so one launch has no race.  A work item is one (block,
// colour, k, i2) row, lanes over j; an owned row visits its J ring only.
//
// Arithmetic: common.cuh packed_dp (const_dp / maf_dp), bitwise equal to
// the serial packed kernels and to the plain twin
// (cuda_kernels/dist_rbpack.py::dist_sweeps_plain).  The MAF weights are
// the serial tables sliced at each block's extended origin (guard entries
// 1.0 outside the grid, where no point updates).
//
// What bounds it on an H100: at 128^3 over (2,2,2) each block is 64^3
// owned, 88^3 extended with n = 6; the eight take 21.8 MB and stay in the
// 50 MB L2, so per-point instructions, the grid syncs and the host's
// launches bound it (the one-launch-a-block design paid 8 launches, up to
// 48 slab copies and a host fold a call); at 512^3 a 280^3 block (88 MB)
// streams from HBM on each colour pass.
//
// Residuals: one partial a CTA for each (iteration, colour), in the field's
// type; after the last grid sync CTA q folds iteration q's partials in
// float64 in a fixed order into r2[q]: no atomics, so the history is the
// same bit for bit from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 32;  // blocks in one launch (dist_rbpack.py MAX_BLOCKS)

template <typename T>
struct Block {
  T* x;            // the extended packed block, updated in place
  const T* tab;    // its MAF tables, nullptr for constant coefficients
  int k0, i0, j0;  // global origin of its owned cells
};

template <typename T>
struct Args {
  Block<T> blk[kMaxBlocks];
  T* partials;  // (n, 2, gridDim.x)
  double* r2;   // (n,)
  T omega;
  int nb;           // blocks
  int Ke, I2, Je;   // extended packed dims
  int hz, hx, hy;   // ring depth per axis
  int lk, li, lj;   // owned extents
  int Kg, Ig, Jg;   // global shape
  int n, offset;
};

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kThreads) dist_rb_sweeps_kernel(
    const __grid_constant__ Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpb = (a.Ke - 2) * a.I2;  // rows of a block: k in [1, Ke-2], every i2
  const int rows = a.nb * rpb;
  const size_t half = size_t(a.Ke) * a.I2 * a.Je;  // one colour
  const int Ie = 2 * a.I2;
  for (int it = 0; it < a.n; ++it) {
    for (int colour = 0; colour < 2; ++colour) {
      T acc = 0;
      for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
        const int bi = row / rpb;
        const int r = row - bi * rpb;
        const int km = r / a.I2;
        const int k = 1 + km, i2 = r - km * a.I2;
        const Block<T>& B = a.blk[bi];
        const int gk = k + B.k0 - a.hz;
        if (gk < 1 || gk > a.Kg - 2) continue;
        T* c = B.x + colour * half;
        const T* o = B.x + (1 - colour) * half;
        // the owned box is whole pair-rows (even depths and extents)
        const bool row_own =
            k >= a.hz && k < a.hz + a.lk && 2 * i2 >= a.hx && 2 * i2 < a.hx + a.li;
        const int par = k + a.offset + 1 + colour;
        const int gi0 = 2 * i2 + B.i0 - a.hx;  // global i at s = 0
        const int dj = B.j0 - a.hy;            // global j - local j
        const size_t p0 = (size_t(k) * a.I2 + i2) * a.Je;
        for (int j = 1 + lane; j <= a.Je - 2; j += 32) {
          const int s = (par + j) & 1;
          const int i = 2 * i2 + s;
          const int gi = gi0 + s, gj = j + dj;
          if (i < 1 || i > Ie - 2 || gi < 1 || gi > a.Ig - 2 || gj < 1 || gj > a.Jg - 2)
            continue;
          const size_t p = p0 + j;
          const T cen = c[p];
          const T dp = packed_dp<T, kMaf>(o, nullptr, B.tab, cen, p, k, i2, j, s, a.Ke,
                                          a.I2, a.Je, a.omega);
          c[p] = add_rn(cen, dp);
          if (row_own && j >= a.hy && j < a.hy + a.lj) acc += dp * dp;
        }
      }
      const T tot = block_sum<kThreads>(acc);
      if (threadIdx.x == 0) a.partials[(size_t(it) * 2 + colour) * gridDim.x + blockIdx.x] = tot;
      grid.sync();
    }
  }
  for (int it = blockIdx.x; it < a.n; it += gridDim.x) {
    double s = 0;
    for (int q = threadIdx.x; q < 2 * int(gridDim.x); q += kThreads)
      s += double(a.partials[size_t(it) * 2 * gridDim.x + q]);
    s = block_sum<kThreads>(s);
    if (threadIdx.x == 0) a.r2[it] = s;
  }
}

template <typename T>
struct ExArgs {
  T* x[kMaxBlocks];  // every block of the mesh, in mesh order
  int nb;
  int dz, dx, dy;    // mesh division
  int Ke, I2, Je;    // extended packed dims
  int hz, hx2, hy;   // ring depths (X in pair-rows)
  int lk, li2, lj;   // owned extents (X in pair-rows)
};

// -1, 0, 1: below the owned range [h, h + l), in it, above it.
__device__ __forceinline__ int side(int e, int h, int l) { return e < h ? -1 : (e >= h + l); }

template <typename T>
__global__ void __launch_bounds__(kThreads) pack_exchange_kernel(const __grid_constant__ ExArgs<T> a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane_rows = a.Ke * a.I2;
  const int rpb = 2 * plane_rows;  // rows of a block: colour, k, i2
  const int rows = a.nb * rpb;
  const size_t half = size_t(a.Ke) * a.I2 * a.Je;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const int bi = row / rpb;
    int r = row - bi * rpb;
    const int c = r / plane_rows;
    r -= c * plane_rows;
    const int k = r / a.I2, i2 = r - k * a.I2;
    const int dk = side(k, a.hz, a.lk), di = side(i2, a.hx2, a.li2);
    const int bz = bi / (a.dx * a.dy), bx = (bi / a.dy) % a.dx, by = bi % a.dy;
    const int nz = bz + dk, nx = bx + di;
    if (nz < 0 || nz >= a.dz || nx < 0 || nx >= a.dx) continue;  // past the grid
    const bool ring_row = dk != 0 || di != 0;
    const int span = ring_row ? a.Je : 2 * a.hy;  // an owned row: its J ring
    const size_t off = c * half;
    T* dst = a.x[bi] + off + (size_t(k) * a.I2 + i2) * a.Je;
    const size_t src0 = off + (size_t(k - dk * a.lk) * a.I2 + (i2 - di * a.li2)) * a.Je;
    for (int t = lane; t < span; t += 32) {
      const int j = ring_row || t < a.hy ? t : t + a.lj;
      const int dj = side(j, a.hy, a.lj);
      const int ny = by + dj;
      if (ny < 0 || ny >= a.dy) continue;
      dst[j] = a.x[(nz * a.dx + nx) * a.dy + ny][src0 + (j - dj * a.lj)];
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

// ptrs: x, tab per block, then partials and r2.  iargs: nb, Ke, I2, Je,
// hz, hx, hy, lk, li, lj, Kg, Ig, Jg, n, offset, grid, device, then k0,
// i0, j0 per block.  The wrapper builds both arrays once for a set of
// blocks.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* stream) {
  const int nb = iargs[0], grid = iargs[15];
  if (nb < 1 || nb > kMaxBlocks || grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(iargs[16]);
  if (e != cudaSuccess) return e;
  Args<T> a{};
  const int* org = iargs + 17;
  for (int b = 0; b < nb; ++b)
    a.blk[b] = Block<T>{static_cast<T*>(ptrs[2 * b]), static_cast<const T*>(ptrs[2 * b + 1]),
                        org[3 * b], org[3 * b + 1], org[3 * b + 2]};
  a.partials = static_cast<T*>(ptrs[2 * nb]);
  a.r2 = static_cast<double*>(ptrs[2 * nb + 1]);
  a.omega = T(omega);
  a.nb = nb;
  a.Ke = iargs[1];
  a.I2 = iargs[2];
  a.Je = iargs[3];
  a.hz = iargs[4];
  a.hx = iargs[5];
  a.hy = iargs[6];
  a.lk = iargs[7];
  a.li = iargs[8];
  a.lj = iargs[9];
  a.Kg = iargs[10];
  a.Ig = iargs[11];
  a.Jg = iargs[12];
  a.n = iargs[13];
  a.offset = iargs[14];
  const bool maf = a.blk[0].tab != nullptr;
  void* kernel = maf ? reinterpret_cast<void*>(dist_rb_sweeps_kernel<T, true>)
                     : reinterpret_cast<void*>(dist_rb_sweeps_kernel<T, false>);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ptrs: every block in mesh order.  iargs: nb, dz, dx, dy, Ke, I2, Je, hz,
// hx2, hy, lk, li2, lj, grid, device.
template <typename T>
int exchange(void* const* ptrs, const int* iargs, void* stream) {
  const int nb = iargs[0], grid = iargs[13];
  if (nb < 1 || nb > kMaxBlocks || grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(iargs[14]);
  if (e != cudaSuccess) return e;
  ExArgs<T> a{};
  for (int b = 0; b < nb; ++b) a.x[b] = static_cast<T*>(ptrs[b]);
  a.nb = nb;
  a.dz = iargs[1];
  a.dx = iargs[2];
  a.dy = iargs[3];
  a.Ke = iargs[4];
  a.I2 = iargs[5];
  a.Je = iargs[6];
  a.hz = iargs[7];
  a.hx2 = iargs[8];
  a.hy = iargs[9];
  a.lk = iargs[10];
  a.li2 = iargs[11];
  a.lj = iargs[12];
  if (a.dz * a.dx * a.dy != nb) return cudaErrorInvalidValue;
  pack_exchange_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
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

int cz_dist_rb_sweeps_f32(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<float>(ptrs, iargs, omega, stream);
}

int cz_dist_rb_sweeps_f64(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<double>(ptrs, iargs, omega, stream);
}

int cz_pack_exchange_f32(void* const* ptrs, const int* iargs, void* stream) {
  return exchange<float>(ptrs, iargs, stream);
}

int cz_pack_exchange_f64(void* const* ptrs, const int* iargs, void* stream) {
  return exchange<double>(ptrs, iargs, stream);
}

}  // extern "C"
