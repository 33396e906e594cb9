// The ghost exchange and the residual fold of the distributed block steps
// for Hopper (sm_90a): one launch each for all the blocks of a card.
//
// Replace the per-plane slice copies of parallel/halo.py::refresh_ghosts
// (the port's counterpart of cubez_tpu/parallel/halo.py's lax.ppermute, the
// reference's Comm_S, cz_comm.cpp:23-38) and the per-block float64 sums of
// halo.py::psum_all (lax.psum, the reference's Comm_SUM_1) for blocks that
// share a card.
//
// Exchange.  The state is a list of ghosted (lk+2, li+2, lj+2) blocks
// (cuda_kernels/dist_sweeps.py).  Face f = 2 axis + side of a block is its
// ghost plane at index 0 (side 0) or l+1 (side 1) of ``axis``; its FACE
// cells are the ones at owned indices on the two other axes.  Each is
// copied from the neighbour's owned face across it (index l of the block
// below, index 1 of the block above).  Edge and corner ghosts (a ghost index
// on two axes or more) are left as they are: no kernel of the port reads
// them (the 7-point stencil and the line systems read face ghosts only;
// NOFACE=6, CB_Define_stub.h:31-35).  ``mode`` 0 copies directly; 1
// gathers the faces into a staging buffer (the overlap step, on its side
// stream, while the interior pass runs); 2 scatters the staging buffer into
// the ghosts.  Staging layout: per block the six faces in order, face sizes
// li lj, li lj, lk lj, lk lj, lk li, lk li.  One CTA row per (block, face)
// pair, grid-stride over the face's cells.  Bytes bound it: a 64^3 block's
// six faces are 98 KB read and written, 0.8 MB for eight blocks (0.5 us at
// 3.35 TB/s); at that size launch latency is the cost.
//
// Fold.  Every launch of a step writes its per-CTA partial sums of dp^2 (in
// the field's type) into one buffer; one CTA sums them in float64 in a
// fixed order (thread t takes t, t + 256, ... in turn, then block_sum's
// fixed tree) into the step's 0-d float64 residual.  No atomics: the
// history is the same bit for bit from run to run.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

using namespace cz;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;  // blocks in one launch (dist_halo.py MAX_BLOCKS)

template <typename T>
struct ExBlock {
  T* x;            // the block that receives its ghosts
  const T* nb[6];  // the neighbour across face f, nullptr past the mesh edge
};

template <typename T>
struct ExArgs {
  ExBlock<T> blk[kMaxBlocks];
  T* staging;
  int first;  // index of blk[0] in the staging buffer
  int lk, li, lj;
  int mode;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) exchange_kernel(const __grid_constant__ ExArgs<T> a) {
  const int f = blockIdx.y, axis = f >> 1, side = f & 1;
  const ExBlock<T>& B = a.blk[blockIdx.z];
  const T* src = B.nb[f];
  if (src == nullptr) return;
  const int Jp = a.lj + 2;
  const size_t plane = size_t(a.li + 2) * Jp;
  // the face's own axis (length la, stride sa) and its two others (u, v)
  const int la = axis == 0 ? a.lk : axis == 1 ? a.li : a.lj;
  const size_t sa = axis == 0 ? plane : axis == 1 ? size_t(Jp) : 1;
  const int nu = axis == 0 ? a.li : a.lk, nv = axis == 2 ? a.li : a.lj;
  const size_t su = axis == 0 ? size_t(Jp) : plane, sv = axis == 2 ? size_t(Jp) : 1;
  const size_t dst0 = size_t(side ? la + 1 : 0) * sa;
  const size_t src0 = size_t(side ? 1 : la) * sa;
  const size_t A0 = size_t(a.li) * a.lj, A1 = size_t(a.lk) * a.lj, A2 = size_t(a.lk) * a.li;
  const size_t st = size_t(a.first + blockIdx.z) * 2 * (A0 + A1 + A2) + (f >= 1 ? A0 : 0) +
                    (f >= 2 ? A0 : 0) + (f >= 3 ? A1 : 0) + (f >= 4 ? A1 : 0) +
                    (f >= 5 ? A2 : 0);
  const int cells = nu * nv;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < cells; t += gridDim.x * kThreads) {
    const int u = t / nv, v = t - u * nv;
    const size_t off = size_t(u + 1) * su + size_t(v + 1) * sv;
    if (a.mode == 0) {
      B.x[dst0 + off] = src[src0 + off];
    } else if (a.mode == 1) {
      a.staging[st + t] = src[src0 + off];
    } else {
      B.x[dst0 + off] = a.staging[st + t];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fold_kernel(const T* __restrict__ partials, int n,
                                                        double* out) {
  double acc = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += double(partials[i]);
  const double tot = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) *out = tot;
}

// ptrs: 7 per block (x, then the neighbours across faces 0..5, 0 for
// none), then the staging buffer.  iargs: n, first, lk, li, lj, mode,
// grid_x, device.  The wrapper builds both arrays once for a set of blocks.
template <typename T>
int exchange(void* const* ptrs, const int* iargs, void* stream) {
  const int n = iargs[0];
  if (n < 1 || n > kMaxBlocks) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(iargs[7]);
  if (e != cudaSuccess) return e;
  ExArgs<T> a{};
  for (int b = 0; b < n; ++b) {
    a.blk[b].x = static_cast<T*>(ptrs[7 * b]);
    for (int f = 0; f < 6; ++f) a.blk[b].nb[f] = static_cast<const T*>(ptrs[7 * b + 1 + f]);
  }
  a.staging = static_cast<T*>(ptrs[7 * n]);
  a.first = iargs[1];
  a.lk = iargs[2];
  a.li = iargs[3];
  a.lj = iargs[4];
  a.mode = iargs[5];
  exchange_kernel<T><<<dim3(iargs[6], 6, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
int fold(const void* partials, int n, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  fold_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(partials), n, static_cast<double*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_dist_max_blocks(void) { return kMaxBlocks; }

int cz_halo_exchange_f32(void* const* ptrs, const int* iargs, void* stream) {
  return exchange<float>(ptrs, iargs, stream);
}

int cz_halo_exchange_f64(void* const* ptrs, const int* iargs, void* stream) {
  return exchange<double>(ptrs, iargs, stream);
}

int cz_fold_partials_f32(const void* partials, int n, void* out, int device, void* stream) {
  return fold<float>(partials, n, out, device, stream);
}

int cz_fold_partials_f64(const void* partials, int n, void* out, int device, void* stream) {
  return fold<double>(partials, n, out, device, stream);
}

}  // extern "C"
