// The Krylov loop's operator for Hopper (sm_90a): the constant-coefficient
// 7-point A x, ap = (nbr_sum(p) - 6 p) * msk, and with a right-hand side
// r = (b - (nbr_sum(p) - 6 p)) * msk, in one pass over the (K, I, J) field.
//
// It replaces no pallas_call: the JAX package leaves calc_ax and calc_rk to
// XLA (cubez_tpu/ops/blas.py), which fuses them into one loop.  The port's
// eager form (ops/blas.py, its plain twin) is six zero-filled shifts (a fill
// and a strided copy each), five adds, the product 6 p, a subtraction and
// the mask: 20 launches and about 41 field transfers an application, where
// the work needs 3 (read p and msk, write ap; 4 with b).  BiCGSTAB applies
// it twice an iteration.
//
// What bounds it: bytes.  13 operations a point against 3 fields of 8 bytes
// (float64) is far below the card's balance, so at 256^3 float64 (134 MB a
// field) the least time is 3 fields over 3.35 TB/s, 0.120 ms.  The design
// reads each field once from HBM and keeps every other access on the SM:
//
// - A CTA of 32 x 8 threads owns a tile of 8 rows (i) of 32 columns (j),
//   and a chunk of planes (k).  A warp takes one row, its lanes neighbouring
//   columns, so each load and the store are whole 128-byte lines (256 bytes
//   a warp in float64).
// - A thread walks its (i, j) column up the chunk holding p[k-1], p[k] and
//   p[k+1] in registers: each plane of p is loaded once, as p[k+1], and
//   moves down the registers.  The i +- 1 and j +- 1 neighbours are the
//   same plane's values that the warps next to it (or the lanes beside it)
//   load as their own p[k+1]: they come from L1 (the read-only path), and
//   at the tile's edge from the L2, where the neighbouring CTA brought them.
// - The chunks split K so that one wave of CTAs fills every SM (the
//   occupancy query's blocks an SM times the SM count): each CTA reads two
//   planes past its chunk's ends, from the L2 too.
//
// Arithmetic: bitwise the plain twin (ops/blas.py calc_ax, calc_rk, which
// sum ops/shifts.py's zero-filled shifts).  Each operation rounds on its
// own (common.cuh's _rn intrinsics, built with --fmad=false), in the
// twin's order: ((((xm + xp) + ym) + yp) + zm) + zp, with a 0 added in
// place of a neighbour past the array's edge, then minus the product
// 6 p, then for r b minus that, then times msk.
//
// The output is written OUT OF PLACE, into a field of its own: BiCGSTAB
// reads the last iteration's A x after this one's.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

using namespace cz;

constexpr int kTx = 32;  // lanes along j
constexpr int kTy = 8;   // warps along i
constexpr int kThreads = kTx * kTy;
constexpr int kMaxDevices = 64;

template <typename T, bool kHasB>
__global__ void __launch_bounds__(kThreads)
    ax_kernel(const T* __restrict__ p, const T* __restrict__ b, const T* __restrict__ msk,
              T* __restrict__ out, int K, int I, int J, int kchunk) {
  const int j = blockIdx.x * kTx + threadIdx.x;
  const int i = blockIdx.y * kTy + threadIdx.y;
  if (i >= I || j >= J) return;
  const int k0 = blockIdx.z * kchunk;
  const int k1 = min(k0 + kchunk, K);
  const size_t plane = size_t(I) * J;
  size_t c = size_t(k0) * plane + size_t(i) * J + j;
  T zm = k0 > 0 ? p[c - plane] : T(0);
  T cen = p[c];
  for (int k = k0; k < k1; ++k, c += plane) {
    const T zp = k + 1 < K ? p[c + plane] : T(0);
    const T xm = i > 0 ? p[c - J] : T(0);
    const T xp = i + 1 < I ? p[c + J] : T(0);
    const T ym = j > 0 ? p[c - 1] : T(0);
    const T yp = j + 1 < J ? p[c + 1] : T(0);
    const T ss = add_rn(add_rn(add_rn(add_rn(add_rn(xm, xp), ym), yp), zm), zp);
    T a = sub_rn(ss, mul_rn(T(6), cen));
    if constexpr (kHasB) a = sub_rn(b[c], a);
    out[c] = mul_rn(a, msk[c]);
    zm = cen;
    cen = zp;
  }
}

// CTAs resident on the whole device at once (every SM), per device and
// form; 0 until first asked.  A race fills a slot twice with one value.
int g_resident[kMaxDevices][4];

template <typename T, bool kHasB>
int resident(int device, int& n) {
  int& slot = g_resident[device][2 * (sizeof(T) == 8) + kHasB];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ax_kernel<T, kHasB>,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    slot = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  n = slot;
  return cudaSuccess;
}

template <typename T, bool kHasB>
int launch(const void* p, const void* b, const void* msk, void* out, int K, int I, int J,
           int device, void* stream) {
  if (K < 1 || I < 1 || J < 1) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int n = 0;
  if (int rc = resident<T, kHasB>(device, n)) return rc;
  const dim3 tiles((J + kTx - 1) / kTx, (I + kTy - 1) / kTy);
  // as many chunks as one wave holds beside the tiles, none empty
  const int want = n / int(tiles.x * tiles.y);
  const int chunks = want < 1 ? 1 : (want > K ? K : want);
  const int kchunk = (K + chunks - 1) / chunks;
  const dim3 grid(tiles.x, tiles.y, (K + kchunk - 1) / kchunk);
  ax_kernel<T, kHasB><<<grid, dim3(kTx, kTy), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(b), static_cast<const T*>(msk),
      static_cast<T*>(out), K, I, J, kchunk);
  return cudaGetLastError();
}

template <typename T>
int calc_ax(const void* p, const void* b, const void* msk, void* out, int K, int I, int J,
            int device, void* stream) {
  return b == nullptr ? launch<T, false>(p, b, msk, out, K, I, J, device, stream)
                      : launch<T, true>(p, b, msk, out, K, I, J, device, stream);
}

}  // namespace

extern "C" {

// p, b (nullptr for A x), msk and out: contiguous (K, I, J) fields of one
// type on ``device``; out is written, the others read.
int cz_calc_ax_f32(const void* p, const void* b, const void* msk, void* out, int K, int I,
                   int J, int device, void* stream) {
  return calc_ax<float>(p, b, msk, out, K, I, J, device, stream);
}

int cz_calc_ax_f64(const void* p, const void* b, const void* msk, void* out, int K, int I,
                   int J, int device, void* stream) {
  return calc_ax<double>(p, b, msk, out, K, I, J, device, stream);
}

}  // extern "C"
