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
//
// The vector passes (vec_kernel, fold_kernel): the rest of a BiCGSTAB
// iteration's vector work, the maps and dots of ops/blas.py, as five
// passes over the fields in place of 31 eager launches (about 77 field
// transfers; the passes need 24):
//
//   bicg_1     p = (r + beta (p - omega q)) msk            read 4, write 1
//   dot2       sum (q r0) msk                              read 3
//   triad      s = (a q + r) msk                           read 3, write 1
//   dots_t     sum (t s) msk and sum (t t) msk             read 3
//   update_xr  x = x + (alpha p_ + omega s_) msk,          read 7, write 2
//              r = (-omega t_ + s) msk, sum (r r) msk and sum (r r0) msk
//
// and cg.py's axpy, x + (a p) msk, and dot1 alone.  They are bytes too:
// at most 14 operations a point against 3 to 9 fields, so a pass's least
// time is its fields over 3.35 TB/s (0.96 ms an iteration at 256^3
// float64).  A CTA of 256 threads strides over the flat (K, I, J) index,
// a warp's lanes on neighbouring points, so every load and store is whole
// lines; one wave of CTAs (the occupancy query's blocks an SM times the
// SM count) covers the field.
//
// Arithmetic of the maps: bitwise their plain twins, each operation
// rounded on its own (_rn, --fmad=false) in ops/blas.py's order, times
// msk as read from the problem's mask (its exact zeros and ones; a NaN
// propagates as the twin's does); -omega is the exact negation the loop's
// -omega is.  The scalars alpha, beta and omega are 0-d fields on the
// card, read through a pointer: no host sync.
//
// Arithmetic of the dots: each term rounds as the twin's (p q) msk does,
// and the sum is taken in the field's type in a fixed order, so a dot is
// the same bits in every run on a card (no atomics): a thread adds its
// points in index order, a CTA folds its threads by common.cuh's
// block_sum_any (shuffles within a warp, then the warps in order), and
// fold_kernel, a second launch of one warp, has lane l add the partials
// of CTAs l, l + 32, ... in order and folds the 32 lanes by shuffles.
// That order is not torch's sum's: a dot differs from the twin's by the
// rounding of the order alone.
//
// Every output is written OUT OF PLACE: the loop reads the old p, s and r
// after the new ones are made.

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


// ---- the vector passes ----------------------------------------------------

// The passes, numbered as cuda_kernels/blas.py's _PASSES.
enum VecOp : int { kBicg1 = 0, kTriad, kAxpy, kDot1, kDot2, kDotsT, kUpdateXr, kVecOps };

constexpr int kVecThreads = 256;
constexpr int kFoldLanes = 32;

__host__ __device__ constexpr int dots_of(int op) {
  return op == kDot1 || op == kDot2 ? 1 : (op == kDotsT || op == kUpdateXr ? 2 : 0);
}

// A pass's pointers, in cuda_kernels/blas.py's order: the fields it reads
// (in), the mask, its 0-d scalars (s), the fields it writes (out), the
// per-CTA partial dots (part, [grid][dots]) and the dots (dot).
template <typename T>
struct VecArgs {
  const T* in[6];
  const T* msk;
  const T* s[2];
  T* out[2];
  T* part;
  T* dot;
};

template <typename T, int kOp>
__global__ void __launch_bounds__(kVecThreads) vec_kernel(VecArgs<T> a, size_t n) {
  constexpr int kDots = dots_of(kOp);
  const T* __restrict__ f0 = a.in[0];
  const T* __restrict__ f1 = a.in[1];
  const T* __restrict__ f2 = a.in[2];
  const T* __restrict__ f3 = a.in[3];
  const T* __restrict__ f4 = a.in[4];
  const T* __restrict__ f5 = a.in[5];
  const T* __restrict__ msk = a.msk;
  T* __restrict__ o0 = a.out[0];
  T* __restrict__ o1 = a.out[1];
  T s0 = T(0), s1 = T(0);
  if constexpr (kOp == kBicg1 || kOp == kUpdateXr) {
    s0 = *a.s[0];
    s1 = *a.s[1];
  } else if constexpr (kOp == kTriad || kOp == kAxpy) {
    s0 = *a.s[0];
  }
  T acc0 = T(0), acc1 = T(0);
  const size_t stride = size_t(gridDim.x) * kVecThreads;
  for (size_t e = size_t(blockIdx.x) * kVecThreads + threadIdx.x; e < n; e += stride) {
    const T m = msk[e];
    if constexpr (kOp == kBicg1) {  // p r q; beta omega
      o0[e] = mul_rn(add_rn(f1[e], mul_rn(s0, sub_rn(f0[e], mul_rn(s1, f2[e])))), m);
    } else if constexpr (kOp == kTriad) {  // x y; a
      o0[e] = mul_rn(add_rn(mul_rn(s0, f0[e]), f1[e]), m);
    } else if constexpr (kOp == kAxpy) {  // x p; a
      o0[e] = add_rn(f0[e], mul_rn(mul_rn(s0, f1[e]), m));
    } else if constexpr (kOp == kDot1) {  // p
      const T p = f0[e];
      acc0 = add_rn(acc0, mul_rn(mul_rn(p, p), m));
    } else if constexpr (kOp == kDot2) {  // p q
      acc0 = add_rn(acc0, mul_rn(mul_rn(f0[e], f1[e]), m));
    } else if constexpr (kOp == kDotsT) {  // t s
      const T t = f0[e];
      acc0 = add_rn(acc0, mul_rn(mul_rn(t, f1[e]), m));
      acc1 = add_rn(acc1, mul_rn(mul_rn(t, t), m));
    } else {  // kUpdateXr: x p_ s_ t_ s r0; alpha omega
      o0[e] = add_rn(f0[e], mul_rn(add_rn(mul_rn(s0, f1[e]), mul_rn(s1, f2[e])), m));
      const T r = mul_rn(add_rn(mul_rn(-s1, f3[e]), f4[e]), m);
      o1[e] = r;
      acc0 = add_rn(acc0, mul_rn(mul_rn(r, r), m));
      acc1 = add_rn(acc1, mul_rn(mul_rn(r, f5[e]), m));
    }
  }
  if constexpr (kDots > 0) {
    const T t0 = block_sum_any(acc0);
    if (threadIdx.x == 0) a.part[size_t(blockIdx.x) * kDots] = t0;
    if constexpr (kDots > 1) {
      const T t1 = block_sum_any(acc1);
      if (threadIdx.x == 0) a.part[size_t(blockIdx.x) * kDots + 1] = t1;
    }
  }
}

// The dots from the per-CTA partials of ``blocks`` CTAs, in one warp.
template <typename T>
__global__ void __launch_bounds__(kFoldLanes)
    fold_kernel(const T* __restrict__ part, int blocks, int dots, T* __restrict__ out) {
  const int lane = threadIdx.x;
  for (int d = 0; d < dots; ++d) {
    T v = T(0);
    for (int b = lane; b < blocks; b += kFoldLanes) v = add_rn(v, part[size_t(b) * dots + d]);
    for (int o = kFoldLanes / 2; o > 0; o >>= 1)
      v = add_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) out[d] = v;
  }
}

// CTAs of each pass resident on the whole device at once, per device,
// type and pass; 0 until first asked.
int g_vec_resident[kMaxDevices][2][kVecOps];

template <typename T, int kOp>
int vec_resident(int device, int& n) {
  int& slot = g_vec_resident[device][sizeof(T) == 8][kOp];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vec_kernel<T, kOp>,
                                                        kVecThreads, 0);
    if (e != cudaSuccess) return e;
    slot = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  n = slot;
  return cudaSuccess;
}

template <typename T, int kOp>
int vec_grid_of(long long n, int device, int* grid) {
  int res = 0;
  if (int rc = vec_resident<T, kOp>(device, res)) return rc;
  const long long want = (n + kVecThreads - 1) / kVecThreads;
  *grid = int(want < res ? want : res);
  return cudaSuccess;
}

template <typename T, int kOp>
int vec_launch(void* const* ptrs, long long n, int grid, cudaStream_t stream) {
  VecArgs<T> a;
  for (int i = 0; i < 6; ++i) a.in[i] = static_cast<const T*>(ptrs[i]);
  a.msk = static_cast<const T*>(ptrs[6]);
  a.s[0] = static_cast<const T*>(ptrs[7]);
  a.s[1] = static_cast<const T*>(ptrs[8]);
  a.out[0] = static_cast<T*>(ptrs[9]);
  a.out[1] = static_cast<T*>(ptrs[10]);
  a.part = static_cast<T*>(ptrs[11]);
  a.dot = static_cast<T*>(ptrs[12]);
  vec_kernel<T, kOp><<<grid, kVecThreads, 0, stream>>>(a, size_t(n));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dots_of(kOp) == 0) return e;
  fold_kernel<T><<<1, kFoldLanes, 0, stream>>>(a.part, grid, dots_of(kOp), a.dot);
  return cudaGetLastError();
}

// pass ``op``'s (template) function, by its number
template <typename T, template <typename, int> class F, typename... A>
int by_op(int op, A... args) {
  switch (op) {
    case kBicg1: return F<T, kBicg1>::run(args...);
    case kTriad: return F<T, kTriad>::run(args...);
    case kAxpy: return F<T, kAxpy>::run(args...);
    case kDot1: return F<T, kDot1>::run(args...);
    case kDot2: return F<T, kDot2>::run(args...);
    case kDotsT: return F<T, kDotsT>::run(args...);
    case kUpdateXr: return F<T, kUpdateXr>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int kOp>
struct GridOf {
  static int run(long long n, int device, int* grid) {
    return vec_grid_of<T, kOp>(n, device, grid);
  }
};

template <typename T, int kOp>
struct Launch {
  static int run(void* const* ptrs, long long n, int grid, cudaStream_t stream) {
    return vec_launch<T, kOp>(ptrs, n, grid, stream);
  }
};

template <typename T>
int vec_grid(int op, long long n, int device, int* grid) {
  if (n < 1 || grid == nullptr) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return by_op<T, GridOf>(op, n, device, grid);
}

template <typename T>
int vec_pass(int op, void* const* ptrs, long long n, int grid, int device, void* stream) {
  if (n < 1 || grid < 1 || ptrs == nullptr) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return by_op<T, Launch>(op, ptrs, n, grid, static_cast<cudaStream_t>(stream));
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

// The grid of pass ``op`` (cuda_kernels/blas.py's _PASSES) over n points:
// one wave of its CTAs, fewer for a small field.  The partial dots hold
// grid * dots values.
int cz_vec_grid_f32(int op, long long n, int device, int* grid) {
  return vec_grid<float>(op, n, device, grid);
}

int cz_vec_grid_f64(int op, long long n, int device, int* grid) {
  return vec_grid<double>(op, n, device, grid);
}

// Launch pass ``op`` over n points of contiguous fields of one type on
// ``device``, and, for a pass with dots, the fold of its partials.  ptrs:
// 6 read fields (nullptr past the pass's), msk, 2 scalars, 2 written
// fields, the partials and the dots.
int cz_vec_pass_f32(int op, void* const* ptrs, long long n, int grid, int device,
                    void* stream) {
  return vec_pass<float>(op, ptrs, n, grid, device, stream);
}

int cz_vec_pass_f64(int op, void* const* ptrs, long long n, int grid, int device,
                    void* stream) {
  return vec_pass<double>(op, ptrs, n, grid, device, stream);
}

}  // extern "C"
