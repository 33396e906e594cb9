// Packed red-black SOR sweeps for Hopper (sm_90a): the CUDA counterparts of
// the JAX package's colour-packed Pallas kernels.
//
// Layout (cubez_tpu_torch/cuda_kernels/rbpack.py::pack_rb): the (K, I, J)
// field folded along I into two dense colour halves, x[2][K][I/2][J], J
// contiguous, no padding.  Colour 0 ("red") holds the points with
// (i + j + k + offset + 1) % 2 == 0; packed row i2 of colour c at (k, j)
// holds physical row i = 2*i2 + s with s = (k + j + offset + 1 + c) & 1.
// K and J neighbours of a point are the other colour's same (k, i2, j)
// shifted by one row or lane; the I pair is other[i2] + other[i2 - 1 + 2s].
//
// Arithmetic contract (bitwise equal to the plain twin,
// cuda_kernels/rbpack.py::rb_color_plain):
//   ss  = ((o[k-1] + o[k+1]) + (o[i2] + o[i2-1+2s])) + (o[j-1] + o[j+1])
//   ss -= b                              (only with a right-hand side)
//   dp  = fma(ss, 1/6, -centre) * omega  (one rounding in the fma)
//   centre += dp
// Every operation is an explicit round-to-nearest intrinsic and the file is
// built with --fmad=false, so nothing else is contracted.
//
// rb_color_kernel replaces K1, cubez_tpu/pallas_kernels/rbpack.py:732
// (make_packed_sweep -> _packed_kernel); one launch updates one colour.
// rb_sweeps_kernel replaces K3, cubez_tpu/pallas_kernels/sweeps2x.py:480
// (build_nx -> _sweepnx_kernel), and K2, sweeps2x.py:552 (build_2x ->
// _sweep2x_kernel, the pair with an optional right-hand side): n full
// iterations in one cooperative launch.
//
// What bounds them on an H100: at 128^3 float32 the packed field is 8.4 MB
// and stays in the 50 MB L2, so bytes do not bound a colour pass: launch
// latency, grid-wide synchronisation and per-point instructions do
// (measured on an H100 80GB HBM3 at 700 W: ~10 us per colour pass, and
// float64 costs only 3% more).  At 512^3 (537 MB) every colour pass
// streams the field from HBM: one read of the other colour, one read and
// one write of the centre colour, ~1.6 GB per iteration (measured: 1.17 ms
// per iteration, 41% of the 3.35 TB/s peak, with ~37% of the time not
// scaling with bytes, most likely the per-point index div/mod).  The
// design answers launch latency with one persistent launch per n
// iterations (two grid syncs per iteration in place of two launches).  It
// does not yet answer the bytes: it makes one device-memory pass per
// colour.  Keeping the n lagged windows on chip, as the TPU kernel's VMEM
// chain does, is later work.
//
// Residuals: each block reduces its sum of dp^2 in a fixed order (warp
// shuffles, then one warp) into partials[block], in float for float fields
// and double for double fields.  No atomics, so histories repeat bitwise
// from run to run.  The host folds rb_color's partials in float64; the
// persistent kernel folds its own in block 0 after the last grid sync.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T> struct Acc;
template <> struct Acc<float> { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// Sum over the block in a fixed order; the result is valid in thread 0.
// Every thread of the block must call it.
template <typename A>
__device__ A block_sum(A v) {
  __shared__ A warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  A tot = 0;
  if (warp == 0) {
    tot = lane < kThreads / 32 ? warp_sums[lane] : A(0);
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_down_sync(0xffffffffu, tot, o);
  }
  __syncthreads();  // warp_sums is reused by the next call
  return tot;
}

// Update interior point ``idx`` of colour ``colour`` in place and return its
// dp (0 for the I-boundary rows, which are not updated).  ``idx`` runs over
// k in [1, K-2], i2 in [0, I2), j in [1, J-2], j fastest.
template <typename T>
__device__ __forceinline__ T update_point(
    T* __restrict__ c, const T* __restrict__ o, const T* __restrict__ b,
    unsigned idx, unsigned I2, unsigned J, int colour, int offset, T omega) {
  const unsigned jm = J - 2;
  const unsigned j = 1 + idx % jm;
  const unsigned r = idx / jm;
  const unsigned i2 = r % I2;
  const unsigned k = 1 + r / I2;
  const unsigned s = (k + j + unsigned(offset) + 1u + unsigned(colour)) & 1u;
  // physical i = 2*i2 + s must lie in [1, I-2]
  if ((i2 == 0 && s == 0) || (i2 + 1 == I2 && s == 1)) return T(0);
  const size_t row = size_t(I2) * J;  // one k step
  const size_t p = (size_t(k) * I2 + i2) * J + j;
  const T ssk = add_rn(o[p - row], o[p + row]);
  const T ssi = add_rn(o[p], o[s ? p + J : p - J]);
  const T ssj = add_rn(o[p - 1], o[p + 1]);
  T ss = add_rn(add_rn(ssk, ssi), ssj);
  if (b != nullptr) ss = sub_rn(ss, b[p]);
  const T cen = c[p];
  const T dp = mul_rn(fma_rn(ss, T(1.0 / 6.0), -cen), omega);
  c[p] = add_rn(cen, dp);
  return dp;
}

// One colour of one red-black iteration: one thread per interior point.
template <typename T>
__global__ void __launch_bounds__(kThreads) rb_color_kernel(
    T* x, const T* b, typename Acc<T>::type* partials, int K, int I2, int J,
    int colour, int offset, T omega, unsigned n_cells) {
  using A = typename Acc<T>::type;
  const size_t plane = size_t(K) * I2 * J;
  T* c = x + colour * plane;
  const T* o = x + (1 - colour) * plane;
  const T* bc = b != nullptr ? b + colour * plane : nullptr;
  const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
  A acc = 0;
  if (idx < n_cells) {
    const A dp = update_point(c, o, bc, idx, I2, J, colour, offset, omega);
    acc = dp * dp;
  }
  const A tot = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// n full iterations in one cooperative launch: a grid-stride loop per
// colour, a grid-wide sync between colours.  partials is (n, 2, gridDim.x);
// r2 receives the n per-iteration sums in float64.
template <typename T>
__global__ void __launch_bounds__(kThreads) rb_sweeps_kernel(
    T* x, const T* b, typename Acc<T>::type* partials, double* r2, int K,
    int I2, int J, int n, int offset, T omega, unsigned n_cells) {
  using A = typename Acc<T>::type;
  cg::grid_group grid = cg::this_grid();
  const size_t plane = size_t(K) * I2 * J;
  const unsigned nb = gridDim.x;
  const unsigned stride = nb * kThreads;
  for (int it = 0; it < n; ++it) {
    for (int colour = 0; colour < 2; ++colour) {
      T* c = x + colour * plane;
      const T* o = x + (1 - colour) * plane;
      const T* bc = b != nullptr ? b + colour * plane : nullptr;
      A acc = 0;
      for (unsigned idx = blockIdx.x * kThreads + threadIdx.x; idx < n_cells;
           idx += stride) {
        const A dp = update_point(c, o, bc, idx, I2, J, colour, offset, omega);
        acc += dp * dp;
      }
      const A tot = block_sum(acc);
      if (threadIdx.x == 0) partials[(size_t(it) * 2 + colour) * nb + blockIdx.x] = tot;
      grid.sync();
    }
  }
  if (blockIdx.x == 0) {
    for (int it = 0; it < n; ++it) {
      double s = 0;
      for (unsigned q = threadIdx.x; q < 2 * nb; q += kThreads)
        s += double(partials[size_t(it) * 2 * nb + q]);
      s = block_sum(s);
      if (threadIdx.x == 0) r2[it] = s;
    }
  }
}

template <typename T>
int launch_color(void* x, const void* b, void* partials, int K, int I2, int J,
                 int colour, int offset, double omega, unsigned n_cells,
                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const unsigned nblocks = (n_cells + kThreads - 1) / kThreads;
  rb_color_kernel<T><<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<const T*>(b),
      static_cast<typename Acc<T>::type*>(partials), K, I2, J, colour, offset,
      T(omega), n_cells);
  return cudaGetLastError();
}

template <typename T>
int max_coresident_blocks(int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rb_sweeps_kernel<T>,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch_sweeps(void* x, const void* b, void* partials, void* r2, int K,
                  int I2, int J, int n, int offset, double omega,
                  unsigned n_cells, int nblocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  T* xp = static_cast<T*>(x);
  const T* bp = static_cast<const T*>(b);
  auto* pp = static_cast<typename Acc<T>::type*>(partials);
  double* rp = static_cast<double*>(r2);
  T om = T(omega);
  void* args[] = {&xp, &bp, &pp, &rp, &K, &I2, &J, &n, &offset, &om, &n_cells};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rb_sweeps_kernel<T>),
                                  dim3(nblocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_threads_per_block() { return kThreads; }

const char* cz_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int cz_rb_color_f32(void* x, const void* b, void* partials, int K, int I2,
                    int J, int colour, int offset, double omega,
                    unsigned n_cells, int device, void* stream) {
  return launch_color<float>(x, b, partials, K, I2, J, colour, offset, omega,
                             n_cells, device, stream);
}

int cz_rb_color_f64(void* x, const void* b, void* partials, int K, int I2,
                    int J, int colour, int offset, double omega,
                    unsigned n_cells, int device, void* stream) {
  return launch_color<double>(x, b, partials, K, I2, J, colour, offset, omega,
                              n_cells, device, stream);
}

int cz_rb_sweeps_max_blocks_f32(int device, int* out) {
  return max_coresident_blocks<float>(device, out);
}

int cz_rb_sweeps_max_blocks_f64(int device, int* out) {
  return max_coresident_blocks<double>(device, out);
}

int cz_rb_sweeps_n_f32(void* x, const void* b, void* partials, void* r2,
                       int K, int I2, int J, int n, int offset, double omega,
                       unsigned n_cells, int nblocks, int device,
                       void* stream) {
  return launch_sweeps<float>(x, b, partials, r2, K, I2, J, n, offset, omega,
                              n_cells, nblocks, device, stream);
}

int cz_rb_sweeps_n_f64(void* x, const void* b, void* partials, void* r2,
                       int K, int I2, int J, int n, int offset, double omega,
                       unsigned n_cells, int nblocks, int device,
                       void* stream) {
  return launch_sweeps<double>(x, b, partials, r2, K, I2, J, n, offset, omega,
                               n_cells, nblocks, device, stream);
}

}  // extern "C"
