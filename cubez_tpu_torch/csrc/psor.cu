// n lexicographic point-SOR sweeps in one launch for Hopper (sm_90a),
// kernel P1.  It takes the place of the JAX package's diagonal-wavefront
// psor step, cubez_tpu/ops/psor_scan.py:82 (make_psor_diag_step), which
// XLA runs as a fori_loop over the diagonals with an associative scan a
// diagonal: no pallas_call computes it.
//
// The reference's psor (cz_solver.f90:207-269; psor_maf, cz_maf.f90:23-114)
// is serial Gauss-Seidel in (j, i, k) order.  The field is in the skewed
// layout S[d, k, i] = X[k, i, d - i] (cuda_kernels/psor.py, ops/psor_scan.py
// make_skew): line (i, j = d - i) reads lines (i - 1, j) and (i, j - 1) of
// diagonal d - 1, new, and (i + 1, j) and (i, j + 1) of diagonal d + 1,
// old.  Each point takes the reference's update, operation for operation
// as ops/stencil.py::jacobi_delta and ops/maf.py::maf_delta order it, one
// round-to-nearest intrinsic each (built with --fmad=false), so a sweep is
// bitwise the serial one and the plain twin's
// (ops/psor_scan.py::psor_diag_plain):
//   constant: ss = ((((x[i-1] + x[i+1]) + x[j-1]) + x[j+1]) + x[k-1]) + x[k+1],
//     dp = ((ss - b) / 6 - x) * omega;
//   MAF: rp = (((((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym x[j-1])
//     + wzp x[k+1]) + wzm x[k-1]) + b, dd = 2 ((c1 + c2) + c3),
//     dp = (rp / dd - x) * omega;
//   x += dp; the residual is the float64 sum of dp^2.
//
// Tasks: each line's inner rows split into C chunks of L rows
// (cuda_kernels/psor.py::plan); task (s, d, c) relaxes chunk c of every
// line of diagonal d in sweep s of the launch's n, walking its rows upward
// with the new x(k - 1) in a register.  Its inputs, the tasks that write
// what it reads:
//   (s, d - 1, c)      the upstream lines' rows, new;
//   (s, d, c - 1)      its lines' x(k0 - 1), new;
//   (s - 1, d + 1, c)  the downstream lines' rows, sweep s - 1's;
//   (s - 1, d, c + 1)  its lines' x(k1 + 1), sweep s - 1's
// ((s - 1, d, c), its own old rows, comes before (s - 1, d + 1, c); on the
// last diagonal it is an input itself).  The state is updated in place,
// so a task must also not overwrite a value before its readers have read
// it.  The values (s, d, c) overwrites, sweep s - 1's of chunk c of
// diagonal d, are read by (s - 1, d + 1, c), (s - 1, d, c + 1) (new
// values there), (s, d - 1, c) and (s, d, c - 1) (old values there) and
// (s, d, c) itself: exactly its inputs.  So running every task after its
// inputs orders the writes after the reads too, and each point sees the
// values of the serial order: n launches of one sweep, bit for bit.
//
// The schedule: a CTA (or, past 1024 lines, each of U CTAs) holds one
// chunk c of one sweep s and walks the diagonals; after each it adds one
// to the counter of (s, c) (progress.cuh).  Before diagonal d its thread
// 0 waits for the counters of (s, c - 1), (s - 1, c) and (s - 1, c + 1)
// to show its inputs done (and, U > 1, its own chunk's d - 1): a task
// waits for its four inputs only, no grid-wide barrier.  A chunk's U CTAs
// keep within one diagonal of each other (each waits for its own chunk's
// last one), so a count of U (d - 1) means every CTA of the chunk has
// done diagonal d.  The counters are zeroed after the launch's last
// grid-wide sync, ready for the next.  cuda_kernels/psor.py states the
// inputs and the waits in Python (``inputs``, ``flag_waits``), and the
// CPU tests replay the CTAs in random orders the counters allow on the
// plain update.  The longest chain of waits is I + J - 5 + C - 1
// + 2 (n - 1) tasks of L dependent updates, against n (I + J - 5 + C - 1)
// for n launches of one sweep (128^3, L = 4, n = 32: 344 against 9024),
// on n times the CTAs.  (A grid-wide barrier between the chain's steps in
// place of the counters measured slower at every height and n, PERF.md
// section 6.)
//
// Each sweep's CTAs are its own: each thread sums its dp^2 in float64,
// each CTA folds its threads' sums in order, and after the last grid-wide
// sync the first CTA folds each sweep's CTA partials in order into r2[s]
// on the card.  No atomics in the sums: r2 is the same from run to run.
//
// What bounds it on an H100: a launch reads S and B and writes S once,
// 3 fields whatever its n (7.5 us at 128^3 float32 at 3.35 TB/s, 0.23 us
// a sweep at n = 32), and a sweep does 12 operations a point (MAF 21;
// 0.36 us at 128^3 at 67 TFLOP/s).  What bounds it more is the dependent chain: a step is L point updates
// in a row (an add, a subtraction, a division, a subtraction, a multiply
// and an add each), their loads through L2, and a synchronisation, and a
// launch of n sweeps is I + J + C - 6 + 2 (n - 1) steps.  The design keeps
// n sweeps' tasks in flight at once, and each thread keeps the inputs of
// its next kAhead rows in flight while it works on the current one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"
#include "progress.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cz;

constexpr int kPsorThreads = 1024;

template <typename T>
struct PsorArgs {
  T* s;                       // S[d, k, i], updated in place
  const T* __restrict__ b;    // B, the same layout
  const T* __restrict__ tab;  // the MAF weights (maf_tables), or nullptr
  double* partials;           // a float64 sum of dp^2 a CTA
  double* r2;                 // their fold, one a sweep
  unsigned* prog;             // a counter a (sweep, chunk), zero at launch
  T omega;
  int K, I, J;
  int lanes;      // threads of a chunk: the longest diagonal's lines, to 32
  int chunks;     // C, chunks of a line
  int rows;       // L, rows of a chunk
  int sweeps;     // n, sweeps of the launch
  int per_sweep;  // CTAs of a sweep
  int units;      // U, CTAs of a chunk (lanes / blockDim.x)
};

// The inputs of one point other than x(k - 1): x[i-1], x[i+1], x[j-1],
// x[j+1] (diagonals d - 1 and d + 1), the old x(k + 1) and b.
enum { kXm, kXp, kYm, kYp, kZp, kB, kIn };

// Rows whose inputs a thread keeps in flight in registers (a CTA of 1024
// threads has 64 a thread).
template <typename T>
constexpr int kAhead = sizeof(T) == 4 ? 4 : 2;

// Rows k0 ... k1 of line (i, d - i), upward.  S's values are read through
// L2 (other threads, of other CTAs too, wrote them before the counters
// the task waited for).  Returns the float64 sum of dp^2.
template <typename T, bool kMaf>
__device__ double relax_rows(const PsorArgs<T>& a, int d, int i, int k0, int k1) {
  const int K = a.K, I = a.I, J = a.J;
  const int j = d - i;
  const size_t slab = size_t(K) * I;  // one diagonal
  T* sc = a.s + size_t(d) * slab + i + size_t(k0) * I;  // this line at k0
  const T* sm = sc - slab;  // diagonal d - 1 at i: (i, j - 1); at i - 1: (i - 1, j)
  const T* sp = sc + slab;  // diagonal d + 1 at i: (i, j + 1); at i + 1: (i + 1, j)
  const T* bb = a.b + size_t(d) * slab + i + size_t(k0) * I;
  const MafTables<T> w(a.tab, K, I, J);  // read only under kMaf
  T wxp = 0, wxm = 0, wyp = 0, wym = 0, c12 = 0;
  if constexpr (kMaf) {
    wxp = __ldg(w.wxp + i);
    wxm = __ldg(w.wxm + i);
    wyp = __ldg(w.wyp + j);
    wym = __ldg(w.wym + j);
    c12 = add_rn(__ldg(w.c1 + i), __ldg(w.c2 + j));
  }
  auto load = [&](T(&v)[kIn], size_t p) {  // row k0 + p / I
    v[kXm] = __ldcg(sm + p - 1);
    v[kXp] = __ldcg(sp + p + 1);
    v[kYm] = __ldcg(sm + p);
    v[kYp] = __ldcg(sp + p);
    v[kZp] = __ldcg(sc + p + I);
    v[kB] = __ldg(bb + p);
  };
  T zm = __ldcg(sc - I);  // x(k0 - 1), new (the chunk below, or the Dirichlet value)
  T cen = __ldcg(sc);     // x(k0), old
  // rows k ... k + kAhead - 1 in flight: row k's inputs in buf[(k - k0) % kAhead]
  constexpr int A = kAhead<T>;
  T buf[A][kIn];
#pragma unroll
  for (int u = 0; u < A; ++u)
    if (k0 + u <= k1) load(buf[u], size_t(u) * I);
  double acc = 0;
  size_t p = 0;
  for (int kk = k0; kk <= k1; kk += A) {
#pragma unroll
    for (int u = 0; u < A; ++u) {
      const int k = kk + u;
      if (k > k1) break;
      T v[kIn];
#pragma unroll
      for (int q = 0; q < kIn; ++q) v[q] = buf[u][q];
      if (k + A <= k1) load(buf[u], p + size_t(A) * I);  // row k + A goes out first
      T quo;
      if constexpr (kMaf) {
        T r = add_rn(mul_rn(wxp, v[kXp]), mul_rn(wxm, v[kXm]));
        r = add_rn(r, mul_rn(wyp, v[kYp]));
        r = add_rn(r, mul_rn(wym, v[kYm]));
        r = add_rn(r, mul_rn(__ldg(w.wzp + k), v[kZp]));
        r = add_rn(r, mul_rn(__ldg(w.wzm + k), zm));
        r = add_rn(r, v[kB]);
        const T dd = mul_rn(T(2), add_rn(c12, __ldg(w.c3 + k)));
        quo = div_rn(r, dd);
      } else {
        T ss = add_rn(add_rn(add_rn(v[kXm], v[kXp]), v[kYm]), v[kYp]);
        ss = add_rn(add_rn(ss, zm), v[kZp]);
        quo = div_rn(sub_rn(ss, v[kB]), T(6));
      }
      const T dp = mul_rn(sub_rn(quo, cen), a.omega);
      const T x = add_rn(cen, dp);
      sc[p] = x;
      acc += double(mul_rn(dp, dp));
      zm = x;
      cen = v[kZp];
      p += I;
    }
  }
  return acc;
}

// Thread 0 of a CTA: wait until the inputs of task (s, d, c)
// are done (a chunk's counter reads U (d' - 1) once its diagonal d' is).
template <typename T>
__device__ void wait_inputs(const PsorArgs<T>& a, int s, int c, int d) {
  const unsigned U = a.units;
  const unsigned* p = a.prog + size_t(s) * a.chunks + c;
  const int d_last = a.I + a.J - 4;
  if (U > 1 && d > 2) wait_at_least(p, U * (d - 2));       // (s, d - 1, c)
  if (c > 0) wait_at_least(p - 1, U * (d - 1));            // (s, d, c - 1)
  if (s > 0) {
    const unsigned* q = p - a.chunks;
    wait_at_least(q, U * (min(d + 1, d_last) - 1));        // (s - 1, d + 1, c)
    if (c + 1 < a.chunks) wait_at_least(q + 1, U * (d - 1));  // (s - 1, d, c + 1)
  }
}

template <typename T, bool kMaf>
__global__ void __launch_bounds__(kPsorThreads, 1) psor_sweep_kernel(
    const __grid_constant__ PsorArgs<T> a) {
  const int I = a.I, J = a.J, n = a.K - 2, d_last = I + J - 4;
  // this CTA's sweep, this thread's chunk c and its line's place on the
  // diagonal
  const int s = blockIdx.x / a.per_sweep;
  const int g = (blockIdx.x - s * a.per_sweep) * blockDim.x + threadIdx.x;
  const int c = g / a.lanes, slot = g - c * a.lanes;
  const int k0 = 1 + c * a.rows, k1 = min(n, k0 + a.rows - 1);
  double acc = 0;
  for (int d = 2; d <= d_last; ++d) {
    if (threadIdx.x == 0) wait_inputs(a, s, c, d);
    __syncthreads();
    const int i = max(1, d - (J - 2)) + slot;
    if (i <= min(I - 2, d - 1)) acc += relax_rows<T, kMaf>(a, d, i, k0, k1);
    __syncthreads();
    if (threadIdx.x == 0) release_add(a.prog + size_t(s) * a.chunks + c);
  }
  const double tot = block_sum_any(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = tot;
  cg::this_grid().sync();
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < a.sweeps; q += blockDim.x) {
      double r = 0;
      for (int p = 0; p < a.per_sweep; ++p) r += a.partials[q * a.per_sweep + p];
      a.r2[q] = r;
    }
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < a.sweeps * a.chunks;
       q += gridDim.x * blockDim.x)
    a.prog[q] = 0;  // every wait of the launch is over
}

template <typename T>
const void* sweep_kernel(bool maf) {
  return maf ? reinterpret_cast<const void*>(psor_sweep_kernel<T, true>)
             : reinterpret_cast<const void*>(psor_sweep_kernel<T, false>);
}

// ptrs: s, b, tab, partials, r2, prog.  iargs: K, I, J, maf, grid, device,
// lanes, chunks, rows, sweeps, per_sweep, units, threads.  The wrapper
// builds both arrays once for a set of fields.
template <typename T>
int launch(void* const* ptrs, const int* iargs, double omega, void* stream) {
  cudaError_t e = cudaSetDevice(iargs[5]);
  if (e != cudaSuccess) return e;
  PsorArgs<T> a;
  a.s = static_cast<T*>(ptrs[0]);
  a.b = static_cast<const T*>(ptrs[1]);
  a.tab = static_cast<const T*>(ptrs[2]);
  a.partials = static_cast<double*>(ptrs[3]);
  a.r2 = static_cast<double*>(ptrs[4]);
  a.prog = static_cast<unsigned*>(ptrs[5]);
  a.omega = T(omega);
  a.K = iargs[0];
  a.I = iargs[1];
  a.J = iargs[2];
  const int maf = iargs[3], grid = iargs[4];
  a.lanes = iargs[6];
  a.chunks = iargs[7];
  a.rows = iargs[8];
  a.sweeps = iargs[9];
  a.per_sweep = iargs[10];
  a.units = iargs[11];
  const int threads = iargs[12];
  const int lines = a.I - 2 < a.J - 2 ? a.I - 2 : a.J - 2;
  if (grid < 1 || a.K < 3 || a.I < 3 || a.J < 3 || (maf != 0) != (a.tab != nullptr) ||
      a.b == nullptr || a.lanes < lines || a.chunks < 1 || a.rows < 1 ||
      a.chunks * a.rows < a.K - 2 || a.sweeps < 1 || a.per_sweep < 1 ||
      size_t(grid) != size_t(a.sweeps) * a.per_sweep || threads < 32 ||
      threads > kPsorThreads || threads % 32 != 0 ||
      a.prog == nullptr || a.units < 1 || a.lanes != a.units * threads ||
      a.per_sweep != a.chunks * a.units)
    return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(sweep_kernel<T>(maf != 0), dim3(grid),
                                  dim3(threads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cz_psor_threads_per_block(void) { return kPsorThreads; }

int cz_psor_sweep_f32(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<float>(ptrs, iargs, omega, stream);
}

int cz_psor_sweep_f64(void* const* ptrs, const int* iargs, double omega, void* stream) {
  return launch<double>(ptrs, iargs, omega, stream);
}

}  // extern "C"
