// The overland kinematic-wave sweep as one CUDA kernel for Hopper (sm_90a).
//
// Replaces lisflood_tpu/ops/kinwave_packed.py:_sweep, an XLA lax.scan (not
// Pallas): one kinematic-wave time step over a packed schedule. For each
// chunk c in order, every lane's discharge is the Newton solution of
//   Q + adx * Q^beta = const + upstream inflow,
// and the discharge then flows on to its downstream position, at most W chunks
// later. L lanes (the three overland runoff lanes Other, Forest, Direct) share
// the schedule, each with its own const and adx. The plain PyTorch version of
// the same function is lisflood_tpu_torch/ops/kinwave_packed.py:_sweep.
//
// Design: the sub-step kernel's wavefront protocol (kinwave_substep.cu has
// the full note), with one task per chunk. G persistent blocks of L*C threads (one thread per
// lane and schedule position) claim chunks in increasing order from a ticket
// counter. Before it reads, a block waits for the chunks its chunk gathers from
// (a host-built list `deps` per chunk, ops/wavefront.py:wavefront_tables, all
// in c-W..c-1): one thread per dependency polls its progress flag with
// ld.acquire.gpu, then a barrier. After its stores, a barrier, then one thread
// publishes the chunk's flag with st.release.gpu. A poll that sees no progress
// for 5 s traps instead of hanging the card. No deadlock: every dependence
// points to a lower chunk and tickets go out in order, so the lowest unfinished
// chunk is held by a running block whose dependencies are finished.
//
// Upstream inflow is a gather in a fixed order: every position sums the
// discharges of its source positions (at most 8 in an LDD graph) in ascending
// order, from the host-built table `ups` (ops/wavefront.py:upstream_table). The
// discharges are read from the output array itself, which every chunk writes
// once, so no ring or reuse guard is needed. No sum is atomic (the ticket
// counter is the kernel's one atomic): the outputs have the same bits for
// every block count and in every run.
//
// What bounds it. One launch reads const, adx and the tables once and writes
// q once (about 60 MB at the continental size in float32) and does some 80
// operations per lane and position: a few hundredths of a millisecond on the
// card. The kernel is bound instead by the critical path of the chunk graph,
// (longest chain of dependent chunks) x (one task: the gathers, one Newton
// solve, two barriers and a flag hop through L2), and by the tasks' throughput
// over G blocks where the chunks of one depth are many.
//
// Arithmetic: -fmad=false, and the Newton solves of kinwave_common.cuh, as
// ops/kinwave_packed.newton_solve: the float32 v-space polynomial at beta =
// 3/5, otherwise the q-space unrolled iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // L * C threads per block
constexpr int kMaxUps = 8;         // LDD: at most 8 upstream neighbours

}  // namespace

// Field order and types must match _SweepArgs in ops/kinwave_packed.py.
struct SweepArgs {
  // chunks, lanes per chunk (C), overland lanes (L), rows of `ups` (K),
  // entries per chunk in `deps` (D), blocks launched (G)
  int n_chunks, chunk, lanes, K, D, blocks;
  double beta;
  // (n_chunks, L, C) operands and the output q
  const void *cst, *adx;
  void* q;
  // (K, n_chunks*C) upstream source positions, ascending, -1 = none;
  // (n_chunks, D) chunks gathered from, -1 padded
  const int *ups, *deps;
  // progress[n_chunks] and the ticket counter after it (zeroed by the caller)
  int* ctrl;
};

namespace {

template <typename T, bool POLY>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(const __grid_constant__ SweepArgs a) {
  const int C = a.chunk, L = a.lanes, D = a.D;
  const int tid = threadIdx.x, nthreads = L * C;
  const int j = tid / C, l = tid % C;
  const int64_t p_pad = static_cast<int64_t>(a.n_chunks) * C;
  const T beta = T(a.beta), inv_beta = T(1.0 / a.beta), b_minus_1 = T(a.beta - 1.0);
  const T tol = T(1e-12);
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx_p = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  int* progress = a.ctrl;
  int* ticket = a.ctrl + a.n_chunks;
  __shared__ int claimed;

  for (;;) {
    // the barriers of the chunk's body separate this write from the reads
    if (tid == 0) claimed = atomicAdd(ticket, 1);
    __syncthreads();
    const int c = claimed;
    if (c >= a.n_chunks) break;
    const int64_t pos = static_cast<int64_t>(c) * C + l;
    const int64_t at = (static_cast<int64_t>(c) * L + j) * C + l;
    const T con = cst[at], adx = adx_p[at];
    // each source's entry in q: (chunk * L + j) * C + lane
    int64_t src[kMaxUps];
#pragma unroll
    for (int k = 0; k < kMaxUps; ++k) {
      const int sp = k < a.K ? a.ups[k * p_pad + pos] : -1;
      src[k] = sp < 0 ? -1 : (static_cast<int64_t>(sp / C) * L + j) * C + sp % C;
    }
    const int* deps = a.deps + static_cast<int64_t>(c) * D;
    for (int i = tid; i < D; i += nthreads)
      if (deps[i] >= 0) wait_for(progress + deps[i], 1);
    __syncthreads();
    T inflow = T(0);
#pragma unroll
    for (int k = 0; k < kMaxUps; ++k)
      if (src[k] >= 0) inflow = inflow + __ldcg(q + src[k]);
    const T cc = inflow + con;
    T out;
    if constexpr (POLY) {
      const bool small = cc <= tol;
      const T v = newton_v(small ? T(1) : cc, adx);
      const T v3 = v * v * v;
      out = small ? T(0) : v3 * v * v;
    } else {
      out = newton_q(cc, adx, beta, inv_beta, b_minus_1);
    }
    __stcg(q + at, out);
    // every thread's store before the flag: barrier, then one release store
    __syncthreads();
    if (tid == 0) st_release(progress + c, 1);
  }
}

typedef void (*SweepKernel)(const SweepArgs);

SweepKernel pick_kernel(int is_double, int poly) {
  if (is_double) return sweep_kernel<double, false>;
  return poly ? sweep_kernel<float, true> : sweep_kernel<float, false>;
}

cudaError_t co_resident(const SweepArgs& a, SweepKernel kernel, int* limit) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, a.lanes * a.chunk, 0);
  *limit = sms * per_sm;
  return rc;
}

bool bad_shape(const SweepArgs& a) {
  return a.chunk < 1 || a.lanes < 1 || a.lanes * a.chunk > kMaxThreads || a.K < 1 ||
         a.K > kMaxUps || a.D < 1 || a.n_chunks < 1;
}

}  // namespace

extern "C" {

// The blocks a launch gets by the kernel's rule, min(co-resident blocks,
// n_chunks), in *blocks, and the co-resident limit in *limit. Returns a
// cudaError_t: cudaErrorLaunchOutOfResources when not one block can be
// resident.
int kinwave_sweep_plan(const SweepArgs* args, int is_double, int poly, int* blocks, int* limit) {
  const SweepArgs& a = *args;
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = co_resident(a, pick_kernel(is_double, poly), limit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (*limit < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  *blocks = *limit < a.n_chunks ? *limit : a.n_chunks;
  return 0;
}

// Launches the sweep with args->blocks blocks of L*C threads on `stream`;
// is_double selects the element type, poly the float32 beta = 3/5 polynomial
// solve. Refuses a block count above the co-resident limit. Returns a
// cudaError_t (0 on success).
int kinwave_sweep_launch(const SweepArgs* args, int is_double, int poly, void* stream) {
  const SweepArgs a = *args;
  if (bad_shape(a) || a.blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SweepKernel kernel = pick_kernel(is_double, poly);
  int limit = 0;
  const cudaError_t rc = co_resident(a, kernel, &limit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (a.blocks > limit) return static_cast<int>(cudaErrorLaunchOutOfResources);
  kernel<<<a.blocks, a.lanes * a.chunk, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kinwave_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
