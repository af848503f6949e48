// K6: the sharded kinematic-wave sweep as one CUDA kernel for Hopper (sm_90a).
//
// Replaces lisflood_tpu/ops/kinwave_sharded.py:_sweep_sharded (:164), an XLA
// lax.scan (:191), not Pallas: one kinematic-wave time step over a sharded
// schedule (ops/kinwave_sharded.py:build_sharded_schedule). Every position's
// discharge, on each of L lanes, is the Newton solution of
//   Q + adx * Q^beta = const + upstream inflow,
// the inflow being the sum of its sources' discharges. The schedule puts S
// shards side by side, position pos = s * n_chunks * C + c * C + l, and closes
// its chunks in global lockstep, so every source of a position in chunk c, in
// its own shard or across a cut edge, lies in an earlier chunk. The plain
// PyTorch version of the same function is
// lisflood_tpu_torch/ops/kinwave_sharded.py:_sweep_sharded.
//
// Design: one block walks the chunks in order. Its threads take the chunk's
// S * C positions (looping where S * C exceeds the block), each position all L
// lanes: a thread gathers its <= 8 sources' q from global memory in the order
// of the upstream table `ups` (ascending natural pixel index of the source, so
// the same for every shard count; the plain version adds them in that order),
// adds const, solves, and stores q. A __syncthreads() separates two
// chunks; it makes the block's global writes of a chunk visible to the block's
// reads in the next. No flags, no atomics: the outputs have the same bits in
// every run, and equal the plain version's.
//
// What bounds it. The function reads const and adx once and writes q once,
// with its graph (one int32 window offset per position and the cut tables): on
// the 1200x1000 catchment of models/synthetic.write_catchment that is tens of
// MB, some 0.01-0.03 ms at 3.35 TB/s, and its operations less. The kernel runs
// at the latency of its chain instead: n_chunks dependent chunk steps, each a
// load of the sources' indices, a gather of their q, a Newton solve in series
// and a barrier, about 1-2 us, so n_chunks times that in all. Keeping the last
// W chunks in shared memory, one block per shard meeting over flags, and the
// split of shards over ranks are left for later work.
//
// Arithmetic: -fmad=false, and the Newton solves of kinwave_common.cuh, as
// ops/kinwave_packed.newton_solve: the float32 v-space polynomial at beta =
// 3/5, otherwise the q-space unrolled iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // threads of the one block
constexpr int kMaxUps = 8;         // LDD: at most 8 upstream neighbours

}  // namespace

// Field order and types must match _ShardedArgs in ops/kinwave_sharded.py.
struct ShardedArgs {
  // chunks, shards (S), lanes per shard and chunk (C), rows of a position
  // (L), rows of the upstream table (K), threads of the block
  int n_chunks, shards, chunk, lanes, K, threads;
  double beta;
  // (L, p_pad) operands and the output q, p_pad = S * n_chunks * C
  const void *cst, *adx;
  void* q;
  // (K, p_pad) source positions of every position, -1 = none
  // (ops/kinwave_sharded.py:upstream_positions)
  const int* ups;
};

namespace {

template <typename T, bool POLY>
__device__ __forceinline__ T solve(T cc, T adx, T beta, T inv_beta, T b_minus_1) {
  if constexpr (POLY) {
    const bool small = cc <= T(1e-12);
    const T v = newton_v(small ? T(1) : cc, adx);
    const T v3 = v * v * v;
    return small ? T(0) : v3 * v * v;
  } else {
    return newton_q(cc, adx, beta, inv_beta, b_minus_1);
  }
}

// KU: the table's rows rounded up to 4 or 8, so that a position's sources
// are loaded into registers by an unrolled loop
template <typename T, bool POLY, int KU>
__global__ void __launch_bounds__(kMaxThreads) sharded_kernel(const __grid_constant__ ShardedArgs a) {
  const int C = a.chunk, SC = a.shards * a.chunk, L = a.lanes, K = a.K;
  const int B = a.n_chunks * C;        // positions of one shard
  const int64_t p_pad = static_cast<int64_t>(a.shards) * B;
  const T beta = T(a.beta), inv_beta = T(1.0 / a.beta), b_minus_1 = T(a.beta - 1.0);
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  for (int c = 0; c < a.n_chunks; ++c) {
    for (int i = threadIdx.x; i < SC; i += blockDim.x) {
      const int pos = (i / C) * B + c * C + i % C;
      int src[KU];
#pragma unroll
      for (int k = 0; k < KU; ++k) src[k] = k < K ? a.ups[k * p_pad + pos] : -1;
      for (int j = 0; j < L; ++j) {
        const int64_t row = j * p_pad;
        // the sources' q in table order, then const, as the plain version adds
        T inflow = T(0);
#pragma unroll
        for (int k = 0; k < KU; ++k)
          if (src[k] >= 0) inflow = inflow + q[row + src[k]];
        q[row + pos] =
            solve<T, POLY>(inflow + cst[row + pos], adx[row + pos], beta, inv_beta, b_minus_1);
      }
    }
    __syncthreads();
  }
}

typedef void (*ShardedKernel)(const ShardedArgs);

template <int KU>
ShardedKernel pick_kernel_ku(int is_double, int poly) {
  if (is_double) return sharded_kernel<double, false, KU>;
  return poly ? sharded_kernel<float, true, KU> : sharded_kernel<float, false, KU>;
}

ShardedKernel pick_kernel(int is_double, int poly, int K) {
  return K <= 4 ? pick_kernel_ku<4>(is_double, poly) : pick_kernel_ku<kMaxUps>(is_double, poly);
}

bool bad_shape(const ShardedArgs& a) {
  return a.n_chunks < 1 || a.shards < 1 || a.chunk < 1 || a.lanes < 1 || a.K < 1 ||
         a.K > kMaxUps || a.threads < 32 || a.threads > kMaxThreads || a.threads % 32 != 0 ||
         static_cast<int64_t>(a.shards) * a.n_chunks * a.chunk * a.lanes >= (1ll << 31);
}

}  // namespace

extern "C" {

// Launches the sweep, one block of args->threads, on `stream`; is_double
// selects the element type, poly the float32 beta = 3/5 polynomial solve.
// Returns a cudaError_t (0 on success).
int kinwave_sharded_launch(const ShardedArgs* args, int is_double, int poly, void* stream) {
  const ShardedArgs a = *args;
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  pick_kernel(is_double, poly, a.K)<<<1, a.threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kinwave_sharded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
