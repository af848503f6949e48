// Device helpers of the two tree-tiled sweeps, kinwave_sweep.cu (the overland
// sweep over the packed schedule) and kinwave_sharded.cu (the sweep over the
// sharded schedule): asynchronous copies into shared memory, the Newton solve
// of one position, the (lane, entry) pairs of a level, the inflow of an entry
// summed in slot order, and a block's trace record.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_common.cuh"

namespace {

// a traced block's record: its SM, the global nanosecond clock at its start and
// end, and its SM's cycles from the start to the end of staging and to its end
constexpr int kTraceWords = 5;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// one 4- or 8-byte element
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

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

// pair i of a level of cnt entries from lo: lane j, entry e (i = j * cnt + e - lo)
__device__ __forceinline__ void split(int i, int cnt, int lo, int& j, int& e) {
  j = 0;
  for (e = i; e >= cnt; e -= cnt) ++j;
  e += lo;
}

// rows of source slots a tile keeps in shared memory: K rounded up to 4 or 8
__host__ __device__ __forceinline__ int slot_rows(int K) { return K <= 4 ? 4 : 8; }

// The inflow of entry e: its sources' q (KU rows of slots, -1 where none)
// added in slot order, 0 for a missing source as the plain version adds it.
// Unrolled and free of branches, so that the loads are in flight together.
template <int KU, typename T>
__device__ __forceinline__ T inflow_of(const int* ss, int n_pad, int e, const T* qj) {
  T inflow = T(0);
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    const int s = ss[k * n_pad + e];
    const T v = qj[s < 0 ? 0 : s];
    inflow = inflow + (s < 0 ? T(0) : v);
  }
  return inflow;
}

// thread 0 writes the block's record (kTraceWords) into `trace`, if not null
__device__ __forceinline__ void trace_block(unsigned long long* trace, unsigned long long g0,
                                            long long c0, long long c_staged) {
  if (!trace || threadIdx.x != 0) return;
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  unsigned long long* t = trace + static_cast<int64_t>(kTraceWords) * blockIdx.x;
  t[0] = smid;
  t[1] = g0;
  t[2] = global_ns();
  t[3] = static_cast<unsigned long long>(c_staged);
  t[4] = static_cast<unsigned long long>(clock64() - c0);
}

}  // namespace
