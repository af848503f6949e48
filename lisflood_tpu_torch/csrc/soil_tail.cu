// K8: the soil Courant tail, CUDA for Hopper (sm_90a).
//
// Replaces the tail of lisflood_tpu/ops/physics.py:soil_columns_step (:200):
// `tail_loop`'s lax.while_loop (:274-302), which the JAX package runs over the
// lanes that lax.top_k compacts (:324), with a whole-grid masked loop as the
// fallback on overflow (:347-353) (XLA, not Pallas). It computes sub-steps
// 1..no_subs-1 of the three-layer Darcy seepage (soilloop.py:213-321) for
// every lane of the (3, P) soil grid, from the storages and seepage sums
// after sub-step 0: each sub-step recomputes the van Genuchten conductivity
// of the three layers from the current storage (_unsat_conductivity), caps
// the seepage by the room below (recomputed from the current storage, which
// equals the reference's explicit cap carry) and by the storage itself, and
// adds it to the lane's sums. The plain PyTorch version of the same function,
// operation for operation, is lisflood_tpu_torch/ops/soil_tail.py:
// soil_tail_reference.
//
// What bounds it. The work depends on the data: every lane reads its count
// (4 bytes), and a lane that sub-steps reads its 21 operands and 3 masks and
// writes its 3 sums; each of its no_subs - 1 sub-steps computes three
// conductivities of two pows each. Few lanes sub-step (1.7% on the continental
// main path, up to 41 times; a fifth forced wet, up to the cap of 100), so one
// thread a lane leaves nearly every warp that holds such a lane running its
// whole loop for one or two useful threads.
//
// Design: the sub-stepping lanes are compacted per tile, so that a warp runs
// 32 of them. One launch a step, nothing read back on the host:
//  1. a block takes a tile of `tile` lanes, in rounds of kRound consecutive
//     lanes, round r of block b the (r G + b)-th of the grid's G blocks, so
//     that the lanes that sub-step, which cluster where the soil is wet,
//     spread over the blocks (ops/soil_tail.py sizes the tile so that the
//     grid fits on the card at once: a lane's chain, not the work, sets the
//     time, and a second wave of blocks would wait for the first one's
//     chains); it loads the counts of all its rounds at once, four lanes a
//     thread a round in a 16-byte load;
//  2. it compacts the lanes with no_subs > 1 into shared memory in the order
//     of its rounds and lanes, each as its offset in the tile and its
//     count's class (floor(log2), at most 7) in 16 bits: four ballots a
//     round give each thread the count of its warp's lower threads, the
//     warps' totals a block-wide prefix (no atomics);
//  3. where the tile holds more than 32 such lanes, a stable radix sort on
//     the class, one bit a pass from the lowest, ones first, groups them,
//     the longest first and in lane order within a class, so that a warp's
//     lanes run loops of about one length and read operands close together;
//  4. the warps run the compacted lanes 32 at a time, warp w the w-th 32 and
//     then, whichever warp is free first, the next 32 (a counter in shared
//     memory): the longest chains start first. A lane's sub-step is the
//     plain version's, operation for operation: `x ** 2` is x * x, `x ** y`
//     is pow / powf, sqrt and division are IEEE, min and max propagate NaN,
//     and -fmad=false (ops/_build.py) keeps every product and sum rounded on
//     its own. Which thread runs a lane, and when, changes no bit.
// A lane's sub-steps are a serial chain: no launch is shorter than the
// longest lane's no_subs - 1 sub-steps run by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// counts a round: four lanes a thread, one 16-byte load
constexpr int kRound = 4 * kThreads;
// the most lanes a tile, and the rounds of one; a compacted lane is 16 bits:
// its offset in the tile in the low kOffsetBits, its count's class above
constexpr int kTile = 7 * kRound;
constexpr int kRounds = kTile / kRound;
constexpr int kOffsetBits = 13;
constexpr unsigned kOffsetMask = (1u << kOffsetBits) - 1u;
// float parameters, in the order of _SOIL_KEYS in ops/physics.py:
// WRes1a, WRes1b, WRes2, WS1a, WS1b, WS2, KSat1a, KSat1b, KSat2,
// GenuInvM1a, GenuInvM1b, GenuInvM2, GenuM1a, GenuM1b, GenuM2
constexpr int kParams = 15;

}  // namespace

// Field order and types must match _SoilTailArgs in ops/soil_tail.py.
struct SoilTailArgs {
  // lanes: 3 * P of the (3, P) grid, each operand contiguous in that shape
  long long n;
  // (n,) int32 sub-step count of each lane; (n,) its sub-step length
  const int* no_subs;
  const void* dt_sub;
  // (n,) storage above the residual after sub-step 0, the three layers
  const void *aw1a, *aw1b, *aw2;
  // (n,) seepage sums after sub-step 0, updated in place
  void *seep_a, *seep_b, *seep_gw;
  // (n,) the float parameters, and the three layers' PoreSpaceNotZero (bool)
  const void* par[kParams];
  const unsigned char* psnz[3];
};

namespace {

// _unsat_conductivity (ops/physics.py): ksat * sqrt(sat) * (1 - (1 -
// sat ** inv_m) ** m) ** 2, sat the relative saturation clamped to [0, 1]
template <typename T>
__device__ __forceinline__ T conductivity(T w, bool psnz, T wres, T ws, T ksat, T inv_m, T m) {
  const T den = psnz ? ws - wres : T(1);
  const T sat = psnz ? vmin(vmax((w - wres) / den, T(0)), T(1)) : T(0);
  const T inner = T(1) - vpow(T(1) - vpow(sat, inv_m), m);
  return ksat * vsqrt(sat) * (inner * inner);
}

// One lane's sub-steps: its operands and the state its loop carries.
template <typename T>
struct Lane {
  long long i;
  int ns, k;
  T wres1a, wres1b, wres2, ws1a, ws1b, ws2, ks1a, ks1b, ks2, im1a, im1b, im2, m1a, m1b, m2;
  T dt, a1a, a1b, a2, sa, sb, sg;
  bool p1a, p1b, p2;

  // lane i's operands, its storages and sums after sub-step 0; next, k = 1
  __device__ __forceinline__ void load(const SoilTailArgs& a, long long lane) {
    i = lane;
    auto par = [&](int j) { return static_cast<const T*>(a.par[j])[i]; };
    wres1a = par(0), wres1b = par(1), wres2 = par(2);
    ws1a = par(3), ws1b = par(4), ws2 = par(5);
    ks1a = par(6), ks1b = par(7), ks2 = par(8);
    im1a = par(9), im1b = par(10), im2 = par(11);
    m1a = par(12), m1b = par(13), m2 = par(14);
    p1a = a.psnz[0][i] != 0, p1b = a.psnz[1][i] != 0, p2 = a.psnz[2][i] != 0;
    ns = a.no_subs[i];
    dt = static_cast<const T*>(a.dt_sub)[i];
    a1a = static_cast<const T*>(a.aw1a)[i];
    a1b = static_cast<const T*>(a.aw1b)[i];
    a2 = static_cast<const T*>(a.aw2)[i];
    sa = static_cast<const T*>(a.seep_a)[i];
    sb = static_cast<const T*>(a.seep_b)[i];
    sg = static_cast<const T*>(a.seep_gw)[i];
    k = 1;
  }

  // sub-step k; returns whether the lane has more
  __device__ __forceinline__ bool step() {
    const T wt1a = a1a + wres1a;
    const T wt1b = a1b + wres1b;
    const T wt2 = a2 + wres2;
    // the three layers' conductivities do not depend on each other
    const T k1a = conductivity(wt1a, p1a, wres1a, ws1a, ks1a, im1a, m1a);
    const T k1b = conductivity(wt1b, p1b, wres1b, ws1b, ks1b, im1b, m1b);
    const T k2 = conductivity(wt2, p2, wres2, ws2, ks2, im2, m2);
    const T s_a = vmin(k1a * dt, ws1b - wt1b);
    const T s_b = vmin(k1b * dt, ws2 - wt2);
    const T s_g = vmin(k2 * dt, a2);
    a1a = a1a - s_a;
    a1b = (a1b + s_a) - s_b;
    a2 = (a2 + s_b) - s_g;
    sa = sa + s_a;
    sb = sb + s_b;
    sg = sg + s_g;
    return ++k < ns;
  }

  __device__ __forceinline__ void store(const SoilTailArgs& a) const {
    static_cast<T*>(a.seep_a)[i] = sa;
    static_cast<T*>(a.seep_b)[i] = sb;
    static_cast<T*>(a.seep_gw)[i] = sg;
  }
};

// The sum of `warp_total` (the same in all threads of a warp) over the
// warps below this thread's, and over all the block's warps in `block_total`.
// Every thread calls it; `scratch` is free again when it returns.
__device__ __forceinline__ int warps_below(int warp_total, int* scratch, int& block_total) {
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) scratch[warp] = warp_total;
  __syncthreads();
  int below = 0;
  block_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = scratch[w];
    below += w < warp ? c : 0;
    block_total += c;
  }
  __syncthreads();
  return below;
}

// The largest `v` in the block; every thread calls it.
__device__ __forceinline__ int block_max(int v, int* scratch) {
  const int w_max = __reduce_max_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = w_max;
  __syncthreads();
  int most = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) most = max(most, scratch[w]);
  __syncthreads();
  return most;
}

// The first lane of round r of the block: the blocks' rounds interleave
// across the grid, so that a block's lanes sample all of it and the lanes
// that sub-step, which cluster where the soil is wet, spread over the blocks.
__device__ __forceinline__ long long round_start(int r) {
  return (static_cast<long long>(r) * gridDim.x + blockIdx.x) * kRound;
}

// A count's class, the sort's key: floor(log2(c)) for c >= 2, at most 7.
// Lanes of one class run loops within a factor of 2 of each other, and sorting
// on the class alone keeps a class's lanes in lane order, so that a warp's
// operands lie close together (a finer key scatters them, and the gathers
// cost more than the closer lengths save).
__device__ __forceinline__ unsigned count_class(int c) { return min(31 - __clz(c), 7); }

template <typename T>
__global__ void __launch_bounds__(kThreads) soil_tail_kernel(const __grid_constant__ SoilTailArgs a,
                                                             int rounds) {
  // the compacted lanes: (class << kOffsetBits) | offset in the tile (round
  // r, lane j of the round: r kRound + j); two lists for the sort's passes
  __shared__ unsigned short list[2][kTile];
  __shared__ int scratch[kWarps];
  __shared__ int next_chunk;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned lower = (1u << lane) - 1u;
  if (threadIdx.x == 0) next_chunk = kWarps;

  // 1. the counts of every round, loaded at once: four lanes a thread, in
  // 16-byte loads where the counts are 16-byte aligned (a round starts at a
  // multiple of 4 lanes)
  const bool vec = reinterpret_cast<uintptr_t>(a.no_subs) % 16 == 0;
  const int j = 4 * threadIdx.x;
  int c[kRounds][4];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long start = round_start(r);
    const int len = r < rounds ? static_cast<int>(
        max(0LL, min(static_cast<long long>(kRound), a.n - start))) : 0;
    const int* counts = a.no_subs + start;
    if (vec && j + 4 <= len) {
      const int4 q = *reinterpret_cast<const int4*>(counts + j);
      c[r][0] = q.x, c[r][1] = q.y, c[r][2] = q.z, c[r][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) c[r][k] = j + k < len ? counts[j + k] : 0;
    }
  }

  // 2. compact: the lanes with no_subs > 1 into list[0], in the order of
  // the block's rounds and of the lanes in a round
  int m = 0;
  unsigned top = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r >= rounds) break;  // the same in every thread
    int below = 0, in_warp = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned word = __ballot_sync(0xffffffffu, c[r][k] > 1);
      below += __popc(word & lower);
      in_warp += __popc(word);
    }
    int round_total;
    int at = m + warps_below(in_warp, scratch, round_total) + below;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c[r][k] > 1) {
        const unsigned key = count_class(c[r][k]);
        list[0][at++] = static_cast<unsigned short>((key << kOffsetBits) | (r * kRound + j + k));
        top = max(top, key);
      }
    }
    m += round_total;
  }
  if (m == 0) return;  // the same in every thread of the block
  __syncthreads();
  int cur = 0;

  // 3. group by count: a stable sort on the class's bits, ones first
  if (m > 32) {
    const int bits = 32 - __clz(block_max(static_cast<int>(top), scratch));
    for (int b = kOffsetBits; b < kOffsetBits + bits; ++b, cur ^= 1) {
      const unsigned short* src = list[cur];
      unsigned short* dst = list[cur ^ 1];
      int ones = 0;
      for (int r = 0; r < m; r += kThreads) {
        const int e = r + threadIdx.x;
        ones += __popc(__ballot_sync(0xffffffffu, e < m && ((src[e] >> b) & 1u)));
      }
      int all_ones;
      warps_below(ones, scratch, all_ones);
      int ones_before = 0;
      for (int r = 0; r < m; r += kThreads) {
        const int e = r + threadIdx.x;
        const bool one = e < m && ((src[e] >> b) & 1u);
        const unsigned word = __ballot_sync(0xffffffffu, one);
        int round_ones;
        // the ones among entries 0..e-1; the others there are zeros
        const int rank = ones_before + warps_below(__popc(word), scratch, round_ones) +
                         __popc(word & lower);
        if (e < m) dst[one ? rank : all_ones + (e - rank)] = src[e];
        ones_before += round_ones;
      }
      __syncthreads();
    }
  }

  // 4. run: warp w takes the chunk of entries 32 w.., then the next chunk
  // not taken whenever it is free
  for (int chunk = warp; 32 * chunk < m;) {
    const int e = 32 * chunk + lane;
    if (e < m) {
      const int offset = list[cur][e] & kOffsetMask;
      Lane<T> state;
      state.load(a, round_start(offset / kRound) + offset % kRound);
      while (state.step()) {
      }
      state.store(a);
    }
    int taken = 0;
    if (lane == 0) taken = atomicAdd(&next_chunk, 1);
    chunk = __shfl_sync(0xffffffffu, taken, 0);
  }
}

}  // namespace

extern "C" {

// One launch over the args->n lanes, `tile` lanes a block (a multiple of
// kRound, at most kTile) in rounds of kRound interleaved across the grid, on
// `stream`; is_double selects the element type. Returns a cudaError_t (0 on
// success).
int soil_tail_launch(const SoilTailArgs* args, int tile, int is_double, void* stream) {
  const SoilTailArgs a = *args;
  if (a.n < 0 || tile <= 0 || tile > kTile || tile % kRound != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const long long grid = (a.n + tile - 1) / tile;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rounds = tile / kRound;
  if (is_double)
    soil_tail_kernel<double><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a, rounds);
  else
    soil_tail_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a, rounds);
  return static_cast<int>(cudaGetLastError());
}

const char* soil_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
