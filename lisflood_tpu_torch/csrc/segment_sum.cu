// K7: segment sums in a fixed order, CUDA for Hopper (sm_90a).
//
// Replaces lisflood_tpu/ops/physics.py:segment_spread and
// scatter_to_downstream (:22-30), `jax.ops.segment_sum`, an XLA scatter (not
// Pallas): per-segment totals of a (size,) vector over a constant segment
// array, spread back to the members or moved to the downstream pixel. The
// plain PyTorch version of the same function, addition for addition, is
// lisflood_tpu_torch/ops/segment_sum.py:segment_sum.
//
// The order of every addition is fixed by ops/segment_sum.SegmentOrder, built
// on the host: each segment's members in ascending index order (`perm`) are
// cut into pieces of 1024; in a piece, lane l of 32 sums members l, l + 32,
// ... from +0, then a fixed tree adds lane l + h to lane l for h = 16, ..., 1;
// a segment's total is +0 plus its pieces' sums in ascending piece order. No
// sum is atomic, so the result has the same bits in every run, and a lane
// that holds no member holds +0, which adds nothing, so how pieces are mapped
// onto threads does not change a bit:
//  - pass 1: a piece of more than 8 members takes a warp (its lanes'
//    strided sums, then the tree by __shfl_down_sync); a piece of at most 8
//    (the D8 segments of downEva and downstruct, a region or catchment of a
//    few cells) takes one thread, which runs the tree over 8 lanes in
//    registers, 32 such pieces to a warp;
//  - pass 2: one thread a segment adds its pieces' sums in order;
//  - pass 3 (segment_spread): one thread a member reads its segment's total.
//
// What bounds it. The function reads the values and the permutation once and
// writes the totals and the spread once: 16 bytes a member in float32 (4 of
// them the segment id the spread reads), 4.2 us for the 1.16 M cells of the
// 1200x1000 catchment at 3.35 TB/s, with one add a member. Three launches and
// pass 2's chain over the pieces of the largest segment (1,135 adds for a
// segment holding the whole grid) stand above that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kSmall = 8;
constexpr int kThreads = 256;

}  // namespace

// Field order and types must match _SegmentArgs in ops/segment_sum.py.
struct SegmentArgs {
  // pieces of more than kSmall members, of at most kSmall, segments summed,
  // members (the values' length), whether pass 3 writes the spread
  int n_large, n_small, count, size, spread;
  // (size,) values; the order's tables (ops/segment_sum.SegmentOrder)
  const void* values;
  const int *perm, *piece_start, *piece_len, *seg_piece, *large, *small, *segments;
  // scratch: each piece's sum; the totals (count,); the spread (size,)
  void *partial, *totals, *out;
};

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) piece_kernel(const __grid_constant__ SegmentArgs a,
                                                         int large_blocks) {
  const T* v = static_cast<const T*>(a.values);
  T* partial = static_cast<T*>(a.partial);
  if (static_cast<int>(blockIdx.x) < large_blocks) {
    const int w = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    if (w >= a.n_large) return;  // a whole warp leaves together
    const int piece = a.large[w];
    const int* m = a.perm + a.piece_start[piece];
    const int n = a.piece_len[piece];
    T acc = T(0);
    for (int i = lane; i < n; i += kLanes) acc = acc + v[m[i]];
#pragma unroll
    for (int h = kLanes / 2; h >= 1; h /= 2) acc = acc + __shfl_down_sync(0xffffffffu, acc, h);
    if (lane == 0) partial[piece] = acc;
  } else {
    const int i = (blockIdx.x - large_blocks) * kThreads + threadIdx.x;
    if (i >= a.n_small) return;
    const int piece = a.small[i];
    const int* m = a.perm + a.piece_start[piece];
    const int n = a.piece_len[piece];
    T x[kSmall];
#pragma unroll
    for (int k = 0; k < kSmall; ++k) x[k] = k < n ? T(0) + v[m[k]] : T(0);
    // the tree's steps h = 16 and 8 add +0 to lanes 0..7
#pragma unroll
    for (int h = kSmall / 2; h >= 1; h /= 2)
#pragma unroll
      for (int k = 0; k < h; ++k) x[k] = x[k] + x[k + h];
    partial[piece] = x[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) total_kernel(const __grid_constant__ SegmentArgs a) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= a.count) return;
  const T* partial = static_cast<const T*>(a.partial);
  T t = T(0);
  for (int j = a.seg_piece[s]; j < a.seg_piece[s + 1]; ++j) t = t + partial[j];
  static_cast<T*>(a.totals)[s] = t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) spread_kernel(const __grid_constant__ SegmentArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.size) return;
  static_cast<T*>(a.out)[i] = static_cast<const T*>(a.totals)[a.segments[i]];
}

int blocks(int64_t n, int per_block) { return static_cast<int>((n + per_block - 1) / per_block); }

template <typename T>
cudaError_t launch(const SegmentArgs& a, cudaStream_t stream) {
  const int large_blocks = blocks(a.n_large, kThreads / kLanes);
  const int grid1 = large_blocks + blocks(a.n_small, kThreads);
  if (grid1 > 0) piece_kernel<T><<<grid1, kThreads, 0, stream>>>(a, large_blocks);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  if (a.count > 0) total_kernel<T><<<blocks(a.count, kThreads), kThreads, 0, stream>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || !a.spread || a.size == 0) return rc;
  spread_kernel<T><<<blocks(a.size, kThreads), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs passes 1, 2 and, with args->spread, 3 on `stream`; is_double selects
// the element type. Returns a cudaError_t (0 on success).
int segment_sum_launch(const SegmentArgs* args, int is_double, void* stream) {
  const SegmentArgs a = *args;
  if (a.n_large < 0 || a.n_small < 0 || a.count < 0 || a.size < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double ? launch<double>(a, s) : launch<float>(a, s));
}

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
