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
// a segment's total is +0 plus its pieces' sums in ascending piece order. A
// lane that holds no member holds +0, which adds nothing (a sum started from
// +0 is never -0), so how pieces are mapped onto threads does not change a
// bit, and neither does the integer ticket below: no sum is atomic, and every
// run gives the same bits.
//
// What bounds it. The function reads the values and the permutation once and
// writes the totals or the spread once: 12 to 16 bytes a member in float32,
// 4.3 us for the 1.2 M cells of the continental grid at 3.35 TB/s, with one
// add a member. The launch gaps and the chain of a large segment's pieces
// (1,172 adds for a segment holding the whole grid) stand above that.
//
// Design: one launch a call, two for a spread over a segment of more than one
// piece.
//  - Pass 1, a warp a piece of more than 8 members and a piece of a segment of
//    several pieces (`items`; their lanes' strided sums, then the tree by
//    __shfl_down_sync), a thread a segment of at most 8 members (the D8
//    segments of downEva and downstruct, a region or catchment of a few
//    cells: the tree over 8 lanes in registers, 32 segments to a warp, their
//    bounds read from `seg_ptr` by consecutive threads). A segment of one
//    piece has its total there: +0 plus the piece's sum, written to the
//    totals, or by the same warp or thread to the members it has just read.
//  - A segment of several pieces: each piece's warp stores its sum, fences
//    and takes the segment's integer ticket; the warp that takes the last one
//    adds the pieces' sums in ascending order from registers, 256 loaded at
//    a time while the 256 before them are added (the adds are a chain; the
//    loads need not be), writes the total and sets the ticket back to 0 for
//    the next call.
//  - Pass 2 (a spread with such segments): a block a piece writes its
//    segment's total to the piece's members.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kSmall = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
// piece sums a lane holds at a time where a warp adds a segment's pieces
constexpr int kBatch = 8;

}  // namespace

// Field order and types must match _SegmentArgs in ops/segment_sum.py.
struct SegmentArgs {
  // warp items, the first n_multi_items of them the pieces of segments of
  // several pieces; those segments; segments summed; whether the call
  // spreads the totals to the members
  int n_items, n_multi_items, n_multi, count, spread;
  // (size,) values; the order's tables (ops/segment_sum.SegmentOrder):
  // perm, seg_ptr (count + 1,), items (n_items, 4) {first entry of perm,
  // members, segment or slot, multi-piece segment or -1}, multi (n_multi, 3)
  // {first slot, pieces, segment}
  const void* values;
  const int *perm, *seg_ptr, *items, *multi;
  // the order's scratch: a ticket a multi-piece segment (0 between calls),
  // the pieces' sums by slot, the multi-piece segments' totals (spread)
  int* tickets;
  void *partial, *multi_totals;
  // the totals (count,) or the spread (size,)
  void *totals, *out;
};

namespace {

template <typename T>
__device__ __forceinline__ T load_l2(const T* p) { return __ldcg(p); }

template <typename T>
__global__ void __launch_bounds__(kThreads) piece_kernel(const __grid_constant__ SegmentArgs a,
                                                         int item_blocks) {
  const T* v = static_cast<const T*>(a.values);
  if (static_cast<int>(blockIdx.x) < item_blocks) {
    const int w = blockIdx.x * kWarps + threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    if (w >= a.n_items) return;  // a whole warp leaves together
    const int4 it = reinterpret_cast<const int4*>(a.items)[w];
    const int* m = a.perm + it.x;
    const int n = it.y;
    T acc = T(0);
#pragma unroll 4
    for (int i = lane; i < n; i += kLanes) acc = acc + v[m[i]];
#pragma unroll
    for (int h = kLanes / 2; h >= 1; h /= 2) acc = acc + __shfl_down_sync(0xffffffffu, acc, h);
    if (it.w < 0) {  // the segment's only piece: its total
      const T total = __shfl_sync(0xffffffffu, T(0) + acc, 0);
      if (!a.spread) {
        if (lane == 0) static_cast<T*>(a.totals)[it.z] = total;
      } else {
        for (int i = lane; i < n; i += kLanes) static_cast<T*>(a.out)[m[i]] = total;
      }
      return;
    }
    T* partial = static_cast<T*>(a.partial);
    int last = 0;
    if (lane == 0) {
      partial[it.z] = acc;
      __threadfence();
      last = atomicAdd(a.tickets + it.w, 1) == a.multi[3 * it.w + 1] - 1;
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) return;
    // every piece's sum is stored: add them in ascending order from +0,
    // piece j + 32 b + l held by lane l in x[b], the next 32 kBatch loaded
    // while these are added
    __threadfence();
    const int first = a.multi[3 * it.w], pieces = a.multi[3 * it.w + 1];
    const T* p = partial + first;
    auto load = [&](int j, T* y) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = j + kLanes * b + lane;
        y[b] = k < pieces ? load_l2(p + k) : T(0);
      }
    };
    T x[kBatch], y[kBatch] = {};
    load(0, x);
    T total = T(0);
    for (int j = 0; j < pieces; j += kLanes * kBatch) {
      if (j + kLanes * kBatch < pieces) load(j + kLanes * kBatch, y);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int k = 0; k < kLanes; ++k) {
          const T piece = __shfl_sync(0xffffffffu, x[b], k);
          if (j + kLanes * b + k < pieces) total = total + piece;
        }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) x[b] = y[b];
    }
    if (lane == 0) {
      a.tickets[it.w] = 0;
      if (a.spread)
        static_cast<T*>(a.multi_totals)[it.w] = total;
      else
        static_cast<T*>(a.totals)[a.multi[3 * it.w + 2]] = total;
    }
  } else {
    const int s = (blockIdx.x - item_blocks) * kThreads + threadIdx.x;
    if (s >= a.count) return;
    const int start = a.seg_ptr[s], n = a.seg_ptr[s + 1] - start;
    if (n > kSmall) return;  // a warp item
    const int* m = a.perm + start;
    T x[kSmall];
#pragma unroll
    for (int k = 0; k < kSmall; ++k) x[k] = k < n ? T(0) + v[m[k]] : T(0);
    // the tree's steps h = 16 and 8 add +0 to lanes 0..7
#pragma unroll
    for (int h = kSmall / 2; h >= 1; h /= 2)
#pragma unroll
      for (int k = 0; k < h; ++k) x[k] = x[k] + x[k + h];
    const T total = T(0) + x[0];
    if (!a.spread) {
      static_cast<T*>(a.totals)[s] = total;
    } else {
#pragma unroll
      for (int k = 0; k < kSmall; ++k)
        if (k < n) static_cast<T*>(a.out)[m[k]] = total;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) spread_kernel(const __grid_constant__ SegmentArgs a) {
  const int4 it = reinterpret_cast<const int4*>(a.items)[blockIdx.x];
  const T total = static_cast<const T*>(a.multi_totals)[it.w];
  const int* m = a.perm + it.x;
  for (int i = threadIdx.x; i < it.y; i += kThreads) static_cast<T*>(a.out)[m[i]] = total;
}

int blocks(int64_t n, int per_block) { return static_cast<int>((n + per_block - 1) / per_block); }

template <typename T>
cudaError_t launch(const SegmentArgs& a, cudaStream_t stream, int* launched) {
  const int item_blocks = blocks(a.n_items, kWarps);
  const int grid = item_blocks + blocks(a.count, kThreads);
  if (grid > 0) {
    piece_kernel<T><<<grid, kThreads, 0, stream>>>(a, item_blocks);
    ++*launched;
  }
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || !a.spread || a.n_multi_items == 0) return rc;
  spread_kernel<T><<<a.n_multi_items, kThreads, 0, stream>>>(a);
  ++*launched;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs pass 1 and, for a spread over multi-piece segments, pass 2 on
// `stream`; is_double selects the element type; *launched is the number of
// kernels launched. Returns a cudaError_t (0 on success).
int segment_sum_launch(const SegmentArgs* args, int is_double, void* stream, int* launched) {
  const SegmentArgs a = *args;
  *launched = 0;
  if (a.n_items < 0 || a.n_multi_items < 0 || a.n_multi_items > a.n_items || a.n_multi < 0 ||
      a.count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_double ? launch<double>(a, s, launched) : launch<float>(a, s, launched));
}

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
