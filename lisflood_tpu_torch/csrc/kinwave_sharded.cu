// K6: the sharded kinematic-wave sweep as one CUDA kernel for Hopper (sm_90a).
//
// Replaces lisflood_tpu/ops/kinwave_sharded.py:_sweep_sharded (:164), an XLA
// lax.scan (:191), not Pallas: one kinematic-wave time step over a sharded
// schedule (ops/kinwave_sharded.py:build_sharded_schedule). Every position's
// discharge, on each of L lanes, is the Newton solution of
//   Q + adx * Q^beta = const + upstream inflow,
// the inflow being the sum of its sources' discharges. Operands and output are
// (L, p_pad) in the schedule's position space, pos = s * n_chunks * C + c * C
// + l. The plain PyTorch version of the same function is
// lisflood_tpu_torch/ops/kinwave_sharded.py:_sweep_sharded, which walks the
// schedule's lockstep chunks in order.
//
// The same kernel replaces lisflood_tpu/ops/kinwave.py:_route_batched (:80),
// ScanRouter's lax.scan (:104) over a natural-order schedule: there position
// space is pixel space (p_pad = P, nothing padded), the tables are built from
// the natural graph (ops/kinwave.py:ScanRouter.sweep_tiles) and the plain
// version is ops/kinwave.py:_route_batched, which walks the schedule's chunks.
//
// Design: tree tiles, as K5 (kinwave_sweep.cu). On one device the schedule's
// cut edges are ordinary edges, so the graph is a forest. The host
// (ops/wavefront.py:sweep_tiles, called by ops/kinwave_sharded.sharded_tables)
// packs the real positions into tiles of whole trees, leaves the schedule's
// padding out, and sorts each tile's entries by level, a level being one band
// of equal depth below the roots, so that every source lies in the level just
// below its target. One block takes one tile on an ordinary grid, deepest tile
// first: no dependence crosses a block, so there is no flag, no ticket and no
// co-residency rule. A tile runs one of three ways:
//  - shallow (its padded entries <= n_smem, K5's path): the tile's slots and
//    positions copied into shared memory with cp.async, const and adx
//    gathered by position, then the levels in shared memory, one
//    __syncthreads a level;
//  - deep, through a ring (its widest level <= ring_w; on the 1200x1000
//    catchment of models/synthetic.write_catchment the two channel trees
//    larger than the cap, the deepest 132,645 cells in 1,583 levels of at
//    most 171): the block walks the levels in
//    order, keeping the last two levels' q in shared memory, so a source's q is
//    a shared-memory load at its offset into the level below. While the
//    block's first ring_threads threads run level d, the others copy the
//    entries' records (position and ring offsets, ops/wavefront.sweep_tiles
//    with ring=True; 16 bytes a copy) of level d + kLeadTable and the operands
//    of level d + kLeadGather ahead with cp.async (an operand's gather needs
//    its position, which arrived with its record), so that no copy lies on
//    the chain; the
//    copiers' cp.async.wait_group kWait and one __syncthreads a level make
//    the level's stages and the ring's last level visible and free the slots
//    being refilled. A level's q goes to global memory for the output and is
//    never read back within the launch;
//  - global (a tile whose level is wider than the ring): q read back from
//    global memory, K5's fallback branch.
// The schedule's padding positions have no edge; the grid's last pad_blocks
// blocks solve them elementwise from const and adx, as the plain version does.
// A launch can record, per block, its SM, its start and end on the global
// clock and its cycles to the end of staging and to its end (ShardedArgs.trace;
// chip_smoke.py phase 10 reads them).
//
// Upstream inflow is summed in a fixed order, the order of the upstream table
// (ops/kinwave_sharded.py:upstream_positions: ascending natural pixel index of
// the source, so the same for every shard count), which the tiles' slots keep,
// as the plain version sums it. No sum is atomic: the outputs have the same
// bits for every cap and in every run, and equal the plain version's.
//
// What bounds it. The function reads const and adx once and writes q once, with
// one int32 downstream index per real position: 32.5 MB on the channel graph
// of that catchment (two lanes), 0.0097 ms at 3.35 TB/s, and 46.5 MB overland
// (three lanes), 0.0139 ms; its operations take less. The kernel runs at the
// latency of its deepest tile instead: the chain floor, its levels times the
// cycles a level takes (a barrier, a gather from shared memory, one Newton
// solve in series and the stores). The ring takes the global round trips out
// of that chain; the copies ahead take the tables' and operands' loads out of
// it; the shallow tiles and the padding run on the other SMs beside it.
//
// Arithmetic: -fmad=false, and the Newton solves of kinwave_common.cuh (through
// kinwave_tiles.cuh, shared with K5), as ops/kinwave_packed.newton_solve: the
// float32 v-space polynomial at beta = 3/5, otherwise the q-space unrolled
// iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_tiles.cuh"

namespace {

constexpr int kMaxThreads = 1024;   // threads per block
constexpr int kMaxUps = 8;          // LDD: at most 8 upstream neighbours
constexpr int kStagedLevels = 255;  // level offsets of a shallow tile kept in shared memory
// The ring path's pipeline: groups of copies in flight while a level runs,
// and how many levels ahead the operands and the tables are copied (the
// operands' gathers read the positions of their tables, which must have
// landed kWait + 1 levels before). ops/kinwave_sharded.py:ring_bytes counts
// the same slots.
constexpr int kWait = 2;
constexpr int kLeadGather = kWait + 1;
constexpr int kLeadTable = kLeadGather + kWait + 1;
constexpr int kGatherSlots = kLeadGather + 1;
constexpr int kTableSlots = kLeadTable + 1;

}  // namespace

// Field order and types must match _ShardedArgs in ops/kinwave_sharded.py.
struct ShardedArgs {
  // tiles, blocks that solve the padding, rows of a position (L), rows of
  // slots (K), positions of the schedule (p_pad), threads per block, padded
  // entries up to which a tile runs in shared memory (n_smem), the ring's
  // width (a multiple of 8), the most levels of a tile that takes it and the
  // threads that run its levels (the others copy ahead), padding positions
  int n_tiles, pad_blocks, lanes, K, p_pad, threads, n_smem, ring_w, ring_levels, ring_threads,
      n_pad;
  double beta;
  // (L, p_pad) operands and the output q
  const void *cst, *adx;
  void* q;
  // the tile tables of ops/wavefront.py:sweep_tiles (width: each tile's widest
  // level; ring: each entry's ring record) and the padding positions
  const int *tile_ptr, *pos, *slots, *lvl_ptr, *lvl_off, *width, *ring, *pad;
  // null, or kTraceWords per block: where the block's time went
  unsigned long long* trace;
};

namespace {

template <typename T>
struct Coef {
  T beta, inv_beta, b_minus_1;
};

// a tile's padded entry count, its levels and its tables
struct Tile {
  int n_pad, levels;
  const int *pos, *slots, *lv, *ring;
};

// int32 of an entry's ring record: its position and K offsets, to 16 bytes
__host__ __device__ __forceinline__ int ring_record(int K) { return (K + 4) / 4 * 4; }

// Shallow: the whole tile in shared memory (K5's path, operands (L, p_pad)).
// Returns the cycles its staging took.
template <typename T, bool POLY, int KU>
__device__ long long run_shallow(const ShardedArgs& a, const Tile& t, const int* lvs, bool staged,
                                 unsigned char* smem, Coef<T> c, long long c0) {
  const int L = a.lanes, K = a.K, P = a.p_pad, n_pad = t.n_pad;
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  T* qs = reinterpret_cast<T*>(smem);                // (L, n_pad): const, then q
  T* as = qs + L * n_pad;                            // (L, n_pad): adx
  int* ss = reinterpret_cast<int*>(as + L * n_pad);  // (KU, n_pad): slots
  int* os = ss + KU * n_pad;                         // (n_pad): positions
  for (int i = threadIdx.x; i < K * n_pad / 4; i += blockDim.x)
    cp_async16(ss + 4 * i, t.slots + 4 * i);
  for (int i = K * n_pad + threadIdx.x; i < KU * n_pad; i += blockDim.x) ss[i] = -1;
  for (int i = threadIdx.x; i < n_pad / 4; i += blockDim.x) cp_async16(os + 4 * i, t.pos + 4 * i);
  cp_async_wait_all();
  __syncthreads();
  // const and adx gathered by position, each value an asynchronous copy
  const int n = staged ? lvs[t.levels] : t.lv[t.levels];
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int p = os[e];
    for (int j = 0; j < L; ++j) {
      cp_async_elem(qs + j * n_pad + e, cst + j * P + p);
      cp_async_elem(as + j * n_pad + e, adx + j * P + p);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const long long c_staged = clock64() - c0;
  for (int d = 0; d < t.levels; ++d) {
    const int lo = staged ? lvs[d] : t.lv[d];
    const int cnt = (staged ? lvs[d + 1] : t.lv[d + 1]) - lo;
    for (int i = threadIdx.x; i < L * cnt; i += blockDim.x) {
      int j, e;
      split(i, cnt, lo, j, e);
      // the sources' q summed in slot order, plus const, solved
      T* qj = qs + j * n_pad;
      const T inflow = inflow_of<KU>(ss, n_pad, e, qj);
      const T out = solve<T, POLY>(inflow + qj[e], as[j * n_pad + e], c.beta, c.inv_beta,
                                   c.b_minus_1);
      qj[e] = out;
      q[j * P + os[e]] = out;
    }
    __syncthreads();
  }
  return c_staged;
}

// Deep: the levels in order through a ring of the last two levels' q, the
// records and operands of later levels copied ahead. A record is R = 4 *
// ceil((K + 1) / 4) int32 an entry (16-byte aligned): its position, then its
// sources' offsets into the level below, -1 where none. Shared memory, in
// order: the ring (2, L, W), the operand slots (kGatherSlots, 2L, W) (const,
// then adx), the record slots (kTableSlots, W, R), the tile's level offsets.
// Returns the cycles to its first level.
template <typename T, bool POLY, int KU>
__device__ long long run_ring(const ShardedArgs& a, const Tile& t, unsigned char* smem, Coef<T> c,
                              long long c0) {
  const int L = a.lanes, K = a.K, P = a.p_pad, W = a.ring_w, R = ring_record(K);
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  T* ring = reinterpret_cast<T*>(smem);
  T* gat = ring + 2 * L * W;
  int* tab = reinterpret_cast<int*>(gat + kGatherSlots * 2 * L * W);
  int* lvo = tab + kTableSlots * R * W;
  for (int i = threadIdx.x; i <= t.levels; i += blockDim.x) cp_async_elem(lvo + i, t.lv + i);
  cp_async_wait_all();
  __syncthreads();
  long long c_staged = 0;
  // the first nc threads run the levels, the others copy ahead (a copying
  // thread's groups land by its own cp.async.wait_group, then the barrier
  // shows them to the block)
  const int nc = a.ring_threads, n_copy = blockDim.x - nc, ct = threadIdx.x - nc;
  const bool copier = ct >= 0;
  // from d = -kLeadTable on, the first iterations only copy ahead
  for (int d = -kLeadTable; d < t.levels; ++d) {
    if (copier) cp_async_wait<kWait>();
    __syncthreads();
    if (d == 0) c_staged = clock64() - c0;
    if (copier) {
      // the records of level x, 16 bytes a copy
      const int x = d + kLeadTable;
      if (x < t.levels) {
        const int lo = lvo[x], n16 = (lvo[x + 1] - lo) * R / 4;
        int* tb = tab + (x % kTableSlots) * R * W;
        const int* src = t.ring + static_cast<int64_t>(lo) * R;
        for (int i = ct; i < n16; i += n_copy) cp_async16(tb + 4 * i, src + 4 * i);
      }
      // the operands of level y, gathered by the positions of its records
      const int y = d + kLeadGather;
      if (y >= 0 && y < t.levels) {
        const int cnt = lvo[y + 1] - lvo[y];
        const int* py = tab + (y % kTableSlots) * R * W;
        T* gy = gat + (y % kGatherSlots) * 2 * L * W;
        for (int e = ct; e < cnt; e += n_copy) {
          const int p = py[e * R];
          for (int j = 0; j < L; ++j) {
            cp_async_elem(gy + j * W + e, cst + j * P + p);
            cp_async_elem(gy + (L + j) * W + e, adx + j * P + p);
          }
        }
      }
      cp_async_commit();
      continue;
    }
    if (d < 0) continue;
    // level d: the sources' q from the ring's previous level, in slot order
    const int cnt = lvo[d + 1] - lvo[d];
    const int* td = tab + (d % kTableSlots) * R * W;
    const T* gd = gat + (d % kGatherSlots) * 2 * L * W;
    const T* rin = ring + ((d + 1) & 1) * L * W;
    T* rout = ring + (d & 1) * L * W;
    for (int i = threadIdx.x; i < L * cnt; i += nc) {
      int j, e;
      split(i, cnt, 0, j, e);
      const int* rec = td + e * R;
      const T* rj = rin + j * W;
      T inflow = T(0);
#pragma unroll
      for (int k = 0; k < KU; ++k) {
        const int s = k < K ? rec[1 + k] : -1;
        const T v = rj[s < 0 ? 0 : s];
        inflow = inflow + (s < 0 ? T(0) : v);
      }
      const T out = solve<T, POLY>(inflow + gd[j * W + e], gd[(L + j) * W + e], c.beta,
                                   c.inv_beta, c.b_minus_1);
      rout[j * W + e] = out;
      q[j * P + rec[0]] = out;
    }
  }
  cp_async_wait_all();
  return c_staged;
}

// Global: q of this tile read back from global memory (K5's fallback).
template <typename T, bool POLY>
__device__ void run_global(const ShardedArgs& a, const Tile& t, const int* lvs, bool staged,
                           Coef<T> c) {
  const int L = a.lanes, K = a.K, P = a.p_pad, n_pad = t.n_pad;
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  for (int d = 0; d < t.levels; ++d) {
    const int lo = staged ? lvs[d] : t.lv[d];
    const int cnt = (staged ? lvs[d + 1] : t.lv[d + 1]) - lo;
    for (int i = threadIdx.x; i < L * cnt; i += blockDim.x) {
      int j, e;
      split(i, cnt, lo, j, e);
      T inflow = T(0);
      for (int k = 0; k < K; ++k) {
        const int s = t.slots[k * n_pad + e];
        if (s >= 0) inflow = inflow + __ldcg(q + j * P + t.pos[s]);
      }
      const int o = j * P + t.pos[e];
      const T out = solve<T, POLY>(inflow + cst[o], adx[o], c.beta, c.inv_beta, c.b_minus_1);
      __stcg(q + o, out);
    }
    __syncthreads();
  }
}

// Padding: no edge, so q = solve(0 + const, adx) elementwise, as the plain
// version's sum of no sources gives.
template <typename T, bool POLY>
__device__ void run_padding(const ShardedArgs& a, Coef<T> c) {
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  const int stride = a.pad_blocks * blockDim.x;
  for (int i = (blockIdx.x - a.n_tiles) * blockDim.x + threadIdx.x; i < a.n_pad; i += stride) {
    const int p = a.pad[i];
    for (int j = 0; j < a.lanes; ++j) {
      const int o = j * a.p_pad + p;
      q[o] = solve<T, POLY>(T(0) + cst[o], adx[o], c.beta, c.inv_beta, c.b_minus_1);
    }
  }
}

template <typename T, bool POLY, int KU>
__global__ void __launch_bounds__(kMaxThreads) sharded_kernel(const __grid_constant__ ShardedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lvs[kStagedLevels + 1];
  const unsigned long long g0 = a.trace ? global_ns() : 0ull;
  const long long c0 = clock64();
  long long c_staged = 0;
  const Coef<T> c{T(a.beta), T(1.0 / a.beta), T(a.beta - 1.0)};
  if (blockIdx.x >= a.n_tiles) {
    run_padding<T, POLY>(a, c);
  } else {
    const int b = blockIdx.x;
    const int begin = a.tile_ptr[b];
    Tile t;
    t.n_pad = a.tile_ptr[b + 1] - begin;
    t.levels = a.lvl_ptr[b + 1] - a.lvl_ptr[b] - 1;
    t.pos = a.pos + begin;
    t.slots = a.slots + static_cast<int64_t>(a.K) * begin;
    t.lv = a.lvl_off + a.lvl_ptr[b];
    t.ring = a.ring + static_cast<int64_t>(ring_record(a.K)) * begin;
    if (t.n_pad > a.n_smem && a.width[b] <= a.ring_w && t.levels <= a.ring_levels) {
      c_staged = run_ring<T, POLY, KU>(a, t, smem, c, c0);
    } else {
      // the tile's level offsets, in shared memory where they fit
      const bool staged = t.levels <= kStagedLevels;
      if (staged)
        for (int i = threadIdx.x; i <= t.levels; i += blockDim.x) lvs[i] = t.lv[i];
      if (t.n_pad <= a.n_smem) {
        c_staged = run_shallow<T, POLY, KU>(a, t, lvs, staged, smem, c, c0);
      } else {
        __syncthreads();
        run_global<T, POLY>(a, t, lvs, staged, c);
      }
    }
  }
  trace_block(a.trace, g0, c0, c_staged);
}

typedef void (*ShardedKernel)(const ShardedArgs);

template <int KU>
ShardedKernel pick_kernel_ku(int is_double, int poly) {
  if (is_double) return sharded_kernel<double, false, KU>;
  return poly ? sharded_kernel<float, true, KU> : sharded_kernel<float, false, KU>;
}

ShardedKernel pick_kernel(int is_double, int poly, int K) {
  return slot_rows(K) == 4 ? pick_kernel_ku<4>(is_double, poly)
                           : pick_kernel_ku<kMaxUps>(is_double, poly);
}

// Dynamic shared memory of a block: the larger of the shallow path's n_smem
// entries (const/q and adx of L lanes, slot_rows(K) slots, one position) and
// the ring path's slots and level offsets (ops/kinwave_sharded.py:smem_bytes
// counts the same).
size_t smem_bytes(const ShardedArgs& a, int is_double) {
  const size_t item = is_double ? 8 : 4, L = a.lanes, W = a.ring_w, KU = slot_rows(a.K);
  const size_t shallow = (2 * L * item + 4 * KU + 4) * a.n_smem;
  const size_t ring = a.ring_w > 0 ? (2 + 2 * kGatherSlots) * L * W * item +
                                         kTableSlots * ring_record(a.K) * W * 4 +
                                         4 * (static_cast<size_t>(a.ring_levels) + 1)
                                   : 0;
  return shallow > ring ? shallow : ring;
}

bool bad_shape(const ShardedArgs& a) {
  return a.lanes < 1 || a.K < 1 || a.K > kMaxUps || a.n_tiles < 0 || a.pad_blocks < 0 ||
         a.n_tiles + a.pad_blocks < 1 || (a.n_pad > 0) != (a.pad_blocks > 0) || a.n_smem < 0 ||
         a.n_smem % 8 != 0 || a.ring_w < 0 || a.ring_w % 8 != 0 || a.ring_levels < 0 ||
         a.threads < 32 || a.threads > kMaxThreads || a.threads % 32 != 0 || a.p_pad < 1 ||
         static_cast<int64_t>(a.p_pad) * a.lanes >= (1ll << 31);
}

}  // namespace

extern "C" {

// The shared memory a block of the sweep can have on the current device
// (*optin) and the kernel's static shared memory (*static_bytes): a block's
// dynamic share must fit their difference. Returns a cudaError_t.
int kinwave_sharded_smem(int is_double, int* optin, int* static_bytes) {
  int device = 0;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, pick_kernel(is_double, 0, kMaxUps));
  *static_bytes = rc == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes) : 0;
  return static_cast<int>(rc);
}

// Launches the sweep on `stream`: one block of args->threads per tile, then
// args->pad_blocks blocks for the padding; is_double selects the element type,
// poly the float32 beta = 3/5 polynomial solve. Returns a cudaError_t (0 on
// success); *smem gets the dynamic shared bytes per block.
int kinwave_sharded_launch(const ShardedArgs* args, int is_double, int poly, void* stream,
                           int* smem) {
  const ShardedArgs a = *args;
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const ShardedKernel kernel = pick_kernel(is_double, poly, a.K);
  const size_t bytes = smem_bytes(a, is_double);
  *smem = static_cast<int>(bytes);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<a.n_tiles + a.pad_blocks, a.threads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kinwave_sharded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
