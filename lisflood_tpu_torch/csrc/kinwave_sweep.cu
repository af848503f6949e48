// The overland kinematic-wave sweep as one CUDA kernel for Hopper (sm_90a).
//
// Replaces lisflood_tpu/ops/kinwave_packed.py:_sweep (:211), an XLA lax.scan
// (not Pallas): one kinematic-wave time step over a packed schedule. Every
// position's discharge, on each of L lanes, is the Newton solution of
//   Q + adx * Q^beta = const + upstream inflow,
// the inflow being the sum of its sources' discharges, and the discharge then
// flows on to its downstream position. L lanes (the three overland runoff lanes
// Other, Forest, Direct) share the schedule, each with its own const and adx.
// The plain PyTorch version of the same function is
// lisflood_tpu_torch/ops/kinwave_packed.py:_sweep.
//
// Design: tree tiles. On the overland graph every channel cell is a pit, so the
// graph is a forest of small trees (on the 1200x1000 catchment of
// models/synthetic.write_catchment: 232,708 trees, one per channel cell, the
// largest 130 cells, at most 42 levels). The host (ops/wavefront.py:
// sweep_tiles) packs whole trees into tiles of at most `cap` positions, trees
// of like depth together, and
// sorts each tile's entries by (level, position), a level being one band of
// equal depth below the roots, so that every source lies one level below its
// target and a level's positions lie close together in the schedule. One block
// takes one tile on an ordinary grid: no dependence crosses a block, so there is
// no ticket, no flag and no co-residency rule. The block copies the tile's
// source slots and positions into shared memory with cp.async, then gathers
// const and adx by position with one 4- or 8-byte cp.async each, so that a
// thread has all its gathers in flight at once, and runs the tile level by
// level: threads stride over the (lane, entry) pairs of a level, sum the
// sources' q from shared memory in slot order (the slot rows padded to 4 or 8,
// the loads unrolled and free of branches) and solve; one __syncthreads
// separates two levels. A tile larger than the block's shared memory (sized
// for the largest tile within the cap, at most 227 KB with the kernel's static
// share) keeps q in global memory: it stores with __stcg, passes the level's
// __syncthreads, which orders the block's own global writes for the block, and
// reads with __ldcg. A launch can record, per block, its SM, its start and end
// on the global clock and its cycles to the end of staging and to its end
// (SweepArgs.trace; chip_smoke.py phase 8 reads them).

// Upstream inflow is summed in a fixed order, the order of `ups`
// (ops/wavefront.py:upstream_table, ascending source position), as the plain
// version sums it. No sum is atomic: the outputs have the same bits for every
// cap and in every run.
//
// What bounds it. The function reads const and adx once and writes q once,
// with one int32 downstream index per position: 46.6 MB on that catchment in
// float32, 0.0139 ms at 3.35 TB/s, against 0.0041 ms of float32 operations:
// bytes. The kernel runs at the latency of its levels instead. A level costs a
// Newton solve in series (six IEEE divides) plus its loads and barrier, and a
// tile runs its levels one after another (at most 42 there), so the tile with
// the most levels alone takes most of a launch, and the other tiles, a few
// resident on each SM, slow it further. Grouping trees by depth cuts the levels
// a tile runs; the cap trades tiles resident against levels per tile; the
// gathers in flight together and the branch-free inflow shorten a tile's
// staging and its levels.

// Arithmetic: -fmad=false, and the Newton solves of kinwave_common.cuh
// (through kinwave_tiles.cuh, which K6 shares), as
// ops/kinwave_packed.newton_solve: the float32 v-space polynomial at beta =
// 3/5, otherwise the q-space unrolled iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_tiles.cuh"

namespace {

constexpr int kMaxThreads = 1024;   // threads per block
constexpr int kMaxUps = 8;          // LDD: at most 8 upstream neighbours
constexpr int kStagedLevels = 255;  // level offsets of a tile kept in shared memory

}  // namespace

// Field order and types must match _SweepArgs in ops/kinwave_packed.py.
struct SweepArgs {
  // tiles, lanes per chunk (C), overland lanes (L), rows of slots (K), the
  // padded entry count up to which a tile's q lies in shared memory (n_smem),
  // threads per block
  int n_tiles, chunk, lanes, K, n_smem, threads;
  double beta;
  // (n_chunks, L, C) operands and the output q
  const void *cst, *adx;
  void* q;
  // the tile tables of ops/wavefront.py:sweep_tiles
  const int *tile_ptr, *pos, *slots, *lvl_ptr, *lvl_off;
  // null, or kTraceWords per block: where the block's time went
  unsigned long long* trace;
};

namespace {

template <typename T, bool POLY, int KU>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(const __grid_constant__ SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lvs[kStagedLevels + 1];
  const int C = a.chunk, L = a.lanes, K = a.K;
  const unsigned long long g0 = a.trace ? global_ns() : 0ull;
  const long long c0 = clock64();
  long long c_staged = 0;
  const int begin = a.tile_ptr[blockIdx.x], n_pad = a.tile_ptr[blockIdx.x + 1] - begin;
  const int* lv = a.lvl_off + a.lvl_ptr[blockIdx.x];
  const int levels = a.lvl_ptr[blockIdx.x + 1] - a.lvl_ptr[blockIdx.x] - 1;
  const int* pos = a.pos + begin;
  const int* slots = a.slots + static_cast<int64_t>(K) * begin;
  const T beta = T(a.beta), inv_beta = T(1.0 / a.beta), b_minus_1 = T(a.beta - 1.0);
  const T* cst = static_cast<const T*>(a.cst);
  const T* adx = static_cast<const T*>(a.adx);
  T* q = static_cast<T*>(a.q);
  // (chunk * L + lane) * C + position in chunk
  auto at = [C, L](int p, int j) { return (p / C * L + j) * C + p % C; };
  // the tile's level offsets, in shared memory where they fit
  const bool staged = levels <= kStagedLevels;
  if (staged)
    for (int i = threadIdx.x; i <= levels; i += blockDim.x) lvs[i] = lv[i];

  if (n_pad <= a.n_smem) {
    T* qs = reinterpret_cast<T*>(smem);                  // (L, n_pad): const, then q
    T* as = qs + L * n_pad;                              // (L, n_pad): adx
    int* ss = reinterpret_cast<int*>(as + L * n_pad);    // (KU, n_pad): slots
    int* os = ss + KU * n_pad;                           // (n_pad): positions, then q offsets
    for (int i = threadIdx.x; i < K * n_pad / 4; i += blockDim.x)
      cp_async16(ss + 4 * i, slots + 4 * i);
    for (int i = K * n_pad + threadIdx.x; i < KU * n_pad; i += blockDim.x) ss[i] = -1;
    for (int i = threadIdx.x; i < n_pad / 4; i += blockDim.x) cp_async16(os + 4 * i, pos + 4 * i);
    cp_async_wait_all();
    __syncthreads();
    // const and adx gathered by position, each value an asynchronous copy:
    // a thread has all its gathers in flight at once
    const int n = staged ? lvs[levels] : lv[levels];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int o = at(os[e], 0);
      os[e] = o;
      for (int j = 0; j < L; ++j) {
        cp_async_elem(qs + j * n_pad + e, cst + o + j * C);
        cp_async_elem(as + j * n_pad + e, adx + o + j * C);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    c_staged = clock64() - c0;
    for (int d = 0; d < levels; ++d) {
      const int lo = staged ? lvs[d] : lv[d];
      const int cnt = (staged ? lvs[d + 1] : lv[d + 1]) - lo;
      for (int i = threadIdx.x; i < L * cnt; i += blockDim.x) {
        int j, e;
        split(i, cnt, lo, j, e);
        // the sources' q summed in slot order, plus const, solved
        T* qj = qs + j * n_pad;
        const T inflow = inflow_of<KU>(ss, n_pad, e, qj);
        const T out = solve<T, POLY>(inflow + qj[e], as[j * n_pad + e], beta, inv_beta, b_minus_1);
        qj[e] = out;
        q[os[e] + j * C] = out;
      }
      __syncthreads();
    }
  } else {
    // q of this tile in global memory: the tables and operands read in place
    __syncthreads();
    for (int d = 0; d < levels; ++d) {
      const int lo = staged ? lvs[d] : lv[d];
      const int cnt = (staged ? lvs[d + 1] : lv[d + 1]) - lo;
      for (int i = threadIdx.x; i < L * cnt; i += blockDim.x) {
        int j, e;
        split(i, cnt, lo, j, e);
        T inflow = T(0);
        for (int k = 0; k < K; ++k) {
          const int s = slots[static_cast<int64_t>(k) * n_pad + e];
          if (s >= 0) inflow = inflow + __ldcg(q + at(pos[s], j));
        }
        const int o = at(pos[e], j);
        const T out = solve<T, POLY>(inflow + cst[o], adx[o], beta, inv_beta, b_minus_1);
        __stcg(q + o, out);
      }
      __syncthreads();
    }
  }
  trace_block(a.trace, g0, c0, c_staged);
}

typedef void (*SweepKernel)(const SweepArgs);

template <int KU>
SweepKernel pick_kernel_ku(int is_double, int poly) {
  if (is_double) return sweep_kernel<double, false, KU>;
  return poly ? sweep_kernel<float, true, KU> : sweep_kernel<float, false, KU>;
}

SweepKernel pick_kernel(int is_double, int poly, int K) {
  return slot_rows(K) == 4 ? pick_kernel_ku<4>(is_double, poly)
                           : pick_kernel_ku<kMaxUps>(is_double, poly);
}

// shared-memory bytes per padded entry: const/q and adx per lane, slot_rows(K)
// slots, one offset of q (ops/kinwave_packed.sweep_fit counts the same)
size_t entry_bytes(const SweepArgs& a, int is_double) {
  return 2 * static_cast<size_t>(a.lanes) * (is_double ? 8 : 4) +
         4 * static_cast<size_t>(slot_rows(a.K)) + 4;
}

bool bad_shape(const SweepArgs& a) {
  return a.chunk < 1 || a.lanes < 1 || a.K < 1 || a.K > kMaxUps || a.n_tiles < 1 ||
         a.n_smem < 0 || a.n_smem % 8 != 0 || a.threads < 32 || a.threads > kMaxThreads ||
         a.threads % 32 != 0;
}

}  // namespace

extern "C" {

// The shared memory a block of the sweep can have on the current device
// (*optin) and the kernel's static shared memory (*static_bytes): a tile's
// dynamic share must fit their difference. Returns a cudaError_t.
int kinwave_sweep_smem(int is_double, int* optin, int* static_bytes) {
  int device = 0;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, pick_kernel(is_double, 0, kMaxUps));
  *static_bytes = rc == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes) : 0;
  return static_cast<int>(rc);
}

// Launches the sweep, one block of args->threads per tile, on `stream`; is_double
// selects the element type, poly the float32 beta = 3/5 polynomial solve.
// Tiles of at most n_smem padded entries keep q in shared memory. Returns a
// cudaError_t (0 on success); *smem gets the dynamic shared bytes per block.
int kinwave_sweep_launch(const SweepArgs* args, int is_double, int poly, void* stream,
                         int* smem) {
  const SweepArgs a = *args;
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const SweepKernel kernel = pick_kernel(is_double, poly, a.K);
  const size_t bytes = entry_bytes(a, is_double) * a.n_smem;
  *smem = static_cast<int>(bytes);
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<a.n_tiles, a.threads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kinwave_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
