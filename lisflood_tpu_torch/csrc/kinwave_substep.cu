// Channel-routing sub-step loop as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lisflood_tpu/ops/kinwave_pallas.py:
// build_substep_pallas (the pl.pallas_call at :654). One launch runs the
// whole NoRoutSteps x chunks loop of one model step:
//   K1  split-routing sub-steps (beta = 3/5 polynomial Newton in float32),
//       with every lane's discharge handed to its downstream neighbour;
//   K2  the open-water evaporation chain (max_no_eva hops with a 10% floor);
//   K3  the lake Modified-Puls and reservoir rule-curve chains, with the
//       feeder staging that fills their inflow buffers;
//   K4a the generic q-space Newton sub-step, used for double and for any
//       beta other than 3/5;
//   K4b the optional sideflow terms: evaporation computed outside the kernel,
//       water use, the inflow-hydrograph ramp and the transmission loss.
// The plain PyTorch version of the same function is
// lisflood_tpu_torch/ops/kinwave_substep.py:substep_reference.
//
// Dependency structure. The unit of work is the task (c, t): sub-step t of
// chunk c. It reads sub-step t of the chunks that c gathers from (all of them
// in c-W..c-1: every downstream and evaporation target lies 1..W chunks
// later) and sub-step t-1 of c itself. A lake or reservoir on a lane of c
// reads, at sub-step t, sub-step t-1 of its feeder lanes, which lie in
// earlier chunks (not necessarily within W). So the chunks form a pipeline
// that is T deep: while chunk c runs sub-step t, chunk c+1 can run t-1.
//
// The kernel is persistent. G blocks of C threads (one thread per lane) each
// claim the next chunk from a ticket counter (chunks go out in increasing
// order), run its evaporation chain, its T sub-steps and its epilogue, and
// claim again until the tickets run out. Blocks meet through one flag per
// chunk in global memory, progress[c]: h+1 once hop h of the chunk's
// evaporation chain is in ev_ring (h = 0..E-2; hop h reads hop h-1 of the
// chunks gathered from, so the chain is pipelined hop by hop like the
// sub-steps), then B+1+t once sub-step t's discharges are in the ring, with
// B = max(E-1, 0); B+T = finished. After the stores of a task:
// __syncthreads(), then one thread publishes the flag with st.release.gpu.
// Before a task: one thread per dependency (a host-built list per chunk,
// `deps`, at most W entries) polls with ld.acquire.gpu until the flag says
// the task's inputs are there, then __syncthreads(), then the gathers (which
// bypass L1). The chunk of a structure polls its feeder chunks (`sdep_list`)
// for their sub-step t-1 likewise.
//
// No deadlock: every dependence points to a lower chunk, tickets go out in
// increasing order, and a block holds a ticket only while it runs, so the
// lowest unfinished chunk is always held by a running block whose
// dependencies are finished. A poll that sees no progress for kStallNs traps
// (the launch then fails) instead of hanging the card.
//
// The rule for G (kinwave_substep_plan): min(co-resident blocks, n_chunks,
// 4*T), where co-resident = SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor
// of the instantiation. The pipeline is T tasks deep, chunks that do not
// depend on each other add to that, and blocks that have claimed a chunk
// ahead of its turn load its operands meanwhile; on the synthetic continental
// drainage the time falls until about 4*T blocks and is flat beyond. A launch
// that cannot have one block resident, or an explicit block count above the
// co-resident limit, is refused.
//
// Hand-over of discharge. On the TPU a one-hot matrix product scatters a
// chunk's discharge into a rotating inflow window. Here each lane instead
// gathers from its upstream lanes (at most 8 in an LDD graph) out of a ring
// of R chunks' sub-step discharges, in the fixed order of a host-built table
// (ascending source position). The sum order is the same in every run and for
// every G, so the outputs are bitwise equal; the plain version sums in the
// same order. A ring slot is T x L x C values (98 KB in float32 at C=512,
// T=24, L=2); the ring lives in global scratch, resident in the 50 MB L2.
// Chunk c writes slot c % R. With several chunks in flight the wrapper makes
// R = 2*G + W slots, and reuse is guarded: the last readers of chunk c-R's
// slot are chunks c-R+1..c-R+W, so a block starts chunk c only when
// progress[c-R..c-R+W] all say finished. Any R >= W+1 is safe under that
// guard; a larger R only makes it wait less. ev_ring is slotted the same way.
//
// Structures. A lake or reservoir is one lane of its owner chunk. That lane
// runs step t of the Modified-Puls or rule-curve chain inside task (c, t),
// with the chain's state kept in the per-structure output arrays. Its inflow
// at t = 0 is the previous model step's (lk_buf0 / rs_buf0); at t >= 1 it is
// the weighted sum of its feeders' sub-step t-1 discharges. Each feeder lane
// writes its discharge into its own slot of a table (structure, feeder slot,
// t), and the owner sums the slots in the plain version's order: per feeder
// chunk ascending an accumulator over that chunk's feeders, then buffer +
// accumulator (the host-built `fee_ord`). Host-built per-chunk lists say
// which structures a chunk owns and which of its lanes feed which slot, so
// no chunk scans the structures.
//
// What bounds it. The work is about 20 input rows and 9 output rows of
// n_chunks*C values (about 170 MB per model step in float32 at the
// continental size) and some 100 flops per lane, lane-row and sub-step: the
// card's bound is a fraction of a millisecond. The kernel is bound by the
// critical path of the task graph instead: (longest chain of dependent chunks
// + T) x (one task + one flag hop through L2). A task is the latency of two
// dependent Newton solves, the L2 round trip of the ring gathers, a block
// barrier and the flag's release/acquire.
//
// Sideflow. Per lane and sub-step t the lateral inflow is assembled in this
// order, every term but the first optional (a null operand pointer means the
// term is absent; the kernel is instantiated without any of K4b's code when
// all of them are):
//   ToChan - eva - eva_dt - wuse                 (once per lane)
//   + (qin_old + float(t+1) * qdelta) / T        (inflow ramp)
//   - loss, loss = (chanq - trans_out) * dt_routing, where uptrans != 0:
//       trans_out = (chanq**tp2 - tsub)**tp1, else trans_out = chanq
//   + side[t]                                    (lake / reservoir outflow)
// then the ischan mask and NaN -> 0. `eva` is the evaporation chain's result
// when it ran outside the kernel (never together with E > 0), `eva_dt` the
// in-kernel chain's. The transmission loss reads the PREVIOUS sub-step's
// chanq (chanq_0 at t = 0) and is summed into the output `trans`; where
// chanq**tp2 < tsub with a non-integer tp1 the loss is NaN: the sideflow then
// becomes 0 but `trans` keeps the NaN, as in the TPU kernel. Padded lanes stay
// inert with tp1 = tp2 = 1, uptrans = 0 and 0 for every other K4b operand.
//
// Arithmetic. The build uses -fmad=false so that every operation rounds
// as the plain PyTorch version's separate elementwise operations do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // one thread per lane: chunk size <= 512
constexpr int kMaxUps = 8;        // LDD: at most 8 upstream neighbours
constexpr int kFeeders = 8;       // feeder slots per structure
constexpr unsigned kPollNs = 32;  // back-off between two polls of a flag
constexpr unsigned long long kStallNs = 5000000000ull;  // a poll this long traps

}  // namespace

// Field order and types must match _Args in ops/kinwave_substep.py.
struct SubstepArgs {
  int n_chunks, chunk, window, T, split, E, K, KE, NL, NR;
  // blocks launched (G), ring slots (R), entries per chunk in `deps` (D)
  int blocks, ring, D;
  double dt_routing, beta;
  // (n_chunks*chunk) rows
  const void *tochan, *dx, *adx1, *alpha1, *ischan, *q1_0, *m31_0, *chanq_0;
  const void *adx2, *alpha2, *qlimit, *m3limit, *c2m3s, *c2qs, *q2_0, *m32_0;
  const void *ev_up0;
  // K4b, each group optional (null = absent): precomputed evaporation, water
  // use, inflow ramp (qin_old with qdelta), transmission loss (uptrans as a
  // 0/1 mask in the float type, with tp1, tp2, tsub)
  const void *eva, *wuse, *qin_old, *qdelta, *uptrans, *tp1, *tp2, *tsub;
  // (K, n_chunks*chunk) / (KE, ...) upstream source positions, -1 = none
  const int *ups, *ev_ups;
  // lakes: position, feeder positions (NL, 8) and weights, parameters, the
  // previous model step's inflow
  const int *lk_pos, *lk_fee;
  const void *lk_fee_w, *lk_factor, *lk_factorsqr, *lk_area, *lk_buf0;
  // lake state, in/out (initialised by the caller)
  void *lk_st, *lk_inold, *lk_in, *lk_out, *lk_bal, *lk_level, *lk_sumin, *lk_sumout;
  // reservoirs
  const int *rs_pos, *rs_fee;
  const void *rs_fee_w, *rs_tot, *rs_cons, *rs_norm, *rs_flood, *rs_nfl, *rs_nondam,
      *rs_normout, *rs_minout, *rs_do, *rs_dln, *rs_dnfl, *rs_buf0;
  void *rs_st, *rs_fill, *rs_sumin, *rs_sumout;
  // (n_chunks*chunk) outputs
  void *q1, *m31, *chanq, *sumdis, *q2, *m32, *cross2, *side1, *ev_add, *trans;
  // the wavefront's host-built tables (ops/kinwave_substep.py:wavefront_tables),
  // structures numbered lakes first: (n_chunks, D) chunks gathered from, -1
  // padded; per chunk (n_chunks+1 offsets into a list) the structures owned,
  // the feeder entries (slot * 512 + lane, slot = structure * 8 + feeder) and
  // the feeder chunks of the structures owned; (NL+NR, 8) each structure's
  // feeder slots in summing order, -1 padded
  const int *deps, *own_ptr, *own_list, *feed_ptr, *feed_ent, *sdep_ptr, *sdep_list, *fee_ord;
  // scratch: discharge ring (R, T, L, C), eva ring (R, E-1, C), feeder
  // discharges ((NL+NR)*8, T); progress[n_chunks] and the ticket counter
  // after it (zeroed by the caller)
  void *qring, *ev_ring, *stage;
  int *ctrl;
};

namespace {

// NaN-propagating max/min, as torch.maximum / torch.minimum
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float vpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double vpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float vabs(float a) { return fabsf(a); }
__device__ __forceinline__ double vabs(double a) { return fabs(a); }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double vsqrt(double a) { return sqrt(a); }

// exponent bit-hack estimate of x**p (kinwave_packed._root_est)
__device__ __forceinline__ float root_est(float x, float p, float c0) {
  const float f = __fadd_rn(__fmul_rn(static_cast<float>(__float_as_int(x)), p), c0);
  return __int_as_float(static_cast<int>(f));
}

// v^5 + a*v^3 = cc, v = q^(1/5) (kinwave_packed._newton_v)
__device__ __forceinline__ float newton_v(float cc, float a) {
  const float va = root_est(cc, 0.2f, static_cast<float>((1.0 - 0.2) * 1065353216.0));
  const float vb = root_est(cc / a, static_cast<float>(1.0 / 3.0),
                            static_cast<float>((1.0 - 1.0 / 3.0) * 1065353216.0));
  float v = vmin(va, vb) * 1.12f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float v2 = v * v, v3 = v2 * v, v4 = v2 * v2;
    const float g = v * v4 + a * v3 - cc;
    const float gp = 5.0f * v4 + 3.0f * a * v2;
    v = v - g / gp;
  }
  return v;
}

// q + a*q^beta = cc, reference q-space Newton (kinwave_packed._newton_unrolled)
template <typename T>
__device__ __forceinline__ T newton_q(T cc, T adx, T beta, T inv_beta, T b_minus_1) {
  constexpr int iters = sizeof(T) == 4 ? 4 : 6;
  const T tol = T(1e-12);
  const bool small = cc <= tol;
  const T c = small ? T(1) : cc;
  const T b_a_dx = beta * adx;
  const T a_pow = b_a_dx * vpow(c, b_minus_1);
  const T secant = a_pow <= T(1) ? c / (T(1) + a_pow) : c / (T(1) + vpow(a_pow, inv_beta));
  const T other = vpow((c - secant) / adx, inv_beta);
  T q = T(0.5) * (secant + other);
  T prev = T(-1);
#pragma unroll
  for (int i = 0; i < iters; ++i) {
    const T powq = vpow(q, beta);
    const T err = q + adx * powq - c;
    const bool active = (vabs(err) > tol) && (q != prev);
    const T q_next = vmax(q - err / (T(1) + b_a_dx * powq / q), tol);
    if (active) {
      prev = q;
      q = q_next;
    }
  }
  if (q == tol) q = T(0);
  return small ? T(0) : q;
}

// ---- flags between blocks

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one thread polls until *flag >= need
__device__ __forceinline__ void wait_for(const int* flag, int need) {
  if (ld_acquire(flag) >= need) return;
  const unsigned long long t0 = global_ns();
  unsigned spins = 0;
  while (ld_acquire(flag) < need) {
    __nanosleep(kPollNs);
    if ((++spins & 1023u) == 0 && global_ns() - t0 > kStallNs) __trap();
  }
}

// ---- K3: one step of a structure's chain, on the structure's own lane; the
// chain's state lives in the per-structure output arrays between steps

// Modified Puls lake step (lakes.py:199-263) of lake s; returns its outflow
template <typename T>
__device__ __noinline__ T lake_step(const SubstepArgs& a, int s, T inflow) {
  const T dt_r = T(a.dt_routing);
  const T factor = static_cast<const T*>(a.lk_factor)[s];
  const T factorsqr = static_cast<const T*>(a.lk_factorsqr)[s];
  const T area = static_cast<const T*>(a.lk_area)[s];
  T* st_p = static_cast<T*>(a.lk_st);
  T* inold_p = static_cast<T*>(a.lk_inold);
  T* out_p = static_cast<T*>(a.lk_out);
  T* bal_p = static_cast<T*>(a.lk_bal);
  T* sumin_p = static_cast<T*>(a.lk_sumin);
  T* sumout_p = static_cast<T*>(a.lk_sumout);
  const T lake_in = (inflow + inold_p[s]) * T(0.5);
  const T si = st_p[s] / dt_r - T(0.5) * out_p[s] + lake_in;
  const T r = -factor + vsqrt(factorsqr + T(2.0) * si);
  const T out_new = r * r;
  const T q_out = out_new * dt_r;
  T st_new = (si - out_new * T(0.5)) * dt_r;
  if (st_new != st_new || st_new < T(0)) st_new = T(0);
  bal_p[s] = bal_p[s] + lake_in * dt_r - q_out;
  inold_p[s] = inflow;
  static_cast<T*>(a.lk_in)[s] = inflow;
  out_p[s] = out_new;
  st_p[s] = st_new;
  static_cast<T*>(a.lk_level)[s] = st_new / area;
  sumin_p[s] = sumin_p[s] + inflow * dt_r;
  sumout_p[s] = sumout_p[s] + q_out;
  return q_out;
}

// rule-curve reservoir step (reservoir.py:173-303) of reservoir s
template <typename T>
__device__ __noinline__ T reservoir_step(const SubstepArgs& a, int s, T inflow) {
  const T dt_r = T(a.dt_routing);
  const T inv_day = T(1.0 / 86400.0);
  const T total = static_cast<const T*>(a.rs_tot)[s];
  const T cons = static_cast<const T*>(a.rs_cons)[s];
  const T norm = static_cast<const T*>(a.rs_norm)[s];
  const T flood = static_cast<const T*>(a.rs_flood)[s];
  const T nfl = static_cast<const T*>(a.rs_nfl)[s];
  const T nondam = static_cast<const T*>(a.rs_nondam)[s];
  const T normout = static_cast<const T*>(a.rs_normout)[s];
  const T minout = static_cast<const T*>(a.rs_minout)[s];
  const T delta_o = static_cast<const T*>(a.rs_do)[s];
  const T dln = static_cast<const T*>(a.rs_dln)[s];
  const T dnfl = static_cast<const T*>(a.rs_dnfl)[s];
  T* st_p = static_cast<T*>(a.rs_st);
  T* sumin_p = static_cast<T*>(a.rs_sumin);
  T* sumout_p = static_cast<T*>(a.rs_sumout);
  const T q_in = inflow * dt_r;
  T st_new = st_p[s] + q_in;
  T f = st_new / total;
  const T o1 = vmin(minout, st_new * inv_day);
  const T o2 = minout + delta_o * (f - T(2) * cons) / dln;
  const T o3a = normout;
  const T o3b = o3a + ((f - nfl) / dnfl) * (nondam - o3a);
  const T temp4 = vmin(nondam, vmax(inflow * T(1.2), o3a));
  const T o4 = vmax((f - flood - T(0.01)) * total * inv_day, temp4);
  T outflow = o1;
  if (f > T(2) * cons) outflow = o2;
  if (f > norm) outflow = o3a;
  if (f > nfl) outflow = o3b;
  if (f > flood) outflow = o4;
  const T temp = vmin(outflow, vmax(inflow, o3a));
  if ((outflow > T(1.2) * inflow) && (outflow > o3a) && (f < flood)) outflow = temp;
  T q_out = outflow * dt_r;
  q_out = vmin(q_out, st_new);
  q_out = vmax(q_out, st_new - total);
  st_new = st_new - q_out;
  f = st_new / total;
  if (f != f || f < T(0)) f = T(0);
  st_p[s] = st_new;
  static_cast<T*>(a.rs_fill)[s] = f;
  sumin_p[s] = sumin_p[s] + q_in;
  sumout_p[s] = sumout_p[s] + q_out;
  return q_out;
}

// step t of structure sg (lakes first): its inflow is the previous model
// step's at t = 0, else the feeders' sub-step t-1 discharges, summed per
// feeder chunk into an accumulator and the accumulators chunk after chunk
template <typename T>
__device__ __noinline__ T structure_step(const SubstepArgs& a, int sg, int t) {
  const bool lake = sg < a.NL;
  const int s = lake ? sg : sg - a.NL;
  T inflow;
  if (t == 0) {
    inflow = static_cast<const T*>(lake ? a.lk_buf0 : a.rs_buf0)[s];
  } else {
    const int* fee = (lake ? a.lk_fee : a.rs_fee) + s * kFeeders;
    const T* w = static_cast<const T*>(lake ? a.lk_fee_w : a.rs_fee_w) + s * kFeeders;
    const T* stage = static_cast<const T*>(a.stage) + static_cast<int64_t>(sg) * kFeeders * a.T;
    inflow = T(0);
    T acc = T(0);
    int prev = -1;
    for (int i = 0; i < kFeeders; ++i) {
      const int f = a.fee_ord[sg * kFeeders + i];
      if (f < 0) break;
      const int ch = fee[f] / a.chunk;
      if (prev >= 0 && ch != prev) {
        inflow = inflow + acc;
        acc = T(0);
      }
      prev = ch;
      acc = acc + __ldcg(stage + f * a.T + (t - 1)) * w[f];
    }
    if (prev >= 0) inflow = inflow + acc;
  }
  return lake ? lake_step<T>(a, s, inflow) : reservoir_step<T>(a, s, inflow);
}

// SIDE: whether any of K4b's operands is present (the kernel is instantiated
// without K4b's code when none is; `python3 chip_smoke.py --side-flag-ab`
// times the main-path launch against a build without the flag).
// __grid_constant__: the chain steps take the arguments by reference, which
// would otherwise copy the whole structure into every thread's local memory.
template <typename T, bool POLY, bool SIDE>
__global__ void __launch_bounds__(kMaxThreads)
    substep_kernel(const __grid_constant__ SubstepArgs a) {
  const int C = a.chunk, T_ = a.T, E = a.E, R = a.ring, D = a.D, W = a.window;
  const int L = a.split ? 2 : 1;
  // progress of a chunk: h+1 after evaporation hop h (h = 0..E-2), B+1+t after
  // sub-step t with B = max(E-1, 0); finished at B+T
  const int B = E > 1 ? E - 1 : 0;
  const int FIN = B + T_;
  const int l = threadIdx.x;
  const int64_t p_pad = static_cast<int64_t>(a.n_chunks) * C;
  const T dt_r = T(a.dt_routing);
  const T beta = T(a.beta), inv_beta = T(1.0 / a.beta), b_minus_1 = T(a.beta - 1.0);
  const T tol = T(1e-12);

  const T* tochan = static_cast<const T*>(a.tochan);
  const T* dx_p = static_cast<const T*>(a.dx);
  const T* adx1_p = static_cast<const T*>(a.adx1);
  const T* alpha1_p = static_cast<const T*>(a.alpha1);
  const T* ischan_p = static_cast<const T*>(a.ischan);
  const T* q1_0 = static_cast<const T*>(a.q1_0);
  const T* m31_0 = static_cast<const T*>(a.m31_0);
  const T* chanq_0 = static_cast<const T*>(a.chanq_0);
  T* ring = static_cast<T*>(a.qring);
  T* ev_ring = static_cast<T*>(a.ev_ring);
  T* stage = static_cast<T*>(a.stage);
  int* progress = a.ctrl;
  int* ticket = a.ctrl + a.n_chunks;
  __shared__ int claimed;

  for (;;) {
    // the barriers of the chunk's body separate this write from the reads
    if (l == 0) claimed = atomicAdd(ticket, 1);
    __syncthreads();
    const int c = claimed;
    if (c >= a.n_chunks) break;
    const int64_t pos = static_cast<int64_t>(c) * C + l;
    const int slot = c % R;
    const int* deps = a.deps + static_cast<int64_t>(c) * D;

    // ---- the lane's operands (no other chunk is read before the wait below)
    const T dx = dx_p[pos];
    const T inv_dx = T(1) / dx;
    const T adx1 = adx1_p[pos], alpha1 = alpha1_p[pos];
    const bool ischan = ischan_p[pos] != T(0);
    T sf_base = tochan[pos];
    if (SIDE && a.eva != nullptr) sf_base = sf_base - static_cast<const T*>(a.eva)[pos];
    // K4b per-sub-step terms: inflow ramp and transmission loss
    const bool ramp = SIDE && a.qin_old != nullptr;
    const bool transloss = SIDE && a.uptrans != nullptr;
    T qin_old = 0, qdelta = 0, tp1 = 1, tp2 = 1, tsub = 0, trans_acc = 0;
    bool uptrans = false;
    if (ramp) {
      qin_old = static_cast<const T*>(a.qin_old)[pos];
      qdelta = static_cast<const T*>(a.qdelta)[pos];
    }
    if (transloss) {
      uptrans = static_cast<const T*>(a.uptrans)[pos] != T(0);
      tp1 = static_cast<const T*>(a.tp1)[pos];
      tp2 = static_cast<const T*>(a.tp2)[pos];
      tsub = static_cast<const T*>(a.tsub)[pos];
    }
    T q1 = q1_0[pos], m31 = m31_0[pos], chanq = chanq_0[pos];
    T qb1 = vpow(q1, beta);
    T adx2 = 0, alpha2 = 0, qlimit = 0, m3limit = 0, c2m3s = 0, c2q_dx = 0;
    T q2 = 0, m32 = 0, qb2 = 0, q2_floor = 0, qb2_floor = 0, side1 = 0;
    if (a.split) {
      adx2 = static_cast<const T*>(a.adx2)[pos];
      alpha2 = static_cast<const T*>(a.alpha2)[pos];
      qlimit = static_cast<const T*>(a.qlimit)[pos];
      m3limit = static_cast<const T*>(a.m3limit)[pos];
      c2m3s = static_cast<const T*>(a.c2m3s)[pos];
      c2q_dx = static_cast<const T*>(a.c2qs)[pos] * inv_dx;
      q2 = static_cast<const T*>(a.q2_0)[pos];
      m32 = static_cast<const T*>(a.m32_0)[pos];
      qb2 = vpow(q2, beta);
      // lane-2 clamp floor: the values the generic path's round trip gives
      // when M3 clamps to Chan2M3Start
      qb2_floor = c2m3s * inv_dx / alpha2;
      q2_floor = vpow(qb2_floor, inv_beta);
    }
    int src[kMaxUps];
#pragma unroll
    for (int k = 0; k < kMaxUps; ++k) {
      const int sp = k < a.K ? a.ups[k * p_pad + pos] : -1;
      // ring offset of the source lane's row 0: ((slot*T + t)*L + j)*C + lane
      src[k] = sp < 0 ? -1 : ((sp / C) % R) * T_ * L * C + sp % C;
    }
    // the structure on this lane (-1: none), the slots this chunk's lanes
    // feed, the feeder chunks of the structures it owns
    const int own0 = a.own_ptr[c], own1 = a.own_ptr[c + 1];
    const int feed0 = a.feed_ptr[c], feed1 = a.feed_ptr[c + 1];
    const int sdep0 = a.sdep_ptr[c], sdep1 = a.sdep_ptr[c + 1];
    int my_sg = -1;
    for (int e = own0; e < own1; ++e) {
      const int sg = a.own_list[e];
      if ((sg < a.NL ? a.lk_pos[sg] : a.rs_pos[sg - a.NL]) == pos) my_sg = sg;
    }

    // ---- wait until the ring slot is free: chunk c-R wrote it, chunks up to
    // c-R+W read it
    for (int i = l; i <= W; i += C) {
      const int j = c - R + i;
      if (j >= 0) wait_for(progress + j, FIN);
    }
    __syncthreads();

    // ---- K2: open-water evaporation chain (evapowater.py:123-159); hop h
    // reads hop h-1 of the chunks gathered from, so each hop is a task
    if (E > 0) {
      int esrc[kMaxUps];
#pragma unroll
      for (int k = 0; k < kMaxUps; ++k) esrc[k] = k < a.KE ? a.ev_ups[k * p_pad + pos] : -1;
      T chan_m = m31;
      const T chan_left = chan_m * T(0.1);
      T eva_add = T(0);
      for (int h = 0; h < E; ++h) {
        T up;
        if (h == 0) {
          up = static_cast<const T*>(a.ev_up0)[pos];
        } else {
          for (int i = l; i < D; i += C)
            if (deps[i] >= 0) wait_for(progress + deps[i], h);
          __syncthreads();
          up = T(0);
#pragma unroll
          for (int k = 0; k < kMaxUps; ++k) {
            if (esrc[k] >= 0) {
              const int ss = (esrc[k] / C) % R;
              up = up + __ldcg(ev_ring + (static_cast<int64_t>(ss) * (E - 1) + (h - 1)) * C +
                               esrc[k] % C);
            }
          }
        }
        const T chan_help = vmax(chan_m - up, chan_left);
        const T ev_it = vmax(up - (chan_m - chan_help), T(0));
        chan_m = chan_help;
        eva_add = eva_add + up - ev_it;
        if (h < E - 1) {
          __stcg(ev_ring + (static_cast<int64_t>(slot) * (E - 1) + h) * C + l, ev_it);
          __syncthreads();
          if (l == 0) st_release(progress + c, h + 1);
        }
      }
      static_cast<T*>(a.ev_add)[pos] = eva_add;
      sf_base = sf_base - eva_add * T(1.0 / a.T);
    }
    if (SIDE && a.wuse != nullptr) sf_base = sf_base - static_cast<const T*>(a.wuse)[pos];

    // ---- K1 / K4a: the T sub-steps of this lane
    T sumdis = T(0);
    T* ring_c = ring + static_cast<int64_t>(slot) * T_ * L * C + l;

    for (int t = 0; t < T_; ++t) {
      // what needs no other chunk, while the polls below are outstanding
      T sideflow_m3 = sf_base;
      if (ramp) sideflow_m3 = sideflow_m3 + (qin_old + T(t + 1) * qdelta) / T(T_);
      if (transloss) {
        // chanq still holds the previous sub-step's discharge here
        const T trans_out = uptrans ? vpow(vpow(chanq, tp2) - tsub, tp1) : chanq;
        const T loss = (chanq - trans_out) * dt_r;
        sideflow_m3 = sideflow_m3 - loss;
        trans_acc = trans_acc + loss;
      }
      // wait for sub-step t of the chunks gathered from, and for sub-step
      // t-1 of the feeder chunks
      for (int i = l; i < D; i += C)
        if (deps[i] >= 0) wait_for(progress + deps[i], B + 1 + t);
      if (t > 0)
        for (int i = sdep0 + l; i < sdep1; i += C) wait_for(progress + a.sdep_list[i], B + t);
      __syncthreads();
      if (own1 > own0)
        sideflow_m3 = sideflow_m3 + (my_sg >= 0 ? structure_step<T>(a, my_sg, t) : T(0));
      T sideflow = ischan ? sideflow_m3 * inv_dx / dt_r : T(0);
      if (sideflow != sideflow) sideflow = T(0);
      T ups1 = T(0), ups2 = T(0);
#pragma unroll
      for (int k = 0; k < kMaxUps; ++k) {
        if (src[k] >= 0) {
          const T* r = ring + src[k] + t * L * C;
          ups1 = ups1 + __ldcg(r);
          if (a.split) ups2 = ups2 + __ldcg(r + C);
        }
      }
      if (!a.split) {
        T q;
        if constexpr (POLY) {
          const T cc = ups1 + adx1 * qb1 + sideflow * dx;
          const bool small = cc <= tol;
          const T v = newton_v(small ? T(1) : cc, adx1);
          const T v3 = v * v * v;
          qb1 = small ? T(0) : v3;
          q = small ? T(0) : v3 * v * v;
          m31 = dx * alpha1 * qb1;
          q1 = q;
        } else {
          const T cc = ups1 + adx1 * vpow(q1, beta) + sideflow * dx;
          q = newton_q(cc, adx1, beta, inv_beta, b_minus_1);
          m31 = vmax(dx * alpha1 * vpow(q, beta), T(0));
          q1 = vpow(m31 * inv_dx / alpha1, inv_beta);
        }
        __stcg(ring_c + t * C, q);
        chanq = q1;
      } else {
        // split the sideflow between the main channel and the floodplain
        const T ratio_den = m31 + m32;
        const T ratio = ratio_den > T(0) ? m31 / ratio_den : T(0);
        const bool over = (m31 + m32 - c2m3s) > m3limit;
        T s1 = over ? ratio * sideflow : sideflow;
        if (vabs(sideflow) < T(1e-7)) s1 = sideflow;
        const T s2 = sideflow - s1 + c2q_dx;
        const T lat1 = s1 * dx, lat2 = s2 * dx;
        T qn1, qn2;
        if constexpr (POLY) {
          const T cc1 = ups1 + adx1 * qb1 + lat1;
          const T cc2 = ups2 + adx2 * qb2 + lat2;
          const bool sm1 = cc1 <= tol, sm2 = cc2 <= tol;
          const T v1 = newton_v(sm1 ? T(1) : cc1, adx1);
          const T v2 = newton_v(sm2 ? T(1) : cc2, adx2);
          const T v13 = v1 * v1 * v1, v23 = v2 * v2 * v2;
          const T qbn1 = sm1 ? T(0) : v13, qbn2 = sm2 ? T(0) : v23;
          qn1 = sm1 ? T(0) : v13 * v1 * v1;
          qn2 = sm2 ? T(0) : v23 * v2 * v2;
          qb1 = qbn1;
          q1 = qn1;
          m31 = dx * alpha1 * qb1;
          const T m32r = dx * alpha2 * qbn2;
          const bool clamp2 = m32r - c2m3s < T(0);
          m32 = clamp2 ? c2m3s : m32r;
          q2 = clamp2 ? q2_floor : qn2;
          qb2 = clamp2 ? qb2_floor : qbn2;
        } else {
          const T cc1 = ups1 + adx1 * vpow(q1, beta) + lat1;
          const T cc2 = ups2 + adx2 * vpow(q2, beta) + lat2;
          qn1 = newton_q(cc1, adx1, beta, inv_beta, b_minus_1);
          qn2 = newton_q(cc2, adx2, beta, inv_beta, b_minus_1);
          m31 = vmax(dx * alpha1 * vpow(qn1, beta), T(0));
          q1 = vpow(m31 * inv_dx / alpha1, inv_beta);
          m32 = dx * alpha2 * vpow(qn2, beta);
          if (m32 - c2m3s < T(0)) m32 = c2m3s;
          q2 = vpow(m32 * inv_dx / alpha2, inv_beta);
        }
        __stcg(ring_c + (t * 2) * C, qn1);
        __stcg(ring_c + (t * 2 + 1) * C, qn2);
        chanq = vmax(q1 + q2 - qlimit, T(0));
        side1 = s1;
      }
      // feeder lanes hand sub-step t's discharge to their structures
      for (int e = feed0; e < feed1; ++e) {
        const int ent = a.feed_ent[e];
        if (ent % kMaxThreads == l)
          __stcg(stage + static_cast<int64_t>(ent / kMaxThreads) * T_ + t, chanq);
      }
      sumdis = sumdis + chanq;
      // every lane's stores before the flag: barrier, then one release store
      __syncthreads();
      if (l == 0) st_release(progress + c, B + 1 + t);
    }

    static_cast<T*>(a.q1)[pos] = q1;
    static_cast<T*>(a.m31)[pos] = m31;
    static_cast<T*>(a.chanq)[pos] = chanq;
    static_cast<T*>(a.sumdis)[pos] = sumdis;
    if (a.split) {
      static_cast<T*>(a.q2)[pos] = q2;
      static_cast<T*>(a.m32)[pos] = m32;
      // CrossSection2Area: only the final sub-step's value survives
      static_cast<T*>(a.cross2)[pos] = (m32 - c2m3s) * inv_dx;
      static_cast<T*>(a.side1)[pos] = side1;
    }
    if (transloss) static_cast<T*>(a.trans)[pos] = trans_acc;
  }
}

typedef void (*SubstepKernel)(const SubstepArgs);

SubstepKernel pick_kernel(const SubstepArgs& a, int is_double, int poly) {
  const bool side = a.eva != nullptr || a.wuse != nullptr || a.qin_old != nullptr ||
                    a.uptrans != nullptr;
  if (is_double) return side ? substep_kernel<double, false, true> : substep_kernel<double, false, false>;
  if (poly) return side ? substep_kernel<float, true, true> : substep_kernel<float, true, false>;
  return side ? substep_kernel<float, false, true> : substep_kernel<float, false, false>;
}

// blocks of a.chunk threads of this instantiation that the card holds at once
cudaError_t co_resident(const SubstepArgs& a, SubstepKernel kernel, int* limit) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, a.chunk, 0);
  *limit = sms * per_sm;
  return rc;
}

}  // namespace

extern "C" {

// The number of blocks a launch of these arguments gets by the kernel's rule,
// min(co-resident blocks, n_chunks, 4*T), in *blocks, and the co-resident
// limit in *limit. Returns a cudaError_t: cudaErrorLaunchOutOfResources when
// not one block can be resident.
int kinwave_substep_plan(const SubstepArgs* args, int is_double, int poly, int* blocks, int* limit) {
  const SubstepArgs& a = *args;
  if (a.chunk < 1 || a.chunk > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = co_resident(a, pick_kernel(a, is_double, poly), limit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (*limit < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int g = *limit;
  if (g > a.n_chunks) g = a.n_chunks;
  if (g > 4 * a.T) g = 4 * a.T;
  *blocks = g;
  return 0;
}

// Launches the sub-step kernel with args->blocks blocks on `stream`;
// is_double selects the element type, poly the float32 beta = 3/5 polynomial
// solve. Refuses a block count above the co-resident limit and a ring of
// fewer than window + 1 slots. Returns a cudaError_t (0 on success).
int kinwave_substep_launch(const SubstepArgs* args, int is_double, int poly, void* stream) {
  const SubstepArgs a = *args;
  if (a.chunk < 1 || a.chunk > kMaxThreads || a.K > kMaxUps || a.KE > kMaxUps || a.D < 1 ||
      a.ring < a.window + 1 || a.blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // operands that come in groups: half a group is refused
  if ((a.qin_old == nullptr) != (a.qdelta == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const bool trans = a.uptrans != nullptr;
  if ((a.tp1 != nullptr) != trans || (a.tp2 != nullptr) != trans || (a.tsub != nullptr) != trans ||
      (a.trans != nullptr) != trans || (a.eva != nullptr && a.E > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const SubstepKernel kernel = pick_kernel(a, is_double, poly);
  int limit = 0;
  const cudaError_t rc = co_resident(a, kernel, &limit);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (a.blocks > limit) return static_cast<int>(cudaErrorLaunchOutOfResources);
  kernel<<<a.blocks, a.chunk, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kinwave_substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
