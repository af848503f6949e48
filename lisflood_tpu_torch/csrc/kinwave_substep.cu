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
// Dependency structure. Chunks run in schedule order: every downstream
// target of chunk c lies in chunks c+1..c+W, and sub-step t of chunk c reads
// only sub-step t of earlier chunks. So one block walks the chunks in order
// with one thread per lane, and each thread runs all T sub-steps of its lane
// back to back; __syncthreads() separates chunks. Every lake and reservoir
// cell is chunked strictly after all of its feeders, so its inflow buffer is
// complete when its owner chunk starts and its T-deep chain runs once there,
// on one thread, before the lanes' sub-steps.
//
// Hand-over of discharge. On the TPU a one-hot matrix product scatters a
// chunk's discharge into a rotating inflow window. Here each lane instead
// gathers from its upstream lanes (at most 8 in an LDD graph) out of a ring
// of the last W+1 chunks' sub-step discharges, in the fixed order of a
// host-built table (ascending source position). The sum order is the same
// in every run, so two runs give bitwise equal results; the plain version
// sums in the same order. The ring ((W+1) x T x L x C values, 393 KB in
// float32 at C=512, T=24, L=2, W=3) is too large for a block's shared memory
// and lives in a global scratch buffer, resident in the 50 MB L2.
//
// What bounds it. The work is about 20 input rows and 9 output rows of
// n_chunks*C values (about 170 MB per model step in float32 at the
// continental size) and some 100 flops per lane, lane-row and sub-step: the
// card's bound is a fraction of a millisecond. This kernel is far from it:
// it runs on one SM of 132, and its time is the latency of the dependent
// Newton chain and of the L2 round trips of the ring, chunk after chunk.
// Parallelism across independent chunks is later work.
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

}  // namespace

// Field order and types must match _Args in ops/kinwave_substep.py.
struct SubstepArgs {
  int n_chunks, chunk, window, T, split, E, K, KE, NL, NR;
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
  // lakes: position, feeder positions (NL, 8) and weights, parameters
  const int *lk_pos, *lk_fee;
  const void *lk_fee_w, *lk_factor, *lk_factorsqr, *lk_area;
  // lake state, in/out (initialised by the caller), and the (T, NL) inflow buffer
  void *lk_st, *lk_inold, *lk_in, *lk_out, *lk_bal, *lk_level, *lk_sumin, *lk_sumout, *lk_buf;
  // reservoirs
  const int *rs_pos, *rs_fee;
  const void *rs_fee_w, *rs_tot, *rs_cons, *rs_norm, *rs_flood, *rs_nfl, *rs_nondam,
      *rs_normout, *rs_minout, *rs_do, *rs_dln, *rs_dnfl;
  void *rs_st, *rs_fill, *rs_sumin, *rs_sumout, *rs_buf;
  // (n_chunks*chunk) outputs
  void *q1, *m31, *chanq, *sumdis, *q2, *m32, *cross2, *side1, *ev_add, *trans;
  // scratch: discharge ring ((W+1), T, L, C), eva ring ((W+1), E-1, C),
  // this chunk's chanq rows (T, C), structure sideflow rows (T, C) (zeroed)
  void *qring, *ev_ring, *chanq_rows, *side;
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

// Modified Puls lake chain (lakes.py:199-263) of lake s, in its owner chunk
template <typename T>
__device__ void lake_chain(const SubstepArgs& a, int s, T* side) {
  const int C = a.chunk, NL = a.NL;
  const T dt_r = T(a.dt_routing);
  const T factor = static_cast<const T*>(a.lk_factor)[s];
  const T factorsqr = static_cast<const T*>(a.lk_factorsqr)[s];
  const T area = static_cast<const T*>(a.lk_area)[s];
  T* st_p = static_cast<T*>(a.lk_st);
  T* inold_p = static_cast<T*>(a.lk_inold);
  T* in_p = static_cast<T*>(a.lk_in);
  T* out_p = static_cast<T*>(a.lk_out);
  T* bal_p = static_cast<T*>(a.lk_bal);
  T* level_p = static_cast<T*>(a.lk_level);
  T* sumin_p = static_cast<T*>(a.lk_sumin);
  T* sumout_p = static_cast<T*>(a.lk_sumout);
  const T* buf = static_cast<const T*>(a.lk_buf);
  T st = st_p[s], inold = inold_p[s], outflow = out_p[s], bal = bal_p[s];
  T inflow_last = in_p[s], level = level_p[s], sumin = sumin_p[s], sumout = sumout_p[s];
  const int lane = a.lk_pos[s] % C;
  for (int t = 0; t < a.T; ++t) {
    const T inflow = buf[t * NL + s];
    const T lake_in = (inflow + inold) * T(0.5);
    const T si = st / dt_r - T(0.5) * outflow + lake_in;
    const T r = -factor + vsqrt(factorsqr + T(2.0) * si);
    const T out_new = r * r;
    const T q_out = out_new * dt_r;
    T st_new = (si - out_new * T(0.5)) * dt_r;
    if (st_new != st_new || st_new < T(0)) st_new = T(0);
    const T bal_new = bal + lake_in * dt_r - q_out;
    side[t * C + lane] = q_out;
    inold = inflow;
    inflow_last = inflow;
    outflow = out_new;
    st = st_new;
    bal = bal_new;
    level = st_new / area;
    sumin = sumin + inflow * dt_r;
    sumout = sumout + q_out;
  }
  st_p[s] = st;
  inold_p[s] = inold;
  in_p[s] = inflow_last;
  out_p[s] = outflow;
  bal_p[s] = bal;
  level_p[s] = level;
  sumin_p[s] = sumin;
  sumout_p[s] = sumout;
}

// rule-curve reservoir chain (reservoir.py:173-303) of reservoir s
template <typename T>
__device__ void reservoir_chain(const SubstepArgs& a, int s, T* side) {
  const int C = a.chunk, NR = a.NR;
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
  T* fill_p = static_cast<T*>(a.rs_fill);
  T* sumin_p = static_cast<T*>(a.rs_sumin);
  T* sumout_p = static_cast<T*>(a.rs_sumout);
  const T* buf = static_cast<const T*>(a.rs_buf);
  T st = st_p[s], fill = fill_p[s], sumin = sumin_p[s], sumout = sumout_p[s];
  const int lane = a.rs_pos[s] % C;
  for (int t = 0; t < a.T; ++t) {
    const T inflow = buf[t * NR + s];
    const T q_in = inflow * dt_r;
    T st_new = st + q_in;
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
    side[t * C + lane] = q_out;
    st = st_new;
    fill = f;
    sumin = sumin + q_in;
    sumout = sumout + q_out;
  }
  st_p[s] = st;
  fill_p[s] = fill;
  sumin_p[s] = sumin;
  sumout_p[s] = sumout;
}

// feeder staging: add this chunk's sub-step discharges of structure s's
// feeders into rows 1..T-1 of its inflow buffer (row t+1 = sub-step t)
template <typename T>
__device__ void stage_feeders(const int* fee, const T* fee_w, T* buf, int n, int s, int c,
                              int C, int T_, const T* chanq_rows) {
  bool any = false;
  for (int f = 0; f < kFeeders; ++f) {
    const int fp = fee[s * kFeeders + f];
    any = any || (fp >= 0 && fp / C == c);
  }
  if (!any) return;
  for (int t = 0; t + 1 < T_; ++t) {
    T acc = T(0);
    for (int f = 0; f < kFeeders; ++f) {
      const int fp = fee[s * kFeeders + f];
      if (fp >= 0 && fp / C == c) acc = acc + chanq_rows[t * C + fp % C] * fee_w[s * kFeeders + f];
    }
    buf[(t + 1) * n + s] = buf[(t + 1) * n + s] + acc;
  }
}

__device__ __forceinline__ bool owns(const int* pos, int n, int c, int C) {
  bool hit = false;
  for (int s = threadIdx.x; s < n; s += blockDim.x) hit = hit || (pos[s] / C == c);
  return hit;
}

__device__ __forceinline__ bool feeds(const int* fee, int n, int c, int C) {
  bool hit = false;
  for (int i = threadIdx.x; i < n * kFeeders; i += blockDim.x) {
    const int fp = fee[i];
    hit = hit || (fp >= 0 && fp / C == c);
  }
  return hit;
}

// SIDE: whether any of K4b's operands is present. With one instantiation
// and the terms guarded by their null pointers alone, the launch without
// them ran about 6% slower (135 against 127 ms at 2,648 chunks of 512 in
// float32 on an H100 at 700 W; `python3 chip_smoke.py --side-flag-ab`).
template <typename T, bool POLY, bool SIDE>
__global__ void __launch_bounds__(kMaxThreads) substep_kernel(const SubstepArgs a) {
  const int C = a.chunk, T_ = a.T, E = a.E;
  const int L = a.split ? 2 : 1;
  const int S = a.window + 1;
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
  T* chanq_rows = static_cast<T*>(a.chanq_rows);
  T* side = static_cast<T*>(a.side);

  for (int c = 0; c < a.n_chunks; ++c) {
    const int64_t pos = static_cast<int64_t>(c) * C + l;
    const int slot = c % S;
    const T dx = dx_p[pos];
    const T inv_dx = T(1) / dx;

    // ---- K2: open-water evaporation chain (evapowater.py:123-159)
    T eva_dt = T(0);
    if (E > 0) {
      int esrc[kMaxUps];
#pragma unroll
      for (int k = 0; k < kMaxUps; ++k) esrc[k] = k < a.KE ? a.ev_ups[k * p_pad + pos] : -1;
      T chan_m = m31_0[pos];
      const T chan_left = chan_m * T(0.1);
      T eva_add = T(0);
      for (int t = 0; t < E; ++t) {
        T up;
        if (t == 0) {
          up = static_cast<const T*>(a.ev_up0)[pos];
        } else {
          up = T(0);
#pragma unroll
          for (int k = 0; k < kMaxUps; ++k) {
            if (esrc[k] >= 0) {
              const int ss = (esrc[k] / C) % S;
              up = up + ev_ring[(static_cast<int64_t>(ss) * (E - 1) + (t - 1)) * C + esrc[k] % C];
            }
          }
        }
        const T chan_help = vmax(chan_m - up, chan_left);
        const T ev_it = vmax(up - (chan_m - chan_help), T(0));
        chan_m = chan_help;
        eva_add = eva_add + up - ev_it;
        if (t < E - 1) ev_ring[(static_cast<int64_t>(slot) * (E - 1) + t) * C + l] = ev_it;
      }
      static_cast<T*>(a.ev_add)[pos] = eva_add;
      eva_dt = eva_add * T(1.0 / a.T);
    }

    // ---- K3: structure chains, in the owner chunk, before the sub-steps
    const bool own = __syncthreads_or(owns(a.lk_pos, a.NL, c, C) || owns(a.rs_pos, a.NR, c, C));
    const bool feed = __syncthreads_or(feeds(a.lk_fee, a.NL, c, C) || feeds(a.rs_fee, a.NR, c, C));
    if (own) {
      for (int s = l; s < a.NL; s += blockDim.x)
        if (a.lk_pos[s] / C == c) lake_chain<T>(a, s, side);
      for (int s = l; s < a.NR; s += blockDim.x)
        if (a.rs_pos[s] / C == c) reservoir_chain<T>(a, s, side);
      __syncthreads();
    }

    // ---- K1 / K4a: the T sub-steps of this lane
    int src[kMaxUps];
#pragma unroll
    for (int k = 0; k < kMaxUps; ++k) {
      const int sp = k < a.K ? a.ups[k * p_pad + pos] : -1;
      // ring offset of the source lane's row 0: ((slot*T + t)*L + j)*C + lane
      src[k] = sp < 0 ? -1 : ((sp / C) % S) * T_ * L * C + sp % C;
    }
    const T adx1 = adx1_p[pos], alpha1 = alpha1_p[pos];
    const bool ischan = ischan_p[pos] != T(0);
    T sf_base = tochan[pos];
    if (SIDE && a.eva != nullptr) sf_base = sf_base - static_cast<const T*>(a.eva)[pos];
    if (E > 0) sf_base = sf_base - eva_dt;
    if (SIDE && a.wuse != nullptr) sf_base = sf_base - static_cast<const T*>(a.wuse)[pos];
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
    T sumdis = T(0);
    T* ring_c = ring + static_cast<int64_t>(slot) * T_ * L * C + l;

    for (int t = 0; t < T_; ++t) {
      T sideflow_m3 = sf_base;
      if (ramp) sideflow_m3 = sideflow_m3 + (qin_old + T(t + 1) * qdelta) / T(T_);
      if (transloss) {
        // chanq still holds the previous sub-step's discharge here
        const T trans_out = uptrans ? vpow(vpow(chanq, tp2) - tsub, tp1) : chanq;
        const T loss = (chanq - trans_out) * dt_r;
        sideflow_m3 = sideflow_m3 - loss;
        trans_acc = trans_acc + loss;
      }
      if (own) sideflow_m3 = sideflow_m3 + side[t * C + l];
      T sideflow = ischan ? sideflow_m3 * inv_dx / dt_r : T(0);
      if (sideflow != sideflow) sideflow = T(0);
      T ups1 = T(0), ups2 = T(0);
#pragma unroll
      for (int k = 0; k < kMaxUps; ++k) {
        if (src[k] >= 0) {
          const T* r = ring + src[k] + t * L * C;
          ups1 = ups1 + r[0];
          if (a.split) ups2 = ups2 + r[C];
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
        ring_c[t * C] = q;
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
        ring_c[(t * 2) * C] = qn1;
        ring_c[(t * 2 + 1) * C] = qn2;
        chanq = vmax(q1 + q2 - qlimit, T(0));
        side1 = s1;
      }
      if (feed) chanq_rows[t * C + l] = chanq;
      sumdis = sumdis + chanq;
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
    __syncthreads();

    // ---- K3: clear this chunk's structure sideflow rows; stage feeders
    if (own) {
      for (int s = l; s < a.NL; s += blockDim.x)
        if (a.lk_pos[s] / C == c)
          for (int t = 0; t < T_; ++t) side[t * C + a.lk_pos[s] % C] = T(0);
      for (int s = l; s < a.NR; s += blockDim.x)
        if (a.rs_pos[s] / C == c)
          for (int t = 0; t < T_; ++t) side[t * C + a.rs_pos[s] % C] = T(0);
    }
    if (feed) {
      for (int s = l; s < a.NL; s += blockDim.x)
        stage_feeders<T>(a.lk_fee, static_cast<const T*>(a.lk_fee_w), static_cast<T*>(a.lk_buf),
                         a.NL, s, c, C, T_, chanq_rows);
      for (int s = l; s < a.NR; s += blockDim.x)
        stage_feeders<T>(a.rs_fee, static_cast<const T*>(a.rs_fee_w), static_cast<T*>(a.rs_buf),
                         a.NR, s, c, C, T_, chanq_rows);
    }
    // the next chunk's first barrier (__syncthreads_or) orders these writes
    // before its reads
  }
}

}  // namespace

extern "C" {

// Launches the sub-step kernel on `stream`; is_double selects the element
// type, poly the float32 beta = 3/5 polynomial solve. Returns
// cudaGetLastError() (0 on success).
int kinwave_substep_launch(const SubstepArgs* args, int is_double, int poly, void* stream) {
  const SubstepArgs a = *args;
  if (a.chunk < 1 || a.chunk > kMaxThreads || a.K > kMaxUps || a.KE > kMaxUps)
    return static_cast<int>(cudaErrorInvalidValue);
  // operands that come in groups: half a group is refused
  if ((a.qin_old == nullptr) != (a.qdelta == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const bool trans = a.uptrans != nullptr;
  if ((a.tp1 != nullptr) != trans || (a.tp2 != nullptr) != trans || (a.tsub != nullptr) != trans ||
      (a.trans != nullptr) != trans || (a.eva != nullptr && a.E > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool side = a.eva != nullptr || a.wuse != nullptr || a.qin_old != nullptr || trans;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    if (side) substep_kernel<double, false, true><<<1, a.chunk, 0, st>>>(a);
    else substep_kernel<double, false, false><<<1, a.chunk, 0, st>>>(a);
  } else if (poly) {
    if (side) substep_kernel<float, true, true><<<1, a.chunk, 0, st>>>(a);
    else substep_kernel<float, true, false><<<1, a.chunk, 0, st>>>(a);
  } else {
    if (side) substep_kernel<float, false, true><<<1, a.chunk, 0, st>>>(a);
    else substep_kernel<float, false, false><<<1, a.chunk, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kinwave_substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
