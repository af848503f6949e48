// Device helpers shared by the port's kernels, kinwave_substep.cu (the
// channel-routing sub-steps) and kinwave_sweep.cu (the overland sweep): the
// kinematic-wave Newton solves of ops/kinwave_packed.py, and, for the sub-step
// kernel's persistent blocks, the progress flags through which they meet (a
// release store after a barrier publishes a chunk; one thread polls with
// acquire loads, then a barrier, before the block reads what the flag guards).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kPollNs = 32;  // back-off between two polls of a flag
constexpr unsigned long long kStallNs = 5000000000ull;  // a poll this long traps

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

}  // namespace
