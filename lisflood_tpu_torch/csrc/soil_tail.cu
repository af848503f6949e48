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
// Design. One thread per lane; each lane loops its own count, so a lane with
// no_subs == 1 returns after reading its count, and nothing is compacted,
// summed across lanes or read back on the host: one launch a step. The
// seepage sums are updated in place, only on the lanes that sub-step.
// Operation for operation as PyTorch computes the plain version:
// `x ** 2` is x * x, `x ** y` is pow / powf, sqrt and division are IEEE, and
// -fmad=false (ops/_build.py) keeps every product and sum rounded on its own.
//
// What bounds it. The work depends on the data: every lane reads its count
// (4 bytes), and a lane that sub-steps reads its 21 operands and 3 masks and
// writes its 3 sums; each of its no_subs - 1 sub-steps computes three
// conductivities of two pows each. Lanes of one warp with different counts
// idle while the longest runs (a lane at the cap of 100 sub-steps runs 99).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kinwave_common.cuh"

namespace {

constexpr int kThreads = 256;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) soil_tail_kernel(const __grid_constant__ SoilTailArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int ns = a.no_subs[i];
  if (ns <= 1) return;
  auto par = [&](int k) { return static_cast<const T*>(a.par[k])[i]; };
  const T wres1a = par(0), wres1b = par(1), wres2 = par(2);
  const T ws1a = par(3), ws1b = par(4), ws2 = par(5);
  const T ks1a = par(6), ks1b = par(7), ks2 = par(8);
  const T im1a = par(9), im1b = par(10), im2 = par(11);
  const T m1a = par(12), m1b = par(13), m2 = par(14);
  const bool p1a = a.psnz[0][i] != 0, p1b = a.psnz[1][i] != 0, p2 = a.psnz[2][i] != 0;
  const T dt = static_cast<const T*>(a.dt_sub)[i];
  T a1a = static_cast<const T*>(a.aw1a)[i];
  T a1b = static_cast<const T*>(a.aw1b)[i];
  T a2 = static_cast<const T*>(a.aw2)[i];
  T* out_a = static_cast<T*>(a.seep_a);
  T* out_b = static_cast<T*>(a.seep_b);
  T* out_g = static_cast<T*>(a.seep_gw);
  T sa = out_a[i], sb = out_b[i], sg = out_g[i];
  for (int k = 1; k < ns; ++k) {
    const T wt1a = a1a + wres1a;
    const T wt1b = a1b + wres1b;
    const T wt2 = a2 + wres2;
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
  }
  out_a[i] = sa;
  out_b[i] = sb;
  out_g[i] = sg;
}

}  // namespace

extern "C" {

// One launch over the args->n lanes on `stream`; is_double selects the
// element type. Returns a cudaError_t (0 on success).
int soil_tail_launch(const SoilTailArgs* args, int is_double, void* stream) {
  const SoilTailArgs a = *args;
  if (a.n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const long long grid = (a.n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    soil_tail_kernel<double><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a);
  else
    soil_tail_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* soil_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
