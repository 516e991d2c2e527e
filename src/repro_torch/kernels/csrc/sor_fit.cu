// K1 — fused safe-operating-region fit for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fleet_telemetry.py::sor_fit
// (`_sor_fit_kernel`): the five exponentially-weighted least-squares sums
// over the `[window, n]` telemetry window, the closed-form per-lane solve,
// the usability gates and the envelope floor `v_frontier + guard`, in one
// pass.
//
// What bounds it on this card: nothing but launch latency. At the serve
// path's shapes (window 32, n = 3 rails x 64 chips) it reads ~74 KB and does
// ~10^4 flops, a fraction of a microsecond of either resource.
//
// Design: one thread per lane, looping over the window rows. Lanes are
// contiguous in `[window, n]`, so each row load of a warp is coalesced. The
// five sums stay in registers; the solve follows the exact f32 op order of
// `ref.sor_solve_reference`. The `__f*_rn` intrinsics keep nvcc from fusing
// a multiply and an add into one FMA, which would change the rounding of
// the cancelling `denom = sw*sxx - sx*sx`. Any `n` and any `window`: no
// padding is needed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// jnp.maximum semantics: a NaN operand propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void sor_fit_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ w,
                               const float* __restrict__ bound,
                               const float* __restrict__ guard,
                               int window, int n, float min_slope,
                               float min_spread_v, float conf_samples,
                               float* __restrict__ intercept_out,
                               float* __restrict__ slope_out,
                               float* __restrict__ front_out,
                               float* __restrict__ conf_out,
                               float* __restrict__ neff_out,
                               float* __restrict__ floor_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float sw = 0.f, sx = 0.f, sy = 0.f, sxx = 0.f, sxy = 0.f;
  for (int r = 0; r < window; ++r) {
    const size_t o = (size_t)r * n + i;
    const float xv = x[o], yv = y[o], wv = w[o];
    const float wx = __fmul_rn(wv, xv);
    sw = __fadd_rn(sw, wv);
    sx = __fadd_rn(sx, wx);
    sy = __fadd_rn(sy, __fmul_rn(wv, yv));
    sxx = __fadd_rn(sxx, __fmul_rn(wx, xv));
    sxy = __fadd_rn(sxy, __fmul_rn(wx, yv));
  }

  const float eps = 1e-9f;
  const float denom = __fsub_rn(__fmul_rn(sw, sxx), __fmul_rn(sx, sx));
  const float slope = __fdiv_rn(
      __fsub_rn(__fmul_rn(sw, sxy), __fmul_rn(sx, sy)), max_nan(denom, eps));
  const float sw_safe = max_nan(sw, eps);
  const float intercept =
      __fdiv_rn(__fsub_rn(sy, __fmul_rn(slope, sx)), sw_safe);
  const float mean_x = __fdiv_rn(sx, sw_safe);
  const float var_x = max_nan(
      __fsub_rn(__fdiv_rn(sxx, sw_safe), __fmul_rn(mean_x, mean_x)), 0.f);

  const bool steep = slope < -min_slope;
  const bool spread = var_x > __fmul_rn(min_spread_v, min_spread_v);
  const bool usable = steep && spread && (denom > eps);

  float v_front =
      usable ? __fdiv_rn(__fsub_rn(bound[i], intercept), slope) : 0.f;
  // jnp.clip(v, 0, 2): a NaN stays NaN
  v_front = v_front < 0.f ? 0.f : (v_front > 2.f ? 2.f : v_front);
  const float conf =
      usable ? __fsub_rn(1.f, expf(__fdiv_rn(-sw, conf_samples))) : 0.f;

  intercept_out[i] = usable ? intercept : 0.f;
  slope_out[i] = usable ? slope : 0.f;
  front_out[i] = v_front;
  conf_out[i] = conf;
  neff_out[i] = sw;
  floor_out[i] = __fadd_rn(v_front, guard[i]);
}

}  // namespace

extern "C" int sor_fit_launch(const void* x, const void* y, const void* w,
                              const void* bound, const void* guard,
                              void* intercept, void* slope, void* front,
                              void* conf, void* neff, void* floor_out,
                              int window, int n, float min_slope,
                              float min_spread_v, float conf_samples,
                              void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    sor_fit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)y, (const float*)w,
        (const float*)bound, (const float*)guard, window, n, min_slope,
        min_spread_v, conf_samples, (float*)intercept, (float*)slope,
        (float*)front, (float*)conf, (float*)neff, (float*)floor_out);
  }
  return (int)cudaGetLastError();
}
