// K1 and K7 — the safe-operating-region fit for Hopper (sm_90a).
//
// K1 replaces the TPU kernel src/repro/kernels/fleet_telemetry.py::sor_fit
// (`_sor_fit_kernel`): the five exponentially-weighted least-squares sums
// over the `[window, n]` telemetry window, the closed-form per-lane solve,
// the usability gates and the envelope floor `v_frontier + guard`, in one
// pass. It has two entry points: `sor_fit_launch`, the TPU kernel's own
// interface (x, y, w in device memory), and `sor_refit_launch`, the whole
// refit on cadence of `core/sor.update_estimate`: it reads the history ring
// as it stands (v, obs, valid, age_s and the host's write cursor), forms
// x, y and w in `ref.sor_fit_inputs`' op order, sums, solves, gates, and
// blends the fit into the old estimate in `ref.sor_blend_reference`'s op
// order, writing the five new estimate fields.
//
// K7 replaces src/repro/kernels/fleet_telemetry.py:157 `sor_accumulate`
// (`_sor_kernel` at :51): the five sums alone, Σw, Σwx, Σwy, Σwx², Σwxy,
// the first stage of the split fit that the host control path runs (the
// solve follows in tensor code). `sor_accumulate_launch` takes x, y, w;
// `sor_accumulate_ring_launch` reads the ring as the refit does.
//
// What bounds them on this card: latency. At the serve and host paths'
// shape (window 32, n = 3 rails x 64 chips = 192) K7 reads 73,728 B and
// writes 3,840 B, 0.0000232 ms at 3.35 TB/s; K1 reads ~74 KB and does ~10^4
// flops. What is left is the launch and the chain of dependent memory
// round trips inside it. A thread that walked the window's rows, consuming
// each row's loads in the same iteration, waited for up to `window` round
// trips to L2 or HBM in a row. And around the kernel, the refit's input
// preparation and its blend were ~40 more launches of tensor code a refit.
//
// Design: a CTA owns 32 lanes (one warp wide) and runs 8 warps. Each pass
// stages 32 window rows: every thread issues the loads of its four (row,
// lane) elements together, so the whole pass costs one round trip, then
// forms its rows' inputs and products and stages them in shared memory;
// warp 0 then sums each lane's products in row order. Both kernels take
// their sums from that one routine (`tile_sums`), so K7's sums are K1's
// bit for bit (the plain versions' `Tensor.sum` blocks the rows past 16
// and parts from them in the last bits). The `__f*_rn` intrinsics keep
// nvcc from contracting a multiply and an add into one FMA, which would
// change the rounding of the cancelling `denom = sw*sxx - sx*sx`. The
// solve follows the f32 op order of `ref.sor_solve_reference` as torch runs
// it on the card (a division by a Python scalar is a multiply by its f32
// reciprocal there). The refit's old estimate and bound are loaded before
// the window, beside it. Any `n` and any `window`; a window past 32 rows
// takes one pass per 32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                  // lanes a CTA
constexpr int kWarps = 8;                   // 256 threads a CTA
constexpr int kRows = 32;                   // window rows staged a pass
constexpr int kRowsPerThread = kRows / kWarps;

// torch.clamp / jnp.maximum semantics: a NaN operand propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : (v < lo ? lo : (v > hi ? hi : v));
}

// The window as the TPU kernels take it: x, y, w [rows, n].
struct Window {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ w;
  int rows, n;

  struct Raw {
    float x, y, w;
  };

  __device__ __forceinline__ Raw fetch(int r, int i) const {
    const size_t o = (size_t)r * n + i;
    return {x[o], y[o], w[o]};
  }

  __device__ __forceinline__ void prepare(const Raw& a, int, int, float& xv,
                                          float& yv, float& wv) const {
    xv = a.x;
    yv = a.y;
    wv = a.w;
  }
};

// The history ring as it stands: v, obs, valid [rows = capacity, n]
// (n = n_rails x n_chips, lane = rail * n_chips + chip), age [rows,
// n_chips]; x, y, w formed as `ref.sor_fit_inputs` forms them on the card.
struct Ring {
  const float* __restrict__ v;
  const float* __restrict__ obs;
  const uint8_t* __restrict__ valid;
  const float* __restrict__ age;
  int rows, n, n_chips, cursor, aged;
  float decay, inv_halflife;

  struct Raw {
    float v, obs, age;
    uint8_t ok;
  };

  __device__ __forceinline__ Raw fetch(int r, int i) const {
    const size_t o = (size_t)r * n + i;
    return {v[o], obs[o],
            aged ? age[(size_t)r * n_chips + i % n_chips] : 0.f, valid[o]};
  }

  __device__ __forceinline__ void prepare(const Raw& a, int r, int,
                                          float& xv, float& yv,
                                          float& wv) const {
    int rank = cursor - 1 - r;                 // 0 == newest
    if (rank < 0) rank += rows;
    // decay ** rank, times valid as a float
    float w = __fmul_rn(powf(decay, (float)rank), a.ok ? 1.f : 0.f);
    // times 0.5 ** (age / halflife), the division a reciprocal multiply
    if (aged) w = __fmul_rn(w, powf(0.5f, __fmul_rn(a.age, inv_halflife)));
    wv = w;
    xv = a.ok ? a.v : 0.f;
    // clamp(log10(clamp(obs, 1e-8)), -8, 2), where valid
    const float l =
        clamp_nan(log10f(max_nan(a.obs, (float)1e-8)), -8.f, 2.f);
    yv = a.ok ? l : 0.f;
  }
};

// The five EWLS sums of this thread's lane (warp 0; other warps' sums are
// not meaningful), over the window rows in row order, each product and
// sum rounded on its own (no FMA). Every thread of the CTA must call it.
template <class In>
__device__ __forceinline__ void tile_sums(const In& in, float (&s)[5]) {
  __shared__ float terms[5][kRows][kLanes];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int i = blockIdx.x * kLanes + lane;
  const bool live = i < in.n;
#pragma unroll
  for (int q = 0; q < 5; ++q) s[q] = 0.f;
  for (int r0 = 0; r0 < in.rows; r0 += kRows) {
    typename In::Raw raw[kRowsPerThread] = {};
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {    // the loads, together
      const int r = r0 + warp + k * kWarps;
      if (live && r < in.rows) raw[k] = in.fetch(r, i);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int rr = warp + k * kWarps, r = r0 + rr;
      if (live && r < in.rows) {
        float x, y, w;
        in.prepare(raw[k], r, i, x, y, w);
        const float wx = __fmul_rn(w, x);
        terms[0][rr][lane] = w;
        terms[1][rr][lane] = wx;
        terms[2][rr][lane] = __fmul_rn(w, y);
        terms[3][rr][lane] = __fmul_rn(wx, x);
        terms[4][rr][lane] = __fmul_rn(wx, y);
      }
    }
    __syncthreads();
    if (warp == 0 && live) {
      const int rows = min(kRows, in.rows - r0);
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int q = 0; q < 5; ++q)
          s[q] = __fadd_rn(s[q], terms[q][r][lane]);
      }
    }
    __syncthreads();
  }
}

struct Fit {
  float intercept, slope, front, conf, neff;
};

// The solve, gates and frontier of one lane in
// `ref.sor_estimate_reference`'s f32 op order.
__device__ __forceinline__ Fit ewls_solve(const float (&s)[5], float bound,
                                          float min_slope,
                                          float min_spread_v,
                                          float conf_samples) {
  const float sw = s[0], sx = s[1], sy = s[2], sxx = s[3], sxy = s[4];
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

  float front = usable ? __fdiv_rn(__fsub_rn(bound, intercept), slope) : 0.f;
  front = clamp_nan(front, 0.f, 2.f);          // jnp.clip: NaN stays NaN
  const float conf =
      usable ? __fsub_rn(1.f, expf(__fmul_rn(-sw, __fdiv_rn(1.f,
                                                            conf_samples))))
             : 0.f;
  return {usable ? intercept : 0.f, usable ? slope : 0.f, front, conf, sw};
}

template <class In>
__global__ void __launch_bounds__(kLanes* kWarps)
    sor_accumulate_kernel(In in, float* __restrict__ sw_out,
                          float* __restrict__ sx_out,
                          float* __restrict__ sy_out,
                          float* __restrict__ sxx_out,
                          float* __restrict__ sxy_out) {
  float s[5];
  tile_sums(in, s);
  const int i = blockIdx.x * kLanes + threadIdx.x;
  if (threadIdx.x >= kLanes || i >= in.n) return;
  sw_out[i] = s[0];
  sx_out[i] = s[1];
  sy_out[i] = s[2];
  sxx_out[i] = s[3];
  sxy_out[i] = s[4];
}

__global__ void __launch_bounds__(kLanes* kWarps)
    sor_fit_kernel(Window in, const float* __restrict__ bound,
                   const float* __restrict__ guard, float min_slope,
                   float min_spread_v, float conf_samples,
                   float* __restrict__ intercept_out,
                   float* __restrict__ slope_out,
                   float* __restrict__ front_out,
                   float* __restrict__ conf_out,
                   float* __restrict__ neff_out,
                   float* __restrict__ floor_out) {
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const bool mine = threadIdx.x < kLanes && i < in.n;
  float b = 0.f, g = 0.f;
  if (mine) {
    b = bound[i];
    g = guard[i];
  }
  float s[5];
  tile_sums(in, s);
  if (!mine) return;
  const Fit f = ewls_solve(s, b, min_slope, min_spread_v, conf_samples);
  intercept_out[i] = f.intercept;
  slope_out[i] = f.slope;
  front_out[i] = f.front;
  conf_out[i] = f.conf;
  neff_out[i] = f.neff;
  floor_out[i] = __fadd_rn(f.front, g);
}

struct Estimate {
  const float* __restrict__ f[5];   // intercept, slope, front, conf, n_eff
};

__global__ void __launch_bounds__(kLanes* kWarps)
    sor_refit_kernel(Ring in, Estimate old, const float* __restrict__ bound,
                     float update_gain, float min_slope, float min_spread_v,
                     float conf_samples, float* __restrict__ out) {
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const bool mine = threadIdx.x < kLanes && i < in.n;
  float o[5] = {}, b = 0.f;
  if (mine) {
#pragma unroll
    for (int k = 0; k < 5; ++k) o[k] = old.f[k][i];
    b = bound[i / in.n_chips];
  }
  float s[5];
  tile_sums(in, s);
  if (!mine) return;
  const Fit f = ewls_solve(s, b, min_slope, min_spread_v, conf_samples);
  const float fit[5] = {f.intercept, f.slope, f.front, f.conf, f.neff};
  const bool new_ok = f.conf > 0.f, old_ok = o[3] > 0.f;
  const float gain = old_ok ? update_gain : 1.f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    out[(size_t)k * in.n + i] =
        new_ok ? __fadd_rn(o[k], __fmul_rn(gain, __fsub_rn(fit[k], o[k])))
               : (old_ok ? o[k] : fit[k]);
  }
}

int blocks(int n) { return (n + kLanes - 1) / kLanes; }

Ring ring(const void* v, const void* obs, const void* valid, const void* age,
          int capacity, int n_rails, int n_chips, int cursor, int aged,
          float decay, float inv_halflife) {
  return Ring{(const float*)v, (const float*)obs, (const uint8_t*)valid,
              (const float*)age, capacity, n_rails * n_chips, n_chips,
              cursor, aged, decay, inv_halflife};
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
    const Window in{(const float*)x, (const float*)y, (const float*)w,
                    window, n};
    sor_fit_kernel<<<blocks(n), kLanes * kWarps, 0, (cudaStream_t)stream>>>(
        in, (const float*)bound, (const float*)guard, min_slope,
        min_spread_v, conf_samples, (float*)intercept, (float*)slope,
        (float*)front, (float*)conf, (float*)neff, (float*)floor_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int sor_accumulate_launch(const void* x, const void* y,
                                     const void* w, void* sw, void* sx,
                                     void* sy, void* sxx, void* sxy,
                                     int window, int n, void* stream) {
  if (n > 0) {
    const Window in{(const float*)x, (const float*)y, (const float*)w,
                    window, n};
    sor_accumulate_kernel<Window>
        <<<blocks(n), kLanes * kWarps, 0, (cudaStream_t)stream>>>(
            in, (float*)sw, (float*)sx, (float*)sy, (float*)sxx,
            (float*)sxy);
  }
  return (int)cudaGetLastError();
}

extern "C" int sor_accumulate_ring_launch(
    const void* v, const void* obs, const void* valid, const void* age,
    void* sw, void* sx, void* sy, void* sxx, void* sxy, int capacity,
    int n_rails, int n_chips, int cursor, int aged, float decay,
    float inv_halflife, void* stream) {
  const Ring in = ring(v, obs, valid, age, capacity, n_rails, n_chips,
                       cursor, aged, decay, inv_halflife);
  if (in.n > 0) {
    sor_accumulate_kernel<Ring>
        <<<blocks(in.n), kLanes * kWarps, 0, (cudaStream_t)stream>>>(
            in, (float*)sw, (float*)sx, (float*)sy, (float*)sxx,
            (float*)sxy);
  }
  return (int)cudaGetLastError();
}

extern "C" int sor_refit_launch(
    const void* v, const void* obs, const void* valid, const void* age,
    const void* old_intercept, const void* old_slope, const void* old_front,
    const void* old_conf, const void* old_neff, const void* bound, void* out,
    int capacity, int n_rails, int n_chips, int cursor, int aged,
    float decay, float inv_halflife, float update_gain, float min_slope,
    float min_spread_v, float conf_samples, void* stream) {
  const Ring in = ring(v, obs, valid, age, capacity, n_rails, n_chips,
                       cursor, aged, decay, inv_halflife);
  const Estimate old{{(const float*)old_intercept, (const float*)old_slope,
                      (const float*)old_front, (const float*)old_conf,
                      (const float*)old_neff}};
  if (in.n > 0) {
    sor_refit_kernel<<<blocks(in.n), kLanes * kWarps, 0,
                       (cudaStream_t)stream>>>(
        in, old, (const float*)bound, update_gain, min_slope, min_spread_v,
        conf_samples, (float*)out);
  }
  return (int)cudaGetLastError();
}
