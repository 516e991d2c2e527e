// K6 — fleet telemetry reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fleet_telemetry.py::fleet_reduce
// (`_kernel`): x [n_chips, n_fields] f32 -> per-field max, min and sum over
// the chips, in one pass over the data.
//
// What bounds it on this card: at the fleet train step's shape ([64, 5],
// 1.3 KB in, 60 B out) the bytes take well under a nanosecond at
// 3.35 TB/s; the kernel is bound by launch latency. So it is one block
// (tiled over the chips when n_chips exceeds the block): each thread folds
// a strided subset of the chips for one field at a time, a warp shuffle
// and one shared-memory pass combine the partials, and thread 0 writes the
// three results. Ragged rows need no mask: a thread past the last chip
// contributes the identity (-inf, +inf, 0).
//
// NaN: jnp.max / jnp.min propagate NaN, CUDA's fmaxf / fminf drop it. The
// combine here propagates it, so a field with a NaN lane returns NaN for
// max and min (and sum), as the reference does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;   // b NaN: a > b is false -> b
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(THREADS)
fleet_reduce_kernel(const float* __restrict__ x, float* __restrict__ mx,
                    float* __restrict__ mn, float* __restrict__ sm,
                    int n_chips, int n_fields) {
  __shared__ float smx[NWARP], smn[NWARP], ssm[NWARP];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int f = 0; f < n_fields; ++f) {
    float a = -INFINITY, b = INFINITY, c = 0.f;
    for (int i = tid; i < n_chips; i += THREADS) {
      const float val = x[(size_t)i * n_fields + f];
      a = nan_max(a, val);
      b = nan_min(b, val);
      c += val;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = nan_min(b, __shfl_xor_sync(0xffffffffu, b, o));
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    if (lane == 0) {
      smx[warp] = a;
      smn[warp] = b;
      ssm[warp] = c;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NWARP; ++w) {
        a = nan_max(a, smx[w]);
        b = nan_min(b, smn[w]);
        c += ssm[w];
      }
      mx[f] = a;
      mn[f] = b;
      sm[f] = c;
    }
    __syncthreads();   // the shared partials are free for the next field
  }
}

}  // namespace

extern "C" int fleet_reduce_launch(const void* x, void* mx, void* mn,
                                   void* sm, int n_chips, int n_fields,
                                   void* stream) {
  if (n_fields == 0) return (int)cudaGetLastError();
  fleet_reduce_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)mx, (float*)mn, (float*)sm, n_chips,
      n_fields);
  return (int)cudaGetLastError();
}
