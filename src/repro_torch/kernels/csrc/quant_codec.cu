// K10 — blockwise symmetric int8 codec for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quant_codec.py::quantize_int8
// (`_kernel`, pallas_call at :45): x (f32 or bf16, n elements, read as
// ceil(n / block) blocks whose tail past n is zero) -> q [nblocks, block]
// int8 and scale [nblocks] f32, per block
//   absmax = max |x|                  (NaN propagates, as jnp.max)
//   scale  = absmax / 127, or 1 where absmax is not > 0 (so also for NaN)
//   q      = clip(round half to even(x / scale), -127, 127)
// Both divisions are __fdiv_rn and the rounding rintf, so the results are
// IEEE whatever the compile flags: codes and scales equal the plain version
// (and the reference's eager ops) bit for bit. A NaN element's code is 0,
// as XLA converts NaN to an integer.
//
// What bounds it on this card: bytes. Per element it reads 4 B (f32) or
// 2 B (bf16) and writes 1 + 4/block B; at the train step's largest leaf
// (530.8 M f32 elements) that is 2.66 GB, 0.795 ms at 3.35 TB/s, against
// ~10 operations per element.
//
// Design: the TPU kernel runs 32 blocks per sequential grid step in VMEM;
// here one warp takes one quantization block at a time, block / 32 elements
// per lane at lane + 32 i (loads coalesced across the warp), held in
// registers between the max and the encode, with a warp-shuffle max and no
// shared memory. A grid-stride loop with 64-bit offsets walks the blocks.
// The tail block is read with a bounds check, so the wrapper never pads a
// copy of its input. Next steps for speed: 16-byte vector loads, four codes
// packed per 32-bit store, and fusing the error-feedback add (g + r) and
// the dequantize into the same pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER_LANE = 32;     // block <= 1024
constexpr long long MAX_GRID = 132LL * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;   // b NaN: a > b is false -> b
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, long long n,
                     long long nblocks, int block) {
  const int lane = threadIdx.x & 31;
  const int per_lane = block >> 5;
  const long long stride = (long long)gridDim.x * WARPS;
  // every lane of a warp walks the same blocks, so the shuffles below see
  // the full warp
  for (long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       b < nblocks; b += stride) {
    const long long base = b * block + lane;
    float v[MAX_PER_LANE];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      if (i < per_lane) {
        const long long j = base + 32LL * i;
        v[i] = j < n ? to_f32(x[j]) : 0.f;
        amax = nan_max(amax, fabsf(v[i]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      if (i < per_lane) {
        const float r = rintf(__fdiv_rn(v[i], s));
        q[base + 32LL * i] =
            isnan(r) ? (int8_t)0
                     : (int8_t)fminf(fmaxf(r, -127.f), 127.f);
      }
    }
    if (lane == 0) scale[b] = s;
  }
}

}  // namespace

// x: n elements, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); q: nblocks *
// block int8; scale: nblocks f32. block is a multiple of 32 up to 1024 and
// n > 0 (the wrapper checks both).
extern "C" int quantize_int8_launch(const void* x, void* q, void* scale,
                                    long long n, int block, int is_bf16,
                                    void* stream) {
  const long long nblocks = (n + block - 1) / block;
  long long grid = (nblocks + WARPS - 1) / WARPS;
  if (grid > MAX_GRID) grid = MAX_GRID;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    quantize_int8_kernel<__nv_bfloat16><<<(unsigned)grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, n, nblocks,
        block);
  else
    quantize_int8_kernel<float><<<(unsigned)grid, THREADS, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)scale, n, nblocks, block);
  return (int)cudaGetLastError();
}
