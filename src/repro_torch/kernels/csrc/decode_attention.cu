// K3 — decode attention for Hopper (sm_90a): one query token per row
// against the KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (`_kernel`): per-row valid `lengths`, GQA (q head h reads
// kv head h // group), online softmax in f32. Rows with length 0 return
// zeros, as the Pallas kernel does.
//
// What bounds it on this card: memory. Each valid K/V row is read once and
// the arithmetic is ~2 flops per byte; at the serve path's shapes (B 4,
// S 296, 16 kv heads, head_dim 128, bf16) a launch reads ~9.7 MB of cache,
// ~2.9 us at 3.35 TB/s.
//
// Design: one block of four warps per (batch row, kv head) serves all of
// that head's `group` q heads, so each K/V row leaves memory once for the
// whole group. Warps take the valid keys round-robin; within a warp the
// lanes span head_dim, so every K/V row load is coalesced, and the q . k
// dot products reduce with shuffles. Each warp keeps (m, l, acc) per q head
// in registers; the four partial states are merged through shared memory
// at the end. Any S (no tiling constraint); keys at or beyond lengths[b]
// are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAXG = 8;   // largest GQA group one block serves

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int S, int Hq, int Hkv, int group,
              float scale) {
  constexpr int NT = DH / 32;
  __shared__ float ms[WARPS * MAXG];
  __shared__ float ls[WARPS * MAXG];
  __shared__ float as[WARPS * MAXG * DH];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  float qr[MAXG][NT];
  float m[MAXG], l[MAXG], acc[MAXG][NT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[g][t] = 0.f;
      qr[g][t] = g < group
          ? to_f32(q[((size_t)b * Hq + hk * group + g) * DH + lane + 32 * t]) * scale
          : 0.f;
    }
  }

#pragma unroll 2
  for (int s = warp; s < len; s += WARPS) {
    const size_t off = (((size_t)b * S + s) * Hkv + hk) * DH + lane;
    float kr[NT], vr[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      kr[t] = to_f32(k[off + 32 * t]);
      vr[t] = to_f32(v[off + 32 * t]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {   // warp-uniform
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) part += qr[g][t] * kr[t];
        const float sc = warp_sum(part);
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[g][t] = acc[g][t] * alpha + p * vr[t];
        m[g] = m_new;
      }
    }
  }

  // merge the per-warp partial softmax states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {
      if (lane == 0) {
        ms[warp * MAXG + g] = m[g];
        ls[warp * MAXG + g] = l[g];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
        as[(warp * MAXG + g) * DH + lane + 32 * t] = acc[g][t];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < group * DH; idx += WARPS * 32) {
    const int g = idx / DH, d = idx % DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ms[w * MAXG + g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float mw = ms[w * MAXG + g];
        const float c = mw == -INFINITY ? 0.f : expf(mw - M);
        L += ls[w * MAXG + g] * c;
        A += as[(w * MAXG + g) * DH + d] * c;
      }
    }
    const float l_safe = L == 0.f ? 1.f : L;
    store(A / l_safe, o + ((size_t)b * Hq + hk * group + g) * DH + d);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int S, int Hq, int Hkv, int group, float scale,
           cudaStream_t stream) {
  decode_kernel<T, DH><<<(unsigned)(B * Hkv), WARPS * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)o, S,
      Hq, Hkv, group, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int head_dim, const void* q, const void* k, const void* v,
              const void* lengths, void* o, int B, int S, int Hq, int Hkv,
              int group, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, B, S, Hq, Hkv, group, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, B, S, Hq, Hkv, group, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, B, S, Hq, Hkv, group, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int S, int Hq, int Hkv,
                                    int group, int head_dim, int is_bf16,
                                    float scale, void* stream) {
  if (B * Hkv == 0) return (int)cudaGetLastError();
  if (group < 1 || group > MAXG) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(head_dim, q, k, v, lengths, o, B, S, Hq,
                                    Hkv, group, scale, st);
  return launch_dh<float>(head_dim, q, k, v, lengths, o, B, S, Hq, Hkv,
                          group, scale, st);
}
