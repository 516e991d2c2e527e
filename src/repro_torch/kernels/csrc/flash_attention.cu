// K2 — flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fwd
// (`_fwd_kernel`): online-softmax attention with a causal / sliding-window
// mask and GQA (q head h reads kv head h // group), emitting the output in
// q's dtype and the f32 log-sum-exp for the backward pass.
//
// What bounds it on this card: at the prefill shapes of the serve path
// (B 4, T 256, 48 q / 16 kv heads, head_dim 128, bf16) the function moves
// ~34 MB (~10 us at 3.35 TB/s) and does ~3.2 GFLOP of causal products
// (~3 us at the 989 TFLOP/s bf16 tensor-core rate), so the least time is set
// by memory. This first kernel computes its two products with f32 FMAs, not
// tensor cores, so in practice it is bound by the FMA and shared-memory
// issue rate; wgmma/TMA tiles are later work.
//
// Design: one block of four warps per (batch, q head, 64-row q tile). The
// scaled q tile is staged once in shared memory as f32; the loop walks
// 32-key tiles of K and V staged in shared memory, and skips tiles that the
// causal or window mask empties entirely. Each warp owns 16 q rows, each
// lane one key of the tile for the scores and head_dim/32 output columns
// for the accumulator, so m, l and acc live in registers in f32. Ragged T
// and S tails are masked here, so prompts of any length are taken.
// Inputs are f32 or bf16, head_dim 32, 64 or 128, layout [B, T, H, Dh].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;             // q rows per block
constexpr int BK = 32;             // keys per kv tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;   // q rows per warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
constexpr size_t smem_floats() {
  // q tile, padded K tile, V tile, per-warp probabilities
  return (size_t)BQ * DH + (size_t)BK * (DH + 4) + (size_t)BK * DH +
         (size_t)WARPS * ROWS * BK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int S, int Hq, int Hkv,
                 int group, int causal, int window, float scale) {
  constexpr int NT = DH / 32;     // accumulator columns per lane
  constexpr int KST = DH + 4;     // K row stride: conflict-free float4 reads
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][DH]
  float* Ks = Qs + BQ * DH;       // [BK][KST]
  float* Vs = Ks + BK * KST;      // [BK][DH]
  float* Ps = Vs + BK * DH;       // [WARPS][ROWS][BK]

  const int n_qt = (Tq + BQ - 1) / BQ;
  int bid = blockIdx.x;
  const int qt = bid % n_qt;
  bid /= n_qt;
  const int h = bid % Hq;
  const int b = bid / Hq;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = qt * BQ;
  const int rbase = warp * ROWS;

  for (int idx = tid; idx < BQ * DH; idx += WARPS * 32) {
    const int r = idx / DH, d = idx % DH;
    const int t = q0 + r;
    float val = 0.f;
    if (t < Tq) val = to_f32(q[(((size_t)b * Tq + t) * Hq + h) * DH + d]) * scale;
    Qs[idx] = val;
  }

  // kv tiles that some row of this q tile can see
  int kv_end = S;
  int kv_begin = 0;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) kv_begin = max(0, q0 - window + 1) / BK * BK;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }
  float* prow = Ps + warp * ROWS * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed; q is staged
    for (int idx = tid; idx < BK * DH; idx += WARPS * 32) {
      const int r = idx / DH, d = idx % DH;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Hkv + hk) * DH + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * KST + d] = kx;
      Vs[r * DH + d] = vx;
    }
    __syncthreads();

    // scores of this warp's rows against the lane's key
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KST;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(Qs + (rbase + r) * DH + d);
        s[r] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      }
    }

    // online softmax, one row at a time (m and l are warp-uniform)
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + rbase + r;
      bool ok = key < S;
      if (causal) {
        ok = ok && key <= row;
        if (window > 0) ok = ok && key > row - window;
      }
      const float sv = ok ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p = ok ? expf(sv - m_new) : 0.f;
        alpha = expf(m[r] - m_new);
      }
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= alpha;
      prow[r * BK + lane] = p;
    }
    __syncwarp();

    // acc += P V, four keys at a time
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][NT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < NT; ++t) vv[jj][t] = Vs[(j + jj) * DH + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + r * BK + j);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          acc[r][t] += p4.x * vv[0][t] + p4.y * vv[1][t] + p4.z * vv[2][t] +
                       p4.w * vv[3][t];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + rbase + r;
    if (row >= Tq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + (((size_t)b * Tq + row) * Hq + h) * DH;
#pragma unroll
    for (int t = 0; t < NT; ++t) store(acc[r][t] / l_safe, orow + lane + 32 * t);
    if (lane == 0) lse[((size_t)b * Hq + h) * Tq + row] = m[r] + logf(l_safe);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int S, int Hq, int Hkv, int group, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const unsigned blocks = (unsigned)((long long)B * Hq * n_qt);
  flash_fwd_kernel<T, DH><<<blocks, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Tq, S, Hq,
      Hkv, group, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int head_dim, const void* q, const void* k, const void* v,
              void* o, void* lse, int B, int Tq, int S, int Hq, int Hkv,
              int group, int causal, int window, float scale,
              cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Tq, S, Hq, Hkv, group, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Tq, S, Hq, Hkv, group, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Tq, S, Hq, Hkv, group,
                            causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Tq, int S, int Hq, int Hkv, int group,
                                   int head_dim, int is_bf16, int causal,
                                   int window, float scale, void* stream) {
  if ((long long)B * Hq * Tq == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(head_dim, q, k, v, o, lse, B, Tq, S, Hq,
                                    Hkv, group, causal, window, scale, st);
  return launch_dh<float>(head_dim, q, k, v, o, lse, B, Tq, S, Hq, Hkv, group,
                          causal, window, scale, st);
}
