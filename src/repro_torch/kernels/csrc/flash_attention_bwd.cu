// K4, K5 — the flash-attention backward on f32 FMAs, for the f32 path and
// bf16 at head_dim 32; the entry points at the end of this file send bf16 at
// head_dim 64 and 128 to the tensor-core kernels of
// `flash_attention_bwd_sm90.cu`.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py::_bwd:
//   K4 `_bwd_dq_kernel`:  dq = scale * sum_kv ds k
//   K5 `_bwd_dkv_kernel`: dv = sum_q p^T do, dk = sum_q ds^T (q * scale),
//                         summed over the q tiles and the GQA group,
// with p = exp(s - lse) recomputed from the forward's saved log-sum-exp
// (p is never stored) and ds = p * (do v^T - delta), delta = rowsum(o do)
// computed by the wrapper. Masks (causal, causal + sliding window, ragged T
// and S tails) are exactly K2's, so any T and S are taken.
//
// Which path reaches which kernel:
//   bf16, head_dim 64 and 128 (every full-width path: the MiniCPM-2B train
//     step, head_dim 64) -> `flash_attention_bwd_sm90.cu`, `wgmma` fed by
//     TMA, p and ds rounded to bf16 before their products;
//   f32 (the tiny configs and the f32 callers), and bf16 at head_dim 32 ->
//     the FMA kernels below. TF32 tensor cores would lose the f32 callers'
//     digits, and head_dim 32 is below the tensor-core tiles' 64-column
//     rows.
//
// What bounds the FMA kernels: memory would (at B 4, T 512, 48/48 heads x
// 64, K4 moves ~63.7 MB, ~19 us at 3.35 TB/s), but they compute every
// product with f32 FMAs on shared-memory tiles (67 TFLOP/s at most, not
// the tensor cores' 989), so in practice f32 FMA and shared-memory
// instruction throughput bound them: the paths that reach them are small.
//
// Design. The Pallas kernels walk a sequential grid axis and carry their
// sums in VMEM scratch; on Hopper blocks run in parallel, so each block
// owns one output tile and walks the other axis in a loop:
//   K4: one block of four warps per (batch, q head, 64-row q tile) walks
//       the 32-key K/V tiles up to the causal diagonal (from the window's
//       start); each warp owns 16 q rows, each lane one key of the tile for
//       s and dp, then head_dim/32 columns of the dq tile, which stays in
//       registers in f32 and is written once.
//   K5: one block of four warps per (batch, kv head, 32-key kv tile) keeps
//       its K/V tile in shared memory and walks the group members x the
//       64-row q tiles from the diagonal on. Phase 1 (warp = 16 rows, lane
//       = key) writes p and ds for the tile to shared memory; phase 2
//       (warp = 8 keys, lane = head_dim/32 columns) accumulates dk and dv
//       in registers: 2 x 8 x head_dim/32 floats per thread, 64 at head_dim
//       128, which keeps the two [32, 128] f32 accumulators (32 KB) in the
//       register file instead of shared memory.
// Inputs are f32 at head_dim 32, 64 or 128 or bf16 at head_dim 32, layout
// [B, T, H, Dh] for q, do, dq and [B, S, Hkv, Dh] for k, v, dk, dv; lse and
// delta [B, Hq, T].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;             // q rows per tile
constexpr int BK = 32;             // keys per kv tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;   // q rows per warp (phase 1)
constexpr int KPW = BK / WARPS;    // keys per warp (K5 phase 2)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// the K2 mask: key in range, and under causal key <= row (> row - window)
__device__ __forceinline__ bool visible(int key, int row, int S, int Tq,
                                        int causal, int window) {
  bool ok = key < S && row < Tq;
  if (causal) {
    ok = ok && key <= row;
    if (window > 0) ok = ok && key > row - window;
  }
  return ok;
}

// stage a [rows, DH] tile of a [B, T, H, DH] tensor as f32 (times `mul`),
// rows at or past `limit` as zeros
template <typename T, int DH, int STRIDE>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int t0,
                                      int rows, int limit, int H, int h,
                                      float mul) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += WARPS * 32) {
    const int r = idx / DH, d = idx % DH;
    const int t = t0 + r;
    float val = 0.f;
    if (t < limit) val = to_f32(src[(((size_t)b * limit + t) * H + h) * DH + d]) * mul;
    dst[r * STRIDE + d] = val;
  }
}

template <int DH>
constexpr size_t dq_smem_floats() {
  // q tile, do tile, padded K and V tiles, per-warp ds rows
  return 2 * (size_t)BQ * DH + 2 * (size_t)BK * (DH + 4) +
         (size_t)WARPS * ROWS * BK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int S, int Hq, int Hkv, int group, int causal,
                    int window, float scale) {
  constexpr int NT = DH / 32;     // dq columns per lane
  constexpr int KST = DH + 4;     // K/V row stride: conflict-free float4 reads
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][DH], scaled
  float* Ds = Qs + BQ * DH;       // [BQ][DH], do
  float* Ks = Ds + BQ * DH;       // [BK][KST]
  float* Vs = Ks + BK * KST;      // [BK][KST]
  float* Ss = Vs + BK * KST;      // [WARPS][ROWS][BK], ds

  const int n_qt = (Tq + BQ - 1) / BQ;
  int bid = blockIdx.x;
  const int qt = bid % n_qt;
  bid /= n_qt;
  const int h = bid % Hq;
  const int b = bid / Hq;
  const int hk = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * BQ;
  const int rbase = warp * ROWS;

  stage<T, DH, DH>(Qs, q, b, q0, BQ, Tq, Hq, h, scale);
  stage<T, DH, DH>(Ds, dout, b, q0, BQ, Tq, Hq, h, 1.f);
  float lse_r[ROWS], delta_r[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + rbase + r;
    const size_t off = ((size_t)b * Hq + h) * Tq + row;
    lse_r[r] = row < Tq ? lse[off] : 0.f;
    delta_r[r] = row < Tq ? delta[off] : 0.f;
  }

  int kv_end = S;
  int kv_begin = 0;
  if (causal) {
    kv_end = min(S, q0 + BQ);
    if (window > 0) kv_begin = max(0, q0 - window + 1) / BK * BK;
  }

  float acc[ROWS][NT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  float* srow = Ss + warp * ROWS * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed; q and do are staged
    for (int idx = threadIdx.x; idx < BK * DH; idx += WARPS * 32) {
      const int r = idx / DH, d = idx % DH;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Hkv + hk) * DH + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * KST + d] = kx;
      Vs[r * KST + d] = vx;
    }
    __syncthreads();

    // s = q k and dp = do v for this warp's rows against the lane's key
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    const float* krow = Ks + lane * KST;
    const float* vrow = Vs + lane * KST;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
      const float4 v4 = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        s[r] += dot4(*reinterpret_cast<const float4*>(Qs + (rbase + r) * DH + d), k4);
        dp[r] += dot4(*reinterpret_cast<const float4*>(Ds + (rbase + r) * DH + d), v4);
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + rbase + r;
      const float p = visible(key, row, S, Tq, causal, window)
                          ? expf(s[r] - lse_r[r]) : 0.f;
      srow[r * BK + lane] = p * (dp[r] - delta_r[r]);
    }
    __syncwarp();

    // acc += ds K, four keys at a time
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float kk[4][NT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < NT; ++t) kk[jj][t] = Ks[(j + jj) * KST + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 d4 = *reinterpret_cast<const float4*>(srow + r * BK + j);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          acc[r][t] += d4.x * kk[0][t] + d4.y * kk[1][t] + d4.z * kk[2][t] +
                       d4.w * kk[3][t];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + rbase + r;
    if (row >= Tq) continue;
    T* drow = dq + (((size_t)b * Tq + row) * Hq + h) * DH;
#pragma unroll
    for (int t = 0; t < NT; ++t) store(acc[r][t] * scale, drow + lane + 32 * t);
  }
}

template <int DH>
constexpr size_t dkv_smem_floats() {
  // padded K and V tiles, q and do tiles, p and ds, lse and delta
  return 2 * (size_t)BK * (DH + 4) + 2 * (size_t)BQ * DH +
         2 * (size_t)BQ * BK + 2 * (size_t)BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int S, int Hq, int Hkv,
                     int group, int causal, int window, float scale) {
  constexpr int NT = DH / 32;     // accumulator columns per lane
  constexpr int KST = DH + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [BK][KST]
  float* Vs = Ks + BK * KST;      // [BK][KST]
  float* Qs = Vs + BK * KST;      // [BQ][DH], scaled
  float* Ds = Qs + BQ * DH;       // [BQ][DH], do
  float* Ps = Ds + BQ * DH;       // [BQ][BK], p
  float* Gs = Ps + BQ * BK;       // [BQ][BK], ds
  float* Ls = Gs + BQ * BK;       // [BQ], lse
  float* Es = Ls + BQ;            // [BQ], delta

  const int n_kt = (S + BK - 1) / BK;
  int bid = blockIdx.x;
  const int kt = bid % n_kt;
  bid /= n_kt;
  const int hk = bid % Hkv;
  const int b = bid / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = kt * BK;
  const int rbase = warp * ROWS;
  const int kbase = warp * KPW;

  stage<T, DH, KST>(Ks, k, b, k0, BK, S, Hkv, hk, 1.f);
  stage<T, DH, KST>(Vs, v, b, k0, BK, S, Hkv, hk, 1.f);

  // q tiles that some row of can see a key of this tile
  int q_begin = 0, q_end = Tq;
  if (causal) {
    q_begin = k0 / BQ * BQ;
    if (window > 0) q_end = min(Tq, k0 + BK - 1 + window);
  }

  float adk[KPW][NT], adv[KPW][NT];
#pragma unroll
  for (int j = 0; j < KPW; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) adk[j][t] = adv[j][t] = 0.f;
  const float* krow = Ks + lane * KST;
  const float* vrow = Vs + lane * KST;
  const int key = k0 + lane;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the previous q tile is consumed; K/V are staged
      stage<T, DH, DH>(Qs, q, b, q0, BQ, Tq, Hq, h, scale);
      stage<T, DH, DH>(Ds, dout, b, q0, BQ, Tq, Hq, h, 1.f);
      for (int r = threadIdx.x; r < BQ; r += WARPS * 32) {
        const int row = q0 + r;
        const size_t off = ((size_t)b * Hq + h) * Tq + row;
        Ls[r] = row < Tq ? lse[off] : 0.f;
        Es[r] = row < Tq ? delta[off] : 0.f;
      }
      __syncthreads();

      // phase 1: p and ds of this warp's rows against the lane's key
      float s[ROWS], dp[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          s[r] += dot4(*reinterpret_cast<const float4*>(Qs + (rbase + r) * DH + d), k4);
          dp[r] += dot4(*reinterpret_cast<const float4*>(Ds + (rbase + r) * DH + d), v4);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = rbase + r;
        const float p = visible(key, q0 + i, S, Tq, causal, window)
                            ? expf(s[r] - Ls[i]) : 0.f;
        Ps[i * BK + lane] = p;
        Gs[i * BK + lane] = p * (dp[r] - Es[i]);
      }
      __syncthreads();

      // phase 2: dv += p^T do, dk += ds^T q over this warp's keys
      const int n_rows = min(BQ, Tq - q0);
      for (int i = 0; i < n_rows; ++i) {
        float qi[NT], di[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          qi[t] = Qs[i * DH + lane + 32 * t];
          di[t] = Ds[i * DH + lane + 32 * t];
        }
        const float4 p0 = *reinterpret_cast<const float4*>(Ps + i * BK + kbase);
        const float4 p1 = *reinterpret_cast<const float4*>(Ps + i * BK + kbase + 4);
        const float4 g0 = *reinterpret_cast<const float4*>(Gs + i * BK + kbase);
        const float4 g1 = *reinterpret_cast<const float4*>(Gs + i * BK + kbase + 4);
        const float pj[KPW] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float gj[KPW] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < KPW; ++j)
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            adv[j][t] += pj[j] * di[t];
            adk[j][t] += gj[j] * qi[t];
          }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int s = k0 + kbase + j;
    if (s >= S) continue;
    const size_t off = (((size_t)b * S + s) * Hkv + hk) * DH;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      store(adk[j][t], dk + off + lane + 32 * t);
      store(adv[j][t], dv + off + lane + 32 * t);
    }
  }
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq,
              int S, int Hq, int Hkv, int group, int causal, int window,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)B * Hq * ((Tq + BQ - 1) / BQ));
  flash_bwd_dq_kernel<T, DH><<<blocks, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, Tq, S, Hq, Hkv, group,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Tq, int S, int Hq, int Hkv, int group, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)B * Hkv * ((S + BK - 1) / BK));
  flash_bwd_dkv_kernel<T, DH><<<blocks, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Tq, S, Hq, Hkv,
      group, causal, window, scale);
  return (int)cudaGetLastError();
}

int dq_f32(int head_dim, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, int Tq, int S, int Hq, int Hkv, int group, int causal,
           int window, float scale, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return launch_dq<float, 32>(q, k, v, dout, lse, delta, dq, B, Tq, S,
                                  Hq, Hkv, group, causal, window, scale, st);
    case 64:
      return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, Tq, S,
                                  Hq, Hkv, group, causal, window, scale, st);
    case 128:
      return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, Tq, S,
                                   Hq, Hkv, group, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dkv_f32(int head_dim, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, int B, int Tq, int S, int Hq, int Hkv, int group,
            int causal, int window, float scale, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return launch_dkv<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, Tq,
                                   S, Hq, Hkv, group, causal, window, scale,
                                   st);
    case 64:
      return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, Tq,
                                   S, Hq, Hkv, group, causal, window, scale,
                                   st);
    case 128:
      return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, Tq,
                                    S, Hq, Hkv, group, causal, window, scale,
                                    st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Tq, int S,
    int Hq, int Hkv, int group, int head_dim, int causal, int window,
    float scale, void* stream);

extern "C" int flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
    int S, int Hq, int Hkv, int group, int head_dim, int causal, int window,
    float scale, void* stream);

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int Tq, int S, int Hq,
                                      int Hkv, int group, int head_dim,
                                      int is_bf16, int causal, int window,
                                      float scale, void* stream) {
  if ((long long)B * Hq * Tq == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && head_dim != 32)   // 64 and 128: the tensor-core kernel
    return flash_attention_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, B, Tq,
                                       S, Hq, Hkv, group, head_dim, causal,
                                       window, scale, stream);
  if (is_bf16)
    return launch_dq<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dq, B, Tq,
                                        S, Hq, Hkv, group, causal, window,
                                        scale, st);
  return dq_f32(head_dim, q, k, v, dout, lse, delta, dq, B, Tq, S, Hq, Hkv,
                group, causal, window, scale, st);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Tq,
                                       int S, int Hq, int Hkv, int group,
                                       int head_dim, int is_bf16, int causal,
                                       int window, float scale, void* stream) {
  if ((long long)B * Hkv * S == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && head_dim != 32)   // 64 and 128: the tensor-core kernel
    return flash_attention_bwd_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, B,
                                        Tq, S, Hq, Hkv, group, head_dim,
                                        causal, window, scale, stream);
  if (is_bf16)
    return launch_dkv<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dk, dv,
                                         B, Tq, S, Hq, Hkv, group, causal,
                                         window, scale, st);
  return dkv_f32(head_dim, q, k, v, dout, lse, delta, dk, dv, B, Tq, S, Hq,
                 Hkv, group, causal, window, scale, st);
}
