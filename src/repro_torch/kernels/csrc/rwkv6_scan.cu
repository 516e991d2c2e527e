// K9 — the RWKV6 ("Finch") recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// (`_kernel`): per (batch row, head), with the [Dh, Dh] key-major state S
// in f32,
//   y_t = r_t . (S + (u * k_t) v_t^T)
//   S   = diag(exp(w_t)) S + k_t v_t^T          (w_t <= 0: log-decay)
// in the reference's op order (att = S + (u k) v, then y = r . att, then
// S = S * exp(w) + k v). r, k, v and y are f32 or bf16; w, u and the state
// are f32.
//
// What bounds it on this card: at the serve path's prefill (B 4, T 256,
// 64 heads, Dh 64) ~5 f32 operations per state element and step (1.34
// GFLOP, ~20 us at 67 TFLOP/s) against ~55 MB moved (~16 us); at decode
// (T = 1) the state read and written, 8.4 MB (~2.5 us).
//
// Design: the Pallas kernel carries S in VMEM across a sequential grid
// axis of time chunks. Blocks on the card run in parallel and in no order,
// so the time loop lives inside one block per (batch row, head). Column j
// of S is independent of the others (y_t[j] reads only S[:, j]), so each
// column is owned by G = 4 lanes of one warp, sixteen rows each (rows
// i = G*m + g), held in registers; y_t[j] is reduced over the four lanes
// with two shuffles. Per tile of TT time steps the block stages
// (r_i, k_i, exp(w_i), u_i k_i) as one float4 per row, and v, in shared
// memory with coalesced loads; every column reuses them, one 16-byte
// shared load per row and step. y is staged and written a tile at a time.
// Any T is taken (no chunk constraint); decode runs at T = 1.
//
// The state is read from s0 (or zeros when s0 is null) at the start and
// written to s_out at the end, each element by the one thread that owns
// it, so s0 and s_out may be the same buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;             // head dim (key and value)
constexpr int G = 4;               // lanes sharing one state column
constexpr int RPT = DH / G;        // state rows per thread
constexpr int THREADS = DH * G;    // 256: one block per (batch row, head)
constexpr int TT = 16;             // time steps staged per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* s0,
             T* __restrict__ y, float* s_out, int T_len, int H) {
  __shared__ float4 rkeu[TT][DH];   // (r_i, k_i, exp(w_i), u_i k_i)
  __shared__ float vs[TT][DH];
  __shared__ float ys[TT][DH];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = (tid >> 5) * (32 / G) + (lane / G);   // state column
  const int g = lane % G;                              // row group

  const size_t sbase = (size_t)bh * DH * DH;
  float s[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    s[m] = s0 != nullptr ? s0[sbase + (size_t)(G * m + g) * DH + j] : 0.f;

  const size_t step = (size_t)H * DH;                  // one time step
  const size_t base = (size_t)b * T_len * step + (size_t)h * DH;
  const float* uh = u + (size_t)h * DH;

  for (int t0 = 0; t0 < T_len; t0 += TT) {
    const int nt = min(TT, T_len - t0);
    for (int e = tid; e < nt * DH; e += THREADS) {
      const int tt = e / DH, c = e % DH;
      const size_t off = base + (size_t)(t0 + tt) * step + c;
      const float kk = to_f32(k[off]);
      rkeu[tt][c] = make_float4(to_f32(r[off]), kk, expf(w[off]),
                                uh[c] * kk);
      vs[tt][c] = to_f32(v[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float yp = 0.f;
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const float4 q = rkeu[tt][G * m + g];
        const float att = s[m] + q.w * vj;
        yp += q.x * att;
        s[m] = s[m] * q.z + q.y * vj;
      }
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (g == 0) ys[tt][j] = yp;
    }
    __syncthreads();
    // the next tile's staging writes rkeu/vs only; ys is rewritten after
    // the next __syncthreads, which every thread reaches after this loop
    for (int e = tid; e < nt * DH; e += THREADS) {
      const int tt = e / DH, c = e % DH;
      store(ys[tt][c], y + base + (size_t)(t0 + tt) * step + c);
    }
  }

#pragma unroll
  for (int m = 0; m < RPT; ++m)
    s_out[sbase + (size_t)(G * m + g) * DH + j] = s[m];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int T_len,
           int H, cudaStream_t stream) {
  rwkv6_kernel<T><<<(unsigned)(B * H), THREADS, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (T*)y, (float*)s_out, T_len, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_out, int B, int T_len, int H,
                              int head_dim, int is_bf16, void* stream) {
  if (head_dim != DH || T_len < 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, T_len, H,
                                 st);
  return launch<float>(r, k, v, w, u, s0, y, s_out, B, T_len, H, st);
}
