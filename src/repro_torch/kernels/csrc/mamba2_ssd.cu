// K8 — the Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py::mamba2_ssd
// (`_kernel`): per (batch row, head h of group g = h / (H / G)), with the
// [N, P] state S in f32,
//   S   = exp(dt_t * A_h) S + (dt_t * B_t) x_t^T
//   y_t = C_t . S + D_h * x_t
// in the reference's op order (decay, then the rank-one update, then
// y = C . S; D * x added to the f32 sum; y cast to x's type). x, B, C and y
// are f32 or bf16; dt, A, D and the state are f32.
//
// What bounds it on this card: at the hybrid serve path's prefill (B 4,
// T 256, 64 heads, P 64, N 64) ~5 f32 operations per state element and
// step (1.34 GFLOP, ~20 us at 67 TFLOP/s) against ~21.5 MB moved (~6.4 us),
// so operations; at decode (T = 1) the state read and written, 8.4 MB
// (~2.5 us).
//
// Design: the Pallas kernel is the chunked SSD form (three MXU matmuls per
// chunk of 128 steps) with the [N, P] state in VMEM across a sequential
// grid axis of chunks. Blocks on the card run in parallel and in no order,
// so nothing carries over between them: one block per (batch row, head)
// runs the whole time loop with the state in registers. Column p of S is
// independent of the others (y_t[p] reads only S[:, p]), so each column is
// owned by LANES = 4 lanes of one warp, N / 4 rows each (rows
// n = LANES * m + r), and y_t[p] is reduced over the four lanes with two
// shuffles. The decay is one scalar exp(dt_t * A_h) per step. Per tile of
// TT time steps the block stages (dt_t * B_t[n], C_t[n]) as one float2 per
// row, x_t and the decay in shared memory with coalesced loads; every
// column reuses them. y is staged and written a tile at a time. Any T is
// taken (the Pallas kernel needs T % min(128, T) == 0); decode runs at
// T = 1. The chunked tensor-core form is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int P = 64;                // head channel dim: state columns
constexpr int LANES = 4;             // lanes sharing one state column
constexpr int THREADS = P * LANES;   // 256: one block per (batch row, head)
constexpr int TT = 32;               // time steps staged per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
mamba2_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  const float* __restrict__ s0, T* __restrict__ y,
                  float* __restrict__ s_out,
                  int T_len, int H, int G) {
  constexpr int RPT = N / LANES;     // state rows per thread
  __shared__ float2 bc[TT][N];       // (dt_t * B_t[n], C_t[n])
  __shared__ float xs[TT][P];
  __shared__ float ys[TT][P];
  __shared__ float decay[TT];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = (tid >> 5) * (32 / LANES) + lane / LANES;   // state column
  const int r = lane % LANES;                                // row group

  const size_t sbase = (size_t)bh * N * P;
  float s[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    s[m] = s0 != nullptr ? s0[sbase + (size_t)(LANES * m + r) * P + j] : 0.f;

  const float a = A[h];
  const float d = D[h];
  const size_t xstep = (size_t)H * P;                  // one time step of x
  const size_t xbase = (size_t)b * T_len * xstep + (size_t)h * P;
  const size_t bstep = (size_t)G * N;                  // one step of B, C
  const size_t bbase = (size_t)b * T_len * bstep + (size_t)grp * N;
  const size_t dbase = (size_t)b * T_len * H + h;

  for (int t0 = 0; t0 < T_len; t0 += TT) {
    const int nt = min(TT, T_len - t0);
    for (int e = tid; e < nt * P; e += THREADS) {
      const int tt = e / P, c = e % P;
      xs[tt][c] = to_f32(x[xbase + (size_t)(t0 + tt) * xstep + c]);
    }
    for (int e = tid; e < nt * N; e += THREADS) {
      const int tt = e / N, n = e % N;
      const size_t off = bbase + (size_t)(t0 + tt) * bstep + n;
      const float dtt = dt[dbase + (size_t)(t0 + tt) * H];
      bc[tt][n] = make_float2(dtt * to_f32(Bm[off]), to_f32(Cm[off]));
    }
    if (tid < nt) decay[tid] = expf(dt[dbase + (size_t)(t0 + tid) * H] * a);
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float xj = xs[tt][j];
      const float dec = decay[tt];
      float yp = 0.f;
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const float2 q = bc[tt][LANES * m + r];
        s[m] = s[m] * dec + q.x * xj;
        yp += q.y * s[m];
      }
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (r == 0) ys[tt][j] = yp + d * xj;
    }
    __syncthreads();
    // the next tile's staging writes bc/xs/decay only; ys is rewritten
    // after the next __syncthreads, which every thread reaches after this
    // loop
    for (int e = tid; e < nt * P; e += THREADS) {
      const int tt = e / P, c = e % P;
      store(ys[tt][c], y + xbase + (size_t)(t0 + tt) * xstep + c);
    }
  }

#pragma unroll
  for (int m = 0; m < RPT; ++m)
    s_out[sbase + (size_t)(LANES * m + r) * P + j] = s[m];
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* s0, void* y,
           void* s_out, int Bt, int T_len, int H, int G,
           cudaStream_t stream) {
  mamba2_ssd_kernel<T, N><<<(unsigned)(Bt * H), THREADS, 0, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (const float*)s0, (T*)y,
      (float*)s_out, T_len, H, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, const void* D, const void* s0,
             void* y, void* s_out, int Bt, int T_len, int H, int G,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, D, s0, y, s_out, Bt, T_len, H,
                           G, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, D, s0, y, s_out, Bt, T_len, H,
                           G, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* s0, void* y, void* s_out, int Bt,
                              int T_len, int H, int G, int N, int head_dim,
                              int is_bf16, void* stream) {
  if (head_dim != P || T_len < 0 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (Bt * H == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_n<__nv_bfloat16>(N, x, dt, A, Bm, Cm, D, s0, y, s_out, Bt,
                                   T_len, H, G, st);
  return launch_n<float>(N, x, dt, A, Bm, Cm, D, s0, y, s_out, Bt, T_len, H,
                         G, st);
}
