// K4 and K5 on the bf16 path: the flash-attention backward on Hopper's
// tensor cores (sm_90a), for head_dim 64 and 128.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py::_bwd:
//   K4 `_bwd_dq_kernel`:  dq = scale * sum_kv dS K
//   K5 `_bwd_dkv_kernel`: dv = sum_q p^T dO, dk = scale * sum_q dS^T Q,
//                         summed over the q rows and the GQA group,
// with p = exp(s * scale - lse) recomputed from the forward's natural-log
// lse (p is never stored), dP = dO V^T and dS = p * (dP - delta), delta =
// rowsum(o * dO) computed by the wrapper. Masks are K2's: causal, causal +
// sliding window, ragged T and S. Layout is [B, T, H, Dh] for q, do, dq
// and [B, S, Hkv, Dh] for k, v, dk, dv; lse and delta f32 [B, Hq, T].
// `flash_attention_bwd.cu` keeps the f32 path and bf16 at head_dim 32, and
// its entry points send bf16 at head_dim 64 and 128 here.
//
// Its bound on this card is set by memory: at the MiniCPM-2B training shape
// (B 4, T = S 512, 48 q / 48 kv heads x 64, causal) K4 moves 63.7 MB
// (19.0 us at 3.35 TB/s) against 9.7 GFLOP of causal products (9.8 us at
// 989 TFLOP/s bf16), K5 76.3 MB (22.8 us) against 12.9 GFLOP (13.1 us).
// The FMA kernels that ran this path before took 0.68 and 0.91 ms on an
// H100 SXM at 700 W, bound by f32 FMA and shared-memory instructions; these run
// all four products of each on `wgmma`.
//
// Design. Each kernel runs one warpgroup (128 threads) per CTA, and each
// CTA owns its output tile: no atomics, so the results are the same bits
// from run to run. Thread 0 loads tiles by TMA into 128-byte-swizzled
// shared memory, each stage of a two-stage ring tracked by one mbarrier;
// a stage is refilled once its last `wgmma` has retired (a CTA barrier).
//   K4 (dq): one CTA per (batch, q head, 64-row q tile), the last q tiles
//     (the most K/V tiles under the causal mask) first. Q and dO are loaded
//     once, K/V tiles (64 keys at head_dim 64, 32 at 128, as K2) stream
//     through the ring from the window's start to the diagonal. Per tile:
//       S = Q K^T and dP = dO V^T: A and B K-major in shared memory;
//       p and dS on the f32 fragment (each thread holds rows lane/4 and
//         lane/4 + 8 of its warp's 16, so lse and delta are two registers),
//         dS packed to bf16 pairs as the A-register fragment;
//       dQ += dS K: K read MN-major with the transpose-B immediate (K2's
//         P V with K in V's place).
//     Registers a thread: S and dP 32 + 32 (16 + 16 at head_dim 128), dQ
//     32 (64).
//   K5 (dk, dv): one CTA per (batch, kv head, 64-key tile), the first key
//     tiles (the most q tiles under the causal mask) first. K and V are
//     loaded once; (Q, dO) tiles of 64 rows (32 at head_dim 128) stream
//     through the ring over group member x q tile, from the diagonal to the
//     window's end: the Pallas grid (B*Hkv, kv block, group, q block) with
//     its sequential axes as a loop. Per tile:
//       S^T = K Q^T and dP^T = V dO^T: A and B K-major in shared memory;
//       p^T and dS^T on the f32 fragment, whose columns are q rows, so the
//         tile's lse and delta are staged in shared memory (double
//         buffered, fetched into registers a tile ahead);
//       dV += p^T dO and dK += dS^T Q: p^T and dS^T as bf16 A-register
//         fragments, dO and Q read MN-major with transpose-B.
//     dK is scaled once in the epilogue. Registers a thread: S^T and dP^T
//     32 + 32 (16 + 16), dV and dK 32 + 32 (64 + 64): the 32-row q tile at
//     head_dim 128 keeps the four accumulators at 160 floats.
// So the four products of each kernel take only K2's two forms
// (`sm90.cuh`): K-major A and B from shared memory, and a register A with
// an MN-major B. One swizzled tile serves both of its descriptors.
//
// The trouble spots, as solved here:
// 1. Rows past T and keys past S. TMA zero-fills Q and dO past T and K and
//    V past S (4-D maps: a tile never reads the next batch row), but lse is
//    not defined there: lse and delta are staged as 0 for those rows, and
//    every tile that the causal or window mask or a ragged edge cuts masks
//    p to 0 (select, not multiply) before p or dS is used, so no inf * 0
//    reaches dK or dQ.
// 2. Rounding. p and dS are rounded to bf16 before their products, as
//    FlashAttention-2/3 and SDPA do; `tests/test_torch_kernels.py` bounds
//    that rounding against the reference's gradients at the paths' head
//    shapes.
// 3. exp2. p = 2^(s * scale * log2 e - lse * log2 e) by `ex2.approx`, with
//    log2 e folded into the scale and into the staged -lse.
// 4. Alignment. TMA needs 16-byte-aligned bases; the Python wrappers raise
//    on a q, k, v or do whose data_ptr() is not 16-byte aligned.
// 5. Empty inputs. B * Hq * T == 0 and B * Hkv * S == 0 return before any
//    launch (`flash_attention_bwd.cu`); K4 with S == 0 writes dq = 0 and K5
//    with T == 0 writes dk = dv = 0, encoding no map for the empty side.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;         // K4's q rows, K5's keys per CTA: wgmma M
constexpr int STAGES = 2;      // the streamed ring
constexpr int THREADS = 128;   // one warpgroup
constexpr int MBOX = BM * ROW_BYTES;  // one 64-column half of a 64-row tile

// K4's keys per K/V tile, as K2's: 32 at head_dim 128, 64 at 64
__host__ __device__ constexpr int dq_kv_tile(int dh) {
  return dh == 128 ? 32 : 64;
}

// K5's q rows per (Q, dO) tile: 32 at head_dim 128 keeps S^T, dP^T, dV and
// dK in registers (16 + 16 + 64 + 64 floats a thread)
__host__ __device__ constexpr int dkv_q_tile(int dh) {
  return dh == 128 ? 32 : 64;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int B, int Tq, int S,
                  int Hq, int group, int causal, int window, float scale) {
  constexpr int BK = dq_kv_tile(DH);
  constexpr int NCH = DH / HALF;        // 128-byte column halves
  constexpr int QBYTES = NCH * MBOX;    // the Q or dO tile
  constexpr int KBOX = BK * ROW_BYTES;  // one column half of a K or V tile
  constexpr int KVBYTES = NCH * KBOX;   // one K or V tile
  constexpr int NO = DH / 2;            // dQ fragment floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t dos = base + QBYTES;
  const uint32_t kv0 = base + 2 * QBYTES;  // stage s: K at kv0 + 2 s KVBYTES

  const int n_qt = (Tq + BM - 1) / BM;
  const int BH = B * Hq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heaviest tiles first
  const int h = (int)(blockIdx.x % BH) % Hq;
  const int b = (int)(blockIdx.x % BH) / Hq;
  const int hk = h / group;
  const int q0 = qt * BM;

  // the kv tiles that some row of this q tile can see
  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BM);
    if (window > 0) kv_begin = max(0, q0 - window + 1) / BK * BK;
  }
  const int n_kv = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  const CUtensorMap* kp = &kmap;   // the maps stay in parameter space
  const CUtensorMap* vp = &vmap;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto load_kv = [&](int j) {   // K/V tile j into stage j % STAGES
    const int s = j % STAGES;
    const uint32_t ks = kv0 + 2 * s * KVBYTES;
    const int key0 = kv_begin + j * BK;
    mbar_expect_tx(bar_kv(s), 2 * KVBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      tma_load(ks + c * KBOX, kp, bar_kv(s), c * HALF, hk, key0, b);
      tma_load(ks + KVBYTES + c * KBOX, vp, bar_kv(s), c * HALF, hk, key0,
               b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_kv(s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * QBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      tma_load(qs + c * MBOX, &qmap, bar_q, c * HALF, h, q0, b);
      tma_load(dos + c * MBOX, &domap, bar_q, c * HALF, h, q0, b);
    }
    for (int j = 0; j < STAGES && j < n_kv; ++j) load_kv(j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's two rows:
  const int row1 = row0 + 8;                      // row0 and row0 + 8
  const int cq = (lane & 3) * 2;   // first of its two columns in each 8
  const float scale_log2 = scale * LOG2E;
  // -lse in log2 units and delta of the two rows; 0 past T, where the
  // rows' dq is never written
  const size_t stat0 = ((size_t)b * Hq + h) * Tq;
  const float nl0 = row0 < Tq ? -lse[stat0 + row0] * LOG2E : 0.f;
  const float nl1 = row1 < Tq ? -lse[stat0 + row1] * LOG2E : 0.f;
  const float dl0 = row0 < Tq ? delta[stat0 + row0] : 0.f;
  const float dl1 = row1 < Tq ? delta[stat0 + row1] : 0.f;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const uint32_t ks = kv0 + 2 * s * KVBYTES;
    const uint32_t vs = ks + KVBYTES;
    mbar_wait(bar_kv(s), (j / STAGES) & 1);
    __syncwarp();

    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, kmajor(qs, MBOX, kk), kmajor(ks, KBOX, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dp, kmajor(dos, MBOX, kk), kmajor(vs, KBOX, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    const int key0 = kv_begin + j * BK;
    const bool edge = key0 + BK > S ||
                      (causal && (key0 + BK - 1 > q0 ||
                                  (window > 0 &&
                                   key0 <= q0 + BM - 1 - window)));
    // dS in bf16 pairs: the fragment of keys 16 kk .. 16 kk + 15 is the A
    // fragment of the kk-th k16 step of dS K
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        float p = ex2(fmaf(sc[4 * n + e], scale_log2, hi ? nl1 : nl0));
        if (edge && !visible(key0 + n * 8 + cq + (e & 1), hi ? row1 : row0,
                             S, causal, window))
          p = 0.f;
        ds[e] = p * (dp[4 * n + e] - (hi ? dl1 : dl0));
      }
      da[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
      da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, da[kk], mnmajor(ks, KBOX, kk));
    wg_commit();
    wg_wait_all();
    reg_fence(acc);

    __syncthreads();   // every wgmma reading this stage has retired
    if (tid == 0 && j + STAGES < n_kv) load_kv(j + STAGES);
  }

  if (row0 < Tq) {
    __nv_bfloat16* drow = dq + (((size_t)b * Tq + row0) * Hq + h) * DH + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8) =
          __floats2bfloat162_rn(acc[4 * n] * scale, acc[4 * n + 1] * scale);
  }
  if (row1 < Tq) {
    __nv_bfloat16* drow = dq + (((size_t)b * Tq + row1) * Hq + h) * DH + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2] * scale,
                                acc[4 * n + 3] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int B, int Tq, int S,
                   int Hkv, int group, int causal, int window, float scale) {
  constexpr int BT = dkv_q_tile(DH);
  constexpr int NCH = DH / HALF;        // 128-byte column halves
  constexpr int KBYTES = NCH * MBOX;    // the K or V tile
  constexpr int TBOX = BT * ROW_BYTES;  // one column half of a Q or dO tile
  constexpr int TBYTES = NCH * TBOX;    // one Q or dO tile
  constexpr int NO = DH / 2;            // dK, dV fragment floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  // -lse in log2 units and delta of a stage's q rows: the fragment's
  // columns
  __shared__ __align__(16) float nls[STAGES][BT];
  __shared__ __align__(16) float dls[STAGES][BT];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = base;
  const uint32_t vs = base + KBYTES;
  const uint32_t qd0 = base + 2 * KBYTES;  // stage s: Q at qd0 + 2 s TBYTES

  const int BH = B * Hkv;
  const int kt = (int)(blockIdx.x / BH);   // the first key tiles see the most
  const int hk = (int)(blockIdx.x % BH) % Hkv;   // q tiles: they go first
  const int b = (int)(blockIdx.x % BH) / Hkv;
  const int k0 = kt * BM;
  const int Hq = Hkv * group;

  // the q tiles that some row of can see a key of this tile
  int q_begin = 0, q_end = Tq;
  if (causal) {
    q_begin = k0 / BT * BT;
    if (window > 0) q_end = min(Tq, k0 + BM - 1 + window);
  }
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;
  const int n_it = group * n_qt;           // (group member, q tile) pairs

  const int tid = threadIdx.x;
  const CUtensorMap* qp = &qmap;   // the maps stay in parameter space
  const CUtensorMap* dop = &domap;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto bar_t = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto load_t = [&](int j) {   // (Q, dO) tile j into stage j % STAGES
    const int s = j % STAGES;
    const uint32_t qs = qd0 + 2 * s * TBYTES;
    const int h = hk * group + j / n_qt;
    const int q0 = q_begin + (j % n_qt) * BT;
    mbar_expect_tx(bar_t(s), 2 * TBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      tma_load(qs + c * TBOX, qp, bar_t(s), c * HALF, h, q0, b);
      tma_load(qs + TBYTES + c * TBOX, dop, bar_t(s), c * HALF, h, q0, b);
    }
  };
  // tile j's lse and delta for row `tid` (tid < BT), fetched into
  // registers a tile ahead and stored once the stage's readers are done
  float f_nl = 0.f, f_dl = 0.f;
  auto fetch = [&](int j) {
    f_nl = f_dl = 0.f;
    if (tid < BT && j < n_it) {
      const int h = hk * group + j / n_qt;
      const int row = q_begin + (j % n_qt) * BT + tid;
      if (row < Tq) {
        const size_t off = ((size_t)b * Hq + h) * Tq + row;
        f_nl = -lse[off] * LOG2E;
        f_dl = delta[off];
      }
    }
  };
  auto put = [&](int j) {
    if (tid < BT) {
      nls[j % STAGES][tid] = f_nl;
      dls[j % STAGES][tid] = f_dl;
    }
  };

  fetch(0);
  put(0);
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_t(s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * KBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      tma_load(ks + c * MBOX, &kmap, bar_kv, c * HALF, hk, k0, b);
      tma_load(vs + c * MBOX, &vmap, bar_kv, c * HALF, hk, k0, b);
    }
    for (int j = 0; j < STAGES && j < n_it; ++j) load_t(j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this thread's two keys:
  const int key1 = key0 + 8;                      // key0 and key0 + 8
  const int cq = (lane & 3) * 2;   // first of its two columns in each 8
  const float scale_log2 = scale * LOG2E;

  float adk[NO], adv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) adk[i] = adv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_it; ++j) {
    const int s = j % STAGES;
    const uint32_t qs = qd0 + 2 * s * TBYTES;
    const uint32_t dos = qs + TBYTES;   // the dO tile
    const int q0 = q_begin + (j % n_qt) * BT;
    fetch(j + 1);
    mbar_wait(bar_t(s), (j / STAGES) & 1);
    __syncwarp();

    float st[BT / 2], dpt[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) st[i] = dpt[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(st, kmajor(ks, MBOX, kk), kmajor(qs, TBOX, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dpt, kmajor(vs, MBOX, kk), kmajor(dos, TBOX, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    const bool edge = q0 + BT > Tq || k0 + BM > S ||
                      (causal && (k0 + BM - 1 > q0 ||
                                  (window > 0 &&
                                   k0 <= q0 + BT - 1 - window)));
    // p^T and dS^T in bf16 pairs: the fragment of q rows 16 kk .. 16 kk +
    // 15 is the A fragment of the kk-th k16 step of p^T dO and dS^T Q
    uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const int c = n * 8 + cq;
      const float2 nl = *reinterpret_cast<const float2*>(&nls[s][c]);
      const float2 dl = *reinterpret_cast<const float2*>(&dls[s][c]);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        p[e] = ex2(fmaf(st[4 * n + e], scale_log2, odd ? nl.y : nl.x));
        const int row = q0 + c + (e & 1);
        if (edge && !(row < Tq && visible((e & 2) ? key1 : key0, row, S,
                                          causal, window)))
          p[e] = 0.f;
        ds[e] = p[e] * (dpt[4 * n + e] - (odd ? dl.y : dl.x));
      }
      pa[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
      da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wgmma_rs(adv, pa[kk], mnmajor(dos, TBOX, kk));
      wgmma_rs(adk, da[kk], mnmajor(qs, TBOX, kk));
    }
    wg_commit();
    wg_wait_all();
    reg_fence(adv);
    reg_fence(adk);

    put(j + 1);        // stage (j + 1) % 2's stats were last read in j - 1
    __syncthreads();   // every wgmma reading this stage has retired
    if (tid == 0 && j + STAGES < n_it) load_t(j + STAGES);
  }

  if (key0 < S) {
    const size_t off = (((size_t)b * S + key0) * Hkv + hk) * DH + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(adk[4 * n] * scale, adk[4 * n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(adv[4 * n], adv[4 * n + 1]);
    }
  }
  if (key1 < S) {
    const size_t off = (((size_t)b * S + key1) * Hkv + hk) * DH + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(adk[4 * n + 2] * scale,
                                adk[4 * n + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(adv[4 * n + 2], adv[4 * n + 3]);
    }
  }
}

// the four maps of one call: q and do with `q_rows`-row boxes (none when
// T == 0), k and v with `k_rows`-row boxes (none when S == 0)
int encode_maps(CUtensorMap* q_map, CUtensorMap* k_map, CUtensorMap* v_map,
                CUtensorMap* do_map, const void* q, const void* k,
                const void* v, const void* dout, int B, int Tq, int S, int Hq,
                int Hkv, int DH, int q_rows, int k_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  *q_map = *k_map = *v_map = *do_map = CUtensorMap{};
  const bool ok =
      (Tq == 0 || (encode_map(encode, q_map, q, B, Tq, Hq, DH, q_rows) &&
                   encode_map(encode, do_map, dout, B, Tq, Hq, DH, q_rows))) &&
      (S == 0 || (encode_map(encode, k_map, k, B, S, Hkv, DH, k_rows) &&
                  encode_map(encode, v_map, v, B, S, Hkv, DH, k_rows)));
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq,
              int S, int Hq, int Hkv, int group, int causal, int window,
              float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  int rc = encode_maps(&qmap, &kmap, &vmap, &domap, q, k, v, dout, B, Tq, S,
                       Hq, Hkv, DH, BM, dq_kv_tile(DH));
  if (rc) return rc;
  constexpr int smem =
      (DH / HALF) * (2 * MBOX + 2 * STAGES * dq_kv_tile(DH) * ROW_BYTES) +
      1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((long long)B * Hq * ((Tq + BM - 1) / BM));
  flash_bwd_dq_sm90<DH><<<blocks, THREADS, smem, stream>>>(
      qmap, kmap, vmap, domap, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, B, Tq, S, Hq, group, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Tq, int S, int Hq, int Hkv, int group, int causal,
               int window, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  int rc = encode_maps(&qmap, &kmap, &vmap, &domap, q, k, v, dout, B, Tq, S,
                       Hq, Hkv, DH, dkv_q_tile(DH), BM);
  if (rc) return rc;
  constexpr int smem =
      (DH / HALF) * (2 * MBOX + 2 * STAGES * dkv_q_tile(DH) * ROW_BYTES) +
      1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((long long)B * Hkv * ((S + BM - 1) / BM));
  flash_bwd_dkv_sm90<DH><<<blocks, THREADS, smem, stream>>>(
      qmap, kmap, vmap, domap, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, Tq, S, Hkv, group, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 at head_dim 64 or 128 (16-byte-aligned q, k, v, do), T > 0; called
// by `flash_attention_bwd_dq` in flash_attention_bwd.cu
extern "C" int flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Tq, int S,
    int Hq, int Hkv, int group, int head_dim, int causal, int window,
    float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Tq, S, Hq, Hkv,
                           group, causal, window, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Tq, S, Hq,
                            Hkv, group, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bf16 at head_dim 64 or 128 (16-byte-aligned q, k, v, do), S > 0; called
// by `flash_attention_bwd_dkv` in flash_attention_bwd.cu
extern "C" int flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
    int S, int Hq, int Hkv, int group, int head_dim, int causal, int window,
    float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Tq, S, Hq,
                            Hkv, group, causal, window, scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Tq, S,
                             Hq, Hkv, group, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
