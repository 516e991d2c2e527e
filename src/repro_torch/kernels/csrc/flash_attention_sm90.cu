// K2 on the bf16 path: the flash-attention forward on Hopper's tensor cores
// (sm_90a), for head_dim 64 and 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fwd
// (`_fwd_kernel`): online-softmax attention with a causal / sliding-window
// mask and GQA (q head h reads kv head h // group), emitting o in bf16 and
// the natural-log log-sum-exp in f32 for the backward pass. Layout is the
// reference's [B, T, H, Dh]; T and S need not tile (the Pallas kernel asks
// that they do). `flash_attention.cu` keeps the f32 path and bf16 at
// head_dim 32, and its entry point sends bf16 at head_dim 64 and 128 here.
//
// Its bound on this card is set by memory. Reading q, k, v and writing o
// and lse once moves 33.8 MB at the Qwen2.5-14B prefill (B 4, T 256, 48/16
// heads x 128; 10.1 us at 3.35 TB/s) against 3.2 GFLOP of causal products
// (3.3 us at 989 TFLOP/s bf16); 50.7 MB (15.1 us) against 6.5 GFLOP (6.5 us)
// at the MiniCPM-2B training shape (B 4, T 512, 48/48 x 64); 16.9 MB
// (5.0 us) at Zamba2-1.2B's shared block (B 4, T 256, 32/32 x 64).
//
// Design. One CTA of one warpgroup (128 threads) per (batch, q head,
// 64-row q tile); the CTAs of the last q tiles, which walk the most K/V
// tiles under the causal mask, are numbered first. Thread 0 loads the q
// tile and a two-stage ring of K and V tiles by TMA, each stage tracked by
// one mbarrier (expected bytes); while the warpgroup computes on one stage
// the next one is in flight, and the stage is refilled once its last
// `wgmma` has retired (a CTA barrier). A K/V tile is 32 keys at head_dim
// 128 and 64 at head_dim 64. Per K/V tile:
//   S = Q K^T: wgmma m64n{32,64}k16, A = Q and B = K from shared memory,
//     both K-major (head_dim contiguous), f32 accumulator, Dh/16 steps;
//   the online softmax on the accumulator fragment: each thread holds two
//     rows (lane/4 and lane/4 + 8 of its warp's 16), the row max and sum
//     shuffle across the 4 lanes of a row; p = 2^(s * scale * log2 e -
//     m * scale * log2 e) by `ex2.approx`, the scale applied to the f32
//     scores (never to a bf16 q: 1/sqrt(128) is not a power of two); l sums
//     the f32 p;
//   O += P V: wgmma m64nDHk16 with P converted to bf16 pairs in registers:
//     the m64nN f32 accumulator fragment of 16 keys is the A-register
//     fragment of one k16 step, as in FlashAttention-3, with no shuffle;
//     B = V from shared memory is MN-major ([keys, Dh], Dh contiguous,
//     contracted over keys), read with the transpose-B immediate.
// Tiles that the causal or window mask empties are skipped; the mask is
// applied only on tiles it cuts (the diagonal, the window's edge, keys past
// S). The epilogue divides by l (l == 0 -> 1, as the reference), writes o
// as bf16 pairs straight from the fragment and lse = m * scale + log(l),
// masking rows >= T. S is 16 or 32 f32 registers a thread and O 32 or 64:
// no spills (`-Xptxas -v` in the build's ptxas report).
//
// What sets its time: not bytes or tensor-core rate but each CTA's chain
// of dependent steps (load wait, Q K^T, softmax, P V, barrier), hidden only
// by other CTAs on the SM, so CTAs per SM decide it. In trial builds on the
// H100, one CTA per SM at head_dim 128 (a three-stage ring) was slower than
// two; 32-key tiles at head_dim 128 (four CTAs per SM) beat 64-key ones,
// and lost at head_dim 64; two warpgroups sharing a 128-row q tile, which
// halves the K/V re-reads from L2, were no faster.
//
// Shared memory, from a 1024-byte-aligned base: q [NCH][64 rows][128 B],
// then per stage K and V [NCH][BK keys][128 B], NCH = Dh / 64 column
// halves: 48 KB at head_dim 128, 40 KB at head_dim 64.
//
// The trouble spots, as solved here:
// 1. The TMA descriptor. `cuTensorMapEncodeTiled` is a driver-API function
//    and the library links no libcuda: it is fetched once through
//    `cudaGetDriverEntryPoint[ByVersion]` as `PFN_cuTensorMapEncodeTiled`
//    (<cudaTypedefs.h>), and each call encodes three maps on the host
//    (q, k, v), passed as `const __grid_constant__ CUtensorMap` parameters.
// 2. Ragged S with batch > 1. The maps are 4-D, (Dh, H, L, B) with a box of
//    (64, 1, rows, 1): a tile that runs past T or S is zero-filled by TMA
//    and never reads the next batch row's tokens; keys >= S are masked
//    anyway.
// 3. Swizzle. 128-byte swizzle allows an inner box of 64 bf16, so Dh 128 is
//    two column halves, each its own box. Every `wgmma` descriptor says
//    128-byte swizzle with an 8-row group stride (SBO) of 1024 bytes; a k16
//    step inside a half advances the start address by 32 bytes (the
//    hardware swizzles the absolute address, and every box starts on 1024
//    bytes); for V (MN-major) a k16 step is 16 rows (2048 bytes) and the
//    leading byte offset (LBO) is the distance between the two column
//    halves (BK * 128 bytes).
// 4. Alignment. TMA needs 16-byte-aligned bases and strides: the strides
//    are multiples of Dh * 2 bytes, and the Python wrapper raises on a
//    q, k or v whose data_ptr() is not 16-byte aligned.
// 5. Loads are TMA, not cp.async; no fallback path exists. A barrier wait
//    that never completes traps (see `mbar_wait`) instead of holding the
//    card.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // q rows per CTA: one warpgroup's wgmma M
constexpr int STAGES = 2;      // the K/V ring
constexpr int THREADS = 128;   // one warpgroup
constexpr int HALF = 64;       // bf16 columns of one 128-byte swizzled row
constexpr int BOX = 64 * 128;  // bytes of the q tile's 64-row TMA box

// keys per K/V tile: 32 at head_dim 128 keeps the ring small enough for
// four CTAs per SM; 64 at head_dim 64 (32 measured slower there)
__host__ __device__ constexpr int kv_tile(int dh) {
  return dh == 128 ? 32 : 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// a barrier that never completes (a load that faulted) traps after ~2^34
// cycles (~9 s) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (64 columns, 1 head, 64 rows, 1 batch) box of a 4-D map into `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across the async wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R32                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "  \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31"
#define WG_R64_TAIL                                                    \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "  \
  "%57, %58, %59, %60, %61, %62, %63"

// S[64 x 32] (+)= Q[64 x 16] K[32 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] V[16 x 64]: P in registers, V MN-major
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] V[16 x 128]: P in registers, V MN-major
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R32
      WG_R64_TAIL "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8
#undef WG_R32
#undef WG_R64_TAIL

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit; -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int B, int Tq, int S, int Hq, int group, int causal,
               int window, float scale) {
  constexpr int BK = kv_tile(DH);
  constexpr int NCH = DH / HALF;       // 128-byte column halves
  constexpr int QBYTES = NCH * BOX;    // the q tile
  constexpr int KBOX = BK * 128;       // one column half of a K or V tile
  constexpr int KVBYTES = NCH * KBOX;  // one K or V tile
  constexpr int NO = DH / 2;           // O fragment floats a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t kv0 = base + QBYTES;  // stage s: K at kv0 + 2 s KVBYTES

  const int n_qt = (Tq + BQ - 1) / BQ;
  const int BH = B * Hq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // heaviest tiles first
  const int h = (int)(blockIdx.x % BH) % Hq;
  const int b = (int)(blockIdx.x % BH) / Hq;
  const int hk = h / group;
  const int q0 = qt * BQ;

  // the kv tiles that some row of this q tile can see
  int kv_begin = 0, kv_end = S;
  if (causal) {
    kv_end = min(S, q0 + BQ);
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, QBYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load(qs + c * BOX, &qmap, bar_q, c * HALF, h, q0, b);
    for (int j = 0; j < STAGES && j < n_kv; ++j) load_kv(j);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's two rows:
  const int row1 = row0 + 8;                      // row0 and row0 + 8
  const int cq = (lane & 3) * 2;   // first of its two columns in each 8
  const float scale_log2 = scale * 1.4426950408889634f;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of the raw scores
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sums

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const uint32_t ks = kv0 + 2 * s * KVBYTES;
    const uint32_t vs = ks + KVBYTES;
    mbar_wait(bar_kv(s), (j / STAGES) & 1);
    __syncwarp();

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;   // 16 columns into a half
      wgmma_qk(sc, sdesc(qs + (kk / 4) * BOX + step, 16, 1024),
               sdesc(ks + (kk / 4) * KBOX + step, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);

    const int key0 = kv_begin + j * BK;
    const bool edge = key0 + BK > S ||
                      (causal && (key0 + BK - 1 > q0 ||
                                  (window > 0 &&
                                   key0 <= q0 + BQ - 1 - window)));
    if (edge) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + cq + (e & 1);
          const int row = (e & 2) ? row1 : row0;
          bool ok = key < S;
          if (causal) {
            ok = ok && key <= row;
            if (window > 0) ok = ok && key > row - window;
          }
          if (!ok) sc[n * 4 + e] = -INFINITY;
        }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // the new max in log2 units; 0 while a row has seen no key
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
    const float alpha0 = ex2(m0 * scale_log2 - ms0);
    const float alpha1 = ex2(m1 * scale_log2 - ms1);
    m0 = mx0;
    m1 = mx1;

    // p in f32 for l, in bf16 pairs for P V: the fragment of keys
    // 16 kk .. 16 kk + 15 is the A fragment of the kk-th k16 step
    uint32_t pa[BK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = ex2(fmaf(sc[4 * n], scale_log2, -ms0));
      const float p1 = ex2(fmaf(sc[4 * n + 1], scale_log2, -ms0));
      const float p2 = ex2(fmaf(sc[4 * n + 2], scale_log2, -ms1));
      const float p3 = ex2(fmaf(sc[4 * n + 3], scale_log2, -ms1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[4 * n] *= alpha0;
      acc[4 * n + 1] *= alpha0;
      acc[4 * n + 2] *= alpha1;
      acc[4 * n + 3] *= alpha1;
    }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv(acc, pa[kk], sdesc(vs + kk * 16 * 128, KBOX, 1024));
    wg_commit();
    wg_wait_all();
    reg_fence(acc);

    __syncthreads();   // every wgmma reading this stage has retired
    if (tid == 0 && j + STAGES < n_kv) load_kv(j + STAGES);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  if (row0 < Tq) {
    __nv_bfloat16* orow = o + (((size_t)b * Tq + row0) * Hq + h) * DH + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (cq == 0) lse[((size_t)b * Hq + h) * Tq + row0] = m0 * scale + logf(ls0);
  }
  if (row1 < Tq) {
    __nv_bfloat16* orow = o + (((size_t)b * Tq + row1) * Hq + h) * DH + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    if (cq == 0) lse[((size_t)b * Hq + h) * Tq + row1] = m1 * scale + logf(ls1);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// [B, L, H, Dh] bf16 as the 4-D map (Dh, H, L, B), a (64, 1, rows, 1) box,
// 128-byte swizzle, zero fill past every edge
bool encode_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map,
                const void* ptr, int B, int L, int H, int DH, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)DH * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * L};
  const cuuint32_t box[4] = {HALF, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tq, int S, int Hq, int Hkv, int group, int causal,
           int window, float scale, cudaStream_t stream) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // with no keys (S == 0) no K/V tile is loaded and the maps stay empty
  CUtensorMap qmap, kmap = {}, vmap = {};
  if (!encode_map(encode, &qmap, q, B, Tq, Hq, DH, BQ) ||
      (S > 0 && (!encode_map(encode, &kmap, k, B, S, Hkv, DH, kv_tile(DH)) ||
                 !encode_map(encode, &vmap, v, B, S, Hkv, DH, kv_tile(DH)))))
    return (int)cudaErrorInvalidValue;
  constexpr int smem =
      (DH / HALF) * (BOX + 2 * STAGES * kv_tile(DH) * 128) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const unsigned blocks = (unsigned)((long long)B * Hq * n_qt);
  flash_fwd_sm90<DH><<<blocks, THREADS, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, (float*)lse, B, Tq, S, Hq, group,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/o at head_dim 64 or 128 (16-byte-aligned bases); called by
// `flash_attention_fwd` in flash_attention.cu
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Tq, int S, int Hq, int Hkv,
                                        int group, int head_dim, int causal,
                                        int window, float scale,
                                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, Tq, S, Hq, Hkv, group, causal,
                        window, scale, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Tq, S, Hq, Hkv, group, causal,
                         window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
