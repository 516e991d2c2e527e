// Building blocks shared by the two chunked scans: K8, the Mamba2 SSD scan
// (`mamba2_ssd.cu`), and K9, the RWKV6 recurrence (`rwkv6_scan.cu`).
//
// Both scans carry a [rows, 64] f32 state S per (batch row, head) through
// time. At prefill the time axis is cut into chunks of CHUNK steps, a tile
// (one CTA) each, and the chunks' dependence is resolved in two launches
// of one kernel (`Job` below says what a tile does):
//   pass 0: one tile per (batch row, head, chunk) but the last. Chunk 0
//     runs from the initial state and computes its y; every other chunk
//     runs from S = 0 (its local state) without y. Each writes its end
//     state to the chunk's scratch slot, and its decay (the product of the
//     chunk's per-step decays: one value, or one a state row).
//   pass 1: one tile per chunk but the first. The state before chunk c is
//     folded from the slots in order, S = slot_0, then S = S * decay_c' +
//     slot_c' for c' = 1 .. c - 1; the tile computes y, and the last chunk
//     writes the final state.
// T <= CHUNK takes one launch (pass 2: chunk 0 from the initial state, y,
// the final state). Only pass 0 reads the initial state and only passes 1
// and 2 write the final state, each element by the one thread that owns
// it, so the two may be one buffer (the model's cache slice).
// Inside a tile the chunk is walked in sub-chunks of SUB steps. Every decay
// is a product of at most SUB per-step factors in (0, 1], taken in step
// order, so nothing overflows whatever the decays, and a factor underflows
// only where the exact value is below f32's range.
//
// Every function has internal linkage: each kernel source includes this
// file and compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace scan {

constexpr int CHUNK = 64;          // time steps of one tile
constexpr int SUB = 16;            // time steps of one sub-chunk
constexpr int NSUB = CHUNK / SUB;  // sub-chunks of a tile: copy groups
constexpr int COLS = 64;           // state columns (P for K8, Dh for K9)
constexpr int LANES = 4;           // lanes sharing one state column
constexpr int THREADS = COLS * LANES;  // 256 a tile
constexpr int DEC_THREADS = 256;   // a decode CTA: one (batch row, head)
static_assert(NSUB == 4, "wait_sub counts four copy groups");
static_assert(SUB == 4 * LANES, "reduce_scatter4 gives a lane 4 steps");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                     to_f32(p[3]));
}

// Four consecutive elements with one vector load (8 bytes for bf16, 16 for
// f32): p must be aligned to that size.
__device__ __forceinline__ float4 load4v(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4v(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; `src_bytes` 0
// zero-fills the destination without reading the source.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// sub-chunk s's copies (group s of the NSUB committed in order) landed
__device__ __forceinline__ void wait_sub(int s) {
  if (s == 0)
    cp_async_wait<NSUB - 1>();
  else if (s == 1)
    cp_async_wait<NSUB - 2>();
  else if (s == 2)
    cp_async_wait<NSUB - 3>();
  else
    cp_async_wait<0>();
}

// Issue the copies of rows [r0, r0 + SUB) of a tile, `row_bytes` each (a
// multiple of 16), from `src` (row r at src + r * stride bytes) to `dst`
// (row r at dst + r * pitch bytes, pitch a multiple of 16). Rows at or
// past `valid` are zero-filled, never read. NTHREADS threads share them.
template <int NTHREADS = THREADS>
__device__ __forceinline__ void stage_rows(char* dst, int pitch,
                                           const char* src, size_t stride,
                                           int row_bytes, int r0, int valid,
                                           int tid) {
  const int per_row = row_bytes / 16;
  for (int e = tid; e < SUB * per_row; e += NTHREADS) {
    const int r = r0 + e / per_row, ch = e % per_row;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + (size_t)r * pitch + ch * 16),
               ok ? src + (size_t)r * stride + ch * 16 : src, ok ? 16 : 0);
  }
}

// The four lanes of one column (g = lane & 3) each hold partial sums
// acc[t] of the sub-chunk's steps t; afterwards lane g holds the full sums
// of steps 4g .. 4g + 3 in out[0..3], added in a fixed order.
__device__ __forceinline__ void reduce_scatter4(const float (&acc)[SUB],
                                                float (&out)[4], int g) {
  float h[8];
  const bool hi2 = (g & 2) != 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float keep = hi2 ? acc[8 + q] : acc[q];
    const float send = hi2 ? acc[q] : acc[8 + q];
    h[q] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const bool hi1 = (g & 1) != 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float keep = hi1 ? h[4 + q] : h[q];
    const float send = hi1 ? h[q] : h[4 + q];
    out[q] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
}

// ---- the bf16 tensor-core form: mma.sync m16n8k16, f32 accumulators ----
// Fragments (lane = 4 * grp + tig): A [16 x 16] row-major, a0 = (grp, 2tig
// .. 2tig+1), a1 = (grp+8, ..), a2 = (grp, 2tig+8 ..), a3 = (grp+8, 2tig+8
// ..); B [16 x 8] (k x n), b0 = (k 2tig .. 2tig+1, n grp), b1 = (k 2tig+8
// .., n grp); C [16 x 8], c0/c1 = (grp, 2tig / 2tig+1), c2/c3 = (grp+8,
// ..). A register holds two bf16, the lower index in the low half.
constexpr int MMA_THREADS = 128;   // four warps, 16 state columns each

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// v as a sum of NS bf16 terms, largest first (NS 2: ~16 bits of v, NS 3:
// all 24); each term is the rounding of what the earlier ones left.
template <int NS>
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16 (&t)[NS]) {
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    t[q] = __float2bfloat16_rn(v);
    v -= __bfloat162float(t[q]);
  }
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The pair (a, b) as NS packed bf16 pairs, largest first (split_bf16 on
// each, a in the low halves), with one conversion instruction a term.
template <int NS>
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (&t)[NS]) {
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    t[q] = as_u32(v);
    const float2 f = __bfloat1622float2(v);
    a -= f.x;
    b -= f.y;
  }
}

// The A fragment of X^T (16 columns of the state x 16 steps) from x staged
// as [step][col] bf16 rows of `stride` elements: rows = steps, col0 = the
// warp's first column.
__device__ __forceinline__ void xt_fragment(uint32_t (&a)[4],
                                            const __nv_bfloat16* xs,
                                            int stride, int col0, int grp,
                                            int tig) {
  const __nv_bfloat16* c0 = xs + col0 + grp;
  const int t0 = 2 * tig;
  a[0] = pack2(c0[t0 * stride], c0[(t0 + 1) * stride]);
  a[1] = pack2(c0[t0 * stride + 8], c0[(t0 + 1) * stride + 8]);
  a[2] = pack2(c0[(t0 + 8) * stride], c0[(t0 + 9) * stride]);
  a[3] = pack2(c0[(t0 + 8) * stride + 8], c0[(t0 + 9) * stride + 8]);
}

// The A fragments (hi, lo) of the f32 state S^T held as accumulators st
// [tiles of 8 columns][4], for the k-step over columns 16kk .. 16kk + 15.
template <int NT>
__device__ __forceinline__ void st_fragments(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&st)[NT][4],
                                             int kk) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* c = st[2 * kk + (q >> 1)] + 2 * (q & 1);
    uint32_t t[2];
    split_pair<2>(c[0], c[1], t);
    hi[q] = t[0];
    lo[q] = t[1];
  }
}

// What a tile of a pass does (see the top of this file).
struct Job {
  int bh, c;        // (batch row, head) and chunk
  bool y;           // computes y
  bool from_s0;     // starts from the initial state (else from a fold or 0)
  bool fold;        // starts from the fold of the slots before chunk c
  bool to_slot;     // writes its end state to slot c and its decay
  bool to_out;      // writes its end state as the final state
};

__device__ __forceinline__ Job job(int pass, int tile, int nc) {
  const int per = pass == 2 ? 1 : nc - 1;
  Job j;
  j.bh = tile / per;
  j.c = tile % per + (pass == 1 ? 1 : 0);
  j.y = pass != 0 || j.c == 0;
  j.from_s0 = pass == 2 || (pass == 0 && j.c == 0);
  j.fold = pass == 1;
  j.to_slot = pass == 0;
  j.to_out = pass == 2 || (pass == 1 && j.c == nc - 1);
  return j;
}

// The state a tile starts from, at the thread's NE elements idx[e] (state
// row row[e]) of its (batch row, head)'s state of `np` elements. `slot` is
// [BH][nc][np]; `decay` is [BH][nc] (ROW_DECAY false) or [BH][nc][rows].
// Every element's load of one slot is issued before the next slot's, so a
// fold waits for memory once a chunk, not once an element.
template <bool ROW_DECAY, int NE>
__device__ __forceinline__ void start_states(float (&s)[NE],
                                             const int (&idx)[NE],
                                             const int (&row)[NE],
                                             const Job& jb, const float* s0,
                                             const float* slot,
                                             const float* decay, int nc,
                                             int np, int rows) {
  const float* src = nullptr;
  if (jb.from_s0 && s0 != nullptr) src = s0 + (size_t)jb.bh * np;
  if (jb.fold) src = slot + (size_t)jb.bh * nc * np;
#pragma unroll
  for (int e = 0; e < NE; ++e) s[e] = src != nullptr ? src[idx[e]] : 0.f;
  if (!jb.fold) return;
  const size_t base = (size_t)jb.bh * nc;
  for (int c = 1; c < jb.c; ++c) {
    const float* sl = slot + (base + c) * np;
    if (ROW_DECAY) {
      const float* dr = decay + (base + c) * rows;
#pragma unroll
      for (int e = 0; e < NE; ++e) s[e] = s[e] * dr[row[e]] + sl[idx[e]];
    } else {
      const float d = decay[base + c];
#pragma unroll
      for (int e = 0; e < NE; ++e) s[e] = s[e] * d + sl[idx[e]];
    }
  }
}

// Where a tile writes its end state (null: nowhere).
__device__ __forceinline__ float* end_state(const Job& jb, float* s_out,
                                            float* slot, int nc, int np) {
  if (jb.to_slot) return slot + ((size_t)jb.bh * nc + jb.c) * np;
  if (jb.to_out) return s_out + (size_t)jb.bh * np;
  return nullptr;
}

// Launch a chunk kernel's passes: one for T <= CHUNK, else passes 0 and 1.
// `launch(pass, tiles)` launches one and returns cudaGetLastError().
template <typename F>
int run_passes(int BH, int T_len, bool have_scratch, F launch) {
  const int nc = (T_len + CHUNK - 1) / CHUNK;
  if (nc == 1) return launch(2, BH);
  if (!have_scratch) return (int)cudaErrorInvalidValue;
  const int rc = launch(0, BH * (nc - 1));
  return rc ? rc : launch(1, BH * (nc - 1));
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB), once.
template <typename K>
int opt_in(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

}  // namespace scan
}  // namespace
