// K3 — decode attention for Hopper (sm_90a): one query token per row
// against the KV cache, the cache split across the SMs (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (`_kernel`): per-row valid `lengths`, GQA (q head h reads
// kv head h // group), online softmax in f32. Rows with length 0 return
// zeros, as the Pallas kernel does. Any S.
//
// What bounds it on this card: memory. Each valid K/V row is read once and
// the work is `group` multiply-adds a byte (3 at Qwen2.5-14B, 1 at
// Zamba2-1.2B), far below the ~295 operations a byte at which the bf16
// tensor cores would set the pace. At the serve paths' shapes (B 4, S 296,
// 48/16 heads x 128 and 32/32 x 64, bf16) a launch reads 5.4 MB at the
// checked ragged lengths (1 to 296) and 8.4-9.4 MB at the lengths decode
// runs (257 to 287): 1.6-2.8 us at 3.35 TB/s. A launch that short is set
// by latency: how soon every SM has its bytes in flight, and how long each
// CTA's chain of dependent steps is.
//
// Design.
// 1. The cache is split across CTAs. The grid is (B * Hkv, n_split); CTA
//    (b, kv head, split) walks keys [split * split_keys, +split_keys) up to
//    lengths[b], so a long row is shared by n_split CTAs and a split past
//    lengths[b] loads nothing. The wrapper picks the split from S (a host
//    int) for about four CTAs an SM: 5 splits of 64 keys at both serve
//    shapes (320 and 640 CTAs), 5 of 832 at Zamba2's 4096-key window. One
//    CTA serves the whole GQA group, so each K/V row leaves memory once.
// 2. Bytes in flight. A CTA of four warps streams its split through a ring
//    of shared-memory stages with `cp.async.cg`, 16 bytes a thread, keys
//    past the split's end zero-filled (a zero source size), never read. A
//    stage holds one tile of K and one of V, 8 KB each (32 keys at
//    head_dim 128 in bf16, 64 at 64; 16 to 64 keys in general), and the
//    ring is one stage deeper than the split's tiles, 2 to 4 stages, so a
//    short split is in flight whole at once (48 KB a CTA at Qwen2.5, 32 KB
//    at Zamba2) and a long one keeps three tiles in flight. lengths[b] and
//    q are loaded first, the copies issued once lengths[b] is known (in a
//    trial build, issuing the first tiles before it arrived was slower on
//    ragged rows and barely faster on full ones). cp.async needs no host-side
//    descriptor (TMA would need a tensor map per cache tensor per call), so
//    the wrapper's host cost does not grow. The copies need 16-byte-aligned
//    q, k, v; the wrapper refuses others.
// 3. A whole tile scored at once, on the CUDA cores. The four warps take a
//    quarter of the tile's rows each. A row's 16-byte chunks go to
//    consecutive lanes (a row of head_dim 128 in bf16 is 16 lanes), so one
//    warp-wide 16-byte read covers 32 / lanes-a-row rows of contiguous
//    shared memory, free of bank conflicts, and each lane keeps its chunk
//    of every q head (pre-scaled by scale * log2 e) in registers. q . k
//    sums over a row's lanes by xor shuffles, which leaves the score in
//    every lane of the row; then, per q head and tile, one max over the
//    warp's rows, one rescale of l and of the accumulator, and p by
//    `ex2.approx`. The accumulator is that same lane's chunk of head_dim,
//    so P V needs no exchange. A tile's arithmetic is one branch-free
//    block over a compile-time head count (1, 2, 3, 4 or 8; heads past
//    `group` are zero q, computed and never stored), so the compiler
//    interleaves the shuffle chains of every row and head (in a trial
//    build with a branch a head, each chain ran alone and a tile took
//    several times as long on the H100). Tensor cores are not used: at
//    `group` <= 8 the FMA loop keeps pace with the byte stream (at group 3
//    about 150 K of the SM's ~435 K f32 flop/us), and a swap-AB `wgmma`
//    would pad the group to N = 8 for no gain.
// 4. Merges in a fixed order, no float atomics, so two launches give the
//    same bits. The four warps' (m, l, acc) merge through shared memory.
//    With n_split == 1 the CTA then writes o. Otherwise the n_split CTAs of
//    one (b, kv head) are a thread-block cluster (at most 8, a portable
//    cluster), and each owns every n_split-th float4 column of the output:
//    each CTA writes each column of its state into the shared memory of the
//    column's owner (distributed shared memory), and each head's (m, l)
//    into every CTA's; one cluster barrier (release, acquire); each CTA
//    merges its columns over the splits in split order and writes them. A
//    CTA with no valid key sends m = -inf, l = 0; a row with no valid key
//    gives zeros. One launch, no workspace, no counters. (Trial builds: the
//    last-arriving CTA merging through global memory, with its fence,
//    atomic and reloads, cost several microseconds more; gathering every
//    state into one CTA's shared memory, more as n_split grew.)
// 5. One design for every dtype and head_dim: nothing here is bf16-only.
//    A row is at least four 16-byte chunks, so head_dim 16 (Mistral-Large's
//    tiny config) is taken in f32 only.
//
// Shared memory: the ring, then the inbox of the cluster's states,
// n_split x group x (head_dim + 2) f32; 48 KB + 7.6 KB at the Qwen2.5
// serve shape. After the loop the ring's bytes hold the warps' states.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;          // largest GQA group one CTA serves
constexpr int MAX_SPLITS = 8;    // most splits of one row: a cluster
constexpr int STAGES = 4;        // the ring's depth
constexpr int TILE_BYTES = 8192; // one tile of K (or of V)
constexpr float LOG2E = 1.4426950408889634f;

constexpr int clamp_keys(int keys) {
  return keys < 16 ? 16 : (keys > 64 ? 64 : keys);
}

template <typename T, int DH>
struct Geo {
  static constexpr int ROW = DH * (int)sizeof(T);  // bytes of one key row
  static constexpr int CPR = ROW / 16;        // 16-byte chunks (lanes) a row
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int TK = clamp_keys(TILE_BYTES / ROW);  // keys a tile
  static constexpr int RPL = 32 / CPR;        // rows of one warp-wide read
  static constexpr int WROWS = TK / WARPS;    // rows a warp takes of a tile
  static constexpr int NL = WROWS / RPL;      // its reads a tile and tensor
  static constexpr int CPT = TK * CPR / THREADS;  // copies a thread, tensor
  static constexpr int TILE = TK * ROW;       // bytes of one tensor's tile
  static constexpr int STAGE = 2 * TILE;      // K tile, then V tile
  static constexpr int SMEM = STAGES * STAGE;  // the deepest ring
  static_assert(CPR >= 4 && CPR <= 32 && 32 % CPR == 0, "row width");
  static_assert(NL >= 1 && WROWS % RPL == 0, "tile rows");
  static_assert(CPT >= 1 && TK * CPR % THREADS == 0, "tile copies");
  static_assert(WARPS * MAXG * (DH + 2) * 4 <= 2 * STAGE,
                "the warps' states fit the shallowest ring");
};

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

// in a ring of `depth` stages, tile t has landed once at most depth - 2
// later groups are pending
__device__ __forceinline__ void cp_async_wait_ring(int depth) {
  if (depth >= 4)
    cp_async_wait<2>();
  else if (depth == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// the cluster barrier in two halves: arrive (relaxed: nothing to publish,
// or release: this thread's writes, remote ones too) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one 16-byte chunk as f32
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 pairs, the low half first
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float4 a, float c) {
  acc.x = fmaf(a.x, c, acc.x);
  acc.y = fmaf(a.y, c, acc.y);
  acc.z = fmaf(a.z, c, acc.z);
  acc.w = fmaf(a.w, c, acc.w);
}

// a / l for four consecutive outputs
__device__ __forceinline__ void store4(float4 a, float l, float* p) {
  *reinterpret_cast<float4*>(p) =
      make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
}
__device__ __forceinline__ void store4(float4 a, float l, __nv_bfloat16* p) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x / l, a.y / l);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z / l, a.w / l);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int DH, int GP>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, int S, int Hq, int Hkv, int group,
                    int split_keys, int n_split, int depth,
                    float scale_log2) {
  using G = Geo<T, DH>;
  constexpr int EPC = G::EPC, CPR = G::CPR, TK = G::TK, NL = G::NL;
  constexpr int D4 = DH / 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x, b = bh / Hkv, hk = bh % Hkv;
  const int split = blockIdx.y;   // = the CTA's rank in its cluster
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane % CPR;     // this lane's chunk of a row
  const int rsub = lane / CPR;  // its row within one warp-wide read
  const int len_in = lengths[b];   // in flight beside the q loads
  if (n_split > 1) cluster_arrive_relaxed();   // "started", awaited below

  const int start = split * split_keys;
  const size_t key_stride = (size_t)Hkv * G::ROW;   // bytes between keys
  const char* kb = (const char*)(k + ((size_t)b * S * Hkv + hk) * DH);
  const char* vb = (const char*)(v + ((size_t)b * S * Hkv + hk) * DH);

  // this lane's chunk of each q head, times scale * log2 e; the heads past
  // `group` are zeros, computed alongside and never stored, so that a
  // tile's arithmetic is one branch-free block the compiler interleaves
  float qr[GP][EPC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    const uint4 u = g < group ? *reinterpret_cast<const uint4*>(
                                    q + ((size_t)b * Hq + hk * group + g) *
                                            DH + c * EPC)
                              : make_uint4(0u, 0u, 0u, 0u);
    unpack(u, qr[g]);
#pragma unroll
    for (int e = 0; e < EPC; ++e) qr[g][e] *= scale_log2;
  }

  const int len = len_in < 0 ? 0 : (len_in > S ? S : len_in);
  const int end = min(min(start + split_keys, S), len);
  const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;

  // tile t into stage t % depth, keys at or past `end` zero-filled; one
  // commit group a call, empty past the split
  auto issue = [&](int t) {
    const int key0 = start + t * TK;
    if (key0 < end) {
      unsigned char* st = smem + (t % depth) * G::STAGE;
#pragma unroll
      for (int i = 0; i < G::CPT; ++i) {
        const int ch = tid + i * THREADS;
        const int key = key0 + ch / CPR;
        const bool ok = key < end;
        const size_t off =
            (size_t)(ok ? key : start) * key_stride + (ch % CPR) * 16;
        cp_async16(smem_u32(st + ch * 16), kb + off, ok ? 16 : 0);
        cp_async16(smem_u32(st + G::TILE + ch * 16), vb + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < depth - 1; ++t) issue(t);

  float m[GP], l[GP], acc[GP][EPC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;
  }

  const int wrow0 = warp * G::WROWS;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_ring(depth);   // this thread's copies of tile t landed
    __syncthreads();             // everyone's did; stage t - 1 is free
    issue(t + depth - 1);
    const unsigned char* st = smem + (t % depth) * G::STAGE;
    const int key0 = start + t * TK;
    if (key0 + wrow0 >= end) continue;   // warp-uniform: no valid row

    // q . k: each lane's chunk, then summed over the row's lanes
    float s[GP][NL];   // scores, then p
    bool valid[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int r = wrow0 + i * G::RPL + rsub;
      valid[i] = key0 + r < end;
      float kf[EPC];
      unpack(*reinterpret_cast<const uint4*>(st + (r * CPR + c) * 16), kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; e += 2) {
          d0 = fmaf(qr[g][e], kf[e], d0);
          d1 = fmaf(qr[g][e + 1], kf[e + 1], d1);
        }
        s[g][i] = d0 + d1;
      }
    }
#pragma unroll
    for (int off = 1; off < CPR; off <<= 1)
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int i = 0; i < NL; ++i)
          s[g][i] += __shfl_xor_sync(0xffffffffu, s[g][i], off);
    // one max and one rescale a tile and q head
    float mx[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int i = 0; i < NL; ++i) s[g][i] = valid[i] ? s[g][i] : -INFINITY;
      mx[g] = s[g][0];
#pragma unroll
      for (int i = 1; i < NL; ++i) mx[g] = fmaxf(mx[g], s[g][i]);
    }
#pragma unroll
    for (int off = CPR; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GP; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m[g] - m_use);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        s[g][i] = ex2(s[g][i] - m_use);
        l[g] += s[g][i];
      }
    }
    // P V: this lane's chunk of head_dim over its rows
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int r = wrow0 + i * G::RPL + rsub;
      float vf[EPC];
      unpack(*reinterpret_cast<const uint4*>(st + G::TILE +
                                             (r * CPR + c) * 16),
             vf);
#pragma unroll
      for (int e = 0; e < EPC; ++e)   // p is 0 there; v may be any bits
        vf[e] = valid[i] ? vf[e] : 0.f;
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[g][e] = fmaf(s[g][i], vf[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the merges

  // the warp's rows: sum l and acc over the lanes of other rows
#pragma unroll
  for (int off = CPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  float* wm = reinterpret_cast<float*>(smem);   // [WARPS][GP]
  float* wl = wm + WARPS * GP;                   // [WARPS][GP]
  float* wacc = wl + WARPS * GP;                 // [WARPS][GP][DH]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (lane == 0) {
      wm[warp * GP + g] = m[g];
      wl[warp * GP + g] = l[g];
    }
    if (lane < CPR) {
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        wacc[(warp * GP + g) * DH + c * EPC + e] = acc[g][e];
    }
  }
  __syncthreads();

  // the CTA's state, four head_dim columns a thread: the warps merged in
  // order. One split: o. Else each state column goes to the inbox (past
  // the ring) of the rank that merges it, column idx to rank idx % n_split,
  // and each head's (m, l) to every rank: acc [split][group * DH], then
  // (m, l) [split][group].
  float* inbox = reinterpret_cast<float*>(smem + depth * G::STAGE);
  float* inbox_ml = inbox + (size_t)n_split * group * DH;
  cg::cluster_group cluster = cg::this_cluster();
  if (n_split > 1) cluster_wait();   // every rank has started
  T* ob = o + ((size_t)b * Hq + hk * group) * DH;
  for (int idx = tid; idx < group * D4; idx += THREADS) {
    const int g = idx / D4, d = idx % D4 * 4;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * GP + g]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wm[w * GP + g];
      const float cw = mw == -INFINITY ? 0.f : ex2(mw - M);
      L = fmaf(wl[w * GP + g], cw, L);
      fma4(A, *reinterpret_cast<const float4*>(wacc + (w * GP + g) * DH + d),
           cw);
    }
    if (n_split == 1) {
      store4(A, L == 0.f ? 1.f : L, ob + g * DH + d);
      continue;
    }
    float* box = cluster.map_shared_rank(inbox, idx % n_split);
    *reinterpret_cast<float4*>(box + ((size_t)split * group * D4 + idx) * 4) =
        A;
    if (d == 0)
      for (int r = 0; r < n_split; ++r)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(inbox_ml, r) +
                                   (split * group + g) * 2) =
            make_float2(M, L);
  }
  if (n_split == 1) return;
  cluster_arrive_release();   // this rank's columns are in their inboxes
  cluster_wait();             // every rank's are

  // this rank's columns: the splits merged in order
  for (int idx = split + tid * n_split; idx < group * D4;
       idx += THREADS * n_split) {
    const int g = idx / D4;
    float M = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp)
      M = fmaxf(M, inbox_ml[(sp * group + g) * 2]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = inbox_ml[(sp * group + g) * 2];
      const float cs = ms == -INFINITY ? 0.f : ex2(ms - M);
      L = fmaf(inbox_ml[(sp * group + g) * 2 + 1], cs, L);
      fma4(A,
           *reinterpret_cast<const float4*>(
               inbox + ((size_t)sp * group * D4 + idx) * 4),
           cs);
    }
    store4(A, L == 0.f ? 1.f : L, ob + idx * 4);
  }
}

template <typename T, int DH, int GP>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int S, int Hq, int Hkv, int group, int split_keys,
           int n_split, float scale_log2, cudaStream_t stream) {
  using G = Geo<T, DH>;
  auto kernel = decode_split_kernel<T, DH, GP>;
  static bool opted_in = false;   // above 48 KB once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM + MAX_SPLITS * MAXG * (DH + 2) * 4);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  // a ring one stage deeper than the split's tiles, so that all of a
  // short split is in flight at once: 2 to STAGES stages
  const int tiles = (split_keys + G::TK - 1) / G::TK;
  const int depth = tiles + 1 < 2 ? 2 : (tiles + 1 > STAGES ? STAGES
                                                            : tiles + 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * Hkv), (unsigned)n_split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes =   // the ring, then rank 0's inbox of states
      depth * G::STAGE + (n_split > 1 ? n_split * group * (DH + 2) * 4 : 0);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;   // the splits of one (b, kv head)
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = n_split;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)k,
                                 (const T*)v, (const int*)lengths, (T*)o, S,
                                 Hq, Hkv, group, split_keys, n_split, depth,
                                 scale_log2);
}


template <typename T, int DH>
int launch_g(const void* q, const void* k, const void* v, const void* lengths,
             void* o, int B, int S, int Hq, int Hkv, int group,
             int split_keys, int n_split, float scale_log2, cudaStream_t st) {
  if (group == 1)
    return launch<T, DH, 1>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                            split_keys, n_split, scale_log2, st);
  if (group == 2)
    return launch<T, DH, 2>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                            split_keys, n_split, scale_log2, st);
  if (group == 3)   // Qwen2.5-14B's group on the serve path
    return launch<T, DH, 3>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                            split_keys, n_split, scale_log2, st);
  if (group <= 4)
    return launch<T, DH, 4>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                            split_keys, n_split, scale_log2, st);
  return launch<T, DH, 8>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                          split_keys, n_split, scale_log2, st);
}

template <typename T>
int launch_dh(int head_dim, const void* q, const void* k, const void* v,
              const void* lengths, void* o, int B, int S, int Hq, int Hkv,
              int group, int split_keys, int n_split, float scale_log2,
              cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return launch_g<T, 32>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                             split_keys, n_split, scale_log2, st);
    case 64:
      return launch_g<T, 64>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                             split_keys, n_split, scale_log2, st);
    case 128:
      return launch_g<T, 128>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                              split_keys, n_split, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Splits of `split_keys` keys must cover S; n_split is a cluster's size.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int S, int Hq, int Hkv,
                                    int group, int head_dim, int is_bf16,
                                    int split_keys, int n_split, float scale,
                                    void* stream) {
  if (B * Hkv == 0) return (int)cudaGetLastError();
  if (group < 1 || group > MAXG || n_split < 1 || n_split > MAX_SPLITS ||
      split_keys < 1 || (long long)split_keys * n_split < S)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float scale_log2 = scale * LOG2E;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(head_dim, q, k, v, lengths, o, B, S, Hq,
                                    Hkv, group, split_keys, n_split,
                                    scale_log2, st);
  if (head_dim == 16)   // f32 only: a bf16 row of 16 is two 16-byte chunks
    return launch_g<float, 16>(q, k, v, lengths, o, B, S, Hq, Hkv, group,
                               split_keys, n_split, scale_log2, st);
  return launch_dh<float>(head_dim, q, k, v, lengths, o, B, S, Hq, Hkv,
                          group, split_keys, n_split, scale_log2, st);
}
