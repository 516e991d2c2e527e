// K10 — blockwise symmetric int8 codec for Hopper (sm_90a), standalone and
// fused into the error-feedback gradient sync.
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
// Two entry points share that block codec (`encode_block`, a warp's block
// in registers):
//
// quantize_int8_launch: the codec alone. Bound by bytes: per element 4 B
// (f32) or 2 B (bf16) read, 1 + 4/block B written; at the 283.1 M f32 leaf
// 1.42 GB, 0.424 ms at 3.35 TB/s, against ~10 operations an element.
//
// ef_sync_leaf_launch: one leaf of the error-feedback sync
// (src/repro/train/step.py:143-157: ef_compress, compression_error_norm,
// reduce_gradients at the int8 level, in a world of one) in one pass, for g
// (bf16 or f32) and the f32 residual r:
//   c     = r + g                                  (f32)
//   kept  = c, or at level 2 c where |c| >= its block's threshold, else 0
//   g_hat = dequantize(codec(kept))                (q1 * s1)
//   r     = c - g_hat                              (in place)
//   num   = sum (g - g_hat)^2,  den = sum g^2      (the leaf's error terms)
//   (q2, s2) = codec(g_hat), out = q2 * s2         (the int8 reduce: the
//           all-gather would move q2 and s2; the sum of one copy is out)
// The unfused sequence moved ~104 B an element through ~10 torch kernels and
// two codec launches; this pass reads g and r once and writes r, out, q2 and
// s2: 15 B an element at bf16 g, 49.5 GB and 14.78 ms at 3.35 TB/s over
// MiniCPM-2B's 3.29 G parameters. The level-2 thresholds (each block's
// round(k * block)-th largest |c|) are an input, the torch order statistic
// of `core/ecollectives.topk_thresholds`.
//
// What held the parent kernel (one warp a block, scalar 4-byte loads and
// 1-byte stores, a grid of 132 x 32 CTAs) at 1.07 TB/s (1.322 ms at the
// 283.1 M f32 leaf) was bytes in flight, not the division. Design, each
// choice from trial builds timed on the H100 (CUDA events, L2 flushed):
// - A warp owns one quantization block at a time: lane l holds, in chunk i,
//   the VEC consecutive elements at i * 32 * VEC + l * VEC, read with one
//   16-byte load (4 f32 or 8 bf16; the fused pass reads 4 elements of g
//   and of r a chunk, 8-byte loads for a bf16 g), so one warp-wide load
//   covers 512 contiguous bytes. The block's max is a 5-step xor shuffle,
//   which leaves it in every lane.
// - Codes go out VEC at a time as one packed store (4 codes in 32 bits at
//   f32, 8 in 64 at bf16); floats as 16-byte stores.
// - Bytes in flight come from many resident warps: a grid of up to
//   132 x 64 CTAs of 8 warps, each warp striding over blocks. In trial
//   builds, lower caps (8, 16, 32 CTAs an SM) were slower; a warp loading
//   two or four blocks before encoding the first, or evict-first cache
//   hints, gained nothing over more CTAs; no cap at all was as fast for the
//   codec and slower for the fused pass (a partial sum for every 8
//   blocks).
// - Division: __fdiv_rn stays. A reciprocal a block with an exact fallback
//   near each .5 boundary was no faster in a trial build, since the bytes
//   bound the pass. But __fdiv_rn takes its slow path on a zero dividend:
//   the fused pass, whose level-2 blocks are three quarters zeros, encodes
//   a zero as 0 without dividing, which made level 2 as fast as level 1
//   (the codec alone, on data with few zeros, divides them).
// - Offsets: a block's base is 64-bit, offsets inside it 32-bit; only the
//   last block, when n is not a multiple of the block, takes bounds-checked
//   scalar loads (the wrapper never pads a copy), and its padded positions
//   are encoded as zeros and never stored as floats.
// - Alignment: the 16-byte accesses need 16-byte-aligned pointers; the
//   wrappers refuse others.
// - The vector path is built for the train step's block, 256 (two float4
//   or one 8-bf16 chunk a lane); every other block runs a scalar kernel:
//   lane l takes elements l + 32 i.
//
// Exactness traps of the fused pass (each would break bit equality with
// the plain version, `kernels/quant_codec.ef_sync_leaf_plain`):
// - FMA contraction. nvcc contracts a * b + c into an FMA by default; the
//   plain version rounds the product first (q1 * s1, then c - g_hat; g - g_hat,
//   then its square, then the sum). Every product, sum and difference here
//   is __fmul_rn / __fadd_rn / __fsub_rn, which are never contracted.
// - error_sums' dtypes. For a bf16 g the plain version's g ** 2 rounds each
//   square to bf16 before summing (and returns the sum as bf16), while
//   (g - g_hat) ** 2 is f32; the kernel rounds g * g to bf16 the same way.
// - Deterministic sums. Each lane adds its block's terms in f32, in order,
//   then into a per-lane double; the warp and the CTA reduce in a fixed
//   order, and each CTA writes its own partial pair (no float atomics). The
//   grid depends only on n (`ef_sync_leaf_grid`), so two launches give the
//   same bits; the wrapper sums the partials with one torch sum. Against
//   the plain version's f32 sums only the order differs.
// - The ragged tail is zero-padded as `_pad_to_block` pads it: padded
//   positions write no r and no out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER_LANE = 32;   // block <= 1024
// the grid's cap: 64 CTAs an SM of the H100's 132 (more than fit at once,
// so the blocks in flight come from many warps a scheduler)
constexpr long long MAX_GRID = 132LL * 64;
// the train step's block: the codec's vector path and the fused pass
constexpr int BLOCK = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;   // b NaN: a > b is false -> b
}

// The block's scale from each lane's partial absmax (every lane gets it).
__device__ __forceinline__ float block_scale(float amax) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

// One code: clip(rint(v / s)), a NaN's code 0. SKIP_ZEROS returns 0 for a
// zero without dividing: __fdiv_rn takes its slow path on a zero dividend,
// which slowed the fused pass's masked level-2 blocks.
template <bool SKIP_ZEROS>
__device__ __forceinline__ int encode(float v, float s) {
  if (SKIP_ZEROS && v == 0.f) return 0;
  const float r = rintf(__fdiv_rn(v, s));
  return isnan(r) ? 0 : (int)fminf(fmaxf(r, -127.f), 127.f);
}

// The codec on a warp's block: v holds this lane's N values (zeros past
// the block's end); writes their codes, returns the block's scale.
template <int N, bool SKIP_ZEROS = false>
__device__ __forceinline__ float encode_block(const float (&v)[N],
                                              int (&code)[N]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) amax = nan_max(amax, fabsf(v[i]));
  const float s = block_scale(amax);
#pragma unroll
  for (int i = 0; i < N; ++i) code[i] = encode<SKIP_ZEROS>(v[i], s);
  return s;
}

// ---- vector loads and stores -------------------------------------------

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// VEC consecutive elements at p (aligned to VEC * sizeof(T)) as f32: 4
// f32 (16 bytes), or 8 or 4 bf16 (16 or 8 bytes).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  static_assert(VEC == 4, "f32 is read 4 at a time");
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(VEC == 8 || VEC == 4, "bf16 is read 8 or 4 at a time");
  uint32_t w[VEC / 2];
  if constexpr (VEC == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  }
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = bf2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack4(const int* c) {
  return (uint32_t)(c[0] & 0xff) | ((uint32_t)(c[1] & 0xff) << 8) |
         ((uint32_t)(c[2] & 0xff) << 16) | ((uint32_t)(c[3] & 0xff) << 24);
}

// VEC (8 or 4) codes at p (aligned to VEC bytes) in one store.
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* p, const int* c) {
  if constexpr (VEC == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(c), pack4(c + 4));
  else
    *reinterpret_cast<uint32_t*>(p) = pack4(c);
}

// This lane's CH chunks of VEC elements of block xb: vector loads, or,
// on the ragged last block (`rem` elements left), checked scalar loads with
// zeros past the end.
template <int VEC, int CH, typename T>
__device__ __forceinline__ void load_block(const T* xb, int lane, int rem,
                                           bool ragged, float (&v)[CH * VEC]) {
  if (!ragged) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      load_vec<VEC>(xb + c * 32 * VEC + lane * VEC, v + c * VEC);
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = c * 32 * VEC + lane * VEC + i;
        v[c * VEC + i] = j < rem ? to_f32(xb[j]) : 0.f;
      }
  }
}

template <int VEC, int CH>
__device__ __forceinline__ void store_block(float* yb, int lane, int rem,
                                            bool ragged,
                                            const float (&v)[CH * VEC]) {
  static_assert(VEC == 4, "floats are stored 4 at a time");
  if (!ragged) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      store_vec4(yb + c * 32 * VEC + lane * VEC, v + c * VEC);
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = c * 32 * VEC + lane * VEC + i;
        if (j < rem) yb[j] = v[c * VEC + i];
      }
  }
}

// ---- quantize_int8: the codec alone ------------------------------------

// Block 256: VEC elements of T in a 16-byte load, CH chunks a lane.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_int8_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, long long n,
                         long long nblocks) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = BLOCK / (32 * VEC);
  constexpr int N = VEC * CH;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       b < nblocks; b += stride) {
    const long long rem = n - b * BLOCK;
    float v[N];
    int code[N];
    load_block<VEC, CH>(x + b * BLOCK, lane, (int)min(rem, (long long)BLOCK),
                        rem < BLOCK, v);
    const float s = encode_block<N>(v, code);
    int8_t* qb = q + b * BLOCK;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      store_codes<VEC>(qb + c * 32 * VEC + lane * VEC, code + c * VEC);
    if (lane == 0) scale[b] = s;
  }
}

// Any block that is a multiple of 32: lane l takes elements l + 32 i.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_int8_scalar_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scale, long long n,
                            long long nblocks, int block) {
  const int lane = threadIdx.x & 31;
  const int per_lane = block >> 5;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       b < nblocks; b += stride) {
    const T* xb = x + b * block;
    const int rem = (int)min(n - b * block, (long long)block);
    float v[MAX_PER_LANE];
    int code[MAX_PER_LANE];
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = (i < per_lane && j < rem) ? to_f32(xb[j]) : 0.f;
    }
    const float s = encode_block<MAX_PER_LANE>(v, code);
#pragma unroll
    for (int i = 0; i < MAX_PER_LANE; ++i)
      if (i < per_lane) q[b * block + lane + 32 * i] = (int8_t)code[i];
    if (lane == 0) scale[b] = s;
  }
}

long long grid_for(long long nblocks) {
  const long long grid = (nblocks + WARPS - 1) / WARPS;
  return grid < MAX_GRID ? grid : MAX_GRID;
}

// ---- ef_sync_leaf: the error-feedback sync of one leaf ------------------

template <typename G>
__global__ void __launch_bounds__(THREADS)
ef_sync_leaf_kernel(const G* __restrict__ g, float* __restrict__ r,
                    const float* __restrict__ thresh, float* __restrict__ out,
                    int8_t* __restrict__ q, float* __restrict__ scale,
                    double* __restrict__ partial, long long n,
                    long long nblocks) {
  constexpr int VEC = 4;
  constexpr int CH = BLOCK / (32 * VEC);
  constexpr int N = VEC * CH;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * WARPS;
  double num = 0.0, den = 0.0;
  for (long long b = (long long)blockIdx.x * WARPS + warp; b < nblocks;
       b += stride) {
    const long long rem = n - b * BLOCK;
    const int rm = (int)min(rem, (long long)BLOCK);
    const bool ragged = rem < BLOCK;
    float gv[N], c[N], kept[N], gh[N];
    int code[N];
    const float t = thresh != nullptr ? thresh[b] : 0.f;
    load_block<VEC, CH>(g + b * BLOCK, lane, rm, ragged, gv);
    load_block<VEC, CH>(r + b * BLOCK, lane, rm, ragged, c);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      c[i] = __fadd_rn(c[i], gv[i]);                        // r + g
      kept[i] = (thresh == nullptr || fabsf(c[i]) >= t) ? c[i] : 0.f;
    }
    const float s1 = encode_block<N, true>(kept, code);
    float e_sum = 0.f, g_sum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      gh[i] = __fmul_rn((float)code[i], s1);                // g_hat
      c[i] = __fsub_rn(c[i], gh[i]);                        // r' = c - g_hat
      const float e = __fsub_rn(gv[i], gh[i]);
      e_sum = __fadd_rn(e_sum, __fmul_rn(e, e));
      float g2 = __fmul_rn(gv[i], gv[i]);
      if constexpr (sizeof(G) == 2)                          // bf16 g ** 2
        g2 = __bfloat162float(__float2bfloat16_rn(g2));
      g_sum = __fadd_rn(g_sum, g2);
    }
    num += (double)e_sum;
    den += (double)g_sum;
    store_block<VEC, CH>(r + b * BLOCK, lane, rm, ragged, c);
    const float s2 = encode_block<N, true>(gh, code);
#pragma unroll
    for (int i = 0; i < N; ++i) gh[i] = __fmul_rn((float)code[i], s2);
    store_block<VEC, CH>(out + b * BLOCK, lane, rm, ragged, gh);
    int8_t* qb = q + b * BLOCK;
#pragma unroll
    for (int k = 0; k < CH; ++k)
      store_codes<VEC>(qb + k * 32 * VEC + lane * VEC, code + k * VEC);
    if (lane == 0) scale[b] = s2;
  }
  // the CTA's partial sums: the warp's lanes, then its warps, in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  __shared__ double sums[WARPS][2];
  if (lane == 0) {
    sums[warp][0] = num;
    sums[warp][1] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, d = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      a += sums[w][0];
      d += sums[w][1];
    }
    partial[2 * blockIdx.x] = a;
    partial[2 * blockIdx.x + 1] = d;
  }
}

template <typename G>
int launch_ef(const void* g, void* r, const void* thresh, void* out, void* q,
              void* scale, void* partial, long long n, cudaStream_t st) {
  const long long nblocks = (n + BLOCK - 1) / BLOCK;
  ef_sync_leaf_kernel<G><<<(unsigned)grid_for(nblocks), THREADS, 0, st>>>(
      (const G*)g, (float*)r, (const float*)thresh, (float*)out, (int8_t*)q,
      (float*)scale, (double*)partial, n, nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: n elements, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned;
// q: nblocks * block int8; scale: nblocks f32. block is a multiple of 32 up
// to 1024 and n > 0 (the wrapper checks all three).
extern "C" int quantize_int8_launch(const void* x, void* q, void* scale,
                                    long long n, int block, int is_bf16,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nblocks = (n + block - 1) / block;
  const unsigned grid = (unsigned)grid_for(nblocks);
  if (block == BLOCK) {
    if (is_bf16)
      quantize_int8_vec_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          (const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, n, nblocks);
    else
      quantize_int8_vec_kernel<float><<<grid, THREADS, 0, st>>>(
          (const float*)x, (int8_t*)q, (float*)scale, n, nblocks);
  } else if (is_bf16) {
    quantize_int8_scalar_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, n, nblocks,
        block);
  } else {
    quantize_int8_scalar_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)scale, n, nblocks, block);
  }
  return (int)cudaGetLastError();
}

// The CTAs ef_sync_leaf_launch runs for n elements: the rows of its
// `partial` output.
extern "C" int ef_sync_leaf_grid(long long n) {
  return (int)grid_for((n + BLOCK - 1) / BLOCK);
}

// One leaf's error-feedback sync in blocks of 256. g: n elements, f32
// (is_bf16 = 0) or bf16; r: n f32, updated in place; thresh: nblocks f32
// (level 2) or null (level 1); out: n f32; q: nblocks * 256 int8; scale:
// nblocks f32; partial: ef_sync_leaf_grid(n) pairs of doubles (sum (g -
// g_hat)^2, sum g^2). n > 0 and g, r, out 16-byte aligned (the wrapper
// checks all).
extern "C" int ef_sync_leaf_launch(const void* g, void* r, const void* thresh,
                                   void* out, void* q, void* scale,
                                   void* partial, long long n, int is_bf16,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_ef<__nv_bfloat16>(g, r, thresh, out, q, scale, partial, n,
                                    st);
  return launch_ef<float>(g, r, thresh, out, q, scale, partial, n, st);
}
