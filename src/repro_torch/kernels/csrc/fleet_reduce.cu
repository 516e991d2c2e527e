// K6 — fleet telemetry reduction for Hopper (sm_90a), and the fleet train
// step's whole reduction tail in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fleet_telemetry.py::fleet_reduce
// (`_kernel`): x [n_chips, n_fields] f32 -> per-field max, min and sum over
// the chips (`fleet_reduce_launch`). `fleet_stats_launch` computes every
// `fleet/*` metric of the fleet train step from its fields as they stand:
// worst (or min) and mean of five fields, the p95 of two, the straggler
// fraction, the SOR confidence's mean and min.
//
// What bounds it on this card: at the fleet step's 64 chips the bytes
// (1.3 KB for K6, 2.1 KB for the tail) take under a nanosecond at
// 3.35 TB/s; both are bound by latency: the launch, one round trip to
// memory, the combine. So every job is in flight at once, one CTA each
// (K6: a field; the tail: five fields, two p95s, the stragglers, the
// confidence), each sized by n (one warp up to 256 values, more warps past
// that, at most 1024 threads). `fold` is the routine every field goes
// through: a thread issues all its loads (up to ITEMS) before it combines
// them, a warp's partials meet in a shuffle tree and, with more than one
// warp, warp 0 folds the warps' partials from shared memory. The order of
// the sums depends on the sizes alone, so the same input gives the same
// bits every run.
//
// The p95 is an exact order statistic, interpolated as torch.quantile does
// on the card: ranks = f32(q) * (n - 1) in f32, the values at ranks
// floor and ceil, and torch.lerp, whose products nvcc contracts into FMAs
// (so `__fmaf_rn` here). The two values are selected by counting ranks in
// shared memory up to RANK_MAX values (n^2 compares, fastest at the
// step's n), by a radix select over the f32 bits past it (4 passes over
// the field, any n). A NaN anywhere in the field gives NaN, as
// torch.quantile's does.
//
// Means: torch divides by a Python int and takes Tensor.mean on the card
// as a multiply by the f32 reciprocal of n; so does `mean` here.
//
// NaN: jnp.max / jnp.min propagate NaN, CUDA's fmaxf / fminf drop it. The
// combine here propagates it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ITEMS = 8;           // loads a thread issues before combining
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int RANK_MAX = 128;      // p95 by rank counting up to here
constexpr unsigned FULL = 0xffffffffu;

// fleet_stats' output slots, in the order of `fleet_telemetry.STATS_KEYS`
enum Slot {
  WORST_OR_MIN = 0,    // 2 * field: worst (v_io: min); 2 * field + 1: mean
  T_FLEET = 10,
  P95 = 11,            // t_chip_s, grad_error
  STRAGGLER = 13,
  CONF_MEAN = 14,
  CONF_MIN = 15,
};
enum Field { POWER_W, T_CHIP_S, GRAD_ERROR, ENERGY_STEP_J, V_IO, N_FIELDS };

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;   // b NaN: a > b is false -> b
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

struct Fold {
  float mx, mn, sum;
};

__device__ __forceinline__ Fold combine(Fold a, Fold b) {
  return {nan_max(a.mx, b.mx), nan_min(a.mn, b.mn), a.sum + b.sum};
}

__device__ __forceinline__ Fold warp_fold(Fold a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = combine(a, {__shfl_xor_sync(FULL, a.mx, o),
                    __shfl_xor_sync(FULL, a.mn, o),
                    __shfl_xor_sync(FULL, a.sum, o)});
  }
  return a;
}

// Fold n values (value i is load(i)) over the CTA; the result is valid in
// thread 0. Thread t takes i = base + t + k * blockDim.x, k < ITEMS.
template <class Load>
__device__ Fold fold(const Load& load, int n) {
  __shared__ Fold part[MAX_WARPS];
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = T >> 5;
  Fold acc{-INFINITY, INFINITY, 0.f};
  for (int base = 0; base < n; base += T * ITEMS) {
    float v[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = base + tid + k * T;
      v[k] = i < n ? load(i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (base + tid + k * T < n) acc = combine(acc, {v[k], v[k], v[k]});
    }
  }
  acc = warp_fold(acc);
  if (nw > 1) {
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = warp_fold(lane < nw ? part[lane]
                                : Fold{-INFINITY, INFINITY, 0.f});
    }
  }
  return acc;
}

__device__ __forceinline__ float mean(float sum, int n) {
  return __fmul_rn(sum, __fdiv_rn(1.f, (float)n));
}

// f32 bits -> an unsigned key in the floats' order (-0 before +0)
__device__ __forceinline__ unsigned to_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// torch.lerp(a, b, w) as torch's card kernel computes it
__device__ __forceinline__ float torch_lerp(float a, float b, float w) {
  const float d = __fsub_rn(b, a);
  return w < 0.5f ? __fmaf_rn(w, d, a)
                  : __fmaf_rn(-d, __fsub_rn(1.f, w), b);
}

// The keys of ranks `lo` and `hi` (0-based, ascending) of x[0, n), n <=
// RANK_MAX, by counting: the value of x[i] holds the ranks from #{x_j <
// x_i} up to #{x_j <= x_i}. Sets *nan if any x is NaN. Valid in every
// thread.
__device__ void rank_pair(const float* __restrict__ x, int n, int lo,
                          int hi, unsigned* key_lo, unsigned* key_hi,
                          bool* nan) {
  __shared__ unsigned keys[RANK_MAX];
  __shared__ unsigned sel[2];
  const int tid = threadIdx.x, T = blockDim.x;
  bool any_nan = false;
  for (int i = tid; i < n; i += T) {
    const float v = x[i];
    any_nan |= isnan(v);
    keys[i] = to_key(v);
  }
  *nan = __syncthreads_or(any_nan);
  for (int i = tid; i < n; i += T) {
    const unsigned ki = keys[i];
    int lt = 0, le = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned kj = keys[j];
      lt += kj < ki;
      le += kj <= ki;
    }
    // equal keys are equal bits: several threads may write one value
    if (lt <= lo && lo < le) sel[0] = ki;
    if (lt <= hi && hi < le) sel[1] = ki;
  }
  __syncthreads();
  *key_lo = sel[0];
  *key_hi = sel[1];
}

__device__ unsigned block_min_u32(unsigned v) {
  __shared__ unsigned part[MAX_WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = part[0];
  for (int w = 1; w < nw; ++w) v = min(v, part[w]);
  return v;
}

// The keys of ranks `lo` and `hi` (hi is lo or lo + 1) of x[0, n), any n,
// by a radix select over 8-bit digits, most significant first: each pass
// counts the keys that share the prefix found so far by their next digit
// (shared atomics), and warp 0 finds the bin that holds rank lo. Rank hi,
// when it is not a tie of rank lo, is the least key above it. Sets *nan
// if any x is NaN. Valid in every thread.
__device__ void radix_pair(const float* __restrict__ x, int n, int lo,
                           int hi, unsigned* key_lo, unsigned* key_hi,
                           bool* nan) {
  __shared__ __align__(16) unsigned hist[256];
  __shared__ unsigned s_prefix, s_rank, s_count;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  unsigned prefix = 0, rank = (unsigned)lo, count = 0;
  bool any_nan = false;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const unsigned high = shift == 24 ? 0u : FULL << (shift + 8);
    for (int b = tid; b < 256; b += T) hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += T) {
      const float v = x[i];
      any_nan |= isnan(v);
      const unsigned k = to_key(v);
      if ((k & high) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    *nan = __syncthreads_or(any_nan);
    if (tid < 32) {
      const uint4 c0 = reinterpret_cast<const uint4*>(hist)[2 * lane];
      const uint4 c1 = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
      const unsigned c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      unsigned s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += c[j];
      unsigned incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      // the first lane whose running count passes the rank holds its bin
      const unsigned hit = __ballot_sync(FULL, rank < incl);
      if (lane == __ffs(hit) - 1) {
        unsigned below = incl - s;
        int bin = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (bin < 0) {
            if (rank < below + c[j]) {
              bin = j;
              s_count = c[j];
            } else {
              below += c[j];
            }
          }
        }
        s_prefix = prefix | ((unsigned)(8 * lane + bin) << shift);
        s_rank = rank - below;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    rank = s_rank;
    count = s_count;
  }
  *key_lo = prefix;
  if (hi == lo || rank + 1 < count) {   // rank hi ties rank lo
    *key_hi = prefix;
    return;
  }
  unsigned m = FULL;
  for (int i = tid; i < n; i += T) {
    const unsigned k = to_key(x[i]);
    if (k > prefix) m = min(m, k);
  }
  *key_hi = block_min_u32(m);
}

// out = torch.quantile(x[0, n), q) on the card: thread 0 writes it
__device__ void quantile(const float* __restrict__ x, int n, float q,
                         float* out) {
  const float ranks = __fmul_rn(q, (float)(n - 1));
  const int lo = (int)ranks;
  const float w = __fsub_rn(ranks, (float)lo);
  const int hi = lo + (w > 0.f);
  unsigned key_lo, key_hi;
  bool nan;
  if (n <= RANK_MAX) {
    rank_pair(x, n, lo, hi, &key_lo, &key_hi, &nan);
  } else {
    radix_pair(x, n, lo, hi, &key_lo, &key_hi, &nan);
  }
  if (threadIdx.x == 0) {
    *out = nan ? __uint_as_float(0x7fffffffu)
               : torch_lerp(from_key(key_lo), from_key(key_hi), w);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
fleet_reduce_kernel(const float* __restrict__ x, float* __restrict__ mx,
                    float* __restrict__ mn, float* __restrict__ sm,
                    int n_chips, int n_fields) {
  const int f = blockIdx.x;
  const Fold r = fold(
      [&](int i) { return x[(size_t)i * n_fields + f]; }, n_chips);
  if (threadIdx.x == 0) {
    mx[f] = r.mx;
    mn[f] = r.mn;
    sm[f] = r.sum;
  }
}

struct StatsArgs {
  const float* field[N_FIELDS];   // power_w, t_chip_s, grad_error,
                                  // energy_step_j, v_io: each [n]
  const unsigned char* straggle;  // [n] bool
  const float* conf;              // [m], or null: no confidence stats
  float* out;
  int n, m;
  float q;
};

// a.field[f] without indexing the kernel's parameters at run time (which
// copies them to the stack)
__device__ __forceinline__ const float* field(const StatsArgs& a, int f) {
  switch (f) {
    case POWER_W: return a.field[POWER_W];
    case T_CHIP_S: return a.field[T_CHIP_S];
    case GRAD_ERROR: return a.field[GRAD_ERROR];
    case ENERGY_STEP_J: return a.field[ENERGY_STEP_J];
    default: return a.field[V_IO];
  }
}

// CTA 0-4: field b's worst (v_io: min) and mean, and t_fleet_s; CTA 5, 6:
// the p95 of t_chip_s, grad_error; CTA 7: the straggler fraction; CTA 8:
// the confidence's mean and min.
__global__ void __launch_bounds__(MAX_THREADS)
fleet_stats_kernel(const StatsArgs a) {
  const int job = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  if (job < N_FIELDS) {
    const float* __restrict__ x = field(a, job);
    const Fold r = fold([&](int i) { return x[i]; }, a.n);
    if (lead) {
      a.out[WORST_OR_MIN + 2 * job] = job == V_IO ? r.mn : r.mx;
      a.out[WORST_OR_MIN + 2 * job + 1] = mean(r.sum, a.n);
      if (job == T_CHIP_S) a.out[T_FLEET] = r.mx;
    }
  } else if (job < N_FIELDS + 2) {
    quantile(job == N_FIELDS ? a.field[T_CHIP_S] : a.field[GRAD_ERROR],
             a.n, a.q, a.out + P95 + (job - N_FIELDS));
  } else if (job == N_FIELDS + 2) {
    const unsigned char* __restrict__ s = a.straggle;
    const Fold r = fold([&](int i) { return s[i] ? 1.f : 0.f; }, a.n);
    if (lead) a.out[STRAGGLER] = mean(r.sum, a.n);
  } else {
    const float* __restrict__ c = a.conf;
    const Fold r = fold([&](int i) { return c[i]; }, a.m);
    if (lead) {
      a.out[CONF_MEAN] = mean(r.sum, a.m);
      a.out[CONF_MIN] = r.mn;
    }
  }
}

// one warp up to 256 values, then a warp per 256 more, at most 1024 threads
int threads_for(int n) {
  const int t = ((n + ITEMS - 1) / ITEMS + 31) / 32 * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

}  // namespace

extern "C" int fleet_reduce_launch(const void* x, void* mx, void* mn,
                                   void* sm, int n_chips, int n_fields,
                                   void* stream) {
  if (n_fields == 0) return (int)cudaGetLastError();
  fleet_reduce_kernel<<<n_fields, threads_for(n_chips), 0,
                        (cudaStream_t)stream>>>(
      (const float*)x, (float*)mx, (float*)mn, (float*)sm, n_chips,
      n_fields);
  return (int)cudaGetLastError();
}

extern "C" int fleet_stats_launch(const void* power_w, const void* t_chip_s,
                                  const void* grad_error,
                                  const void* energy_step_j,
                                  const void* v_io, const void* straggle,
                                  const void* conf, void* out, int n, int m,
                                  float q, void* stream) {
  StatsArgs a;
  a.field[POWER_W] = (const float*)power_w;
  a.field[T_CHIP_S] = (const float*)t_chip_s;
  a.field[GRAD_ERROR] = (const float*)grad_error;
  a.field[ENERGY_STEP_J] = (const float*)energy_step_j;
  a.field[V_IO] = (const float*)v_io;
  a.straggle = (const unsigned char*)straggle;
  a.conf = (const float*)conf;
  a.out = (float*)out;
  a.n = n;
  a.m = conf ? m : 0;
  a.q = q;
  const int jobs = N_FIELDS + 3 + (conf ? 1 : 0);
  fleet_stats_kernel<<<jobs, threads_for(n > a.m ? n : a.m), 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
