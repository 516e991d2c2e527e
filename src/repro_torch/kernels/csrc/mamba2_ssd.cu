// K8 — the Mamba2 SSD scan for Hopper (sm_90a): the chunked form spread
// across the SMs at prefill, and a decode step that may update the state in
// place.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py::mamba2_ssd
// (`_kernel`): per (batch row, head h of group h / (H / G)), with the
// [N, P] state S in f32,
//   S   = exp(dt_t * A_h) S + (dt_t * B_t) x_t^T
//   y_t = C_t . S + D_h * x_t
// x, B, C and y are f32 or bf16; dt, A, D and the state are f32. P is 64,
// N 64 or 16, any T and any number of groups dividing the heads.
//
// What bounds it on this card. At the hybrid serve path's prefill (B 4,
// T 256, 64 heads, P 64, N 64, bf16) a call must move ~21.5 MB (6.4 us at
// 3.35 TB/s), and that bounds it. The sequential recurrence's 5 operations
// a state element and step (1.34 GFLOP) are the least any form needs; the
// chunked form below does ~1.6 GFLOP (the end state of all but the last
// chunk twice, and the sub-chunks' C B^T and W x). In bf16 they run on the
// tensor cores, an f32 product as at most three bf16 ones (1.34 GFLOP x 3,
// ~4.1 us at 989 TFLOP/s), under the bytes; in f32 they run as FMAs (~20
// us at 67 TFLOP/s), over them. At decode (T = 1) the f32 state read and
// written, 8.4 MB (2.5 us), bounds it.
//
// Design (the passes, tiles and sub-chunks are those of `chunk_scan.cuh`).
// 1. Prefill: chunks of CHUNK = 64 steps, a tile each. Pass 0 computes
//    each chunk's end state (chunk 0 from the initial state, with its y;
//    the others from 0) and decay exp(sum dt * A); pass 1 folds the state
//    before each later chunk from those and computes its y: 768 + 768
//    tiles at the serve shape. T <= CHUNK is one pass.
// 2. Inside a tile, sub-chunks of SUB = 16 steps. With dec_m = exp(dt_m A)
//    (one expf a step and head) and the sub-chunk's steps 0..15:
//      Ch_t = C_t * prod_{m<=t} dec_m      (C decayed from the sub-chunk's
//                                           start to step t)
//      Bh_j = B_j * dt_j * prod_{m>j} dec_m (step j's update decayed to the
//                                           sub-chunk's end)
//      W_tj = (C_t . B_j) * dt_j * prod_{j<m<=t} dec_m  for j <= t, else 0
//      y_t  = Ch_t . S + sum_j W_tj x_j + D x_t
//      S    = (prod_m dec_m) S + Bh^T x
//    every product taken from the per-step factors in order, so each decay
//    is a product of at most 16 factors in (0, 1]: exact to a few ulps for
//    any dt * A (at dt * A = -64 a step each factor, e^-64, and its
//    products underflow towards 0, as the sequential form's do), where
//    differences of a cumulative sum would lose digits once |sum| is large.
// 3. bf16 (the serve path) runs the three products on the tensor cores
//    (`ssd_chunk_mma`: mma.sync m16n8k16, f32 accumulators, a warp per 16
//    state columns, the state held in the accumulators). The f32 operands
//    Bh, S, Ch and W are sums of bf16 terms (three for Bh, two for the
//    rest), so the state keeps f32's accuracy and y is within ~2^-16 of
//    its terms before it is rounded to bf16 at its store, the one bf16
//    rounding point. f32 runs every product as an FMA on the CUDA cores
//    (`ssd_chunk_kernel`).
// 4. Loads overlap compute: a tile issues the `cp.async` copies of its four
//    sub-chunks' x, B and C rows at once, one commit group a sub-chunk, and
//    waits for sub-chunk s's group before computing it; rows past T are
//    zero-filled (dt = 0 there, so those steps leave S as it is).
// 5. Decode (T = 1): a 256-thread CTA a (row, head); a thread reads and
//    writes four rows of four columns with 16-byte vectors (a warp whole
//    256-byte rows) and loads its own rows' B and C, so nothing waits on a
//    barrier before the update; y is summed over the rows by one shuffle
//    and one exchange between the warps. (Split over four CTAs of 16
//    columns, the step took longer on the H100 with the L2 flushed.)
// 6. In place: every state element is read and then written by the one
//    thread that owns it, and only the pass that does not read s0 writes
//    s_out, so s0 and s_out may be one buffer: the model's cache slice.
// Sums are taken in a fixed order with no atomics: two launches give the
// same bits.

#include "chunk_scan.cuh"

namespace {

using namespace scan;
constexpr int P = COLS;   // head channel dim: state columns

// ---- f32: the CUDA cores -------------------------------------------------

// Shared memory of an f32 tile, in bytes from the dynamic base.
template <typename T, int N>
struct Geo {
  static constexpr int RPT = N / LANES;   // state rows a thread
  static constexpr int RS = RPT + 4;      // a lane's rows in Ch/Bh, padded
  static constexpr int HROW = LANES * RS; // one step of Ch / Bh (floats)
  static constexpr int FROW = N + 1;      // one step of Bf / Cf (floats)
  static constexpr int X_OFF = 0;                              // x [CHUNK][P]
  static constexpr int B_OFF = X_OFF + CHUNK * P * sizeof(T);  // B [CHUNK][N]
  static constexpr int C_OFF = B_OFF + CHUNK * N * sizeof(T);  // C [CHUNK][N]
  static constexpr int DT_OFF = C_OFF + CHUNK * N * sizeof(T); // dt [CHUNK]
  static constexpr int DEC_OFF = DT_OFF + CHUNK * 4;           // exp(dt A)
  static constexpr int BF_OFF = DEC_OFF + CHUNK * 4;           // B [SUB][FROW]
  static constexpr int CF_OFF = BF_OFF + SUB * FROW * 4;       // C [SUB][FROW]
  static constexpr int BH_OFF = CF_OFF + SUB * FROW * 4;       // Bh [SUB][HROW]
  static constexpr int CH_OFF = BH_OFF + SUB * HROW * 4;       // Ch [SUB][HROW]
  static constexpr int W_OFF = CH_OFF + SUB * HROW * 4;        // W [SUB][SUB]
  static constexpr int Y_OFF = W_OFF + SUB * SUB * 4;          // y [SUB][P]
  static constexpr int SMEM = Y_OFF + SUB * P * 4;
  static_assert(BH_OFF % 16 == 0 && CH_OFF % 16 == 0 && (RS * 4) % 16 == 0,
                "Ch and Bh are read as float4");
};

// A tile of pass `pass` (chunk_scan.cuh's Job) on the CUDA cores: thread
// (column p, lane g) owns S[g*RPT .. g*RPT + RPT - 1][p]; y_t sums C . S
// over the four lanes of a column (reduce_scatter4).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ D,
                 const float* s0, T* __restrict__ y, float* s_out,
                 float* slot, float* decay, int T_len, int H, int G,
                 int pass, int nc) {
  using Gm = Geo<T, N>;
  constexpr int RPT = Gm::RPT, RS = Gm::RS, HROW = Gm::HROW;
  constexpr int FROW = Gm::FROW, NE = N / SUB;
  extern __shared__ __align__(16) char smem[];
  const T* xs = reinterpret_cast<const T*>(smem + Gm::X_OFF);
  const T* bs = reinterpret_cast<const T*>(smem + Gm::B_OFF);
  const T* cs = reinterpret_cast<const T*>(smem + Gm::C_OFF);
  float* dts = reinterpret_cast<float*>(smem + Gm::DT_OFF);
  float* dec = reinterpret_cast<float*>(smem + Gm::DEC_OFF);
  float* bf = reinterpret_cast<float*>(smem + Gm::BF_OFF);
  float* cf = reinterpret_cast<float*>(smem + Gm::CF_OFF);
  float* bhat = reinterpret_cast<float*>(smem + Gm::BH_OFF);
  float* chat = reinterpret_cast<float*>(smem + Gm::CH_OFF);
  float* wm = reinterpret_cast<float*>(smem + Gm::W_OFF);
  float* ys = reinterpret_cast<float*>(smem + Gm::Y_OFF);

  const Job jb = job(pass, blockIdx.x, nc);
  const bool y_on = jb.y;
  const int tid = threadIdx.x;
  const int b = jb.bh / H, h = jb.bh % H, grp = h / (H / G);
  const int t0 = jb.c * CHUNK;
  const int len = min(CHUNK, T_len - t0);

  // the four sub-chunks' rows of x, B (and C) in flight, a group each
  const size_t xrow = (size_t)H * P * sizeof(T);   // bytes a time step
  const size_t brow = (size_t)G * N * sizeof(T);
  const char* xg = reinterpret_cast<const char*>(
      x + ((size_t)b * T_len + t0) * H * P + (size_t)h * P);
  const char* bg = reinterpret_cast<const char*>(
      Bm + ((size_t)b * T_len + t0) * G * N + (size_t)grp * N);
  const char* cg = reinterpret_cast<const char*>(
      Cm + ((size_t)b * T_len + t0) * G * N + (size_t)grp * N);
  for (int s = 0; s < NSUB; ++s) {
    if (s * SUB < len) {      // a sub-chunk past T stays an empty group
      stage_rows(smem + Gm::X_OFF, P * sizeof(T), xg, xrow, P * sizeof(T),
                 s * SUB, len, tid);
      stage_rows(smem + Gm::B_OFF, N * sizeof(T), bg, brow, N * sizeof(T),
                 s * SUB, len, tid);
      if (y_on)
        stage_rows(smem + Gm::C_OFF, N * sizeof(T), cg, brow,
                   N * sizeof(T), s * SUB, len, tid);
    }
    cp_async_commit();
  }
  const float a = A[h];
  if (tid < CHUNK) {
    const float d =
        tid < len ? dt[((size_t)b * T_len + t0 + tid) * H + h] : 0.f;
    dts[tid] = d;
    dec[tid] = expf(d * a);
  }

  const int p = tid >> 2;     // state column
  const int g = tid & 3;      // lane of the column: rows g*RPT + m
  float s[RPT];
  {
    int idx[RPT], row[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      row[m] = g * RPT + m;
      idx[m] = row[m] * P + p;
    }
    start_states<false>(s, idx, row, jb, s0, slot, decay, nc, N * P, N);
  }
  const float dh = D[h];
  float cdec = 1.f;           // the chunk's decay

  for (int sb = 0; sb < NSUB; ++sb) {
    const int r0 = sb * SUB;
    if (r0 >= len) break;     // uniform over the tile
    wait_sub(sb);
    __syncthreads();          // the sub-chunk's rows (and dt) landed
    const float* dc = dec + r0;
    float dblk = 1.f;
#pragma unroll
    for (int m = 0; m < SUB; ++m) dblk *= dc[m];
    {
      // step tt of the sub-chunk: its decayed operands; pair (tt, j): the
      // decay of step j's update at step tt
      const int tt = tid >> 4, j = tid & 15;
      float ep = 1.f, su = 1.f;
      for (int m = 0; m <= tt; ++m) ep *= dc[m];
      for (int m = tt + 1; m < SUB; ++m) su *= dc[m];
      const float wsuf = dts[r0 + tt] * su;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int n = j * NE + e;
        const int hn = (n / RPT) * RS + n % RPT;
        const float bv = to_f32(bs[(r0 + tt) * N + n]);
        bhat[tt * HROW + hn] = bv * wsuf;
        if (y_on) {
          const float cv = to_f32(cs[(r0 + tt) * N + n]);
          chat[tt * HROW + hn] = cv * ep;
          bf[tt * FROW + n] = bv;
          cf[tt * FROW + n] = cv;
        }
      }
      if (y_on) {
        float mm = 0.f;
        if (j <= tt) {
          mm = dts[r0 + j];
          for (int m = j + 1; m <= tt; ++m) mm *= dc[m];
        }
        __syncthreads();      // bf, cf complete
        float wv = 0.f;
        if (j <= tt) {
          float cb = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n)
            cb += cf[tt * FROW + n] * bf[j * FROW + n];
          wv = cb * mm;
        }
        wm[tt * SUB + j] = wv;
      }
    }
    __syncthreads();          // Bh, Ch, W complete

    if (y_on) {
      float acc[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        const float4* crow =
            reinterpret_cast<const float4*>(chat + t * HROW + g * RS);
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < RPT / 4; ++q) {
          const float4 cv = crow[q];
          v += cv.x * s[4 * q];
          v += cv.y * s[4 * q + 1];
          v += cv.z * s[4 * q + 2];
          v += cv.w * s[4 * q + 3];
        }
        acc[t] = v;
      }
      float ysum[4];
      reduce_scatter4(acc, ysum, g);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * g + q;
        float v = ysum[q];
        for (int j = 0; j <= t; ++j)
          v += wm[t * SUB + j] * to_f32(xs[(r0 + j) * P + p]);
        ys[t * P + p] = v + dh * to_f32(xs[(r0 + t) * P + p]);
      }
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m) s[m] *= dblk;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const float xv = to_f32(xs[(r0 + t) * P + p]);
      const float4* brw =
          reinterpret_cast<const float4*>(bhat + t * HROW + g * RS);
#pragma unroll
      for (int q = 0; q < RPT / 4; ++q) {
        const float4 bv = brw[q];
        s[4 * q] += bv.x * xv;
        s[4 * q + 1] += bv.y * xv;
        s[4 * q + 2] += bv.z * xv;
        s[4 * q + 3] += bv.w * xv;
      }
    }
    cdec *= dblk;
    __syncthreads();          // y staged; Bh, Ch, W free for the next
    if (y_on) {
      const int nt = min(SUB, len - r0);
      T* yb = y + ((size_t)b * T_len + t0 + r0) * H * P + (size_t)h * P;
      for (int e = tid; e < nt * P; e += THREADS)
        store(ys[e], yb + (size_t)(e / P) * H * P + e % P);
    }
  }

  if (float* so = end_state(jb, s_out, slot, nc, N * P)) {
#pragma unroll
    for (int m = 0; m < RPT; ++m) so[(size_t)(g * RPT + m) * P + p] = s[m];
  }
  if (jb.to_slot && tid == 0) decay[(size_t)jb.bh * nc + jb.c] = cdec;
}

// ---- bf16: the tensor cores ----------------------------------------------

// Shared memory of a bf16 tile, in bytes from the dynamic base. x, B and C
// of all four sub-chunks are staged at once, the chunk's row r at row r
// (the tile's occupancy is bound by its registers, not by shared memory);
// staged rows are padded so that the fragment loads of a warp fall in
// distinct banks.
template <int N>
struct GeoMma {
  static constexpr int XP = P + 8;        // x staging pitch (bf16)
  static constexpr int BP = N + 8;        // B, C staging pitch (bf16)
  static constexpr int MP = SUB + 1;      // a row of the table M (f32)
  static constexpr int YP = P + 4;        // a row of y (f32)
  static constexpr int X_OFF = 0;                       // x [CHUNK][XP]
  static constexpr int B_OFF = X_OFF + CHUNK * XP * 2;  // B [CHUNK][BP]
  static constexpr int C_OFF = B_OFF + CHUNK * BP * 2;  // C [CHUNK][BP]
  static constexpr int DT_OFF = C_OFF + CHUNK * BP * 2; // dt [CHUNK]
  static constexpr int DEC_OFF = DT_OFF + CHUNK * 4;       // exp(dt A)
  static constexpr int EP_OFF = DEC_OFF + CHUNK * 4;       // [NSUB][SUB]
  static constexpr int WS_OFF = EP_OFF + CHUNK * 4;        // [NSUB][SUB]
  static constexpr int DB_OFF = WS_OFF + CHUNK * 4;        // [NSUB]
  static constexpr int M_OFF = DB_OFF + NSUB * 4;          // [NSUB][SUB][MP]
  static constexpr int Y_OFF = M_OFF + NSUB * SUB * MP * 4;// y [SUB][YP]
  static constexpr int SMEM = Y_OFF + SUB * YP * 4;
  static_assert(B_OFF % 16 == 0 && C_OFF % 16 == 0 && Y_OFF % 16 == 0 &&
                    (XP * 2) % 16 == 0 && (BP * 2) % 16 == 0,
                "aligned regions and staged rows");
};

// The two bf16 of a register, as f32.
__device__ __forceinline__ float lo_f32(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// A tile of pass `pass` (chunk_scan.cuh's Job), bf16 on the tensor cores.
// The tile's four warps each own 16 state columns p: the state is held
// transposed, S^T [p][n], as m16n8 f32 accumulators. Per sub-chunk, with
// the decays of the design above (ep_t, wsuf_t, M_tj, the sub-chunk's dblk),
// every warp runs, on its own registers:
//   CB    = C B^T                       (exact bf16 inputs)
//   y^T   = ep . (S^T C^T) + X^T (CB * M)^T + D x
//   S^T  <- dblk S^T + (X^T * wsuf) B
// as m16n8k16 products with f32 sums: the decays scale the output columns
// (ep) or the operand X (wsuf), so B and C enter as they are staged. The
// f32 operands are sums of bf16 terms (split_bf16): X * wsuf three (exact),
// S and CB * M two (~16 bits). So the state keeps f32's accuracy and y's
// error (~2^-16 of its terms) is far inside the bf16 rounding at its
// store, the one bf16 rounding point of the result. The decay tables of
// all four sub-chunks are walked once, at the tile's start, a warp each
// (M a lane a column j; ep, wsuf and dblk a lane each).
template <int N>
__global__ void __launch_bounds__(MMA_THREADS)
ssd_chunk_mma(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ dt, const float* __restrict__ A,
              const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm,
              const float* __restrict__ D, const float* s0,
              __nv_bfloat16* __restrict__ y, float* s_out, float* slot,
              float* decay, int T_len, int H, int G, int pass, int nc) {
  using bf16 = __nv_bfloat16;
  using Gm = GeoMma<N>;
  constexpr int NT = N / 8, KS = N / 16, XP = Gm::XP, BP = Gm::BP;
  constexpr int MP = Gm::MP, YP = Gm::YP;
  extern __shared__ __align__(16) char smem[];
  float* dts = reinterpret_cast<float*>(smem + Gm::DT_OFF);
  float* dec = reinterpret_cast<float*>(smem + Gm::DEC_OFF);
  float* eps = reinterpret_cast<float*>(smem + Gm::EP_OFF);
  float* wss = reinterpret_cast<float*>(smem + Gm::WS_OFF);
  float* dbs = reinterpret_cast<float*>(smem + Gm::DB_OFF);
  float* ms = reinterpret_cast<float*>(smem + Gm::M_OFF);
  float* ys = reinterpret_cast<float*>(smem + Gm::Y_OFF);

  const Job jb = job(pass, blockIdx.x, nc);
  const bool y_on = jb.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int b = jb.bh / H, h = jb.bh % H, gi = h / (H / G);
  const int t0 = jb.c * CHUNK;
  const int len = min(CHUNK, T_len - t0);

  const size_t xrow = (size_t)H * P * 2, brow = (size_t)G * N * 2;
  const char* xg = reinterpret_cast<const char*>(
      x + ((size_t)b * T_len + t0) * H * P + (size_t)h * P);
  const char* bg = reinterpret_cast<const char*>(
      Bm + ((size_t)b * T_len + t0) * G * N + (size_t)gi * N);
  const char* cg = reinterpret_cast<const char*>(
      Cm + ((size_t)b * T_len + t0) * G * N + (size_t)gi * N);
  // sub-chunk s's rows, one commit group a sub-chunk (empty past T)
  auto stage = [&](int s) {
    if (s * SUB < len) {
      const int r0 = s * SUB;
      stage_rows<MMA_THREADS>(smem + Gm::X_OFF, XP * 2, xg, xrow, P * 2, r0,
                              len, tid);
      stage_rows<MMA_THREADS>(smem + Gm::B_OFF, BP * 2, bg, brow, N * 2, r0,
                              len, tid);
      if (y_on)
        stage_rows<MMA_THREADS>(smem + Gm::C_OFF, BP * 2, cg, brow, N * 2,
                                r0, len, tid);
    }
    cp_async_commit();
  };
  // dt and the start state go out before the bulk copies, which would
  // queue ahead of them
  const float a = A[h];
  if (tid < CHUNK) {
    const float d =
        tid < len ? dt[((size_t)b * T_len + t0 + tid) * H + h] : 0.f;
    dts[tid] = d;
    dec[tid] = expf(d * a);
  }
  // S^T [p][n]: rows p0 + grp (+8), columns 8nt + 2tig (+1)
  const int p0 = 16 * warp;
  float st[NT][4];
  {
    float sv[NT * 4];
    int idx[NT * 4], row[NT * 4];
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) {
      row[e] = 8 * (e >> 2) + 2 * tig + (e & 1);
      idx[e] = row[e] * P + p0 + grp + 8 * ((e >> 1) & 1);
    }
    start_states<false>(sv, idx, row, jb, s0, slot, decay, nc, N * P, N);
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) st[e >> 2][e & 3] = sv[e];
  }
  for (int s = 0; s < NSUB; ++s) stage(s);
  const float dh = D[h];
  __syncthreads();            // dt, dec complete
  {
    // warp w: the decay tables of sub-chunk w
    const float* dc = dec + warp * SUB;
    float d[SUB];
#pragma unroll
    for (int m = 0; m < SUB; ++m) d[m] = dc[m];
    if (lane < SUB) {         // M [t][j] = dt_j prod_{j<m<=t} dec_m
      const int j = lane;
      float mm = dts[warp * SUB + j];
      float* mw = ms + warp * SUB * MP;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        if (t > j) mm *= d[t];
        mw[t * MP + j] = t >= j ? mm : 0.f;
      }
    } else if (lane == SUB) { // ep_t = prod_{m<=t} dec_m, dblk
      float e = 1.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        e *= d[t];
        eps[warp * SUB + t] = e;
      }
      dbs[warp] = e;
    } else if (lane == SUB + 1) {  // wsuf_t = dt_t prod_{m>t} dec_m
      float q = 1.f;
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        wss[warp * SUB + t] = dts[warp * SUB + t] * q;
        q *= d[t];
      }
    }
  }
  float cdec = 1.f;

  for (int sb = 0; sb < NSUB; ++sb) {
    const int r0 = sb * SUB;
    if (r0 >= len) break;     // uniform over the tile
    wait_sub(sb);
    __syncthreads();          // the sub-chunk's rows (and the tables) landed
    const bf16* xs = reinterpret_cast<const bf16*>(smem + Gm::X_OFF) + r0 * XP;
    const bf16* bs = reinterpret_cast<const bf16*>(smem + Gm::B_OFF) + r0 * BP;
    const bf16* cs = reinterpret_cast<const bf16*>(smem + Gm::C_OFF) + r0 * BP;
    const float* ep = eps + r0;
    const float* ws = wss + r0;
    const float dblk = dbs[sb];

    uint32_t xa[4];           // X^T [p][t] of the warp's columns
    xt_fragment(xa, xs, XP, p0, grp, tig);
    // (X^T * wsuf) as three bf16 terms; element (row, step): a0 (grp,
    // 2tig..), a1 (grp+8, 2tig..), a2 (grp, 2tig+8..), a3 (grp+8, ..)
    uint32_t xw[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = 2 * tig + 8 * (q >> 1);
      uint32_t tz[3];
      split_pair<3>(lo_f32(xa[q]) * ws[t], hi_f32(xa[q]) * ws[t + 1], tz);
#pragma unroll
      for (int z = 0; z < 3; ++z) xw[z][q] = tz[z];
    }
    if (y_on) {
      // C B^T: rows t (grp, grp + 8), columns j (8jt + 2tig ..)
      float cb[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* cr = cs + grp * BP + 16 * kk + 2 * tig;
        const uint32_t af[4] = {ld32(cr), ld32(cr + 8 * BP), ld32(cr + 8),
                                ld32(cr + 8 * BP + 8)};
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const bf16* br = bs + (8 * jt + grp) * BP + 16 * kk + 2 * tig;
          mma_bf16(cb[jt], af, ld32(br), ld32(br + 8));
        }
      }
      float yi[2][4] = {}, ya[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t shi[4], slo[4];
        st_fragments<NT>(shi, slo, st, kk);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const bf16* cr = cs + (8 * tt + grp) * BP + 16 * kk + 2 * tig;
          const uint32_t c0 = ld32(cr), c1 = ld32(cr + 8);
          mma_bf16(yi[tt], shi, c0, c1);
          mma_bf16(yi[tt], slo, c0, c1);
        }
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        // W = CB * M as the B fragment of step rows t = 8tt + grp: b0 the
        // columns j = 2tig, 2tig + 1 (tile 0), b1 those + 8 (tile 1)
        const int t = 8 * tt + grp;
        const float* mr = ms + (sb * SUB + t) * MP + 2 * tig;
        uint32_t wb[2][2];
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          uint32_t tz[2];
          split_pair<2>(cb[jt][2 * tt] * mr[8 * jt],
                        cb[jt][2 * tt + 1] * mr[8 * jt + 1], tz);
          wb[0][jt] = tz[0];
          wb[1][jt] = tz[1];
        }
        mma_bf16(ya[tt], xa, wb[0][0], wb[0][1]);
        mma_bf16(ya[tt], xa, wb[1][0], wb[1][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tq = 8 * tt + 2 * tig + (q & 1);
          const int pp = p0 + grp + 8 * (q >> 1);
          ys[tq * YP + pp] = yi[tt][q] * ep[tq] + ya[tt][q] +
                             dh * __bfloat162float(xs[tq * XP + pp]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) st[nt][q] *= dblk;
      // B [t][n] of columns n = 8nt + grp: b0 steps 2tig .., b1 2tig + 8 ..
      const bf16* bc = bs + 2 * tig * BP + 8 * nt + grp;
      const uint32_t b0 = pack2(bc[0], bc[BP]);
      const uint32_t b1 = pack2(bc[8 * BP], bc[9 * BP]);
#pragma unroll
      for (int z = 0; z < 3; ++z) mma_bf16(st[nt], xw[z], b0, b1);
    }
    cdec *= dblk;
    __syncthreads();          // y staged
    if (y_on) {
      const int nt2 = min(SUB, len - r0);
      bf16* yb = y + ((size_t)b * T_len + t0 + r0) * H * P + (size_t)h * P;
      for (int e = tid; e < nt2 * (P / 2); e += MMA_THREADS) {
        const int t = e / (P / 2), pp = 2 * (e % (P / 2));
        *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)t * H * P + pp) =
            __floats2bfloat162_rn(ys[t * YP + pp], ys[t * YP + pp + 1]);
      }
    }
  }
  cp_async_wait<0>();         // no copy outlives the tile

  if (float* so = end_state(jb, s_out, slot, nc, N * P)) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = 8 * nt + 2 * tig + (q & 1), pp = p0 + grp + 8 * (q >> 1);
        so[(size_t)n * P + pp] = st[nt][q];
      }
  }
  if (jb.to_slot && tid == 0) decay[(size_t)jb.bh * nc + jb.c] = cdec;
}

// ---- decode ---------------------------------------------------------------

// Decode (T = 1): one CTA of DEC_THREADS a (batch row, head); thread (row
// group rg, column quad cq) owns rows rg*RD .. rg*RD + RD - 1 of columns
// cq*4 .. cq*4 + 3, so a warp reads and writes whole 256-byte rows. A
// thread loads its own rows' B and C and its columns' x (vector loads), so
// no barrier comes before the state update; y is summed over the row
// groups by one shuffle and one exchange between the warps.
template <typename T, int N>
__global__ void __launch_bounds__(DEC_THREADS)
ssd_decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  const float* s0, T* __restrict__ y, float* s_out, int H,
                  int G) {
  constexpr int RG = DEC_THREADS / (P / 4);     // row groups: 16
  constexpr int RD = N / RG;                    // rows a thread: 4 or 1
  static_assert(RD == 1 || RD == 4, "a thread's rows: one, or four");
  __shared__ float4 part[DEC_THREADS / 32][P / 4];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int tid = threadIdx.x, cq = tid % (P / 4), rg = tid / (P / 4);
  const int col = cq * 4;

  float4 sv[RD];
#pragma unroll
  for (int m = 0; m < RD; ++m) {
    const size_t off = ((size_t)bh * N + rg * RD + m) * P + col;
    sv[m] = s0 != nullptr ? *reinterpret_cast<const float4*>(s0 + off)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const size_t roff = ((size_t)b * G + grp) * N + rg * RD;
  float bn[RD], cn[RD];
  if constexpr (RD == 4) {
    const float4 bq = load4v(Bm + roff), cq4 = load4v(Cm + roff);
    bn[0] = bq.x, bn[1] = bq.y, bn[2] = bq.z, bn[3] = bq.w;
    cn[0] = cq4.x, cn[1] = cq4.y, cn[2] = cq4.z, cn[3] = cq4.w;
  } else {
    bn[0] = to_f32(Bm[roff]);
    cn[0] = to_f32(Cm[roff]);
  }
  const float4 xv = load4v(x + (size_t)bh * P + col);
  const float d = dt[bh];
  const float dec = expf(d * A[h]);
  const float dh = D[h];
  float4 yp = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < RD; ++m) {
    const float db = d * bn[m];
    float4 v = sv[m];
    v.x = v.x * dec + db * xv.x;
    v.y = v.y * dec + db * xv.y;
    v.z = v.z * dec + db * xv.z;
    v.w = v.w * dec + db * xv.w;
    *reinterpret_cast<float4*>(
        s_out + ((size_t)bh * N + rg * RD + m) * P + col) = v;
    yp.x += cn[m] * v.x;
    yp.y += cn[m] * v.y;
    yp.z += cn[m] * v.z;
    yp.w += cn[m] * v.w;
  }
  yp.x += __shfl_xor_sync(0xffffffffu, yp.x, 16);
  yp.y += __shfl_xor_sync(0xffffffffu, yp.y, 16);
  yp.z += __shfl_xor_sync(0xffffffffu, yp.z, 16);
  yp.w += __shfl_xor_sync(0xffffffffu, yp.w, 16);
  if ((tid & 31) < 16) part[tid >> 5][cq] = yp;
  __syncthreads();
  if (tid < P / 4) {         // rg 0: xv holds columns col .. col + 3
    float4 acc = part[0][tid];
#pragma unroll
    for (int q = 1; q < DEC_THREADS / 32; ++q) {
      const float4 pq = part[q][tid];
      acc.x += pq.x;
      acc.y += pq.y;
      acc.z += pq.z;
      acc.w += pq.w;
    }
    T* yo = y + (size_t)bh * P + col;
    store(acc.x + dh * xv.x, yo);
    store(acc.y + dh * xv.y, yo + 1);
    store(acc.z + dh * xv.z, yo + 2);
    store(acc.w + dh * xv.w, yo + 3);
  }
}

// The chunk kernel of a dtype: f32 on the CUDA cores, bf16 on the tensor
// cores.
template <typename T, int N>
struct Chunk {
  static constexpr int THREADS_ = THREADS, SMEM = Geo<T, N>::SMEM;
  static auto kernel() { return ssd_chunk_kernel<T, N>; }
};
template <int N>
struct Chunk<__nv_bfloat16, N> {
  static constexpr int THREADS_ = MMA_THREADS, SMEM = GeoMma<N>::SMEM;
  static auto kernel() { return ssd_chunk_mma<N>; }
};

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* s0, void* y,
           void* s_out, void* slot, void* decay, int Bt, int T_len, int H,
           int G, cudaStream_t stream) {
  const int BH = Bt * H;
  const T* xp = (const T*)x;
  const T* bp = (const T*)Bm;
  const T* cp = (const T*)Cm;
  const float *dtp = (const float*)dt, *ap = (const float*)A,
              *dp = (const float*)D;
  if (T_len == 1) {
    ssd_decode_kernel<T, N><<<(unsigned)BH, DEC_THREADS, 0, stream>>>(
        xp, dtp, ap, bp, cp, dp, (const float*)s0, (T*)y, (float*)s_out, H,
        G);
    return (int)cudaGetLastError();
  }
  using K = Chunk<T, N>;
  const auto kernel = K::kernel();
  static bool opted = false;
  const int rc = opt_in(kernel, K::SMEM, opted);
  if (rc) return rc;
  const int nc = (T_len + CHUNK - 1) / CHUNK;
  return run_passes(BH, T_len, slot != nullptr && decay != nullptr,
                    [&](int pass, int tiles) {
                      kernel<<<(unsigned)tiles, K::THREADS_, K::SMEM,
                               stream>>>(xp, dtp, ap, bp, cp, dp,
                                         (const float*)s0, (T*)y,
                                         (float*)s_out, (float*)slot,
                                         (float*)decay, T_len, H, G, pass,
                                         nc);
                      return (int)cudaGetLastError();
                    });
}

template <typename T>
int launch_n(int N, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, const void* D, const void* s0,
             void* y, void* s_out, void* slot, void* decay, int Bt, int T_len,
             int H, int G, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, D, s0, y, s_out, slot, decay,
                           Bt, T_len, H, G, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, D, s0, y, s_out, slot, decay,
                           Bt, T_len, H, G, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [Bt,T,H,P], dt [Bt,T,H], A, D [H], B, C [Bt,T,G,N], s0 (or null) and
// s_out [Bt,H,N,P] (may be one buffer), y [Bt,T,H,P]; for T > chunk the
// scratch `slot` [Bt*H, ceil(T / chunk), N, P] and `decay` [Bt*H,
// ceil(T / chunk)] f32. `chunk` must be this file's CHUNK.
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* s0, void* y, void* s_out,
                              void* slot, void* decay, int Bt, int T_len,
                              int H, int G, int N, int head_dim, int chunk,
                              int is_bf16, void* stream) {
  if (head_dim != P || chunk != CHUNK || T_len < 1 || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (Bt * H == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_n<__nv_bfloat16>(N, x, dt, A, Bm, Cm, D, s0, y, s_out,
                                   slot, decay, Bt, T_len, H, G, st);
  return launch_n<float>(N, x, dt, A, Bm, Cm, D, s0, y, s_out, slot, decay,
                         Bt, T_len, H, G, st);
}
