// K9 — the RWKV6 ("Finch") recurrence for Hopper (sm_90a): the chunked
// gated-linear-attention form spread across the SMs at prefill, and a
// decode step that may update the state in place.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// (`_kernel`): per (batch row, head), with the [Dh, Dh] key-major state S
// in f32,
//   y_t = r_t . (S + (u * k_t) v_t^T)
//   S   = diag(exp(w_t)) S + k_t v_t^T          (w_t <= 0: log-decay)
// r, k, v and y are f32 or bf16; w, u and the state are f32; Dh is 64, any
// T.
//
// What bounds it on this card. At the serve path's prefill (B 4, T 256,
// 64 heads, Dh 64, bf16) a call must move ~54.5 MB (16.3 us at 3.35
// TB/s), and that bounds it. The sequential recurrence's 5 operations a
// state element and step (1.34 GFLOP) are the least any form needs; the
// chunked form below does ~1.7 GFLOP (the end state of all but the last
// chunk twice, and the sub-chunks' causal scores). In bf16 the products
// with the state run on the tensor cores, an f32 product as at most three
// bf16 ones (1.34 GFLOP x 3, ~4.1 us at 989 TFLOP/s), under the bytes; in
// f32 they run as FMAs (~20 us at 67 TFLOP/s), under f32's ~92 MB. At decode
// (T = 1) the f32 state read and written, 8.4 MB (2.5 us), bounds it.
//
// Design (the passes, tiles and sub-chunks are those of `chunk_scan.cuh`;
// rows are keys i, columns values j).
// 1. Prefill: chunks of CHUNK = 64 steps, a tile each. Pass 0 computes
//    each chunk's end state (chunk 0 from the initial state, with its y;
//    the others from 0) and per-key decay prod_t exp(w_t); pass 1 folds
//    the state before each later chunk from those and computes its y: 768
//    + 768 tiles at the serve shape. T <= CHUNK is one pass.
// 2. Inside a tile, sub-chunks of SUB = 16 steps (Yang et al., "Gated
//    Linear Attention Transformers with Hardware-Efficient Training",
//    2023: the secondary chunking for a per-channel decay). With e_t =
//    exp(w_t) (one expf an element, in place over the staged w) and the
//    sub-chunk's steps 0..15:
//      rh_t = r_t * prod_{m<t} e_m         (r decayed from the start)
//      kh_j = k_j * prod_{m>j} e_m         (k decayed to the end)
//      A_tj = sum_i r_t[i] k_j[i] prod_{j<m<t} e_m[i]   for j < t
//      A_tt = sum_i r_t[i] (u[i] k_t[i])                (the bonus)
//      y_t  = rh_t . S + sum_{j<=t} A_tj v_j
//      S    = diag(prod_m e_m) S + kh^T v
//    The trap of the factorised form, e^{W_t} e^{-W_j} with W the
//    cumulative log-decay, is that e^{-W_j} overflows f32 once the span's
//    sum |w| passes ~88, which w = -exp(N(-1, 1)) reaches inside 64 steps.
//    Here every decay is a running product of at most 16 factors e_m in
//    (0, 1], taken in order: A's off-diagonal terms by a walk along t for
//    each (j, group of keys) that multiplies k_j by e_t after each step's
//    score. Nothing overflows for any w <= 0, and a decay underflows only
//    where its exact value is below f32's range.
// 3. bf16 (the serve path) runs rh . S, A v and the state update on the
//    tensor cores (`wkv_chunk_mma`: mma.sync m16n8k16, f32 accumulators, a
//    warp per 16 value columns, the state held in the accumulators). The
//    f32 operands kh, S, rh and A are sums of bf16 terms (three for kh,
//    two for the rest), so the state keeps f32's accuracy and y is within
//    ~2^-16 of its terms before it is rounded to bf16 at its store, the
//    one bf16 rounding point. The decays and A's scores are taken on the
//    CUDA cores in both dtypes; f32 runs every product as an FMA
//    (`wkv_chunk_kernel`).
// 4. Loads overlap compute: a tile issues the `cp.async` copies of its four
//    sub-chunks' r, k, v and w rows at once, a commit group a sub-chunk,
//    and waits for sub-chunk s's group before computing it; rows past T
//    are zero-filled (w = 0 there, e = 1, so those steps leave S as it
//    is).
// 5. Decode (T = 1): a 256-thread CTA a (row, head); a thread reads and
//    writes four rows of four columns with 16-byte vectors (a warp whole
//    256-byte rows) and loads its own keys' r, k, w and u, so nothing
//    waits on a barrier before the update (exp(w) is taken by each of the
//    16 threads that share a key: 16 K expf a step, cheaper than a
//    barrier); y is summed over the rows by one shuffle and one exchange
//    between the warps. (Split over four CTAs of 16 columns, the step took
//    longer on the H100 with the L2 flushed.)
// 6. In place: every state element is read and then written by the one
//    thread that owns it, and only the pass that does not read s0 writes
//    s_out, so s0 and s_out may be one buffer: the model's cache slice.
// Sums are taken in a fixed order with no atomics: two launches give the
// same bits.

#include "chunk_scan.cuh"

namespace {

using namespace scan;
constexpr int DH = COLS;    // head dim (key and value)

// ---- f32: the CUDA cores -------------------------------------------------

// Shared memory of an f32 tile, in bytes from the dynamic base.
template <typename T>
struct Geo {
  static constexpr int RPT = DH / LANES;  // state rows (keys) a thread
  static constexpr int RS = RPT + 4;      // a lane's keys in rh/kh, padded
  static constexpr int HROW = LANES * RS; // one step of rh / kh (floats)
  static constexpr int K_OFF = 0;                              // k [CHUNK][DH]
  static constexpr int V_OFF = K_OFF + CHUNK * DH * sizeof(T); // v
  static constexpr int W_OFF = V_OFF + CHUNK * DH * sizeof(T); // w, then e
  static constexpr int KH_OFF = W_OFF + CHUNK * DH * 4;        // kh [SUB][HROW]
  static constexpr int DB_OFF = KH_OFF + SUB * HROW * 4;       // prod e [DH]
  static constexpr int R_OFF = DB_OFF + DH * 4;                // r [CHUNK][DH]
  static constexpr int RH_OFF = R_OFF + CHUNK * DH * sizeof(T);// rh [SUB][HROW]
  static constexpr int PS = SUB * SUB + 1;                     // padded
  static constexpr int PART_OFF = RH_OFF + SUB * HROW * 4;     // [16][PS]
  static constexpr int A_OFF = PART_OFF + 16 * PS * 4;         // A [SUB][SUB]
  static constexpr int Y_OFF = A_OFF + SUB * SUB * 4;          // y [SUB][DH]
  static constexpr int SMEM = Y_OFF + SUB * DH * 4;
  static_assert(KH_OFF % 16 == 0 && RH_OFF % 16 == 0 && DB_OFF % 16 == 0 &&
                    (RS * 4) % 16 == 0,
                "rh, kh and the decays are read as float4");
};

// A tile of pass `pass` (chunk_scan.cuh's Job) on the CUDA cores: thread
// (value column j, lane g) owns S[g*RPT .. g*RPT + RPT - 1][j]; y_t sums
// rh . S over the four lanes of a column (reduce_scatter4).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s0,
                 T* __restrict__ y, float* s_out, float* slot, float* decay,
                 int T_len, int H, int pass, int nc) {
  using Gm = Geo<T>;
  constexpr int RPT = Gm::RPT, RS = Gm::RS, HROW = Gm::HROW;
  extern __shared__ __align__(16) char smem[];
  const T* ks = reinterpret_cast<const T*>(smem + Gm::K_OFF);
  const T* vs = reinterpret_cast<const T*>(smem + Gm::V_OFF);
  float* es = reinterpret_cast<float*>(smem + Gm::W_OFF);
  float* kh = reinterpret_cast<float*>(smem + Gm::KH_OFF);
  float* db = reinterpret_cast<float*>(smem + Gm::DB_OFF);
  const T* rs = reinterpret_cast<const T*>(smem + Gm::R_OFF);
  float* rh = reinterpret_cast<float*>(smem + Gm::RH_OFF);
  float* part = reinterpret_cast<float*>(smem + Gm::PART_OFF);
  float* am = reinterpret_cast<float*>(smem + Gm::A_OFF);
  float* ys = reinterpret_cast<float*>(smem + Gm::Y_OFF);

  const Job jb = job(pass, blockIdx.x, nc);
  const bool y_on = jb.y;
  const int tid = threadIdx.x;
  const int b = jb.bh / H, h = jb.bh % H;
  const int t0 = jb.c * CHUNK;
  const int len = min(CHUNK, T_len - t0);

  // the four sub-chunks' rows of k, v, w (and r) in flight, a group each
  const size_t base = ((size_t)b * T_len + t0) * H * DH + (size_t)h * DH;
  const size_t trow = (size_t)H * DH * sizeof(T);    // bytes a time step
  const size_t wrow = (size_t)H * DH * 4;
  for (int s = 0; s < NSUB; ++s) {
    if (s * SUB < len) {      // a sub-chunk past T stays an empty group
      stage_rows(smem + Gm::K_OFF, DH * sizeof(T),
                 reinterpret_cast<const char*>(k + base), trow,
                 DH * sizeof(T), s * SUB, len, tid);
      stage_rows(smem + Gm::V_OFF, DH * sizeof(T),
                 reinterpret_cast<const char*>(v + base), trow,
                 DH * sizeof(T), s * SUB, len, tid);
      stage_rows(smem + Gm::W_OFF, DH * 4,
                 reinterpret_cast<const char*>(w + base), wrow, DH * 4,
                 s * SUB, len, tid);
      if (y_on)
        stage_rows(smem + Gm::R_OFF, DH * sizeof(T),
                   reinterpret_cast<const char*>(r + base), trow,
                   DH * sizeof(T), s * SUB, len, tid);
    }
    cp_async_commit();
  }

  const int jc = tid >> 2;    // state column (value index)
  const int g = tid & 3;      // lane of the column: keys g*RPT + m
  float s[RPT];
  {
    int idx[RPT], row[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      row[m] = g * RPT + m;
      idx[m] = row[m] * DH + jc;
    }
    start_states<true>(s, idx, row, jb, s0, slot, decay, nc, DH * DH, DH);
  }
  float cdec = 1.f;           // thread i < DH: key i's chunk decay

  for (int sb = 0; sb < NSUB; ++sb) {
    const int r0 = sb * SUB;
    if (r0 >= len) break;     // uniform over the tile
    wait_sub(sb);
    __syncthreads();          // the sub-chunk's rows landed
    float* e = es + r0 * DH;  // the sub-chunk's w, then e = exp(w)
    for (int q = tid; q < SUB * DH; q += THREADS) e[q] = expf(e[q]);
    __syncthreads();
    const T* kr = ks + r0 * DH;
    const T* rr = rs + r0 * DH;
    if (tid < DH) {
      // key i: rh (with y) and the sub-chunk's decay, by a forward walk
      const int i = tid, hi = (i / RPT) * RS + i % RPT;
      float pr = 1.f;
      for (int t = 0; t < SUB; ++t) {
        if (y_on) rh[t * HROW + hi] = to_f32(rr[t * DH + i]) * pr;
        pr *= e[t * DH + i];
      }
      db[i] = pr;
      cdec *= pr;
    } else if (tid < 2 * DH) {
      // key i: kh by a backward walk
      const int i = tid - DH, hi = (i / RPT) * RS + i % RPT;
      float q = 1.f;
      for (int t = SUB - 1; t >= 0; --t) {
        kh[t * HROW + hi] = to_f32(kr[t * DH + i]) * q;
        q *= e[t * DH + i];
      }
    }
    if (y_on) {
      // (j, keys 4cg .. 4cg + 3): the partial scores of step j's key at
      // every later step t of the sub-chunk, and the bonus at t = j
      const int j = tid >> 4, cg = tid & 15, i0 = 4 * cg;
      const float4 kj = load4(kr + j * DH + i0);
      const float4 rj = load4(rr + j * DH + i0);
      const float4 uh = load4(u + (size_t)h * DH + i0);
      float* pc = part + cg * Gm::PS;
      pc[j * SUB + j] = rj.x * (uh.x * kj.x) + rj.y * (uh.y * kj.y) +
                        rj.z * (uh.z * kj.z) + rj.w * (uh.w * kj.w);
      float4 co = kj;
      for (int t = j + 1; t < SUB; ++t) {
        const float4 rt = load4(rr + t * DH + i0);
        pc[t * SUB + j] = rt.x * co.x + rt.y * co.y + rt.z * co.z +
                          rt.w * co.w;
        const float4 et = *reinterpret_cast<const float4*>(e + t * DH + i0);
        co.x *= et.x;
        co.y *= et.y;
        co.z *= et.z;
        co.w *= et.w;
      }
      __syncthreads();        // partial scores, rh, kh, db complete
      const int tt = tid >> 4, jj = tid & 15;
      float a = 0.f;
      if (jj <= tt)
        for (int q = 0; q < 16; ++q) a += part[q * Gm::PS + tt * SUB + jj];
      am[tt * SUB + jj] = a;
    }
    __syncthreads();          // A, rh, kh, db complete

    const T* vr = vs + r0 * DH;
    if (y_on) {
      float acc[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        const float4* rw =
            reinterpret_cast<const float4*>(rh + t * HROW + g * RS);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < RPT / 4; ++q) {
          const float4 rv = rw[q];
          a += rv.x * s[4 * q];
          a += rv.y * s[4 * q + 1];
          a += rv.z * s[4 * q + 2];
          a += rv.w * s[4 * q + 3];
        }
        acc[t] = a;
      }
      float ysum[4];
      reduce_scatter4(acc, ysum, g);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * g + q;
        float a = ysum[q];
        for (int j = 0; j <= t; ++j)
          a += am[t * SUB + j] * to_f32(vr[j * DH + jc]);
        ys[t * DH + jc] = a;
      }
    }
    const float4* dq = reinterpret_cast<const float4*>(db + g * RPT);
#pragma unroll
    for (int q = 0; q < RPT / 4; ++q) {
      const float4 d = dq[q];
      s[4 * q] *= d.x;
      s[4 * q + 1] *= d.y;
      s[4 * q + 2] *= d.z;
      s[4 * q + 3] *= d.w;
    }
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const float vv = to_f32(vr[t * DH + jc]);
      const float4* kw =
          reinterpret_cast<const float4*>(kh + t * HROW + g * RS);
#pragma unroll
      for (int q = 0; q < RPT / 4; ++q) {
        const float4 kv = kw[q];
        s[4 * q] += kv.x * vv;
        s[4 * q + 1] += kv.y * vv;
        s[4 * q + 2] += kv.z * vv;
        s[4 * q + 3] += kv.w * vv;
      }
    }
    __syncthreads();          // y staged; kh, rh, A, db free for the next
    if (y_on) {
      const int nt = min(SUB, len - r0);
      T* yb = y + base + (size_t)r0 * H * DH;
      for (int q = tid; q < nt * DH; q += THREADS)
        store(ys[q], yb + (size_t)(q / DH) * H * DH + q % DH);
    }
  }

  if (float* so = end_state(jb, s_out, slot, nc, DH * DH)) {
#pragma unroll
    for (int m = 0; m < RPT; ++m) so[(size_t)(g * RPT + m) * DH + jc] = s[m];
  }
  if (jb.to_slot && tid < DH)
    decay[((size_t)jb.bh * nc + jb.c) * DH + tid] = cdec;
}

// ---- bf16: the tensor cores ----------------------------------------------

// Shared memory of a bf16 tile, in bytes from the dynamic base. r, k, v
// and w go through a ring of two sub-chunks (the tables take the rest: a
// deeper ring would cost a CTA an SM); staged rows and the operand tables
// are padded so that the fragment loads fall in distinct banks. y is
// staged over the partial scores, which are spent by then.
struct GeoMma {
  static constexpr int RING = 2;          // sub-chunks in flight
  static constexpr int TP = DH + 8;       // r, k, v staging pitch (bf16)
  static constexpr int TROW = SUB + 8;    // a row of kh^T and A (bf16)
  static constexpr int KROW = DH + 8;     // a row of rh (bf16)
  static constexpr int KG = 16;           // key groups of the score walk
  static constexpr int PS = SUB * SUB + 2;  // a group's scores, padded
  static constexpr int YP = DH + 4;       // a row of y (f32)
  static constexpr int K_OFF = 0;                        // k [RING][SUB][TP]
  static constexpr int V_OFF = K_OFF + RING * SUB * TP * 2;    // v
  static constexpr int R_OFF = V_OFF + RING * SUB * TP * 2;    // r
  static constexpr int W_OFF = R_OFF + RING * SUB * TP * 2;    // w, then e
  static constexpr int KH_OFF = W_OFF + RING * SUB * DH * 4;  // kh^T [3][DH][..]
  static constexpr int DB_OFF = KH_OFF + 3 * DH * TROW * 2; // prod e [DH] f32
  static constexpr int RH_OFF = DB_OFF + DH * 4;            // rh [2][SUB][KROW]
  static constexpr int A_OFF = RH_OFF + 2 * SUB * KROW * 2; // A [2][SUB][TROW]
  static constexpr int PART_OFF = A_OFF + 2 * SUB * TROW * 2; // [KG][PS]
  static constexpr int Y_OFF = PART_OFF;                    // y [SUB][YP]
  static constexpr int SMEM = PART_OFF + KG * PS * 4;
  static_assert(SUB * YP <= KG * PS, "y fits over the scores");
  static_assert(V_OFF % 16 == 0 && R_OFF % 16 == 0 && W_OFF % 16 == 0 &&
                    DB_OFF % 16 == 0 && PART_OFF % 16 == 0,
                "aligned regions");
};

// A tile of pass `pass` (chunk_scan.cuh's Job), bf16 on the tensor cores.
// The tile's four warps each own 16 value columns j: the state is held
// transposed, S^T [j][i], as m16n8 f32 accumulators, so that
//   y^T   = S^T rh^T + V^T A^T     (A: S^T from the accumulators, V^T)
//   S^T  <- S^T diag(db) + V^T kh  (A: V^T; B: kh)
// are m16n8k16 products with f32 sums. r, k and v are bf16 already; the f32
// operands are sums of bf16 terms (split_bf16): kh three (exact), S, rh
// and A two (~16 bits), S rh taken as hi*hi + lo*hi + hi*lo. So the state
// keeps f32's accuracy and y's error (~2^-16 of its terms) is far inside
// the bf16 rounding at its store, the one bf16 rounding point of the
// result. The decays (e, rh, kh, db) and A's scores are taken on the CUDA
// cores by walks along the sub-chunk: a thread a key for rh (forward) or
// kh (backward), and for the scores a thread a pair of steps (j, 15 - j)
// and four keys, both walks sharing each step's loads (a step at or
// before j multiplies by 1, so no lane branches), with each key group's
// partial scores on its own banks.
__global__ void __launch_bounds__(MMA_THREADS)
wkv_chunk_mma(const __nv_bfloat16* __restrict__ r,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ w, const float* __restrict__ u,
              const float* s0, __nv_bfloat16* __restrict__ y, float* s_out,
              float* slot, float* decay, int T_len, int H, int pass,
              int nc) {
  using bf16 = __nv_bfloat16;
  using Gm = GeoMma;
  constexpr int NT = DH / 8, KS = DH / 16, TP = Gm::TP, TROW = Gm::TROW;
  constexpr int KROW = Gm::KROW, KG = Gm::KG, YP = Gm::YP;
  constexpr int KPG = DH / KG;              // keys a score-walk group
  static_assert(KPG == 4 && MMA_THREADS == KG * SUB / 2,
                "a score-walk thread: two steps, a float4 of keys");
  extern __shared__ __align__(16) char smem[];
  bf16* kht = reinterpret_cast<bf16*>(smem + Gm::KH_OFF);
  float* db = reinterpret_cast<float*>(smem + Gm::DB_OFF);
  bf16* rhs = reinterpret_cast<bf16*>(smem + Gm::RH_OFF);
  float* part = reinterpret_cast<float*>(smem + Gm::PART_OFF);
  bf16* ams = reinterpret_cast<bf16*>(smem + Gm::A_OFF);
  float* ys = reinterpret_cast<float*>(smem + Gm::Y_OFF);

  const Job jb = job(pass, blockIdx.x, nc);
  const bool y_on = jb.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int b = jb.bh / H, h = jb.bh % H;
  const int t0 = jb.c * CHUNK;
  const int len = min(CHUNK, T_len - t0);

  const size_t base = ((size_t)b * T_len + t0) * H * DH + (size_t)h * DH;
  const size_t trow = (size_t)H * DH * 2, wrow = (size_t)H * DH * 4;
  // sub-chunk s's rows into ring slot s % RING (the staged row r0 + i of
  // the chunk lands at row i of the slot), one commit group a sub-chunk
  constexpr int RING = Gm::RING;
  auto stage = [&](int s) {
    if (s < NSUB && s * SUB < len) {
      const int o = (s % RING) * SUB, r0 = s * SUB;
      stage_rows<MMA_THREADS>(smem + Gm::K_OFF + (o - r0) * TP * 2, TP * 2,
                              reinterpret_cast<const char*>(k + base), trow,
                              DH * 2, r0, len, tid);
      stage_rows<MMA_THREADS>(smem + Gm::V_OFF + (o - r0) * TP * 2, TP * 2,
                              reinterpret_cast<const char*>(v + base), trow,
                              DH * 2, r0, len, tid);
      stage_rows<MMA_THREADS>(smem + Gm::W_OFF + (o - r0) * DH * 4, DH * 4,
                              reinterpret_cast<const char*>(w + base), wrow,
                              DH * 4, r0, len, tid);
      if (y_on)
        stage_rows<MMA_THREADS>(smem + Gm::R_OFF + (o - r0) * TP * 2,
                                TP * 2,
                                reinterpret_cast<const char*>(r + base),
                                trow, DH * 2, r0, len, tid);
    }
    cp_async_commit();
  };
  // the start state goes out before the bulk copies, which would queue
  // ahead of it. S^T [j][i]: rows j0 + grp (+8), columns 8nt + 2tig (+1)
  const int j0 = 16 * warp;
  float st[NT][4];
  {
    float sv[NT * 4];
    int idx[NT * 4], row[NT * 4];
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) {
      row[e] = 8 * (e >> 2) + 2 * tig + (e & 1);
      idx[e] = row[e] * DH + j0 + grp + 8 * ((e >> 1) & 1);
    }
    start_states<true>(sv, idx, row, jb, s0, slot, decay, nc, DH * DH, DH);
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) st[e >> 2][e & 3] = sv[e];
  }
  for (int s = 0; s < RING; ++s) stage(s);
  // the score walk's steps (sj, SUB - 1 - sj), keys i0 .. i0 + KPG - 1, and
  // their bonus u
  const int sj = tid / KG, i0 = KPG * (tid % KG);
  float uk[KPG];
#pragma unroll
  for (int z = 0; z < KPG; ++z) uk[z] = u[(size_t)h * DH + i0 + z];
  float cdec = 1.f;           // thread i < DH: key i's chunk decay

  for (int sb = 0; sb < NSUB; ++sb) {
    const int r0 = sb * SUB;
    if (r0 >= len) break;     // uniform over the tile
    cp_async_wait<RING - 1>();  // group sb landed
    __syncthreads();
    const int o = (sb % RING) * SUB;
    const bf16* kr = reinterpret_cast<const bf16*>(smem + Gm::K_OFF) + o * TP;
    const bf16* vr = reinterpret_cast<const bf16*>(smem + Gm::V_OFF) + o * TP;
    const bf16* rr = reinterpret_cast<const bf16*>(smem + Gm::R_OFF) + o * TP;
    float* e = reinterpret_cast<float*>(smem + Gm::W_OFF) + o * DH;
    for (int q = tid; q < SUB * DH; q += MMA_THREADS) e[q] = expf(e[q]);
    __syncthreads();          // e = exp(w) of the sub-chunk
    if (tid < DH) {
      // key i: rh (with y; two terms) and the sub-chunk's decay
      const int i = tid;
      float pr = 1.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        if (y_on) {
          bf16 tr[2];
          split_bf16<2>(__bfloat162float(rr[t * TP + i]) * pr, tr);
          rhs[t * KROW + i] = tr[0];
          rhs[(SUB + t) * KROW + i] = tr[1];
        }
        pr *= e[t * DH + i];
      }
      db[i] = pr;
      cdec *= pr;
    } else {
      // key i: kh (three terms) by a backward walk, stored a step pair at
      // a time
      const int i = tid - DH;
      float kv[SUB];
      float q = 1.f;
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        kv[t] = __bfloat162float(kr[t * TP + i]) * q;
        q *= e[t * DH + i];
      }
#pragma unroll
      for (int t = 0; t < SUB; t += 2) {
        uint32_t tz[3];
        split_pair<3>(kv[t], kv[t + 1], tz);
#pragma unroll
        for (int z = 0; z < 3; ++z)
          *reinterpret_cast<uint32_t*>(kht + (z * DH + i) * TROW + t) = tz[z];
      }
    }
    if (y_on) {
      // steps ja = sj and jb = SUB - 1 - sj, keys i0 ..: the partial
      // scores of step j's key at every later step t (k_j times e_t after
      // each step), and the bonus r_j . (u k_j) at t = j. Both walks share
      // each step's loads; a step at or before j multiplies by 1.
      const int ja = sj, jb = SUB - 1 - sj;
      float* pc = part + (tid % KG) * Gm::PS;
      float ca[KPG], cb[KPG];
      {
        const float4 ka = load4v(kr + ja * TP + i0);
        const float4 kb = load4v(kr + jb * TP + i0);
        const float4 ra = load4v(rr + ja * TP + i0);
        const float4 rb = load4v(rr + jb * TP + i0);
        ca[0] = ka.x, ca[1] = ka.y, ca[2] = ka.z, ca[3] = ka.w;
        cb[0] = kb.x, cb[1] = kb.y, cb[2] = kb.z, cb[3] = kb.w;
        const float ra4[KPG] = {ra.x, ra.y, ra.z, ra.w};
        const float rb4[KPG] = {rb.x, rb.y, rb.z, rb.w};
        float ba = 0.f, bb = 0.f;
#pragma unroll
        for (int z = 0; z < KPG; ++z) {
          ba += ra4[z] * (uk[z] * ca[z]);
          bb += rb4[z] * (uk[z] * cb[z]);
        }
        pc[ja * SUB + ja] = ba;
        pc[jb * SUB + jb] = bb;
      }
#pragma unroll
      for (int t = 1; t < SUB; ++t) {
        const float4 rt = load4v(rr + t * TP + i0);
        const float4 et = *reinterpret_cast<const float4*>(e + t * DH + i0);
        const float r4[KPG] = {rt.x, rt.y, rt.z, rt.w};
        const float e4[KPG] = {et.x, et.y, et.z, et.w};
        float sa = 0.f, sb2 = 0.f;
#pragma unroll
        for (int z = 0; z < KPG; ++z) {
          sa += r4[z] * ca[z];
          sb2 += r4[z] * cb[z];
        }
        if (t > ja) pc[t * SUB + ja] = sa;
        if (t > jb) pc[t * SUB + jb] = sb2;
#pragma unroll
        for (int z = 0; z < KPG; ++z) {
          ca[z] *= t > ja ? e4[z] : 1.f;
          cb[z] *= t > jb ? e4[z] : 1.f;
        }
      }
      __syncthreads();        // partial scores complete
      // A [t][j] (two terms), a pair of columns a thread
      const int t = tid >> 3, j = 2 * (tid & 7);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        a0 += part[g * Gm::PS + t * SUB + j];
        a1 += part[g * Gm::PS + t * SUB + j + 1];
      }
      uint32_t tz[2];
      split_pair<2>(j <= t ? a0 : 0.f, j + 1 <= t ? a1 : 0.f, tz);
#pragma unroll
      for (int z = 0; z < 2; ++z)
        *reinterpret_cast<uint32_t*>(ams + (z * SUB + t) * TROW + j) = tz[z];
    }
    __syncthreads();          // A, rh, kh, db complete; the scores spent

    uint32_t va[4];           // V^T [j][t] of the warp's columns
    xt_fragment(va, vr, TP, j0, grp, tig);
    if (y_on) {
      float yt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t shi[4], slo[4];
        st_fragments<NT>(shi, slo, st, kk);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const bf16* rh = rhs + (8 * tt + grp) * KROW + 16 * kk + 2 * tig;
          const bf16* rl = rh + SUB * KROW;
          const uint32_t h0 = ld32(rh), h1 = ld32(rh + 8);
          mma_bf16(yt[tt], shi, h0, h1);
          mma_bf16(yt[tt], slo, h0, h1);
          mma_bf16(yt[tt], shi, ld32(rl), ld32(rl + 8));
        }
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const bf16* ah = ams + (8 * tt + grp) * TROW + 2 * tig;
        const bf16* al = ah + SUB * TROW;
        mma_bf16(yt[tt], va, ld32(ah), ld32(ah + 8));
        mma_bf16(yt[tt], va, ld32(al), ld32(al + 8));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 8 * tt + 2 * tig + (q & 1);
          ys[t * YP + j0 + grp + 8 * (q >> 1)] = yt[tt][q];
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(db + 8 * nt + 2 * tig);
      st[nt][0] *= d.x;
      st[nt][1] *= d.y;
      st[nt][2] *= d.x;
      st[nt][3] *= d.y;
      const bf16* kq = kht + (8 * nt + grp) * TROW + 2 * tig;
#pragma unroll
      for (int z = 0; z < 3; ++z)
        mma_bf16(st[nt], va, ld32(kq + z * DH * TROW),
                 ld32(kq + z * DH * TROW + 8));
    }
    __syncthreads();          // y staged; ring slot sb % RING, the tables free
    stage(sb + RING);
    if (y_on) {
      const int nt2 = min(SUB, len - r0);
      bf16* yb = y + base + (size_t)r0 * H * DH;
      for (int q = tid; q < nt2 * (DH / 2); q += MMA_THREADS) {
        const int t = q / (DH / 2), jj = 2 * (q % (DH / 2));
        *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)t * H * DH + jj) =
            __floats2bfloat162_rn(ys[t * YP + jj], ys[t * YP + jj + 1]);
      }
    }
  }
  cp_async_wait<0>();         // no copy outlives the tile

  if (float* so = end_state(jb, s_out, slot, nc, DH * DH)) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * nt + 2 * tig + (q & 1), jj = j0 + grp + 8 * (q >> 1);
        so[(size_t)i * DH + jj] = st[nt][q];
      }
  }
  if (jb.to_slot && tid < DH)
    decay[((size_t)jb.bh * nc + jb.c) * DH + tid] = cdec;
}

// ---- decode ---------------------------------------------------------------

// Decode (T = 1): one CTA of DEC_THREADS a (batch row, head); thread (key
// group rg, column quad cq) owns keys rg*4 .. rg*4 + 3 of value columns
// cq*4 .. cq*4 + 3, so a warp reads and writes whole 256-byte rows. A
// thread loads its own keys' r, k, w and u and its columns' v (vector
// loads), so no barrier comes before the state update; y is summed over
// the key groups by one shuffle and one exchange between the warps.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
wkv_decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  T* __restrict__ y, float* s_out, int H) {
  constexpr int RG = DEC_THREADS / (DH / 4);    // key groups: 16
  constexpr int RD = DH / RG;                   // keys a thread: 4
  static_assert(RD == 4, "a thread's keys: four");
  __shared__ float4 part[DEC_THREADS / 32][DH / 4];
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x, cq = tid % (DH / 4), rg = tid / (DH / 4);
  const int col = cq * 4;

  float4 sv[RD];
#pragma unroll
  for (int m = 0; m < RD; ++m) {
    const size_t off = ((size_t)bh * DH + rg * RD + m) * DH + col;
    sv[m] = s0 != nullptr ? *reinterpret_cast<const float4*>(s0 + off)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const size_t koff = (size_t)bh * DH + rg * RD;
  const float4 rq = load4v(r + koff), kq = load4v(k + koff);
  const float4 wq = load4v(w + koff);
  const float* uh = u + (size_t)h * DH + rg * RD;
  const float4 vv = load4v(v + (size_t)bh * DH + col);
  const float ri[RD] = {rq.x, rq.y, rq.z, rq.w};
  const float ki[RD] = {kq.x, kq.y, kq.z, kq.w};
  const float wi[RD] = {wq.x, wq.y, wq.z, wq.w};
  float4 yp = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < RD; ++m) {
    const float uk = uh[m] * ki[m], ew = expf(wi[m]);
    float4 sm = sv[m];
    yp.x += ri[m] * (sm.x + uk * vv.x);
    yp.y += ri[m] * (sm.y + uk * vv.y);
    yp.z += ri[m] * (sm.z + uk * vv.z);
    yp.w += ri[m] * (sm.w + uk * vv.w);
    sm.x = sm.x * ew + ki[m] * vv.x;
    sm.y = sm.y * ew + ki[m] * vv.y;
    sm.z = sm.z * ew + ki[m] * vv.z;
    sm.w = sm.w * ew + ki[m] * vv.w;
    *reinterpret_cast<float4*>(
        s_out + ((size_t)bh * DH + rg * RD + m) * DH + col) = sm;
  }
  yp.x += __shfl_xor_sync(0xffffffffu, yp.x, 16);
  yp.y += __shfl_xor_sync(0xffffffffu, yp.y, 16);
  yp.z += __shfl_xor_sync(0xffffffffu, yp.z, 16);
  yp.w += __shfl_xor_sync(0xffffffffu, yp.w, 16);
  if ((tid & 31) < 16) part[tid >> 5][cq] = yp;
  __syncthreads();
  if (tid < DH / 4) {
    float4 acc = part[0][tid];
#pragma unroll
    for (int q = 1; q < DEC_THREADS / 32; ++q) {
      const float4 pq = part[q][tid];
      acc.x += pq.x;
      acc.y += pq.y;
      acc.z += pq.z;
      acc.w += pq.w;
    }
    T* yo = y + (size_t)bh * DH + col;
    store(acc.x, yo);
    store(acc.y, yo + 1);
    store(acc.z, yo + 2);
    store(acc.w, yo + 3);
  }
}

// The chunk kernel of a dtype: f32 on the CUDA cores, bf16 on the tensor
// cores.
template <typename T>
struct Chunk {
  static constexpr int THREADS_ = THREADS, SMEM = Geo<T>::SMEM;
  static auto kernel() { return wkv_chunk_kernel<T>; }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int THREADS_ = MMA_THREADS, SMEM = GeoMma::SMEM;
  static auto kernel() { return wkv_chunk_mma; }
};

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, void* slot,
           void* decay, int B, int T_len, int H, cudaStream_t stream) {
  const int BH = B * H;
  const T *rp = (const T*)r, *kp = (const T*)k, *vp = (const T*)v;
  const float *wp = (const float*)w, *up = (const float*)u;
  if (T_len == 1) {
    wkv_decode_kernel<T><<<(unsigned)BH, DEC_THREADS, 0, stream>>>(
        rp, kp, vp, wp, up, (const float*)s0, (T*)y, (float*)s_out, H);
    return (int)cudaGetLastError();
  }
  using K = Chunk<T>;
  const auto kernel = K::kernel();
  static bool opted = false;
  const int rc = opt_in(kernel, K::SMEM, opted);
  if (rc) return rc;
  const int nc = (T_len + CHUNK - 1) / CHUNK;
  return run_passes(BH, T_len, slot != nullptr && decay != nullptr,
                    [&](int pass, int tiles) {
                      kernel<<<(unsigned)tiles, K::THREADS_, K::SMEM,
                               stream>>>(rp, kp, vp, wp, up,
                                         (const float*)s0, (T*)y,
                                         (float*)s_out, (float*)slot,
                                         (float*)decay, T_len, H, pass, nc);
                      return (int)cudaGetLastError();
                    });
}

}  // namespace

// r, k, v, w [B,T,H,Dh], u [H,Dh], s0 (or null) and s_out [B,H,Dh,Dh]
// (may be one buffer), y [B,T,H,Dh]; for T > chunk the scratch `slot`
// [B*H, ceil(T / chunk), Dh, Dh] and `decay` [B*H, ceil(T / chunk), Dh]
// f32. `chunk` must be this file's CHUNK.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_out, void* slot, void* decay,
                              int B, int T_len, int H, int head_dim,
                              int chunk, int is_bf16, void* stream) {
  if (head_dim != DH || chunk != CHUNK || T_len < 1)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, slot, decay,
                                 B, T_len, H, st);
  return launch<float>(r, k, v, w, u, s0, y, s_out, slot, decay, B, T_len,
                       H, st);
}
