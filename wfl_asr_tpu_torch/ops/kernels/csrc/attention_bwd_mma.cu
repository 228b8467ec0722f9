// Backward of bias-free key-masked attention at head_dim > 128 (the
// Conformer's attention, head_dim 384 on the main path) on the tensor cores,
// for Hopper (sm_90a). dQ, dK, dV of
//
//   out[b,h,q,:] = softmax_k( (q·kᵀ)·scale, keys k >= kv_len[b] set to
//                             -1e30 ) · v
//
// from the forward's row logsumexp (LSE) and delta = rowsum(dO·O).
//
// Replaces wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:_bwd_dkdv_kernel
// (:106) and _bwd_dq_kernel (:171), the backward of flash_attention_trainable
// (K1b). Calls with a bias take attention_bwd_bias_mma.cu at head_dim 64
// (K2b) and the FMA kernels of flash_attention.cu at other widths, as do
// bias-free widths ≤ 128.
//
// What bounds it on the card: 5 products of 2·H·T·Σkv_len·D FLOPs (S = Q·Kᵀ,
// dP = dO·Vᵀ, dV += (P·M)ᵀ·dO, dK += dSᵀ·Q, dQ += dS·K) against a few MB of
// bytes: operations, far above the ridge in both dtypes. The kernels this
// replaces ran all of it as f32 FMA loops fed from shared memory (a shared
// load per 0.7-1.3 FMAs), so they were bound by shared-memory bandwidth at
// about 1/14 of the FMA peak, and their dQ pass looped over the batch inside
// a block (for K2b's dBias), one under-filled wave of 188 blocks.
//
// What this design does about it:
// - Every product runs on mma.sync with f32 accumulation. bf16: m16n8k16
//   with ldmatrix operands; P and dS are rounded to bf16 only as operands
//   of the second-stage products (FlashAttention-2). f32: m16n8k8 TF32 with
//   a three-way split, a = hi + lo (hi = a rounded to TF32 by integer ops,
//   lo = a − hi), a·b ≈ lo·hi + hi·lo + hi·hi: ≈ 2⁻²² relative per product,
//   near f32; single TF32 would be 2⁻¹¹ and miss the backward's 1e-4 ×
//   max|grad| tolerance. Three TF32 products cost three times one, so the
//   split's ceiling is a third of the TF32 rate (≈ 165 TFLOP/s of f32 work
//   against the H100 SXM's published 495 TF32 dense). The dtypes share one
//   skeleton; an operand policy (PolBF16, PolF32 of attention_mma.cuh) lays
//   out tiles, loads fragments and runs the mma, so tiling, masking and
//   dropout are written once.
// - 16 warps a block. In the dK/dV pass the scores of a streamed tile
//   (32 × W) are 16×16 sub-tiles per product: warps 0-7 compute S, warps
//   8-15 dP, the 8 of a product splitting each sub-tile's contraction over
//   D; the parts meet in shared memory, where four warps a sub-tile each
//   finish one pair of its columns (exp, mask, dropout, dS), so no warp
//   waits on a long chain.
// - dK/dV pass (attn_bwd_dkdv_mma): one block per (32-key tile, h, b)
//   walks the query tiles. After the scores it writes Pᵀ·M and dSᵀ to
//   shared memory, and each warp owns 16 keys × D/8 columns of dV and dK in
//   registers across the whole query loop (2 × 6 n8 tiles × 4 = 48 f32 a
//   thread at D = 384). It also stores dS to a workspace [B, H, T, ldk] of
//   the kernel's dtype (ldk = T rounded up to 32; bf16 rounds dS where the
//   dQ product's operand would anyway). Key tiles wholly past kv_len write
//   zero gradients and no dS.
// - dQ pass (attn_bwd_dq_mma, the next launch): one block per (64-query
//   tile, h, b), no batch loop: 384 blocks at [8, 2, 1499, 384]. It reads
//   dS back and runs dQ += dS·K alone; dQ (64 × D) stays in registers
//   across the key loop, split over the warps by columns, each warp's two
//   16-row tiles sharing every K fragment (32-query blocks, which split
//   and load each K fragment twice as often, were slower on the card).
// - So S and dP are computed once (5 products, the bound's), and each
//   gradient is still written by one block: deterministic, no atomics. A
//   dQ pass that recomputed S and dP instead (7 products, no workspace)
//   was slower on the card. The workspace is B·H·T·ldk elements (144 MB in
//   f32 at the main shape) and moves ≈ 0.1 ms of bytes.
// - Every product's mma steps sum into fresh registers that are added to
//   the long-lived sums in f32: the tensor core truncates when it adds into
//   an accumulator. Adding the dK/dV/dQ products straight into the
//   accumulators was barely faster on the card and about doubled the worst
//   f32 error.
// - Staging: 16-byte cp.async into padded (bf16: rows of D + 8) or shifted
//   (f32) rows, pitched for the widest D of the kernel's group so that every
//   offset is an immediate; the LSE and delta rows by 4-byte cp.async in
//   the same group. ldmatrix (also for f32's plain reads) and the per-lane
//   transposed TF32 reads are free of bank conflicts. The dK/dV pass's
//   streamed tile (Q and dO) is double-buffered: 32 rows in bf16 (169 KB a
//   block at D = 384); in f32 16 rows (220 KB), as the resident K and V
//   alone take 98 KB. That halves the work each barrier and each score
//   exchange covers; 32 rows in one buffer, waiting for each copy, were a
//   little slower on the card. f32 at D > 384 keeps one buffer of 16 rows
//   to fit 227 KB. The dQ pass double-buffers 32 rows of K and 64 × 32 of
//   dS (f32: 114 KB at D = 384).
// - Masking as in the FMA kernels: keys ≥ kv_len[b] are -1e30 before the
//   exp, query rows past T add nothing, ragged tiles are zero-filled on load
//   and never stored.
// - Strict attention dropout (K6) as a DROP template flag: wfl::drop_keep
//   on the absolute (b, h, q, k) of each accumulator element. In a 16×8
//   accumulator tile element e of a lane is row g + 8·(e/2), column
//   2·(lane%4) + e%2, g = lane/4; in the dK/dV pass, the only one that
//   computes scores, rows are keys and columns queries. dV takes P·M and
//   dS = P·(M·dP − delta); P and the LSE stay undropped.
#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// Tiles. The block's 16 warps own its dK/dV (or dQ) accumulators as 2 row
// tiles × 8 column slices, so NPW, the 8-column tiles a warp owns at most,
// is ⌈D/64⌉ rounded to the group a kernel is compiled for (4: D ≤ 256,
// 6: ≤ 384, 8: ≤ 512). In the dK/dV pass the scores of a streamed tile
// (32 keys × W queries) are SUBS = 2·W/16 sub-tiles of 16×16 per product;
// warps 0-7 compute S, warps 8-15 dP, each sub-tile's contraction over D
// shared by PARTS = 8/SUBS warps, which leave their partial sums in shared
// memory. The streamed tile has 32 rows in bf16 and 16 in f32, in two
// buffers but for f32 at D > 384, which has one to fit 227 KB. The dQ pass
// streams 32 keys of K and of dS (64 queries a block) at a time, in two
// buffers. Rows are pitched for the group's widest D.
// ---------------------------------------------------------------------------

template <class Pol, int NPW>
struct Tiles {
  static constexpr bool kF32 = sizeof(typename Pol::T) == 4;
  static constexpr int w = kF32 ? 16 : 32;      // rows of a streamed tile
  static constexpr int nbuf = kF32 && NPW > 6 ? 1 : 2;
  // dK/dV pass: BK keys a block, BQ queries a streamed tile
  static constexpr int kv_bk = 32, kv_bq = w;
  // dQ pass: BQ queries a block, BK keys a streamed tile (two buffers)
  static constexpr int q_bq = 64, q_bk = 32;
  static constexpr int es = sizeof(typename Pol::T);
  // 16×16 score sub-tiles of a streamed tile per product (dK/dV pass)
  static constexpr int subs = 2 * w / 16;
  static constexpr int parts = kWarps / 2 / subs;
  static constexpr size_t part_bytes = sizeof(float) * 2 * subs * parts * 256;
  // row pitch of the D-wide tiles, for the group's widest D
  static constexpr int p = Pol::pitch(64 * NPW);

  static constexpr size_t dkdv_smem =
      (size_t)es * (2 * kv_bk * p + 2 * nbuf * kv_bq * p
                    + 2 * kv_bk * Pol::pitch_s(kv_bq))
      + sizeof(float) * 2 * nbuf * kv_bq + part_bytes;
  static constexpr size_t dq_smem =
      (size_t)es * 2 * (q_bk * p + q_bq * Pol::pitch_s(q_bk));
  static_assert(2 * subs * parts == kWarps, "score sub-tiles split evenly");
  static_assert(dkdv_smem <= 232448, "dK/dV tiles exceed 227 KB");
  static_assert(dq_smem <= 232448, "dQ tiles exceed 227 KB");
};

// S = A_s·B_sᵀ and dP = A_dp·B_dpᵀ of one streamed tile (32 × 16·SUBS/2),
// computed by all warps: warp w takes product w / 8, sub-tile (w % 8) % SUBS
// at rows r0 and columns c0, and part (w % 8) / SUBS of its contraction
// over D, and leaves its partial sums in sPart (a [8][32] slot of floats for
// each product, sub-tile and part). A lane holds 4 pairs of a sub-tile's
// elements (rows g, g + 8; 8-column tiles 0, 1; columns 2·(lane%4) + 0, 1),
// and 4 of the sub-tile's 2·PARTS warps each finish one pair: they add the
// parts of S and dP and return true with the pair, at local row rl and
// columns cl, cl + 1.
template <class Pol, int SUBS>
__device__ __forceinline__ bool score_tiles(
    float (&s)[2], float (&dp)[2], const typename Pol::T* a_s,
    const typename Pol::T* b_s, const typename Pol::T* a_dp,
    const typename Pol::T* b_dp, int p, int D, float* sPart, int& rl,
    int& cl) {
  constexpr int PARTS = kWarps / 2 / SUBS, NC = SUBS / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int prod = warp / (kWarps / 2), u = warp % (kWarps / 2);
  const int sub = u % SUBS, part = u / SUBS;
  const int r0 = (sub / NC) * 16, c0 = (sub % NC) * 16;
  const int per = ((D + PARTS - 1) / PARTS + Pol::KS - 1) / Pol::KS * Pol::KS;
  const int kbeg = part * per, kend = min(D, kbeg + per);
  float x[2][4];
  score_part<Pol>(x, prod ? a_dp : a_s, prod ? b_dp : b_s, p, r0, c0, kbeg,
                  kend);
  float* mine = sPart + ((prod * SUBS + sub) * PARTS + part) * 256 + lane;
#pragma unroll
  for (int e = 0; e < 8; ++e) mine[e * 32] = x[e / 4][e % 4];
  __syncthreads();
  const int pair = prod * PARTS + part;     // 8-column tile j, row half i
  if (pair >= 4) return false;
  const int j = pair >> 1, i = pair & 1, e0 = 4 * j + 2 * i;
  const float* ps = sPart + sub * PARTS * 256 + lane;
  const float* pd = sPart + (SUBS + sub) * PARTS * 256 + lane;
  s[0] = s[1] = dp[0] = dp[1] = 0.f;
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    s[0] += ps[q * 256 + e0 * 32];
    s[1] += ps[q * 256 + (e0 + 1) * 32];
    dp[0] += pd[q * 256 + e0 * 32];
    dp[1] += pd[q * 256 + (e0 + 1) * 32];
  }
  rl = r0 + (lane >> 2) + 8 * i;
  cl = c0 + 8 * j + 2 * (lane & 3);
  return true;
}

// The pair's arguments ([B, H, T, D] tensors, the LSE and delta rows, the
// key lengths, the dS workspace [B, H, T, ldk]) as one kernel parameter.
template <class T>
struct BwdArgs {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_len;
  T *dq, *dk, *dv, *ds;
  int H, T_len, D, ldk;
  float scale;
  Dropout drop;
};

// ---------------------------------------------------------------------------
// dK/dV pass: block (key tile, h, b). Warp w owns keys 16·(w % 2) and the
// column slice w / 2 of dV and dK across the query tiles; the block also
// stores its keys' columns of dS for the dQ pass.
// ---------------------------------------------------------------------------

template <class Pol, int NPW, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_mma(const BwdArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = Tiles<Pol, NPW>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  constexpr int BK = Cfg::kv_bk, BQ = Cfg::kv_bq, NBUF = Cfg::nbuf;
  constexpr int MI = BK / 16;
  static_assert(MI == 2 && Cfg::subs == 2 * BQ / 16, "sub-tiles of the key tile");
  const T* __restrict__ q = a.q;
  const T* __restrict__ k = a.k;
  const T* __restrict__ v = a.v;
  const T* __restrict__ dout = a.dout;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ delta = a.delta;
  T* __restrict__ dk = a.dk;
  T* __restrict__ dv = a.dv;
  const int H = a.H, T_len = a.T_len, D = a.D, ldk = a.ldk;
  const float scale = a.scale;
  const Dropout drop = a.drop;
  constexpr int P = Cfg::p;
  constexpr int PP = Pol::pitch_s(BQ);
  T* sK = reinterpret_cast<T*>(smem_raw);      // [BK][P]
  T* sV = sK + BK * P;                           // [BK][P]
  T* sQ = sV + BK * P;                           // [NBUF][BQ][P]
  T* sDO = sQ + NBUF * BQ * P;                   // [NBUF][BQ][P]
  T* sPT = sDO + NBUF * BQ * P;                  // [BK][PP]  (P·M)ᵀ
  T* sDST = sPT + BK * PP;                       // [BK][PP]  dSᵀ
  float* sL = reinterpret_cast<float*>(sDST + BK * PP);   // [NBUF][BQ]
  float* sDl = sL + NBUF * BQ;                             // [NBUF][BQ]
  float* sPart = sDl + NBUF * BQ;                // partial score sums

  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * T_len * D;
  const int kvl = a.kv_len[b];
  if (k0 >= kvl) {      // no query attends these keys: zero gradients
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      if (k0 + idx / D < T_len) {
        dk[base + (size_t)k0 * D + idx] = from_f<T>(0.f);
        dv[base + (size_t)k0 * D + idx] = from_f<T>(0.f);
      }
    }
    return;
  }
  const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;
  T* __restrict__ ds = a.ds + bh * T_len * ldk;

  auto stage_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    stage_rows<Pol, kThreads>(sQ + buf * BQ * P, P, q + base, q0, BQ, T_len,
                              D);
    stage_rows<Pol, kThreads>(sDO + buf * BQ * P, P, dout + base, q0, BQ,
                              T_len, D);
    stage_stats<kThreads>(sL + buf * BQ, sDl + buf * BQ, lse, delta, bh, q0,
                          BQ, T_len);
  };
  stage_rows<Pol, kThreads>(sK, P, k + base, k0, BK, T_len, D);
  stage_rows<Pol, kThreads>(sV, P, v + base, k0, BK, T_len, D);
  stage_q(0, 0);
  cp_async_commit();

  const int ai = warp % MI, aj = warp / MI;
  const int NT = D / 8;
  const int npw = cols_per_warp(NT, kWarps / MI), nt0 = aj * npw;
  float acc_dv[1][NPW][4], acc_dk[1][NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[0][n][e] = acc_dk[0][n][e] = 0.f;

  const int n_qt = (T_len + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = NBUF == 2 ? (qt & 1) : 0;
    cp_async_wait<0>();
    __syncthreads();    // this tile is in; every warp is done with qt − 1
    if (NBUF == 2 && qt + 1 < n_qt) {
      stage_q(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* tQ = sQ + buf * BQ * P;
    const T* tDO = sDO + buf * BQ * P;
    const int q0 = qt * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows are keys, columns queries
    float s[2], dp[2];
    int kl, cl;
    if (score_tiles<Pol, Cfg::subs>(s, dp, sK, tQ, sV, tDO, P, D, sPart, kl,
                                    cl)) {
      const int kj = k0 + kl;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = cl + e, qi = q0 + ql;
        // mask before the exp: a masked key's raw score may exceed the LSE
        // by more than 88, and exp → inf, times 0, is NaN
        const float sv = kj < kvl ? s[e] * scale : kNegInf;
        const float p = qi < T_len ? expf(sv - sL[buf * BQ + ql]) : 0.f;
        // K6: dV takes P·M, dS = P·(M·dP − delta)
        const float ks = (DROP && qi < T_len && kj < kvl)
            ? drop_keep(drop, dbase, qi, kj) : 1.f;
        s[e] = p * ks;
        dp[e] = p * (dp[e] * ks - sDl[buf * BQ + ql]);
        // dS[q][k] for the dQ pass (8 lanes a query row: 32-byte runs in f32)
        if (qi < T_len) ds[(size_t)qi * ldk + kj] = from_f<T>(dp[e]);
      }
      Pol::store2(sPT, PP, kl, cl, s[0], s[1]);
      Pol::store2(sDST, PP, kl, cl, dp[0], dp[1]);
    }
    __syncthreads();
    // dV += (P·M)ᵀ·dO, dK += dSᵀ·Q (scale at the store)
    accumulate<Pol, NPW, BQ, 1>(acc_dv, sPT, PP, ai * 16, tDO, P, nt0, npw,
                                NT);
    accumulate<Pol, NPW, BQ, 1>(acc_dk, sDST, PP, ai * 16, tQ, P, nt0, npw,
                                NT);
    if (NBUF == 1) {
      __syncthreads();    // every warp is done with this tile's buffer
      if (qt + 1 < n_qt) {
        stage_q(qt + 1, 0);
        cp_async_commit();
      }
    }
  }
  const int r0 = k0 + ai * 16;
  store_acc<T, NPW>(dv + base, acc_dv[0], r0, nt0, npw, NT, T_len, D, 1.f);
  store_acc<T, NPW>(dk + base, acc_dk[0], r0, nt0, npw, NT, T_len, D, scale);
}

// ---------------------------------------------------------------------------
// dQ pass: block (query tile, h, b), after the dK/dV pass has written dS.
// Warp w owns queries 32·(w % 2) (two row tiles, which share each K
// fragment) and the column slice w / 2 of dQ across the key tiles; dQ +=
// dS·K with dS and K streamed in two buffers.
// ---------------------------------------------------------------------------

template <class Pol, int NPW>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_mma(const BwdArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = Tiles<Pol, NPW>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BQ = Cfg::q_bq, BK = Cfg::q_bk;
  constexpr int MT = BQ / 32;       // row tiles a warp: 2 row groups of warps
  static_assert(MT * 32 == BQ, "two row groups of 16·MT queries");
  constexpr int P = Cfg::p;
  constexpr int PP = Pol::pitch_s(BK);
  T* sK = reinterpret_cast<T*>(smem_raw);      // [2][BK][P]
  T* sDS = sK + 2 * BK * P;                      // [2][BQ][PP]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)b * a.H + h;
  const T* __restrict__ k = a.k + bh * T_len * D;
  const T* __restrict__ ds = a.ds + bh * T_len * a.ldk;
  const int kvl = a.kv_len[b];

  // key tiles up to kv_len: the dK/dV pass wrote dS for each (0 past kv_len)
  auto stage = [&](int kt, int buf) {
    stage_rows<Pol, kThreads>(sK + buf * BK * P, P, k, kt * BK, BK, T_len,
                              D);
    stage_cols<Pol, BK, kThreads>(sDS + buf * BQ * PP, PP, ds, q0, kt * BK,
                                  BQ, T_len, a.ldk);
    cp_async_commit();
  };
  stage(0, 0);

  const int ai = warp % 2, aj = warp / 2;
  const int NT = D / 8;
  const int npw = cols_per_warp(NT, kWarps / 2), nt0 = aj * npw;
  float acc[MT][NPW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int n_kt = (kvl + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    __syncthreads();    // this tile is in; every warp is done with kt − 1
    if (kt + 1 < n_kt) stage(kt + 1, buf ^ 1);
    // dQ += dS·K (scale at the store)
    accumulate<Pol, NPW, BK, MT>(acc, sDS + buf * BQ * PP, PP, ai * 16 * MT,
                                 sK + buf * BK * P, P, nt0, npw, NT);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_acc<T, NPW>(a.dq + bh * T_len * D, acc[m], q0 + (ai * MT + m) * 16,
                      nt0, npw, NT, T_len, D, a.scale);
}

// The two passes in turn on one stream, on the grids (32-key tile, h, b)
// and (64-query tile, h, b): the dQ pass reads the dS that the dK/dV pass
// wrote.
template <class Pol, int NPW, bool DROP>
cudaError_t run_pair(const BwdArgs<typename Pol::T>& a, int B,
                     cudaStream_t stream) {
  using Cfg = Tiles<Pol, NPW>;
  static_assert(Cfg::kv_bk == 32 && Cfg::q_bk == 32,
                "the workspace's columns come in 32-key tiles");
  cudaError_t err = wfl::launch(
      attn_bwd_dkdv_mma<Pol, NPW, DROP>,
      dim3((a.T_len + Cfg::kv_bk - 1) / Cfg::kv_bk, a.H, B), dim3(kThreads),
      Cfg::dkdv_smem, stream, a);
  if (err != cudaSuccess) return err;
  return wfl::launch(attn_bwd_dq_mma<Pol, NPW>,
                     dim3((a.T_len + Cfg::q_bq - 1) / Cfg::q_bq, a.H, B),
                     dim3(kThreads), Cfg::dq_smem, stream, a);
}

// The column group by D, and the dropout hash only with a seed.
template <class Pol>
cudaError_t dispatch(const BwdArgs<typename Pol::T>& a, int B,
                     cudaStream_t s) {
#define WFL_PAIR(npw)                                          \
  return a.drop.seed ? run_pair<Pol, npw, true>(a, B, s)       \
                     : run_pair<Pol, npw, false>(a, B, s)
  if (a.D <= 256) WFL_PAIR(4);
  if (a.D <= 384) WFL_PAIR(6);
  WFL_PAIR(8);
#undef WFL_PAIR
}

template <class T>
cudaError_t dispatch_dtype(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* kv_len, void* dq,
                           void* dk, void* dv, void* ds, int B, int H,
                           int T_len, int D, int ldk, float scale,
                           Dropout drop, cudaStream_t s) {
  const BwdArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(kv_len), static_cast<T*>(dq),
                     static_cast<T*>(dk), static_cast<T*>(dv),
                     static_cast<T*>(ds), H, T_len, D, ldk, scale, drop};
  if constexpr (sizeof(T) == 4) return dispatch<PolF32>(a, B, s);
  else return dispatch<PolBF16>(a, B, s);
}

}  // namespace

using namespace wfl;

// dQ, dK, dV of bias-free attention (the forward wfl_flash_attention_fwd
// without bias or gate): the dK/dV pass, then the dQ pass. q, k, v, dout,
// dq, dk, dv: [B, H, T, D] contiguous of the dtype (0 = f32 as 3×TF32,
// 1 = bf16), D a multiple of 16 in (128, 512]; lse and delta = rowsum(dO·O)
// [B, H, T] f32; kv_len [B] int32 in [1, T]; ds a workspace [B, H, T, ldk]
// of the dtype, ldk ≥ T a multiple of 32 (its contents on return are
// dS); seed (one int32 on the device, or null), drop_thr and drop_scale as
// the forward's. Returns the launches' cudaError_t.
extern "C" int wfl_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_len, const void* seed,
    void* dq, void* dk, void* dv, void* ds, int B, int H, int T_len, int D,
    int ldk, float scale, int drop_thr, float drop_scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || D <= 128 || D > 512) return cudaErrorInvalidValue;
  if (ldk % 32 != 0 || ldk < T_len) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32)
    return dispatch_dtype<float>(q, k, v, dout, lse, delta, kv_len, dq, dk,
                                 dv, ds, B, H, T_len, D, ldk, scale, drop, s);
  if (dtype == kBF16)
    return dispatch_dtype<bf16>(q, k, v, dout, lse, delta, kv_len, dq, dk,
                                dv, ds, B, H, T_len, D, ldk, scale, drop, s);
  return cudaErrorInvalidValue;
}
