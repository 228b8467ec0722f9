// Backward of the gated-bias key-masked attention at head_dim 64 (WavLM's
// gated relative-position attention, 12 layers on the main path), and of
// the bias-free one at head_dim 64 and 128, on the tensor cores, for Hopper
// (sm_90a). dQ, dK, dV, dBias and dGate of
//
//   out[b,h,q,:] = softmax_k( (q·kᵀ)·scale + gate[b,h,q]·bias[h,q,k],
//                             keys k >= kv_len[b] set to -1e30 ) · v
//
// from the forward's row logsumexp (LSE) and delta = rowsum(dO·O). Without
// a bias (BIAS = false: null bias, gate, dBias and dGate) dQ, dK and dV of
// the bias-free attention, for bias-free f32 calls at head_dim ≤ 64 (route
// mma64: Whisper's layers, the `none` encoder's Conformer) and, at head
// width D = 128, at 80-128 (route mma128: a Conformer of hidden 512 under 4
// heads); narrower widths are zero-padded to 64 or 128 by the caller. In
// bf16 those calls take attention_wgmma.cu's dK/dV pass (routes wgmma64,
// wgmma128) and this file's dQ pass alone (wfl_attention_bwd_dq_mma). The
// head width is a template parameter; a bias is taken at D = 64 only.
//
// Replaces wfl_asr_tpu/ops/pallas/flash_attention.py:_bwd_dkdv_kernel
// (:262) and _bwd_dq_kernel (:342), the kernels of _bwd_impl (:417) (K2b),
// and, without a bias, wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:
// _bwd_dkdv_kernel (:106) and _bwd_dq_kernel (:171) (K1b) at head_dim ≤ 128.
// Other head widths up to 512 with a bias keep the FMA pair of
// flash_attention.cu; wider calls take attention_wide.cu, which runs this
// file's dBias/dGate pass (wfl_attention_bias_dbias) for its bias.
//
// What bounds it on the card: 5 products of 2·H·T·Σkv_len·D FLOPs (S = Q·Kᵀ,
// dP = dO·Vᵀ, dV += (P·M)ᵀ·dO, dK += dSᵀ·Q, dQ += dS·K; 105.8 GFLOP at
// [8, 12, 1499, 64]) against the bias read and dBias written once ([H, T, T]
// f32, 108 MB each): operations in f32 (1.58 ms at the 67 TFLOP/s FMA rate),
// bytes in bf16. The FMA pair this replaces ran all five products (and S and
// dP twice) as f32 FMA loops fed from shared memory, and its dQ pass looped
// over the batch inside each block so that one thread owned dBias[h, q, k]
// for every b.
//
// What this design does about it: three launches, each gradient written by
// one block, no atomics, so the result does not depend on the schedule.
// - The products run on mma.sync with f32 accumulation through the operand
//   policies of attention_mma.cuh (bf16 m16n8k16; f32 as three TF32
//   m16n8k8 products of split operands, each mma step summed into fresh
//   registers that are then added in f32), as in attention_bwd_mma.cu.
// - At D = 64 a contraction over D is four (bf16) or eight (f32) mma steps,
//   too short to split over warps, so the warps split the rows of the score
//   tile instead: 4 warps a block, each owning 16 keys (dK/dV pass) or 16
//   queries (dQ pass) and every column of its gradient in registers.
// - At D = 128 (bias-free: the dK/dV pass in f32, the dQ pass in both
//   dtypes) the layout stays: a dK/dV warp holds 2 × 64 f32 accumulator
//   registers a thread; K and V stay in shared memory and each product
//   reads and splits its fragments on use, as at 64. Shared memory doubles
//   with D, so the dK/dV pass runs 2 blocks a SM (16 queries a streamed
//   tile, 107 KB), and the f32 dQ pass 2 (100 KB). Its 255 registers a
//   thread spill 156 bytes; with 32 queries and 1 block a SM, which fit,
//   it took 46 % longer (kernel_variants_ab.py --kernel k128b).
// - dK/dV pass (attn_bias_bwd_dkdv_mma): one block per (64-key tile, b, h),
//   b the fastest-varying block index, so the 8 blocks that read the same
//   bias[h, :, key tile] strip run together and share it in L2. Each block
//   walks the query tiles (32 queries in f32, 64 in bf16, double-buffered by
//   cp.async with their LSE, delta and gate rows); each warp computes its
//   16 keys × 16 queries of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ at a time, adds
//   gate·bias, masks keys past kv_len to -1e30 before the exp, and forms
//   P = exp(S − LSE) and dS = P·(M·dP − delta) in its accumulator
//   registers, which are the A operands of dV += (P·M)ᵀ·dO and dK += dSᵀ·Q
//   as they stand (attention_mma.cuh: a_from_acc), with no trip through
//   shared memory. The bias is read straight from device memory (its rows
//   are T elements apart, odd at T = 1499, too unaligned for cp.async), one
//   16-query chunk ahead of its use, so that a chunk's products hide the
//   next chunk's loads. dS goes to a workspace [B, H, T, ldk] of the
//   kernel's dtype (ldk = T rounded up to 64) through a 16 × 16 staging
//   tile of the warp, as 16-byte stores. Key tiles wholly past kv_len write
//   zero dK and dV and no dS.
// - dQ pass (attn_bias_bwd_dq_mma): one block per (64-query tile, h, b),
//   no batch loop; dQ += dS·K over the key tiles up to kv_len, K and dS
//   double-buffered. So S and dP are computed once: 5 products.
// - dBias/dGate pass (attn_bias_bwd_dbias): no products, a bandwidth pass
//   over the workspace. One block per (8 query rows, h), a warp a row; it
//   walks the key tiles of 256 keys (8 a lane, lane + 32·i), and for each
//   walks b = 0..B−1 in order. Reduction orders, each fixed:
//   dBias[h, q, k] = Σ_b gate[b,h,q]·dS[b,h,q,k], b in order, in one
//   thread's register, stored once in f32; dGate[b, h, q] = Σ_k bias·dS:
//   each lane sums its 8 keys of the tile in order, the warp adds its 32
//   lanes by an xor butterfly (16, 8, 4, 2, 1; lane 0's order is kept), and
//   lane 0 adds the tile's sum to the row's B-long strip in shared memory,
//   tile after tile; the strip is stored once at the end. bias and dS are
//   each read once; keys ≥ kv_len[b] (dS there is 0 or never written) and
//   query rows past T add nothing. Doing dGate here, and not in the dQ pass,
//   keeps the bias out of the dQ pass: there it would be read B times.
// - Bytes of the workspace: B·H·T·ldk elements (884 MB in f32 at the main
//   shape), of which the key tiles below kv_len are written once and read
//   twice, ≈ 0.6 ms at 3.35 TB/s; bf16 rounds dS in the workspace where the
//   dQ product's operand would anyway, and dBias and dGate add the rounded
//   values in f32.
// - Without a bias (BIAS = false) the dK/dV pass reads no bias and no gate
//   rows, and the dBias/dGate pass does not launch; the dS workspace stays,
//   as the dQ pass reads it.
// - Strict attention dropout (K6) as a DROP template flag, in the dK/dV pass
//   only, the only one that computes scores: wfl::drop_keep on the absolute
//   (b, h, q, k) of each accumulator element (rows of the transposed tile
//   are keys). dV takes P·M, dS = P·(M·dP − delta); P and the LSE stay
//   undropped, and the mask reaches dQ, dBias and dGate through dS.
#include <type_traits>

#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // the head width with a bias, and of mma64
constexpr int kD128 = 128;    // the bias-free head width of route mma128
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;               // keys a dK/dV block, workspace tile
constexpr int kBQ = 64;               // queries a dQ block
constexpr int kRows = 8;              // query rows a dBias/dGate block
constexpr int kBiasThreads = kRows * 32;
constexpr int kKeysPerLane = 8;       // dBias/dGate: 256 keys a key tile
constexpr float kNegInf = -1e30f;

// Shared memory of the dK/dV pass: K and V (64 × D), two buffers of the
// streamed Q and dO tiles and their LSE, delta and gate rows (no gate rows
// without a bias), and each warp's 16 × 16 dS staging tile; at D = 64 f32
// streams 32 queries (78 KB, two blocks a SM), bf16 (with a bias only) 64
// (59 KB, three a SM); at D = 128 (f32, bias-free) 16, two blocks a SM.
template <class Pol, bool BIAS, int D>
struct BiasTiles {
  static constexpr bool kF32 = sizeof(typename Pol::T) == 4;
  static constexpr int es = sizeof(typename Pol::T);
  // queries a streamed tile, dK/dV blocks a SM
  static constexpr int bq = kF32 ? (D == kD ? 32 : 16) : 64;
  static constexpr int blocks = kF32 ? 2 : 3;
  static constexpr int p = Pol::pitch(D);
  // dS staging rows: 16 keys and 16 bytes of padding, so that the lanes'
  // element stores fall on distinct banks and rows stay 16-byte aligned
  static constexpr int pst = 16 + 16 / es;
  static constexpr size_t dkdv_smem =
      (size_t)es * (2 * kBK * p + 2 * 2 * bq * p + kWarps * 16 * pst)
      + sizeof(float) * (BIAS ? 3 : 2) * 2 * bq;
  static_assert(D == kD || (D == kD128 && !BIAS && kF32),
                "a bias only at head_dim 64; bias-free at 64 and, in f32, "
                "128");
  // 228 KB a SM, 1 KB of it reserved per block
  static_assert(blocks * (dkdv_smem + 1024) <= 233472,
                "dK/dV blocks a SM exceed its shared memory");
};

// Shared memory of the dQ pass: two buffers of K (64 keys × D) and of dS
// (64 queries × 64 keys).
template <class Pol, int D>
struct DqTiles {
  static constexpr int p = Pol::pitch(D);
  static constexpr int pq = Pol::pitch_s(kBK);
  static constexpr size_t dq_smem =
      sizeof(typename Pol::T) * 2 * (kBK * p + kBQ * pq);
  static_assert(D == kD || D == kD128, "head widths 64 and 128");
  static_assert(dq_smem <= 232448, "dQ tiles exceed 227 KB");
};

// The launches' arguments as one kernel parameter: [B, H, T, D] tensors,
// bias [H, T, T] of the dtype, gate [B, H, T] f32 (null: 1), the LSE and
// delta rows, the key lengths, the dS workspace [B, H, T, ldk], dBias [H,
// T, T] f32 and dGate [B, H, T] f32 (null without gate).
template <class T>
struct BiasArgs {
  const T *q, *k, *v, *dout, *bias;
  const float *gate, *lse, *delta;
  const int* kv_len;
  T *dq, *dk, *dv, *ds;
  float *dbias, *dgate;
  int B, H, T_len, ldk;
  float scale;
  Dropout drop;
};

// gate of query rows [row0, row0 + n) into sG by 4-byte cp.async in the
// caller's copy group (1 without a gate, 0 past T)
__device__ __forceinline__ void stage_gate(float* sG, const float* gate,
                                           size_t bh, int row0, int n,
                                           int T_len) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = row0 + i < T_len;
    if (gate == nullptr) {
      sG[i] = ok ? 1.f : 0.f;
    } else {
      cp_async4(sG + i, gate + (ok ? bh * T_len + row0 + i : 0),
                ok ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV pass: block (b, 64-key tile, h). Warp w owns keys 16·w and all D
// columns of dV and dK across the query tiles, and stores its keys' dS.
// ---------------------------------------------------------------------------

template <class Pol, bool BIAS, bool DROP, int D>
__global__ void __launch_bounds__(kThreads, BiasTiles<Pol, BIAS, D>::blocks)
attn_bias_bwd_dkdv_mma(const BiasArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = BiasTiles<Pol, BIAS, D>;
  constexpr int BQ = Cfg::bq, P = Cfg::p, PST = Cfg::pst;
  constexpr int kNT = D / 8;            // 8-column tiles of a gradient row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);      // [BK][P]
  T* sV = sK + kBK * P;                          // [BK][P]
  T* sQ = sV + kBK * P;                          // [2][BQ][P]
  T* sDO = sQ + 2 * BQ * P;                      // [2][BQ][P]
  T* sSt = sDO + 2 * BQ * P;                     // [warps][16 q][PST] dS
  float* sL = reinterpret_cast<float*>(sSt + kWarps * 16 * PST);  // [2][BQ]
  float* sDl = sL + 2 * BQ;                                        // [2][BQ]
  float* sG = sDl + 2 * BQ;                               // [2][BQ] (BIAS)

  const int b = blockIdx.x, k0 = blockIdx.y * kBK, h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len, ldk = a.ldk;
  const float scale = a.scale;
  const size_t bh = (size_t)b * a.H + h;
  const size_t base = bh * T_len * D;
  const int kvl = a.kv_len[b];
  if (k0 >= kvl) {      // no query attends these keys: zero gradients
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      if (k0 + idx / D < T_len) {
        a.dk[base + (size_t)k0 * D + idx] = from_f<T>(0.f);
        a.dv[base + (size_t)k0 * D + idx] = from_f<T>(0.f);
      }
    }
    return;
  }
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;
  const T* __restrict__ bias =
      BIAS ? a.bias + (size_t)h * T_len * T_len : nullptr;
  T* __restrict__ ds = a.ds + bh * T_len * ldk;
  T* st = sSt + warp * 16 * PST;                 // this warp's dS tile

  auto stage_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    stage_rows<Pol, kThreads>(sQ + buf * BQ * P, P, a.q + base, q0, BQ,
                              T_len, D);
    stage_rows<Pol, kThreads>(sDO + buf * BQ * P, P, a.dout + base, q0, BQ,
                              T_len, D);
    stage_stats<kThreads>(sL + buf * BQ, sDl + buf * BQ, a.lse, a.delta, bh,
                          q0, BQ, T_len);
    if constexpr (BIAS) stage_gate(sG + buf * BQ, a.gate, bh, q0, BQ, T_len);
  };
  stage_rows<Pol, kThreads>(sK, P, a.k + base, k0, kBK, T_len, D);
  stage_rows<Pol, kThreads>(sV, P, a.v + base, k0, kBK, T_len, D);
  stage_q(0, 0);
  cp_async_commit();

  const int r0 = warp * 16;                      // the warp's keys, local
  float acc_dv[kNT][4], acc_dk[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[n][e] = acc_dk[n][e] = 0.f;

  // The bias of this lane's 8 elements of the 16 queries from qc: element
  // e of 8-column tile n is key r0 + g + 8·(e/2), query qc + 8·n +
  // 2·(lane%4) + e%2. Loaded one 16-query chunk ahead of its use, so that
  // a chunk's products hide the next chunk's loads.
  auto load_bias = [&](float (&bv)[2][4], int qc) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + r0 + g + 8 * (e >> 1);
        const int qi = qc + 8 * n + 2 * t4 + (e & 1);
        bv[n][e] = (BIAS && qi < T_len && kj < kvl)
            ? to_f(bias[(size_t)qi * T_len + kj]) : 0.f;
      }
  };
  float bv[2][4];
  load_bias(bv, 0);

  const int n_qt = (T_len + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = qt & 1;
    cp_async_wait<0>();
    __syncthreads();    // this tile is in; every warp is done with qt − 1
    if (qt + 1 < n_qt) {
      stage_q(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* tQ = sQ + buf * BQ * P;
    const T* tDO = sDO + buf * BQ * P;
    const float* tL = sL + buf * BQ;
    const float* tDl = sDl + buf * BQ;
    const float* tG = sG + buf * BQ;
    const int q0 = qt * BQ;

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += 16) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows are keys, columns queries
      float s[2][4], dp[2][4];
      score_part<Pol>(s, sK, tQ, P, r0, c0, 0, D);
      score_part<Pol>(dp, sV, tDO, P, r0, c0, 0, D);
      float bn[2][4];
      load_bias(bn, q0 + c0 + 16);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int kl = g + 8 * (x >> 1), kj = k0 + r0 + kl;
          const int ql = 8 * n + 2 * t4 + (x & 1), qi = q0 + c0 + ql;
          // mask before the exp: a masked key's raw score may exceed the
          // LSE by more than 88, and exp → inf, times 0, is NaN
          const float sv = kj < kvl
              ? (BIAS ? s[n][x] * scale + tG[c0 + ql] * bv[n][x]
                      : s[n][x] * scale)
              : kNegInf;
          const float p = qi < T_len ? expf(sv - tL[c0 + ql]) : 0.f;
          // K6: dV takes P·M, dS = P·(M·dP − delta)
          const float ks = (DROP && qi < T_len && kj < kvl)
              ? drop_keep(a.drop, dbase, qi, kj) : 1.f;
          s[n][x] = p * ks;
          dp[n][x] = p * (dp[n][x] * ks - tDl[c0 + ql]);
          st[ql * PST + kl] = from_f<T>(dp[n][x]);
        }
      // dV += (P·M)ᵀ·dO, dK += dSᵀ·Q (scale at the store), P·M and dS
      // straight from the registers
      accumulate_held<Pol>(acc_dv, s, tDO, P, c0);
      accumulate_held<Pol>(acc_dk, dp, tQ, P, c0);
      // dS[q][k] for the dQ and dBias/dGate passes: the warp's 16 queries
      // × 16 keys, 16 bytes a lane
      __syncwarp();
      constexpr int kVecs = 16 / Pol::kVec;       // 16-byte pieces a row
      for (int i = lane; i < 16 * kVecs; i += 32) {
        const int ql = i / kVecs, c = (i % kVecs) * Pol::kVec;
        const int qi = q0 + c0 + ql;
        if (qi < T_len) {
          *reinterpret_cast<uint4*>(ds + (size_t)qi * ldk + k0 + r0 + c) =
              *reinterpret_cast<const uint4*>(st + ql * PST + c);
        }
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) bv[n][x] = bn[n][x];
    }
  }
  store_acc<T, kNT>(a.dv + base, acc_dv, k0 + r0, 0, kNT, kNT, T_len, D,
                    1.f);
  store_acc<T, kNT>(a.dk + base, acc_dk, k0 + r0, 0, kNT, kNT, T_len, D,
                    scale);
}

// ---------------------------------------------------------------------------
// dQ pass: block (64-query tile, h, b), after the dK/dV pass has written dS.
// Warp w owns queries 16·w and all D columns of dQ across the key tiles.
// ---------------------------------------------------------------------------

template <class Pol, int D>
__global__ void __launch_bounds__(kThreads, 3)
attn_bias_bwd_dq_mma(const BiasArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = DqTiles<Pol, D>;
  constexpr int P = Cfg::p, PQ = Cfg::pq, kNT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);      // [2][BK][P]
  T* sDS = sK + 2 * kBK * P;                     // [2][BQ][PQ]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int T_len = a.T_len;
  const size_t bh = (size_t)b * a.H + h;
  const T* __restrict__ k = a.k + bh * T_len * D;
  const T* __restrict__ ds = a.ds + bh * T_len * a.ldk;
  const int kvl = a.kv_len[b];

  // key tiles up to kv_len: the dK/dV pass wrote dS for each (0 past kv_len)
  auto stage = [&](int kt, int buf) {
    stage_rows<Pol, kThreads>(sK + buf * kBK * P, P, k, kt * kBK, kBK, T_len,
                              D);
    stage_cols<Pol, kBK, kThreads>(sDS + buf * kBQ * PQ, PQ, ds, q0,
                                   kt * kBK, kBQ, T_len, a.ldk);
    cp_async_commit();
  };
  stage(0, 0);

  float acc[1][kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.f;

  const int n_kt = (kvl + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    __syncthreads();    // this tile is in; every warp is done with kt − 1
    if (kt + 1 < n_kt) stage(kt + 1, buf ^ 1);
    // dQ += dS·K (scale at the store), 32 keys at a time, not unrolled:
    // unrolled, the compiler hoists every B fragment of the tile and
    // spills. A slice starts 32 columns into the dS tile (f32's column
    // swizzle stays below 32) and 32 rows into the K tile (f32's row shift
    // repeats every 8 rows).
#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 32) {
      accumulate<Pol, kNT, 32, 1>(acc, sDS + buf * kBQ * PQ + kk, PQ,
                                  warp * 16, sK + (buf * kBK + kk) * P, P, 0,
                                  kNT, kNT);
    }
  }
  store_acc<T, kNT>(a.dq + bh * T_len * D, acc[0], q0 + warp * 16, 0, kNT,
                    kNT, T_len, D, a.scale);
}

// ---------------------------------------------------------------------------
// dBias/dGate pass: block (8 query rows, h), a warp a row; dynamic shared
// memory holds each row's dGate strip over b (8 · B floats).
// ---------------------------------------------------------------------------

template <class T>
__global__ void __launch_bounds__(kBiasThreads)
attn_bias_bwd_dbias(const BiasArgs<T> a) {
  extern __shared__ float sDGate[];              // [kRows][B]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kRows + warp, h = blockIdx.y;
  const int B = a.B, H = a.H, T_len = a.T_len;
  if (q >= T_len) return;       // the warp's row is padding (no barrier below)
  const bool with_gate = a.gate != nullptr;
  float* strip = sDGate + warp * B;
  for (int b = lane; b < B; b += 32) strip[b] = 0.f;
  __syncwarp();
  const T* __restrict__ bias = a.bias + ((size_t)h * T_len + q) * T_len;
  float* __restrict__ dbias = a.dbias + ((size_t)h * T_len + q) * T_len;
  constexpr int KT = 32 * kKeysPerLane;

  for (int k0 = 0; k0 < T_len; k0 += KT) {
    float bv[kKeysPerLane], acc[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kj = k0 + lane + 32 * i;
      bv[i] = kj < T_len ? to_f(bias[kj]) : 0.f;
      acc[i] = 0.f;
    }
    for (int b = 0; b < B; ++b) {
      const size_t row = ((size_t)b * H + h) * T_len + q;
      const float gv = with_gate ? a.gate[row] : 1.f;
      const int kvl = a.kv_len[b];
      const T* __restrict__ ds = a.ds + row * a.ldk;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int kj = k0 + lane + 32 * i;
        // past kv_len dS is 0, or was never written (whole key tiles)
        const float d = kj < kvl ? to_f(ds[kj]) : 0.f;
        acc[i] += gv * d;
        part += bv[i] * d;
      }
      if (with_gate) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) strip[b] += part;
      }
    }
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kj = k0 + lane + 32 * i;
      if (kj < T_len) dbias[kj] = acc[i];
    }
  }
  if (with_gate) {
    __syncwarp();
    for (int b = lane; b < B; b += 32)
      a.dgate[((size_t)b * H + h) * T_len + q] = strip[b];
  }
}

template <class T>
cudaError_t run_dbias(const BiasArgs<T>& a, cudaStream_t stream) {
  return wfl::launch(attn_bias_bwd_dbias<T>,
                     dim3((a.T_len + kRows - 1) / kRows, a.H),
                     dim3(kBiasThreads), sizeof(float) * kRows * a.B, stream,
                     a);
}

// The passes in turn on one stream: dK/dV (which writes dS), then dQ and,
// with a bias, dBias/dGate (which read it).
template <class Pol, bool BIAS, bool DROP, int D>
cudaError_t run_passes(const BiasArgs<typename Pol::T>& a,
                       cudaStream_t stream) {
  using Cfg = BiasTiles<Pol, BIAS, D>;
  const int n_kt = (a.T_len + kBK - 1) / kBK;
  cudaError_t err = wfl::launch(attn_bias_bwd_dkdv_mma<Pol, BIAS, DROP, D>,
                                dim3(a.B, n_kt, a.H), dim3(kThreads),
                                Cfg::dkdv_smem, stream, a);
  if (err != cudaSuccess) return err;
  err = wfl::launch(attn_bias_bwd_dq_mma<Pol, D>,
                    dim3((a.T_len + kBQ - 1) / kBQ, a.H, a.B),
                    dim3(kThreads), DqTiles<Pol, D>::dq_smem, stream, a);
  if (err != cudaSuccess || !BIAS) return err;
  return run_dbias(a, stream);
}

// The bias terms only with a bias (at D = 64), the dropout hash only with a
// seed. The bias-free dK/dV pass in bf16 is attention_wgmma.cu's (routes
// wgmma64 and wgmma128, whose dQ pass is this file's, by
// wfl_attention_bwd_dq_mma): it is not instantiated here.
template <class Pol, int D>
cudaError_t dispatch(const BiasArgs<typename Pol::T>& a, cudaStream_t s) {
  if constexpr (D == kD) {
    if (a.bias != nullptr)
      return a.drop.seed ? run_passes<Pol, true, true, D>(a, s)
                         : run_passes<Pol, true, false, D>(a, s);
  }
  if constexpr (std::is_same_v<Pol, PolBF16>) {
    return cudaErrorInvalidValue;
  } else {
    return a.drop.seed ? run_passes<Pol, false, true, D>(a, s)
                       : run_passes<Pol, false, false, D>(a, s);
  }
}

// The dQ pass alone at head width D (dQ += dS·K over the key tiles below
// kv_len, scaled at the store), for a dK/dV pass of another file.
template <class Pol, int D>
cudaError_t run_dq(const BiasArgs<typename Pol::T>& a, cudaStream_t stream) {
  return wfl::launch(attn_bias_bwd_dq_mma<Pol, D>,
                     dim3((a.T_len + kBQ - 1) / kBQ, a.H, a.B),
                     dim3(kThreads), DqTiles<Pol, D>::dq_smem, stream, a);
}

template <class T>
cudaError_t dq_alone(const void* k, const void* kv_len, const void* ds,
                     void* dq, int B, int H, int T_len, int D, int ldk,
                     float scale, cudaStream_t s) {
  BiasArgs<T> a{};
  a.k = static_cast<const T*>(k);
  a.kv_len = static_cast<const int*>(kv_len);
  a.ds = static_cast<T*>(const_cast<void*>(ds));
  a.dq = static_cast<T*>(dq);
  a.B = B;
  a.H = H;
  a.T_len = T_len;
  a.ldk = ldk;
  a.scale = scale;
  using Pol = std::conditional_t<sizeof(T) == 4, PolF32, PolBF16>;
  return D == kD ? run_dq<Pol, kD>(a, s) : run_dq<Pol, kD128>(a, s);
}

template <class T>
cudaError_t dispatch_dtype(const void* q, const void* k, const void* v,
                           const void* bias, const void* gate,
                           const void* dout, const void* lse,
                           const void* delta, const void* kv_len, void* dq,
                           void* dk, void* dv, void* ds, void* dbias,
                           void* dgate, int B, int H, int T_len, int D,
                           int ldk, float scale, Dropout drop,
                           cudaStream_t s) {
  const BiasArgs<T> a{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const T*>(bias), static_cast<const float*>(gate),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(ds),
      static_cast<float*>(dbias), static_cast<float*>(dgate), B, H, T_len,
      ldk, scale, drop};
  using Pol = std::conditional_t<sizeof(T) == 4, PolF32, PolBF16>;
  return D == kD ? dispatch<Pol, kD>(a, s) : dispatch<Pol, kD128>(a, s);
}

template <class T>
cudaError_t dbias_alone(const void* ds, const void* bias, const void* gate,
                        const void* kv_len, void* dbias, void* dgate, int B,
                        int H, int T_len, int ldk, cudaStream_t s) {
  BiasArgs<T> a{};
  a.bias = static_cast<const T*>(bias);
  a.ds = static_cast<T*>(const_cast<void*>(ds));
  a.gate = static_cast<const float*>(gate);
  a.kv_len = static_cast<const int*>(kv_len);
  a.dbias = static_cast<float*>(dbias);
  a.dgate = static_cast<float*>(dgate);
  a.B = B;
  a.H = H;
  a.T_len = T_len;
  a.ldk = ldk;
  return run_dbias(a, s);
}

}  // namespace

using namespace wfl;

// dQ, dK, dV, dBias and dGate of the gated-bias attention at head_dim 64
// (the forward wfl_attention_fwd_bias_mma): the dK/dV pass, the dQ pass, the
// dBias/dGate pass; with a null bias (gate, dbias and dgate null too) dQ,
// dK and dV of the bias-free attention, by the first two, at head_dim 64
// or 128. q, k, v, dout, dq, dk, dv: [B, H, T, D] contiguous of the dtype
// (0 = f32 as 3×TF32, 1 = bf16), D = 64 or 128; bias [H, T, T] of the dtype
// (D = 64 only) or null; gate [B, H, T] f32 or null; lse and delta =
// rowsum(dO·O) [B, H, T] f32; kv_len [B] int32 in [1, T]; ds a workspace
// [B, H, T, ldk] of the dtype, ldk ≥ T a multiple of 64 (its contents on
// return are dS where a key tile is below kv_len); dbias [H, T, T] f32 and
// dgate [B, H, T] f32 (null without gate), every element written; seed (one
// int32 on the device, or null), drop_thr and drop_scale as the forward's.
// The bias-free passes in bf16 are refused (attention_wgmma.cu's dK/dV pass
// and wfl_attention_bwd_dq_mma take them). Returns the launches'
// cudaError_t.
extern "C" int wfl_attention_bwd_bias_mma(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, const void* dout, const void* lse, const void* delta,
    const void* kv_len, const void* seed, void* dq, void* dk, void* dv,
    void* ds, void* dbias, void* dgate, int B, int H, int T_len, int D,
    int ldk, float scale, int drop_thr, float drop_scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != kD && (D != kD128 || bias != nullptr)) ||
      (bias == nullptr) != (dbias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if ((gate == nullptr) != (dgate == nullptr)) return cudaErrorInvalidValue;
  if (bias == nullptr && gate != nullptr) return cudaErrorInvalidValue;
  if (ldk % kBK != 0 || ldk < T_len) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32)
    return dispatch_dtype<float>(q, k, v, bias, gate, dout, lse, delta,
                                 kv_len, dq, dk, dv, ds, dbias, dgate, B, H,
                                 T_len, D, ldk, scale, drop, s);
  if (dtype == kBF16)
    return dispatch_dtype<bf16>(q, k, v, bias, gate, dout, lse, delta,
                                kv_len, dq, dk, dv, ds, dbias, dgate, B, H,
                                T_len, D, ldk, scale, drop, s);
  return cudaErrorInvalidValue;
}

// The dQ pass alone, for the bias-free dK/dV pass of attention_wgmma.cu
// (routes wgmma64 and wgmma128), which leaves dS in a workspace of this
// layout: k and dq [B, H, T, D] contiguous of the dtype (0 = f32, 1 =
// bf16), D = 64 or 128 (narrower heads zero-padded to it); kv_len [B] int32
// in [1, T]; ds [B, H, T, ldk] of the dtype, ldk ≥ T a multiple of 64,
// holding dS for the key tiles below kv_len[b]; scale the scores'. Returns
// the launch's cudaError_t.
extern "C" int wfl_attention_bwd_dq_mma(const void* k, const void* kv_len,
                                        const void* ds, void* dq, int B,
                                        int H, int T_len, int D, int ldk,
                                        float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != kD && D != kD128) || ldk % kBK != 0 || ldk < T_len)
    return cudaErrorInvalidValue;
  if (dtype == kF32)
    return dq_alone<float>(k, kv_len, ds, dq, B, H, T_len, D, ldk, scale, s);
  if (dtype == kBF16)
    return dq_alone<bf16>(k, kv_len, ds, dq, B, H, T_len, D, ldk, scale, s);
  return cudaErrorInvalidValue;
}

// The dBias/dGate pass alone, for a backward that leaves dS in a workspace
// of this layout by other passes (attention_wide.cu at head_dim > 512): ds
// [B, H, T, ldk] of the dtype, ldk ≥ T, holding dS for every key below
// kv_len[b] and every query row below T; bias [H, T, T] of the dtype; gate
// [B, H, T] f32 or null; kv_len [B] int32 in [1, T]; dbias [H, T, T] f32 and
// dgate [B, H, T] f32 (null without gate), every element written. No head
// width enters. Returns the launch's cudaError_t.
extern "C" int wfl_attention_bias_dbias(const void* ds, const void* bias,
                                        const void* gate, const void* kv_len,
                                        void* dbias, void* dgate, int B,
                                        int H, int T_len, int ldk, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias == nullptr || dbias == nullptr || ldk < T_len)
    return cudaErrorInvalidValue;
  if ((gate == nullptr) != (dgate == nullptr)) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return dbias_alone<float>(ds, bias, gate, kv_len, dbias, dgate, B, H,
                              T_len, ldk, s);
  if (dtype == kBF16)
    return dbias_alone<bf16>(ds, bias, gate, kv_len, dbias, dgate, B, H,
                             T_len, ldk, s);
  return cudaErrorInvalidValue;
}
