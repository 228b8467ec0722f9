// Attention at head widths above 512, forward and backward, with or without
// the gated bias, on the tensor cores, for Hopper (sm_90a):
//
//   out[b,h,q,:] = softmax_k( (q·kᵀ)·scale [+ gate[b,h,q]·bias[h,q,k]],
//                             keys k >= kv_len[b] set to -1e30 ) · v
//
// with the row logsumexp LSE = m + log(max(l, 1e-30)) when asked, and dQ,
// dK, dV from the LSE and delta = rowsum(dO·O). A null gate is read as 1.
// The Whisper presets of d_model 1280 (large*, turbo) run their Conformer at
// head_dim 640 under the default 2 heads.
//
// Replaces, at head_dim > 512: wfl_asr_tpu/ops/pallas/flash_attention_bwd.py
// :_fwd_kernel (:49), _bwd_dkdv_kernel (:106), _bwd_dq_kernel (:171) (K1,
// K1b), and with a bias wfl_asr_tpu/ops/pallas/flash_attention.py:
// _flash_kernel (:75), _bwd_dkdv_kernel (:262), _bwd_dq_kernel (:342) (K2,
// K2b). dBias and dGate come from the dBias/dGate pass of
// attention_bwd_bias_mma.cu (wfl_attention_bias_dbias), which reads the dS
// workspace this file's dK/dV pass leaves and no head width.
//
// What bounds it on the card: the same products as the narrower kernels
// (2 forward, 5 backward, of 2·H·T·Σkv_len·D FLOPs each): operations. What
// stops the other designs at 512 is room: a 64-row f32 Q tile at D = 640 is
// 164 KB, and the output or gradient accumulators of a block's rows do not
// fit its registers.
//
// What this design does about it (right first, not fast):
// - A grid over output column blocks of kCB = 128 columns: block (column
//   block, row tile, b·H + h), the column blocks of a row tile adjacent, so
//   that they read the same Q and K rows from L2. Each block owns only its
//   slice of O, dK, dV or dQ in registers (8 warps as 2 row groups × 4
//   column slices, 32 f32 a thread a gradient).
// - The score products need all of D: each block computes the full S = Q·Kᵀ
//   (and in the dK/dV pass dP = dO·Vᵀ) of its tile, looping over D in
//   chunks of kDC = 64 columns staged through shared memory (16-byte
//   cp.async, one buffer, waited for at once), each warp one 16 × 16
//   sub-tile over the whole contraction. The column blocks of a tile run the
//   same instructions on the same data, so their S, P, row max and row sum
//   agree bit for bit; the LSE is written by column block 0.
// - Forward: per key tile (32 keys, 64 queries a block), the scores with
//   scale, gate·bias and the key mask go to shared memory; 4 threads a row
//   keep the online softmax (natural exp) and write P (bf16: rounded, as the
//   JAX kernel's p.astype(v.dtype); f32: split once into TF32 hi and lo
//   halves) and α; then acc = acc·α + P·V[:, slice] (attention_mma.cuh's
//   accumulate).
// - Backward in two launches, as attention_bwd_mma.cu: the dK/dV pass (64
//   keys a block, query tiles of 32 streamed) forms P = exp(S − LSE) and
//   dS = P·(M·dP − delta) per element of the warp's sub-tile of Sᵀ, writes
//   P·M and dS to shared memory, and adds (P·M)ᵀ·dO[:, slice] and
//   dSᵀ·Q[:, slice]; column block 0 also writes dS to a workspace [B, H, T,
//   ldk] of the dtype (ldk = T rounded up to 64). The dQ pass (64 queries a
//   block) runs dQ[:, slice] += dS·K[:, slice] over the key tiles below
//   kv_len from the workspace. Every gradient is written by one block: no
//   atomics, the result does not depend on the schedule.
// - Products on mma.sync through attention_mma.cuh's operand policies: bf16
//   m16n8k16, f32 as three TF32 m16n8k8 products of hi/lo splits, each
//   group of mma steps summed into fresh registers and added in f32.
// - Masking as the other kernels: key tiles wholly past kv_len[b] are
//   skipped (forward, dQ) or write zero dK and dV and no dS; keys ≥ kv_len
//   are -1e30 before the exp; ragged tiles are zero-filled on load, rows
//   past T never stored.
// - Strict attention dropout (K6) as a DROP template flag: the forward
//   multiplies P by wfl::drop_keep of the absolute (b, h, q, k) after the
//   row sum; the dK/dV pass gives dV P·M and dS = P·(M·dP − delta).
//
// What it costs: the score products run once for each column block (5
// times at D = 640), and K, V (backward) and Q are staged again for each
// tile they meet. A faster design keeps more columns a block in registers
// across warpgroups (wgmma) and stages the chunks ahead.
#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDC = 64;       // D columns a staged chunk of a score product
constexpr int kCB = 128;      // output columns a block
constexpr int kMinD = 512;    // narrower widths take the other kernels
constexpr int kFwdBQ = 64, kFwdBK = 32;     // forward: queries, keys a tile
constexpr int kKvBK = 64, kKvBQ = 32;       // dK/dV: keys a block, queries
constexpr int kDqBQ = 64, kDqBK = 32;       // dQ: queries a block, keys
constexpr int kLdk = 64;      // the dS workspace's rows: a multiple of this
constexpr float kNegInf = -1e30f;

// Tiles. Chunk rows of the score products are pitched for kDC columns,
// slice rows for kCB; score tiles by pitch_s. Nothing depends on D, so one
// table serves every width.
template <class Pol>
struct WideTiles {
  static constexpr bool kF32 = sizeof(typename Pol::T) == 4;
  static constexpr int es = sizeof(typename Pol::T);
  static constexpr int pc = Pol::pitch(kDC);
  static constexpr int pv = Pol::pitch(kCB);
  // forward: Q and K chunks, the V slice, P (f32: hi | lo), f32 scores, α
  // and 1/l
  static constexpr int fwd_pp = Pol::pitch_s(kF32 ? 2 * kFwdBK : kFwdBK);
  static constexpr int fwd_ss = kFwdBK + 4;
  static constexpr size_t fwd_smem =
      (size_t)es * ((kFwdBQ + kFwdBK) * pc + kFwdBK * pv + kFwdBQ * fwd_pp)
      + sizeof(float) * (kFwdBQ * fwd_ss + 2 * kFwdBQ);
  // dK/dV: K, V, Q and dO chunks, the Q and dO slices, Pᵀ·M and dSᵀ, the
  // LSE and delta rows
  static constexpr int kv_ps = Pol::pitch_s(kKvBQ);
  static constexpr size_t dkdv_smem =
      (size_t)es * (2 * (kKvBK + kKvBQ) * pc + 2 * kKvBQ * pv
                    + 2 * kKvBK * kv_ps)
      + sizeof(float) * 2 * kKvBQ;
  // dQ: the dS tile and the K slice
  static constexpr int dq_ps = Pol::pitch_s(kDqBK);
  static constexpr size_t dq_smem =
      (size_t)es * (kDqBQ * dq_ps + kDqBK * pv);
  // 228 KB a SM, 1 KB of it reserved per block: two blocks a SM
  static_assert(2 * (fwd_smem + 1024) <= 233472, "forward tiles too large");
  static_assert(2 * (dkdv_smem + 1024) <= 233472, "dK/dV tiles too large");
  static_assert(2 * (dq_smem + 1024) <= 233472, "dQ tiles too large");
};

// The launches' arguments as one kernel parameter: [B, H, T, D] tensors,
// bias [H, T, T] of the dtype or null, gate [B, H, T] f32 or null, the key
// lengths, the LSE (written by the forward when not null, read by the
// backward) and delta rows, the dS workspace [B, H, T, ldk].
template <class T>
struct WideArgs {
  const T *q, *k, *v, *dout, *bias;
  const float *gate, *delta;
  float* lse;
  const int* kv_len;
  T *out, *dq, *dk, *dv, *ds;
  int H, T_len, D, ldk;
  float scale;
  Dropout drop;
};

// rows [row0, row0 + n) × columns [c0, c0 + w) of a row-major matrix of row
// pitch ld into a tile laid out by Pol::at (pitch p), by 16-byte cp.async in
// the caller's copy group; rows past T are zero-filled. w is a multiple of
// 16 elements.
template <class Pol>
__device__ __forceinline__ void stage_block(typename Pol::T* dst, int p,
                                            const typename Pol::T* src,
                                            int row0, int c0, int n, int w,
                                            int T_len, int ld) {
  const int nv = w / Pol::kVec;
  for (int idx = threadIdx.x; idx < n * nv; idx += kThreads) {
    const int r = idx / nv, c = (idx - r * nv) * Pol::kVec;
    const bool ok = row0 + r < T_len;
    cp_async16(dst + Pol::at(p, r, c),
               ok ? src + (size_t)(row0 + r) * ld + c0 + c : src,
               ok ? 16 : 0);
  }
}

// gate·bias[h, q, k] of an in-range (q, k), or 0 without a bias
template <class T, bool BIAS>
__device__ __forceinline__ float gated_bias(const WideArgs<T>& a, size_t bh,
                                            int h, int q, int k) {
  if constexpr (!BIAS) return 0.f;
  const float g = a.gate != nullptr ? a.gate[bh * a.T_len + q] : 1.f;
  return g * to_f(a.bias[((size_t)h * a.T_len + q) * a.T_len + k]);
}

// ---------------------------------------------------------------------------
// Forward: block (column block, 64-query tile, b·H + h). Warp w computes the
// 16 × 16 score sub-tile (rows 16·(w / 2), keys 16·(w % 2)) over all of D,
// then owns rows 32·(w % 2) and the column slice w / 2 of the block's
// output columns. Thread i runs the softmax of query row i / 4, keys
// 8·(i % 4) + [0, 8) of each tile.
// ---------------------------------------------------------------------------

template <class Pol, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_fwd(const WideArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = WideTiles<Pol>;
  constexpr int BQ = kFwdBQ, BK = kFwdBK, PC = Cfg::pc, PV = Cfg::pv;
  constexpr int PP = Cfg::fwd_pp, SS = Cfg::fwd_ss, KPT = BK / 4, MT = 2;
  constexpr int NPW = 4;          // 8-column tiles a warp: kCB / 8 / 4
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);        // [BQ][PC] a chunk of Q
  T* sK = sQ + BQ * PC;                           // [BK][PC] a chunk of K
  T* sV = sK + BK * PC;                           // [BK][PV] V's slice
  T* sP = sV + BK * PV;                           // [BQ][PP]
  float* sS = reinterpret_cast<float*>(sP + BQ * PP);   // [BQ][SS]
  float* sAlpha = sS + BQ * SS;                   // [BQ]
  float* sInv = sAlpha + BQ;                      // [BQ]

  const int cb = blockIdx.x, q0 = blockIdx.y * BQ;
  const int bhi = blockIdx.z, b = bhi / a.H, h = bhi - b * a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)bhi;
  const size_t base = bh * T_len * D;
  const int col0 = cb * kCB, ncol = min(kCB, D - col0), NT = ncol / 8;
  const int kvl = a.kv_len[b];
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;

  const int sr0 = (warp >> 1) * 16, sc0 = (warp & 1) * 16;   // S sub-tile
  const int srow = tid >> 2, skey = (tid & 3) * KPT, qi = q0 + srow;
  const int ar0 = (warp & 1) * 32;                           // P·V rows
  const int npw = cols_per_warp(NT, 4), nt0 = (warp >> 1) * npw;
  float m_run = kNegInf, l_run = 0.f;
  float acc[MT][NPW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int n_kt = (kvl + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // S = Q·Kᵀ over D, a chunk at a time; V's slice comes with chunk 0
    float s[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kDC) {
      const int w = min(kDC, D - c0);
      __syncthreads();    // every warp is done with the buffers
      stage_block<Pol>(sQ, PC, a.q + base, q0, c0, BQ, w, T_len, D);
      stage_block<Pol>(sK, PC, a.k + base, k0, c0, BK, w, T_len, D);
      if (c0 == 0)
        stage_block<Pol>(sV, PV, a.v + base, k0, col0, BK, ncol, T_len, D);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float x[2][4];
      score_part<Pol>(x, sQ, sK, PC, sr0, sc0, 0, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][e] += x[0][e];
        s[1][e] += x[1][e];
      }
    }
    // scale, gated bias, key mask
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = sr0 + g + 8 * (e >> 1), c = sc0 + 8 * n + 2 * t4 + (e & 1);
        const int qr = q0 + r, kj = k0 + c;
        float val = kNegInf;
        if (kj < kvl) {
          val = s[n][e] * a.scale;
          if (BIAS && qr < T_len) val += gated_bias<T, BIAS>(a, bh, h, qr, kj);
        }
        sS[r * SS + c] = val;
      }
    __syncthreads();

    // online softmax of row srow over keys k0 + skey + [0, KPT)
    {
      float p[KPT];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        p[i] = sS[srow * SS + skey + i];
        mx = fmaxf(mx, p[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        p[i] = expf(p[i] - m_new);
        ps += p[i];
      }
      l_run = l_run * alpha + ps;
      m_run = m_new;
      // K6: l keeps the undropped sum, only P·V takes the mask
      if constexpr (DROP) {
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int kj = k0 + skey + i;
          if (qi < T_len && kj < kvl) p[i] *= drop_keep(a.drop, dbase, qi, kj);
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; i += 2)
        Pol::template store2_split<BK>(sP, PP, srow, skey + i, p[i],
                                       p[i + 1]);
      if ((tid & 3) == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // acc = acc·α + P·V[:, slice]
    float al[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) al[m][i] = sAlpha[ar0 + 16 * m + g + 8 * i];
    accumulate<Pol, NPW, BK, MT, BK, true>(acc, sP, PP, ar0, sV, PV, nt0, npw,
                                           NT, al);
  }

  // the row sum over the row's 4 threads, the LSE and 1/l
  {
    float l = l_run;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    if ((tid & 3) == 0) {
      sInv[srow] = 1.f / lc;
      if (cb == 0 && a.lse != nullptr && qi < T_len)
        a.lse[bh * T_len + qi] = m_run + logf(lc);
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = ar0 + 16 * m;
    const float inv[2] = {sInv[r0 + g], sInv[r0 + g + 8]};
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] *= inv[e >> 1];
    store_acc<T, NPW>(a.out + base + col0, acc[m], q0 + r0, nt0, npw, NT,
                      T_len, D, 1.f);
  }
}

// ---------------------------------------------------------------------------
// dK/dV pass: block (column block, 64-key tile, b·H + h). Per streamed tile
// of 32 queries, warp w computes the 16 × 16 sub-tiles (keys 16·(w / 2),
// queries 16·(w % 2)) of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over all of D, then owns
// keys 32·(w % 2) and the column slice w / 2 of dV and dK.
// ---------------------------------------------------------------------------

template <class Pol, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_bwd_dkdv(const WideArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = WideTiles<Pol>;
  constexpr int BK = kKvBK, BQ = kKvBQ, PC = Cfg::pc, PV = Cfg::pv;
  constexpr int PS = Cfg::kv_ps, MT = 2, NPW = 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);        // [BK][PC] chunks
  T* sV = sK + BK * PC;                           // [BK][PC]
  T* sQ = sV + BK * PC;                           // [BQ][PC]
  T* sDO = sQ + BQ * PC;                          // [BQ][PC]
  T* sQs = sDO + BQ * PC;                         // [BQ][PV] slices
  T* sDOs = sQs + BQ * PV;                        // [BQ][PV]
  T* sPt = sDOs + BQ * PV;                        // [BK][PS] Pᵀ·M
  T* sDSt = sPt + BK * PS;                        // [BK][PS] dSᵀ
  float* sL = reinterpret_cast<float*>(sDSt + BK * PS);   // [BQ]
  float* sDl = sL + BQ;                                    // [BQ]

  const int cb = blockIdx.x, k0 = blockIdx.y * BK;
  const int bhi = blockIdx.z, b = bhi / a.H, h = bhi - b * a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)bhi;
  const size_t base = bh * T_len * D;
  const int col0 = cb * kCB, ncol = min(kCB, D - col0), NT = ncol / 8;
  const int kvl = a.kv_len[b];
  if (k0 >= kvl) {      // no query attends these keys: zero gradients
    for (int idx = tid; idx < BK * ncol; idx += kThreads) {
      const int r = idx / ncol, c = idx - r * ncol;
      if (k0 + r < T_len) {
        a.dk[base + (size_t)(k0 + r) * D + col0 + c] = from_f<T>(0.f);
        a.dv[base + (size_t)(k0 + r) * D + col0 + c] = from_f<T>(0.f);
      }
    }
    return;
  }
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;
  T* __restrict__ ds = a.ds + bh * T_len * a.ldk;

  const int sr0 = (warp >> 1) * 16, sc0 = (warp & 1) * 16;   // sub-tile
  const int ar0 = (warp & 1) * 32;                           // dK/dV rows
  const int npw = cols_per_warp(NT, 4), nt0 = (warp >> 1) * npw;
  float acc_dv[MT][NPW][4], acc_dk[MT][NPW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dv[m][n][e] = acc_dk[m][n][e] = 0.f;

  const int n_qt = (T_len + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = dp[0][e] = dp[1][e] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kDC) {
      const int w = min(kDC, D - c0);
      __syncthreads();    // every warp is done with the buffers
      stage_block<Pol>(sK, PC, a.k + base, k0, c0, BK, w, T_len, D);
      stage_block<Pol>(sV, PC, a.v + base, k0, c0, BK, w, T_len, D);
      stage_block<Pol>(sQ, PC, a.q + base, q0, c0, BQ, w, T_len, D);
      stage_block<Pol>(sDO, PC, a.dout + base, q0, c0, BQ, w, T_len, D);
      if (c0 == 0) {
        stage_block<Pol>(sQs, PV, a.q + base, q0, col0, BQ, ncol, T_len, D);
        stage_block<Pol>(sDOs, PV, a.dout + base, q0, col0, BQ, ncol, T_len,
                         D);
        stage_stats<kThreads>(sL, sDl, a.lse, a.delta, bh, q0, BQ, T_len);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float x[2][4], y[2][4];
      score_part<Pol>(x, sK, sQ, PC, sr0, sc0, 0, w);
      score_part<Pol>(y, sV, sDO, PC, sr0, sc0, 0, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][e] += x[0][e];
        s[1][e] += x[1][e];
        dp[0][e] += y[0][e];
        dp[1][e] += y[1][e];
      }
    }
    // P = exp(S − LSE), dS = P·(M·dP − delta) per element; rows are keys,
    // columns queries. Pairs of adjacent queries go to the tiles together.
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kl = sr0 + g + 8 * i, kj = k0 + kl;
        float pm[2], dsv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          const int ql = sc0 + 8 * n + 2 * t4 + j, qi = q0 + ql;
          // mask before the exp: a masked key's raw score may exceed the
          // LSE by more than 88, and exp → inf, times 0, is NaN
          float sv = kNegInf;
          if (kj < kvl) {
            sv = s[n][e] * a.scale;
            if (BIAS && qi < T_len)
              sv += gated_bias<T, BIAS>(a, bh, h, qi, kj);
          }
          const float p = qi < T_len ? expf(sv - sL[ql]) : 0.f;
          const float ks = (DROP && qi < T_len && kj < kvl)
              ? drop_keep(a.drop, dbase, qi, kj) : 1.f;
          pm[j] = p * ks;
          dsv[j] = p * (dp[n][e] * ks - sDl[ql]);
          if (cb == 0 && qi < T_len)
            ds[(size_t)qi * a.ldk + kj] = from_f<T>(dsv[j]);
        }
        const int ql0 = sc0 + 8 * n + 2 * t4;
        Pol::store2(sPt, PS, kl, ql0, pm[0], pm[1]);
        Pol::store2(sDSt, PS, kl, ql0, dsv[0], dsv[1]);
      }
    __syncthreads();
    // dV += (P·M)ᵀ·dO[:, slice], dK += dSᵀ·Q[:, slice] (scale at the store)
    accumulate<Pol, NPW, BQ, MT>(acc_dv, sPt, PS, ar0, sDOs, PV, nt0, npw,
                                 NT);
    accumulate<Pol, NPW, BQ, MT>(acc_dk, sDSt, PS, ar0, sQs, PV, nt0, npw,
                                 NT);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    store_acc<T, NPW>(a.dv + base + col0, acc_dv[m], k0 + ar0 + 16 * m, nt0,
                      npw, NT, T_len, D, 1.f);
    store_acc<T, NPW>(a.dk + base + col0, acc_dk[m], k0 + ar0 + 16 * m, nt0,
                      npw, NT, T_len, D, a.scale);
  }
}

// ---------------------------------------------------------------------------
// dQ pass: block (column block, 64-query tile, b·H + h), after the dK/dV
// pass has written dS. Warp w owns queries 32·(w % 2) and the column slice
// w / 2 of dQ across the key tiles below kv_len.
// ---------------------------------------------------------------------------

template <class Pol>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_bwd_dq(const WideArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = WideTiles<Pol>;
  constexpr int BQ = kDqBQ, BK = kDqBK, PV = Cfg::pv, PS = Cfg::dq_ps;
  constexpr int MT = 2, NPW = 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sDS = reinterpret_cast<T*>(smem_raw);       // [BQ][PS]
  T* sK = sDS + BQ * PS;                          // [BK][PV] K's slice

  const int cb = blockIdx.x, q0 = blockIdx.y * BQ;
  const int bhi = blockIdx.z, b = bhi / a.H;
  const int warp = threadIdx.x >> 5;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)bhi;
  const size_t base = bh * T_len * D;
  const int col0 = cb * kCB, ncol = min(kCB, D - col0), NT = ncol / 8;
  const T* __restrict__ ds = a.ds + bh * T_len * a.ldk;
  const int kvl = a.kv_len[b];
  const int ar0 = (warp & 1) * 32;
  const int npw = cols_per_warp(NT, 4), nt0 = (warp >> 1) * npw;
  float acc[MT][NPW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // key tiles up to kv_len: the dK/dV pass wrote dS for each (0 past kv_len)
  const int n_kt = (kvl + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();      // every warp is done with the buffers
    stage_cols<Pol, BK, kThreads>(sDS, PS, ds, q0, k0, BQ, T_len, a.ldk);
    stage_block<Pol>(sK, PV, a.k + base, k0, col0, BK, ncol, T_len, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    accumulate<Pol, NPW, BK, MT>(acc, sDS, PS, ar0, sK, PV, nt0, npw, NT);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_acc<T, NPW>(a.dq + base + col0, acc[m], q0 + ar0 + 16 * m, nt0, npw,
                      NT, T_len, D, a.scale);
}

int col_blocks(int D) { return (D + kCB - 1) / kCB; }

template <class Pol, bool BIAS, bool DROP>
cudaError_t run_fwd(const WideArgs<typename Pol::T>& a, int B,
                    cudaStream_t s) {
  return wfl::launch(attn_wide_fwd<Pol, BIAS, DROP>,
                     dim3(col_blocks(a.D), (a.T_len + kFwdBQ - 1) / kFwdBQ,
                          B * a.H),
                     dim3(kThreads), WideTiles<Pol>::fwd_smem, s, a);
}

// The dK/dV pass (which writes dS), then the dQ pass (which reads it).
template <class Pol, bool BIAS, bool DROP>
cudaError_t run_bwd(const WideArgs<typename Pol::T>& a, int B,
                    cudaStream_t s) {
  cudaError_t err = wfl::launch(
      attn_wide_bwd_dkdv<Pol, BIAS, DROP>,
      dim3(col_blocks(a.D), (a.T_len + kKvBK - 1) / kKvBK, B * a.H),
      dim3(kThreads), WideTiles<Pol>::dkdv_smem, s, a);
  if (err != cudaSuccess) return err;
  return wfl::launch(attn_wide_bwd_dq<Pol>,
                     dim3(col_blocks(a.D), (a.T_len + kDqBQ - 1) / kDqBQ,
                          B * a.H),
                     dim3(kThreads), WideTiles<Pol>::dq_smem, s, a);
}

// The bias terms only with a bias, the dropout hash only with a seed.
template <class Pol>
cudaError_t dispatch(const WideArgs<typename Pol::T>& a, int B, bool fwd,
                     cudaStream_t s) {
#define WFL_WIDE(bias, drop)                                    \
  return fwd ? run_fwd<Pol, bias, drop>(a, B, s)                \
             : run_bwd<Pol, bias, drop>(a, B, s)
  if (a.bias != nullptr) {
    if (a.drop.seed) WFL_WIDE(true, true);
    WFL_WIDE(true, false);
  }
  if (a.drop.seed) WFL_WIDE(false, true);
  WFL_WIDE(false, false);
#undef WFL_WIDE
}

template <class T>
cudaError_t dispatch_dtype(const WideArgs<T>& a, int B, bool fwd,
                           cudaStream_t s) {
  if constexpr (sizeof(T) == 4) return dispatch<PolF32>(a, B, fwd, s);
  else return dispatch<PolBF16>(a, B, fwd, s);
}

// The checks both launchers share: D a multiple of 16 above 512, a gate
// only with a bias.
bool refused(int D, const void* bias, const void* gate) {
  return D <= kMinD || D % 16 != 0 || (bias == nullptr && gate != nullptr);
}

template <class T>
WideArgs<T> args(const void* q, const void* k, const void* v,
                 const void* bias, const void* gate, const void* kv_len,
                 void* lse, int H, int T_len, int D, float scale,
                 Dropout drop) {
  WideArgs<T> a{};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.bias = static_cast<const T*>(bias);
  a.gate = static_cast<const float*>(gate);
  a.kv_len = static_cast<const int*>(kv_len);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.T_len = T_len;
  a.D = D;
  a.scale = scale;
  a.drop = drop;
  return a;
}

}  // namespace

using namespace wfl;

// The forward at head_dim > 512 (wfl_flash_attention_fwd's arguments, which
// it shares): q, k, v, out [B, H, T, D] contiguous of the dtype (0 = f32 as
// 3×TF32, 1 = bf16), D a multiple of 16 above 512; bias [H, T, T] of the
// dtype or null; gate [B, H, T] f32 or null (read as 1; refused without a
// bias); kv_len [B] int32 in [1, T]; lse [B, H, T] f32, written when not
// null; seed (one int32 on the device, or null), drop_thr and drop_scale as
// the other forwards'. Returns the launch's cudaError_t.
extern "C" int wfl_attention_wide_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* gate, const void* kv_len,
                                      void* out, void* lse, const void* seed,
                                      int B, int H, int T_len, int D,
                                      float scale, int drop_thr,
                                      float drop_scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (refused(D, bias, gate)) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32) {
    WideArgs<float> a = args<float>(q, k, v, bias, gate, kv_len, lse, H,
                                    T_len, D, scale, drop);
    a.out = static_cast<float*>(out);
    return dispatch_dtype(a, B, true, s);
  }
  if (dtype == kBF16) {
    WideArgs<bf16> a = args<bf16>(q, k, v, bias, gate, kv_len, lse, H, T_len,
                                  D, scale, drop);
    a.out = static_cast<bf16*>(out);
    return dispatch_dtype(a, B, true, s);
  }
  return cudaErrorInvalidValue;
}

// dQ, dK and dV at head_dim > 512: the dK/dV pass, then the dQ pass. q, k,
// v, dout, dq, dk, dv [B, H, T, D] contiguous of the dtype, D a multiple of
// 16 above 512; bias [H, T, T] of the dtype or null; gate [B, H, T] f32 or
// null; lse and delta = rowsum(dO·O) [B, H, T] f32; kv_len [B] int32 in
// [1, T]; ds a workspace [B, H, T, ldk] of the dtype, ldk ≥ T a multiple of
// 64, which holds dS on return for every key below kv_len[b] (the input of
// wfl_attention_bias_dbias for dBias and dGate); seed, drop_thr, drop_scale
// as the forward's. Returns the launches' cudaError_t.
extern "C" int wfl_attention_wide_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, const void* dout, const void* lse, const void* delta,
    const void* kv_len, const void* seed, void* dq, void* dk, void* dv,
    void* ds, int B, int H, int T_len, int D, int ldk, float scale,
    int drop_thr, float drop_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (refused(D, bias, gate)) return cudaErrorInvalidValue;
  if (ldk % kLdk != 0 || ldk < T_len) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
#define WFL_WIDE_BWD(T)                                                   \
  WideArgs<T> a = args<T>(q, k, v, bias, gate, kv_len,                    \
                          const_cast<void*>(lse), H, T_len, D, scale, drop); \
  a.dout = static_cast<const T*>(dout);                                   \
  a.delta = static_cast<const float*>(delta);                            \
  a.dq = static_cast<T*>(dq);                                             \
  a.dk = static_cast<T*>(dk);                                             \
  a.dv = static_cast<T*>(dv);                                             \
  a.ds = static_cast<T*>(ds);                                             \
  a.ldk = ldk;                                                            \
  return dispatch_dtype(a, B, false, s)
  if (dtype == kF32) { WFL_WIDE_BWD(float); }
  if (dtype == kBF16) { WFL_WIDE_BWD(bf16); }
#undef WFL_WIDE_BWD
  return cudaErrorInvalidValue;
}
