// Forward of the gated-bias key-masked attention at head_dim 64 (WavLM's
// gated relative-position attention, 12 layers on the main path, in serving
// and in training), and of the bias-free one at head_dim 64 and 128, on the
// tensor cores, for Hopper (sm_90a):
//
//   out[b,h,q,:] = softmax_k( (q·kᵀ)·scale + gate[b,h,q]·bias[h,q,k],
//                             keys k >= kv_len[b] set to -1e30 ) · v
//
// and, when asked, the row logsumexp LSE = m + log(max(l, 1e-30)) (natural
// log) that the backward (attention_bwd_bias_mma.cu) reads. A null gate is
// read as 1. A null bias (with a null gate) drops the gated term: the
// bias-free instantiation (BIAS = false), which serves bias-free f32 calls
// at head_dim ≤ 64 (route mma64: Whisper's layers, the `none` encoder's
// Conformer) and, at head width D = 128, at 80-128 (route mma128: a
// Conformer of hidden 512 under 4 heads, Whisper-base's at the config
// schema's default); narrower widths are zero-padded to 64 or 128 by the
// caller, with the true 1/√d. In bf16 those calls take attention_wgmma.cu
// (routes wgmma64, wgmma128). The head width is a template parameter; a
// bias is taken at D = 64 only.
//
// Replaces wfl_asr_tpu/ops/pallas/flash_attention.py:_flash_kernel (:75),
// the kernel of _fwd_impl (:189) (K2), and, without a bias,
// wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:_fwd_kernel (:49) (K1) in
// f32 at head_dim ≤ 128. Calls with a bias at other widths up to 512 keep the
// forwards of flash_attention.cu; wider calls take attention_wide.cu.
//
// What bounds it on the card: 2 products of 2·H·T·Σkv_len·D FLOPs (S = Q·Kᵀ,
// O = P·V; 4.2e10 at [8, 12, 1499, 64] with kv_len 1499 − 100·b) against the
// [H, T, T] bias read once and Q, K, V, O once (128 MB in bf16, 255 MB in
// f32): operations in both dtypes, barely in bf16 (0.043 ms at 989 TFLOP/s,
// the bytes 0.038 at 3.35 TB/s), 0.26 ms in f32 at the 3×TF32 ceiling. The
// kernels this replaces read the bias once for every batch element (grid
// (q-tile, h, b), b slowest: 431 MB a bf16 call), one element at a time
// inside the softmax, staged K and V synchronously with two barriers a tile,
// and ran f32 as FMA loops from shared memory at 255 registers.
//
// What this design does about it:
// - Batch-innermost grid: block (b, 16·warps-query tile, h), b the fastest
//   block index, so the B blocks that read one [query tile × T] bias strip
//   run together; the strip comes from device memory once and from L2 B − 1
//   times (54 MB of bias traffic a bf16 call, 108 MB in f32).
// - The FlashAttention-2 layout: each warp owns 16 query rows and all D
//   output columns in registers, and keeps its Q fragments in registers for
//   the whole key loop (f32: split once into TF32 hi/lo halves). P is
//   re-packed from the score accumulators as the A operand of P·V
//   (attention_mma.cuh: a_from_acc, accumulate_held), with no trip through
//   shared memory; row statistics reduce over the quad. The 16 × 16 score
//   sub-tiles of attention_fwd_mma.cu, with both operands in shared memory
//   (bound by shared-memory reads there), are for D = 384, where the
//   output accumulator leaves no room for Q in registers.
// - Both products run on mma.sync through the operand policies of
//   attention_mma.cuh: bf16 m16n8k16 (P rounded to bf16 before P·V, as the
//   JAX kernel's p.astype(v.dtype)); f32 as three TF32 m16n8k8 products of
//   hi/lo splits, each group of mma steps summed into fresh registers and
//   added in f32 (the tensor core truncates when it adds into a live
//   accumulator). bf16 rescales the output by α and lets the mma add into
//   it.
// - Staging, one tile ahead: K and V of key tile k + 1 by 16-byte cp.async
//   (stage_rows_by_warp, several 64-wide rows a warp at once), and the bias
//   tile in the same copy group (stage_spans): each query row's 64 (bf16) or
//   32 (f32) keys as the 16-byte-aligned span that covers them, 9 chunks,
//   read at the row's element offset. So the bias comes in whole 16-byte
//   copies although its rows are T elements apart (odd at T = 1499), and
//   tile k + 1's copies are in flight while tile k is computed; one barrier
//   a tile.
// - The softmax in base 2: log2(e) is folded into the scale and the gate,
//   so each score costs one exp2f; the LSE is written in natural log.
// - Without a bias (BIAS = false) the bias spans, their share of shared
//   memory and the gate go; the tile that remains is the FlashAttention-2
//   layout alone (FwdBiasTiles<Pol, false, D>).
// - At D = 128 (bias-free f32 only) the same layout holds twice the
//   columns: a warp's output is 64 f32 registers a thread. It runs 8 warps
//   (128 queries) a block and 1 block a SM, which leaves each thread 255
//   registers (2 blocks of 8 warps allow 128). Q's TF32 hi/lo halves alone
//   would be 128 registers: each warp reads its Q fragment from shared
//   memory and splits it on use in every k-step of S (q_regs = false), as
//   attention_fwd_mma.cu does at D = 384. Measured on the card
//   (kernel_variants_ab.py --kernel k128, [8, 4, 1500, 128]): 4 warps and 2
//   blocks a SM were 4-8 % slower, Q's fragments in registers (spilling)
//   25-28 %, 16-key tiles and 3 blocks 13-14 %. What bounds it there (its
//   clocks variants): P·V 43-49 % of the key loop (each warp splits V's B
//   fragments on use), S 28-37 %, issuing the next tile's copies 11-15 %.
// - Masking: key tiles wholly past kv_len[b] are skipped (key 0 is always
//   valid, kv_len ≥ 1), keys past kv_len are set to -1e30 before the row
//   max; ragged K/V tiles and query rows past T are zero-filled, rows past T
//   never stored.
// - Strict attention dropout (K6) as a DROP template flag: l sums the
//   undropped p, and wfl::drop_keep of the absolute (b, h, q, k) multiplies
//   P after the row sum and before P·V, bit for bit the JAX kernel's mask.
// - Tiles (FwdBiasTiles), measured on the card against the alternatives
//   (kernel_variants_ab.py): bf16 8 warps (128 queries) and 64-key tiles,
//   128 registers, 90 KB of shared memory, 2 blocks a SM (4 warps, or
//   32-key tiles, were 16 % and 8 % slower); f32 4 warps (64 queries) and
//   32-key tiles, 253 registers, 72 KB, 2 blocks a SM (3 blocks a SM, at
//   168 registers and a spill, were 2 % slower; fresh sums of 2 or 8 mma
//   steps no faster than 4). f32 splits K and V on use, in every warp:
//   splitting each tile once into hi/lo halves in shared memory, for a
//   second barrier and 36 KB, was 13 % slower.
//
// What still bounds it (kernel_variants_ab.py --kernel k1w: clock64 per
// phase of the key loop, the bias-free f32 instantiation at [8, 8, 1500,
// 64]): issuing the next tile's cp.async copies takes 40 % of the warps'
// cycles, the softmax 8 %, S 23 %, P·V 27 %, waiting for the tile 2 %.
#include <type_traits>

#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;       // the head width with a bias, and of route mma64
constexpr int kD128 = 128;   // the bias-free head width of route mma128
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles by dtype and head width: warps of 16 query rows, keys a tile, and
// blocks a SM the registers are bounded for. Shared memory holds Q (BQ
// rows), two buffers of K and V (BK rows each) and, with a bias, two of the
// bias spans (BQ rows of PB). Without a bias the registers, not shared
// memory, bound the blocks a SM. q_regs: Q's fragments held in registers
// for the whole key loop (at D = 64; f32 at D = 128 reads them from shared
// memory). bf16 is taken at D = 64 with a bias only.
template <class Pol, bool BIAS, int D>
struct FwdBiasTiles {
  static constexpr bool kF32 = sizeof(typename Pol::T) == 4;
  static constexpr int es = sizeof(typename Pol::T);
  static constexpr int warps = kF32 && D == kD ? 4 : 8;
  static constexpr int bk = kF32 ? 32 : 64;
  static constexpr int blocks = D == kD ? 2 : 1;
  static constexpr bool q_regs = D == kD;
  // mma steps of S run into one accumulator before they are added in f32
  // (see scores)
  static constexpr int s_chunk = 4;
  static constexpr int threads = 32 * warps;
  static constexpr int bq = 16 * warps;
  static constexpr int p = Pol::pitch(D);
  static constexpr int pb = (bk * es / 16 + 1) * 16 / es;
  static constexpr size_t smem =
      (size_t)es * (bq * p + 2 * 2 * bk * p + (BIAS ? 2 * bq * pb : 0));
  static_assert(D == kD || (D == kD128 && !BIAS && kF32),
                "a bias only at head_dim 64; bias-free at 64 and, in f32, "
                "128");
  static_assert(bk * es % 16 == 0, "a key tile moves the spans by chunks");
  // 228 KB a SM, 1 KB of it reserved per block
  static_assert(blocks * (smem + 1024) <= 233472,
                "forward blocks a SM exceed its shared memory");
};

// The forward's arguments ([B, H, T, D] tensors, bias [H, T, T] of the
// dtype, gate [B, H, T] f32 or null, the key lengths, the LSE rows or null)
// as one kernel parameter.
template <class T>
struct FwdBiasArgs {
  const T *q, *k, *v, *bias;
  const float* gate;
  const int* kv_len;
  T* out;
  float* lse;
  int H, T_len;
  float scale;
  Dropout drop;
};

// S = Q·Kᵀ for the warp's 16 query rows and the 16·NJ keys of tK: s[j][n]
// is the 8-key tile 2j + n. Q's A fragment of k-step kk is qa[kk] (QREGS),
// or is read from rows r0 of the tile sQ and split on use. Each CH mma
// steps sum into fresh registers that are then added in f32 (see
// score_part).
template <class Pol, int D, int NJ, bool QREGS, int CH>
__device__ __forceinline__ void scores(
    float (&s)[NJ][2][4],
    const typename Pol::A (&qa)[QREGS ? D / Pol::KS : 1],
    const typename Pol::T* sQ, int r0, const typename Pol::T* tK, int p) {
  constexpr int KD = D / Pol::KS;
  static_assert(KD % CH == 0, "whole groups of mma steps");
#pragma unroll
  for (int kc = 0; kc < KD; kc += CH) {
    float y[NJ][2][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][0][e] = y[j][1][e] = 0.f;
#pragma unroll
    for (int kk = kc; kk < kc + CH; ++kk) {
      typename Pol::A a;
      if constexpr (QREGS) a = qa[kk];
      else Pol::load_ak(a, sQ, p, r0, kk * Pol::KS);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename Pol::B b0, b1;
        Pol::load_bk2(b0, b1, tK, p, 16 * j, kk * Pol::KS);
        Pol::mma(y[j][0], a, b0);
        Pol::mma(y[j][1], a, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][n][e] = kc == 0 ? y[j][n][e] : s[j][n][e] + y[j][n][e];
  }
}

// ---------------------------------------------------------------------------
// Block (b, query tile, h). Warp w owns queries 16·w of the tile and all D
// output columns across the key tiles; lane (g, t) holds rows g and g + 8
// and keys 8·n + 2t + {0, 1} of each 8-key score tile n.
// ---------------------------------------------------------------------------

template <class Pol, bool BIAS, bool DROP, int D>
__global__ void __launch_bounds__(FwdBiasTiles<Pol, BIAS, D>::threads,
                                  FwdBiasTiles<Pol, BIAS, D>::blocks)
attn_bias_fwd_mma(const FwdBiasArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = FwdBiasTiles<Pol, BIAS, D>;
  constexpr int NW = Cfg::warps, BQ = Cfg::bq, BK = Cfg::bk, P = Cfg::p;
  constexpr int PB = Cfg::pb, KD = D / Pol::KS, NJ = BK / 16;
  constexpr int kNT = D / 8;                      // 8-column output tiles
  constexpr bool kInPlace = !Cfg::kF32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [BQ][P]
  T* sK = sQ + BQ * P;                            // [2][BK][P]
  T* sV = sK + 2 * BK * P;                        // [2][BK][P]
  T* sB = sV + 2 * BK * P;                        // [2][BQ][PB] bias spans
                                                  // (with a bias)

  const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len;
  const size_t bh = (size_t)b * a.H + h;
  const size_t base = bh * T_len * D;
  const T* __restrict__ k = a.k + base;
  const T* __restrict__ v = a.v + base;
  const T* bias = BIAS ? a.bias + (size_t)h * T_len * T_len : nullptr;
  const T* bias_end = BIAS ? a.bias + (size_t)a.H * T_len * T_len : nullptr;
  const int kvl = a.kv_len[b];
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;

  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    stage_rows_by_warp<Pol, NW>(sK + buf * BK * P, P, k, k0, BK, T_len, D);
    stage_rows_by_warp<Pol, NW>(sV + buf * BK * P, P, v, k0, BK, T_len, D);
    if constexpr (BIAS)
      stage_spans<T, BK, Cfg::threads>(sB + buf * BQ * PB, PB, bias, T_len,
                                       q0, k0, BQ, T_len, a.bias, bias_end);
  };
  stage_rows_by_warp<Pol, NW>(sQ, P, a.q + base, q0, BQ, T_len, D);
  stage(0, 0);
  cp_async_commit();

  // this lane's two rows: log2(e)·gate, and where the row's bias span starts
  // in a bias tile (the element offset is the same for every key tile, as a
  // tile moves the span by whole chunks)
  const int r0 = warp * 16;
  int qrow[2], brow[2];
  float gl[2], m_row[2], l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = r0 + g + 8 * i;
    qrow[i] = q0 + lr;
    const bool ok = qrow[i] < T_len;
    gl[i] = kLog2e * (a.gate != nullptr && ok ? a.gate[bh * T_len + qrow[i]]
                                              : 1.f);
    brow[i] = BIAS && ok
        ? lr * PB + span_offset(bias + (size_t)qrow[i] * T_len) : lr * PB;
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
  }
  const float sc = a.scale * kLog2e;
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // Q and key tile 0 are in; the Q fragments stay in registers, or (f32
  // at D = 128) are read from sQ and split in every k-step of S
  cp_async_wait<0>();
  __syncthreads();
  typename Pol::A qa[Cfg::q_regs ? KD : 1];
  if constexpr (Cfg::q_regs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Pol::load_ak(qa[kk], sQ, P, r0, kk * Pol::KS);
  }

  const int n_kt = (kvl + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt > 0) {
      cp_async_wait<0>();
      __syncthreads();    // this tile is in; every warp is done with kt − 1
    }
    if (kt + 1 < n_kt) {
      stage(kt + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* tB = sB + buf * BQ * PB;

    float s[NJ][2][4];
    scores<Pol, D, NJ, Cfg::q_regs, Cfg::s_chunk>(s, qa, sQ, r0,
                                                 sK + buf * BK * P, P);

    // scale, gated bias and key mask in base 2; online softmax per row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = 16 * j + 8 * n + 2 * t4 + (e & 1);
          const float x = BIAS ? fmaf(s[j][n][e], sc,
                                      gl[i] * to_f(tB[brow[i] + col]))
                               : s[j][n][e] * sc;
          s[j][n][e] = k0 + col < kvl ? x : kNegInf;
          mx[i] = fmaxf(mx[i], s[j][n][e]);
        }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_row[i], quad_max(mx[i]));
      alpha[i] = exp2f(m_row[i] - m_new);
      m_row[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][n][e] - m_row[e >> 1]);
          ps[e >> 1] += p;
          s[j][n][e] = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + ps[i];
    // K6, after the row sum (l keeps the undropped sum)
    if constexpr (DROP) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qrow[e >> 1];
            const int kj = k0 + 16 * j + 8 * n + 2 * t4 + (e & 1);
            if (qi < T_len && kj < kvl)
              s[j][n][e] *= drop_keep(a.drop, dbase, qi, kj);
          }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P·V, P straight from the score registers, 16 keys at a time
    const T* tV = sV + buf * BK * P;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      accumulate_held<Pol, kNT, kInPlace>(o, s[j], tV, P, 16 * j);
  }

  // the row sum over the quad, the LSE and 1/l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l_row[i]), 1e-30f);
    if (a.lse != nullptr && t4 == 0 && qrow[i] < T_len)
      a.lse[bh * T_len + qrow[i]] = m_row[i] * kLn2 + logf(lc);
    const float inv = 1.f / lc;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      o[n][2 * i] *= inv;
      o[n][2 * i + 1] *= inv;
    }
  }
  store_acc<T, kNT>(a.out + base, o, q0 + r0, 0, kNT, kNT, T_len, D, 1.f);
}

template <class Pol, bool BIAS, bool DROP, int D>
cudaError_t run_fwd(const FwdBiasArgs<typename Pol::T>& a, int B,
                    cudaStream_t stream) {
  using Cfg = FwdBiasTiles<Pol, BIAS, D>;
  return wfl::launch(attn_bias_fwd_mma<Pol, BIAS, DROP, D>,
                     dim3(B, (a.T_len + Cfg::bq - 1) / Cfg::bq, a.H),
                     dim3(Cfg::threads), Cfg::smem, stream, a);
}

// The bias term only with a bias (at D = 64), the dropout hash only with a
// seed. The bias-free forward in bf16 is attention_wgmma.cu's (routes
// wgmma64 and wgmma128): it is not instantiated here.
template <class Pol, int D>
cudaError_t dispatch(const FwdBiasArgs<typename Pol::T>& a, int B,
                     cudaStream_t s) {
  if constexpr (D == kD) {
    if (a.bias != nullptr)
      return a.drop.seed ? run_fwd<Pol, true, true, D>(a, B, s)
                         : run_fwd<Pol, true, false, D>(a, B, s);
  }
  if constexpr (std::is_same_v<Pol, PolBF16>) {
    return cudaErrorInvalidValue;
  } else {
    return a.drop.seed ? run_fwd<Pol, false, true, D>(a, B, s)
                       : run_fwd<Pol, false, false, D>(a, B, s);
  }
}

template <class T>
cudaError_t dispatch_dtype(const void* q, const void* k, const void* v,
                           const void* bias, const void* gate,
                           const void* kv_len, void* out, void* lse, int B,
                           int H, int T_len, int D, float scale,
                           Dropout drop, cudaStream_t s) {
  const FwdBiasArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v),
                         static_cast<const T*>(bias),
                         static_cast<const float*>(gate),
                         static_cast<const int*>(kv_len),
                         static_cast<T*>(out), static_cast<float*>(lse), H,
                         T_len, scale, drop};
  using Pol = std::conditional_t<sizeof(T) == 4, PolF32, PolBF16>;
  return D == kD ? dispatch<Pol, kD>(a, B, s) : dispatch<Pol, kD128>(a, B, s);
}

}  // namespace

using namespace wfl;

// The forward at head_dim 64, and bias-free at 128 (wfl_flash_attention_fwd's
// arguments, which it shares): q, k, v, out [B, H, T, D] contiguous of the
// dtype (0 = f32 as 3×TF32, 1 = bf16), D = 64 or 128; bias [H, T, T] of the
// dtype, at any address (D = 64 only), or null for the bias-free forward;
// gate [B, H, T] f32 or null (read as 1; a gate without a bias is refused);
// kv_len [B] int32 in [1, T]; lse [B, H, T] f32, written when not null; seed
// (one int32 on the device, or null), drop_thr and drop_scale as the other
// forwards'. Refuses what forward_route does not send here: the bias-free
// forward in bf16 among it. Returns the launch's cudaError_t.
extern "C" int wfl_attention_fwd_bias_mma(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* gate,
                                          const void* kv_len, void* out,
                                          void* lse, const void* seed, int B,
                                          int H, int T_len, int D,
                                          float scale, int drop_thr,
                                          float drop_scale, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != kD && (D != kD128 || bias != nullptr)) ||
      (bias == nullptr && gate != nullptr))
    return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32)
    return dispatch_dtype<float>(q, k, v, bias, gate, kv_len, out, lse, B, H,
                                 T_len, D, scale, drop, s);
  if (dtype == kBF16)
    return dispatch_dtype<bf16>(q, k, v, bias, gate, kv_len, out, lse, B, H,
                                T_len, D, scale, drop, s);
  return cudaErrorInvalidValue;
}
