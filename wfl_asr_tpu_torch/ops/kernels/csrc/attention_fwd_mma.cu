// Forward of bias-free key-masked attention at head_dim > 128 (the
// Conformer's attention, head_dim 384 on the main path) on the tensor cores,
// for Hopper (sm_90a):
//
//   out[b,h,q,:] = softmax_k( (q·kᵀ)·scale, keys k >= kv_len[b] set to
//                             -1e30 ) · v
//
// and, when asked, the row logsumexp LSE = m + log(max(l, 1e-30)) that the
// backward (attention_bwd_mma.cu) reads.
//
// Replaces wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:_fwd_kernel (:49),
// the forward of flash_attention_trainable (K1). Calls with a bias, and
// bias-free widths ≤ 128, take the forwards of flash_attention.cu.
//
// What bounds it on the card: 2 products of 2·H·T·Σkv_len·D FLOPs (S = Q·Kᵀ,
// O = P·V; 4.2e10 at [8,2,1499,384]) against 4·B·H·T·D elements of bytes:
// operations, far above the ridge in both dtypes. The kernels this replaces
// kept the bf16 output accumulator in shared memory (WMMA, four round trips
// of the [64 × 384] tile a key tile) and ran f32 as FMA loops fed from
// shared memory.
//
// What this design does about it:
// - 16 warps, one block per (64-query tile, h, b): 384 blocks at the main
//   shape. The 64 × D f32 output accumulator stays in registers across the
//   key loop, split over the warps as 2 row groups × 8 column slices (at
//   D = 384 each warp owns 32 rows × 48 columns, 48 f32 a thread), as the
//   dQ pass of attention_bwd_mma.cu does.
// - Both products run on mma.sync with f32 accumulation through the operand
//   policies of attention_mma.cuh: bf16 m16n8k16 with ldmatrix operands; f32
//   as three TF32 m16n8k8 products of hi/lo-split operands (≈ 2⁻²² relative
//   a product, near f32).
// - S = Q·Kᵀ of a key tile (64 × BK) is SUBS sub-tiles of 16 × 16, each
//   sub-tile's contraction over D shared by PARTS = 16 / SUBS warps
//   (score_part); the partial sums meet in shared memory, and 8 threads a
//   query row add them in a fixed order, scale, mask keys ≥ kv_len to -1e30
//   before the row max, and keep the running max m and their share of the
//   row sum l (summed over the 8 at the end: the order is fixed, no
//   atomics). They write P once to shared memory (bf16: rounded to bf16, as
//   the JAX kernel's p.astype(v.dtype); f32: split once into TF32 hi and lo
//   halves, which every column slice then reads as they are) and the row's
//   rescale factor α, so each key tile costs three barriers, none per
//   product.
// - Each warp then takes acc = acc·α + P·V for its column slice with
//   ldmatrix.trans (bf16) or per-lane (f32) B fragments of V
//   (attention_mma.cuh's accumulate, P read as store2_split wrote it). f32
//   sums each k-step's product in fresh registers (the tensor core
//   truncates when it adds into a live accumulator) and folds α into the
//   first add; bf16 rescales acc and lets the mma add into it.
// - Staging: Q stays resident (64 × (D + 8) bf16, 50 KB at D = 384; f32 98
//   KB, so Q is split on every use: resident hi/lo halves would need 196
//   KB). K and V come in by 16-byte cp.async, double-buffered: 32 keys a
//   tile in bf16 (172 KB a block at D = 384), 16 in f32 (220 KB); f32 at
//   D > 384 keeps one buffer to fit 227 KB. A warp stages a row at a time,
//   its lanes on consecutive 16-byte chunks (attention_mma.cuh's
//   stage_rows_by_warp): handing the copies to the memory pipe stalls the
//   warps for a large share of a tile, and stage_rows, which divides by the
//   row length for every chunk, stalled them longer. Rows are pitched for the
//   widest D of the kernel's column group, so every offset of an unrolled
//   loop is an immediate.
// - Masking: key tiles wholly past kv_len[b] are skipped (key 0 is always
//   valid, kv_len ≥ 1); ragged tiles are zero-filled on load; query rows
//   past T are never stored.
// - Strict attention dropout (K6) as a DROP template flag: l sums the
//   undropped p, and wfl::drop_keep of the absolute (b, h, q, k) multiplies
//   P after the row sum and before P·V, bit for bit the JAX kernel's mask.
//
// What still bounds it (clock64 counters per phase, on the card): the
// barriers cost little; the staging's copies, then S. S is bound by
// shared-memory reads, as every warp loads both operands of its 16×16
// sub-tile (8 FLOP a byte, where the tensor cores need ≈ 32 a byte of the
// shared-memory rate). Q fragments held in registers have no room beside
// the 48 accumulators; wgmma on 64-row warpgroup tiles and TMA copies are
// the next step.
#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;                 // queries a block
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// Tiles. NPW, the 8-column output tiles a warp owns at most, is ⌈D/64⌉
// rounded to the group a kernel is compiled for (4: D ≤ 256, 6: ≤ 384, 8:
// ≤ 512). A key tile has BK keys (32 bf16, 16 f32), in two buffers but for
// f32 at D > 384. The S partial sums are [PARTS][BQ][SP] f32; P is [BQ][PP]
// (f32: hi in columns [0, BK), lo in [BK, 2·BK)); then α and 1/l of each
// row.
// ---------------------------------------------------------------------------

template <class Pol, int NPW>
struct FwdTiles {
  static constexpr bool kF32 = sizeof(typename Pol::T) == 4;
  static constexpr int es = sizeof(typename Pol::T);
  static constexpr int bk = kF32 ? 16 : 32;
  static constexpr int nbuf = kF32 && NPW > 6 ? 1 : 2;
  static constexpr int p = Pol::pitch(64 * NPW);          // Q, K, V rows
  static constexpr int subs = kBQ / 16 * (bk / 16);       // 16×16 sub-tiles
  static constexpr int parts = kWarps / subs;             // warps a sub-tile
  // partial sums: rows 8 floats more than a multiple of 32 apart in bf16
  // (conflict-free float2 stores); f32 has no room for the pad
  static constexpr int sp = bk + (kF32 ? 0 : 8);
  static constexpr int pp = Pol::pitch_s(kF32 ? 2 * bk : bk);
  static constexpr int kpt = bk / 8;                      // keys a thread
  static constexpr size_t smem =
      (size_t)es * (kBQ * p + 2 * nbuf * bk * p + kBQ * pp)
      + sizeof(float) * (parts * kBQ * sp + 2 * kBQ);
  static_assert(subs * parts == kWarps, "score sub-tiles split evenly");
  static_assert(kBQ * 8 == kThreads, "8 softmax threads a query row");
  static_assert(smem <= 232448, "forward tiles exceed 227 KB");
};

// The forward's arguments ([B, H, T, D] tensors, the key lengths, the LSE
// rows or null) as one kernel parameter.
template <class T>
struct FwdArgs {
  const T *q, *k, *v;
  const int* kv_len;
  T* out;
  float* lse;
  int H, T_len, D;
  float scale;
  Dropout drop;
};

// ---------------------------------------------------------------------------
// Block (query tile, h, b). Warp w computes part w / SUBS of score sub-tile
// w % SUBS, then owns queries 32·(w % 2) (two row tiles, which share each V
// fragment) and the column slice w / 2 of the output across the key tiles.
// Thread i runs the softmax of query row i / 8, keys KPT·(i % 8) + [0, KPT)
// of each tile.
// ---------------------------------------------------------------------------

template <class Pol, int NPW, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_mma(const FwdArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = FwdTiles<Pol, NPW>;
  constexpr int BK = Cfg::bk, NBUF = Cfg::nbuf, P = Cfg::p, PP = Cfg::pp;
  constexpr int SP = Cfg::sp, KPT = Cfg::kpt, SUBS = Cfg::subs;
  constexpr int PARTS = Cfg::parts, NC = BK / 16;
  constexpr int MT = kBQ / 32;      // row tiles a warp: 2 row groups of warps
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [BQ][P]
  T* sK = sQ + kBQ * P;                           // [NBUF][BK][P]
  T* sV = sK + NBUF * BK * P;                     // [NBUF][BK][P]
  T* sP = sV + NBUF * BK * P;                     // [BQ][PP]
  float* sPart = reinterpret_cast<float*>(sP + kBQ * PP);  // [PARTS][BQ][SP]
  float* sAlpha = sPart + PARTS * kBQ * SP;       // [BQ]
  float* sInv = sAlpha + kBQ;                     // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)b * a.H + h;
  const size_t base = bh * T_len * D;
  const T* __restrict__ k = a.k + base;
  const T* __restrict__ v = a.v + base;
  const int kvl = a.kv_len[b];
  const float scale = a.scale;
  const Dropout drop = a.drop;
  const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;

  auto stage = [&](int kt, int buf) {
    stage_rows_by_warp<Pol, kWarps>(sK + buf * BK * P, P, k, kt * BK, BK,
                                    T_len, D);
    stage_rows_by_warp<Pol, kWarps>(sV + buf * BK * P, P, v, kt * BK, BK,
                                    T_len, D);
  };
  stage_rows_by_warp<Pol, kWarps>(sQ, P, a.q + base, q0, kBQ, T_len, D);
  stage(0, 0);
  cp_async_commit();

  // S: this warp's sub-tile (rows sr0, keys sc0 of the tile) and its part of
  // the contraction over D
  const int sub = warp % SUBS, part = warp / SUBS;
  const int sr0 = (sub / NC) * 16, sc0 = (sub % NC) * 16;
  const int per = ((D + PARTS - 1) / PARTS + Pol::KS - 1) / Pol::KS * Pol::KS;
  const int kbeg = part * per, kend = min(D, kbeg + per);
  float* sMine = sPart + part * kBQ * SP;
  // softmax: this thread's row and keys
  const int srow = tid >> 3, skey = (tid & 7) * KPT, qi = q0 + srow;
  float m_run = kNegInf, l_run = 0.f;
  // P·V: this warp's rows and column slice
  const int ar0 = (warp % 2) * 16 * MT;
  const int NT = D / 8;
  const int npw = cols_per_warp(NT, kWarps / 2), nt0 = (warp / 2) * npw;
  float acc[MT][NPW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int n_kt = (kvl + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = NBUF == 2 ? (kt & 1) : 0;
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();    // this tile is in; every warp is done with kt − 1
    if (NBUF == 2 && kt + 1 < n_kt) {
      stage(kt + 1, buf ^ 1);
      cp_async_commit();
    }
    const T* tV = sV + buf * BK * P;

    // this warp's partial sums of a 16×16 sub-tile of S = Q·Kᵀ
    {
      float x[2][4];
      score_part<Pol>(x, sQ, sK + buf * BK * P, P, sr0, sc0, kbeg, kend);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(sMine + (sr0 + g + 8 * i) * SP + sc0
                                     + 8 * n + 2 * t4) =
              make_float2(x[n][2 * i], x[n][2 * i + 1]);
    }
    __syncthreads();

    // online softmax of row srow over keys k0 + skey + [0, KPT)
    {
      float s[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt)
#pragma unroll
        for (int i = 0; i < KPT; ++i)
          s[i] += sPart[(pt * kBQ + srow) * SP + skey + i];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        s[i] = k0 + skey + i < kvl ? s[i] * scale : kNegInf;
        mx = fmaxf(mx, s[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        s[i] = expf(s[i] - m_new);
        ps += s[i];
      }
      l_run = l_run * alpha + ps;
      m_run = m_new;
      // K6: l keeps the undropped sum, only P·V takes the mask
      if constexpr (DROP) {
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int kj = k0 + skey + i;
          if (qi < T_len && kj < kvl) s[i] *= drop_keep(drop, dbase, qi, kj);
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; i += 2)
        Pol::template store2_split<BK>(sP, PP, srow, skey + i, s[i],
                                       s[i + 1]);
      if ((tid & 7) == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // acc = acc·α + P·V for this warp's rows and column slice
    {
      float alpha[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          alpha[m][i] = sAlpha[ar0 + 16 * m + g + 8 * i];
      accumulate<Pol, NPW, BK, MT, BK, true>(acc, sP, PP, ar0, tV, P, nt0,
                                             npw, NT, alpha);
    }
    if (NBUF == 1) {
      __syncthreads();    // every warp is done with this tile's buffer
      if (kt + 1 < n_kt) {
        stage(kt + 1, 0);
        cp_async_commit();
      }
    }
  }

  // the row sum over the row's 8 threads, the LSE and 1/l
  {
    float l = l_run;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float lc = fmaxf(l, 1e-30f);
    if ((tid & 7) == 0) {
      sInv[srow] = 1.f / lc;
      if (a.lse != nullptr && qi < T_len)
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
    store_acc<T, NPW>(a.out + base, acc[m], q0 + r0, nt0, npw, NT, T_len, D,
                      1.f);
  }
}

template <class Pol, int NPW, bool DROP>
cudaError_t run_fwd(const FwdArgs<typename Pol::T>& a, int B,
                    cudaStream_t stream) {
  return wfl::launch(attn_fwd_mma<Pol, NPW, DROP>,
                     dim3((a.T_len + kBQ - 1) / kBQ, a.H, B), dim3(kThreads),
                     FwdTiles<Pol, NPW>::smem, stream, a);
}

// The column group by D, and the dropout hash only with a seed.
template <class Pol>
cudaError_t dispatch(const FwdArgs<typename Pol::T>& a, int B,
                     cudaStream_t s) {
#define WFL_FWD(npw)                                          \
  return a.drop.seed ? run_fwd<Pol, npw, true>(a, B, s)       \
                     : run_fwd<Pol, npw, false>(a, B, s)
  if (a.D <= 256) WFL_FWD(4);
  if (a.D <= 384) WFL_FWD(6);
  WFL_FWD(8);
#undef WFL_FWD
}

template <class T>
cudaError_t dispatch_dtype(const void* q, const void* k, const void* v,
                           const void* kv_len, void* out, void* lse, int B,
                           int H, int T_len, int D, float scale,
                           Dropout drop, cudaStream_t s) {
  const FwdArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v),
                     static_cast<const int*>(kv_len), static_cast<T*>(out),
                     static_cast<float*>(lse), H, T_len, D, scale, drop};
  if constexpr (sizeof(T) == 4) return dispatch<PolF32>(a, B, s);
  else return dispatch<PolBF16>(a, B, s);
}

}  // namespace

using namespace wfl;

// The bias-free forward (wfl_flash_attention_fwd's arguments, which it
// shares): q, k, v, out [B, H, T, D] contiguous of the dtype (0 = f32 as
// 3×TF32, 1 = bf16), D a multiple of 16 in (128, 512]; bias and gate must
// be null (a call with a bias is refused); kv_len [B] int32 in [1, T]; lse
// [B, H, T] f32, written when not null; seed (one int32 on the device, or
// null), drop_thr and drop_scale as the other forwards'. Returns the
// launch's cudaError_t.
extern "C" int wfl_attention_fwd_mma(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* gate, const void* kv_len,
                                     void* out, void* lse, const void* seed,
                                     int B, int H, int T_len, int D,
                                     float scale, int drop_thr,
                                     float drop_scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr || gate != nullptr) return cudaErrorInvalidValue;
  if (D % 16 != 0 || D <= 128 || D > 512) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32)
    return dispatch_dtype<float>(q, k, v, kv_len, out, lse, B, H, T_len, D,
                                 scale, drop, s);
  if (dtype == kBF16)
    return dispatch_dtype<bf16>(q, k, v, kv_len, out, lse, B, H, T_len, D,
                                scale, drop, s);
  return cudaErrorInvalidValue;
}
