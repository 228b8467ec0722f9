// Bias-free key-masked attention in bf16 on Hopper's warpgroup products
// (wgmma) fed by the Tensor Memory Accelerator (TMA), sm_90a: the forward
// and the dK/dV pass of the backward, at head widths up to 64 (route
// wgmma64: Whisper's layers, the `none` encoder's Conformer) and 80-128
// (route wgmma128: a Conformer of hidden 512 under 4 heads, Whisper-base's
// at the config schema's default):
//
//   out[b,h,q,:] = softmax_k( (q·kᵀ)·scale, keys k >= kv_len[b] at -1e30 ) · v
//
// with the row logsumexp LSE (natural log) when asked, strict attention
// dropout (K6) as a template flag, and of the backward dK, dV and dS (the
// workspace the dQ pass of attention_bwd_bias_mma.cu reads), after a
// pre-pass that forms delta = rowsum(dO·O).
//
// Replaces wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:_fwd_kernel (:49,
// pallas_call :244) (K1) and _bwd_dkdv_kernel (:106, pallas_call :401) (K1b;
// its _bwd_dq_kernel, :171, stays with attn_bias_bwd_dq_mma) in bf16 at
// head_dim ≤ 128. f32 keeps the mma.sync routes mma64 and mma128 of
// attention_{fwd,bwd}_bias_mma.cu.
//
// What bounds it on the card: the forward's 2 products of 2·H·T·Σkv_len·D
// FLOPs (S = Q·Kᵀ, O = P·V; 0.0373 ms at 989 TFLOP/s at [8, 8, 1500, 64]
// and [8, 4, 1500, 128]) against Q, K, V and O read or written once (0.015
// ms at 3.35 TB/s): operations. The dK/dV pass does 4 of the backward's 5
// products (Sᵀ, dPᵀ, dV, dK) and writes the dS workspace. The mma.sync
// kernels this replaces ran 5.3× their bound in the forward, with a third
// of the key loop spent issuing the next tile's 16-byte cp.async copies in
// every thread, S as a chain of 8 m16n8k16 steps at D = 128, and a dK/dV
// pass in which each warp read its Q and dO fragments from shared memory
// for every product.
//
// What this design does about it:
// - Warp roles. A CTA is one producer warp group and one or two consumer
//   warp groups. One thread of the producer issues TMA loads of whole tiles
//   (3-D tensor maps (D, T, B·H) over [B, H, T, D], hopper.cuh: make_map)
//   into a ring of shared-memory stages with a full and an empty mbarrier
//   each; the consumers run the products on wgmma and release a stage by
//   arriving on its empty barrier. The producer gives its registers to the
//   consumers (setmaxnreg) where a SM holds more than 256 threads of CTAs.
// - Tiles. 128-byte swizzled rows of 64 bf16: a row of 128 columns is two
//   boxes. A map is made at the tensor's own width (any multiple of 16 up
//   to 64 or 128): the TMA fills the columns past it with zeros, which add
//   nothing to q·kᵀ, and the rows past T (of this matrix, never another
//   head's) with zeros. So nothing is padded on the host.
// - Forward (attn_wg_fwd): a consumer group owns 64 query rows (Q loaded
//   once), a stage holds 128 keys of K and V, two stages. S = Q·Kᵀ is an SS
//   product (both K-major from shared memory) into m64n128 f32
//   accumulators; the online softmax runs in base 2 on them (log2(e)
//   folded into the scale),
//   each thread's rows following the m64nN accumulator layout (the m16n8
//   layout of mma.sync, repeated): rows g and g + 8 of its warp's 16,
//   reduced over the quad. Keys past kv_len are set to -1e30 before the row
//   max; key tiles wholly past it are never loaded. P is re-packed from the
//   accumulators into bf16 A fragments and O += P·V is an RS product with V
//   read [keys × D] as an MN-major B (the transpose bit). K6: wfl::drop_keep
//   of the absolute (b, h, q, k) multiplies P after the row sum, before P·V.
//   At D = 64 one consumer group (64 queries) a CTA and 2 CTAs a SM; at
//   D = 128 two groups (128 queries) a CTA and 1 CTA a SM (kFwdGroups*).
// - dK/dV pass (attn_wg_dkdv): a consumer group owns 64 keys, whose K and V
//   stay in shared memory; the producer streams 64-query tiles of Q and dO
//   by TMA and their rows of LSE·log2(e) and delta by bulk copies. Sᵀ = K·Qᵀ
//   and dPᵀ = V·dOᵀ are SS products; P = exp2(Sᵀ·scale·log2(e) − LSE₂),
//   P·M and dS = P·(M·dP − delta) are formed in registers (keys past kv_len
//   give P = 0, query rows past T an LSE of 1e30 and so P = 0), and
//   dV += (P·M)·dO and dK += dS·Q are RS products with dO and Q as MN-major
//   B. dS goes to the workspace [B, H, T, ldk] transposed to [q, k] through
//   a shared staging tile of the group, as 16-byte stores. Each gradient is
//   written by one CTA, with no atomics.
// - The pre-pass (attn_wg_delta) reads O and dO once: delta = rowsum(dO·O)
//   in f32, and LSE·log2(e), into rows padded to a multiple of 64 (whose
//   starts the bulk copies need 16-byte aligned, whatever T is).
// - O, dK and dV are stored from the accumulators as bf16 pairs, columns
//   past the tensor's width and rows past T not at all.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace wfl;
using namespace wfl::hopper;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kPadLse = 1e30f;   // LSE₂ of a padded query row: P = 0
constexpr int kBoxBytes = 128;     // a swizzled row: 64 bf16
constexpr int kRowPad = 64;        // the pre-pass's rows, padded to this
// consumer warp groups a forward CTA (64 queries each), by head width: at
// D = 64 one, 2 CTAs a SM (8 % faster than 2 groups and 1 CTA a SM at
// [8, 8, 1500, 64] and at [8, 2, 1500, 48], kernel_variants_ab.py --kernel
// wg); at D = 128 two (Q and two stages of K and V leave room for 1 CTA)
constexpr int kFwdGroups64 = 1;
constexpr int kFwdGroups128 = 2;
// consumer warp groups a dK/dV CTA (64 keys each), by head width
constexpr int kBwdGroups64 = 2;
constexpr int kBwdGroups128 = 2;

// The CTA's threads, the CTAs a SM its launch bounds name, and the
// registers a thread of the producer and of a consumer group hold after
// reallocation (none where a SM holds at most 256 threads of CTAs: each
// thread keeps the 255 registers the launch bounds allow).
template <int NWG, int MIN_BLOCKS>
struct Roles {
  static constexpr int threads = 128 * (NWG + 1);
  static constexpr int min_blocks = MIN_BLOCKS;
  static constexpr bool rebalance = threads * MIN_BLOCKS > 256;
  static constexpr int regs_base = 65536 / (threads * MIN_BLOCKS) / 8 * 8;
  static constexpr int regs_producer = 40;
  static constexpr int regs_consumer =
      (regs_base * threads - 128 * regs_producer) / (128 * NWG) / 8 * 8;
  static_assert(!rebalance || regs_consumer <= 256, "setmaxnreg caps at 256");
};

// The forward's tiles: D/64 column blocks, 64 queries a consumer group,
// 128 keys a stage, two stages; Q, the ring of K and V, then the barriers
// (full and empty a stage, and Q's), in a base aligned to 1024 bytes.
template <int D, int NWG>
struct FwdTiles : Roles<NWG, NWG == 1 ? 2 : 1> {
  static constexpr int nb = D / 64;
  static constexpr int bq = 64 * NWG;
  static constexpr int bk = 128;
  static constexpr int stages = 2;
  static constexpr int q_bytes = nb * bq * kBoxBytes;
  static constexpr int kv_bytes = nb * bk * kBoxBytes;   // K or V, a stage
  static constexpr int bar_off = q_bytes + 2 * stages * kv_bytes;
  static constexpr size_t smem = bar_off + 8 * (2 * stages + 1) + 1024;
  static_assert(D == 64 || D == 128, "head widths 64 and 128");
  static_assert(bk % 16 == 0 && bk <= 256, "a TMA box holds ≤ 256 rows");
  // 227 KB a block, 228 KB a SM with 1 KB reserved a block
  static_assert(smem <= 232448, "forward tiles exceed 227 KB");
  static_assert((NWG == 1 ? 2 : 1) * (smem + 1024) <= 233472,
                "forward CTAs a SM exceed its shared memory");
};

// The dK/dV pass's tiles: 64 keys a consumer group (K and V resident), 64
// queries a stage, two stages of Q, dO and their LSE₂ and delta rows, then
// each group's dS staging tile (64 queries × 64 keys, pitch kStPitch), then
// the barriers (K/V's, full and empty a stage). 1 CTA a SM.
constexpr int kStPitch = 72;       // 144-byte rows: 16-byte aligned
template <int D, int NWG>
struct BwdTiles : Roles<NWG, 1> {
  static constexpr int nb = D / 64;
  static constexpr int bk = 64 * NWG;
  static constexpr int bq = 64;
  static constexpr int stages = 2;
  static constexpr int kv_bytes = nb * bk * kBoxBytes;   // K or V
  static constexpr int q_bytes = nb * bq * kBoxBytes;    // Q or dO, a stage
  // LSE₂ and delta (2 · 64 floats), padded so that stages stay aligned
  static constexpr int stat_bytes = 1024;
  static constexpr int stage_bytes = 2 * q_bytes + stat_bytes;
  static constexpr int st_off = 2 * kv_bytes + stages * stage_bytes;
  static constexpr int st_bytes = bq * kStPitch * 2;
  static constexpr int bar_off = st_off + NWG * st_bytes;
  static constexpr size_t smem = bar_off + 8 * (2 * stages + 1) + 1024;
  static_assert(D == 64 || D == 128, "head widths 64 and 128");
  static_assert(q_bytes % 1024 == 0 && stage_bytes % 1024 == 0,
                "swizzled tiles start on 1024 bytes");
  static_assert(smem <= 232448, "dK/dV tiles exceed 227 KB");
};

// The forward's arguments (one kernel parameter, the tensor maps in it):
// maps of q, k, v at the true width d; out [B, H, T, d] bf16; lse [B, H, T]
// f32 or null; kv_len [B] int32 in [1, T].
struct WgFwdArgs {
  CUtensorMap q, k, v;
  bf16* out;
  float* lse;
  const int* kv_len;
  int H, T_len, d;
  float scale;
  Dropout drop;
};

// The dK/dV pass's arguments: maps of q, k, v and dO at the true width d;
// the pre-pass's rows (lse2, delta: [B·H, Tp] f32, Tp = T rounded up to
// kRowPad); dk, dv [B, H, T, d] bf16; ds [B, H, T, ldk] bf16.
struct WgBwdArgs {
  CUtensorMap q, k, v, dout;
  const float *lse2, *delta;
  const int* kv_len;
  bf16 *dk, *dv, *ds;
  int H, T_len, Tp, d, ldk;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = saddr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else wgmma_rs_n128(d, a, b, scale_d);
}

// keep A fragments in their registers until the products that read them
// have completed (after wg_wait)
template <int M>
__device__ __forceinline__ void frag_fence(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]) :: "memory");
}

// acc (rows row0 + g, row0 + g + 8 of the warp, m64nD layout) times mul as
// bf16 pairs into a [T, d] matrix; columns ≥ d and rows ≥ T not stored
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           int row0, int T_len, int d,
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    if (c >= d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r < T_len)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * d + c) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * mul,
                                  acc[4 * n + 2 * i + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: CTA (query tile of 64·NWG, b·H + h). Warp group 0 produces;
// consumer group w owns queries 64·w of the tile, its warp 16 of them.
// ---------------------------------------------------------------------------

template <int D, int NWG, bool DROP>
__global__ void __launch_bounds__(FwdTiles<D, NWG>::threads,
                                  FwdTiles<D, NWG>::min_blocks)
attn_wg_fwd(const __grid_constant__ WgFwdArgs a) {
  using Cfg = FwdTiles<D, NWG>;
  constexpr int NB = Cfg::nb, BQ = Cfg::bq, BK = Cfg::bk, ST = Cfg::stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;                        // [NB][BQ] rows
  unsigned char* sK = sQ + Cfg::q_bytes;           // [ST][NB][BK] rows
  unsigned char* sV = sK + ST * Cfg::kv_bytes;     // [ST][NB][BK] rows
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::bar_off);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int kvl = a.kv_len[b];
  const int n_kt = (kvl + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {              // the producer: one thread issues every load
    if constexpr (Cfg::rebalance) regs_dec<Cfg::regs_producer>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qbar, Cfg::q_bytes);
      for (int c = 0; c < NB; ++c)
        for (int w = 0; w < NWG; ++w)
          tma_load(sQ + (c * BQ + 64 * w) * kBoxBytes, &a.q, 64 * c,
                   q0 + 64 * w, bh, qbar);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % ST;
        mbar_wait(&empty[s], ((kt / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * Cfg::kv_bytes);
        for (int c = 0; c < NB; ++c) {
          tma_load(sK + s * Cfg::kv_bytes + c * BK * kBoxBytes, &a.k, 64 * c,
                   kt * BK, bh, &full[s]);
          tma_load(sV + s * Cfg::kv_bytes + c * BK * kBoxBytes, &a.v, 64 * c,
                   kt * BK, bh, &full[s]);
        }
      }
    }
    return;
  }

  if constexpr (Cfg::rebalance) regs_inc<Cfg::regs_consumer>();
  const int w = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 64 * w + 16 * warp;     // the warp's first query
  const float sc = a.scale * kLog2e;
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;
  const uint32_t q_addr = saddr(sQ) + 64 * w * kBoxBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % ST, k0 = kt * BK;
    mbar_wait(&full[s], (kt / ST) & 1);
    const uint32_t k_addr = saddr(sK) + s * Cfg::kv_bytes;
    const uint32_t v_addr = saddr(sV) + s * Cfg::kv_bytes;

    // S = Q·Kᵀ: k-step kk reads 16 columns, 32 bytes into column block kk/4
    float sacc[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss<BK>(sacc,
                   desc(q_addr + (kk >> 2) * BQ * kBoxBytes + off, 16, 1024),
                   desc(k_addr + (kk >> 2) * BK * kBoxBytes + off, 16, 1024),
                   kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(sacc);

    // scale and key mask in base 2; online softmax over this thread's rows
    // g (element i with bit 1 clear) and g + 8
    float mx[2] = {kNegInf, kNegInf};
    const bool ragged = k0 + BK > kvl;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = sacc[i] * sc;
      if (ragged && col >= kvl) x = kNegInf;
      sacc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_row[r], quad_max(mx[r]));
      alpha[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = exp2f(sacc[i] - m_row[(i >> 1) & 1]);
      ps[(i >> 1) & 1] += p;
      sacc[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + ps[r];
    // K6, after the row sum (l keeps the undropped sum)
    if constexpr (DROP) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int qi = row0 + g + 8 * ((i >> 1) & 1);
        const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (qi < a.T_len && kj < kvl)
          sacc[i] *= drop_keep(a.drop, dbase, qi, kj);
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P·V: P's bf16 A fragments, 16 keys a k-step, V's rows 16 keys
    // (2048 bytes) a k-step on, its column blocks BK rows apart
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) a_frag(pa[j], sacc, j);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_rs<D>(o, pa[j], desc(v_addr + j * 16 * kBoxBytes,
                                 BK * kBoxBytes, 1024), 1);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    frag_fence(pa);
    mbar_arrive(&empty[s]);
  }

  // the row sums over the quad, the LSE and 1/l
  const size_t row_base = (size_t)bh * a.T_len;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(quad_sum(l_row[r]), 1e-30f);
    const int qi = row0 + g + 8 * r;
    if (a.lse != nullptr && t4 == 0 && qi < a.T_len)
      a.lse[row_base + qi] = m_row[r] * kLn2 + logf(lc);
    inv[r] = 1.f / lc;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_rows<D>(a.out + row_base * a.d, o, row0, a.T_len, a.d, 1.f);
}

// ---------------------------------------------------------------------------
// Pre-pass: delta = rowsum(dO·O) and LSE₂ = LSE·log2(e) into [B·H, Tp] rows
// (0 and 1e30 on the padded rows). LANES (16) lanes a row, 8 elements a
// lane: a row of up to 128.
// ---------------------------------------------------------------------------

template <int LANES>
__global__ void __launch_bounds__(256)
attn_wg_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ lse2,
              float* __restrict__ delta, int rows, int T_len, int Tp, int d) {
  static_assert(LANES == 16, "the reduction below spans 16 lanes");
  const int row = blockIdx.x * (256 / LANES) + threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const int bh = row / Tp, t = row - bh * Tp;
  const bool live = row < rows && t < T_len;
  float acc = 0.f;
  if (live && 8 * sub < d) {
    const size_t at = ((size_t)bh * T_len + t) * d + 8 * sub;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(op[e]);
      const float2 y = __bfloat1622float2(dp[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < rows) {
    delta[row] = live ? acc : 0.f;
    lse2[row] = live ? lse[(size_t)bh * T_len + t] * kLog2e : kPadLse;
  }
}

// ---------------------------------------------------------------------------
// dK/dV pass: CTA (key tile of 64·NWG, b·H + h). Warp group 0 produces;
// consumer group w owns keys 64·w of the tile, its warp 16 of them, and
// stores their dS. Rows of the transposed score tiles are keys, columns
// queries.
// ---------------------------------------------------------------------------

template <int D, int NWG, bool DROP>
__global__ void __launch_bounds__(BwdTiles<D, NWG>::threads,
                                  BwdTiles<D, NWG>::min_blocks)
attn_wg_dkdv(const __grid_constant__ WgBwdArgs a) {
  using Cfg = BwdTiles<D, NWG>;
  constexpr int NB = Cfg::nb, BK = Cfg::bk, BQ = Cfg::bq, ST = Cfg::stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sK = smem;                          // [NB][BK] rows
  unsigned char* sV = sK + Cfg::kv_bytes;            // [NB][BK] rows
  unsigned char* sStage = sV + Cfg::kv_bytes;        // [ST] × (Q, dO, stats)
  bf16* sSt = reinterpret_cast<bf16*>(smem + Cfg::st_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::bar_off);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int k0 = blockIdx.x * BK, bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int T_len = a.T_len, d = a.d;
  const int kvl = a.kv_len[b];
  const size_t row_base = (size_t)bh * T_len;
  if (k0 >= kvl) {      // no query attends these keys: zero gradients
    const int rows = min(BK, T_len - k0);
    for (int i = threadIdx.x; i < rows * d; i += Cfg::threads) {
      a.dk[(row_base + k0) * d + i] = __float2bfloat16(0.f);
      a.dv[(row_base + k0) * d + i] = __float2bfloat16(0.f);
    }
    return;
  }
  const int n_qt = (T_len + BQ - 1) / BQ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {              // the producer: one thread issues every load
    if constexpr (Cfg::rebalance) regs_dec<Cfg::regs_producer>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(kvbar, 2 * Cfg::kv_bytes);
      for (int c = 0; c < NB; ++c)
        for (int w = 0; w < NWG; ++w) {
          tma_load(sK + (c * BK + 64 * w) * kBoxBytes, &a.k, 64 * c,
                   k0 + 64 * w, bh, kvbar);
          tma_load(sV + (c * BK + 64 * w) * kBoxBytes, &a.v, 64 * c,
                   k0 + 64 * w, bh, kvbar);
        }
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % ST;
        unsigned char* st = sStage + s * Cfg::stage_bytes;
        mbar_wait(&empty[s], ((qt / ST) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * Cfg::q_bytes + 2 * BQ * 4);
        for (int c = 0; c < NB; ++c) {
          tma_load(st + c * BQ * kBoxBytes, &a.q, 64 * c, qt * BQ, bh,
                   &full[s]);
          tma_load(st + Cfg::q_bytes + c * BQ * kBoxBytes, &a.dout, 64 * c,
                   qt * BQ, bh, &full[s]);
        }
        const size_t row = (size_t)bh * a.Tp + qt * BQ;
        bulk_load(st + 2 * Cfg::q_bytes, a.lse2 + row, BQ * 4, &full[s]);
        bulk_load(st + 2 * Cfg::q_bytes + BQ * 4, a.delta + row, BQ * 4,
                  &full[s]);
      }
    }
    return;
  }

  if constexpr (Cfg::rebalance) regs_inc<Cfg::regs_consumer>();
  const int w = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + 64 * w + 16 * warp;      // the warp's first key
  const int kj[2] = {key0 + g, key0 + g + 8};
  const float sc = a.scale * kLog2e;
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;
  const uint32_t k_addr = saddr(sK) + 64 * w * kBoxBytes;
  const uint32_t v_addr = saddr(sV) + 64 * w * kBoxBytes;
  bf16* stg = sSt + w * BQ * kStPitch;           // [query][key] of the group
  bf16* ds = a.ds + row_base * a.ldk + k0 + 64 * w;
  const bool group_live = k0 + 64 * w < kvl;     // then k0 + 64w + 64 ≤ ldk

  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt % ST, q0 = qt * BQ;
    mbar_wait(&full[s], (qt / ST) & 1);
    const unsigned char* st = sStage + s * Cfg::stage_bytes;
    const uint32_t q_addr = saddr(st), do_addr = q_addr + Cfg::q_bytes;
    const float* sL = reinterpret_cast<const float*>(st + 2 * Cfg::q_bytes);
    const float* sDl = sL + BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, both K-major, 16 columns of D a k-step
    float sacc[BQ / 2], dp[BQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint32_t kb = (kk >> 2) * BK * kBoxBytes + off;
      const uint32_t qb = (kk >> 2) * BQ * kBoxBytes + off;
      wgmma_ss<BQ>(sacc, desc(k_addr + kb, 16, 1024),
                   desc(q_addr + qb, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint32_t kb = (kk >> 2) * BK * kBoxBytes + off;
      const uint32_t qb = (kk >> 2) * BQ * kBoxBytes + off;
      wgmma_ss<BQ>(dp, desc(v_addr + kb, 16, 1024),
                   desc(do_addr + qb, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(sacc);
    reg_fence(dp);

    // P = exp2(S·scale·log2e − LSE₂) (0 past kv_len and past T), K6's
    // P·M, dS = P·(M·dP − delta); dS staged transposed, as [query][key]
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int ql = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int r = (i >> 1) & 1;
      const float p = kj[r] < kvl ? exp2f(sacc[i] * sc - sL[ql]) : 0.f;
      float ks = 1.f;
      if constexpr (DROP) {
        if (q0 + ql < T_len && kj[r] < kvl)
          ks = drop_keep(a.drop, dbase, q0 + ql, kj[r]);
      }
      sacc[i] = p * ks;
      dp[i] = p * (dp[i] * ks - sDl[ql]);
      stg[ql * kStPitch + 16 * warp + g + 8 * r] = __float2bfloat16(dp[i]);
    }

    // dV += (P·M)·dO, dK += dS·Q: 16 queries (2048 bytes of rows) a k-step,
    // the column blocks BQ rows apart
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      a_frag(pa[j], sacc, j);
      a_frag(sa[j], dp, j);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
      wgmma_rs<D>(dv, pa[j], desc(do_addr + j * 16 * kBoxBytes,
                                  BQ * kBoxBytes, 1024), 1);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
      wgmma_rs<D>(dk, sa[j], desc(q_addr + j * 16 * kBoxBytes,
                                  BQ * kBoxBytes, 1024), 1);
    wg_commit();

    // dS of the group's 64 keys for the tile's queries, 16 bytes a store.
    // A group whose keys all lie past kv_len stores nothing: the dQ pass
    // reads no such tile, and where ⌈T/64⌉ is odd its keys would start at
    // ldk, on the next query row's.
    named_sync(1 + w, 128);
#pragma unroll
    for (int i = tid; i < BQ * 8; i += 128) {
      const int ql = i >> 3, c = (i & 7) * 8;
      if (group_live && q0 + ql < T_len)
        *reinterpret_cast<uint4*>(ds + (size_t)(q0 + ql) * a.ldk + c) =
            *reinterpret_cast<const uint4*>(stg + ql * kStPitch + c);
    }
    wg_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    frag_fence(pa);
    frag_fence(sa);
    named_sync(1 + w, 128);    // the staging tile is read: free for the next
    mbar_arrive(&empty[s]);
  }
  store_rows<D>(a.dv + row_base * d, dv, key0, T_len, d, 1.f);
  store_rows<D>(a.dk + row_base * d, dk, key0, T_len, d, a.scale);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D, int NWG>
cudaError_t run_fwd(WgFwdArgs& a, int BH, cudaStream_t s) {
  using Cfg = FwdTiles<D, NWG>;
  const dim3 grid((a.T_len + Cfg::bq - 1) / Cfg::bq, BH);
  return a.drop.seed
      ? wfl::launch(attn_wg_fwd<D, NWG, true>, grid, dim3(Cfg::threads),
                    Cfg::smem, s, a)
      : wfl::launch(attn_wg_fwd<D, NWG, false>, grid, dim3(Cfg::threads),
                    Cfg::smem, s, a);
}

template <int D, int NWG>
cudaError_t run_dkdv(WgBwdArgs& a, int BH, cudaStream_t s) {
  using Cfg = BwdTiles<D, NWG>;
  const dim3 grid((a.T_len + Cfg::bk - 1) / Cfg::bk, BH);
  return a.drop.seed
      ? wfl::launch(attn_wg_dkdv<D, NWG, true>, grid, dim3(Cfg::threads),
                    Cfg::smem, s, a)
      : wfl::launch(attn_wg_dkdv<D, NWG, false>, grid, dim3(Cfg::threads),
                    Cfg::smem, s, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the head width a route takes, and a true width within it
bool widths_ok(int d, int width) {
  return (width == 64 || width == 128) && d > 0 && d % 16 == 0 && d <= width;
}

}  // namespace

using namespace wfl;

// The bias-free bf16 forward (routes wgmma64 and wgmma128): q, k, v, out
// [B, H, T, d] bf16 contiguous and 16-byte aligned, d a multiple of 16 up
// to `width` (64 or 128, the instantiation); kv_len [B] int32 in [1, T];
// lse [B, H, T] f32, written when not null; seed (one int32 on the device,
// or null), drop_thr and drop_scale as the other forwards'. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for what it does not take, or
// where a tensor map is refused).
extern "C" int wfl_attention_wgmma_fwd(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, void* lse, const void* seed,
                                       int B, int H, int T_len, int d,
                                       int width, float scale, int drop_thr,
                                       float drop_scale, void* stream) {
  if (!widths_ok(d, width) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out) || T_len < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  WgFwdArgs a{};
  if (!make_map(&a.q, q, d, T_len, BH, d, 64) ||
      !make_map(&a.k, k, d, T_len, BH, d, FwdTiles<64, 2>::bk) ||
      !make_map(&a.v, v, d, T_len, BH, d, FwdTiles<64, 2>::bk))
    return cudaErrorInvalidValue;
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.kv_len = static_cast<const int*>(kv_len);
  a.H = H;
  a.T_len = T_len;
  a.d = d;
  a.scale = scale;
  a.drop = Dropout{static_cast<const int*>(seed), drop_thr, drop_scale};
  return width == 128 ? run_fwd<128, kFwdGroups128>(a, BH, s)
                      : run_fwd<64, kFwdGroups64>(a, BH, s);
}

// The backward's pre-pass: out, dout [B, H, T, d] bf16 (16-byte aligned, d
// a multiple of 16 up to 128), lse [B, H, T] f32 (the forward's); ws a
// workspace [2, B·H, Tp] f32, Tp = T rounded up to 64: LSE·log2(e) in its
// first half and delta = rowsum(dO·O) in its second, every row written.
extern "C" int wfl_attention_wgmma_delta(const void* out, const void* dout,
                                         const void* lse, void* ws, int B,
                                         int H, int T_len, int d,
                                         void* stream) {
  if (!widths_ok(d, 128) || !aligned16(out) || !aligned16(dout))
    return cudaErrorInvalidValue;
  const int Tp = (T_len + kRowPad - 1) / kRowPad * kRowPad;
  const int rows = B * H * Tp;
  float* lse2 = static_cast<float*>(ws);
  attn_wg_delta<16><<<(rows + 15) / 16, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), lse2, lse2 + rows, rows, T_len, Tp, d);
  return cudaGetLastError();
}

// The bias-free bf16 dK/dV pass (routes wgmma64 and wgmma128), after the
// pre-pass: q, k, v, dout, dk, dv [B, H, T, d] bf16 contiguous and 16-byte
// aligned, d a multiple of 16 up to `width` (64 or 128); ws the pre-pass's
// workspace; kv_len [B] int32 in [1, T]; ds a workspace [B, H, T, ldk]
// bf16, ldk ≥ T a multiple of 64, of which the dQ pass
// (wfl_attention_bwd_dq_mma) reads the key tiles below kv_len; seed,
// drop_thr and drop_scale as the forward's. Returns the launch's
// cudaError_t.
extern "C" int wfl_attention_wgmma_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* ws, const void* kv_len, const void* seed, void* dk, void* dv,
    void* ds, int B, int H, int T_len, int d, int width, int ldk,
    float scale, int drop_thr, float drop_scale, void* stream) {
  if (!widths_ok(d, width) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(ds) ||
      ldk % 64 != 0 || ldk < T_len || T_len < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  const int Tp = (T_len + kRowPad - 1) / kRowPad * kRowPad;
  WgBwdArgs a{};
  if (!make_map(&a.q, q, d, T_len, BH, d, 64) ||
      !make_map(&a.k, k, d, T_len, BH, d, 64) ||
      !make_map(&a.v, v, d, T_len, BH, d, 64) ||
      !make_map(&a.dout, dout, d, T_len, BH, d, 64))
    return cudaErrorInvalidValue;
  a.lse2 = static_cast<const float*>(ws);
  a.delta = a.lse2 + (size_t)BH * Tp;
  a.kv_len = static_cast<const int*>(kv_len);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.ds = static_cast<bf16*>(ds);
  a.H = H;
  a.T_len = T_len;
  a.Tp = Tp;
  a.d = d;
  a.ldk = ldk;
  a.scale = scale;
  a.drop = Dropout{static_cast<const int*>(seed), drop_thr, drop_scale};
  return width == 128 ? run_dkdv<128, kBwdGroups128>(a, BH, s)
                      : run_dkdv<64, kBwdGroups64>(a, BH, s);
}
