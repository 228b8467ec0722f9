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
// stops the narrower designs at 512 is room: no block holds a 64-row Q tile
// of all D columns beside K and V (164 KB in f32 at D = 640), nor the output
// or gradient accumulators of all D columns in its registers.
//
// What this design does about it: a thread-block cluster splits the
// contraction over D, so that every score product runs once a tile.
// - The cluster plan (plan_of): C = ⌈D / 128⌉ CTAs, rank r owning the
//   columns [r·W, min((r + 1)·W, D)) of D, W a multiple of 16 up to
//   kSliceW = 128 columns, balanced over the ranks (640: C = 5, W = 128;
//   528: 5 × 112, the last 80; 1280: 10 × 128, a non-portable cluster
//   above 8 CTAs, up to 16: D ≤ 2048). Launched by cudaLaunchKernelEx with
//   the cluster dimension (C, 1, 1) on a grid (C, tiles, B·H).
// - Each CTA keeps its rank's slice resident in shared memory (the forward
//   its Q slice, the dK/dV pass its K and V slices) and streams the others'
//   matching slices by 16-byte cp.async, a warp a row, staged ahead (the
//   forward: K two tiles ahead in a ring of 2, V one tile ahead in a ring
//   of 2; the dK/dV pass: Q, dO, LSE and delta in a ring of 3); no CTA
//   reads another rank's columns of any input.
// - Per tile, each CTA computes a partial score tile over its slice only (S
//   = Q·Kᵀ; in the dK/dV pass Sᵀ and dPᵀ = V·dOᵀ), each warp its 16 rows
//   on mma.sync, and stores it fragment-major (512-byte chunks: a warp's
//   8-column tile, 16 bytes a lane) into a double-buffered partial buffer.
//   The cluster then sums the partials as a reduce-scatter and an
//   all-gather through distributed shared memory (mapa +
//   ld.shared::cluster, 16-byte loads, no bank conflicts): rank r sums the
//   chunks c with c % C == r over the ranks in rank order 0..C-1 and writes
//   the sums over its own partial (no other rank reads those), then every
//   warp reads its chunks' sums from their owners. So each score is summed
//   once, every rank holds bit-identical scores, P, row max and row sum,
//   and a CTA reads 2·(C − 1)/C score tiles of its peers a tile, not C − 1
//   (the first design read every partial in every warp: the exchange was
//   half of the bf16 forward's cycles). Rank 0 alone writes the LSE; the
//   ranks share the dS workspace's rows of a tile, copied out of shared
//   memory row by row.
// - Two cluster barriers a tile, each arrive split from its wait: A(k)
//   (every rank's partial of tile k is in) and B(k) (every rank's sums of
//   it are in). Between B's arrive and wait a CTA stages ahead and computes
//   tile k + 1's partial; between A(k + 1)'s arrive and wait it accumulates
//   tile k's P·V (or dK and dV). The double-buffered partials make the
//   barriers also the ones that free a buffer. Before it exits a CTA waits
//   on a last cluster barrier, so that no peer still reads its shared
//   memory.
// - Forward: 8 warps, 16 query rows each (128 a cluster), keys a tile 64
//   (bf16) or 48 (f32; 8 % faster than 32 on the card, kernel_variants_ab.py
//   --kernel wide; 4 warps and 2 blocks a SM were 14-15 % (bf16) and
//   34-40 % (f32) slower); the online softmax in registers in base 2 (log2(e)
//   folded into the scale and the gate, one exp2f a score); P re-packed
//   from the score registers as the A operand of P·V[:, slice] (bf16:
//   rounded to bf16, as the JAX kernel's p.astype(v.dtype)), the output
//   slice in registers (64 f32 a thread).
// - dK/dV pass: 64 keys a cluster, 8 warps as 4 key groups × 2 halves; a
//   warp's partials cover its 16 keys × half the streamed queries, then it
//   forms P = exp(S − LSE) and dS = P·(M·dP − delta) per element into
//   shared memory tiles Pᵀ·M and dSᵀ, and accumulates dV += (P·M)ᵀ·dO and
//   dK += dSᵀ·Q over half the slice's columns (64 f32 a thread). The dQ
//   pass (a block per 128 output columns, 64 queries) runs dQ[:, slice] +=
//   dS·K[:, slice] over the key tiles below kv_len from the workspace, its
//   tiles staged one ahead. Every gradient is written by one block: no
//   atomics, the result does not depend on the schedule.
// - Products on mma.sync through attention_mma.cuh's operand policies: bf16
//   m16n8k16, f32 as three TF32 m16n8k8 products of hi/lo splits, each
//   group of mma steps summed into fresh registers and added in f32. One
//   block a SM (166-220 KB of shared memory), up to 255 registers.
// - Masking as the other kernels: key tiles wholly past kv_len[b] are
//   skipped (forward, dQ) or write zero dK and dV and no dS; keys ≥ kv_len
//   are -1e30 before the exp; ragged tiles are zero-filled on load, rows
//   past T never stored.
// - Strict attention dropout (K6) as a DROP template flag: the forward
//   multiplies P by wfl::drop_keep of the absolute (b, h, q, k) after the
//   row sum; the dK/dV pass gives dV P·M and dS = P·(M·dP − delta).
//
// What it costs: the partials move through distributed shared memory, 8·(C
// − 1)/C bytes a score element a CTA (twice that in the dK/dV pass), two
// cluster barriers a tile, and every rank runs the softmax of the whole
// tile. What still bounds the forward (kernel_variants_ab.py --kernel wide,
// clock64 shares of its key loop at [8, 2, 1500, 640], f32 at 32-key
// tiles): the reduce-scatter with its arrive 23 % of the bf16 warps'
// cycles (14 % f32), issuing the copies and the partial S 26 % (36 %), P·V
// 28 % (41 %), the softmax 16 % (6 %), the waits for the barriers and the
// all-gather 7 % (4 %). A CTA a SM runs these phases one after another:
// 4 warps and 2 CTAs a SM, to interleave two clusters, were slower, and
// two reduce positions in flight a thread in place of one left the
// reduce-scatter's share where it was (23 % against 21 %, two calls).
// Pushing the partials to their owners (st.async on an mbarrier) in place
// of the barrier-and-pull exchange is the next step.
#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;           // the backward passes' warps
constexpr int kThreads = kWarps * 32;
constexpr int kMinD = 512;        // narrower widths take the other kernels
constexpr int kSliceW = 128;      // the widest D slice a CTA owns
constexpr int kPortable = 8;      // the portable cluster size
constexpr int kMaxRanks = 16;     // the largest cluster (non-portable)
constexpr int kMaxD = kSliceW * kMaxRanks;
constexpr int kLdk = 64;          // the dS workspace's rows: a multiple of this
// Tiles of each pass, by dtype {bf16, f32}
constexpr int kFwdWarps = 8;              // forward: warps, 16 queries each
constexpr int kFwdBlocks = 1;             // forward: blocks a SM
constexpr int kFwdKeys[2] = {64, 48};     // forward: keys a tile
constexpr int kFwdStages = 2;             // forward: K and V ring stages
constexpr int kKvKeys = 64;               // dK/dV: keys a cluster
constexpr int kKvQueries[2] = {64, 32};   // dK/dV: queries a streamed tile
constexpr int kKvStages = 3;              // dK/dV: Q/dO ring stages
constexpr int kDqBQ = 64, kDqBK = 32;     // dQ: queries a block, keys a tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles. A slice row is pitched for kSliceW columns whatever the slice's
// width, so one table serves every head width. The partial buffers hold
// f32 score fragments, two buffers (alternate tiles).
template <class Pol>
struct WideTiles {
  static constexpr bool kF32 = sizeof(typename Pol::T) == 4;
  static constexpr int es = sizeof(typename Pol::T);
  static constexpr int p = Pol::pitch(kSliceW);
  // forward: the Q slice, the K and V rings, the partial S buffers
  static constexpr int fwd_bq = 16 * kFwdWarps;
  static constexpr int fwd_bk = kFwdKeys[kF32];
  static constexpr size_t fwd_smem =
      (size_t)es * (fwd_bq + kFwdStages * 2 * fwd_bk) * p
      + sizeof(float) * 2 * fwd_bq * fwd_bk;
  // dK/dV: the K and V slices, the Q/dO ring, Pᵀ·M and dSᵀ, the LSE and
  // delta ring, the partial Sᵀ and dPᵀ buffers
  static constexpr int kv_bk = kKvKeys;
  static constexpr int kv_bq = kKvQueries[kF32];
  static constexpr int kv_ps = Pol::pitch_s(kv_bq);
  static constexpr size_t dkdv_smem =
      (size_t)es * (2 * kv_bk * p + kKvStages * 2 * kv_bq * p
                    + 2 * kv_bk * kv_ps)
      + sizeof(float) * (kKvStages * 2 * kv_bq + 2 * 2 * kv_bk * kv_bq);
  // dQ: two stages of the dS tile and the K slice
  static constexpr int dq_ps = Pol::pitch_s(kDqBK);
  static constexpr size_t dq_smem =
      (size_t)es * 2 * (kDqBQ * dq_ps + kDqBK * p);
  // 228 KB a SM, 1 KB of it reserved per block: the forward kFwdBlocks
  // blocks a SM, the dK/dV pass one, the dQ pass two
  static_assert(kFwdBlocks * (fwd_smem + 1024) <= 233472,
                "forward tiles too large");
  static_assert(dkdv_smem + 1024 <= 233472, "dK/dV tiles too large");
  static_assert(2 * (dq_smem + 1024) <= 233472, "dQ tiles too large");
};

// The cluster plan of a head width (a multiple of 16): ranks CTAs, rank r
// owning the columns [r·width, min((r + 1)·width, D)).
struct Plan {
  int ranks, width;
};

inline Plan plan_of(int D) {
  const int steps = D / 16, most = kSliceW / 16;
  const int c = (steps + most - 1) / most;
  const int per = (steps + c - 1) / c;
  return Plan{(steps + per - 1) / per, 16 * per};
}

// The launches' arguments as one kernel parameter: [B, H, T, D] tensors,
// bias [H, T, T] of the dtype or null, gate [B, H, T] f32 or null, the key
// lengths, the LSE (written by the forward when not null, read by the
// backward) and delta rows, the dS workspace [B, H, T, ldk], the plan.
template <class T>
struct WideArgs {
  const T *q, *k, *v, *dout, *bias;
  const float *gate, *delta;
  float* lse;
  const int* kv_len;
  T *out, *dq, *dk, *dv, *ds;
  int H, T_len, D, ldk;
  int ranks, width;
  float scale;
  Dropout drop;
};

// ---------------------------------------------------------------------------
// Clusters (sm_90): the CTA's rank, the split cluster barrier (arrive with
// release, wait with acquire: what a CTA stored before it arrived is seen by
// every CTA after its wait), and 16-byte reads of a peer's shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of p (in this CTA's shared memory) in rank r
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned r) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(p)), "r"(r));
  return a;
}

__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// Tiles and products
// ---------------------------------------------------------------------------

// rows [row0, row0 + n) × the w columns at src (a row-major matrix of row
// pitch ld) into a tile of pitch p laid out by Pol::at, by 16-byte cp.async
// in the caller's copy group, a warp a row (several narrow rows at once, a
// group of lanes each) by the block's NW warps; rows past T are
// zero-filled. w is a multiple of 16 elements, at most kSliceW.
template <class Pol, int NW = kWarps>
__device__ __forceinline__ void stage_slice(typename Pol::T* dst, int p,
                                            const typename Pol::T* src,
                                            int row0, int n, int T_len,
                                            int w, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = w / Pol::kVec;                  // chunks a row, ≤ 32
  const int rows = 32 / nv;                      // rows a warp at once
  const int sub = lane / nv;                     // this lane's row of them
  if (sub >= rows) return;
  const int c = (lane - sub * nv) * Pol::kVec;
  for (int r = warp * rows + sub; r < n; r += NW * rows) {
    const bool ok = row0 + r < T_len;
    cp_async16(dst + Pol::at(p, r, c),
               ok ? src + (size_t)(row0 + r) * ld + c : src, ok ? 16 : 0);
  }
}

// The warp's partial scores X = A·Bᵀ over a slice: rows r0 + [0, 16) of the
// A tile and columns c0 + [0, 16·NJ) of the [n][k]-stored B tile, both of
// pitch p, contracted over the slice's first ks·KS columns (x[j][n] is the
// 8-column tile 2j + n). Each 4 mma steps sum into fresh registers that are
// then added in f32 (see score_part).
template <class Pol, int NJ>
__device__ __forceinline__ void slice_scores(float (&x)[NJ][2][4],
                                             const typename Pol::T* a_t,
                                             const typename Pol::T* b_t,
                                             int p, int r0, int c0, int ks) {
  constexpr int CH = 4, KSMAX = kSliceW / Pol::KS;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][0][e] = x[j][1][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KSMAX; kc += CH) {
    if (kc >= ks) break;
    float y[NJ][2][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][0][e] = y[j][1][e] = 0.f;
#pragma unroll
    for (int kk = kc; kk < kc + CH; ++kk) {
      if (kk >= ks) break;
      typename Pol::A qa;
      Pol::load_ak(qa, a_t, p, r0, kk * Pol::KS);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename Pol::B b0, b1;
        Pol::load_bk2(b0, b1, b_t, p, c0 + 16 * j, kk * Pol::KS);
        Pol::mma(y[j][0], qa, b0);
        Pol::mma(y[j][1], qa, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][n][e] += y[j][n][e];
  }
}

// A warp's score fragments into its slot of a partial buffer, fragment-major
// (slot = the buffer + 4·(32·2NJ·warp + lane); tile t at slot + 128·t).
template <int NJ>
__device__ __forceinline__ void put_part(float* slot,
                                         const float (&x)[NJ][2][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      *reinterpret_cast<float4*>(slot + 128 * (2 * j + n)) =
          make_float4(x[j][n][0], x[j][n][1], x[j][n][2], x[j][n][3]);
}

// This rank's share of the cluster's sum of a partial buffer (nchunks
// chunks of 32 lanes × 16 bytes): every chunk c with c % ranks == rank,
// summed over the ranks in rank order, each rank's buffer read through
// distributed shared memory, written back in place into this rank's
// buffer (no other rank reads this rank's own chunks of the partials, so
// the sum can take their place). A thread takes two 16-byte positions at
// once, their loads in flight together, up to 8 ranks at a time.
template <int NTHREADS>
__device__ __forceinline__ void reduce_own(float* buf, int nchunks, int rank,
                                           int ranks) {
  constexpr int G = 8;
  const int n = 32 * ((nchunks - rank + ranks - 1) / ranks);
  for (int i = threadIdx.x; i < n; i += 2 * NTHREADS) {
    const int i1 = i + NTHREADS < n ? i + NTHREADS : i;
    float* at[2] = {buf + 128 * (rank + ranks * (i >> 5)) + 4 * (i & 31),
                    buf + 128 * (rank + ranks * (i1 >> 5)) + 4 * (i1 & 31)};
    float4 s[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int r0 = 0; r0 < ranks; r0 += G) {
      float4 v[2][G];
#pragma unroll
      for (int r = 0; r < G; ++r)
        if (r0 + r < ranks)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            v[u][r] = ld_cluster4(map_rank(at[u], r0 + r));
#pragma unroll
      for (int r = 0; r < G; ++r)
        if (r0 + r < ranks)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            s[u].x += v[u][r].x;
            s[u].y += v[u][r].y;
            s[u].z += v[u][r].z;
            s[u].w += v[u][r].w;
          }
    }
    *reinterpret_cast<float4*>(at[0]) = s[0];
    *reinterpret_cast<float4*>(at[1]) = s[1];
  }
}

// The warp's summed score fragments of a buffer that reduce_own has
// summed: its chunks c0 + t (t < 2NJ; slot as put_part's), each read from
// the rank that owns it (c % ranks).
template <int NJ>
__device__ __forceinline__ void gather_sums(float (&x)[NJ][2][4],
                                            const float* slot, int c0,
                                            int ranks) {
  float4 v[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      v[j][n] = ld_cluster4(map_rank(slot + 128 * (2 * j + n),
                                     (c0 + 2 * j + n) % ranks));
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      x[j][n][0] = v[j][n].x;
      x[j][n][1] = v[j][n].y;
      x[j][n][2] = v[j][n].z;
      x[j][n][3] = v[j][n].w;
    }
}

// acc += C·B for one 16 × 16 tile C the warp holds in accumulator registers
// (its columns are the contraction) and the first nt 8-column tiles (nt
// even) of the [k][n]-stored tile b_t, rows k0 + [0, 16): accumulate_held
// of attention_mma.cuh with the slice's width known only at run time.
template <class Pol, int NTMAX, bool IN_PLACE>
__device__ __forceinline__ void accumulate_slice(
    float (&acc)[NTMAX][4], const float (&c)[2][4], const typename Pol::T* b_t,
    int pb, int k0, int nt) {
#pragma unroll
  for (int st = 0; st < Pol::kStepsAcc; ++st) {
    typename Pol::A a;
    Pol::a_from_acc(a, c, st);
#pragma unroll
    for (int n = 0; n < NTMAX; n += 2) {
      if (n >= nt) break;
      typename Pol::B b0, b1;
      Pol::load_bt2_acc(b0, b1, b_t, pb, k0 + st * Pol::KS, n * 8);
      if constexpr (IN_PLACE) {
        Pol::mma(acc[n], a, b0);
        Pol::mma(acc[n + 1], a, b1);
      } else {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        Pol::mma(t0, a, b0);
        Pol::mma(t1, a, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] += t0[e];
          acc[n + 1][e] += t1[e];
        }
      }
    }
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
// Forward: cluster (rank, 16·kFwdWarps-query tile, b·H + h). Warp w owns
// queries 16·w of the tile: their partial scores over the rank's slice,
// then the softmax of the summed scores, and the rank's output columns.
// Lane (g, t) holds rows g and g + 8 and keys 8·n + 2t + {0, 1} of each
// 8-key tile n.
// ---------------------------------------------------------------------------

template <class Pol, bool BIAS, bool DROP>
__global__ void __launch_bounds__(32 * kFwdWarps, kFwdBlocks)
attn_wide_fwd(const WideArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = WideTiles<Pol>;
  constexpr int BQ = Cfg::fwd_bq, BK = Cfg::fwd_bk, P = Cfg::p;
  constexpr int NS = kFwdStages, NJ = BK / 16, NTMAX = kSliceW / 8;
  constexpr int NW = kFwdWarps;
  constexpr int kPartBuf = BQ * BK;               // floats a partial buffer
  constexpr int kChunks = kPartBuf / 128;         // its 512-byte chunks
  constexpr bool kInPlace = !Cfg::kF32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);        // [BQ][P] the Q slice
  T* sK = sQ + BQ * P;                            // [NS][BK][P] K's slices
  T* sV = sK + NS * BK * P;                       // [NS][BK][P] V's slices
  float* sPart = reinterpret_cast<float*>(sV + NS * BK * P);  // [2][..]

  const int rank = static_cast<int>(cluster_rank());
  const int q0 = blockIdx.y * BQ;
  const int bhi = blockIdx.z, b = bhi / a.H, h = bhi - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)bhi;
  const size_t base = bh * T_len * D;
  const int col0 = rank * a.width, w = min(a.width, D - col0);
  const int ks = w / Pol::KS, nt = w / 8;
  const T* __restrict__ k = a.k + base + col0;
  const T* __restrict__ v = a.v + base + col0;
  const int kvl = a.kv_len[b];
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;
  const int n_kt = (kvl + BK - 1) / BK;

  // K of key tile kt is read a tile before its V: K(kt + 2) and V(kt + 1)
  // come in together, into the slots K(kt) and V(kt − 1) left
  auto stage_k = [&](int kt) {
    stage_slice<Pol, NW>(sK + (kt % NS) * BK * P, P, k, kt * BK, BK, T_len, w,
                         D);
  };
  auto stage_v = [&](int kt) {
    stage_slice<Pol, NW>(sV + (kt % NS) * BK * P, P, v, kt * BK, BK, T_len, w,
                         D);
  };
  stage_slice<Pol, NW>(sQ, P, a.q + base + col0, q0, BQ, T_len, w, D);
  stage_k(0);
  stage_v(0);
  cp_async_commit();
  if (n_kt > 1) {
    stage_k(1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();        // the Q slice and key tile 0 are in

  // this lane's two rows: log2(e)·gate and the bias row
  const int r0 = warp * 16;
  int qrow[2];
  float gl[2], m_row[2], l_row[2];
  const T* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + r0 + g + 8 * i;
    const bool ok = qrow[i] < T_len;
    gl[i] = kLog2e * (BIAS && a.gate != nullptr && ok
                          ? a.gate[bh * T_len + qrow[i]] : 1.f);
    brow[i] = BIAS && ok ? a.bias + ((size_t)h * T_len + qrow[i]) * T_len
                         : nullptr;
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
  }
  const float sc = a.scale * kLog2e;
  float o[NTMAX][4];
#pragma unroll
  for (int n = 0; n < NTMAX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // the warp's partial of key tile kt into buffer kt & 1
  float* const slot = sPart + 4 * (32 * 2 * NJ * warp + lane);
  auto partial = [&](int kt) {
    float x[NJ][2][4];
    slice_scores<Pol, NJ>(x, sQ, sK + (kt % NS) * BK * P, P, r0, 0, ks);
    put_part<NJ>(slot + (kt & 1) * kPartBuf, x);
  };
  partial(0);
  cluster_arrive();

  // Two cluster barriers a tile, each arrive split from its wait: A(kt),
  // every rank's partial of tile kt is in; B(kt), every rank's share of
  // its sum is in. The next tile's partial runs inside B, P·V inside A.
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float* const buf = sPart + (kt & 1) * kPartBuf;
    cluster_wait();       // A(kt)
    reduce_own<32 * NW>(buf, kChunks, rank, a.ranks);
    cluster_arrive();     // B(kt)
    cp_async_wait<0>();
    __syncthreads();      // V(kt), K(kt + 1) are in; every warp is done with
                          // kt − 1
    if (kt + 1 < n_kt) {
      stage_v(kt + 1);
      if (kt + 2 < n_kt) stage_k(kt + 2);
      cp_async_commit();
      partial(kt + 1);
    }
    cluster_wait();       // B(kt)
    float s[NJ][2][4];
    gather_sums<NJ>(s, slot + (kt & 1) * kPartBuf, 2 * NJ * warp, a.ranks);

    // scale, gated bias and key mask in base 2; online softmax per row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kj = k0 + 16 * j + 8 * n + 2 * t4 + (e & 1);
          float x = kNegInf;
          if (kj < kvl) {
            x = s[j][n][e] * sc;
            if (BIAS && brow[i] != nullptr)
              x = fmaf(gl[i], to_f(brow[i][kj]), x);
          }
          s[j][n][e] = x;
          mx[i] = fmaxf(mx[i], x);
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

    if (kt + 1 < n_kt) cluster_arrive();   // A(kt + 1)

    // O = O·α + P·V[:, slice], P straight from the score registers
#pragma unroll
    for (int n = 0; n < NTMAX; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    const T* tV = sV + (kt % NS) * BK * P;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      accumulate_slice<Pol, NTMAX, kInPlace>(o, s[j], tV, P, 16 * j, nt);
  }
  cluster_arrive();       // this CTA reads no peer's shared memory any more

  // the row sum over the quad, the LSE (rank 0) and 1/l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l_row[i]), 1e-30f);
    if (rank == 0 && a.lse != nullptr && t4 == 0 && qrow[i] < T_len)
      a.lse[bh * T_len + qrow[i]] = m_row[i] * kLn2 + logf(lc);
    const float inv = 1.f / lc;
#pragma unroll
    for (int n = 0; n < NTMAX; ++n) {
      o[n][2 * i] *= inv;
      o[n][2 * i + 1] *= inv;
    }
  }
  store_acc<T, NTMAX>(a.out + base + col0, o, q0 + r0, 0, nt, nt, T_len, D,
                      1.f);
  cluster_wait();         // and no peer reads this one's
}

// ---------------------------------------------------------------------------
// dK/dV pass: cluster (rank, 64-key tile, b·H + h). Warp w: keys 16·(w % 4)
// of the tile; per streamed query tile its partial Sᵀ = K·Qᵀ and dPᵀ =
// V·dOᵀ over the rank's slice for queries half (w / 4) of the tile, then
// P·M and dS of those into shared memory; then dV and dK of its keys for
// the 8-column tiles of half w / 4 of the rank's columns.
// ---------------------------------------------------------------------------

template <class Pol, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attn_wide_bwd_dkdv(const WideArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = WideTiles<Pol>;
  constexpr int BK = Cfg::kv_bk, BQ = Cfg::kv_bq, P = Cfg::p;
  constexpr int PS = Cfg::kv_ps, NS = kKvStages;
  constexpr int NJ = BQ / 32;                     // a warp's 16-query groups
  constexpr int NPW = kSliceW / 16;               // its 8-column tiles, most
  constexpr int kPartBuf = BK * BQ;               // floats of S (or dP)
  constexpr int kChunks = kPartBuf / 128;         // its 512-byte chunks
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);        // [BK][P] the K slice
  T* sV = sK + BK * P;                            // [BK][P] the V slice
  T* sQO = sV + BK * P;                           // [NS][Q, dO][BQ][P]
  T* sPt = sQO + NS * 2 * BQ * P;                 // [BK][PS] Pᵀ·M
  T* sDSt = sPt + BK * PS;                        // [BK][PS] dSᵀ
  float* sStat = reinterpret_cast<float*>(sDSt + BK * PS);  // [NS][L, δ][BQ]
  float* sPart = sStat + NS * 2 * BQ;             // [2][S, dP][..]

  const int rank = static_cast<int>(cluster_rank());
  const int k0 = blockIdx.y * BK;
  const int bhi = blockIdx.z, b = bhi / a.H, h = bhi - b * a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)bhi;
  const size_t base = bh * T_len * D;
  const int col0 = rank * a.width, w = min(a.width, D - col0);
  const int ks = w / Pol::KS, nt = w / 8;
  const int kvl = a.kv_len[b];
  if (k0 >= kvl) {      // no query attends these keys: zero gradients
    for (int idx = tid; idx < BK * w; idx += kThreads) {
      const int r = idx / w, c = idx - r * w;
      if (k0 + r < T_len) {
        a.dk[base + (size_t)(k0 + r) * D + col0 + c] = from_f<T>(0.f);
        a.dv[base + (size_t)(k0 + r) * D + col0 + c] = from_f<T>(0.f);
      }
    }
    return;
  }
  const uint32_t dbase = DROP ? drop_base(a.drop, b, h) : 0u;
  T* __restrict__ ds = a.ds + bh * T_len * a.ldk;
  const T* q = a.q + base + col0;
  const T* dout = a.dout + base + col0;

  const int kb = 16 * (warp & 3), half = warp >> 2;
  const int qh = half * (BQ / 2);                 // its queries of a tile
  const int npw = cols_per_warp(nt, 2), nt0 = half * npw;
  float acc_dv[1][NPW][4], acc_dk[1][NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[0][n][e] = acc_dk[0][n][e] = 0.f;

  const int n_qt = (T_len + BQ - 1) / BQ;
  auto stage = [&](int qt) {
    const int sl = qt % NS;
    T* dst = sQO + sl * 2 * BQ * P;
    stage_slice<Pol>(dst, P, q, qt * BQ, BQ, T_len, w, D);
    stage_slice<Pol>(dst + BQ * P, P, dout, qt * BQ, BQ, T_len, w, D);
    stage_stats<kThreads>(sStat + sl * 2 * BQ, sStat + sl * 2 * BQ + BQ,
                          a.lse, a.delta, bh, qt * BQ, BQ, T_len);
  };
  stage_slice<Pol>(sK, P, a.k + base + col0, k0, BK, T_len, w, D);
  stage_slice<Pol>(sV, P, a.v + base + col0, k0, BK, T_len, w, D);
  stage(0);
  cp_async_commit();
  if (n_qt > 1) {
    stage(1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();        // the K and V slices and query tile 0 are in

  // the warp's partial Sᵀ and dPᵀ of query tile qt into buffer qt & 1
  float* const slot = sPart + 4 * (32 * 2 * NJ * warp + lane);
  auto partial = [&](int qt) {
    const T* tQ = sQO + (qt % NS) * 2 * BQ * P;
    float* dst = slot + (qt & 1) * 2 * kPartBuf;
    float x[NJ][2][4];
    slice_scores<Pol, NJ>(x, sK, tQ, P, kb, qh, ks);
    put_part<NJ>(dst, x);
    slice_scores<Pol, NJ>(x, sV, tQ + BQ * P, P, kb, qh, ks);
    put_part<NJ>(dst + kPartBuf, x);
  };
  partial(0);
  cluster_arrive();

  // The forward's two split cluster barriers a tile: A(qt), every rank's
  // partials of tile qt are in; B(qt), every rank's share of their sums.
  // The next tile's partials run inside B, dK and dV inside A.
  const float sc = a.scale * kLog2e;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ, sl = qt % NS;
    const float* sL = sStat + sl * 2 * BQ;
    const float* sDl = sL + BQ;
    float* const buf = sPart + (qt & 1) * 2 * kPartBuf;
    cluster_wait();       // A(qt)
    reduce_own<kThreads>(buf, 2 * kChunks, rank, a.ranks);
    cluster_arrive();     // B(qt)
    cp_async_wait<0>();
    __syncthreads();      // tile qt + 1 is in; every warp is done with qt − 1
    if (qt + 2 < n_qt) {
      stage(qt + 2);
      cp_async_commit();
    }
    if (qt + 1 < n_qt) partial(qt + 1);
    cluster_wait();       // B(qt)
    float s[NJ][2][4], dp[NJ][2][4];
    gather_sums<NJ>(s, slot + (qt & 1) * 2 * kPartBuf, 2 * NJ * warp,
                    a.ranks);
    gather_sums<NJ>(dp, slot + (qt & 1) * 2 * kPartBuf + kPartBuf,
                    kChunks + 2 * NJ * warp, a.ranks);

    // P = exp(S − LSE), dS = P·(M·dP − delta) per element; rows are keys,
    // columns queries
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + kb + g + 8 * (e >> 1);
          const int ql = qh + 16 * j + 8 * n + 2 * t4 + (e & 1), qi = q0 + ql;
          // mask before the exp: a masked key's raw score may exceed the
          // LSE by more than 88, and exp → inf, times 0, is NaN
          float sv = kNegInf;
          if (kj < kvl) {
            sv = s[j][n][e] * sc;
            if (BIAS && qi < T_len)
              sv = fmaf(kLog2e, gated_bias<T, BIAS>(a, bh, h, qi, kj), sv);
          }
          const float p = qi < T_len ? exp2f(sv - sL[ql] * kLog2e) : 0.f;
          const float km = (DROP && qi < T_len && kj < kvl)
              ? drop_keep(a.drop, dbase, qi, kj) : 1.f;
          s[j][n][e] = p * km;
          dp[j][n][e] = p * (dp[j][n][e] * km - sDl[ql]);
        }

    if (qt + 1 < n_qt) cluster_arrive();   // A(qt + 1)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kl = kb + g + 8 * i, ql = qh + 16 * j + 8 * n + 2 * t4;
          Pol::store2(sPt, PS, kl, ql, s[j][n][2 * i], s[j][n][2 * i + 1]);
          Pol::store2(sDSt, PS, kl, ql, dp[j][n][2 * i],
                      dp[j][n][2 * i + 1]);
        }
    __syncthreads();      // Pᵀ·M and dSᵀ of tile qt are in

    // dS of the tile into the workspace ([query][key] rows), a row's keys
    // by consecutive threads; the ranks share the rows (row % C == rank)
    const int n_rows = (BQ - rank + a.ranks - 1) / a.ranks;
    for (int idx = tid; idx < n_rows * BK; idx += kThreads) {
      const int ql = rank + a.ranks * (idx / BK), kl = idx % BK;
      if (q0 + ql < T_len)
        ds[(size_t)(q0 + ql) * a.ldk + k0 + kl] = sDSt[Pol::at_s(PS, kl, ql)];
    }

    // dV += (P·M)ᵀ·dO[:, slice], dK += dSᵀ·Q[:, slice] (scale at the store)
    const T* tQ = sQO + sl * 2 * BQ * P;
    accumulate<Pol, NPW, BQ, 1>(acc_dv, sPt, PS, kb, tQ + BQ * P, P, nt0,
                                npw, nt);
    accumulate<Pol, NPW, BQ, 1>(acc_dk, sDSt, PS, kb, tQ, P, nt0, npw, nt);
  }
  cluster_arrive();       // this CTA reads no peer's shared memory any more
  store_acc<T, NPW>(a.dv + base + col0, acc_dv[0], k0 + kb, nt0, npw, nt,
                    T_len, D, 1.f);
  store_acc<T, NPW>(a.dk + base + col0, acc_dk[0], k0 + kb, nt0, npw, nt,
                    T_len, D, a.scale);
  cluster_wait();         // and no peer reads this one's
}

// ---------------------------------------------------------------------------
// dQ pass: block (column block of kSliceW, 64-query tile, b·H + h), after
// the dK/dV pass has written dS. Warp w owns queries 32·(w % 2) and the
// column slice w / 2 of dQ across the key tiles below kv_len; the dS tile
// and the K slice of key tile k + 1 are staged while tile k is computed.
// ---------------------------------------------------------------------------

template <class Pol>
__global__ void __launch_bounds__(kThreads, 2)
attn_wide_bwd_dq(const WideArgs<typename Pol::T> a) {
  using T = typename Pol::T;
  using Cfg = WideTiles<Pol>;
  constexpr int BQ = kDqBQ, BK = kDqBK, P = Cfg::p, PS = Cfg::dq_ps;
  constexpr int MT = 2, NPW = 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sDS = reinterpret_cast<T*>(smem_raw);       // [2][BQ][PS]
  T* sK = sDS + 2 * BQ * PS;                      // [2][BK][P] K's slice

  const int cb = blockIdx.x, q0 = blockIdx.y * BQ;
  const int bhi = blockIdx.z, b = bhi / a.H;
  const int warp = threadIdx.x >> 5;
  const int T_len = a.T_len, D = a.D;
  const size_t bh = (size_t)bhi;
  const size_t base = bh * T_len * D;
  const int col0 = cb * kSliceW, ncol = min(kSliceW, D - col0), NT = ncol / 8;
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
  auto stage = [&](int kt) {
    const int st = kt & 1;
    stage_cols<Pol, BK, kThreads>(sDS + st * BQ * PS, PS, ds, q0, kt * BK,
                                  BQ, T_len, a.ldk);
    stage_slice<Pol>(sK + st * BK * P, P, a.k + base + col0, kt * BK, BK,
                     T_len, ncol, D);
  };
  const int n_kt = (kvl + BK - 1) / BK;
  stage(0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    __syncthreads();      // tile kt is in; every warp is done with kt − 1
    if (kt + 1 < n_kt) {
      stage(kt + 1);
      cp_async_commit();
    }
    accumulate<Pol, NPW, BK, MT>(acc, sDS + st * BQ * PS, PS, ar0,
                                 sK + st * BK * P, P, nt0, npw, NT);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_acc<T, NPW>(a.dq + base + col0, acc[m], q0 + ar0 + 16 * m, nt0, npw,
                      NT, T_len, D, a.scale);
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The attributes a pass's kernel needs: dynamic shared memory above 48 KB,
// and clusters above the portable 8 CTAs.
template <class Kernel>
cudaError_t set_attributes(Kernel kernel, size_t smem, int ranks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || ranks <= kPortable) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A launch configuration of grid with clusters of (ranks, 1, 1); attr is
// the caller's storage for the cluster attribute.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int ranks, int threads,
                                         size_t smem, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class T>
cudaError_t launch_cluster(void (*kernel)(WideArgs<T>), dim3 grid,
                           int threads, size_t smem, cudaStream_t s,
                           const WideArgs<T>& a) {
  cudaError_t err = set_attributes(kernel, smem, a.ranks);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, a.ranks, threads, smem,
                                                s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of a kernel can be resident at once (the occupancy
// API), with its attributes set as a launch sets them.
template <class T>
cudaError_t resident_clusters(void (*kernel)(WideArgs<T>), int ranks,
                              int threads, size_t smem, int* clusters) {
  cudaError_t err = set_attributes(kernel, smem, ranks);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(ranks), ranks, threads,
                                                smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <class Pol, bool BIAS, bool DROP>
cudaError_t run_fwd(const WideArgs<typename Pol::T>& a, int B,
                    cudaStream_t s) {
  using Cfg = WideTiles<Pol>;
  return launch_cluster(attn_wide_fwd<Pol, BIAS, DROP>,
                        dim3(a.ranks, (a.T_len + Cfg::fwd_bq - 1) / Cfg::fwd_bq,
                             B * a.H),
                        32 * kFwdWarps, Cfg::fwd_smem, s, a);
}

// The dK/dV pass (which writes dS), then the dQ pass (which reads it).
template <class Pol, bool BIAS, bool DROP>
cudaError_t run_bwd(const WideArgs<typename Pol::T>& a, int B,
                    cudaStream_t s) {
  using Cfg = WideTiles<Pol>;
  cudaError_t err = launch_cluster(
      attn_wide_bwd_dkdv<Pol, BIAS, DROP>,
      dim3(a.ranks, (a.T_len + Cfg::kv_bk - 1) / Cfg::kv_bk, B * a.H),
      kThreads, Cfg::dkdv_smem, s, a);
  if (err != cudaSuccess) return err;
  return wfl::launch(attn_wide_bwd_dq<Pol>,
                     dim3((a.D + kSliceW - 1) / kSliceW,
                          (a.T_len + kDqBQ - 1) / kDqBQ, B * a.H),
                     dim3(kThreads), Cfg::dq_smem, s, a);
}

// The plan's numbers of one instantiation: out[0] the cluster's CTAs,
// out[1] the slice width, out[2] the dynamic shared memory a block, out[3]
// the clusters that can be resident at once (the dQ pass: blocks a SM).
template <class Pol, bool BIAS, bool DROP>
cudaError_t describe(const Plan& pl, int pass, int* out) {
  using Cfg = WideTiles<Pol>;
  using T = typename Pol::T;
  out[0] = pass == 2 ? 1 : pl.ranks;
  out[1] = pass == 2 ? kSliceW : pl.width;
  if (pass == 0) {
    out[2] = (int)Cfg::fwd_smem;
    return resident_clusters<T>(attn_wide_fwd<Pol, BIAS, DROP>, pl.ranks,
                                32 * kFwdWarps, Cfg::fwd_smem, &out[3]);
  }
  if (pass == 1) {
    out[2] = (int)Cfg::dkdv_smem;
    return resident_clusters<T>(attn_wide_bwd_dkdv<Pol, BIAS, DROP>,
                                pl.ranks, kThreads, Cfg::dkdv_smem, &out[3]);
  }
  out[2] = (int)Cfg::dq_smem;
  cudaError_t err = cudaFuncSetAttribute(
      attn_wide_bwd_dq<Pol>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg::dq_smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], attn_wide_bwd_dq<Pol>, kThreads, Cfg::dq_smem);
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

// The checks both launchers share: D a multiple of 16 above 512 and at most
// 2048 (16 CTAs of 128 columns), a gate only with a bias.
bool refused(int D, const void* bias, const void* gate) {
  return D <= kMinD || D > kMaxD || D % 16 != 0
         || (bias == nullptr && gate != nullptr);
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
  const Plan pl = plan_of(D);
  a.ranks = pl.ranks;
  a.width = pl.width;
  a.scale = scale;
  a.drop = drop;
  return a;
}

}  // namespace

using namespace wfl;

// The forward at head_dim > 512 (wfl_flash_attention_fwd's arguments, which
// it shares): q, k, v, out [B, H, T, D] contiguous of the dtype (0 = f32 as
// 3×TF32, 1 = bf16), D a multiple of 16 in (512, 2048]; bias [H, T, T] of
// the dtype or null; gate [B, H, T] f32 or null (read as 1; refused without
// a bias); kv_len [B] int32 in [1, T]; lse [B, H, T] f32, written when not
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
// 16 in (512, 2048]; bias [H, T, T] of the dtype or null; gate [B, H, T]
// f32 or null; lse and delta = rowsum(dO·O) [B, H, T] f32; kv_len [B] int32
// in [1, T]; ds a workspace [B, H, T, ldk] of the dtype, ldk ≥ T a multiple
// of 64, which holds dS on return for every key below kv_len[b] (the input
// of wfl_attention_bias_dbias for dBias and dGate); seed, drop_thr,
// drop_scale as the forward's. Returns the launches' cudaError_t.
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

// The cluster plan at head width D (a multiple of 16 in (512, 2048]) of one
// instantiation: pass 0 the forward, 1 the dK/dV pass, 2 the dQ pass, of
// the dtype, with (bias != 0) or without a bias, with (drop != 0) or
// without dropout. out[4]: the cluster's CTAs, the slice width, the dynamic
// shared memory a block in bytes, and the clusters of it the card can hold
// at once (cudaOccupancyMaxActiveClusters; the dQ pass, which runs no
// clusters: its blocks a SM). Returns a cudaError_t.
extern "C" int wfl_attention_wide_plan(int D, int dtype, int pass, int bias,
                                       int drop, int* out) {
  if (D <= kMinD || D > kMaxD || D % 16 != 0 || pass < 0 || pass > 2)
    return cudaErrorInvalidValue;
  const Plan pl = plan_of(D);
#define WFL_DESCRIBE(Pol)                                                \
  if (bias) return drop ? describe<Pol, true, true>(pl, pass, out)       \
                        : describe<Pol, true, false>(pl, pass, out);     \
  return drop ? describe<Pol, false, true>(pl, pass, out)                \
              : describe<Pol, false, false>(pl, pass, out)
  if (dtype == kF32) { WFL_DESCRIBE(PolF32); }
  if (dtype == kBF16) { WFL_DESCRIBE(PolBF16); }
#undef WFL_DESCRIBE
  return cudaErrorInvalidValue;
}
