// Flash attention forward with an optional shared additive bias, a per-query
// gate and a key-length mask, for Hopper (sm_90a).
//
//   out[b,h,q,:] = softmax_k( (q*scale)·k + gate[b,h,q]·bias[h,q,k],
//                             keys k >= kv_len[b] set to -1e30 ) · v
//
// Replaces two TPU kernels with one template:
// - wfl_asr_tpu/ops/pallas/flash_attention.py:_flash_kernel (with bias and
//   gate; WavLM's gated relative-position attention), and
// - wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:_fwd_kernel (no bias)
//   at head_dim ≤ 128. The TPU package split them only for grid order and
//   VMEM; the math is the same. Bias-free calls at head_dim > 128 (the
//   Conformer's 384) take the mma.sync forward of attention_fwd_mma.cu, so
//   the kernels here serve head_dim > 128 only with a bias, which no model
//   of the repo uses.
//
// What bounds it on the card: at WavLM shapes ([8,12,1499,64]) the work is
// 4·B·H·T²·D ≈ 5.5e10 FLOPs against ≈ 128 MB of bytes (the [H,T,T] bias
// dominates) — above the bf16 ridge, so it is bound by operations. This
// first version runs bf16 on the tensor cores (mma.sync with register-
// resident tiles up to head_dim 128, WMMA above) and f32 as plain FMA loops
// from shared memory (keeping full f32 precision); wgmma and TMA are later
// work, so all run well below that bound.
//
// Design of the f32 kernel (the bf16 ones are described at their
// definitions):
// - One block of 4 warps owns BQ query rows of one (b, h); each warp owns
//   RQ = BQ/4 rows, so the row max/sum of the online softmax are warp
//   shuffles. RQ shrinks as D grows (16 / 8 / 4 rows) so the output tile,
//   RQ rows × ⌈D/32⌉ columns per lane, stays in registers.
// - Keys stream in tiles of 32 (one key per lane for the scores), through one
//   shared-memory buffer that holds the K tile, then the V tile. K rows are
//   pitched at D + 4 floats, so the 16-byte row reads of 8 lanes fall on
//   distinct banks; Q rows are read as broadcast 16-byte loads.
// - In P·V each lane owns the output columns lane + 32·m and reads P as
//   broadcast 16-byte loads of its rows, 4 keys at a time.
// - The bias is read per (q-tile, k-tile) straight from the shared [H,T,T]
//   tensor — never expanded over the batch.
// - Masking to -1e30 happens before the row max, as on the TPU; key tiles
//   wholly past kv_len are skipped (they add exp(-1e30 - m) = 0 exactly,
//   since key 0 is always valid: the wrapper clamps kv_len to >= 1).
// - Any D that is a multiple of 16 up to 512 works (D=384: 16 query rows and
//   76 KB of shared memory a block); ragged tails (T=1499) are zero-filled on
//   load and never stored.
//
// Strict attention dropout (K6, wfl_asr_tpu/ops/pallas/dropout_mask.py) runs
// inside every forward variant and both backward passes when the launcher is
// given a seed pointer: each score element's keep decision is the integer
// hash wfl::drop_keep (common.cuh) of (seed, b, h, q, k) at absolute indices,
// so any tiling regenerates the same mask, bit-identical to the JAX kernels'.
// The forwards mask P after the row sum l (the LSE stays undropped) and
// before P·V; the backward recomputes P from that LSE and uses P·M for dV and
// P·(M·dP − delta) for dS. It costs ≈ 12 integer operations per valid score
// element per pass, against 2·D FMAs. Every kernel takes it as a template
// flag, so without a seed it compiles exactly as before (a runtime branch
// cost 5-50 % in the forwards and 2-4 % in K1b's backward at rate 0 on the
// card).
#include <mma.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace wfl;
using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBK = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

// Query rows per warp of the f32 kernel for NC = ⌈D/32⌉ output columns a lane.
__host__ __device__ constexpr int f32_rows(int nc) { return nc <= 2 ? 16 : nc <= 4 ? 8 : 4; }

template <int NC, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ gate, const int* __restrict__ kv_len,
              float* __restrict__ out, float* __restrict__ lse, int H,
              int T_len, int D, float scale, Dropout drop) {
  constexpr int RQ = f32_rows(NC);
  constexpr int BQ = RQ * kWarps;
  extern __shared__ __align__(16) float smem[];
  const int DK = D + 4;
  float* sQ = smem;                // [BQ][D]   q * scale
  float* sKV = sQ + BQ * D;        // [BK][DK]  the K tile, then the V tile
  float* sP = sKV + kBK * DK;      // [BQ][BK]  probabilities of this tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + bh * T_len * D;
  const float* kb = k + bh * T_len * D;
  const float* vb = v + bh * T_len * D;
  const int kvl = kv_len[b];
  const int D4 = D / 4;
  const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;

  // rows [row0, row0 + n) of a [T, D] matrix, times mul, into a tile of
  // pitch `pitch`; zero past T
  auto load_rows = [&](float* dst, int pitch, const float* src, int row0,
                       int n, float mul) {
    for (int idx = tid; idx < n * D4; idx += kThreads) {
      const int r = idx / D4, c = (idx - r * D4) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < T_len) {
        val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
        val.x *= mul; val.y *= mul; val.z *= mul; val.w *= mul;
      }
      *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
    }
  };

  load_rows(sQ, D, qb, q0, BQ, scale);
  float m_row[RQ], l_row[RQ], g_row[RQ], o[RQ][NC];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + warp * RQ + r;
    m_row[r] = kNegInf;
    l_row[r] = 0.f;
    g_row[r] = (gate != nullptr && qi < T_len) ? gate[bh * T_len + qi] : 1.f;
#pragma unroll
    for (int m = 0; m < NC; ++m) o[r][m] = 0.f;
  }

  const int n_kt = (kvl + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK, kj = k0 + lane;
    __syncthreads();  // every warp is done with the previous V tile
    load_rows(sKV, DK, kb, k0, kBK, 1.f);
    __syncthreads();

    // scores of this warp's rows against key kj (this lane's)
    float s[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(sKV + lane * DK);
    const float4* q4 = reinterpret_cast<const float4*>(sQ + warp * RQ * D);
    for (int d = 0; d < D4; ++d) {
      const float4 kv = k4[d];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 qv = q4[r * D4 + d];
        s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    float alpha[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qi = q0 + warp * RQ + r;
      float sv = s[r];
      if (bias != nullptr) {
        const float bv = (qi < T_len && kj < T_len)
            ? bias[((size_t)h * T_len + qi) * T_len + kj] : 0.f;
        sv += gate != nullptr ? g_row[r] * bv : bv;
      }
      if (kj >= kvl) sv = kNegInf;
      const float m_new = fmaxf(m_row[r], warp_max(sv));
      alpha[r] = expf(m_row[r] - m_new);
      float p = expf(sv - m_new);
      l_row[r] = l_row[r] * alpha[r] + warp_sum(p);
      m_row[r] = m_new;
      // K6: l keeps the undropped sum, only P·V takes the mask
      if (DROP && qi < T_len && kj < kvl)
        p *= drop_keep(drop, dbase, qi, kj);
      sP[(warp * RQ + r) * kBK + lane] = p;
    }
    __syncthreads();  // every warp is done with the K tile
    load_rows(sKV, DK, vb, k0, kBK, 1.f);
    __syncthreads();

    // O = O * alpha + P · V; this lane's columns are lane + 32·m
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int m = 0; m < NC; ++m) o[r][m] *= alpha[r];
    const float4* p4 = reinterpret_cast<const float4*>(sP + warp * RQ * kBK);
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int c = lane + 32 * m;
          vv[jj][m] = c < D ? sKV[(j + jj) * DK + c] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 pr = p4[r * (kBK / 4) + j / 4];
#pragma unroll
        for (int m = 0; m < NC; ++m)
          o[r][m] += pr.x * vv[0][m] + pr.y * vv[1][m] + pr.z * vv[2][m]
                   + pr.w * vv[3][m];
      }
    }
  }

  float* ob = out + bh * T_len * D;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + warp * RQ + r;
    if (qi >= T_len) continue;
    const float inv_l = 1.f / fmaxf(l_row[r], 1e-30f);
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = lane + 32 * m;
      if (c < D) ob[(size_t)qi * D + c] = o[r][m] * inv_l;
    }
    if (lse != nullptr && lane == 0)
      lse[bh * T_len + qi] = m_row[r] + logf(fmaxf(l_row[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim > 128 (the Conformer's 384): the same online softmax with
// both products on the tensor cores (WMMA 16×16×16, f32 accumulators) and
// the output accumulator in shared memory. Each warp owns 16 query rows.
// ---------------------------------------------------------------------------

template <int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ bias,
               const float* __restrict__ gate,
               const int* __restrict__ kv_len, bf16* __restrict__ out,
               float* __restrict__ lse, int H, int T_len, int D,
               float scale, Dropout drop) {
  constexpr int BQ = 16 * NW;
  constexpr int BK = kBK;
  constexpr int NT = NW * 32;
  constexpr int SP = BK + 4;   // f32 pitch of scores / PV scratch
  constexpr int PP = BK + 8;   // bf16 pitch of P
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;        // bf16 pitch of the Q/K/V tiles
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][DP]
  bf16* sK = sQ + BQ * DP;                         // [BK][DP]
  bf16* sV = sK + BK * DP;                         // [BK][DP]
  bf16* sP = sV + BK * DP;                         // [BQ][PP]
  float* sS = reinterpret_cast<float*>(sP + BQ * PP);  // [BQ][SP]
  float* sO = sS + BQ * SP;                        // [BQ][D] accumulator
  float* sA = sO + BQ * D;                         // [BQ] alpha, then 1/l

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * 16;    // this warp's first row in the block
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * T_len * D;
  const bf16* kb = k + bh * T_len * D;
  const bf16* vb = v + bh * T_len * D;
  const int kvl = kv_len[b];
  const int v8 = D / 8;        // 16-byte vectors per row
  const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;

  // rows [row0, row0 + n) of a [T, D] matrix into a DP-pitched tile,
  // zero past T
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int n) {
    for (int idx = tid; idx < n * v8; idx += NT) {
      const int r = idx / v8, c = (idx - r * v8) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < T_len)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
    }
  };

  load_rows(sQ, qb, q0, BQ);
  for (int idx = tid; idx < BQ * D; idx += NT) sO[idx] = 0.f;
  float m_row[16], l_row[16], g_row[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = q0 + wr + r;
    m_row[r] = kNegInf;
    l_row[r] = 0.f;
    g_row[r] = (gate != nullptr && qi < T_len) ? gate[bh * T_len + qi] : 1.f;
  }

  const int n_kt = (kvl + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(sK, kb, k0, BK);
    load_rows(sV, vb, k0, BK);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int kd = 0; kd < D; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + wr * DP + kd, DP);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + j * 16 * DP + kd, DP);
          wmma::mma_sync(acc[j], a, bk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(sS + wr * SP + j * 16, acc[j], SP,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp's lanes
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r, qi = q0 + row;
      float vals[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int c = lane + 32 * t, kj = k0 + c;
        float sv = sS[row * SP + c] * scale;
        if (bias != nullptr) {
          const float bv = (qi < T_len && kj < T_len)
              ? to_f(bias[((size_t)h * T_len + qi) * T_len + kj]) : 0.f;
          sv += gate != nullptr ? g_row[r] * bv : bv;
        }
        if (kj >= kvl) sv = kNegInf;
        vals[t] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m_row[r], warp_max(mx));
      const float alpha = expf(m_row[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int kj = k0 + lane + 32 * t;
        float p = expf(vals[t] - m_new);
        ps += p;
        // K6: masked in f32 before the bf16 P of P·V, after the row sum
        if (DROP && qi < T_len && kj < kvl)
          p *= drop_keep(drop, dbase, qi, kj);
        sP[row * PP + lane + 32 * t] = from_f<bf16>(p);
      }
      l_row[r] = l_row[r] * alpha + warp_sum(ps);
      m_row[r] = m_new;
      if (lane == 0) sA[row] = alpha;
    }
    __syncwarp();

    // O = O * alpha + P V, BK output columns at a time through scratch
    for (int c0 = 0; c0 < D; c0 += BK) {
      const int nf = min(BK, D - c0) / 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sP + wr * PP + kk, PP);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          if (j >= nf) continue;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, sV + kk * DP + c0 + j * 16, DP);
          wmma::mma_sync(acc[j], a, bv, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        if (j < nf)
          wmma::store_matrix_sync(sS + wr * SP + j * 16, acc[j], SP,
                                  wmma::mem_row_major);
      __syncwarp();
      const int w = nf * 16;
      for (int e = lane; e < 16 * w; e += 32) {
        const int row = wr + e / w, c = e % w;
        float* o = sO + row * D + c0 + c;
        *o = *o * sA[row] + sS[row * SP + c];
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (lane == 0) sA[wr + r] = 1.f / fmaxf(l_row[r], 1e-30f);
    const int qi = q0 + wr + r;
    if (lse != nullptr && lane == 0 && qi < T_len)
      lse[bh * T_len + qi] = m_row[r] + logf(fmaxf(l_row[r], 1e-30f));
  }
  __syncwarp();
  bf16* ob = out + bh * T_len * D;
  for (int e = lane; e < 16 * D; e += 32) {
    const int row = wr + e / D, c = e % D, qi = q0 + row;
    if (qi < T_len)
      ob[(size_t)qi * D + c] = from_f<bf16>(sO[row * D + c] * sA[row]);
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim ≤ 128: the FlashAttention-2 layout on mma.sync m16n8k16.
// Each of 4 warps owns 16 query rows; its Q fragments, scores, P and output
// accumulators stay in registers (P is re-packed from the score accumulators
// as the A operand of P·V), so shared memory holds only the Q, K and V tiles.
// A thread holds rows g = lane/4 and g + 8 of its warp's 16, and columns
// 2·(lane%4) + {0, 1} of each 8-wide tile; row statistics reduce over the
// 4 threads of a quad, and the row sum l stays per thread until the end.
// The mma.sync/ldmatrix helpers are in mma.cuh.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;
constexpr int kMmaBK = 64;

template <int D, bool DROP>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ bias,
              const float* __restrict__ gate, const int* __restrict__ kv_len,
              bf16* __restrict__ out, float* __restrict__ lse, int H,
              int T_len, float scale, Dropout drop) {
  constexpr int NT = kMmaWarps * 32;
  constexpr int DP = D + 8;        // bf16 pitch: 16-byte rows, no conflicts
  constexpr int KD = D / 16;       // k-steps of Q·Kᵀ
  constexpr int NS = kMmaBK / 8;   // 8-key score tiles
  constexpr int NO = D / 8;        // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][DP]
  bf16* sK = sQ + kMmaBQ * DP;                     // [BK][DP]
  bf16* sV = sK + kMmaBK * DP;                     // [BK][DP]

  const int q0 = blockIdx.x * kMmaBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * T_len * D;
  const bf16* kb = k + bh * T_len * D;
  const bf16* vb = v + bh * T_len * D;
  const int kvl = kv_len[b];
  const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;

  // rows [row0, row0 + n) of a [T, D] matrix into a DP-pitched tile, zero
  // past T
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int n) {
    constexpr int V8 = D / 8;
    for (int idx = tid; idx < n * V8; idx += NT) {
      const int r = idx / V8, c = (idx - r * V8) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < T_len)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
    }
  };

  load_rows(sQ, qb, q0, kMmaBQ);
  __syncthreads();
  unsigned qa[KD][4];
  {
    const bf16* base = sQ + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qa[kk], base + kk * 16);
  }

  int qrow[2];
  float m_row[2], l_row[2], g_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + warp * 16 + g + 8 * i;
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
    g_row[i] = (gate != nullptr && qrow[i] < T_len)
        ? gate[bh * T_len + qrow[i]] : 1.f;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int n_kt = (kvl + kMmaBK - 1) / kMmaBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(sK, kb, k0, kMmaBK);
    load_rows(sV, vb, k0, kMmaBK);
    __syncthreads();

    // S = Q Kᵀ: K rows are the col-major B operand as stored
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned bk[4];
        ldsm_x4(bk, sK + (n * 8 + (lane & 7) + (lane >> 4) * 8) * DP
                        + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[n], qa[kk], bk[0], bk[1]);
        mma16816(s[n + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // scale, gated bias, key mask; online softmax per row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kj = k0 + n * 8 + 2 * t + (e & 1);
        float sv = s[n][e] * scale;
        if (bias != nullptr) {
          const float bv = (qrow[i] < T_len && kj < T_len)
              ? to_f(bias[((size_t)h * T_len + qrow[i]) * T_len + kj]) : 0.f;
          sv += gate != nullptr ? g_row[i] * bv : bv;
        }
        if (kj >= kvl) sv = kNegInf;
        s[n][e] = sv;
        mx[i] = fmaxf(mx[i], sv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_row[i], quad_max(mx[i]));
      alpha[i] = expf(m_row[i] - m_new);
      m_row[i] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_row[e >> 1]);
        ps[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + ps[i];
    // K6, after the row sum: element e of score tile n is row qrow[e / 2],
    // key k0 + 8·n + 2·t + e % 2 (the accumulator layout of m16n8k16)
    if constexpr (DROP) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qrow[e >> 1], kj = k0 + n * 8 + 2 * t + (e & 1);
          if (qi < T_len && kj < kvl) s[n][e] *= drop_keep(drop, dbase, qi, kj);
        }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16, as the TPU kernel's p.astype(v.dtype))
    // from the score registers; V rows are the row-major B operand
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]),
          pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned bv[4];
        ldsm_x4_t(bv, sV + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP
                          + n * 8 + (lane >> 4) * 8);
        mma16816(o[n], pa, bv[0], bv[1]);
        mma16816(o[n + 1], pa, bv[2], bv[3]);
      }
    }
  }

  bf16* ob = out + bh * T_len * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_sum = quad_sum(l_row[i]);
    const float inv_l = 1.f / fmaxf(l_sum, 1e-30f);
    if (qrow[i] >= T_len) continue;
    if (lse != nullptr && t == 0)
      lse[bh * T_len + qrow[i]] = m_row[i] + logf(fmaxf(l_sum, 1e-30f));
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qrow[i] * D + n * 8
                                         + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] * inv_l, o[n][2 * i + 1] * inv_l);
  }
}

template <int D, bool DROP>
cudaError_t run_mma(const void* q, const void* k, const void* v,
                    const void* bias, const void* gate, const void* kv_len,
                    void* out, void* lse, int B, int H, int T_len,
                    float scale, Dropout drop, cudaStream_t stream) {
  dim3 grid((T_len + kMmaBQ - 1) / kMmaBQ, H, B);
  const size_t smem = sizeof(bf16) * (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8);
  return wfl::launch(flash_fwd_mma<D, DROP>, grid, dim3(kMmaWarps * 32), smem,
                     stream, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const bf16*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                     static_cast<float*>(lse), H, T_len, scale, drop);
}

size_t wmma_smem_bytes(int nw, int D) {
  const size_t bq = 16 * nw, dp = D + 8, bk = kBK;
  return sizeof(bf16) * (bq * dp + 2 * bk * dp + bq * (bk + 8)) +
         sizeof(float) * (bq * (bk + 4) + bq * D + bq);
}

template <int NW, bool DROP>
cudaError_t run_wmma(const void* q, const void* k, const void* v,
                     const void* bias, const void* gate, const void* kv_len,
                     void* out, void* lse, int B, int H, int T_len, int D,
                     float scale, Dropout drop, cudaStream_t stream) {
  dim3 grid((T_len + 16 * NW - 1) / (16 * NW), H, B);
  return wfl::launch(flash_fwd_wmma<NW, DROP>, grid, dim3(NW * 32),
                     wmma_smem_bytes(NW, D), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<const bf16*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                     static_cast<float*>(lse), H, T_len, D, scale, drop);
}

// Up to D=128 the register-resident mma.sync kernel (its output tile fits
// in registers); above (calls with a bias only), the WMMA kernel with
// 32-key tiles, and 2 warps (32 query rows) above D=384, so the staged
// tiles fit in 227 KB.
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const void* bias, const void* gate,
                          const void* kv_len, void* out, void* lse, int B,
                          int H, int T_len, int D, float scale, Dropout drop,
                          cudaStream_t s) {
#define WFL_MMA_CASE(d) \
  case d: return drop.seed ? run_mma<d, true>(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len, scale, drop, s) \
                           : run_mma<d, false>(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len, scale, drop, s);
  switch (D) {
    WFL_MMA_CASE(16) WFL_MMA_CASE(32) WFL_MMA_CASE(48) WFL_MMA_CASE(64)
    WFL_MMA_CASE(80) WFL_MMA_CASE(96) WFL_MMA_CASE(112) WFL_MMA_CASE(128)
    default: break;
  }
#undef WFL_MMA_CASE
#define WFL_WMMA(nw, dr) \
  return run_wmma<nw, dr>(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len, D, scale, drop, s)
  if (D <= 384) {
    if (drop.seed) WFL_WMMA(4, true);
    WFL_WMMA(4, false);
  }
  if (drop.seed) WFL_WMMA(2, true);
  WFL_WMMA(2, false);
#undef WFL_WMMA
}

template <int NC, bool DROP>
cudaError_t run_f32(const void* q, const void* k, const void* v,
                    const void* bias, const void* gate, const void* kv_len,
                    void* out, void* lse, int B, int H, int T_len, int D,
                    float scale, Dropout drop, cudaStream_t stream) {
  constexpr int BQ = f32_rows(NC) * kWarps;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  const size_t smem = sizeof(float) *
      ((size_t)BQ * D + (size_t)kBK * (D + 4) + (size_t)BQ * kBK);
  return wfl::launch(flash_fwd_f32<NC, DROP>, grid, dim3(kThreads), smem, stream,
                     static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const int*>(kv_len), static_cast<float*>(out),
                     static_cast<float*>(lse), H, T_len, D, scale, drop);
}

// One instantiation per ⌈D/32⌉ (D a multiple of 16 up to 512).
cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* bias, const void* gate,
                         const void* kv_len, void* out, void* lse, int B,
                         int H, int T_len, int D, float scale, Dropout drop,
                         cudaStream_t s) {
#define WFL_F32_CASE(nc) \
  case nc: return drop.seed ? run_f32<nc, true>(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len, D, scale, drop, s) \
                            : run_f32<nc, false>(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len, D, scale, drop, s);
  switch ((D + 31) / 32) {
    WFL_F32_CASE(1) WFL_F32_CASE(2) WFL_F32_CASE(3) WFL_F32_CASE(4)
    WFL_F32_CASE(5) WFL_F32_CASE(6) WFL_F32_CASE(7) WFL_F32_CASE(8)
    WFL_F32_CASE(9) WFL_F32_CASE(10) WFL_F32_CASE(11) WFL_F32_CASE(12)
    WFL_F32_CASE(13) WFL_F32_CASE(14) WFL_F32_CASE(15) WFL_F32_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef WFL_F32_CASE
}

// ---------------------------------------------------------------------------
// Backward (K2b with bias and gate, K1b without): two passes that recompute
// P = exp(S − LSE) tile by tile from the forward's row LSE, so nothing of
// size [B,H,T,T] is formed.
//
// Replaces wfl_asr_tpu/ops/pallas/flash_attention.py:_bwd_dkdv_kernel and
// _bwd_dq_kernel (K2b) and flash_attention_bwd.py:_bwd_dkdv_kernel and
// _bwd_dq_kernel (K1b); the TPU package keeps K1b apart only for grid order.
// Calls with a bias at head_dim 64 (K2b on the main path) run the
// tensor-core passes of attention_bwd_bias_mma.cu instead, bias-free calls
// at head_dim > 128 (K1b) the pair of attention_bwd_mma.cu; these kernels
// serve the other widths with a bias and bias-free widths up to 128.
//
// - dK/dV pass (flash_bwd_dkdv): one block per (key tile, h, b) loops over
//   the query tiles: S (gated bias, key mask before the exp), P, dP = dO·Vᵀ,
//   dS = P·(dP − delta), then dV += Pᵀ·dO and dK += dSᵀ·(Q·scale). Key
//   tiles wholly past kv_len write zeros and stop.
// - dQ pass (flash_bwd_dq): one block per (query tile, h) loops over b and,
//   inside, over the key tiles below kv_len[b]: dQ += dS·K·scale and
//   dGate[b,h,q] += Σ_k bias·dS. dBias[h,q,k] = Σ_b gate·dS is added into
//   the block's own [BQ, T] strip of the zero-filled f32 dBias by the thread
//   that owns each element, b after b: the TPU's revisited output block
//   (batch innermost) as a loop inside the block. Deterministic, no float
//   atomics, no [B,H,T,T] buffer; the price is B read-modify-writes of the
//   strip, 2·B·H·T²·4 bytes per call (1.7 GB at [8,12,1499,·], ≈ 0.5 ms at
//   3.35 TB/s), plus B reads of the bias in each pass.
//
// What bounds it on the card: 7 products of B·H·T²·D (S and dP in both
// passes, dV, dK, dQ), so operations, as in the forward. This first version
// runs them as f32 FMA loops from shared memory for both dtypes (bf16 is
// widened on load, everything accumulates in f32); each thread holds a
// register micro-tile of S/dP (RI×RJ) and of the dK/dV/dQ updates (2×4), so
// a shared-memory load feeds ~1.3-2 FMAs. Tensor cores (mma.sync/wgmma) are
// later work. Rows are pitched at D + 1 floats, so the threads of a warp,
// which own consecutive keys, read distinct banks. Tiles by D keep the
// staged rows within 227 KB: at D=384 (the Conformer) 16 keys × 32 queries
// (dK/dV, 197 KB) and 16 queries × 32 keys (dQ, 171 KB).
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;

// rows [row0, row0 + n) of a [T, D] matrix, times mul, into an f32 tile of
// pitch `pitch`; zero past T
template <typename T>
__device__ __forceinline__ void bwd_load(float* dst, int pitch, const T* src,
                                         int row0, int n, int T_len, int D,
                                         float mul) {
  for (int idx = threadIdx.x; idx < n * D; idx += kBwdThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * pitch + c] = row0 + r < T_len
        ? to_f(src[(size_t)(row0 + r) * D + c]) * mul : 0.f;
  }
}

// lse, delta and gate of query rows [q0, q0 + BQ) into sRow[0..3·BQ); rows
// past T get lse = delta = gate = 0 (their Q and dO rows are zero, so they
// add nothing)
template <int BQ>
__device__ __forceinline__ void bwd_rows(float* sRow, const float* lse,
                                         const float* delta,
                                         const float* gate, size_t bh,
                                         int q0, int T_len) {
  for (int i = threadIdx.x; i < BQ; i += kBwdThreads) {
    const int qi = q0 + i;
    const bool ok = qi < T_len;
    sRow[i] = ok ? lse[bh * T_len + qi] : 0.f;
    sRow[BQ + i] = ok ? delta[bh * T_len + qi] : 0.f;
    sRow[2 * BQ + i] = (ok && gate != nullptr) ? gate[bh * T_len + qi] : 0.f;
  }
}

// P and dS of one (query tile, key tile) pair from the staged tiles. Thread
// (ti, tj) = (tid / 16, tid % 16) owns query rows ti + 16·r and keys
// tj + 16·c. sQ holds q·scale. bv returns the bias values read (0 without
// bias). With DROP (dbase = drop_base of this (b, h)) p returns the
// dropped P·M and ds the dropped dS.
template <typename T, int BQ, int BK, bool DROP>
__device__ __forceinline__ void bwd_tile_ds(
    const float* sQ, const float* sDO, const float* sK, const float* sV,
    int DP, int D, const float* sRow, bool has_gate, const T* bias_h,
    int q0, int k0, int kvl, int T_len, const Dropout& drop, uint32_t dbase,
    float (&p)[BQ / 16][BK / 16], float (&ds)[BQ / 16][BK / 16],
    float (&bv)[BQ / 16][BK / 16]) {
  constexpr int RI = BQ / 16, RJ = BK / 16;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float s[RI][RJ], dp[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) s[r][c] = dp[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[RI], dov[RI], kv[RJ], vv[RJ];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      qv[r] = sQ[(ti + 16 * r) * DP + d];
      dov[r] = sDO[(ti + 16 * r) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      kv[c] = sK[(tj + 16 * c) * DP + d];
      vv[c] = sV[(tj + 16 * c) * DP + d];
    }
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        s[r][c] += qv[r] * kv[c];
        dp[r][c] += dov[r] * vv[c];
      }
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = ti + 16 * r, qi = q0 + i;
    const float lse = sRow[i], delta = sRow[BQ + i], g = sRow[2 * BQ + i];
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int kj = k0 + tj + 16 * c;
      float sv = s[r][c], b_ = 0.f;
      if (bias_h != nullptr) {
        b_ = (qi < T_len && kj < T_len)
            ? to_f(bias_h[(size_t)qi * T_len + kj]) : 0.f;
        sv += has_gate ? g * b_ : b_;
      }
      // mask before the exp: a masked key's raw score may exceed the LSE
      // by more than 88, and exp → inf, times 0, is NaN
      if (kj >= kvl) sv = kNegInf;
      const float pv = expf(sv - lse);
      // K6: the P that dV takes is P·M, and dS = P·(M·dP − delta); P, and
      // so the LSE, stay undropped
      const float ks = (DROP && qi < T_len && kj < kvl)
          ? drop_keep(drop, dbase, qi, kj) : 1.f;
      p[r][c] = pv * ks;
      ds[r][c] = pv * (dp[r][c] * ks - delta);
      bv[r][c] = b_;
    }
  }
}

template <typename T, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ bias,
               const float* __restrict__ gate, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kv_len, T* __restrict__ dk,
               T* __restrict__ dv, int H, int T_len, int D, float scale,
               Dropout drop) {
  constexpr int RI = BQ / 16, RJ = BK / 16, PP = BK + 1;
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sK = smem;                 // [BK][DP]
  float* sV = sK + BK * DP;         // [BK][DP]
  float* sQ = sV + BK * DP;         // [BQ][DP]  q * scale
  float* sDO = sQ + BQ * DP;        // [BQ][DP]
  float* sP = sDO + BQ * DP;        // [BQ][PP]
  float* sDS = sP + BQ * PP;        // [BQ][PP]
  float* sdK = sDS + BQ * PP;       // [BK][D]  accumulators
  float* sdV = sdK + BK * D;        // [BK][D]
  float* sRow = sdV + BK * D;       // [3][BQ]  lse, delta, gate

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * T_len * D;
  const int kvl = kv_len[b];
  if (k0 >= kvl) {      // no query attends these keys: zero gradients
    for (int idx = tid; idx < BK * D; idx += kBwdThreads) {
      const int r = idx / D;
      if (k0 + r < T_len) {
        dk[base + (size_t)k0 * D + idx] = from_f<T>(0.f);
        dv[base + (size_t)k0 * D + idx] = from_f<T>(0.f);
      }
    }
    return;
  }
  const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;
  bwd_load(sK, DP, k + base, k0, BK, T_len, D, 1.f);
  bwd_load(sV, DP, v + base, k0, BK, T_len, D, 1.f);
  for (int idx = tid; idx < 2 * BK * D; idx += kBwdThreads) sdK[idx] = 0.f;
  const T* bias_h = bias != nullptr ? bias + (size_t)h * T_len * T_len
                                    : nullptr;
  const int ti = tid >> 4, tj = tid & 15;
  const int nd = D / 4;

  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    __syncthreads();    // the previous tile's updates are done with sQ..sDS
    bwd_load(sQ, DP, q + base, q0, BQ, T_len, D, scale);
    bwd_load(sDO, DP, dout + base, q0, BQ, T_len, D, 1.f);
    bwd_rows<BQ>(sRow, lse, delta, gate, bh, q0, T_len);
    __syncthreads();
    float p[RI][RJ], ds[RI][RJ], bv[RI][RJ];
    bwd_tile_ds<T, BQ, BK, DROP>(sQ, sDO, sK, sV, DP, D, sRow,
                                 gate != nullptr, bias_h, q0, k0, kvl, T_len,
                                 drop, dbase, p, ds, bv);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        sP[(ti + 16 * r) * PP + tj + 16 * c] = p[r][c];
        sDS[(ti + 16 * r) * PP + tj + 16 * c] = ds[r][c];
      }
    __syncthreads();
    // dV += Pᵀ·dO, dK += dSᵀ·(q·scale): 2 keys × 4 columns a micro-tile
    for (int m = tid; m < (BK / 2) * nd; m += kBwdThreads) {
      const int jg = m / nd, dg = m - jg * nd;
      float av[2][4], ak[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const int e = (jg + (BK / 2) * jj) * D + dg + nd * dd;
          av[jj][dd] = sdV[e];
          ak[jj][dd] = sdK[e];
        }
      for (int i = 0; i < BQ; ++i) {
        float pv[2], dsv[2], dov[4], qv[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          pv[jj] = sP[i * PP + jg + (BK / 2) * jj];
          dsv[jj] = sDS[i * PP + jg + (BK / 2) * jj];
        }
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          dov[dd] = sDO[i * DP + dg + nd * dd];
          qv[dd] = sQ[i * DP + dg + nd * dd];
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) {
            av[jj][dd] += pv[jj] * dov[dd];
            ak[jj][dd] += dsv[jj] * qv[dd];
          }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const int e = (jg + (BK / 2) * jj) * D + dg + nd * dd;
          sdV[e] = av[jj][dd];
          sdK[e] = ak[jj][dd];
        }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BK * D; idx += kBwdThreads) {
    const int r = idx / D;
    if (k0 + r < T_len) {
      dk[base + (size_t)k0 * D + idx] = from_f<T>(sdK[idx]);
      dv[base + (size_t)k0 * D + idx] = from_f<T>(sdV[idx]);
    }
  }
}

template <typename T, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ bias,
             const float* __restrict__ gate, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ kv_len, T* __restrict__ dq,
             float* __restrict__ dgate, float* __restrict__ dbias, int B,
             int H, int T_len, int D, float scale, Dropout drop) {
  constexpr int RI = BQ / 16, RJ = BK / 16, PP = BK + 1;
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* sQ = smem;                 // [BQ][DP]  q * scale
  float* sDO = sQ + BQ * DP;        // [BQ][DP]
  float* sK = sDO + BQ * DP;        // [BK][DP]
  float* sV = sK + BK * DP;         // [BK][DP]
  float* sDS = sV + BK * DP;        // [BQ][PP]
  float* sdQ = sDS + BQ * PP;       // [BQ][D]  accumulator
  float* sRow = sdQ + BQ * D;       // [4][BQ]  lse, delta, gate, dGate

  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int nd = D / 4;
  const T* bias_h = bias != nullptr ? bias + (size_t)h * T_len * T_len
                                    : nullptr;
  float* dbias_h = dbias != nullptr ? dbias + (size_t)h * T_len * T_len
                                    : nullptr;
  const bool has_gate = gate != nullptr;

  for (int b = 0; b < B; ++b) {
    const size_t bh = (size_t)b * H + h;
    const size_t base = bh * T_len * D;
    const int kvl = kv_len[b];
    const uint32_t dbase = DROP ? drop_base(drop, b, h) : 0u;
    __syncthreads();    // the previous b's stores are done with sdQ/sRow
    bwd_load(sQ, DP, q + base, q0, BQ, T_len, D, scale);
    bwd_load(sDO, DP, dout + base, q0, BQ, T_len, D, 1.f);
    bwd_rows<BQ>(sRow, lse, delta, gate, bh, q0, T_len);
    for (int idx = tid; idx < BQ * D; idx += kBwdThreads) sdQ[idx] = 0.f;
    for (int i = tid; i < BQ; i += kBwdThreads) sRow[3 * BQ + i] = 0.f;

    for (int k0 = 0; k0 < kvl; k0 += BK) {
      __syncthreads();  // the previous key tile's dQ update is done
      bwd_load(sK, DP, k + base, k0, BK, T_len, D, 1.f);
      bwd_load(sV, DP, v + base, k0, BK, T_len, D, 1.f);
      __syncthreads();
      float p[RI][RJ], ds[RI][RJ], bv[RI][RJ];
      bwd_tile_ds<T, BQ, BK, DROP>(sQ, sDO, sK, sV, DP, D, sRow, has_gate,
                                   bias_h, q0, k0, kvl, T_len, drop, dbase,
                                   p, ds, bv);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = ti + 16 * r, qi = q0 + i;
        const float g = sRow[2 * BQ + i];
        float dg = 0.f;
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          const int kj = k0 + tj + 16 * c;
          sDS[i * PP + tj + 16 * c] = ds[r][c];
          dg += bv[r][c] * ds[r][c];
          // this thread owns dBias[h, qi, kj] for every b
          if (dbias_h != nullptr && qi < T_len && kj < T_len)
            dbias_h[(size_t)qi * T_len + kj] += has_gate ? g * ds[r][c]
                                                         : ds[r][c];
        }
        if (has_gate) {
          // Σ over the 16 threads of this row (lanes tj = 0..15)
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)
            dg += __shfl_xor_sync(0xffffffffu, dg, o);
          if (tj == 0) sRow[3 * BQ + i] += dg;
        }
      }
      __syncthreads();
      // dQ += dS·K (scale at the store): 2 rows × 4 columns a micro-tile
      for (int m = tid; m < (BQ / 2) * nd; m += kBwdThreads) {
        const int ig = m / nd, dg = m - ig * nd;
        float acc[2][4];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
            acc[ii][dd] = sdQ[(ig + (BQ / 2) * ii) * D + dg + nd * dd];
        for (int j = 0; j < BK; ++j) {
          float dsv[2], kv[4];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
            dsv[ii] = sDS[(ig + (BQ / 2) * ii) * PP + j];
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) kv[dd] = sK[j * DP + dg + nd * dd];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) acc[ii][dd] += dsv[ii] * kv[dd];
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
            sdQ[(ig + (BQ / 2) * ii) * D + dg + nd * dd] = acc[ii][dd];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * D; idx += kBwdThreads) {
      const int r = idx / D;
      if (q0 + r < T_len)
        dq[base + (size_t)q0 * D + idx] = from_f<T>(sdQ[idx] * scale);
    }
    if (has_gate)
      for (int i = tid; i < BQ; i += kBwdThreads)
        if (q0 + i < T_len) dgate[bh * T_len + q0 + i] = sRow[3 * BQ + i];
  }
}

template <typename T, int BQ, int BK, bool DROP>
cudaError_t run_dkdv(const void* q, const void* k, const void* v,
                     const void* bias, const void* gate, const void* dout,
                     const void* lse, const void* delta, const void* kv_len,
                     void* dk, void* dv, int B, int H, int T_len, int D,
                     float scale, Dropout drop, cudaStream_t stream) {
  const size_t dp = D + 1;
  const size_t smem = sizeof(float) *
      (2 * BK * dp + 2 * BQ * dp + 2 * BQ * (BK + 1) + 2 * BK * (size_t)D
       + 3 * BQ);
  dim3 grid((T_len + BK - 1) / BK, H, B);
  return wfl::launch(flash_bwd_dkdv<T, BQ, BK, DROP>, grid,
                     dim3(kBwdThreads), smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const T*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const T*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(kv_len), static_cast<T*>(dk),
                     static_cast<T*>(dv), H, T_len, D, scale, drop);
}

template <typename T, int BQ, int BK, bool DROP>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* bias, const void* gate, const void* dout,
                   const void* lse, const void* delta, const void* kv_len,
                   void* dq, void* dgate, void* dbias, int B, int H,
                   int T_len, int D, float scale, Dropout drop,
                   cudaStream_t stream) {
  const size_t dp = D + 1;
  const size_t smem = sizeof(float) *
      (2 * BQ * dp + 2 * BK * dp + BQ * (BK + 1) + BQ * (size_t)D + 4 * BQ);
  dim3 grid((T_len + BQ - 1) / BQ, H);
  return wfl::launch(flash_bwd_dq<T, BQ, BK, DROP>, grid,
                     dim3(kBwdThreads), smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const T*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const T*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(kv_len), static_cast<T*>(dq),
                     static_cast<float*>(dgate), static_cast<float*>(dbias),
                     B, H, T_len, D, scale, drop);
}

// Tiles by D (staged rows within 227 KB; the dQ pass's grid of
// ⌈T/BQ⌉·H blocks kept above the 132 SMs at the Conformer's 2 heads).
template <typename T, bool DROP>
cudaError_t dispatch_bwd_tiles(const void* q, const void* k, const void* v,
                               const void* bias, const void* gate,
                               const void* dout, const void* lse,
                               const void* delta, const void* kv_len,
                               void* dq, void* dk, void* dv, void* dgate,
                               void* dbias, int B, int H, int T_len, int D,
                               float scale, Dropout drop, cudaStream_t s) {
#define WFL_DKDV(bq, bk) \
  run_dkdv<T, bq, bk, DROP>(q, k, v, bias, gate, dout, lse, delta, kv_len, dk, dv, B, H, T_len, D, scale, drop, s)
#define WFL_DQ(bq, bk) \
  run_dq<T, bq, bk, DROP>(q, k, v, bias, gate, dout, lse, delta, kv_len, dq, dgate, dbias, B, H, T_len, D, scale, drop, s)
  cudaError_t err;
  if (D <= 64) err = WFL_DKDV(64, 64);
  else if (D <= 128) err = WFL_DKDV(64, 32);
  else if (D <= 384) err = WFL_DKDV(32, 16);
  else err = WFL_DKDV(16, 16);
  if (err != cudaSuccess) return err;
  if (D <= 128) return WFL_DQ(32, 64);
  if (D <= 384) return WFL_DQ(16, 32);
  return WFL_DQ(16, 16);
#undef WFL_DKDV
#undef WFL_DQ
}

// The dropout hash is compiled in only when a seed is given.
template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* gate,
                         const void* dout, const void* lse,
                         const void* delta, const void* kv_len, void* dq,
                         void* dk, void* dv, void* dgate, void* dbias,
                         int B, int H, int T_len, int D, float scale,
                         Dropout drop, cudaStream_t s) {
  return drop.seed
      ? dispatch_bwd_tiles<T, true>(q, k, v, bias, gate, dout, lse, delta,
                                    kv_len, dq, dk, dv, dgate, dbias, B, H,
                                    T_len, D, scale, drop, s)
      : dispatch_bwd_tiles<T, false>(q, k, v, bias, gate, dout, lse, delta,
                                     kv_len, dq, dk, dv, dgate, dbias, B, H,
                                     T_len, D, scale, drop, s);
}

}  // namespace

using namespace wfl;

// q, k, v, out: [B, H, T, D] contiguous, D a multiple of 16 up to 512;
// dtype 0 = f32 (FMA kernel), 1 = bf16 (tensor-core kernels), the tiles
// chosen by D. bias: [H, T, T] of the same dtype or null; gate: [B, H, T]
// f32 or null; kv_len: [B] int32 in [1, T]. lse: [B, H, T] f32, written
// (the row's logsumexp of the scaled, biased, masked scores) when not null.
// seed: one int32 on the device, or null for no dropout; with it, attention
// probabilities are dropped (K6): kept iff the hash of (seed, b, h, q, k)
// is >= drop_thr, and scaled by drop_scale. Returns the launch's
// cudaError_t.
extern "C" int wfl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* gate, const void* kv_len,
                                       void* out, void* lse, const void* seed,
                                       int B, int H, int T_len, int D,
                                       float scale, int drop_thr,
                                       float drop_scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || D > 512) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32)
    return dispatch_f32(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len,
                        D, scale, drop, s);
  if (dtype == kBF16)
    return dispatch_bf16(q, k, v, bias, gate, kv_len, out, lse, B, H, T_len,
                         D, scale, drop, s);
  return cudaErrorInvalidValue;
}

// The backward of wfl_flash_attention_fwd: both passes, in order, on one
// stream. q, k, v, dout, dq, dk, dv: [B, H, T, D] of the dtype; bias [H, T,
// T] of the dtype or null; gate [B, H, T] f32 or null; lse and delta =
// rowsum(dO·O) [B, H, T] f32; kv_len [B] int32 in [1, T]; seed, drop_thr
// and drop_scale as the forward's. dgate [B, H, T] f32 (null without gate);
// dbias [H, T, T] f32, zero-filled by the caller (null without bias).
extern "C" int wfl_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, const void* dout, const void* lse, const void* delta,
    const void* kv_len, const void* seed, void* dq, void* dk, void* dv,
    void* dgate, void* dbias, int B, int H, int T_len, int D, float scale,
    int drop_thr, float drop_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || D > 512) return cudaErrorInvalidValue;
  const Dropout drop{static_cast<const int*>(seed), drop_thr, drop_scale};
  if (dtype == kF32)
    return dispatch_bwd<float>(q, k, v, bias, gate, dout, lse, delta, kv_len,
                               dq, dk, dv, dgate, dbias, B, H, T_len, D,
                               scale, drop, s);
  if (dtype == kBF16)
    return dispatch_bwd<bf16>(q, k, v, bias, gate, dout, lse, delta, kv_len,
                              dq, dk, dv, dgate, dbias, B, H, T_len, D, scale,
                              drop, s);
  return cudaErrorInvalidValue;
}
