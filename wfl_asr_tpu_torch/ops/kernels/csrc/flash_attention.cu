// Flash attention forward with an optional shared additive bias, a per-query
// gate and a key-length mask, for Hopper (sm_90a).
//
//   out[b,h,q,:] = softmax_k( (q*scale)·k + gate[b,h,q]·bias[h,q,k],
//                             keys k >= kv_len[b] set to -1e30 ) · v
//
// Replaces two TPU kernels with one template:
// - wfl_asr_tpu/ops/pallas/flash_attention.py:_flash_kernel (with bias and
//   gate; WavLM's gated relative-position attention), and
// - wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:_fwd_kernel (no bias;
//   the Conformer attention). The TPU package split them only for grid
//   order and VMEM; the math is the same.
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
#include <mma.h>

#include "common.cuh"

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

template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ gate, const int* __restrict__ kv_len,
              float* __restrict__ out, int H, int T_len, int D, float scale) {
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
      const float p = expf(sv - m_new);
      l_row[r] = l_row[r] * alpha[r] + warp_sum(p);
      m_row[r] = m_new;
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
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim > 128 (the Conformer's 384): the same online softmax with
// both products on the tensor cores (WMMA 16×16×16, f32 accumulators) and
// the output accumulator in shared memory. Each warp owns 16 query rows.
// ---------------------------------------------------------------------------

template <int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ bias,
               const float* __restrict__ gate,
               const int* __restrict__ kv_len, bf16* __restrict__ out,
               int H, int T_len, int D, float scale) {
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
        const float p = expf(vals[t] - m_new);
        ps += p;
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
  for (int r = 0; r < 16; ++r)
    if (lane == 0) sA[wr + r] = 1.f / fmaxf(l_row[r], 1e-30f);
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
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a · b for one m16n8k16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;
constexpr int kMmaBK = 64;

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ bias,
              const float* __restrict__ gate, const int* __restrict__ kv_len,
              bf16* __restrict__ out, int H, int T_len, float scale) {
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
    const float inv_l = 1.f / fmaxf(quad_sum(l_row[i]), 1e-30f);
    if (qrow[i] >= T_len) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qrow[i] * D + n * 8
                                         + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] * inv_l, o[n][2 * i + 1] * inv_l);
  }
}

template <int D>
cudaError_t run_mma(const void* q, const void* k, const void* v,
                    const void* bias, const void* gate, const void* kv_len,
                    void* out, int B, int H, int T_len, float scale,
                    cudaStream_t stream) {
  dim3 grid((T_len + kMmaBQ - 1) / kMmaBQ, H, B);
  const size_t smem = sizeof(bf16) * (size_t)(kMmaBQ + 2 * kMmaBK) * (D + 8);
  return wfl::launch(flash_fwd_mma<D>, grid, dim3(kMmaWarps * 32), smem,
                     stream, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const bf16*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                     H, T_len, scale);
}

size_t wmma_smem_bytes(int nw, int D) {
  const size_t bq = 16 * nw, dp = D + 8, bk = kBK;
  return sizeof(bf16) * (bq * dp + 2 * bk * dp + bq * (bk + 8)) +
         sizeof(float) * (bq * (bk + 4) + bq * D + bq);
}

template <int NW>
cudaError_t run_wmma(const void* q, const void* k, const void* v,
                     const void* bias, const void* gate, const void* kv_len,
                     void* out, int B, int H, int T_len, int D, float scale,
                     cudaStream_t stream) {
  dim3 grid((T_len + 16 * NW - 1) / (16 * NW), H, B);
  return wfl::launch(flash_fwd_wmma<NW>, grid, dim3(NW * 32),
                     wmma_smem_bytes(NW, D), stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<const bf16*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                     H, T_len, D, scale);
}

// Up to D=128 the register-resident mma.sync kernel (its output tile fits
// in registers); above, the WMMA kernel with 32-key tiles, and 2 warps (32
// query rows) above D=384, so the staged tiles fit in 227 KB.
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const void* bias, const void* gate,
                          const void* kv_len, void* out, int B, int H,
                          int T_len, int D, float scale, cudaStream_t s) {
#define WFL_MMA_CASE(d) \
  case d: return run_mma<d>(q, k, v, bias, gate, kv_len, out, B, H, T_len, scale, s);
  switch (D) {
    WFL_MMA_CASE(16) WFL_MMA_CASE(32) WFL_MMA_CASE(48) WFL_MMA_CASE(64)
    WFL_MMA_CASE(80) WFL_MMA_CASE(96) WFL_MMA_CASE(112) WFL_MMA_CASE(128)
    default: break;
  }
#undef WFL_MMA_CASE
  if (D <= 384)
    return run_wmma<4>(q, k, v, bias, gate, kv_len, out, B, H, T_len, D, scale, s);
  return run_wmma<2>(q, k, v, bias, gate, kv_len, out, B, H, T_len, D, scale, s);
}

template <int NC>
cudaError_t run_f32(const void* q, const void* k, const void* v,
                    const void* bias, const void* gate, const void* kv_len,
                    void* out, int B, int H, int T_len, int D, float scale,
                    cudaStream_t stream) {
  constexpr int BQ = f32_rows(NC) * kWarps;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  const size_t smem = sizeof(float) *
      ((size_t)BQ * D + (size_t)kBK * (D + 4) + (size_t)BQ * kBK);
  return wfl::launch(flash_fwd_f32<NC>, grid, dim3(kThreads), smem, stream,
                     static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(gate),
                     static_cast<const int*>(kv_len), static_cast<float*>(out),
                     H, T_len, D, scale);
}

// One instantiation per ⌈D/32⌉ (D a multiple of 16 up to 512).
cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* bias, const void* gate,
                         const void* kv_len, void* out, int B, int H,
                         int T_len, int D, float scale, cudaStream_t s) {
#define WFL_F32_CASE(nc) \
  case nc: return run_f32<nc>(q, k, v, bias, gate, kv_len, out, B, H, T_len, D, scale, s);
  switch ((D + 31) / 32) {
    WFL_F32_CASE(1) WFL_F32_CASE(2) WFL_F32_CASE(3) WFL_F32_CASE(4)
    WFL_F32_CASE(5) WFL_F32_CASE(6) WFL_F32_CASE(7) WFL_F32_CASE(8)
    WFL_F32_CASE(9) WFL_F32_CASE(10) WFL_F32_CASE(11) WFL_F32_CASE(12)
    WFL_F32_CASE(13) WFL_F32_CASE(14) WFL_F32_CASE(15) WFL_F32_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef WFL_F32_CASE
}

}  // namespace

using namespace wfl;

// q, k, v, out: [B, H, T, D] contiguous, D a multiple of 16 up to 512;
// dtype 0 = f32 (FMA kernel), 1 = bf16 (tensor-core kernels), the tiles
// chosen by D. bias: [H, T, T] of the same dtype or null; gate: [B, H, T]
// f32 or null; kv_len: [B] int32 in [1, T]. Returns the launch's
// cudaError_t.
extern "C" int wfl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* gate, const void* kv_len,
                                       void* out, int B, int H, int T_len,
                                       int D, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 != 0 || D > 512) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return dispatch_f32(q, k, v, bias, gate, kv_len, out, B, H, T_len, D,
                        scale, s);
  if (dtype == kBF16)
    return dispatch_bf16(q, k, v, bias, gate, kv_len, out, B, H, T_len, D,
                         scale, s);
  return cudaErrorInvalidValue;
}
