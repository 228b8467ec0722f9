// Tensor-core tiles of the attention kernels (sm_90a): the operand policies,
// which lay out shared-memory tiles and run one mma step in bf16 (m16n8k16)
// or in f32 as three TF32 m16n8k8 products of split operands, and the
// staging, product and store helpers written once over them. Used by
// attention_fwd_mma.cu (bias-free forward, head_dim > 128),
// attention_fwd_bias_mma.cu (gated-bias forward, head_dim 64),
// attention_bwd_mma.cu (bias-free backward, head_dim > 128) and
// attention_bwd_bias_mma.cu (gated-bias backward, head_dim 64).
//
// Thread-strided loops take the block's thread count as NTHREADS.
#pragma once

#include "mma.cuh"

namespace wfl {

// ---------------------------------------------------------------------------
// Operand policies. A tile is row-major in shared memory with a pitch of
// pitch(cols) elements; at(p, r, c) is the element offset of (r, c); the
// score tiles written by the kernel itself use pitch_s and at_s.
// - load_a: the A fragment (16 rows from r0, KS columns from k0) of a score
//   tile (Pᵀ, dSᵀ, dS), whose rows are the product's rows.
// - load_ak: the same of a D-wide tile (K, V, Q, dO: at).
// - load_bk2: the B fragments (8 × KS) of two adjacent 8-column tiles of a
//   D-wide tile stored as [n][k] (K's rows in S = Q·Kᵀ).
// - load_bt: the B fragment (KS × 8) of a D-wide tile stored as [k][n]
//   (dO's rows in dV += Pᵀ·dO); load_bt2 that of two adjacent 8-column
//   tiles.
// - a_from_acc: the A fragment of a score tile the warp holds in
//   accumulator registers (P and dS of a 16 × 16 tile), with no trip
//   through shared memory; load_bt2_acc the B fragments in its k order.
// - store2_split / load_a_split<LO>: a score tile written once and read as
//   the A operand many times (the forward's P): f32 stores it as TF32 hi
//   halves in columns [0, LO) and lo halves in [LO, 2·LO), split once, and
//   reads them with no split; bf16 stores and reads it as it is.
// ---------------------------------------------------------------------------

struct PolBF16 {
  using T = __nv_bfloat16;
  static constexpr int KS = 16;          // k depth of one mma
  static constexpr int kVec = 8;         // elements in 16 bytes
  struct A { unsigned r[4]; };
  struct B { unsigned r[2]; };

  // 16-byte rows that are not a multiple of 128 bytes apart: the 8 row
  // addresses of each ldmatrix fall on distinct banks
  __host__ __device__ static constexpr int pitch(int cols) { return cols + 8; }
  __device__ static int at(int p, int r, int c) { return r * p + c; }
  // the score tiles (Pᵀ, dSᵀ, dS) use the same layout
  __host__ __device__ static constexpr int pitch_s(int cols) {
    return pitch(cols);
  }
  __device__ static int at_s(int p, int r, int c) { return at(p, r, c); }

  __device__ static void load_a(A& a, const T* t, int p, int r0, int k0) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(a.r, t + (r0 + (lane & 15)) * p + k0 + (lane >> 4) * 8);
  }
  __device__ static void load_ak(A& a, const T* t, int p, int r0, int k0) {
    load_a(a, t, p, r0, k0);
  }
  __device__ static void load_bk2(B& b0, B& b1, const T* t, int p, int n0,
                                  int k0) {
    const int lane = threadIdx.x & 31;
    unsigned r[4];
    ldsm_x4(r, t + (n0 + (lane & 7) + (lane >> 4) * 8) * p + k0
                   + ((lane >> 3) & 1) * 8);
    b0.r[0] = r[0]; b0.r[1] = r[1];
    b1.r[0] = r[2]; b1.r[1] = r[3];
  }
  __device__ static void load_bt(B& b, const T* t, int p, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    ldsm_x2_t(b.r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * p + n0);
  }
  __device__ static void load_bt2(B& b0, B& b1, const T* t, int p, int k0,
                                  int n0) {
    const int lane = threadIdx.x & 31;
    unsigned r[4];
    ldsm_x4_t(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * p + n0
                     + (lane >> 4) * 8);
    b0.r[0] = r[0]; b0.r[1] = r[1];
    b1.r[0] = r[2]; b1.r[1] = r[3];
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma16816(c, a.r, b.r[0], b.r[1]);
  }
  // The A fragment of k-step s of a 16 × 16 tile held in registers as two
  // 8-column accumulator tiles c[n] (element e: row g + 8·(e/2), column
  // 8n + 2·(lane%4) + e%2): the m16n8k16 A layout is the accumulator
  // layout, in the natural column order (one k-step, s = 0).
  static constexpr int kStepsAcc = 1;
  __device__ static void a_from_acc(A& a, const float (&c)[2][4], int) {
    a.r[0] = pack_bf16(c[0][0], c[0][1]);
    a.r[1] = pack_bf16(c[0][2], c[0][3]);
    a.r[2] = pack_bf16(c[1][0], c[1][1]);
    a.r[3] = pack_bf16(c[1][2], c[1][3]);
  }
  // the B fragments that match a_from_acc's k order: rows k0 + k
  __device__ static void load_bt2_acc(B& b0, B& b1, const T* t, int p,
                                      int k0, int n0) {
    load_bt2(b0, b1, t, p, k0, n0);
  }
  // (r, c) and (r, c + 1), c even
  __device__ static void store2(T* t, int p, int r, int c, float v0,
                                float v1) {
    *reinterpret_cast<unsigned*>(t + at_s(p, r, c)) = pack_bf16(v0, v1);
  }
  template <int LO>
  __device__ static void store2_split(T* t, int p, int r, int c, float v0,
                                      float v1) {
    store2(t, p, r, c, v0, v1);
  }
  template <int LO>
  __device__ static void load_a_split(A& a, const T* t, int p, int r0,
                                      int k0) {
    load_a(a, t, p, r0, k0);
  }
};

struct PolF32 {
  using T = float;
  static constexpr int KS = 8;
  static constexpr int kVec = 4;
  struct A { unsigned hi[4], lo[4]; };
  struct B { unsigned hi[2], lo[2]; };

  // Streamed and resident tiles (Q, dO, K, V) are read both plainly (A and
  // [n][k] B fragments: row g, column t over g < 8, t < 4) and transposed
  // ([k][n] B fragments: row t, column g). Rows are 8 floats more than a
  // multiple of 32 apart, and rows with bit 2 set start 4 floats in, so row
  // r starts on bank sh(r) = 8·(r % 4) + 4·((r / 4) % 2): plain reads fall
  // on banks sh(g) + t, transposed ones on 8·t + g (rows t < 4) or
  // 8·t + 4 + g (rows t + 4), all 32 distinct. The shift is additive in the
  // column, so with a pitch fixed per kernel every offset of an unrolled
  // loop is an immediate, and 16-byte rows stay whole.
  __host__ __device__ static constexpr int pitch(int cols) {
    return (cols + 31) / 32 * 32 + 8;
  }
  __device__ static int at(int p, int r, int c) { return r * p + (r & 4) + c; }
  // The score tiles (Pᵀ, dSᵀ, dS) are only read plainly: rows 32 floats
  // apart, columns XOR-swizzled in 4-float steps by sh(r).
  __host__ __device__ static constexpr int pitch_s(int cols) {
    return (cols + 31) / 32 * 32;
  }
  __device__ static int at_s(int p, int r, int c) {
    return r * p + (c ^ (((r & 3) << 3) | (r & 4)));
  }
  // hi = x rounded to nearest TF32 by integer ops (cvt.rna.tf32 runs at
  // a quarter of the ALU rate and was the f32 kernels' limit), lo = x − hi
  // exact in f32; the mma reads lo's top 10 mantissa bits (truncation,
  // ≤ 2⁻²²·|x|)
  __device__ static void split(float x, unsigned& hi, unsigned& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }

  // Plain reads by ldmatrix: an 8×8 matrix of 16-bit values is 8 rows of 4
  // floats, of which lane (g, t) receives float t of row g, the TF32 A and
  // [n][k] B fragment layout; lane l gives a row address of matrix l / 8.
  // Each 16-byte row chunk stays whole under both layouts, and the 8 rows
  // of a matrix start on 8 distinct 4-bank groups.
  __device__ static void split4(const unsigned (&r)[4], unsigned (&hi)[4],
                                unsigned (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[i], lo[i]);
  }
  __device__ static void load_a(A& a, const T* t, int p, int r0, int k0) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    unsigned r[4];
    ldsm_x4(r, t + at_s(p, r0 + (lane & 7) + 8 * (m & 1), k0 + 4 * (m >> 1)));
    split4(r, a.hi, a.lo);
  }
  __device__ static void load_ak(A& a, const T* t, int p, int r0, int k0) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    unsigned r[4];
    ldsm_x4(r, t + at(p, r0 + (lane & 7) + 8 * (m & 1), k0 + 4 * (m >> 1)));
    split4(r, a.hi, a.lo);
  }
  __device__ static void load_bk2(B& b0, B& b1, const T* t, int p, int n0,
                                  int k0) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    unsigned r[4], hi[4], lo[4];
    ldsm_x4(r, t + at(p, n0 + (lane & 7) + 8 * (m >> 1), k0 + 4 * (m & 1)));
    split4(r, hi, lo);
    b0.hi[0] = hi[0]; b0.hi[1] = hi[1]; b0.lo[0] = lo[0]; b0.lo[1] = lo[1];
    b1.hi[0] = hi[2]; b1.hi[1] = hi[3]; b1.lo[0] = lo[2]; b1.lo[1] = lo[3];
  }
  __device__ static void load_bt(B& b, const T* t, int p, int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    split(t[at(p, k0 + c, n0 + g)], b.hi[0], b.lo[0]);
    split(t[at(p, k0 + c + 4, n0 + g)], b.hi[1], b.lo[1]);
  }
  __device__ static void load_bt2(B& b0, B& b1, const T* t, int p, int k0,
                                  int n0) {
    load_bt(b0, t, p, k0, n0);
    load_bt(b1, t, p, k0, n0 + 8);
  }
  // the small terms first
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma1688_tf32(c, a.lo, b.hi);
    mma1688_tf32(c, a.hi, b.lo);
    mma1688_tf32(c, a.hi, b.hi);
  }
  // The A fragment of k-step s (8-column accumulator tile s) of a 16 × 16
  // tile held in registers as c[2][4] (see PolBF16::a_from_acc). The
  // m16n8k8 A layout puts k = lane%4 and lane%4 + 4 in a lane, the
  // accumulator columns 2·(lane%4) and 2·(lane%4) + 1, so k-index t stands
  // for column 2t and t + 4 for 2t + 1: no shuffles, and load_bt2_acc reads
  // the B rows in that order.
  static constexpr int kStepsAcc = 2;
  __device__ static void a_from_acc(A& a, const float (&c)[2][4], int s) {
    split(c[s][0], a.hi[0], a.lo[0]);      // (g, t)      = (g, 2t)
    split(c[s][2], a.hi[1], a.lo[1]);      // (g + 8, t)  = (g + 8, 2t)
    split(c[s][1], a.hi[2], a.lo[2]);      // (g, t + 4)  = (g, 2t + 1)
    split(c[s][3], a.hi[3], a.lo[3]);      // (g + 8, t + 4)
  }
  __device__ static void load_bt_acc(B& b, const T* t, int p, int k0,
                                     int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    split(t[at(p, k0 + 2 * c, n0 + g)], b.hi[0], b.lo[0]);
    split(t[at(p, k0 + 2 * c + 1, n0 + g)], b.hi[1], b.lo[1]);
  }
  __device__ static void load_bt2_acc(B& b0, B& b1, const T* t, int p,
                                      int k0, int n0) {
    load_bt_acc(b0, t, p, k0, n0);
    load_bt_acc(b1, t, p, k0, n0 + 8);
  }
  __device__ static void store2(T* t, int p, int r, int c, float v0,
                                float v1) {
    *reinterpret_cast<float2*>(t + at_s(p, r, c)) = make_float2(v0, v1);
  }
  template <int LO>
  __device__ static void store2_split(T* t, int p, int r, int c, float v0,
                                      float v1) {
    unsigned h0, l0, h1, l1;
    split(v0, h0, l0);
    split(v1, h1, l1);
    store2(t, p, r, c, __uint_as_float(h0), __uint_as_float(h1));
    store2(t, p, r, c + LO, __uint_as_float(l0), __uint_as_float(l1));
  }
  // load_a's reads of both halves, without its split
  template <int LO>
  __device__ static void load_a_split(A& a, const T* t, int p, int r0,
                                      int k0) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    const int r = r0 + (lane & 7) + 8 * (m & 1), c = k0 + 4 * (m >> 1);
    ldsm_x4(a.hi, t + at_s(p, r, c));
    ldsm_x4(a.lo, t + at_s(p, r, c + LO));
  }
};

// rows [row0, row0 + n) of a [T, D] matrix into a tile of pitch p by
// 16-byte cp.async; rows past T are zero-filled
template <class Pol, int NTHREADS>
__device__ __forceinline__ void stage_rows(typename Pol::T* dst, int p,
                                           const typename Pol::T* src,
                                           int row0, int n, int T_len, int D) {
  const int nv = D / Pol::kVec;
  for (int idx = threadIdx.x; idx < n * nv; idx += NTHREADS) {
    const int r = idx / nv, c = (idx - r * nv) * Pol::kVec;
    const bool ok = row0 + r < T_len;
    cp_async16(dst + Pol::at(p, r, c),
               ok ? src + (size_t)(row0 + r) * D + c : src, ok ? 16 : 0);
  }
}

// The same by a row a warp at a time, the lanes on consecutive 16-byte
// chunks: no division by the row length for every chunk, which stalled the
// forward's warps longer on staging than the copies themselves. A row of
// fewer than 32 chunks (D = 64: 8 in bf16, 16 in f32) is one of several
// that a warp stages at once, a group of lanes each.
template <class Pol, int NWARPS>
__device__ __forceinline__ void stage_rows_by_warp(typename Pol::T* dst,
                                                   int p,
                                                   const typename Pol::T* src,
                                                   int row0, int n, int T_len,
                                                   int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = D / Pol::kVec;                  // chunks a row
  const int rows = nv < 32 ? 32 / nv : 1;        // rows a warp at once
  const int sub = rows > 1 ? lane / nv : 0;      // this lane's row of them
  if (sub >= rows) return;                       // lanes past rows · nv
  const int c0 = (lane - sub * nv) * Pol::kVec;
  const int step = rows > 1 ? D : 32 * Pol::kVec;
  for (int r = warp * rows + sub; r < n; r += NWARPS * rows) {
    const bool ok = row0 + r < T_len;
    const typename Pol::T* row = ok ? src + (size_t)(row0 + r) * D : src;
    for (int c = c0; c < D; c += step)
      cp_async16(dst + Pol::at(p, r, c), ok ? row + c : src, ok ? 16 : 0);
  }
}

// The element offset of p within its 16-byte chunk.
template <class T>
__device__ __forceinline__ int span_offset(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Columns [c0, c0 + W) of rows [row0, row0 + n) of a row-major matrix of
// row pitch ld that lies in [begin, end) (the [H, T, T] bias: rows T
// elements apart, so at odd T no row starts on 16 bytes), by 16-byte
// cp.async in the caller's copy group. Each row is copied as the 16-byte
// aligned span that covers its W elements, W·sizeof(T)/16 + 1 chunks, into
// a row of dst (pitch p, 16-byte rows); its element c0 + j lands at
// span_offset(&row[c0]) + j. A chunk that reaches past end copies its
// in-bounds bytes and cp.async's src-size zero-fills the rest; one that
// starts before begin (a base not on 16 bytes) is copied by plain loads,
// zero outside; rows past T_len are zero.
template <class T, int W, int NTHREADS>
__device__ __forceinline__ void stage_spans(T* dst, int p, const T* src,
                                            size_t ld, int row0, int c0,
                                            int n, int T_len, const T* begin,
                                            const T* end) {
  constexpr int kEl = 16 / sizeof(T), kChunks = W / kEl + 1;
  static_assert(W % kEl == 0, "a span is whole chunks");
  const uintptr_t lo = reinterpret_cast<uintptr_t>(begin);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(end);
  for (int idx = threadIdx.x; idx < n * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    T* d = dst + r * p + c * kEl;
    const uintptr_t at = (reinterpret_cast<uintptr_t>(
        src + (size_t)(row0 + r) * ld + c0) & ~uintptr_t(15)) + 16 * c;
    if (row0 + r >= T_len || at >= hi) {
      cp_async16(d, reinterpret_cast<const void*>(lo & ~uintptr_t(15)), 0);
    } else if (at >= lo) {
      const int bytes = hi - at < 16 ? static_cast<int>(hi - at) : 16;
      cp_async16(d, reinterpret_cast<const void*>(at), bytes);
    } else {
      const T* x = reinterpret_cast<const T*>(at);
#pragma unroll
      for (int j = 0; j < kEl; ++j)
        d[j] = x + j >= begin && x + j < end ? x[j] : from_f<T>(0.f);
    }
  }
}

// rows [row0, row0 + n) × columns [c0, c0 + W) of a matrix of row pitch ld
// into a score tile of pitch p (Pol::at_s) by 16-byte cp.async; rows past
// T are zero-filled
template <class Pol, int W, int NTHREADS>
__device__ __forceinline__ void stage_cols(typename Pol::T* dst, int p,
                                           const typename Pol::T* src,
                                           int row0, int c0, int n, int T_len,
                                           int ld) {
  constexpr int nv = W / Pol::kVec;
  for (int idx = threadIdx.x; idx < n * nv; idx += NTHREADS) {
    const int r = idx / nv, c = (idx - r * nv) * Pol::kVec;
    const bool ok = row0 + r < T_len;
    cp_async16(dst + Pol::at_s(p, r, c),
               ok ? src + (size_t)(row0 + r) * ld + c0 + c : src,
               ok ? 16 : 0);
  }
}

// lse and delta of rows [row0, row0 + n) into sL[0..n), sD[0..n) by 4-byte
// cp.async, in the caller's copy group; rows past T get 0 (their Q and dO
// rows are zero, and P is set to 0 there)
template <int NTHREADS>
__device__ __forceinline__ void stage_stats(float* sL, float* sD,
                                            const float* lse,
                                            const float* delta, size_t bh,
                                            int row0, int n, int T_len) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const bool ok = row0 + i < T_len;
    const size_t at = ok ? bh * T_len + row0 + i : 0;
    cp_async4(sL + i, lse + at, ok ? 4 : 0);
    cp_async4(sD + i, delta + at, ok ? 4 : 0);
  }
}

// This warp's part of one 16×16 tile of X = A·Bᵀ (two 8-column tiles):
// rows r0 of the A tile, columns c0 of the [n][k]-stored B tile, contracted
// over columns [kbeg, kend). Each 4 mma steps sum into fresh registers that
// are then added in f32: the tensor core's adds into a long-lived
// accumulator truncate.
template <class Pol>
__device__ __forceinline__ void score_part(float (&x)[2][4],
                                           const typename Pol::T* a_t,
                                           const typename Pol::T* b_t,
                                           int p, int r0, int c0, int kbeg,
                                           int kend) {
  constexpr int CH = 4 * Pol::KS;
#pragma unroll
  for (int e = 0; e < 4; ++e) x[0][e] = x[1][e] = 0.f;
#pragma unroll 2
  for (int kc = kbeg; kc < kend; kc += CH) {
    float y[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kd = kc; kd < kc + CH; kd += Pol::KS) {
      if (kd >= kend) break;
      typename Pol::A a;
      typename Pol::B b0, b1;
      Pol::load_ak(a, a_t, p, r0, kd);
      Pol::load_bk2(b0, b1, b_t, p, c0, kd);
      Pol::mma(y[0], a, b0);
      Pol::mma(y[1], a, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[0][e] += y[0][e];
      x[1][e] += y[1][e];
    }
  }
}

// acc[m][n] += A·B over the KDIM rows of B: A from the tile a_t (rows
// r0 + 16·m, m < MT; a score tile read by Pol::load_a, or with LO > 0 one
// written by store2_split<LO>), B from the [k][n]-stored tile b_t, the
// warp's 8-column tiles nt0 + n (n < npw, nt0 + n < NT); each B fragment
// serves the MT row tiles. Each mma step's product sums into fresh
// registers and is added to acc in f32 (see score_part), which also keeps
// the A fragments live; pairs of tiles share one ldmatrix in bf16. With
// ALPHA, acc = acc·α + A·B instead (alpha[m][i] is α of row
// r0 + 16·m + g + 8·i): f32 folds α into the first step's add; bf16
// rescales acc and lets the mma add into it, as its adds in fresh
// registers cost the forward 7 % of its device time and the rounding of a
// bf16 P dwarfs the truncation.
template <class Pol, int NPW, int KDIM, int MT, int LO = 0, bool ALPHA = false>
__device__ __forceinline__ void accumulate(
    float (&acc)[MT][NPW][4], const typename Pol::T* a_t, int pa, int r0,
    const typename Pol::T* b_t, int pb, int nt0, int npw, int NT,
    const float (*alpha)[2] = nullptr) {
  constexpr bool kInPlace = ALPHA && sizeof(typename Pol::T) == 2;
  if constexpr (kInPlace) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NPW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] *= alpha[m][e >> 1];
  }
#pragma unroll
  for (int kk = 0; kk < KDIM; kk += Pol::KS) {
    typename Pol::A a[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (LO > 0)
        Pol::template load_a_split<LO>(a[m], a_t, pa, r0 + 16 * m, kk);
      else
        Pol::load_a(a[m], a_t, pa, r0 + 16 * m, kk);
    }
#pragma unroll
    for (int n = 0; n < NPW; n += 2) {
      const int tile = nt0 + n;
      if (n >= npw || tile >= NT) break;
      typename Pol::B b0, b1;
      const bool pair = tile + 1 < NT;
      if (pair) Pol::load_bt2(b0, b1, b_t, pb, kk, tile * 8);
      else Pol::load_bt(b0, b_t, pb, kk, tile * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (kInPlace) {
          Pol::mma(acc[m][n], a[m], b0);
          if (pair) Pol::mma(acc[m][n + 1], a[m], b1);
        } else {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          Pol::mma(t0, a[m], b0);
          if (pair) Pol::mma(t1, a[m], b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (ALPHA && kk == 0) {
              const float al = alpha[m][e >> 1];
              acc[m][n][e] = fmaf(acc[m][n][e], al, t0[e]);
              if (pair) acc[m][n + 1][e] = fmaf(acc[m][n + 1][e], al, t1[e]);
            } else {
              acc[m][n][e] += t0[e];
              if (pair) acc[m][n + 1][e] += t1[e];
            }
          }
        }
      }
    }
  }
}

// acc += C·B for one 16 × 16 tile C that the warp holds in accumulator
// registers (P or dS; its columns are the contraction) and all NT 8-column
// tiles of the [k][n]-stored tile b_t, rows k0 + [0, 16). By default each
// mma step sums into fresh registers that are added to acc in f32 (see
// score_part); IN_PLACE lets the mma add into acc (see accumulate's ALPHA).
template <class Pol, int NT, bool IN_PLACE = false>
__device__ __forceinline__ void accumulate_held(
    float (&acc)[NT][4], const float (&c)[2][4], const typename Pol::T* b_t,
    int pb, int k0) {
#pragma unroll
  for (int st = 0; st < Pol::kStepsAcc; ++st) {
    typename Pol::A a;
    Pol::a_from_acc(a, c, st);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
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

// The warp's share of the D/8 column tiles: an even count, from nt0.
__device__ __forceinline__ int cols_per_warp(int NT, int slices) {
  const int n = (NT + slices - 1) / slices;
  return (n + 1) & ~1;
}

// acc (rows r0 + g, r0 + g + 8 of a [T, D] matrix, the warp's column
// tiles) times mul into out; rows past T are not stored
template <class T, int NPW>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[NPW][4],
                                          int row0, int nt0, int npw, int NT,
                                          int T_len, int D, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NPW; ++n) {
    if (n >= npw || nt0 + n >= NT) continue;
    const int c = (nt0 + n) * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r >= T_len) continue;
      const float v0 = acc[n][2 * i] * mul, v1 = acc[n][2 * i + 1] * mul;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(out + (size_t)r * D + c) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * D + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace wfl
