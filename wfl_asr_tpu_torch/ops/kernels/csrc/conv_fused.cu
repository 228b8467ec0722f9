// One stride-2 VALID Conv1d layer (C → C, k ∈ {2, 3}, no bias) with exact
// GELU, channels-last [B, T, C], on the tensor cores, for Hopper (sm_90a):
//
//   out[b, t, n] = gelu( Σ_{j<k} Σ_c xin[b, 2t + j, c] · W[n, c, j] )
//
// rounded to the activation dtype; optionally xin = gelu(((x − mean)·inv)·
// scale + bias) per (b, c) in f32, rounded to the dtype (the WavLM layer-0
// GroupNorm application, on the first layer of chain 1).
//
// Replaces wfl_asr_tpu/ops/pallas/conv_fused.py:_kernel (:135) and its
// batch-packing variant _kernel_packed (:91), the kernels of
// _fused_conv_impl's pallas_call (K5): WavLM feature-encoder layers 1-3 and
// 4-6. conv_fused.py:fused_conv_chain launches this kernel once per layer of
// a chain; the intermediates go through device memory in the activation
// dtype, which is the TPU kernel's rounding of every layer (:173).
//
// What bounds it on the card: operations. At B = 8 × 30 s layer 1 (95999 →
// 47999 rows) is 604 GFLOP against 1.18 GB of input, output and weights in
// bf16: 0.61 ms at 989 TFLOP/s against 0.35 ms at 3.35 TB/s, and 3.66 ms
// against 0.71 ms in f32 (three TF32 products at 495 TFLOP/s); every later
// layer keeps that ratio. So fusing the layers, as the kernel before this
// one did, saves bytes that do not bound it and costs what does: the whole
// chain had to be resident in one block's shared memory, which left 7-11
// output rows a block, weights re-read from L2 for every block and used
// against 1-3 row tiles, and a fifth of the MMA rows spent on padding. One
// properly tiled GEMM a layer keeps the sum of the per-layer bounds, which
// is the fused bound.
//
// Design (one launch a layer, an implicit GEMM with M = T_out rows of one
// batch row, N = C, K = k·C):
// - Block tile of 128 output rows of one batch row × bn output channels
//   (Tiles): bf16 256 channels, 8 warps of 64 rows × 64 channels; f32 128
//   channels, 8 warps of 64 × 32 (its fresh sums double the accumulators).
//   Grid (N tile, M tile, b), the N tile fastest, so the blocks that share
//   one input tile run together and read it from device memory once.
// - K loop over 64-byte slices of the input channels (32 bf16, 16 f32).
//   A stage holds the 2·128 + k − 2 input rows of the block (one staged
//   tile serves all k taps: tap j of output row m is staged row 2m + j) and
//   the k × bn weight rows [tap][c_out][c_in] (pack_weights) of the slice,
//   copied by 16-byte cp.async, each thread its fixed chunk column and
//   rows at offsets computed once (Stager); rows past T_in, channels past
//   C and output channels past C arrive as zeros (src-size 0). A ring of 3
//   (bf16, 195 KB) or 4 (f32, 164 KB) stages keeps the copies of the next
//   slices in flight while one is multiplied; one barrier a slice.
// - Layout of a staged tile (swz): two 64-byte rows a 128-byte line, the
//   line's eight 16-byte chunks XOR-permuted by the line index mod 8. The
//   eight row addresses of one ldmatrix are output rows m..m+7 of one tap,
//   i.e. staged rows two apart: eight consecutive lines, one half each, so
//   the permutation spreads them over all eight chunk positions of the
//   banks; the weight rows of one ldmatrix (eight consecutive output
//   channels: four lines, both halves) land on eight distinct positions as
//   well. A plain row-major tile put all eight stride-2 rows on the same
//   banks (8-way); even/odd planes would have needed a second layout for
//   the weights, and this one serves both operands with no padding. The
//   permutation is a function of the unpermuted offset, so a fragment's
//   address is its lane's offset plus a constant, then the XOR: addressing
//   the fragments by a table of permuted offsets held 48 more registers
//   and spilled.
// - Products on mma.sync: bf16 m16n8k16 with f32 accumulators; f32 as three
//   TF32 m16n8k8 products of hi/lo halves split on use
//   (attention_mma.cuh: PolF32::split), each slice's products summed into
//   fresh registers and added in f32 (the tensor core truncates what it
//   adds into a live accumulator).
// - The layer-0 norm and GELU (NORM), in place on the staged input: each
//   thread normalises the chunks it copied itself (so its own cp.async wait
//   suffices), slice kt + 1 while slice kt is multiplied, with no barrier
//   of its own. It costs one erf per input element per N tile: on an H100
//   (chip_smoke.py, kernel_variants_ab.py) in bf16 1.4 ms of layer 1's 3.3
//   ms at 256 channels a block (2.6 ms at 128, the reason for the wider
//   bf16 tile), about what a separate normalising pass costs; in f32, at
//   128 channels, 3.3 of 12.5 ms, where a separate pass would save ~2 ms.
// - Epilogue: the f32 sums through a tile in the ring's space, then exact
//   GELU, rounded to the dtype, stored as 16-byte rows: output rows past
//   T_out and channels past C are never written. (GELU on the accumulators
//   in registers, before the tile, spilled at bf16's 128 accumulators.)
#include "common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace wfl;
using bf16 = __nv_bfloat16;

// One 16-byte chunk of the tiles is 8 bf16 or 4 f32; a staged row is 4
// chunks (64 bytes), a K slice of BK = 64 / sizeof(T) channels.
constexpr int kRowChunks = 4;
constexpr int kMaxK = 3;

// The permutation on the unpermuted byte offset o = 64·r + 16·c of chunk c
// (0..3) of staged row r in a 1024-byte aligned tile: rows 2i and 2i + 1
// share 128-byte line i, whose 8 chunk positions (bits 4-6) are XORed with
// i % 8 (bits 7-9). A fragment's address is then its lane's offset plus a
// constant, permuted: one add and the XOR, with no table of per-lane
// offsets to keep in registers.
__device__ __forceinline__ unsigned swz(unsigned o) {
  return o ^ ((o >> 3) & 0x70);
}

// Per-dtype fragments, at unpermuted byte offsets within the stage's tiles.
// a_lane / b_lane: the lane's part of the offset. load_a at a_lane + 128·m0
// + 64·j + 32·s: the A fragment of output rows [m0, m0 + 16) for tap j,
// k-step s of the slice (staged rows 2m + j); load_b2 at b_lane + 64·r0 +
// 32·s: the B fragments of weight rows [r0, r0 + 16) (two 8-channel tiles),
// k-step s.
struct OpBF16 {
  using T = bf16;
  static constexpr bool kFresh = false;
  struct A { unsigned r[4]; };
  struct B { unsigned r[2]; };
  __device__ static unsigned a_lane(int lane) {
    return 128 * (lane & 15) + 16 * (lane >> 4);
  }
  __device__ static unsigned b_lane(int lane) {
    return 64 * ((lane & 7) + ((lane >> 4) << 3)) + 16 * ((lane >> 3) & 1);
  }
  __device__ static void load_a(A& a, const unsigned char* s, unsigned o) {
    ldsm_x4(a.r, s + swz(o));
  }
  __device__ static void load_b2(B& b0, B& b1, const unsigned char* s,
                                 unsigned o) {
    unsigned r[4];
    ldsm_x4(r, s + swz(o));
    b0.r[0] = r[0]; b0.r[1] = r[1];
    b1.r[0] = r[2]; b1.r[1] = r[3];
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma16816(c, a.r, b.r[0], b.r[1]);
  }
};

struct OpF32 {
  using T = float;
  static constexpr bool kFresh = true;
  struct A { unsigned hi[4], lo[4]; };
  struct B { unsigned hi[2], lo[2]; };
  // an 8×8 b16 matrix of ldmatrix is 8 rows of 4 floats: lane (g, t)
  // receives float t of row g, the TF32 A and [n][k] B fragment layout
  __device__ static unsigned a_lane(int lane) {
    const int m = lane >> 3;
    return 128 * ((lane & 7) + 8 * (m & 1)) + 16 * (m >> 1);
  }
  __device__ static unsigned b_lane(int lane) {
    const int m = lane >> 3;
    return 64 * ((lane & 7) + 8 * (m >> 1)) + 16 * (m & 1);
  }
  __device__ static void load_a(A& a, const unsigned char* s, unsigned o) {
    unsigned r[4];
    ldsm_x4(r, s + swz(o));
    PolF32::split4(r, a.hi, a.lo);
  }
  __device__ static void load_b2(B& b0, B& b1, const unsigned char* s,
                                 unsigned o) {
    unsigned r[4], hi[4], lo[4];
    ldsm_x4(r, s + swz(o));
    PolF32::split4(r, hi, lo);
    b0.hi[0] = hi[0]; b0.hi[1] = hi[1]; b0.lo[0] = lo[0]; b0.lo[1] = lo[1];
    b1.hi[0] = hi[2]; b1.hi[1] = hi[3]; b1.lo[0] = lo[2]; b1.lo[1] = lo[3];
  }
  // the small terms first
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma1688_tf32(c, a.lo, b.hi);
    mma1688_tf32(c, a.hi, b.lo);
    mma1688_tf32(c, a.hi, b.hi);
  }
};

// Tiles per dtype: output rows and channels a block, warps along N (a
// warp owns 64 rows × bn / wn channels), stages of the ring, blocks a SM
// the registers are bounded for.
template <class Op> struct Tiles;
template <> struct Tiles<OpBF16> { static constexpr int bm = 128, bn = 256, wn = 4, stages = 3, blocks = 1; };
template <> struct Tiles<OpF32> { static constexpr int bm = 128, bn = 128, wn = 4, stages = 4, blocks = 1; };

template <class Op>
struct Cfg : Tiles<Op> {
  using T = typename Op::T;
  using Tiles<Op>::bm;
  using Tiles<Op>::bn;
  using Tiles<Op>::wn;
  using Tiles<Op>::stages;
  static constexpr int vec = 16 / sizeof(T);          // elements a chunk
  static constexpr int bk = kRowChunks * vec;         // channels a slice
  static constexpr int wm = bm / 64;                  // warps along M
  static constexpr int ni = bn / wn / 8;              // 8-channel tiles a warp
  static constexpr int threads = 32 * wm * wn;
  // each tile on 1024 bytes, where swz's lines mod 8 start
  static constexpr int a_bytes = ((2 * bm + kMaxK - 1) / 2 * 128 + 1023)
                                 / 1024 * 1024;
  static constexpr int b_bytes = kMaxK * bn / 2 * 128;
  static constexpr int stage_bytes = a_bytes + b_bytes;
  // f32 epilogue tile: rows 8 banks apart, so a warp's float2 stores of
  // rows g, columns 2t fall on distinct banks in each half
  static constexpr int out_pitch = bn + 8;
  static constexpr int ring = stages * stage_bytes;
  static constexpr int out_bytes = bm * out_pitch * (int)sizeof(float);
  static constexpr int smem = ring > out_bytes ? ring : out_bytes;
  static_assert(bm % 64 == 0 && bn % (16 * wn) == 0, "whole warp tiles");
  static_assert(threads % kRowChunks == 0, "a thread keeps its chunk column");
  static_assert(stages >= 3, "the norm's slice, the products' and a copy");
  static_assert(stage_bytes % 1024 == 0, "swz needs 1024-byte tiles");
};

struct Args {
  const void* x;            // [B, T_in, C]
  const void* w;            // [k, C, C]: tap, c_out, c_in
  void* out;                // [B, T_out, C]
  const float* mean;        // [B, C]; null: no input norm
  const float* inv;         // [B, C]
  const float* scale;       // [C]
  const float* bias;        // [C]
  int T_in, T_out, C;
};

// A thread's share of the copies: one chunk column cc = tid % 4 and the
// rows r0 + RP·i (r0 = tid / 4, RP = threads / 4) of the stage's input
// rows and weight rows. RP / 2 lines are a multiple of 8, so row r0 + RP·i
// lies at swz(64·r0 + 16·cc) + 64·RP·i bytes. The source pointers move by
// one slice of channels a stage.
template <class Op, int K>
struct Stager {
  using C_ = Cfg<Op>;
  using T = typename Op::T;
  static constexpr int RP = C_::threads / kRowChunks;
  static constexpr int nA = 2 * C_::bm + K - 2;       // input rows
  static_assert(RP % 16 == 0 && C_::bn % RP == 0, "whole lines a pass");
  const T* xa;      // input row r0 of the block, channel cc·vec
  const T* wb;      // weight row (tap 0, output channel n0 + r0), cc·vec
  int dst;          // swz(64·r0 + 16·cc)
  int a_rows;       // input rows from r0 to T_in
  int n_left;       // output channels from n0 + r0 to C
  int ch;           // cc·vec

  __device__ Stager(const Args& a, int b, int in0, int n0) {
    const int r0 = threadIdx.x / kRowChunks, cc = threadIdx.x % kRowChunks;
    ch = cc * C_::vec;
    dst = swz(64 * r0 + 16 * cc);
    a_rows = a.T_in - in0 - r0;
    n_left = a.C - n0 - r0;
    xa = static_cast<const T*>(a.x) + ((size_t)b * a.T_in + in0 + r0) * a.C
         + ch;
    wb = static_cast<const T*>(a.w) + (size_t)(n0 + r0) * a.C + ch;
  }

  // Copy K slice c0 into one stage: rows past T_in, output channels past C
  // and channels past C as zeros (src-size 0).
  __device__ __forceinline__ void copy(unsigned char* sa, unsigned char* sb,
                                       const Args& a, int c0) const {
    const bool ch_ok = c0 + ch < a.C;
    const size_t pass_a = (size_t)RP * a.C, tap = (size_t)a.C * a.C;
#pragma unroll
    for (int i = 0; i * RP < nA; ++i) {
      if (threadIdx.x / kRowChunks + i * RP >= nA) break;
      const bool ok = ch_ok && i * RP < a_rows;
      cp_async16(sa + dst + 64 * RP * i, ok ? xa + i * pass_a + c0 : a.x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < K * C_::bn / RP; ++i) {
      const int j = i * RP / C_::bn, nn = i * RP % C_::bn;
      const bool ok = ch_ok && nn < n_left;
      cp_async16(sb + dst + 64 * RP * i,
                 ok ? wb + j * tap + (size_t)nn * a.C + c0 : a.w,
                 ok ? 16 : 0);
    }
  }

  // The layer-0 norm and GELU on the staged input of K slice c0, in place:
  // rows below T_in and channels below C (the zero fill elsewhere stays).
  __device__ __forceinline__ void norm(unsigned char* sa, const Args& a,
                                       int b, int c0) const {
    constexpr int V = C_::vec;
    const int c = c0 + ch;
    if (c >= a.C) return;
    // the chunk's channels' statistics, 16 bytes a load (the wrapper gives
    // 16-byte aligned rows, and c is a multiple of 4)
    float mu[V], iv[V], sc[V], bi[V];
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const size_t bc = (size_t)b * a.C + c + e;
      *reinterpret_cast<float4*>(mu + e) =
          __ldg(reinterpret_cast<const float4*>(a.mean + bc));
      *reinterpret_cast<float4*>(iv + e) =
          __ldg(reinterpret_cast<const float4*>(a.inv + bc));
      *reinterpret_cast<float4*>(sc + e) =
          __ldg(reinterpret_cast<const float4*>(a.scale + c + e));
      *reinterpret_cast<float4*>(bi + e) =
          __ldg(reinterpret_cast<const float4*>(a.bias + c + e));
    }
#pragma unroll
    for (int i = 0; i * RP < nA; ++i) {
      if (threadIdx.x / kRowChunks + i * RP >= nA || i * RP >= a_rows) break;
      uint4* p = reinterpret_cast<uint4*>(sa + dst + 64 * RP * i);
      uint4 v = *p;
      T* el = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float y = __fmul_rn(__fsub_rn(to_f(el[e]), mu[e]), iv[e]);
        el[e] = from_f<T>(gelu_f(__fadd_rn(__fmul_rn(y, sc[e]), bi[e])));
      }
      *p = v;
    }
  }
};

// The products of one staged K slice: every tap, every k-step, the warp's
// 4 × NI tiles of 16 rows × 8 channels. oa, ob: the unpermuted offsets of
// the warp's first A and B fragments in the stage (lane parts included).
template <class Op, int K, int NI = Cfg<Op>::ni>
__device__ __forceinline__ void slice_products(float (&d)[4][NI][4],
                                               const unsigned char* smem,
                                               unsigned oa, unsigned ob) {
  using C_ = Cfg<Op>;
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      typename Op::B bf[NI];
#pragma unroll
      for (int p = 0; p < NI / 2; ++p)
        Op::load_b2(bf[2 * p], bf[2 * p + 1], smem,
                    ob + 64 * (j * C_::bn + 16 * p) + 32 * ks);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        typename Op::A af;
        Op::load_a(af, smem, oa + 128 * 16 * mi + 64 * j + 32 * ks);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) Op::mma(d[mi][ni], af, bf[ni]);
      }
    }
  }
}

// Block (N-tile, M-tile, b): output rows [m0, m0 + bm) of batch row b,
// channels [n0, n0 + bn). Warp (wm, wn) owns rows 64·wm + [0, 64) and
// channels WN·wn + [0, WN), WN = bn / Tiles::wn; lane (g, t) holds rows g
// and g + 8 and channels 2t + {0, 1} of each 16 × 8 tile.
template <class Op, int K, bool NORM>
__global__ void __launch_bounds__(Cfg<Op>::threads, Cfg<Op>::blocks)
conv_layer_mma(const Args a) {
  using C_ = Cfg<Op>;
  using T = typename Op::T;
  constexpr int S = C_::stages, NI = C_::ni, WN = 8 * NI;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C_::wn, wn = warp % C_::wn;
  const int n0 = blockIdx.x * C_::bn, m0 = blockIdx.y * C_::bm;
  const int b = blockIdx.z, in0 = 2 * m0;
  const int KT = (a.C + C_::bk - 1) / C_::bk;
  auto sa = [&](int s) { return smem + s * C_::stage_bytes; };
  auto sb = [&](int s) { return smem + s * C_::stage_bytes + C_::a_bytes; };
  // the warp's fragment offsets in a stage (slot 0)
  const unsigned oa = Op::a_lane(lane) + 128 * 64 * wm;
  const unsigned ob = C_::a_bytes + Op::b_lane(lane) + 64 * WN * wn;

  const Stager<Op, K> st(a, b, in0, n0);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) st.copy(sa(s), sb(s), a, s * C_::bk);
    cp_async_commit();
  }
  // With the norm, slice kt + 1 is normalised while slice kt is multiplied:
  // each iteration waits for one slice more, and the first is normalised
  // here.
  constexpr int L = NORM ? 1 : 0;
  if constexpr (NORM) {
    cp_async_wait<S - 2>();
    __syncthreads();
    st.norm(sa(0), a, b, 0);
  }
  float acc[4][NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2 - L>();   // slices up to kt + L have landed here
    __syncthreads();              // ... everywhere (and slice kt is
                                  // normalised); slot kt − 1 is free
    const int next = kt + S - 1;
    if (next < KT) st.copy(sa(next % S), sb(next % S), a, next * C_::bk);
    cp_async_commit();
    if constexpr (NORM) {
      if (kt + 1 < KT) st.norm(sa((kt + 1) % S), a, b, (kt + 1) * C_::bk);
    }
    const int slot = kt % S;
    if constexpr (Op::kFresh) {
      float y[4][NI][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[mi][ni][e] = 0.f;
      slice_products<Op, K>(y, smem, oa + slot * C_::stage_bytes,
                            ob + slot * C_::stage_bytes);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += y[mi][ni][e];
    } else {
      slice_products<Op, K>(acc, smem, oa + slot * C_::stage_bytes,
                            ob + slot * C_::stage_bytes);
    }
  }

  // epilogue: the f32 sums through a [bm × bn] tile in the ring's space,
  // then GELU, rounded, stored as 16-byte rows (the GELU's temporaries do
  // not meet the accumulators in registers)
  cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int P = C_::out_pitch;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int r = 64 * wm + 16 * mi + g, c = WN * wn + 8 * ni + 2 * t;
      *reinterpret_cast<float2*>(tile + r * P + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * P + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  constexpr int V = C_::vec, RC = C_::bn / V;         // chunks an output row
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.T_out + m0) * a.C + n0;
  for (int idx = threadIdx.x; idx < C_::bm * RC; idx += C_::threads) {
    const int r = idx / RC, c = (idx % RC) * V;
    if (m0 + r >= a.T_out || n0 + c >= a.C) continue;
    uint4 v;
    T* el = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(tile + r * P + c + e);
      el[e] = from_f<T>(gelu_f(f.x));
      el[e + 1] = from_f<T>(gelu_f(f.y));
      el[e + 2] = from_f<T>(gelu_f(f.z));
      el[e + 3] = from_f<T>(gelu_f(f.w));
    }
    *reinterpret_cast<uint4*>(out + (size_t)r * a.C + c) = v;
  }
}

template <class Op, int K, bool NORM>
cudaError_t run(const Args& a, int B, cudaStream_t stream) {
  using C_ = Cfg<Op>;
  dim3 grid((a.C + C_::bn - 1) / C_::bn, (a.T_out + C_::bm - 1) / C_::bm, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  return launch(conv_layer_mma<Op, K, NORM>, grid, dim3(C_::threads),
                C_::smem, stream, a);
}

template <class Op>
cudaError_t run_k(const Args& a, int B, int k, bool norm,
                  cudaStream_t stream) {
  if (k == 3)
    return norm ? run<Op, 3, true>(a, B, stream)
                : run<Op, 3, false>(a, B, stream);
  return norm ? run<Op, 2, true>(a, B, stream)
              : run<Op, 2, false>(a, B, stream);
}

}  // namespace

using namespace wfl;

// One layer. x: [B, T_in, C], out: [B, T_out, C] contiguous and 16-byte
// aligned, T_out = (T_in − k) / 2 + 1 ≥ 1, dtype 0 = f32 (C % 4 == 0),
// 1 = bf16 (C % 16 == 0). w: [k][C][C] (tap, c_out, c_in) of the same
// dtype. mean/inv: [B, C] f32, scale/bias: [C] f32, all null for no input
// norm. Returns the launch's cudaError_t.
extern "C" int wfl_conv_layer_fwd(const void* x, const void* w, void* out,
                                  int B, int T_in, int T_out, int C, int k,
                                  const float* mean, const float* inv,
                                  const float* scale, const float* nbias,
                                  int dtype, void* stream) {
  const bool norm = mean != nullptr;
  if ((k != 2 && k != 3) || B < 1 || T_out < 1
      || T_out != (T_in - k) / 2 + 1 || C < 1
      || norm != (inv != nullptr) || norm != (scale != nullptr)
      || norm != (nbias != nullptr))
    return cudaErrorInvalidValue;
  Args a{x, w, out, mean, inv, scale, nbias, T_in, T_out, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && C % 4 == 0) return run_k<OpF32>(a, B, k, norm, s);
  if (dtype == kBF16 && C % 16 == 0) return run_k<OpBF16>(a, B, k, norm, s);
  return cudaErrorInvalidValue;
}
