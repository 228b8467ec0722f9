// Fused chain of up to three stride-2 VALID Conv1d layers (no bias), exact
// GELU after each, channels-last [B, T, C], for Hopper (sm_90a).
//
// Replaces wfl_asr_tpu/ops/pallas/conv_fused.py:_kernel (and its TPU
// batch-packing variant _kernel_packed, the same math): WavLM feature-encoder
// layers 1-3 and 4-6. Optionally the chain's input first gets a
// per-(b, c) ``gelu(((x - mean) * inv) * scale + bias)`` — the layer-0
// GroupNorm application fused into the load.
//
// What bounds it on the card: chain 1 at B=8×30 s is ≈ 1.06e12 FLOPs
// against ≈ 0.9 GB (bf16) of input and output — bound by operations.
//
// Design (one launch per chain):
// - A block produces ``tile`` rows of the chain's last layer for one batch
//   row. The row counts of every stage are composed backwards from the tile
//   (n_in = 2·(n_out − 1) + k per layer, as conv_fused.py:85-88 and
//   266-271 do), the input rows are staged once in shared memory (with the
//   input norm + GELU applied on the way in), and every intermediate layer
//   stays in shared memory; only the last layer writes to device memory.
//   Intermediates are rounded to the activation type, as on the TPU.
// - A stride-2 conv layer is a matrix product whose A operand is the staged
//   input read with a leading dimension of 2·C: output row r, tap j reads
//   staged row 2r + j. bf16 runs it on the tensor cores (WMMA 16×16×16, f32
//   accumulators; 16 warps, each owning 2 column tiles × up to 4 row tiles,
//   with weight tiles from L2, the next step's loaded during this step's
//   products); f32 runs plain FMA loops (up to 32 rows × 2 output channels
//   of accumulators per thread, so each weight is read once per layer per
//   block), keeping full f32 precision.
// - bf16 stages keep even and odd rows in two planes with a row pitch of
//   C + 16: the A operand of tap j is then a plain row-major block of one
//   plane (rows R..R+15 of plane j&1, shifted by j>>1), every fragment base
//   stays 32-byte aligned, and the ldmatrix rows fall 32 bytes apart in the
//   banks (at most 2-way conflicts, where a 2·C pitch gave 8-way).
// - The wrapper picks the tile per dtype so the staged rows (padded to the
//   16-row tiles of the bf16 path) fit in 227 KB.
// - Input rows past T_in are never read (zero-filled); output rows past
//   T_out are never written.
// - Weights are pre-packed once by the wrapper as [k][C_in][C_out], so
//   weight loads are contiguous over output channels.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace wfl;
using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 3;
constexpr int kCPT = 2;   // f32 path: output channels per thread per pass
constexpr int kNF = 2;    // bf16 path: column tiles per warp
constexpr int kRG = 4;    // bf16 path: row tiles per accumulator group

// Threads per block: f32 runs 8 warps (2 output channels a thread cover
// 512), bf16 16, so that the weight loads of one warp overlap the work of
// the others.
template <typename T> struct Threads { static constexpr int n = 256; };
template <> struct Threads<bf16> { static constexpr int n = 512; };

struct Chain {
  const void* w[kMaxLayers];
  int k[kMaxLayers];
  int rows[kMaxLayers + 1];   // rows[l]: input rows of layer l; rows[L] = tile
  size_t offset[kMaxLayers + 1];  // element offset of stage l; [L]: scratch
  int half[kMaxLayers];       // bf16: rows per plane of stage l
  int pitch;                  // elements per staged row
  int n_layers;
};

// Row r of a staged layer: plain rows (f32), or even/odd planes (bf16).
template <typename T>
__device__ __forceinline__ T* stage_row(T* base, int r, int half, int pitch,
                                        bool planes) {
  return base + (size_t)(planes ? (r & 1) * half + (r >> 1) : r) * pitch;
}

// f32: out rows [0, n_out) of one layer, FMA loops. Each thread keeps RB
// rows × kCPT output channels in registers; the caller picks RB ≥ n_out
// where it can, so every weight is read once per layer per block. Four
// input channels are read per step (one 16-byte shared-memory load a row).
template <int NT, int RB>
__device__ void layer_fma(const float* in_s, const float* __restrict__ w,
                          int kk, int n_out, int C, float* out_s,
                          float* out_g, int out_valid) {
  const int tid = threadIdx.x;
  for (int cbase = 0; cbase < C; cbase += NT * kCPT) {
    for (int r0 = 0; r0 < n_out; r0 += RB) {
      float acc[RB][kCPT];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < kCPT; ++j) acc[i][j] = 0.f;
      for (int tap = 0; tap < kk; ++tap) {
#pragma unroll 2
        for (int ci = 0; ci < C; ci += 4) {
          float wv[4][kCPT];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* wrow = w + ((size_t)tap * C + ci + u) * C + cbase + tid;
#pragma unroll
            for (int j = 0; j < kCPT; ++j)
              wv[u][j] = (cbase + tid + j * NT < C) ? __ldg(wrow + j * NT) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const int r = r0 + i;
            float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < n_out)
              xv = *reinterpret_cast<const float4*>(
                  in_s + (size_t)(2 * r + tap) * C + ci);
#pragma unroll
            for (int j = 0; j < kCPT; ++j) {
              acc[i][j] += xv.x * wv[0][j];
              acc[i][j] += xv.y * wv[1][j];
              acc[i][j] += xv.z * wv[2][j];
              acc[i][j] += xv.w * wv[3][j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + i;
        if (r >= n_out) continue;
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          const int co = cbase + tid + j * NT;
          if (co >= C) continue;
          const float g = gelu_f(acc[i][j]);
          if (out_s != nullptr) out_s[(size_t)r * C + co] = g;
          else if (r < out_valid) out_g[(size_t)r * C + co] = g;
        }
      }
    }
  }
}

template <int NT>
__device__ void layer_fma_rows(const float* in_s, const float* w, int kk,
                               int n_out, int C, float* out_s, float* out_g,
                               int out_valid) {
  if (n_out > 16)
    layer_fma<NT, 32>(in_s, w, kk, n_out, C, out_s, out_g, out_valid);
  else if (n_out > 8)
    layer_fma<NT, 16>(in_s, w, kk, n_out, C, out_s, out_g, out_valid);
  else
    layer_fma<NT, 8>(in_s, w, kk, n_out, C, out_s, out_g, out_valid);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// bf16: out rows [0, round16(n_out)) of one layer on the tensor cores; rows
// >= n_out are computed from padding and dropped. scratch: 256 f32 per warp.
// The K loop runs over (tap, 16 input channels) steps; the weight fragments
// of the next step load while this step's products run.
template <int NW>
__device__ void layer_wmma(const bf16* in_s, int in_half,
                           const bf16* __restrict__ w, int kk, int n_out,
                           int C, int pitch, bf16* out_s, int out_half,
                           bf16* out_g, int out_valid, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int RT = (n_out + 15) / 16, CT = C / 16;
  const int ksteps = C / 16, steps = kk * ksteps;
  float* sc = scratch + warp * 256;
  for (int ct0 = warp * kNF; ct0 < CT; ct0 += NW * kNF) {
    auto load_b = [&](FragB (&bfr)[kNF], int s) {
      const int tap = s / ksteps, ci = (s - tap * ksteps) * 16;
#pragma unroll
      for (int j = 0; j < kNF; ++j)
        if (ct0 + j < CT)
          wmma::load_matrix_sync(
              bfr[j], w + ((size_t)tap * C + ci) * C + (ct0 + j) * 16, C);
    };
    for (int rt0 = 0; rt0 < RT; rt0 += kRG) {
      FragC acc[kRG][kNF];
#pragma unroll
      for (int i = 0; i < kRG; ++i)
#pragma unroll
        for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      auto mma_step = [&](const FragB (&bfr)[kNF], int s) {
        const int tap = s / ksteps, ci = (s - tap * ksteps) * 16;
#pragma unroll
        for (int i = 0; i < kRG; ++i) {
          if (rt0 + i >= RT) continue;
          FragA afr;
          // rows 2·(R + m) + tap: plane tap&1, rows R + m + tap>>1
          wmma::load_matrix_sync(
              afr, in_s + (size_t)((tap & 1) * in_half + 16 * (rt0 + i)
                                   + (tap >> 1)) * pitch + ci, pitch);
#pragma unroll
          for (int j = 0; j < kNF; ++j)
            if (ct0 + j < CT) wmma::mma_sync(acc[i][j], afr, bfr[j], acc[i][j]);
        }
      };
      FragB b0[kNF], b1[kNF];
      load_b(b0, 0);
      for (int s = 0; s < steps; s += 2) {
        if (s + 1 < steps) load_b(b1, s + 1);
        mma_step(b0, s);
        if (s + 1 >= steps) break;
        if (s + 2 < steps) load_b(b0, s + 2);
        mma_step(b1, s + 1);
      }
#pragma unroll
      for (int i = 0; i < kRG; ++i) {
#pragma unroll
        for (int j = 0; j < kNF; ++j) {
          if (rt0 + i >= RT || ct0 + j >= CT) continue;
          wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = (rt0 + i) * 16 + (e >> 4);
            const int co = (ct0 + j) * 16 + (e & 15);
            if (r >= n_out) continue;
            const bf16 g = from_f<bf16>(gelu_f(sc[e]));
            if (out_s != nullptr)
              stage_row(out_s, r, out_half, pitch, true)[co] = g;
            else if (r < out_valid) out_g[(size_t)r * C + co] = g;
          }
          __syncwarp();
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Threads<T>::n)
conv_chain_kernel(const T* __restrict__ x, T* __restrict__ out, Chain ch,
                  int T_in, int T_out, int C,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  const float* __restrict__ scale,
                  const float* __restrict__ nbias) {
  constexpr int NT = Threads<T>::n;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, b = blockIdx.y;
  const int L = ch.n_layers;
  const int tile = ch.rows[L];
  const int out0 = blockIdx.x * tile;
  const int in0 = out0 << L;  // first input row of this tile

  // stage 0: the chain's input rows (normalized + GELU when asked); rows
  // past T_in, and the padding up to the allocated rows, are zero
  constexpr bool planes = std::is_same<T, bf16>::value;
  T* s0 = smem + ch.offset[0];
  const int alloc0 = (int)((ch.offset[1] - ch.offset[0]) / ch.pitch);
  const T* xb = x + (size_t)b * T_in * C;
  for (int r = 0; r < alloc0; ++r) {
    const int row = in0 + r;
    for (int c = tid; c < C; c += NT) {
      float val = 0.f;
      if (r < ch.rows[0] && row < T_in) {
        val = to_f(xb[(size_t)row * C + c]);
        if (mean != nullptr) {
          val = (val - mean[(size_t)b * C + c]) * inv[(size_t)b * C + c];
          val = gelu_f(val * scale[c] + nbias[c]);
        }
      }
      stage_row(s0, r, ch.half[0], ch.pitch, planes)[c] = from_f<T>(val);
    }
  }

  for (int l = 0; l < L; ++l) {
    __syncthreads();  // stage l is complete
    const bool last = (l == L - 1);
    const int out_row0 = out0 << (L - 1 - l);  // global row of output 0
    T* out_s = last ? nullptr : smem + ch.offset[l + 1];
    T* out_g = out + ((size_t)b * T_out + out_row0) * C;
    const int out_valid = T_out - out_row0;
    if constexpr (planes) {
      layer_wmma<NT / 32>(smem + ch.offset[l], ch.half[l],
                          static_cast<const bf16*>(ch.w[l]), ch.k[l],
                          ch.rows[l + 1], C, ch.pitch, out_s,
                          last ? 0 : ch.half[l + 1], out_g, out_valid,
                          reinterpret_cast<float*>(smem + ch.offset[L]));
    } else {
      layer_fma_rows<NT>(smem + ch.offset[l],
                         static_cast<const float*>(ch.w[l]), ch.k[l],
                         ch.rows[l + 1], C, out_s, out_g, out_valid);
    }
  }
}

// Stage rows for a tile, composed backwards, and their allocation (the
// bf16 path reads whole 16-row tiles: padded so no read leaves the stage).
// Returns the shared-memory bytes, scratch included.
size_t plan(Chain& ch, int tile, int C, bool wmma_path) {
  const int L = ch.n_layers;
  const size_t esize = wmma_path ? sizeof(bf16) : sizeof(float);
  ch.rows[L] = tile;
  for (int l = L - 1; l >= 0; --l) ch.rows[l] = 2 * (ch.rows[l + 1] - 1) + ch.k[l];
  ch.pitch = wmma_path ? C + 16 : C;
  size_t off = 0;
  for (int l = 0; l < L; ++l) {
    ch.offset[l] = off;
    int alloc = ch.rows[l];
    if (wmma_path) {
      const int padded_out = (ch.rows[l + 1] + 15) / 16 * 16;
      alloc = std::max(alloc, 2 * (padded_out - 1) + ch.k[l]);
      ch.half[l] = (alloc + 1) / 2;
      alloc = 2 * ch.half[l];
    }
    off += (size_t)alloc * ch.pitch;
  }
  ch.offset[L] = off;
  size_t bytes = off * esize;
  if (wmma_path) bytes += (size_t)(Threads<bf16>::n / 32) * 256 * sizeof(float);
  return bytes;
}

template <typename T>
cudaError_t run(const void* x, void* out, Chain ch, int B, int T_in,
                int T_out, int C, int tile, const float* mean,
                const float* inv, const float* scale, const float* nbias,
                cudaStream_t stream) {
  constexpr bool wmma_path = std::is_same<T, bf16>::value;
  if (C % (wmma_path ? 16 : 4) != 0) return cudaErrorInvalidValue;
  const size_t smem = plan(ch, tile, C, wmma_path);
  dim3 grid((T_out + tile - 1) / tile, B);
  return wfl::launch(conv_chain_kernel<T>, grid, dim3(Threads<T>::n), smem,
                     stream,
                     static_cast<const T*>(x), static_cast<T*>(out), ch,
                     T_in, T_out, C, mean, inv, scale, nbias);
}

}  // namespace

using namespace wfl;

// x: [B, T_in, C], out: [B, T_out, C] contiguous, dtype 0 = f32, 1 = bf16
// (bf16 needs C % 16 == 0). w_l: packed [k_l][C][C] (tap, c_in, c_out) of
// the same dtype. mean/inv: [B, C] f32, scale/bias: [C] f32, all null for no
// input norm. Returns the launch's cudaError_t.
extern "C" int wfl_conv_chain_fwd(const void* x, void* out, const void* w0,
                                  const void* w1, const void* w2, int k0,
                                  int k1, int k2, int n_layers, int B,
                                  int T_in, int T_out, int C, int tile,
                                  const float* mean, const float* inv,
                                  const float* scale, const float* nbias,
                                  int dtype, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || tile < 1)
    return cudaErrorInvalidValue;
  Chain ch{};
  ch.n_layers = n_layers;
  ch.w[0] = w0; ch.w[1] = w1; ch.w[2] = w2;
  ch.k[0] = k0; ch.k[1] = k1; ch.k[2] = k2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return run<float>(x, out, ch, B, T_in, T_out, C, tile, mean, inv, scale,
                      nbias, s);
  if (dtype == kBF16)
    return run<bf16>(x, out, ch, B, T_in, T_out, C, tile, mean, inv, scale,
                     nbias, s);
  return cudaErrorInvalidValue;
}
