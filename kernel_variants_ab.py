"""Time variants of a kernel source on one card, in turns.

    python3 kernel_variants_ab.py [--kernel k2|k1w|k128|k128b|k5] [--iters N]
    python3 kernel_variants_ab.py --kernel wide --baseline OLD.cu [--iters N]
    python3 kernel_variants_ab.py --kernel wg --baseline FWD.cu BWD.cu

Each variant is the kernel's source with some of its tile constants
replaced as text (``K2_VARIANTS``: ``csrc/attention_fwd_bias_mma.cu``, the
gated-bias attention forward; ``K1W_VARIANTS``: the same source's bias-free
instantiation, the Whisper layers' K1; ``K5_VARIANTS``:
``csrc/conv_fused.cu``, the conv layer). Every variant builds with the
port's ``nvcc`` flags into a library of its own (all started together),
runs at the main shapes (K2: [8, 12, 1499, 64] with its LSE, kv_len 1499 −
100·b, bias and gate; K1w: Whisper-base's [8, 8, 1500, 64] with its LSE,
every key valid, no bias; K5: chain 1 [8, 95999, 512] → [8, 11999, 512]
with the layer-0 norm, and chain 2 [8, 11999, 512] → [8, 1499, 512]), is
held against the plain twin within ``chip_smoke.py``'s tolerances, and is
timed with CUDA events (the median of ``--iters`` calls of its launcher)
in turns: the variants of a dtype in order, then in reverse. Prints each
variant's ``[ptxas]`` lines, one line a variant, and a last JSON line of
the mean times.

K1w also runs the ``clocks`` variants, which add per-phase ``clock64``
counters to the forward's key loop (wait and barrier; issuing the next
tile's copies; S = Q·Kᵀ; the softmax; O += P·V), each phase ended by a
read of its last result so that the mma pipeline's latency falls in the
phase that issued it; lane 0 of each warp adds its cycles to a device
array, read back once. And it times each backward route's dK/dV pass at
the same shape by device time (torch.profiler): the FMA pair of
``flash_attention.cu`` (the earlier route at this width), forced through
``backward_route``, against the bias-free D = 64 passes.

``--kernel wide`` builds this tree's ``csrc/attention_wide.cu`` and the
file given by ``--baseline`` (an earlier version of it, with the same C
entry points) and times both at large-v3's Conformer shape [8, 2, 1500,
640], bias-free, in bf16 and f32, in turns: the forward (CUDA events), and
the device ms of the forward, the dK/dV pass and the dQ pass, each held to
the plain twins; its ``clocks`` variants print the cycle shares of the
forward's key loop by phase (``WIDE_PHASES``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

# The forward's tile constants by head width and dtype, as the source has
# them
FWD_WARPS = "int warps = kF32 && D == kD ? 4 : 8;"
FWD_BK = "int bk = kF32 ? 32 : 64;"
FWD_BLOCKS = "int blocks = D == kD ? 2 : 1;"
FWD_QREGS = "bool q_regs = D == kD;"
FWD_CHUNK = "int s_chunk = 4;"
# name: (dtype, [(text of the source, its replacement), ...])
K2_VARIANTS = {
    "bf16 8 warps": ("bf16", []),
    "bf16 4 warps": ("bf16", [(FWD_WARPS, "int warps = D == kD ? 4 : 8;")]),
    "bf16 8 warps, 32-key tiles": ("bf16", [(FWD_BK,
                                             "int bk = kF32 ? 32 : 32;")]),
    "f32 4 warps": ("f32", []),
    "f32 4 warps, 2 mma steps a fresh sum": ("f32", [(FWD_CHUNK,
                                                      "int s_chunk = 2;")]),
    "f32 4 warps, 8 mma steps a fresh sum": ("f32", [(
        FWD_CHUNK, "int s_chunk = D / Pol::KS;")]),
    "f32 4 warps, 3 blocks a SM": ("f32", [(FWD_BLOCKS, FWD_BLOCKS.replace(
        "D == kD ? 2", "D == kD ? (kF32 ? 3 : 2)"))]),
}

# K5: the per-dtype Tiles line of conv_fused.cu, as it stands and as varied
K5_BF16 = ("struct Tiles<OpBF16> { static constexpr int bm = 128, bn = 256, "
           "wn = 4, stages = 3, blocks = 1; };")
K5_F32 = ("struct Tiles<OpF32> { static constexpr int bm = 128, bn = 128, "
          "wn = 4, stages = 4, blocks = 1; };")


def _k5(line: str, old: str, new: str) -> list:
    return [(line, line.replace(old, new))]


# The alternative to the layer-0 norm inside layer 1: a pass of its own,
# x → gelu(((x − mean)·inv)·scale + bias) in x's dtype, 16 bytes a thread,
# then layer 1 without the norm. Appended to the source by the variant.
NORM_PASS = r"""
template <typename T>
__global__ void __launch_bounds__(256)
conv_norm_pass(const T* __restrict__ x, T* __restrict__ y,
               const float* __restrict__ mean, const float* __restrict__ inv,
               const float* __restrict__ scale,
               const float* __restrict__ bias, int T_len, int C,
               long long n_chunks) {
  constexpr int V = 16 / sizeof(T);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n_chunks;
       i += (long long)gridDim.x * 256) {
    const long long e0 = i * V, row = e0 / C;
    const int c = (int)(e0 - row * C), b = (int)(row / T_len);
    uint4 v = *reinterpret_cast<const uint4*>(x + e0);
    T* el = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = __fmul_rn(__fsub_rn(to_f(el[e]),
                                          mean[(size_t)b * C + c + e]),
                                inv[(size_t)b * C + c + e]);
      el[e] = from_f<T>(gelu_f(__fadd_rn(__fmul_rn(z, scale[c + e]),
                                         bias[c + e])));
    }
    *reinterpret_cast<uint4*>(y + e0) = v;
  }
}

extern "C" int wfl_conv_norm_pass(const void* x, void* y, int B, int T_len,
                                  int C, const float* mean, const float* inv,
                                  const float* scale, const float* bias,
                                  int dtype, void* stream) {
  const int V = dtype == kF32 ? 4 : 8;
  const long long n = (long long)B * T_len * C / V;
  const int grid = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                     : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    conv_norm_pass<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), mean, inv,
        scale, bias, T_len, C, n);
  else
    conv_norm_pass<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), mean, inv, scale, bias, T_len, C, n);
  return cudaGetLastError();
}
"""
NORM_PASS_AT = "}  // namespace\n\nusing namespace wfl;\n"
J_LOOP = "#pragma unroll\n  for (int j = 0; j < K; ++j) {"

K5_VARIANTS = {
    "bf16 128x256, warps 64x64, 3 stages": ("bf16", []),
    "bf16 128x256, tap loop not unrolled": ("bf16", [(
        J_LOOP, J_LOOP.replace("unroll", "unroll 1"))]),
    "bf16 128x256, norm as a pass of its own": ("bf16", [(
        NORM_PASS_AT, NORM_PASS_AT + NORM_PASS)]),
    "bf16 128x128, warps 64x32, 4 stages": ("bf16", _k5(
        K5_BF16, "bn = 256, wn = 4, stages = 3",
        "bn = 128, wn = 4, stages = 4")),
    "f32 128x128, warps 64x32, 4 stages": ("f32", []),
    "f32 128x128, tap loop not unrolled": ("f32", [(
        J_LOOP, J_LOOP.replace("unroll", "unroll 1"))]),
    "f32 128x128, norm as a pass of its own": ("f32", [(
        NORM_PASS_AT, NORM_PASS_AT + NORM_PASS)]),
}

# K1w: per-phase clocks, as text put into the forward's key loop. Each mark
# first reads a register of the phase's last result (an empty asm that
# takes it as an operand: the warp waits for it), then clock64.
CLK_DECL = "constexpr float kLn2 = 0.6931471805599453f;\n"
CLK_GLOBAL = CLK_DECL + """__device__ unsigned long long wfl_clk[5];
#define WFL_MARK(i, dep)                                        \\
  {                                                             \\
    float wfl_d = (dep);                                        \\
    asm volatile("" : "+f"(wfl_d));                             \\
    const long long wfl_n = clock64();                          \\
    wfl_c[i] += wfl_n - wfl_t;                                  \\
    wfl_t = wfl_n;                                              \\
  }
"""
CLK_START = "  const int n_kt = (kvl + BK - 1) / BK;\n"
CLK_WAIT = ("      __syncthreads();    // this tile is in; every warp is done "
            "with kt − 1\n    }\n")
CLK_STAGE = "      stage(kt + 1, buf ^ 1);\n      cp_async_commit();\n    }\n"
CLK_S = ("    scores<Pol, D, NJ, Cfg::q_regs, Cfg::s_chunk>(s, qa, sQ, r0,\n"
         "                                                 sK + buf * BK * "
         "P, P);\n")
CLK_SOFT = "    // O += P·V, P straight from the score registers, 16 keys at a time\n"
CLK_PV = ("      accumulate_held<Pol, kNT, kInPlace>(o, s[j], tV, P, 16 * j);\n"
          "  }\n")
CLK_END = "  // the row sum over the quad, the LSE and 1/l\n"
CLK_READ = """
extern "C" int wfl_read_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, wfl_clk, sizeof(wfl_clk));
  if (err != cudaSuccess) return err;
  unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return cudaMemcpyToSymbol(wfl_clk, zero, sizeof(zero));
}
"""
CLK_PHASES = ("wait+barrier", "issue copies", "S=QK^T", "softmax", "O+=PV")


def clocks(wait: str = CLK_WAIT) -> list:
    """The clock marks, the wait phase ending after the text ``wait``."""
    return [
        (CLK_DECL, CLK_GLOBAL),
        (CLK_START, CLK_START + "  long long wfl_c[5] = {0, 0, 0, 0, 0};\n"
         "  long long wfl_t = clock64();\n"),
        (wait, wait + "    WFL_MARK(0, 0.f)\n")] + CLOCK_MARKS


CLOCK_MARKS = [
    (CLK_STAGE, CLK_STAGE + "    WFL_MARK(1, 0.f)\n"),
    (CLK_S, CLK_S + "    WFL_MARK(2, s[NJ - 1][1][3])\n"),
    (CLK_SOFT, "    WFL_MARK(3, o[kNT - 1][3] + s[NJ - 1][1][3])\n"
     + CLK_SOFT),
    (CLK_PV, CLK_PV.replace("  }\n", "    WFL_MARK(4, o[kNT - 1][3])\n  }\n")),
    (CLK_END, "  if (lane == 0)\n    for (int i = 0; i < 5; ++i)\n"
     "      atomicAdd(&wfl_clk[i], (unsigned long long)wfl_c[i]);\n"
     + CLK_END),
    ("}  // namespace\n\nusing namespace wfl;\n",
     "}  // namespace\n\nusing namespace wfl;\n" + CLK_READ),
]
CLOCKS = clocks()
# K and V by bulk copies (the Tensor Memory Accelerator): warp 0 issues
# one cp.async.bulk a row into the padded rows, completing on an mbarrier a
# buffer, in place of 16-byte cp.async in every thread
BULK_HELPERS = r"""
// Bulk copies (the Tensor Memory Accelerator, sm_90): one instruction
// copies a contiguous run of bytes global → shared and reports the bytes
// to an mbarrier in shared memory; a thread that expects them arrives with
// their count (mbar_expect_tx), and the consumers wait for the barrier's
// phase (mbar_wait). Addresses and sizes are multiples of 16 bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

// make the initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WFL_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WFL_WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

"""
BULK_STAGE_FROM = (
    "  auto stage = [&](int kt, int buf) {\n    const int k0 = kt * BK;\n"
    "    stage_rows_by_warp<Pol, NW>(sK + buf * BK * P, P, k, k0, BK, T_len, "
    "D);\n    stage_rows_by_warp<Pol, NW>(sV + buf * BK * P, P, v, k0, BK, "
    "T_len, D);\n")
BULK_STAGE = r"""  // K and V of a key tile: warp 0 issues one bulk copy a row
  // (128 bytes in bf16, 256 in f32) into the padded rows, lane 0 first
  // arriving on the buffer's barrier with their bytes; rows past T are
  // zero-filled by plain stores (a V row of garbage times P = 0 could be
  // NaN), which the next iteration's barrier publishes.
  __shared__ __align__(8) uint64_t bars[2];
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    {
      const int rows = min(BK, T_len - k0);
      T* dK = sK + buf * BK * P;
      T* dV = sV + buf * BK * P;
      if (warp == 0) {
        constexpr unsigned kRow = D * sizeof(T);
        if (lane == 0) mbar_expect_tx(&bars[buf], 2 * rows * kRow);
        __syncwarp();
        for (int r = lane; r < rows; r += 32) {
          bulk_g2s(dK + Pol::at(P, r, 0), k + (size_t)(k0 + r) * D, kRow,
                   &bars[buf]);
          bulk_g2s(dV + Pol::at(P, r, 0), v + (size_t)(k0 + r) * D, kRow,
                   &bars[buf]);
        }
      }
      for (int idx = threadIdx.x; idx < (BK - rows) * D;
           idx += Cfg::threads) {
        const int r = rows + idx / D, c = idx % D;
        dK[Pol::at(P, r, c)] = from_f<T>(0.f);
        dV[Pol::at(P, r, c)] = from_f<T>(0.f);
      }
    }
"""
BULK_INIT_AT = ("  stage_rows_by_warp<Pol, NW>(sQ, P, a.q + base, q0, BQ, "
                "T_len, D);\n")
BULK_INIT = """  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
"""
BULK_WAIT = "    mbar_wait(&bars[buf], (kt >> 1) & 1);\n"
BULK_KV = [(CLK_DECL, CLK_DECL + BULK_HELPERS),
           (BULK_STAGE_FROM, BULK_STAGE),
           (BULK_INIT_AT, BULK_INIT + BULK_INIT_AT),
           (CLK_WAIT, CLK_WAIT + BULK_WAIT)]
# (f32 only: the bias-free bf16 forward is attention_wgmma.cu's, --kernel wg)
K1W_VARIANTS = {
    "f32 4 warps": ("f32", []),
    "f32 4 warps, clocks": ("f32", CLOCKS),
    "f32 4 warps, bulk K/V": ("f32", BULK_KV),
    "f32 4 warps, bulk K/V, clocks": ("f32", BULK_KV + clocks(BULK_WAIT)),
}

K2_VARIANTS.update({
    "bf16 8 warps, bulk K/V": ("bf16", BULK_KV),
    "f32 4 warps, bulk K/V": ("f32", BULK_KV),
})

# The bias-free f32 forward at D = 128 (route mma128): 8 warps and 1 block
# a SM against 4 warps and 2-3 blocks (fewer queries a block, more blocks
# a SM; shorter key tiles make room for them); Q read from shared memory
# on use against Q's split fragments held in registers


def _fwd128(blocks=None, warps=None, bk=None, q_regs=None) -> list:
    """The replacements that set the f32 D = 128 forward's tiles; D = 64
    keeps its own."""
    subs = []
    if warps is not None:
        subs.append((FWD_WARPS, f"int warps = D == kD ? (kF32 ? 4 : 8) : "
                                f"{warps};"))
    if bk is not None:
        subs.append((FWD_BK, f"int bk = D == kD ? (kF32 ? 32 : 64) : {bk};"))
    if blocks is not None:
        subs.append((FWD_BLOCKS, f"int blocks = D == kD ? 2 : {blocks};"))
    if q_regs is not None:
        subs.append((FWD_QREGS, f"bool q_regs = D == kD || "
                                f"{str(q_regs).lower()};"))
    return subs


K128_VARIANTS = {
    "f32 D=128 8 warps, 1 block a SM": ("f32", []),
    "f32 D=128 8 warps, clocks": ("f32", CLOCKS),
    "f32 D=128 4 warps, 2 blocks a SM": ("f32", _fwd128(2, warps=4)),
    "f32 D=128 4 warps, 2 blocks a SM, Q in registers": (
        "f32", _fwd128(2, warps=4, q_regs=True)),
    "f32 D=128 4 warps, 16-key tiles, 3 blocks a SM": ("f32", _fwd128(
        3, warps=4, bk=16)),
}
# The D = 128 passes (attention_bwd_bias_mma.cu): f32's dK/dV pass at 16
# queries a streamed tile and 2 blocks a SM against 32 queries and 1 block
BWD_BQ = "int bq = kF32 ? (D == kD ? 32 : 16) : 64;"
BWD_BLOCKS = "int blocks = kF32 ? 2 : 3;"
K128B_VARIANTS = {
    "f32 D=128 16-query tiles, 2 blocks a SM": ("f32", []),
    "f32 D=128 32-query tiles, 1 block a SM": ("f32", [
        (BWD_BQ, "int bq = kF32 ? 32 : 64;"),
        (BWD_BLOCKS, "int blocks = kF32 ? (D == kD ? 2 : 1) : 3;")]),
}

# The wide route (attention_wide.cu): this tree's cluster kernels, with and
# without per-phase clocks in the forward's key loop, against a baseline
# source given by --baseline (the variants named in WIDE_BASELINE take that
# file in place of the source).
WIDE_PHASES = ("A wait", "reduce-scatter", "B arrive",
               "copy wait+CTA barrier", "copies+partial S",
               "B wait+all-gather", "softmax", "A arrive", "P.V")
WIDE_CLK_GLOBAL = CLK_GLOBAL.replace("wfl_clk[5]",
                                     f"wfl_clk[{len(WIDE_PHASES)}]")
WIDE_LOOP = ("  for (int kt = 0; kt < n_kt; ++kt) {\n    const int k0 = kt * BK;"
             "\n    float* const buf")
WIDE_WAIT_A = "    cluster_wait();       // A(kt)\n"
WIDE_REDUCE = "    reduce_own<32 * NW>(buf, kChunks, rank, a.ranks);\n"
WIDE_ARRIVE_B = "    cluster_arrive();     // B(kt)\n"
WIDE_SYNC = ("    __syncthreads();      // V(kt), K(kt + 1) are in; every warp is "
             "done with\n                          // kt − 1\n")
WIDE_PARTIAL = "      partial(kt + 1);\n    }\n"
WIDE_GATHER = ("    gather_sums<NJ>(s, slot + (kt & 1) * kPartBuf, 2 * NJ * warp, "
               "a.ranks);\n")
WIDE_ARRIVE_A = "    if (kt + 1 < n_kt) cluster_arrive();   // A(kt + 1)\n"
WIDE_PV = ("      accumulate_slice<Pol, NTMAX, kInPlace>(o, s[j], tV, P, 16 * "
           "j, nt);\n  }\n")
WIDE_END = "  // the row sum over the quad, the LSE (rank 0) and 1/l\n"
_ZEROS = ", ".join("0" * len(WIDE_PHASES))
WIDE_READ = CLK_READ.replace("[5]", f"[{len(WIDE_PHASES)}]").replace(
    "{0, 0, 0, 0, 0}", "{" + _ZEROS + "}")
WIDE_CLOCKS = [
    (CLK_DECL, WIDE_CLK_GLOBAL),
    (WIDE_LOOP, f"  long long wfl_c[{len(WIDE_PHASES)}] = {{{_ZEROS}}};\n"
     "  long long wfl_t = clock64();\n" + WIDE_LOOP),
    (WIDE_WAIT_A, WIDE_WAIT_A + "    WFL_MARK(0, 0.f)\n"),
    (WIDE_REDUCE, WIDE_REDUCE + "    WFL_MARK(1, 0.f)\n"),
    (WIDE_ARRIVE_B, WIDE_ARRIVE_B + "    WFL_MARK(2, 0.f)\n"),
    (WIDE_SYNC, WIDE_SYNC + "    WFL_MARK(3, 0.f)\n"),
    (WIDE_PARTIAL, WIDE_PARTIAL + "    WFL_MARK(4, 0.f)\n"),
    (WIDE_GATHER, WIDE_GATHER + "    WFL_MARK(5, s[NJ - 1][1][3])\n"),
    (WIDE_ARRIVE_A, "    WFL_MARK(6, s[NJ - 1][1][3] + l_row[0])\n"
     + WIDE_ARRIVE_A + "    WFL_MARK(7, 0.f)\n"),
    (WIDE_PV, WIDE_PV.replace("  }\n", "    WFL_MARK(8, o[NTMAX - 1][3])\n"
                              "  }\n")),
    (WIDE_END, f"  if (lane == 0)\n    for (int i = 0; i < {len(WIDE_PHASES)}; "
     "++i)\n      atomicAdd(&wfl_clk[i], (unsigned long long)wfl_c[i]);\n"
     + WIDE_END),
    ("}  // namespace\n\nusing namespace wfl;\n",
     "}  // namespace\n\nusing namespace wfl;\n" + WIDE_READ),
]
# The forward at 4 warps (64 queries) a CTA and 2 CTAs a SM, so that two
# clusters' phases interleave on a SM; shorter key tiles keep two blocks'
# shared memory in a SM (bf16 48 keys, f32 16)
WIDE_4WARPS = [("constexpr int kFwdWarps = 8;", "constexpr int kFwdWarps = 4;"),
               ("constexpr int kFwdBlocks = 1;",
                "constexpr int kFwdBlocks = 2;"),
               ("constexpr int kFwdKeys[2] = {64, 48};",
                "constexpr int kFwdKeys[2] = {48, 16};")]
WIDE_VARIANTS = {
    "bf16 cluster": ("bf16", []),
    "bf16 cluster, clocks": ("bf16", WIDE_CLOCKS),
    "bf16 4 warps, 48-key tiles, 2 blocks a SM": ("bf16", WIDE_4WARPS),
    "bf16 baseline": ("bf16", []),
    "f32 cluster": ("f32", []),
    "f32 cluster, clocks": ("f32", WIDE_CLOCKS),
    "f32 4 warps, 16-key tiles, 2 blocks a SM": ("f32", WIDE_4WARPS),
    "f32 32-key tiles": ("f32", [("constexpr int kFwdKeys[2] = {64, 48};",
                                  "constexpr int kFwdKeys[2] = {64, 32};")]),
    "f32 baseline": ("f32", []),
}
WIDE_BASELINE = ("bf16 baseline", "f32 baseline")

# The bias-free bf16 routes wgmma64 and wgmma128 (attention_wgmma.cu, its
# dQ pass attention_bwd_bias_mma.cu's) against the bias-free bf16
# instantiations of an earlier attention_fwd_bias_mma.cu and
# attention_bwd_bias_mma.cu (--baseline FWD.cu BWD.cu: "baseline mma.sync",
# both files built from the parent's tree); the forward's CTAs of 128
# queries (two consumer groups, 1 CTA a SM) against 64 (one group, 2 CTAs
# a SM) at D = 64, its three stages against two, and the D = 128 dK/dV
# pass with one consumer group against two
WG_STAGES = ("  static constexpr int bk = 128;\n"
             "  static constexpr int stages = 2;\n")
WG_VARIANTS = {
    "wgmma": ("bf16", []),
    "wgmma, forward CTAs of 128 queries at D=64": ("bf16", [(
        "constexpr int kFwdGroups64 = 1;",
        "constexpr int kFwdGroups64 = 2;")]),
    "wgmma, 3 forward stages": ("bf16", [(
        WG_STAGES, WG_STAGES.replace("stages = 2", "stages = 3"))]),
    "wgmma, dK/dV of one consumer group at D=128": ("bf16", [(
        "constexpr int kBwdGroups128 = 2;",
        "constexpr int kBwdGroups128 = 1;")]),
    "baseline mma.sync": ("bf16", []),
}
WG_BASELINE = ("baseline mma.sync",)
WG_SHAPES = ((8, 8, 1500, 64), (8, 4, 1500, 128), (8, 2, 1500, 48))

KERNELS = {"k2": ("attention_fwd_bias_mma.cu", K2_VARIANTS),
           "k1w": ("attention_fwd_bias_mma.cu", K1W_VARIANTS),
           "k128": ("attention_fwd_bias_mma.cu", K128_VARIANTS),
           "k128b": ("attention_bwd_bias_mma.cu", K128B_VARIANTS),
           "k5": ("conv_fused.cu", K5_VARIANTS),
           "wide": ("attention_wide.cu", WIDE_VARIANTS),
           "wg": ("attention_wgmma.cu", WG_VARIANTS)}


def build(tmp: str, source: str, variants: dict, baseline: str = None,
          baseline_names=()) -> dict:
    """One library per variant from a copy of ``csrc/`` with the variant's
    replacements (the variants in ``baseline_names`` with the file
    ``baseline`` in place of the source first); returns {name: (library
    path, nvcc output)}."""
    from wfl_asr_tpu_torch.ops.kernels import _build
    procs = {}
    for i, (name, (_, subs)) in enumerate(variants.items()):
        src = os.path.join(tmp, f"v{i}")
        shutil.copytree(_build.CSRC, src)
        path = os.path.join(src, source)
        if name in baseline_names:
            shutil.copyfile(baseline, path)
        with open(path) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(src, "libvariant.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, log)
    return out


def build_wg(tmp: str, baselines) -> dict:
    """``--kernel wg``: each variant of ``WG_VARIANTS`` built from a copy of
    ``csrc/``, attention_wgmma.cu with the variant's replacements and this
    tree's attention_bwd_bias_mma.cu (the dQ pass); the baseline from the
    two files given (an earlier attention_fwd_bias_mma.cu and
    attention_bwd_bias_mma.cu) in place of this tree's. Returns {name:
    {source: (library path, nvcc output)}}."""
    from wfl_asr_tpu_torch.ops.kernels import _build
    procs = {}
    for i, (name, (_, subs)) in enumerate(WG_VARIANTS.items()):
        src = os.path.join(tmp, f"v{i}")
        shutil.copytree(_build.CSRC, src)
        if name in WG_BASELINE:
            jobs = {}
            for source, path in zip(("attention_fwd_bias_mma",
                                     "attention_bwd_bias_mma"), baselines):
                shutil.copyfile(path, os.path.join(src, source + ".cu"))
                jobs[source] = []
        else:
            jobs = {"attention_wgmma": subs, "attention_bwd_bias_mma": []}
        for source, subs_ in jobs.items():
            path = os.path.join(src, source + ".cu")
            with open(path) as f:
                text = f.read()
            for old, new in subs_:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: {old!r} is not in the source "
                                     f"once")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(src, f"lib{source}.so")
            procs[(name, source)] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                 "-o", lib, path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    out = {}
    for (name, source), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} ({source}):\n{log}")
        out.setdefault(name, {})[source] = (lib, log)
    return out


def in_turns(names, run_one) -> dict:
    """``run_one(name)`` for each name in order, then in reverse; returns
    {name: [its times]}. ``run_one`` returns a time or None (failed)."""
    turns = {n: [] for n in names}
    for n in names + names[::-1]:
        ms = run_one(n)
        if ms is None:
            return {}
        turns[n].append(ms)
    return turns


def run_k2(libs: dict, iters: int) -> dict:
    import torch
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention as fa
    fns = {name: _build.bind(ctypes.CDLL(lib), "attention_fwd_bias_mma")
           .wfl_attention_fwd_bias_mma for name, (lib, _) in libs.items()}
    b, h, t, d = sm.B, 12, sm.T, 64
    kv = torch.tensor([t - 100 * i for i in range(b)], dtype=torch.int32,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    means = {}
    for dtype, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v, bias, gate = sm.attn_inputs(gen, (b, h, t, d), tdt, True)
        ref, ref_lse = fa.attention_plain(q, k, v, bias, gate, kv,
                                          return_lse=True)
        scale = ref.float().abs().max().item()
        out = torch.empty_like(q)
        lse = torch.empty((b, h, t), device="cuda")

        def run_one(n):
            def run(fn=fns[n]):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bias.data_ptr(), gate.data_ptr(), kv.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), None, b, h, t,
                         d, 1.0 / math.sqrt(d), 0, 1.0,
                         0 if dtype == "f32" else 1,
                         _build.stream_ptr(q.device))
                if err:
                    raise SystemExit(f"{n}: launch failed, error {err}")
            out.zero_()
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = (err <= sm.ATTN_TOL[dtype] * scale
                  and lse_err <= sm.LSE_TOL)
            ms = sm.time_ms(run, iters)
            print(f"[variant] {n}: ms={ms:.4f} max_abs_err={err:.3e} "
                  f"(tol {sm.ATTN_TOL[dtype]:g}×{scale:.3g}) "
                  f"lse_err={lse_err:.3e}{'' if ok else ' FAILED'}",
                  flush=True)
            return ms if ok else None
        turns = in_turns([n for n, (dt, _) in K2_VARIANTS.items()
                          if dt == dtype], run_one)
        if not turns:
            return {}
        means.update({n: float(np.mean(ms)) for n, ms in turns.items()})
        del q, k, v, bias, gate, ref, ref_lse, out, lse
        torch.cuda.empty_cache()
    return means


def run_k1w(libs: dict, iters: int) -> dict:
    """The bias-free D = 64 forward's variants at Whisper-base's shape: the
    times in turns, each clocks variant's cycle shares by phase (from one
    more call after its timing), then each backward route's dK/dV pass."""
    return run_bias_free(libs, iters, 8, 64, K1W_VARIANTS, "mma64")


def run_k128(libs: dict, iters: int) -> dict:
    """The same for the bias-free D = 128 forward's variants at
    Whisper-base's Conformer under 4 heads, [8, 4, 1500, 128]; the
    backward routes compared are the FMA pair and mma128."""
    return run_bias_free(libs, iters, 4, 128, K128_VARIANTS, "mma128")


def run_bias_free(libs: dict, iters: int, h: int, d: int, variants: dict,
                  route_now: str) -> dict:
    """The bias-free forward's ``variants`` at [8, h, 1500, d], every key
    valid: each held to the plain twin (and its LSE), timed in turns,
    each clocks variant's cycle shares by phase; then the backward of the
    FMA pair and of ``route_now`` by device ms, each forced through
    ``backward_route``."""
    import torch
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention as fa
    cdlls = {name: _build.bind(ctypes.CDLL(lib), "attention_fwd_bias_mma")
             for name, (lib, _) in libs.items()}
    fns = {name: lib.wfl_attention_fwd_bias_mma
           for name, lib in cdlls.items()}
    b, t = sm.B, sm.WHISPER_T
    kv = torch.full((b,), t, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    means, shares = {}, {}
    for dtype, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        if all(dt != dtype for dt, _ in variants.values()):
            continue
        q, k, v, _, _ = sm.attn_inputs(gen, (b, h, t, d), tdt, False)
        ref, ref_lse = fa.attention_plain(q, k, v, None, None, kv,
                                          return_lse=True)
        scale = ref.float().abs().max().item()
        out = torch.empty_like(q)
        lse = torch.empty((b, h, t), device="cuda")

        def run_one(n):
            def run(fn=fns[n]):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                         None, kv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                         None, b, h, t, d, 1.0 / math.sqrt(d), 0, 1.0,
                         0 if dtype == "f32" else 1,
                         _build.stream_ptr(q.device))
                if err:
                    raise SystemExit(f"{n}: launch failed, error {err}")
            out.zero_()
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = (err <= sm.ATTN_TOL[dtype] * scale
                  and lse_err <= sm.LSE_TOL)
            ms = sm.time_ms(run, iters)
            if "clocks" in n and n not in shares:
                read = cdlls[n].wfl_read_clocks
                read.restype = ctypes.c_int
                read.argtypes = [ctypes.c_void_p]
                buf = (ctypes.c_ulonglong * 5)()
                if read(buf):
                    raise SystemExit(f"{n}: reading the clocks failed")
                run()
                torch.cuda.synchronize()
                if read(buf):
                    raise SystemExit(f"{n}: reading the clocks failed")
                total = float(sum(buf))
                shares[n] = {p: buf[i] / total
                             for i, p in enumerate(CLK_PHASES)}
                print(f"[clocks] {n}: cycle shares of the key loop, summed "
                      f"over warps ({total:.4g} cycles): " + ", ".join(
                          f"{p} {x:.3f}" for p, x in shares[n].items()),
                      flush=True)
            print(f"[variant] {n}: ms={ms:.4f} max_abs_err={err:.3e} "
                  f"(tol {sm.ATTN_TOL[dtype]:g}×{scale:.3g}) "
                  f"lse_err={lse_err:.3e}{'' if ok else ' FAILED'}",
                  flush=True)
            return ms if ok else None
        turns = in_turns([n for n, (dt, _) in variants.items()
                          if dt == dtype], run_one)
        if not turns:
            return {}
        means.update({n: float(np.mean(ms)) for n, ms in turns.items()})

        # each backward route's passes at this shape, by device time
        leaves = [x.requires_grad_() for x in (q, k, v)]
        dout = (torch.rand((b, h, t, d), generator=gen, device="cuda") * 2
                - 1).to(tdt)
        from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
            flash_attention_trainable
        route = fa.backward_route
        try:
            for name in ("fma", route_now):
                fa.backward_route = lambda *args, r=name: r
                y = flash_attention_trainable(*leaves, kv)
                by = sm.device_ms_by_kernel(lambda: torch.autograd.grad(
                    y, leaves, dout, retain_graph=True))
                means[f"{dtype} backward {name}"] = by
                print(f"[dkdv] {dtype} [{b},{h},{t},{d}] backward route "
                      f"{name}: device ms by kernel " + ", ".join(
                          f"{k_} {ms:.4f}" for k_, ms in by.items()),
                      flush=True)
                del y
        finally:
            fa.backward_route = route
        del q, k, v, ref, ref_lse, out, lse, leaves, dout
        torch.cuda.empty_cache()
    means["clock shares"] = shares
    return means


def run_k128b(libs: dict, iters: int) -> dict:
    """The D = 128 passes' variants at [8, 4, 1500, 128], bias-free, every
    key valid, in bf16 and f32: each variant's dK/dV and dQ passes (through
    its launcher, from the plain twin's LSE and delta) held to the plain
    twin's gradients, then in turns the launcher's ms (CUDA events) and the
    device ms of each pass (torch.profiler)."""
    import torch
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention as fa
    cdlls = {name: ctypes.CDLL(lib) for name, (lib, _) in libs.items()}
    b, h, t, d = sm.B, 4, sm.WHISPER_T, 128
    kv = torch.full((b,), t, dtype=torch.int32, device="cuda")
    ldk = -(-t // 64) * 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    means = {}
    for dtype, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        if all(dt != dtype for dt, _ in K128B_VARIANTS.values()):
            continue
        code = 0 if dtype == "f32" else 1
        q, k, v, _, _ = sm.attn_inputs(gen, (b, h, t, d), tdt, False)
        dout = (torch.rand((b, h, t, d), generator=gen, device="cuda") * 2
                - 1).to(tdt)
        ref, lse = fa.attention_plain(q, k, v, None, None, kv,
                                      return_lse=True)
        want = fa.attention_backward_plain(q, k, v, None, None, kv, ref, lse,
                                           dout)[:3]
        delta = (dout.float() * ref.float()).sum(-1).contiguous()
        grads = [torch.empty_like(q) for _ in range(3)]
        ds = torch.empty((b, h, t, ldk), dtype=tdt, device="cuda")

        def run_one(n):
            fn = cdlls[n].wfl_attention_bwd_bias_mma
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p])

            def backward():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                         None, dout.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), kv.data_ptr(), None,
                         *[g.data_ptr() for g in grads], ds.data_ptr(), None,
                         None, b, h, t, d, ldk, 1.0 / math.sqrt(d), 0, 1.0,
                         code, _build.stream_ptr(q.device))
                if err:
                    raise SystemExit(f"{n}: backward failed, error {err}")
            backward()
            torch.cuda.synchronize()
            rel = max((g.float() - w.float()).abs().max().item()
                      / w.float().abs().max().item()
                      for g, w in zip(grads, want))
            ok = rel <= sm.GRAD_TOL[dtype]
            got = {"ms": sm.time_ms(backward, iters)}
            by = sm.device_ms_by_kernel(backward)
            for part in ("dkdv", "dq"):
                got[part + "_device_ms"] = sum(
                    x for kname, x in by.items()
                    if kname.startswith(f"attn_bias_bwd_{part}_mma<"))
            print(f"[variant] {n} [{b},{h},{t},{d}]: ms={got['ms']:.4f} "
                  f"device dK/dV {got['dkdv_device_ms']:.4f} dQ "
                  f"{got['dq_device_ms']:.4f}; grads {rel:.3e} × max (tol "
                  f"{sm.GRAD_TOL[dtype]:g}){'' if ok else ' FAILED'}",
                  flush=True)
            return got if ok else None
        turns = in_turns([n for n, (dt, _) in K128B_VARIANTS.items()
                          if dt == dtype], run_one)
        if not turns:
            return {}
        means.update({n: {key: float(np.mean([x[key] for x in runs]))
                          for key in runs[0]}
                      for n, runs in turns.items()})
        del q, k, v, dout, ref, lse, want, delta, grads, ds
        torch.cuda.empty_cache()
    return means


def run_wide(libs: dict, iters: int) -> dict:
    """The wide route's variants at large-v3's Conformer shape [8, 2, 1500,
    640], bias-free, every key valid, in bf16 and f32: each variant's
    forward (its LSE too) and backward against the plain twins, then in
    turns the forward's ms (CUDA events over its launcher, one kernel) and
    the device ms of the forward, the dK/dV pass and the dQ pass
    (torch.profiler); each clocks variant's cycle shares by phase of the
    forward's key loop."""
    import torch
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention as fa
    cdlls = {name: ctypes.CDLL(lib) for name, (lib, _) in libs.items()}
    b, h, t, d = sm.B, 2, sm.WHISPER_T, 640
    kv = torch.full((b,), t, dtype=torch.int32, device="cuda")
    ldk = -(-t // 64) * 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    means, shares = {}, {}
    for dtype, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        code = 0 if dtype == "f32" else 1
        q, k, v, _, _ = sm.attn_inputs(gen, (b, h, t, d), tdt, False)
        dout = (torch.rand((b, h, t, d), generator=gen, device="cuda") * 2
                - 1).to(tdt)
        ref, ref_lse = fa.attention_plain(q, k, v, None, None, kv,
                                          return_lse=True)
        want = fa.attention_backward_plain(q, k, v, None, None, kv, ref,
                                           ref_lse, dout)[:3]
        scale = ref.float().abs().max().item()
        out = torch.empty_like(q)
        lse = torch.empty((b, h, t), device="cuda")
        grads = [torch.empty_like(q) for _ in range(3)]
        ds = torch.empty((b, h, t, ldk), dtype=tdt, device="cuda")
        delta = torch.empty((b, h, t), device="cuda")

        def run_one(n):
            lib = cdlls[n]
            _build.bind(lib, "attention_wide")
            fwd, bwd = lib.wfl_attention_wide_fwd, lib.wfl_attention_wide_bwd
            stream = _build.stream_ptr(q.device)

            def forward():
                err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                          None, kv.data_ptr(), out.data_ptr(),
                          lse.data_ptr(), None, b, h, t, d,
                          1.0 / math.sqrt(d), 0, 1.0, code, stream)
                if err:
                    raise SystemExit(f"{n}: forward failed, error {err}")

            def backward():
                err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                          None, dout.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), kv.data_ptr(), None,
                          *[g.data_ptr() for g in grads], ds.data_ptr(), b,
                          h, t, d, ldk, 1.0 / math.sqrt(d), 0, 1.0, code,
                          stream)
                if err:
                    raise SystemExit(f"{n}: backward failed, error {err}")
            out.zero_()
            forward()
            delta.copy_((dout.float() * out.float()).sum(-1))
            backward()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            rel = max((g.float() - w.float()).abs().max().item()
                      / w.float().abs().max().item()
                      for g, w in zip(grads, want))
            ok = (err <= sm.ATTN_TOL[dtype] * scale
                  and lse_err <= sm.LSE_TOL and rel <= sm.GRAD_TOL[dtype])
            ms = sm.time_ms(forward, iters)
            by = sm.device_ms_by_kernel(lambda: (forward(), backward()))
            got = {"fwd_ms": ms}
            for part in ("fwd", "bwd_dkdv", "bwd_dq"):
                got[part + "_device_ms"] = sum(
                    x for kname, x in by.items()
                    if kname.startswith(f"attn_wide_{part}<"))
            if "clocks" in n and n not in shares:
                read = lib.wfl_read_clocks
                read.restype = ctypes.c_int
                read.argtypes = [ctypes.c_void_p]
                buf = (ctypes.c_ulonglong * len(WIDE_PHASES))()
                if read(buf):
                    raise SystemExit(f"{n}: reading the clocks failed")
                forward()
                torch.cuda.synchronize()
                if read(buf):
                    raise SystemExit(f"{n}: reading the clocks failed")
                total = float(sum(buf))
                shares[n] = {p: buf[i] / total
                             for i, p in enumerate(WIDE_PHASES)}
                print(f"[clocks] {n}: cycle shares of the forward's key "
                      f"loop, summed over warps ({total:.4g} cycles): "
                      + ", ".join(f"{p} {x:.3f}"
                                  for p, x in shares[n].items()),
                      flush=True)
            print(f"[variant] {n} [{b},{h},{t},{d}]: fwd ms={ms:.4f} device "
                  f"fwd {got['fwd_device_ms']:.4f} dK/dV "
                  f"{got['bwd_dkdv_device_ms']:.4f} dQ "
                  f"{got['bwd_dq_device_ms']:.4f}; max_abs_err={err:.3e} "
                  f"(tol {sm.ATTN_TOL[dtype]:g}×{scale:.3g}) lse_err="
                  f"{lse_err:.3e} grads {rel:.3e} × max (tol "
                  f"{sm.GRAD_TOL[dtype]:g}){'' if ok else ' FAILED'}",
                  flush=True)
            return got if ok else None
        turns = in_turns([n for n, (dt, _) in WIDE_VARIANTS.items()
                          if dt == dtype], run_one)
        if not turns:
            return {}
        means.update({n: {key: float(np.mean([x[key] for x in runs]))
                          for key in runs[0]}
                      for n, runs in turns.items()})
        del q, k, v, dout, ref, ref_lse, want, out, lse, grads, ds, delta
        torch.cuda.empty_cache()
    means["clock shares"] = shares
    return means


def run_wg(libs: dict, iters: int) -> dict:
    """``--kernel wg`` at ``WG_SHAPES``, bf16, bias-free, every key valid:
    each variant's forward (with its LSE) and backward through its raw
    launchers, held to the plain twins, then in turns the forward's and
    backward's ms (CUDA events over the launchers) and the device ms of
    the forward, the dK/dV pass, the pre-pass (wgmma) and the dQ pass. The
    baseline runs the parent's bias-free bf16 instantiations at head width
    64 or 128 (48 zero-padded to 64, as its route did), its delta by the
    torch ops of its launcher."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention as fa
    used = {"attention_fwd_bias_mma": ("wfl_attention_fwd_bias_mma",),
            "attention_bwd_bias_mma": ("wfl_attention_bwd_bias_mma",
                                       "wfl_attention_bwd_dq_mma")}
    cdlls = {name: {src: _build.bind(
        ctypes.CDLL(lib), src,
        used.get(src) if name not in WG_BASELINE else used.get(src)[:1])
        for src, (lib, _) in by_src.items()}
        for name, by_src in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    means = {}
    for b, h, t, d in WG_SHAPES:
        width = 64 if d <= 64 else 128
        kv = torch.full((b,), t, dtype=torch.int32, device="cuda")
        q, k, v, _, _ = sm.attn_inputs(gen, (b, h, t, d), torch.bfloat16,
                                       False)
        dout = (torch.rand((b, h, t, d), generator=gen, device="cuda") * 2
                - 1).to(torch.bfloat16)
        ref, ref_lse = fa.attention_plain(q, k, v, None, None, kv,
                                          return_lse=True)
        want = fa.attention_backward_plain(q, k, v, None, None, kv, ref,
                                           ref_lse, dout)[:3]
        top = ref.float().abs().max().item()
        scale = 1.0 / math.sqrt(d)
        ldk = -(-t // 64) * 64
        ds = torch.empty((b, h, t, ldk), dtype=torch.bfloat16, device="cuda")
        ws = torch.empty((2, b * h, ldk), device="cuda")
        lse = torch.empty((b, h, t), device="cuda")
        padded = [F.pad(x, (0, width - d)).contiguous()
                  for x in (q, k, v, dout)]

        def runners(n):
            lib = cdlls[n]
            if n in WG_BASELINE:
                pq, pk, pv, pdo = padded
                out = torch.empty_like(pq)
                grads = [torch.empty_like(pq) for _ in range(3)]
                fwd_fn = lib["attention_fwd_bias_mma"] \
                    .wfl_attention_fwd_bias_mma
                bwd_fn = lib["attention_bwd_bias_mma"] \
                    .wfl_attention_bwd_bias_mma

                def forward():
                    return fwd_fn(pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                                  None, None, kv.data_ptr(), out.data_ptr(),
                                  lse.data_ptr(), None, b, h, t, width, scale,
                                  0, 1.0, 1, stream)

                def backward():
                    delta = (pdo.float() * out.float()).sum(-1).contiguous()
                    return bwd_fn(pq.data_ptr(), pk.data_ptr(),
                                  pv.data_ptr(), None, None, pdo.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(),
                                  kv.data_ptr(), None,
                                  *[g.data_ptr() for g in grads],
                                  ds.data_ptr(), None, None, b, h, t, width,
                                  ldk, scale, 0, 1.0, 1, stream)
                return forward, backward, out, grads
            out = torch.empty_like(q)
            dk, dv = torch.empty_like(q), torch.empty_like(q)
            kw = padded[1]
            dq = torch.empty_like(kw)
            wg, dql = lib["attention_wgmma"], lib["attention_bwd_bias_mma"]

            def forward():
                return wg.wfl_attention_wgmma_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), None, b, h, t, d, width,
                    scale, 0, 1.0, stream)

            def backward():
                return (wg.wfl_attention_wgmma_delta(
                    out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    ws.data_ptr(), b, h, t, d, stream)
                    or wg.wfl_attention_wgmma_dkdv(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), ws.data_ptr(), kv.data_ptr(), None,
                        dk.data_ptr(), dv.data_ptr(), ds.data_ptr(), b, h, t,
                        d, width, ldk, scale, 0, 1.0, stream)
                    or dql.wfl_attention_bwd_dq_mma(
                        kw.data_ptr(), kv.data_ptr(), ds.data_ptr(),
                        dq.data_ptr(), b, h, t, width, ldk, scale, 1, stream))
            return forward, backward, out, [dq, dk, dv]

        def run_one(n):
            forward, backward, out, grads = runners(n)

            def checked(fn, what):
                def run():
                    err = fn()
                    if err:
                        raise SystemExit(f"{n}: {what} failed, error {err}")
                return run
            fwd, bwd = checked(forward, "forward"), checked(backward,
                                                            "backward")
            fwd()
            bwd()
            torch.cuda.synchronize()
            err = (out[..., :d].float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            rel = max((g[..., :d].float() - w.float()).abs().max().item()
                      / w.float().abs().max().item()
                      for g, w in zip(grads, want))
            ok = (err <= sm.ATTN_TOL["bf16"] * top and lse_err <= sm.LSE_TOL
                  and rel <= sm.GRAD_TOL["bf16"])
            got = {"fwd_ms": sm.time_ms(fwd, iters),
                   "bwd_ms": sm.time_ms(bwd, iters)}
            by = sm.device_ms_by_kernel(lambda: (fwd(), bwd()))
            parts = {"fwd": ("attn_wg_fwd<", "attn_bias_fwd_mma<"),
                     "dkdv": ("attn_wg_dkdv<", "attn_bias_bwd_dkdv_mma<"),
                     "delta": ("attn_wg_delta",),
                     "dq": ("attn_bias_bwd_dq_mma<",)}
            for part, prefixes in parts.items():
                got[part + "_device_ms"] = sum(
                    x for kname, x in by.items() if kname.startswith(prefixes))
            print(f"[variant] {n} [{b},{h},{t},{d}]: forward ms="
                  f"{got['fwd_ms']:.4f} (device {got['fwd_device_ms']:.4f}), "
                  f"backward ms={got['bwd_ms']:.4f} (device dK/dV "
                  f"{got['dkdv_device_ms']:.4f}, pre-pass "
                  f"{got['delta_device_ms']:.4f}, dQ "
                  f"{got['dq_device_ms']:.4f}); max_abs_err={err:.3e} (tol "
                  f"{sm.ATTN_TOL['bf16']:g}×{top:.3g}) lse_err={lse_err:.3e} "
                  f"grads {rel:.3e} × max (tol {sm.GRAD_TOL['bf16']:g})"
                  f"{'' if ok else ' FAILED'}", flush=True)
            return got if ok else None
        turns = in_turns(list(WG_VARIANTS), run_one)
        if not turns:
            return {}
        means[f"[{b},{h},{t},{d}]"] = {
            n: {key: float(np.mean([x[key] for x in runs]))
                for key in runs[0]} for n, runs in turns.items()}
        del q, k, v, dout, ref, ref_lse, want, ds, ws, lse, padded
        torch.cuda.empty_cache()
    return means


def run_k5(libs: dict, iters: int) -> dict:
    """Both chains of each variant through the port's layer loop
    (``conv_fused._launch_layers``) on the variant's library: the ms of
    chain 1 (with the norm), of chain 2, and of the two together."""
    import torch
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import conv_fused as cf
    torch.backends.cudnn.allow_tf32 = False
    cdlls = {name: ctypes.CDLL(lib) for name, (lib, _) in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    means = {}
    for dtype, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        chains = []
        for ks, t_in, with_norm in (((3, 3, 3), 95999, True),
                                    ((3, 2, 2), 11999, False)):
            x, ws, norm = sm.conv_inputs(gen, ks, t_in, 512, with_norm, tdt)
            ref = cf.conv_chain_plain(x, ws, norm)
            chains.append((x, cf.pack_weights(ws, tdt, "cuda"),
                           None if norm is None else
                           [t.float().contiguous() for t in norm], ref,
                           ref.float().abs().max().item()))

        def run_one(n):
            times = []
            lib = cdlls[n]
            for i, (x, packed, norm, ref, scale) in enumerate(chains):
                def run(x=x, packed=packed, norm=norm):
                    if norm is not None and hasattr(lib,
                                                    "wfl_conv_norm_pass"):
                        fn = lib.wfl_conv_norm_pass
                        fn.restype = ctypes.c_int
                        fn.argtypes = ([ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p] * 4
                                       + [ctypes.c_int, ctypes.c_void_p])
                        xn = torch.empty_like(x)
                        err = fn(x.data_ptr(), xn.data_ptr(), *x.shape,
                                 *[t.data_ptr() for t in norm],
                                 0 if x.dtype == torch.float32 else 1,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise SystemExit(f"{n}: norm pass error {err}")
                        x, norm = xn, None
                    return cf._launch_layers(x, packed, norm, lib)
                err = (run().float() - ref.float()).abs().max().item()
                ok = err <= sm.CONV_TOL[dtype] * scale and math.isfinite(err)
                times.append(sm.time_ms(run, iters))
                print(f"[variant] {n}: chain {i + 1} ms={times[-1]:.4f} "
                      f"max_abs_err={err:.3e} (tol "
                      f"{sm.CONV_TOL[dtype]:g}×{scale:.3g})"
                      f"{'' if ok else ' FAILED'}", flush=True)
                if not ok:
                    return None
            return times
        turns = in_turns([n for n, (dt, _) in K5_VARIANTS.items()
                          if dt == dtype], run_one)
        if not turns:
            return {}
        for n, ts in turns.items():
            c1, c2 = (float(np.mean([t[i] for t in ts])) for i in (0, 1))
            means[n] = {"chain1_ms": c1, "chain2_ms": c2, "sum_ms": c1 + c2}
        del chains
        torch.cuda.empty_cache()
    return means


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="k2")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--baseline", default=None, nargs="+",
                    help="--kernel wide: the attention_wide.cu to time "
                         "against this tree's; --kernel wg: the "
                         "attention_fwd_bias_mma.cu and "
                         "attention_bwd_bias_mma.cu whose bias-free bf16 "
                         "instantiations to time against the wgmma routes")
    args = ap.parse_args()
    if args.kernel == "wide" and (not args.baseline
                                  or len(args.baseline) != 1):
        ap.error("--kernel wide needs --baseline PATH")
    if args.kernel == "wg" and (not args.baseline
                                or len(args.baseline) != 2):
        ap.error("--kernel wg needs --baseline FWD.cu BWD.cu")
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as sm
    torch.backends.cuda.matmul.allow_tf32 = False
    source, variants = KERNELS[args.kernel]
    print(f"[device] {sm.card_line()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="wfl_variants_")
    try:
        if args.kernel == "wg":
            libs = build_wg(tmp, args.baseline)
            logs = [(name, log) for name, by in libs.items()
                    for _, log in by.values()]
        else:
            libs = build(tmp, source, variants,
                         args.baseline and args.baseline[0], WIDE_BASELINE)
            logs = [(name, log) for name, (_, log) in libs.items()]
        kernel_name = {"k2": ("attn_bias_fwd",), "k1w": ("attn_bias_fwd",),
                       "k128": ("attn_bias_fwd",),
                       "k128b": ("attn_bias_bwd",),
                       "k5": ("conv_layer_mma",), "wide": ("attn_wide_",),
                       "wg": ("attn_wg_", "bias_fwd_mma<PolBF16, false",
                              "bias_bwd_dkdv_mma<PolBF16, false",
                              "dq_mma<PolBF16")}
        for name, log in logs:
            for line in sm.ptxas_summary(log):
                if any(k in line for k in kernel_name[args.kernel]):
                    print(f"[ptxas] {name}: {line}", flush=True)
        means = {"k2": run_k2, "k1w": run_k1w, "k128": run_k128,
                 "k128b": run_k128b, "k5": run_k5, "wide": run_wide,
                 "wg": run_wg}[args.kernel](libs, args.iters)
        if not means:
            return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": sm.card_line(), "kernel": args.kernel,
                      "mean_ms": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
