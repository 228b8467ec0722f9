"""Time variants of a kernel source on one card, in turns.

    python3 kernel_variants_ab.py [--kernel k2|k5] [--iters N]

Each variant is the kernel's source with some of its tile constants
replaced as text (``K2_VARIANTS``: ``csrc/attention_fwd_bias_mma.cu``, the
gated-bias attention forward; ``K5_VARIANTS``: ``csrc/conv_fused.cu``, the
conv layer). Every variant builds with the port's ``nvcc`` flags into a
library of its own (all started together), runs at the main shapes (K2:
[8, 12, 1499, 64] with its LSE, kv_len 1499 − 100·b, bias and gate; K5:
chain 1 [8, 95999, 512] → [8, 11999, 512] with the layer-0 norm, and
chain 2 [8, 11999, 512] → [8, 1499, 512]), is held against the plain twin
within ``chip_smoke.py``'s tolerances, and is timed with CUDA events (the
median of ``--iters`` calls of its launcher) in turns: the variants of a
dtype in order, then in reverse. Prints each variant's ``[ptxas]`` lines,
one line a variant, and a last JSON line of the mean times.
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

# name: (dtype, [(text of the source, its replacement), ...])
K2_VARIANTS = {
    "bf16 8 warps": ("bf16", []),
    "bf16 4 warps": ("bf16", [("int warps = kF32 ? 4 : 8;",
                               "int warps = kF32 ? 4 : 4;")]),
    "bf16 8 warps, 32-key tiles": ("bf16", [("int bk = kF32 ? 32 : 64;",
                                             "int bk = kF32 ? 32 : 32;")]),
    "f32 4 warps": ("f32", []),
    "f32 4 warps, 2 mma steps a fresh sum": ("f32", [("KD = kD / Pol::KS, CH = 4;",
                                                      "KD = kD / Pol::KS, CH = 2;")]),
    "f32 4 warps, 8 mma steps a fresh sum": ("f32", [("KD = kD / Pol::KS, CH = 4;",
                                                      "KD = kD / Pol::KS, CH = KD;")]),
    "f32 4 warps, 3 blocks a SM": ("f32", [("int blocks = 2;",
                                            "int blocks = kF32 ? 3 : 2;")]),
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

KERNELS = {"k2": ("attention_fwd_bias_mma.cu", K2_VARIANTS),
           "k5": ("conv_fused.cu", K5_VARIANTS)}


def build(tmp: str, source: str, variants: dict) -> dict:
    """One library per variant from a copy of ``csrc/`` with the variant's
    replacements; returns {name: (library path, nvcc output)}."""
    from wfl_asr_tpu_torch.ops.kernels import _build
    procs = {}
    for i, (name, (_, subs)) in enumerate(variants.items()):
        src = os.path.join(tmp, f"v{i}")
        shutil.copytree(_build.CSRC, src)
        path = os.path.join(src, source)
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
    fns = {name: fa._fwd_launcher(getattr(ctypes.CDLL(lib),
                                          "wfl_attention_fwd_bias_mma"))
           for name, (lib, _) in libs.items()}
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
    args = ap.parse_args()
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
        libs = build(tmp, source, variants)
        kernel_name = {"k2": "attn_bias_fwd", "k5": "conv_layer_mma"}
        for name, (_, log) in libs.items():
            for line in sm.ptxas_summary(log):
                if kernel_name[args.kernel] in line:
                    print(f"[ptxas] {name}: {line}", flush=True)
        means = (run_k2 if args.kernel == "k2" else run_k5)(libs, args.iters)
        if not means:
            return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": sm.card_line(), "kernel": args.kernel,
                      "mean_ms": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
