"""Time variants of K2's forward source on one card, in turns.

    python3 kernel_variants_ab.py [--iters N]

Each variant is ``csrc/attention_fwd_bias_mma.cu`` with some of its tile
constants replaced as text (``VARIANTS``). Every variant builds with the
port's ``nvcc`` flags into a library of its own (all started together),
runs the gated-bias forward with its LSE at the main shape ([8, 12, 1499,
64], kv_len 1499 − 100·b, bias and gate), is held against the plain twin
within ``chip_smoke.py``'s tolerances, and is timed with CUDA events (the
median of ``--iters`` launches of its launcher) in turns: the variants of a
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

SOURCE = "attention_fwd_bias_mma.cu"
LAUNCHER = "wfl_attention_fwd_bias_mma"
# name: (dtype, [(text of the source, its replacement), ...])
VARIANTS = {
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


def build(tmp: str) -> dict:
    """One library per variant from a copy of ``csrc/`` with the variant's
    replacements; returns {name: (library path, nvcc output)}."""
    from wfl_asr_tpu_torch.ops.kernels import _build
    procs = {}
    for i, (name, (_, subs)) in enumerate(VARIANTS.items()):
        src = os.path.join(tmp, f"v{i}")
        shutil.copytree(_build.CSRC, src)
        path = os.path.join(src, SOURCE)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as sm
    from wfl_asr_tpu_torch.ops.kernels import _build, flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {sm.card_line()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="wfl_variants_")
    try:
        libs = build(tmp)
        for name, (_, log) in libs.items():
            for line in sm.ptxas_summary(log):
                if "attn_bias_fwd" in line:
                    print(f"[ptxas] {name}: {line}", flush=True)
        fns = {name: fa._fwd_launcher(getattr(ctypes.CDLL(lib), LAUNCHER))
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
            names = [n for n, (dt, _) in VARIANTS.items() if dt == dtype]
            turns = {n: [] for n in names}
            for n in names + names[::-1]:
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
                ms = sm.time_ms(run, args.iters)
                turns[n].append(ms)
                print(f"[variant] {n}: ms={ms:.4f} max_abs_err={err:.3e} "
                      f"(tol {sm.ATTN_TOL[dtype]:g}×{scale:.3g}) "
                      f"lse_err={lse_err:.3e}{'' if ok else ' FAILED'}",
                      flush=True)
                if not ok:
                    return 1
            means.update({n: float(np.mean(ms)) for n, ms in turns.items()})
            del q, k, v, bias, gate, ref, ref_lse, out, lse
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": sm.card_line(), "mean_ms": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
