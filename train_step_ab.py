"""Time the default f32 training step of the port on one GPU: one checkout
against another, in turns, on the same batch.

    python3 train_step_ab.py A_DIR B_DIR     # turns A, B, B, A
    python3 train_step_ab.py --one DIR       # one turn

DIR is the root of a checkout that holds ``wfl_asr_tpu_torch``. A turn is a
process of its own that imports the package from DIR, builds its kernels,
makes the flagship tagger at full width (``chip_smoke.train_config``'s
recipe: WavLM-base-plus, BiLSTM ×2, Conformer ×2 at head_dim 384; random
weights from seed 3) and one batch of 8 wavs of 20-29 s (seed 7), takes 2
warm-up steps (f32, Prodigy, dropout at the recipe's rates, PyTorch's
default TF32 flags as ``chip_smoke.py`` phase 6 sets them), times
``--steps`` steps with CUDA events, and profiles one more (device busy
time, idle share, the attention kernels, forward and backward). Its last line is one JSON object.
The A/B run prints each turn's output, then one JSON line with each side's
medians and idle shares and B's mean median over A's.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS, SECONDS, NUM_LABELS = 8, 29.0, 73
WARMUP = 2


def smoke():
    """The ``chip_smoke.py`` beside this file (not the checkout's own), for
    its training recipe, card line and profiler."""
    spec = importlib.util.spec_from_file_location(
        "train_step_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_batch() -> dict:
    """8 rows of audio, the first 29 s and the rest 20-29 s, zero-padded,
    with −100-padded labels and offset targets, from a seed."""
    from wfl_asr_tpu_torch.train.losses import offset_targets_from_segments
    rng = np.random.RandomState(7)
    frames = int(SECONDS / 0.02)
    secs = [SECONDS] + list(rng.uniform(20.0, SECONDS, ROWS - 1))
    audio = np.zeros((ROWS, int(SECONDS * 16000)), np.float32)
    labels = np.full((ROWS, frames), -100, np.int64)
    targets = []
    for i, sec in enumerate(secs):
        n_audio = int(sec * 16000)
        audio[i, :n_audio] = rng.randn(n_audio) * 0.1
        n = min(int(sec / 0.02), frames - 1)
        labels[i, :n] = rng.randint(0, NUM_LABELS, size=n)
        edges = np.cumsum(rng.uniform(0.05, 0.2, size=int(sec / 0.05) + 2))
        segs = [(float(a), float(b), "p1") for a, b in zip(edges, edges[1:])
                if b < n * 0.02]
        targets.append(offset_targets_from_segments(segs, 0.02, n, 192))
    f, c, x, v = (np.stack([t[j] for t in targets]) for j in range(4))
    return {"audio": audio, "labels": labels,
            "lang_ids": np.arange(ROWS, dtype=np.int32) % 2,
            "off_frames": f, "off_channels": c, "off_fracs": x,
            "off_valid": v, "max_label_len": frames}


def turn(root: str, steps: int) -> dict:
    """One turn on the package of the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_step_ab: no CUDA device")
    import wfl_asr_tpu_torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import KERNEL_SOURCES, _build, \
        flash_attention, flash_attention_bwd
    from wfl_asr_tpu_torch.train import loop
    sm = smoke()
    _build.build_all(list(KERNEL_SOURCES))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    cfg = Config(sm.train_config("/nonexistent"))
    cfg.num_languages = 2
    model = init_tagger(TaggerArch.from_config(cfg, NUM_LABELS),
                        torch.Generator().manual_seed(3), "cuda")
    opt = loop.make_optimizer(cfg, model.parameters())
    batch = make_batch()
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step():
        m, _, _ = loop.train_step(model, opt, batch, "cuda", 0.1, 3.0,
                                  generator=gen)
        return m["loss"], m
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()[0]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    counts = {"K2b": flash_attention.bwd_launches,
              "K1b": flash_attention_bwd.bwd_launches,
              "mma pair": getattr(flash_attention, "mma_bwd_launches", None),
              "mma bias passes": getattr(flash_attention,
                                         "mma_bias_bwd_launches", None),
              "mma fwd": getattr(flash_attention, "mma_fwd_launches", None),
              "mma bias fwd": getattr(flash_attention,
                                      "mma_bias_fwd_launches", None)}
    prof = sm.profile_step(step, what="one f32 train step", top=0)
    attn = {}
    for name, (us, n) in prof["kernels"].items():
        if ("_bwd_" in name or "_fwd_" in name) and "::" in name:
            short = name.split("::", 1)[1].split("(")[0]
            acc = attn.setdefault(short, [0.0, 0])
            acc[0] += us / 1e3
            acc[1] += n
    return {"root": root,
            "package": os.path.dirname(wfl_asr_tpu_torch.__file__),
            "card": sm.card_line(), "median_ms": float(np.median(times)),
            "steps_ms": times, "loss": float(loss),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: n // steps if n is not None else None
                         for k, n in counts.items()},
            "profiled": {k: prof[k] for k in ("wall_ms", "busy_ms", "idle")},
            "attention_kernels_ms": attn}


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Time the f32 train step, one checkout against another.")
    ap.add_argument("roots", nargs="*", metavar="DIR")
    ap.add_argument("--one", metavar="DIR", help="run one turn on DIR")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(turn(args.one, args.steps)), flush=True)
        return 0
    if len(args.roots) != 2 or args.roots[0] == args.roots[1]:
        ap.error("give two different checkout roots, A and B")
    a, b = args.roots
    got = {a: [], b: []}
    for root in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--steps", str(args.steps)], capture_output=True, text=True,
            timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(f"train_step_ab: the turn on {root} exited "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        got[root].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {side: {"root": root,
                      "median_ms": [t["median_ms"] for t in got[root]],
                      "idle": [t["profiled"]["idle"] for t in got[root]],
                      "busy_ms": [t["profiled"]["busy_ms"]
                                  for t in got[root]]}
               for side, root in (("A", a), ("B", b))}
    summary["B/A"] = (float(np.mean(summary["B"]["median_ms"]))
                      / float(np.mean(summary["A"]["median_ms"])))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
