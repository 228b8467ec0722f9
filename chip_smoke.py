"""Chip smoke test of the PyTorch/CUDA port (``wfl_asr_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --only kernels  # build + kernel-vs-plain phases only
    python3 chip_smoke.py --only conv     # build + K5's part of phase 3 only
    python3 chip_smoke.py --only train    # build + training phases 6-7 only
    python3 chip_smoke.py --only whisper  # build + phases 3e and 8-9f only
    python3 chip_smoke.py --only modules  # build + phases 10a-10f only
    python3 chip_smoke.py --only optim    # build + phases 10e-10f only
    python3 chip_smoke.py --only parallel # build + phase 11 only
    python3 chip_smoke.py --only pp       # build + phase 11d only
    python3 chip_smoke.py --only remat-det  # build + 10a deterministic

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build every kernel from ``wfl_asr_tpu_torch/ops/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel's entry point (``flash_attention``,
   ``flash_attention_trainable``, ``fused_conv_chain``) against its plain
   PyTorch twin on the card, at the full-width shapes of the WavLM-base
   main path, in f32 (TF32 off) and bf16, on inputs whose outputs are of
   order 1 (peaked attention over values in [-1, 1]; conv activations of
   unit scale, so every GELU works in its curved range), with median times
   over CUDA-event timings, the plain twin's time, one PyTorch library
   call's time where one computes the same function, and the least time
   the card could take (``bound_ms``); the forwards also with their row
   LSE, each shown by the launch counts to take the route
   ``forward_route`` names (K1: the mma.sync forward of
   ``attention_fwd_mma.cu``; K2: the mma.sync forward with a bias of
   ``attention_fwd_bias_mma.cu``); K5 (``conv_fused.cu``, one launch a
   layer, shown by ``layer_launches``) with the cuDNN chain (one
   ``F.conv1d`` + ``F.gelu`` a layer, TF32 off) as its library yardstick,
   f32 bounds at the 3×TF32 ceiling, each layer's time and layer 1's
   without the layer-0 norm, and small ragged widths (C = 80 f32, 48 bf16, odd T, 1-2 layers);
4. the main path: a full-width WavLM-base-plus tagger (random weights from
   a ``torch.Generator`` seed) saved as ``.pt``, 8 synthetic wavs of ≤ 30 s,
   ``infer_folder_batched`` on the card in bf16 with the device decode —
   launch counts reset just before and read just after — then the batched
   forward with gate and median at B=8×30 s (bench.py's definition), timed
   with its peak memory, and one bf16 step profiled (12 launches of the
   mma.sync forward with a bias, none of ``flash_attention.cu``'s
   ``flash_fwd_mma<64>``, 6 of K5's ``conv_layer_mma``, 3 a chain);
5. the card against the CPU, f32 (TF32 off): one 30 s utterance through
   ``InferenceSession.forward`` (unmasked), and the 8 wavs of unequal
   length through ``forward_many_decoded`` (sample and frame masks, masked
   GroupNorm statistics, unequal key lengths, the packed BiLSTM, the
   device decode): logits must agree to ≤ 1e-3 on every row's valid
   frames;
6. the training path at full width: 24 synthetic wavs of 20-30 s with
   ``.lab`` files in two languages, ``preprocess``, then ``train`` on the
   card (the default recipe: Prodigy at lr 1, dropout at its config values,
   f32, batch 8, 6 steps, validation every 3) with the launch counts reset
   just before and read just after (12 K2b launches a step on the
   mma.sync passes with a bias, 2 K1b on the mma.sync pair, none on the
   FMA pair; 12 K2 and 2 K1 a forward, each on its mma.sync forward, as
   in phases 4, 6b and 7);
   step times, audio-seconds trained per second, peak memory, one profiled
   step, ``last_model.pt`` reloaded to the same logits, ``best_model.pt``
   served by ``infer_folder_batched``, a bf16 step;
7. one train step (f32, TF32 off, full width, B=2×8 s, dropout 0), the
   card against the CPU: loss ≤ 1e-5 relative, gradients ≤ 1e-3 × max.
   Where ReLU inputs of the dilated conv stack take the other branch on
   the card (inputs within rounding of 0), the card step on its own
   branches keeps its loss held to 1e-5 and its worst gradient diff
   printed, and a rerun on the CPU's branches is held to both
   tolerances; more than RELU_MAX_PINNED = 4 such inputs, or one above
   RELU_TIE = 3e-5 on either device, fails;
8. Whisper-base serving (``encoder_type: whisper``, the flagship heads):
   the tagger saved as .pt and served by ``infer_folder_batched`` on the
   card in bf16 over a copy of phase 4's wavs, the launch counts set to 0 just
   before and read just after (a forward: 6 K1 on the bf16 wgmma forward
   of ``attention_wgmma.cu`` at D = 64, route wgmma64, 2 on the bias-free
   mma.sync forward of ``attention_fwd_mma.cu``, none on the fused
   forwards); the batched forward timed at B=8×30 s in bf16
   and f32 with its peak memory; one bf16 step profiled; one bf16 forward
   of the ``large-v3`` preset at full width (its Conformer at the
   config's 2 heads, head_dim 640: 2 forwards on the wide route of
   ``attention_wide.cu``, 32 on wgmma64), timed;
   8b. the card against the CPU as in phase 5, for Whisper-base and for the
   ``none`` encoder at full width (80 mels; unequal lengths take the
   host's reflect padding and the precentered STFT);
   8c. Whisper-base without the config's ``conformer_heads`` key, so the
   Conformer runs the schema's default of 4 heads at head_dim 128: served
   as in phase 8 (a bf16 forward: 6 K1 on wgmma64, 2 on the wgmma forward
   at D = 128, route wgmma128, none fused), timed at B=8×30 s
   in bf16 and f32 with its peak memory, one bf16 step profiled; 8d. its
   card against the CPU as in phase 5;
9. Whisper-base training: preprocess and train on phase 6's corpus (f32,
   batch 8, 4 steps, validation after the last) with the plain attention
   twins stubbed to raise; a step: 6 K1b on the bias-free D = 64 passes
   of ``attention_bwd_bias_mma.cu``, 2 on the mma.sync pair, none on the
   FMA pair; step times, audio-s/s, peak memory, a profiled step,
   ``last_model.pt`` reloaded to the same logits; 9b. one f32 Whisper-base
   train step at B=2×30 s, the card against the CPU, under phase 7's
   rules; 9c. the ``large-v3`` preset at full width (Conformer at 2 heads,
   head_dim 640; encoder trained) takes 2 f32 Prodigy steps through
   ``loop.train_step`` at B=2×30 s: finite loss and gradients, 2 forwards
   and 2 backwards on the wide route of ``attention_wide.cu`` and 32 of
   each on the D = 64 one in the first step, the step's ms and peak
   memory; 9d. phase 9 at the schema's 4 Conformer heads (a step: 6 K1b
   on the bias-free D = 64 passes, 2 on the bias-free D = 128 passes,
   route mma128, none on the mma.sync pair or the FMA pair); 9f. the bf16
   training path: that model with ``training.compute_dtype: bfloat16``,
   its f32 and bf16 losses on one batch and weights, then 2 bf16 steps at
   B = 8 × 30 s (a step: 6 backwards on the wgmma route at D = 64, 2 at
   D = 128, none on mma64/mma128), the step's ms, audio-s/s, peak memory
   and profiled busy and idle share; 9e. its card-vs-CPU train step at
   B=2×30 s under phase 7's rules;
10. the modules of the port beyond the kernels (``--only modules``):
   10a. remat on WavLM-base-plus (f32, TF32 off, B = 8 of 20-30 s): one
   step without and one with ``remat``, from the same model, Prodigy
   state, batch and generator state, for the default dropout and with
   strict attention dropout — loss ≤ 1e-6 relative, gradients ≤ 1e-5 ×
   max|g|, peak memory and ms for both, 12 K2 forwards a plain step and
   24 a remat one (12 recomputed); 10b. ``training.remat: auto`` on
   phase 9c's ``large-v3`` at B = 8 × 30 s through the train loop's
   ``RematStep``: the plain step overflows the card and it must flip; two
   steps, the OOM's message, ms, peak memory and launches; 10c.
   ``model.serving_quantization: int8`` against the bf16 session at B =
   8 × 30 s: audio-s/s in turns, peak memory, K5/K2/K1 launches, the JAX
   test's cosine, agreement and offset bounds, and one int8 product's
   int32 accumulator card == CPU; 10d. ``python -m
   wfl_asr_tpu_torch.correct_label`` on 8 generated 30 s wavs in a
   subprocess, its ``.lab`` files equal to ``process_file``'s in
   process; 10e. every optimizer name (Prodigy and the 26 optax names of
   ``train/optimizers.py``) on one set of full-width WavLM-base-plus
   gradients (B = 2 × 30 s, f32): 3 steps on the card and on the CPU from
   the same weights, the lr halved before the last, the parameters held
   card against CPU per family (``OPT_REL``; sign and threshold flips of
   lion, rprop, adopt and yogi counted and bounded); each name's step
   wall ms, kernels and device ms of a profiled step, and state bytes;
   10f. ``loop.train`` on phase 6's corpus with AdamW, Lamb and Adafactor
   (2 steps, validation after the last): finite losses, ``last_model.pt``
   reloaded to the same logits, the Lamb run's ``WFL_PROFILE_DIR`` trace
   naming ``attn_bias_fwd_mma``, the validation figures' events when
   tensorboardX and matplotlib are there (else a line saying which is
   absent);
11. data, fully-sharded, tensor and sequence parallelism (``--only
   parallel``): 11a. the attention kernels on shards — K2 + K2b at
   WavLM's [8, 12, 1499, 64] with bias and gate, K1 + K1b at the
   Conformer's [8, 2, 1499, 384] and at Whisper's [8, 8, 1500, 64]
   (wgmma64 in bf16, mma64 in f32), f32 and bf16, strict dropout at 0.1,
   ragged kv_len: the batch and the heads each split in two, each shard
   called through the entry point with its slices and its origin; 0 mask
   bits off (3d's read-out against the plain mask at the shard's global
   indices), out, LSE, dQ, dK, dV and dGate equal to the unsharded slices
   and dBias summed over the batch halves, within the kernels'
   tolerances; 11b. ``python -m torch.distributed.run --nproc_per_node 1``
   worlds of one over NCCL on phase 6's corpus (WavLM-base-plus at 4 of
   its 12 layers, f32, 2 steps; the rank runs ``loop.train`` through
   ``--rank-train``): with
   DDP, and with ``training.fsdp`` and ``sharded_validation``; the first
   step's loss within 1e-5 of the plain loop's on the same batch and
   FSDP's second within 1e-5 of DDP's, step ms, peak memory and K2/K2b launches (counts 0 just before the run, read
   just after); 11c. ``infer_folder_batched(data_parallel=True)`` in an
   NCCL world of one, its ``.lab`` files byte-identical to phase 4's, with
   its K2/K1/K5 launches; 11d. pipeline parallelism: a ``python -m
   torch.distributed.run --nproc_per_node 2`` world over ``gloo`` on the
   one card (NCCL refuses two ranks on one device; the layers and kernels
   run on ``cuda:0`` in both ranks, activations move through host
   buffers), each rank running ``--rank-pp`` under this process's TF32
   flags (the plain loop's reference loss is taken meanwhile in this
   process): ``loop.train`` on phase 6's
   corpus with ``training.pipeline_parallel: 2`` and ``pp_microbatches:
   4`` (WavLM-base-plus at full width, its depth cut to PP_LAYERS layers,
   f32, B = 8, 2 steps, every dropout rate and LayerDrop at 0 so that the
   steps are comparable), its first loss within 1e-5 of the plain loop's
   on the same batch and its second within 1e-5 of a DDP world of one's
   (run by rank 0 after the pipeline, on the same config without
   ``pipeline_parallel``), each rank's step ms, peak memory and parameter
   bytes against the whole model's, its K2/K2b launches equal to its
   layers × 4 microbatches × 2 steps (no warm-up or drain ticks) and its
   K1/K1b of the replicated Conformer heads, the replicated parameters
   equal on both ranks; then ``infer_folder_batched`` with
   ``model.pipeline_parallel: 2`` on phase 4's wavs and model, its ``.lab``
   files byte-identical to phase 4's or each differing line listed, with
   its K5 and K2 launches per rank;
12. a ``[time]`` line (wall seconds by phase), a ``{"kernels": [...]}``
   line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Phase 3 includes 3b: the backward kernels (K2b, K1b) through
``flash_attention(...)`` / ``flash_attention_trainable(...)`` then
``.backward``, at the training shapes, against
``attention_backward_plain``, each shown by the launch counts to run the
route ``backward_route`` names (K1b: the mma.sync pair of
``attention_bwd_mma.cu``; K2b: the three mma.sync passes of
``attention_bwd_bias_mma.cu``, dK/dV, dQ and dBias/dGate; bias-free at
head_dim ≤ 64 their bias-free instantiation in f32, dK/dV and dQ, and in bf16 the pre-pass and wgmma
dK/dV pass of ``attention_wgmma.cu`` with that dQ pass; above 512 the
passes of ``attention_wide.cu``; bias-free at 80-128 the same at D = 128;
other widths up to 512 with a bias: the FMA
pair of ``flash_attention.cu``), with the
device time of each kernel of the call; 3c: strict attention dropout (K6) inside
all four, forward and backward, at the main shapes in f32 and bf16 at
rates 0.1 and 0.15 against the plain twins with the same mask, timed with
and without dropout beside SDPA with ``dropout_p`` (the bf16 forward held
element by element to its rounding bound, and a mask of another seed
shown to fail the same limit; K1b's and K2b's backwards shown to fail the
plain twin of seed + 1); the head-width sweep (``head_dims``), with bias
at 16-512 (64 on the mma.sync forward with a bias and the mma.sync
passes, there also without gate and with a bias whose base is not
16-byte aligned) and at 528-2048 (the wide route), bias-free at 16-64
(f32: the bias-free D = 64 route mma64; bf16: wgmma64), 80-128 (mma128;
wgmma128),
144-512 (mma.sync) and 528-2048 (wide), and strict dropout bias-free at
64, 128 and 640, each forward's and backward's route shown by the launch
counts; 3d: the mask
of each forward variant (the mma.sync forward of
``attention_fwd_bias_mma.cu`` at D = 64 with a zero bias and a unit gate,
and its bias-free f32 instantiations at D = 64 and 128, the bf16 wgmma
forward at D = 64 and 128 and, through dV, its dK/dV pass; the f32 FMA
and bf16 ``mma.sync``
forwards of ``flash_attention.cu`` at D = 48 with a zero bias; the
mma.sync forward of ``attention_fwd_mma.cu`` at D = 384; the wide forward
of ``attention_wide.cu`` at D = 640, bias-free in f32 and with a zero
bias in bf16; the others in f32 and bf16), read off bit for bit at
T=1499 over every query and key tile, and the kept share at the main
shape; 3e: K1 and K1b at the Whisper paths' shapes, bias-free, in f32
and bf16, at [8, 8, 1500, 64] (Whisper-base's layers) and [8, 2, 1500,
40] (the ``none`` encoder's Conformer, padded to 48 by the entry point),
both on the bias-free D = 64 route (f32 mma64, padded to 64; bf16
wgmma64 at the tensors' width), and at [8, 2, 1500, 640] (large-v3's
Conformer at 2 heads, the wide route), and at [8, 4, 1500, 128]
(Whisper-base's Conformer at the schema's 4 heads) and [8, 4, 1500, 96],
both on the bias-free D = 128 route (mma128, wgmma128), against the
plain twins, timed beside SDPA (without a mask where every key is valid)
and the bound, with the device time of each kernel; in bf16 also with
ragged key lengths, and a ``[gap]`` line of entry less device ms; at
[8, 4, 1500, 128] also the fused forward and the FMA pair of
``flash_attention.cu`` through their launchers, held to the plain twins,
their device ms beside the D = 128 route's (``[mma128]``,
``[wgmma128]`` lines). After the build,
``[cluster]`` lines give the wide route's cluster plan and resident
clusters of each instantiation.

Phase 6 includes 6b: the flagship recipe with
``training.strict_attention_dropout: true`` (4 steps, validation at the
last) with the plain attention twins replaced by stubs that raise; 12 K2 +
2 K1 dropout forwards and 12 K2b + 2 K1b dropout backwards a step, each
on its mma.sync route (the profiled step's kernel names too); step times strict against not, on one batch in
turns; peak memory; a profiled strict step; a bf16 strict step. Phase 7 includes 7b: one strict f32 train
step, the card against the CPU, with fixed attention seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s for bf16 on tensor cores and f32 outside them. "tf32x3" is the
# ceiling of f32 work done as three TF32 products on the tensor cores
# (495 TFLOP/s over 3), as the f32 routes of the mma.sync forward and
# backward kernels do it; their f32 bound is taken at that rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
# INT32 operations/s: 64 INT32 lanes a SM against 128 FP32 ones (Hopper
# architecture white paper), at the clock of the 67 TFLOP/s f32 figure
# (132 SMs × 64 × 1.98 GHz). The dropout hash (K6) costs HASH_OPS of them
# per valid score element: 2 multiply-adds of the pre-mix, three shift-xor
# pairs, two multiplies, the mask, the compare and the select. A bound
# counts it once in the forward and once in the backward, as the backward's
# recomputed S and dP are counted once (its two passes are a choice of this
# design, not work the function needs).
PEAK_INT32_OPS = 16.7e12
HASH_OPS = 12
DROP_RATES = (0.1, 0.15)
DROP_SEED = 1234567
# The profiler's names of the kernels of ops/kernels/csrc/*.cu
PORT_KERNELS = tuple(f"void (anonymous namespace)::{k}" for k in (
    "flash_fwd_", "flash_bwd_", "attn_fwd_", "attn_bwd_", "attn_bias_fwd_",
    "attn_bias_bwd_", "attn_wide_", "attn_wg_", "conv_layer_mma"))

# Tolerances of a kernel against its plain twin on the card, as fractions
# of the reference output's largest magnitude (≈ 1 on the inputs below):
# for bf16 attention 1e-2 is 2.5 bf16 steps of a value in [0.5, 1).
ATTN_TOL = {"f32": 1e-4, "bf16": 1e-2}          # × max|out|
# bf16 attention with dropout, element by element against the f32 plain
# twin on the same (bf16-valued) inputs: the kernel rounds P·M to bf16
# before P·V, which moves out[i] by at most u·A[i] (A = Σ_j p_j·M_j·|v_j|,
# the attention of |v|), and rounds out[i] to bf16, at most u·|out[i]|;
# u = 2⁻⁸ is bf16's unit roundoff. BF16_SLACK and BF16_FLOOR cover the
# f32 exp and sums.
BF16_U = 2.0 ** -8
BF16_SLACK = 1.02
BF16_FLOOR = 1e-5
# The forward's row LSE against the plain twin's, absolute (an LSE is ≈ 10
# on the inputs below).
LSE_TOL = 1e-3
# Backward kernels against the plain twin, per gradient, as fractions of
# that gradient's largest magnitude: bf16 inputs and outputs round dq/dk/dv
# (and the forward's bf16 out enters delta = rowsum(dO·O)), so 2e-2.
GRAD_TOL = {"f32": 1e-4, "bf16": 2e-2}          # × max|grad|
CONV_TOL = {"f32": 1e-3, "bf16": 3e-2}          # × max|out|
# Attention inputs: q·k/√d of std ≈ Q_SCALE, so each row's softmax puts
# its weight on a few keys and the output (a mix of values in [-1, 1]) is
# of order 1 — a wrong mask, bias or normalisation moves it by that much.
Q_SCALE = 3.0
CROSS_DEVICE_TOL = 1e-3                          # card vs CPU logits, f32
# Phase 7's step passes one kink, the ReLUs of the dilated conv stack, whose
# inputs (of order 1) differ between the card and the CPU by rounding (up to
# 1.24e-5 in f32 on an H100). An input closer to 0 than that may take the
# other branch on the other device. A branch that differs at an input above
# RELU_TIE (about 2.4× that gap), or at more than RELU_MAX_PINNED inputs,
# fails; below both, the card step is run again on the CPU's branches, and
# the loss of the step on the card's own branches is still held to its
# tolerance (the loss is continuous across the kink).
RELU_TIE = 3e-5
RELU_MAX_PINNED = 4

B, T = 8, 1499          # batch rows and frames of a 30 s chunk


def log(msg: str) -> None:
    print(msg, flush=True)


LAPS: dict = {}         # wall seconds by phase, summed over its calls


@contextlib.contextmanager
def lap(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        LAPS[name] = LAPS.get(name, 0.0) + time.time() - t0


def log_laps() -> None:
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in LAPS.items())
        + f"; total {sum(LAPS.values()):.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of ``iters`` CUDA-event timings of one call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ptxas_summary(text: str):
    """One line per kernel of nvcc's ``-Xptxas -v`` report: the kernel's
    name (demangled by ``c++filt`` where the toolkit's host has it),
    registers and spills."""
    names, out, cur, spill = [], [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            cur, spill = line.split("Function properties for", 1)[1].strip(), ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and cur is not None:
            names.append(cur)
            out.append(line.split(":", 1)[-1].strip() + "; " + spill)
            cur = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=30,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    short = [n.replace("(anonymous namespace)::", "").split("(")[0]
             for n in names]
    return [f"{n}: {o}" for n, o in zip(short, out)]


def bwd_rate(d: int, with_bias: bool, dtype: str) -> str:
    """The ``PEAK_FLOPS`` key of a backward's products: the 3×TF32
    ceiling for f32 on a tensor-core route, else the dtype's own."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    if dtype == "f32" and fa.backward_route(d, with_bias) != "fma":
        return "tf32x3"
    return dtype


def fwd_rate(d: int, with_bias: bool, dtype: str) -> str:
    """The ``PEAK_FLOPS`` key of a forward's products, by the same rule
    through ``forward_route``: the 3×TF32 ceiling for f32 on an mma.sync
    forward, else the dtype's own."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    if dtype == "f32" and fa.forward_route(d, with_bias) != "fused":
        return "tf32x3"
    return dtype


# The forward routes in the order of ``fwd_counts``, and the backward
# routes in that of ``route_counts``
FWD_ROUTES = ("mma_bias", "mma", "mma64", "wide", "fused", "mma128",
              "wgmma64", "wgmma128")
BWD_ROUTES = ("mma_bias", "mma", "mma64", "wide", "fma", "mma128",
              "wgmma64", "wgmma128")


def fwd_counts():
    """The launch counts of the eight forward routes, in ``FWD_ROUTES``
    order: the mma.sync forward with a bias, the bias-free mma.sync forward
    of ``attention_fwd_mma.cu``, the bias-free f32 instantiation of the
    D = 64 forward, the wide forward of ``attention_wide.cu``, the forwards
    of ``flash_attention.cu``, the bias-free f32 instantiation at D = 128,
    the bf16 wgmma forward of ``attention_wgmma.cu`` at D = 64 and 128."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    return [fa.mma_bias_fwd_launches, fa.mma_fwd_launches,
            fa.mma64_fwd_launches, fa.wide_fwd_launches,
            fa.fused_fwd_launches, fa.mma128_fwd_launches,
            fa.wgmma64_fwd_launches, fa.wgmma128_fwd_launches]


def fwd_launch(run, d, with_bias, what, dtype):
    """Run one forward (``run()``) in ``dtype`` (a torch dtype) and check
    that it took the route ``forward_route`` names, once, and no other
    (each count is raised in the branch of ``launch_kernel`` that launches
    it, after the launch returned no error). Returns what ``run()`` did."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    before = fwd_counts()
    got = run()
    rose = [n - m for n, m in zip(fwd_counts(), before)]
    route = fa.forward_route(d, with_bias, dtype)
    want = [int(route == r) for r in FWD_ROUTES]
    if rose != want:
        raise AssertionError(f"{what}: forward launches {FWD_ROUTES} rose "
                             f"by {rose}, want {want}")
    return got


def cluster_plans() -> None:
    """The wide route's cluster plan (``wfl_attention_wide_plan``) of every
    instantiation at D = 640, and of the bias-free ones without dropout at
    528, 1280 and 2048: the CTAs of a cluster, the width of a rank's D
    slice, the shared memory a block, and how many of its clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``; the dQ pass, which
    runs no clusters: its blocks a SM). Fails where a pass cannot be
    resident."""
    import ctypes
    from wfl_asr_tpu_torch.ops.kernels import _build
    lib = _build.library("attention_wide")
    fn = lib.wfl_attention_wide_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for d in (528, 640, 1280, 2048):
        parts = []
        for dtype, code in (("bf16", 1), ("f32", 0)):
            for npass, name in enumerate(("fwd", "dkdv", "dq")):
                for bias, drop in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    if (bias or drop) and (d != 640 or npass == 2):
                        continue
                    out = (ctypes.c_int * 4)()
                    _build.check(lib, fn(d, code, npass, bias, drop, out),
                                 f"wide plan D={d} {dtype} {name}")
                    kind = "bias" * bias + "+" * (bias and drop) \
                        + "drop" * drop or "plain"
                    unit = "blocks/SM" if npass == 2 else "clusters"
                    parts.append(f"{dtype} {name} {kind}: {out[0]} × "
                                 f"{out[1]} cols, {out[2]} B, {out[3]} "
                                 f"{unit}")
                    if out[3] < 1:
                        raise AssertionError(f"wide {name} {dtype} {kind} "
                                             f"at D={d}: no cluster fits")
        log(f"[cluster] wide route D={d}: " + "; ".join(parts))


def bound_ms(flops: float, nbytes: float, dtype: str, int_ops: float = 0.0):
    """The least time, ms: the largest of ``flops`` over the peak of
    ``dtype`` (a ``PEAK_FLOPS`` key),
    ``int_ops`` over the INT32 rate and ``nbytes`` over the HBM rate. The
    INT32 lanes are a pipe of their own beside the FP32 lanes and the
    tensor cores, so the two operation times overlap and are not added."""
    t_ops = max(flops / PEAK_FLOPS[dtype], int_ops / PEAK_INT32_OPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------

def attn_inputs(gen, shape, dtype, with_bias):
    """q, k, v (and bias, gate) on the card whose attention output is of
    order 1: peaked scores (see Q_SCALE) over values in [-1, 1]."""
    import torch
    b, h, t, _ = shape
    q = torch.randn(shape, generator=gen, device="cuda") * Q_SCALE
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    bias = gate = None
    if with_bias:
        bias = (torch.randn((h, t, t), generator=gen, device="cuda") * 0.5
                ).to(dtype)
        gate = torch.rand((b, h, t), generator=gen, device="cuda") + 0.5
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, gate


def _attn_case(name, gen, h, d, dtype, with_bias, kv, iters, t=T):
    """One forward entry point (``flash_attention`` with bias and gate, or
    ``flash_attention_trainable``) against ``attention_plain`` at [B, h, t,
    d], its LSE (through ``launch_kernel`` on the inputs the entry point
    pads to a multiple of 16) against the plain twin's, timed beside the
    plain twin, SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    dev = "cuda"
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, bias, gate = attn_inputs(gen, (B, h, t, d), tdt, with_bias)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)

    # the entry point the model calls: K2 with bias and gate, K1 without
    if with_bias:
        def entry():
            return fa.flash_attention(q, k, v, bias, gate, kv_len)
    else:
        def entry():
            return flash_attention_trainable(q, k, v, kv_len)
    with torch.inference_mode():
        out = fwd_launch(entry, d, with_bias, f"{name} {dtype}", tdt)
        qp, kp, vp, _, scale = fa.pad_head_dim(q, k, v)
        _, lse = fwd_launch(lambda: fa.launch_kernel(
            qp, kp, vp, bias, gate, kv_len, return_lse=True, scale=scale),
            d, with_bias, f"{name} {dtype} with LSE", tdt)
        del qp, kp, vp
    ref, ref_lse = fa.attention_plain(q, k, v, bias, gate, kv_len,
                                      return_lse=True)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    mean_abs = ref.float().abs().mean().item()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (err <= ATTN_TOL[dtype] * scale and math.isfinite(err)
          and lse_err <= LSE_TOL)
    del lse, ref_lse

    with torch.inference_mode():
        ms = time_ms(entry, iters)
        by_kernel = device_ms_by_kernel(entry)
    plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, bias, gate,
                                                  kv_len), iters)
    # the one PyTorch call computing the same function (yardstick only)
    mask = sdpa_mask(t, h, tdt, kv_len, bias, gate)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters)
    del mask

    es = 4 if dtype == "f32" else 2
    valid_keys = float(sum(kv))
    flops = 4.0 * h * t * valid_keys * d
    nbytes = 4.0 * B * h * t * d * es + B * 4
    if with_bias:
        nbytes += h * t * t * es + B * h * t * 4
    rate = fwd_rate(d, with_bias, dtype)
    bms, by = bound_ms(flops, nbytes, rate)
    log(f"[kernel] {name} {dtype} [{B},{h},{t},{d}] route "
        f"{fa.forward_route(d, with_bias, tdt)} kv_len "
        f"{'all ' + str(t) if min(kv) == t else f'{max(kv)}-{min(kv)}'} "
        f"max_abs_err={err:.3e} "
        f"(tol {ATTN_TOL[dtype]:g}×{scale:.3g}; mean|out| {mean_abs:.3g}) "
        f"lse_err={lse_err:.3e} (tol {LSE_TOL:g}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
        f"bound_ms={bms:.4f} ({by} at {rate}); device ms by kernel "
        + ", ".join(f"{n} {t:.4f}" for n, t in by_kernel.items()))
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs diff {err} exceeds "
                             f"{ATTN_TOL[dtype]}×{scale}, or lse diff "
                             f"{lse_err} exceeds {LSE_TOL}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms,
                device_ms=sum(by_kernel.values()))


def sdpa_mask(t, h, tdt, kv_len, bias, gate):
    """SDPA's ``attn_mask`` for the same function: gate·bias and the key
    mask materialized as [B, h, t, t] in ``tdt``, or None where there is no
    bias and every key is valid (then SDPA may take its flash kernel)."""
    import torch
    keep = torch.arange(t, device="cuda")[None, :] < kv_len[:, None]
    if bias is None and bool(keep.all()):
        return None
    mask = torch.zeros((B, h, t, t), dtype=tdt, device="cuda")
    if bias is not None:
        mask += (gate.detach()[..., None] * bias.detach().float()[None]
                 ).to(tdt)
    return mask.masked_fill_(~keep[:, None, None, :], -1e30)


def route_counts():
    """The launch counts of the eight backward routes, in ``BWD_ROUTES``
    order: the mma.sync passes with a bias, the bias-free mma.sync pair of
    ``attention_bwd_mma.cu``, the bias-free f32 instantiation of the D = 64
    passes, the wide passes of ``attention_wide.cu``, the FMA pair, the
    bias-free f32 instantiation of the passes at D = 128, the bf16 wgmma
    backward (pre-pass, dK/dV pass of ``attention_wgmma.cu``, dQ pass) at
    D = 64 and 128."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    return [fa.mma_bias_bwd_launches, fa.mma_bwd_launches,
            fa.mma64_bwd_launches, fa.wide_bwd_launches,
            fa.fma_bwd_launches, fa.mma128_bwd_launches,
            fa.wgmma64_bwd_launches, fa.wgmma128_bwd_launches]


def pair_launch(grad, d, with_bias, what, dtype):
    """Run one backward (``grad()``) in ``dtype`` (a torch dtype) and check
    that it launched the route ``backward_route`` names, once, and no
    other. Each route's count rises in the branch of ``launch_backward``
    that calls its library, after the launch returned no error. Returns
    what ``grad()`` did."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    before = route_counts()
    got = grad()
    rose = [n - m for n, m in zip(route_counts(), before)]
    route = fa.backward_route(d, with_bias, dtype)
    want = [int(route == r) for r in BWD_ROUTES]
    if rose != want:
        raise AssertionError(f"{what}: backward launches {BWD_ROUTES} rose "
                             f"by {rose}, want {want}")
    return got


def device_ms_by_kernel(fn, reps: int = 3) -> dict:
    """Device ms a call of ``fn()`` spends in each kernel of ``csrc/``
    (torch.profiler over ``reps`` calls), by the kernel's short name: the
    mean of the kernel's recorded launches times its launches a call (the
    recorded events over ``reps``, rounded). A total over ``reps`` read
    some kernels well below their CUDA-event time (the fused f32 forward at
    [8, 4, 1500, 128] at 1.19 against 1.82 ms, about 2/3), as if the trace
    had lost a launch's event; a count that is no multiple of ``reps`` is
    logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.key.startswith(PORT_KERNELS) and evt.count:
            short = evt.key.split("::", 1)[1].split("(")[0]
            per_call = max(1, round(evt.count / reps))
            if evt.count % reps:
                log(f"[profile] {short}: {evt.count} events over {reps} "
                    f"calls")
            out[short] = (out.get(short, 0.0) + evt.device_time_total
                          / evt.count * per_call / 1e3)
    return out


def _attn_bwd_case(name, gen, h, d, dtype, with_bias, kv, iters, t=T):
    """One backward entry point (``flash_attention(...)`` or
    ``flash_attention_trainable(...)`` followed by ``.backward``) against
    ``attention_backward_plain`` on the same inputs, at the training
    shapes (or [B, h, t, d]): q, k, v (and bias f32, gate f32) need
    gradients, as in the model."""
    import torch
    import torch.nn.functional as F
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    dev = "cuda"
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, bias, gate = attn_inputs(gen, (B, h, t, d), tdt, with_bias)
    if with_bias:
        bias = bias.float()
    leaves = [x.requires_grad_() for x in (q, k, v, bias, gate)
              if x is not None]
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
    dout = (torch.rand((B, h, t, d), generator=gen, device=dev) * 2 - 1
            ).to(tdt)
    if with_bias:
        out = fa.flash_attention(q, k, v, bias, gate, kv_len)
    else:
        out = flash_attention_trainable(q, k, v, kv_len)

    def entry():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)
    got = pair_launch(entry, d, with_bias, f"{name} {dtype}", tdt)
    with torch.no_grad():
        ref_out, ref_lse = fa.attention_plain(q, k, v, bias, gate, kv_len,
                                              return_lse=True)
        qp, kp, vp, _, scale = fa.pad_head_dim(q, k, v)
        _, lse = fa.launch_kernel(qp, kp, vp, bias, gate, kv_len,
                                  return_lse=True, scale=scale)
        del qp, kp, vp
        want = [g for g in fa.attention_backward_plain(
            q, k, v, bias, gate, kv_len, ref_out, ref_lse, dout)
            if g is not None]
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse).abs().max().item()
    errs, ok = {}, math.isfinite(lse_err) and lse_err <= LSE_TOL
    for gname, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        errs[gname] = (err, scale)
        ok = ok and math.isfinite(err) and err <= GRAD_TOL[dtype] * scale
    del want, ref_out

    ms = time_ms(entry, iters)
    by_kernel = device_ms_by_kernel(entry)
    with torch.no_grad():
        plain_ms = time_ms(lambda: fa.attention_backward_plain(
            q, k, v, bias, gate, kv_len, out, lse, dout), max(iters // 2, 2))
    torch.cuda.empty_cache()
    # the one PyTorch call computing the same gradients (yardstick only):
    # autograd of SDPA with gate·bias materialized as an attn_mask that
    # needs a gradient
    mask = sdpa_mask(t, h, tdt, kv_len, bias, gate)
    sdpa_in = [q, k, v] + ([mask.requires_grad_()] if with_bias else [])
    sdpa_out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    library_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, sdpa_in, dout, retain_graph=True), iters)
    del sdpa_out, mask
    torch.cuda.empty_cache()

    es = 4 if dtype == "f32" else 2
    valid_keys = float(sum(kv))
    flops = 5 * 2.0 * h * t * valid_keys * d       # S, dP, dV, dK, dQ
    nbytes = 8.0 * B * h * t * d * es + 2 * B * h * t * 4 + B * 4
    if with_bias:    # bias read in q's dtype; dbias f32; gate, dgate
        nbytes += h * t * t * es + h * t * t * 4 + 2 * B * h * t * 4
    bms, by = bound_ms(flops, nbytes, bwd_rate(d, with_bias, dtype))
    log(f"[kernel] {name} {dtype} [{B},{h},{t},{d}] route "
        f"{fa.backward_route(d, with_bias, tdt)} kv_len "
        f"{'all ' + str(t) if min(kv) == t else f'{max(kv)}-{min(kv)}'} "
        f"lse_err={lse_err:.3e} "
        + " ".join(f"{n}={e:.3e}/{sc:.3g}" for n, (e, sc) in errs.items())
        + f" (tol {GRAD_TOL[dtype]:g}×max) ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} sdpa_bwd_ms={library_ms:.4f} bound_ms={bms:.4f} "
        f"({by}); device ms by kernel "
        + ", ".join(f"{n} {t:.4f}" for n, t in by_kernel.items()))
    if not ok:
        raise AssertionError(f"{name} {dtype}: gradients {errs} or lse "
                             f"{lse_err} exceed tolerance")
    worst = max(e / max(sc, 1e-30) for e, sc in errs.values())
    return dict(max_abs_err=max(e for e, _ in errs.values()),
                max_rel_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms,
                device_ms=sum(by_kernel.values()))


def conv_launch(run, n_layers, what):
    """Run one K5 entry point (``run()``) and check that it launched the
    layer kernel of ``conv_fused.cu`` once a layer (``layer_launches``,
    raised after each launch returned no error) and counted one chain.
    Returns what ``run()`` did."""
    from wfl_asr_tpu_torch.ops.kernels import conv_fused as cf
    layers, chains = cf.layer_launches, sum(cf.launches.values())
    got = run()
    rose = (cf.layer_launches - layers, sum(cf.launches.values()) - chains)
    if rose != (n_layers, 1):
        raise AssertionError(f"{what}: layer and chain launches rose by "
                             f"{rose}, want ({n_layers}, 1)")
    return got


def conv_inputs(gen, ks, t_in, c, with_norm, tdt):
    """x, the weights and the optional layer-0 norm on the card, of unit
    scale: He-scaled weights (std √(2/(C·k))) keep every layer's GELU input
    of order 1, where GELU is far from linear."""
    import torch
    dev = "cuda"
    x = torch.randn((B, t_in, c), generator=gen, device=dev).to(tdt)
    ws = [torch.randn((c, c, k), generator=gen, device=dev)
          * math.sqrt(2.0 / (c * k)) for k in ks]
    norm = None
    if with_norm:
        norm = (torch.randn((B, c), generator=gen, device=dev) * 0.1,
                0.5 + torch.rand((B, c), generator=gen, device=dev),
                1.0 + 0.2 * torch.randn((c,), generator=gen, device=dev),
                torch.randn((c,), generator=gen, device=dev) * 0.1)
    return x, ws, norm


def cudnn_chain(x, ws, norm):
    """The same function as one cuDNN convolution a layer in x's dtype
    (channels-first, ``F.conv1d(stride=2)`` + ``F.gelu``, the norm as
    elementwise ops in f32 before it; ``ws`` in x's dtype): K5's
    yardstick, which the port never calls."""
    import torch.nn.functional as F
    h = x
    if norm is not None:
        mean, inv, scale, bias = norm
        h = (h.float() - mean[:, None, :]) * inv[:, None, :]
        h = F.gelu(h * scale + bias).to(x.dtype)
    h = h.transpose(1, 2)
    for w in ws:
        h = F.gelu(F.conv1d(h, w, stride=2))
    return h.transpose(1, 2)


def _conv_case(name, gen, ks, t_in, with_norm, dtype, iters, c=512,
               timed=True):
    import torch
    from wfl_asr_tpu_torch.ops.kernels import conv_fused as cf
    dev = "cuda"
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, ws, norm = conv_inputs(gen, ks, t_in, c, with_norm, tdt)
    packed = cf.pack_weights(ws, tdt, dev)

    def entry():        # the entry point the WavLM feature encoder calls
        return cf.fused_conv_chain(x, ws, input_norm=norm, packed=packed)
    with torch.inference_mode():
        out = conv_launch(entry, len(ks), f"{name} {dtype}")
    ref = cf.conv_chain_plain(x, ws, norm)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    mean_abs = ref.float().abs().mean().item()
    err = (out.float() - ref.float()).abs().max().item()
    ok = (err <= CONV_TOL[dtype] * scale and math.isfinite(err)
          and out.shape == ref.shape)
    t = cf.chain_out_len(t_in, ks)
    shape = f"ks={ks} [{B},{t_in},{c}]->[{B},{t},{c}]"
    if not timed:
        log(f"[kernel] {name} {dtype} {shape} max_abs_err={err:.3e} (tol "
            f"{CONV_TOL[dtype]:g}×{scale:.3g})")
    if not ok:
        diff = (out.float() - ref.float()).abs()
        bad = diff > CONV_TOL[dtype] * scale
        where = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
        raise AssertionError(f"{name} {dtype} {shape}: max abs diff {err} "
                             f"exceeds {CONV_TOL[dtype]}×{scale} at (b, t, "
                             f"c) {where}; {int(bad.sum())} of "
                             f"{bad.numel()} elements over")
    if not timed:
        return dict(max_abs_err=err)
    lib_ws = [w.to(tdt) for w in ws]
    with torch.inference_mode():
        ms = time_ms(entry, iters)
        # each layer's launch alone, and layer 1 without the norm: what the
        # norm costs it (CUDA events: the profiler's kernel sums have come
        # out short here)
        layer_ms, h, nm = [], x, norm
        for w, p in zip(ws, packed):
            layer_ms.append(time_ms(lambda h=h, w=w, p=p, nm=nm:
                                    cf.launch_kernel(h, [w], nm, [p]), iters))
            h, nm = cf.launch_kernel(h, [w], nm, [p]), None
        bare_ms = time_ms(lambda: cf.launch_kernel(x, ws[:1], None,
                                                   packed[:1]), iters)
        del h
        lib_err = (cudnn_chain(x, lib_ws, norm).float() - ref.float()).abs() \
            .max().item()
        library_ms = time_ms(lambda: cudnn_chain(x, lib_ws, norm), iters)
    plain_ms = time_ms(lambda: cf.conv_chain_plain(x, ws, norm), iters)

    es = 4 if dtype == "f32" else 2
    tt, flops = t_in, 0.0
    for k in ks:
        tt = (tt - k) // 2 + 1
        flops += 2.0 * B * c * c * k * tt
    nbytes = (B * t_in * c + B * t * c + sum(ks) * c * c) * es
    if with_norm:
        nbytes += 2 * B * c * 4 + 2 * c * 4
    # f32 runs as three TF32 products on the tensor cores
    rate = "tf32x3" if dtype == "f32" else dtype
    bms, by = bound_ms(flops, nbytes, rate)
    log(f"[kernel] {name} {dtype} {shape} max_abs_err={err:.3e} (tol "
        f"{CONV_TOL[dtype]:g}×{scale:.3g}; mean|out| {mean_abs:.3g}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} cudnn_ms={library_ms:.4f} "
        f"(its max abs diff {lib_err:.3e}) "
        f"bound_ms={bms:.4f} ({by} at {rate}); ms a layer "
        + ", ".join(f"{v:.4f}" for v in layer_ms)
        + (f" (layer 1 without the norm {bare_ms:.4f})" if with_norm
           else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms, layer_ms=layer_ms,
                bare_ms=bare_ms)


def phase_conv(gen, iters: int) -> dict:
    """K5 in both dtypes: the two chains at the main shapes, then the small
    ragged widths."""
    import torch
    res = {}
    for dtype in ("f32", "bf16"):
        res[("K5a", dtype)] = _conv_case("fused_conv_chain[1-3]", gen,
                                         (3, 3, 3), 95999, True, dtype,
                                         iters)
        res[("K5b", dtype)] = _conv_case("fused_conv_chain[4-6]", gen,
                                         (3, 2, 2), 11999, False, dtype,
                                         iters)
        torch.cuda.empty_cache()
    conv_ragged(gen)
    return res


def conv_ragged(gen) -> None:
    """K5 at small widths against its plain twin: C = 80 in f32 (five K
    slices of 16 channels) and C = 48 in bf16 (one and a half of 32), both
    short of one 128-channel N tile, odd T, chains of 1 and 2 layers, with
    and without the layer-0 norm."""
    for dtype, c in (("f32", 80), ("bf16", 48)):
        for ks, t_in, with_norm in (((3,), 301, True), ((2,), 258, False),
                                    ((3, 2), 517, True)):
            _conv_case("fused_conv_chain (ragged)", gen, ks, t_in,
                       with_norm, dtype, 0, c=c, timed=False)


def phase_kernels(iters: int) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    kv = [T - 100 * i for i in range(B)]     # unequal key lengths
    res = {}
    for dtype in ("f32", "bf16"):
        with lap("3"):
            res[("K2", dtype)] = _attn_case("flash_attention", gen, 12, 64,
                                            dtype, True, kv, iters)
            res[("K1", dtype)] = _attn_case("flash_attention_trainable", gen,
                                            2, 384, dtype, False, kv, iters)
            torch.cuda.empty_cache()
        # phase 3b: the backward kernels at the training shapes
        with lap("3b"):
            res[("K2b", dtype)] = _attn_bwd_case("flash_attention_bwd", gen,
                                                 12, 64, dtype, True, kv,
                                                 iters)
            res[("K1b", dtype)] = _attn_bwd_case(
                "flash_attention_trainable_bwd", gen, 2, 384, dtype, False,
                kv, iters)
            torch.cuda.empty_cache()
        # phase 3c: strict attention dropout (K6) inside all four kernels
        with lap("3c"):
            for rate in DROP_RATES:
                res[("K2drop", dtype, rate)] = _attn_drop_case(
                    "flash_attention+dropout", gen, 12, 64, dtype, True, kv,
                    rate, iters)
                res[("K1drop", dtype, rate)] = _attn_drop_case(
                    "flash_attention_trainable+dropout", gen, 2, 384, dtype,
                    False, kv, rate, iters)
                torch.cuda.empty_cache()
    with lap("3"):
        res.update(phase_conv(gen, iters))
    with lap("head widths"):
        head_dims(gen)
    with lap("3d"):
        mask_bits()
    with lap("3e"):
        res.update(phase_whisper_kernels(gen, iters))
    return res


WHISPER_T = 1500        # the Whisper encoder's frames (30 s)


def phase_whisper_kernels(gen, iters: int) -> dict:
    """3e: K1 and K1b at the Whisper paths' shapes, bias-free and without a
    key mask, in f32 (TF32 off) and bf16, each against its plain twin,
    timed beside SDPA and the bound, with its device time by kernel, its
    route shown by the launch counts: [8, 8, 1500, 64], Whisper-base's
    layers, and [8, 2, 1500, 40], the ``none`` encoder's Conformer at
    hidden 80, through the public entry point (which pads D to 48, and the
    route to 64): both the bias-free instantiations of the D = 64 forward
    and passes ("mma64"); [8, 2, 1500, 640], large-v3's Conformer at its
    default 2 heads, on the wide route of ``attention_wide.cu``; [8, 4,
    1500, 128], Whisper-base's Conformer at the config schema's default of
    4 heads, and [8, 4, 1500, 96] (padded to 128 by the route), on the
    bias-free D = 128 instantiations ("mma128"). At [8, 4, 1500, 128] the
    same call also runs the fused forward and the FMA pair of
    ``flash_attention.cu`` (the route there before "mma128", which calls
    with a bias keep at other widths than 64) through its launchers on the
    same inputs, each held to the plain twin, with their device time by
    pass, and prints the D = 128 route's device time against theirs and its
    entry points against SDPA (``[mma128]`` lines in f32, ``[wgmma128]`` in
    bf16). In bf16 every bias-free shape but 640 takes the wgmma routes
    (wgmma64, wgmma128), and runs again with ragged key lengths (1500 −
    100·b), held to the same tolerances; a ``[gap]`` line gives each entry
    point's ms less its kernels' device ms."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kv = [WHISPER_T] * B
    ragged = [WHISPER_T - 100 * i for i in range(B)]
    res = {}
    for dtype in ("f32", "bf16"):
        for key, h, d in (("w", 8, 64), ("n", 2, 40), ("wide", 2, 640),
                          ("128", 4, 128), ("96", 4, 96)):
            what = {"w": "Whisper", "n": "none, D=40",
                    "wide": "large-v3 Conformer, D=640",
                    "128": "Whisper-base Conformer at 4 heads, D=128",
                    "96": "Conformer of hidden 384 at 4 heads, D=96"}[key]
            res[("K1" + key, dtype)] = _attn_case(
                f"flash_attention_trainable ({what})", gen, h, d, dtype,
                False, kv, iters, t=WHISPER_T)
            res[("K1b" + key, dtype)] = _attn_bwd_case(
                f"flash_attention_trainable_bwd ({what})", gen, h, d, dtype,
                False, kv, iters, t=WHISPER_T)
            torch.cuda.empty_cache()
            if dtype == "bf16" and key != "wide":
                res[("K1r" + key, dtype)] = _attn_case(
                    f"flash_attention_trainable ({what}, ragged)", gen, h,
                    d, dtype, False, ragged, iters, t=WHISPER_T)
                res[("K1br" + key, dtype)] = _attn_bwd_case(
                    f"flash_attention_trainable_bwd ({what}, ragged)", gen,
                    h, d, dtype, False, ragged, iters, t=WHISPER_T)
                torch.cuda.empty_cache()
                f, b_ = res[("K1" + key, dtype)], res[("K1b" + key, dtype)]
                log(f"[gap] bf16 [{B},{h},{WHISPER_T},{d}] entry ms less "
                    f"device ms: forward {f['ms']:.4f} − "
                    f"{f['device_ms']:.4f} = "
                    f"{f['ms'] - f['device_ms']:.4f}, backward "
                    f"{b_['ms']:.4f} − {b_['device_ms']:.4f} = "
                    f"{b_['ms'] - b_['device_ms']:.4f}")
            if key == "128":
                res[("fma128", dtype)] = fma_pair_at(gen, h, d, dtype, iters)
                mma128_against_fma(res, dtype)
                torch.cuda.empty_cache()
    return res


def fma_pair_at(gen, h: int, d: int, dtype: str, iters: int) -> dict:
    """The fused forward and the FMA pair of ``flash_attention.cu`` at
    [B, h, 1500, d], bias-free, every key valid, launched directly through
    their launchers (``_launch_fused_fwd``, ``_launch_fma``), each held to
    the plain twins (forward and LSE, dq, dk, dv), and the same call's
    launchers of the D = 128 route of the dtype (f32: mma128,
    ``_launch_mma128_fwd``, ``_launch_mma128``; bf16: wgmma128,
    ``_launch_wgmma_fwd``, ``_launch_wgmma``) on the same inputs: each
    launcher's ms (CUDA events, in turns: old, new, new, old) and device ms
    by kernel."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    t = WHISPER_T
    q, k, v, _, _ = attn_inputs(gen, (B, h, t, d), tdt, False)
    dout = (torch.rand((B, h, t, d), generator=gen, device="cuda") * 2 - 1
            ).to(tdt)
    kv = torch.full((B,), t, dtype=torch.int32, device="cuda")
    lse = torch.empty((B, h, t), device="cuda")

    def fwd():
        return fa._launch_fused_fwd(q, k, v, None, None, kv, lse, None, 0,
                                    1.0)
    out = fwd()
    delta = (dout.float() * out.float()).sum(-1).contiguous()

    def bwd():
        return fa._launch_fma(q, k, v, None, None, dout, lse, delta, kv,
                              None, 0, 1.0)[:3]

    def fwd128():
        if dtype == "bf16":
            return fa._launch_wgmma_fwd("wgmma128", q, k, v, kv, lse, None, 0,
                                        1.0)
        return fa._launch_mma128_fwd(q, k, v, kv, lse, None, 0, 1.0)

    def bwd128():
        if dtype == "bf16":
            return fa._launch_wgmma("wgmma128", q, k, v, out, dout, lse, kv,
                                    None, 0, 1.0)
        return fa._launch_mma128(q, k, v, dout, lse, delta, kv, None, 0, 1.0)
    got = bwd()
    ref, ref_lse = fa.attention_plain(q, k, v, None, None, kv,
                                      return_lse=True)
    want = fa.attention_backward_plain(q, k, v, None, None, kv, ref, ref_lse,
                                       dout)[:3]
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    rel = max((g.float() - w.float()).abs().max().item()
              / w.float().abs().max().item() for g, w in zip(got, want))
    del ref, ref_lse, want, got
    ok = (err <= ATTN_TOL[dtype] * scale and lse_err <= LSE_TOL
          and rel <= GRAD_TOL[dtype])
    turns = {n: [] for n in ("fwd", "fwd128", "bwd", "bwd128")}
    for names in (("fwd", "bwd"), ("fwd128", "bwd128"), ("fwd128", "bwd128"),
                  ("fwd", "bwd")):
        for n in names:
            turns[n].append(time_ms({"fwd": fwd, "bwd": bwd, "fwd128": fwd128,
                                     "bwd128": bwd128}[n], iters))
    ms = {n: float(np.mean(x)) for n, x in turns.items()}
    fwd_dev, bwd_dev = device_ms_by_kernel(fwd), device_ms_by_kernel(bwd)
    log(f"[kernel] fused forward and FMA pair of flash_attention.cu {dtype} "
        f"[{B},{h},{t},{d}] bias-free: max_abs_err={err:.3e} lse_err="
        f"{lse_err:.3e} grads {rel:.3e} × max; forward ms={ms['fwd']:.4f}, "
        f"device ms by kernel " + ", ".join(f"{n} {x:.4f}"
                                           for n, x in fwd_dev.items())
        + f"; backward ms={ms['bwd']:.4f}, device ms by kernel "
        + ", ".join(f"{n} {x:.4f}" for n, x in bwd_dev.items())
        + f"; the {'wgmma128' if dtype == 'bf16' else 'mma128'} launchers "
        f"on the same inputs, in turns: forward "
        f"ms={ms['fwd128']:.4f}, backward ms={ms['bwd128']:.4f}")
    if not ok:
        raise AssertionError(f"flash_attention.cu at D={d} {dtype}: forward "
                             f"{err}, lse {lse_err} or gradients {rel} out "
                             f"of tolerance")
    return dict(fwd_ms=ms["fwd"], bwd_ms=ms["bwd"], fwd128_ms=ms["fwd128"],
                bwd128_ms=ms["bwd128"], fwd_device_ms=sum(fwd_dev.values()),
                bwd_device_ms=sum(bwd_dev.values()))


def mma128_against_fma(res: dict, dtype: str) -> None:
    """One ``[mma128]`` (f32) or ``[wgmma128]`` (bf16) line at [8, 4, 1500,
    128]: that route's forward and backward device ms (torch.profiler) and
    launcher ms (CUDA events, in turns) against the fused forward's and the
    FMA pair's of the same call, and the entry points' ms against SDPA's
    (the forward without a mask, the backward by autograd)."""
    f, b, old = res[("K1128", dtype)], res[("K1b128", dtype)], \
        res[("fma128", dtype)]
    route = "wgmma128" if dtype == "bf16" else "mma128"
    log(f"[{route}] {dtype} [{B},4,{WHISPER_T},128]: backward device "
        f"{b['device_ms']:.4f} ms against the FMA pair's "
        f"{old['bwd_device_ms']:.4f} "
        f"({b['device_ms'] / old['bwd_device_ms']:.3f}×), launchers "
        f"{old['bwd128_ms']:.4f} against {old['bwd_ms']:.4f} ms "
        f"({old['bwd128_ms'] / old['bwd_ms']:.3f}×); forward device "
        f"{f['device_ms']:.4f} against the fused forward's "
        f"{old['fwd_device_ms']:.4f} "
        f"({f['device_ms'] / old['fwd_device_ms']:.3f}×), launchers "
        f"{old['fwd128_ms']:.4f} against {old['fwd_ms']:.4f} ms "
        f"({old['fwd128_ms'] / old['fwd_ms']:.3f}×); entry points "
        f"forward {f['ms']:.4f} / SDPA {f['library_ms']:.4f} "
        f"({f['ms'] / f['library_ms']:.3f}×), backward {b['ms']:.4f} / "
        f"SDPA {b['library_ms']:.4f} ({b['ms'] / b['library_ms']:.3f}×)")


SWEEP_WIDE = (528, 640, 1024, 1280, 2048)
# query lengths with an odd count of 64-key tiles: the last dK/dV CTA of the
# wgmma routes (128 keys) then reaches past the dS workspace's ⌈T/64⌉·64
# columns, which its second consumer group must leave alone
ODD_TILE_T = (50, 150)


def head_dims(gen) -> None:
    """Every kernel variant of the attention, forward and backward, at a
    small shape, against the plain twins, each forward's and backward's
    route shown by its launch count: bf16 and f32 with bias, gate and a
    ragged key length at head widths 16-512 (at 64 the mma.sync forward and
    passes with a bias, the others on the forwards and the FMA pair of
    flash_attention.cu) and at 528, 640, 1024, 1280 and 2048 (the wide
    route), at 64 with a bias and no gate, at 64 with a bias in q's dtype
    whose base is not 16-byte aligned; bias-free (``flash_attention_trainable``) at 16,
    32, 40, 48 and 64 (routes mma64 in f32 and wgmma64 in bf16; 40 first
    to 48 by the entry point), 80, 96, 112 and 128 (mma128 and wgmma128),
    144, 256, 384 and 512 (the mma.sync forward and pair) and 528-2048 (the
    wide route); bias-free at 48, 64, 96 and 128 at T = 50 and 150 (an odd
    count of 64-key tiles, ``ODD_TILE_T``); strict dropout (rate 0.1)
    bias-free at 64, 128 and 640, against the plain twins with the same
    mask."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    cases = ([(d, True, "", 203) for d in (16, 48, 64, 128, 144, 512)
              + SWEEP_WIDE]
             + [(64, True, " no gate", 203),
                (64, True, " unaligned bias", 203)]
             + [(d, False, " bias-free", 203)
                for d in (16, 32, 40, 48, 64, 80, 96, 112, 128, 144, 256,
                          384, 512) + SWEEP_WIDE]
             + [(d, False, f" bias-free T={t}", t)
                for d in (48, 64, 96, 128) for t in ODD_TILE_T]
             + [(d, False, " dropout", 203) for d in (64, 128, 640)])
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device="cuda")
    errs = {}
    for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for d, with_bias, kind, t_len in cases:
            what = f"{dtype} head_dim {d}{kind}"
            q, k, v, bias, gate = attn_inputs(gen, (2, 2, t_len, d), tdt,
                                              with_bias)
            if kind == " unaligned bias":
                # in q's dtype, so that the kernel reads it where it lies:
                # one element past a 16-byte boundary
                held = torch.empty(bias.numel() + 1, dtype=tdt, device="cuda")
                bias = held[1:].view(bias.shape).copy_(bias)
                assert bias.data_ptr() % 16
            elif with_bias:
                bias = bias.float()
            if kind == " no gate":
                gate = None
            kv = torch.tensor([t_len, min(77, t_len - 21)],
                              dtype=torch.int32, device="cuda")
            drop = (dict(dropout_rate=DROP_RATES[0], dropout_seed=seed)
                    if kind == " dropout" else {})

            def entry():
                if with_bias:
                    return fa.flash_attention(q, k, v, bias, gate, kv, **drop)
                return flash_attention_trainable(q, k, v, kv, **drop)
            with torch.inference_mode():
                out = fwd_launch(entry, d, with_bias, f"attention {what}",
                                 tdt)
            ref, lse = fa.attention_plain(q, k, v, bias, gate, kv,
                                          return_lse=True, **drop)
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= ATTN_TOL[dtype] * scale:
                raise AssertionError(f"attention {what}: max abs diff {err} "
                                     f"exceeds {ATTN_TOL[dtype]}×{scale}")
            leaves = [x.requires_grad_() for x in (q, k, v, bias, gate)
                      if x is not None]
            dout = torch.rand_like(q) * 2 - 1
            got = pair_launch(lambda: torch.autograd.grad(entry(), leaves,
                                                          dout),
                              d, with_bias, f"attention backward {what}", tdt)
            want = fa.attention_backward_plain(q, k, v, bias, gate, kv, ref,
                                               lse, dout, **drop)
            rel = max((g.float() - w.float()).abs().max().item()
                      / w.float().abs().max().item()
                      for g, w in zip(got, want))
            errs[what] = (err, rel)
            if not rel <= GRAD_TOL[dtype]:
                raise AssertionError(f"attention backward {what}: max diff "
                                     f"{rel} × max|grad|")
    log("[kernel] attention head widths, with bias 16/48/64/128/144/512 (64 "
        "on the mma.sync forward with a bias) and 528/640/1024/1280/2048 "
        "(wide), with bias and no gate 64, with an unaligned bias 64, "
        "bias-free 16/32/40/48/64 (mma64 f32, wgmma64 bf16), 80/96/112/128 "
        "(mma128 f32, wgmma128 bf16), 144/256/384/512 (mma) and "
        "528/640/1024/1280/2048 (wide), bias-free 48/64/96/128 at T = 50 "
        "and 150, dropout "
        "0.1 bias-free 64/128/640, f32 and bf16: "
        "forward max_abs_err, backward max diff / max|grad| " + ", ".join(
            f"{k}={e:.2e},{r:.2e}" for k, (e, r) in errs.items()))


# ---------------------------------------------------------------------------
# Phase 3c-3d: strict attention dropout (K6)
# ---------------------------------------------------------------------------

def _sdpa_ms(q, k, v, mask, dout, rate, iters, mask_grad):
    """SDPA with ``dropout_p`` (its own mask: a yardstick only), forward
    and autograd backward (the mask needs a gradient where it carries the
    bias); None where PyTorch refuses the call."""
    import torch
    import torch.nn.functional as F
    try:
        fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q.detach(), k.detach(), v.detach(), attn_mask=mask.detach(),
            dropout_p=rate), iters)
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        m = mask.detach()
        if mask_grad:
            ins.append(m.requires_grad_())
        out = F.scaled_dot_product_attention(*ins[:3], attn_mask=m,
                                             dropout_p=rate)
        bwd = time_ms(lambda: torch.autograd.grad(out, ins, dout,
                                                  retain_graph=True), iters)
        del out, ins, m
        return fwd, bwd
    except RuntimeError as e:
        log(f"[kernel] sdpa dropout_p={rate}: refused "
            f"({str(e).splitlines()[0][:100]})")
        return None, None


def _limit_text(dtype: str) -> str:
    if dtype == "f32":
        return f"{ATTN_TOL['f32']:g}×max|ref|"
    return f"{BF16_SLACK:g}·2^-8·(|ref|+A)+{BF16_FLOOR:g} per element"


def _drop_fwd_limit(q, k, v, bias, gate, kv_len, rate, seed, dtype):
    """3c's forward check: (the per-element limit, the f32 plain twin with
    the kernel's mask, the f32 plain twin with the mask of seed + 1). f32:
    ATTN_TOL × max|ref|. bf16: u·(|ref| + A)·BF16_SLACK + BF16_FLOOR, A the
    attention of |v| (see BF16_U)."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    up = [None if x is None else x.detach().float()
          for x in (q, k, v, bias, gate)]

    def plain(vv, s):
        return fa.attention_plain(up[0], up[1], vv, up[3], up[4], kv_len,
                                  dropout_rate=rate, dropout_seed=s)
    ref32, wrong = plain(up[2], seed), plain(up[2], seed + 1)
    if dtype == "f32":
        lim = torch.full_like(ref32, ATTN_TOL["f32"]
                              * ref32.abs().max().item())
    else:
        lim = (BF16_U * BF16_SLACK * (ref32.abs() + plain(up[2].abs(), seed))
               + BF16_FLOOR)
    return lim, ref32, wrong


def _attn_drop_case(name, gen, h, d, dtype, with_bias, kv, rate, iters):
    """3c: one entry point with dropout at ``rate`` (fixed seed) at the
    main shape: the forward against ``attention_plain`` and ``.backward``
    against ``attention_backward_plain`` with the same mask; each timed
    with and without dropout, in turns."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    dev = "cuda"
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, bias, gate = attn_inputs(gen, (B, h, T, d), tdt, with_bias)
    if with_bias:
        bias = bias.float()
    leaves = [x.requires_grad_() for x in (q, k, v, bias, gate)
              if x is not None]
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    dout = (torch.rand((B, h, T, d), generator=gen, device=dev) * 2 - 1
            ).to(tdt)

    def entry(r):
        drop = dict(dropout_rate=r, dropout_seed=seed if r else None)
        if with_bias:
            return fa.flash_attention(q, k, v, bias, gate, kv_len, **drop)
        return flash_attention_trainable(q, k, v, kv_len, **drop)

    with torch.inference_mode():
        out = fwd_launch(lambda: entry(rate), d, with_bias,
                         f"{name} {dtype} rate {rate}", tdt)
    outs = {r: entry(r) for r in (0.0, rate)}       # with autograd
    got = pair_launch(lambda: torch.autograd.grad(
        outs[rate], leaves, dout, retain_graph=True), d, with_bias,
        f"{name} {dtype} rate {rate}", tdt)
    with torch.no_grad():
        ref, ref_lse = fa.attention_plain(q, k, v, bias, gate, kv_len,
                                          return_lse=True, dropout_rate=rate,
                                          dropout_seed=seed)
        want = [g for g in fa.attention_backward_plain(
            q, k, v, bias, gate, kv_len, ref, ref_lse, dout,
            dropout_rate=rate, dropout_seed=seed) if g is not None]
        # the mma.sync backwards' mask map: the plain twin with the mask of
        # seed + 1 must be outside the tolerance of some gradient
        wrong_bwd = None
        if fa.backward_route(d, with_bias, tdt) in ("mma", "mma_bias"):
            wrong_bwd = max(
                ((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
                for g, w in zip(got, [w for w in fa.attention_backward_plain(
                    q, k, v, bias, gate, kv_len, ref, ref_lse, dout,
                    dropout_rate=rate, dropout_seed=seed + 1)
                    if w is not None]))
            if not wrong_bwd > GRAD_TOL[dtype]:
                raise AssertionError(
                    f"{name} {dtype} rate {rate}: the backward passes the "
                    f"plain twin of seed + 1 ({wrong_bwd} × max|grad|)")
        lim, ref32, wrong = _drop_fwd_limit(q, k, v, bias, gate, kv_len,
                                            rate, seed, dtype)
    torch.cuda.synchronize()
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    ratio = (diff / lim).max().item()
    ok = math.isfinite(ratio) and ratio <= 1.0
    # the same limit must catch a mask of another seed
    over = (out.float() - wrong).abs() > lim
    wrong_over, wrong_share = int(over.sum().item()), over.float().mean().item()
    del diff, lim, ref32, wrong, over
    if not wrong_over:
        raise AssertionError(f"{name} {dtype} rate {rate}: the forward limit "
                             f"passes the mask of another seed")
    errs = {}
    for gname, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        gs = w.float().abs().max().item()
        e = (g.float() - w.float()).abs().max().item()
        errs[gname] = (e, gs)
        ok = ok and math.isfinite(e) and e <= GRAD_TOL[dtype] * gs
    del want, got

    def bwd(r):
        return torch.autograd.grad(outs[r], leaves, dout, retain_graph=True)
    with torch.inference_mode():
        fwd_ms = [time_ms(lambda: entry(r), iters)
                  for r in (0.0, rate, rate, 0.0)]
    bwd_ms = [time_ms(lambda: bwd(r), iters) for r in (0.0, rate, rate, 0.0)]
    with torch.no_grad():
        plain_ms = time_ms(lambda: fa.attention_plain(
            q, k, v, bias, gate, kv_len, dropout_rate=rate,
            dropout_seed=seed), max(iters // 2, 2))
        plain_bwd_ms = time_ms(lambda: fa.attention_backward_plain(
            q, k, v, bias, gate, kv_len, ref, ref_lse, dout,
            dropout_rate=rate, dropout_seed=seed), max(iters // 2, 2))
    del ref, ref_lse, outs
    torch.cuda.empty_cache()
    keep = torch.arange(T, device=dev)[None, :] < kv_len[:, None]
    mask = torch.zeros((B, h, T, T), dtype=tdt, device=dev)
    if with_bias:
        mask += (gate.detach()[..., None] * bias.detach()[None]).to(tdt)
    mask.masked_fill_(~keep[:, None, None, :], -1e30)
    sdpa_fwd, sdpa_bwd = _sdpa_ms(q, k, v, mask, dout, rate, iters,
                                  with_bias)
    del mask
    torch.cuda.empty_cache()

    es = 4 if dtype == "f32" else 2
    valid = float(h * T * sum(kv))                  # valid score elements
    f_bytes = 4.0 * B * h * T * d * es + B * 4 + 4
    b_bytes = 8.0 * B * h * T * d * es + 2 * B * h * T * 4 + B * 4 + 4
    if with_bias:
        f_bytes += h * T * T * es + B * h * T * 4
        b_bytes += h * T * T * es + h * T * T * 4 + 2 * B * h * T * 4
    f_bound, f_by = bound_ms(4.0 * valid * d, f_bytes,
                             fwd_rate(d, with_bias, dtype), HASH_OPS * valid)
    b_bound, b_by = bound_ms(10.0 * valid * d, b_bytes,
                             bwd_rate(d, with_bias, dtype),
                             HASH_OPS * valid)
    f_ms = float(np.mean(fwd_ms[1:3]))
    f0_ms = float(np.mean(fwd_ms[::3]))
    b_ms = float(np.mean(bwd_ms[1:3]))
    b0_ms = float(np.mean(bwd_ms[::3]))

    def fmt(x):
        return "refused" if x is None else f"{x:.4f}"
    log(f"[kernel] {name} {dtype} rate={rate} [{B},{h},{T},{d}] forward "
        f"max_abs_err={err:.3e} max err/limit={ratio:.3f} (limit "
        f"{_limit_text(dtype)}; seed+1's mask: {wrong_over} elements "
        f"over, {wrong_share:.4f} of all) backward " + " ".join(f"{n}={e:.3e}/{s:.3g}"
                                for n, (e, s) in errs.items())
        + f" (tol {GRAD_TOL[dtype]:g}×max"
        + ("" if wrong_bwd is None else
           f"; seed+1's plain twin {wrong_bwd:.3e}×max")
        + f"); forward ms={f_ms:.4f} "
        f"(no dropout {f0_ms:.4f}; turns {', '.join(f'{x:.4f}' for x in fwd_ms)}) "
        f"plain_ms={plain_ms:.4f} sdpa_dropout_ms={fmt(sdpa_fwd)} "
        f"bound_ms={f_bound:.4f} ({f_by}); backward ms={b_ms:.4f} "
        f"(no dropout {b0_ms:.4f}; turns {', '.join(f'{x:.4f}' for x in bwd_ms)}) "
        f"plain_ms={plain_bwd_ms:.4f} sdpa_dropout_bwd_ms={fmt(sdpa_bwd)} "
        f"bound_ms={b_bound:.4f} ({b_by})")
    if not ok:
        raise AssertionError(f"{name} {dtype} rate {rate}: forward {err} "
                             f"or gradients {errs} exceed tolerance")
    return dict(fwd=dict(max_abs_err=err, ms=f_ms, ms_nodrop=f0_ms,
                         plain_ms=plain_ms, bound_ms=f_bound, bound_by=f_by,
                         library_ms=sdpa_fwd),
                bwd=dict(max_abs_err=max(e for e, _ in errs.values()),
                         ms=b_ms, ms_nodrop=b0_ms, plain_ms=plain_bwd_ms,
                         bound_ms=b_bound, bound_by=b_by,
                         library_ms=sdpa_bwd))


def mask_bits() -> None:
    """3d: each forward variant's dropout mask read off bit for bit at the
    main length T=1499, over every query and key tile and the ragged tail:
    at D = 64 the mma.sync forward of ``attention_fwd_bias_mma.cu`` with a
    bias (a zero bias and a unit gate) and its bias-free f32 instantiation,
    and at D = 128 its bias-free f32 instantiation there (route mma128);
    the bf16 wgmma forward of ``attention_wgmma.cu`` at D = 64 and 128
    (routes wgmma64, wgmma128); at D = 48 with a zero bias the forwards of
    ``flash_attention.cu``; at D = 384 the mma.sync forward of
    ``attention_fwd_mma.cu``; at D = 640 the wide forward of
    ``attention_wide.cu`` bias-free (f32) and with a zero bias (bf16); each
    shown by the launch counts to take that route. With q = k = 0 and a
    zero bias every row is uniform over its kv_len keys; v holds the
    identity on keys j0..j0+D−1 (one call for each block of D keys), so
    out[b,h,q,j−j0] > 0 exactly when key j is kept. The pattern must equal
    the plain mask's (zero mismatches). Then the wgmma dK/dV pass's mask
    (``mask_bits_dkdv``), and the kept share of the mask at the main
    shape."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import dropout_mask as dm
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    dev, b, h = "cuda", 2, 3
    kv = torch.tensor([T, 1001], dtype=torch.int32, device=dev)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    valid = (torch.arange(T, device=dev)[None, :] < kv[:, None])[
        :, None, None, :]
    found = []
    for variant, dtype, d, with_bias in (
            ("f32 mma.sync bias fwd", torch.float32, 64, True),
            ("bf16 mma.sync bias fwd", torch.bfloat16, 64, True),
            ("f32 mma.sync bias-free D=64 fwd", torch.float32, 64, False),
            ("bf16 wgmma D=64 fwd", torch.bfloat16, 64, False),
            ("f32 mma.sync bias-free D=128 fwd", torch.float32, 128, False),
            ("bf16 wgmma D=128 fwd", torch.bfloat16, 128, False),
            ("f32 FMA", torch.float32, 48, True),
            ("bf16 mma.sync", torch.bfloat16, 48, True),
            ("f32 mma.sync fwd", torch.float32, 384, False),
            ("bf16 mma.sync fwd", torch.bfloat16, 384, False),
            ("f32 wide fwd", torch.float32, 640, False),
            ("bf16 wide fwd", torch.bfloat16, 640, True)):
        q = torch.zeros((b, h, T, d), dtype=dtype, device=dev)
        bias = gate = None
        if with_bias:
            bias = torch.zeros((h, T, T), dtype=dtype, device=dev)
            gate = torch.ones((b, h, T), device=dev)
        for rate in DROP_RATES:
            kept = torch.zeros((b, h, T, T), dtype=torch.bool, device=dev)
            for j0 in range(0, T, d):
                w = min(d, T - j0)
                v = torch.zeros_like(q)
                v[..., j0:j0 + w, :w] = torch.eye(w, dtype=dtype, device=dev)
                with torch.inference_mode():
                    out = fwd_launch(lambda: fa.flash_attention(
                        q, q, v, bias, gate, kv_len=kv, dropout_rate=rate,
                        dropout_seed=seed), d, with_bias,
                        f"dropout mask {variant} D={d}", dtype)
                kept[..., j0:j0 + w] = out[..., :w].float() > 0
            want = (dm.mask_grid(seed, b, h, T, T, rate, dev) > 0) & valid
            bad = int((kept != want).sum().item())
            found.append(f"{variant} D={d} rate={rate}: {bad} of "
                         f"{want.numel()} differ, {int(want.sum())} kept")
            if bad:
                raise AssertionError(f"dropout mask of the {variant} kernel "
                                     f"(D={d}, rate {rate}): {bad} elements "
                                     f"differ from the plain mask")
            del kept, want
    found += mask_bits_dkdv(kv, seed, valid)
    shares = []
    for rate in DROP_RATES:
        share = (dm.mask_grid(seed, B, 12, T, T, rate, dev) > 0).float() \
            .mean().item()
        shares.append(f"rate {rate}: {share:.5f}")
        if abs(share - (1 - rate)) > 0.005:
            raise AssertionError(f"kept share {share} at rate {rate}")
    torch.cuda.empty_cache()
    log(f"[kernel] dropout mask bit for bit, [2,3,{T},D], kv_len ({T}, "
        f"1001), keys read D at a time: "
        + "; ".join(found))
    log(f"[kernel] dropout kept share at [{B},12,{T},{T}] (must be 1 − rate "
        f"± 0.005): " + ", ".join(shares))


def mask_bits_dkdv(kv, seed, valid) -> list:
    """3d for the wgmma dK/dV pass (bf16, D = 64 and 128, rates 0.1 and
    0.15): with q = k = 0 every row's P is 1/kv_len on its valid keys, so
    dV[key, c] = Σ_q P·M[q, key]·dO[q, c]; dO holds the identity on queries
    q0..q0+D−1 (one backward for each block of D queries), so dV[b, h,
    key, q − q0] > 0 exactly when key is kept for query q. The pattern must
    equal the plain mask's; each backward shown by the launch counts to run
    the wgmma route. Returns the lines for the log."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import dropout_mask as dm
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    dev, b, h, tdt = "cuda", 2, 3, torch.bfloat16
    found = []
    for d in (64, 128):
        q = torch.zeros((b, h, T, d), dtype=tdt, device=dev)
        for rate in DROP_RATES:
            drop = dict(dropout_rate=rate, dropout_seed=seed)
            with torch.inference_mode():
                out, lse = fa.launch_kernel(q, q, q, kv_len=kv,
                                            return_lse=True, **drop)
            kept = torch.zeros((b, h, T, T), dtype=torch.bool, device=dev)
            for q0 in range(0, T, d):
                w = min(d, T - q0)
                dout = torch.zeros_like(q)
                dout[..., q0:q0 + w, :w] = torch.eye(w, dtype=tdt,
                                                     device=dev)
                with torch.inference_mode():
                    _, _, dv, _, _ = pair_launch(
                        lambda: fa.launch_backward(q, q, q, None, None, kv,
                                                   out, lse, dout, **drop),
                        d, False, f"dropout mask bf16 wgmma dK/dV D={d}",
                        tdt)
                kept[..., q0:q0 + w, :] = \
                    dv[..., :w].transpose(-1, -2).float() > 0
            want = (dm.mask_grid(seed, b, h, T, T, rate, dev) > 0) & valid
            bad = int((kept != want).sum().item())
            found.append(f"bf16 wgmma dK/dV D={d} rate={rate}: {bad} of "
                         f"{want.numel()} differ, {int(want.sum())} kept")
            if bad:
                raise AssertionError(f"dropout mask of the wgmma dK/dV pass "
                                     f"(D={d}, rate {rate}): {bad} elements "
                                     f"differ from the plain mask")
            del kept, want
    return found


# ---------------------------------------------------------------------------
# Phase 4: the main path through the entry points a user calls
# ---------------------------------------------------------------------------

DURATIONS = (30.0, 27.3, 24.1, 19.8, 15.2, 11.7, 6.4, 2.9)


ENCODER_NAMES = {"wavlm": "WavLM-base-plus", "whisper": "Whisper-base",
                 "none": "the mel front end (80 mels)"}


def make_run(root: str, encoder: str = "wavlm", default_heads=False):
    """A save_dir (73 labels, 2 languages), a Config built from a dict, a
    random-init tagger (``encoder``: WavLM-base-plus, Whisper-base or the
    mel front end, with the flagship heads; ``default_heads``: without the
    ``conformer_heads`` key, so the schema's default of 4) saved as .pt,
    and 8 wavs of ≤ 30 s, the same for every model, in a folder of the
    model's own (a folder's ``.wfl_cache`` is keyed by file name alone, the
    reference's layout, so another model's cached logits would be
    served)."""
    import torch
    from wfl_asr_tpu_torch.checkpoint import save_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.data.audio import write_wav
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger

    name = encoder + ("_4heads" if default_heads else "")
    save_dir = os.path.join(root, f"save_{name}")
    os.makedirs(save_dir)
    phonemes = [f"p{i}" for i in range(35)] + ["SP"]
    labels = ["O"] + [f"{t}-{p}" for p in phonemes for t in ("B", "I")]
    assert len(labels) == 73
    with open(os.path.join(save_dir, "phonemes.txt"), "w") as f:
        f.write("\n".join(labels) + "\n")
    with open(os.path.join(save_dir, "langs.txt"), "w") as f:
        f.write("en,0\nja,1\n")
    model_cfg = {
        "encoder_type": encoder, "wavlm_model": "microsoft/wavlm-base-plus",
        "whisper_model": "openai/whisper-base",
        "num_languages": 2, "lang_emb_dim": 64, "enable_bilstm": True,
        "bilstm_num_layer": 2, "num_conformer_layers": 2,
        "conformer_heads": 2, "conformer_ff_expansion": 2,
        "conformer_kernel_size": 31, "conformer_dropout": 0.15,
        "enable_dilated_conv": True, "dilated_conv_depth": 2,
        "dilated_conv_kernel": 3}
    if default_heads:
        del model_cfg["conformer_heads"]
    cfg = Config({"data": {"sample_rate": 16000, "frame_duration": 0.02},
                  "model": model_cfg, "output": {"save_dir": save_dir},
                  "postprocess": {"median_filter": 3,
                                  "merge_segments": "right",
                                  "device_decode": True}})
    arch = TaggerArch.from_config(cfg, len(labels))
    model = init_tagger(arch, torch.Generator().manual_seed(0))
    ckpt = os.path.join(save_dir, "best_model.pt")
    save_model_checkpoint(ckpt, model)
    n_params = sum(p.numel() for p in model.parameters())
    del model

    wav_dir = os.path.join(root, f"wavs_{name}")
    os.makedirs(wav_dir)
    rng = np.random.RandomState(0)
    for i, dur in enumerate(DURATIONS):
        n = int(dur * 16000)
        t = np.arange(n) / 16000.0
        tone = sum(np.sin(2 * np.pi * f * t) * a
                   for f, a in ((180.0 + 40 * i, 0.3), (620.0, 0.1)))
        write_wav(os.path.join(wav_dir, f"utt{i}.wav"),
                  tone * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
                  + rng.randn(n) * 0.02, 16000)
    log(f"[main] tagger {ENCODER_NAMES[encoder]}: {n_params} parameters, "
        f"{len(labels)} labels, 2 languages, Conformer "
        f"{arch.conformer_heads} heads of "
        f"{arch.hidden_size // arch.conformer_heads}; {len(DURATIONS)} wavs "
        f"of {min(DURATIONS)}-{max(DURATIONS)} s")
    return cfg, ckpt, wav_dir


def serving_perf(cfg, ckpt: str, iters: int, what: str):
    """The batched forward with gate and median at B=8×30 s, as bench.py
    defines it (unmasked rows, WavLM's position bias precomputed, ids to
    the host), in bf16 and f32: audio-seconds per second, pipelined and
    synchronous step times, the peak memory of a step. Returns the numbers
    by dtype and the bf16 step."""
    import torch
    from wfl_asr_tpu_torch.infer.pipeline import _get_session
    from wfl_asr_tpu_torch.ops.postprocess import confidence_gate_ids, \
        median_filter_ids
    perf, steps = {}, {}
    samples = 30 * 16000
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(B, samples) * 0.1).astype(np.float32)
                             ).to("cuda")
    lang = torch.zeros(B, dtype=torch.int64, device="cuda")
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        session = _get_session(cfg, ckpt, "cuda", dtype)
        t_frames = session.num_frames_for(samples)
        pos_bias = session._pos_bias_for(t_frames)

        def step(session=session, dtype=dtype, pos_bias=pos_bias):
            with torch.inference_mode():
                logits, offsets = session.model(audio, lang,
                                                compute_dtype=dtype,
                                                pos_bias=pos_bias)
                ids = median_filter_ids(confidence_gate_ids(logits, 0.5, 0), 3)
            return ids, offsets

        resident_gb = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        step()[0].cpu()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        sync = []
        for _ in range(iters):
            t0 = time.perf_counter()
            step()[0].cpu()
            sync.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        outs = [step() for _ in range(iters)]
        for o in outs:
            o[0].cpu()
        del outs
        pipelined = (time.perf_counter() - t0) / iters
        rate = B * samples / 16000.0 / pipelined
        perf[name] = dict(audio_s_per_s=rate, pipelined_ms=pipelined * 1e3,
                          sync_ms_median=float(np.median(sync)) * 1e3,
                          sync_ms_min=float(np.min(sync)) * 1e3,
                          frames=t_frames, peak_gb=peak_gb,
                          resident_gb=resident_gb)
        steps[name] = step
        log(f"[perf] {what}: batched forward + gate + median, B={B}×"
            f"{samples / 16000:g} s {name}: {rate:.2f} audio-s/s "
            f"(pipelined step {pipelined * 1e3:.2f} ms; sync step median "
            f"{np.median(sync) * 1e3:.2f} ms, min {np.min(sync) * 1e3:.2f} "
            f"ms; {iters} steps each; peak memory of a step {peak_gb:.3f} "
            f"GiB, {resident_gb:.3f} of it resident before the step)")
    return perf, steps["bf16"]


def phase_main(root: str, iters: int) -> dict:
    import torch
    from wfl_asr_tpu_torch.infer.pipeline import _get_session, \
        infer_folder_batched
    from wfl_asr_tpu_torch.labels import parse_lab
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import conv_fused, flash_attention, \
        flash_attention_bwd

    cfg, ckpt, wav_dir = make_run(root)
    out_dir = os.path.join(root, "labs")
    bf16 = torch.bfloat16

    # launch counts: 0 just before the main path, read just after
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    infer_folder_batched(wav_dir, cfg, ckpt, out_dir, lang_id=0,
                         confidence_threshold=0.0, batch_files=8,
                         device="cuda", compute_dtype=bf16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # K5: the layer kernel's launches of each chain (3 layers each)
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_trainable": flash_attention_bwd.launches,
              "fused_conv_chain[1-3]": 3 * conv_fused.launches[(3, 3, 3)],
              "fused_conv_chain[4-6]": 3 * conv_fused.launches[(3, 2, 2)]}
    n_segs = []
    for i, dur in enumerate(DURATIONS):
        lab = os.path.join(out_dir, f"utt{i}.lab")
        if not os.path.exists(lab):
            raise AssertionError(f"missing {lab}")
        segs = parse_lab(lab)
        if not segs or segs[-1][1] > dur + 0.05:
            raise AssertionError(f"{lab}: {len(segs)} segments, bad span")
        n_segs.append(len(segs))
    log(f"[main] infer_folder_batched on cuda, bf16, device_decode, "
        f"batch_files=8: {len(DURATIONS)} .lab files with {n_segs} segments "
        f"in {wall:.2f} s (first call: position bias + warm-up)")
    log(f"[main] kernel launches on the main path: {json.dumps(counts)}; "
        f"forwards {dict(zip(FWD_ROUTES, fwd_counts()))}")
    missing = [k for k, n in counts.items() if n < 1]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    chains = dict(conv_fused.launches)
    if (conv_fused.layer_launches != counts["fused_conv_chain[1-3]"]
            + counts["fused_conv_chain[4-6]"]
            or set(chains) != {(3, 3, 3), (3, 2, 2)}
            or chains[(3, 3, 3)] != chains[(3, 2, 2)]):
        raise AssertionError(f"K5: {conv_fused.layer_launches} layer "
                             f"launches for the chains {chains}; want 3 a "
                             f"chain, chains 1-3 and 4-6 alike")
    per_forward(fwd_counts(), counts["flash_attention"],
                counts["flash_attention_trainable"], "phase 4")

    # batched forward with gate and median at B=8×30 s, as bench.py
    # defines it
    perf, step = serving_perf(cfg, ckpt, iters, "WavLM-base-plus")
    profiled_forwards(profile_step(step), "phase 4, bf16 serving")
    lstm_dtypes(_get_session(cfg, ckpt, "cuda", bf16).model)
    return dict(perf=perf, counts=counts, cfg=cfg, ckpt=ckpt, wav_dir=wav_dir)


def per_forward(fwd: list, k2: int, k1: int, what: str) -> None:
    """Each forward of the WavLM tagger runs 12 K2 and 2 K1: K1's launches
    are a sixth of K2's, every K2 ran the mma.sync forward with a bias and
    every K1 the bias-free one of ``attention_fwd_mma.cu``, none another
    route (``fwd``: the counts of the eight routes, as ``fwd_counts``)."""
    if not (k1 >= 2 and fwd == [k2, k1, 0, 0, 0, 0, 0, 0]
            and 6 * k1 == k2):
        raise AssertionError(f"{what}: forwards {FWD_ROUTES} {fwd}, {k2} K2 "
                             f"and {k1} K1 launches; want 12 K2 and 2 K1 a "
                             f"forward, each on its mma.sync forward")


def profiled_forwards(prof: dict, what: str) -> None:
    """The profiler's kernel names as a second witness of the launch counts
    of one bf16 serving step: 12 launches of the mma.sync forward with a
    bias, none of ``flash_attention.cu``'s bf16 forward at D = 64, and 6 of
    the conv layer kernel (K5: feature-encoder layers 1-6, the first with
    the layer-0 norm)."""
    want = {"attn_bias_fwd_mma<": 12, "flash_fwd_mma<64": 0,
            "conv_layer_mma<": 6, "conv_layer_mma<OpBF16, 3, true>": 1}
    names = [(name.replace("<(anonymous namespace)::", "<"), n)
             for name, (_, n) in prof["kernels"].items()]
    got = {part: sum(n for name, n in names if f"::{part}" in name)
           for part in want}
    if got != want:
        raise AssertionError(f"{what}: profiled forward kernels {got}, want "
                             f"{want}")


def profile_step(step, what: str = "one bf16 step", top: int = 12) -> None:
    """Device time by kernel over one step (torch.profiler): the ``top``
    kernels and every hand-written one, and the device's busy share of the
    step's wall time. ``step()`` returns a tuple
    whose first element is moved to the host to end the step. Returns the
    wall and busy ms, the idle share and {kernel name: [device µs,
    launches]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()[0].cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, spans = {}, []
    for evt in prof.events():
        # a record_function range (Optimizer.step#...) also shows on the
        # device's timeline; it is a span over kernels, not one
        if evt.device_type != DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False) or "#" in evt.name:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        acc = by_name.setdefault(evt.name, [0.0, 0])
        acc[0] += end - start
        acc[1] += 1
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            busy += (cur_e - cur_s) if cur_e is not None else 0.0
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += (cur_e - cur_s) if cur_e is not None else 0.0
    total = sum(v[0] for v in by_name.values())
    log(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (idle share {1 - busy / wall_us:.3f}), "
        f"{sum(v[1] for v in by_name.values())} kernels")
    # the top rows, then the kernels of csrc/*.cu that fall below them
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, count)) in enumerate(ranked):
        if i < top or name.startswith(PORT_KERNELS):
            log(f"[profile] {us / 1e3:9.3f} ms "
                f"{100 * us / max(total, 1):5.1f}% x{count:<5d} {name[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle": 1 - busy / wall_us, "kernels": by_name}


def profiled_pairs(prof: dict, what: str) -> None:
    """The profiler's kernel names as a second witness of the launch counts:
    an f32 train step runs the mma.sync forward with a bias 12 times (12
    K2) and the bias-free one twice (2 K1), none of the forwards of
    ``flash_attention.cu`` (``flash_fwd_f32<2>`` and ``<12>``, the f32
    widths of D = 64 and 384, and ``flash_fwd_wmma``), each kernel of the
    bias-free mma.sync pair twice (2 K1b backwards), each of the three
    mma.sync passes with a bias 12 times (12 K2b), and no kernel of the FMA
    pair."""
    want = {"attn_bias_fwd_mma<": 12, "flash_fwd_f32<2,": 0,
            "attn_fwd_mma<": 2, "flash_fwd_f32<12,": 0, "flash_fwd_wmma<": 0,
            "attn_bwd_dkdv_mma<": 2, "attn_bwd_dq_mma<": 2,
            "attn_bias_bwd_dkdv_mma<": 12, "attn_bias_bwd_dq_mma<": 12,
            "attn_bias_bwd_dbias<": 12, "flash_bwd_dkdv<": 0,
            "flash_bwd_dq<": 0}
    got = {part: sum(n for name, (_, n) in prof["kernels"].items()
                     if f"::{part}" in name) for part in want}
    if got != want:
        raise AssertionError(f"{what}: profiled backward kernels {got}, "
                             f"want {want}")


def lstm_dtypes(model) -> None:
    """The BiLSTM at B=8 × T frames in f32 (what the port runs under every
    compute dtype) and in bf16 (what the JAX package runs under bf16),
    timed on the card, so the choice rests on a number. PyTorch does not
    pack bf16 RNN weights into one buffer, so cuDNN packs them on each
    bf16 call (a warning says so)."""
    import copy
    import torch
    x = torch.randn((B, T, model.arch.hidden_size), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        f32_ms = time_ms(lambda: model.bilstm(x), 5)
        lstm16 = copy.deepcopy(model.bilstm).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)
        try:
            bf16 = f"{time_ms(lambda: lstm16(x16), 5):.3f} ms"
        except RuntimeError as e:     # cuDNN may refuse a bf16 RNN
            bf16 = f"refused ({str(e).splitlines()[0][:80]})"
    log(f"[lstm] BiLSTM [{B},{T},{model.arch.hidden_size}]: f32 "
        f"{f32_ms:.3f} ms, bf16 {bf16}")


# ---------------------------------------------------------------------------
# Phase 5: the card against the CPU
# ---------------------------------------------------------------------------

def phase_cross_device(cfg, ckpt: str, wav_dir: str,
                       what: str = "WavLM-base-plus") -> dict:
    """The card against the CPU in f32 (TF32 off): one 30 s utterance
    through ``forward`` (one full bucket, no masks), then the 8 wavs of
    unequal length in one masked batch through ``forward_many_decoded``
    (Whisper pads every row to 30 s and runs them unmasked)."""
    import torch
    from wfl_asr_tpu_torch.data.audio import peak_normalize, read_wav
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession, \
        _decode_segment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    audios = []
    for i in range(len(DURATIONS)):
        audio, _ = read_wav(os.path.join(wav_dir, f"utt{i}.wav"))
        audios.append(peak_normalize(audio, eps=1e-8).astype(np.float32))
    one, many, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        s = InferenceSession(cfg, ckpt, compute_dtype=torch.float32,
                             device=dev)
        logits, offsets = s.forward(audios[0], [0])
        segs = _decode_segment(s, logits[0], offsets[0], 0.0, 3, None)
        one[dev] = (logits[0], offsets[0], segs)
        many[dev] = s.forward_many_decoded(audios, [0], 0.0, 3)
        secs[dev] = time.perf_counter() - t0
        del s

    def lines(segs):
        return [f"{int(a * 1e7)} {int(b * 1e7)} {p}" for a, b, p in segs]

    def lines_differing(a, b):
        la, lb = lines(a), lines(b)
        pairs = [(x, y) for x, y in zip(la, lb) if x != y]
        return (len(pairs) + abs(len(la) - len(lb)),
                max(len(la), len(lb)), pairs[:2])

    pairs = [("forward utt0", one["cuda"], one["cpu"])] + [
        (f"forward_many_decoded utt{i}", many["cuda"][i], many["cpu"][i])
        for i in range(len(DURATIONS))]
    worst, worst_off, diff, n_lines = 0.0, 0.0, 0, 0
    for name, card, cpu in pairs:
        n_frames = len(card[0])
        if card[0].shape != cpu[0].shape or not np.isfinite(card[0]).all():
            raise AssertionError(f"{name}: card logits {card[0].shape} "
                                 f"vs CPU {cpu[0].shape}, or not finite")
        err = float(np.abs(card[0] - cpu[0]).max())
        off_err = float(np.abs(card[1] - cpu[1]).max())
        d, n, shown = lines_differing(card[2], cpu[2])
        log(f"[cross] {what} {name}: {n_frames} valid frames, logits "
            f"max_abs_diff="
            f"{err:.3e}, offsets {off_err:.3e}, .lab lines differing {d} of "
            f"{n}" + "".join(f"; card {x!r} vs CPU {y!r}" for x, y in shown))
        if not err <= CROSS_DEVICE_TOL:
            raise AssertionError(f"{name}: card vs CPU logits differ by {err} "
                                 f"(tol {CROSS_DEVICE_TOL})")
        worst, worst_off = max(worst, err), max(worst_off, off_err)
        diff, n_lines = diff + d, n_lines + n
    log(f"[cross] {what}: card vs CPU, f32 (TF32 off), every row's valid "
        f"frames: "
        f"logits max_abs_diff={worst:.3e} (tol {CROSS_DEVICE_TOL}), offsets "
        f"{worst_off:.3e}; .lab lines differing: {diff} of {n_lines} (card "
        f"{secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s incl. load)")
    return dict(max_abs_err=worst, lab_lines_differing=diff,
                lab_lines=n_lines)



# ---------------------------------------------------------------------------
# Phase 6: the training path at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS, VAL_EVERY = 6, 3
PHONES = [f"p{i}" for i in range(35)] + ["SP"]


def write_corpus(data_dir: str, n_per_lang: int = 12) -> float:
    """Synthetic wavs of 20-30 s with HTK .lab files (segments of 50-200
    ms over 36 phonemes) in two languages; returns the total seconds."""
    from wfl_asr_tpu_torch.data.audio import write_wav
    rng = np.random.RandomState(1)
    total = 0.0
    for li, lang in enumerate(("en", "ja")):
        os.makedirs(os.path.join(data_dir, lang))
        for i in range(n_per_lang):
            dur = 20.0 + 10.0 * rng.rand()
            n = int(dur * 16000)
            t = np.arange(n) / 16000.0
            wav = (0.3 * np.sin(2 * np.pi * (150 + 30 * i + 70 * li) * t)
                   * (0.5 + 0.5 * np.sin(2 * np.pi * 0.9 * t))
                   + rng.randn(n) * 0.03)
            write_wav(os.path.join(data_dir, lang, f"u{i}.wav"), wav, 16000)
            lines, start = [], 0.0
            while start < dur - 0.06:
                end = min(start + 0.05 + 0.15 * rng.rand(), dur)
                lines.append(f"{int(start * 1e7)} {int(end * 1e7)} "
                             f"{PHONES[rng.randint(len(PHONES))]}")
                start = end
            with open(os.path.join(data_dir, lang, f"u{i}.lab"), "w") as f:
                f.write("\n".join(lines) + "\n")
            total += dur
    return total


def train_config(root: str, encoder: str = "wavlm") -> dict:
    """The default config.yaml's training recipe on the flagship
    (WavLM-base-plus, BiLSTM ×2, Conformer ×2 at 2 heads, dilated ×2),
    cut to 6 steps at batch 8 with validation every 3; with
    ``encoder="whisper"`` the encoder is Whisper-base (config.yaml's
    ``whisper_model``)."""
    return {
        "data": {"data_dir": os.path.join(root, "data"), "sample_rate": 16000,
                 "num_val_files": 4, "max_seq_len": None,
                 "frame_duration": 0.02},
        "model": {
            "encoder_type": encoder,
            "wavlm_model": "microsoft/wavlm-base-plus",
            "whisper_model": "openai/whisper-base",
            "freeze_encoder": False, "enable_bilstm": True,
            "bilstm_num_layer": 2, "enable_dilated_conv": True,
            "dilated_conv_depth": 2, "dilated_conv_kernel": 3,
            "segmental_loss_weight": 1.0,
            "segmental_loss_weights": [1.0, 1.0, 2.0],
            "subframe_loss_weight": 3.0, "num_conformer_layers": 2,
            "conformer_heads": 2, "conformer_ff_expansion": 2,
            "conformer_kernel_size": 31, "conformer_dropout": 0.15,
            "lang_emb_dim": 64, "num_languages": 0},
        "training": {
            "batch_size": 8, "optimizer": "Prodigy",
            "optimizer_params": {"betas": [0.9, 0.999], "eps": 1e-8},
            "learning_rate": 1, "scheduler": "ConstantLR",
            "scheduler_params": {}, "scheduler_step_on_update": False,
            "weight_decay": 1e-5, "label_smoothing": 0.1,
            "max_steps": TRAIN_STEPS, "val_check_interval": VAL_EVERY,
            "max_checkpoints": 5, "log_dir": os.path.join(root, "run", "logs"),
            "merged_phoneme_groups": [], "seed": 0,
            "compute_dtype": "float32"},
        "augmentation": {"enable": True, "noise_std": 0.005, "prob": 0.5,
                         "volume_range": [0.9, 1.1]},
        "output": {"save_dir": os.path.join(root, "run")},
        "postprocess": {"median_filter": 3, "merge_segments": "right",
                        "device_decode": True}}


def phase_train(root: str) -> dict:
    """preprocess → train on the card (f32), with the launch counts set to
    0 just before and read just after; step times, audio-s/s trained and
    peak memory; one profiled step; the checkpoints reloaded and served;
    one bf16 step."""
    import torch
    from wfl_asr_tpu_torch.checkpoint import load_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.data.dataset import BatchLoader, PhonemeDataset, \
        split_dataset
    from wfl_asr_tpu_torch.infer.pipeline import infer_folder_batched
    from wfl_asr_tpu_torch.labels import load_phoneme_list, parse_lab
    from wfl_asr_tpu_torch.models.tagger import TaggerArch
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop

    # PyTorch's defaults, which a user's training run has (phases 3 and 5
    # turn TF32 off): f32 matmuls in full f32, cuDNN convs in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    seconds = write_corpus(os.path.join(root, "data"))
    raw = train_config(root)
    preprocess(raw["data"]["data_dir"], raw)
    save = raw["output"]["save_dir"]
    cfg = Config.load(os.path.join(save, "config.yaml"))
    labels = load_phoneme_list(os.path.join(save, "phonemes.txt"))
    log(f"[train] corpus: 24 wavs, {seconds:.1f} s, {len(labels)} labels, "
        f"2 languages; preprocess wrote {sorted(os.listdir(save))}")

    marks = []

    def on_update(step, batches):
        torch.cuda.synchronize()
        audio_s = sum(len(w) for b in batches for w in b["wavs"]) / 16000.0
        marks.append((step, time.perf_counter(), audio_s,
                      batches[0]["audio"].shape))

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = loop.train(cfg, device="cuda", on_update=on_update)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_bwd": flash_attention.bwd_launches,
              "flash_attention_trainable": flash_attention_bwd.launches,
              "flash_attention_trainable_bwd": flash_attention_bwd.bwd_launches,
              "mma bias passes": flash_attention.mma_bias_bwd_launches,
              "mma pair": flash_attention.mma_bwd_launches,
              "mma64 passes": flash_attention.mma64_bwd_launches,
              "mma128 passes": flash_attention.mma128_bwd_launches,
              "wide passes": flash_attention.wide_bwd_launches,
              "fma pair": flash_attention.fma_bwd_launches}
    fwd = fwd_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] kernel launches over {TRAIN_STEPS} steps + 2 validations: "
        f"{json.dumps(counts)}; forwards {dict(zip(FWD_ROUTES, fwd))}")
    per_forward(fwd, counts["flash_attention"],
                counts["flash_attention_trainable"], "phase 6")
    want = {"flash_attention_bwd": 12 * TRAIN_STEPS,
            "flash_attention_trainable_bwd": 2 * TRAIN_STEPS,
            "mma bias passes": 12 * TRAIN_STEPS, "mma pair": 2 * TRAIN_STEPS,
            "mma64 passes": 0, "mma128 passes": 0, "wide passes": 0,
            "fma pair": 0}
    if any(counts[k] != n for k, n in want.items()) or min(
            n for k, n in counts.items() if k not in want) < 1:
        raise AssertionError(f"training launches {counts}: want every "
                             f"kernel > 0 and per step 12 K2b (mma.sync "
                             f"passes with a bias), 2 K1b (mma.sync pair), "
                             f"0 on the other backward routes")

    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["loss"] for e in events if e["event"] == "train"]
    vals = {e["step"]: e["loss"] for e in events if e["event"] == "val"}
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    # step times: updates that follow an update (not the first, not the
    # one after a validation)
    times, audio = [], 0.0
    for (s0, t_prev, _, _), (s1, t_cur, a, shape) in zip(marks, marks[1:]):
        if s0 % VAL_EVERY:
            times.append((t_cur - t_prev) * 1e3)
            audio += a
    step_ms = float(np.median(times))
    rate = audio / (sum(times) / 1e3)
    log(f"[train] f32, batch 8 (buckets {[m[3] for m in marks]}): losses "
        f"{[round(x, 4) for x in losses]}, val {vals}; median step "
        f"{step_ms:.2f} ms over steps {[m[0] for m in marks[1:] if (m[0] - 1) % VAL_EVERY]} "
        f"({', '.join(f'{t:.1f}' for t in times)} ms), {rate:.2f} audio-s "
        f"trained per s, peak memory {peak_gb:.2f} GiB, whole run {wall:.1f} s")

    # a training batch for the checks below
    ds = PhonemeDataset(os.path.join(save, "dataset.json"), labels,
                               cfg.max_seq_len, cfg.augmentation, 16000)
    train_idx, _ = split_dataset(len(ds), cfg.num_val_files, cfg.seed)
    batch = next(iter(BatchLoader(ds, train_idx, 8, seed=0,
                                  shuffle=False).epoch_batches(0)))
    # the checkpoints: last reloads to the same logits; best is the best
    # validation's model_step file; the served path reads best
    arch = TaggerArch.from_config(cfg, len(labels))
    audio = torch.from_numpy(batch["audio"][:2]).cuda()
    lang = torch.tensor([0, 1], device="cuda")
    model.eval()
    last = load_model_checkpoint(os.path.join(save, "last_model.pt"), arch,
                                 "cuda")
    mem = model.state_dict()
    same_weights = all(torch.equal(v, mem[k])
                       for k, v in last.state_dict().items())
    with torch.no_grad():
        trained = model(audio, lang)[0]
        reloaded = last(audio, lang)[0]
    # the same weights on the same card; the logits may still differ by
    # the run-to-run order of cuDNN's and the gather backward's sums
    reload_diff = (trained - reloaded).abs().max().item()
    del last
    best_step = min(vals, key=vals.get)
    best = torch.load(os.path.join(save, "best_model.pt"), weights_only=True)
    at_best = torch.load(os.path.join(save, f"model_step{best_step}.pt"),
                         weights_only=True)
    same = all(torch.equal(best[k], at_best[k]) for k in at_best)
    if not same_weights or reload_diff > 1e-5 * trained.abs().max().item():
        raise AssertionError(f"last_model.pt: weights equal {same_weights}, "
                             f"logits differ by {reload_diff}")
    if not same:
        raise AssertionError(f"best_model.pt != model_step{best_step}.pt")
    wav_dir = os.path.join(raw["data"]["data_dir"], "en")
    out_dir = os.path.join(root, "served")
    infer_folder_batched(wav_dir, cfg, os.path.join(save, "best_model.pt"),
                         out_dir, lang_id=0, confidence_threshold=0.0,
                         batch_files=8, device="cuda",
                         compute_dtype=torch.bfloat16)
    labs = [f for f in os.listdir(out_dir) if f.endswith(".lab")]
    n_segs = sum(len(parse_lab(os.path.join(out_dir, f))) for f in labs)
    if len(labs) != 12 or n_segs == 0:
        raise AssertionError(f"served {len(labs)} .lab files, {n_segs} segs")
    log(f"[train] last_model.pt reloads to the in-memory weights exactly, "
        f"logits max diff {reload_diff:.3e} of max "
        f"{trained.abs().max().item():.3g}; best_model.pt = model_step{best_step}.pt (val "
        f"{vals[best_step]:.4f}); infer_folder_batched on it wrote "
        f"{len(labs)} .lab files, {n_segs} segments")
    # one profiled f32 step, then bf16 against f32, on that batch
    opt = loop.make_optimizer(cfg, model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step(dtype=torch.float32):
        m, _, _ = loop.train_step(model, opt, batch, "cuda", 0.1, 3.0,
                                  compute_dtype=dtype, generator=gen)
        return m["loss"], m
    step()
    profiled_pairs(profile_step(
        step, what=f"one f32 train step (batch {batch['audio'].shape})",
        top=24), "phase 6")
    bf16_ms = time_ms(lambda: step(torch.bfloat16), iters=3, warmup=1)
    bf16_loss = float(step(torch.bfloat16)[0])
    f32_ms = time_ms(step, iters=3, warmup=0)
    log(f"[train] same batch, f32 step {f32_ms:.2f} ms, bf16 step "
        f"{bf16_ms:.2f} ms (loss {bf16_loss:.4f}); "
        f"{sum(len(w) for w in batch['wavs']) / 16000:.1f} audio-s a step")
    if not math.isfinite(bf16_loss):
        raise AssertionError(f"bf16 train step loss {bf16_loss}")

    del model, opt
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=step_ms, audio_s_per_s=rate,
                peak_gb=peak_gb, bf16_ms=bf16_ms, f32_ms=f32_ms,
                labels=len(labels))


STRICT_STEPS = 4         # phase 6b, validation after the last


def set_strict(model, flag: bool) -> None:
    """Strict attention dropout on or off in a built tagger (the flag the
    WavLM layers and the Conformer blocks read), for timing both on one
    model."""
    import dataclasses
    model.encoder.arch = dataclasses.replace(model.encoder.arch,
                                             strict_attention_dropout=flag)
    for block in model.conformer_layers:
        block.strict_attn_dropout = flag


def phase_train_strict(root: str, base: dict) -> dict:
    """6b: the flagship recipe with ``training.strict_attention_dropout:
    true`` on phase 6's corpus, f32, batch 8, validation after the last
    step, with the plain attention twins replaced by stubs that raise (no
    dropout call on the card may reach them). Launch counts set to 0 just
    before ``train`` and read just after: per step 12 K2 and 2 K1 dropout
    forwards, 12 K2b and 2 K1b dropout backwards. Then on one batch: the f32
    step with strict dropout off and on, in turns; one profiled strict
    step; one bf16 strict step."""
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.data.dataset import BatchLoader, PhonemeDataset, \
        split_dataset
    from wfl_asr_tpu_torch.labels import load_phoneme_list
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    raw = train_config(root)
    raw["output"]["save_dir"] = os.path.join(root, "strict")
    raw["training"].update(strict_attention_dropout=True,
                           max_steps=STRICT_STEPS,
                           val_check_interval=STRICT_STEPS,
                           log_dir=os.path.join(root, "strict", "logs"))
    preprocess(raw["data"]["data_dir"], raw)
    save = raw["output"]["save_dir"]
    cfg = Config.load(os.path.join(save, "config.yaml"))
    labels = load_phoneme_list(os.path.join(save, "phonemes.txt"))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain attention twin ran on the card path")
    saved = flash_attention.attention_plain, \
        flash_attention.attention_backward_plain
    flash_attention.attention_plain = refuse
    flash_attention.attention_backward_plain = refuse
    try:
        marks = []

        def on_update(step, batches):
            torch.cuda.synchronize()
            marks.append((step, time.perf_counter()))

        kernels.reset_launch_counts()
        resident_gb = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = loop.train(cfg, device="cuda", on_update=on_update)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {
            "K2 dropout": flash_attention.dropout_launches,
            "K1 dropout": flash_attention_bwd.dropout_launches,
            "K2b dropout": flash_attention.dropout_bwd_launches,
            "K1b dropout": flash_attention_bwd.dropout_bwd_launches,
            "K2 all": flash_attention.launches,
            "K1 all": flash_attention_bwd.launches,
            "mma bias passes": flash_attention.mma_bias_bwd_launches,
            "mma pair": flash_attention.mma_bwd_launches,
            "mma64 passes": flash_attention.mma64_bwd_launches,
            "mma128 passes": flash_attention.mma128_bwd_launches,
            "wide passes": flash_attention.wide_bwd_launches,
            "fma pair": flash_attention.fma_bwd_launches}
        fwd = fwd_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train-strict] kernel launches over {STRICT_STEPS} strict "
            f"steps + 1 validation: {json.dumps(counts)}; forwards "
            f"{dict(zip(FWD_ROUTES, fwd))}")
        per_forward(fwd, counts["K2 all"], counts["K1 all"], "phase 6b")
        want = {"K2 dropout": 12 * STRICT_STEPS,
                "K1 dropout": 2 * STRICT_STEPS,
                "K2b dropout": 12 * STRICT_STEPS,
                "K1b dropout": 2 * STRICT_STEPS,
                "mma bias passes": 12 * STRICT_STEPS,
                "mma pair": 2 * STRICT_STEPS,
                "mma64 passes": 0, "mma128 passes": 0, "wide passes": 0,
                "fma pair": 0}
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"strict training launches {counts}: want "
                                 f"per step 12 K2, 2 K1, 12 K2b (mma.sync "
                                 f"passes with a bias), 2 K1b (mma.sync "
                                 f"pair) with dropout, 0 on the FMA pair")
        with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e["loss"] for e in events if e["event"] == "train"]
        vals = [e["loss"] for e in events if e["event"] == "val"]
        if len(losses) != STRICT_STEPS or not all(
                map(math.isfinite, losses + vals)) or len(vals) != 1:
            raise AssertionError(f"strict train losses {losses}, val {vals}")
        times = [(t1 - t0_) * 1e3 for (_, t0_), (_, t1) in
                 zip(marks, marks[1:])]
        step_ms = float(np.median(times))
        log(f"[train-strict] f32, batch 8, strict attention dropout (WavLM "
            f"0.1, Conformer 0.15): losses {[round(x, 4) for x in losses]}, "
            f"val {vals[0]:.4f}; median step {step_ms:.2f} ms over "
            f"{', '.join(f'{t:.1f}' for t in times)} ms (not strict, phase "
            f"6: {base['step_ms']:.2f}); peak memory {peak_gb:.2f} GiB, "
            f"{resident_gb:.2f} of it resident before the run (not strict "
            f"{base['peak_gb']:.2f}); whole run {wall:.1f} s")

        ds = PhonemeDataset(os.path.join(save, "dataset.json"), labels,
                            cfg.max_seq_len, cfg.augmentation, 16000)
        train_idx, _ = split_dataset(len(ds), cfg.num_val_files, cfg.seed)
        batch = next(iter(BatchLoader(ds, train_idx, 8, seed=0,
                                      shuffle=False).epoch_batches(0)))
        opt = loop.make_optimizer(cfg, model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step(dtype=torch.float32):
            m, _, _ = loop.train_step(model, opt, batch, "cuda", 0.1, 3.0,
                                      compute_dtype=dtype, generator=gen)
            return m["loss"], m
        step()
        turns, peaks = [], {False: 0.0, True: 0.0}
        for flag in (False, True, True, False):
            set_strict(model, flag)
            torch.cuda.reset_peak_memory_stats()
            turns.append(time_ms(step, iters=3, warmup=1))
            peaks[flag] = max(peaks[flag],
                              torch.cuda.max_memory_allocated() / 2 ** 30)
        set_strict(model, True)
        ab = (float(np.mean(turns[1:3])), float(np.mean(turns[::3])))
        log(f"[train-strict] same batch {tuple(batch['audio'].shape)}, f32 "
            f"step in turns off/on/on/off: "
            f"{', '.join(f'{t:.2f}' for t in turns)} ms — strict "
            f"{ab[0]:.2f} against {ab[1]:.2f} ms ({ab[0] / ab[1]:.4f}×); "
            f"peak memory strict {peaks[True]:.3f} against "
            f"{peaks[False]:.3f} GiB ({peaks[True] / peaks[False]:.4f}×)")
        profiled_pairs(profile_step(step, what="one strict f32 train step",
                                    top=24), "phase 6b")
        bf16_loss = float(step(torch.bfloat16)[0])
        log(f"[train-strict] one bf16 strict step: loss {bf16_loss:.4f}")
        if not math.isfinite(bf16_loss):
            raise AssertionError(f"bf16 strict step loss {bf16_loss}")
    finally:
        flash_attention.attention_plain, \
            flash_attention.attention_backward_plain = saved
    del model, opt
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=step_ms, peak_gb=peak_gb,
                same_batch_ms=ab)


# ---------------------------------------------------------------------------
# Phase 7: one train step, the card against the CPU
# ---------------------------------------------------------------------------

def train_batch(num_labels: int, seconds: float = 8.0) -> dict:
    """Two rows of ``seconds`` of audio (the second shorter, zero-padded),
    −100-padded labels and offset targets, from a seed."""
    from wfl_asr_tpu_torch.train.losses import offset_targets_from_segments
    rng = np.random.RandomState(7)
    s = int(seconds * 16000)
    frames = int(seconds / 0.02)
    audio = (rng.randn(2, s) * 0.1).astype(np.float32)
    audio[1, int(0.75 * s):] = 0.0
    labels = np.full((2, frames), -100, np.int64)
    targets = []
    for i, n in enumerate((frames - 1, int(0.75 * frames))):
        labels[i, :n] = rng.randint(0, num_labels, size=n)
        edges = np.cumsum(rng.uniform(0.05, 0.2, size=80))
        segs = [(float(a), float(b), "p1") for a, b in zip(edges, edges[1:])
                if b < n * 0.02]
        targets.append(offset_targets_from_segments(segs, 0.02, n, 192))
    f, c, x, v = (np.stack([t[j] for t in targets]) for j in range(4))
    return {"audio": audio, "labels": labels,
            "lang_ids": np.array([0, 1], np.int32), "off_frames": f,
            "off_channels": c, "off_fracs": x, "off_valid": v,
            "max_label_len": frames}


def _scaled_dropout(x, rate, generator=None, training=True):
    """A deterministic stand-in for the heads' generator dropout (the
    card's and the CPU's generators draw different bits), so phase 7b can
    keep the Conformer's rate, and its in-kernel dropout, above 0."""
    return x if not training or rate <= 0.0 else x * (1.0 - rate)


def phase_train_cross_device(labels: int, strict: bool = False,
                             encoder: str = "wavlm",
                             default_heads: bool = False) -> dict:
    """f32 with TF32 off, the flagship at full width, the same weights and
    batch: loss ≤ 1e-5 relative, every gradient ≤ 1e-3 × its max |grad|
    (one whose CPU value is below 1e-6 × the largest gradient is 0 in
    exact arithmetic — the key bias, the conv bias before BatchNorm — and
    must be below that on the card too). Phase 7: dropout 0. Phase 7b
    (``strict``): strict attention dropout at the recipe's rates (WavLM
    0.1, Conformer 0.15) with the same fixed seed for each attention call
    on both devices (the seed helper patched), the heads' generator
    dropout replaced by a deterministic scaling, every other dropout 0.

    The step is piecewise smooth: the dilated conv stack's ReLUs are its
    one kink. Seeded inputs put a few ReLU inputs within 1e-6 of 0, where
    any change of f32 rounding may take the other branch and move the
    gradients downstream of it by a discrete step. Both steps record every
    ReLU input. The card step first takes its own branches; where no input
    has the other sign on the CPU, its gradients are the ones held to the
    tolerance. Otherwise it fails if an input of the other sign lies above
    RELU_TIE on either device, or if more than RELU_MAX_PINNED do; below
    both, the card step runs again on the CPU's branches (relu(x) = x where
    the CPU's input was > 0, else 0), so the gradients compare the same
    piece of the function, and that run is held to the tolerance; the
    loss, continuous across the kink, is held to 1e-5 on both card runs.
    The log shows the worst gradient diff of both card runs.

    ``encoder="whisper"`` (phase 9b): Whisper-base with the same heads, at
    B=2×30 s (the encoder pads to 30 s anyway), its dropout 0;
    ``default_heads`` (phase 9e): without the ``conformer_heads`` key, so
    the Conformer runs the schema's 4 heads of 128 on route mma128."""
    import dataclasses
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models import heads, layers
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = train_config("/nonexistent", encoder)
    raw["training"]["strict_attention_dropout"] = strict
    if default_heads:
        del raw["model"]["conformer_heads"]
    cfg = Config(raw)
    cfg.num_languages = 2
    arch = TaggerArch.from_config(cfg, labels)
    arch = dataclasses.replace(
        arch, conformer_dropout=arch.conformer_dropout if strict else 0.0)
    if encoder == "whisper":
        seconds = 30.0
        arch = dataclasses.replace(arch, whisper=dataclasses.replace(
            arch.whisper, dropout=0.0, activation_dropout=0.0,
            layerdrop=0.0))
        # backward routes (BWD_ROUTES), forwards (FWD_ROUTES): 2 Conformer
        # blocks on the mma.sync pair and forward, 6 Whisper layers on the
        # bias-free D = 64 passes and forward (f32: mma64)
        want_routes = [0, 2, 6, 0, 0, 0, 0, 0] * 2
        if default_heads:     # the Conformer at head_dim 128: mma128
            want_routes = [0, 0, 6, 0, 0, 2, 0, 0] * 2
    else:
        seconds = 8.0
        arch = dataclasses.replace(arch, wavlm=dataclasses.replace(
            arch.wavlm, hidden_dropout=0.0, feat_proj_dropout=0.0,
            layerdrop=0.0))
        want_routes = [12, 2, 0, 0, 0, 0, 0, 0] * 2
    batch = train_batch(labels, seconds)
    seeds = [int(s) for s in np.random.RandomState(11).randint(
        -2 ** 31, 2 ** 31 - 1, size=64)]
    draws = []

    def fixed_seed(generator, device):
        draws.append(device)
        return torch.tensor([seeds[len(draws) - 1]], dtype=torch.int32,
                            device=device)

    relu = torch.relu
    relu_in = {}

    def recorded(dev, pinned):
        def fn(x):
            seen = relu_in.setdefault(dev, [])
            seen.append(x.detach().float().cpu())
            if not pinned:
                return relu(x)
            keep = (relu_in["cpu"][len(seen) - 1] > 0).to(x.device)
            return torch.where(keep, x, torch.zeros_like(x))
        return fn

    def step(dev, pinned=False):
        nonlocal drop_counts, routes, n_draws
        draws.clear()
        relu_in.pop(dev, None)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model = init_tagger(arch, torch.Generator().manual_seed(3), dev)
        torch.relu = recorded(dev, pinned)
        try:
            m, _, _ = loop.micro_step(model, batch, dev, 1, 0.1, 3.0)
        finally:
            torch.relu = relu
        if dev == "cuda":
            drop_counts = [flash_attention.dropout_launches,
                           flash_attention_bwd.dropout_launches,
                           flash_attention.dropout_bwd_launches,
                           flash_attention_bwd.dropout_bwd_launches]
            routes = route_counts() + fwd_counts()
            n_draws = len(draws)
        return (float(m["loss"]), {n: p.grad.float().cpu() for n, p
                                   in model.named_parameters()},
                time.perf_counter() - t0)

    def flips():
        """ReLU inputs of the other sign on the card (CPU, card); fails on
        one above RELU_TIE or on more than RELU_MAX_PINNED."""
        if len(relu_in["cuda"]) != len(relu_in["cpu"]):
            raise AssertionError(f"ReLU calls: card {len(relu_in['cuda'])}, "
                                 f"CPU {len(relu_in['cpu'])}")
        out = []
        for x_card, x_cpu in zip(relu_in["cuda"], relu_in["cpu"]):
            other = (x_card > 0) != (x_cpu > 0)
            out += list(zip(x_cpu[other].tolist(), x_card[other].tolist()))
        far = [(a, c) for a, c in out if max(abs(a), abs(c)) > RELU_TIE]
        if far or len(out) > RELU_MAX_PINNED:
            raise AssertionError(
                f"{len(out)} ReLU inputs of other signs on the card and the "
                f"CPU (limit {RELU_MAX_PINNED}), {len(far)} above {RELU_TIE} "
                f"(CPU, card): {(far or out)[:4]}")
        return out

    def worst_grad(g_card, g_cpu):
        """The worst gradient diff as a fraction of its max |grad|, and an
        error for the first gradient out of tolerance (or None)."""
        gmax = max(g.abs().max().item() for g in g_cpu.values())
        worst, worst_name, bad = 0.0, "", None
        for name, g in g_cpu.items():
            scale = g.abs().max().item()
            diff = (g_card[name] - g).abs().max().item()
            if scale <= 1e-6 * gmax:
                ok = g_card[name].abs().max().item() <= 1e-6 * gmax
                rel = 0.0
            else:
                rel = diff / scale
                ok = rel <= 1e-3
            if not ok and bad is None:
                bad = (f"{name}: card vs CPU gradient diff {diff} (max |g| "
                       f"{scale})")
            if rel > worst:
                worst, worst_name = rel, name
        return worst, worst_name, bad

    saved = layers.attention_dropout_seed, heads.dropout
    if strict:
        layers.attention_dropout_seed, heads.dropout = fixed_seed, \
            _scaled_dropout
    drop_counts = routes = None
    n_draws = 0
    try:
        l_cpu, g_cpu, s_cpu = step("cpu")
        l_card, g_card, s_card = step("cuda")
        flipped = flips()
        free = worst_grad(g_card, g_cpu)
        loss_own = abs(l_card - l_cpu) / abs(l_cpu)
        if flipped:
            l_card, g_card, s_pin = step("cuda", pinned=True)
            pinned_flips = flips()
            s_card += s_pin
    finally:
        layers.attention_dropout_seed, heads.dropout = saved
    relu_diff = max((a - c).abs().max().item()
                    for a, c in zip(relu_in["cuda"], relu_in["cpu"]))
    relu_min = min(x.abs().min().item() for x in relu_in["cpu"])
    want = [12, 2, 12, 2] if strict else [0, 0, 0, 0]
    if drop_counts != want or n_draws != (14 if strict else 0):
        raise AssertionError(f"dropout launches on the card {drop_counts} "
                             f"(want {want}), seeds drawn {n_draws}")
    if routes != want_routes:
        raise AssertionError(f"backward routes on the card {BWD_ROUTES} "
                             f"and forwards {FWD_ROUTES} {routes}, want "
                             f"{want_routes}")
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_name, bad = worst_grad(g_card, g_cpu) if flipped else free
    what = ("strict attention dropout (WavLM 0.1, Conformer 0.15; fixed "
            "seeds; dropout launches on the card K2/K1/K2b/K1b "
            f"{drop_counts})" if strict else "dropout 0")
    what += (f"; backward routes on the card {BWD_ROUTES} and forwards "
             f"{FWD_ROUTES} {routes}; ReLU "
             f"inputs card vs CPU max diff "
             f"{relu_diff:.2e}, smallest |input| on the CPU {relu_min:.2e}, "
             f"{len(flipped)} of other sign on the card's own branches "
             f"(CPU, card: "
             + (", ".join(f"{a:.2e}, {c:.2e}" for a, c in flipped)
                or "none") + f"; limits {RELU_TIE:g}, {RELU_MAX_PINNED})")
    if flipped:
        what += (f"; card's own branches: loss rel {loss_own:.2e} (tol "
                 f"1e-5), worst {free[0]:.2e} × max|g| ({free[1]}), not held "
                 f"to the tolerance; rerun on the CPU's branches "
                 f"({len(pinned_flips)} of other sign on the card)")
    log(f"[cross-train] {encoder}, Conformer {arch.conformer_heads} heads: "
        f"one f32 train step (TF32 off), B=2×"
        f"{seconds:g} s, {what}: "
        f"loss card {l_card:.7f} vs CPU {l_cpu:.7f} (rel {loss_rel:.2e}, tol "
        f"1e-5); {len(g_cpu)} gradients"
        f"{' on the CPU branches' if flipped else ''}, worst {worst:.2e} × "
        f"max|g| "
        f"({worst_name}; tol 1e-3); card {s_card:.1f} s, CPU {s_cpu:.1f} s")
    if not (loss_rel <= 1e-5 and loss_own <= 1e-5):
        raise AssertionError(f"card vs CPU loss rel diff {loss_rel} (on the "
                             f"card's own branches {loss_own})")
    if bad:
        raise AssertionError(bad)
    return dict(loss_rel=loss_rel, loss_rel_own=loss_own, grad_rel=worst,
                grad_rel_own=free[0], relu_flips=len(flipped))


# ---------------------------------------------------------------------------
# Phases 8-9c: the Whisper encoder and the mel front end
# ---------------------------------------------------------------------------

WHISPER_LAYERS = 6      # Whisper-base; its attention runs K1 at D = 64
WHISPER_STEPS = 4       # phase 9, validation after the last


def whisper_fwd_counts(what: str, flash_fwd: int, conformer: str = "mma",
                       layers: str = "mma64") -> int:
    """Each forward of the Whisper-base tagger runs K1 on the route
    ``layers`` in each of its 6 layers (D = 64: ``mma64``, the bias-free f32
    instantiation of the D = 64 forward, or in bf16 ``wgmma64``, the wgmma
    forward of ``attention_wgmma.cu``) and on the route ``conformer`` in
    each of the 2 Conformer blocks (at 2 heads, D = 256: ``mma``, the
    bias-free mma.sync forward of ``attention_fwd_mma.cu``; at the schema's
    4 heads, D = 128: ``mma128`` in f32, ``wgmma128`` in bf16), and no
    forward with a bias, none on the fused forwards: ``flash_fwd`` launches
    of the entry point, split so. Returns the number of tagger forwards."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    got = fwd_counts()
    n = got[FWD_ROUTES.index(conformer)] // 2
    want = [{conformer: 2 * n, layers: WHISPER_LAYERS * n}.get(r, 0)
            for r in FWD_ROUTES]
    if n < 1 or got != want or flash_fwd != 8 * n or fa.launches:
        raise AssertionError(f"{what}: forwards {FWD_ROUTES} {got}, "
                             f"{flash_fwd} K1 and {fa.launches} K2 launches; "
                             f"want 6 {layers} and 2 {conformer} K1 a "
                             f"forward, no K2")
    return n


def wgmma_launches(prof: dict, kernel: str, d: int) -> int:
    """Launches in a profiled step of ``kernel`` of ``attention_wgmma.cu``
    (``attn_wg_fwd``, ``attn_wg_dkdv``) at head width ``d`` (its first
    template argument)."""
    return sum(n for name, (_, n) in prof["kernels"].items()
               if f"::{kernel}<{d}," in name)


def bias_free(prof: dict, kernel: str, d: int) -> int:
    """Launches in a profiled step of the instantiation at head width
    ``d`` of a kernel of ``attention_{fwd,bwd}_bias_mma.cu`` (its last
    template argument); for ``attn_bias_fwd_mma`` and
    ``attn_bias_bwd_dkdv_mma``, only the bias-free ones (the second, BIAS,
    false)."""
    flag = "" if kernel == "attn_bias_bwd_dq_mma" else r", false"
    pat = rf"::{kernel}<[^,<>]*{flag}[^<>]*, {d}>"
    return sum(n for name, (_, n) in prof["kernels"].items()
               if re.search(pat, name))



def serve_whisper_base(root: str, iters: int, default_heads: bool = False
                       ) -> dict:
    """Whisper-base with the flagship heads (``default_heads``: without the
    config's ``conformer_heads`` key, so the schema's 4 heads of 128),
    saved as .pt, served by ``infer_folder_batched`` on the card in bf16
    over a copy of phase 4's wavs, the launch counts set to 0 just before
    and read just after (a forward: 6 K1 on the bias-free D = 64 forward
    and 2 on the Conformer's route, none fused, no K5); the batched forward
    timed at B=8×30 s in bf16 and f32 with its peak memory; one bf16 step
    profiled, its kernel names by head width as a second witness. Served in
    bf16, the 6 layers run the wgmma forward at D = 64 (wgmma64), the
    Conformer at 4 heads at D = 128 (wgmma128)."""
    import torch
    from wfl_asr_tpu_torch.infer.pipeline import infer_folder_batched
    from wfl_asr_tpu_torch.labels import parse_lab
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import conv_fused, \
        flash_attention_bwd

    conformer, tag = ("wgmma128", "8c") if default_heads else ("mma", "8")
    cfg, ckpt, wav_dir = make_run(root, "whisper", default_heads)
    what = f"Whisper-base, {cfg.conformer_heads} Conformer heads"
    out_dir = os.path.join(root, f"labs_whisper_{cfg.conformer_heads}heads")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    infer_folder_batched(wav_dir, cfg, ckpt, out_dir, lang_id=0,
                         confidence_threshold=0.0, batch_files=8,
                         device="cuda", compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = flash_attention_bwd.launches
    n_fwd = whisper_fwd_counts(f"phase {tag}", k1, conformer, "wgmma64")
    routes = dict(zip(FWD_ROUTES, fwd_counts()))
    if conv_fused.layer_launches:
        raise AssertionError(f"phase {tag} launched K5 "
                             f"{conv_fused.layer_launches} times")
    n_segs = []
    for i in range(len(DURATIONS)):
        lab = os.path.join(out_dir, f"utt{i}.lab")
        segs = parse_lab(lab) if os.path.exists(lab) else []
        # the Whisper window is 30 s whatever the file's length
        if not segs or segs[-1][1] > 30.05:
            raise AssertionError(f"{lab}: {len(segs)} segments, bad span")
        n_segs.append(len(segs))
    log(f"[whisper] phase {tag}, {what}: infer_folder_batched on cuda, "
        f"bf16, device_decode, batch_files=8: {len(DURATIONS)} .lab files "
        f"with {n_segs} segments in {wall:.2f} s; K1 launches {k1} over "
        f"{n_fwd} forward(s): forwards {routes}")

    perf, step = serving_perf(cfg, ckpt, iters, what)
    prof = profile_step(step, f"one bf16 serving step, {what}")
    # the Conformer's 2 K1 on the mma.sync forward (2 heads) or on the
    # wgmma forward at D = 128 (4 heads); none on the mma.sync D = 64/128
    # forward
    c = 0 if default_heads else 2
    want = {"flash_fwd_": 0, "attn_fwd_mma<": c, "attn_bias_fwd_mma<": 0,
            "attn_wg_fwd<": WHISPER_LAYERS + 2 - c, "conv_layer_mma<": 0}
    got = {part: sum(n for name, (_, n) in prof["kernels"].items()
                     if f"::{part}" in name) for part in want}
    widths = (wgmma_launches(prof, "attn_wg_fwd", 64),
              wgmma_launches(prof, "attn_wg_fwd", 128))
    if got != want or widths != (WHISPER_LAYERS, 2 - c):
        raise AssertionError(f"phase {tag}: profiled forward kernels {got}, "
                             f"wgmma at D = 64 and 128 {widths}, want "
                             f"{want}, ({WHISPER_LAYERS}, {2 - c})")
    return dict(perf=perf, routes=routes, cfg=cfg, ckpt=ckpt,
                wav_dir=wav_dir, busy_ms=prof["busy_ms"], idle=prof["idle"],
                wall_ms=prof["wall_ms"])


def phase_whisper_serving(root: str, iters: int) -> dict:
    """8: Whisper-base served at the config's 2 Conformer heads
    (``serve_whisper_base``); one bf16 forward of the ``large-v3`` preset
    at full width (128 mels, 32 layers of 1280, 20 heads; the Conformer at
    the config's 2 heads, head_dim 640, on the wide route), timed, its
    logits finite."""
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention_bwd

    run = serve_whisper_base(root, iters)
    cfg = run["cfg"]
    # large-v3 at full width, the Conformer at the config's 2 heads
    raw = {"data": {"sample_rate": 16000, "frame_duration": 0.02},
           "model": dict(cfg.raw["model"],
                         whisper_model="openai/whisper-large-v3")}
    arch = TaggerArch.from_config(Config(raw), 73)
    t0 = time.perf_counter()
    model = init_tagger(arch, torch.Generator().manual_seed(0), "cuda")
    init_s = time.perf_counter() - t0
    audio = torch.from_numpy((np.random.RandomState(1).randn(B, 480000)
                              * 0.1).astype(np.float32)).cuda()
    lang = torch.zeros(B, dtype=torch.int64, device="cuda")

    def large():
        with torch.inference_mode():
            return model(audio, lang, compute_dtype=torch.bfloat16)[0]
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    logits = large()
    whisper_counts = [flash_attention_bwd.launches] + fwd_counts()
    large_ms = time_ms(large, iters=3, warmup=1)
    large_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    finite = bool(torch.isfinite(logits.float()).all())
    log(f"[whisper] large-v3 tagger ({n_params} parameters, 128 mels, 32 "
        f"layers of 1280, 20 heads; Conformer {arch.conformer_heads} heads, "
        f"head_dim {1280 // arch.conformer_heads}), bf16 forward at "
        f"B={B}×30 s: {large_ms:.2f} ms ({B * 30 / large_ms * 1e3:.2f} "
        f"audio-s/s), peak memory {large_peak:.3f} GiB ({resident:.3f} "
        f"resident before), logits "
        f"{tuple(logits.shape)} finite {finite}; K1 launches and forwards "
        f"{FWD_ROUTES} {whisper_counts}; built in {init_s:.1f} s")
    # K1, then the forward routes: 32 layers on wgmma64, 2 Conformer
    # blocks on the wide route
    want = [34, 0, 0, 0, 2, 0, 0, 32, 0]
    if not finite or whisper_counts != want or arch.conformer_heads != 2:
        raise AssertionError(f"large-v3: logits finite {finite}, launches "
                             f"{whisper_counts}, want {want}, Conformer "
                             f"heads {arch.conformer_heads}")
    del model, logits
    torch.cuda.empty_cache()
    return dict(run, wgmma64=run["routes"]["wgmma64"],
                wide=whisper_counts[4], large_ms=large_ms,
                large_peak_gb=large_peak)


def phase_whisper_cross_device(root: str, run: dict) -> dict:
    """8b: the card against the CPU in f32 (TF32 off), phase 5's checks:
    Whisper-base (one 30 s utterance through ``forward``, the 8 wavs
    through ``forward_many_decoded``), then the ``none`` encoder at full
    width (80 mels, hidden 80, Conformer head_dim 40) over the same wavs,
    whose unequal lengths take the host's reflect padding and the
    ``precentered`` STFT."""
    cross = {"whisper": phase_cross_device(run["cfg"], run["ckpt"],
                                           run["wav_dir"], "Whisper-base")}
    cfg, ckpt, wav_dir = make_run(root, "none")
    cross["none"] = phase_cross_device(cfg, ckpt, wav_dir, "none")
    return cross


def phase_whisper_train(root: str, default_heads: bool = False) -> dict:
    """9: preprocess and train Whisper-base with the flagship heads on
    phase 6's corpus, the default recipe in f32, batch 8, 4 steps,
    validation after the last, the plain attention twins replaced by stubs
    that raise; the launch counts set to 0 just before ``train`` and read
    just after (a step: 6 K1b on the bias-free D = 64 passes, 2 on the
    mma.sync pair, none on the FMA pair; a forward: 6 bias-free D = 64 and
    2 mma.sync K1); step times, audio-s/s trained,
    peak memory; one profiled step; ``last_model.pt`` reloaded to the same
    logits. 9d (``default_heads``): the same without the config's
    ``conformer_heads`` key, so the Conformer runs the schema's 4 heads of
    128: its 2 K1b a step on the bias-free D = 128 passes (mma128) and its
    2 K1 a forward on the D = 128 forward, none on the mma.sync pair or
    the FMA pair."""
    import torch
    from wfl_asr_tpu_torch.checkpoint import load_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.data.dataset import BatchLoader, PhonemeDataset, \
        split_dataset
    from wfl_asr_tpu_torch.labels import load_phoneme_list
    from wfl_asr_tpu_torch.models.tagger import TaggerArch
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    if not os.path.isdir(os.path.join(root, "data")):
        write_corpus(os.path.join(root, "data"))
    raw = train_config(root, "whisper")
    conformer, tag = ("mma128", "9d") if default_heads else ("mma", "9")
    if default_heads:
        del raw["model"]["conformer_heads"]
    save = os.path.join(root, "whisper_4heads_run" if default_heads
                        else "whisper_run")
    raw["output"]["save_dir"] = save
    raw["training"].update(max_steps=WHISPER_STEPS,
                           val_check_interval=WHISPER_STEPS,
                           log_dir=os.path.join(save, "logs"))
    preprocess(raw["data"]["data_dir"], raw)
    cfg = Config.load(os.path.join(save, "config.yaml"))
    labels = load_phoneme_list(os.path.join(save, "phonemes.txt"))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain attention twin ran on the card path")
    saved = flash_attention.attention_plain, \
        flash_attention.attention_backward_plain
    flash_attention.attention_plain = refuse
    flash_attention.attention_backward_plain = refuse
    try:
        marks = []

        def on_update(step, batches):
            torch.cuda.synchronize()
            audio_s = sum(len(w) for b in batches for w in b["wavs"]) / 16000
            marks.append((step, time.perf_counter(), audio_s))

        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = loop.train(cfg, device="cuda", on_update=on_update)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"K1": flash_attention_bwd.launches,
                  "K1b": flash_attention_bwd.bwd_launches,
                  "mma bias passes": flash_attention.mma_bias_bwd_launches,
                  "mma pair": flash_attention.mma_bwd_launches,
                  "mma64 passes": flash_attention.mma64_bwd_launches,
                  "mma128 passes": flash_attention.mma128_bwd_launches,
                  "wgmma64 passes": flash_attention.wgmma64_bwd_launches,
                  "wgmma128 passes": flash_attention.wgmma128_bwd_launches,
                  "wide passes": flash_attention.wide_bwd_launches,
                  "fma pair": flash_attention.fma_bwd_launches}
        fwd = dict(zip(FWD_ROUTES, fwd_counts()))
        counts.update({"mma64 forwards": fwd["mma64"],
                       "mma128 forwards": fwd["mma128"]})
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        n_fwd = whisper_fwd_counts(f"phase {tag}", counts["K1"], conformer)
        log(f"[whisper-train] phase {tag}, Conformer "
            f"{cfg.conformer_heads} heads: kernel launches over "
            f"{WHISPER_STEPS} steps + 1 validation ({n_fwd} forwards): "
            f"{json.dumps(counts)}")
        pair = "mma128 passes" if default_heads else "mma pair"
        want = {"K1b": 8 * WHISPER_STEPS, "mma bias passes": 0,
                "mma pair": 0, "mma128 passes": 0,
                "mma64 passes": WHISPER_LAYERS * WHISPER_STEPS,
                "wgmma64 passes": 0, "wgmma128 passes": 0,
                "wide passes": 0, "fma pair": 0}
        want[pair] = 2 * WHISPER_STEPS
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"Whisper training launches {counts}: want "
                                 f"per step 6 K1b on the bias-free D = 64 "
                                 f"passes, 2 on the {pair}, 0 on the FMA "
                                 f"pair")
        with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e["loss"] for e in events if e["event"] == "train"]
        vals = [e["loss"] for e in events if e["event"] == "val"]
        if len(losses) != WHISPER_STEPS or len(vals) != 1 or not all(
                map(math.isfinite, losses + vals)):
            raise AssertionError(f"Whisper train losses {losses}, val {vals}")
        times = [(t1 - t0_) * 1e3 for (_, t0_, _), (_, t1, _) in
                 zip(marks, marks[1:])]
        step_ms = float(np.median(times))
        rate = sum(a for _, _, a in marks[1:]) / (sum(times) / 1e3)
        log(f"[whisper-train] phase {tag}, f32, batch 8: losses "
            f"{[round(x, 4) for x in losses]}, val {vals[0]:.4f}; median "
            f"step {step_ms:.2f} ms over {', '.join(f'{t:.1f}' for t in times)}"
            f" ms, {rate:.2f} audio-s trained per s, peak memory "
            f"{peak_gb:.2f} GiB, whole run {wall:.1f} s")

        ds = PhonemeDataset(os.path.join(save, "dataset.json"), labels,
                            cfg.max_seq_len, cfg.augmentation, 16000)
        train_idx, _ = split_dataset(len(ds), cfg.num_val_files, cfg.seed)
        batch = next(iter(BatchLoader(ds, train_idx, 8, seed=0,
                                      shuffle=False).epoch_batches(0)))
        arch = TaggerArch.from_config(cfg, len(labels))
        audio = torch.from_numpy(batch["audio"][:2]).cuda()
        lang = torch.tensor([0, 1], device="cuda")
        model.eval()
        last = load_model_checkpoint(os.path.join(save, "last_model.pt"),
                                     arch, "cuda")
        mem = model.state_dict()
        same_weights = all(torch.equal(v, mem[k])
                           for k, v in last.state_dict().items())
        with torch.no_grad():
            trained = model(audio, lang)[0]
            reloaded = last(audio, lang)[0]
        reload_diff = (trained - reloaded).abs().max().item()
        del last
        if not same_weights or \
                reload_diff > 1e-5 * trained.abs().max().item():
            raise AssertionError(f"last_model.pt: weights equal "
                                 f"{same_weights}, logits differ by "
                                 f"{reload_diff}")
        log(f"[whisper-train] last_model.pt reloads to the in-memory "
            f"weights exactly, logits max diff {reload_diff:.3e} of max "
            f"{trained.abs().max().item():.3g}")

        opt = loop.make_optimizer(cfg, model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            m, _, _ = loop.train_step(model, opt, batch, "cuda", 0.1, 3.0,
                                      generator=gen)
            return m["loss"], m
        step()
        prof = profile_step(step, what="one f32 Whisper-base train step "
                            f"(batch {batch['audio'].shape}, Conformer "
                            f"{cfg.conformer_heads} heads)", top=24)
        # the Conformer's 2 K1 and 2 K1b on the mma.sync forward and pair
        # (2 heads) or on the D = 128 instantiations (4 heads)
        c = 0 if default_heads else 2
        want = {"flash_fwd_": 0, "attn_fwd_mma<": c,
                "attn_bias_fwd_mma<": WHISPER_LAYERS + 2 - c,
                "flash_bwd_dkdv<": 0, "flash_bwd_dq<": 0,
                "attn_bwd_dkdv_mma<": c, "attn_bwd_dq_mma<": c,
                "attn_bias_bwd_dkdv_mma<": WHISPER_LAYERS + 2 - c,
                "attn_bias_bwd_dq_mma<": WHISPER_LAYERS + 2 - c,
                "attn_bias_bwd_dbias<": 0}
        got = {part: sum(n for name, (_, n) in prof["kernels"].items()
                         if f"::{part}" in name) for part in want}
        widths = {(k, d): bias_free(prof, k, d)
                  for k in ("attn_bias_fwd_mma", "attn_bias_bwd_dkdv_mma",
                            "attn_bias_bwd_dq_mma") for d in (64, 128)}
        want_widths = {(k, d): WHISPER_LAYERS if d == 64 else 2 - c
                       for k, d in widths}
        if got != want or widths != want_widths:
            raise AssertionError(f"phase {tag}: profiled kernels {got}, "
                                 f"bias-free by head width {widths}, want "
                                 f"{want}, {want_widths}")
    finally:
        flash_attention.attention_plain, \
            flash_attention.attention_backward_plain = saved
    out = dict(counts=counts, step_ms=step_ms, audio_s_per_s=rate,
               peak_gb=peak_gb, labels=len(labels), busy_ms=prof["busy_ms"],
               idle=prof["idle"])
    if default_heads:       # for phase 9f
        out.update(model=model, batch=batch, cfg=cfg)
    del model, opt
    torch.cuda.empty_cache()
    return out


def phase_whisper_bf16_train(run: dict) -> dict:
    """9f: the bf16 training path. Whisper-base at the schema's 4 Conformer
    heads (phase 9d's trained model and one batch of its corpus, B = 8 ×
    30 s windows), the default recipe with ``training.compute_dtype:
    bfloat16``: the plain attention twins replaced by stubs that raise,
    the loss of one f32 and one bf16 forward and backward on the same
    batch and weights (no update), then 2 bf16 Prodigy steps through
    ``loop.train_step``, the launch counts set to 0 just before the first
    and read just after the last: a step runs 6 backwards on the wgmma
    route at D = 64 (wgmma64) and 2 at D = 128 (wgmma128), as many
    forwards, none on the f32 routes mma64 and mma128. The step's ms
    (the second), audio-s/s, peak memory and, over one more profiled step,
    the device's busy and idle share. The losses must be finite and every
    gradient finite when the optimizer steps. No tolerance is set on the
    bf16 loss against the f32 one: the kernels' correctness in bf16 is
    held by phases 3e and 3d; the gap is printed."""
    import copy
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention
    from wfl_asr_tpu_torch.train import loop
    model, batch, cfg = run["model"], run["batch"], run["cfg"]
    if cfg.conformer_heads != 4:
        raise AssertionError("phase 9f needs phase 9d's run at 4 heads")
    # the dtype the training loop takes from the config's key
    raw = copy.deepcopy(cfg.raw)
    raw.setdefault("training", {})["compute_dtype"] = "bfloat16"
    bf16 = loop._compute_dtype(Config(raw))
    if bf16 != torch.bfloat16:
        raise AssertionError(f"training.compute_dtype bfloat16 gives {bf16}")
    opt = loop.make_optimizer(cfg, model.parameters())
    checked = []

    def grads_finite(optimizer, args, kwargs):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        checked.append((len(grads), all(
            bool(torch.isfinite(g).all()) for g in grads)))
    audio_s = sum(len(w) for w in batch["wavs"]) / 16000

    def refuse(*args, **kwargs):
        raise AssertionError("a plain attention twin ran on the card path")
    saved = flash_attention.attention_plain, \
        flash_attention.attention_backward_plain
    flash_attention.attention_plain = refuse
    flash_attention.attention_backward_plain = refuse
    hook = opt.register_step_pre_hook(grads_finite)
    try:
        losses = {}
        for name, dtype in (("f32", torch.float32), ("bf16", bf16)):
            gen = torch.Generator(device="cuda").manual_seed(3)
            m, _, _ = loop.micro_step(model, batch, "cuda", 1, 0.1, 3.0,
                                      dtype, generator=gen)
            losses[name] = float(m["loss"])
            opt.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            m, _, _ = loop.train_step(model, opt, batch, "cuda", 0.1, 3.0,
                                      compute_dtype=bf16, generator=gen)
            return m["loss"], m
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times, step_losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            step_losses.append(float(step()[0]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        bwd = dict(zip(BWD_ROUTES, route_counts()))
        fwd = dict(zip(FWD_ROUTES, fwd_counts()))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_step(step, what="one bf16 Whisper-base train step "
                            "(B = 8 × 30 s, Conformer 4 heads)", top=24)
    finally:
        hook.remove()
        flash_attention.attention_plain, \
            flash_attention.attention_backward_plain = saved
    want = {"wgmma64": 6 * 2, "wgmma128": 2 * 2, "mma64": 0, "mma128": 0}
    got = {r: bwd[r] for r in want}
    got_fwd = {r: fwd[r] for r in want}
    ok_grads = len(checked) == 3 and all(n > 0 and f for n, f in checked)
    finite = all(map(math.isfinite, list(losses.values()) + step_losses))
    kern = {(k, d): wgmma_launches(prof, k, d)
            for k in ("attn_wg_fwd", "attn_wg_dkdv") for d in (64, 128)}
    log(f"[whisper-train] phase 9f, bf16 (training.compute_dtype "
        f"bfloat16), Whisper-base at 4 Conformer heads, batch "
        f"{tuple(batch['audio'].shape)} ({audio_s:.1f} s of audio): loss "
        f"on the same batch and weights f32 {losses['f32']:.5f}, bf16 "
        f"{losses['bf16']:.5f} (gap {losses['bf16'] - losses['f32']:+.5f}, "
        f"no tolerance: phases 3d and 3e hold the kernels); 2 bf16 steps, "
        f"losses {[round(x, 5) for x in step_losses]}, step ms "
        f"{', '.join(f'{x:.1f}' for x in times)} (the first allocates the "
        f"optimizer state), {audio_s / times[-1] * 1e3:.2f} audio-s/s, peak "
        f"memory {peak:.2f} GiB; backward launches over the 2 steps {got}, "
        f"forwards {got_fwd}; (gradients, all finite) at each optimizer "
        f"step {checked}; profiled step busy {prof['busy_ms']:.2f} of "
        f"{prof['wall_ms']:.2f} ms (idle share {prof['idle']:.3f}), wgmma "
        f"kernels by head width {kern}")
    if got != want or got_fwd != want or not ok_grads or not finite:
        raise AssertionError(f"phase 9f: backward launches {got}, forwards "
                             f"{got_fwd} (want {want} over 2 steps), "
                             f"gradients {checked}, losses {losses} "
                             f"{step_losses}")
    if kern != {("attn_wg_fwd", 64): 6, ("attn_wg_fwd", 128): 2,
                ("attn_wg_dkdv", 64): 6, ("attn_wg_dkdv", 128): 2}:
        raise AssertionError(f"phase 9f: profiled wgmma kernels {kern}")
    del opt
    torch.cuda.empty_cache()
    return dict(step_ms=times[-1], audio_s_per_s=audio_s / times[-1] * 1e3,
                peak_gb=peak, losses=losses, busy_ms=prof["busy_ms"],
                wall_ms=prof["wall_ms"], idle=prof["idle"], counts=got)


LARGE_STEPS = 2         # phase 9c: the counted step, then a timed one


def phase_large_v3_train(labels: int) -> dict:
    """9c: the wide backward on a training path. The ``large-v3`` preset at
    full width (random weights from a seed; 128 mels, 32 layers of 1280, 20
    heads; the Conformer at the config's 2 heads, so head_dim 640; the
    encoder trained, ``freeze_encoder: false``), the default recipe in f32
    with TF32 off, takes LARGE_STEPS Prodigy steps through
    ``loop.train_step`` on one batch of B = 2 × 30 s. The launch counts are
    set to 0 just before the first step and read just after: 2 forwards
    and 2 backwards on the wide route of ``attention_wide.cu``, 32 of each
    on the bias-free D = 64 route, none elsewhere. Every gradient is
    finite when the optimizer steps (a step pre-hook), the losses are
    finite; the second step's ms and the peak memory are printed."""
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = train_config("/nonexistent", "whisper")
    raw["model"].update(whisper_model="openai/whisper-large-v3",
                        freeze_encoder=False)
    cfg = Config(raw)
    cfg.num_languages = 2
    arch = TaggerArch.from_config(cfg, labels)
    t0 = time.perf_counter()
    model = init_tagger(arch, torch.Generator().manual_seed(5), "cuda")
    opt = loop.make_optimizer(cfg, model.parameters())
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    checked = []

    def grads_finite(optimizer, args, kwargs):
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        checked.append((len(grads), all(
            bool(torch.isfinite(g).all()) for g in grads)))
    hook = opt.register_step_pre_hook(grads_finite)
    batch = train_batch(labels, 30.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts = [], [], None
    try:
        for i in range(LARGE_STEPS):
            if i == 0:
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            m, _, _ = loop.train_step(model, opt, batch, "cuda", 0.1, 3.0,
                                      generator=gen)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts = route_counts() + fwd_counts()
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # backward routes (BWD_ROUTES), forwards (FWD_ROUTES): the 2 Conformer
    # blocks on the wide route, the 32 Whisper layers on mma64
    want = [0, 0, 32, 2, 0, 0, 0, 0] * 2
    ok_grads = len(checked) == LARGE_STEPS and all(
        n > 0 and finite for n, finite in checked)
    log(f"[large-v3-train] f32 (TF32 off), Prodigy, B=2×30 s, encoder "
        f"trained, Conformer {arch.conformer_heads} heads (head_dim "
        f"{arch.hidden_size // arch.conformer_heads}); {n_params} "
        f"parameters, built in {init_s:.1f} s: losses "
        f"{[round(x, 4) for x in losses]}, (gradients, all finite) at each "
        f"step {checked}; step ms {', '.join(f'{x:.1f}' for x in times)} "
        f"(the first allocates the optimizer state), peak memory "
        f"{peak:.2f} GiB; launches of the first step: backward routes "
        f"{BWD_ROUTES} and forwards {FWD_ROUTES} {counts}")
    if counts != want or not ok_grads or not all(
            map(math.isfinite, losses)) or arch.conformer_heads != 2:
        raise AssertionError(f"large-v3 train step: launches {counts} (want "
                             f"{want}), gradients {checked}, losses "
                             f"{losses}")
    del model, opt
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=times[-1], peak_gb=peak,
                wide=counts[BWD_ROUTES.index("wide")])


# ---------------------------------------------------------------------------
# Phases 10a-10f: remat, remat auto, int8 serving, correct_label, optimizers
# ---------------------------------------------------------------------------

# 10a: a remat step against the plain one (the same model, Prodigy state,
# batch and generator state): loss relative, gradients × max|g|
REMAT_LOSS_TOL = 1e-6
REMAT_GRAD_TOL = 1e-5
# 10c: int8 serving against the bf16 session, the bounds of the JAX
# package's own test (tests/test_quantized_serving.py:98-102)
INT8_COSINE, INT8_AGREE, INT8_OFFSET = 0.99, 0.9, 0.1
# 10b: large-v3 rows of 30 s. B = 8 fits without remat (52.47 GiB); with
# Prodigy's state resident a plain step holds B = 13 (75.81 GiB) and not
# 14 when nothing else is on the card, 12 and not 13 after the earlier
# phases (on an H100 80GB HBM3 at 700 W), so the phase runs 14
REMAT_AUTO_B = 14
FLAGSHIP_LABELS = 73    # make_run's label count


def batch_rows(num_labels: int, seconds, seed: int) -> dict:
    """One training batch of len(seconds) rows: row i holds seconds[i] of
    noise, zero-padded to the longest, with −100-padded labels, offset
    targets of 50-200 ms segments and alternating language ids."""
    from wfl_asr_tpu_torch.train.losses import offset_targets_from_segments
    rng = np.random.RandomState(seed)
    s, frames = int(max(seconds) * 16000), int(round(max(seconds) / 0.02))
    audio = np.zeros((len(seconds), s), np.float32)
    labels = np.full((len(seconds), frames), -100, np.int64)
    segs_by_row = []
    for i, sec in enumerate(seconds):
        n = int(round(sec / 0.02))
        audio[i, :int(sec * 16000)] = rng.randn(int(sec * 16000)) * 0.1
        labels[i, :n] = rng.randint(0, num_labels, size=n)
        edges = np.concatenate([[0.0], np.cumsum(
            rng.uniform(0.05, 0.2, size=int(sec / 0.05) + 2))])
        segs_by_row.append([(float(a), float(b), "p1")
                            for a, b in zip(edges, edges[1:])
                            if b < n * 0.02])
    most = 2 * max(len(segs) for segs in segs_by_row)
    targets = [offset_targets_from_segments(segs, 0.02, int(round(
        sec / 0.02)), most) for segs, sec in zip(segs_by_row, seconds)]
    f, c, x, v = (np.stack([t[j] for t in targets]) for j in range(4))
    return {"audio": audio, "labels": labels,
            "lang_ids": (np.arange(len(seconds)) % 2).astype(np.int32),
            "off_frames": f, "off_channels": c, "off_fracs": x,
            "off_valid": v, "max_label_len": frames}


def phase_remat(root: str) -> dict:
    """10a: remat on WavLM-base-plus (the flagship tagger, random weights
    from a seed), f32 with TF32 off, the default recipe (Prodigy at lr 1,
    the preset's dropout and LayerDrop), one batch of B = 8 rows of 20-30
    s. From the same model and fresh Prodigy state, the same batch and the
    same generator state, one optimizer step without remat and one with,
    for the default dropout and again with strict attention dropout (K6
    seeds drawn inside the recomputed layers): the loss held to
    REMAT_LOSS_TOL relative, every gradient to REMAT_GRAD_TOL × max|g|
    (and whether they came out bit-identical); peak memory and the step's
    ms (forward and backward, then the update) for both; the launch counts
    set to 0 just before each step and read just after: 12 K2 forwards and
    12 K2b backwards without remat, 24 K2 forwards (12 + 12 recomputed)
    and 12 K2b with it."""
    import copy
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention
    from wfl_asr_tpu_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = train_config(root)
    raw["model"]["num_languages"] = 2
    cfg = Config(raw)
    arch = TaggerArch.from_config(cfg, FLAGSHIP_LABELS)
    base = init_tagger(arch, torch.Generator().manual_seed(4), "cuda")
    seconds = [20.0 + 10.0 * i / 7 for i in range(8)][::-1]
    batch = batch_rows(FLAGSHIP_LABELS, seconds, seed=11)
    start = torch.Generator(device="cuda").manual_seed(5).get_state()
    out = {}
    for strict in (False, True):
        runs = {}
        for remat in (False, True):
            model = copy.deepcopy(base)
            model.bilstm.flatten_parameters()
            set_strict(model, strict)
            opt = loop.make_optimizer(cfg, model.parameters())
            gen = torch.Generator(device="cuda")
            torch.cuda.empty_cache()
            # this mode's own warm-up (allocations, kernels), dropped
            gen.set_state(start)
            loop.micro_step(model, batch, "cuda", 1, 0.1, 3.0,
                            generator=gen, remat=remat)
            model.zero_grad(set_to_none=True)
            gen.set_state(start)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            m, _, _ = loop.micro_step(model, batch, "cuda", 1, 0.1, 3.0,
                                      generator=gen, remat=remat)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = dict(k2=flash_attention.launches,
                          k2b=flash_attention.bwd_launches,
                          k2_drop=flash_attention.dropout_launches)
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            loop.apply_update(opt)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            runs[remat] = dict(
                loss=float(m["loss"]), grads=grads, counts=counts,
                peak_gb=peak, fb_ms=(t1 - t0) * 1e3, update_ms=(t3 - t2) * 1e3,
                gen=gen.get_state())
            del model, opt
        plain, rem = runs[False], runs[True]
        loss_rel = abs(rem["loss"] - plain["loss"]) / abs(plain["loss"])
        gmax = max(float(g.abs().max()) for g in plain["grads"].values())
        grad_rel = max(float((rem["grads"][n] - g).abs().max())
                       for n, g in plain["grads"].items()) / gmax
        identical = loss_rel == 0.0 and all(
            torch.equal(rem["grads"][n], g)
            for n, g in plain["grads"].items())
        what = "strict attention dropout" if strict else "default dropout"
        log(f"[remat] phase 10a, WavLM-base-plus f32 (TF32 off), B=8 of "
            f"{seconds[-1]:.1f}-{seconds[0]:.1f} s, {what}: loss plain "
            f"{plain['loss']:.7f}, remat {rem['loss']:.7f} (rel "
            f"{loss_rel:.2e}); worst gradient diff {grad_rel:.2e} × max|g| "
            f"over {len(plain['grads'])} tensors; bit-identical "
            f"{identical}; generator end states equal "
            f"{torch.equal(plain['gen'], rem['gen'])}; peak memory "
            f"{plain['peak_gb']:.2f} → {rem['peak_gb']:.2f} GiB; forward + "
            f"backward {plain['fb_ms']:.1f} → {rem['fb_ms']:.1f} ms, update "
            f"{plain['update_ms']:.1f} / {rem['update_ms']:.1f} ms; "
            f"launches plain {plain['counts']}, remat {rem['counts']}")
        want_plain = dict(k2=12, k2b=12, k2_drop=12 if strict else 0)
        want_rem = dict(k2=24, k2b=12, k2_drop=24 if strict else 0)
        if (loss_rel > REMAT_LOSS_TOL or grad_rel > REMAT_GRAD_TOL
                or plain["counts"] != want_plain
                or rem["counts"] != want_rem
                or plain["grads"].keys() != rem["grads"].keys()
                or not torch.equal(plain["gen"], rem["gen"])):
            raise AssertionError(
                f"phase 10a ({what}): loss rel {loss_rel:.2e} (tol "
                f"{REMAT_LOSS_TOL}), gradients {grad_rel:.2e} × max (tol "
                f"{REMAT_GRAD_TOL}), launches {plain['counts']} / "
                f"{rem['counts']} (want {want_plain} / {want_rem})")
        out["strict" if strict else "default"] = dict(
            loss_rel=loss_rel, grad_rel=grad_rel, identical=identical,
            peak_gb=(plain["peak_gb"], rem["peak_gb"]),
            fb_ms=(plain["fb_ms"], rem["fb_ms"]),
            update_ms=(plain["update_ms"], rem["update_ms"]),
            counts=(plain["counts"], rem["counts"]))
    del base
    torch.cuda.empty_cache()
    return out


def phase_remat_deterministic(root: str) -> dict:
    """``--only remat-det``: phase 10a's remat pair once more with
    ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
    set before cuBLAS starts, in ``main``). An op without a deterministic
    CUDA implementation raises: its message is logged, and the pair runs
    again with ``warn_only=True``, every op that warns listed; then the
    gap between the two steps is logged as 10a logs it."""
    import warnings
    import torch
    raised = None
    torch.use_deterministic_algorithms(True)
    try:
        res = phase_remat(root)
        warned = []
    except RuntimeError as e:
        raised = str(e).splitlines()[0]
        log(f"[remat-det] deterministic mode raised: {raised}")
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = phase_remat(root)
        warned = sorted({str(w.message).splitlines()[0] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    for what, r in res.items():
        log(f"[remat-det] 10a {what} dropout, deterministic algorithms "
            f"(CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}"
            f"): loss rel {r['loss_rel']:.2e}, gradients {r['grad_rel']:.2e} "
            f"× max|g|, bit-identical {r['identical']}")
    for msg in warned:
        log(f"[remat-det] nondeterministic op: {msg}")
    return dict(res, raised=raised, warned=warned)


def phase_remat_auto(labels: int) -> dict:
    """10b: ``training.remat: auto`` on phase 9c's configuration (the
    ``large-v3`` preset at full width, 32 layers of 1280, the Conformer at
    the config's 2 heads so head_dim 640 on the wide route, the encoder
    trained, f32 with TF32 off) at B = REMAT_AUTO_B × 30 s, through the
    train loop's ``loop.RematStep("auto")``: the first step fits (Prodigy's
    state is allocated after its backward), the second's plain attempt
    must overflow the card and the step flip to remat, or the phase fails;
    one more step. The OOM's message, each step's ms, and the peak memory
    and launch counts (set to 0 just before it, read just after) on the
    wide and D = 64 routes of the step after the flip are printed. Then, with the optimizer state
    resident, plain forwards and backwards at B = 9, 10, ... up to the
    first that overflows: the smallest batch a plain step cannot hold."""
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = train_config("/nonexistent", "whisper")
    raw["model"].update(whisper_model="openai/whisper-large-v3",
                        freeze_encoder=False)
    raw["training"]["remat"] = "auto"
    cfg = Config(raw)
    cfg.num_languages = 2
    if loop.remat_mode(cfg) != "auto":
        raise AssertionError("training.remat: auto not read as auto")
    arch = TaggerArch.from_config(cfg, labels)
    model = init_tagger(arch, torch.Generator().manual_seed(5), "cuda")
    opt = loop.make_optimizer(cfg, model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    flips = []
    step = loop.RematStep(loop.remat_mode(cfg), model, gen,
                          on_flip=lambda: flips.append(time.perf_counter()))
    batch = batch_rows(labels, [30.0] * REMAT_AUTO_B, seed=13)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses, counts, flipped_at = [], [], None, None
    for i in range(3):
        if flipped_at is not None:      # the step after the flip
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, _ = step(opt, [batch], "cuda", label_smoothing=0.1,
                          subframe_weight=3.0)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if flipped_at is not None:
            counts = dict(bwd=dict(zip(BWD_ROUTES, route_counts())),
                          fwd=dict(zip(FWD_ROUTES, fwd_counts())))
            break
        if flips:
            flipped_at = i + 1
    if counts is None:
        raise AssertionError(f"phase 10b: no flip in 2 steps at B="
                             f"{REMAT_AUTO_B} (step ms {times})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    oom = step.oom.splitlines()[0] if step.oom else None
    # the smallest batch whose plain forward and backward overflow, with
    # the optimizer state resident (every step after the first)
    held, first_oom = [], None
    for rows in range(9, REMAT_AUTO_B + 3):
        probe = batch_rows(labels, [30.0] * rows, seed=13)
        torch.cuda.reset_peak_memory_stats()
        try:
            loop.micro_step(model, probe, "cuda", 1, 0.1, 3.0, generator=gen)
            torch.cuda.synchronize()
            failed = False
        except torch.cuda.OutOfMemoryError:
            failed = True
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        if failed:
            first_oom = rows
            break
        held.append((rows, round(torch.cuda.max_memory_allocated()
                                 / 2 ** 30, 2)))
    log(f"[remat-auto] phase 10b, large-v3 f32 (TF32 off), B="
        f"{REMAT_AUTO_B}×30 s, encoder trained, Conformer "
        f"{arch.conformer_heads} heads (head_dim "
        f"{arch.hidden_size // arch.conformer_heads}), training.remat auto: "
        f"flipped {bool(flips)} ({len(flips)} flip), remat now "
        f"{step.remat}, at step {flipped_at} (the first step allocates "
        f"Prodigy's state after its backward); the OOM as CUDA reported "
        f"it: {oom!r}; step ms {', '.join(f'{x:.1f}' for x in times)} "
        f"(the flip's holds the failed plain attempt), losses "
        f"{[round(x, 4) for x in losses]}; the step after the flip: peak "
        f"memory {peak:.2f} GiB, launches: forwards {counts['fwd']}, "
        f"backwards {counts['bwd']}; plain forward + backward with the "
        f"optimizer state resident: held (B, peak GiB) {held}, first "
        f"overflow at B = {first_oom}")
    want_fwd = {"wide": 2, "mma64": 64}
    want_bwd = {"wide": 2, "mma64": 32}
    got_fwd = {k: v for k, v in counts["fwd"].items() if v}
    got_bwd = {k: v for k, v in counts["bwd"].items() if v}
    if (len(flips) != 1 or not step.remat or got_fwd != want_fwd
            or got_bwd != want_bwd or not all(map(math.isfinite, losses))
            or first_oom is None):
        raise AssertionError(
            f"phase 10b: flips {len(flips)}, remat {step.remat}, forwards "
            f"{got_fwd} (want {want_fwd}), backwards {got_bwd} (want "
            f"{want_bwd}), losses {losses}, first plain overflow at "
            f"{first_oom}")
    del model, opt, step
    torch.cuda.empty_cache()
    return dict(flipped=True, flipped_at=flipped_at, oom=oom,
                step_ms=times[-1], times=times, peak_gb=peak, counts=counts,
                held=held, first_oom=first_oom)


def phase_int8(cfg, ckpt: str, iters: int) -> dict:
    """10c: ``model.serving_quantization: int8`` on phase 4's
    WavLM-base-plus checkpoint: the bf16 session and the int8 session (its
    encoder's 73 large linears — 6 a layer and the feature projection —
    W8A8-dynamic, ``torch._int_mm``) at B = 8 ×
    30 s, the batched forward with gate and median timed in turns (bf16,
    int8, int8, bf16) with peak memory; the int8 forward's K5/K2/K1
    launches (set to 0 just before it, read just after); its logits held
    to the JAX test's bounds against the bf16 session's on the same rows
    (cosine > INT8_COSINE, frame agreement > INT8_AGREE, offsets max|diff|
    < INT8_OFFSET); one quantized linear's int32 accumulator on the card
    equal to the CPU's on the same int8 inputs, at 1499 rows and at 5
    (padded to the product's 17)."""
    import copy
    import torch
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.infer.pipeline import _get_session
    from wfl_asr_tpu_torch.models import layers
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import conv_fused, flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.ops.postprocess import confidence_gate_ids, \
        median_filter_ids
    raw = copy.deepcopy(cfg.raw)
    raw["model"]["serving_quantization"] = "int8"
    bf16 = torch.bfloat16
    sessions = {"bf16": _get_session(cfg, ckpt, "cuda", bf16),
                "int8": _get_session(Config(raw), ckpt, "cuda", bf16)}
    q = sessions["int8"]
    if len(q.quantized) != 73 or sessions["bf16"].quantized:
        raise AssertionError(f"int8 session quantized {len(q.quantized)} "
                             f"linears (want 73: 6 in each of 12 layers "
                             f"and the feature projection)")
    samples = 30 * 16000
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(B, samples) * 0.1).astype(
        np.float32)).to("cuda")
    lang = torch.zeros(B, dtype=torch.int64, device="cuda")

    def forward(session):
        t = session.num_frames_for(samples)
        with torch.inference_mode():
            return session.model(audio, lang, compute_dtype=bf16,
                                 pos_bias=session._pos_bias_for(t))

    def step(session):
        logits, offsets = forward(session)
        return median_filter_ids(confidence_gate_ids(logits, 0.5, 0), 3)

    forward(q)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    forward(q)
    torch.cuda.synchronize()
    counts = {"K5 layers": conv_fused.layer_launches,
              "K2": flash_attention.launches,
              "K1": flash_attention_bwd.launches}
    perf = {"bf16": [], "int8": []}
    peaks = {}
    for name in ("bf16", "int8", "int8", "bf16"):
        s = sessions[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(s).cpu()
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        outs = [step(s) for _ in range(iters)]
        for o in outs:
            o.cpu()
        del outs
        perf[name].append(B * 30.0 * iters / (time.perf_counter() - t0))
    lg_b, off_b = (x.float() for x in forward(sessions["bf16"]))
    lg_q, off_q = (x.float() for x in forward(q))
    cosine = float((lg_b * lg_q).sum() / (lg_b.norm() * lg_q.norm()))
    agree = float((lg_b.argmax(-1) == lg_q.argmax(-1)).float().mean())
    off_diff = float((off_b - off_q).abs().max())
    mod = q.model.encoder.encoder.layers[0].attention.q_proj
    acc_ok = {}
    for rows in (1499, 5):
        x_q = torch.randint(-127, 128, (rows, mod.in_features),
                            generator=torch.Generator().manual_seed(rows),
                            dtype=torch.int8)
        acc_ok[rows] = torch.equal(
            layers.int8_matmul(x_q.cuda(), mod.w_q).cpu(),
            layers.int8_matmul(x_q, mod.w_q.cpu()))
    log(f"[int8] phase 10c, WavLM-base-plus bf16 serving, B={B}×30 s, "
        f"batched forward + gate + median, {iters} steps a turn: bf16 "
        f"{', '.join(f'{x:.2f}' for x in perf['bf16'])} audio-s/s, int8 "
        f"{', '.join(f'{x:.2f}' for x in perf['int8'])} (turns bf16, int8, "
        f"int8, bf16); peak memory of a step bf16 {peaks['bf16']:.3f}, "
        f"int8 {peaks['int8']:.3f} GiB; {len(q.quantized)} linears "
        f"quantized; an int8 forward's launches {counts}; int8 against bf16 "
        f"logits cosine {cosine:.6f} (> {INT8_COSINE}), frame agreement "
        f"{agree:.4f} (> {INT8_AGREE}), offsets max|diff| {off_diff:.4f} "
        f"(< {INT8_OFFSET}); int32 accumulator card == CPU at rows "
        f"{acc_ok}")
    if (cosine <= INT8_COSINE or agree <= INT8_AGREE
            or off_diff >= INT8_OFFSET or not all(acc_ok.values())
            or counts != {"K5 layers": 6, "K2": 12, "K1": 2}):
        raise AssertionError(f"phase 10c: cosine {cosine}, agreement "
                             f"{agree}, offsets {off_diff}, accumulators "
                             f"{acc_ok}, launches {counts}")
    return dict(perf=perf, peaks=peaks, cosine=cosine, agree=agree,
                off_diff=off_diff, counts=counts)


def phase_correct_label(root: str) -> dict:
    """10d: ``python -m wfl_asr_tpu_torch.correct_label FOLDER`` in a
    subprocess on 8 generated 30 s wavs (tone and noise segments) with
    ``.lab`` files whose boundaries sit up to 40 ms off the transitions;
    the corrected files must equal those of the port's ``process_file``
    called in this process on a copy, and the boundary caches be gone."""
    from wfl_asr_tpu_torch import correct_label
    from wfl_asr_tpu_torch.data.audio import write_wav
    cli, here = os.path.join(root, "cl_cli"), os.path.join(root, "cl_here")
    for d in (cli, here):
        os.makedirs(d)
    rng = np.random.RandomState(21)
    n_lines = 0
    for i in range(8):
        n = 30 * 16000
        y = np.zeros(n)
        t, lines = 0.0, []
        while t < 29.9:
            dur = min(rng.uniform(0.08, 0.45), 30.0 - t)
            a, b = int(t * 16000), int((t + dur) * 16000)
            kind = rng.randint(3)
            if kind == 0:
                y[a:b] = 0.5 * np.sin(2 * np.pi * rng.uniform(150, 900)
                                      * np.arange(b - a) / 16000)
            elif kind == 1:
                y[a:b] = 0.2 * rng.randn(b - a)
            end = t + dur + (rng.uniform(-0.04, 0.04) if t + dur < 29.9
                             else 0.0)
            start = lines[-1][1] if lines else 0.0
            lines.append((start, max(end, start + 0.01), ["SP", "a", "k"][
                kind]))
            t += dur
        n_lines += len(lines)
        for d in (cli, here):
            write_wav(os.path.join(d, f"u{i}.wav"), y, 16000)
            with open(os.path.join(d, f"u{i}.lab"), "w") as f:
                f.writelines(f"{int(s * 1e7)} {int(e * 1e7)} {lab}\n"
                             for s, e, lab in lines)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wfl_asr_tpu_torch.correct_label", cli],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"correct_label CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        for i in range(8):
            correct_label.process_file(os.path.join(here, f"u{i}.wav"))
    here_s = time.perf_counter() - t0
    same = [open(os.path.join(cli, f"u{i}.lab"), "rb").read()
            == open(os.path.join(here, f"u{i}.lab"), "rb").read()
            for i in range(8)]
    left = sorted(set(os.listdir(cli)) ^ set(os.listdir(here)))
    last = proc.stdout.strip().splitlines()[-1]
    log(f"[correct_label] phase 10d: 8 wavs of 30 s, {n_lines} .lab lines; "
        f"the CLI in a subprocess in {cli_s:.2f} s (its last line "
        f"{last!r}), process_file in this process in {here_s:.2f} s; "
        f"files equal {sum(same)}/8, files differing between the folders "
        f"{left}")
    if not all(same) or left or last != (
            "Label correction complete. All files processed."):
        raise AssertionError(f"phase 10d: equal {same}, extra files {left}")
    return dict(cli_s=cli_s, same=sum(same))


# Phase 10e: every optimizer name, card against CPU. The card and the CPU
# run the same f32 formulas on the same gradients; they differ by the
# rounding of their kernels (CUDA's rsqrt and division, fused multiply-adds)
# and by the order of their reductions. Each parameter tensor is held to
# OPT_REL[family] × the largest 3-step change of that tensor on the CPU plus
# OPT_ULPS ulps of its largest entry (the final p + u rounds once more):
# - "elementwise" (the moment family and SGD): a few ulps of each update,
#   1e-5 of its size leaves ~100× room;
# - "per-leaf" (lamb, lars, fromage, novograd, adafactor, sm3): the leaf's
#   norms and means summed in another order scale the whole leaf's update,
#   ~log2(n) · 2^-24 relative, 1e-4;
# - "global" (Prodigy, dadaptadamw): d is a ratio of sums over all 95M
#   elements, ~1e-6 relative a step, fed back each step, 1e-4.
# Prodigy's and dadaptadamw's d itself is held to OPT_D_REL: it is a ratio
# of sums over all parameters, each summed in another order on each side
# (~1e-6 relative), fed back each step. (torch's CPU norm kernels sum in
# long f32 chains, 4e-5 off at 2.4M elements, which put d 2e-4 away from
# the card's; train/norms.py's leaf_norms sums as accurately as the card.)
# Sign-based or thresholded updates (lion's sign, rprop's sign products,
# adopt's clip, yogi's sign(v − g²)) flip where their input lies within
# rounding of the threshold: an element beyond the tolerance counts as a
# flip there, and more than OPT_MAX_FLIPS flips in a name fails; anywhere
# else one element beyond it fails.
OPT_STEPS = 3
OPT_PROFILED = 2        # steps in the profiler's window, after 2 unrecorded
OPT_LR = {"prodigy": 1.0, "dadaptadamw": 1.0, "adadelta": 1.0}
OPT_REL = {"elementwise": 1e-5, "per-leaf": 1e-4, "global": 1e-4}
OPT_FAMILY = dict(
    {n: "per-leaf" for n in ("lamb", "lars", "fromage", "novograd",
                             "adafactor", "sm3")},
    prodigy="global", dadaptadamw="global")
OPT_D_REL = 1e-4
OPT_FLIPS = ("lion", "rprop", "adopt", "yogi")
OPT_MAX_FLIPS = 16
OPT_ULPS = 2


def _state_bytes(state) -> int:
    import torch
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(_state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(_state_bytes(v) for v in state)
    return 0


def phase_optimizers(root: str, labels: int) -> dict:
    """10e: one f32 ``micro_step`` of the full-width WavLM-base-plus tagger
    (B = 2 × 30 s, TF32 off) gives one set of gradients; for Prodigy and
    each of the 26 optax names (``train/optimizers.py``), from the same
    weights and on those gradients, ``OPT_STEPS`` steps on the card and the
    same steps on the CPU from copies, the lr halved before the last step;
    the parameters held card against CPU under the rules above (and
    Prodigy's and dadaptadamw's d to OPT_D_REL). For each name: the
    last step's wall ms on the card, the kernels and summed device ms a
    step of OPT_PROFILED more steps profiled, and the optimizer state's
    bytes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.train import loop
    from wfl_asr_tpu_torch.train.optimizers import OPTIMIZERS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = train_config(root)
    raw["model"]["num_languages"] = 2
    arch = TaggerArch.from_config(Config(raw), labels)
    model = init_tagger(arch, torch.Generator().manual_seed(6), "cuda")
    batch = batch_rows(labels, [30.0, 30.0], seed=13)
    loop.micro_step(model, batch, "cuda", 1, 0.1, 3.0,
                    generator=torch.Generator(device="cuda").manual_seed(7))
    by_param = model.jax_leaf_blocks()
    blocks = {n: by_param[p] for n, p in model.named_parameters()
              if p in by_param}
    dev = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    host = ({n: t.cpu() for n, t in dev.items()},
            {n: t.cpu() for n, t in grads.items()})
    n_elems = sum(t.numel() for t in dev.values())
    del model
    torch.cuda.empty_cache()
    log(f"[optim] phase 10e: WavLM-base-plus tagger, {len(dev)} tensors, "
        f"{n_elems} parameters, {len(grads)} with a gradient (B = 2 × 30 s, "
        f"f32); {OPT_STEPS} steps from the same weights, lr halved before "
        f"the last")

    out = {}
    for name in ["Prodigy"] + sorted(OPTIMIZERS):
        key = name.lower()
        lr = OPT_LR.get(key, 1e-3)
        t = dict(raw["training"], optimizer=name, learning_rate=lr)
        cfg = Config(dict(raw, training=t))
        runs = {}
        for where, (weights, g) in (("cuda", (dev, grads)), ("cpu", host)):
            params = {n: torch.nn.Parameter(w.clone())
                      for n, w in weights.items()}
            opt = loop.make_optimizer(
                cfg, list(params.values()),
                {params[n]: b for n, b in blocks.items()})
            for n, p in params.items():
                p.grad = g.get(n)
            for i in range(OPT_STEPS):
                if i == OPT_STEPS - 1:
                    loop.set_lr(opt, lr / 2)
                if where == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt.step()
                if where == "cuda":
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            glob = {k: float(v) for k, v in getattr(
                opt, "global_state", lambda: {})().items()
                if k in ("d", "estim_lr")}
            runs[where] = dict(params={n: p.detach().cpu()
                                       for n, p in params.items()},
                               glob=glob, wall_ms=wall_ms)
            if where == "cuda":
                # a step before the window and a warm-up step: a window that
                # opens on the step it records can lose its first ~30
                # kernels (0 read for sgd's step)
                with profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=1, warmup=1,
                                               active=OPT_PROFILED,
                                               repeat=1)) as prof:
                    for _ in range(2 + OPT_PROFILED):
                        opt.step()
                        torch.cuda.synchronize()
                        prof.step()
                kern = [e for e in prof.events()
                        if e.device_type == DeviceType.CUDA]
                runs[where].update(
                    launches=len(kern) / OPT_PROFILED,
                    busy_ms=sum(e.time_range.elapsed_us()
                                for e in kern) / 1e3 / OPT_PROFILED,
                    state_bytes=_state_bytes(list(opt.state.values())))
            del params, opt
        family = OPT_FAMILY.get(key, "elementwise")
        flips, worst, moved = 0, 0.0, 0.0
        for n, w0 in host[0].items():
            a, b = runs["cuda"]["params"][n], runs["cpu"]["params"][n]
            change = float((b - w0).abs().max())
            moved = max(moved, change)
            tol = (OPT_REL[family] * change
                   + OPT_ULPS * 2.0 ** -23 * float(w0.abs().max()))
            err = (a - b).abs()
            flips += int((err > tol).sum())
            worst = max(worst, float(err.max()) / max(change, 1e-30))
        d_rel = {k: abs(runs["cuda"]["glob"][k] - v) / abs(v)
                 for k, v in runs["cpu"]["glob"].items()}
        c = runs["cuda"]
        out[name] = dict(family=family, flips=flips, worst=worst,
                         moved=moved, d_rel=d_rel, wall_ms=c["wall_ms"],
                         busy_ms=c["busy_ms"], launches=c["launches"],
                         state_mib=c["state_bytes"] / 2 ** 20,
                         cpu_ms=runs["cpu"]["wall_ms"])
        log(f"[optim] {name} ({family}, lr {lr:g} → {lr / 2:g}): card vs "
            f"CPU worst {worst:.2e} × the tensor's change (tol "
            f"{OPT_REL[family]:g} + {OPT_ULPS} ulps), {flips} elements "
            f"beyond it, largest change {moved:.3e}"
            + (f", d rel {d_rel}" if d_rel else "")
            + f"; card step {c['wall_ms']:.2f} ms wall, a profiled step "
            f"{c['launches']:g} kernels, {c['busy_ms']:.2f} ms device busy; "
            f"state {c['state_bytes'] / 2 ** 20:.1f} MiB; CPU step "
            f"{runs['cpu']['wall_ms']:.0f} ms")
        if (moved == 0.0 or any(r > OPT_D_REL for r in d_rel.values())
                or flips > (OPT_MAX_FLIPS if key in OPT_FLIPS else 0)):
            raise AssertionError(
                f"phase 10e {name}: {flips} elements beyond the tolerance "
                f"(allowed {OPT_MAX_FLIPS if key in OPT_FLIPS else 0}), "
                f"largest change {moved}, d rel {d_rel}")
    return out


OPT_TRAIN = (("AdamW", 1e-3), ("Lamb", 1e-3), ("Adafactor", 1e-2))


def phase_train_optimizers(root: str) -> dict:
    """10f: ``loop.train`` on phase 6's corpus (written here when phase 6
    did not run) with ``AdamW``, ``Lamb`` and ``Adafactor`` in the config's
    spelling: the default recipe otherwise (f32, batch 8), 2 steps,
    validation after the last. Each: finite losses, ``last_model.pt``
    reloaded to the same weights and logits. The Lamb run under
    ``WFL_PROFILE_DIR``: its ``torch.profiler`` trace must exist and name
    the port's attention kernels (``attn_bias_fwd_mma``, the K1/K2
    forward). With tensorboardX and matplotlib on the machine the
    validation figures' events must be in the event file; without them a
    line says which is absent."""
    import torch
    from wfl_asr_tpu_torch.checkpoint import load_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.labels import load_phoneme_list
    from wfl_asr_tpu_torch.models.tagger import TaggerArch
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    if not os.path.isdir(os.path.join(root, "data")):
        write_corpus(os.path.join(root, "data"))
    absent = []
    for module in ("tensorboardX", "matplotlib"):
        try:
            __import__(module)
        except ImportError:
            absent.append(module)
    if absent:
        log(f"[optim] phase 10f: {' and '.join(absent)} absent on this "
            f"machine: validation figures are not drawn, not checked")
    g = torch.Generator().manual_seed(8)
    audio = (torch.randn(2, 16000 * 12, generator=g) * 0.1).cuda()
    lang = torch.tensor([0, 1], device="cuda")
    out = {}
    for name, lr in OPT_TRAIN:
        raw = train_config(root)
        save = os.path.join(root, f"run_{name.lower()}")
        raw["output"]["save_dir"] = save
        raw["training"].update(optimizer=name, learning_rate=lr,
                               max_steps=2, val_check_interval=2,
                               log_dir=os.path.join(save, "logs"))
        preprocess(raw["data"]["data_dir"], raw)
        cfg = Config.load(os.path.join(save, "config.yaml"))
        prof_dir = os.path.join(root, "profile_lamb")
        if name == "Lamb":
            os.environ["WFL_PROFILE_DIR"] = prof_dir
        t0 = time.perf_counter()
        try:
            model = loop.train(cfg, device="cuda")
        finally:
            os.environ.pop("WFL_PROFILE_DIR", None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e["loss"] for e in events if e["event"] == "train"]
        vals = [e["loss"] for e in events if e["event"] == "val"]
        arch = TaggerArch.from_config(
            cfg, len(load_phoneme_list(os.path.join(save, "phonemes.txt"))))
        last = load_model_checkpoint(os.path.join(save, "last_model.pt"),
                                     arch, "cuda")
        mem = model.state_dict()
        same_weights = all(torch.equal(v, mem[k])
                           for k, v in last.state_dict().items())
        model.eval()
        with torch.no_grad():
            a, b = model(audio, lang)[0], last(audio, lang)[0]
        diff = (a - b).abs().max().item()
        line = (f"[optim] phase 10f {name} (lr {lr:g}): loop.train 2 steps "
                f"+ validation in {wall:.1f} s, losses "
                f"{[round(x, 4) for x in losses]}, val {vals}; "
                f"last_model.pt weights equal {same_weights}, logits diff "
                f"{diff:.2e} of max {a.abs().max().item():.3g}")
        if name == "Lamb":
            from wfl_asr_tpu_torch.utils.profiling import TRACE_FILE
            trace = os.path.join(prof_dir, "train", TRACE_FILE)
            with open(trace) as f:
                text = f.read()
            named = text.count("attn_bias_fwd_mma")
            line += (f"; trace {os.path.getsize(trace) / 2 ** 20:.1f} MiB, "
                     f"{named} attn_bias_fwd_mma events")
            if not named:
                raise AssertionError(f"phase 10f: {trace} names no "
                                     f"attn_bias_fwd_mma")
        if not absent:
            blob = b"".join(open(os.path.join(cfg.log_dir, f), "rb").read()
                            for f in os.listdir(cfg.log_dir)
                            if f.startswith("events."))
            figures = blob.count(b"val/prediction_")
            line += f"; {figures} figure events"
            if not figures:
                raise AssertionError(f"phase 10f {name}: no figure events "
                                     f"in {cfg.log_dir}")
        log(line)
        if (len(losses) != 2 or len(vals) != 1
                or not all(map(math.isfinite, losses + vals))
                or not same_weights or diff > 1e-5 * a.abs().max().item()):
            raise AssertionError(f"phase 10f {name}: losses {losses}, val "
                                 f"{vals}, weights equal {same_weights}, "
                                 f"logits diff {diff}")
        out[name] = dict(wall_s=wall, losses=losses)
        del model, last
        torch.cuda.empty_cache()
    return out


def module_phases(root: str, cfg, ckpt: str, labels: int,
                  iters: int) -> dict:
    """Phases 10a-10f under ``root``; ``cfg``/``ckpt``: phase 4's
    WavLM-base-plus run."""
    with lap("10a"):
        remat = phase_remat(root)
    with lap("10b"):
        auto = phase_remat_auto(labels)
    with lap("10c"):
        int8 = phase_int8(cfg, ckpt, iters)
    with lap("10d"):
        cl = phase_correct_label(root)
    with lap("10e"):
        optim = phase_optimizers(root, labels)
    with lap("10f"):
        optim_train = phase_train_optimizers(root)
    return dict(remat=remat, auto=auto, int8=int8, cl=cl, optim=optim,
                optim_train=optim_train)


def whisper_phases(root: str, iters: int) -> dict:
    """Phases 8-8d and 9-9f under ``root``."""
    with lap("8"):
        serving = phase_whisper_serving(root, iters)
    with lap("8b"):
        cross = phase_whisper_cross_device(root, serving)
    with lap("8c"):
        serving4 = serve_whisper_base(root, iters, default_heads=True)
    with lap("8d"):
        serving4["cross"] = phase_cross_device(
            serving4["cfg"], serving4["ckpt"], serving4["wav_dir"],
            "Whisper-base, 4 Conformer heads")
    with lap("9"):
        trained = phase_whisper_train(root)
    with lap("9b"):
        cross_train = phase_train_cross_device(trained["labels"],
                                               encoder="whisper")
    with lap("9c"):
        large = phase_large_v3_train(trained["labels"])
    with lap("9d"):
        trained4 = phase_whisper_train(root, default_heads=True)
    with lap("9f"):
        bf16_train = phase_whisper_bf16_train(trained4)
    for key in ("model", "batch", "cfg"):
        trained4.pop(key)
    with lap("9e"):
        cross_train4 = phase_train_cross_device(
            trained4["labels"], encoder="whisper", default_heads=True)
    return dict(serving=serving, cross=cross, trained=trained,
                cross_train=cross_train, large=large, serving4=serving4,
                trained4=trained4, cross_train4=cross_train4,
                bf16_train=bf16_train)


# ---------------------------------------------------------------------------

KERNEL_ROWS = [
    # (result key, dtype, name, counter name, source, TPU kernel replaced).
    # The inference kernels report their bf16 case (the served path's
    # dtype), the backward kernels their f32 case (the default training
    # dtype) and, on the bf16 training path (phase 9f), their bf16 case;
    # each its launches on its own main path: inference (phase 4),
    # training (phase 6), or the Whisper paths (phases 8, 8c, 9, 9c, 9d
    # and 9f).
    ("K2", "bf16", "flash_attention", "flash_attention",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_fwd_bias_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention.py:75"),
    ("K1", "bf16", "flash_attention_trainable", "flash_attention_trainable",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_fwd_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    ("K5a", "bf16", "fused_conv_chain[1-3]", "fused_conv_chain[1-3]",
     "wfl_asr_tpu_torch/ops/kernels/csrc/conv_fused.cu",
     "wfl_asr_tpu/ops/pallas/conv_fused.py:135"),
    ("K5b", "bf16", "fused_conv_chain[4-6]", "fused_conv_chain[4-6]",
     "wfl_asr_tpu_torch/ops/kernels/csrc/conv_fused.cu",
     "wfl_asr_tpu/ops/pallas/conv_fused.py:135"),
    ("K2b", "f32", "flash_attention_bwd", "flash_attention_bwd",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_bwd_bias_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention.py:262"),
    ("K1b", "f32", "flash_attention_trainable_bwd",
     "flash_attention_trainable_bwd",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_bwd_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:106"),
    # K1 and K1b at Whisper-base's layers (bias-free, D = 64): in f32 the
    # bias-free instantiations of the D = 64 forward and passes (route
    # mma64, phase 9), in bf16 the wgmma forward and dK/dV pass of
    # attention_wgmma.cu (route wgmma64, phases 8 and 9f)
    ("K1w", "f32", "flash_attention_trainable [Whisper, D=64, bias-free "
     "f32 mma64]", "whisper K1 f32",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_fwd_bias_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    ("K1bw", "f32", "flash_attention_trainable_bwd [Whisper, D=64, "
     "bias-free f32 mma64]", "whisper K1b",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_bwd_bias_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:106"),
    ("K1w", "bf16", "flash_attention_trainable [Whisper, D=64, bias-free "
     "bf16 wgmma64]", "whisper K1 bf16",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_wgmma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    ("K1bw", "bf16", "flash_attention_trainable_bwd [Whisper, D=64, "
     "bias-free bf16 wgmma64: pre-pass and dK/dV of attention_wgmma.cu, "
     "dQ of attention_bwd_bias_mma.cu]", "whisper K1b bf16",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_wgmma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:106"),
    # K1 above head_dim 512: the wide forward, launched by the large-v3
    # forward of phase 8 (its Conformer at head_dim 640)
    ("K1wide", "bf16", "flash_attention_trainable [large-v3 Conformer, "
     "D=640, wide]", "wide K1",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_wide.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    # K1b above head_dim 512: the wide dK/dV and dQ passes, launched by the
    # large-v3 train step of phase 9c
    ("K1bwide", "f32", "flash_attention_trainable_bwd [large-v3 Conformer, "
     "D=640, wide]", "wide K1b",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_wide.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:106"),
    # K1 and K1b at head_dim 80-128, bias-free, launched by Whisper-base at
    # the schema's 4 Conformer heads: in f32 the D = 128 instantiations
    # (route mma128, phase 9d), in bf16 the wgmma kernels at D = 128
    # (route wgmma128, phases 8c and 9f)
    ("K1128", "f32", "flash_attention_trainable [Whisper-base Conformer "
     "at 4 heads, D=128, bias-free f32 mma128]", "mma128 K1",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_fwd_bias_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    ("K1b128", "f32", "flash_attention_trainable_bwd [Whisper-base "
     "Conformer at 4 heads, D=128, bias-free f32 mma128]", "mma128 K1b",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_bwd_bias_mma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:106"),
    ("K1128", "bf16", "flash_attention_trainable [Whisper-base Conformer "
     "at 4 heads, D=128, bias-free bf16 wgmma128]", "wgmma128 K1",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_wgmma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    ("K1b128", "bf16", "flash_attention_trainable_bwd [Whisper-base "
     "Conformer at 4 heads, D=128, bias-free bf16 wgmma128]",
     "wgmma128 K1b",
     "wfl_asr_tpu_torch/ops/kernels/csrc/attention_wgmma.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:106"),
]


# ---------------------------------------------------------------------------
# Phase 11: data, fully-sharded, tensor and sequence parallelism
# ---------------------------------------------------------------------------

PAR_RATE = 0.1          # strict dropout rate of 11a
PAR_STEPS = 2           # train steps of each 11b world
PAR_LAYERS = 4          # WavLM-base-plus cut to 4 of its 12 layers in 11b
PP_LAYERS = 4           # and in 11d's pipeline (2 layers a stage)
PP_MICRO = 4            # 11d's pp_microbatches
PP_TIMEOUT_S = 300      # 11d's world, start to end


def _par_mask_bits(d: int, h: int, dtype, with_bias: bool, kv) -> int:
    """The kept pattern of each (batch half, head half) shard's forward,
    called through the entry point with its origin, read off with q = k = 0
    and v the identity on D keys at a time (3d's way), against the plain
    mask at the shard's global indices (``dropout_mask.keep_mask``, not
    the seed offset under test). Returns the number of bits off."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import dropout_mask as dm
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    dev, b = "cuda", B
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    bad = 0
    for b0 in (0, b // 2):
        for h0 in (0, h // 2):
            nb, nh = b // 2, h // 2
            q = torch.zeros((nb, nh, T, d), dtype=dtype, device=dev)
            bias = gate = None
            if with_bias:
                bias = torch.zeros((nh, T, T), dtype=dtype, device=dev)
                gate = torch.ones((nb, nh, T), device=dev)
            kvs = kv[b0:b0 + nb]
            kept = torch.zeros((nb, nh, T, T), dtype=torch.bool, device=dev)
            for j0 in range(0, T, d):
                w = min(d, T - j0)
                v = torch.zeros_like(q)
                v[..., j0:j0 + w, :w] = torch.eye(w, dtype=dtype, device=dev)
                with torch.inference_mode():
                    if with_bias:
                        out = fa.flash_attention(
                            q, q, v, bias, gate, kv_len=kvs,
                            dropout_rate=PAR_RATE, dropout_seed=seed,
                            origin=(b0, h0))
                    else:
                        out = flash_attention_trainable(
                            q, q, v, kv_len=kvs, dropout_rate=PAR_RATE,
                            dropout_seed=seed, origin=(b0, h0))
                kept[..., j0:j0 + w] = out[..., :w].float() > 0
            ar = lambda n, o=0: torch.arange(o, o + n, device=dev)  # noqa
            want = dm.keep_mask(seed.reshape(()), ar(nb, b0)[:, None, None,
                                                              None],
                                ar(nh, h0)[None, :, None, None],
                                ar(T)[:, None], ar(T)[None, :],
                                PAR_RATE) > 0
            want &= (ar(T)[None, :] < kvs[:, None])[:, None, None, :]
            bad += int((kept != want).sum().item())
            del kept, want
    torch.cuda.empty_cache()
    return bad


def _par_case(name, gen, h, d, dtype_name, with_bias, kv) -> dict:
    """11a, one shape: the unsharded call through the entry point (strict
    dropout at PAR_RATE, ragged kv_len) against its four shards — the
    batch and the heads each split in two — each called with its slices of
    q, k, v, bias and gate and its origin: out, LSE, dQ, dK, dV against
    the unsharded slices, dGate too, and dBias summed over the batch
    halves; the worst differences as fractions of each tensor's max, held
    to the kernel's tolerances (ATTN_TOL, LSE_TOL, GRAD_TOL)."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    b = B
    t = 1500 if (not with_bias and d == 64) else T
    q, k, v, bias, gate = attn_inputs(gen, (b, h, t, d), dtype, with_bias)
    dout = (torch.rand(q.shape, generator=gen, device="cuda") * 2 - 1
            ).to(dtype)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device="cuda")

    def call(rows, heads, origin):
        ins = [x[rows][:, heads].detach().clone().requires_grad_()
               for x in (q, k, v)]
        bg = [None, None]
        if with_bias:
            bg = [bias[heads].detach().clone().requires_grad_(),
                  gate[rows][:, heads].detach().clone().requires_grad_()]
            out = fa.flash_attention(*ins, *bg, kv_len=kv[rows],
                                     dropout_rate=PAR_RATE,
                                     dropout_seed=seed, origin=origin)
        else:
            out = flash_attention_trainable(*ins, kv_len=kv[rows],
                                            dropout_rate=PAR_RATE,
                                            dropout_seed=seed, origin=origin)
        out.backward(dout[rows][:, heads])
        with torch.no_grad():
            _, lse = fa.launch_kernel(
                *(x.detach() for x in ins), *(y.detach() if y is not None
                                              else None for y in bg),
                kv_len=kv[rows], return_lse=True, dropout_rate=PAR_RATE,
                dropout_seed=fa.shard_seed(seed, origin))
        got = {"out": out.detach(), "lse": lse, "dq": ins[0].grad,
               "dk": ins[1].grad, "dv": ins[2].grad}
        if with_bias:
            got.update(dbias=bg[0].grad.float(), dgate=bg[1].grad)
        return got

    full = call(slice(None), slice(None), (0, 0))
    worst = {key: 0.0 for key in full}
    dbias = {}
    for b0 in (0, b // 2):
        for h0 in (0, h // 2):
            rows, heads = slice(b0, b0 + b // 2), slice(h0, h0 + h // 2)
            part = call(rows, heads, (b0, h0))
            for key, val in part.items():
                if key == "dbias":
                    dbias[h0] = dbias.get(h0, 0) + val
                    continue
                want = full[key][rows][:, heads].float()
                scale = 1.0 if key == "lse" else max(
                    want.abs().max().item(), 1e-30)
                worst[key] = max(worst[key], (val.float() - want).abs()
                                 .max().item() / scale)
    if with_bias:
        want = full["dbias"]
        scale = want.abs().max().item()
        worst["dbias"] = max((dbias[h0] - want[h0:h0 + h // 2]).abs().max()
                             .item() / scale for h0 in dbias)
    tol = {"out": ATTN_TOL[dtype_name], "lse": LSE_TOL}
    tol.update({key: GRAD_TOL[dtype_name] for key in worst
                if key not in tol})
    bits = _par_mask_bits(d, h, dtype, with_bias, kv)
    log(f"[parallel] 11a {name} {dtype_name} [{b},{h},{t},{d}] "
        f"(route {fa.forward_route(d, with_bias, dtype)}/"
        f"{fa.backward_route(d, with_bias, dtype)}), shards of 2 × 2: "
        f"{bits} mask bits off; worst |shard − unsharded| / max: "
        + ", ".join(f"{key} {val:.2e}" for key, val in worst.items()))
    over = {key: val for key, val in worst.items() if val > tol[key]}
    if bits or over:
        raise AssertionError(f"11a {name} {dtype_name}: {bits} mask bits "
                             f"off, over tolerance {over}")
    del q, k, v, bias, gate, dout, full
    torch.cuda.empty_cache()
    return dict(worst=worst, bits=bits)


def phase_parallel_kernels(gen) -> dict:
    """11a: the attention kernels on batch and head shards against the
    unsharded call: K2 + K2b (WavLM's gated bias, D = 64, 12 heads), K1 +
    K1b at the Conformer's [8, 2, 1499, 384] and at Whisper's [8, 8,
    1500, 64] (wgmma64 in bf16, mma64 in f32), f32 and bf16, strict
    dropout at 0.1, ragged kv_len."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kv = torch.tensor([T, 1001, 1499, 700, 1200, 1499, 64, 1333],
                      dtype=torch.int32, device="cuda")
    res = {}
    for name, h, d, with_bias in (("K2+K2b", 12, 64, True),
                                  ("K1+K1b Conformer", 2, 384, False),
                                  ("K1+K1b Whisper", 8, 64, False)):
        for dtype in ("f32", "bf16"):
            res[(name, dtype)] = _par_case(name, gen, h, d, dtype, with_bias,
                                           kv)
    return res


def rank_train(runs) -> None:
    """One rank of the 11b world (run by ``torch.distributed.run``): first,
    before any process group exists, the plain loop's first-step loss
    (``plain_first_loss`` of the first config); then for each (config,
    output) pair in turn, the train loop as ``python -m
    wfl_asr_tpu_torch.train`` runs it — the first call joins the
    launcher's NCCL group itself — with the launch counts set to 0 just
    before and read just after; writes the step times, peak memory,
    counts, the world and the plain loss to the output."""
    import torch
    import torch.distributed as dist
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.train import loop
    assert not dist.is_initialized()
    plain = plain_first_loss(Config.load(runs[0]))
    for cfg_path, out_path in zip(runs[::2], runs[1::2]):
        marks = []

        def on_update(step, batches):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.train(cfg_path, device="cuda", on_update=on_update)
        counts = {"K2": flash_attention.launches,
                  "K2b": flash_attention.bwd_launches,
                  "K1": flash_attention_bwd.launches,
                  "K1b": flash_attention_bwd.bwd_launches}
        info = {"counts": counts, "step_ms": [
            1e3 * (b - a) for a, b in zip([t0] + marks, marks)],
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "world": dist.get_world_size(), "backend": dist.get_backend(),
            "plain": plain}
        with open(out_path, "w") as f:
            json.dump(info, f)
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plain_first_loss(cfg) -> float:
    """The plain loop's loss on the first batch of the loop's order: the
    same seeded weights, loader and ``micro_step`` as ``loop.train``
    without a process group."""
    import torch
    from wfl_asr_tpu_torch.data.dataset import BatchLoader, PhonemeDataset, \
        split_dataset
    from wfl_asr_tpu_torch.labels import load_phoneme_list
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    from wfl_asr_tpu_torch.train import loop
    save = cfg.save_dir
    labels = load_phoneme_list(os.path.join(save, "phonemes.txt"))
    data = PhonemeDataset(os.path.join(save, "dataset.json"), labels,
                          cfg.max_seq_len, cfg.augmentation, cfg.sample_rate)
    train_idx, _ = split_dataset(len(data), cfg.num_val_files, cfg.seed)
    batch = next(BatchLoader(data, train_idx, cfg.batch_size, seed=cfg.seed,
                             shuffle=True, frame_duration=cfg.frame_duration
                             ).epoch_batches(0))
    model = init_tagger(TaggerArch.from_config(cfg, len(labels)),
                        torch.Generator().manual_seed(cfg.seed),
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    m, _, _ = loop.micro_step(model, batch, "cuda", 1, cfg.label_smoothing,
                              cfg.subframe_loss_weight, generator=gen)
    loss = float(m["loss"])
    del model
    torch.cuda.empty_cache()
    return loss


def phase_parallel_train(root: str) -> dict:
    """11b: a ``python -m torch.distributed.run --nproc_per_node 1`` world
    of one over NCCL on phase 6's corpus (WavLM-base-plus at full width,
    its depth cut to PAR_LAYERS layers so that phase 11 stays near 60 s,
    f32, PyTorch's default TF32 flags; the segmental metric off, so that
    the logged loss is the step's), one rank running ``rank_train``:
    PAR_STEPS steps with
    DDP, then as many with ``training.fsdp`` plus ``sharded_validation``
    (one validation). The first step's loss is held to the plain loop's
    on the same batch, computed in that process before it joins the group,
    and FSDP's second step's to DDP's (1e-5 relative each); step ms, peak
    memory and K2/K2b launches printed for each."""
    import yaml
    from wfl_asr_tpu_torch.preprocess import preprocess
    data_dir = os.path.join(root, "data")          # phase 6's, if it ran
    if not os.path.isdir(data_dir):
        write_corpus(data_dir)
    res, runs, modes = {}, [], ("ddp", "fsdp")
    raw = train_config(root)
    raw["data"]["data_dir"] = data_dir
    raw["model"]["segmental_loss_weight"] = 0.0
    raw["model"]["encoder_arch_overrides"] = {"num_layers": PAR_LAYERS}
    for mode, extra in zip(modes, ({"val_check_interval": 1000},
                                   {"fsdp": True, "sharded_validation": True,
                                    "val_check_interval": PAR_STEPS})):
        run = os.path.join(root, f"par_{mode}")
        raw["output"]["save_dir"] = run
        raw["training"].update(max_steps=PAR_STEPS,
                               log_dir=os.path.join(run, "logs"), **extra)
        cfg_path = os.path.join(run, "config.yaml")
        if mode == "ddp":
            preprocess(data_dir, raw)
        else:                   # the same artifacts, another config
            shutil.copytree(os.path.join(root, "par_ddp"), run)
            with open(cfg_path) as f:
                written = yaml.safe_load(f)     # preprocess's, languages in
            written["output"]["save_dir"] = run
            written["training"].update(raw["training"])
            with open(cfg_path, "w") as f:
                yaml.safe_dump(written, f)
        runs += [cfg_path, os.path.join(run, "rank0.json")]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), os.path.abspath(__file__),
           "--rank-train", *runs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"11b: rc {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"[parallel] 11b world of one: {wall:.1f} s wall, both runs")
    for mode, cfg_path, out in zip(modes, runs[::2], runs[1::2]):
        run = os.path.dirname(cfg_path)
        with open(out) as f:
            info = json.load(f)
        plain = info["plain"]
        with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        losses = [e["loss"] for e in events if e["event"] == "train"]
        vals = [e["loss"] for e in events if e["event"] == "val"]
        rel = abs(losses[0] - plain) / abs(plain)
        log(f"[parallel] 11b {mode} world of {info['world']} over "
            f"{info['backend']}: losses {losses}, first step {rel:.2e} "
            f"relative to the plain loop's {plain:.6f}; validation "
            f"{vals}; step ms {[round(x, 1) for x in info['step_ms']]}; "
            f"peak {info['peak_gb']:.2f} GiB; launches "
            f"{json.dumps(info['counts'])}")
        if info["world"] != 1 or info["backend"] != "nccl":
            raise AssertionError(f"11b {mode}: world {info['world']} over "
                                 f"{info['backend']}")
        if len(losses) != PAR_STEPS or rel > 1e-5 \
                or not np.all(np.isfinite(losses)):
            raise AssertionError(f"11b {mode}: losses {losses} against the "
                                 f"plain first step {plain}")
        if mode == "fsdp" and len(vals) != 1:
            raise AssertionError(f"11b fsdp: validations {vals}")
        if mode == "fsdp":
            # the same first step: the second steps' losses agree too
            # (run to run on the card they move by ~2e-7)
            gap = abs(losses[1] - res["ddp"]["losses"][1]) / abs(losses[1])
            log(f"[parallel] 11b fsdp against ddp, step 2: {gap:.2e} "
                f"relative")
            if gap > 1e-5:
                raise AssertionError(f"11b: step 2 fsdp {losses[1]} against "
                                     f"ddp {res['ddp']['losses'][1]}")
        if min(info["counts"]["K2"], info["counts"]["K2b"]) < 1:
            raise AssertionError(f"11b {mode}: K2/K2b launches "
                                 f"{info['counts']}")
        for name in ("last_model.pt",):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"11b {mode}: no {name}")
        res[mode] = dict(info, losses=losses, rel=rel)
        shutil.rmtree(run, ignore_errors=True)
    return res


def phase_parallel_serving(root: str, cfg, ckpt: str, wav_dir: str,
                           ref_labs: str) -> dict:
    """11c: ``infer_folder_batched(data_parallel=True)`` in an NCCL world of
    one, on a fresh copy of phase 4's wavs (no cache), with the launch
    counts set to 0 just before and read just after: its ``.lab`` files
    must equal phase 4's byte for byte."""
    import torch
    import torch.distributed as dist
    from wfl_asr_tpu_torch.infer import pipeline
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import conv_fused, flash_attention, \
        flash_attention_bwd
    wavs = os.path.join(root, "par_wavs")
    os.makedirs(wavs)
    for name in os.listdir(wav_dir):
        if name.endswith(".wav"):
            shutil.copy(os.path.join(wav_dir, name), wavs)
    out_dir = os.path.join(root, "par_labs")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pipeline.infer_folder_batched(wavs, cfg, ckpt, out_dir, lang_id=0,
                                      confidence_threshold=0.0,
                                      batch_files=8, device="cuda",
                                      compute_dtype=torch.bfloat16,
                                      data_parallel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"K2": flash_attention.launches,
                  "K1": flash_attention_bwd.launches,
                  "K5 layers": conv_fused.layer_launches}
        mesh = [s.mesh.shape for s in pipeline._SESSION_CACHE.values()
                if s.mesh is not None]
    finally:
        for key in [k for k, s in pipeline._SESSION_CACHE.items()
                    if s.mesh is not None]:
            del pipeline._SESSION_CACHE[key]
        dist.destroy_process_group()
    names = sorted(n for n in os.listdir(ref_labs) if n.endswith(".lab"))
    same = [n for n in names if open(os.path.join(ref_labs, n), "rb").read()
            == open(os.path.join(out_dir, n), "rb").read()]
    log(f"[parallel] 11c infer_folder_batched(data_parallel=True), NCCL "
        f"world of 1 (mesh {mesh}): {len(same)} of {len(names)} .lab files "
        f"byte-identical to phase 4's; launches {json.dumps(counts)}; "
        f"{wall:.2f} s")
    if not mesh or len(same) != len(names) or not names:
        raise AssertionError(f"11c: mesh {mesh}, {len(same)} of "
                             f"{len(names)} .lab files equal")
    if min(counts.values()) < 1:
        raise AssertionError(f"11c: launches {counts}")
    return dict(counts=counts, wall=wall)


NO_DROPOUT = {"hidden_dropout": 0.0, "activation_dropout": 0.0,
              "feat_proj_dropout": 0.0, "attention_dropout": 0.0,
              "layerdrop": 0.0}


def rank_pp(args) -> None:
    """One rank of 11d's pipeline world (run by ``torch.distributed.run``
    with ``WFL_DIST_BACKEND=gloo``): ``loop.train`` on the PP config
    (joining the group itself) with the launch counts set to 0 just before
    and read just after; the replicated parameters gathered from
    both ranks; ``infer_folder_batched`` on the PP serving config, the
    counts set to 0 just before and read just after; finally rank 0 alone
    trains the DDP config in a world of one over NCCL. Each rank writes
    ``rank{r}.json`` to the output directory."""
    import faulthandler
    import torch
    import torch.distributed as dist
    from wfl_asr_tpu_torch.infer import pipeline
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import conv_fused, flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.parallel import pp
    from wfl_asr_tpu_torch.train import loop
    pp_cfg, ddp_cfg, out_dir, serve_cfg, ckpt, wavs, labs = args
    rank = int(os.environ["RANK"])
    # the parent's TF32 flags (phase 4 served under them)
    matmul, cudnn = (bool(int(x)) for x in
                     os.environ["WFL_SMOKE_TF32"].split(","))
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    # a rank still running this close to the phase's limit shows its stack
    faulthandler.dump_traceback_later(PP_TIMEOUT_S - 60, exit=False)

    def say(msg):
        print(f"[pp rank {rank}] {time.strftime('%H:%M:%S')} {msg}",
              flush=True)

    info = {}
    marks = []

    def on_update(step, batches):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        say(f"step {step}")

    def counts():
        return {"K2": flash_attention.launches,
                "K2b": flash_attention.bwd_launches,
                "K1": flash_attention_bwd.launches,
                "K1b": flash_attention_bwd.bwd_launches,
                "K5 layers": conv_fused.layer_launches}

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = loop.train(pp_cfg, device="cuda", on_update=on_update)
    say("trained")
    info["counts"] = counts()
    info["step_ms"] = [1e3 * (b - a) for a, b in zip([t0] + marks, marks)]
    info["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    info["world"], info["backend"] = dist.get_world_size(), \
        dist.get_backend()
    info["layers"] = list(model.encoder.pipeline.local)
    info["devices"] = sorted({str(p.device) for p in model.parameters()})
    named = dict(model.named_parameters())
    info["param_bytes"] = sum(p.numel() * p.element_size()
                              for p in named.values())
    info["layer_bytes"] = sum(p.numel() * p.element_size()
                              for n, p in named.items()
                              if pp.pp_spec(n) == "stage")
    replicas = {n: p.detach().cpu() for n, p in named.items()
                if pp.pp_spec(n) == "replicated"}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, replicas)
    info["replica_gap"] = max(float((r[n] - replicas[n]).abs().max())
                              for r in every for n in replicas)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    say("serving")
    t0 = time.perf_counter()
    pipeline.infer_folder_batched(wavs, serve_cfg, ckpt, labs, lang_id=0,
                                  confidence_threshold=0.0, batch_files=8,
                                  device="cuda",
                                  compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    info["serve_s"] = time.perf_counter() - t0
    info["serve_counts"] = counts()
    pipeline._SESSION_CACHE.clear()
    dist.barrier()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        # the same config without pipeline parallelism, in a DDP world of
        # one (the group made here, on a store of its own: under the
        # launcher a tcp:// rendezvous would wait for the agent's store)
        store = dist.TCPStore("127.0.0.1", _free_port(), 1, True)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0)
        say("DDP world of one")
        loop.train(ddp_cfg, device="cuda")
        info["ddp_backend"] = dist.get_backend()
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    faulthandler.cancel_dump_traceback_later()
    say("done")


def phase_pipeline(root: str, cfg, ckpt: str, wav_dir: str,
                   ref_labs: str) -> dict:
    """11d (see the module docstring): the two-rank pipeline world on the
    one card, training then serving, and its checks."""
    import torch
    import yaml
    from wfl_asr_tpu_torch.preprocess import preprocess
    data_dir = os.path.join(root, "data")          # phase 6's, if it ran
    if not os.path.isdir(data_dir):
        write_corpus(data_dir)
    raw = train_config(root)
    raw["data"]["data_dir"] = data_dir
    raw["model"]["segmental_loss_weight"] = 0.0
    raw["model"]["conformer_dropout"] = 0.0
    raw["model"]["encoder_arch_overrides"] = dict(NO_DROPOUT,
                                                  num_layers=PP_LAYERS)
    paths = {}
    for mode, extra in (("pp", {"pipeline_parallel": 2,
                                "pp_microbatches": PP_MICRO}),
                        ("ddp", {})):
        run = os.path.join(root, f"pp_{mode}")
        raw["output"]["save_dir"] = run
        raw["training"].update(max_steps=2, val_check_interval=1000,
                               log_dir=os.path.join(run, "logs"))
        raw["training"].pop("pipeline_parallel", None)
        raw["training"].pop("pp_microbatches", None)
        raw["training"].update(extra)
        preprocess(data_dir, raw)
        cfg_path = os.path.join(run, "config.yaml")
        with open(cfg_path) as f:
            written = yaml.safe_load(f)     # preprocess's, languages in
        written["training"].update(raw["training"])
        with open(cfg_path, "w") as f:
            yaml.safe_dump(written, f)
        paths[mode] = cfg_path
    serve_raw = json.loads(json.dumps(cfg.raw))
    serve_raw["model"]["pipeline_parallel"] = 2
    serve_cfg = os.path.join(root, "pp_serve.yaml")
    with open(serve_cfg, "w") as f:
        yaml.safe_dump(serve_raw, f)
    wavs = os.path.join(root, "pp_wavs")
    os.makedirs(wavs)
    for name in os.listdir(wav_dir):
        if name.endswith(".wav"):
            shutil.copy(os.path.join(wav_dir, name), wavs)
    out_dir = os.path.join(root, "pp_out")
    labs = os.path.join(root, "pp_labs")
    os.makedirs(out_dir)
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), os.path.abspath(__file__),
           "--rank-pp", paths["pp"], paths["ddp"], out_dir, serve_cfg, ckpt,
           wavs, labs]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    env = dict(os.environ, WFL_DIST_BACKEND="gloo",
               WFL_SMOKE_TF32=",".join(str(int(x)) for x in tf32))
    rank_log = os.path.join(out_dir, "ranks.log")
    t0 = time.perf_counter()
    with open(rank_log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
        from wfl_asr_tpu_torch.config import Config
        try:
            # the plain loop's first loss on the same batch, here while the
            # ranks start up (this process has no group)
            plain = plain_first_loss(Config.load(paths["pp"]))
            rc = proc.wait(timeout=max(PP_TIMEOUT_S - (time.perf_counter()
                                                       - t0), 1))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)      # the launcher and its ranks
                proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(rank_log) as f:
            text = f.read()
        raise AssertionError(f"11d: rc {rc} after {wall:.1f} s\n"
                             f"{text[-12000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    def losses(mode):
        with open(os.path.join(root, f"pp_{mode}", "logs",
                               "metrics.jsonl")) as f:
            return [e["loss"] for e in map(json.loads, f)
                    if e["event"] == "train"]

    pp_losses, ddp_losses = losses("pp"), losses("ddp")
    first = abs(pp_losses[0] - plain) / abs(plain)
    second = abs(pp_losses[1] - ddp_losses[1]) / abs(ddp_losses[1])
    log(f"[pp] 11d two ranks on one card over {ranks[0]['backend']} "
        f"(devices {ranks[0]['devices']} and {ranks[1]['devices']}; TF32 "
        f"matmul/cuDNN {tf32[0]}/{tf32[1]}, as this process): "
        f"{wall:.1f} s wall; losses {pp_losses} against the plain loop's "
        f"first {plain:.6f} ({first:.2e} relative) and a DDP world of one's "
        f"{ddp_losses} (step 2 {second:.2e} relative, "
        f"{ranks[0]['ddp_backend']})")
    for r, info in enumerate(ranks):
        log(f"[pp] 11d rank {r}: layers {info['layers']}, parameters "
            f"{info['param_bytes'] / 2 ** 20:.1f} MiB of which its layers "
            f"{info['layer_bytes'] / 2 ** 20:.1f} MiB; step ms "
            f"{[round(x, 1) for x in info['step_ms']]}; peak "
            f"{info['peak_gb']:.2f} GiB; training launches "
            f"{json.dumps(info['counts'])}; replicas differ by "
            f"{info['replica_gap']:.3e}; serving {info['serve_s']:.2f} s, "
            f"launches {json.dumps(info['serve_counts'])}")
    names = sorted(n for n in os.listdir(ref_labs) if n.endswith(".lab"))
    differing = []
    for n in names:
        a = open(os.path.join(ref_labs, n)).read().splitlines()
        b = open(os.path.join(labs, n)).read().splitlines()
        if a != b:
            differing.append((n, len(a), len(b),
                              [(x, y) for x, y in zip(a, b) if x != y][:4]))
    log(f"[pp] 11d serving: {len(names) - len(differing)} of {len(names)} "
        f".lab files byte-identical to phase 4's"
        + "".join(f"; {n}: {la} against {lb} lines, first differing "
                  f"{d}" for n, la, lb, d in differing))
    expect = len(ranks[0]["layers"]) * PP_MICRO * 2
    for r, info in enumerate(ranks):
        c = info["counts"]
        if info["world"] != 2 or info["devices"] != ["cuda:0"]:
            raise AssertionError(f"11d rank {r}: world {info['world']}, "
                                 f"devices {info['devices']}")
        if c["K2"] != expect or c["K2b"] != expect or min(
                c["K1"], c["K1b"]) < 1:
            raise AssertionError(f"11d rank {r}: launches {c}, K2/K2b "
                                 f"expected {expect}")
        if min(info["serve_counts"]["K2"],
               info["serve_counts"]["K5 layers"]) < 1:
            raise AssertionError(f"11d rank {r}: serving launches "
                                 f"{info['serve_counts']}")
        if info["replica_gap"] != 0.0:
            raise AssertionError(f"11d rank {r}: replicas differ by "
                                 f"{info['replica_gap']}")
    if len(pp_losses) != 2 or first > 1e-5 or second > 1e-5 \
            or not np.all(np.isfinite(pp_losses)):
        raise AssertionError(f"11d: losses {pp_losses}, plain {plain}, DDP "
                             f"{ddp_losses}")
    if not names or len(differing) == len(names):
        raise AssertionError(f"11d: {len(differing)} of {len(names)} .lab "
                             f"files differ")
    for mode in ("pp_pp", "pp_ddp"):
        shutil.rmtree(os.path.join(root, mode), ignore_errors=True)
    return dict(ranks=ranks, losses=pp_losses, ddp=ddp_losses, first=first,
                second=second, wall=wall, differing=differing)


def parallel_phases(root: str, cfg=None, ckpt=None, wav_dir=None,
                    ref_labs=None) -> dict:
    """Phase 11 (``--only parallel``): 11a-11d; without phase 4's run it
    makes one (the same ``make_run`` and ``infer_folder_batched`` call)."""
    import torch
    with lap("11a"):
        kern = phase_parallel_kernels(
            torch.Generator(device="cuda").manual_seed(11))
    with lap("11b"):
        train = phase_parallel_train(root)
    with lap("11c"):
        if cfg is None:
            cfg, ckpt, wav_dir = make_run(root)
            ref_labs = os.path.join(root, "labs")
            from wfl_asr_tpu_torch.infer.pipeline import infer_folder_batched
            infer_folder_batched(wav_dir, cfg, ckpt, ref_labs, lang_id=0,
                                 confidence_threshold=0.0, batch_files=8,
                                 device="cuda", compute_dtype=torch.bfloat16)
        serving = phase_parallel_serving(root, cfg, ckpt, wav_dir, ref_labs)
    with lap("11d"):
        pipe = phase_pipeline(root, cfg, ckpt, wav_dir, ref_labs)
    return dict(kernels=kern, train=train, serving=serving, pipeline=pipe)


def k6_row(kern: dict, strict: dict) -> dict:
    """The strict attention dropout's row: K6 runs inside the four attention
    kernels, so its launches are the dropout launches of phase 6b's
    training run, and its numbers are K2b's in f32 at rate 0.1 with
    dropout (phase 3c): the hash's cost where the training step spends
    most (the bound: the larger of K2b's f32 operations at the 3×TF32
    ceiling, the hash's INT32 operations and the bytes, each over its
    rate)."""
    r = kern[("K2drop", "f32", DROP_RATES[0])]["bwd"]
    return {"name": "attention_dropout (in K1/K2/K1b/K2b)", "route": "cuda",
            "source": "wfl_asr_tpu_torch/ops/kernels/csrc/common.cuh",
            "replaces": "wfl_asr_tpu/ops/pallas/dropout_mask.py:65",
            "launches": sum(n for k, n in strict["counts"].items()
                            if k.endswith("dropout")),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "conv", "train", "whisper",
                                       "modules", "optim", "parallel", "pp",
                                       "remat-det"),
                    default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rank-train", nargs="+", metavar="CONFIG OUT",
                    help="(run by phase 11b under torch.distributed.run)")
    ap.add_argument("--rank-pp", nargs=7, metavar="ARG",
                    help="(run by phase 11d under torch.distributed.run)")
    args = ap.parse_args()

    if args.only == "remat-det":
        # read when cuBLAS starts: before any CUDA work
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.rank_train:
        rank_train(args.rank_train)
        return 0
    if args.rank_pp:
        rank_pp(args.rank_pp)
        return 0
    from wfl_asr_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {sys.version.split()[0]}")
    sources = {"conv": ["conv_fused"],
               "whisper": ["attention_fwd_mma", "attention_bwd_mma",
                           "attention_fwd_bias_mma",
                           "attention_bwd_bias_mma", "attention_wide",
                           "attention_wgmma", "flash_attention"]}
    with lap("build"):
        logs = _build.build_all(sources.get(args.only, list(KERNEL_SOURCES)))
    log(f"[build] {', '.join(logs)} in {LAPS['build']:.1f} s")
    for name, text in logs.items():
        for line in ptxas_summary(text):
            log(f"[ptxas] {name}: {line}")
    if "attention_wide" in logs:
        cluster_plans()

    def train_phases(root):
        with lap("6"):
            trained = phase_train(root)
        with lap("6b"):
            strict = phase_train_strict(root, trained)
        with lap("7"):
            cross_train = phase_train_cross_device(trained["labels"])
        with lap("7b"):
            cross_strict = phase_train_cross_device(trained["labels"],
                                                    strict=True)
        return trained, strict, cross_train, cross_strict

    if args.only == "conv":      # K5's part of phase 3 alone
        torch.backends.cudnn.allow_tf32 = False
        with lap("3"):
            phase_conv(torch.Generator(device="cuda").manual_seed(0),
                       args.iters)
        log_laps()
        return 0
    if args.only in ("train", "whisper", "modules", "optim",
                     "parallel", "pp", "remat-det"):     # iterating
        root = tempfile.mkdtemp(prefix="wfl_smoke_")
        try:
            if args.only == "train":        # phases 6-7b
                train_phases(root)
            elif args.only == "parallel":   # phase 11
                parallel_phases(root)
            elif args.only == "remat-det":  # phase 10a, deterministic
                with lap("10a-det"):
                    phase_remat_deterministic(root)
            elif args.only == "pp":         # phase 11d
                cfg, ckpt, wav_dir = make_run(root)
                ref_labs = os.path.join(root, "labs")
                from wfl_asr_tpu_torch.infer.pipeline import \
                    infer_folder_batched
                infer_folder_batched(wav_dir, cfg, ckpt, ref_labs, lang_id=0,
                                     confidence_threshold=0.0, batch_files=8,
                                     device="cuda",
                                     compute_dtype=torch.bfloat16)
                with lap("11d"):
                    phase_pipeline(root, cfg, ckpt, wav_dir, ref_labs)
            elif args.only == "optim":      # phases 10e-10f
                with lap("10e"):
                    phase_optimizers(root, FLAGSHIP_LABELS)
                with lap("10f"):
                    phase_train_optimizers(root)
            elif args.only == "modules":    # phases 10a-10f
                cfg, ckpt, _ = make_run(root)
                module_phases(root, cfg, ckpt, FLAGSHIP_LABELS, args.iters)
            else:                           # phases 3e and 8-9c
                with lap("3e"):
                    phase_whisper_kernels(
                        torch.Generator(device="cuda").manual_seed(0),
                        args.iters)
                whisper_phases(root, args.iters)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        log_laps()
        return 0
    kern = phase_kernels(args.iters)
    if args.only == "kernels":
        log_laps()
        return 0

    root = tempfile.mkdtemp(prefix="wfl_smoke_")
    try:
        with lap("4"):
            run = phase_main(root, iters=args.iters)
        perf, counts = run["perf"], run["counts"]
        with lap("5"):
            cross = phase_cross_device(run["cfg"], run["ckpt"],
                                       run["wav_dir"])
        trained, strict, cross_train, cross_strict = train_phases(root)
        counts.update({k: n for k, n in trained["counts"].items()
                       if k.endswith("_bwd")})
        whisper = whisper_phases(root, args.iters)
        tr, tr4 = whisper["trained"]["counts"], whisper["trained4"]["counts"]
        counts["whisper K1 f32"] = tr["mma64 forwards"]
        counts["whisper K1b"] = tr["mma64 passes"]
        counts["whisper K1 bf16"] = whisper["serving"]["wgmma64"]
        counts["whisper K1b bf16"] = whisper["bf16_train"]["counts"][
            "wgmma64"]
        counts["wide K1"] = whisper["serving"]["wide"]
        counts["wide K1b"] = whisper["large"]["wide"]
        counts["mma128 K1"] = tr4["mma128 forwards"]
        counts["mma128 K1b"] = tr4["mma128 passes"]
        counts["wgmma128 K1"] = whisper["serving4"]["routes"]["wgmma128"]
        counts["wgmma128 K1b"] = whisper["bf16_train"]["counts"][
            "wgmma128"]
        modules = module_phases(root, run["cfg"], run["ckpt"],
                                FLAGSHIP_LABELS, args.iters)
        par = parallel_phases(root, run["cfg"], run["ckpt"], run["wav_dir"],
                              os.path.join(root, "labs"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log_laps()

    rows = []
    for key, dtype, name, counter, source, replaces in KERNEL_ROWS:
        r = kern[(key, dtype)]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[counter],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    rows.append(k6_row(kern, strict))
    idle = [r["name"] for r in rows if r["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels launched no time on their main "
                             f"path: {idle}")
    log(f"[summary] bf16 B=8x30 s: {perf['bf16']['audio_s_per_s']:.2f} "
        f"audio-s/s, f32: {perf['f32']['audio_s_per_s']:.2f} audio-s/s "
        f"(peak memory {perf['bf16']['peak_gb']:.3f} / "
        f"{perf['f32']['peak_gb']:.3f} GiB); "
        f"card vs CPU logits {cross['max_abs_err']:.3e}; training f32 "
        f"{trained['step_ms']:.1f} ms a step, {trained['audio_s_per_s']:.2f} "
        f"audio-s/s, {trained['peak_gb']:.2f} GiB peak; card vs CPU train "
        f"step loss {cross_train['loss_rel']:.2e}, grads "
        f"{cross_train['grad_rel']:.2e} × max; strict training "
        f"{strict['step_ms']:.1f} ms a step, {strict['peak_gb']:.2f} GiB "
        f"peak, same batch {strict['same_batch_ms'][0]:.1f} against "
        f"{strict['same_batch_ms'][1]:.1f} ms; card vs CPU strict step loss "
        f"{cross_strict['loss_rel']:.2e}, grads {cross_strict['grad_rel']:.2e}"
        f" × max")
    wperf, wtrain = whisper["serving"]["perf"], whisper["trained"]
    log(f"[summary] Whisper-base bf16 B=8x30 s: "
        f"{wperf['bf16']['audio_s_per_s']:.2f} audio-s/s, f32: "
        f"{wperf['f32']['audio_s_per_s']:.2f} (peak memory "
        f"{wperf['bf16']['peak_gb']:.3f} / {wperf['f32']['peak_gb']:.3f} "
        f"GiB); large-v3 bf16 {whisper['serving']['large_ms']:.2f} ms a "
        f"forward; card vs CPU logits Whisper "
        f"{whisper['cross']['whisper']['max_abs_err']:.3e}, none "
        f"{whisper['cross']['none']['max_abs_err']:.3e}; training f32 "
        f"{wtrain['step_ms']:.1f} ms a step, {wtrain['audio_s_per_s']:.2f} "
        f"audio-s/s, {wtrain['peak_gb']:.2f} GiB peak; card vs CPU train "
        f"step loss {whisper['cross_train']['loss_rel']:.2e}, grads "
        f"{whisper['cross_train']['grad_rel']:.2e} × max; large-v3 f32 train "
        f"step B=2x30 s {whisper['large']['step_ms']:.1f} ms, "
        f"{whisper['large']['peak_gb']:.2f} GiB peak")
    wperf4, wtrain4 = whisper["serving4"]["perf"], whisper["trained4"]
    log(f"[summary] Whisper-base at the schema's 4 Conformer heads (head_dim "
        f"128, mma128): bf16 B=8x30 s {wperf4['bf16']['audio_s_per_s']:.2f} "
        f"audio-s/s, f32 {wperf4['f32']['audio_s_per_s']:.2f} (peak memory "
        f"{wperf4['bf16']['peak_gb']:.3f} / {wperf4['f32']['peak_gb']:.3f} "
        f"GiB; bf16 step busy {whisper['serving4']['busy_ms']:.2f} of "
        f"{whisper['serving4']['wall_ms']:.2f} ms); card vs CPU logits "
        f"{whisper['serving4']['cross']['max_abs_err']:.3e}; training f32 "
        f"{wtrain4['step_ms']:.1f} ms a step, "
        f"{wtrain4['audio_s_per_s']:.2f} audio-s/s, "
        f"{wtrain4['peak_gb']:.2f} GiB peak, profiled step busy "
        f"{wtrain4['busy_ms']:.2f} ms (idle {wtrain4['idle']:.3f}); 2 "
        f"heads: busy {wtrain['busy_ms']:.2f} ms (idle "
        f"{wtrain['idle']:.3f}); card vs CPU train step loss "
        f"{whisper['cross_train4']['loss_rel']:.2e}, grads "
        f"{whisper['cross_train4']['grad_rel']:.2e} × max")
    wb = whisper["bf16_train"]
    log(f"[summary] Whisper-base at 4 Conformer heads, bf16 train step "
        f"(phase 9f, wgmma64/wgmma128): {wb['step_ms']:.1f} ms, "
        f"{wb['audio_s_per_s']:.2f} audio-s/s, {wb['peak_gb']:.2f} GiB "
        f"peak, profiled step busy {wb['busy_ms']:.2f} of "
        f"{wb['wall_ms']:.2f} ms (idle {wb['idle']:.3f}); loss on one "
        f"batch f32 {wb['losses']['f32']:.5f}, bf16 "
        f"{wb['losses']['bf16']:.5f}")
    ra, au, i8 = modules["remat"], modules["auto"], modules["int8"]
    log(f"[summary] phase 10: remat WavLM-base-plus f32 B=8 peak "
        f"{ra['default']['peak_gb'][0]:.2f} → "
        f"{ra['default']['peak_gb'][1]:.2f} GiB, forward + backward "
        f"{ra['default']['fb_ms'][0]:.1f} → {ra['default']['fb_ms'][1]:.1f} "
        f"ms, gradients {ra['default']['grad_rel']:.1e} / strict "
        f"{ra['strict']['grad_rel']:.1e} × max; remat auto large-v3 B="
        f"{REMAT_AUTO_B}×30 s flipped at step {au['flipped_at']} on "
        f"{'. '.join(au['oom'].split('. ')[:2])!r}, "
        f"{au['step_ms']:.1f} ms a step, {au['peak_gb']:.2f} GiB peak; int8 "
        f"serving {np.mean(i8['perf']['int8']):.2f} against bf16 "
        f"{np.mean(i8['perf']['bf16']):.2f} audio-s/s, cosine "
        f"{i8['cosine']:.5f}; correct_label CLI "
        f"{modules['cl']['cli_s']:.2f} s for 8 × 30 s")
    optim = modules["optim"]
    log("[summary] phase 10e, optimizer step on the card (wall ms / "
        "kernels / state MiB): " + ", ".join(
            f"{n} {r['wall_ms']:.1f}/{r['launches']:g}/{r['state_mib']:.0f}"
            for n, r in optim.items())
        + "; phase 10f loop.train " + ", ".join(
            f"{n} {r['wall_s']:.1f} s" for n, r in
            modules["optim_train"].items()))
    pt = par["train"]
    log("[summary] phase 11: kernels on 2 × 2 batch/head shards, worst "
        "|shard − unsharded| / max " + "; ".join(
            f"{n} {dt} " + "/".join(f"{v:.1e}" for v in r["worst"].values())
            for (n, dt), r in par["kernels"].items())
        + "; NCCL worlds of one: " + ", ".join(
            f"{m} step {r['step_ms'][-1]:.1f} ms, {r['peak_gb']:.2f} GiB, "
            f"K2/K2b {r['counts']['K2']}/{r['counts']['K2b']}"
            for m, r in pt.items())
        + f"; data-parallel serving {par['serving']['wall']:.2f} s, .lab "
        f"byte-identical")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
