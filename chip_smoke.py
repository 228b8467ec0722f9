"""Chip smoke test of the PyTorch/CUDA port (``wfl_asr_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --only kernels  # build + kernel-vs-plain phases only

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
   the card could take (``bound_ms``);
4. the main path: a full-width WavLM-base-plus tagger (random weights from
   a ``torch.Generator`` seed) saved as ``.pt``, 8 synthetic wavs of ≤ 30 s,
   ``infer_folder_batched`` on the card in bf16 with the device decode —
   launch counts reset just before and read just after — then the batched
   forward with gate and median at B=8×30 s (bench.py's definition), timed;
5. the card against the CPU, f32 (TF32 off): one 30 s utterance through
   ``InferenceSession.forward`` (unmasked), and the 8 wavs of unequal
   length through ``forward_many_decoded`` (sample and frame masks, masked
   GroupNorm statistics, unequal key lengths, the packed BiLSTM, the
   device decode): logits must agree to ≤ 1e-3 on every row's valid
   frames;
6. a ``{"kernels": [...]}`` line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s for bf16 on tensor cores and f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# Tolerances of a kernel against its plain twin on the card, as fractions
# of the reference output's largest magnitude (≈ 1 on the inputs below):
# for bf16 attention 1e-2 is 2.5 bf16 steps of a value in [0.5, 1).
ATTN_TOL = {"f32": 1e-4, "bf16": 1e-2}          # × max|out|
CONV_TOL = {"f32": 1e-3, "bf16": 3e-2}          # × max|out|
# Attention inputs: q·k/√d of std ≈ Q_SCALE, so each row's softmax puts
# its weight on a few keys and the output (a mix of values in [-1, 1]) is
# of order 1 — a wrong mask, bias or normalisation moves it by that much.
Q_SCALE = 3.0
CROSS_DEVICE_TOL = 1e-3                          # card vs CPU logits, f32

B, T = 8, 1499          # batch rows and frames of a 30 s chunk


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
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


def _attn_case(name, gen, h, d, dtype, with_bias, kv, iters):
    import torch
    import torch.nn.functional as F
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
        flash_attention_trainable
    dev = "cuda"
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, bias, gate = attn_inputs(gen, (B, h, T, d), tdt, with_bias)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)

    # the entry point the model calls: K2 with bias and gate, K1 without
    if with_bias:
        def entry():
            return fa.flash_attention(q, k, v, bias, gate, kv_len)
    else:
        def entry():
            return flash_attention_trainable(q, k, v, kv_len)
    with torch.inference_mode():
        out = entry()
    ref = fa.attention_plain(q, k, v, bias, gate, kv_len)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    mean_abs = ref.float().abs().mean().item()
    err = (out.float() - ref.float()).abs().max().item()
    ok = err <= ATTN_TOL[dtype] * scale and math.isfinite(err)

    with torch.inference_mode():
        ms = time_ms(entry, iters)
    plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, bias, gate,
                                                  kv_len), iters)
    # the one PyTorch call computing the same function (yardstick only)
    keep = torch.arange(T, device=dev)[None, :] < kv_len[:, None]
    mask = torch.zeros((B, h, T, T), dtype=tdt, device=dev)
    if with_bias:
        mask += (gate[..., None] * bias.float()[None]).to(tdt)
    mask.masked_fill_(~keep[:, None, None, :], -1e30)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters)
    del mask

    es = 4 if dtype == "f32" else 2
    valid_keys = float(sum(kv))
    flops = 4.0 * h * T * valid_keys * d
    nbytes = 4.0 * B * h * T * d * es + B * 4
    if with_bias:
        nbytes += h * T * T * es + B * h * T * 4
    bms, by = bound_ms(flops, nbytes, dtype)
    log(f"[kernel] {name} {dtype} [{B},{h},{T},{d}] max_abs_err={err:.3e} "
        f"(tol {ATTN_TOL[dtype]:g}×{scale:.3g}; mean|out| {mean_abs:.3g}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
        f"bound_ms={bms:.4f} ({by})")
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs diff {err} exceeds "
                             f"{ATTN_TOL[dtype]}×{scale}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def _conv_case(name, gen, ks, t_in, with_norm, dtype, iters):
    import torch
    from wfl_asr_tpu_torch.ops.kernels import conv_fused as cf
    dev, c = "cuda", 512
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    # unit-scale activations: He-scaled weights (std √(2/(C·k))) keep every
    # layer's GELU input of order 1, where GELU is far from linear
    x = torch.randn((B, t_in, c), generator=gen, device=dev).to(tdt)
    ws = [torch.randn((c, c, k), generator=gen, device=dev)
          * math.sqrt(2.0 / (c * k)) for k in ks]
    norm = None
    if with_norm:
        norm = (torch.randn((B, c), generator=gen, device=dev) * 0.1,
                0.5 + torch.rand((B, c), generator=gen, device=dev),
                1.0 + 0.2 * torch.randn((c,), generator=gen, device=dev),
                torch.randn((c,), generator=gen, device=dev) * 0.1)
    packed = cf.pack_weights(ws, tdt, dev)

    def entry():        # the entry point the WavLM feature encoder calls
        return cf.fused_conv_chain(x, ws, input_norm=norm, packed=packed)
    with torch.inference_mode():
        out = entry()
    ref = cf.conv_chain_plain(x, ws, norm)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    mean_abs = ref.float().abs().mean().item()
    err = (out.float() - ref.float()).abs().max().item()
    ok = err <= CONV_TOL[dtype] * scale and math.isfinite(err)
    with torch.inference_mode():
        ms = time_ms(entry, iters)
    plain_ms = time_ms(lambda: cf.conv_chain_plain(x, ws, norm), iters)

    es = 4 if dtype == "f32" else 2
    t, flops = t_in, 0.0
    for k in ks:
        t = (t - k) // 2 + 1
        flops += 2.0 * B * c * c * k * t
    nbytes = (B * t_in * c + B * t * c + sum(ks) * c * c) * es
    if with_norm:
        nbytes += 2 * B * c * 4 + 2 * c * 4
    bms, by = bound_ms(flops, nbytes, dtype)
    log(f"[kernel] {name} {dtype} ks={ks} [{B},{t_in},{c}]->[{B},{t},{c}] "
        f"max_abs_err={err:.3e} (tol {CONV_TOL[dtype]:g}×{scale:.3g}; "
        f"mean|out| {mean_abs:.3g}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by})")
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs diff {err} exceeds "
                             f"{CONV_TOL[dtype]}×{scale}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def phase_kernels(iters: int) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    kv = [T - 100 * i for i in range(B)]     # unequal key lengths
    res = {}
    for dtype in ("f32", "bf16"):
        res[("K2", dtype)] = _attn_case("flash_attention", gen, 12, 64,
                                        dtype, True, kv, iters)
        res[("K1", dtype)] = _attn_case("flash_attention_trainable", gen, 2,
                                        384, dtype, False, kv, iters)
        res[("K5a", dtype)] = _conv_case("fused_conv_chain[1-3]", gen,
                                         (3, 3, 3), 95999, True, dtype,
                                         iters)
        res[("K5b", dtype)] = _conv_case("fused_conv_chain[4-6]", gen,
                                         (3, 2, 2), 11999, False, dtype,
                                         iters)
        torch.cuda.empty_cache()
    head_dims(gen)
    return res


def head_dims(gen) -> None:
    """Every kernel variant of the attention at a small shape: bf16 and f32
    at head widths from 16 to 512 (the main path runs 64 and 384), with bias,
    gate and a ragged key length, against the plain twin."""
    import torch
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    errs = {}
    for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for d in (16, 48, 128, 144, 512):
            q, k, v, bias, gate = attn_inputs(gen, (2, 2, 203, d), tdt, True)
            kv = torch.tensor([203, 77], dtype=torch.int32, device="cuda")
            with torch.inference_mode():
                out = fa.flash_attention(q, k, v, bias, gate, kv)
            ref = fa.attention_plain(q, k, v, bias, gate, kv)
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            errs[(dtype, d)] = err
            if not err <= ATTN_TOL[dtype] * scale:
                raise AssertionError(f"attention {dtype} head_dim {d}: max abs "
                                     f"diff {err} exceeds {ATTN_TOL[dtype]}"
                                     f"×{scale}")
    log("[kernel] attention head widths 16/48/128/144/512, f32 and bf16: "
        "max_abs_err " + ", ".join(f"{k[0]}/{k[1]}={e:.2e}"
                                   for k, e in errs.items()))


# ---------------------------------------------------------------------------
# Phase 4: the main path through the entry points a user calls
# ---------------------------------------------------------------------------

DURATIONS = (30.0, 27.3, 24.1, 19.8, 15.2, 11.7, 6.4, 2.9)


def make_run(root: str):
    """A save_dir (73 labels, 2 languages), a Config built from a dict, a
    random-init WavLM-base-plus tagger saved as .pt, and 8 wavs of ≤ 30 s."""
    import torch
    from wfl_asr_tpu_torch.checkpoint import save_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.data.audio import write_wav
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger

    save_dir = os.path.join(root, "save")
    os.makedirs(save_dir)
    phonemes = [f"p{i}" for i in range(35)] + ["SP"]
    labels = ["O"] + [f"{t}-{p}" for p in phonemes for t in ("B", "I")]
    assert len(labels) == 73
    with open(os.path.join(save_dir, "phonemes.txt"), "w") as f:
        f.write("\n".join(labels) + "\n")
    with open(os.path.join(save_dir, "langs.txt"), "w") as f:
        f.write("en,0\nja,1\n")
    model_cfg = {
        "encoder_type": "wavlm", "wavlm_model": "microsoft/wavlm-base-plus",
        "num_languages": 2, "lang_emb_dim": 64, "enable_bilstm": True,
        "bilstm_num_layer": 2, "num_conformer_layers": 2,
        "conformer_heads": 2, "conformer_ff_expansion": 2,
        "conformer_kernel_size": 31, "conformer_dropout": 0.15,
        "enable_dilated_conv": True, "dilated_conv_depth": 2,
        "dilated_conv_kernel": 3}
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

    wav_dir = os.path.join(root, "wavs")
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
    log(f"[main] tagger WavLM-base-plus: {n_params} parameters, "
        f"{len(labels)} labels, 2 languages; {len(DURATIONS)} wavs of "
        f"{min(DURATIONS)}-{max(DURATIONS)} s")
    return cfg, ckpt, wav_dir


def phase_main(root: str, iters: int) -> dict:
    import torch
    from wfl_asr_tpu_torch.infer.pipeline import _get_session, \
        infer_folder_batched
    from wfl_asr_tpu_torch.labels import parse_lab
    from wfl_asr_tpu_torch.ops import kernels
    from wfl_asr_tpu_torch.ops.kernels import conv_fused, flash_attention, \
        flash_attention_bwd
    from wfl_asr_tpu_torch.ops.postprocess import confidence_gate_ids, \
        median_filter_ids

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
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_trainable": flash_attention_bwd.launches,
              "fused_conv_chain[1-3]": conv_fused.launches[(3, 3, 3)],
              "fused_conv_chain[4-6]": conv_fused.launches[(3, 2, 2)]}
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
    log(f"[main] kernel launches on the main path: {json.dumps(counts)}")
    missing = [k for k, n in counts.items() if n < 1]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")

    # batched forward with gate and median at B=8×30 s, as bench.py
    # defines it: unmasked rows, precomputed position bias, ids to host
    perf = {}
    samples = 30 * 16000
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(B, samples) * 0.1).astype(np.float32)
                             ).to("cuda")
    lang = torch.zeros(B, dtype=torch.int64, device="cuda")
    for name, dtype in (("bf16", bf16), ("f32", torch.float32)):
        session = _get_session(cfg, ckpt, "cuda", dtype)
        t_frames = session.num_frames_for(samples)
        pos_bias = session._pos_bias_for(t_frames)

        def step():
            with torch.inference_mode():
                logits, offsets = session.model(audio, lang,
                                                compute_dtype=dtype,
                                                pos_bias=pos_bias)
                ids = median_filter_ids(confidence_gate_ids(logits, 0.5, 0), 3)
            return ids, offsets

        step()[0].cpu()
        sync = []
        for _ in range(iters):
            t0 = time.perf_counter()
            step()[0].cpu()
            sync.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        outs = [step() for _ in range(iters)]
        for o in outs:
            o[0].cpu()
        pipelined = (time.perf_counter() - t0) / iters
        rate = B * samples / 16000.0 / pipelined
        perf[name] = dict(audio_s_per_s=rate, pipelined_ms=pipelined * 1e3,
                          sync_ms_median=float(np.median(sync)) * 1e3,
                          sync_ms_min=float(np.min(sync)) * 1e3,
                          frames=t_frames)
        log(f"[perf] batched forward + gate + median, B={B}×"
            f"{samples / 16000:g} s {name}: {rate:.2f} audio-s/s "
            f"(pipelined step {pipelined * 1e3:.2f} ms; sync step median "
            f"{np.median(sync) * 1e3:.2f} ms, min {np.min(sync) * 1e3:.2f} "
            f"ms; {iters} steps each)")
        if name == "bf16":
            profile_step(step)
            lstm_dtypes(session.model)
    return dict(perf=perf, counts=counts, cfg=cfg, ckpt=ckpt, wav_dir=wav_dir)


def profile_step(step) -> None:
    """Device time by kernel over one bf16 step (torch.profiler), and the
    device's busy share of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()[0].cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, spans = {}, []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
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
    log(f"[profile] one bf16 step: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (idle share {1 - busy / wall_us:.3f}), "
        f"{sum(v[1] for v in by_name.values())} kernels")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile] {us / 1e3:9.3f} ms {100 * us / max(total, 1):5.1f}% "
            f"x{count:<5d} {name[:90]}")


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

def phase_cross_device(cfg, ckpt: str, wav_dir: str) -> dict:
    """The card against the CPU in f32 (TF32 off): one 30 s utterance
    through ``forward`` (one full bucket, no masks), then the 8 wavs of
    unequal length in one masked batch through ``forward_many_decoded``."""
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
        log(f"[cross] {name}: {n_frames} valid frames, logits max_abs_diff="
            f"{err:.3e}, offsets {off_err:.3e}, .lab lines differing {d} of "
            f"{n}" + "".join(f"; card {x!r} vs CPU {y!r}" for x, y in shown))
        if not err <= CROSS_DEVICE_TOL:
            raise AssertionError(f"{name}: card vs CPU logits differ by {err} "
                                 f"(tol {CROSS_DEVICE_TOL})")
        worst, worst_off = max(worst, err), max(worst_off, off_err)
        diff, n_lines = diff + d, n_lines + n
    log(f"[cross] card vs CPU, f32 (TF32 off), every row's valid frames: "
        f"logits max_abs_diff={worst:.3e} (tol {CROSS_DEVICE_TOL}), offsets "
        f"{worst_off:.3e}; .lab lines differing: {diff} of {n_lines} (card "
        f"{secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s incl. load)")
    return dict(max_abs_err=worst, lab_lines_differing=diff,
                lab_lines=n_lines)


# ---------------------------------------------------------------------------

KERNEL_ROWS = [
    # (result key, name, counter name, source, TPU kernel replaced)
    ("K2", "flash_attention", "flash_attention",
     "wfl_asr_tpu_torch/ops/kernels/csrc/flash_attention.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention.py:75"),
    ("K1", "flash_attention_trainable", "flash_attention_trainable",
     "wfl_asr_tpu_torch/ops/kernels/csrc/flash_attention.cu",
     "wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:49"),
    ("K5a", "fused_conv_chain[1-3]", "fused_conv_chain[1-3]",
     "wfl_asr_tpu_torch/ops/kernels/csrc/conv_fused.cu",
     "wfl_asr_tpu/ops/pallas/conv_fused.py:135"),
    ("K5b", "fused_conv_chain[4-6]", "fused_conv_chain[4-6]",
     "wfl_asr_tpu_torch/ops/kernels/csrc/conv_fused.cu",
     "wfl_asr_tpu/ops/pallas/conv_fused.py:135"),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",), default=None)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from wfl_asr_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {sys.version.split()[0]}")
    t0 = time.time()
    logs = _build.build_all(list(KERNEL_SOURCES))
    log(f"[build] {', '.join(KERNEL_SOURCES)} in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    kern = phase_kernels(args.iters)
    if args.only == "kernels":
        return 0

    root = tempfile.mkdtemp(prefix="wfl_smoke_")
    try:
        run = phase_main(root, iters=args.iters)
        perf, counts = run["perf"], run["counts"]
        cross = phase_cross_device(run["cfg"], run["ckpt"], run["wav_dir"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rows = []
    for key, name, counter, source, replaces in KERNEL_ROWS:
        r = kern[(key, "bf16")]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[counter],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    log(f"[summary] bf16 B=8x30 s: {perf['bf16']['audio_s_per_s']:.2f} "
        f"audio-s/s, f32: {perf['f32']['audio_s_per_s']:.2f} audio-s/s; "
        f"card vs CPU logits {cross['max_abs_err']:.3e}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
