"""Driver of folder-labelling traffic: one closed-loop client that labels
folders of wavs, one ``infer_folder_batched`` call (a job) after another.

Set-up: the card, the kernels (built once into the checkout, then loaded),
seeded weights written as a checkpoint, the label files, a pool of folders
of seeded wavs, the program's session and one warm-up job. The window runs
jobs over the pool in turn until ``seconds`` have passed; before a folder
is used again its ``.wfl_cache`` is moved aside, so every job runs the
forward. A file counts when its ``.lab`` was written by the deadline; the
rate is their seconds of audio over the time from the window's start to
the last of those ``.lab`` writes. Traced (``--trace 1``), one more job on
the pool's first folder runs under the profiler after the window.

The check, once the window has closed and the program's state is freed:
a sample of the files labelled inside the window (drawn from the seed,
with the longest among them) against the plain reference run at each
file's exact length: the cached (language-averaged) logits and offsets,
and the widest gap by which the label the program put first lies below
the reference's best; and each sampled ``.lab`` against the reference's
postprocess of the program's own cached logits (files with a frame where
float32 rounding could flip the gate or the arg-max are not compared).
Every file of every job must have its ``.lab`` and cache entries.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import time

import numpy as np
import torch

from benchmark.core import program, seeds, traffic
from benchmark.core.card import (Laps, device_info, host_clock, host_delta,
                                 reference_model, spec_for, start, sync)
from benchmark.core.spans import Spans
from benchmark.core.trace import Trace, summarize
from benchmark.core.weights import make_state
from benchmark.reference import postprocess as ref_post
from benchmark.reference import lowered, strict_f32
from benchmark.reference.data import read_wav16
from benchmark.reference.tagger import export_state

LANGS = ["en", "ja"]








def reference_outputs(ref, audio: np.ndarray, num_languages: int, device,
                      dtype=torch.float32):
    """Language-averaged (logits [T, n], offsets [T, 2]) at the file's
    exact length, in float32 numpy."""
    x = torch.from_numpy(audio).to(device, dtype)[None].repeat(
        num_languages, 1)
    with torch.no_grad():
        lg, off = ref(x, torch.arange(num_languages, device=device))
    return (lg.float().mean(0).cpu().numpy(),
            off.float().mean(0).cpu().numpy())


def load_audio(path: str) -> np.ndarray:
    """The program's reading of a served file: samples over their peak
    (plus 1e-8), float32."""
    a = read_wav16(path)
    return (a / (np.max(np.abs(a)) + 1e-8)).astype(np.float32)


def compare(prog_logits, prog_offsets, ref_logits, ref_offsets):
    """(max |Δlogit|, max |ref logit|, widest gap of the program's first
    label below the reference's best, max |Δoffset|); a shape mismatch
    reads infinite."""
    if prog_logits.shape != ref_logits.shape or \
            prog_offsets.shape != ref_offsets.shape:
        return math.inf, 1.0, math.inf, math.inf
    err = float(np.abs(prog_logits - ref_logits).max())
    scale = float(np.abs(ref_logits).max())
    pick = prog_logits.argmax(-1)
    gap = float((ref_logits.max(-1)
                 - np.take_along_axis(ref_logits, pick[:, None], -1)[:, 0]
                 ).max())
    return err, scale, gap, float(np.abs(prog_offsets - ref_offsets).max())


def run(ctx: dict) -> dict:
    cfg, tr, device = ctx["config"], ctx["traffic"], ctx["device"]
    work, seed, seconds = ctx["work"], ctx["seed"], ctx["seconds"]
    lap = Laps(ctx["t_start"])

    # -- set-up -----------------------------------------------------------
    from wfl_asr_tpu_torch.infer import pipeline
    start(device, lap)

    labels = traffic.labels_list()
    save_dir = os.path.join(work, "run")
    program.write_label_files(save_dir, labels, LANGS)
    pcfg = program.program_config(cfg, save_dir,
                                  postprocess=tr["postprocess"])
    spec = spec_for(cfg)
    state = make_state(spec, seeds.sub_seed(seed, "weights"), device)
    ckpt = os.path.join(work, "tagger.pt")
    torch.save(export_state(state), ckpt)
    del state
    lap("weights_s")

    durs = traffic.durations_of(tr, tr["folders"] * tr["files_per_folder"])
    pool = traffic.folder_pool(os.path.join(work, "pool"), tr["folders"],
                               tr["files_per_folder"], durs,
                               seeds.sub_seed(seed, "audio"), device)
    samples = {}           # (folder, name) → samples
    for k, folder in enumerate(pool):
        for i in range(tr["files_per_folder"]):
            samples[(k, f"{i:03d}.wav")] = int(
                durs[k * tr["files_per_folder"] + i] * traffic.SR)
    lap("data_s")

    labs = []              # (host time, path) of each .lab written
    spans = Spans()
    save_lab = pipeline.save_lab

    def timed_save_lab(path, segments):
        save_lab(path, segments)
        labs.append((time.perf_counter(), path))

    pipeline.save_lab = timed_save_lab
    jobs = []              # (job, folder, t0, t1, out dir, cache dir)
    dtype = torch.float32 if tr["compute_dtype"] == "float32" \
        else torch.bfloat16

    def job(j: int, k: int) -> None:
        out = os.path.join(work, "out", f"job{j:03d}")
        t0 = time.perf_counter()
        pipeline.infer_folder_batched(
            pool[k], pcfg, ckpt, out, lang_id=tr["lang_id"],
            confidence_threshold=tr["postprocess"]["confidence_threshold"],
            batch_files=tr["batch_files"], device=device,
            compute_dtype=dtype)
        t1 = time.perf_counter()
        cache = os.path.join(work, "caches", f"job{j:03d}")
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        os.rename(os.path.join(pool[k], ".wfl_cache"), cache)
        jobs.append((j, k, t0, t1, out, cache))

    try:
        job(-1, 0)                                      # warm-up
        shutil.rmtree(jobs[-1][4])
        shutil.rmtree(jobs[-1][5])
        jobs.clear()
        labs.clear()
        lap("warmup_s")
        setup_s = time.perf_counter() - ctx["t_start"]

        if ctx["trace"]:
            _install_spans(spans)
        # -- window ---------------------------------------------------------
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync(device)
        host0 = host_clock()
        w0 = time.perf_counter()
        deadline = w0 + seconds
        j = 0
        while time.perf_counter() < deadline:
            job(j, j % len(pool))
            j += 1
        host = host_delta(host0, host_clock())
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        trace_info = None
        if ctx["trace"]:
            # the traced jobs take the pool's first folders whatever the
            # window ran, so that every traced run reads the same files
            folders = [i % len(pool) for i in range(tr["trace_jobs"])]
            trace_info = _traced_jobs(job, j, folders, device)
            trace_info["trace_audio_s"] = sum(
                n for (k, _name), n in samples.items()
                if k in folders) / traffic.SR
    finally:
        pipeline.save_lab = save_lab
        spans.restore()
        pipeline._SESSION_CACHE.clear()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    window_jobs = [x for x in jobs if x[2] < deadline]
    written = {p: t for t, p in labs if t <= deadline}
    # the window closes at its last answer: the time after it is work in
    # flight, whose answers fall after the deadline
    window_s = (max(written.values()) - w0) if written else seconds
    files = []             # (job, folder, name, samples, lab path, cache)
    for jj, k, t0, t1, out, cache in jobs:
        for name in sorted(os.listdir(pool[k])):
            if name.endswith(".wav"):
                lab = os.path.join(out, name[:-4] + ".lab")
                files.append((jj, k, name, samples[(k, name)], lab, cache))
    # counted: written by the deadline; due (judged): every file of a job
    # the window started, its answer late or not
    counted = [f for f in files if f[4] in written]
    due_files = [f for f in files if f[0] in {x[0] for x in window_jobs}]
    audio_s = sum(f[3] for f in counted) / traffic.SR
    rate = audio_s / window_s

    # -- check ----------------------------------------------------------------
    checks = check(cfg, tr, ctx["limits"]["limits"], labels, pool, files,
                   due_files, seed, device)
    failed = int(checks["missing"][0]) + int(checks["lab_mismatch"][0])
    correct = all(v <= lim for v, lim in checks.values())

    run = {
        "setup_split": lap.split, "correct": correct,
        "attempted": len(due_files), "failed": failed,
        "checks": [(n, v, lim) for n, (v, lim) in checks.items()],
        "e2e": {"label_audio_s_per_s": rate, "setup_s": setup_s},
        "device": device_info(device, peak),
        "cfg": cfg, "num_labels": len(labels), "window_s": window_s,
        "window_jobs": window_jobs, "counted_files": counted,
        "spans": spans, "window": (w0, deadline),
        "batch_files": tr["batch_files"], "host": host,
    }
    if trace_info is not None:
        run.update(trace_info)
        run["device"].update(busy_s=trace_info["trace"]["busy_s"],
                             window_s=trace_info["trace"]["window_s"])
        run["breakdown"] = {"device_ops": trace_info["trace"]["device_ops"],
                            "idle_gaps": trace_info["trace"]["idle_gaps"]}
    return run




def _attn_info(q, k, v, bias=None, gate=None, kv_len=None, *a, **kw):
    return (tuple(q.shape), q.dtype, bias is not None, kv_len)


def _attn_info_trainable(q, k, v, kv_len=None, *a, **kw):
    return (tuple(q.shape), q.dtype, False, kv_len)


def _conv_info(x, ws, *a, **kw):
    return (tuple(x.shape), x.dtype, [int(w.shape[-1]) for w in ws])


def _install_spans(spans: Spans) -> None:
    spans.wrap("wfl_asr_tpu_torch.infer.pipeline:InferenceSession"
               ".forward_many", "bench.forward_many")
    spans.wrap("wfl_asr_tpu_torch.infer.pipeline:read_wav", "bench.read_wav")
    spans.wrap("wfl_asr_tpu_torch.infer.pipeline:_decode_segment",
               "bench.decode")
    spans.wrap("wfl_asr_tpu_torch.infer.pipeline:_cache_save",
               "bench.cache_save")
    spans.wrap("wfl_asr_tpu_torch.models.wavlm:flash_attention",
               "bench.attn_fwd", _attn_info)
    spans.wrap("wfl_asr_tpu_torch.models.heads:flash_attention_trainable",
               "bench.attn_fwd", _attn_info_trainable)
    spans.wrap("wfl_asr_tpu_torch.models.whisper:flash_attention_trainable",
               "bench.attn_fwd", _attn_info_trainable)
    spans.wrap("wfl_asr_tpu_torch.models.wavlm:fused_conv_chain",
               "bench.conv_fe", _conv_info)


def _traced_jobs(job, j, folders, device) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device == "cuda" else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            for i, k in enumerate(folders):
                job(j + i, k)
            sync(device)
    t1 = time.perf_counter()
    trace = Trace(prof)
    under = {name: trace.device_s_under(name)
             for name in ("bench.attn_fwd", "bench.conv_fe")}
    return {"trace": summarize(trace), "trace_host": (t0, t1),
            "device_under": under}


def check(cfg, tr, limits, labels, pool, files, due_files, seed,
          device) -> dict:
    """{name: (value, limit)}."""
    missing = sum(
        1 for jj, k, name, n, lab, cache in files
        if not (os.path.exists(lab) and os.path.exists(os.path.join(
            cache, name[:-4] + "_avg_logits.pt"))))
    chosen = sample(due_files, tr["check"]["files"], seed)
    if not chosen:
        raise RuntimeError("no job started in the window: nothing to check")
    with strict_f32():
        err, gap, off_err, mismatch = _compare_sample(
            cfg, tr, labels, pool, chosen, seed, device)
    return {"logit_err": (err, limits["logit_err"]),
            "logit_gap": (gap, limits["logit_gap"]),
            "offset_err": (off_err, limits["offset_err"]),
            "lab_mismatch": (mismatch, 0), "missing": (missing, 0)}


def _compare_sample(cfg, tr, labels, pool, chosen, seed, device):
    state = make_state(spec_for(cfg), seeds.sub_seed(seed, "weights"),
                       device)
    ref = reference_model(cfg, state, device)
    del state
    err = gap = off_err = 0.0
    mismatch = 0
    thr = tr["postprocess"]["confidence_threshold"]
    for jj, k, name, n, lab, cache in chosen:
        base = os.path.join(cache, name[:-4] + "_avg_")
        if not (os.path.exists(base + "logits.pt") and os.path.exists(lab)):
            continue                       # counted under "missing"
        pl = torch.load(base + "logits.pt").numpy()
        po = torch.load(base + "offsets.pt").numpy()
        rl, ro = reference_outputs(ref, load_audio(os.path.join(pool[k], name)),
                                   cfg["assumed"]["num_languages"], device)
        e, scale, g, oe = compare(pl, po, rl, ro)
        err, gap, off_err = max(err, e / scale), max(gap, g), max(off_err,
                                                                   oe)
        if ref_post.ambiguous_frames(pl, thr).any():
            continue
        with open(lab) as f:
            text = f.read()
        if text != ref_post.label_file(pl, po, labels, thr,
                                       tr["postprocess"]["median_filter"]):
            mismatch += 1
    del ref
    if device == "cuda":
        torch.cuda.empty_cache()
    return err, gap, off_err, mismatch


def sample(files, want: int, seed: int):
    """The longest of ``files`` (item 3: samples) and ``want`` − 1 others
    drawn from the check's seed."""
    if not files:
        return []
    rng = np.random.default_rng(seeds.sub_seed(seed, "check"))
    longest = max(range(len(files)), key=lambda i: files[i][3])
    rest = [i for i in range(len(files)) if i != longest]
    pick = rng.choice(len(rest), size=min(want - 1, len(rest)),
                      replace=False) if rest else []
    return [files[longest]] + [files[rest[i]] for i in pick]


def control(cfg, tr, seed, device, work, precision: str = "bf16") -> dict:
    """The control's readings at the cell's size: the reference computed in
    ``precision`` (``reference.lowered``) in the program's place, on the
    files a run would sample, against the float32 reference."""
    durs = traffic.durations_of(tr, tr["folders"] * tr["files_per_folder"])
    pool = traffic.folder_pool(os.path.join(work, "pool"), tr["folders"],
                               tr["files_per_folder"], durs,
                               seeds.sub_seed(seed, "audio"), device)
    files = [(0, k, f"{i:03d}.wav", int(durs[k * tr["files_per_folder"] + i]
                                        * traffic.SR))
             for k in range(tr["folders"])
             for i in range(tr["files_per_folder"])]
    chosen = sample(files, tr["check"]["files"], seed)
    err = gap = off_err = 0.0
    state = make_state(spec_for(cfg), seeds.sub_seed(seed, "weights"),
                       device)
    with lowered(precision) as dtype:
        low = reference_model(cfg, state, device, dtype)
    ref = reference_model(cfg, state, device)
    del state
    n_lang = cfg["assumed"]["num_languages"]
    for _j, k, name, _n in chosen:
        audio = load_audio(os.path.join(pool[k], name))
        with strict_f32():
            rl, ro = reference_outputs(ref, audio, n_lang, device)
        with lowered(precision) as dtype:
            cl, co = reference_outputs(low, audio, n_lang, device, dtype)
        e, scale, g, oe = compare(cl, co, rl, ro)
        err, gap, off_err = max(err, e / scale), max(gap, g), \
            max(off_err, oe)
    return {"logit_err": err, "logit_gap": gap, "offset_err": off_err}
