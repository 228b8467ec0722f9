"""Driver of training traffic: the recipe of a traffic file driven through
the program's ``train()`` on a seeded corpus.

Set-up: the card, the kernels, a corpus of seeded wavs and ``.lab`` files,
the program's ``preprocess`` of it, seeded weights (put into the model that
``train()`` builds, by wrapping the ``init_tagger`` it calls), and the
first updates (``warmup_updates``). Those first updates run through
``train()``'s own loop and loader on rows that all differ, and are the
ones the check follows: each update's loss, each parameter's gradient
norm as the optimizer gets it at the first update, and each parameter's
change after ``checked_updates`` updates. The window then runs from the
end of the warm-up updates until ``seconds`` have passed, stamped through
``train()``'s ``on_update`` hook, and closes with a synchronize after its
last update. Its rate is the real (unpadded) seconds of audio of every
update in it over its time. Traced (``--trace 1``), the ``trace_updates``
updates right after the warm-up run under the profiler, the same batches
in every run, and the window follows them.

The check, once the window has closed and the program is freed: the plain
reference works the same updates out again from the corpus files, the
seed and the same weights (its own labels, split, batch order,
augmentation, collation, forward, loss, backward and Prodigy), and each
number is the worst over parameters of the gap between the two norms,
over the larger of the reference's norm and the median parameter's.
Parameters whose reference gradient is under a thousandth of the median
parameter's (a key bias under softmax, a bias before BatchNorm: zero but
for rounding) are left out of the change, whose direction rounding sets.

Dropout: during the checked updates the program's dropout calls are
wrapped so that each one's keep mask is recorded (the same call run again
on ones from the same generator state, which must end in the same state),
and the reference drops the same elements. ``masks_off`` counts the masks
that are not inverted dropout at the configured rate (a value other than 0
and 1/(1 − rate), or a keep share more than six standard deviations from
1 − rate), each mask that does not fit the reference's tensor at its
site, and every update whose number of dropout calls differs from the
reference's sites.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from benchmark.core import program, seeds, traffic
from benchmark.core.card import (Laps, device_info, host_clock, host_delta,
                                 spec_for, start, sync)
from benchmark.core.spans import Spans
from benchmark.core.trace import Trace, summarize
from benchmark.core.weights import make_state
from benchmark.reference import lowered, strict_f32
from benchmark.reference.data import Corpus
from benchmark.reference.losses import tagger_loss
from benchmark.reference.prodigy import Prodigy
from benchmark.reference.tagger import DropFeed, Tagger, export_state

# the program's modules whose ``dropout`` the checked updates record
DROPOUT_MODULES = ("wfl_asr_tpu_torch.models.heads",
                   "wfl_asr_tpu_torch.models.wavlm",
                   "wfl_asr_tpu_torch.models.whisper")


class WindowClosed(Exception):
    pass


def run(ctx: dict) -> dict:
    cfg, tr, device = ctx["config"], ctx["traffic"], ctx["device"]
    work, seed, seconds = ctx["work"], ctx["seed"], ctx["seconds"]
    lap = Laps(ctx["t_start"])
    from wfl_asr_tpu_torch.models import tagger as ptagger
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop
    start(device, lap)

    per = tr["files_per_language"]
    durs = traffic.durations_of(tr, per * len(tr["languages"]))
    data_dir = os.path.join(work, "corpus")
    traffic.corpus(data_dir, tr["languages"], per, durs,
                   seeds.sub_seed(seed, "audio"), device)
    save_dir = os.path.join(work, "run")
    pcfg = program.program_config(
        cfg, save_dir, data_dir=data_dir, training=tr["training"],
        augmentation=tr["augmentation"], num_val=tr["num_val_files"])
    preprocess(data_dir, pcfg)
    lap("data_s")

    spec = spec_for(cfg)
    wseed = seeds.sub_seed(seed, "weights")
    state = export_state(make_state(spec, wseed, device))
    lap("weights_s")

    checked = tr["checked_updates"]
    warm = max(tr["warmup_updates"], checked)
    rec = {"losses": [], "grad_norms": None, "change_norms": None,
           "rows": [], "model": None, "optimizer": None, "masks": [],
           "masks_off": 0}
    real_init = loop.init_tagger
    real_make_opt = loop.make_optimizer
    real_micro = loop.micro_step

    def init_tagger(arch, generator, device=device):
        with torch.device(device):
            model = ptagger.BIOPhonemeTagger(arch)
        model.load_state_dict(state, strict=True)
        rec["model"] = model
        return model.to(device).eval()

    def make_optimizer(*a, **kw):
        opt = real_make_opt(*a, **kw)
        step = opt.step

        def first_step(*sa, **skw):
            rec["grad_norms"] = {
                n: (p.grad.float().norm() if p.grad is not None
                    else torch.zeros((), device=p.device))
                for n, p in rec["model"].named_parameters()}
            opt.step = step
            return step(*sa, **skw)

        opt.step = first_step
        rec["optimizer"] = opt
        return opt

    def micro_step(*a, **kw):
        if len(rec["masks"]) < checked:
            rec["masks"].append([])
        out = real_micro(*a, **kw)
        if len(rec["losses"]) < checked:
            rec["losses"].append(out[0]["loss"].detach().clone())
        return out

    spans = Spans()
    win = {"t0": None, "updates": [], "traced": 0}
    prof = [None]

    def on_update(step, batches):
        now = time.perf_counter()
        if step <= checked:
            rec["rows"].append([p for b in batches for p in b["wav_paths"]])
        if step == checked:
            start = make_state(spec, wseed, device)
            rec["change_norms"] = {
                n: (p.detach() - start[n]).float().norm()
                for n, p in rec["model"].named_parameters()}
            del start
            loop.micro_step = real_micro
            restore_dropout()
        if step < warm:
            return
        if ctx["trace"] and win["traced"] < tr["trace_updates"]:
            # traced: the updates right after the warm-up (the same batches
            # in every run), before the window and apart from it
            if prof[0] is None:
                spans.wrap("wfl_asr_tpu_torch.train.loop:micro_step",
                           "bench.forward_backward")
                sync(device)
                prof[0] = _start_profile(device)
                win["mark"] = torch.profiler.record_function("bench.window")
                win["mark"].__enter__()
                win["trace_t0"] = time.perf_counter()
                return
            win["traced"] += 1
            win["trace_audio_s"] = win.get("trace_audio_s", 0.0) + sum(
                len(w) for b in batches for w in b["wavs"]) / traffic.SR
            if win["traced"] < tr["trace_updates"]:
                return
            sync(device)
            win["trace_t1"] = time.perf_counter()
            win["mark"].__exit__(None, None, None)
            prof[0].__exit__(None, None, None)
        if win["t0"] is None:
            sync(device)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            lap("warmup_s")
            win["setup_s"] = time.perf_counter() - ctx["t_start"]
            win["host0"] = host_clock()
            win["t0"] = time.perf_counter()
            return
        win["updates"].append([
            (len(w), int(n)) for b in batches
            for w, n in zip(b["wavs"], b["label_lengths"])])
        if now - win["t0"] >= seconds:
            sync(device)
            win["t1"] = time.perf_counter()
            win["host"] = host_delta(win["host0"], host_clock())
            win["peak"] = (torch.cuda.max_memory_allocated()
                           if device == "cuda" else 0)
            raise WindowClosed

    loop.init_tagger, loop.make_optimizer = init_tagger, make_optimizer
    loop.micro_step = micro_step
    restore_dropout = _record_dropout(rec)
    if ctx["trace"]:
        _install_spans(spans)
    try:
        loop.train(pcfg, device=device, on_update=on_update)
    except WindowClosed:
        pass
    finally:
        loop.init_tagger, loop.make_optimizer = real_init, real_make_opt
        loop.micro_step = real_micro
        restore_dropout()
        spans.restore()
        if prof[0] is not None and "trace_t1" not in win:
            prof[0].__exit__(None, None, None)
    trace_info = None
    if prof[0] is not None:
        trace = Trace(prof[0])
        trace_info = {"trace": summarize(trace),
                      "trace_host": (win["trace_t0"], win["trace_t1"]),
                      "trace_audio_s": win["trace_audio_s"],
                      "device_under": {"bench.attn_bwd": trace.device_s_under(
                          "bench.attn_bwd")}}
    num_params = sum(p.numel() for p in rec["model"].parameters())
    losses = [float(x) for x in rec["losses"]]
    # a program that never stepped its optimizer, or never reached the
    # checked update, has no reading: every parameter reads as missing
    grad_norms = {n: float(v) for n, v in (rec["grad_norms"] or {}).items()}
    change_norms = {n: float(v)
                    for n, v in (rec["change_norms"] or {}).items()}
    rows, masks = rec["rows"], rec["masks"]
    masks_off = rec["masks_off"]
    rec.clear()
    del state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    checks = check(cfg, tr, ctx["limits"]["limits"], data_dir, spec, wseed,
                   rows, losses, grad_norms, change_norms, masks, masks_off,
                   device)
    correct = all(v <= lim for v, lim in checks.values())
    window_s = win["t1"] - win["t0"]
    audio_s = sum(n for u in win["updates"] for n, _ in u) / traffic.SR
    run = {
        "setup_split": lap.split, "correct": correct,
        "attempted": checked, "failed": sum(
            1 for v, lim in checks.values() if not v <= lim),
        "checks": [(n, v, lim) for n, (v, lim) in checks.items()],
        "e2e": {"train_audio_s_per_s": audio_s / window_s,
                "setup_s": win["setup_s"]},
        "device": device_info(device, win["peak"]),
        "cfg": cfg, "num_labels": len(traffic.labels_list()),
        "num_params": num_params, "window_s": window_s,
        "window_updates": win["updates"], "spans": spans,
        "window_host": (win["t0"], win["t1"]), "host": win["host"],
    }
    if trace_info is not None:
        run.update(trace_info)
        run["device"].update(busy_s=trace_info["trace"]["busy_s"],
                             window_s=trace_info["trace"]["window_s"])
        run["breakdown"] = {"device_ops": trace_info["trace"]["device_ops"],
                            "idle_gaps": trace_info["trace"]["idle_gaps"]}
    return run


def _rng(generator, device):
    """(get_state, set_state) of the stream a dropout call draws from: a
    pair's local stream, a generator, or the device's default one."""
    g = getattr(generator, "local", generator)
    if g is not None:
        return g.get_state, g.set_state
    if torch.device(device).type == "cuda":
        return torch.cuda.get_rng_state, torch.cuda.set_rng_state
    return torch.get_rng_state, torch.set_rng_state


def _record_dropout(rec):
    """Wrap the program's ``dropout`` in :data:`DROPOUT_MODULES`: while
    ``rec["masks"]`` holds an update's list, each call that drops records
    its keep mask there (on the host). Returns the function that puts the
    program's own back."""
    import importlib
    mods = [importlib.import_module(m) for m in DROPOUT_MODULES]
    real = {m: m.dropout for m in mods}

    def make(real_fn):
        def dropout(x, rate, generator=None, training=True):
            if not training or rate <= 0.0 or not rec["masks"]:
                return real_fn(x, rate, generator, training)
            get, put = _rng(generator, x.device)
            before = get()
            y = real_fn(x, rate, generator, training)
            after = get()
            put(before)
            m = real_fn(torch.ones_like(x), rate, generator, training)
            keep = m != 0
            scale = torch.ones((), dtype=x.dtype, device=x.device) / (
                1.0 - rate)
            share = float(keep.float().mean())
            sd = (rate * (1.0 - rate) / max(m.numel(), 1)) ** 0.5
            rec["masks_off"] += int(
                not torch.equal(get(), after)
                or bool((keep & (m != scale)).any())
                or abs(share - (1.0 - rate)) > 6 * sd)
            rec["masks"][-1].append(keep.cpu())
            return y
        return dropout

    for m in mods:
        m.dropout = make(real[m])

    def restore():
        for m in mods:
            m.dropout = real[m]
    return restore


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _bwd_info(ctx, *a):
    q, k, v, bias, gate, kv, out, lse, seed = ctx.saved_tensors
    return (tuple(q.shape), q.dtype, bias is not None, kv)


def _install_spans(spans: Spans) -> None:
    spans.wrap_iter("wfl_asr_tpu_torch.data.dataset:BatchLoader"
                    ".epoch_batches", "bench.loader_next")
    spans.wrap("wfl_asr_tpu_torch.train.loop:apply_update",
               "bench.optimizer")
    spans.wrap("wfl_asr_tpu_torch.train.loop:decode_bio_tags",
               "bench.host_metric")
    for target in ("wfl_asr_tpu_torch.ops.kernels.flash_attention:"
                   "_FlashAttention.backward",
                   "wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd:"
                   "_FlashAttentionTrainable.backward"):
        spans.wrap(target, "bench.attn_bwd", _bwd_info, static=True)


def _worst_gap(prog: dict, ref: dict, names) -> float:
    """Worst over ``names`` of |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    names = list(names)
    if not names:
        return 0.0
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog.get(n, float("inf")) - ref[n]) / max(ref[n], med,
                                                              1e-30)
               for n in names)


def drop_sites(cfg) -> int:
    """The number of dropout calls an update of the reference makes."""
    with torch.device("meta"):
        model = Tagger(cfg, cfg["assumed"]["num_labels"],
                       cfg["assumed"]["num_languages"])
    return len(model.drop_sites)


def reference_steps(cfg, tr, data_dir, spec, wseed, n_steps, device,
                    feed: DropFeed, dtype=torch.float32, fault: str = None):
    """The reference's first ``n_steps`` updates: (rows, losses, first
    gradient norms, change norms), by parameter name, with the keep masks
    of ``feed``. ``fault`` plants one of the faults the check must see:
    "half" (each batch's second half left out, the mean taken over the
    rest), "label" (the first row's labels moved to the next tag)."""
    corpus = Corpus(data_dir)
    t = tr["training"]
    train_idx, _ = corpus.split(t["seed"], tr["num_val_files"])
    batches = corpus.batches(train_idx, t["seed"], 0, t["batch_size"])
    state = make_state(spec, wseed, device)
    model = Tagger(cfg, len(corpus.labels), corpus.num_languages,
                   checkpoint_layers=True).to(device)
    model.load_state_dict(state)
    model.to(dtype).train()
    model.set_feed(feed)
    params = dict(model.named_parameters())
    opt = Prodigy(list(params.values()), lr=t["learning_rate"],
                  betas=tuple(t["optimizer_params"]["betas"]),
                  eps=t["optimizer_params"]["eps"],
                  weight_decay=t["weight_decay"])
    rows, losses, grads = [], [], None
    for step in range(n_steps):
        feed.step = step
        idxs = batches[step]
        rows.append([corpus.items[i]["wav"] for i in idxs])
        audio, labels, langs, targets, lab_len = corpus.collate(
            idxs, t["seed"], 0, tr["augmentation"])
        if fault == "half":
            n = len(idxs) // 2
            audio, labels, langs, targets = (audio[:n], labels[:n],
                                             langs[:n], targets[:n])
        elif fault == "label":
            row = labels[0]
            row[row >= 0] = (row[row >= 0] + 1) % len(corpus.labels)
        logits, offsets = model(torch.from_numpy(audio).to(device, dtype),
                                torch.from_numpy(langs).to(device),
                                max_label_len=lab_len)
        loss = tagger_loss(logits, offsets,
                           torch.from_numpy(labels).to(device), targets,
                           t["label_smoothing"],
                           cfg["heads"]["subframe_loss_weight"])
        loss.backward()
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {n: float(p.grad.float().norm()) for n, p in
                     params.items()}
        opt.step()
        for p in params.values():
            p.grad = None
    change = {n: float((p.detach().float()
                        - state[n].to(dtype).float()).norm())
              for n, p in params.items()}
    del model, opt, state
    return rows, losses, grads, change


def check(cfg, tr, limits, data_dir, spec, wseed, rows, losses, grad_norms,
          change_norms, masks, masks_off, device) -> dict:
    n = tr["checked_updates"]
    feed = DropFeed({(step, site): keep for step, ms in enumerate(masks)
                     for site, keep in enumerate(ms)})
    with strict_f32():
        r_rows, r_losses, r_grads, r_change = reference_steps(
            cfg, tr, data_dir, spec, wseed, n, device, feed)
    if device == "cuda":
        torch.cuda.empty_cache()
    sites = drop_sites(cfg)
    masks_off += feed.misfits + abs(len(masks) - n) + sum(
        abs(len(ms) - sites) for ms in masks)
    return dict(numbers(limits, rows, losses, grad_norms, change_norms,
                        r_rows, r_losses, r_grads, r_change),
                masks_off=(masks_off, 0))


def numbers(limits, rows, losses, grads, change, r_rows, r_losses, r_grads,
            r_change) -> dict:
    """{name: (value, limit)} of the program's first updates against the
    reference's."""
    rows_differ = sum(a != b for a, b in zip(rows, r_rows)) + abs(
        len(rows) - len(r_rows))
    loss_gap = max((abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
                   default=float("inf"))
    if len(losses) != len(r_losses):
        loss_gap = float("inf")
    med = float(np.median(list(r_grads.values())))
    moved = [k for k, g in r_grads.items() if g >= 1e-3 * med]
    return {"rows_differ": (rows_differ, 0),
            "loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (_worst_gap(grads, r_grads, r_grads),
                         limits["grad_gap"]),
            "change_gap": (_worst_gap(change, r_change, moved),
                           limits["change_gap"])}


def _corpus(tr, seed, device, work) -> str:
    per = tr["files_per_language"]
    durs = traffic.durations_of(tr, per * len(tr["languages"]))
    data_dir = os.path.join(work, "corpus")
    traffic.corpus(data_dir, tr["languages"], per, durs,
                   seeds.sub_seed(seed, "audio"), device)
    return data_dir


def _seeded_feed(seed: int, device) -> DropFeed:
    """Keep masks drawn by the benchmark from the check's seed, for runs
    with no program: the same ones to both sides."""
    return DropFeed(generator=torch.Generator(device=device).manual_seed(
        seeds.sub_seed(seed, "check")))


def control(cfg, tr, seed, device, work, precision: str = "bf16") -> dict:
    """The control's readings at the cell's size: the reference's first
    updates in the program's place, computed in ``precision``
    (``reference.lowered``), against its float32 ones, on the corpus a run
    with ``seed`` trains on and with the same dropout masks."""
    data_dir = _corpus(tr, seed, device, work)
    spec, wseed = spec_for(cfg), seeds.sub_seed(seed, "weights")
    n, feed = tr["checked_updates"], _seeded_feed(seed, device)
    with strict_f32():
        ref = reference_steps(cfg, tr, data_dir, spec, wseed, n, device,
                              feed)
    if device == "cuda":
        torch.cuda.empty_cache()
    with lowered(precision) as dtype:
        low = reference_steps(cfg, tr, data_dir, spec, wseed, n, device,
                              feed, dtype)
    limits = {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    return {k: v for k, (v, _) in numbers(limits, *low, *ref).items()}


def faults(cfg, tr, seed, device, work) -> dict:
    """Readings of the faults a training cell can have, planted in the
    reference put in the program's place, at the cell's size: {fault:
    {number: reading}} against the clean reference. A step that leaves the
    state unchanged reads 1 by the change's measure and needs no run."""
    data_dir = _corpus(tr, seed, device, work)
    spec, wseed = spec_for(cfg), seeds.sub_seed(seed, "weights")
    n, feed = tr["checked_updates"], _seeded_feed(seed, device)
    limits = {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    out = {}
    with strict_f32():
        ref = reference_steps(cfg, tr, data_dir, spec, wseed, n, device,
                              feed)
        for fault in ("half", "label"):
            if device == "cuda":
                torch.cuda.empty_cache()
            bad = reference_steps(cfg, tr, data_dir, spec, wseed, n, device,
                                  feed, fault=fault)
            out[fault] = {k: v for k, (v, _) in numbers(
                limits, ref[0], *bad[1:], *ref).items() if k != "rows_differ"}
    return out
