"""Remat at Whisper-large-v3's shape, narrowed, on the CPU: a tiny Whisper
encoder with large-v3's 128 mel bins under config.yaml's heads (the
benchmark's ``whisper-large-v3`` configuration at a width of 64), its
weights drawn as the benchmark draws them and exported to the plain
reference's names (``benchmark/reference``).

- One remat update (forward, losses, backward) equals the same update
  without remat, bit for bit, and matches the reference's
  ``Tagger(checkpoint_layers=True)`` given the program's dropout masks.
- ``wfl.recompute`` records once per checkpointed layer and micro-batch
  while a profiler records, on the thread that runs the backward, with
  the layer's index; nothing without remat, nothing with the profiler off.
- The training loop's ``wfl.update`` counts the layers recomputed in it
  (``recomputed``).

    python -m pytest tests/test_torch_remat_trace.py -q
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from benchmark.core import program, traffic
from benchmark.core.card import spec_for
from benchmark.core.weights import make_state
from benchmark.drivers import train_corpus
from benchmark.reference import strict_f32
from benchmark.reference.losses import offset_targets, tagger_loss
from benchmark.reference.tagger import DropFeed, Tagger, export_state
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.ops.kernels import flash_attention as FA
from wfl_asr_tpu_torch.ops.kernels import flash_attention_bwd as FAB
from wfl_asr_tpu_torch.train import losses as TL
from wfl_asr_tpu_torch.train import loop as TLOOP
from wfl_asr_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
LAYERS = 2
SMOOTHING = 0.1


def _cfg() -> dict:
    with open(os.path.join(HERE, "..", "benchmark", "configs",
                           "whisper-large-v3.json")) as f:
        cfg = json.load(f)
    assert cfg["num_mel_bins"] == 128
    cfg.update(d_model=64, encoder_layers=LAYERS, encoder_attention_heads=2,
               encoder_ffn_dim=128)
    return cfg


CFG = _cfg()
NUM_LABELS = CFG["assumed"]["num_labels"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def state():
    """The benchmark's seeded weights under the reference's names."""
    return export_state(make_state(spec_for(CFG), 20241, "cpu"))


def _program(state):
    pcfg = program.program_config(CFG, "unused")
    arch = PT.TaggerArch.from_config(Config(pcfg), NUM_LABELS)
    model = PT.BIOPhonemeTagger(arch)
    model.load_state_dict(state, strict=True)
    return model


def _batch(seed=3):
    """Two rows of unequal audio with their labels and segments; the
    program's offset targets and the reference's."""
    rng = np.random.RandomState(seed)
    lens, max_label = (40, 31), 50
    audio = (rng.randn(2, 16000) * 0.3).astype(np.float32)
    audio[1, 12400:] = 0.0
    labels = np.full((2, max_label), -100, np.int64)
    segs = []
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(0, NUM_LABELS, size=n)
        segs.append([(0.0, 0.07 + 0.01 * i, "a"), (0.07 + 0.01 * i, 0.3, "b"),
                     (0.3, 0.61, "a")])
    t = [TL.offset_targets_from_segments(s, 0.02, n, 16)
         for s, n in zip(segs, lens)]
    f, c, x, v = (np.stack([row[j] for row in t]) for j in range(4))
    batch = {"audio": audio, "labels": labels,
             "lang_ids": np.array([0, 1], np.int32), "off_frames": f,
             "off_channels": c, "off_fracs": x, "off_valid": v,
             "label_lengths": np.array(lens, np.int32),
             "max_label_len": max_label}
    ref_targets = [offset_targets(s, 0.02, n) for s, n in zip(segs, lens)]
    return batch, ref_targets


def _update(state, remat, batch, n_micro=1):
    """The program's micro-steps in training mode: (losses, gradients)."""
    model = _program(state)
    gen = torch.Generator().manual_seed(11)
    losses = [TLOOP.micro_step(model, batch, "cpu", n_micro, SMOOTHING,
                               CFG["heads"]["subframe_loss_weight"],
                               generator=gen, remat=remat)[0]["loss"]
              for _ in range(n_micro)]
    return losses, {n: p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None}


def test_remat_update_equals_plain_and_the_reference(state):
    batch, ref_targets = _batch()
    plain_loss, plain_grads = _update(state, False, batch)
    rec = {"masks": [[]], "masks_off": 0}
    restore = train_corpus._record_dropout(rec)
    try:
        remat_loss, remat_grads = _update(state, True, batch)
    finally:
        restore()
    # the recompute repeats the first pass's arithmetic and its draws
    assert torch.equal(remat_loss[0], plain_loss[0])
    assert remat_grads.keys() == plain_grads.keys()
    for n, g in plain_grads.items():
        assert torch.equal(remat_grads[n], g), n
    assert rec["masks_off"] == 0 and rec["masks"][0]

    feed = DropFeed({(0, site): keep
                     for site, keep in enumerate(rec["masks"][0])})
    ref = Tagger(CFG, NUM_LABELS, CFG["assumed"]["num_languages"],
                 checkpoint_layers=True)
    ref.load_state_dict(state)
    ref.train()
    ref.set_feed(feed)
    with strict_f32():
        logits, offsets = ref(torch.from_numpy(batch["audio"]),
                              torch.from_numpy(batch["lang_ids"]),
                              max_label_len=batch["max_label_len"])
        loss = tagger_loss(logits, offsets, torch.from_numpy(batch["labels"]),
                           ref_targets, SMOOTHING,
                           CFG["heads"]["subframe_loss_weight"])
        loss.backward()
    assert feed.misfits == 0 and len(feed.draws) == len(ref.drop_sites)
    # f32 on both sides in another order of operations (the reference's
    # log-mel in float64, its attention unfused): rounding, ~1e-7 relative
    loss = float(loss.detach())
    assert abs(float(remat_loss[0]) - loss) <= 1e-5 * abs(loss)
    grads = dict(ref.named_parameters())
    gmax = max(float(g.abs().max()) for g in remat_grads.values())
    for n, g in remat_grads.items():
        # gradients summed over 1500 frames and two rows, each 1e-7 apart
        # in f32: 1e-4 of the largest leaves room for their accumulation
        diff = float((g - grads[n].grad).abs().max())
        assert diff <= 1e-4 * gmax, (n, diff, gmax)


def _recompute_spans(since):
    return [r for r in profiling.spans()
            if r.name == "wfl.recompute" and r.start_ns >= since]


def test_recompute_spans(state, monkeypatch):
    batch, _ = _batch()
    backward_threads = set()
    real = FA.attention_backward

    def watched(ctx, dout):
        backward_threads.add(threading.get_ident())
        return real(ctx, dout)

    monkeypatch.setattr(FA, "attention_backward", watched)
    monkeypatch.setattr(FAB, "attention_backward", watched)

    # profiler off: nothing recorded, nothing counted
    since, n0 = time.perf_counter_ns(), profiling.recomputed()
    _update(state, True, batch)
    assert not _recompute_spans(since) and profiling.recomputed() == n0

    from torch.profiler import ProfilerActivity, profile
    for remat, micro in ((False, 1), (True, 2)):
        since = time.perf_counter_ns()
        n0 = profiling.recomputed()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _update(state, remat, batch, n_micro=micro)
        got = _recompute_spans(since)
        want = LAYERS * micro if remat else 0
        assert len(got) == want and profiling.recomputed() - n0 == want
        assert sorted(r.attrs["layer"] for r in got) == sorted(
            list(range(LAYERS)) * (micro if remat else 0))
        assert all(r.thread in backward_threads for r in got)
        ranges = [e for e in prof.events() if e.name == "wfl.recompute"]
        assert len(ranges) == want


def test_the_update_span_counts_the_recomputed_layers(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    from wfl_asr_tpu_torch.preprocess import preprocess
    cfg = dict(CFG, d_model=32, encoder_ffn_dim=64)
    cfg["heads"] = dict(cfg["heads"], lang_emb_dim=8)
    data_dir = str(tmp_path / "corpus")
    traffic.corpus(data_dir, ["en", "ja"], 3, [1.0] * 6, 5, "cpu")
    training = {"batch_size": 2, "optimizer": "Prodigy",
                "optimizer_params": {"betas": [0.9, 0.999], "eps": 1e-8},
                "learning_rate": 1, "scheduler": "ConstantLR",
                "weight_decay": 1e-5, "label_smoothing": SMOOTHING,
                "max_steps": 2, "val_check_interval": 10 ** 9, "seed": 0,
                "num_workers": 0, "remat": True}
    pcfg = program.program_config(cfg, str(tmp_path / "run"),
                                  data_dir=data_dir, training=training,
                                  num_val=2)
    preprocess(data_dir, pcfg)
    since = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        TLOOP.train(pcfg, device="cpu")
    updates = [r for r in profiling.spans()
               if r.name == "wfl.update" and r.start_ns >= since]
    assert [r.attrs["recomputed"] for r in updates] == [LAYERS, LAYERS]
