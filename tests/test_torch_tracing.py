"""The port's spans (``utils/profiling.span``) on the CPU: nothing recorded
and no profiler range opened while no profiler records; parents, roots,
threads and attributes while one does; the shared clock against the
profiler's own events; the bounded buffer; and the spans of a folder job
and of a few training updates, whose ``.lab`` files and steps the spans
leave as they were.

    python -m pytest tests/test_torch_tracing.py -q
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from wfl_asr_tpu_torch.utils import profiling as P

ARCH_OVERRIDES = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, num_buckets=40, max_distance=100)
LABELS = sorted([f"B-p{i}" for i in range(4)] + [f"I-p{i}" for i in range(4)]
                + ["O", "B-SP", "I-SP"])
SR = 16000
FILE_SECONDS = [0.6, 2.3, 1.4, 3.1, 0.9]
BATCH_FILES = 2


def recording():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_buffer():
    P.reset()
    yield
    P.reset()


def by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    """With no profiler on, a span is one shared no-op: no record, no
    ``record_function``, ``set`` ignored, decorators pass through."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))

    @P.span("wfl.t_decorated")
    def work(x):
        return x + 1

    with P.span("wfl.t_outer", rows=3) as outer:
        with P.span("wfl.t_inner") as inner:
            inner.set(samples=5)
        assert work(1) == 2
    assert P.span("wfl.t_outer") is outer
    assert P.span("wfl.t_outer", rows=4) is outer
    assert P.spans() == [] and opened == []


def test_nested_spans_carry_parent_root_thread_and_attributes():
    with recording():
        with P.span("wfl.t_job", files=2) as job:
            with P.span("wfl.t_forward", rows=4):
                with P.span("wfl.t_stage"):
                    pass
            with P.span("wfl.t_read") as rd:
                rd.set(samples=123)
        with P.span("wfl.t_next"):
            pass
    recs = by_name(P.spans())
    (j,), (f,), (s,), (r,), (n,) = (recs[k] for k in (
        "wfl.t_job", "wfl.t_forward", "wfl.t_stage", "wfl.t_read",
        "wfl.t_next"))
    assert j.id == job.id and j.parent is None and j.root == j.id
    assert (f.parent, f.root) == (j.id, j.id)
    assert (s.parent, s.root) == (f.id, j.id)
    assert (r.parent, r.root) == (j.id, j.id)
    assert n.parent is None and n.root == n.id != j.id
    assert {x.thread for x in (j, f, s, r, n)} == {threading.get_ident()}
    assert (j.attrs, f.attrs, s.attrs, r.attrs) == (
        {"files": 2}, {"rows": 4}, {}, {"samples": 123})
    for x in (f, s, r):
        assert j.start_ns <= x.start_ns <= x.end_ns <= j.end_ns
    # records are appended as spans end: innermost first
    assert [x.name for x in P.spans()] == [
        "wfl.t_stage", "wfl.t_forward", "wfl.t_read", "wfl.t_job",
        "wfl.t_next"]


def test_a_second_thread_keeps_its_own_parents():
    """A span on another thread (the loader's producer) has no parent
    from the thread that started it; its own nested span does."""
    def produce():
        with P.span("wfl.t_collate"):
            with P.span("wfl.t_item"):
                time.sleep(0.001)

    with recording():
        with P.span("wfl.t_update"):
            t = threading.Thread(target=produce)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    recs = by_name(P.spans())
    (u,), (c,), (i,) = (recs[k] for k in ("wfl.t_update", "wfl.t_collate",
                                          "wfl.t_item"))
    assert c.parent is None and c.root == c.id
    assert (i.parent, i.root) == (c.id, c.id)
    assert c.thread == i.thread == t.ident != u.thread


def test_decorator_records_each_call_while_recording():
    @P.span("wfl.t_call")
    def work(x):
        with P.span("wfl.t_inside"):
            return 2 * x

    assert work(2) == 4                     # off: nothing
    with recording():
        assert work(3) == 6
        assert work(4) == 8
    assert work(5) == 10
    recs = by_name(P.spans())
    assert len(recs["wfl.t_call"]) == 2 and len(recs["wfl.t_inside"]) == 2
    for outer, inner in zip(recs["wfl.t_call"], recs["wfl.t_inside"]):
        assert inner.parent == outer.id
    assert work.__name__ == "work"


def test_spans_map_onto_the_profilers_clock():
    """``start_ns + clock_offset_ns()`` of every span lies within 1 ms of
    the profiler's range of the same name, start and end."""
    names = ["wfl.t_a", "wfl.t_b", "wfl.t_c"]
    with recording() as prof:
        for k in range(4):
            for name in names:
                with P.span(name):
                    torch.ones(64).sum()
                    time.sleep(0.002 * (k + 1))
    offset = P.clock_offset_ns()
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("wfl.t_"):
            events[e.name()].append((e.start_ns(), e.end_ns()))
    recs = by_name(P.spans())
    for name in names:
        ev = sorted(events[name])
        assert len(ev) == len(recs[name]) == 4
        for r, (s, e) in zip(recs[name], ev):
            assert abs(r.start_ns + offset - s) < 1_000_000
            assert abs(r.end_ns + offset - e) < 1_000_000


def test_the_buffer_is_bounded(monkeypatch):
    assert P._TRACER.records.maxlen == P.BUFFER_SPANS
    monkeypatch.setattr(P._TRACER, "records", collections.deque(maxlen=5))
    with recording():
        for i in range(12):
            with P.span("wfl.t_n", i=i):
                pass
    kept = P.spans()
    assert [r.attrs["i"] for r in kept] == list(range(7, 12))
    P.reset()
    assert P.spans() == []


# ---------------------------------------------------------------------------
# The program's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One folder job on a tiny WavLM tagger with the profiler off and one
    with it on, on two copies of the same wavs. Returns (spans of the
    traced job, its profiler events' names, the two output dirs)."""
    from wfl_asr_tpu_torch.checkpoint import save_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.data.audio import write_wav
    from wfl_asr_tpu_torch.infer import pipeline
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    root = tmp_path_factory.mktemp("served")
    save = root / "save"
    save.mkdir()
    (save / "phonemes.txt").write_text("\n".join(LABELS) + "\n")
    (save / "langs.txt").write_text("en,0\nja,1\n")
    config = {
        "data": {"sample_rate": SR, "frame_duration": 0.02},
        "model": {
            "encoder_type": "wavlm",
            "wavlm_model": "microsoft/wavlm-base-plus",
            "encoder_arch_overrides": ARCH_OVERRIDES,
            "num_languages": 2, "lang_emb_dim": 16, "enable_bilstm": True,
            "bilstm_num_layer": 2, "num_conformer_layers": 1,
            "conformer_heads": 2, "enable_dilated_conv": True},
        "output": {"save_dir": str(save)},
        "postprocess": {"median_filter": 3, "merge_segments": "right"}}
    config_path = save / "config.yaml"
    config_path.write_text(yaml.dump(config, sort_keys=False))
    arch = TaggerArch.from_config(Config(config), len(LABELS))
    model = init_tagger(arch, torch.Generator().manual_seed(3))
    ckpt = str(save / "best_model.pt")
    save_model_checkpoint(ckpt, model)
    rng = np.random.RandomState(5)
    audios = {f"w{i}.wav": rng.randn(int(SR * d)) * 0.4
              for i, d in enumerate(FILE_SECONDS)}
    outs = []
    torch.set_num_threads(2)
    for side in ("off", "on"):
        folder = root / f"wavs_{side}"
        folder.mkdir()
        for name, audio in audios.items():
            write_wav(str(folder / name), audio, SR)
        out = root / f"out_{side}"

        def job():
            pipeline.infer_folder_batched(
                str(folder), str(config_path), ckpt, str(out),
                confidence_threshold=0.1, batch_files=BATCH_FILES,
                device="cpu")
        if side == "off":
            job()
        else:
            P.reset()
            with recording() as prof:
                job()
            names = {e.name() for e in prof.profiler.kineto_results.events()}
        outs.append(out)
    pipeline._SESSION_CACHE.clear()
    return P.spans(), names, outs


def test_folder_job_spans(served):
    """One listing, one ``wfl.forward`` a batch with the bucket arithmetic,
    one ``wfl.read_wav`` and ``wfl.lab_write`` a file, two decode spans
    and two cache entries a file; all under the one ``wfl.job``. Every
    group after the first was read and assembled ahead, in the shadow of
    the forward before it: one ``wfl.shadow`` a forward, inside it between
    the encoder's launch and the heads', before its readback, holding the
    next group's reads and the previous group's decode and writes."""
    recs, _names, _outs = served
    by = by_name(recs)
    (job,) = by["wfl.job"]
    lens = [int(SR * d) for d in FILE_SECONDS]
    groups = [lens[i:i + BATCH_FILES]
              for i in range(0, len(lens), BATCH_FILES)]
    fwd = sorted(by["wfl.forward"], key=lambda r: r.start_ns)
    assert len(fwd) == len(groups)
    for k, (r, g) in enumerate(zip(fwd, groups)):
        bucket = int(np.ceil(max(g) / SR)) * SR
        assert r.attrs == {"rows": 2 * len(g), "samples_true": 2 * sum(g),
                           "samples_run": 2 * len(g) * bucket,
                           "ahead": int(k > 0)}
    shadows = sorted(by["wfl.shadow"], key=lambda r: r.start_ns)
    assert len(shadows) == len(groups) > 2
    for f, sh, enc, head, back in zip(
            fwd, shadows, *(sorted(by[n], key=lambda r: r.start_ns)
                            for n in ("wfl.encoder", "wfl.heads",
                                      "wfl.readback"))):
        assert sh.parent == f.id
        assert enc.end_ns <= sh.start_ns and sh.end_ns <= head.start_ns
        assert f.end_ns <= back.start_ns
    inside = collections.Counter(
        (shadows.index(s), r.name) for r in recs for s in shadows
        if r.parent == s.id)
    for k, g in enumerate(groups):
        nxt = groups[k + 1] if k + 1 < len(groups) else []
        prev = groups[k - 1] if k else []
        assert inside[(k, "wfl.read_wav")] == len(nxt)
        assert inside[(k, "wfl.lab_write")] == len(prev)
        assert inside[(k, "wfl.cache_save")] == 2 * len(prev)
    assert sorted(r.attrs["samples"] for r in by["wfl.read_wav"]) == \
        sorted(lens)
    (listing,) = by["wfl.list"]
    assert listing.attrs == {"files": len(lens)}
    # host decode: each file's language average, then its segments
    assert len(by["wfl.decode"]) == 2 * len(lens)
    assert len(by["wfl.lab_write"]) == len(lens)
    assert len(by["wfl.cache_save"]) == 2 * len(lens)
    assert len(by["wfl.readback"]) == len(by["wfl.stage"]) == len(groups)
    for name in ("wfl.encoder", "wfl.heads", "wfl.bilstm"):
        assert len(by[name]) == len(groups)
    ids = {r.id: r for r in recs}
    for r in recs:
        assert r.root == job.id and r.thread == job.thread
    for r in by["wfl.stage"] + by["wfl.encoder"] + by["wfl.heads"]:
        assert ids[r.parent].name == "wfl.forward"
    for r in by["wfl.bilstm"]:
        assert ids[r.parent].name == "wfl.heads"


def test_folder_job_is_the_same_traced(served):
    """The traced job's ``.lab`` files are byte-equal to the untraced
    job's, and its profiler events hold the program's ranges."""
    _recs, names, (off, on) = served
    labs = sorted(os.listdir(off))
    assert labs == sorted(os.listdir(on)) and len(labs) == len(FILE_SECONDS)
    for lab in labs:
        a, b = (off / lab).read_bytes(), (on / lab).read_bytes()
        assert a.strip() and a == b
    assert {"wfl.job", "wfl.forward", "wfl.read_wav", "wfl.encoder",
            "wfl.readback"} <= names


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three updates of ``train()`` on the CPU under the profiler, in
    one epoch of three batches."""
    from tests.test_torch_train import make_config, make_data
    from wfl_asr_tpu_torch.preprocess import preprocess
    from wfl_asr_tpu_torch.train import loop as TLOOP
    root = str(tmp_path_factory.mktemp("trained"))
    make_data(root, n_per_lang=6)
    cfg = make_config(root, max_steps=3, val_check_interval=100)
    preprocess(cfg["data"]["data_dir"], cfg)
    cfg["model"]["num_languages"] = 2
    torch.set_num_threads(2)
    P.reset()
    with recording():
        TLOOP.train(cfg, device="cpu")
    recs = P.spans()
    P.reset()
    return recs, root


def test_train_update_spans(trained):
    """One ``wfl.update`` a step, each the root of its micro-batch's
    forward and backward and of the optimizer's step, and from the second
    step on of the previous step's readback and log; without remat no
    layer is recomputed."""
    recs, _root = trained
    by = by_name(recs)
    updates = sorted(by["wfl.update"], key=lambda r: r.start_ns)
    assert [u.attrs for u in updates] == [{"step": s, "recomputed": 0}
                                          for s in (1, 2, 3)]
    under = collections.defaultdict(list)
    for r in recs:
        if r.root != r.id:
            under[r.root].append(r.name)
    for k, u in enumerate(updates):
        names = under[u.id]
        assert names.count("wfl.forward_backward") == 1
        assert names.count("wfl.optimizer") == 1
        assert names.count("wfl.encoder") == names.count("wfl.heads") == 1
        assert names.count("wfl.readback") == (1 if k else 0)
        assert names.count("wfl.log") == (1 if k else 0)
    (fb,) = [r for r in by["wfl.forward_backward"]
             if r.root == updates[0].id]
    assert fb.attrs["rows"] == 3 and fb.attrs["samples_true"] > 0


def test_train_loader_spans(trained):
    """The batches are collated on the loader's thread and waited for on
    the loop's; the last step's readback runs after the last update."""
    recs, _root = trained
    by = by_name(recs)
    loop_thread = by["wfl.update"][0].thread
    assert by["wfl.collate"] and by["wfl.loader_wait"]
    assert {r.thread for r in by["wfl.collate"]} != {loop_thread}
    assert all(r.parent is None for r in by["wfl.collate"])
    assert {r.thread for r in by["wfl.loader_wait"]} == {loop_thread}
    assert len(by["wfl.readback"]) == 3
    last = max(by["wfl.readback"], key=lambda r: r.start_ns)
    assert last.parent is None


def test_infer_cli_writes_a_serving_trace(served, tmp_path, monkeypatch):
    """With ``WFL_PROFILE_DIR``, the infer CLI's folder mode writes a
    Chrome trace holding the program's ranges."""
    from wfl_asr_tpu_torch.infer import cli, pipeline
    _recs, _names, (off, _on) = served
    save = off.parent / "save"
    folder = tmp_path / "wavs"
    folder.mkdir()
    src = off.parent / "wavs_off"
    for name in sorted(os.listdir(src)):
        if name.endswith(".wav"):
            (folder / name).write_bytes((src / name).read_bytes())
    monkeypatch.setenv("WFL_PROFILE_DIR", str(tmp_path / "prof"))
    try:
        cli.main.main([str(folder), "-ckpt", str(save / "best_model.pt"),
                       "-c", str(save / "config.yaml"), "-o",
                       str(tmp_path / "out"), "-b", "2", "--device", "cpu"],
                      standalone_mode=False)
    finally:
        pipeline._SESSION_CACHE.clear()
    trace = tmp_path / "prof" / "infer" / P.TRACE_FILE
    names = {e.get("name") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert {"wfl.job", "wfl.forward", "wfl.lab_write"} <= names
    assert len(os.listdir(tmp_path / "out")) == len(FILE_SECONDS)
