"""The output check sees a broken timed path: each fault a cell can have,
planted in the program underneath a tiny CPU run, turns ``correct``
false."""

import numpy as np
import pytest

from benchmark import run as brun


def _run(tiny_bench, workload):
    bench, bdir = tiny_bench
    return brun.run_cell(bench, workload, 424242, 1.0, False, device="cpu",
                         bench_dir=bdir)


@pytest.mark.parametrize("encoder", ["wavlm-base-plus", "whisper-base"])
def test_an_altered_label_file(tiny_bench, monkeypatch, encoder):
    from wfl_asr_tpu_torch.infer import pipeline
    save = pipeline.save_lab

    def altered(path, segments):
        segments = list(segments)
        if segments:
            s, e, _ph = segments[0]
            segments[0] = (s, e, "XX")
        save(path, segments)

    monkeypatch.setattr(pipeline, "save_lab", altered)
    out = _run(tiny_bench, f"{encoder}.label_mixed")
    assert not out["correct"]
    assert out["checks"]["lab_mismatch"]["value"] > 0


@pytest.mark.parametrize("encoder", ["wavlm-base-plus", "whisper-base"])
def test_altered_logits(tiny_bench, monkeypatch, encoder):
    from wfl_asr_tpu_torch.infer import pipeline
    forward = pipeline.InferenceSession.forward_many

    def altered(self, *a, **kw):
        out = forward(self, *a, **kw)
        return [(lg + np.float32(0.05) * np.abs(lg).max()
                 * (np.arange(lg.shape[-1]) == 3), off) for lg, off in out]

    monkeypatch.setattr(pipeline.InferenceSession, "forward_many", altered)
    out = _run(tiny_bench, f"{encoder}.label_mixed")
    assert not out["correct"]


def test_a_step_that_leaves_the_state(tiny_bench, monkeypatch):
    from wfl_asr_tpu_torch.train import loop
    monkeypatch.setattr(loop, "apply_update",
                        lambda opt: opt.zero_grad(set_to_none=True))
    out = _run(tiny_bench, "whisper-base.train_mixed")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] >= \
        out["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out(tiny_bench, monkeypatch):
    from wfl_asr_tpu_torch.train import loop
    micro = loop.micro_step

    def half(model, batch, *a, **kw):
        n = len(batch["labels"]) // 2
        batch.update({k: v[:n] for k, v in batch.items()
                      if isinstance(v, (np.ndarray, list))})
        return micro(model, batch, *a, **kw)

    monkeypatch.setattr(loop, "micro_step", half)
    out = _run(tiny_bench, "whisper-base.train_mixed")
    assert not out["correct"]


def test_an_altered_label(tiny_bench, monkeypatch):
    from wfl_asr_tpu_torch.data import dataset
    collate = dataset.collate

    def altered(*a, **kw):
        batch = collate(*a, **kw)
        row = batch["labels"][0]
        row[row >= 0] = (row[row >= 0] + 1) % 73
        return batch

    monkeypatch.setattr(dataset, "collate", altered)
    out = _run(tiny_bench, "whisper-base.train_mixed")
    assert not out["correct"]


def test_dropout_at_another_rate(tiny_bench, monkeypatch):
    from wfl_asr_tpu_torch.models import heads
    drop = heads.dropout

    def doubled(x, rate, generator=None, training=True):
        return drop(x, 2 * rate, generator, training)

    monkeypatch.setattr(heads, "dropout", doubled)
    out = _run(tiny_bench, "whisper-base.train_mixed")
    assert not out["correct"]
    assert out["checks"]["masks_off"]["value"] > 0
