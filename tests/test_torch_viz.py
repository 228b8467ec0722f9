"""The port's validation figures (``wfl_asr_tpu_torch/utils/viz.py`` and the
train loop's ``val/prediction_{count}_{j}``) against the JAX package's on
the CPU: the same lines, texts, colours and limits; the figures the loop
hands its writer; and the conditions under which it draws.

    python -m pytest tests/test_torch_viz.py -q
"""

import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from wfl_asr_tpu.utils import viz as JV
from wfl_asr_tpu_torch.train import loop as TLOOP
from wfl_asr_tpu_torch.utils import viz as TV


def _figure_contract(fig):
    """Everything the figure contract fixes: each line's data, colour,
    width, alpha and z-order; each text's position, string, colour and
    transform kind; the limits, title, axis label and legend."""
    import matplotlib.colors as mcolors
    (ax,) = fig.axes
    lines = [(np.asarray(l.get_xdata(), float).tolist(),
              np.asarray(l.get_ydata(), float).tolist(),
              mcolors.to_rgba(l.get_color()), l.get_linewidth(),
              l.get_alpha(), l.get_zorder()) for l in ax.lines]
    texts = [(t.get_position(), t.get_text(), mcolors.to_rgba(t.get_color()),
              t.get_ha(), t.get_va(), t.get_fontsize(),
              t.get_transform() == ax.get_xaxis_transform())
             for t in ax.texts]
    legend = ax.get_legend()
    return dict(lines=lines, texts=texts, ylim=ax.get_ylim(),
                xlim=ax.get_xlim(), title=ax.get_title(),
                xlabel=ax.get_xlabel(),
                legend=[t.get_text() for t in legend.get_texts()],
                legend_colors=[mcolors.to_rgba(h.get_color())
                               for h in legend.legend_handles],
                patch_alpha=fig.patch.get_alpha(),
                size=tuple(fig.get_size_inches()))


CASES = {
    "plain": ([(0.0, 0.3, "a"), (0.3, 0.31, "b"), (0.31, 0.9, "('c')")],
              [(0.0, 0.25, "a"), (0.25, 0.9, "\"SP\"")]),
    "nested_gt": ([(0.0, 0.5, ["x", "y"])],
                  [[(0.0, 0.2, "a"), (0.2, 0.5, "(b)")]]),
    "malformed_gt": ([(0.1, 0.4, "a")],
                     [(0.0, 0.2, "a"), "junk", (0.2, "x", "b"),
                      (0.2, 0.6, "c")]),
    "no_gt": ([(0.0, 0.6, "a"), (0.6, 0.61, "b")], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_matches_jax(case, capsys):
    import matplotlib.pyplot as plt
    wav = (np.random.RandomState(3).randn(16000) * 0.3).astype(np.float32)
    pred, gt = CASES[case]
    figs = [mod.visualize_prediction(wav, 16000, pred, gt, title="T")
            for mod in (JV, TV)]
    printed = capsys.readouterr().out
    assert _figure_contract(figs[1]) == _figure_contract(figs[0])
    if case == "malformed_gt":
        assert printed.count("[ERROR] Failed to plot GT segment") == 2
    for fig in figs:
        plt.close(fig)


def test_clean_label_matches_jax():
    for ph in ["a", " (b) ", "'c'", '"SP"', ["x", "y"], ["(z)"], "( 'q' )",
               "(unbalanced", 7, "", "''"]:
        assert TV.clean_label(ph) == JV.clean_label(ph), ph


def test_figure_without_matplotlib_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        TV.visualize_prediction(np.zeros(160), 16000, [(0.0, 0.01, "a")])


# ---------------------------------------------------------------------------
# The train loop's figures
# ---------------------------------------------------------------------------

class FakeWriter:
    def __init__(self):
        self.figures, self.scalars = [], []

    def add_figure(self, tag, fig, global_step=None):
        import matplotlib.pyplot as plt
        (ax,) = fig.axes
        self.figures.append((tag, global_step, [
            (t.get_text(), t.get_color()) for t in ax.texts]))
        plt.close(fig)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def close(self):
        pass


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    from tests.test_torch_train import make_config, make_data
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path_factory.mktemp("viz"))
    make_data(root, n_per_lang=3)
    cfg = make_config(root)
    # canonical "A" is en's "a" and ja's "b": the figures show each
    cfg["training"]["merged_phoneme_groups"] = [["A", "en/a", "ja/b"]]
    preprocess(cfg["data"]["data_dir"], cfg)
    cfg["model"]["num_languages"] = 2
    return root, cfg


def _val_batches(cfg_raw):
    """The validation batches the loop sees (its split, its loader)."""
    from wfl_asr_tpu_torch.config import as_config
    from wfl_asr_tpu_torch.data.dataset import (BatchLoader, PhonemeDataset,
                                                split_dataset)
    from wfl_asr_tpu_torch.labels import load_phoneme_list
    cfg = as_config(cfg_raw)
    labels = load_phoneme_list(os.path.join(cfg.save_dir, "phonemes.txt"))
    ds = PhonemeDataset(os.path.join(cfg.save_dir, "dataset.json"), labels,
                        cfg.max_seq_len, cfg.augmentation, cfg.sample_rate)
    _, val_idx = split_dataset(len(ds), cfg.num_val_files, cfg.seed)
    return list(BatchLoader(ds, val_idx, cfg.batch_size, seed=cfg.seed,
                            shuffle=False, frame_duration=cfg.frame_duration
                            ).epoch_batches(epoch=0))


def _fake_tensorboardx(monkeypatch):
    """A tensorboardX whose SummaryWriter is one FakeWriter."""
    import types
    writer = FakeWriter()
    monkeypatch.setitem(sys.modules, "tensorboardX", types.SimpleNamespace(
        SummaryWriter=lambda log_dir: writer))
    return writer


def _copy_run(root, cfg, name, **training):
    """``cfg`` on a fresh save_dir holding the preprocessed artifacts."""
    raw = json.loads(json.dumps(cfg))
    raw["training"].update(training)
    raw["output"]["save_dir"] = os.path.join(root, name)
    os.makedirs(raw["output"]["save_dir"])
    for art in ("phonemes.txt", "dataset.json", "langs.txt",
                "phoneme_merge_map.json", "lang_phonemes.json"):
        with open(os.path.join(root, "run", art)) as f, open(os.path.join(
                raw["output"]["save_dir"], art), "w") as g:
            g.write(f.read())
    return raw


@pytest.mark.parametrize("num_vis", [2, 5])
def test_loop_draws_the_jax_figures(prepped, monkeypatch, num_vis):
    """Two validations (steps 2 and 4): each hands the writer the first
    ``num_vis_samples`` samples' figures under the JAX loop's names
    ``val/prediction_{count}_{j}`` (count over the validation set, j in the
    batch), at the step; the ground truth in green in the sample
    language's own symbols (the merge map's ``canonical_to_lang``)."""
    from wfl_asr_tpu_torch.labels import (canonical_to_lang, clean_lab,
                                          load_langs, load_phoneme_merge_map)
    root, cfg = prepped
    raw = _copy_run(root, cfg, f"run_vis{num_vis}", max_steps=4,
                    num_vis_samples=num_vis)
    writer = _fake_tensorboardx(monkeypatch)
    TLOOP.train(raw, device="cpu")

    batches = _val_batches(raw)
    id2lang = {i: l for l, i in load_langs(
        os.path.join(root, "run", "langs.txt")).items()}
    merge_map = load_phoneme_merge_map(
        os.path.join(root, "run", "phoneme_merge_map.json"))
    assert merge_map, "the fixture has no merge map: the check is vacuous"
    want, count = [], 0
    for batch in batches:
        for j in range(len(batch["label_lengths"])):
            count += 1
            if count <= num_vis:
                lang = id2lang[int(batch["lang_ids"][j])]
                gt = batch["segments_gt"][j]
                gt = gt[0] if len(gt) == 1 and isinstance(gt[0], list) else gt
                green = [JV.clean_label(canonical_to_lang(
                    clean_lab(ph), lang, merge_map))
                    for s, e, ph in gt if e - s > 0.02]
                want.append((f"val/prediction_{count}_{j}", green))
    got = [(tag, [t for t, c in texts if c == "green"])
           for tag, _, texts in writer.figures]
    assert got == want * 2
    assert [s for _, s, _ in writer.figures] == \
        [2] * len(want) + [4] * len(want)
    assert len(want) == min(num_vis, count)


def test_loop_draws_only_with_matplotlib(prepped, monkeypatch):
    """Without matplotlib the loop writes its scalars and no figure; with
    tensorboardX's own writer its figures reach the event file."""
    root, cfg = prepped
    writer = _fake_tensorboardx(monkeypatch)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    TLOOP.train(_copy_run(root, cfg, "run_nompl", max_steps=2), device="cpu")
    assert writer.figures == []
    assert ("val/loss", 2) in writer.scalars
    monkeypatch.undo()
    pytest.importorskip("tensorboardX")
    EventAccumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator"
    ).EventAccumulator
    log_dir = os.path.join(root, "tb")
    TLOOP.train(_copy_run(root, cfg, "run_tb", max_steps=2,
                          num_vis_samples=2, log_dir=log_dir), device="cpu")
    acc = EventAccumulator(log_dir)
    acc.Reload()
    assert sorted(acc.Tags()["images"]) == ["val/prediction_1_0",
                                            "val/prediction_2_1"]
