"""The port's command lines under ``python -m torch.distributed.run`` on the
CPU (``--device cpu``: a ``gloo`` world of two ranks), against one
process:

- ``python -m wfl_asr_tpu_torch.train`` with every dropout rate and
  LayerDrop at 0 (element-wise masks differ per rank by design): the same
  ``metrics.jsonl`` train losses (1e-6 relative), the same validation
  losses with ``training.sharded_validation`` (each rank evaluates its rows
  of each validation batch; 1e-6 relative), and the same ``last_model.pt``
  (the same keys, every tensor within 1e-5);
- ``python -m wfl_asr_tpu_torch.infer`` on a folder (the batched mode,
  ``data_parallel`` on by default in a world of two): ``.lab`` files
  byte-identical to one process's, and every ``.wfl_cache`` entry written.

The one-process and two-rank runs of each command run at once.

    python -m pytest tests/test_torch_parallel_cli.py -q
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from wfl_asr_tpu_torch.data.audio import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

ARCH = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
            conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, num_buckets=40, max_distance=100,
            hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
            attention_dropout=0.0, layerdrop=0.0)


def _make_data(root):
    """Two languages × 5 utterances of 1-2.5 s, with HTK labels."""
    rng = np.random.RandomState(0)
    phones = ["a", "b", "SP", "c"]
    for lang in ("en", "ja"):
        d = os.path.join(root, "data", lang)
        os.makedirs(d, exist_ok=True)
        for i in range(5):
            dur = 1.0 + 0.37 * i
            write_wav(os.path.join(d, f"u{i}.wav"),
                      rng.randn(int(dur * 16000)) * 0.3, 16000)
            t, k, lines = 0.0, 0, []
            while t < dur - 0.05:
                e = min(t + 0.1 + 0.05 * (k % 3), dur)
                lines.append(f"{int(t * 1e7)} {int(e * 1e7)} "
                             f"{phones[(k + i) % 4]}")
                t, k = e, k + 1
            with open(os.path.join(d, f"u{i}.lab"), "w") as f:
                f.write("\n".join(lines) + "\n")


def _config(root, run, **training):
    t = {"batch_size": 4, "optimizer": "Prodigy",
         "optimizer_params": {"betas": [0.9, 0.999], "eps": 1e-8},
         "learning_rate": 1, "scheduler": "ConstantLR",
         "weight_decay": 1e-5, "label_smoothing": 0.1, "max_steps": 4,
         "val_check_interval": 2, "max_checkpoints": 2,
         "log_dir": os.path.join(root, run, "logs"), "seed": 0}
    t.update(training)
    return {
        "data": {"data_dir": os.path.join(root, "data"),
                 "sample_rate": 16000, "num_val_files": 2,
                 "frame_duration": 0.02},
        "model": {"encoder_type": "wavlm",
                  "wavlm_model": "microsoft/wavlm-base-plus",
                  "encoder_arch_overrides": dict(ARCH),
                  "num_languages": 2, "lang_emb_dim": 16,
                  "bilstm_num_layer": 2, "num_conformer_layers": 2,
                  "conformer_heads": 2, "conformer_ff_expansion": 2,
                  "conformer_dropout": 0.0, "subframe_loss_weight": 3.0,
                  "merged_phoneme_groups": []},
        "training": t,
        "augmentation": {"enable": True, "noise_std": 0.005, "prob": 0.5,
                         "volume_range": [0.9, 1.1]},
        "output": {"save_dir": os.path.join(root, run)},
        "postprocess": {"median_filter": 3}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, ranks, log):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "TORCHELASTIC_RUN_ID"):
        env.pop(key, None)
    cmd = [sys.executable]
    if ranks > 1:
        cmd += ["-m", "torch.distributed.run", "--nproc_per_node",
                str(ranks), "--master_addr", "127.0.0.1", "--master_port",
                str(_free_port())]
    return subprocess.Popen(cmd + args, env=env, cwd=REPO,
                            stdout=open(log, "w"), stderr=subprocess.STDOUT)


def _finish(procs):
    for p, log in procs:
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            with open(log) as f:
                pytest.fail(f"{log}: rc {p.returncode}\n{f.read()[-4000:]}")


def _events(run_dir, kind):
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        return [(e["step"], e["loss"]) for e in map(json.loads, f)
                if e["event"] == kind]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, one-process run dir, two-rank run dir) after both trainings
    and both servings."""
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path_factory.mktemp("ddp_cli"))
    _make_data(root)
    procs = []
    for run, ranks, extra in (("one", 1, {}),
                              ("two", 2, {"sharded_validation": True})):
        cfg = _config(root, run, **extra)
        preprocess(cfg["data"]["data_dir"], cfg)
        path = os.path.join(root, run, "config.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        log = os.path.join(root, f"train_{run}.log")
        procs.append((_start(["-m", "wfl_asr_tpu_torch.train", path,
                              "--device", "cpu"], ranks, log), log))
    _finish(procs)

    rng = np.random.RandomState(5)
    folders = [os.path.join(root, f"wavs_{run}") for run in ("one", "two")]
    for folder in folders:
        os.makedirs(folder)
    for i in range(7):
        audio = rng.randn(int((0.8 + 0.45 * i) * 16000)) * 0.3
        for folder in folders:
            write_wav(os.path.join(folder, f"f{i}.wav"), audio, 16000)
    audio = rng.randn(int(31.5 * 16000)) * 0.3       # the chunked path
    for folder in folders:
        write_wav(os.path.join(folder, "long.wav"), audio, 16000)
    procs = []
    one = os.path.join(root, "one")
    for run, ranks, folder in (("one", 1, folders[0]), ("two", 2,
                                                        folders[1])):
        log = os.path.join(root, f"infer_{run}.log")
        procs.append((_start(
            ["-m", "wfl_asr_tpu_torch.infer", folder, "-ckpt",
             os.path.join(one, "last_model.pt"), "-c",
             os.path.join(one, "config.yaml"), "-o",
             os.path.join(root, f"labs_{run}"), "--device", "cpu", "-b",
             "3"], ranks, log), log))
    _finish(procs)
    return root, one, os.path.join(root, "two")


def test_two_rank_train_matches_one_process(runs):
    _, one, two = runs
    want, got = _events(one, "train"), _events(two, "train")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-6)


def test_two_rank_sharded_validation_matches_one_process(runs):
    _, one, two = runs
    want, got = _events(one, "val"), _events(two, "val")
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-6)


def test_two_rank_checkpoint_matches_one_process(runs):
    """Rank 0 writes the canonical last_model.pt; its sidecars hold both
    ranks' generator states."""
    _, one, two = runs
    a = torch.load(os.path.join(one, "last_model.pt"), weights_only=True)
    b = torch.load(os.path.join(two, "last_model.pt"), weights_only=True)
    assert list(a) == list(b)
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=1e-5, rtol=0,
                                   msg=k)
    side = torch.load(os.path.join(two, "model_step4.train.pt"),
                      weights_only=True)
    assert len(side["local_generators"]) == 2 and side["step"] == 4


def test_rank_rows_are_the_batch_rows(runs):
    """A data rank's rows of each global batch (``BatchLoader(rows=...)``)
    are the one-process batch's rows at its padded lengths, augmentation
    draws included; ``item_lengths`` are the collated items' lengths; the
    node shards are the JAX package's."""
    from wfl_asr_tpu.data.dataset import shard_indices_for_process as jshard
    from wfl_asr_tpu_torch.data.dataset import (BatchLoader, PhonemeDataset,
                                                shard_indices_for_process,
                                                split_dataset)
    from wfl_asr_tpu_torch.labels import load_phoneme_list
    root, one, _ = runs
    labels = load_phoneme_list(os.path.join(one, "phonemes.txt"))
    data = PhonemeDataset(os.path.join(one, "dataset.json"), labels,
                          aug_cfg={"enable": True, "noise_std": 0.005,
                                   "prob": 0.5})
    idx, _ = split_dataset(len(data), 2, 0)
    full = list(BatchLoader(data, idx, 4, seed=0).epoch_batches(1))
    parts = [list(BatchLoader(data, idx, 4, seed=0, rows=r)
                  .epoch_batches(1)) for r in ((0, 2), (2, 4))]
    assert len(full) == len(parts[0]) == len(parts[1]) == 2
    for k, whole in enumerate(full):
        for r, part in enumerate(p[k] for p in parts):
            assert part["max_label_len"] == whole["max_label_len"]
            for key in ("audio", "labels", "lang_ids", "off_frames",
                        "off_fracs", "off_valid", "label_lengths"):
                np.testing.assert_array_equal(
                    part[key], whole[key][2 * r:2 * r + 2], err_msg=key)
    for i in range(len(data)):
        item = data.get_item(i)
        n_seg = sum(1 for s in item["segments"] if len(s) == 3)
        assert data.item_lengths(i) == (len(item["audio"]),
                                        len(item["label_ids"]), 2 * n_seg)
    assert data.global_max_lengths() == tuple(
        max(data.item_lengths(i)[j] for i in range(len(data)))
        for j in range(3))
    for n, p in ((10, 3), (8, 2), (7, 4)):
        for r in range(p):
            assert shard_indices_for_process(list(range(n)), r, p) == \
                jshard(list(range(n)), r, p)


def test_two_rank_serving_writes_the_same_labs(runs):
    root, _, _ = runs
    one, two = (os.path.join(root, f"labs_{r}") for r in ("one", "two"))
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two)) and len(names) == 8
    for name in names:
        with open(os.path.join(one, name), "rb") as f1, \
                open(os.path.join(two, name), "rb") as f2:
            assert f1.read() == f2.read(), name
    cache = os.listdir(os.path.join(root, "wavs_two", ".wfl_cache"))
    assert sum(n.endswith("_logits.pt") for n in cache) >= 7
