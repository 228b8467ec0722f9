"""Launch-ahead folder serving: while a group's encoder runs on the card,
``infer_folder_batched`` writes the previous group's files and reads and
assembles the next group's rows.

On the CPU: a job of several groups (a partial last one, cached files
between them) writes the same ``.lab`` and ``.wfl_cache`` bytes as jobs
of one group each, which have nothing to overlap and so run in the serial
order, for the host and the device decode, one language and the
languages' average, median 3; a wav that fails to read in a shadow is
raised once the group in flight is written, so the files written are the
serial order's; and ``heads.bilstm``'s mask path runs each row alone at
its length. On the card (marked ``card``, skipped without one): the host
decode's gate and median, on the session's decode stream, give the main
stream's ids without waiting for the work queued there.

    python -m pytest tests/test_torch_launch_ahead.py -q
    python -m pytest tests/test_torch_launch_ahead.py -q -m card \\
        --noconftest                                      # on the card

The file imports nothing of JAX, so that it runs on the card's machine.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from torch import nn

from wfl_asr_tpu_torch.models import heads as H

LABELS = sorted([f"B-p{i}" for i in range(4)] + [f"I-p{i}" for i in range(4)]
                + ["O", "B-SP", "I-SP"])
SR = 16000
TINY = dict(
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, num_buckets=40, max_distance=100)
# twelve files; f02 and f05 cached before the job, so its steps are f02,
# the group (f00 f01 f03), f05, the groups (f04 f06 f07) and (f08 f09 f10),
# and the partial group (f11)
SECONDS = [0.7, 2.3, 1.4, 3.1, 0.9, 1.8, 0.6, 2.6, 1.2, 0.8, 2.0, 1.1]
CACHED = ["f02.wav", "f05.wav"]
BATCH_FILES = 3


def make_run(root, arch=TINY, device_decode=False, seed=3):
    """(config path, checkpoint) of a WavLM tagger with random weights and
    two languages, postprocess median 3, merge right."""
    from wfl_asr_tpu_torch.checkpoint import save_model_checkpoint
    from wfl_asr_tpu_torch.config import Config
    from wfl_asr_tpu_torch.models.tagger import TaggerArch, init_tagger
    save = os.path.join(root, "save")
    os.makedirs(save, exist_ok=True)
    with open(os.path.join(save, "phonemes.txt"), "w") as f:
        f.write("\n".join(LABELS) + "\n")
    with open(os.path.join(save, "langs.txt"), "w") as f:
        f.write("en,0\nja,1\n")
    config = {
        "data": {"sample_rate": SR, "frame_duration": 0.02},
        "model": {
            "encoder_type": "wavlm",
            "wavlm_model": "microsoft/wavlm-base-plus",
            "encoder_arch_overrides": dict(arch),
            "num_languages": 2, "lang_emb_dim": 16, "enable_bilstm": True,
            "bilstm_num_layer": 2, "num_conformer_layers": 1,
            "conformer_heads": 2, "enable_dilated_conv": True},
        "output": {"save_dir": save},
        "postprocess": {"median_filter": 3, "merge_segments": "right",
                        "device_decode": device_decode}}
    config_path = os.path.join(save, "config.yaml")
    with open(config_path, "w") as f:
        yaml.dump(config, f, sort_keys=False)
    arch_ = TaggerArch.from_config(Config(config), len(LABELS))
    ckpt = os.path.join(save, "best_model.pt")
    save_model_checkpoint(ckpt, init_tagger(arch_,
                                            torch.Generator().manual_seed(seed)))
    return config_path, ckpt


def write_wavs(folder, names):
    from wfl_asr_tpu_torch.data.audio import write_wav
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(11)
    for i, sec in enumerate(SECONDS):
        audio = rng.randn(int(SR * sec)) * 0.4
        name = f"f{i:02d}.wav"
        if name in names:
            write_wav(os.path.join(folder, name), audio, SR)


def read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# The job's bytes against jobs of one group each
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_decode", [False, True],
                         ids=["host_decode", "device_decode"])
@pytest.mark.parametrize("lang_id", [None, 0], ids=["averaged", "lang0"])
def test_launch_ahead_bytes_equal_the_serial_order(tmp_path, monkeypatch,
                                                   device_decode, lang_id):
    from wfl_asr_tpu_torch.infer import pipeline
    config, ckpt = make_run(str(tmp_path), device_decode=device_decode)
    names = [f"f{i:02d}.wav" for i in range(len(SECONDS))]
    new = [n for n in names if n not in CACHED]
    groups = [new[i:i + BATCH_FILES] for i in range(0, len(new), BATCH_FILES)]
    assert len(groups) == 4 and len(groups[-1]) < BATCH_FILES

    def job(folder, out):
        pipeline.infer_folder_batched(
            str(folder), config, ckpt, str(out), lang_id=lang_id,
            confidence_threshold=0.1, batch_files=BATCH_FILES, device="cpu")

    # the cached files' entries, from a job of their own
    write_wavs(tmp_path / "pre", CACHED)
    job(tmp_path / "pre", tmp_path / "out_pre")
    # the serial order: one job a group
    for k, group in enumerate(groups):
        write_wavs(tmp_path / f"g{k}", group)
        job(tmp_path / f"g{k}", tmp_path / f"out_g{k}")
    # the job under test, its groups' rows assembled ahead after the first
    main = tmp_path / "main"
    write_wavs(main, names)
    shutil.copytree(tmp_path / "pre" / ".wfl_cache", main / ".wfl_cache")
    ahead = []
    method = ("forward_many_decoded" if device_decode else "forward_many")
    forward = getattr(pipeline.InferenceSession, method)

    def spy(self, *a, **kw):
        ahead.append(kw.get("rows") is not None)
        return forward(self, *a, **kw)

    monkeypatch.setattr(pipeline.InferenceSession, method, spy)
    try:
        job(main, tmp_path / "out_main")
    finally:
        pipeline._SESSION_CACHE.clear()
    # f05 comes between the first two groups and first writes the group read
    # back before it, so the groups after the second are the ones read ahead
    assert ahead == [False, False, True, True]

    suffix = "_avg" if lang_id is None else f"_lang{lang_id}"
    assert sorted(os.listdir(tmp_path / "out_main")) == \
        sorted(n.replace(".wav", ".lab") for n in names)
    for k, group in enumerate([CACHED] + groups):
        src = "pre" if k == 0 else f"g{k - 1}"
        for name in group:
            lab = name.replace(".wav", ".lab")
            want = read(tmp_path / f"out_{src}" / lab)
            assert want.strip(), "an empty .lab: the comparison is vacuous"
            assert read(tmp_path / "out_main" / lab) == want, name
            for kind in ("logits", "offsets"):
                entry = f"{name[:-4]}{suffix}_{kind}.pt"
                assert read(main / ".wfl_cache" / entry) == \
                    read(tmp_path / src / ".wfl_cache" / entry), entry


def write_bad_wav(path):
    """A wav whose header reads (so the job lists it as a short new file)
    but whose samples do not: 12-bit PCM."""
    import struct
    data = bytes(2 * SR)
    fmt = struct.pack("<HHIIHH", 1, 1, SR, 2 * SR, 2, 12)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
                + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(data)) + data)


def test_a_failed_read_ahead_is_raised_after_the_group_in_flight_is_written(
        tmp_path):
    """The third group's bad wav is read in the second group's shadow; the
    job raises its error once the second group's files are written, and
    writes nothing of the third, as the serial order would."""
    from wfl_asr_tpu_torch.infer import pipeline
    config, ckpt = make_run(str(tmp_path))
    names = [f"f{i:02d}.wav" for i in range(7)]
    folder = tmp_path / "main"
    write_wavs(folder, names[:6])
    write_bad_wav(str(folder / names[6]))
    try:
        with pytest.raises(ValueError, match="Unsupported PCM bit depth"):
            pipeline.infer_folder_batched(
                str(folder), config, ckpt, str(tmp_path / "out"),
                confidence_threshold=0.1, batch_files=BATCH_FILES,
                device="cpu")
    finally:
        pipeline._SESSION_CACHE.clear()
    assert sorted(os.listdir(tmp_path / "out")) == \
        [n.replace(".wav", ".lab") for n in names[:6]]
    assert sorted(os.listdir(folder / ".wfl_cache")) == sorted(
        f"{n[:-4]}_avg_{kind}.pt" for n in names[:6]
        for kind in ("logits", "offsets"))


# ---------------------------------------------------------------------------
# The BiLSTM's mask path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [
    [12, 0, 7, 12, 3, 3],          # full rows, an all-padding row, ties
    [12, 12, 12, 12, 12, 12],      # every row full
    [0, 0, 0, 0, 0, 0],            # every row padding
    [1, 5, 9, 2, 11, 6]])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_mask_path_runs_each_row_alone(lengths, num_layers, dtype):
    """With a mask, each row's valid frames are the LSTM run over that row
    alone at its length (at least one frame: an all-padding row runs its
    first), and its padded frames are zeros."""
    torch.manual_seed(0)
    lstm = nn.LSTM(16, 8, num_layers=num_layers, bidirectional=True,
                   batch_first=True)
    x = torch.randn(len(lengths), 12, 16).to(dtype)
    mask = torch.arange(12)[None, :] < torch.tensor(lengths)[:, None]
    with torch.no_grad():
        got = H.bilstm(lstm, x, mask=mask)
        assert got.dtype == dtype and got.shape == (len(lengths), 12, 16)
        for row, n in zip(range(len(lengths)), lengths):
            n = max(n, 1)
            want = lstm(x[row:row + 1, :n].float())[0][0].to(dtype)
            torch.testing.assert_close(got[row, :n], want)
            assert not got[row, n:].any()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """Skips the test where there is no CUDA device (decided here, at run
    time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def card_session(card, tmp_path):
    """A session on the card: WavLM-base-plus's widths at two layers."""
    from wfl_asr_tpu_torch.infer import pipeline
    config, ckpt = make_run(str(tmp_path), arch={"num_layers": 2})
    return pipeline.InferenceSession(config, ckpt, device="cuda")


@pytest.mark.card
def test_the_decode_stream_gives_the_main_streams_ids(card_session):
    from wfl_asr_tpu_torch.ops.postprocess import (confidence_gate_ids,
                                                   median_filter_ids)
    session = card_session
    logits = (np.random.RandomState(4).randn(700, len(LABELS)) * 3
              ).astype(np.float32)
    with torch.inference_mode():
        ids = confidence_gate_ids(torch.from_numpy(logits).cuda(), 0.5,
                                  session.label2id["O"])
        want = median_filter_ids(ids, 3).cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)     # about a second queued on the card
    got = session.postprocess_ids(logits, 0.5, 3)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    assert busy, "the decode waited for the main stream's queued work"
