"""The port's Whisper and mel (``encoder_type: none``) encoders against the
JAX package on the CPU, in f32, the JAX side under
``jax.default_matmul_precision("highest")``, the same numpy inputs (seeded)
through both, weights from the JAX ``init_tagger`` carried across by
``state_dict_from_jax`` + ``load_state_dict(strict=True)``:

- the arch tables (``whisper_arch_from_name``, ``TaggerArch.from_config``);
- the Whisper encoder at a narrow override arch (head_dim 40, padded to 48
  inside the attention) and at the ``tiny`` preset at full width;
- a JAX-written Whisper ``.pt`` loading strictly;
- tagger logits and offsets for both encoders;
- one f32 train step (``embed_positions``' gradient included);
- byte-identical ``.lab`` files from ``infer_folder`` and
  ``infer_folder_batched`` for both encoders;
- ``flash_attention_trainable`` at head widths 40 and 24 (zero-padded to
  a multiple of 16) against the Pallas kernel in interpret mode;
- a config without ``conformer_heads`` (the schema's default of 4) at
  Whisper-base's width, hidden 512, narrow otherwise: the Conformer at
  head_dim 128 (route ``mma128`` on the card) in both packages, its logits,
  one f32 train step and the ``.lab`` files.

Tolerances: 1e-4 × max|ref| for encoders and taggers (1500 frames through
layers of f32 sums in another order); the attention 1e-5; the train step
as ``tests/test_torch_train.py``'s."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from wfl_asr_tpu.config import Config as JaxConfig
from wfl_asr_tpu.data.audio import write_wav
from wfl_asr_tpu.models import whisper as JW
from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
from wfl_asr_tpu.models.tagger import apply_tagger, init_tagger
from wfl_asr_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models import whisper as PW
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.ops.kernels import flash_attention_bwd
from wfl_asr_tpu_torch.train import loop as TLOOP

MODEL_TOL = 1e-4
ATTN_TOL = 1e-5
# head_dim 40 in the encoder (80 / 2) and in the Conformer (hidden 80)
NARROW = dict(d_model=80, num_layers=2, num_heads=2, ffn_dim=128)
# Whisper-base's width (8 heads of 64) in 2 narrow layers: under the
# schema's default 4 Conformer heads the Conformer runs head_dim 128
BASE_WIDTH = dict(d_model=512, num_layers=2, num_heads=8, ffn_dim=128)
LABELS = sorted([f"B-p{i}" for i in range(4)] + [f"I-p{i}" for i in range(4)]
                + ["O", "B-SP", "I-SP"])


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, tol=MODEL_TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(),
                               rtol=0)


def raw_config(encoder: str, save_dir: str = "unused", **model) -> dict:
    m = {"encoder_type": encoder, "whisper_model": "openai/whisper-base",
         "wavlm_model": "microsoft/wavlm-base-plus",
         "num_languages": 2, "lang_emb_dim": 16, "enable_bilstm": True,
         "bilstm_num_layer": 2, "num_conformer_layers": 2,
         "conformer_heads": 2, "conformer_ff_expansion": 2,
         "conformer_kernel_size": 31, "conformer_dropout": 0.0,
         "enable_dilated_conv": True, "dilated_conv_depth": 2,
         "dilated_conv_kernel": 3}
    if encoder == "whisper":
        m["encoder_arch_overrides"] = dict(NARROW)
    m.update(model)
    return {"data": {"sample_rate": 16000, "frame_duration": 0.02},
            "model": m, "output": {"save_dir": save_dir},
            "postprocess": {"median_filter": 3, "merge_segments": "right"}}


def build_pair(raw: dict, seed: int = 0):
    """(JAX arch, params, state, port model) with the same weights."""
    arch = JaxTaggerArch.from_config(JaxConfig(raw), len(LABELS))
    params, state = init_tagger(jax.random.PRNGKey(seed), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    parch = PT.TaggerArch.from_config(Config(raw), len(LABELS))
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    return arch, params, state, model.eval()


# ---------------------------------------------------------------------------
# arch tables
# ---------------------------------------------------------------------------

_JAX_ONLY = {"use_flash_attention"}


def _fields(arch, skip=_JAX_ONLY):
    return {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)
            if f.name not in skip}


@pytest.mark.parametrize("name", sorted(JW.WHISPER_PRESETS) + [
    "openai/whisper-base", "openai/whisper-small.en",
    "whisper-large-v3-turbo", "openai/whisper-tiny.en"])
def test_whisper_arch_from_name(name):
    assert _fields(PW.whisper_arch_from_name(name)) == \
        _fields(JW.whisper_arch_from_name(name))


def test_whisper_arch_unknown_name_raises():
    with pytest.raises(ValueError, match="Known presets"):
        PW.whisper_arch_from_name("openai/whisper-huge")


@pytest.mark.parametrize("encoder,model", [
    ("whisper", {}),
    ("whisper", {"whisper_model": "openai/whisper-large-v3",
                 "encoder_arch_overrides": {"num_layers": 2,
                                            "use_flash_attention": True}}),
    ("none", {}), ("null", {"freeze_encoder": True}),
])
@pytest.mark.parametrize("strict", [False, True])
def test_arch_from_config_matches_jax(encoder, model, strict):
    """Every field of the port's arch equals the JAX arch's (strict
    attention dropout reaches the tagger's flag, never the Whisper arch);
    ``none`` takes hidden = n_mels."""
    raw = raw_config(encoder, **model)
    raw["training"] = {"strict_attention_dropout": strict}
    raw["data"]["n_mels"] = 64
    j = JaxTaggerArch.from_config(JaxConfig(raw), 9)
    p = PT.TaggerArch.from_config(Config(raw), 9)
    skip = {"use_flash_attention", "whisper", "wavlm"}
    assert _fields(p, skip) == _fields(j, skip)
    assert p.strict_attention_dropout == strict
    if encoder == "whisper":
        assert _fields(p.whisper) == _fields(j.whisper)
    else:
        assert p.encoder_type == "none" and p.hidden_size == 64
        assert p.whisper is None and p.wavlm is None


def test_arch_unknown_name_with_overrides_warns(capsys):
    raw = raw_config("whisper", whisper_model="my-whisper")
    arch = PT.TaggerArch.from_config(Config(raw), 9)
    assert "[WARN] Unknown whisper model" in capsys.readouterr().out
    assert arch.whisper == PW.WhisperArch(**NARROW)
    raw["model"]["encoder_arch_overrides"] = {"num_layer": 2}
    with pytest.raises(ValueError, match="num_layer"):
        PT.TaggerArch.from_config(Config(raw), 9)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper_pair():
    return build_pair(raw_config("whisper"))


def _feats(n_mels, b=2, seed=0):
    return (np.random.RandomState(seed).randn(b, n_mels, 3000) * 0.5
            ).astype(np.float32)


def test_whisper_encoder_narrow(whisper_pair):
    arch, params, _, model = whisper_pair
    x = _feats(arch.whisper.num_mel_bins)
    ref = JW.whisper_encode(params["encoder"], arch.whisper, jnp.asarray(x))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x))
    assert got.shape == (2, 1500, NARROW["d_model"])
    _close(got.numpy(), ref)


def test_whisper_tiny_full_width():
    """The ``tiny`` preset at full width (384 wide, 6 heads of 64; the
    Conformer at head_dim 192): the encoder on one 30 s log-mel, then the
    tagger's logits and offsets on one 30 s utterance."""
    arch, params, state, model = build_pair(
        raw_config("whisper", whisper_model="openai/whisper-tiny",
                   encoder_arch_overrides=None), seed=1)
    assert arch.whisper.d_model == 384 and model.arch.hidden_size == 384
    x = _feats(80, b=1, seed=2)
    ref = JW.whisper_encode(params["encoder"], arch.whisper, jnp.asarray(x))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x))
    _close(got.numpy(), ref)
    audio = _audio(6, seconds=(30.0,))
    lang = np.array([1], np.int32)
    jl, jo, _ = apply_tagger(params, state, arch, jnp.asarray(audio),
                             jnp.asarray(lang))
    with torch.no_grad():
        pl, po = model(torch.from_numpy(audio), torch.from_numpy(lang))
    assert pl.shape == (1, 1500, len(LABELS))
    _close(pl.numpy(), jl)
    _close(po.numpy(), jo)


def test_jax_written_whisper_pt_loads_strict(whisper_pair, tmp_path):
    from wfl_asr_tpu.checkpoint import save_model_checkpoint as jax_save
    from wfl_asr_tpu_torch.checkpoint import load_model_checkpoint, \
        save_model_checkpoint
    arch, params, state, model = whisper_pair
    path = str(tmp_path / "w.pt")
    jax_save(path, params, state, arch)
    parch = model.arch
    loaded = load_model_checkpoint(path, parch)
    want = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    assert "encoder.embed_positions.weight" in got
    assert "encoder.layers.0.self_attn.k_proj.bias" not in got
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    path2 = str(tmp_path / "port.pt")
    save_model_checkpoint(path2, loaded)
    again = load_model_checkpoint(path2, parch).state_dict()
    assert all(torch.equal(again[k], got[k]) for k in want)


def _audio(seed, seconds=(2.4, 1.7)):
    rng = np.random.RandomState(seed)
    n = int(max(seconds) * 16000)
    a = np.zeros((len(seconds), n), np.float32)
    for i, s in enumerate(seconds):
        a[i, :int(s * 16000)] = rng.randn(int(s * 16000)) * 0.3
    return a


def test_whisper_tagger_logits_and_offsets(whisper_pair):
    arch, params, state, model = whisper_pair
    audio = _audio(4)
    lang = np.array([1, 0], np.int32)
    jl, jo, _ = apply_tagger(params, state, arch, jnp.asarray(audio),
                             jnp.asarray(lang), max_label_len=120)
    with torch.no_grad():
        pl, po = model(torch.from_numpy(audio), torch.from_numpy(lang),
                       max_label_len=120)
    _close(pl.numpy(), jl)
    _close(po.numpy(), jo)


@pytest.mark.parametrize("masked", [False, True])
def test_none_tagger_logits_and_offsets(masked):
    """The mel front end as the hidden states (hidden 80, Conformer
    head_dim 40); masked: unequal valid frames, precentered rows."""
    arch, params, state, model = build_pair(raw_config("none"), seed=2)
    audio = _audio(5)
    lang = np.array([0, 1], np.int32)
    kw, pkw = {}, {}
    if masked:
        lens = np.array([int(2.4 * 16000), int(1.7 * 16000)])
        t = audio.shape[1] // 320 + 1
        frame_mask = np.arange(t)[None] < (lens // 320 + 1)[:, None]
        # the host's exact-length reflect padding, then zeros to the bucket
        rows = np.zeros((2, audio.shape[1] + 400), np.float32)
        for i, n in enumerate(lens):
            rows[i, :n + 400] = np.pad(audio[i, :n], 200, mode="reflect")
        audio = rows
        kw = dict(frame_mask=jnp.asarray(frame_mask), precentered=True)
        pkw = dict(frame_mask=torch.from_numpy(frame_mask), precentered=True)
    jl, jo, _ = apply_tagger(params, state, arch, jnp.asarray(audio),
                             jnp.asarray(lang), **kw)
    with torch.no_grad():
        pl, po = model(torch.from_numpy(audio), torch.from_numpy(lang),
                       **pkw)
    if masked:
        keep = frame_mask[:, :, None]
        jl, jo = np.where(keep, jl, 0), np.where(keep, jo, 0)
        pl, po = (np.where(keep, x.numpy(), 0) for x in (pl, po))
    _close(np.asarray(pl), jl)
    _close(np.asarray(po), jo)


@pytest.mark.parametrize("d", [40, 24])
def test_attention_odd_head_dims_match_jax(d):
    """Forward and backward of ``flash_attention_trainable`` at head widths
    that are no multiple of 16 (zero-padded inside, the true 1/√d)
    against the Pallas kernel, with a ragged key length."""
    rng = np.random.RandomState(d)
    b, h, t = 2, 2, 40
    q, k, v, dout = (rng.randn(b, h, t, d).astype(np.float32)
                     for _ in range(4))
    kv = np.array([t, 23], np.int32)

    def jfn(q, k, v):
        return jax_fat(q, k, v, jnp.asarray(kv))
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_bwd.flash_attention_trainable(
        tq, tk, tv, torch.from_numpy(kv))
    assert out.shape == (b, h, t, d)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATTN_TOL, rtol=0)
    for g, w in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert g.shape == (b, h, t, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=ATTN_TOL * np.abs(w).max(), rtol=0)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _train_batch(num_labels, seed=3):
    from wfl_asr_tpu_torch.train.losses import offset_targets_from_segments
    rng = np.random.RandomState(seed)
    s, lens, max_label = 2400, (22, 17), 50
    audio = (rng.randn(2, s) * 0.3).astype(np.float32)
    audio[1, 1900:] = 0.0
    labels = np.full((2, max_label), -100, np.int64)
    targets = []
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(0, num_labels, size=n)
        segs = [(0.0, 0.07 + 0.01 * i, "a"), (0.07 + 0.01 * i, 0.3, "b"),
                (0.3, 0.41, "a")]
        targets.append(offset_targets_from_segments(segs, 0.02, n, 64))
    f, c, x, v = (np.stack([t[j] for t in targets]) for j in range(4))
    return {"audio": audio, "labels": labels,
            "lang_ids": np.array([0, 1], np.int32), "off_frames": f,
            "off_channels": c, "off_fracs": x, "off_valid": v,
            "label_lengths": np.array(lens, np.int32),
            "max_label_len": max_label}


def test_whisper_train_step_matches_jax(whisper_pair):
    """Dropout 0: loss/ce/offset_loss ≤ 1e-5, every gradient (the trained
    position table's too) ≤ 1e-4 × its max|g|, BatchNorm running stats ≤
    1e-6 (``test_train_step_matches_jax``'s tolerances)."""
    _check_train_step(whisper_pair, raw_config("whisper"))


def _check_train_step(pair, raw):
    """One f32 train step of the port (weights of ``pair``, config
    ``raw``) against the JAX ``make_grad_step`` on ``_train_batch``, at
    ``test_whisper_train_step_matches_jax``'s tolerances."""
    from wfl_asr_tpu.train import loop as JLOOP
    arch, params, state, _ = pair
    batch = _train_batch(arch.num_labels)
    jargs = [jnp.asarray(batch[k]) for k in TLOOP.BATCH_KEYS]
    grad_step = JLOOP.make_grad_step(arch, 0.1, 3.0)
    jgrads, jstate, jm, _, _ = grad_step(
        params, state, jax.random.PRNGKey(1), *jargs,
        max_label_len=batch["max_label_len"])

    parch = PT.TaggerArch.from_config(Config(raw), len(LABELS))
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    m, _, _ = TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0)
    for k in ("loss", "ce", "offset_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    want = export_tagger(jax.tree_util.tree_map(np.asarray, jgrads),
                         jax.tree_util.tree_map(np.asarray, jstate),
                         "whisper")
    names = [n for n, _ in model.named_parameters()]
    assert "encoder.embed_positions.weight" in names
    gmax = max(np.abs(np.asarray(want[n])).max() for n in names)
    for name, p in model.named_parameters():
        w, g = np.asarray(want[name]).reshape(p.shape), p.grad.numpy()
        if np.abs(w).max() <= 1e-6 * gmax:
            # 0 in exact arithmetic (the conv bias before BatchNorm)
            assert np.abs(g).max() <= 1e-6 * gmax, name
            continue
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=name)
    sd = model.state_dict()
    for i, s in enumerate(jstate["conformer"]):
        for key, jk in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                sd[f"conformer_layers.{i}.conv.3.{key}"].numpy(),
                np.asarray(s["bn"][jk]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# .lab byte parity through the folder entry points
# ---------------------------------------------------------------------------

def _make_run(tmp_path, encoder, make_raw=raw_config):
    save_dir = tmp_path / f"save_{encoder}"
    save_dir.mkdir()
    (save_dir / "phonemes.txt").write_text("\n".join(LABELS) + "\n")
    (save_dir / "langs.txt").write_text("en,0\nja,1\n")
    raw = make_raw(encoder, str(save_dir), conformer_dropout=0.15)
    raw["postprocess"]["device_decode"] = True
    config = save_dir / "config.yaml"
    config.write_text(yaml.dump(raw, sort_keys=False))
    arch = JaxTaggerArch.from_config(JaxConfig(raw), len(LABELS))
    params, state = init_tagger(jax.random.PRNGKey(7), arch)
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    ckpt = str(save_dir / "best_model.pt")
    save_model_checkpoint(ckpt, params, state, arch)
    return str(config), ckpt


@pytest.mark.parametrize("encoder", ["whisper", "none"])
def test_lab_parity_folders(tmp_path, encoder):
    """``infer_folder`` (one file at a time, lang 1) and
    ``infer_folder_batched`` (unequal lengths in one forward, languages
    averaged, the device decode) write the JAX package's ``.lab`` files
    byte for byte."""
    _check_lab_parity(tmp_path, encoder)


def _check_lab_parity(tmp_path, encoder, make_raw=raw_config):
    """``test_lab_parity_folders`` for the config ``make_raw`` gives."""
    from wfl_asr_tpu.infer.pipeline import infer_folder as jax_folder
    from wfl_asr_tpu.infer.pipeline import \
        infer_folder_batched as jax_batched
    from wfl_asr_tpu_torch.infer import infer_folder, infer_folder_batched
    config, ckpt = _make_run(tmp_path, encoder, make_raw)
    rng = np.random.RandomState(13)
    wavs = tmp_path / f"wavs_{encoder}"
    wavs.mkdir()
    names = []
    for i, dur in enumerate([0.6, 2.3, 1.4]):
        names.append(f"w{i}.wav")
        write_wav(str(wavs / names[-1]), rng.randn(int(16000 * dur)) * 0.4,
                  16000)
    runs = {"jax_folder": lambda o: jax_folder(
                str(wavs), config, ckpt, o, device="cpu", lang_id=1,
                confidence_threshold=0.1),
            "port_folder": lambda o: infer_folder(
                str(wavs), config, ckpt, o, device="cpu", lang_id=1,
                confidence_threshold=0.1),
            "jax_batched": lambda o: jax_batched(
                str(wavs), config, ckpt, o, lang_id=None,
                confidence_threshold=0.1, batch_files=3,
                data_parallel=False),
            "port_batched": lambda o: infer_folder_batched(
                str(wavs), config, ckpt, o, lang_id=None,
                confidence_threshold=0.1, batch_files=3, device="cpu")}
    for name, run in runs.items():
        run(str(tmp_path / f"out_{name}"))
    for mode in ("folder", "batched"):
        for wav in names:
            lab = wav.replace(".wav", ".lab")
            a = open(tmp_path / f"out_jax_{mode}" / lab).read()
            b = open(tmp_path / f"out_port_{mode}" / lab).read()
            assert a.strip(), "empty .lab: the comparison would be vacuous"
            assert a == b, (mode, lab)


# ---------------------------------------------------------------------------
# the config schema's default of 4 Conformer heads at Whisper-base's width
# ---------------------------------------------------------------------------

def default_heads_config(encoder: str = "whisper", save_dir: str = "unused",
                         **model) -> dict:
    """``raw_config`` at Whisper-base's width (``BASE_WIDTH``) without the
    ``conformer_heads`` key, so each package takes its schema's default."""
    raw = raw_config(encoder, save_dir,
                     encoder_arch_overrides=dict(BASE_WIDTH), **model)
    del raw["model"]["conformer_heads"]
    return raw


@pytest.fixture(scope="module")
def base_width_pair():
    return build_pair(default_heads_config(), seed=4)


def test_default_conformer_heads_run_head_dim_128(base_width_pair):
    """Without ``conformer_heads`` both packages build a 4-head Conformer
    over the 512-wide trunk, so its attention runs head_dim 128, which the
    card sends to route ``mma128`` in both directions."""
    from wfl_asr_tpu_torch.ops.kernels import flash_attention as fa
    arch, _, _, model = base_width_pair
    assert arch.conformer_heads == model.arch.conformer_heads == 4
    assert arch.hidden_size == model.arch.hidden_size == 512
    for block in model.conformer_layers:
        assert block.self_attn.heads == 4
        assert block.self_attn.in_proj_weight.shape == (3 * 512, 512)
    assert fa.forward_route(128, False) == fa.backward_route(128, False) \
        == "mma128"


def test_default_heads_tagger_logits(base_width_pair):
    """Logits and offsets of the 4-head tagger against the JAX tagger."""
    arch, params, state, model = base_width_pair
    audio = _audio(8)
    lang = np.array([0, 1], np.int32)
    jl, jo, _ = apply_tagger(params, state, arch, jnp.asarray(audio),
                             jnp.asarray(lang), max_label_len=120)
    with torch.no_grad():
        pl, po = model(torch.from_numpy(audio), torch.from_numpy(lang),
                       max_label_len=120)
    _close(pl.numpy(), jl)
    _close(po.numpy(), jo)


def test_default_heads_train_step_matches_jax(base_width_pair):
    """One f32 train step of the 4-head tagger against the JAX step, at
    ``test_whisper_train_step_matches_jax``'s tolerances."""
    _check_train_step(base_width_pair, default_heads_config())


def test_default_heads_lab_parity(tmp_path):
    """The 4-head tagger's ``.lab`` files through both folder entry points,
    byte for byte the JAX package's."""
    _check_lab_parity(tmp_path, "whisper", default_heads_config)


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

def _write_corpus(root, n_per_lang=3):
    rng = np.random.RandomState(0)
    for lang in ("en", "ja"):
        d = os.path.join(root, "data", lang)
        os.makedirs(d)
        for i in range(n_per_lang):
            dur = 1.0 + 0.37 * i
            write_wav(os.path.join(d, f"u{i}.wav"),
                      rng.randn(int(dur * 16000)) * 0.3, 16000)
            t, k, lines = 0.0, 0, []
            while t < dur - 0.05:
                e = min(t + 0.1 + 0.05 * (k % 3), dur)
                lines.append(f"{int(t * 1e7)} {int(e * 1e7)} "
                             f"{('a', 'b', 'SP')[(k + i) % 3]}")
                t, k = e, k + 1
            with open(os.path.join(d, f"u{i}.lab"), "w") as f:
                f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("encoder", ["whisper", "none"])
def test_train_driver(tmp_path, encoder):
    """``preprocess`` then ``train`` on the CPU: 2 updates, a validation,
    finite losses, ``last_model.pt`` reloading strictly to the trained
    weights; under ``freeze_encoder`` the Whisper encoder takes no
    update."""
    from wfl_asr_tpu_torch.checkpoint import load_model_checkpoint
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path)
    _write_corpus(root)
    raw = raw_config(encoder, os.path.join(root, "run"),
                     freeze_encoder=encoder == "whisper")
    raw["data"].update(data_dir=os.path.join(root, "data"), num_val_files=2)
    raw["training"] = {
        "batch_size": 2, "optimizer": "Prodigy", "learning_rate": 1,
        "scheduler": "ConstantLR", "max_steps": 2, "val_check_interval": 2,
        "max_checkpoints": 1, "log_dir": os.path.join(root, "run", "logs"),
        "seed": 0}
    preprocess(raw["data"]["data_dir"], raw)
    cfg = Config.load(os.path.join(root, "run", "config.yaml"))
    init = PT.init_tagger(PT.TaggerArch.from_config(cfg, 7),
                          torch.Generator().manual_seed(cfg.seed))
    model = TLOOP.train(cfg, device="cpu")
    events = [json.loads(x) for x in
              open(os.path.join(root, "run", "logs", "metrics.jsonl"))]
    losses = [e["loss"] for e in events if e["event"] in ("train", "val")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    last = load_model_checkpoint(os.path.join(root, "run", "last_model.pt"),
                                 model.arch)
    got, start = last.state_dict(), init.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    if encoder == "whisper":
        assert all(torch.equal(got[k], start[k]) for k in got
                   if k.startswith("encoder."))
        assert not torch.equal(got["classifier.weight"],
                               start["classifier.weight"])
    else:
        assert not any(k.startswith("encoder.") for k in got)
