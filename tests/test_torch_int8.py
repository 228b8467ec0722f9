"""int8 serving in the port (``model.serving_quantization: int8``,
W8A8-dynamic) against the JAX package's (``models/layers.py``
``quantize_linear_int8`` / ``_linear_int8`` / ``quantize_tree_int8``,
``infer/pipeline.py``) on the CPU: the weight codes and scales bit for
bit, the int8 linear ≤ 1e-6 × max|y|, a zero row, the set of quantized
linears for narrow WavLM and Whisper encoders, a narrow WavLM tagger
forward ≤ 1e-3 × max|logits|, and the session flag end to end (``.lab``
lines against the JAX int8 session's).

    python -m pytest tests/test_torch_int8.py -q
"""

import difflib
import os

import numpy as np
import pytest
import torch
import yaml
from torch import nn

import jax
import jax.numpy as jnp

from wfl_asr_tpu.config import Config as JaxConfig
from wfl_asr_tpu.models import layers as JLAYERS
from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
from wfl_asr_tpu.models.tagger import apply_tagger, init_tagger
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.data.audio import write_wav
from wfl_asr_tpu_torch.models import layers as L
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_wavlm, \
    export_whisper_encoder, state_dict_from_jax

LABELS = sorted([f"B-p{i}" for i in range(4)] + [f"I-p{i}" for i in range(4)]
                + ["O", "B-SP", "I-SP"])
# both dims of every encoder linear ≥ 256, so each is quantized; WavLM's
# full conv recipe (20 ms frames) at 64 channels
WAVLM_NARROW = dict(hidden_size=256, num_layers=2, num_heads=4,
                    intermediate_size=512, conv_dim=[64] * 7,
                    conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                    conv_stride=[5, 2, 2, 2, 2, 2, 2],
                    num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4, num_buckets=40,
                    max_distance=100)
WHISPER_NARROW = dict(d_model=256, num_layers=2, num_heads=4, ffn_dim=512)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _raw(encoder, save_dir="unused", quant="none", **model):
    m = {"encoder_type": encoder, "wavlm_model": "microsoft/wavlm-base-plus",
         "whisper_model": "openai/whisper-base",
         "encoder_arch_overrides": dict(
             WAVLM_NARROW if encoder == "wavlm" else WHISPER_NARROW),
         "num_languages": 2, "lang_emb_dim": 16, "enable_bilstm": True,
         "bilstm_num_layer": 1, "num_conformer_layers": 1,
         "conformer_heads": 2, "conformer_ff_expansion": 2,
         "conformer_dropout": 0.0, "enable_dilated_conv": True,
         "serving_quantization": quant}
    m.update(model)
    return {"data": {"sample_rate": 16000, "frame_duration": 0.02},
            "model": m, "output": {"save_dir": save_dir},
            "postprocess": {"median_filter": 3, "merge_segments": "right"}}


def _linear(rng, d_in, d_out, bias=True):
    mod = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(
            (rng.randn(d_out, d_in) * 0.05).astype(np.float32)))
        if bias:
            mod.bias.copy_(torch.from_numpy(
                (rng.randn(d_out) * 0.01).astype(np.float32)))
    jp = {"w": jnp.asarray(mod.weight.detach().numpy().T)}
    if bias:
        jp["b"] = jnp.asarray(mod.bias.detach().numpy())
    return mod, jp


@pytest.mark.parametrize("bias", [True, False])
def test_weight_codes_bit_for_bit(bias):
    mod, jp = _linear(np.random.RandomState(0), 512, 1024, bias)
    with torch.no_grad():
        mod.weight[7] = 0.0                      # a zero output channel
    jp["w"] = jnp.asarray(mod.weight.detach().numpy().T)
    q = L.quantize_linear_int8(mod)
    jq = JLAYERS.quantize_linear_int8(jp)
    assert q.w_q.dtype == torch.int8 and q.w_q.shape == (1024, 512)
    np.testing.assert_array_equal(q.w_q.numpy(), np.asarray(jq["w_q"]).T)
    np.testing.assert_array_equal(q.w_scale.numpy(),
                                  np.asarray(jq["w_scale"]))
    assert q.w_scale[7] == np.float32(1e-12)
    assert (q.bias is None) == (not bias)


@pytest.mark.parametrize("shape, dtype", [
    ((16, 512), "float32"), ((2, 37, 512), "float32"),
    ((3, 512), "bfloat16")])
def test_int8_linear_matches_jax(shape, dtype):
    rng = np.random.RandomState(1)
    mod, jp = _linear(rng, 512, 256)
    x = (rng.randn(*shape) * 1.3).astype(np.float32)
    q = L.quantize_linear_int8(mod)
    jq = JLAYERS.quantize_linear_int8(jp)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    got = L.linear(q, xt)
    want = np.asarray(JLAYERS.linear(jq, jnp.asarray(xt.float().numpy())
                                     .astype(getattr(jnp, dtype)))
                      .astype(jnp.float32))
    assert got.dtype == tdt and got.shape == shape[:-1] + (256,)
    got = got.float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                               rtol=0)
    # and close to the float product (W8A8 is ~0.5 % off at these stats)
    exact = L.linear(mod, torch.from_numpy(x)).detach().numpy()
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02


def test_zero_row_gives_zeros():
    q = L.quantize_linear_int8(nn.Linear(256, 256, bias=False))
    out = L.linear(q, torch.zeros(4, 256))
    assert torch.equal(out, torch.zeros(4, 256))


def test_int8_matmul_is_exact():
    """The int32 accumulator equals the exact integer product, rows padded
    or not (the padding is taken on CUDA tensors only)."""
    rng = np.random.RandomState(2)
    for m in (1, 5, 17, 40):
        a = rng.randint(-127, 128, size=(m, 256)).astype(np.int8)
        w = rng.randint(-127, 128, size=(64, 256)).astype(np.int8)
        got = L.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def _jax_quantized_names(encoder, params):
    """The torch module names of the linears ``quantize_tree_int8`` picks
    in a JAX encoder tree: every picked "w" set to ones and the rest to
    zeros, exported to torch keys."""
    picked = JLAYERS.quantize_tree_int8(params)

    def mark(orig, q):
        if isinstance(orig, dict):
            if "w_q" in q:
                return {k: (np.ones_like(np.asarray(v)) if k == "w"
                            else np.zeros_like(np.asarray(v)))
                        for k, v in orig.items()}
            return {k: mark(orig[k], q[k]) for k in orig}
        if isinstance(orig, (list, tuple)):
            return [mark(a, b) for a, b in zip(orig, q)]
        return np.zeros_like(np.asarray(orig))
    export = export_wavlm if encoder == "wavlm" else export_whisper_encoder
    return {k[:-len(".weight")] for k, v in
            export(mark(params, picked)).items()
            if k.endswith(".weight") and v.size > 1 and np.all(v == 1)}


@pytest.mark.parametrize("encoder, overrides", [
    ("wavlm", {}), ("wavlm", {"conv_dim": [256] * 7}),
    ("whisper", {}), ("whisper", {"d_model": 128, "ffn_dim": 512})])
def test_quantized_set_matches_quantize_tree(encoder, overrides):
    from wfl_asr_tpu.models.wavlm import init_wavlm
    from wfl_asr_tpu.models.whisper import init_whisper_encoder
    raw = _raw(encoder)
    raw["model"]["encoder_arch_overrides"].update(overrides)
    arch = JaxTaggerArch.from_config(JaxConfig(raw), len(LABELS))
    if encoder == "wavlm":
        params = init_wavlm(jax.random.PRNGKey(0), arch.wavlm)
    else:
        params = init_whisper_encoder(jax.random.PRNGKey(0), arch.whisper)
    params = jax.tree_util.tree_map(np.asarray, params)
    want = _jax_quantized_names(encoder, params)
    parch = PT.TaggerArch.from_config(Config(raw), len(LABELS))
    model = PT.BIOPhonemeTagger(parch)
    got = set(L.quantize_int8(model.encoder))
    assert got == want
    n_layers = raw["model"]["encoder_arch_overrides"]["num_layers"]
    if overrides.get("d_model") == 128:
        assert got == set()
    else:
        assert len(got) >= 6 * n_layers
    assert all(isinstance(model.encoder.get_submodule(n), L.Int8Linear)
               for n in got)


def test_wavlm_forward_matches_jax_int8(monkeypatch):
    """A narrow WavLM tagger's int8 forward against the JAX one (its
    ``apply_tagger`` run op by op): logits and offsets ≤ 1e-3 × their max.
    The float paths between the quantized linears differ by ~1e-6, so an
    activation at a rounding tie may take the next int8 code; one such
    flip moves an output by ~1/(127·√K) of its size, and the layers after
    it carry that on. Each quantized linear, replayed through JAX's
    ``_linear_int8`` on the activations the port's forward gave it,
    equals the port's output bit for bit."""
    raw = _raw("wavlm")
    arch = JaxTaggerArch.from_config(JaxConfig(raw), len(LABELS))
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.RandomState(2)
    audio = (rng.randn(2, 24000) * 0.3).astype(np.float32)
    langs = np.array([0, 1], np.int32)
    qparams = dict(params)
    qparams["encoder"] = JLAYERS.quantize_tree_int8(params["encoder"])
    want_lg, want_off, _ = apply_tagger(qparams, state, arch,
                                        jnp.asarray(audio),
                                        jnp.asarray(langs))
    want_lg, want_off = np.asarray(want_lg), np.asarray(want_off)

    parch = PT.TaggerArch.from_config(Config(raw), len(LABELS))
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    model.eval()
    assert len(L.quantize_int8(model.encoder)) == 12
    calls = []
    real = L.linear_int8

    def recorded(mod, x):
        y = real(mod, x)
        calls.append((mod, x.clone(), y.clone()))
        return y
    monkeypatch.setattr(L, "linear_int8", recorded)
    with torch.no_grad():
        lg, off = model(torch.from_numpy(audio),
                        torch.from_numpy(langs.astype(np.int64)))
    lg, off = lg.numpy(), off.numpy()
    worst = np.abs(lg - want_lg).max() / np.abs(want_lg).max()
    print(f"int8 WavLM logits: worst |diff| {worst:.3e} × max|logits|")
    assert worst <= 1e-3
    assert np.abs(off - want_off).max() <= 1e-3 * np.abs(want_off).max()
    assert len(calls) == 12
    for mod, x, y in calls:
        jp = {"w_q": jnp.asarray(mod.w_q.numpy().T),
              "w_scale": jnp.asarray(mod.w_scale.numpy()),
              "b": jnp.asarray(mod.bias.numpy())}
        np.testing.assert_array_equal(
            np.asarray(JLAYERS._linear_int8(jp, jnp.asarray(x.numpy()))),
            y.numpy())


def test_session_flag_end_to_end(tmp_path, capsys):
    """``serving_quantization: int8`` through both packages' batched
    folder mode on the same JAX-written ``.pt``: the port's ``.lab`` lines
    agree with the JAX int8 session's in ≥ 99 % of lines; unknown values
    raise; the ``none`` encoder has nothing to quantize."""
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    from wfl_asr_tpu.infer.pipeline import infer_folder_batched as jax_fold
    from wfl_asr_tpu_torch.infer import InferenceSession, \
        infer_folder_batched
    save = tmp_path / "save"
    save.mkdir()
    (save / "phonemes.txt").write_text("\n".join(LABELS) + "\n")
    (save / "langs.txt").write_text("en,0\nja,1\n")
    raw = _raw("wavlm", str(save), quant="int8")
    raw["postprocess"] = {"median_filter": 1, "merge_segments": "none"}
    cfg_path = save / "config.yaml"
    cfg_path.write_text(yaml.dump(raw, sort_keys=False))
    arch = JaxTaggerArch.from_config(JaxConfig(raw), len(LABELS))
    params, state = init_tagger(jax.random.PRNGKey(3), arch)
    # a classifier 30× the init's scale, so the random model's frames take
    # many labels and the .lab files many lines
    params["classifier"]["w"] = params["classifier"]["w"] * 30.0
    ckpt = str(save / "best_model.pt")
    save_model_checkpoint(ckpt, params, state, arch)

    rng = np.random.RandomState(4)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, seconds in enumerate((2.7, 1.9, 3.4)):
        write_wav(str(wavs / f"w{i}.wav"), rng.randn(int(16000 * seconds))
                  * 0.4, 16000)
    jax_fold(str(wavs), str(cfg_path), ckpt, str(tmp_path / "jax"),
             lang_id=0, confidence_threshold=0.0, batch_files=3,
             data_parallel=False)
    infer_folder_batched(str(wavs), str(cfg_path), ckpt,
                         str(tmp_path / "port"), lang_id=0,
                         confidence_threshold=0.0, batch_files=3,
                         device="cpu")
    assert "int8 serving: encoder linears quantized" in capsys.readouterr().out
    same = total = 0
    for i in range(3):
        a = open(tmp_path / "jax" / f"w{i}.lab").read().splitlines()
        b = open(tmp_path / "port" / f"w{i}.lab").read().splitlines()
        blocks = difflib.SequenceMatcher(a=a, b=b,
                                         autojunk=False).get_matching_blocks()
        same += sum(blk.size for blk in blocks)
        total += max(len(a), len(b))
    print(f"int8 session .lab lines: {same} of {total} agree")
    assert total > 30 and same >= 0.99 * total

    session = InferenceSession(str(cfg_path), ckpt, device="cpu")
    assert len(session.quantized) == 12
    assert "encoder.layers.0.attention.q_proj" in session.quantized
    assert isinstance(session.model.encoder.encoder.layers[0].feed_forward
                      .intermediate_dense, L.Int8Linear)

    bad = dict(raw)
    bad["model"] = dict(raw["model"], serving_quantization="fp4")
    with pytest.raises(ValueError, match="serving_quantization"):
        InferenceSession(bad, ckpt, device="cpu")

    none = _raw("none", str(save), quant="int8", n_mels=80)
    none["model"].pop("encoder_arch_overrides")
    narch = JaxTaggerArch.from_config(JaxConfig(none), len(LABELS))
    nparams, nstate = init_tagger(jax.random.PRNGKey(0), narch)
    nckpt = str(tmp_path / "none.pt")
    save_model_checkpoint(nckpt, nparams, nstate, narch)
    s_none = InferenceSession(none, nckpt, device="cpu")
    assert s_none.quantized == []
    lg, _ = s_none.forward(rng.randn(8000).astype(np.float32) * 0.4, [0])
    assert np.isfinite(lg).all()
