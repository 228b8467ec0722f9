"""Module-by-module parity of the PyTorch port (``wfl_asr_tpu_torch``) with
the JAX package on the CPU, in f32: the same numpy inputs (seeded) through
both, the JAX side under ``jax.default_matmul_precision("highest")``.

Weights come from the JAX ``init_tagger`` and cross over through
``state_dict_from_jax`` + ``load_state_dict(strict=True)`` — the carry-across
itself is under test. Tolerances: 1e-5 max abs per module, 1e-4 for the
encoder and the whole tagger."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from wfl_asr_tpu.models import heads as JH
from wfl_asr_tpu.models import layers as JL
from wfl_asr_tpu.models.tagger import apply_tagger, init_tagger
from wfl_asr_tpu.models.wavlm import wavlm_encode
from wfl_asr_tpu.ops import frontend as JF
from wfl_asr_tpu.ops import postprocess as JP
from wfl_asr_tpu_torch.models import heads as PH
from wfl_asr_tpu_torch.models import layers as PL
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import state_dict_from_jax
from wfl_asr_tpu_torch.ops import frontend as PF
from wfl_asr_tpu_torch.ops import postprocess as PP

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4


def jax_kernel_arch(arch):
    """The JAX arch with its Pallas kernels switched on (interpret mode on
    the CPU), as the JAX session does on an accelerator."""
    return dataclasses.replace(
        arch, use_flash_attention=True,
        wavlm=dataclasses.replace(arch.wavlm, use_flash_attention=True,
                                  use_fused_conv=True))


def _common_fields(cls, obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if f.name not in skip}


def port_arch(arch) -> PT.TaggerArch:
    """The port's TaggerArch with the same fields as a JAX TaggerArch (the
    port keeps only the fields its inference reads)."""
    return PT.TaggerArch(
        **_common_fields(PT.TaggerArch, arch, skip=("wavlm",)),
        wavlm=PT.WavLMArch(**_common_fields(PT.WavLMArch, arch.wavlm)))


def build_pair(seed: int = 0, tiny: bool = True):
    """(jax_arch, params, state, port_model) with the same weights."""
    arch = jax_kernel_arch(graft._flagship_arch(tiny=tiny))
    params, state = init_tagger(jax.random.PRNGKey(seed), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    parch = port_arch(arch)
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    return arch, params, state, model.eval()


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=MODULE_TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


def _frame_mask(b, t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


# ---------------------------------------------------------------------------
# layers / frontend
# ---------------------------------------------------------------------------

def test_layer_norm_and_stats():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 30, 24).astype(np.float32) * 3 + 1
    ln = torch.nn.LayerNorm(24)
    with torch.no_grad():
        ln.weight.copy_(_t(rng.randn(24).astype(np.float32)))
        ln.bias.copy_(_t(rng.randn(24).astype(np.float32)))
    ref = JL.layer_norm({"scale": ln.weight.numpy(), "bias": ln.bias.numpy()},
                        jnp.asarray(x))
    _close(PL.layer_norm(ln, _t(x)), ref)

    mask = _frame_mask(2, 30, [30, 17])
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        pm = None if m is None else _t(m)
        for got, want in zip(PL.channel_stats(_t(x), pm),
                             JL.channel_stats(jnp.asarray(x), jm)):
            _close(got, want)
        xc = np.swapaxes(x, 1, 2).copy()
        scale, bias = rng.randn(24).astype(np.float32), \
            rng.randn(24).astype(np.float32)
        _close(PL.group_norm(_t(scale), _t(bias), _t(xc), 24, time_mask=pm),
               JL.group_norm(jnp.asarray(scale), jnp.asarray(bias),
                             jnp.asarray(xc), 24, time_mask=jm))


def test_wav2vec2_normalize_masked():
    rng = np.random.RandomState(1)
    audio = (rng.randn(2, 500) * 0.3 + 0.05).astype(np.float32)
    mask = np.arange(500)[None, :] < np.array([[500], [321]])
    _close(PF.wav2vec2_normalize(_t(audio)),
           JF.wav2vec2_normalize(jnp.asarray(audio)))
    _close(PF.wav2vec2_normalize_masked(_t(audio), _t(mask)),
           JF.wav2vec2_normalize_masked(jnp.asarray(audio),
                                        jnp.asarray(mask)))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [None, (40, 23)])
def test_bilstm_valid_frames(pair, lengths):
    _, params, _, model = pair
    rng = np.random.RandomState(2)
    x = rng.randn(2, 40, 64).astype(np.float32)
    mask = None if lengths is None else _frame_mask(2, 40, lengths)
    ref = np.asarray(JH.bilstm(params["bilstm"], jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
    out = PH.bilstm(model.bilstm, _t(x),
                    None if mask is None else _t(mask)).numpy()
    for i, n in enumerate(lengths or (40, 40)):
        _close(out[i, :n], ref[i, :n])


@pytest.mark.parametrize("lengths", [None, (40, 23)])
def test_conformer_block(pair, lengths):
    arch, params, state, model = pair
    rng = np.random.RandomState(3)
    x = rng.randn(2, 40, 64).astype(np.float32)
    mask = None if lengths is None else _frame_mask(2, 40, lengths)
    ref, _ = JH.conformer_block(
        params["conformer"][0], state["conformer"][0], jnp.asarray(x),
        arch.conformer_heads, arch.conformer_kernel, 0.0, None,
        deterministic=True, train=False,
        mask=None if mask is None else jnp.asarray(mask), use_flash=True)
    out = model.conformer_layers[0](_t(x), None if mask is None else _t(mask))
    ref = np.asarray(ref)
    for i, n in enumerate(lengths or (40, 40)):
        _close(out[i, :n], ref[i, :n])


@pytest.mark.parametrize("lengths", [None, (40, 23)])
def test_dilated_offset_lang(pair, lengths):
    arch, params, _, model = pair
    rng = np.random.RandomState(4)
    x = rng.randn(2, 40, 64).astype(np.float32)
    mask = None if lengths is None else _frame_mask(2, 40, lengths)
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else _t(mask)
    _close(PH.dilated_stack(model.dilated_conv_stack, _t(x),
                            arch.dilated_kernel, pm),
           JH.dilated_stack(params["dilated"], jnp.asarray(x),
                            arch.dilated_kernel, jm))
    _close(PH.offset_head(model.boundary_offset_head, _t(x), pm),
           JH.offset_head(params["offset_head"], jnp.asarray(x), jm))
    lang = np.array([1, 0], np.int32)
    _close(PH.lang_conditioning(model.lang_emb, model.lang_proj, _t(x),
                                _t(lang)),
           JH.lang_conditioning(params["lang"], jnp.asarray(x),
                                jnp.asarray(lang)))


# ---------------------------------------------------------------------------
# encoder and tagger
# ---------------------------------------------------------------------------

def _audio_batch(arch, seed, samples=(8000, 5731)):
    rng = np.random.RandomState(seed)
    s = max(samples)
    audio = (rng.randn(len(samples), s) * 0.3).astype(np.float32)
    smask = np.arange(s)[None, :] < np.array(samples)[:, None]
    t = arch.wavlm.feature_lengths(s)
    lengths = [arch.wavlm.feature_lengths(n) for n in samples]
    return audio, smask, _frame_mask(len(samples), t, lengths), lengths


@pytest.mark.parametrize("masked", [False, True])
def test_wavlm_encoder(pair, masked):
    arch, params, _, model = pair
    audio, smask, fmask, lengths = _audio_batch(arch, 5)
    normed = np.asarray(JF.wav2vec2_normalize(jnp.asarray(audio)))
    if not masked:
        smask = fmask = None
        lengths = [arch.wavlm.feature_lengths(normed.shape[1])] * 2
    ref = np.asarray(wavlm_encode(
        params["encoder"], arch.wavlm, jnp.asarray(normed),
        mask=None if fmask is None else jnp.asarray(fmask),
        sample_mask=None if smask is None else jnp.asarray(smask)))
    out = model.encoder(_t(normed), mask=None if fmask is None else _t(fmask),
                        sample_mask=None if smask is None else _t(smask))
    assert tuple(out.shape) == ref.shape
    for i, n in enumerate(lengths):
        _close(out[i, :n], ref[i, :n], MODEL_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_tagger_logits_and_offsets(pair, masked):
    arch, params, state, model = pair
    audio, smask, fmask, lengths = _audio_batch(arch, 6)
    if not masked:
        smask = fmask = None
        lengths = [arch.wavlm.feature_lengths(audio.shape[1])] * 2
    lang = np.array([0, 1], np.int32)
    lj, oj, _ = apply_tagger(
        params, state, arch, jnp.asarray(audio), jnp.asarray(lang),
        sample_mask=None if smask is None else jnp.asarray(smask),
        frame_mask=None if fmask is None else jnp.asarray(fmask))
    lt, ot = model(_t(audio), _t(lang),
                   sample_mask=None if smask is None else _t(smask),
                   frame_mask=None if fmask is None else _t(fmask))
    lj, oj = np.asarray(lj), np.asarray(oj)
    for i, n in enumerate(lengths):
        _close(lt[i, :n], lj[i, :n], MODEL_TOL)
        _close(ot[i, :n], oj[i, :n], MODEL_TOL)


def test_max_label_len_trim_and_pad(pair):
    arch, params, state, model = pair
    audio, _, _, _ = _audio_batch(arch, 7, samples=(4000, 4000))
    lang = np.array([1, 1], np.int32)
    for max_len in (150, 230):
        lj, _, _ = apply_tagger(params, state, arch, jnp.asarray(audio),
                                jnp.asarray(lang), max_label_len=max_len)
        lt, _ = model(_t(audio), _t(lang), max_label_len=max_len)
        _close(lt, lj, MODEL_TOL)


# ---------------------------------------------------------------------------
# weight carry-across
# ---------------------------------------------------------------------------

def test_state_dict_keys_are_the_reference_schema(pair):
    arch, params, state, model = pair
    keys = set(model.state_dict())
    assert "encoder.encoder.layers.0.attention.rel_attn_embed.weight" in keys
    assert "encoder.encoder.layers.1.attention.rel_attn_embed.weight" \
        not in keys
    assert model.state_dict()[
        "encoder.encoder.layers.0.attention.gru_rel_pos_const"].shape == \
        (1, arch.wavlm.num_heads, 1, 1)
    for k in ("encoder.encoder.pos_conv_embed.conv.parametrizations.weight"
              ".original0", "bilstm.weight_ih_l1_reverse",
              "conformer_layers.1.self_attn.in_proj_weight",
              "conformer_layers.0.conv.3.num_batches_tracked",
              "dilated_conv_stack.2.weight", "boundary_offset_head.2.bias"):
        assert k in keys, k


def test_jax_written_pt_loads_strict(pair, tmp_path):
    from wfl_asr_tpu.checkpoint import save_model_checkpoint as jax_save
    from wfl_asr_tpu_torch.checkpoint import load_model_checkpoint, \
        save_model_checkpoint
    arch, params, state, model = pair
    path = str(tmp_path / "jax.pt")
    jax_save(path, params, state, arch)
    loaded = load_model_checkpoint(path, port_arch(arch))
    want = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    # and the port's own .pt round-trips
    path2 = str(tmp_path / "port.pt")
    save_model_checkpoint(path2, loaded)
    again = load_model_checkpoint(path2, port_arch(arch)).state_dict()
    for k in want:
        assert torch.equal(again[k], got[k])


def test_init_tagger_is_seeded():
    arch = port_arch(graft._flagship_arch(tiny=True))
    a = PT.init_tagger(arch, torch.Generator().manual_seed(3)).state_dict()
    b = PT.init_tagger(arch, torch.Generator().manual_seed(3)).state_dict()
    c = PT.init_tagger(arch, torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classifier.weight"], c["classifier.weight"])


def test_arch_from_config_matches_jax():
    """The same config dict gives the JAX arch's values in every field the
    port keeps, the dropout, LayerDrop and freeze fields included. JAX-only
    override keys (the kernel switches, strict attention dropout) are
    dropped; any other unknown key raises."""
    from wfl_asr_tpu.config import Config as JaxConfig
    from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
    from wfl_asr_tpu_torch.config import Config
    overrides = dict(hidden_size=64, num_layers=2, num_heads=4,
                     conv_dim=[32] * 7, use_flash_attention=True,
                     use_fused_conv=True, layerdrop=0.2,
                     attention_dropout=0.3)
    raw = {"model": {"encoder_type": "wavlm",
                     "wavlm_model": "microsoft/wavlm-base-plus",
                     "encoder_arch_overrides": overrides,
                     "num_languages": 2, "conformer_heads": 2,
                     "dilated_conv_depth": 3, "conformer_dropout": 0.2,
                     "freeze_encoder": True}}
    jax_arch = JaxTaggerArch.from_config(JaxConfig(raw), 11)
    arch = PT.TaggerArch.from_config(Config(raw), 11)
    assert arch == port_arch(jax_arch)
    assert arch.wavlm.conv_dim == (32,) * 7 and arch.hidden_size == 64
    assert (arch.wavlm.layerdrop, arch.wavlm.attention_dropout,
            arch.wavlm.feat_proj_dropout, arch.conformer_dropout,
            arch.freeze_encoder) == (0.2, 0.3, 0.1, 0.2, True)
    raw["model"]["encoder_arch_overrides"] = dict(overrides, hiden_size=8)
    with pytest.raises(ValueError, match="hiden_size"):
        PT.TaggerArch.from_config(Config(raw), 11)


# ---------------------------------------------------------------------------
# postprocess ops
# ---------------------------------------------------------------------------

LABELS = ["B-a", "I-a", "B-b", "I-b", "O", "B-SP", "I-SP", "junk"]


def test_confidence_gate_and_median():
    rng = np.random.RandomState(8)
    logits = (rng.randn(3, 57, len(LABELS)) * 2).astype(np.float32)
    ids_j = JP.confidence_gate_ids(jnp.asarray(logits), jnp.float32(0.4), 4)
    ids_t = PP.confidence_gate_ids(_t(logits), 0.4, 4)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    for size in (1, 2, 3, 5, 8):
        np.testing.assert_array_equal(
            PP.median_filter_ids(ids_t, size).numpy(),
            np.asarray(JP.median_filter_ids(ids_j, size)))
        for length in (0, 1, 4, 40, 57):
            np.testing.assert_array_equal(
                PP.median_filter_ids_masked(ids_t[0], size, length).numpy(),
                np.asarray(JP.median_filter_ids_masked(
                    ids_j[0], size, jnp.int32(length))))


def test_extract_segments_ids():
    rng = np.random.RandomState(9)
    kind, ph, names = PP.bio_tables(LABELS)
    jkind, jph, jnames = JP.bio_tables(LABELS)
    np.testing.assert_array_equal(kind, jkind)
    np.testing.assert_array_equal(ph, jph)
    assert names == jnames
    for trial in range(6):
        t = 50
        ids = rng.randint(0, len(LABELS), size=t).astype(np.int32)
        offsets = rng.rand(t, 2).astype(np.float32)
        length = [50, 37, 1, 0, 12, 50][trial]
        want = JP.extract_segments_ids(jnp.asarray(ids), jnp.asarray(offsets),
                                       jnp.int32(length), jnp.asarray(kind),
                                       jnp.asarray(ph))
        got = PP.extract_segments_ids(_t(ids), _t(offsets), length,
                                      _t(kind), _t(ph))
        count = int(np.asarray(want[-1]))
        assert int(got[-1]) == count
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(g.numpy()[:count],
                                          np.asarray(w)[:count])
