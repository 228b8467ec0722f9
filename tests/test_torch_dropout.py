"""Strict attention dropout (K6) in the PyTorch port against the JAX package
on the CPU: the hash mask bit for bit, the attention entry points' plain
twins against the JAX Pallas kernels with in-kernel dropout (interpret mode,
the same int32 seed) in the forward and every cotangent, the input checks,
the WavLM/Conformer wiring with seeds injected on both sides, one strict
train step of the tiny flagship against ``make_grad_step``, and the train
loop with ``training.strict_attention_dropout: true``.

The CUDA kernels that evaluate the same hash run only on the card;
``chip_smoke.py`` holds them against these plain twins there (phases 3c,
3d, 6b, 7b).

    python -m pytest tests/test_torch_dropout.py -q
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_torch_train import _opt_raw, _tiny_batch, make_config, make_data, \
    port_arch
from wfl_asr_tpu.ops.pallas import dropout_mask as JD
from wfl_asr_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from wfl_asr_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_trainable as jax_fat
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import heads as PH
from wfl_asr_tpu_torch.models import layers as PL
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.ops.kernels import dropout_mask as TD
from wfl_asr_tpu_torch.ops.kernels import flash_attention, \
    flash_attention_bwd
from wfl_asr_tpu_torch.train import loop as TLOOP

# the JAX dropout test's own tolerances (tests/test_flash_dropout.py)
F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------------------
# 1. the hash
# ---------------------------------------------------------------------------

SEEDS = [0, 1, -1, -2 ** 31, 2 ** 31 - 1] + [
    int(s) for s in np.random.RandomState(0).randint(-2 ** 31, 2 ** 31 - 1,
                                                     size=3)]


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform24_bit_exact(seed):
    """The port's uniform24 = JAX's, over b, h ≤ 16 and q, k ≤ 4096."""
    rng = np.random.RandomState(seed & 0xFFFF)
    q = np.concatenate([np.arange(64), rng.randint(0, 4097, 60),
                        [4095, 4096]]).astype(np.int32)[:, None]
    k = np.concatenate([np.arange(64), rng.randint(0, 4097, 60),
                        [4095, 4096]]).astype(np.int32)[None, :]
    for b, h in ((0, 0), (1, 11), (16, 16), (7, 3)):
        want = np.asarray(JD.uniform24(jnp.int32(seed), b, h, jnp.asarray(q),
                                       jnp.asarray(k)))
        got = TD.uniform24(torch.tensor(seed, dtype=torch.int32), b, h,
                           torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str((b, h)))


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.15, 0.25, 0.5, 0.999])
def test_keep_threshold_and_share(rate):
    assert TD.keep_threshold(rate) == JD.keep_threshold(rate)
    q = jnp.arange(512, dtype=jnp.int32)[:, None]
    k = jnp.arange(512, dtype=jnp.int32)[None, :]
    want = np.asarray(JD.keep_mask_f32(jnp.int32(42), 1, 2, q, k, rate))
    got = TD.keep_mask(42, 1, 2, torch.arange(512)[:, None],
                       torch.arange(512)[None, :], rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(float((got > 0).mean()) - (1.0 - rate)) <= 0.01


@pytest.mark.parametrize("dtype,rate", [("f32", 0.15), ("bf16", 0.2)])
def test_prob_dropout_oracle_matches_jax(dtype, rate):
    """attention_prob_dropout_plain = JAX's
    attention_prob_dropout_reference on a [B, H, Tq, Tk] probability
    tensor, bitwise."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    probs = np.random.RandomState(6).rand(2, 3, 40, 56).astype(np.float32)
    seed = -123456789
    want = JD.attention_prob_dropout_reference(jnp.asarray(probs, jdt),
                                               jnp.int32(seed), rate)
    got = TD.attention_prob_dropout_plain(torch.from_numpy(probs).to(tdt),
                                          seed, rate)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# 2-3. the entry points' plain twins against the JAX kernels with dropout
# ---------------------------------------------------------------------------

def _to_jnp(x, dtype):
    return None if x is None else jnp.asarray(x, dtype)


def _to_torch(x, dtype):
    return None if x is None else torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gated_dropout_matches_jax(dtype, rate):
    """flash_attention with bias, gate, ragged kv_len and dropout: forward
    and dq, dk, dv, dbias, dgate against the JAX kernel at the same seed."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rng = np.random.RandomState(int(rate * 10) + len(dtype))
    b, h, t, d = 2, 2, 96, 32
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) * 0.3
               for _ in range(3))
    bias = rng.randn(h, t, t).astype(np.float32) * 0.2
    gate = (rng.rand(b, h, t) * 0.5 + 0.5).astype(np.float32)
    kv_len = np.array([90, 61], np.int32)
    g = rng.randn(b, h, t, d).astype(np.float32) * 0.3
    seed = int(rng.randint(-2 ** 31, 2 ** 31 - 1))

    def jfn(q_, k_, v_, bias_, gate_):
        return jax_fa(q_, k_, v_, bias_, gate_, jnp.asarray(kv_len),
                      dropout_rate=rate, dropout_seed=jnp.int32(seed))
    jin = [_to_jnp(x, jdt) for x in (q, k, v, bias)] + [jnp.asarray(gate)]
    want_out, vjp = jax.vjp(jfn, *jin)
    want = vjp(jnp.asarray(g, jdt))

    leaves = [_to_torch(x, tdt).requires_grad_() for x in (q, k, v, bias)]
    leaves.append(torch.from_numpy(gate).requires_grad_())
    out = flash_attention.flash_attention(
        *leaves, kv_len=torch.from_numpy(kv_len), dropout_rate=rate,
        dropout_seed=seed)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want_out, np.float32), **tol)
    got = torch.autograd.grad(out, leaves, _to_torch(g, tdt))
    for name, a, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", [
    # (b, h, t, d, rate, dtype): the cases of tests/test_flash_dropout.py
    (1, 1, 64, 32, 0.1, "f32"),
    (3, 2, 200, 64, 0.5, "f32"),
    (2, 4, 384, 32, 0.25, "f32"),
    (2, 2, 137, 64, 0.3, "f32"),
    (2, 2, 160, 64, 0.2, "bf16"),
])
def test_masked_dropout_matches_jax(case):
    """flash_attention_trainable with ragged kv_len and dropout: forward
    and dq, dk, dv against the JAX kernel at the same seed."""
    b, h, t, d, rate, dtype = case
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rng = np.random.RandomState(b * 1000 + t + d)
    q, k, v, g = (rng.randn(b, h, t, d).astype(np.float32) * 0.3
                  for _ in range(4))
    kv_len = rng.randint(max(1, t // 2), t + 1, size=(b,)).astype(np.int32)
    seed = int(rng.randint(-2 ** 31, 2 ** 31 - 1))

    def jfn(*xs):
        return jax_fat(*xs, jnp.asarray(kv_len), dropout_rate=rate,
                       dropout_seed=jnp.int32(seed))
    want_out, vjp = jax.vjp(jfn, *(_to_jnp(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))

    leaves = [_to_torch(x, tdt).requires_grad_() for x in (q, k, v)]
    out = flash_attention_bwd.flash_attention_trainable(
        *leaves, torch.from_numpy(kv_len), dropout_rate=rate,
        dropout_seed=torch.tensor([seed], dtype=torch.int32))
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want_out, np.float32), **tol)
    got = torch.autograd.grad(out, leaves, _to_torch(g, tdt))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# 4. rate 0 and the input checks
# ---------------------------------------------------------------------------

def test_rate_zero_and_input_checks():
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 40, 16).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rng.randn(2, 40, 40).astype(np.float32))
    for fn, args in ((flash_attention.flash_attention, (q, k, v, bias)),
                     (flash_attention_bwd.flash_attention_trainable,
                      (q, k, v))):
        base = fn(*args)
        assert torch.equal(fn(*args, dropout_rate=0.0, dropout_seed=7), base)
        assert not torch.equal(fn(*args, dropout_rate=0.2, dropout_seed=7),
                               base)
        with pytest.raises(ValueError, match="requires dropout_seed"):
            fn(*args, dropout_rate=0.1)
        for bad in (1.0, 1.5, -0.1):
            with pytest.raises(ValueError, match="dropout_rate"):
                fn(*args, dropout_rate=bad, dropout_seed=7)


def _tiny_port_arch(strict: bool, rate: float = 0.3):
    base = port_arch(graft._flagship_arch(tiny=True))
    return dataclasses.replace(
        base, strict_attention_dropout=strict,
        wavlm=dataclasses.replace(base.wavlm, attention_dropout=rate,
                                  strict_attention_dropout=strict))


def test_strict_flag_changes_nothing_at_inference():
    """Eval mode: the strict tagger's logits equal the plain one's,
    bitwise."""
    audio = torch.from_numpy(
        (np.random.RandomState(5).randn(2, 2400) * 0.3).astype(np.float32))
    lang = torch.tensor([0, 1])
    strict = PT.init_tagger(_tiny_port_arch(True),
                            torch.Generator().manual_seed(0))
    plain = PT.BIOPhonemeTagger(_tiny_port_arch(False)).eval()
    plain.load_state_dict(strict.state_dict())
    with torch.no_grad():
        a, oa = strict(audio, lang, max_label_len=50)
        b, ob = plain(audio, lang, max_label_len=50)
    assert torch.equal(a, b) and torch.equal(oa, ob)


def test_strict_flag_from_config_matches_jax():
    """training.strict_attention_dropout sets the flag on the Conformer
    (TaggerArch) and the WavLMArch; an encoder_arch_overrides entry on the
    WavLMArch only — as the JAX TaggerArch.from_config does."""
    from wfl_asr_tpu.config import Config as JaxConfig
    from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
    for training, overrides in (({"strict_attention_dropout": True}, {}),
                                ({}, {"strict_attention_dropout": True}),
                                ({}, {})):
        raw = {"model": {"encoder_type": "wavlm",
                         "wavlm_model": "microsoft/wavlm-base-plus",
                         "num_languages": 2,
                         "encoder_arch_overrides": dict(overrides)},
               "training": dict(training)}
        ja = JaxTaggerArch.from_config(JaxConfig(raw), 7)
        pa = PT.TaggerArch.from_config(Config(raw), 7)
        assert pa.strict_attention_dropout == ja.strict_attention_dropout
        assert pa.wavlm.strict_attention_dropout == \
            ja.wavlm.strict_attention_dropout
        assert pa.wavlm.attention_dropout == ja.wavlm.attention_dropout == 0.1


# ---------------------------------------------------------------------------
# 5. the model with the same seeds injected on both sides
# ---------------------------------------------------------------------------

def _scaled_jax_dropout(rng, x, rate, deterministic):
    """A deterministic stand-in for the JAX package's dropout in the heads,
    so the Conformer's rate can stay above 0 on both sides."""
    return x if deterministic or rate <= 0.0 else x * (1.0 - rate)


def _scaled_port_dropout(x, rate, generator=None, training=True):
    return x if not training or rate <= 0.0 else x * (1.0 - rate)


def _inject_seeds(monkeypatch, seeds):
    """Both sides take the i-th attention call's seed from ``seeds``: the
    JAX kernel entry points (module attributes, looked up at call time)
    and the port's seed helper. Returns the two call logs."""
    from wfl_asr_tpu.models import heads as JH
    jax_calls, port_calls = [], []

    def wrap(real):
        def wrapped(*a, **kw):
            if kw.get("dropout_rate", 0.0) > 0.0:
                kw["dropout_seed"] = jnp.int32(seeds[len(jax_calls)])
                jax_calls.append(kw["dropout_rate"])
            return real(*a, **kw)
        return wrapped

    for mod, name in (("wfl_asr_tpu.ops.pallas.flash_attention",
                       "flash_attention"),
                      ("wfl_asr_tpu.ops.pallas.flash_attention_bwd",
                       "flash_attention_trainable")):
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, name, wrap(getattr(m, name)))

    def seed_helper(generator, device):
        port_calls.append(1)
        return torch.tensor([seeds[len(port_calls) - 1]], dtype=torch.int32,
                            device=device)

    monkeypatch.setattr(PL, "attention_dropout_seed", seed_helper)
    monkeypatch.setattr(JH, "dropout", _scaled_jax_dropout)
    monkeypatch.setattr(PH, "dropout", _scaled_port_dropout)
    return jax_calls, port_calls


def _strict_jax_arch():
    base = graft._flagship_arch(tiny=True)
    return dataclasses.replace(
        base, use_flash_attention=True, strict_attention_dropout=True,
        wavlm=dataclasses.replace(base.wavlm, use_flash_attention=True,
                                  strict_attention_dropout=True,
                                  attention_dropout=0.3, hidden_dropout=0.0))


@pytest.fixture
def seeds(monkeypatch):
    from wfl_asr_tpu.models import wavlm as jwavlm
    monkeypatch.setattr(jwavlm, "FLASH_MIN_T", 0)
    return [int(s) for s in np.random.RandomState(9).randint(
        -2 ** 31, 2 ** 31 - 1, size=8)]


def test_strict_train_step_matches_jax(monkeypatch, seeds):
    """One strict train step of the tiny flagship (attention dropout 0.3 in
    WavLM, 0.15 in the Conformer, every other dropout 0) against the JAX
    make_grad_step: loss ≤ 1e-5, every gradient ≤ 1e-4 × max|g|."""
    from wfl_asr_tpu.models.tagger import init_tagger
    from wfl_asr_tpu.train import loop as JLOOP
    jax_calls, port_calls = _inject_seeds(monkeypatch, seeds)
    arch = _strict_jax_arch()
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    batch = _tiny_batch(arch)
    jargs = [jnp.asarray(batch[k]) for k in TLOOP.BATCH_KEYS]
    _, _, jm, _, _ = jgrads_all = JLOOP.make_grad_step(arch, 0.1, 3.0)(
        params, state, jax.random.PRNGKey(1), *jargs,
        max_label_len=batch["max_label_len"])
    n_attn = arch.wavlm.num_layers + arch.num_conformer_layers
    assert jax_calls == [0.3] * arch.wavlm.num_layers + [0.15] * \
        arch.num_conformer_layers

    parch = port_arch(arch)
    assert parch.strict_attention_dropout and \
        parch.wavlm.strict_attention_dropout
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    m, _, _ = TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0)
    assert len(port_calls) == n_attn
    for key in ("loss", "ce", "offset_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-5,
                                   rtol=0, err_msg=key)

    want = export_tagger(jgrads_all[0], jgrads_all[1], "wavlm")
    sd_names = {"encoder.encoder.pos_conv_embed.conv.weight":
                "encoder.encoder.pos_conv_embed.conv.parametrizations"
                ".weight.original1"}
    wants = {name: np.asarray(want[sd_names.get(name, name)]).reshape(
        p.shape) for name, p in model.named_parameters()}
    gmax = max(np.abs(w).max() for w in wants.values())
    for name, p in model.named_parameters():
        w, g = wants[name], p.grad.numpy()
        if np.abs(w).max() <= 1e-6 * gmax:
            # 0 in exact arithmetic (the key bias, the conv bias before
            # BatchNorm): rounding noise on both sides
            assert np.abs(g).max() <= 1e-6 * gmax, name
            continue
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("lengths", [None, (40, 23)])
def test_strict_conformer_block_matches_jax(monkeypatch, seeds, lengths):
    """A strict Conformer block in training (in-kernel dropout at 0.15, the
    post-projection substitute skipped; BatchNorm batch statistics)
    against JAX conformer_block: output and d/dx ≤ 1e-5 × max."""
    from wfl_asr_tpu.models import heads as JH
    from wfl_asr_tpu.models.layers import RngStream
    from wfl_asr_tpu.models.tagger import init_tagger
    jax_calls, port_calls = _inject_seeds(monkeypatch, seeds)
    arch = _strict_jax_arch()
    params, state = init_tagger(jax.random.PRNGKey(2), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 40, 64).astype(np.float32)
    g = rng.randn(2, 40, 64).astype(np.float32)
    mask = (None if lengths is None else
            np.arange(40)[None, :] < np.asarray(lengths)[:, None])

    def jblock(x_):
        return JH.conformer_block(
            params["conformer"][0], state["conformer"][0], x_,
            arch.conformer_heads, arch.conformer_kernel,
            arch.conformer_dropout, RngStream(jax.random.PRNGKey(4)),
            deterministic=False, train=True,
            mask=None if mask is None else jnp.asarray(mask),
            use_flash=True, strict_attn_dropout=True)[0]
    want, vjp = jax.vjp(jblock, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    assert jax_calls == [arch.conformer_dropout]

    parch = port_arch(arch)
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    block = model.conformer_layers[0].train()
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, None if mask is None else torch.from_numpy(mask))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert len(port_calls) == 1
    for got, w in ((out.detach().numpy(), np.asarray(want)),
                   (dx.numpy(), np.asarray(want_dx))):
        np.testing.assert_allclose(got, w, atol=1e-5 * np.abs(w).max(),
                                   rtol=0)


# ---------------------------------------------------------------------------
# 6. the train loop
# ---------------------------------------------------------------------------

def test_strict_train_loop_on_cpu(tmp_path, monkeypatch):
    """train() accepts training.strict_attention_dropout on the CPU: 2
    steps with finite losses, 4 attention seeds drawn a step (2 WavLM
    layers, 2 Conformer blocks), none in validation."""
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path)
    make_data(root, n_per_lang=3)
    raw = make_config(root, strict_attention_dropout=True, max_steps=2,
                      val_check_interval=2, batch_size=2)
    raw["data"]["num_val_files"] = 2
    preprocess(raw["data"]["data_dir"], raw)
    cfg = Config.load(os.path.join(raw["output"]["save_dir"], "config.yaml"))
    draws = []
    real = PL.attention_dropout_seed

    def spy(generator, device):
        draws.append(generator)
        return real(generator, device)
    monkeypatch.setattr(PL, "attention_dropout_seed", spy)
    model = TLOOP.train(cfg.raw, device="cpu")
    assert model.arch.strict_attention_dropout
    assert model.arch.wavlm.strict_attention_dropout
    assert len(draws) == 2 * 4 and all(g is not None for g in draws)
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = [e["loss"] for e in events if e["event"] == "train"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [e["step"] for e in events if e["event"] == "val"] == [2]
