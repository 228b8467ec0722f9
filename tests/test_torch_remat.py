"""Remat in the port (``training.remat: true | auto``, alias
``gradient_checkpointing``), after ``tests/test_remat.py``, on the CPU:

- narrow WavLM and Whisper taggers in training mode, with dropout,
  LayerDrop and (WavLM, Conformer) strict attention dropout: remat on and
  off give bit-identical losses, gradients and generator end states (each
  layer's draws come from a private generator set to the run's state, so
  the recompute repeats them);
- a remat step against the JAX package's remat step (dropout 0, its XLA
  attention), at the train-step tolerances;
- ``RematStep("auto")`` with an injected ``torch.cuda.OutOfMemoryError``:
  one flip, the whole update rerun from the restored generator, buffers
  and cleared grads, equal to a remat step from the start; a second OOM,
  another error, or an OOM in ``optimizer.step()`` propagates;
- the ``gradient_checkpointing`` alias, and the train loop with
  ``remat: auto`` (a ``remat_auto_flip`` event; the run equals a
  ``remat: true`` run).

    python -m pytest tests/test_torch_remat.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.train import loop as TLOOP

from tests.test_torch_train import (_opt_raw, _tiny_batch, make_config,
                                    make_data, port_arch)

WHISPER_NARROW = dict(d_model=80, num_layers=2, num_heads=2, ffn_dim=128,
                      dropout=0.1, activation_dropout=0.1, layerdrop=0.3)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _arch(encoder: str) -> PT.TaggerArch:
    """A narrow tagger with every random draw of training on: dropout in
    the encoder and the Conformer, LayerDrop, and strict attention
    dropout (in WavLM's layers and the Conformer)."""
    base = port_arch(graft._flagship_arch(tiny=True))
    if encoder == "wavlm":
        return dataclasses.replace(
            base, strict_attention_dropout=True, conformer_dropout=0.1,
            wavlm=dataclasses.replace(
                base.wavlm, hidden_dropout=0.1, activation_dropout=0.1,
                feat_proj_dropout=0.1, attention_dropout=0.2, layerdrop=0.3,
                strict_attention_dropout=True))
    whisper = PT.WhisperArch(**WHISPER_NARROW)
    return dataclasses.replace(
        base, encoder_type="whisper", wavlm=None, whisper=whisper,
        hidden_size=whisper.d_model, strict_attention_dropout=True,
        conformer_dropout=0.1)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("encoder", ["wavlm", "whisper"])
def test_remat_on_off_bit_identical(encoder):
    arch = _arch(encoder)
    batch = _tiny_batch(arch)
    runs = []
    for remat in (False, True):
        model = PT.init_tagger(arch, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(11)
        m, _, _ = TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0,
                                   generator=gen, remat=remat)
        runs.append((m, _grads(model), gen.get_state(),
                     [b.clone() for b in model.buffers()]))
    (m0, g0, s0, b0), (m1, g1, s1, b1) = runs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert g0.keys() == g1.keys() and len(g0) > 20
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))
    # the draws are live: another generator seed gives another loss
    model = PT.init_tagger(arch, torch.Generator().manual_seed(0))
    m2, _, _ = TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0,
                                generator=torch.Generator().manual_seed(12),
                                remat=True)
    assert not torch.equal(m2["loss"], m0["loss"])


def test_remat_recomputes_the_encoder_layers(monkeypatch):
    """With remat each encoder layer runs twice a step (the forward and
    the backward's recompute), without it once."""
    from wfl_asr_tpu_torch.models import wavlm
    arch = _arch("wavlm")
    batch = _tiny_batch(arch)
    calls = []
    real = wavlm.WavLMEncoder._layer

    def counted(self, *args):
        calls.append(1)
        return real(self, *args)
    monkeypatch.setattr(wavlm.WavLMEncoder, "_layer", counted)
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        model = PT.init_tagger(arch, torch.Generator().manual_seed(0))
        TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0,
                         generator=torch.Generator().manual_seed(1),
                         remat=remat)
        assert len(calls) == want, (remat, calls)


def test_remat_step_matches_jax_remat_step():
    """Dropout 0: the port's remat micro-step against
    ``make_grad_step(..., remat=True)`` — loss ≤ 1e-5, every gradient ≤
    1e-4 × its max|g| (``test_train_step_matches_jax``'s tolerances). The
    JAX step runs its XLA attention, the plain reference of its Pallas
    kernels (``test_train_step_matches_jax`` holds those)."""
    from wfl_asr_tpu.models.tagger import init_tagger
    from wfl_asr_tpu.train import loop as JLOOP
    base = graft._flagship_arch(tiny=True)
    arch = dataclasses.replace(
        base, use_flash_attention=False, conformer_dropout=0.0,
        wavlm=dataclasses.replace(base.wavlm, use_flash_attention=False,
                                  use_fused_conv=False, hidden_dropout=0.0))
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    batch = _tiny_batch(arch)
    jargs = [jnp.asarray(batch[k]) for k in TLOOP.BATCH_KEYS]
    jgrads, jstate, jm, _, _ = JLOOP.make_grad_step(
        arch, 0.1, 3.0, remat=True)(params, state, jax.random.PRNGKey(1),
                                    *jargs,
                                    max_label_len=batch["max_label_len"])

    parch = port_arch(arch)
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(state_dict_from_jax(params, state, parch),
                          strict=True)
    m, _, _ = TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0,
                               remat=True)
    for k in ("loss", "ce", "offset_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    want = export_tagger(jax.tree_util.tree_map(np.asarray, jgrads),
                         jax.tree_util.tree_map(np.asarray, jstate), "wavlm")
    sd_name = {"encoder.encoder.pos_conv_embed.conv.weight":
               "encoder.encoder.pos_conv_embed.conv.parametrizations"
               ".weight.original1"}
    wants = {n: np.asarray(want[sd_name.get(n, n)]).reshape(p.shape)
             for n, p in model.named_parameters()}
    gmax = max(np.abs(w).max() for w in wants.values())
    for name, p in model.named_parameters():
        w, g = wants[name], p.grad.numpy()
        if np.abs(w).max() <= 1e-6 * gmax:
            assert np.abs(g).max() <= 1e-6 * gmax, name
            continue
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# remat: auto
# ---------------------------------------------------------------------------

def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB")


def _update(mode, inject=None, opt_step=None, seed=5):
    """One update of 2 micro-batches through ``RematStep(mode)``;
    ``inject(call, remat)`` runs after each micro-step and may raise."""
    arch = _arch("wavlm")
    model = PT.init_tagger(arch, torch.Generator().manual_seed(0))
    opt = TLOOP.make_optimizer(Config(_opt_raw()), model.parameters())
    if opt_step is not None:
        opt.step = opt_step
    gen = torch.Generator().manual_seed(seed)
    flips = []
    step = TLOOP.RematStep(mode, model, gen,
                           on_flip=lambda: flips.append(1))
    calls = []
    real = TLOOP.micro_step

    def micro(model_, batch, *args, remat=False, **kwargs):
        out = real(model_, batch, *args, remat=remat, **kwargs)
        calls.append(remat)
        if inject is not None:
            inject(len(calls), remat)
        return out
    batches = [_tiny_batch(arch, 3), _tiny_batch(arch, 4)]
    orig, TLOOP.micro_step = TLOOP.micro_step, micro
    try:
        metrics, _ = step(opt, batches, "cpu", label_smoothing=0.1,
                          subframe_weight=3.0)
    finally:
        TLOOP.micro_step = orig
    return dict(model=model, gen=gen, metrics=metrics, step=step,
                calls=calls, flips=flips)


def _same_run(a, b):
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
    sa, sb = a["model"].state_dict(), b["model"].state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a["gen"].get_state(), b["gen"].get_state())


def test_auto_flips_once_and_equals_remat_from_the_start():
    """The OOM comes after the second micro-batch's backward, when both
    have accumulated gradients, advanced the generator and moved the
    BatchNorm statistics: the rerun starts from the state before the
    update."""
    def oom_on_second(call, remat):
        if not remat and call == 2:
            raise _oom()
    auto = _update("auto", oom_on_second)
    assert auto["calls"] == [False, False, True, True]
    assert auto["flips"] == [1] and auto["step"].remat
    assert "Tried to allocate 20.00 GiB" in auto["step"].oom
    _same_run(auto, _update("on"))
    _same_run(auto, _update("off"))
    # not vacuous: other draws give another update
    other = _update("on", seed=6)
    assert not torch.equal(other["metrics"]["loss"], auto["metrics"]["loss"])


def test_auto_without_oom_stays_off():
    auto = _update("auto")
    assert auto["calls"] == [False, False] and not auto["step"].remat
    _same_run(auto, _update("off"))


def test_auto_second_oom_propagates():
    def always(call, remat):
        raise _oom()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _update("auto", always)


def test_auto_other_errors_propagate():
    def bad(call, remat):
        raise ValueError("not memory")
    with pytest.raises(ValueError, match="not memory"):
        _update("auto", bad)


def test_auto_oom_in_the_optimizer_step_propagates():
    calls = []

    def opt_step(*args, **kwargs):
        calls.append(1)
        raise _oom()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _update("auto", opt_step=opt_step)
    assert calls == [1]


@pytest.mark.parametrize("training, want", [
    ({}, "off"), ({"remat": True}, "on"), ({"remat": "auto"}, "auto"),
    ({"remat": " AUTO "}, "auto"), ({"gradient_checkpointing": True}, "on"),
    ({"gradient_checkpointing": "auto"}, "auto"),
    ({"remat": False, "gradient_checkpointing": True}, "off")])
def test_remat_mode_and_alias(training, want):
    assert TLOOP.remat_mode(Config({"training": training})) == want
    with pytest.raises(ValueError, match="remat mode"):
        TLOOP.RematStep("sometimes", None)


def test_train_loop_remat_auto(tmp_path, monkeypatch):
    """The train loop with ``remat: auto`` and an OOM injected into its
    first micro-step: a ``remat_auto_flip`` event at step 0, and the run
    equals one with ``remat: true``."""
    from wfl_asr_tpu_torch.preprocess import preprocess
    root = str(tmp_path)
    make_data(root, n_per_lang=3)
    real = TLOOP.micro_step
    seen = []

    def oom_once(*args, remat=False, **kwargs):
        out = real(*args, remat=remat, **kwargs)
        seen.append(remat)
        if len(seen) == 1:
            raise _oom()
        return out
    models = {}
    for mode, save in (("auto", "run_auto"), (True, "run_on")):
        cfg = make_config(root, save=save, remat=mode, max_steps=2,
                          val_check_interval=2, batch_size=2)
        cfg["data"]["num_val_files"] = 2
        preprocess(cfg["data"]["data_dir"], cfg)
        if mode == "auto":
            monkeypatch.setattr(TLOOP, "micro_step", oom_once)
        else:
            monkeypatch.setattr(TLOOP, "micro_step", real)
        models[mode] = TLOOP.train(json.loads(json.dumps(cfg)), device="cpu")
        if mode == "auto":
            log = os.path.join(cfg["training"]["log_dir"], "metrics.jsonl")
            with open(log) as f:
                events = [json.loads(line) for line in f]
            flips = [e for e in events if e["event"] == "remat_auto_flip"]
            assert len(flips) == 1 and flips[0]["step"] == 0
            assert flips[0]["remat"] is True
            assert [e["step"] for e in events if e["event"] == "train"] \
                == [1, 2]
    assert seen == [False, True, True]
    sa, sb = models["auto"].state_dict(), models[True].state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
