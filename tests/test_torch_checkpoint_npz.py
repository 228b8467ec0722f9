"""Checkpoint interchange with the JAX package on the CPU: a ``.pt.npz``
(what a torch-less JAX run writes, ``save_pytree_npz`` of the
``export_tagger`` dict) serves and resumes in the port, and a JAX Prodigy
``.train.npz`` sidecar resumes the port's Prodigy so that the next step
agrees with the JAX run's; the port's own ``.train.pt`` wins when both
exist; another optimizer's JAX state starts the port fresh.

    python -m pytest tests/test_torch_checkpoint_npz.py -q
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from wfl_asr_tpu.checkpoint import save_pytree_npz, save_train_state
from wfl_asr_tpu.config import Config as JaxConfig
from wfl_asr_tpu.models.convert import export_tagger as jax_export
from wfl_asr_tpu.models.tagger import init_tagger
from wfl_asr_tpu_torch import checkpoint as CK
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger
from wfl_asr_tpu_torch.train import loop as TLOOP
from wfl_asr_tpu_torch.train.schedules import get_scheduler

from tests.test_torch_e2e import LABELS, make_run
from tests.test_torch_train import _opt_raw, _tiny_batch, port_arch


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def test_pt_npz_serves_like_jax(tmp_path):
    """The same weights as ``.pt.npz`` only: the port's session logits ≤
    1e-5 × max of the JAX session's (which loads the same file)."""
    from wfl_asr_tpu.checkpoint import load_model_checkpoint as jax_load
    from wfl_asr_tpu.infer.pipeline import InferenceSession as JaxSession
    from wfl_asr_tpu.models.tagger import TaggerArch as JaxTaggerArch
    from wfl_asr_tpu_torch.infer import InferenceSession
    config, ckpt = make_run(tmp_path, "npz")
    raw = yaml.safe_load(open(config))
    arch = JaxTaggerArch.from_config(JaxConfig(raw), len(LABELS))
    params, state = jax_load(ckpt, arch)
    npz_only = str(tmp_path / "model_step3.pt")
    save_pytree_npz(npz_only + ".npz", jax_export(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state), arch))
    assert not os.path.exists(npz_only)
    audio = (np.random.RandomState(5).randn(int(16000 * 1.3)) * 0.4
             ).astype(np.float32)
    want, want_off = JaxSession(config, npz_only).forward(audio, [0, 1])
    got, got_off = InferenceSession(config, npz_only, device="cpu").forward(
        audio, [0, 1])
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    np.testing.assert_allclose(got_off, want_off,
                               atol=1e-5 * np.abs(want_off).max(), rtol=0)
    # resume discovery and rotation see the .pt.npz
    assert CK.find_resume_checkpoints(str(tmp_path)) == [(npz_only, 3)]
    sd = CK.read_state_dict(npz_only)
    assert sd.keys() == torch.load(ckpt, weights_only=True).keys()
    CK.remove_checkpoint(npz_only)
    assert not os.path.exists(npz_only + ".npz")


def _jax_run(tmp_path, steps):
    """The tiny flagship (dropout 0, XLA attention) after ``steps`` JAX
    Prodigy steps on one batch, saved as ``model_step{steps}.pt`` with its
    ``.train.npz``; returns what the next JAX step needs."""
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    from wfl_asr_tpu.train import loop as JLOOP
    base = graft._flagship_arch(tiny=True)
    arch = dataclasses.replace(
        base, conformer_dropout=0.0,
        wavlm=dataclasses.replace(base.wavlm, hidden_dropout=0.0))
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    raw = _opt_raw()
    raw["training"]["optimizer_params"]["d_coef"] = 20.0
    tx = JLOOP.make_optimizer(JaxConfig(raw))
    grad_fn = JLOOP.make_grad_step(arch, 0.1, 3.0)
    apply_fn = JLOOP.make_accum_apply(tx)
    batch = _tiny_batch(arch)
    args = [jnp.asarray(batch[k]) for k in TLOOP.BATCH_KEYS]
    ostate = tx.init(params)
    for i in range(steps):
        grads, state, _, _, _ = grad_fn(
            params, state, jax.random.PRNGKey(i), *args,
            max_label_len=batch["max_label_len"])
        params, ostate = apply_fn(params, ostate, grads, n_micro=1)
    path = str(tmp_path / f"model_step{steps}.pt")
    save_model_checkpoint(path, params, state, arch)
    save_train_state(path, ostate, steps, np.asarray(jax.random.PRNGKey(9)),
                     {"factor": 1.0, "last_epoch": float(steps)})
    return dict(arch=arch, params=params, state=state, ostate=ostate,
                grad_fn=grad_fn, apply_fn=apply_fn, batch=batch, args=args,
                raw=raw, path=path)


def _port(run, optimizer_raw=None):
    model = PT.BIOPhonemeTagger(port_arch(run["arch"]))
    opt = TLOOP.make_optimizer(Config(optimizer_raw or run["raw"]),
                               model.parameters())
    sched = get_scheduler("ConstantLR", {}, base_lr=1.0)
    return model, opt, sched, torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jaxrun"), steps=2)


def test_jax_prodigy_sidecar_resumes(jax_run, capsys):
    run = jax_run
    model, opt, sched, gen = _port(run)
    gen_before = gen.get_state()
    step = TLOOP._resume(model, opt, gen, sched,
                         os.path.dirname(run["path"]))
    printed = capsys.readouterr().out
    assert step == 2 and "restored the JAX run's Prodigy state" in printed
    assert "PRNG key does not map" in printed
    assert torch.equal(gen.get_state(), gen_before)
    glob = opt.global_state()
    inner = run["ostate"].inner_state
    assert float(glob["k"]) == 2.0
    for key in ("d", "d_max", "d_numerator"):
        np.testing.assert_allclose(float(glob[key]),
                                   float(getattr(inner, key)), rtol=1e-7)
    assert sched.last_epoch == 2
    # every parameter's state is the JAX leaf, in torch's layout, exactly
    names = {id(p): n for n, p in model.named_parameters()}
    for key in ("exp_avg", "exp_avg_sq", "s", "p0"):
        sd = export_tagger(
            jax.tree_util.tree_map(np.asarray, getattr(inner, key)),
            jax.tree_util.tree_map(np.asarray, run["state"]), "wavlm")
        for p, st in opt.state.items():
            want = sd[CK._state_dict_key(names[id(p)])]
            np.testing.assert_array_equal(
                st[key].numpy(), np.asarray(want).reshape(p.shape))
    assert len(opt.state) == len(list(model.parameters()))

    # the next step from the same gradients (the JAX step's): the resumed
    # state alone decides whether the two updates agree
    grads, _, _, _, _ = run["grad_fn"](      # donates the state it gets
        run["params"], jax.tree_util.tree_map(jnp.copy, run["state"]),
        jax.random.PRNGKey(2), *run["args"],
        max_label_len=run["batch"]["max_label_len"])
    g_sd = export_tagger(jax.tree_util.tree_map(np.asarray, grads),
                         jax.tree_util.tree_map(np.asarray, run["state"]),
                         "wavlm")
    params, ostate = run["apply_fn"](run["params"], run["ostate"], grads,
                                     n_micro=1)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.array(
            g_sd[CK._state_dict_key(name)], np.float32)).reshape(p.shape)
    opt.step()
    glob, inner = opt.global_state(), ostate.inner_state
    assert float(inner.d) > 1e-6, "d never grew: the check is vacuous"
    # d and d_max to 2e-6: they divide two f32 sums over every parameter
    # (Σ g·(p0 − p) and Σ|s|), which the two optimizers reduce in other
    # orders (1.1e-6 measured here; the states they start from are equal)
    for key in ("d", "d_max"):
        np.testing.assert_allclose(float(glob[key]),
                                   float(getattr(inner, key)), rtol=2e-6)
    want = export_tagger(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, run["state"]),
                         "wavlm")
    got = model.state_dict()
    moved = 0
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var",
                       "original0")):
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   rtol=0, err_msg=k)
        moved += 1
    assert moved > 50


def test_port_sidecar_wins_over_jax(jax_run, tmp_path):
    run = jax_run
    model, opt, sched, gen = _port(run)
    path = str(tmp_path / "model_step2.pt")
    for suffix in ("", ".train.npz"):
        src = run["path"].removesuffix(".pt") + (suffix or ".pt")
        with open(src, "rb") as f, \
                open(path.removesuffix(".pt") + (suffix or ".pt"), "wb") as g:
            g.write(f.read())
    TLOOP.train_step(model, opt, _tiny_batch(run["arch"], 4), "cpu", 0.1,
                     3.0)
    gen.manual_seed(123)
    CK.save_train_state(path, opt, 2, gen, {"factor": 0.5})
    saved_d = opt.global_state()["d"].clone()
    model2, opt2, sched2, gen2 = _port(run)
    assert TLOOP._resume(model2, opt2, gen2, sched2, str(tmp_path)) == 2
    assert torch.equal(opt2.global_state()["d"], saved_d)
    assert float(opt2.global_state()["k"]) == 1.0
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert sched2.factor == 0.5
    CK.remove_checkpoint(path)
    assert os.listdir(tmp_path) == []


def test_other_jax_optimizer_starts_fresh(tmp_path, capsys):
    """A JAX AdamW sidecar cannot map onto the port: logged, and the
    optimizer left fresh; so is a Prodigy sidecar under a port AdamW."""
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    from wfl_asr_tpu.train import loop as JLOOP
    arch = graft._flagship_arch(tiny=True)
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    adamw = {"training": {"optimizer": "AdamW", "learning_rate": 1e-3}}
    tx = JLOOP.make_optimizer(JaxConfig(adamw))
    path = str(tmp_path / "model_step5.pt")
    save_model_checkpoint(path, params, state, arch)
    save_train_state(path, tx.init(params), 5,
                     np.asarray(jax.random.PRNGKey(0)))
    for raw in (_opt_raw(), adamw):
        model = PT.BIOPhonemeTagger(port_arch(arch))
        opt = TLOOP.make_optimizer(Config(raw), model.parameters())
        assert TLOOP._resume(model, opt, torch.Generator(),
                             get_scheduler("ConstantLR", {}, base_lr=1.0),
                             str(tmp_path)) == 5
        printed = capsys.readouterr().out
        assert "does not map onto the port's" in printed
        assert "optimizer starts fresh" in printed
        assert len(opt.state) == 0
