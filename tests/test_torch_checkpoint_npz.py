"""Checkpoint interchange with the JAX package on the CPU: a ``.pt.npz``
(what a torch-less JAX run writes, ``save_pytree_npz`` of the
``export_tagger`` dict) serves and resumes in the port, and a JAX
``.train.npz`` sidecar of Prodigy or of any of the 26 optax names (and a
JAX PP run's stacked one) resumes the port's optimizer of that name so that
the next step agrees with the JAX run's; the port's own ``.train.pt`` wins
when both exist; another optimizer's JAX state starts the port fresh.

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
from wfl_asr_tpu_torch.train import optimizers as TOPT
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
    """A JAX AdamW sidecar restores a port AdamW (every parameter's state
    filled, the count and the live learning rate taken), but cannot map
    onto a port Prodigy: logged, and that optimizer left fresh; so is a
    JAX Prodigy sidecar under a port AdamW."""
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    from wfl_asr_tpu.train import loop as JLOOP
    arch = graft._flagship_arch(tiny=True)
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    adamw = {"training": {"optimizer": "AdamW", "learning_rate": 1e-3}}
    for sidecar, raw, maps in (("AdamW", adamw, True),
                               ("AdamW", _opt_raw(), False),
                               ("Prodigy", adamw, False)):
        root = tmp_path / f"{sidecar}_{raw['training']['optimizer']}"
        root.mkdir()
        tx = JLOOP.make_optimizer(JaxConfig(
            adamw if sidecar == "AdamW" else _opt_raw()))
        path = str(root / "model_step5.pt")
        save_model_checkpoint(path, params, state, arch)
        save_train_state(path, tx.init(params), 5,
                         np.asarray(jax.random.PRNGKey(0)))
        model = PT.BIOPhonemeTagger(port_arch(arch))
        opt = TLOOP.make_optimizer(Config(raw), model.parameters())
        assert TLOOP._resume(model, opt, torch.Generator(),
                             get_scheduler("ConstantLR", {}, base_lr=1.0),
                             str(root)) == 5
        printed = capsys.readouterr().out
        if maps:
            assert "restored the JAX run's AdamW state" in printed
            assert len(opt.state) == len(list(model.parameters()))
            assert all(int(st["step"]) == 0 for st in opt.state.values())
            assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)
            continue
        assert "does not map onto the port's" in printed
        assert "optimizer starts fresh" in printed
        assert len(opt.state) == 0


OPTAX_NAMES = sorted(TOPT.OPTIMIZERS)


def _synthetic_grads(params, k: int):
    """Seeded gradients shaped as ``params`` (numpy, the same every run)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(100 + k)
    return jax.tree_util.tree_unflatten(tree, [
        (rng.randn(*np.shape(x)) * 0.1).astype(np.float32) for x in leaves])


def _sidecar_case(tmp_path, name, stack=False):
    """Two eager optax updates of ``name`` (JLOOP.make_optimizer) on the
    tiny tagger from seeded gradients, saved as ``model_step2.pt`` with its
    ``.train.npz`` (the state stacked as a JAX PP run saves it when
    ``stack``); returns the raw config, the third update's gradients and
    the parameters before and after it, exported to torch keys."""
    from wfl_asr_tpu.checkpoint import save_model_checkpoint
    from wfl_asr_tpu.parallel import pp as JPP
    from wfl_asr_tpu.train import loop as JLOOP
    arch = graft._flagship_arch(tiny=True)
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    lr = 1.0 if name.lower() in ("prodigy", "dadaptadamw", "adadelta") \
        else 1e-2
    # adafactor factors leaves from 16 on (the tiny tagger has none of
    # 128); dadaptadamw's and Prodigy's d start at 1e-2 and 1e-3, so that
    # three updates move the parameters
    extra = {"adafactor": {"min_dim_size_to_factor": 16},
             "dadaptadamw": {"estim_lr0": 1e-2},
             "Prodigy": {"d0": 1e-3}}.get(name, {})
    raw = {"training": {"optimizer": name, "learning_rate": lr,
                        "weight_decay": 1e-5, "optimizer_params": {
                            "betas": [0.9, 0.999], "eps": 1e-8, **extra}}}

    def stacked(tree):
        if not stack:
            return tree
        tree = dict(tree)
        enc = dict(tree["encoder"])
        enc["layers"] = JPP.stack_layers(enc["layers"])
        tree["encoder"] = enc
        return tree

    def export(tree):
        return export_tagger(jax.tree_util.tree_map(np.asarray, tree),
                             jax.tree_util.tree_map(np.asarray, state),
                             "wavlm")

    tx = JLOOP.make_optimizer(JaxConfig(raw))
    p = stacked(params)
    ostate = tx.init(p)
    update = jax.jit(tx.update)
    for k in range(2):
        u, ostate = update(stacked(_synthetic_grads(params, k)), ostate, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
    path = str(tmp_path / "model_step2.pt")
    unstacked = dict(p)
    if stack:
        enc = dict(p["encoder"])
        enc["layers"] = JPP.unstack_layers(enc["layers"])
        unstacked["encoder"] = enc
    save_model_checkpoint(path, unstacked, state, arch)
    save_train_state(path, ostate, 2, np.asarray(jax.random.PRNGKey(0)))
    grads = _synthetic_grads(params, 2)
    u, _ = update(stacked(grads), ostate, p)
    after = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
    if stack:
        after = dict(after)
        enc = dict(after["encoder"])
        enc["layers"] = JPP.unstack_layers(enc["layers"])
        after["encoder"] = enc
    return dict(raw=raw, arch=arch, grads=export(grads),
                before=export(unstacked), after=export(after))


def _resume_and_step(tmp_path, case, capsys):
    """The port resumes the case's checkpoint (``loop._resume``) and takes
    the third update; returns (its parameters by state key, the log)."""
    model = PT.BIOPhonemeTagger(port_arch(case["arch"]))
    opt = TLOOP.make_optimizer(Config(case["raw"]), list(model.parameters()),
                               model.jax_leaf_blocks())
    lr = case["raw"]["training"]["learning_rate"]
    assert TLOOP._resume(model, opt, torch.Generator(),
                         get_scheduler("ConstantLR", {}, base_lr=lr),
                         str(tmp_path)) == 2
    printed = capsys.readouterr().out
    for n, q in model.named_parameters():
        q.grad = torch.from_numpy(np.array(
            case["grads"][CK._state_dict_key(n)], np.float32)
        ).reshape(q.shape)
    opt.step()
    return model.state_dict(), printed


def _assert_third_update(got, case):
    """Every parameter within test_torch_optimizers' tolerance (1e-6) of
    optax's third update, which moved them by far more."""
    moved = 0.0
    for k, w in case["after"].items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var",
                       "original0")):
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6, rtol=0,
                                   err_msg=k)
        moved = max(moved, float(np.abs(w - case["before"][k]).max()))
    assert moved > 1e-4, "the update moved nothing: the check is vacuous"


@pytest.mark.parametrize("name", OPTAX_NAMES)
def test_jax_optax_sidecar_resumes(tmp_path, capsys, name):
    """A JAX run's sidecar of each optax name (two eager updates of the
    tiny tagger) resumes the port's optimizer of that name through
    ``loop._resume``, and the port's next update on the same gradients is
    optax's third (per-leaf states — adafactor's factored moments, here
    with leaves factored from 16 on, sm3's accumulators, novograd's
    moment — mapped leaf by leaf, in_proj's three leaves on its rows)."""
    case = _sidecar_case(tmp_path, name)
    got, printed = _resume_and_step(tmp_path, case, capsys)
    assert "restored the JAX run's" in printed, printed
    _assert_third_update(got, case)


@pytest.mark.parametrize("name", ["AdamW", "Prodigy", "sm3"])
def test_stacked_jax_sidecar_resumes(tmp_path, capsys, name):
    """A JAX PP run's sidecar (the encoder's layers one stacked ``[L]``
    leaf each) resumes a port run without pipeline parallelism: AdamW's
    and Prodigy's states unstack along [L] and the next update is the JAX
    run's; sm3's accumulators span the stacked leaf's layers, so it starts
    fresh, logged."""
    case = _sidecar_case(tmp_path, name, stack=True)
    got, printed = _resume_and_step(tmp_path, case, capsys)
    if name == "sm3":
        assert "does not map onto the port's SM3" in printed
        assert "optimizer starts fresh" in printed
        return
    assert "restored the JAX run's" in printed, printed
    _assert_third_update(got, case)
