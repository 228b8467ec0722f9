"""The port's optimizers by name (``wfl_asr_tpu_torch/train/optimizers.py``)
against the JAX package's ``make_optimizer`` (optax) on the CPU: every name
over 5 steps of shared gradients, with and without the config's weight
decay and across an lr change; the kwargs table against optax's
signatures; the name lookup; a ``state_dict`` round trip mid-run; and the
per-leaf statistics through the tiny tagger's train step.

    python -m pytest tests/test_torch_optimizers.py -q
"""

import copy
import dataclasses
import inspect
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import __graft_entry__ as graft
from wfl_asr_tpu.config import Config as JaxConfig
from wfl_asr_tpu.train import loop as JLOOP
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.train import loop as TLOOP
from wfl_asr_tpu_torch.train import optimizers as TOPT

NAMES = sorted(TOPT.OPTIMIZERS)
# the leaves of the 5-step check; the last two are factored by adafactor
# (second largest axis ≥ 128)
SHAPES = [(5, 3), (7,), (2, 4, 3), (130, 129), (129, 131, 3)]
# |port − optax| on O(1) parameters after 5 steps at lr 1e-2, then 5e-3
TOL = 1e-6
# the per-name lr: dadaptadamw (its d estimate) and adadelta run at lr 1
LR = {"dadaptadamw": 1.0, "adadelta": 1.0}
# dadaptadamw's d starts at 1e-2 here, so that 5 steps move the parameters
EXTRA = {"dadaptadamw": {"estim_lr0": 1e-2}}


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _raw(name, lr, weight_decay=None, **params):
    t = {"optimizer": name, "learning_rate": lr,
         "optimizer_params": {"betas": [0.9, 0.999], "eps": 1e-8, **params}}
    if weight_decay is not None:
        t["weight_decay"] = weight_decay
    return {"training": t}


def _set_jax_lr(state, lr):
    state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)


def _data(seed=1):
    rng = np.random.RandomState(seed)
    p0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    drift = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(d + 0.3 * rng.randn(*d.shape)).astype(np.float32)
              for d in drift] for _ in range(5)]
    return p0, grads


def _run_both(raw, p0, grads, lr_after=None):
    """5 steps of optax (through JLOOP.make_optimizer) and of the port from
    the same parameters on the same gradients; the lr becomes lr_after
    before step 4. Yields (step, jax params, port params, port optimizer,
    optax state)."""
    tx = JLOOP.make_optimizer(JaxConfig(raw))
    jp = [jnp.asarray(x) for x in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = TLOOP.make_optimizer(Config(raw), tp)
    for i, gs in enumerate(grads):
        if i == 3 and lr_after is not None:
            _set_jax_lr(state, lr_after)
            TLOOP.set_lr(opt, lr_after)
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        yield i, jp, tp, opt, state


@pytest.mark.parametrize("weight_decay", [1e-5, None],
                         ids=["config_wd", "no_wd"])
@pytest.mark.parametrize("name", NAMES)
def test_matches_optax(name, weight_decay):
    """Every parameter within TOL of optax after each of 5 steps; the lr
    halves before step 4; the parameters move by far more than TOL."""
    p0, grads = _data()
    lr = LR.get(name, 1e-2)
    raw = _raw(name, lr, weight_decay, **EXTRA.get(name, {}))
    for i, jp, tp, opt, state in _run_both(raw, p0, grads, lr_after=lr / 2):
        for a, b in zip(jp, tp):
            assert np.isfinite(np.asarray(a)).all(), f"{name} step {i}"
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       atol=TOL, rtol=0,
                                       err_msg=f"{name} step {i}")
        if name == "dadaptadamw":
            # d is a ratio of f32 sums over the 115k elements, summed in
            # another order on each side (~log2(n)·2^-24 ≈ 1e-6 relative
            # each), fed back into the next step's sums
            np.testing.assert_allclose(
                opt.global_state()["estim_lr"].item(),
                float(state.inner_state.estim_lr), rtol=2e-5)
    moved = max(float(np.abs(b.detach().numpy() - x).max())
                for b, x in zip(tp, p0))
    assert moved > 100 * TOL, f"{name} barely moved ({moved})"


OPTIONS = [
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {"momentum": 0.5, "accumulator_dtype": "bfloat16"}),
    ("rmsprop", {"centered": True, "momentum": 0.9}),
    ("rmsprop", {"bias_correction": True}),
    ("rmsprop", {"eps_in_sqrt": False, "initial_scale": 0.1,
                 "momentum": 0.8, "nesterov": True}),
    # ρ is 0.97, 1.96, 2.99, 3.96, 4.96 over the 5 steps: the rectified
    # branch runs at the last (at the default threshold 5, never)
    ("radam", {"nesterov": True, "threshold": 4.5}),
    ("adam", {"mu_dtype": "bfloat16", "eps_root": 1e-8}),
    ("adamw", {"mask": False}),
    ("adabelief", {"nesterov": True}),
    ("adafactor", {"momentum": 0.9, "weight_decay_rate": 1e-3}),
    ("adafactor", {"factored": False, "clipping_threshold": None,
                   "multiply_by_parameter_scale": False}),
    ("lars", {"nesterov": True, "trust_ratio_mask": False,
              "weight_decay_mask": False}),
    ("adopt", {"nesterov": True, "use_clipping": False}),
    ("ademamix", {"alpha": 3.0, "b3": 0.999, "mu_dtype": "bfloat16"}),
    ("adagrad", {"initial_accumulator_value": 0.0}),
    ("lion", {"mu_dtype": "bfloat16"}),
]


@pytest.mark.parametrize("name,params", OPTIONS,
                         ids=[f"{n}-{'-'.join(p)}" for n, p in OPTIONS])
def test_options_match_optax(name, params):
    """The branches the defaults leave off, against optax as above, plus
    two f32 ulps relative: without adopt's clipping, g / √v of a tiny
    first gradient drives some parameters to |p| ≈ 25."""
    p0, grads = _data(seed=3)
    lr = LR.get(name, 1e-2)
    for i, jp, tp, _, _ in _run_both(_raw(name, lr, 1e-5, **params), p0,
                                     grads, lr_after=lr / 2):
        for a, b in zip(jp, tp):
            assert np.isfinite(np.asarray(a)).all(), f"{name} step {i}"
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       atol=TOL, rtol=2.0 ** -22,
                                       err_msg=f"{name} {params} step {i}")


def test_state_dict_round_trip_mid_run():
    """After 2 steps the state goes through torch.save/torch.load (as the
    ``.train.pt`` sidecar does) into a fresh optimizer; its next step equals
    the original's bit for bit, for every name."""
    p0, grads = _data(seed=2)
    for name in NAMES:
        raw = _raw(name, LR.get(name, 1e-2), 1e-5)
        tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
        opt = TLOOP.make_optimizer(Config(raw), tp)
        for gs in grads[:2]:
            for p, g in zip(tp, gs):
                p.grad = torch.from_numpy(g)
            opt.step()
        twin = [torch.nn.Parameter(p.detach().clone()) for p in tp]
        buf = io.BytesIO()
        torch.save(opt.state_dict(), buf)
        buf.seek(0)
        again = TLOOP.make_optimizer(Config(raw), twin)
        again.load_state_dict(torch.load(buf, weights_only=True))
        for o, ps in ((opt, tp), (again, twin)):
            TLOOP.set_lr(o, 3e-3)
            for p, g in zip(ps, grads[2]):
                p.grad = torch.from_numpy(g)
            o.step()
        for a, b in zip(tp, twin):
            assert torch.equal(a, b), name


def test_kwargs_table_is_optax_signatures():
    """OPTAX_KWARGS lists each optax factory's keyword arguments in order,
    without learning_rate, with optax's defaults."""
    assert sorted(TOPT.OPTAX_KWARGS) == sorted(JLOOP._OPTAX_OPTIMIZERS)
    for name, factory in JLOOP._OPTAX_OPTIMIZERS.items():
        sig = inspect.signature(factory).parameters
        assert list(TOPT.OPTAX_KWARGS[name]) == [
            k for k in sig if k != "learning_rate"], name
        for k, want in TOPT.OPTAX_KWARGS[name].items():
            default = sig[k].default
            if callable(default) and not isinstance(default, type):
                assert want is None, (name, k)
                assert TOPT._fourth_root(16) == float(default(jnp.int32(16)))
            elif isinstance(default, type):
                assert TOPT._dtype(want) == torch.float32, (name, k)
                assert default is jnp.float32, (name, k)
            else:
                assert want == default, (name, k)


def test_names_and_unknown_names():
    """Case-insensitive lookup of all 26 names and Prodigy; any other name
    (also torch.optim's own ASGD, LBFGS, SparseAdam) raises the JAX
    package's ValueError with the same message."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    for name in NAMES + ["Prodigy"]:
        for spelled in (name, name.upper(), name.capitalize()):
            opt = TLOOP.make_optimizer(Config(_raw(spelled, 1e-3)), params)
            assert isinstance(opt, torch.optim.Optimizer)
    for name in ("muon", "ASGD", "LBFGS", "SparseAdam", "sophia", "nope"):
        with pytest.raises(ValueError) as want:
            JLOOP.make_optimizer(JaxConfig(_raw(name, 1e-3)))
        with pytest.raises(ValueError) as got:
            TLOOP.make_optimizer(Config(_raw(name, 1e-3)), params)
        assert str(got.value) == str(want.value)


def test_weight_decay_reaches_only_its_factories():
    """training.weight_decay reaches exactly the 11 factories that take
    ``weight_decay``; adafactor's weight_decay_rate does not pick it up;
    ``betas`` become b1/b2, or stay betas for dadaptadamw."""
    takes = {n for n in NAMES if "weight_decay" in TOPT.OPTAX_KWARGS[n]}
    assert takes == {"adamw", "adadelta", "nadamw", "adamaxw", "lion",
                     "lamb", "lars", "adan", "novograd", "dadaptadamw",
                     "ademamix"}
    params = [torch.nn.Parameter(torch.zeros(3))]
    for name in NAMES:
        opt = TLOOP.make_optimizer(
            Config(_raw(name, 1e-3, 0.123, b1=0.5)), params)
        group = opt.param_groups[0]
        assert (group.get("weight_decay") == 0.123) == (name in takes), name
        if name == "adafactor":
            assert group["weight_decay_rate"] is None
        if "b1" in TOPT.OPTAX_KWARGS[name]:
            assert (group["b1"], group["b2"]) == (0.9, 0.999), name
        if name == "dadaptadamw":
            assert group["betas"] == (0.9, 0.999)


def test_optimizer_path_names_no_torch_optim_algorithm():
    """The optimizer module builds on torch.optim.Optimizer alone."""
    src = inspect.getsource(TOPT)
    for cls in ("Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adadelta",
                "Adamax", "NAdam", "RAdam", "Rprop", "ASGD", "LBFGS",
                "SparseAdam", "Adafactor"):
        assert f"torch.optim.{cls}" not in src, cls
        assert f"optim.{cls}(" not in src, cls


# ---------------------------------------------------------------------------
# Per-leaf statistics through the tiny tagger's train step
# ---------------------------------------------------------------------------

def _port_arch(arch):
    def common(cls, obj, skip=()):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
                if f.name not in skip}
    return PT.TaggerArch(**common(PT.TaggerArch, arch, skip=("wavlm",)),
                         wavlm=PT.WavLMArch(**common(PT.WavLMArch,
                                                     arch.wavlm)))


@pytest.fixture(scope="module")
def tagger():
    """The tiny flagship (dropout 0, JAX's Pallas attention at every T), its
    JAX parameters, one batch, and the JAX leaves whose gradient is 0 in
    exact arithmetic (≤ 1e-6 × max|g| at the first step: the key biases,
    the conv bias before BatchNorm, ...)."""
    from tests.test_torch_train import _tiny_batch
    from wfl_asr_tpu.models import wavlm as jwavlm
    from wfl_asr_tpu.models.tagger import init_tagger
    mp = pytest.MonkeyPatch()
    mp.setattr(jwavlm, "FLASH_MIN_T", 0)
    base = graft._flagship_arch(tiny=True)
    arch = dataclasses.replace(
        base, use_flash_attention=True, conformer_dropout=0.0,
        wavlm=dataclasses.replace(base.wavlm, use_flash_attention=True,
                                  hidden_dropout=0.0))
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    batch = _tiny_batch(arch)
    jargs = [jnp.asarray(batch[k]) for k in TLOOP.BATCH_KEYS]
    grads = JLOOP.make_grad_step(arch, 0.1, 3.0)(
        params, copy.deepcopy(state), jax.random.PRNGKey(0), *jargs,
        max_label_len=batch["max_label_len"])[0]
    grads = jax.tree_util.tree_map(np.asarray, grads)
    gmax = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(grads))
    zero = jax.tree_util.tree_map(
        lambda g: bool(np.abs(g).max() <= 1e-6 * gmax), grads)
    yield dict(arch=arch, params=params, state=state, batch=batch,
               jargs=jargs, zero=zero)
    mp.undo()


def _zero_blocks(model, tagger):
    """The port's (parameter, row block) pairs of the JAX leaves flagged in
    ``tagger["zero"]``: the flags exported to the port's keys as the
    parameters are (in_proj's q, k, v become row blocks)."""
    flags = export_tagger(jax.tree_util.tree_map(
        lambda z, p: np.full(np.shape(p), float(z), np.float32),
        tagger["zero"], tagger["params"]), tagger["state"], "wavlm")
    blocks = model.jax_leaf_blocks()
    out = []
    for name, p in model.named_parameters():
        key = name if name in flags else name.replace(
            "conv.weight", "conv.parametrizations.weight.original1")
        flag = np.asarray(flags[key]).reshape(p.shape)
        for a, b in blocks.get(p, [(0, p.shape[0] if p.dim() else 1)]):
            if flag[a:b].all():
                out.append((p, a, b))
    return out


# the lr of each case: large enough that the run without the leaf map is
# far from optax, small enough that the card's f32 rounding stays < 1e-5
TAGGER_LR = {"lamb": 1e-3, "lars": 1.0, "fromage": 1e-3, "novograd": 1e-3,
             "adafactor": 3e-2, "sm3": 3e-2, "dadaptadamw": 1.0}
LEAF_CASES = [("lamb", False), ("lars", False), ("fromage", False),
              ("novograd", False), ("adafactor", False), ("sm3", False),
              ("dadaptadamw", False), ("dadaptadamw", True)]


@pytest.mark.parametrize("name,freeze", LEAF_CASES,
                         ids=[f"{n}{'-frozen' if f else ''}"
                              for n, f in LEAF_CASES])
def test_tagger_train_steps_match_jax(tagger, name, freeze):
    """3 train steps of the tiny flagship tagger: JAX's make_train_step
    (optax through JLOOP.make_optimizer, the encoder masked under
    freeze_encoder) against the port's micro_step + apply_update (its
    train_step) on trainable parameters only: every parameter and buffer
    ≤ 1e-5. The Conformer's in_proj statistics run over JAX's q, k, v
    leaves (``jax_leaf_blocks``); without that map the result is far off.

    The leaves whose gradient is 0 in exact arithmetic carry each side's
    rounding noise, which lamb's and novograd's per-leaf normalisation
    would turn into steps of random sign: they are set to exactly 0 on both
    sides before the optimizer (an ``optax.masked(set_to_zero())`` in front
    of the JAX transform; the same gradient blocks zeroed in the port)."""
    t = tagger
    arch = dataclasses.replace(t["arch"], freeze_encoder=freeze)
    batch, jargs = t["batch"], t["jargs"]
    raw = _raw(name, TAGGER_LR[name], 1e-5)

    mask = JLOOP.encoder_freeze_mask(t["params"]) if freeze else None
    tx = optax.chain(optax.masked(optax.set_to_zero(), t["zero"]),
                     JLOOP.make_optimizer(JaxConfig(raw), mask))
    train_step = JLOOP.make_train_step(arch, 0.1, 3.0, tx)
    jp, js = jax.tree_util.tree_map(jnp.asarray, (t["params"], t["state"]))
    ostate = tx.init(jp)
    for i in range(3):
        jp, js, ostate, _, _, _ = train_step(
            jp, js, ostate, jax.random.PRNGKey(i), *jargs,
            max_label_len=batch["max_label_len"])
    want = export_tagger(jax.tree_util.tree_map(np.asarray, jp),
                         jax.tree_util.tree_map(np.asarray, js), "wavlm")

    parch = _port_arch(arch)
    sd0 = state_dict_from_jax(t["params"], t["state"], parch)
    runs = {}
    for use_blocks in (True, False):
        model = PT.BIOPhonemeTagger(parch)
        model.load_state_dict(copy.deepcopy(sd0), strict=True)
        before = copy.deepcopy(model.state_dict())
        if freeze:
            model.encoder.requires_grad_(False)
        zero = _zero_blocks(model, t)
        opt = TLOOP.make_optimizer(
            Config(raw), [p for p in model.parameters() if p.requires_grad],
            model.jax_leaf_blocks() if use_blocks else None)
        for _ in range(3):
            TLOOP.micro_step(model, batch, "cpu", 1, 0.1, 3.0)
            for p, a, b in zero:
                if p.grad is not None:
                    p.grad[a:b] = 0.0
            TLOOP.apply_update(opt)
        runs[use_blocks] = model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(runs[True][k].numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0, err_msg=k)
    if freeze:
        for k, v in before.items():
            if k.startswith("encoder."):
                assert torch.equal(runs[True][k], v), k
    if name != "dadaptadamw":       # d and its sums are global
        gap = max(float((runs[False][k] - runs[True][k]).abs().max())
                  for k in runs[True] if "in_proj" in k)
        assert gap > 1e-4, f"{name}: the leaf map changed nothing ({gap})"
