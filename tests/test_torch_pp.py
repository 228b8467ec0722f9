"""The port's pipeline parallelism (``wfl_asr_tpu_torch/parallel/pp.py``) on
the CPU, in ``gloo`` worlds.

One module fixture starts everything at once: two worlds of
tests/torch_parallel_worker.py (one process a rank, joined through
``maybe_initialize_distributed``, a free port each, a join timeout) and the
train and infer command lines under ``python -m torch.distributed.run``:

- 2 ranks, stage 2: ``gpipe_apply`` on a stack of 4 tanh layers at 1-8
  microbatches (the counterparts of tests/test_pipeline_parallel.py:39-104
  and :332); the WavLM and Whisper encoders pipelined against
  unpipelined; Prodigy train steps (plain, remat, strict dropout +
  LayerDrop, two steps); the optimizers with statistics over a leaf or
  the tree on seeded gradients; serving;
- 4 ranks, data 2 × stage 2: a Prodigy train step;
- ``python -m wfl_asr_tpu_torch.train`` with ``training.pipeline_parallel:
  2`` against one process, then resumed from its own checkpoint; ``python
  -m wfl_asr_tpu_torch.infer`` on a folder with ``model.pipeline_parallel:
  2`` against one process.

Meanwhile the parent computes the references on the same numpy-seeded
weights (the tiny flagship tagger, its WavLM deepened to 4 layers, dropout
off) and 4-row batch: the port's one-process steps, and the JAX package's
gradients on its 8-device CPU mesh with pipeline parallelism
(``make_pp_mesh(2)``: data 4 × stage 2), under
``jax.default_matmul_precision("highest")``. Tolerances: against the
port, loss 1e-6 relative, gradients 1e-5 × max|g|, parameters after one
Prodigy update 1e-5; against JAX, tests/test_torch_train.py's: loss 1e-5,
gradients 1e-4 × max|g|; the optimizers against optax's update of the
stacked tree (the JAX package's PP layout) on the same gradients,
test_torch_optimizers' 1e-6.

The resume and the infer command lines start once the trainings are done,
while the parent computes the rest.

    python -m pytest tests/test_torch_pp.py -q
"""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.ops.kernels import dropout_mask as DM
from wfl_asr_tpu_torch.ops.kernels import flash_attention as FA
from wfl_asr_tpu_torch.parallel import pp as PP
from wfl_asr_tpu_torch.train import loop as TLOOP

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_parallel as TP  # noqa: E402
import test_torch_parallel_cli as CLI  # noqa: E402
import torch_parallel_worker as W  # noqa: E402

JOIN_TIMEOUT_S = 420
STEP_CASES = ("step", "remat", "grid")
# the optimizers whose statistics span a leaf (held to optax's update of
# the stacked tree) or the whole tree (the same sums as one process: held
# to the port's one-process optimizer, itself held to optax by
# tests/test_torch_optimizers.py)
LEAF_NAMES = ("lamb", "adafactor", "sm3", "novograd")
TREE_NAMES = ("Prodigy", "dadaptadamw")
OPT_NAMES = LEAF_NAMES + TREE_NAMES
MICROBATCHES = (1, 2, 4, 8)


def _jax_arch():
    base = TP._jax_arch()
    return dataclasses.replace(
        base, use_flash_attention=False,
        wavlm=dataclasses.replace(base.wavlm, num_layers=4,
                                  use_flash_attention=False))


def _stack(tree):
    from wfl_asr_tpu.parallel import pp as JPP
    tree = dict(tree)
    enc = dict(tree["encoder"])
    enc["layers"] = JPP.stack_layers(enc["layers"])
    tree["encoder"] = enc
    return tree


def _unstack(tree):
    from wfl_asr_tpu.parallel import pp as JPP
    tree = dict(tree)
    enc = dict(tree["encoder"])
    enc["layers"] = JPP.unstack_layers(enc["layers"])
    tree["encoder"] = enc
    return tree


def _export(tree, state):
    out = export_tagger(jax.tree_util.tree_map(np.asarray, tree),
                        jax.tree_util.tree_map(np.asarray, state), "wavlm")
    pre = "encoder.encoder.pos_conv_embed.conv."
    out[pre + "weight"] = out.pop(pre + "parametrizations.weight.original1")
    del out[pre + "parametrizations.weight.original0"]
    return {k: v for k, v in out.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def _jax_pp_grads(arch, params, state, batch):
    """The JAX package's loss and gradients with the encoder's layers
    stacked over its ('data', 'stage') mesh (data 4 × stage 2)."""
    from wfl_asr_tpu.parallel import pp as JPP
    from wfl_asr_tpu.parallel import replicate, shard_batch
    from wfl_asr_tpu.train import loop as JLOOP
    mesh = JPP.make_pp_mesh(2)
    p = JPP.shard_params_pp(_stack(params), mesh)
    s = replicate(state, mesh)
    jargs = shard_batch({k: batch[k] for k in TLOOP.BATCH_KEYS}, mesh,
                        pad_value_map={"labels": -100})
    step = JLOOP.make_grad_step(arch, 0.1, 3.0, mesh=mesh)
    with mesh:
        g, js, m, _, _ = step(p, s, jax.random.PRNGKey(1),
                              *[jargs[k] for k in TLOOP.BATCH_KEYS],
                              max_label_len=int(batch["max_label_len"]))
    g = _unstack(jax.tree_util.tree_map(np.asarray, g))
    return float(m["loss"]), _export(g, jax.tree_util.tree_map(np.asarray,
                                                              js))


def _synthetic(params, k):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(100 + k)
    return jax.tree_util.tree_unflatten(tree, [
        (rng.randn(*np.shape(x)) * 0.1).astype(np.float32) for x in leaves])


def _jax_optim(name, params, state):
    """optax's parameters after two updates on the seeded gradients, the
    tree stacked (the JAX package's PP layout)."""
    from wfl_asr_tpu.config import Config as JaxConfig
    from wfl_asr_tpu.train import loop as JLOOP
    tx = JLOOP.make_optimizer(JaxConfig(W.optimizer_raw(name)))
    p = _stack(jax.tree_util.tree_map(jnp.asarray, params))
    ostate = tx.init(p)
    update = jax.jit(tx.update)
    for k in range(2):
        u, ostate = update(_stack(_synthetic(params, k)), ostate, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
    return _export(_unstack(p), state)


def _port_optim(root, name):
    """The port's one-process optimizer on the same two gradients."""
    model = W.load_model(root)
    opt = TLOOP.make_optimizer(Config(W.optimizer_raw(name)),
                               list(model.parameters()),
                               model.jax_leaf_blocks())
    for k in range(2):
        with np.load(os.path.join(root, f"grads{k}.npz")) as grads:
            for n, p in model.named_parameters():
                p.grad = torch.from_numpy(np.array(grads[n])).reshape(
                    p.shape)
        TLOOP.apply_update(opt)
    return {k: v.detach().numpy() for k, v in
            {**dict(model.named_parameters()),
             **dict(model.named_buffers())}.items()}


def _cli_start(root):
    """The PP and one-process train and infer command lines, started."""
    from wfl_asr_tpu_torch.preprocess import preprocess
    CLI._make_data(root)
    procs = {}
    for run, ranks, extra in (("one", 1, {}),
                              ("pp", 2, {"pipeline_parallel": 2,
                                         "pp_microbatches": 2,
                                         "sharded_validation": True})):
        cfg = CLI._config(root, run, **extra)
        cfg["model"]["encoder_arch_overrides"]["num_layers"] = 4
        preprocess(os.path.join(root, "data"), cfg)
        path = os.path.join(root, run, "config.yaml")
        with open(path) as f:
            written = yaml.safe_load(f)
        written["training"].update(extra)
        with open(path, "w") as f:
            yaml.safe_dump(written, f)
        log = os.path.join(root, f"train_{run}.log")
        procs[f"train_{run}"] = (CLI._start(
            ["-m", "wfl_asr_tpu_torch.train", path, "--device", "cpu"],
            ranks, log), log)
    return procs


def _cli_infer(root):
    """The one-process run's last model serves the corpus's first
    language's folder, batched (one process, and two ranks with
    model.pipeline_parallel)."""
    wavs = os.path.join(root, "data", "en")
    procs = {}
    for run, ranks in (("one", 1), ("pp", 2)):
        cfg = os.path.join(root, "one", "config.yaml")
        if ranks > 1:
            with open(cfg) as f:
                raw = yaml.safe_load(f)
            raw["model"]["pipeline_parallel"] = 2
            cfg = os.path.join(root, "serve_pp.yaml")
            with open(cfg, "w") as f:
                yaml.safe_dump(raw, f)
        folder = os.path.join(root, f"wavs_{run}")
        os.makedirs(folder)
        for name in os.listdir(wavs):
            if name.endswith(".wav"):
                with open(os.path.join(wavs, name), "rb") as src, \
                        open(os.path.join(folder, name), "wb") as dst:
                    dst.write(src.read())
        log = os.path.join(root, f"infer_{run}.log")
        procs[f"infer_{run}"] = (CLI._start(
            ["-m", "wfl_asr_tpu_torch.infer", folder, "-ckpt",
             os.path.join(root, "one", "last_model.pt"), "-c", cfg,
             "-o", os.path.join(root, f"labs_{run}"), "-b", "8",
             "--device", "cpu"], ranks, log), log)
    return procs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from wfl_asr_tpu.models.tagger import init_tagger
    from wfl_asr_tpu_torch.checkpoint import save_model_checkpoint
    root = str(tmp_path_factory.mktemp("pp"))
    cli_root = str(tmp_path_factory.mktemp("pp_cli"))
    arch = _jax_arch()
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    parch = TP._port_arch(arch)
    sd = state_dict_from_jax(params, state, parch)
    torch.save({"arch": parch, "state": sd}, os.path.join(root, "model.pt"))
    batch = TP._batch(arch)
    np.savez(os.path.join(root, "batch.npz"), **batch)
    serve = os.path.join(root, "serve")
    os.makedirs(serve)
    labels = ["O"] + [f"{t}-p{i}" for i in range(36) for t in "BI"]
    with open(os.path.join(serve, "phonemes.txt"), "w") as f:
        f.write("\n".join(labels[:parch.num_labels]) + "\n")
    with open(os.path.join(serve, "langs.txt"), "w") as f:
        f.write("en,0\nja,1\n")
    with open(os.path.join(serve, "config.yaml"), "w") as f:
        yaml.safe_dump({"data": {"sample_rate": 16000},
                        "model": {"encoder_type": "wavlm",
                                  "num_languages": 2},
                        "output": {"save_dir": serve}}, f)
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(sd, strict=True)
    save_model_checkpoint(os.path.join(serve, "model.pt"), model)
    # the optimizer cases' gradients, by the port's names
    for k in range(2):
        g = _export(_synthetic(params, k), state)
        np.savez(os.path.join(root, f"grads{k}.npz"), **g)

    step = lambda name, **kw: dict(kind="pp_step", name=name, **kw)  # noqa
    spawned = [
        TP._spawn(root, "pp2", 2, [
            dict(kind="pp_gpipe", name="gpipe",
                 microbatches=list(MICROBATCHES)),
            dict(kind="pp_encoders", name="encoders"),
            step("step", m=2), step("remat", m=2, remat=True),
            step("strict", m=2, arch=TP.STRICT),
            step("twice", m=4, steps=2),
            dict(kind="pp_serve", name="serve")]
            + [dict(kind="pp_optim", name=f"optim_{n}", optimizer=n)
               for n in OPT_NAMES]),
        TP._spawn(root, "grid4", 4, [step("grid")]),
    ]
    cli = _cli_start(cli_root)
    deadline = time.time() + JOIN_TIMEOUT_S

    torch.set_num_threads(2)
    with jax.default_matmul_precision("highest"):
        ref = {"port": TP._port_step(root, batch),
               "strict": TP._port_step(root, batch, TP.STRICT),
               "jax_pp": _jax_pp_grads(arch, params, state, batch),
               "jax": TP._jax_grads(arch, params, state, batch)}
    # the trainings are done by now: resume the PP run from its own step-4
    # checkpoint, and serve the one-process run's model both ways
    CLI._finish(list(cli.values()))
    with open(os.path.join(cli_root, "pp", "config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["training"]["max_steps"] = 6
    with open(os.path.join(cli_root, "pp", "resume.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    later = {"resume": (CLI._start(
        ["-m", "wfl_asr_tpu_torch.train",
         os.path.join(cli_root, "pp", "resume.yaml"), "--device", "cpu"],
        2, os.path.join(cli_root, "resume.log")),
        os.path.join(cli_root, "resume.log"))}
    later.update(_cli_infer(cli_root))
    with jax.default_matmul_precision("highest"):
        ref["optim"] = {n: _jax_optim(n, params, state)
                        for n in LEAF_NAMES}
    ref["optim"].update({n: _port_optim(root, n) for n in TREE_NAMES})
    ref["flat"] = {n: _port_optim(root, n) for n in LEAF_NAMES}
    ref["root"], ref["cli"] = root, cli_root
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession
    session = InferenceSession(os.path.join(serve, "config.yaml"),
                               os.path.join(serve, "model.pt"),
                               arch=parch, device="cpu")
    rng = np.random.RandomState(11)
    audios = [(rng.randn(n) * 0.3).astype(np.float32)
              for n in (9000, 16000, 23999)]
    ref["serve"] = session.forward_many(audios, [[0, 1]] * len(audios))

    for world in spawned:
        TP._join(root, world, deadline)
    CLI._finish(list(later.values()))
    got = {}
    for name in os.listdir(root):
        if name.endswith(".npz") and not name.startswith(("batch",
                                                           "grads")):
            with np.load(os.path.join(root, name)) as data:
                got[name[:-4]] = {k: data[k] for k in data.files}
    return ref, got


# ---------------------------------------------------------------------------
# The schedule and the encoders
# ---------------------------------------------------------------------------

def _gpipe_reference():
    """The sequential loop's output and gradients of (y²).sum()."""
    ws, bs, x0, mask, scale = W.gpipe_data()
    lays = [W._Tanh(w.copy(), b.copy()) for w, b in zip(ws, bs)]
    x = torch.from_numpy(x0.copy()).requires_grad_(True)
    sc = torch.from_numpy(scale.copy()).requires_grad_(True)
    h = x
    for lay in lays:
        h = W.gpipe_layer(lay, h, torch.from_numpy(mask), sc)
    (h * h).sum().backward()
    out = {"y": h.detach().numpy(), "gx": x.grad.numpy(),
           "gscale": sc.grad.numpy()}
    for i, lay in enumerate(lays):
        out[f"gw{i}"], out[f"gb{i}"] = lay.w.grad.numpy(), lay.b.grad.numpy()
    return out


@pytest.mark.parametrize("m", MICROBATCHES)
def test_gpipe_matches_sequential(worlds, m):
    """Stage 2 over 4 layers at M microbatches (8 rows; at 8 one row a
    microbatch): the output, the input's gradient, every layer's weight
    and bias gradients and the shared operand's gradient equal the
    sequential loop's (rtol 1e-5, atol 1e-6, as the JAX schedule tests);
    the per-row mask is sliced per microbatch."""
    _, got = worlds
    res, want = got["gpipe"], _gpipe_reference()
    for k, w in want.items():
        np.testing.assert_allclose(res[f"{k}/{m}"], w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{k} at M={m}")


@pytest.mark.parametrize("encoder", ["wavlm", "whisper"])
def test_encoder_pipelined_matches_unpipelined(worlds, encoder):
    """Each encoder (4 layers, stage 2, 2 microbatches; WavLM with a frame
    mask and its shared position bias) against its one-process forward and
    backward on the same rank: the output within 1e-5 × max, every
    gradient within 1e-5 × max|g|, the same parameter names."""
    _, got = worlds
    res = got["encoders"]
    assert res[f"{encoder}/fwd"] <= 1e-5 * res[f"{encoder}/scale"]
    assert res[f"{encoder}/grad"] <= 1e-5
    assert res[f"{encoder}/names"] == 0


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", STEP_CASES)
def test_pp_step_matches_single_process(worlds, case):
    """Stage 2 (plain; remat, whose step is the plain step), and data 2 ×
    stage 2: loss 1e-6 relative, gradients 1e-5 × max|g|, parameters and
    BatchNorm statistics after one Prodigy update 1e-5, against the port's
    one-process step."""
    ref, got = worlds
    want, res = ref["port"], got[case]
    for k in ("loss", "ce", "offset_loss"):
        assert res[k] == pytest.approx(want[k], rel=1e-6), k
    TP._assert_grads(res, {k[2:]: v for k, v in want.items()
                           if k.startswith("g/")}, 1e-5)
    for k, w in want.items():
        if k.startswith("p/") and not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(res[k], w, atol=1e-5, rtol=0,
                                       err_msg=k)


POS_CONV = "encoder.encoder.pos_conv_embed.conv.weight"


@pytest.mark.parametrize("case", ["step", "grid"])
def test_pp_step_matches_jax_pp(worlds, case):
    """Against the JAX package's PP step (data 4 × stage 2 on its 8-device
    CPU mesh, the layers stacked): loss 1e-5, gradients 1e-4 × max|g|.
    One gradient differs, by the JAX package: its PP step gives WavLM's
    position-conv weight S = 2 times the gradient of its own unpipelined
    step (every other gradient is the unpipelined one). The port gives the
    unpipelined gradient there; both facts are held to 1e-4 × max|g|."""
    ref, got = worlds
    loss, want = ref["jax_pp"]
    _, plain = ref["jax"]
    assert got[case]["loss"] == pytest.approx(loss, abs=1e-5)
    TP._assert_grads(got[case], {k: np.asarray(v) for k, v in want.items()
                                 if k != POS_CONV}, 1e-4)
    gmax = max(np.abs(v).max() for v in want.values())
    np.testing.assert_allclose(want[POS_CONV], 2 * plain[POS_CONV],
                               atol=1e-4 * gmax, rtol=0)
    np.testing.assert_allclose(got[case]["g/" + POS_CONV], plain[POS_CONV],
                               atol=1e-4 * gmax, rtol=0)


def test_pp_remat_step_is_the_pp_step(worlds):
    """Remat (each stage checkpoints its layers) changes nothing: the same
    loss and gradients as the stage-2 step, 1e-6 relative / 1e-6 × max."""
    _, got = worlds
    a, b = got["step"], got["remat"]
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    TP._assert_grads(b, {k[2:]: v for k, v in a.items()
                         if k.startswith("g/")}, 1e-6)


def test_strict_dropout_pp_step_is_the_single_process_step(worlds):
    """Strict attention dropout (0.2) and LayerDrop (0.4) at stage 2, 2
    microbatches: every stage replays the layers' LayerDrop draws and
    seeds from the shared stream, each microbatch's kernel call carries its
    row origin, so the step is the one-process strict step (loss 1e-6
    relative, gradients 1e-5 × max|g|)."""
    ref, got = worlds
    want, res = ref["strict"], got["strict"]
    plain = ref["port"]["g/encoder.encoder.layers.1.attention.q_proj.weight"]
    strict = want["g/encoder.encoder.layers.1.attention.q_proj.weight"]
    assert np.abs(strict - plain).max() > 0.1 * np.abs(plain).max(), \
        "dropout changed nothing: the check would be vacuous"
    for k in ("loss", "ce", "offset_loss"):
        assert res[k] == pytest.approx(want[k], rel=1e-6), k
    TP._assert_grads(res, {k[2:]: v for k, v in want.items()
                           if k.startswith("g/")}, 1e-5)


@pytest.mark.parametrize("rows", [2, 4])
def test_microbatch_masks_are_the_unsharded_masks(rows):
    """Each microbatch's strict-dropout seed with its origin (b0 = its first
    global row) gives the rows of the unsharded call's mask, bit for bit."""
    seed = torch.tensor([987654321], dtype=torch.int32)
    b, h, t = 8, 3, 20
    full = DM.mask_grid(seed, b, h, t, t, 0.2, "cpu")
    for b0 in range(0, b, rows):
        got = DM.mask_grid(FA.shard_seed(seed, (b0, 0)), rows, h, t, t, 0.2,
                           "cpu")
        assert torch.equal(got, full[b0:b0 + rows]), b0


def test_replicas_stay_equal_across_stages(worlds):
    """After two steps at 4 microbatches every replicated parameter and
    buffer is the same on both stages, to the bit."""
    _, got = worlds
    assert got["twice"]["replica_gap"] == 0.0


@pytest.mark.parametrize("name", OPT_NAMES)
def test_stacked_statistics_match_jax_pp(worlds, name):
    """Each optimizer whose statistics span a leaf (lamb's trust ratios,
    adafactor's block and parameter RMS, sm3's accumulators, novograd's
    moment) over the stages' parameters, two updates on seeded gradients:
    every parameter within 1e-6 of optax's update of the stacked tree, the
    JAX package's PP layout — which differs from the one-process update.
    Prodigy's and D-Adaptation's sums over the tree (stage-local leaves
    added over the stages, replicated ones once) give the one-process
    update, 1e-6."""
    ref, got = worlds
    want, res = ref["optim"][name], got[f"optim_{name}"]
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(res[f"p/{k}"], np.asarray(w), atol=1e-6,
                                   rtol=0, err_msg=k)
    if name in LEAF_NAMES:
        flat = ref["flat"][name]
        gap = max(float(np.abs(np.asarray(want[k]) - flat[k]).max())
                  for k in want if k in flat)
        assert gap > 1e-5, f"{name}: stacking changed nothing ({gap})"


# ---------------------------------------------------------------------------
# Serving and the command lines
# ---------------------------------------------------------------------------

def test_pp_serving_matches_single_process(worlds):
    """``InferenceSession`` with ``model.pipeline_parallel: 2``: logits and
    offsets of bucketed rows within 1e-5 of the one-process session's."""
    ref, got = worlds
    for i, (lg, off) in enumerate(ref["serve"]):
        np.testing.assert_allclose(got["serve"][f"logits/{i}"], lg,
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["serve"][f"offsets/{i}"], off,
                                   atol=1e-5, rtol=0)


def test_pp_train_cli_matches_one_process(worlds):
    """``training.pipeline_parallel: 2`` under torch.distributed.run: the
    same train and (sharded) validation losses as one process (1e-6
    relative) and the same canonical step-4 checkpoint, gathered from the
    stages (every tensor within 1e-5)."""
    ref, _ = worlds
    one = os.path.join(ref["cli"], "one")
    two = os.path.join(ref["cli"], "pp")
    for kind in ("train", "val"):
        # the PP run's log goes on past step 4 after its resume
        a = CLI._events(one, kind)
        b = [e for e in CLI._events(two, kind) if e[0] <= 4]
        assert a and [s for s, _ in a] == [s for s, _ in b]
        for (_, x), (_, y) in zip(a, b):
            assert y == pytest.approx(x, rel=1e-6), kind
    sd1 = torch.load(os.path.join(one, "model_step4.pt"), weights_only=True)
    sd2 = torch.load(os.path.join(two, "model_step4.pt"), weights_only=True)
    assert sd1.keys() == sd2.keys()
    for k in sd1:
        torch.testing.assert_close(sd2[k].float(), sd1[k].float(), atol=1e-5,
                                   rtol=0, msg=k)


def test_pp_train_cli_resumes_its_checkpoint(worlds):
    """The PP run resumes from its step-4 checkpoint and sidecar (the
    optimizer state gathered from the stages, each stage given its layers'
    slice) and trains steps 5-6."""
    ref, _ = worlds
    with open(os.path.join(ref["cli"], "resume.log")) as f:
        log = f.read()
    assert "Resuming from checkpoint: model_step4.pt" in log
    assert "Restored optimizer, generator and scheduler state" in log
    steps = [s for s, _ in CLI._events(os.path.join(ref["cli"], "pp"),
                                       "train")]
    assert steps == [1, 2, 3, 4, 5, 6]
    state = torch.load(os.path.join(ref["cli"], "pp",
                                    "model_step6.train.pt"),
                       weights_only=True)
    assert state["pipeline_stages"] == 2 and state["step"] == 6
    opt = state["optimizer"]
    # every parameter of the one-process model has its state, in its order
    assert opt["state"] and \
        sorted(opt["state"]) == opt["param_groups"][0]["params"]


def test_pp_infer_cli_labs_match_one_process(worlds):
    """``python -m wfl_asr_tpu_torch.infer FOLDER -b 8`` with
    ``model.pipeline_parallel: 2`` on two ranks: ``.lab`` files
    byte-identical to one process's, written once (by the first stage)."""
    ref, _ = worlds
    one = os.path.join(ref["cli"], "labs_one")
    two = os.path.join(ref["cli"], "labs_pp")
    names = sorted(os.listdir(one))
    assert names and names == sorted(os.listdir(two))
    for name in names:
        with open(os.path.join(one, name), "rb") as a, \
                open(os.path.join(two, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(ref["cli"], "infer_pp.log")) as f:
        assert "pipeline-parallel serving" in f.read()


# ---------------------------------------------------------------------------
# The guards and the pure functions
# ---------------------------------------------------------------------------

def _cfg(**training):
    raw = {"model": {"encoder_type": training.pop("encoder", "wavlm")},
           "training": {"batch_size": 4, **training}}
    return Config(raw)


@pytest.mark.parametrize("training,match", [
    ({"model_parallel": 2}, "mutually exclusive"),
    ({"fsdp": True}, "training.fsdp is mutually exclusive"),
    ({"encoder": "none"}, "needs a layered encoder"),
    ({}, "needs multiple visible devices"),
])
def test_pp_guards_raise_the_jax_errors(training, match):
    """The JAX loop's ``ValueError``s (loop.py:684-701, 709-712, 745-747):
    PP with model parallelism, with FSDP, for an encoder other than wavlm
    or whisper, and with one rank."""
    with pytest.raises(ValueError, match=match):
        TLOOP.plan_parallel(_cfg(pipeline_parallel=2, **training), "cpu")


def test_pp_across_nodes_raises(monkeypatch):
    monkeypatch.setattr(TLOOP.pmesh, "node_count", lambda env=None: 2)
    with pytest.raises(ValueError, match="not supported across nodes"):
        TLOOP.plan_parallel(_cfg(pipeline_parallel=2), "cpu")


def test_pp_mesh_and_layer_errors():
    """``make_pp_mesh``'s and ``place_stacked``'s errors; the spec and the
    stacked-leaf key of a parameter name; the microbatch clamp."""
    with pytest.raises(ValueError, match="must be >= 2"):
        PP.make_pp_mesh(1, "cpu", world=8)
    with pytest.raises(ValueError, match="not divisible by num_stages=3"):
        PP.make_pp_mesh(3, "cpu", world=8)
    mesh = PP.PipelineMesh(None, 1, 1, 0, 0, stage_size=4, stage_rank=2)
    with pytest.raises(ValueError, match="6 layers not divisible by 4"):
        PP.stage_layers(6, mesh)
    assert PP.stage_layers(12, mesh) == range(6, 9)
    enc = "encoder.encoder.layers.7.attention.q_proj.weight"
    assert PP.pp_spec(enc) == "stage"
    assert PP.stacked_key(enc) == "encoder.encoder.layers.*.attention." \
        "q_proj.weight"
    assert PP.pp_spec("encoder.layers.3.fc1.weight") == "stage"
    for name in ("encoder.encoder.layers.0.attention.rel_attn_embed.weight",
                 "conformer_layers.0.ff1.net.1.weight", "classifier.bias",
                 "encoder.feature_projection.projection.weight"):
        assert PP.pp_spec(name) == "replicated", name
    assert PP.microbatch_count(0, 8) == 8
    assert PP.microbatch_count(3, 8) == 1
    assert PP.microbatch_count(4, 2) == 2


def test_serving_pp_errors(tmp_path):
    """The JAX session's errors for ``model.pipeline_parallel`` (one
    visible rank that S does not divide; an encoder without layers)."""
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession
    for encoder, match in (("wavlm", "does not divide the 1 visible"),
                           ("none", "needs a layered encoder")):
        raw = {"model": {"encoder_type": encoder, "pipeline_parallel": 2,
                         "num_languages": 0,
                         "wavlm_model": "microsoft/wavlm-base-plus"},
               "output": {"save_dir": str(tmp_path)}}
        (tmp_path / "phonemes.txt").write_text("O\nB-a\nI-a\n")
        (tmp_path / "langs.txt").write_text("")
        with pytest.raises(ValueError, match=match):
            InferenceSession(raw, str(tmp_path / "missing.pt"),
                             device="cpu")


def test_pp_world_of_one_has_no_pipeline():
    """Without a process group the PP module's collectives are never
    reached: ``make_pp_mesh`` needs one."""
    with pytest.raises(RuntimeError, match="initialized process group"):
        PP.make_pp_mesh(2, "cpu", world=2)
