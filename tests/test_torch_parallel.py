"""The port's data, fully-sharded, tensor and sequence parallelism
(``wfl_asr_tpu_torch/parallel/``) on the CPU, in ``gloo`` worlds.

One module fixture spawns three worlds at once (tests/torch_parallel_worker.py,
one process a rank, each joined through ``maybe_initialize_distributed``
from the launcher's variables, a free port each, a join timeout):

- 2 ranks, data 2: a DP (DDP) step and an FSDP step of the tiny flagship
  tagger, and FSDP's optimizer step for every optimizer name on seeded
  synthetic gradients;
- 2 ranks, model 2: a TP step, an SP + TP step, and TP (+ SP) serving;
- 4 ranks, data 2 × model 2: a DP + TP step, and one with strict attention
  dropout and LayerDrop.

Meanwhile the parent computes the references: the port's single-process
step on the same numpy-seeded weights and 4-row batch, and the JAX
package's gradients on them, unsharded and on its 8-device CPU mesh with
tensor parallelism (data 4 × model 2), under
``jax.default_matmul_precision("highest")`` with dropout off. Tolerances:
against the port, loss 1e-6 relative, gradients 1e-5 × max|g|, parameters
after one Prodigy update 1e-5; against JAX, tests/test_torch_train.py's:
loss 1e-5, gradients 1e-4 × max|g| (gradients that are 0 in exact
arithmetic — the key bias, the conv bias before BatchNorm — held to
1e-6 × max|g| on both sides). FSDP's optimizer step: parameters after two
updates within 1e-6 of the single-process optimizer's (same full-tensor
arithmetic). The strict-dropout step: the shards' seeds carry their
origins, so it equals the single-process strict step (loss 1e-6
relative), and the masks are bit-identical (checked on the entry points
directly, by batch and by head split).

    python -m pytest tests/test_torch_parallel.py -q
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from wfl_asr_tpu.parallel import fsdp as JFSDP
from wfl_asr_tpu_torch.config import Config
from wfl_asr_tpu_torch.models import tagger as PT
from wfl_asr_tpu_torch.models.convert import export_tagger, \
    state_dict_from_jax
from wfl_asr_tpu_torch.ops.kernels import dropout_mask as DM
from wfl_asr_tpu_torch.ops.kernels import flash_attention as FA
from wfl_asr_tpu_torch.ops.kernels.flash_attention_bwd import \
    flash_attention_trainable
from wfl_asr_tpu_torch.parallel import fsdp as PFSDP
from wfl_asr_tpu_torch.parallel import mesh as PMESH
from wfl_asr_tpu_torch.train import losses as TL
from wfl_asr_tpu_torch.train import loop as TLOOP
from wfl_asr_tpu_torch.train import optimizers as TOPT

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_worker as W  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
NAMES = ["Prodigy"] + sorted(TOPT.OPTIMIZERS)
STEP_CASES = ("dp", "fsdp", "tp", "sp", "dptp")
JOIN_TIMEOUT_S = 420
STRICT = {"wavlm": {"strict_attention_dropout": True,
                    "attention_dropout": 0.2, "layerdrop": 0.4}}


def _common(cls, obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if f.name not in skip}


def _jax_arch():
    base = graft._flagship_arch(tiny=True)
    return dataclasses.replace(
        base, use_flash_attention=True, conformer_dropout=0.0,
        wavlm=dataclasses.replace(base.wavlm, use_flash_attention=True,
                                  hidden_dropout=0.0))


def _port_arch(arch):
    return PT.TaggerArch(**_common(PT.TaggerArch, arch, skip=("wavlm",)),
                         wavlm=PT.WavLMArch(**_common(PT.WavLMArch,
                                                      arch.wavlm)))


def _batch(arch, seed=3):
    """Four rows of unequal audio and label lengths (the data ranks' valid
    label counts differ), −100-padded, with offset targets."""
    rng = np.random.RandomState(seed)
    s, lens, max_label = 2400, (22, 17, 9, 20), 50
    audio = (rng.randn(4, s) * 0.3).astype(np.float32)
    audio[1, 1900:] = 0.0
    audio[2, 1200:] = 0.0
    labels = np.full((4, max_label), -100, np.int64)
    targets = []
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(0, arch.num_labels, size=n)
        segs = [(0.0, 0.07 + 0.01 * i, "a"), (0.07 + 0.01 * i, 0.3, "b"),
                (0.3, 0.41, "a")]
        targets.append(TL.offset_targets_from_segments(segs, 0.02, n, 64))
    f, c, x, v = (np.stack([t[j] for t in targets]) for j in range(4))
    return {"audio": audio, "labels": labels,
            "lang_ids": np.array([0, 1, 1, 0], np.int32), "off_frames": f,
            "off_channels": c, "off_fracs": x, "off_valid": v,
            "max_label_len": np.int64(max_label)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(root, name, n, cases):
    spec = os.path.join(root, f"{name}.json")
    with open(spec, "w") as f:
        json.dump({"dir": root, "cases": cases, "timeout": 300}, f)
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
        env.pop("TORCHELASTIC_RUN_ID", None)
        log = open(os.path.join(root, f"{name}.{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, spec],
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return name, procs


def _join(root, world, deadline):
    name, procs = world
    for p, log in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
        log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(root, f"{name}.{bad[0]}.log")) as f:
            tail = f.read()[-4000:]
        pytest.fail(f"world {name}: ranks {bad} failed:\n{tail}")


def _port_step(root, batch, arch_fields=None, optimizer="Prodigy"):
    """The port's single-process step (loss, grads, params after it)."""
    model = W.load_model(root, arch_fields)
    opt = TLOOP.make_optimizer(Config(W.optimizer_raw(optimizer)),
                               list(model.parameters()),
                               model.jax_leaf_blocks())
    grads = {}
    step = TLOOP.RematStep(
        "off", model, torch.Generator().manual_seed(7),
        after_backward=lambda: grads.update(
            {k: p.grad.clone() for k, p in model.named_parameters()}))
    b = dict(batch, max_label_len=int(batch["max_label_len"]))
    metrics, _ = step(opt, [b], "cpu", **W.STEP_KW)
    out = {k: float(v) for k, v in metrics.items()}
    out.update({f"g/{k}": v.numpy() for k, v in grads.items()})
    out.update({f"p/{k}": v.detach().numpy()
                for k, v in PFSDP.full_state_dict(model).items()})
    return out


def _port_optim(root, name):
    model = W.load_model(root)
    opt = TLOOP.make_optimizer(Config(W.optimizer_raw(name)),
                               list(model.parameters()),
                               model.jax_leaf_blocks())
    for k in range(2):
        grads = W.synthetic_grads(model, k)
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        TLOOP.apply_update(opt)
    return {f"p/{k}": v.detach().numpy()
            for k, v in PFSDP.full_state_dict(model).items()}


def _jax_grads(arch, params, state, batch, mesh=None):
    """JAX's gradients and loss, unsharded or on ``mesh`` with TP."""
    from wfl_asr_tpu.train import loop as JLOOP
    jargs = {k: batch[k] for k in TLOOP.BATCH_KEYS}
    p, s = params, state
    if mesh is not None:
        from wfl_asr_tpu.parallel import replicate, shard_batch, \
            shard_params_tp
        p = shard_params_tp(params, mesh)
        s = replicate(state, mesh)
        jargs = shard_batch(jargs, mesh, pad_value_map={"labels": -100})
    else:
        p = jax.tree_util.tree_map(jnp.asarray, params)
        s = jax.tree_util.tree_map(jnp.asarray, state)
        jargs = {k: jnp.asarray(v) for k, v in jargs.items()}
    step = JLOOP.make_grad_step(arch, 0.1, 3.0, mesh=mesh)
    if mesh is not None:
        with mesh:
            g, js, m, _, _ = step(p, s, jax.random.PRNGKey(1),
                                  *[jargs[k] for k in TLOOP.BATCH_KEYS],
                                  max_label_len=int(batch["max_label_len"]))
    else:
        g, js, m, _, _ = step(p, s, jax.random.PRNGKey(1),
                              *[jargs[k] for k in TLOOP.BATCH_KEYS],
                              max_label_len=int(batch["max_label_len"]))
    g = jax.tree_util.tree_map(np.asarray, g)
    js = jax.tree_util.tree_map(np.asarray, js)
    want = export_tagger(g, js, "wavlm")
    pre = "encoder.encoder.pos_conv_embed.conv."
    want[pre + "weight"] = want.pop(pre + "parametrizations.weight.original1")
    del want[pre + "parametrizations.weight.original0"]
    want = {k: v for k, v in want.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}
    return float(m["loss"]), want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from wfl_asr_tpu.models import wavlm as jwavlm
    from wfl_asr_tpu.models.tagger import init_tagger
    from wfl_asr_tpu.parallel import make_mesh
    from wfl_asr_tpu_torch.checkpoint import save_model_checkpoint
    root = str(tmp_path_factory.mktemp("parallel"))
    arch = _jax_arch()
    params, state = init_tagger(jax.random.PRNGKey(0), arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    parch = _port_arch(arch)
    sd = state_dict_from_jax(params, state, parch)
    torch.save({"arch": parch, "state": sd}, os.path.join(root, "model.pt"))
    batch = _batch(arch)
    np.savez(os.path.join(root, "batch.npz"), **batch)
    serve = os.path.join(root, "serve")
    os.makedirs(serve)
    labels = ["O"] + [f"{t}-p{i}" for i in range(36) for t in "BI"]
    with open(os.path.join(serve, "phonemes.txt"), "w") as f:
        f.write("\n".join(labels[:parch.num_labels]) + "\n")
    with open(os.path.join(serve, "langs.txt"), "w") as f:
        f.write("en,0\nja,1\n")
    import yaml
    with open(os.path.join(serve, "config.yaml"), "w") as f:
        yaml.safe_dump({"data": {"sample_rate": 16000},
                        "model": {"encoder_type": "wavlm",
                                  "num_languages": 2},
                        "output": {"save_dir": serve}}, f)
    model = PT.BIOPhonemeTagger(parch)
    model.load_state_dict(sd, strict=True)
    save_model_checkpoint(os.path.join(serve, "model.pt"), model)

    step = lambda name, mode, mp, **kw: dict(kind="step", name=name,  # noqa
                                             mode=mode, mp=mp, **kw)
    spawned = [
        _spawn(root, "data2", 2, [step("dp", "ddp", 1),
                                  step("fsdp", "fsdp", 1),
                                  dict(kind="replicate", name="replicate")]
               + [dict(kind="optim", name=f"optim_{n}", optimizer=n)
                  for n in NAMES]),
        _spawn(root, "model2", 2, [
            step("tp", "tp", 2), step("sp", "tp", 2, sp=True),
            dict(kind="serve", name="serve_tp", mp=2),
            dict(kind="serve", name="serve_sp", mp=2, sp=True)]),
        _spawn(root, "grid4", 4, [step("dptp", "tp", 2),
                                  step("strict", "tp", 2, arch=STRICT)]),
    ]
    deadline = time.time() + JOIN_TIMEOUT_S

    # the references, while the worlds run
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jwavlm, "FLASH_MIN_T", 0)
    try:
        with jax.default_matmul_precision("highest"):
            ref = {"port": _port_step(root, batch),
                   "strict": _port_step(root, batch, STRICT),
                   "jax": _jax_grads(arch, params, state, batch),
                   "jax_mesh": _jax_grads(arch, params, state, batch,
                                          make_mesh(model_parallel=2))}
    finally:
        mp.undo()
    ref["optim"] = {n: _port_optim(root, n) for n in NAMES}
    ref["root"] = root
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession
    session = InferenceSession(os.path.join(serve, "config.yaml"),
                               os.path.join(serve, "model.pt"),
                               arch=parch, device="cpu")
    rng = np.random.RandomState(11)
    audios = [(rng.randn(n) * 0.3).astype(np.float32)
              for n in (9000, 16000, 23999)]
    ref["serve"] = session.forward_many(audios, [[0, 1]] * len(audios))

    for world in spawned:
        _join(root, world, deadline)
    got = {}
    for name in os.listdir(root):
        if name.endswith(".npz") and name != "batch.npz":
            with np.load(os.path.join(root, name)) as data:
                got[name[:-4]] = {k: data[k] for k in data.files}
    return ref, got


def _assert_grads(got, want, rel, tiny=1e-6):
    gmax = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got[f"g/{name}"].reshape(w.shape)
        if np.abs(w).max() <= tiny * gmax:
            # 0 in exact arithmetic: rounding noise on both sides
            assert np.abs(g).max() <= tiny * gmax, name
            continue
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_single_process(worlds, case):
    """Loss 1e-6 relative, gradients 1e-5 × max|g|, parameters and
    BatchNorm statistics after one Prodigy update 1e-5."""
    ref, got = worlds
    want, res = ref["port"], got[case]
    for k in ("loss", "ce", "offset_loss"):
        assert res[k] == pytest.approx(want[k], rel=1e-6), k
    _assert_grads(res, {k[2:]: v for k, v in want.items()
                        if k.startswith("g/")}, 1e-5)
    for k, w in want.items():
        if k.startswith("p/") and not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(res[k], w, atol=1e-5, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_jax(worlds, case):
    """Against the JAX package's unsharded step and its (data 4 × model 2)
    TP mesh step: loss 1e-5, gradients 1e-4 × max|g|."""
    ref, got = worlds
    for key in ("jax", "jax_mesh"):
        loss, want = ref[key]
        assert got[case]["loss"] == pytest.approx(loss, abs=1e-5), key
        _assert_grads(got[case], {k: np.asarray(v) for k, v in want.items()},
                      1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_fsdp_optimizer_step_is_the_unsharded_step(worlds, name):
    """Every optimizer name on FSDP's shards (data 2): the parameters
    after two updates on the same gradients equal the single-process
    optimizer's (1e-6): Prodigy's and D-Adaptation's global sums, the
    per-leaf trust ratios and norms, Adafactor's factored moments and SM3's
    accumulators over whole JAX leaves (the Conformer's in_proj row blocks
    straddle the shard boundary)."""
    ref, got = worlds
    want, res = ref["optim"][name], got[f"optim_{name}"]
    for k, w in want.items():
        np.testing.assert_allclose(res[k], w, atol=1e-6, rtol=0, err_msg=k)
    w0 = W.load_model(ref["root"]).state_dict()
    assert max(np.abs(want[f"p/{k}"] - w0[k].numpy()).max()
               for k in ("classifier.weight", "lang_proj.weight")) > 1e-6, \
        "the updates moved nothing: the check would be vacuous"


def test_strict_dropout_dp_tp_step_is_the_unsharded_step(worlds):
    """Strict attention dropout (rate 0.2) and LayerDrop (0.4) under data
    2 × model 2: the LayerDrop draws and seeds come from the shared
    generator, each shard's seed carries its origin, so the step is the
    single-process strict step."""
    ref, got = worlds
    want, res = ref["strict"], got["strict"]
    plain = ref["port"]["g/encoder.encoder.layers.1.attention.q_proj.weight"]
    strict = want["g/encoder.encoder.layers.1.attention.q_proj.weight"]
    assert np.abs(strict - plain).max() > 0.1 * np.abs(plain).max(), \
        "dropout changed nothing: the check would be vacuous"
    for k in ("loss", "ce", "offset_loss"):
        assert res[k] == pytest.approx(want[k], rel=1e-6), k
    _assert_grads(res, {k[2:]: v for k, v in want.items()
                        if k.startswith("g/")}, 1e-5)


@pytest.mark.parametrize("case", ["serve_tp", "serve_sp"])
def test_tensor_parallel_serving_matches_unsharded(worlds, case):
    """``InferenceSession(model_parallel=2)`` (with and without
    ``model.sequence_parallel``): logits and offsets of bucketed rows
    within 1e-5 of the unsharded session's."""
    ref, got = worlds
    for i, (lg, off) in enumerate(ref["serve"]):
        np.testing.assert_allclose(got[case][f"logits/{i}"], lg, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got[case][f"offsets/{i}"], off,
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# In-process: the pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_size", [1, 2, 4, 8])
def test_fsdp_spec_matches_jax(data_size):
    shapes = [(), (7,), (768,), (3072, 768), (768, 3072), (2304, 768),
              (128, 128), (129, 127), (16384,), (16383,), (512, 512, 3),
              (320, 12), (1, 12, 1, 1), (73, 64), (12, 4096, 2)]
    for shape in shapes:
        assert PFSDP.fsdp_spec(shape, data_size) == tuple(
            JFSDP.fsdp_spec(shape, data_size)), shape
    assert PFSDP.MIN_SHARD_SIZE == JFSDP.MIN_SHARD_SIZE


@pytest.mark.parametrize("entry", ["gated", "trainable"])
def test_shard_origin_gives_the_unsharded_mask(entry):
    """Each shard of the batch (2) and of the heads (2), called through the
    entry point with its origin, gives the unsharded call's output rows bit
    for bit (strict dropout 0.3, ragged keys), and its mask is the
    unsharded mask's block."""
    g = torch.Generator().manual_seed(0)
    b, h, t, d = 4, 4, 24, 16
    q, k, v = (torch.randn(b, h, t, d, generator=g) for _ in range(3))
    bias = torch.randn(h, t, t, generator=g)
    gate = torch.rand(b, h, t, generator=g) + 0.5
    kv = torch.tensor([24, 17, 9, 20], dtype=torch.int32)
    seed = torch.tensor([123456789], dtype=torch.int32)

    def call(rows, heads, origin):
        args = [x[rows][:, heads] for x in (q, k, v)]
        if entry == "gated":
            return FA.flash_attention(*args, bias=bias[heads],
                                      gate=gate[rows][:, heads],
                                      kv_len=kv[rows], dropout_rate=0.3,
                                      dropout_seed=seed, origin=origin)
        return flash_attention_trainable(*args, kv_len=kv[rows],
                                         dropout_rate=0.3, dropout_seed=seed,
                                         origin=origin)

    full = call(slice(None), slice(None), (0, 0))
    for r0 in (0, 2):
        for h0 in (0, 2):
            rows, heads = slice(r0, r0 + 2), slice(h0, h0 + 2)
            part = call(rows, heads, (r0, h0))
            assert torch.equal(part, full[rows][:, heads]), (r0, h0)
            got = DM.mask_grid(FA.shard_seed(seed, (r0, h0)), 2, 2, t, t,
                               0.3, "cpu")
            want = DM.mask_grid(seed, b, h, t, t, 0.3, "cpu")
            assert torch.equal(got, want[rows][:, heads]), (r0, h0)


def test_replicate_broadcasts_rank_0(worlds):
    _, got = worlds
    np.testing.assert_array_equal(got["replicate"]["x"], np.ones((2, 3)))


def test_shard_batch_and_make_mesh():
    """Rows padded to the data size (labels −100) and cut to the data
    rank's block; a world that model_parallel does not divide raises."""
    mesh = PMESH.Mesh(None, 2, 1, 1, 0)
    out = PMESH.shard_batch({"audio": np.ones((3, 5), np.float32),
                             "labels": np.ones((3, 4), np.int64),
                             "max_label_len": 4}, mesh,
                            pad_value_map={"labels": -100})
    assert out["audio"].shape == (2, 5) and out["max_label_len"] == 4
    assert np.all(out["labels"][1] == -100) and np.all(out["audio"][1] == 0)
    assert PMESH.shard_rows(8, mesh) == (4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        PMESH.make_mesh(4, "cpu", world=6)


# ---------------------------------------------------------------------------
# maybe_initialize_distributed (after tests/test_parallel.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_guard(monkeypatch):
    monkeypatch.setattr(PMESH, "_dist_initialized", False)


def test_maybe_initialize_distributed_guard(fresh_guard):
    """Joins iff a launcher's world is set, exactly once; gloo on the
    CPU, NCCL on the card."""
    calls = []
    init = lambda **kw: calls.append(kw)  # noqa: E731
    assert PMESH.maybe_initialize_distributed(env={}, _initialize=init,
                                              device="cpu") is False
    assert PMESH.maybe_initialize_distributed(
        env={"WORLD_SIZE": "1"}, _initialize=init) is False
    env = {"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "x"}
    assert PMESH.maybe_initialize_distributed(env=env, _initialize=init,
                                              device="cpu") is True
    assert [c["backend"] for c in calls] == ["gloo"]
    assert PMESH.maybe_initialize_distributed(env=env,
                                              _initialize=init) is False
    assert len(calls) == 1


def test_torchrun_world_of_one_joins(fresh_guard):
    """torchrun's world of one (TORCHELASTIC_RUN_ID) is a world."""
    calls = []
    assert PMESH.maybe_initialize_distributed(
        env={"WORLD_SIZE": "1", "TORCHELASTIC_RUN_ID": "r"},
        _initialize=lambda **kw: calls.append(kw)) is True
    assert calls[0]["backend"] == "nccl"


def test_launch_signal_classification():
    assert PMESH._launch_signal({}) is None
    assert PMESH._launch_signal({"WORLD_SIZE": "1"}) is None
    assert PMESH._launch_signal({"WORLD_SIZE": "4"}) == "explicit"
    assert PMESH._launch_signal({"SLURM_NTASKS": "2"}) == "heuristic"
    assert PMESH._launch_signal({"SLURM_NTASKS": "1"}) is None
    assert PMESH._launch_signal({"OMPI_COMM_WORLD_SIZE": "8"}) == \
        "heuristic"


def test_second_init_is_benign(fresh_guard):
    def twice(**kw):
        raise RuntimeError("trying to initialize the default process group "
                           "twice!")

    assert PMESH.maybe_initialize_distributed(
        env={"WORLD_SIZE": "2"}, _initialize=twice) is True


def test_handshake_failure_propagates(fresh_guard):
    def fail(**kw):
        raise RuntimeError("connect() timed out")

    with pytest.raises(RuntimeError, match="timed out"):
        PMESH.maybe_initialize_distributed(env={"WORLD_SIZE": "2"},
                                           _initialize=fail)
    assert PMESH._dist_initialized is False


def test_valueerror_degrades_only_for_a_hint(fresh_guard):
    """A scheduler's hint that cannot rendezvous degrades once, with a
    warning; the same ValueError under a launcher's WORLD_SIZE raises."""
    calls = []

    def no_master(**kw):
        calls.append(kw)
        raise ValueError("environment variable MASTER_ADDR expected")

    env = {"SLURM_NTASKS": "2", "SLURM_PROCID": "1"}
    assert PMESH.maybe_initialize_distributed(env=env,
                                              _initialize=no_master) is False
    assert PMESH.maybe_initialize_distributed(env=env,
                                              _initialize=no_master) is False
    assert len(calls) == 1 and calls[0]["world_size"] == 2 \
        and calls[0]["rank"] == 1
    PMESH._dist_initialized = False
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        PMESH.maybe_initialize_distributed(env={"WORLD_SIZE": "2"},
                                           _initialize=no_master)


def test_serving_pipeline_parallel_raises_and_sp_warns(worlds, capsys):
    """``model.pipeline_parallel: 2`` in one process is the JAX session's
    ``ValueError`` (2 stages do not divide the one visible rank; PP serving
    itself runs in tests/test_torch_pp.py); without a model dim
    ``model.sequence_parallel`` warns as the JAX session does."""
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession
    ref, _ = worlds
    serve = os.path.join(ref["root"], "serve")
    arch = torch.load(os.path.join(ref["root"], "model.pt"),
                      weights_only=False)["arch"]
    import yaml
    with open(os.path.join(serve, "config.yaml")) as f:
        raw = yaml.safe_load(f)
    for key, val in (("pipeline_parallel", 2), ("sequence_parallel", True)):
        cfg = json.loads(json.dumps(raw))
        cfg["model"][key] = val
        if key == "pipeline_parallel":
            with pytest.raises(ValueError, match="does not divide the 1 "
                                                 "visible devices"):
                InferenceSession(cfg, os.path.join(serve, "model.pt"),
                                 arch=arch, device="cpu")
        else:
            session = InferenceSession(cfg, os.path.join(serve, "model.pt"),
                                       arch=arch, device="cpu")
            assert not session.sequence_parallel
            assert "model.sequence_parallel ignored" in \
                capsys.readouterr().out


def test_tp_spec_is_the_jax_placement():
    """``tp.tp_spec`` gives ``tp._spec_for``'s placements in torch's
    [out, in] layout; the packed in_proj stays replicated."""
    from wfl_asr_tpu.parallel import tp as JTP
    from jax.sharding import PartitionSpec as P
    from wfl_asr_tpu_torch.parallel import tp
    enc = "encoder.encoder.layers.3.attention."
    cases = {
        enc + "q_proj.weight": (2, ("model", None), ("q", "w"), (None,
                                                                "model")),
        enc + "v_proj.bias": (1, ("model",), ("v", "b"), ("model",)),
        enc + "out_proj.weight": (2, (None, "model"), ("out", "w"),
                                  ("model", None)),
        enc + "out_proj.bias": (1, (), ("out", "b"), ()),
        enc + "gru_rel_pos_const": (4, (None, "model", None, None), None,
                                    None),
        "encoder.encoder.layers.0.attention.rel_attn_embed.weight":
            (2, (None, "model"), ("rel_attn_embed", "w"), (None, "model")),
        "encoder.encoder.layers.1.feed_forward.intermediate_dense.weight":
            (2, ("model", None), ("ff_in", "w"), (None, "model")),
        "encoder.layers.2.fc2.weight": (2, (None, "model"), ("ff_out", "w"),
                                        ("model", None)),
        "conformer_layers.0.ff2.net.1.bias": (1, ("model",), ("in", "b"),
                                              ("model",)),
        "conformer_layers.1.self_attn.out_proj.weight":
            (2, (None, "model"), ("attn_out", "w"), ("model", None)),
        "conformer_layers.1.self_attn.in_proj_weight": (2, (), None, None),
        "classifier.weight": (2, (), ("classifier", "w"), ()),
        "encoder.encoder.layers.3.attention.gru_rel_pos_linear.weight":
            (2, (), ("gru_rel_pos_linear", "w"), ()),
    }

    class Key:
        def __init__(self, key):
            self.key = key

    for name, (ndim, want, jax_path, jax_want) in cases.items():
        assert tp.tp_spec(name, ndim) == want, name
        if jax_path is not None:
            leaf = np.zeros((2,) * ndim)
            assert JTP._spec_for([Key(k) for k in jax_path], leaf) == \
                P(*jax_want), name


def test_tp_needs_divisible_heads_and_widths():
    from wfl_asr_tpu_torch.parallel import tp
    parch = _port_arch(_jax_arch())
    tp.check_divisible(parch, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tp.check_divisible(parch, 3)
