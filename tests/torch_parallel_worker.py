"""One rank of a ``gloo`` world for tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r LOCAL_WORLD_SIZE=n MASTER_ADDR=127.0.0.1 \
        MASTER_PORT=p python tests/torch_parallel_worker.py SPEC.json

The spec names a directory holding ``model.pt`` (the tagger's arch and
state_dict), ``batch.npz`` (one global batch) and ``serve/`` (a serving
save dir), and a list of cases. Each rank joins the world through
``parallel.maybe_initialize_distributed`` (the launcher's variables), runs
every case on its shard and rank 0 writes ``CASE.npz``:

- ``step``: one update of the train loop's step machinery (``_shard_model``,
  ``RematStep`` with ``_gradient_hooks``, ``FullTensorStep``) on this data
  rank's rows: the data-averaged loss, the gathered gradients (``g/NAME``)
  and parameters after the update (``p/NAME``, buffers too);
- ``optim``: FSDP's optimizer step for one optimizer name on seeded
  synthetic gradients, two updates (``p/NAME`` after them);
- ``serve``: ``InferenceSession(model_parallel=mp)`` logits on fixed rows;
- ``replicate``: ``parallel.replicate`` of a rank-dependent tensor, every
  rank's result gathered;
- pipeline parallelism (tests/test_torch_pp.py): ``pp_step`` (the train
  loop's PP step; with ``steps`` > 1 the replicated parameters of every
  stage too), ``pp_gpipe`` (``gpipe_apply`` on a stack of tanh layers, its
  output and gradients), ``pp_encoders`` (the WavLM and Whisper encoders
  pipelined against a one-process copy on the same rank), ``pp_optim`` (an
  optimizer over the stages' parameters on seeded gradients) and
  ``pp_serve`` (``InferenceSession`` with ``model.pipeline_parallel``);
  stage-local tensors are gathered over each pipeline.

The parent reads ``DONE`` lines from each rank's output.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wfl_asr_tpu_torch.config import Config  # noqa: E402
from wfl_asr_tpu_torch.models import layers  # noqa: E402
from wfl_asr_tpu_torch.models.tagger import BIOPhonemeTagger  # noqa: E402
from wfl_asr_tpu_torch.parallel import fsdp as pfsdp  # noqa: E402
from wfl_asr_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from wfl_asr_tpu_torch.parallel import pp  # noqa: E402
from wfl_asr_tpu_torch.train import loop  # noqa: E402

STEP_KW = dict(label_smoothing=0.1, subframe_weight=3.0)


def optimizer_raw(name: str) -> dict:
    """The training section of an optimizer case (shared with the test)."""
    lr = 1.0 if name.lower() in ("prodigy", "dadaptadamw", "adadelta") \
        else 1e-2
    t = {"optimizer": name, "learning_rate": lr, "weight_decay": 1e-4,
         "optimizer_params": {}}
    if name.lower() == "prodigy":
        t["optimizer_params"] = {"betas": [0.9, 0.999], "eps": 1e-8}
    if name.lower() == "dadaptadamw":
        t["optimizer_params"] = {"estim_lr0": 1e-2}
    return {"training": t}


def synthetic_grads(model, step: int):
    """Seeded gradients by parameter name (the same in every process)."""
    out = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        rng = np.random.RandomState(1000 * step + i)
        out[name] = torch.from_numpy(
            rng.randn(*p.shape).astype(np.float32) * 0.1)
    return out


def load_model(root: str, arch_fields=None) -> BIOPhonemeTagger:
    blob = torch.load(os.path.join(root, "model.pt"), weights_only=False)
    arch = blob["arch"]
    if arch_fields:
        import dataclasses
        wavlm = dataclasses.replace(arch.wavlm,
                                    **arch_fields.get("wavlm", {}))
        arch = dataclasses.replace(arch, wavlm=wavlm,
                                   **arch_fields.get("tagger", {}))
    model = BIOPhonemeTagger(arch)
    model.load_state_dict(blob["state"], strict=True)
    return model


def _full_grads(model):
    return {name: pfsdp._full(p.grad).clone() for name, p in
            model.named_parameters() if p.grad is not None}


def run_step(case, root):
    mesh = pmesh.make_mesh(case["mp"], "cpu")
    model = load_model(root, case.get("arch"))
    par = loop.Parallel(mesh, fsdp=case["mode"] == "fsdp",
                        model_parallel=case["mp"],
                        sequence_parallel=bool(case.get("sp")))
    net = loop._shard_model(model, par, torch.device("cpu"))
    if case["mode"] == "fsdp":
        from torch.distributed.tensor import DTensor
        assert not any(isinstance(p, DTensor)
                       for p in model.bilstm.parameters())
        assert isinstance(model.conformer_layers[0].conv[2].weight, DTensor)
    cfg = Config(optimizer_raw(case.get("optimizer", "Prodigy")))
    opt = loop.make_optimizer(
        cfg, [p for p in model.parameters() if p.requires_grad],
        model.jax_leaf_blocks())
    if par.sharded_params:
        opt = pfsdp.FullTensorStep(opt)
    gen = torch.Generator().manual_seed(case.get("seed", 7))
    if mesh.data_size > 1:
        gen = layers.Generators(torch.Generator().manual_seed(
            loop._local_seed(7, mesh.data_rank)), gen)
    sync, after = loop._gradient_hooks(net, model, par)
    grads = {}

    def capture():
        if after is not None:
            after()
        grads.update(_full_grads(model))

    step = loop.RematStep("off", net, gen, sync=sync, after_backward=capture)
    with np.load(os.path.join(root, "batch.npz")) as data:
        batch = {k: data[k] for k in data.files}
    batch["max_label_len"] = int(batch["max_label_len"])
    rows = pmesh.shard_batch(batch, mesh)
    metrics, _ = step(opt, [rows], "cpu", mean_count=mesh.mean_count,
                      **STEP_KW)
    metrics = mesh.average_scalars(metrics)
    out = {k: float(v) for k, v in metrics.items()}
    out.update({f"g/{k}": v.numpy() for k, v in grads.items()})
    out.update({f"p/{k}": v.numpy() for k, v in
                pfsdp.full_state_dict(model).items()})
    return out


def run_optim(case, root):
    from torch.distributed.tensor import DTensor
    mesh = pmesh.make_mesh(1, "cpu")
    model = load_model(root)
    pfsdp.shard_params_fsdp(model, mesh)
    cfg = Config(optimizer_raw(case["optimizer"]))
    opt = pfsdp.FullTensorStep(loop.make_optimizer(
        cfg, list(model.parameters()), model.jax_leaf_blocks()))
    for k in range(2):
        grads = synthetic_grads(model, k)
        for name, p in model.named_parameters():
            g = grads[name]
            p.grad = (DTensor.from_local(pfsdp._shard_like(g, p),
                                         p.device_mesh, p.placements,
                                         shape=p.shape, stride=p.stride())
                      if isinstance(p, DTensor) else g)
        loop.apply_update(opt)
    return {f"p/{k}": v.numpy() for k, v in
            pfsdp.full_state_dict(model).items()}


def run_serve(case, root):
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession
    serve = os.path.join(root, "serve")
    cfg = os.path.join(serve, "config.yaml")
    if case.get("sp"):
        import yaml
        raw = yaml.safe_load(open(cfg))
        raw["model"]["sequence_parallel"] = True
        cfg = raw
    arch = torch.load(os.path.join(root, "model.pt"),
                      weights_only=False)["arch"]
    session = InferenceSession(cfg, os.path.join(serve, "model.pt"),
                               arch=arch, device="cpu",
                               model_parallel=case["mp"])
    rng = np.random.RandomState(11)
    audios = [(rng.randn(n) * 0.3).astype(np.float32)
              for n in (9000, 16000, 23999)]
    out = {}
    for i, (lg, off) in enumerate(session.forward_many(
            audios, [[0, 1]] * len(audios))):
        out[f"logits/{i}"], out[f"offsets/{i}"] = lg, off
    return out


def run_replicate(case, root):
    x = torch.full((3,), float(dist.get_rank() + 1))
    pmesh.replicate({"x": x}, None)
    got = [torch.empty(3) for _ in range(dist.get_world_size())]
    dist.all_gather(got, x)
    return {"x": torch.stack(got).numpy()}


def _stage_gather(mesh, tensors):
    """{name: tensor} of every stage of this rank's pipeline, merged."""
    parts = [None] * mesh.stage_size
    dist.all_gather_object(parts, {k: v.detach().clone()
                                   for k, v in tensors.items()},
                           group=mesh.stage_group)
    out = {}
    for part in parts:
        out.update(part)
    return out


def _named_tensors(model):
    """Parameters and buffers by name (the pos conv's weight as itself, not
    its state_dict's weight-norm pair)."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _pp_setup(case, root):
    mesh = pp.make_pp_mesh(case.get("stages", 2), "cpu")
    model = load_model(root, case.get("arch"))
    par = loop.Parallel(mesh, pipeline=mesh.stage_size,
                        pp_microbatches=case.get("m", 0))
    par.full_names = [n for n, _ in model.named_parameters()]
    net = loop._shard_model(model, par, torch.device("cpu"))
    return mesh, model, par, net


def _pp_optimizer(case, model, mesh):
    named = dict(model.named_parameters())
    cfg = Config(optimizer_raw(case.get("optimizer", "Prodigy")))
    return loop.make_optimizer(
        cfg, list(named.values()), model.jax_leaf_blocks(),
        stacked=pp.StackedLeaves(named, mesh,
                                 model.encoder.pipeline.num_layers))


def run_pp_step(case, root):
    mesh, model, par, net = _pp_setup(case, root)
    opt = _pp_optimizer(case, model, mesh)
    gen = layers.Generators(
        torch.Generator().manual_seed(loop._local_seed(7, dist.get_rank())),
        torch.Generator().manual_seed(case.get("seed", 7)))
    sync, after = loop._gradient_hooks(net, model, par)
    grads = {}

    def capture():
        after()
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})

    step = loop.RematStep("on" if case.get("remat") else "off", net, gen,
                          sync=sync, after_backward=capture)
    with np.load(os.path.join(root, "batch.npz")) as data:
        batch = {k: data[k] for k in data.files}
    batch["max_label_len"] = int(batch["max_label_len"])
    rows = pmesh.shard_batch(batch, mesh)
    out = {}
    for i in range(case.get("steps", 1)):
        grads.clear()
        metrics, _ = step(opt, [rows], "cpu", mean_count=mesh.mean_count,
                          **STEP_KW)
        metrics = mesh.average_scalars(metrics)
        if i == 0:
            out = {k: float(v) for k, v in metrics.items()}
            out.update({f"g/{k}": v.numpy() for k, v in
                        _stage_gather(mesh, grads).items()})
    out.update({f"p/{k}": v.numpy() for k, v in
                _stage_gather(mesh, _named_tensors(model)).items()})
    replicas = {k: v for k, v in model.state_dict().items()
                if pp.pp_spec(k) == "replicated"}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, replicas)
    out["replica_gap"] = max(
        float((r[k].float() - replicas[k].float()).abs().max())
        for r in every for k in replicas)
    return out


class _Tanh(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))
        self.b = torch.nn.Parameter(torch.from_numpy(b))


def gpipe_data(seed=7, n_layers=4, width=8, rows=8, t=6):
    """A stack of tanh layers, its input, a row mask and a row scale (the
    same in every process)."""
    rng = np.random.RandomState(seed)
    ws = (rng.randn(n_layers, width, width) * 0.3).astype(np.float32)
    bs = (rng.randn(n_layers, width) * 0.1).astype(np.float32)
    x = rng.randn(rows, t, width).astype(np.float32)
    mask = (rng.rand(rows, t) > 0.3).astype(np.float32)
    scale = (1.0 + rng.rand(t)).astype(np.float32)
    return ws, bs, x, mask, scale


def gpipe_layer(lay, h, mask, scale):
    return torch.tanh(h @ lay.w + lay.b) * mask[:, :, None] * scale[:, None]


def run_pp_gpipe(case, root):
    mesh = pp.make_pp_mesh(case.get("stages", 2), "cpu")
    ws, bs, x0, mask, scale = gpipe_data()
    local = pp.stage_layers(len(ws), mesh)
    out = {}
    for m in case["microbatches"]:
        lays = [_Tanh(ws[i].copy(), bs[i].copy()) for i in local]
        x = torch.from_numpy(x0.copy()).requires_grad_(True)
        sc = torch.from_numpy(scale.copy()).requires_grad_(True)

        def run(h, rows, shr, i):
            for lay in lays:
                h = gpipe_layer(lay, h, rows[0], shr[0])
            return h

        y = pp.gpipe_apply(run, x, mesh, m,
                           per_row=(torch.from_numpy(mask),), shared=(sc,))
        (y * y).sum().backward()
        grads = {f"w{i}": lay.w.grad for i, lay in zip(local, lays)}
        grads.update({f"b{i}": lay.b.grad for i, lay in zip(local, lays)})
        full = _stage_gather(mesh, grads)
        out[f"y/{m}"] = y.detach().numpy()
        out[f"gx/{m}"] = x.grad.numpy()
        out[f"gscale/{m}"] = sc.grad.numpy()
        for k, v in full.items():
            out[f"g{k}/{m}"] = v.numpy()
    return out


def run_pp_encoders(case, root):
    """Each encoder pipelined (M = 2 microbatches) against a one-process
    copy of the same weights on this rank: the output and every gradient's
    gap, relative to the largest gradient."""
    import copy
    from wfl_asr_tpu_torch.models.wavlm import WavLMEncoder
    from wfl_asr_tpu_torch.models.whisper import WhisperEncoder
    mesh = pp.make_pp_mesh(case.get("stages", 2), "cpu")
    out = {}
    arch = torch.load(os.path.join(root, "model.pt"),
                      weights_only=False)["arch"]
    from wfl_asr_tpu_torch.models import whisper as PW
    encs = {"wavlm": (WavLMEncoder, arch.wavlm),
            "whisper": (WhisperEncoder, PW.WhisperArch(
                d_model=80, num_layers=4, num_heads=2, ffn_dim=128))}
    for name, (cls, a) in encs.items():
        torch.manual_seed(0)
        full = cls(a).train()
        ref = copy.deepcopy(full)

        class Holder(torch.nn.Module):
            pass

        holder = Holder()
        holder.encoder = full
        pp.shard_params_pp(holder, mesh, microbatches=2)
        g = torch.Generator().manual_seed(1)
        if name == "wavlm":
            inp = torch.randn(4, 2400, generator=g)
            mask = torch.ones(4, a.feature_lengths(2400), dtype=torch.bool)
            mask[1, 70:] = False
            kw = dict(mask=mask)
        else:
            inp = torch.randn(4, a.num_mel_bins, 3000, generator=g)
            kw = {}
        y = full(inp, **kw)
        y_ref = ref(inp, **kw)
        (y * y).sum().backward()
        (y_ref * y_ref).sum().backward()
        want = {k: p.grad for k, p in ref.named_parameters()
                if p.grad is not None}
        got = _stage_gather(mesh, {k: p.grad for k, p in
                                   full.named_parameters()
                                   if p.grad is not None})
        gmax = max(float(v.abs().max()) for v in want.values())
        tiny = [k for k, v in want.items()
                if float(v.abs().max()) <= 1e-6 * gmax]
        out[f"{name}/fwd"] = float((y - y_ref).abs().max())
        out[f"{name}/scale"] = float(y_ref.abs().max())
        out[f"{name}/grad"] = max(float((got[k] - v).abs().max()) / gmax
                                  for k, v in want.items() if k not in tiny)
        out[f"{name}/names"] = float(len(set(got) ^ set(want)))
    return out


def run_pp_optim(case, root):
    mesh, model, _, _ = _pp_setup(case, root)
    opt = _pp_optimizer(case, model, mesh)
    for k in range(2):
        with np.load(os.path.join(root, f"grads{k}.npz")) as grads:
            for name, p in model.named_parameters():
                p.grad = torch.from_numpy(np.array(grads[name])).reshape(
                    p.shape)
        loop.apply_update(opt)
    return {f"p/{k}": v.numpy()
            for k, v in _stage_gather(mesh, _named_tensors(model)).items()}


def run_pp_serve(case, root):
    from wfl_asr_tpu_torch.infer.pipeline import InferenceSession
    import yaml
    serve = os.path.join(root, "serve")
    raw = yaml.safe_load(open(os.path.join(serve, "config.yaml")))
    raw["model"]["pipeline_parallel"] = case.get("stages", 2)
    arch = torch.load(os.path.join(root, "model.pt"),
                      weights_only=False)["arch"]
    session = InferenceSession(raw, os.path.join(serve, "model.pt"),
                               arch=arch, device="cpu")
    assert session.mesh.shape["stage"] == case.get("stages", 2)
    rng = np.random.RandomState(11)
    audios = [(rng.randn(n) * 0.3).astype(np.float32)
              for n in (9000, 16000, 23999)]
    out = {}
    for i, (lg, off) in enumerate(session.forward_many(
            audios, [[0, 1]] * len(audios))):
        out[f"logits/{i}"], out[f"offsets/{i}"] = lg, off
    return out


def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    pmesh.maybe_initialize_distributed(device="cpu",
                                       timeout_s=spec.get("timeout", 300))
    root = spec["dir"]
    runners = {"step": run_step, "optim": run_optim, "serve": run_serve,
               "replicate": run_replicate, "pp_step": run_pp_step,
               "pp_gpipe": run_pp_gpipe, "pp_encoders": run_pp_encoders,
               "pp_optim": run_pp_optim, "pp_serve": run_pp_serve}
    for case in spec["cases"]:
        out = runners[case["kind"]](case, root)
        if dist.get_rank() == 0:
            np.savez(os.path.join(root, f"{case['name']}.npz"), **out)
        print(f"DONE {case['name']}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
