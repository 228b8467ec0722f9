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
  rank's result gathered.

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


def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    pmesh.maybe_initialize_distributed(device="cpu",
                                       timeout_s=spec.get("timeout", 300))
    root = spec["dir"]
    runners = {"step": run_step, "optim": run_optim, "serve": run_serve,
               "replicate": run_replicate}
    for case in spec["cases"]:
        out = runners[case["kind"]](case, root)
        if dist.get_rank() == 0:
            np.savez(os.path.join(root, f"{case['name']}.npz"), **out)
        print(f"DONE {case['name']}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
