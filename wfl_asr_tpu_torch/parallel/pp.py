"""Pipeline parallelism (GPipe) of the encoder's transformer layers, the
port of ``wfl_asr_tpu/parallel/pp.py``.

The JAX package runs the schedule as one program (``shard_map`` over a
``('data', 'stage')`` mesh, a tick scan handing activations on with
``ppermute``, one masked ``psum``). The torch idiom is one process a rank,
so here every rank runs its own part of the schedule by hand:

- :func:`make_pp_mesh` lays the world out as ``(data, stage)``, the stage
  dim fastest (the ranks of one pipeline are adjacent), with the JAX
  function's errors; a :class:`PipelineMesh` holds this rank's stage and
  data groups and the ranks before and after it in its pipeline.
- :func:`stage_layers`: a stage holds ``L/S`` contiguous layers
  (``place_stacked``'s error when S does not divide L); :func:`pp_spec` is
  ``pp_shardings``' rule: parameters of the encoder's layers are
  stage-local, everything else is replicated (WavLM's bucket table, which
  HF keeps on layer 0, is the JAX package's top-level
  ``rel_attn_embed``: replicated).
- :func:`shard_params_pp` cuts a model in place to this stage's layers.
  The full stack exists once across a pipeline group; the layer modules
  keep their global indices, so parameter names are the one-process
  model's.
- :func:`gpipe_apply` runs M microbatches forward through the stages by
  point-to-point send/recv of ``[mb, T, H]``; ``per_row`` operands are
  sliced per microbatch, ``shared`` ones passed whole; the last stage's
  output is broadcast over the stage group (the masked ``psum``). Its
  backward (a ``torch.autograd.Function``) takes each microbatch's output
  gradient on the last stage and sends input gradients upstream; the
  stage's parameter gradients accumulate in place, the shared operands'
  gradients are summed over the stage group, and the pipeline input's
  gradient reaches every stage, so replicated parameters before the stack
  get equal gradients everywhere (the transpose of the JAX ``psum``).
  A stage runs its layers exactly M times a pass: no warm-up or drain
  ticks.
- Transport: device tensors over NCCL; host buffers over ``gloo`` (its
  send/recv take CPU tensors), the layers still on the rank's device.

The optimizers' statistics over a stacked leaf (:class:`StackedLeaves`)
and the gather of a stage-local model for its checkpoint live here too.

    torchrun --nproc_per_node S -m wfl_asr_tpu_torch.train CONFIG  # with
    # training.pipeline_parallel: S
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh, node_count, world_size

# a parameter of the encoder's layer stack (WavLM nests HF's encoder)
_LAYER = re.compile(r"^encoder\.(?:encoder\.)?layers\.(\d+)\.")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclass
class PipelineMesh(Mesh):
    """The ``("data", "stage")`` mesh of a world: this rank's data and stage
    coordinates, its data group (the ranks of the same stage) and stage
    group (its pipeline), and the global ranks of its pipeline in stage
    order. Its model dim is 1, so the layers run every head."""
    stage_size: int = 1
    stage_rank: int = 0
    groups: Dict = field(default_factory=dict)
    pipeline: Sequence[int] = ()
    device_type: str = "cuda"

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_size, "stage": self.stage_size}

    @property
    def data_group(self):
        return self.groups["data"]

    @property
    def stage_group(self):
        return self.groups["stage"]

    @property
    def device(self) -> torch.device:
        return torch.device(self.device_type)

    @property
    def first(self) -> bool:
        return self.stage_rank == 0

    @property
    def last(self) -> bool:
        return self.stage_rank == self.stage_size - 1

    @property
    def prev_rank(self) -> int:
        return self.pipeline[self.stage_rank - 1]

    @property
    def next_rank(self) -> int:
        return self.pipeline[self.stage_rank + 1]

    @property
    def host_transport(self) -> bool:
        """``gloo``: collectives and send/recv go through host buffers."""
        return dist.get_backend(self.stage_group) == "gloo"

    @property
    def transport(self) -> str:
        return ("gloo via host buffers" if self.host_transport
                else f"{dist.get_backend(self.stage_group)} on the device")


def make_pp_mesh(num_stages: int, device=None,
                 world: Optional[int] = None) -> PipelineMesh:
    """The ``("data", "stage")`` mesh over the initialized world: stage the
    trailing dim (a pipeline's ranks adjacent), data the pipelines. The JAX
    package's ``ValueError``s: fewer than 2 stages, a world that
    ``num_stages`` does not divide. Every rank creates every group, in the
    same order."""
    n = world_size() if world is None else world
    num_stages = int(num_stages)
    if num_stages < 2:
        raise ValueError(f"num_stages must be >= 2, got {num_stages}")
    if n % num_stages != 0:
        raise ValueError(f"{n} devices not divisible by num_stages="
                         f"{num_stages}")
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs an initialized process group "
                           "(launch with torchrun)")
    data = n // num_stages
    r = dist.get_rank()
    groups = {}
    for d in range(data):
        ranks = list(range(d * num_stages, (d + 1) * num_stages))
        g = dist.new_group(ranks)
        if r in ranks:
            groups["stage"], pipeline = g, ranks
    for s in range(num_stages):
        ranks = list(range(s, n, num_stages))
        g = dist.new_group(ranks)
        if r in ranks:
            groups["data"] = g
    kind = torch.device("cuda" if device is None else device).type
    return PipelineMesh(None, data, 1, r // num_stages, 0, node_count(),
                        stage_size=num_stages, stage_rank=r % num_stages,
                        groups=groups, pipeline=pipeline, device_type=kind)


def microbatch_count(requested: int, rows: int) -> int:
    """The JAX encoders' clamp: ``gcd(requested or rows, rows)`` (at least
    1), so that one setting serves the training batch and the smaller
    validation batches."""
    m = int(requested) or rows
    return max(1, math.gcd(m, rows))


# ---------------------------------------------------------------------------
# The stage's layers
# ---------------------------------------------------------------------------

def stage_layers(n_layers: int, mesh: PipelineMesh) -> range:
    """The global indices of this stage's ``L/S`` contiguous layers."""
    s = mesh.stage_size
    if n_layers % s != 0:
        raise ValueError(f"{n_layers} layers not divisible by {s} pipeline "
                         f"stages")
    per = n_layers // s
    return range(mesh.stage_rank * per, (mesh.stage_rank + 1) * per)


def pp_spec(name: str) -> str:
    """``pp_shardings``' rule by parameter name: "stage" for a parameter of
    the encoder's layers (stage-local), else "replicated". WavLM's bucket
    table sits on layer 0 in HF's layout but is the JAX tree's top-level
    ``rel_attn_embed``: replicated."""
    if _LAYER.match(name) and "rel_attn_embed" not in name:
        return "stage"
    return "replicated"


def stacked_key(name: str) -> str:
    """A layer parameter's name with its layer index taken out: the key of
    the JAX package's stacked ``[L, ...]`` leaf it belongs to."""
    return _LAYER.sub(lambda m: m.group(0).replace(m.group(1), "*"), name, 1)


class StageLayers(nn.Module):
    """The stage's layers under their global indices (``layers.6`` stays
    ``layers.6`` on the second of two stages of 12 layers), iterated in
    order; ``stub`` modules (WavLM's bucket table holder on the stages
    without layer 0) are registered but not run."""

    def __init__(self, local: Dict[int, nn.Module],
                 stubs: Optional[Dict[int, nn.Module]] = None):
        super().__init__()
        merged = dict(stubs or {})
        merged.update(local)
        for i in sorted(merged):
            self.add_module(str(i), merged[i])
        self.indices = sorted(local)

    def __iter__(self):
        return iter(self._modules[str(i)] for i in self.indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]


@dataclass
class Pipeline:
    """What an encoder's pipelined branch needs: the mesh, the microbatch
    setting (0: one row a microbatch), the stage's global layer indices and
    the stack's depth."""
    mesh: PipelineMesh
    microbatches: int
    local: Sequence[int]
    num_layers: int


def _layer_owner(encoder: nn.Module) -> nn.Module:
    """The module holding the encoder's ``layers`` (WavLM's nested HF
    encoder, Whisper's encoder itself)."""
    inner = getattr(encoder, "encoder", None)
    return inner if inner is not None and hasattr(inner, "layers") \
        else encoder


def shard_params_pp(model: nn.Module, mesh: PipelineMesh,
                    microbatches: int = 0) -> nn.Module:
    """Cut ``model`` in place to this stage's layers (the others are
    dropped, so only this stage's parameters stay on its device), attach the
    mesh for the heads (BatchNorm over the data group, dropout origins) and
    the :class:`Pipeline` to the encoder. Returns the model."""
    from .tp import attach_mesh
    owner = _layer_owner(model.encoder)
    layers = owner.layers
    n = len(layers)
    local = stage_layers(n, mesh)
    stubs = {}
    first = layers[0]
    if 0 not in local and hasattr(getattr(first, "attention", None),
                                  "rel_attn_embed"):
        holder = nn.Module()
        holder.attention = nn.Module()
        holder.attention.rel_attn_embed = first.attention.rel_attn_embed
        stubs[0] = holder
    owner.layers = StageLayers({i: layers[i] for i in local}, stubs)
    attach_mesh(model, mesh)
    model.encoder.pipeline = Pipeline(mesh, int(microbatches), list(local), n)
    return model


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _send(t: torch.Tensor, dst: int, mesh: PipelineMesh) -> None:
    t = t.detach().contiguous()
    dist.send(t.cpu() if mesh.host_transport else t, dst)


def _recv(like: torch.Tensor, src: int, mesh: PipelineMesh) -> torch.Tensor:
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if mesh.host_transport else like.device)
    dist.recv(buf, src)
    return buf.to(like.device)


def _on_group(t: torch.Tensor, mesh: PipelineMesh, op: Callable) -> None:
    """``op(tensor)`` (a collective over the stage group) on ``t`` in place,
    through a host copy over ``gloo``."""
    if mesh.host_transport and t.device.type != "cpu":
        host = t.detach().cpu()
        op(host)
        t.copy_(host)
    else:
        op(t)


def broadcast_from_last(t: torch.Tensor, mesh: PipelineMesh) -> None:
    src = mesh.pipeline[-1]
    _on_group(t, mesh, lambda x: dist.broadcast(x, src,
                                                group=mesh.stage_group))


def sum_over_stages(t: torch.Tensor, mesh: PipelineMesh) -> None:
    _on_group(t, mesh, lambda x: dist.all_reduce(x, group=mesh.stage_group))


def max_over_stages(t: torch.Tensor, mesh: PipelineMesh) -> None:
    _on_group(t, mesh, lambda x: dist.all_reduce(
        x, op=dist.ReduceOp.MAX, group=mesh.stage_group))


def sync_replicas(tensors: Sequence[torch.Tensor],
                  mesh: PipelineMesh) -> None:
    """Every tensor as the pipeline's first stage holds it, on every stage
    (one flat broadcast): the replicated parameters' gradients, so that
    the replicas stay equal bit for bit whatever the card's reduction
    orders."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    src = mesh.pipeline[0]
    _on_group(flat, mesh, lambda x: dist.broadcast(x, src,
                                                   group=mesh.stage_group))
    at = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def _slices(n: int, m: int):
    mb = n // m
    return [slice(i * mb, (i + 1) * mb) for i in range(m)]


def _forward(run, x, mesh, m, per_row, shared, keep_graph: bool):
    """The stage's forward over the microbatches: (output on every stage,
    [(input, output)] of this stage's microbatches when ``keep_graph``)."""
    saved = []
    outs = []
    for i, rows in enumerate(_slices(x.shape[0], m)):
        if mesh.first:
            h = x[rows].detach()
        else:
            h = _recv(x[rows], mesh.prev_rank, mesh)
        if keep_graph:
            h.requires_grad_(True)
        y = run(h, [r[rows] for r in per_row], shared, i)
        if not mesh.last:
            _send(y, mesh.next_rank, mesh)
        if keep_graph:
            saved.append((h, y))
        if mesh.last:
            outs.append(y.detach())
    out = torch.cat(outs) if mesh.last else torch.empty(
        x.shape, dtype=x.dtype, device=x.device)       # contiguous
    broadcast_from_last(out, mesh)
    return out, saved


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, mesh, m, per_row, anchor, x, *shared):
        inputs = [s.detach().requires_grad_(s.requires_grad) for s in shared]
        with torch.enable_grad():
            out, saved = _forward(run, x, mesh, m, per_row, inputs, True)
        ctx.mesh, ctx.m, ctx.saved, ctx.inputs = mesh, m, saved, inputs
        ctx.x_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, gy):
        mesh, saved = ctx.mesh, ctx.saved
        gx = gy.new_zeros(ctx.x_shape)
        for (h, y), rows in zip(saved, _slices(ctx.x_shape[0], ctx.m)):
            if mesh.last:
                g = gy[rows]
            else:
                g = _recv(y, mesh.next_rank, mesh)
            torch.autograd.backward(y, g)
            gh = h.grad if h.grad is not None else torch.zeros_like(h)
            if mesh.first:
                gx[rows] = gh
            else:
                _send(gh, mesh.prev_rank, mesh)
        ctx.saved = None
        # the input's gradient on every stage (only the first has one)
        sum_over_stages(gx, mesh)
        grads = []
        for s in ctx.inputs:
            if s.requires_grad:
                g = s.grad if s.grad is not None else torch.zeros_like(s)
                sum_over_stages(g, mesh)
                grads.append(g)
            else:
                grads.append(None)
        return (None, None, None, None, None, gx, *grads)


def gpipe_apply(run: Callable, x: torch.Tensor, mesh: PipelineMesh,
                microbatches: int, per_row: Sequence[torch.Tensor] = (),
                shared: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The pipelined ``for layer in all layers: x = layer(x)``.

    ``run(h, rows, shared, i)`` applies this stage's layers to microbatch
    ``i`` (``h`` [mb, T, H]; ``rows`` the ``per_row`` operands' rows of
    that microbatch; ``shared`` the shared operands, whole). ``x`` [B, T,
    H] (B divisible by ``microbatches``) is read on the first stage only.
    Returns [B, T, H] on every stage of the pipeline. Differentiable in
    ``x`` and ``shared`` and in the stage's parameters when grad is on;
    every stage must call it, and its backward, in the same order."""
    m = int(microbatches)
    b = x.shape[0]
    if m < 1 or b % m:
        raise ValueError(f"batch {b} not divisible by microbatches={m}")
    per_row = list(per_row)
    shared = list(shared)
    if torch.is_grad_enabled():
        # the anchor makes the output require grad whatever ``x`` does, so
        # that the backward reaches the stage's parameters
        anchor = torch.empty(0, device=x.device, requires_grad=True)
        return _GPipe.apply(run, mesh, m, per_row, anchor, x, *shared)
    out, _ = _forward(run, x, mesh, m, per_row, shared, False)
    return out


def replay_draws(pipe: Pipeline, generator, layerdrop: float,
                 layer_draws: Callable, device) -> Dict[int, tuple]:
    """Every layer's whole-batch draws from the shared stream, in the
    one-process loop's order (the LayerDrop draw, then the layer's own:
    ``layer_draws(generator)`` makes them), so that every stage leaves the
    stream where one process would. Returns, for this stage's layers,
    (the skip flag or None, the stream's state at the layer's own draws)."""
    from ..models.layers import shared_generator
    stream = shared_generator(generator)
    out = {}
    for i in range(pipe.num_layers):
        skip = (torch.rand((), generator=stream, device=device) < layerdrop
                ) if layerdrop > 0.0 else None
        state = stream.get_state()
        layer_draws(generator)
        if i in pipe.local:
            out[i] = (skip, state)
    return out


def pipelined_layers(encoder: nn.Module, x: torch.Tensor, call: Callable,
                     generator=None, remat: bool = False,
                     per_row: Sequence[torch.Tensor] = (),
                     shared: Sequence[torch.Tensor] = (),
                     layer_draws: Optional[Callable] = None) -> torch.Tensor:
    """An encoder's layer loop through the pipeline (the JAX encoders'
    stacked-layer branch): ``call(layer, h, rows, shared, generator,
    row0)`` runs one layer on a microbatch whose first row is global row
    ``row0``. In training, each layer's LayerDrop flag and its whole-batch
    draws (strict-dropout seeds) are replayed from the shared stream as one
    process draws them, the same for every microbatch, so a skip is
    whole-batch and a seed's mask positional; element-wise dropout draws
    from the local stream, per (layer, microbatch). ``remat``: each layer
    under ``layers.checkpointed``."""
    from ..models.layers import Generators, checkpointed, local_generator
    pipe = encoder.pipeline
    mesh = pipe.mesh
    draws = {}
    if encoder.training and generator is not None:
        layerdrop = float(getattr(encoder.arch, "layerdrop", 0.0))
        draws = replay_draws(pipe, generator, layerdrop,
                             layer_draws or (lambda g: None), x.device)
        private = torch.Generator(device=x.device)
    m = microbatch_count(pipe.microbatches, x.shape[0])
    origin = mesh.data_rank * x.shape[0]
    stage = list(zip(pipe.local, _layer_owner(encoder).layers))

    def run(h, rows, shr, i):
        row0 = origin + i * h.shape[0]
        for idx, layer in stage:
            skip, gen = None, None
            if idx in draws:
                skip, state = draws[idx]
                private.set_state(state)
                gen = Generators(local_generator(generator), private)

            def one(h_, g_, layer=layer):
                return call(layer, h_, rows, shr, g_, row0)

            y = checkpointed(one, gen, h, layer=idx) if remat \
                else one(h, gen)
            h = torch.where(skip, h, y) if skip is not None else y
        return h

    return gpipe_apply(run, x, mesh, m, per_row, shared)


# ---------------------------------------------------------------------------
# Statistics over stacked leaves (the optimizers)
# ---------------------------------------------------------------------------

class StackedLeaves:
    """The JAX package's stacked ``[L, ...]`` leaves of a PP run, as the
    optimizers see them: each stage-local parameter belongs to the leaf of
    its :func:`stacked_key`, which spans every stage; a statistic over such
    a leaf reduces the stage's part over the stage group. ``num_layers``:
    L."""

    def __init__(self, named: Dict[str, torch.Tensor], mesh: PipelineMesh,
                 num_layers: int):
        self.mesh = mesh
        self.num_layers = int(num_layers)
        self.key: Dict[torch.Tensor, str] = {
            p: stacked_key(name) for name, p in named.items()
            if pp_spec(name) == "stage"}

    def __contains__(self, p) -> bool:
        return p in self.key

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the stage group."""
        out = t.clone()
        max_over_stages(out, self.mesh)
        return out

    def combine(self, owners: Sequence, values: torch.Tensor
                ) -> torch.Tensor:
        """``values`` [n], one per leaf view, ``owners`` the parameter of
        each view (a stacked parameter is one view): summed per stacked
        leaf over this stage's views and over the stage group, so each
        stacked view gets its leaf's total and the others keep their own
        value. The keys come in the same order on every stage (each stage
        holds the same names for its own layers)."""
        keys = {}
        idx = []
        for p in owners:
            k = self.key.get(p)
            if k is None:
                idx.append(-1)
            else:
                idx.append(keys.setdefault(k, len(keys)))
        if not keys:
            return values
        index = torch.tensor(idx, device=values.device)
        stacked = index >= 0
        totals = values.new_zeros(len(keys)).index_add_(
            0, index[stacked], values[stacked])
        sum_over_stages(totals, self.mesh)
        return torch.where(stacked, totals[index.clamp_min(0)], values)

    def split_sums(self, params: Sequence, values: torch.Tensor
                   ) -> torch.Tensor:
        """Σ ``values`` (one per parameter) with the stage-local ones summed
        over the stage group and the replicated ones counted once: a global
        sum over the JAX tree's leaves."""
        mask = torch.tensor([p in self.key for p in params],
                            device=values.device)
        local = torch.where(mask, values, torch.zeros_like(values)).sum()
        sum_over_stages(local, self.mesh)
        return local + torch.where(mask, torch.zeros_like(values),
                                   values).sum()


# ---------------------------------------------------------------------------
# The canonical checkpoint of a stage-local model
# ---------------------------------------------------------------------------

def gather_state_dict(model: nn.Module, mesh: PipelineMesh
                      ) -> Dict[str, torch.Tensor]:
    """The one-process model's state_dict on the CPU, from the stages of
    this rank's pipeline (every stage of it calls this)."""
    mine = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    parts = [None] * mesh.stage_size
    dist.all_gather_object(parts, mine, group=mesh.stage_group)
    full = {}
    for part in parts:
        full.update(part)
    return full


def gather_optimizer_state(optimizer: torch.optim.Optimizer,
                           names: Dict[torch.Tensor, str],
                           order: Sequence[str], mesh: PipelineMesh
                           ) -> dict:
    """The ``state_dict`` of a one-process optimizer over the parameters
    named in ``order`` (the full model's, in its order), from the stages'
    optimizers; ``names``: this stage's parameter → name."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu()
        if isinstance(v, (list, tuple)):
            return type(v)(host(x) for x in v)
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v

    mine = {names[p]: host(st) for p, st in optimizer.state.items()}
    parts = [None] * mesh.stage_size
    dist.all_gather_object(parts, mine, group=mesh.stage_group)
    by_name = {}
    for part in parts:
        by_name.update(part)
    (group,) = optimizer.param_groups
    entry = {k: v for k, v in group.items() if k != "params"}
    entry["params"] = list(range(len(order)))
    state = {i: by_name[n] for i, n in enumerate(order) if n in by_name}
    return {"state": state, "param_groups": [entry]}


def stage_optimizer_state(full_state: dict, order: Sequence[str],
                          local: Sequence[str]) -> dict:
    """A one-process optimizer's ``state_dict`` (over the names ``order``)
    cut to a stage's optimizer over the names ``local``."""
    at = {n: i for i, n in enumerate(order)}
    groups = []
    for g in full_state["param_groups"]:
        entry = dict(g)
        entry["params"] = list(range(len(local)))
        groups.append(entry)
    state = {j: full_state["state"][at[n]] for j, n in enumerate(local)
             if at[n] in full_state["state"]}
    return {"state": state, "param_groups": groups}
