"""Fully-sharded data parallelism over the mesh's ``data`` dim, the port of
``wfl_asr_tpu/parallel/fsdp.py``, on FSDP2's ``fully_shard``.

- :func:`fsdp_spec` keeps the JAX rule as a pure function: a parameter
  shards its largest dimension divisible by the data size (ties to the
  earliest axis); leaves under ``MIN_SHARD_SIZE`` elements, or with no
  such dimension, stay replicated.
- :func:`shard_params_fsdp` applies ``fully_shard`` to each encoder layer
  and at the root, placing each parameter by that rule through
  ``shard_placement_fn``. The replicated leaves are FSDP's
  ``ignored_params``: plain tensors on every rank whose gradients the train
  loop averages over the data group itself (``Mesh.average_grads``). The
  BiLSTM's weights are replicated too, whatever their size: on the card
  ``nn.LSTM`` moves them into a cuDNN buffer of its own
  (``flatten_parameters``), which FSDP's gathers do not refill, so a
  sharded LSTM would run its second step on its first step's weights.
  FSDP gathers a layer's shards on entry and reduce-scatters its gradients
  after its backward.
- :class:`FullTensorStep` runs any of the port's optimizers on sharded
  parameters (FSDP's, or tensor parallelism's) with the unsharded step's
  result: Prodigy's ``dot`` and ``d_denom`` and D-Adaptation's sums are
  sums over every parameter, and Lamb's and Lars's trust ratios,
  Fromage's and NovoGrad's norms, Adafactor's factored moments and SM3's
  per-axis accumulators are statistics over whole JAX leaves (a row block
  of the Conformer's packed ``in_proj`` may straddle two shards). So the
  step gathers each sharded parameter, its gradient and its optimizer
  state to full tensors, runs the optimizer's own step on them, and keeps
  each rank's shard of the new parameters and of every parameter-shaped
  state tensor; the rest of the state (counts, global scalars, factored
  rows and columns) is the same on every rank. The state rests sharded;
  the step holds the full tensors for its duration.
- :func:`full_state_dict` gathers the full parameters and buffers (a
  collective: every rank calls it), and :meth:`FullTensorStep.state_dict`
  the full optimizer state, so that rank 0 writes the canonical ``.pt``
  and sidecar a one-process run writes; a resume loads them into the
  unsharded model before it is sharded again, and
  :meth:`FullTensorStep.load_state_dict` shards the optimizer state.

Enabled by ``training.fsdp: true``; exclusive with model and pipeline
parallelism, and one node only (the JAX package's ``ValueError`` s).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set

import torch
from torch import nn

# Leaves smaller than this many elements replicate (the gather costs more
# than the memory saved; every matmul weight of the tagger is above it).
MIN_SHARD_SIZE = 16384


def fsdp_spec(shape, data_size: int, min_size: Optional[int] = None
              ) -> tuple:
    """The JAX rule: a tuple with "data" at the sharded dimension (the
    largest dimension divisible by ``data_size``, ties to the earliest
    axis), or () for a replicated leaf (small, or no such dimension)."""
    if min_size is None:
        min_size = MIN_SHARD_SIZE
    shape = tuple(int(d) for d in shape)
    size = 1
    for d in shape:
        size *= d
    if not shape or size < min_size:
        return ()
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % data_size == 0:
            spec = [None] * len(shape)
            spec[i] = "data"
            return tuple(spec)
    return ()


def replicated_params(model: nn.Module, data_size: int,
                      min_size: Optional[int] = None) -> List[nn.Parameter]:
    """The parameters :func:`fsdp_spec` leaves replicated, and every
    recurrent module's (see the module docstring), in the model's order."""
    rnn = {id(p) for m in model.modules() if isinstance(m, nn.RNNBase)
           for p in m.parameters()}
    return [p for p in model.parameters()
            if id(p) in rnn or fsdp_spec(p.shape, data_size, min_size) == ()]


def encoder_layers(model: nn.Module) -> List[nn.Module]:
    """The encoder's transformer layers (each one FSDP unit)."""
    enc = getattr(model, "encoder", None)
    if enc is None:
        return []
    if hasattr(enc, "encoder") and hasattr(enc.encoder, "layers"):
        return list(enc.encoder.layers)           # WavLM
    return list(getattr(enc, "layers", []))        # Whisper


def shard_params_fsdp(model: nn.Module, mesh,
                      min_size: Optional[int] = None) -> List[nn.Parameter]:
    """``fully_shard`` each encoder layer and the root of ``model`` over the
    mesh's data dim, in place, each parameter on :func:`fsdp_spec`'s
    dimension. Returns the replicated (ignored) parameters, in the model's
    order (every rank reduces their gradients in the same order)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    data_size = mesh.data_size
    replicated = replicated_params(model, data_size, min_size)

    def placement(p: nn.Parameter):
        return Shard(fsdp_spec(p.shape, data_size, min_size).index("data"))

    kwargs = dict(mesh=mesh.data_mesh, shard_placement_fn=placement,
                  ignored_params=set(replicated))
    for layer in encoder_layers(model):
        fully_shard(layer, **kwargs)
    fully_shard(model, **kwargs)
    return replicated


def _is_sharded(t) -> bool:
    """A DTensor parameter (sharded, or replicated as a row-parallel
    bias is): the wrapped optimizer takes plain tensors."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _gather_like(local: torch.Tensor, p) -> torch.Tensor:
    """A tensor laid out as the DTensor ``p``'s local shard, gathered."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride(),
                              run_check=False).full_tensor()


def _shard_like(full: torch.Tensor, p) -> torch.Tensor:
    """This rank's shard of a full tensor shaped as the DTensor ``p``."""
    from torch.distributed.tensor import Shard
    out = full
    for mesh_dim, place in enumerate(p.placements):
        if isinstance(place, Shard):
            n = p.device_mesh.size(mesh_dim)
            r = p.device_mesh.get_local_rank(mesh_dim)
            chunks = list(torch.chunk(out, n, dim=place.dim))
            while len(chunks) < n:
                shape = list(out.shape)
                shape[place.dim] = 0
                chunks.append(out.new_empty(shape))
            out = chunks[r]
    return out.clone(memory_format=torch.contiguous_format)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model`` as a full tensor, by its
    parameter name (a collective over sharded parameters: every rank
    calls it)."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = _full(p.detach())
    for name, b in model.named_buffers():
        out[name] = _full(b.detach())
    return out


class FullTensorStep:
    """An optimizer whose step on sharded (DTensor) parameters computes the
    unsharded step (see the module docstring). Plain parameters pass
    through untouched. Forwards ``param_groups``, ``zero_grad`` and the
    rest to the wrapped optimizer."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.inner = optimizer
        # per sharded parameter: the state keys held as shards
        self._sharded_keys: Dict[int, Set[str]] = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _sharded(self):
        return [p for g in self.inner.param_groups for p in g["params"]
                if _is_sharded(p)]

    @contextlib.contextmanager
    def _full_view(self, write_back: bool):
        """The wrapped optimizer over full plain tensors in place of the
        sharded parameters (their gradients and state gathered); on exit
        the shards of the new values are kept."""
        inner = self.inner
        sharded = self._sharded()
        full = {}
        for p in sharded:
            f = p.detach().full_tensor()
            if p.grad is not None:
                f.grad = _full(p.grad)
            st = inner.state.pop(p, None)
            if st:
                keys = self._sharded_keys.get(id(p), set())
                st = {k: (_gather_like(v, p) if k in keys else v)
                      for k, v in st.items()}
                inner.state[f] = st
            full[p] = f
        groups = [g["params"] for g in inner.param_groups]
        for g in inner.param_groups:
            g["params"] = [full.get(p, p) for p in g["params"]]
        blocks = getattr(inner, "leaf_blocks", None)
        if blocks:
            inner.leaf_blocks = {full.get(p, p): v for p, v in blocks.items()}
        try:
            yield
        finally:
            for g, ps in zip(inner.param_groups, groups):
                g["params"] = ps
            if blocks:
                inner.leaf_blocks = blocks
            with torch.no_grad():
                for p, f in full.items():
                    if write_back:
                        p.to_local().copy_(_shard_like(f, p))
                    st = inner.state.pop(f, None)
                    if not st:
                        continue
                    keys = {k for k, v in st.items()
                            if isinstance(v, torch.Tensor) and v.dim() > 0
                            and v.shape == p.shape}
                    self._sharded_keys[id(p)] = keys
                    inner.state[p] = {k: (_shard_like(v, p) if k in keys
                                          else v) for k, v in st.items()}

    @torch.no_grad()
    def step(self, closure=None):
        with self._full_view(write_back=True):
            return self.inner.step(closure)

    def state_dict(self) -> dict:
        """The wrapped optimizer's ``state_dict`` with full tensors (a
        collective: every rank calls it)."""
        with self._full_view(write_back=False):
            sd = self.inner.state_dict()
            # detach the full tensors from the view that is about to close
            return {"state": {k: dict(v) for k, v in sd["state"].items()},
                    "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a full (one-process) optimizer state and keep this rank's
        shards."""
        with self._full_view(write_back=False):
            self.inner.load_state_dict(state_dict)
