"""The process group, the ``('data', 'model')`` mesh and the batch helpers,
the port of ``wfl_asr_tpu/parallel/mesh.py``.

The torch idiom is one process per GPU, launched by ``torchrun`` (or
``python -m torch.distributed.run``): a world on one node stands for the
JAX package's single host with many devices, a world across nodes for its
multi-host runs. So every guard the JAX package keys on
``jax.process_count()`` keys here on the node count (``WORLD_SIZE /
LOCAL_WORLD_SIZE``), and every guard it keys on ``len(jax.devices())`` on
the world size.

- :func:`maybe_initialize_distributed` joins the process group exactly once
  under a launcher: NCCL on the card, ``gloo`` when the CPU is asked for.
  It keeps the JAX module's error classes: a failed handshake propagates, a
  second init is benign, and a launch only hinted at by the environment
  (``SLURM_NTASKS``/``OMPI_COMM_WORLD_SIZE``/``PMI_SIZE`` without
  ``WORLD_SIZE``) degrades to one process with a warning when it cannot
  rendezvous.
- :func:`make_mesh` builds a :class:`Mesh`: a torch ``DeviceMesh`` with
  dims ``("data", "model")`` over the world, its process groups and this
  rank's coordinates.
- :func:`shard_batch` pads a batch's rows to a multiple of the data size
  with the ``pad_value_map`` fills (labels −100) and keeps this rank's
  contiguous block; :func:`replicate` broadcasts tensors from rank 0.
- The reductions that keep a sharded step equal to the unsharded one: the
  count under a mean (:meth:`Mesh.mean_count`), gradient averaging over
  the data group (:meth:`Mesh.average_grads`), and sums of host metrics
  (:meth:`Mesh.sum_over_data`). Each is the identity at a data size of 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

# Launchers whose world-size variable, without WORLD_SIZE, only hints at a
# multi-process launch: a failed rendezvous then degrades to one process.
_HINT_VARS = ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")
_HINT_RANKS = {"SLURM_NTASKS": "SLURM_PROCID",
               "OMPI_COMM_WORLD_SIZE": "OMPI_COMM_WORLD_RANK",
               "PMI_SIZE": "PMI_RANK"}

# How long a collective may wait for its peers before the group raises
DEFAULT_TIMEOUT_S = 1800

# The process group's backend when set ("gloo" puts several ranks on one
# card: NCCL refuses two ranks on the same device); else NCCL on the card,
# gloo on the CPU
BACKEND_VAR = "WFL_DIST_BACKEND"

_dist_initialized = False


def _int(env, key: str, default: int = 0) -> int:
    try:
        return int(env.get(key, default))
    except (TypeError, ValueError):
        return default


def _launch_signal(env):
    """None (one process) | "explicit" (a launcher's world: init failures
    propagate) | "heuristic" (a scheduler's hint: a failed rendezvous
    degrades to one process with a warning). ``torchrun`` sets
    ``TORCHELASTIC_RUN_ID``, so its world of one is a world too."""
    if "WORLD_SIZE" in env:
        if _int(env, "WORLD_SIZE", 1) > 1 or "TORCHELASTIC_RUN_ID" in env:
            return "explicit"
        return None
    if any(_int(env, key, 1) > 1 for key in _HINT_VARS):
        return "heuristic"
    return None


def _init_kwargs(env, signal: str, backend: str, timeout_s: float) -> dict:
    kwargs = {"backend": backend, "timeout": timedelta(seconds=timeout_s)}
    if signal == "heuristic":
        for key in _HINT_VARS:
            if _int(env, key, 1) > 1:
                kwargs["world_size"] = _int(env, key, 1)
                kwargs["rank"] = _int(env, _HINT_RANKS[key], 0)
                break
    return kwargs


def _default_initialize(**kwargs):
    dist.init_process_group(init_method="env://", **kwargs)


def maybe_initialize_distributed(env=None, _initialize=None,
                                 device="cuda",
                                 timeout_s: float = DEFAULT_TIMEOUT_S
                                 ) -> bool:
    """Join the process group iff the environment marks a launch of several
    processes (or ``torchrun``'s world of one), exactly once: NCCL when
    ``device`` is CUDA (each rank on ``cuda:LOCAL_RANK``, modulo the card
    count), ``gloo`` on the CPU, or the backend ``WFL_DIST_BACKEND`` names.
    No-op for a plain one-process run. Returns True when the group was
    joined by this call.

    ``env``/``_initialize`` are injectable for unit tests."""
    global _dist_initialized
    env = os.environ if env is None else env
    if _dist_initialized:
        return False
    signal = _launch_signal(env)
    if signal is None:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda and _initialize is None and torch.cuda.is_available():
        # more ranks than cards (a gloo world on one card) share the cards
        torch.cuda.set_device(_int(env, "LOCAL_RANK", 0)
                              % torch.cuda.device_count())
    backend = env.get(BACKEND_VAR) or ("nccl" if cuda else "gloo")
    init = _initialize if _initialize is not None else _default_initialize
    try:
        init(**_init_kwargs(env, signal, backend, timeout_s))
    except RuntimeError as e:
        # Only a double init is benign. A rendezvous or connection failure
        # must propagate: swallowing it would let N processes train as N
        # independent runs with no gradient sync.
        text = str(e)
        if "twice" not in text and "already initialized" not in text:
            raise
    except ValueError as e:
        if signal == "explicit":
            # the launcher set a world; one that cannot form is a
            # configuration error, not a reason to run unsynced
            raise
        print(f"[WARN] torch.distributed init skipped: {e}")
        _dist_initialized = True
        return False
    _dist_initialized = True
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def node_count(env=None) -> int:
    """``WORLD_SIZE / LOCAL_WORLD_SIZE`` of the launch (1 without one)."""
    env = os.environ if env is None else env
    world = world_size()
    local = _int(env, "LOCAL_WORLD_SIZE", world) or world
    return max(world // max(local, 1), 1)


@dataclass
class Mesh:
    """The ``("data", "model")`` mesh of a world: a torch ``DeviceMesh``
    (ranks laid out row-major, the model dim fastest, as the JAX package
    reshapes its devices), its process groups, and this rank's
    coordinates. A data rank's model group holds the ranks that see the
    same rows; a model rank's data group those that hold the same
    shards."""
    device_mesh: object
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    nodes: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_size, "model": self.model_size}

    @property
    def data_group(self):
        return self.device_mesh.get_group("data")

    @property
    def model_group(self):
        return self.device_mesh.get_group("model")

    @property
    def data_mesh(self):
        return self.device_mesh["data"]

    @property
    def model_mesh(self):
        return self.device_mesh["model"]

    @property
    def device(self) -> torch.device:
        return torch.device(self.device_mesh.device_type)

    # -- the reductions of the unsharded step --------------------------------

    def mean_count(self, count: torch.Tensor) -> torch.Tensor:
        """The count under a mean taken over the whole batch, as this rank's
        share: all-reduced over the data group, divided by its size. A
        rank's ``sum / mean_count(n)`` then averages over the data ranks
        (as DDP averages gradients) to the unsharded ``Σ sum / Σ n``. The
        count itself as it is at a data size of 1."""
        if self.data_size == 1:
            return count
        total = count.detach().to(torch.float32).clone()
        dist.all_reduce(total, group=self.data_group)
        return total.clamp_min(1) / self.data_size

    def sum_over_data(self, values) -> np.ndarray:
        """Sums of host metrics over the data group (float64 on the wire;
        the model group's ranks hold the same values and are not added)."""
        arr = np.asarray(values, np.float64)
        if self.data_size == 1:
            return arr
        t = torch.from_numpy(arr.copy()).to(self.device)
        dist.all_reduce(t, group=self.data_group)
        return t.cpu().numpy()

    def average_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Average every gradient over the data group, in place (the local
        shard of a sharded one); what DDP does, for parameters DDP does not
        take (DTensor shards, FSDP's replicated leaves)."""
        if self.data_size == 1:
            return
        for p in params:
            if p.grad is None:
                continue
            g = local_tensor(p.grad)
            dist.all_reduce(g, group=self.data_group)
            g.div_(self.data_size)

    def average_scalars(self, values: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Detached device scalars averaged over the data group (the
        logged loss of a step is the unsharded step's)."""
        if self.data_size == 1:
            return values
        keys = sorted(values)
        t = torch.stack([values[k].detach().float() for k in keys])
        dist.all_reduce(t, group=self.data_group)
        t = t / self.data_size
        return dict(zip(keys, t.unbind()))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable: every rank's loss
    depends on the sum, so its gradient is the sum of the ranks'
    gradients."""
    return _AllReduceSum.apply(x, group)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), else ``t``."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def make_mesh(model_parallel: int = 1, device=None,
              world: Optional[int] = None) -> Mesh:
    """The ``("data", "model")`` mesh over the initialized world: the world
    must divide by ``model_parallel`` (the JAX package's ``ValueError``).
    ``device``: the ranks' device type (CUDA unless "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size() if world is None else world
    model_parallel = int(model_parallel)
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch with torchrun)")
    kind = torch.device("cuda" if device is None else device).type
    dm = init_device_mesh(kind, (n // model_parallel, model_parallel),
                          mesh_dim_names=("data", "model"))
    r = dist.get_rank()
    return Mesh(dm, n // model_parallel, model_parallel, r // model_parallel,
                r % model_parallel, node_count())


def replicate(tensors: Dict[str, torch.Tensor], mesh: Optional[Mesh]
              ) -> Dict[str, torch.Tensor]:
    """Every tensor as rank 0 holds it, on every rank (a broadcast over the
    world, in place; ``mesh`` names the world it runs in)."""
    for t in tensors.values():
        dist.broadcast(t, src=0)
    return tensors


def shard_rows(n: int, mesh: Mesh):
    """(start, stop) of this data rank's contiguous block of ``n`` rows
    (``n`` a multiple of the data size)."""
    per = n // mesh.data_size
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def shard_batch(batch: Dict, mesh: Mesh, pad_value_map=None) -> Dict:
    """Each array field's leading (batch) axis padded to a multiple of the
    data size (with ``pad_value_map``'s fill for its key, else 0: the JAX
    package's labels −100 keep the CE unchanged) and cut to this data
    rank's contiguous block; other fields pass through."""
    out = {}
    for key, x in batch.items():
        if not isinstance(x, np.ndarray) or x.ndim == 0:
            out[key] = x
            continue
        rem = x.shape[0] % mesh.data_size
        if rem:
            fill = (pad_value_map or {}).get(key, 0)
            pad = np.full((mesh.data_size - rem,) + x.shape[1:], fill,
                          x.dtype)
            x = np.concatenate([x, pad], axis=0)
        lo, hi = shard_rows(x.shape[0], mesh)
        out[key] = x[lo:hi]
    return out


def shard_origin(mesh: Optional[Mesh], local_batch: int, first_head: int
                 ) -> tuple:
    """(b0, h0): the global index of an attention call's first row and
    first head on this rank (``flash_attention``'s ``origin``): the data
    rank's block of rows, and the first of this rank's heads."""
    if mesh is None:
        return 0, int(first_head)
    return mesh.data_rank * int(local_batch), int(first_head)
