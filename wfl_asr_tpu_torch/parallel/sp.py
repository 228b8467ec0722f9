"""Sequence parallelism over the mesh's ``model`` dim, the port of
``wfl_asr_tpu/parallel/sp.py``.

Between encoder layers the residual stream ``[B, T, H]`` is held as
``[B, T/mp, H]`` on each rank of a model group: its contiguous block of
time. A layer gathers the whole sequence on entry (the attention kernels
couple every position, so they get the gathered T) and keeps its own block
of the output. T = 1499 is odd: the sequence is zero-padded to a multiple
of mp before the split and the padding is stripped on the gather, as
GSPMD pads an uneven dimension, so the layers always see the true length.
The positional conv embedding (k = 128) runs before the first split, on
the whole sequence, and needs no halo.

Under tensor parallelism the gradient of a gathered sequence is the same
on every rank of the model group (the column-parallel projections reduce
their input's gradient there), so the gather's backward keeps its own
block, and the split's backward gathers the blocks.

Enabled by ``training.sequence_parallel: true`` (train) or
``model.sequence_parallel: true`` (serving), with ``model_parallel > 1``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def sp_active(mesh, sequence_parallel: bool) -> bool:
    """True iff the flag is set and a mesh with a model dim > 1 is live."""
    return (bool(sequence_parallel) and mesh is not None
            and mesh.model_size > 1)


def _padded(t: int, mp: int) -> int:
    return -(-t // mp) * mp


def _gather_blocks(x: torch.Tensor, mesh) -> torch.Tensor:
    blocks = [torch.empty_like(x) for _ in range(mesh.model_size)]
    dist.all_gather(blocks, x.contiguous(), group=mesh.model_group)
    return torch.cat(blocks, dim=1)


def _own_block(x: torch.Tensor, mesh) -> torch.Tensor:
    per = x.shape[1] // mesh.model_size
    return x[:, mesh.model_rank * per:(mesh.model_rank + 1) * per] \
        .contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.t = mesh, x.shape[1]
        pad = _padded(x.shape[1], mesh.model_size) - x.shape[1]
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        return _own_block(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.mesh)[:, :ctx.t], None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, t):
        ctx.mesh = mesh
        return _gather_blocks(x, mesh)[:, :t]

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        pad = _padded(g.shape[1], mesh.model_size) - g.shape[1]
        if pad:
            g = F.pad(g, (0, 0) * (g.dim() - 2) + (0, pad))
        return _own_block(g, mesh), None, None


def shard_time(x: torch.Tensor, mesh) -> torch.Tensor:
    """``[B, T, ...]`` → this model rank's block ``[B, ⌈T/mp⌉, ...]`` of
    the zero-padded sequence."""
    return _Split.apply(x, mesh)


def gather_time(x: torch.Tensor, mesh, length: int) -> torch.Tensor:
    """The blocks of a model group back to ``[B, length, ...]``."""
    return _Gather.apply(x, mesh, int(length))
