"""Tensor parallelism over the mesh's ``model`` dim, the port of
``wfl_asr_tpu/parallel/tp.py`` (Megatron-style).

The placements are ``tp._spec_for``'s, by the JAX package's names of the
parameters (:func:`tp_spec`, in torch's ``[out, in]`` layout):

- column-parallel (output dim sharded): the attention q/k/v projections and
  the FFN input projections (WavLM ``intermediate_dense``, Whisper ``fc1``,
  the Conformer FF modules' ``net.1``), weight and bias;
- row-parallel (input dim sharded): the attention output projections and
  the FFN output projections; their bias is replicated and added once,
  after the sum over the model group;
- WavLM's bucket table ``rel_attn_embed`` and the gate constant
  ``gru_rel_pos_const`` sharded on heads, so the position bias
  ``[H/mp, T, T]`` and the gate ``[B, H/mp, T]`` are built locally;
- everything else replicated.

:func:`shard_params_tp` places them as DTensors with
``parallelize_module`` (``ColwiseParallel``/``RowwiseParallel``) and
``distribute_tensor``. The models' functional layers call no module's
``forward``, so the styles' input and output hooks never run; the layers
take each weight's local shard (``models.layers.linear``) and put in the
collectives themselves: :func:`copy_to_model` before a column-parallel
product (identity, its gradient summed over the model group) and
:func:`reduce_from_model` after a row-parallel one (the sum, its gradient
the identity). The attention modules then work on ``H / mp`` local heads
through the same hand-written kernels.

One placement differs from JAX's, where a DTensor cannot express it: the
Conformer's packed ``in_proj_weight``/``in_proj_bias`` ``[3E, E]`` stacks
JAX's q, k and v leaves, and a rank must hold whole heads of each. It stays
replicated; each rank computes with its heads' rows of each block and the
gradient is summed over the model group (:func:`copy_to_model` on the
weight), so every rank holds the full, equal gradient. Results are the
same.

Heads and FFN widths must divide the model dim (:func:`check_divisible`).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# The JAX package's parent names whose "w"/"b" leaves shard column-wise
# (output dim) and row-wise (input dim).
_COL = {"q", "k", "v", "ff_in", "fc1", "in"}
_ROW = {"out", "attn_out", "ff_out", "fc2"}

# The port's module paths under the JAX package's parent names.
_JAX_PARENT = (
    (re.compile(r"\.attention\.([qkv])_proj$"), None),
    (re.compile(r"\.self_attn\.([qkv])_proj$"), None),
    (re.compile(r"\.attention\.out_proj$"), "out"),
    (re.compile(r"^encoder\.layers\.\d+\.self_attn\.out_proj$"), "out"),
    (re.compile(r"^conformer_layers\.\d+\.self_attn\.out_proj$"),
     "attn_out"),
    (re.compile(r"\.feed_forward\.intermediate_dense$"), "ff_in"),
    (re.compile(r"\.feed_forward\.output_dense$"), "ff_out"),
    (re.compile(r"\.fc1$"), "ff_in"),
    (re.compile(r"\.fc2$"), "ff_out"),
    (re.compile(r"\.ff[12]\.net\.1$"), "in"),
    (re.compile(r"\.ff[12]\.net\.4$"), "out"),
)


def jax_parent(module_path: str) -> Optional[str]:
    """The JAX package's parent name for a port module path, or None."""
    for pattern, name in _JAX_PARENT:
        m = pattern.search(module_path)
        if m:
            return name if name is not None else m.group(1)
    return None


def tp_spec(param_name: str, ndim: int) -> Tuple:
    """``tp._spec_for``'s placement of a port parameter, in torch's layout:
    a tuple with "model" at the sharded dim, or () for replicated."""
    module_path, _, leaf = param_name.rpartition(".")
    if leaf == "gru_rel_pos_const":
        return (None, "model", None, None)[:ndim]       # [1, H, 1, 1]
    if module_path.endswith("rel_attn_embed") and leaf == "weight":
        return (None, "model")                          # [buckets, H]
    parent = jax_parent(module_path)
    if parent in _COL:
        if leaf == "weight" and ndim == 2:
            return ("model", None)
        if leaf == "bias" and ndim == 1:
            return ("model",)
    if parent in _ROW and leaf == "weight" and ndim == 2:
        return (None, "model")
    return ()


def check_divisible(arch, model_parallel: int) -> None:
    """The JAX package's ``ValueError`` when heads or FFN widths do not
    divide the model dim."""
    mp = int(model_parallel)
    widths = {"conformer_heads": arch.conformer_heads,
              "conformer FF width": arch.hidden_size
              * arch.conformer_ff_expansion}
    if arch.wavlm is not None:
        widths.update({"wavlm num_heads": arch.wavlm.num_heads,
                       "wavlm intermediate_size":
                       arch.wavlm.intermediate_size})
    if arch.whisper is not None:
        widths.update({"whisper num_heads": arch.whisper.num_heads,
                       "whisper ffn_dim": arch.whisper.ffn_dim})
    for what, n in widths.items():
        if n % mp:
            raise ValueError(f"{what}={n} not divisible by "
                             f"model_parallel={mp}")


# ---------------------------------------------------------------------------
# The collectives of the model group
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; its gradient is summed over ``group`` (Megatron's f)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; its gradient is the identity (Megatron's
    g)."""
    return _ReduceFromModel.apply(x, group)


def model_dim_shard(t: torch.Tensor):
    """(dim, group) of a DTensor sharded on a mesh's ``model`` dim, else
    None."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    if mesh.mesh_dim_names != ("model",):
        return None
    place = t.placements[0]
    if not isinstance(place, Shard):
        return None
    return place.dim, mesh.get_group()


# ---------------------------------------------------------------------------
# Placing the parameters
# ---------------------------------------------------------------------------

def attach_mesh(model: nn.Module, mesh) -> None:
    """Give every module that runs attention or a Conformer block the mesh
    (local heads, dropout-seed origins, the BatchNorm's data group); alone,
    for data parallelism, which shards no parameter."""
    from ..models.heads import ConformerBlock, PackedSelfAttention
    from ..models.wavlm import WavLMEncoder
    from ..models.whisper import WhisperEncoder
    for mod in model.modules():
        if isinstance(mod, (WavLMEncoder, WhisperEncoder, ConformerBlock,
                            PackedSelfAttention)):
            mod.mesh = mesh


def shard_params_tp(model: nn.Module, mesh) -> nn.Module:
    """Place ``model``'s parameters with :func:`tp_spec` on the mesh's
    model dim (replicated over data), in place; returns it."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    check_divisible(model.arch, mesh.model_size)
    sub = mesh.model_mesh
    for path, mod in list(model.named_modules()):
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            spec = tp_spec(f"{path}.weight", 2)
            if spec == ("model", None):         # a Linear's output dim
                parallelize_module(mod, sub, ColwiseParallel())
            elif spec == (None, "model"):       # input dim; a table's heads
                parallelize_module(mod, sub, RowwiseParallel()
                                   if isinstance(mod, nn.Linear)
                                   else ColwiseParallel())
        const = getattr(mod, "gru_rel_pos_const", None)
        if isinstance(const, nn.Parameter):
            dim = tp_spec(f"{path}.gru_rel_pos_const", const.dim()).index(
                "model")
            mod.gru_rel_pos_const = nn.Parameter(distribute_tensor(
                const.data, sub, [Shard(dim)]),
                requires_grad=const.requires_grad)
    attach_mesh(model, mesh)
    return model
