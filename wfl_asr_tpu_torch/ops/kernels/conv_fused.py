"""Fused stride-2 conv chain (WavLM feature encoder layers 1-6), the port of
``wfl_asr_tpu/ops/pallas/conv_fused.py:fused_conv_chain``.

A chain of ≤ 3 VALID Conv1d layers (C → C, k ∈ {2, 3}, stride 2, no
bias), exact GELU after each, on channels-last [B, T, C]; optionally the
layer-0 GroupNorm application ``gelu(((x − mean)·inv)·scale + bias)`` on
the input. On a CUDA tensor one launch of ``csrc/conv_fused.cu`` runs the
whole chain, keeping the intermediate layers in shared memory; on a CPU
tensor the plain twin :func:`conv_chain_plain` (``F.conv1d`` + GELU) runs.
Nothing falls back. Inference only.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

MAX_CHAIN = 3
MAX_TILE = 16
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
BF16_WARPS = 16      # warps of a bf16 block (Threads<bf16> in the source)

# Launches of the CUDA kernel, per chain (keyed by its kernel sizes).
launches: Counter = Counter()


def chain_out_len(t_in: int, ks: Sequence[int]) -> int:
    t = t_in
    for k in ks:
        t = (t - k) // 2 + 1
    return t


def stage_rows(tile: int, ks: Sequence[int]) -> list:
    """Rows of every stage for ``tile`` output rows, composed backwards
    (n_in = 2·(n_out − 1) + k): [input rows, layer-1 rows, ..., tile]."""
    rows = [tile]
    for k in reversed(ks):
        rows.append(2 * (rows[-1] - 1) + k)
    return rows[::-1]


def smem_bytes(tile: int, ks: Sequence[int], c: int, esize: int) -> int:
    """Shared memory of one block (``plan`` in csrc/conv_fused.cu): the
    staged rows of every layer's input. bf16 (the tensor-core path) pads
    each stage to whole 16-row tiles and an even row count, pitches rows at
    C + 16, and adds 1 KB of f32 scratch for each of its warps."""
    rows = stage_rows(tile, ks)
    total = 0
    for layer, k in enumerate(ks):
        alloc = rows[layer]
        if esize == 2:
            padded_out = -(-rows[layer + 1] // 16) * 16
            alloc = max(alloc, 2 * (padded_out - 1) + k)
            alloc += alloc % 2
        total += alloc
    if esize == 2:
        return total * (c + 16) * esize + BF16_WARPS * 256 * 4
    return total * c * esize


def pick_tile(ks: Sequence[int], c: int, esize: int) -> int:
    """Largest tile ≤ MAX_TILE whose staged rows fit in shared memory."""
    for tile in range(MAX_TILE, 0, -1):
        if smem_bytes(tile, ks, c, esize) <= SMEM_LIMIT:
            return tile
    raise ValueError(f"conv chain {tuple(ks)} at C={c} does not fit in "
                     f"shared memory")


def pack_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype,
                 device=None) -> list:
    """Torch-layout [C_out, C_in, k] weights → the kernel's [k, C_in, C_out]
    at the activation dtype. Done once per dtype by the owning module."""
    return [w.detach().to(device=device, dtype=dtype).permute(2, 1, 0)
            .contiguous() for w in weights]


def _check(x, weights):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if not 1 <= len(weights) <= MAX_CHAIN:
        raise ValueError(f"a chain has 1..{MAX_CHAIN} layers")
    for w in weights:
        if tuple(w.shape[:2]) != (c, c):
            raise ValueError("fused chain requires C_in == C_out == C")
        if w.shape[2] not in (2, 3):
            raise ValueError("fused chain supports k in {2, 3} (stride 2)")
    if chain_out_len(x.shape[1], [w.shape[2] for w in weights]) <= 0:
        raise ValueError("input too short for the conv chain")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {x.dtype} unsupported (float32, bfloat16)")
    if x.dtype == torch.bfloat16 and c % 16:
        raise ValueError("bf16 conv chains need C % 16 == 0 (tensor-core "
                         "tiles)")
    if c % 4:
        raise ValueError("conv chains need C % 4 == 0 (16-byte row loads)")


def conv_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     input_norm=None) -> torch.Tensor:
    """Plain PyTorch twin: ``F.conv1d`` + exact GELU per layer in f32, each
    layer's output rounded to the activation dtype as the kernel does."""
    dt = x.dtype
    h = x.float()
    if input_norm is not None:
        mean, inv, scale, bias = (t.float() for t in input_norm)
        h = (h - mean[:, None, :]) * inv[:, None, :]
        h = F.gelu(h * scale + bias).to(dt).float()
    h = h.transpose(1, 2)
    for w in weights:
        h = F.gelu(F.conv1d(h, w.float(), stride=2)).to(dt).float()
    return h.transpose(1, 2).contiguous().to(dt)


def launch_kernel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  input_norm=None, packed: Optional[list] = None
                  ) -> torch.Tensor:
    """Run ``csrc/conv_fused.cu`` on CUDA tensors (no launch count)."""
    _check(x, weights)
    if not x.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    b, t_in, c = x.shape
    ks = [int(w.shape[2]) for w in weights]
    t_out = chain_out_len(t_in, ks)
    if packed is None:
        packed = pack_weights(weights, x.dtype, x.device)
    if any(p.dtype != x.dtype for p in packed):
        raise ValueError("packed weights must match the activation dtype")
    x = x.contiguous()
    esize = x.element_size()
    tile = pick_tile(ks, c, esize)
    out = torch.empty((b, t_out, c), dtype=x.dtype, device=x.device)
    norm = [None] * 4
    if input_norm is not None:
        mean, inv, scale, bias = input_norm
        norm = [mean.float().contiguous(), inv.float().contiguous(),
                scale.float().contiguous(), bias.float().contiguous()]
    ptrs = [p.data_ptr() for p in packed] + [None] * (MAX_CHAIN - len(packed))
    kk = ks + [0] * (MAX_CHAIN - len(ks))
    lib = _build.library("conv_fused")
    fn = lib.wfl_conv_chain_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), out.data_ptr(), *ptrs, *kk, len(ks), b, t_in,
             t_out, c, tile,
             *[n.data_ptr() if n is not None else None for n in norm],
             0 if x.dtype == torch.float32 else 1,
             _build.stream_ptr(x.device))
    _build.check(lib, err, "conv_fused")
    return out


class _FusedConvChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weights, input_norm, packed):
        out = launch_kernel(x, weights, input_norm, packed)
        launches[tuple(int(w.shape[2]) for w in weights)] += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the fused conv chain is forward-only, as in the JAX package "
            "(the feature encoder runs plain convs while its weights train)")


def fused_conv_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     input_norm=None, packed: Optional[list] = None
                     ) -> torch.Tensor:
    """x: [B, T, C] channels-last; weights: per layer [C, C, k] (torch
    layout), k ∈ {2, 3}, no bias → [B, T_chain, C].

    input_norm: optional (mean [B,C], inv [B,C], scale [C], bias [C]).
    packed: the weights pre-packed by :func:`pack_weights` for x's dtype.
    A CUDA tensor runs the kernel, a CPU tensor the plain twin. The kernel
    is forward-only: a CUDA input or weight that needs a gradient raises
    (it is never silently detached)."""
    _check(x, weights)
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights, input_norm)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    norm = [t for t in (input_norm or ()) if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *weights, *norm]):
        raise RuntimeError(
            "fused_conv_chain (K5) has no backward: run it under "
            "torch.no_grad() (a frozen encoder), or use the plain convs")
    return _FusedConvChain.apply(x, list(weights), input_norm, packed)
