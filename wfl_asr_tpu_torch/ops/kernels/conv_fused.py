"""Fused stride-2 conv chain (WavLM feature encoder layers 1-6), the port of
``wfl_asr_tpu/ops/pallas/conv_fused.py:fused_conv_chain``.

A chain of ≤ 3 VALID Conv1d layers (C → C, k ∈ {2, 3}, stride 2, no
bias), exact GELU after each, on channels-last [B, T, C]; optionally the
layer-0 GroupNorm application ``gelu(((x − mean)·inv)·scale + bias)`` on
the input. On a CUDA tensor ``csrc/conv_fused.cu`` runs each layer as one
launch of a tensor-core implicit GEMM, the intermediate layers in device
memory in the activation dtype (so each is rounded to it, as on the TPU);
on a CPU tensor the plain twin :func:`conv_chain_plain` (``F.conv1d`` +
GELU) runs. Nothing falls back. Inference only.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

MAX_CHAIN = 3

# Launches of the entry point on CUDA, per chain (keyed by its kernel sizes).
launches: Counter = Counter()
# Launches of the layer kernel (one a layer of a chain), each counted after
# its launcher returned no error.
layer_launches = 0


def chain_out_len(t_in: int, ks: Sequence[int]) -> int:
    t = t_in
    for k in ks:
        t = (t - k) // 2 + 1
    return t


def pack_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype,
                 device=None) -> list:
    """Torch-layout [C_out, C_in, k] weights → the kernel's [k, C_out, C_in]
    (tap, output channel, input channel: the [n][k] rows its B fragments
    read) at the activation dtype. Done once per dtype by the owning
    module."""
    return [w.detach().to(device=device, dtype=dtype).permute(2, 0, 1)
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
    """Run ``csrc/conv_fused.cu`` on CUDA tensors, one launch a layer; each
    layer's output is a new tensor in x's dtype. Counts each layer's
    launch in ``layer_launches``, not the chain's."""
    _check(x, weights)
    if not x.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    c = x.shape[-1]
    if packed is None:
        packed = pack_weights(weights, x.dtype, x.device)
    if len(packed) != len(weights) or any(
            p.dtype != x.dtype or p.device != x.device
            or tuple(p.shape) != (w.shape[2], c, c) or not p.is_contiguous()
            or p.data_ptr() % 16 for p, w in zip(packed, weights)):
        raise ValueError("packed weights must be pack_weights(weights) in "
                         "the activation's dtype and device")
    x = x.contiguous()
    if x.data_ptr() % 16:          # 16-byte copies need an aligned base
        x = x.clone()
    norm = None
    if input_norm is not None:     # f32, rows read 16 bytes at a time
        norm = [t.to(device=x.device, dtype=torch.float32).contiguous()
                for t in input_norm]
        norm = [t.clone() if t.data_ptr() % 16 else t for t in norm]
    return _launch_layers(x, packed, norm)


def _launch_layers(x: torch.Tensor, packed: Sequence[torch.Tensor],
                   norm: Optional[list], lib: Optional[ctypes.CDLL] = None
                   ) -> torch.Tensor:
    """One ``wfl_conv_layer_fwd`` launch for each packed layer, the input
    norm (mean, inv, scale, bias in f32) on the first. ``lib``: a build of
    the source other than the port's own (``kernel_variants_ab.py``)."""
    global layer_launches
    if lib is None:
        lib = _build.library("conv_fused")
    fn = lib.wfl_conv_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    stream = _build.stream_ptr(x.device)
    b, _, c = x.shape
    for p in packed:
        k, t_in = int(p.shape[0]), x.shape[1]
        out = torch.empty((b, chain_out_len(t_in, [k]), c), dtype=x.dtype,
                          device=x.device)
        ptrs = [None] * 4 if norm is None else [t.data_ptr() for t in norm]
        err = fn(x.data_ptr(), p.data_ptr(), out.data_ptr(), b, t_in,
                 out.shape[1], c, k, *ptrs,
                 0 if x.dtype == torch.float32 else 1, stream)
        _build.check(lib, err, "conv_fused")
        layer_launches += 1
        x, norm = out, None
    return x


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
