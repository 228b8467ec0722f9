"""Gated-bias flash attention (forward), the port of
``wfl_asr_tpu/ops/pallas/flash_attention.py:flash_attention``.

    out[b,h,q,:] = softmax_k( q·kᵀ/√d + gate[b,h,q]·bias[h,q,k],
                              keys ≥ kv_len[b] → −1e30 ) · v

- ``bias`` [H, T, T] is WavLM's relative position bias, shared over the
  batch (read per tile by the kernel, never expanded to [B,H,T,T]);
  ``gate`` [B, H, T] is the per-query gate; ``kv_len`` [B] masks padded
  keys (clamped to ≥ 1, as in JAX).
- On a CUDA tensor the hand-written kernel ``csrc/flash_attention.cu``
  runs (f32 or bf16 in, f32 softmax and accumulation). On a CPU tensor the
  plain twin :func:`attention_plain` runs. Nothing falls back: a kernel
  that fails to build or launch raises.
- Forward only: the backward (dQ/dK/dV/dBias/dGate) is ROADMAP Queue 2
  "K2b", and calling it raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
BACKWARD_TODO = ("the attention backward kernels are not ported yet "
                 "(ROADMAP.md Queue 2, K2b/K1b: training slice)")

# Launches of the CUDA kernel through this module's entry point; a run
# resets it to 0 and reads it to show the path went through the kernel.
launches = 0


def _prep_kv_len(kv_len, b: int, t: int, device) -> torch.Tensor:
    """[B] int32 valid key counts, clamped to [1, T] (a kv_len of 0 would
    leave a row fully masked; attending to key 0 alone keeps it finite —
    flash_attention.py:179-185)."""
    if kv_len is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    kv = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return kv.expand(b).clamp(1, t).contiguous()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    kv_len=None) -> torch.Tensor:
    """Plain PyTorch twin: materialized f32 scores, the kernel's exact
    math (``layers.attention_core`` with the gated bias and key mask)."""
    b, h, t, d = q.shape
    s = torch.matmul(q.float() * (1.0 / math.sqrt(d)),
                     k.float().transpose(-1, -2))
    if bias is not None:
        bf = bias.float()[None]
        s = s + (gate.float()[..., None] * bf if gate is not None else bf)
    kv = _prep_kv_len(kv_len, b, t, q.device)
    keep = torch.arange(t, device=q.device)[None, :] < kv[:, None]
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check(q, k, v, bias, gate):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share a [B,H,T,D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    d = q.shape[-1]
    if d % 16 or d > 512:
        raise ValueError(f"head_dim {d} unsupported: a multiple of 16 up to "
                         f"512 is required")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {q.dtype} unsupported (float32, bfloat16)")
    if gate is not None and bias is None:
        raise ValueError("gate requires bias")
    b, h, t, _ = q.shape
    if bias is not None and tuple(bias.shape) != (h, t, t):
        raise ValueError(f"bias must be [H,T,T]={h, t, t}, got "
                         f"{tuple(bias.shape)}")
    if gate is not None and tuple(gate.shape) != (b, h, t):
        raise ValueError(f"gate must be [B,H,T]={b, h, t}, got "
                         f"{tuple(gate.shape)}")


def launch_kernel(q, k, v, bias=None, gate=None, kv_len=None) -> torch.Tensor:
    """Run ``csrc/flash_attention.cu`` on CUDA tensors (no launch count)."""
    _check(q, k, v, bias, gate)
    if not q.is_cuda:
        raise ValueError("launch_kernel needs CUDA tensors")
    b, h, t, d = q.shape
    lib = _build.library("flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    if gate is not None:
        gate = gate.float().contiguous()
    kv = _prep_kv_len(kv_len, b, t, q.device)
    out = torch.empty_like(q)
    fn = lib.wfl_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             gate.data_ptr() if gate is not None else None,
             kv.data_ptr(), out.data_ptr(), b, h, t, d,
             1.0 / math.sqrt(d), 0 if q.dtype == torch.float32 else 1,
             _build.stream_ptr(q.device))
    _build.check(lib, err, "flash_attention")
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, gate, kv_len):
        global launches
        out = launch_kernel(q, k, v, bias, gate, kv_len)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_TODO)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    kv_len=None, dropout_rate: float = 0.0) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T, D]. bias: [H, T, T] or None;
    gate: [B, H, T] or None (requires bias); kv_len: [B] or None (= T).

    A CUDA tensor runs the kernel, a CPU tensor the plain twin."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout is not ported (ROADMAP.md Queue 2, "
            "K6)")
    _check(q, k, v, bias, gate)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, gate, kv_len)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bias, gate, kv_len)
