"""Key-masked attention without bias, the port of
``wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:flash_attention_trainable``,
forward and backward.

The Conformer blocks' attention (head_dim 384 on the main path). The JAX
package keeps it apart from the gated kernel for TPU grid order and VMEM
only (flash_attention_bwd.py:18-25); on the card both entry points run the
same kernels of ``csrc/flash_attention.cu`` without bias or gate — the
forward (with the row LSE when autograd needs it) and the two backward
passes — and each entry point keeps its own launch counts.
"""

from __future__ import annotations

import torch

from .flash_attention import attention_backward, attention_forward, \
    check_entry

# Launches of the CUDA kernels through this entry point (forward, and the
# backward pair).
launches = 0
bwd_launches = 0


class _FlashAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        global launches
        out = attention_forward(ctx, q, k, v, None, None, kv_len)
        launches += q.is_cuda
        return out

    @staticmethod
    def backward(ctx, dout):
        global bwd_launches
        dq, dk, dv, _, _ = attention_backward(ctx, dout)
        bwd_launches += dout.is_cuda
        return dq, dk, dv, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len=None,
                              dropout_rate: float = 0.0) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T, D]; kv_len: [B] or None (= T).
    A CUDA tensor runs the kernels, a CPU tensor the plain twins; both are
    differentiable in q, k and v."""
    check_entry(q, k, v, None, None, dropout_rate)
    return _FlashAttentionTrainable.apply(q, k, v, kv_len)
