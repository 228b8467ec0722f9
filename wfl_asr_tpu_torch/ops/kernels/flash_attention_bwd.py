"""Key-masked attention without bias (forward), the port of
``wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:flash_attention_trainable``.

The Conformer blocks' attention (head_dim 384 on the main path). The JAX
package keeps it apart from the gated kernel for TPU grid order and VMEM
only (flash_attention_bwd.py:18-25); on the card both entry points run the
same template ``csrc/flash_attention.cu`` without bias or gate, and each
keeps its own launch count. Forward only: the backward is ROADMAP Queue 2
"K1b" and raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .flash_attention import BACKWARD_TODO, _check, attention_plain, \
    launch_kernel

# Launches of the CUDA kernel through this entry point.
launches = 0


class _FlashAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        global launches
        out = launch_kernel(q, k, v, kv_len=kv_len)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(BACKWARD_TODO)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len=None,
                              dropout_rate: float = 0.0) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T, D]; kv_len: [B] or None (= T).
    A CUDA tensor runs the kernel, a CPU tensor the plain twin."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel attention dropout is not ported (ROADMAP.md Queue 2, "
            "K6)")
    _check(q, k, v, None, None)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len=kv_len)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    return _FlashAttentionTrainable.apply(q, k, v, kv_len)
