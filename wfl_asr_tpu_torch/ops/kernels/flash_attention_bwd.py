"""Key-masked attention without bias, the port of
``wfl_asr_tpu/ops/pallas/flash_attention_bwd.py:flash_attention_trainable``,
forward and backward.

The Conformer blocks' attention (head_dim 384 on the main path, 128 for a
hidden size of 512 under 4 heads) and the Whisper encoder's (head_dim 64). The JAX package keeps it apart from the
gated kernel for TPU grid order and VMEM only (flash_attention_bwd.py:18-25);
on the card both entry points share the routes of ``flash_attention``
(``forward_route``, ``backward_route``), by head width and dtype: ≤ 64
and 80-128 in bf16 the wgmma forward and dK/dV pass of
``csrc/attention_wgmma.cu`` at head width 64 and 128, at the tensors' own
width, with the dQ pass of ``csrc/attention_bwd_bias_mma.cu``
(``flash_attention.wgmma64_fwd_launches``, ``wgmma64_bwd_launches``,
``wgmma128_fwd_launches``, ``wgmma128_bwd_launches``), in f32 the bias-free
instantiations of the tensor-core forward and passes of
``csrc/attention_fwd_bias_mma.cu`` and ``csrc/attention_bwd_bias_mma.cu``
at head width 64 and 128 (narrower widths zero-padded to it;
``mma64_fwd_launches``, ``mma64_bwd_launches``, ``mma128_fwd_launches``,
``mma128_bwd_launches``); 144-512 the tensor-core forward of
``csrc/attention_fwd_mma.cu`` and pair of ``csrc/attention_bwd_mma.cu``
(``mma_fwd_launches``, ``mma_bwd_launches``); above 512 (to 2048) the
cluster forward and passes of ``csrc/attention_wide.cu`` (``wide_fwd_launches``,
``wide_bwd_launches``). All take the strict attention dropout (K6) when
asked. Each entry point keeps its own launch counts.
"""

from __future__ import annotations

import torch

from .flash_attention import attention_backward, attention_forward, \
    check_entry, pad_head_dim

# Launches of the CUDA kernels through this entry point (forward, and the
# backward pair), and of those the ones with dropout.
launches = 0
bwd_launches = 0
dropout_launches = 0
dropout_bwd_launches = 0


class _FlashAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len, dropout_rate, seed, scale):
        global launches, dropout_launches
        out = attention_forward(ctx, q, k, v, None, None, kv_len,
                                dropout_rate, seed, scale)
        launches += q.is_cuda
        dropout_launches += q.is_cuda and dropout_rate > 0.0
        return out

    @staticmethod
    def backward(ctx, dout):
        global bwd_launches, dropout_bwd_launches
        dq, dk, dv, _, _ = attention_backward(ctx, dout)
        bwd_launches += dout.is_cuda
        dropout_bwd_launches += dout.is_cuda and ctx.dropout_rate > 0.0
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len=None,
                              dropout_rate: float = 0.0,
                              dropout_seed=None, origin=(0, 0)
                              ) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T, D]; kv_len: [B] or None (= T).
    ``dropout_rate``/``dropout_seed``: strict attention dropout (K6), as
    :func:`~.flash_attention.flash_attention` takes them, with the shard
    ``origin`` (b0, h0) of a call on a shard of the batch or the heads
    (``flash_attention.shard_seed``). A CUDA tensor
    runs the kernels, a CPU tensor the plain twins; both are differentiable
    in q, k and v. Any head width: others than multiples of 16 are
    zero-padded (``flash_attention.pad_head_dim``)."""
    q, k, v, d, scale = pad_head_dim(q, k, v)
    rate, seed = check_entry(q, k, v, None, None, dropout_rate, dropout_seed,
                             origin)
    return _FlashAttentionTrainable.apply(q, k, v, kv_len, rate, seed,
                                          scale)[..., :d]
