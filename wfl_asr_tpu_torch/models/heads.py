"""Model heads, the port of ``wfl_asr_tpu/models/heads.py``: BiLSTM,
Conformer blocks, dilated conv stack, boundary-offset head, language
conditioning. Module names follow the reference ``BIOPhonemeTagger``
(``conformer_layers.{i}.ff1.net.{0,1,4}``, a packed
``self_attn.in_proj_weight``, ``conv.{0,2,3,5}``, ``dilated_conv_stack.{2j}``,
``boundary_offset_head.{0,2}``), so its checkpoints load unchanged.

Semantics kept from the reference (model.py:21-52): the Conformer conv
module is a **full** (not depthwise) k=31 conv with BatchNorm1d, attention
is post-LN, and the block has no final LayerNorm.

Training mode (``module.train()``) follows the JAX package (heads.py:172-290):
dropout at ``conformer_dropout`` after each FF module's GELU and output,
after the attention's output projection (the post-projection substitute
for probability dropout) and after the conv module; BatchNorm normalizes
with the batch statistics (biased variance) and updates the running ones
(unbiased variance, momentum 0.1), as ``nn.BatchNorm1d`` does. Dropout
draws from the ``generator`` passed in. With ``strict_attn_dropout`` the
attention probabilities are dropped at that rate inside the kernels (K6)
instead, and the post-projection substitute is skipped (heads.py:260-268),
so the block is the reference's ``nn.MultiheadAttention(dropout=...)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..ops.kernels.flash_attention_bwd import flash_attention_trainable
from ..parallel.mesh import all_reduce_sum, shard_origin
from ..parallel.tp import copy_to_model
from . import layers
from .layers import conv1d, dropout, gelu, layer_norm, linear


# ---------------------------------------------------------------------------
# BiLSTM
# ---------------------------------------------------------------------------

def bilstm(lstm: nn.LSTM, x: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stacked bidirectional ``nn.LSTM(batch_first=True)`` over [B, T, H].

    With ``mask`` [B, T] (right-padded), rows are packed to their true
    lengths, so the reverse direction starts at each row's last valid frame
    from a zero state — the JAX package's carry reset on padded frames
    (heads.py:61-111). Valid frames match; padded frames come out as zeros.

    The LSTM runs in f32 whatever the compute dtype (cuDNN's bf16 RNN
    support is not relied on); the output is cast back.
    """
    dtype = x.dtype
    xf = x.float()
    if mask is None:
        out, _ = lstm(xf)
        return out.to(dtype)
    t = x.shape[1]
    lengths = mask.to(torch.int64).sum(-1).clamp_min(1).cpu()
    packed = pack_padded_sequence(xf, lengths, batch_first=True,
                                  enforce_sorted=False)
    out, _ = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Conformer block
# ---------------------------------------------------------------------------

class FeedForwardModule(nn.Module):
    """LN → Linear(×e) → GELU → Drop → Linear → Drop (model.py:6-19); the
    reference's dropout slots are identities (the dropout is
    :func:`~.layers.dropout` with an explicit generator), so the linears
    keep their indices."""

    def __init__(self, dim: int, expansion: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.net = nn.Sequential(
            nn.LayerNorm(dim), nn.Linear(dim, dim * expansion), nn.GELU(),
            nn.Identity(), nn.Linear(dim * expansion, dim), nn.Identity())

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = gelu(linear(self.net[1], layer_norm(self.net[0], x)))
        h = dropout(h, self.rate, generator, self.training)
        h = linear(self.net[4], h)
        return dropout(h, self.rate, generator, self.training)


class PackedSelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight``
    [3E, E], ``out_proj``) with the attention through the key-masked kernel
    ``flash_attention_trainable``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        # the parallel.mesh.Mesh of a sharded run (parallel.tp): under
        # tensor parallelism each rank attends with its heads, their rows of
        # the q, k and v blocks of the (replicated) packed projection
        self.mesh = None

    def forward(self, x: torch.Tensor, kv_len=None,
                dropout_rate: float = 0.0, dropout_seed=None) -> torch.Tensor:
        b, t, dim = x.shape
        d = dim // self.heads
        heads, h0, mesh = self.heads, 0, self.mesh
        w, bias = self.in_proj_weight, self.in_proj_bias
        if mesh is not None and mesh.model_size > 1:
            heads = self.heads // mesh.model_size
            h0 = mesh.model_rank * heads
            # every rank's rows of the replicated projection get their
            # gradient from this rank alone: sum them over the model group
            x, w, bias = (copy_to_model(a, mesh.model_group)
                          for a in (x, w, bias))
        w, bias = w.to(x.dtype), bias.to(x.dtype)

        def proj(i):
            lo = i * dim + h0 * d
            h = F.linear(x, w[lo:lo + heads * d], bias[lo:lo + heads * d])
            return h.reshape(b, t, heads, d).transpose(1, 2).contiguous()

        attn = flash_attention_trainable(
            proj(0), proj(1), proj(2), kv_len, dropout_rate, dropout_seed,
            origin=shard_origin(mesh, b, h0))
        return linear(self.out_proj,
                      attn.transpose(1, 2).reshape(b, t, heads * d))


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """BatchNorm over [B, C, T] in f32: running statistics in eval; in
    training the batch statistics, with the running ones updated in place
    (``nn.BatchNorm1d``'s train-mode semantics). With a ``mesh`` whose
    data dim is > 1 the batch is the data ranks' rows together
    (SyncBatchNorm's semantics): mean and variance reduced over the data
    group, differentiably, and the running statistics updated with them,
    the same on every rank."""
    if bn.training:
        bn.num_batches_tracked += 1
        if mesh is not None and mesh.data_size > 1:
            return _batch_norm_synced(bn, x, mesh).to(x.dtype)
        y = torch.nn.functional.batch_norm(
            x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=True, momentum=bn.momentum, eps=bn.eps)
        return y.to(x.dtype)
    y = (x.float() - bn.running_mean[None, :, None]) \
        * torch.rsqrt(bn.running_var[None, :, None] + bn.eps)
    y = y * bn.weight[None, :, None] + bn.bias[None, :, None]
    return y.to(x.dtype)


def _batch_norm_synced(bn: nn.BatchNorm1d, x: torch.Tensor,
                       mesh) -> torch.Tensor:
    """Train-mode BatchNorm over the rows of every data rank (equal shapes
    on every rank): two-pass mean and biased variance through a
    differentiable all-reduce, the running variance unbiased."""
    xf = x.float()
    n = xf.shape[0] * xf.shape[2] * mesh.data_size
    mean = all_reduce_sum(xf.sum(dim=(0, 2)), mesh.data_group) / n
    c = xf - mean[None, :, None]
    var = all_reduce_sum((c * c).sum(dim=(0, 2)), mesh.data_group) / n
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach() * (n / max(n - 1, 1)),
                                        alpha=m)
    y = c * torch.rsqrt(var + bn.eps)[None, :, None]
    return y * bn.weight[None, :, None] + bn.bias[None, :, None]


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ff_expansion: int,
                 conv_kernel: int, rate: float = 0.0,
                 strict_attn_dropout: bool = False):
        super().__init__()
        self.rate = rate
        self.strict_attn_dropout = strict_attn_dropout
        self.ff1 = FeedForwardModule(dim, ff_expansion, rate)
        self.ff2 = FeedForwardModule(dim, ff_expansion, rate)
        self.self_attn = PackedSelfAttention(dim, heads)
        self.ln1 = nn.LayerNorm(dim)
        self.ln2 = nn.LayerNorm(dim)
        self.conv_kernel = conv_kernel
        self.conv = nn.Sequential(
            nn.Conv1d(dim, 2 * dim, 1), nn.GLU(dim=1),
            nn.Conv1d(dim, dim, conv_kernel, padding=conv_kernel // 2),
            nn.BatchNorm1d(dim), nn.GELU(), nn.Conv1d(dim, dim, 1))
        # the parallel.mesh.Mesh of a sharded run: the BatchNorm's data
        # group
        self.mesh = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        """Macaron FF halves, post-LN MHSA, conv module, no final LN.
        ``mask`` [B, T]: key-padding mask for attention, and the main conv's
        input is zeroed on padded frames (exact-length zero padding)."""
        def drop(h):
            return dropout(h, self.rate, generator, self.training)

        x = x + 0.5 * self.ff1(x, generator)
        kv_len = mask.to(torch.int32).sum(-1) if mask is not None else None
        if self.training and self.strict_attn_dropout and self.rate > 0.0:
            # the exact probability dropout, in-kernel; no substitute after
            attn = self.self_attn(x, kv_len, self.rate,
                                  layers.attention_dropout_seed(generator,
                                                                x.device))
        else:
            attn = drop(self.self_attn(x, kv_len))
        x = layer_norm(self.ln1, x + attn)

        h = layer_norm(self.ln2, x).transpose(1, 2)            # [B, C, T]
        h = conv1d(self.conv[0], h)
        a, g = h.chunk(2, dim=1)                               # GLU(dim=1)
        h = a * torch.sigmoid(g)
        if mask is not None:
            h = h * mask[:, None, :].to(h.dtype)
        h = conv1d(self.conv[2], h, padding=self.conv_kernel // 2)
        h = gelu(batch_norm(self.conv[3], h, self.mesh))
        h = conv1d(self.conv[5], h).transpose(1, 2)
        x = x + drop(h)
        return x + 0.5 * self.ff2(x, generator)


# ---------------------------------------------------------------------------
# Dilated conv stack / offset head / language conditioning
# ---------------------------------------------------------------------------

def make_dilated_stack(dim: int, depth: int, kernel: int) -> nn.Sequential:
    """depth × (Conv1d(dilation=2^i, same padding) + ReLU) (model.py:126-133)."""
    mods = []
    for i in range(depth):
        dilation = 2 ** i
        mods += [nn.Conv1d(dim, dim, kernel, dilation=dilation,
                           padding=dilation * (kernel - 1) // 2), nn.ReLU()]
    return nn.Sequential(*mods)


def dilated_stack(stack: nn.Sequential, x: torch.Tensor, kernel: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, T, C]; with ``mask`` each conv's input is zeroed on padded
    frames."""
    h = x.transpose(1, 2)
    mask_c = mask[:, None, :].to(h.dtype) if mask is not None else None
    for i in range(0, len(stack), 2):
        dilation = 2 ** (i // 2)
        if mask_c is not None:
            h = h * mask_c
        h = torch.relu(conv1d(stack[i], h, padding=dilation * (kernel - 1) // 2,
                              dilation=dilation))
    return h.transpose(1, 2)


def make_offset_head(dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(dim, dim, 3, padding=1), nn.GELU(),
                         nn.Conv1d(dim, 2, 1), nn.Sigmoid())


def offset_head(head: nn.Sequential, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv(k=3) → GELU → Conv(→2, k=1) → Sigmoid → [B, T, 2]."""
    h = x.transpose(1, 2)
    if mask is not None:
        h = h * mask[:, None, :].to(h.dtype)
    h = gelu(conv1d(head[0], h, padding=1))
    return torch.sigmoid(conv1d(head[2], h)).transpose(1, 2)


def lang_conditioning(emb: nn.Embedding, proj: nn.Linear, x: torch.Tensor,
                      lang_id: torch.Tensor) -> torch.Tensor:
    """Embed the language id, broadcast over T, concat, project back."""
    e = emb.weight[lang_id.long()].to(x.dtype)                  # [B, E]
    e = e[:, None, :].expand(x.shape[0], x.shape[1], e.shape[-1])
    return linear(proj, torch.cat([x, e], dim=-1))
