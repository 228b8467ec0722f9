"""WavLM encoder in PyTorch, the port of ``wfl_asr_tpu/models/wavlm.py``.

Module names follow HF ``WavLMModel`` so the reference checkpoint's keys
load unchanged (``feature_extractor.conv_layers.{i}``,
``encoder.layers.{i}.attention.q_proj``, the weight-normed
``encoder.pos_conv_embed.conv``, ``rel_attn_embed`` on layer 0 only).

The forward is the JAX package's path with its kernels on:

- conv layer 0 as a windowed matmul emitting channels-last [B, T, C], the
  layer-0 GroupNorm statistics over valid frames only (``channel_stats``),
  and layers 1-6 as fused chains of ≤ 3 layers (``ops.kernels.conv_fused``,
  forward only) whose first chain applies the GroupNorm + GELU on its
  input. While the conv weights train (grad enabled and weights that need
  it) the layers run as plain differentiable convs instead, as the JAX
  package leaves them to XLA then (train/loop.py:766-772);
- the feature projection, padded-frame zeroing, the pos conv;
- post-LN (base) or pre-LN (large) transformer layers with gated relative
  position bias attention through ``ops.kernels.flash_attention`` (forward
  and backward kernels) at every length (the TPU's ``FLASH_MIN_T``
  cut-over is not carried over).

In training mode (``module.train()``) dropout (feature projection, hidden,
activation) and LayerDrop follow wavlm.py:533-660, drawing from the
``generator`` passed in. LayerDrop computes every layer and selects, as the
JAX package does, so the kernels launch once per layer on every step. With
``strict_attention_dropout`` the attention probabilities are dropped at
``attention_dropout`` inside the kernels (K6), each layer's seed drawn from
the same generator (wavlm.py:439-442); the hidden dropout after the
attention stays. With ``remat`` each transformer layer runs under
``layers.checkpointed`` (wavlm.py:620-640): its draws are the same in the
first pass, the recompute and without remat, so remat on and off give the
same loss and gradients. Parameters stay f32 and are cast to the compute
dtype at use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv_fused import MAX_CHAIN, fused_conv_chain, \
    pack_weights
from ..ops.kernels.flash_attention import flash_attention
from ..parallel import pp
from ..parallel.mesh import local_tensor, shard_origin
from ..parallel.sp import gather_time, shard_time, sp_active
from ..parallel.tp import copy_to_model
from . import layers
from .layers import channel_stats, checkpointed, conv1d, dropout, gelu, \
    group_norm, layer_norm, linear


@dataclass(frozen=True)
class WavLMArch:
    """Architecture hyperparameters (defaults = wavlm-base/base-plus), under
    the JAX package's names and defaults; its kernel switches are dropped by
    ``TaggerArch.from_config`` (the port always runs its kernels)."""
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"          # "group" (base) | "layer" (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    do_stable_layer_norm: bool = False        # True for wavlm-large
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.0
    # attention-probability dropout, applied in training only under
    # strict_attention_dropout (in-kernel, K6); by default the hidden
    # dropout after the attention is the regularizer, as in JAX
    attention_dropout: float = 0.0
    strict_attention_dropout: bool = False
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.0                    # whole-batch layer skip

    @classmethod
    def from_hf_config(cls, hf) -> "WavLMArch":
        return cls(
            hidden_size=hf.hidden_size, num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            conv_dim=tuple(hf.conv_dim), conv_kernel=tuple(hf.conv_kernel),
            conv_stride=tuple(hf.conv_stride), conv_bias=hf.conv_bias,
            feat_extract_norm=hf.feat_extract_norm,
            num_conv_pos_embeddings=hf.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=hf.num_conv_pos_embedding_groups,
            num_buckets=hf.num_buckets, max_distance=hf.max_bucket_distance,
            do_stable_layer_norm=hf.do_stable_layer_norm,
            layer_norm_eps=hf.layer_norm_eps,
            hidden_dropout=hf.hidden_dropout,
            activation_dropout=hf.activation_dropout,
            attention_dropout=hf.attention_dropout,
            feat_proj_dropout=hf.feat_proj_dropout,
            layerdrop=hf.layerdrop,
        )

    def feature_lengths(self, num_samples: int) -> int:
        """Frames out of the conv feature encoder: floor((L-k)/s)+1 each."""
        length = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


def relative_position_buckets(length: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5-style (WavLM variant) bucket matrix [T, T], host-side."""
    half = num_buckets // 2
    context = np.arange(length)[:, None]
    memory = np.arange(length)[None, :]
    rel = memory - context
    buckets = (rel > 0).astype(np.int64) * half
    rel_abs = np.abs(rel)
    max_exact = half // 2
    is_small = rel_abs < max_exact
    large = max_exact + (
        np.log(np.maximum(rel_abs, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact) * (half - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets += np.where(is_small, rel_abs, large)
    return buckets


def fused_tail_start(arch: WavLMArch) -> int:
    """First conv layer of the trailing run the fused chain can take
    (C_in == C_out, k ∈ {2,3}, stride 2, no per-layer norm, no bias)."""
    if arch.conv_bias or arch.feat_extract_norm == "layer":
        return len(arch.conv_dim)
    j = len(arch.conv_dim)
    while j > 1:          # layer 0 stays outside (its GroupNorm lives there)
        i = j - 1
        if (arch.conv_stride[i] == 2 and arch.conv_kernel[i] in (2, 3)
                and arch.conv_dim[i] == arch.conv_dim[i - 1]):
            j = i
        else:
            break
    return j


def conv0_fast_ok(arch: WavLMArch, s: int) -> bool:
    """Can layer 0 run as the windowed matmul without dropping frames?"""
    k0, s0 = arch.conv_kernel[0], arch.conv_stride[0]
    if k0 == 2 * s0:
        return True
    if k0 <= s0:
        return (s - k0) // s0 + 1 <= s // s0
    return False


# ---------------------------------------------------------------------------
# Modules (HF WavLMModel names)
# ---------------------------------------------------------------------------

class ConvLayer(nn.Module):
    def __init__(self, arch: WavLMArch, i: int):
        super().__init__()
        c_in = 1 if i == 0 else arch.conv_dim[i - 1]
        c_out = arch.conv_dim[i]
        self.conv = nn.Conv1d(c_in, c_out, arch.conv_kernel[i],
                              stride=arch.conv_stride[i], bias=arch.conv_bias)
        if arch.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out)
        elif arch.feat_extract_norm == "group" and i == 0:
            self.layer_norm = nn.GroupNorm(c_out, c_out)


class FeatureExtractor(nn.Module):
    def __init__(self, arch: WavLMArch):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            ConvLayer(arch, i) for i in range(len(arch.conv_dim)))


class FeatureProjection(nn.Module):
    def __init__(self, arch: WavLMArch):
        super().__init__()
        self.layer_norm = nn.LayerNorm(arch.conv_dim[-1])
        self.projection = nn.Linear(arch.conv_dim[-1], arch.hidden_size)


def _pos_conv_norm(w: torch.Tensor) -> torch.Tensor:
    """Per-kernel-position L2 norm [1, 1, K] (weight norm over dim 2),
    computed on the CPU whatever ``w``'s device, so that the norm written
    on save and the one divided by on load are the same float and the
    round trip is exact."""
    return w.detach().cpu().square().sum(dim=(0, 1), keepdim=True).sqrt() \
        .to(w.device)


def _weight_norm_state(module, state_dict, prefix, local_metadata) -> None:
    """state_dict post-hook: ``conv.weight`` → the reference's weight-norm
    keys, original1 = the weight and original0 = its norm (what the JAX
    package's export writes), so a save and a load round-trip exactly."""
    with torch.no_grad():
        w = state_dict.pop(prefix + "conv.weight")
        state_dict[prefix + "conv.parametrizations.weight.original0"] = \
            _pos_conv_norm(w)
        state_dict[prefix + "conv.parametrizations.weight.original1"] = w


def _fold_weight_norm(module, state_dict, prefix, *args) -> None:
    """load_state_dict pre-hook: fold the weight norm (the parametrization
    keys, or the older ``weight_g``/``weight_v``) into ``conv.weight``."""
    for g_key, v_key in (("conv.parametrizations.weight.original0",
                          "conv.parametrizations.weight.original1"),
                         ("conv.weight_g", "conv.weight_v")):
        if prefix + g_key in state_dict and prefix + v_key in state_dict:
            g = state_dict.pop(prefix + g_key)
            v = state_dict.pop(prefix + v_key)
            state_dict[prefix + "conv.weight"] = \
                v * (g / _pos_conv_norm(v).clamp_min(1e-12))


class PosConvEmbed(nn.Module):
    """The convolutional position embedding. Its weight is a plain
    parameter, trained as the JAX package trains it (the weight norm folded
    in); the state_dict keeps the reference's weight-norm form
    (``conv.parametrizations.weight.original0/1``)."""

    def __init__(self, arch: WavLMArch):
        super().__init__()
        k = arch.num_conv_pos_embeddings
        self.conv = nn.Conv1d(arch.hidden_size, arch.hidden_size, k,
                              padding=k // 2,
                              groups=arch.num_conv_pos_embedding_groups)
        self.register_state_dict_post_hook(_weight_norm_state)
        self.register_load_state_dict_pre_hook(_fold_weight_norm)


class WavLMAttention(nn.Module):
    def __init__(self, arch: WavLMArch, has_rel_embed: bool):
        super().__init__()
        h = arch.hidden_size
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)
        self.gru_rel_pos_const = nn.Parameter(
            torch.ones(1, arch.num_heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(h // arch.num_heads, 8)
        if has_rel_embed:
            self.rel_attn_embed = nn.Embedding(arch.num_buckets,
                                               arch.num_heads)


class FeedForward(nn.Module):
    def __init__(self, arch: WavLMArch):
        super().__init__()
        self.intermediate_dense = nn.Linear(arch.hidden_size,
                                            arch.intermediate_size)
        self.output_dense = nn.Linear(arch.intermediate_size,
                                      arch.hidden_size)


class WavLMLayer(nn.Module):
    def __init__(self, arch: WavLMArch, i: int):
        super().__init__()
        self.attention = WavLMAttention(arch, has_rel_embed=(i == 0))
        self.layer_norm = nn.LayerNorm(arch.hidden_size)
        self.feed_forward = FeedForward(arch)
        self.final_layer_norm = nn.LayerNorm(arch.hidden_size)

    def forward(self, run, *args):
        """``run(self, *args)``: the encoder's layer function, called through
        the module so that hooks on the layer run (FSDP's gathers)."""
        return run(self, *args)


class WavLMTransformer(nn.Module):
    """HF ``WavLMEncoder``: pos conv, LayerNorm and the layer stack."""

    def __init__(self, arch: WavLMArch):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(arch)
        self.layer_norm = nn.LayerNorm(arch.hidden_size)
        self.layers = nn.ModuleList(WavLMLayer(arch, i)
                                    for i in range(arch.num_layers))


class WavLMEncoder(nn.Module):
    """HF ``WavLMModel``: raw (normalized) audio [B, S] → [B, T, H]."""

    def __init__(self, arch: WavLMArch):
        super().__init__()
        self.arch = arch
        self.feature_extractor = FeatureExtractor(arch)
        self.feature_projection = FeatureProjection(arch)
        self.encoder = WavLMTransformer(arch)
        self._packed = {}
        # bucket index matrices per (length, device): lengths come in 1 s
        # buckets, so this stays small, and a step skips the host's [T, T]
        self._buckets = {}
        # the parallel.mesh.Mesh of a sharded run (set by parallel.tp):
        # local heads, shard origins of the dropout seeds
        self.mesh = None
        # sequence parallelism between layers (parallel/sp.py)
        self.sequence_parallel = False
        # pipeline parallelism over the layers (parallel/pp.py)
        self.pipeline = None

    def _heads(self):
        """(local heads, first local head, model group or None): all heads
        and no group unless the mesh's model dim is > 1."""
        heads, mesh = self.arch.num_heads, self.mesh
        if mesh is None or mesh.model_size == 1:
            return heads, 0, None
        local = heads // mesh.model_size
        return local, mesh.model_rank * local, mesh.model_group

    # -- position bias -------------------------------------------------------

    def position_bias(self, length: int) -> torch.Tensor:
        """Shared (ungated) relative position bias [H, T, T], f32; under
        tensor parallelism this rank's heads, [H/mp, T, T], from its shard
        of the bucket table."""
        table = local_tensor(
            self.encoder.layers[0].attention.rel_attn_embed.weight)
        key = (length, table.device)
        buckets = self._buckets.get(key)
        if buckets is None:
            buckets = torch.from_numpy(relative_position_buckets(
                length, self.arch.num_buckets, self.arch.max_distance)
            ).to(table.device)
            self._buckets[key] = buckets
        # an embedding lookup: its backward (the table's gradient from the
        # summed dBias of every layer) is a segmented sum, not a scatter
        return F.embedding(buckets, table).permute(2, 0, 1).contiguous()

    # -- feature encoder -------------------------------------------------------

    def _packed_chain(self, g: int, ws, x: torch.Tensor):
        """The chain's weights packed for the kernel, once per dtype and
        device (re-packed only if the weights were replaced or updated)."""
        if not x.is_cuda:
            return None
        key = (g, x.dtype, x.device)
        version = tuple((w.data_ptr(), w._version) for w in ws)
        hit = self._packed.get(key)
        if hit is None or hit[0] != version:
            hit = (version, pack_weights(ws, x.dtype, x.device))
            self._packed[key] = hit
        return hit[1]

    def _fused_tail(self, x: torch.Tensor, split: int, input_norm=None):
        """Conv layers [split:] as fused chains of ≤ 3 layers on [B, T, C];
        the first chain applies ``input_norm`` (layer-0 GroupNorm) + GELU
        to its input."""
        layers = self.feature_extractor.conv_layers
        for g in range(split, len(layers), MAX_CHAIN):
            ws = [layer.conv.weight for layer in layers[g: g + MAX_CHAIN]]
            x = fused_conv_chain(x, ws, input_norm=input_norm,
                                 packed=self._packed_chain(g, ws, x))
            input_norm = None
        return x

    def _conv0_windowed(self, audio: torch.Tensor) -> torch.Tensor:
        """Layer 0 (C_in=1, k ≤ 2·stride) as a windowed matmul emitting
        channels-last [B, T0, C] (no [B, C, T] relayout)."""
        arch = self.arch
        k0, s0 = arch.conv_kernel[0], arch.conv_stride[0]
        b, s = audio.shape
        t0 = (s - k0) // s0 + 1
        v = audio[:, : (s // s0) * s0].reshape(b, s // s0, s0)
        if k0 > s0:
            win = torch.cat([v[:, :-1], v[:, 1:]], dim=-1)[:, :t0, :k0]
        else:
            win = v[:, :t0, :k0]
        conv = self.feature_extractor.conv_layers[0].conv
        y = torch.matmul(win, conv.weight.to(audio.dtype)[:, 0, :].t())
        if conv.bias is not None:
            y = y + conv.bias.to(y.dtype)
        return y

    def feature_encoder(self, audio: torch.Tensor,
                        sample_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Raw audio [B, S] → conv features [B, T, C]. With
        ``sample_mask`` the layer-0 GroupNorm statistics cover valid frames
        only, so valid frames equal an exact-length run. While the conv
        weights train, every layer runs as a plain conv (K5 has no
        backward)."""
        arch = self.arch
        layers = self.feature_extractor.conv_layers
        valid_len = (sample_mask.to(torch.int64).sum(-1)
                     if sample_mask is not None else None)
        trains = torch.is_grad_enabled() and any(
            layer.conv.weight.requires_grad for layer in layers)
        split = len(layers) if trains else fused_tail_start(arch)
        if (split == 1 and split < len(layers)
                and conv0_fast_ok(arch, audio.shape[-1])
                and arch.feat_extract_norm == "group"):
            x = self._conv0_windowed(audio)
            time_mask = None
            if valid_len is not None:
                valid_len = (valid_len - arch.conv_kernel[0]) \
                    // arch.conv_stride[0] + 1
                time_mask = (torch.arange(x.shape[1], device=x.device)[None]
                             < valid_len[:, None])
            mean, var = channel_stats(x, time_mask)
            gn = layers[0].layer_norm
            norm = (mean, torch.rsqrt(var + 1e-5), gn.weight, gn.bias)
            return self._fused_tail(x, split, input_norm=norm)

        x = audio[:, None, :]
        for i, layer in enumerate(layers[:split]):
            x = conv1d(layer.conv, x, stride=arch.conv_stride[i],
                       padding="VALID")
            if valid_len is not None:
                valid_len = (valid_len - arch.conv_kernel[i]) \
                    // arch.conv_stride[i] + 1
            if hasattr(layer, "layer_norm"):
                if arch.feat_extract_norm == "group" and i == 0:
                    time_mask = None
                    if valid_len is not None:
                        time_mask = (torch.arange(x.shape[-1],
                                                  device=x.device)[None]
                                     < valid_len[:, None])
                    x = group_norm(layer.layer_norm.weight,
                                   layer.layer_norm.bias, x,
                                   num_groups=x.shape[1],
                                   time_mask=time_mask)
                else:
                    x = layer_norm(layer.layer_norm, x.transpose(1, 2)
                                   ).transpose(1, 2)
            x = gelu(x)
        return self._fused_tail(x.transpose(1, 2), split)

    # -- transformer -------------------------------------------------------------

    def _pos_conv_embed(self, x: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        conv = self.encoder.pos_conv_embed.conv
        y = conv1d(conv, x.transpose(1, 2),
                   padding=arch.num_conv_pos_embeddings // 2,
                   groups=arch.num_conv_pos_embedding_groups,
                   weight=conv.weight)
        if arch.num_conv_pos_embeddings % 2 == 0:
            y = y[:, :, :-1]
        return gelu(y).transpose(1, 2)

    def _gate_values(self, att: WavLMAttention,
                     x: torch.Tensor) -> torch.Tensor:
        """WavLM's per-query position-bias gate → [B, H, T] f32 (this
        rank's heads under tensor parallelism)."""
        b, t, _ = x.shape
        heads, h0, group = self._heads()
        lin = att.gru_rel_pos_linear
        w, bias = lin.weight, lin.bias
        if group is not None:
            # the replicated projection serves this rank's heads only: its
            # gradient, as the input's, is summed over the model group
            x, w, bias = (copy_to_model(a, group) for a in (x, w, bias))
        xh = x.reshape(b, t, self.arch.num_heads, -1)[:, :, h0:h0 + heads]
        xh = xh.transpose(1, 2)                                  # [B,H,T,D]
        proj = F.linear(xh, w.to(xh.dtype), bias.to(xh.dtype))   # [B,H,T,8]
        proj = proj.reshape(b, heads, t, 2, 4).sum(-1)
        gates = torch.sigmoid(proj.float())
        const = local_tensor(att.gru_rel_pos_const).float().reshape(
            1, heads, 1)
        return gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0

    def _attend(self, att: WavLMAttention, x: torch.Tensor,
                pos_bias: torch.Tensor, kv_len, generator=None,
                row0: Optional[int] = None) -> torch.Tensor:
        b, t, hid = x.shape
        heads, h0, _ = self._heads()
        hid = hid * heads // self.arch.num_heads        # this rank's width

        def split(h):
            return h.reshape(b, t, heads, hid // heads).transpose(1, 2) \
                .contiguous()

        q = split(linear(att.q_proj, x))
        k = split(linear(att.k_proj, x))
        v = split(linear(att.v_proj, x))
        gate = self._gate_values(att, x)
        drop = {}
        arch = self.arch
        if (self.training and arch.strict_attention_dropout
                and arch.attention_dropout > 0.0):
            # strict attention dropout, in-kernel (torch semantics)
            drop = dict(dropout_rate=arch.attention_dropout,
                        dropout_seed=layers.attention_dropout_seed(
                            generator, x.device),
                        origin=shard_origin(self.mesh, b, h0)
                        if row0 is None else (row0, h0))
        out = flash_attention(q, k, v, bias=pos_bias, gate=gate,
                              kv_len=kv_len, **drop)
        return linear(att.out_proj, out.transpose(1, 2).reshape(b, t, hid))

    def _layer_draws(self, generator) -> None:
        """A layer's whole-batch draws from the shared stream, as
        :meth:`_attend` makes them in training: the strict-dropout seed."""
        arch = self.arch
        if (self.training and arch.strict_attention_dropout
                and arch.attention_dropout > 0.0):
            layers.attention_dropout_seed(
                generator, layers.shared_generator(generator).device)

    def _layer(self, layer: WavLMLayer, x, pos_bias, kv_len, generator,
               row0: Optional[int] = None):
        """One layer; ``row0``: the global index of ``x``'s first row when
        it is a pipeline microbatch (the strict-dropout origin)."""
        arch = self.arch
        eps = arch.layer_norm_eps
        ff = layer.feed_forward

        def hidden_drop(h):
            return dropout(h, arch.hidden_dropout, generator, self.training)

        def feed_forward(h):
            h = gelu(linear(ff.intermediate_dense, h))
            h = dropout(h, arch.activation_dropout, generator, self.training)
            return hidden_drop(linear(ff.output_dense, h))

        if arch.do_stable_layer_norm:            # pre-LN (wavlm-large)
            xn = layer_norm(layer.layer_norm, x, eps)
            x = x + hidden_drop(self._attend(layer.attention, xn, pos_bias,
                                             kv_len, generator, row0))
            return x + feed_forward(layer_norm(layer.final_layer_norm, x,
                                               eps))
        x = x + hidden_drop(self._attend(layer.attention, x, pos_bias,
                                         kv_len, generator, row0))
        x = layer_norm(layer.layer_norm, x, eps)
        return layer_norm(layer.final_layer_norm, x + feed_forward(x), eps)

    def forward(self, audio: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                sample_mask: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32,
                pos_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """``audio`` [B, S] normalized; ``mask`` [B, T] / ``sample_mask``
        [B, S] give exact-length numerics on bucket-padded rows.
        ``pos_bias`` [H, T, T]: a precomputed position bias. ``generator``:
        the dropout and LayerDrop draws in training mode. ``remat``: each
        transformer layer under ``layers.checkpointed``."""
        arch = self.arch
        eps = arch.layer_norm_eps
        audio = audio.to(compute_dtype)
        feats = self.feature_encoder(audio, sample_mask)
        x = layer_norm(self.feature_projection.layer_norm, feats, eps)
        x = linear(self.feature_projection.projection, x)
        x = dropout(x, arch.feat_proj_dropout, generator, self.training)
        if mask is not None:
            x = x * mask[:, :, None].to(x.dtype)
        x = x + self._pos_conv_embed(x)
        if not arch.do_stable_layer_norm:
            x = layer_norm(self.encoder.layer_norm, x, eps)
        x = dropout(x, arch.hidden_dropout, generator, self.training)
        if pos_bias is None:
            pos_bias = self.position_bias(x.shape[1])
        if pos_bias.is_cuda and not pos_bias.requires_grad:
            # the CUDA kernels read the bias in the compute dtype, as the
            # JAX wrapper stores it: cast once a forward, not once a layer
            # (the plain twin on the CPU reads it as it is). A bias that is
            # trained stays f32, so that the layers' dBias add up in f32 as
            # the JAX package's do.
            pos_bias = pos_bias.to(compute_dtype)
        kv_len = (mask.to(torch.int32).sum(-1) if mask is not None else None)
        if self.pipeline is not None:
            x = pp.pipelined_layers(
                self, x, lambda layer, h, rows, shr, gen, row0: layer(
                    self._layer, h, shr[0], rows[0] if rows else None, gen,
                    row0), generator, remat,
                per_row=(kv_len,) if kv_len is not None else (),
                shared=(pos_bias,), layer_draws=self._layer_draws)
            if arch.do_stable_layer_norm:
                x = layer_norm(self.encoder.layer_norm, x, eps)
            return x
        layerdrop = arch.layerdrop if self.training else 0.0
        t = x.shape[1]
        sp = sp_active(self.mesh, self.sequence_parallel)
        if sp:
            x = shard_time(x, self.mesh)
        for i, layer in enumerate(self.encoder.layers):
            # the LayerDrop draw precedes the layer's own, remat or not
            skip = (torch.rand((), generator=layers.shared_generator(
                generator), device=x.device) < layerdrop) \
                if layerdrop > 0.0 else None
            h = gather_time(x, self.mesh, t) if sp else x
            if remat:
                y = checkpointed(layer, generator, self._layer, h, pos_bias,
                                 kv_len, layer=i)
            else:
                y = layer(self._layer, h, pos_bias, kv_len, generator)
            if sp:
                y = shard_time(y, self.mesh)
            x = torch.where(skip, x, y) if skip is not None else y
        if sp:
            x = gather_time(x, self.mesh, t)
        if arch.do_stable_layer_norm:
            x = layer_norm(self.encoder.layer_norm, x, eps)
        return x
