"""Whisper encoder in PyTorch, the port of ``wfl_asr_tpu/models/whisper.py``.

Module names follow HF ``WhisperEncoder`` so the reference checkpoint's keys
load unchanged (``conv1``, ``conv2``, ``embed_positions.weight``,
``layers.{i}.self_attn.{q,k,v,out}_proj`` with no bias on ``k_proj``,
``self_attn_layer_norm``, ``fc1``, ``fc2``, ``final_layer_norm``,
``layer_norm``).

The forward is the JAX package's ``whisper_encode`` with its kernel on:
log-mel [B, n_mels, 3000] → the conv stem (k=3 pad 1; k=3 stride 2 pad 1,
exact GELU after each) → + the position table → pre-LN layers whose
attention is ``flash_attention_trainable`` (bias-free, no key mask, no
dropout; head_dim 64 in every preset) → the final LayerNorm → [B, 1500, D].
The position table is a trained parameter, as in the JAX package (HF keeps
it frozen). In training mode (``module.train()``) dropout, activation
dropout and LayerDrop follow whisper.py:177-272, drawing from the
``generator`` passed in; LayerDrop computes every layer and selects.
With ``remat`` each layer runs under ``layers.checkpointed``
(whisper.py:204-222), its draws the same as without. Under pipeline
parallelism (``self.pipeline``, set by ``parallel.pp.shard_params_pp``)
the layers run through ``parallel.pp.pipelined_layers`` (whisper.py:161-
202); sequence parallelism shards the time axis between layers
(``parallel/sp.py``). Parameters stay f32 and are cast to the compute
dtype at use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.kernels.flash_attention_bwd import flash_attention_trainable
from ..parallel import pp
from ..parallel.sp import gather_time, shard_time, sp_active
from .layers import checkpointed, conv1d, dropout, gelu, layer_norm, \
    linear, shared_generator


@dataclass(frozen=True)
class WhisperArch:
    """Encoder hyperparameters (defaults = whisper-base), under the JAX
    package's names and defaults; its kernel switch is dropped by
    ``TaggerArch.from_config`` (the port always runs its kernels)."""
    d_model: int = 512
    num_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    dropout: float = 0.0
    activation_dropout: float = 0.0
    layerdrop: float = 0.0                    # whole-batch layer skip

    @classmethod
    def from_hf_config(cls, hf) -> "WhisperArch":
        return cls(d_model=hf.d_model, num_layers=hf.encoder_layers,
                   num_heads=hf.encoder_attention_heads,
                   ffn_dim=hf.encoder_ffn_dim, num_mel_bins=hf.num_mel_bins,
                   max_source_positions=hf.max_source_positions,
                   dropout=hf.dropout, activation_dropout=hf.activation_dropout,
                   layerdrop=hf.encoder_layerdrop)


# Every released encoder (d_model, layers, heads, ffn; 128 mel bins from
# large-v3 on). Unknown names raise rather than map to the nearest size.
WHISPER_PRESETS = {
    "tiny": WhisperArch(384, 4, 6, 1536),
    "base": WhisperArch(512, 6, 8, 2048),
    "small": WhisperArch(768, 12, 12, 3072),
    "medium": WhisperArch(1024, 24, 16, 4096),
    "large": WhisperArch(1280, 32, 20, 5120),
    "large-v1": WhisperArch(1280, 32, 20, 5120),
    "large-v2": WhisperArch(1280, 32, 20, 5120),
    "large-v3": WhisperArch(1280, 32, 20, 5120, num_mel_bins=128),
    "large-v3-turbo": WhisperArch(1280, 32, 20, 5120, num_mel_bins=128),
    "turbo": WhisperArch(1280, 32, 20, 5120, num_mel_bins=128),
}


def whisper_arch_from_name(model_name: str) -> WhisperArch:
    """Preset for names like "openai/whisper-base", "whisper-small.en" or
    "whisper-large-v3-turbo", or a local HF checkpoint directory's
    ``config.json``. Unknown names raise with the preset list."""
    from .hf_local import local_hf_arch
    local = local_hf_arch(model_name, "whisper", "WhisperConfig",
                          WhisperArch, "model.whisper_model")
    if local is not None:
        return local
    tail = model_name.split("/")[-1].removeprefix("whisper-")
    size = tail.split(".")[0]            # drop the ".en" language suffix
    if size not in WHISPER_PRESETS:
        raise ValueError(
            f"Unknown whisper variant {model_name!r}. Known presets: "
            f"{sorted(WHISPER_PRESETS)}. A local HF checkpoint DIRECTORY "
            f"(with config.json) is also accepted. For a custom "
            f"architecture set model.encoder_arch_overrides in the config "
            f"(fields of WhisperArch, e.g. d_model/num_layers/num_mel_bins).")
    return WHISPER_PRESETS[size]


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoid table [length, channels] f32 (log-spaced
    timescales, [sin | cos])."""
    log_timescale_increment = math.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment
                            * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


class WhisperAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class WhisperEncoderLayer(nn.Module):
    def __init__(self, arch: WhisperArch):
        super().__init__()
        d = arch.d_model
        self.self_attn = WhisperAttention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, arch.ffn_dim)
        self.fc2 = nn.Linear(arch.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d)

    def forward(self, run, *args):
        """``run(self, *args)``: the encoder's layer function, called through
        the module so that hooks on the layer run (FSDP's gathers)."""
        return run(self, *args)


class WhisperEncoder(nn.Module):
    """HF ``WhisperEncoder``: log-mel [B, n_mels, 3000] → [B, 1500, D]."""

    def __init__(self, arch: WhisperArch):
        super().__init__()
        self.arch = arch
        d = arch.d_model
        self.conv1 = nn.Conv1d(arch.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(arch.max_source_positions, d)
        with torch.no_grad():
            self.embed_positions.weight.copy_(torch.from_numpy(
                sinusoidal_positions(arch.max_source_positions, d)))
        self.layers = nn.ModuleList(WhisperEncoderLayer(arch)
                                    for _ in range(arch.num_layers))
        self.layer_norm = nn.LayerNorm(d)
        # the parallel.mesh.Mesh of a sharded run (set by parallel.tp), and
        # sequence parallelism between layers (parallel/sp.py)
        self.mesh = None
        self.sequence_parallel = False
        # pipeline parallelism over the layers (parallel/pp.py)
        self.pipeline = None

    def _layer(self, layer: WhisperEncoderLayer, x: torch.Tensor,
               generator) -> torch.Tensor:
        """One pre-LN layer (whisper.py:238-272)."""
        arch = self.arch
        b, t, d = x.shape
        att = layer.self_attn
        mp = self.mesh.model_size if self.mesh is not None else 1
        heads = arch.num_heads // mp              # this rank's heads

        def split(h):
            return h.reshape(b, t, heads, -1).transpose(1, 2).contiguous()

        h = layer_norm(layer.self_attn_layer_norm, x)
        attn = flash_attention_trainable(split(linear(att.q_proj, h)),
                                         split(linear(att.k_proj, h)),
                                         split(linear(att.v_proj, h)))
        attn = linear(att.out_proj,
                      attn.transpose(1, 2).reshape(b, t, d // mp))
        x = x + dropout(attn, arch.dropout, generator, self.training)

        h = gelu(linear(layer.fc1, layer_norm(layer.final_layer_norm, x)))
        h = dropout(h, arch.activation_dropout, generator, self.training)
        h = dropout(linear(layer.fc2, h), arch.dropout, generator,
                    self.training)
        return x + h

    def forward(self, input_features: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """``input_features`` [B, n_mels, 3000] → [B, 1500, D] at the
        compute dtype. ``generator``: the dropout and LayerDrop draws in
        training mode. ``remat``: each layer under
        ``layers.checkpointed``."""
        arch = self.arch
        x = input_features.to(compute_dtype)
        x = gelu(conv1d(self.conv1, x, padding=1))
        x = gelu(conv1d(self.conv2, x, stride=2, padding=1))
        x = x.transpose(1, 2)                                   # [B, T, D]
        x = x + self.embed_positions.weight.to(compute_dtype)[None,
                                                              :x.shape[1]]
        x = dropout(x, arch.dropout, generator, self.training)
        if self.pipeline is not None:
            x = pp.pipelined_layers(
                self, x, lambda layer, h, rows, shr, gen, row0: layer(
                    self._layer, h, gen), generator, remat)
            return layer_norm(self.layer_norm, x)
        layerdrop = arch.layerdrop if self.training else 0.0
        t = x.shape[1]
        sp = sp_active(self.mesh, self.sequence_parallel)
        if sp:
            x = shard_time(x, self.mesh)
        for i, layer in enumerate(self.layers):
            # the LayerDrop draw precedes the layer's own, remat or not
            skip = (torch.rand((), generator=shared_generator(generator),
                               device=x.device) < layerdrop) \
                if layerdrop > 0.0 else None
            h = gather_time(x, self.mesh, t) if sp else x
            if remat:
                y = checkpointed(layer, generator, self._layer, h, layer=i)
            else:
                y = layer(self._layer, h, generator)
            if sp:
                y = shard_time(y, self.mesh)
            x = torch.where(skip, x, y) if skip is not None else y
        if sp:
            x = gather_time(x, self.mesh, t)
        return layer_norm(self.layer_norm, x)
