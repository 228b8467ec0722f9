"""WavLM and Whisper encoders in plain float32 ``torch``.

Parameter names are those of the published checkpoints (Hugging Face
``WavLMModel`` and ``WhisperEncoder``), so a WFL-ASR checkpoint's
``encoder.*`` entries map one to one (:func:`export_state`).

WavLM (Chen et al. 2022, microsoft/wavlm-base-plus ``config.json``):
seven convolutions (kernel 10,3,3,3,3,2,2, stride 5,2,2,2,2,2,2, 512
channels, no bias), a GroupNorm of one channel a group after the first,
exact GELU after each; LayerNorm and a linear projection to the hidden
size; a grouped convolutional position embedding (kernel 128, 16 groups,
padding 64, the last frame dropped, GELU) added to it; LayerNorm; then
post-LN transformer layers whose attention adds a relative position bias
(320 T5-style buckets, largest distance 800, a table in the first layer
shared by every layer), gated per query and head by
``sigmoid(a)·(sigmoid(b)·c − 1) + 2`` where ``a``, ``b`` are sums of four
of the eight outputs of a per-head linear map of the query's input.
Departure: the bucket index's logarithm is taken in float64 (the
published code takes it in float32; the two differ only where a distance
falls on a bucket edge to rounding).

Whisper (Radford et al. 2022, openai/whisper-base ``config.json``): two
convolutions (kernel 3, the second of stride 2) with GELU, sinusoidal
positions, pre-LN layers (the key projection without bias), a final
LayerNorm.

``checkpoint_layers`` recomputes each transformer layer in the backward
pass (``torch.utils.checkpoint``): the same arithmetic, less memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def rel_position_buckets(length: int, num_buckets: int = 320,
                         max_distance: int = 800) -> np.ndarray:
    half = num_buckets // 2
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    buckets = (rel > 0).astype(np.int64) * half
    dist = np.abs(rel)
    exact = half // 2
    far = exact + (np.log(np.maximum(dist, 1) / exact)
                   / math.log(max_distance / exact)
                   * (half - exact)).astype(np.int64)
    far = np.minimum(far, half - 1)
    return buckets + np.where(dist < exact, dist, far)


def _attend(q, k, v, bias=None):
    """q, k, v [B, H, T, D]; bias [B or 1, H, T, T] added to the scaled
    scores."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


class _Module(nn.Module):
    pass


class WavLM(nn.Module):
    def __init__(self, c: dict, checkpoint_layers: bool = False):
        super().__init__()
        self.c, self.ckpt = c, checkpoint_layers
        dims, ks, ss = c["conv_dim"], c["conv_kernel"], c["conv_stride"]
        self.feature_extractor = _Module()
        self.feature_extractor.conv_layers = nn.ModuleList()
        for i, (d, k, s) in enumerate(zip(dims, ks, ss)):
            layer = _Module()
            layer.conv = nn.Conv1d(1 if i == 0 else dims[i - 1], d, k,
                                   stride=s, bias=c["conv_bias"])
            if i == 0:
                layer.layer_norm = nn.GroupNorm(d, d)
            self.feature_extractor.conv_layers.append(layer)
        hid = c["hidden_size"]
        self.feature_projection = _Module()
        self.feature_projection.layer_norm = nn.LayerNorm(dims[-1])
        self.feature_projection.projection = nn.Linear(dims[-1], hid)
        enc = self.encoder = _Module()
        enc.pos_conv_embed = _Module()
        kpos = c["num_conv_pos_embeddings"]
        enc.pos_conv_embed.conv = nn.Conv1d(
            hid, hid, kpos, padding=kpos // 2,
            groups=c["num_conv_pos_embedding_groups"])
        enc.layer_norm = nn.LayerNorm(hid, eps=c["layer_norm_eps"])
        enc.layers = nn.ModuleList()
        heads = c["num_attention_heads"]
        for i in range(c["num_hidden_layers"]):
            layer = _Module()
            att = layer.attention = _Module()
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(att, n, nn.Linear(hid, hid))
            att.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
            att.gru_rel_pos_linear = nn.Linear(hid // heads, 8)
            if i == 0:
                att.rel_attn_embed = nn.Embedding(c["num_buckets"], heads)
            layer.layer_norm = nn.LayerNorm(hid, eps=c["layer_norm_eps"])
            ff = layer.feed_forward = _Module()
            ff.intermediate_dense = nn.Linear(hid, c["intermediate_size"])
            ff.output_dense = nn.Linear(c["intermediate_size"], hid)
            layer.final_layer_norm = nn.LayerNorm(hid,
                                                  eps=c["layer_norm_eps"])
            enc.layers.append(layer)

    def num_frames(self, num_samples: int) -> int:
        n = num_samples
        for k, s in zip(self.c["conv_kernel"], self.c["conv_stride"]):
            n = (n - k) // s + 1
        return max(n, 0)

    def position_bias(self, t: int, device) -> torch.Tensor:
        table = self.encoder.layers[0].attention.rel_attn_embed.weight
        idx = torch.from_numpy(rel_position_buckets(
            t, self.c["num_buckets"], self.c["max_bucket_distance"])
        ).to(device)
        return table[idx].permute(2, 0, 1)[None]              # [1, H, T, T]

    def _layer(self, layer, x, bias):
        att, heads = layer.attention, self.c["num_attention_heads"]
        b, t, hid = x.shape
        xh = _heads(x, heads)                                 # [B, H, T, d]
        g = att.gru_rel_pos_linear(xh).reshape(b, heads, t, 2, 4).sum(-1)
        g = torch.sigmoid(g)
        gate = g[..., :1] * (g[..., 1:] * att.gru_rel_pos_const - 1.0) + 2.0
        out = _attend(_heads(att.q_proj(x), heads),
                      _heads(att.k_proj(x), heads),
                      _heads(att.v_proj(x), heads), gate * bias)
        x = layer.layer_norm(x + att.out_proj(_merge(out)))
        ff = layer.feed_forward
        h = ff.output_dense(F.gelu(ff.intermediate_dense(x)))
        return layer.final_layer_norm(x + h)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, S], already normalized → [B, T, hidden]."""
        x = audio[:, None, :]
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            x = layer.conv(x)
            if i == 0:
                x = layer.layer_norm(x)
            x = F.gelu(x)
        x = x.transpose(1, 2)
        x = self.feature_projection.projection(
            self.feature_projection.layer_norm(x))
        pos = self.encoder.pos_conv_embed.conv(x.transpose(1, 2))
        if self.c["num_conv_pos_embeddings"] % 2 == 0:
            pos = pos[:, :, :-1]
        x = self.encoder.layer_norm(x + F.gelu(pos).transpose(1, 2))
        bias = self.position_bias(x.shape[1], x.device)
        for layer in self.encoder.layers:
            if self.ckpt and torch.is_grad_enabled():
                x = checkpoint(self._layer, layer, x, bias,
                               use_reentrant=False)
            else:
                x = self._layer(layer, x, bias)
        return x


def sinusoids(length: int, channels: int) -> np.ndarray:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class Whisper(nn.Module):
    def __init__(self, c: dict, checkpoint_layers: bool = False):
        super().__init__()
        self.c, self.ckpt = c, checkpoint_layers
        d = c["d_model"]
        self.conv1 = nn.Conv1d(c["num_mel_bins"], d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(c["max_source_positions"], d)
        self.layers = nn.ModuleList()
        for _ in range(c["encoder_layers"]):
            layer = _Module()
            att = layer.self_attn = _Module()
            att.q_proj = nn.Linear(d, d)
            att.k_proj = nn.Linear(d, d, bias=False)
            att.v_proj = nn.Linear(d, d)
            att.out_proj = nn.Linear(d, d)
            layer.self_attn_layer_norm = nn.LayerNorm(d)
            layer.fc1 = nn.Linear(d, c["encoder_ffn_dim"])
            layer.fc2 = nn.Linear(c["encoder_ffn_dim"], d)
            layer.final_layer_norm = nn.LayerNorm(d)
            self.layers.append(layer)
        self.layer_norm = nn.LayerNorm(d)

    def num_frames(self, num_samples: int) -> int:
        return self.c["max_source_positions"]

    def _layer(self, layer, x):
        att, heads = layer.self_attn, self.c["encoder_attention_heads"]
        h = layer.self_attn_layer_norm(x)
        out = _attend(_heads(att.q_proj(h), heads),
                      _heads(att.k_proj(h), heads),
                      _heads(att.v_proj(h), heads))
        x = x + att.out_proj(_merge(out))
        h = layer.fc2(F.gelu(layer.fc1(layer.final_layer_norm(x))))
        return x + h

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """log-mel [B, n_mels, 3000] → [B, 1500, d_model]."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.embed_positions.weight[None, :x.shape[1]]
        for layer in self.layers:
            if self.ckpt and torch.is_grad_enabled():
                x = checkpoint(self._layer, layer, x, use_reentrant=False)
            else:
                x = self._layer(layer, x)
        return self.layer_norm(x)
