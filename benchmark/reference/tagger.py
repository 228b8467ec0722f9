"""The WFL-ASR tagger over an encoder, in plain float32 ``torch``.

    audio [B, S], language id [B]
      → encoder (WavLM on normalized audio, or Whisper on its log-mel)
      → time cut or zero-padded to the label length (training)
      → [hidden ; language embedding] → linear back to hidden
      → 2-layer bidirectional LSTM (hidden/2 a direction)
      → Conformer blocks: x + ½·FF(x); x = LN(x + MHSA(x)) (post-LN);
        x + ConvModule(LN(x)); x + ½·FF(x), no final LayerNorm. FF is
        LN → linear ×e → GELU → linear; the conv module a 1×1 conv to 2C,
        GLU, a full (not depthwise) conv of kernel 31, BatchNorm, GELU, a
        1×1 conv
      → dilated convs (kernel 3, dilation 2^i, ReLU)
      → classifier logits [B, T, n_tags]; boundary offsets [B, T, 2]
        (conv k3 → GELU → conv 1×1 → sigmoid)

Names are the WFL-ASR checkpoint's (``conformer_layers.{i}.ff1.net.{0,1,4}``,
``self_attn.in_proj_weight``, ``conv.{0,2,3,5}``, ``dilated_conv_stack.{2j}``,
``boundary_offset_head.{0,2}``).

Dropout (training only): the Conformer's at ``conformer_dropout``, after
each FF module's GELU and output, after the attention and after the conv
module. Departure from WFL-ASR's ``nn.MultiheadAttention(dropout=...)``:
the probabilities are not dropped, the attention's output is, as the
system under test does by default (``strict_attention_dropout`` false).
The keep masks are data (:class:`DropFeed`): the reference cannot repeat
another program's random stream, so it takes the draws it is given, or
draws its own from a seed. The encoders have no dropout here: the
benchmark trains only Whisper-base, whose published rates are 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .encoders import WavLM, Whisper, _attend, _heads, _merge, sinusoids
from .frontend import wav2vec2_normalize, whisper_log_mel


class DropFeed:
    """The keep masks of one run of updates, by (update, site): set
    ``step`` before each update's forward. A missing mask is drawn from
    ``generator`` (U[0, 1) ≥ rate) and kept, so that a second run over the
    same feed (the control, a fault) drops the same elements."""

    def __init__(self, draws=None, generator=None):
        self.draws = dict(draws or {})
        self.generator, self.step = generator, 0
        # masks given that do not fit the reference's tensor there (they
        # are replaced by draws of the generator)
        self.misfits = 0


class Drop(nn.Module):
    """Inverted dropout: x · keep / (1 − rate), ``keep`` from the feed at
    (its update, this site). A run over part of the batch takes the mask's
    first rows. The identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate, self.site, self.feed = rate, None, None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        key = (self.feed.step, self.site)
        keep = self.feed.draws.get(key)
        if keep is not None and (keep.shape[0] < x.shape[0]
                                 or keep.shape[1:] != x.shape[1:]):
            self.feed.misfits += 1
            keep = None
        if keep is None:
            keep = torch.rand(x.shape, generator=self.feed.generator,
                              device=x.device) >= self.rate
            self.feed.draws[key] = keep
        keep = keep[:x.shape[0]].to(x.device, x.dtype)
        return x * keep / (1.0 - self.rate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, expansion: int, rate: float):
        super().__init__()
        self.net = nn.Sequential(
            nn.LayerNorm(dim), nn.Linear(dim, dim * expansion), nn.GELU(),
            Drop(rate), nn.Linear(dim * expansion, dim), Drop(rate))

    def forward(self, x):
        return self.net(x)


class Conformer(nn.Module):
    def __init__(self, dim: int, heads: int, expansion: int, kernel: int,
                 rate: float):
        super().__init__()
        self.heads, self.kernel = heads, kernel
        self.ff1 = FeedForward(dim, expansion, rate)
        self.ff2 = FeedForward(dim, expansion, rate)
        self.drop_attn, self.drop_conv = Drop(rate), Drop(rate)
        self.self_attn = nn.MultiheadAttention(dim, heads, batch_first=True)
        self.ln1 = nn.LayerNorm(dim)
        self.ln2 = nn.LayerNorm(dim)
        self.conv = nn.Sequential(
            nn.Conv1d(dim, 2 * dim, 1), nn.GLU(dim=1),
            nn.Conv1d(dim, dim, kernel, padding=kernel // 2),
            nn.BatchNorm1d(dim), nn.GELU(), nn.Conv1d(dim, dim, 1))

    def _mhsa(self, x):
        att = self.self_attn
        q, k, v = F.linear(x, att.in_proj_weight,
                           att.in_proj_bias).chunk(3, dim=-1)
        out = _attend(_heads(q, self.heads), _heads(k, self.heads),
                      _heads(v, self.heads))
        return att.out_proj(_merge(out))

    def drops(self):
        """The drop sites in the order a forward meets them."""
        return [self.ff1.net[3], self.ff1.net[5], self.drop_attn,
                self.drop_conv, self.ff2.net[3], self.ff2.net[5]]

    def forward(self, x):
        x = x + 0.5 * self.ff1(x)
        x = self.ln1(x + self.drop_attn(self._mhsa(x)))
        x = x + self.drop_conv(
            self.conv(self.ln2(x).transpose(1, 2)).transpose(1, 2))
        return x + 0.5 * self.ff2(x)


class Tagger(nn.Module):
    def __init__(self, cfg: dict, num_labels: int, num_languages: int,
                 checkpoint_layers: bool = False):
        """``cfg``: a configuration file's content: the encoder's
        ``config.json`` keys at the top level, ``encoder_type`` and the
        ``heads``."""
        super().__init__()
        self.kind = cfg["encoder_type"]
        enc_cfg, h = cfg, cfg["heads"]
        if self.kind == "wavlm":
            self.encoder = WavLM(enc_cfg, checkpoint_layers)
            hid = enc_cfg["hidden_size"]
        elif self.kind == "whisper":
            self.encoder = Whisper(enc_cfg, checkpoint_layers)
            hid = enc_cfg["d_model"]
        else:
            raise ValueError(f"encoder_type {self.kind!r}")
        self.hidden = hid
        self.lang_emb = nn.Embedding(max(num_languages, 1),
                                     h["lang_emb_dim"])
        self.lang_proj = nn.Linear(hid + h["lang_emb_dim"], hid)
        self.bilstm = nn.LSTM(hid, hid // 2, num_layers=h["bilstm_num_layer"],
                              batch_first=True, bidirectional=True)
        self.conformer_layers = nn.ModuleList(
            Conformer(hid, h["conformer_heads"], h["conformer_ff_expansion"],
                      h["conformer_kernel_size"], h["conformer_dropout"])
            for _ in range(h["num_conformer_layers"]))
        # the sites that drop, numbered in the order a forward meets them
        self.drop_sites = [d for block in self.conformer_layers
                           for d in block.drops() if d.rate > 0.0]
        for i, d in enumerate(self.drop_sites):
            d.site = i
        mods, k = [], h["dilated_conv_kernel"]
        for i in range(h["dilated_conv_depth"]):
            mods += [nn.Conv1d(hid, hid, k, dilation=2 ** i,
                               padding=2 ** i * (k - 1) // 2), nn.ReLU()]
        self.dilated_conv_stack = nn.Sequential(*mods)
        self.classifier = nn.Linear(hid, num_labels)
        self.boundary_offset_head = nn.Sequential(
            nn.Conv1d(hid, hid, 3, padding=1), nn.GELU(),
            nn.Conv1d(hid, 2, 1), nn.Sigmoid())

    def set_feed(self, feed: DropFeed) -> None:
        for d in self.drop_sites:
            d.feed = feed

    def num_frames(self, num_samples: int) -> int:
        return self.encoder.num_frames(num_samples)

    def forward(self, audio: torch.Tensor, lang_id: torch.Tensor,
                max_label_len: int = None):
        """audio [B, S] float; → (logits [B, T, n], offsets [B, T, 2])."""
        if self.kind == "wavlm":
            x = self.encoder(wav2vec2_normalize(audio))
        else:
            x = self.encoder(whisper_log_mel(
                audio.float(), self.encoder.c["num_mel_bins"]).to(audio.dtype))
        if max_label_len is not None:
            t = x.shape[1]
            x = (x[:, :max_label_len] if t >= max_label_len
                 else F.pad(x, (0, 0, 0, max_label_len - t)))
        e = self.lang_emb(lang_id.long())[:, None, :].expand(
            -1, x.shape[1], -1)
        x = self.lang_proj(torch.cat([x, e], dim=-1))
        x, _ = self.bilstm(x)
        for block in self.conformer_layers:
            x = block(x)
        x = self.dilated_conv_stack(x.transpose(1, 2)).transpose(1, 2)
        logits = self.classifier(x)
        offsets = self.boundary_offset_head(x.transpose(1, 2)).transpose(1, 2)
        return logits, offsets


# ---------------------------------------------------------------------------
# Weights: what the benchmark draws, and the checkpoint's names
# ---------------------------------------------------------------------------

# the classifier's rows are drawn at this multiple of the default bound, so
# that most frames clear the confidence gate, as a trained tagger's do
CLASSIFIER_GAIN = 60.0


def weight_spec(model: Tagger) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) for every entry of the state dict:
    kind "uniform" (U(±scale)), "normal" (N(0, scale²)), "fill" (all
    ``scale``), "sinusoid" (Whisper's position table). Bounds are torch's
    defaults: 1/√fan_in for linears and convs, 1/√hidden for the LSTM;
    N(0, 1) for the language embedding, N(0, 0.02²) for WavLM's bucket
    table; norms and BatchNorm statistics at 1 and 0."""
    spec, state = [], model.state_dict()
    for name, t in state.items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("embed_positions.weight"):
            spec.append((name, shape, "sinusoid", 0.0))
        elif name.endswith("rel_attn_embed.weight"):
            spec.append((name, shape, "normal", 0.02))
        elif name.startswith("lang_emb."):
            spec.append((name, shape, "normal", 1.0))
        elif name.startswith("bilstm."):
            spec.append((name, shape, "uniform",
                         1.0 / math.sqrt(model.hidden // 2)))
        elif leaf in ("running_var", "gru_rel_pos_const"):
            spec.append((name, shape, "fill", 1.0))
        elif leaf in ("running_mean", "num_batches_tracked"):
            spec.append((name, shape, "fill", 0.0))
        elif len(shape) == 1 and _is_norm(model, name):
            spec.append((name, shape, "fill",
                         1.0 if leaf == "weight" else 0.0))
        else:
            weight = name[:-len(leaf)] + ("weight" if leaf != "in_proj_bias"
                                          else "in_proj_weight")
            w = state[weight] if leaf.endswith("bias") else t
            fan_in = int(np.prod(w.shape[1:]))
            bound = 1.0 / math.sqrt(fan_in)
            if name.startswith("classifier."):
                bound *= CLASSIFIER_GAIN
            spec.append((name, shape, "uniform", bound))
    return spec


def _is_norm(model: Tagger, name: str) -> bool:
    mod = model.get_submodule(name.rsplit(".", 1)[0])
    return isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d))


def fill_sinusoid(shape) -> torch.Tensor:
    return torch.from_numpy(sinusoids(shape[0], shape[1]))


POS_CONV = "encoder.encoder.pos_conv_embed.conv."


def export_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This module's state dict → a WFL-ASR checkpoint's: the same names,
    but WavLM's position convolution under its weight-norm names
    (``original0`` the norm over all but the kernel axis, ``original1`` the
    weight itself)."""
    out = {}
    for name, t in state.items():
        if name == POS_CONV + "weight":
            w = t.detach().float().cpu()
            out[POS_CONV + "parametrizations.weight.original0"] = \
                w.square().sum(dim=(0, 1), keepdim=True).sqrt()
            out[POS_CONV + "parametrizations.weight.original1"] = w
        else:
            out[name] = t
    return out
