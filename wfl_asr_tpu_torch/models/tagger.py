"""BIO phoneme tagger, the port of ``wfl_asr_tpu/models/tagger.py``:
``TaggerArch`` (with ``from_config``, the WavLM presets and
``model.encoder_arch_overrides``) and the ``BIOPhonemeTagger`` module, whose
``forward`` mirrors ``apply_tagger`` — in eval mode, or in training mode
(``model.train()``: dropout from an explicit ``torch.Generator``, LayerDrop,
BatchNorm batch statistics):

    audio [B, S], lang_id [B]
        → wav2vec2 normalize → WavLM encoder
          | Whisper log-mel → Whisper encoder
          | mel spectrogram (``encoder_type: none``: the mels are the
            hidden states, hidden size = n_mels)
        → trim-or-pad time to max_label_len (model.py:166-174)
        → lang embed concat + proj → BiLSTM → Conformer × N → dilated conv
        → logits [B, T, n_tags], offsets [B, T, 2]

``freeze_encoder`` runs the encoder under ``torch.no_grad()`` (so no
gradient reaches it, and the forward-only fused conv chains may run); the
train loop also leaves its parameters out of the optimizer, so they take
no update and no weight decay (apply_tagger :310-325 and the optax mask).
With ``encoder_type: none`` there is no encoder, and ``freeze_encoder``
changes nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.frontend import mel_spectrogram, wav2vec2_normalize, \
    wav2vec2_normalize_masked, whisper_log_mel
from ..utils.profiling import span
from . import heads as H
from .layers import linear
from .wavlm import WavLMArch, WavLMEncoder
from .whisper import WhisperArch, WhisperEncoder, whisper_arch_from_name

# Known WavLM checkpoint families → architecture presets (no network). The
# regularizer fields are the hub config.json values (feat_proj_dropout and
# attention_dropout 0.1, LayerDrop 0.05 base / 0.1 large), as in JAX.
WAVLM_PRESETS = {
    "base": WavLMArch(feat_proj_dropout=0.1, attention_dropout=0.1,
                      layerdrop=0.05),
    "base-plus": WavLMArch(feat_proj_dropout=0.1, attention_dropout=0.1,
                           layerdrop=0.05),
    # wavlm-large: per-layer LayerNorm AND biased convs (its config.json
    # sets conv_bias: true)
    "large": WavLMArch(hidden_size=1024, num_layers=24, num_heads=16,
                       intermediate_size=4096, feat_extract_norm="layer",
                       do_stable_layer_norm=True, conv_bias=True,
                       feat_proj_dropout=0.1, attention_dropout=0.1,
                       layerdrop=0.1),
}

# Fields of the JAX package's WavLMArch and WhisperArch that the port does
# not carry: the kernel switches (the port always runs its kernels). An
# ``encoder_arch_overrides`` entry naming one is dropped; any other key that
# is not a field of the encoder's arch raises.
JAX_ONLY_ARCH_KEYS = frozenset({"use_flash_attention", "use_fused_conv"})


def wavlm_arch_from_name(model_name: str) -> WavLMArch:
    """Preset for a WavLM checkpoint name, or a local HF checkpoint
    directory's ``config.json``."""
    from .hf_local import local_hf_arch
    local = local_hf_arch(model_name, "wavlm", "WavLMConfig",
                          WavLMArch, "model.wavlm_model")
    if local is not None:
        return local
    tail = model_name.split("/")[-1].removeprefix("wavlm-")
    if tail in WAVLM_PRESETS:
        return WAVLM_PRESETS[tail]
    for key in ("large", "base-plus", "base"):
        if key in tail:
            return WAVLM_PRESETS[key]
    raise ValueError(
        f"Unknown wavlm model {model_name!r}. Known presets: "
        f"{sorted(WAVLM_PRESETS)} (plus task-suffixed variants of each). "
        f"A local HF checkpoint DIRECTORY (with config.json) is also "
        f"accepted. For a custom architecture set "
        f"model.encoder_arch_overrides in the config (fields of WavLMArch).")


@dataclass(frozen=True)
class TaggerArch:
    """All static hyperparameters of the tagger."""
    encoder_type: str                 # "wavlm" | "whisper" | "none"
    num_labels: int
    num_languages: int
    hidden_size: int
    lang_emb_dim: int = 64
    enable_bilstm: bool = True
    bilstm_num_layers: int = 1
    num_conformer_layers: int = 2
    conformer_heads: int = 4
    conformer_ff_expansion: int = 4
    conformer_kernel: int = 31
    conformer_dropout: float = 0.1
    enable_dilated_conv: bool = True
    dilated_depth: int = 2
    dilated_kernel: int = 3
    freeze_encoder: bool = False
    # training.strict_attention_dropout: true attention-probability dropout
    # (HF WavLM attention_dropout, nn.MultiheadAttention(dropout=...)) in
    # training, in-kernel (K6), instead of the post-projection substitute;
    # inference is unaffected
    strict_attention_dropout: bool = False
    sample_rate: int = 16000
    frame_duration: float = 0.02
    n_mels: int = 80
    wavlm: Optional[WavLMArch] = None
    whisper: Optional[WhisperArch] = None

    @classmethod
    def from_config(cls, cfg, num_labels: int) -> "TaggerArch":
        """Build from a ``Config`` (defaults mirror the reference's
        model.py:57-142 ``.get`` sites)."""
        enc = cfg.encoder_type
        wavlm = whisper = None
        strict_attn = bool(cfg.raw.get("training", {})
                           .get("strict_attention_dropout", False))
        overrides = cfg.raw.get("model", {}).get("encoder_arch_overrides") or {}
        if enc == "whisper":
            whisper = _encoder_arch(enc, cfg.encoder_name, overrides,
                                    whisper_arch_from_name, WhisperArch)
            hidden = whisper.d_model
        elif enc == "wavlm":
            wavlm = _encoder_arch(enc, cfg.encoder_name, overrides,
                                  wavlm_arch_from_name, WavLMArch)
            if strict_attn:
                wavlm = replace(wavlm, strict_attention_dropout=True)
            hidden = wavlm.hidden_size
        elif enc in ("none", "null"):
            enc = "none"
            hidden = cfg.n_mels
        else:
            raise ValueError(
                "Unsupported encoder type. Use 'whisper', 'wavlm', or 'none'.")
        return cls(
            encoder_type=enc, num_labels=num_labels,
            num_languages=cfg.num_languages, hidden_size=hidden,
            lang_emb_dim=cfg.lang_emb_dim,
            enable_bilstm=cfg.enable_bilstm,
            bilstm_num_layers=cfg.bilstm_num_layers,
            num_conformer_layers=cfg.num_conformer_layers,
            conformer_heads=cfg.conformer_heads,
            conformer_ff_expansion=cfg.conformer_ff_expansion,
            conformer_kernel=cfg.conformer_kernel_size,
            conformer_dropout=cfg.conformer_dropout,
            enable_dilated_conv=cfg.enable_dilated_conv,
            dilated_depth=cfg.dilated_conv_depth,
            dilated_kernel=cfg.dilated_conv_kernel,
            freeze_encoder=cfg.freeze_encoder,
            strict_attention_dropout=strict_attn,
            sample_rate=cfg.sample_rate, frame_duration=cfg.frame_duration,
            n_mels=cfg.n_mels, wavlm=wavlm, whisper=whisper,
        )


def _encoder_arch(enc: str, name: str, overrides: dict, from_name, cls):
    """The encoder's arch: the named preset (or a local HF directory's
    config.json) with ``model.encoder_arch_overrides`` applied; an unknown
    name with overrides builds on the family default, with a warning."""
    try:
        arch = from_name(name)
    except ValueError:
        if not overrides:
            raise
        print(f"[WARN] Unknown {enc} model {name!r}: building from the "
              f"{cls.__name__} defaults + model.encoder_arch_overrides — "
              f"overrides must name every field that differs from the "
              f"defaults.")
        arch = cls()
    if overrides:
        known = {f.name for f in fields(cls)}
        unknown = set(overrides) - known - JAX_ONLY_ARCH_KEYS
        if unknown:
            raise ValueError(
                f"model.encoder_arch_overrides: unknown {cls.__name__} "
                f"field(s) {sorted(unknown)}")
        arch = replace(arch, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in overrides.items() if k in known})
    return arch


def _trim_or_pad(x: torch.Tensor, length: int) -> torch.Tensor:
    """Time-axis trim/zero-pad of [B, T, ...] to ``length``."""
    t = x.shape[1]
    if t > length:
        return x[:, :length]
    if t < length:
        pad = [0, 0] * (x.dim() - 2) + [0, length - t]
        return F.pad(x, pad)
    return x


class BIOPhonemeTagger(nn.Module):
    """Encoder + language conditioning + heads + classifiers under the
    reference ``BIOPhonemeTagger``'s state_dict keys (model.py:54-194)."""

    def __init__(self, arch: TaggerArch):
        super().__init__()
        self.arch = arch
        hd = arch.hidden_size
        if arch.encoder_type == "wavlm":
            self.encoder = WavLMEncoder(arch.wavlm)
        elif arch.encoder_type == "whisper":
            self.encoder = WhisperEncoder(arch.whisper)
        elif arch.encoder_type != "none":
            raise ValueError(f"unknown encoder_type {arch.encoder_type!r}")
        self.lang_emb = nn.Embedding(max(arch.num_languages, 1),
                                     arch.lang_emb_dim)
        self.lang_proj = nn.Linear(hd + arch.lang_emb_dim, hd)
        if arch.enable_bilstm:
            self.bilstm = nn.LSTM(hd, hd // 2, num_layers=arch.bilstm_num_layers,
                                  batch_first=True, bidirectional=True)
        self.conformer_layers = nn.ModuleList(
            H.ConformerBlock(hd, arch.conformer_heads,
                             arch.conformer_ff_expansion,
                             arch.conformer_kernel, arch.conformer_dropout,
                             arch.strict_attention_dropout)
            for _ in range(arch.num_conformer_layers))
        if arch.enable_dilated_conv:
            self.dilated_conv_stack = H.make_dilated_stack(
                hd, arch.dilated_depth, arch.dilated_kernel)
        self.classifier = nn.Linear(hd, arch.num_labels)
        self.boundary_offset_head = H.make_offset_head(hd)

    def jax_leaf_blocks(self) -> Dict[nn.Parameter, List[Tuple[int, int]]]:
        """The parameters that stack several of the JAX pytree's leaves, each
        with its leaves' row blocks: a Conformer layer's packed
        ``in_proj_weight`` [3D, D] and ``in_proj_bias`` [3D] are JAX's
        ``q``, ``k`` and ``v`` (models/convert.py). The optimizers take their
        per-leaf statistics over these blocks."""
        blocks = {}
        for layer in self.conformer_layers:
            att = layer.self_attn
            d = att.in_proj_weight.shape[1]
            rows = [(i * d, (i + 1) * d) for i in range(3)]
            blocks[att.in_proj_weight] = rows
            blocks[att.in_proj_bias] = rows
        return blocks

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        if self.arch.enable_bilstm:
            # after a move to the card: one weight buffer, which cuDNN would
            # otherwise compact on every call
            self.bilstm.flatten_parameters()
        return out

    def encode(self, audio, sample_mask=None, frame_mask=None,
               compute_dtype=torch.float32, pos_bias=None, generator=None,
               precentered: bool = False, remat: bool = False
               ) -> torch.Tensor:
        """Front end + encoder → hidden states [B, T_enc, H]; under
        ``freeze_encoder`` without autograd. The masks and ``pos_bias``
        reach the WavLM encoder only; ``precentered`` (rows the host
        reflect-padded at their exact length) the mel front end of
        ``encoder_type: none`` only; ``remat`` (gradient checkpointing of
        the encoder layers) the WavLM and Whisper encoders."""
        arch = self.arch
        if arch.encoder_type == "none":
            hop = int(arch.frame_duration * arch.sample_rate)
            return mel_spectrogram(audio, arch.sample_rate, 400, hop,
                                   arch.n_mels, center=not precentered
                                   ).to(compute_dtype)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not arch.freeze_encoder):
            if arch.encoder_type == "whisper":
                feats = whisper_log_mel(audio,
                                        n_mels=arch.whisper.num_mel_bins)
                return self.encoder(feats, compute_dtype=compute_dtype,
                                    generator=generator, remat=remat)
            if sample_mask is not None:
                normed = wav2vec2_normalize_masked(audio, sample_mask)
            else:
                normed = wav2vec2_normalize(audio)
            return self.encoder(normed, mask=frame_mask,
                                sample_mask=sample_mask,
                                compute_dtype=compute_dtype,
                                pos_bias=pos_bias, generator=generator,
                                remat=remat)

    def forward(self, audio: torch.Tensor, lang_id: Optional[torch.Tensor],
                max_label_len: Optional[int] = None,
                sample_mask: Optional[torch.Tensor] = None,
                frame_mask: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32,
                pos_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                precentered: bool = False, remat: bool = False):
        """Returns (logits [B, T, n_tags], offsets [B, T, 2]) at the compute
        dtype. ``sample_mask`` [B, S] / ``frame_mask`` [B, T_enc]: bucketed
        inference with exact-length numerics on valid frames.
        ``generator``: the dropout draws in training mode (on the
        model's device). ``precentered``, ``remat``: see :meth:`encode`."""
        with span("wfl.encoder"):
            hidden = self.encode(audio, sample_mask, frame_mask,
                                 compute_dtype, pos_bias, generator,
                                 precentered, remat)
        return self.heads(hidden, lang_id, max_label_len, frame_mask,
                          generator)

    def heads(self, hidden: torch.Tensor, lang_id: Optional[torch.Tensor],
              max_label_len: Optional[int] = None,
              frame_mask: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Language conditioning through the offset head over the encoder's
        hidden states [B, T_enc, H] → (logits, offsets), as :meth:`forward`'s."""
        arch = self.arch
        with span("wfl.heads"):
            if max_label_len is not None:
                hidden = _trim_or_pad(hidden, int(max_label_len))
                if frame_mask is not None:
                    frame_mask = _trim_or_pad(frame_mask, int(max_label_len))
            if lang_id is not None:
                hidden = H.lang_conditioning(self.lang_emb, self.lang_proj,
                                             hidden, lang_id)
            if arch.enable_bilstm:
                with span("wfl.bilstm"):
                    hidden = H.bilstm(self.bilstm, hidden, mask=frame_mask)
            out = hidden
            for block in self.conformer_layers:
                out = block(out, mask=frame_mask, generator=generator)
            if arch.enable_dilated_conv:
                out = H.dilated_stack(self.dilated_conv_stack, out,
                                      arch.dilated_kernel, mask=frame_mask)
            logits = linear(self.classifier, out)
            offsets = H.offset_head(self.boundary_offset_head, out,
                                    mask=frame_mask)
        return logits, offsets


@torch.no_grad()
def init_tagger(arch: TaggerArch, generator: torch.Generator,
                device="cpu") -> BIOPhonemeTagger:
    """A tagger with random weights drawn from ``generator`` (torch default
    init bounds: U(±1/√fan_in) for linears and convs, U(±1/√hidden) for the
    LSTM, N(0, 1) for the language embedding, N(0, 0.02) for the bucket
    table; norms at 1/0; Whisper's position table its sinusoids, as in
    JAX), built on ``device``."""
    model = BIOPhonemeTagger(arch)

    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            fan_in = mod.weight[0].numel()
            uniform_(mod.weight, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                uniform_(mod.bias, 1.0 / math.sqrt(fan_in))
        elif isinstance(mod, nn.LSTM):
            for p in mod.parameters():
                uniform_(p, 1.0 / math.sqrt(mod.hidden_size))
        elif isinstance(mod, nn.Embedding):
            if name.endswith("embed_positions"):
                continue            # the sinusoids WhisperEncoder set
            std = 0.02 if name.endswith("rel_attn_embed") else 1.0
            mod.weight.copy_(torch.randn(mod.weight.shape,
                                         generator=generator) * std)
        elif isinstance(mod, H.PackedSelfAttention):
            uniform_(mod.in_proj_weight,
                     1.0 / math.sqrt(mod.in_proj_weight.shape[1]))
            uniform_(mod.in_proj_bias,
                     1.0 / math.sqrt(mod.in_proj_weight.shape[1]))
    return model.to(device).eval()
