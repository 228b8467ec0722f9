"""Operations and bytes, worked out from a configuration's shapes, and the
least time they need on the chip (``peaks.json``).

Model FLOPs count the multiply-adds of the products (linear layers,
convolutions, attention's two products, the LSTM's gate products) as two
operations each; element-wise work is not counted. A forward is counted at
an item's true length: padding is waste and is not counted. Whisper's
forward is defined on 30 s of audio (1500 frames), so it counts 1500
frames whatever the item's length. Training counts three forwards (the
forward and a backward of twice its work) at an item's true length.

Kernel bounds follow the kernel table's arithmetic: attention's forward
is 4·H·T·K·D operations (QKᵀ and PV over the valid keys K), its backward
five products (S, dP, dV, dK, dQ); each input byte is read once and each
output byte written once.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "peaks.json")) as f:
    PEAKS = json.load(f)


def peak_flops(dtype: str) -> float:
    return PEAKS["flops"][dtype]


def bound_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(least seconds, "operations" or "bytes")."""
    t_ops = flops / peak_flops(dtype)
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def conv_out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def attention_fwd(b: int, h: int, t: int, d: int, valid_keys: float,
                  elem: int, bias: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward over [b, h, t, d]; ``valid_keys``:
    the sum over the batch of each row's valid keys."""
    flops = 4.0 * h * t * valid_keys * d
    nbytes = 4.0 * b * h * t * d * elem + 4 * b
    if bias:
        nbytes += h * t * t * elem + b * h * t * 4
    return flops, nbytes


def attention_bwd(b: int, h: int, t: int, d: int, valid_keys: float,
                  elem: int, bias: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one backward: five products; q, k, v, out, dout
    read, dq, dk, dv written, the LSE and its delta."""
    flops = 5 * 2.0 * h * t * valid_keys * d
    nbytes = 8.0 * b * h * t * d * elem + 2 * b * h * t * 4 + 4 * b
    if bias:
        nbytes += h * t * t * elem + h * t * t * 4 + 2 * b * h * t * 4
    return flops, nbytes


def conv_chain(b: int, t_in: int, c: int, kernels, elem: int
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) of a chain of stride-2 convolutions of c channels
    over [b, t_in, c]: the input read, the last output written, the
    weights read."""
    t, flops = t_in, 0.0
    for k in kernels:
        t = conv_out(t, k, 2)
        flops += 2.0 * b * c * c * k * t
    nbytes = (b * t_in * c + b * t * c + sum(kernels) * c * c) * elem
    return flops, nbytes


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _lstm(t: int, d_in: int, h: int, layers: int) -> float:
    total, din = 0.0, d_in
    for _ in range(layers):
        total += 2 * 2.0 * t * 4 * h * (din + h)      # two directions
        din = 2 * h
    return total


def heads_flops(cfg: dict, t: int, hid: int, num_labels: int) -> float:
    h = cfg["heads"]
    f = 2.0 * t * (hid + h["lang_emb_dim"]) * hid
    f += _lstm(t, hid, hid // 2, h["bilstm_num_layer"])
    e, k = h["conformer_ff_expansion"], h["conformer_kernel_size"]
    per_block = (2 * 2 * 2.0 * t * hid * hid * e        # two FF modules
                 + 2.0 * t * hid * 3 * hid + 2.0 * t * hid * hid
                 + 4.0 * t * t * hid                     # QKᵀ, PV
                 + 2.0 * t * hid * 2 * hid               # 1×1 to 2C
                 + 2.0 * t * hid * hid * k               # full conv
                 + 2.0 * t * hid * hid)                  # 1×1
    f += h["num_conformer_layers"] * per_block
    f += h["dilated_conv_depth"] * 2.0 * t * hid * hid * h["dilated_conv_kernel"]
    f += 2.0 * t * hid * num_labels
    f += 2.0 * t * hid * hid * 3 + 2.0 * t * hid * 2   # offset head
    return f


def wavlm_flops(c: dict, samples: int) -> Tuple[float, int]:
    """(FLOPs of the encoder at ``samples``, its frames)."""
    n, c_in, f = samples, 1, 0.0
    for d, k, s in zip(c["conv_dim"], c["conv_kernel"], c["conv_stride"]):
        n = conv_out(n, k, s)
        f += 2.0 * n * d * c_in * k
        c_in = d
    t, hid = max(n, 0), c["hidden_size"]
    f += 2.0 * t * c_in * hid
    groups, kp = c["num_conv_pos_embedding_groups"], c["num_conv_pos_embeddings"]
    f += 2.0 * t * hid * (hid // groups) * kp
    heads = c["num_attention_heads"]
    per_layer = (4 * 2.0 * t * hid * hid + 4.0 * t * t * hid
                 + 2 * 2.0 * t * hid * c["intermediate_size"]
                 + 2.0 * t * heads * (hid // heads) * 8)
    return f + c["num_hidden_layers"] * per_layer, t


def whisper_flops(c: dict) -> Tuple[float, int]:
    t, d = c["max_source_positions"], c["d_model"]
    f = 2.0 * 2 * t * c["num_mel_bins"] * d * 3 + 2.0 * t * d * d * 3
    per_layer = (4 * 2.0 * t * d * d + 4.0 * t * t * d
                 + 2 * 2.0 * t * d * c["encoder_ffn_dim"])
    return f + c["encoder_layers"] * per_layer, t


def forward_flops(cfg: dict, samples: int, num_labels: int,
                  label_frames: int = None) -> float:
    """One row's forward: the encoder at ``samples``, the heads at the
    encoder's frames (or at ``label_frames`` when training cuts or pads the
    encoder's output to the labels)."""
    enc = cfg
    if cfg["encoder_type"] == "wavlm":
        f, t = wavlm_flops(enc, samples)
        hid = enc["hidden_size"]
    else:
        f, t = whisper_flops(enc)
        hid = enc["d_model"]
    if label_frames is not None:
        t = label_frames
    return f + heads_flops(cfg, t, hid, num_labels)


def optimizer_flops(num_params: int) -> float:
    """Prodigy's arithmetic a parameter (the moments, the running sums,
    the dot product and the update): about 20 operations."""
    return 20.0 * num_params
