"""Weight carry-across: JAX parameter pytrees → the reference-schema
state_dict that :class:`~wfl_asr_tpu_torch.models.tagger.BIOPhonemeTagger`
loads with ``strict=True``.

The port's own copy of ``wfl_asr_tpu/models/convert.py:239-388``
(``export_tagger`` and its helpers). It takes the JAX ``(params, state)``
pytrees with numpy (or any array-like) leaves — no JAX import — and returns
torch tensors under the reference's keys (HF WavLM nests its encoder, so
encoder keys read ``encoder.encoder.layers.{i}.attention.q_proj.weight``;
HF Whisper's read ``encoder.layers.{i}.self_attn.q_proj.weight``; the
``none`` encoder has no keys).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch


def _put_linear(out: Dict, prefix: str, p) -> None:
    """Linear pytree {w [in, out], b?} → torch ``weight`` [out, in], bias."""
    out[f"{prefix}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = np.asarray(p["b"])


def _put_ln(out: Dict, prefix: str, p) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _put_conv(out: Dict, prefix: str, p) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = np.asarray(p["b"])


def export_wavlm(params) -> Dict:
    """WavLM pytree → HF ``WavLMModel`` keys (numpy values). The pos-conv
    weight norm is stored as original1 = the folded weight, original0 = its
    per-kernel-position norm, so folding back gives the weight."""
    out: Dict = {}
    put_linear = functools.partial(_put_linear, out)
    put_ln = functools.partial(_put_ln, out)

    for i, layer in enumerate(params["feature_encoder"]):
        pre = f"feature_extractor.conv_layers.{i}"
        _put_conv(out, f"{pre}.conv", layer["conv"])
        if "norm" in layer:
            put_ln(f"{pre}.layer_norm", layer["norm"])
    put_ln("feature_projection.layer_norm", params["feature_projection"]["ln"])
    put_linear("feature_projection.projection",
               params["feature_projection"]["proj"])

    w = np.asarray(params["pos_conv"]["w"])
    out["encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = \
        np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True))
    out["encoder.pos_conv_embed.conv.parametrizations.weight.original1"] = w
    if "b" in params["pos_conv"]:
        out["encoder.pos_conv_embed.conv.bias"] = \
            np.asarray(params["pos_conv"]["b"])
    put_ln("encoder.layer_norm", params["encoder_ln"])

    rel = np.asarray(params["rel_attn_embed"]["w"])
    for i, layer in enumerate(params["layers"]):
        pre = f"encoder.layers.{i}"
        if i == 0:  # HF stores the shared bucket table on layer 0 only
            out[f"{pre}.attention.rel_attn_embed.weight"] = rel
        put_linear(f"{pre}.attention.q_proj", layer["q"])
        put_linear(f"{pre}.attention.k_proj", layer["k"])
        put_linear(f"{pre}.attention.v_proj", layer["v"])
        put_linear(f"{pre}.attention.out_proj", layer["out"])
        out[f"{pre}.attention.gru_rel_pos_const"] = \
            np.asarray(layer["gru_gate_const"]).reshape(1, -1, 1, 1)
        put_linear(f"{pre}.attention.gru_rel_pos_linear", layer["gru_gate"])
        put_ln(f"{pre}.layer_norm", layer["attn_ln"])
        put_linear(f"{pre}.feed_forward.intermediate_dense", layer["ff_in"])
        put_linear(f"{pre}.feed_forward.output_dense", layer["ff_out"])
        put_ln(f"{pre}.final_layer_norm", layer["final_ln"])
    return out


def export_whisper_encoder(params) -> Dict:
    """Whisper pytree → bare HF ``WhisperEncoder`` keys (numpy values);
    ``k_proj`` has no bias."""
    out: Dict = {}
    put_linear = functools.partial(_put_linear, out)
    put_ln = functools.partial(_put_ln, out)

    for name in ("conv1", "conv2"):
        _put_conv(out, name, params[name])
    out["embed_positions.weight"] = np.asarray(params["embed_positions"])
    put_ln("layer_norm", params["ln_post"])
    for i, layer in enumerate(params["layers"]):
        pre = f"layers.{i}"
        put_ln(f"{pre}.self_attn_layer_norm", layer["attn_ln"])
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                          ("out_proj", "out")):
            put_linear(f"{pre}.self_attn.{name}", layer[key])
        put_ln(f"{pre}.final_layer_norm", layer["final_ln"])
        put_linear(f"{pre}.fc1", layer["ff_in"])
        put_linear(f"{pre}.fc2", layer["ff_out"])
    return out


def export_tagger(params, state, encoder_type: str) -> Dict:
    """Tagger pytrees → reference ``BIOPhonemeTagger`` keys (numpy values).
    The encoder sits under ``encoder.`` (reference model.py:70/80)."""
    out: Dict = {}
    export = {"wavlm": export_wavlm,
              "whisper": export_whisper_encoder}.get(encoder_type)
    if export is not None and "encoder" in params:
        for k, v in export(params["encoder"]).items():
            out[f"encoder.{k}"] = v

    put_linear = functools.partial(_put_linear, out)
    put_ln = functools.partial(_put_ln, out)
    put_conv = functools.partial(_put_conv, out)

    put_linear("lang_proj", params["lang"]["proj"])
    out["lang_emb.weight"] = np.asarray(params["lang"]["emb"]["w"])
    if "bilstm" in params:
        for i, dirs in enumerate(params["bilstm"]):
            for d, suffix in zip(dirs, ("", "_reverse")):
                out[f"bilstm.weight_ih_l{i}{suffix}"] = np.asarray(d["w_ih"]).T
                out[f"bilstm.weight_hh_l{i}{suffix}"] = np.asarray(d["w_hh"]).T
                out[f"bilstm.bias_ih_l{i}{suffix}"] = np.asarray(d["b_ih"])
                out[f"bilstm.bias_hh_l{i}{suffix}"] = np.asarray(d["b_hh"])
    for i, (p, s) in enumerate(zip(params["conformer"], state["conformer"])):
        pre = f"conformer_layers.{i}"
        for name in ("ff1", "ff2"):
            put_ln(f"{pre}.{name}.net.0", p[name]["ln"])
            put_linear(f"{pre}.{name}.net.1", p[name]["in"])
            put_linear(f"{pre}.{name}.net.4", p[name]["out"])
        out[f"{pre}.self_attn.in_proj_weight"] = np.concatenate(
            [np.asarray(p[k]["w"]).T for k in ("q", "k", "v")], axis=0)
        out[f"{pre}.self_attn.in_proj_bias"] = np.concatenate(
            [np.asarray(p[k]["b"]) for k in ("q", "k", "v")], axis=0)
        put_linear(f"{pre}.self_attn.out_proj", p["attn_out"])
        put_ln(f"{pre}.ln1", p["ln1"])
        put_ln(f"{pre}.ln2", p["ln2"])
        put_conv(f"{pre}.conv.0", p["conv_pw1"])
        put_conv(f"{pre}.conv.2", p["conv_main"])
        out[f"{pre}.conv.3.weight"] = np.asarray(p["bn"]["scale"])
        out[f"{pre}.conv.3.bias"] = np.asarray(p["bn"]["bias"])
        out[f"{pre}.conv.3.running_mean"] = np.asarray(s["bn"]["mean"])
        out[f"{pre}.conv.3.running_var"] = np.asarray(s["bn"]["var"])
        # torch BatchNorm1d state the reference's strict load requires
        out[f"{pre}.conv.3.num_batches_tracked"] = np.asarray(0, np.int64)
        put_conv(f"{pre}.conv.5", p["conv_pw2"])
    if "dilated" in params:
        for j, p in enumerate(params["dilated"]):
            put_conv(f"dilated_conv_stack.{j * 2}", p)  # ReLUs at odd indices
    put_linear("classifier", params["classifier"])
    put_conv("boundary_offset_head.0", params["offset_head"]["conv1"])
    put_conv("boundary_offset_head.2", params["offset_head"]["conv2"])
    return out


def state_dict_from_jax(params, state, arch) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` with numpy leaves → a torch state_dict that
    ``BIOPhonemeTagger(arch).load_state_dict(sd, strict=True)`` accepts.
    ``arch`` is a port ``TaggerArch`` (or anything with ``encoder_type``)."""
    sd = export_tagger(params, state, arch.encoder_type)
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in sd.items()}
