"""What the benchmark hands the program: its configuration dict, built
from a configuration file and a traffic mix, and its label and language
files. The architecture is passed whole (``encoder_arch_overrides``), so
that the program runs the numbers of the configuration file and not its
own presets."""

from __future__ import annotations

import os
from typing import List

WAVLM_FIELDS = {   # the program's WavLMArch field ← config.json key
    "hidden_size": "hidden_size", "num_layers": "num_hidden_layers",
    "num_heads": "num_attention_heads",
    "intermediate_size": "intermediate_size", "conv_dim": "conv_dim",
    "conv_kernel": "conv_kernel", "conv_stride": "conv_stride",
    "conv_bias": "conv_bias", "feat_extract_norm": "feat_extract_norm",
    "num_conv_pos_embeddings": "num_conv_pos_embeddings",
    "num_conv_pos_embedding_groups": "num_conv_pos_embedding_groups",
    "num_buckets": "num_buckets", "max_distance": "max_bucket_distance",
    "do_stable_layer_norm": "do_stable_layer_norm",
    "layer_norm_eps": "layer_norm_eps", "hidden_dropout": "hidden_dropout",
    "activation_dropout": "activation_dropout",
    "attention_dropout": "attention_dropout",
    "feat_proj_dropout": "feat_proj_dropout", "layerdrop": "layerdrop"}
WHISPER_FIELDS = {
    "d_model": "d_model", "num_layers": "encoder_layers",
    "num_heads": "encoder_attention_heads", "ffn_dim": "encoder_ffn_dim",
    "num_mel_bins": "num_mel_bins",
    "max_source_positions": "max_source_positions", "dropout": "dropout",
    "activation_dropout": "activation_dropout",
    "layerdrop": "encoder_layerdrop"}


def model_section(cfg: dict, num_languages: int) -> dict:
    h = cfg["heads"]
    enc = cfg["encoder_type"]
    fields = WAVLM_FIELDS if enc == "wavlm" else WHISPER_FIELDS
    return {
        "encoder_type": enc, f"{enc}_model": cfg["model_name"],
        "encoder_arch_overrides": {k: cfg[v] for k, v in fields.items()},
        "freeze_encoder": h["freeze_encoder"], "enable_bilstm": True,
        "bilstm_num_layer": h["bilstm_num_layer"],
        "enable_dilated_conv": True,
        "dilated_conv_depth": h["dilated_conv_depth"],
        "dilated_conv_kernel": h["dilated_conv_kernel"],
        "segmental_loss_weight": h["segmental_loss_weight"],
        "segmental_loss_weights": h["segmental_loss_weights"],
        "subframe_loss_weight": h["subframe_loss_weight"],
        "num_conformer_layers": h["num_conformer_layers"],
        "conformer_heads": h["conformer_heads"],
        "conformer_ff_expansion": h["conformer_ff_expansion"],
        "conformer_kernel_size": h["conformer_kernel_size"],
        "conformer_dropout": h["conformer_dropout"],
        "lang_emb_dim": h["lang_emb_dim"], "num_languages": num_languages}


def program_config(cfg: dict, save_dir: str, data_dir: str = "",
                   training: dict = None, augmentation: dict = None,
                   postprocess: dict = None, num_val: int = 0) -> dict:
    return {
        "data": {"data_dir": data_dir, "sample_rate": 16000,
                 "num_val_files": num_val, "max_seq_len": None,
                 "frame_duration": 0.02, "n_mels": 80},
        "model": model_section(cfg, cfg["assumed"]["num_languages"]),
        "training": dict(training or {},
                         log_dir=os.path.join(save_dir, "logs")),
        "augmentation": dict(augmentation or {"enable": False}),
        "finetuning": {"enable": False, "model_path": None},
        "output": {"save_dir": save_dir},
        "postprocess": dict(postprocess or {}),
    }


def write_label_files(save_dir: str, labels: List[str],
                      langs: List[str]) -> None:
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "phonemes.txt"), "w") as f:
        f.writelines(tag + "\n" for tag in labels)
    with open(os.path.join(save_dir, "langs.txt"), "w") as f:
        f.writelines(f"{lang},{i}\n" for i, lang in enumerate(langs))
