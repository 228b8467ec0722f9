"""Config system: typed view over the reference ``config.yaml`` schema.

The reference reads a raw YAML dict with ~30 scattered ``.get`` defaults
(SURVEY.md §5 "Config / flag system"). We keep the raw dict as the source of
truth — so preprocess can re-write ``config.yaml`` the way the reference does
(preprocess.py:191-195) — and expose typed accessors whose defaults replicate
every reference call site (cited below).

Fork-only keys seen in the wild (``enable_duration_prediction``,
``duration_head_dim``, ``duration_loss_weight``, ``enable_self_attn_polisher``,
``self_attn_heads``) are accepted and ignored, per SURVEY.md §5.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple, Union

# ``yaml`` is imported only where a YAML file is read or written: a
# ``Config`` built from a dict needs no pyyaml (machines that serve the
# model may not have it).


def load_raw_config(path: str = "config.yaml") -> Dict[str, Any]:
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


def save_raw_config(config: Dict[str, Any], path: str) -> None:
    """Reference-compatible rewrite: ``yaml.dump(config, sort_keys=False)``
    (preprocess.py:193-194)."""
    import yaml
    with open(path, "w") as f:
        yaml.dump(config, f, sort_keys=False)


def as_config(config: Union[str, "Config", Dict[str, Any]]) -> "Config":
    """A ``Config`` from a YAML path, a raw dict or a ``Config``."""
    if isinstance(config, Config):
        return config
    if isinstance(config, dict):
        return Config(config)
    return Config.load(str(config))


class Config:
    """Typed accessor over the raw config dict.

    Every default mirrors the reference's ``.get(...)`` default at the cited
    call site so that a sparse YAML behaves identically.
    """

    def __init__(self, raw: Dict[str, Any]):
        self.raw = raw

    @classmethod
    def load(cls, path: str = "config.yaml") -> "Config":
        return cls(load_raw_config(path))

    def save(self, path: str) -> None:
        save_raw_config(self.raw, path)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.raw))

    def _sec(self, name: str) -> Dict[str, Any]:
        val = self.raw.get(name)
        return val if isinstance(val, dict) else {}

    # --- data --------------------------------------------------------------
    @property
    def data_dir(self) -> str:
        return self._sec("data")["data_dir"]

    @property
    def sample_rate(self) -> int:
        return int(self._sec("data").get("sample_rate", 16000))

    @property
    def num_val_files(self) -> int:
        return int(self._sec("data")["num_val_files"])

    @property
    def max_seq_len(self) -> Optional[int]:
        v = self._sec("data").get("max_seq_len")
        return None if v in (None, 0, "null") else int(v)

    @property
    def frame_duration(self) -> float:
        # reference preprocess.py:70, train.py:189, model.py:88 default 0.02
        return float(self._sec("data").get("frame_duration", 0.02))

    @property
    def n_mels(self) -> int:
        return int(self._sec("data").get("n_mels", 80))  # model.py:89

    # --- model ---------------------------------------------------------------
    @property
    def encoder_type(self) -> str:
        return str(self._sec("model")["encoder_type"]).lower()  # model.py:57

    @property
    def encoder_name(self) -> str:
        m = self._sec("model")
        return m["whisper_model"] if self.encoder_type == "whisper" else m["wavlm_model"]

    @property
    def freeze_encoder(self) -> bool:
        return bool(self._sec("model").get("freeze_encoder", False))  # model.py:61

    @property
    def enable_bilstm(self) -> bool:
        return bool(self._sec("model").get("enable_bilstm", True))  # model.py:62

    @property
    def bilstm_num_layers(self) -> int:
        return int(self._sec("model").get("bilstm_num_layer", 1))  # model.py:108

    @property
    def enable_dilated_conv(self) -> bool:
        return bool(self._sec("model").get("enable_dilated_conv", True))  # model.py:64

    @property
    def dilated_conv_depth(self) -> int:
        return int(self._sec("model").get("dilated_conv_depth", 2))  # model.py:65

    @property
    def dilated_conv_kernel(self) -> int:
        return int(self._sec("model").get("dilated_conv_kernel", 3))  # model.py:66

    @property
    def num_conformer_layers(self) -> int:
        return int(self._sec("model").get("num_conformer_layers", 2))  # model.py:123

    @property
    def conformer_heads(self) -> int:
        return int(self._sec("model").get("conformer_heads", 4))  # model.py:118

    @property
    def conformer_ff_expansion(self) -> int:
        return int(self._sec("model").get("conformer_ff_expansion", 4))  # model.py:119

    @property
    def conformer_kernel_size(self) -> int:
        return int(self._sec("model").get("conformer_kernel_size", 31))  # model.py:120

    @property
    def conformer_dropout(self) -> float:
        return float(self._sec("model").get("conformer_dropout", 0.1))  # model.py:121

    @property
    def lang_emb_dim(self) -> int:
        return int(self._sec("model").get("lang_emb_dim", 64))  # model.py:96

    @property
    def num_languages(self) -> int:
        return int(self._sec("model")["num_languages"])  # model.py:97

    @num_languages.setter
    def num_languages(self, value: int) -> None:
        self.raw.setdefault("model", {})["num_languages"] = int(value)

    @property
    def segmental_loss_weight(self) -> float:
        return float(self._sec("model").get("segmental_loss_weight", 1.0))  # train.py:250

    @property
    def differentiable_segmental_weight(self) -> float:
        # NEW (no reference analogue): weight of the trainable soft-IoU
        # segmental term; 0 keeps the reference's gradient-dead behavior
        # (quirk Q1). See train/losses.py soft_iou_segmental_loss.
        return float(self._sec("model").get(
            "differentiable_segmental_weight", 0.0))

    @property
    def segmental_loss_weights(self) -> Tuple[float, float, float]:
        v = self._sec("model").get("segmental_loss_weights", (1.0, 1.0, 2.0))  # train.py:222
        return tuple(float(x) for x in v)

    @property
    def subframe_loss_weight(self) -> float:
        return float(self._sec("model").get("subframe_loss_weight", 1.0))  # train.py:251

    # --- training ------------------------------------------------------------
    @property
    def batch_size(self) -> int:
        return int(self._sec("training")["batch_size"])

    @property
    def num_workers(self) -> int:
        return int(self._sec("training").get("num_workers", 0))

    @property
    def optimizer(self) -> str:
        return str(self._sec("training").get("optimizer", "AdamW"))  # train.py:379

    @property
    def optimizer_params(self) -> Dict[str, Any]:
        return dict(self._sec("training").get("optimizer_params", {}) or {})

    @property
    def learning_rate(self) -> float:
        return float(self._sec("training")["learning_rate"])

    @property
    def weight_decay(self) -> Optional[float]:
        v = self._sec("training").get("weight_decay")
        return None if v is None else float(v)

    @property
    def scheduler(self) -> str:
        return str(self._sec("training").get("scheduler", "ConstantLR"))  # train.py:409

    @property
    def scheduler_params(self) -> Dict[str, Any]:
        return dict(self._sec("training").get("scheduler_params", {}) or {})

    @property
    def scheduler_step_on_update(self) -> bool:
        return bool(self._sec("training").get("scheduler_step_on_update", False))  # train.py:258

    @property
    def label_smoothing(self) -> float:
        return float(self._sec("training").get("label_smoothing", 0.0))  # train.py:412

    @property
    def max_steps(self) -> int:
        return int(self._sec("training")["max_steps"])

    @property
    def val_check_interval(self) -> int:
        return int(self._sec("training")["val_check_interval"])

    @property
    def max_checkpoints(self) -> int:
        return int(self._sec("training")["max_checkpoints"])

    @property
    def log_dir(self) -> str:
        return self._sec("training")["log_dir"]

    @property
    def merged_phoneme_groups(self) -> List[List[str]]:
        return self._sec("training").get("merged_phoneme_groups", []) or []

    @property
    def num_vis_samples(self) -> int:
        return int(self._sec("training").get("num_vis_samples", 5))  # train.py:510 (Q12)

    @property
    def seed(self) -> int:
        # TPU-build addition: the reference is unseeded (quirk Q9); we default
        # to a fixed seed for reproducible splits/augmentation.
        return int(self._sec("training").get("seed", 0))

    # --- augmentation ----------------------------------------------------------
    @property
    def augmentation(self) -> Dict[str, Any]:
        defaults = {"enable": False, "prob": 1.0, "noise_std": 0.0,
                    "volume_range": [1.0, 1.0]}  # train.py:46-53
        defaults.update(self._sec("augmentation"))
        return defaults

    # --- finetuning --------------------------------------------------------------
    @property
    def finetuning_enable(self) -> bool:
        return bool(self._sec("finetuning").get("enable", False))

    @property
    def finetuning_model_path(self) -> Optional[str]:
        return self._sec("finetuning").get("model_path") or None

    # --- output / postprocess -----------------------------------------------------
    @property
    def save_dir(self) -> str:
        return self._sec("output")["save_dir"]

    @property
    def median_filter(self) -> int:
        return int(self._sec("postprocess").get("median_filter", 1))

    @property
    def merge_segments(self) -> str:
        return str(self._sec("postprocess").get("merge_segments", "right"))

    @property
    def confidence_threshold(self) -> float:
        return float(self._sec("postprocess").get("confidence_threshold", 0.0))  # infer.py:407-408

    @property
    def serving_quantization(self) -> str:
        """"int8" quantizes the encoder's large linears (both dims ≥ 256)
        for serving, W8A8-dynamic: int8 weights per output channel, the
        activations per row at run time, the product on ``torch._int_mm``.
        Checkpoints stay full-precision; quantization happens at session
        load. On an NVIDIA H100 80GB HBM3 at 700.00 W it served
        WavLM-base-plus at B = 8 × 30 s at 2008.54-2085.77 audio-s/s
        against bf16's 2692.95-2727.44 (``chip_smoke.py`` phase 10c), with
        the same peak memory: a layout option, not a speed-up. Default
        "none"."""
        return str(self._sec("model").get("serving_quantization",
                                          "none")).lower()

    @property
    def serving_pipeline_parallel(self) -> int:
        """GPipe-pipeline the encoder's transformer stack over S stages at
        session load (parallel/pp.py) — each rank holds layers/S of the
        encoder, so models up to S× one card's memory serve without
        weight-sharding the matmuls. 0/1 disables. Needs a world that S
        divides and encoder layers % S == 0."""
        return int(self._sec("model").get("pipeline_parallel", 0))

    @property
    def serving_sequence_parallel(self) -> bool:
        """TPU addition: shard the encoder's time axis over the mesh's
        'model' axis between layers (Megatron-SP, parallel/sp.py). Serving
        counterpart of training.sequence_parallel; only meaningful when the
        session runs on a mesh with model_parallel > 1."""
        return bool(self._sec("model").get("sequence_parallel", False))

    @property
    def device_decode(self) -> bool:
        """TPU addition (no reference analogue): run the BIO→segments state
        machine on device in the batched folder mode, transferring segment
        arrays instead of per-frame ids (the last north-star clause —
        gate + median + decode device-side before one host transfer)."""
        return bool(self._sec("postprocess").get("device_decode", False))
