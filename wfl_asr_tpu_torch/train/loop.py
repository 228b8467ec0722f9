"""The train loop, the port of ``wfl_asr_tpu/train/loop.py:554-1276`` for
one device on one host:

- artifacts from ``save_dir`` (``phonemes.txt``, ``dataset.json``,
  ``langs.txt`` and ``phoneme_merge_map.json``, written by ``python -m
  wfl_asr_tpu_torch.preprocess``; the language names and the merge map
  serve the validation figures);
- a seeded train/val split by ``num_val_files``;
- optional finetune surgery: language-embedding rows grown, classifier rows
  carried over by tag name;
- the optimizer by name with the JAX package's optax semantics
  (train/optimizers.py: Prodigy and the 26 optax names, kwargs filtered as
  the JAX package filters them), the Conformer's packed in_proj taken as
  JAX's three leaves by the per-leaf statistics;
- schedulers stepped per validation (default) or per update, with the
  ReduceLROnPlateau special case;
- gradient accumulation (the applied gradient is the mean of the
  micro-batch gradients; ``step`` counts updates);
- auto-resume from the newest readable ``model_step{N}.pt`` (or a JAX
  run's ``.pt.npz``) plus its training sidecar (the port's ``.train.pt``,
  else a JAX run's Prodigy ``.train.npz``); checkpoint rotation,
  ``best_model.pt``, ``last_model.pt``;
- ``training.remat`` (alias ``gradient_checkpointing``): true checkpoints
  every encoder layer; "auto" runs without and flips to remat for the rest
  of the run at the first CUDA OOM, rerunning that whole update
  (:class:`RematStep`; a ``remat_auto_flip`` event in metrics.jsonl);
- ``metrics.jsonl`` (the JAX event schema) with a one-step-delayed metric
  readback, so the host never waits on the step it just queued, and
  TensorBoard scalars when ``tensorboardX`` imports; validation figures
  (``val/prediction_{count}_{j}``, the first ``num_vis_samples`` samples,
  utils/viz.py) when matplotlib imports too;
- ``WFL_PROFILE_DIR``: the training loop runs inside
  ``utils.profiling.maybe_trace("train")``, a ``torch.profiler`` trace.

Each step runs the model in training mode (dropout from a seeded
``torch.Generator`` on the device, LayerDrop, BatchNorm batch statistics;
with ``training.strict_attention_dropout`` the attention-probability
dropout inside the attention kernels, K6, its seeds drawn from the same
generator):
CE + subframe_weight · offset (+ the optional soft-IoU term), backward
through the hand-written attention kernels, and the optimizer. The
segmental term is a value-only metric on the host, as in the reference.

Under a launcher (``torchrun --nproc_per_node N``, one process a GPU;
:func:`plan_parallel` keeps the JAX loop's warnings and errors for each
combination, loop.py:640-750):

- data parallelism (``training.data_parallel``, on by default): the model
  in DDP over the mesh's data group (``no_sync`` on every micro-step of an
  accumulation but the last); each rank collates its contiguous rows of
  each global batch at the batch's padded lengths; the CE's and the
  soft-IoU's counts, the Conformer's BatchNorm statistics and the logged
  metrics are reduced over the data group, so the step is the unsharded
  step; LayerDrop and the strict-dropout seeds come from a generator all
  ranks share, element-wise dropout from one a data rank;
- ``training.fsdp``: FSDP2 over the data group (``parallel/fsdp.py``),
  the optimizer's step on full tensors (``FullTensorStep``);
- ``training.model_parallel``: tensor parallelism (``parallel/tp.py``),
  with ``training.sequence_parallel`` (``parallel/sp.py``), gradients
  averaged over the data group;
- ``training.pipeline_parallel: S``: GPipe over a ``(data, stage)`` mesh
  (``parallel/pp.py``): each stage holds L/S of the encoder's layers and
  runs ``training.pp_microbatches`` microbatches through them (clamped as
  the JAX encoders clamp it); the batch is sharded over data only; the
  optimizer takes its statistics over the JAX package's stacked leaves;
  the replicated parameters' gradients are averaged over the data group
  and kept equal over the stages; composes with gradient accumulation,
  remat and sharded validation;
- ``training.sharded_validation``: each data rank evaluates its rows of
  each validation batch and the metric sums are reduced, so every rank
  gets the one-process validation metrics;
- across nodes, each node reads its share of the training files;
- rank 0 alone writes metrics.jsonl, TensorBoard, figures and checkpoints:
  the canonical ``.pt`` and sidecar of a one-process run, gathered from
  the shards (the sidecar adds each rank's dropout-generator state).

Not ported (a config that asks for it raises ``NotImplementedError``
naming ROADMAP.md): the orbax format. Validation runs in eval mode,
without dropout.

    python -m wfl_asr_tpu_torch.train CONFIG [--device cuda|cpu]
    torchrun --nproc_per_node N -m wfl_asr_tpu_torch.train CONFIG
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pickle
import time
import zipfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import (find_resume_checkpoints, load_train_state,
                          read_state_dict, remove_checkpoint,
                          restore_jax_train_state, save_model_checkpoint,
                          save_train_state)
from ..config import Config, as_config
from ..data.dataset import BatchLoader, PhonemeDataset, \
    shard_indices_for_process, split_dataset
from ..infer.pipeline import resolve_device
from ..labels import (canonical_to_lang, clean_lab, decode_bio_tags,
                      load_langs, load_phoneme_list, load_phoneme_merge_map,
                      merge_adjacent_segments)
from ..metrics import framewise_accuracy, phoneme_error_rate, \
    timing_error_rate
from ..models import layers
from ..models.tagger import BIOPhonemeTagger, TaggerArch, init_tagger
from ..parallel import fsdp as pfsdp
from ..parallel import mesh as pmesh
from ..parallel import tp as ptp
from ..utils.profiling import maybe_trace, recomputed, span
from .losses import (cross_entropy, offset_loss, segmental_loss_value,
                     soft_iou_segmental_loss)
from .optimizers import STACKED_STATE, make_optimizer
from .schedules import get_scheduler

BATCH_KEYS = ("audio", "labels", "lang_ids", "off_frames", "off_channels",
              "off_fracs", "off_valid")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to wfl_asr_tpu_torch: a deliberate "
        f"difference (ROADMAP.md)")


def check_supported(cfg: Config) -> None:
    """Raise for the JAX-only training options."""
    fmt = str(cfg._sec("output").get("checkpoint_format", "pt"))
    if fmt != "pt":
        raise _not_ported(f"output.checkpoint_format {fmt!r}")


@dataclasses.dataclass
class Parallel:
    """How a run is spread over its ranks (:func:`plan_parallel`)."""
    mesh: Optional[pmesh.Mesh] = None
    fsdp: bool = False
    model_parallel: int = 1
    sequence_parallel: bool = False
    sharded_validation: bool = False
    # FSDP's replicated leaves, whose gradients the loop averages itself
    replicated: Sequence = ()
    pipeline: int = 1
    pp_microbatches: int = 0
    # under pipeline parallelism: the one-process model's trainable
    # parameter names, in order (the canonical optimizer state's)
    full_names: Sequence[str] = ()

    @property
    def pp(self) -> bool:
        return self.pipeline > 1

    @property
    def ddp(self) -> bool:
        return (self.mesh is not None and not self.fsdp
                and self.model_parallel == 1 and not self.pp)

    @property
    def main(self) -> bool:
        """This rank writes the run's files."""
        return pmesh.rank() == 0

    @property
    def sharded_params(self) -> bool:
        return self.fsdp or self.model_parallel > 1


def plan_parallel(cfg: Config, device) -> Parallel:
    """The run's parallel layout, with the JAX loop's warnings and errors
    (loop.py:640-750): sequence parallelism without model parallelism
    warns and is ignored; FSDP without a process group (one device) warns
    and is ignored; FSDP with model or pipeline parallelism, FSDP across
    nodes and model parallelism across nodes raise ``ValueError``, as do a
    world that ``model_parallel`` does not divide, a batch that the data
    size does not divide, and ``training.remat: auto`` with more than one
    rank (an out-of-memory flip on one rank would leave the others
    waiting in the gradient all-reduce). Pipeline parallelism raises with
    model parallelism, across nodes, for an encoder other than wavlm or
    whisper, and with one rank (loop.py:684-701, 745-747). A process group
    (a launcher, or the caller) puts the run on a mesh unless
    ``training.data_parallel`` is false and nothing else asks for one."""
    t = cfg._sec("training")
    mp = int(t.get("model_parallel", 1))
    sp = bool(t.get("sequence_parallel", False))
    fsdp = bool(t.get("fsdp", False))
    stages = int(t.get("pipeline_parallel", 1))
    grouped = torch.distributed.is_initialized()
    nodes = pmesh.node_count()
    if sp and mp <= 1:
        print("[WARN] training.sequence_parallel ignored: it shards the "
              "time axis over the 'model' mesh axis, which requires "
              "training.model_parallel > 1")
        sp = False
    if remat_mode(cfg) == "auto" and pmesh.world_size() > 1:
        raise ValueError(
            "training.remat: auto is single-process only (the OOM fallback "
            "would desynchronize the ranks' steps); set training.remat "
            "true/false explicitly")
    if stages > 1:
        if mp > 1:
            raise ValueError("training.pipeline_parallel and "
                             "training.model_parallel are mutually "
                             "exclusive (different mesh layouts)")
        if nodes > 1:
            raise ValueError(
                "pipeline_parallel > 1 is not supported across nodes: "
                "checkpointing needs node-local stages. Use data "
                "parallelism across nodes and PP within one node.")
        if cfg.encoder_type not in ("wavlm", "whisper"):
            raise ValueError("training.pipeline_parallel needs a layered "
                             "encoder (wavlm or whisper)")
    if fsdp:
        if mp > 1 or stages > 1:
            raise ValueError(
                "training.fsdp is mutually exclusive with model_parallel/"
                "pipeline_parallel (different parameter placements)")
        if nodes > 1:
            raise ValueError(
                "training.fsdp is not supported across nodes: validation/"
                "checkpointing need node-local parameters. Use plain data "
                "parallelism across nodes and FSDP within one.")
        if not grouped:
            print("[WARN] training.fsdp ignored: single visible device")
            fsdp = False
    if mp > 1 and not grouped:
        print(f"[WARN] training.model_parallel={mp} ignored: single "
              f"visible device")
        mp, sp = 1, False
    if stages > 1 and pmesh.world_size() <= 1:
        raise ValueError("training.pipeline_parallel needs multiple "
                         "visible devices")
    use_mesh = grouped and (mp > 1 or fsdp or stages > 1
                            or bool(t.get("data_parallel", True)))
    if not use_mesh:
        return Parallel()
    if nodes > 1 and mp > 1:
        raise ValueError(
            "model_parallel > 1 is not supported across nodes: validation/"
            "checkpointing need node-local (replicated) parameters. Use "
            "data parallelism across nodes and TP within one node.")
    if stages > 1:
        from ..parallel import pp
        mesh = pp.make_pp_mesh(stages, device)
    else:
        mesh = pmesh.make_mesh(mp, device)
    if cfg.batch_size % mesh.data_size:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by "
                         f"the {mesh.data_size}-way data axis")
    print(f"[INFO] Parallel over {pmesh.world_size()} ranks (mesh "
          f"{mesh.shape}{', FSDP' if fsdp else ''}"
          f"{', sequence parallel' if sp else ''})")
    return Parallel(mesh, fsdp, mp, sp,
                    bool(t.get("sharded_validation", False)),
                    pipeline=stages,
                    pp_microbatches=int(t.get("pp_microbatches", 0)))


def remat_mode(cfg: Config) -> str:
    """``training.remat`` (alias ``gradient_checkpointing``) as "on", "off"
    or "auto", read as the JAX loop reads it (loop.py:664-667)."""
    t = cfg._sec("training")
    raw = t.get("remat", t.get("gradient_checkpointing", False))
    if isinstance(raw, str) and raw.strip().lower() == "auto":
        return "auto"
    return "on" if bool(raw) else "off"


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


# ---------------------------------------------------------------------------
# One step
# ---------------------------------------------------------------------------

def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array fields of a collated batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS}


def micro_step(model: BIOPhonemeTagger, batch: Dict, device, n_micro: int,
               label_smoothing: float, subframe_weight: float,
               compute_dtype=torch.float32, seg_diff_weight: float = 0.0,
               generator: Optional[torch.Generator] = None,
               remat: bool = False, mean_count: Optional[Callable] = None):
    """Forward (training mode) and backward of one micro-batch, its loss
    scaled by 1/n_micro so that the gradients summed over n_micro
    micro-batches are their mean; ``remat`` checkpoints the encoder layers;
    ``mean_count`` reduces the losses' counts over the data ranks
    (``Mesh.mean_count``) when the batch is a rank's rows.
    Returns ({loss, ce, offset_loss} as detached device scalars, pred_ids,
    offsets)."""
    wavs = batch.get("wavs")     # the unpadded rows, where collated
    with span("wfl.forward_backward", rows=len(batch["audio"]),
              samples_true=(sum(map(len, wavs)) if wavs is not None
                            else int(np.size(batch["audio"])))):
        arrays = to_device(batch, device)
        model.train()
        logits, offsets = model(arrays["audio"], arrays["lang_ids"],
                                max_label_len=batch["max_label_len"],
                                compute_dtype=compute_dtype,
                                generator=generator, remat=remat)
        ce = cross_entropy(logits, arrays["labels"], label_smoothing,
                           mean_count=mean_count)
        ol = offset_loss(offsets, arrays["off_frames"],
                         arrays["off_channels"], arrays["off_fracs"],
                         arrays["off_valid"])
        loss = ce + subframe_weight * ol
        if seg_diff_weight:
            loss = loss + seg_diff_weight * soft_iou_segmental_loss(
                logits, arrays["labels"], mean_count=mean_count)
        (loss / n_micro).backward()
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "offset_loss": ol.detach()}
        return metrics, logits.detach().argmax(-1), offsets.detach()


def apply_update(optimizer: torch.optim.Optimizer) -> None:
    with span("wfl.optimizer"):
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)


def train_step(model, optimizer, batch, device, label_smoothing: float,
               subframe_weight: float, compute_dtype=torch.float32,
               seg_diff_weight: float = 0.0, generator=None):
    """One update from one batch (no accumulation)."""
    out = micro_step(model, batch, device, 1, label_smoothing,
                     subframe_weight, compute_dtype, seg_diff_weight,
                     generator)
    apply_update(optimizer)
    return out


class RematStep:
    """One optimizer update from its micro-batches under ``training.remat``
    "on", "off" or "auto" (the JAX loop's ``AutoRematStep``, loop.py:286-336).

    "auto" runs without remat first. A ``torch.cuda.OutOfMemoryError`` in a
    micro-batch's forward or backward flips it: once out of the ``except``
    block (so the failed graph is freed), the CUDA cache is emptied, the
    generator and the model's buffers (BatchNorm statistics) are put back as
    they were before the step, every ``.grad`` is cleared, and the whole
    update — every micro-batch — runs again with remat, which stays on for
    the rest of the run; ``on_flip`` is called. An OOM with remat on, or one
    in ``optimizer.step()`` (which runs outside the retry), propagates, as
    does any other error."""

    def __init__(self, mode: str, model: BIOPhonemeTagger,
                 generator: Optional[torch.Generator] = None,
                 on_flip: Optional[Callable[[], None]] = None,
                 sync: Optional[Callable[[bool], object]] = None,
                 after_backward: Optional[Callable[[], None]] = None):
        """``sync(last)``: a context for each micro-batch's forward and
        backward (DDP's ``no_sync`` on all but the last);
        ``after_backward()``: called once the update's gradients are in,
        before the optimizer (the data-group averages DDP does not do)."""
        if mode not in ("on", "off", "auto"):
            raise ValueError(f"remat mode {mode!r}: on, off or auto")
        self.model, self.generator, self.on_flip = model, generator, on_flip
        self.sync, self.after_backward = sync, after_backward
        self.auto = mode == "auto"
        self.remat = mode == "on"
        self.oom = None          # the message of the OOM that flipped it

    def _grads(self, batches, device, kwargs):
        outs = []
        for i, b in enumerate(batches):
            with (self.sync(i == len(batches) - 1) if self.sync is not None
                  else contextlib.nullcontext()):
                outs.append(micro_step(self.model, b, device, len(batches),
                                       generator=self.generator,
                                       remat=self.remat, **kwargs))
        if self.after_backward is not None:
            self.after_backward()
        metrics = {k: sum(m[k] for m, _, _ in outs) / len(outs)
                   for k in outs[0][0]}
        return metrics, [(p, o, b) for (_, p, o), b in zip(outs, batches)]

    def __call__(self, optimizer: torch.optim.Optimizer, batches: List[Dict],
                 device, **kwargs):
        """Forward and backward of every micro-batch in ``batches``, then
        ``optimizer.step()``. Returns (the micro-batches' mean metrics,
        [(pred_ids, offsets, batch)]). ``kwargs``: :func:`micro_step`'s
        loss and dtype arguments."""
        if self.remat or not self.auto:
            out = self._grads(batches, device, kwargs)
        else:
            gen_state = (layers.generator_state(self.generator)
                         if self.generator is not None else None)
            buffers = [(b, b.detach().clone())
                       for b in self.model.buffers()]
            try:
                out = self._grads(batches, device, kwargs)
            except torch.cuda.OutOfMemoryError as e:
                self.oom, out = str(e), None
            if out is None:
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                if gen_state is not None:
                    layers.set_generator_state(self.generator, gen_state)
                with torch.no_grad():
                    for b, saved in buffers:
                        b.copy_(saved)
                self.model.zero_grad(set_to_none=True)
                optimizer.zero_grad(set_to_none=True)
                print(f"[WARN] train step failed to fit device memory "
                      f"({'. '.join(self.oom.split('. ')[:2])}); retrying "
                      f"with gradient checkpointing (training.remat: auto)",
                      flush=True)
                self.remat = True
                if self.on_flip is not None:
                    self.on_flip()
                out = self._grads(batches, device, kwargs)
        apply_update(optimizer)
        return out


# ---------------------------------------------------------------------------
# Finetune surgery
# ---------------------------------------------------------------------------

def finetune_surgery(model: BIOPhonemeTagger, arch: TaggerArch, cfg: Config,
                     label_list, generator: torch.Generator) -> None:
    """Load a base checkpoint into ``model``: the language embedding grown
    with N(0, 0.01²) rows, classifier rows carried over by matching tag
    names (reference train.py:334-377)."""
    base_path = cfg.finetuning_model_path
    if not base_path or not os.path.exists(base_path):
        return
    print(f"[INFO] Loading finetune base model: {base_path}")
    base_phoneme_path = base_path.replace("best_model.pt", "phonemes.txt")
    if not os.path.exists(base_phoneme_path):
        raise RuntimeError(
            f"Missing phoneme list for base model: {base_phoneme_path}")
    old_labels = load_phoneme_list(base_phoneme_path)
    sd = read_state_dict(base_path)
    old_langs = sd["lang_emb.weight"].shape[0]
    base = BIOPhonemeTagger(dataclasses.replace(
        arch, num_labels=len(old_labels), num_languages=old_langs))
    base.load_state_dict(sd, strict=True)
    base_sd = {k: v.detach().clone() for k, v in base.state_dict().items()}

    if arch.num_languages > old_langs:
        print(f"[INFO] Expanding lang_emb from {old_langs} -> "
              f"{arch.num_languages}")
        emb = base_sd["lang_emb.weight"]
        grown = 0.01 * torch.randn(
            (arch.num_languages - old_langs, emb.shape[1]),
            generator=generator, device=generator.device).cpu()
        base_sd["lang_emb.weight"] = torch.cat([emb, grown], dim=0)

    new_index = {l: i for i, l in enumerate(label_list)}
    print(f"[INFO] Attempting partial reuse of classifier weights: "
          f"{len(old_labels)} -> {len(label_list)}")
    w = model.classifier.weight.detach().cpu().clone()
    b = model.classifier.bias.detach().cpu().clone()
    matched = 0
    for i, label in enumerate(old_labels):
        if label in new_index:
            w[new_index[label]] = base_sd["classifier.weight"][i]
            b[new_index[label]] = base_sd["classifier.bias"][i]
            matched += 1
    print(f"[INFO] Transferred weights for {matched} matching phoneme tags")
    base_sd["classifier.weight"], base_sd["classifier.bias"] = w, b
    model.load_state_dict(base_sd, strict=True)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _median_filter_np(ids: np.ndarray, size: int) -> np.ndarray:
    """scipy-semantics median filter (symmetric pad, rank size//2) on the
    host, over each row's exact label length."""
    if size <= 1 or ids.size == 0:
        return ids
    left = size // 2
    padded = np.pad(ids, (left, size - 1 - left), mode="symmetric")
    windows = np.lib.stride_tricks.sliding_window_view(padded, size)
    return np.sort(windows, axis=-1)[:, size // 2]


def _gt_segments(segs):
    if isinstance(segs, list) and len(segs) == 1 and isinstance(segs[0], list):
        return segs[0]
    return segs


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _draw_prediction(writer, cfg: Config, batch, j: int, count: int,
                     step: int, segs, gt, id2lang, merge_map) -> None:
    """One ``val/prediction_{count}_{j}`` figure (JAX loop.py:504-518): the
    predicted and ground-truth segments in the sample language's own
    symbols when there is a merge map."""
    from ..utils.viz import visualize_prediction
    lang_name = id2lang.get(int(batch["lang_ids"][j]))
    if merge_map and lang_name:
        segs = [(s, e, canonical_to_lang(ph, lang_name, merge_map))
                for s, e, ph in segs]
        gt = [(s, e, canonical_to_lang(clean_lab(ph), lang_name, merge_map))
              for s, e, ph in gt]
    fig = visualize_prediction(batch["wavs"][j], cfg.sample_rate, segs, gt)
    writer.add_figure(f"val/prediction_{count}_{j}", fig, global_step=step)


@torch.no_grad()
def evaluate(model: BIOPhonemeTagger, val_loader: BatchLoader, label_list,
             cfg: Config, device, writer=None, step: int = 0,
             id2lang: Optional[Dict[int, str]] = None,
             merge_map=None, mesh: Optional[pmesh.Mesh] = None) -> float:
    """Reference evaluate() (train.py:456-545) in eval mode: the mean of
    batch CEs, frame accuracy, PER and TER over median-filtered, BIO-decoded
    and merged segments. With a writer, and matplotlib, the first
    ``num_vis_samples`` samples are drawn as figures. Returns the mean
    CE.

    With ``mesh`` (sharded validation: ``val_loader`` collates this data
    rank's rows of each validation batch, at the batch's padded lengths)
    the metric sums are reduced over the data group, as the JAX
    ``evaluate(cross_host=True)`` does (loop.py:520-535): each batch's CE
    from its ranks' token-weighted sums, then the mean of the batch CEs,
    so every rank gets the one-process metrics. A rank whose share of a
    short batch is empty runs the forward on a stand-in row and counts
    nothing (FSDP's gathers need every rank of the data group)."""
    id2label = dict(enumerate(label_list))
    id2lang = id2lang or {}
    draw = writer is not None and _has_matplotlib()
    model.eval()
    losses, acc, per, ter, count = [], 0.0, 0.0, 0.0, 0
    tokens = []
    for batch in val_loader.epoch_batches(epoch=0):
        arrays = to_device(batch, device)
        logits, offsets = model(arrays["audio"], arrays["lang_ids"],
                                max_label_len=batch["max_label_len"])
        if batch.get("stand_in"):
            losses.append(0.0)
            tokens.append(0.0)
            continue
        losses.append(float(cross_entropy(logits, arrays["labels"],
                                          cfg.label_smoothing)))
        if mesh is not None:
            tokens.append(float((np.asarray(batch["labels"]) != -100).sum()))
            losses[-1] *= tokens[-1]
        pred_ids = logits.argmax(-1).cpu().numpy()
        offsets = offsets.float().cpu().numpy()
        labels = np.asarray(batch["labels"])
        for j in range(len(batch["label_lengths"])):
            n = int(batch["label_lengths"][j])
            ids = _median_filter_np(pred_ids[j, :n], cfg.median_filter)
            segs = decode_bio_tags([id2label[int(p)] for p in ids],
                                   frame_duration=cfg.frame_duration,
                                   offsets=offsets[j, :n])
            if cfg.merge_segments != "none":
                segs = merge_adjacent_segments(segs, mode=cfg.merge_segments)
            gt = _gt_segments(batch["segments_gt"][j])
            acc += framewise_accuracy(pred_ids[j, :n], labels[j, :n])
            per += phoneme_error_rate(segs, gt)
            ter += timing_error_rate(segs, gt)
            count += 1
            if draw and count <= cfg.num_vis_samples:
                _draw_prediction(writer, cfg, batch, j, count, step, segs,
                                 gt, id2lang, merge_map)
    if mesh is not None:
        n = len(losses)
        sums = mesh.sum_over_data(losses + tokens + [acc, per, ter, count])
        losses = [s / t if t else 0.0 for s, t in zip(sums[:n],
                                                       sums[n:2 * n])]
        acc, per, ter, count = sums[2 * n:]
        count = int(round(count))
    avg_loss = float(np.mean(losses)) if losses else 0.0
    avg = [x / count if count else 0.0 for x in (acc, per, ter)]
    if writer is not None:
        for name, val in zip(("loss", "accuracy", "per", "ter"),
                             [avg_loss] + avg):
            writer.add_scalar(f"val/{name}", val, step)
    print(f"\n[Validation] Loss: {avg_loss:.4f} | Acc: {avg[0] * 100:.2f}% | "
          f"PER: {avg[1]:.3f} | TER: {avg[2]:.3f}", flush=True)
    return avg_loss


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def _compute_dtype(cfg: Config) -> torch.dtype:
    name = str(cfg._sec("training").get("compute_dtype", "float32"))
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def _local_seed(seed: int, data_rank: int) -> int:
    """The element-wise dropout seed of a data rank."""
    return int(np.random.SeedSequence((seed, 1 + data_rank))
               .generate_state(1)[0])


def _train_loaders(cfg: Config, dataset: PhonemeDataset, train_idx, val_idx,
                   par: Parallel):
    """(train loader, validation loader) for this rank: on a mesh, this
    data rank's rows of each global batch (at the batch's padded lengths),
    the last partial batch dropped as the JAX loop drops it; across nodes,
    this node's share of the files at the dataset's maximal lengths; with
    sharded validation, this data rank's rows of each validation batch."""
    mesh = par.mesh
    rows, fixed, batch, drop_last = None, (0, 0, 0), cfg.batch_size, False
    if mesh is not None:
        drop_last = True
        nodes = mesh.nodes
        if nodes > 1:
            if cfg.batch_size % nodes:
                raise ValueError(
                    f"batch_size {cfg.batch_size} (global) must be "
                    f"divisible by the {nodes} nodes")
            node = pmesh.rank() // (pmesh.world_size() // nodes)
            batch = cfg.batch_size // nodes
            train_idx = shard_indices_for_process(train_idx, node, nodes)
            fixed = dataset.global_max_lengths()
            print(f"[INFO] Multi-node input: node {node}/{nodes}, "
                  f"{len(train_idx)} files, node batch {batch}, pinned "
                  f"shapes (audio {fixed[0]}, labels {fixed[1]}, targets "
                  f"{fixed[2]})")
        per_node = mesh.data_size // nodes
        per = batch // per_node
        d = mesh.data_rank % per_node
        rows = (d * per, (d + 1) * per)
    train_loader = BatchLoader(dataset, train_idx, batch, seed=cfg.seed,
                               shuffle=True, frame_duration=cfg.frame_duration,
                               drop_last=drop_last, rows=rows,
                               fixed_lengths=fixed)
    val_rows = None
    if par.sharded_validation:
        per = cfg.batch_size // mesh.data_size
        val_rows = (mesh.data_rank * per, (mesh.data_rank + 1) * per)
        print(f"[INFO] Sharded validation: data rank {mesh.data_rank} "
              f"evaluates rows {val_rows[0]}:{val_rows[1]} of each batch")
    val_loader = BatchLoader(dataset, val_idx, cfg.batch_size, seed=cfg.seed,
                             shuffle=False, frame_duration=cfg.frame_duration,
                             rows=val_rows)
    return train_loader, val_loader


def _shard_model(model: BIOPhonemeTagger, par: Parallel, device):
    """Place ``model`` as ``par`` says, in place: tensor parallelism
    (+ sequence parallelism), FSDP, or the mesh alone for DDP. Returns the
    module the steps call (DDP's wrapper, or the model)."""
    mesh = par.mesh
    if mesh is None:
        return model
    if par.pp:
        from ..parallel import pp
        pp.shard_params_pp(model, mesh, par.pp_microbatches)
        local = model.encoder.pipeline.local
        print(f"[INFO] Pipeline parallel: stage {mesh.stage_rank} of "
              f"{mesh.stage_size} holds encoder layers {local[0]}-"
              f"{local[-1]}, data rank {mesh.data_rank} of "
              f"{mesh.data_size}, microbatches "
              f"{par.pp_microbatches or 'one a row'}, transport "
              f"{mesh.transport}")
        return model
    if par.model_parallel > 1:
        ptp.shard_params_tp(model, mesh)
        if par.sequence_parallel and hasattr(model, "encoder"):
            model.encoder.sequence_parallel = True
        return model
    ptp.attach_mesh(model, mesh)
    if par.fsdp:
        par.replicated = tuple(pfsdp.shard_params_fsdp(model, mesh))
        return model
    from torch.nn.parallel import DistributedDataParallel
    return DistributedDataParallel(
        model, device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()]
        if device.type == "cuda" else None,
        process_group=mesh.data_group, broadcast_buffers=False)


def _gradient_hooks(net, model: BIOPhonemeTagger, par: Parallel):
    """(sync, after_backward) for :class:`RematStep`: DDP's ``no_sync`` or
    FSDP's gradient-sync switch on every micro-batch but the last; after
    the backward, the data-group averages of the gradients that neither
    takes (FSDP's replicated leaves; every gradient under tensor
    parallelism)."""
    if par.mesh is None:
        return None, None
    if par.ddp:
        return (lambda last: contextlib.nullcontext() if last
                else net.no_sync()), None

    @contextlib.contextmanager
    def fsdp_sync(last):
        model.set_requires_gradient_sync(last)
        yield

    if par.fsdp:
        return fsdp_sync, lambda: par.mesh.average_grads(par.replicated)
    if par.pp:
        from ..parallel import pp
        params = [p for p in model.parameters() if p.requires_grad]
        replicas = [p for n, p in model.named_parameters()
                    if p.requires_grad and pp.pp_spec(n) == "replicated"]

        def after():
            par.mesh.average_grads(params)
            pp.sync_replicas([p.grad for p in replicas], par.mesh)
        return None, after
    return None, lambda: par.mesh.average_grads(model.parameters())


def _save_checkpoint(path: str, model: BIOPhonemeTagger, par: Parallel
                     ) -> None:
    """The canonical ``.pt`` of ``model`` (gathered from its shards or
    stages: every rank calls this; rank 0 writes)."""
    if par.pp:
        from ..parallel import pp
        full = pp.gather_state_dict(model, par.mesh)
        if par.main:
            canonical = BIOPhonemeTagger(model.arch)
            canonical.load_state_dict(full, strict=True)
            save_model_checkpoint(path, canonical)
        return
    if not par.sharded_params:
        if par.main:
            save_model_checkpoint(path, model)
        return
    full = pfsdp.full_state_dict(model)
    if par.main:
        canonical = BIOPhonemeTagger(model.arch)
        canonical.load_state_dict({k: v.cpu() for k, v in full.items()},
                                  strict=True)
        save_model_checkpoint(path, canonical)


def _save_train_state(path: str, optimizer, step: int, generator,
                      scheduler, par: Parallel, model=None) -> None:
    """The sidecar beside ``path`` (every rank calls this; rank 0 writes):
    the full optimizer state (under pipeline parallelism gathered from the
    stages, with their count as ``pipeline_stages``), the shared
    generator's state as ``generator`` and, on a mesh, every rank's
    element-wise dropout generator's as ``local_generators``."""
    extra = {}
    if par.pp:
        from ..parallel import pp
        names = {p: n for n, p in model.named_parameters()}
        opt_state = pp.gather_optimizer_state(optimizer, names,
                                              par.full_names, par.mesh)
        extra["pipeline_stages"] = par.pipeline
    else:
        opt_state = optimizer.state_dict()
    if isinstance(generator, layers.Generators):
        states = [None] * pmesh.world_size()
        torch.distributed.all_gather_object(states,
                                            generator.local.get_state())
        extra["local_generators"] = states
    if par.main:
        save_train_state(path, opt_state, step,
                         layers.shared_generator(generator),
                         scheduler.state_dict(), extra=extra)


def train(config="config.yaml", device=None, segmental_metric: bool = True,
          on_update: Optional[Callable[[int, List[Dict]], None]] = None
          ) -> BIOPhonemeTagger:
    """Train from ``config`` (a YAML path, a dict or a ``Config``) on
    ``device`` (CUDA unless "cpu" is asked for). Returns the model.
    ``on_update(step, batches)``, when given, is called after each
    optimizer update with the update's micro-batches (this rank's rows).
    Under a launcher (or a process group the caller made) the run spreads
    over the world as the module docstring says."""
    cfg = as_config(config)
    check_supported(cfg)
    pmesh.maybe_initialize_distributed(
        device="cpu" if str(device) == "cpu" else "cuda")
    device = resolve_device(device)
    save_dir = cfg.save_dir
    os.makedirs(save_dir, exist_ok=True)

    label_list = load_phoneme_list(os.path.join(save_dir, "phonemes.txt"))
    id2lang = {i: lang for lang, i in load_langs(
        os.path.join(save_dir, "langs.txt")).items()}
    merge_map = load_phoneme_merge_map(
        os.path.join(save_dir, "phoneme_merge_map.json"))
    dataset = PhonemeDataset(os.path.join(save_dir, "dataset.json"),
                             label_list, cfg.max_seq_len, cfg.augmentation,
                             cfg.sample_rate)
    train_idx, val_idx = split_dataset(len(dataset), cfg.num_val_files,
                                       cfg.seed)
    if not train_idx:
        raise ValueError(
            f"num_val_files={cfg.num_val_files} leaves no training samples "
            f"(dataset has {len(dataset)})")
    par = plan_parallel(cfg, device)
    mesh = par.mesh
    train_loader, val_loader = _train_loaders(cfg, dataset, train_idx,
                                              val_idx, par)

    arch = TaggerArch.from_config(cfg, len(label_list))
    if par.model_parallel > 1:
        ptp.check_divisible(arch, par.model_parallel)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    model = init_tagger(arch, torch.Generator().manual_seed(cfg.seed),
                        device=device)
    if cfg.finetuning_enable:
        finetune_surgery(model, arch, cfg, label_list, generator)
    if arch.freeze_encoder and arch.encoder_type != "none":
        model.encoder.requires_grad_(False)

    def new_optimizer():
        return make_optimizer(
            cfg, [p for p in model.parameters() if p.requires_grad],
            model.jax_leaf_blocks())

    optimizer = new_optimizer()
    base_lr = cfg.learning_rate
    scheduler = get_scheduler(cfg.scheduler, cfg.scheduler_params,
                              base_lr=base_lr)
    if mesh is not None and (mesh.data_size > 1 or par.pp):
        # element-wise dropout: a stream a data rank (a rank under
        # pipeline parallelism, whose stages run different layers)
        generator = layers.Generators(
            torch.Generator(device=device).manual_seed(_local_seed(
                cfg.seed, pmesh.rank() if par.pp else mesh.data_rank)),
            generator)

    best_loss, checkpoint_paths = float("inf"), []
    # resume into the unsharded model; the shards are cut from it after
    step = _resume(model, optimizer, generator, scheduler, save_dir,
                   stages=par.pipeline)
    if step:
        checkpoint_paths = [p for p, _ in sorted(
            find_resume_checkpoints(save_dir), key=lambda c: c[1])
        ][-cfg.max_checkpoints:]
    else:
        print("Training start")
    if par.pp:
        par.full_names = [n for n, p in model.named_parameters()
                          if p.requires_grad]
        full_state = optimizer.state_dict()
    net = _shard_model(model, par, device)
    if par.pp:
        from ..parallel import pp
        named = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
        optimizer = make_optimizer(
            cfg, list(named.values()), model.jax_leaf_blocks(),
            stacked=pp.StackedLeaves(named, mesh,
                                     model.encoder.pipeline.num_layers))
        if full_state["state"]:
            optimizer.load_state_dict(pp.stage_optimizer_state(
                full_state, par.full_names, list(named)))
        del full_state
    elif par.sharded_params:
        state = optimizer.state_dict()
        optimizer = pfsdp.FullTensorStep(new_optimizer())
        if state["state"]:
            optimizer.load_state_dict(state)

    writer = None
    if par.main:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(cfg.log_dir)
        except ImportError:
            writer = None
    os.makedirs(cfg.log_dir, exist_ok=True)
    metrics_log = (open(os.path.join(cfg.log_dir, "metrics.jsonl"), "a")
                   if par.main else open(os.devnull, "w"))

    def log_event(kind: str, step_: int, **fields) -> None:
        metrics_log.write(json.dumps(
            {"event": kind, "step": step_, "time": time.time(), **fields})
            + "\n")
        metrics_log.flush()

    compute_dtype = _compute_dtype(cfg)
    accum = int(cfg._sec("training").get("grad_accumulation", 1))
    if accum > 1:
        print(f"[INFO] Gradient accumulation: {accum} micro-batches per "
              f"update (effective batch {accum * cfg.batch_size})")
    remat = remat_mode(cfg)
    if remat == "on":
        print("[INFO] Gradient checkpointing (remat) on encoder layers")
    elif remat == "auto":
        print("[INFO] training.remat: auto — gradient checkpointing will "
              "engage only if the train step overflows device memory")
    sync, after_backward = _gradient_hooks(net, model, par)
    update = RematStep(remat, net, generator, on_flip=lambda: log_event(
        "remat_auto_flip", step, remat=True), sync=sync,
        after_backward=after_backward)
    restart_loader = bool(cfg._sec("training").get(
        "restart_loader_on_validation", False))
    id2label = dict(enumerate(label_list))
    step_kwargs = dict(label_smoothing=cfg.label_smoothing,
                       subframe_weight=cfg.subframe_loss_weight,
                       compute_dtype=compute_dtype,
                       seg_diff_weight=cfg.differentiable_segmental_weight)
    if mesh is not None and mesh.data_size > 1:
        step_kwargs["mean_count"] = mesh.mean_count
    val_kwargs = {"mesh": mesh} if par.sharded_validation else {}

    # One-step-delayed readback: step N's metrics are read on the host
    # while step N+1 runs on the device (drained before every validation).
    pending = None
    last_log = time.time()

    def drain_pending() -> None:
        nonlocal pending, last_log
        if pending is None:
            return
        p_step, p_metrics, p_micro, p_lr = pending
        pending = None
        with span("wfl.readback"):
            loss_val = float(p_metrics["loss"])
            offset_val = float(p_metrics["offset_loss"])
        if segmental_metric and cfg.segmental_loss_weight != 0.0:
            with span("wfl.host_metric"):
                seg_total, n_samples = 0.0, 0
                for pred, off, batch in p_micro:
                    pred, off = pred.cpu().numpy(), off.float().cpu().numpy()
                    for i, ll in enumerate(batch["label_lengths"]):
                        ll = int(ll)
                        segs = decode_bio_tags(
                            [id2label[int(p)] for p in pred[i, :ll]],
                            frame_duration=cfg.frame_duration,
                            offsets=off[i, :ll])
                        seg_total += segmental_loss_value(
                            segs, _gt_segments(batch["segments_gt"][i]),
                            cfg.segmental_loss_weights)
                    n_samples += len(batch["label_lengths"])
                if mesh is not None:
                    seg_total, n_samples = mesh.sum_over_data(
                        [seg_total, n_samples])
                loss_val += (cfg.segmental_loss_weight * seg_total
                             / max(n_samples, 1))
        with span("wfl.log"):
            if writer is not None:
                writer.add_scalar("train/loss", loss_val, p_step)
                writer.add_scalar("train/offset_loss", offset_val, p_step)
            log_event("train", p_step, loss=loss_val,
                      offset_loss=offset_val, lr=p_lr)
            now = time.time()
            print(f"[train] step {p_step} loss {loss_val:.4f} offset_loss "
                  f"{offset_val:.4f} lr {p_lr:g} "
                  f"({1.0 / max(now - last_log, 1e-9):.2f} it/s)",
                  flush=True)
        last_log = now

    with maybe_trace("train"):
        micro: List = []
        epoch = 0
        while step < cfg.max_steps:
            epoch_ran = False
            for batch in train_loader.epoch_batches(epoch):
                epoch_ran = True
                micro.append(batch)
                if len(micro) < accum:
                    continue
                with span("wfl.update", step=step + 1) as upd:
                    lr_used = base_lr * scheduler.factor
                    set_lr(optimizer, lr_used)
                    recomputed_before = recomputed()
                    metrics, update_micro = update(optimizer, micro, device,
                                                   **step_kwargs)
                    upd.set(recomputed=recomputed() - recomputed_before)
                    if mesh is not None:
                        metrics = mesh.average_scalars(metrics)
                    micro = []
                    if cfg.scheduler_step_on_update:
                        scheduler.step()
                    step += 1
                    if on_update is not None:
                        on_update(step, [b for _, _, b in update_micro])

                    drain_pending()
                    pending = (step, metrics, update_micro, lr_used)

                if step % cfg.val_check_interval == 0:
                    drain_pending()
                    val_loss = evaluate(model, val_loader, label_list, cfg,
                                        device, writer, step, id2lang,
                                        merge_map, **val_kwargs)
                    log_event("val", step, loss=val_loss)
                    model_path = os.path.join(save_dir, f"model_step{step}.pt")
                    _save_checkpoint(model_path, model, par)
                    _save_train_state(model_path, optimizer, step, generator,
                                      scheduler, par, model)
                    checkpoint_paths.append(model_path)
                    if len(checkpoint_paths) > cfg.max_checkpoints:
                        old = checkpoint_paths.pop(0)
                        if par.main:
                            remove_checkpoint(old)
                    if val_loss < best_loss:
                        best_loss = val_loss
                        _save_checkpoint(
                            os.path.join(save_dir, "best_model.pt"), model,
                            par)
                        print(f"\nSaved best model with loss = {val_loss:.4f}")
                    if not cfg.scheduler_step_on_update:
                        if type(scheduler).__name__ == "ReduceLROnPlateau":
                            scheduler.step(best_loss)
                        else:
                            scheduler.step(step)
                    if writer is not None:
                        writer.add_scalar("train/learning_rate",
                                          base_lr * scheduler.factor, step)
                    if restart_loader:
                        break
                if step >= cfg.max_steps:
                    break
            drain_pending()
            if not epoch_ran:
                raise ValueError(
                    f"training epoch produced no batches ({len(train_idx)} "
                    f"train samples, batch_size {cfg.batch_size})")
            epoch += 1

    _save_checkpoint(os.path.join(save_dir, "last_model.pt"), model, par)
    metrics_log.close()
    if writer is not None:
        writer.close()
    print("\nTraining complete at max_steps!")
    return model


# what torch.load raises on a torn or truncated file (the weights-only
# unpickler raises IndexError or KeyError on a cut stream)
_TORN = (EOFError, pickle.UnpicklingError, zipfile.BadZipFile, ValueError,
         OSError, RuntimeError, IndexError, KeyError)


def _restore_generators(generator, state: dict) -> None:
    """The sidecar's generator state into ``generator``; of a pair, into
    its shared stream, and this rank's element-wise stream from
    ``local_generators`` when the sidecar has one for as many ranks (else
    that stream keeps its seed)."""
    layers.shared_generator(generator).set_state(state["generator"])
    if isinstance(generator, layers.Generators):
        states = state.get("local_generators") or []
        if len(states) == pmesh.world_size():
            generator.local.set_state(states[pmesh.rank()])


def _resume(model, optimizer, generator, scheduler, save_dir: str,
            stages: int = 1) -> int:
    """Load the newest readable ``model_step{N}.pt`` or ``.pt.npz`` and its
    sidecar — the port's ``.train.pt``, else a JAX ``.train.npz``; returns
    its step, or 0 when there is none. A torn file falls back to the next
    older one; a readable checkpoint that does not fit the model (the
    config changed) raises, as does a save_dir whose checkpoints are all
    unreadable. ``stages``: the run's pipeline stages; an optimizer state
    kept per stacked leaf (sm3's, novograd's) that was saved under another
    stage count starts fresh."""
    candidates = find_resume_checkpoints(save_dir)
    errors = []
    for path, step in candidates:
        try:
            sd = read_state_dict(path)
        except _TORN as e:
            print(f"[WARN] Skipping unreadable checkpoint "
                  f"{os.path.basename(path)}: {e}")
            errors.append(e)
            continue
        try:
            model.load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise RuntimeError(
                f"Checkpoint {os.path.basename(path)} is readable but does "
                f"not match the configured model. If the model config "
                f"changed, point output.save_dir at a fresh directory "
                f"instead of resuming over the old run.") from e
        print(f"Resuming from checkpoint: {os.path.basename(path)} "
              f"(step {step})")
        try:
            state = load_train_state(path)
        except _TORN as e:
            print(f"[WARN] Unreadable train-state sidecar, starting the "
                  f"optimizer fresh: {e}")
            state = None
        saved_stages = int((state or {}).get("pipeline_stages", 1))
        if state is not None and (saved_stages > 1) != (stages > 1) \
                and getattr(optimizer, "optax_name", "") in STACKED_STATE:
            print(f"[INFO] {os.path.basename(path)}: the "
                  f"{type(optimizer).__name__} state was saved with "
                  f"{saved_stages} pipeline stage(s) and does not map onto "
                  f"a run with {stages}; the optimizer starts fresh")
            _restore_generators(generator, state)
            if state["scheduler"]:
                scheduler.load_state_dict(state["scheduler"])
            return step
        if state is not None:
            optimizer.load_state_dict(state["optimizer"])
            _restore_generators(generator, state)
            if state["scheduler"]:
                scheduler.load_state_dict(state["scheduler"])
            print("[INFO] Restored optimizer, generator and scheduler state")
            return step
        try:
            state = restore_jax_train_state(path, model, optimizer,
                                            pipeline=stages > 1)
        except _TORN as e:
            print(f"[WARN] Unreadable JAX train-state sidecar, starting the "
                  f"optimizer fresh: {e}")
            optimizer.state.clear()
            state = None
        if state is not None:
            if state["scheduler"]:
                scheduler.load_state_dict(state["scheduler"])
        else:
            # a fresh optimizer: Prodigy takes p0 from the loaded
            # parameters at its first step
            print("[INFO] No train-state sidecar: optimizer starts fresh "
                  "from the loaded parameters")
        return step
    if candidates:
        raise RuntimeError(
            f"{len(candidates)} checkpoint(s) found in {save_dir} but none "
            f"could be loaded (last error: {errors[-1]}). Delete the "
            f"unreadable files to deliberately restart.")
    return 0


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description="Train the WFL model with a config file (PyTorch port); "
                    "torchrun --nproc_per_node N runs it on N ranks")
    parser.add_argument("config", type=str, help="Path to the config.yaml")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        train(args.config, device=args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
