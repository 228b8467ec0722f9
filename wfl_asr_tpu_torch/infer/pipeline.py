"""Inference pipeline: wav → (chunked) forward → postprocess → HTK ``.lab``.
The port of ``wfl_asr_tpu/infer/pipeline.py``.

Behavioral contract (reference infer.py end to end), as in the JAX package:

- 30 s chunking with per-chunk re-normalization and time shifting
  (infer.py:19-28, 98-184; quirk Q11 double-normalize kept);
- per-language logits/offsets averaging when ``lang_id`` is None, as ONE
  batched forward over all language ids;
- the ``.wfl_cache`` logits/offsets cache under the reference's file names,
  entries in torch format;
- confidence gate → median filter → BIO decode with sub-frame offsets →
  canonical→language mapping → segment merging → forced alignment;
- sampling flags accepted with the reference's dead semantics (quirk Q2).

Audio is padded into 1 s buckets; sample and frame masks make valid-frame
outputs equal exact-length runs, so rows of different lengths share one
forward. With ``postprocess.device_decode`` the batched folder mode runs
language averaging, gate, masked median and the BIO state machine on the
device and moves segment arrays to the host once; the host multiplies
``(idx + offset) * Δ`` in float64 (``.lab`` truncation parity).

The batched folder mode launches ahead, on one thread: a group's encoder
is launched with no wait for the card (rows copied from a pinned buffer
without blocking, masks built on the device), and while the card runs it
the host writes the previous group's cache entries and ``.lab`` files
(the host decode's gate and median on a stream of their own) and reads
and assembles the next group's rows; then the heads run (the BiLSTM waits
for the encoder) and the outputs are read back. Each rank's device work
keeps its order, the files' bytes are those of the serial order, and a
read that fails in the shadow is raised once the group in flight is
written, as the serial order would.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no CUDA device they raise. ``model.serving_quantization: int8`` swaps the
encoder's large linears for W8A8-dynamic int8 ones at load
(``models.layers.quantize_int8``).

Under a launcher (``torchrun``, one process a GPU):
``infer_folder_batched(data_parallel=None)`` spreads each batch of files
over the ranks (on when the world has more than one rank): each rank serves
a contiguous share of the batch's files, at the whole batch's bucket length,
and writes their ``.lab`` and ``.wfl_cache`` files. ``InferenceSession(...,
model_parallel=N)`` shards the weights for tensor-parallel serving
(``parallel/tp.py``), with ``model.sequence_parallel`` as in training.
``model.pipeline_parallel: S`` pipelines the encoder's layers over a
``(data, stage)`` mesh of the world (``parallel/pp.py``, one row a
microbatch, as the JAX session runs it); every stage of a pipeline calls
the forwards with the same rows, the heads run on every stage, and the
pipeline's first stage alone writes ``.lab`` and ``.wfl_cache`` files.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..checkpoint import load_model_checkpoint
from ..config import Config, as_config
from ..data.audio import peak_normalize, read_wav, resample, \
    resampled_length, wav_duration
from ..labels import (Segment, align_phoneme_list, canonical_to_lang,
                      decode_bio_tags, load_langs, load_phoneme_list,
                      load_phoneme_merge_map, merge_adjacent_segments,
                      save_lab)
from ..models.layers import quantize_int8
from ..models.tagger import TaggerArch
from ..parallel import mesh as pmesh
from ..ops.frontend import WHISPER_N_SAMPLES
from ..ops.postprocess import (bio_tables, confidence_gate_ids,
                               extract_segments_ids, median_filter_ids,
                               median_filter_ids_masked)
from ..utils.profiling import span

FRAME_DURATION = 0.02          # reference infer.py:12
MAX_SEGMENT_DURATION = 30.0    # reference infer.py:13
BUCKET_SECONDS = 1.0           # padding granularity of the bucketed forward
MEL_CENTER_PAD = 200           # n_fft // 2 of the mel front end's STFT

ConfigLike = Union[str, Config, dict]


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" → the CUDA device, which must exist; "cpu" only when
    asked for. Never a quiet fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def split_audio(audio: np.ndarray, sr: int,
                max_duration: float = MAX_SEGMENT_DURATION) -> List[np.ndarray]:
    """Fixed-size 30 s splits (reference infer.py:19-28)."""
    samples_per_segment = int(max_duration * sr)
    return [audio[start:start + samples_per_segment]
            for start in range(0, len(audio), samples_per_segment)]


class Rows(NamedTuple):
    """A bucketed forward's rows as :meth:`InferenceSession.assemble`
    wrote them: ``audio`` [R, W] f32, one row an (item, language) pair;
    ``meta`` [3, R] int64, each row's language id, samples and frames;
    both views of the session's staging buffer. ``t_pad``: the bucket's
    frames; ``masked``: the forward takes per-row masks; ``t_refs``: each
    item's frames."""
    audio: torch.Tensor
    meta: torch.Tensor
    bucket: int
    t_pad: int
    masked: bool
    t_refs: List[int]


class _Staging:
    """The host side of the forwards' inputs: one buffer, pinned on CUDA
    (plain memory on the CPU), that a batch's rows are written into. It is
    written again only once an event says its last copy to the card is
    done; a forward's copy is the first work queued for it, so rows
    assembled while that forward runs seldom wait."""

    def __init__(self, device: torch.device):
        self.pin = device.type == "cuda"
        self.audio: Optional[torch.Tensor] = None
        self.meta: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None

    def take(self, rows: int, width: int):
        """(audio [rows, width] f32, meta [3, rows] int64): the buffer, once
        its last copy is done, grown to fit."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None
        if self.audio is None or self.audio.numel() < rows * width:
            self.audio = torch.empty(rows * width, dtype=torch.float32,
                                     pin_memory=self.pin)
        if self.meta is None or self.meta.numel() < 3 * rows:
            self.meta = torch.empty(3 * rows, dtype=torch.int64,
                                    pin_memory=self.pin)
        return (self.audio[:rows * width].view(rows, width),
                self.meta[:3 * rows].view(3, rows))

    def sent(self) -> None:
        """Marks the buffer's copies as issued on the current stream."""
        if self.pin:
            self.copied = torch.cuda.Event()
            self.copied.record()


class InferenceSession:
    """A loaded tagger on one device, with the bucketed forward.

    ``model_parallel`` > 1 (under an initialized process group): the
    weights sharded for tensor parallelism over a ``("data", "model")``
    mesh of the world; every rank of a model group must then call the
    forwards with the same rows. ``data_parallel``: a mesh over the world
    (model dim 1) for :func:`infer_folder_batched` to spread files over;
    the forwards stay rank-local. ``model.pipeline_parallel: S`` (the
    config's): the encoder's layers over S stages of a ``(data, stage)``
    mesh of the world, each stage holding its share (``parallel/pp.py``);
    ``writes`` is then true on each pipeline's first stage only."""

    def __init__(self, config: ConfigLike, checkpoint_path: str,
                 compute_dtype: torch.dtype = torch.float32,
                 arch: Optional[TaggerArch] = None, device=None,
                 model_parallel: int = 1, data_parallel: bool = False):
        self.device = resolve_device(device)
        self.cfg = as_config(config)
        save_dir = self.cfg.save_dir
        self.label_list = load_phoneme_list(os.path.join(save_dir,
                                                         "phonemes.txt"))
        self.label2id = {l: i for i, l in enumerate(self.label_list)}
        self.id2label = {i: l for i, l in enumerate(self.label_list)}
        self.lang2id = load_langs(os.path.join(save_dir, "langs.txt"))
        self.merge_map = load_phoneme_merge_map(
            os.path.join(save_dir, "phoneme_merge_map.json"))
        self.arch = arch or TaggerArch.from_config(self.cfg,
                                                   len(self.label_list))
        quant = self.cfg.serving_quantization
        if quant not in ("none", "int8"):
            raise ValueError(f"model.serving_quantization={quant!r}: only "
                             f"'int8' or 'none' are supported")
        pp_stages = int(self.cfg.serving_pipeline_parallel)
        if pp_stages > 1 and self.arch.encoder_type not in ("wavlm",
                                                            "whisper"):
            raise ValueError("model.pipeline_parallel needs a layered "
                             "encoder (wavlm or whisper)")
        model_parallel = int(model_parallel)
        if pp_stages > 1:
            if model_parallel > 1:
                raise ValueError(
                    "model.pipeline_parallel needs a ('data','stage') "
                    "mesh; the session was given one without a 'stage' "
                    "axis")
            if pmesh.world_size() % pp_stages:
                raise ValueError(
                    f"model.pipeline_parallel={pp_stages} does not divide "
                    f"the {pmesh.world_size()} visible devices")
        if model_parallel > 1 and quant == "int8":
            raise ValueError("model.serving_quantization: int8 and "
                             "model_parallel > 1 do not combine")
        model = load_model_checkpoint(checkpoint_path, self.arch)
        self.quantized: List[str] = []
        if quant == "int8" and self.arch.encoder_type != "none":
            # W8A8-dynamic int8 on the encoder's large linears, quantized
            # on the CPU before the move (pipeline.py:141-159)
            self.quantized = quantize_int8(model.encoder)
            print("[INFO] int8 serving: encoder linears quantized "
                  "(W8A8-dynamic, per-output-channel weights)")
        self.model = model.to(self.device)
        self.mesh = None
        self.writes = True
        if pp_stages > 1:
            from ..parallel import pp
            self.mesh = pp.make_pp_mesh(pp_stages, self.device)
            pp.shard_params_pp(self.model, self.mesh)
            self.writes = self.mesh.first
            print(f"[INFO] pipeline-parallel serving: encoder layers over "
                  f"{pp_stages} stages (mesh {self.mesh.shape}, transport "
                  f"{self.mesh.transport})")
        elif model_parallel > 1 or (data_parallel
                                  and torch.distributed.is_initialized()):
            from ..parallel import tp
            self.mesh = pmesh.make_mesh(model_parallel, self.device)
            if model_parallel > 1:
                tp.shard_params_tp(self.model, self.mesh)
                print(f"[INFO] tensor-parallel serving: mesh "
                      f"{self.mesh.shape}")
        # model.sequence_parallel: the encoder's time axis sharded between
        # layers (parallel/sp.py); needs a mesh with model > 1
        self.sequence_parallel = bool(self.cfg.serving_sequence_parallel
                                      and model_parallel > 1)
        if self.cfg.serving_sequence_parallel and not self.sequence_parallel:
            print("[WARN] model.sequence_parallel ignored: the session has "
                  "no mesh with a >1 'model' axis")
        if self.sequence_parallel and self.arch.encoder_type != "none":
            self.model.encoder.sequence_parallel = True
        self.compute_dtype = compute_dtype
        self.sr = self.cfg.sample_rate
        # Position-bias store: one buffer at the largest bucket length seen
        # (every shorter length's bias is its leading [:t, :t] block), at
        # the compute dtype, plus a small LRU of sliced shorter views.
        self._pos_bias_full: Optional[torch.Tensor] = None
        self._pos_bias_len = 0
        self._pos_bias_slices: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        self._pos_bias_slice_cap = 4
        self._bio_cache = None
        self._staging = _Staging(self.device)
        # the host decode's gate and median run on a stream of their own, so
        # that their readback does not wait for a forward in flight
        self._decode_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)

    # -- forward --------------------------------------------------------------

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(x)).to(self.device)

    def _pos_bias_for(self, t_pad: int) -> Optional[torch.Tensor]:
        """WavLM's position bias for a bucket length, computed once per
        session at the largest length seen and sliced for shorter ones
        (bounded); None for the other encoders."""
        if self.arch.encoder_type != "wavlm":
            return None
        if t_pad > self._pos_bias_len:
            with torch.inference_mode():
                bias = self.model.encoder.position_bias(t_pad)
            if self.compute_dtype == torch.bfloat16:
                bias = bias.to(torch.bfloat16)   # the kernel reads it so
            self._pos_bias_full = bias
            self._pos_bias_len = t_pad
            self._pos_bias_slices.clear()
        if t_pad == self._pos_bias_len:
            return self._pos_bias_full
        if t_pad not in self._pos_bias_slices:
            self._pos_bias_slices[t_pad] = \
                self._pos_bias_full[:, :t_pad, :t_pad].contiguous()
            while len(self._pos_bias_slices) > self._pos_bias_slice_cap:
                self._pos_bias_slices.popitem(last=False)
        else:
            self._pos_bias_slices.move_to_end(t_pad)
        return self._pos_bias_slices[t_pad]

    def assemble(self, audios: Sequence[np.ndarray],
                 lang_ids_per_item: Sequence[Sequence[int]],
                 bucket: Optional[int] = None,
                 masked: Optional[bool] = None) -> Rows:
        """Every (item, language) row of one bucketed forward, written into
        the session's staging buffer: the item's audio zero-filled to
        the bucket (``bucket``: the padded length, at least; a share of a
        larger batch runs at the batch's); for the mel front end first
        reflect-padded by 200 at its exact length (the centring the device
        STFT then skips), so the tail frames equal an exact-length run
        (pipeline.py:339-348). ``masked`` (default: every encoder but
        Whisper, which pads each row to 30 s itself): the forward takes
        per-row sample and frame masks. Rows assembled earlier are
        overwritten: launch them first."""
        s_true = [len(a) for a in audios]
        bucket = max(bucket or 0, self._bucket(max(s_true)))
        mel = self.arch.encoder_type == "none"
        width = bucket + 2 * MEL_CENTER_PAD if mel else bucket
        n_rows = sum(len(langs) for langs in lang_ids_per_item)
        audio, meta = self._staging.take(n_rows, width)
        rows, info = audio.numpy(), meta.numpy()
        t_refs = [self.num_frames_for(s) for s in s_true]
        r = 0
        for a, langs, t_ref in zip(audios, lang_ids_per_item, t_refs):
            n_samples = len(a)
            if mel:
                a = np.pad(np.asarray(a, np.float32), MEL_CENTER_PAD,
                           mode="reflect")
            rows[r:r + len(langs), :len(a)] = a
            rows[r:r + len(langs), len(a):] = 0.0
            info[0, r:r + len(langs)] = langs
            info[1:, r:r + len(langs)] = [[n_samples], [t_ref]]
            r += len(langs)
        if masked is None:
            masked = self.arch.encoder_type != "whisper"
        return Rows(audio, meta, bucket, self.num_frames_for(bucket), masked,
                    t_refs)

    def launch(self, rows: Rows,
               shadow: Optional[Callable[[], None]] = None):
        """One forward over assembled rows → DEVICE (logits, offsets) at the
        compute dtype. The rows are copied to the device without blocking
        the host (into tensors of their own: the staging buffer may be
        written again once the copy is done) and the masks are built there.
        ``shadow``, host work done while the forward is in flight, runs
        between the encoder's launch and the heads': the BiLSTM waits for
        the card (its lengths' read back, then cuDNN's call, which returns
        once the card has run it), so work put there overlaps the encoder."""
        dev = self.device
        with torch.inference_mode():
            with span("wfl.stage"):
                x = rows.audio.to(dev, non_blocking=True, copy=True)
                meta = rows.meta.to(dev, non_blocking=True, copy=True)
                self._staging.sent()
                sample_mask = frame_mask = None
                if rows.masked:
                    sample_mask = (torch.arange(rows.bucket, device=dev)
                                   < meta[1, :, None])
                    frame_mask = (torch.arange(rows.t_pad, device=dev)
                                  < meta[2, :, None])
            with span("wfl.encoder"):
                hidden = self.model.encode(
                    x, sample_mask, frame_mask, self.compute_dtype,
                    self._pos_bias_for(rows.t_pad),
                    precentered=self.arch.encoder_type == "none")
        if shadow is not None:
            with span("wfl.shadow"):
                shadow()
        with torch.inference_mode():
            return self.model.heads(hidden, meta[0], frame_mask=frame_mask)

    def samples_run(self, bucket: int) -> int:
        """Samples the encoder computes on a row of a ``bucket``-sample
        batch: the bucket; Whisper's front end pads every row to 30 s."""
        return (WHISPER_N_SAMPLES if self.arch.encoder_type == "whisper"
                else bucket)

    def num_frames_for(self, num_samples: int) -> int:
        """Frames the reference model emits for this exact length: Whisper
        always 1500 (30 s); WavLM its conv recurrence, clamped at 0 (it
        goes negative below one receptive field); the mel front end
        ``S // hop + 1`` (0 for no samples)."""
        if self.arch.encoder_type == "whisper":
            return self.arch.whisper.max_source_positions
        if self.arch.encoder_type == "wavlm":
            return max(self.arch.wavlm.feature_lengths(num_samples), 0)
        hop = int(self.arch.frame_duration * self.sr)
        return num_samples // hop + 1 if num_samples > 0 else 0

    def _bucket(self, num_samples: int) -> int:
        unit = int(BUCKET_SECONDS * self.sr)
        return max(int(np.ceil(num_samples / unit)), 1) * unit

    def forward(self, audio: np.ndarray, lang_ids: Sequence[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-length forward on bucketed shapes: audio [S]; the same
        audio is batched over ``lang_ids``. Returns f32
        (logits [L, T_ref, n_tags], offsets [L, T_ref, 2])."""
        s_true = len(audio)
        n = len(lang_ids)
        t_ref = self.num_frames_for(s_true)
        if t_ref == 0:
            return (np.zeros((n, 0, self.arch.num_labels), np.float32),
                    np.zeros((n, 0, 2), np.float32))
        bucket = self._bucket(s_true)
        with span("wfl.forward", rows=n, samples_true=n * s_true,
                  samples_run=n * self.samples_run(bucket)):
            # Whisper pads every row to 30 s itself and runs unmasked
            masked = self.arch.encoder_type != "whisper" and s_true != bucket
            logits, offsets = self.launch(self.assemble(
                [audio], [list(lang_ids)], bucket, masked))
        with span("wfl.readback"):
            return (logits[:, :t_ref].float().cpu().numpy(),
                    offsets[:, :t_ref].float().cpu().numpy())

    def _forward_many_device(self, audios: Sequence[np.ndarray],
                             lang_ids_per_item: Sequence[Sequence[int]],
                             bucket: Optional[int] = None,
                             rows: Optional[Rows] = None,
                             shadow: Optional[Callable[[], None]] = None):
        """One bucketed forward over every (item, language) row with per-row
        masks; returns DEVICE outputs and each item's true frame count.
        ``bucket``: the padded length (a share of a larger batch runs at
        the batch's); ``rows``: the items' rows assembled ahead;
        ``shadow``: as :meth:`launch`'s."""
        s_true = [len(a) for a in audios]
        bucket = max(bucket or 0, self._bucket(max(s_true)))
        n_rows = sum(len(langs) for langs in lang_ids_per_item)
        with span("wfl.forward", rows=n_rows,
                  samples_true=sum(s * len(langs) for s, langs in
                                   zip(s_true, lang_ids_per_item)),
                  samples_run=n_rows * self.samples_run(bucket),
                  ahead=int(rows is not None)):
            if rows is None:
                rows = self.assemble(audios, lang_ids_per_item, bucket)
            logits, offsets = self.launch(rows, shadow)
        return logits, offsets, rows.t_refs

    def forward_many(self, audios: Sequence[np.ndarray],
                     lang_ids_per_item: Sequence[Sequence[int]],
                     bucket: Optional[int] = None,
                     rows: Optional[Rows] = None,
                     shadow: Optional[Callable[[], None]] = None):
        """Batched multi-utterance forward; per item (logits [L_i, T_i, n],
        offsets [L_i, T_i, 2]) as f32 numpy. ``bucket``: the padded length
        to run at, at least. ``rows``: the items' rows, assembled ahead
        (:meth:`assemble`). ``shadow``: host work run while the forward is
        in flight, after the encoder's launch and before the heads' and the
        readback (:meth:`launch`)."""
        if not audios:
            return []
        logits, offsets, t_refs = self._forward_many_device(
            audios, lang_ids_per_item, bucket, rows, shadow)
        with span("wfl.readback"):
            logits = logits.float().cpu().numpy()
            offsets = offsets.float().cpu().numpy()
        out, row = [], 0
        for i, langs in enumerate(lang_ids_per_item):
            n = len(langs)
            out.append((logits[row:row + n, :t_refs[i]],
                        offsets[row:row + n, :t_refs[i]]))
            row += n
        return out

    def _bio(self):
        """Cached (kind_table, ph_table on the device, ph_names)."""
        if self._bio_cache is None:
            kind, ph, names = bio_tables(self.label_list)
            self._bio_cache = (self._to_device(kind), self._to_device(ph),
                               names)
        return self._bio_cache

    def forward_many_decoded(self, audios: Sequence[np.ndarray],
                             langs: Sequence[int],
                             confidence_threshold: float, median_size: int,
                             bucket: Optional[int] = None,
                             rows: Optional[Rows] = None,
                             shadow: Optional[Callable[[], None]] = None):
        """Batched forward + device-side language averaging, gate, masked
        median and BIO decode; one host transfer of segment arrays (plus the
        averaged logits/offsets the ``.wfl_cache`` needs). Every item uses
        the language list ``langs``. ``rows``, ``shadow``: as
        :meth:`forward_many`'s. Returns per item
        ``(mean_logits [T_i, n], mean_offsets [T_i, 2], segments)``."""
        if not audios:
            return []
        n_items, n_langs = len(audios), len(langs)
        logits, offsets, t_refs = self._forward_many_device(
            audios, [list(langs)] * n_items, bucket, rows, shadow)
        kind_t, ph_t, ph_names = self._bio()
        o_id = self.label2id["O"]
        with span("wfl.decode"), torch.inference_mode():
            lg = logits.float().reshape((n_items, n_langs)
                                        + logits.shape[1:]).mean(dim=1)
            off = offsets.float().reshape((n_items, n_langs)
                                          + offsets.shape[1:]).mean(dim=1)
            ids = confidence_gate_ids(lg, confidence_threshold, o_id)
            decoded = []
            for i in range(n_items):
                ids_i = ids[i]
                if median_size > 1:
                    ids_i = median_filter_ids_masked(ids_i, median_size,
                                                     t_refs[i])
                decoded.append(extract_segments_ids(ids_i, off[i], t_refs[i],
                                                    kind_t, ph_t))
            # the single host transfer
            with span("wfl.readback"):
                b, e, p, so, eo, cnt = (torch.stack(x).cpu().numpy()
                                        for x in zip(*decoded))
                mlg, moff = lg.cpu().numpy(), off.cpu().numpy()
            out = []
            for i in range(n_items):
                segs = []
                for k in range(int(cnt[i])):
                    st = (int(b[i, k]) + float(so[i, k])) * FRAME_DURATION
                    en = (int(e[i, k]) + float(eo[i, k])) * FRAME_DURATION
                    segs.append((st, en, ph_names[int(p[i, k])]))
                out.append((mlg[i, :t_refs[i]], moff[i, :t_refs[i]], segs))
        return out

    def postprocess_ids(self, logits: np.ndarray,
                        confidence_threshold: float,
                        median_size: int) -> np.ndarray:
        """Device-side confidence gate + median filter → label ids [T], on
        the session's decode stream: the readback waits for these kernels,
        not for a forward in flight."""
        with torch.inference_mode(), torch.cuda.stream(self._decode_stream):
            ids = confidence_gate_ids(self._to_device(logits),
                                      confidence_threshold,
                                      self.label2id["O"])
            if median_size > 1:
                ids = median_filter_ids(ids, median_size)
            return ids.cpu().numpy()


# ---------------------------------------------------------------------------
# Cache (reference .wfl_cache layout)
# ---------------------------------------------------------------------------

@span("wfl.cache_save")
def _cache_save(path: str, arr: np.ndarray) -> None:
    """A torch-format entry: the reference's cache read is a bare
    ``torch.load`` (infer.py:127-131, 246-249)."""
    torch.save(torch.from_numpy(np.ascontiguousarray(arr)), path)


def _cache_load(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            arr = np.load(f, allow_pickle=False)
        if isinstance(arr, np.ndarray):
            return arr
    except ValueError:
        pass
    try:  # torch format (a zip archive: np.load sees an NpzFile above)
        val = torch.load(path, map_location="cpu", weights_only=False)
        return np.asarray(val.detach().cpu().numpy(), np.float32)
    except Exception:
        return None


def _squeeze_batch(arr: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if arr is not None and arr.ndim == 3 and arr.shape[0] == 1:
        return arr[0]
    return arr


# ---------------------------------------------------------------------------
# Prediction on one audio segment (cache + language averaging)
# ---------------------------------------------------------------------------

def _lang_name_for(session: InferenceSession, lang_id: Optional[int]):
    if lang_id is None:
        return None
    for name, idx in session.lang2id.items():
        if idx == lang_id:
            return name
    return None


def _check_lang_id(session: InferenceSession, lang_id: Optional[int]) -> None:
    """The reference's torch embedding raises on a bad id (infer.py:257-259)."""
    if lang_id is not None and (
            lang_id < 0 or (session.lang2id
                            and lang_id > max(session.lang2id.values()))):
        raise ValueError(f"Language ID {lang_id} is invalid. "
                         f"Available: {session.lang2id}")


def _predict_segment(session: InferenceSession, segment: np.ndarray,
                     lang_id: Optional[int],
                     logit_path: Optional[str], offset_path: Optional[str]):
    """Forward one segment (all languages batched and averaged when lang_id
    is None), honoring/filling the cache. Returns (logits [T,n], offsets
    [T,2])."""
    logits = offsets = None
    if logit_path is not None:
        logits = _squeeze_batch(_cache_load(logit_path))
        if logits is not None:
            print(f"Loaded cached logits for {os.path.basename(logit_path)}")
            offsets = _squeeze_batch(_cache_load(offset_path))
    if logits is None:
        _check_lang_id(session, lang_id)
        lang_ids = ([lang_id] if lang_id is not None
                    else sorted(session.lang2id.values()) or [0])
        batched_logits, batched_offsets = session.forward(segment, lang_ids)
        logits = batched_logits.mean(axis=0)
        offsets = batched_offsets.mean(axis=0)
        if logit_path is not None and session.writes:
            _cache_save(logit_path, logits)
            _cache_save(offset_path, offsets)
    return logits, offsets


@span("wfl.decode")
def _decode_segment(session: InferenceSession, logits: np.ndarray,
                    offsets: Optional[np.ndarray],
                    confidence_threshold: float, median_size: int,
                    lang_name: Optional[str]) -> List[Segment]:
    """Gate → median → BIO decode → canonical→lang mapping
    (reference infer.py:163-179)."""
    ids = session.postprocess_ids(logits, confidence_threshold, median_size)
    tags = [session.id2label[int(i)] for i in ids]
    segments = decode_bio_tags(tags, frame_duration=FRAME_DURATION,
                               offsets=offsets)
    if session.merge_map and lang_name:
        segments = [(s, e, canonical_to_lang(ph, lang_name, session.merge_map))
                    for s, e, ph in segments]
    return segments


def process_segments(session: InferenceSession, segments: List[np.ndarray],
                     sr: int, lang_id: Optional[int],
                     cache_dir: Optional[str], base_name: Optional[str],
                     confidence_threshold: float) -> List[Segment]:
    """Chunked-path processing (reference infer.py:98-184)."""
    all_segments: List[Segment] = []
    current_time = 0.0
    lang_name = _lang_name_for(session, lang_id)
    median_size = session.cfg.median_filter
    lang_suffix = f"_lang{lang_id}" if lang_id is not None else "_avg"
    for idx, segment in enumerate(segments):
        if len(segment) > 0:
            segment = segment / (np.max(np.abs(segment)) + 1e-8)  # Q11
        logit_path = offset_path = None
        if cache_dir is not None and base_name is not None:
            logit_path = os.path.join(
                cache_dir, f"{base_name}_seg{idx}{lang_suffix}_logits.pt")
            offset_path = os.path.join(
                cache_dir, f"{base_name}_seg{idx}{lang_suffix}_offsets.pt")
        logits, offsets = _predict_segment(session, segment, lang_id,
                                           logit_path, offset_path)
        decoded = _decode_segment(session, logits, offsets,
                                  confidence_threshold, median_size,
                                  lang_name)
        all_segments.extend([(s + current_time, e + current_time, ph)
                             for s, e, ph in decoded])
        current_time += len(segment) / sr
    return all_segments


# ---------------------------------------------------------------------------
# Public API (mirrors reference infer.py signatures)
# ---------------------------------------------------------------------------

_SESSION_CACHE: Dict[tuple, InferenceSession] = {}


def _config_key(config: ConfigLike):
    if isinstance(config, (Config, dict)):
        return ("object", id(config))
    return ("path", os.path.abspath(str(config)))


def _get_session(config: ConfigLike, checkpoint_path: str, device=None,
                 compute_dtype: torch.dtype = torch.float32,
                 data_parallel: bool = False) -> InferenceSession:
    """One cached session per (config, checkpoint, device, dtype, data
    parallel). Joins the launcher's process group first, if there is one
    (a plain run is untouched); ``data_parallel`` takes effect in a process
    group (a world of one too), and is on under pipeline parallelism (whose
    session is one per world)."""
    pmesh.maybe_initialize_distributed(
        device="cpu" if str(device) == "cpu" else "cuda")
    dev = resolve_device(device)
    data_parallel = (bool(data_parallel) or as_config(
        config).serving_pipeline_parallel > 1) \
        and torch.distributed.is_initialized()
    key = (_config_key(config), os.path.abspath(checkpoint_path), str(dev),
           compute_dtype, data_parallel)
    session = _SESSION_CACHE.get(key)
    if session is None:
        session = InferenceSession(config, checkpoint_path,
                                   compute_dtype=compute_dtype, device=dev,
                                   data_parallel=data_parallel)
        _SESSION_CACHE[key] = session
    return session


@span("wfl.job")
def infer_audio(audio_path: str, config_path: ConfigLike = "config.yaml",
                checkpoint_path: str = "best_model.pt",
                output_lab_path: Optional[str] = None,
                device=None, lang_id: Optional[int] = None,
                sample: bool = False, top_k: int = 0, top_p: float = 0.0,
                temperature: float = 1.0,
                confidence_threshold: float = 0.0,
                compute_dtype: torch.dtype = torch.float32) -> List[Segment]:
    """Single-file inference → segments (+ optional ``.lab``), mirroring
    reference infer.py:186-328. The sampling flags do not change the output
    (quirk Q2). ``device`` defaults to CUDA; pass "cpu" for the CPU."""
    del sample, top_k, top_p, temperature
    session = _get_session(config_path, checkpoint_path, device,
                           compute_dtype)
    lang_name = _lang_name_for(session, lang_id)
    forced = _load_forced_list(audio_path)

    with span("wfl.read_wav") as sp:
        audio, sr = read_wav(audio_path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        if sr != session.sr:
            audio = resample(audio, sr, session.sr)
            sr = session.sr
        audio = np.asarray(audio, np.float64)
        if len(audio) > 0:
            audio = peak_normalize(audio, eps=1e-8)
        sp.set(samples=len(audio))

    base_name = os.path.splitext(os.path.basename(audio_path))[0]
    cache_dir = os.path.join(os.path.dirname(audio_path), ".wfl_cache")
    os.makedirs(cache_dir, exist_ok=True)
    lang_suffix = f"_lang{lang_id}" if lang_id is not None else "_avg"

    median_size = session.cfg.median_filter
    if len(audio) / sr > MAX_SEGMENT_DURATION:
        print(f"Audio is too long ({len(audio)/sr:.1f}s), splitting...")
        segments_pred = process_segments(
            session, split_audio(audio, sr), sr, lang_id,
            cache_dir, base_name, confidence_threshold)
    else:
        logit_path = os.path.join(cache_dir,
                                  f"{base_name}{lang_suffix}_logits.pt")
        offset_path = os.path.join(cache_dir,
                                   f"{base_name}{lang_suffix}_offsets.pt")
        logits, offsets = _predict_segment(session, audio, lang_id,
                                           logit_path, offset_path)
        segments_pred = _decode_segment(session, logits, offsets,
                                        confidence_threshold, median_size,
                                        lang_name)

    if session.cfg.merge_segments != "none":
        segments_pred = merge_adjacent_segments(
            segments_pred, mode=session.cfg.merge_segments)
    if forced is not None:
        segments_pred = _apply_forced_alignment(segments_pred, forced)
    if output_lab_path and session.writes:
        dir_path = os.path.dirname(output_lab_path)
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)
        with span("wfl.lab_write"):
            save_lab(output_lab_path, segments_pred)
        print(f"Predictions saved to: {output_lab_path}")
    return segments_pred


def _load_forced_list(audio_path: str) -> Optional[List[str]]:
    """Forced phoneme list from the sibling .txt (reference infer.py:210-215)."""
    phoneme_txt = audio_path.replace(".wav", ".txt")
    if not os.path.exists(phoneme_txt):
        return None
    forced: List[str] = []
    with open(phoneme_txt, "r", encoding="utf-8") as f:
        for line in f:
            forced.extend(line.strip().split())
    print(f"Loaded forced phoneme list with {len(forced)} phonemes.")
    return forced


def _apply_forced_alignment(segments_pred: List[Segment],
                            forced: List[str]) -> List[Segment]:
    """Forced alignment + SP/AP edge re-attachment (reference infer.py:312-319)."""
    aligned = align_phoneme_list(segments_pred, forced)
    if "SP" not in forced and "AP" not in forced:
        before = [s for s in segments_pred
                  if s[2] in ("SP", "AP") and aligned and s[1] <= aligned[0][0]]
        after = [s for s in segments_pred
                 if s[2] in ("SP", "AP") and aligned and s[0] >= aligned[-1][1]]
        return before + aligned + after
    return aligned


@span("wfl.job")
def infer_folder_batched(folder_path: str,
                         config_path: ConfigLike = "config.yaml",
                         checkpoint_path: str = "best_model.pt",
                         output_dir: str = "outputs",
                         lang_id: Optional[int] = None,
                         confidence_threshold: float = 0.0,
                         batch_files: int = 8, device=None,
                         compute_dtype: torch.dtype = torch.float32,
                         data_parallel: Optional[bool] = None) -> None:
    """Throughput folder mode: ≤ 30 s files are batched into shared bucketed
    forwards via per-row masks, with outputs identical to per-file
    inference. Longer files take the chunked path; cached files skip the
    forward.

    ``data_parallel`` (default: on when the launcher's world has more than
    one rank): each rank serves a contiguous share of each batch's files,
    at the whole batch's bucket length, and the longer and the cached
    files in turn; each rank writes the ``.lab`` and ``.wfl_cache`` files of
    what it serves. Which files are cached is decided by every rank before
    any rank writes. Under ``model.pipeline_parallel`` the data ranks share
    the files so, every stage of a pipeline runs its data rank's forwards,
    and the pipeline's first stage writes."""
    pmesh.maybe_initialize_distributed(
        device="cpu" if str(device) == "cpu" else "cuda")
    if data_parallel is None:
        data_parallel = pmesh.world_size() > 1
    session = _get_session(config_path, checkpoint_path, device,
                           compute_dtype, data_parallel=data_parallel)
    mesh = session.mesh if data_parallel else None
    ranks, me = (mesh.data_size, mesh.data_rank) if mesh else (1, 0)
    os.makedirs(output_dir, exist_ok=True)
    median_size = session.cfg.median_filter
    lang_suffix = f"_lang{lang_id}" if lang_id is not None else "_avg"
    lang_name = _lang_name_for(session, lang_id)
    _check_lang_id(session, lang_id)
    langs = ([lang_id] if lang_id is not None
             else sorted(session.lang2id.values()) or [0])

    @span("wfl.lab_write")
    def finish(name, segments):
        if session.cfg.merge_segments != "none":
            segments = merge_adjacent_segments(
                segments, mode=session.cfg.merge_segments)
        forced = _load_forced_list(os.path.join(folder_path, name))
        if forced is not None:
            segments = _apply_forced_alignment(segments, forced)
        save_lab(os.path.join(output_dir, name.replace(".wav", ".lab")),
                 segments)

    def load(path):
        with span("wfl.read_wav") as sp:
            audio, sr = read_wav(path)
            if audio.ndim > 1:
                audio = audio.mean(axis=1)
            if sr != session.sr:
                audio = resample(audio, sr, session.sr)
            if len(audio) > 0:
                audio = peak_normalize(audio, eps=1e-8)
            sp.set(samples=len(audio))
            return np.asarray(audio, np.float32)

    def forward(audios, bucket, rows, shadow):
        """A group's forward, ``shadow`` run while it is in flight."""
        if session.cfg.device_decode:
            return session.forward_many_decoded(
                audios, langs, confidence_threshold, median_size,
                bucket=bucket, rows=rows, shadow=shadow)
        return session.forward_many(audios, [langs] * len(audios),
                                    bucket=bucket, rows=rows, shadow=shadow)

    def write(group, results):
        """A group's cache entries and ``.lab`` files, from its forward's
        results (the host decode's language average and decode first)."""
        if not session.writes:
            return
        for (name, _path, _n, logit_path, offset_path), result in \
                zip(group, results):
            if session.cfg.device_decode:
                logits, offsets, segs = result
            else:
                with span("wfl.decode"):     # the languages' average first
                    logits = result[0].mean(axis=0)
                    offsets = result[1].mean(axis=0)
            _cache_save(logit_path, logits)
            _cache_save(offset_path, offsets)
            if not session.cfg.device_decode:
                segs = _decode_segment(session, logits, offsets,
                                       confidence_threshold, median_size,
                                       lang_name)
            elif session.merge_map and lang_name:
                with span("wfl.decode"):
                    segs = [(s, e, canonical_to_lang(ph, lang_name,
                                                     session.merge_map))
                            for s, e, ph in segs]
            finish(name, segs)

    def read(group, bucket):
        """A group's wavs and their rows, assembled for its forward."""
        audios = [load(g[1]) for g in group]
        return audios, session.assemble(audios, [langs] * len(group), bucket)

    # every rank classifies every file before any rank writes a cache entry
    cache_dir = os.path.join(folder_path, ".wfl_cache")
    os.makedirs(cache_dir, exist_ok=True)
    work = []
    with span("wfl.list") as sp:
        for name in sorted(f for f in os.listdir(folder_path)
                           if f.lower().endswith(".wav")):
            path = os.path.join(folder_path, name)
            # duration gate first (header only): a >30 s file takes the chunked
            # path even if a stale short-file cache entry has its name
            n_samples, sr_hdr = wav_duration(path)
            if n_samples / sr_hdr > MAX_SEGMENT_DURATION:
                work.append(("long", name, path))
                continue
            base = os.path.splitext(name)[0]
            logit_path = os.path.join(cache_dir,
                                      f"{base}{lang_suffix}_logits.pt")
            offset_path = os.path.join(cache_dir,
                                       f"{base}{lang_suffix}_offsets.pt")
            cached = _squeeze_batch(_cache_load(logit_path))
            if cached is not None:
                work.append(("cached", name, cached, offset_path))
                continue
            work.append(("new", name, path,
                         resampled_length(n_samples, sr_hdr, session.sr),
                         logit_path, offset_path))
        sp.set(files=len(work))
    if mesh is not None:
        torch.distributed.barrier()

    # this rank's steps in order: its share of each group of new files (at
    # the whole group's bucket), and the long and cached files whose turn
    # is its own
    steps = []
    pending = []  # (name, path, samples, logit_path, offset_path)
    turn = 0      # the rank whose turn a long or cached file is

    def close_group():
        bucket = session._bucket(max(g[2] for g in pending))
        share = pending[me * len(pending) // ranks:
                        (me + 1) * len(pending) // ranks]
        if share:
            steps.append(("group", (share, bucket)))

    for kind, name, *rest in work:
        if kind == "new":
            pending.append((name, *rest))
            if len(pending) >= batch_files:
                close_group()
                pending = []
            continue
        mine, turn = turn == me, (turn + 1) % ranks
        if mine:
            steps.append((kind, (name, *rest)))
    if pending:
        close_group()

    # Launch ahead: while group k's forward runs on the card, the host writes
    # group k-1's files and reads and assembles group k+1's rows. A long or
    # cached file first writes the group read back before it.
    done = None    # (group, results): the group last read back, unwritten
    ahead = None   # (audios, rows): the next group's, read in a shadow
    for i, (kind, item) in enumerate(steps):
        if kind != "group":
            if done is not None:
                write(*done)
                done = None
            if kind == "long":
                name, path = item
                infer_audio(path, config_path, checkpoint_path,
                            os.path.join(output_dir,
                                         name.replace(".wav", ".lab")),
                            device=device, lang_id=lang_id,
                            confidence_threshold=confidence_threshold,
                            compute_dtype=compute_dtype)
            elif session.writes:
                name, cached, offset_path = item
                finish(name, _decode_segment(
                    session, cached, _squeeze_batch(_cache_load(offset_path)),
                    confidence_threshold, median_size, lang_name))
            continue
        group, bucket = item
        if ahead is None:
            audios, rows = [load(g[1]) for g in group], None
        else:
            (audios, rows), ahead = ahead, None
        prev, done = done, None
        nxt = steps[i + 1][1] if i + 1 < len(steps) \
            and steps[i + 1][0] == "group" else None
        failed = None  # the next group's reads' error, raised once this
                       # group is written, as the serial order would

        def shadow():
            nonlocal ahead, failed
            if prev is not None:
                write(*prev)
            if nxt is not None:
                try:
                    ahead = read(*nxt)
                except Exception as err:
                    failed = err
        done = (group, forward(audios, bucket, rows,
                               None if prev is None and nxt is None
                               else shadow))
        if failed is not None:
            write(*done)
            raise failed
    if done is not None:
        write(*done)


def infer_folder(folder_path: str, config_path: ConfigLike = "config.yaml",
                 checkpoint_path: str = "best_model.pt",
                 output_dir: str = "outputs", device=None,
                 lang_id: Optional[int] = None, sample: bool = False,
                 top_k: int = 0, top_p: float = 0.0, temperature: float = 1.0,
                 confidence_threshold: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32) -> None:
    """Folder inference, one file at a time (reference infer.py:330-357)."""
    wav_files = [f for f in os.listdir(folder_path)
                 if f.lower().endswith(".wav")]
    os.makedirs(output_dir, exist_ok=True)
    for wav_file in wav_files:
        print(f"\nInferencing: {wav_file}")
        segments = infer_audio(
            audio_path=os.path.join(folder_path, wav_file),
            config_path=config_path, checkpoint_path=checkpoint_path,
            output_lab_path=os.path.join(output_dir,
                                         wav_file.replace(".wav", ".lab")),
            device=device, lang_id=lang_id, sample=sample, top_k=top_k,
            top_p=top_p, temperature=temperature,
            confidence_threshold=confidence_threshold,
            compute_dtype=compute_dtype)
        print("Predicted segments:")
        for start, end, ph in segments:
            print(f"({round(start, 2)}, {round(end, 2)}, {ph})")
