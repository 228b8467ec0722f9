"""Host data pipeline (numpy), the port of ``wfl_asr_tpu/data/dataset.py``:
dataset, augmentation, seeded split, bucketed batching. From the same
``dataset.json`` and seed it yields the same batches as the JAX loader.

Per item: read the wav, resample to 16 kHz, peak-normalize (silence passes
through), probability-gated volume scale + Gaussian noise with clipping,
optional truncation to ``max_seq_len``; unknown BIO tags map to "O".
Collation pads waveforms with 0.0 and labels with −100, to buckets (audio
to 1 s multiples, labels to 50-frame multiples, offset targets to
64-multiples) so the number of distinct batch shapes stays bounded; extra
label frames carry −100 and are ignored by the loss. The split and the
augmentation are seeded. A background thread prefetches batches.

Under data parallelism every rank of a node walks the same seeded batch
order and collates only its rows of each batch (``BatchLoader(rows=…)``),
at the batch's padded lengths, which the loader takes from the metadata
and the WAV headers of the whole batch: a rank's rows are then the rows
of the one-process batch, padded alike (the Conformer's BatchNorm takes
its statistics over padded frames too). Across nodes each node takes its
share of the files (``shard_indices_for_process``) and the collated
shapes are pinned to the dataset's maxima (``global_max_lengths``), as
in the JAX package's multi-host input.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..train.losses import offset_targets_from_segments
from ..utils.profiling import span
from .audio import peak_normalize, read_wav, resample, resampled_length, \
    wav_duration

AUDIO_BUCKET = 16000        # 1 s at 16 kHz
LABEL_BUCKET = 50           # 1 s at 20 ms frames
TARGET_BUCKET = 64          # offset-target padding granularity


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


class PhonemeDataset:
    """Loads ``dataset.json``; items processed on demand with a caller-held
    RNG (so augmentation is reproducible per (seed, epoch, index))."""

    def __init__(self, dataset_path: str, label_list: Sequence[str],
                 max_seq_len: Optional[int] = None,
                 aug_cfg: Optional[dict] = None,
                 sample_rate: int = 16000):
        with open(dataset_path, "r") as f:
            self.samples = json.load(f)
        self.label_list = list(label_list)
        self.label2id = {l: i for i, l in enumerate(label_list)}
        self.max_seq_len = max_seq_len
        self.sample_rate = sample_rate
        self.aug_cfg = {"enable": False, "prob": 1.0, "noise_std": 0.0,
                        "volume_range": [1.0, 1.0]}  # train.py:46-53 defaults
        if aug_cfg:
            self.aug_cfg.update(aug_cfg)

    def __len__(self) -> int:
        return len(self.samples)

    def item_lengths(self, idx: int) -> Tuple[int, int, int]:
        """(audio samples at the target rate, label frames, offset targets
        before bucketing) of an item, from its metadata and WAV header
        alone: what :func:`collate` pads to."""
        sample = self.samples[idx]
        n = resampled_length(*wav_duration(sample["wav_path"]),
                             self.sample_rate)
        if self.max_seq_len:
            n = min(n, self.max_seq_len)
        targets = sum(1 for seg in sample["phoneme_segments"]
                      if isinstance(seg, (list, tuple)) and len(seg) == 3) * 2
        return n, len(sample["bio_tags"]), targets

    def global_max_lengths(self) -> Tuple[int, int, int]:
        """The largest :meth:`item_lengths` over the dataset (multi-node
        input pins the collated shapes to them)."""
        lens = [self.item_lengths(i) for i in range(len(self.samples))]
        return tuple(max((x[j] for x in lens), default=0) for j in range(3))

    def get_item(self, idx: int, rng: Optional[np.random.RandomState] = None
                 ) -> Dict:
        sample = self.samples[idx]
        wav, sr = read_wav(sample["wav_path"])
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)

        wav = peak_normalize(wav)  # silence passthrough (train.py:65-69)

        aug = self.aug_cfg
        if aug.get("enable", False) and rng is not None \
                and rng.random_sample() < aug.get("prob", 1.0):
            lo, hi = aug.get("volume_range", [1.0, 1.0])
            wav = wav * rng.uniform(lo, hi)
            noise_std = aug.get("noise_std", 0.0)
            if noise_std > 0:
                wav = wav + rng.normal(0.0, noise_std, wav.shape)
            wav = np.clip(wav, -1.0, 1.0)

        audio = wav.astype(np.float32)
        if self.max_seq_len:
            audio = audio[: self.max_seq_len]

        o_id = self.label2id["O"]
        label_ids = np.array([self.label2id.get(t, o_id)
                              for t in sample["bio_tags"]], np.int32)
        return {"audio": audio, "label_ids": label_ids, "wav": wav,
                "segments": sample["phoneme_segments"],
                "wav_path": sample["wav_path"],
                "lang_id": int(sample["lang_id"])}


def split_dataset(n: int, num_val: int, seed: int):
    """Seeded random split (the reference's ``random_split`` is unseeded,
    quirk Q9). Returns (train_indices, val_indices)."""
    perm = np.random.RandomState(seed).permutation(n)
    return perm[num_val:].tolist(), perm[:num_val].tolist()


def shard_indices_for_process(indices, process_index: int,
                              process_count: int):
    """Disjoint equal-size contiguous shards of a (seeded-shuffled) index
    list, one a node: ``floor(n / process_count)`` items each, so every
    node runs as many batches an epoch (unequal shards would leave some
    ranks waiting in a collective)."""
    per = len(indices) // process_count
    return list(indices[process_index * per:(process_index + 1) * per])


def collate(items: List[Dict], frame_duration: float = 0.02,
            fixed_audio_len: int = 0, fixed_label_len: int = 0,
            fixed_targets_len: int = 0) -> Dict:
    """Bucket-padded batch: audio 0.0-padded, labels −100-padded
    (reference collate_fn train.py:22-36), plus vectorized offset targets.
    ``fixed_*``: pad to at least these lengths (a rank's rows of a larger
    batch, or the dataset's maxima across nodes)."""
    batch = len(items)
    label_lengths = np.array([len(it["label_ids"]) for it in items], np.int32)
    max_label_len = int(label_lengths.max()) if batch else 0
    padded_label_len = _round_up(max(max_label_len, fixed_label_len),
                                 LABEL_BUCKET)
    max_audio = max(len(it["audio"]) for it in items)
    padded_audio_len = _round_up(max(max_audio, fixed_audio_len),
                                 AUDIO_BUCKET)

    audio = np.zeros((batch, padded_audio_len), np.float32)
    labels = np.full((batch, padded_label_len), -100, np.int64)
    lang_ids = np.zeros(batch, np.int32)

    max_targets = max((sum(1 for s in it["segments"]
                           if isinstance(s, (list, tuple)) and len(s) == 3) * 2
                       for it in items), default=1)
    max_targets = _round_up(max(max_targets, fixed_targets_len, 1),
                            TARGET_BUCKET)
    off_f = np.zeros((batch, max_targets), np.int32)
    off_c = np.zeros((batch, max_targets), np.int32)
    off_x = np.zeros((batch, max_targets), np.float32)
    off_v = np.zeros((batch, max_targets), bool)

    for i, it in enumerate(items):
        audio[i, :len(it["audio"])] = it["audio"]
        labels[i, :len(it["label_ids"])] = it["label_ids"]
        lang_ids[i] = it["lang_id"]
        f, c, x, v = offset_targets_from_segments(
            it["segments"], frame_duration, int(label_lengths[i]), max_targets)
        off_f[i], off_c[i], off_x[i], off_v[i] = f, c, x, v

    return {
        "audio": audio, "labels": labels, "lang_ids": lang_ids,
        "label_lengths": label_lengths,
        "max_label_len": padded_label_len,
        "off_frames": off_f, "off_channels": off_c, "off_fracs": off_x,
        "off_valid": off_v,
        "wavs": [it["wav"] for it in items],
        "segments_gt": [it["segments"] for it in items],
        "wav_paths": [it["wav_path"] for it in items],
    }


class BatchLoader:
    """Seeded shuffling + background-thread prefetch over a PhonemeDataset."""

    def __init__(self, dataset: PhonemeDataset, indices: Sequence[int],
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 frame_duration: float = 0.02, prefetch: int = 2,
                 drop_last: bool = False,
                 rows: Optional[Tuple[int, int]] = None,
                 fixed_lengths: Tuple[int, int, int] = (0, 0, 0)):
        """``rows`` (lo, hi): collate only rows lo:hi of each batch (a data
        rank's share; the rows of a short last batch are split evenly), at
        the padded lengths of the whole batch; a share left empty by a
        short batch collates the batch's first row as a stand-in, marked
        ``batch["stand_in"]`` (every rank runs as many forwards).
        ``fixed_lengths``: (audio, labels, targets) to pad every batch to
        at least."""
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.frame_duration = frame_duration
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rows = rows
        self.fixed_lengths = tuple(fixed_lengths)
        self.epoch = 0

    def _collate(self, chunk, epoch: int) -> Dict:
        fixed = self.fixed_lengths
        if self.rows is not None:
            lens = [self.dataset.item_lengths(i) for i in chunk]
            fixed = tuple(max([f] + [x[j] for x in lens])
                          for j, f in enumerate(fixed))
            lo, hi = self.rows
            if len(chunk) < self.batch_size:
                lo = lo * len(chunk) // self.batch_size
                hi = hi * len(chunk) // self.batch_size
            stand_in = lo == hi
            chunk = chunk[:1] if stand_in else chunk[lo:hi]
        items = []
        for idx in chunk:
            rng = np.random.RandomState(
                hash((self.seed, epoch, idx)) % (2 ** 31))
            items.append(self.dataset.get_item(idx, rng))
        batch = collate(items, self.frame_duration, *fixed)
        if self.rows is not None:
            batch["stand_in"] = stand_in
        return batch

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_batches(self, epoch: Optional[int] = None) -> Iterator[Dict]:
        epoch = self.epoch if epoch is None else epoch
        order = list(self.indices)
        if self.shuffle:
            np.random.RandomState(hash((self.seed, epoch)) % (2 ** 31)) \
                .shuffle(order)

        stop = threading.Event()

        def put(out_q: queue.Queue, item) -> bool:
            # Bounded put that honors cancellation: the consumer may abandon
            # the generator mid-epoch (max_steps, Q10 loader restarts), and
            # a plain blocking put would leave this thread pinned forever on
            # the full queue holding collated batches.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(out_q: queue.Queue):
            try:
                for start in range(0, len(order), self.batch_size):
                    if stop.is_set():
                        return
                    chunk = order[start:start + self.batch_size]
                    if self.drop_last and len(chunk) < self.batch_size:
                        break
                    with span("wfl.collate"):
                        batch = self._collate(chunk, epoch)
                    if not put(out_q, batch):
                        return
            except Exception as exc:  # surface loader errors to the consumer
                put(out_q, exc)
            put(out_q, None)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        thread = threading.Thread(target=produce, args=(q,), daemon=True)
        thread.start()
        try:
            while True:
                with span("wfl.loader_wait"):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            self.epoch = epoch + 1
        finally:
            # GeneratorExit (abandoned epoch) or error: release the producer.
            stop.set()
