"""A training corpus worked out from its files, as WFL-ASR's training
defines it: ``data_dir/<lang>/<name>.wav`` with an HTK ``<name>.lab``
beside it.

- languages: the sorted language folders, numbered from 0; items: each
  language's sorted wavs that have a ``.lab``, in that order;
- labels: per 20 ms frame (``int(duration / Δ)`` frames) "O", with
  ``B-x`` at ``int(start/Δ)`` and ``I-x`` up to ``int(end/Δ)`` inclusive,
  later segments over earlier ones; the label list is the sorted set of
  every ``B-``/``I-`` tag and "O";
- the split: ``RandomState(seed).permutation(n)``, the first
  ``num_val`` held out; an epoch's order: the training indices shuffled by
  ``RandomState(hash((seed, epoch)) % 2**31)``, cut into batches;
- an item: the wav's samples (16-bit PCM / 32768) divided by their peak;
  with augmentation, ``RandomState(hash((seed, epoch, index)) % 2**31)``
  draws u < prob, then a gain in the volume range and Gaussian noise,
  clipped to ±1;
- a batch: audio zero-padded to a whole second above its longest item,
  labels padded with -100 to a multiple of 50 frames (the model's output
  is cut or padded to that length).
"""

from __future__ import annotations

import glob
import os
import wave
from typing import Dict, List

import numpy as np


def read_wav16(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2 and w.getnchannels() == 1
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0


def read_lab(path: str):
    segs = []
    with open(path) as f:
        for line in f:
            a, b, ph = line.split()
            segs.append((int(a) / 1e7, int(b) / 1e7, ph))
    return segs


def bio(segs, num_frames: int, dt: float) -> List[str]:
    tags = ["O"] * num_frames
    for start, end, ph in segs:
        b, e = int(start / dt), min(int(end / dt), num_frames - 1)
        if b >= num_frames:
            continue
        tags[b] = f"B-{ph}"
        for i in range(b + 1, e + 1):
            tags[i] = f"I-{ph}"
    return tags


class Corpus:
    def __init__(self, data_dir: str, dt: float = 0.02):
        self.dt = dt
        langs = sorted(d for d in os.listdir(data_dir)
                       if os.path.isdir(os.path.join(data_dir, d)))
        self.items: List[Dict] = []
        phones = set()
        for li, lang in enumerate(langs):
            for wav in sorted(glob.glob(os.path.join(data_dir, lang,
                                                     "*.wav"))):
                lab = wav[:-4] + ".lab"
                if not os.path.exists(lab):
                    continue
                with wave.open(wav, "rb") as w:
                    n = w.getnframes() / w.getframerate()
                segs = read_lab(lab)
                phones |= {s[2] for s in segs}
                self.items.append(dict(wav=wav, segs=segs, lang=li,
                                       tags=bio(segs, int(n / dt), dt)))
        self.labels = sorted({f"{p}-{ph}" for ph in phones for p in "BI"}
                             | {"O"})
        self.num_languages = len(langs)

    def split(self, seed: int, num_val: int):
        perm = np.random.RandomState(seed).permutation(len(self.items))
        return perm[num_val:].tolist(), perm[:num_val].tolist()

    def batches(self, train_idx, seed: int, epoch: int, batch: int):
        order = list(train_idx)
        np.random.RandomState(hash((seed, epoch)) % (2 ** 31)).shuffle(order)
        return [order[i:i + batch] for i in range(0, len(order), batch)]

    def audio(self, idx: int, seed: int, epoch: int, aug: dict) -> np.ndarray:
        wav = read_wav16(self.items[idx]["wav"])
        peak = np.max(np.abs(wav)) if wav.size else 0.0
        if peak > 0:
            wav = wav / peak
        rng = np.random.RandomState(hash((seed, epoch, idx)) % (2 ** 31))
        if aug.get("enable") and rng.random_sample() < aug.get("prob", 1.0):
            lo, hi = aug.get("volume_range", [1.0, 1.0])
            wav = wav * rng.uniform(lo, hi)
            if aug.get("noise_std", 0.0) > 0:
                wav = wav + rng.normal(0.0, aug["noise_std"], wav.shape)
            wav = np.clip(wav, -1.0, 1.0)
        return wav.astype(np.float32)

    def collate(self, idxs, seed: int, epoch: int, aug: dict):
        """(audio [B, S], labels [B, L], lang ids [B], offset targets per
        item, max label length)."""
        from .losses import offset_targets
        auds = [self.audio(i, seed, epoch, aug) for i in idxs]
        tags = [self.items[i]["tags"] for i in idxs]
        s = max(-(-max(len(a) for a in auds) // 16000), 1) * 16000
        lab = max(-(-max(len(t) for t in tags) // 50), 1) * 50
        audio = np.zeros((len(idxs), s), np.float32)
        labels = np.full((len(idxs), lab), -100, np.int64)
        l2i = {l: i for i, l in enumerate(self.labels)}
        for r, (a, t) in enumerate(zip(auds, tags)):
            audio[r, :len(a)] = a
            labels[r, :len(t)] = [l2i[x] for x in t]
        targets = [offset_targets(self.items[i]["segs"], self.dt, len(t))
                   for i, t in zip(idxs, tags)]
        langs = np.array([self.items[i]["lang"] for i in idxs], np.int64)
        return audio, labels, langs, targets, lab
