"""Seeded inputs: synthetic voiced audio as 16-bit mono wavs, and HTK
``.lab`` files of phone segments.

Durations follow a log-normal law (median and σ from the traffic file,
clipped), taken at fixed quantiles (i + ½)/N and spread over the files by
a fixed permutation (``arrangement_seed``): every seed gets the same set
of lengths in the same places, so that the work of a run does not depend
on its seed. The seed draws the audio (a tone of a random pitch with
vibrato, three harmonics, a syllable-rate envelope and noise) and the
phones.
"""

from __future__ import annotations

import os
import wave
from statistics import NormalDist
from typing import List

import numpy as np
import torch

SR = 16000
PHONES = ("SP", "a", "i", "u", "e", "o", "k", "s", "t", "n", "h", "m", "y",
          "r", "w", "g", "z", "d", "b", "p", "ch", "ts", "sh", "j", "f",
          "v", "l", "th", "dh", "ng", "ae", "ah", "aw", "ay", "er", "oy")


def durations(n: int, median: float, sigma: float, lo: float, hi: float,
              arrangement_seed: int) -> List[float]:
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    d = np.clip(median * np.exp(sigma * np.array(z)), lo, hi)
    return d[np.random.RandomState(arrangement_seed).permutation(n)].tolist()


def durations_of(tr: dict, n: int) -> List[float]:
    """``durations`` with a traffic file's ``duration_s`` law."""
    d = tr["duration_s"]
    return durations(n, d["median"], d["sigma"], d["min"], d["max"],
                     d["arrangement_seed"])


def labels_list() -> List[str]:
    return sorted({f"{p}-{ph}" for ph in PHONES for p in "BI"} | {"O"})


def synth(lengths: List[int], seed: int, device) -> List[np.ndarray]:
    """int16 audio of each length, drawn in a few large calls."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = len(lengths)
    total = int(sum(lengths))
    f0 = torch.rand(n, generator=gen, device=device) * 200 + 100
    phase0 = torch.rand(n, generator=gen, device=device) * 6.283
    owner = torch.repeat_interleave(
        torch.arange(n, device=device),
        torch.tensor(lengths, device=device))
    starts = torch.tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]),
                          device=device)
    t = (torch.arange(total, device=device, dtype=torch.float64)
         - starts[owner].double()) / SR
    f = f0[owner].double()
    # instantaneous phase of f0·(1 + 0.03·sin(2π·5t))
    ph = 2 * np.pi * f * (t - 0.03 / (2 * np.pi * 5) * torch.cos(
        2 * np.pi * 5 * t)) + phase0[owner].double()
    x = (torch.sin(ph) + 0.5 * torch.sin(2 * ph) + 0.25 * torch.sin(3 * ph))
    env = 0.6 + 0.4 * torch.sin(2 * np.pi * 3 * t + phase0[owner].double())
    noise = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float64) * 0.03
    y = ((x * env / 1.75 + noise) * 0.5 * 32767).clamp(-32767, 32767)
    y = y.to(torch.int16).cpu().numpy()
    return np.split(y, np.cumsum(lengths)[:-1])


def write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(samples.astype("<i2").tobytes())


class PhoneDraws:
    """Phones in seeded permutations of all of them, one after another, so
    that a corpus of 36 segments or more holds every phone."""

    def __init__(self, rng: np.random.RandomState):
        self.rng, self.queue = rng, []

    def next(self) -> str:
        if not self.queue:
            self.queue = list(self.rng.permutation(len(PHONES)))
        return PHONES[self.queue.pop()]


def write_lab(path: str, dur: float, rng: np.random.RandomState,
              phones: PhoneDraws) -> None:
    """Phone segments of 50-200 ms over the whole file."""
    lines, start = [], 0.0
    while start < dur - 0.06:
        end = min(start + 0.05 + 0.15 * rng.rand(), dur)
        lines.append(f"{int(start * 1e7)} {int(end * 1e7)} "
                     f"{phones.next()}\n")
        start = end
    with open(path, "w") as f:
        f.writelines(lines)


def folder_pool(root: str, folders: int, files: int, durs: List[float],
                seed: int, device) -> List[str]:
    """``folders`` folders of ``files`` wavs each (``durs`` in order)."""
    lengths = [int(d * SR) for d in durs]
    audio = synth(lengths, seed, device)
    out = []
    for k in range(folders):
        path = os.path.join(root, f"folder{k:02d}")
        os.makedirs(path, exist_ok=True)
        for i in range(files):
            write_wav(os.path.join(path, f"{i:03d}.wav"), audio[k * files + i])
        out.append(path)
    return out


def corpus(data_dir: str, langs: List[str], per_lang: int,
           durs: List[float], seed: int, device) -> None:
    lengths = [int(d * SR) for d in durs]
    audio = synth(lengths, seed, device)
    rng = np.random.RandomState(np.random.SeedSequence(seed)
                                .generate_state(1)[0])
    phones = PhoneDraws(rng)
    for li, lang in enumerate(langs):
        os.makedirs(os.path.join(data_dir, lang), exist_ok=True)
        for i in range(per_lang):
            j = li * per_lang + i
            base = os.path.join(data_dir, lang, f"u{i:03d}")
            write_wav(base + ".wav", audio[j])
            write_lab(base + ".lab", lengths[j] / SR, rng, phones)
