"""Label-boundary corrector, the port of ``wfl_asr_tpu/correct_label.py``:
snap HTK ``.lab`` boundaries to signal-derived boundary candidates.

- boundary detection from spectral flux (STFT n_fft=512, hop=160) fused with
  MFCC-delta magnitude, each max-normalized, mean-combined;
  ``find_peaks(height=0.1, distance=5)``, peaks shifted one frame left;
- greedy snap of each segment start/end to the nearest *unused* candidate
  within 30 ms;
- the ``_boundary.txt`` candidate cache created, used, and deleted after the
  run, the in-place ``.lab`` rewrite, the optional 3-panel PNG, and the
  ``ProcessPoolExecutor`` folder fan-out (spawned workers, at most one a
  file; each printed line one write, so that workers' lines never
  interleave).

Host code on NumPy/SciPy, as in the JAX package (hann STFT, slaney-mel →
dB → DCT-II MFCCs, Savitzky-Golay delta — librosa's conventions); the
output files and printed lines are the JAX module's. ``matplotlib`` (for
``--save_plot``) and ``tqdm`` (the folder mode's progress bar) are imported
where they are used: without tqdm the folder mode prints a plain count to
stderr, and ``--save_plot`` without matplotlib raises ``ImportError``. In
the folder mode a file that fails raises its error (the JAX module's pool
drops it).

    python -m wfl_asr_tpu_torch.correct_label PATH [--save_plot]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import List, Optional

import numpy as np

from .data.audio import read_wav, resample
from .ops.frontend import mel_filterbank

snap_threshold_sec = 0.03  # reference correct_label.py:13


# ---------------------------------------------------------------------------
# DSP front-end (librosa-convention STFT / MFCC on NumPy)
# ---------------------------------------------------------------------------

def _stft_mag(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| with hann window, centered frames, zero padding — librosa's
    conventions. Returns [n_fft//2+1, n_frames]."""
    pad = n_fft // 2
    y_p = np.pad(y, pad, mode="constant")
    n_frames = 1 + len(y) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y_p[idx]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    spec = np.fft.rfft(frames * window[None, :], axis=1)
    return np.abs(spec).T


def _mfcc(y: np.ndarray, sr: int, n_mfcc: int, hop: int,
          n_fft: int = 2048, n_mels: int = 128) -> np.ndarray:
    from scipy.fft import dct
    power = _stft_mag(y, n_fft, hop) ** 2
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sr, scale="slaney",
                        norm="slaney").astype(np.float64)
    mel = fb.T @ power
    log_spec = 10.0 * np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 80.0)
    return dct(log_spec, axis=0, type=2, norm="ortho")[:n_mfcc]


def detect_boundaries(y: np.ndarray, sr: int, frame_length: int = 512,
                      hop_length: int = 160, flux_threshold: float = 0.1,
                      delta_window: int = 5):
    """Spectral-flux + MFCC-delta boundary candidates
    (reference correct_label.py:15-38). Returns
    (times list, flux, delta_mag, flux_times)."""
    from scipy.signal import find_peaks, savgol_filter

    S = _stft_mag(y, frame_length, hop_length)
    flux = np.sqrt(np.sum(np.diff(S, axis=1) ** 2, axis=0))
    flux = np.pad(flux, (1,), mode="constant")
    flux = flux / np.max(flux) if flux.size and np.max(flux) > 0 else flux

    mfcc = _mfcc(y, sr, n_mfcc=13, hop=hop_length)
    delta = savgol_filter(mfcc, 9, polyorder=1, deriv=1, axis=-1,
                          mode="interp")
    delta_mag = np.mean(np.abs(delta), axis=0)
    if delta_mag.size and np.max(delta_mag) > 0:
        delta_mag = delta_mag / np.max(delta_mag)

    min_len = min(len(flux), len(delta_mag))
    flux = flux[:min_len]
    delta_mag = delta_mag[:min_len]

    combined = 0.5 * flux + 0.5 * delta_mag
    peaks, _ = find_peaks(combined, height=flux_threshold,
                          distance=delta_window)
    shifted = np.clip(peaks - 1, 0, max(len(combined) - 1, 0))
    times = shifted * hop_length / sr
    flux_times = np.arange(len(flux)) * hop_length / sr
    return times.tolist(), flux, delta_mag, flux_times


# ---------------------------------------------------------------------------
# Snap logic + file protocol
# ---------------------------------------------------------------------------

def correct_lab_boundaries(wav_path: str, predicted_boundaries: List[float],
                           snap_threshold: float = snap_threshold_sec):
    """Greedy nearest-unused-candidate snap within the threshold
    (reference correct_label.py:40-87). Returns (snapped, original)."""
    lab_path = wav_path.replace(".wav", ".lab")
    snapped, original = [], []
    if not os.path.exists(lab_path):
        return snapped, original

    used = set()
    with open(lab_path, "r", encoding="utf-8") as f:
        for line in f:
            fields = line.strip().split()
            if len(fields) != 3:
                continue
            start_sec = float(fields[0]) / 1e7
            end_sec = float(fields[1]) / 1e7
            label = fields[2]
            original.append((start_sec, end_sec, label))

            for which in ("start", "end"):
                target = start_sec if which == "start" else end_sec
                closest, best = None, snap_threshold + 1
                for t in predicted_boundaries:
                    if t in used:
                        continue
                    dist = abs(t - target)
                    if dist < best:
                        best, closest = dist, t
                if closest is not None and best <= snap_threshold:
                    if which == "start":
                        start_sec = closest
                    else:
                        end_sec = closest
                    used.add(closest)

            snapped.append((start_sec, end_sec, label))
    return snapped, original


def write_predicted_boundaries(wav_path: str, boundaries: List[float],
                               out_path: Optional[str] = None) -> None:
    path = out_path or wav_path.replace(".wav", "_boundary.txt")
    with open(path, "w", encoding="utf-8") as f:
        for t in boundaries:
            f.write(f"{t:.6f}\n")


def load_predicted_boundaries(wav_path: str) -> Optional[List[float]]:
    path = wav_path.replace(".wav", "_boundary.txt")
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            return [float(line.strip()) for line in f if line.strip()]
    return None


def write_lab(wav_path: str, boundaries,
              out_path: Optional[str] = None) -> None:
    path = out_path or wav_path.replace(".wav", ".lab")
    with open(path, "w", encoding="utf-8") as f:
        for start, end, label in boundaries:
            f.write(f"{int(start * 1e7)} {int(end * 1e7)} {label}\n")


def visualize_audio_features(wav_path, y, sr, predicted_boundaries, flux,
                             delta_mag, flux_times, snapped_boundaries=None,
                             original_boundaries=None,
                             save_path: str = "features_plot.png") -> None:
    """Diagnostic PNG for a snap run — the reference's 3-panel layout
    (correct_label.py:107-138): waveform with the ORIGINAL label
    boundaries on top, the spectral-flux / MFCC-delta detector curves with
    the candidate peaks in the middle, and the waveform again with the
    SNAPPED (corrected) boundaries at the bottom. Needs matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--save_plot needs the 'matplotlib' package, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(y)) / sr
    amp = float(np.max(np.abs(y))) or 1.0
    fig, (ax_orig, ax_det, ax_snap) = plt.subplots(
        3, 1, figsize=(14, 9), sharex=True)
    fig.suptitle(os.path.basename(wav_path))

    def waveform_panel(ax, title, segs, color):
        ax.set_title(title)
        ax.plot(t, y, color="lightblue", linewidth=0.6, zorder=1)
        for start, end, label in segs or []:
            ax.axvline(end, color=color, linewidth=1)
            ax.annotate(label, ((start + end) / 2, amp * 0.8),
                        ha="center", fontsize=8, color=color)

    waveform_panel(ax_orig, "Original Label", original_boundaries, "#c44")

    ax_det.set_title("Spectral Flux + MFCC Delta")
    if len(flux_times):
        ax_det.plot(flux_times, flux, color="purple", linewidth=0.9,
                    label="Flux")
        ax_det.plot(flux_times, delta_mag, color="orange", linewidth=0.9,
                    label="MFCC")
        ax_det.legend(loc="upper right", fontsize=8)
    for tb in predicted_boundaries:
        ax_det.axvline(tb, color="magenta", linestyle="--", linewidth=0.8)

    waveform_panel(ax_snap, "Corrected Label Boundaries",
                   snapped_boundaries, "#283")
    ax_snap.set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def _say(line: str) -> None:
    """``print(line)`` as one write: the folder mode's workers share one
    stdout, and unbuffered (``PYTHONUNBUFFERED``) ``print`` writes the text
    and its newline apart, so lines of workers that print at once would
    interleave."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def process_file(wav_path: str, save_plot: bool = False) -> None:
    """Reference correct_label.py:153-180: load → (cached) detect → snap →
    rewrite .lab → optional PNG → delete the boundary cache."""
    y, sr = read_wav(wav_path)
    if y.ndim > 1:
        y = y.mean(axis=1)
    if sr != 16000:
        y = resample(y, sr, 16000)
        sr = 16000

    boundaries = load_predicted_boundaries(wav_path)
    if boundaries is None:
        _say("[INFO] No pre-made boundary file detected, creating a new one")
        boundaries, flux, delta_mag, flux_times = detect_boundaries(y, sr)
        write_predicted_boundaries(wav_path, boundaries)
    else:
        _say(f"[INFO] Found pre-made boundary file for {wav_path}, using it")
        flux = delta_mag = flux_times = np.array([])

    snapped, original = correct_lab_boundaries(wav_path, boundaries)
    write_lab(wav_path, snapped)

    if save_plot:
        visualize_audio_features(wav_path, y, sr, boundaries, flux, delta_mag,
                                 flux_times, snapped, original,
                                 save_path=wav_path.replace(".wav", ".png"))

    boundary_path = wav_path.replace(".wav", "_boundary.txt")
    if os.path.exists(boundary_path):
        os.remove(boundary_path)


def _progress(total: int):
    """tqdm's bar when tqdm imports, else a plain ``done/total`` count on
    stderr; either way an object with ``update(n)`` and a context."""
    try:
        from tqdm import tqdm
        return tqdm(total=total)
    except ImportError:
        return _Count(total)


class _Count:
    def __init__(self, total: int):
        self.total, self.done = total, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        print(file=sys.stderr, flush=True)

    def update(self, n: int = 1) -> None:
        self.done += n
        print(f"\r{self.done}/{self.total}", end="", file=sys.stderr,
              flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Correct .lab timing boundaries from audio features.",
        usage="%(prog)s <input_path> [--save_plot]")
    parser.add_argument("input_path", type=str,
                        help="Path to .wav file or folder of .wav files")
    parser.add_argument("--save_plot", action="store_true",
                        help="saves PNG visualization")
    args = parser.parse_args(argv)

    if os.path.isdir(args.input_path):
        wav_files = [os.path.join(args.input_path, f)
                     for f in os.listdir(args.input_path)
                     if f.endswith(".wav")]
        # spawned workers: the parent has imported torch, whose threads a
        # forked child would inherit in an unknown state
        with ProcessPoolExecutor(
                max_workers=max(1, min(len(wav_files), os.cpu_count() or 1)),
                mp_context=multiprocessing.get_context("spawn")) as executor:
            futures = [executor.submit(process_file, fp, args.save_plot)
                       for fp in wav_files]
            with _progress(len(futures)) as bar:
                for fut in as_completed(futures):
                    fut.result()
                    bar.update(1)
        print("\nLabel correction complete. All files processed.")
    elif args.input_path.endswith(".wav"):
        process_file(args.input_path, save_plot=args.save_plot)
    else:
        print("Expected a .wav file or a folder of .wav files.")
        sys.exit(1)


if __name__ == "__main__":
    main()
