"""Validation figures: the waveform with predicted and ground-truth
boundaries, the port's own copy of ``wfl_asr_tpu/utils/viz.py`` with its
figure contract (reference utils.py:87-146): a lightblue waveform, red
prediction boundaries and labels, green ground-truth ones, labels only for
segments longer than 20 ms, y limits ±1.

``matplotlib`` is imported where a figure is drawn; without it
:func:`visualize_prediction` raises ``ImportError`` naming it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Segment = Tuple[float, float, str]


def clean_label(ph) -> str:
    """A phoneme symbol for display: a list joined by spaces, stripped, one
    pair of parentheses or quotes removed (reference utils.py:87-100)."""
    if isinstance(ph, list):
        ph = " ".join(str(x) for x in ph)
    ph = str(ph).strip()
    if ph.startswith("(") and ph.endswith(")"):
        ph = ph[1:-1].strip()
    if (ph.startswith("'") and ph.endswith("'")) or \
            (ph.startswith('"') and ph.endswith('"')):
        ph = ph[1:-1].strip()
    return ph


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("validation figures need the 'matplotlib' "
                          "package, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def visualize_prediction(waveform, sample_rate: int,
                         segments_pred: List[Segment],
                         segments_gt: Optional[List[Segment]] = None,
                         title: str = "Prediction"):
    """The figure of one validation sample (a matplotlib ``Figure``)."""
    plt = _pyplot()

    while isinstance(segments_gt, list) and len(segments_gt) == 1 \
            and isinstance(segments_gt[0], list):
        segments_gt = segments_gt[0]

    waveform = np.asarray(waveform)
    duration = len(waveform) / sample_rate
    time = np.linspace(0, duration, len(waveform))

    fig, ax = plt.subplots(figsize=(12, 3))
    fig.patch.set_alpha(0)
    ax.set_facecolor("none")
    ax.plot(time, waveform, alpha=0.8, color="lightblue", zorder=0)

    for start, end, ph in segments_pred:
        ph = clean_label(ph)
        if end - start > 0.02:
            ax.text((start + end) / 2, 0.9, ph, color="red", ha="center",
                    va="bottom", transform=ax.get_xaxis_transform(),
                    fontsize=12, zorder=3)
        ax.axvline(start, color="red", linestyle="-", linewidth=0.6,
                   alpha=0.5, zorder=2)

    if segments_gt:
        for item in segments_gt:
            if not isinstance(item, (list, tuple)) or len(item) != 3:
                continue
            try:
                start, end = float(item[0]), float(item[1])
                ph = clean_label(item[2])
                if end - start > 0.02:
                    ax.text((start + end) / 2, 0.7, ph, color="green",
                            ha="center", va="bottom",
                            transform=ax.get_xaxis_transform(),
                            fontsize=12, zorder=3)
                ax.axvline(start, color="green", linestyle="-",
                           linewidth=0.6, alpha=0.5, zorder=2)
            except Exception as exc:  # a malformed segment is skipped
                print(f"[ERROR] Failed to plot GT segment {item}: {exc}")

    ax.set_title(title)
    ax.set_xlabel("Time (s)")
    ax.set_ylim(-1, 1)
    legend = [plt.Line2D([], [], linestyle="none", marker="o", color="red",
                         markersize=8, label="Pred"),
              plt.Line2D([], [], linestyle="none", marker="o", color="green",
                         markersize=8, label="GT")]
    ax.legend(handles=legend, loc="upper right", frameon=True, fancybox=True,
              framealpha=0.6)
    return fig
