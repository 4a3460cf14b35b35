"""Analysis/plotting utilities replicating the reference's Python tooling
(src/{energy,am-score,mixture,prior,nn-training,wer}-plotting, SURVEY §2.3)
— counterpart of speechrecognition_tpu/tools/plots.py.

Each function takes the framework's own artifacts (stats files, priors,
alignments) and writes a PNG; the data-extraction logic matches the
reference scripts so the same diagnostics are available. The readers are
numpy only; the plotting functions import matplotlib when they are called
(``_pyplot``), so importing this module needs no matplotlib.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first plot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_energy_segmentation(energy: np.ndarray, b1: int, b2: int,
                             out_path: str) -> None:
    """Frame energies with linear-segmentation boundaries
    (src/energy-plotting/plot.py over the trainer's .seg files)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(energy, lw=0.8)
    for b in (b1, b2):
        ax.axvline(b, color="red", ls="--", lw=1)
    ax.set_xlabel("frame")
    ax.set_ylabel("energy (c0)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def read_am_scores(path: str) -> List[Tuple[int, int, int, float]]:
    """Parse 'i j k score' lines (Training.cpp:127,159,208)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                rows.append((int(parts[0]), int(parts[1]), int(parts[2]),
                             float(parts[3])))
    return rows


def plot_am_scores(stats_path: str, out_path: str,
                   label: Optional[str] = None) -> None:
    """AM-score-per-EM-iteration curve (src/am-score-plotting/plot.py)."""
    plt = _pyplot()
    rows = read_am_scores(stats_path)
    scores = [r[3] for r in rows]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(scores, marker="o", ms=3, label=label or stats_path)
    for idx, r in enumerate(rows):
        if r[1] == -1:  # post-split markers
            ax.axvline(idx, color="gray", ls=":", lw=0.8)
    ax.set_xlabel("estimation step")
    ax.set_ylabel("avg −log score / frame")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_state_priors(priors: Dict[str, np.ndarray], out_path: str) -> None:
    """Compare state priors (src/prior-plotting/plot.py)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    for name, p in priors.items():
        ax.plot(p, lw=0.9, label=name)
    ax.set_xlabel("state")
    ax.set_ylabel("prior probability")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def read_nn_stats(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse 'train # cv # time' lines (NNTraining.cpp:288,415)."""
    train, cv, times = [], [], []
    with open(path) as f:
        for line in f:
            m = re.match(r"([\d.eE+-]+) # ([\d.eE+-]+) # ([\d.eE+-]+)", line)
            if m:
                train.append(float(m.group(1)))
                cv.append(float(m.group(2)))
                times.append(float(m.group(3)))
    return np.asarray(train), np.asarray(cv), np.asarray(times)


def plot_nn_training(stats_path: str, out_path: str) -> None:
    """Train/CV frame-error curves (src/nn-training-plotting/plot.py)."""
    plt = _pyplot()
    train, cv, _ = read_nn_stats(stats_path)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(train, marker="o", ms=3, label="train FER")
    ax.plot(cv, marker="s", ms=3, label="cv FER")
    ax.set_xlabel("epoch")
    ax.set_ylabel("frame error rate")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_wer_vs_threshold(results: Sequence[Tuple[float, float, float]],
                          out_path: str) -> None:
    """WER and RTF vs pruning threshold (src/wer-plotting/gnuplot).
    results: (threshold, wer%, rtf) tuples."""
    plt = _pyplot()
    thr = [r[0] for r in results]
    wer = [r[1] for r in results]
    rtf = [r[2] for r in results]
    fig, ax1 = plt.subplots(figsize=(8, 4))
    ax1.semilogx(thr, wer, marker="o", color="tab:blue", label="WER")
    ax1.set_xlabel("pruning threshold")
    ax1.set_ylabel("WER [%]", color="tab:blue")
    ax2 = ax1.twinx()
    ax2.semilogx(thr, rtf, marker="s", color="tab:red", label="RTF")
    ax2.set_ylabel("RTF", color="tab:red")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_mixture_scores(curves: Dict[str, Sequence[float]], out_path: str) -> None:
    """AM score trajectories for pooling/approximation variants
    (src/mixture-plotting/plot.py over {sum,max_approx}.{pooling} files)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    for name, ys in curves.items():
        ax.plot(list(ys), marker="o", ms=3, label=name)
    ax.set_xlabel("estimation step")
    ax.set_ylabel("avg −log score / frame")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def dump_log_spectrum_pgm(spectrum: np.ndarray, out_path: str) -> None:
    """Log-spectrum → PGM image (reference: Util.cpp create_pgm)."""
    s = np.log(np.maximum(spectrum, 1e-10))
    s = (255 * (s - s.min()) / max(1e-12, s.max() - s.min())).astype(np.uint8)
    img = s.T[::-1]  # frequency up the y-axis
    with open(out_path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
