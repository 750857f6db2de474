"""Figure and array reports of reconstructions, spectra, samples and
confusion matrices.

Counterpart of ``sleepgen/eval/reports.py`` (the reference's
``util.py`` plotting: ``get_figure`` / ``log_reconstructions``
:137-173, ``get_epochs_spectrum`` / ``log_spectral`` :66-121 and
175-195, ``get_figure_ldm`` :124-134): waveform figures and a log-scale
PSD overlay saved as ``.pdf``, with the arrays beside them as ``.npy``
under the JAX package's names. The PSD is the port's Welch
(``eval/psd.welch_psd``), saved in float32 as the JAX package's is.

matplotlib is imported inside each function with the Agg backend; where
it is missing the functions raise ``ImportError``, as the JAX package's
do, and the trainers' figure hooks catch that and train on.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from sleepgen_torch.eval.psd import welch_psd


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_reconstruction_figure(run_dir: str | Path, step: int, original_bcl: np.ndarray,
                               recon_bcl: np.ndarray, name: str = "RECONSTRUCTION") -> Path:
    """Sample 0's original and reconstruction side by side
    (``reconstruction_<name>_<step>.pdf``), and both (B, C, L) arrays."""
    plt = _plt()
    run_dir = Path(run_dir)
    fig, axes = plt.subplots(1, 2, figsize=(15, 5), sharey=True)
    axes[0].plot(original_bcl[0, 0])
    axes[0].set_title("Original")
    axes[1].plot(recon_bcl[0, 0])
    axes[1].set_title("Reconstruction")
    out = run_dir / f"reconstruction_{name}_{step}.pdf"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    np.save(run_dir / f"original_{name}_{step}.npy", original_bcl)
    np.save(run_dir / f"reconstr_{name}_{step}.npy", recon_bcl)
    return out


def _mean_psd(x: np.ndarray, sfreq: float, fmax: float):
    psd, freqs = welch_psd(np.asarray(x, np.float32).reshape(-1, x.shape[-1]), sfreq=sfreq,
                           fmax=fmax)
    return psd.mean(axis=0).astype(np.float32), freqs.astype(np.float32)


def save_spectral_figure(run_dir: str | Path, step: int, eeg_bcl: np.ndarray,
                         recon_bcl: np.ndarray, name: str = "SPECTRAL_RECONSTRUCTION",
                         sfreq: float = 100.0, fmax: float = 12.0) -> Path:
    """Mean Welch PSD of the original (red) and the reconstruction (blue),
    log scale (``compare_<name>_<step>.pdf``), and each as (freqs, psd)."""
    plt = _plt()
    run_dir = Path(run_dir)
    p_orig, freqs = _mean_psd(eeg_bcl, sfreq, fmax)
    p_rec, _ = _mean_psd(recon_bcl, sfreq, fmax)
    fig, ax = plt.subplots(1, 1, figsize=(10, 4))
    ax.plot(freqs, p_orig, color="red", label="Original")
    ax.plot(freqs, p_rec, color="blue", label="Reconstructed")
    ax.set_yscale("log")
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("PSD")
    ax.set_title("PSD of the original dataset and synthetic data")
    ax.legend(loc="upper right")
    out = run_dir / f"compare_{name}_{step}.pdf"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    np.save(run_dir / f"original_spe_{name}_{step}.npy", np.stack([freqs, p_orig]))
    np.save(run_dir / f"reconstr_spe_{name}_{step}.npy", np.stack([freqs, p_rec]))
    return out


def save_sample_figure(run_dir: str | Path, step: int, samples_bcl: np.ndarray) -> Path:
    """Waveforms of the first four samples (``ldm_samples_<step>.pdf``)."""
    plt = _plt()
    n = min(4, samples_bcl.shape[0])
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), sharey=True, squeeze=False)
    for i in range(n):
        axes[0][i].plot(samples_bcl[i, 0].astype(np.float32))
        axes[0][i].set_title(f"Sample {i}")
    out = Path(run_dir) / f"ldm_samples_{step}.pdf"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def save_confusion_matrix_figure(path: str | Path, cm: np.ndarray,
                                 class_names: Sequence[str] = ("Wake", "N1", "N2", "N3", "REM"),
                                 ) -> Path:
    """A confusion-matrix heatmap with its counts (run_sleep_decode.py:268-273)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45)
    ax.set_yticks(range(len(class_names)), class_names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return Path(path)
