"""Reconstruction figures, the codebook-hierarchy ablation and dataset
figures.

Port of `encodec_tpu/tools/visualize.py` (behavioral reference:
encodec/visualize.py and the per-epoch figures of train.py:290-313):
`reconstruction_figure` (signal and spectrogram, original against
reconstruction), `hierarchy_ablation` (decode from a contiguous slice of
the RVQ stages, to see what each level contributes; K3 and K2 on the
card), and the dataset histograms `data_distribution_figure`,
`patients_distribution_figure` and `zero_runs_figure`.

matplotlib is imported inside the figure functions: the machine with the
card has none, and nothing else of the port needs it.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..losses.spectrogram import breathing_spectrogram


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def reconstruction_figure(x: np.ndarray, x_hat: np.ndarray, *,
                          sampling_rate: int = 10, n_fft: int = 512,
                          win_length: tp.Optional[int] = None,
                          hop_length: tp.Optional[int] = None,
                          path: tp.Optional[str] = None):
    """Original and reconstructed signal with their spectrograms (a
    4-panel figure, ref train.py:290-313). x, x_hat: `[T]` mono signals.
    Returns the figure (saved to `path` and closed when given)."""
    plt = _pyplot()

    def spec(v):
        s = breathing_spectrogram(
            torch.as_tensor(np.asarray(v, np.float32))[None], sampling_rate,
            n_fft, hop_length, win_length)
        return s[0].cpu().numpy()

    S_x, S_hat = spec(x), spec(x_hat)
    nf = S_x.shape[0] // 2
    S_x, S_hat = S_x[:nf], S_hat[:nf]
    vmin = min(S_x.min(), S_hat.min())
    vmax = max(S_x.max(), S_hat.max())

    fig, axs = plt.subplots(4, 1, figsize=(20, 10), sharex=True)
    t = np.arange(len(x))
    axs[0].plot(t, x)
    axs[0].set_title("Original")
    axs[0].set_ylim(-6, 6)
    axs[1].imshow(S_x, cmap="jet", aspect="auto",
                  extent=[0, len(x), 0, nf], vmin=vmin, vmax=vmax)
    axs[1].invert_yaxis()
    axs[1].set_title("Original Spectrogram")
    axs[2].plot(t[:len(x_hat)], x_hat)
    axs[2].set_title("Reconstructed")
    axs[2].set_ylim(-6, 6)
    axs[3].imshow(S_hat, cmap="jet", aspect="auto",
                  extent=[0, len(x), 0, nf], vmin=vmin, vmax=vmax)
    axs[3].invert_yaxis()
    axs[3].set_title("Reconstructed Spectrogram")
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig


@torch.inference_mode()
def hierarchy_ablation(model, x: np.ndarray, *, start: int = 0,
                       depth: tp.Optional[int] = None) -> np.ndarray:
    """Decode from RVQ stages `[start, start + depth)` only (the
    reference's codebook-hierarchy probe, visualize.py:262-277). x: `[C,
    T]`. Returns `[C, T']` audio reconstructed from that slice of the
    residual hierarchy, on the model's device."""
    from ..models.seanet import seanet_decoder, seanet_encoder
    from ..quant import rvq_intermediate_results

    xt = torch.as_tensor(np.asarray(x, np.float32)).T[None].to(model.device)
    emb = seanet_encoder(model.infer_params["encoder"], xt, model.cfg.seanet)
    stack = rvq_intermediate_results(model.qstate, emb,
                                     model.cfg.rvq)["quantized_stack"]
    n_q = stack.shape[0]
    end = min(start + (depth or n_q - start), n_q)
    out = seanet_decoder(model.infer_params["decoder"],
                         stack[start:end].sum(dim=0), model.cfg.seanet)
    return out[0].T.cpu().numpy()


def _save_or_return(plt, fig, path):
    if path:
        fig.savefig(path, dpi=300, bbox_inches="tight")
        plt.close(fig)
    return fig


def data_distribution_figure(items: tp.Iterable[np.ndarray], *,
                             bins: int = 74, value_range=(-6.0, 6.0),
                             title: str = "Histogram",
                             path: tp.Optional[str] = None):
    """One normalized value histogram over a dataset's signals,
    accumulated item by item so whole nights never sit in memory at once
    (ref visualize.py get_data_distribution 156-193). `items` yields
    arrays of any shape (e.g. `ds[i]["x"]`)."""
    plt = _pyplot()
    bin_edges = np.linspace(value_range[0], value_range[1], bins + 1)
    histogram = np.zeros(bins)
    for x in items:
        if x is None:
            continue
        histogram += np.histogram(np.asarray(x), bins=bin_edges)[0]
    histogram = histogram / max(1.0, histogram.sum())

    fig = plt.figure(figsize=(8, 6))
    plt.bar(bin_edges[:-1], histogram, width=np.diff(bin_edges),
            edgecolor="black", align="edge")
    plt.xlabel("Feature Value")
    plt.ylabel("Frequency")
    plt.title(title)
    plt.grid(True)
    return _save_or_return(plt, fig, path)


def patients_distribution_figure(items: tp.Sequence[dict], *,
                                 grid=(6, 6), bins: int = 49,
                                 value_range=(-4.0, 4.0),
                                 path: tp.Optional[str] = None):
    """Per-item value histograms on a grid (ref get_patients_distribution
    195-229). `items` are dataset dicts with 'x' and 'filename'."""
    plt = _pyplot()
    rows, cols = grid
    fig, axes = plt.subplots(rows, cols, figsize=(20, 10))
    axes = np.atleast_1d(axes).flatten()
    bin_edges = np.linspace(value_range[0], value_range[1], bins + 1)
    for ax, item in zip(axes, items):
        histogram = np.histogram(np.asarray(item["x"]),
                                 bins=bin_edges)[0].astype(np.float64)
        histogram /= max(1.0, histogram.sum())
        ax.bar(bin_edges[:-1], histogram, width=np.diff(bin_edges),
               edgecolor="black", align="edge")
        ax.set_title(f"File {str(item.get('filename', ''))[:6]}")
        ax.set_xlim(-6, 6)
        ax.grid(True)
    return _save_or_return(plt, fig, path)


def zero_runs_figure(items: tp.Iterable[np.ndarray], *,
                     window: int = 200 * 5, bins: int = 99,
                     path: tp.Optional[str] = None):
    """Histogram of constant-window ("zero-run") positions, normalized by
    signal length (ref get_zeros 426-514): a sliding window is flagged
    when every sample equals its first, the sensor-dropout signature that
    the offline curation (`data.curation`) blocklists."""
    plt = _pyplot()
    bin_edges = np.linspace(0.0, 1.0, bins + 1)
    histogram = np.zeros(bins)
    for x in items:
        x = np.asarray(x).reshape(-1)
        if x.shape[0] < window:
            continue
        view = np.lib.stride_tricks.sliding_window_view(x, window)
        idx = np.flatnonzero(np.all(view == view[:, :1], axis=1))
        if idx.size:
            histogram += np.histogram(idx / x.shape[0], bins=bin_edges)[0]
    total = histogram.sum()
    if total > 0:
        histogram = histogram / total

    fig = plt.figure(figsize=(8, 6))
    plt.bar(bin_edges[:-1], histogram, width=np.diff(bin_edges),
            edgecolor="black", align="edge")
    plt.xlabel("Index Value")
    plt.ylabel("Frequency")
    plt.title("Histogram of 0 indices")
    plt.grid(True)
    return _save_or_return(plt, fig, path)
