"""Plotting helpers (reference's missing ``src.utils.plotting`` module).

Matplotlib is imported lazily with the Agg backend so headless runs work;
where it is not installed a plot raises ``ImportError``. The port's copy of
``vggp_tpu/experiments/plotting.py``: numpy in, the same figures.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_model_history(history: Dict, title: str = "", path: Optional[str] = None):
    """Loss + hyperparameter traces over iterations (nb61 usage)."""
    plt = _plt()
    keys = [k for k in ("elbo", "noise", "scale_sigma_1", "scale_sigma_2",
                        "lengthscale_1", "lengthscale_2")
            if history.get(k) is not None and len(history.get(k, [])) > 0]
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3))
    if len(keys) == 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        ax.plot(np.asarray(history[k]))
        ax.set_title(k)
        ax.set_xlabel("iteration")
    fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def plot_posterior_1d(x, y, xstar, mean, std, truth_fn=None, title: str = "",
                      path: Optional[str] = None):
    """Posterior overlay plot (nb1 cell 35 pattern)."""
    plt = _plt()
    x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
    xs, mu, sd = np.asarray(xstar).ravel(), np.asarray(mean).ravel(), np.asarray(std).ravel()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.scatter(x, y, s=12, c="k", label="obs", zorder=3)
    ax.plot(xs, mu, label="posterior mean")
    ax.fill_between(xs, mu - 2 * sd, mu + 2 * sd, alpha=0.25, label="±2σ")
    if truth_fn is not None:
        ax.plot(xs, truth_fn(xs), "--", label="truth")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def plot_grid_heatmaps(grids: Dict[str, np.ndarray], title: str = "",
                       path: Optional[str] = None):
    """Side-by-side heatmaps of gridded products (nb5/nb61 pattern)."""
    plt = _plt()
    names = list(grids)
    fig, axes = plt.subplots(1, len(names), figsize=(3.4 * len(names), 3.2))
    if len(names) == 1:
        axes = [axes]
    vals = np.concatenate([np.asarray(g).ravel() for g in grids.values()])
    vmin, vmax = np.nanmin(vals), np.nanmax(vals)
    for ax, name in zip(axes, names):
        im = ax.imshow(np.asarray(grids[name]).T, origin="lower", vmin=vmin, vmax=vmax)
        ax.set_title(name)
    fig.colorbar(im, ax=axes, shrink=0.8)
    fig.suptitle(title)
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig
