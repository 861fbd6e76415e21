"""Uncertainty propagation through nonlinear JOINT functionals via pathwise
posterior sampling.

"What is the distribution of the AREA where SSH exceeds τ?" and "how high
could the field's MAXIMUM plausibly be?" are functionals of the whole
latent surface at once. Marginal moments cannot answer them — treating
locations as independent shrinks the variance of spatial averages and
inflates the maximum. Coherent function draws from Matheron's rule
(``vggp_tpu_torch.sampling``) answer both, and the per-point sample moments
double as a validation of the sampler against the analytic posterior.

Truth: a smooth two-scale field; n noisy point observations; 2-D Kronecker
SVGP (cell-integral features) fit by minibatch Adam; functionals evaluated
on a dense evaluation lattice and on the gridded product's cells.

The port of ``vggp_tpu/experiments/exceedance.py``; it runs on ``cuda``
unless ``device`` names another device. Its draws come from CPU
``torch.Generator`` s seeded where the JAX run takes ``PRNGKey(seed + k)``.

Run: ``python -m vggp_tpu_torch.experiments.exceedance [--iters N] [--outdir D]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, sampling, train
from vggp_tpu_torch.experiments import misc, plotting
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import svgp


def field(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Two-scale smooth truth (large gyre + shorter-scale meanders)."""
    return (np.sin(3.0 * x) * np.cos(2.0 * y)
            + 0.5 * np.sin(7.0 * x + 1.0) * np.cos(5.0 * y + 0.5))


def generate_obs(n: int, noise: float, seed: int):
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2))
    y = field(X[:, 0], X[:, 1]) + noise * rng.standard_normal(n)
    return X, y


def truth_cell_means(n_cells: int) -> np.ndarray:
    """(c, c) truth cell means by per-cell Gauss–Legendre (8 nodes an axis:
    exact to machine precision for this smooth field)."""
    nodes, wts = np.polynomial.legendre.leggauss(8)
    edges = np.linspace(0.0, 1.0, n_cells + 1)
    half = 0.5 * (edges[1:] - edges[:-1])
    mid = 0.5 * (edges[1:] + edges[:-1])
    xq = mid[:, None] + half[:, None] * nodes[None, :]        # (c, 8)
    wq = half[:, None] * wts[None, :]                          # (c, 8)
    Fq = field(xq[:, :, None, None], xq[None, None, :, :])     # (c,8,c,8)
    return np.einsum("ip,jr,ipjr->ij", wq, wq, Fq) / (1.0 / n_cells) ** 2


def run(
    m_side: int = 32,
    n_eval: int = 64,
    n_obs: int = 5000,
    noise: float = 0.05,
    n_iters: int = 8000,
    batch_size: int = 1024,
    learning_rate: float = 0.05,
    n_samples: int = 256,
    n_features: int = 2048,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    X, y = generate_obs(n_obs, noise, seed)
    Xt, yt = as_f32(X), as_f32(y)

    feats = tuple(CellIntegralFeature.from_lims(m_side, 0.0, 1.0) for _ in range(2))
    spec = svgp.SVGPSpec(kinds=("matern32", "matern32"), features=feats,
                         num_data=n_obs, variational="kron")
    p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
    p_fit, hist, final_loss, wall = misc.timed_fit_minibatch(
        lambda q, xb, yb: svgp.loss(spec, q, xb, yb), p0, Xt, yt,
        n_iters, batch_size, learning_rate, seed)

    # dense evaluation lattice + truth functionals
    g = (np.arange(n_eval) + 0.5) / n_eval
    GX, GY = np.meshgrid(g, g, indexing="ij")
    Xg = as_f32(np.stack([GX.ravel(), GY.ravel()], -1))
    truth = field(GX, GY).ravel()
    tau = float(np.quantile(truth, 0.8))
    area_truth = float(np.mean(truth > tau))
    max_truth = float(truth.max())

    with torch.no_grad():
        post = svgp.posterior(spec, p_fit, Xg, full_cov=False)
        samp = misc.host(sampling.pathwise_posterior(
            spec, p_fit, misc.generator(seed + 1), Xg, n_samples=n_samples,
            n_features=n_features))                   # (S, n_eval²)
    mean = misc.host(post.mean)
    std = np.sqrt(misc.host(post.var))

    # sampler validation: per-point sample moments vs analytic
    mean_err = float(np.abs(samp.mean(0) - mean).max())
    var_rel = np.abs(samp.var(0) - std**2) / np.maximum(std**2, 1e-6)

    # joint functionals: coherent pathwise vs (wrong) independent marginals
    rng = np.random.default_rng(seed + 2)
    indep = mean[None, :] + std[None, :] * rng.standard_normal((n_samples, mean.size))
    area_path = (samp > tau).mean(axis=1)
    area_indep = (indep > tau).mean(axis=1)
    max_path = samp.max(axis=1)
    max_indep = indep.max(axis=1)

    # ---- product-level: coherent draws of the gridded product itself ----
    # pathwise_q_v gives JOINT draws of the cell averages with the prior-path
    # integrals in closed form, so exceedance areas and extremes of the
    # GRIDDED PRODUCT get full distributions too.
    n_cells = 32
    pg = tuple(CellIntegralFeature.from_lims(n_cells, 0.0, 1.0) for _ in range(2))
    cell_area = (1.0 / n_cells) ** 2
    with torch.no_grad():
        qv = svgp.q_v(spec, p_fit, pg, full_cov=False)
        vs = misc.host(sampling.pathwise_q_v(
            spec, p_fit, misc.generator(seed + 3), pg, n_samples=n_samples,
            n_features=n_features)) / cell_area       # (S, c²) means
    v_mean = misc.host(qv.mean) / cell_area
    v_std = np.sqrt(misc.host(qv.var)) / cell_area

    truth_v = truth_cell_means(n_cells)
    tau_v = float(np.quantile(truth_v.ravel(), 0.8))
    indep_v = v_mean[None, :] + v_std[None, :] * np.random.default_rng(
        seed + 4).standard_normal((n_samples, v_mean.size))

    results: Dict = {
        "final_loss": final_loss,
        "steps_per_sec": n_iters / wall,
        "sampler_mean_err": mean_err,
        "sampler_var_med_rel_err": float(np.median(var_rel)),
        "tau": tau,
        "area_truth": area_truth,
        "area_pathwise": misc.dist(area_path),
        "area_independent": misc.dist(area_indep),
        "max_truth": max_truth,
        "max_pathwise": misc.dist(max_path),
        "max_independent": misc.dist(max_indep),
        "n_obs": n_obs, "m_total": m_side**2,
        "n_samples": n_samples, "n_features": n_features,
        "product": {
            "n_cells": n_cells,
            "tau": tau_v,
            "qv_mean_rmse": float(np.sqrt(np.mean(
                (v_mean - truth_v.ravel()) ** 2))),
            "sampler_mean_err": float(np.abs(vs.mean(0) - v_mean).max()),
            "area_truth": float(np.mean(truth_v.ravel() > tau_v)),
            "area_pathwise": misc.dist((vs > tau_v).mean(axis=1)),
            "area_independent": misc.dist((indep_v > tau_v).mean(axis=1)),
            "max_truth": float(truth_v.max()),
            "max_pathwise": misc.dist(vs.max(axis=1)),
            "max_independent": misc.dist(indep_v.max(axis=1)),
        },
    }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(results, fh, indent=2)
        exc_prob = (samp > tau).mean(axis=0).reshape(n_eval, n_eval)
        plotting.plot_grid_heatmaps(
            {"truth field": truth.reshape(n_eval, n_eval),
             "posterior mean": mean.reshape(n_eval, n_eval),
             f"P[f > {tau:.2f}] (pathwise)": exc_prob},
            title="exceedance probability from coherent posterior samples",
            path=os.path.join(outdir, "exceedance.png"))
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--m-side", type=int, default=32)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--outdir", default="results/torch/exceedance")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(m_side=args.m_side, n_iters=args.iters, n_samples=args.samples,
              outdir=args.outdir, device=args.device)
    print(json.dumps(res, default=float))


if __name__ == "__main__":
    main()
