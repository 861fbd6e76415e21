"""Gridded Poisson intensity mapping: count observations → latent-rate q(v).

COUNT data (e.g. storm events, sightings, detections per quadrat) drive a
2-D Kronecker SVGP with a Poisson log-link likelihood
(``vggp_tpu_torch.likelihoods``), and the gridded-product head q(v) delivers
per-cell integrals of the latent log-intensity WITH uncertainty — the
machinery is likelihood-independent because q(v) is a linear functional of
q(u).

Truth: log-intensity f(x, y) = a + b·sin(2πx)cos(2πy) (separable → exact
cell integrals); y_i ~ Poisson(e^{f(x_i)}).

The port of ``vggp_tpu/experiments/poisson.py``; it runs on ``cuda`` unless
``device`` names another device. Its random draws come from CPU
``torch.Generator`` s seeded where the JAX run takes ``PRNGKey(seed + k)``,
so a card run and a CPU run draw the same samples.

Run: ``python -m vggp_tpu_torch.experiments.poisson [--iters N] [--outdir D]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, likelihoods, sampling, train
from vggp_tpu_torch.experiments import misc, plotting
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import svgp

_A, _B = 1.0, 0.8


def log_intensity(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return _A + _B * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)


def truth_integrals(mesh_x: np.ndarray, mesh_y: np.ndarray) -> np.ndarray:
    """Exact ∬_cell f over each (i, j) grid cell (separable closed form)."""
    dx = np.diff(mesh_x)
    dy = np.diff(mesh_y)
    sx = (np.cos(2 * np.pi * mesh_x[:-1]) - np.cos(2 * np.pi * mesh_x[1:])) / (2 * np.pi)
    cy = (np.sin(2 * np.pi * mesh_y[1:]) - np.sin(2 * np.pi * mesh_y[:-1])) / (2 * np.pi)
    return _A * dx[:, None] * dy[None, :] + _B * sx[:, None] * cy[None, :]


def generate_counts(n: int = 4000, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2))
    lam = np.exp(log_intensity(X[:, 0], X[:, 1]))
    y = rng.poisson(lam).astype(np.float64)
    return X, y, lam


def run(
    m_side: int = 32,
    n_grid: int = 10,
    n_obs: int = 4000,
    n_iters: int = 16000,
    batch_size: int = 1024,
    learning_rate: float = 0.05,
    seed: int = 0,
    n_quad: int = 48,
    n_count_samples: int = 512,
    n_count_features: int = 2048,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    X, y, lam_true = generate_counts(n=n_obs, seed=seed)
    Xt, yt = as_f32(X), as_f32(y)

    feats = tuple(CellIntegralFeature.from_lims(m_side, 0.0, 1.0) for _ in range(2))
    spec = svgp.SVGPSpec(kinds=("matern32", "matern32"), features=feats,
                         num_data=X.shape[0], variational="kron",
                         likelihood="poisson")
    p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
    # count-aware prior scale: the Gaussian init heuristic sets the kernel
    # variance from var(y) of the COUNTS (≈ E[λ] + var(λ)), an order of
    # magnitude above the latent log-intensity's spread; var(log1p(y)) is
    # the right scale.
    zv = float(np.var(np.log1p(np.asarray(y))))
    for ax in p0["axes"]:
        ax["variance"] = torch.tensor(zv, dtype=torch.float32, device=device)

    p_fit, hist, final_loss, wall = misc.timed_fit_minibatch(
        lambda q, xb, yb: svgp.loss(spec, q, xb, yb), p0, Xt, yt,
        n_iters, batch_size, learning_rate, seed)

    # gridded product over the LATENT log-intensity
    grids = tuple(CellIntegralFeature.from_lims(n_grid, 0.0, 1.0) for _ in range(2))
    with torch.no_grad():
        qv = svgp.q_v(spec, p_fit, grids, full_cov=False)
        # pointwise predictive intensity on the observation sites
        lam_hat, _ = svgp.predict_y(spec, p_fit, Xt)
    truth = truth_integrals(grids[0].mesh, grids[1].mesh)
    mean2 = misc.host(qv.mean).reshape(n_grid, n_grid)
    metrics = misc.evaluation_metric_row(truth, qv, y)
    rel = np.abs(misc.host(lam_hat) - lam_true) / lam_true

    # ---- region-total counts: a joint functional of the latent surface ----
    # N_region | f ~ Poisson(Λ), Λ = ∬_region e^{f}: a nonlinear functional
    # of the WHOLE field, whose distribution needs coherent draws
    # (sampling.pathwise_posterior); independent marginals at the quadrature
    # points decohere e^{f} under the integral and shrink the Λ spread.
    x0, x1, y0, y1 = 0.0, 0.5, 0.0, 0.5
    nq, n_s, n_feat = n_quad, n_count_samples, n_count_features
    gq = (np.arange(nq) + 0.5) / nq
    qx, qy = x0 + gq * (x1 - x0), y0 + gq * (y1 - y0)
    QX, QY = np.meshgrid(qx, qy, indexing="ij")
    Xq = as_f32(np.stack([QX.ravel(), QY.ravel()], -1))
    w_cell = (x1 - x0) * (y1 - y0) / nq**2

    with torch.no_grad():
        samp = misc.host(sampling.pathwise_posterior(
            spec, p_fit, misc.generator(seed + 11), Xq, n_samples=n_s,
            n_features=n_feat))                           # (S, nq²) latent f
        post_q = svgp.posterior(spec, p_fit, Xq, full_cov=False)
    lam_big = np.exp(log_intensity(QX, QY)).ravel()
    lam_tot_truth = float(w_cell * lam_big.sum())        # ∬ e^f truth (midpoint)
    lam_tot = w_cell * np.exp(samp).sum(axis=1)          # (S,) pathwise Λ

    mq, sq = misc.host(post_q.mean), np.sqrt(misc.host(post_q.var))
    indep = mq[None, :] + sq[None, :] * np.random.default_rng(
        seed + 12).standard_normal((n_s, mq.size))
    lam_tot_indep = w_cell * np.exp(indep).sum(axis=1)

    # N_s ~ Poisson(Λ_s), drawn on the CPU from the host Λ (float32, as the
    # JAX run's jnp.asarray of it)
    counts = misc.host(likelihoods.sample_observations(
        "poisson", misc.generator(seed + 13),
        torch.as_tensor(np.log(lam_tot), dtype=torch.float32)[:, None]))[:, 0]

    results: Dict = {
        "final_loss": final_loss,
        "steps_per_sec": n_iters / wall,
        "qv_max_err": float(np.abs(mean2 - truth).max()),
        "metrics": metrics,
        "intensity_median_rel_err": float(np.median(rel)),
        "n_obs": int(X.shape[0]),
        "m_total": int(m_side) ** 2,
        "region_counts": {
            "region": [x0, x1, y0, y1],
            "lambda_truth": lam_tot_truth,
            "lambda_pathwise": misc.dist(lam_tot),
            "lambda_independent": misc.dist(lam_tot_indep),
            "counts_predictive": misc.dist(counts),
            "n_samples": n_s, "n_quad": nq * nq,
        },
    }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        table = dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], metrics),
                     steps_per_sec=round(results["steps_per_sec"], 1),
                     qv_max_err=results["qv_max_err"],
                     intensity_median_rel_err=results["intensity_median_rel_err"],
                     n_obs=results["n_obs"], m_total=results["m_total"],
                     region_counts=results["region_counts"])
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(table, fh, indent=2)
        plotting.plot_grid_heatmaps(
            {"truth ∬f per cell": truth, "q(v) mean": mean2},
            title="gridded Poisson log-intensity product",
            path=os.path.join(outdir, "qv_latent.png"))
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=16000)
    ap.add_argument("--m-side", type=int, default=32)
    ap.add_argument("--outdir", default="results/torch/poisson")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(m_side=args.m_side, n_iters=args.iters, outdir=args.outdir, device=args.device)
    print(json.dumps({k: v for k, v in res.items() if not isinstance(v, tuple)},
                     default=float))


if __name__ == "__main__":
    main()
