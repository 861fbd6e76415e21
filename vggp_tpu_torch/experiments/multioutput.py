"""Multi-output (ICM) gridded products: cross-output transfer demo.

Two correlated 2-D fields — a densely track-sampled primary (e.g. SSH from
a well-sampled mission) and a SPARSELY observed secondary output that is an
affine transform of the same latent (a second mission / correlated tracer).
One joint ICM Kronecker SGPR (collapsed bound) with a coregion axis (prior
B ⊗ K₁ ⊗ K₂) learns the cross-output correlation and transfers the dense
output's information to the sparse one; the control is an independent
single-output fit on the sparse data alone.

Outputs per model: test metrics on the sparse output, per-output gridded
q(v) products vs analytic cell-integral truth, and the learned B.

The port of ``vggp_tpu/experiments/multioutput.py``; it runs on ``cuda``
unless ``device`` names another device. Its results also hold the joint
fit's steps a second.

Run: ``python -m vggp_tpu_torch.experiments.multioutput [--iters N] [--outdir D]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, kernels, train
from vggp_tpu_torch.experiments import misc
from vggp_tpu_torch.features import CellIntegralFeature, OutputFeature
from vggp_tpu_torch.models import sgpr
from vggp_tpu_torch.utils import metrics


def _field(x1, x2):
    """Latent 2-D field with analytic cell integrals (separable terms)."""
    return np.sin(4.0 * x1) * np.cos(3.0 * x2)


def _cell_integrals(mesh1, mesh2, scale: float, offset: float) -> np.ndarray:
    """∫∫_cell (scale·f + offset) over the (mesh1 × mesh2) cells — exact."""
    a1, b1 = mesh1[:-1], mesh1[1:]
    a2, b2 = mesh2[:-1], mesh2[1:]
    i1 = (np.cos(4.0 * a1) - np.cos(4.0 * b1)) / 4.0     # ∫ sin(4x)
    i2 = (np.sin(3.0 * b2) - np.sin(3.0 * a2)) / 3.0     # ∫ cos(3y)
    areas = np.outer(b1 - a1, b2 - a2)
    return scale * np.outer(i1, i2) + offset * areas


def _tracks(rng, n_tracks: int, n_per: int):
    """Satellite-style diagonal passes across the unit square."""
    xs, ys = [], []
    for _ in range(n_tracks):
        x0 = rng.uniform(-0.4, 0.4)
        t = np.linspace(0.0, 1.0, n_per)
        xs.append(np.clip(x0 + t, 0.0, 1.0))
        ys.append(t)
    return np.concatenate(xs), np.concatenate(ys)


def run(
    n_iters: int = 800,
    learning_rate: float = 0.03,
    n_dense_tracks: int = 24,
    n_sparse_obs: int = 60,
    scale: float = 0.7,
    offset: float = 0.2,
    noise_sd: float = 0.05,
    m_axis: int = 16,
    grid_n: int = 12,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    # output 0: dense tracks of the latent field
    x1d, x2d = _tracks(rng, n_dense_tracks, 64)
    y0 = _field(x1d, x2d) + noise_sd * rng.standard_normal(x1d.shape[0])
    # output 1: affine transform, sparse random obs
    x1s = rng.uniform(0, 1, n_sparse_obs)
    x2s = rng.uniform(0, 1, n_sparse_obs)
    y1 = (scale * _field(x1s, x2s) + offset
          + noise_sd * rng.standard_normal(n_sparse_obs))
    # held-out test set for the sparse output
    x1t = rng.uniform(0, 1, 400)
    x2t = rng.uniform(0, 1, 400)
    ft = scale * _field(x1t, x2t) + offset

    X = as_f32(np.stack([
        np.concatenate([x1d, x1s]),
        np.concatenate([x2d, x2s]),
        np.concatenate([np.zeros_like(x1d), np.ones(n_sparse_obs)]),
    ], axis=1))
    Y = as_f32(np.concatenate([y0, y1]))

    # collapsed SGPR (optimal q(u) at every step, calibrated variances)
    mesh = np.linspace(0.0, 1.0, m_axis + 1)
    feats = (CellIntegralFeature(mesh=mesh), CellIntegralFeature(mesh=mesh),
             OutputFeature(n_outputs=2))
    # learn_mean: per-output constant means absorb the inter-mission bias
    # (a zero-mean GP would push the offset into kappa, deflating the
    # learned cross-correlation)
    spec = sgpr.SGPRSpec(kinds=("matern32", "matern32", "coregion"),
                         features=feats, learn_mean=True)
    p0 = train.non_informative_init(spec.init_params(torch.float32, device), X, Y)
    p_joint, _, final_loss, wall = misc.timed_fit(
        lambda q: sgpr.loss(spec, q, X, Y), p0, n_iters, learning_rate)

    # control: independent single-output SGPR on the sparse data alone
    spec_i = sgpr.SGPRSpec(kinds=("matern32", "matern32"), features=feats[:2],
                           learn_mean=True)
    Xi = as_f32(np.stack([x1s, x2s], axis=1))
    Yi = as_f32(y1)
    p0i = train.non_informative_init(spec_i.init_params(torch.float32, device), Xi, Yi)
    p_ind, _ = train.fit(lambda q: sgpr.loss(spec_i, q, Xi, Yi),
                         p0i, n_iters, learning_rate)

    with torch.no_grad():
        st = sgpr.precompute(spec, p_joint, X, Y)
        g_j = sgpr.posterior_from_state(spec, p_joint, st,
                                        as_f32(np.stack([x1t, x2t, np.ones(400)], axis=1)))
        g_i = sgpr.posterior(spec_i, p_ind, Xi, Yi, as_f32(np.stack([x1t, x2t], 1)),
                             full_cov=False)

    def _row(g):
        tt = torch.as_tensor(ft, dtype=torch.float32)[:, None]  # the 2D shape contract
        mean = misc.host(g.mean).reshape(-1, 1)
        mean_t = torch.as_tensor(mean)
        return {
            "rmse": float(metrics.root_mean_squared_error(tt, mean_t)),
            "r2": float(metrics.r_squared(tt, mean_t)),
            "nlpd": float(metrics.negative_log_predictive_density(
                tt.reshape(-1), mean_t.reshape(-1),
                torch.as_tensor(misc.host(g.variance())))),
        }

    # per-output gridded products from the joint model
    gmesh = np.linspace(0.0, 1.0, grid_n + 1)
    gaxes = (CellIntegralFeature(mesh=gmesh), CellIntegralFeature(mesh=gmesh),
             OutputFeature(n_outputs=2))
    with torch.no_grad():
        qv = sgpr.q_v_from_state(spec, p_joint, st, gaxes)
        B = misc.host(kernels.coregion_b(p_joint["axes"][2]))
    qv_mean = misc.host(qv.mean).reshape(grid_n, grid_n, 2)
    truth0 = _cell_integrals(gmesh, gmesh, 1.0, 0.0)
    truth1 = _cell_integrals(gmesh, gmesh, scale, offset)

    results = {
        "n_dense": int(x1d.shape[0]), "n_sparse": n_sparse_obs,
        "final_loss": final_loss,
        "sparse_output_test": {"joint_icm": _row(g_j),
                               "independent": _row(g_i)},
        "qv_err_output0": float(np.abs(qv_mean[:, :, 0] - truth0).max()),
        "qv_err_output1": float(np.abs(qv_mean[:, :, 1] - truth1).max()),
        "qv_scale": float(np.abs(truth0).max()),
        "learned_B": B.tolist(),
        "learned_corr": float(B[0, 1] / np.sqrt(B[0, 0] * B[1, 1])),
        "learned_means": misc.host(p_joint["mean"]).tolist(),
        "steps_per_sec": n_iters / wall,
    }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(results, f, indent=1)
        try:
            from vggp_tpu_torch.experiments import plotting

            plotting.plot_grid_heatmaps(
                {"q_v output 0": qv_mean[:, :, 0], "truth 0": truth0,
                 "q_v output 1": qv_mean[:, :, 1], "truth 1": truth1},
                title="ICM per-output gridded products",
                path=os.path.join(outdir, "qv_products.png"))
        except ImportError:
            pass
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--outdir", default="results/torch/multioutput")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(n_iters=args.iters, outdir=args.outdir, device=args.device)
    j = res["sparse_output_test"]["joint_icm"]
    i = res["sparse_output_test"]["independent"]
    print(f"sparse-output test: joint ICM rmse {j['rmse']:.4f} r2 {j['r2']:.3f} "
          f"nlpd {j['nlpd']:.3f} | independent rmse {i['rmse']:.4f} "
          f"r2 {i['r2']:.3f} nlpd {i['nlpd']:.3f}")
    print(f"learned cross-output corr {res['learned_corr']:+.3f}; "
          f"q_v max err out0 {res['qv_err_output0']:.4f} "
          f"out1 {res['qv_err_output1']:.4f} (scale {res['qv_scale']:.3f})")


if __name__ == "__main__":
    main()
