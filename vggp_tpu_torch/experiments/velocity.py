"""Geostrophic velocity fields from SSH — the gridded-GRADIENT data product.

Oceanographers' first derived quantity from the gridded SSH product is the
geostrophic velocity, which is the SSH *gradient*:

    u_g = −(g / f₀) ∂η/∂y,    v_g = (g / f₀) ∂η/∂x

(η sea-surface height, g gravity, f₀ the Coriolis parameter). Here the
trained gridded GP emits that product directly — exact closed-form
posteriors over per-cell mean gradients (``models.sgpr.q_dv_from_state``:
the cell integral of ∂f collapses to a face difference of point
evaluations) with per-cell uncertainty, validated against face-difference
trapezoid truth from the dense reference field
(``utils.grad_trapz_grid_2d``); then the current-speed distribution from
joint pathwise (f, ∂₀f, ∂₁f) draws.

The port of ``vggp_tpu/experiments/velocity.py``; it runs on ``cuda`` unless
``device`` names another device. Its draws come from CPU ``torch.Generator`` s
seeded where the JAX run takes ``PRNGKey(seed + k)``.

Run: ``python -m vggp_tpu_torch.experiments.velocity [--iters N] [--outdir D]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, kernels, sampling, train
from vggp_tpu_torch.data.gulfstream import SyntheticGulfStream
from vggp_tpu_torch.experiments import misc, plotting
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import sgpr
from vggp_tpu_torch.utils import grad_trapz_grid_2d
from vggp_tpu_torch.utils.metrics import (
    negative_log_predictive_density,
    r_squared,
    root_mean_squared_error,
)

GRAVITY = 9.81          # m s⁻²
OMEGA_EARTH = 7.2921e-5  # rad s⁻¹
M_PER_DEG_LAT = 111.2e3


def _axis_metrics(truth: np.ndarray, mean: np.ndarray, var: np.ndarray) -> Dict:
    """rmse, r² ((g, g), the metrics' 2-D contract), NLPD and the 2σ
    coverage, in float32 as the JAX run's ``jnp.asarray`` gives them."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    t2, m2 = f32(truth), f32(mean)
    t, m, v = f32(truth.reshape(-1)), f32(mean.reshape(-1)), f32(var.reshape(-1))
    inside = np.abs(truth.reshape(-1) - mean.reshape(-1)) <= 2.0 * np.sqrt(var.reshape(-1))
    return {
        "rmse": float(root_mean_squared_error(t2, m2)),
        "r2": float(r_squared(t2, m2)),
        "nlpd": float(negative_log_predictive_density(t, m, v)),
        "coverage_2sigma": float(inside.mean()),
    }


def run(
    seed: int = 0,
    sparsity: int = 2,
    n_features: int = 32,
    n_grid: int = 20,
    n_iters: int = 800,
    learning_rate: float = 0.02,
    kind: str = "matern32",
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    ds = SyntheticGulfStream(seed=seed)
    X, y = ds.obs_train_data(sparsity)
    Xt, yt = as_f32(X), as_f32(y)

    feats = (CellIntegralFeature.from_lims(n_features, 0.0, 1.0),
             CellIntegralFeature.from_lims(n_features, 0.0, 1.0))
    spec = sgpr.SGPRSpec(kinds=(kind, kind), features=feats)
    p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
    p_fit, _, final_loss, wall = misc.timed_fit(
        lambda q: sgpr.loss(spec, q, Xt, yt), p0, n_iters, learning_rate)

    grids = (CellIntegralFeature.from_lims(n_grid, 0.0, 1.0),
             CellIntegralFeature.from_lims(n_grid, 0.0, 1.0))
    cell_area = grids[0].delta * grids[1].delta
    with torch.no_grad():
        state = sgpr.precompute(spec, p_fit, Xt, yt)
        qdv = {ax: sgpr.q_dv_from_state(spec, p_fit, state, grids, axis=ax, full_cov=False)
               for ax in (0, 1)}

    # face-difference trapezoid truth from the dense (unit-scaled) field
    field, xs, ys = ds._field_scaled()
    truth = {ax: grad_trapz_grid_2d(field, xs, ys, n_grid, ax) for ax in (0, 1)}

    results: Dict = {"steps_per_sec": n_iters / wall, "final_loss": final_loss}
    mean_grad, std_grad = {}, {}
    for ax in (0, 1):
        mean = misc.host(qdv[ax].mean).reshape(n_grid, n_grid)
        var = misc.host(qdv[ax].variance()).reshape(n_grid, n_grid)
        results[f"grad{ax}"] = _axis_metrics(truth[ax], mean, var)
        # per-cell MEAN gradient (integral / cell measure) in scaled units
        mean_grad[ax] = mean / cell_area
        std_grad[ax] = np.sqrt(var) / cell_area

    # physical geostrophic velocities: scaled units → m/s on the sphere
    lo_lon, hi_lon, lo_lat, hi_lat = ds.extent
    lat0 = 0.5 * (lo_lat + hi_lat)
    f0 = 2.0 * OMEGA_EARTH * np.sin(np.deg2rad(lat0))
    m_per_x = (hi_lon - lo_lon) * M_PER_DEG_LAT * np.cos(np.deg2rad(lat0))
    m_per_y = (hi_lat - lo_lat) * M_PER_DEG_LAT
    u_g = -(GRAVITY / f0) * mean_grad[1] / m_per_y   # zonal (−∂η/∂y)
    v_g = (GRAVITY / f0) * mean_grad[0] / m_per_x    # meridional (+∂η/∂x)
    u_sd = (GRAVITY / f0) * std_grad[1] / m_per_y
    v_sd = (GRAVITY / f0) * std_grad[0] / m_per_x
    u_true = -(GRAVITY / f0) * (truth[1] / cell_area) / m_per_y
    v_true = (GRAVITY / f0) * (truth[0] / cell_area) / m_per_x
    speed = np.hypot(u_g, v_g)
    results["velocity"] = {
        "u_rmse_m_s": float(np.sqrt(np.mean((u_g - u_true) ** 2))),
        "v_rmse_m_s": float(np.sqrt(np.mean((v_g - v_true) ** 2))),
        "speed_max_m_s": float(speed.max()),
        "speed_mean_m_s": float(speed.mean()),
    }

    # current-speed distribution via JOINT pathwise (f, ∂₀f, ∂₁f) draws at
    # the cell centers: speed is nonlinear in the gradient, so its
    # distribution needs coherent joint samples. Matérn-3/2 spectral
    # gradients are heavy-tailed (t₃ frequencies); --kind matern52 gives
    # lower-variance exceedance maps at the same S.
    cx = 0.5 * (grids[0].mesh[:-1] + grids[0].mesh[1:])
    cy = 0.5 * (grids[1].mesh[:-1] + grids[1].mesh[1:])
    centers = np.stack(np.meshgrid(cx, cy, indexing="ij"), -1).reshape(-1, 2)
    with torch.no_grad():
        draws = misc.host(sampling.pathwise_posterior_collapsed_with_grads(
            spec, p_fit, misc.generator(seed + 7), Xt, yt, as_f32(centers),
            grad_axes=(0, 1), n_samples=96, n_features=1024))
    d0 = draws[:, 1, :]                 # (S, cells) ∂f/∂x_scaled samples
    d1 = draws[:, 2, :]
    u_s = -(GRAVITY / f0) * d1 / m_per_y
    v_s = (GRAVITY / f0) * d0 / m_per_x
    speed_s = np.hypot(u_s, v_s)        # (S, cells)
    thresh = 0.5  # m/s — "strong current" exceedance
    exceed = (speed_s > thresh).mean(0).reshape(n_grid, n_grid)
    # pointwise truth gradient at the centers (central differences on the
    # dense field — validation only)
    gx = np.gradient(field, xs, axis=0)
    gy = np.gradient(field, ys, axis=1)
    ix = np.searchsorted(xs, centers[:, 0])
    iy = np.searchsorted(ys, centers[:, 1])
    u_t = -(GRAVITY / f0) * gy[ix, iy] / m_per_y
    v_t = (GRAVITY / f0) * gx[ix, iy] / m_per_x
    speed_t = np.hypot(u_t, v_t)
    brier = float(np.mean(((speed_s > thresh).mean(0) - (speed_t > thresh)) ** 2))
    results["speed"] = {
        "exceed_threshold_m_s": thresh,
        "exceed_brier": brier,
        "speed_rmse_m_s": float(np.sqrt(np.mean((speed_s.mean(0) - speed_t) ** 2))),
        "speed_corr": float(np.corrcoef(speed_s.mean(0), speed_t)[0, 1]),
    }

    # relative geostrophic vorticity ζ/f₀ = (g/f₀²)∇²η — SECOND derivatives,
    # available when the kernel is twice differentiable (Matérn ≥ 5/2, RBF)
    if kind in kernels.TWICE_DIFFERENTIABLE_KINDS:
        with torch.no_grad():
            draws2 = misc.host(sampling.pathwise_posterior_collapsed_with_grads(
                spec, p_fit, misc.generator(seed + 11), Xt, yt, as_f32(centers),
                grad_axes=((2, 0), (0, 2)), n_samples=96, n_features=1024))
        dxx = draws2[:, 1, :] / m_per_x**2
        dyy = draws2[:, 2, :] / m_per_y**2
        zeta = (GRAVITY / f0**2) * (dxx + dyy)          # ζ/f₀ samples
        lap = (np.gradient(np.gradient(field, xs, axis=0), xs, axis=0) / m_per_x**2
               + np.gradient(np.gradient(field, ys, axis=1), ys, axis=1) / m_per_y**2)
        zeta_t = (GRAVITY / f0**2) * lap[ix, iy]
        zm = zeta.mean(0)
        results["vorticity"] = {
            "zeta_corr": float(np.corrcoef(zm, zeta_t)[0, 1]),
            "zeta_rmse": float(np.sqrt(np.mean((zm - zeta_t) ** 2))),
            "zeta_abs_p90": float(np.quantile(np.abs(zm), 0.9)),
        }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(results, fh, indent=2)
        np.savez(
            os.path.join(outdir, "fields.npz"),
            u_g=u_g, v_g=v_g, u_sd=u_sd, v_sd=v_sd,
            u_true=u_true, v_true=v_true,
            grad0_mean=mean_grad[0], grad1_mean=mean_grad[1],
            grad0_truth=truth[0] / cell_area, grad1_truth=truth[1] / cell_area,
        )
        plotting.plot_grid_heatmaps(
            {"u_g (GP)": u_g, "u_g (truth)": u_true,
             "v_g (GP)": v_g, "v_g (truth)": v_true,
             "speed": speed, "u σ": u_sd},
            title="geostrophic velocity from the gridded-gradient product",
            path=os.path.join(outdir, "velocity.png"))
        plotting.plot_grid_heatmaps(
            {"P(speed > 0.5 m/s)": exceed,
             "mean speed (samples)": speed_s.mean(0).reshape(n_grid, n_grid),
             "speed (truth)": speed_t.reshape(n_grid, n_grid)},
            title="current-speed exceedance from joint pathwise gradients",
            path=os.path.join(outdir, "speed_exceedance.png"))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--kind", default="matern32")
    ap.add_argument("--outdir", default="results/torch/velocity")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(n_iters=args.iters, kind=args.kind, outdir=args.outdir, device=args.device)
    for ax in (0, 1):
        m = res[f"grad{ax}"]
        print(f"grad{ax}: rmse={m['rmse']:.4g} r2={m['r2']:.3f} "
              f"nlpd={m['nlpd']:+.2f} cover2σ={m['coverage_2sigma']:.2f}")
    v = res["velocity"]
    print(f"velocity: u_rmse={v['u_rmse_m_s']:.3f} m/s v_rmse={v['v_rmse_m_s']:.3f} m/s "
          f"mean speed={v['speed_mean_m_s']:.3f} max={v['speed_max_m_s']:.3f}")
    s = res["speed"]
    print(f"speed (pathwise): rmse={s['speed_rmse_m_s']:.3f} m/s "
          f"corr={s['speed_corr']:.3f} exceed-Brier={s['exceed_brier']:.3f}")
    if "vorticity" in res:
        z = res["vorticity"]
        print(f"vorticity ζ/f₀: corr={z['zeta_corr']:.3f} rmse={z['zeta_rmse']:.3f} "
              f"|ζ/f₀| p90={z['zeta_abs_p90']:.3f}")


if __name__ == "__main__":
    main()
