"""Notebooks 1 & 4 equivalent: 1D model zoo on synthetic sin+cos data, with
gridded-prediction validation against quadrature truth.

The port of ``vggp_tpu/experiments/univariate.py``; it runs on ``cuda``
unless ``device`` names another device.

Run: ``python -m vggp_tpu_torch.experiments.univariate [--iters N] [--outdir D]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, train
from vggp_tpu_torch.experiments import misc, plotting, zoo
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import exact, sgpr
from vggp_tpu_torch.utils import gen_1d, integrate_1d


def _data(f, n_obs: int, noise: float, seed: int, device):
    X, y_clean = gen_1d(f, 0.0, 1.0, n_obs)
    rng = np.random.default_rng(seed)
    y = y_clean + noise * rng.standard_normal(n_obs)
    return (X, y, torch.as_tensor(X, dtype=torch.float32, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device))


def run(
    n_obs: int = 15,
    noise: float = 0.05,
    n_iters: int = 1000,
    learning_rate: float = 0.05,
    n_grid: int = 10,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    f = lambda x: np.sin(2 * x) + np.cos(5 * x)
    X, y, Xt, yt = _data(f, n_obs, noise, seed, device)
    xs = torch.linspace(0.0, 1.0, 200, dtype=torch.float32, device=device)

    grid = CellIntegralFeature.from_lims(n_grid, 0.0, 1.0)
    truth, _ = integrate_1d(f, grid.mesh)

    results: Dict = {"models": {}}
    members = {"exactgp": (zoo.exact_spec(1), exact)}
    members.update({name: (spec, sgpr)
                    for name, spec in zoo.sgpr_specs_1d(n_cells=n_grid).items()})
    for name, (spec, mod) in members.items():
        p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
        p_fit, hist, final_loss, wall = misc.timed_fit(
            lambda q, s=spec, m=mod: m.loss(s, q, Xt, yt), p0, n_iters, learning_rate)
        with torch.no_grad():
            post = mod.posterior(spec, p_fit, Xt, yt, xs, full_cov=False)
            qv = mod.q_v(spec, p_fit, Xt, yt, (grid,), full_cov=False)
        results["models"][name] = {
            "final_loss": final_loss,
            "steps_per_sec": n_iters / wall,
            "qv_max_err": float(np.abs(misc.host(qv.mean) - truth).max()),
            "metrics": misc.evaluation_metric_row(truth, qv, y),
            "calibration": misc.calibration_row(truth, qv),
            "posterior": (misc.host(post.mean), misc.host(post.stddev())),
            "history": {k: misc.host(v) for k, v in hist.items()},
        }

    results["truth_integrals"] = truth
    results["data"] = (X, y)

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        table = {
            name: dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], r["metrics"]),
                       steps_per_sec=round(r["steps_per_sec"], 1),
                       qv_max_err=r["qv_max_err"],
                       **r["calibration"])
            for name, r in results["models"].items()
        }
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(table, fh, indent=2)
        for name, r in results["models"].items():
            mu, sd = r["posterior"]
            plotting.plot_posterior_1d(
                X, y, misc.host(xs), mu, sd, truth_fn=f, title=name,
                path=os.path.join(outdir, f"posterior_{name}.png"))
    return results


def run_orders(
    n_obs: int = 40,
    noise: float = 0.05,
    n_iters: int = 1000,
    learning_rate: float = 0.05,
    n_grid: int = 10,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    """The full kernel×feature matrix: 4 sparse families × Matérn 1/2, 3/2,
    5/2 (ASVGP spline degree and VFF Kuu rank track the order — both beyond
    the reference's Matérn-1/2-only versions)."""
    device = config.resolve_device(device)
    f = lambda x: np.sin(2 * x) + np.cos(5 * x)
    _, y, Xt, yt = _data(f, n_obs, noise, seed, device)
    grid = CellIntegralFeature.from_lims(n_grid, 0.0, 1.0)
    truth, _ = integrate_1d(f, grid.mesh)
    out: Dict = {}
    for kind in ("matern12", "matern32", "matern52"):
        out[kind] = {}
        for name, spec in zoo.sgpr_specs_1d_orders(kind, n_cells=n_grid).items():
            p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
            p_fit, _, final_loss, wall = misc.timed_fit(
                lambda q, s=spec: sgpr.loss(s, q, Xt, yt), p0, n_iters, learning_rate)
            with torch.no_grad():
                qv = sgpr.q_v(spec, p_fit, Xt, yt, (grid,), full_cov=False)
            out[kind][name] = dict(
                zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"],
                    misc.evaluation_metric_row(truth, qv, y)),
                steps_per_sec=round(n_iters / wall, 1),
                final_loss=final_loss,
            )
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "orders_metrics.json"), "w") as fh:
            json.dump(out, fh, indent=2)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--outdir", default="results/torch/univariate")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--orders", action="store_true",
                    help="also run the kernel-order × feature-family matrix")
    args = ap.parse_args()
    res = run(n_iters=args.iters, outdir=args.outdir, device=args.device)
    for name, r in res["models"].items():
        m = dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], r["metrics"]))
        print(f"{name:<10} loss={r['final_loss']:+.3f} it/s={r['steps_per_sec']:.0f} "
              f"qv_err={r['qv_max_err']:.4f} rmse={m['rmse']:.4f} r2={m['r2']:.3f} "
              f"nlpd={m['nlpd']:+.2f}")
    if args.orders:
        orders = run_orders(n_iters=args.iters, outdir=args.outdir, device=args.device)
        for kind, models in orders.items():
            for name, m in models.items():
                print(f"{kind:<9} {name:<10} it/s={m['steps_per_sec']:.0f} "
                      f"rmse={m['rmse']:.4f} r2={m['r2']:.3f} nlpd={m['nlpd']:+.2f}")


if __name__ == "__main__":
    main()
