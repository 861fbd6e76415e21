"""Notebooks 3 & 5 equivalent: 2D Kronecker model zoo on a synthetic
multiscale field, with 2D gridded-prediction validation.

The port of ``vggp_tpu/experiments/kronecker.py``; it runs on ``cuda``
unless ``device`` names another device.

Run: ``python -m vggp_tpu_torch.experiments.kronecker [--iters N] [--outdir D]
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
from vggp_tpu_torch.utils import gen_2d, trapz_grid_2d


def run(
    n_side: int = 25,
    noise: float = 0.05,
    n_iters: int = 500,
    learning_rate: float = 0.05,
    n_grid: int = 10,
    seed: int = 0,
    outdir: str | None = None,
    include_exact: bool = True,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    # nb3's multiscale test function
    f = lambda a, b: np.sin(8 * a) * np.cos(8 * b) + 0.5 * np.sin(2 * (a + b))
    X, y = gen_2d(f, (0, 1), (0, 1), n_side)
    rng = np.random.default_rng(seed)
    y = y + noise * rng.standard_normal(y.shape)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)

    grids = (CellIntegralFeature.from_lims(n_grid, 0.0, 1.0),
             CellIntegralFeature.from_lims(n_grid, 0.0, 1.0))
    # dense truth field on a fine grid -> per-cell trapezoid integrals
    fine = 400
    xs_f = np.linspace(0, 1, fine)
    dense = f(xs_f[:, None], xs_f[None, :])  # [x1, x2]
    truth = trapz_grid_2d(dense, xs_f, xs_f, n_grid)  # [cell1, cell2]

    results: Dict = {"models": {}, "truth": truth}

    members = {"exactgp": (zoo.exact_spec(2), exact)} if include_exact else {}
    members.update({name: (spec, sgpr) for name, spec in zoo.sgpr_specs_2d().items()})
    for name, (spec, mod) in members.items():
        p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
        p_fit, _, final_loss, wall = misc.timed_fit(
            lambda q, s=spec, m=mod: m.loss(s, q, Xt, yt), p0, n_iters, learning_rate)
        with torch.no_grad():
            qv = mod.q_v(spec, p_fit, Xt, yt, grids, full_cov=False)
        mean = misc.host(qv.mean).reshape(n_grid, n_grid)
        results["models"][name] = {
            "final_loss": final_loss,
            "steps_per_sec": n_iters / wall,
            "qv_grid": mean,
            "qv_var": misc.host(qv.variance()).reshape(n_grid, n_grid),
            "qv_max_err": float(np.abs(mean - truth).max()),
            "metrics": misc.evaluation_metric_row(truth, qv, y),
        }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        table = {
            name: dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], r["metrics"]),
                       steps_per_sec=round(r["steps_per_sec"], 1),
                       qv_max_err=r["qv_max_err"])
            for name, r in results["models"].items()
        }
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(table, fh, indent=2)
        heat = {"truth": truth}
        heat.update({n: r["qv_grid"] for n, r in results["models"].items()})
        plotting.plot_grid_heatmaps(heat, title="gridded predictions q(v)",
                                    path=os.path.join(outdir, "qv_means.png"))
        plotting.plot_grid_heatmaps(
            {n: r["qv_var"] for n, r in results["models"].items()},
            title="q(v) variances", path=os.path.join(outdir, "qv_vars.png"))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--outdir", default="results/torch/kronecker")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--no-exact", action="store_true")
    args = ap.parse_args()
    res = run(n_iters=args.iters, outdir=args.outdir, include_exact=not args.no_exact,
              device=args.device)
    for name, r in res["models"].items():
        m = dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], r["metrics"]))
        print(f"{name:<10} loss={r['final_loss']:+.2f} it/s={r['steps_per_sec']:.0f} "
              f"qv_err={r['qv_max_err']:.4f} r2={m['r2']:.3f} nlpd={m['nlpd']:+.2f}")


if __name__ == "__main__":
    main()
