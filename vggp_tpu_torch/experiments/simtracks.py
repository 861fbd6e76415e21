"""Notebook 6 equivalent: synthetic satellite tracks over a Gulf Stream SSH
snapshot (NATL60 hour when available, synthetic field otherwise), 20×20
gridded products from the 5-model zoo.

The port of ``vggp_tpu/experiments/simtracks.py``; it runs on ``cuda``
unless ``device`` names another device.

Run: ``python -m vggp_tpu_torch.experiments.simtracks [--iters N] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, train
from vggp_tpu_torch.data.simulation import generate_track, synthetic_ssh_field
from vggp_tpu_torch.experiments import misc, plotting, zoo
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import exact, sgpr
from vggp_tpu_torch.utils import min_max_scaling, simpson_grid_2d


def run(
    root_folder: str | None = None,
    trajectory_gradient: int = 2,
    track_sparsity: float = 2.0,
    observation_sparsity: int = 10,
    n_grid: int = 20,
    n_iters: int = 100,
    learning_rate: float = 0.05,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    # nb6 cell 3: NATL60 hour; synthetic stand-in without the archive
    if root_folder and os.path.isdir(root_folder):
        from vggp_tpu_torch.data.simulation import SimulationDataHour

        sim = SimulationDataHour(root_folder, "2012", "10", "01", 12)
        field = np.asarray(sim.data.sossheig.values)
        lons = np.asarray(sim.data.lon.values)
        lats = np.asarray(sim.data.lat.values)
    else:
        field, lons, lats = synthetic_ssh_field(seed=3)

    lon, lat, ssh = generate_track(field, lons, lats, trajectory_gradient,
                                   track_sparsity, observation_sparsity)
    # Scale by the FIELD extent (not the subsampled track's own extremes):
    # the Simpson truth grid below lives in full-field unit coordinates, and
    # a sparse track's min/max can sit strictly inside the field, which would
    # misalign predicted cells against truth cells.
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    x1, *_ = min_max_scaling(as_f32(lon), min=float(lons[0]), max=float(lons[-1]))
    x2, *_ = min_max_scaling(as_f32(lat), min=float(lats[0]), max=float(lats[-1]))
    X = torch.stack([x1, x2], dim=1)
    y = as_f32(ssh)

    # ground truth: Simpson cell integrals of the full field in unit coords
    xs = np.linspace(0, 1, field.shape[1])
    ys = np.linspace(0, 1, field.shape[0])
    truth = simpson_grid_2d(field.T, xs, ys, n_grid)  # [lon-cell, lat-cell]

    grids = (CellIntegralFeature.from_lims(n_grid, 0.0, 1.0),
             CellIntegralFeature.from_lims(n_grid, 0.0, 1.0))
    results: Dict = {"n_obs": int(len(ssh)), "truth": truth, "models": {}}

    def fit(name, spec, mod):
        p0 = train.non_informative_init(spec.init_params(torch.float32, device), X, y)
        p_fit, _, final_loss, wall = misc.timed_fit(
            lambda q: mod.loss(spec, q, X, y), p0, n_iters, learning_rate)
        with torch.no_grad():
            qv = mod.q_v(spec, p_fit, X, y, grids, full_cov=False)
        results["models"][name] = {
            "final_loss": final_loss,
            "steps_per_sec": n_iters / wall,
            "qv_mean": misc.host(qv.mean).reshape(n_grid, n_grid),
            "metrics": misc.evaluation_metric_row(truth, qv, y),
        }

    if len(ssh) <= 4000:
        fit("exactgp", zoo.exact_spec(2), exact)
    for name, spec in zoo.sgpr_specs_2d(n_inducing=10, n_frequencies=8,
                                        n_knots=n_grid, n_cells=n_grid).items():
        fit(name, spec, sgpr)

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        table = {name: dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"],
                                r["metrics"]),
                            steps_per_sec=round(r["steps_per_sec"], 1))
                 for name, r in results["models"].items()}
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(table, fh, indent=2)
        heat = {"truth": truth}
        heat.update({n: r["qv_mean"] for n, r in results["models"].items()})
        plotting.plot_grid_heatmaps(heat, title="simulated-track gridded predictions",
                                    path=os.path.join(outdir, "qv_means.png"))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--root", default=None)
    ap.add_argument("--outdir", default="results/torch/simtracks")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(root_folder=args.root, n_iters=args.iters, outdir=args.outdir,
              device=args.device)
    print(f"n_obs={res['n_obs']}")
    for name, r in res["models"].items():
        m = dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], r["metrics"]))
        print(f"{name:<10} it/s={r['steps_per_sec']:.0f} rmse={m['rmse']:.5f} "
              f"r2={m['r2']:.3f} nlpd={m['nlpd']:+.2f}")


if __name__ == "__main__":
    main()
