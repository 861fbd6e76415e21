"""Notebook 7 equivalent: North Sea SLA gridded products.

Loads a month of real CMEMS AltiKa sea-level anomalies over the North Sea
(51-61°N, -3-10°E) when the archive is present, otherwise a synthetic
stand-in with the same along-track geometry; fits the ASVGP and GriddedGP
models and extracts 20×20 gridded q(v) products.

The port of ``vggp_tpu/experiments/northsea.py``; it runs on ``cuda``
unless ``device`` names another device.

Run: ``python -m vggp_tpu_torch.experiments.northsea [--iters N] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, train
from vggp_tpu_torch.data.gulfstream import SyntheticGulfStream
from vggp_tpu_torch.experiments import misc, plotting
from vggp_tpu_torch.features import B1SplineFeature, CellIntegralFeature
from vggp_tpu_torch.models import sgpr
from vggp_tpu_torch.utils import min_max_scaling

NORTH_SEA_LAT = (51.0, 61.0)
NORTH_SEA_LON = (-3.0, 10.0)


def _load_obs(root_folder: str | None):
    """(lon, lat, sla): real AltiKa 2013-04 month if available, else synthetic."""
    if root_folder and os.path.isdir(root_folder):
        from vggp_tpu_torch.data.missions import MissionData

        md = MissionData(root_folder, "al", ["2013"], ["04"],
                         latitude_range=NORTH_SEA_LAT, longitude_range=NORTH_SEA_LON)
        if len(md):
            return md.observations("sla_filtered")
    extent = (*NORTH_SEA_LON, *NORTH_SEA_LAT)
    syn = SyntheticGulfStream(satellite_name="envisat", seed=7, extent=extent,
                              trajectory_gradient=2, track_sparsity=0.4)
    lon, lat, val = syn._obs()
    return lon, lat, val


def run(
    root_folder: str | None = None,
    n_grid: int = 20,
    n_iters: int = 500,
    learning_rate: float = 0.01,
    max_obs: int = 20000,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    lon, lat, sla = _load_obs(root_folder)
    if len(sla) > max_obs:
        idx = np.random.default_rng(0).choice(len(sla), max_obs, replace=False)
        lon, lat, sla = lon[idx], lat[idx], sla[idx]

    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    x1, lo1, hi1 = min_max_scaling(as_f32(lon))
    x2, lo2, hi2 = min_max_scaling(as_f32(lat))
    X = torch.stack([x1, x2], dim=1)
    y = as_f32(sla)

    grids = (CellIntegralFeature.from_lims(n_grid, 0.0, 1.0),
             CellIntegralFeature.from_lims(n_grid, 0.0, 1.0))
    specs = {
        "asvgp": sgpr.SGPRSpec(
            kinds=("matern12", "matern12"),
            features=(B1SplineFeature(np.linspace(0, 1, n_grid + 1)),
                      B1SplineFeature(np.linspace(0, 1, n_grid + 1)))),
        "griddedgp": sgpr.SGPRSpec(
            kinds=("matern12", "matern12"),
            features=(CellIntegralFeature.from_lims(n_grid, 0.0, 1.0),
                      CellIntegralFeature.from_lims(n_grid, 0.0, 1.0))),
    }

    results: Dict = {"n_obs": int(len(sla)), "models": {}}
    for name, spec in specs.items():
        p0 = train.non_informative_init(spec.init_params(torch.float32, device), X, y)
        p_fit, _, final_loss, wall = misc.timed_fit(
            lambda q, s=spec: sgpr.loss(s, q, X, y), p0, n_iters, learning_rate)
        with torch.no_grad():
            qv = sgpr.q_v(spec, p_fit, X, y, grids, full_cov=False)
        results["models"][name] = {
            "final_loss": final_loss,
            "steps_per_sec": n_iters / wall,
            "qv_mean": misc.host(qv.mean).reshape(n_grid, n_grid),
            "qv_var": misc.host(qv.var).reshape(n_grid, n_grid),
        }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        plotting.plot_grid_heatmaps(
            {n: r["qv_mean"] for n, r in results["models"].items()},
            title="North Sea gridded SLA q(v) means",
            path=os.path.join(outdir, "qv_means.png"))
        plotting.plot_grid_heatmaps(
            {n: r["qv_var"] for n, r in results["models"].items()},
            title="North Sea q(v) variances",
            path=os.path.join(outdir, "qv_vars.png"))
        with open(os.path.join(outdir, "summary.json"), "w") as fh:
            json.dump({n: {"final_loss": r["final_loss"],
                           "steps_per_sec": round(r["steps_per_sec"], 2)}
                       for n, r in results["models"].items()}, fh, indent=2)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--root", default=None, help="CMEMS mission archive root")
    ap.add_argument("--outdir", default="results/torch/northsea")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(root_folder=args.root, n_iters=args.iters, outdir=args.outdir,
              device=args.device)
    print(f"n_obs={res['n_obs']}")
    for name, r in res["models"].items():
        print(f"{name:<10} loss={r['final_loss']:+.2f} it/s={r['steps_per_sec']:.1f}")


if __name__ == "__main__":
    main()
