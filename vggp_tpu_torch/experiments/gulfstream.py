"""Notebooks 6 & 61 equivalent: Gulf Stream SSH gridded-GP experiment.

Train/val/test windows of along-track observations (real data-challenge
archives when present, synthetic stand-ins otherwise), a Simpson-gridded
ground truth, the 5-model zoo, optional CV sweeps over the SVGP inducing
count and VFF frequency count, and the nb61 metric tables.

The port of ``vggp_tpu/experiments/gulfstream.py``; it runs on ``cuda``
unless ``device`` names another device. Each record's ``params`` and ``qv``
are host (numpy) copies.

Run: ``python -m vggp_tpu_torch.experiments.gulfstream [--iters N] [--cv]
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
from vggp_tpu_torch.experiments.configs import EXP_1_TEST, EXP_1_TRAIN, EXP_1_VAL
from vggp_tpu_torch.experiments.loaders import load_gulf_stream_data
from vggp_tpu_torch.features import CellIntegralFeature, FourierFeature
from vggp_tpu_torch.models import exact, freesvgp, sgpr
from vggp_tpu_torch.models.common import Gaussian

METRIC_NAMES = ["mse", "mae", "rmse", "r2", "nlpd", "msll"]


def _fit_and_score(name, spec, Xj, yj, grids, truth, n_iters, lr, loss_mod):
    """(the host record of one fit, its final params on the device)."""
    p0 = train.non_informative_init(spec.init_params(torch.float32, Xj.device), Xj, yj)
    p_fit, hist, final_loss, wall = misc.timed_fit(
        lambda q: loss_mod.loss(spec, q, Xj, yj), p0, n_iters, lr)
    with torch.no_grad():
        qv = loss_mod.q_v(spec, p_fit, Xj, yj, grids, full_cov=False)
    record = {
        "params": train.tree_map(misc.host, p_fit),
        "final_loss": final_loss,
        "steps_per_sec": n_iters / wall,
        "qv": Gaussian(mean=misc.host(qv.mean), var=misc.host(qv.variance())),
        "metrics": misc.evaluation_metric_row(truth, qv, yj),
        "calibration": misc.calibration_row(truth, qv),
        "history": misc.record_history(misc.make_training_history_dict(n_iters), hist),
    }
    return record, p_fit


def run(
    obs_root: str = "data/dc_obs",
    ref_root: str = "data/dc_ref",
    sparsity: int = 3,
    n_iters: int = 1000,
    learning_rate: float = 0.01,
    run_cv: bool = False,
    cv_iters: int = 1000,   # nb61 used CV_ITERATIONS=100 on CPU
    cv_lr: float = 0.1,     # nb61 CV_LR
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    ds_train = load_gulf_stream_data(obs_root, ref_root, EXP_1_TRAIN)
    ds_val = load_gulf_stream_data(obs_root, ref_root, EXP_1_VAL)
    ds_test = load_gulf_stream_data(obs_root, ref_root, EXP_1_TEST)

    X_train, y_train = ds_train.obs_train_data(sparsity)
    X_val, y_val = ds_val.obs_train_data(sparsity)
    X_test, y_test = ds_test.obs_train_data(sparsity)

    n_splines = EXP_1_TRAIN["N_SPLINES"]
    train_grid = ds_train.grid_ref_data_simpson(n_splines)
    test_grid = ds_test.grid_ref_data_simpson(EXP_1_TEST["N_SPLINES"])

    grids = (CellIntegralFeature.from_lims(n_splines, 0.0, 1.0),
             CellIntegralFeature.from_lims(n_splines, 0.0, 1.0))

    results: Dict = {"train": {}, "test": {}, "cv": {}}

    def zoo_2d():
        d = {"exactgp": (zoo.exact_spec(2), exact)}
        d.update({k: (v, sgpr) for k, v in zoo.sgpr_specs_2d(
            n_inducing=10, n_frequencies=8, n_knots=n_splines, n_cells=n_splines
        ).items()})
        return d

    for split, (X, y, truth) in {
        "train": (X_train, y_train, train_grid),
        "test": (X_test, y_test, test_grid),
    }.items():
        Xj, yj = as_f32(X), as_f32(y)
        for name, (spec, mod) in zoo_2d().items():
            if name == "exactgp" and X.shape[0] > 5000:
                continue  # dense n³ beyond sensible size
            results[split][name], _ = _fit_and_score(
                name, spec, Xj, yj, grids, truth, n_iters, learning_rate, mod)

    # CV sweeps (nb61 cells 32/39): inducing count and frequency count,
    # scored on the validation window
    if run_cv:
        Xj, yj = as_f32(X_train), as_f32(y_train)
        Xv, yv = as_f32(X_val), as_f32(y_val)
        val_grid = ds_val.grid_ref_data_simpson(EXP_1_VAL["N_SPLINES"])

        # nb61 cell 32's exact range: m FREE 2-D inducing points (the
        # reference's GriddedMatern12SVGP takes Z (m, 2) directly —
        # models.freesvgp), not a per-axis product grid.
        cv_zs = [10, 30, 50, 100, 150, 200, 250, 300, 350, 400, 450, 500]
        cv = misc.cross_validation_dict(len(cv_zs))
        for i, n_z in enumerate(cv_zs):
            spec = freesvgp.FreeSVGPSpec(kinds=("matern12", "matern12"), m=n_z)
            p0 = train.non_informative_init(
                spec.init_params(torch.float32, device, seed=i), Xj, yj)
            p_fit, _, _, wall = misc.timed_fit(
                lambda q, s=spec: freesvgp.loss(s, q, Xj, yj), p0, cv_iters, cv_lr)
            with torch.no_grad():
                qv_tr = freesvgp.q_v(spec, p_fit, Xj, yj, grids, full_cov=False)
                qv_val = freesvgp.q_v(spec, p_fit, Xv, yv, grids, full_cov=False)
            cv["setting"][i] = n_z
            cv["train_metrics"][i] = misc.evaluation_metric_row(train_grid, qv_tr, yj)
            cv["val_metrics"][i] = misc.evaluation_metric_row(val_grid, qv_val, yv)
            cv.setdefault("steps_per_sec", [None] * len(cv_zs))[i] = round(
                cv_iters / wall, 1)
        results["cv"]["svgp_n_inducing"] = cv

        cv_oms = [1, 3, 5, 7, 10, 12]   # nb61 cell 39's exact range
        cv = misc.cross_validation_dict(len(cv_oms))
        for i, n_om in enumerate(cv_oms):
            spec = sgpr.SGPRSpec(
                kinds=("matern12", "matern12"),
                features=(FourierFeature(n_om, 0.0, 1.0), FourierFeature(n_om, 0.0, 1.0)))
            r, p_fit = _fit_and_score("vff", spec, Xj, yj, grids, train_grid,
                                      cv_iters, cv_lr, sgpr)
            with torch.no_grad():
                qv_val = sgpr.q_v(spec, p_fit, Xv, yv, grids, full_cov=False)
            cv["setting"][i] = n_om
            cv["train_metrics"][i] = r["metrics"]
            cv["val_metrics"][i] = misc.evaluation_metric_row(val_grid, qv_val, yv)
            cv.setdefault("steps_per_sec", [None] * len(cv_oms))[i] = round(
                r["steps_per_sec"], 1)
        results["cv"]["vff_n_omegas"] = cv

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        for split in ("train", "test"):
            table = {name: dict(zip(METRIC_NAMES, r["metrics"]),
                                steps_per_sec=round(r["steps_per_sec"], 1),
                                **r.get("calibration", {}))
                     for name, r in results[split].items()}
            with open(os.path.join(outdir, f"{split}_metrics.json"), "w") as fh:
                json.dump(table, fh, indent=2)
        heat = {"truth": train_grid}
        heat.update({n: r["qv"].mean.reshape(n_splines, n_splines)
                     for n, r in results["train"].items()})
        plotting.plot_grid_heatmaps(heat, title="train-window gridded predictions",
                                    path=os.path.join(outdir, "train_qv_means.png"))
        if run_cv:
            with open(os.path.join(outdir, "cv.json"), "w") as fh:
                json.dump(results["cv"], fh, indent=2, default=str)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--cv", action="store_true")
    ap.add_argument("--obs-root", default="data/dc_obs")
    ap.add_argument("--ref-root", default="data/dc_ref")
    ap.add_argument("--outdir", default="results/torch/gulfstream")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(obs_root=args.obs_root, ref_root=args.ref_root,
              n_iters=args.iters, run_cv=args.cv, outdir=args.outdir, device=args.device)
    for split in ("train", "test"):
        print(f"--- {split} ---")
        for name, r in res[split].items():
            m = dict(zip(METRIC_NAMES, r["metrics"]))
            print(f"{name:<10} it/s={r['steps_per_sec']:.0f} rmse={m['rmse']:.5f} "
                  f"r2={m['r2']:.3f} nlpd={m['nlpd']:+.2f} msll={m['msll']:+.2f}")


if __name__ == "__main__":
    main()
