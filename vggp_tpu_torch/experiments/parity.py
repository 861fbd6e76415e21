"""Apples-to-apples parity: reference-style torch f64 (CPU) vs the port (f32).

Both columns get IDENTICAL inputs — the same SyntheticGulfStream train/test
windows (stable crc32 seeds), the same Simpson-gridded truth, the same
non-informative inits, the same Adam(0.01) × 1000-iteration protocol (nb61
cells 24-60) — and are scored with the same [mse, mae, rmse, r², nlpd, msll]
metric row on the 20×20 gridded q(v) data product.

The reference column is :mod:`vggp_tpu_torch.experiments.torch_oracle` — an
independent float64 implementation of the reference's models (the
reference's own gpytorch stack is not installable in this image; the oracle
matches its math model-for-model and its training protocol, minus documented
reference bugs, see torch_oracle docstring). It runs on the CPU by design.
The port's column, ``vggp_tpu_torch_f32``, runs on ``device`` (``cuda``
unless the caller names another).

The port of ``vggp_tpu/experiments/parity.py``.

Run: ``python -m vggp_tpu_torch.experiments.parity [--iters N] [--outdir D]
[--device cpu]``. Writes ``results/torch/parity/table.json`` + ``table.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np

METRIC_NAMES = ["mse", "mae", "rmse", "r2", "nlpd", "msll"]
ZOO = ["exactgp", "svgp", "vffgp", "asvgp", "griddedgp"]
COLUMN = "vggp_tpu_torch_f32"


def _metric_row(truth, mean, var, y_train):
    from vggp_tpu_torch.experiments import misc
    from vggp_tpu_torch.models.common import Gaussian

    g = Gaussian(mean=np.asarray(misc.host(mean), np.float64),
                 var=np.asarray(misc.host(var), np.float64))
    return misc.evaluation_metric_row(truth, g, misc.host(y_train))


def run(n_iters: int = 1000, lr: float = 0.01, sparsity: int = 3,
        outdir: str | None = None, svgp_m: int = 100, n_omegas: int = 5,
        exact_subsample: int = 4, device=None) -> Dict:
    """``exact_subsample``: the dense exact GP is fit on every k-th
    observation in BOTH columns — the torch oracle's O(n³) training pass
    costs seconds an iteration at the full n=4400 window (hours per fit; the
    reference's own notebooks only ever ran the exact model on smaller
    windows). The sparse zoo uses the full window."""
    import torch

    from vggp_tpu_torch import config, train
    from vggp_tpu_torch.experiments import torch_oracle, zoo
    from vggp_tpu_torch.experiments.configs import EXP_1_TEST, EXP_1_TRAIN
    from vggp_tpu_torch.experiments.loaders import load_gulf_stream_data
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.models import exact, freesvgp, sgpr

    device = config.resolve_device(device)
    out: Dict = {"config": {"n_iters": n_iters, "lr": lr, "sparsity": sparsity,
                            "svgp_m": svgp_m, "n_omegas": n_omegas,
                            "exact_subsample": exact_subsample,
                            "device": str(device)}, "splits": {}}

    for split, exp_dict in (("train", EXP_1_TRAIN), ("test", EXP_1_TEST)):
        # grid resolution is keyed to THIS split's config (gulfstream.py
        # semantics) — keying it to EXP_1_TRAIN would silently score the test
        # window on the train grid if the configs ever diverge
        n_splines = exp_dict["N_SPLINES"]
        grid_mesh = np.linspace(0.0, 1.0, n_splines + 1)
        grids = (CellIntegralFeature.from_lims(n_splines, 0.0, 1.0),
                 CellIntegralFeature.from_lims(n_splines, 0.0, 1.0))
        ds = load_gulf_stream_data("data/dc_obs", "data/dc_ref", exp_dict)
        X, y = ds.obs_train_data(sparsity)
        X, y = np.asarray(X, np.float64), np.asarray(y, np.float64).reshape(-1)
        truth = ds.grid_ref_data_simpson(n_splines)
        rows: Dict = {}

        def model_data(name):
            if name == "exactgp":
                return X[::exact_subsample], y[::exact_subsample]
            return X, y

        # ---- reference-style torch f64 column (CPU) -------------------------
        for name in ZOO:
            Xm, ym = model_data(name)
            t0 = time.time()
            (mean, var), losses, hyps = torch_oracle.fit(
                name, Xm, ym, grid_mesh, n_splines, n_iters=n_iters, lr=lr,
                m_svgp=svgp_m, n_omegas=n_omegas)
            wall = time.time() - t0
            rows.setdefault(name, {})["reference_f64_cpu"] = {
                "metrics": dict(zip(METRIC_NAMES, _metric_row(truth, mean, var, ym))),
                "steps_per_sec": round(n_iters / wall, 2),
                "final_loss": losses[-1],
                "hyps": hyps,
            }
            print(f"[torch] {split}/{name}: {n_iters / wall:.1f} it/s "
                  f"rmse={rows[name]['reference_f64_cpu']['metrics']['rmse']:.5f}",
                  flush=True)

        # ---- the port's column (float32 on `device`) ------------------------
        # (zoo's per-axis-PointFeature "svgp" SGPR is not the parity model —
        # the reference's SVGP has FREE 2-D inducing points, so the branch
        # below uses FreeSVGPSpec; drop the zoo entry to keep specs honest)
        specs = {"exactgp": (zoo.exact_spec(2), exact)}
        specs.update({k: (v, sgpr) for k, v in zoo.sgpr_specs_2d(
            n_inducing=10, n_frequencies=n_omegas, n_knots=n_splines,
            n_cells=n_splines).items() if k != "svgp"})
        specs["svgp"] = (freesvgp.FreeSVGPSpec(kinds=("matern12", "matern12"), m=svgp_m),
                         freesvgp)
        for name in ZOO:
            Xm, ym = model_data(name)
            Xj = torch.as_tensor(Xm, dtype=torch.float32, device=device)
            yj = torch.as_tensor(ym, dtype=torch.float32, device=device)
            spec, mod = specs[name]
            # fit TWICE: the first call pays the CUDA context and the kernel
            # loads (the torch column has no analogue), the second measures
            # the steady-state rate; completion is forced by reading the
            # final loss before the clock stops (an asynchronous launch
            # queue otherwise ends the timer early). q(v) prediction stays
            # outside the timed window (the torch wall includes its single
            # prediction pass — ≤0.1% of the 1000 training passes it spans).
            p_init = (spec.init_params(torch.float32, device, seed=0) if name == "svgp"
                      else spec.init_params(torch.float32, device))
            p0 = train.non_informative_init(p_init, Xj, yj)
            fit = lambda s=spec, m=mod: train.fit(
                lambda q: m.loss(s, q, Xj, yj), p0, n_iters, lr)
            p_fit, hist = fit()                              # warm-up
            float(hist["loss"][-1])
            t0 = time.time()
            p_fit, hist = fit()
            final_loss = float(hist["loss"][-1])             # force completion
            wall = time.time() - t0
            with torch.no_grad():
                qv = mod.q_v(spec, p_fit, Xj, yj, grids, full_cov=False)
            rows[name][COLUMN] = {
                "metrics": dict(zip(METRIC_NAMES,
                                    _metric_row(truth, qv.mean, qv.var, ym))),
                "steps_per_sec": round(n_iters / wall, 2),
                "final_loss": final_loss,
            }
            print(f"[port ] {split}/{name}: {n_iters / wall:.1f} it/s "
                  f"rmse={rows[name][COLUMN]['metrics']['rmse']:.5f}",
                  flush=True)
        out["splits"][split] = {"n_obs": int(X.shape[0]), "models": rows}

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "table.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        with open(os.path.join(outdir, "table.md"), "w") as fh:
            fh.write(_markdown(out))
    return out


def _markdown(out: Dict) -> str:
    device = out["config"].get("device", "cuda")
    lines = [f"# Parity: reference-style torch f64 (CPU) vs {COLUMN} ({device})",
             "", f"config: {json.dumps(out['config'])}", ""]
    for split, rec in out["splits"].items():
        lines += [f"## {split} window (n = {rec['n_obs']})", "",
                  "| model | impl | rmse | r2 | nlpd | msll | it/s |",
                  "|---|---|---|---|---|---|---|"]
        for name, impls in rec["models"].items():
            for impl, r in impls.items():
                m = r["metrics"]
                lines.append(
                    f"| {name} | {impl} | {m['rmse']:.6f} | {m['r2']:.4f} | "
                    f"{m['nlpd']:+.3f} | {m['msll']:+.3f} | {r['steps_per_sec']} |")
        lines.append("")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--outdir", default="results/torch/parity")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    run(n_iters=args.iters, outdir=args.outdir, device=args.device)


if __name__ == "__main__":
    main()
