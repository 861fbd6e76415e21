"""3-D space-time gridded products: lon × lat × time Kronecker SVGP.

A traveling-wave SSH field is observed along satellite-style diagonal
passes, each pass at its own time; a 3-axis Kronecker-factored SVGP with
Matérn-1/2 cell-integral features then produces a gridded (lon, lat, time)
data product q(v) — per-cell integrals with uncertainty — validated against
the field's analytic cell integrals. Each training step runs the
``cell_kuf_with_dl`` kernel once per axis.

The port of ``vggp_tpu/experiments/spacetime.py``; it runs on ``cuda``
unless ``device`` names another device. Its results also hold the (g, g, g)
q(v) mean and variance (``qv_mean``, ``qv_var``).

Run: ``python -m vggp_tpu_torch.experiments.spacetime [--iters N] [--outdir D]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from vggp_tpu_torch import config, train
from vggp_tpu_torch.experiments import misc, plotting
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import svgp

# f(x, y, t) = sin(3x − 1.5t)·cos(2y) + 0.5·sin(2x)·sin(1.5y + t), expanded
# into separable (coef, (fn, freq) per axis) terms via angle addition.
_TERMS: List[Tuple[float, Tuple[str, float], Tuple[str, float], Tuple[str, float]]] = [
    (1.0, ("sin", 3.0), ("cos", 2.0), ("cos", 1.5)),
    (-1.0, ("cos", 3.0), ("cos", 2.0), ("sin", 1.5)),
    (0.5, ("sin", 2.0), ("sin", 1.5), ("cos", 1.0)),
    (0.5, ("sin", 2.0), ("cos", 1.5), ("sin", 1.0)),
]


def field(x: np.ndarray, y: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = 0.0
    for coef, (fx, ax), (fy, ay), (ft, at) in _TERMS:
        out = out + coef * (getattr(np, fx)(ax * x)
                            * getattr(np, fy)(ay * y)
                            * getattr(np, ft)(at * t))
    return out


def _axis_integrals(fn: str, freq: float, mesh: np.ndarray) -> np.ndarray:
    """Exact ∫_cell sin/cos(freq·s) ds per cell of ``mesh``."""
    lo, hi = mesh[:-1], mesh[1:]
    if fn == "sin":
        return (np.cos(freq * lo) - np.cos(freq * hi)) / freq
    return (np.sin(freq * hi) - np.sin(freq * lo)) / freq


def truth_integrals(meshes: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> np.ndarray:
    """(g1, g2, g3) exact triple cell integrals of the field."""
    out = 0.0
    for coef, tx, ty, tt in _TERMS:
        ix = _axis_integrals(*tx, meshes[0])
        iy = _axis_integrals(*ty, meshes[1])
        it = _axis_integrals(*tt, meshes[2])
        out = out + coef * ix[:, None, None] * iy[None, :, None] * it[None, None, :]
    return out


def generate_passes(
    n_passes: int = 48,
    points_per_pass: int = 160,
    noise: float = 0.05,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Satellite-style diagonal ground tracks, one time slice per pass.

    Each pass k crosses the unit square diagonally (alternating ascending /
    descending, random intercept) at time t_k ∈ (0, 1), with a small
    along-track time drift (a real altimeter sweeps, it does not snapshot).
    """
    rng = np.random.default_rng(seed)
    xs, ys, ts, vals = [], [], [], []
    for k in range(n_passes):
        s = np.linspace(0.0, 1.0, points_per_pass)
        c = rng.uniform(-0.6, 0.6)
        if k % 2 == 0:
            x, y = s, np.clip(s + c, 0.0, 1.0)
        else:
            x, y = s, np.clip(1.0 - s + c, 0.0, 1.0)
        keep = (y > 0.0) & (y < 1.0)
        t = (k + 0.5) / n_passes + 0.02 * (s - 0.5)
        xs.append(x[keep]); ys.append(y[keep]); ts.append(np.clip(t[keep], 0, 1))
        vals.append(field(x[keep], y[keep], np.clip(t[keep], 0, 1)))
    X = np.stack([np.concatenate(xs), np.concatenate(ys), np.concatenate(ts)], axis=1)
    y = np.concatenate(vals) + noise * rng.standard_normal(X.shape[0])
    return X, y


def run(
    m_side: int = 32,
    n_grid: int = 8,
    n_iters: int = 1500,
    batch_size: int = 1024,
    learning_rate: float = 0.02,
    noise: float = 0.05,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    X, y = generate_passes(noise=noise, seed=seed)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)

    feats = tuple(CellIntegralFeature.from_lims(m_side, 0.0, 1.0) for _ in range(3))
    spec = svgp.SVGPSpec(kinds=("matern12",) * 3, features=feats,
                         num_data=X.shape[0], variational="kron")
    p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)

    p_fit, hist, final_loss, wall = misc.timed_fit_minibatch(
        lambda q, xb, yb: svgp.loss(spec, q, xb, yb), p0, Xt, yt,
        n_iters, batch_size, learning_rate, seed)

    grids = tuple(CellIntegralFeature.from_lims(n_grid, 0.0, 1.0) for _ in range(3))
    with torch.no_grad():
        qv = svgp.q_v(spec, p_fit, grids, full_cov=False)
    truth = truth_integrals(tuple(g.mesh for g in grids))

    mean3 = misc.host(qv.mean).reshape(n_grid, n_grid, n_grid)
    metrics = misc.evaluation_metric_row(truth, qv, y)
    results: Dict = {
        "final_loss": final_loss,
        "steps_per_sec": n_iters / wall,
        "qv_max_err": float(np.abs(mean3 - truth).max()),
        "metrics": metrics,
        "n_obs": int(X.shape[0]),
        "m_total": int(m_side) ** 3,
        "qv_mean": mean3,
        "qv_var": misc.host(qv.variance()).reshape(n_grid, n_grid, n_grid),
    }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        table = dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], metrics),
                     steps_per_sec=round(results["steps_per_sec"], 1),
                     qv_max_err=results["qv_max_err"],
                     n_obs=results["n_obs"], m_total=results["m_total"])
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(table, fh, indent=2)
        k = n_grid // 2
        plotting.plot_grid_heatmaps(
            {"truth (t-slice)": truth[:, :, k], "q(v) mean (t-slice)": mean3[:, :, k]},
            title=f"space-time gridded product, time cell {k}",
            path=os.path.join(outdir, "qv_tslice.png"))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--outdir", default="results/torch/spacetime")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    r = run(n_iters=args.iters, outdir=args.outdir, device=args.device)
    m = dict(zip(["mse", "mae", "rmse", "r2", "nlpd", "msll"], r["metrics"]))
    print(f"spacetime 3-D gridded SVGP: n={r['n_obs']} m={r['m_total']} "
          f"it/s={r['steps_per_sec']:.0f} loss={r['final_loss']:+.1f}")
    print(f"  qv_max_err={r['qv_max_err']:.4f} r2={m['r2']:.3f} "
          f"nlpd={m['nlpd']:+.2f} msll={m['msll']:+.2f}")


if __name__ == "__main__":
    main()
