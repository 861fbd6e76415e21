"""Sequential mission assimilation: online gridded products without refits.

The whitened natural-parameter stream state (:mod:`vggp_tpu_torch.streaming`)
assimilates each satellite pass with ONE O(n·m²) update and re-emits the
gridded q(v) product — the state after pass k is exactly the optimal batch
posterior of passes 1..k.

The experiment simulates k altimetry passes (slanted ground tracks across a
two-scale SSH-like field), assimilates them sequentially, and records:

- the gridded-product RMSE/NLPD after every pass,
- proof of exactness: max |streamed q(v) − batch-SGPR q(v)| over the grid
  after the final pass,
- throughput of the assimilation scan (passes/s),
- a nonstationarity segment: the field drifts mid-stream, and exponential
  forgetting (ρ < 1) tracks the drifted field while the no-forgetting state
  stays anchored to stale data; then a hyperparameter refresh on the
  drifted window, carried over by ``reanchor``.

The port of ``vggp_tpu/experiments/streaming.py``; it runs on ``cuda`` unless
``device`` names another device.

Run: ``python -m vggp_tpu_torch.experiments.streaming [--outdir D] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, streaming, train
from vggp_tpu_torch.experiments import misc, plotting
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import sgpr, svgp


def field(x, y, phase: float = 0.0):
    """Two-scale SSH-like truth; ``phase`` shifts the meanders (drift)."""
    return (np.sin(3.0 * x + phase) * np.cos(2.0 * y)
            + 0.5 * np.sin(7.0 * x + 1.0 + 2.0 * phase) * np.cos(5.0 * y + 0.5))


def mission_pass(p: int, n_per_track: int, n_tracks: int, noise: float,
                 seed: int, phase: float = 0.0):
    """One altimetry pass: slanted ground tracks with per-pass offsets."""
    rng = np.random.default_rng(seed + 1000 * p)
    t = np.linspace(0.0, 1.0, n_per_track)
    xs, ys = [], []
    for k in range(n_tracks):
        off = rng.random()
        slope = 0.8 + 0.4 * rng.random()
        sgn = 1.0 if (k + p) % 2 == 0 else -1.0
        x = t
        y = np.mod(off + sgn * slope * t, 1.0)
        xs.append(x)
        ys.append(y)
    X = np.stack([np.concatenate(xs), np.concatenate(ys)], axis=-1)
    yv = field(X[:, 0], X[:, 1], phase) + noise * rng.standard_normal(len(X))
    return X.astype(np.float32), yv.astype(np.float32)


def truth_cell_means(n_cells: int, phase: float = 0.0) -> np.ndarray:
    nodes, wts = np.polynomial.legendre.leggauss(8)
    edges = np.linspace(0.0, 1.0, n_cells + 1)
    half = 0.5 * (edges[1:] - edges[:-1])
    mid = 0.5 * (edges[1:] + edges[:-1])
    xq = mid[:, None] + half[:, None] * nodes[None, :]
    wq = half[:, None] * wts[None, :]
    Fq = field(xq[:, :, None, None], xq[None, None, :, :], phase)
    cell_area = (1.0 / n_cells) ** 2
    return np.einsum("ip,jr,ipjr->ij", wq, wq, Fq).ravel() / cell_area


def _qv_metrics(qv_fn, pq, truth, cell_area):
    g = qv_fn(pq)
    mean = misc.host(g.mean) / cell_area
    var = misc.host(g.var) / cell_area**2
    err = mean - truth
    rmse = float(np.sqrt(np.mean(err**2)))
    nlpd = float(np.mean(0.5 * np.log(2 * np.pi * var) + err**2 / (2 * var)))
    return rmse, nlpd, float(np.sqrt(var).mean())


@torch.no_grad()
def _assimilation_wall(spec, p_full, Xst, yst, device) -> float:
    """Seconds of one assimilation scan over the stacked passes, after one
    warm-up scan; each scan ends when its state is read to the host."""
    for _ in range(2):
        t0 = time.time()
        out = streaming.assimilate_scan(
            spec, p_full, streaming.init_state(spec, torch.float32, device), Xst, yst)
        float(out["lam"][0, 0])
    return time.time() - t0


def run(
    m_side: int = 16,
    n_cells: int = 24,
    n_passes: int = 8,
    n_tracks: int = 6,
    n_per_track: int = 64,
    noise: float = 0.05,
    n_hyper_iters: int = 1500,
    drift_phase: float = 0.6,
    rho: float = 0.55,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_dev = lambda a: torch.as_tensor(a, device=device)
    feats = tuple(CellIntegralFeature.from_lims(m_side, 0.0, 1.0) for _ in range(2))
    spec = svgp.SVGPSpec(kinds=("matern32", "matern32"), features=feats,
                         num_data=n_passes * n_tracks * n_per_track,
                         variational="full")
    cspec = sgpr.SGPRSpec(kinds=("matern32", "matern32"), features=feats)

    passes = [mission_pass(p, n_per_track, n_tracks, noise, seed)
              for p in range(n_passes)]

    # hyperparameters: one collapsed-bound fit on the first two passes only
    X01 = as_dev(np.concatenate([passes[0][0], passes[1][0]]))
    y01 = as_dev(np.concatenate([passes[0][1], passes[1][1]]))
    p0 = train.non_informative_init(cspec.init_params(torch.float32, device), X01, y01)
    p_hyp, _, _, hyper_wall = misc.timed_fit(
        lambda q: sgpr.loss(cspec, q, X01, y01), p0, n_hyper_iters, 0.05)
    # the SVGP param dict shares the hyper leaves; add a placeholder q
    p_full = dict(spec.init_params(torch.float32, device))
    p_full["axes"] = p_hyp["axes"]
    p_full["noise"] = p_hyp["noise"]

    grid = tuple(CellIntegralFeature.from_lims(n_cells, 0.0, 1.0) for _ in range(2))
    cell_area = (1.0 / n_cells) ** 2
    truth = truth_cell_means(n_cells)

    # ---- sequential assimilation: one update per pass ----
    with torch.no_grad():
        assim = lambda s, xb, yb: streaming.assimilate(spec, p_full, s, xb, yb)
        topar = lambda s: streaming.to_params(spec, p_full, s)
        qv_fn = lambda p: svgp.q_v(spec, p, grid, full_cov=False)
        state = streaming.init_state(spec, torch.float32, device)
        per_pass = []
        for p, (Xp, yp) in enumerate(passes):
            state = assim(state, as_dev(Xp), as_dev(yp))
            rmse, nlpd, mstd = _qv_metrics(qv_fn, topar(state), truth, cell_area)
            per_pass.append({"pass": p + 1, "n_seen": int(state["n_seen"]),
                             "qv_rmse": rmse, "qv_nlpd": nlpd, "mean_std": mstd})

    # assimilation throughput: one scan over the stacked passes
    Xst = as_dev(np.stack([p[0] for p in passes]))
    yst = as_dev(np.stack([p[1] for p in passes]))
    stream_wall = _assimilation_wall(spec, p_full, Xst, yst, device)

    with torch.no_grad():
        # ---- exactness: streamed state == batch SGPR on all passes ----
        Xall = as_dev(np.concatenate([p[0] for p in passes]))
        yall = as_dev(np.concatenate([p[1] for p in passes]))
        qv_stream = qv_fn(topar(state))
        qv_batch = sgpr.q_v(cspec, p_hyp, Xall, yall, grid, full_cov=False)
        mean_gap = float(np.abs(misc.host(qv_stream.mean)
                                - misc.host(qv_batch.mean)).max()) / cell_area
        var_gap = float(np.abs(misc.host(qv_stream.var)
                               - misc.host(qv_batch.var)).max()) / cell_area**2

        # ---- nonstationarity: field drifts; forgetting tracks, anchor lags ----
        drift_passes = [mission_pass(n_passes + p, n_per_track, n_tracks, noise,
                                     seed, phase=drift_phase) for p in range(n_passes)]
        truth_d = truth_cell_means(n_cells, phase=drift_phase)
        s_forget, s_anchor = state, state
        for Xp, yp in drift_passes:
            s_forget = assim(streaming.forget(s_forget, rho), as_dev(Xp), as_dev(yp))
            s_anchor = assim(s_anchor, as_dev(Xp), as_dev(yp))
        rmse_f, nlpd_f, _ = _qv_metrics(qv_fn, topar(s_forget), truth_d, cell_area)
        rmse_a, nlpd_a, _ = _qv_metrics(qv_fn, topar(s_anchor), truth_d, cell_area)

    # ---- hyper refresh: refit on the drifted window, reanchor, compare ----
    # (the accumulated data information carries across the hyper change —
    # no replay of past passes)
    Xw = as_dev(np.concatenate([p[0] for p in drift_passes[-3:]]))
    yw = as_dev(np.concatenate([p[1] for p in drift_passes[-3:]]))
    p_re, _ = train.fit(lambda q: sgpr.loss(cspec, q, Xw, yw),
                        train.non_informative_init(
                            cspec.init_params(torch.float32, device), Xw, yw),
                        max(200, n_hyper_iters // 3), 0.05)
    p_full2 = dict(p_full)
    p_full2["axes"], p_full2["noise"] = p_re["axes"], p_re["noise"]
    with torch.no_grad():
        s_re = streaming.reanchor(spec, p_full, p_full2, s_forget)
        rmse_r, nlpd_r, _ = _qv_metrics(qv_fn, streaming.to_params(spec, p_full2, s_re),
                                        truth_d, cell_area)

    results: Dict = {
        "per_pass": per_pass,
        "stream_vs_batch_qv_mean_gap": mean_gap,
        "stream_vs_batch_qv_var_gap": var_gap,
        "hyper_fit_seconds": hyper_wall,
        "assimilation_passes_per_sec": n_passes / stream_wall,
        "m_total": m_side**2, "n_per_pass": n_tracks * n_per_track,
        "drift": {"phase": drift_phase, "rho": rho,
                  "rmse_forget": rmse_f, "rmse_anchored": rmse_a,
                  "nlpd_forget": nlpd_f, "nlpd_anchored": nlpd_a,
                  "rmse_reanchored": rmse_r, "nlpd_reanchored": nlpd_r},
    }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "metrics.json"), "w") as fh:
            json.dump(results, fh, indent=2)
        qv_grid = misc.host(qv_stream.mean).reshape(n_cells, n_cells) / cell_area
        plotting.plot_grid_heatmaps(
            {"streamed q(v) mean": qv_grid,
             "truth cell means": truth.reshape(n_cells, n_cells),
             "abs error": np.abs(qv_grid - truth.reshape(n_cells, n_cells))},
            title="streaming assimilation",
            path=os.path.join(outdir, "fields.png"))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="results/torch/streaming")
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--m-side", type=int, default=16)
    ap.add_argument("--hyper-iters", type=int, default=1500)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(n_passes=args.passes, m_side=args.m_side,
              n_hyper_iters=args.hyper_iters, outdir=args.outdir, device=args.device)
    print(json.dumps({k: v for k, v in res.items() if k != "per_pass"}, indent=2))
    for row in res["per_pass"]:
        print(row)


if __name__ == "__main__":
    main()
