"""Evidence-based kernel selection + honest (hyper-marginalized) intervals.

1. *Which kernel order does the data support?* Fit the exact GP at each
   Matérn order / RBF on data drawn from a KNOWN kernel and rank by the
   Laplace log evidence (``hyperpost.log_evidence_laplace``) — the evidence
   charges for hyperparameter complexity, unlike raw training loss.
2. *Do the error bars mean what they say?* On a small fitting window the
   hyperparameter posterior is wide, and plug-in predictive intervals
   under-cover. Compare plug-in vs Laplace-marginalized coverage on
   held-out points.

The port of ``vggp_tpu/experiments/evidence.py``; it runs on ``cuda`` unless
``device`` names another device, in float32 as the JAX package's production
run does (its Hessians too). Each kind's record also holds the fit's steps a
second. The marginalized draws come from a CPU
``torch.Generator`` seeded where the JAX run takes ``PRNGKey(seed + 3)``.

Run: ``python -m vggp_tpu_torch.experiments.evidence [--device cpu]``
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, hyperpost, train
from vggp_tpu_torch.experiments import misc
from vggp_tpu_torch.models import exact
from vggp_tpu_torch.utils import metrics

KINDS = ("matern12", "matern32", "matern52", "rbf")


def _host_gram(kind: str, x: np.ndarray, var: float, ell: float) -> np.ndarray:
    """Stationary Gram in host float64 (data generation must not depend on
    the device: a float32 Gram's ~1e-7 entry error makes the n = 400
    Cholesky fail and would make the drawn 'truth' device-dependent)."""
    r = np.abs(x[:, None] - x[None, :]) / ell
    if kind == "matern12":
        k = np.exp(-r)
    elif kind == "matern32":
        a = np.sqrt(3.0) * r
        k = (1.0 + a) * np.exp(-a)
    elif kind == "matern52":
        a = np.sqrt(5.0) * r
        k = (1.0 + a + a * a / 3.0) * np.exp(-a)
    elif kind == "rbf":
        k = np.exp(-0.5 * r * r)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return var * k


def _draw_gp_data(kind: str, n: int, noise_sd: float, seed: int,
                  ell: float = 0.2, var: float = 1.0):
    """Sample y = f + ε with f a GP path of the given kernel (host f64)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, n))
    K = _host_gram(kind, x, var, ell)
    L = np.linalg.cholesky(K + 1e-10 * np.eye(n))
    f = L @ rng.standard_normal(n)
    y = f + noise_sd * rng.standard_normal(n)
    return x, f, y


def run(
    gen_kind: str = "matern32",
    n_train: int = 200,  # smoothness discrimination m32-vs-m52 needs n ≳ 10²
    n_test: int = 200,
    noise_sd: float = 0.1,
    n_iters: int = 800,
    learning_rate: float = 0.05,
    n_marg_samples: int = 256,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    x, f_all, y = _draw_gp_data(gen_kind, n_train + n_test, noise_sd, seed)
    idx = np.random.default_rng(seed + 1).permutation(n_train + n_test)
    tr, te = np.sort(idx[:n_train]), np.sort(idx[n_train:])
    Xt, yt = as_f32(x[tr]), as_f32(y[tr])
    Xs, ys = as_f32(x[te]), as_f32(y[te])

    results: Dict = {"gen_kind": gen_kind, "n_train": n_train, "models": {}}
    for kind in KINDS:
        spec = exact.ExactGPSpec(kinds=(kind,))
        loss_fn = lambda p, s=spec: exact.loss(s, p, Xt, yt)
        p0 = train.non_informative_init(spec.init_params(torch.float32, device), Xt, yt)
        p_fit, _, final_loss, wall = misc.timed_fit(loss_fn, p0, n_iters, learning_rate)
        st = hyperpost.laplace(loss_fn, p_fit)
        with torch.no_grad():
            log_ev = float(hyperpost.log_evidence_laplace(loss_fn, p_fit, st))

        predict = lambda p, s=spec: exact.posterior_predictive(
            s, p, Xt, yt, Xs, full_cov=False)
        with torch.no_grad():
            plug = predict(p_fit)
            marg = hyperpost.predict_marginalized(
                predict, st, misc.generator(seed + 3), n_samples=n_marg_samples)

        def _cal(g):
            return {
                "nlpd": float(metrics.negative_log_predictive_density(
                    ys, g.mean, g.variance())),
                "crps": metrics.crps_gaussian(ys, g.mean, g.variance()),
                "coverage90": metrics.interval_coverage(
                    ys, g.mean, g.variance(), 0.90),
            }

        results["models"][kind] = {
            "final_loss": final_loss,
            "log_evidence": log_ev,
            "plugin": _cal(plug),
            "marginalized": _cal(marg),
            "steps_per_sec": n_iters / wall,
        }

    ranked = sorted(results["models"].items(),
                    key=lambda kv: -kv[1]["log_evidence"])
    results["evidence_ranking"] = [k for k, _ in ranked]

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "evidence.json"), "w") as fh:
            json.dump({k: v for k, v in results.items() if k != "models"}
                      | {"models": results["models"]}, fh, indent=2)
    return results


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--gen-kind", default="matern32")
    ap.add_argument("--outdir", default="results/torch/evidence")
    ap.add_argument("--n-train", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    res = run(gen_kind=args.gen_kind, n_train=args.n_train, outdir=args.outdir,
              device=args.device)
    print(f"data drawn from {res['gen_kind']}; evidence ranking: "
          f"{' > '.join(res['evidence_ranking'])}")
    for kind, r in res["models"].items():
        print(f"  {kind:9s} log-ev {r['log_evidence']:9.2f}  "
              f"plug-in cov90 {r['plugin']['coverage90']:.2f} "
              f"nlpd {r['plugin']['nlpd']:7.3f} | marginalized cov90 "
              f"{r['marginalized']['coverage90']:.2f} "
              f"nlpd {r['marginalized']['nlpd']:7.3f}")


if __name__ == "__main__":
    main()
