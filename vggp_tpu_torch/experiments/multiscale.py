"""Multi-scale decomposition: sum-of-kernels GP separating scales.

An SSH-like 1-D transect is a LARGE-SCALE signal (basin gyre, ℓ ~ 0.5) plus
a MESOSCALE eddy field (ℓ ~ 0.04) plus noise. One sum-of-separable-kernels
GP (``models/sum.py``) with a long-ℓ component on a coarse inducing mesh and
a short-ℓ component on a fine mesh (lengthscales fixed per band — free
lengthscales make the attribution unidentifiable; ``train.fit(trainable=...)``)
recovers BOTH fields separately with per-component uncertainty. The control
is a single-kernel GP: same total fit, no decomposition.

The port of ``vggp_tpu/experiments/multiscale.py``; it runs on ``cuda``
unless ``device`` names another device. Its results also hold the sum
model's fit's steps a second.

Run: ``python -m vggp_tpu_torch.experiments.multiscale [--iters N] [--outdir D]
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
from vggp_tpu_torch.experiments import misc
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import sgpr
from vggp_tpu_torch.models import sum as msum


def _slow(x):
    return np.sin(2.0 * x) + 0.4 * np.cos(3.0 * x)


def _fast(x):
    return 0.3 * np.sin(25.0 * x) + 0.15 * np.cos(41.0 * x)


def run(
    n: int = 400,
    noise_sd: float = 0.03,
    n_iters: int = 800,
    learning_rate: float = 0.03,
    seed: int = 0,
    outdir: str | None = None,
    device=None,
) -> Dict:
    device = config.resolve_device(device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, n))
    y = _slow(x) + _fast(x) + noise_sd * rng.standard_normal(n)
    X, Y = as_f32(x), as_f32(y)

    c_slow = sgpr.SGPRSpec(kinds=("matern32",),
                           features=(CellIntegralFeature(mesh=np.linspace(0, 1, 9)),))
    c_fast = sgpr.SGPRSpec(kinds=("matern32",),
                           features=(CellIntegralFeature(mesh=np.linspace(0, 1, 49)),))
    spec = msum.SumSGPRSpec(components=(c_slow, c_fast))
    p = spec.init_params(torch.float32, device)
    p["components"][0]["axes"][0]["lengthscale"] = f32(0.5)
    p["components"][1]["axes"][0]["lengthscale"] = f32(0.04)
    p["components"][1]["axes"][0]["variance"] = f32(0.1)
    p["noise"] = f32(0.01)
    mask = dict(train.tree_map(lambda _: True, p))
    mask["components"] = tuple(
        {"axes": tuple(dict(ax, lengthscale=False) for ax in comp["axes"])}
        for comp in mask["components"])
    p_fit, _, final_loss, wall = misc.timed_fit(
        lambda q: msum.loss(spec, q, X, Y), p, n_iters, learning_rate,
        trainable=lambda _: mask)

    # control: one kernel, fine mesh, free lengthscale
    c_one = sgpr.SGPRSpec(kinds=("matern32",),
                          features=(CellIntegralFeature(mesh=np.linspace(0, 1, 49)),))
    p1 = train.non_informative_init(c_one.init_params(torch.float32, device), X, Y)
    p1_fit, _ = train.fit(lambda q: sgpr.loss(c_one, q, X, Y), p1, n_iters, learning_rate)

    xs = np.linspace(0.02, 0.98, 200)
    with torch.no_grad():
        st = msum.precompute(spec, p_fit, X, Y)
        g = msum.posterior_from_state(spec, p_fit, st, as_f32(xs))
        g_slow = msum.component_posterior(spec, p_fit, st, as_f32(xs), 0)
        g_fast = msum.component_posterior(spec, p_fit, st, as_f32(xs), 1)
        g1 = sgpr.posterior(c_one, p1_fit, X, Y, as_f32(xs), full_cov=False)

    def _rmse(m, t):
        return float(np.sqrt(np.mean((misc.host(m) - t) ** 2)))

    total_truth = _slow(xs) + _fast(xs)
    results = {
        "n": n,
        "final_loss": final_loss,
        "total_rmse_sum_model": _rmse(g.mean, total_truth),
        "total_rmse_single_kernel": _rmse(g1.mean, total_truth),
        "slow_component_rmse": _rmse(g_slow.mean, _slow(xs)),
        "fast_component_rmse": _rmse(g_fast.mean, _fast(xs)),
        "slow_scale": float(np.std(_slow(xs))),
        "fast_scale": float(np.std(_fast(xs))),
        "component_vars": [
            float(p_fit["components"][q]["axes"][0]["variance"])
            for q in range(2)],
        "steps_per_sec": n_iters / wall,
    }

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(results, f, indent=1)
        try:
            from vggp_tpu_torch.experiments import plotting

            plotting.plot_posterior_1d(
                x, y, xs, misc.host(g_slow.mean), misc.host(g_slow.stddev()),
                truth_fn=_slow, title="large-scale component",
                path=os.path.join(outdir, "slow_component.png"))
            plotting.plot_posterior_1d(
                x, y, xs, misc.host(g_fast.mean), misc.host(g_fast.stddev()),
                truth_fn=_fast, title="mesoscale component",
                path=os.path.join(outdir, "fast_component.png"))
        except ImportError:
            pass
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--outdir", default="results/torch/multiscale")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    r = run(n_iters=args.iters, outdir=args.outdir, device=args.device)
    print(f"total rmse: sum-model {r['total_rmse_sum_model']:.4f} vs "
          f"single-kernel {r['total_rmse_single_kernel']:.4f}")
    print(f"scale attribution rmse: slow {r['slow_component_rmse']:.4f} "
          f"(signal sd {r['slow_scale']:.3f}), fast "
          f"{r['fast_component_rmse']:.4f} (signal sd {r['fast_scale']:.3f})")


if __name__ == "__main__":
    main()
