"""Classify the experiments' learned-inducing-point members whose float32
results the card and the CPU do not share (ROADMAP queue 3, item 19), on
the CPU.

Each case is fitted twice in float32 on the CPU from the same start: on the
experiment's inputs X, and on X moved by one float32 ulp. If the fits part
by about as much as the card and the CPU do after 5 steps, and agree after
one step, the gap is set by roundoff in the trajectory, not by the
arithmetic of either device. The cases:

- the free-point SVGP of ``experiments.gulfstream``'s CV sweep at m = 50,
  200 and 300 (the train window at sparsity 3, lr 0.1, z from the sweep's
  seed), its metric row and final loss;
- the zoo's point SVGP of ``experiments.univariate`` (15 points, lr 0.05),
  its final loss and q(v) mean, and the distance between its closest
  inducing points after the first step;
- ``run_orders``' point SVGP of each Matérn order (40 points, lr 0.05): the
  same 1-ulp gap, and its float32 metric row against float64's.

With ``--jax`` the JAX package's own univariate point SVGP is fitted in
float32 and float64 from the same start (x64 on), its final losses printed.

    python tools/torch_experiments_roundoff.py [--steps 5] [--jax]

About 20 s here (the JAX part about 15 s more).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CV_ZS = [10, 30, 50, 100, 150, 200, 250, 300, 350, 400, 450, 500]  # gulfstream.py's sweep


def gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def one_ulp(a: np.ndarray) -> np.ndarray:
    a32 = np.asarray(a, np.float32)
    return np.nextafter(a32, np.float32(np.inf)).astype(np.float64)


def free_points(X, y, truth, m: int, steps: int):
    from vggp_tpu_torch import train
    from vggp_tpu_torch.experiments import misc
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.models import freesvgp

    Xt = torch.as_tensor(X, dtype=torch.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    spec = freesvgp.FreeSVGPSpec(kinds=("matern12", "matern12"), m=m)
    p0 = train.non_informative_init(
        spec.init_params(torch.float32, "cpu", seed=CV_ZS.index(m)), Xt, yt)
    p, hist = train.fit(lambda q: freesvgp.loss(spec, q, Xt, yt), p0, steps, 0.1)
    grids = (CellIntegralFeature.from_lims(20, 0.0, 1.0),) * 2
    with torch.no_grad():
        qv = freesvgp.q_v(spec, p, Xt, yt, grids, full_cov=False)
    return np.asarray(misc.evaluation_metric_row(truth, qv, yt)), float(hist["loss"][-1])


def point_svgp(X, y, steps: int, kind="matern12", dtype=torch.float32):
    """(final loss, q(v) mean, metric row, closest inducing points' gap)."""
    from vggp_tpu_torch import train
    from vggp_tpu_torch.experiments import misc, zoo
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.models import sgpr
    from vggp_tpu_torch.utils import integrate_1d

    Xt = torch.as_tensor(X, dtype=dtype)
    yt = torch.as_tensor(y, dtype=dtype)
    spec = zoo.sgpr_specs_1d_orders(kind)["svgp"]
    p0 = train.non_informative_init(spec.init_params(dtype, "cpu"), Xt, yt)
    p, hist = train.fit(lambda q: sgpr.loss(spec, q, Xt, yt), p0, steps, 0.05)
    grid = CellIntegralFeature.from_lims(10, 0.0, 1.0)
    with torch.no_grad():
        qv = sgpr.q_v(spec, p, Xt, yt, (grid,), full_cov=False)
    truth, _ = integrate_1d(lambda x: np.sin(2 * x) + np.cos(5 * x), grid.mesh)
    z = np.sort(p["axes"][0]["z"].numpy())
    return (float(hist["loss"][-1]), qv.mean.numpy(),
            np.asarray(misc.evaluation_metric_row(truth, qv, y)), float(np.diff(z).min()))


def univariate_data(n: int = 15):
    from vggp_tpu_torch.utils import gen_1d

    X, y_clean = gen_1d(lambda x: np.sin(2 * x) + np.cos(5 * x), 0.0, 1.0, n)
    return X, y_clean + 0.05 * np.random.default_rng(0).standard_normal(n)


def jax_float32_against_float64(steps: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from vggp_tpu import train as jtrain
    from vggp_tpu.experiments import zoo as jzoo
    from vggp_tpu.models import sgpr as jsgpr

    X, y = univariate_data()
    spec = jzoo.sgpr_specs_1d()["svgp"]
    losses = {}
    for dtype in (jnp.float32, jnp.float64):
        Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y, dtype)
        p0 = jtrain.non_informative_init(spec.init_params(dtype), Xj, yj)
        _, hist = jtrain.fit(lambda q: jsgpr.loss(spec, q, Xj, yj), p0, steps, 0.05)
        losses[jnp.dtype(dtype).name] = np.asarray(hist["loss"], np.float64)
    f32, f64 = losses["float32"], losses["float64"]
    print(f"JAX univariate point SVGP, {steps} steps: float32 losses {f32.tolist()}")
    print(f"  float64 losses {f64.tolist()}; final loss float32 vs float64 "
          f"{abs(f32[-1] - f64[-1]) / abs(f64[-1]):.3e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()

    from vggp_tpu_torch.experiments.configs import EXP_1_TRAIN
    from vggp_tpu_torch.experiments.loaders import load_gulf_stream_data

    ds = load_gulf_stream_data("data/dc_obs", "data/dc_ref", EXP_1_TRAIN)
    X, y = ds.obs_train_data(3)
    X, y = np.asarray(X, np.float64), np.asarray(y, np.float64).reshape(-1)
    truth = ds.grid_ref_data_simpson(EXP_1_TRAIN["N_SPLINES"])
    for m in (50, 200, 300):
        for steps in (args.steps, 1):
            row, loss = free_points(X, y, truth, m, steps)
            row_p, loss_p = free_points(one_ulp(X), y, truth, m, steps)
            print(f"free points m = {m}, {steps} step(s): X vs X + 1 ulp: metric row "
                  f"{gap(row_p, row):.3e}, final loss {abs(loss_p - loss) / abs(loss):.3e}")
    X1, y1 = univariate_data()
    for steps in (args.steps, 1):
        loss, mean, _, dz = point_svgp(X1, y1, steps)
        loss_p, mean_p, _, dz_p = point_svgp(one_ulp(X1), y1, steps)
        print(f"univariate point SVGP, {steps} step(s): X vs X + 1 ulp: final loss "
              f"{abs(loss_p - loss) / abs(loss):.3e}, q(v) mean {gap(mean_p, mean):.3e}; "
              f"closest inducing points {dz:.3e} apart ({dz_p:.3e})")
    X2, y2 = univariate_data(40)
    for kind in ("matern12", "matern32", "matern52"):
        for steps in (args.steps, 1):
            loss, _, row, dz = point_svgp(X2, y2, steps, kind)
            loss_p, _, row_p, _ = point_svgp(one_ulp(X2), y2, steps, kind)
            _, _, row64, _ = point_svgp(X2, y2, steps, kind, torch.float64)
            print(f"run_orders {kind} point SVGP, {steps} step(s): X vs X + 1 ulp: final "
                  f"loss {abs(loss_p - loss) / abs(loss):.3e}, metric row "
                  f"{gap(row_p, row):.3e}; float32 vs float64 metric row "
                  f"{gap(row, row64):.3e}; closest inducing points {dz:.3e} apart")
    if args.jax:
        jax_float32_against_float64(args.steps)


if __name__ == "__main__":
    main()
