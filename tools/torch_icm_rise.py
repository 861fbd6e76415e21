"""Classify the ICM SVGP's rising minibatch loss at batch 16 384 (ROADMAP
queue 3, item 17) on the CPU: the JAX package and the port take the same
batches from the same start.

The model is ``chip_smoke.icm_svgp_spec()``'s (512×512 Matérn-1/2 cells ×
2 outputs, the Kronecker family, a noise level and a mean per output) on
``chip_smoke.make_data_multioutput``'s 1 000 000 two-output points. As
phase 12a runs it: ``--steps`` Adam steps at batch 4096, then ``--big-steps``
at 16 384 with a fresh Adam, lr 1e-2, in float32 and float64. The batches
are drawn once from a numpy generator and fed to both packages, which
start from JAX's ``init_params``. If both packages' losses rise at 16 384,
the rise is the model's; if only the port's does, it is the port's.

    JAX_PLATFORMS=cpu python tools/torch_icm_rise.py [--steps 8] [--big-steps 4]

About 6 minutes on 8 CPU cores (both packages, both precisions). Prints
each run's losses, one line a run, and the largest relative gap between
the packages' losses step by step.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--big-steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-2)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    import chip_smoke as cs
    from vggp_tpu import features as jfeatures
    from vggp_tpu import train as jtrain
    from vggp_tpu.models import svgp as jsvgp
    from vggp_tpu_torch import convert, svgp, train

    X32, y32, _ = cs.make_data_multioutput(torch.device("cpu"))
    spec = cs.icm_svgp_spec()
    jspec = jsvgp.SVGPSpec(kinds=spec.kinds, num_data=spec.num_data, variational="kron",
                           per_output_noise=True, learn_mean=True,
                           features=(jfeatures.CellIntegralFeature.from_lims(cs.M_AXIS, 0.0, 1.0),
                                     jfeatures.CellIntegralFeature.from_lims(cs.M_AXIS, 0.0, 1.0),
                                     jfeatures.OutputFeature(n_outputs=2)))
    rng = np.random.default_rng(17)
    runs = ((cs.TRAIN_BATCH, args.steps), (cs.FUSED_BATCH, args.big_steps))
    batches = [[rng.integers(0, cs.NUM_DATA, b) for _ in range(k)] for b, k in runs]
    out = {}
    for dtype in ("float32", "float64"):
        Xn, yn = X32.double().numpy(), y32.double().numpy()
        p0 = jax.tree.map(np.asarray, jspec.init_params(getattr(jnp, dtype)))
        # JAX: make_step_fn over optax.adam, a fresh optimizer each run
        jloss = lambda p, xb, yb: jsvgp.loss(jspec, p, xb, yb)
        raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, p0))
        losses = []
        t0 = time.perf_counter()
        for run in batches:
            opt = optax.adam(args.lr)
            step, state = jtrain.make_step_fn(jloss, opt), opt.init(raw)
            for idx in run:
                raw, state, val = step(raw, state, jnp.asarray(Xn[idx], dtype),
                                       jnp.asarray(yn[idx], dtype))
                losses.append(float(val))
        out["jax", dtype] = losses
        print(f"jax {dtype}: {np.array(losses).round(1).tolist()} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        # the port: make_step_fn over torch.optim.Adam, a fresh optimizer each run
        tdt = getattr(torch, dtype)
        params = convert.params_from_jax(p0, device="cpu", dtype=tdt)
        tloss = lambda p, xb, yb: svgp.loss(spec, p, xb, yb)
        losses = []
        t0 = time.perf_counter()
        for run in batches:
            raw_t = train.raw_leaves_from(params)
            step = train.make_step_fn(tloss, raw_t,
                                      torch.optim.Adam(train.tree_leaves(raw_t), lr=args.lr))
            for idx in run:
                losses.append(float(step(torch.as_tensor(Xn[idx], dtype=tdt),
                                         torch.as_tensor(yn[idx], dtype=tdt))))
            with torch.no_grad():
                params = train.constrain(train.tree_map(lambda v: v.detach(), raw_t))
        out["port", dtype] = losses
        print(f"port {dtype}: {np.array(losses).round(1).tolist()} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    n4 = args.steps
    for key, losses in out.items():
        a = np.array(losses)
        print(f"{key[0]} {key[1]}: at 4096 {a[0]:.6g} -> {a[n4 - 1]:.6g}; at 16 384 "
              f"{a[n4]:.6g} -> {a[-1]:.6g} ({'rises' if a[-1] > a[n4] else 'falls'})")
    for dtype in ("float32", "float64"):
        j, t = np.array(out["jax", dtype]), np.array(out["port", dtype])
        print(f"{dtype}: the port's losses against JAX's, max rel {np.max(np.abs(t - j) / np.abs(j)):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
