"""Float32 pathwise draws against float64, in the port and the JAX package.

    JAX_PLATFORMS=cpu python tools/torch_draws_f32.py [--cells 64] [--n 1024] [--ratios 40,300,550,600]

A 2-D collapsed GriddedGP on cells² Matérn-1/2 cells (σ² 0.911, noise 0.114,
the values phase 4 trains to) and n points of a numpy seed. For each ℓ/δ of
``--ratios`` draws 8 antithetic Matheron samples of the gridded product
(``pathwise_q_v_samples``, 512 features) in float32 and float64 in both
packages, all from one numpy table of prior paths and ε (each package's draw
functions patched to read it, cast to each dtype), and prints each
package's float32 distance from its float64, draw by draw and in the
variances, the two float64s' distance, and the port's float32 against the
JAX package's. CPU only.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax
    import numpy as np
    import torch

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from vggp_tpu import sampling as jsampling
    from vggp_tpu.features import CellIntegralFeature as JaxCell
    from vggp_tpu.models import iterative as jit_
    from vggp_tpu.models import sgpr as jsgpr
    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, iterative, sampling

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=64)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--ratios", default="40,300,550,600")
    args = ap.parse_args()
    m, n, S, F = args.cells, args.n, 8, 512
    rng = np.random.default_rng(0)
    X = rng.random((n, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(n)
    t1 = rng.standard_t(1.0, size=(S // 2, 2, F))          # matern12: df 2ν = 1
    ph = rng.random((S // 2, F)) * 2 * np.pi
    eps = rng.standard_normal((S // 2, n))
    amp = np.sqrt(2 * 0.911 ** 2 / F)
    key = jax.random.PRNGKey(0)
    k1, k2 = (jnp.stack([jax.random.split(k)[i] for k in jax.random.split(key, S // 2)])
              for i in (0, 1))
    real_normal = jax.random.normal
    lane = lambda k, ks: jnp.argmax(jnp.all(k == ks, axis=-1))

    def jax_run(dt, ell):
        om = t1 / ell
        jsampling.prior_paths = lambda k, spec, params, nf: (
            jnp.asarray(om, dt)[lane(k, k1)], jnp.asarray(ph, dt)[lane(k, k1)],
            jnp.asarray(amp, dt))
        jax.random.normal = lambda k, shape=(), dtype=float: (
            jnp.asarray(eps)[lane(k, k2)].astype(dtype) if tuple(shape) == (n,)
            else real_normal(k, shape, dtype))
        spec = jsgpr.SGPRSpec(kinds=("matern12",) * 2,
                              features=tuple(JaxCell.from_lims(m, 0.0, 1.0) for _ in range(2)))
        c = lambda a: jnp.asarray(a, dt)
        p = {"axes": tuple({"variance": c(0.911), "lengthscale": c(ell)} for _ in range(2)),
             "noise": c(0.114)}
        try:
            return np.asarray(jax.jit(lambda p, X, y: jit_.pathwise_q_v_samples(
                spec, p, X, y, spec.features, key, n_samples=S, n_features=F,
                antithetic=True))(p, c(X), c(y)), np.float64)
        finally:
            jax.random.normal = real_normal

    def port_run(dt, ell):
        om = t1 / ell
        rows, eps_rows = iter(range(S // 2)), iter(range(S // 2))
        c = lambda a: torch.as_tensor(a, dtype=dt)
        sampling.prior_paths = lambda gen, spec, params, nf: (
            lambda j: (c(om[j]), c(ph[j]), c(amp)))(next(rows))
        sampling.normal = lambda gen, shape, like: c(eps[next(eps_rows)])
        spec = SGPRSpec(kinds=("matern12",) * 2,
                        features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0)
                                       for _ in range(2)))
        p = {"axes": tuple({"variance": c(0.911), "lengthscale": c(ell)} for _ in range(2)),
             "noise": c(0.114)}
        with torch.no_grad():
            return iterative.pathwise_q_v_samples(
                spec, p, c(X), c(y), spec.features, torch.Generator(), n_samples=S,
                n_features=F, antithetic=True).double().numpy()

    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    for ratio in (float(r) for r in args.ratios.split(",")):
        ell = ratio / m
        j64, j32 = jax_run(jnp.float64, ell), jax_run(jnp.float32, ell)
        t64, t32 = port_run(torch.float64, ell), port_run(torch.float32, ell)
        print(f"{m}² cells, n = {n}, ℓ/δ {ratio:g}: float32 vs float64 JAX {rel(j32, j64):.3e} "
              f"(variances {rel(j32.var(0), j64.var(0)):.3e}), port {rel(t32, t64):.3e} "
              f"(variances {rel(t32.var(0), t64.var(0)):.3e}); float64 port vs JAX "
              f"{rel(t64, j64):.3e}; float32 port vs JAX {rel(t32, j32):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
