"""The float32 KMS-Woodbury PCG at the edge of its gates, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_cg_woodbury_f32.py [--ratios 300,512,540,579,600] [--jax]

A 1-D collapsed GriddedGP on 512 Matérn-1/2 cells (σ² 0.91, noise 0.114, the
values phase 4 trains to) and 4096 points. The JAX package's float32 gates
admit the KMS-Woodbury preconditioner only where u = δ/ℓ lies between the u
floor 5·√eps (1.73e-3) and 1/CG_KMS_MIN_STIFFNESS of its config (1.95e-3),
that is for ℓ/δ in [512, 579]; its float32 M⁻¹ breaks down there within a few
iterations, so the port's float32 runs Jacobi PCG. For each ℓ/δ of
``--ratios`` prints ``solve_w``'s preconditioner, iterations and its own
and its true relative residual (recomputed in float64), in float32 and
float64, and the same for the Woodbury PCG forced in float32; with
``--jax`` also the true residual of the JAX package's float32 solve.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, iterative
    from vggp_tpu_torch.ops.cg import pcg_solve

    ap = argparse.ArgumentParser()
    ap.add_argument("--ratios", default="300,512,540,579,600")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    m, n = 512, 4096
    rng = np.random.default_rng(0)
    x = rng.random(n)
    y = np.sin(6 * x) + 0.1 * rng.standard_normal(n)
    spec = SGPRSpec(kinds=("matern12",), features=(CellIntegralFeature.from_lims(m, 0.0, 1.0),))

    def params(ell, dtype):
        t = lambda v: torch.tensor(v, dtype=dtype)
        return {"axes": ({"variance": t(0.91), "lengthscale": t(ell)},), "noise": t(0.114)}

    x64, y64 = torch.as_tensor(x), torch.as_tensor(y)
    for ratio in (float(r) for r in args.ratios.split(",")):
        ell = ratio / m
        line = [f"ℓ/δ {ratio:g}:"]
        for dtype in (torch.float32, torch.float64):
            w, info = iterative.solve_w(spec, params(ell, dtype), x64.to(dtype), y64.to(dtype),
                                        return_info=True)
            true = float(iterative.relative_residual(spec, params(ell, torch.float64), x64, y64, w))
            line.append(f"{str(dtype)[6:]} {info['preconditioner']} {info['iterations']} "
                        f"iterations, rel {info['rel_resid']:.3e}, true {true:.3e};")
        p32, x32, y32 = params(ell, torch.float32), x64.float(), y64.float()
        blocks = iterative._kuf_blocks(spec, p32, x32)
        matvec = iterative._on_columns((m,), iterative._g_apply(spec, p32, blocks,
                                                                p32["noise"], None))
        precond = iterative._kms_woodbury_precond(spec, p32, blocks)
        w, k, rel = pcg_solve(matvec, iterative._kuf_v(blocks, y32)[:, None], precond,
                              return_info=True)
        true = float(iterative.relative_residual(spec, params(ell, torch.float64), x64, y64,
                                                 w[:, 0]))
        line.append(f"float32 kms-woodbury forced {int(k[0])} iterations, rel "
                    f"{float(rel[0]):.3e}, true {true:.3e};")
        if args.jax:
            import jax

            jax.config.update("jax_enable_x64", True)
            import jax.numpy as jnp

            from vggp_tpu.features import CellIntegralFeature as JaxCell
            from vggp_tpu.models import iterative as jit_
            from vggp_tpu.models import sgpr as jsgpr

            jspec = jsgpr.SGPRSpec(kinds=("matern12",), features=(JaxCell.from_lims(m, 0.0, 1.0),))
            f32 = lambda v: jnp.asarray(v, jnp.float32)
            pj = {"axes": ({"variance": f32(0.91), "lengthscale": f32(ell)},), "noise": f32(0.114)}
            wj = jax.jit(lambda p, a, b: jit_.solve_w(jspec, p, a, b))(pj, f32(x), f32(y))
            true = float(iterative.relative_residual(spec, params(ell, torch.float64), x64, y64,
                                                     torch.as_tensor(np.asarray(wj))))
            line.append(f"JAX float32 true {true:.3e}")
        print(" ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
