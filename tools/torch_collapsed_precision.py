"""Where the float32 error of the collapsed GriddedGP's heads comes from, on one
CUDA card.

    python3 tools/torch_collapsed_precision.py

Fits chip_smoke.py's phase-10d model (Matérn-3/2 cells, 64×64, the first
65 536 points, SGPR_KIND_STEPS steps) and takes ``posterior_grad`` on axis 0
at the 4096 serving points from ``precompute`` states built in float32 with
one piece at a time taken another way, each against the card's float64:

- the port's state (its Gram B = I + AAᵀ accumulated in float64);
- B formed by cuBLAS's float32 product instead (as the JAX package forms
  it, in float32);
- that B with its Cholesky factor L_B taken on the CPU;
- the port's B with L_B taken on the CPU;
- the whole state on the CPU in float32.

It also prints the matmul flags in force and the error of the card's
float32 A·Aᵀ against float64 with TF32 off and on, and every gradient leaf
at SGPR_CUT_N points with the port as it is, with its B-block (L_B, c) or
its Kuu factor in float64, and on the CPU in float32; and does the same for
phase 7's Matérn-1/2 model's ``posterior``. The card's name and power limit
come first, a JSON object with the readings last. Imports torch and the port
only (no JAX).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the data, the fitted models, the bounds)


def _states(spec, params, X, y, device):
    """{variant: (params, state)} of float32 states with one piece swapped."""
    import torch

    from vggp_tpu_torch import sgpr
    from vggp_tpu_torch.config import matmul_precision
    from vggp_tpu_torch.ops.chol import safe_cholesky, tri_solve

    cpu = torch.device("cpu")
    cast = lambda dev: cs.cast_to(dev, torch.float32)
    p32 = cast(device)(params)
    with torch.no_grad():
        chols, A, LB, c = sgpr.precompute(spec, p32, cast(device)(X), cast(device)(y))
        sigma = torch.sqrt(p32["noise"])
        yr = cast(device)(y) / sigma

        def rebuild(B=None, LB_new=None):
            if LB_new is None:
                LB_new = safe_cholesky(B, 1e-12)
            with matmul_precision("high"):
                return chols, A, LB_new, tri_solve(LB_new, A @ yr)

        eye = torch.eye(A.shape[0], dtype=torch.float64, device=device)
        B64 = (eye + A.double() @ A.double().T).float()
        with matmul_precision("high"):
            B32 = torch.eye(A.shape[0], dtype=A.dtype, device=device) + A @ A.T
        lb_cpu = lambda B: safe_cholesky(B.cpu(), 1e-12).to(device)
        p_cpu = cast(cpu)(params)
        out = {"port": (p32, (chols, A, LB, c)),
               "B in f32": (p32, rebuild(B=B32)),
               "B in f32, L_B on cpu": (p32, rebuild(LB_new=lb_cpu(B32))),
               "L_B on cpu": (p32, rebuild(LB_new=lb_cpu(B64))),
               "cpu": (p_cpu, sgpr.precompute(spec, p_cpu, cast(cpu)(X), cast(cpu)(y)))}
    return out


def _gram_errors(A):
    """max|Δ|/max|ref| of the card's float32 A·Aᵀ against float64, TF32 off
    and on."""
    import torch

    from vggp_tpu_torch.config import matmul_precision

    with torch.no_grad():
        ref = A.double() @ A.double().T
        out = {}
        for prec in ("high", "default"):
            with matmul_precision(prec):
                g = A @ A.T
            out[prec] = float((g.double() - ref).abs().max() / ref.abs().max())
    return out


def probe(name, spec, params, X, y, head, device) -> dict:
    import torch

    from vggp_tpu_torch import sgpr

    with torch.no_grad():
        p64 = cs.cast_to(device, torch.float64)(params)
        st64 = sgpr.precompute(spec, p64, cs.cast_to(device, torch.float64)(X),
                               cs.cast_to(device, torch.float64)(y))
        ref = head(p64, st64, torch.float64, device)
        rows = {}
        for variant, (p, st) in _states(spec, params, X, y, device).items():
            dev = st[1].device
            rows[variant] = cs.gauss_err(head(p, st, torch.float32, dev), ref)
        rows["A·Aᵀ f32 vs f64"] = _gram_errors(
            sgpr.precompute(spec, cs.cast_to(device, torch.float32)(params),
                            cs.cast_to(device, torch.float32)(X),
                            cs.cast_to(device, torch.float32)(y))[1])
    print(f"{name}: " + "; ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in rows.items()))
    return rows


def _f64_factor_state(orig):
    """``common.factored_state`` with its B-block (L_B = chol(B), c) taken
    in float64 at the float32 jitter floor, the state cast back."""
    import torch

    from vggp_tpu_torch.models import common
    from vggp_tpu_torch.ops.chol import F32_MIN_JITTER, safe_cholesky, tri_solve

    def fs(spec, params, X, y, with_chols=True):
        y = y.reshape(-1)
        sigma = torch.sqrt(common.obs_noise(spec, params, X))
        chols = common.axis_chol_kuu(spec, params) if with_chols else None
        A = common.khatri_rao_all(common.axis_whitened_kuf_scalar(spec, params, X)) / sigma
        A64 = A.double()
        B = torch.eye(A.shape[0], dtype=torch.float64, device=A.device) + A64 @ A64.T
        LB = safe_cholesky(B, max(1e-12, F32_MIN_JITTER) if A.dtype != torch.float64 else 1e-12)
        c = tri_solve(LB, A64 @ (y / sigma).double())
        return chols, A, LB.to(A.dtype), c.to(A.dtype), y

    return fs


def _f64_finv(orig):
    """``common._finv_of_params`` taken in float64 and cast back."""
    def finv(feat, kind, rel_jitter, ell, var):
        fi, ratio = orig(feat, kind, rel_jitter, ell.double(), var.double())
        return fi.to(ell.dtype), (None if ratio is None else ratio.to(ell.dtype))

    return finv


def gradient_probe(spec, params, X, y, device) -> dict:
    """max|Δ|/max|ref| of each gradient leaf of the loss at (X, y) in float32
    on the card, the port as it is and with its B-block or its Kuu factor
    in float64, and on the CPU in float32, against the card's float64."""
    import contextlib
    from unittest import mock

    import torch

    from vggp_tpu_torch import sgpr
    from vggp_tpu_torch.models import common

    def leaves(dev, dt):
        c = cs.cast_to(dev, dt)
        return cs.value_and_grads(lambda q: sgpr.loss(spec, q, c(X), c(y)), c(params))[1]

    ref = leaves(device, torch.float64)
    variants = {
        "port": contextlib.nullcontext,
        "B-block in f64": lambda: mock.patch.object(
            common, "factored_state", _f64_factor_state(common.factored_state)),
        "Kuu factor in f64": lambda: mock.patch.object(
            common, "_finv_of_params", _f64_finv(common._finv_of_params)),
    }
    rows = {}
    for name, ctx in variants.items():
        with ctx():
            got = leaves(device, torch.float32)
        rows[name] = {k: cs.rel_err(got[k].double().cpu(), ref[k].double().cpu()) for k in ref}
    got = leaves(torch.device("cpu"), torch.float32)
    rows["cpu"] = {k: cs.rel_err(got[k].double(), ref[k].double().cpu()) for k in ref}
    for name, r in rows.items():
        print(f"  gradient {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    return rows


def main() -> int:
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, sgpr, train

    if not torch.cuda.is_available():
        print("torch_collapsed_precision: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__}; allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    device = torch.device("cuda")
    X, y, Xs = cs.make_data(device)
    Xn, yn = X[:cs.SGPR_N], y[:cs.SGPR_N]
    out = {"card": card}
    for kind, jitter, steps, head_name in (("matern32", cs.SLICE_JITTER, cs.SGPR_KIND_STEPS,
                                            "posterior_grad axis 0"),
                                           ("matern12", 1e-6, cs.SGPR_STEPS, "posterior")):
        spec = SGPRSpec(kinds=(kind,) * 2, features=tuple(
            CellIntegralFeature.from_lims(cs.SGPR_CELLS, 0.0, 1.0) for _ in range(2)),
            jitter=jitter)
        p0 = train.non_informative_init(spec.init_params(torch.float32), Xn, yn)
        params, _ = train.fit(lambda p: sgpr.loss(spec, p, Xn, yn), p0, steps, cs.FIT_LR)
        if head_name == "posterior":
            head = lambda p, st, dt, dev: sgpr.posterior_from_state(spec, p, st, Xs.to(dev, dt))
        else:
            head = lambda p, st, dt, dev: sgpr.posterior_grad_from_state(spec, p, st,
                                                                         Xs.to(dev, dt), 0)
        out[f"{kind} {head_name}"] = probe(f"{kind} {head_name}", spec, params, Xn, yn, head,
                                           device)
        out[f"{kind} gradient at n={cs.SGPR_CUT_N}"] = gradient_probe(
            spec, params, X[:cs.SGPR_CUT_N], y[:cs.SGPR_CUT_N], device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
