"""Where the float32 error of the point-feature SVGP's gradient leaves comes
from, on one CUDA card.

    python3 tools/torch_points_precision.py

Trains chip_smoke.py's phase-11c model (the 1-D full-family SVGP on 512
learnable Matérn-3/2 inducing points, 8 Adam steps at batch 4096, the same
seeds) and takes the loss and every gradient leaf at the first 4096 points
in float32 with one piece at a time taken in float64, each against the
CPU's float64:

- the port as it is, on the card and on the CPU;
- the q(f) moments (Lᵀa forward, a·dtᵀ over the batch and L·dt backward)
  in float64;
- the Kuu Cholesky factor in float64 (cast back to float32);
- the whitening F⁻¹·Kuf in float64 (the factor too);
- all three.

Then it holds the whole of phase 11c's comparison (the loss, every leaf and
the four heads) under planted faults, by chip_smoke.py's own rule (the
larger of the floor and CPU_ERR_RATIO times the CPU's float32 error): the
whitening apply in TF32, the ℓ-tangent and moments' backward in TF32
(``tools/torch_grad_control.py``'s "gradients TF32") and every model product
in TF32. Each control lists the quantities that fail at 11c's floors
(``TOL_GRAD_FULL["points"]``, ``POINTS_HEAD_FLOOR``) and at the cell SVGPs'
(``TOL_GRAD_FULL["svgp"]``, ``TOL_E2E_POST``).

The card's name and power limit come first, a JSON object with the
readings last. Imports torch and the port only (no JAX).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the data, the model, the helpers)
import torch_grad_control as gc  # noqa: E402  (the TF32 controls)


@contextlib.contextmanager
def tf32_whitening():
    """The whitening apply F⁻¹·Kuf's forward in TF32."""
    from vggp_tpu_torch import config

    old, config.WHITEN_MATMUL_PRECISION = config.WHITEN_MATMUL_PRECISION, "default"
    try:
        yield
    finally:
        config.WHITEN_MATMUL_PRECISION = old


CONTROLS = (("sound", contextlib.nullcontext), ("whitening TF32", tf32_whitening),
            ("gradients TF32", lambda: gc.tf32_gradients(moments=True)),
            ("model TF32", gc.tf32_model))


def controls(spec, params, xb, yb, heads, device) -> list:
    """11c's comparison under each of CONTROLS: every quantity's error on the
    card against the CPU's float64, and the quantities that fail at 11c's
    floors and at the cell SVGPs'."""
    import torch

    q = lambda dev, dt: cs.svgp_slice_quantities(spec, params, xb, yb, heads,
                                                 cs.cast_to(dev, dt))
    cpu = torch.device("cpu")
    ref, f32 = q(cpu, torch.float64), q(cpu, torch.float32)
    e32 = {k: cs.quantity_err(f32[k], ref[k]) for k in ref}
    floors = {"11c floors": (cs.TOL_GRAD_FULL["points"], cs.POINTS_HEAD_FLOOR),
              "cell SVGP floors": (cs.TOL_GRAD_FULL["svgp"], cs.TOL_E2E_POST)}
    rows = []
    for control, ctx in CONTROLS:
        with ctx():
            got = q(device, torch.float32)
        errs = {k: cs.quantity_err(got[k], ref[k]) for k in ref}
        row = {"control": control, "errs": errs, "cpu_f32": e32}
        for label, (grad_floor, head_floor) in floors.items():
            row[label] = sorted(k for k in ref if not cs.finite(got[k]) or errs[k] > cs.quantity_tol(
                k, e32[k], grad_floor, head_floor))
        rows.append(row)
        print(f"11c [{control}]: " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        print(f"11c [{control}] fails at 11c's floors: {row['11c floors'] or 'none'}; at the "
              f"cell SVGPs': {row['cell SVGP floors'] or 'none'}")
    return rows


def main() -> int:
    import torch

    from vggp_tpu_torch import svgp, train
    from vggp_tpu_torch.models import common
    from vggp_tpu_torch.ops.chol import PSDFactor, safe_cholesky

    if not torch.cuda.is_available():
        print("torch_points_precision: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line())
    device = torch.device("cuda")
    x1, y1, xs1 = cs.make_data_1d(device)
    X1 = x1[:, None]
    spec = cs.points_spec()
    model, _ = cs.train_svgp(device, spec, X1, y1, ((cs.TRAIN_BATCH, cs.FULL_STEPS),), 61)
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
    xb, yb = X1[:cs.TRAIN_BATCH], y1[:cs.TRAIN_BATCH]

    real_apply, real_chol = svgp.KronMoments.apply, common.axis_chol_kuu
    real_whiten = common.axis_whitened_kuf

    def moments64(mu, *mats):
        return tuple(o.float() for o in real_apply(mu.double(), *(m.double() for m in mats)))

    def chol64(spec, params):
        out = []
        for i, (kind, f) in enumerate(zip(spec.kinds, spec.features)):
            kuu = f.Kuu(kind, common.axis_params(params, i)).double()
            jit = common.axis_rel_jitter(spec, kind, torch.float32, f)
            out.append(PSDFactor(safe_cholesky(kuu, jit).float()))
        return tuple(out)

    def whiten64(spec, params, chols, X):
        X = X[:, None] if X.dim() == 1 else X
        out = []
        for i, (kind, f) in enumerate(zip(spec.kinds, spec.features)):
            p = common.axis_params(params, i)
            kuu = f.Kuu(kind, p).double()
            F = safe_cholesky(kuu, common.axis_rel_jitter(spec, kind, torch.float32, f))
            out.append(torch.linalg.solve_triangular(F, f.Kuf(kind, p, X[:, i]).double(),
                                                     upper=False).float())
        return tuple(out)

    def leaves(cast, moments=False, chol=False, whiten=False):
        svgp.KronMoments.apply = moments64 if moments else real_apply
        common.axis_chol_kuu = chol64 if chol else real_chol
        common.axis_whitened_kuf = whiten64 if whiten else real_whiten
        try:
            val, grads = cs.value_and_grads(lambda q: svgp.loss(spec, q, cast(xb), cast(yb)),
                                            cast(params))
        finally:
            svgp.KronMoments.apply, common.axis_chol_kuu = real_apply, real_chol
            common.axis_whitened_kuf = real_whiten
        return {"loss": val, **grads}

    cpu = torch.device("cpu")
    ref = leaves(cs.cast_to(cpu, torch.float64))
    card = cs.cast_to(device, torch.float32)
    variants = {"card f32": leaves(card), "cpu f32": leaves(cs.cast_to(cpu, torch.float32)),
                "card f32, moments f64": leaves(card, moments=True),
                "card f32, Kuu factor f64": leaves(card, chol=True),
                "card f32, whitening f64": leaves(card, whiten=True),
                "card f32, all three f64": leaves(card, moments=True, chol=True, whiten=True)}
    out = {name: {k: cs.quantity_err(v[k], ref[k]) for k in ref} for name, v in variants.items()}
    for name, errs in out.items():
        print(f"{name}: " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    rows = controls(spec, params, xb, yb, cs.points_heads(xs1[:, None]), device)
    print(json.dumps({"points_precision": out, "controls": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
