"""Control of chip_smoke.py's gradient-leaf floors (phases 7–9), on one CUDA card.

    python3 tools/torch_grad_control.py

Fits the collapsed GriddedGP, the exact GP and the three likelihood SVGPs as
``chip_smoke.py`` does, then takes every gradient leaf of each phase's
comparison on the card in float32 four times: at the port's precisions
(sound), with the whitened ℓ-tangent's products in TF32, with the Kronecker
moments' backward in TF32 as well (the two are the JAX package's
``GRAD_MATMUL_PRECISION`` contract, which the port gave up), and with every
model product in TF32 (``config.MATMUL_PRECISION = "default"``). Each leaf is
held against the phase's float64 reference and the phase's bound: the larger
of ``chip_smoke.TOL_GRAD`` and ``CPU_ERR_RATIO`` times the CPU's own float32
error (where the phase takes one). A control that no leaf of a comparison
fails is one its floor cannot tell from a sound run.

Prints one line per comparison and control and, last, a JSON object with the
rows, after the card's name and power limit. Imports torch and the port only
(no JAX).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the fitted models and the phases' bounds)


def _in_tf32(fn):
    """``fn`` run with ``config.MATMUL_PRECISION`` set to "default" (TF32)."""
    from vggp_tpu_torch import config

    def wrapped(*args):
        old, config.MATMUL_PRECISION = config.MATMUL_PRECISION, "default"
        try:
            return fn(*args)
        finally:
            config.MATMUL_PRECISION = old

    return wrapped


@contextlib.contextmanager
def tf32_gradients(moments: bool):
    """The whitened ℓ-tangent's products in TF32 and, with ``moments``, the
    Kronecker moments' backward too: the JAX package's
    ``GRAD_MATMUL_PRECISION`` contract. The rest as the port has it."""
    from vggp_tpu_torch.models import common, svgp

    real_tangent, real_bwd = common._whitened_kuf_tangent, svgp.KronMoments.backward
    common._whitened_kuf_tangent = _in_tf32(real_tangent)
    if moments:
        svgp.KronMoments.backward = staticmethod(_in_tf32(real_bwd))
    try:
        yield
    finally:
        common._whitened_kuf_tangent = real_tangent
        svgp.KronMoments.backward = staticmethod(real_bwd)


@contextlib.contextmanager
def tf32_model():
    """Every product of the model math and its gradient in TF32 (the
    whitening apply aside)."""
    from vggp_tpu_torch import config

    old, config.MATMUL_PRECISION = config.MATMUL_PRECISION, "default"
    try:
        yield
    finally:
        config.MATMUL_PRECISION = old


CONTROLS = (("sound", contextlib.nullcontext),
            ("tangent TF32", lambda: tf32_gradients(moments=False)),
            ("gradients TF32", lambda: tf32_gradients(moments=True)),
            ("model TF32", tf32_model))


def compare(what, floor, loss_fn, params, device, ref_device, cpu_f32: bool) -> list:
    """The rows of one comparison: for each control, every leaf's error
    against float64 on ``ref_device``, its bound, and whether it fails."""
    import torch

    leaves = lambda dev, dt: cs.value_and_grads(
        lambda q: loss_fn(q, cs.cast_to(dev, dt)), cs.cast_to(dev, dt)(params))[1]
    ref = leaves(ref_device, torch.float64)
    e32 = ({k: cs.quantity_err(g, ref[k]) for k, g in leaves(torch.device("cpu"),
                                                             torch.float32).items()}
           if cpu_f32 else {})
    tol = {k: max(floor, cs.CPU_ERR_RATIO * e32.get(k, 0.0)) for k in ref}
    rows = []
    for control, ctx in CONTROLS:
        with ctx():
            got = leaves(device, torch.float32)
        errs = {k: cs.quantity_err(got[k], ref[k]) for k in ref}
        failed = sorted(k for k in ref if errs[k] > tol[k])
        rows.append({"comparison": what, "control": control, "floor": floor, "errs": errs,
                     "tols": tol, "failed": failed})
        worst = max(errs, key=lambda k: errs[k] / tol[k])
        print(f"{what} [{control}]: largest {max(errs.values()):.3e}, closest to its bound "
              f"{worst} {errs[worst]:.3e} of {tol[worst]:.3e}; fails: {failed or 'none'}")
    return rows


def main() -> int:
    import torch

    from vggp_tpu_torch import exact, sgpr, svgp, train
    from vggp_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_grad_control: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}")
    device, cpu = torch.device("cuda"), torch.device("cpu")
    _build.load()
    X, y, _ = cs.make_data(device)
    rows = []

    spec, params, *_ = cs.fit_collapsed(X, y)
    for key, n, ref_dev in (("collapsed full n", cs.SGPR_N, device),
                            ("collapsed cut n", cs.SGPR_CUT_N, cpu)):
        rows += compare(f"{key} ({n})", cs.TOL_GRAD[key],
                        lambda q, c: sgpr.loss(spec, q, c(X[:n]), c(y[:n])), params, device,
                        ref_dev, cpu_f32=ref_dev == cpu)

    spec, params, *_ = cs.fit_exact(X, y)
    n = cs.EXACT_N
    rows += compare(f"exact ({n})", cs.TOL_GRAD["exact"],
                    lambda q, c: exact.loss(spec, q, c(X[:n]), c(y[:n])), params, device, cpu,
                    cpu_f32=True)

    for i, (name, _) in enumerate(cs.LIKELIHOODS):
        spec, model, t, *_ = cs.train_likelihood(device, X, y, i)
        with torch.no_grad():
            params = train.tree_map(lambda v: v.detach(), model.params())
        xb, yb = X[:cs.TRAIN_BATCH], t[:cs.TRAIN_BATCH]
        rows += compare(f"likelihood {name}", cs.TOL_GRAD["likelihood"],
                        lambda q, c: svgp.loss(spec, q, c(xb), c(yb)), params, device, cpu,
                        cpu_f32=True)
    print(card)
    print(json.dumps({"rows": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
