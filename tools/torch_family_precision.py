"""The float32 error of the collapsed families' gradient leaves (chip_smoke.py
phase 12b), and a control of their floors.

    python3 tools/torch_family_precision.py [--cpu] [--models icm,sum,additive,free]

Fits each model of ``chip_smoke.collapsed_family_specs`` as phase 12b does
(``family_init``, FAMILY_STEPS ``train.fit`` steps on SGPR_N points), on the
card or, with ``--cpu``, on the CPU. Then at FAMILY_CUT_N points it takes the
ELBO and every gradient leaf in float64 on the CPU (the reference), in
float32 on the CPU, and on the card in float32 at the port's precisions
(sound) and with every model product in TF32 (``config.MATMUL_PRECISION``
and ``config.WHITEN_MATMUL_PRECISION`` at "default", a planted fault). Each
is held against phase 12b's bound: the larger of its floor
(``chip_smoke.TOL_GRAD_FAMILY``) and ``CPU_ERR_RATIO`` times the CPU's own
float32 error. A control that no leaf fails is one the floors cannot tell
from a sound run. With ``--cpu`` there is no card: the fit and the float32
readings are the CPU's, and the control is not taken.

Prints one line per model and reading and, last, a JSON object with the
rows, after the card's name and power limit when there is a card. Imports
torch and the port only (no JAX).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the phase's models, data and bounds)


def _quantities(spec, mod, params, X, y, cast) -> dict:
    p, Xc, yc = cast(params), cast(X[:cs.FAMILY_CUT_N]), cast(y[:cs.FAMILY_CUT_N])
    val, leaves = cs.value_and_grads(lambda q: mod.loss(spec, q, Xc, yc), p)
    return {"elbo": -val, **leaves}


def _tf32(fn):
    """``fn`` with every model product in TF32."""
    from vggp_tpu_torch import config

    def wrapped(*args):
        old = config.MATMUL_PRECISION, config.WHITEN_MATMUL_PRECISION
        config.MATMUL_PRECISION = config.WHITEN_MATMUL_PRECISION = "default"
        try:
            return fn(*args)
        finally:
            config.MATMUL_PRECISION, config.WHITEN_MATMUL_PRECISION = old

    return wrapped


def main() -> int:
    import torch

    from vggp_tpu_torch import config, train

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="fit and read on the CPU alone")
    parser.add_argument("--models", default="icm,sum,additive,free",
                        help="comma-separated models of phase 12b")
    args = parser.parse_args()
    on_card = not args.cpu
    if on_card and not torch.cuda.is_available():
        print("torch_family_precision: no CUDA device (use --cpu)", file=sys.stderr)
        return 2
    device = torch.device("cuda" if on_card else "cpu")
    if on_card:
        print(f"card: {cs.card_line()}")
    else:
        real = config.resolve_device
        config.resolve_device = lambda d=None: torch.device("cpu") if d is None else real(d)
    X, y, Xs = cs.make_data(device)
    Xm, ym, _ = cs.make_data_multioutput(device)
    cpu = torch.device("cpu")
    rows = []
    for name, spec, mod in cs.collapsed_family_specs():
        if name not in args.models.split(","):
            continue
        Xd, yd = (Xm, ym) if name == "icm" else (X, y)
        Xn, yn = Xd[:cs.SGPR_N], yd[:cs.SGPR_N]
        params0, trainable = cs.family_init(name, spec, Xn, yn)
        params, _ = train.fit(lambda p: mod.loss(spec, p, Xn, yn), params0, cs.FAMILY_STEPS,
                              cs.FIT_LR, trainable=trainable)
        q = lambda cast: _quantities(spec, mod, params, Xd, yd, cast)
        ref = q(cs.cast_to(cpu, torch.float64))
        f32 = q(cs.cast_to(cpu, torch.float32))
        floor = cs.TOL_GRAD_FAMILY.get(name, cs.TOL_GRAD_FAMILY["collapsed"])
        readings = {"cpu f32": f32}
        if on_card:
            readings["card f32"] = q(cs.cast_to(device, torch.float32))
            readings["card, every product TF32"] = _tf32(q)(cs.cast_to(device, torch.float32))
        for what, got in readings.items():
            errs = {k: cs.quantity_err(got[k], ref[k]) for k in ref}
            fails = [k for k in ref if what != "cpu f32" and errs[k] > cs.quantity_tol(
                k, cs.quantity_err(f32[k], ref[k]), floor)]
            print(f"{name} {what}: " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                  + (f"; fails {fails}" if what != "cpu f32" else ""))
            rows.append({"model": name, "reading": what, "errors": errs, "fails": fails})
    print(json.dumps({"rows": rows, "fit_on": device.type}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
