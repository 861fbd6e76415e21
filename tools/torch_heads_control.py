"""Control of chip_smoke.py's serving-heads bound, on one CUDA card.

    python3 tools/torch_heads_control.py

Trains the 512×512-cell model as ``chip_smoke.py`` does (phases 4 and 5),
then runs each phase-6 head on the card twice: at the port's precisions and
with ``config.MATMUL_PRECISION`` and ``config.WHITEN_MATMUL_PRECISION`` set
to "default", which lets cuBLAS take TF32 in every product of the heads. Each
result is held against the same head on the CPU in float64 and compared with
the phase's bound, ``chip_smoke.heads_tol`` of the CPU's own float32 error.
A head whose TF32 run stays inside the bound is one the bound cannot tell
from a lower-precision product.

Prints one line per head and, last, a JSON object with the rows, after the
card's name and power limit. Imports torch and the port only (no JAX).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the trained model, the heads and their bound)


def main() -> int:
    import torch

    from vggp_tpu_torch import config
    from vggp_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_heads_control: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}")
    device = torch.device("cuda")
    _build.load()
    X, y, Xs = cs.make_data(device)
    spec, model, *_ = cs.drive_main_path(device, X, y, Xs)
    specs, ctx = cs.head_contexts(device, spec, model)
    precisions = (config.MATMUL_PRECISION, config.WHITEN_MATMUL_PRECISION)
    rows = []
    for name, which, _, _, fn in cs.head_table(device, spec, Xs):
        run = lambda tag: fn(specs[which], *ctx[which, tag])
        with torch.no_grad():
            ref, f32, card_f32 = run("f64"), run("f32"), run("card")
            config.MATMUL_PRECISION = config.WHITEN_MATMUL_PRECISION = "default"
            try:
                card_tf32 = run("card")
            finally:
                config.MATMUL_PRECISION, config.WHITEN_MATMUL_PRECISION = precisions
        e32 = cs.gauss_err(f32, ref)
        row = {"head": name, "cpu_f32": e32, "tol": cs.heads_tol(e32),
               "card_f32": cs.gauss_err(card_f32, ref), "card_tf32": cs.gauss_err(card_tf32, ref)}
        row["tf32_caught"] = row["card_tf32"] > row["tol"]
        rows.append(row)
        print(f"{name}: card f32 {row['card_f32']:.3e}, card TF32 {row['card_tf32']:.3e}, "
              f"cpu f32 {e32:.3e}, tol {row['tol']:.3e}: TF32 "
              + ("caught" if row["tf32_caught"] else "NOT caught"))
    print(card)
    print(json.dumps({"rows": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
