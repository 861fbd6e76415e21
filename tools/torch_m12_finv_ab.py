"""The closed-form F⁻¹ kernel of the port against the plain path it replaced, on one CUDA card.

    python3 tools/torch_m12_finv_ab.py [--m 512,64,15] [--dtypes float32,float64]
                                       [--iters 50] [--turns 2] [--json PATH]

Imports torch and the port only (no JAX). For each m and dtype, at σ² = 1.3
and ℓ = 0.27 (ℓ/δ = 0.27·m):

- the ``m12_finv`` kernel against ``ops.kms.m12_finv_plain``:
  max|Δ|/max|plain| of the raw F⁻¹, of F and of the F⁻¹ after the
  Newton–Schulz step, and whether q is the plain one bit for bit;
- the device time of the kernel alone (``m12_finv_kernel`` in the
  profiler's CUDA trace, the median launch) beside its bound, the two
  (m, m) stores over 3.35 TB/s;
- the closed form as ``models.common._finv_of_params`` takes it, F⁻¹ and q
  (``kms.m12_cell_inv_chol_and_ratio``: one launch and the Newton–Schulz
  step), against the plain path (``m12_finv_plain`` and the same step):
  device ms a call (every device operation of five profiled calls), launches
  a call, and host ms a call (CUDA events around ``--iters`` back-to-back
  calls), the median of ``--turns`` interleaved turns (plain, kernel,
  kernel, plain).

The card's name and power limit head the output; ``--json`` writes the
readings too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def _inputs(m, dtype, device):
    import torch

    return (m, 1.0 / m, torch.tensor(1.3, dtype=dtype, device=device),
            torch.tensor(0.27, dtype=dtype, device=device), 1e-6)


def accuracy(m, dtype, device) -> dict:
    import torch

    from vggp_tpu_torch.ops import kms

    args = _inputs(m, dtype, device)
    got, want = kms.m12_finv(*args), kms.m12_finv_plain(*args)
    torch.cuda.synchronize()
    return {"raw_finv": cs.rel_err(got[0], want[0]), "f": cs.rel_err(got[1], want[1]),
            "refined_finv": cs.rel_err(kms.newton_schulz_step(*got[:2]),
                                       kms.newton_schulz_step(*want[:2])),
            "q_bitwise": float(got[2]) == float(want[2])}


def per_call(fn, iters: int, traced: int = 5) -> dict:
    """Device ms and device operations of one call of ``fn`` (the profiler
    over ``traced`` calls) and its host ms (CUDA events over ``iters``)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    host = e0.elapsed_time(e1) / iters
    prof, _ = cs._profiled(fn, traced)
    events = cs._device_events(prof)
    return {"device_ms": cs._kernel_ms(prof) / traced, "launches": len(events) / traced,
            "host_ms": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", default="512,64,15")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()

    import torch

    from vggp_tpu_torch.ops import _build, kms

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds():.2f} s)")

    out = {"card": card, "rows": []}
    for name in a.dtypes.split(","):
        dtype = getattr(torch, name)
        for m in (int(v) for v in a.m.split(",")):
            args = _inputs(m, dtype, device)
            row = {"dtype": name, "m": m, **accuracy(m, dtype, device)}
            kernel_ms, _ = cs.time_ms(lambda: kms.m12_finv(*args), iters=a.iters,
                                      kernel="m12_finv_kernel")
            row["kernel_ms"] = kernel_ms
            row["bound_ms"] = 2 * m * m * dtype.itemsize / HBM_BYTES_PER_S * 1e3
            sides = {
                "plain": lambda: kms.newton_schulz_step(*kms.m12_finv_plain(*args)[:2]),
                "kernel": lambda: kms.m12_cell_inv_chol_and_ratio(*args)}
            reads = {k: [] for k in sides}
            for _ in range(a.turns):
                for k in ("plain", "kernel", "kernel", "plain"):
                    reads[k].append(per_call(sides[k], a.iters))
            for k, rs in reads.items():
                for key in ("device_ms", "launches", "host_ms"):
                    row[f"{k}_{key}"] = statistics.median(r[key] for r in rs)
            print(f"{name} m={m}: kernel {kernel_ms:.5f} ms (bound {row['bound_ms']:.5f} ms, "
                  f"stores); F⁻¹ and q: plain {row['plain_device_ms']:.4f} device ms in "
                  f"{row['plain_launches']:.0f} launches, {row['plain_host_ms']:.4f} host ms; "
                  f"kernel path {row['kernel_device_ms']:.4f} device ms in "
                  f"{row['kernel_launches']:.0f} launches, {row['kernel_host_ms']:.4f} host ms; "
                  f"gaps raw {row['raw_finv']:.3e}, F {row['f']:.3e}, refined "
                  f"{row['refined_finv']:.3e}, q bit for bit {row['q_bitwise']}")
            out["rows"].append(row)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
