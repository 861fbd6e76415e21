#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 gpbench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6]
        [--out chiprun_out/<file>.json]

For each of ``--seeds``: the program's numbers, by the cell's own set-up and
check, without a window (for a serving cell, the requests of the first
``check_within`` indices stand in for the window's). For each of
``--control-seeds``: the control's numbers (the reference one precision step
below the configuration's, put in the program's place) and, for a training
cell, the planted fault of half the batch left out, the mean taken over the
rest, and the fault of every update after the first skipped (a state left
unchanged reads 1 on ``change`` by its definition). The
benchmark's runs never run this; the limits in ``limits/`` are set from its
readings as ``PERF.md`` records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpbench import harness  # noqa: E402
from gpbench.reference.precision import CONTROL, REFERENCE  # noqa: E402


def _numbers(d: dict) -> dict:
    return {k: float(v) for k, v in d.items() if not k.startswith("_")}


def program_reading(cell) -> dict:
    drv = cell.driver
    st = drv.setup(cell)
    if cell.traffic["driver"] == "serve":
        for k in range(cell.traffic["check_within"]):
            drv.unit(st, k)
    drv.release(st)
    return _numbers(drv.check(st))


def fit_control(cell) -> dict:
    """The control's and the planted faults' readings of a training cell:
    each against the reference on the same batches."""
    from gpbench import data
    from gpbench.drivers import fit

    cfg, tr = cell.cfg, cell.traffic
    X, y = data.field(cfg, cfg["num_data"], cell.device, cell.seed)
    p0 = cell.family.init_params(cfg, cell.device)
    order = data.EpochOrder(X.shape[0], int(tr["batch"]), cell.device, cell.seed)
    idx = [order.batch(k) for k in range(fit.CHECKED_STEPS)]
    block = tr["check_block"]
    ctl = fit.reference_steps(cell, X, y, p0, idx, CONTROL, block)
    out = {"control": _numbers(fit.gaps(cell, X, y, p0, idx, ctl))}
    half = [ix[: ix.shape[0] // 2] for ix in idx]
    flt = fit.reference_steps(cell, X, y, p0, half, REFERENCE, block)
    out["fault_half_batch"] = _numbers(fit.gaps(cell, X, y, p0, idx, flt))
    flt = fit.reference_steps(cell, X, y, p0, idx, REFERENCE, block, updates=1)
    out["fault_updates_after_first_skipped"] = _numbers(fit.gaps(cell, X, y, p0, idx, flt))
    return out


def serve_control(cell) -> dict:
    from gpbench import compare
    from gpbench.drivers import serve

    st = serve.setup(cell)
    serve.release(st)
    worst = {"mean": 0.0, "var": 0.0}
    for k in sorted(st["sample"]):
        cm, cv = serve.reference_answer(st, k, CONTROL)
        rm, rv = serve.reference_answer(st, k, REFERENCE)
        worst["mean"] = max(worst["mean"], compare.field_gap(cm, rm))
        worst["var"] = max(worst["var"], compare.field_gap(cv, rv))
    return {"control": worst}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    cell.device = device
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    result = {"workload": args.workload, "card": torch.cuda.get_device_name(device),
              "program": {}, "control": {}}
    for s in seeds:
        cell.seed = s
        t0 = time.perf_counter()
        result["program"][s] = program_reading(cell)
        torch.cuda.empty_cache()
        print(f"program seed {s}: {result['program'][s]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for s in controls:
        cell.seed = s
        t0 = time.perf_counter()
        fn = fit_control if cell.traffic["driver"] == "fit" else serve_control
        result["control"][s] = fn(cell)
        torch.cuda.empty_cache()
        print(f"control seed {s}: {result['control'][s]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
