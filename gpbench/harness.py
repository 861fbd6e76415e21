"""One run of one cell: set-up, the measured window, the check, the result.

Everything particular to a cell is found by name. ``BENCHMARK.json`` names
the cell's configuration (its file under ``configs/``) and traffic mix
(``traffic/<name>.json``, which names its driver in ``drivers/``); the
configuration names its model family (``families/<name>.py``, with its
plain reference in ``reference/``); the cell's limits are
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``.
A new cell, mix or metric is new files and new entries, and no edit here.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vggp_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``workload`` of ``bench`` with its files, read from ``root``."""
    base = root / "gpbench"
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload, names)]
    return SimpleNamespace(
        name=workload, entry=entry, cfg=cfg, traffic=traffic,
        limits=load_json(base / "limits" / f"{workload}.json"),
        driver=load_module(base / "drivers" / f"{traffic['driver']}.py",
                           f"gpbench_driver_{traffic['driver']}"),
        family=load_module(base / "families" / f"{cfg['family']}.py",
                           f"gpbench_family_{cfg['family']}"),
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: load_module(base / "metrics" / f"{m['name']}.py",
                                        f"gpbench_metric_{m['name']}")
                 for m in e2e + per_layer},
        seed=None, device=None)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(cell, st, seconds: float, max_units, start: int = 0) -> dict:
    """Units ``start``, ``start`` + 1, ... back to back until ``seconds`` have
    passed (or ``max_units`` are done), then ``synchronize()``: the window's
    record."""
    import torch

    from gpbench.trace import MARKER

    drv = cell.driver
    latencies, points, k = [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.profiler.record_function(MARKER):
        while True:
            p, s = drv.unit(st, start + k)
            points += p
            latencies.append(s)
            k += 1
            if time.perf_counter() >= deadline or (max_units and k >= max_units):
                break
        _sync(cell.device)
    return {"t0": t0, "window_s": time.perf_counter() - t0, "units": k, "points": points,
            "latencies_s": latencies}


def _profiled_window(cell, st, seconds: float, max_units, start: int) -> dict:
    """The trace summary of a profiled window of units from ``start`` on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpbench.trace import summarize

    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        # "Profiler clears events at the end of each cycle": one cycle here
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=acts) as prof:
            rec = _window(cell, st, seconds, max_units, start)
    summary = summarize(prof)
    summary.update(units=rec["units"], unit_mean_s=rec["window_s"] / max(rec["units"], 1))
    return summary


def forbidden_loaded() -> list:
    """Top-level names of ``sys.modules`` that are JAX or the JAX package,
    each compared whole (``vggp_tpu_torch`` is not ``vggp_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             out=None, err=None) -> int:
    """One run of ``cell``; prints the result's line last on ``out`` and the
    numbers compared last on ``err``. Returns the exit code."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    out = out or sys.stdout
    err = err or sys.stderr
    cell.seed, cell.device = int(seed), device
    drv = cell.driver
    before = time.perf_counter() - t_start
    st = drv.setup(cell)
    _sync(device)
    ck.reset_launch_counts()
    rec = _window(cell, st, seconds, None)
    rec["setup_s"] = rec.pop("t0") - t_start
    launches, shapes = dict(ck.LAUNCHES), dict(ck.SHAPE_LAUNCHES)
    timed_shapes, summary = shapes, None
    if trace or any(m["source"] == "device_trace" for m in cell.end_to_end):
        # the profiler slows the host, so the trace's metrics read a window
        # of their own after the timed one, whose latencies stay unprofiled;
        # an end-to-end metric of the device's trace reads it in every run
        ck.reset_launch_counts()
        summary = _profiled_window(cell, st, seconds, cell.traffic.get("trace_units"),
                                   rec["units"])
        shapes = dict(ck.SHAPE_LAUNCHES)
    failed = drv.failed(st)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.update(kind=cell.traffic["driver"], fmas_per_unit=drv.fmas(st), trace=summary,
               shape_launches=shapes)
    print(f"gpbench {cell.name}: set-up {rec['setup_s']:.6f} s: {before:.6f} s to the driver "
          f"(interpreter, imports, CUDA), then {st.get('phases')}", file=out)
    lat = sorted(rec["latencies_s"])
    q = [lat[min(len(lat) - 1, int(f * len(lat)))] for f in (0.0, 0.1, 0.5, 0.9, 1.0)]
    print(f"gpbench {cell.name}: unit seconds min, p10, median, p90, max "
          f"{[round(v, 6) for v in q]}", file=out)
    print(f"gpbench {cell.name}: {rec['units']} units in {rec['window_s']:.6f} s; kernel "
          f"launches {launches}, by shape "
          f"{ {f'{n}({m},{k})': v for (n, m, k), v in timed_shapes.items()} }", file=out)
    if summary is not None:
        print(f"gpbench {cell.name}: traced window {summary['units']} units in "
              f"{summary['window_s']:.6f} s ({summary['unit_mean_s']:.6f} s a unit against "
              f"{rec['window_s'] / rec['units']:.6f} s timed), device busy "
              f"{summary['busy_s']:.6f} s, {summary['launches']} launches", file=out)

    drv.release(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check(st)
    where = numbers.pop("_where", {})
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": rec["units"], "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    bad = forbidden_loaded()
    if bad:
        print(f"gpbench: the run loaded {bad}: the port may not import JAX or the JAX "
              f"package", file=err)
        return 3
    print(f"gpbench {cell.name}: check took {time.perf_counter() - t_check:.3f} s: "
          f"{numbers}, over {where}", file=out)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
