"""What the metric readers under ``metrics/`` share. Each reader takes the
run's record and returns its number, or None where the record has nothing
for it: another kind of cell, or no trace, or a kernel the window did not
launch. A share of a roofline or of the peak is never reported as 0."""

from __future__ import annotations

import statistics

from gpbench import costs
from gpbench.trace import kernel_seconds


def traced(rec: dict, kind: str):
    """The trace summary of a traced run of a ``kind`` cell, else None."""
    return rec.get("trace") if rec.get("kind") == kind else None


def launches_per_unit(rec: dict, kind: str):
    t = traced(rec, kind)
    return None if t is None or not t["units"] else t["launches"] / t["units"]


def device_ms_per_unit(rec: dict, kind: str):
    """Milliseconds in which an operation ran on the device, over the units
    of the profiled window: none where the trace saw no device."""
    t = traced(rec, kind)
    if t is None or not t["units"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["units"]


def mfu(rec: dict, kind: str):
    """The least time of a unit's products over its measured time: the mean
    latency of the timed window's units, which the profiler does not slow.
    Reported in a traced run only, beside the trace's metrics."""
    if traced(rec, kind) is None or not rec["latencies_s"]:
        return None
    least = costs.least_seconds(rec["fmas_per_unit"])
    return 100.0 * least / statistics.fmean(rec["latencies_s"])


def roofline(rec: dict, name: str):
    """The least time of every launch of kernel ``name`` in the window over
    its device time in the trace."""
    t = rec.get("trace")
    if t is None:
        return None
    bound = costs.kernel_bound_s(name, rec["shape_launches"])
    spent = kernel_seconds(t, costs.KERNEL_SYMBOLS[name])
    return 100.0 * bound / spent if bound > 0 and spent > 0 else None


def idle_share(rec: dict, kind: str):
    t = traced(rec, kind)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
