"""What a ``torch.profiler`` trace of the window says: the device's busy time
(the union of its kernel, copy and set intervals), the kernel launches the
host issued, each kernel's device time by name, and the idle gaps with what
the host was doing in them.

The window is the span of a ``record_function`` marker around the timed
loop. The events are read from the profiler's raw results, not from its
Python event objects, so that a trace of some hundred thousand launches is
read in seconds.
"""

from __future__ import annotations

import bisect
import collections

import torch

MARKER = "gpbench.window"
TOP = 10


def _ns(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name.startswith("cuLaunch")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """busy_s, window_s, launches, kernel_s (device seconds by kernel name),
    device_ops and idle_gaps (each the TOP largest, [name, seconds])."""
    events = prof.profiler.kineto_results.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    window = None
    device, host = [], []
    launches = 0
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            s, t = _ns(e)
            device.append((s, t, name))
        elif e.device_type() == cpu:
            if name == MARKER:
                window = _ns(e)
            elif _is_launch(name):
                launches += 1
            else:
                s, t = _ns(e)
                host.append((s, t, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {MARKER!r} span")
    w0, w1 = window
    device = [(max(s, w0), min(t, w1), n) for s, t, n in device if t > w0 and s < w1]
    busy = _merge([(s, t) for s, t, _ in device])
    busy_ns = sum(t - s for s, t in busy)

    by_name = collections.Counter()
    for s, t, n in device:
        by_name[n] += t - s
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))

    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for s, t in gaps:
        idle[_host_at(host, starts, (s + t) // 2)] += t - s
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9, "launches": launches,
            "kernel_s": {n: v / 1e9 for n, v in by_name.items()},
            "device_ops": [[n[:160], v / 1e9] for n, v in by_name.most_common(TOP)],
            "idle_gaps": [[n[:160], v / 1e9] for n, v in idle.most_common(TOP)]}


def _host_at(host, starts, t, lookback: int = 256) -> str:
    """The innermost host operation running at time ``t``: of those that
    contain it, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "(host between operations)"


def kernel_seconds(summary: dict, symbol: str) -> float:
    """Device seconds of every kernel whose name holds ``symbol``."""
    return sum(v for n, v in summary["kernel_s"].items() if symbol in n)
