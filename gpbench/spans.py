"""Where a traced window's device time and idle gaps go among the port's
``vggp.*`` spans (``vggp_tpu_torch.tracing``), and the per-layer metrics read
from it.

:func:`install` makes ``trace.summarize`` add one key, ``spans``, to the
summary it returns: :func:`summarize_spans` of the same profiler events. The
summary's other keys are ``trace.summarize``'s own, computed as before. The
metric readers that need the key call :func:`install` when they are loaded,
which is before the run.

The attribution is a pure function of plain tuples, which
:func:`summarize_spans` builds from the profiler's events:

- a device operation goes to the innermost span around the runtime call that
  launched it (matched by correlation id), on the launching thread;
- a thread inside an ``autograd::engine::evaluate_function`` event runs a
  backward node: the event stands for the forward operator with the node's
  sequence number on its forward thread, and so for that operator's span;
- a launch with neither around it goes to the span the host was in at the
  time (below); with none, the operation is unattributed;
- an idle interval is split among the spans by how long each was the host's
  innermost: at each instant, of the spans and linked backward nodes open on
  any thread, the one entered last;
- ``vggp.sync.*`` spans mark a read back to the host, not a layer: they are
  counted, and their time goes to the span around them.

Span names are ``vggp.<layer>.<what>``; a layer's number sums its spans.
"""

from __future__ import annotations

import bisect
import collections
import functools
import heapq
from typing import NamedTuple

from gpbench import trace

PREFIX = "vggp."
SYNC = "vggp.sync."
ENTRY = "vggp.entry."
BACKWARD = "autograd::engine::evaluate_function"
UNATTRIBUTED = "(no span)"
# runtime calls after which the host has waited for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


class HostEvent(NamedTuple):
    """A host event: a span, an operator or a backward node."""

    name: str
    tid: int       # the profiler's thread id
    start: int     # ns
    end: int       # ns
    seq: int       # autograd sequence number, -1 where none
    fwd_tid: int   # a backward event's forward thread, 0 for a forward one


def _segments(intervals) -> tuple:
    """``[(start, end, label)]`` as disjoint segments ``(starts, [(start,
    end, label)])``: at each instant the label of the interval entered last
    among those open (of two entered at once, the shorter)."""
    by_start = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    points = sorted({p for s, e, _ in by_start for p in (s, e)})
    heap, segs, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(by_start) and by_start[i][0] <= a:
            s, e, label = by_start[i]
            heapq.heappush(heap, (-s, e, i, label))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        label = heap[0][3]
        if segs and segs[-1][1] == a and segs[-1][2] == label:
            segs[-1] = (segs[-1][0], b, label)
        else:
            segs.append((a, b, label))
    return [s for s, _, _ in segs], segs


def _label(seg, t):
    starts, segs = seg
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < segs[i][1]:
        return segs[i][2]
    return None


class _Timeline:
    """The innermost label at an instant: on one thread, or across threads."""

    def __init__(self, intervals):
        per = collections.defaultdict(list)
        for tid, s, e, label in intervals:
            per[tid].append((s, e, label))
        self.threads = {tid: _segments(iv) for tid, iv in per.items()}
        self.across = _segments([(s, e, label) for _, s, e, label in intervals])

    def at(self, tid, t):
        seg = self.threads.get(tid)
        return None if seg is None else _label(seg, t)

    def anywhere(self, t):
        return _label(self.across, t)


def _forward_ops(events) -> dict:
    """(thread, sequence number) → the start of the last forward operator
    with it: the one that made the autograd node (operators nested in it,
    and those that make no node, share the number)."""
    out = {}
    for e in events:
        if e.seq >= 0 and e.fwd_tid == 0:
            key = (e.tid, e.seq)
            if e.start >= out.get(key, -1):
                out[key] = e.start
    return out


def _overlap(segs, gaps) -> collections.Counter:
    """ns of each label's segments inside the sorted disjoint ``gaps``."""
    out = collections.Counter()
    j = 0
    for s, t in gaps:
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < t:
            a, b, label = segs[k]
            out[label] += min(b, t) - max(a, s)
            k += 1
    return out


def attribute(events, calls, device, gaps, window, syncs=()) -> dict:
    """The window's device seconds and idle seconds by span name
    (``UNATTRIBUTED`` for none), the count of each span begun in the window,
    and the synchronizing runtime calls inside the units.

    events: ``HostEvent``s; calls: correlation id → (thread, start ns) of the
    runtime call; device: ``(start, end, name, correlation id)`` clipped to
    the window; gaps: the window's idle intervals, sorted; window: (start,
    end) ns; syncs: (thread, start ns) of each synchronizing runtime call."""
    w0, w1 = window
    spans = [e for e in events if e.name.startswith(PREFIX)]
    count = collections.Counter(e.name for e in spans if w0 <= e.start <= w1)
    layered = [(e.tid, e.start, e.end, e.name) for e in spans if not e.name.startswith(SYNC)]
    of_spans = _Timeline(layered)
    forward = _forward_ops(events)
    for e in events:
        if e.name.startswith(BACKWARD) and e.seq >= 0:
            start = forward.get((e.fwd_tid, e.seq))
            label = None if start is None else of_spans.at(e.fwd_tid, start)
            if label is not None:
                layered.append((e.tid, e.start, e.end, label))
    host = _Timeline(layered)

    device_ns = collections.Counter()
    for s, t, _, corr in device:
        call = calls.get(corr)
        label = None
        if call is not None:
            tid, at = call
            label = host.at(tid, at) or host.anywhere(at)
        device_ns[label or UNATTRIBUTED] += t - s
    idle_ns = _overlap(host.across[1], gaps)
    covered = sum(idle_ns.values())
    idle_ns[UNATTRIBUTED] += sum(t - s for s, t in gaps) - covered

    entry = _Timeline([(e.tid, e.start, e.end, e.name) for e in spans
                       if e.name.startswith(ENTRY)])
    waits = _Timeline([(e.tid, e.start, e.end, e.name) for e in spans
                       if e.name.startswith(SYNC)])
    inside = [(tid, t) for tid, t in syncs if w0 <= t <= w1 and entry.at(tid, t)]
    return {"device_s": {k: v / 1e9 for k, v in device_ns.items()},
            "idle_s": {k: v / 1e9 for k, v in idle_ns.items() if v},
            "count": dict(count),
            "runtime_syncs": {"in_units": len(inside),
                              "in_sync_spans": sum(1 for tid, t in inside if waits.at(tid, t))}}


# --------------------------------------------------------------------------- #
# the profiler's events
# --------------------------------------------------------------------------- #

def _host_event(e, name: str) -> HostEvent:
    s = e.start_ns()
    return HostEvent(name, e.start_thread_id(), s, s + e.duration_ns(), e.sequence_nr(),
                     e.fwd_thread_id())


def summarize_spans(events) -> dict:
    """:func:`attribute` of the profiler's raw events, over the window that
    ``trace.summarize`` reads (its ``trace.MARKER`` span) and the idle
    intervals it finds there."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    window = None
    device, linked, calls, syncs = [], [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                s = e.start_ns()
                device.append((s, s + e.duration_ns(), name, e.correlation_id()))
        elif e.device_type() == cpu:
            if name.startswith("cu"):
                calls[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
                if name in SYNC_CALLS:
                    syncs.append((e.start_thread_id(), e.start_ns()))
            if name == trace.MARKER:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith(PREFIX) or (e.sequence_nr() >= 0
                                             and not trace._is_launch(name)):
                linked.append(_host_event(e, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {trace.MARKER!r} span")
    w0, w1 = window
    device = [(max(s, w0), min(t, w1), n, c) for s, t, n, c in device if t > w0 and s < w1]
    gaps, prev = [], w0
    for s, t in trace._merge([(s, t) for s, t, _, _ in device]):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    return attribute(linked, calls, device, gaps, window, syncs)


def install() -> None:
    """Make ``trace.summarize`` add the key ``spans`` (:func:`summarize_spans`)
    to its summary; once, however often it is called."""
    summarize = trace.summarize
    if getattr(summarize, "adds_spans", False):
        return

    @functools.wraps(summarize)
    def with_spans(prof) -> dict:
        summary = summarize(prof)
        summary["spans"] = summarize_spans(prof.profiler.kineto_results.events())
        return summary

    with_spans.adds_spans = True
    trace.summarize = with_spans


# --------------------------------------------------------------------------- #
# the per-layer metrics' readers
# --------------------------------------------------------------------------- #

def _spans(rec: dict, kind: str):
    """The span attribution of a traced run of a ``kind`` cell whose program
    records spans, else None (another cell, no trace, a program without
    them)."""
    t = rec.get("trace") if rec.get("kind") == kind else None
    if t is None or not t["units"] or not t.get("spans", {}).get("count"):
        return None
    return t


def layer_ms_per_unit(rec: dict, kind: str, what: str, layer: str):
    """Milliseconds a unit of ``what`` ("device_s" or "idle_s") that went to
    the spans of ``layer`` (``vggp.<layer>.*``), or to none where ``layer``
    is None."""
    t = _spans(rec, kind)
    if t is None:
        return None
    by_span = t["spans"][what]
    if layer is None:
        total = by_span.get(UNATTRIBUTED, 0.0)
    else:
        total = sum(v for k, v in by_span.items() if k.startswith(f"{PREFIX}{layer}."))
    return 1e3 * total / t["units"]


def syncs_per_unit(rec: dict, kind: str):
    """``vggp.sync.*`` spans (reads of a device value by the host) a unit."""
    t = _spans(rec, kind)
    if t is None:
        return None
    n = sum(v for k, v in t["spans"]["count"].items() if k.startswith(SYNC))
    return n / t["units"]
