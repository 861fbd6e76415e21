"""Named spans at the port's layer boundaries, recorded only while a
``torch.profiler`` runs.

A span is a ``torch.profiler.record_function`` range, so it shares the
profiler's clock and event stream with the device trace: each device
operation can be traced to the span that launched it, and each idle gap to
the span the host was in. Names are ``vggp.<layer>.<what>``:

- ``vggp.entry.*``: the unit a caller sees (a training step, its backward and
  update; a posterior request);
- ``vggp.model.*``: the model's math (``models/``: the q(f) moments, the
  likelihood terms, the KL);
- ``vggp.dispatch.*``: the host's dispatch of features and ops
  (``features.py``, ``ops/*``) and the kernels they launch;
- ``vggp.sync.*``: a read of a device value back to the host; the span's
  length is how long the host waited.

The spans of one unit nest under its ``vggp.entry.*`` span. With no profiler
recording, a span costs one flag read and launches, synchronises and
allocates nothing.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd import _profiler_enabled


class _Null:
    """The context of every span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """``with span("vggp.<layer>.<what>"):`` — a ``record_function`` range
    while a profiler records, else a shared context that does nothing."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``
    (the profiler is asked on each call, not when the function is defined)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
