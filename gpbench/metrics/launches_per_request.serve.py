"""Kernel launches the host issued in the traced window, per request."""

from gpbench.readers import launches_per_unit


def read(rec):
    return launches_per_unit(rec, "serve")
