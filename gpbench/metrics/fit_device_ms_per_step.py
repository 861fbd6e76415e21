"""Milliseconds a training step keeps the device busy: the union of the
device's operation intervals over every step of the profiled window that
follows the timed one, over those steps."""

from gpbench.readers import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "fit")
