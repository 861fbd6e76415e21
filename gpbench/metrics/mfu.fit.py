"""The least time of a training step's products (gpbench.costs) over its measured time, %."""

from gpbench.readers import mfu


def read(rec):
    return mfu(rec, "fit")
