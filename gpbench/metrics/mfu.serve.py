"""The least time of a request's products (gpbench.costs) over its measured time, %."""

from gpbench.readers import mfu


def read(rec):
    return mfu(rec, "serve")
