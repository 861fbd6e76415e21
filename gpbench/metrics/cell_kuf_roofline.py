"""The least time of every cell_kuf launch in the traced window over its device time, %."""

from gpbench.readers import roofline


def read(rec):
    return roofline(rec, "cell_kuf")
