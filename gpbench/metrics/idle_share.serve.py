"""The share of the traced window of a serve cell in which no operation ran on the device, %."""

from gpbench.readers import idle_share


def read(rec):
    return idle_share(rec, "serve")
