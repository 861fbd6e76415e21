"""The least time of the traced window's three-axis contractions (the
``kron_contract`` counts, ``gpbench.contract``) over the device time of the
``vggp.model.contract`` span, %."""

from gpbench.contract import device_s, window_bound_s
from gpbench.spans import install

# the trace's summary carries the spans' attribution from here on
install()


def read(rec):
    spent = device_s(rec, "fit")
    bound = window_bound_s(rec["shape_launches"])
    return 100.0 * bound / spent if spent and bound > 0 else None
