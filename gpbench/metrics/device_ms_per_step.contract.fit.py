"""Device milliseconds a training step of the operations launched inside the
port's ``vggp.model.contract`` span: the three-axis moments' contraction,
forward and backward (``gpbench.spans``)."""

from gpbench.contract import device_s
from gpbench.spans import install

# the trace's summary carries the spans' attribution from here on
install()


def read(rec):
    spent = device_s(rec, "fit")
    return None if spent is None else 1e3 * spent / rec["trace"]["units"]
