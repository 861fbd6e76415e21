"""Milliseconds a training step in which the device was idle while the host was
innermost in the port's ``vggp.dispatch.*`` spans (``gpbench.spans``)."""

from gpbench.spans import install, layer_ms_per_unit

# the trace's summary carries the spans' attribution from here on
install()


def read(rec):
    return layer_ms_per_unit(rec, "fit", "idle_s", "dispatch")
