"""Device milliseconds a training step of the operations launched inside no
``vggp.*`` span (``gpbench.spans``)."""

from gpbench.spans import install, layer_ms_per_unit

# the trace's summary carries the spans' attribution from here on
install()


def read(rec):
    return layer_ms_per_unit(rec, "fit", "device_s", None)
