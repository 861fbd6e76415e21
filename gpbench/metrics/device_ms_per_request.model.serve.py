"""Device milliseconds a request of the operations launched inside the port's
``vggp.model.*`` spans (``gpbench.spans``)."""

from gpbench.spans import install, layer_ms_per_unit

# the trace's summary carries the spans' attribution from here on
install()


def read(rec):
    return layer_ms_per_unit(rec, "serve", "device_s", "model")
