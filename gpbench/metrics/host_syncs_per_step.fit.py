"""Reads of a device value by the host (``vggp.sync.*`` spans) a training step,
in the traced window."""

from gpbench.spans import install, syncs_per_unit

# the trace's summary carries the spans' attribution from here on
install()


def read(rec):
    return syncs_per_unit(rec, "fit")
