"""The cost model against the bounds of PERF.md §6, and the shares it gives
never above 100% when the time measured is the least time itself."""

import pytest

from gpbench import costs, readers


@pytest.mark.parametrize("name, m, n, want_ms", [
    ("cell_kuf", 512, 4096, 0.00251),
    ("cell_kuf_with_dl", 512, 4096, 0.00501),
    ("fused_banded_whiten_kuf", 512, 16384, 0.0327),
    ("cell_kuf", 512, 65536, 0.0401),
    ("cell_kuf_with_dl", 64, 65536, 0.0101),
    ("fused_banded_whiten_kuf", 512, 65536, 0.1307),
])
def test_kernel_bounds_match_the_table(name, m, n, want_ms):
    got = costs.KERNEL_BOUNDS[name](m, n) * 1e3
    assert got == pytest.approx(want_ms, rel=5e-3)


def test_bound_sums_launches_by_shape():
    shapes = {("cell_kuf", 512, 4096): 3, ("cell_kuf", 64, 65536): 2,
              ("cell_kuf_with_dl", 512, 4096): 7}
    want = 3 * costs.kuf_bound_s(512, 4096, False) + 2 * costs.kuf_bound_s(64, 65536, False)
    assert costs.kernel_bound_s("cell_kuf", shapes) == pytest.approx(want)


@pytest.mark.parametrize("fmas", [
    costs.svgp_kron_fit_fmas([512, 512], 4096),
    costs.svgp_kron_fit_fmas([512, 512], 262144),
    costs.svgp_kron_serve_fmas([512, 512], 262144),
])
def test_mfu_of_the_least_time_is_100(fmas):
    least = costs.least_seconds(fmas)
    assert least > 0
    for kind in ("fit", "serve"):
        rec = {"kind": kind, "fmas_per_unit": fmas, "latencies_s": [least] * 3,
               "trace": {"busy_s": 1.0, "window_s": 1.0}}
        assert readers.mfu(rec, kind) == pytest.approx(100.0)
        rec["latencies_s"] = [least * 1.5] * 3
        assert readers.mfu(rec, kind) < 100.0


@pytest.mark.parametrize("name", sorted(costs.KERNEL_BOUNDS))
def test_roofline_of_the_least_time_is_100(name):
    shapes = {(name, 512, 65536): 4}
    bound = costs.kernel_bound_s(name, shapes)
    symbol = costs.KERNEL_SYMBOLS[name]
    rec = {"trace": {"kernel_s": {f"void {symbol}<float>(...)": bound}}, "shape_launches": shapes}
    assert readers.roofline(rec, name) == pytest.approx(100.0)
    rec["trace"]["kernel_s"] = {symbol: 2 * bound}
    assert readers.roofline(rec, name) == pytest.approx(50.0)


def test_no_share_where_nothing_ran():
    rec = {"trace": {"kernel_s": {}}, "shape_launches": {}}
    assert readers.roofline(rec, "cell_kuf") is None
    assert readers.mfu({"kind": "fit", "trace": None}, "fit") is None


def test_device_ms_per_unit():
    rec = {"kind": "fit", "trace": {"busy_s": 0.234, "units": 60}}
    assert readers.device_ms_per_unit(rec, "fit") == pytest.approx(3.9)
    assert readers.device_ms_per_unit(rec, "serve") is None
    rec["trace"]["busy_s"] = 0.0
    assert readers.device_ms_per_unit(rec, "fit") is None


def test_step_counts_at_the_cells():
    """The least times PERF.md gives for the cells."""
    assert costs.least_seconds(costs.svgp_kron_fit_fmas([512, 512], 4096)) * 1e3 == \
        pytest.approx(17.47 / 64, abs=1e-4)
    assert costs.least_seconds(costs.svgp_kron_fit_fmas([512, 512], 262144)) * 1e3 == \
        pytest.approx(17.47, abs=0.01)
    assert costs.least_seconds(costs.svgp_kron_serve_fmas([512, 512], 262144)) * 1e3 == \
        pytest.approx(6.16, abs=0.01)
