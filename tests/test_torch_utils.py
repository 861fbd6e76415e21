"""The port's ``utils`` (``vggp_tpu_torch/utils/``) against the JAX
package's (``vggp_tpu/utils/``).

The metrics and scalers on tensors match ``vggp_tpu.utils``' jnp functions
at rtol 1e-12 in float64 (the mirrors of ``tests/test_metrics.py``, on the
same data); the host-numpy metrics, the data generators and the
integrators are the port's own copies and equal the JAX package's bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import utils as jutils
from vggp_tpu.utils import metrics as jmetrics

from vggp_tpu_torch import utils
from vggp_tpu_torch.utils import metrics

RTOL = 1e-12


def _fake_predictions(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(n)
    sd = np.exp(0.3 * rng.standard_normal(n))
    y = mu + sd * rng.standard_normal(n)  # perfectly calibrated
    return y, mu, sd**2


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_evaluation_row_matches_jax():
    """The row equals JAX's bitwise (numpy or tensor inputs) and the tensor
    metrics: each torch metric equals JAX's jnp metric at RTOL."""
    y, mu, var = _fake_predictions(200)
    ty = np.linspace(-1, 2, 50)
    row = metrics.evaluation_metric_row(y, mu, var, ty)
    assert row == jmetrics.evaluation_metric_row(y, mu, var, ty)
    assert metrics.evaluation_metric_row(_t(y), _t(mu), _t(var), _t(ty)) == row
    y2, mu2 = y.reshape(-1, 1), mu.reshape(-1, 1)
    for i, name in enumerate(("mean_squared_error", "mean_absolute_error",
                              "root_mean_squared_error", "r_squared")):
        got = float(getattr(utils, name)(_t(y2), _t(mu2)))
        assert got == pytest.approx(float(getattr(jutils, name)(jnp.asarray(y2),
                                                                jnp.asarray(mu2))), rel=RTOL)
        assert row[i] == pytest.approx(got, rel=1e-10)
    nlpd = float(utils.negative_log_predictive_density(_t(y), _t(mu), _t(var)))
    assert nlpd == pytest.approx(float(jutils.negative_log_predictive_density(
        jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var))), rel=RTOL)
    assert row[4] == pytest.approx(nlpd, rel=1e-10)
    for name in ("mean_standardized_log_loss", "mean_squared_log_loss"):
        msll = float(getattr(utils, name)(_t(y), _t(mu), _t(var), _t(ty)))
        assert msll == pytest.approx(float(getattr(jutils, name)(
            jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var), jnp.asarray(ty))), rel=RTOL)
        assert row[5] == pytest.approx(msll, rel=1e-9)


def test_metrics_keep_the_2d_shape_contract():
    a, b = _t(np.zeros((3, 1))), _t(np.zeros((3, 2)))
    for fn in (utils.mean_squared_error, utils.r_squared):
        with pytest.raises(AssertionError, match="2D"):
            fn(_t(np.zeros(3)), a)
        with pytest.raises(AssertionError, match="shape mismatch"):
            fn(a, b)
    with pytest.raises(AssertionError, match="2D"):
        jutils.mean_squared_error(jnp.zeros(3), jnp.zeros((3, 1)))


def test_crps_closed_form_matches_numerical_integral():
    """CRPS(F, y) = ∫ (F(t) − 1{t ≥ y})² dt on a wide fine grid, and JAX's
    closed form bitwise."""
    from scipy.special import erf

    def Phi(t, mu, sd):
        return 0.5 * (1.0 + erf((t - mu) / (sd * np.sqrt(2.0))))

    for (mu, sd, y) in [(0.0, 1.0, 0.7), (2.0, 0.5, 0.0), (-1.0, 2.0, -1.0)]:
        lo = np.linspace(mu - 12 * sd, y, 100_001)
        hi = np.linspace(y, mu + 12 * sd, 100_001)
        oracle = (np.trapezoid(Phi(lo, mu, sd) ** 2, lo)
                  + np.trapezoid((Phi(hi, mu, sd) - 1.0) ** 2, hi))
        args = (np.asarray([y]), np.asarray([mu]), np.asarray([sd**2]))
        got = metrics.crps_gaussian(*args)
        assert got == pytest.approx(oracle, rel=1e-6)
        assert got == jmetrics.crps_gaussian(*args)


def test_crps_small_sigma_limit_is_mae():
    y = np.asarray([1.0, -2.0, 0.3])
    mu = np.asarray([0.5, -2.5, 0.3])
    got = metrics.crps_gaussian(_t(y), _t(mu), _t(np.full(3, 1e-16)))
    assert got == pytest.approx(np.mean(np.abs(y - mu)), rel=1e-6)


def test_crps_proper_scoring_prefers_true_variance():
    y, mu, var = _fake_predictions(20_000, seed=3)
    s_true = metrics.crps_gaussian(y, mu, var)
    assert s_true == jmetrics.crps_gaussian(y, mu, var)
    assert s_true < metrics.crps_gaussian(y, mu, 4.0 * var)
    assert s_true < metrics.crps_gaussian(y, mu, 0.25 * var)


def test_interval_coverage_calibrated_and_not():
    y, mu, var = _fake_predictions(50_000, seed=1)
    for level in (0.5, 0.9, 0.95):
        got = metrics.interval_coverage(y, mu, var, level)
        assert got == jmetrics.interval_coverage(y, mu, var, level)
        assert got == pytest.approx(level, abs=0.01)
    assert metrics.interval_coverage(y, mu, 0.25 * var, 0.95) < 0.8


def test_calibration_curve_tracks_diagonal():
    y, mu, var = _fake_predictions(50_000, seed=2)
    nominal, emp = metrics.calibration_curve(_t(y), _t(mu), _t(var))
    jn, je = jmetrics.calibration_curve(y, mu, var)
    np.testing.assert_array_equal(nominal, jn)
    np.testing.assert_array_equal(emp, je)
    np.testing.assert_allclose(emp, nominal, atol=0.012)
    _, emp_wide = metrics.calibration_curve(y, mu, 4.0 * var)
    assert np.all(emp_wide > nominal)


def test_scalers_match_jax():
    """min-max (bounds from the data and given) and z-scaling, with their
    inverses, at RTOL; the inverses undo the scalings."""
    x = np.random.default_rng(4).standard_normal(300) * 3.0 + 1.5
    tx, jx = _t(x), jnp.asarray(x)
    for kw in ({}, {"min": -4.0, "max": 9.0}):
        got, lo, hi = utils.min_max_scaling(tx, **kw)
        want, jlo, jhi = jutils.min_max_scaling(jx, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
        assert float(lo) == float(jlo) and float(hi) == float(jhi)
        back = utils.min_max_inverse(got, lo, hi)
        np.testing.assert_allclose(back.numpy(), np.asarray(jutils.min_max_inverse(want, jlo, jhi)),
                                   rtol=RTOL)
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-12)
    got, mean, std = utils.z_scaling(tx)
    want, jmean, jstd = jutils.z_scaling(jx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert float(mean) == pytest.approx(float(jmean), rel=RTOL)
    assert float(std) == pytest.approx(float(jstd), rel=RTOL)
    np.testing.assert_allclose(utils.z_inverse(got, mean, std).numpy(), x, rtol=1e-12)


def test_datagen_matches_jax():
    """gen_1d and gen_2d, evenly and randomly spaced: bitwise."""
    f1 = lambda x: np.sin(4 * x) + np.cos(2 * x)
    f2 = lambda a, b: np.sin(3 * a) * np.cos(2 * b)
    for random in (False, True):
        for got, want in zip(utils.gen_1d(f1, -1.0, 2.0, 37, random, seed=5),
                             jutils.gen_1d(f1, -1.0, 2.0, 37, random, seed=5)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(utils.gen_2d(f2, (0.0, 1.0), (-1.0, 1.0), 9, random, seed=6),
                             jutils.gen_2d(f2, (0.0, 1.0), (-1.0, 1.0), 9, random, seed=6)):
            np.testing.assert_array_equal(got, want)


def test_integrators_match_jax():
    """integrate_1d and the 2-D cell integrators (average, trapezoid,
    Simpson, the gradient's face differences on both axes): bitwise, the
    same errors raised."""
    mesh = np.linspace(0.0, 1.0, 7) ** 1.5
    f = lambda x: np.exp(np.sin(5 * x))
    for got, want in zip(utils.integrate_1d(f, mesh), jutils.integrate_1d(f, mesh)):
        np.testing.assert_array_equal(got, want)
    xs, ys = np.linspace(0.0, 1.0, 41), np.linspace(-1.0, 2.0, 41)
    field = np.sin(3 * xs)[:, None] * np.cos(2 * ys)[None, :]
    np.testing.assert_array_equal(utils.average_grid_2d(field, 8),
                                  jutils.average_grid_2d(field, 8))
    for name in ("trapz_grid_2d", "simpson_grid_2d"):
        np.testing.assert_array_equal(getattr(utils, name)(field, xs, ys, 8),
                                      getattr(jutils, name)(field, xs, ys, 8))
    for axis in (0, 1):
        np.testing.assert_array_equal(utils.grad_trapz_grid_2d(field, xs, ys, 8, axis),
                                      jutils.grad_trapz_grid_2d(field, xs, ys, 8, axis))
    for mod in (utils, jutils):
        with pytest.raises(ValueError, match="cannot form"):
            mod.average_grid_2d(field[:5, :5], 8)
        with pytest.raises(ValueError, match="axis"):
            mod.grad_trapz_grid_2d(field, xs, ys, 8, 2)
