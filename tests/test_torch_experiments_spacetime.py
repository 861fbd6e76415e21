"""The port's ``spacetime`` experiment and the three-axis Kronecker SVGP it
fits, against the JAX package.

*The model alone, float64 at 1e-10:* a lon × lat × time SVGP with Matérn-1/2
cells of three different sizes per axis (so a transposed Kronecker order
cannot pass), a random μ, perturbed factors L₁, L₂, L₃ and ℓ ≠ 1: the loss,
its gradient with respect to every leaf (with ``KronMoments``' hand-written
backward and with plain autograd), and ``q_v``'s mean and variance on 4³
cells, flattened in ``numpy.kron``'s row-major order.

*Exact holds:* the field, ``truth_integrals`` and ``generate_passes`` equal
the JAX package's arrays.

*The experiment:* ``spacetime.run(m_side=8, n_grid=4, batch_size=512)`` at
5 iterations in both packages, the JAX run in float32 as in production
(``jax.enable_x64(False)``) and the port on the CPU in float32. The minibatch
indices are one table: the JAX run's own ``randint`` draws (its key split
as ``train.fit_minibatch`` splits it) fed to the port's ``train._randint``.
Held at float32's RTOL = 1e-3: the final loss, the metric row per entry,
the q(v) mean and variance by their largest magnitude.
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import train as jtrain
from vggp_tpu.experiments import spacetime as jspacetime
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import config, convert, train
from vggp_tpu_torch.experiments import spacetime
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import svgp

from test_torch_experiments import (RTOL, _close_each, _close_max, one_torch_thread,  # noqa: F401
                                    report_largest_gap)
from test_torch_svgp import _torch_flat

ITERS = 5
AXIS_M = (6, 5, 7)      # cells per axis: three sizes pin the Kronecker order
GRID = 4
RTOL_F64 = 1e-10


# --------------------------------------------------------------------------- #
# one minibatch-index table for both packages (also imported by the other
# test_torch_experiments_* files)
# --------------------------------------------------------------------------- #

def jax_minibatch_indices(seed: int, n: int, batch_size: int, n_iters: int) -> np.ndarray:
    """The (n_iters, batch_size) indices JAX's ``train.fit_minibatch`` draws:
    its key split once a step, ``randint`` on the subkey (run in the caller's
    x64 mode, which sets randint's integer width)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (batch_size,), 0, n)))
    return np.stack(out)


@contextlib.contextmanager
def port_minibatches(table: np.ndarray):
    """The port's ``train._randint`` hands out ``table``'s rows in order
    (one step's indices a call), and must use all of them."""
    flat = iter(table.reshape(-1).tolist())

    def randint(gen, n, size, device):
        idx = [next(flat) for _ in range(size)]
        assert max(idx) < n
        return torch.as_tensor(idx, dtype=torch.int64, device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "_randint", randint)
        yield
    assert next(flat, None) is None, "the port drew fewer minibatches than the table"


# --------------------------------------------------------------------------- #
# the three-axis SVGP alone, float64
# --------------------------------------------------------------------------- #

def _params_np(seed=0):
    rng = np.random.default_rng(seed)
    q = {"mu": 0.3 * rng.standard_normal(AXIS_M)}
    for i, m in enumerate(AXIS_M, start=1):
        eye_raw = np.asarray(jsvgp.raw_from_chol(jnp.eye(m)))
        q[f"raw_L{i}"] = eye_raw + 0.05 * np.tril(rng.standard_normal((m, m)))
    axes = tuple({"variance": np.asarray(v), "lengthscale": np.asarray(ell)}
                 for v, ell in ((1.3, 0.2), (0.8, 0.35), (1.1, 0.5)))
    return {"axes": axes, "noise": np.asarray(0.05), "q": q}


def _specs():
    kw = dict(kinds=("matern12",) * 3, num_data=5000, variational="kron")
    jspec = jsvgp.SVGPSpec(features=tuple(JaxCellFeature.from_lims(m, 0.0, 1.0)
                                          for m in AXIS_M), **kw)
    tspec = svgp.SVGPSpec(features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0)
                                         for m in AXIS_M), **kw)
    return jspec, tspec


@pytest.fixture(scope="module")
def three_axis():
    """Specs, parameters, a batch, and the JAX loss, gradients and q(v)
    (one jitted program)."""
    jspec, tspec = _specs()
    p_np = _params_np()
    rng = np.random.default_rng(7)
    x = rng.random((90, 3)) * 1.1 - 0.05
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + x[:, 2] + 0.1 * rng.standard_normal(90)
    grids = tuple(JaxCellFeature.from_lims(GRID, 0.0, 1.0) for _ in range(3))

    @jax.jit
    def jax_side(raw, xj, yj):
        val, g = jax.value_and_grad(
            lambda r: jsvgp.loss(jspec, jtrain.constrain(r), xj, yj))(raw)
        qv = jsvgp.q_v(jspec, jtrain.constrain(raw), grids, full_cov=False)
        return val, g, qv.mean, qv.var

    raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, p_np))
    val, g, mean, var = jax_side(raw, jnp.asarray(x), jnp.asarray(y))
    want = {"loss": float(val), "grads": [np.asarray(v) for v in jax.tree.leaves(g)],
            "mean": np.asarray(mean), "var": np.asarray(var)}
    return tspec, p_np, x, y, want


@pytest.mark.parametrize("fast_moments_bwd", [True, False])
def test_three_axis_svgp_loss_and_every_gradient_match_jax(three_axis, fast_moments_bwd,
                                                           monkeypatch):
    """Loss and every gradient leaf at rtol 1e-10 (each leaf within 1e-10 of
    its largest entry), through ``KronMoments`` over three factors and
    through plain autograd; every ℓ- and L-gradient is non-zero."""
    tspec, p_np, x, y, want = three_axis
    monkeypatch.setattr(config, "FAST_MOMENTS_BWD", fast_moments_bwd)
    raw = train.raw_leaves_from(convert.params_from_jax(p_np, device="cpu",
                                                        dtype=torch.float64))
    val = svgp.loss(tspec, train.constrain(raw), torch.tensor(x), torch.tensor(y))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), want["loss"], rtol=RTOL_F64)
    got = _torch_flat(train.tree_map(lambda v: v.grad, raw))
    assert len(got) == len(want["grads"]) == 3 * 2 + 1 + 4
    for g, w in zip(got, want["grads"], strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL_F64,
                                   atol=RTOL_F64 * max(np.abs(w).max(), 1e-300))
        assert np.abs(w).max() > 1e-6


def test_three_axis_q_v_matches_jax(three_axis):
    """q(v) on 4³ cells: mean and variance at rtol 1e-10 of their largest
    magnitude, in numpy.kron's row-major order (the mean reshapes to
    (4, 4, 4) as the experiment reads it)."""
    tspec, p_np, _, _, want = three_axis
    grids = tuple(CellIntegralFeature.from_lims(GRID, 0.0, 1.0) for _ in range(3))
    with torch.no_grad():
        qv = svgp.q_v(tspec, convert.params_from_jax(p_np, device="cpu", dtype=torch.float64),
                      grids, full_cov=False)
    for got, w in ((qv.mean, want["mean"]), (qv.var, want["var"])):
        assert got.shape == w.shape == (GRID ** 3,)
        np.testing.assert_allclose(got.numpy(), w, rtol=RTOL_F64,
                                   atol=RTOL_F64 * np.abs(w).max())
    # the order is row-major: a single axis's permutation moves the mean
    m3 = want["mean"].reshape(GRID, GRID, GRID)
    assert not np.allclose(m3, np.transpose(m3, (2, 1, 0)))


# --------------------------------------------------------------------------- #
# exact holds and the experiment
# --------------------------------------------------------------------------- #

def test_field_truth_and_passes_equal_jax():
    rng = np.random.default_rng(1)
    x, y, t = rng.random((3, 50))
    np.testing.assert_array_equal(spacetime.field(x, y, t), jspacetime.field(x, y, t),
                                  strict=True)
    meshes = (np.linspace(0.0, 1.0, 5), np.linspace(0.0, 1.0, 4),
              np.sort(np.r_[0.0, rng.random(5), 1.0]))
    np.testing.assert_array_equal(spacetime.truth_integrals(meshes),
                                  jspacetime.truth_integrals(meshes), strict=True)
    for kw in ({}, {"n_passes": 7, "points_per_pass": 33, "noise": 0.1, "seed": 4}):
        for g, w in zip(spacetime.generate_passes(**kw), jspacetime.generate_passes(**kw),
                        strict=True):
            np.testing.assert_array_equal(g, w, strict=True)


SMALL = dict(m_side=8, n_grid=4, batch_size=512, n_iters=ITERS)


@pytest.fixture(scope="module")
def spacetime_runs():
    with jax.enable_x64(False):
        want = jspacetime.run(**SMALL)
        n = jspacetime.generate_passes()[0].shape[0]
        table = jax_minibatch_indices(0, n, SMALL["batch_size"], ITERS)
    with port_minibatches(table):
        got = spacetime.run(device="cpu", **SMALL)
    return got, want


def test_spacetime_matches_jax(spacetime_runs):
    got, want = spacetime_runs
    assert set(want) <= set(got)
    assert (got["n_obs"], got["m_total"]) == (want["n_obs"], want["m_total"]) == (5385, 512)
    assert np.isfinite(got["steps_per_sec"]) and got["steps_per_sec"] > 0
    _close_each(got["final_loss"], want["final_loss"])
    _close_each(got["metrics"], want["metrics"])
    truth = jspacetime.truth_integrals(tuple(
        JaxCellFeature.from_lims(4, 0.0, 1.0).mesh for _ in range(3)))
    assert got["qv_mean"].shape == got["qv_var"].shape == (4, 4, 4)
    # the JAX run keeps its q(v) in its error only: max|mean − truth| moves
    # by at most max|Δmean|, held within RTOL of the product's magnitude
    assert abs(got["qv_max_err"] - want["qv_max_err"]) <= RTOL * np.abs(truth).max()
    np.testing.assert_allclose(np.abs(got["qv_mean"] - truth).max(), got["qv_max_err"])
    assert got["qv_var"].min() > 0


def test_spacetime_q_v_matches_jax_heads(spacetime_runs):
    """The port's q(v) against the JAX package's q(v) of the JAX run's
    trained parameters: the JAX run's trajectory reproduced by its own calls
    (``fit_minibatch`` with the same seed), then ``q_v`` on the 4³ grid."""
    got, _ = spacetime_runs
    with jax.enable_x64(False):
        X, y = jspacetime.generate_passes()
        Xj, yj = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
        feats = tuple(JaxCellFeature.from_lims(8, 0.0, 1.0) for _ in range(3))
        spec = jsvgp.SVGPSpec(kinds=("matern12",) * 3, features=feats,
                              num_data=X.shape[0], variational="kron")
        p0 = jtrain.non_informative_init(spec.init_params(jnp.float32), Xj, yj)
        p_fit, _ = jtrain.fit_minibatch(lambda q, xb, yb: jsvgp.loss(spec, q, xb, yb), p0,
                                        Xj, yj, n_iters=ITERS, batch_size=512,
                                        learning_rate=0.02, seed=0)
        grids = tuple(JaxCellFeature.from_lims(4, 0.0, 1.0) for _ in range(3))
        qv = jax.jit(lambda p: jsvgp.q_v(spec, p, grids, full_cov=False))(p_fit)
    _close_max(got["qv_mean"].reshape(-1), np.asarray(qv.mean))
    _close_max(got["qv_var"].reshape(-1), np.asarray(qv.var))


class _Ran(Exception):
    pass


def test_spacetime_cli(monkeypatch):
    def fake_run(**kwargs):
        raise _Ran(kwargs)

    monkeypatch.setattr(spacetime, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["spacetime", "--iters", "3", "--device", "cpu"])
    with pytest.raises(_Ran) as ran:
        spacetime.main()
    assert ran.value.args[0] == {"n_iters": 3, "outdir": "results/torch/spacetime",
                                 "device": "cpu"}
