"""The port's natural-gradient trainer (``train.fit_natgrad``) against the
JAX package's (``vggp_tpu/train.py:414-524``).

The first five tests mirror ``tests/test_natgrad.py`` on the port: for a
Gaussian likelihood, the full batch and γ = 1, one step lands on the
optimal q(u), whose ELBO is the collapsed bound. The rest hold the port's
trajectories against JAX's in float64 on the CPU at rtol 1e-8: the full
batch, and minibatches whose indices are JAX's own draws (each step's
``randint`` at the key JAX splits off, fed to the port in call order), for
the Gaussian likelihood and the Bernoulli one; the losses every step and
the final hyperparameters, μ and raw_L.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import svgp as jsvgp
from vggp_tpu.utils import gen_1d

from vggp_tpu_torch import convert, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import sgpr, svgp

RTOL_TRAJ = 1e-8


def _setup(n=40, m=8, noise=0.01, seed=0, likelihood="gaussian"):
    """The port's specs (SVGP full family and the collapsed model on the
    same m cells), the JAX SVGP spec, params as numpy and the data."""
    X, y = gen_1d(lambda x: np.sin(4 * x), 0.0, 1.0, n)
    y = y + 0.05 * np.random.default_rng(seed).standard_normal(n)
    if likelihood == "bernoulli":
        y = (y > 0.0).astype(np.float64)
    kw = dict(kinds=("matern12",), num_data=n, variational="full", likelihood=likelihood)
    jspec = jsvgp.SVGPSpec(features=(JaxCellFeature.from_lims(m, 0.0, 1.0),), **kw)
    grid = CellIntegralFeature.from_lims(m, 0.0, 1.0)
    spec_v = svgp.SVGPSpec(features=(grid,), **kw)
    spec_s = sgpr.SGPRSpec(kinds=("matern12",), features=(grid,))
    p = jax.tree.map(np.asarray, jspec.init_params(jnp.float64))
    p["axes"] = ({"variance": np.asarray(1.0), "lengthscale": np.asarray(0.3)},)
    p["noise"] = np.asarray(noise)
    return spec_v, spec_s, jspec, p, X, y


def _t(p_np):
    return convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)


def _xy(X, y):
    return torch.tensor(X), torch.tensor(y)


def test_one_natgrad_step_reaches_collapsed_bound():
    spec_v, spec_s, _, p, X, y = _setup()
    params = _t(p)
    X, y = _xy(X, y)
    collapsed = float(sgpr.elbo(spec_s, {"axes": params["axes"], "noise": params["noise"]}, X, y))
    p1, _ = train.fit_natgrad(spec_v, params, X, y, n_iters=1, gamma=1.0, hyper_lr=0.0)
    with torch.no_grad():
        e1 = float(svgp.elbo(spec_v, p1, X, y))
        e0 = float(svgp.elbo(spec_v, params, X, y))
    assert e1 == pytest.approx(collapsed, rel=1e-8, abs=1e-8)
    assert e0 < collapsed - 1.0


def test_natgrad_hybrid_training_improves_elbo():
    spec_v, spec_s, _, p, X, y = _setup()
    X, y = _xy(X, y)
    p_fit, hist = train.fit_natgrad(spec_v, _t(p), X, y, n_iters=60, gamma=1.0, hyper_lr=0.05)
    losses = hist["loss"].numpy()
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0
    p_fin, _ = train.fit_natgrad(spec_v, p_fit, X, y, n_iters=1, gamma=1.0, hyper_lr=0.0)
    with torch.no_grad():
        collapsed = float(sgpr.elbo(spec_s, {"axes": p_fin["axes"], "noise": p_fin["noise"]},
                                    X, y))
        achieved = float(svgp.elbo(spec_v, p_fin, X, y))
    assert achieved == pytest.approx(collapsed, rel=1e-6, abs=1e-6)


def test_natgrad_minibatch_runs():
    spec_v, _, _, p, X, y = _setup(n=60)
    X, y = _xy(X, y)
    _, hist = train.fit_natgrad(spec_v, _t(p), X, y, n_iters=50, gamma=0.3, hyper_lr=0.02,
                                batch_size=20)
    assert torch.isfinite(hist["loss"]).all()


def test_elbo_muS_consistent_with_elbo():
    spec_v, _, _, p, X, y = _setup()
    params = _t(p)
    X, y = _xy(X, y)
    L = svgp.chol_from_raw(params["q"]["raw_L"])
    a = float(svgp.elbo_muS(spec_v, params, params["q"]["mu"], L @ L.T, X, y))
    assert a == pytest.approx(float(svgp.elbo(spec_v, params, X, y)), rel=1e-10)


def test_natgrad_rejects_kron_family():
    grid = CellIntegralFeature.from_lims(4, 0.0, 1.0)
    spec = svgp.SVGPSpec(kinds=("matern12", "matern12"), features=(grid, grid), num_data=10,
                         variational="kron")
    params = spec.init_params(torch.float64, "cpu")
    with pytest.raises(ValueError, match="full variational family"):
        train.fit_natgrad(spec, params, torch.zeros((4, 2), dtype=torch.float64),
                          torch.zeros(4, dtype=torch.float64), 1)


def _jax_indices(seed, n_iters, batch, n):
    """JAX's minibatch indices: per step ``key, sub = split(key)``, then
    ``randint(sub, (batch,), 0, n)``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (batch,), 0, n)))
    return out


@pytest.mark.parametrize("likelihood,batch", [("gaussian", None), ("gaussian", 16),
                                              ("bernoulli", None), ("bernoulli", 16)])
def test_natgrad_trajectory_matches_jax(likelihood, batch, monkeypatch):
    """12 hybrid steps (γ 0.5 for the Gaussian likelihood, 0.3 for the
    Bernoulli; Adam at 0.02) from the same start in both packages: every
    loss and the final parameters, q's μ and raw_L included, at rtol 1e-8.
    Minibatches of 16 of the 40 points use JAX's index draws in both."""
    n_iters, gamma = 12, 0.5 if likelihood == "gaussian" else 0.3
    spec_v, _, jspec, p, X, y = _setup(likelihood=likelihood)
    if batch is not None:
        rows = iter(_jax_indices(3, n_iters, batch, len(y)))
        monkeypatch.setattr(train, "_randint",
                            lambda gen, n, size, device: torch.as_tensor(next(rows)))
    kw = dict(n_iters=n_iters, gamma=gamma, hyper_lr=0.02, batch_size=batch, seed=3)
    jfin, jhist = jtrain.fit_natgrad(jspec, jax.tree.map(jnp.asarray, p), jnp.asarray(X),
                                     jnp.asarray(y), **kw)
    tX, ty = _xy(X, y)
    tfin, thist = train.fit_natgrad(spec_v, _t(p), tX, ty, **kw)
    for k in ("loss", "elbo"):
        np.testing.assert_allclose(thist[k].numpy(), np.asarray(jhist[k]), rtol=RTOL_TRAJ)
    for g, w in zip(train.sorted_leaves(tfin), jax.tree.leaves(jfin), strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL_TRAJ,
                                   atol=RTOL_TRAJ * max(np.abs(w).max(), 1.0))


def test_natgrad_guard_drops_a_step_that_leaves_s_indefinite():
    """A step whose −2θ₂ is not positive definite (γ = 50 overshoots) is
    dropped on the device, as JAX's guard drops it: the losses stay finite
    and equal JAX's, q stays a valid Gaussian."""
    spec_v, _, jspec, p, X, y = _setup()
    kw = dict(n_iters=3, gamma=50.0, hyper_lr=0.0)
    jfin, jhist = jtrain.fit_natgrad(jspec, jax.tree.map(jnp.asarray, p), jnp.asarray(X),
                                     jnp.asarray(y), **kw)
    tX, ty = _xy(X, y)
    tfin, thist = train.fit_natgrad(spec_v, _t(p), tX, ty, **kw)
    np.testing.assert_allclose(thist["loss"].numpy(), np.asarray(jhist["loss"]), rtol=RTOL_TRAJ)
    assert torch.isfinite(thist["loss"]).all()
    assert thist["loss"][1] == thist["loss"][2]      # the second step was dropped
    np.testing.assert_allclose(tfin["q"]["mu"].numpy(), np.asarray(jfin["q"]["mu"]),
                               rtol=RTOL_TRAJ, atol=1e-12)


def test_elbo_muS_is_nan_at_an_indefinite_S_as_jax():
    """At an S that is not positive definite ``elbo_muS`` gives NaN, as the
    JAX package's (its Cholesky's NaN), so a natural-gradient guard can drop
    the step: no error."""
    spec_v, _, jspec, p, X, y = _setup()
    S = -np.eye(8)
    jv = jsvgp.elbo_muS(jspec, jax.tree.map(jnp.asarray, p), jnp.zeros(8), jnp.asarray(S),
                        jnp.asarray(X), jnp.asarray(y))
    tX, ty = _xy(X, y)
    tv = svgp.elbo_muS(spec_v, _t(p), torch.zeros(8, dtype=torch.float64), torch.tensor(S),
                       tX, ty)
    assert np.isnan(float(jv)) and bool(torch.isnan(tv))
