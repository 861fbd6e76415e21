"""The port's object facade (``vggp_tpu_torch.api``: ``GP``, ``SVGP``,
``Streaming``) against the JAX package's (``vggp_tpu/api.py``).

One counterpart for each test of ``tests/test_api.py``, on the same numpy
data from a seed, with the port's facade on the CPU. The facades run in
float64 (the JAX one given ``spec.init_params(jnp.float64)`` and
``initialise=True``, the port's ``dtype=torch.float64``). A fit is held
against the JAX facade's fit at ``RTOL_FIT`` 1e-6 (torch.optim.Adam against
optax.adam, the bound of ``test_torch_sgpr.py``); every head is held at
``RTOL`` 1e-10 against the JAX facade's on the same params and data, the
JAX facade's heads of a test traced into one jitted program. Minibatches
take JAX's indices through ``train._randint``; the pathwise, Laplace and
HMC draws come from one numpy table patched into both packages (the
helpers of ``test_torch_samplers.py``, ``test_torch_pathwise.py`` and
``test_torch_hyperpost.py``). ``sample_q_v`` adds a learned mean's cell
integrals and draws a coregion spec, where JAX's does neither (ROADMAP
queue 3, item 14): those draws are held against JAX's plus JAX's
``grid_mean``, and by their moments against ``q_v``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import api as japi
from vggp_tpu import hyperpost as jhyper
from vggp_tpu import streaming as jstreaming
from vggp_tpu.models import common as jcommon
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import convert, hyperpost, train
from vggp_tpu_torch.api import GP, SVGP, Streaming
from vggp_tpu_torch.features import CellIntegralFeature, FourierFeature, PointFeature
from vggp_tpu_torch.models import common, exact, freesvgp

import test_torch_hyperpost as thp
import test_torch_pathwise as tpw
import test_torch_samplers as tsm

RTOL = 1e-10
RTOL_FIT = 1e-6
F64 = dict(device="cpu", dtype=torch.float64)
F = tsm.F   # the features of a patched pathwise draw table


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rtol=RTOL, scale=0.0):
    """Within rtol of ``want``, absolutely within rtol of the larger of
    max|want| and ``scale``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), scale))


def _gauss_close(got, want, rtol=RTOL, var_scale=0.0):
    """Mean and variance; ``var_scale`` the variance's scale where it is a
    cancellation residue (p(v | u) on the model's own cells)."""
    _close(got.mean, want.mean, rtol)
    _close(got.variance(), want.variance(), rtol, var_scale)


def _tree_close(got, want, rtol=RTOL):
    for g, w in zip(train.sorted_leaves(got), jax.tree.leaves(want), strict=True):
        _close(g, w, rtol)


def _to_np(tree):
    """A parameter tree of tensors or JAX arrays as numpy arrays."""
    return train.tree_map(_np, tree)


def _jax64(jm):
    """The JAX facade ``jm`` rebuilt on float64 ``spec.init_params``."""
    return type(jm)(jm.spec, params=jm.spec.init_params(jnp.float64))


def _held(tm, X, y):
    """Attach (X, y) to a port GP facade without moving its params."""
    return tm.fit(X, y, n_iters=0, initialise=False)


def _jheads(cls, spec, params, data, calls):
    """JAX facade heads in one jitted program: a ``cls`` facade on ``params``
    (and ``data`` when given) → ``calls(facade)``, a pytree of arrays."""
    def run(p, d):
        jm = cls(spec, params=p)
        if d is not None:
            jm._X, jm._y = d
        return calls(jm)

    d = None if data is None else tuple(jnp.asarray(a) for a in data)
    return jax.jit(run)(jax.tree.map(jnp.asarray, _to_np(params)), d)


def _same_spec(tspec, jspec):
    """The port's spec holds the JAX spec's fields and features."""
    for f in ("kinds", "num_data", "variational", "likelihood", "learn_mean",
              "per_output_noise", "m"):
        assert getattr(tspec, f, None) == getattr(jspec, f, None), f
    tf, jf = getattr(tspec, "features", ()), getattr(jspec, "features", ())
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        assert type(a).__name__ == type(b).__name__ and a.m == b.m
        for attr in ("mesh", "z_init", "knots"):
            if getattr(b, attr, None) is not None:
                np.testing.assert_array_equal(np.asarray(getattr(a, attr)),
                                              np.asarray(getattr(b, attr)))


def _jax_indices(seed, n_iters, batch, n):
    """JAX's minibatch indices: per step ``key, sub = split(key)``, then
    ``randint(sub, (batch,), 0, n)``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (batch,), 0, n)))
    return out


def _feed_indices(monkeypatch, rows):
    rows = iter(rows)
    monkeypatch.setattr(train, "_randint",
                        lambda gen, n, size, device: torch.as_tensor(next(rows)))


@pytest.fixture(scope="module")
def data1d():
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, 50)
    y = np.sin(4 * X) + 0.05 * rng.standard_normal(50)
    return X, y


@pytest.fixture(scope="module")
def data2d():
    rng = np.random.default_rng(1)
    X = rng.uniform(0.0, 1.0, (200, 2))
    y = np.sin(4 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.standard_normal(200)
    return X, y


# --------------------------------------------------------------------------- #
# GP
# --------------------------------------------------------------------------- #

def test_gridded_fit_matches_jax(data1d):
    """``gridded`` + ``fit`` (fresh params: non-informative init, 40 Adam
    steps) against the JAX facade's fit at RTOL_FIT, every history entry
    too; then ``elbo``, ``q_v`` and ``predict(predictive=True)`` on JAX's
    fitted params at RTOL, and ``p_v_u`` on cells shifted by half a cell."""
    X, y = data1d
    tm = GP.gridded(10, (0.0, 1.0), **F64).fit(X, y, n_iters=40, learning_rate=0.05)
    jm = _jax64(japi.GP.gridded(10, (0.0, 1.0))).fit(
        jnp.asarray(X), jnp.asarray(y), n_iters=40, learning_rate=0.05, initialise=True)
    _same_spec(tm.spec, jm.spec)
    _tree_close(tm.params, jm.params, RTOL_FIT)
    assert sorted(tm.history) == sorted(jm.history)
    for k in jm.history:
        _close(tm.history[k], jm.history[k], RTOL_FIT)
    xs = np.linspace(0.0, 1.0, 9)
    tm = _held(GP(tm.spec, params=_to_np(jm.params), **F64), X, y)
    shifted = japi.CellIntegralFeature.from_lims(10, 0.05, 1.05)
    want = _jheads(japi.GP, jm.spec, jm.params, (X, y), lambda m: (
        -m._mod.loss(m.spec, m.params, m._X, m._y), m.q_v(),
        m.predict(jnp.asarray(xs), predictive=True), m.p_v_u(shifted)))
    _close(tm.elbo(), want[0])
    _gauss_close(tm.q_v(), want[1])
    _gauss_close(tm.predict(xs, predictive=True), want[2])
    _gauss_close(tm.p_v_u(CellIntegralFeature.from_lims(10, 0.05, 1.05)), want[3])


def test_factories_build_expected_specs():
    """Every factory builds the JAX factory's spec; the same arguments
    raise."""
    cases = [("gridded", ((6, 5), ((0.0, 1.0), (-1.0, 2.0))), {"kinds": ("matern12", "matern32")}),
             ("vff", (8, (0.0, 1.0)), {"kinds": "matern52", "ndim": 2}),
             ("svgp", (7, (0.0, 1.0)), {}),
             ("asvgp", ((6, 7, 8), (0.0, 1.0)), {"kinds": ("matern12", "matern32", "matern52")}),
             ("exact", (), {"ndim": 2}),
             ("additive", ((6, 5), (0.0, 1.0)), {}),
             ("free_z", (5, ((0.0, 1.0), (0.0, 2.0))), {"seed": 3}),
             ("multioutput", ((4, 3), (0.0, 1.0), 2), {"per_output_noise": True})]
    for name, args, kw in cases:
        tm = getattr(GP, name)(*args, **kw, **F64)
        jm = getattr(japi.GP, name)(*args, **kw)
        _same_spec(tm.spec, jm.spec)
    assert isinstance(GP.svgp(7, (0.0, 1.0), **F64).spec.features[0], PointFeature)
    assert isinstance(GP.vff(8, (0.0, 1.0), **F64).spec.features[0], FourierFeature)
    assert isinstance(GP.exact(ndim=2, **F64).spec, exact.ExactGPSpec)
    for name, args, kw in (("asvgp", (10, (0.0, 1.0)), {"kinds": "rbf"}),
                           ("gridded", (6, ((0.0, 1.0),)), {"ndim": 2})):
        with pytest.raises(ValueError):
            getattr(japi.GP, name)(*args, **kw)
        with pytest.raises(ValueError):
            getattr(GP, name)(*args, **kw, **F64)


def test_predict_before_fit_raises():
    for m in (japi.GP.gridded(6, (0.0, 1.0)), GP.gridded(6, (0.0, 1.0), **F64)):
        with pytest.raises(ValueError, match="fit"):
            m.predict(np.zeros((3,)))


def test_q_v_requires_cell_axes_or_explicit_grid(data1d):
    """A VFF model's ``q_v`` needs explicit ``grid_axes`` (a single feature
    wraps to a 1-tuple); the head on the port's fitted params equals the
    JAX facade's."""
    X, y = data1d
    tm = GP.vff(8, (-0.3, 1.3), **F64).fit(X, y, n_iters=10)
    with pytest.raises(ValueError, match="grid_axes"):
        tm.q_v()
    qv = tm.q_v(CellIntegralFeature.from_lims(8, 0.0, 1.0))
    assert qv.mean.shape == (8,)
    jspec = japi.GP.vff(8, (-0.3, 1.3)).spec
    jgrid = japi.CellIntegralFeature.from_lims(8, 0.0, 1.0)
    _gauss_close(qv, _jheads(japi.GP, jspec, tm.params, (X, y), lambda m: m.q_v(jgrid)))


def test_exact_facade_q_v(data1d):
    X, y = data1d
    tm = GP.exact(**F64).fit(X, y, n_iters=10)
    grid = CellIntegralFeature.from_lims(6, 0.0, 1.0)
    jgrid = japi.CellIntegralFeature.from_lims(6, 0.0, 1.0)
    want = _jheads(japi.GP, japi.GP.exact().spec, tm.params, (X, y),
                   lambda m: (m.q_v(jgrid), m.q_dv(jgrid)))
    _gauss_close(tm.q_v(grid), want[0])
    _gauss_close(tm.q_dv(grid), want[1])
    with pytest.raises(ValueError, match="inducing"):
        tm.q_u()
    with pytest.raises(ValueError, match="inducing"):
        tm.p_v_u(grid)


def test_sampling_and_qdv_delegate(data1d, monkeypatch):
    """``sample`` and ``sample_q_v`` from one patched draw table, and
    ``q_dv``, against the JAX facade's on the port's fitted params."""
    X, y = data1d
    tm = GP.gridded(8, (0.0, 1.0), **F64).fit(X, y, n_iters=10)
    jspec = japi.GP.gridded(8, (0.0, 1.0)).spec
    key = jax.random.PRNGKey(3)
    xs = np.linspace(0.0, 1.0, 5)
    tsm._patch_draws(monkeypatch, "collapsed", jspec, key, 4)
    s = tm.sample(torch.Generator(), xs, n_samples=4, n_features=F)
    s_ref = _jheads(japi.GP, jspec, tm.params, (X, y),
                    lambda m: m.sample(key, jnp.asarray(xs), n_samples=4, n_features=F))
    _close(s, s_ref)
    tsm._patch_draws(monkeypatch, "collapsed", jspec, key, 3)
    sv = tm.sample_q_v(torch.Generator(), n_samples=3, n_features=F)
    sv_ref = _jheads(japi.GP, jspec, tm.params, (X, y),
                     lambda m: m.sample_q_v(key, n_samples=3, n_features=F))
    assert sv.shape == (3, 8)
    _close(sv, sv_ref)
    _gauss_close(tm.q_dv(axis=0), _jheads(japi.GP, jspec, tm.params, (X, y),
                                          lambda m: m.q_dv(axis=0)))


def test_checkpoint_roundtrip(tmp_path, data1d):
    """``save`` → ``restore`` is bitwise, keeps the params' device and
    dtype, and the restored facade's ELBO equals the JAX facade's."""
    X, y = data1d
    tm = GP.gridded(6, (0.0, 1.0), **F64).fit(X, y, n_iters=15)
    tm.save(str(tmp_path / "ckpt"), step=2)
    t2 = GP.gridded(6, (0.0, 1.0), **F64).restore(str(tmp_path / "ckpt"), step=2)
    for a, b in zip(train.sorted_leaves(tm.params), train.sorted_leaves(t2.params),
                    strict=True):
        assert torch.equal(a, b) and b.dtype == torch.float64 and b.device.type == "cpu"
    assert not t2._params_are_fresh
    _held(t2, X, y)
    want = _jheads(japi.GP, japi.GP.gridded(6, (0.0, 1.0)).spec, tm.params, (X, y),
                   lambda m: -m._mod.loss(m.spec, m.params, m._X, m._y))
    assert tm.elbo() == t2.elbo()
    _close(t2.elbo(), want)


def test_factories_infer_ndim_from_count_sequence():
    """A sequence count, lims pairs or kinds set ndim as in JAX; mismatches
    raise in both."""
    for name, args, kw in (("gridded", ((6, 5), (0.0, 1.0)), {}),
                           ("vff", ((4, 3), (0.0, 1.0)), {}),
                           ("svgp", ((7, 7), (0.0, 1.0)), {}),
                           ("gridded", (6, (0.0, 1.0)), {"kinds": ("matern12", "matern32")})):
        tm = getattr(GP, name)(*args, **kw, **F64)
        assert tm.spec.ndim == 2
        _same_spec(tm.spec, getattr(japi.GP, name)(*args, **kw).spec)
    for args in (((6, 5, 4), ((0.0, 1.0), (0.0, 1.0))), ((6, 0), (0.0, 1.0))):
        with pytest.raises(ValueError):
            japi.GP.gridded(*args)
        with pytest.raises(ValueError):
            GP.gridded(*args, **F64)


def test_fit_keeps_user_supplied_params(data1d):
    """``fit`` keeps supplied params (a sentinel noise survives a
    zero-rate step); fresh params take JAX's non-informative init;
    ``initialise=True`` forces it."""
    X, y = data1d
    spec = GP.gridded(6, (0.0, 1.0), **F64).spec
    p = spec.init_params(torch.float64, "cpu")
    p["noise"] = torch.tensor(123.0, dtype=torch.float64)
    m = GP(spec, params=p, **F64).fit(X, y, n_iters=1, learning_rate=0.0)
    assert float(m.params["noise"]) == pytest.approx(123.0, rel=1e-12)
    m2 = GP(spec, **F64).fit(X, y, n_iters=1, learning_rate=0.0)
    jspec = japi.GP.gridded(6, (0.0, 1.0)).spec
    j0 = jax.tree.map(np.asarray, jax.jit(lambda X, y: japi.train.non_informative_init(
        jspec.init_params(jnp.float64), X, y))(jnp.asarray(X), jnp.asarray(y)))
    _tree_close(m2.params, j0, 1e-12)
    m3 = GP(spec, params=p, **F64).fit(X, y, n_iters=1, learning_rate=0.0, initialise=True)
    _tree_close(m3.params, j0, 1e-12)


def test_q_v_cache_hits_on_equal_grids(data1d, tmp_path):
    """Equal-but-distinct grids give identical ``q_v`` (no program cache to
    count in the port), equal to the JAX facade's; ``fit`` and ``restore``
    drop every cached state (``_w``, ``_laplace``, ``_hmc``)."""
    X, y = data1d
    m = GP.gridded(6, (0.0, 1.0), **F64).fit(X, y, n_iters=5)
    g1 = CellIntegralFeature.from_lims(4, 0.0, 1.0)
    g2 = CellIntegralFeature.from_lims(4, 0.0, 1.0)
    assert g1 is not g2
    q1, q2 = m.q_v((g1,)), m.q_v((g2,))
    assert torch.equal(q1.mean, q2.mean) and torch.equal(q1.var, q2.var)
    jg = japi.CellIntegralFeature.from_lims(4, 0.0, 1.0)
    _gauss_close(q1, _jheads(japi.GP, japi.GP.gridded(6, (0.0, 1.0)).spec, m.params, (X, y),
                             lambda j: j.q_v((jg,))))
    m.save(str(tmp_path / "c"))
    for step in (lambda: m.fit(X, y, n_iters=1), lambda: m.restore(str(tmp_path / "c"))):
        m.solve_iterative()
        m.laplace()
        m._hmc = ("settings", None)
        step()
        assert m._w is None and m._laplace is None and m._hmc is None


def test_gp_facade_raises_without_cuda(monkeypatch):
    """A facade built with no ``device`` runs on the card and raises where
    there is none; ``device="cpu"`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: GP.gridded(6, (0.0, 1.0)),
                  lambda: SVGP.gridded((4, 4), (0.0, 1.0), num_data=10),
                  lambda: Streaming(SVGP.gridded(6, (0.0, 1.0), num_data=10, **F64).spec,
                                    SVGP.gridded(6, (0.0, 1.0), num_data=10, **F64).params)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert GP.gridded(6, (0.0, 1.0), device="cpu").params["noise"].device.type == "cpu"


# --------------------------------------------------------------------------- #
# SVGP / Streaming
# --------------------------------------------------------------------------- #

def test_svgp_facade_matches_functional_core(data2d, monkeypatch, tmp_path):
    """``SVGP.gridded`` (the Kronecker family at ndim 2) + ``fit`` on JAX's
    minibatch indices against the JAX facade's fit at RTOL_FIT; every head
    cold (``q_v``, ``predict``, ``q_u``, ``p_v_u``, ``prior``, ``q_dv``,
    ``elbo``) and warm after ``precompute`` on JAX's params at RTOL;
    ``save`` → ``restore`` bitwise, dropping the warm state."""
    X, y = data2d
    tm = SVGP.gridded((8, 8), (0.0, 1.0), num_data=200, **F64)
    assert tm.spec.variational == "kron"
    _feed_indices(monkeypatch, _jax_indices(0, 30, 64, 200))
    tm.fit(X, y, n_iters=30, batch_size=64, learning_rate=0.05, seed=0)
    jm = _jax64(japi.SVGP.gridded((8, 8), (0.0, 1.0), num_data=200)).fit(
        jnp.asarray(X), jnp.asarray(y), n_iters=30, batch_size=64, learning_rate=0.05,
        seed=0, initialise=True)
    _same_spec(tm.spec, jm.spec)
    _tree_close(tm.params, jm.params, RTOL_FIT)
    _close(tm.history["loss"], jm.history["loss"], RTOL_FIT)
    tm = SVGP(tm.spec, params=_to_np(jm.params), **F64)
    xs = np.random.default_rng(2).uniform(0, 1, (7, 2))
    jxs = jnp.asarray(xs)
    want = _jheads(japi.SVGP, jm.spec, jm.params, None, lambda m: (
        m.q_v(), m.predict(jxs, predictive=True), m.q_u(), m.p_v_u(), m.prior(jxs),
        m.q_dv(axis=1), jsvgp.elbo(m.spec, m.params, jnp.asarray(X), jnp.asarray(y))))
    heads = lambda: (tm.q_v(), tm.predict(xs, predictive=True), tm.q_u(), tm.p_v_u(),
                     tm.prior(xs), tm.q_dv(axis=1))
    prior_var = float(np.max(np.asarray(want[4].variance())))
    for got, w in zip(heads(), want):
        _gauss_close(got, w, var_scale=prior_var)
    _close(tm.elbo(X, y), want[-1])
    assert np.all(_np(tm.q_v().var) > 0)
    tm.precompute()
    assert tm._state is not None
    for got, w in zip(heads(), want):
        _gauss_close(got, w, var_scale=prior_var)
    tm.save(str(tmp_path))
    back = SVGP.gridded((8, 8), (0.0, 1.0), num_data=200, **F64).restore(str(tmp_path))
    assert back._state is None and not back._params_are_fresh
    for a, b in zip(train.sorted_leaves(tm.params), train.sorted_leaves(back.params),
                    strict=True):
        assert torch.equal(a, b)
    tm.restore(str(tmp_path))
    assert tm._state is None
    _gauss_close(back.q_v(), want[0])


def test_svgp_facade_heads_match_jax(data2d, monkeypatch):
    """The heads the JAX test leaves out, on a Matérn-3/2 full-family SVGP
    with a learned mean under a Poisson likelihood: ``posterior_grad`` cold
    and warm, ``predict_y``, ``sample`` from one draw table, and
    ``sample_q_v``: JAX's draws plus JAX's ``grid_mean`` (the port adds the
    learned mean's cell integrals; ROADMAP queue 3, item 14)."""
    X, _ = data2d
    kw = dict(num_data=200, kinds="matern32", variational="full", likelihood="poisson",
              learn_mean=True)
    jm = japi.SVGP.gridded((5, 4), (0.0, 1.0), **kw)
    rng = np.random.default_rng(5)
    p = jax.tree.map(np.asarray, jm.spec.init_params(jnp.float64))
    p["q"] = {"mu": 0.3 * rng.standard_normal(20),
              "raw_L": np.tril(0.2 * rng.standard_normal((20, 20)), -1) - 0.5 * np.eye(20)}
    p["mean"] = np.asarray(0.4)
    tm = SVGP(SVGP.gridded((5, 4), (0.0, 1.0), **kw, **F64).spec, params=p, **F64)
    xs, jxs = X[:9], jnp.asarray(X[:9])
    key = jax.random.PRNGKey(4)
    want = _jheads(japi.SVGP, jm.spec, p, None, lambda m: (
        m.posterior_grad(jxs, axis=1), m.predict_y(jxs),
        jcommon.grid_mean(m.spec, m.params, m.spec.features)))
    _gauss_close(tm.posterior_grad(xs, axis=1), want[0])
    _tree_close(tm.predict_y(xs), want[1])
    tsm._patch_draws(monkeypatch, "svgp full", jm.spec, key, 3)
    _close(tm.sample(torch.Generator(), xs, n_samples=3, n_features=F),
           _jheads(japi.SVGP, jm.spec, p, None,
                   lambda m: m.sample(key, jxs, n_samples=3, n_features=F)))
    tsm._patch_draws(monkeypatch, "svgp full", jm.spec, key, 3)
    sv = tm.sample_q_v(torch.Generator(), n_samples=3, n_features=F)
    sv_ref = _jheads(japi.SVGP, jm.spec, p, None,
                     lambda m: m.sample_q_v(key, n_samples=3, n_features=F))
    _close(sv, np.asarray(sv_ref) + np.asarray(want[2]), 1e-12)
    tm.precompute()
    _gauss_close(tm.posterior_grad(xs, axis=1), want[0])


def test_svgp_fit_natgrad_matches_jax(data1d, monkeypatch):
    """``fit_natgrad`` (fresh params: non-informative init; 12 hybrid steps
    on minibatches of 16, JAX's indices) against the JAX facade's at 1e-8
    (the bound of ``test_torch_natgrad.py``): every loss and the final
    params, q's μ and raw_L included."""
    X, y = data1d
    kw = dict(n_iters=12, gamma=0.5, hyper_lr=0.02, batch_size=16, seed=3)
    tm = SVGP.gridded(8, (0.0, 1.0), num_data=50, **F64)
    _feed_indices(monkeypatch, _jax_indices(3, 12, 16, 50))
    tm.fit_natgrad(X, y, **kw)
    jm = _jax64(japi.SVGP.gridded(8, (0.0, 1.0), num_data=50)).fit_natgrad(
        jnp.asarray(X), jnp.asarray(y), initialise=True, **kw)
    _tree_close(tm.params, jm.params, 1e-8)
    _close(tm.history["loss"], jm.history["loss"], 1e-8)
    assert tm._state is None and not tm._params_are_fresh


def test_svgp_facade_fit_keeps_supplied_params(data2d):
    X, y = data2d
    spec = SVGP.gridded((4, 4), (0.0, 1.0), num_data=200, **F64).spec
    p = spec.init_params(torch.float64, "cpu")
    p["noise"] = torch.tensor(123.0, dtype=torch.float64)
    m = SVGP(spec, params=p, **F64).fit(X, y, n_iters=1, batch_size=32, learning_rate=0.0)
    assert float(m.params["noise"]) == pytest.approx(123.0, rel=1e-12)
    m2 = SVGP(spec, **F64).fit(X, y, n_iters=1, batch_size=32, learning_rate=0.0)
    jspec = japi.SVGP.gridded((4, 4), (0.0, 1.0), num_data=200).spec
    j0 = jax.tree.map(np.asarray, jax.jit(lambda X, y: japi.train.non_informative_init(
        jspec.init_params(jnp.float64), X, y))(jnp.asarray(X), jnp.asarray(y)))
    _tree_close(m2.params, j0, 1e-12)


def test_svgp_spec_rejected_by_gp_facade():
    spec = SVGP.gridded((4, 4), (0.0, 1.0), num_data=10, **F64).spec
    with pytest.raises(TypeError, match="api.SVGP"):
        GP(spec, **F64)
    with pytest.raises(TypeError, match="SVGPSpec"):
        SVGP(GP.gridded(4, (0.0, 1.0), **F64).spec, **F64)
    with pytest.raises(TypeError, match="api.SVGP"):
        japi.GP(japi.SVGP.gridded((4, 4), (0.0, 1.0), num_data=10).spec)


def test_streaming_facade_matches_functional_core(data1d):
    """``streaming`` (the full family at ndim 1) assimilates two chunks,
    then ``forget`` and ``reanchor``: Λ, η and n_seen, ``predict``, ``q_v``
    and ``to_svgp().predict`` against the JAX functional stream (the JAX
    facade's calls) in one jitted program, at RTOL."""
    X, y = data1d
    m = SVGP.gridded(12, (0.0, 1.0), num_data=50, **F64)
    assert m.spec.variational == "full"
    m.non_informative_initialise(X, y)
    s = m.streaming(dtype=torch.float64)
    s.assimilate(X[:25], y[:25]).assimilate(X[25:], y[25:])
    assert s.n_seen == 50
    jspec = japi.SVGP.gridded(12, (0.0, 1.0), num_data=50).spec
    p_new = {**_to_np(m.params), "noise": np.asarray(0.01),
             "axes": ({"variance": np.asarray(0.9), "lengthscale": np.asarray(0.2)},)}
    xs = np.linspace(0.0, 1.0, 9)
    jgrid = japi.CellIntegralFeature.from_lims(6, 0.0, 1.0)

    def jstream(p, pn, X, y, xs):
        st = jstreaming.init_state(jspec, jnp.float64)
        st = jstreaming.assimilate(jspec, p, st, X[:25], y[:25])
        st1 = jstreaming.assimilate(jspec, p, st, X[25:], y[25:])
        q1 = jstreaming.to_params(jspec, p, st1)
        st2 = jstreaming.reanchor(jspec, p, pn, jstreaming.forget(st1, 0.7))
        return (st1, jsvgp.posterior(jspec, q1, xs), jsvgp.q_v(jspec, q1, (jgrid,)),
                st2, jsvgp.posterior(jspec, jstreaming.to_params(jspec, pn, st2), xs))

    want = jax.jit(jstream)(*(jax.tree.map(jnp.asarray, a) for a in (
        _to_np(m.params), p_new, X, y, xs)))
    _close(s.state["lam"], want[0]["lam"])
    _close(s.state["eta"], want[0]["eta"])
    _gauss_close(s.predict(xs), want[1])
    _gauss_close(s.to_svgp().predict(xs), want[1])
    qv = s.q_v(CellIntegralFeature.from_lims(6, 0.0, 1.0))
    _gauss_close(qv, want[2])
    assert np.all(_np(qv.var) > 0)
    s.forget(0.7).reanchor(p_new)
    _close(s.state["lam"], want[3]["lam"])
    _close(s.state["eta"], want[3]["eta"])
    _gauss_close(s.predict(xs), want[4])


def test_additive_and_sum_facades(data2d):
    X, y = data2d
    m = GP.additive((6, 5), (0.0, 1.0), **F64).fit(X, y, n_iters=10, learning_rate=0.05)
    want = _jheads(japi.GP, japi.GP.additive((6, 5), (0.0, 1.0)).spec, m.params, (X, y),
                   lambda j: (-j._mod.loss(j.spec, j.params, j._X, j._y), j.q_v(), j.q_u()))
    _close(m.elbo(), want[0])
    _gauss_close(m.q_v(), want[1])
    _gauss_close(m.q_u(), want[2])
    coarse = GP.gridded((4, 4), (0.0, 1.0), **F64).spec
    fine = GP.gridded((8, 8), (0.0, 1.0), **F64)   # GP instances are unwrapped
    ms = GP.sum([coarse, fine], **F64).fit(X, y, n_iters=10, learning_rate=0.05)
    jsum = japi.GP.sum([japi.GP.gridded((4, 4), (0.0, 1.0)).spec,
                        japi.GP.gridded((8, 8), (0.0, 1.0))]).spec
    want = _jheads(japi.GP, jsum, ms.params, (X, y),
                   lambda j: (-j._mod.loss(j.spec, j.params, j._X, j._y), j.q_v()))
    _close(ms.elbo(), want[0])
    qv = ms.q_v()
    assert qv.mean.shape == (16,)
    _gauss_close(qv, want[1])
    with pytest.raises(TypeError, match="SGPRSpec"):
        GP.sum([GP.exact(**F64)], **F64)


def _multioutput_data(data2d, P=2):
    X, y = data2d
    out = np.random.default_rng(3).integers(0, P, X.shape[0]).astype(np.float64)
    return np.concatenate([X, out[:, None]], axis=1), y + 0.5 * out


def test_multioutput_facade(data2d):
    Xo, yo = _multioutput_data(data2d)
    m = GP.multioutput((5, 5), (0.0, 1.0), n_outputs=2, per_output_noise=True, **F64)
    assert m.spec.kinds[-1] == "coregion"
    m.fit(Xo, yo, n_iters=25, learning_rate=0.05)
    jspec = japi.GP.multioutput((5, 5), (0.0, 1.0), n_outputs=2, per_output_noise=True).spec
    _same_spec(m.spec, jspec)
    want = _jheads(japi.GP, jspec, m.params, (Xo, yo), lambda j: (
        -j._mod.loss(j.spec, j.params, j._X, j._y), j.predict(jnp.asarray(Xo[:7])), j.q_v()))
    _close(m.elbo(), want[0])
    _gauss_close(m.predict(Xo[:7]), want[1])
    qv = m.q_v()
    assert qv.mean.shape == (5 * 5 * 2,)
    _gauss_close(qv, want[2])


def test_multioutput_sample_q_v_adds_the_learned_mean(data2d, monkeypatch):
    """``GP.multioutput``'s ``sample_q_v`` (a learned mean per output by
    default): JAX's raises on the coregion axis; the port draws it, and its
    draws minus the same draws with ``common.grid_mean`` taken out (the
    same generator seed) are JAX's ``grid_mean`` at 1e-12 (ROADMAP queue 3,
    item 14)."""
    Xo, yo = _multioutput_data(data2d)
    m = GP.multioutput((5, 5), (0.0, 1.0), n_outputs=2, **F64).fit(Xo, yo, n_iters=5)
    jspec = japi.GP.multioutput((5, 5), (0.0, 1.0), n_outputs=2).spec
    with pytest.raises(NotImplementedError):
        _jheads(japi.GP, jspec, m.params, (Xo, yo),
                lambda j: j.sample_q_v(jax.random.PRNGKey(0), n_samples=2, n_features=F))
    draws = m.sample_q_v(torch.Generator().manual_seed(8), n_samples=4, n_features=F)
    monkeypatch.setattr(common, "grid_mean", lambda spec, params, grid_axes: 0.0)
    base = m.sample_q_v(torch.Generator().manual_seed(8), n_samples=4, n_features=F)
    offset = jcommon.grid_mean(jspec, jax.tree.map(jnp.asarray, _to_np(m.params)),
                               jspec.features)
    assert draws.shape == (4, 50) and float(np.abs(np.asarray(offset)).min()) > 0
    _close(draws - base, np.broadcast_to(np.asarray(offset), (4, 50)), 1e-12)


def test_multioutput_sample_q_v_moments_match_q_v(data2d):
    """The coregion draws are draws of q(v): over 1024 draws (float64)
    their mean is within 5 standard errors of ``q_v``'s everywhere and
    their variance within 20% of it (median 8%), for the collapsed and the
    SVGP facades."""
    Xo, yo = _multioutput_data(data2d)
    tm = GP.multioutput((4, 3), (0.0, 1.0), n_outputs=2, **F64).fit(Xo, yo, n_iters=10)
    sm = SVGP.multioutput((4, 3), (0.0, 1.0), n_outputs=2, num_data=200, **F64)
    sm.fit(Xo, yo, n_iters=20, batch_size=64, learning_rate=0.05)
    S = 1024
    for m in (tm, sm):
        d = _np(m.sample_q_v(torch.Generator().manual_seed(11), n_samples=S, n_features=256))
        g = m.q_v()
        mean, var = _np(g.mean), _np(g.var)
        assert np.all(np.abs(d.mean(0) - mean) <= 5.0 * np.sqrt(var / S))
        rel = np.abs(d.var(0) - var) / var
        assert rel.max() < 0.2 and np.median(rel) < 0.08


def test_svgp_multioutput_accepts_variational_kwarg():
    m = SVGP.multioutput(4, (0.0, 1.0), n_outputs=2, num_data=64, ndim=1,
                         variational="full", **F64)
    assert m.spec.variational == "full" and m.spec.kinds[-1] == "coregion"
    _same_spec(m.spec, japi.SVGP.multioutput(4, (0.0, 1.0), n_outputs=2, num_data=64, ndim=1,
                                             variational="full").spec)
    assert SVGP.multioutput(4, (0.0, 1.0), n_outputs=2, num_data=64, ndim=1,
                            **F64).spec.variational == "kron"


def test_streaming_rejects_noise_on_nonconjugate_spec():
    """Per-point noise on a Poisson stream raises in both; the CVI update
    without it equals JAX's ``assimilate_natgrad`` at RTOL."""
    kw = dict(num_data=32, ndim=1, likelihood="poisson", variational="full")
    s = SVGP.gridded(6, (0.0, 1.0), **kw, **F64).streaming()
    X = np.linspace(0.1, 0.9, 8)
    y = np.ones(8)
    with pytest.raises(ValueError, match="noise"):
        s.assimilate(X, y, noise=np.full((8,), 0.1))
    jm = japi.SVGP.gridded(6, (0.0, 1.0), **kw)
    with pytest.raises(ValueError, match="noise"):
        jm.streaming().assimilate(jnp.asarray(X), jnp.asarray(y), noise=jnp.full((8,), 0.1))
    s.assimilate(X, y, gamma=0.5)
    p = _to_np(s.params)
    want = jax.jit(lambda p, X, y: jstreaming.assimilate_natgrad(
        jm.spec, p, jstreaming.init_state(jm.spec, jnp.float64), X, y, gamma=0.5))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(X), jnp.asarray(y))
    _close(s.state["lam"], want["lam"])
    _close(s.state["eta"], want["eta"])


def test_vff_q_v_on_grid_past_domain(data1d):
    X, y = data1d
    m = GP.vff(8, (0.1, 0.9), kinds="matern32", **F64).fit(X, y, n_iters=10)
    grid = CellIntegralFeature.from_lims(10, 0.0, 1.0)   # extends both sides
    sub = CellIntegralFeature(mesh=np.linspace(0.0, 0.1, 6))
    qv, qv_sub = m.q_v(grid), m.q_v(sub)
    assert qv.mean.shape == (10,) and np.all(_np(qv.var) > 0)
    jg = japi.CellIntegralFeature.from_lims(10, 0.0, 1.0)
    jsub = japi.CellIntegralFeature(mesh=np.linspace(0.0, 0.1, 6))
    want = _jheads(japi.GP, japi.GP.vff(8, (0.1, 0.9), kinds="matern32").spec, m.params,
                   (X, y), lambda j: (j.q_v(jg), j.q_v(jsub)))
    _gauss_close(qv, want[0])
    _gauss_close(qv_sub, want[1])
    np.testing.assert_allclose(float(qv.mean[0]), float(qv_sub.mean.sum()), rtol=1e-4,
                               atol=1e-6)


def test_free_z_facade_matches_functional_core():
    """``free_z``'s points equal JAX's draw; ``predict``, ``q_v`` on
    explicit grids and ``q_u`` equal the JAX facade's; ``q_v()`` raises."""
    rng = np.random.default_rng(2)
    X = rng.random((60, 2))
    y = np.sin(5 * X[:, 0]) * X[:, 1] + 0.05 * rng.standard_normal(60)
    m = GP.free_z(12, ((0.0, 1.0), (0.0, 1.0)), kinds="matern32", seed=4, **F64)
    jm = japi.GP.free_z(12, ((0.0, 1.0), (0.0, 1.0)), kinds="matern32", seed=4)
    assert isinstance(m.spec, freesvgp.FreeSVGPSpec) and m.params["z"].shape == (12, 2)
    _close(m.params["z"], jm.params["z"], 1e-7)    # JAX holds z in float32
    m.fit(X, y, n_iters=10, learning_rate=0.05)
    xs = rng.random((9, 2))
    grids = (CellIntegralFeature.from_lims(5, 0.0, 1.0), CellIntegralFeature.from_lims(4, 0.0, 1.0))
    jgrids = (japi.CellIntegralFeature.from_lims(5, 0.0, 1.0),
              japi.CellIntegralFeature.from_lims(4, 0.0, 1.0))
    want = _jheads(japi.GP, jm.spec, m.params, (X, y), lambda j: (
        j.predict(jnp.asarray(xs)), j.q_v(grid_axes=jgrids), j.q_u()))
    _gauss_close(m.predict(xs), want[0])
    _gauss_close(m.q_v(grid_axes=grids), want[1])
    _gauss_close(m.q_u(), want[2])
    with pytest.raises(ValueError, match="grid_axes"):
        m.q_v()


def test_iterative_facade_matches_qv_mean(data1d):
    """The CG heads (``solve_iterative`` at tol 1e-12) equal the JAX
    facade's at 1e-9 (the bound of ``test_torch_iterative.py``) and the
    dense heads; the default solve's too (test_api's bound); ``fit`` drops
    the cached w."""
    X, y = data1d
    m = GP.gridded(40, (0.0, 1.0), **F64).fit(X, y, n_iters=10, learning_rate=0.05)
    grids = (CellIntegralFeature.from_lims(10, 0.0, 1.0),)
    xs = np.linspace(0.02, 0.98, 11)
    np.testing.assert_allclose(_np(m.q_v_mean_iterative(grids)), _np(m.q_v(grids).mean),
                               rtol=2e-3, atol=1e-5)
    assert m._w is not None
    m.solve_iterative(tol=1e-12, maxiter=4000)
    jg = (japi.CellIntegralFeature.from_lims(10, 0.0, 1.0),)
    jxs = jnp.asarray(xs)

    def jrun(j):
        j.solve_iterative(tol=1e-12, maxiter=4000)
        return j.q_v_mean_iterative(jg), j.predict_mean_iterative(jxs), j.q_v(jg)

    want = _jheads(japi.GP, japi.GP.gridded(40, (0.0, 1.0)).spec, m.params, (X, y), jrun)
    _close(m.q_v_mean_iterative(grids), want[0], 1e-9)
    _close(m.predict_mean_iterative(xs), want[1], 1e-9)
    _close(m.q_v_mean_iterative(grids), want[2].mean, 1e-6)
    m.fit(X, y, n_iters=2, learning_rate=0.01)
    assert m._w is None


MARG_XS = np.linspace(0.1, 0.9, 7)
MARG_SAMPLES = 48


@pytest.fixture(scope="module")
def laplace_case(data1d):
    """GP.gridded(8) fitted 20 steps (its params as numpy) and, on them,
    JAX's Laplace state (the facade's ``laplace``) and JAX's marginalized
    ``predict`` at MARG_XS and ``q_v`` from ``PRNGKey(1)`` draws, in one
    jitted program."""
    X, y = data1d
    params = _to_np(GP.gridded(8, (0.0, 1.0), **F64).fit(
        X, y, n_iters=20, learning_rate=0.05).params)
    jspec = japi.GP.gridded(8, (0.0, 1.0)).spec

    def run(p, X, y, xs):
        loss = lambda q: jsgpr.loss(jspec, q, X, y)
        st = jhyper.laplace(loss, p)
        draws = jhyper.sample_params(st, jax.random.PRNGKey(1), MARG_SAMPLES)
        post = jhyper.predict_marginalized_draws(
            lambda q: jsgpr.posterior(jspec, q, X, y, xs, full_cov=False), draws)
        qv = jhyper.predict_marginalized_draws(
            lambda q: jsgpr.q_v(jspec, q, X, y, jspec.features, full_cov=False), draws)
        return {"mean": st.mean, "chol_cov": st.chol_cov, "logdet_h": st.logdet_h}, post, qv

    st, post, qv = jax.jit(run)(*(jax.tree.map(jnp.asarray, a) for a in (params, X, y, MARG_XS)))
    return params, jax.tree.map(np.asarray, st), post, qv


def _with_jax_laplace(case, X, y):
    """A port facade on the case's params holding JAX's Laplace state as
    its cached ``laplace()`` (one eigenvector sign convention for both)."""
    params, st, _, _ = case
    m = _held(GP(GP.gridded(8, (0.0, 1.0), **F64).spec, params=params, **F64), X, y)
    m._laplace = (1e-8, convert.laplace_state_from_jax(st, params, device="cpu"))
    return m


def test_marginalized_facade_widen_variances(data1d, laplace_case, monkeypatch):
    """``laplace`` equals JAX's (mean, covariance, log|H| at RTOL);
    ``predict_marginalized`` and ``q_v_marginalized`` on JAX's Laplace state
    and JAX's draws equal JAX's at 1e-9 (the bound of
    ``test_torch_hyperpost.py``); they keep the point heads' means to
    leading order with wider variances; ``fit`` drops the state."""
    X, y = data1d
    params, jst, jpost, jqv = laplace_case
    m = _held(GP(GP.gridded(8, (0.0, 1.0), **F64).spec, params=params, **F64), X, y)
    st = m.laplace()
    _close(st.mean, jst["mean"])
    _close(st.chol_cov @ st.chol_cov.T, jst["chol_cov"] @ jst["chol_cov"].T)
    _close(st.logdet_h, jst["logdet_h"])
    m = _with_jax_laplace(laplace_case, X, y)
    p = jst["mean"].shape[0]
    thp._use_draws(monkeypatch, thp._jax_normals(1, (MARG_SAMPLES, p)) * 2)
    point = m.predict(MARG_XS)
    marg = m.predict_marginalized(MARG_XS, n_samples=MARG_SAMPLES, seed=1)
    _gauss_close(marg, jpost, 1e-9)
    _gauss_close(m.q_v_marginalized(n_samples=MARG_SAMPLES, seed=1), jqv, 1e-9)
    assert np.all(_np(marg.var) >= _np(point.var) * 0.5)
    assert float(marg.var.mean()) > float(point.var.mean())
    m.fit(X, y, n_iters=2)
    assert m._laplace is None


def test_laplace_cache_rebuilds_on_different_floor(data1d):
    X, y = data1d
    m = GP.gridded(6, (0.0, 1.0), **F64).fit(X, y, n_iters=10, learning_rate=0.05)
    st1 = m.laplace(min_eig_rel=1e-8)
    assert m.laplace(min_eig_rel=1e-8) is st1
    st2 = m.laplace(min_eig_rel=1e-2)
    assert st2 is not st1 and m.laplace(min_eig_rel=1e-2) is st2


def test_hmc_facade_marginalized_heads(data1d, laplace_case, monkeypatch):
    """``hmc`` and the ``method="hmc"`` heads on JAX's Laplace state and
    JAX's draws. The facade asks the sampler for JAX's settings (256 draws,
    4 chains, 128 warmup steps), which take minutes in the port's Python
    leapfrog on the CPU; here the sampler is shrunk to 2 chains of 4 + 4
    steps of 4 leapfrogs for both packages, and the call the facade made
    is checked. The
    draws, accept rate and step sizes equal JAX's at 1e-8, the thinned
    mixtures at 1e-9; the chain is cached until the params change."""
    X, y = data1d
    m = _with_jax_laplace(laplace_case, X, y)
    jst = laplace_case[1]
    asked = []
    real = hyperpost.hmc_sample_params
    small = dict(n_samples=8, n_chains=2, n_warmup=4, n_leapfrog=4)

    def shrunk(loss_fn, state, gen, n_samples, n_chains, n_warmup, **kw):
        asked.append((n_samples, n_chains, n_warmup))
        return real(loss_fn, state, gen, **small, **kw)

    monkeypatch.setattr(hyperpost, "hmc_sample_params", shrunk)
    p = jst["mean"].shape[0]
    thp._use_draws(monkeypatch, thp._jax_hmc_rows(3, 2, 8, p))
    res = m.hmc(seed=3)
    assert asked == [(256, 4, 128)] and m.hmc(seed=3) is res
    jspec = japi.GP.gridded(8, (0.0, 1.0)).spec
    xs = MARG_XS
    idx = np.linspace(0, 7, 4).astype(np.int32)

    def jrun(p, X, y, mean, chol, logdet, xs):
        loss = lambda q: jsgpr.loss(jspec, q, X, y)
        from jax.flatten_util import ravel_pytree
        _, unravel = ravel_pytree(japi.train.unconstrain(p))
        st = jhyper.LaplaceState(mean=mean, chol_cov=chol, logdet_h=logdet, unravel=unravel)
        r = jhyper.hmc_sample_params(loss, st, jax.random.PRNGKey(3), **small)
        thin = jax.tree.map(lambda a: a[idx], r.draws)
        post = jhyper.predict_marginalized_draws(
            lambda q: jsgpr.posterior(jspec, q, X, y, xs, full_cov=False), thin)
        qv = jhyper.predict_marginalized_draws(
            lambda q: jsgpr.q_v(jspec, q, X, y, jspec.features, full_cov=False), thin)
        return r.raw_draws, r.accept_rate, r.step_size, post, qv

    want = jax.jit(jrun)(*(jax.tree.map(jnp.asarray, a) for a in (
        laplace_case[0], X, y, jst["mean"], jst["chol_cov"], jst["logdet_h"], xs)))
    _close(res.raw_draws, want[0], 1e-8)
    _close(res.accept_rate, want[1], 1e-8)
    _close(res.step_size, want[2], 1e-8)
    assert 0.4 < float(res.accept_rate) <= 1.0
    marg = m.predict_marginalized(xs, n_samples=4, seed=3, method="hmc")
    _gauss_close(marg, want[3], 1e-9)
    _gauss_close(m.q_v_marginalized(n_samples=4, seed=3, method="hmc"), want[4], 1e-9)
    assert asked == [(256, 4, 128)]   # the cached chain serves both heads
    with pytest.raises(ValueError, match="laplace.*hmc|hmc"):
        m.predict_marginalized(xs, method="nuts")
    m.fit(X, y, n_iters=2)
    assert m._hmc is None


def test_iterative_gradient_head_facades(data1d):
    """``q_dv_mean_iterative`` and ``predict_grad_mean_iterative`` on
    Matérn-3/2 cells at tol 1e-12 equal the JAX facade's at 1e-7 (the face
    differences amplify the solves' difference by about 1/ℓ) and the dense
    heads."""
    X, y = data1d
    m = GP.gridded(24, (0.0, 1.0), kinds="matern32", **F64).fit(
        X, y, n_iters=10, learning_rate=0.05)
    m.solve_iterative(tol=1e-12, maxiter=4000)
    grids = (CellIntegralFeature.from_lims(6, 0.0, 1.0),)
    xs = np.linspace(0.1, 0.9, 9)
    jg = (japi.CellIntegralFeature.from_lims(6, 0.0, 1.0),)
    jxs = jnp.asarray(xs)

    def jrun(j):
        j.solve_iterative(tol=1e-12, maxiter=4000)
        return (j.q_dv_mean_iterative(jg, axis=0), j.predict_grad_mean_iterative(jxs, axis=0),
                j.q_dv(jg, axis=0), j.posterior_grad(jxs, axis=0))

    want = _jheads(japi.GP, japi.GP.gridded(24, (0.0, 1.0), kinds="matern32").spec, m.params,
                   (X, y), jrun)
    _close(m.q_dv_mean_iterative(grids, axis=0), want[0], 1e-7)
    _close(m.predict_grad_mean_iterative(xs, axis=0), want[1], 1e-7)
    _gauss_close(m.q_dv(grids, axis=0), want[2])
    _gauss_close(m.posterior_grad(xs, axis=0), want[3])
    _close(m.q_dv_mean_iterative(grids, axis=0), want[2].mean, 1e-4)


def test_pathwise_iterative_facade(data1d, monkeypatch):
    """``q_v_pathwise_iterative`` and ``q_dv_pathwise_iterative`` from one
    patched draw table equal the JAX facade's at 1e-8 (the bound of
    ``test_torch_pathwise.py``), and their moments track the dense head."""
    X, y = data1d
    m = GP.gridded(32, (0.0, 1.0), **F64).fit(X, y, n_iters=10, learning_rate=0.05)
    grids = (CellIntegralFeature.from_lims(6, 0.0, 1.0),)
    jg = (japi.CellIntegralFeature.from_lims(6, 0.0, 1.0),)
    jspec = japi.GP.gridded(32, (0.0, 1.0)).spec
    S, Fp, cg = 64, 48, dict(tol=1e-12, maxiter=4000)
    patch = lambda: tpw._patch_draws(monkeypatch, jax.random.PRNGKey(3), S, 1, Fp, (50,),
                                     seed=13)
    patch()
    want = _jheads(japi.GP, jspec, m.params, (X, y), lambda j: (
        j.q_v_pathwise_iterative(jg, n_samples=S, n_features=Fp, seed=3, **cg),
        j.q_dv_pathwise_iterative(jg, axis=0, n_samples=S, n_features=Fp, seed=3, **cg)))
    _gauss_close(m.q_v_pathwise_iterative(grids, n_samples=S, n_features=Fp, seed=3, **cg),
                 want[0], 1e-8)
    patch()
    _gauss_close(m.q_dv_pathwise_iterative(grids, axis=0, n_samples=S, n_features=Fp, seed=3,
                                           **cg), want[1], 1e-8)
    monkeypatch.undo()
    dense = m.q_v(grids)
    pw = m.q_v_pathwise_iterative(grids, n_samples=256, n_features=512, seed=3)
    w_var = _np(dense.var)
    np.testing.assert_allclose(_np(pw.mean), _np(dense.mean),
                               atol=5.0 * float(np.max(np.sqrt(w_var / 256))))
    np.testing.assert_allclose(_np(pw.var), w_var, rtol=0.3, atol=1e-6 * float(np.max(w_var)))
