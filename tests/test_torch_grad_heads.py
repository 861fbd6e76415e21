"""The port's pointwise-gradient heads against the JAX package.

Three small 2-D models with differentiable kernels, parameters from a numpy
seed: the Kronecker SVGP with Matérn-3/2 × RBF cells (8×7), the collapsed
GP with RBF × Matérn-5/2 cells, the second axis on a non-uniform mesh, and
the exact GP with Matérn-5/2 × Matérn-3/2. Every ``posterior_grad`` and
``posterior_grad_from_state`` head, on both axes, marginal and
``full_cov``, and the whitened mixed-partial blocks of
``common.axis_whitened_deriv_kuf``, get the same numpy inputs in float64 on
the CPU in both packages (JAX in x64, one jitted program) and are held at
rtol 1e-9 with atol 1e-9·max|ref|.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import common as jcommon
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import convert
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import common, exact, sgpr, svgp

RTOL_HEAD = 1e-9

_NONUNIFORM = np.array([0.0, 0.07, 0.21, 0.30, 0.55, 0.61, 0.90, 1.0]) * 2.0 - 0.5
_MESHES = (np.linspace(0.0, 1.0, 9), np.linspace(-0.5, 1.5, 8))
_KINDS = {"svgp": ("matern32", "rbf"), "sgpr": ("rbf", "matern52"),
          "exact": ("matern52", "matern32")}
_ORDERS = ((1, 0), (0, 1), (2, 0), (0, 2), (1, 1), (2, 1))


def _points(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(n), rng.random(n) * 2.0 - 0.5], axis=1)


_X = _points(1, 120)
_Y = np.sin(6 * _X[:, 0]) * np.cos(3 * _X[:, 1]) + 0.1 * np.random.default_rng(2).standard_normal(120)
_XS = _points(3, 25)


def _specs(pkg):
    """(svgp spec, sgpr spec, exact spec) of the JAX package or the port."""
    jax_side = pkg == "jax"
    cell = JaxCellFeature if jax_side else CellIntegralFeature
    svgp_m, sgpr_m, exact_m = (jsvgp, jsgpr, jexact) if jax_side else (svgp, sgpr, exact)
    return (svgp_m.SVGPSpec(kinds=_KINDS["svgp"], features=tuple(cell(m) for m in _MESHES),
                            num_data=500, variational="kron"),
            sgpr_m.SGPRSpec(kinds=_KINDS["sgpr"], features=(cell(_MESHES[0]), cell(_NONUNIFORM))),
            exact_m.ExactGPSpec(_KINDS["exact"]))


def _params_np():
    rng = np.random.default_rng(0)
    axes = ({"variance": np.asarray(1.3), "lengthscale": np.asarray(0.2)},
            {"variance": np.asarray(0.8), "lengthscale": np.asarray(0.45)})
    q = {"mu": 0.3 * rng.standard_normal((8, 7))}
    for i, m in ((1, 8), (2, 7)):
        q[f"raw_L{i}"] = (np.asarray(jsvgp.raw_from_chol(jnp.eye(m)))
                          + 0.05 * np.tril(rng.standard_normal((m, m))))
    return {"svgp": {"axes": axes, "noise": np.asarray(0.05), "q": q},
            "sgpr": {"axes": axes, "noise": np.asarray(0.02)},
            "exact": {"axes": axes, "noise": np.asarray(0.02)}}


_HEADS = [(family, axis, full) for family in ("svgp", "svgp_warm", "sgpr", "sgpr_warm", "exact")
          for axis, full in itertools.product((0, 1), (False, True))]


def _head(mods, specs, params, family, axis, full, X, y, xs, states):
    svgp_m, sgpr_m, exact_m = mods
    s_svgp, s_sgpr, s_exact = specs
    if family == "svgp":
        return svgp_m.posterior_grad(s_svgp, params["svgp"], xs, axis, full_cov=full)
    if family == "svgp_warm":
        return svgp_m.posterior_grad_from_state(s_svgp, params["svgp"], states["svgp"], xs, axis,
                                                full_cov=full)
    if family == "sgpr":
        return sgpr_m.posterior_grad(s_sgpr, params["sgpr"], X, y, xs, axis, full_cov=full)
    if family == "sgpr_warm":
        return sgpr_m.posterior_grad_from_state(s_sgpr, params["sgpr"], states["sgpr"], xs, axis,
                                                full_cov=full)
    return exact_m.posterior_grad(s_exact, params["exact"], X, y, xs, axis, full_cov=full)


@pytest.fixture(scope="module")
def jax_out():
    """Every JAX head and block compared below, from one compiled program."""
    specs = _specs("jax")

    @jax.jit
    def run(params, X, y, xs):
        states = {"svgp": jsvgp.precompute(specs[0], params["svgp"]),
                  "sgpr": jsgpr.precompute(specs[1], params["sgpr"], X, y)}
        chols = jcommon.axis_chol_kuu(specs[1], params["sgpr"])
        return ({h: _head((jsvgp, jsgpr, jexact), specs, params, *h, X, y, xs, states)
                 for h in _HEADS},
                {o: jcommon.axis_whitened_deriv_kuf(specs[1], params["sgpr"], chols, xs, o)
                 for o in _ORDERS})

    return jax.tree.map(np.asarray, run(jax.tree.map(jnp.asarray, _params_np()),
                                        *(jnp.asarray(a) for a in (_X, _Y, _XS))))


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL_HEAD, atol=RTOL_HEAD * np.abs(want).max())


def _port_inputs():
    params = convert.params_from_jax(_params_np(), device="cpu", dtype=torch.float64)
    return params, *(torch.as_tensor(a) for a in (_X, _Y, _XS))


@pytest.mark.parametrize("family,axis,full", _HEADS)
def test_gradient_head_matches_jax(jax_out, family, axis, full):
    """One head, cold or warm (``*_warm``: from ``precompute``), f64, 1e-9."""
    specs = _specs("port")
    params, X, y, xs = _port_inputs()
    states = {"svgp": svgp.precompute(specs[0], params["svgp"]),
              "sgpr": sgpr.precompute(specs[1], params["sgpr"], X, y)}
    got = _head((svgp, sgpr, exact), specs, params, family, axis, full, X, y, xs, states)
    want = jax_out[0][family, axis, full]
    _close(got.mean, want.mean)
    if full:
        assert got.var is None
        _close(got.cov, want.cov)
    else:
        assert got.cov is None
        _close(got.var, want.var)


@pytest.mark.parametrize("orders", _ORDERS)
def test_whitened_deriv_blocks_match_jax(jax_out, orders):
    """F_i⁻¹ ∂^{o_i}Kuf_i per axis for a derivative-order tuple (second
    derivatives on the twice-differentiable RBF and Matérn-5/2 axes), f64."""
    spec = _specs("port")[1]
    params, _, _, xs = _port_inputs()
    chols = common.axis_chol_kuu(spec, params["sgpr"])
    got = common.axis_whitened_deriv_kuf(spec, params["sgpr"], chols, xs, orders)
    for g, w in zip(got, jax_out[1][orders], strict=True):
        _close(g, w)


@pytest.mark.parametrize("entry", [(0, 3), (1,), 5])
def test_bad_derivative_orders_raise_as_jax(entry):
    """An order above 2, a tuple of the wrong length and an axis out of range
    raise ValueError in both packages."""
    for mod, spec in ((common, _specs("port")[1]), (jcommon, _specs("jax")[1])):
        with pytest.raises(ValueError):
            mod.normalize_deriv_orders(spec, entry)
