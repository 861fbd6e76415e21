"""The free-point family of the port against the JAX package: the ELBO
and its gradient leaves (the points z among them), every head, ``train.fit``
and the ``FreeSVGP`` module. Inputs, tolerances and helpers as
``test_torch_families.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.models import freesvgp as jfree

import vggp_tpu_torch
from vggp_tpu_torch import features, train
from vggp_tpu_torch.models import freesvgp

from test_torch_families import (_both, _check_fit, _data, _grids, _heads_close, _tensors)
from test_torch_full import _check_value_and_grad, _torch_flat


# --------------------------------------------------------------------------- #
# the free-point model
# --------------------------------------------------------------------------- #

def _free_specs(kind="matern32", m=12):
    return jfree.FreeSVGPSpec(kinds=(kind,) * 2, m=m), freesvgp.FreeSVGPSpec(kinds=(kind,) * 2, m=m)


def _free_params():
    rng = np.random.default_rng(2)
    return {"axes": ({"variance": np.asarray(0.9), "lengthscale": np.asarray(0.3)},
                     {"variance": np.asarray(0.7), "lengthscale": np.asarray(0.4)}),
            "z": rng.random((12, 2)), "noise": np.asarray(0.02)}


def test_freesvgp_matches_jax():
    """The free-point model: ``init_params`` (the same z from the seed,
    exactly), the ELBO (rtol 1e-10) and its gradient leaves, z's included
    (autograd through the Cholesky of Kuu, rtol 1e-7); every head (the
    posterior marginal, full_cov and predictive, prior, q_u, q_v marginal
    and full_cov, p_v_u, q_dv and the gradient posterior marginal on one
    axis and full_cov on the other), rtol 1e-9."""
    jspec, tspec = _free_specs()
    for g, w in zip(_torch_flat(tspec.init_params(torch.float64, "cpu", seed=3)),
                    jax.tree.leaves(jspec.init_params(jnp.float64, seed=3)), strict=True):
        np.testing.assert_array_equal(g, w)
    x, y = _data(60, 7)
    (jx, tx), (jy, ty) = _tensors(x, y)
    p_np = _free_params()
    _check_value_and_grad(lambda p: jfree.loss(jspec, p, jx, jy),
                          lambda p: freesvgp.loss(tspec, p, tx, ty), p_np)
    jp, tp = _both(p_np)
    (jxs, txs), = _tensors(_data(9, 13)[0])
    jg, tg = _grids(jfeatures), _grids(features)
    with torch.no_grad():
        pairs = [(freesvgp.posterior(tspec, tp, tx, ty, txs),
                  lambda p, X, y, xs: jfree.posterior(jspec, p, X, y, xs)),
                 (freesvgp.posterior(tspec, tp, tx, ty, txs, full_cov=True),
                  lambda p, X, y, xs: jfree.posterior(jspec, p, X, y, xs, full_cov=True)),
                 (freesvgp.posterior_predictive(tspec, tp, tx, ty, txs, full_cov=True),
                  lambda p, X, y, xs: jfree.posterior_predictive(jspec, p, X, y, xs, full_cov=True)),
                 (freesvgp.prior(tspec, tp, txs), lambda p, X, y, xs: jfree.prior(jspec, p, xs)),
                 (freesvgp.q_u(tspec, tp, tx, ty), lambda p, X, y, xs: jfree.q_u(jspec, p, X, y)),
                 (freesvgp.q_v(tspec, tp, tx, ty, tg),
                  lambda p, X, y, xs: jfree.q_v(jspec, p, X, y, jg)),
                 (freesvgp.q_v(tspec, tp, tx, ty, tg, full_cov=True),
                  lambda p, X, y, xs: jfree.q_v(jspec, p, X, y, jg, full_cov=True)),
                 (freesvgp.p_v_u(tspec, tp, tx, ty, tg),
                  lambda p, X, y, xs: jfree.p_v_u(jspec, p, X, y, jg))]
        for axis, full in ((0, False), (1, True)):
            pairs.append((freesvgp.q_dv(tspec, tp, tx, ty, tg, axis, full_cov=full),
                          lambda p, X, y, xs, a=axis, f=full: jfree.q_dv(
                              jspec, p, X, y, jg, a, full_cov=f)))
            pairs.append((freesvgp.posterior_grad(tspec, tp, tx, ty, txs, axis, full),
                          lambda p, X, y, xs, a=axis, f=full: jfree.posterior_grad(
                              jspec, p, X, y, xs, a, f)))
    _heads_close(pairs, (jp, jx, jy, jxs))


def test_freesvgp_fit_matches_jax():
    """``non_informative_init`` and 4 steps of ``train.fit`` on the
    free-point model (z learned): the history and the final parameters, z
    included, at rtol 1e-6; the ``FreeSVGP`` module holds z as a parameter
    and its loss equals the function's."""
    jspec, tspec = _free_specs("matern12", 10)
    x, y = _data(50, 8)
    (jx, tx), (jy, ty) = _tensors(x, y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    tfinal, jfinal = _check_fit(lambda p: jfree.loss(jspec, p, jx, jy),
                                lambda p: freesvgp.loss(tspec, p, tx, ty), jp0, tp0)
    assert not np.allclose(np.asarray(jfinal["z"]), np.asarray(jp0["z"]))
    model = vggp_tpu_torch.FreeSVGP(tspec, tx, ty, tfinal, dtype=torch.float64, device="cpu")
    assert isinstance(model.z, torch.nn.Parameter) and model.z.shape == (10, 2)
    np.testing.assert_allclose(float(model().detach()),
                               float(freesvgp.loss(tspec, tfinal, tx, ty)), rtol=1e-12)
