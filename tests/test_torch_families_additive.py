"""The additive family of the port against the JAX package: the ELBO and
its gradient leaves through the scalar-tangent whitening, every head, and
``train.fit``. Inputs, tolerances and helpers as ``test_torch_families.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.models import additive as jadditive

import vggp_tpu_torch
from vggp_tpu_torch import features, train
from vggp_tpu_torch.models import additive

from test_torch_families import (_both, _check_fit, _data, _grids, _heads_close, _tensors)
from test_torch_full import _check_value_and_grad


# --------------------------------------------------------------------------- #
# the additive model
# --------------------------------------------------------------------------- #

def _additive_specs(kind):
    cells = ((7, -0.05, 1.05), (6, 0.0, 1.0))
    return (jadditive.AdditiveSGPRSpec(kinds=(kind,) * 2, features=_grids(jfeatures, cells)),
            additive.AdditiveSGPRSpec(kinds=(kind,) * 2, features=_grids(features, cells)))


_ADD_P = {"axes": ({"variance": np.asarray(0.8), "lengthscale": np.asarray(0.35)},
                   {"variance": np.asarray(0.5), "lengthscale": np.asarray(0.25)}),
          "noise": np.asarray(0.03)}


@pytest.mark.parametrize("kind", ("matern32", "matern12"))
def test_additive_matches_jax(kind):
    """The additive model: the ELBO (rtol 1e-10) and its gradient leaves
    through the scalar-tangent whitening (rtol 1e-7); every head (the
    posterior marginal, full_cov and predictive, prior, q_u, q_v marginal
    and full_cov, p_v_u, q_dv marginal on one axis and full_cov on the
    other, the gradient posterior likewise), rtol 1e-9; for Matérn-1/2 (the
    cell kernels' kind) the posterior, q_u, q_v, p_v_u and q_dv, and its
    gradient posterior raises as JAX's does."""
    jspec, tspec = _additive_specs(kind)
    x, y = _data(60, 4)
    (jx, tx), (jy, ty) = _tensors(x, y)
    _check_value_and_grad(lambda p: jadditive.loss(jspec, p, jx, jy),
                          lambda p: additive.loss(tspec, p, tx, ty), _ADD_P)
    jp, tp = _both(_ADD_P)
    (jxs, txs), = _tensors(_data(9, 12)[0])
    jg, tg = _grids(jfeatures), _grids(features)
    with torch.no_grad():
        pairs = [(additive.posterior(tspec, tp, tx, ty, txs),
                  lambda p, X, y, xs: jadditive.posterior(jspec, p, X, y, xs)),
                 (additive.posterior(tspec, tp, tx, ty, txs, full_cov=True),
                  lambda p, X, y, xs: jadditive.posterior(jspec, p, X, y, xs, full_cov=True)),
                 (additive.posterior_predictive(tspec, tp, tx, ty, txs),
                  lambda p, X, y, xs: jadditive.posterior_predictive(jspec, p, X, y, xs)),
                 (additive.prior(tspec, tp, txs), lambda p, X, y, xs: jadditive.prior(jspec, p, xs)),
                 (additive.q_u(tspec, tp, tx, ty), lambda p, X, y, xs: jadditive.q_u(jspec, p, X, y)),
                 (additive.q_v(tspec, tp, tx, ty, tg),
                  lambda p, X, y, xs: jadditive.q_v(jspec, p, X, y, jg)),
                 (additive.q_v(tspec, tp, tx, ty, tg, full_cov=True),
                  lambda p, X, y, xs: jadditive.q_v(jspec, p, X, y, jg, full_cov=True)),
                 (additive.p_v_u(tspec, tp, tx, ty, tg),
                  lambda p, X, y, xs: jadditive.p_v_u(jspec, p, X, y, jg))]
        for axis, full in ((0, False), (1, True)):
            pairs.append((additive.q_dv(tspec, tp, tx, ty, tg, axis, full_cov=full),
                          lambda p, X, y, xs, a=axis, f=full: jadditive.q_dv(
                              jspec, p, X, y, jg, a, full_cov=f)))
            if kind == "matern32":
                pairs.append((additive.posterior_grad(tspec, tp, tx, ty, txs, axis, full),
                              lambda p, X, y, xs, a=axis, f=full: jadditive.posterior_grad(
                                  jspec, p, X, y, xs, a, f)))
        if kind == "matern12":     # the kernel's kind: the heads that differ from Matérn-3/2's
            pairs = [pairs[i] for i in (0, 4, 5, 7, 8, 9)]
    _heads_close(pairs, (jp, jx, jy, jxs))
    if kind == "matern12":
        for mod, spec, p, xx, yy, xs in ((jadditive, jspec, jp, jx, jy, jxs),
                                         (additive, tspec, tp, tx, ty, txs)):
            with pytest.raises(ValueError, match="once-differentiable"):
                mod.posterior_grad(spec, p, xx, yy, xs, 0)


def test_additive_fit_matches_jax():
    """``non_informative_init`` and 4 steps of ``train.fit`` on the
    additive model (the scalar-tangent route on each axis): the history
    and the final parameters at rtol 1e-6; the ``AdditiveSGPR`` module's
    loss equals the function's; the gridded heads need uniform grids and
    two components, as JAX's."""
    jspec, tspec = _additive_specs("matern12")
    x, y = _data(60, 6)
    (jx, tx), (jy, ty) = _tensors(x, y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    tfinal, _ = _check_fit(lambda p: jadditive.loss(jspec, p, jx, jy),
                           lambda p: additive.loss(tspec, p, tx, ty), jp0, tp0)
    model = vggp_tpu_torch.AdditiveSGPR(tspec, tx, ty, tfinal, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(float(model().detach()),
                               float(additive.loss(tspec, tfinal, tx, ty)), rtol=1e-12)
    uneven = (features.CellIntegralFeature(np.array([0.0, 0.2, 0.7, 1.0])),
              features.CellIntegralFeature.from_lims(3, 0, 1))
    with pytest.raises(ValueError, match="uniform grid axes"):
        additive.q_v(tspec, tfinal, tx, ty, uneven)
    one = additive.AdditiveSGPRSpec(kinds=("matern12",), features=tspec.features[:1])
    with pytest.raises(ValueError, match="2 components"):
        additive.q_v(one, {"axes": tfinal["axes"][:1], "noise": tfinal["noise"]}, tx, ty,
                     tspec.features)
