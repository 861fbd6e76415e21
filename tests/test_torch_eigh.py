"""The clamped-eigh Kuu factor of the port against the JAX package: the
factor itself (F up to the sign of each column: the JAX package leaves the
sign to its solver, the port fixes it), and the collapsed GP and the SVGP
under ``factor_method="eigh"``, every sign-invariant result at rtol 1e-9.
Inputs, tolerances and helpers as ``test_torch_families.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import svgp as jsvgp
from vggp_tpu.ops import chol as jchol

import vggp_tpu_torch
from vggp_tpu_torch import features
from vggp_tpu_torch.models import sgpr, svgp
from vggp_tpu_torch.ops import chol

from test_torch_families import _both, _data, _grids, _heads_close, _tensors
from test_torch_full import _check_value_and_grad, _close, _to_torch


# --------------------------------------------------------------------------- #
# the clamped-eigh Kuu factor
# --------------------------------------------------------------------------- #

def _gram(kind, m=10):
    f = jfeatures.CellIntegralFeature.from_lims(m, 0.0, 1.0)
    return np.asarray(f.Kuu(kind, {"variance": jnp.asarray(1.2), "lengthscale": jnp.asarray(0.4)}))


@pytest.mark.parametrize("kind,floor", (("matern12", None), ("matern52", 1e-4)))
def test_psd_factor_eigh_matches_jax(kind, floor):
    """``psd_factor_eigh`` of a cell Gram (Matérn-5/2 with a floor that
    clamps its small eigenvalues): F and F⁻¹ equal JAX's up to the sign of
    each column (row of F⁻¹), rtol 1e-9; the port's signs follow its
    convention (each column's product with the reference vector positive);
    ``logdet``, ``whiten`` of a vector and of a matrix wider than F, and
    F Fᵀ at rtol 1e-9; ``psd_factor(method="eigh")`` is the same factor and
    an unknown method raises as JAX's."""
    a = _gram(kind)
    jf = jchol.psd_factor_eigh(jnp.asarray(a), floor)
    tf = chol.psd_factor_eigh(torch.tensor(a), floor)
    F_j, F_t = np.asarray(jf.F), tf.F.numpy()
    s = np.sign(np.sum(F_j * F_t, axis=0))
    assert np.all(s != 0) and not tf.tri
    _close(F_t, F_j * s[None, :])
    _close(tf.Finv.numpy(), np.asarray(jf.Finv) * s[:, None])
    ref = chol._sign_reference(a.shape[0], tf.F).numpy()
    assert np.all(ref @ F_t > 0)
    _close(tf.logdet, jf.logdet)
    _close(tf.F @ tf.F.T, jf.F @ jf.F.T)
    rng = np.random.default_rng(0)
    for b in (rng.standard_normal(10), rng.standard_normal((10, 17))):
        got, want = tf.whiten(torch.tensor(b)).numpy(), np.asarray(jf.whiten(jnp.asarray(b)))
        _close(got, want * (s if b.ndim == 1 else s[:, None]))
    if floor is None:
        _close(chol.psd_factor(torch.tensor(a), method="eigh").F, F_t, 1e-15)
    for mod, arr in ((jchol, jnp.asarray), (chol, torch.tensor)):
        with pytest.raises(ValueError, match="unknown factor method"):
            mod.psd_factor(arr(a), method="qr")


def test_eigh_sign_convention_is_device_independent():
    """The convention fixes each column whatever sign the solver returns:
    the factor of −Q's columns (the same eigendecomposition with every sign
    flipped) is the same F."""
    a = torch.tensor(_gram("matern32"))
    f = chol.psd_factor_eigh(a)
    w, q = torch.linalg.eigh(0.5 * (a + a.T))
    flipped = torch.ones(q.shape[1], dtype=q.dtype)
    flipped[::2] = -1.0
    real_eigh = torch.linalg.eigh
    try:
        torch.linalg.eigh = lambda m: (w, q * flipped[None, :])
        g = chol.psd_factor_eigh(a)
    finally:
        torch.linalg.eigh = real_eigh
    np.testing.assert_array_equal(f.F.numpy(), g.F.numpy())


def _eigh_sgpr_specs():
    feats = lambda pkg: _grids(pkg, ((6, 0, 1), (5, -0.05, 1.05)))
    kw = dict(kinds=("matern12", "matern12"), factor_method="eigh")
    return jsgpr.SGPRSpec(features=feats(jfeatures), **kw), sgpr.SGPRSpec(features=feats(features),
                                                                           **kw)


def test_eigh_sgpr_matches_jax():
    """The collapsed GP with ``factor_method="eigh"`` (every head is
    invariant to the eigenvectors' signs): the ELBO (rtol 1e-10) and its
    gradient leaves through eigh (rtol 1e-7), the posterior, q_v, q_u and
    p_v_u (rtol 1e-9); the spec takes the dense route, not the scalar
    tangent (``scalar_whiten_eligible`` reads the factor method)."""
    jspec, tspec = _eigh_sgpr_specs()
    x, y = _data(50, 9)
    (jx, tx), (jy, ty) = _tensors(x, y)
    p_np = {"axes": ({"variance": np.asarray(1.1), "lengthscale": np.asarray(0.3)},
                     {"variance": np.asarray(0.9), "lengthscale": np.asarray(0.4)}),
            "noise": np.asarray(0.03)}
    _check_value_and_grad(lambda p: jsgpr.loss(jspec, p, jx, jy),
                          lambda p: sgpr.loss(tspec, p, tx, ty), p_np)
    jp, tp = _both(p_np)
    assert not vggp_tpu_torch.common.scalar_whiten_eligible(tspec, tp)
    (jxs, txs), = _tensors(_data(9, 14)[0])
    jg, tg = _grids(jfeatures), _grids(features)
    with torch.no_grad():
        pairs = [(sgpr.posterior(tspec, tp, tx, ty, txs),
                  lambda p, X, y, xs: jsgpr.posterior(jspec, p, X, y, xs)),
                 (sgpr.q_v(tspec, tp, tx, ty, tg), lambda p, X, y, xs: jsgpr.q_v(jspec, p, X, y, jg)),
                 (sgpr.q_u(tspec, tp, tx, ty), lambda p, X, y, xs: jsgpr.q_u(jspec, p, X, y)),
                 (sgpr.p_v_u(tspec, tp, tx, ty, tg),
                  lambda p, X, y, xs: jsgpr.p_v_u(jspec, p, X, y, jg))]
    _heads_close(pairs, (jp, jx, jy, jxs))


def test_eigh_svgp_heads_match_jax():
    """The Kronecker SVGP with ``factor_method="eigh"``: its whitened
    coordinates follow the factor's column signs, so JAX gets the port's
    model expressed in its own signs (μ and each L_i flipped by the signs
    between the two packages' F_i); the loss (rtol 1e-10), the posterior
    cold and warm, q_v and q_u then agree (rtol 1e-9)."""
    feats = lambda pkg: _grids(pkg, ((6, 0, 1), (5, -0.05, 1.05)))
    kw = dict(kinds=("matern12", "matern12"), num_data=300, variational="kron",
              factor_method="eigh")
    jspec, tspec = jsvgp.SVGPSpec(features=feats(jfeatures), **kw), svgp.SVGPSpec(
        features=feats(features), **kw)
    rng = np.random.default_rng(10)
    p_np = {"axes": ({"variance": np.asarray(1.1), "lengthscale": np.asarray(0.3)},
                     {"variance": np.asarray(0.9), "lengthscale": np.asarray(0.4)}),
            "noise": np.asarray(0.03), "q": {"mu": 0.4 * rng.standard_normal((6, 5))}}
    Ls = [np.tril(0.2 * rng.standard_normal((m, m)), -1) + np.diag(rng.uniform(0.5, 1.0, m))
          for m in (6, 5)]
    jp, tp = _both(p_np)
    signs = [np.sign(np.sum(np.asarray(j.F) * t.F.numpy(), axis=0)) for j, t in zip(
        jsvgp.common.axis_chol_kuu(jspec, jp), vggp_tpu_torch.common.axis_chol_kuu(tspec, tp))]
    raw = lambda L: np.asarray(jsvgp.raw_from_chol(jnp.asarray(L)))
    t_np = {**p_np, "q": {**p_np["q"], "raw_L1": raw(Ls[0]), "raw_L2": raw(Ls[1])}}
    j_np = {**p_np, "q": {"mu": p_np["q"]["mu"] * np.outer(*signs),
                          **{f"raw_L{i + 1}": raw(s[:, None] * L * s[None, :])
                             for i, (s, L) in enumerate(zip(signs, Ls))}}}
    jp, tp = jax.tree.map(jnp.asarray, j_np), _to_torch(t_np)
    x, y = _data(40, 15)
    (jx, tx), (jy, ty), (jxs, txs) = _tensors(x, y, _data(9, 16)[0])
    np.testing.assert_allclose(float(svgp.loss(tspec, tp, tx, ty)),
                               float(jsvgp.loss(jspec, jp, jx, jy)), rtol=1e-10)
    jg, tg = _grids(jfeatures), _grids(features)
    with torch.no_grad():
        state = svgp.precompute(tspec, tp)
        pairs = [(svgp.posterior(tspec, tp, txs), lambda p, xs: jsvgp.posterior(jspec, p, xs)),
                 (svgp.posterior_from_state(tspec, tp, state, txs, full_cov=True),
                  lambda p, xs: jsvgp.posterior(jspec, p, xs, full_cov=True)),
                 (svgp.q_v(tspec, tp, tg), lambda p, xs: jsvgp.q_v(jspec, p, jg)),
                 (svgp.q_u(tspec, tp), lambda p, xs: jsvgp.q_u(jspec, p))]
    _heads_close(pairs, (jp, jxs))
