"""Second derivatives of the port against the JAX package: the Hessian that
``hyperpost.laplace`` takes, in the raw (softplus⁻¹) space and the flat
order of ``jax.flatten_util.ravel_pytree``.

The scalar-tangent whitening's backward (``models.common.WhitenedKufScalar``)
and the Kronecker moments' (``models.svgp.KronMoments``) read tensors saved
without a graph, so they are first-order only: under ``create_graph`` they
raise, and ``models.common.second_order()`` routes around them (the primal
whitening through ``CellKufOp``, plain autograd for the moments).
``ops.chol.WhitenMatmul``'s backward is plain products of its saved inputs
and is exact at second order. Every collapsed family's Hessian is held at
rtol 1e-10 of max|H| against JAX's: ``jax.hessian`` where JAX can take it,
``jax.jacrev(jax.jacrev(·))`` where the model whitens through
``vggp_tpu.ops.chol._whiten_matmul``, a ``custom_vjp`` whose forward rule
calls itself and so refuses the forward mode of ``jax.hessian``. Float64 on
the CPU, JAX in x64, its Pallas kernels in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.models import additive as jadditive
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import freesvgp as jfree
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import sum as jsum
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import config, convert, features, hyperpost, train
from vggp_tpu_torch.models import additive, common, exact, freesvgp, sgpr, svgp
from vggp_tpu_torch.models import sum as msum
from vggp_tpu_torch.ops.chol import WhitenMatmul

import test_torch_sgpr as tsg
from test_torch_families import _data as _data2d

RTOL_H = 1e-10


def _collapsed_case(name):
    """(JAX loss, port loss, params as numpy, whether JAX's forward-over-
    reverse Hessian raises) of one collapsed family."""
    if name in ("cells 1d", "cells 2d"):
        cfg = name.split()[1]
        js, ts = tsg._specs(cfg)
        x, y = tsg._data(cfg, 0)
        p = tsg._params_np(cfg)
        mods = (jsgpr, sgpr)
        raises = False
    elif name in ("points", "vff"):
        rng = np.random.default_rng(4)
        x = rng.random(60)
        y = np.sin(6 * x) + 0.05 * rng.standard_normal(60)
        if name == "points":
            z = np.linspace(0.05, 0.95, 6)
            feats = (jfeatures.PointFeature(6, z), features.PointFeature(6, z))
            ax = {"variance": np.asarray(1.1), "lengthscale": np.asarray(0.3), "z": z}
        else:
            feats = (jfeatures.FourierFeature(5, -0.1, 1.1), features.FourierFeature(5, -0.1, 1.1))
            ax = {"variance": np.asarray(1.1), "lengthscale": np.asarray(0.3)}
        js = jsgpr.SGPRSpec(kinds=("matern32",), features=feats[:1])
        ts = sgpr.SGPRSpec(kinds=("matern32",), features=feats[1:])
        p = {"axes": (ax,), "noise": np.asarray(0.03)}
        mods = (jsgpr, sgpr)
        raises = name == "points"
    elif name == "exact":
        rng = np.random.default_rng(5)
        x = np.sort(rng.random(40))
        y = np.sin(6 * x) + 0.1 * rng.standard_normal(40)
        js, ts = jexact.ExactGPSpec(kinds=("matern32",)), exact.ExactGPSpec(kinds=("matern32",))
        p = {"axes": ({"variance": np.asarray(0.9), "lengthscale": np.asarray(0.25)},),
             "noise": np.asarray(0.02)}
        mods = (jexact, exact)
        raises = False
    elif name == "free points":
        x, y = _data2d(50, 7)
        js = jfree.FreeSVGPSpec(kinds=("matern32",) * 2, m=8)
        ts = freesvgp.FreeSVGPSpec(kinds=("matern32",) * 2, m=8)
        p = {"axes": ({"variance": np.asarray(0.9), "lengthscale": np.asarray(0.3)},
                      {"variance": np.asarray(0.7), "lengthscale": np.asarray(0.4)}),
             "z": np.random.default_rng(2).random((8, 2)), "noise": np.asarray(0.02)}
        mods = (jfree, freesvgp)
        raises = True
    elif name == "additive":
        x, y = _data2d(60, 4)
        cells = ((7, -0.05, 1.05), (6, 0.0, 1.0))
        js = jadditive.AdditiveSGPRSpec(
            kinds=("matern12",) * 2,
            features=tuple(jfeatures.CellIntegralFeature.from_lims(*c) for c in cells))
        ts = additive.AdditiveSGPRSpec(
            kinds=("matern12",) * 2,
            features=tuple(features.CellIntegralFeature.from_lims(*c) for c in cells))
        p = {"axes": ({"variance": np.asarray(0.8), "lengthscale": np.asarray(0.35)},
                      {"variance": np.asarray(0.5), "lengthscale": np.asarray(0.25)}),
             "noise": np.asarray(0.03)}
        mods = (jadditive, additive)
        raises = False
    else:  # "sum": a coarse and a fine Matérn-1/2 cell component
        x, y = _data2d(60, 3)

        def comps(pkg, mod):
            return tuple(mod.SGPRSpec(kinds=("matern12",) * 2,
                                      features=tuple(pkg.CellIntegralFeature.from_lims(m, 0, 1)
                                                     for _ in range(2)))
                         for m in (3, 6))
        js = jsum.SumSGPRSpec(components=comps(jfeatures, jsgpr))
        ts = msum.SumSGPRSpec(components=comps(features, sgpr))
        p = {"components": tuple({"axes": tuple({"variance": np.asarray(v),
                                                 "lengthscale": np.asarray(ell)}
                                                for _ in range(2))}
                                 for v, ell in ((0.8, 0.6), (0.2, 0.15))),
             "noise": np.asarray(0.03)}
        mods = (jsum, msum)
        raises = True
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    return (lambda q: mods[0].loss(js, q, jx, jy), lambda q: mods[1].loss(ts, q, tx, ty),
            p, raises)


@functools.lru_cache(maxsize=None)
def _jax_hessian_of(name):
    jloss, _, p_np, raises = _collapsed_case(name)
    return _jax_hessian(jloss, p_np, raises)


def _jax_hessian(loss_fn, p_np, raises):
    """JAX's raw-space Hessian at ``p_np`` in ravel_pytree order: by
    ``jax.hessian`` (``hyperpost.laplace``'s), or where that raises — as it
    must exactly for the models ``raises`` names — reverse over reverse."""
    flat, unravel = ravel_pytree(jtrain.unconstrain(jax.tree.map(jnp.asarray, p_np)))
    f = lambda v: loss_fn(jtrain.constrain(unravel(v)))
    try:
        H = jax.jit(jax.hessian(f))(flat)
        assert not raises
    except TypeError as e:
        assert raises and "custom_vjp" in str(e), e
        H = jax.jit(jax.jacrev(jax.jacrev(f)))(flat)
    return np.asarray(flat), np.asarray(H)


def _to_torch(p_np):
    return convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)


def _h_close(got, want, rtol=RTOL_H):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


_FAMILIES = ("cells 1d", "cells 2d", "points", "vff", "exact", "free points", "additive", "sum")


@pytest.mark.parametrize("name", _FAMILIES)
def test_collapsed_hessian_matches_jax(name):
    """Each collapsed family's raw-space Hessian (``hyperpost.raw_hessian``,
    the route of ``laplace``) against JAX's at rtol 1e-10 of max|H|, and
    the flat vector equal to ``ravel_pytree``'s (sorted dict keys)."""
    _, tloss, p_np, _ = _collapsed_case(name)
    jflat, Hj = _jax_hessian_of(name)
    H, flat, _ = hyperpost.raw_hessian(tloss, _to_torch(p_np))
    np.testing.assert_allclose(flat.numpy(), jflat, rtol=1e-15, atol=1e-15)
    _h_close(H, Hj)


def test_the_1d_cells_hessian_was_the_fault():
    """ROADMAP queue 3, item 16's case (32 Matérn-1/2 cells, 200 points,
    σ² 1.3, ℓ 0.08, noise 0.02): the port's H_ℓℓ and H_σ²σ² equal JAX's
    (492.8 and 81.6; the first-order backward under a graph gave −2937 and
    1012), and outside the route the Hessian raises instead."""
    _, tloss, p_np, _ = _collapsed_case("cells 1d")
    _, Hj = _jax_hessian_of("cells 1d")
    H, *_ = hyperpost.raw_hessian(tloss, _to_torch(p_np))
    assert Hj[0, 0] == pytest.approx(492.75, rel=1e-4)   # lengthscale first (sorted keys)
    assert Hj[1, 1] == pytest.approx(81.59, rel=1e-3)
    np.testing.assert_allclose(H.numpy()[[0, 1], [0, 1]], Hj[[0, 1], [0, 1]], rtol=1e-10)
    flat, unravel = train.ravel(train.unconstrain(_to_torch(p_np)))
    with pytest.raises(RuntimeError, match="WhitenedKufScalar's backward is first-order only"):
        torch.autograd.functional.hessian(lambda v: tloss(train.constrain(unravel(v))), flat)


def _svgp_case(variational):
    rng = np.random.default_rng(0)
    x = rng.random((40, 2))
    y = np.sin(5 * x[:, 0]) * np.cos(3 * x[:, 1])
    lims = ((3, 0.0, 1.0), (4, 0.0, 1.0)) if variational == "kron" else ((2, 0.0, 1.0), (3, 0.0, 1.0))
    js = jsvgp.SVGPSpec(kinds=("matern12",) * 2, num_data=40, variational=variational,
                        features=tuple(jfeatures.CellIntegralFeature.from_lims(*g) for g in lims))
    ts = svgp.SVGPSpec(kinds=("matern12",) * 2, num_data=40, variational=variational,
                       features=tuple(features.CellIntegralFeature.from_lims(*g) for g in lims))
    p = jax.tree.map(np.asarray, js.init_params(jnp.float64))
    p = jax.tree.map(lambda v: v + 0.05 * rng.standard_normal(np.shape(v)) if np.ndim(v) else v, p)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    return (lambda q: jsvgp.loss(js, q, jx, jy), lambda q: svgp.loss(ts, q, tx, ty), p)


@pytest.mark.parametrize("variational", ("kron", "full"))
def test_kron_moments_is_first_order_only(variational):
    """``KronMoments``'s backward, measured: its Hessian read 0.43 (kron) and
    0.19 (full) of max|H| off ``jax.hessian``'s, so under ``create_graph``
    it raises; inside ``second_order()`` the SVGP's Hessian (q's leaves and
    the hyperparameters, p = 42 on 3×4 cells, 47 on 2×3) equals JAX's at
    rtol 1e-10."""
    jloss, tloss, p_np = _svgp_case(variational)
    _, Hj = _jax_hessian(jloss, p_np, False)
    H, *_ = hyperpost.raw_hessian(tloss, _to_torch(p_np))
    _h_close(H, Hj)
    assert config.FAST_MOMENTS_BWD
    rng = np.random.default_rng(3)
    ms = (6,) if variational == "full" else (3, 4)
    mu = torch.tensor(rng.standard_normal(ms), requires_grad=True)
    Ls = [torch.tensor(np.tril(rng.standard_normal((m, m))), requires_grad=True) for m in ms]
    blocks = [torch.tensor(rng.standard_normal((m, 7)), requires_grad=True) for m in ms]
    out = svgp.KronMoments.apply(mu, *Ls, *blocks)
    with pytest.raises(RuntimeError, match="KronMoments's backward is first-order only"):
        torch.autograd.grad(sum(o.sum() for o in out), [mu, *Ls, *blocks], create_graph=True)


def test_whiten_matmul_is_exact_at_second_order():
    """``WhitenMatmul``'s backward (g·bᵀ, finv ᵀ·g of its saved inputs) is
    right at second order: the Hessian of a nonlinear function of
    finv @ b equals plain autograd's to roundoff (it stays as it is; the
    point and free-point Hessians above run through it)."""
    rng = np.random.default_rng(1)
    finv = torch.tensor(np.tril(rng.standard_normal((5, 5))) + 3 * np.eye(5))
    b = torch.tensor(rng.standard_normal((5, 4)))
    flat = torch.cat([finv.reshape(-1), b.reshape(-1)])

    def f(mm):
        def g(v):
            a, c = v[:25].reshape(5, 5), v[25:].reshape(5, 4)
            return torch.sum(torch.sin(mm(a, c)) ** 2)
        return g

    got = torch.autograd.functional.hessian(f(WhitenMatmul.apply), flat)
    want = torch.autograd.functional.hessian(f(torch.matmul), flat)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13)


def test_first_order_paths_unchanged_outside_the_route():
    """Outside ``second_order()`` the loss and its gradient take the
    scalar tangent (and equal the route's to roundoff): the route only
    changes how second derivatives are built."""
    _, tloss, p_np, _ = _collapsed_case("cells 2d")
    flat, unravel = train.ravel(train.unconstrain(_to_torch(p_np)))
    outs = []
    for ctx in (torch.enable_grad, common.second_order):
        v = flat.clone().requires_grad_(True)
        with ctx():
            val = tloss(train.constrain(unravel(v)))
            (g,) = torch.autograd.grad(val, v)
        outs.append((val.item(), g.numpy()))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-13)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-10)
