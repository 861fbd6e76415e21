"""The port's other inducing features (points, VFF, B1/B2/B3 splines), their
operators and helpers, against the JAX package.

Every feature at the nb1 widths (``vggp_tpu/experiments/zoo.py:29-52``): 10
inducing points, 10 frequencies (m = 21), 15 B1 knots, B2 on 13 and B3 on 12
intervals (m = 15 each), for every kind each supports, at three lengthscales.
Points lie on both sides of [0, 1] and on its knots; the serving grids are
one inside [0, 1] and one reaching past both ends (the VFF continuation's
tail integrals). Both packages get the same numpy inputs in float64 on the
CPU (JAX in x64). Closed forms and their forward-mode derivatives are held
at rtol 1e-12 with atol 1e-12·max|ref|; the whitened ℓ-tangent of the
scalar path at 1e-10, as ``tests/test_torch_kinds.py`` holds the cells'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import basis as jbasis
from vggp_tpu import features as jfeatures
from vggp_tpu import kernels as jkernels
from vggp_tpu.models import common as jcommon
from vggp_tpu.ops import banded as jbanded
from vggp_tpu.ops import diag_lowrank as jdl
from vggp_tpu.ops import stablemath as jstable

from vggp_tpu_torch import basis, config, features, kernels
from vggp_tpu_torch.models import common
from vggp_tpu_torch.ops import banded, diag_lowrank, stablemath

RTOL = 1e-12
RTOL_TANGENT = 1e-10
VAR = 1.3
ELLS = (0.04, 0.3, 2.5)
_rng = np.random.default_rng(0)
X = np.concatenate([_rng.random(40) * 1.4 - 0.2, np.linspace(0.0, 1.0, 15)])
# the x-derivative blocks skip the ends of [0, 1], the kinks of |x − a| and
# |x − b| in the VFF continuation, where each AD system takes its own
# one-sided value (JAX's |x|′(0) = 1, torch's 0)
XD = X[(X != 0.0) & (X != 1.0)]
GRIDS = {"inside": np.linspace(0.0, 1.0, 7),
         "outside": np.array([-0.1, 0.05, 0.3, 0.42, 0.8, 1.15])}
MATERN = ("matern12", "matern32", "matern52")


def _make(pkg, name):
    """The feature ``name`` of the JAX package (``pkg`` = jfeatures) or the
    port (``pkg`` = features), from the same numpy arguments."""
    return {
        "points": lambda: pkg.PointFeature(10, np.linspace(0.05, 0.95, 10)),
        "vff": lambda: pkg.FourierFeature(10, 0.0, 1.0),
        "b1": lambda: pkg.B1SplineFeature(np.linspace(0.0, 1.0, 15)),
        "b2": lambda: pkg.B2SplineFeature(13, 0.0, 1.0),
        "b3": lambda: pkg.B3SplineFeature(12, 0.0, 1.0),
    }[name]()


# (feature, kind) pairs with a Kuu: points take every kind, VFF the Matérn
# orders, each spline the order of its smoothness
CASES = ([("points", k) for k in (*MATERN, "rbf")] + [("vff", k) for k in MATERN]
         + [("b1", "matern12"), ("b2", "matern32"), ("b3", "matern52")])


def _close(got, want, rtol=RTOL):
    want, got = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in (want, got))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _params(pkg, feat, ell):
    p = ({"variance": torch.tensor(VAR, dtype=torch.float64),
          "lengthscale": torch.tensor(ell, dtype=torch.float64)} if pkg is features else
         {"variance": jnp.asarray(VAR), "lengthscale": jnp.asarray(ell)})
    if "z" in (feat.init_params(torch.float64) if pkg is features else feat.init_params()):
        z = np.linspace(0.05, 0.95, feat.m) + 0.01 * np.sin(np.arange(feat.m))
        p["z"] = torch.as_tensor(z) if pkg is features else jnp.asarray(z)
    return p


def _blocks(pkg, name, kind, ell):
    """Every block of one (feature, kind) that both packages have by the
    same names (the same calls on either side)."""
    feat = _make(pkg, name)
    p = _params(pkg, feat, ell)
    arr = torch.as_tensor if pkg is features else jnp.asarray
    grids = {g: (features if pkg is features else jfeatures).CellIntegralFeature(mesh)
             for g, mesh in GRIDS.items()}
    x = arr(X)
    v = arr(np.cos(np.arange(feat.m * 3.0)).reshape(feat.m, 3))
    out = {"Kuu": feat.Kuu(kind, p), "Kuf": feat.Kuf(kind, p, x),
           "kuu_diag": feat.kuu_diag(kind, p), "kuu_matvec": feat.kuu_matvec(kind, p, v),
           "kuu_matvec_vec": feat.kuu_matvec(kind, p, v[:, 0])}
    out["Kuf_with_dl"] = feat.Kuf_with_dl(kind, p, x)
    for g, grid in grids.items():
        out[f"Kvu {g}"] = feat.Kvu(kind, p, grid)
    if name != "points" or kind in jkernels.DIFFERENTIABLE_KINDS:
        out["dKuf_dx"] = feat.dKuf_dx(kind, p, arr(XD))
    if name != "points" or kind in jkernels.TWICE_DIFFERENTIABLE_KINDS:
        out["dKuf_dx2"] = feat.dKuf_dx2(kind, p, arr(XD))
    if name == "vff":
        out["lowrank"] = feat.kuu_diag_lowrank(kind, p)
        if kind == "matern12":
            out["rank1"] = feat.kuu_diag_rank1(kind, p)
    if name == "b1":
        out["bands"] = feat.kuu_bands(kind, p)
    return out


@pytest.fixture(scope="module")
def jax_blocks():
    """Every JAX block, by (feature, kind, ℓ)."""
    return {(name, kind, ell): jax.tree.map(np.asarray, _blocks(jfeatures, name, kind, ell))
            for name, kind in CASES for ell in ELLS}


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("name,kind", CASES)
def test_feature_blocks_match_jax(jax_blocks, name, kind, ell):
    """Kuu, Kuf, Kvu inside and past [0, 1], diag(Kuu), Kuu @ v (vector and
    matrix), (Kuf, ∂Kuf/∂ℓ), the x-derivative blocks where defined, and the
    structured forms (VFF's diagonal plus low rank, B1's bands), f64, 1e-12."""
    got = _blocks(features, name, kind, ell)
    want = jax_blocks[name, kind, ell]
    assert sorted(got) == sorted(want)
    for key in want:
        g_leaves = got[key] if isinstance(got[key], tuple) else (got[key],)
        w_leaves = want[key] if isinstance(want[key], tuple) else (want[key],)
        for g, w in zip(g_leaves, w_leaves, strict=True):
            _close(g, w)


def test_vff_continuation_is_continuous_and_tails_match_quadrature():
    """The VFF basis is C⁰ at both ends of [a, b] for every Matérn order
    (the reference's sign and 5/2 form are not), and Kvu of cells that
    reach past both ends meets the trapezoidal quadrature of Kuf."""
    feat = features.FourierFeature(4, 0.0, 1.0)
    for kind in MATERN:
        p = _params(features, feat, 0.3)
        eps = 1e-9
        x = torch.tensor([-eps, eps, 1.0 - eps, 1.0 + eps], dtype=torch.float64)
        k = feat.Kuf(kind, p, x)
        assert torch.allclose(k[:, 0], k[:, 1], atol=1e-7)
        assert torch.allclose(k[:, 2], k[:, 3], atol=1e-7)
        grid = features.CellIntegralFeature(GRIDS["outside"])
        _close(feat.Kvu(kind, p, grid), feat.kvu_quadrature(kind, p, grid, n_quad=4001), 1e-6)


def test_spline_static_tables_match_jax():
    """The spline RKHS features' static tables (the spline-product integrals,
    the boundary state, the per-interval coefficients) equal the JAX
    package's: both build them in numpy from scipy's BSpline."""
    for name in ("b2", "b3"):
        f, jf = _make(features, name), _make(jfeatures, name)
        for attr in ("_M", "_state", "_coeffs"):
            np.testing.assert_array_equal(getattr(f, attr), getattr(jf, attr))
        assert f.delta == jf.delta and f.m == jf.m and f.kind == jf.kind


@pytest.mark.parametrize("name,kind", [c for c in CASES if c[0] != "points"])
def test_fixed_bases_take_the_scalar_path(name, kind):
    """The repair of the scalar-tangent whitening: every fixed basis answers
    the cell-only hooks with None (no AttributeError) and takes the dense
    factor there; a = F⁻¹Kuf and the VJP (dℓ, dσ²) of Σ g·a against JAX's
    ``whitened_kuf_scalar``, ∂a/∂ℓ against jax.jvp of the dense route, f64,
    1e-10."""
    feat, jfeat = _make(features, name), _make(jfeatures, name)
    p = {"lengthscale": torch.tensor(0.3, dtype=torch.float64),
         "variance": torch.tensor(VAR, dtype=torch.float64)}
    assert feat.kuu_first_row_dl(kind, p) is None
    assert feat.inv_chol_kuu(kind, p, 1e-6) is None
    assert feat.whiten_band_ratio(kind, p, 1e-6) is None
    assert feat.whitened_kuf_fused(kind, p, None, None, torch.as_tensor(X)) is None
    assert feat.extra_f32_jitter(kind) == 0.0
    rel = 1e-6
    g = np.random.default_rng(5).standard_normal((feat.m, X.shape[0]))

    def dense_a(ell):
        pj = {"lengthscale": ell, "variance": jnp.asarray(VAR)}
        k = jfeat.Kuu(kind, pj)
        k = 0.5 * (k + k.T)
        k = k + jnp.mean(jnp.diagonal(k)) * rel * jnp.eye(k.shape[0])
        return jax.scipy.linalg.solve_triangular(jnp.linalg.cholesky(k),
                                                 jfeat.Kuf(kind, pj, jnp.asarray(X)), lower=True)

    a_j, vjp = jax.vjp(lambda l, v: jcommon.whitened_kuf_scalar(
        jfeat, kind, rel, {"lengthscale": l, "variance": v}, jnp.asarray(X)),
        jnp.asarray(0.3), jnp.asarray(VAR))
    dl_j, dv_j = vjp(jnp.asarray(g))
    _, da_j = jax.jvp(dense_a, (jnp.asarray(0.3),), (jnp.asarray(1.0),))
    ell = p["lengthscale"].clone().requires_grad_()
    var = p["variance"].clone().requires_grad_()
    a = common.whitened_kuf_scalar(feat, kind, rel, {"lengthscale": ell, "variance": var},
                                   torch.as_tensor(X))
    dl, dv = torch.autograd.grad(torch.sum(torch.as_tensor(g) * a), (ell, var))
    _, da = common._whitened_kuf_tangent(feat, kind, rel, ell.detach(), var.detach(),
                                         torch.as_tensor(X))
    for got, want in ((a, a_j), (dl, dl_j), (dv, dv_j), (da, da_j)):
        _close(got, want, RTOL_TANGENT)


def test_unsupported_kinds_raise_as_jax():
    """Each feature rejects the kinds it has no closed form for, with the
    same exception type as the JAX package."""
    for pkg in (features, jfeatures):
        arr = torch.as_tensor if pkg is features else jnp.asarray
        p = {"variance": arr(1.0), "lengthscale": arr(0.3)}
        with pytest.raises(NotImplementedError):
            _make(pkg, "vff").Kuu("rbf", p)
        with pytest.raises(NotImplementedError):
            _make(pkg, "vff").kuu_diag_rank1("matern32", p)
        with pytest.raises(NotImplementedError):
            _make(pkg, "b1").Kuu("matern32", p)
        with pytest.raises(NotImplementedError):
            _make(pkg, "b2").Kuu("matern52", p)
        with pytest.raises(NotImplementedError):
            _make(pkg, "vff").Kvu("rbf", p, pkg.CellIntegralFeature(GRIDS["outside"]))
        with pytest.raises(ValueError):
            pkg.B1SplineFeature(np.array([0.0, 0.1, 0.3]))
        with pytest.raises(ValueError):
            pkg.SplineRKHSFeature(4, 10, 0.0, 1.0)


# --------------------------------------------------------------------------- #
# kernels, operators, series and bases
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", (*MATERN, "rbf"))
def test_spectral_constants_match_jax(kind):
    """spectral_density, and for the Matérn orders white_noise_intensity
    and p0_inv_rows, f64, 1e-12."""
    om = np.linspace(0.0, 80.0, 33)
    v, ell = torch.tensor(VAR, dtype=torch.float64), torch.tensor(0.3, dtype=torch.float64)
    _close(kernels.spectral_density(kind, torch.as_tensor(om), v, ell),
           jkernels.spectral_density(kind, jnp.asarray(om), VAR, 0.3))
    if kind == "rbf":
        return
    _close(kernels.white_noise_intensity(kind, v, ell),
           jkernels.white_noise_intensity(kind, VAR, 0.3))
    got = kernels.p0_inv_rows(kind, v, ell)
    want = jkernels.p0_inv_rows(kind, jnp.asarray(VAR), jnp.asarray(0.3))
    for g_row, w_row in zip(got, want, strict=True):
        for g, w in zip(g_row, w_row, strict=True):
            assert isinstance(g, float) == isinstance(w, float)
            _close(torch.as_tensor(g), w)


def test_diag_lowrank_matches_jax():
    """Every diag + low-rank operator (dense, matvec, Woodbury solve,
    logdet; rank 1 and rank 3), vector and matrix right-hand sides, 1e-12."""
    rng = np.random.default_rng(2)
    alpha, W = rng.random(9) + 0.5, rng.standard_normal((9, 3))
    b = rng.standard_normal((9, 4))
    t = torch.as_tensor
    for rhs in (b, b[:, 0]):
        _close(diag_lowrank.diag_lowrank_matvec(t(alpha), t(W), t(rhs)),
               jdl.diag_lowrank_matvec(alpha, W, rhs))
        _close(diag_lowrank.diag_lowrank_solve(t(alpha), t(W), t(rhs)),
               jdl.diag_lowrank_solve(alpha, W, rhs))
        _close(diag_lowrank.diag_rank1_matvec(t(alpha), t(W[:, 0]), t(rhs)),
               jdl.diag_rank1_matvec(alpha, W[:, 0], rhs))
        _close(diag_lowrank.diag_rank1_solve(t(alpha), t(W[:, 0]), t(rhs)),
               jdl.diag_rank1_solve(alpha, W[:, 0], rhs))
    _close(diag_lowrank.diag_lowrank_dense(t(alpha), t(W)), jdl.diag_lowrank_dense(alpha, W))
    _close(diag_lowrank.diag_lowrank_logdet(t(alpha), t(W)), jdl.diag_lowrank_logdet(alpha, W))
    _close(diag_lowrank.diag_rank1_dense(t(alpha), t(W[:, 0])),
           jdl.diag_rank1_dense(alpha, W[:, 0]))
    _close(diag_lowrank.diag_rank1_logdet(t(alpha), t(W[:, 0])),
           jdl.diag_rank1_logdet(alpha, W[:, 0]))


@pytest.mark.parametrize("bandwidth", (1, 2))
def test_banded_matches_jax(bandwidth):
    """banded_to_dense, dense_to_banded and banded_matvec (vector and matrix
    right-hand sides), exact."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 8))
    a = a + a.T
    bands = np.asarray(jbanded.dense_to_banded(jnp.asarray(a), bandwidth))
    np.testing.assert_array_equal(banded.dense_to_banded(torch.as_tensor(a), bandwidth).numpy(),
                                  bands)
    np.testing.assert_array_equal(banded.banded_to_dense(torch.as_tensor(bands)).numpy(),
                                  np.asarray(jbanded.banded_to_dense(jnp.asarray(bands))))
    v = rng.standard_normal((8, 3))
    for rhs in (v, v[:, 0]):
        _close(banded.banded_matvec(torch.as_tensor(bands), torch.as_tensor(rhs)),
               jbanded.banded_matvec(jnp.asarray(bands), jnp.asarray(rhs)))


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
def test_gamma_lowers_match_jax(dtype):
    """γ(2, x) and γ(3, x) across the series and the direct branch, f64 to
    1e-12 and f32 to 1e-6 of JAX's float32 (the same series cut-offs), and
    the coefficient tables equal the JAX package's."""
    assert stablemath._G2_COEFF == jstable._G2_COEFF
    assert stablemath._G3_COEFF == jstable._G3_COEFF
    x = np.concatenate([np.geomspace(1e-6, 0.999, 40), np.linspace(1.0, 30.0, 30)]).astype(dtype)
    rtol = RTOL if dtype == np.float64 else 1e-6
    for fn, jfn in ((stablemath.gamma2_lower, jstable.gamma2_lower),
                    (stablemath.gamma3_lower, jstable.gamma3_lower)):
        _close(fn(torch.as_tensor(x)), jfn(jnp.asarray(x)), rtol)


def test_gamma_lowers_keep_float32_accuracy_on_short_cells():
    """In float32 the series meets the float64 value to 2e-7 relative at
    x = λh ≪ 1, where the direct antiderivative difference cancels."""
    x = np.geomspace(1e-5, 0.5, 20)
    for fn, exact in ((stablemath.gamma2_lower, lambda x: 1.0 - (1.0 + x) * np.exp(-x)),
                      (stablemath.gamma3_lower,
                       lambda x: 2.0 - (2.0 + 2.0 * x + x * x) * np.exp(-x))):
        ref = fn(torch.as_tensor(x)).numpy()
        got = fn(torch.as_tensor(x, dtype=torch.float32)).double().numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-7)
        np.testing.assert_allclose(ref[-5:], exact(x[-5:]), rtol=1e-9)


@pytest.mark.parametrize("name", ("b0", "b1", "fourier12", "fourier32", "fourier52"))
def test_basis_matches_jax(name):
    """The standalone bases at points on both sides of [0, 1], 1e-12."""
    make = {"b0": lambda m: m.B0SplineBasis(0.0, 1.0, 8),
            "b1": lambda m: m.B1SplineBasis(0.0, 1.0, 9),
            "fourier12": lambda m: m.FourierBasisMatern12(4, 0.0, 1.0, 0.2),
            "fourier32": lambda m: m.FourierBasisMatern32(4, 0.0, 1.0, 0.2),
            "fourier52": lambda m: m.FourierBasisMatern52(4, 0.0, 1.0, 0.2)}[name]
    b, jb = make(basis), make(jbasis)
    _close(b(torch.as_tensor(X)), jb(jnp.asarray(X)))
    _close(b(X, device="cpu"), jb(jnp.asarray(X)))
    if hasattr(jb, "mesh"):
        np.testing.assert_array_equal(b.mesh, jb.mesh)
    if name.startswith("fourier"):
        assert b.m == jb.m


@pytest.mark.parametrize("name", ("b0", "b1", "fourier"))
def test_basis_places_input_as_entry_points_do(name, monkeypatch):
    """A tensor stays on its own device; any other input goes to
    ``config.resolve_device(device)`` (``cuda`` unless the caller names
    another), as ``convert.params_from_jax`` places its leaves."""
    b = {"b0": basis.B0SplineBasis(0.0, 1.0, 8), "b1": basis.B1SplineBasis(0.0, 1.0, 9),
         "fourier": basis.FourierBasisMatern32(4, 0.0, 1.0, 0.2)}[name]
    asked = []
    monkeypatch.setattr(config, "resolve_device",
                        lambda device=None: asked.append(device) or torch.device("cpu"))
    for x, device in ((X, None), (X.tolist(), None), (X, "cpu")):
        want = b(torch.as_tensor(x))
        got = b(x, device=device)
        assert got.device.type == "cpu"
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)
    assert asked == [None, None, "cpu"]
