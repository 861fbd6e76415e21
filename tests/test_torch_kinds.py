"""The port's cell features of every kernel kind, on uniform and non-uniform
meshes, against the JAX package.

Matérn-1/2, 3/2, 5/2 and RBF B0 cell features on an 8-cell uniform mesh and
on the 7-cell non-uniform mesh of ``tests/test_nonuniform.py``, at three
lengthscales (ℓ/δ from 0.3 to 20, so the RBF row takes both its erfc and
its Gauss–Legendre branch). Both packages get the same numpy inputs in
float64 on the CPU, JAX in x64 (its Pallas kernels fall back to their jnp
forms at these sizes); the JAX side is one jitted program per test group.
Blocks are held at rtol 1e-12 with atol 1e-12·max|ref|, the whitened
ℓ-tangent at 1e-10, value-and-grad of each model family at 1e-9. In
float32 the Toeplitz rows are held against the ``bench.py`` goldens within
its 2e-4 and the ELBO against JAX's float32 within ``bench.py``'s
``_FAMILY_TOL_DEFAULT`` (2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from vggp_tpu import kernels as jkernels
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import common as jcommon
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import svgp as jsvgp

import chip_smoke
from vggp_tpu_torch import convert, kernels, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import common, exact, sgpr, svgp

RTOL_BLOCK = 1e-12
RTOL_TANGENT = 1e-10
RTOL_MODEL = 1e-9

KINDS = ("matern12", "matern32", "matern52", "rbf")
MESHES = {"uniform": np.linspace(0.0, 1.0, 9),
          "nonuniform": np.array([0.0, 0.07, 0.21, 0.30, 0.55, 0.61, 0.90, 1.0])}
GRID = np.array([-0.1, 0.05, 0.3, 0.42, 0.8, 1.15])   # serving cells for Kvu
ELLS = (0.04, 0.3, 2.5)
VAR = 1.3
_rng = np.random.default_rng(0)
X = np.concatenate([_rng.random(40) * 1.4 - 0.2, MESHES["nonuniform"]])


def _close(got, want, rtol):
    want, got = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in (want, got))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _blocks(feat, grid, kind, p, x):
    """The blocks of one (feature, kind) that both packages have by the
    same names (the same code runs on either side)."""
    out = {"Kuf": feat.Kuf(kind, p, x), "Kvu": feat.Kvu(kind, p, grid),
           "Kuu": feat.Kuu(kind, p), "kuu_diag": feat.kuu_diag(kind, p),
           "dKuf_dl": feat.Kuf_with_dl(kind, p, x)[1]}
    if feat.uniform:
        out["row"] = feat.kuu_first_row(kind, p)
    if kind in jkernels.DIFFERENTIABLE_KINDS:
        out["dKuf_dx"] = feat.dKuf_dx(kind, p, x)
        out["dKuf_dx2"] = feat.dKuf_dx2(kind, p, x)
    return out


@pytest.fixture(scope="module")
def jax_blocks():
    """Every JAX block, by (ℓ, mesh, kind, name), from one compiled program."""
    feats = {name: JaxCellFeature(mesh) for name, mesh in MESHES.items()}
    grid = JaxCellFeature(GRID)

    @jax.jit
    def run(ell, x):
        p = {"variance": jnp.asarray(VAR), "lengthscale": ell}
        return {(mname, kind): _blocks(f, grid, kind, p, x)
                for mname, f in feats.items() for kind in KINDS}

    return {ell: jax.tree.map(np.asarray, run(jnp.asarray(ell), jnp.asarray(X)))
            for ell in ELLS}


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_cell_blocks_match_jax(jax_blocks, kind, mesh, ell):
    """Kuf, Kvu, Kuu, diag(Kuu), the Toeplitz row (uniform mesh), the
    ℓ-tangent of Kuf and the x-derivative blocks of one kind, f64, 1e-12."""
    feat, grid = CellIntegralFeature(MESHES[mesh]), CellIntegralFeature(GRID)
    p = {"variance": torch.tensor(VAR, dtype=torch.float64),
         "lengthscale": torch.tensor(ell, dtype=torch.float64)}
    got = _blocks(feat, grid, kind, p, torch.as_tensor(X))
    want = jax_blocks[ell][mesh, kind]
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], RTOL_BLOCK)


@pytest.mark.parametrize("kind", KINDS)
def test_nonuniform_row_and_m12_slope_raise_as_jax(kind):
    """The Toeplitz row of a non-uniform mesh raises ValueError in both
    packages; so does the k′-difference block of Matérn-1/2, which has no k′."""
    mesh = MESHES["nonuniform"]
    for f, p, x in ((CellIntegralFeature(mesh),
                     {"variance": torch.tensor(VAR, dtype=torch.float64),
                      "lengthscale": torch.tensor(0.3, dtype=torch.float64)},
                     torch.as_tensor(X[:3])),
                    (JaxCellFeature(mesh),
                     {"variance": jnp.asarray(VAR), "lengthscale": jnp.asarray(0.3)},
                     jnp.asarray(X[:3]))):
        with pytest.raises(ValueError, match="Toeplitz-only"):
            f.kuu_first_row(kind, p)
        if kind not in jkernels.DIFFERENTIABLE_KINDS:
            with pytest.raises(ValueError, match="once-differentiable"):
                f.dKuf_dx2(kind, p, x)


def test_kernel_derivatives_match_jax():
    """dk_dr, neg_d2k_dr2, grad_variance, dgram_1d and grad_gram_1d of each
    differentiable kind, f64, 1e-12; Matérn-1/2 raises ValueError in both."""
    r = np.linspace(-2.0, 2.0, 41)
    x1, x2 = X[:9], X[9:30]
    for kind in jkernels.DIFFERENTIABLE_KINDS:
        for fn, args in (("dk_dr", (r,)), ("neg_d2k_dr2", (r,)), ("dgram_1d", (x1, x2)),
                         ("grad_gram_1d", (x1, x2))):
            got = getattr(kernels, fn)(kind, *(torch.as_tensor(a) for a in args),
                                       torch.tensor(VAR, dtype=torch.float64),
                                       torch.tensor(0.3, dtype=torch.float64))
            _close(got, getattr(jkernels, fn)(kind, *(jnp.asarray(a) for a in args), VAR, 0.3),
                   RTOL_BLOCK)
        _close(kernels.grad_variance(kind, torch.tensor(VAR, dtype=torch.float64),
                                     torch.tensor(0.3, dtype=torch.float64)),
               jkernels.grad_variance(kind, VAR, 0.3), RTOL_BLOCK)
    for mod in (kernels, jkernels):
        with pytest.raises(ValueError, match="once-differentiable"):
            mod.require_differentiable("matern12")
        with pytest.raises(ValueError, match="twice-differentiable"):
            mod.require_twice_differentiable("matern32")
        with pytest.raises(ValueError, match="unknown kernel kind"):
            mod.require_differentiable("matern33")


# --------------------------------------------------------------------------- #
# the whitened ℓ-tangent of the scalar-tangent whitening, every kind and mesh
# --------------------------------------------------------------------------- #

# (kind, mesh, float64 relative jitter): Matérn-1/2 on the uniform mesh
# takes the closed forms (F⁻¹ of ops.kms, the Toeplitz ∂Kuu/∂ℓ), every other
# case the dense factor and the forward-mode tangent of the jittered Kuu
_TANGENT_CASES = [(kind, mesh, 1e-6) for kind in KINDS for mesh in sorted(MESHES)]
_TANGENT_ELL = 0.3
_G = np.random.default_rng(5).standard_normal((8, X.shape[0]))


@pytest.fixture(scope="module")
def jax_tangents():
    """(a, the VJP (dℓ, dσ²) of Σ g·a, and ∂a/∂ℓ by jax.jvp of the dense
    route F⁻¹Kuf) for every case, from one compiled program."""
    feats = {name: JaxCellFeature(mesh) for name, mesh in MESHES.items()}

    def dense_a(feat, kind, rel, ell, x):
        k = feat.Kuu(kind, {"lengthscale": ell, "variance": jnp.asarray(VAR)})
        k = 0.5 * (k + k.T)
        k = k + jnp.mean(jnp.diagonal(k)) * rel * jnp.eye(k.shape[0])
        F = jnp.linalg.cholesky(k)
        kuf = feat.Kuf(kind, {"lengthscale": ell, "variance": jnp.asarray(VAR)}, x)
        return jax.scipy.linalg.solve_triangular(F, kuf, lower=True)

    @jax.jit
    def run(ell, var, x):
        out = {}
        for kind, mesh, rel in _TANGENT_CASES:
            f = feats[mesh]
            g = jnp.asarray(_G[:f.m])
            a, vjp = jax.vjp(lambda l, v: jcommon.whitened_kuf_scalar(
                f, kind, rel, {"lengthscale": l, "variance": v}, x), ell, var)
            _, da = jax.jvp(lambda l: dense_a(f, kind, rel, l, x), (ell,), (jnp.ones_like(ell),))
            out[kind, mesh] = (a, vjp(g), da)
        return out

    return jax.tree.map(np.asarray, run(jnp.asarray(_TANGENT_ELL), jnp.asarray(VAR),
                                        jnp.asarray(X)))


@pytest.mark.parametrize("kind,mesh,rel", _TANGENT_CASES)
def test_whitened_tangent_matches_jax(jax_tangents, kind, mesh, rel):
    """a = F⁻¹Kuf, its scalar-tangent backward (dℓ, dσ²) against JAX's
    ``whitened_kuf_scalar`` VJP and ∂a/∂ℓ against jax.jvp of the dense
    route, f64, to 1e-10 (F⁻¹ of the RBF Gram at rel jitter 1e-6 amplifies
    the two factorizations' roundoff past 1e-12)."""
    feat = CellIntegralFeature(MESHES[mesh])
    ell = torch.tensor(_TANGENT_ELL, dtype=torch.float64, requires_grad=True)
    var = torch.tensor(VAR, dtype=torch.float64, requires_grad=True)
    x = torch.as_tensor(X)
    a = common.whitened_kuf_scalar(feat, kind, rel, {"lengthscale": ell, "variance": var}, x)
    dl, dv = torch.autograd.grad(torch.sum(torch.as_tensor(_G[:feat.m]) * a), (ell, var))
    _, da = common._whitened_kuf_tangent(feat, kind, rel, ell.detach(), var.detach(), x)
    a_j, (dl_j, dv_j), da_j = jax_tangents[kind, mesh]
    _close(a, a_j, RTOL_TANGENT)
    _close(dl, dl_j, RTOL_TANGENT)
    _close(dv, dv_j, RTOL_TANGENT)
    _close(da, da_j, RTOL_TANGENT)


def test_kuu_jitter_tangent_reads_the_diagonal():
    """On a non-uniform mesh the jitter's ℓ-derivative is mean(diag ∂K)·rel,
    not ∂K[0, 0]·rel: the tangent's diagonal against a central difference of
    the jittered Gram, f64."""
    feat = CellIntegralFeature(MESHES["nonuniform"])
    var, ell, h, rel = torch.tensor(VAR, dtype=torch.float64), 0.3, 1e-5, 1e-2
    dk = common._kuu_jittered_dl(feat, "matern32", rel, torch.tensor(ell, dtype=torch.float64),
                                 var)
    fd = (common._kuu_jittered(feat, "matern32", rel, torch.tensor(ell + h, dtype=torch.float64),
                               var)
          - common._kuu_jittered(feat, "matern32", rel,
                                 torch.tensor(ell - h, dtype=torch.float64), var)) / (2 * h)
    _close(torch.diagonal(dk), torch.diagonal(fd), 1e-7)


# --------------------------------------------------------------------------- #
# value-and-grad of each model family
# --------------------------------------------------------------------------- #

# (family, kinds, per-axis meshes): Matérn-3/2 cells in each family, and
# Matérn-1/2 on the non-uniform mesh in the two that have cells
_MODEL_CASES = {
    "svgp-matern32": ("svgp", ("matern32", "matern32"), ("uniform", "nonuniform")),
    "svgp-matern12-nonuniform": ("svgp", ("matern12", "matern12"), ("nonuniform", "nonuniform")),
    "sgpr-matern32": ("sgpr", ("matern32", "matern32"), ("uniform", "uniform")),
    "sgpr-matern12-nonuniform": ("sgpr", ("matern12", "matern12"), ("nonuniform", "uniform")),
    "exact-matern32": ("exact", ("matern32", "matern32"), None),
}
_N_MODEL = 60
_XM = np.random.default_rng(8).random((_N_MODEL, 2))
_YM = np.sin(6 * _XM[:, 0]) * np.cos(4 * _XM[:, 1]) + 0.1 * np.random.default_rng(9).standard_normal(
    _N_MODEL)


def _model_spec(mods, case):
    """(model module, spec) of a case in the JAX package (``mods`` its
    svgp, sgpr and exact modules) or in the port."""
    family, kinds, meshes = _MODEL_CASES[case]
    svgp_m, sgpr_m, exact_m = mods
    if family == "exact":
        return exact_m, exact_m.ExactGPSpec(kinds)
    feats = tuple((JaxCellFeature if svgp_m is jsvgp else CellIntegralFeature)(MESHES[m])
                  for m in meshes)
    if family == "svgp":
        return svgp_m, svgp_m.SVGPSpec(kinds=kinds, features=feats, num_data=500,
                                       variational="kron")
    return sgpr_m, sgpr_m.SGPRSpec(kinds=kinds, features=feats)


def _model_params(case):
    family, kinds, meshes = _MODEL_CASES[case]
    rng = np.random.default_rng(3)
    p = {"axes": ({"variance": np.asarray(1.2), "lengthscale": np.asarray(0.25)},
                  {"variance": np.asarray(0.9), "lengthscale": np.asarray(0.35)}),
         "noise": np.asarray(0.03)}
    if family == "svgp":
        ms = [len(MESHES[m]) - 1 for m in meshes]
        p["q"] = {"mu": 0.3 * rng.standard_normal(ms)}
        for i, m in enumerate(ms):
            p["q"][f"raw_L{i + 1}"] = (np.asarray(jsvgp.raw_from_chol(jnp.eye(m)))
                                       + 0.05 * np.tril(rng.standard_normal((m, m))))
    return p


@pytest.fixture(scope="module")
def jax_models():
    """(loss, its gradient) of every case in float64, and the loss in
    float32, from one compiled program."""
    mods = (jsvgp, jsgpr, jexact)

    @jax.jit
    def run(params, x, y):
        out = {}
        for case in _MODEL_CASES:
            mod, spec = _model_spec(mods, case)
            f = lambda p, x, y: mod.loss(spec, p, x, y)
            out[case] = (*jax.value_and_grad(f)(params[case], x, y),
                         f(jax.tree.map(lambda v: v.astype(jnp.float32), params[case]),
                           x.astype(jnp.float32), y.astype(jnp.float32)))
        return out

    params = {case: jax.tree.map(jnp.asarray, _model_params(case)) for case in _MODEL_CASES}
    return jax.tree.map(np.asarray, run(params, jnp.asarray(_XM), jnp.asarray(_YM)))


@pytest.mark.parametrize("case", sorted(_MODEL_CASES))
def test_model_value_and_grad_match_jax(jax_models, case):
    """The loss and every gradient leaf in float64 to 1e-9; the float32 loss
    against JAX's float32 within 2e-3."""
    mod, spec = _model_spec((svgp, sgpr, exact), case)
    loss_j, grads_j, loss32_j = jax_models[case]
    for dtype in (torch.float64, torch.float32):
        p = convert.params_from_jax(_model_params(case), device="cpu", dtype=dtype)
        p = train.tree_map(lambda v: v.requires_grad_(), p)
        x, y = (torch.as_tensor(a, dtype=dtype) for a in (_XM, _YM))
        val = mod.loss(spec, p, x, y)
        if dtype == torch.float32:
            _close(val, loss32_j, bench._FAMILY_TOL_DEFAULT)
            continue
        _close(val, loss_j, RTOL_MODEL)
        val.backward()
        got = train.tree_map(lambda v: v.grad.numpy(), p)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(grads_j), strict=True):
            _close(g, w, RTOL_MODEL)


# --------------------------------------------------------------------------- #
# float32: the bench goldens of the Toeplitz rows
# --------------------------------------------------------------------------- #

def test_chip_smoke_goldens_are_the_bench_goldens():
    """chip_smoke carries its own copy of the bench goldens (it imports
    nothing of the JAX package): the copy is exact."""
    for name in ("_GOLD_M32_ROW3", "_GOLD_M52_ROW3", "_GOLD_RBF_ROW4", "_GOLD_P",
                 "_GOLD_KUF_SAMPLES", "_GOLD_KUF_SUM"):
        assert getattr(chip_smoke, name) == getattr(bench, name), name


@pytest.mark.parametrize("kind", ("matern32", "matern52", "rbf"))
def test_f32_rows_meet_the_bench_goldens(kind):
    """The float32 Toeplitz row of the 128-cell golden feature against the
    float64 goldens of ``bench.py:71-73`` within its 2e-4, as
    ``chip_smoke.check_goldens`` holds it on the card."""
    gold = chip_smoke.GOLD_ROWS[kind]
    g = CellIntegralFeature.from_lims(128, 0.0, 1.0)
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in bench._GOLD_P.items()}
    row = g.kuu_first_row(kind, p)[:len(gold)].double().numpy()
    err = np.abs(row - gold).max() / np.abs(gold).max()
    assert err < chip_smoke.GOLD_TOL_F32, err


def test_f32_m12_gram_on_a_fine_uneven_mesh():
    """Matérn-1/2 cells on chip_smoke's 512-cell mesh refined toward its
    middle, at ℓ = 1 (ℓ/δ up to 727): the port's product-form Gram agrees
    with the JAX package's in float64 (rtol 1e-9: the generic form's own
    float64 cancellation) and in float32 keeps λ_min within 1% of float64,
    where the generic form's float32 Gram is indefinite (ROADMAP queue 3)."""
    mesh = chip_smoke.stretched_mesh(512)
    feat = CellIntegralFeature(mesh)
    k64 = feat.Kuu("matern12", {"variance": torch.tensor(1.0, dtype=torch.float64),
                                "lengthscale": torch.tensor(1.0, dtype=torch.float64)})
    _close(k64, JaxCellFeature(mesh).Kuu("matern12", {"variance": jnp.asarray(1.0),
                                                      "lengthscale": jnp.asarray(1.0)}), 1e-9)
    lam = {}
    for dtype in (torch.float32, torch.float64):
        k = common._kuu_jittered(feat, "matern12", 1e-6, torch.tensor(1.0, dtype=dtype),
                                 torch.tensor(1.0, dtype=dtype))
        assert int(torch.linalg.cholesky_ex(k).info) == 0
        lam[dtype] = float(torch.linalg.eigvalsh(k.double())[0])
    assert abs(lam[torch.float32] - lam[torch.float64]) < 1e-2 * lam[torch.float64], lam


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_tangents_leave_the_device_caches_plain(monkeypatch, kind, mesh):
    """A gradient through the scalar-tangent whitening, whose forward-mode
    tangents are the first to fill a fresh feature's mesh cache and the GL-24
    constants: every cached tensor is plain and has storage, as a kernel
    launch needs (under ``torch.func.jvp`` they were wrapped tensors
    without one, and the next ``cell_kuf_with_dl`` launch raised)."""
    from vggp_tpu_torch import features

    monkeypatch.setattr(features, "_GL24_ON_DEVICE", {})
    feat = CellIntegralFeature(MESHES[mesh])
    ell = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    var = torch.tensor(VAR, dtype=torch.float64, requires_grad=True)
    a = common.whitened_kuf_scalar(feat, kind, 1e-6, {"lengthscale": ell, "variance": var},
                                   torch.as_tensor(X))
    torch.sum(a * a).backward()
    cached = [*feat._meshes.values(), *(t for pair in features._GL24_ON_DEVICE.values()
                                        for t in pair)]
    assert cached
    for t in cached:
        assert not torch._C._functorch.is_functorch_wrapped_tensor(t)
        assert t.data_ptr() != 0
