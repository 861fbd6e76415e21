"""The port's last public names against the JAX package, and the per-row
form of the ``cell_kuf_with_dl`` kernel.

- ``kernels.KINDS``, ``validate_kind``, ``gram_product_2d``, ``kdiag_1d`` and
  ``kdiag_product_2d`` for each kind, and ``ops.chol.logdet_from_chol``:
  the same numpy inputs through both packages in float64, held at 1e-12.
- The re-exports of ``vggp_tpu_torch.ops`` and ``vggp_tpu_torch.models``:
  each name is its submodule's own object, and the name sets are the JAX
  package's, less ``realfft``'s four (the port takes ``torch.fft``).
  Importing ``models`` imports nothing outside the package that imports it
  back (no cycle).
- The arithmetic of ``csrc/cell_kuf.cu``'s ``cell_kuf_with_dl_kernel``,
  written out in numpy float32 (the row's coefficients once a row, one exp
  an element outside the cell), held against JAX's ``cell_kuf_with_dl`` in
  float64 within twice JAX's own float32 error, at ℓ/δ ≈ 550 (the main
  path's trained lengthscale on 512 cells, where the c0 term cancels) and
  ℓ/δ ≈ 5.
"""

import ast
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vggp_tpu.models as jmodels
import vggp_tpu.ops as jops
from vggp_tpu import kernels as jkernels
from vggp_tpu.ops import chol as jchol
from vggp_tpu.ops import pallas_kernels as jpk

import vggp_tpu_torch.models as tmodels
import vggp_tpu_torch.ops as tops
from vggp_tpu_torch import kernels
from vggp_tpu_torch.ops import chol

RTOL = 1e-12
REALFFT = ("circulant_matvec", "fft_pair", "ifft_pair", "sym_toeplitz_matvec_real")
PORT = Path(__file__).resolve().parents[1] / "vggp_tpu_torch"

_rng = np.random.default_rng(16)
X1 = _rng.random((23, 2)) * 1.2 - 0.1
X2 = _rng.random((17, 2)) * 1.2 - 0.1
P1 = {"variance": 1.3, "lengthscale": 0.27}
P2 = {"variance": 0.7, "lengthscale": 0.61}
# each kind on axis 0 beside the next one on axis 1
PAIRS = [(k, jkernels.KINDS[(i + 1) % 4]) for i, k in enumerate(jkernels.KINDS)]


def _close(got, want, rtol=RTOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _t(p):
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v, dtype=jnp.float64) for k, v in p.items()}


# --------------------------------------------------------------------------- #
# kernels and chol
# --------------------------------------------------------------------------- #

def test_kinds_are_the_jax_packages():
    assert kernels.KINDS == jkernels.KINDS
    assert kernels.STATIONARY_KINDS is kernels.KINDS
    for kind in kernels.KINDS:
        assert kernels.validate_kind(kind) == jkernels.validate_kind(kind)
    for bad in ("matern72", "coregion", ""):
        with pytest.raises(ValueError):
            jkernels.validate_kind(bad)
        with pytest.raises(ValueError, match="unknown kernel kind"):
            kernels.validate_kind(bad)


@pytest.mark.parametrize("kinds", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_gram_product_2d(kinds):
    got = kernels.gram_product_2d(kinds, torch.from_numpy(X1), torch.from_numpy(X2),
                                  _t(P1), _t(P2))
    want = jkernels.gram_product_2d(kinds, jnp.asarray(X1), jnp.asarray(X2), _j(P1), _j(P2))
    _close(got, want)


@pytest.mark.parametrize("kind", jkernels.KINDS)
def test_kdiag_1d(kind):
    x = X1[:, 0]
    got = kernels.kdiag_1d(kind, torch.from_numpy(x), torch.tensor(1.3, dtype=torch.float64),
                           torch.tensor(0.27, dtype=torch.float64))
    want = jkernels.kdiag_1d(kind, jnp.asarray(x), jnp.float64(1.3), jnp.float64(0.27))
    _close(got, want)
    assert got.dtype == torch.float64


@pytest.mark.parametrize("kinds", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_kdiag_product_2d(kinds):
    got = kernels.kdiag_product_2d(kinds, torch.from_numpy(X1), _t(P1), _t(P2))
    want = jkernels.kdiag_product_2d(kinds, jnp.asarray(X1), _j(P1), _j(P2))
    _close(got, want)
    # the diagonal of the product Gram
    _close(got, np.diag(np.asarray(jkernels.gram_product_2d(
        kinds, jnp.asarray(X1), jnp.asarray(X1), _j(P1), _j(P2)))))


@pytest.mark.parametrize("m", [1, 7, 64])
def test_logdet_from_chol(m):
    a = _rng.standard_normal((m, m))
    spd = a @ a.T + m * np.eye(m)
    L = np.linalg.cholesky(spd)
    got = chol.logdet_from_chol(torch.from_numpy(L))
    _close(got, jchol.logdet_from_chol(jnp.asarray(L)))
    _close(got, np.linalg.slogdet(spd)[1], rtol=1e-10)


# --------------------------------------------------------------------------- #
# the package re-exports
# --------------------------------------------------------------------------- #

OPS_NAMES = sorted(set(jops.__all__) - set(REALFFT))
MODELS_NAMES = sorted(jmodels.__all__)


def test_reexported_name_sets():
    assert set(REALFFT) <= set(jops.__all__)
    assert sorted(tops.__all__) == OPS_NAMES
    assert sorted(tmodels.__all__) == MODELS_NAMES
    assert len(OPS_NAMES) == 26 and len(MODELS_NAMES) == 13


def _port_twin(jax_obj):
    """The port's object of the same name in the same module as ``jax_obj``
    (a JAX module, or a function or class of one)."""
    if isinstance(jax_obj, type(sys)):
        return sys.modules[jax_obj.__name__.replace("vggp_tpu.", "vggp_tpu_torch.", 1)]
    module = sys.modules[jax_obj.__module__.replace("vggp_tpu.", "vggp_tpu_torch.", 1)]
    return getattr(module, jax_obj.__name__)


@pytest.mark.parametrize("name", OPS_NAMES)
def test_ops_reexport(name):
    assert getattr(tops, name) is _port_twin(getattr(jops, name))


@pytest.mark.parametrize("name", MODELS_NAMES)
def test_models_reexport(name):
    assert getattr(tmodels, name) is _port_twin(getattr(jmodels, name))


def _module_file(name: str):
    rel = Path(*name.split(".")[1:])
    for f in (PORT / rel.with_suffix(".py"), PORT / rel / "__init__.py"):
        if f.exists():
            return f
    return None


def _top_level_imports(name: str) -> set:
    """The port's modules that ``name`` imports at its top level."""
    out = set()
    for node in ast.parse(_module_file(name).read_text()).body:
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods = [f"{node.module}.{a.name}" if _module_file(f"{node.module}.{a.name}")
                    else node.module for a in node.names]
        else:
            continue
        out |= {m for m in mods if m.startswith("vggp_tpu_torch.")}
    return out


def test_models_package_has_no_import_cycle():
    seen, todo = set(), ["vggp_tpu_torch.models"]
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.add(name)
            todo += sorted(_top_level_imports(name))
    outside = sorted(m for m in seen if not m.startswith("vggp_tpu_torch.models"))
    assert "vggp_tpu_torch.ops.chol" in outside and "vggp_tpu_torch.features" in outside
    back = [m for m in outside
            if any(i.startswith("vggp_tpu_torch.models") for i in _top_level_imports(m))]
    assert not back, f"imported by vggp_tpu_torch.models and importing it back: {back}"


# --------------------------------------------------------------------------- #
# cell_kuf_with_dl's per-row form
# --------------------------------------------------------------------------- #

F32 = np.float32
# 1/(k + 2)!, k = 0..10: csrc/cell_tile.cuh's inv_fact
_INV_FACT = [1.0 / np.prod(np.arange(1, k + 3, dtype=np.float64)) for k in range(11)]


def _expm1s_f32(x):
    """csrc/cell_tile.cuh's expm1s in float32: 10 series terms below |x| = 1."""
    small = np.abs(x) < 1
    xs = np.where(small, x, F32(0)).astype(F32)
    acc = np.full_like(xs, F32(_INV_FACT[9]))
    for k in range(8, -1, -1):
        acc = acc * xs + F32(_INV_FACT[k])
    return np.where(small, acc * xs * xs + xs, np.exp(x) - F32(1)).astype(F32)


def _one_minus_1pd_emd_f32(d, om):
    """csrc/cell_tile.cuh's one_minus_1pd_emd in float32: 1 − (1 + d)e^{−d},
    11 series terms below d = 1."""
    xs = -d
    acc = np.full_like(d, F32(11 * _INV_FACT[10]))
    for k in range(9, -1, -1):
        acc = acc * xs + F32((k + 1) * _INV_FACT[k])
    return np.where(d < 1, acc * d * d, om - (F32(1) - om) * d).astype(F32)


def kernel_form_f32(mesh, x, variance, lengthscale):
    """(Kuf, ∂Kuf/∂ℓ) as cell_kuf_with_dl_kernel computes them, in float32:
    per row δ/ℓ = (b − a)·(1/ℓ), om = −expm1(−δ/ℓ), k = σ²ℓ·om, c1 = σ²·om,
    c0 = σ²(1 − (1 + δ/ℓ)e^{−δ/ℓ}); per element near = min(|x − a|,
    |x − b|)·(1/ℓ), e = exp(−near), Kuf = e·k, ∂Kuf/∂ℓ = e·(c0 + c1·near);
    inside the cell the far exp and the product identity."""
    with np.errstate(over="ignore"):
        mesh, x = mesh.astype(F32), x.astype(F32)
        var, ell = F32(variance), F32(lengthscale)
        inv_ell = F32(1) / ell
        var_ell = var * ell
        a, b = mesh[:-1, None], mesh[1:, None]
        dd = ((b - a) * inv_ell).astype(F32)
        em_dd = _expm1s_f32(-dd)
        om = -em_dd
        k, c1 = var_ell * om, var * om
        c0 = var * _one_minus_1pd_emd_f32(dd, om)
        xr = x[None, :]
        da, db = np.abs(xr - a), np.abs(xr - b)
        near = np.minimum(da, db) * inv_ell
        e = np.exp(-near)
        kuf = e * k
        dl = e * (c0 + c1 * near)
        far = np.maximum(da, db) * inv_ell
        efar = np.exp(-far)
        F = om + (e - F32(1)) * (efar - F32(1))
        inside = (xr >= a) & (xr <= b)
        kuf = np.where(inside, var_ell * F, kuf)
        dl = np.where(inside, var * (F - (e * near + efar * far)), dl)
    assert kuf.dtype == F32 and dl.dtype == F32
    return kuf, dl


@pytest.mark.parametrize("m, ell_over_delta", [(512, 550.0), (64, 5.0)])
def test_kernel_form_against_jax(m, ell_over_delta):
    mesh = np.linspace(0.0, 1.0, m + 1).astype(F32)
    rng = np.random.default_rng(m)
    x = np.concatenate([rng.random(1500) * 1.1 - 0.05, mesh[:: max(1, m // 32)]]).astype(F32)
    ell = F32(ell_over_delta / m)
    var = F32(1.3)
    ref = jpk.cell_kuf_with_dl(jnp.asarray(mesh, jnp.float64), jnp.asarray(x, jnp.float64),
                               jnp.float64(var), jnp.float64(ell))
    jax32 = jpk.cell_kuf_with_dl(jnp.asarray(mesh), jnp.asarray(x), jnp.float32(var),
                                 jnp.float32(ell))
    got = kernel_form_f32(mesh, x, var, ell)
    for name, g, j, r in zip(("Kuf", "dKuf"), got, jax32, ref):
        r = np.asarray(r)
        assert np.asarray(j).dtype == np.float32
        scale = np.abs(r).max()
        e_form = np.abs(g.astype(np.float64) - r).max() / scale
        e_jax = np.abs(np.asarray(j, np.float64) - r).max() / scale
        assert e_jax > 0
        assert e_form <= 2.0 * e_jax, (name, e_form, e_jax)
