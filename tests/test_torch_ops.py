"""The port's numerical ops and cell-Kuf kernels against the JAX package.

Inputs are made with numpy from a seed and fed to both packages in float64
on the CPU; the JAX Pallas kernels run in interpret mode, as
``tests/test_pallas.py`` runs them. On the CPU the port's kernel wrappers
take their plain PyTorch versions, so these tests hold the plain versions
(the arithmetic the CUDA kernels repeat) against the TPU kernels. The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu.features import _m12_cell_point_cov as jax_m12_cell_point_cov
from vggp_tpu.features import _m12_toeplitz_first_row as jax_first_row
from vggp_tpu.ops import chol as jax_chol
from vggp_tpu.ops import kms as jax_kms
from vggp_tpu.ops import pallas_kernels as jax_pk
from vggp_tpu.ops import stablemath as jax_sm
from vggp_tpu.ops.toeplitz import sym_toeplitz_dense as jax_toeplitz

from vggp_tpu_torch.features import _m12_cell_point_cov, _m12_toeplitz_first_row
from vggp_tpu_torch.ops import cell_kuf as ck
from vggp_tpu_torch.ops import chol, kms, stablemath
from vggp_tpu_torch.ops.toeplitz import sym_toeplitz_dense

REPO = Path(__file__).resolve().parents[1]


def T(a):
    """numpy/JAX array → float64 CPU tensor."""
    return torch.as_tensor(np.array(a, dtype=np.float64))


def N(t):
    return t.detach().numpy()


# --------------------------------------------------------------------------- #
# stablemath, Toeplitz, Cholesky — rtol 1e-13: the same series in the same
# order on both sides, so only the last bits of exp may differ
# --------------------------------------------------------------------------- #

_SM_X = np.concatenate([np.linspace(-3.0, 3.0, 601),
                        np.logspace(-8, 0, 57), -np.logspace(-8, 0, 57)])


@pytest.mark.parametrize("name", ["expm1s", "expm1mx", "sinhmx"])
def test_stablemath_matches_jax_f64(name):
    got = getattr(stablemath, name)(T(_SM_X))
    want = getattr(jax_sm, name)(jnp.asarray(_SM_X))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", ["expm1s", "expm1mx", "sinhmx"])
def test_stablemath_matches_jax_f32(name):
    """float32 keeps the JAX cut-offs (10 and 5 terms); the two libms' f32
    exp may differ by an ulp, hence rtol 1e-6."""
    x = _SM_X.astype(np.float32)
    got = getattr(stablemath, name)(torch.as_tensor(x))
    assert got.dtype == torch.float32
    want = getattr(jax_sm, name)(jnp.asarray(x))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-30)


def test_sym_toeplitz_dense_matches_jax():
    row = np.random.default_rng(3).standard_normal(37)
    np.testing.assert_allclose(N(sym_toeplitz_dense(T(row))),
                               np.asarray(jax_toeplitz(jnp.asarray(row))),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("ell", [0.003, 0.27, 4.0])
def test_m12_toeplitz_first_row_matches_jax(ell):
    m, delta, var = 256, 1.0 / 256, 1.3
    got = _m12_toeplitz_first_row(m, delta, T(var), T(ell), torch.float64)
    want = jax_first_row(m, delta, jnp.asarray(var), jnp.asarray(ell), jnp.float64)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-13, atol=0)


def test_safe_cholesky_matches_jax():
    a = np.random.default_rng(4).standard_normal((20, 20))
    a = a @ a.T
    np.testing.assert_allclose(N(chol.safe_cholesky(T(a), 1e-6)),
                               np.asarray(jax_chol.safe_cholesky(jnp.asarray(a), 1e-6)),
                               rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------- #
# ops/kms at m = 256 — rtol 1e-10: the Newton–Schulz step's two matmuls
# sum in another order on each side
# --------------------------------------------------------------------------- #

def _assert_close_scaled(got, want, rtol):
    """rtol on every entry, with an absolute floor of rtol·max|want| for the
    entries that decay geometrically towards 0."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("ell", [0.02, 0.27, 3.0])
def test_m12_cell_inv_chol_matches_jax(ell):
    m, var, rel = 256, 1.3, 1e-6
    got = kms.m12_cell_inv_chol(m, 1.0 / m, T(var), T(ell), rel)
    want = jax_kms.m12_cell_inv_chol(m, 1.0 / m, jnp.asarray(var), jnp.asarray(ell), rel)
    _assert_close_scaled(N(got), want, 1e-10)
    ratio = kms.m12_geometric_ratio(1.0 / m, T(ell), rel)
    want_ratio = jax_kms.m12_geometric_ratio(1.0 / m, jnp.asarray(ell), rel)
    np.testing.assert_allclose(float(ratio), float(want_ratio), rtol=1e-10)


@pytest.mark.parametrize("ell", [0.02, 0.27, 3.0])
def test_newton_schulz_step_squares_an_unstructured_error(ell):
    """The refinement's purpose: an unstructured 1e-6 per-entry error of the
    raw factor (the JAX package's TPU transcendental error) leaves a residual
    ‖I − F·X‖ that one step squares. Measured ratio ≤ 2e-4 at these ℓ;
    bound 1e-3 (a half step leaves 0.5)."""
    m = 256
    finv, f_mat = kms.m12_cell_factors(m, 1.0 / m, T(1.3), T(ell), 1e-6)
    noise = np.random.default_rng(8).standard_normal((m, m))
    x0 = finv + torch.tril(T(noise)) * 1e-6 * finv.abs().max()
    eye = torch.eye(m, dtype=torch.float64)
    resid = lambda x: float((eye - f_mat @ x).abs().max())
    assert resid(kms.newton_schulz_step(x0, f_mat)) < 1e-3 * resid(x0)


@pytest.mark.parametrize("ell", [0.02, 0.27, 3.0])
def test_m12_cell_inv_chol_f32_is_consistent_with_its_factor(ell):
    """float32 F⁻¹ against the float64 analytic factor: ‖I − F·F⁻¹‖ ≤ 2e-6
    (about 16 ulp; measured ≤ 4e-7 at m = 256). The raw closed form meets
    this on the CPU as well, which is why the step is held by the test
    above and not here."""
    m = 256
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    finv = kms.m12_cell_inv_chol(m, 1.0 / m, f32(1.3), f32(ell), 1e-6)
    assert finv.dtype == torch.float32
    _, f_mat = kms.m12_cell_factors(m, 1.0 / m, T(1.3), T(ell), 1e-6)
    resid = torch.eye(m, dtype=torch.float64) - f_mat @ finv.double()
    assert float(resid.abs().max()) < 2e-6


@pytest.mark.parametrize("q", [0.3, 0.8])
def test_banded_whiten_apply_matches_jax(q):
    """q < 0.7 takes the banded product, q ≥ 0.7 the dense one."""
    m, n = 256, 300
    finv = np.asarray(jax_kms.m12_cell_inv_chol(m, 1.0 / m, jnp.asarray(1.3),
                                                jnp.asarray(0.27), 1e-6))
    kuf = np.random.default_rng(5).standard_normal((m, n))
    got = kms.banded_whiten_apply(T(finv), T(kuf), T(q), "highest")
    want = jax_kms.banded_whiten_apply(jnp.asarray(finv), jnp.asarray(kuf),
                                       jnp.asarray(q), "highest")
    _assert_close_scaled(N(got), want, 1e-10)


# --------------------------------------------------------------------------- #
# the three kernels' plain versions against the TPU kernels
# --------------------------------------------------------------------------- #

_KUF_CASES = {
    # (mesh, points, σ², ℓ): points outside the mesh; a non-aligned (200, 301)
    "outside": (np.linspace(0.0, 1.0, 11),
                np.random.default_rng(0).random(37) * 1.4 - 0.2, 1.3, 0.27),
    "nonaligned": (np.linspace(-0.5, 2.0, 201), np.linspace(-1.0, 3.0, 301), 0.7, 1.5),
}


@pytest.mark.parametrize("case", sorted(_KUF_CASES))
def test_cell_kuf_plain_matches_pallas_interpret(case):
    """rtol 1e-12: the same tile math (the product identity inside cells)."""
    mesh, x, v, ell = _KUF_CASES[case]
    want = np.asarray(jax_pk.cell_kuf(jnp.asarray(mesh), jnp.asarray(x), v, ell))
    got = ck.cell_kuf(T(mesh), T(x), v, ell)
    assert got.shape == want.shape
    np.testing.assert_allclose(N(got), want, rtol=1e-12, atol=1e-14)
    # the per-element-series reference form agrees too
    ref = _m12_cell_point_cov(T(mesh), T(x), T(v), T(ell))
    np.testing.assert_allclose(
        N(ref), np.asarray(jax_m12_cell_point_cov(jnp.asarray(mesh), jnp.asarray(x), v, ell)),
        rtol=1e-12, atol=1e-14)


def _kernel_form_kuf(mesh, x, variance, lengthscale):
    """The cell_kuf kernel's arithmetic (``kuf_points`` in
    ``csrc/cell_tile.cuh``) in torch, in its order: 1/ℓ once; u and w as
    products by it; e^{−near} = exp(−min(u, w)) for every element; outside
    the cell Kuf = e^{−near}·σ²ℓ·(−expm1(−δ/ℓ)), the coefficient once per
    row; inside σ²ℓ·(−expm1(−δ/ℓ) + (e^{−near} − 1)(e^{−far} − 1)), with the
    far exp taken there only."""
    a, b, xr = mesh[:-1, None], mesh[1:, None], x.reshape(1, -1)
    var_ell = variance * lengthscale
    inv_ell = 1.0 / lengthscale
    em_dd = stablemath.expm1s(-(b - a) / lengthscale)
    u = torch.abs(xr - a) * inv_ell
    w = torch.abs(xr - b) * inv_ell
    enear = torch.exp(-torch.minimum(u, w))
    kuf = enear * (var_ell * (-em_dd))
    inside = (xr >= a) & (xr <= b)
    efar = torch.exp(-torch.maximum(u[inside], w[inside]))
    kuf[inside] = var_ell * (-em_dd.expand_as(kuf)[inside]
                             + (enear[inside] - 1.0) * (efar - 1.0))
    return kuf


_EDGE_MESH = np.linspace(0.0, 1.0, 17)
_KERNEL_FORM_CASES = {
    **_KUF_CASES,
    # every edge (both mesh ends included) and every cell's midpoint
    "edges": (_EDGE_MESH, np.concatenate([_EDGE_MESH, (_EDGE_MESH[:-1] + _EDGE_MESH[1:]) / 2]),
              1.3, 0.27),
    # points so far outside that float32's exp underflows to 0 (u > 100)
    "far": (_EDGE_MESH, np.array([-60.0, -30.0, -0.3, 0.4, 1.7, 45.0, 80.0]), 1.3, 0.27),
    "ell_small": (np.linspace(0.0, 1.0, 65),
                  np.random.default_rng(9).random(53) * 1.1 - 0.05, 0.8, 0.003),
    "ell_large": (np.linspace(0.0, 1.0, 65),
                  np.random.default_rng(10).random(53) * 1.1 - 0.05, 0.8, 4.0),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(_KERNEL_FORM_CASES))
def test_cell_kuf_kernel_form_matches_pallas_interpret(case, dtype):
    """The CUDA cell_kuf kernel's one-exp form against the TPU kernel
    (interpret mode) and the plain version, which take two exps per element
    and divide by ℓ: float64 at rtol 1e-12, float32 at 2e-5 of max|Kuf|
    (chip_smoke's bounds), and float32 exact zeros where exp underflows."""
    mesh, x, v, ell = (np.asarray(z, dtype=dtype) for z in _KERNEL_FORM_CASES[case])
    tt = lambda z: torch.as_tensor(z)
    got = N(_kernel_form_kuf(tt(mesh), tt(x), tt(v), tt(ell)))
    pallas = np.asarray(jax_pk.cell_kuf(jnp.asarray(mesh), jnp.asarray(x), jnp.asarray(v),
                                        jnp.asarray(ell)))
    plain = N(ck.cell_kuf_plain(tt(mesh), tt(x), tt(v), tt(ell)))
    assert got.dtype == pallas.dtype == plain.dtype == dtype
    for want in (pallas, plain):
        if dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
        else:
            assert np.abs(got - want).max() / np.abs(want).max() < 2e-5
    if case == "far" and dtype == np.float32:
        far = np.abs(x) > 40
        assert (got[:, far] == 0).all() and (plain[:, far] == 0).all()


@pytest.mark.parametrize("case", sorted(_KUF_CASES))
def test_cell_kuf_with_dl_matches_jax(case):
    """Off the TPU the JAX function evaluates ``_cell_kuf_FG``; the port's
    wrapper takes the tile form on the CPU at every size. rtol 1e-12."""
    mesh, x, v, ell = _KUF_CASES[case]
    want_k, want_d = jax_pk.cell_kuf_with_dl(jnp.asarray(mesh), jnp.asarray(x),
                                             jnp.asarray(v), jnp.asarray(ell))
    got_k, got_d = ck.cell_kuf_with_dl(T(mesh), T(x), T(v), T(ell))
    np.testing.assert_allclose(N(got_k), np.asarray(want_k), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(N(got_d), np.asarray(want_d), rtol=1e-12, atol=1e-14)
    plain_k, plain_d = ck.cell_kuf_with_dl_plain(T(mesh), T(x), T(v), T(ell))
    np.testing.assert_allclose(N(plain_k), np.asarray(want_k), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(N(plain_d), np.asarray(want_d), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("a_precision,t_precision",
                         [("highest", "highest"), ("highest", "default")])
def test_fused_banded_whiten_kuf_plain_matches_pallas_interpret(a_precision, t_precision):
    """m = 256, n = 300, float64, rtol 1e-10 (as tests/test_pallas.py), at
    the precisions the main path passes and at "highest" for both."""
    m, n = 256, 300
    mesh = np.linspace(0.0, 1.0, m + 1)
    x = np.random.default_rng(7).random(n) * 1.2 - 0.1
    v, ell, jit = 1.3, 0.27, 1e-6
    finv = jax_kms.m12_cell_inv_chol(m, 1.0 / m, jnp.asarray(v), jnp.asarray(ell), jit)
    a_want, t_want = jax_pk.fused_banded_whiten_kuf(
        finv, jnp.asarray(mesh), jnp.asarray(x), jnp.asarray(v), jnp.asarray(ell),
        a_precision, t_precision)
    a, t = ck.fused_banded_whiten_kuf(T(finv), T(mesh), T(x), T(v), T(ell),
                                      a_precision, t_precision)
    np.testing.assert_allclose(N(a), np.asarray(a_want), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(N(t), np.asarray(t_want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("bad", ["a", "t"])
def test_fused_banded_whiten_kuf_rejects_an_unknown_precision(bad):
    m = 256
    mesh, x = T(np.linspace(0.0, 1.0, m + 1)), T(np.linspace(0.0, 1.0, 64))
    finv = kms.m12_cell_inv_chol(m, 1.0 / m, T(1.0), T(0.3), 1e-6)
    precs = {"a": "highest", "t": "default", bad: "fastest"}
    with pytest.raises(ValueError, match="fastest"):
        ck.fused_banded_whiten_kuf(finv, mesh, x, T(1.0), T(0.3), precs["a"], precs["t"])
    with pytest.raises(ValueError, match="fastest"):
        ck.fused_banded_whiten_kuf_plain(finv, mesh, x, T(1.0), T(0.3), precs["a"], precs["t"])


# --------------------------------------------------------------------------- #
# CPU evidence for the float32 tensor-core kernel (csrc/fused_whiten_tc.cu)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ell", [0.27, 3.0])
def test_finv_diagonal_blocks_are_exactly_zero_above_the_diagonal(dtype, ell):
    """The ground for the kernel's skip of D's upper triangle: every 128-block
    on the diagonal of the port's F⁻¹ (after the Newton–Schulz step) is
    exactly 0 above its diagonal, at m = 512."""
    m = 512
    as_t = lambda v: torch.tensor(v, dtype=dtype)
    finv = kms.m12_cell_inv_chol(m, 1.0 / m, as_t(1.3), as_t(ell), 1e-6)
    diag, _ = kms.band_blocks(finv)
    upper = torch.triu(torch.ones(kms.BAND_BLOCK, kms.BAND_BLOCK, dtype=torch.bool), 1)
    assert diag.shape == (m // kms.BAND_BLOCK, kms.BAND_BLOCK, kms.BAND_BLOCK)
    assert bool((diag[:, upper] == 0).all())
    assert bool((diag[:, ~upper] != 0).any())


def _tf32(x, rounding="nearest"):
    """float32 → TF32 (10 explicit mantissa bits) by bit masking: round to
    nearest with ties away (the kernel's +half-ulp), or truncation (what the
    tensor core reads of an fp32 operand that was not rounded)."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _bf16(x):
    """float32 → bf16 value, round to nearest even (cvt.rn.bf16x2)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _pieces(x, count, rnd):
    """x ≈ p0 + p1 + … with each piece rounded by ``rnd`` and each remainder
    exact in float32."""
    out = []
    for _ in range(count):
        out.append(rnd(x))
        x = x - out[-1]
    return out


# the six bf16 products of the kernel's split: small ones first, big last
_SIX = [(1, 0), (0, 1), (2, 0), (0, 2), (1, 1)]


def _emulated_tc_product(finv, k, split):
    """The kernel's arithmetic in plain torch: the band product of rounded
    pieces with fp32 accumulation, the small products and the big one summed
    apart as in the kernel. ``split``: "tf32" one TF32 product, "3xtf32" the
    three-product TF32 split, "bf16x6" the kernel's six-product bf16 split."""
    band = kms.banded_apply
    if split == "tf32":
        return band(_tf32(finv), _tf32(k))
    if split == "3xtf32":
        d, kk = _pieces(finv, 2, _tf32), _pieces(k, 2, _tf32)
        pairs = _SIX[:2]
    else:
        d, kk = _pieces(finv, 3, _bf16), _pieces(k, 3, _bf16)
        pairs = _SIX
    small = sum(band(d[i], kk[j]) for i, j in pairs)
    return band(d[0], kk[0]) + small


@pytest.mark.parametrize("ell", [0.27, 3.0])
def test_tensor_core_arithmetic_meets_the_precision_contract(ell):
    """At (512, 2048), against the f64 product of the same f32 inputs
    (max|Δ|/max): the kernel's six-product bf16 split of ``a`` (the
    reference's 6-pass "highest") is within 2× of the plain fp32 product's
    own error (measured 0.8–1.0×), while the 3xTF32 split misses it by more
    than 2× (measured 3.6–5.2×: 22 of fp32's 24 bits, amplified by the
    cancellation in F⁻¹·Kuf) although it costs the same tensor time; and
    colsum(a²) stays within the 2e-4 that chip_smoke holds the card to. The
    one-pass TF32 ``t`` is within 2× of a TF32 product that reads its fp32
    inputs by truncation. These fix chip_smoke.py's tolerances."""
    m, n = 512, 2048
    rng = np.random.default_rng(11)
    mesh = torch.linspace(0.0, 1.0, m + 1, dtype=torch.float64).float()
    x = torch.as_tensor(rng.random(n) * 1.1 - 0.05, dtype=torch.float32)
    v, l32 = torch.tensor(1.3), torch.tensor(ell)
    finv = kms.m12_cell_inv_chol(m, 1.0 / m, v, l32, 1e-6)
    kuf, dkuf = ck.cell_kuf_with_dl_plain(mesh, x, v, l32)
    band = kms.banded_apply
    err = lambda got, want: float((got.double() - want).abs().max() / want.abs().max())

    a_ref = band(finv.double(), kuf.double())
    e_fp32 = err(band(finv, kuf), a_ref)
    a6 = _emulated_tc_product(finv, kuf, "bf16x6")
    assert err(a6, a_ref) <= 2.0 * e_fp32
    assert err(_emulated_tc_product(finv, kuf, "3xtf32"), a_ref) > 2.0 * e_fp32
    colsum = lambda a: torch.sum(a.double() ** 2, dim=0)
    assert err(colsum(a6), colsum(a_ref)) < 2e-4

    t_ref = band(finv.double(), dkuf.double())
    e_t = err(_emulated_tc_product(finv, dkuf, "tf32"), t_ref)
    e_trunc = err(_tf32(finv, "truncate") @ _tf32(dkuf, "truncate"), t_ref)
    assert e_t <= 2.0 * e_trunc


def test_cell_kuf_op_gradients_match_jax():
    """Analytic backward vs the JAX custom_vjp, rtol 1e-10."""
    rng = np.random.default_rng(2)
    mesh = np.linspace(0.0, 1.0, 9)
    x = rng.random(21)
    g = rng.standard_normal((8, 21))
    want = jax.grad(lambda v, ell: jnp.sum(jax_pk.cell_kuf_op(
        jnp.asarray(mesh), jnp.asarray(x), v, ell) * g), argnums=(0, 1))(
            jnp.asarray(1.3), jnp.asarray(0.4))
    v = T(1.3).requires_grad_(True)
    ell = T(0.4).requires_grad_(True)
    torch.sum(ck.cell_kuf_op(T(mesh), T(x), v, ell) * T(g)).backward()
    np.testing.assert_allclose(float(v.grad), float(want[0]), rtol=1e-10)
    np.testing.assert_allclose(float(ell.grad), float(want[1]), rtol=1e-10)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    ck.reset_launch_counts()
    mesh, x = T(np.linspace(0.0, 1.0, 257)), T(np.linspace(0.0, 1.0, 300))
    finv = kms.m12_cell_inv_chol(256, 1.0 / 256, T(1.0), T(0.3), 1e-6)
    np.testing.assert_array_equal(N(ck.cell_kuf(mesh, x, 1.0, 0.3)),
                                  N(ck.cell_kuf_plain(mesh, x, 1.0, 0.3)))
    ck.cell_kuf_with_dl(mesh, x, T(1.0), T(0.3))
    ck.fused_banded_whiten_kuf(finv, mesh, x, T(1.0), T(0.3), "highest", "default")
    assert ck.LAUNCHES == {k: 0 for k in ck.LAUNCHES}


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape"])
def test_kernel_input_checks_raise(bad):
    mesh = torch.linspace(0.0, 1.0, 65, dtype=torch.float64)
    x = torch.linspace(0.0, 1.0, 256, dtype=torch.float64)
    if bad == "dtype":
        mesh, x = mesh.to(torch.int64), x.to(torch.int64)
    elif bad == "contiguity":
        x = torch.linspace(0.0, 1.0, 512, dtype=torch.float64)[::2]
    else:
        x = x.reshape(16, 16)
    with pytest.raises((TypeError, ValueError)):
        ck._checked(mesh, x)


def test_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError):
        ck._on_cpu(torch.zeros(3), torch.zeros(3, device="meta"))


# --------------------------------------------------------------------------- #
# package boundary
# --------------------------------------------------------------------------- #

def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vggp_tpu_torch\n"
        "for m in pkgutil.walk_packages(vggp_tpu_torch.__path__, 'vggp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'vggp_tpu', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "for m in ('hyperpost', 'lbfgs', 'train', 'convert', 'api', 'utils', 'utils.metrics',\n"
        "          'utils.scalers', 'utils.datagen', 'utils.integrators', 'parallel',\n"
        "          'parallel.mesh', 'parallel.dp', 'parallel.cg', 'data', 'data.transforms',\n"
        "          'data.simulation', 'data.missions', 'data.gulfstream'):\n"
        "    assert 'vggp_tpu_torch.' + m in sys.modules, m\n"
        "print('ok', len([k for k in sys.modules if k.startswith('vggp_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert int(proc.stdout.split()[1]) >= 14   # every module of the package was imported
