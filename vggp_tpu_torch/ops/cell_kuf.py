"""Matérn-1/2 cell-integral Kuf kernels: CUDA wrappers and plain versions.

Port of ``vggp_tpu/ops/pallas_kernels.py``. Each TPU kernel there has a
hand-written CUDA counterpart in ``csrc/`` and a plain PyTorch
version here, written from the same tile math:

- ``cell_kuf`` replaces ``pallas_kernels.py:84``; plain ``cell_kuf_plain``.
- ``cell_kuf_with_dl`` replaces ``pallas_kernels.py:134``; plain
  ``cell_kuf_with_dl_plain``.
- ``fused_banded_whiten_kuf`` replaces ``pallas_kernels.py:231``; plain
  ``fused_banded_whiten_kuf_plain``. Its float32 kernel is the tensor-core
  one of ``csrc/fused_whiten_tc.cu``; float64 runs ``csrc/cell_kuf.cu``.

A wrapper takes its plain version only for CPU tensors (the tests); for a
CUDA tensor it launches the kernel or raises. Each launch adds one to
:data:`LAUNCHES` (and, by shape, to :data:`SHAPE_LAUNCHES`), so a run can show
that its path went through the kernels. The counters also hold the closed-form
F⁻¹ kernel of ``ops.kms.m12_finv`` (``csrc/m12_finv.cu``), as ``m12_finv``
at (m, m). :data:`SHAPE_LAUNCHES` alone also counts each forward of the
three-axis moments' contraction (``models.svgp.KronMoments``), a step's
three products, as ``kron_contract`` at (Π m_i, n).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.ops.kms import BAND_BLOCK, banded_apply
from vggp_tpu_torch.ops.stablemath import expm1s

# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {"cell_kuf": 0, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0,
            "m12_finv": 0}
# The same launches by (wrapper name, m, n), and the ``kron_contract`` counts.
SHAPE_LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()


def _count(name: str, m: int, n: int) -> None:
    LAUNCHES[name] += 1
    SHAPE_LAUNCHES[name, m, n] += 1


# --------------------------------------------------------------------------- #
# plain versions (the tile math of pallas_kernels._tile_kuf_F / _tile_kuf_dkuf)
# --------------------------------------------------------------------------- #

def _tile_kuf_F(a, b, x, lengthscale):
    """F of the 3-case closed form: Kuf = σ²ℓ·F; a/b (rows, 1), x (1, n).

    Inside a cell, expm1(−u) + expm1(−w) = expm1(−δ/ℓ) − expm1(−u)·expm1(−w)
    moves the series onto the per-cell column: two plain exps per element.
    Returns (F, intermediates) for the ∂/∂ℓ tile.
    """
    u = torch.abs(x - a) / lengthscale
    w = torch.abs(x - b) / lengthscale
    inside = (x >= a) & (x <= b)
    dd = (b - a) / lengthscale
    em_dd = expm1s(-dd)
    e_u = torch.exp(-u)
    e_w = torch.exp(-w)
    enear = torch.maximum(e_u, e_w)
    F = torch.where(inside, -em_dd + (e_u - 1.0) * (e_w - 1.0), enear * (-em_dd))
    return F, (u, w, inside, dd, em_dd, e_u, e_w, enear)


def _tile_kuf_dkuf(a, b, x, variance, lengthscale):
    """(Kuf, ∂Kuf/∂ℓ) = (σ²ℓ·F, σ²(F + G)) of one tile."""
    F, (u, w, inside, dd, em_dd, e_u, e_w, enear) = _tile_kuf_F(a, b, x, lengthscale)
    near = torch.minimum(u, w)
    e_dd = 1.0 + em_dd
    G = torch.where(inside, -(e_u * u + e_w * w),
                    enear * (near * (-em_dd) - e_dd * dd))
    return variance * lengthscale * F, variance * (F + G)


def _edges(mesh, x):
    return mesh[:-1, None], mesh[1:, None], x.reshape(1, -1)


def cell_kuf_plain(mesh, x, variance, lengthscale):
    """(m, n) Kuf = σ²ℓ·F on tensors — the plain version of :func:`cell_kuf`."""
    a, b, xr = _edges(mesh, x)
    F, _ = _tile_kuf_F(a, b, xr, lengthscale)
    return variance * lengthscale * F


def cell_kuf_with_dl_plain(mesh, x, variance, lengthscale):
    """(Kuf, ∂Kuf/∂ℓ) on tensors — the plain version of :func:`cell_kuf_with_dl`."""
    a, b, xr = _edges(mesh, x)
    return _tile_kuf_dkuf(a, b, xr, variance, lengthscale)


def fused_banded_whiten_kuf_plain(finv, mesh, x, variance, lengthscale,
                                  a_precision: str, t_precision: str):
    """(F⁻¹·Kuf, F⁻¹·∂Kuf/∂ℓ) over the block-bidiagonal band, ``a`` at
    ``a_precision`` and ``t`` at ``t_precision`` (JAX names, through
    :func:`config.matmul_precision`: on the card "default" lets cuBLAS use
    TF32; on the CPU both are full precision) — the plain version of
    :func:`fused_banded_whiten_kuf`."""
    kuf, dkuf = cell_kuf_with_dl_plain(mesh, x, variance, lengthscale)
    with config.matmul_precision(a_precision):
        a = banded_apply(finv, kuf)
    with config.matmul_precision(t_precision):
        return a, banded_apply(finv, dkuf)


def _cell_kuf_FG(mesh, x, lengthscale):
    """(F, G) of the 3-case closed form with the per-element series
    (``pallas_kernels._cell_kuf_FG``): Kuf = σ²ℓ·F(ℓ), ℓF′(ℓ) = G."""
    a, b, xr = _edges(mesh, x)
    u = torch.abs(xr - a) / lengthscale
    w = torch.abs(xr - b) / lengthscale
    inside = (xr >= a) & (xr <= b)
    near = torch.minimum(u, w)
    dd = (b - a) / lengthscale
    enear = torch.exp(-near)
    em_dd = expm1s(-dd)
    F = torch.where(inside, -(expm1s(-u) + expm1s(-w)), enear * (-em_dd))
    G = torch.where(
        inside,
        -(torch.exp(-u) * u + torch.exp(-w) * w),
        enear * (near * (-em_dd) - torch.exp(-dd) * dd),
    )
    return F, G


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU; raises for a mix of devices
    or a device that is neither the CPU nor CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"cell-Kuf kernels need all tensors on one device, got {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cell-Kuf kernels run on CUDA (or plainly on the CPU), not {dev}")
    return dev.type == "cpu"


def _checked(mesh, x, finv=None):
    """Validate the kernel inputs; returns (dtype suffix, m, n)."""
    dtype = mesh.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"cell-Kuf kernels take float32 or float64, got {dtype}")
    for name, t in (("mesh", mesh), ("x", x), ("finv", finv)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, mesh is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mesh.dim() != 1 or mesh.shape[0] < 2:
        raise ValueError(f"mesh must be (m + 1,) with m ≥ 1, got {tuple(mesh.shape)}")
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be (n,) with n ≥ 1, got {tuple(x.shape)}")
    return _SUFFIX[dtype], mesh.shape[0] - 1, x.shape[0]


def _scal(variance, lengthscale, like):
    """[σ², ℓ] as a 2-element device array (no host read of either)."""
    return torch.stack([torch.as_tensor(v, dtype=like.dtype, device=like.device)
                        .detach().reshape(()) for v in (variance, lengthscale)])


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def cell_kuf(mesh, x, variance, lengthscale):
    """(m, n) Matérn-1/2 cell-integral Kuf. ``mesh``: (m + 1,) cell edges,
    ``x``: (n,) points. Not differentiable (see :func:`cell_kuf_op`)."""
    if _on_cpu(mesh, x):
        return cell_kuf_plain(mesh, x, variance, lengthscale)
    sfx, m, n = _checked(mesh, x)
    from vggp_tpu_torch.ops import _build

    lib = _build.load()
    scal = _scal(variance, lengthscale, mesh)
    out = torch.empty((m, n), dtype=mesh.dtype, device=mesh.device)
    rc = getattr(lib, f"cell_kuf_{sfx}")(_ptr(mesh), _ptr(x), _ptr(scal), _ptr(out),
                                         m, n, _stream(mesh))
    _raise_on(rc, "cell_kuf")
    _count("cell_kuf", m, n)
    return out


def cell_kuf_with_dl(mesh, x, variance, lengthscale):
    """(Kuf, ∂Kuf/∂ℓ) in one pass. Not differentiable: callers are
    scalar-tangent forwards that consume both outputs as values."""
    if _on_cpu(mesh, x):
        return cell_kuf_with_dl_plain(mesh, x, variance, lengthscale)
    sfx, m, n = _checked(mesh, x)
    from vggp_tpu_torch.ops import _build

    lib = _build.load()
    scal = _scal(variance, lengthscale, mesh)
    out = torch.empty((m, n), dtype=mesh.dtype, device=mesh.device)
    dl = torch.empty_like(out)
    rc = getattr(lib, f"cell_kuf_with_dl_{sfx}")(
        _ptr(mesh), _ptr(x), _ptr(scal), _ptr(out), _ptr(dl), m, n, _stream(mesh))
    _raise_on(rc, "cell_kuf_with_dl")
    _count("cell_kuf_with_dl", m, n)
    return out, dl


# JAX precision name → the float32 kernel's split flag: 1 for the
# fp32-accurate six-product bf16 split, 0 for one TF32 product.
_SPLIT = {"highest": 1, "high": 1, "default": 0}


def fused_banded_whiten_kuf(finv, mesh, x, variance, lengthscale,
                            a_precision: str, t_precision: str):
    """(a, t) = (F⁻¹·Kuf, F⁻¹·∂Kuf/∂ℓ) without materialising Kuf or ∂Kuf.

    ``finv`` must be block-bidiagonal at ``BAND_BLOCK`` (the caller gates on
    the geometric ratio, as for ``kms.banded_whiten_apply``) with m divisible
    by ``BAND_BLOCK`` and at least two blocks. ``a_precision`` and
    ``t_precision`` are the JAX kernel's strings: in float32 on the card
    "highest" and "high" are fp32-accurate (a six-product bf16 split on the
    tensor cores, the reference's 6-pass "highest") and "default" is one
    TF32 product; float64, and the plain version on the CPU, compute both at
    full precision. Any other string raises.
    """
    for prec in (a_precision, t_precision):
        if prec not in _SPLIT:
            raise ValueError(f"unknown matmul precision {prec!r}")
    if _on_cpu(finv, mesh, x):
        return fused_banded_whiten_kuf_plain(finv, mesh, x, variance, lengthscale,
                                             a_precision, t_precision)
    sfx, m, n = _checked(mesh, x, finv)
    if finv.shape != (m, m) or m % BAND_BLOCK != 0 or m // BAND_BLOCK < 2:
        raise ValueError(f"finv must be (m, m) with m a multiple of {BAND_BLOCK} "
                         f"and ≥ 2 blocks; got finv {tuple(finv.shape)}, m = {m}")
    from vggp_tpu_torch.ops import _build

    lib = _build.load()
    scal = _scal(variance, lengthscale, mesh)
    a = torch.empty((m, n), dtype=mesh.dtype, device=mesh.device)
    t = torch.empty_like(a)
    args = [_ptr(finv), _ptr(mesh), _ptr(x), _ptr(scal), _ptr(a), _ptr(t), m, n]
    if sfx == "f32":
        if finv.data_ptr() % 16 != 0:
            raise ValueError("finv must be 16-byte aligned for the float32 kernel")
        args += [_SPLIT[a_precision], _SPLIT[t_precision]]
    rc = getattr(lib, f"fused_banded_whiten_kuf_{sfx}")(*args, _stream(mesh))
    _raise_on(rc, "fused_banded_whiten_kuf")
    _count("fused_banded_whiten_kuf", m, n)
    return a, t


class CellKufOp(torch.autograd.Function):
    """Kuf with the kernel forward and the analytic backward of
    ``pallas_kernels._cell_kuf_bwd``: ∂/∂σ² = Σ ḡ·ℓF and
    ∂/∂ℓ = Σ ḡ·σ²(F + G), in plain torch. mesh and x get no gradient."""

    @staticmethod
    def forward(ctx, mesh, x, variance, lengthscale):
        ctx.save_for_backward(mesh, x, variance, lengthscale)
        return cell_kuf(mesh, x, variance, lengthscale)

    @staticmethod
    def backward(ctx, g):
        mesh, x, variance, lengthscale = ctx.saved_tensors
        F, G = _cell_kuf_FG(mesh, x, lengthscale)
        dv = torch.sum(g * (lengthscale * F))
        dl = torch.sum(g * (variance * (F + G)))
        return None, None, dv, dl


def cell_kuf_op(mesh, x, variance, lengthscale):
    """Differentiable (in σ² and ℓ) Kuf through :class:`CellKufOp`."""
    like = mesh
    variance = torch.as_tensor(variance, dtype=like.dtype, device=like.device)
    lengthscale = torch.as_tensor(lengthscale, dtype=like.dtype, device=like.device)
    return CellKufOp.apply(mesh, x, variance, lengthscale)
