"""Library-wide toggles of the PyTorch port (counterpart of ``vggp_tpu/config.py``).

The names and defaults follow the JAX package so that a reader can hold the
two side by side. Precision strings keep the JAX vocabulary and are mapped
onto PyTorch by :func:`matmul_precision`: "highest" and "high" are full fp32
on the card (no TF32), "default" lets cuBLAS use TF32.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# Matmul precision for model math run under :func:`highest_precision` (ELBO,
# KL, predictions) and for every gradient product: the whitened ℓ-tangent
# (``models.common._whitened_kuf_tangent``) and the backward of the
# Kronecker q(f) moments. Full fp32 on the card. The JAX package gives the
# gradient products a GRAD_MATMUL_PRECISION of one bf16 pass on the TPU;
# the port has none. On an H100, a TF32 tangent moved the ℓ-gradients by
# 47% in the collapsed bound and by 4% to 20× in the SVGP under the
# non-Gaussian likelihoods; a TF32 moments backward put the Student-t
# SVGP's dℓ 3.3e-3 from float64, 26× the CPU's float32 error.
MATMUL_PRECISION: str = "high"

# Precision of the whitening apply F⁻¹·Kuf: its result is consumed through
# the cancellation k_ff − ‖a‖², so it is fp32-accurate, never single-pass
# TF32 (full fp32 in cuBLAS, a six-product bf16 split in the fused kernel).
WHITEN_MATMUL_PRECISION: str = "highest"

# Whitened-block gradients through two precomputed scalar tangents
# (``models.common.whitened_kuf_scalar``).
SCALAR_WHITEN_VJP: bool = True

# Block-bidiagonal whitening apply of the structured F⁻¹ (``ops.kms``), with a
# dense fallback when the geometric ratio reaches 0.7.
BANDED_WHITEN_APPLY: bool = True

# Hand-written backward of the Kronecker q(f) moments
# (``models.svgp.KronMoments``).
FAST_MOMENTS_BWD: bool = True

# Closed-form inverse Cholesky of the Matérn-1/2 cell Kuu (``ops.kms``).
STRUCTURED_FINV: bool = True

# Fuse the cell-Kuf construction into the banded whitening apply
# (``ops.cell_kuf.fused_banded_whiten_kuf``). "auto" fuses at
# n ≥ FUSED_WHITEN_MIN_POINTS; True/False force it.
FUSED_WHITEN_KUF: bool | str = "auto"
FUSED_WHITEN_MIN_POINTS: int = 16384


def fused_whiten_enabled(n: int) -> bool:
    mode = FUSED_WHITEN_KUF
    if mode == "auto":
        return n >= FUSED_WHITEN_MIN_POINTS
    return bool(mode)


# KMS preconditioners of the matrix-free CG path (``models.iterative``). When
# every axis is a uniform Matérn-1/2 cell feature, Kuu = γ·KMS(ρ) + η·I
# exactly and KMS⁻¹ is a closed tridiagonal, which gives
# (a) a near-exact ⊗(γ⁻¹KMS⁻¹) preconditioner for the sampler's Kuu solves,
#     where cond(Kuu) grows like (ℓ/δ)² and Jacobi scaling does little, and
# (b) a Woodbury preconditioner M = σ²·⊗(γᵢKMSᵢ) + KufKufᵀ for the G solve:
#     one (n, n) factorization, then O(m) tridiagonal matvecs per apply.
# (b) has its gates read from the parameters once a solve. Below
# u = δ/ℓ ≈ √eps the tridiagonal apply cancels to rounding noise (the u
# floor). The JAX package's float32 also waits until the largest ℓ/δ
# reaches its CG_KMS_MIN_STIFFNESS = 512, the regime where Jacobi CG
# stalls: with the u floor that leaves ℓ/δ ∈ [512, 579], where the float32
# M⁻¹ loses positive definiteness and PCG broke down within a few
# iterations at every ratio tried (tools/torch_cg_woodbury_f32.py). So the
# port's float32 never takes (b) and runs Jacobi PCG. The (n, n) build is
# gated off above CG_KMS_MAX_POINTS.
CG_KMS_PRECOND: bool = True
CG_KMS_MAX_POINTS: int = 8192


# The JAX package's Pallas minimums (64 cells, 128 points) have no
# counterpart: they guard the TPU's (128, 128) tile padding, while the CUDA
# kernels mask their ragged edges, so a CUDA tensor always takes the kernel.


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when no card is present rather than carrying on on the
    CPU; pass ``device="cpu"`` to run there on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vggp_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the enclosed matmuls at a JAX-named precision.

    "highest" and "high" disable TF32 for cuBLAS and cuDNN (full fp32);
    "default" enables it. The previous flags are restored on exit. CPU
    matmuls are unaffected.
    """
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown matmul precision {precision!r}")
    tf32 = precision == "default"
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def highest_precision(fn):
    """Run ``fn`` under :data:`MATMUL_PRECISION` (read at call time) —
    the counterpart of ``vggp_tpu.models.common.highest_precision``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)

    return wrapped
