"""PSD-safe Cholesky, triangular solves and PSD factors (port of
``vggp_tpu/ops/chol.py``)."""

from __future__ import annotations

import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.config import matmul_precision

DEFAULT_JITTER = 1e-6
# float32 relative jitter floor (see the JAX package for its derivation).
F32_MIN_JITTER = 1e-6


class WhitenMatmul(torch.autograd.Function):
    """finv @ b with the forward at ``config.WHITEN_MATMUL_PRECISION`` and the
    backward at ``config.MATMUL_PRECISION`` (``chol.py:26-55``).

    The forward product feeds cancellations such as k_ff − ‖a‖² and must be
    fp32-accurate (no TF32 on the card); its cotangent products are
    gradients and take the ambient precision.
    """

    @staticmethod
    def forward(ctx, finv, b):
        ctx.save_for_backward(finv, b)
        with matmul_precision(config.WHITEN_MATMUL_PRECISION):
            return finv @ b

    @staticmethod
    def backward(ctx, g):
        finv, b = ctx.saved_tensors
        with matmul_precision(config.MATMUL_PRECISION):
            dfinv = torch.outer(g, b) if b.dim() == 1 else g @ b.T
            return dfinv, finv.T @ g


def safe_cholesky(a: torch.Tensor, jitter: float = DEFAULT_JITTER) -> torch.Tensor:
    """Lower Cholesky of ``(a + aᵀ)/2 + jitter·mean(diag)·I``.

    float64 uses ``jitter`` as given; float32 floors it at
    :data:`F32_MIN_JITTER`. A matrix that is not positive definite raises
    (``torch.linalg.LinAlgError``), on the card as on the CPU.
    """
    a = 0.5 * (a + a.T)
    n = a.shape[-1]
    rel = jitter if a.dtype == torch.float64 else max(jitter, F32_MIN_JITTER)
    scale = torch.mean(torch.diagonal(a)) * rel
    return torch.linalg.cholesky(a + scale * torch.eye(n, dtype=a.dtype, device=a.device))


def tri_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L x = b`` for lower-triangular L; ``b`` a vector or a matrix."""
    if b.dim() == 1:
        return torch.linalg.solve_triangular(chol, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(chol, b, upper=False)


class PSDFactor:
    """Cholesky factor of a PSD matrix, A ≈ F Fᵀ with F lower-triangular,
    and its whitening solve. (The JAX package's clamped-eigh flavour is not
    ported: ROADMAP queue 1, item 10.)"""

    __slots__ = ("F",)

    def __init__(self, F):
        self.F = F          # (m, m), A = F @ F.T

    def whiten(self, b: torch.Tensor) -> torch.Tensor:
        """F⁻¹ b: a triangular solve, or, when b has more columns than F has
        rows, one explicit triangular inverse and one fp32-accurate
        :class:`WhitenMatmul` (``chol.py:123-148``)."""
        m = self.F.shape[0]
        cols = 1 if b.dim() == 1 else b.shape[-1]
        if cols > m:
            eye = torch.eye(m, dtype=self.F.dtype, device=self.F.device)
            finv = torch.linalg.solve_triangular(self.F, eye, upper=False)
            return WhitenMatmul.apply(finv, b)
        return tri_solve(self.F, b)


def psd_factor(a: torch.Tensor, jitter: float = DEFAULT_JITTER) -> PSDFactor:
    """Jittered-Cholesky PSD factor of ``(a + aᵀ)/2`` (:func:`safe_cholesky`)."""
    return PSDFactor(safe_cholesky(a, jitter))
