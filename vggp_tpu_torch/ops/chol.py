"""PSD-safe Cholesky, triangular solves and PSD factors (port of
``vggp_tpu/ops/chol.py``)."""

from __future__ import annotations

import math

import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.config import matmul_precision
from vggp_tpu_torch.tracing import traced

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


def tri_solve(chol: torch.Tensor, b: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``Lᵀ x = b`` with ``trans``) for lower-triangular
    L; ``b`` a vector or a matrix."""
    a = chol.T if trans else chol
    if b.dim() == 1:
        return torch.linalg.solve_triangular(a, b[:, None], upper=trans)[:, 0]
    return torch.linalg.solve_triangular(a, b, upper=trans)


def solve_psd(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given the lower Cholesky factor of A."""
    return tri_solve(chol, tri_solve(chol, b), trans=True)


def logdet_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """log|A| from its lower Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol)))


# Relative eigenvalue floors of the clamped-eigh factor, by dtype
# (``chol.py:160-168``): a condition-number cap in place of a failure.
EIG_FLOOR_F32 = 1e-6
EIG_FLOOR_F64 = 1e-12


class PSDFactor:
    """Factor of a PSD matrix, A ≈ F Fᵀ, with its whitening solve, in two
    flavours (``chol.py:100-159``):

    - Cholesky (``tri=True``): F lower-triangular; ``whiten`` a triangular
      solve. Differentiable; the training path's factor.
    - clamped-eigh (``tri=False``): F = QΛ^½ with the eigenvalues floored
      at a relative threshold and F⁻¹ = Λ^{−½}Qᵀ stored; ``whiten`` one
      fp32-accurate product, NaN-free for any symmetric input. For the
      serving heads of extremely ill-conditioned Grams, not for training
      (the gradient of eigh carries 1/(λ_i − λ_j)).
    """

    __slots__ = ("F", "Finv", "tri")

    def __init__(self, F, Finv=None, tri=True):
        self.F = F          # (m, m), A = F @ F.T
        self.Finv = Finv    # (m, m) explicit F⁻¹, only for tri=False
        self.tri = tri

    @traced("vggp.dispatch.whiten")
    def whiten(self, b: torch.Tensor) -> torch.Tensor:
        """F⁻¹ b. Cholesky: a triangular solve, or, when b has more columns
        than F has rows, one explicit triangular inverse and one
        fp32-accurate :class:`WhitenMatmul` (``chol.py:123-148``). Eigh: the
        stored F⁻¹ through :class:`WhitenMatmul`."""
        if not self.tri:
            return WhitenMatmul.apply(self.Finv, b)
        m = self.F.shape[0]
        cols = 1 if b.dim() == 1 else b.shape[-1]
        if cols > m:
            eye = torch.eye(m, dtype=self.F.dtype, device=self.F.device)
            finv = torch.linalg.solve_triangular(self.F, eye, upper=False)
            return WhitenMatmul.apply(finv, b)
        return tri_solve(self.F, b)

    @property
    def logdet(self) -> torch.Tensor:
        """log|A| = 2 log|F|: the diagonal of a Cholesky factor, the column
        norms of QΛ^½."""
        if self.tri:
            return 2.0 * torch.sum(torch.log(torch.diagonal(self.F)))
        return 2.0 * torch.sum(torch.log(torch.linalg.vector_norm(self.F, dim=0)))


def psd_factor(a: torch.Tensor, method: str = "chol",
               jitter: float = DEFAULT_JITTER) -> PSDFactor:
    """PSD factor of ``(a + aᵀ)/2``: the jittered Cholesky
    (:func:`safe_cholesky`) or the clamped eigendecomposition
    (:func:`psd_factor_eigh`, which takes no jitter)."""
    if method == "chol":
        return PSDFactor(safe_cholesky(a, jitter))
    if method == "eigh":
        return psd_factor_eigh(a)
    raise ValueError(f"unknown factor method {method!r}")


def _sign_reference(m: int, like: torch.Tensor) -> torch.Tensor:
    """c_i = frac((i + 1)·φ) + ½, φ the golden ratio: a fixed vector with
    no symmetry, against which each eigenvector's sign is fixed."""
    i = torch.arange(1, m + 1, dtype=torch.float64)
    return torch.remainder(i * ((1.0 + math.sqrt(5.0)) / 2.0), 1.0).add_(0.5).to(like)


def psd_factor_eigh(a: torch.Tensor, rel_floor: float = None) -> PSDFactor:
    """Clamped-eigh PSD factor of ``(a + aᵀ)/2`` (``chol.py:175-187``): the
    eigenvalues floored at ``rel_floor``·max(λ) (EIG_FLOOR_F32 or
    EIG_FLOOR_F64 by dtype).

    Each eigenvector's sign is fixed so that its product with a fixed
    reference vector (:func:`_sign_reference`) is positive. The JAX package
    leaves the sign to its solver; LAPACK and cuSOLVER pick differently, and
    whitened parameters carried between devices would then describe another
    model. (The largest-magnitude entry cannot decide it: the antisymmetric
    eigenvectors of a symmetric Toeplitz Gram have their largest entries in
    ± pairs.) No sign-invariant result changes.
    """
    a = 0.5 * (a + a.T)
    if rel_floor is None:
        rel_floor = EIG_FLOOR_F64 if a.dtype == torch.float64 else EIG_FLOOR_F32
    w, q = torch.linalg.eigh(a)
    w = torch.maximum(w, rel_floor * torch.max(w))
    s = torch.sign(_sign_reference(q.shape[0], q) @ q)
    q = q * torch.where(s == 0, torch.ones_like(s), s)[None, :]
    sw = torch.sqrt(w)
    return PSDFactor(q * sw[None, :], (q / sw[None, :]).T, tri=False)
