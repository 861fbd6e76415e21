"""Diagonal-plus-low-rank operators A = diag(α) + W Wᵀ (port of
``vggp_tpu/ops/diag_lowrank.py``): the structure of the VFF Kuu, rank 1
for Matérn-1/2, 2 for Matérn-3/2 and 3 for Matérn-5/2. Solve and logdet go
through Woodbury and the matrix determinant lemma, O(m r²) instead of O(m³).
"""

from __future__ import annotations

import torch


def diag_rank1_dense(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return torch.diag(alpha) + torch.outer(beta, beta)


def diag_rank1_matvec(alpha: torch.Tensor, beta: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if v.dim() == 1:
        return alpha * v + beta * torch.dot(beta, v)
    return alpha[:, None] * v + torch.outer(beta, beta @ v)


def diag_rank1_solve(alpha: torch.Tensor, beta: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (diag(α) + ββᵀ) x = b by Sherman–Morrison."""
    ia = 1.0 / alpha
    denom = 1.0 + torch.sum(beta * beta * ia)
    if b.dim() == 1:
        iab = ia * b
        return iab - ia * beta * (torch.sum(beta * iab) / denom)
    iab = ia[:, None] * b
    return iab - torch.outer(ia * beta, beta @ iab) / denom


def diag_rank1_logdet(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """log|diag(α) + ββᵀ| by the matrix determinant lemma."""
    return torch.sum(torch.log(alpha)) + torch.log1p(torch.sum(beta * beta / alpha))


def diag_lowrank_dense(alpha: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return torch.diag(alpha) + W @ W.T


def diag_lowrank_matvec(alpha: torch.Tensor, W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (alpha * v if v.dim() == 1 else alpha[:, None] * v) + W @ (W.T @ v)


def _cap_chol(alpha: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of the (r, r) capacitance I + Wᵀ diag(α)⁻¹ W."""
    cap = torch.eye(W.shape[1], dtype=W.dtype, device=W.device) + W.T @ (W / alpha[:, None])
    return torch.linalg.cholesky(0.5 * (cap + cap.T))


def diag_lowrank_solve(alpha: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (diag(α) + W Wᵀ) x = b by Woodbury, O(m r²)."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    ia_b = b / alpha[:, None]
    t = torch.cholesky_solve(W.T @ ia_b, _cap_chol(alpha, W))       # (r, k)
    x = ia_b - (W / alpha[:, None]) @ t
    return x[:, 0] if vec else x


def diag_lowrank_logdet(alpha: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """log|diag(α) + W Wᵀ| by the matrix determinant lemma."""
    return (torch.sum(torch.log(alpha))
            + 2.0 * torch.sum(torch.log(torch.diagonal(_cap_chol(alpha, W)))))
