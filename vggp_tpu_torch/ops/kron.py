"""Kronecker-product helpers (port of ``vggp_tpu/ops/kron.py:24-62``).

Index convention of ``numpy.kron``: ``kron(A, B)`` has row index
``i_A * rows(B) + i_B`` (row-major flattening of the (i_A, i_B) pair).
``kron_dense`` is for tests and small gridded covariances only.
"""

from __future__ import annotations

from typing import Sequence

import torch


def kron_dense(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Materialized Kronecker product of a list of matrices (tests / small m)."""
    out = mats[0]
    for m in mats[1:]:
        # contiguous operands: a Cholesky factor from LAPACK is column-major,
        # which torch.kron's autograd path cannot view
        out = torch.kron(out.contiguous(), m.contiguous())
    return out


def khatri_rao_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column-wise Kronecker (row-wise Khatri–Rao): (m1, n), (m2, n) →
    (m1·m2, n); column j is ``kron(a[:, j], b[:, j])``."""
    m1, n = a.shape
    m2 = b.shape[0]
    return (a[:, None, :] * b[None, :, :]).reshape(m1 * m2, n)


def kron_diag(diags: Sequence[torch.Tensor]) -> torch.Tensor:
    """diag(A₁ ⊗ … ⊗ A_d) from per-factor diagonals (outer product, flattened)."""
    out = diags[0]
    for d in diags[1:]:
        out = (out[:, None] * d[None, :]).reshape(-1)
    return out


def kron_matvec(mats: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(A₁ ⊗ … ⊗ A_d) @ x without the product: one matmul per factor on the
    reshaped (∏ m_i,) vector ``x``."""
    t = x.reshape([m.shape[1] for m in mats])
    for i, a in enumerate(mats):
        t = torch.movedim(torch.tensordot(a, t, dims=([1], [i])), 0, i)
    return t.reshape(-1)
