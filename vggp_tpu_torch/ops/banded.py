"""Symmetric banded operators (port of ``vggp_tpu/ops/banded.py``): the B1
spline RKHS Gram is tridiagonal. Bands are stored LAPACK-style:
``bands[k]`` is the k-th superdiagonal padded with trailing zeros, so
``bands`` is (bandwidth + 1, m) with ``bands[0]`` the diagonal.
"""

from __future__ import annotations

import torch


def banded_to_dense(bands: torch.Tensor) -> torch.Tensor:
    """The dense symmetric matrix of its upper bands."""
    bw1, m = bands.shape
    out = torch.diag(bands[0])
    for k in range(1, bw1):
        d = bands[k][: m - k]
        out = out + torch.diag(d, k) + torch.diag(d, -k)
    return out


def dense_to_banded(a: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """The diagonal and ``bandwidth`` superdiagonals of a symmetric matrix."""
    rows = [torch.diagonal(a)]
    for k in range(1, bandwidth + 1):
        rows.append(torch.nn.functional.pad(torch.diagonal(a, k), (0, k)))
    return torch.stack(rows)


def banded_matvec(bands: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(diagonal + the super- and sub-bands) @ v in O(bandwidth · m); ``v``
    is (m,) or (m, k)."""
    bw1, m = bands.shape
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    out = bands[0][:, None] * v
    for k in range(1, bw1):
        d = bands[k][: m - k][:, None]
        pad = torch.zeros((k, v.shape[1]), dtype=out.dtype, device=out.device)
        out = out + torch.cat([d * v[k:], pad]) + torch.cat([pad, d * v[: m - k]])
    return out[:, 0] if squeeze else out
