"""Symmetric Toeplitz operators (port of ``vggp_tpu/ops/toeplitz.py``):
the dense matrix for a factorization, and the O(m log m) FFT matvec of the
matrix-free path."""

from __future__ import annotations

import torch


def sym_toeplitz_dense(first_row: torch.Tensor) -> torch.Tensor:
    """Dense symmetric Toeplitz matrix T[i, j] = first_row[|i − j|].

    An index-table gather: cheap on the card, and differentiable (forward and
    reverse mode) through ``first_row``.
    """
    m = first_row.shape[0]
    k = torch.arange(m, device=first_row.device)
    return first_row[(k[:, None] - k[None, :]).abs()]


def sym_toeplitz_operator(first_row: torch.Tensor):
    """The map v ↦ T @ v of :func:`sym_toeplitz_matvec`, with the circulant's
    transform computed once for every product that follows."""
    m = first_row.shape[0]
    # the circulant's first column: [r0, r1, …, r_{m−1}, 0, r_{m−1}, …, r1]
    c = torch.cat([first_row, first_row.new_zeros(1), first_row[1:].flip(0)])
    fc = torch.fft.rfft(c)[:, None]

    def apply(v: torch.Tensor) -> torch.Tensor:
        squeeze = v.dim() == 1
        if squeeze:
            v = v[:, None]
        fv = torch.fft.rfft(v, n=2 * m, dim=0)
        out = torch.fft.irfft(fc * fv, n=2 * m, dim=0)[:m].to(v.dtype)
        return out[:, 0] if squeeze else out

    return apply


def sym_toeplitz_matvec(first_row: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T @ v by circulant embedding of length 2m and real FFTs, O(m log m).

    ``v`` is (m,) or (m, k); the product runs down the first axis. The JAX
    package swaps in a complex-free FFT on the TPU, which has no complex
    arithmetic; cuFFT and the CPU's FFT serve here.
    """
    return sym_toeplitz_operator(first_row)(v)
