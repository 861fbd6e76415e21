"""Numerical building blocks of the port, re-exported as
``vggp_tpu/ops/__init__.py`` does, less ``realfft``'s four names (the port
takes ``torch.fft``); ``cell_kuf`` holds the CUDA kernels."""

from vggp_tpu_torch.ops.chol import (
    PSDFactor,
    logdet_from_chol,
    psd_factor,
    psd_factor_eigh,
    safe_cholesky,
    solve_psd,
    tri_solve,
)
from vggp_tpu_torch.ops.toeplitz import sym_toeplitz_dense, sym_toeplitz_matvec
from vggp_tpu_torch.ops.kron import khatri_rao_rows, kron_dense, kron_diag, kron_matvec
from vggp_tpu_torch.ops.diag_lowrank import (
    diag_lowrank_dense,
    diag_lowrank_logdet,
    diag_lowrank_matvec,
    diag_lowrank_solve,
    diag_rank1_dense,
    diag_rank1_logdet,
    diag_rank1_matvec,
    diag_rank1_solve,
)
from vggp_tpu_torch.ops.banded import banded_matvec, banded_to_dense, dense_to_banded
from vggp_tpu_torch.ops.stablemath import expm1mx, expm1s

__all__ = [
    "safe_cholesky",
    "psd_factor",
    "psd_factor_eigh",
    "PSDFactor",
    "tri_solve",
    "solve_psd",
    "logdet_from_chol",
    "sym_toeplitz_dense",
    "sym_toeplitz_matvec",
    "kron_dense",
    "kron_matvec",
    "khatri_rao_rows",
    "kron_diag",
    "diag_rank1_dense",
    "diag_rank1_solve",
    "diag_rank1_logdet",
    "diag_rank1_matvec",
    "diag_lowrank_dense",
    "diag_lowrank_solve",
    "diag_lowrank_logdet",
    "diag_lowrank_matvec",
    "banded_to_dense",
    "dense_to_banded",
    "banded_matvec",
    "expm1mx",
    "expm1s",
]
