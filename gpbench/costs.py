"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and the
operations and bytes that each kernel and each step or request needs,
computed from shapes alone.

Every count here is what the algorithm needs, not what the program happens
to issue: a triangular factor counts its triangle, a symmetric product
A·Aᵀ its upper half, a banded F⁻¹ its band. So no share computed from them
can pass 1 when the time measured is the whole of the work.

The kernel accounting is the one ``chip_smoke.py`` uses (its ``kuf_bounds``
and ``fused_bounds``), copied so that a change to the program cannot move
the yardstick.
"""

from __future__ import annotations

# H100 SXM published dense peaks at the full 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 67e12        # FP64 tensor cores
FP32_FLOPS_PER_S = 67e12        # fp32 on the CUDA cores (no TF32)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2   # an FMA counts as two operations

# The fused kernel's tensor-core products per needed FMA for each JAX-named
# precision: six bf16 products for the fp32-accurate split ("highest",
# "high"), one TF32 product for "default" (csrc/fused_whiten_tc.cu).
TC_PRODUCTS = {"highest": 6, "high": 6, "default": 1}
# The precisions the main path gives the fused kernel: the whitening a at
# config.WHITEN_MATMUL_PRECISION, the ℓ-tangent t at config.MATMUL_PRECISION.
MAIN_PRECISIONS = ("highest", "high")

# fp32 instructions per output element of the cell tile math (the count and
# its derivation are chip_smoke.py's): Kuf alone 16, Kuf with ∂Kuf/∂ℓ 22.
OPS_KUF = 16
OPS_KUF_DL = 22

BAND_BLOCK = 128   # the block of the banded F⁻¹ (vggp_tpu_torch.ops.kms)

# Peak FLOP/s by the precision name a product count carries.
PEAKS = {"fp64": FP64_FLOPS_PER_S, "fp32": FP32_FLOPS_PER_S, "bf16x6": BF16_FLOPS_PER_S / 6}

F4 = 4


def band_entries(m: int) -> int:
    """Entries of the block-bidiagonal F⁻¹ that the whitening needs: the lower
    triangles of the m/128 diagonal blocks and the m/128 − 1 sub-diagonal
    blocks."""
    nb = m // BAND_BLOCK
    return nb * BAND_BLOCK * (BAND_BLOCK + 1) // 2 + (nb - 1) * BAND_BLOCK ** 2


def kuf_bound_s(m: int, n: int, with_dl: bool) -> float:
    """Least time (s) of ``cell_kuf`` (or ``cell_kuf_with_dl``) at (m, n) in
    float32: the bytes (mesh, x, [σ², ℓ], the outputs) over HBM, or the
    needed instructions over the fp32 issue rate, whichever is larger."""
    outs = 2 if with_dl else 1
    t_bytes = ((m + 1 + n + 2) + outs * m * n) * F4 / HBM_BYTES_PER_S
    t_ops = m * n * (OPS_KUF_DL if with_dl else OPS_KUF) / FP32_INSTR_PER_S
    return max(t_bytes, t_ops)


def fused_bound_s(m: int, n: int, precisions=MAIN_PRECISIONS) -> float:
    """Least time (s) of ``fused_banded_whiten_kuf`` at (m, n): the bytes (the
    band of F⁻¹, mesh, x, scalars, the two outputs) over HBM, or the
    operations: the band's FMAs at the tensor-core products each precision
    takes, beside the Kuf and ∂Kuf/∂ℓ generation on the CUDA cores."""
    band = band_entries(m)
    t_bytes = (band + m + 1 + n + 2 + 2 * m * n) * F4 / HBM_BYTES_PER_S
    tensor = sum(2 * TC_PRODUCTS[p] * band * n
                 / (BF16_FLOPS_PER_S if TC_PRODUCTS[p] > 1 else TF32_FLOPS_PER_S)
                 for p in precisions)
    t_gen = m * n * OPS_KUF_DL / FP32_INSTR_PER_S
    return max(t_bytes, max(tensor, t_gen))


# The device kernel of each wrapper, as the profiler names it, and its bound.
KERNEL_SYMBOLS = {
    "cell_kuf": "cell_kuf_primal_kernel",
    "cell_kuf_with_dl": "cell_kuf_with_dl_kernel",
    "fused_banded_whiten_kuf": "fused_whiten_tc_kernel",
}
KERNEL_BOUNDS = {
    "cell_kuf": lambda m, n: kuf_bound_s(m, n, with_dl=False),
    "cell_kuf_with_dl": lambda m, n: kuf_bound_s(m, n, with_dl=True),
    "fused_banded_whiten_kuf": lambda m, n: fused_bound_s(m, n),
}


def kernel_bound_s(name: str, shape_launches) -> float:
    """Least time (s) of every launch of kernel ``name`` in ``shape_launches``,
    a mapping (wrapper name, m, n) → launches."""
    return sum(count * KERNEL_BOUNDS[name](m, n)
               for (kname, m, n), count in shape_launches.items() if kname == name)


def tri(m: int) -> int:
    """FMAs per column of a product by an (m, m) triangular matrix."""
    return m * (m + 1) // 2


# ----------------------------------------------------------------------------
# the products of one step or request, as {precision: FMAs}
# ----------------------------------------------------------------------------

def _add(out: dict, prec: str, fmas: float) -> None:
    out[prec] = out.get(prec, 0.0) + fmas


def svgp_kron_fit_fmas(axis_m, n: int) -> dict:
    """One minibatch step of the whitened Kronecker SVGP (two axes or more)
    at batch ``n``: loss, backward and update.

    Forward, per axis i: the whitening a_i = F_i⁻¹Kuf_i and its ℓ-tangent
    t_i = F_i⁻¹∂Kuf_i over the band of the closed-form F⁻¹ where the axis
    blocks into two bands or more (fp32-accurate: the least time is the
    six-product bf16 split's, whether or not the program fuses), else
    through the triangle (fp32), and
    Φ(M_i)·a_i with Φ lower-triangular (fp32). The moments: the mean's
    contraction of μ against every axis (Π m_i FMAs a point for the first
    axis contracted, fewer after) and L_iᵀa_i (triangular). Backward of the
    moments: ∂μ (the same contraction), ∂a_i (one contraction an axis),
    L_i·∂t_i and the lower triangle of a_i·∂t_iᵀ. The (m_i, m_i) products
    of M_i and the KL are O(m_i³) and left out."""
    out: dict = {}
    for m in axis_m:
        if m % BAND_BLOCK == 0 and m // BAND_BLOCK >= 2:
            _add(out, "bf16x6", 2 * band_entries(m) * n)
        else:
            _add(out, "fp32", 2 * tri(m) * n)
        _add(out, "fp32", tri(m) * n)          # Φ(M)·a
    contraction = _contraction_fmas(axis_m, n)
    _add(out, "fp32", contraction)             # the mean
    for m in axis_m:
        _add(out, "fp32", tri(m) * n)          # t = Lᵀa
    # backward of the moments
    _add(out, "fp32", contraction)             # ∂μ
    for i in range(len(axis_m)):
        others = [m for j, m in enumerate(axis_m) if j != i]
        _add(out, "fp32", _contraction_fmas([axis_m[i]] + others, n))   # ∂a_i
        _add(out, "fp32", 2 * tri(axis_m[i]) * n)                        # L·∂t, a·∂tᵀ
    return out


def _contraction_fmas(axis_m, n: int) -> float:
    """FMAs of μ (Π m_i) contracted against one (m_i, n) matrix an axis,
    columns aligned: the first contraction costs Π m_i a point, each later
    one the product of the axes left; the last, an elementwise product and
    a sum over the first axis, is left out."""
    total, left = 0, 1
    for m in axis_m:
        left *= m
    for m in reversed(axis_m[1:]):
        total += left * n
        left //= m
    return total


def svgp_kron_serve_fmas(axis_m, n: int) -> dict:
    """One warm ``posterior_from_state`` request of the Kronecker SVGP at n
    points: per axis the whitening F_i⁻¹Kuf_i through the dense factor and
    L_iᵀa_i (both triangular), and the mean's contraction."""
    out: dict = {}
    for m in axis_m:
        _add(out, "fp32", 2 * tri(m) * n)
    _add(out, "fp32", _contraction_fmas(axis_m, n))
    return out


def least_seconds(fmas: dict) -> float:
    """Least time (s) of products given as {precision: FMAs}: two operations
    an FMA, each precision at its peak."""
    return sum(2.0 * f / PEAKS[p] for p, f in fmas.items())
