"""Accuracy-compensated transcendental helpers (port of
``vggp_tpu/ops/stablemath.py``).

The small-|x| regime is evaluated with explicit Horner series so that the
cancellation-sensitive closed forms of the cell features (e^x − 1 − x,
sinh x − x) keep their relative accuracy in float32 on every device. The
series coefficients and the float32 term cut-offs are those of the JAX
package; ``csrc/cell_kuf.cu`` carries the same series for ``expm1s``. The
lower incomplete gammas γ(2, ·) and γ(3, ·) integrate the Markov
continuation of the Fourier features over short cells.
"""

from __future__ import annotations

import math

import torch

# Series coefficients 1/k! for k = 2..18.
_INV_FACT = [
    0.5,                       # 1/2!
    1.6666666666666666e-01,    # 1/3!
    4.1666666666666664e-02,    # 1/4!
    8.3333333333333332e-03,    # 1/5!
    1.3888888888888889e-03,    # 1/6!
    1.9841269841269841e-04,    # 1/7!
    2.4801587301587302e-05,    # 1/8!
    2.7557319223985893e-06,    # 1/9!
    2.7557319223985888e-07,    # 1/10!
    2.5052108385441720e-08,    # 1/11!
    2.0876756987868100e-09,    # 1/12!
    1.6059043836821613e-10,    # 1/13!
    1.1470745597729725e-11,    # 1/14!
    7.6471637318198164e-13,    # 1/15!
    4.7794773323873853e-14,    # 1/16!
    2.8114572543455206e-15,    # 1/17!
    1.5619206968586226e-16,    # 1/18!
]

# float32 needs terms through 1/11!: the next term at |x| = 1 is below f32 eps.
_N_TERMS_F32 = 10

# Odd-series coefficients 1/(2k+1)! for k = 1..9.
_INV_ODD_FACT = [
    1.6666666666666666e-01,    # 1/3!
    8.3333333333333332e-03,    # 1/5!
    1.9841269841269841e-04,    # 1/7!
    2.7557319223985893e-06,    # 1/9!
    2.5052108385441720e-08,    # 1/11!
    1.6059043836821613e-10,    # 1/13!
    7.6471637318198164e-13,    # 1/15!
    2.8114572543455206e-15,    # 1/17!
    8.2206352466243295e-18,    # 1/19!
]

_N_ODD_TERMS_F32 = 5


def _series_expm1mx(x: torch.Tensor) -> torch.Tensor:
    """Σ_{k≥2} x^k / k!  (= e^x − 1 − x), Horner form, |x| ≲ 1."""
    coeffs = _INV_FACT[:_N_TERMS_F32] if x.dtype == torch.float32 else _INV_FACT
    acc = torch.zeros_like(x) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc * x * x


def expm1mx(x: torch.Tensor) -> torch.Tensor:
    """e^x − 1 − x, accurate for all x (series for |x| < 1)."""
    small = torch.abs(x) < 1.0
    xs = torch.where(small, x, 0.0)
    return torch.where(small, _series_expm1mx(xs), torch.exp(x) - 1.0 - x)


def expm1s(x: torch.Tensor) -> torch.Tensor:
    """e^x − 1 with series evaluation for |x| < 1."""
    small = torch.abs(x) < 1.0
    xs = torch.where(small, x, 0.0)
    return torch.where(small, _series_expm1mx(xs) + xs, torch.exp(x) - 1.0)


def sinhmx(x: torch.Tensor) -> torch.Tensor:
    """sinh(x) − x, accurate for all x (odd Horner series for |x| < 1)."""
    coeffs = (_INV_ODD_FACT[:_N_ODD_TERMS_F32]
              if x.dtype == torch.float32 else _INV_ODD_FACT)
    small = torch.abs(x) < 1.0
    xs = torch.where(small, x, 0.0)
    x2 = xs * xs
    acc = torch.zeros_like(x) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x2 + c
    series = acc * x2 * xs
    xl = torch.where(small, 1.0, x)
    return torch.where(small, series, 0.5 * (expm1mx(xl) - expm1mx(-xl)))


# Series coefficients (k−1)/k! for k = 2..19 and (k−1)(k−2)/k! for k = 3..19
# (Python's int/int division rounds each exact rational once), behind the
# lower incomplete gammas γ(2, x) and γ(3, x) below.
_G2_COEFF = [(k - 1) / math.factorial(k) for k in range(2, 20)]
_G3_COEFF = [(k - 1) * (k - 2) / math.factorial(k) for k in range(3, 20)]
# float32: the next term falls below f32 eps relative to γ(2, 1) ≈ 0.264 and
# γ(3, 1) ≈ 0.160.
_N_G_TERMS_F32 = 11


def _gamma_series(x: torch.Tensor, coeffs, lead: int, sign: float) -> torch.Tensor:
    cs = coeffs[:_N_G_TERMS_F32] if x.dtype == torch.float32 else coeffs
    t = -x
    acc = torch.zeros_like(x) + cs[-1]
    for c in reversed(cs[:-1]):
        acc = acc * t + c
    return sign * acc * t ** lead


def gamma2_lower(x: torch.Tensor) -> torch.Tensor:
    """γ(2, x) = 1 − (1 + x)e^{−x} for x ≥ 0, by its series for |x| < 1:
    ∫₀ʰ t·e^{−λt} dt = γ(2, λh)/λ², where the direct form cancels like x²/2."""
    small = torch.abs(x) < 1.0
    xs = torch.where(small, x, 0.0)
    xl = torch.where(small, 1.0, x)
    return torch.where(small, _gamma_series(xs, _G2_COEFF, 2, 1.0),
                       1.0 - (1.0 + xl) * torch.exp(-xl))


def gamma3_lower(x: torch.Tensor) -> torch.Tensor:
    """γ(3, x) = 2 − (2 + 2x + x²)e^{−x} for x ≥ 0, by its series for
    |x| < 1: ∫₀ʰ t²·e^{−λt} dt = γ(3, λh)/λ³ (the direct form cancels like
    x³/3)."""
    small = torch.abs(x) < 1.0
    xs = torch.where(small, x, 0.0)
    xl = torch.where(small, 1.0, x)
    return torch.where(small, _gamma_series(xs, _G3_COEFF, 3, -1.0),
                       2.0 - (2.0 + (2.0 + xl) * xl) * torch.exp(-xl))
