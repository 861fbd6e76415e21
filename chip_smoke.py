"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero before the result line):

1. the card's name and power limit, and the CUDA version PyTorch was built for;
2. build the hand-written kernels (one ``nvcc`` per source of
   ``vggp_tpu_torch/csrc/``, side by side);
3. hold each kernel against its plain PyTorch version on the card, in
   float64 and float32, at the main path's shapes and at a ragged shape (the
   fused kernel at the main path's precisions and at "highest" for both;
   ``cell_kuf`` also at the serving grid's (512, 65 536), at the face
   difference's (512, 513) with every point on a cell edge, a ragged row
   length, one cell and an x that is a view at an offset),
   and the float32 and float64 results against the cell-Kuf goldens of
   ``bench.py`` (copied here; the port imports nothing of the JAX package),
   and the float32 closed-form F⁻¹ with and without its Newton–Schulz step
   against float64;
4. train the 512×512-cell Kronecker SVGP (m = 262 144 inducing cells,
   float32, num_data = 1 000 000) with Adam: 20 steps at batch 4096 through
   ``cell_kuf_with_dl`` and 8 steps at batch 16384 through
   ``fused_banded_whiten_kuf``, counting the launches of each;
5. serve ``posterior`` at 4096 held-out points under ``torch.no_grad()``
   through ``cell_kuf``, and hold the trained model's loss and posterior on
   the card (float32) against the same functions on the CPU in float64,
   the loss also at batch 16384 with gradients on, through the fused kernel;
6. the serving heads of the trained model under ``torch.no_grad()``: the warm
   ``precompute`` state, ``posterior_from_state`` beside the cold
   ``posterior`` (under no_grad the warm head on a fresh state) at the 4096
   points and on the 256×256 grid, ``q_v`` and
   ``q_dv`` (axis 0) cold and warm on the model's 512×512 cells,
   ``posterior(full_cov=True)`` at 256 points, and the heads whose output is
   dense by nature at a size that fits: ``q_u`` of a 64×64-cell model with
   parameters from a seed, ``p_v_u`` and ``q_v``/``q_dv`` with
   ``full_cov=True`` on a 32×32 grid. Each head's ``cell_kuf`` launches are
   counted exactly, and its result on the card (float32) is held against the
   same head on the CPU in float64;
7. profile three steps at each batch (device busy share, the ops with the
   most host and device time);
8. time each kernel and its plain version (device time from the profiler's
   CUDA trace, call time from CUDA events), ``cell_kuf`` also at the
   serving grid's (512, 65 536) beside one warm cold ``posterior`` and one
   ``posterior_from_state`` on that grid and at the face difference's
   (512, 513), and the fused kernel beside the unfused route it replaces,
   and print them and the steady-state step and serving times with the
   card's name and power limit.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

M_AXIS = 512
NUM_DATA = 1_000_000
TRAIN_BATCH = 4096
FUSED_BATCH = 16384
SERVE_POINTS = 4096
SERVE_GRID = 256       # posterior on a 256×256 prediction grid (phases 6 and 8b)
FULL_COV_POINTS = 256  # phase 6: posterior(full_cov=True), a (262 144, 256) Khatri–Rao block
Q_U_CELLS = 64         # phase 6: q_u's (m, m) covariance on a 64×64-cell model (4096²)
DENSE_GRID = 32        # phase 6: p_v_u, q_v and q_dv with full_cov on a 32×32 grid (1024²)
TRAIN_STEPS = 20       # first WARM_STEPS untimed
FUSED_STEPS = 8
WARM_STEPS = 3

# H100 SXM published peaks (dense, no sparsity) at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

# The precisions the main path gives the fused kernel
# (config.WHITEN_MATMUL_PRECISION, config.GRAD_MATMUL_PRECISION), and the
# tensor-core products per needed FMA the float32 kernel issues for each
# string: six bf16 ones for the fp32-accurate split, one TF32 one for
# "default" (csrc/fused_whiten_tc.cu).
MAIN_PRECISIONS = ("highest", "default")
TC_PRODUCTS = {"highest": 6, "high": 6, "default": 1}

# The cell tile math's operations per output element: what the function
# needs, as fp32 instructions of the CUDA cores, whose issue rate is half the
# fp32 FLOP rate (that rate counts an FMA as two operations). A precise exp
# or division is several instructions, not one: expf is 8 in the SASS (range
# reduction, one MUFU.EX2, scaling), an IEEE division about 9. The function
# needs no division per element (1/ℓ is one per launch) and one exp
# (e^{−near}; the far exp only inside the cell, one row in m):
#   Kuf: x − a, x − b, two products by 1/ℓ (|·| is an operand modifier),
#        min, the exp (8), two compares, e^{−near} times the row's
#        σ²ℓ·(−expm1(−δ/ℓ)): 16;
#   Kuf and ∂Kuf/∂ℓ: the same with F = e^{−near}·(−expm1(−δ/ℓ)) and σ²ℓ·F
#        (17), and G = e^{−near}·(near·(−expm1(−δ/ℓ)) − e^{−δ/ℓ}·δ/ℓ) (3),
#        F + G and σ²·: 22.
# The per-row series of cell_row is amortised over the row.
OPS_KUF = 16
OPS_KUF_DL = 22
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2

# float64 cell-Kuf goldens of bench.py:69-84 (128 cells on [0, 1],
# σ² = 1.3, ℓ = 0.27, points linspace(0.013, 0.987, 256)).
_GOLD_P = {"variance": 1.3, "lengthscale": 0.27}
_GOLD_KUF_SAMPLES = {
    (0, 0): 0.009820220820605961,
    (64, 128): 0.010064219468069275,
    (127, 255): 0.009820220820605961,
    (30, 200): 0.0013814864006452521,
}
_GOLD_KUF_SUM = 133.36001797326242
_GOLD_R_SUM = 330.72390424878466   # colsum((F⁻¹Kuf)²), rel jitter 1e-6
_GOLD_R_17 = 1.2891879138256372
GOLD_TOL_F32 = 2e-4                # bench.py's own bound
GOLD_TOL_F64 = 1e-9

# kernel vs plain version, max|Δ| / max|plain|:
#  f64: both sides are IEEE double with another order of summation (and
#       FMA contraction in the kernel): roundoff, 1e-12.
#  f32: Kuf and ∂Kuf/∂ℓ elementwise, and a = F⁻¹·Kuf, at 2e-5. t = F⁻¹·∂Kuf
#       at "highest" sums terms of both signs whose cancellation leaves the
#       result far smaller than its terms, so the float32 summation order
#       moves it more: 1e-3 (t is gradient-only signal).
#  t at "default" is one TF32 product (about 1e-2 to 4e-2 from f64 under
#       that cancellation, by the CPU emulation in tests/test_torch_ops.py):
#       its error against the f64 plain version may be at most
#       TF32_ERR_RATIO times that of torch's own TF32 product (the plain
#       version at "default").
#  colsum(a²), the quadratic form of k_ff − ‖a‖², against f64: the bench's
#       2e-4 (GOLD_TOL_F32).
TOL_F64 = 1e-12
TOL_F32 = 2e-5
TOL_F32_T = 1e-3
TF32_ERR_RATIO = 2.0

# float32 F⁻¹ at m = 512 vs float64: relative error and ‖I − F·F⁻¹‖, each
# about 40 ulp (the CPU's float32 gives ≤ 7e-7 for both).
TOL_FINV = 5e-6

# the trained model on the card (float32) vs the same functions on the CPU
# in float64. The loss sums (k_ff − ‖a‖²)/σ² over the batch, scaled by
# N/|b|: float32 roundoff of ‖a‖² ≈ k_ff is amplified by 1/σ² as the noise
# falls during training (measured 4.5e-5 to 8.8e-4 after 28 steps), hence
# 5e-3. The posterior marginals carry no such scale: 1e-3.
TOL_E2E_LOSS = 5e-3
TOL_E2E_POST = 1e-3

# The serving heads on the card (float32) vs the same head on the CPU in
# float64, max|Δ|/max|ref| over the mean and the variance (or covariance): at
# most the larger of TOL_E2E_POST and CPU_ERR_RATIO times the error of the
# same head in float32 on the CPU. Served under no_grad, every head whitens
# through a dense float32 Cholesky of Kuu, whose condition number at
# ℓ/δ ≈ 500 is held near the 1e6 of its jitter floor, so its float32 error
# is set by the factorization, on any device. Measured on an H100, card/CPU:
# 0.65–1.31 for the grid heads, 2.0–2.4 for the posteriors (whose bound is
# TOL_E2E_POST); with every product in TF32 (tools/torch_heads_control.py)
# 2.9–3.4 for q_v, p_v_u and q_v full_cov, which this ratio catches, and
# 0.9–1.7 for q_dv, which no ratio above the float32 one can.
CPU_ERR_RATIO = 2.0

_REPLACES = {
    "cell_kuf": "vggp_tpu/ops/pallas_kernels.py:84",
    "cell_kuf_with_dl": "vggp_tpu/ops/pallas_kernels.py:134",
    "fused_banded_whiten_kuf": "vggp_tpu/ops/pallas_kernels.py:231",
}
# the device kernel each wrapper launches (torch.profiler names contain it)
_DEVICE_KERNELS = {
    "cell_kuf": "cell_kuf_primal_kernel",
    "cell_kuf_with_dl": "cell_kuf_with_dl_kernel",
    "fused_banded_whiten_kuf": "fused_whiten_tc_kernel",
}
_SOURCES = {
    "cell_kuf": "vggp_tpu_torch/csrc/cell_kuf.cu",
    "cell_kuf_with_dl": "vggp_tpu_torch/csrc/cell_kuf.cu",
    "fused_banded_whiten_kuf": "vggp_tpu_torch/csrc/fused_whiten_tc.cu",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _profiled(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler (CPU and CUDA);
    returns (profiler, wall ms of the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def _device_events(prof, kernel=None) -> list:
    """The CUDA kernels and copies the profiler saw; with ``kernel``, only
    those whose name contains it."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (kernel is None or kernel in e.name)]


def _kernel_ms(prof, kernel=None) -> float:
    """Total device time (ms) of :func:`_device_events`."""
    return sum(e.time_range.elapsed_us() for e in _device_events(prof, kernel)) / 1e3


def time_ms(fn, iters: int = 50, warm: int = 3, kernel=None):
    """(device ms, call ms) of one call of ``fn``: device time per call from
    torch.profiler's CUDA trace (host launch overhead excluded), of the
    device kernel named ``kernel`` alone (one launch per call, averaged over
    the launches the trace kept) or else of every kernel the call launches;
    call time is CUDA events around
    ``iters`` back-to-back calls (host overhead included where it exceeds
    the device time)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    call = e0.elapsed_time(e1) / iters
    if kernel is None:
        prof, _ = _profiled(fn, iters)
        device = _kernel_ms(prof) / iters
    else:
        # one launch per call. The trace drops device records now and then
        # (seen on the H100: 41 and 0 of 50), so a window that kept fewer
        # than half of them is taken again, up to three times.
        for _ in range(3):
            prof, _ = _profiled(fn, iters)
            n_ev = len(_device_events(prof, kernel))
            if iters // 2 <= n_ev <= iters:
                break
        check(iters // 2 <= n_ev <= iters, f"profiler saw {n_ev} launches of {kernel} in {iters} calls")
        device = _kernel_ms(prof, kernel) / n_ev
    check(device > 0, "the profiler saw no device time")
    return device, call


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(m, n, dtype, device, seed):
    import numpy as np
    import torch

    from vggp_tpu_torch.ops import kms

    rng = np.random.default_rng(seed)
    mesh = torch.linspace(0.0, 1.0, m + 1, dtype=torch.float64).to(dtype).to(device)
    x = torch.as_tensor(rng.random(n) * 1.1 - 0.05, dtype=dtype, device=device)
    v = torch.tensor(1.3, dtype=dtype, device=device)
    ell = torch.tensor(0.27, dtype=dtype, device=device)
    finv = (kms.m12_cell_inv_chol(m, 1.0 / m, v, ell, 1e-6)
            if m % kms.BAND_BLOCK == 0 else None)
    return mesh, x, v, ell, finv


def check_kernels(device) -> dict:
    """Phase 3: every kernel against its plain version, f64 and f32."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    errs = {}   # max |kernel − plain| at the main path's f32 shapes and precisions
    main_shapes = ((M_AXIS, TRAIN_BATCH), (M_AXIS, FUSED_BATCH), (M_AXIS, M_AXIS + 1))

    def compare(kernel, name, got, want, tol, tag, shape, record=True, precs=()):
        e = rel_err(got, want)
        label = " ".join((tag, "/".join(precs))).strip()
        print(f"check {kernel} {name} {label} {shape}: rel {e:.3e}")
        check(e < tol, f"{kernel} {name} {label} {shape} rel {e}")
        if record and tag == "f32" and shape in main_shapes:
            errs[kernel] = max(errs.get(kernel, 0.0), float((got - want).abs().max()))

    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        for shape in ((M_AXIS, TRAIN_BATCH), (200, 301)):
            mesh, x, v, ell, _ = kernel_inputs(*shape, dtype, device, seed=1)
            compare("cell_kuf", "Kuf", ck.cell_kuf(mesh, x, v, ell),
                    ck.cell_kuf_plain(mesh, x, v, ell), tol, tag, shape)
            for name, g, w in zip(("Kuf", "dKuf"), ck.cell_kuf_with_dl(mesh, x, v, ell),
                                  ck.cell_kuf_with_dl_plain(mesh, x, v, ell)):
                compare("cell_kuf_with_dl", name, g, w, tol, tag, shape)
        # cell_kuf alone: the serving grid's shape, a ragged row length
        # (n % 4 = 3), one cell, and x as a view at a 4-byte offset
        for shape, offset in (((M_AXIS, SERVE_GRID ** 2), 0), ((37, 1023), 0), ((1, 5), 0),
                              ((64, 1001), 1)):
            mesh, x, v, ell, _ = kernel_inputs(shape[0], shape[1] + offset, dtype, device,
                                               seed=6)
            x = x[offset:]
            compare("cell_kuf", "Kuf", ck.cell_kuf(mesh, x, v, ell),
                    ck.cell_kuf_plain(mesh, x, v, ell), tol, tag,
                    shape + (("x at +1",) if offset else ()))
        # q_dv's face difference: every point on a cell edge, n % 4 = 1
        mesh, _, v, ell, _ = kernel_inputs(M_AXIS, 1, dtype, device, seed=8)
        compare("cell_kuf", "Kuf at the edges", ck.cell_kuf(mesh, mesh, v, ell),
                ck.cell_kuf_plain(mesh, mesh, v, ell), tol, tag, (M_AXIS, M_AXIS + 1))
        for shape in ((M_AXIS, FUSED_BATCH), (256, 301)):
            mesh, x, v, ell, finv = kernel_inputs(*shape, dtype, device, seed=2)
            for precs in (MAIN_PRECISIONS, ("highest", "highest")):
                (a, t), (a_p, t_p) = (ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, *precs),
                                      ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell,
                                                                       *precs))
                main = precs == MAIN_PRECISIONS
                compare("fused_banded_whiten_kuf", "a", a, a_p, tol, tag, shape, main, precs)
                if tag == "f64" or precs[1] != "default":
                    compare("fused_banded_whiten_kuf", "t", t, t_p,
                            TOL_F64 if tag == "f64" else TOL_F32_T, tag, shape, main, precs)
                else:
                    check_fused_f32_main(finv, mesh, x, v, ell, a, t, t_p, shape)
                    if shape in main_shapes:
                        errs["fused_banded_whiten_kuf"] = max(
                            errs["fused_banded_whiten_kuf"], float((t - t_p).abs().max()))
    torch.cuda.synchronize()
    return errs


def check_fused_f32_main(finv, mesh, x, v, ell, a, t, t_tf32, shape) -> None:
    """The float32 fused kernel at the main path's precisions against the
    float64 plain version of the same inputs: colsum(a²) within the bench's
    2e-4, and the one-pass TF32 ``t`` within TF32_ERR_RATIO of torch's own
    TF32 product (``t_tf32``, the plain version at "default")."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    a64, t64 = ck.fused_banded_whiten_kuf_plain(
        *(z.double() for z in (finv, mesh, x, v, ell)), "highest", "highest")
    colsum = lambda z: torch.sum(z.double() ** 2, dim=0)
    e_q = rel_err(colsum(a), colsum(a64))
    e_t, e_torch = rel_err(t.double(), t64), rel_err(t_tf32.double(), t64)
    print(f"check fused_banded_whiten_kuf f32 {shape} vs f64: colsum(a^2) rel {e_q:.3e}; "
          f"t rel {e_t:.3e} (torch TF32 {e_torch:.3e}, ratio {e_t / e_torch:.3f})")
    check(e_q < GOLD_TOL_F32, f"fused colsum(a^2) {shape} rel {e_q}")
    check(e_t <= TF32_ERR_RATIO * e_torch, f"fused t {shape}: {e_t} vs torch TF32 {e_torch}")


def check_goldens(device) -> None:
    """Phase 3b: the bench goldens through the port's feature API."""
    import numpy as np
    import torch

    from vggp_tpu_torch.config import matmul_precision
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.ops import cell_kuf as ck

    g = CellIntegralFeature.from_lims(128, 0.0, 1.0)
    for dtype, tol in ((torch.float32, GOLD_TOL_F32), (torch.float64, GOLD_TOL_F64)):
        p = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in _GOLD_P.items()}
        x = torch.as_tensor(np.linspace(0.013, 0.987, 256), dtype=dtype, device=device)
        before = ck.LAUNCHES["cell_kuf"]
        kuf = g.Kuf("matern12", p, x)
        check(ck.LAUNCHES["cell_kuf"] == before + 1, "golden Kuf did not launch cell_kuf")
        finv = g.inv_chol_kuu("matern12", p, 1e-6)
        with matmul_precision("highest"):
            a = finv @ kuf
        r = torch.sum(a * a, dim=0).double().cpu()
        kuf64 = kuf.double().cpu()
        errs = {
            "kuf_sample": max(abs(float(kuf64[i, j]) - v) / abs(v)
                              for (i, j), v in _GOLD_KUF_SAMPLES.items()),
            "kuf_sum": abs(float(kuf64.sum()) - _GOLD_KUF_SUM) / _GOLD_KUF_SUM,
            "r_sum": abs(float(r.sum()) - _GOLD_R_SUM) / _GOLD_R_SUM,
            "r_17": abs(float(r[17]) - _GOLD_R_17) / _GOLD_R_17,
        }
        tag = "f64" if dtype == torch.float64 else "f32"
        print(f"check goldens {tag}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        for k, v in errs.items():
            check(v < tol, f"golden {k} {tag} rel {v} >= {tol}")


def check_finv(device) -> None:
    """Phase 3c: the float32 closed-form F⁻¹ on the card, with and without
    its Newton–Schulz step, against float64 on the CPU at m = 512: relative
    error of F⁻¹, the consistency ‖I − F·F⁻¹‖ with the float64 analytic
    factor, and colsum((F⁻¹Kuf)²), the quadratic form the step protects
    (1e-3 from the raw form on the TPU, by the JAX package's measurement).
    The refined factor must meet TOL_FINV and the bench's 2e-4 on the
    quadratic form; the raw one is reported beside it."""
    import torch

    from vggp_tpu_torch.config import matmul_precision
    from vggp_tpu_torch.ops import cell_kuf as ck
    from vggp_tpu_torch.ops import kms

    m, cpu = M_AXIS, torch.device("cpu")
    for ell in (0.27, 3.0):
        args = lambda dt, dev: (m, 1.0 / m, torch.tensor(1.3, dtype=dt, device=dev),
                                torch.tensor(ell, dtype=dt, device=dev), 1e-6)
        ref = kms.m12_cell_inv_chol(*args(torch.float64, cpu))
        _, f64 = kms.m12_cell_factors(*args(torch.float64, cpu))
        raw, f32 = kms.m12_cell_factors(*args(torch.float32, device))
        refined = kms.newton_schulz_step(raw, f32)
        mesh, x, v, _, _ = kernel_inputs(m, TRAIN_BATCH, torch.float64, cpu, seed=5)
        kuf = ck.cell_kuf_plain(mesh, x, v, torch.tensor(ell, dtype=torch.float64))
        r_ref = torch.sum((ref @ kuf) ** 2, dim=0)
        kuf32 = kuf.float().to(device)
        eye = torch.eye(m, dtype=torch.float64)
        out = {}
        for tag, finv in (("refined", refined), ("raw", raw)):
            with matmul_precision("highest"):
                r = torch.sum((finv @ kuf32) ** 2, dim=0).double().cpu()
            f = finv.double().cpu()
            out[tag] = (rel_err(f, ref), float((eye - f64 @ f).abs().max()), rel_err(r, r_ref))
        print(f"check finv f32 ell {ell}: " + "; ".join(
            f"{tag} rel {e:.3e}, |I-F*Finv| {c:.3e}, colsum(a^2) rel {q:.3e}"
            for tag, (e, c, q) in out.items()))
        e, c, q = out["refined"]
        check(e < TOL_FINV and c < TOL_FINV and q < GOLD_TOL_F32,
              f"refined f32 finv at ell {ell}: rel {e}, consistency {c}, colsum {q}")
        e, c, q = out["raw"]
        print(f"check finv f32 ell {ell}: the raw form "
              f"{'meets' if max(e, c) < TOL_FINV and q < GOLD_TOL_F32 else 'misses'} "
              f"the same bounds")


def make_data(device):
    """Synthetic data from a numpy seed, as bench.py:365-371 makes its batch."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    X = rng.random((NUM_DATA, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(NUM_DATA)
    Xs = rng.random((SERVE_POINTS, 2))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return as_t(X), as_t(y), as_t(Xs)


def run_steps(step, X, y, batch, n_steps, gen):
    """n_steps training steps on uniform minibatches; returns (losses,
    steady-state ms per step over the steps after WARM_STEPS)."""
    import torch

    losses = []
    t0 = None
    for k in range(n_steps):
        if k == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        idx = torch.randint(0, X.shape[0], (batch,), generator=gen, device=X.device)
        losses.append(step(X[idx], y[idx]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n_steps - WARM_STEPS)
    return [float(v) for v in losses], ms


def drive_main_path(device, X, y, Xs):
    """Phases 4 and 5: train at 4096 and 16384, serve the posterior."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGP, SVGPSpec, svgp, train
    from vggp_tpu_torch.ops import cell_kuf as ck

    spec = SVGPSpec(kinds=("matern12", "matern12"),
                    features=tuple(CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0)
                                   for _ in range(2)),
                    num_data=NUM_DATA, variational="kron")
    model = SVGP(spec)   # device None: the card
    check(model.noise.device.type == device.type, "model not on the card")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = train.make_step_fn(lambda p, xb, yb: svgp.loss(spec, p, xb, yb),
                              model.raw_params(), opt)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    launches = {k: 0 for k in ck.LAUNCHES}
    timings = {}

    ck.reset_launch_counts()
    losses, timings["step_ms_batch4096"] = run_steps(step, X, y, TRAIN_BATCH, TRAIN_STEPS, gen)
    got = dict(ck.LAUNCHES)
    print(f"train batch {TRAIN_BATCH}: losses {losses[0]:.6g} -> {losses[-1]:.6g}, "
          f"launches {got}")
    check(all(torch.isfinite(torch.tensor(losses))), f"non-finite loss at {TRAIN_BATCH}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"loss did not fall at {TRAIN_BATCH}: {losses}")
    check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 2 * TRAIN_STEPS,
                  "fused_banded_whiten_kuf": 0}, f"launches at {TRAIN_BATCH}: {got}")
    launches = {k: launches[k] + got[k] for k in got}

    ck.reset_launch_counts()
    losses16, timings["step_ms_batch16384"] = run_steps(step, X, y, FUSED_BATCH,
                                                        FUSED_STEPS, gen)
    got = dict(ck.LAUNCHES)
    print(f"train batch {FUSED_BATCH}: losses {losses16[0]:.6g} -> {losses16[-1]:.6g}, "
          f"launches {got}")
    check(all(torch.isfinite(torch.tensor(losses16))), f"non-finite loss at {FUSED_BATCH}")
    check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 0,
                  "fused_banded_whiten_kuf": 2 * FUSED_STEPS}, f"launches at {FUSED_BATCH}: {got}")
    launches = {k: launches[k] + got[k] for k in got}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        post = model.posterior(Xs)
    torch.cuda.synchronize()
    timings["posterior_ms_4096"] = (time.perf_counter() - t0) * 1e3
    got = dict(ck.LAUNCHES)
    print(f"serve {SERVE_POINTS} points: launches {got}, mean range "
          f"[{float(post.mean.min()):.4g}, {float(post.mean.max()):.4g}], "
          f"var range [{float(post.var.min()):.4g}, {float(post.var.max()):.4g}]")
    check(post.mean.shape == (SERVE_POINTS,) and post.var.shape == (SERVE_POINTS,),
          "posterior shapes")
    check(bool(torch.isfinite(post.mean).all() and torch.isfinite(post.var).all()),
          "posterior not finite")
    check(bool((post.var > 0).all()), "posterior variance not positive")
    check(got == {"cell_kuf": 2, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0},
          f"launches at serving: {got}")
    launches = {k: launches[k] + got[k] for k in got}
    return spec, model, post, launches, timings, step, gen


def serving_grid_points(device):
    """The cell centres of the SERVE_GRID × SERVE_GRID prediction grid."""
    import torch

    g = (torch.arange(SERVE_GRID, dtype=torch.float32, device=device) + 0.5) / SERVE_GRID
    return torch.cartesian_prod(g, g)


def q_u_model(device):
    """Phase 6's Q_U_CELLS × Q_U_CELLS-cell model, its parameters from a
    numpy seed (q_u's output is an (m, m) covariance: 4096², 67 MB)."""
    import numpy as np
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp

    m = Q_U_CELLS
    spec = SVGPSpec(kinds=("matern12", "matern12"),
                    features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for _ in range(2)),
                    num_data=NUM_DATA, variational="kron")
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    q = {"mu": t(0.3 * rng.standard_normal((m, m)))}
    for i in (1, 2):
        q[f"raw_L{i}"] = svgp.raw_from_chol(t(np.eye(m) + 0.05 * np.tril(rng.standard_normal((m, m)), -1)))
    axes = ({"variance": t(1.1), "lengthscale": t(0.15)},
            {"variance": t(0.9), "lengthscale": t(0.25)})
    return spec, {"axes": axes, "noise": t(0.01), "q": q}


def head_table(device, spec, Xs):
    """Phase 6's heads: (name, model, expected cell_kuf launches, output
    length, fn(spec, params, state, cast)). ``cast`` moves a tensor to the
    parameters' device and dtype; ``state`` is their ``precompute`` state.
    The 32×32 grid lies over [0.5, 1.5]²: a quarter of it inside the model's
    cells, where v is nearly a function of u and p(v | u)'s variance falls
    below float32 resolution, the rest outside them."""
    from vggp_tpu_torch import CellIntegralFeature, svgp

    own, n_cells = spec.features, spec.num_inducing
    grid_pts = serving_grid_points(device)
    dense_grid = tuple(CellIntegralFeature.from_lims(DENSE_GRID, 0.5, 1.5) for _ in range(2))
    xs_full = Xs[:FULL_COV_POINTS]
    n_dense = DENSE_GRID ** 2
    return [
        (f"posterior_from_state {Xs.shape[0]}", "main", 2, Xs.shape[0],
         lambda s, p, st, c: svgp.posterior_from_state(s, p, st, c(Xs))),
        (f"posterior {Xs.shape[0]}", "main", 2, Xs.shape[0],
         lambda s, p, st, c: svgp.posterior(s, p, c(Xs))),
        (f"posterior_from_state {SERVE_GRID}x{SERVE_GRID}", "main", 2, grid_pts.shape[0],
         lambda s, p, st, c: svgp.posterior_from_state(s, p, st, c(grid_pts))),
        (f"posterior {SERVE_GRID}x{SERVE_GRID}", "main", 2, grid_pts.shape[0],
         lambda s, p, st, c: svgp.posterior(s, p, c(grid_pts))),
        ("q_v own cells", "main", 0, n_cells, lambda s, p, st, c: svgp.q_v(s, p, own)),
        ("q_v_from_state own cells", "main", 0, n_cells,
         lambda s, p, st, c: svgp.q_v_from_state(s, p, st, own)),
        ("q_dv axis 0 own cells", "main", 1, n_cells, lambda s, p, st, c: svgp.q_dv(s, p, own, 0)),
        ("q_dv_from_state axis 0 own cells", "main", 1, n_cells,
         lambda s, p, st, c: svgp.q_dv_from_state(s, p, st, own, 0)),
        (f"posterior full_cov {FULL_COV_POINTS}", "main", 2, FULL_COV_POINTS,
         lambda s, p, st, c: svgp.posterior(s, p, c(xs_full), full_cov=True)),
        (f"q_u {Q_U_CELLS}x{Q_U_CELLS}-cell model", "q_u", 0, Q_U_CELLS ** 2,
         lambda s, p, st, c: svgp.q_u(s, p)),
        (f"p_v_u {DENSE_GRID}x{DENSE_GRID}", "main", 0, n_dense,
         lambda s, p, st, c: svgp.p_v_u(s, p, dense_grid)),
        (f"q_v full_cov {DENSE_GRID}x{DENSE_GRID}", "main", 0, n_dense,
         lambda s, p, st, c: svgp.q_v(s, p, dense_grid, full_cov=True)),
        (f"q_dv full_cov axis 0 {DENSE_GRID}x{DENSE_GRID}", "main", 1, n_dense,
         lambda s, p, st, c: svgp.q_dv(s, p, dense_grid, 0, full_cov=True)),
    ]


def gauss_err(got, want) -> float:
    """max|Δ|/max|ref| of the mean and of the variance or covariance, the
    larger, both sides taken to float64 on the CPU."""
    cov = want.cov is not None
    pairs = ((got.mean, want.mean), (got.cov, want.cov) if cov else (got.var, want.var))
    return max(rel_err(g.double().cpu(), w.double().cpu()) for g, w in pairs)


def heads_tol(cpu_f32_err: float) -> float:
    """A serving head's bound on the card's float32 error: the larger of
    TOL_E2E_POST and CPU_ERR_RATIO × the same head's float32 error on the CPU."""
    return max(TOL_E2E_POST, CPU_ERR_RATIO * cpu_f32_err)


def head_contexts(device, spec, model):
    """(specs, ctx) of phase 6: the trained model and the q_u model by name,
    and for each with "card" (float32 on the card), "f64" and "f32" (on the
    CPU) its parameters, their ``precompute`` state and a cast of inputs to
    them."""
    import torch

    from vggp_tpu_torch import svgp, train

    cpu = torch.device("cpu")
    with torch.no_grad():
        p_dev = train.tree_map(lambda v: v.detach(), model.params())
    spec_u, p_u = q_u_model(device)
    specs = {"main": spec, "q_u": spec_u}
    ctx = {}   # (model, "card" | "f64" | "f32") → (params, state, cast)
    for which, p in (("main", p_dev), ("q_u", p_u)):
        for tag, dev, dt in (("card", device, torch.float32), ("f64", cpu, torch.float64),
                             ("f32", cpu, torch.float32)):
            pp = train.tree_map(lambda v, dev=dev, dt=dt: v.to(device=dev, dtype=dt), p)
            with torch.no_grad():
                st = svgp.precompute(specs[which], pp)
            ctx[which, tag] = (pp, st, lambda t, dev=dev, dt=dt: t.to(device=dev, dtype=dt))
    return specs, ctx


def serve_heads(device, spec, model, Xs):
    """Phase 6: the serving heads of the trained model under no_grad.

    Each head: its cell_kuf launches counted exactly (reset before, read
    after), shapes, finite means and variances, and positive variances (for
    a dense covariance: everywhere its float64 value exceeds the head's
    error bound, and nowhere below −bound), and the result against the same
    head on the CPU in float64, within :func:`heads_tol` of the CPU's own
    float32 error. Returns (launches, the (512, 513) launches, timings, the
    warm state)."""
    import torch

    from vggp_tpu_torch import svgp
    from vggp_tpu_torch.ops import cell_kuf as ck

    specs, ctx = head_contexts(device, spec, model)
    chols, Ls = ctx["main", "card"][1]
    check(all(bool(torch.isfinite(c.F).all()) for c in chols)
          and all(bool(torch.isfinite(L).all()) for L in Ls),
          "the warm state's float32 Kuu factors on the card are not finite")

    launches = {k: 0 for k in ck.LAUNCHES}
    edge_launches = 0
    for name, which, n_launch, n, fn in head_table(device, spec, Xs):
        run = lambda tag: fn(specs[which], *ctx[which, tag])
        ck.reset_launch_counts()
        with torch.no_grad():
            g = run("card")
        torch.cuda.synchronize()
        got = dict(ck.LAUNCHES)
        check(got == {"cell_kuf": n_launch, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0},
              f"{name}: launches {got}, expected {n_launch} of cell_kuf")
        launches = {k: launches[k] + got[k] for k in got}
        if name.startswith("q_dv") and "own cells" in name:
            edge_launches += got["cell_kuf"]
        with torch.no_grad():
            ref, f32 = run("f64"), run("f32")
        dense = ref.cov is not None
        check(g.mean.shape == (n,) and (g.cov.shape == (n, n) if dense else g.var.shape == (n,)),
              f"{name}: shapes {tuple(g.mean.shape)}, "
              f"{tuple((g.cov if dense else g.var).shape)}")
        v, ref_v = g.variance(), ref.variance()
        check(bool(torch.isfinite(g.mean).all() and torch.isfinite(g.cov if dense else v).all()),
              f"{name}: not finite")
        e, e32 = gauss_err(g, ref), gauss_err(f32, ref)
        tol = heads_tol(e32)
        bound = tol * float((ref.cov if dense else ref_v).abs().max())
        v = v.double().cpu()
        resolved = ref_v > bound if dense else torch.ones_like(ref_v, dtype=torch.bool)
        print(f"check head {name}: launches {got['cell_kuf']}, card f32 vs cpu f64 {e:.3e}, "
              f"cpu f32 {e32:.3e} (ratio {e / e32:.2f}), tol {tol:.3e}; var range "
              f"[{float(v.min()):.4g}, {float(v.max()):.4g}]"
              + (f", {int(resolved.sum())} of {n} resolved" if dense else ""))
        check(e <= tol, f"{name}: card f32 vs cpu f64 {e} > {tol} (cpu f32 {e32})")
        check(bool((v[resolved] > 0).all()) and float(v.min()) > -bound,
              f"{name}: variance not positive")

    # times: one call each after a warm one (host clock, ends in synchronize)
    timings = {}
    p, st, _ = ctx["main", "card"]
    own = spec.features
    for key, fn in (("precompute_ms", lambda: svgp.precompute(spec, p)),
                    ("q_v_ms_own_cells", lambda: svgp.q_v(spec, p, own)),
                    ("q_v_from_state_ms_own_cells", lambda: svgp.q_v_from_state(spec, p, st, own)),
                    ("q_dv_ms_own_cells", lambda: svgp.q_dv(spec, p, own, 0)),
                    ("q_dv_from_state_ms_own_cells",
                     lambda: svgp.q_dv_from_state(spec, p, st, own, 0))):
        timings[key] = host_ms(fn)
    print("serve heads: " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
    return launches, edge_launches, timings, st


def host_ms(fn) -> float:
    """Host ms of one warm call of ``fn`` under no_grad, ending in synchronize."""
    import torch

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


PROFILE_STEPS = 3


def profile_steps(step, X, y, batch, gen) -> dict:
    """Phase 7: where a training step's time goes. Three steps under
    torch.profiler: the device's busy share of the window (kernel time over
    wall time) and the ops with the most host and device time."""
    import torch

    def one():
        idx = torch.randint(0, X.shape[0], (batch,), generator=gen, device=X.device)
        step(X[idx], y[idx])

    prof, wall = _profiled(one, PROFILE_STEPS)
    busy = _kernel_ms(prof) / wall
    avgs = list(prof.key_averages())
    by_host = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)[:8]
    by_dev = sorted(avgs, key=lambda a: a.self_device_time_total, reverse=True)[:8]
    fmt = lambda a, t: f"{a.key[:60]} {t / 1e3 / PROFILE_STEPS:.3f} ms x{a.count // PROFILE_STEPS}"
    print(f"profile batch {batch}: {wall / PROFILE_STEPS:.3f} ms/step under the profiler, "
          f"device busy {busy:.3f} of the window")
    print("  host:   " + "; ".join(fmt(a, a.self_cpu_time_total) for a in by_host))
    print("  device: " + "; ".join(fmt(a, a.self_device_time_total) for a in by_dev))
    return {f"profiled_step_ms_batch{batch}": wall / PROFILE_STEPS,
            f"device_busy_share_batch{batch}": busy}


def check_against_cpu_f64(spec, model, post, X, y, Xs) -> None:
    """Phase 5b: the trained model on the card (f32) vs the CPU in f64."""
    import torch

    from vggp_tpu_torch import svgp, train

    with torch.no_grad():
        p_dev = model.params()
        p_cpu = train.tree_map(lambda v: v.detach().double().cpu(), p_dev)
        xb, yb = X[:TRAIN_BATCH], y[:TRAIN_BATCH]
        l_dev = float(svgp.loss(spec, p_dev, xb, yb))
        l_cpu = float(svgp.loss(spec, p_cpu, xb.double().cpu(), yb.double().cpu()))
        n = 256
        ref = svgp.posterior(spec, p_cpu, Xs[:n].double().cpu())
    e_loss = abs(l_dev - l_cpu) / abs(l_cpu)
    e_mean = rel_err(post.mean[:n].double().cpu(), ref.mean)
    e_var = rel_err(post.var[:n].double().cpu(), ref.var)
    print(f"check card f32 vs cpu f64: loss {e_loss:.3e}, posterior mean {e_mean:.3e}, "
          f"var {e_var:.3e}")
    check(e_loss < TOL_E2E_LOSS and e_mean < TOL_E2E_POST and e_var < TOL_E2E_POST,
          f"card vs cpu f64: loss {e_loss}, mean {e_mean}, var {e_var}")


def check_fused_against_cpu_f64(spec, model, X, y) -> None:
    """Phase 5c: the loss at batch 16384 with gradients on, which takes the
    fused kernel (2 launches, one per axis), on the card (f32) vs the CPU in
    float64 (TOL_E2E_LOSS)."""
    import torch

    from vggp_tpu_torch import svgp, train
    from vggp_tpu_torch.ops import cell_kuf as ck

    xb, yb = X[:FUSED_BATCH], y[:FUSED_BATCH]
    ck.reset_launch_counts()
    l_dev = float(svgp.loss(spec, model.params(), xb, yb).detach())
    got = dict(ck.LAUNCHES)
    check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 2},
          f"launches of the loss at {FUSED_BATCH} with gradients on: {got}")
    with torch.no_grad():
        p_cpu = train.tree_map(lambda v: v.detach().double().cpu(), model.params())
        l_cpu = float(svgp.loss(spec, p_cpu, xb.double().cpu(), yb.double().cpu()))
    e_loss = abs(l_dev - l_cpu) / abs(l_cpu)
    print(f"check card f32 vs cpu f64 at batch {FUSED_BATCH} through the fused kernel: "
          f"loss {e_loss:.3e}, launches {got}")
    check(e_loss < TOL_E2E_LOSS, f"fused loss vs cpu f64: {e_loss}")


def fused_bounds(m: int, n: int, precisions) -> dict:
    """The card's least time (ms) for fused_banded_whiten_kuf at (m, n):
    the bytes (F⁻¹'s needed band entries, mesh, x, scalars, the two outputs)
    over HBM, and the operations: the needed band FMAs at the tensor-core
    products each precision takes (TC_PRODUCTS, bf16 or TF32 rate), the
    Kuf/∂Kuf generation on the CUDA cores. Beside it, the reckoning with
    every product in fp32 FMA on the CUDA cores, as an fp32-FMA kernel would
    do them."""
    from vggp_tpu_torch.ops.kms import BAND_BLOCK

    nb, f4 = m // BAND_BLOCK, 4
    # the band entries the function needs: the lower triangles of the nb
    # diagonal blocks and the nb − 1 full sub-diagonal blocks of F⁻¹
    band = nb * BAND_BLOCK * (BAND_BLOCK + 1) // 2 + (nb - 1) * BAND_BLOCK ** 2
    t_bytes = (band + m + 1 + n + 2 + 2 * m * n) * f4 / HBM_BYTES_PER_S * 1e3
    tensor = sum(2 * TC_PRODUCTS[p] * band * n
                 / (BF16_FLOPS_PER_S if TC_PRODUCTS[p] > 1 else TF32_FLOPS_PER_S)
                 for p in precisions) * 1e3
    t_gen = m * n * OPS_KUF_DL / FP32_INSTR_PER_S * 1e3
    t_fma = 2 * 2 * band * n / FP32_FLOPS_PER_S * 1e3 + t_gen
    t_ops = max(tensor, t_gen)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_fma_ms": max(t_bytes, t_fma)}


def kuf_bounds(m: int, n: int, with_dl: bool) -> dict:
    """The card's least time (ms) for cell_kuf (or cell_kuf_with_dl) at
    (m, n) in float32: the bytes (mesh, x, scalars, the outputs) over HBM, or
    the needed instructions (OPS_KUF, OPS_KUF_DL) over the fp32 issue rate,
    whichever is larger."""
    f4, outs = 4, 2 if with_dl else 1
    t_bytes = ((m + 1 + n + 2) + outs * m * n) * f4 / HBM_BYTES_PER_S * 1e3
    t_ops = m * n * (OPS_KUF_DL if with_dl else OPS_KUF) / FP32_INSTR_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_kuf_shape(device, m, n, x_is_mesh=False) -> dict:
    """cell_kuf at (m, n) in f32, kernel in turns with its plain version:
    device ms from the profiler's trace, and the bound. ``x_is_mesh``: the
    points are the cell edges themselves (n = m + 1), as in q_dv's face
    difference."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    mesh, x, v, ell, _ = kernel_inputs(m, n, torch.float32, device, seed=7)
    if x_is_mesh:
        x = mesh.clone()
    kern = lambda: ck.cell_kuf(mesh, x, v, ell)
    plain = lambda: ck.cell_kuf_plain(mesh, x, v, ell)
    p1, _ = time_ms(plain, iters=10)
    k1, _ = time_ms(kern, iters=20, kernel=_DEVICE_KERNELS["cell_kuf"])
    k2, _ = time_ms(kern, iters=20, kernel=_DEVICE_KERNELS["cell_kuf"])
    p2, _ = time_ms(plain, iters=10)
    out = {"shape": [m, n], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           **kuf_bounds(m, n, False)}
    print(f"time cell_kuf at ({m}, {n}){' x = mesh' if x_is_mesh else ''}: device ms kernel "
          f"{k1:.5f}/{k2:.5f}, plain {p1:.5f}/{p2:.5f}; bound {out['bound_ms']:.5f} ms "
          f"({out['bound_by']})")
    return out


def time_serving_grid(device, spec, model, state) -> dict:
    """Phase 8b: cell_kuf at the serving grid's (512, 65 536), and the cold
    ``posterior`` (``precompute`` and the warm head) and the warm
    ``posterior_from_state`` on the 256×256 grid in turns (cold, warm, warm,
    cold; one call each after a warm one, host clock around a call that ends
    in synchronize), so the kernel's time and the serving times stand side
    by side. Each call launches cell_kuf twice."""
    import torch

    from vggp_tpu_torch import svgp
    from vggp_tpu_torch.ops import cell_kuf as ck

    n = SERVE_GRID ** 2
    out = time_kuf_shape(device, M_AXIS, n)
    grid = serving_grid_points(device)
    with torch.no_grad():
        p = model.params()
    heads = {"posterior": lambda: svgp.posterior(spec, p, grid),
             "posterior_from_state": lambda: svgp.posterior_from_state(spec, p, state, grid)}
    times = {k: [] for k in heads}
    for name in ("posterior", "posterior_from_state", "posterior_from_state", "posterior"):
        ck.reset_launch_counts()
        times[name].append(host_ms(heads[name]))
        got = dict(ck.LAUNCHES)
        check(got["cell_kuf"] == 4, f"launches of two {name} calls on the grid: {got}")
    out["posterior_ms"] = sum(times["posterior"]) / 2
    out["posterior_from_state_ms"] = sum(times["posterior_from_state"]) / 2
    print(f"serve a {SERVE_GRID}x{SERVE_GRID} grid ({n} points): cold posterior "
          + "/".join(f"{t:.3f}" for t in times["posterior"]) + " ms, warm posterior_from_state "
          + "/".join(f"{t:.3f}" for t in times["posterior_from_state"]) + " ms")
    return out


def measure_kernels(device, errs, launches, serving_grid, face_edges) -> list:
    """Phase 8: kernel and plain times at the main path's f32 shapes, and the
    fused kernel beside the unfused route it replaces (cell_kuf_with_dl, then
    kms.banded_whiten_apply for a at "highest" and t at "default");
    ``serving_grid`` (phase 8b) and ``face_edges`` (phase 8c) go into
    cell_kuf's row."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck
    from vggp_tpu_torch.ops import kms

    rows = []
    mesh, x, v, ell, _ = kernel_inputs(M_AXIS, TRAIN_BATCH, torch.float32, device, seed=3)
    # (name, kernel call, plain call, bound)
    cases = [(name, lambda c=call: c(mesh, x, v, ell), lambda c=plain: c(mesh, x, v, ell),
              kuf_bounds(M_AXIS, TRAIN_BATCH, name == "cell_kuf_with_dl"))
             for name, call, plain in (
                 ("cell_kuf", ck.cell_kuf, ck.cell_kuf_plain),
                 ("cell_kuf_with_dl", ck.cell_kuf_with_dl, ck.cell_kuf_with_dl_plain))]
    nf = FUSED_BATCH
    meshf, xf, vf, ellf, finv = kernel_inputs(M_AXIS, nf, torch.float32, device, seed=4)
    q = kms.m12_geometric_ratio(1.0 / M_AXIS, ellf, 1e-6)

    def unfused():
        kuf, dkuf = ck.cell_kuf_with_dl(meshf, xf, vf, ellf)
        return (kms.banded_whiten_apply(finv, kuf, q, MAIN_PRECISIONS[0]),
                kms.banded_whiten_apply(finv, dkuf, q, MAIN_PRECISIONS[1]))

    cases.append((
        "fused_banded_whiten_kuf",
        lambda: ck.fused_banded_whiten_kuf(finv, meshf, xf, vf, ellf, *MAIN_PRECISIONS),
        lambda: ck.fused_banded_whiten_kuf_plain(finv, meshf, xf, vf, ellf, *MAIN_PRECISIONS),
        fused_bounds(M_AXIS, nf, MAIN_PRECISIONS),
    ))
    for name, kern, plain, bound in cases:
        dev_kernel = _DEVICE_KERNELS[name]
        fused = name == "fused_banded_whiten_kuf"
        # in turns: plain, kernel, (unfused, unfused,) kernel, plain
        p1, pc1 = time_ms(plain)
        k1, kc1 = time_ms(kern, kernel=dev_kernel)
        if fused:
            u1, _ = time_ms(unfused)
            u2, _ = time_ms(unfused)
        k2, kc2 = time_ms(kern, kernel=dev_kernel)
        p2, pc2 = time_ms(plain)
        row = {
            "name": name, "route": "cuda", "source": _SOURCES[name],
            "replaces": _REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            **bound, "library_ms": None,
        }
        extra = ""
        if name == "cell_kuf":
            row["at_serving_grid"] = serving_grid
            row["at_face_edges"] = face_edges
        if fused:
            row["precisions"] = list(MAIN_PRECISIONS)
            row["unfused_ms"] = (u1 + u2) / 2
            extra = (f"; unfused route {u1:.5f}/{u2:.5f}; bound {row['bound_ms']:.5f} "
                     f"(fp32-FMA reckoning {row['bound_fp32_fma_ms']:.5f})")
        rows.append(row)
        print(f"time {name}: device ms kernel {k1:.5f}/{k2:.5f}, plain {p1:.5f}/{p2:.5f}; "
              f"call ms kernel {kc1:.5f}/{kc2:.5f}, plain {pc1:.5f}/{pc2:.5f}; "
              f"bound {row['bound_ms']:.5f} ms" + extra)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda")

    from vggp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds():.2f} s) -> "
          + ", ".join(_build.library_path(src).name for src in _build.SOURCES))

    errs = check_kernels(device)
    check_goldens(device)
    check_finv(device)
    X, y, Xs = make_data(device)
    spec, model, post, launches, timings, step, gen = drive_main_path(device, X, y, Xs)
    check_against_cpu_f64(spec, model, post, X, y, Xs)
    check_fused_against_cpu_f64(spec, model, X, y)
    got, edge_launches, serve_times, state = serve_heads(device, spec, model, Xs)
    launches = {k: launches[k] + got[k] for k in got}
    timings.update(serve_times)
    for batch in (TRAIN_BATCH, FUSED_BATCH):
        timings.update(profile_steps(step, X, y, batch, gen))
    serving_grid = time_serving_grid(device, spec, model, state)
    timings["posterior_ms_grid65536"] = serving_grid["posterior_ms"]
    timings["posterior_from_state_ms_grid65536"] = serving_grid["posterior_from_state_ms"]
    face_edges = {**time_kuf_shape(device, M_AXIS, M_AXIS + 1, x_is_mesh=True),
                  "launches": edge_launches}
    rows = measure_kernels(device, errs, launches, serving_grid, face_edges)
    timings["card"] = card
    print(json.dumps({"steps": timings}))
    print(json.dumps({"kernels": rows, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
