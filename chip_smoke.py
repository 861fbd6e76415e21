"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero before the result line):

1. the card's name and power limit, and the CUDA version PyTorch was built for;
2. build the hand-written kernels (one ``nvcc`` per source of
   ``vggp_tpu_torch/csrc/``, side by side);
3. hold each kernel against its plain PyTorch version on the card, in
   float64 and float32, at the main path's shapes and at a ragged shape (the
   fused kernel at the main path's precisions ("highest", "high") and with
   a one-pass TF32 ``t`` ("highest", "default");
   both cell kernels also at the serving grid's (512, 65 536), at the face
   differences' (512, 513) and (64, 65) with every point on a cell edge, a
   ragged row length, one cell, an x that is a view at an offset (the
   scalar instances) and spacetime's (32, 1024), and at the collapsed and
   exact models' 64-cell shapes (64, 65 536), (64, 4096) and a ragged
   (64, 65 531)),
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
7. the collapsed GriddedGP (``sgpr``, 64×64 cells, m = 4096) on the first
   65 536 points: ``non_informative_init``, 10 full-batch Adam steps of
   ``train.fit`` (``cell_kuf_with_dl`` twice a step, ``fused_banded_whiten_kuf``
   never: 64-cell axes fail its gate), the steady-state step, and every head
   cold on the trained model with its ``cell_kuf`` launches counted exactly
   and its host time; the ELBO, every gradient leaf and every head on the
   card in float32 against the card in float64 at the full n, and against
   the CPU in float64 at a cut n (8192), each within the larger of a stated
   floor and CPU_ERR_RATIO times the CPU's own float32 error; the heads
   compared at the full n are the timed cold calls' own outputs;
8. the exact GP at n = 4096: 10 ``train.fit`` steps, then ``mll`` and its
   gradients, ``posterior`` at the 4096 points and ``q_v``/``q_dv`` on a
   64×64 grid (``cell_kuf`` at (64, 4096), counted), against the CPU in
   float64 by the same rule;
9. the 512×512 Kronecker SVGP under the bernoulli, poisson and Student-t
   likelihoods: 5 steps each at batch 4096 (``cell_kuf_with_dl`` twice a
   step), the loss and every gradient leaf and ``predict_y`` at the 4096
   points against the CPU in float64 by the same rule;
10. the slice of the other cell kinds, the non-uniform mesh and the
   pointwise-gradient heads, on phase 1's data: (a) the Matérn-3/2, 5/2 and
   RBF Toeplitz rows against the ``bench.py`` goldens (in phase 3b); (b) the
   512×512-cell SVGP with Matérn-3/2 cells, 8 steps at batch 4096, its loss,
   gradient leaves, ``posterior_grad`` on both axes cold and warm and
   ``q_dv`` against the CPU's float64, no kernel launched; (c) the same SVGP
   with Matérn-1/2 cells on a mesh refined toward the middle of each axis:
   both cell kernels against their plain versions on that mesh, steps at
   4096 and 16 384 (``cell_kuf_with_dl`` twice a step, the fused kernel
   never), the posterior (``cell_kuf`` twice), against the CPU's float64;
   (d) the collapsed GriddedGP with Matérn-3/2 cells (64×64, 65 536 points),
   its ELBO, gradients, ``posterior_grad`` and ``q_dv`` on both axes against
   the card's float64 and the CPU's at 8192 points; (e) the exact GP with
   Matérn-3/2 at n = 4096, ``posterior_grad`` on both axes, marginal and
   ``full_cov``, against the CPU's float64; the RBF fits of
   ``bench.py:228-260``; and the float32 λ_min readings of the jittered
   Matérn-3/2, 5/2 and RBF cell Grams (phase 6 also reads the warm
   posterior's error with the Kuu Cholesky taken on the other device);
11. the full variational family, the learned mean and the other inducing
   features: both cell kernels against their plain versions at (64, 4096),
   (512, 4096) on 1-D data and (15, 20 000), the fused kernel at
   (512, 16 384) on one axis; (a) the 2-D full-family SVGP on 64×64
   Matérn-1/2 cells (m = 4096) with a learned mean, 8 steps at batch 4096
   (``cell_kuf_with_dl`` twice a step), the posterior cold and warm, q_v,
   q_dv, p_v_u, q_u and one ``elbo_muS`` value-and-grad, against the CPU's
   float64 at 512 points; (b) the 1-D full-family SVGP on 512 cells with a
   learned mean, 8 steps at 4096 and 4 at 16 384 (the fused kernel where
   the band-ratio gate admits ℓ, its reading printed), the posterior;
   (c) the 1-D SVGP on 512 learnable Matérn-3/2 inducing points, 8 steps,
   ``posterior`` and ``posterior_grad`` cold and warm, no kernel launched;
   (d) the 2-D collapsed zoo at ``zoo.sgpr_specs_2d``'s widths on 20 000
   points (points, VFF at every Matérn order, B1, B2, B3, 15×15 cells),
   20 ``train.fit`` steps each and q_v on the 15×15 cells, the GriddedGP
   through both cell kernels; each against the CPU's float64; and the
   float32 λ_min readings of the VFF and spline Grams;
12. the multi-output ICM models, the sum, additive and free-point families
   and the clamped-eigh factor: both cell kernels against their plain
   versions at (512, 16 384), (32, 65 536), (16, 65 536), (60, 65 536) and
   (512, 65 536), the fused kernel at (512, 65 536), CellKufOp's backward at
   (512, 4096); (a) the ICM SVGP of ``api.SVGP.multioutput`` at the main
   path's width (512×512 Matérn-1/2 cells × 2 outputs, a noise level and a
   mean per output) on two-output data (output 1 = 0.7·f + 0.2 with its own
   noise), 8 steps of ``train.fit_minibatch`` at 4096 and 4 at 16 384
   (``cell_kuf`` twice a step through CellKufOp: the coregion axis sends
   every axis through the dense Kuu factor), profiled steps, the ``SVGP``
   module's posterior cold and warm, q_v on the 512²×2 cells and the learned
   B, against the CPU's float64; (b) on 65 536 points, 10 ``train.fit``
   steps then heads of the ICM collapsed GP (32×32 cells × 2 outputs),
   the multi-scale sum (16×16 and 60×60 cells, the coarse lengthscale
   frozen), the additive model (512 cells per axis, the fused kernel where
   its gate admits ℓ) and 500 free points, each against the CPU's float64;
   (c) phase 7's trained model with the clamped-eigh factor, its posterior
   and q_v against the Cholesky heads and the CPU's float64; (d) the family
   cases of ``smoke_cases`` in float32 against ``bench.py``'s float64
   goldens;
13. the matrix-free path (``models/iterative.py``, ``ops/cg.py`` and the
   prior-path layer of ``sampling.py``): ``cell_kuf`` against its plain
   version at (16 384, 256) and (512, 513); (a) the collapsed GriddedGP on
   the main path's 512×512 cells with phase 4's trained hyperparameters
   and noise on 65 536 of its points: ``solve_w`` in float32 and float64
   (iterations, preconditioner, ms, the true relative residual in
   float64), the posterior mean at the 4096 points, the q_v and q_dv
   means on the 512² cells, each held against a 4000-iteration float64
   solve (Jacobi CG stops at maxiter 1000 far from convergence there), and
   a profiled float32 solve (ms, launches and busy share an iteration
   against the bound of its two Kuf contractions); (b) the matrix-free
   means of phase 7's, 10d's and 12b's trained collapsed models against
   their dense heads at 8192 points, float64 at tol 1e-12 and float32 by
   the phases' rule against the CPU's float32 at the same n; (c)
   ``q_v_pathwise`` (S = 16 antithetic, control variate) and
   ``q_dv_pathwise`` on (a)'s model at 16 384 points in float32 and
   float64 from the same draws, and ``q_v_pathwise`` on phase 7's model at
   S = 1024 in float64 at 8192 points against its dense q_v; (d) bench.py's
   CG row and the float32 KMS-Woodbury PCG where its gates admit ℓ (its
   breakdown and the Jacobi PCG that takes over);
14. the pathwise samplers of every model family and streaming assimilation
   (``sampling.py``, ``streaming.py``): ``cell_kuf`` against its plain
   version at the phase's new shapes, (64, 16 384), (64, 576), (64, 16 960),
   (64, 8192), (32, 4096), (16, 4096) and (60, 4096); (a) ``sampling.pathwise`` at the
   4096 points and ``pathwise_q_v`` on the 512² cells of phase 4's model,
   256 draws of 2048 features, the first 8 against the CPU's float64 from
   the same draws, all by their moments against ``posterior`` and ``q_v``;
   (b) the joint (f, ∂f) draws of 10b's Matérn-3/2 SVGP and 10d's collapsed
   GP; (c) ``pathwise`` on phase 7's collapsed GP, phase 8's exact GP and
   12b's ICM, sum, additive and free-point models, ``pathwise_q_v`` on phase
   7's cells, 64 draws each, the same two holds; (d) phase 11a's model
   streams the 1 000 000 points in chunks of 16 384 (``assimilate`` and
   ``assimilate_scan``, float32 and float64), ``forget``, ``reanchor``,
   ``to_params`` → ``q_v``, and ``assimilate_natgrad`` on Poisson targets,
   against the CPU's float64 at 8192 points and the card's float64 stream;
   cell_kuf's launches counted by shape;
15. ``hyperpost.py`` and the rest of ``train.py``: both cell kernels against
   their plain versions at the phase's new shape (32, 200); (a) the Hessian
   ``hyperpost.laplace`` takes, through ``models.common.second_order()``
   (the ``cell_kuf`` kernel forward, a plain-torch backward): the 1-D case of
   ROADMAP queue 3, item 16 on the card against the CPU in float64 and
   float32, phase 7's trained model at its full width and phase 8's exact GP
   in float64 against central differences of their gradient, their float32
   Hessians against float64 by the 1-D case's bound; (b) ``fit_lbfgs`` (optax's L-BFGS and zoom line search) on
   phase 7's model, 20 iterations in float32 and float64, and the 1-D
   case's float64 trajectory against the CPU's; (c) ``fit_natgrad`` on
   11a's model, 8 minibatch steps, then one full-batch step at γ = 1 in
   float64 against the collapsed bound; (d) ``hmc_sample_params`` on phase
   7's model at 8192 points (2 chains of 24 + 24 steps) against its Laplace
   Gaussian, and the 1-D
   case's HMC against the CPU's from one CPU generator; (e)
   ``predict_marginalized`` and ``log_evidence_laplace`` on phase 7's model;
   (f) ``fit_restarts`` on phase 8's exact GP, a checkpoint round trip of
   phase 4's model and a resumed ``fit_minibatch``, a ``profile_trace`` of
   training steps that names the ``cell_kuf_with_dl`` kernel; the launches
   read by shape, every shape held against plain. It runs after 17's
   rows are assembled;
16. profile three steps at each batch (device busy share, the ops with the
   most host and device time), at the very end: late in a long process,
   after these two windows, every later window kept only 8 of 20 launches
   (H100 runs);
17. time each kernel and its plain version right after phase 3 (early in
   the process, where the profiler's trace keeps every launch; the rows
   are assembled after phase 14) (device time from the profiler's
   CUDA trace, call time from CUDA events), ``cell_kuf`` also at the
   serving grid's (512, 65 536) beside one warm cold ``posterior`` and one
   ``posterior_from_state`` on that grid and at the face difference's
   (512, 513), both cell kernels at the collapsed model's (64, 65 536) and
   on the stretched mesh, ``cell_kuf`` at (64, 4096), (64, 65) and the CG
   case's (16 384, 256), ``cell_kuf_with_dl`` at phase 15's (64, 8192)
   and at every phase 20 shape (``P20_TIMED_SHAPES`` and
   ``P20_DL_TIMED_SHAPES``),
   and the fused kernel beside the unfused route it replaces, and print
   them and the steady-state step and serving times with the card's name
   and power limit;
18. the object facade (``vggp_tpu_torch.api``), after phase 15, with no
   profiler window: every call with no device named, held against the
   functional calls it stands for at 1e-6 relative (the facade does no
   arithmetic) with the same kernels launched, the host ms of each side
   printed: (a) ``SVGP.gridded`` at the main path's 512² cells, ``fit`` 8
   steps at 4096 and 4 at 16 384, ``precompute``, the warm ``predict``,
   ``q_v`` and ``q_dv``, ``q_v`` cold, ``save``/``restore`` and
   ``sample_q_v`` bitwise; (b) ``SVGP.multioutput`` (12a's model) ``fit`` 4
   steps and ``sample_q_v``: the zero-mean draws plus ``grid_mean``; (c)
   ``GP.gridded`` (phase 7's model) ``fit`` 6 steps, ``q_v``, ``q_dv``,
   ``solve_iterative``, ``q_v_mean_iterative``; (d) 11a's model streamed
   through ``Streaming`` (4 chunks of 16 384) and ``to_svgp().q_v()``; its
   launches read by shape, each at a shape held against plain before.
19. the sharded main path (``vggp_tpu_torch.parallel``), after phase 18, on
   a world-1 NCCL group started from a FileStore: each sharded call held
   against the unsharded port call it stands for at 1e-6 relative (every
   collective of a world of one is an identity), the same kernels launched
   at shapes held before, both sides' host ms printed: (a) 4 steps at 4096
   and 2 at 16 384 of ``make_sharded_svgp_step`` from phase 4's model on a
   ("data", "model") mesh, (b) ``make_sharded_qv`` on the 512² cells, (c)
   ``make_sharded_assimilate`` on 11a's model (4 chunks of 16 384), (d) the
   sharded ``solve_w`` (the same iterations) and CG mean heads on 13a's
   model at 65 536 points, (e) the sharded pathwise ``q_v`` and ``q_dv``
   on phase 7's model at S = 16 from one generator seed; within 60 s.
20. the experiment layer (``vggp_tpu_torch.experiments``), last: (a) every
   ported ``run()`` (``univariate.run`` and ``run_orders``,
   ``kronecker``, ``simtracks``, ``gulfstream`` with its CV sweeps,
   ``northsea``, ``parity``) at its default widths and 5 iterations on the
   CPU, those with a roundoff-set member (``P20_ROUNDOFF``: the learned
   Matérn-1/2 inducing points at lr 0.05 and 0.1) at 1 iteration too, the kernel
   wrappers' calls recorded by (name, m, n); every recorded shape held on
   the card against the plain version (float64 and float32) before (b)
   and (c) launch it; its most-called shapes, ``P20_TIMED_SHAPES``, held
   and timed in phase 17, before phase 15 (which 20a checks); (b)
   each ``run()`` on the card at 20 iterations (parity at 10), each model's
   steps a second and final loss printed beside the card line; (c) each
   again at 5 iterations against (a)'s CPU run: final losses within 5e-3,
   q(v) means, variances, posteriors and metric rows within 1e-3 of their
   largest magnitude, parity's oracle column bitwise; the roundoff-set
   members so at 1 iteration; launches counted by shape; (a) + (b) + (c)
   within 150 s. No file is written.
21. the last eight experiments (``spacetime``, ``poisson``, ``exceedance``,
   ``streaming``, ``velocity``, ``evidence``, ``multioutput``,
   ``multiscale``), after phase 20: (a) each ``run()`` at its default widths
   and 5 iterations on the CPU, the kernel wrappers' calls recorded by
   (name, m, n) (spacetime's three-axis Matérn-1/2 SVGP alone calls one:
   ``cell_kuf_with_dl`` once an axis a step at (32, 1024)), every recorded
   shape held on the card against the plain version before (b) and (c)
   launch it; its most-called shapes, ``P21_TIMED_SHAPES``, held and timed
   in phase 17; (b) each on the card at 20 iterations, steps a second and
   final loss printed beside the card line; (c) each again at 5 iterations
   against (a)'s CPU run: final losses and log
   evidences within 5e-3, heads, metric rows and the sampled functionals
   (CPU generators, so the same draws) within 1e-3 of their largest
   magnitude (the stream's drift-segment NLPDs within P21_DRIFT_NLPD_FLOOR),
   errors against a truth within 1e-3 of the truth's scale, fractions of
   points within two points; launches counted by shape; (a) + (b) + (c)
   within 150 s.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
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

# phase 7: the collapsed GriddedGP, 64×64 cells (m = 4096, the JAX package's
# dense-feasible oracle size, tools/cg_scale_study.py) on the first SGPR_N
# points; the CPU float64 reference at SGPR_CUT_N points
SGPR_CELLS = 64
SGPR_N = 65_536
SGPR_CUT_N = 8192
SGPR_STEPS = 10
FIT_LR = 0.05
EXACT_N = 4096         # phase 8 (vggp_tpu/experiments/gulfstream.py runs up to 5000)
EXACT_STEPS = 10
LIK_STEPS = 5          # phase 9, per likelihood
# at 1e-2 the poisson loss rose from 2e6 to 1e15 in 5 steps, on an H100 and
# on the CPU in float32 alike (where no product is TF32)
LIK_LR = 3e-3
LIKELIHOODS = (("bernoulli", ()), ("poisson", ()), ("student_t", (("df", 4.0),)))

# H100 SXM published peaks (dense, no sparsity) at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

# The precisions the main path gives the fused kernel
# (config.WHITEN_MATMUL_PRECISION for a, config.MATMUL_PRECISION for the
# ℓ-tangent's t), and the tensor-core products per needed FMA the float32
# kernel issues for each string: six bf16 ones for the fp32-accurate split,
# one TF32 one for "default" (csrc/fused_whiten_tc.cu).
MAIN_PRECISIONS = ("highest", "high")
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
# the first entries of the 128-cell feature's Toeplitz Kuu rows (bench.py:71-73)
_GOLD_M32_ROW3 = [7.93294240e-05, 7.92343147e-05, 7.89592508e-05]
_GOLD_M52_ROW3 = [7.93364803e-05, 7.92812306e-05, 7.91161120e-05]
_GOLD_RBF_ROW4 = [7.93401676e-05, 7.93069656e-05, 7.92074430e-05, 7.90418494e-05]
GOLD_ROWS = {"matern32": _GOLD_M32_ROW3, "matern52": _GOLD_M52_ROW3, "rbf": _GOLD_RBF_ROW4}
GOLD_TOL_F32 = 2e-4                # bench.py's own bound
GOLD_TOL_F64 = 1e-9

# kernel vs plain version, max|Δ| / max|plain|:
#  f64: both sides are IEEE double with another order of summation (and
#       FMA contraction in the kernel): roundoff, 1e-12.
#  f32: Kuf and ∂Kuf/∂ℓ elementwise, and a = F⁻¹·Kuf, at 2e-5. t = F⁻¹·∂Kuf
#       at "highest" sums terms of both signs whose cancellation leaves the
#       result far smaller than its terms, so the float32 summation order
#       moves it more: 1e-3 (t is gradient-only signal).
#  t at "default" (off the main path since its ℓ-tangent went to fp32; the
#       kernel keeps the JAX kernel's contract) is one TF32 product (about
#       1e-2 to 4e-2 from f64 under
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

# Phases 7–9 hold the card's float32 against a float64 reference by the same
# rule, with these floors: losses TOL_E2E_LOSS and heads TOL_E2E_POST as
# above; gradient leaves TOL_GRAD of their comparison, about 5× the largest
# leaf error of a sound run on an H100 (6.2e-4, 2.9e-5, 4.7e-6 and 4.3e-4).
# tools/torch_grad_control.py shows what each catches (PERF.md §6): a TF32
# ℓ-tangent fails every collapsed and likelihood comparison (dℓ 3.5e-3 to
# 0.44), every model product in TF32 the collapsed σ² leaves and the
# poisson SVGP's dμ (2.7e-3); no control moves the exact GP's leaves. At the
# full n of the collapsed GP the CPU takes no float32 gradient (three
# (4096, 65 536) products), so there the floor alone holds the leaves.
TOL_GRAD = {"collapsed full n": 3e-3, "collapsed cut n": 1.5e-4, "exact": 2.5e-5,
            "likelihood": 2e-3}

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
    """max|got − want| / max|want|; the absolute error where want is all zero."""
    den = want.abs().max()
    return float((got - want).abs().max() / (den if den > 0 else 1.0))


PROFILE_LEAD_S = 0.05


def _profiled(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler (CPU and CUDA);
    returns (profiler, wall ms of the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # Late in a long run the trace lost the device records of the first
        # few ms of a window (on an H100: 7 of 10 and 7 of 50 launches, with
        # or without a synchronize between calls, in every window), so the
        # calls start PROFILE_LEAD_S after the window opens (then it lost
        # records only now and then); the wall clock starts with them.
        time.sleep(PROFILE_LEAD_S)
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
    device kernel named ``kernel`` alone (one launch per call, the median of
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
        # (seen on the H100: 41 and 0 of 50, and 4 of 10 three windows in a
        # row), so a window that kept fewer than half of them is taken
        # again, up to five times.
        for _ in range(5):
            prof, _ = _profiled(fn, iters)
            n_ev = len(_device_events(prof, kernel))
            if iters // 2 <= n_ev <= iters:
                break
            print(f"time_ms: the trace kept {n_ev} of {iters} launches of {kernel} "
                  f"({len(_device_events(prof))} device records in all); taken again")
        check(iters // 2 <= n_ev <= iters, f"profiler saw {n_ev} launches of {kernel} in {iters} calls")
        # the median launch: a record the trace cut short (seen: 0.052 ms
        # against a 0.080 ms bound beside 0.110 in the next window) does not
        # move it
        device = statistics.median(e.time_range.elapsed_us()
                                   for e in _device_events(prof, kernel)) / 1e3
    check(device > 0, "the profiler saw no device time")
    return device, call


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(m, n, dtype, device, seed, mesh=None):
    """(mesh, x, σ², ℓ, F⁻¹ or None) in ``dtype`` on ``device``: the uniform
    mesh of m cells on [0, 1], or the numpy edges ``mesh``; n points from a
    seed over [−0.05, 1.05]; the closed-form F⁻¹ of the uniform mesh where m
    blocks into bands."""
    import numpy as np
    import torch

    from vggp_tpu_torch.ops import kms

    rng = np.random.default_rng(seed)
    mesh = torch.as_tensor(np.linspace(0.0, 1.0, m + 1) if mesh is None else mesh,
                           dtype=torch.float64).to(dtype).to(device)
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
    main_shapes = ((M_AXIS, TRAIN_BATCH), (M_AXIS, FUSED_BATCH), (M_AXIS, M_AXIS + 1),
                   (SGPR_CELLS, SGPR_N), (SGPR_CELLS, EXACT_N), (SGPR_CELLS, SGPR_CELLS + 1))

    def compare(kernel, name, got, want, tol, tag, shape, record=True, precs=()):
        e = rel_err(got, want)
        label = " ".join((tag, "/".join(precs))).strip()
        print(f"check {kernel} {name} {label} {shape}: rel {e:.3e}")
        check(e < tol, f"{kernel} {name} {label} {shape} rel {e}")
        if record and tag == "f32" and shape in main_shapes:
            errs[kernel] = max(errs.get(kernel, 0.0), float((got - want).abs().max()))

    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        # the SVGP's training shape, a ragged one, and the 64-cell axes of the
        # collapsed step (n = 65 536), the exact GP's q_v (n = 4096) and a
        # ragged row length (n % 4 = 3)
        for shape in ((M_AXIS, TRAIN_BATCH), (200, 301), (SGPR_CELLS, SGPR_N),
                      (SGPR_CELLS, EXACT_N), (SGPR_CELLS, SGPR_N - 5)):
            mesh, x, v, ell, _ = kernel_inputs(*shape, dtype, device, seed=1)
            compare("cell_kuf", "Kuf", ck.cell_kuf(mesh, x, v, ell),
                    ck.cell_kuf_plain(mesh, x, v, ell), tol, tag, shape)
            for name, g, w in zip(("Kuf", "dKuf"), ck.cell_kuf_with_dl(mesh, x, v, ell),
                                  ck.cell_kuf_with_dl_plain(mesh, x, v, ell)):
                compare("cell_kuf_with_dl", name, g, w, tol, tag, shape)
        # the edges of both kernels' traversal: the serving grid's shape, a
        # ragged row length (n % 4 = 3), one cell, x as a view at a 4-byte
        # offset (the scalar instances), and spacetime's (32, 1024)
        for shape, offset in (((M_AXIS, SERVE_GRID ** 2), 0), ((37, 1023), 0), ((1, 5), 0),
                              ((64, 1001), 1), ((32, 1024), 0)):
            mesh, x, v, ell, _ = kernel_inputs(shape[0], shape[1] + offset, dtype, device,
                                               seed=6)
            x = x[offset:]
            label = shape + (("x at +1",) if offset else ())
            compare("cell_kuf", "Kuf", ck.cell_kuf(mesh, x, v, ell),
                    ck.cell_kuf_plain(mesh, x, v, ell), tol, tag, label)
            for name, g, w in zip(("Kuf", "dKuf"), ck.cell_kuf_with_dl(mesh, x, v, ell),
                                  ck.cell_kuf_with_dl_plain(mesh, x, v, ell)):
                compare("cell_kuf_with_dl", name, g, w, tol, tag, label)
        # q_dv's face difference: every point on a cell edge, n % 4 = 1 (not
        # a shape of cell_kuf_with_dl on the main path: its error is not
        # recorded for the kernel's row)
        for m in (M_AXIS, SGPR_CELLS):
            mesh, _, v, ell, _ = kernel_inputs(m, 1, dtype, device, seed=8)
            compare("cell_kuf", "Kuf at the edges", ck.cell_kuf(mesh, mesh, v, ell),
                    ck.cell_kuf_plain(mesh, mesh, v, ell), tol, tag, (m, m + 1))
            for name, g, w in zip(("Kuf", "dKuf"), ck.cell_kuf_with_dl(mesh, mesh, v, ell),
                                  ck.cell_kuf_with_dl_plain(mesh, mesh, v, ell)):
                compare("cell_kuf_with_dl", f"{name} at the edges", g, w, tol, tag, (m, m + 1),
                        record=False)
        for shape in ((M_AXIS, FUSED_BATCH), (256, 301)):
            mesh, x, v, ell, finv = kernel_inputs(*shape, dtype, device, seed=2)
            for precs in (MAIN_PRECISIONS, ("highest", "default")):
                (a, t), (a_p, t_p) = (ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, *precs),
                                      ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell,
                                                                       *precs))
                main = precs == MAIN_PRECISIONS
                compare("fused_banded_whiten_kuf", "a", a, a_p, tol, tag, shape, main, precs)
                if tag == "f64" or precs[1] != "default":
                    compare("fused_banded_whiten_kuf", "t", t, t_p,
                            TOL_F64 if tag == "f64" else TOL_F32_T, tag, shape, main, precs)
                else:
                    check_fused_tf32_t(finv, mesh, x, v, ell, a, t, t_p, shape)
    torch.cuda.synchronize()
    return errs


def check_fused_tf32_t(finv, mesh, x, v, ell, a, t, t_tf32, shape) -> None:
    """The float32 fused kernel at ("highest", "default") against the float64
    plain version of the same inputs: colsum(a²) within the bench's 2e-4,
    and the one-pass TF32 ``t`` within TF32_ERR_RATIO of torch's own TF32
    product (``t_tf32``, the plain version at "default")."""
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
    """Phase 3b (and 10a): the bench goldens through the port's feature API,
    the Matérn-3/2, 5/2 and RBF Toeplitz rows among them."""
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
        for kind, gold in GOLD_ROWS.items():
            row = g.kuu_first_row(kind, p)[:len(gold)].double().cpu()
            gold = torch.tensor(gold, dtype=torch.float64)
            errs[f"{kind}_row"] = float((row - gold).abs().max() / gold.abs().max())
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


# Phase 3d: the closed-form F⁻¹ kernel (csrc/m12_finv.cu) against its plain
# version on the card at these m (every per-axis cell count the phases build
# a closed-form F⁻¹ at, and m = 1, 2), on both branches of u = δ/ℓ (ℓ/δ in
# FINV_ELL_OVER_DELTA). Tolerances, max|Δ|/max|plain| per output: float64
# 1e-12 (roundoff); float32 1e-6 for the raw F⁻¹ and F, whose entries q^k
# and r^k the plain version takes by cumprod (a rounding a factor) and the
# kernel by squaring, and for the refined F⁻¹ (the Newton–Schulz step
# cancels the raw factor's error to first order; its products round alike
# on both sides): on an H100 the largest gap was 1.8e-9 raw and 6.0e-8
# refined. q bit for bit: one thread repeats the plain version's scalar
# operations with no contraction.
FINV_HELD_M = (1, 2, 9, 10, 12, 15, 16, 20, 32, 60, 64, 128, 256, 512)
FINV_ELL_OVER_DELTA = (0.4, 3.0)
TOL_FINV_KERNEL = {"float64": 1e-12, "float32": 1e-6}
# (dtype name, m) held in phase 3d (or at the end of main, for an m that a
# phase launched first), and every m12_finv launch of the script by (dtype
# name, m): the launch counters are reset by every phase
FINV_HELD = {}
FINV_LAUNCHED = collections.Counter()


def record_finv_launches() -> None:
    """Count every launch of the ``m12_finv`` kernel of the script into
    FINV_LAUNCHED (``ops.kms.m12_finv`` and ``M12FinvOp`` look the launcher
    up at call time)."""
    from vggp_tpu_torch.ops import kms

    launch = kms._m12_finv_values

    def recording(m, delta, variance, lengthscale, rel_jitter):
        if lengthscale.device.type == "cuda":
            FINV_LAUNCHED[str(lengthscale.dtype).removeprefix("torch."), m] += 1
        return launch(m, delta, variance, lengthscale, rel_jitter)

    kms._m12_finv_values = recording


def hold_finv_kernel(device, ms, dtypes=("float64", "float32")) -> None:
    """Phase 3d: the ``m12_finv`` kernel against ``kms.m12_finv_plain`` on the
    card at each m of ``ms``: raw F⁻¹, F, q and the F⁻¹ after the
    Newton–Schulz step, at both ℓ/δ of FINV_ELL_OVER_DELTA; the zeros above
    the diagonal exact; each launch counted once at (m, m). Records the
    largest relative gap in FINV_HELD[dtype name, m]."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck
    from vggp_tpu_torch.ops import kms

    for name in dtypes:
        dtype = getattr(torch, name)
        for m in ms:
            worst = 0.0
            for ratio in FINV_ELL_OVER_DELTA:
                args = (m, 1.0 / m, torch.tensor(1.3, dtype=dtype, device=device),
                        torch.tensor(ratio / m, dtype=dtype, device=device), 1e-6)
                ck.reset_launch_counts()
                got = kms.m12_finv(*args)
                torch.cuda.synchronize()
                check(ck.LAUNCHES["m12_finv"] == 1 and dict(ck.SHAPE_LAUNCHES)
                      == {("m12_finv", m, m): 1}, f"3d m12_finv {name} m={m}: launches "
                      f"{dict(ck.SHAPE_LAUNCHES)}")
                want = kms.m12_finv_plain(*args)
                upper = torch.triu(torch.ones(m, m, dtype=torch.bool, device=device), 1)
                check(all(bool((t[upper] == 0).all()) for t in got[:2]),
                      f"3d m12_finv {name} m={m}: nonzero above the diagonal")
                check(float(got[2]) == float(want[2]), f"3d m12_finv {name} m={m} ℓ/δ={ratio}: "
                      f"q {float(got[2])!r} vs plain {float(want[2])!r}")
                gaps = [rel_err(g, w) for g, w in zip(got[:2], want[:2])]
                gaps.append(rel_err(kms.newton_schulz_step(*got[:2]),
                                    kms.newton_schulz_step(*want[:2])))
                print(f"check 3d m12_finv {name} m={m} ℓ/δ={ratio}: raw F⁻¹ {gaps[0]:.3e}, "
                      f"F {gaps[1]:.3e}, refined {gaps[2]:.3e}, q equal")
                check(max(gaps) < TOL_FINV_KERNEL[name],
                      f"3d m12_finv {name} m={m} ℓ/δ={ratio}: gaps {gaps}")
                worst = max(worst, *gaps)
            FINV_HELD[name, m] = worst


def hold_finv_launched(device) -> dict:
    """The end of :func:`main`: every (dtype, m) the script launched the
    ``m12_finv`` kernel at is held against plain (phase 3d's, or now for an
    m it did not list). Returns {"launches": …, "held late": […],
    "held_max_rel_gap": …}."""
    late = sorted({k for k in FINV_LAUNCHED} - set(FINV_HELD))
    for name, m in late:
        hold_finv_kernel(device, (m,), (name,))
    launched = {f"{name} m={m}": n for (name, m), n in sorted(FINV_LAUNCHED.items())}
    print(f"m12_finv launches of the script by dtype and m: {launched}; held against plain: "
          f"{sorted(FINV_HELD)}, of them only after a launch: {late}")
    check(set(FINV_LAUNCHED) <= set(FINV_HELD), "m12_finv launched at a shape never held")
    return {"launches": launched, "held late": [f"{name} m={m}" for name, m in late],
            "held_max_rel_gap": {f"{name} m={m}": e for (name, m), e in sorted(FINV_HELD.items())}}


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

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp, train
    from vggp_tpu_torch.models.svgp import SVGP
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
    launches = dict(NO_LAUNCHES)
    timings = {}

    ck.reset_launch_counts()
    losses, timings["step_ms_batch4096"] = run_steps(step, X, y, TRAIN_BATCH, TRAIN_STEPS, gen)
    got = cell_launches()
    print(f"train batch {TRAIN_BATCH}: losses {losses[0]:.6g} -> {losses[-1]:.6g}, "
          f"launches {got}")
    check(all(torch.isfinite(torch.tensor(losses))), f"non-finite loss at {TRAIN_BATCH}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"loss did not fall at {TRAIN_BATCH}: {losses}")
    check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 2 * TRAIN_STEPS,
                  "fused_banded_whiten_kuf": 0}, f"launches at {TRAIN_BATCH}: {got}")
    check_finv_launches(2 * TRAIN_STEPS, f"training at {TRAIN_BATCH}")
    launches = {k: launches[k] + got[k] for k in got}

    ck.reset_launch_counts()
    losses16, timings["step_ms_batch16384"] = run_steps(step, X, y, FUSED_BATCH,
                                                        FUSED_STEPS, gen)
    got = cell_launches()
    print(f"train batch {FUSED_BATCH}: losses {losses16[0]:.6g} -> {losses16[-1]:.6g}, "
          f"launches {got}")
    check(all(torch.isfinite(torch.tensor(losses16))), f"non-finite loss at {FUSED_BATCH}")
    check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 0,
                  "fused_banded_whiten_kuf": 2 * FUSED_STEPS}, f"launches at {FUSED_BATCH}: {got}")
    check_finv_launches(2 * FUSED_STEPS, f"training at {FUSED_BATCH}")
    launches = {k: launches[k] + got[k] for k in got}

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        post = model.posterior(Xs)
    torch.cuda.synchronize()
    timings["posterior_ms_4096"] = (time.perf_counter() - t0) * 1e3
    got = cell_launches()
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
    check_finv_launches(0, "serving (the dense factors)")
    launches = {k: launches[k] + got[k] for k in got}
    return spec, model, post, launches, timings, step, gen


def check_finv_launches(want: int, what: str) -> None:
    """The main path's closed-form F⁻¹: ``want`` launches of ``m12_finv``
    since the last reset, all at (M_AXIS, M_AXIS) — one an axis a step."""
    from vggp_tpu_torch.ops import cell_kuf as ck

    got = {k: v for k, v in ck.SHAPE_LAUNCHES.items() if k[0] == "m12_finv"}
    print(f"{what}: m12_finv launches {ck.LAUNCHES['m12_finv']}, by shape {got}")
    check(ck.LAUNCHES["m12_finv"] == want
          and got == ({("m12_finv", M_AXIS, M_AXIS): want} if want else {}),
          f"{what}: m12_finv launches {ck.LAUNCHES['m12_finv']} {got}, expected {want}")


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

    launches = dict(NO_LAUNCHES)
    edge_launches = 0
    for name, which, n_launch, n, fn in head_table(device, spec, Xs):
        run = lambda tag: fn(specs[which], *ctx[which, tag])
        ck.reset_launch_counts()
        with torch.no_grad():
            g = run("card")
        torch.cuda.synchronize()
        got = cell_launches()
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
    timings["warm_posterior_cholesky_swap"] = cholesky_swap(device, spec, ctx, Xs)
    return launches, edge_launches, timings, st


def cholesky_swap(device, spec, ctx, Xs) -> dict:
    """Phase 6b (ROADMAP queue 3, item 4): the warm posterior at the 4096
    points on the card with the 512² Kuu Cholesky factors that the CPU takes
    in float32 moved over, and on the CPU in float32 with the card's factors
    moved there, each against the CPU's float64, as ratios to the CPU's own
    float32 error. A ratio near 1 with the CPU's factors on the card puts
    the card's gap on cuSOLVER's factorization. A reading, not a check."""
    import torch

    from vggp_tpu_torch import svgp
    from vggp_tpu_torch.ops.chol import PSDFactor

    (p_card, (ch_card, ls_card), _), (p32, (ch32, ls32), _) = ctx["main", "card"], ctx["main", "f32"]
    swap = lambda chols, dev: tuple(PSDFactor(c.F.to(dev)) for c in chols)
    xs32 = Xs.cpu()
    with torch.no_grad():
        ref = svgp.posterior_from_state(spec, *ctx["main", "f64"][:2], Xs.double().cpu())
        errs = {"cpu f32": gauss_err(svgp.posterior_from_state(spec, p32, (ch32, ls32), xs32), ref),
                "card f32": gauss_err(svgp.posterior_from_state(spec, p_card, (ch_card, ls_card),
                                                                Xs), ref),
                "card f32, cpu factors": gauss_err(svgp.posterior_from_state(
                    spec, p_card, (swap(ch32, device), ls_card), Xs), ref),
                "cpu f32, card factors": gauss_err(svgp.posterior_from_state(
                    spec, p32, (swap(ch_card, xs32.device), ls32), xs32), ref)}
    out = {k: {"err": v, "ratio_to_cpu_f32": v / errs["cpu f32"]} for k, v in errs.items()}
    print("6b warm posterior at 4096 points vs cpu f64, the Kuu Cholesky swapped: " + "; ".join(
        f"{k} {v['err']:.3e} (ratio {v['ratio_to_cpu_f32']:.2f})" for k, v in out.items()))
    return out


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


# --------------------------------------------------------------------------- #
# phases 7–9: the collapsed GriddedGP, the exact GP, the likelihoods
# --------------------------------------------------------------------------- #

def value_and_grads(loss_fn, params):
    """(loss, {name: gradient}) at constrained ``params``: ``d<key>_<axis>``
    for the axes (``d<key>_c<q>_<axis>`` for component q of a sum of
    kernels), ``dnoise``, ``d<key>`` for the variational leaves, ``dmean``
    for a learned mean and ``dz`` for free points; a leaf the loss does not
    reach has none."""
    from vggp_tpu_torch import train

    pg = train.tree_map(lambda v: v.detach().clone().requires_grad_(), params)
    val = loss_fn(pg)
    val.backward()
    axes = ([(f"c{q}_", cp["axes"]) for q, cp in enumerate(pg["components"])]
            if "components" in pg else [("", pg["axes"])])
    grads = {f"d{k}_{tag}{i}": v.grad for tag, ax_tuple in axes
             for i, ax in enumerate(ax_tuple) for k, v in ax.items()}
    grads["dnoise"] = pg["noise"].grad
    if "z" in pg:
        grads["dz"] = pg["z"].grad
    grads.update({f"d{k}": v.grad for k, v in pg.get("q", {}).items()})
    if "mean" in pg:
        grads["dmean"] = pg["mean"].grad
    return val.detach(), {k: g for k, g in grads.items() if g is not None}


def quantity_err(got, want) -> float:
    """max|Δ|/max|ref| of a tensor, a Gaussian (:func:`gauss_err`) or a
    tuple of tensors (the larger), both sides in float64 on the CPU."""
    from vggp_tpu_torch.models.common import Gaussian

    if isinstance(want, Gaussian):
        return gauss_err(got, want)
    if isinstance(want, tuple):
        return max(quantity_err(g, w) for g, w in zip(got, want, strict=True))
    return rel_err(got.double().cpu(), want.double().cpu())


def finite(g) -> bool:
    import torch

    from vggp_tpu_torch.models.common import Gaussian

    if isinstance(g, Gaussian):
        return all(finite(t) for t in (g.mean, g.cov, g.var) if t is not None)
    if isinstance(g, tuple):
        return all(finite(t) for t in g)
    if hasattr(g, "F"):                         # a PSD factor of the state
        return finite(g.F)
    return bool(torch.isfinite(g).all())


def quantity_tol(name: str, e32: float, grad_floor,
                 head_floor: float = TOL_E2E_POST) -> float:
    """The bound of :func:`check_quantities` on the quantity ``name`` whose
    CPU float32 error is ``e32``: the larger of its floor and
    CPU_ERR_RATIO × ``e32``. ``grad_floor`` is one floor for every gradient
    leaf, or a dict from a leaf's name prefix to its floor, the first
    matching key taken ("d" matches every leaf)."""
    if isinstance(grad_floor, dict) and name.startswith("d"):
        grad_floor = next(v for k, v in grad_floor.items() if name.startswith(k))
    floor = (grad_floor if name.startswith("d") else
             TOL_E2E_LOSS if name in ("elbo", "loss", "mll", "elbo_muS") else head_floor)
    return max(floor, CPU_ERR_RATIO * e32)


def check_quantities(what: str, got: dict, ref: dict, f32: dict, grad_floor: float,
                     head_floor: float = TOL_E2E_POST) -> None:
    """Every quantity on the card (``got``, float32) against ``ref``: finite,
    and within the larger of its floor (``grad_floor`` for a gradient leaf,
    TOL_E2E_LOSS for a loss, ``head_floor`` for a head) and CPU_ERR_RATIO ×
    the CPU's own float32 error (``f32``; a quantity it lacks is held at
    its floor alone)."""
    check(sorted(got) == sorted(ref) and set(f32) <= set(ref),
          f"{what}: quantities {sorted(got)} vs {sorted(ref)} vs {sorted(f32)}")
    worst = (0.0, "")
    for name in ref:
        check(finite(got[name]), f"{what} {name}: not finite")
        e = quantity_err(got[name], ref[name])
        e32 = quantity_err(f32[name], ref[name]) if name in f32 else 0.0
        tol = quantity_tol(name, e32, grad_floor, head_floor)
        worst = max(worst, (e / tol, name))
        print(f"check {what} {name}: card f32 {e:.3e}, "
              f"cpu f32 {f'{e32:.3e}' if name in f32 else 'not taken'}, tol {tol:.3e}")
        check(e <= tol, f"{what} {name}: card f32 {e} > {tol} (cpu f32 {e32})")
    print(f"check {what}: {len(ref)} quantities pass; the closest to its bound, "
          f"{worst[1]}, at {worst[0]:.3f} of it")


def run_counted(name, fn, n_cell_kuf):
    """A warm call and a timed call of ``fn`` under no_grad (host clock
    around the second, which ends in synchronize), with the launches of
    both counted: ``n_cell_kuf`` of ``cell_kuf`` a call and none of the
    other kernels. Returns (the output, ms, launches)."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    ck.reset_launch_counts()
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = cell_launches()
    want = {"cell_kuf": 2 * n_cell_kuf, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0}
    check(got == want, f"{name}: launches of two calls {got}, expected {want}")
    check(finite(out), f"{name}: not finite")
    return out, ms, got


def add_launches(total: dict, got: dict) -> dict:
    return {k: total[k] + got[k] for k in total}


def fit_counted(what, loss_fn, params, n_steps, trainable=None):
    """``train.fit`` for ``n_steps`` at FIT_LR (``trainable`` as there), its
    launches counted (reset just before, read just after); returns (params,
    ms per step over the fit, launches). The loss must be finite and fall."""
    import torch

    from vggp_tpu_torch import train
    from vggp_tpu_torch.ops import cell_kuf as ck

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = train.fit(loss_fn, params, n_steps, FIT_LR, trainable=trainable)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    got = cell_launches()
    losses = hist["loss"].double().cpu()
    print(f"{what}: fit {n_steps} steps, {ms:.3f} ms a step, loss {float(losses[0]):.6g} -> "
          f"{float(losses[-1]):.6g}, launches {got}")
    check(bool(torch.isfinite(losses).all()), f"{what}: loss not finite: {losses}")
    check(float(losses[-1]) < float(losses[0]), f"{what}: the loss did not fall: {losses}")
    return params, ms, got


def cast_to(device, dtype):
    """A cast of a tensor or a parameter tree to ``device`` and ``dtype``."""
    from vggp_tpu_torch import train

    return lambda t: train.tree_map(lambda v: v.detach().to(device=device, dtype=dtype), t)


# phase 7's heads and their cell_kuf launches a call, cold: (at (64, 65 536),
# elsewhere). The factored state takes one per axis at (64, n); so does the
# 256×256 grid's query block (posterior_from_state runs on the state of the
# precompute before it); the 4096 points' block one per axis at (64, 4096);
# q_dv's face difference one at (64, 65)
SGPR_HEADS = (("elbo", 2, 0), ("posterior", 2, 2), ("precompute", 2, 0),
              ("posterior_from_state grid", 2, 0), ("q_v", 2, 0), ("q_v full_cov", 2, 0),
              ("q_dv axis 0", 2, 1), ("q_dv axis 1", 2, 1), ("q_dv full_cov axis 0", 2, 1),
              ("q_dv full_cov axis 1", 2, 1), ("q_u", 2, 0), ("p_v_u", 2, 0), ("prior", 0, 0))


def sgpr_head(spec, name, p, X, y, pts, state=None):
    """One of phase 7's heads, cold, or with ``state`` from it (the
    ``*_from_state`` head; q_u, p_v_u and prior take none). ``pts``: the
    query points "xs" (4096), "grid" and "prior", and "shifted", the cells
    of p_v_u: on the model's own cells v is a function of u and p(v | u)
    has no variance to speak of, so its grid is theirs shifted by half a
    cell on each axis, each of its cells straddling two of theirs."""
    from vggp_tpu_torch import sgpr

    own, full = spec.features, "full_cov" in name
    if name == "elbo":
        return sgpr.elbo(spec, p, X, y)
    if name == "precompute":
        return sgpr.precompute(spec, p, X, y)
    if name == "posterior":
        if state is None:
            return sgpr.posterior(spec, p, X, y, pts["xs"], full_cov=False)
        return sgpr.posterior_from_state(spec, p, state, pts["xs"])
    if name == "posterior_from_state grid":
        return sgpr.posterior_from_state(spec, p, state, pts["grid"])
    if name == "prior":
        return sgpr.prior(spec, p, pts["prior"])
    if name == "q_u":
        return sgpr.q_u(spec, p, X, y)
    if name == "p_v_u":
        return sgpr.p_v_u(spec, p, X, y, pts["shifted"])
    if name.startswith("q_v"):
        if state is None:
            return sgpr.q_v(spec, p, X, y, own, full_cov=full)
        return sgpr.q_v_from_state(spec, p, state, own, full_cov=full)
    axis = int(name[-1])
    if state is None:
        return sgpr.q_dv(spec, p, X, y, own, axis, full_cov=full)
    return sgpr.q_dv_from_state(spec, p, state, own, axis, full_cov=full)


def sgpr_quantities(spec, params, X, y, pts, cast, grads=True, heads=True) -> dict:
    """Phase 7's compared quantities in one context (``cast`` to its device
    and dtype): the ELBO, its gradient leaves (with ``grads``), and (with
    ``heads``) every head but ``precompute`` from one ``precompute`` state,
    q_u and p_v_u too (each takes the state that ``sgpr.precompute``
    returns: a cold head is that state and the same formulas, and one state
    spares the CPU an O(n·m²) pass a head)."""
    from unittest import mock

    import torch

    from vggp_tpu_torch import sgpr

    p, X, y = cast(params), cast(X), cast(y)
    pts = {k: (cast(v) if isinstance(v, torch.Tensor) else v) for k, v in pts.items()}
    if grads:
        val, leaves = value_and_grads(lambda q: sgpr.loss(spec, q, X, y), p)
        out = {"elbo": -val, **leaves}
    with torch.no_grad():
        if not grads:
            out = {"elbo": sgpr.elbo(spec, p, X, y)}
        if not heads:
            return out
        state = sgpr.precompute(spec, p, X, y)
        with mock.patch.object(sgpr, "precompute", lambda *args: state):
            for name, *_ in SGPR_HEADS:
                if name not in ("elbo", "precompute"):
                    out[name] = sgpr_head(spec, name, p, X, y, pts, state)
    return out


def fit_collapsed(X, y) -> tuple:
    """The collapsed GriddedGP (64×64 cells, m = 4096) fitted on the first
    SGPR_N points: ``non_informative_init``, then SGPR_STEPS of
    :func:`fit_counted`. Returns (spec, params, ms per step, launches)."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, sgpr, train

    spec = SGPRSpec(kinds=("matern12", "matern12"),
                    features=tuple(CellIntegralFeature.from_lims(SGPR_CELLS, 0.0, 1.0)
                                   for _ in range(2)))
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    params0 = train.non_informative_init(spec.init_params(torch.float32), Xn, yn)
    return (spec, *fit_counted("collapsed m=4096", lambda p: sgpr.loss(spec, p, Xn, yn),
                               params0, SGPR_STEPS))


def collapsed_phase(device, X, y, Xs) -> tuple:
    """Phase 7: the collapsed GriddedGP (m = 4096) on SGPR_N points, trained
    and served on the card and held against float64. Returns (launches,
    timings, the launches at (64, 65 536) by kernel, (spec, the trained
    params) for phase 12c)."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, sgpr, train
    from vggp_tpu_torch.models.common import Gaussian
    from vggp_tpu_torch.ops import cell_kuf as ck

    spec, params, fit_ms, launches = fit_collapsed(X, y)
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    check(launches == {"cell_kuf": 0, "cell_kuf_with_dl": 2 * SGPR_STEPS,
                       "fused_banded_whiten_kuf": 0}, f"collapsed fit launches {launches}")
    timings = {"sgpr_fit_ms_per_step": fit_ms}

    # the steady state: WARM_STEPS steps, then WARM_STEPS timed ones
    raw = train.raw_leaves_from(params)
    step = train.make_step_fn(lambda p: sgpr.loss(spec, p, Xn, yn), raw,
                              torch.optim.Adam(train.tree_leaves(raw), lr=FIT_LR))
    ck.reset_launch_counts()
    for k in range(2 * WARM_STEPS):
        if k == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        step()
    torch.cuda.synchronize()
    timings["sgpr_step_ms"] = (time.perf_counter() - t0) * 1e3 / WARM_STEPS
    got = cell_launches()
    print(f"collapsed m=4096 n={SGPR_N}: steady-state step {timings['sgpr_step_ms']:.3f} ms, "
          f"launches {got}")
    check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 4 * WARM_STEPS,
                  "fused_banded_whiten_kuf": 0}, f"collapsed steps' launches {got}")
    launches = add_launches(launches, got)
    at_n = {"cell_kuf": 0, "cell_kuf_with_dl": launches["cell_kuf_with_dl"]}

    half = 0.5 / SGPR_CELLS
    pts = {"xs": Xs, "grid": serving_grid_points(device), "prior": Xs[:FULL_COV_POINTS],
           "shifted": tuple(CellIntegralFeature.from_lims(SGPR_CELLS, half, 1.0 + half)
                            for _ in range(2))}
    outputs = {}
    for name, n_at_n, n_other in SGPR_HEADS:
        n_launch = n_at_n + n_other
        state = outputs["precompute"] if name == "posterior_from_state grid" else None
        out, ms, got = run_counted(name, lambda: sgpr_head(spec, name, params, Xn, yn, pts, state),
                                   n_launch)
        launches = add_launches(launches, got)
        at_n["cell_kuf"] += 2 * n_at_n
        timings[f"sgpr_{name.replace(' ', '_')}_ms"] = ms
        outputs[name] = out
        print(f"collapsed head {name}: {ms:.3f} ms, cell_kuf {n_launch} a call")
    _, A, LB, _ = outputs["precompute"]
    check(A.shape == (spec.num_inducing, SGPR_N) and LB.shape == (spec.num_inducing,) * 2,
          f"collapsed state shapes: A {tuple(A.shape)}, L_B {tuple(LB.shape)}")

    # the card's float32 against the card's float64 at the full n (the
    # kernels' float64 instances), and against the CPU's float64 at a cut n;
    # the grid posterior on its first SERVE_POINTS points (the CPU's float32
    # of all 65 536 would take a (4096, 65 536) triangular solve). At the
    # full n the card's heads are the timed cold calls' outputs above, and
    # the CPU's float32 takes no gradient (three (4096, 65 536) products).
    pts["grid"] = pts["grid"][:SERVE_POINTS]
    grid = outputs["posterior_from_state grid"]
    cold = {**outputs, "posterior_from_state grid": Gaussian(mean=grid.mean[:SERVE_POINTS],
                                                             var=grid.var[:SERVE_POINTS])}
    del cold["precompute"]
    cpu = torch.device("cpu")
    for what, n, floor, refs in (
            (f"collapsed n={SGPR_N} vs card f64", SGPR_N, TOL_GRAD["collapsed full n"],
             ((device, torch.float64, True), (cpu, torch.float32, False))),
            (f"collapsed n={SGPR_CUT_N} vs cpu f64", SGPR_CUT_N, TOL_GRAD["collapsed cut n"],
             ((cpu, torch.float64, True), (cpu, torch.float32, True)))):
        t0 = time.perf_counter()
        ref, f32 = (sgpr_quantities(spec, params, X[:n], y[:n], pts, cast_to(dev, dt), grads)
                    for dev, dt, grads in refs)
        full = n == SGPR_N
        got = sgpr_quantities(spec, params, X[:n], y[:n], pts,
                              cast_to(device, torch.float32), heads=not full)
        if full:
            got.update(cold)
        check_quantities(what, got, ref, f32, floor)
        timings[f"check {what} s"] = time.perf_counter() - t0
    return launches, timings, at_n, (spec, params)


# phase 8's heads and their cell_kuf launches a call: q_v's cell/point
# covariance on each axis at (64, 4096); q_dv's on the axis it does not
# differentiate
EXACT_HEADS = (("mll", 0), ("posterior", 0), ("q_v", 2), ("q_v full_cov", 2),
               ("q_dv axis 0", 1), ("q_dv axis 1", 1))


def exact_head(spec, name, p, X, y, xs, grid):
    from vggp_tpu_torch import exact

    full = "full_cov" in name
    if name == "mll":
        return exact.mll(spec, p, X, y)
    if name == "posterior":
        return exact.posterior(spec, p, X, y, xs, full_cov=False)
    if name.startswith("q_v"):
        return exact.q_v(spec, p, X, y, grid, full_cov=full)
    return exact.q_dv(spec, p, X, y, grid, int(name[-1]), full_cov=full)


def fit_exact(X, y) -> tuple:
    """The exact GP fitted on the first EXACT_N points:
    ``non_informative_init``, then EXACT_STEPS of :func:`fit_counted`.
    Returns (spec, params, ms per step, launches)."""
    import torch

    from vggp_tpu_torch import ExactGPSpec, exact, train

    spec = ExactGPSpec(("matern12", "matern12"))
    Xn, yn = X[:EXACT_N], y[:EXACT_N]
    params0 = train.non_informative_init(spec.init_params(torch.float32), Xn, yn)
    return (spec, *fit_counted(f"exact n={EXACT_N}", lambda p: exact.loss(spec, p, Xn, yn),
                               params0, EXACT_STEPS))


def exact_phase(device, X, y, Xs) -> tuple:
    """Phase 8: the exact GP on EXACT_N points, trained and served on the
    card and held against the CPU's float64 at the same size. Returns
    (launches, timings, (spec, the trained params) for 14c)."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, exact

    spec, params, fit_ms, launches = fit_exact(X, y)
    Xn, yn = X[:EXACT_N], y[:EXACT_N]
    check(sum(launches.values()) == 0, f"exact fit launches {launches}")
    timings = {"exact_fit_ms_per_step": fit_ms}
    grid = tuple(CellIntegralFeature.from_lims(SGPR_CELLS, 0.0, 1.0) for _ in range(2))
    for name, n_launch in EXACT_HEADS:
        _, ms, got = run_counted(name, lambda: exact_head(spec, name, params, Xn, yn, Xs, grid),
                                 n_launch)
        launches = add_launches(launches, got)
        timings[f"exact_{name.replace(' ', '_')}_ms"] = ms
        print(f"exact head {name}: {ms:.3f} ms, cell_kuf {n_launch} a call")

    def quantities(cast):
        p, Xc, yc, xs = cast(params), cast(Xn), cast(yn), cast(Xs)
        val, grads = value_and_grads(lambda q: exact.loss(spec, q, Xc, yc), p)
        with torch.no_grad():
            return {"mll": -val, **grads,
                    **{name: exact_head(spec, name, p, Xc, yc, xs, grid)
                       for name, _ in EXACT_HEADS if name != "mll"}}

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    check_quantities(f"exact n={EXACT_N} vs cpu f64",
                     *(quantities(cast_to(dev, dt)) for dev, dt in (
                         (device, torch.float32), (cpu, torch.float64), (cpu, torch.float32))),
                     TOL_GRAD["exact"])
    timings["check exact s"] = time.perf_counter() - t0
    return launches, timings, (spec, params)


def likelihood_targets(name, X, y, seed):
    """Phase 9's targets from the seeded X: bernoulli, the sign of the test
    function; poisson, counts drawn at rate exp(f); student_t, the Gaussian
    target plus 0.1·t₄ noise."""
    import numpy as np
    import torch

    x = X.double().cpu().numpy()
    f = np.sin(6 * x[:, 0]) * np.cos(5 * x[:, 1])
    rng = np.random.default_rng(seed)
    if name == "bernoulli":
        t = (f > 0).astype(float)
    elif name == "poisson":
        t = rng.poisson(np.exp(f)).astype(float)
    else:
        t = y.double().cpu().numpy() + 0.1 * rng.standard_t(4.0, size=f.shape)
    return torch.as_tensor(t, dtype=X.dtype, device=X.device)


def train_likelihood(device, X, y, i) -> tuple:
    """The 512×512 Kronecker SVGP under the i-th of LIKELIHOODS, LIK_STEPS
    Adam steps at batch TRAIN_BATCH on its targets, the launches counted
    (reset just before, read just after). Returns (spec, model, targets,
    losses, ms per step, launches)."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp, train
    from vggp_tpu_torch.models.svgp import SVGP
    from vggp_tpu_torch.ops import cell_kuf as ck

    name, opts = LIKELIHOODS[i]
    spec = SVGPSpec(kinds=("matern12", "matern12"),
                    features=tuple(CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0)
                                   for _ in range(2)),
                    num_data=NUM_DATA, variational="kron", likelihood=name,
                    likelihood_opts=opts)
    t = likelihood_targets(name, X, y, seed=20 + i)
    model = SVGP(spec)
    step = train.make_step_fn(lambda p, xb, yb: svgp.loss(spec, p, xb, yb), model.raw_params(),
                              torch.optim.Adam(model.parameters(), lr=LIK_LR))
    gen = torch.Generator(device=device)
    gen.manual_seed(i)
    ck.reset_launch_counts()
    losses, ms = run_steps(step, X, t, TRAIN_BATCH, LIK_STEPS, gen)
    got = cell_launches()
    print(f"{name}: {LIK_STEPS} steps at batch {TRAIN_BATCH}, loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, {ms:.3f} ms a step, launches {got}")
    check(all(v == v and abs(v) != float("inf") for v in losses), f"{name}: loss not finite")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}")
    return spec, model, t, losses, ms, got


def likelihood_phase(device, X, y, Xs) -> tuple:
    """Phase 9: the 512×512 Kronecker SVGP under each non-Gaussian
    likelihood, LIK_STEPS Adam steps at batch TRAIN_BATCH, then the loss,
    its gradient leaves and ``predict_y`` on the card against the CPU's
    float64. Returns (launches, timings)."""
    import torch

    from vggp_tpu_torch import svgp, train
    from vggp_tpu_torch.ops import cell_kuf as ck

    launches = dict(NO_LAUNCHES)
    timings = {}
    cpu = torch.device("cpu")
    for i, (name, _) in enumerate(LIKELIHOODS):
        spec, model, t, _, timings[f"{name}_step_ms"], got = train_likelihood(device, X, y, i)
        check(got == {"cell_kuf": 0, "cell_kuf_with_dl": 2 * LIK_STEPS,
                      "fused_banded_whiten_kuf": 0}, f"{name}: launches {got}")
        launches = add_launches(launches, got)
        pred, ms, got = run_counted(f"{name} predict_y", lambda: svgp.predict_y(
            spec, model.params(), Xs), 2)
        launches = add_launches(launches, got)
        timings[f"{name}_predict_y_ms"] = ms
        with torch.no_grad():
            params = train.tree_map(lambda v: v.detach(), model.params())
        xb, yb = X[:TRAIN_BATCH], t[:TRAIN_BATCH]

        def quantities(cast):
            p, xc, yc, xs = cast(params), cast(xb), cast(yb), cast(Xs)
            val, grads = value_and_grads(lambda q: svgp.loss(spec, q, xc, yc), p)
            with torch.no_grad():
                return {"loss": val, **grads, "predict_y": svgp.predict_y(spec, p, xs)}

        check_quantities(f"{name} vs cpu f64", *(quantities(cast_to(dev, dt)) for dev, dt in (
            (device, torch.float32), (cpu, torch.float64), (cpu, torch.float32))),
            TOL_GRAD["likelihood"])
        if name == "bernoulli":
            check(bool(((pred >= 0) & (pred <= 1)).all()), "bernoulli predict_y outside [0, 1]")
        elif name == "poisson":
            check(bool((pred[0] > 0).all() and (pred[1] >= pred[0]).all()),
                  "poisson predict_y: E[λ] not positive or Var[y] < E[λ]")
        else:
            check(bool((pred.var > 0).all()), "student_t predict_y: variance not positive")
    return launches, timings


# --------------------------------------------------------------------------- #
# phase 10: the Matérn-3/2, 5/2 and RBF cell features, the non-uniform mesh
# and the pointwise-gradient heads
# --------------------------------------------------------------------------- #

KIND_STEPS = 8          # 10b and 10c at batch 4096, the first WARM_STEPS untimed
KIND_FUSED_STEPS = 4    # 10c at batch 16 384
SGPR_KIND_STEPS = 4     # 10d, full batch
EXACT_KIND_STEPS = 5    # 10e
# bench.py:228-260: a 1-D collapsed GriddedGP with RBF cells across ℓ/δ
RBF_CELLS, RBF_N, RBF_STEPS, RBF_LR = 64, 384, 30, 3e-2
RBF_RATIOS = (0.1, 1.0, 10.0, 50.0)
LAMBDA_RATIOS = (0.1, 1.0, 10.0, 50.0, 512.0)   # ℓ/δ of the λ_min readings, m = 512
NO_LAUNCHES = {"cell_kuf": 0, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0}


def cell_launches() -> dict:
    """``ops.cell_kuf.LAUNCHES`` of the three cell kernels, whose routes the
    phases hold launch for launch. The closed-form F⁻¹'s kernel
    (``m12_finv``) is held apart: against plain at every m it launches
    (phase 3d and the end of :func:`main`), exactly in phase 4's steps, and
    by shape in phase 14."""
    from vggp_tpu_torch.ops import cell_kuf as ck

    return {k: ck.LAUNCHES[k] for k in NO_LAUNCHES}


def cell_shape_launches() -> dict:
    """``ops.cell_kuf.SHAPE_LAUNCHES`` of the three cell kernels."""
    from vggp_tpu_torch.ops import cell_kuf as ck

    return {k: v for k, v in ck.SHAPE_LAUNCHES.items() if k[0] in NO_LAUNCHES}
# The Matérn-3/2 models of 10b and 10d take the float32 jitter floor of their
# cells (KIND_JITTER_F32 and the feature's 2e-4) as their spec's jitter, so
# that the float64 references are the same model: with the default 1e-6 the
# float64 Gram would be jittered 200× less, which moved the loss by 1% and
# the gradients by up to 13% on the CPU at 16 and 8 cells an axis.
SLICE_JITTER = 2e-4
# gradient floors of phase 10's comparisons, as TOL_GRAD's: the SVGPs (10b,
# 10c) as the likelihood SVGPs', the exact GP as phase 8's; the Matérn-3/2
# collapsed GP's about 5× the largest sound reading, which is 10× phase 7's:
# its float32 leaves scatter from 1e-6 to 2.6e-4 off float64 on the card
# and the CPU alike, by which of its factorizations runs in float64
# (tools/torch_collapsed_precision.py; an H100).
TOL_GRAD_SLICE = {"svgp": 2e-3, "collapsed": 1.5e-3, "exact": 2.5e-5}


def stretched_mesh(m: int):
    """m cells on [0, 1] refined toward the middle, standing in for a grid
    refined over a front: the edges 0.5 + 0.5·sinh(1.5(2t − 1))/sinh(1.5) on
    a uniform t, the middle cells 2.35× narrower than the end ones."""
    import numpy as np

    t = np.linspace(0.0, 1.0, m + 1)
    return 0.5 + 0.5 * np.sinh(1.5 * (2.0 * t - 1.0)) / np.sinh(1.5)


def check_nonuniform_kernels(device) -> dict:
    """10c: both cell kernels against their plain versions on the stretched
    mesh, at the SVGP step's (512, 4096) and, every point on an (unevenly
    spaced) cell edge, at (512, 513), in float64 (TOL_F64) and float32
    (TOL_F32). Returns the float32 max |kernel − plain| by kernel."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    errs = {}
    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        for n, on_edges in ((TRAIN_BATCH, False), (M_AXIS + 1, True)):
            mesh, x, v, ell, _ = kernel_inputs(M_AXIS, n, dtype, device, seed=12,
                                               mesh=stretched_mesh(M_AXIS))
            if on_edges:
                x = mesh.clone()
            pairs = [("cell_kuf", "Kuf", ck.cell_kuf(mesh, x, v, ell),
                      ck.cell_kuf_plain(mesh, x, v, ell))]
            pairs += [("cell_kuf_with_dl", name, g, w) for name, g, w in zip(
                ("Kuf", "dKuf"), ck.cell_kuf_with_dl(mesh, x, v, ell),
                ck.cell_kuf_with_dl_plain(mesh, x, v, ell))]
            for kernel, name, got, want in pairs:
                e = rel_err(got, want)
                print(f"check {kernel} {name} {tag} ({M_AXIS}, {n}) stretched mesh"
                      f"{', x = the mesh' if on_edges else ''}: rel {e:.3e}")
                check(e < tol, f"{kernel} {name} {tag} stretched ({M_AXIS}, {n}) rel {e}")
                if tag == "f32":
                    errs[kernel] = max(errs.get(kernel, 0.0), float((got - want).abs().max()))
    return errs


def lambda_min_readings(device) -> dict:
    """10: λ_min of the jittered 512-cell Grams over their mean diagonal,
    built in float32 on the card against float64, at ℓ/δ ∈ LAMBDA_RATIOS (δ
    the mean cell width), and whether the float32 Cholesky succeeds: the
    Matérn-3/2, 5/2 and RBF Grams of the uniform mesh at their float32
    jitter floor (2e-4), and the Matérn-1/2 Gram of the stretched mesh at
    its floor (1e-6), as the port builds it and by the JAX package's generic
    cell/cell form. Readings, not checks: the JAX floors are kept."""
    import types

    import torch

    from vggp_tpu_torch import CellIntegralFeature
    from vggp_tpu_torch.features import _cell_cell_cov
    from vggp_tpu_torch.models import common

    uniform = CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0)
    stretched = CellIntegralFeature(stretched_mesh(M_AXIS))
    spec = types.SimpleNamespace(jitter=1e-6)

    def generic(feat, kind, rel, ell, var):
        mesh = feat.mesh_j({"lengthscale": ell})
        k = _cell_cell_cov(kind, mesh, mesh, var, ell)
        k = 0.5 * (k + k.T)
        return k + torch.mean(torch.diagonal(k)) * rel * torch.eye(k.shape[0], dtype=k.dtype,
                                                                    device=k.device)

    cases = [(kind, uniform, common._kuu_jittered) for kind in ("matern32", "matern52", "rbf")]
    cases += [("matern12 stretched", stretched, common._kuu_jittered),
              ("matern12 stretched, generic form", stretched, generic)]
    out = {}
    for name, feat, gram in cases:
        kind = name.split()[0]
        rel = common.axis_rel_jitter(spec, kind, torch.float32, feat)
        cells = []
        for ratio in LAMBDA_RATIOS:
            lam = {}
            for dtype in (torch.float32, torch.float64):
                var = torch.tensor(1.0, dtype=dtype, device=device)
                ell = torch.tensor(ratio / M_AXIS, dtype=dtype, device=device)
                k = gram(feat, kind, rel, ell, var)
                lam[dtype] = (float(torch.linalg.eigvalsh(k.double())[0])
                              / float(torch.mean(torch.diagonal(k))))
                if dtype == torch.float32:
                    chol_ok = int(torch.linalg.cholesky_ex(k).info) == 0
            cells.append({"l_over_delta": ratio, "lambda_min_f32": lam[torch.float32],
                          "lambda_min_f64": lam[torch.float64], "f32_cholesky": chol_ok})
        out[name] = {"rel_jitter": rel, "readings": cells}
        print(f"lambda_min {name} m={M_AXIS} rel jitter {rel:g}: " + "; ".join(
            f"l/d {c['l_over_delta']:g}: f32 {c['lambda_min_f32']:.4e}, "
            f"f64 {c['lambda_min_f64']:.4e}, f32 chol {'ok' if c['f32_cholesky'] else 'FAILS'}"
            for c in cells))
    return out


def train_svgp(device, spec, X, y, runs, seed, after_run=None) -> tuple:
    """The SVGP of ``spec`` from its initial parameters, Adam at lr 1e-2 for
    each (batch, steps) of ``runs`` in turn, the launches of each run
    counted (reset just before, read just after); ``after_run(model)`` is
    called after each run. Returns (model, [(losses, ms a step,
    launches)])."""
    import torch

    from vggp_tpu_torch import svgp, train
    from vggp_tpu_torch.models.svgp import SVGP
    from vggp_tpu_torch.ops import cell_kuf as ck

    model = SVGP(spec)
    step = train.make_step_fn(lambda p, xb, yb: svgp.loss(spec, p, xb, yb), model.raw_params(),
                              torch.optim.Adam(model.parameters(), lr=1e-2))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for batch, n_steps in runs:
        ck.reset_launch_counts()
        losses, ms = run_steps(step, X, y, batch, n_steps, gen)
        out.append((losses, ms, cell_launches()))
        check(all(v == v and abs(v) != float("inf") for v in losses),
              f"{spec.kinds}: loss not finite at batch {batch}: {losses}")
        if after_run is not None:
            after_run(model)
    return model, out


def svgp_slice_quantities(spec, params, xb, yb, heads, cast) -> dict:
    """The loss and its gradient leaves at (xb, yb), and every head of
    ``heads`` ((name, fn(spec, params, state, pts))) from one ``precompute``
    state, in one context (``cast`` to its device and dtype)."""
    import torch

    from vggp_tpu_torch import svgp

    p = cast(params)
    val, grads = value_and_grads(lambda q: svgp.loss(spec, q, cast(xb), cast(yb)), p)
    with torch.no_grad():
        state = svgp.precompute(spec, p)
        return {"loss": val, **grads, **{name: fn(spec, p, state, cast) for name, fn in heads}}


def hold_against_cpu(what, quantities, device, floor, head_floor=TOL_E2E_POST,
                     launches=None) -> float:
    """Phase 10's rule: ``quantities(cast)`` on the card in float32 against
    the CPU's float64, by :func:`check_quantities` with the CPU's float32;
    with ``launches``, the card's evaluation must launch exactly those
    (counted from just before it to just after). Returns the seconds it
    took."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    ck.reset_launch_counts()
    got = quantities(cast_to(device, torch.float32))
    counted = cell_launches()
    if launches is not None:
        print(f"{what}: the card's evaluation launched {counted}")
        check(counted == launches, f"{what}: launches {counted}, expected {launches}")
    check_quantities(what, got, *(quantities(cast_to(cpu, dt))
                                  for dt in (torch.float64, torch.float32)), floor, head_floor)
    return time.perf_counter() - t0


def timed_heads(heads, spec, params, state, cast) -> dict:
    """Host ms of one warm call of each head (:func:`host_ms`), with no
    kernel launched (the launches of both calls counted)."""
    from vggp_tpu_torch.ops import cell_kuf as ck

    out = {}
    for name, fn in heads:
        ck.reset_launch_counts()
        out[name] = host_ms(lambda: fn(spec, params, state, cast))
        check(cell_launches() == NO_LAUNCHES, f"{name}: launches {cell_launches()}")
    return out


def kinds_svgp_part(device, X, y, Xs, timings) -> tuple:
    """10b: the 512² Kronecker SVGP with Matérn-3/2 cells (dense F⁻¹, the
    forward-mode ℓ-tangent): KIND_STEPS steps at batch 4096, the loss and its
    gradient leaves, ``posterior_grad`` on both axes cold and from
    ``precompute`` at the 4096 points and ``q_dv`` on axis 0 of the 512²
    cells against the CPU's float64. No kernel launches anywhere. Returns
    (spec, the trained params) for 14b."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp, train

    spec = SVGPSpec(kinds=("matern32",) * 2, features=tuple(
        CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0) for _ in range(2)),
        num_data=NUM_DATA, variational="kron", jitter=SLICE_JITTER)
    model, [(losses, ms, got)] = train_svgp(device, spec, X, y, ((TRAIN_BATCH, KIND_STEPS),), 30)
    print(f"10b matern32 SVGP: {KIND_STEPS} steps at batch {TRAIN_BATCH}, loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, {ms:.3f} ms a step, launches {got}")
    check(got == NO_LAUNCHES, f"10b matern32 SVGP launches {got}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"10b: the loss did not fall: {losses}")
    timings["matern32_svgp_step_ms_batch4096"] = ms
    own = spec.features
    heads = [(f"posterior_grad axis {a}", lambda s, p, st, c, a=a: svgp.posterior_grad(s, p, c(Xs), a))
             for a in (0, 1)]
    heads += [(f"posterior_grad_from_state axis {a}",
               lambda s, p, st, c, a=a: svgp.posterior_grad_from_state(s, p, st, c(Xs), a))
              for a in (0, 1)]
    heads.append(("q_dv axis 0 own cells", lambda s, p, st, c: svgp.q_dv(s, p, own, 0)))
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
        state = svgp.precompute(spec, params)
    cast = cast_to(device, torch.float32)
    for name, t in timed_heads(heads, spec, params, state, cast).items():
        timings[f"matern32_svgp_{name.replace(' ', '_')}_ms"] = t
    xb, yb = X[:TRAIN_BATCH], y[:TRAIN_BATCH]
    timings["check 10b s"] = hold_against_cpu(
        "10b matern32 SVGP vs cpu f64",
        lambda c: svgp_slice_quantities(spec, params, xb, yb, heads, c), device,
        TOL_GRAD_SLICE["svgp"])
    return spec, params


def nonuniform_svgp_part(device, X, y, Xs, timings) -> tuple:
    """10c: the 512² Kronecker SVGP with Matérn-1/2 cells on the stretched
    mesh: the cell kernels against their plain versions there, KIND_STEPS
    steps at batch 4096 and KIND_FUSED_STEPS at 16 384 (cell_kuf_with_dl
    twice a step, the fused kernel never: no band ratio), the posterior at
    the 4096 points (cell_kuf twice), and the loss, its gradient leaves and
    the posterior against the CPU's float64. Returns (launches, the kernels'
    float32 errors, the launches by kernel at the stretched shapes)."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp, train

    errs = check_nonuniform_kernels(device)
    feats = tuple(CellIntegralFeature(stretched_mesh(M_AXIS)) for _ in range(2))
    spec = SVGPSpec(kinds=("matern12",) * 2, features=feats, num_data=NUM_DATA,
                    variational="kron")
    check(not feats[0].uniform, "the stretched mesh is not uniform")
    runs = ((TRAIN_BATCH, KIND_STEPS), (FUSED_BATCH, KIND_FUSED_STEPS))
    model, out = train_svgp(device, spec, X, y, runs, 31)
    launches = dict(NO_LAUNCHES)
    for (batch, n_steps), (losses, ms, got) in zip(runs, out):
        print(f"10c stretched matern12 SVGP: {n_steps} steps at batch {batch}, loss "
              f"{losses[0]:.6g} -> {losses[-1]:.6g}, {ms:.3f} ms a step, launches {got}")
        check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": 2 * n_steps},
              f"10c launches at batch {batch}: {got}")
        timings[f"stretched_svgp_step_ms_batch{batch}"] = ms
        launches = add_launches(launches, got)
    check(sum(out[0][0][-3:]) < sum(out[0][0][:3]), f"10c: the loss did not fall: {out[0][0]}")
    _, ms, got = run_counted("10c posterior", lambda: model.posterior(Xs), 2)
    timings["stretched_svgp_posterior_ms_4096"] = ms
    launches = add_launches(launches, got)
    at_shape = {"cell_kuf_with_dl": launches["cell_kuf_with_dl"], "cell_kuf": got["cell_kuf"]}
    print(f"10c posterior at {SERVE_POINTS} points: {ms:.3f} ms, launches of two calls {got}")
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
    heads = [("posterior", lambda s, p, st, c: svgp.posterior(s, p, c(Xs)))]
    xb, yb = X[:TRAIN_BATCH], y[:TRAIN_BATCH]
    timings["check 10c s"] = hold_against_cpu(
        "10c stretched matern12 SVGP vs cpu f64",
        lambda c: svgp_slice_quantities(spec, params, xb, yb, heads, c), device,
        TOL_GRAD_SLICE["svgp"])
    return launches, errs, at_shape


def kinds_collapsed_part(device, X, y, Xs, timings) -> None:
    """10d: the collapsed GriddedGP with Matérn-3/2 cells (64×64, the model
    of ``experiments/velocity.py`` at phase 7's size) on the first SGPR_N
    points: SGPR_KIND_STEPS full-batch steps, then the ELBO, its gradient
    leaves, ``posterior_grad`` (marginal at the 4096 points, ``full_cov`` at
    FULL_COV_POINTS) and ``q_dv`` on both axes from ``precompute``, against
    the card's float64 at the full n (the ELBO and the heads, beside the
    CPU's float32) and the CPU's float64 at SGPR_CUT_N (with the gradient
    leaves). No kernel launches. Returns (spec, the trained params) for
    13b and 14b."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, sgpr, train

    spec = SGPRSpec(kinds=("matern32",) * 2, features=tuple(
        CellIntegralFeature.from_lims(SGPR_CELLS, 0.0, 1.0) for _ in range(2)),
        jitter=SLICE_JITTER)
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    params0 = train.non_informative_init(spec.init_params(torch.float32), Xn, yn)
    params, ms, got = fit_counted("10d collapsed matern32 m=4096",
                                  lambda p: sgpr.loss(spec, p, Xn, yn), params0, SGPR_KIND_STEPS)
    check(got == NO_LAUNCHES, f"10d fit launches {got}")
    timings["matern32_sgpr_fit_ms_per_step"] = ms
    own = spec.features
    for a in (0, 1):
        _, ms, _ = run_counted(f"10d posterior_grad axis {a}", lambda a=a: sgpr.posterior_grad(
            spec, params, Xn, yn, Xs, a), 0)
        timings[f"matern32_sgpr_posterior_grad_axis{a}_ms"] = ms

    def quantities(cast, n, grads):
        p, Xc, yc, xs = cast(params), cast(X[:n]), cast(y[:n]), cast(Xs)
        out = {}
        if grads:
            val, leaves = value_and_grads(lambda q: sgpr.loss(spec, q, Xc, yc), p)
            out = {"elbo": -val, **leaves}
        with torch.no_grad():
            if not grads:
                out["elbo"] = sgpr.elbo(spec, p, Xc, yc)
            state = sgpr.precompute(spec, p, Xc, yc)
            for a in (0, 1):
                out[f"posterior_grad axis {a}"] = sgpr.posterior_grad_from_state(
                    spec, p, state, xs, a)
                out[f"posterior_grad full_cov axis {a}"] = sgpr.posterior_grad_from_state(
                    spec, p, state, xs[:FULL_COV_POINTS], a, full_cov=True)
                out[f"q_dv axis {a}"] = sgpr.q_dv_from_state(spec, p, state, own, a)
        return out

    # As phase 7: at the full n the ELBO and the heads against the card's
    # float64, beside the CPU's float32 (no gradient: three (4096, 65 536)
    # products); the gradient leaves at the cut n. The Matérn-3/2 model's
    # float32 is far from float64 on any device (dσ² 5.2e-2 at the full n,
    # the gradient heads 6e-3, on an H100), so no floor alone holds it.
    cpu = torch.device("cpu")
    for what, n, grads, refs in (
            (f"10d collapsed matern32 n={SGPR_N} vs card f64", SGPR_N, False,
             ((device, torch.float64), (cpu, torch.float32))),
            (f"10d collapsed matern32 n={SGPR_CUT_N} vs cpu f64", SGPR_CUT_N, True,
             ((cpu, torch.float64), (cpu, torch.float32)))):
        t0 = time.perf_counter()
        got = quantities(cast_to(device, torch.float32), n, grads)
        ref, *f32 = (quantities(cast_to(dev, dt), n, grads) for dev, dt in refs)
        check_quantities(what, got, ref, f32[0] if f32 else {}, TOL_GRAD_SLICE["collapsed"])
        timings[f"check {what} s"] = time.perf_counter() - t0
    return spec, params


def kinds_exact_part(device, X, y, Xs, timings) -> None:
    """10e: the exact GP with Matérn-3/2 on EXACT_N points: EXACT_KIND_STEPS
    steps, then ``posterior_grad`` on both axes, marginal at the 4096 points
    and ``full_cov`` at FULL_COV_POINTS of them, against the CPU's float64."""
    import torch

    from vggp_tpu_torch import ExactGPSpec, exact, train

    spec = ExactGPSpec(("matern32", "matern32"))
    Xn, yn = X[:EXACT_N], y[:EXACT_N]
    params0 = train.non_informative_init(spec.init_params(torch.float32), Xn, yn)
    params, ms, got = fit_counted(f"10e exact matern32 n={EXACT_N}",
                                  lambda p: exact.loss(spec, p, Xn, yn), params0, EXACT_KIND_STEPS)
    check(got == NO_LAUNCHES, f"10e fit launches {got}")
    timings["matern32_exact_fit_ms_per_step"] = ms
    heads = [(f"posterior_grad{' full_cov' if full else ''} axis {a}", a, full)
             for a in (0, 1) for full in (False, True)]
    for name, a, full in heads:
        pts = Xs[:FULL_COV_POINTS] if full else Xs
        _, ms, _ = run_counted(f"10e {name}", lambda a=a, full=full, pts=pts: exact.posterior_grad(
            spec, params, Xn, yn, pts, a, full_cov=full), 0)
        timings[f"matern32_exact_{name.replace(' ', '_')}_ms"] = ms

    def quantities(cast):
        p, Xc, yc, xs = cast(params), cast(Xn), cast(yn), cast(Xs)
        with torch.no_grad():
            return {"mll": exact.mll(spec, p, Xc, yc),
                    **{name: exact.posterior_grad(spec, p, Xc, yc,
                                                  xs[:FULL_COV_POINTS] if full else xs, a,
                                                  full_cov=full)
                       for name, a, full in heads}}

    timings["check 10e s"] = hold_against_cpu(f"10e exact matern32 n={EXACT_N} vs cpu f64",
                                              quantities, device, TOL_GRAD_SLICE["exact"])


def rbf_fits(device, timings) -> None:
    """10: ``bench.py``'s RBF check: a 1-D collapsed GriddedGP with RBF_CELLS
    RBF cells, RBF_N points from seed 7, RBF_STEPS Adam steps at RBF_LR from
    ℓ = ratio·δ for each ratio of RBF_RATIOS; the losses finite and falling."""
    import numpy as np
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, sgpr, train

    feat = CellIntegralFeature.from_lims(RBF_CELLS, 0.0, 1.0)
    spec = SGPRSpec(kinds=("rbf",), features=(feat,))
    rng = np.random.default_rng(7)
    xr = np.sort(rng.random(RBF_N))
    yr = np.sin(6 * xr) + 0.05 * rng.standard_normal(RBF_N)
    Xr, Yr = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (xr, yr))
    t0 = time.perf_counter()
    for ratio in RBF_RATIOS:
        p = spec.init_params(torch.float32)
        p["axes"][0]["lengthscale"] = torch.tensor(ratio * feat.delta, dtype=torch.float32,
                                                   device=device)
        _, hist = train.fit(lambda q: sgpr.loss(spec, q, Xr, Yr), p, RBF_STEPS, RBF_LR)
        losses = hist["loss"].double().cpu()
        print(f"10 rbf fit l/d {ratio:g}: loss {float(losses[0]):.6g} -> {float(losses[-1]):.6g}")
        check(bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0]),
              f"rbf gridded fit at l/d {ratio}: {losses.tolist()}")
    timings["rbf_fits_s"] = time.perf_counter() - t0


def slice_phase(device, X, y, Xs) -> tuple:
    """Phase 10: 10b–10e and the RBF fits (10a is check_goldens), with the
    λ_min readings. Returns (launches, timings, (the kernels' float32 errors
    and launches on the stretched mesh, the λ_min readings, 10d's model,
    10b's model))."""
    timings = {}
    launches = dict(NO_LAUNCHES)
    for part in (kinds_svgp_part, nonuniform_svgp_part, kinds_collapsed_part,
                 kinds_exact_part):
        t0 = time.perf_counter()
        out = part(device, X, y, Xs, timings)
        if part is nonuniform_svgp_part:
            launches, errs, at_shape = out
        if part is kinds_collapsed_part:
            matern32 = out
        if part is kinds_svgp_part:
            m32_svgp = out
        timings[f"{part.__name__}_s"] = time.perf_counter() - t0
        print(f"{part.__name__}: {timings[f'{part.__name__}_s']:.1f} s")
    rbf_fits(device, timings)
    readings = lambda_min_readings(device)
    return launches, timings, ({"errs": errs, "launches": at_shape}, readings, matern32,
                               m32_svgp)


# --------------------------------------------------------------------------- #
# phase 11: the full variational family, the learned constant mean, and the
# collapsed zoo of the other inducing features (points, VFF, B1/B2/B3)
# --------------------------------------------------------------------------- #

FULL_CELLS = 64         # 11a: 64×64 Matérn-1/2 cells, m = 4096 (phase 7's dense-feasible size)
FULL_STEPS = 8          # 11a–11c at batch 4096, the first WARM_STEPS untimed
FULL_FUSED_STEPS = 4    # 11b at batch 16 384
FULL_CUT_N = 512        # 11a: the batch and query points of its CPU references
FULL1D_CELLS = 512      # 11b: the 1-D full family on [0, 1]
POINTS_M = 512          # 11c: learnable inducing points, Matérn-3/2
# 11d: the published widths of zoo.sgpr_specs_2d (vggp_tpu/experiments/zoo.py:99-133)
# on the max_obs of experiments/northsea.py:55
ZOO_POINTS, ZOO_FREQS, ZOO_KNOTS, ZOO_CELLS = 10, 15, 15, 15
ZOO_N = 20_000
ZOO_STEPS = 20
# 11c takes Matérn-3/2's float32 jitter floor (KIND_JITTER_F32) as its spec's
# jitter, so that its float64 reference is the same model (as SLICE_JITTER)
POINTS_JITTER = 1e-4
# gradient floors of phase 11's comparisons: the cell SVGPs as phase 10's;
# the point SVGP (11c) about 5× the largest sound reading, the CPU float32's
# own draw_L error of 1.26e-3 (the card's was 2.82e-3, 2.25× it, on an H100);
# the zoo's collapsed models as the Matérn-3/2 collapsed GP's (TOL_GRAD_SLICE).
# 11c's heads take POINTS_HEAD_FLOOR, about 5× the CPU float32's own
# posterior_grad error (5.2e-4; the card's 1.15e-3). The point SVGP's float32
# is set by the whitening F⁻¹·Kuf of a 512-point Matérn-3/2 Gram at
# ℓ/δ ≈ 500, on any device: with the whitening in float64 its card leaves
# fall 10–50× (draw_L 2.8e-3 → 5.9e-5; tools/torch_points_precision.py, an
# H100; ROADMAP queue 3, item 8).
TOL_GRAD_FULL = {"svgp": 2e-3, "points": 6e-3, "zoo": 1.5e-3}
POINTS_HEAD_FLOOR = 3e-3
LAMBDA_FULL_RATIOS = (0.1, 1.0, 10.0, 50.0)      # ℓ/δ of the new features' λ_min readings
# 11a's elbo_muS takes S = LLᵀ + ELBO_MUS_RIDGE·I at the trained (μ, L): LLᵀ
# alone is singular to working precision (a triangular factor trained by
# Adam: σ_min(L) = 1.7e-13 against σ_max 8.1 at m = 4096 after 8 steps on an
# H100, as 11a prints them), so its float32 Cholesky fails on the CPU; the
# ridge bounds cond(S) by 1e5. The factorization of LLᵀ itself is read, not
# checked.
ELBO_MUS_RIDGE = 1e-3


def make_data_1d(device):
    """11b–11c's data: NUM_DATA points on [0, 1] from a numpy seed, the
    1-D counterpart of :func:`make_data`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    x = rng.random(NUM_DATA)
    y = np.sin(6 * x) + 0.5 * np.cos(17 * x) + 0.1 * rng.standard_normal(NUM_DATA)
    xs = rng.random(SERVE_POINTS)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return as_t(x), as_t(y), as_t(xs)


def check_kernels_at(device, cases, phase: str) -> dict:
    """Both cell kernels against their plain versions at each (m, x, xf) of
    ``cases`` (m uniform cells on [0, 1], the points x) and, where xf is
    given, the fused kernel at (m, len(xf)) (its F⁻¹ the closed form at
    ℓ = 0.27), in float64 (TOL_F64) and float32 (TOL_F32, the fused t at
    TOL_F32_T). Returns the float32 max |kernel − plain| by (kernel, m, n),
    each shape's own."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck
    from vggp_tpu_torch.ops import kms

    errs = {}
    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        tag = "f64" if dtype == torch.float64 else "f32"
        v = torch.tensor(1.3, dtype=dtype, device=device)
        ell = torch.tensor(0.27, dtype=dtype, device=device)
        for m, x, xf in cases:
            mesh = torch.linspace(0.0, 1.0, m + 1, dtype=torch.float64).to(dtype).to(device)
            x = x.to(dtype).contiguous()     # a column of the 2-D data is a strided view
            pairs = [("cell_kuf", "Kuf", ck.cell_kuf(mesh, x, v, ell),
                      ck.cell_kuf_plain(mesh, x, v, ell))]
            pairs += [("cell_kuf_with_dl", name, g, w) for name, g, w in zip(
                ("Kuf", "dKuf"), ck.cell_kuf_with_dl(mesh, x, v, ell),
                ck.cell_kuf_with_dl_plain(mesh, x, v, ell))]
            if xf is not None:
                xf = xf.to(dtype).contiguous()
                finv = kms.m12_cell_inv_chol(m, 1.0 / m, v, ell, 1e-6)
                a, t = ck.fused_banded_whiten_kuf(finv, mesh, xf, v, ell, *MAIN_PRECISIONS)
                a_p, t_p = ck.fused_banded_whiten_kuf_plain(finv, mesh, xf, v, ell,
                                                            *MAIN_PRECISIONS)
                pairs += [("fused_banded_whiten_kuf", "a", a, a_p),
                          ("fused_banded_whiten_kuf", "t", t, t_p)]
            for kernel, name, got, want in pairs:
                n = got.shape[1]
                e = rel_err(got, want)
                bound = TOL_F32_T if tag == "f32" and name == "t" else tol
                print(f"check {kernel} {name} {tag} ({m}, {n}) on phase {phase}'s data: "
                      f"rel {e:.3e}")
                check(e < bound, f"{kernel} {name} {tag} ({m}, {n}) rel {e}")
                if tag == "f32":
                    key = (kernel, m, n)
                    errs[key] = max(errs.get(key, 0.0), float((got - want).abs().max()))
            del pairs
    torch.cuda.synchronize()
    return errs


def check_full_kernels(device, X, x1) -> dict:
    """11: :func:`check_kernels_at` phase 11's shapes on its own data:
    (64, 4096) on the 2-D data's first axis, (512, 4096) on the 1-D data and
    (15, 20 000), an odd cell count, and the fused kernel at (512, 16 384) on
    one axis of the 1-D data."""
    return check_kernels_at(device, ((FULL_CELLS, X[:TRAIN_BATCH, 0], None),
                                     (FULL1D_CELLS, x1[:TRAIN_BATCH], x1[:FUSED_BATCH]),
                                     (ZOO_CELLS, X[:ZOO_N, 0], None)), "11")


def svgp_cut_quantities(spec, params, xb, yb, heads, cast, mu_s=None) -> dict:
    """:func:`svgp_slice_quantities`, and with ``mu_s`` = (μ, S) the value and
    the (μ, S) gradients of ``elbo_muS`` at (xb, yb)."""
    from vggp_tpu_torch import svgp

    out = svgp_slice_quantities(spec, params, xb, yb, heads, cast)
    if mu_s is not None:
        mu, S = (cast(t).requires_grad_() for t in mu_s)
        val = svgp.elbo_muS(spec, cast(params), mu, S, cast(xb), cast(yb))
        val.backward()
        out.update({"elbo_muS": val.detach(), "delbo_muS_mu": mu.grad, "delbo_muS_S": S.grad})
    return out


def full_2d_part(device, X, y, Xs, timings) -> tuple:
    """11a: the 2-D full-family gridded SVGP, 64×64 Matérn-1/2 cells
    (m = 4096) and a learned mean: FULL_STEPS steps at batch 4096
    (cell_kuf_with_dl twice a step at (64, 4096)); the posterior at the 4096
    points cold and from ``precompute`` (cell_kuf twice each), q_v and q_dv
    (axis 0; cell_kuf once at (64, 65)) marginal on the 64×64 cells, p_v_u on
    the cells shifted by half a cell and q_u ((4096)² each), one ``elbo_muS``
    value-and-grad at the trained μ and S = LLᵀ + ELBO_MUS_RIDGE·I
    (cell_kuf_with_dl twice); then the loss, its gradient
    leaves, the heads and elbo_muS at FULL_CUT_N points against the CPU's
    float64. Returns (the launches, (spec, the trained params) for 14d)."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp, train

    own = tuple(CellIntegralFeature.from_lims(FULL_CELLS, 0.0, 1.0) for _ in range(2))
    # p(v | u) on the model's own cells is a cancellation to zero (v is u
    # there); on cells shifted by half a cell it is not, as in phase 7
    h = 0.5 / FULL_CELLS
    shifted = tuple(CellIntegralFeature.from_lims(FULL_CELLS, h, 1.0 + h) for _ in range(2))
    spec = SVGPSpec(kinds=("matern12",) * 2, features=own, num_data=NUM_DATA,
                    variational="full", learn_mean=True)
    model, [(losses, ms, got)] = train_svgp(device, spec, X, y, ((TRAIN_BATCH, FULL_STEPS),), 41)
    m = spec.num_inducing
    # each step: Lᵀa forward, and a·dtᵀ and L·dt backward, (m, m) × (m, batch)
    flops = 3 * 2 * m * m * TRAIN_BATCH
    print(f"11a full 2-D SVGP m={m}: {FULL_STEPS} steps at batch {TRAIN_BATCH}, loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}, {ms:.3f} ms a step (its three "
          f"({m}, {m}) x ({m}, {TRAIN_BATCH}) products need {flops / FP32_FLOPS_PER_S * 1e3:.3f} ms "
          f"at the fp32 peak), launches {got}")
    check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": 2 * FULL_STEPS}, f"11a launches {got}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"11a: the loss did not fall: {losses}")
    timings["full2d_step_ms_batch4096"] = ms
    timings["full2d_step_product_bound_ms"] = flops / FP32_FLOPS_PER_S * 1e3
    launches = dict(got)
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
        state = svgp.precompute(spec, params)
        L = svgp.chol_from_raw(params["q"]["raw_L"])
        S = L @ L.T
        sv = torch.linalg.svdvals(L.double())
        print(f"11a the trained L: sigma max {float(sv[0]):.4g}, min {float(sv[-1]):.4g}; "
              f"the Cholesky of LL^T on the card: float32 info "
              f"{int(torch.linalg.cholesky_ex(S).info)}, float64 info "
              f"{int(torch.linalg.cholesky_ex(S.double()).info)} (0: it factors)")
        timings["full2d_trained_L_sigma"] = [float(sv[0]), float(sv[-1])]
        mu_s = (params["q"]["mu"],
                S + ELBO_MUS_RIDGE * torch.eye(m, dtype=S.dtype, device=S.device))
    grid_heads = [("q_v own cells", lambda s, p, st, c: svgp.q_v(s, p, own), 0),
                  ("q_dv axis 0 own cells", lambda s, p, st, c: svgp.q_dv(s, p, own, 0), 1),
                  ("p_v_u shifted cells", lambda s, p, st, c: svgp.p_v_u(s, p, shifted), 0),
                  ("q_u", lambda s, p, st, c: svgp.q_u(s, p), 0)]
    point_heads = [(f"posterior {n}", lambda s, p, st, c, n=n: svgp.posterior(s, p, c(Xs[:n])), 2)
                   for n in (SERVE_POINTS, FULL_CUT_N)]
    point_heads += [(f"posterior_from_state {n}",
                     lambda s, p, st, c, n=n: svgp.posterior_from_state(s, p, st, c(Xs[:n])), 2)
                    for n in (SERVE_POINTS, FULL_CUT_N)]
    for name, fn, n_launch in point_heads[:1] + point_heads[2:3] + grid_heads:
        _, t, got = run_counted(f"11a {name}", lambda fn=fn: fn(spec, params, state, lambda v: v),
                                n_launch)
        timings[f"full2d_{name.replace(' ', '_')}_ms"] = t
        launches = add_launches(launches, got)
    # elbo_muS value-and-grad at the trained μ and the ridged S, batch 4096
    from vggp_tpu_torch.ops import cell_kuf as ck

    ck.reset_launch_counts()
    p = train.tree_map(lambda v: v.clone().requires_grad_(), params)
    mu, S = (t.clone().requires_grad_() for t in mu_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = svgp.elbo_muS(spec, p, mu, S, X[:TRAIN_BATCH], y[:TRAIN_BATCH])
    val.backward()
    torch.cuda.synchronize()
    timings["full2d_elbo_muS_value_and_grad_ms"] = (time.perf_counter() - t0) * 1e3
    got = cell_launches()
    print(f"11a elbo_muS at batch {TRAIN_BATCH}: {float(val.detach()):.6g}, value and grad "
          f"{timings['full2d_elbo_muS_value_and_grad_ms']:.3f} ms, launches {got}")
    check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": 2}, f"11a elbo_muS launches {got}")
    check(finite((val.detach(), mu.grad, S.grad)), "11a elbo_muS not finite")
    launches = add_launches(launches, got)
    heads = [(name, fn) for name, fn, _ in point_heads[1:2] + point_heads[3:] + grid_heads]
    xb, yb = X[:FULL_CUT_N], y[:FULL_CUT_N]
    timings["check 11a s"] = hold_against_cpu(
        f"11a full 2-D SVGP m={m} vs cpu f64 at {FULL_CUT_N} points",
        lambda c: svgp_cut_quantities(spec, params, xb, yb, heads, c, mu_s), device,
        TOL_GRAD_FULL["svgp"])
    # where the step's time goes: three more steps under the profiler (their
    # launches are not the path's, as phase 16's)
    step = train.make_step_fn(lambda p, xb, yb: svgp.loss(spec, p, xb, yb), model.raw_params(),
                              torch.optim.Adam(model.parameters(), lr=1e-2))
    gen = torch.Generator(device=device)
    gen.manual_seed(42)
    print("11a profile:")
    timings.update({f"full2d_{k}": v for k, v in
                    profile_steps(step, X, y, TRAIN_BATCH, gen).items()})
    return launches, (spec, params)


def full_1d_part(device, x1, y1, xs1, timings) -> dict:
    """11b: the 1-D full-family SVGP, the facade's 1-D default: 512
    Matérn-1/2 cells on [0, 1] and a learned mean, FULL_STEPS steps at batch
    4096 (cell_kuf_with_dl once a step at (512, 4096)), FULL_FUSED_STEPS at
    16 384 (the fused kernel once a step where the band-ratio gate admits ℓ,
    cell_kuf_with_dl where it does not; the gate's readings printed), the
    posterior at 4096 points (cell_kuf once), and the loss, its gradient
    leaves and the posterior against the CPU's float64 at 4096 points, then
    the loss and its leaves at 16 384 (the steps' route) too. Returns the
    launches."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, svgp, train
    from vggp_tpu_torch.models import common

    feat = CellIntegralFeature.from_lims(FULL1D_CELLS, 0.0, 1.0)
    spec = SVGPSpec(kinds=("matern12",), features=(feat,), num_data=NUM_DATA,
                    variational="full", learn_mean=True)
    rel = common.axis_rel_jitter(spec, "matern12", torch.float32, feat)
    X1 = x1[:, None]

    def gate(model):
        with torch.no_grad():
            q = feat.whiten_band_ratio("matern12", model.params()["axes"][0], rel)
        return float(q)

    runs = ((TRAIN_BATCH, FULL_STEPS), (FUSED_BATCH, FULL_FUSED_STEPS))
    readings = []     # the gate after each run: before and after the steps at 16 384
    model, out = train_svgp(device, spec, X1, y1, runs, 51,
                            after_run=lambda mdl: readings.append(gate(mdl)))
    q_before, q_after = readings
    print(f"11b the band-ratio gate (fuse while q < 0.7) at the trained lengthscale: q = "
          f"{q_before:.4f} before the steps at {FUSED_BATCH}, {q_after:.4f} after")
    launches = dict(NO_LAUNCHES)
    for (batch, n_steps), (losses, ms, got) in zip(runs, out):
        print(f"11b full 1-D SVGP m={FULL1D_CELLS}: {n_steps} steps at batch {batch}, loss "
              f"{losses[0]:.6g} -> {losses[-1]:.6g}, {ms:.3f} ms a step, launches {got}")
        check(all(v == v and abs(v) != float("inf") for v in losses), f"11b loss {losses}")
        timings[f"full1d_step_ms_batch{batch}"] = ms
        if batch == TRAIN_BATCH:
            want = {**NO_LAUNCHES, "cell_kuf_with_dl": n_steps}
            check(got == want, f"11b launches at {batch}: {got}")
        elif q_before < 0.7 and q_after < 0.7:
            check(got == {**NO_LAUNCHES, "fused_banded_whiten_kuf": n_steps},
                  f"11b launches at {batch}, the gate admitting ℓ: {got}")
        elif q_before >= 0.7 and q_after >= 0.7:
            check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": n_steps},
                  f"11b launches at {batch}, the gate declining ℓ: {got}")
        else:
            check(got["cell_kuf"] == 0 and got["cell_kuf_with_dl"]
                  + got["fused_banded_whiten_kuf"] == n_steps, f"11b launches at {batch}: {got}")
        launches = add_launches(launches, got)
    check(sum(out[0][0][-3:]) < sum(out[0][0][:3]), f"11b: the loss did not fall: {out[0][0]}")
    timings["full1d_gate_ratio"] = [q_before, q_after]
    _, ms, got = run_counted("11b posterior", lambda: model.posterior(xs1[:, None]), 1)
    timings["full1d_posterior_ms_4096"] = ms
    launches = add_launches(launches, got)
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
    heads = [("posterior", lambda s, p, st, c: svgp.posterior(s, p, c(xs1[:, None])))]
    timings["check 11b s"] = hold_against_cpu(
        "11b full 1-D SVGP vs cpu f64",
        lambda c: svgp_slice_quantities(spec, params, X1[:TRAIN_BATCH], y1[:TRAIN_BATCH],
                                        heads, c), device, TOL_GRAD_FULL["svgp"])
    # the route of the steps at 16 384 end to end: the loss and its leaves at
    # FUSED_BATCH points, one fused launch on the card where the gate admits
    # ℓ (cell_kuf_with_dl where it declines); not the path's launches
    route = "fused_banded_whiten_kuf" if q_after < 0.7 else "cell_kuf_with_dl"
    timings["check 11b fused s"] = hold_against_cpu(
        f"11b full 1-D SVGP at {FUSED_BATCH} points vs cpu f64",
        lambda c: svgp_slice_quantities(spec, params, X1[:FUSED_BATCH], y1[:FUSED_BATCH], [], c),
        device, TOL_GRAD_FULL["svgp"], launches={**NO_LAUNCHES, route: 1})
    return launches


def points_spec():
    """11c's model: POINTS_M learnable Matérn-3/2 inducing points on [0, 1]
    in the full family."""
    import numpy as np

    from vggp_tpu_torch import PointFeature, SVGPSpec

    feat = PointFeature(POINTS_M, np.linspace(0.0, 1.0, POINTS_M))
    return SVGPSpec(kinds=("matern32",), features=(feat,), num_data=NUM_DATA,
                    variational="full", jitter=POINTS_JITTER)


def points_heads(xs) -> list:
    """11c's heads at the points ``xs``, (name, fn(spec, params, state, cast))."""
    from vggp_tpu_torch import svgp

    return [("posterior", lambda s, p, st, c: svgp.posterior(s, p, c(xs))),
            ("posterior_from_state", lambda s, p, st, c: svgp.posterior_from_state(s, p, st, c(xs))),
            ("posterior_grad", lambda s, p, st, c: svgp.posterior_grad(s, p, c(xs), 0)),
            ("posterior_grad_from_state",
             lambda s, p, st, c: svgp.posterior_grad_from_state(s, p, st, c(xs), 0))]


def points_part(device, x1, y1, xs1, timings) -> dict:
    """11c: the 1-D SVGP with POINTS_M learnable inducing points, Matérn-3/2,
    in the full family (the dense factor, differentiated by autograd through
    the Cholesky): FULL_STEPS steps at batch 4096, ``posterior`` and
    ``posterior_grad`` cold and from ``precompute`` at 4096 points, and the
    loss, its gradient leaves (dz among them) and the heads against the CPU's
    float64. No kernel launches. Returns the launches."""
    import torch

    from vggp_tpu_torch import svgp, train

    spec = points_spec()
    feat = spec.features[0]
    X1 = x1[:, None]
    model, [(losses, ms, got)] = train_svgp(device, spec, X1, y1, ((TRAIN_BATCH, FULL_STEPS),),
                                            61)
    print(f"11c point SVGP m={POINTS_M} matern32: {FULL_STEPS} steps at batch {TRAIN_BATCH}, "
          f"loss {losses[0]:.6g} -> {losses[-1]:.6g}, {ms:.3f} ms a step, launches {got}")
    check(got == NO_LAUNCHES, f"11c launches {got}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"11c: the loss did not fall: {losses}")
    timings["points_step_ms_batch4096"] = ms
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
        state = svgp.precompute(spec, params)
        dz = float((params["axes"][0]["z"] - torch.as_tensor(feat.z_init, device=device)).abs().max())
    print(f"11c the points moved by up to {dz:.3e}")
    check(dz > 0, "11c: the inducing points did not move")
    heads = points_heads(xs1[:, None])
    for name, t in timed_heads(heads, spec, params, state, lambda v: v).items():
        timings[f"points_{name}_ms"] = t
    timings["check 11c s"] = hold_against_cpu(
        "11c point SVGP vs cpu f64",
        lambda c: svgp_slice_quantities(spec, params, X1[:TRAIN_BATCH], y1[:TRAIN_BATCH],
                                        heads, c), device, TOL_GRAD_FULL["points"],
        POINTS_HEAD_FLOOR)
    return dict(got)


def zoo_specs():
    """11d: the 2-D collapsed zoo at the published widths of
    ``zoo.sgpr_specs_2d``, Matérn-1/2 (points, VFF, B1, cells), with VFF at
    Matérn-3/2 and 5/2 and the B2 (3/2) and B3 (5/2) spline RKHS features
    beside them at the same widths (m = 15 per axis for the splines)."""
    import numpy as np

    from vggp_tpu_torch import (B1SplineFeature, B2SplineFeature, B3SplineFeature,
                                CellIntegralFeature, FourierFeature, PointFeature, SGPRSpec)

    pad = 0.05
    make = {
        "svgp": ("matern12", lambda: PointFeature(ZOO_POINTS,
                                                  np.linspace(pad, 1.0 - pad, ZOO_POINTS))),
        "vffgp": ("matern12", lambda: FourierFeature(ZOO_FREQS, 0.0, 1.0)),
        "asvgp": ("matern12", lambda: B1SplineFeature(np.linspace(0.0, 1.0, ZOO_KNOTS))),
        "griddedgp": ("matern12", lambda: CellIntegralFeature.from_lims(ZOO_CELLS, 0.0, 1.0)),
        "vffgp matern32": ("matern32", lambda: FourierFeature(ZOO_FREQS, 0.0, 1.0)),
        "vffgp matern52": ("matern52", lambda: FourierFeature(ZOO_FREQS, 0.0, 1.0)),
        "asvgp b2": ("matern32", lambda: B2SplineFeature(ZOO_KNOTS - 2, 0.0, 1.0)),
        "asvgp b3": ("matern52", lambda: B3SplineFeature(ZOO_KNOTS - 3, 0.0, 1.0)),
    }
    # each spec's jitter is its kind's float32 floor (KIND_JITTER_F32), so that
    # the float64 reference is the same model (as SLICE_JITTER in phase 10)
    from vggp_tpu_torch.models.common import KIND_JITTER_F32

    return {name: SGPRSpec(kinds=(kind,) * 2, features=(f(), f()), jitter=KIND_JITTER_F32[kind])
            for name, (kind, f) in make.items()}


def zoo_part(device, X, y, timings) -> dict:
    """11d: each model of :func:`zoo_specs` on the first ZOO_N points:
    ``non_informative_init``, ZOO_STEPS ``train.fit`` steps, then ``q_v`` on
    the 15×15 cells (full_cov), with the launches counted (the GriddedGP's
    cell_kuf_with_dl twice a step at (15, 20 000), cell_kuf twice in q_v;
    none for the other members), and the ELBO, its gradient leaves and q_v
    against the CPU's float64. Returns the launches."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, sgpr, train

    Xn, yn = X[:ZOO_N], y[:ZOO_N]
    grid = tuple(CellIntegralFeature.from_lims(ZOO_CELLS, 0.0, 1.0) for _ in range(2))
    launches = dict(NO_LAUNCHES)
    for name, spec in zoo_specs().items():
        cells = name == "griddedgp"
        params0 = train.non_informative_init(spec.init_params(torch.float32), Xn, yn)
        params, ms, got = fit_counted(f"11d zoo {name} m={spec.num_inducing}",
                                      lambda p, spec=spec: sgpr.loss(spec, p, Xn, yn), params0,
                                      ZOO_STEPS)
        check(got == ({**NO_LAUNCHES, "cell_kuf_with_dl": 2 * ZOO_STEPS} if cells
                      else NO_LAUNCHES), f"11d {name} fit launches {got}")
        launches = add_launches(launches, got)
        timings[f"zoo_{name.replace(' ', '_')}_fit_ms_per_step"] = ms
        qv, ms, got = run_counted(f"11d {name} q_v", lambda spec=spec, params=params: sgpr.q_v(
            spec, params, Xn, yn, grid), 2 if cells else 0)
        check(qv.mean.shape == (ZOO_CELLS ** 2,), f"11d {name} q_v shape {qv.mean.shape}")
        launches = add_launches(launches, got)
        timings[f"zoo_{name.replace(' ', '_')}_q_v_ms"] = ms

        def quantities(cast, spec=spec, params=params):
            p, Xc, yc = cast(params), cast(Xn), cast(yn)
            val, leaves = value_and_grads(lambda q: sgpr.loss(spec, q, Xc, yc), p)
            with torch.no_grad():
                return {"elbo": -val, **leaves, "q_v": sgpr.q_v(spec, p, Xc, yc, grid)}

        timings[f"check 11d {name} s"] = hold_against_cpu(
            f"11d zoo {name} n={ZOO_N} vs cpu f64", quantities, device, TOL_GRAD_FULL["zoo"])
    return launches


def lambda_min_full_readings(device) -> dict:
    """11: λ_min of the jittered float32 Grams of the new features over
    their mean diagonal against float64, at ℓ/δ ∈ LAMBDA_FULL_RATIOS (δ the
    interval width: (b − a)/m), and whether the float32 Cholesky succeeds:
    VFF at every Matérn order, B1, B2 and B3, at m ≈ 512 and at the zoo's
    widths, each at its float32 jitter floor. Readings, not checks: the JAX
    floors are kept."""
    import types

    import numpy as np
    import torch

    from vggp_tpu_torch import (B1SplineFeature, B2SplineFeature, B3SplineFeature,
                                FourierFeature)
    from vggp_tpu_torch.models import common

    spec = types.SimpleNamespace(jitter=1e-6)
    cases = []
    for m_vff, m_spl in ((255, 512), (ZOO_FREQS, ZOO_KNOTS)):
        vff = FourierFeature(m_vff, 0.0, 1.0)
        cases += [(f"vff {k} m={vff.m}", k, vff) for k in ("matern12", "matern32", "matern52")]
        cases += [(f"b1 m={m_spl}", "matern12", B1SplineFeature(np.linspace(0.0, 1.0, m_spl))),
                  (f"b2 m={m_spl}", "matern32", B2SplineFeature(m_spl - 2, 0.0, 1.0)),
                  (f"b3 m={m_spl}", "matern52", B3SplineFeature(m_spl - 3, 0.0, 1.0))]
    out = {}
    for name, kind, feat in cases:
        rel = common.axis_rel_jitter(spec, kind, torch.float32, feat)
        cells = []
        for ratio in LAMBDA_FULL_RATIOS:
            lam, chol_ok = {}, None
            for dtype in (torch.float32, torch.float64):
                var = torch.tensor(1.0, dtype=dtype, device=device)
                ell = torch.tensor(ratio / feat.m, dtype=dtype, device=device)
                k = common._kuu_jittered(feat, kind, rel, ell, var)
                ok = bool(torch.isfinite(k).all())
                lam[dtype] = (float(torch.linalg.eigvalsh(k.double())[0])
                              / float(torch.mean(torch.diagonal(k)))) if ok else float("nan")
                if dtype == torch.float32:
                    chol_ok = ok and int(torch.linalg.cholesky_ex(k).info) == 0
            cells.append({"l_over_delta": ratio, "lambda_min_f32": lam[torch.float32],
                          "lambda_min_f64": lam[torch.float64], "f32_cholesky": chol_ok})
        out[name] = {"rel_jitter": rel, "readings": cells}
        print(f"lambda_min {name} rel jitter {rel:g}: " + "; ".join(
            f"l/d {c['l_over_delta']:g}: f32 {c['lambda_min_f32']:.4e}, "
            f"f64 {c['lambda_min_f64']:.4e}, f32 chol {'ok' if c['f32_cholesky'] else 'FAILS'}"
            for c in cells))
    return out


def full_phase(device, X, y, Xs) -> tuple:
    """Phase 11: 11a–11d and the new features' λ_min readings, with the cell
    kernels held against their plain versions at the phase's shapes first.
    Returns (launches, timings, (the kernels' float32 errors, the λ_min
    readings, 11a's spec and trained params))."""
    timings = {}
    full2d = None
    x1, y1, xs1 = make_data_1d(device)
    errs = check_full_kernels(device, X, x1)
    launches = dict(NO_LAUNCHES)
    for name, part in (("full_2d_part", lambda: full_2d_part(device, X, y, Xs, timings)),
                       ("full_1d_part", lambda: full_1d_part(device, x1, y1, xs1, timings)),
                       ("points_part", lambda: points_part(device, x1, y1, xs1, timings)),
                       ("zoo_part", lambda: zoo_part(device, X, y, timings))):
        t0 = time.perf_counter()
        got = part()
        if name == "full_2d_part":
            got, full2d = got
        launches = add_launches(launches, got)
        timings[f"{name}_s"] = time.perf_counter() - t0
        print(f"{name}: {timings[f'{name}_s']:.1f} s")
    readings = lambda_min_full_readings(device)
    return launches, timings, (errs, readings, full2d)


# --------------------------------------------------------------------------- #
# phase 12: the multi-output ICM models, the sum, additive and free-point
# families and the clamped-eigh Kuu factor
# --------------------------------------------------------------------------- #

ICM_STEPS = 8            # 12a at batch 4096 (the first WARM_STEPS untimed by the profile)
ICM_FUSED_STEPS = 4      # 12a at batch 16 384: cell_kuf as at 4096 (the dense route)
ICM_CELLS = 32           # 12b: api.GP.multioutput's 32×32 cells × 2 outputs (m = 2048)
SUM_CELLS = (16, 60)     # 12b: the coarse and the fine component (m = 256 + 3600)
SUM_ELL = (0.5, 0.1)     # their initial lengthscales; the coarse one frozen
ADD_CELLS = 512          # 12b: the additive model's cells per axis (m = 1024)
ADD_GRID = 64            # its q_v and q_dv grid
FREE_M = 500             # 12b: free points, the top of the reference's nb61 Z sweep
FREE_GRID = 16
FAMILY_STEPS = 10
# the CPU references of 12b take the first FAMILY_CUT_N points (the sum's
# (3856, n) Gram and its gradient in float64 and float32 on the host: the
# card's side of the comparison takes the same points)
FAMILY_CUT_N = 2048
OUTPUT1_NOISE = 0.2      # output 1 = 0.7·f + 0.2 + this × N(0, 1), output 0 phase 1's y
# gradient floors of phase 12's comparisons, as phase 11's: the ICM SVGP as
# the cell SVGPs' (whose float32 whitening it shares, densely); the collapsed
# families as the zoo's, but the additive model's σ² leaves. Its dσ² is the
# difference of n/σ²_noise and Σ a²/σ²_d, each about 2e5 at 2048 points,
# against a net of about 25, so a relative error of 1e-6 in the float32
# whitened blocks a (the closed-form F⁻¹ alone carries a few: TOL_FINV)
# moves it by about 1e-2: float32 put it 1.4e-3 off float64 on an H100, and
# on the CPU 2.7e-4 at the card's fit but 1.3e-2 at the CPU's own fit of the
# same data (tools/torch_family_precision.py --cpu). The 2× rule cannot bind
# a reading that moves 50× with the fit; 5e-2 is about 4× the largest sound
# one, and every model product in TF32 puts it far past that (the same
# tool, on the card). Its dℓ leaves read ≤ 1.5e-4 and keep the zoo's floor.
TOL_GRAD_FAMILY = {"svgp": 2e-3, "collapsed": 1.5e-3,
                   "additive": {"dvariance": 5e-2, "d": 1.5e-3}}

# the float64 and JAX float32 goldens of bench.py:100-127 for the family
# cases of vggp_tpu/utils/smoke_cases.py (copied: the port imports nothing of
# the JAX package); the streaming row waits for its module, and the CG row
# stands apart (_GOLD_CG)
_GOLD_FAMILIES_F32 = {
    "coregion_elbo": -47.59423828125,
    "coregion_qv_mean_sum": 0.427493691444397,
    "coregion_qv_var_sum": 0.0009293855400756001,
    "sum_elbo": -72.27989196777344,
    "sum_post_mean_sum": 3.5802884101867676,
    "sum_post_var_sum": 1.1309404373168945,
    "additive_elbo": 6.7396087646484375,
    "additive_qv_mean_sum": 0.22462376952171326,
    "additive_qv_var_sum": 7.233110954985023e-05,
}
_GOLD_FAMILIES_F64 = {
    "coregion_elbo": -47.485966495554294,
    "coregion_qv_mean_sum": 0.42749339860245494,
    "coregion_qv_var_sum": 0.0009221060452785777,
    "sum_elbo": -71.9237328187921,
    "sum_post_mean_sum": 3.5802466770672665,
    "sum_post_var_sum": 1.1262581291762208,
    "additive_elbo": 7.18648170901443,
    "additive_qv_mean_sum": 0.22462068888565817,
    "additive_qv_var_sum": 6.899560071360089e-05,
}


def family_inputs(dtype, device):
    """The inputs of ``smoke_cases.family_inputs`` (``vggp_tpu/utils/
    smoke_cases.py:24-36``), from the same numpy generator: (X_mo, y_mo) of
    the coregion case, (X2, y2) of the sum and additive cases."""
    import numpy as np
    import torch

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(42)
    n = 96
    x = np.sort(rng.uniform(0.0, 1.0, n))
    task = rng.integers(0, 2, n)
    f0 = np.sin(5.0 * x)
    y = np.where(task == 0, f0, 0.7 * f0 + 0.2) + 0.05 * rng.standard_normal(n)
    X2 = rng.random((80, 2)).astype(np_dtype)
    y2 = np.sin(4 * X2[:, 0]) * X2[:, 1] + 0.05 * rng.standard_normal(80)
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np_dtype), device=device)
    return as_t(np.stack([x, task.astype(np.float64)], 1)), as_t(y), as_t(X2), as_t(y2)


def family_specs():
    """``smoke_cases.family_specs`` (``:39-57``): the ICM collapsed GP on 12
    Matérn-1/2 cells × 2 outputs, the sum of a Matérn-3/2 and a Matérn-1/2
    component on 10×9 cells, the additive Matérn-3/2 model on them."""
    from vggp_tpu_torch import (AdditiveSGPRSpec, CellIntegralFeature, OutputFeature,
                                SGPRSpec, SumSGPRSpec)

    feat, out = CellIntegralFeature.from_lims(12, 0.0, 1.0), OutputFeature(n_outputs=2)
    feats2 = (CellIntegralFeature.from_lims(10, 0.0, 1.0),
              CellIntegralFeature.from_lims(9, 0.0, 1.0))
    spec_mo = SGPRSpec(kinds=("matern12", "coregion"), features=(feat, out))
    spec_sum = SumSGPRSpec(components=(SGPRSpec(kinds=("matern32",) * 2, features=feats2),
                                       SGPRSpec(kinds=("matern12",) * 2, features=feats2)))
    spec_add = AdditiveSGPRSpec(kinds=("matern32",) * 2, features=feats2)
    return spec_mo, spec_sum, spec_add, (feat, out), feats2


def family_params(spec_mo, dtype, device):
    """``smoke_cases.family_params`` (``:60-80``) of the three cases."""
    import torch

    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    p_mo = spec_mo.init_params(dtype, device)
    p_mo = {**p_mo, "axes": ({"variance": t(0.9), "lengthscale": t(0.22)}, p_mo["axes"][1]),
            "noise": t(0.02)}
    hyp = lambda v, ell: {"variance": t(v), "lengthscale": t(ell)}
    p_sum = {"components": ({"axes": (hyp(0.8, 0.35), hyp(0.8, 0.35))},
                            {"axes": (hyp(0.4, 0.12), hyp(0.4, 0.12))}),
             "noise": t(0.03)}
    p_add = {"axes": (hyp(0.8, 0.35), hyp(0.8, 0.35)), "noise": t(0.03)}
    return p_mo, p_sum, p_add


def cg_case(dtype, device):
    """``smoke_cases.cg_case`` (``:83-106``): the matrix-free q_v mean of a
    1-D collapsed GP on 16 384 Matérn-1/2 cells (ℓ = 0.25, so ℓ/δ = 4096)
    from 256 points, on a 20-cell grid, at ``maxiter=600``. Returns
    (spec, params, x, y, grid)."""
    import numpy as np
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec

    rng = np.random.default_rng(14)
    x = np.sort(rng.uniform(size=256))
    y = np.sin(7 * x) + 0.05 * rng.standard_normal(256)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    spec = SGPRSpec(kinds=("matern12",), features=(CellIntegralFeature.from_lims(16384, 0.0, 1.0),))
    params = {"axes": ({"variance": as_t(1.0), "lengthscale": as_t(0.25)},), "noise": as_t(0.05)}
    return spec, params, as_t(x), as_t(y), (CellIntegralFeature.from_lims(20, 0.0, 1.0),)


CG_CASE_MAXITER = 600
# the CG row of bench.py:112 and :126 (copied), Σ|E_q[v]| of cg_case. Its
# float64 golden predates the KMS preconditioners: it is a Jacobi iterate
# at maxiter 600 far from convergence (relative residual about 1e-6), where
# the iterates of two implementations part at 1e-5, and the JAX package
# itself now gives CG_F64_JAX on the CPU, 4.3e-5 from it. CG_F64_JAX is that
# value (copied; tests/test_torch_iterative.py holds the copy against the
# JAX package's live value): the float64 solve converges there in 6
# KMS-Woodbury iterations, to a relative residual of 4e-9. In float32 u =
# δ/ℓ = 2.4e-4 lies below the u floor (1.7e-3), so Jacobi PCG runs all 600
# iterations; the float32 golden is held at bench.py's 5e-3.
_GOLD_CG_F32 = 0.6034155488014221
_GOLD_CG_F64 = 0.6034675343733363
CG_F64_JAX = 0.6034935560228916
TOL_CG_F32 = 5e-3
TOL_CG_F64 = 1e-9


def cg_value(dtype, device):
    """Σ|E_q[v]| of :func:`cg_case` in ``dtype`` on ``device`` (bench.py's
    CG row), and the solve's info (iterations, relative residual,
    preconditioner)."""
    from vggp_tpu_torch import iterative

    spec, p, x, y, grid = cg_case(dtype, device)
    w, info = iterative.solve_w(spec, p, x, y, maxiter=CG_CASE_MAXITER, return_info=True)
    return float(iterative.q_v_mean_from_w(spec, p, grid, w).abs().sum()), info


def family_values(dtype, device) -> dict:
    """The rows of ``smoke_cases.family_values`` (``:167-194``) that the port
    serves, in ``dtype`` on ``device``: each case's ELBO, and the sums of the
    mean and variance of the coregion q_v, the sum's posterior at 16 points
    and the additive q_v."""
    import torch

    from vggp_tpu_torch import additive, sgpr, sum as msum

    X_mo, y_mo, X2, y2 = family_inputs(dtype, device)
    spec_mo, spec_sum, spec_add, grid_mo, feats2 = family_specs()
    p_mo, p_sum, p_add = family_params(spec_mo, dtype, device)
    with torch.no_grad():
        qv_mo = sgpr.q_v(spec_mo, p_mo, X_mo, y_mo, grid_mo, full_cov=False)
        g_sum = msum.posterior(spec_sum, p_sum, X2, y2, X2[:16], full_cov=False)
        qv_ad = additive.q_v(spec_add, p_add, X2, y2, feats2, full_cov=False)
        vals = {"coregion_elbo": sgpr.elbo(spec_mo, p_mo, X_mo, y_mo),
                "coregion_qv_mean_sum": qv_mo.mean.sum(), "coregion_qv_var_sum": qv_mo.var.sum(),
                "sum_elbo": msum.elbo(spec_sum, p_sum, X2, y2),
                "sum_post_mean_sum": g_sum.mean.sum(), "sum_post_var_sum": g_sum.var.sum(),
                "additive_elbo": additive.elbo(spec_add, p_add, X2, y2),
                "additive_qv_mean_sum": qv_ad.mean.sum(), "additive_qv_var_sum": qv_ad.var.sum()}
    return {k: float(v) for k, v in vals.items()}


def family_goldens_part(device, timings) -> None:
    """12d: the family cases in float32 on the card against the float64
    goldens, each within the larger of its floor (TOL_E2E_LOSS for an ELBO,
    TOL_E2E_POST for a sum) and CPU_ERR_RATIO × the port's own float32 error
    on the CPU; the distance from JAX's CPU float32 golden is printed beside
    it (the port accumulates the collapsed Gram in float64, so its float32
    need not sit on JAX's)."""
    import torch

    t0 = time.perf_counter()
    card = family_values(torch.float32, device)
    cpu = family_values(torch.float32, torch.device("cpu"))
    for name, gold in _GOLD_FAMILIES_F64.items():
        e = abs(card[name] - gold) / abs(gold)
        e32 = abs(cpu[name] - gold) / abs(gold)
        tol = max(TOL_E2E_LOSS if name.endswith("elbo") else TOL_E2E_POST, CPU_ERR_RATIO * e32)
        jax32 = abs(card[name] - _GOLD_FAMILIES_F32[name]) / abs(_GOLD_FAMILIES_F32[name])
        print(f"check 12d {name}: card f32 {card[name]:.9g}, rel {e:.3e} from the f64 golden "
              f"(cpu f32 {e32:.3e}, tol {tol:.3e}); {jax32:.3e} from JAX's cpu f32 golden")
        check(e <= tol, f"12d {name}: card f32 {e} > {tol}")
    timings["family_goldens_s"] = time.perf_counter() - t0


def make_data_multioutput(device):
    """12's two-output data: phase 1's points and field (the same numpy
    generator as :func:`make_data`), each point given an output index from a
    second generator; output 0 is phase 1's y, output 1 is 0.7·f + 0.2 with
    its own noise level (OUTPUT1_NOISE), as ``smoke_cases.family_inputs``
    and ``experiments/multioutput.py`` build it. The output index is X's
    last column; the query points get indices too."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    X = rng.random((NUM_DATA, 2))
    f = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1])
    y0 = f + 0.1 * rng.standard_normal(NUM_DATA)
    Xs = rng.random((SERVE_POINTS, 2))
    rng2 = np.random.default_rng(12)
    task = rng2.integers(0, 2, NUM_DATA)
    y = np.where(task == 0, y0, 0.7 * f + 0.2 + OUTPUT1_NOISE * rng2.standard_normal(NUM_DATA))
    ts = rng2.integers(0, 2, SERVE_POINTS)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return (as_t(np.column_stack([X, task])), as_t(y), as_t(np.column_stack([Xs, ts])))


def check_family_kernels(device, X) -> dict:
    """12: :func:`check_kernels_at` phase 12's shapes on its data: (512,
    16 384), the ICM SVGP's steps at 16 384, the collapsed families'
    (32, 65 536), (16, 65 536), (60, 65 536) and the additive model's
    (512, 65 536), the fused kernel there too; and CellKufOp's backward (dσ²,
    dℓ, the first training of a cell model through it) at (512, 4096)
    against the plain version's autograd on the card (TOL_F32) and CellKufOp
    on the CPU in float64 (TOL_E2E_POST). Returns the float32 max
    |kernel − plain| by (kernel, m, n)."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    shapes = ((M_AXIS, FUSED_BATCH), (ICM_CELLS, SGPR_N), (SUM_CELLS[0], SGPR_N),
              (SUM_CELLS[1], SGPR_N), (ADD_CELLS, SGPR_N))
    errs = check_kernels_at(device, [(m, X[:n, 0], X[:n, 0] if m == ADD_CELLS else None)
                                     for m, n in shapes], "12")

    # CellKufOp's backward: the cotangent a random (m, n) field
    def backward(op, dev, dtype):
        mesh = torch.linspace(0.0, 1.0, M_AXIS + 1, dtype=torch.float64).to(dtype).to(dev)
        x = X[:TRAIN_BATCH, 0].to(dtype).to(dev).contiguous()
        v = torch.tensor(1.3, dtype=dtype, device=dev, requires_grad=True)
        ell = torch.tensor(0.27, dtype=dtype, device=dev, requires_grad=True)
        gen = torch.Generator().manual_seed(5)
        g = torch.randn((M_AXIS, TRAIN_BATCH), generator=gen, dtype=torch.float64).to(dtype).to(dev)
        torch.autograd.backward(op(mesh, x, v, ell), g)
        return torch.stack([v.grad, ell.grad]).double().cpu()

    ck.reset_launch_counts()
    got = backward(ck.cell_kuf_op, device, torch.float32)
    check(cell_launches() == {**NO_LAUNCHES, "cell_kuf": 1},
          f"CellKufOp forward launches {cell_launches()}")
    plain = backward(ck.cell_kuf_plain, device, torch.float32)
    ref = backward(ck.cell_kuf_op, torch.device("cpu"), torch.float64)
    for what, want, bound in (("plain autograd f32 on the card", plain, TOL_F32),
                              ("CellKufOp f64 on the cpu", ref, TOL_E2E_POST)):
        e = float(((got - want).abs() / want.abs()).max())
        print(f"check CellKufOp backward (dσ², dℓ) f32 ({M_AXIS}, {TRAIN_BATCH}) vs {what}: "
              f"rel {e:.3e}")
        check(e < bound, f"CellKufOp backward vs {what}: rel {e}")
    errs[("cell_kuf_op_backward", M_AXIS, TRAIN_BATCH)] = float((got - ref).abs().max())
    torch.cuda.synchronize()
    return errs


def icm_svgp_spec():
    """12a: what ``api.SVGP.multioutput`` builds at the main path's width:
    512×512 Matérn-1/2 cells on the bench's square and 2 outputs, the
    Kronecker family, a noise level and a mean per output."""
    from vggp_tpu_torch import CellIntegralFeature, OutputFeature, SVGPSpec

    return SVGPSpec(kinds=("matern12", "matern12", "coregion"),
                    features=(CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0),
                              CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0),
                              OutputFeature(n_outputs=2)),
                    num_data=NUM_DATA, variational="kron", per_output_noise=True,
                    learn_mean=True)


def icm_svgp_part(device, Xm, ym, Xsm, timings) -> dict:
    """12a: the ICM SVGP: ICM_STEPS steps of ``train.fit_minibatch`` at
    batch 4096, then ICM_FUSED_STEPS at 16 384 from where they ended (each
    call its own Adam, lr 1e-2; the coregion axis's W and κ send every axis
    through the dense Kuu factor: ``cell_kuf`` through CellKufOp, twice a
    step, its backward plain torch; no other kernel), three profiled steps
    at 4096 (the step time and the device's busy share), the ``SVGP`` module
    of the trained parameters, its posterior at the 4096 points cold and
    from ``precompute`` (cell_kuf twice each), q_v marginal on the 512²×2
    cells (no launch), the learned B; ``posterior_grad`` raises as the JAX
    package's does. Then the loss, its gradient leaves (W, κ and the
    per-output noise and mean among them) and the heads against the CPU's
    float64 at 4096 points. Returns the launches."""
    import torch

    from vggp_tpu_torch import kernels, svgp, train
    from vggp_tpu_torch.models.svgp import SVGP
    from vggp_tpu_torch.ops import cell_kuf as ck

    spec = icm_svgp_spec()
    loss = lambda p, xb, yb: svgp.loss(spec, p, xb, yb)
    params = spec.init_params()
    launches = dict(NO_LAUNCHES)
    for k, (batch, n_steps) in enumerate(((TRAIN_BATCH, ICM_STEPS),
                                          (FUSED_BATCH, ICM_FUSED_STEPS))):
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, hist = train.fit_minibatch(loss, params, Xm, ym, n_steps, batch,
                                           learning_rate=1e-2, seed=61 + k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        got = cell_launches()
        losses = [float(v) for v in hist["loss"]]
        print(f"12a ICM SVGP: {n_steps} steps at batch {batch}, loss {losses[0]:.6g} -> "
              f"{losses[-1]:.6g}, {ms:.3f} ms a step, launches {got}")
        check(all(v == v and abs(v) != float("inf") for v in losses), f"12a loss {losses}")
        check(got == {**NO_LAUNCHES, "cell_kuf": 2 * n_steps},
              f"12a launches at batch {batch}: {got}")
        if batch == TRAIN_BATCH:
            check(sum(losses[-3:]) < sum(losses[:3]), f"12a: the loss did not fall: {losses}")
        timings.setdefault("family_fit_launches", {})[f"icm_svgp_{batch}"] = got
        timings[f"icm_svgp_fit_ms_per_step_batch{batch}"] = ms
        launches = add_launches(launches, got)

    raw = train.raw_leaves_from(params)
    step = train.make_step_fn(loss, raw, torch.optim.Adam(train.tree_leaves(raw), lr=1e-2))
    gen = torch.Generator(device=device)
    gen.manual_seed(63)
    for k, v in profile_steps(step, Xm, ym, TRAIN_BATCH, gen).items():
        timings[f"icm_svgp_{k}"] = v

    model = SVGP(spec, params)
    check(set(model.axes[2].keys()) == {"w", "kappa"} and model.noise.shape == (2,)
          and model.mean.shape == (2,), "12a: the module's coregion, noise and mean leaves")
    post, ms, got = run_counted("12a posterior", lambda: model.posterior(Xsm), 2)
    timings["icm_svgp_posterior_ms_4096"] = ms
    launches = add_launches(launches, got)
    with torch.no_grad():
        state = svgp.precompute(spec, params)
    _, ms, got = run_counted("12a posterior_from_state",
                             lambda: svgp.posterior_from_state(spec, params, state, Xsm), 2)
    timings["icm_svgp_posterior_from_state_ms_4096"] = ms
    launches = add_launches(launches, got)
    qv, ms, got = run_counted("12a q_v", lambda: model.q_v(), 0)
    timings["icm_svgp_q_v_ms"] = ms
    check(qv.mean.shape == (2 * M_AXIS ** 2,), f"12a q_v shape {tuple(qv.mean.shape)}")
    B = kernels.coregion_b(params["axes"][2]).double().cpu()
    corr = float(B[0, 1] / (B[0, 0] * B[1, 1]).sqrt())
    print(f"12a posterior {SERVE_POINTS} points {timings['icm_svgp_posterior_ms_4096']:.3f} ms, "
          f"warm {timings['icm_svgp_posterior_from_state_ms_4096']:.3f} ms, q_v on "
          f"{M_AXIS}²×2 cells {timings['icm_svgp_q_v_ms']:.3f} ms; learned B = "
          f"{B.numpy().round(5).tolist()} (correlation {corr:.4f}), noise "
          f"{params['noise'].cpu().numpy().round(5).tolist()}, mean "
          f"{params['mean'].cpu().numpy().round(5).tolist()}")
    try:
        svgp.posterior_grad(spec, params, Xsm[:8], 2)
    except ValueError as err:
        print(f"12a posterior_grad on the coregion axis raises ValueError, as JAX's: {err}")
    else:
        check(False, "12a posterior_grad on the coregion axis did not raise")
    heads = [("posterior", lambda s, p, st, c: svgp.posterior(s, p, c(Xsm))),
             ("q_v", lambda s, p, st, c: svgp.q_v_from_state(s, p, st, s.features))]
    timings["check 12a s"] = hold_against_cpu(
        "12a ICM SVGP vs cpu f64",
        lambda c: svgp_slice_quantities(spec, params, Xm[:TRAIN_BATCH], ym[:TRAIN_BATCH], heads,
                                        c), device, TOL_GRAD_FAMILY["svgp"])
    return launches


def collapsed_family_specs():
    """12b's models: (name, spec, module of the model functions, the
    launches of one training step, its trainable mask or None)."""
    from vggp_tpu_torch import (AdditiveSGPRSpec, CellIntegralFeature, FreeSVGPSpec,
                                OutputFeature, SGPRSpec, SumSGPRSpec, additive, freesvgp,
                                sgpr, sum as msum)

    cells = lambda m: tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for _ in range(2))
    icm = SGPRSpec(kinds=("matern12", "matern12", "coregion"),
                   features=cells(ICM_CELLS) + (OutputFeature(n_outputs=2),), learn_mean=True)
    ssum = SumSGPRSpec(components=tuple(SGPRSpec(kinds=("matern12",) * 2, features=cells(m))
                                        for m in SUM_CELLS))
    add = AdditiveSGPRSpec(kinds=("matern12",) * 2, features=cells(ADD_CELLS))
    free = FreeSVGPSpec(kinds=("matern12",) * 2, m=FREE_M)
    return (("icm", icm, sgpr), ("sum", ssum, msum), ("additive", add, additive),
            ("free", free, freesvgp))


def family_init(name, spec, X, y):
    """``non_informative_init`` of each model; the sum's components start at
    SUM_ELL (the fine one at a tenth of the variance) and the coarse
    lengthscale is frozen (``train.fit(trainable=…)``, as
    ``experiments/multiscale.py``): free lengthscales on both leave the split
    of the signal between the scales unidentifiable. Returns (params,
    trainable or None)."""
    import torch

    from vggp_tpu_torch import train

    params = train.non_informative_init(spec.init_params(torch.float32), X, y)
    if name != "sum":
        return params, None
    comps = []
    for q, (cp, ell) in enumerate(zip(params["components"], SUM_ELL)):
        scale = 1.0 if q == 0 else 0.1
        comps.append({"axes": tuple({"variance": ax["variance"] * scale,
                                     "lengthscale": torch.full_like(ax["lengthscale"], ell)}
                                    for ax in cp["axes"])})
    params = {**params, "components": tuple(comps)}
    mask = train.tree_map(lambda _: True, params)
    mask["components"] = ({"axes": tuple({"variance": True, "lengthscale": False}
                                         for _ in comps[0]["axes"])},) + mask["components"][1:]
    return params, lambda _: mask


def family_heads(name, spec, mod, Xs, Xsm):
    """12b's heads of each model: (name, fn(params, X, y, cast), cell_kuf
    launches of one call on the card)."""
    from vggp_tpu_torch import CellIntegralFeature, OutputFeature

    if name == "icm":
        grid = spec.features
        return (("posterior", lambda p, X, y, c: mod.posterior(spec, p, X, y, c(Xsm),
                                                               full_cov=False), 4),
                ("q_v", lambda p, X, y, c: mod.q_v(spec, p, X, y, grid, full_cov=False), 2))
    if name == "sum":
        def comp(q):
            return lambda p, X, y, c: mod.component_posterior(
                spec, p, mod.precompute(spec, p, X, y), c(Xs), q)
        return (("posterior", lambda p, X, y, c: mod.posterior(spec, p, X, y, c(Xs)), 8),
                ("component_posterior 0", comp(0), 6), ("component_posterior 1", comp(1), 6))
    if name == "additive":
        grid = tuple(CellIntegralFeature.from_lims(ADD_GRID, 0.0, 1.0) for _ in range(2))
        return (("q_v", lambda p, X, y, c: mod.q_v(spec, p, X, y, grid), 2),
                ("q_dv axis 0", lambda p, X, y, c: mod.q_dv(spec, p, X, y, grid, 0), 3))
    grid = tuple(CellIntegralFeature.from_lims(FREE_GRID, 0.0, 1.0) for _ in range(2))
    return (("posterior", lambda p, X, y, c: mod.posterior(spec, p, X, y, c(Xs)), 0),
            ("q_v", lambda p, X, y, c: mod.q_v(spec, p, X, y, grid), 0))


def additive_gate(spec, params) -> list:
    """The band-ratio gate's reading (fuse while q < 0.7) on each axis of
    the additive model at ``params``."""
    import torch

    from vggp_tpu_torch.models import common

    with torch.no_grad():
        return [float(f.whiten_band_ratio(k, p, common.axis_rel_jitter(spec, k, torch.float32, f)))
                for k, f, p in zip(spec.kinds, spec.features, params["axes"])]


def collapsed_families_part(device, X, y, Xs, Xm, ym, Xsm, timings, fitted) -> dict:
    """12b: the ICM collapsed GP (cells × 2 outputs, a mean per output), the
    multi-scale sum, the additive model and the free-point model on the first
    SGPR_N points: ``non_informative_init`` and FAMILY_STEPS ``train.fit``
    steps each, launches counted exactly (cell_kuf twice a step in the ICM
    GP and four times in the sum, through CellKufOp; the additive model's
    two axes through the fused kernel where the band-ratio gate admits ℓ,
    ``cell_kuf_with_dl`` where it declines, its readings printed; nothing
    for the free points); each model's heads (:func:`family_heads`) with
    their launches; then the ELBO, its gradient leaves and the heads on
    FAMILY_CUT_N points against the CPU's float64. Returns the launches;
    ``fitted`` gets each model's (spec, trained params, X, y)."""
    import torch

    from vggp_tpu_torch import train

    launches = dict(NO_LAUNCHES)
    for name, spec, mod in collapsed_family_specs():
        Xd, yd = (Xm, ym) if name == "icm" else (X, y)
        Xn, yn = Xd[:SGPR_N], yd[:SGPR_N]
        params0, trainable = family_init(name, spec, Xn, yn)
        if name == "additive":
            gate0 = additive_gate(spec, params0)
        params, ms, got = fit_counted(f"12b {name} m={spec.num_inducing} n={SGPR_N}",
                                      lambda p, spec=spec, mod=mod: mod.loss(spec, p, Xn, yn),
                                      params0, FAMILY_STEPS, trainable)
        n = FAMILY_STEPS
        if name == "icm":
            want = {**NO_LAUNCHES, "cell_kuf": 2 * n}
        elif name == "sum":
            want = {**NO_LAUNCHES, "cell_kuf": 4 * n}
            start = train.constrain(train.unconstrain(params0))["components"][0]["axes"]
            frozen = [float(ax["lengthscale"]) for ax in params["components"][0]["axes"]]
            check(frozen == [float(ax["lengthscale"]) for ax in start],
                  f"12b sum: the frozen lengthscales moved: {frozen}")
        elif name == "free":
            want = dict(NO_LAUNCHES)
        else:
            gate1 = additive_gate(spec, params)
            print(f"12b additive: the band-ratio gate (fuse while q < 0.7) per axis: "
                  f"{gate0} before the fit, {gate1} after")
            timings["additive_gate_ratio"] = [gate0, gate1]
            if max(gate0 + gate1) < 0.7:
                want = {**NO_LAUNCHES, "fused_banded_whiten_kuf": 2 * n}
            elif min(gate0 + gate1) >= 0.7:
                want = {**NO_LAUNCHES, "cell_kuf_with_dl": 2 * n}
            else:
                want = {**NO_LAUNCHES, "cell_kuf_with_dl": got["cell_kuf_with_dl"],
                        "fused_banded_whiten_kuf": 2 * n - got["cell_kuf_with_dl"]}
        check(got == want, f"12b {name} fit launches {got}, expected {want}")
        fitted[name] = (spec, params, Xn, yn)
        timings.setdefault("family_fit_launches", {})[name] = got
        launches = add_launches(launches, got)
        timings[f"family_{name}_fit_ms_per_step"] = ms
        if name == "sum":
            hist_p = params["components"][1]["axes"]
            print(f"12b sum: the fine component's lengthscales "
                  f"{[round(float(ax['lengthscale']), 5) for ax in hist_p]}")
        if name == "additive":
            try:
                mod.posterior_grad(spec, params, Xn, yn, Xs[:8], 0)
            except ValueError as err:
                print(f"12b additive posterior_grad on Matérn-1/2 raises ValueError, as JAX's: "
                      f"{err}")
            else:
                check(False, "12b additive posterior_grad on Matérn-1/2 did not raise")
        heads = family_heads(name, spec, mod, Xs, Xsm)
        ident = cast_to(device, torch.float32)
        for hname, fn, n_launch in heads:
            out, ms, got = run_counted(f"12b {name} {hname}",
                                       lambda fn=fn: fn(params, Xn, yn, ident), n_launch)
            launches = add_launches(launches, got)
            timings[f"family_{name}_{hname.replace(' ', '_')}_ms"] = ms
            print(f"12b {name} {hname}: {ms:.3f} ms, cell_kuf {n_launch} a call")

        def quantities(cast, spec=spec, mod=mod, params=params, heads=heads, Xd=Xd, yd=yd):
            p, Xc, yc = cast(params), cast(Xd[:FAMILY_CUT_N]), cast(yd[:FAMILY_CUT_N])
            val, leaves = value_and_grads(lambda q: mod.loss(spec, q, Xc, yc), p)
            with torch.no_grad():
                return {"elbo": -val, **leaves,
                        **{h: fn(p, Xc, yc, cast) for h, fn, _ in heads}}

        timings[f"check 12b {name} s"] = hold_against_cpu(
            f"12b {name} n={FAMILY_CUT_N} vs cpu f64", quantities, device,
            TOL_GRAD_FAMILY.get(name, TOL_GRAD_FAMILY["collapsed"]))
    return launches


def eigh_part(device, X, y, Xs, collapsed, timings) -> dict:
    """12c: phase 7's trained collapsed GriddedGP (64×64 cells, SGPR_N points)
    with ``factor_method="eigh"``: the posterior at the 4096 points (cell_kuf
    four times: the state at (64, 65 536), the query at (64, 4096)) and q_v
    on the 64×64 cells (twice), each held against the Cholesky heads of the
    same model on the card (TOL_E2E_POST, beside the CPU float32's distance
    between the two at SGPR_CUT_N points) and, at SGPR_CUT_N points, against
    the CPU's float64 eigh heads by the phases' rule. Returns the
    launches."""
    import dataclasses

    import torch

    from vggp_tpu_torch import sgpr

    spec, params = collapsed
    espec = dataclasses.replace(spec, factor_method="eigh")
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    heads = (("posterior", lambda s, p, X, y, c: sgpr.posterior(s, p, X, y, c(Xs), full_cov=False),
              4),
             ("q_v", lambda s, p, X, y, c: sgpr.q_v(s, p, X, y, s.features, full_cov=False), 2))
    launches = dict(NO_LAUNCHES)
    ident = cast_to(device, torch.float32)
    cpu32 = cast_to(torch.device("cpu"), torch.float32)
    for name, fn, n_launch in heads:
        got_e, ms, got = run_counted(f"12c eigh {name}", lambda fn=fn: fn(espec, params, Xn, yn,
                                                                          ident), n_launch)
        launches = add_launches(launches, got)
        timings[f"eigh_{name}_ms"] = ms
        with torch.no_grad():
            got_c = fn(spec, params, Xn, yn, ident)
            Xc, yc = cpu32(X[:SGPR_CUT_N]), cpu32(y[:SGPR_CUT_N])
            e32 = quantity_err(fn(espec, cpu32(params), Xc, yc, cpu32),
                               fn(spec, cpu32(params), Xc, yc, cpu32))
        e = quantity_err(got_e, got_c)
        tol = max(TOL_E2E_POST, CPU_ERR_RATIO * e32)
        print(f"check 12c eigh {name} vs the Cholesky head on the card (n = {SGPR_N}): {e:.3e} "
              f"(cpu f32 at n = {SGPR_CUT_N}: {e32:.3e}), tol {tol:.3e}; {ms:.3f} ms")
        check(e <= tol, f"12c eigh {name} vs Cholesky: {e} > {tol}")

    def quantities(cast):
        p, Xc, yc = cast(params), cast(X[:SGPR_CUT_N]), cast(y[:SGPR_CUT_N])
        with torch.no_grad():
            return {name: fn(espec, p, Xc, yc, cast) for name, fn, _ in heads}

    timings["check 12c s"] = hold_against_cpu(f"12c eigh n={SGPR_CUT_N} vs cpu f64", quantities,
                                              device, TOL_GRAD["collapsed cut n"])
    return launches


def families_phase(device, X, y, Xs, collapsed) -> tuple:
    """Phase 12: the multi-output ICM models, the sum, additive and
    free-point families and the clamped-eigh factor (12a–12d), with the cell
    kernels held against their plain versions at the phase's shapes first.
    Returns (launches, timings, the kernels' float32 errors, 12b's fitted
    models by name)."""
    timings = {}
    errs = check_family_kernels(device, X)
    Xm, ym, Xsm = make_data_multioutput(device)
    launches = dict(NO_LAUNCHES)
    fitted = {}
    for name, part in (
            ("icm_svgp_part", lambda: icm_svgp_part(device, Xm, ym, Xsm, timings)),
            ("collapsed_families_part", lambda: collapsed_families_part(
                device, X, y, Xs, Xm, ym, Xsm, timings, fitted)),
            ("eigh_part", lambda: eigh_part(device, X, y, Xs, collapsed, timings)),
            ("family_goldens_part", lambda: family_goldens_part(device, timings) or NO_LAUNCHES)):
        t0 = time.perf_counter()
        launches = add_launches(launches, part())
        timings[f"{name}_s"] = time.perf_counter() - t0
        print(f"{name}: {timings[f'{name}_s']:.1f} s")
    return launches, timings, errs, fitted


# --------------------------------------------------------------------------- #
# phase 13: the matrix-free path (CG and PCG solves, the KMS preconditioners,
# the FFT Toeplitz matvec, models/iterative.py and the prior-path layer)
# --------------------------------------------------------------------------- #

# 13a: the first MF_N of the main path's points (cut from NUM_DATA: the
# card's float64 solves at 512² have to fit the call), solved at
# iterative's default maxiter (the product's call) in both precisions, and
# once more in float64 at MF_LONG_MAXITER as the reference
MF_N = 65_536
MF_MAXITER = 1000
MF_LONG_MAXITER = 4000
MF_PROFILE_ITERS = 64
# At 13a's model Jacobi CG stops at MF_MAXITER far from convergence, and the
# CPU can run neither the solve at its size nor, at a cut n, one that
# converges at its rate. So 13a holds two things apart: each head's own
# float32 error from one w (the float64 solve at MF_LONG_MAXITER) at full
# size by the 2× rule against the CPU's float32 of the same head, and the
# float32 solve's true relative residual, recomputed in float64, within
# TOL_MF_RESID (4.8e-4 after MF_MAXITER iterations, float64's 1.5e-4, on an
# H100 at 700 W). Each truncated solve's heads against the long one are
# readings: the two precisions' Krylov paths part, so their distances are
# not in a fixed ratio (on the card 1.5–1.8 : 1; 7 : 1 in the CPU
# rehearsal's 16² cells at about the same residuals). 13b holds truncated
# float32 solves against dense heads where the CPU runs the same solve.
TOL_MF_RESID = 2e-3
# 13b: on the first MF_DENSE_N points (the KMS gate's CG_KMS_MAX_POINTS: at
# 65 536 float64 Jacobi CG on phase 7's model ended 20 000 iterations at a
# relative residual of 1.1e-6, its q_v 7.4e-5 from the dense head, on an
# H100), float64 solves at tol 1e-12 and at most
# MF_DENSE_MAXITER iterations against the dense heads with jitter 1e-12:
# within TOL_MF_DENSE_F64 where the solve converged, else (10d's Matérn-3/2
# and 12b's ICM models, whose Jacobi CG ended at relative residuals of
# 8.2e-7 and 2.1e-5, their heads 5.3e-4 and 1.2e-4 from the dense ones on an
# H100 at 700 W) within TOL_MF_DENSE_TRUNC
MF_DENSE_N = 8192
MF_DENSE_TOL = 1e-12
MF_DENSE_MAXITER = 3000
MF_DENSE_JITTER = 1e-12
TOL_MF_DENSE_F64 = 1e-7
TOL_MF_DENSE_TRUNC = 2e-3
# 13c: the pathwise draws on 13a's model at MF_PATH_N points (above
# CG_KMS_MAX_POINTS, so the G solves take Jacobi CG, as 13a's), S = 16
# antithetic. Their G solves stop at MF_MAXITER too, each column on its own
# Krylov path, so the antithetic mean meets the mean from solve_w within
# TOL_MF_ANTITHETIC, not exactly (1.3e-2 and 5.1e-2 in float32, 6.9e-3 and
# 6.1e-2 in float64 for q_v and q_dv on an H100 at 700 W). Their float32
# against float64 is a reading: it grows with the G solves' maxiter (0.185,
# 0.241, 0.566 at 1000, 2000, 4000 on an H100, tools/torch_cg_probe.py), a
# float32 limit at large ℓ/δ that the JAX package shares
# (tools/torch_draws_f32.py), and the CPU cannot run these draws at their
# size for the 2× rule. The draws are held by the 2× rule on phase
# 7's model at MF_DRAWS_N points, where the CPU runs the same sampler from
# the same draws and the G solves converge: float64 at tol MF_DENSE_TOL
# (the Woodbury PCG), float32 at its default tol within MF_DRAWS_MAXITER
# (Jacobi PCG, 2505 iterations for solve_w on an H100); the float64
# antithetic identity there within TOL_MF_DENSE_F64. On
# phase 7's model MF_DENSE_SAMPLES plain draws of 4096 features, as
# tests/test_iterative.py:351-403 (at S = 256 the per-cell variance's MC
# error, √(2/255) = 8.9%, puts rtol 0.25 at 2.8σ, which some of 4096 cells
# cross)
MF_PATH_N = 16_384
MF_SAMPLES = 16
MF_FEATURES = 1024
MF_DRAWS_N = 1024
MF_DRAWS_MAXITER = 6000
TOL_MF_ANTITHETIC = {"q_v": 3e-2, "q_dv axis 0": 0.15}
MF_DENSE_SAMPLES = 1024
MF_DENSE_FEATURES = 4096
# 13d: a 1-D model inside the window where the JAX package's float32 gates
# admit the KMS-Woodbury PCG: 512 cells at ℓ/δ = 540, inside ℓ/δ ∈ [512,
# 579] (CG_KMS_MIN_STIFFNESS to 1/u_floor), on 4096 points; phase 4 trains
# the main path's model into that window (ℓ/δ ≈ 550). The port's float32
# takes Jacobi PCG there (see config); its true relative residual within
# TOL_MF_WOODBURY_RESID, the bound tests/test_torch_iterative.py holds it to
# on the CPU (1.5e-5 on an H100 at 700 W, 7.2e-6 on the CPU; the JAX
# package's float32 Woodbury ends above 1 there)
MF_WOODBURY_CELLS = 512
MF_WOODBURY_RATIO = 540.0
MF_WOODBURY_N = 4096
TOL_MF_WOODBURY_RESID = 1e-4
# the phase's cell_kuf launches by (name, m, n), summed over counted() calls
MF_SHAPE_LAUNCHES = collections.Counter()


def counted(name, fn, n_cell_kuf, shapes=MF_SHAPE_LAUNCHES):
    """One call of ``fn`` under no_grad, host clock around it (ending in
    synchronize), its launches counted (reset just before, read just after;
    by shape into ``shapes``) and, unless ``n_cell_kuf`` is None, held
    exactly: ``n_cell_kuf`` of cell_kuf and none of the other kernels.
    Returns (the output, ms, launches)."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = cell_launches()
    # kernel launches only: the three-axis moments count their contraction there too
    shapes.update({k: v for k, v in ck.SHAPE_LAUNCHES.items() if k[0] in ck.LAUNCHES})
    if n_cell_kuf is not None:
        want = {**NO_LAUNCHES, "cell_kuf": n_cell_kuf}
        check(got == want, f"{name}: launches {got}, expected {want}")
    return out, ms, got


def mf_model(main):
    """13a's model: the collapsed GriddedGP on the main path's 512×512 cells
    with phase 4's trained kernel hyperparameters and noise."""
    import torch

    from vggp_tpu_torch import SGPRSpec

    spec_svgp, model = main
    with torch.no_grad():
        p = model.params()
    params = {"axes": tuple({k: v.detach().clone() for k, v in ax.items()} for ax in p["axes"]),
              "noise": p["noise"].detach().clone()}
    return SGPRSpec(kinds=spec_svgp.kinds, features=spec_svgp.features), params


# 13a's heads from w and their cell_kuf launches a call: the query block one
# per axis at (512, 4096), q_dv's face difference one at (512, 513)
MF_HEADS = (("posterior", 2), ("q_v", 0), ("q_dv axis 0", 1))


def mf_head(spec, name, p, w, xs):
    from vggp_tpu_torch import iterative

    if name == "posterior":
        return iterative.posterior_mean_from_w(spec, p, xs, w)
    if name == "q_v":
        return iterative.q_v_mean_from_w(spec, p, spec.features, w)
    return iterative.q_dv_mean_from_w(spec, p, spec.features, 0, w)


def mf_solve(spec, params, X, y, xs, cast, count, maxiter=MF_MAXITER):
    """solve_w and 13a's heads on the card (``cast`` to its dtype), each
    call's launches counted into ``count``. Returns (quantities, info, ms of
    solve_w)."""
    from vggp_tpu_torch import iterative

    p, Xd, yd, xd = cast(params), cast(X), cast(y), cast(xs)
    (w, info), ms, got = counted(f"13a solve_w n={Xd.shape[0]}", lambda: iterative.solve_w(
        spec, p, Xd, yd, maxiter=maxiter, return_info=True), spec.ndim)
    count.update(add_launches(count, got))
    out = {"w": w}
    for name, n_launch in MF_HEADS:
        out[name], _, got = counted(f"13a {name}", lambda n=name: mf_head(spec, n, p, w, xd),
                                    n_launch)
        count.update(add_launches(count, got))
    return out, info, ms


def mf_solve_part(device, X, y, Xs, main, timings) -> tuple:
    """13a: solve_w and the heads from w on 13a's model (m = 262 144) at MF_N
    points in float32 and float64 at MF_MAXITER, each solve's iterations,
    preconditioner, ms and true relative residual (recomputed in float64),
    and a float64 solve at MF_LONG_MAXITER; then the checks of TOL_MF_RESID
    and a profiled float32 solve. Returns (launches, (spec, params))."""
    import torch

    from vggp_tpu_torch import iterative
    from vggp_tpu_torch.ops import cell_kuf as ck
    from vggp_tpu_torch.ops import cg

    spec, params = mf_model(main)
    ells = [float(ax["lengthscale"]) * spec.features[i].m for i, ax in enumerate(params["axes"])]
    print(f"13a model: {spec.features[0].m}x{spec.features[1].m} cells, phase 4's trained σ² "
          f"{[round(float(ax['variance']), 5) for ax in params['axes']]}, ℓ/δ "
          f"{[round(v, 2) for v in ells]}, noise {float(params['noise']):.5f}; n = {MF_N}")
    launches = dict(NO_LAUNCHES)
    X, y = X[:MF_N], y[:MF_N]
    c64 = cast_to(device, torch.float64)
    p64, X64, y64 = c64(params), c64(X), c64(y)
    card = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        cg.reset_counts()
        card[tag], info, ms = mf_solve(spec, params, X, y, Xs, cast_to(device, dtype),
                                       launches)
        counts = dict(cg.COUNTS)
        rel, _, got = counted("13a relative_residual", lambda: iterative.relative_residual(
            spec, p64, X64, y64, card[tag]["w"]), spec.ndim)
        launches = add_launches(launches, got)
        timings[f"mf_solve_w_{tag}_ms"] = ms
        timings[f"mf_solve_w_{tag}"] = {**info, "true_rel_resid": float(rel)}
        print(f"13a solve_w {tag} n={MF_N}: {info['iterations']} iterations "
              f"({info['preconditioner']}), relative residual {info['rel_resid']:.3e}, "
              f"true {float(rel):.3e} (float64); {ms:.1f} ms, "
              f"{ms / max(info['iterations'], 1):.3f} ms an iteration; host reads of the "
              f"running flag {counts['host_syncs']} (every {cg.CHECK_EVERY} iterations)")
    resid = timings["mf_solve_w_f32"]["true_rel_resid"]
    print(f"check 13a solve_w f32: true relative residual {resid:.3e} (tol {TOL_MF_RESID:.0e})")
    check(resid <= TOL_MF_RESID, f"13a float32 solve: {timings['mf_solve_w_f32']}")
    long, info, ms = mf_solve(spec, params, X, y, Xs, c64, launches, MF_LONG_MAXITER)
    print(f"13a solve_w f64 maxiter {MF_LONG_MAXITER}: {info['iterations']} iterations, "
          f"relative residual {info['rel_resid']:.3e}; {ms:.1f} ms")
    timings["mf_solve_w_f64_long"] = {**info, "ms": ms}

    print("13a w: f32 vs f64 "
          f"{rel_err(card['f32']['w'].double().cpu(), card['f64']['w'].double().cpu()):.3e}, "
          f"f64 vs the f64 solve at maxiter {MF_LONG_MAXITER} "
          f"{rel_err(card['f64']['w'].double().cpu(), long['w'].double().cpu()):.3e} (a reading: "
          "w is held through its residual and the heads)")
    # each head's own float32 error: from the long solve's w cast to float32,
    # on the card and on the CPU, against the card's float64 head from that w
    c32, cpu32 = cast_to(device, torch.float32), cast_to(torch.device("cpu"), torch.float32)
    p32, xs32, w32 = c32(params), c32(Xs), c32(long["w"])
    pc, xsc, wc = cpu32(params), cpu32(Xs), cpu32(long["w"])
    for name, n_launch in MF_HEADS:
        want = long[name].double().cpu()
        got32, _, got = counted(f"13a {name} f32 from one w",
                                lambda n=name: mf_head(spec, n, p32, w32, xs32), n_launch)
        launches = add_launches(launches, got)
        with torch.no_grad():
            cpu = mf_head(spec, name, pc, wc, xsc)
        e, e32 = rel_err(got32.double().cpu(), want), rel_err(cpu.double(), want)
        tol = max(TOL_E2E_POST, CPU_ERR_RATIO * e32)
        print(f"check 13a {name} from one w: card f32 vs card f64 {e:.3e}, cpu f32 {e32:.3e}, "
              f"tol {tol:.3e}")
        check(bool(torch.isfinite(got32).all()), f"13a {name} from one w not finite")
        check(e <= tol, f"13a {name} from one w: card f32 {e} > {tol}")
        timings[f"mf_{name.replace(' ', '_')}_from_w_err"] = {"card": e, "cpu_f32": e32}
    # each precision's heads through its truncated solve against the float64
    # solve at MF_LONG_MAXITER: readings (see TOL_MF_RESID)
    for name, _ in MF_HEADS:
        e = rel_err(card["f32"][name].double().cpu(), card["f64"][name].double().cpu())
        to_long = {tag: rel_err(card[tag][name].double().cpu(), long[name].double().cpu())
                   for tag in ("f32", "f64")}
        print(f"13a {name}: from the f64 solve at maxiter {MF_LONG_MAXITER}: f32 "
              f"{to_long['f32']:.3e}, f64 {to_long['f64']:.3e} (maxiter {MF_MAXITER}); card f32 "
              f"vs f64 {e:.3e} (readings)")
        check(bool(torch.isfinite(card["f32"][name]).all()), f"13a {name} not finite")
        timings[f"mf_{name.replace(' ', '_')}_err"] = {"f32_vs_f64": e, "to_long": to_long}

    # a profiled float32 solve of MF_PROFILE_ITERS iterations
    c32 = cast_to(device, torch.float32)
    p32, X32, y32 = c32(params), c32(X), c32(y)
    ck.reset_launch_counts()
    with torch.no_grad():
        iterative.solve_w(spec, p32, X32, y32, maxiter=MF_PROFILE_ITERS)
        prof, wall = _profiled(lambda: iterative.solve_w(spec, p32, X32, y32,
                                                         maxiter=MF_PROFILE_ITERS), 1)
    got = cell_launches()
    MF_SHAPE_LAUNCHES.update(cell_shape_launches())
    check(got == {**NO_LAUNCHES, "cell_kuf": 2 * spec.ndim},
          f"13a warm and profiled solves' launches {got}")
    launches = add_launches(launches, got)
    n_ev = len(_device_events(prof))
    dev_ms = _kernel_ms(prof)
    bound = 2 * 2 * spec.num_inducing * MF_N / FP32_FLOPS_PER_S * 1e3
    prof_out = {"iterations": MF_PROFILE_ITERS, "ms_per_iteration": wall / MF_PROFILE_ITERS,
                "device_ms_per_iteration": dev_ms / MF_PROFILE_ITERS,
                "launches_per_iteration": n_ev / MF_PROFILE_ITERS, "busy_share": dev_ms / wall,
                "bound_ms_per_iteration": bound}
    timings["mf_cg_profile"] = prof_out
    print(f"13a profiled f32 CG ({MF_PROFILE_ITERS} iterations, the Kuf blocks included): "
          f"{prof_out['ms_per_iteration']:.3f} ms an iteration (device "
          f"{prof_out['device_ms_per_iteration']:.3f}), {prof_out['launches_per_iteration']:.1f} "
          f"device kernels an iteration, busy share {prof_out['busy_share']:.3f}; the two Kuf "
          f"contractions' bound {bound:.3f} ms an iteration (fp32)")
    top = sorted(((e.self_device_time_total if hasattr(e, "self_device_time_total")
                   else e.self_cuda_time_total), e.key) for e in prof.key_averages())[-6:]
    print("13a profiled CG, the ops with the most device time (us): "
          + ", ".join(f"{k} {t:.0f}" for t, k in reversed(top)))
    return launches, (spec, params)


def mf_dense_part(device, X, y, Xs, collapsed, matern32, icm, timings) -> dict:
    """13b: the matrix-free means against the dense heads of the same
    trained models on the card, on their first MF_DENSE_N points: phase 7's
    collapsed GriddedGP (the KMS-Woodbury PCG in float64; q_v on its
    cells, the posterior at the 4096 points), 10d's Matérn-3/2 one
    (posterior_grad on both axes) and 12b's ICM one (q_v; per-output noise
    and means, the weighted system). float64 CG at tol 1e-12 against the
    dense float64 heads with jitter 1e-12 within TOL_MF_DENSE_F64 (where the
    solve stopped at maxiter, TOL_MF_DENSE_TRUNC); float32 CG
    at the defaults against the same dense float64, by the phases' rule with
    the CPU's own float32 CG at the same n (a cut n would understate it:
    a float32 solve's error grows with the conditioning, that is with n).
    Returns the launches."""
    import dataclasses

    import torch

    from vggp_tpu_torch import iterative, sgpr

    launches = dict(NO_LAUNCHES)
    spec7, p7 = collapsed
    spec32, p32 = matern32
    spec_i, p_i, X_i, y_i = icm
    Xs_i = torch.cat([Xs, (torch.arange(Xs.shape[0], device=Xs.device) % 2)[:, None]
                      .to(Xs.dtype)], 1)
    # (name, spec, params, X, y, query, {head: (the CG head from w, the dense
    # head, the cell_kuf launches of each a call)})
    cases = (
        ("phase 7 collapsed", spec7, p7, X, y, Xs, {
            "q_v": (lambda s, p, X, y, w, q: iterative.q_v_mean_from_w(s, p, s.features, w),
                    lambda s, p, X, y, q: sgpr.q_v(s, p, X, y, s.features, full_cov=False).mean,
                    0, 2),
            "posterior": (lambda s, p, X, y, w, q: iterative.posterior_mean_from_w(s, p, q, w),
                          lambda s, p, X, y, q: sgpr.posterior(s, p, X, y, q, full_cov=False).mean,
                          2, 4)}),
        ("10d matern32", spec32, p32, X, y, Xs, {
            f"posterior_grad axis {a}": (
                lambda s, p, X, y, w, q, a=a: iterative.posterior_grad_mean_from_w(s, p, q, a, w),
                lambda s, p, X, y, q, a=a: sgpr.posterior_grad(s, p, X, y, q, a).mean, 0, 0)
            for a in (0, 1)}),
        ("12b icm", spec_i, p_i, X_i, y_i, Xs_i, {
            "q_v": (lambda s, p, X, y, w, q: iterative.q_v_mean_from_w(s, p, s.features, w),
                    lambda s, p, X, y, q: sgpr.q_v(s, p, X, y, s.features, full_cov=False).mean,
                    0, 2)}),
    )
    for name, spec, params, Xc, yc, q, heads in cases:
        Xc, yc = Xc[:MF_DENSE_N], yc[:MF_DENSE_N]
        dspec = dataclasses.replace(spec, jitter=MF_DENSE_JITTER)
        n_axes = sum(k == "matern12" for k in spec.kinds)
        c64, c32 = cast_to(device, torch.float64), cast_to(device, torch.float32)
        res = {}
        for tag, cast, tol, maxiter in (("f64", c64, MF_DENSE_TOL, MF_DENSE_MAXITER),
                                        ("f32", c32, None, MF_MAXITER)):
            p, Xd, yd, qd = cast(params), cast(Xc), cast(yc), cast(q)
            (w, info), ms, got = counted(f"13b {name} solve_w {tag}", lambda: iterative.solve_w(
                spec, p, Xd, yd, tol=tol, maxiter=maxiter, return_info=True), n_axes)
            launches = add_launches(launches, got)
            print(f"13b {name} solve_w {tag} n={Xd.shape[0]}: {info}, {ms:.1f} ms")
            timings[f"mf_dense_{name}_solve_{tag}".replace(" ", "_")] = {**info, "ms": ms}
            if tag == "f64":
                converged = info["rel_resid"] <= MF_DENSE_TOL
            for head, (cg_fn, _, n_cg, _) in heads.items():
                res[(tag, head)], _, got = counted(f"13b {name} {head} {tag}",
                                                   lambda: cg_fn(spec, p, Xd, yd, w, qd), n_cg)
                launches = add_launches(launches, got)
        # the CPU's own float32 CG at the same n, against the card's dense float64
        cpu32 = cast_to(torch.device("cpu"), torch.float32)
        p3, X3, y3, q3 = cpu32(params), cpu32(Xc), cpu32(yc), cpu32(q)
        with torch.no_grad():
            w3 = iterative.solve_w(spec, p3, X3, y3)
            cpu_f32 = {head: fns[0](spec, p3, X3, y3, w3, q3) for head, fns in heads.items()}
        p, Xd, yd, qd = c64(params), c64(Xc), c64(yc), c64(q)
        for head, (_, dense_fn, _, n_dense) in heads.items():
            want, _, got = counted(f"13b {name} dense {head} f64",
                                   lambda: dense_fn(dspec, p, Xd, yd, qd), n_dense)
            launches = add_launches(launches, got)
            e64 = rel_err(res[("f64", head)], want)
            e = rel_err(res[("f32", head)].double(), want)
            e32 = rel_err(cpu_f32[head].double(), want.cpu())
            tol = max(TOL_E2E_POST, CPU_ERR_RATIO * e32)
            tol64 = TOL_MF_DENSE_F64 if converged else TOL_MF_DENSE_TRUNC
            print(f"check 13b {name} {head}: f64 CG vs dense {e64:.3e} (tol {tol64:.0e}"
                  f"{'' if converged else ': the f64 solve stopped at maxiter'}); card f32 CG "
                  f"vs dense f64 {e:.3e}, cpu f32 CG {e32:.3e}, tol {tol:.3e}")
            check(e64 <= tol64, f"13b {name} {head}: f64 CG vs dense {e64}")
            check(e <= tol, f"13b {name} {head}: f32 CG vs dense {e} > {tol}")
            timings[f"mf_dense_{name}_{head}".replace(" ", "_")] = {"f64": e64, "f32": e,
                                                                    "cpu_f32": e32}
    return launches


def mf_pathwise(spec, params, X, y, cast, device, count):
    """13c's draws on the card in one dtype (``cast``): pathwise_q_v_samples
    (with the priors) and pathwise_q_dv_samples on axis 0, MF_SAMPLES
    antithetic of MF_FEATURES features from two generators seeded 13 and 14,
    and the means from solve_w that their antithetic means must equal; each
    call's launches counted into ``count`` (cell_kuf two a sampler, one more
    for q_dv's face difference)."""
    import torch

    from vggp_tpu_torch import iterative

    p, Xd, yd = cast(params), cast(X), cast(y)
    kw = dict(n_samples=MF_SAMPLES, n_features=MF_FEATURES, antithetic=True)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)

    def means():
        w = iterative.solve_w(spec, p, Xd, yd, maxiter=MF_MAXITER)
        return (iterative.q_v_mean_from_w(spec, p, spec.features, w),
                iterative.q_dv_mean_from_w(spec, p, spec.features, 0, w))

    calls = {
        "q_v": (lambda: iterative.pathwise_q_v_samples(
            spec, p, Xd, yd, spec.features, gen(13), return_prior=True, **kw), spec.ndim),
        "q_dv axis 0": (lambda: (iterative.pathwise_q_dv_samples(
            spec, p, Xd, yd, spec.features, 0, gen(14), **kw), None), spec.ndim + 1),
        "means": (means, spec.ndim + 1)}
    out = {}
    tag = str(p["noise"].dtype)[6:]
    for name, (fn, n_launch) in calls.items():
        out[name], ms, got = counted(f"13c {name} {tag}", fn, n_launch)
        count.update(add_launches(count, got))
        print(f"13c {name} {tag} n={Xd.shape[0]}, S={MF_SAMPLES}: {ms:.1f} ms")
    out["mean q_v"], out["mean q_dv axis 0"] = out.pop("means")
    return out


def mf_pathwise_part(device, X, y, mf, collapsed, timings) -> dict:
    """13c: pathwise uncertainty on 13a's model and cells at MF_PATH_N points
    (:func:`mf_pathwise`) in float32 and float64 from the same draws: the
    antithetic sample means against the means from solve_w within
    TOL_MF_ANTITHETIC; q_v_pathwise's control-variate moments, every
    variance positive and at most diag(Kvv); float32 against float64 draw
    by draw, a reading. Then phase 7's model: its draws by the 2× rule
    (:func:`mf_draws_part`), and q_v_pathwise with MF_DENSE_SAMPLES plain
    draws in float64 at MF_DENSE_N points against its dense float64 q_v:
    the variance within rtol 0.25, the mean within 5 MC standard errors.
    Returns the launches."""
    import dataclasses

    import torch

    from vggp_tpu_torch import iterative, sgpr

    spec, params = mf
    launches = dict(NO_LAUNCHES)
    X_full, y_full = X, y
    X, y = X[:MF_PATH_N], y[:MF_PATH_N]
    kvv = None
    for i, g in enumerate(spec.features):
        di = g.kuu_diag(spec.kinds[i], cast_to(device, torch.float64)(params)["axes"][i])
        kvv = di if kvv is None else (kvv[:, None] * di[None, :]).reshape(-1)
    card = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        card[tag] = out = mf_pathwise(spec, params, X, y, cast_to(device, dtype), device,
                                      launches)
        samples, priors = out["q_v"]
        p = cast_to(device, dtype)(params)
        g = iterative.pathwise_moments(spec, p, spec.features, samples, priors, True)
        var = g.var.double()
        print(f"13c q_v_pathwise {tag}: var range [{float(var.min()):.4g}, "
              f"{float(var.max()):.4g}], diag(Kvv) {float(kvv.max()):.4g}")
        check(bool((var > 0).all()) and bool((var <= kvv).all()),
              f"13c {tag}: a variance outside (0, diag Kvv]")
        dv = out["q_dv axis 0"][0]
        check(bool(torch.isfinite(dv).all()) and bool((dv.var(0) > 0).all()),
              f"13c q_dv {tag}: a variance not positive")
        for name in ("q_v", "q_dv axis 0"):
            e = rel_err(out[name][0].double().mean(0), out[f"mean {name}"].double())
            print(f"check 13c {name} {tag}: antithetic mean vs the mean from solve_w {e:.3e} "
                  f"(tol {TOL_MF_ANTITHETIC[name]:.0e})")
            check(e <= TOL_MF_ANTITHETIC[name], f"13c {name} {tag}: antithetic mean {e}")
    # float32 against float64 draw by draw, beside the means' distance and
    # the variances' largest ratio: readings (see TOL_MF_ANTITHETIC)
    for name in ("q_v", "q_dv axis 0"):
        e = rel_err(card["f32"][name][0].double().cpu(), card["f64"][name][0].double().cpu())
        e_mean = rel_err(card["f32"][f"mean {name}"].double().cpu(),
                         card["f64"][f"mean {name}"].double().cpu())
        v32, v64 = (card[t][name][0].double().var(0) for t in ("f32", "f64"))
        ratio = float((v32 / v64.clamp(min=torch.finfo(torch.float64).tiny)).max())
        print(f"13c {name} draws: card f32 vs f64 {e:.3e}; the mean from solve_w {e_mean:.3e}; "
              f"the largest variance ratio f32/f64 {ratio:.3f} (readings)")
        timings[f"mf_pathwise_{name.replace(' ', '_')}_err"] = {"f32_vs_f64": e, "mean": e_mean,
                                                                "var_ratio_max": ratio}
    launches = add_launches(launches, mf_draws_part(device, X_full, y_full, collapsed, timings))

    # phase 7's model: the pathwise moments against the dense q_v, in float64
    # on 13b's MF_DENSE_N points, where the solves converge (the Woodbury G
    # solve, the KMS Kuu solve): a Monte Carlo check of the sampler, which
    # the truncated Jacobi solves at 65 536 points would bias (on an H100:
    # the mean 2.2 MC errors' worth past its 5-error bound, the variance
    # 0.28 off)
    spec7, p7 = collapsed
    c64 = cast_to(device, torch.float64)
    Xn, yn = c64(X_full[:MF_DENSE_N]), c64(y_full[:MF_DENSE_N])
    g, ms, got = counted("13c q_v_pathwise on phase 7's model", lambda: iterative.q_v_pathwise(
        spec7, c64(p7), Xn, yn, spec7.features, torch.Generator(device=device).manual_seed(15),
        n_samples=MF_DENSE_SAMPLES, n_features=MF_DENSE_FEATURES), 2)
    launches = add_launches(launches, got)
    dspec7 = dataclasses.replace(spec7, jitter=MF_DENSE_JITTER)
    want, _, got = counted("13c dense q_v f64 on phase 7's model", lambda: sgpr.q_v(
        dspec7, c64(p7), Xn, yn, spec7.features, full_cov=False), 2)
    launches = add_launches(launches, got)
    w_mean, w_var = want.mean.double(), want.var.double()
    d_mean = float((g.mean.double() - w_mean).abs().max())
    bound_mean = 5.0 * float(torch.sqrt(w_var / MF_DENSE_SAMPLES).max())
    d_var = float(((g.var.double() - w_var).abs() / (w_var + 1e-6 * w_var.max())).max())
    print(f"check 13c q_v_pathwise f64 on phase 7's model (S={MF_DENSE_SAMPLES}, "
          f"{MF_DENSE_FEATURES} features, n={MF_DENSE_N}): {ms:.1f} ms; mean max|Δ| {d_mean:.3e} "
          f"(5 MC errors {bound_mean:.3e}), variance max rel {d_var:.3e} (tol 0.25)")
    check(d_mean <= bound_mean, f"13c phase 7 mean {d_mean} > {bound_mean}")
    check(d_var <= 0.25, f"13c phase 7 variance rel {d_var} > 0.25")
    timings["mf_pathwise_phase7"] = {"ms": ms, "mean_abs": d_mean, "mean_bound": bound_mean,
                                     "var_rel": d_var}
    return launches


def mf_draws_part(device, X, y, collapsed, timings) -> dict:
    """13c on phase 7's model at MF_DRAWS_N points: pathwise_q_v_samples,
    MF_SAMPLES antithetic of MF_FEATURES features, from one card generator
    (so the same draws) on the card in float64 and float32 and on the CPU
    in float32, the G solves to convergence (see MF_DRAWS_MAXITER). The
    card's float32 draws and their variances against the card's float64 by
    the 2× rule with the CPU's; the float64 antithetic mean against
    q_v_mean_from_w of a float64 solve_w within TOL_MF_DENSE_F64. Returns
    the launches."""
    import torch

    from vggp_tpu_torch import iterative

    spec, params = collapsed
    launches = dict(NO_LAUNCHES)
    X, y = X[:MF_DRAWS_N], y[:MF_DRAWS_N]
    print(f"13c phase 7's model: ℓ {[round(float(ax['lengthscale']), 4) for ax in params['axes']]}"
          f", σ² {[round(float(ax['variance']), 4) for ax in params['axes']]}, noise "
          f"{float(params['noise']):.5f}")
    c32 = cast_to(device, torch.float32)
    (_, info), _, got = counted("13c solve_w f32 on phase 7's model", lambda: iterative.solve_w(
        spec, c32(params), c32(X), c32(y), maxiter=MF_DRAWS_MAXITER, return_info=True), 2)
    launches = add_launches(launches, got)
    print(f"13c solve_w f32 on phase 7's model n={MF_DRAWS_N} (as a G solve of the draws): "
          f"{info}")
    draws = {}
    for where, dev, dtype in (("card f64", device, torch.float64),
                              ("card f32", device, torch.float32),
                              ("cpu f32", torch.device("cpu"), torch.float32)):
        c = cast_to(dev, dtype)
        p, Xd, yd = c(params), c(X), c(y)
        gen = torch.Generator(device=device).manual_seed(16)
        kw = dict(n_samples=MF_SAMPLES, n_features=MF_FEATURES, antithetic=True,
                  maxiter=MF_DRAWS_MAXITER,
                  tol=MF_DENSE_TOL if dtype == torch.float64 else None)
        fn = lambda: iterative.pathwise_q_v_samples(spec, p, Xd, yd, spec.features, gen, **kw)
        t0 = time.perf_counter()
        if dev.type == "cpu":
            with torch.no_grad():
                draws[where] = fn()
        else:
            draws[where], _, got = counted(f"13c draws on phase 7's model {where}", fn, 2)
            launches = add_launches(launches, got)
        print(f"13c draws on phase 7's model {where} n={MF_DRAWS_N}, S={MF_SAMPLES}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    ref = draws["card f64"].double().cpu()
    errs = {}
    for name, of in (("draws", lambda t: t), ("variances", lambda t: t.var(0))):
        e = rel_err(of(draws["card f32"].double().cpu()), of(ref))
        e32 = rel_err(of(draws["cpu f32"].double()), of(ref))
        tol = max(TOL_E2E_POST, CPU_ERR_RATIO * e32)
        print(f"check 13c {name} on phase 7's model: card f32 vs card f64 {e:.3e}, cpu f32 "
              f"{e32:.3e}, tol {tol:.3e}")
        check(e <= tol, f"13c {name} on phase 7's model: card f32 {e} > {tol}")
        errs[name] = {"card": e, "cpu_f32": e32}
    c64 = cast_to(device, torch.float64)
    (w, info), _, got = counted("13c solve_w on phase 7's model", lambda: iterative.solve_w(
        spec, c64(params), c64(X), c64(y), tol=MF_DENSE_TOL, maxiter=MF_DRAWS_MAXITER,
        return_info=True), 2)
    launches = add_launches(launches, got)
    mean, _, got = counted("13c q_v_mean_from_w on phase 7's model",
                           lambda: iterative.q_v_mean_from_w(spec, c64(params), spec.features, w),
                           0)
    e = rel_err(draws["card f64"].mean(0), mean)
    print(f"check 13c antithetic mean on phase 7's model f64 ({info}): vs the mean from "
          f"solve_w {e:.3e} (tol {TOL_MF_DENSE_F64:.0e})")
    check(e <= TOL_MF_DENSE_F64, f"13c antithetic mean on phase 7's model {e}")
    timings["mf_draws_phase7"] = {**errs, "antithetic_mean": e}
    return launches


def mf_bench_part(device, timings) -> tuple:
    """13d: bench.py's CG row (:func:`cg_value`, cell_kuf once a solve at
    (16 384, 256)) on the card: float32 within TOL_CG_F32 of bench.py's
    float32 golden, float64 within TOL_CG_F64 of the JAX package's float64
    value (CG_F64_JAX), the distance from bench.py's float64 golden printed;
    and the 1-D model inside the JAX package's float32 Woodbury window
    (MF_WOODBURY_*): the float32 solve must take Jacobi PCG and reach a true
    relative residual within TOL_MF_WOODBURY_RESID, the float64 solve the
    KMS-Woodbury PCG and 1e-7. Returns the launches."""
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, iterative

    launches = dict(NO_LAUNCHES)
    vals = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        (vals[tag], info), ms, got = counted(f"13d cg_case {tag}",
                                             lambda: cg_value(dtype, device), 1)
        launches = add_launches(launches, got)
        print(f"13d cg_qv_abs_sum {tag}: {vals[tag]!r} ({info}), {ms:.1f} ms")
        timings[f"mf_cg_case_{tag}"] = {"value": vals[tag], **info, "ms": ms}
    e32 = abs(vals["f32"] - _GOLD_CG_F32) / abs(_GOLD_CG_F32)
    e64 = abs(vals["f64"] - CG_F64_JAX) / abs(CG_F64_JAX)
    stale = abs(vals["f64"] - _GOLD_CG_F64) / abs(_GOLD_CG_F64)
    print(f"check 13d cg_qv_abs_sum: f32 {e32:.3e} from bench.py's f32 golden (tol "
          f"{TOL_CG_F32:.0e}); f64 {e64:.3e} from the JAX package's f64 value (tol "
          f"{TOL_CG_F64:.0e}), {stale:.3e} from bench.py's f64 golden")
    check(e32 <= TOL_CG_F32, f"13d cg_qv_abs_sum f32 {e32}")
    check(e64 <= TOL_CG_F64, f"13d cg_qv_abs_sum f64 {e64}")

    x1, y1, _ = make_data_1d(device)
    x1, y1 = x1[:MF_WOODBURY_N], y1[:MF_WOODBURY_N]
    m = MF_WOODBURY_CELLS
    spec = SGPRSpec(kinds=("matern12",), features=(CellIntegralFeature.from_lims(m, 0.0, 1.0),))
    c64 = cast_to(device, torch.float64)
    params = {"axes": ({"variance": torch.tensor(0.91), "lengthscale":
                        torch.tensor(MF_WOODBURY_RATIO / m)},), "noise": torch.tensor(0.114)}
    reading = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        c = cast_to(device, dtype)
        (w, info), ms, got = counted(f"13d woodbury solve_w {tag}", lambda: iterative.solve_w(
            spec, c(params), c(x1), c(y1), return_info=True), 1)
        launches = add_launches(launches, got)
        rel, _, got = counted("13d relative_residual", lambda: iterative.relative_residual(
            spec, c64(params), c64(x1), c64(y1), w), 1)
        launches = add_launches(launches, got)
        reading[tag] = {**info, "true_rel_resid": float(rel), "ms": ms}
    print(f"check 13d the 1-D model at ℓ/δ = {MF_WOODBURY_RATIO} ({m} cells, "
          f"n = {MF_WOODBURY_N}), solve_w: {reading}; the f32 true residual's tol "
          f"{TOL_MF_WOODBURY_RESID:.0e}")
    check(reading["f32"]["preconditioner"] == "jacobi-pcg"
          and reading["f32"]["true_rel_resid"] <= TOL_MF_WOODBURY_RESID,
          f"13d float32 Woodbury-window case: {reading['f32']}")
    check(reading["f64"]["preconditioner"] == "kms-woodbury"
          and reading["f64"]["true_rel_resid"] < 1e-7, f"13d float64 case: {reading['f64']}")
    timings["mf_woodbury_case"] = reading
    return launches


def matrix_free_phase(device, X, y, Xs, main, collapsed, matern32, icm) -> tuple:
    """Phase 13: cell_kuf against its plain version at the path's new shapes
    (16 384, 256) and (512, 513), then 13a–13d. Returns (launches, timings,
    the kernels' float32 errors, cell_kuf's launches at (512, 513) and at
    (16 384, 256), counted by shape)."""
    import torch

    timings = {}
    x_cg = cg_case(torch.float32, device)[2]
    edges = torch.linspace(0.0, 1.0, M_AXIS + 1, dtype=torch.float64, device=device)
    errs = check_kernels_at(device, ((16384, x_cg, None), (M_AXIS, edges, None)), "13")
    launches = dict(NO_LAUNCHES)
    MF_SHAPE_LAUNCHES.clear()
    mf = None
    for name, part in (
            ("mf_solve_part", lambda: mf_solve_part(device, X, y, Xs, main, timings)),
            ("mf_dense_part", lambda: mf_dense_part(device, X, y, Xs, collapsed, matern32, icm,
                                                    timings)),
            ("mf_pathwise_part", lambda: mf_pathwise_part(device, X, y, mf, collapsed,
                                                          timings)),
            ("mf_bench_part", lambda: mf_bench_part(device, timings))):
        t0 = time.perf_counter()
        got = part()
        if name == "mf_solve_part":
            got, mf = got
        launches = add_launches(launches, got)
        timings[f"{name}_s"] = time.perf_counter() - t0
        print(f"{name}: {timings[f'{name}_s']:.1f} s")
    at = {"at_face_edges": MF_SHAPE_LAUNCHES["cell_kuf", M_AXIS, M_AXIS + 1],
          "at_16384_cells": MF_SHAPE_LAUNCHES["cell_kuf", 16384, 256]}
    print(f"phase 13's cell_kuf launches by shape: {dict(MF_SHAPE_LAUNCHES)}")
    check(all(v > 0 for v in at.values()), f"phase 13: a new shape never launched: {at}")
    check(sum(v for k, v in MF_SHAPE_LAUNCHES.items() if k[0] in NO_LAUNCHES)
          == launches["cell_kuf"],
          f"phase 13: launches by shape {dict(MF_SHAPE_LAUNCHES)} vs {launches}")
    return launches, timings, errs, at


# --------------------------------------------------------------------------- #
# phase 14: the pathwise samplers of every model family (sampling.py) and
# streaming assimilation (streaming.py)
# --------------------------------------------------------------------------- #

# 14a: sampling.pathwise at the 4096 serve points and pathwise_q_v on the
# 512² cells of phase 4's model at the defaults of
# vggp_tpu/experiments/exceedance.py:61-62: 256 paths of 2048 features
P14_SAMPLES = 256
P14_FEATURES = 2048
# 14b and 14c: 64 draws a model at the 4096 serve points
P14_FAMILY_SAMPLES = 64
# Each sampler's first P14_CPU_DRAWS draws are held against the CPU's
# float64 from the same draws by the 2× rule against the CPU's float32 (S
# cut for the hold: the CPU's float64 at S = 256 would take minutes). The
# collapsed models' holds also cut their data to the first P14_CUT_N points
# (from 65 536: the CPU's (m, n) products at m = 4096 take seconds a
# precision; n = 4096 is the query blocks' own, so no other shape is
# launched); the card's full-n draws are held by their moments.
P14_CPU_DRAWS = 8
P14_CUT_N = 4096
# The moments of the draws: the sample mean within TOL_P14_MEAN_SDS head
# standard deviations over √S of the head's mean at every point and cell
# (with a float32 floor of TOL_E2E_POST × max|mean|), and in 14a the sample
# variance's median relative error within TOL_P14_VAR_MEDIAN, the bound of
# tests/test_sampling.py:107. Matérn-3/2 gradient draws are heavy-tailed
# (sampling.py:757-763): their variances are not held. 14a holds the
# moments of the card's float64 draws from the same generator and reads
# the float32 ones: at ℓ/δ ≈ 550 the float32 q_v draws lie 0.13 from
# float64 draw by draw (the CPU's float32 0.072, ROADMAP queue 3, item 13),
# far above a cell's posterior sd, and their sample mean read 1.47 of the
# bound on an H100 (700 W).
TOL_P14_MEAN_SDS = 5.0
TOL_P14_VAR_MEDIAN = 0.35
# 14d: phase 11a's 2-D full-family model (64×64 Matérn-1/2 cells, m = 4096)
# with its trained hyperparameters streams the main path's 1 000 000 points
# in chunks of STREAM_CHUNK (61 full chunks and one of 576). Its float32
# state and q_v are held against the CPU's float64 on the first
# STREAM_CUT_N points; the whole float32 stream against the card's float64
# one at TOL_STREAM_F32; the float64 stream in chunks of STREAM_BIG_CHUNK
# equals it within TOL_STREAM_IDENTITY. forget at STREAM_RHO
# (vggp_tpu/experiments/streaming.py:102), reanchor to ℓ × STREAM_ELL;
# assimilate_natgrad on NATGRAD_N of phase 9's Poisson targets, held
# against the CPU on P14_CUT_N of them.
STREAM_CHUNK = 16_384
STREAM_CUT_N = 8192
STREAM_BIG_CHUNK = 65_536
STREAM_RHO = 0.55
STREAM_ELL = 1.1
NATGRAD_N = 16_384
TOL_STREAM_IDENTITY = 1e-10
# the float32 stream against the card's float64 one, set from the readings
# of its first card run (Λ 3.6e-6, η 1.6e-5, q_v 1.3e-2, q_v after forget
# and reanchor 2.8e-2 on an H100 at 700 W), about 4× above them: Λ's
# condition grows like n/σ² (about 1e7 after the stream), so q_v carries
# float32's rounding of Λ far above the heads' floor, in the JAX package too
TOL_STREAM_F32 = {"lam": 2e-5, "eta": 1e-4, "q_v": 5e-2, "q_v after reanchor": 0.1}
# cell_kuf's shapes that phase 14 is the first to launch, held against the
# plain version before it runs: the stream's chunk (and natgrad's batch),
# the short last chunks of the stream and of the chunking identity's
# stream, the CPU hold's points on 64 cells, and the query blocks at the
# 4096 serve points of the ICM collapsed GP's and the sum's cells; and the
# shapes it launches that earlier phases held
P14_NEW_SHAPES = ((FULL_CELLS, STREAM_CHUNK), (FULL_CELLS, NUM_DATA % STREAM_CHUNK),
                  (FULL_CELLS, NUM_DATA % STREAM_BIG_CHUNK), (FULL_CELLS, STREAM_CUT_N),
                  (ICM_CELLS, SERVE_POINTS), (SUM_CELLS[0], SERVE_POINTS),
                  (SUM_CELLS[1], SERVE_POINTS))
P14_HELD_SHAPES = ((M_AXIS, SERVE_POINTS), (SGPR_CELLS, SGPR_N), (FULL_CELLS, TRAIN_BATCH),
                   (ICM_CELLS, SGPR_N), (SUM_CELLS[0], SGPR_N), (SUM_CELLS[1], SGPR_N),
                   (ADD_CELLS, SGPR_N))
# the phase's launches by (name, m, n), summed over p14_call()s
P14_SHAPE_LAUNCHES = collections.Counter()


def p14_call(name, fn):
    """:func:`counted` with the launches read, not held, by shape into
    P14_SHAPE_LAUNCHES; the output must be finite. Returns (the output, ms,
    launches)."""
    out, ms, got = counted(name, fn, None, P14_SHAPE_LAUNCHES)
    check(finite(tuple(out.values()) if isinstance(out, dict) else out), f"{name}: not finite")
    print(f"{name}: {ms:.1f} ms, launches {got}")
    return out, ms, got


def hold_draws(what, run, device, n_samples, seed, cut_n=None) -> tuple:
    """``run(cast, gen, S, n)`` → S draws of a sampler, n the data points it
    conditions on (None: all). On the card in float32 at ``n_samples`` and
    all the data (timed and counted by :func:`p14_call`); then the first
    P14_CPU_DRAWS draws on the CPU in float64 and float32 (at ``cut_n``
    points, where given, the card's also taken again there), each from a
    CPU generator seeded with ``seed``, so the same draws. The card's
    against the CPU's float64 within the larger of TOL_E2E_POST and
    CPU_ERR_RATIO × the CPU float32's error. Returns (the card's draws, ms,
    launches, the readings)."""
    import torch

    cpu = torch.device("cpu")
    gen = lambda: torch.Generator().manual_seed(seed)
    c32 = cast_to(device, torch.float32)
    draws, ms, got = p14_call(f"{what} card f32 S={n_samples}",
                              lambda: run(c32, gen(), n_samples, None))
    first = draws[:P14_CPU_DRAWS]
    if cut_n is not None:
        first, _, more = p14_call(f"{what} card f32 at n={cut_n}",
                                  lambda: run(c32, gen(), P14_CPU_DRAWS, cut_n))
        got = add_launches(got, more)
    with torch.no_grad():
        ref, f32 = (run(cast_to(cpu, dt), gen(), P14_CPU_DRAWS, cut_n).double()
                    for dt in (torch.float64, torch.float32))
    e, e32 = rel_err(first.double().cpu(), ref), rel_err(f32, ref)
    tol = max(TOL_E2E_POST, CPU_ERR_RATIO * e32)
    print(f"check {what} first {P14_CPU_DRAWS} draws{'' if cut_n is None else f' at n={cut_n}'}: "
          f"card f32 vs cpu f64 {e:.3e}, cpu f32 {e32:.3e}, tol {tol:.3e}")
    check(e <= tol, f"{what}: card f32 draws {e} > {tol} (cpu f32 {e32})")
    return draws, ms, got, {"card": e, "cpu_f32": e32, "tol": tol}


def hold_moments(what, draws, head, variance=False, held=True) -> dict:
    """The S draws' sample mean against the head's (a Gaussian on the card)
    within TOL_P14_MEAN_SDS·sd/√S + TOL_E2E_POST·max|mean| everywhere, and
    with ``variance`` the sample variance's median relative error within
    TOL_P14_VAR_MEDIAN; ``held=False`` prints them as readings. Returns the
    readings."""
    import torch

    d = draws.double()
    mean, var = head.mean.double(), head.var.double()
    S = d.shape[0]
    bound = (TOL_P14_MEAN_SDS * torch.sqrt(torch.clamp(var, min=0.0)) / S ** 0.5
             + TOL_E2E_POST * mean.abs().max())
    ratio = float(((d.mean(0) - mean).abs() / bound).max())
    out = {"mean_to_bound": ratio}
    msg = f"check {what} moments over S={S}: the sample mean at {ratio:.3f} of its bound"
    if variance:
        med = float(torch.median((d.var(0) - var).abs() / var))
        out["var_median_rel"] = med
        msg += f", the sample variance's median relative error {med:.3f} (tol {TOL_P14_VAR_MEDIAN})"
    print(msg if held else f"{msg} (a reading)".replace("check ", "", 1))
    if held:
        check(ratio <= 1.0, f"{what}: the sample mean at {ratio} of its bound")
        check(not variance or out["var_median_rel"] <= TOL_P14_VAR_MEDIAN,
              f"{what}: sample variance median rel {out.get('var_median_rel')}")
    return out


def main_draws_part(device, Xs, main, timings) -> dict:
    """14a: ``sampling.pathwise`` at the 4096 serve points and
    ``pathwise_q_v`` on the 512² cells of phase 4's trained model,
    P14_SAMPLES draws of P14_FEATURES features in float32 (cell_kuf twice
    for the query block, at (512, 4096); q_v none), the first held against
    the CPU's float64; the moments against ``svgp.posterior`` and
    ``svgp.q_v`` of the card's float64 draws from the same generator held,
    the float32 ones read. Returns the launches."""
    import torch

    from vggp_tpu_torch import sampling, svgp, train

    spec, model = main
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
    own = spec.features
    launches = dict(NO_LAUNCHES)
    for i, (name, run, head) in enumerate((
            ("pathwise", lambda c, g, S, n: sampling.pathwise(
                spec, c(params), g, c(Xs), n_samples=S, n_features=P14_FEATURES),
             lambda p=params: svgp.posterior(spec, p, Xs.to(p["noise"].dtype))),
            ("pathwise_q_v", lambda c, g, S, n: sampling.pathwise_q_v(
                spec, c(params), g, own, n_samples=S, n_features=P14_FEATURES),
             lambda p=params: svgp.q_v(spec, p, own)))):
        draws, ms, got, r = hold_draws(f"14a {name}", run, device, P14_SAMPLES, 1400 + i)
        g, _, more = p14_call(f"14a {name}'s head", head)
        r["f32"] = hold_moments(f"14a {name} f32", draws, g, variance=True, held=False)
        launches = add_launches(launches, add_launches(got, more))
        del draws
        c64 = cast_to(device, torch.float64)
        d64, ms64, more = p14_call(f"14a {name} card f64 S={P14_SAMPLES}", lambda: run(
            c64, torch.Generator().manual_seed(1400 + i), P14_SAMPLES, None))
        launches = add_launches(launches, more)
        g64, _, more = p14_call(f"14a {name}'s head f64", lambda: head(c64(params)))
        launches = add_launches(launches, more)
        r["f64"] = hold_moments(f"14a {name} f64", d64, g64, variance=True)
        del d64
        timings[f"p14_main_{name}_ms"] = ms
        timings[f"p14_main_{name}_f64_ms"] = ms64
        timings[f"p14_main_{name}"] = {**r, "launches": got}
    return launches


def gradient_draws_part(device, X, y, Xs, m32_svgp, m32_collapsed, timings) -> dict:
    """14b: the joint (f, ∂f/∂x₀, ∂f/∂x₁) draws of 10b's Matérn-3/2 512²
    SVGP (``pathwise_posterior_with_grads``) and of 10d's Matérn-3/2
    collapsed GP (``pathwise_posterior_collapsed_with_grads``, on its 65 536
    points), P14_FAMILY_SAMPLES each at the serve points; the first held
    against the CPU's float64 (the collapsed GP at P14_CUT_N points), the
    rows' sample means against ``posterior`` and ``posterior_grad``. No
    kernel launches (Matérn-3/2). Returns the launches."""
    from vggp_tpu_torch import sampling, sgpr, svgp

    launches = dict(NO_LAUNCHES)
    spec, params = m32_svgp
    spec_c, params_c = m32_collapsed
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    cases = (
        ("svgp", lambda c, g, S, n: sampling.pathwise_posterior_with_grads(
            spec, c(params), g, c(Xs), (0, 1), n_samples=S, n_features=P14_FEATURES), None,
         [lambda: svgp.posterior(spec, params, Xs)]
         + [lambda a=a: svgp.posterior_grad(spec, params, Xs, a) for a in (0, 1)]),
        ("collapsed", lambda c, g, S, n: sampling.pathwise_posterior_collapsed_with_grads(
            spec_c, c(params_c), g, c(Xn[:n]), c(yn[:n]), c(Xs), (0, 1), n_samples=S,
            n_features=P14_FEATURES), P14_CUT_N,
         [lambda: sgpr.posterior(spec_c, params_c, Xn, yn, Xs, full_cov=False)]
         + [lambda a=a: sgpr.posterior_grad(spec_c, params_c, Xn, yn, Xs, a)
            for a in (0, 1)]))
    for i, (name, run, cut_n, heads) in enumerate(cases):
        what = f"14b matern32 {name} with grads"
        draws, ms, got, r = hold_draws(what, run, device, P14_FAMILY_SAMPLES, 1410 + i, cut_n)
        check(draws.shape == (P14_FAMILY_SAMPLES, 3, SERVE_POINTS), f"{what}: {draws.shape}")
        launches = add_launches(launches, got)
        for row, head in enumerate(heads):
            g, _, more = p14_call(f"{what} row {row}'s head", head)
            launches = add_launches(launches, more)
            r[f"row {row}"] = hold_moments(f"{what} row {row}", draws[:, row], g)
        timings[f"p14_grads_{name}_ms"] = ms
        timings[f"p14_grads_{name}"] = r
    return launches


def family_draws_part(device, X, y, Xs, collapsed, exact_model, fitted, timings) -> dict:
    """14c: ``pathwise`` on phase 7's collapsed GriddedGP, phase 8's exact
    GP and 12b's ICM collapsed, sum, additive and free-point models, and
    ``pathwise_q_v`` on phase 7's model's cells, P14_FAMILY_SAMPLES draws
    each at the serve points; the first held against the CPU's float64 (the
    collapsed families at P14_CUT_N points), all by their sample means
    against the model's own posterior. Returns the launches."""
    from vggp_tpu_torch import additive, exact, freesvgp, sampling, sgpr
    from vggp_tpu_torch import sum as msum

    _, _, Xsm = make_data_multioutput(device)
    spec7, p7 = collapsed
    X7, y7 = X[:SGPR_N], y[:SGPR_N]
    spec_e, p_e = exact_model
    Xe, ye = X[:EXACT_N], y[:EXACT_N]
    cases = [
        ("phase 7 collapsed", spec7, p7, X7, y7, Xs, P14_CUT_N,
         lambda: sgpr.posterior(spec7, p7, X7, y7, Xs, full_cov=False)),
        ("phase 8 exact", spec_e, p_e, Xe, ye, Xs, None,
         lambda: exact.posterior(spec_e, p_e, Xe, ye, Xs, full_cov=False))]
    mods = {"icm": sgpr, "sum": msum, "additive": additive, "free": freesvgp}
    for name in ("icm", "sum", "additive", "free"):
        spec, p, Xf, yf = fitted[name]
        q = Xsm if name == "icm" else Xs
        cases.append((f"12b {name}", spec, p, Xf, yf, q, P14_CUT_N,
                      lambda spec=spec, p=p, Xf=Xf, yf=yf, q=q, mod=mods[name]:
                      mod.posterior(spec, p, Xf, yf, q, full_cov=False)))
    launches = dict(NO_LAUNCHES)
    for i, (name, spec, p, Xd, yd, q, cut_n, head) in enumerate(cases):
        run = (lambda c, g, S, n, spec=spec, p=p, Xd=Xd, yd=yd, q=q: sampling.pathwise(
            spec, c(p), g, c(q), data=(c(Xd[:n]), c(yd[:n])), n_samples=S,
            n_features=P14_FEATURES))
        draws, ms, got, r = hold_draws(f"14c {name}", run, device, P14_FAMILY_SAMPLES,
                                       1420 + i, cut_n)
        g, _, more = p14_call(f"14c {name}'s head", head)
        r.update(hold_moments(f"14c {name}", draws, g))
        launches = add_launches(launches, add_launches(got, more))
        timings[f"p14_family_{name.replace(' ', '_')}_ms"] = ms
        timings[f"p14_family_{name.replace(' ', '_')}"] = {**r, "launches": got}
    run = lambda c, g, S, n: sampling.pathwise_q_v(spec7, c(p7), g, spec7.features, n_samples=S,
                                                   n_features=P14_FEATURES,
                                                   data=(c(X7[:n]), c(y7[:n])))
    draws, ms, got, r = hold_draws("14c phase 7 collapsed pathwise_q_v", run, device,
                                   P14_FAMILY_SAMPLES, 1430, P14_CUT_N)
    g, _, more = p14_call("14c phase 7 q_v", lambda: sgpr.q_v(spec7, p7, X7, y7, spec7.features,
                                                               full_cov=False))
    r.update(hold_moments("14c phase 7 collapsed pathwise_q_v", draws, g))
    launches = add_launches(launches, add_launches(got, more))
    timings["p14_family_phase7_q_v_ms"] = ms
    timings["p14_family_phase7_q_v"] = {**r, "launches": got}
    return launches


def streaming_part(device, X, y, full2d, timings) -> dict:
    """14d: streaming assimilation on phase 11a's model (see STREAM_*):
    the first STREAM_CUT_N points' state and q_v against the CPU's float64;
    the 1 000 000 points in chunks of STREAM_CHUNK through ``assimilate``
    (a loop) in float32 and float64 and the 61 full chunks through
    ``assimilate_scan``; the float64 stream in chunks of STREAM_BIG_CHUNK;
    ``forget``, ``reanchor`` and ``to_params`` → ``svgp.q_v`` on the 64²
    cells; ``assimilate_natgrad`` under the Poisson likelihood. cell_kuf
    twice a chunk. Returns the launches."""
    import dataclasses

    import torch

    from vggp_tpu_torch import streaming, svgp

    spec, params = full2d
    own = spec.features
    cpu = torch.device("cpu")
    c32, c64 = cast_to(device, torch.float32), cast_to(device, torch.float64)
    launches = dict(NO_LAUNCHES)
    params_new = {**params, "axes": tuple({**ax, "lengthscale": ax["lengthscale"] * STREAM_ELL}
                                          for ax in params["axes"])}
    print(f"14d phase 11a's model: ℓ {[round(float(ax['lengthscale']), 4) for ax in params['axes']]}"
          f", σ² {[round(float(ax['variance']), 4) for ax in params['axes']]}, noise "
          f"{float(params['noise']):.5f}, mean {float(params['mean']):.5f}")

    def assimilated(cast, n):
        p, Xc, yc = cast(params), cast(X[:n]), cast(y[:n])
        s = streaming.assimilate(spec, p, streaming.init_state(spec, Xc.dtype, Xc.device), Xc, yc)
        return {**s, "q_v": svgp.q_v(spec, streaming.to_params(spec, p, s), own)}

    got, _, more = p14_call(f"14d assimilate n={STREAM_CUT_N} card f32",
                            lambda: assimilated(c32, STREAM_CUT_N))
    launches = add_launches(launches, more)
    with torch.no_grad():
        ref, f32 = (assimilated(cast_to(cpu, dt), STREAM_CUT_N)
                    for dt in (torch.float64, torch.float32))
    check_quantities(f"14d assimilate n={STREAM_CUT_N} vs cpu f64", got, ref, f32, TOL_E2E_POST)

    n_full = (NUM_DATA // STREAM_CHUNK) * STREAM_CHUNK
    states = {}

    def stream(cast, chunk, keep_full=False):
        p, Xc, yc = cast(params), cast(X), cast(y)
        s = streaming.init_state(spec, Xc.dtype, Xc.device)
        for lo in range(0, NUM_DATA, chunk):
            if keep_full and lo == n_full:
                states["full chunks"] = s
            s = streaming.assimilate(spec, p, s, Xc[lo:lo + chunk], yc[lo:lo + chunk])
        return s

    n_chunks = -(-NUM_DATA // STREAM_CHUNK)
    s32, ms, more = p14_call(f"14d stream f32, {n_chunks} chunks of {STREAM_CHUNK}",
                             lambda: stream(c32, STREAM_CHUNK, keep_full=True))
    launches = add_launches(launches, more)
    timings["p14_stream_f32_ms_per_chunk"] = ms / n_chunks
    timings["p14_stream_f32_points_per_s"] = NUM_DATA / (ms / 1e3)
    p32 = c32(params)
    scan, ms_scan, more = p14_call(
        f"14d assimilate_scan f32, {n_full // STREAM_CHUNK} chunks",
        lambda: streaming.assimilate_scan(
            spec, p32, streaming.init_state(spec, torch.float32, device),
            X[:n_full].reshape(-1, STREAM_CHUNK, 2), y[:n_full].reshape(-1, STREAM_CHUNK)))
    launches = add_launches(launches, more)
    timings["p14_scan_f32_ms_per_chunk"] = ms_scan / (n_full // STREAM_CHUNK)
    e_scan = max(rel_err(scan[k], states["full chunks"][k]) for k in ("lam", "eta", "n_seen"))
    print(f"check 14d assimilate_scan against the loop over the same chunks: {e_scan:.3e}")
    check(e_scan <= TOL_F32, f"14d assimilate_scan vs the loop {e_scan}")
    s64, ms64, more = p14_call(f"14d stream f64, chunks of {STREAM_CHUNK}",
                               lambda: stream(c64, STREAM_CHUNK))
    launches = add_launches(launches, more)
    timings["p14_stream_f64_ms_per_chunk"] = ms64 / n_chunks
    big, _, more = p14_call(f"14d stream f64, chunks of {STREAM_BIG_CHUNK}",
                            lambda: stream(c64, STREAM_BIG_CHUNK))
    launches = add_launches(launches, more)
    e_id = max(rel_err(big[k], s64[k]) for k in ("lam", "eta"))
    print(f"check 14d f64 chunks of {STREAM_BIG_CHUNK} vs {STREAM_CHUNK}: Λ, η {e_id:.3e} "
          f"(tol {TOL_STREAM_IDENTITY:.0e})")
    check(e_id <= TOL_STREAM_IDENTITY, f"14d chunking identity {e_id}")
    check(float(s64["n_seen"]) == NUM_DATA, f"14d n_seen {float(s64['n_seen'])}")

    def handoff(cast, s):
        p, pn = cast(params), cast(params_new)
        r = streaming.reanchor(spec, p, pn, streaming.forget(s, STREAM_RHO))
        return {"q_v": svgp.q_v(spec, streaming.to_params(spec, p, s), own),
                "q_v after reanchor": svgp.q_v(spec, streaming.to_params(spec, pn, r), own)}

    h32, ms_h, more = p14_call("14d forget, reanchor, to_params -> q_v f32",
                               lambda: handoff(c32, s32))
    launches = add_launches(launches, more)
    timings["p14_handoff_f32_ms"] = ms_h
    h64, _, more = p14_call("14d forget, reanchor, to_params -> q_v f64",
                            lambda: handoff(c64, s64))
    launches = add_launches(launches, more)
    reading = {k: quantity_err(s32[k], s64[k]) for k in ("lam", "eta")}
    reading.update({k: quantity_err(h32[k], h64[k]) for k in h64})
    print(f"check 14d the f32 stream of {NUM_DATA} points vs the card's f64: {reading} "
          f"(tol {TOL_STREAM_F32})")
    for k, e in reading.items():
        check(e <= TOL_STREAM_F32[k], f"14d f32 stream {k}: {e} > {TOL_STREAM_F32[k]}")
    timings["p14_stream_f32_vs_f64"] = reading

    spec_p = dataclasses.replace(spec, likelihood="poisson")
    t = likelihood_targets("poisson", X, y, seed=21)     # phase 9's (20 + its index)

    def natgrad(cast, n):
        p, Xc, tc = cast(params), cast(X[:n]), cast(t[:n])
        s = streaming.init_state(spec_p, Xc.dtype, Xc.device)
        return streaming.assimilate_natgrad(spec_p, p, s, Xc, tc)

    nat, ms_n, more = p14_call(f"14d assimilate_natgrad poisson f32 n={NATGRAD_N}",
                               lambda: natgrad(c32, NATGRAD_N))
    launches = add_launches(launches, more)
    timings["p14_natgrad_f32_ms"] = ms_n
    ev = torch.linalg.eigvalsh(nat["lam"].double())
    lam_min, lam_max = float(ev[0]), float(ev[-1])
    print(f"check 14d natgrad: λ of Λ in [{lam_min:.6f}, {lam_max:.6g}] (log-concave sites "
          f"keep Λ ⪰ I; float32 rounding allowed 1e-4·λ_max)")
    check(lam_min >= 1.0 - 1e-4 * lam_max, f"14d natgrad λ_min {lam_min}, λ_max {lam_max}")
    got, _, more = p14_call(f"14d assimilate_natgrad poisson f32 n={P14_CUT_N}",
                            lambda: natgrad(c32, P14_CUT_N))
    launches = add_launches(launches, more)
    with torch.no_grad():
        ref, f32 = (natgrad(cast_to(cpu, dt), P14_CUT_N) for dt in (torch.float64, torch.float32))
    check_quantities(f"14d natgrad n={P14_CUT_N} vs cpu f64", got, ref, f32, TOL_E2E_POST)
    return launches


def sampler_stream_phase(device, X, y, Xs, models) -> tuple:
    """Phase 14: cell_kuf against its plain version at P14_NEW_SHAPES, then
    14a–14d on the models of the earlier phases (``models``: "main",
    "matern32 svgp", "matern32 collapsed", "collapsed", "exact", "fitted",
    "full2d"). Every shape the phase launches must have been held against
    the plain version. Returns (launches, timings, the float32 errors by
    (name, m, n), cell_kuf's launches by (m, n))."""
    import torch

    timings = {}
    Xm, _, Xsm = make_data_multioutput(device)
    n_full = (NUM_DATA // STREAM_CHUNK) * STREAM_CHUNK
    n_big = (NUM_DATA // STREAM_BIG_CHUNK) * STREAM_BIG_CHUNK
    points = {(FULL_CELLS, STREAM_CHUNK): X[:STREAM_CHUNK, 0],
              (FULL_CELLS, NUM_DATA % STREAM_CHUNK): X[n_full:, 0],
              (FULL_CELLS, NUM_DATA % STREAM_BIG_CHUNK): X[n_big:, 0],
              (FULL_CELLS, STREAM_CUT_N): X[:STREAM_CUT_N, 0],
              (ICM_CELLS, SERVE_POINTS): Xsm[:, 0],
              (SUM_CELLS[0], SERVE_POINTS): Xs[:, 0], (SUM_CELLS[1], SERVE_POINTS): Xs[:, 1]}
    errs = check_kernels_at(device, tuple((m, points[m, n], None) for m, n in P14_NEW_SHAPES),
                            "14")
    P14_SHAPE_LAUNCHES.clear()
    launches = dict(NO_LAUNCHES)
    for name, part in (
            ("main_draws_part", lambda: main_draws_part(device, Xs, models["main"], timings)),
            ("gradient_draws_part", lambda: gradient_draws_part(
                device, X, y, Xs, models["matern32 svgp"], models["matern32 collapsed"],
                timings)),
            ("family_draws_part", lambda: family_draws_part(
                device, X, y, Xs, models["collapsed"], models["exact"], models["fitted"],
                timings)),
            ("streaming_part", lambda: streaming_part(device, X, y, models["full2d"], timings))):
        t0 = time.perf_counter()
        launches = add_launches(launches, part())
        timings[f"{name}_s"] = time.perf_counter() - t0
        print(f"{name}: {timings[f'{name}_s']:.1f} s")
    at = {(m, n): c for (name, m, n), c in P14_SHAPE_LAUNCHES.items() if name == "cell_kuf"}
    finv_at = {(m, n): c for (name, m, n), c in P14_SHAPE_LAUNCHES.items() if name == "m12_finv"}
    print(f"phase 14's cell_kuf launches by shape: {at}; the other kernels: "
          f"{ {k: v for k, v in P14_SHAPE_LAUNCHES.items() if k[0] != 'cell_kuf'} }")
    check(sum(v for k, v in P14_SHAPE_LAUNCHES.items() if k[0] in NO_LAUNCHES)
          == sum(launches.values()),
          f"phase 14: launches by shape {dict(P14_SHAPE_LAUNCHES)} vs {launches}")
    check(launches["cell_kuf"] == sum(at.values()) and set(at) <= set(P14_NEW_SHAPES)
          | set(P14_HELD_SHAPES), f"phase 14 launched a shape never held against plain: {at}")
    check(all(m == n and (dt, m) in FINV_HELD for m, n in finv_at for dt in ("float32", "float64")),
          f"phase 14 launched m12_finv at a shape never held against plain: {finv_at}")
    check(all(at.get(s, 0) > 0 for s in P14_NEW_SHAPES),
          f"phase 14: a new shape never launched: {at}")
    torch.cuda.synchronize()
    return launches, timings, errs, at


# --------------------------------------------------------------------------- #
# phase 15: hyperpost.py and the rest of train.py
# --------------------------------------------------------------------------- #

# 15a's 1-D case, ROADMAP queue 3, item 16's (tests/test_torch_sgpr.py's
# "1d"): 32 Matérn-1/2 cells on [0, 1], 200 points of sin(6x) + 0.05·N(0, 1)
# from numpy seed 0, σ² 1.3, ℓ 0.08, noise 0.02
P15_1D_CELLS = 32
P15_1D_N = 200
P15_1D_PARAMS = (1.3, 0.08, 0.02)
# the card's float64 Hessian of the 1-D case against the CPU's, the same
# function through the same route: roundoff only
TOL_H_CPU = 1e-10
# a full-width float64 Hessian against central differences (step
# P15_FD_STEP in the raw space) of the card's own float64 gradient, as a
# share of max|H|: the differences' truncation error is about h²·|f'''|/6,
# their rounding the gradient's (about 1e-13 relative) over 2h
P15_FD_STEP = 1e-4
TOL_H_FD = 1e-6
# the float32 Hessian of the 1-D case on the card against the CPU's
# float64, by the 2× rule against the CPU's float32 with this floor (as the
# heads' floor: its products are the heads'); the full-width float32
# Hessians against the card's float64 by the same bound (the CPU takes no
# float32 Hessian at that width; the JAX package's docstring calls the
# float32 H noise-limited on the TPU: on an H100 it read 3.2e-6 and 1.5e-6)
TOL_H_F32 = 1e-3
# 15b: fit_lbfgs on phase 7's model from its trained parameters; the 1-D
# case's float64 trajectory against the CPU's at TOL_LBFGS_CPU
LBFGS_ITERS = 20
TOL_LBFGS_CPU = 1e-8
# 15c: fit_natgrad on 11a's model, NATGRAD_STEPS minibatch steps at
# TRAIN_BATCH (γ NATGRAD_GAMMA, Adam at 1e-2), then one full-batch step at
# γ = 1 on SGPR_N points in float64, whose ELBO must equal the collapsed
# bound at TOL_NATGRAD_COLLAPSED (tests/test_natgrad.py:34)
NATGRAD_STEPS = 8
NATGRAD_GAMMA = 0.5
TOL_NATGRAD_COLLAPSED = 1e-6
# 15d: HMC on phase 7's model at SGPR_CUT_N points (cut from 65 536), 2
# chains, 24 warmup, 24 draws, 8 leapfrog steps (cut from 4 / 128 / 256 /
# 16 to fit about 900 gradients: one takes 45–60 ms there on an H100, and
# 32 + 32 steps, 1152 gradients, made phase 15 111 s); the draws' raw mean within
# TOL_HMC_MEAN_SDS Laplace sd/√S of the Laplace mean, each raw variance
# within a factor TOL_HMC_VAR of Laplace's, the accept rate in (0.5, 0.99]
HMC_CHAINS, HMC_WARMUP, HMC_DRAWS, HMC_LEAPFROG = 2, 24, 24, 8
HMC_FIT_ITERS = 30       # fit_lbfgs at the cut, float64, to the mode the Laplace state is taken at
TOL_HMC_MEAN_SDS = 5.0
TOL_HMC_VAR = 3.0
# the 1-D case's HMC on the card against the CPU's from one CPU generator
HMC_1D = dict(n_samples=16, n_chains=2, n_warmup=8, n_leapfrog=4)
TOL_HMC_CPU = 1e-8
# 15e: predict_marginalized at the SERVE_POINTS query points, MARG_SAMPLES
# draws; with chol_cov × MARG_SHRINK the mixture is the plug-in head
MARG_SAMPLES = 16
MARG_SHRINK = 1e-6
# 15f: fit_restarts on phase 8's exact GP
RESTARTS, RESTART_ITERS, RESTART_SPREAD = 4, 10, 0.5
TOL_RESTART_SEQ = 1e-6   # each restart against train.fit from its start: the same calls
CKPT_STEPS = 3
# 15f traces this many training steps (2 cell_kuf_with_dl launches each):
# phase 15 runs last, where a profiler window has kept as few as 3 of 20
# kernel launches on an H100, so the trace must name the kernel with most
# of its launches lost
P15_TRACE_STEPS = 16
# a resumed fit_minibatch takes the same losses: the same inputs through the
# same kernels; a reduction order that varied between calls would show here
TOL_CKPT_RESUME = 1e-6
# cell kernel shapes phase 15 launches first (held against the plain version
# before it runs), and those earlier phases held
P15_NEW_SHAPES = ((P15_1D_CELLS, P15_1D_N),)
P15_HELD_SHAPES = ((SGPR_CELLS, SGPR_N), (SGPR_CELLS, SGPR_CUT_N), (FULL_CELLS, TRAIN_BATCH),
                   (M_AXIS, TRAIN_BATCH), (SGPR_CELLS, SERVE_POINTS))


def p15_count(fn):
    """``fn()`` on the host clock (ending in synchronize) and its launches:
    the counts' growth over the call (phase 15 zeroes them once, before its
    parts, and reads them by shape after). Returns (the output, ms,
    launches)."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    before = cell_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {k: ck.LAUNCHES[k] - before[k] for k in before}


def p15_case_1d(device, dtype):
    """15a's 1-D collapsed case on ``device`` in ``dtype``: (spec, params,
    loss)."""
    import numpy as np
    import torch

    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, sgpr

    rng = np.random.default_rng(0)
    x = rng.random(P15_1D_N)
    y = np.sin(6 * x) + 0.05 * rng.standard_normal(P15_1D_N)
    spec = SGPRSpec(kinds=("matern12",),
                    features=(CellIntegralFeature.from_lims(P15_1D_CELLS, 0.0, 1.0),))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    var, ell, noise = P15_1D_PARAMS
    params = {"axes": ({"variance": t(var), "lengthscale": t(ell)},), "noise": t(noise)}
    X, Y = t(x), t(y)
    return spec, params, lambda p: sgpr.loss(spec, p, X, Y)


def fd_hessian(loss_fn, flat, unravel, h=P15_FD_STEP):
    """Central differences of the first-order gradient of
    ``loss_fn(constrain(unravel(v)))`` at ``flat``, symmetrized."""
    import torch

    from vggp_tpu_torch import train

    def grad(v):
        v = v.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(train.constrain(unravel(v))), v)
        return g

    cols = []
    for i in range(flat.shape[0]):
        e = torch.zeros_like(flat)
        e[i] = h
        cols.append((grad(flat + e) - grad(flat - e)) / (2 * h))
    H = torch.stack(cols, 1)
    return 0.5 * (H + H.T)


def second_order_part(device, collapsed, exact_model, X, y, timings) -> dict:
    """15a: the Hessian of ``hyperpost.laplace`` through
    ``models.common.second_order()``: the 1-D case on the card against the
    CPU in float64 and float32 (the 2× rule); phase 7's trained model at its
    full width (64² cells, SGPR_N points) and phase 8's exact GP in float64
    against central differences of the card's own float64 gradient, their
    float32 H against float64 by the 1-D case's bound. Returns the
    readings."""
    import torch

    from vggp_tpu_torch import exact, hyperpost, sgpr

    cpu = torch.device("cpu")
    out = {}
    H = {}
    for where, dev, dt in (("card", device, torch.float64), ("cpu", cpu, torch.float64),
                           ("card", device, torch.float32), ("cpu", cpu, torch.float32)):
        _, p, loss = p15_case_1d(dev, dt)
        (h, _, _), ms, got = p15_count(lambda: hyperpost.raw_hessian(loss, p))
        H[where, dt] = h.double().cpu()
        if where == "card":
            check(got["cell_kuf"] > 0 and got["cell_kuf_with_dl"] == 0,
                  f"15a 1-D Hessian launches {got}")
            print(f"15a 1-D Hessian ({dt}): {ms:.1f} ms, launches {got}")
    ref = H["cpu", torch.float64]
    e64 = rel_err(H["card", torch.float64], ref)
    e32, c32 = rel_err(H["card", torch.float32], ref), rel_err(H["cpu", torch.float32], ref)
    tol32 = max(TOL_H_F32, CPU_ERR_RATIO * c32)
    print(f"check 15a 1-D Hessian: card f64 vs cpu f64 {e64:.3e} (tol {TOL_H_CPU}); card f32 "
          f"{e32:.3e}, cpu f32 {c32:.3e}, tol {tol32:.3e}; H_ll {float(ref[0, 0]):.6g}, "
          f"H_ss {float(ref[1, 1]):.6g}")
    check(e64 <= TOL_H_CPU, f"15a 1-D Hessian card f64 {e64}")
    check(e32 <= tol32, f"15a 1-D Hessian card f32 {e32} > {tol32}")
    out["1d"] = {"f64": e64, "f32": e32, "cpu_f32": c32}
    spec7, p7 = collapsed
    espec, pe = exact_model
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    Xe, ye = X[:EXACT_N], y[:EXACT_N]
    for name, loss, params in (
            ("phase 7 collapsed", lambda c: (lambda p: sgpr.loss(spec7, p, c(Xn), c(yn))), p7),
            ("phase 8 exact", lambda c: (lambda p: exact.loss(espec, p, c(Xe), c(ye))), pe)):
        to64, to32 = cast_to(device, torch.float64), cast_to(device, torch.float32)
        (h64, flat, unravel), ms, got = p15_count(lambda: hyperpost.raw_hessian(loss(to64),
                                                                                to64(params)))
        t0 = time.perf_counter()
        hfd = fd_hessian(loss(to64), flat, unravel)
        fd_s = time.perf_counter() - t0
        (h32, _, _), ms32, _ = p15_count(lambda: hyperpost.raw_hessian(loss(to32),
                                                                       to32(params)))
        efd = rel_err(h64.cpu(), hfd.cpu())
        r32 = rel_err(h32.double().cpu(), h64.cpu())
        w = torch.linalg.eigvalsh(0.5 * (h64 + h64.T)).cpu()
        print(f"check 15a {name} Hessian (p = {flat.shape[0]}) f64: {ms:.1f} ms, launches "
              f"{got}; against central differences of its gradient ({fd_s:.1f} s) {efd:.3e} "
              f"of max|H| {float(h64.abs().max()):.4g} (tol {TOL_H_FD}); eigenvalues "
              f"{w.numpy().round(3).tolist()}; f32 H {ms32:.1f} ms, {r32:.3e} from f64 "
              f"(tol {tol32:.3e}, the 1-D case's rule)")
        check(efd <= TOL_H_FD, f"15a {name} Hessian vs central differences {efd}")
        check(r32 <= tol32, f"15a {name} f32 Hessian {r32} > {tol32}")
        tag = name.split()[-1]
        timings[f"p15_hessian_{tag}_ms_f64"] = ms
        timings[f"p15_hessian_{tag}_ms_f32"] = ms32
        out[tag] = {"fd": efd, "f32_vs_f64": r32}
    return out


def lbfgs_part(device, collapsed, X, y, timings) -> dict:
    """15b: ``fit_lbfgs`` LBFGS_ITERS iterations on phase 7's model at its
    full width from its trained parameters, float32 and float64 (the
    float32 final loss within TOL_E2E_LOSS of float64's), with the loss
    evaluations an iteration and ms an iteration; the 1-D case's float64
    trajectory on the card against the CPU's at TOL_LBFGS_CPU."""
    import torch

    from vggp_tpu_torch import sgpr, train

    spec, params = collapsed
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    out = {}
    for dt in (torch.float32, torch.float64):
        c = cast_to(device, dt)
        Xc, yc, evals = c(Xn), c(yn), [0]

        def loss(p):
            evals[0] += 1
            return sgpr.loss(spec, p, Xc, yc)

        (_, hist), ms, got = p15_count(lambda: train.fit_lbfgs(loss, c(params), LBFGS_ITERS))
        losses = hist["loss"].double().cpu()
        tag = "f32" if dt == torch.float32 else "f64"
        out[tag] = float(losses[-1])
        print(f"15b fit_lbfgs phase 7 {tag}: {LBFGS_ITERS} iterations, loss "
              f"{float(losses[0]):.8g} -> {float(losses[-1]):.8g}, {evals[0]} loss evaluations "
              f"({evals[0] / LBFGS_ITERS:.2f} an iteration), {ms / LBFGS_ITERS:.1f} ms an "
              f"iteration, launches {got}")
        check(bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0]),
              f"15b fit_lbfgs {tag}: {losses}")
        check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": 2 * evals[0]},
              f"15b fit_lbfgs {tag} launches {got} for {evals[0]} evaluations")
        timings[f"p15_lbfgs_ms_per_iter_{tag}"] = ms / LBFGS_ITERS
        timings[f"p15_lbfgs_evals_per_iter_{tag}"] = evals[0] / LBFGS_ITERS
    e = abs(out["f32"] - out["f64"]) / abs(out["f64"])
    print(f"check 15b fit_lbfgs final loss f32 vs f64: {e:.3e} (tol {TOL_E2E_LOSS})")
    check(e <= TOL_E2E_LOSS, f"15b fit_lbfgs f32 final loss {e}")
    hists = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        _, p, loss = p15_case_1d(dev, torch.float64)
        (fin, hist), _, _ = p15_count(lambda: train.fit_lbfgs(loss, p, LBFGS_ITERS))
        hists[where] = ({k: v.cpu() for k, v in hist.items()},
                        [v.cpu() for v in train.sorted_leaves(fin)])
    e = max(max(rel_err(hists["card"][0][k], hists["cpu"][0][k]) for k in hists["cpu"][0]),
            max(rel_err(a, b) for a, b in zip(hists["card"][1], hists["cpu"][1])))
    print(f"check 15b 1-D fit_lbfgs f64 trajectory card vs cpu: {e:.3e} (tol {TOL_LBFGS_CPU}), "
          f"loss {float(hists['cpu'][0]['loss'][0]):.8g} -> {float(hists['cpu'][0]['loss'][-1]):.8g}")
    check(e <= TOL_LBFGS_CPU, f"15b 1-D fit_lbfgs trajectory {e}")
    out["1d_traj"] = e
    return out


def natgrad_part(device, full2d, X, y, timings) -> dict:
    """15c: ``fit_natgrad`` on 11a's model (64² cells, m = 4096, the full
    family, a learned mean; its trained hyperparameters, q from the prior):
    NATGRAD_STEPS minibatch steps at TRAIN_BATCH in
    float32 (cell_kuf_with_dl twice a step, the loss finite and falling), then
    one full-batch step at γ = 1 with the hyperparameters frozen on SGPR_N
    points in float64, whose ELBO must equal ``sgpr.elbo`` on the same
    cells, points and hyperparameters."""
    import dataclasses

    import torch

    from vggp_tpu_torch import SGPRSpec, sgpr, svgp, train

    spec, trained = full2d
    # 11a's hyperparameters with q at the spec's start (μ = 0, S = I): the
    # natural parameters of 11a's Adam-trained q need S⁻¹, whose factor
    # (a 4096² triangle moved entrywise by Adam) float32 cannot invert
    params = {**trained, "q": spec.init_params(torch.float32, device)["q"]}
    (fin, hist), ms, got = p15_count(lambda: train.fit_natgrad(
        spec, params, X, y, NATGRAD_STEPS, gamma=NATGRAD_GAMMA, hyper_lr=1e-2,
        batch_size=TRAIN_BATCH, seed=15))
    losses = [float(v) for v in hist["loss"]]
    print(f"15c fit_natgrad 11a: {NATGRAD_STEPS} steps at {TRAIN_BATCH}, loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, {ms / NATGRAD_STEPS:.1f} ms a step, launches {got}")
    check(all(v == v and abs(v) != float("inf") for v in losses), f"15c losses {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"15c: the loss did not fall: {losses}")
    check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": 2 * NATGRAD_STEPS}, f"15c launches {got}")
    timings["p15_natgrad_ms_per_step"] = ms / NATGRAD_STEPS
    c = cast_to(device, torch.float64)
    Xn, yn = c(X[:SGPR_N]), c(y[:SGPR_N])
    full = dataclasses.replace(spec, num_data=SGPR_N)
    p64 = c(fin)

    def one():
        p1, _ = train.fit_natgrad(full, p64, Xn, yn, 1, gamma=1.0, hyper_lr=0.0)
        with torch.no_grad():
            return (svgp.elbo(full, p1, Xn, yn),
                    sgpr.elbo(SGPRSpec(kinds=spec.kinds, features=spec.features, learn_mean=True),
                              {k: p1[k] for k in ("axes", "noise", "mean")}, Xn, yn))

    (e_sv, e_col), ms, got = p15_count(one)
    e = abs(float(e_sv) - float(e_col)) / abs(float(e_col))
    print(f"check 15c one natgrad step (γ = 1, f64, {SGPR_N} points): ELBO {float(e_sv):.10g} vs "
          f"collapsed {float(e_col):.10g}, rel {e:.3e} (tol {TOL_NATGRAD_COLLAPSED}); "
          f"{ms:.1f} ms, launches {got}")
    check(e <= TOL_NATGRAD_COLLAPSED, f"15c natgrad vs collapsed bound {e}")
    return {"collapsed_rel": e}


def hmc_part(device, collapsed, X, y, timings) -> dict:
    """15d: ``hmc_sample_params`` on phase 7's model at SGPR_CUT_N points in
    float32 from its float64 Laplace state at the mode (``fit_lbfgs`` there
    first; 2 chains, 24 + 24 steps of 8 leapfrog steps), over the four
    hyperparameters the model identifies: the draws against the Laplace
    Gaussian and the accept rate; the 1-D case's HMC on the card against the CPU's, float64, one
    CPU generator seeded the same."""
    import torch

    from vggp_tpu_torch import hyperpost, sgpr, train

    spec, trained = collapsed
    c64, c32 = cast_to(device, torch.float64), cast_to(device, torch.float32)
    Xc, yc = X[:SGPR_CUT_N], y[:SGPR_CUT_N]
    # the product kernel identifies σ₁²σ₂² alone (a flat direction of the
    # Hessian at the mode, which HMC would random-walk along): axis 1's
    # variance is held at 1 and axis 0's carries the product
    ax0, ax1 = trained["axes"]
    params = {"axes": ({**ax0, "variance": ax0["variance"] * ax1["variance"]},),
              "axis_1": {"lengthscale": ax1["lengthscale"]}, "noise": trained["noise"]}

    def loss(c):
        X1, y1 = c(Xc), c(yc)

        def f(p):
            ax1 = {"variance": torch.ones_like(p["noise"]), **p["axis_1"]}
            return sgpr.loss(spec, {"axes": (p["axes"][0], ax1), "noise": p["noise"]}, X1, y1)

        return f
    # the Laplace Gaussian is the posterior's approximation at its mode: the
    # model at the cut, fitted there by L-BFGS in float64 first
    (mode, _), ms_fit, _ = p15_count(lambda: train.fit_lbfgs(loss(c64), c64(params),
                                                             HMC_FIT_ITERS))
    st, ms_l, _ = p15_count(lambda: hyperpost.laplace(loss(c64), mode))
    st32 = st._replace(mean=st.mean.float(), chol_cov=st.chol_cov.float(),
                       logdet_h=st.logdet_h.float())
    gen = torch.Generator(device=device)
    gen.manual_seed(15)
    n_grads = HMC_CHAINS * (HMC_WARMUP + HMC_DRAWS) * (HMC_LEAPFROG + 1)
    res, ms, got = p15_count(lambda: hyperpost.hmc_sample_params(
        loss(c32), st32, gen, n_samples=HMC_CHAINS * HMC_DRAWS, n_chains=HMC_CHAINS,
        n_warmup=HMC_WARMUP, n_leapfrog=HMC_LEAPFROG))
    raws = res.raw_draws.double().cpu()
    S = raws.shape[0]
    cov = (st.chol_cov @ st.chol_cov.T).cpu()
    sd = torch.sqrt(torch.diagonal(cov))
    mean_sds = float(((raws.mean(0) - st.mean.cpu()).abs() / (sd / S ** 0.5)).max())
    var_ratio = raws.var(0) / torch.diagonal(cov)
    acc = float(res.accept_rate)
    print(f"check 15d HMC phase 7 at {SGPR_CUT_N} points: {S} draws, {ms:.0f} ms "
          f"({ms / n_grads:.2f} ms a gradient, {n_grads} gradients), the mode by L-BFGS "
          f"{ms_fit:.0f} ms, Laplace {ms_l:.0f} ms; "
          f"accept {acc:.3f}, step sizes {res.step_size.cpu().numpy().round(4).tolist()}; the "
          f"raw mean at {mean_sds:.2f} Laplace sd/√S (tol {TOL_HMC_MEAN_SDS}), the variance "
          f"ratios {var_ratio.numpy().round(3).tolist()} (tol ×{TOL_HMC_VAR}); launches {got}")
    check(bool(torch.isfinite(raws).all()), "15d HMC draws not finite")
    check(0.5 < acc <= 0.99, f"15d HMC accept rate {acc}")
    check(mean_sds <= TOL_HMC_MEAN_SDS, f"15d HMC mean at {mean_sds} sd/√S")
    check(bool(((var_ratio <= TOL_HMC_VAR) & (var_ratio >= 1 / TOL_HMC_VAR)).all()),
          f"15d HMC variance ratios {var_ratio}")
    check(got["cell_kuf_with_dl"] > 0 and got["fused_banded_whiten_kuf"] == 0,
          f"15d HMC launches {got}")
    timings["p15_hmc_ms_per_gradient"] = ms / n_grads
    out = {"accept": acc, "mean_sds": mean_sds}
    runs = {}
    # one Laplace state for both (the eigenvectors' signs differ between
    # cuSOLVER and LAPACK, and with them the whitened coordinates)
    _, p, loss1 = p15_case_1d(torch.device("cpu"), torch.float64)
    st1 = hyperpost.laplace(loss1, p)
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        _, _, loss1 = p15_case_1d(dev, torch.float64)
        st_dev = st1._replace(mean=st1.mean.to(dev), chol_cov=st1.chol_cov.to(dev),
                              logdet_h=st1.logdet_h.to(dev))
        r, _, _ = p15_count(lambda: hyperpost.hmc_sample_params(
            loss1, st_dev, torch.Generator().manual_seed(7), **HMC_1D))
        runs[where] = r
    e = max(rel_err(runs["card"].raw_draws.cpu(), runs["cpu"].raw_draws),
            rel_err(runs["card"].step_size.cpu(), runs["cpu"].step_size),
            rel_err(runs["card"].accept_rate.cpu(), runs["cpu"].accept_rate))
    print(f"check 15d 1-D HMC card vs cpu (f64, one CPU generator): {e:.3e} (tol {TOL_HMC_CPU}), "
          f"accept {float(runs['cpu'].accept_rate):.3f}")
    check(e <= TOL_HMC_CPU, f"15d 1-D HMC card vs cpu {e}")
    out["1d"] = e
    return out


def marginalized_part(device, collapsed, X, y, Xs, timings) -> dict:
    """15e: ``predict_marginalized`` (the posterior at the SERVE_POINTS
    points, MARG_SAMPLES draws) and ``log_evidence_laplace`` on phase 7's
    model at its full width: with chol_cov × MARG_SHRINK the mixture is the
    plug-in head within the heads' floor; the true state's variance read
    against the plug-in one; the log evidence in float32 against
    float64."""
    import torch

    from vggp_tpu_torch import hyperpost, sgpr

    spec, params = collapsed
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    ev = {}
    for dt in (torch.float64, torch.float32):
        c = cast_to(device, dt)
        loss = lambda p: sgpr.loss(spec, p, c(Xn), c(yn))
        st, _, _ = p15_count(lambda: hyperpost.laplace(loss, c(params)))
        ev[dt] = float(hyperpost.log_evidence_laplace(loss, c(params), st))
        if dt == torch.float32:
            state = st
    e_ev = abs(ev[torch.float32] - ev[torch.float64]) / abs(ev[torch.float64])
    print(f"check 15e log evidence f32 {ev[torch.float32]:.8g} vs f64 {ev[torch.float64]:.8g}: "
          f"{e_ev:.3e} (tol {TOL_E2E_LOSS})")
    check(e_ev <= TOL_E2E_LOSS, f"15e log evidence f32 vs f64 {e_ev}")
    predict = lambda p: sgpr.posterior(spec, p, Xn, yn, Xs, full_cov=False)
    gen = torch.Generator(device=device)
    with torch.no_grad():
        plug = predict(params)
        shrunk = state._replace(chol_cov=state.chol_cov * MARG_SHRINK)
        gen.manual_seed(5)
        m0, ms0, got0 = p15_count(lambda: hyperpost.predict_marginalized(predict, shrunk, gen,
                                                                         MARG_SAMPLES))
        gen.manual_seed(6)
        m1, ms1, got1 = p15_count(lambda: hyperpost.predict_marginalized(predict, state, gen,
                                                                         MARG_SAMPLES))
    e0 = gauss_err(m0, plug)
    ratio = (m1.var / plug.var).double().cpu()
    print(f"check 15e predict_marginalized S={MARG_SAMPLES} at {SERVE_POINTS} points: shrunk "
          f"state vs plug-in {e0:.3e} (tol {TOL_E2E_POST}), {ms0:.0f} ms, launches {got0}; the "
          f"true state's variance over the plug-in's: median {float(ratio.median()):.4f}, min "
          f"{float(ratio.min()):.4f}, max {float(ratio.max()):.4f} (a reading), {ms1:.0f} ms")
    check(e0 <= TOL_E2E_POST, f"15e shrunk marginalized vs plug-in {e0}")
    check(finite(m1) and bool((m1.var > 0).all()), "15e marginalized head")
    check(got0["cell_kuf"] == got1["cell_kuf"] == 4 * MARG_SAMPLES,
          f"15e launches {got0}, {got1}")
    timings["p15_marginalized_ms"] = ms1
    return {"shrunk": e0, "log_evidence": e_ev, "var_ratio_median": float(ratio.median())}


def rest_part(device, exact_model, main, X, y, timings) -> dict:
    """15f: ``fit_restarts`` on phase 8's exact GP (each restart against a
    sequential ``fit`` from its start, ``best`` the argmin); a checkpoint
    round trip of phase 4's trained 512² SVGP on the card (bitwise, and a
    resumed ``fit_minibatch`` taking the same losses); a ``profile_trace``
    of P15_TRACE_STEPS training steps, whose trace must name the
    cell_kuf_with_dl kernel."""
    import json as _json
    import os
    import shutil

    import torch

    from vggp_tpu_torch import exact, svgp, train

    espec, pe = exact_model
    Xe, ye = X[:EXACT_N], y[:EXACT_N]
    loss = lambda p: exact.loss(espec, p, Xe, ye)
    pb = train.init_restarts(pe, torch.Generator(device=device).manual_seed(3), RESTARTS,
                             RESTART_SPREAD)
    (best, hist), ms, _ = p15_count(lambda: train.fit_restarts(loss, pb, RESTART_ITERS, FIT_LR))
    final = hist["loss"][:, -1]
    worst = 0.0
    for r in range(RESTARTS):
        _, h = train.fit(loss, train.tree_map(lambda v: v[r], pb), RESTART_ITERS, FIT_LR)
        worst = max(worst, rel_err(hist["loss"][r], h["loss"]))
    print(f"check 15f fit_restarts exact GP: {RESTARTS} × {RESTART_ITERS}, {ms:.0f} ms, final "
          f"losses {final.cpu().numpy().round(3).tolist()}, best {hist['best']}; each restart "
          f"against a sequential fit {worst:.3e}")
    check(hist["loss"].shape == (RESTARTS, RESTART_ITERS), "15f restarts history shape")
    check(worst <= TOL_RESTART_SEQ, f"15f restart vs sequential fit {worst}")
    check(hist["best"] == int(torch.argmin(final)), f"15f best {hist['best']}")
    spec, model = main
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke_tree", "p15")
    shutil.rmtree(root, ignore_errors=True)
    params = train.tree_map(lambda v: v.detach().clone(), model.params())
    train.save_checkpoint(os.path.join(root, "ckpt"), params, step=7)
    back = train.load_checkpoint(os.path.join(root, "ckpt"), step=7, like=params,
                                 map_location=device)
    same = all(torch.equal(a, b) and a.device == b.device
               for a, b in zip(train.tree_leaves(params), train.tree_leaves(back), strict=True))
    mloss = lambda p, xb, yb: svgp.loss(spec, p, xb, yb)
    runs = [train.fit_minibatch(mloss, p, X, y, CKPT_STEPS, TRAIN_BATCH, seed=9)[1]["loss"]
            for p in (params, back)]
    e = rel_err(runs[0].double().cpu(), runs[1].double().cpu())
    print(f"check 15f checkpoint of phase 4's 512² SVGP: bitwise {same}; a resumed "
          f"fit_minibatch ({CKPT_STEPS} steps) against the original's losses {e:.3e} "
          f"(tol {TOL_CKPT_RESUME})")
    check(same, "15f checkpoint round trip not bitwise")
    check(e <= TOL_CKPT_RESUME, f"15f resumed losses differ by {e}")
    trace_dir = os.path.join(root, "trace")
    raw = train.raw_leaves_from(params)
    step = train.make_step_fn(mloss, raw, torch.optim.Adam(train.tree_leaves(raw), lr=1e-2))
    idx = torch.randint(0, X.shape[0], (TRAIN_BATCH,), generator=torch.Generator(
        device=device).manual_seed(4), device=device)

    def traced():
        with train.profile_trace(trace_dir):
            time.sleep(PROFILE_LEAD_S)     # as _profiled: the window's first ms can go unrecorded
            for _ in range(P15_TRACE_STEPS):
                step(X[idx], y[idx])

    _, ms, got = p15_count(traced)
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    names = set()
    for f in files:
        with open(os.path.join(trace_dir, f)) as fh:
            names |= {str(e.get("name", "")) for e in _json.load(fh).get("traceEvents", [])}
    hit = sorted(n for n in names if _DEVICE_KERNELS["cell_kuf_with_dl"] in n)
    print(f"check 15f profile_trace: {len(files)} trace file(s), {len(names)} event names, "
          f"cell_kuf_with_dl's kernel {hit[:1]}; the step's launches {got}")
    check(len(files) == 1 and hit, "15f profile_trace: the trace names no cell_kuf_with_dl kernel")
    check(got == {**NO_LAUNCHES, "cell_kuf_with_dl": 2 * P15_TRACE_STEPS},
          f"15f traced steps' launches {got}")
    shutil.rmtree(root, ignore_errors=True)
    return {"restart_vs_sequential": worst}


def hyperpost_phase(device, X, y, Xs, models) -> tuple:
    """Phase 15: both cell kernels against their plain versions at
    P15_NEW_SHAPES, then 15a–15f on the earlier phases' models (``models``:
    "main", "collapsed", "exact", "full2d"). Every shape the phase launches
    must have been held against the plain version, and both cell kernels
    must be launched. Returns (launches, timings, the float32 errors by
    (name, m, n), the launches by (name, m, n), the readings)."""
    import numpy as np
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    timings, readings = {}, {}
    x1 = torch.as_tensor(np.random.default_rng(0).random(P15_1D_N), dtype=torch.float32,
                         device=device)
    errs = check_kernels_at(device, ((P15_1D_CELLS, x1, None),), "15")
    ck.reset_launch_counts()
    for name, part in (
            ("second_order", lambda: second_order_part(device, models["collapsed"],
                                                       models["exact"], X, y, timings)),
            ("lbfgs", lambda: lbfgs_part(device, models["collapsed"], X, y, timings)),
            ("natgrad", lambda: natgrad_part(device, models["full2d"], X, y, timings)),
            ("hmc", lambda: hmc_part(device, models["collapsed"], X, y, timings)),
            ("marginalized", lambda: marginalized_part(device, models["collapsed"], X, y, Xs,
                                                       timings)),
            ("rest", lambda: rest_part(device, models["exact"], models["main"], X, y, timings))):
        t0 = time.perf_counter()
        readings[name] = part()
        timings[f"p15_{name}_s"] = time.perf_counter() - t0
        print(f"15 {name}: {timings[f'p15_{name}_s']:.1f} s")
    at = cell_shape_launches()
    launches = cell_launches()
    print(f"phase 15's launches by shape: {at}")
    allowed = set(P15_NEW_SHAPES) | set(P15_HELD_SHAPES)
    check(all((m, n) in allowed for _, m, n in at), f"phase 15 launched a shape never held "
          f"against plain: {sorted(k for k in at if k[1:] not in allowed)}")
    check(launches["cell_kuf"] > 0 and launches["cell_kuf_with_dl"] > 0,
          f"phase 15: a cell kernel never launched: {launches}")
    check(all(at.get((k, *s), 0) > 0 for s in P15_NEW_SHAPES
              for k in ("cell_kuf", "cell_kuf_with_dl")), f"phase 15: a new shape never launched")
    torch.cuda.synchronize()
    return launches, timings, errs, at, readings


# --------------------------------------------------------------------------- #
# phase 18: the object facade (api.GP, api.SVGP, api.Streaming) on the card
# --------------------------------------------------------------------------- #

P18_STEPS = 8             # 18a at batch 4096 (cell_kuf_with_dl twice a step)
P18_FUSED_STEPS = 4       # 18a at batch 16 384 (the fused kernel twice a step)
P18_ICM_STEPS = 4         # 18b at batch 4096 (cell_kuf twice a step: the dense route)
P18_SAMPLES = 16          # 18a and 18b: sample_q_v
P18_FEATURES = 2048
P18_COLLAPSED_STEPS = 6   # 18c, full batch on SGPR_N points
P18_STREAM_CHUNKS = 4     # 18d, chunks of STREAM_CHUNK
P18_LR = 1e-2             # phase 4's learning rate (its seed, 0, seeds every fit)
P18_SEED = 18             # the draws' generator
# the facade does no arithmetic: its results are the functional calls', the
# same kernels on the same inputs; this bound leaves float32 roundoff room
TOL_FACADE = 1e-6
P18_SHAPE_LAUNCHES = collections.Counter()


def p18_held_shapes() -> set:
    """(kernel, m, n) of every launch phase 18 may make: the shapes phases 3
    and 14 held against the plain version."""
    return {("cell_kuf_with_dl", M_AXIS, TRAIN_BATCH), ("cell_kuf", M_AXIS, TRAIN_BATCH),
            ("fused_banded_whiten_kuf", M_AXIS, FUSED_BATCH), ("cell_kuf", M_AXIS, SERVE_POINTS),
            ("cell_kuf", M_AXIS, M_AXIS + 1), ("cell_kuf_with_dl", SGPR_CELLS, SGPR_N),
            ("cell_kuf", SGPR_CELLS, SGPR_N), ("cell_kuf", SGPR_CELLS, SGPR_CELLS + 1),
            ("cell_kuf", FULL_CELLS, STREAM_CHUNK)}


def _p18_tensors(out) -> list:
    """The tensors of a facade result: a tensor, a Gaussian, a PSD factor,
    or a dict, tuple or list of them."""
    from vggp_tpu_torch.models.common import Gaussian

    if isinstance(out, Gaussian):
        return [t for t in (out.mean, out.cov, out.var) if t is not None]
    if hasattr(out, "F"):
        return [out.F]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _p18_tensors(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _p18_tensors(v)]
    return [out]


def hold_pair(phase, what, first, second, sides, shapes, tol, want=None, no_grad=True,
              repeat=True) -> tuple:
    """A call and the calls it stands for (``second``, under no_grad with
    ``no_grad``), each on the host clock (ending in synchronize) with its
    launches counted (reset just before, read just after), in turns first,
    second and, with ``repeat`` (a call that can run twice), again, so the
    second pair's times are warm. ``sides`` names the two; every ``first``
    call's launches by shape join ``shapes``. Each call of the pair launches
    the same kernels (``want`` where given); the last outputs are finite and
    agree within ``tol`` (max|Δ|/max|ref| of each tensor). Returns (the
    first's output, the second's, the first's launches over its calls, the
    readings)."""
    import contextlib

    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    a, b = sides
    runs = {a: [], b: []}
    total = dict(NO_LAUNCHES)
    for _ in range(2 if repeat else 1):
        for side, fn, ctx in ((a, first, contextlib.nullcontext()),
                              (b, second,
                               torch.no_grad() if no_grad else contextlib.nullcontext())):
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                out = fn()
            torch.cuda.synchronize()
            got = cell_launches()
            runs[side].append((out, (time.perf_counter() - t0) * 1e3, got))
            if side == a:
                shapes.update(cell_shape_launches())
                total = add_launches(total, got)
        check(runs[a][-1][2] == runs[b][-1][2],
              f"{phase} {what}: {a} launches {runs[a][-1][2]}, {b} {runs[b][-1][2]}")
        check(want is None or runs[a][-1][2] == {**NO_LAUNCHES, **want},
              f"{phase} {what}: launches {runs[a][-1][2]}, expected {want}")
    got, ref = runs[a][-1][0], runs[b][-1][0]
    gt, rt = _p18_tensors(got), _p18_tensors(ref)
    check(len(gt) == len(rt) and all(g.shape == r.shape for g, r in zip(gt, rt)),
          f"{phase} {what}: the {a} output does not match the {b} one's in structure")
    err = max(rel_err(g.double(), r.double()) for g, r in zip(gt, rt))
    ms = {side: [r[1] for r in runs[side]] for side in runs}
    print(f"check {phase} {what}: host ms {a} " + "/".join(f"{t:.3f}" for t in ms[a])
          + f", {b} " + "/".join(f"{t:.3f}" for t in ms[b])
          + f", rel {err:.3e} (tol {tol:.0e}), launches {runs[a][-1][2]}")
    check(all(bool(torch.isfinite(t).all()) for t in gt), f"{phase} {what}: not finite")
    check(err <= tol, f"{phase} {what}: {a} vs {b} {err} > {tol}")
    return got, ref, total, {f"{a}_ms": ms[a], f"{b}_ms": ms[b], "rel": err}


def p18_pair(what, facade, functional, want=None, no_grad=True, repeat=True) -> tuple:
    """:func:`hold_pair` of a facade call and the functional calls it stands
    for, within TOL_FACADE, the facade's launches by shape into
    P18_SHAPE_LAUNCHES."""
    return hold_pair("18", what, facade, functional, ("facade", "functional"),
                     P18_SHAPE_LAUNCHES, TOL_FACADE, want, no_grad, repeat)


def facade_phase(device, X, y, Xs, models) -> tuple:
    """Phase 18: the object facade, every call through ``vggp_tpu_torch.api``
    with no device named (so on the card), on phase 4's data at its
    learning rate and seed, each held by :func:`p18_pair` against the
    functional calls it stands for. (a) ``SVGP.gridded`` at the main path's
    512² cells: ``fit`` P18_STEPS at 4096 then P18_FUSED_STEPS at 16 384
    (continuing), ``precompute`` and the warm ``predict``, ``q_v`` and
    ``q_dv``, ``q_v`` cold on a copy without the state, ``save`` and
    ``restore`` (bitwise), ``sample_q_v`` (bitwise); (b) ``SVGP.multioutput``
    (12a's model, a noise and a mean per output, on 12a's two-output data)
    ``fit`` P18_ICM_STEPS at 4096 and ``sample_q_v``, whose draws are the
    functional draws of the same params with the mean at 0 plus
    ``common.grid_mean`` (ROADMAP queue 3, item 14); (c) ``GP.gridded``
    (phase 7's model) on SGPR_N points: ``fit``, ``q_v``, ``q_dv``,
    ``solve_iterative``, ``q_v_mean_iterative``; (d) the full family with
    11a's trained params (``models["full2d"]``): ``streaming`` of
    P18_STREAM_CHUNKS chunks of STREAM_CHUNK and ``to_svgp().q_v()``. Every
    launch must be at a shape held against the plain version before.
    Returns (the facade's launches, timings, its launches by (name, m, n))."""
    import tempfile

    import torch

    from vggp_tpu_torch import api, iterative, sampling, sgpr, streaming, svgp, train
    from vggp_tpu_torch.models import common

    P18_SHAPE_LAUNCHES.clear()
    timings = {}
    launches = dict(NO_LAUNCHES)
    lims = ((0.0, 1.0), (0.0, 1.0))
    f32 = torch.float32

    def pair(what, facade, functional, want=None, no_grad=True, repeat=True):
        nonlocal launches
        got, ref, n, r = p18_pair(what, facade, functional, want, no_grad, repeat)
        launches = add_launches(launches, n)
        timings[f"p18 {what}"] = r
        return got, ref

    def gen():
        g = torch.Generator(device=device)
        g.manual_seed(P18_SEED)
        return g

    def fits(what, facade, loss, params, runs, X, y):
        """Facade fits against train.fit_minibatch continuing from
        ``params``, non-informatively initialised in the first fit as the
        facade's fresh params are: ``runs`` of (n_steps, batch, the kernel
        launched twice a step)."""
        ref = {}

        def functional(n_steps, batch):
            if not ref:
                ref["p"] = train.non_informative_init(params, X, y)
            ref["p"], _ = train.fit_minibatch(loss, ref["p"], X, y, n_steps, batch, P18_LR,
                                              seed=0)
            return ref["p"]

        for n_steps, batch, kernel in runs:
            pair(f"{what} fit {n_steps} steps at batch {batch}",
                 lambda n_steps=n_steps, batch=batch: facade.fit(
                     X, y, n_iters=n_steps, batch_size=batch, learning_rate=P18_LR,
                     seed=0).params,
                 lambda n_steps=n_steps, batch=batch: functional(n_steps, batch),
                 {kernel: 2 * n_steps}, no_grad=False, repeat=False)
            losses = [float(v) for v in facade.history["loss"]]
            print(f"{what} loss at batch {batch}: {losses[0]:.6g} -> {losses[-1]:.6g}")
        return ref["p"]

    # 18a: the main path through the facade
    t0 = time.perf_counter()
    m = api.SVGP.gridded((M_AXIS, M_AXIS), lims, num_data=NUM_DATA)
    spec, own = m.spec, m.spec.features
    check(m.device.type == device.type and spec.variational == "kron"
          and spec.kinds == ("matern12",) * 2 and m.params["noise"].dtype == f32,
          "18a: SVGP.gridded's spec, device or dtype")
    p = fits("18a SVGP", m, lambda q, xb, yb: svgp.loss(spec, q, xb, yb),
             spec.init_params(f32, device), ((P18_STEPS, TRAIN_BATCH, "cell_kuf_with_dl"),
                                             (P18_FUSED_STEPS, FUSED_BATCH,
                                              "fused_banded_whiten_kuf")), X, y)
    state = {}
    pair("18a precompute", lambda: m.precompute()._state,
         lambda: state.setdefault("st", svgp.precompute(spec, p)), {})
    st = state["st"]
    pair(f"18a predict {SERVE_POINTS} points warm", lambda: m.predict(Xs),
         lambda: svgp.posterior_from_state(spec, p, st, Xs), {"cell_kuf": 2})
    pair("18a q_v warm", lambda: m.q_v(), lambda: svgp.q_v_from_state(spec, p, st, own), {})
    pair("18a q_dv axis 0 warm", lambda: m.q_dv(axis=0),
         lambda: svgp.q_dv_from_state(spec, p, st, own, 0), {"cell_kuf": 1})
    cold = api.SVGP(spec, params=m.params)
    pair("18a q_v cold", lambda: cold.q_v(), lambda: svgp.q_v(spec, p, own), {})
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        m.save(root)
        back = api.SVGP.gridded((M_AXIS, M_AXIS), lims, num_data=NUM_DATA).restore(root)
        torch.cuda.synchronize()
        timings["p18 18a save and restore ms"] = (time.perf_counter() - t1) * 1e3
    same = all(torch.equal(a, b) and b.device.type == device.type for a, b in zip(
        train.sorted_leaves(m.params), train.sorted_leaves(back.params), strict=True))
    print(f"check 18a save and restore: bitwise {same}, "
          f"{timings['p18 18a save and restore ms']:.3f} ms")
    check(same, "18a: the restored params differ from the saved ones")
    got, ref = pair(f"18a sample_q_v S={P18_SAMPLES} F={P18_FEATURES}",
                    lambda: m.sample_q_v(gen(), n_samples=P18_SAMPLES, n_features=P18_FEATURES),
                    lambda: sampling.pathwise_q_v(spec, p, gen(), own, n_samples=P18_SAMPLES,
                                                  n_features=P18_FEATURES))
    check(torch.equal(got, ref), "18a: sample_q_v is not the functional draws bit for bit")
    timings["p18_18a_s"] = time.perf_counter() - t0

    # 18b: the item-14 repair at the main path's width
    t0 = time.perf_counter()
    Xm, ym, _ = make_data_multioutput(device)
    mo = api.SVGP.multioutput((M_AXIS, M_AXIS), lims, n_outputs=2, num_data=NUM_DATA,
                              per_output_noise=True)
    spec_mo = mo.spec
    ref_spec = icm_svgp_spec()
    check(spec_mo.kinds == ref_spec.kinds and spec_mo.learn_mean and spec_mo.per_output_noise
          and spec_mo.variational == "kron" and spec_mo.axis_m == ref_spec.axis_m,
          "18b: SVGP.multioutput is not 12a's model")
    p_mo = fits("18b SVGP.multioutput", mo, lambda q, xb, yb: svgp.loss(spec_mo, q, xb, yb),
                spec_mo.init_params(f32, device),
                ((P18_ICM_STEPS, TRAIN_BATCH, "cell_kuf"),), Xm, ym)
    p_zero = {**p_mo, "mean": torch.zeros_like(p_mo["mean"])}
    offset = common.grid_mean(spec_mo, p_mo, spec_mo.features)
    got, ref = pair(f"18b sample_q_v S={P18_SAMPLES} F={P18_FEATURES} against the zero-mean "
                    "draws plus grid_mean",
                    lambda: mo.sample_q_v(gen(), n_samples=P18_SAMPLES, n_features=P18_FEATURES),
                    lambda: sampling.pathwise_q_v(spec_mo, p_zero, gen(), spec_mo.features,
                                                  n_samples=P18_SAMPLES,
                                                  n_features=P18_FEATURES) + offset)
    print(f"18b learned means {p_mo['mean'].cpu().numpy().round(5).tolist()}: grid_mean in "
          f"[{float(offset.min()):.4e}, {float(offset.max()):.4e}], draws in "
          f"[{float(got.min()):.4e}, {float(got.max()):.4e}]")
    timings["p18_18b_s"] = time.perf_counter() - t0

    # 18c: the collapsed GriddedGP (phase 7's model) through api.GP
    t0 = time.perf_counter()
    Xn, yn = X[:SGPR_N], y[:SGPR_N]
    gp = api.GP.gridded((SGPR_CELLS, SGPR_CELLS), lims)
    spec_c = gp.spec
    own_c = spec_c.features
    fitted = {}

    def collapsed_fit():
        p0 = train.non_informative_init(spec_c.init_params(f32, device), Xn, yn)
        fitted["p"], _ = train.fit(lambda q: sgpr.loss(spec_c, q, Xn, yn), p0,
                                   P18_COLLAPSED_STEPS, P18_LR)
        return fitted["p"]

    pair(f"18c GP.fit {P18_COLLAPSED_STEPS} steps",
         lambda: gp.fit(Xn, yn, n_iters=P18_COLLAPSED_STEPS, learning_rate=P18_LR).params,
         collapsed_fit, {"cell_kuf_with_dl": 2 * P18_COLLAPSED_STEPS}, no_grad=False,
         repeat=False)
    pc = fitted["p"]
    pair("18c q_v", lambda: gp.q_v(), lambda: sgpr.q_v(spec_c, pc, Xn, yn, own_c, full_cov=False),
         {"cell_kuf": 2})
    pair("18c q_dv axis 0", lambda: gp.q_dv(axis=0),
         lambda: sgpr.q_dv(spec_c, pc, Xn, yn, own_c, 0, full_cov=False), {"cell_kuf": 3})
    _, w = pair("18c solve_iterative", lambda: gp.solve_iterative()._w,
                lambda: iterative.solve_w(spec_c, pc, Xn, yn))
    pair("18c q_v_mean_iterative", lambda: gp.q_v_mean_iterative(),
         lambda: iterative.q_v_mean_from_w(spec_c, pc, own_c, w), {})
    timings["p18_18c_s"] = time.perf_counter() - t0

    # 18d: streaming through the facade on 11a's trained model
    t0 = time.perf_counter()
    spec_f, p_f = models["full2d"]
    full = api.SVGP.gridded((FULL_CELLS, FULL_CELLS), lims, num_data=NUM_DATA,
                            variational="full", learn_mean=True)
    check(full.spec.kinds == spec_f.kinds and full.spec.variational == "full"
          and full.spec.learn_mean and full.spec.axis_m == spec_f.axis_m,
          "18d: SVGP.gridded(variational='full') is not 11a's model")
    stream = api.SVGP(full.spec, params=p_f).streaming()
    chunks = [(X[lo:lo + STREAM_CHUNK], y[lo:lo + STREAM_CHUNK])
              for lo in range(0, P18_STREAM_CHUNKS * STREAM_CHUNK, STREAM_CHUNK)]

    def facade_stream():
        for xc, yc in chunks:
            stream.assimilate(xc, yc)
        return stream.state

    def functional_stream():
        s = streaming.init_state(spec_f, f32, device)
        for xc, yc in chunks:
            s = streaming.assimilate(spec_f, p_f, s, xc, yc)
        return s

    _, s_ref = pair(f"18d Streaming.assimilate {P18_STREAM_CHUNKS} chunks of {STREAM_CHUNK}",
                    facade_stream, functional_stream, {"cell_kuf": 2 * P18_STREAM_CHUNKS},
                    repeat=False)
    check(stream.n_seen == P18_STREAM_CHUNKS * STREAM_CHUNK, f"18d n_seen {stream.n_seen}")
    pair("18d to_svgp().q_v()", lambda: stream.to_svgp().q_v(),
         lambda: svgp.q_v(spec_f, streaming.to_params(spec_f, p_f, s_ref), spec_f.features,
                          full_cov=False), {})
    timings["p18_18d_s"] = time.perf_counter() - t0

    at = dict(P18_SHAPE_LAUNCHES)
    print(f"phase 18's launches by shape: {at}")
    held = p18_held_shapes()
    check(all(k in held for k in at), f"phase 18 launched a shape never held against plain: "
          f"{sorted(k for k in at if k not in held)}")
    check(sum(at.values()) == sum(launches.values()),
          f"phase 18: launches by shape {at} vs {launches}")
    check(all(launches[k] > 0 for k in launches), f"phase 18: a kernel never launched: {launches}")
    return launches, timings, at


# --------------------------------------------------------------------------- #
# phase 19: the sharded main path (vggp_tpu_torch.parallel) at world size 1
# --------------------------------------------------------------------------- #

P19_STEPS = ((4, TRAIN_BATCH, "cell_kuf_with_dl"), (2, FUSED_BATCH, "fused_banded_whiten_kuf"))
P19_STREAM_CHUNKS = 4     # 19c, chunks of STREAM_CHUNK
P19_SEED = 19             # 19e's generator, and the step batches'
# every collective of a world of one is an identity, so each sharded result
# is expected to equal the unsharded one bit for bit; this bound leaves
# float32 roundoff room
TOL_P19 = 1e-6
P19_MAX_S = 60.0
P19_SHAPE_LAUNCHES = collections.Counter()


def parallel_phase(device, X, y, models, card) -> tuple:
    """Phase 19: the sharded main path through ``vggp_tpu_torch.parallel`` on
    a world-1 NCCL group (a FileStore in a temporary directory: no network,
    no port) with the meshes ("data",) and ("data", "model") on the card,
    each sharded call held by :func:`hold_pair` against the unsharded port
    call it stands for: (a) P19_STEPS of ``make_sharded_svgp_step`` from
    phase 4's model (``models["main"]``) at its learning rate, on batches
    drawn from one seed, the losses and every raw leaf; (b)
    ``make_sharded_qv`` on its 512² cells; (c) ``make_sharded_assimilate``
    on 11a's model (``models["full2d"]``), P19_STREAM_CHUNKS chunks of
    STREAM_CHUNK; (d) ``make_sharded_solve_w`` (the same iterations) and
    the CG mean heads on 13a's model at MF_N points in float32 at
    MF_MAXITER; (e) ``make_sharded_pathwise_qv`` and ``_qdv`` on phase 7's
    model (``models["collapsed"]``) at MF_SAMPLES draws of MF_FEATURES at
    MF_DRAWS_N points and the samplers' MF_MAXITER, from one generator
    seed. Every launch must be at a
    shape an earlier phase launched and held against the plain version.
    Returns (the sharded side's launches, timings, its launches by (name,
    m, n))."""
    import tempfile

    import torch
    import torch.distributed as dist

    from vggp_tpu_torch import iterative, parallel, streaming, svgp, train

    t_phase = time.perf_counter()
    P19_SHAPE_LAUNCHES.clear()
    timings, launches = {}, dict(NO_LAUNCHES)
    f32 = torch.float32
    c32 = cast_to(device, f32)

    def pair(what, sharded, unsharded, want=None, no_grad=True, repeat=True):
        nonlocal launches
        got, ref, n, r = hold_pair("19", what, sharded, unsharded, ("sharded", "unsharded"),
                                   P19_SHAPE_LAUNCHES, TOL_P19, want, no_grad, repeat)
        launches = add_launches(launches, n)
        timings[f"p19 {what}"] = r
        return got, ref

    backend = parallel.mesh.BACKENDS[device.type]    # nccl on the card
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group(backend, store=dist.FileStore(f"{root}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh_d = parallel.make_mesh(("data",), (1,), device.type)
            mesh_dm = parallel.data_model_mesh(device_type=device.type)
            check(dist.get_backend() == backend and mesh_dm.mesh_dim_names == ("data", "model")
                  and mesh_dm.device_type == device.type,
                  f"19: the meshes are not {backend} meshes on the {device.type} device")
            print(f"19: a world-1 {dist.get_backend()} group, meshes {mesh_d.mesh_dim_names} "
                  f"{tuple(mesh_d.shape)} and {mesh_dm.mesh_dim_names} {tuple(mesh_dm.shape)}")
            # start each axis's communicator before the timed calls
            for mesh in (mesh_d, mesh_dm):
                for name in mesh.mesh_dim_names:
                    dist.all_reduce(torch.zeros(1, device=device), group=mesh.get_group(name))

            # 19a: the training step from phase 4's model
            spec, model = models["main"]
            own = spec.features
            with torch.no_grad():
                p0 = train.tree_map(lambda v: v.detach().clone(), model.params())
            gen = torch.Generator(device=device).manual_seed(P19_SEED)
            runs = [[torch.randint(0, X.shape[0], (batch,), generator=gen, device=device)
                     for _ in range(n_steps)] for n_steps, batch, _ in P19_STEPS]
            init_fn, step_fn = parallel.make_sharded_svgp_step(
                spec, lambda ps: torch.optim.Adam(ps, lr=P18_LR), mesh_dm)
            raw1, opt1 = init_fn(p0)
            sh = {"raw": raw1, "opt": opt1}
            raw0 = train.raw_leaves_from(p0)
            step0 = train.make_step_fn(lambda q, xb, yb: svgp.loss(spec, q, xb, yb), raw0,
                                       torch.optim.Adam(train.tree_leaves(raw0), lr=P18_LR))

            def sharded_steps(idx):
                losses = []
                for i in idx:
                    xb, yb = parallel.shard_batch(X[i], y[i], mesh_dm)
                    sh["raw"], sh["opt"], loss = step_fn(sh["raw"], sh["opt"], xb, yb)
                    losses.append(loss)
                return [torch.stack(losses)] + [v.detach().clone()
                                                for v in train.tree_leaves(sh["raw"])]

            def unsharded_steps(idx):
                losses = [step0(X[i], y[i]) for i in idx]
                return [torch.stack(losses)] + [v.detach().clone()
                                                for v in train.tree_leaves(raw0)]

            for (n_steps, batch, kernel), idx in zip(P19_STEPS, runs):
                what = f"19a {n_steps} sharded steps at batch {batch}"
                got, _ = pair(what, lambda idx=idx: sharded_steps(idx),
                              lambda idx=idx: unsharded_steps(idx), {kernel: 2 * n_steps},
                              no_grad=False, repeat=False)
                r = timings[f"p19 {what}"]
                timings[f"p19_step_ms_batch{batch}"] = {
                    "sharded": r["sharded_ms"][0] / n_steps,
                    "unsharded": r["unsharded_ms"][0] / n_steps}
                print(f"19a a step at batch {batch}: sharded "
                      f"{r['sharded_ms'][0] / n_steps:.3f} ms, unsharded "
                      f"{r['unsharded_ms'][0] / n_steps:.3f} ms (host clock, ending in "
                      f"synchronize; {card}); losses {float(got[0][0]):.6g} -> "
                      f"{float(got[0][-1]):.6g}")

            # 19b: the gridded head over the sharded state
            qv_fn = parallel.make_sharded_qv(spec, mesh_dm, own)
            pair(f"19b make_sharded_qv on the {M_AXIS}² cells", lambda: qv_fn(sh["raw"]),
                 lambda: svgp.q_v(spec, train.constrain(raw0), own), {})

            # 19c: streaming on 11a's model
            spec_f, p_f = models["full2d"]
            fold = parallel.make_sharded_assimilate(spec_f, p_f, mesh_d)
            chunks = [(X[lo:lo + STREAM_CHUNK], y[lo:lo + STREAM_CHUNK])
                      for lo in range(0, P19_STREAM_CHUNKS * STREAM_CHUNK, STREAM_CHUNK)]

            def sharded_stream():
                s = streaming.init_state(spec_f, f32, device)
                for xc, yc in chunks:
                    s = fold(s, *parallel.shard_batch(xc, yc, mesh_d))
                return s

            def unsharded_stream():
                s = streaming.init_state(spec_f, f32, device)
                for xc, yc in chunks:
                    s = streaming.assimilate(spec_f, p_f, s, xc, yc)
                return s

            got, _ = pair(f"19c make_sharded_assimilate {P19_STREAM_CHUNKS} chunks of "
                          f"{STREAM_CHUNK}", sharded_stream, unsharded_stream,
                          {"cell_kuf": 2 * P19_STREAM_CHUNKS})
            check(float(got["n_seen"]) == P19_STREAM_CHUNKS * STREAM_CHUNK,
                  f"19c n_seen {float(got['n_seen'])}")

            # 19d: the CG heads on 13a's model
            spec_m, params_m = mf_model((spec, model))
            own_m = spec_m.features
            pm, Xm, ym = c32(params_m), c32(X[:MF_N]), c32(y[:MF_N])
            xb, yb = parallel.shard_batch(Xm, ym, mesh_d)
            infos = {}
            solve = parallel.make_sharded_solve_w(spec_m, mesh_d, maxiter=MF_MAXITER)

            def with_info(side, fn):
                w, infos[side] = fn()
                return w

            pair(f"19d make_sharded_solve_w n={MF_N}",
                 lambda: with_info("sharded", lambda: solve(pm, xb, yb, return_info=True)),
                 lambda: with_info("unsharded", lambda: iterative.solve_w(
                     spec_m, pm, Xm, ym, maxiter=MF_MAXITER, return_info=True)),
                 {"cell_kuf": spec_m.ndim}, repeat=False)
            print(f"19d solve_w: sharded {infos['sharded']}, unsharded {infos['unsharded']}")
            same = [(i["iterations"], i["preconditioner"]) for i in infos.values()]
            check(same[0] == same[1], f"19d: the sharded solve's iterations differ: {infos}")
            timings["p19_solve_w_info"] = infos
            pair(f"19d make_sharded_qv_mean_cg n={MF_N}",
                 lambda: parallel.make_sharded_qv_mean_cg(spec_m, mesh_d, own_m,
                                                          maxiter=MF_MAXITER)(pm, xb, yb),
                 lambda: iterative.q_v_mean_cg(spec_m, pm, Xm, ym, own_m, maxiter=MF_MAXITER),
                 {"cell_kuf": spec_m.ndim}, repeat=False)
            pair(f"19d make_sharded_qdv_mean_cg axis 0 n={MF_N}",
                 lambda: parallel.make_sharded_qdv_mean_cg(spec_m, mesh_d, own_m, 0,
                                                           maxiter=MF_MAXITER)(pm, xb, yb),
                 lambda: iterative.q_dv_mean_from_w(spec_m, pm, own_m, 0, iterative.solve_w(
                     spec_m, pm, Xm, ym, maxiter=MF_MAXITER)),
                 {"cell_kuf": spec_m.ndim + 1}, repeat=False)

            # 19e: the pathwise heads on phase 7's model
            spec_c, params_c = models["collapsed"]
            own_c = spec_c.features
            pc, Xc, yc = c32(params_c), c32(X[:MF_DRAWS_N]), c32(y[:MF_DRAWS_N])
            xbc, ybc = parallel.shard_batch(Xc, yc, mesh_d)
            kw = dict(n_samples=MF_SAMPLES, n_features=MF_FEATURES, maxiter=MF_MAXITER)
            seeded = lambda: torch.Generator(device=device).manual_seed(P19_SEED)
            pair(f"19e make_sharded_pathwise_qv S={MF_SAMPLES} n={MF_DRAWS_N}",
                 lambda: parallel.make_sharded_pathwise_qv(spec_c, mesh_d, own_c, **kw)(
                     pc, xbc, ybc, seeded()),
                 lambda: iterative.q_v_pathwise(spec_c, pc, Xc, yc, own_c, seeded(), **kw),
                 {"cell_kuf": spec_c.ndim}, repeat=False)
            pair(f"19e make_sharded_pathwise_qdv axis 0 S={MF_SAMPLES} n={MF_DRAWS_N}",
                 lambda: parallel.make_sharded_pathwise_qdv(spec_c, mesh_d, own_c, 0, **kw)(
                     pc, xbc, ybc, seeded()),
                 lambda: iterative.q_dv_pathwise(spec_c, pc, Xc, yc, own_c, 0, seeded(), **kw),
                 {"cell_kuf": spec_c.ndim + 1}, repeat=False)
        finally:
            dist.destroy_process_group()

    at = dict(P19_SHAPE_LAUNCHES)
    held = (p18_held_shapes() | set(MF_SHAPE_LAUNCHES) | set(P14_SHAPE_LAUNCHES)
            | set(P18_SHAPE_LAUNCHES))
    print(f"phase 19's launches: {launches}, by shape {at}")
    check(all(k in held for k in at), f"phase 19 launched a shape never held against plain: "
          f"{sorted(k for k in at if k not in held)}")
    check(sum(at.values()) == sum(launches.values()),
          f"phase 19: launches by shape {at} vs {launches}")
    check(all(launches[k] > 0 for k in launches), f"phase 19: a kernel never launched: {launches}")
    worst = max(r["rel"] for k, r in timings.items() if k.startswith("p19 "))
    timings["p19_largest_rel"] = worst
    took = time.perf_counter() - t_phase
    print(f"phase 19: the largest gap of a sharded result from the unsharded one {worst:.3e} "
          f"(tol {TOL_P19:.0e}); {took:.1f} s")
    check(took <= P19_MAX_S, f"phase 19 took {took:.1f} s > {P19_MAX_S} s")
    return launches, timings, at


# --------------------------------------------------------------------------- #
# phase 20: the experiment layer (vggp_tpu_torch.experiments)
# --------------------------------------------------------------------------- #

P20_ITERS = 20           # 20b: each run() at its default widths, iterations cut to 20
P20_PARITY_ITERS = 10    # 20b: parity's, cut further (its CPU oracle, ~0.5 s an iteration)
P20_HOLD_ITERS = 5       # 20a and 20c: each run() on the CPU and on the card
P20_MAX_S = 150.0        # 20a + 20b + 20c
# phase 17 times these, each kernel's three most-called shapes in 20a (by
# its calls, then the shape; experiments_phase checks that they still are)
P20_TIMED_SHAPES = (("cell_kuf", 20, 4400), ("cell_kuf", 20, 696), ("cell_kuf", 10, 15),
                    ("cell_kuf_with_dl", 20, 4400), ("cell_kuf_with_dl", 15, 625),
                    ("cell_kuf_with_dl", 20, 696))
# and cell_kuf_with_dl's other three shapes in 20a, so that phase 17 times
# every shape phase 20 launches it at
P20_DL_TIMED_SHAPES = (("cell_kuf_with_dl", 10, 15), ("cell_kuf_with_dl", 10, 40),
                       ("cell_kuf_with_dl", 20, 20000))
P20_METRICS = ("mse", "mae", "rmse", "r2", "nlpd", "msll")
# Members whose float32 result after a few Adam steps is set by roundoff
# (ROADMAP queue 3, item 19), by run and model-name prefix: learned
# Matérn-1/2 inducing points, whose kernel has a kink at d = 0. The zoo's
# point SVGP at lr 0.05 (Adam's first step moves each z by ±lr, half the
# zoo's z spacing, onto its neighbour or a data point) and the CV sweep's
# free points at lr 0.1: which side of a kink roundoff puts a point on
# decides its next step. A 1-ulp change of the inputs on the CPU moves their
# 5-step results by 0.7–5% and their 1-step results by at most 1e-6
# (tools/torch_experiments_roundoff.py), as far as the card's 5-step results
# moved from the CPU's on an H100. They are held where their trajectory is still
# determined, after one step (P20_FIRST_STEP_ITERS), at the same floors;
# every other result at P20_HOLD_ITERS. (run_orders' Matérn-3/2 and 5/2
# point SVGPs, smooth at d = 0, are held at P20_HOLD_ITERS: after one step
# their points still coincide and the 5/2 Kuu is too near singular there.)
P20_ROUNDOFF = {"univariate": ("svgp",), "univariate.run_orders": ("matern12/svgp",),
                "kronecker": ("svgp",), "simtracks": ("svgp",),
                "gulfstream": ("cv svgp_n_inducing=",)}
P20_FIRST_STEP_ITERS = 1
P20_SHAPE_LAUNCHES = collections.Counter()


def p20_runs(iters: int, parity_iters=None) -> dict:
    """Each ported experiment ``run()`` at its default widths with its
    iterations (``cv_iters`` too) set to ``iters`` (parity's to
    ``parity_iters`` where given), as {name: run(device)}. None writes files
    (no ``outdir``)."""
    from vggp_tpu_torch.experiments import (gulfstream, kronecker, northsea, parity,
                                            simtracks, univariate)

    parity_iters = iters if parity_iters is None else parity_iters
    return {
        "univariate": lambda d: univariate.run(n_iters=iters, device=d),
        "univariate.run_orders": lambda d: univariate.run_orders(n_iters=iters, device=d),
        "kronecker": lambda d: kronecker.run(n_iters=iters, device=d),
        "simtracks": lambda d: simtracks.run(n_iters=iters, device=d),
        "gulfstream": lambda d: gulfstream.run(n_iters=iters, run_cv=True, cv_iters=iters,
                                               device=d),
        "northsea": lambda d: northsea.run(n_iters=iters, device=d),
        "parity": lambda d: parity.run(n_iters=parity_iters, device=d),
    }


def p20_roundoff(name: str, model: str) -> bool:
    """Whether ``model`` of run ``name`` is one of P20_ROUNDOFF's members."""
    return any(model.startswith(prefix) for prefix in P20_ROUNDOFF.get(name, ()))


def p20_records(name: str, out) -> tuple:
    """A run's results as ({(model, quantity): value}, {model: steps a
    second}): the final losses (floats), and the q(v) means and variances,
    posterior means and stddevs and metric rows (float64 arrays). For
    ``parity`` the port's column; its oracle column is held apart."""
    import numpy as np

    q, rates = {}, {}

    def add(model, rec, heads=(), loss=True):
        if loss:
            q[model, "final_loss"] = float(rec["final_loss"])
        rates[model] = float(rec["steps_per_sec"])
        for label, value in heads:
            q[model, label] = np.asarray(value, np.float64).reshape(-1)

    if name == "univariate":
        for m, r in out["models"].items():
            add(m, r, (("metrics", r["metrics"]), ("posterior mean", r["posterior"][0]),
                       ("posterior std", r["posterior"][1])))
    elif name == "univariate.run_orders":
        for kind, models in out.items():
            for m, r in models.items():
                add(f"{kind}/{m}", r, (("metrics", [r[k] for k in P20_METRICS]),))
    elif name == "kronecker":
        for m, r in out["models"].items():
            add(m, r, (("q_v mean", r["qv_grid"]), ("q_v var", r["qv_var"]),
                       ("metrics", r["metrics"])))
    elif name == "simtracks":
        for m, r in out["models"].items():
            add(m, r, (("q_v mean", r["qv_mean"]), ("metrics", r["metrics"])))
    elif name == "northsea":
        for m, r in out["models"].items():
            add(m, r, (("q_v mean", r["qv_mean"]), ("q_v var", r["qv_var"])))
    elif name == "gulfstream":
        for split in ("train", "test"):
            for m, r in out[split].items():
                add(f"{split}/{m}", r, (("q_v mean", r["qv"].mean), ("q_v var", r["qv"].var),
                                        ("metrics", r["metrics"])))
        for sweep, cv in out["cv"].items():
            for i, setting in enumerate(cv["setting"]):
                add(f"cv {sweep}={setting}", {"steps_per_sec": cv["steps_per_sec"][i]},
                    (("train metrics", cv["train_metrics"][i]),
                     ("val metrics", cv["val_metrics"][i])), loss=False)
    elif name == "parity":
        for split, rec in out["splits"].items():
            for m, impls in rec["models"].items():
                r = impls["vggp_tpu_torch_f32"]
                add(f"{split}/{m}", r, (("metrics", list(r["metrics"].values())),))
                rates[f"{split}/{m} oracle"] = float(impls["reference_f64_cpu"]["steps_per_sec"])
    else:
        raise ValueError(name)
    return q, rates


def p20_oracle(out) -> dict:
    """parity's oracle column without its wall-clock rate."""
    return {(split, m): {k: v for k, v in impls["reference_f64_cpu"].items()
                         if k != "steps_per_sec"}
            for split, rec in out["splits"].items() for m, impls in rec["models"].items()}


def p20_gap(got, want) -> float:
    """|Δ|/|want| of a loss; max|Δ|/max|want| of an array."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def p20_cases(device, shapes) -> list:
    """:func:`check_kernels_at`'s cases for each (kernel, m, n) of ``shapes``:
    m uniform cells, n points from a seed over [−0.05, 1.05]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(20)
    return [(m, torch.as_tensor(rng.random(n) * 1.1 - 0.05, device=device), None)
            for m, n in sorted({(m, n) for _, m, n in shapes})]


@contextlib.contextmanager
def recorded_kernel_calls():
    """Within the block, every call of the three kernel wrappers is counted
    by (name, m, n) in the Counter it yields (the callers look the wrappers
    up at call time)."""
    from vggp_tpu_torch.ops import cell_kuf as ck

    calls = collections.Counter()
    originals = {name: getattr(ck, name) for name in NO_LAUNCHES}

    def recording(name, fn):
        def call(*args, **kwargs):
            mesh, x = args[1:3] if name == "fused_banded_whiten_kuf" else args[:2]
            calls[name, mesh.shape[0] - 1, x.reshape(-1).shape[0]] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(ck, name, recording(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ck, name, fn)


def experiments_cpu_part(device) -> dict:
    """Phase 20a, the phase's start: every ``run()`` of :func:`p20_runs` at
    P20_HOLD_ITERS on the CPU in float32, and those with a member of
    P20_ROUNDOFF at P20_FIRST_STEP_ITERS too — 20c's references — with every
    call of the three kernel wrappers recorded by (name, m, n) (the CPU
    takes the plain versions, which launch nothing); then every recorded
    shape held on the card against the plain version in float64 and
    float32 (:func:`check_kernels_at`, both cell kernels at each (m, n))
    before the phase launches it. Returns {"cpu", "cpu_first_step",
    "calls", "errs", "seconds"}."""
    t0 = time.perf_counter()
    cpu, first = {}, {}
    with recorded_kernel_calls() as calls:
        for iters, runs, into in ((P20_HOLD_ITERS, p20_runs(P20_HOLD_ITERS), cpu),
                                  (P20_FIRST_STEP_ITERS, p20_runs(P20_FIRST_STEP_ITERS), first)):
            for name, run in runs.items():
                if into is first and name not in P20_ROUNDOFF:
                    continue
                t1 = time.perf_counter()
                into[name] = run("cpu")
                print(f"20a {name} on the CPU at {iters} iterations: "
                      f"{time.perf_counter() - t1:.1f} s")
    print(f"20a kernel calls by (name, m, n): {dict(sorted(calls.items()))}")
    check(not any(k[0] == "fused_banded_whiten_kuf" for k in calls),
          f"20a: the fused kernel was called ({calls}); no experiment has 128·k cells")
    cases = p20_cases(device, calls)
    errs = check_kernels_at(device, cases, "20")
    took = time.perf_counter() - t0
    print(f"20a: {len(cases)} shapes held on the card; {took:.1f} s")
    return {"cpu": cpu, "cpu_first_step": first, "calls": calls, "errs": errs,
            "seconds": took}


def p20_timed_shapes(calls) -> tuple:
    """(kernel, m, n) of each cell kernel's three most-called shapes in
    ``calls`` (by the count, then the shape)."""
    out = []
    for kernel in ("cell_kuf", "cell_kuf_with_dl"):
        ranked = sorted(((k, c) for k, c in calls.items() if k[0] == kernel),
                        key=lambda kc: (-kc[1], kc[0]))
        out += [k for k, _ in ranked[:3]]
    return tuple(out)


def experiments_phase(device, card) -> tuple:
    """Phase 20, last: the experiment layer on the card. (a)
    :func:`experiments_cpu_part`, whose most-called shapes must be
    P20_TIMED_SHAPES (phase 17 held and timed them); (b) each ``run()``
    of :func:`p20_runs` at its default widths and P20_ITERS (parity at
    P20_PARITY_ITERS): each model's steps a second and final loss printed
    beside the card's name and power limit, every number finite; (c) each
    again at P20_HOLD_ITERS against 20a's CPU run: every final loss within
    TOL_E2E_LOSS, every q(v) mean, variance, posterior and metric row within
    TOL_E2E_POST of its largest magnitude, parity's oracle column equal bit
    for bit; the members of P20_ROUNDOFF so at P20_FIRST_STEP_ITERS (their
    gaps at P20_HOLD_ITERS printed). Every launch is counted by (name, m,
    n) and must be at a shape 20a held against the plain version. 20a + 20b
    + 20c take at most P20_MAX_S. Returns (the launches, timings, the
    launches by shape)."""
    import numpy as np
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    part = experiments_cpu_part(device)
    t_phase = time.perf_counter()
    check(p20_timed_shapes(part["calls"]) == P20_TIMED_SHAPES,
          f"20a: the most-called shapes {p20_timed_shapes(part['calls'])} are not "
          f"P20_TIMED_SHAPES, which phase 17 timed")
    P20_SHAPE_LAUNCHES.clear()
    launches, timings = dict(NO_LAUNCHES), {"experiments_cpu_part_s": part["seconds"]}

    def counted_run(name, run):
        nonlocal launches
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = cell_launches()
        P20_SHAPE_LAUNCHES.update(cell_shape_launches())
        launches = add_launches(launches, got)
        return out, seconds, got

    # 20b: the default widths at P20_ITERS
    for name, run in p20_runs(P20_ITERS, P20_PARITY_ITERS).items():
        out, seconds, got = counted_run(name, run)
        quantities, rates = p20_records(name, out)
        bad = [k for k, v in quantities.items() if not np.all(np.isfinite(v))]
        check(not bad, f"20b {name}: not finite: {bad}")
        check(all(np.isfinite(r) and r > 0 for r in rates.values()),
              f"20b {name}: steps a second {rates}")
        for model, rate in rates.items():
            loss = quantities.get((model, "final_loss"))
            print(f"20b {name} {model}: {rate:.1f} steps/s"
                  + ("" if loss is None else f", final loss {loss:.6g}") + f" ({card})")
        timings[f"p20b {name}"] = {"seconds": seconds, "launches": got, "steps_per_sec": rates,
                                   "final_loss": {m: v for (m, k), v in quantities.items()
                                                  if k == "final_loss"}}
        print(f"20b {name}: {seconds:.1f} s, launches {got}")

    # 20c: the card against 20a's CPU runs
    misses, worst = [], {}

    def hold(name, what, card_q, cpu_q, members):
        """Hold ``members`` (a predicate on the model name) of a run's
        records at the floors; returns the largest gap by kind."""
        check(sorted(card_q) == sorted(cpu_q), f"20c {name}: the card's results differ in keys")
        gaps = {}
        for key, want in cpu_q.items():
            model, quantity = key
            if not members(model):
                continue
            kind = "losses" if quantity == "final_loss" else "heads"
            floor = TOL_E2E_LOSS if kind == "losses" else TOL_E2E_POST
            gap = p20_gap(card_q[key], want)
            gaps[kind] = max(gaps.get(kind, 0.0), gap)
            if not gap <= floor:
                misses.append(f"{name} {what} {model} {quantity}: {gap} > {floor}")
        return gaps

    for name, run in p20_runs(P20_HOLD_ITERS).items():
        out, seconds, got = counted_run(name, run)
        card_q, cpu_q = p20_records(name, out)[0], p20_records(name, part["cpu"][name])[0]
        gaps = hold(name, f"{P20_HOLD_ITERS} steps", card_q, cpu_q,
                    lambda m, n=name: not p20_roundoff(n, m))
        worst.update({(name, k): v for k, v in gaps.items()})
        line = (f"check 20c {name}: the largest gap card vs CPU at {P20_HOLD_ITERS} steps, "
                f"losses {gaps.get('losses', 0.0):.3e} (floor {TOL_E2E_LOSS:.0e}), heads "
                f"{gaps.get('heads', 0.0):.3e} (floor {TOL_E2E_POST:.0e})")
        if name in P20_ROUNDOFF:
            loose = {}
            for key, want in cpu_q.items():
                if p20_roundoff(name, key[0]):
                    kind = "losses" if key[1] == "final_loss" else "heads"
                    loose[kind] = max(loose.get(kind, 0.0), p20_gap(card_q[key], want))
            first, s1, _ = counted_run(name, p20_runs(P20_FIRST_STEP_ITERS)[name])
            gaps1 = hold(name, f"{P20_FIRST_STEP_ITERS} step", p20_records(name, first)[0],
                         p20_records(name, part["cpu_first_step"][name])[0],
                         lambda m, n=name: p20_roundoff(n, m))
            worst.update({(name, f"roundoff {k}"): v for k, v in gaps1.items()})
            line += (f"; its roundoff-set members ({', '.join(P20_ROUNDOFF[name])}) at "
                     f"{P20_FIRST_STEP_ITERS} step: losses {gaps1.get('losses', 0.0):.3e}, heads "
                     f"{gaps1.get('heads', 0.0):.3e} (at {P20_HOLD_ITERS}: losses "
                     f"{loose.get('losses', 0.0):.3e}, heads {loose.get('heads', 0.0):.3e}, "
                     f"not held)")
            seconds += s1
        if name == "parity":
            same = p20_oracle(out) == p20_oracle(part["cpu"][name])
            line += f"; the oracle column equals the CPU run's bit for bit: {same}"
            if not same:
                misses.append("parity: the oracle columns differ")
        print(line + f"; {seconds:.1f} s")
    timings["p20c_largest_gap"] = {f"{n} {k}": v for (n, k), v in worst.items()}
    check(not misses, f"20c: {len(misses)} results off: {misses}")

    at = dict(P20_SHAPE_LAUNCHES)
    held = {k for k in part["errs"]}
    print(f"phase 20's launches: {launches}, by shape {dict(sorted(at.items()))}")
    check(all(k in held for k in at), f"phase 20 launched a shape never held against plain: "
          f"{sorted(k for k in at if k not in held)}")
    check(sum(at.values()) == sum(launches.values()),
          f"phase 20: launches by shape {at} vs {launches}")
    check(launches["cell_kuf"] > 0 and launches["cell_kuf_with_dl"] > 0
          and launches["fused_banded_whiten_kuf"] == 0,
          f"phase 20: launches {launches}")
    took = part["seconds"] + time.perf_counter() - t_phase
    timings["experiments_phase_total_s"] = took
    print(f"phase 20: 20a {part['seconds']:.1f} s + 20b/20c "
          f"{time.perf_counter() - t_phase:.1f} s = {took:.1f} s")
    check(took <= P20_MAX_S, f"phase 20 took {took:.1f} s > {P20_MAX_S} s")
    return launches, timings, at


# --------------------------------------------------------------------------- #
# phase 21: the last eight experiments (spacetime, poisson, exceedance,
# streaming, velocity, evidence, multioutput, multiscale)
# --------------------------------------------------------------------------- #

P21_ITERS = 20           # 21b: each run() at its default widths, iterations cut to 20
P21_HOLD_ITERS = 5       # 21a and 21c: each run() on the CPU and on the card
P21_MAX_S = 150.0        # 21a + 21b + 21c
# phase 17 times these: spacetime's most-called shapes in 21a, up to three
# (its three axes share one: 32 cells, batch 1024; experiments_phase21
# checks that they still are the most-called)
P21_TIMED_SHAPES = (("cell_kuf_with_dl", 32, 1024),)
P21_SHAPE_LAUNCHES = collections.Counter()
# 21c's bounds on the fractions that float32 roundoff can move by whole
# points (a sample value across τ, a test point across its interval's
# edge): two such flips, in the fraction's own units
P21_FLIPS = 2
# 21c's floor for the stream's drift-segment NLPDs (after forget, anchored
# and reanchored), the one head that misses TOL_E2E_POST: float32 roundoff
# grows through the stream's 16 passes, the drift and the 200-step refit
# (ROADMAP queue 3, item 15), and card vs CPU read 1.153e-3 at 5 iterations
# and 1.847e-3 at 20 on an H100 80GB HBM3 at 700 W, the same in every run.
# About 5× the larger reading, as the gradient floors of phases 7–9 are set.
P21_DRIFT_NLPD_FLOOR = 1e-2


def p21_runs(iters: int) -> dict:
    """Each of the eight ``run()`` s at its default widths with its
    iterations (streaming's hyperparameter fit) set to ``iters``, as
    {name: run(device)}. None writes files."""
    from vggp_tpu_torch.experiments import (evidence, exceedance, multioutput, multiscale,
                                            poisson, spacetime, streaming, velocity)

    return {
        "spacetime": lambda d: spacetime.run(n_iters=iters, device=d),
        "poisson": lambda d: poisson.run(n_iters=iters, device=d),
        "exceedance": lambda d: exceedance.run(n_iters=iters, device=d),
        "streaming": lambda d: streaming.run(n_hyper_iters=iters, device=d),
        "velocity": lambda d: velocity.run(n_iters=iters, device=d),
        "evidence": lambda d: evidence.run(n_iters=iters, device=d),
        "multioutput": lambda d: multioutput.run(n_iters=iters, device=d),
        "multiscale": lambda d: multiscale.run(n_iters=iters, device=d),
    }


def _default(run, arg: str):
    """The default of ``run``'s argument ``arg``."""
    import inspect

    return inspect.signature(run).parameters[arg].default


def p21_records(name: str, out, iters: int) -> tuple:
    """A run's results as ({(model, quantity): (value, hold)}, {model: steps
    a second}). ``hold`` says how 21c holds the value (a float or float64
    array) against the CPU's: ``"losses"`` and ``"heads"`` by
    :func:`p20_gap` at TOL_E2E_LOSS and TOL_E2E_POST; ``("scaled", s)``, an
    error of a mean against its truth, by max|Δ|/s at TOL_E2E_POST (it moves
    by at most max|Δmean|; s the truth's largest magnitude); ``("flips",
    b)``, a fraction of points, by max|Δ| ≤ b (P21_FLIPS points);
    ``("below", b)``, a roundoff-level gap, by its own value ≤ b on each
    side; ``("floor", b)``, a head by :func:`p20_gap` at b. ``iters`` is the run's iterations (streaming's rate reads it)."""
    import numpy as np

    from vggp_tpu_torch.experiments import evidence, exceedance, streaming, velocity

    q, rates = {}, {}
    arr = lambda v: np.asarray(v, np.float64).reshape(-1)
    dist = lambda d: arr([d["mean"], d["std"], d["q05"], d["q95"]])
    flips = lambda n: ("flips", P21_FLIPS / n)

    def add(model, quantity, value, hold="heads"):
        q[model, quantity] = (float(value) if hold == "losses" else arr(value), hold)

    if name == "spacetime":
        add("svgp", "final_loss", out["final_loss"], "losses")
        add("svgp", "q_v mean", out["qv_mean"])
        add("svgp", "q_v var", out["qv_var"])
        add("svgp", "metrics", out["metrics"])
        rates["svgp"] = out["steps_per_sec"]
    elif name == "poisson":
        add("svgp", "final_loss", out["final_loss"], "losses")
        add("svgp", "metrics", out["metrics"])
        add("svgp", "intensity median rel err", out["intensity_median_rel_err"])
        rc = out["region_counts"]
        for k in ("lambda_pathwise", "lambda_independent", "counts_predictive"):
            add("svgp", k, dist(rc[k]))
        rates["svgp"] = out["steps_per_sec"]
    elif name == "exceedance":
        add("svgp", "final_loss", out["final_loss"], "losses")
        add("svgp", "sampler errors", [out["sampler_mean_err"], out["sampler_var_med_rel_err"]])
        n_eval, n_cells = _default(exceedance.run, "n_eval"), out["product"]["n_cells"]
        for k in ("max_pathwise", "max_independent"):
            add("svgp", k, dist(out[k]))
            add("svgp", f"product {k}", dist(out["product"][k]))
        for k in ("area_pathwise", "area_independent"):
            add("svgp", k, dist(out[k]), flips(n_eval ** 2))
            add("svgp", f"product {k}", dist(out["product"][k]), flips(n_cells ** 2))
        add("svgp", "product errors", [out["product"]["qv_mean_rmse"],
                                       out["product"]["sampler_mean_err"]])
        rates["svgp"] = out["steps_per_sec"]
    elif name == "streaming":
        # the RMSEs of the cell means against their truth, by the truth's
        # largest magnitude (before and after the drift)
        n_cells, drift = _default(streaming.run, "n_cells"), out["drift"]
        scale = lambda phase: float(np.abs(streaming.truth_cell_means(n_cells, phase)).max())
        add("stream", "per pass qv_rmse", [r["qv_rmse"] for r in out["per_pass"]],
            ("scaled", scale(0.0)))
        for k in ("qv_nlpd", "mean_std"):
            add("stream", f"per pass {k}", [r[k] for r in out["per_pass"]])
        add("stream", "drift rmse", [drift[k] for k in ("rmse_forget", "rmse_anchored",
                                                       "rmse_reanchored")],
            ("scaled", scale(drift["phase"])))
        add("stream", "drift nlpd", [drift[k] for k in ("nlpd_forget", "nlpd_anchored",
                                                       "nlpd_reanchored")],
            ("floor", P21_DRIFT_NLPD_FLOOR))
        # the exactness contract: streamed q(v) = batch q(v) to roundoff (the
        # JAX package's smoke bound on the mean gap)
        for k in ("stream_vs_batch_qv_mean_gap", "stream_vs_batch_qv_var_gap"):
            add("stream", k, out[k], ("below", 1e-2))
        rates["hyperparameter fit"] = iters / out["hyper_fit_seconds"]
        rates["assimilation (passes)"] = out["assimilation_passes_per_sec"]
    elif name == "velocity":
        add("sgpr", "final_loss", out["final_loss"], "losses")
        for ax in (0, 1):
            g = out[f"grad{ax}"]
            add("sgpr", f"grad{ax} metrics", [g["rmse"], g["r2"], g["nlpd"]])
            add("sgpr", f"grad{ax} coverage", g["coverage_2sigma"],
                flips(_default(velocity.run, "n_grid") ** 2))
        add("sgpr", "velocity", list(out["velocity"].values()))
        s = out["speed"]
        add("sgpr", "speed", [s["speed_rmse_m_s"], s["speed_corr"]])
        # a Brier score over the cells of exceedance fractions of 96 draws:
        # one draw across the threshold moves it by under 3/96/cells
        cells = _default(velocity.run, "n_grid") ** 2
        add("sgpr", "speed exceed brier", s["exceed_brier"],
            ("flips", P21_FLIPS * 3 / 96 / cells))
        rates["sgpr"] = out["steps_per_sec"]
    elif name == "evidence":
        for kind, r in out["models"].items():
            add(kind, "final_loss", r["final_loss"], "losses")
            add(kind, "log evidence", r["log_evidence"], "losses")
            for head in ("plugin", "marginalized"):
                add(kind, f"{head} nlpd crps", [r[head]["nlpd"], r[head]["crps"]])
                add(kind, f"{head} coverage90", r[head]["coverage90"],
                    flips(_default(evidence.run, "n_test")))
            rates[kind] = r["steps_per_sec"]
    elif name == "multioutput":
        add("icm", "final_loss", out["final_loss"], "losses")
        for model, row in out["sparse_output_test"].items():
            add("icm", f"{model} sparse-output test", list(row.values()))
        add("icm", "q_v errors", [out["qv_err_output0"], out["qv_err_output1"]],
            ("scaled", out["qv_scale"]))
        add("icm", "learned B", out["learned_B"])
        add("icm", "learned corr and means", [out["learned_corr"], *out["learned_means"]])
        rates["icm"] = out["steps_per_sec"]
    elif name == "multiscale":
        add("sum", "final_loss", out["final_loss"], "losses")
        scale = max(out["slow_scale"], out["fast_scale"])
        add("sum", "rmses", [out[k] for k in ("total_rmse_sum_model", "total_rmse_single_kernel",
                                             "slow_component_rmse", "fast_component_rmse")],
            ("scaled", scale))
        add("sum", "component vars", out["component_vars"])
        rates["sum"] = out["steps_per_sec"]
    else:
        raise ValueError(name)
    return q, {m: float(r) for m, r in rates.items()}


def p21_gap(card, cpu, hold) -> tuple:
    """(gap, floor) of one 21c quantity by its ``hold`` (:func:`p21_records`)."""
    import numpy as np

    if hold == "losses":
        return p20_gap(card, cpu), TOL_E2E_LOSS
    if hold == "heads":
        return p20_gap(card, cpu), TOL_E2E_POST
    kind, b = hold
    if kind == "floor":
        return p20_gap(card, cpu), b
    if kind == "scaled":
        return float(np.abs(np.asarray(card) - np.asarray(cpu)).max()) / b, TOL_E2E_POST
    if kind == "flips":
        return float(np.abs(np.asarray(card) - np.asarray(cpu)).max()), b
    return float(max(np.abs(card).max(), np.abs(cpu).max())), b      # "below"


def experiments21_cpu_part(device) -> dict:
    """Phase 21a, the phase's start: each ``run()`` of :func:`p21_runs` at
    P21_HOLD_ITERS on the CPU in float32 (21c's references), every
    call of the kernel wrappers recorded by (name, m, n) (the CPU takes the
    plain versions, which launch nothing); then every recorded shape held on
    the card against the plain version in float64 and float32
    (:func:`check_kernels_at`) before the phase launches it. Returns {"cpu",
    "calls", "errs", "seconds"}."""
    t0 = time.perf_counter()
    cpu = {}
    with recorded_kernel_calls() as calls:
        for name, run in p21_runs(P21_HOLD_ITERS).items():
            t1 = time.perf_counter()
            cpu[name] = run("cpu")
            print(f"21a {name} on the CPU at {P21_HOLD_ITERS} iterations: "
                  f"{time.perf_counter() - t1:.1f} s")
    print(f"21a kernel calls by (name, m, n): {dict(sorted(calls.items()))}")
    check(not any(k[0] == "fused_banded_whiten_kuf" for k in calls),
          f"21a: the fused kernel was called ({calls}); spacetime's batch is below its gate")
    check(all(k[0] == "cell_kuf_with_dl" for k in calls) and calls,
          f"21a: spacetime's three-axis steps should call cell_kuf_with_dl alone: {calls}")
    cases = p20_cases(device, calls)
    errs = check_kernels_at(device, cases, "21")
    took = time.perf_counter() - t0
    print(f"21a: {len(cases)} shapes held on the card; {took:.1f} s")
    return {"cpu": cpu, "calls": calls, "errs": errs, "seconds": took}


def p21_timed_shapes(calls) -> tuple:
    """(kernel, m, n) of the three most-called shapes in ``calls`` (by the
    count, then the shape)."""
    ranked = sorted(calls.items(), key=lambda kc: (-kc[1], kc[0]))
    return tuple(k for k, _ in ranked[:3])


def experiments_phase21(device, card) -> tuple:
    """Phase 21, after phase 20: the last eight experiments on the card. (a)
    :func:`experiments21_cpu_part`, whose most-called shapes must be
    P21_TIMED_SHAPES (phase 17 held and timed them); (b) each ``run()`` of
    :func:`p21_runs` at its default widths and P21_ITERS: steps a second and
    final loss printed beside the card's name and power limit, every number
    finite; (c) each again at P21_HOLD_ITERS against 21a's CPU run by
    :func:`p21_gap` (losses TOL_E2E_LOSS, heads and metric rows
    TOL_E2E_POST, the sampled functionals too: the draws come from CPU
    generators; the stream's drift-segment NLPDs at P21_DRIFT_NLPD_FLOOR).
    Every launch is counted by (name, m, n) and must be at a shape 21a held.
    21a + 21b + 21c take at most P21_MAX_S. Returns (the launches, timings,
    the launches by shape)."""
    import numpy as np
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    part = experiments21_cpu_part(device)
    t_phase = time.perf_counter()
    check(p21_timed_shapes(part["calls"]) == P21_TIMED_SHAPES,
          f"21a: the most-called shapes {p21_timed_shapes(part['calls'])} are not "
          f"P21_TIMED_SHAPES, which phase 17 timed")
    P21_SHAPE_LAUNCHES.clear()
    launches, timings = dict(NO_LAUNCHES), {"experiments21_cpu_part_s": part["seconds"]}

    def counted_run(run):
        nonlocal launches
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = cell_launches()
        P21_SHAPE_LAUNCHES.update(cell_shape_launches())
        launches = add_launches(launches, got)
        return out, seconds, got

    # 21b: the default widths at P21_ITERS
    for name, run in p21_runs(P21_ITERS).items():
        out, seconds, got = counted_run(run)
        quantities, rates = p21_records(name, out, P21_ITERS)
        bad = [k for k, (v, _) in quantities.items() if not np.all(np.isfinite(v))]
        check(not bad, f"21b {name}: not finite: {bad}")
        check(all(np.isfinite(r) and r > 0 for r in rates.values()),
              f"21b {name}: steps a second {rates}")
        for model, rate in rates.items():
            loss = quantities.get((model, "final_loss"), (None,))[0]
            print(f"21b {name} {model}: {rate:.1f} steps/s"
                  + ("" if loss is None else f", final loss {loss:.6g}") + f" ({card})")
        timings[f"p21b {name}"] = {
            "seconds": seconds, "launches": got, "steps_per_sec": rates,
            "final_loss": {m: v for (m, k), (v, _) in quantities.items() if k == "final_loss"}}
        print(f"21b {name}: {seconds:.1f} s, launches {got}")

    # 21c: the card against 21a's CPU runs
    misses, worst = [], {}
    for name, run in p21_runs(P21_HOLD_ITERS).items():
        out, seconds, _ = counted_run(run)
        card_q = p21_records(name, out, P21_HOLD_ITERS)[0]
        cpu_q = p21_records(name, part["cpu"][name], P21_HOLD_ITERS)[0]
        check(sorted(card_q) == sorted(cpu_q), f"21c {name}: the card's results differ in keys")
        gaps = {}
        for key, (want, hold) in cpu_q.items():
            gap, floor = p21_gap(card_q[key][0], want, hold)
            kind = hold if isinstance(hold, str) else hold[0]
            if kind == "floor":
                print(f"21c {name} {key[1]}: card vs CPU {gap:.3e} (floor {floor:.0e})")
            gaps[kind] = max(gaps.get(kind, 0.0), gap / floor)
            if not gap <= floor:
                misses.append(f"{name} {key[0]} {key[1]}: {gap} > {floor}")
        worst.update({(name, k): v for k, v in gaps.items()})
        print(f"check 21c {name}: the largest gap card vs CPU at {P21_HOLD_ITERS} steps as a "
              f"share of its floor, " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(gaps.items()))
              + f"; {seconds:.1f} s")
    timings["p21c_largest_share_of_floor"] = {f"{n} {k}": v for (n, k), v in worst.items()}
    check(not misses, f"21c: {len(misses)} results off: {misses}")

    at = dict(P21_SHAPE_LAUNCHES)
    held = set(part["errs"])
    print(f"phase 21's launches: {launches}, by shape {dict(sorted(at.items()))}")
    check(all(k in held for k in at), f"phase 21 launched a shape never held against plain: "
          f"{sorted(k for k in at if k not in held)}")
    check(sum(at.values()) == sum(launches.values()),
          f"phase 21: launches by shape {at} vs {launches}")
    check(launches["cell_kuf_with_dl"] > 0 and launches["fused_banded_whiten_kuf"] == 0,
          f"phase 21: launches {launches}")
    took = part["seconds"] + time.perf_counter() - t_phase
    timings["experiments_phase21_total_s"] = took
    print(f"phase 21: 21a {part['seconds']:.1f} s + 21b/21c "
          f"{time.perf_counter() - t_phase:.1f} s = {took:.1f} s")
    check(took <= P21_MAX_S, f"phase 21 took {took:.1f} s > {P21_MAX_S} s")
    return launches, timings, at


PROFILE_STEPS = 3


def profile_steps(step, X, y, batch, gen) -> dict:
    """Phase 16: where a training step's time goes. Three steps under
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
    got = cell_launches()
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


def time_kuf_shape(device, m, n, x_is_mesh=False, name="cell_kuf", edges=None) -> dict:
    """``name`` (cell_kuf or cell_kuf_with_dl) at (m, n) in f32, kernel in
    turns with its plain version: device ms from the profiler's trace, and
    the bound. ``x_is_mesh``: the points are the cell edges themselves
    (n = m + 1), as in q_dv's face difference; ``edges``: numpy edges in
    place of the uniform mesh."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    key = (name, m, n, x_is_mesh, edges is not None)
    if key in KERNEL_TIMES:
        return dict(KERNEL_TIMES[key])
    mesh, x, v, ell, _ = kernel_inputs(m, n, torch.float32, device, seed=7, mesh=edges)
    if x_is_mesh:
        x = mesh.clone()
    kern = lambda: getattr(ck, name)(mesh, x, v, ell)
    plain = lambda: getattr(ck, f"{name}_plain")(mesh, x, v, ell)
    p1, _ = time_ms(plain, iters=10)
    k1, _ = time_ms(kern, iters=20, kernel=_DEVICE_KERNELS[name])
    k2, _ = time_ms(kern, iters=20, kernel=_DEVICE_KERNELS[name])
    p2, _ = time_ms(plain, iters=10)
    out = {"shape": [m, n], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           **kuf_bounds(m, n, name == "cell_kuf_with_dl")}
    print(f"time {name} at ({m}, {n}){' x = mesh' if x_is_mesh else ''}"
          f"{'' if edges is None else ' stretched mesh'}: device ms kernel "
          f"{k1:.5f}/{k2:.5f}, plain {p1:.5f}/{p2:.5f}; bound {out['bound_ms']:.5f} ms "
          f"({out['bound_by']})")
    KERNEL_TIMES[key] = out
    return dict(out)


def time_fused_shape(device, m, n) -> dict:
    """fused_banded_whiten_kuf at (m, n) in f32 at MAIN_PRECISIONS, kernel
    in turns with its plain version: device ms from the profiler's trace,
    and the bound."""
    import torch

    from vggp_tpu_torch.ops import cell_kuf as ck

    key = ("fused_banded_whiten_kuf", m, n)
    if key in KERNEL_TIMES:
        return dict(KERNEL_TIMES[key])
    mesh, x, v, ell, finv = kernel_inputs(m, n, torch.float32, device, seed=8)
    kern = lambda: ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, *MAIN_PRECISIONS)
    plain = lambda: ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell, *MAIN_PRECISIONS)
    p1, _ = time_ms(plain, iters=5)
    k1, _ = time_ms(kern, iters=10, kernel=_DEVICE_KERNELS["fused_banded_whiten_kuf"])
    k2, _ = time_ms(kern, iters=10, kernel=_DEVICE_KERNELS["fused_banded_whiten_kuf"])
    p2, _ = time_ms(plain, iters=5)
    out = {"shape": [m, n], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           **fused_bounds(m, n, MAIN_PRECISIONS)}
    print(f"time fused_banded_whiten_kuf at ({m}, {n}): device ms kernel {k1:.5f}/{k2:.5f}, "
          f"plain {p1:.5f}/{p2:.5f}; bound {out['bound_ms']:.5f} ms ({out['bound_by']})")
    KERNEL_TIMES[key] = out
    return dict(out)


def time_serving_grid(device, spec, model, state) -> dict:
    """Phase 17b: cell_kuf at the serving grid's (512, 65 536), and the cold
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
        got = cell_launches()
        check(got["cell_kuf"] == 4, f"launches of two {name} calls on the grid: {got}")
    out["posterior_ms"] = sum(times["posterior"]) / 2
    out["posterior_from_state_ms"] = sum(times["posterior_from_state"]) / 2
    print(f"serve a {SERVE_GRID}x{SERVE_GRID} grid ({n} points): cold posterior "
          + "/".join(f"{t:.3f}" for t in times["posterior"]) + " ms, warm posterior_from_state "
          + "/".join(f"{t:.3f}" for t in times["posterior_from_state"]) + " ms")
    return out


def measure_kernels(device, errs, launches, shapes) -> list:
    """Phase 17: kernel and plain times at the main path's f32 shapes, and the
    fused kernel beside the unfused route it replaces (cell_kuf_with_dl, then
    kms.banded_whiten_apply for a and t at MAIN_PRECISIONS); ``shapes``
    (by kernel, then by key: the timings of phases 17b–17e at the other
    shapes of the main path) go into the kernels' rows."""
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
        key = ("main row", name)
        if key not in KERNEL_TIMES:
            # in turns: plain, kernel, (unfused, unfused,) kernel, plain
            p1, pc1 = time_ms(plain)
            k1, kc1 = time_ms(kern, kernel=dev_kernel)
            u1, u2 = (time_ms(unfused)[0], time_ms(unfused)[0]) if fused else (None, None)
            k2, kc2 = time_ms(kern, kernel=dev_kernel)
            p2, pc2 = time_ms(plain)
            KERNEL_TIMES[key] = (p1, pc1, k1, kc1, u1, u2, k2, kc2, p2, pc2)
        p1, pc1, k1, kc1, u1, u2, k2, kc2, p2, pc2 = KERNEL_TIMES[key]
        if errs is None:
            continue
        row = {
            "name": name, "route": "cuda", "source": _SOURCES[name],
            "replaces": _REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            **bound, "library_ms": None,
        }
        extra = ""
        row.update(shapes.get(name, {}))
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


# Phase 17's kernel timings, taken early (right after phase 3) by
# time_kernels_early and read back when phase 17 assembles its rows: late in
# a long process torch.profiler's trace kept 8 of 20 launches a window (and
# then none) from the first timing after phase 16 on, in whole-script runs on
# an H100, where a short process kept them all. Keyed by the timing's
# arguments.
KERNEL_TIMES = {}


def phase17_shapes() -> list:
    """The (name, m, n, x_is_mesh, stretched) of every kernel shape phase 17
    times, in its order (the serving grid's, the face differences', the
    collapsed, zoo, family, phase 14, 15 and 20 shapes)."""
    cuts = [(SGPR_CELLS, SGPR_CUT_N, "cell_kuf_with_dl")]
    return ([("cell_kuf", M_AXIS, SERVE_GRID ** 2, False, False),
             ("cell_kuf", M_AXIS, M_AXIS + 1, True, False),
             ("cell_kuf", 16384, 256, False, False),
             ("cell_kuf", SGPR_CELLS, SGPR_N, False, False),
             ("cell_kuf", FULL_CELLS, TRAIN_BATCH, False, False),
             ("cell_kuf", SGPR_CELLS, SGPR_CELLS + 1, True, False),
             ("cell_kuf", M_AXIS, SERVE_POINTS, False, True),
             ("cell_kuf", M_AXIS, M_AXIS + 1, True, True),
             ("cell_kuf", ZOO_CELLS, ZOO_N, False, False),
             ("cell_kuf_with_dl", SGPR_CELLS, SGPR_N, False, False),
             ("cell_kuf_with_dl", M_AXIS, TRAIN_BATCH, False, True),
             ("cell_kuf_with_dl", FULL_CELLS, TRAIN_BATCH, False, False),
             ("cell_kuf_with_dl", ZOO_CELLS, ZOO_N, False, False)]
            + [(k, m, n, False, False) for k, m, n in (
                ("cell_kuf", M_AXIS, FUSED_BATCH), ("cell_kuf", ICM_CELLS, SGPR_N),
                ("cell_kuf", SUM_CELLS[0], SGPR_N), ("cell_kuf", SUM_CELLS[1], SGPR_N),
                ("cell_kuf", ADD_CELLS, SGPR_N), ("cell_kuf_with_dl", ADD_CELLS, SGPR_N))]
            + [("cell_kuf", m, n, False, False) for m, n in P14_NEW_SHAPES]
            + [(k, m, n, False, False) for k in ("cell_kuf", "cell_kuf_with_dl")
               for m, n in P15_NEW_SHAPES]
            + [(k, m, n, False, False) for m, n, k in cuts]
            + [(k, m, n, False, False) for k, m, n in P20_TIMED_SHAPES + P20_DL_TIMED_SHAPES]
            + [(k, m, n, False, False) for k, m, n in P21_TIMED_SHAPES])


def time_kernels_early(device) -> tuple:
    """Phase 17's timings, right after phase 3, into KERNEL_TIMES: every
    shape of :func:`phase17_shapes` (phase 20's ``P20_TIMED_SHAPES`` and
    ``P20_DL_TIMED_SHAPES`` and phase 21's ``P21_TIMED_SHAPES`` held
    against plain first), the fused kernel at the additive model's shape,
    and the main path's rows of :func:`measure_kernels`. Returns phase 20's
    and phase 21's shapes' float32 errors against plain."""
    p20_shapes = P20_TIMED_SHAPES + P20_DL_TIMED_SHAPES
    p20_errs = check_kernels_at(device, p20_cases(device, p20_shapes), "20")
    p21_errs = check_kernels_at(device, p20_cases(device, P21_TIMED_SHAPES), "21")
    edges = stretched_mesh(M_AXIS)
    for name, m, n, x_is_mesh, stretched in phase17_shapes():
        time_kuf_shape(device, m, n, x_is_mesh=x_is_mesh, name=name,
                       edges=edges if stretched else None)
    time_fused_shape(device, ADD_CELLS, SGPR_N)
    measure_kernels(device, None, None, {})
    return p20_errs, p21_errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda")

    from vggp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds():.2f} s) -> "
          + ", ".join(_build.library_path(src).name for src in _build.SOURCES))

    record_finv_launches()
    errs = check_kernels(device)
    check_goldens(device)
    check_finv(device)
    hold_finv_kernel(device, FINV_HELD_M)
    t0 = time.perf_counter()
    p20_errs, p21_errs = time_kernels_early(device)
    kernel_timings_s = time.perf_counter() - t0
    print(f"phase 17's kernel timings, taken after phase 3: {kernel_timings_s:.1f} s")
    X, y, Xs = make_data(device)
    spec, model, post, launches, timings, step, gen = drive_main_path(device, X, y, Xs)
    timings["kernel_timings_s"] = kernel_timings_s
    check_against_cpu_f64(spec, model, post, X, y, Xs)
    check_fused_against_cpu_f64(spec, model, X, y)
    got, edge_launches, serve_times, state = serve_heads(device, spec, model, Xs)
    launches = add_launches(launches, got)
    timings.update(serve_times)
    for phase in (collapsed_phase, exact_phase, likelihood_phase, slice_phase, full_phase):
        t0 = time.perf_counter()
        got, phase_times, *more = phase(device, X, y, Xs)
        timings[f"{phase.__name__}_s"] = time.perf_counter() - t0
        print(f"{phase.__name__}: {timings[f'{phase.__name__}_s']:.1f} s")
        launches = add_launches(launches, got)
        timings.update(phase_times)
        if phase is collapsed_phase:
            at_n = more[0]   # the launches at (64, 65 536) by kernel
        if phase is slice_phase:
            stretched, timings["lambda_min"], matern32, m32_svgp = more[0]
        if phase is collapsed_phase:
            collapsed = more[1]   # phase 7's spec and trained params, for 12c
        if phase is exact_phase:
            exact_model = more[0]
        if phase is full_phase:
            full_errs, timings["lambda_min_new_features"], full2d = more[0]
    t0 = time.perf_counter()
    got, phase_times, family_errs, fitted = families_phase(device, X, y, Xs, collapsed)
    timings["families_phase_s"] = time.perf_counter() - t0
    print(f"families_phase: {timings['families_phase_s']:.1f} s")
    launches = add_launches(launches, got)
    timings.update(phase_times)
    t0 = time.perf_counter()
    got, phase_times, mf_errs, mf_at = matrix_free_phase(device, X, y, Xs, (spec, model),
                                                         collapsed, matern32, fitted["icm"])
    timings["matrix_free_phase_s"] = time.perf_counter() - t0
    print(f"matrix_free_phase: {timings['matrix_free_phase_s']:.1f} s")
    launches = add_launches(launches, got)
    timings.update(phase_times)
    t0 = time.perf_counter()
    got, phase_times, p14_errs, p14_at = sampler_stream_phase(device, X, y, Xs, {
        "main": (spec, model), "matern32 svgp": m32_svgp, "matern32 collapsed": matern32,
        "collapsed": collapsed, "exact": exact_model, "fitted": fitted, "full2d": full2d})
    timings["sampler_stream_phase_s"] = time.perf_counter() - t0
    print(f"sampler_stream_phase: {timings['sampler_stream_phase_s']:.1f} s")
    launches = add_launches(launches, got)
    timings.update(phase_times)
    serving_grid = time_serving_grid(device, spec, model, state)
    timings["posterior_ms_grid65536"] = serving_grid["posterior_ms"]
    timings["posterior_from_state_ms_grid65536"] = serving_grid["posterior_from_state_ms"]
    edges = stretched_mesh(M_AXIS)
    shapes = {
        "cell_kuf": {
            "at_serving_grid": serving_grid,
            "at_face_edges": {**time_kuf_shape(device, M_AXIS, M_AXIS + 1, x_is_mesh=True),
                              "launches": edge_launches,
                              "launches_matrix_free": mf_at["at_face_edges"],
                              "max_abs_err_matrix_free": mf_errs[("cell_kuf", M_AXIS,
                                                                   M_AXIS + 1)]},
            "at_16384_cells_256": {**time_kuf_shape(device, 16384, 256),
                                   "launches": mf_at["at_16384_cells"],
                                   "max_abs_err": mf_errs[("cell_kuf", 16384, 256)]},
            "at_64_cells": {**time_kuf_shape(device, SGPR_CELLS, SGPR_N),
                            "launches": at_n["cell_kuf"]},
            "at_64_cells_4096": {**time_kuf_shape(device, FULL_CELLS, TRAIN_BATCH),
                                 "max_abs_err": full_errs[("cell_kuf", FULL_CELLS, TRAIN_BATCH)]},
            "at_64_cells_face_edges": time_kuf_shape(device, SGPR_CELLS, SGPR_CELLS + 1,
                                                     x_is_mesh=True),
            "at_stretched_mesh": {**time_kuf_shape(device, M_AXIS, SERVE_POINTS, edges=edges),
                                  "launches": stretched["launches"]["cell_kuf"],
                                  "max_abs_err": stretched["errs"]["cell_kuf"]},
            "at_stretched_face_edges": time_kuf_shape(device, M_AXIS, M_AXIS + 1,
                                                      x_is_mesh=True, edges=edges),
            "at_15_cells": {**time_kuf_shape(device, ZOO_CELLS, ZOO_N),
                            "max_abs_err": full_errs[("cell_kuf", ZOO_CELLS, ZOO_N)]},
            "at_512_cells_4096_one_axis": {
                "max_abs_err": full_errs[("cell_kuf", FULL1D_CELLS, TRAIN_BATCH)]}},
        "cell_kuf_with_dl": {
            "at_64_cells": {**time_kuf_shape(device, SGPR_CELLS, SGPR_N, name="cell_kuf_with_dl"),
                            "launches": at_n["cell_kuf_with_dl"]},
            "at_stretched_mesh": {**time_kuf_shape(device, M_AXIS, TRAIN_BATCH,
                                                   name="cell_kuf_with_dl", edges=edges),
                                  "launches": stretched["launches"]["cell_kuf_with_dl"],
                                  "max_abs_err": stretched["errs"]["cell_kuf_with_dl"]},
            "at_64_cells_4096": {
                **time_kuf_shape(device, FULL_CELLS, TRAIN_BATCH, name="cell_kuf_with_dl"),
                "max_abs_err": full_errs[("cell_kuf_with_dl", FULL_CELLS, TRAIN_BATCH)]},
            "at_512_cells_4096_one_axis": {
                "max_abs_err": full_errs[("cell_kuf_with_dl", FULL1D_CELLS, TRAIN_BATCH)]},
            "at_15_cells": {**time_kuf_shape(device, ZOO_CELLS, ZOO_N, name="cell_kuf_with_dl"),
                            "max_abs_err": full_errs[("cell_kuf_with_dl", ZOO_CELLS, ZOO_N)]}},
        "fused_banded_whiten_kuf": {
            "at_one_axis_16384": {"max_abs_err": full_errs[
                ("fused_banded_whiten_kuf", FULL1D_CELLS, FUSED_BATCH)]}},
    }
    # phase 12's shapes: the times, the float32 errors against the plain
    # version and the launches of the training steps there
    fits = timings["family_fit_launches"]
    for kernel, m, n, steps in (("cell_kuf", M_AXIS, FUSED_BATCH, fits["icm_svgp_16384"]),
                              ("cell_kuf", ICM_CELLS, SGPR_N, fits["icm"]),
                              ("cell_kuf", SUM_CELLS[0], SGPR_N, fits["sum"]),
                              ("cell_kuf", SUM_CELLS[1], SGPR_N, fits["sum"]),
                              ("cell_kuf", ADD_CELLS, SGPR_N, None),
                              ("cell_kuf_with_dl", ADD_CELLS, SGPR_N, fits["additive"])):
        entry = {**time_kuf_shape(device, m, n, name=kernel),
                 "max_abs_err": family_errs[(kernel, m, n)]}
        if steps is not None:
            # the sum's two components share the four launches a step
            entry["launches_in_training"] = (steps[kernel] // 2 if m in SUM_CELLS
                                             else steps[kernel])
        shapes[kernel][f"at_{m}_cells_{n}"] = entry
    shapes["fused_banded_whiten_kuf"][f"at_{ADD_CELLS}_cells_{SGPR_N}"] = {
        **time_fused_shape(device, ADD_CELLS, SGPR_N),
        "max_abs_err": family_errs[("fused_banded_whiten_kuf", ADD_CELLS, SGPR_N)],
        "launches_in_training": fits["additive"]["fused_banded_whiten_kuf"]}
    # phase 14's new shapes, their launches counted there by shape
    for m, n in P14_NEW_SHAPES:
        shapes["cell_kuf"][f"at_{m}_cells_{n}"] = {
            **time_kuf_shape(device, m, n), "launches": p14_at[m, n],
            "max_abs_err": p14_errs[("cell_kuf", m, n)]}
    # phase 15's new shape, timed with the others after phase 3; its
    # launches and error join the row once phase 15 has run
    for name in ("cell_kuf", "cell_kuf_with_dl"):
        for m, n in P15_NEW_SHAPES:
            shapes[name][f"at_{m}_cells_{n}"] = time_kuf_shape(device, m, n, name=name)
    # phase 15's HMC and marginalized heads run cell_kuf_with_dl at
    # (64, SGPR_CUT_N), phase 3 held it there; its time and share of the bound
    cut = time_kuf_shape(device, SGPR_CELLS, SGPR_CUT_N, name="cell_kuf_with_dl")
    cut["share_of_bound"] = cut["bound_ms"] / cut["ms"]
    print(f"cell_kuf_with_dl at ({SGPR_CELLS}, {SGPR_CUT_N}): {cut['share_of_bound']:.3f} of its "
          f"bound")
    shapes["cell_kuf_with_dl"][f"at_{SGPR_CELLS}_cells_{SGPR_CUT_N}"] = cut
    # phase 20's most-called shapes and cell_kuf_with_dl's others, held
    # against plain and timed with the others after phase 3; their launches
    # join the rows once phase 20 has run
    for kernel, m, n in P20_TIMED_SHAPES + P20_DL_TIMED_SHAPES:
        entry = time_kuf_shape(device, m, n, name=kernel)
        entry.update(share_of_bound=entry["bound_ms"] / entry["ms"],
                     max_abs_err=p20_errs[(kernel, m, n)])
        print(f"{kernel} at ({m}, {n}), phase 20: {entry['share_of_bound']:.3f} of its bound")
        shapes[kernel][f"phase20_at_{m}_cells_{n}"] = entry
    # phase 21's most-called shapes (spacetime's three-axis steps), so
    for kernel, m, n in P21_TIMED_SHAPES:
        entry = time_kuf_shape(device, m, n, name=kernel)
        entry.update(share_of_bound=entry["bound_ms"] / entry["ms"],
                     max_abs_err=p21_errs[(kernel, m, n)])
        print(f"{kernel} at ({m}, {n}), phase 21: {entry['share_of_bound']:.3f} of its bound")
        shapes[kernel][f"phase21_at_{m}_cells_{n}"] = entry
    shapes["cell_kuf"]["cell_kuf_op_backward_at_512_cells_4096"] = {
        "max_abs_err_vs_cpu_f64": family_errs[("cell_kuf_op_backward", M_AXIS, TRAIN_BATCH)]}
    rows = measure_kernels(device, errs, launches, shapes)
    t0 = time.perf_counter()
    got, phase_times, p15_errs, p15_at, timings["p15_readings"] = hyperpost_phase(
        device, X, y, Xs, {"main": (spec, model), "collapsed": collapsed,
                           "exact": exact_model, "full2d": full2d})
    timings["hyperpost_phase_s"] = time.perf_counter() - t0
    print(f"hyperpost_phase: {timings['hyperpost_phase_s']:.1f} s")
    launches = add_launches(launches, got)
    timings.update(phase_times)
    t0 = time.perf_counter()
    got, phase_times, p18_at = facade_phase(device, X, y, Xs, {"full2d": full2d})
    timings["facade_phase_s"] = time.perf_counter() - t0
    print(f"facade_phase: {timings['facade_phase_s']:.1f} s")
    launches = add_launches(launches, got)
    timings.update(phase_times)
    t0 = time.perf_counter()
    got19, phase_times, p19_at = parallel_phase(device, X, y, {
        "main": (spec, model), "full2d": full2d, "collapsed": collapsed}, card)
    timings["parallel_phase_s"] = time.perf_counter() - t0
    print(f"parallel_phase: {timings['parallel_phase_s']:.1f} s")
    launches = add_launches(launches, got19)
    timings.update(phase_times)
    t0 = time.perf_counter()
    got20, phase_times, p20_at = experiments_phase(device, card)
    timings["experiments_phase_s"] = time.perf_counter() - t0
    print(f"experiments_phase: {timings['experiments_phase_s']:.1f} s")
    launches = add_launches(launches, got20)
    timings.update(phase_times)
    t0 = time.perf_counter()
    got21, phase_times, p21_at = experiments_phase21(device, card)
    timings["experiments_phase21_s"] = time.perf_counter() - t0
    print(f"experiments_phase21: {timings['experiments_phase21_s']:.1f} s")
    launches = add_launches(launches, got21)
    timings.update(phase_times)
    # phase 16 last: in whole-script runs on an H100 every profiler window
    # after its two windows (about 6000 launches each) kept 8 of 20 launches
    for batch in (TRAIN_BATCH, FUSED_BATCH):
        timings.update(profile_steps(step, X, y, batch, gen))
    for row in rows:
        name = row["name"]
        row["launches"] = launches[name]
        row["phase20_launches"] = got20[name]
        row["phase20_launches_by_shape"] = {
            f"{m}x{n}": k for (kname, m, n), k in sorted(p20_at.items()) if kname == name}
        row["phase21_launches"] = got21[name]
        row["phase21_launches_by_shape"] = {
            f"{m}x{n}": k for (kname, m, n), k in sorted(p21_at.items()) if kname == name}
        for key, entry in row.items():
            if key.startswith("phase20_at_"):
                entry["launches"] = p20_at.get((name, entry["shape"][0], entry["shape"][1]), 0)
            if key.startswith("phase21_at_"):
                entry["launches"] = p21_at.get((name, entry["shape"][0], entry["shape"][1]), 0)
        row["phase18_launches"] = got[name]
        row["phase19_launches"] = got19[name]
        row["phase19_launches_by_shape"] = {
            f"{m}x{n}": k for (kname, m, n), k in sorted(p19_at.items()) if kname == name}
        row["phase18_launches_by_shape"] = {
            f"{m}x{n}": k for (kname, m, n), k in sorted(p18_at.items()) if kname == name}
        if name == "fused_banded_whiten_kuf":
            continue
        for m, n in P15_NEW_SHAPES:
            row[f"at_{m}_cells_{n}"].update(launches=p15_at.get((name, m, n), 0),
                                            max_abs_err=p15_errs[(name, m, n)])
        row["phase15_launches_by_shape"] = {
            f"{m}x{n}": k for (kname, m, n), k in sorted(p15_at.items()) if kname == name}
        if name == "cell_kuf_with_dl":
            row[f"at_{SGPR_CELLS}_cells_{SGPR_CUT_N}"]["launches_phase15"] = p15_at.get(
                (name, SGPR_CELLS, SGPR_CUT_N), 0)
    timings["m12_finv"] = hold_finv_launched(device)
    timings["card"] = card
    print(json.dumps({"steps": timings}))
    print(json.dumps({"kernels": rows, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
