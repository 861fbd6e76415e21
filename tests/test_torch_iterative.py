"""The port's matrix-free path against the JAX package: ``ops.cg``, the KMS
tridiagonal pieces, the FFT Toeplitz matvec, ``kron_matvec``, the cell
features' ``kuu_matvec``/``kuu_diag`` and ``models.iterative``.

Both packages get the same numpy inputs in float64 on the CPU (JAX in x64,
its Pallas ``cell_kuf`` in interpret mode); the JAX side of a test runs as
one jitted program. The solvers match JAX's iterates and iteration counts
at rtol 1e-10, the structured operators at rtol 1e-12, and every head of
``iterative`` at tol 1e-12 at rtol 1e-9, on the Jacobi and the
KMS-Woodbury branches. The samplers and bench.py's CG row are in
``test_torch_pathwise.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import config as jconfig
from vggp_tpu import features as jf
from vggp_tpu.models import iterative as jit_
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.ops import cg as jcg
from vggp_tpu.ops import kms as jkms
from vggp_tpu.ops import kron as jkron
from vggp_tpu.ops import toeplitz as jtoeplitz

from vggp_tpu_torch import config, convert
from vggp_tpu_torch import features as tf
from vggp_tpu_torch.models import iterative, sgpr
from vggp_tpu_torch.models import sum as msum
from vggp_tpu_torch.ops import cg, kms, kron, toeplitz

RTOL_HEAD = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the solvers' loops run thousands of
    small ops, which a thread pool contended by the other test workers
    slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _spd(m, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (q * np.geomspace(1.0, cond, m)) @ q.T


# --------------------------------------------------------------------------- #
# ops.cg
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("solver", ["cg", "cg x0", "pcg jacobi", "pcg identity"])
def test_solvers_match_jax_iterates(solver):
    """x, the iteration count and the relative residual of ``return_info``
    on the same SPD system (m = 40, cond 5; for Jacobi a row scaling that
    it undoes) at tol 1e-6, and at a maxiter that cuts the solve short. (Once
    CG's Krylov basis loses orthogonality, the two packages' iterates part
    from rounding: by 2e-11 after 25 iterations at cond 20.)"""
    A = _spd(40, 1, 5.0)
    if solver == "pcg jacobi":
        scale = np.geomspace(1.0, 10.0, 40)
        A = A * scale[:, None] * scale[None, :]
    b = np.random.default_rng(2).standard_normal(40)
    x0 = np.random.default_rng(3).standard_normal(40) if solver == "cg x0" else None
    d = np.diag(A)

    def run_jax(maxiter):
        mv = lambda v: jnp.asarray(A) @ v
        if solver.startswith("cg"):
            return jcg.cg_solve(mv, jnp.asarray(b), tol=1e-6, maxiter=maxiter,
                                x0=None if x0 is None else jnp.asarray(x0), return_info=True)
        pc = (lambda r: r / jnp.asarray(d)) if solver.endswith("jacobi") else (lambda r: r)
        return jcg.pcg_solve(mv, jnp.asarray(b), pc, tol=1e-6, maxiter=maxiter,
                             return_info=True)

    def run_torch(maxiter):
        mv = lambda v: _t(A) @ v
        if solver.startswith("cg"):
            return cg.cg_solve(mv, _t(b), tol=1e-6, maxiter=maxiter,
                               x0=None if x0 is None else _t(x0), return_info=True)
        pc = (lambda r: r / _t(d)[:, None]) if solver.endswith("jacobi") else (lambda r: r)
        return cg.pcg_solve(mv, _t(b), pc, tol=1e-6, maxiter=maxiter, return_info=True)

    for maxiter in (1000, 7):
        (xj, kj, rj), (xt, kt, rt) = run_jax(maxiter), run_torch(maxiter)
        _close(xt, xj, 1e-10)
        assert int(kt) == int(kj) and (maxiter == 7) == (int(kj) == 7)
        _close(rt, rj, 1e-10)
        if maxiter == 1000:
            assert float(rt) <= 1e-6


@pytest.mark.parametrize("solver", ["cg", "pcg"])
def test_breakdown_keeps_the_iterate(solver):
    """An indefinite A: the iteration where pᵀAp ≤ 0 stops the solve at the
    iterate before it, as in JAX (no 1/tiny step)."""
    A = np.diag([3.0, 2.0, -1.0, 1.0, -2.5])
    b = np.ones(5)
    if solver == "cg":
        xj, kj, _ = jcg.cg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12,
                                 return_info=True)
        xt, kt, _ = cg.cg_solve(lambda v: _t(A) @ v, _t(b), tol=1e-12, return_info=True)
    else:
        xj, kj, _ = jcg.pcg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), lambda r: r,
                                  tol=1e-12, return_info=True)
        xt, kt, _ = cg.pcg_solve(lambda v: _t(A) @ v, _t(b), lambda r: r, tol=1e-12,
                                 return_info=True)
    assert int(kt) == int(kj) < 1000
    assert np.all(np.isfinite(_np(xt)))
    _close(xt, xj, 1e-12)


def test_float32_default_tol_stops_early():
    """float32 takes tol = max(1e-8, 50·eps) = 6e-6 and stops inside
    maxiter with a true residual at float32's level."""
    A = _spd(60, 4, 1e3).astype(np.float32)
    b = np.random.default_rng(5).standard_normal(60).astype(np.float32)
    mv = lambda v: _t(A, torch.float32) @ v
    x, k, rel = cg.cg_solve(mv, _t(b, torch.float32), maxiter=500, return_info=True)
    assert cg.default_tol(torch.float32) == pytest.approx(50 * np.finfo(np.float32).eps)
    assert cg.default_tol(torch.float64) == 1e-8
    assert x.dtype == torch.float32
    assert int(k) < 500 and float(rel) <= cg.default_tol(torch.float32)
    true = np.linalg.norm(b.astype(np.float64) - A.astype(np.float64) @ _np(x).astype(np.float64))
    assert true <= 1e-4 * np.linalg.norm(b)


@pytest.mark.parametrize("solver", ["cg", "pcg"])
def test_batched_columns_match_each_column_alone(solver):
    """Columns that stop at different iterations (an eigenvector at one, a
    sum of three eigenvectors at three, a zero column at none, a column cut
    by maxiter): each gets the iterate, count and residual of its own solve,
    and the host reads the running flag once every CHECK_EVERY
    iterations."""
    A = _spd(50, 6, 30.0)
    vecs = np.linalg.eigh(A)[1]
    rng = np.random.default_rng(7)
    B = np.stack([rng.standard_normal(50), vecs[:, 3], np.zeros(50),
                  vecs[:, [1, 20, 40]].sum(1)], 1)
    mv = lambda V: _t(A) @ V
    pc = lambda R: R / 2.0      # a preconditioner that keeps the eigenvectors

    def solve(b, maxiter):
        if solver == "cg":
            return cg.cg_solve(mv, b, tol=1e-8, maxiter=maxiter, return_info=True)
        return cg.pcg_solve(mv, b, pc, tol=1e-8, maxiter=maxiter, return_info=True)

    maxiter = 19
    cg.reset_counts()
    X, K, R = solve(_t(B), maxiter)
    counts = dict(cg.COUNTS)
    ks = []
    for j in range(B.shape[1]):
        x, k, r = solve(_t(B[:, j]), maxiter)
        if np.abs(B[:, j]).max() > 0:
            _close(X[:, j], x, 1e-12)
            # a relative residual; rounding-level ones (1e-15) agree absolutely
            np.testing.assert_allclose(_np(R[j]), _np(r), rtol=1e-10, atol=1e-13)
        assert int(K[j]) == int(k)
        ks.append(int(k))
    assert ks[0] == maxiter and ks[2] == 0 and len(set(ks)) == 4
    assert counts["solves"] == 1 and counts["iterations"] == maxiter
    assert counts["host_syncs"] == -(-maxiter // cg.CHECK_EVERY)
    assert np.all(_np(X[:, 2]) == 0.0)


# --------------------------------------------------------------------------- #
# the structured operators
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("delta,ell,floor", [(1e-3, 0.2, 0.0), (0.05, 0.02, 0.0),
                                            (1.0, 0.5, 0.0), (0.01, 0.01, 0.0),
                                            (1e-4, 5.0, 1e-3), (40.0, 1.0, 0.0)])
def test_kms_gamma_rho_and_tinv_match_jax(delta, ell, floor):
    """(γ, ρ, 1 − ρ²) across u = δ/ℓ (below 1, above, at 1, floored, capped),
    and KMS⁻¹ applied to (m,), (m, k) and m = 1."""
    want = jkms.kms_gamma_rho(delta, jnp.asarray(1.3), jnp.asarray(ell), u_floor=floor)
    got = kms.kms_gamma_rho(delta, _t(1.3), _t(ell), u_floor=floor)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
    rng = np.random.default_rng(8)
    for shape in ((17,), (17, 3), (1,), (1, 2)):
        v = rng.standard_normal(shape)
        _close(kms.kms_tinv_matvec(got[1], got[2], _t(v)),
               jkms.kms_tinv_matvec(want[1], want[2], jnp.asarray(v)), 1e-12)


def test_toeplitz_and_kron_matvecs_match_jax():
    rng = np.random.default_rng(9)
    row = np.exp(-np.arange(33) / 5.0) + 0.1 * rng.random(33)
    for shape in ((33,), (33, 4)):
        v = rng.standard_normal(shape)
        want = jtoeplitz.sym_toeplitz_matvec(jnp.asarray(row), jnp.asarray(v))
        got = toeplitz.sym_toeplitz_matvec(_t(row), _t(v))
        _close(got, want, 1e-12)
        _close(got, toeplitz.sym_toeplitz_dense(_t(row)) @ _t(v), 1e-12)
    mats = [rng.standard_normal(s) for s in ((3, 4), (5, 2), (2, 3))]
    x = rng.standard_normal(4 * 2 * 3)
    _close(kron.kron_matvec([_t(a) for a in mats], _t(x)),
           jkron.kron_matvec([jnp.asarray(a) for a in mats], jnp.asarray(x)), 1e-12)


def _stretched(m):
    s = np.linspace(0.0, 1.0, m + 1)
    return s + 0.15 * np.sin(2 * np.pi * s) / (2 * np.pi)


@pytest.mark.parametrize("mesh", ["uniform", "stretched"])
@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52", "rbf"])
def test_cell_kuu_matvec_and_diag_match_jax(kind, mesh):
    """The cell features' Kuu @ v ((m,) and (m, k)) and diag(Kuu): the FFT
    matvec and the constant row[0] on a uniform mesh, dense products on a
    stretched one."""
    edges = np.linspace(0.0, 1.0, 41) if mesh == "uniform" else _stretched(40)
    jfeat, tfeat = jf.CellIntegralFeature(edges), tf.CellIntegralFeature(edges)
    assert tfeat.uniform == (mesh == "uniform")
    p_np = {"variance": 1.2, "lengthscale": 0.13}
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    pt = {k: _t(v) for k, v in p_np.items()}
    v = np.random.default_rng(10).standard_normal((40, 3))
    want = jax.jit(lambda p, v: (jfeat.kuu_matvec(kind, p, v), jfeat.kuu_matvec(kind, p, v[:, 0]),
                                 jfeat.kuu_diag(kind, p)))(pj, jnp.asarray(v))
    got = (tfeat.kuu_matvec(kind, pt, _t(v)), tfeat.kuu_matvec(kind, pt, _t(v[:, 0])),
           tfeat.kuu_diag(kind, pt))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
    _close(got[0], tfeat.Kuu(kind, pt) @ _t(v), 1e-11)


# --------------------------------------------------------------------------- #
# models.iterative against JAX
# --------------------------------------------------------------------------- #

def _data(d, n, seed, outputs=0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = np.sin(6 * X[:, 0]) * (np.cos(3 * X[:, 1]) if d > 1 else 1.0) \
        + 0.05 * rng.standard_normal(n)
    if outputs:
        task = rng.integers(0, outputs, n)
        y = np.where(task == 0, y, 0.7 * y + 0.2)
        X = np.column_stack([X, task.astype(np.float64)])
    return X, y


# name: (kinds, feature builders (JAX, port), axis params, learn_mean,
# per_output_noise, outputs, the preconditioner the port picks)
_CASES = {
    "1d kms": (("matern12",), [lambda m: m.CellIntegralFeature.from_lims(48, 0.0, 1.0)],
               ((1.2, 0.25),), False, False, 0, "kms-woodbury"),
    "2d kms mean": (("matern12", "matern12"),
                    [lambda m: m.CellIntegralFeature.from_lims(10, 0.0, 1.0),
                     lambda m: m.CellIntegralFeature.from_lims(9, -0.1, 1.1)],
                    ((0.8, 0.3), (1.1, 0.25)), True, False, 0, "kms-woodbury"),
    "2d jacobi": (("matern12", "matern12"),
                  [lambda m: m.CellIntegralFeature.from_lims(10, 0.0, 1.0),
                   lambda m: m.CellIntegralFeature.from_lims(9, -0.1, 1.1)],
                  ((0.8, 0.3), (1.1, 0.25)), False, False, 0, "jacobi"),
    "1d b1": (("matern12",), [lambda m: m.B1SplineFeature(np.linspace(0.0, 1.0, 40))],
              ((1.2, 0.25),), False, False, 0, "jacobi"),
    "2d matern32 stretched": (("matern32", "matern32"),
                              [lambda m: m.CellIntegralFeature(_stretched(12)),
                               lambda m: m.CellIntegralFeature.from_lims(8, 0.0, 1.0)],
                              ((0.9, 0.12), (1.0, 0.15)), False, False, 0, "jacobi"),
    "icm per-output": (("matern12", "matern12", "coregion"),
                       [lambda m: m.CellIntegralFeature.from_lims(8, 0.0, 1.0),
                        lambda m: m.CellIntegralFeature.from_lims(7, 0.0, 1.0),
                        lambda m: m.OutputFeature(n_outputs=2)],
                       ((0.9, 0.15), (1.0, 0.12)), True, True, 2, "jacobi"),
}


def _case(name):
    kinds, builders, hyp, learn_mean, pon, outputs, precond = _CASES[name]
    jspec = jsgpr.SGPRSpec(kinds=kinds, features=tuple(b(jf) for b in builders),
                           learn_mean=learn_mean, per_output_noise=pon)
    tspec = sgpr.SGPRSpec(kinds=kinds, features=tuple(b(tf) for b in builders),
                          learn_mean=learn_mean, per_output_noise=pon)
    p = jax.tree.map(np.asarray, jspec.init_params(jnp.float64))
    axes = list(p["axes"])
    for i, (v, ell) in enumerate(hyp):
        axes[i] = {**axes[i], "variance": np.asarray(v), "lengthscale": np.asarray(ell)}
    if outputs:
        axes[-1] = {"w": np.array([[0.9], [0.6]]), "kappa": np.array([0.3, 0.2])}
    p = {**p, "axes": tuple(axes),
         "noise": np.array([0.02, 0.05]) if pon else np.asarray(0.02)}
    if learn_mean:
        p["mean"] = np.array([0.3, -0.2]) if outputs else np.asarray(0.25)
    n_cont = len(hyp)
    X, y = _data(n_cont, 150, 11, outputs)
    return jspec, tspec, p, X, y, precond


def _grid(tspec_or_jspec, mod):
    out = []
    for kind, feat in zip(tspec_or_jspec.kinds, tspec_or_jspec.features):
        out.append(mod.OutputFeature(n_outputs=feat.n_outputs) if kind == "coregion"
                   else mod.CellIntegralFeature.from_lims(5, 0.05, 0.95))
    return tuple(out)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_solve_w_and_heads_match_jax(name, monkeypatch):
    """solve_w and every *_from_w head at tol 1e-12: posterior means at 40
    points, q_v and q_dv on each continuous axis over a 5-cell grid, and
    posterior_grad_mean_from_w where the kind is differentiable; the CG
    wrappers compose them. The port's preconditioner is the one the JAX
    package's gates select."""
    jspec, tspec, p_np, X, y, precond = _case(name)
    if precond == "jacobi" and name == "2d jacobi":
        monkeypatch.setattr(jconfig, "CG_KMS_PRECOND", False)
        monkeypatch.setattr(config, "CG_KMS_PRECOND", False)
    xs = np.random.default_rng(12).random((40, X.shape[1]))
    if "coregion" in jspec.kinds:
        xs[:, -1] = np.arange(40) % 2
    cont = [i for i, k in enumerate(jspec.kinds) if k != "coregion"]
    diff = [i for i in cont if jspec.kinds[i] != "matern12"]
    gj, gt = _grid(jspec, jf), _grid(tspec, tf)

    def jax_heads(p, X, y, xs):
        w = jit_.solve_w(jspec, p, X, y, tol=1e-12, maxiter=4000)
        out = {"w": w, "posterior": jit_.posterior_mean_from_w(jspec, p, xs, w),
               "q_v": jit_.q_v_mean_from_w(jspec, p, gj, w)}
        for a in cont:
            out[f"q_dv {a}"] = jit_.q_dv_mean_from_w(jspec, p, gj, a, w)
        for a in diff:
            out[f"grad {a}"] = jit_.posterior_grad_mean_from_w(jspec, p, xs, a, w)
        return out

    Xa = X if X.shape[1] > 1 else X[:, 0]
    xa = xs if xs.shape[1] > 1 else xs[:, 0]
    want = jax.jit(jax_heads)(jax.tree.map(jnp.asarray, p_np), jnp.asarray(Xa), jnp.asarray(y),
                              jnp.asarray(xa))
    pt = convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)
    Xt, yt, xt = _t(Xa), _t(y), _t(xa)
    w, info = iterative.solve_w(tspec, pt, Xt, yt, tol=1e-12, maxiter=4000, return_info=True)
    assert info["preconditioner"] == precond and info["rel_resid"] <= 1e-12
    got = {"w": w, "posterior": iterative.posterior_mean_from_w(tspec, pt, xt, w),
           "q_v": iterative.q_v_mean_from_w(tspec, pt, gt, w)}
    for a in cont:
        got[f"q_dv {a}"] = iterative.q_dv_mean_from_w(tspec, pt, gt, a, w)
    for a in diff:
        got[f"grad {a}"] = iterative.posterior_grad_mean_from_w(tspec, pt, xt, a, w)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], RTOL_HEAD)
    _close(iterative.posterior_mean_cg(tspec, pt, Xt, yt, xt, tol=1e-12, maxiter=4000),
           want["posterior"], RTOL_HEAD)
    _close(iterative.q_v_mean_cg(tspec, pt, Xt, yt, gt, tol=1e-12, maxiter=4000),
           want["q_v"], RTOL_HEAD)


def test_matrix_free_means_match_the_dense_heads():
    """The port's CG means against its own dense collapsed heads (jitter
    1e-12) on a 2-D model: q_v, the posterior mean and the gridded gradient."""
    jspec, tspec, p_np, X, y, _ = _case("2d kms mean")
    tspec = sgpr.SGPRSpec(kinds=tspec.kinds, features=tspec.features, jitter=1e-12,
                          learn_mean=True)
    pt = convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)
    Xt, yt = _t(X), _t(y)
    grid = _grid(tspec, tf)
    w = iterative.solve_w(tspec, pt, Xt, yt, tol=1e-12, maxiter=4000)
    _close(iterative.q_v_mean_from_w(tspec, pt, grid, w),
           sgpr.q_v(tspec, pt, Xt, yt, grid, full_cov=False).mean, 1e-7)
    _close(iterative.posterior_mean_from_w(tspec, pt, Xt[:30], w),
           sgpr.posterior(tspec, pt, Xt, yt, Xt[:30], full_cov=False).mean, 1e-7)
    _close(iterative.q_dv_mean_from_w(tspec, pt, grid, 1, w),
           sgpr.q_dv(tspec, pt, Xt, yt, grid, 1, full_cov=False).mean, 1e-7)


def test_check_spec_rejects_the_other_families():
    comp = sgpr.SGPRSpec(kinds=("matern12",),
                         features=(tf.CellIntegralFeature.from_lims(8, 0.0, 1.0),))
    spec = msum.SumSGPRSpec(components=(comp, comp))
    p = spec.init_params(torch.float64, device="cpu")
    with pytest.raises(ValueError, match="dense heads"):
        iterative.solve_w(spec, p, torch.zeros((4, 1), dtype=torch.float64),
                          torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="dense heads"):
        iterative._check_spec(type("S", (), {"kinds": ("matern12",), "features": ()})())
    _, tspec, p_np, X, y, _ = _case("icm per-output")
    pt = convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="output axis"):
        iterative.pathwise_q_dv_samples(tspec, pt, _t(X), _t(y), _grid(tspec, tf), 2,
                                        torch.Generator(), n_samples=2)
    with pytest.raises(ValueError, match="even"):
        iterative.pathwise_q_v_samples(tspec, pt, _t(X), _t(y), _grid(tspec, tf),
                                       torch.Generator(), n_samples=3, antithetic=True)


@pytest.mark.parametrize("ratio", [512.0, 540.0, 579.0])
def test_float32_woodbury_breakdown_falls_back_to_jacobi(ratio):
    """Inside the window where the JAX package's float32 gates admit the
    KMS-Woodbury PCG (ℓ/δ from its CG_KMS_MIN_STIFFNESS = 512 to 1/u_floor
    ≈ 579) its preconditioner breaks down in float32 within a few iterations
    and the JAX package returns that iterate (a true relative residual above
    1, tools/torch_cg_woodbury_f32.py). The port's float32 runs Jacobi PCG
    there: a true residual at float32's level, and the float64 solve (the
    Woodbury's, 7 iterations) unchanged."""
    m, n = 512, 4096
    rng = np.random.default_rng(0)
    x = rng.random(n)
    y = np.sin(6 * x) + 0.1 * rng.standard_normal(n)
    spec = sgpr.SGPRSpec(kinds=("matern12",),
                         features=(tf.CellIntegralFeature.from_lims(m, 0.0, 1.0),))

    def params(dtype):
        return {"axes": ({"variance": _t(0.91, dtype), "lengthscale": _t(ratio / m, dtype)},),
                "noise": _t(0.114, dtype)}

    w32, info32 = iterative.solve_w(spec, params(torch.float32), _t(x, torch.float32),
                                    _t(y, torch.float32), return_info=True)
    w64, info64 = iterative.solve_w(spec, params(torch.float64), _t(x), _t(y), return_info=True)
    assert info32["preconditioner"] == "jacobi-pcg"
    assert info64["preconditioner"] == "kms-woodbury" and info64["iterations"] < 20
    true = float(iterative.relative_residual(spec, params(torch.float64), _t(x), _t(y), w32))
    assert true < 1e-4
