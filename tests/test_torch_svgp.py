"""The port's main path end to end against the JAX package: the 2-D
Kronecker SVGP with Matérn-1/2 cell features — loss, every gradient leaf, a
5-step Adam trajectory, the posterior — plus the module pieces it runs.

Both packages get the same numpy inputs in float64 on the CPU (2 axes × 256
cells, batch 512). At the initial parameters (μ = 0, L = I) the loss does
not depend on ℓ, so a broken ℓ-tangent would pass there: the parameters
here have a random μ, a perturbed raw_L and ℓ ≠ 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import svgp as jsvgp

import vggp_tpu_torch
from vggp_tpu_torch import config, convert, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import common, svgp
from vggp_tpu_torch.ops import cell_kuf as ck

M_AXIS = 256
BATCH = 512
NUM_DATA = 100_000


def _params_np(seed=0):
    rng = np.random.default_rng(seed)
    eye_raw = np.asarray(jsvgp.raw_from_chol(jnp.eye(M_AXIS)))
    q = {"mu": 0.3 * rng.standard_normal((M_AXIS, M_AXIS))}
    for i in (1, 2):
        q[f"raw_L{i}"] = eye_raw + 0.01 * np.tril(rng.standard_normal((M_AXIS, M_AXIS)))
    return {"axes": ({"variance": np.asarray(1.3), "lengthscale": np.asarray(0.2)},
                     {"variance": np.asarray(0.8), "lengthscale": np.asarray(0.3)}),
            "noise": np.asarray(0.05), "q": q}


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(100 + seed)
    x = rng.random((n, 2)) * 1.1 - 0.05
    y = np.sin(6 * x[:, 0]) * np.cos(5 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y


def _specs():
    jspec = jsvgp.SVGPSpec(kinds=("matern12",) * 2,
                           features=tuple(JaxCellFeature.from_lims(M_AXIS, 0.0, 1.0)
                                          for _ in range(2)),
                           num_data=NUM_DATA, variational="kron")
    tspec = svgp.SVGPSpec(kinds=("matern12",) * 2,
                          features=tuple(CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0)
                                         for _ in range(2)),
                          num_data=NUM_DATA, variational="kron")
    return jspec, tspec


def _jax_tree(p_np):
    return jax.tree.map(jnp.asarray, p_np)


def _torch_tree(p_np, dtype=torch.float64):
    return convert.params_from_jax(p_np, device="cpu", dtype=dtype)


def _flat(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def _torch_flat(tree):
    # jax.tree.leaves orders dict keys sorted; follow the same order
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _torch_flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _torch_flat(v)]
    return [tree.detach().numpy()]


def _assert_tree_close(got, want, rtol):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-300))


def _jax_grads(jspec, p_np, x, y):
    raw = jtrain.unconstrain(_jax_tree(p_np))
    val, g = jax.value_and_grad(
        lambda r: jsvgp.loss(jspec, jtrain.constrain(r), jnp.asarray(x), jnp.asarray(y)))(raw)
    return float(val), _flat(g)


def _torch_grads(tspec, p_np, x, y):
    raw = train.raw_leaves_from(_torch_tree(p_np))
    val = svgp.loss(tspec, train.constrain(raw), torch.tensor(x), torch.tensor(y))
    val.backward()
    return float(val.detach()), _torch_flat(train.tree_map(lambda v: v.grad, raw))


@pytest.fixture(scope="module")
def setup():
    """Specs, parameters, a batch, and the JAX loss and gradients there
    (computed once: the JAX side is the slow one)."""
    jspec, tspec = _specs()
    p_np = _params_np()
    x, y = _batch(0)
    jval, jg = _jax_grads(jspec, p_np, x, y)
    return jspec, tspec, p_np, x, y, jval, jg


# --------------------------------------------------------------------------- #
# the slice end to end
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("toggle", [None, "STRUCTURED_FINV", "BANDED_WHITEN_APPLY"])
def test_loss_matches_jax(setup, toggle, monkeypatch):
    """rtol 1e-10: same closed forms; the sums run in another order. With
    ``STRUCTURED_FINV`` off the port takes F⁻¹ from a dense Cholesky, with
    ``BANDED_WHITEN_APPLY`` off the dense apply; the JAX side keeps its
    defaults, and the f64 results agree all the same."""
    _, tspec, p_np, x, y, jval, _ = setup
    if toggle:
        monkeypatch.setattr(config, toggle, False)
    got = float(svgp.loss(tspec, _torch_tree(p_np), torch.tensor(x), torch.tensor(y)))
    np.testing.assert_allclose(got, jval, rtol=1e-10)


@pytest.mark.parametrize("fast_moments_bwd", [True, False])
def test_gradients_match_jax(setup, fast_moments_bwd, monkeypatch):
    """Every gradient leaf, rtol 1e-7 (the ℓ-tangent passes through the
    derivative of the jittered Kuu and two (m, m) products on each side),
    with the hand-written moments backward and with plain autograd. The
    ℓ-gradients are non-zero here."""
    _, tspec, p_np, x, y, jval, jg = setup
    monkeypatch.setattr(config, "FAST_MOMENTS_BWD", fast_moments_bwd)
    tval, tg = _torch_grads(tspec, p_np, x, y)
    np.testing.assert_allclose(tval, jval, rtol=1e-10)
    _assert_tree_close(tg, jg, 1e-7)
    # leaves in sorted order: axes[0].{lengthscale, variance}, axes[1]..., noise, q...
    assert abs(float(tg[0])) > 1e-3 and abs(float(tg[2])) > 1e-3


def test_fused_path_matches_jax(setup, monkeypatch):
    """With the fusion minimum lowered to the test batch, the port takes the
    fused whitening (its plain version on the CPU); JAX off the TPU takes the
    unfused path. Loss rtol 1e-10, gradients rtol 1e-7."""
    _, tspec, p_np, x, y, jval, jg = setup
    calls = []
    real = ck.fused_banded_whiten_kuf
    monkeypatch.setattr(config, "FUSED_WHITEN_MIN_POINTS", BATCH)
    monkeypatch.setattr(ck, "fused_banded_whiten_kuf",
                        lambda *a: calls.append(1) or real(*a))
    tval, tg = _torch_grads(tspec, p_np, x, y)
    assert len(calls) == 2
    np.testing.assert_allclose(tval, jval, rtol=1e-10)
    _assert_tree_close(tg, jg, 1e-7)


def test_fused_gate_falls_back_above_the_ratio_gate(setup, monkeypatch):
    """At or above ratio 0.7 the fused hook takes the unfused pass and two
    dense products; where the factor is banded both give the same (a, t),
    rtol 1e-10."""
    _, tspec, p_np, x, _, _, _ = setup
    monkeypatch.setattr(config, "FUSED_WHITEN_MIN_POINTS", BATCH)
    feat = tspec.features[0]
    p = _torch_tree(p_np)["axes"][0]
    finv = feat.inv_chol_kuu("matern12", p, 1e-6)
    xs = torch.tensor(x[:, 0])
    fused = feat.whitened_kuf_fused("matern12", p, finv, torch.tensor(0.3, dtype=torch.float64), xs)
    dense = feat.whitened_kuf_fused("matern12", p, finv, torch.tensor(0.8, dtype=torch.float64), xs)
    for f, d in zip(fused, dense):
        np.testing.assert_allclose(f.numpy(), d.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(d.abs().max()))


def test_adam_trajectory_matches_optax(setup):
    """5 Adam steps (optax.adam(1e-2) vs torch.optim.Adam(lr=1e-2)) on the
    same numpy batches: final constrained params rtol 1e-6."""
    jspec, tspec, p_np = setup[:3]
    batches = [_batch(s) for s in range(1, 6)]

    opt = optax.adam(1e-2)
    raw = jtrain.unconstrain(_jax_tree(p_np))
    st = opt.init(raw)
    for xb, yb in batches:
        val, g = jax.value_and_grad(
            lambda r: jsvgp.loss(jspec, jtrain.constrain(r), jnp.asarray(xb), jnp.asarray(yb)))(raw)
        raw, st = jtrain.guarded_update(opt, raw, st, val, g)
    want = _flat(jtrain.constrain(raw))

    traw = train.raw_leaves_from(_torch_tree(p_np))
    topt = torch.optim.Adam(train.tree_leaves(traw), lr=1e-2)
    step = train.make_step_fn(lambda p, xb, yb: svgp.loss(tspec, p, xb, yb), traw, topt)
    losses = [float(step(torch.tensor(xb), torch.tensor(yb))) for xb, yb in batches]
    assert all(np.isfinite(losses))
    with torch.no_grad():
        got = _torch_flat(train.constrain(traw))
    _assert_tree_close(got, want, 1e-6)


@pytest.mark.parametrize("predictive", [False, True])
def test_posterior_matches_jax(setup, predictive):
    """Mean and variance at 200 points, rtol 1e-9 (the predictive variance
    adds the noise)."""
    jspec, tspec, p_np = setup[:3]
    xs, _ = _batch(9, n=200)
    want = jsvgp.posterior(jspec, _jax_tree(p_np), jnp.asarray(xs), predictive=predictive)
    with torch.no_grad():
        got = svgp.posterior(tspec, _torch_tree(p_np), torch.tensor(xs), predictive=predictive)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want.mean)).max())
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-9)


def test_f32_loss_matches_jax_f64(setup):
    """The port in float32 against the f64 JAX loss, rtol 1e-4 (float32
    closed forms, the f32 jitter floor, and a 65 536-term KL trace)."""
    _, tspec, p_np, x, y, want, _ = setup
    got = svgp.loss(tspec, _torch_tree(p_np, torch.float32),
                    torch.tensor(x, dtype=torch.float32), torch.tensor(y, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-4)


def test_training_takes_tangent_path_and_serving_the_primal(setup, monkeypatch):
    """Under differentiation the forward reaches cell_kuf_with_dl (one call
    per axis) and never the primal cell_kuf; under no_grad the posterior
    reaches cell_kuf (one per axis) and no tangent."""
    _, tspec, p_np, x, y = setup[:5]
    calls = {"cell_kuf": 0, "cell_kuf_with_dl": 0}
    for name in calls:
        real = getattr(ck, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ck, name, spy)
    _torch_grads(tspec, p_np, x, y)
    assert calls == {"cell_kuf": 0, "cell_kuf_with_dl": 2}
    calls.update(cell_kuf=0, cell_kuf_with_dl=0)
    with torch.no_grad():
        svgp.posterior(tspec, _torch_tree(p_np), torch.tensor(x))
    assert calls == {"cell_kuf": 2, "cell_kuf_with_dl": 0}


def test_moments_backward_rides_the_model_precision(setup, monkeypatch):
    """The hand-written backward of the Kronecker moments runs its products
    at ``config.MATMUL_PRECISION`` (fp32 on the card), as every gradient
    product of the port."""
    _, tspec, p_np, x, y = setup[:5]
    seen, real_prec, real_bwd = [], svgp.matmul_precision, svgp.KronMoments.backward
    inside = []

    def backward(ctx, *grads):
        inside.append(1)
        try:
            return real_bwd(ctx, *grads)
        finally:
            inside.pop()

    monkeypatch.setattr(svgp, "matmul_precision",
                        lambda prec: (seen.append(prec) if inside else None) or real_prec(prec))
    monkeypatch.setattr(svgp.KronMoments, "backward", staticmethod(backward))
    _torch_grads(tspec, p_np, x, y)
    assert seen == [config.MATMUL_PRECISION]


# --------------------------------------------------------------------------- #
# module pieces
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ell", [0.003, 0.2, 5.0])
def test_kuu_lengthscale_tangent_matches_jax(ell):
    """The closed-form ∂(jittered Kuu)/∂ℓ against jax.jvp of the JAX
    package's jittered Kuu in f64, and against torch's own forward mode of
    the port's jittered Kuu: rtol 1e-9 (the closed form groups the terms
    differently from the traced derivative, and both cancel to O(d³) on the
    diagonal at small d = δ/ℓ)."""
    jf = JaxCellFeature.from_lims(M_AXIS, 0.0, 1.0)
    tf = CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0)
    rel, v = 1e-6, 1.3

    def jax_kuu(t):
        k = jf.Kuu("matern12", {"lengthscale": t, "variance": jnp.asarray(v)})
        k = 0.5 * (k + k.T)
        return k + jnp.mean(jnp.diagonal(k)) * rel * jnp.eye(k.shape[0])

    _, want = jax.jvp(jax_kuu, (jnp.asarray(ell),), (jnp.asarray(1.0),))
    want = np.asarray(want)
    v_t, ell_t = torch.tensor(v, dtype=torch.float64), torch.tensor(ell, dtype=torch.float64)
    got = common._kuu_jittered_dl(tf, "matern12", rel, ell_t, v_t)
    _, traced = torch.func.jvp(lambda t: common._kuu_jittered(tf, "matern12", rel, t, v_t),
                               (ell_t,), (torch.ones_like(ell_t),))
    for g in (got, traced):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("ell", [0.05, 0.2, 1.0])
def test_whitened_kuf_scalar_matches_jax(ell):
    """Primal (no grad) and tangent (grad) paths give the same a as JAX, and
    the scalar-tangent gradients match jax.grad: rtol 1e-10 and 1e-8."""
    from vggp_tpu.models import common as jcommon

    jf = JaxCellFeature.from_lims(M_AXIS, 0.0, 1.0)
    tf = CellIntegralFeature.from_lims(M_AXIS, 0.0, 1.0)
    rng = np.random.default_rng(11)
    x = rng.random(300)
    g = rng.standard_normal((M_AXIS, 300))
    v = 0.9

    def jfun(lv):
        a = jcommon.whitened_kuf_scalar(jf, "matern12", 1e-6,
                                        {"lengthscale": lv[0], "variance": lv[1]}, jnp.asarray(x))
        return jnp.sum(a * g), a

    (_, a_want), g_want = jax.value_and_grad(jfun, has_aux=True)(jnp.asarray([ell, v]))
    ell_t = torch.tensor(ell, dtype=torch.float64, requires_grad=True)
    v_t = torch.tensor(v, dtype=torch.float64, requires_grad=True)
    a_grad = common.whitened_kuf_scalar(tf, "matern12", 1e-6,
                                        {"lengthscale": ell_t, "variance": v_t}, torch.tensor(x))
    torch.sum(a_grad * torch.tensor(g)).backward()
    with torch.no_grad():
        a_primal = common.whitened_kuf_scalar(tf, "matern12", 1e-6,
                                              {"lengthscale": ell_t, "variance": v_t},
                                              torch.tensor(x))
    scale = np.abs(np.asarray(a_want)).max()
    for a in (a_grad, a_primal):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_want), rtol=1e-10,
                                   atol=1e-10 * scale)
    np.testing.assert_allclose([float(ell_t.grad), float(v_t.grad)], np.asarray(g_want),
                               rtol=1e-8)


def test_chol_raw_and_softplus_transforms_match_jax():
    rng = np.random.default_rng(12)
    raw = rng.standard_normal((6, 6))
    L = np.asarray(jsvgp.chol_from_raw(jnp.asarray(raw)))
    np.testing.assert_allclose(svgp.chol_from_raw(torch.tensor(raw)).numpy(), L, rtol=1e-14)
    np.testing.assert_allclose(svgp.raw_from_chol(torch.tensor(L)).numpy(),
                               np.asarray(jsvgp.raw_from_chol(jnp.asarray(L))), rtol=1e-12)
    p_np = _params_np(1)
    _assert_tree_close(_torch_flat(train.unconstrain(_torch_tree(p_np))),
                       _flat(jtrain.unconstrain(_jax_tree(p_np))), 1e-12)
    _assert_tree_close(_torch_flat(train.constrain(_torch_tree(p_np))),
                       _flat(jtrain.constrain(_jax_tree(p_np))), 1e-12)


def test_init_params_and_kl_match_jax():
    jspec, tspec = _specs()
    _assert_tree_close(_torch_flat(tspec.init_params(torch.float64, device="cpu")),
                       _flat(jspec.init_params(jnp.float64)), 1e-14)
    p_np = _params_np(2)
    np.testing.assert_allclose(float(svgp.kl(tspec, _torch_tree(p_np))),
                               float(jsvgp.kl(jspec, _jax_tree(p_np))), rtol=1e-10)


def test_params_round_trip():
    p_np = _params_np(3)
    back = convert.params_to_numpy(convert.params_from_jax(p_np, device="cpu"))
    assert isinstance(back["axes"], tuple)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(p_np), strict=True):
        np.testing.assert_array_equal(g, w)
    f32 = convert.params_from_jax(p_np, device="cpu", dtype=torch.float32)
    assert f32["q"]["mu"].dtype == torch.float32


def test_guarded_update_skips_nonfinite_step():
    w = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    opt = torch.optim.Adam([w], lr=0.1)
    loss = (w * torch.tensor([1.0, float("nan"), 1.0], dtype=torch.float64)).sum()
    loss.backward()
    assert not train.guarded_update(opt, [w], loss)
    assert torch.equal(w.detach(), torch.ones(3, dtype=torch.float64))
    assert len(opt.state) == 0       # the optimizer state was not touched either
    opt.zero_grad()
    loss = (w * w).sum()
    loss.backward()
    assert train.guarded_update(opt, [w], loss)
    assert not torch.equal(w.detach(), torch.ones(3, dtype=torch.float64))


def test_svgp_module_and_fit_minibatch():
    """The nn.Module holds the raw tree as Parameters and computes the same
    loss as the functional form; fit_minibatch lowers the loss."""
    _, tspec = _specs()
    p_np = _params_np(4)
    model = svgp.SVGP(tspec, _torch_tree(p_np), device="cpu")
    assert len(list(model.parameters())) == 2 * 2 + 1 + 3
    x, y = _batch(4)
    xt, yt = torch.tensor(x), torch.tensor(y)
    np.testing.assert_allclose(float(model(xt, yt).detach()),
                               float(svgp.loss(tspec, _torch_tree(p_np), xt, yt)), rtol=1e-12)
    final, hist = train.fit_minibatch(lambda p, xb, yb: svgp.loss(tspec, p, xb, yb),
                                      _torch_tree(p_np), xt, yt, n_iters=4,
                                      batch_size=256, learning_rate=1e-2, seed=0)
    assert torch.isfinite(hist["loss"]).all()
    assert float(svgp.loss(tspec, final, xt, yt)) < float(hist["loss"][0])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tspec = _specs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tspec.init_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        svgp.SVGP(tspec)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax(_params_np(5))
    assert tspec.init_params(device="cpu")["noise"].device.type == "cpu"


# Cases ported since they were written: each now checks that the port raises
# what the JAX package raises for the same call (an unknown kind in Kuf, a
# Matérn-1/2 axis in a gradient head, the Kronecker family on one axis now
# that the full family is ported, a per-output mean vector without a
# coregion axis now that the constant mean is, per-output noise without one
# under a non-Gaussian likelihood now that the noise vector is), or gives the
# value JAX gives (the coregion Gram, the clamped-eigh factor).
_RAISES_AS_JAX = {"kind": KeyError, "posterior_grad": ValueError, "full_family": ValueError,
                  "learned_mean": ValueError, "likelihood": ValueError}


def _ported_values_match_jax(what):
    """The coregion Gram of ``axis_gram`` at integer indices (rtol 1e-12),
    and the loss and the posterior of the 8×8-cell Kronecker SVGP under
    ``factor_method="eigh"`` at its initial parameters (μ = 0, S = I: the
    whitened coordinates' signs do not enter; rtol 1e-10 and 1e-9)."""
    rng = np.random.default_rng(1)
    if what == "coregion_gram":
        p_np = {"w": rng.standard_normal((3, 2)), "kappa": rng.uniform(0.1, 1.0, 3)}
        x1, x2 = np.array([0.0, 2.0, 1.0]), np.array([1.0, 0.0])
        got = vggp_tpu_torch.kernels.axis_gram("coregion", convert.params_from_jax(p_np, "cpu"),
                                               torch.tensor(x1), torch.tensor(x2))
        from vggp_tpu import kernels as jkernels

        want = jkernels.axis_gram("coregion", _jax_tree(p_np), jnp.asarray(x1), jnp.asarray(x2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        return
    kw = dict(kinds=("matern12",) * 2, num_data=10, variational="kron", factor_method="eigh")
    jspec = jsvgp.SVGPSpec(features=tuple(JaxCellFeature.from_lims(8, 0.0, 1.0)
                                          for _ in range(2)), **kw)
    tspec = svgp.SVGPSpec(features=tuple(CellIntegralFeature.from_lims(8, 0.0, 1.0)
                                         for _ in range(2)), **kw)
    p_np = jax.tree.map(np.asarray, jspec.init_params(jnp.float64))
    jp, tp = _jax_tree(p_np), convert.params_from_jax(p_np, "cpu")
    X, y, xs = rng.random((6, 2)), rng.random(6), rng.random((4, 2))
    np.testing.assert_allclose(float(svgp.loss(tspec, tp, torch.tensor(X), torch.tensor(y))),
                               float(jsvgp.loss(jspec, jp, jnp.asarray(X), jnp.asarray(y))),
                               rtol=1e-10)
    with torch.no_grad():
        got = svgp.posterior(tspec, tp, torch.tensor(xs))
    want = jsvgp.posterior(jspec, jp, jnp.asarray(xs))
    for g, w in ((got.mean, want.mean), (got.var, want.var)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9 * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("what", ["full_family", "likelihood", "kind", "learned_mean",
                                  "posterior_grad", "coregion_gram", "eigh_factor"])
def test_unported_options_raise(what):
    if what in ("coregion_gram", "eigh_factor"):
        _ported_values_match_jax(what)
        return
    feats = tuple(CellIntegralFeature.from_lims(8, 0.0, 1.0) for _ in range(2))
    jfeats = tuple(JaxCellFeature.from_lims(8, 0.0, 1.0) for _ in range(2))
    for pkg, fs in (("jax", jfeats), ("port", feats)):
        with pytest.raises(_RAISES_AS_JAX[what]):
            if what == "full_family":
                (jsvgp if pkg == "jax" else svgp).SVGPSpec(
                    kinds=("matern12",), features=fs[:1], num_data=10, variational="kron")
            elif what in ("learned_mean", "likelihood"):
                # a vector mean, or per-output noise under Student-t, on a
                # model without a coregion axis
                mod = jsvgp if pkg == "jax" else svgp
                lik = "student_t" if what == "likelihood" else "gaussian"
                spec = mod.SVGPSpec(kinds=("matern12",) * 2, features=fs, num_data=10,
                                    variational="kron", likelihood=lik)
                p0 = spec.init_params() if pkg == "jax" else spec.init_params(device="cpu")
                key = "mean" if what == "learned_mean" else "noise"
                vec, X, y = ((jnp.full(2, 0.1), jnp.ones((4, 2)) * 0.5, jnp.ones(4))
                             if pkg == "jax" else
                             (torch.full((2,), 0.1), torch.rand(4, 2), torch.rand(4)))
                mod.loss(spec, {**p0, key: vec}, X, y)
            elif what == "kind":
                p = ({"variance": jnp.asarray(1.0), "lengthscale": jnp.asarray(0.3)}
                     if pkg == "jax" else
                     {"variance": torch.tensor(1.0), "lengthscale": torch.tensor(0.3)})
                fs[0].Kuf("matern33", p, jnp.linspace(0, 1, 5) if pkg == "jax"
                          else torch.linspace(0, 1, 5))
            elif pkg == "jax":
                spec = jsvgp.SVGPSpec(kinds=("matern12",) * 2, features=fs, num_data=10,
                                      variational="kron")
                jsvgp.posterior_grad(spec, spec.init_params(), jnp.ones((4, 2)) * 0.5, 0)
            else:
                spec = svgp.SVGPSpec(kinds=("matern12",) * 2, features=fs, num_data=10,
                                     variational="kron")
                svgp.posterior_grad(spec, spec.init_params(device="cpu"), torch.rand(4, 2),
                                    axis=0)
