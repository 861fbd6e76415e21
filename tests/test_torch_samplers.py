"""The port's pathwise samplers (``vggp_tpu_torch.sampling.pathwise*``)
against the JAX package's ``vggp_tpu/sampling.py:658-1227``.

The samplers are held deterministically: both packages' draws are patched to
one numpy table (:func:`_patch_draws`) — the prior paths (plain and
chol(B)-mixed), the additive model's per-component frequencies and phases,
and the standard normals z (or the exact GP's ε) — the JAX side keyed as its
per-sample function splits its keys, the port's side in call order. Every
family's draws then agree at rtol 1e-8 in float64 on the CPU (JAX in x64,
each sampler one jitted program): the SVGP's Kronecker, full and ICM forms,
the collapsed GP and its ICM form, the free points, the exact GP with a
noise level per output, the additive model and an LMC sum, through the
``pathwise`` dispatch; ``pathwise_q_v`` on both SVGP families and the
collapsed GP (the port adds the learned mean's cell integrals there, a
departure); the joint gradient draws of the SVGP and the collapsed GP at
integer axes and at order tuples. The dispatch errors, one float32 case
against the JAX package's float32 error and the byte-budget split of the
samples (``iterative.SAMPLER_CHUNK_BYTES``) complete the file.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jf
from vggp_tpu import kernels as jkernels
from vggp_tpu import sampling as jsampling
from vggp_tpu.models import additive as jadditive
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import freesvgp as jfree
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import sum as jsum
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import convert, kernels, sampling
from vggp_tpu_torch import features as tf
from vggp_tpu_torch.models import additive, exact, freesvgp, iterative, sgpr, svgp
from vggp_tpu_torch.models import sum as msum

RTOL = 1e-8
S = 4
F = 32
N_STAR = 20


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


# --------------------------------------------------------------------------- #
# the models: (JAX spec, port spec, numpy params, X, y, x*) by name
# --------------------------------------------------------------------------- #

def _axis(rng):
    return {"variance": np.asarray(rng.uniform(0.6, 1.4)),
            "lengthscale": np.asarray(rng.uniform(0.2, 0.5))}


def _coregion(rng, P=2):
    return {"w": rng.standard_normal((P, 1)), "kappa": rng.uniform(0.1, 0.8, P)}


def _raw_l(rng, m):
    return np.tril(0.2 * rng.standard_normal((m, m)), -1) + np.diag(rng.uniform(-1.0, 0.5, m))


def _cells(pkg, *ms):
    return tuple(pkg.CellIntegralFeature.from_lims(m, 0.0, 1.0) for m in ms)


def _inputs(rng, n, co):
    """(n, 2) inputs on [0, 1]², or a column of output indices at ``co``."""
    X = rng.random((n, 2))
    if co is not None:
        X[:, co] = rng.integers(0, 2, n)
    return X


def _target(X, co):
    f = np.sin(5 * X[:, 0]) * (np.cos(4 * X[:, 1]) if co is None else 1.0)
    if co is not None:
        f = np.where(X[:, co] > 0.5, 0.7 * f + 0.2, f)
    return f + 0.05 * np.random.default_rng(1).standard_normal(X.shape[0])


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    co, data = None, True
    if name.startswith("svgp"):
        data = False
        if name == "svgp kron":
            kinds, ms, var, kw = ("matern12", "matern32"), (8, 6), "kron", {"learn_mean": True}
        elif name == "svgp full":
            kinds, ms, var, kw = ("matern12", "matern12"), (5, 4), "full", {"learn_mean": True}
        elif name == "svgp icm":
            kinds, ms, var, co = ("matern12", "coregion"), (8,), "kron", 1
            kw = {"learn_mean": True, "per_output_noise": True}
        else:                                            # "svgp grads"
            kinds, ms, var, kw = ("matern52", "matern52"), (9, 8), "kron", {"learn_mean": True}
        feats = lambda pkg: _cells(pkg, *ms) + ((pkg.OutputFeature(2),) if co else ())
        jspec = jsvgp.SVGPSpec(kinds=kinds, features=feats(jf), num_data=100, variational=var,
                               **kw)
        tspec = svgp.SVGPSpec(kinds=kinds, features=feats(tf), num_data=100, variational=var,
                              **kw)
        axes = tuple(_coregion(rng) if k == "coregion" else _axis(rng) for k in kinds)
        axis_m = jspec.axis_m
        if var == "full":
            q = {"mu": 0.3 * rng.standard_normal(jspec.num_inducing),
                 "raw_L": _raw_l(rng, jspec.num_inducing)}
        else:
            q = {"mu": 0.3 * rng.standard_normal(axis_m),
                 **{f"raw_L{i + 1}": _raw_l(rng, mi) for i, mi in enumerate(axis_m)}}
        p = {"axes": axes, "noise": np.array([0.03, 0.06]) if co else np.asarray(0.04),
             "q": q, "mean": np.array([0.2, -0.1]) if co else np.asarray(0.25)}
    elif name.startswith("collapsed"):
        if name == "collapsed icm":
            kinds, ms, co = ("matern12", "coregion"), (10,), 1
            kw = {"learn_mean": True, "per_output_noise": True}
        elif name == "collapsed grads":
            kinds, ms, kw = ("matern52", "matern52"), (9, 8), {"learn_mean": True}
        else:
            kinds, ms, kw = ("matern12", "matern32"), (8, 7), {"learn_mean": True}
        feats = lambda pkg: _cells(pkg, *ms) + ((pkg.OutputFeature(2),) if co else ())
        jspec = jsgpr.SGPRSpec(kinds=kinds, features=feats(jf), **kw)
        tspec = sgpr.SGPRSpec(kinds=kinds, features=feats(tf), **kw)
        axes = tuple(_coregion(rng) if k == "coregion" else _axis(rng) for k in kinds)
        p = {"axes": axes, "noise": np.array([0.03, 0.06]) if co else np.asarray(0.04),
             "mean": np.array([0.2, -0.1]) if co else np.asarray(0.25)}
    elif name == "free":
        kinds = ("matern12", "matern32")
        jspec, tspec = jfree.FreeSVGPSpec(kinds=kinds, m=6), freesvgp.FreeSVGPSpec(kinds=kinds, m=6)
        p = {"axes": tuple(_axis(rng) for _ in kinds), "z": rng.random((6, 2)),
             "noise": np.asarray(0.04)}
    elif name == "exact icm":
        kinds, co = ("matern32", "coregion"), 1
        kw = dict(n_outputs=2, per_output_noise=True, learn_mean=True)
        jspec, tspec = jexact.ExactGPSpec(kinds=kinds, **kw), exact.ExactGPSpec(kinds=kinds, **kw)
        p = {"axes": (_axis(rng), _coregion(rng)), "noise": np.array([0.03, 0.06]),
             "mean": np.array([0.2, -0.1])}
    elif name == "additive":
        kinds = ("matern12", "matern32")
        jspec = jadditive.AdditiveSGPRSpec(kinds=kinds, features=_cells(jf, 12, 9))
        tspec = additive.AdditiveSGPRSpec(kinds=kinds, features=_cells(tf, 12, 9))
        p = {"axes": tuple(_axis(rng) for _ in kinds), "noise": np.asarray(0.04)}
    else:                                                # "sum lmc"
        co = 1

        def comps(pkg, mod):
            return tuple(mod.SGPRSpec(kinds=(kind, "coregion"),
                                      features=(pkg.CellIntegralFeature.from_lims(m, 0.0, 1.0),
                                                pkg.OutputFeature(2)))
                         for kind, m in (("matern12", 5), ("matern32", 7)))

        kw = dict(per_output_noise=True, learn_mean=True)
        jspec = jsum.SumSGPRSpec(components=comps(jf, jsgpr), **kw)
        tspec = msum.SumSGPRSpec(components=comps(tf, sgpr), **kw)
        p = {"components": tuple({"axes": (_axis(rng), _coregion(rng))} for _ in range(2)),
             "noise": np.array([0.03, 0.06]), "mean": np.array([0.2, -0.1])}
    X = _inputs(rng, 48, co) if data else None
    y = _target(X, co) if data else None
    xs = _inputs(rng, N_STAR, co)
    return jspec, tspec, p, X, y, xs


# --------------------------------------------------------------------------- #
# one draw table, patched into both packages
# --------------------------------------------------------------------------- #

def _slots(name, jspec):
    """(the per-sample key split count, the draws of one sample in the
    port's call order): (kind, index of the JAX key that draws it, shape).
    Kinds: "path" (omegas (d, F), phases (F,)), "mo_path" (omegas
    (P, d_cont, F), phases (P, F)), "freq" (F,), "phase" (F,), "z"."""
    if name == "additive":
        d = jspec.ndim
        slots = []
        for i in range(d):
            slots += [("freq", 2 * i, (F,)), ("phase", 2 * i + 1, (F,))]
        return 2 * d + 1, slots + [("z", 2 * d, (jspec.num_inducing,))]
    if name == "sum lmc":
        Q = len(jspec.components)
        return Q + 1, [("mo_path", q, (2, 1, F)) for q in range(Q)] + [
            ("z", Q, (jspec.num_inducing,))]
    co = "coregion" in jspec.kinds
    path = ("mo_path", 0, (2, jspec.ndim - 1, F)) if co else ("path", 0, (jspec.ndim, F))
    if name.startswith("svgp"):
        z = jspec.axis_m if jspec.variational == "kron" else (jspec.num_inducing,)
    elif name == "exact icm":
        z = (48,)
    else:
        z = (jspec.num_inducing,)
    return 2, [path, ("z", 1, tuple(z))]


def _patch_draws(monkeypatch, name, jspec, key, n_samples, seed=13):
    """Patch both packages' draws for ``n_samples`` samples of the ``name``
    case's sampler to one numpy table. JAX's draws are looked up by the key
    each vmap lane holds (``key`` split into n_samples keys, each into the
    sampler's per-sample split); the port's come in call order."""
    n_split, slots = _slots(name, jspec)
    rng = np.random.default_rng(seed)
    tables = collections.defaultdict(lambda: ([], []))
    for ks in jax.random.split(key, n_samples):
        sub = jax.random.split(ks, n_split)
        for kind, idx, shape in slots:
            if kind in ("path", "mo_path"):
                val = (rng.standard_t(2.0, size=shape) * 4.0,
                       rng.random(shape[:-2] + (F,)) * 2 * np.pi)
            elif kind == "freq":
                val = rng.standard_t(2.0, size=shape) * 4.0
            elif kind == "phase":
                val = rng.random(shape) * 2 * np.pi
            else:
                val = rng.standard_normal(shape)
            tables[kind][0].append(np.asarray(sub[idx]))
            tables[kind][1].append(val)
    z_shapes = {tuple(shape) for kind, _, shape in slots if kind == "z"}

    def jrow(kind, k, part=None):
        keys, vals = tables[kind]
        j = jnp.argmax(jnp.all(k == jnp.asarray(np.stack(keys)), axis=-1))
        arr = np.stack([v if part is None else v[part] for v in vals])
        return jnp.asarray(arr)[j]

    def dtype_of(params):
        return jax.tree.leaves(params)[0].dtype

    def amp_of(params, xp):
        v = 1.0
        for ax in params["axes"]:
            if "variance" in ax:
                v = v * ax["variance"]
        return xp.sqrt(2.0 * v / F)

    def jpaths(k, spec, params, n_features):
        dt = dtype_of(params)
        return (jrow("path", k, 0).astype(dt), jrow("path", k, 1).astype(dt), amp_of(params, jnp))

    def jpaths_mo(k, spec, params, n_features):
        dt = dtype_of(params)
        co = spec.kinds.index("coregion")
        B = jkernels.coregion_b(params["axes"][co])
        LB = jnp.linalg.cholesky(B + 1e-10 * jnp.eye(B.shape[0], dtype=B.dtype))
        return (jrow("mo_path", k, 0).astype(dt), jrow("mo_path", k, 1).astype(dt),
                amp_of(params, jnp), LB, co)

    real_normal, real_uniform = jax.random.normal, jax.random.uniform

    def jnormal(k, shape=(), dtype=float):
        if tuple(shape) not in z_shapes:
            return real_normal(k, shape, dtype)
        return jrow("z", k).astype(dtype)

    monkeypatch.setattr(jsampling, "prior_paths", jpaths)
    monkeypatch.setattr(jsampling, "prior_paths_multioutput", jpaths_mo)
    monkeypatch.setattr(jax.random, "normal", jnormal)
    if "freq" in tables:
        monkeypatch.setattr(jsampling, "sample_frequencies",
                            lambda k, kind, ell, n: jrow("freq", k).astype(ell.dtype))
        monkeypatch.setattr(jax.random, "uniform",
                            lambda k, shape=(), dtype=float, minval=0.0, maxval=1.0:
                            jrow("phase", k) if tuple(shape) == (F,)
                            else real_uniform(k, shape, dtype, minval, maxval))

    rows = {kind: iter(vals) for kind, (_, vals) in tables.items()}

    def tleaf(params):
        return next(v for v in _leaves(params) if torch.is_tensor(v))

    def tpaths(gen, spec, params, n_features):
        om, ph = next(rows["path"])
        like = tleaf(params)
        return _t(om, like.dtype), _t(ph, like.dtype), amp_of(params, torch)

    def tpaths_mo(gen, spec, params, n_features):
        om, ph = next(rows["mo_path"])
        like = tleaf(params)
        co = spec.kinds.index(kernels.COREGION_KIND)
        B = kernels.coregion_b(params["axes"][co])
        LB = torch.linalg.cholesky(B + 1e-10 * torch.eye(B.shape[0], dtype=B.dtype))
        return _t(om, like.dtype), _t(ph, like.dtype), amp_of(params, torch), LB, co

    def tnormal(gen, shape, like):
        val = next(rows["z"])
        assert tuple(shape) == val.shape, (shape, val.shape)
        return _t(val, like.dtype)

    monkeypatch.setattr(sampling, "prior_paths", tpaths)
    monkeypatch.setattr(sampling, "prior_paths_multioutput", tpaths_mo)
    monkeypatch.setattr(sampling, "normal", tnormal)
    if "freq" in tables:
        monkeypatch.setattr(sampling, "sample_frequencies",
                            lambda gen, kind, ell, n: _t(next(rows["freq"]), ell.dtype))
        monkeypatch.setattr(sampling, "_phases",
                            lambda gen, n, like: _t(next(rows["phase"]), like.dtype))
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _both(p, dtype=np.float64):
    p = jax.tree.map(lambda v: np.asarray(v, dtype), p)
    return (jax.tree.map(jnp.asarray, p),
            convert.params_from_jax(p, device="cpu", dtype=torch.float64 if dtype == np.float64
                                    else torch.float32))


def _run_both(name, head, monkeypatch, dtype=np.float64, grad_axes=None):
    """The ``name`` case's sampler ``head`` ("pathwise", "q_v" or "grads")
    in both packages from one patched draw table → (port, JAX) draws."""
    jspec, tspec, p, X, y, xs = _case(name)
    jp, tp = _both(p, dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    key = jax.random.PRNGKey(7)
    rows = _patch_draws(monkeypatch, name, jspec, key, S)
    cast_j = lambda a: None if a is None else jnp.asarray(a, dtype)
    cast_t = lambda a: None if a is None else _t(a, tdt)
    data_j = None if X is None else (cast_j(X), cast_j(y))
    data_t = None if X is None else (cast_t(X), cast_t(y))
    kw = dict(n_samples=S, n_features=F)
    gen = torch.Generator()
    if head == "pathwise":
        want = jax.jit(lambda p, d, xs: jsampling.pathwise(jspec, p, key, xs, data=d, **kw))(
            jp, data_j, cast_j(xs))
        got = sampling.pathwise(tspec, tp, gen, cast_t(xs), data=data_t, **kw)
    elif head == "q_v":
        grids = lambda pkg: _cells(pkg, 5, 4)
        want = jax.jit(lambda p, d: jsampling.pathwise_q_v(jspec, p, key, grids(jf), data=d,
                                                           **kw))(jp, data_j)
        got = sampling.pathwise_q_v(tspec, tp, gen, grids(tf), data=data_t, **kw)
    elif data_j is None:
        want = jax.jit(lambda p, xs: jsampling.pathwise_posterior_with_grads(
            jspec, p, key, xs, grad_axes, **kw))(jp, cast_j(xs))
        got = sampling.pathwise_posterior_with_grads(tspec, tp, gen, cast_t(xs), grad_axes, **kw)
    else:
        want = jax.jit(lambda p, d, xs: jsampling.pathwise_posterior_collapsed_with_grads(
            jspec, p, key, *d, xs, grad_axes, **kw))(jp, data_j, cast_j(xs))
        got = sampling.pathwise_posterior_collapsed_with_grads(tspec, tp, gen, *data_t,
                                                               cast_t(xs), grad_axes, **kw)
    for it in rows.values():                      # the port drew every row of the table
        assert next(it, None) is None
    return got, np.asarray(want)


FAMILIES = ("svgp kron", "svgp full", "svgp icm", "collapsed", "collapsed icm", "free",
            "exact icm", "additive", "sum lmc")


@pytest.mark.parametrize("name", FAMILIES)
def test_pathwise_matches_jax(name, monkeypatch):
    """``pathwise`` of every family from one draw table: rtol 1e-8, the
    mean where JAX adds it (the SVGP, collapsed, exact and sum samplers)."""
    got, want = _run_both(name, "pathwise", monkeypatch)
    assert got.shape == (S, N_STAR)
    _close(got, want)


@pytest.mark.parametrize("name", ("svgp kron", "svgp full", "collapsed"))
def test_pathwise_q_v_matches_jax(name, monkeypatch):
    """``pathwise_q_v`` on a 5×4 grid of cells for the SVGP's two families
    and the collapsed GP: rtol 1e-8 against JAX's draws plus JAX's
    ``common.grid_mean`` of the learned mean, which the port adds and JAX
    does not (ROADMAP queue 3, item 14)."""
    from vggp_tpu.models import common as jcommon

    got, want = _run_both(name, "q_v", monkeypatch)
    jspec, _, p, *_ = _case(name)
    offset = np.asarray(jcommon.grid_mean(jspec, _both(p)[0], _cells(jf, 5, 4)))
    assert got.shape == (S, 20)
    _close(got, want + offset)


@pytest.mark.parametrize("grad_axes", [(0, 1), ((2, 0),), ((1, 1), 0)],
                         ids=["axes 0 1", "order (2, 0)", "order (1, 1) and axis 0"])
@pytest.mark.parametrize("name", ("svgp grads", "collapsed grads"))
def test_pathwise_with_grads_matches_jax(name, grad_axes, monkeypatch):
    """The joint (f, ∂f) draws on Matérn-5/2 cells at integer axes and
    per-axis order tuples, the SVGP's and the collapsed GP's: rtol 1e-8,
    the mean on row 0 only."""
    got, want = _run_both(name, "grads", monkeypatch, grad_axes=grad_axes)
    assert got.shape == (S, 1 + len(grad_axes), N_STAR)
    _close(got, want)


def test_with_grads_rejects_what_jax_rejects():
    """A derivative order the kind cannot take raises JAX's ValueError:
    ∂/∂x on Matérn-1/2, ∂² on Matérn-3/2, an order tuple of the wrong
    length."""
    for kinds, entry in ((("matern12", "matern12"), 0), (("matern32", "matern32"), (2, 0)),
                         (("matern52", "matern52"), (1, 0, 0))):
        msgs = []
        for pkg, sv, smp, arr, gen in (
                (jf, jsvgp, jsampling, jnp.zeros((3, 2)), jax.random.PRNGKey(0)),
                (tf, svgp, sampling, torch.zeros((3, 2), dtype=torch.float64),
                 torch.Generator())):
            spec = sv.SVGPSpec(kinds=kinds, features=_cells(pkg, 4, 4), num_data=3,
                               variational="kron")
            p = (spec.init_params(jnp.float64) if pkg is jf
                 else spec.init_params(torch.float64, device="cpu"))
            with pytest.raises(ValueError) as err:
                smp.pathwise_posterior_with_grads(spec, p, gen, arr, (entry,), n_samples=1,
                                                  n_features=4)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_dispatch_errors_match_jax():
    """``pathwise`` without data for a collapsed or exact spec (ValueError),
    on an unknown spec (NotImplementedError); ``pathwise_q_v`` without data
    for the collapsed GP (ValueError) and on another family
    (NotImplementedError): the JAX package's types and messages."""
    class Other:
        kinds = ("matern12",)

    jspec, tspec, p, X, y, xs = _case("collapsed")
    ejspec, etspec = jexact.ExactGPSpec(kinds=("matern12",)), exact.ExactGPSpec(kinds=("matern12",))
    jp, tp = _both(p)
    key, gen = jax.random.PRNGKey(0), torch.Generator()
    xj, xt = jnp.asarray(xs), _t(xs)
    cases = [
        (lambda: jsampling.pathwise(jspec, jp, key, xj),
         lambda: sampling.pathwise(tspec, tp, gen, xt), ValueError),
        (lambda: jsampling.pathwise(ejspec, jp, key, xj),
         lambda: sampling.pathwise(etspec, tp, gen, xt), ValueError),
        (lambda: jsampling.pathwise(Other(), jp, key, xj, data=(xj, xj)),
         lambda: sampling.pathwise(Other(), tp, gen, xt, data=(xt, xt)), NotImplementedError),
        (lambda: jsampling.pathwise_q_v(jspec, jp, key, _cells(jf, 3, 3)),
         lambda: sampling.pathwise_q_v(tspec, tp, gen, _cells(tf, 3, 3)), ValueError),
        (lambda: jsampling.pathwise_q_v(ejspec, jp, key, _cells(jf, 3, 3)),
         lambda: sampling.pathwise_q_v(etspec, tp, gen, _cells(tf, 3, 3)), NotImplementedError),
    ]
    for jfn, tfn, err in cases:
        msgs = []
        for fn in (jfn, tfn):
            with pytest.raises(err) as info:
                fn()
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def test_float32_within_twice_jax_error(monkeypatch):
    """The Kronecker SVGP's draws in float32 from the same draw table as
    float64: the port's float32 error within twice the JAX package's."""
    got64, want64 = _run_both("svgp kron", "pathwise", monkeypatch)
    got32, want32 = _run_both("svgp kron", "pathwise", monkeypatch, dtype=np.float32)
    assert got32.dtype == torch.float32 and want32.dtype == np.float32
    scale = np.abs(want64).max()
    e_port = np.abs(_np(got32).astype(np.float64) - _np(got64)).max() / scale
    e_jax = np.abs(want32.astype(np.float64) - want64).max() / scale
    assert e_port <= 2.0 * e_jax, (e_port, e_jax)


def test_chunked_samples_equal_one_batch(monkeypatch):
    """With ``iterative.SAMPLER_CHUNK_BYTES`` below one sample's
    (m / m_d, n*) intermediate the Kronecker contraction runs one sample a
    slice: the same draws as one batch (rtol 1e-12), from the generator's
    own draws. The first samples of a larger S are the draws of a smaller
    one: each sample draws its path and z in turn."""
    _, tspec, p, _, _, xs = _case("svgp kron")
    tp = convert.params_from_jax(p, device="cpu", dtype=torch.float64)
    run = lambda n: sampling.pathwise_posterior(tspec, tp, torch.Generator().manual_seed(3),
                                                _t(xs), n_samples=n, n_features=F)
    one = run(5)
    calls = []
    real = iterative._in_chunks
    monkeypatch.setattr(iterative, "_in_chunks",
                        lambda fn, X, row_bytes: calls.append(row_bytes) or real(fn, X, row_bytes))
    monkeypatch.setattr(iterative, "SAMPLER_CHUNK_BYTES", 8 * 20 * 8)
    split = run(5)
    assert calls == [8 * N_STAR * 8]
    _close(split, one, 1e-12)
    _close(run(2), one[:2], 1e-12)
    assert math.isfinite(float(one.abs().max()))


def test_pathwise_q_v_adds_the_learned_mean(monkeypatch):
    """``pathwise_q_v`` adds a learned mean's cell integrals, as ``q_v``
    does: a recorded departure from the JAX package, whose draws leave the
    mean out (ROADMAP queue 3, item 14). From one patched draw table, the
    port's draws with the mean at 0.7 equal JAX's draws plus JAX's
    ``common.grid_mean``, and with the mean at 0 JAX's draws, at rtol 1e-12."""
    from vggp_tpu.models import common as jcommon

    jspec, tspec, p, _, _, _ = _case("svgp kron")
    grids = lambda pkg: _cells(pkg, 5, 4)
    key = jax.random.PRNGKey(2)
    for mean in (0.7, 0.0):
        jp, tp = _both({**p, "mean": np.asarray(mean)})
        _patch_draws(monkeypatch, "svgp kron", jspec, key, 3)
        got = sampling.pathwise_q_v(tspec, tp, torch.Generator(), grids(tf), n_samples=3,
                                    n_features=F)
        want = np.asarray(jax.jit(lambda p: jsampling.pathwise_q_v(
            jspec, p, key, grids(jf), n_samples=3, n_features=F))(jp))
        offset = np.asarray(jcommon.grid_mean(jspec, jp, grids(jf)))
        if mean == 0.0:
            _close(got, want, 1e-12)
        else:
            assert np.abs(offset).min() > 0.0
            _close(got, want + offset, 1e-12)
