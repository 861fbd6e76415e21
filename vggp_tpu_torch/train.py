"""Parameter transforms, init heuristics, training loops, checkpoints and
metrics of the port (``vggp_tpu/train.py``, all of it): the transforms,
``non_informative_init``, ``informative_init``, ``fit``, ``fit_minibatch``,
``make_step_fn``, the restarts, ``fit_lbfgs``, ``fit_natgrad``, the
checkpoints, ``MetricsLogger`` and ``profile_trace``.

Positive hyperparameters (variance, lengthscale, noise) live unconstrained
under a floored softplus; models always see constrained values. ``fit``,
``fit_minibatch`` and the restarts step ``torch.optim.Adam`` on the raw
leaves; ``fit_natgrad`` steps Adam as optax writes it, with its guard on the
device; ``fit_lbfgs`` is optax's L-BFGS (``lbfgs.py``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from vggp_tpu_torch.tracing import span, traced

POSITIVE_KEYS = ("variance", "lengthscale", "noise", "kappa")

# Positivity floors added under the softplus bijector (the noise floor keeps
# the float32 ELBO's cancellation error from rewarding σ² → 0).
FLOORS = {"noise": 1e-6, "variance": 1e-8, "lengthscale": 1e-8, "kappa": 1e-8}


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """log(e^y − 1), stable for large y."""
    return y + torch.log(-torch.expm1(-y))


def _map_positive(tree, fn):
    """Apply ``fn(key, value)`` to the values under POSITIVE_KEYS anywhere in
    a nested dict/tuple/list; leave everything else as it is. ``fn`` is
    called in sorted-key order (the order ``jax.tree`` visits a dict, which
    ``init_restarts``'s draws follow); each dict keeps its own key order."""
    if isinstance(tree, dict):
        done = {k: (fn(k, tree[k]) if k in POSITIVE_KEYS else _map_positive(tree[k], fn))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_positive(v, fn) for v in tree)
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/tuple/list, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def sorted_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, sequences
    in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in sorted_leaves(v)]
    return [tree]


def ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """(flat, unravel) as ``jax.flatten_util.ravel_pytree`` gives them: the
    leaves in :func:`sorted_leaves` order, each flattened, concatenated in
    their common dtype. ``unravel(v)`` rebuilds the tree (its containers and
    key order) from views of ``v``, so a gradient flows back to ``v``; a
    ``v`` of shape (…, p) gives leaves with the same leading axes."""
    leaves = sorted_leaves(tree)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    shapes = [leaf.shape for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])

    def unravel(v: torch.Tensor):
        parts, off = [], 0
        for shape in shapes:
            size = math.prod(shape)
            parts.append(v[..., off:off + size].reshape(v.shape[:-1] + shape))
            off += size
        it = iter(parts)

        def build(t):
            if isinstance(t, dict):
                got = {k: build(t[k]) for k in sorted(t)}
                return {k: got[k] for k in t}
            if isinstance(t, (tuple, list)):
                return type(t)(build(x) for x in t)
            return next(it)

        return build(tree)

    return flat, unravel


def unconstrain(params: Dict) -> Dict:
    """Constrained → unconstrained (softplus⁻¹ on positive leaves, floored)."""
    return _map_positive(
        params, lambda k, v: inv_softplus(torch.clamp(v - FLOORS[k], min=1e-10)))


def constrain(raw_params: Dict) -> Dict:
    """Unconstrained → constrained (floor + softplus on positive leaves)."""
    return _map_positive(raw_params, lambda k, v: FLOORS[k] + softplus(v))


def _init_axes(params: Dict, X: torch.Tensor, variance, lmbda: float) -> tuple:
    """The axes with variance ← ``variance`` and lengthscale_i ← std(x_i)/λ
    (population moments, as ``jnp.std``), writing only the keys an axis has:
    a coregion axis keeps its W and κ."""
    if X.dim() == 1:
        X = X[:, None]
    out = []
    for i, p in enumerate(params["axes"]):
        q = dict(p)
        if "variance" in q:
            q["variance"] = torch.as_tensor(variance, dtype=p["variance"].dtype,
                                            device=p["variance"].device)
        if "lengthscale" in q:
            q["lengthscale"] = (torch.std(X[:, i], correction=0) / lmbda).to(p["lengthscale"])
        out.append(q)
    return tuple(out)


def _like(value: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``value`` in ``leaf``'s dtype, device and shape (a per-output vector
    keeps its shape)."""
    return value.to(leaf).expand_as(leaf).clone()


def non_informative_init(params: Dict, X: torch.Tensor, y: torch.Tensor,
                         lmbda: float = 1.0, kappa: float = 2.0) -> Dict:
    """variance ← var(y); noise ← variance/κ²; lengthscale_i ← std(x_i)/λ;
    a learned mean ← the sample mean of y. A sum of kernels inits every
    component's axes so; the noise and the mean keep their shapes."""
    y = y.reshape(-1)
    yvar = torch.var(y, correction=0)
    out = dict(params)
    if "components" in params:
        out["components"] = tuple({**cp, "axes": _init_axes(cp, X, yvar, lmbda)}
                                  for cp in params["components"])
    else:
        out["axes"] = _init_axes(params, X, yvar, lmbda)
    out["noise"] = _like(yvar / kappa ** 2, params["noise"])
    if "mean" in params:
        out["mean"] = _like(torch.mean(y), params["mean"])
    return out


def informative_init(params: Dict, X: torch.Tensor, y: torch.Tensor,
                     prior_amplitude: float, lmbda: float = 1.0) -> Dict:
    """variance ← (amplitude/2)²; noise ← max(var(y) − variance, 1e-6·var(y));
    lengthscale_i ← std(x_i)/λ."""
    var = (prior_amplitude / 2.0) ** 2
    yvar = torch.var(y.reshape(-1), correction=0)
    return {**params, "axes": _init_axes(params, X, var, lmbda),
            "noise": _like(torch.maximum(yvar - var, 1e-6 * yvar), params["noise"])}


@traced("vggp.entry.update")
def guarded_update(optimizer: torch.optim.Optimizer, leaves, val: torch.Tensor) -> bool:
    """Take the optimizer step only when the loss and every gradient are
    finite; otherwise skip it whole, optimizer state included — the
    counterpart of the JAX package's branch-free ``guarded_update``.

    Reads one boolean back to the host per step. Returns whether the step
    was taken.
    """
    finite = torch.isfinite(val.detach())
    for p in leaves:
        if p.grad is not None:
            finite = finite & torch.isfinite(p.grad).all()
    with span("vggp.sync.guarded_update"):
        ok = bool(finite)
    if not ok:
        return False
    optimizer.step()
    return True


def make_step_fn(loss_fn: Callable, raw: Dict, optimizer: torch.optim.Optimizer):
    """A single training step over the raw parameters.

    ``loss_fn(params, *args)`` takes constrained params; ``raw`` is the raw
    tree whose leaves ``optimizer`` holds (e.g. ``SVGP.raw_params()``).
    ``step(*args)`` computes the loss and its gradient, applies the guarded
    update and returns the loss (detached).
    """
    leaves = tree_leaves(raw)

    def step(*args) -> torch.Tensor:
        with span("vggp.entry.step"):
            optimizer.zero_grad(set_to_none=True)
            val = loss_fn(constrain(raw), *args)
            with span("vggp.entry.backward"):
                val.backward()
            guarded_update(optimizer, leaves, val)
            return val.detach()

    return step


def raw_leaves_from(params: Dict) -> Dict:
    """The raw tree of ``params`` with every leaf a fresh tensor that
    requires grad — the state a functional fit optimizes."""
    return tree_map(lambda v: v.detach().clone().requires_grad_(True), unconstrain(params))


def _history_entry(params: Dict, loss_val: torch.Tensor) -> Dict:
    """One step's record: the loss and ELBO, the noise, and each axis's
    ``scale_sigma_i`` and ``lengthscale_i`` (a coregion axis: its B diagonal
    ``coregion_bdiag_i``); a sum of kernels keeps no per-axis traces."""
    from vggp_tpu_torch import kernels

    h = {"loss": loss_val, "elbo": -loss_val, "noise": params["noise"]}
    if "axes" not in params:
        return h
    for i, p in enumerate(params["axes"]):
        if "variance" in p:
            h[f"scale_sigma_{i + 1}"] = p["variance"]
            h[f"lengthscale_{i + 1}"] = p["lengthscale"]
        else:
            h[f"coregion_bdiag_{i + 1}"] = kernels.coregion_b_diag(p)
    return h


def _frozen_leaves(raw, mask) -> list:
    """The leaves of ``raw`` whose entry in the same-structured ``mask`` is False."""
    if isinstance(raw, dict):
        return [leaf for k in raw for leaf in _frozen_leaves(raw[k], mask[k])]
    if isinstance(raw, (tuple, list)):
        return [leaf for r, m in zip(raw, mask, strict=True) for leaf in _frozen_leaves(r, m)]
    return [] if mask else [raw]


def fit(loss_fn: Callable[[Dict], torch.Tensor], params: Dict, n_iters: int,
        learning_rate: float = 0.1,
        trainable: Optional[Callable[[Dict], Dict]] = None) -> Tuple[Dict, Dict]:
    """Full-batch fit: ``n_iters`` guarded ``torch.optim.Adam`` steps.

    ``loss_fn(params)`` takes constrained params. ``trainable(params)``
    gives a tree of bools of the same structure: the gradients of the False
    leaves are zeroed before each update, so they keep their initial values
    exactly. Returns (final constrained params, history): each entry of the
    history a tensor over the steps, the loss before the step and the
    parameters after it, as the JAX package records them.
    """
    raw = raw_leaves_from(params)
    leaves = tree_leaves(raw)
    frozen = [] if trainable is None else _frozen_leaves(raw, trainable(params))
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    hist = []
    for _ in range(n_iters):
        opt.zero_grad(set_to_none=False)
        val = loss_fn(constrain(raw))
        val.backward()
        for leaf in frozen:
            if leaf.grad is not None:
                leaf.grad.zero_()
        guarded_update(opt, leaves, val)
        with torch.no_grad():
            hist.append(_history_entry(constrain(raw), val.detach()))
    history = {k: torch.stack([h[k] for h in hist]) for k in hist[0]} if hist else {}
    with torch.no_grad():
        final = constrain(tree_map(lambda v: v.detach(), raw))
    return final, history


def _randint(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """``size`` uniform indices in [0, n) from ``gen``, on ``device``."""
    return torch.randint(0, n, (size,), generator=gen, device=gen.device).to(device)


def fit_minibatch(
    loss_fn: Callable[[Dict, torch.Tensor, torch.Tensor], torch.Tensor],
    params: Dict,
    X: torch.Tensor,
    y: torch.Tensor,
    n_iters: int,
    batch_size: int,
    learning_rate: float = 0.01,
    seed: int = 0,
    generator_device=None,
) -> Tuple[Dict, Dict]:
    """Stochastic fit with ``torch.optim.Adam``: each step draws a uniform
    minibatch (with replacement) from a ``torch.Generator`` seeded with
    ``seed`` on ``generator_device`` (the data's device by default). With
    ``generator_device="cpu"`` the indices are copied to the data's device
    each step, and one seed gives the same batches on every device. Returns
    (final constrained params, history of per-step losses and ELBOs).
    """
    raw = raw_leaves_from(params)
    opt = torch.optim.Adam(tree_leaves(raw), lr=learning_rate)
    step = make_step_fn(loss_fn, raw, opt)
    y = y.reshape(-1)
    n = y.shape[0]
    gen = torch.Generator(device=X.device if generator_device is None else generator_device)
    gen.manual_seed(seed)
    losses = []
    for _ in range(n_iters):
        idx = _randint(gen, n, batch_size, X.device)
        losses.append(step(X[idx], y[idx]))
    losses = torch.stack(losses)
    with torch.no_grad():
        final = constrain(tree_map(lambda v: v.detach(), raw))
    return final, {"loss": losses, "elbo": -losses}


# --------------------------------------------------------------------------- #
# multi-start fitting and L-BFGS
# --------------------------------------------------------------------------- #

def init_restarts(params: Dict, gen: torch.Generator, n_restarts: int,
                  spread: float = 0.5) -> Dict:
    """Batch a base init into ``n_restarts`` starts along a new leading axis.

    Restart 0 is the base init verbatim; restarts 1.. multiply every
    positive hyperparameter (``POSITIVE_KEYS`` leaves) by an independent
    ``exp(spread · N(0, 1))`` factor, one draw of (R, …) per leaf from
    ``gen`` (``sampling.normal``), the leaves visited as the JAX package
    visits them (dict keys sorted). Other leaves are tiled unchanged. Feed the result to
    :func:`fit_restarts`.
    """
    from vggp_tpu_torch import sampling

    tiled = tree_map(lambda v: v.expand((n_restarts,) + tuple(v.shape)).clone(), params)

    def jitter(_k, v):
        factor = torch.exp(spread * sampling.normal(gen, v.shape, v))
        factor[0] = 1.0
        return v * factor

    return _map_positive(tiled, jitter)


def fit_restarts(loss_fn: Callable[[Dict], torch.Tensor], params_batch: Dict, n_iters: int,
                 learning_rate: float = 0.1) -> Tuple[Dict, Dict]:
    """Multi-start fit: :func:`fit` from each restart of ``params_batch``
    (every leaf with a leading restart axis, e.g. from
    :func:`init_restarts`), one after another — the JAX package ``vmap``s
    them into one program. Returns ``(best_params, hist)``: the restart with
    the lowest final loss (a non-finite one counts as +inf), and its
    history entries stacked to (R, n_iters) with ``hist["best"]`` the
    winning index."""
    n_restarts = tree_leaves(params_batch)[0].shape[0]
    finals, hists = [], []
    for r in range(n_restarts):
        final, hist = fit(loss_fn, tree_map(lambda v: v[r], params_batch), n_iters,
                          learning_rate)
        finals.append(final)
        hists.append(hist)
    hist = {k: torch.stack([h[k] for h in hists]) for k in hists[0]}
    last = hist["loss"][:, -1]
    best = int(torch.argmin(torch.where(torch.isfinite(last), last,
                                        torch.full_like(last, math.inf))))
    hist["best"] = best
    return finals[best], hist


def fit_lbfgs(loss_fn: Callable[[Dict], torch.Tensor], params: Dict, n_iters: int = 100,
              memory_size: int = 10) -> Tuple[Dict, Dict]:
    """Full-batch fit with optax's L-BFGS and zoom line search
    (:mod:`vggp_tpu_torch.lbfgs`) on the raw parameters flattened as
    ``ravel_pytree`` flattens them.

    For smooth full-batch objectives (exact MLL, collapsed ELBO); each
    iteration costs one or more loss evaluations in the line search. A step
    whose iterate is not finite everywhere is dropped with its optimizer
    state. Returns (params, history): the loss before each step and the
    parameters after it; the history flatlines once the search finds no
    step.
    """
    from vggp_tpu_torch import lbfgs

    flat, unravel = ravel(tree_map(lambda v: v.detach(), unconstrain(params)))

    def value_and_grad(v):
        v = v.detach().requires_grad_(True)
        val = loss_fn(constrain(unravel(v)))
        (g,) = torch.autograd.grad(val, v)
        return val.detach(), g

    state = lbfgs.init(flat, memory_size)
    hist = []
    for _ in range(n_iters):
        new, new_state, val, _ = lbfgs.step(value_and_grad, flat, state)
        if bool(torch.isfinite(new).all()):
            flat, state = new, new_state
        with torch.no_grad():
            hist.append(_history_entry(constrain(unravel(flat)),
                                       torch.as_tensor(val, dtype=flat.dtype, device=flat.device)))
    history = {k: torch.stack([h[k] for h in hist]) for k in hist[0]} if hist else {}
    with torch.no_grad():
        return constrain(unravel(flat.clone())), history


# --------------------------------------------------------------------------- #
# natural gradients
# --------------------------------------------------------------------------- #

class _Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) on a list of tensors, its
    update and state taken or kept whole by a device-side select (the
    JAX package's ``guarded_update``): no host read."""

    def __init__(self, leaves, lr: float):
        self.lr = lr
        self.mu = [torch.zeros_like(v) for v in leaves]
        self.nu = [torch.zeros_like(v) for v in leaves]
        self.count = torch.zeros((), dtype=torch.int64, device=leaves[0].device)

    def step(self, leaves, grads, ok: torch.Tensor) -> list:
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = self.count + 1
        out, mus, nus = [], [], []
        for v, g, mu, nu in zip(leaves, grads, self.mu, self.nu):
            t = count.to(v.dtype)
            mu_n = (1.0 - b1) * g + b1 * mu
            nu_n = (1.0 - b2) * (g * g) + b2 * nu
            mu_hat = mu_n / (1.0 - torch.pow(b1, t))
            nu_hat = nu_n / (1.0 - torch.pow(b2, t))
            new = v + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))
            out.append(torch.where(ok, new, v))
            mus.append(torch.where(ok, mu_n, mu))
            nus.append(torch.where(ok, nu_n, nu))
        self.mu, self.nu = mus, nus
        self.count = torch.where(ok, count, self.count)
        return out


def _natural_to_moments(th1: torch.Tensor, th2: torch.Tensor):
    """(μ, S) from natural parameters θ₁ = S⁻¹μ, θ₂ = −½S⁻¹."""
    sinv = -2.0 * th2
    L = torch.linalg.cholesky_ex(0.5 * (sinv + sinv.T))[0]   # PD by the step's guard
    S = torch.cholesky_inverse(L)
    S = 0.5 * (S + S.T)
    return S @ th1, S


def fit_natgrad(spec, params: Dict, X: torch.Tensor, y: torch.Tensor, n_iters: int,
                gamma: float = 0.5, hyper_lr: float = 0.01, batch_size: Optional[int] = None,
                seed: int = 0) -> Tuple[Dict, Dict]:
    """Hybrid trainer of the full-family whitened SVGP: natural-gradient
    steps on q, Adam on the hyperparameters (``train.py:414-524``).

    With θ₁ = S⁻¹μ, θ₂ = −½S⁻¹ and dL/dξ₁ = ∇_μL − 2(∇_S L)μ, dL/dξ₂ = ∇_S L
    of ``svgp.elbo_muS``, the step is θ ← θ − γ·dL/dξ. For a Gaussian
    likelihood and the full batch, γ = 1 lands on the optimal q(u) in one
    step; other likelihoods take γ < 1. A step that leaves −2θ₂ not
    positive definite (``cholesky_ex``) or any part non-finite is dropped by
    a device-side select, and so is a non-finite hyperparameter step.
    Minibatch indices come from a ``torch.Generator`` seeded with ``seed``
    on the data's device. Returns (params with q as (μ, raw_L), history of
    the losses and ELBOs).
    """
    from vggp_tpu_torch.models import svgp as _svgp
    from vggp_tpu_torch.ops.chol import safe_cholesky

    if getattr(spec, "variational", "full") != "full":
        raise ValueError(
            "fit_natgrad requires the full variational family (the Kronecker-"
            "factored covariance is not an exponential family, so the natural-"
            "gradient step has no closed form); use train.fit_minibatch for "
            "variational='kron'")
    y = y.reshape(-1)
    n = y.shape[0]
    q0 = params["q"]
    with torch.no_grad():
        L0 = _svgp.chol_from_raw(q0["raw_L"])
        S0 = L0 @ L0.T
        th1 = torch.linalg.solve(S0, q0["mu"])
        th2 = -0.5 * torch.linalg.inv(S0)
    raw = raw_leaves_from({k: v for k, v in params.items() if k != "q"})
    leaves = tree_leaves(raw)
    opt = _Adam(leaves, hyper_lr)
    gen = torch.Generator(device=X.device)
    gen.manual_seed(seed)
    losses = []
    for _ in range(n_iters):
        with torch.no_grad():
            mu, S = _natural_to_moments(th1, th2)
        if batch_size is None:
            xb, yb = X, y
        else:
            idx = _randint(gen, n, batch_size, X.device)
            xb, yb = X[idx], y[idx]
        mu, S = mu.requires_grad_(True), S.requires_grad_(True)
        p = dict(constrain(raw))
        p["q"] = None
        val = -_svgp.elbo_muS(spec, p, mu, S, xb, yb)
        *g_h, g_mu, g_S = torch.autograd.grad(val, leaves + [mu, S], allow_unused=True)
        with torch.no_grad():
            g_h = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, g_h)]
            g_S = 0.5 * (g_S + g_S.T)
            new_th1 = th1 - gamma * (g_mu - 2.0 * (g_S @ mu))
            new_th2 = th2 - gamma * g_S
            probe, info = torch.linalg.cholesky_ex(-2.0 * 0.5 * (new_th2 + new_th2.T))
            finite_val = torch.isfinite(val)
            ok = (finite_val & torch.isfinite(new_th1).all() & (info == 0)
                  & torch.isfinite(probe).all())
            th1 = torch.where(ok, new_th1, th1)
            th2 = torch.where(ok, new_th2, th2)
            finite = finite_val
            for g in g_h:
                finite = finite & torch.isfinite(g).all()
            for leaf, new in zip(leaves, opt.step(leaves, g_h, finite)):
                leaf.copy_(new)
            losses.append(val.detach())
    with torch.no_grad():
        mu, S = _natural_to_moments(th1, th2)
        out = constrain(tree_map(lambda v: v.detach().clone(), raw))
        out["q"] = {"mu": mu, "raw_L": _svgp.raw_from_chol(safe_cholesky(S, 1e-10))}
    losses = torch.stack(losses) if losses else torch.zeros(0)
    return out, {"loss": losses, "elbo": -losses}


# --------------------------------------------------------------------------- #
# checkpoints, metrics, tracing
# --------------------------------------------------------------------------- #

def save_checkpoint(path: str, params: Dict, step: int = 0) -> None:
    """Save a parameter tree under ``path/<step>/`` with ``torch.save`` (its
    tensors as they are, their devices recorded)."""
    target = os.path.join(os.path.abspath(path), str(step))
    os.makedirs(target, exist_ok=True)
    torch.save(params, os.path.join(target, "params.pt"))


def _restore_like(tree, like):
    """``tree`` rebuilt in ``like``'s containers (tuples stay tuples)."""
    if isinstance(like, dict):
        return {k: _restore_like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_restore_like(t, v) for t, v in zip(tree, like, strict=True))
    return tree


def load_checkpoint(path: str, step: int = 0, like: Optional[Dict] = None,
                    map_location=None) -> Dict:
    """Restore a parameter tree saved by :func:`save_checkpoint`
    (``torch.load(weights_only=True)``), onto ``map_location`` where given.
    ``like`` (a tree of the same structure, e.g. ``spec.init_params()``)
    restores its container types and key order."""
    target = os.path.join(os.path.abspath(path), str(step), "params.pt")
    tree = torch.load(target, weights_only=True, map_location=map_location)
    return tree if like is None else _restore_like(tree, like)


class MetricsLogger:
    """Minimal structured metrics logger: one JSON object a line, the bytes
    the JAX package's logger writes."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            rec[k] = float(v)
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


def profile_trace(log_dir: str):
    """A ``torch.profiler`` context (the CPU, and the card where there is
    one) that writes a Chrome trace into ``log_dir`` on exit. While it
    records, the port's ``vggp.*`` spans (``tracing``) appear in the trace
    beside the operators they enclose: each step, request and layer."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
