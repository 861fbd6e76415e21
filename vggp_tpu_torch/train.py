"""Parameter transforms, init heuristics and training loops of the port
(``vggp_tpu/train.py``: the transforms, ``non_informative_init``,
``informative_init``, ``fit``, ``fit_minibatch`` and ``make_step_fn``).

Positive hyperparameters (variance, lengthscale, noise) live unconstrained
under a floored softplus; models always see constrained values. The
optimizer is ``torch.optim.Adam`` on the raw leaves.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

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
    a nested dict/tuple/list; leave everything else as it is."""
    if isinstance(tree, dict):
        return {k: (fn(k, v) if k in POSITIVE_KEYS else _map_positive(v, fn))
                for k, v in tree.items()}
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
    if not bool(finite):
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
        optimizer.zero_grad(set_to_none=True)
        val = loss_fn(constrain(raw), *args)
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


def fit_minibatch(
    loss_fn: Callable[[Dict, torch.Tensor, torch.Tensor], torch.Tensor],
    params: Dict,
    X: torch.Tensor,
    y: torch.Tensor,
    n_iters: int,
    batch_size: int,
    learning_rate: float = 0.01,
    seed: int = 0,
) -> Tuple[Dict, Dict]:
    """Stochastic fit with ``torch.optim.Adam``: each step draws a uniform
    minibatch (with replacement) from a ``torch.Generator`` seeded with
    ``seed`` on the data's device. Returns (final constrained params,
    history of per-step losses and ELBOs).
    """
    raw = raw_leaves_from(params)
    opt = torch.optim.Adam(tree_leaves(raw), lr=learning_rate)
    step = make_step_fn(loss_fn, raw, opt)
    y = y.reshape(-1)
    n = y.shape[0]
    gen = torch.Generator(device=X.device)
    gen.manual_seed(seed)
    losses = []
    for _ in range(n_iters):
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=X.device)
        losses.append(step(X[idx], y[idx]))
    losses = torch.stack(losses)
    with torch.no_grad():
        final = constrain(tree_map(lambda v: v.detach(), raw))
    return final, {"loss": losses, "elbo": -losses}
