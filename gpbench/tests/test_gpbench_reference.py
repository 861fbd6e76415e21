"""The plain reference against the port on the CPU in float64 at small
sizes: the loss, every gradient leaf and the posterior of the whitened
Kronecker SVGP."""

import copy

import pytest
import torch

from gpbench import data, harness
from gpbench.compare import named_leaves
from gpbench.reference import svgp_kron as ref_svgp
from gpbench.reference.precision import REFERENCE

from conftest import ROOT


def _cfg(name: str, **small) -> dict:
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == name)
    cfg = copy.deepcopy(harness.load_json(ROOT / entry["file"]))
    cfg.update(small)
    return cfg


def _f64(p: dict) -> dict:
    return {k: ([t.double() for t in v] if isinstance(v, list) else v.double())
            for k, v in p.items()}


def _assert_close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k].double(), want[k].double(), rtol=rtol,
                                   atol=rtol * float(want[k].abs().max()), msg=k)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_svgp_kron_loss_and_gradients(seed):
    from gpbench.families import svgp_kron as fam
    from vggp_tpu_torch.models import svgp

    cfg = _cfg("svgp512_m12", cells=[12, 16], num_data=5000)
    dev = torch.device("cpu")
    X, y = data.field(cfg, 600, dev, seed)
    p = _f64(fam.served_params(cfg, dev, seed))
    model = svgp.SVGP(fam._spec(cfg), params=fam._program_params(p))
    raw = model.raw_params()
    loss = svgp.loss(model.spec, model.params(), X.double(), y.double())
    loss.backward()
    got = {k: v.grad for k, v in named_leaves(raw).items()}
    want_loss, want = ref_svgp.loss_and_grad(cfg, ref_svgp.raw_from_constrained(cfg, p),
                                             X, y, REFERENCE, block=256)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-11)
    _assert_close(got, want, 1e-8)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_svgp_kron_posterior(seed):
    from gpbench.families import svgp_kron as fam

    cfg = _cfg("svgp512_m12", cells=[12, 16])
    dev = torch.device("cpu")
    p = _f64(fam.served_params(cfg, dev, seed))
    xs = data.points(700, cfg["domain"], data.generator(dev, seed, "query"), dev).double()
    mean, var = fam.program_serve(cfg, p)(xs)
    rmean, rvar = ref_svgp.posterior(cfg, p, xs, REFERENCE, block=300)
    torch.testing.assert_close(mean, rmean, rtol=1e-9, atol=1e-9 * float(rmean.abs().max()))
    torch.testing.assert_close(var, rvar, rtol=1e-9, atol=1e-9 * float(rvar.abs().max()))


def test_reference_adam_is_torchs():
    """The reference's written-out Adam takes torch.optim.Adam's steps."""
    from gpbench.reference.adam import Adam

    g = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(5, generator=g, dtype=torch.float64), "b": torch.randn(
        (3, 3), generator=g, dtype=torch.float64)}
    leaves = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    opt = torch.optim.Adam(leaves, lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    mine, params = Adam(0.05, (0.9, 0.999), 1e-8), dict(p0)
    for _ in range(4):
        grads = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
                 for k, v in p0.items()}
        for leaf, k in zip(leaves, p0):
            leaf.grad = grads[k].clone()
        opt.step()
        params = mine.step(params, grads, 0.0)
    for leaf, k in zip(leaves, p0):
        torch.testing.assert_close(params[k], leaf.detach(), rtol=1e-13, atol=1e-15)
