"""The three-axis whitened Kronecker SVGP of the port on the CPU.

- ``KronMoments`` at three axes and more takes explicit products against the
  Khatri–Rao of all axes but the widest; its outputs and gradients match the
  plain math (``_moments_math`` and autograd through it).
- At two axes it computes what it computed before, bit for bit: the einsum
  path, written out here as it was.
- ``svgp.loss`` with its gradients, and ``posterior_from_state``, at three
  axes match the benchmark's plain reference ``gpbench.reference.svgp_kron3``
  in float64; one axis takes the banded whitening, two the dense F⁻¹.
- Under the profiler a three-axis loss and backward open the
  ``vggp.model.contract`` span twice and count one ``kron_contract``; two
  axes do neither.
"""

import copy
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpbench.compare import named_leaves
from gpbench.families import svgp_kron as fam
from gpbench.reference import svgp_kron3 as ref
from gpbench.reference.precision import REFERENCE
from vggp_tpu_torch import CellIntegralFeature, SVGPSpec
from vggp_tpu_torch.models import svgp
from vggp_tpu_torch.ops import cell_kuf as ck
from vggp_tpu_torch.ops import kms

ROOT = Path(__file__).resolve().parents[1]


def _moment_inputs(ms, n, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    mu = torch.randn(ms, generator=g, dtype=dtype)
    Ls = [torch.tril(torch.randn((m, m), generator=g, dtype=dtype)) for m in ms]
    blocks = [torch.randn((m, n), generator=g, dtype=dtype) for m in ms]
    cots = [torch.randn((n,), generator=g, dtype=dtype) for _ in range(3)]
    return mu, Ls, blocks, cots


def _grads(fn, mu, Ls, blocks, cots):
    leaves = [t.clone().requires_grad_(True) for t in (mu, *Ls, *blocks)]
    d = len(Ls)
    outs = fn(leaves[0], leaves[1:1 + d], leaves[1 + d:])
    grads = torch.autograd.grad(outs, leaves, grad_outputs=cots)
    return [o.detach() for o in outs], list(grads)


def _kron_moments(mu, Ls, blocks):
    return svgp.KronMoments.apply(mu, *Ls, *blocks)


def _plain(mu, Ls, blocks):
    return svgp._moments_math(mu, Ls, blocks)[:3]


# (7, 5, 3) and (16, 4, 6) keep the widest axis first; (4, 9, 6) moves it to
# the middle, (3, 5, 2, 4) has four axes
@pytest.mark.parametrize("ms", [(7, 5, 3), (16, 4, 6), (4, 9, 6), (3, 5, 2, 4)])
def test_explicit_products_match_the_plain_math(ms):
    args = _moment_inputs(ms, 33, seed=sum(ms))
    got_out, got_grads = _grads(_kron_moments, *args)
    want_out, want_grads = _grads(_plain, *args)
    # both sides are exact float64 arithmetic in another order: rounding only
    for got, want in zip(got_out + got_grads, want_out + want_grads):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


def _parent_two_axis(mu, Ls, blocks, cots):
    """The two-axis KronMoments as the einsum path computed it."""
    a, b = blocks
    gm, gr, gv = cots
    mean = torch.einsum("ab,an,bn->n", mu, a, b)
    ts = [Ls[0].T @ a, Ls[1].T @ b]
    rs = [torch.sum(a * a, dim=0), torch.sum(b * b, dim=0)]
    vs = [torch.sum(t * t, dim=0) for t in ts]
    outs = [mean, rs[0] * rs[1], vs[0] * vs[1]]
    dmu = torch.einsum("n,an,bn->ab", gm, a, b)
    means = [torch.einsum("ab,bn->an", mu, b), torch.einsum("ab,an->bn", mu, a)]
    dLs, das = [], []
    for i in range(2):
        da = means[i] * gm[None, :]
        da = da + 2.0 * blocks[i] * (gr * rs[1 - i])[None, :]
        dt = 2.0 * ts[i] * (gv * vs[1 - i])[None, :]
        da = da + Ls[i] @ dt
        dLs.append(blocks[i] @ dt.T)
        das.append(da)
    return outs, [dmu, *dLs, *das]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_axes_compute_what_they_did_bit_for_bit(dtype):
    mu, Ls, blocks, cots = _moment_inputs((12, 9), 40, seed=5, dtype=dtype)
    got_out, got_grads = _grads(_kron_moments, mu, Ls, blocks, cots)
    want_out, want_grads = _parent_two_axis(mu, Ls, blocks, cots)
    for got, want in zip(got_out + got_grads, want_out + want_grads):
        assert torch.equal(got, want)


def _cfg(cells) -> dict:
    cfg = json.loads((ROOT / "gpbench" / "configs" / "st512x42_m12.json").read_text())
    return dict(copy.deepcopy(cfg), cells=list(cells), num_data=5000)


def _params(cfg: dict, seed: int) -> dict:
    """Constrained float64 parameters: σ², ℓ, noise, μ and L_i from the seed."""
    g = torch.Generator().manual_seed(seed)
    ms = cfg["cells"]

    def uniform(lo, hi):
        return torch.tensor(lo + (hi - lo) * float(torch.rand((), generator=g)),
                            dtype=torch.float64)

    Ls = [torch.tril(0.05 * torch.randn((m, m), generator=g, dtype=torch.float64), -1)
          + torch.diag(0.5 + torch.rand((m,), generator=g, dtype=torch.float64)) for m in ms]
    return {"variance": [uniform(0.5, 1.5) for _ in ms],
            "lengthscale": [uniform(0.1, 0.6) for _ in ms],
            "noise": uniform(0.05, 0.2),
            "mu": torch.randn(ms, generator=g, dtype=torch.float64),
            "L": Ls}


def _points(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=g, dtype=torch.float64)
    y = torch.sin(6.0 * x[:, 0]) * torch.cos(5.0 * x[:, 1]) + 0.1 * torch.randn(
        (n,), generator=g, dtype=torch.float64)
    return x, y


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_loss_and_gradients_match_the_reference(monkeypatch, seed):
    cfg = _cfg((256, 8, 6))
    p = _params(cfg, seed)
    x, y = _points(300, seed)
    banded = []
    orig = kms.banded_apply
    monkeypatch.setattr(kms, "banded_apply",
                        lambda finv, kuf: banded.append(finv.shape[0]) or orig(finv, kuf))
    model = svgp.SVGP(fam._spec(cfg), params=fam._program_params(p))
    raw = model.raw_params()
    loss = svgp.loss(model.spec, model.params(), x, y)
    loss.backward()
    # the 256-cell axis takes the banded whitening, the 8- and 6-cell ones the dense F⁻¹
    assert banded == [256]
    got = {k: v.grad for k, v in named_leaves(raw).items()}
    want_loss, want = ref.loss_and_grad(cfg, ref.raw_from_constrained(cfg, p), x, y,
                                        REFERENCE, block=128)
    # float64 on both sides; the loss sums 300 points scaled by N/n, so its
    # rounding stays many orders below 1e-10
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-10)
    assert set(got) == set(want)
    for k in want:
        # the whitening goes through F⁻¹ in closed form against the
        # reference's Cholesky inverse, and the gradients through the
        # hand-written backward: float64 rounding of O(m) sums, far below 1e-8
        torch.testing.assert_close(got[k], want[k], rtol=1e-8,
                                   atol=1e-8 * float(want[k].abs().max()), msg=k)


@pytest.mark.parametrize("seed", [11, 2**31 + 9])
def test_posterior_from_state_matches_the_reference(seed):
    cfg = _cfg((256, 8, 6))
    p = _params(cfg, seed)
    xs, _ = _points(400, seed + 1)
    params = fam._program_params(p)
    spec = fam._spec(cfg)
    with torch.no_grad():
        g = svgp.posterior_from_state(spec, params, svgp.precompute(spec, params), xs)
    rmean, rvar = ref.posterior(cfg, p, xs, REFERENCE, block=150)
    # float64 through dense factors on both sides
    torch.testing.assert_close(g.mean, rmean, rtol=1e-9, atol=1e-9 * float(rmean.abs().max()))
    torch.testing.assert_close(g.var, rvar, rtol=1e-9, atol=1e-9 * float(rvar.abs().max()))


def _profiled_loss(cells):
    feats = tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for m in cells)
    spec = SVGPSpec(kinds=("matern12",) * len(cells), features=feats, num_data=1000,
                    variational="kron")
    model = svgp.SVGP(spec, device=torch.device("cpu"))
    g = torch.Generator().manual_seed(3)
    x = torch.rand((16, len(cells)), generator=g)
    y = torch.sin(6.0 * x[:, 0])
    ck.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x, y).backward()
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                   if e.name() == "vggp.model.contract" or e.name() == "vggp.model.moments"
                   or e.name().endswith("KronMomentsBackward"))
    return spans, {k: v for k, v in ck.SHAPE_LAUNCHES.items() if k[0] == "kron_contract"}


@pytest.mark.parametrize("cells", [(8, 6, 4), (8, 6)])
def test_contract_span_and_counter(cells):
    spans, counts = _profiled_loss(cells)
    contract = [(s, t) for s, t, name in spans if name == "vggp.model.contract"]
    if len(cells) == 2:
        assert not contract and not counts
        return
    assert counts == {("kron_contract", 8 * 6 * 4, 16): 1}
    assert len(contract) == 2

    def inside(iv, name):
        return any(s <= iv[0] and iv[1] <= t for s, t, n in spans if n.endswith(name))

    # the forward's span inside the moments' span, the backward's inside the
    # moments' backward node (which the benchmark's attribution links to it)
    assert inside(contract[0], "vggp.model.moments")
    assert inside(contract[1], "KronMomentsBackward")
