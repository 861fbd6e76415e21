"""The port's collapsed model zoo over every feature family against the JAX
package.

The zoos of ``vggp_tpu/experiments/zoo.py`` (the nb1 zoo at Matérn-3/2 and
5/2, whose ASVGP members are the B2 and B3 splines, and the nb3 Kronecker
zoo with fewer features per axis) go through ``non_informative_init``,
``sgpr`` and ``train.fit``. Both packages get the same numpy inputs in
float64 on the CPU (JAX in x64, its Pallas kernels in interpret mode).
Fit trajectories are held at rtol 1e-6 (as ``tests/test_torch_sgpr.py``
holds them), heads at rtol 1e-9 with atol 1e-9·max|ref|.
``tests/test_torch_mean.py`` holds the learned mean of the collapsed and
exact GPs on the same zoo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.experiments import zoo
from vggp_tpu.models import sgpr as jsgpr

from vggp_tpu_torch import features, train
from vggp_tpu_torch.models import sgpr

from test_torch_full import RTOL_FIT, _close, _gauss_close, _port_feature, _to_torch, _torch_flat


# --------------------------------------------------------------------------- #
# the collapsed zoo and the learned mean of the collapsed and exact GPs
# --------------------------------------------------------------------------- #

_ZOOS = {
    "1d": lambda: zoo.sgpr_specs_1d(),
    "1d-matern32": lambda: zoo.sgpr_specs_1d_orders("matern32"),
    "1d-matern52": lambda: zoo.sgpr_specs_1d_orders("matern52"),
    "2d": lambda: zoo.sgpr_specs_2d(n_inducing=5, n_frequencies=4, n_knots=6, n_cells=5),
}
# the nb3 zoo whole (Matérn-1/2: points, VFF, B1, cells), and the members of
# the other orders that differ from it (VFF's rank-2 and rank-3 Kuu, B2, B3)
_ZOO_CASES = ([("2d", m) for m in ("svgp", "vffgp", "asvgp", "griddedgp")]
              + [(z, m) for z in ("1d-matern32", "1d-matern52") for m in ("vffgp", "asvgp")])


def _zoo_specs(z, model, learn_mean=False):
    js = _ZOOS[z]()[model]
    js = jsgpr.SGPRSpec(kinds=js.kinds, features=js.features, learn_mean=learn_mean)
    return js, sgpr.SGPRSpec(kinds=js.kinds, features=tuple(_port_feature(f)
                                                            for f in js.features),
                             learn_mean=learn_mean)


def _zoo_data(z, seed, n=80):
    rng = np.random.default_rng(seed)
    if z.startswith("1d"):
        x = rng.random(n)
        return x, np.sin(6 * x) + 0.05 * rng.standard_normal(n)
    x = rng.random((n, 2))
    return x, np.sin(5 * x[:, 0]) * np.cos(4 * x[:, 1]) + 0.05 * rng.standard_normal(n)


@pytest.mark.parametrize("z,model", _ZOO_CASES)
def test_zoo_fit_matches_jax(z, model):
    """Each family of the zoo (points, VFF, ASVGP splines, cells) through
    ``non_informative_init`` and 4 full-batch Adam steps of ``train.fit``
    (torch.optim.Adam against optax.adam): every history entry and the
    final parameters (z of the point features included) at rtol 1e-6, then
    q_v on a grid of cells inside the domain, rtol 1e-9 of itself on JAX's
    final parameters."""
    jspec, tspec = _zoo_specs(z, model)
    x, y = _zoo_data(z, 1)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    jfinal, jhist = jtrain.fit(lambda p: jsgpr.loss(jspec, p, jx, jy), jp0, 4, 0.05)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    tfinal, thist = train.fit(lambda p: sgpr.loss(tspec, p, tx, ty), tp0, 4, 0.05)
    assert sorted(thist) == sorted(jhist)
    for k in jhist:
        _close(thist[k], jhist[k], RTOL_FIT)
    for g, w in zip(_torch_flat(tfinal), jax.tree.leaves(jfinal), strict=True):
        _close(g, w, RTOL_FIT)
    lims = ((4, 0.1, 0.9),) * jspec.ndim
    jgrid = tuple(jfeatures.CellIntegralFeature.from_lims(*g) for g in lims)
    tgrid = tuple(features.CellIntegralFeature.from_lims(*g) for g in lims)
    want = jsgpr.q_v(jspec, jfinal, jx, jy, jgrid)
    with torch.no_grad():
        got = sgpr.q_v(tspec, _to_torch(jax.tree.map(np.asarray, jfinal)), tx, ty, tgrid)
    _gauss_close(got, want)
