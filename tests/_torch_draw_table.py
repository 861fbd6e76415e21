"""One table of random draws for a JAX experiment run and the port's run of
the same experiment (imported by the ``test_torch_experiments_*`` files).

The JAX samplers split each key into one key a sample and each of those
into (path, z); ``prior_paths`` splits the path key into one key an axis
(``sample_frequencies``) and one for the phases. :class:`DrawTable` makes
those draws once from a numpy seed for every sampler call of a run: the
JAX side looks each one up by the key it is drawn with (inside ``vmap`` and
``jit``), the port's side takes them in call order (its samplers draw
sample by sample: each sample's frequencies, phases, then z). The
frequencies are Student-t(2) draws × 4, the phases U[0, 2π), z standard
normal; the real ``prior_paths`` of both packages stack them and compute the
amplitude.

Also: Poisson counts by inverse CDF from one table of uniforms (JAX's
``jax.random.poisson`` and the port's ``torch.poisson``), and the Laplace
draws of ``hyperpost.sample_params`` ((S, p) standard normals).

Keys are given by their ``PRNGKey`` seed. A table records the calls that
built it (``recipe``), so another process can build the same table
(:meth:`DrawTable.from_recipe`) for a JAX run of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from vggp_tpu import sampling as jsampling

from vggp_tpu_torch import sampling


class DrawTable:
    def __init__(self, seed: int = 13):
        self.rng = np.random.default_rng(seed)
        self.keys = {"freq": [], "phase": [], "z": [], "normal": []}
        self.vals = {"freq": [], "phase": [], "z": [], "normal": []}
        self.port = {"freq": [], "phase": [], "z": [], "normal": []}
        self.z_shapes = set()
        self.normal_shapes = set()
        self.n_features = None
        self.uniforms = {}
        self.recipe = []

    @classmethod
    def from_recipe(cls, recipe, seed: int = 13):
        table = cls(seed)
        for method, args in recipe:
            getattr(table, method)(*args)
        return table

    def _add(self, kind, key, val):
        self.keys[kind].append(np.asarray(key))
        self.vals[kind].append(val)
        self.port[kind].append(val)

    def sampler(self, key_seed: int, n_samples: int, ndim: int, n_features: int, z_shape):
        """The draws of one sampler call (``pathwise_posterior``,
        ``pathwise_q_v``, the collapsed gradient draws) of ``n_samples`` at
        ``PRNGKey(key_seed)``: per sample, ``ndim`` frequency rows, the
        phases, z."""
        self.recipe.append(("sampler", (key_seed, n_samples, ndim, n_features, tuple(z_shape))))
        key = jax.random.PRNGKey(key_seed)
        assert self.n_features in (None, n_features)
        self.n_features = n_features
        self.z_shapes.add(tuple(z_shape))
        for ks in jax.random.split(key, n_samples):
            kp, kw = jax.random.split(ks)
            sub = jax.random.split(kp, ndim + 1)
            for i in range(ndim):
                self._add("freq", sub[i], self.rng.standard_t(2.0, size=n_features) * 4.0)
            self._add("phase", sub[ndim], self.rng.random(n_features) * 2 * np.pi)
            self._add("z", kw, self.rng.standard_normal(z_shape))
        return self

    def laplace(self, key_seed: int, n_samples: int, n_params: int, calls: int = 1):
        """``hyperpost.sample_params``' (S, p) standard normals at
        ``PRNGKey(key_seed)``, drawn ``calls`` times with that key (the
        port's side in turn)."""
        self.recipe.append(("laplace", (key_seed, n_samples, n_params, calls)))
        key = jax.random.PRNGKey(key_seed)
        self.normal_shapes.add((n_samples, n_params))
        self._add("normal", key, self.rng.standard_normal((n_samples, n_params)))
        self.port["normal"] += self.port["normal"][-1:] * (calls - 1)
        return self

    def poisson(self, key_seed: int, n: int):
        """The uniforms of one ``sample_observations("poisson", ...)`` of n
        counts at ``PRNGKey(key_seed)``."""
        self.recipe.append(("poisson", (key_seed, n)))
        key = jax.random.PRNGKey(key_seed)
        self.uniforms[tuple(np.asarray(key).tolist())] = self.rng.random(n)
        return self

    def _jrow(self, kind, k):
        keys = jnp.asarray(np.stack(self.keys[kind]))
        j = jnp.argmax(jnp.all(k == keys, axis=-1))
        return jnp.asarray(np.stack(self.vals[kind]))[j]

    def patch(self, mp: pytest.MonkeyPatch):
        """Patch both packages' draws to the table (``mp`` a MonkeyPatch)."""
        real_normal, real_uniform = jax.random.normal, jax.random.uniform
        F = self.n_features

        def jnormal(k, shape=(), dtype=float):
            shape = tuple(shape)
            if shape in self.z_shapes:
                return self._jrow("z", k).astype(dtype)
            if shape in self.normal_shapes:
                return self._jrow("normal", k).astype(dtype)
            return real_normal(k, shape, dtype)

        def juniform(k, shape=(), dtype=float, minval=0.0, maxval=1.0):
            if F is not None and tuple(shape) == (F,):
                return self._jrow("phase", k).astype(dtype)
            return real_uniform(k, shape, dtype, minval, maxval)

        def jpoisson(k, lam, shape=None, dtype=int):
            u = self.uniforms[tuple(np.asarray(k).tolist())]
            return jnp.asarray(stats.poisson.ppf(u.reshape(np.shape(lam)), np.asarray(lam)))

        mp.setattr(jax.random, "normal", jnormal)
        mp.setattr(jax.random, "uniform", juniform)
        mp.setattr(jax.random, "poisson", jpoisson)
        mp.setattr(jsampling, "sample_frequencies",
                   lambda k, kind, ell, n: self._jrow("freq", k).astype(ell.dtype))

        rows = {kind: iter(vals) for kind, vals in self.port.items()}
        t = lambda v, like: torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)
        real_tnormal = sampling.normal

        def tnormal(gen, shape, like):
            shape = tuple(shape)
            if shape in self.z_shapes:
                return t(next(rows["z"]), like)
            if shape in self.normal_shapes:
                return t(next(rows["normal"]), like)
            return real_tnormal(gen, shape, like)

        poisson_u = iter(list(self.uniforms.values()))

        def tpoisson(lam, generator=None):
            u = next(poisson_u).reshape(tuple(lam.shape))
            return torch.as_tensor(stats.poisson.ppf(u, lam.numpy()), dtype=lam.dtype)

        mp.setattr(sampling, "normal", tnormal)
        mp.setattr(sampling, "sample_frequencies",
                   lambda gen, kind, ell, n: t(next(rows["freq"]), ell))
        mp.setattr(sampling, "_phases", lambda gen, n, like: t(next(rows["phase"]), like))
        mp.setattr(torch, "poisson", tpoisson)
        return rows
