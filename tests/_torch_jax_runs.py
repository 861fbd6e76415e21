"""Run a JAX package experiment in a process of its own (imported by the
``test_torch_experiments_*`` files): ``run(name, kwargs)`` in a fresh
interpreter on the CPU, float32 as in production (x64 off), so that
several runs' XLA compiles proceed side by side while the port's runs go on
in the test's process. A run given a ``DrawTable`` recipe
(``_torch_draw_table``) draws from that table, built anew in its process."""

import importlib
import multiprocessing


def _run(name: str, kwargs: dict, recipe=None):
    import os

    # XLA's CPU compiles are most of a run's time here; without LLVM's
    # optimisation passes they take a fraction of it (the results differ
    # from the optimised build's by float32 roundoff only)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")
    import jax
    import pytest

    jax.config.update("jax_platforms", "cpu")
    run = importlib.import_module(f"vggp_tpu.experiments.{name}").run
    with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
        if recipe is not None:
            from _torch_draw_table import DrawTable

            DrawTable.from_recipe(recipe).patch(mp)
        return run(**kwargs)


def start(jobs: dict):
    """{name: kwargs or (kwargs, recipe)} → (pool, {name: AsyncResult});
    close the pool with ``pool.terminate()`` when the results are read."""
    pool = multiprocessing.get_context("spawn").Pool(len(jobs))
    args = {name: job if isinstance(job, tuple) else (job, None) for name, job in jobs.items()}
    return pool, {name: pool.apply_async(_run, (name, *a)) for name, a in args.items()}
