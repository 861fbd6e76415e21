"""What a collective costs the sharded matrix-free heads at world size 1, on the card.

    python3 tools/torch_collective_probe.py

Starts a world-1 NCCL group from a FileStore (no network, no port) and times,
on the host clock ending in ``synchronize``, one ``dist.all_reduce`` of
float32 tensors of the sizes the sharded heads reduce (a scalar, phase 19e's
batched (16, 64, 64) right-hand sides, 19d's 512² w-tensor) over 2000 calls,
beside an in-place ``add_`` of the same tensor (one launch). Then fits phase
7's model (``chip_smoke.fit_collapsed``) and runs phase 19e's sharded and
unsharded pathwise ``q_v`` in turns (unsharded, sharded, sharded,
unsharded), counting the sharded run's reductions and the CG iterations
(``ops.cg.COUNTS``). Prints the card's name and power limit first. Needs a
CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

CALLS = 2000


def per_call_us(fn, torch) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / CALLS


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("torch_collective_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card)
    from vggp_tpu_torch import iterative, parallel
    from vggp_tpu_torch.ops import _build, cg
    from vggp_tpu_torch.parallel import cg as pcg

    _build.load()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("nccl", store=dist.FileStore(f"{root}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = parallel.make_mesh(("data",), (1,))
            group = mesh.get_group("data")
            for shape in ((1,), (16, 64, 64), (512 * 512,)):
                t = torch.zeros(shape, device=device)
                ar = per_call_us(lambda: dist.all_reduce(t, group=group), torch)
                add = per_call_us(lambda: t.add_(0.0), torch)
                print(f"all_reduce of {tuple(shape)} float32: {ar:.1f} us a call; add_ "
                      f"{add:.1f} us ({card})")

            X, y, _ = chip_smoke.make_data(device)
            spec, params, *_ = chip_smoke.fit_collapsed(X, y)
            n = chip_smoke.MF_DRAWS_N
            Xc, yc = X[:n], y[:n]
            kw = dict(n_samples=chip_smoke.MF_SAMPLES, n_features=chip_smoke.MF_FEATURES,
                      maxiter=chip_smoke.MF_DRAWS_MAXITER)
            seeded = lambda: torch.Generator(device=device).manual_seed(chip_smoke.P19_SEED)
            reductions = [0]
            real = pcg._data_shard

            def counted(*args):
                shard = real(*args)

                def reduce(t):
                    reductions[0] += 1
                    return shard.reduce(t)

                return shard._replace(reduce=reduce)

            pcg._data_shard = counted
            sharded = parallel.make_sharded_pathwise_qv(spec, mesh, spec.features, **kw)
            calls = {"unsharded": lambda: iterative.q_v_pathwise(spec, params, Xc, yc,
                                                                  spec.features, seeded(), **kw),
                     "sharded": lambda: sharded(params, Xc, yc, seeded())}
            for side in ("unsharded", "sharded", "sharded", "unsharded"):
                reductions[0] = 0
                cg.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls[side]()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                print(f"19e pathwise q_v {side}: {ms:.1f} ms, {reductions[0]} reductions, "
                      f"CG {dict(cg.COUNTS)}")
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
