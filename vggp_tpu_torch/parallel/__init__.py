"""Multi-device execution on ``torch.distributed`` (port of ``vggp_tpu/parallel/``).

One process a device; a ``DeviceMesh`` names the axes (:mod:`mesh`):

- data parallelism: each process takes its contiguous block of the
  minibatch, and the loss and gradients are all-reduced over the ``data``
  axis (:mod:`dp`);
- model parallelism: for very large inducing grids μ and each raw_L_i of
  the Kronecker variational state are split over ``model`` axes, gathered
  for the step and sliced back after it (:mod:`dp`);
- the matrix-free path splits the data, and every contraction over n is a
  partial sum plus one all-reduce (:mod:`cg`).

The JAX package places arrays and lets GSPMD insert the collectives; here
each collective is written out. NCCL serves ``cuda`` meshes, gloo ``cpu``
ones.
"""

from vggp_tpu_torch.parallel.mesh import make_mesh, data_model_mesh
from vggp_tpu_torch.parallel.dp import (make_sharded_svgp_step, make_sharded_assimilate,
                                        make_sharded_qv, shard_params, shard_batch)
from vggp_tpu_torch.parallel.cg import (make_sharded_solve_w, make_sharded_qv_mean_cg,
                                        make_sharded_qdv_mean_cg,
                                        make_sharded_pathwise_qv,
                                        make_sharded_pathwise_qdv)

__all__ = [
    "make_mesh",
    "data_model_mesh",
    "make_sharded_svgp_step",
    "make_sharded_assimilate",
    "make_sharded_qv",
    "make_sharded_solve_w",
    "make_sharded_qv_mean_cg",
    "make_sharded_qdv_mean_cg",
    "make_sharded_pathwise_qv",
    "make_sharded_pathwise_qdv",
    "shard_params",
    "shard_batch",
]
