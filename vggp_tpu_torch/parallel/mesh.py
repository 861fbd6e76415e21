"""Device meshes over ``torch.distributed`` (port of ``vggp_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the default process group: one process a device, ranks laid
out row-major over the axis sizes (rank = ((d·M₁ + m₁)·M₂ + m₂)… for a
("data", "model1", "model2") mesh). The backend follows the device: NCCL for
``cuda``, gloo for ``cpu``. A caller that has not started the default group
gets one from the environment (``env://``, as ``torchrun`` sets it); a
caller that has started it must have started it with the device's backend.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _default_group(device_type: str) -> None:
    """Start the default process group from the environment if no group
    runs; raise if the device is absent or the running group's backend is
    not the device's."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass device_type='cpu' for gloo")
    backend = BACKENDS[device_type]
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if dist.get_backend() != backend:
        raise ValueError(f"a {device_type} mesh needs the {backend} backend; the default "
                         f"process group runs {dist.get_backend()}")


def make_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int],
              device_type: str = "cuda"):
    """A DeviceMesh of shape ``axis_sizes`` with dimensions ``axis_names``
    over every process of the default group. Raises ``ValueError`` when the
    sizes' product is not the world size, and when the running group's
    backend is not the device's."""
    _default_group(device_type)
    total = math.prod(axis_sizes)
    world = dist.get_world_size()
    if total != world:
        raise ValueError(f"mesh wants {total} devices, have {world}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def data_model_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                    device_type: str = "cuda"):
    """("data", "model") mesh over ``n_devices`` processes (the world size
    by default): ``model_parallel`` of them shard the second Kronecker axis
    of the variational state, the rest do data parallelism."""
    _default_group(device_type)
    n = n_devices or dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return make_mesh(("data", "model"), (n // model_parallel, model_parallel), device_type)
