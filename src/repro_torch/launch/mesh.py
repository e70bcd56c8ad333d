"""Device meshes over the default process group, the port of
``repro.launch.mesh``.

The reference's production meshes are TPU v5e pods. The port's are H100
clusters of the same device counts, so per-device records compare at the
same global batches: ``pod1`` is (data 32, model 8), 256 GPUs, and
``pod2`` is (pod 2, data 32, model 8), 512 GPUs. The ``model`` axis is one
8-GPU NVLink node, where tensor parallelism belongs; the data axes cross
nodes. Each function builds a ``DeviceMesh`` over ranks 0..n-1 of the
default process group, which the caller has initialised: NCCL on the
cards, gloo on the CPU, or the dry run's fake group of 256 or 512 ranks
(``launch/dryrun.py``). The mesh's device type follows the group's
backend. Nothing here touches a process group when the module is
imported.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

POD1 = ((32, 8), ("data", "model"))
POD2 = ((2, 32, 8), ("pod", "data", "model"))


def _device_type() -> str:
    """"cuda" under NCCL, else "cpu" (gloo, and the fake group, whose
    tensors live on the meta device)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple) -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world}; trace it under "
            "the dry run's fake process group (python -m "
            "repro_torch.launch.dryrun)")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def init_smoke_world(device: str) -> None:
    """A default process group of one rank for ``make_smoke_mesh``: NCCL
    for ``device="cuda"``, gloo for the CPU, over a ``FileStore`` in a new
    temporary directory (no network)."""
    import tempfile
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """``pod1`` (32, 8) over (data, model), or with ``multi_pod`` ``pod2``
    (2, 32, 8) over (pod, data, model)."""
    return _mesh(*(POD2 if multi_pod else POD1))


def make_smoke_mesh(shape=(1, 1), axes=("data", "model")) -> DeviceMesh:
    """A small mesh for one card or CPU tests (the sharding rules still
    run)."""
    return _mesh(tuple(shape), tuple(axes))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes used for batch parallelism on this mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh: DeviceMesh) -> str:
    return "model"
