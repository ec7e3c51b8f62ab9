"""Meshes of the port: the serving mesh and the training mesh.

Port of ``repro/launch/mesh.py``.  JAX builds one logical mesh over every
visible device of one process; the port is SPMD by process instead, one
rank per device, so a mesh here is a ``torch.distributed`` process group
per mesh axis (:func:`torch.distributed.device_mesh.init_device_mesh`),
and every rank calls the constructor.  The caller starts the world
(``torch.distributed.init_process_group`` with its address, world size
and rank); a one-rank mesh with no world yet starts its own on a free
localhost port.  Constructing a mesh touches no device state beyond the
process group.
"""

from __future__ import annotations

import socket

import torch

SERVE_AXES = ("expert", "model")
TRAIN_AXES = ("pod", "data", "model")


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for ``tcp://127.0.0.1:<port>``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _ensure_world(n: int, device) -> int:
    """The world's size, after starting a one-rank world when none exists
    and ``n == 1``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a mesh of {n} ranks needs torch.distributed."
                "init_process_group(..., world_size=n) on every rank first")
        dist.init_process_group(default_backend(device),
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1)
    return dist.get_world_size()


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a device mesh (or of any object whose
    ``shape`` is already such a mapping, as a JAX mesh's is)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def make_serve_mesh(shape=(1, 1), device="cuda"):
    """Serving mesh: (expert, model).

    The ``expert`` axis shards the engine's expert slots (each rank holds
    a contiguous block of them); the ``model`` axis shards the base model
    along dims where every output element is still computed by exactly
    one rank (vocab-parallel embed and head, batch-sharded KV), so token
    streams stay those of the single-device engine.

    ``shape=(1, 1)`` is a one-rank mesh: the mesh code path without a
    second device.  Every rank of the world calls this; the world size
    must be ``expert * model``.  ``device`` picks the mesh's device type
    (``"cuda"`` or ``"cpu"``); the collectives run on the world's backend
    (NCCL or gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(shape)
    if len(shape) != 2:
        raise ValueError(
            f"serve mesh shape must be (expert, model), got {shape!r}")
    n = shape[0] * shape[1]
    world = _ensure_world(n, device)
    if n != world:
        raise ValueError(
            f"serve mesh {shape} needs {n} devices but {world} are visible "
            "(start one rank per device)")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=SERVE_AXES)


def production_shape(world: int, *, multi_pod: bool = False,
                     shape=None) -> tuple:
    """The training mesh's sizes for ``world`` ranks: ``shape`` when
    given, explicit (pod, data, model) sizes (or (data, model), a mesh
    without pods) whose product is ``world``; else every rank a pod when
    ``multi_pod`` (pure data parallelism across pods, the compressed
    step's axis), else one pod of ``world`` data ranks."""
    if shape is not None:
        shape = tuple(int(n) for n in shape)
        if len(shape) not in (2, 3):
            raise ValueError("a training mesh is (pod, data, model) or "
                             f"(data, model), got {shape!r}")
        n = 1
        for v in shape:
            n *= v
        if n != world:
            raise ValueError(f"training mesh {shape} needs {n} ranks but "
                             f"the world has {world}")
        return shape
    return (world, 1, 1) if multi_pod else (1, world, 1)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         shape=None):
    """Training mesh over the world: ("pod", "data", "model") sized by
    :func:`production_shape`, or ("data", "model") for a 2-d ``shape``
    (the reference's single-pod axes, which its decode layouts use).  The
    reference's TPU pod sizes do not carry over: the world's size
    decides, or ``shape`` names the sizes (the dry run's H100 meshes are
    (32, 8) and (2, 32, 8): "model" inside one 8-card NVLink host)."""
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist
    world = (dist.get_world_size() if dist.is_initialized()
             else _ensure_world(1, device))
    sizes = production_shape(world, multi_pod=multi_pod, shape=shape)
    names = TRAIN_AXES if len(sizes) == 3 else TRAIN_AXES[1:]
    return init_device_mesh(torch.device(device).type, sizes,
                            mesh_dim_names=names)
