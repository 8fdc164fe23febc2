"""Device meshes over ``torch.distributed``, a torch counterpart of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the named
dims ``("data", "model")`` over the initialized process group: one rank
per device, each rank a process.  ``data`` shards the FL member axis of the
dispatch path; a ``model`` axis of more than one rank column-shards the
parameter plane (``core.plane.plane_specs``).  Nothing here builds a mesh
at import.

``init_world`` joins (or starts) the process group a mesh lives on, with
an explicit rendezvous (``tcp://localhost:<port>`` or ``file://<path>``):
nothing on a one-host machine tells a process of a cluster.
``make_production_mesh`` builds the compile analysis's (16, 16) or
(2, 16, 16) mesh inside ``fake_world``: one process stands for rank 0 of
a world of 256 or 512 ranks that exist only in a fake process group.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


def data_axes(mesh) -> tuple:
    """The batch-sharding axes: ('pod', 'data') on a multi-pod mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 for an axis the mesh lacks)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def mesh_shape(mesh) -> dict:
    """{axis name: ranks}, as JAX's ``dict(mesh.shape)``."""
    return {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}


def host_mesh_shape(n_data: int = 1, n_model: int = 1) -> dict:
    """The shape ``make_host_mesh(n_data, n_model)`` builds, without
    building it: a one-device run (``launch/train.py``) needs no process
    group to describe its 1×1 mesh."""
    return {"data": int(n_data), "model": int(n_model)}


def default_backend(device_type: str, world: int) -> str:
    """``gloo`` on the CPU; on CUDA ``nccl`` when every rank has a card of
    its own, else ``gloo`` (NCCL refuses two ranks on one card)."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def init_world(rank: int, world: int, init_method: str,
               backend: str = "gloo") -> None:
    """Join the default process group (a no-op when it exists)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device_type: str = "cpu"):
    """A (n_data, n_model) mesh over the initialized process group, whose
    world must hold n_data · n_model ranks (rank r at row r // n_model,
    column r % n_model)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(launch.mesh.init_world)")
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} ranks, the world has {world}")
    ranks = torch.arange(world).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


@contextmanager
def fake_world(size: int, rank: int = 0):
    """A process group of ``size`` ranks in which this process is
    ``rank`` and no other rank exists: PyTorch's fake backend (``"fake"``
    on a ``FakeStore``), whose collectives return at once and move no
    data.  ``torch.distributed._tools.fake_collectives`` is loaded so that
    collectives on fake tensors dispatch.  The group is destroyed on
    exit; a world that already exists is refused."""
    import torch.distributed as dist
    # registers the "fake" backend and its store
    from torch.testing._internal.distributed import fake_pg
    import torch.distributed._tools.fake_collectives  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: (16, 16) ``("data", "model")``, or (2, 16, 16)
    with ``"pod"`` in front, over an initialized world of 256 or 512 ranks
    (``fake_world`` for the compile analysis).  Its device type is
    ``"cpu"``, which the fake backend takes with or without a card, so the
    analysis runs alike on both machines."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh needs a world of {n} "
                           "ranks (launch.mesh.fake_world)")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def parse_sim_mesh_shape(shape) -> tuple:
    """Normalize a sim-mesh shape — int, ``"8"``/``"8x1"``/``"4x2"`` string,
    or tuple — to a validated ``(data, model)`` pair."""
    if isinstance(shape, str):
        shape = tuple(int(s) for s in shape.lower().replace("×", "x")
                      .split("x"))
    elif isinstance(shape, int):
        shape = (shape,)
    if len(shape) > 2:
        raise ValueError(
            f"sim meshes have at most (data, model) axes, got {shape}")
    n_data = int(shape[0])
    n_model = int(shape[1]) if len(shape) > 1 else 1
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh axes must be ≥ 1, got {shape}")
    return n_data, n_model


def make_sim_mesh(shape, device_type: str = "cpu"):
    """Mesh for mesh-sharded FL simulation (``sim_run --mesh-shape``): the
    ``data`` axis shards the cluster member axis of the dispatch blocks,
    and a ``model`` axis of more than one rank column-shards the plane,
    bank and teacher stacks inside them.  ``shape`` is an int (data-axis
    size), an ``"8"`` / ``"8x1"`` / ``"4x2"`` string, or a tuple
    ``(data[, model])``."""
    return make_host_mesh(*parse_sim_mesh_shape(shape),
                          device_type=device_type)
