"""Device meshes (port of ``src/repro/launch/mesh.py``) over
``torch.distributed.device_mesh.DeviceMesh``.

Single pod: 16 x 16 = 256 devices, axes ("data", "model"). Multi-pod:
2 x 16 x 16 = 512 devices, axes ("pod", "data", "model"); the "pod" axis
crosses the slow boundary, and FedCET's single aggregated vector is the
only collective that traverses it, once per tau local steps.

The reference lowers its programs on one host with 512 placeholder XLA
devices (``--xla_force_host_platform_device_count``). The counterpart here
is ``fake_world(n)``: a process group of ``n`` ranks on PyTorch's fake
backend, in which this process is rank 0 and every collective returns at
once without moving data. A mesh built inside it holds no device.
Functions, not module-level meshes, so that importing touches no process
group.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the device type of a mesh in a fake world: ``cpu`` on every build. With
#: the local shards fake, the model's own small constants (positions,
#: masks) are real tensors on the mesh's device, so a ``cuda`` mesh would
#: allocate on a card; and on a ``cpu`` mesh DTensor issues an all-to-all
#: as an all-gather and a chunk ("CPU process group does not support
#: alltoall"), which the collective counter reports as it sees it.
FAKE_DEVICE_TYPE = "cpu"


@contextlib.contextmanager
def fake_world(n: int):
    """Start a fake process group of ``n`` ranks (this process is rank 0)
    and destroy it on exit. Refuses to run where a process group is
    already up: a fake world never shares a process with a real one."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process; run the dry run in "
                           "a process of its own")
    # private to PyTorch's tests; used only here
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, axes, device_type=None) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"need a process group of {n} ranks for mesh "
                           f"{shape}; run inside launch/mesh.py:fake_world"
                           f"({n}) or an initialized process group")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    if device_type is None:
        device_type = (FAKE_DEVICE_TYPE if dist.get_backend() == "fake"
                       else "cuda")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type=None) -> DeviceMesh:
    """A small mesh (a fake world of a few ranks in the tests, or a real
    one-rank group on the card)."""
    return _mesh(shape, axes, device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, the reference's ``Mesh.shape``."""
    return {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}


def client_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The mesh axes that enumerate federated clients (model/fsdp excluded)."""
    return tuple(a for a in mesh.mesh_dim_names if a not in ("model", "fsdp"))


def n_clients(mesh: DeviceMesh) -> int:
    out = 1
    for a in client_axes(mesh):
        out *= axis_size(mesh, a)
    return out


def tp_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, "model")
