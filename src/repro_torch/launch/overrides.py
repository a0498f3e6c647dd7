"""Per-architecture distribution overrides (port of
``src/repro/launch/overrides.py``).

The production device grid is fixed (16x16 per pod, 2x16x16 multi-pod), but
how the non-model axes are *interpreted* is a per-arch design decision:

* train: memory-heavy archs split the 16-way data axis into
  (clients x fsdp): each client's FedCET state additionally shards over
  `fsdp`, and the per-client batch also splits over `fsdp`.

* serve: llama4-scout also needs weights sharded over BOTH non-batch axes
  (2D tensor parallelism: experts over `model`, d_ff over `data`).

Everything else keeps the plain layout: data=clients, model=TP.
"""

from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import axis_size


@dataclasses.dataclass(frozen=True)
class ArchDistribution:
    fsdp: int = 1            # train: data axis splits into (data/fsdp, fsdp)
    serve_wide: bool = False  # serve: also shard weights over the data axis


OVERRIDES: dict[str, ArchDistribution] = {
    "llama4-scout-17b-a16e": ArchDistribution(fsdp=4, serve_wide=True),
    "llava-next-34b": ArchDistribution(fsdp=2),
}


def distribution_for(arch: str) -> ArchDistribution:
    return OVERRIDES.get(arch, ArchDistribution())


def train_mesh_view(mesh: DeviceMesh, fsdp: int) -> DeviceMesh:
    """Reinterpret the production device grid with an fsdp axis split out of
    the data axis: (pod?, data, model) -> (pod?, data/fsdp, fsdp, model).
    The same ranks in the same order: the mesh tensor is reshaped."""
    if fsdp == 1:
        return mesh
    names = tuple(mesh.mesh_dim_names)
    if "data" not in names or axis_size(mesh, "data") % fsdp:
        raise ValueError(f"train_mesh_view: fsdp {fsdp} must divide the "
                         f"data axis of {names}")
    new_shape, new_names = [], []
    for n in names:
        if n == "data":
            new_shape += [axis_size(mesh, "data") // fsdp, fsdp]
            new_names += ["data", "fsdp"]
        else:
            new_shape.append(axis_size(mesh, n))
            new_names.append(n)
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(new_shape),
                      mesh_dim_names=tuple(new_names))
