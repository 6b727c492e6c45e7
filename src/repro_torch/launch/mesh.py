"""Named meshes over the ranks of a process group.

The port of the JAX package's ``repro.launch.mesh``. A :class:`MeshSpec`
is what the sharding rules read (axis names and sizes, as a JAX ``Mesh``
or ``AbstractMesh`` gives them); :meth:`MeshSpec.device_mesh` builds the
``torch.distributed`` ``DeviceMesh`` over the current process group.
Building a mesh never initialises a process group: the caller does that
(``torch.distributed.init_process_group``, or ``torchrun``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes and names of a device mesh, major axis first."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in mesh order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of this spec over the initialised process
        group, whose world size must equal :attr:`size`."""
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, tuple(self.axis_sizes),
                                mesh_dim_names=tuple(self.axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The H100 counterpart of the 16 x 16 TPU pod: (32, 8) data x model for
    256 GPUs, (2, 32, 8) pod x data x model for 512. The model axis is one
    8-GPU NVLink node, so tensor-parallel collectives stay on NVLink and the
    data axes cross InfiniBand."""
    if multi_pod:
        return MeshSpec((2, 32, 8), ("pod", "data", "model"))
    return MeshSpec((32, 8), ("data", "model"))


def world_size() -> int:
    """Ranks of the initialised process group (1 where there is none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_host_mesh(model: int = 1) -> MeshSpec:
    """(world / model, model) data x model over the ranks that exist."""
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{n} ranks of the process group")
    return MeshSpec((n // model, model), ("data", "model"))
