"""Production mesh construction.

``make_production_mesh`` is a FUNCTION: importing this module starts no
process group and initialises no CUDA. Single pod: (data=16, model=16) =
256 devices; multi-pod: (pod=2, data=16, model=16) = 512 devices, the
'pod' axis the slow inter-node dimension (params replicated across pods,
the data-parallel gradient reduction over it).

Every constructor needs the default process group started by its caller,
with a world size equal to the mesh's device count: ``nccl`` on the card,
``gloo`` on the CPU, or the fake group of the dry-run
(``repro_torch.launch.dryrun``), which simulates rank 0 of 256 or 512
without running the others.
"""
from __future__ import annotations

from repro_torch.common.sharding import make_mesh
from repro_torch.common.types import MeshSpec


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh_from_spec(spec: MeshSpec, *, device_type: str = "cuda"):
    return make_mesh(spec.shape, spec.axes, device_type=device_type)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """Small (data, model) mesh over the ranks of the default group —
    tests/examples."""
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)


def mesh_spec_for(mesh) -> MeshSpec:
    return MeshSpec(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def degraded_mesh(lost_pods: int = 1, *, device_type: str = "cuda"):
    """Elastic restart target after losing ``lost_pods`` pods: the same code
    runs on the smaller mesh and checkpoints reshard on restore."""
    assert lost_pods < 2
    return make_production_mesh(multi_pod=False, device_type=device_type)
