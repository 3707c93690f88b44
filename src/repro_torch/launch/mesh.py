"""Production and test meshes.

Counterpart of ``repro/launch/mesh.py``: functions, not module constants,
so importing touches no process group.  Single pod: 16 × 16 = 256 ranks
``("data", "model")``.  Multi-pod: 2 × 16 × 16 = 512 ranks ``("pod",
"data", "model")``; the 'pod' axis carries only data parallelism.  Each
builds a ``torch.distributed`` ``DeviceMesh`` over the default process
group, whose world size must be the mesh's and whose backend is the
caller's choice: ``"fake"`` for the dry-run, gloo for CPU processes, NCCL
with a card a rank.
"""

from __future__ import annotations

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (``cuda`` devices under NCCL, else ``cpu``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a default process group "
                           f"of {n} ranks")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*PRODUCTION[multi_pod])


def make_test_mesh(n_data: int = 2, n_model: int = 2):
    """Small ``("data", "model")`` mesh for tests with few ranks."""
    return make_mesh((n_data, n_model), ("data", "model"))
