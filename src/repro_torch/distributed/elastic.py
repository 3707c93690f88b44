"""Elastic scaling: the mesh a resilient run continues on after its host
count changes.

Counterpart of ``repro/distributed/elastic.py``'s ``best_mesh`` for the
data axis, the mesh ``engine.run_resilient`` remeshes to after an elastic
resize.  The shard count, and with it the all-to-all's key ranges, stays
fixed: only the hosts that run the shards change.  The reference's
``elastic_restore`` (and ``ckpt.restore(shardings=...)``) reshard FSDP
parameters through ``distributed/sharding.py``, which is not ported
(ROADMAP A14b).
"""

from __future__ import annotations

from repro_torch.distributed.mesh import LocalMesh, Mesh


def best_mesh(mesh: Mesh, num_hosts: int) -> Mesh:
    """The data mesh over ``num_hosts`` hosts that continues ``mesh``: a
    ``LocalMesh(num_hosts)`` on the mesh's device and axis.  A
    ``ProcessGroupMesh`` is taken at world size 1 only (the resilient
    driver runs every shard in its one process, ROADMAP C.48): it is kept
    at one host and becomes a ``LocalMesh`` otherwise."""
    if num_hosts <= 0:
        raise ValueError(f"num_hosts must be positive, got {num_hosts}")
    if mesh.kind != "local":
        if mesh.size != 1:
            raise NotImplementedError(
                f"best_mesh continues a ProcessGroupMesh at world size 1 "
                f"only, got {mesh.size} ranks (ROADMAP C.48)")
        if num_hosts == 1:
            return mesh
    return LocalMesh(num_hosts, mesh.device, axis_name=mesh.axis_name)
