"""Elastic scaling: the mesh a run continues on after its host count
changes, and the sharded state restored onto it.

Counterpart of ``repro/distributed/elastic.py``.  :func:`best_mesh` is its
``best_mesh`` for the data axis, the mesh ``engine.run_resilient``
remeshes to after an elastic resize: the shard count, and with it the
all-to-all's key ranges, stays fixed; only the hosts that run the shards
change.  :func:`best_grid` is its ``(data, model)`` grid rule for a
training mesh over the live ranks, and :func:`elastic_restore` restores
the newest valid checkpoint resharded onto such a mesh: the sharding
rules are mesh-relative, so the new layout follows from the new mesh.
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


def best_grid(n: int, *, model_parallel: int | None = None
              ) -> tuple[int, int]:
    """``(data, model)`` of the largest grid over ``n`` ranks: the model
    axis the largest power of two up to 16 that divides ``n`` (or
    ``model_parallel``), the data axis the rest."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    if model_parallel is None:
        model_parallel = 1
        while model_parallel * 2 <= min(n, 16) and n % (model_parallel * 2) == 0:
            model_parallel *= 2
    return n // model_parallel, model_parallel


def elastic_restore(ckpt_dir: str, example_tree, mesh, *, fsdp: bool = True,
                    retry=None):
    """Restore the newest VALID checkpoint resharded onto ``mesh`` (a
    ``DeviceMesh`` with the reference's axis names; corrupt snapshots are
    quarantined and skipped by ``ckpt.restore``).  Returns (tree, step),
    the leaves DTensors in ``sharding.param_shardings(example_tree, mesh,
    fsdp=fsdp)``.

    ``retry``: optional ``coordination.RetryPolicy``: a flaky store read is
    retried on its bounded deterministic backoff schedule instead of
    failing the whole elastic restart."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import sharding as shd

    shardings = shd.param_shardings(example_tree, mesh, fsdp=fsdp)

    def _load():
        return ckpt.restore(ckpt_dir, example_tree, shardings=shardings)

    if retry is None:
        return _load()
    return retry.call(_load, op=f"elastic restore from {ckpt_dir}")
