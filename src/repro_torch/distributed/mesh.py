"""The shard mesh of a distributed run: one interface, two meshes.

The reference ``shard_map``s a flow over a data axis of a device mesh.
PyTorch has no ``shard_map``, and the card's machine has one H100 (NCCL
refuses two ranks on one GPU), so the port runs a flow's shard bodies
through a small mesh layer of its own:

* :class:`LocalMesh` runs the S shards of a flow in turn, in one
  process, on one device.  Its collectives take the list of the S
  shards' tensors and work on it in shard order 0…S−1.  It is the
  counterpart of the reference's fake-device meshes
  (``--xla_force_host_platform_device_count``): it exercises the shard
  bodies and the kernels they launch, and no interconnect.
* :class:`ProcessGroupMesh` wraps ``torch.distributed``: one shard per
  rank, gloo for CPU processes, NCCL where each rank has its own card.

A shard body cannot block inside a collective while the other shards of
a :class:`LocalMesh` run, so the engine writes each flow as stages
separated by collectives.  Both meshes run the same stages: a stage maps
over :meth:`Mesh.shards` (all S shards on a ``LocalMesh``, the rank's one
on a ``ProcessGroupMesh``), and every collective takes and returns one
tensor per shard of that list.

Collectives (each the counterpart of the ``lax`` one named):

* ``psum`` / ``pmax`` / ``pmin`` (``lax.psum``, ...): the engine uses them
  for exact reductions only (integers, counts); float merges gather and
  reduce in shard order on the host side (``engine.merge_tables_collective``);
* ``all_gather`` (``lax.all_gather``): ``[S, ...]`` of every shard's tensor;
* ``all_to_all`` (``lax.all_to_all(..., tiled=True)`` over a leading
  destination axis): shard ``d`` receives row ``d`` of every source, in
  source order;
* ``psum_scatter`` (``lax.psum_scatter(..., tiled=True)``): shard ``s``
  gets block ``s`` of the sum along the leading axis;
* ``axis_index`` (``lax.axis_index``): the shard indices of the list.

While ``roofline.op_trace`` traces a call, each collective records itself
as one op ``mesh::<name>`` over the mesh's size, as the reference's HLO
names its all-reduce, all-gather, all-to-all and reduce-scatter; the
copies or process-group calls inside it are hidden.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.roofline import op_trace


def _traced(method):
    """A collective that records itself in an active trace: one op a
    call, standing for every shard of ``xs``."""

    @functools.wraps(method)
    def run(self, xs):
        return op_trace.collective(method.__name__, self.size, len(xs),
                                   method, self, xs)

    return run


def _check_leading(xs, size: int, what: str) -> None:
    for x in xs:
        if x.shape[0] % size:
            raise ValueError(f"{what}: leading axis {x.shape[0]} is no "
                             f"multiple of the mesh size {size}")


class Mesh:
    """The interface both meshes implement (see the module docstring)."""

    kind: str = ""
    size: int = 1
    axis_name: str = "data"
    backend: str = ""
    device: torch.device

    def shards(self) -> list[int]:
        """The shard indices this process runs, in order."""
        raise NotImplementedError

    def axis_index(self) -> list[int]:
        return self.shards()

    def signature(self) -> str:
        """What a compiled entry is keyed on: kind, size, axis, backend."""
        return (f"{self.kind}(size={self.size}, axis={self.axis_name}, "
                f"backend={self.backend}, device={self.device.type})")

    def __repr__(self) -> str:
        return self.signature()


class LocalMesh(Mesh):
    """S shards run in turn in one process on one ``device`` (``None``: the
    card).  Collectives combine the list of the S shards' tensors in shard
    order.  This mesh exercises the shard bodies and the kernels they
    launch, not an interconnect: its all-to-all is a copy within one
    device's memory."""

    kind = "local"

    def __init__(self, num_shards: int, device=None, *,
                 axis_name: str = "data"):
        if int(num_shards) < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.size = int(num_shards)
        self.axis_name = axis_name
        self.device = resolve_device(device)
        self.backend = self.device.type

    def shards(self) -> list[int]:
        return list(range(self.size))

    def _full(self, xs) -> list[torch.Tensor]:
        if len(xs) != self.size:
            raise ValueError(f"a LocalMesh collective takes {self.size} "
                             f"tensors, one a shard; got {len(xs)}")
        return list(xs)

    @_traced
    def psum(self, xs):
        xs = self._full(xs)
        total = xs[0].clone()
        for x in xs[1:]:
            total = total + x
        return [total] * self.size

    @_traced
    def pmax(self, xs):
        xs = self._full(xs)
        return [torch.stack(xs).amax(dim=0)] * self.size

    @_traced
    def pmin(self, xs):
        xs = self._full(xs)
        return [torch.stack(xs).amin(dim=0)] * self.size

    @_traced
    def all_gather(self, xs):
        return [torch.stack(self._full(xs))] * self.size

    @_traced
    def all_to_all(self, xs):
        xs = self._full(xs)
        _check_leading(xs, self.size, "all_to_all")
        parts = [x.chunk(self.size, dim=0) for x in xs]
        return [torch.cat([parts[src][dst] for src in range(self.size)])
                for dst in range(self.size)]

    @_traced
    def psum_scatter(self, xs):
        xs = self._full(xs)
        _check_leading(xs, self.size, "psum_scatter")
        total = self.psum(xs)[0]
        return [b.clone() for b in total.chunk(self.size, dim=0)]


class ProcessGroupMesh(Mesh):
    """One shard per rank of a ``torch.distributed`` process group
    (``group=None``: the default group, which the caller initializes with
    its address, world size and rank).  gloo runs on the CPU; NCCL on the
    rank's card (``device=None`` picks ``cuda`` for NCCL, ``cpu``
    otherwise).  Collective lists hold the rank's one tensor."""

    kind = "process_group"

    def __init__(self, group=None, *, device=None, axis_name: str = "data"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupMesh needs torch.distributed.init_process_group "
                "to have run (pass its address, world size and rank)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.axis_name = axis_name
        self.backend = str(dist.get_backend(group))
        if device is None:
            device = "cuda" if self.backend == "nccl" else "cpu"
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    def shards(self) -> list[int]:
        return [self.rank]

    def _one(self, xs) -> torch.Tensor:
        if len(xs) != 1:
            raise ValueError(f"a ProcessGroupMesh collective takes the "
                             f"rank's one tensor; got {len(xs)}")
        return xs[0].contiguous()

    def _all_reduce(self, xs, op):
        import torch.distributed as dist

        out = self._one(xs).clone()
        dist.all_reduce(out, op=op, group=self.group)
        return [out]

    @_traced
    def psum(self, xs):
        import torch.distributed as dist

        return self._all_reduce(xs, dist.ReduceOp.SUM)

    @_traced
    def pmax(self, xs):
        import torch.distributed as dist

        return self._all_reduce(xs, dist.ReduceOp.MAX)

    @_traced
    def pmin(self, xs):
        import torch.distributed as dist

        return self._all_reduce(xs, dist.ReduceOp.MIN)

    @_traced
    def all_gather(self, xs):
        import torch.distributed as dist

        x = self._one(xs)
        rows = x.reshape((1,) + tuple(x.shape))
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(out, rows, group=self.group)
        return [out]

    @_traced
    def all_to_all(self, xs):
        import torch.distributed as dist

        x = self._one(xs)
        _check_leading([x], self.size, "all_to_all")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return [out]

    @_traced
    def psum_scatter(self, xs):
        import torch.distributed as dist

        x = self._one(xs)
        _check_leading([x], self.size, "psum_scatter")
        out = torch.empty((x.shape[0] // self.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
        scatter(out, x, group=self.group)
        return [out]
