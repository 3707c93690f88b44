"""Distribution (ROADMAP A11): the shard mesh (``mesh``), the shuffle's
wire codecs (``wire``) and int8 compression (``compression``).  The
flows' shard bodies are in ``core/engine.py``; the skew planner in
``core/skew.py``."""

from repro_torch.distributed.mesh import LocalMesh, Mesh, ProcessGroupMesh

__all__ = ["LocalMesh", "Mesh", "ProcessGroupMesh"]
