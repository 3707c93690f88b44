"""Distribution (ROADMAP A11) and resilience (A12): the shard mesh
(``mesh``), the shuffle's wire codecs (``wire``) and int8 compression
(``compression``); the fault scripts and recovery ledger (``fault``), the
durable control plane (``coordination``), the chaos drills (``chaos``) and
the elastic remesh (``elastic``).  The flows' shard bodies and the
resilient driver are in ``core/engine.py``; the skew planner in
``core/skew.py``."""

from repro_torch.distributed.chaos import ChaosPlan
from repro_torch.distributed.coordination import (CoordinationStore,
                                                  FileKVStore, MemKVStore,
                                                  RetryPolicy)
from repro_torch.distributed.fault import FaultInjection, RecoveryLog
from repro_torch.distributed.mesh import LocalMesh, Mesh, ProcessGroupMesh

__all__ = ["ChaosPlan", "CoordinationStore", "FaultInjection", "FileKVStore",
           "LocalMesh", "MemKVStore", "Mesh", "ProcessGroupMesh",
           "RecoveryLog", "RetryPolicy"]
