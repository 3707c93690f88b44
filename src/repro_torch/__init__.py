"""repro_torch: the MapReduce framework of ``repro``, ported to PyTorch and
hand-written CUDA kernels for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports none of it
(and no JAX).  Ported so far: combiner derivation from a torch ``reduce``;
the stream, sort, combine and reduce flows on one device and over a
shard mesh (``distributed``: ``LocalMesh``, ``ProcessGroupMesh``, the
shuffle's wire codecs, and the skew planner in ``core/skew.py``), and the
cost model that ranks them for a workload size (``n_pairs_hint``); the dense
transformer's serving path (llama3-8b: prefill and greedy decode, in
``models``, ``serving`` and ``launch.serve``); and a hand-written kernel
for each of the reference's eight Pallas kernels (``kernels``).  See
ROADMAP.md for what is still to come.
"""

from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
