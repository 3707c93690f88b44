"""repro_torch: the MapReduce framework of ``repro``, ported to PyTorch and
hand-written CUDA kernels for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports none of it
(and no JAX).  Ported so far: the main path — combiner derivation from a
torch ``reduce``, the stream flow, and the ``onehot_fold`` /
``chunk_monoid_fold`` kernels.  See ROADMAP.md for what is still to come.
"""

from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
