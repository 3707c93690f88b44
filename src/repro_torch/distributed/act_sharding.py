"""Activation-sharding hints, settable by launchers, no-op otherwise.

Counterpart of ``repro/distributed/act_sharding.py``.  The reference pins
attention intermediates on its mesh so that GSPMD does not re-shard them
by heads and replicate the batch.  The port's models compute on plain
tensors (ROADMAP C.70), so these hooks are identities there; they act only
on a ``DTensor`` with a mesh registered, which they redistribute to the
reference's choice of placements:

* ``batch_major(x)``   — dim 0 over the DP axes.
* ``seq_major(x)``     — a sequence axis over 'model' (for head counts that
  do not divide it), batch over DP.
* ``attn_weights(x)``  — [B, Kv, G, Sq, T] logits/weights: batch over DP,
  KV heads over 'model' when divisible, else the query dim, else the
  cache positions.

The choice itself is ``*_spec(shape)``, a :class:`P` or ``None`` (leave
as is), so that it can be held against the reference's.  With no mesh
registered (the default) each hook costs one ``None`` check.
"""

from __future__ import annotations

_MESH = None


def set_mesh(mesh) -> None:
    """Register ``mesh`` (a ``DeviceMesh``, or any object with a ``.shape``
    mapping for the ``*_spec`` choices alone)."""
    global _MESH
    _MESH = mesh


def clear() -> None:
    set_mesh(None)


def current_mesh():
    return _MESH


def _sizes() -> tuple[dict, tuple, int]:
    from repro_torch.models.common import dp_axes, mesh_shape

    shape = mesh_shape(_MESH)
    dp = dp_axes(_MESH)
    ndp = 1
    for a in dp:
        ndp *= shape[a]
    return shape, dp, ndp


def batch_major_spec(shape):
    """Dim 0 over the DP axes, or ``None``."""
    from repro_torch.models.common import P

    if _MESH is None or not len(shape):
        return None
    _, dp, ndp = _sizes()
    if not dp or shape[0] % ndp:
        return None
    return P(dp, *([None] * (len(shape) - 1)))


def seq_major_spec(shape, axis: int = 1):
    """A sequence axis over 'model' (Megatron sequence parallelism), batch
    over DP where it divides; ``None`` where 'model' does not divide it."""
    from repro_torch.models.common import P

    if _MESH is None:
        return None
    sizes, dp, ndp = _sizes()
    if "model" not in sizes:
        return None
    if len(shape) <= axis or shape[axis] % sizes["model"]:
        return None
    b_ax = dp if (dp and shape[0] % ndp == 0) else None
    spec = [b_ax] + [None] * (len(shape) - 1)
    spec[axis] = "model"
    return P(*spec)


def heads_even(n_heads: int) -> bool:
    if _MESH is None:
        return True
    from repro_torch.models.common import mesh_shape

    sizes = mesh_shape(_MESH)
    return "model" not in sizes or n_heads % sizes["model"] == 0


def attn_weights_spec(shape):
    """[B, Kv, G, Sq, T]: KV heads over 'model', else query positions,
    else cache positions; batch over DP where it divides."""
    from repro_torch.models.common import P

    if _MESH is None:
        return None
    sizes, dp, ndp = _sizes()
    if len(shape) != 5 or "model" not in sizes:
        return batch_major_spec(shape)
    m = sizes["model"]
    b_ax = dp if (dp and shape[0] % ndp == 0) else None
    if shape[1] % m == 0:
        return P(b_ax, "model", None, None, None)
    if shape[3] % m == 0:
        return P(b_ax, None, None, "model", None)
    if shape[4] % m == 0:
        return P(b_ax, None, None, None, "model")
    return P(b_ax, None, None, None, None)


def _pin(x, spec):
    """``x`` redistributed to ``spec`` when it is a DTensor on the
    registered mesh; else ``x``."""
    from torch.distributed.tensor import DTensor

    if spec is None or not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import placements

    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def batch_major(x):
    """Constrain dim 0 to the DP axes, rest unconstrained."""
    if _MESH is None:
        return x
    return _pin(x, batch_major_spec(x.shape))


def seq_major(x, axis: int = 1):
    if _MESH is None:
        return x
    return _pin(x, seq_major_spec(x.shape, axis))


def attn_weights(x):
    if _MESH is None:
        return x
    return _pin(x, attn_weights_spec(x.shape))
