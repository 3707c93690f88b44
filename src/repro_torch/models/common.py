"""Model configuration shared by the architectures.

Counterpart of ``repro/models/common.py``: :class:`ModelConfig` keeps the
reference's fields, defaults and derived sizes, with ``dtype`` a
``torch.dtype`` (the reference's ``jnp.bfloat16`` is ``torch.bfloat16``).
The sharding helpers (``pick``, ``dp_axes``, ``param_spec``) keep the
reference's logic over :class:`P`, the port's ``PartitionSpec``, and read a
mesh through :func:`mesh_shape`: a ``torch.distributed`` ``DeviceMesh`` or
any object whose ``.shape`` maps axis names to sizes, so that the rules run
with no device and no process group.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    qkv_bias: bool = False
    # gemma2-style options
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    sliding_window: int | None = None
    local_global_alternate: bool = False
    post_norms: bool = False  # gemma2 post-attn/post-ffn norms
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (zamba2): a shared attention block every k layers
    hybrid_attn_every: int = 6
    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_len: int = 448  # whisper max target positions
    # modality frontends are stubs: input_specs provides embeddings
    frontend: str | None = None  # None | "audio" | "vision"
    num_patches: int = 256  # vlm prefix length
    # numerics
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    act: str = "silu"
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the 500k-context decode shape."""
        return self.family in ("ssm", "hybrid")

    # --- SSM derived dims ---
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (the reference's
        sizes, f32)."""
        base = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=128,
            head_dim=16,
            sliding_window=self.sliding_window and 32,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            hybrid_attn_every=2,
            enc_layers=2 if self.enc_layers else 0,
            dec_len=16,
            num_patches=4,
            dtype=torch.float32,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def _canonical(entry):
    """A spec entry as JAX's ``PartitionSpec`` stores it: a tuple of no
    name is ``None``, a tuple of one name is the name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class P:
    """A partition spec: one entry a tensor dimension, each ``None``
    (replicated), an axis name, or a tuple of axis names (major to minor).
    Entries are stored as JAX's ``PartitionSpec`` stores them
    (:func:`_canonical`).  Not a tuple, so that tree walkers take it for a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_canonical(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}" if len(self.entries) != 1 else (
            f"P({self.entries[0]!r})")

    def axes(self) -> tuple:
        """Every axis name the spec uses, in order."""
        out = []
        for e in self.entries:
            out += [e] if isinstance(e, str) else list(e or ())
        return tuple(out)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dimension names) or
    of any object whose ``.shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _fits(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return dim % n == 0


def pick(mesh, dim: int, *candidates):
    """First sharding candidate (axis name / tuple / None) dividing dim."""
    for c in candidates:
        if _fits(dim, mesh, c):
            return c
    return None


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def param_spec(mesh, shape: tuple, kinds: tuple) -> P:
    """Build a partition spec for a parameter.

    ``kinds[i]`` in {"model", "fsdp", "expert", None}: preferred role of
    dim i.  "model": tensor-parallel; "fsdp": ZeRO-3 over the data axes;
    "expert": expert-parallel over 'model'.  Falls back to replication when
    the dim is not divisible.
    """
    dp = dp_axes(mesh)
    spec = []
    used_model = False
    for dim, kind in zip(shape, kinds):
        if kind in ("model", "expert") and not used_model:
            c = pick(mesh, dim, "model")
            spec.append(c)
            used_model = c is not None
        elif kind == "fsdp":
            spec.append(pick(mesh, dim, dp, dp[-1] if dp else None))
        else:
            spec.append(None)
    return P(*spec)
