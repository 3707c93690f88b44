"""The one input generator: a configuration's columns, made on the device
from the run's seed.

A configuration file lists its columns under ``columns``; each names a
dtype, a shape (numbers, or names of the configuration's ``sizes``) and a
distribution with its parameters.  Every column is drawn in one call from
one ``torch.Generator`` on the device, in the order the file lists them, so
the same seed gives the same tensors, and every seed gives tensors of the
same sizes.  Distributions: ``uniform_int`` (``low`` ≤ x < ``high``),
``uniform`` (floats in [``low``, ``high``)).
"""

from __future__ import annotations

import torch

DTYPES = {"uint8": torch.uint8, "int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


def size(value, sizes: dict) -> int:
    """A shape entry or parameter: a number, or the name of one of the
    configuration's ``sizes``."""
    if isinstance(value, str):
        return int(sizes[value])
    return value


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def column(spec: dict, sizes: dict, g: torch.Generator, device):
    shape = tuple(size(d, sizes) for d in spec["shape"])
    dtype = DTYPES[spec["dtype"]]
    dist = spec["dist"]
    if dist == "uniform_int":
        return torch.randint(size(spec["low"], sizes), size(spec["high"], sizes),
                             shape, dtype=dtype, device=device, generator=g)
    if dist == "uniform":
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(float(spec["low"]), float(spec["high"]),
                            generator=g)
    raise ValueError(f"unknown distribution {dist!r}")


def columns(config: dict, seed: int, device, sizes: dict | None = None
            ) -> dict[str, torch.Tensor]:
    """Every column of ``config`` for ``seed`` on ``device``; ``sizes``
    replaces the configuration's own (the tests' small copies)."""
    sizes = dict(config["sizes"], **(sizes or {}))
    g = generator(seed, device)
    return {name: column(spec, sizes, g, device)
            for name, spec in config["columns"].items()}


def items(traffic: dict, cols: dict[str, torch.Tensor]):
    """The job's items: each column the traffic names, its rows grouped
    into items of ``item_shape`` (a view; nothing is copied)."""
    out = []
    for part in traffic["items"]:
        col = cols[part["column"]]
        shape = tuple(part.get("item_shape", ()))
        out.append(col.view((-1,) + shape) if shape else col)
    return out[0] if len(out) == 1 else tuple(out)
