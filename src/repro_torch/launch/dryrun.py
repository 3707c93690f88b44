"""Dry-run of every (arch × shape) cell on the production meshes: shapes,
per-chip memory and roofline terms, with no device and no allocation.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 fake XLA devices and reads the compiled
module.  Here the process joins a ``torch.distributed`` group on the
``"fake"`` backend at the mesh's world size, as rank 0, and traces one step
of the cell under ``FakeTensorMode``: parameters, optimizer state, batches
and decode state are DTensors in the reference's layouts
(``distributed.sharding``) whose shards are fake tensors, and the step is
the port's own sharded one (``training.train_step``; for serve cells, the
gather-compute-scatter of :func:`_serve_step`).  Per cell:

* ``n_params`` / ``n_active``; ``memory`` from the shards' shapes:
  ``argument_bytes`` (state, parameters and batch a rank),
  ``output_bytes``, ``alias_bytes`` (the state, updated in place) and
  ``temp_bytes``, the peak of ``MemTracker`` over the traced step;
  ``peak_per_chip_gib`` and whether it ``fits`` a card's 80 GB;
* ``roofline`` (``roofline.analysis.analyze``): FLOPs, bytes and wire
  bytes a chip from ``roofline.op_trace``'s trace of the step, at a rank's
  shapes, the collectives read from the DTensor redistributions that
  reach the dispatcher; a train cell traces one microbatch, whose body
  (``op_trace.loop("microbatch")``) counts M times while the parameters'
  gather and the optimizer count once (the reference's HLO parser
  multiplies a while body by its trip count).  Every rate is an H100 SXM5
  data-sheet rate: the terms are a model, not a measurement.

Decode cells trace ``flash_decode`` as one op (its fake implementation,
``kernels.flash_decode.traced_op``), not its plain version.  The row's
``traced_ops`` counts the ATen ops (``"aten"``) and every other op by
name.  Errors become
``"status": "error"`` rows and the process exits 1, as the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.configs import (SHAPES, all_cells, cell_supported,
                                 decode_state_kw, default_kv_dtype,
                                 get_config, input_specs)
from repro_torch.distributed import sharding as shd
from repro_torch.models.registry import active_param_count, get_model

#: train cells that take more microbatches (activation residency scales
#: with the tokens of a microbatch): the reference's table
MB_OVERRIDES = {
    "qwen1.5-32b": 32,
    "qwen2.5-14b": 32,
    "gemma2-27b": 32,
    "internvl2-26b": 32,
    "llama4-scout-17b-a16e": 32,
}

#: a card's memory, bytes (H100 SXM5 80 GB)
CARD_BYTES = 80e9

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def fake_world(n: int) -> None:
    """Make the default process group a ``"fake"`` one of ``n`` ranks, this
    process rank 0 (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _fake_like(tree):
    """Fake tensors (zeros) of a tree of meta tensors, under the active
    ``FakeTensorMode``."""
    leaves = flatten(tree)[0]
    return unflatten(tree, [torch.zeros(tuple(x.shape), dtype=x.dtype)
                            for x in leaves])


def train_microbatches(arch: str, shape, mesh, microbatches: int) -> int:
    """The reference's microbatch count for a train cell, halved until it
    divides the rows each DP rank holds (a rank runs whole rows)."""
    mb = max(microbatches, MB_OVERRIDES.get(arch, 0))
    while shape.global_batch % mb:
        mb //= 2
    batch = input_specs(get_config(arch), shape)
    spec = flatten(shd.batch_pspecs(batch, mesh))[0][0]
    rows = shd.local_shape((shape.global_batch,), shd.P(spec[0]), mesh)[0]
    while rows % mb:
        mb //= 2
    return mb


def _batch_only(placements, batch_dim: int) -> list:
    """``placements`` with every shard but the batch dim's replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim == batch_dim else Replicate()
            for p in placements]


def _serve_step(model, kind: str):
    """One sharded serve step of the port's design: parameters gathered
    whole, each rank's batch rows of the decode state gathered over the
    other axes, ``prefill`` / ``decode_step`` (``flash_decode`` where it
    applies) on plain tensors, and the new state cut back to the rank's
    shards."""
    from torch.distributed.tensor import DTensor

    from repro_torch.serving.serve_step import make_decode_step, make_prefill

    fn = (make_decode_step(model, use_kernels=True) if kind == "decode"
          else make_prefill(model))

    def gather_rows(x, batch_dim):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh,
                              _batch_only(x.placements, batch_dim)).to_local()

    def step(params, state, inputs):
        full = unflatten(params, [shd.gather_full(x, x.dtype)
                                  for x in flatten(params)[0]])
        leaves = flatten(state)[0]
        local = unflatten(state, [gather_rows(x, 1) for x in leaves])
        xs = unflatten(inputs, [x.to_local() if isinstance(x, DTensor)
                                else x for x in flatten(inputs)[0]])
        if kind == "decode":
            out, new = fn(full, local, xs)
        else:
            out, new = fn(full, xs, local)
        cut = []
        for x, y in zip(leaves, flatten(new)[0]):
            if isinstance(x, DTensor):
                y = DTensor.from_local(
                    y, x.device_mesh, _batch_only(x.placements, 1),
                    run_check=False).redistribute(x.device_mesh,
                                                  x.placements)
            cut.append(y)
        return out, unflatten(new, cut)

    return step


def build_cell(arch: str, shape_name: str, mesh, *, microbatches: int = 16,
               tc_overrides: dict | None = None) -> dict:
    """Under an active ``FakeTensorMode``: the cell's step function, its
    arguments as DTensors of fake shards, and what :func:`run_cell` reads
    (``fn``, ``args``, ``argument_bytes``, ``state_bytes`` (the donated
    argument's) and, for a train cell, ``microbatches``: the trip count of
    the one microbatch its step runs)."""
    from repro_torch.distributed.act_sharding import set_mesh
    from repro_torch.models.common import P, dp_axes, pick
    from repro_torch.training import optim
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg = get_config(arch)
    model = get_model(cfg)
    shape = SHAPES[shape_name]
    set_mesh(mesh)

    if shape.kind == "train":
        mb = train_microbatches(arch, shape, mesh, microbatches)
        tc = TrainConfig(num_microbatches=1, loss_mode="sharded",
                         **(tc_overrides or {}))
        params = model.init_params(torch.Generator())
        opt = optim.init_opt_state(params)
        del params
        opt = shd.distribute(opt, shd.shardings_of(
            shd.param_pspecs(opt, mesh, fsdp=True), mesh))
        whole = input_specs(cfg, shape)
        one = {k: torch.empty((shape.global_batch // mb,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device="meta")
               for k, x in whole.items()}
        batch_ps = shd.batch_pspecs(one, mesh)
        batch = shd.distribute(_fake_like(one),
                               shd.shardings_of(batch_ps, mesh))
        vshard = pick(mesh, cfg.vocab_size, "model")
        logits_ps = P(dp_axes(mesh) or None, None, vshard)
        step = make_train_step(
            model, tc, param_pspecs=shd.param_pspecs(opt["master"], mesh),
            batch_pspecs=batch_ps, logits_pspec=logits_ps)
        state_bytes = shd.local_nbytes(opt)
        return {"fn": step, "args": (opt, batch), "state_bytes": state_bytes,
                "argument_bytes": state_bytes + shd.local_nbytes(
                    whole, shd.shardings_of(shd.batch_pspecs(whole, mesh),
                                            mesh)),
                "microbatches": mb}

    kv_dtype = default_kv_dtype(arch, shape_name)
    # serve params are replicated over the DP axes unless they don't fit a
    # chip when only model-sharded (llama4-scout: ~200 GB bf16 / 16-way TP)
    serve_fsdp = arch in ("llama4-scout-17b-a16e",)
    params = model.init_params(torch.Generator())
    params = shd.distribute(params, shd.param_shardings(params, mesh,
                                                        fsdp=serve_fsdp))
    state = model.init_decode_state(shape.global_batch, shape.seq_len,
                                    kv_dtype=kv_dtype, device="cpu",
                                    **decode_state_kw(cfg, shape))
    state = shd.distribute(state, shd.shardings_of(
        shd.decode_state_pspecs(state, mesh, cfg), mesh))
    if shape.kind == "prefill":
        inputs = input_specs(cfg, shape)
        specs = shd.batch_pspecs(inputs, mesh)
    else:
        inputs = input_specs(cfg, shape)["tokens"]
        specs = shd.tokens_pspec(shape.global_batch, mesh)
    inputs = shd.distribute(_fake_like(inputs), shd.shardings_of(specs, mesh))
    state_bytes = shd.local_nbytes(state)
    return {"fn": _serve_step(model, shape.kind),
            "args": (params, state, inputs), "state_bytes": state_bytes,
            "argument_bytes": sum(shd.local_nbytes(a)
                                  for a in (params, state, inputs))}


def _cell_memory(cell, temp: float) -> dict:
    """The reference's memory fields from the shards' bytes: the state is
    an argument, an output and donated (updated in place); ``temp`` is the
    traced step's peak of what it allocates."""
    arg, state = cell["argument_bytes"], cell["state_bytes"]
    peak = arg + state + temp - state
    return {"argument_bytes": int(arg), "output_bytes": int(state),
            "temp_bytes": int(temp), "alias_bytes": int(state),
            "peak_per_chip_gib": round(peak / 2 ** 30, 3),
            "fits": bool(peak <= CARD_BYTES)}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             microbatches: int = 16, verbose: bool = True,
             mesh=None) -> dict:
    """One row of the dry-run.  ``mesh``: a ``DeviceMesh`` to use instead
    of the production mesh ``mesh_name`` (whose fake group this makes)."""
    ok, why = cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.act_sharding import clear
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import analysis as roofline
    from repro_torch.roofline import op_trace
    from repro_torch.training.grad_accum import derive_grad_combiner

    t0 = time.time()
    try:
        if mesh is None:
            dims, axes = MESHES[mesh_name]
            fake_world(math.prod(dims))
            mesh = make_mesh(dims, axes)
        chips = mesh.size()
        cfg = get_config(arch)
        model = get_model(cfg)
        shape = SHAPES[shape_name]
        derive_grad_combiner()  # its probes compute: not under fake
        with FakeTensorMode():
            abstract = model.init_params(torch.Generator())
            n_params = sum(x.numel() for x in flatten(abstract)[0])
            n_active = (active_param_count(cfg, abstract)
                        if cfg.num_experts else n_params)
            del abstract
            cell = build_cell(arch, shape_name, mesh,
                              microbatches=microbatches)
            mf = roofline.model_flops_estimate(
                cfg, shape.kind, shape.seq_len, shape.global_batch,
                n_params, n_active)

            def step():
                with op_trace.trips(microbatch=cell.get("microbatches", 1)):
                    return cell["fn"](*cell["args"])

            rl = roofline.analyze(
                step, arch=arch, shape=shape_name, mesh_name=mesh_name,
                chips=chips, model_flops=mf,
                argument_bytes=cell["argument_bytes"])
        clear()
        memory = _cell_memory(cell, rl.cost.peak_bytes)
        counts = rl.cost.op_counts
        n_ops = {"aten": sum(v for k, v in counts.items()
                             if k.startswith("aten::")),
                 **{k: v for k, v in sorted(counts.items())
                    if not k.startswith("aten::")}}
        out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "ok", "compile_s": round(time.time() - t0, 1),
               "n_params": int(n_params), "n_active": int(n_active),
               "attention": ("flash_decode" if n_ops.get(
                   "repro_torch::flash_decode") else "plain"),
               "traced_ops": n_ops,
               "memory": memory, "roofline": rl.to_dict(),
               "cuda_initialized": torch.cuda.is_initialized()}
        if "microbatches" in cell:
            out["microbatches"] = cell["microbatches"]
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] OK "
                  f"trace={out['compile_s']}s "
                  f"peak={memory['peak_per_chip_gib']}GiB/chip "
                  f"fits={memory['fits']} dominant={rl.dominant} "
                  f"step={rl.step_s * 1e3:.2f}ms mfu={rl.mfu:.3f}")
            print("  counted: flops/chip=%.3e bytes/chip=%.3e"
                  % (rl.flops, rl.bytes_accessed))
            print("  collectives:", json.dumps(rl.collective_ops))
        return out
    except Exception as e:
        from repro_torch.distributed.act_sharding import clear

        clear()
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "compile_s": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for (a, s, _, _) in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    results = []
    try:
        for arch, shape in cells:
            for m in meshes:
                r = run_cell(arch, shape, m, microbatches=args.microbatches)
                results.append(r)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{arch}_{shape}_{m}.json".replace("/", "_")
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(r, f, indent=1)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} ==")
    for r in results:
        if r["status"] == "error":
            print(f"  ERROR {r['arch']} × {r['shape']} × {r['mesh']}: "
                  f"{r['error']}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
