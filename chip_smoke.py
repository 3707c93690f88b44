#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

Phases (each raises on failure, and the script then exits non-zero):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (into ``build/repro_torch/``), one
   nvcc per source, all at once, and print ptxas's registers, shared
   memory and spills of the keyed fold's (chunk_monoid_fold's), the radix
   partition's, segment_reduce's, flash_decode's and int_fold's kernels,
   and of the lane-table fold (onehot_fold's);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones: max/min bit for bit (signed
   zeros and NaNs of random payloads included, several a key, one or two a
   key, and in the carried table), sums within 1e-5 of each key's sum of
   absolute values, and two runs of each kernel bit for bit.  The keyed
   folds also with one key holding almost every pair, every key out of
   range, K one past a table (two key tiles) and D = 128.  The sums of B1,
   B2, B6 and B7 also on the lane-table plan's cases, each plan's shape
   checked: the main shapes, one key holding almost every pair (and half
   of them), every key out of range, n below 32 and no multiple of a
   stage, D = 1, 3, 4, 5 and 128 (column tiles), K = 1 and K at the
   crossover and one past it (the index-order pass).  The sort flow's
   kernels too: the radix partitions' layouts bit for bit (keys, starts,
   values at real slots), two runs bit for bit, the hierarchy's leaf
   layout equal to the one-level partition's, and segment_reduce on those
   layouts, with ragged sizes, a key space that is no multiple of the
   bucket, sentinel and out-of-range keys, pad_align 8, 16 and 256, one
   bucket holding half the pairs, every key invalid, D = 8, D = 300 (the
   values left in device memory), key and value views that are not 8-byte
   aligned (D = 2, 3), 1024 buckets (two passes), a hierarchy with a
   level of 512 buckets (fan-outs (2, 512)) and 2048 leaves (K = 2^25,
   two passes).  The combine
   flow's kernels too, by the same rules: K = 1 to 2^16, D = 1 to 128,
   bf16 values, sentinel and out-of-range keys, NaN and signed zeros.
   And flash_decode, f32 and bf16, at the reference kernel test's shapes,
   the bench shape, llama3-8b's decode shape, phase 15's (G = H / Hkv
   = 8, 5 and 6: a full head block of 8 and two partial ones) and phase
   16's (G = 1, D = 64: zamba2's shared attention at S = 2080, whisper's
   self-attention at 33 positions and cross-attention at 1500), with
   ragged kv_len (0, 1, S and lengths that are no multiple of a tile),
   within 1e-5 (both sides fold the same inputs in f32), two runs bit for
   bit, and three planted faults (a position, a head map, a tile) must
   each miss that tolerance at the llama, phase 15 and phase 16 shapes.
   B1 with the counts column folded in the kernel (``onehot_fold(...,
   counts=True)``, the stream flow's fused accumulator) bit for bit the
   fold of ``[values, valid]`` it replaced, at the main path's shape,
   ragged, one key holding almost every pair, every key out of range, two
   key tiles, streaming KeyedSum's K = 2^16, lane column tiles, a
   counts-only column tile and an empty chunk; within 1e-5 of its plain
   version, counts exact; two runs bit for bit.  int_fold (the exact
   integer keyed fold) bit for bit its plain version, tables and counts,
   two runs bit for bit, its inputs unwritten: K = 1 to 2^20, D = 0, 1,
   3 and 6, int32 and int64 rows, values at the int32 limits and near
   ±2^63, sentinel and out-of-range keys, every key invalid, n = 0, 31
   and 2^22, one key holding almost every pair, zipf 1.2, without counts;
3. main path, additive: ``MapReduce(KMeans()).run`` on 2^24 points of the
   Phoenix kmeans shape (3 dimensions, 100 means); the plan must be the
   stream flow with a derived monoid, ``onehot_fold`` must have launched,
   each launch with the lane-table plan, the counts must equal
   ``np.bincount`` and the centroids a float64 numpy reference (rtol =
   atol = 1e-5);
4. main path, dense: the bounding-box (max/min) app on the same points;
   ``chunk_monoid_fold`` must have launched and the boxes must equal
   numpy's per-key max/min bit for bit (int_fold counts its pairs);
   4c. the integer main paths: ``MapReduce(WordCount(2^16)).run`` on 2^24
   zipf tokens and ``MapReduce(Histogram()).run`` on 2^22 pixels, the
   stream flow with the reference's ``mode=additive``, no FALLBACK note
   and no ``LoweringFallbackWarning``, ``int_fold`` once a chunk and no
   other kernel, values and counts ``np.bincount`` bit for bit; then the
   seven Phoenix apps, on small inputs, must give on the card what they
   give on the CPU, each stream flow with the CPU's ``mode=`` (phases 5b,
   6b and 7b too);
5. the sort flow's main paths: ``MapReduce(KeyedSum(K), flow="sort").run``
   on 2^24 pairs (2^21 items of 8 keys, f32 weights drawn from a seed) at
   K = 2^18 (one radix level) and K = 2^20 (two levels);
   ``radix_partition`` or ``radix_partition_multi``, and
   ``segment_reduce``, must have launched, the counts must equal
   ``np.bincount`` and the sums a float64 numpy reference (rtol = atol =
   1e-5); then the seven Phoenix apps under ``flow="sort"``, card == CPU;
6. the combine flow's main paths on the 2^24 KMeans points:
   ``MapReduce(KMeans(), flow="combine")`` (the one-hot lowering,
   ``onehot_combine`` for the values and the counts), the bounding-box
   app (the scatter lowering; its max and min leaves take the sort route,
   radix_partition + segment_reduce) and KMeans with
   ``combine_impl="scatter"`` (``combine_scatter`` for the sum; the sums
   of both KMeans runs on the lane-table plan), counts
   exact, centroids against float64 numpy and boxes bit for bit; then
   ``KeyedSum(2^16)`` on 2^22 pairs, past the one-hot cutoff: the scatter
   lowering's sort route (radix_partition + segment_reduce, never
   combine_scatter), counts exact, sums against float64 numpy, two runs
   bit for bit; then the seven Phoenix apps under ``flow="combine"``;
7. the reduce flow (the paper's baseline, no kernel): KMeans with its
   window as long as the largest count, counts exact and centroids against
   float64 numpy; then the Phoenix apps under ``flow="reduce"``;
7c. the cost model behind ``n_pairs_hint``: (a) the stream and sort
   flows of KeyedSum (f32 weights) at K = 2^10 to 2^20 and 2^22 / 2^24
   pairs, KMeans at 2^24 points and two reduce-flow runs, each the median
   wall of 3 and one profiled run, over the items and a copy in turn (the
   stream flow's eager loop: a call over items the run has not just seen,
   which is what the model prices); the ``cuda`` profile refit from them
   (device time by kernel against ``cost_model.cuda_work``'s bytes, host
   terms from the walls), printed beside the committed ``CUDA_COEFF``
   (the ``cost_profile`` line); (b) with the committed coefficients, the
   model's choice must be the measured winner at every shape it wins by
   2x or more (the ``cost_gate`` line, with the measured and modelled
   crossover K at each n); (c) ``MapReduce(KeyedSum(2^20),
   n_pairs_hint=2^24)`` and ``MapReduce(KMeans(), n_pairs_hint=2^24)``:
   the plan's profile is ``cuda``, the chosen flow's kernels launch and
   the result equals the same flow forced, bit for bit;
8. the serve main path: ``serving.serve_step.generate`` on llama3-8b at
   full width and depth (32 layers, bf16, random weights from a seeded
   generator), batch 4, a 2048-token prompt, 32 greedy tokens;
   flash_decode must launch 32 x 31 times, a second run must give the same
   tokens, the teacher-forced logits must repeat bit for bit, each
   flash_decode call of the decode must agree with its plain version on
   its own inputs within 1e-5, the logits must agree with the plain
   decode on the card and with the decode through the kernel's plain
   version within SERVE_RMS_TOL / SERVE_MAX_TOL, and three planted faults
   must each miss 1e-5 in the decode and fall outside the gate against
   the plain decode; prefill ms,
   decode ms per token and tokens/s over the whole decode loop (one
   synchronisation at its end; the median of three runs), the median step
   (CUDA events), and a profile of one decode step (flash_decode against
   the matmuls) (``serve_setup`` and ``serve_run`` take any transformer
   config: phase 15 runs them too);
9. time each kernel, its plain version and one PyTorch library call at the
   main path's shapes (CUDA events, and replayed from a CUDA graph, without
   the host's per-call work; the device operations of a call; flash_decode
   at llama3-8b's decode shape, the bench shape and phase 15's three
   decode shapes, against SDPA;
   segment_reduce's max at the BoundingBox combine shape against
   scatter_reduce_; int_fold at WordCount's, Histogram's and a counts-only
   K = 100 shape against ``index_add_`` + ``bincount``; the radix
   partitions also at the combine flow's
   sort-route shapes and at 2048 leaves; the keyed folds' rows name their
   plan's shape and give a time with one key holding half the pairs;
   B1 also at the uv.sourceip benchmark cell's shape, K = 2.5M in place on
   the partitioned route, against float64, its plain version and the tile
   route, ``cell_fold_rows``),
   B4's pass sweep (one pass against two; the splits of 2048 leaves), the
   keyed-fold sweep (the lane-table pass against the index-order pass
   over K and D, behind the plan's crossover), the scatter lowering's
   route sweep (combine_scatter against sort_segment_fold over K, at D = 1
   and 3, uniform keys and one key holding half the pairs), the
   BoundingBox and KMeans scatter-lowering runs on each route, each
   main-path run after warm-up, the ratio of the reduce flow's time to the
   combine and stream flows' (the paper's speedup), and profile one run of
   each (device time by kernel, busy share);
10. the staged path (``staged_on_card``, the ``staged`` line): compiled
   calls of KMeans (stream, B1), BoundingBox (stream, B2), WordCount
   (stream, int_fold), KeyedSum
   K = 2^20 (sort, B4 + B5) and KMeans ``flow="combine"`` (B6) at 2^24
   pairs equal an uncached ``run()`` bit for bit and launch their kernels,
   and a second call leaves the first call's tensors; a second MapReduce
   over an equal app derives, tunes and compiles nothing; pow2 buckets at
   2^24 - 4099 and 2^24 - 8191 points equal the exact runs bit for bit,
   with one compile; a pipeline (KeyedSum K = 2^16, then a histogram of
   the sums or key presence mod 8) fused, unfused and stage by stage bit
   for bit; the measured probe and its tune cache; the host syncs of a
   compiled call;
11. the streaming service (``streaming_on_card``, the ``streaming``
   line): ``MapReduce(app, streaming=True).serve(...)``.  (a) Four
   ingests of 2^22 KMeans points (B1, 4 launches, lane plan), of 2^22
   BoundingBox points (B2, 8 launches) and of 2^19 KeyedSum items at
   K = 2^16 (2^22 pairs; B1, 4 launches on the index-order pass) equal
   the batch run whose chunk is the micro-batch, bit for bit, and the
   KeyedSum snapshot equals float64 numpy's per-key sums (within
   SUM_RTOL) and counts (exactly), since the ingests and the batch run
   share B1's launches (phase 2 holds B1 against its plain version at
   this shape); (b) ragged
   micro-batches 2^22, 2^22 - 4099, 5000, 1, 0 and 2^22: counts exact,
   boxes bit for bit numpy's, centroids against float64 numpy, a second
   service bit for bit; (c) 20 ingests of 2^20 points under
   ``sliding(8, 2)`` cover exactly the live periods, and ``tumbling(2)``
   drops a key seen only in expired batches; (d) 50 ingests of one
   2^22-point KMeans batch: ingest ms (median, p99), pairs/s, ``run()``
   of the batch, host syncs an ingest, device busy share, an ingest's
   device time (the ``streaming ingest`` line: the kernels' sum, B1's and
   any ``cat``'s share, first to last op by CUDA events), zero derives,
   tunes, probes and compiles, and a second service is a compiled-cache
   hit; (e) snapshots from the main thread while an ``IngestionQueue``
   worker folds 30 batches under ``sliding(4, 1)``, each consistent, with
   their ms; (f) a warm restart from step 8 of ``ckpt_every=4`` replayed
   to 12, and the newest step, bit for bit, with the checkpoint's and
   the restore's ms and bytes.  B1's and B2's rows of the ``kernels``
   line name their launches on this path (``streaming_launches``).

12. distribution (``distributed_on_card``, the ``distributed`` line), on
   ``LocalMesh(S)``, whose S shards run in turn on the card:
   ``MapReduce(app).run_distributed(items, mesh=...)`` through the staged
   path.  KMeans at 2^24 points, stream flow, S = 1, 2, 4: counts exact,
   centroids against float64 numpy, bit for bit with
   ``engine.merge_partial_tables`` over the shards' own ``LocalRun``
   tables, B1 on every shard; key-sharded (``scatter_output``) the same
   bits.  BoundingBox, S = 4: boxes bit for bit numpy's and the local
   run's, B2 on every shard.  The KMeans combine flow at S = 4, one-hot
   (B6) and scatter (B7), as the stream run.  KeyedSum on 2^24 pairs, sort
   flow, S = 4, K = 2^20 (B3 + B5 on each shard's 2^18 keys) and K = 2^22
   (B4 + B5 on 2^20): counts exact, sums against float64 numpy, delta bit
   for bit with raw, the encoded bytes a shard equal to
   ``roofline.shuffle_wire_bytes``, and the all-to-all's stages timed (the
   rate behind ``cost_model.CUDA_EXCHANGE_BYTES_PER_S``).  The
   reference's wire gate at 2^22 pairs over 16 shards (delta <= 0.6x raw).
   WordCount on zipf text (2^24 tokens, 2^16 words), reduce and sort
   flows at S = 4, ``skew="off"`` and ``"auto"`` (balanced boundaries,
   a hot key split on the sort flow): counts exact, off and auto bit for
   bit, nothing overflows under ``strict``; the default capacity overflows,
   raises under ``strict`` and otherwise warns into ``plan.diagnostics``.
   ``ProcessGroupMesh`` over NCCL at world size 1: bit for bit with
   ``LocalMesh(1)``.  A second ``compile()`` is a cache hit with no
   derive, tune or compile.  Each run's wall (median of 3), device time
   and launches a shard; B1-B7's rows of the ``kernels`` line name their
   launches a shard on this path (``distributed_launches``).
13. resilience (``resilient_on_card``, the ``resilient`` line):
   ``MapReduce(app).run_resilient(items, options=...)``, every shard in
   this process on the card.  (a) Fault-free over 4 hosts, bit for bit
   ``run_distributed(LocalMesh(S))`` at the same S: KMeans stream S = 4
   and 8 (B1), BoundingBox S = 8 (B2), the KMeans combine flow one-hot
   (B6) and scatter (B7) at S = 4, KeyedSum sort S = 4 at K = 2^20 (B3 +
   B5) and 2^22 (B4 + B5), raw and delta, and WordCount on zipf text, sort,
   S = 4, ``skew="auto"`` (the hot-split phase B); counts exact, max/min
   bit for bit numpy's, sums within SUM_RTOL of float64 numpy.  (b) Drills
   on KMeans stream and KeyedSum 2^20 sort, 8 shards over 4 hosts: host 2
   dies; host 1 dies after one shard with ``ckpt_dir`` (restored [1]) and
   with a dead disk; a straggler and an elastic 4 -> 3 at S = 4; a chaos
   drill on a ``FileKVStore`` (the coordinator killed, one of eight
   partials corrupt, two store timeouts, a partitioned host): each bit for
   bit the fault-free run, its log the reference tests' values, and every
   kernel's launches the partials the log accounts for (a partitioned
   host's dropped ones too) times one partial's, plus phase B's.  A
   partial checkpointed under delta is rejected by its wire epoch under
   raw.  (c) Each run's wall beside ``run_distributed``'s (median of 3),
   each drill's wall, device time and busy share, the time to recover one
   shard (recompute it, or restore its checkpoint) and a checkpoint's ms
   and bytes.  (d) A repeat call derives, tunes and compiles nothing.
   B1-B7's rows of the ``kernels`` line name their launches on this path
   (``resilient_launches``).
14. dense-family training (``train_on_card``, the ``train`` line), after
   the earlier phases' memory is released: ``training.train_step`` at
   full model width with two layers, random weights from seed 0 on the
   card, batches from ``data.pipeline.global_batch`` (1024 tokens a row),
   the chunked loss (vocab chunks of 8192), one warm-up step of the
   schedule and a peak rate of 3e-5 (``TRAIN_LR``).  (a) llama3-8b (32 -> 2 layers), batch 8, 4 microbatches:
   four steps in the ``combiner`` accumulation mode, then four in
   ``materialize``, each from a fresh copy of one initial state kept on
   the host; each mode's step ms (after the warm step), tokens/s and peak
   device memory; the losses finite and falling, the modes' first losses
   within 1e-5, two combiner steps from the cloned state bit for bit
   (losses and a digest of every bit of the state), and the materialize
   peak above the combiner's by at least 2 x 4P bytes (P parameters);
   then the loss alone (forward and backward of one microbatch), chunked
   against materialized: within 1e-4, the chunked peak at least half an
   f32 logits tensor below.  (b) gemma2-27b (46 -> 2 layers, one local,
   one global), batch 2, 2 microbatches, the ``combiner`` mode: the same
   readings and gates but the materialize ones.  No kernel runs here:
   the reference's training path has no Pallas kernel.
15. the transformer's MoE and VLM branches (``moe_on_card``, the ``moe``
   line), after phase 14's memory is released, random weights from seed
   0, the peak-memory counter reset before each model.  Served through
   ``generate`` as phase 8 (batch 4, a 2048-token prompt, 32 greedy
   tokens; ``serve_run`` with the same checks, but for one: the logits
   are gated against the decode through the kernel's plain version, and
   those against the model's plain decode, whose attention rounds its
   weights to bf16 (C.22), and the planted faults' there, are read and
   printed: at 48 layers that rounding alone reaches the gate, and the
   newest-position fault moves qwen3-moe's logits by less than it; every
   fault must miss 1e-5 in the decode's own flash_decode calls): (a)
   qwen3-moe-30b-a3b at full width, 48 -> 12 layers (128 experts top-8;
   flash_decode 12 x 31 times at G = 8), (b) llama4-scout-17b-a16e at
   full width, 48 -> 4 layers (16 experts top-1; 4 x 31 at G = 5), (c)
   internvl2-26b at full width, 48 -> 12 layers, 256 random patch
   embeddings in front of the prompt (12 x 31 at G = 6, S = 2336).
   The compared and faulty decodes replay the kernel decode's routing,
   and the routing flips the plain decode would have taken are counted
   and printed; one decode step of each model is profiled.  For
   MoE, prefill alone in the ``combiner`` and ``materialize`` modes (ms,
   the two modes' logits and routings against each other) and, at every
   layer of a prefill, both modes on the same input within the serve
   gate, the combiner bit for bit on a repeat.  Then ``train_step`` at
   full width, 48 -> 2 layers, the launcher's batches, combiner
   accumulation: (d) qwen3-moe-30b-a3b, 8 x 1024, 4 microbatches, four
   steps in each MoE mode; (e) internvl2-26b, 2 x (256 + 1024), 2
   microbatches, the combiner.  Step ms, tokens/s, peak memory and the
   load-balance loss per mode; losses finite and falling, two steps from
   one cloned state bit for bit in each mode, the modes' first losses
   within MOE_LOSS_RTOL.
16. the SSM, hybrid and audio families (``ssm_on_card``, the ``ssm``
   line), after phase 15's memory is released, random weights from seed
   0.  (a)-(b) Served through ``generate`` at full width and depth, batch
   4, 32 greedy tokens (``serve_run``): mamba2-2.7b (64 layers, a
   2048-token prompt; no kernel on its path: launches all 0, tokens and
   teacher-forced logits repeat bit for bit), zamba2-1.2b (38 layers, a
   2048-token prompt; flash_decode 6 x 31 times in the shared attention,
   G = 1) and whisper-medium (24 + 24 layers, 1500 random frames and a
   BOS token; flash_decode 48 x 32 times, self- and cross-attention, the
   BOS step's in prefill included); every flash_decode call of the
   teacher-forced decode within FD_TOL of its plain version, every
   planted fault missing it; whisper's logits within 2^-5 of the decode
   through the kernel's plain version, every fault outside; zamba2's
   bf16 logits read, not gated (its rounding alone moves them past 2^-5,
   ROADMAP C.69), and zamba2 served again in f32 with the logits within
   F32_LOGIT_TOL and every fault outside; the prefills and one decode
   step profiled.  (c) The SSD prefill against the recurrence in f32 at
   full width (mamba2-2.7b at 32 of 64 layers and zamba2-1.2b at 20 of
   38, 2 x 512 tokens, two chunks): the prefill's last position and one step after it, and
   the chunked forward at every position, against 512 single-token
   decode steps, within SSD_TOL on the softmax (the reference's test) and
   on the logits (C.68); the exclusive inter-chunk state made inclusive
   and the decode's conv window shifted by one must each fail it.  (d)
   ``train_step`` at full width, combiner accumulation, 2 microbatches,
   the published chunk of 256: mamba2-2.7b at 8 of 64 layers and
   zamba2-1.2b at 14 of 38 (2 x 1024 tokens), whisper-medium whole (2 x
   1500 frames, 448 tokens); losses finite and falling, every gradient finite,
   two steps from one cloned state bit for bit; step ms, tokens/s, peak
   memory.

18. the op trace (``traced_on_card``, the ``traced`` line): (a)
   ``Compiled.traced_cost`` of KMeans (2^24 points) and WordCount (2^24
   zipf tokens over 2^16 words) in the stream, combine and reduce flows:
   traced bytes, FLOPs and peak, ``cost_analysis()["model_bytes"]``, one
   warm untraced call's CUDA-event time and the traced bytes over it as a
   share of 3.35 TB/s; the stream and combine flows under the reduce
   flow in bytes, the stream flow's peak under half the combine flow's
   and the same at half the items (the combine flow's grows with them),
   each peak what a call holds beyond its items; KMeans's stream flow no
   more bytes than its combine flow, with the same FLOPs in its kernel
   ops and a peak no higher than before B1 folded the counts column;
   WordCount's stream flow no more bytes than its combine flow; and
   every launch ``_build`` counted during a traced call one op of its
   trace; (b) the
   stream and combine flows at 2^14 items on the card and on the CPU
   (kernels on, one chunk size): the same kernel ops and bytes; (c) WordCount ``run_distributed`` on ``LocalMesh(S)``, S = 2
   and 4, at 2^20 and 2^22 pairs: the stream flow's wire bytes a shard
   the same at both, the reduce flow's larger; (d) phase 17's dry-run
   cells beside PR 29's FLOPs, bytes and wire bytes.
19. the examples (``examples_on_card``, the ``examples`` line): the
   port's single-card examples (``examples/torch/``: quickstart,
   pipeline_wordcount_topk, serve_lm, train_lm at 4 steps) through their
   ``main`` on the card, their default device: quickstart's counts equal
   ``np.bincount``, the pipeline's fused run its unfused one, serve_lm's
   tokens twice the same, train_lm's losses finite; each one's wall.

``run()`` prepares its run on its first call (the staged ``compile()``),
and on the card that is one warm-up run on zeros, whose launches count:
the main paths call ``mr.lower(items).compile()`` before they reset the
launch counters, so each path's launches are its run's own.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.  Without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_POINTS = 1 << 24  # Phoenix kmeans: 3 dimensions, 100 means
SORT_ITEMS = 1 << 21  # KeyedSum: 8 keys per item, 2^24 pairs
SORT_KEY_SPACES = (1 << 18, 1 << 20)  # one radix level; two levels
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SUM_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bits(t):
    import torch
    return t.contiguous().view(torch.int32)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph of ``iters``
    calls: the device's time without the host's per-call work, which sets
    the pace of back-to-back eager calls of a small kernel."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nan_payloads(rng, size: int):
    """Quiet NaNs of random sign and payload: never the canonical one, so
    a kernel that makes a NaN anew, or keeps another NaN of its key than
    the plain version keeps, shows."""
    bits = (np.uint32(0x7FC00000)
            | rng.integers(1, 1 << 22, size=size, dtype=np.uint32)
            | (rng.integers(0, 2, size=size, dtype=np.uint32)
               << np.uint32(31)))
    return bits.astype(np.uint32).view(np.float32)


def plant_specials(rng, arr, nan_share: float = 0.001) -> None:
    """In place: a tenth of the entries +0, a tenth -0, and ``nan_share``
    of them NaNs of random payloads (several on a key at the main path's
    sizes; one or two on many keys at a ``nan_share`` of 0.3)."""
    flat = arr.reshape(-1)
    p = rng.random(flat.size)
    flat[p < 0.1] = 0.0
    flat[(p >= 0.1) & (p < 0.2)] = -0.0
    nan = (p >= 0.2) & (p < 0.2 + nan_share)
    flat[nan] = nan_payloads(rng, int(nan.sum()))


#: the keys of a keyed-fold case: uniform, one key holding almost every
#: pair, one key holding half the pairs, or every key outside [0, K)
KEY_MIXES = ("uniform", "one_hot_key", "half_hot_key", "all_out")


def fold_keys(rng, n, k, mix: str = "uniform", bad_keys: bool = True):
    """[n] int32 keys in [0, K), with sentinel (K) and out-of-range keys
    mixed in (``bad_keys``), by :data:`KEY_MIXES`."""
    keys = rng.integers(0, k, size=n).astype(np.int32)
    if mix == "one_hot_key":  # key K // 2 holds all but about 1/1000
        keys[rng.random(n) >= 1e-3] = k // 2
    if mix == "half_hot_key":  # key K // 2 holds about half the pairs
        keys[rng.random(n) < 0.5] = k // 2
    bad = rng.random(n) < (1.0 if mix == "all_out" else 0.1)
    if bad_keys or mix == "all_out":
        keys[bad] = rng.choice(np.array([k, k + 3, -1, -7], np.int32),
                               size=int(bad.sum()))
    return keys


def fold_inputs(rng, n, d, k, *, specials: bool, bad_keys: bool,
                mix: str = "uniform", nan_share: float = 0.001):
    import torch
    keys = fold_keys(rng, n, k, mix, bad_keys)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    acc = rng.standard_normal((k, d)).astype(np.float32)
    if specials:
        for arr in (vals, acc):
            plant_specials(rng, arr, nan_share)
    return tuple(torch.from_numpy(a).cuda() for a in (keys, vals, acc))


def check_kernels(rng) -> None:
    """Phase 2: every kernel against its plain version, on the card."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_plain
    from repro_torch.kernels.segment_reduce import chunk_monoid_fold_plain

    cases = [  # (n, d, k, block_k, label[, mix, nan_share])
        (CUDA_CHUNK_PAIRS, 4, 100, None, "main path (KMeans fused [K, 3+1])"),
        (CUDA_CHUNK_PAIRS, 3, 100, None, "main path (bounding-box leaf)"),
        (1_000_003, 9, 300, None, "ragged"),
        (5_001, 13, 1000, 96, "block_k not dividing K"),
        (777, 1, 1, None, "one key"),
        (3, 2, 50, 7, "fewer pairs than a tile"),
        (CUDA_CHUNK_PAIRS, 3, 100, None, "one key holds almost every pair",
         "one_hot_key"),
        (100_003, 3, 100, None, "every key out of range", "all_out"),
        (100_003, 1, ops.FOLD_TABLE_FLOATS + 1, None,
         "K one past a table (two key tiles)"),
        (200_003, 128, 100, None, "D = 128 (two column tiles)"),
        (1_000_003, 3, 1000, None, "K = 1000, one-warp blocks"),
        (1 << 22, 2, 1 << 16, None,
         "streaming KeyedSum K = 2^16 (fused [K, 1+1], index order)"),
    ] + [(n, 3, k, None, f"NaN payloads: one and two a key, K = {k}",
          "uniform", 0.3) for n, k in ((501, 100), (5_001, 1000),
                                       (5_001, 2000))]

    def twice(fn, what):
        a, b = fn(), fn()
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: two runs differ")
        return a

    for n, d, k, block_k, label, *how in cases:
        mix = how[0] if how else "uniform"
        nan_share = how[1] if len(how) > 1 else 0.001
        # the plain contraction's one-hot: at most FOLD_PLAIN_KEY_BLOCK keys
        plain_block = block_k or min(k, ops.FOLD_PLAIN_KEY_BLOCK)
        keys, vals, acc = fold_inputs(rng, n, d, k, specials=False,
                                      bad_keys=True, mix=mix)
        plain = onehot_fold_plain(keys, vals, acc, block_k=plain_block)
        # an f32 sum in another order: within SUM_RTOL of sum |terms|
        tol = SUM_RTOL * onehot_fold_plain(keys, vals.abs(), acc.abs(),
                                           block_k=plain_block) + SUM_RTOL
        for name, fn in (
                ("onehot_fold", lambda: ops.onehot_fold(
                    keys, vals, acc, block_k=block_k)),
                ("chunk_monoid_fold", lambda: ops.chunk_monoid_fold(
                    keys, vals, acc, "add", block_k=block_k))):
            err = (twice(fn, f"{name} add ({label})") - plain).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"{name} add != plain ({label}): max "
                                     f"abs err {err.max().item()}")
        for op in ("max", "min"):
            keys, vals, acc = fold_inputs(rng, n, d, k, specials=True,
                                          bad_keys=True, mix=mix,
                                          nan_share=nan_share)
            got = twice(lambda: ops.chunk_monoid_fold(
                keys, vals, acc, op, block_k=block_k),
                f"chunk_monoid_fold {op} ({label})")
            want = chunk_monoid_fold_plain(keys, vals, acc, op)
            if not torch.equal(bits(got), bits(want)):
                diff = (bits(got) != bits(want)).sum().item()
                raise AssertionError(
                    f"chunk_monoid_fold {op} != plain bitwise ({label}): "
                    f"{diff} elements differ")
        log(f"kernels == plain: {label} n={n} d={d} k={k} "
            f"block_k={block_k} "
            f"plan={ops.fold_plan(n, k, d, 'add', block_k)}")


def check_counts_column(rng) -> None:
    """Phase 2, B1 with the counts column folded in the kernel
    (``onehot_fold(..., counts=True)``, the stream flow's fused
    accumulator): bit for bit the parent's form, a fold of ``[values,
    valid]`` onto the same ``[K, D + 1]`` acc; within SUM_RTOL of the plain
    version, whose counts it equals exactly; two runs bit for bit."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_plain

    cases = [  # (n, D values, k, label[, mix]): acc is [K, D + 1]
        (CUDA_CHUNK_PAIRS, 3, 100, "main path (KMeans [K, 3+1])"),
        (1_000_003, 8, 300, "ragged"),
        (CUDA_CHUNK_PAIRS, 3, 100, "one key holds almost every pair",
         "one_hot_key"),
        (100_003, 3, 100, "every key out of range", "all_out"),
        (100_003, 1, ops.FOLD_TABLE_FLOATS + 1,
         "K one past a table (two key tiles, a counts-only column tile)"),
        (1 << 22, 1, 1 << 16,
         "streaming KeyedSum K = 2^16 (fused [K, 1+1], index order)"),
        (300_007, 9, 100, "D = 9 + 1 (lane column tiles)"),
        (200_003, 128, 100, "D = 128 + 1 (a counts-only lane column tile)"),
        (1_000_003, 3, 1000, "K = 1000 (index order)"),
        (31, 3, 100, "n < 32"),
        (100_003, 3, 1, "K = 1"),
        (0, 3, 100, "empty chunk"),
    ]
    for n, d, k, label, *how in cases:
        mix = how[0] if how else "uniform"
        keys, vals, _ = fold_inputs(rng, n, d, k, specials=False,
                                    bad_keys=True, mix=mix)
        acc = torch.from_numpy(
            rng.standard_normal((k, d + 1)).astype(np.float32)).cuda()
        valid = ((keys >= 0) & (keys < k)).to(torch.float32)[:, None]
        parent = ops.onehot_fold(keys, torch.cat([vals, valid], 1), acc)
        got = [ops.onehot_fold(keys, vals, acc, counts=True)
               for _ in range(2)]
        if not torch.equal(bits(got[0]), bits(got[1])):
            raise AssertionError(f"onehot_fold counts ({label}): two runs "
                                 f"differ")
        if not torch.equal(bits(got[0]), bits(parent)):
            diff = (bits(got[0]) != bits(parent)).sum().item()
            raise AssertionError(f"onehot_fold counts != the [values, "
                                 f"valid] fold bitwise ({label}): {diff} "
                                 f"elements differ")
        block = min(k, ops.FOLD_PLAIN_KEY_BLOCK)
        plain = onehot_fold_plain(keys, vals, acc, block_k=block,
                                  counts=True)
        tol = SUM_RTOL * onehot_fold_plain(keys, vals.abs(), acc.abs(),
                                           block_k=block,
                                           counts=True) + SUM_RTOL
        err = (got[0] - plain).abs()
        if not bool((err <= tol).all()) or not torch.equal(
                got[0][:, -1], plain[:, -1]):
            raise AssertionError(f"onehot_fold counts != plain ({label}): "
                                 f"max abs err {err.max().item()}")
        plan = ops.fold_plan(n, k, d + 1, "add") if n else None
        log(f"counts column == [values, valid] bitwise: {label} n={n} "
            f"d={d}+1 k={k} plan={plan}")


def lane_crossover(d: int) -> int:
    """The most keys whose sum of D columns takes the lane-table plan."""
    from repro_torch.kernels import ops
    return max(k for k in range(1, ops.FOLD_LANE_MAX_KEYS + 1)
               if ops.fold_plan(1 << 22, k, d, "add").shape == "lane")


def check_lane_folds(rng) -> None:
    """Phase 2, the lane-table shape of a sum: B1 and B2's add (onto acc),
    B6 and B7's add (from zero) against their plain versions within
    SUM_RTOL of each key's sum of |terms|, two runs bit for bit; each case
    takes the plan shape it names (lane tables up to the crossover, the
    index-order pass one key past it)."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_plain

    cases = [  # (n, d, k, label[, mix]); N a multiple of no stage
        (CUDA_CHUNK_PAIRS, 4, 100, "B1 main shape (KMeans [K, 3+1])"),
        (N_POINTS, 3, 100, "B6/B7 main shape (KMeans values)"),
        (N_POINTS, 1, 100, "B6 main shape (KMeans counts)"),
        (CUDA_CHUNK_PAIRS, 4, 100, "one key holds almost every pair",
         "one_hot_key"),
        (N_POINTS, 3, 100, "one key holds half the pairs", "half_hot_key"),
        (100_003, 3, 100, "every key out of range", "all_out"),
        (17, 3, 100, "n < 32"),
        (31, 4, 100, "n < 32"),
        (1_000_003, 4, 100, "n not a multiple of a stage"),
        (300_007, 1, 100, "D = 1"),
        (300_007, 5, 100, "D = 5 (column tiles)"),
        (200_003, 128, 100, "D = 128 (column tiles)"),
        (100_003, 3, 1, "K = 1"),
        (100_003, 4, 1, "K = 1"),
    ]
    for d in (1, 3, 4):
        top = lane_crossover(d)
        cases += [(1_000_003, d, top, f"K = {top}, the crossover at D = {d}"),
                  (1_000_003, d, top + 1, f"K = {top + 1}, one past it")]

    def twice(fn, what):
        a, b = fn(), fn()
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: two runs differ")
        return a

    for n, d, k, label, *how in cases:
        mix = how[0] if how else "uniform"
        plan = ops.fold_plan(n, k, d, "add")
        want = "lane" if "one past" not in label else ops.table_plan(
            n, k, d).shape
        if plan.shape != want:
            raise AssertionError(f"lane folds ({label}): plan {plan}")
        plain_block = min(k, ops.FOLD_PLAIN_KEY_BLOCK)
        keys, vals, acc = fold_inputs(rng, n, d, k, specials=False,
                                      bad_keys=True, mix=mix)
        zero = torch.zeros_like(acc)
        for start, fns in (
                (acc, (("onehot_fold", lambda: ops.onehot_fold(
                    keys, vals, acc)),
                       ("chunk_monoid_fold", lambda: ops.chunk_monoid_fold(
                           keys, vals, acc, "add")))),
                (zero, (("onehot_combine", lambda: ops.onehot_combine(
                    keys, vals, k)),
                        ("combine_scatter", lambda: ops.combine_scatter(
                            keys, vals, k, "add"))))):
            plain = onehot_fold_plain(keys, vals, start, block_k=plain_block)
            tol = SUM_RTOL * onehot_fold_plain(
                keys, vals.abs(), start.abs(), block_k=plain_block) + SUM_RTOL
            for name, fn in fns:
                err = (twice(fn, f"{name} add ({label})") - plain).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"{name} add != plain ({label}): "
                                         f"max abs err {err.max().item()}")
        del plain, tol, keys, vals, acc, zero
        log(f"lane folds == plain: {label} n={n} d={d} k={k} plan={plan}")


@contextlib.contextmanager
def fold_shapes():
    """The plan shape of each keyed-fold launch (B1, B2, B6, B7) made in
    the block, by kernel: each binding is wrapped for the block, and
    records its plan before it launches."""
    from repro_torch.kernels import combine_scatter as cs
    from repro_torch.kernels import onehot_combine as oc
    from repro_torch.kernels import segment_reduce as sr

    seen: dict[str, list[str]] = {}
    bindings = ((oc, "onehot_fold"), (sr, "chunk_monoid_fold"),
                (oc, "onehot_combine"), (cs, "combine_scatter"))
    saved = [getattr(mod, f"{name}_cuda") for mod, name in bindings]

    def wrap(fn, name):
        def call(*args, **kw):  # the plan: the bindings' last positional
            seen.setdefault(name, []).append(args[-1].shape)
            return fn(*args, **kw)
        return call

    for (mod, name), fn in zip(bindings, saved):
        setattr(mod, f"{name}_cuda", wrap(fn, name))
    try:
        yield seen
    finally:
        for (mod, name), fn in zip(bindings, saved):
            setattr(mod, f"{name}_cuda", fn)


def lane_launches(seen, launches, names) -> None:
    """Every launch of the kernels ``names`` (by the counts) took the
    lane-table plan."""
    for name in names:
        if seen.get(name, []) != ["lane"] * launches[name]:
            raise AssertionError(f"{name}: {launches[name]} launches, plan "
                                 f"shapes {seen.get(name)}; lane tables "
                                 f"expected")


def kmeans_centroids(pts, assign):
    """(counts, float64 centroids) of the KMeans points, by numpy."""
    counts = np.bincount(assign, minlength=100)
    sums = np.stack([np.bincount(assign, weights=pts[:, j].astype(np.float64),
                                 minlength=100) for j in range(3)], axis=1)
    return counts, sums / np.maximum(counts, 1)[:, None]


def numpy_boxes(pts, assign):
    """Per-key max and min of the KMeans points, by numpy."""
    order = np.argsort(assign, kind="stable")
    starts = np.searchsorted(assign[order], np.arange(100))
    spts = pts[order]
    return np.concatenate([np.maximum.reduceat(spts, starts, axis=0),
                           np.minimum.reduceat(spts, starts, axis=0)], axis=1)


def main_path_additive(pts, assign):
    """Phase 3."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    mr = MapReduce(apps.KMeans())  # the process's first plan (C.20)
    first_plan_ms = (time.perf_counter() - t0) * 1e3
    log(f"first plan in the process: {first_plan_ms:.1f} ms")
    plan = mr.plan
    if (plan.flow, plan.derivation.strategy, mr.tiling.mode) != (
            "stream", "monoid", "additive") or not mr.use_kernels:
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    items = (torch.from_numpy(assign).cuda(), torch.from_numpy(pts).cuda())
    mr.lower(items).compile()  # staged first: the warm-up's launches
    with fold_shapes() as seen:  # stay out of the run's count
        ops.reset_launch_counts()
        res = mr.run(items)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    if launches["onehot_fold"] <= 0:
        raise AssertionError(f"onehot_fold never launched: {launches}")
    lane_launches(seen, launches, ("onehot_fold",))
    log(mr.explain())
    want_counts, want = kmeans_centroids(pts, assign)
    counts = res.counts.cpu().numpy()
    if not np.array_equal(counts, want_counts):
        raise AssertionError("KMeans counts != np.bincount")
    got = res.values.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    log(f"main path additive: KMeans {len(assign)} points, counts exact "
        f"(max {want_counts.max()} per key), centroids max abs err "
        f"{np.abs(got - want).max():.3g}, launches {launches}, plans {seen}")
    return mr, items, launches, first_plan_ms


def main_path_dense(pts, assign, items):
    """Phase 4."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    mr = MapReduce(apps.BoundingBox())
    if (mr.plan.flow, mr.tiling.mode) != ("stream", "dense"):
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    mr.lower(items).compile()  # staged first (the warm-up's launches)
    ops.reset_launch_counts()
    res = mr.run(items)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["chunk_monoid_fold"] <= 0 or launches["int_fold"] <= 0:
        raise AssertionError(f"chunk_monoid_fold or int_fold (the counts) "
                             f"never launched: {launches}")
    want = numpy_boxes(pts, assign)
    got = res.values.cpu().numpy()
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("bounding boxes != numpy per-key max/min")
    log(f"main path dense: bounding boxes bitwise equal to numpy, launches "
        f"{launches}")
    return mr, launches


def phoenix_on_card(flow: str = "auto") -> None:
    """Phases 4b, 5b, 6b and 7b: the seven Phoenix apps (small inputs) on
    the card equal the same runs on the CPU — integer results and counts
    exactly, float sums within rtol = atol = 1e-5 (another summation
    order)."""
    from repro_torch import MapReduce, apps

    modes = {}
    for name in apps.ALL:
        app, items = apps.build(name, np.random.default_rng(2), scale=0.05)
        card_mr = MapReduce(app, flow=flow)
        host_mr = MapReduce(app, flow=flow, device="cpu")
        if card_mr.plan.flow == "stream":  # the fold's lowering, both sides
            modes[name] = (card_mr.tiling.mode, host_mr.tiling.mode)
            if modes[name][0] != modes[name][1]:
                raise AssertionError(f"{name}: stream mode={modes[name][0]} "
                                     f"on the card, {modes[name][1]} on the "
                                     f"CPU:\n{card_mr.explain()}")
        card = card_mr.run(items)
        host = host_mr.run(items)
        if not np.array_equal(card.counts.cpu().numpy(),
                              host.counts.numpy()):
            raise AssertionError(f"{name}: counts differ card vs CPU")
        got, want = card.values.cpu().numpy(), host.values.numpy()
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    log(f"Phoenix apps (flow={flow}) on the card == on the CPU: "
        f"{', '.join(apps.ALL)}; stream modes (card, CPU) {modes}")


def kernel_rows(rng, launches_add, launches_dense, ops_count) -> list[dict]:
    """Phase 8: kernel, plain and library times at the main path's shapes;
    ``ops_count``: the device operations of phase 2b."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_plain
    from repro_torch.kernels.segment_reduce import chunk_monoid_fold_plain

    n, k = CUDA_CHUNK_PAIRS, 100
    rows = []
    # B1 as the stream flow calls it: [n, 3] values onto the fused [K, 3+1]
    # accumulator, the counts column folded in the kernel
    for name, d, op in (("onehot_fold", 3, "add"),
                        ("chunk_monoid_fold", 3, "max")):
        keys, vals, acc = fold_inputs(rng, n, d, k, specials=False,
                                      bad_keys=False)
        keys64 = keys.long()
        width = d
        if name == "onehot_fold":
            width = d + 1
            acc = torch.cat([acc, torch.zeros_like(acc[:, :1])], 1)
            # the library's call folds a ones column made beforehand
            ones = torch.cat([vals, torch.ones_like(vals[:, :1])], 1)
            kern = lambda ks=keys: ops.onehot_fold(  # noqa: E731
                ks, vals, acc, counts=True)
            plain = lambda: onehot_fold_plain(  # noqa: E731
                keys, vals, acc, counts=True)
            lib = lambda: acc.index_add(0, keys64, ones)  # noqa: E731
            launches = launches_add[name]
        else:
            idx = keys64[:, None].expand(n, d).contiguous()
            kern = lambda ks=keys: ops.chunk_monoid_fold(  # noqa: E731
                ks, vals, acc, op)
            plain = lambda: chunk_monoid_fold_plain(  # noqa: E731
                keys, vals, acc, op)
            lib = lambda: acc.scatter_reduce(  # noqa: E731
                0, idx, vals, "amax", include_self=True)
            launches = launches_dense[name]
        # the graphs first, each beside the same call with one key holding
        # half the pairs: a plain version's large product just before slows
        # the card's next tens of microseconds
        hot = torch.from_numpy(fold_keys(rng, n, k, "half_hot_key",
                                         bad_keys=False)).cuda()
        kern_graph_ms = graph_ms(kern, 20)
        hot_ms = graph_ms(lambda: kern(hot), 20)
        err = (kern() - plain()).abs().max().item()
        nbytes = n * (4 + 4 * d) + 2 * k * width * 4
        n_ops = n * width  # one add (or compare) per column of a pair
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        ms = time_ms(kern, 20)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/onehot_combine.py:69"
                         if name == "onehot_fold"
                         else "src/repro/kernels/segment_reduce.py:102"),
            "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": time_ms(plain, 5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib, 20),
            "graph_ms": kern_graph_ms, "library_graph_ms": graph_ms(lib, 20),
            "device_ops": ops_count[name],
            "plan": ops.fold_plan(n, k, width, op).shape,
            "hot_half_graph_ms": hot_ms,
            "shape": {"n": n, "d": d, "k": k, "op": op,
                      "acc_columns": width},
        })
    return rows


#: the uv.sourceip benchmark cell's groups: B1 onto [K, 1 + counts]
CELL_FOLD_K = 2_500_000
#: key block of the plain version's one-hot contraction at the cell's
#: shape: its [n, block] f32 one-hot is 8 GiB at a card chunk
CELL_PLAIN_KEY_BLOCK = 512


def cell_fold_rows(rng) -> list[dict]:
    """Phase 9: B1 at the uv.sourceip cell's shape, as its chunk loop
    calls it: a card chunk of pairs with one value column onto the fused
    [2.5M, 1 + counts] accumulator, in place (``ops.onehot_fold(...,
    counts=True, inplace=True)``), which takes the partitioned route.  With
    uniform keys, and with half the pairs on one key (its region cut into
    segments joined in order), sentinel and negative keys mixed into both.
    Each is held to float64 sums within SUM_RTOL of each key's sum of
    absolute values, the counts exactly, and a bfloat16 control (the values
    rounded to bfloat16, summed in float64) must miss that tolerance.  The
    uniform case is also held to the plain version (``onehot_fold_plain``
    over key blocks of :data:`CELL_PLAIN_KEY_BLOCK`, one timed call: it
    compares every pair with every key).  Beside the route's time: the
    tile route's (``ops.tile_plan``, out of place as before the route), the
    bound, ``index_add_``'s, each fold's allocations and its launches."""
    import torch
    from repro_torch import spans
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import (onehot_fold_cuda,
                                                    onehot_fold_plain)

    n, k, d, width = CUDA_CHUNK_PAIRS, CELL_FOLD_K, 1, 2
    plan = ops.fold_plan(n, k, width, "add", None, True, True)
    tile = ops.tile_plan(n, k, width, "add")
    if plan.route != "partitioned":
        raise AssertionError(f"cell fold: not on the partitioned route: "
                             f"{plan}")
    acc = torch.from_numpy(np.concatenate([
        rng.standard_normal((k, d)).astype(np.float32),
        rng.integers(0, 64, size=(k, 1)).astype(np.float32)], 1)).cuda()
    vals = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).cuda()
    row = {"name": "onehot_fold", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/onehot_fold.cu",
           "replaces": "src/repro/kernels/onehot_combine.py:69",
           "plan": plan.route, "tile_plan_scans": tile.scans,
           "scans": plan.scans, "sub_chunks": plan.n_seg,
           "shape": {"n": n, "d": d, "k": k, "op": "add",
                     "acc_columns": width, "inplace": True}}

    def fold_in_place(keys, start):
        out = start.clone()
        return ops.onehot_fold(keys, vals, out, counts=True, inplace=True)

    def peak_bytes(fn):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        return peak

    for mix in ("uniform", "half_hot_key"):
        keys = torch.from_numpy(fold_keys(rng, n, k, mix)).cuda()
        ok = (keys >= 0) & (keys < k)
        k64 = keys[ok].long()
        sums = acc[:, 0].double().index_add(0, k64, vals[ok, 0].double())
        mass = acc[:, 0].double().abs().index_add(
            0, k64, vals[ok, 0].double().abs()).clamp(min=1.0)
        counts = acc[:, 1].double().index_add(
            0, k64, torch.ones_like(k64, dtype=torch.float64))
        ops.reset_launch_counts()
        with spans.recording() as rec:
            got = fold_in_place(keys, acc)
        torch.cuda.synchronize()
        launches = {name: c for name, c in ops.launch_counts().items() if c}
        again = fold_in_place(keys, acc)
        err = float(((got[:, 0].double() - sums).abs() / mass).max())
        control = acc[:, 0].double().index_add(
            0, k64, vals[ok, 0].bfloat16().double())
        control_err = float(((control - sums).abs() / mass).max())
        if not (torch.equal(bits(got), bits(again))
                and torch.equal(got[:, 1].double(), counts)
                and err <= SUM_RTOL < control_err):
            raise AssertionError(
                f"cell fold {mix}: rel err {err} (bfloat16 control "
                f"{control_err}, tolerance {SUM_RTOL}), counts "
                f"{torch.equal(got[:, 1].double(), counts)}, two runs "
                f"{torch.equal(bits(got), bits(again))}")
        run = acc.clone()
        kern = lambda ks=keys: ops.onehot_fold(  # noqa: E731
            ks, vals, run, counts=True, inplace=True)
        by_tile = lambda ks=keys: onehot_fold_cuda(  # noqa: E731
            ks, vals, acc, tile, counts=True)
        tag = "" if mix == "uniform" else "hot_half_"
        row[f"{tag}rel_err"] = err
        row[f"{tag}bf16_control_rel_err"] = control_err
        row[f"{tag}graph_ms"] = graph_ms(kern, 20)
        row[f"{tag}tile_graph_ms"] = graph_ms(by_tile, 5)
        row[f"{tag}launches"] = launches
        row[f"{tag}counters"] = {
            name: rec.counters.get(name, 0)
            for name in ("fold_pairs", "fold_scans", "fold_partitioned")}
        if mix == "uniform":
            row["ms"] = row["kernel_ms"] = time_ms(kern, 20)
            row["tile_ms"] = time_ms(by_tile, 5)
            row["peak_bytes"] = peak_bytes(kern)
            row["tile_peak_bytes"] = peak_bytes(by_tile)
            # index_add_ takes no key outside [0, K): the kept pairs only
            ones = torch.cat([vals[ok], torch.ones_like(vals[ok])], 1)
            lib = lambda: acc.index_add(0, k64, ones)  # noqa: E731
            row["library_ms"] = time_ms(lib, 20)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = onehot_fold_plain(keys, vals, acc,
                                      block_k=CELL_PLAIN_KEY_BLOCK,
                                      counts=True)
            stop.record()
            torch.cuda.synchronize()
            row["plain_ms"] = start.elapsed_time(stop)
            row["max_abs_err"] = float((got - plain).abs().max())
            row["plain_rel_err"] = float(
                ((plain[:, 0].double() - sums).abs() / mass).max())
            if not (torch.equal(plain[:, 1], got[:, 1])
                    and row["plain_rel_err"] <= SUM_RTOL):
                raise AssertionError(f"cell fold: the plain version "
                                     f"misses float64: {row}")
            del plain
    nbytes = n * (4 + 4 * d) + 2 * k * width * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * width / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"cell fold (B1 at K={k}, n={n}, in place): route "
        f"{row['graph_ms']:.4f} ms (graph), tile route "
        f"{row['tile_graph_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, "
        f"half on one key {row['hot_half_graph_ms']:.4f} ms; rel err "
        f"{row['rel_err']:.3g} / {row['hot_half_rel_err']:.3g} (bfloat16 "
        f"control {row['bf16_control_rel_err']:.3g}); plain "
        f"{row['plain_ms']:.1f} ms; launches {row['launches']}")
    return [row]


# -- the exact integer keyed fold (int_fold) ---------------------------------

#: phase 4c: WordCount's zipf tokens and words, Histogram's pixels (3 pairs
#: each)
INT_WC_TOKENS = 1 << 24
INT_WC_VOCAB = 1 << 16
INT_HG_PIXELS = 1 << 22
#: int_fold's rows of the ``kernels`` line: (label, n, D, K, key mix); the
#: rows int64, as the stream flow hands them over (the premap widens the
#: map's int32 ones)
INT_FOLD_SHAPES = (("wordcount", 1 << 22, 1, INT_WC_VOCAB, "zipf"),
                   ("histogram", 1 << 22, 1, 768, "uniform"),
                   ("counts_k100", 1 << 22, 0, 100, "uniform"))


def int_fold_inputs(rng, n, d, k, dtype, mix, bad_keys=True):
    """(keys, rows, table, counts) on the card: [n] int32 keys by ``mix``
    (:data:`KEY_MIXES`, or ``zipf``: zipf 1.2 keys, hottest at the low ids;
    ``near_limits``: uniform keys with rows at the int32 limits, so per-key
    sums pass 2^31, or near ±2^63 for int64 rows, which wrap), sentinel and
    out-of-range keys mixed in (``bad_keys``); [n, D] rows of ``dtype``; a
    random [K, D] int64 table and [K] int32 counts."""
    import torch
    if mix == "zipf":
        keys = (rng.zipf(1.2, n) % k).astype(np.int32)
        if bad_keys:
            bad = rng.random(n) < 0.1
            keys[bad] = rng.choice(np.array([k, k + 3, -1, -7], np.int32),
                                   size=int(bad.sum()))
    else:
        keys = fold_keys(rng, n, k, "uniform" if mix == "near_limits"
                         else mix, bad_keys)
    if mix == "near_limits":
        info = np.iinfo(dtype)
        picks = np.array([info.max, info.max - 1, info.min, info.min + 1,
                          -1, 1], dtype)
        rows = rng.choice(picks[:2] if dtype == np.int32 else picks, (n, d))
    else:
        rows = rng.integers(-1000, 1000, (n, d)).astype(dtype)
    table = rng.integers(-2**40, 2**40, (k, d)).astype(np.int64)
    counts = rng.integers(0, 1000, k).astype(np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (keys, rows, table,
                                                      counts))


def check_int_fold(rng) -> None:
    """Phase 2, ``int_fold`` bit for bit against ``int_fold_plain`` on the
    same card tensors, the table and the counts, and two runs bit for bit:
    K = 1, 4, 100, 768, 2^16 and 2^20 (a table in shared memory, partly, or
    not at all); D = 0, 1, 3 and 6 (columns past the first, which the warp
    loads with its keys); int32 and
    int64 rows, values at the int32 limits (per-key sums past 2^31) and
    near ±2^63 (wrapping); sentinel and out-of-range keys, every key
    invalid; n = 0, 31, ragged and 2^22; one key holding almost every pair,
    zipf 1.2; without counts too."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.int_fold import int_fold_plain

    n = CUDA_CHUNK_PAIRS
    i32, i64 = np.int32, np.int64
    cases = [  # (n, D, K, row dtype, mix[, counts])
        (n, 1, INT_WC_VOCAB, i64, "zipf"),  # WordCount's chunk
        (n, 1, 768, i64, "uniform"),  # Histogram's
        (n, 0, 100, i32, "uniform"),  # the counts of K = 100
        (n, 1, INT_WC_VOCAB, i32, "zipf"),
        (n, 3, 100, i32, "zipf"),
        (n, 1, 1 << 20, i32, "uniform"),
        (n, 1, INT_WC_VOCAB, i32, "one_hot_key"),
        (n, 1, 768, i64, "one_hot_key"),
        (n, 0, 1 << 20, i32, "zipf"),
        (n, 1, 1, i32, "uniform"),
        (1_000_003, 1, 4, i32, "near_limits"),
        (1_000_003, 3, 100, i64, "near_limits"),
        (1_000_003, 3, INT_WC_VOCAB, i32, "near_limits"),
        (1_000_003, 6, 768, i64, "uniform"),
        (1_000_003, 6, INT_WC_VOCAB, i32, "zipf"),
        (1_000_003, 3, 4, i64, "uniform", False),
        (1_000_003, 1, INT_WC_VOCAB, i32, "zipf", False),
        (100_003, 1, 100, i32, "all_out"),
        (100_003, 0, INT_WC_VOCAB, i32, "all_out"),
        (31, 1, 100, i32, "uniform"),
        (31, 3, 1 << 20, i64, "uniform"),
        (31, 0, 1, i32, "uniform"),
        (0, 1, 100, i32, "uniform"),
        (0, 0, 4, i32, "uniform"),
    ]
    for m, d, k, dtype, mix, *how in cases:
        with_counts = how[0] if how else True
        keys, rows, table, counts = int_fold_inputs(rng, m, d, k, dtype, mix)
        args = (keys, rows, table) + ((counts,) if with_counts else ())
        kept = [t.clone() for t in args]
        got = [ops.int_fold(*args) for _ in range(2)]
        want = int_fold_plain(*args) if m else (
            (table, counts) if with_counts else table)
        torch.cuda.synchronize()
        if not with_counts:
            got, want = [(g,) for g in got], (want,)
        for a, b, w in zip(got[0], got[1], want):
            if not torch.equal(a, b):
                raise AssertionError(f"int_fold: two runs differ (n={m} "
                                     f"d={d} k={k} {mix})")
            if a.dtype != w.dtype or not torch.equal(a, w):
                diff = (a != w).sum().item()
                raise AssertionError(f"int_fold != plain (n={m} d={d} k={k} "
                                     f"{np.dtype(dtype).name} {mix}): {diff} "
                                     f"elements differ")
        if not all(torch.equal(x, y) for x, y in zip(args, kept)):
            raise AssertionError(f"int_fold wrote its inputs (n={m} d={d} "
                                 f"k={k})")
        if mix == "near_limits":  # the sums must leave the int32 range
            if not bool(((got[0][0] - table).abs() > 2**31).any()):
                raise AssertionError("int_fold near_limits: no sum past "
                                     "2^31")
        log(f"int_fold == plain bitwise: n={m} d={d} k={k} "
            f"{np.dtype(dtype).name} {mix} counts={with_counts}")


def main_path_int_fold() -> dict:
    """Phase 4c: ``MapReduce(WordCount(2^16)).run`` on 2^24 zipf tokens
    and ``MapReduce(Histogram()).run`` on 2^22 pixels (3 x 2^22 pairs) on
    the card.  The plan must be the stream flow with ``mode=additive`` (the
    reference's), no FALLBACK note and no ``LoweringFallbackWarning``;
    ``int_fold`` must have launched, once a chunk, and no other kernel;
    values and counts must equal ``np.bincount`` bit for bit.  Returns
    ``{label: (mr, items, launches)}``."""
    import warnings

    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.core.collector import LoweringFallbackWarning
    from repro_torch.data import datasets
    from repro_torch.kernels import ops

    toks, vocab = datasets.wordcount_data(
        np.random.default_rng(6), tokens=INT_WC_TOKENS, vocab=INT_WC_VOCAB)
    px = datasets.histogram_data(np.random.default_rng(8),
                                 pixels=INT_HG_PIXELS)
    runs = {"wordcount": (apps.WordCount(vocab), toks.reshape(-1, 16),
                          np.bincount(toks, minlength=vocab)),
            "histogram": (apps.Histogram(), px, np.bincount(
                (np.arange(3, dtype=np.int32) * 256 + px).ravel(),
                minlength=768))}
    out = {}
    for label, (app, host, want) in runs.items():
        items = torch.from_numpy(host).cuda()
        with warnings.catch_warnings():
            warnings.simplefilter("error", LoweringFallbackWarning)
            mr = MapReduce(app)
            text = mr.explain()
            if (mr.plan.flow, mr.tiling.mode) != ("stream", "additive") or (
                    "FALLBACK" in text):
                raise AssertionError(f"{label}: unexpected plan:\n{text}")
            mr.lower(items).compile()  # the warm-up's launches stay out
            ops.reset_launch_counts()
            res = mr.run(items)
            torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        chunks = -(-host.shape[0] // (mr.tiling.chunk_pairs
                                      // app.emit_capacity))
        if launches != {"int_fold": chunks}:
            raise AssertionError(f"{label}: launches {launches}, want "
                                 f"int_fold once a chunk ({chunks})")
        counts, values = res.counts.cpu().numpy(), res.values.cpu().numpy()
        if not (np.array_equal(counts, want) and np.array_equal(values,
                                                                want)):
            raise AssertionError(f"{label}: values or counts != np.bincount")
        log(f"main path int_fold: {label}, {host.shape[0]} items, "
            f"{mr.tiling.describe()}, values and counts == np.bincount "
            f"(max {want.max()} a key), launches {launches}")
        out[label] = (mr, items, launches)
    return out


def int_fold_rows(rng, launches: dict, ops_count) -> list[dict]:
    """Phase 8: ``int_fold`` at :data:`INT_FOLD_SHAPES`: kernel (CUDA
    events and a CUDA graph), plain and library times (``index_add_`` and
    ``bincount`` on the same inputs, the int64 index built beforehand), the
    byte bound (each key and row read once, the table and counts in and
    out) and the launches of the main path that hands it that shape
    (``launches``, by label); ``ops_count``: phase 2b's device operations."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.int_fold import int_fold_plain

    rows_out = []
    for label, n, d, k, mix in INT_FOLD_SHAPES:
        keys, rows, table, counts = int_fold_inputs(rng, n, d, k, np.int64,
                                                    mix, bad_keys=False)
        table.zero_()
        counts.zero_()
        keys64 = keys.long()
        kern = lambda: ops.int_fold(keys, rows, table, counts)  # noqa: E731
        plain = lambda: int_fold_plain(  # noqa: E731
            keys, rows, table, counts)

        def lib():
            out = counts + torch.bincount(keys64, minlength=k)
            return (table.index_add(0, keys64, rows), out) if d else out

        got, want = kern(), plain()
        err = max((a - b).abs().max().item() for a, b in zip(got, want)
                  if a.numel())
        nbytes = n * (4 + 8 * d) + 2 * k * (8 * d + 4)
        n_ops = n * (d + 1)  # an add a pair and column, and its count
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        ms = time_ms(kern, 20)
        rows_out.append({
            "name": "int_fold", "label": label, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int_fold.cu",
            "replaces": ("none (port only, no pallas_call): "
                         "src/repro/core/collector.py:634 "
                         "StreamCombiner._fold_additive, the XLA-fused "
                         "integer one-hot contraction"),
            "launches": launches[label], "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "graph_ms": graph_ms(kern, 20),
            "plain_ms": time_ms(plain, 5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib, 20),
            "device_ops": ops_count[f"int_fold/{label}"],
            "shape": {"n": n, "d": d, "k": k, "rows": "int64",
                      "counts": True, "keys": mix}})
        log(f"int_fold {label}: {ms:.4f} ms, graph "
            f"{rows_out[-1]['graph_ms']:.4f}, bound "
            f"{rows_out[-1]['bound_ms']:.4f}, plain "
            f"{rows_out[-1]['plain_ms']:.4f}, library "
            f"{rows_out[-1]['library_ms']:.4f}")
    return rows_out


# -- the combine and reduce flows ---------------------------------------------


def combine_pairs(rng, n, d, k, *, specials: bool, dtype=np.float32,
                  mix: str = "uniform", nan_share: float = 0.001):
    """Keys in [0, K) with sentinel (K) and out-of-range keys mixed in (by
    :data:`KEY_MIXES`); values (NaN payloads and signed zeros with
    ``specials``) of ``dtype``."""
    import torch
    keys = fold_keys(rng, n, k, mix)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    if specials:
        plant_specials(rng, vals, nan_share)
    vals = torch.from_numpy(vals).cuda()
    if dtype != np.float32:
        vals = vals.to(torch.bfloat16)
    return torch.from_numpy(keys).cuda(), vals


def check_combine_kernels(rng) -> None:
    """Phase 2, combine flow: onehot_combine and combine_scatter against
    their plain versions on the card (sums within 1e-5 of each key's sum of
    |v|, max/min bit for bit, two runs bit for bit)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.combine_scatter import combine_scatter_plain
    from repro_torch.kernels.onehot_combine import onehot_combine_plain

    def twice(fn, what):
        a, b = fn(), fn()
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: two runs differ")
        return a

    cases = [  # (n, d, k, label); N a multiple of no tile
        (N_POINTS, 3, 100, "main path (KMeans values)"),
        (N_POINTS, 1, 100, "main path (KMeans counts)"),
        (1_000_003, 9, 37, "ragged"),
        (5_001, 8, 2048, "the one-hot cutoff"),
        (777, 1, 1, "one key"),
        (3, 128, 100, "fewer pairs than a tile"),
        (100_003, 1, 1 << 16, "K = 2^16 (the additive fallback)"),
        (20_001, 128, 1 << 16, "K = 2^16, D = 128"),
        (1_000_003, 3, 100, "one key holds almost every pair",
         "one_hot_key"),
        (100_003, 3, 100, "every key out of range", "all_out"),
        (100_003, 1, ops.FOLD_TABLE_FLOATS + 1,
         "K one past a table (two key tiles)"),
        (1_000_003, 3, 1000, "K = 1000, one-warp blocks"),
    ] + [(n, 3, k, f"NaN payloads: one and two a key, K = {k}", "uniform",
          0.3) for n, k in ((501, 100), (5_001, 1000), (5_001, 2000))]
    for n, d, k, label, *how in cases:
        mix = how[0] if how else "uniform"
        nan_share = how[1] if len(how) > 1 else 0.001
        plain_block = min(k, ops.FOLD_PLAIN_KEY_BLOCK)
        for dtype in (np.float32, "bf16") if d == 3 else (np.float32,):
            keys, vals = combine_pairs(rng, n, d, k, specials=False,
                                       dtype=dtype, mix=mix)
            v32 = vals.float()
            plain = onehot_combine_plain(keys, v32, k, block_k=plain_block)
            tol = SUM_RTOL * onehot_combine_plain(
                keys, v32.abs(), k, block_k=plain_block) + SUM_RTOL
            for name, fn in (
                    ("onehot_combine",
                     lambda: ops.onehot_combine(keys, vals, k)),
                    ("combine_scatter",
                     lambda: ops.combine_scatter(keys, vals, k, "add"))):
                err = (twice(fn, f"{name} add ({label})") - plain).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(
                        f"{name} add != plain ({label}, {dtype}): max abs "
                        f"err {err.max().item()}")
        for op in ("max", "min"):
            keys, vals = combine_pairs(rng, n, d, k, specials=True, mix=mix,
                                       nan_share=nan_share)
            got = twice(lambda: ops.combine_scatter(keys, vals, k, op),
                        f"combine_scatter {op} ({label})")
            want = combine_scatter_plain(keys, vals, k, op)
            if not torch.equal(bits(got), bits(want)):
                diff = (bits(got) != bits(want)).sum().item()
                raise AssertionError(
                    f"combine_scatter {op} != plain bitwise ({label}): "
                    f"{diff} elements differ")
        log(f"onehot_combine, combine_scatter == plain: {label} n={n} d={d} "
            f"k={k} plan={ops.fold_plan(n, k, d, 'add')}")


def main_path_combine(pts, assign, items):
    """Phase 6: under ``flow="combine"`` on the 2^24 points, KMeans (the
    one-hot lowering), BoundingBox (the scatter lowering, whose max and min
    leaves take the sort route) and KMeans with ``combine_impl="scatter"``
    (its add leaf below 256 keys: combine_scatter)."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.core import collector as col
    from repro_torch.kernels import ops

    runs = {}
    for label, app, forced, impl, want in (
            ("kmeans", apps.KMeans(), "auto", "onehot",
             {"onehot_combine": 2}),  # the values and the counts
            ("bounding_box", apps.BoundingBox(), "auto", "scatter",
             {"radix_partition": 2, "segment_reduce": 2,  # max, min
              "int_fold": 1}),  # the counts
            ("kmeans_scatter", apps.KMeans(), "scatter", "scatter",
             {"combine_scatter": 1, "int_fold": 1})):  # values; counts
        mr = MapReduce(app, flow="combine", combine_impl=forced)
        chosen = forced
        if forced == "auto":
            chosen, _ = col.choose_combine_impl(
                mr.plan.spec, app.key_space, len(assign), onehot_kernel=True)
        if mr.plan.flow != "combine" or chosen != impl or not mr.use_kernels:
            raise AssertionError(f"unexpected plan ({chosen}):\n"
                                 f"{mr.explain()}")
        mr.lower(items).compile()  # staged first (the warm-up's launches)
        with fold_shapes() as seen:
            ops.reset_launch_counts()
            res = mr.run(items)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        if launches != {name: want.get(name, 0) for name in launches}:
            raise AssertionError(f"{label} combine: expected {want}, got "
                                 f"{launches}")
        lane_launches(seen, launches, set(want) & {"onehot_combine",
                                                   "combine_scatter"})
        counts = res.counts.cpu().numpy()
        if not np.array_equal(counts, np.bincount(assign, minlength=100)):
            raise AssertionError(f"{label} combine: counts != np.bincount")
        got = res.values.cpu().numpy()
        if label != "bounding_box":
            np.testing.assert_allclose(got, kmeans_centroids(pts, assign)[1],
                                       rtol=SUM_RTOL, atol=SUM_RTOL)
        elif not np.array_equal(got.view(np.uint32),
                                numpy_boxes(pts, assign).view(np.uint32)):
            raise AssertionError("combine: bounding boxes != numpy max/min")
        log(mr.explain())
        log(f"main path combine: {label} impl={impl}, counts exact, "
            f"launches {launches}, plans {seen}")
        runs[label] = (mr, launches)
    return runs


def main_path_reduce(pts, assign, items):
    """Phase 7: KMeans under ``flow="reduce"`` (no kernel: the reference
    has none), Lmax set to the largest count so no value is cut off."""
    import torch
    from repro_torch import MapReduce, apps

    app = apps.KMeans()
    app.max_values_per_key = int(np.bincount(assign).max())
    mr = MapReduce(app, flow="reduce")
    if mr.plan.flow != "reduce" or mr.plan.optimized:
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    res = mr.run(items)
    torch.cuda.synchronize()
    want_counts, want = kmeans_centroids(pts, assign)
    if not np.array_equal(res.counts.cpu().numpy(), want_counts):
        raise AssertionError("KMeans reduce: counts != np.bincount")
    got = res.values.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_RTOL)
    log(mr.explain())
    log(f"main path reduce: KMeans Lmax={app.max_values_per_key}, counts "
        f"exact, centroids max abs err {np.abs(got - want).max():.3g}")
    return mr


def combine_kernel_rows(rng, launches, ops_count) -> list[dict]:
    """Phase 8, combine flow: B6 and B7 at the combine main path's shapes
    (2^24 pairs, D = 3, K = 100), and B7's additive fallback at K = 2^16;
    ``ops_count``: the device operations of phase 2b."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.combine_scatter import combine_scatter_plain
    from repro_torch.kernels.onehot_combine import onehot_combine_plain

    n, d, k = N_POINTS, 3, 100
    keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda")
    vals = torch.randn((n, d), device="cuda")
    keys64 = keys.long()
    hot = torch.from_numpy(fold_keys(rng, n, k, "half_hot_key",
                                     bad_keys=False)).cuda()
    nbytes = n * (4 + 4 * d) + k * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * d / F32_OPS_PER_S * 1e3
    src = "src/repro_torch/kernels/csrc/"
    rows = []
    for name, op, kern, plain, lib, replaces in (
            ("onehot_combine", "add",
             lambda ks=keys: ops.onehot_combine(ks, vals, k),
             lambda: onehot_combine_plain(keys, vals, k),
             lambda: torch.zeros((k, d), device="cuda").index_add_(
                 0, keys64, vals),
             "src/repro/kernels/onehot_combine.py:123"),
            ("combine_scatter", "add",
             lambda ks=keys: ops.combine_scatter(ks, vals, k, "add"),
             lambda: combine_scatter_plain(keys, vals, k, "add"),
             lambda: torch.zeros((k, d), device="cuda").index_add_(
                 0, keys64, vals),
             "src/repro/kernels/combine_scatter.py:52")):
        # the graphs first, as in kernel_rows
        kern_graph_ms = graph_ms(kern, 10)
        hot_ms = graph_ms(lambda: kern(hot), 10)  # one key: half the pairs
        err = (kern() - plain()).abs().max().item()
        ms = time_ms(kern, 10)
        rows.append({
            "name": name, "route": "cuda", "source": src + name + ".cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": time_ms(plain, 3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib, 10),
            "graph_ms": kern_graph_ms, "library_graph_ms": graph_ms(lib, 10),
            "device_ops": ops_count[name],
            "plan": ops.fold_plan(n, k, d, op).shape,
            "hot_half_graph_ms": hot_ms,
            "shape": {"n": n, "d": d, "k": k, "op": op},
        })
    # B7 on the scatter lowering at K = 2^16, two key tiles (the combine
    # flow takes the sort route there; see combine_route_sweep)
    n2, k2 = 1 << 22, 1 << 16
    keys = torch.randint(0, k2, (n2,), dtype=torch.int32, device="cuda")
    vals = torch.randn((n2, 1), device="cuda")
    rows[-1]["k65536_add"] = {
        "n": n2, "d": 1, "k": k2,
        "ms": time_ms(lambda: ops.combine_scatter(keys, vals, k2, "add"), 10),
        "bound_ms": (n2 * 8 + k2 * 4) / HBM_BYTES_PER_S * 1e3,
        "library_ms": time_ms(lambda: torch.zeros(
            (k2, 1), device="cuda").index_add_(0, keys.long(), vals), 3)}
    return rows


#: key spaces of the scatter lowering's route sweep, 2^22 pairs each
ROUTE_SWEEP_KEYS = (1 << 6, 1 << 7, 1 << 8, 1 << 10, 1 << 11, 1 << 12,
                    1 << 13, 1 << 14, 1 << 16)


def combine_route_sweep(rng) -> dict:
    """The combine flow's scatter lowering on f32 leaves: combine_scatter
    (B7) against sort_segment_fold (B3/B4 + B5, from the identity table) at
    2^22 pairs, D = 1 and 3, uniform keys and one key holding half the
    pairs, over :data:`ROUTE_SWEEP_KEYS`, add and max, with sentinel and
    out-of-range keys; the tables must agree (max bit for bit, sums within
    1e-5 of each key's sum of |v|).  The crossover sets
    ``collector.SCATTER_SORT_MIN_KEYS``."""
    import torch
    from repro_torch.kernels import ops

    n = 1 << 22
    out = {"n": n, "rows": []}
    for d in (1, 3):
        for mix in ("uniform", "half_hot_key"):
            for k in ROUTE_SWEEP_KEYS:
                keys, vals = combine_pairs(rng, n, d, k, specials=False,
                                           mix=mix)
                row = {"k": k, "d": d, "keys": mix}
                for op, ident in (("add", 0.0), ("max", float("-inf"))):
                    acc = torch.full((k, d), ident, device="cuda")
                    b7 = lambda: ops.combine_scatter(  # noqa: E731
                        keys, vals, k, op)
                    srt = lambda: ops.sort_segment_fold(  # noqa: E731
                        keys, vals, acc, op)
                    got, want = srt(), b7()
                    what = f"route sweep K={k} D={d} {mix}"
                    if op == "max":
                        if not torch.equal(bits(got), bits(want)):
                            raise AssertionError(f"{what}: sort max != "
                                                 f"combine_scatter max")
                    else:
                        ok = (keys >= 0) & (keys < k)
                        tol = SUM_RTOL * torch.zeros(
                            (k, d), dtype=torch.float64,
                            device="cuda").index_add_(
                            0, keys[ok].long(),
                            vals[ok].abs().double()) + SUM_RTOL
                        if not bool(((got - want).abs() <= tol).all()):
                            raise AssertionError(f"{what}: sort add != "
                                                 f"combine_scatter add")
                    row[f"{op}_combine_scatter_ms"] = time_ms(b7, 10)
                    row[f"{op}_sort_segment_fold_ms"] = time_ms(srt, 10)
                row["add_plan"] = ops.fold_plan(n, k, d, "add").shape
                out["rows"].append(row)
    return out


#: key spaces and widths of the keyed-fold sweep, 2^22 pairs each
FOLD_SWEEP_KEYS = (16, 64, 100, 128, 256, 512, 1024)
FOLD_SWEEP_COLS = (1, 3, 4)


def keyed_fold_sweep(rng) -> dict:
    """B1 onto acc over 2^22 pairs of uniform keys, at
    :data:`FOLD_SWEEP_KEYS` x :data:`FOLD_SWEEP_COLS`: the lane-table pass
    (``ops.lane_plan``, whatever warps an SM it leaves) against the
    index-order pass (``ops.table_plan``), each from a CUDA graph, and the
    shape ``ops.fold_plan`` takes; the two sums must agree within SUM_RTOL
    of each key's sum of |terms|.  The measurement behind the plan's
    crossover (``ops.FOLD_LANE_MAX_KEYS``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_cuda

    n = 1 << 22
    out = {"n": n, "rows": []}
    for d in FOLD_SWEEP_COLS:
        for k in FOLD_SWEEP_KEYS:
            keys, vals, acc = fold_inputs(rng, n, d, k, specials=False,
                                          bad_keys=False)
            lane, table = ops.lane_plan(n, k, d), ops.table_plan(n, k, d)
            by_lane = lambda: onehot_fold_cuda(  # noqa: E731
                keys, vals, acc, lane)
            by_table = lambda: onehot_fold_cuda(  # noqa: E731
                keys, vals, acc, table)
            tol = SUM_RTOL * (torch.zeros(
                (k, d), dtype=torch.float64, device="cuda").index_add_(
                0, keys.long(), vals.abs().double()) + acc.abs()) + SUM_RTOL
            if not bool(((by_lane() - by_table()).abs() <= tol).all()):
                raise AssertionError(f"keyed fold sweep K={k} D={d}: the "
                                     f"two passes' sums differ")
            out["rows"].append({
                "k": k, "d": d, "lane_graph_ms": graph_ms(by_lane, 20),
                "table_graph_ms": graph_ms(by_table, 20),
                "lane_cols": lane.cols,
                "lane_warps_per_sm": lane.per_sm * lane.warps,
                "table_shape": table.shape,
                "plan": ops.fold_plan(n, k, d, "add").shape})
    return out


def scatter_routes(mr, items) -> dict:
    """A combine run of the scatter lowering with every f32 leaf on
    combine_scatter and then on the sort route (the key-count switch set
    past K, then to 1): wall ms and the lowering each took; the tables must
    agree (max/min bit for bit, sums within SUM_RTOL)."""
    import torch
    from repro_torch.core import collector as col

    saved = col.SCATTER_SORT_MIN_KEYS
    out, tabs = {"k": mr.app.key_space}, []
    for label, min_keys in (("combine_scatter", mr.app.key_space + 1),
                            ("sort_route", 1)):
        col.SCATTER_SORT_MIN_KEYS = dict.fromkeys(saved, min_keys)
        try:
            tabs.append(mr.run(items).values)
            out[f"{label}_ms"] = run_ms(mr, items)
            out[f"{label}_lowering"] = mr.plan.lowering
        finally:
            col.SCATTER_SORT_MIN_KEYS = saved
    if not (torch.equal(bits(tabs[0]), bits(tabs[1])) or torch.allclose(
            tabs[0], tabs[1], rtol=SUM_RTOL, atol=SUM_RTOL)):
        raise AssertionError("scatter routes: the two routes' tables differ")
    mr.run(items)  # leave the plan's lowering line as routed
    return out


# -- decode attention and the serve path -------------------------------------

#: (B, H, Hkv, D, S): the reference kernel test's shapes
#: (tests/kernels/test_kernels.py:73-76), the bench shape
#: (benchmarks/bench_integrations.py:67-73) and llama3-8b's decode shape
#: (batch 4, a 2048-token prompt and 32 new tokens)
FD_TEST_SHAPES = ((2, 8, 2, 64, 300), (1, 4, 4, 32, 128),
                  (3, 16, 4, 128, 1000), (1, 8, 1, 64, 256))
FD_BENCH_SHAPE = (1, 8, 2, 64, 8192)
FD_LLAMA_SHAPE = (4, 32, 8, 128, 2080)
#: phase 15's decode shapes (batch 4, a 2048-token prompt, 32 new tokens):
#: qwen3-moe-30b-a3b at G = H / Hkv = 8 (a full head block of 8),
#: llama4-scout-17b-a16e at G = 5 and internvl2-26b at G = 6 (256 patches
#: in front of the prompt), whose head blocks of 8 leave 3 and 2 heads empty
FD_SLICE_SHAPES = {"qwen3-moe-30b-a3b": (4, 32, 4, 128, 2080),
                   "llama4-scout-17b-a16e": (4, 40, 8, 128, 2080),
                   "internvl2-26b": (4, 48, 8, 128, 2336)}
#: phase 16's decode shapes, all at G = 1 (H = Hkv), D = 64, whose head
#: blocks of 4 leave 3 heads empty: zamba2-1.2b's shared attention (a
#: 2048-token prompt, 32 new tokens), whisper-medium's self-attention (a
#: BOS prompt and 32 new tokens: 33 positions) and its cross-attention over
#: the 1500 encoder positions of a 30-s window
FD_PHASE16_SHAPES = {"zamba2-1.2b": (4, 32, 32, 64, 2080),
                     "whisper-medium/self": (4, 16, 16, 64, 33),
                     "whisper-medium/cross": (4, 16, 16, 64, 1500)}
#: flash_decode against its plain version on the card (rtol = atol), f32
#: and bf16 alike: both read the same inputs, widen them to f32 and fold in
#: f32, and differ only in the order of the sums (the reference kernel
#: test's 2e-4 / 2e-2 hold the port against the JAX package on the CPU)
FD_TOL = 1e-5
#: the first tile of positions a planted fault leaves out
FD_FAULT_TILE = 64


def fd_faults():
    """Planted faults of the decode attention, each a wrapper of the kernel
    ``fd(q, k, v, kv_len, **kw)``: the newest position left out (kv_len =
    pos), every query head on KV head 0, and the first 64-position tile left
    out (half the positions of a cache shorter than two tiles: whisper's
    self cache holds 33).  The phase-2 check and the serve gate must tell
    each from the kernel."""

    def first_kv_head(x):
        return x[:, :, :1].expand_as(x).contiguous()

    def first_tile_dropped(fd, q, k, v, n, **kw):
        t = min(FD_FAULT_TILE, k.shape[1] // 2)
        return fd(q, k[:, t:].contiguous(), v[:, t:].contiguous(),
                  (n - t).clamp(min=0), **kw)

    return {
        "kv_len_minus_1": lambda fd, q, k, v, n, **kw: fd(q, k, v, n - 1,
                                                         **kw),
        "one_kv_head": lambda fd, q, k, v, n, **kw: fd(
            q, first_kv_head(k), first_kv_head(v), n, **kw),
        "first_tile_dropped": first_tile_dropped,
    }


def decode_inputs(rng, b, h, hkv, d, s, dtype, kv_len):
    """q, k, v on the card as the reference kernel test makes them (k scaled
    by 0.3), in ``dtype``, and ``kv_len`` as int32."""
    import torch
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (*(torch.from_numpy(a).cuda().to(dt) for a in (q, k, v)),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


def fd_kv_lens(b: int, s: int) -> list[list[int]]:
    """Ragged kv_len rows for a batch of ``b`` over ``s`` positions: 0
    (zeros out), 1, S and two lengths that are no multiple of a tile,
    rotated so that every length appears in some row of some run."""
    lens = [0, 1, s, max(1, s - 37), max(1, s // 3 + 5)]
    return [[lens[(i + off) % len(lens)] for i in range(b)]
            for off in range(0, len(lens), b)]


def check_flash_decode(rng) -> None:
    """Phase 2, decode attention: flash_decode against its plain version on
    the card, f32 and bf16, at the reference test's, the bench, the
    llama3-8b, phase 15's and phase 16's decode shapes, with ragged
    ``kv_len`` (0, which gives zeros, 1, S and lengths that are no
    multiple of a tile), within FD_TOL, and two runs bit for bit; each
    planted fault of :func:`fd_faults` at the llama shape and at phase 15's
    and 16's must miss FD_TOL."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode_plain

    def agree(got, want):
        err = (got - want).abs()
        return bool((err <= FD_TOL + FD_TOL * want.abs()).all()), float(
            err.max())

    for shape in FD_TEST_SHAPES + (FD_BENCH_SHAPE, FD_LLAMA_SHAPE,
                                   *FD_SLICE_SHAPES.values(),
                                   *FD_PHASE16_SHAPES.values()):
        b, h, hkv, d, s = shape
        runs = fd_kv_lens(b, s)
        for kv_len in runs:
            for dtype in ("f32", "bf16"):
                q, k, v, kvl = decode_inputs(rng, *shape, dtype, kv_len)
                got = ops.flash_decode(q, k, v, kvl)
                again = ops.flash_decode(q, k, v, kvl)
                if not torch.equal(bits(got), bits(again)):
                    raise AssertionError(f"flash_decode {shape} {dtype}: two "
                                         f"runs differ")
                ok, err = agree(got, flash_decode_plain(q, k, v, kvl))
                if not ok:
                    raise AssertionError(
                        f"flash_decode {shape} {dtype} != plain: max abs err "
                        f"{err} (kv_len {kv_len})")
                zero = [i for i, n in enumerate(kv_len) if n == 0]
                if zero and bool(got[zero].abs().max() != 0):
                    raise AssertionError("flash_decode: kv_len = 0 must give "
                                         "0")
        log(f"flash_decode == plain within {FD_TOL}: B,H,Hkv,D,S={shape} "
            f"kv_len={runs} f32 and bf16")
    for tile_s in (64, 128, 8192):  # other splits, the same function
        q, k, v, kvl = decode_inputs(rng, *FD_BENCH_SHAPE, "f32", [5000])
        ok, err = agree(ops.flash_decode(q, k, v, kvl, tile_s=tile_s),
                        flash_decode_plain(q, k, v, kvl))
        if not ok:
            raise AssertionError(f"flash_decode tile_s={tile_s}: max abs err "
                                 f"{err}")
    log(f"flash_decode == plain within {FD_TOL} at tile_s 64, 128 and 8192")
    for shape in (FD_LLAMA_SHAPE, *FD_SLICE_SHAPES.values(),
                  *FD_PHASE16_SHAPES.values()):
        b, _, _, _, s = shape
        q, k, v, kvl = decode_inputs(rng, *shape, "bf16", [s - 32] * b)
        want = flash_decode_plain(q, k, v, kvl)
        seen = {}
        for name, fault in fd_faults().items():
            ok, seen[name] = agree(fault(ops.flash_decode, q, k, v, kvl),
                                   want)
            if ok:
                raise AssertionError(
                    f"flash_decode check blind to the planted fault {name} "
                    f"at {shape}: max abs err {seen[name]}")
        log(f"flash_decode check catches each planted fault at "
            f"B,H,Hkv,D,S={shape} (bf16, kv_len {s - 32}): max abs err "
            f"{seen}")


#: the serve main path: llama3-8b at full width and depth, bf16; its
#: numbers are those of the median of SERVE_TIMED_RUNS timed generations
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_TIMED_RUNS = 3
#: the kernel decode against the plain one on the card, teacher-forced with
#: the kernel run's tokens, per step: rms(Δ) <= SERVE_RMS_TOL rms(logits)
#: and max|Δ| <= SERVE_MAX_TOL max|logits|.  The two differ only in where
#: they round: the plain path rounds the attention weights to bf16 before
#: the value product, flash_decode keeps them and its output in f32 (ROADMAP
#: C.22), and each difference of one ulp passes through up to 32 layers and
#: into the K/V the later steps read.  Readings on an NVIDIA H100 80GB HBM3
#: at 700.00 W (rms, max): the sound kernel 0.0204, 0.0230; the planted
#: faults of fd_faults() 0.0427, 0.0536 (the newest position left out),
#: 0.236, 0.289 (the first tile) and 1.36, 1.58 (one KV head).  Each limit
#: lies between the sound reading and the nearest fault's, 1.4-1.5x from
#: the sound one, and the run fails unless every fault is caught.
SERVE_RMS_TOL, SERVE_MAX_TOL = 2.0 ** -5, 2.0 ** -5


#: whisper's frames a request: the encoder length of a 30-s window after
#: the stub frontend (the conv frontend halves 3000 mel frames)
WHISPER_FRAMES = 1500


def serve_setup(cfg, seed: int = 0):
    """(model, params, prompts, extra): ``cfg`` with random weights from a
    seeded generator on the card, random prompts [SERVE_BATCH,
    SERVE_PROMPT] (whisper: one BOS token a row) and the stub frontends'
    outputs in the model dtype: for vlm random patch embeddings, for
    whisper WHISPER_FRAMES random frame embeddings (``extra`` is None
    otherwise)."""
    import torch
    from repro_torch.models.registry import get_model

    model = get_model(cfg)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(seed))
    audio = cfg.family == "audio"
    prompts = torch.randint(
        0, cfg.vocab_size, (SERVE_BATCH, 1 if audio else SERVE_PROMPT),
        dtype=torch.int32, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    stub = torch.Generator(device="cuda").manual_seed(seed + 3)
    extra = None
    if cfg.family == "vlm":
        extra = {"patches": torch.randn(
            (SERVE_BATCH, cfg.num_patches, cfg.d_model), device="cuda",
            generator=stub).to(cfg.dtype)}
    elif audio:
        extra = {"frames": torch.randn(
            (SERVE_BATCH, WHISPER_FRAMES, cfg.d_model), device="cuda",
            generator=stub).to(cfg.dtype)}
    return model, params, prompts, extra


def patch_len(extra) -> int:
    """Cache positions the stub frontend's output takes in front of the
    prompt (vlm patches; whisper's frames take none)."""
    return extra["patches"].shape[1] if extra and "patches" in extra else 0


def fd_calls(cfg) -> tuple[int, int]:
    """flash_decode calls (a decode step, the prefill) of ``cfg``'s serve
    path: one a layer for the transformer, one a call site of the shared
    block for the hybrid, two a decoder layer for whisper (self and cross),
    whose prefill decodes the BOS token, none for mamba2."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every, 0
    if cfg.family == "audio":
        return 2 * cfg.num_layers, 2 * cfg.num_layers
    return cfg.num_layers, 0


def teacher_forced(model, params, prompts, tokens, use_kernels, extra=None):
    """Per-step logits [B, n, V] of prefill and of decode steps fed
    ``tokens[:, :n - 1]`` (n = tokens' length), as generate computes them
    (``extra``: generate's ``extra_batch``)."""
    import torch
    b, s = prompts.shape
    n = tokens.shape[1]
    # whisper's prefill decodes the BOS token: its attention takes the
    # kernel or not as the steps' does
    kw = {"use_kernels": use_kernels} if model.cfg.family == "audio" else {}
    with torch.inference_mode():
        st = model.init_decode_state(b, s + n + patch_len(extra),
                                     device=prompts.device)
        lg, st = model.prefill(params, {"tokens": prompts, **(extra or {})},
                               st, **kw)
        out = [lg]
        for i in range(n - 1):
            lg, st = model.decode_step(params, st, tokens[:, i],
                                       use_kernels=use_kernels)
            out.append(lg)
        return torch.stack(out, dim=1)


@contextlib.contextmanager
def routing_recorded():
    """Records every MoE routing while open: a list with one entry a
    ``moe._route`` call, its top-k expert ids ([..., K], in top-k
    order)."""
    from repro_torch.models import moe

    real, seen = moe._route, []

    def route(p, tokens, k):
        out = real(p, tokens, k)
        seen.append(out[2])
        return out

    moe._route = route
    try:
        yield seen
    finally:
        moe._route = real


@contextlib.contextmanager
def routing_replayed(records):
    """Replays recorded routings (:func:`routing_recorded`): the n-th
    ``moe._route`` call while open takes the n-th record's expert ids and
    this run's probabilities at them (renormalized, as ``_route`` does), so
    two runs whose hidden states differ by rounding route alike.  Yields a
    list that receives, a call, which tokens' own top-k set differed from
    the record's (a flip the run would have taken)."""
    import torch
    from repro_torch.models import moe

    real, flips, it = moe._route, [], iter(records)

    def route(p, tokens, k):
        probs, _, own = real(p, tokens, k)
        idx = next(it)
        flips.append((torch.sort(own, dim=-1).values
                      != torch.sort(idx, dim=-1).values).any(-1))
        gates = torch.gather(probs, -1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return probs, gates, idx

    moe._route = route
    try:
        yield flips
    finally:
        moe._route = real


@contextlib.contextmanager
def decode_attention_held(fault=None):
    """While open, ``ops.flash_decode`` as the decode calls it (with the
    planted ``fault`` of :func:`fd_faults`, if given), each call's output
    held against ``flash_decode_plain`` on the call's own inputs.  Yields a
    list that receives, a call, [max(|Δ| - FD_TOL (1 + |want|)), max|Δ|] on
    the card and the call's KV positions (:func:`held_summary` reads
    it)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode_plain

    real, seen = ops.flash_decode, []

    def fd(q, k, v, n, **kw):
        out = (fault(real, q, k, v, n, **kw) if fault
               else real(q, k, v, n, **kw))
        want = flash_decode_plain(q, k, v, n)
        err = (out - want).abs()
        seen.append((torch.stack([(err - FD_TOL * (1 + want.abs())).amax(),
                                  err.amax()]), k.shape[1]))
        return out

    ops.flash_decode = fd
    try:
        yield seen
    finally:
        ops.flash_decode = real


@contextlib.contextmanager
def decode_attention_plain():
    """While open, ``ops.flash_decode`` is the kernel's plain version
    (``flash_decode_plain``: the same function, f32 weights, unfused), so a
    decode run computes what the kernel decode computes, up to the order
    of the f32 sums."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode_plain

    real = ops.flash_decode
    ops.flash_decode = lambda q, k, v, n, **kw: flash_decode_plain(q, k, v,
                                                                   n)
    try:
        yield
    finally:
        ops.flash_decode = real


def held_summary(seen) -> dict:
    """The calls of :func:`decode_attention_held`, the largest error,
    whether any call missed FD_TOL, and the calls by KV positions."""
    import collections

    import torch
    excess, err = torch.stack([e for e, _ in seen]).amax(0).tolist()
    return {"calls": len(seen), "max_abs_err": err, "past_tol": excess > 0,
            "calls_by_kv_positions": {
                str(s): n for s, n in sorted(collections.Counter(
                    s for _, s in seen).items())}}


def decode_gap(lk, lp) -> dict:
    """The serve gate's readings of logits ``lk`` against the plain decode's
    ``lp`` ([B, n, V]): per step rms(Δ)/rms(lp) and max|Δ|/max|lp|, each
    at its worst step, and the share of greedy tokens that agree."""
    diff = (lk - lp).float()
    lpf = lp.float()
    rms_rel = diff.pow(2).mean((0, 2)).sqrt() / lpf.pow(2).mean((0, 2)).sqrt()
    max_rel = diff.abs().amax((0, 2)) / lpf.abs().amax((0, 2))
    return {"rms_rel_max": float(rms_rel.max()),
            "max_rel_max": float(max_rel.max()),
            "greedy_agreement": float(
                (lk.argmax(-1) == lp.argmax(-1)).float().mean())}


def within_gate(gap: dict, tol=None) -> bool:
    """``gap``'s readings within ``tol`` (rms, max; by default
    SERVE_RMS_TOL, SERVE_MAX_TOL)."""
    rms, mx = tol or (SERVE_RMS_TOL, SERVE_MAX_TOL)
    return gap["rms_rel_max"] <= rms and gap["max_rel_max"] <= mx


def serve_run(model, params, prompts, extra=None, *, gates=None,
              fault_gates=()) -> dict:
    """``serving.serve_step.generate`` on ``model``: batch SERVE_BATCH, the
    prompts, SERVE_NEW new greedy tokens (``extra``: its extra_batch).
    flash_decode must launch layers x (SERVE_NEW - 1) times and no other
    kernel; a second run gives the same tokens; the teacher-forced logits
    with the kernels equal generate's tokens under argmax and repeat bit
    for bit, and in the repeat every flash_decode call agrees with its
    plain version on its own inputs within FD_TOL
    (:func:`decode_attention_held`); each planted fault of
    :func:`fd_faults`, run through the same decode, must miss FD_TOL in
    some call.  Two logits comparisons, each read against SERVE_*_TOL:
    ``plain``, the model's plain decode (its attention rounds the weights
    to the model dtype, C.22), and ``kernel_plain``, the decode with the
    kernel's plain version in its place (:func:`decode_attention_plain`).
    ``gates`` maps each comparison that is gated to its (rms, max) tols
    (by default ``kernel_plain`` at SERVE_*_TOL; ``{}``: both read, not
    gated, as zamba2 in bf16, ROADMAP C.69): the kernel decode must agree
    with each within its gate.  Every planted fault must fall outside the
    gates of ``fault_gates`` (phase 8: ``plain``; at 48 layers the C.22
    rounding alone reaches the gate, and a fault whose effect is below the
    gate's size cannot miss it: ROADMAP C.62).  MoE: the
    compared and the faulty decodes route as the kernel decode did
    (:func:`routing_replayed`), so a top-k near a tie that rounding tips
    the other way (a routing flip, which moves the logits for reasons
    that are not the attention's) does not enter the comparison; the
    flips the plain decode would have taken are counted by (row, layer,
    step) and printed.  flash_decode's calls a step and in prefill are
    :func:`fd_calls`'s (whisper: also the BOS step its prefill decodes,
    so its prefill logits are compared, not required equal); a model with
    no kernel on its path (mamba2) gets the launch, repeat and token
    checks and its timings only.  The launches of the ``generate`` run
    are also read by KV positions (whisper: self- and cross-attention),
    and the held decode's calls must split the same way."""
    import functools
    import statistics

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import param_count
    from repro_torch.serving.serve_step import generate

    cfg = model.cfg
    if gates is None:
        gates = {"kernel_plain": (SERVE_RMS_TOL, SERVE_MAX_TOL)}
    if not set(fault_gates) <= set(gates):
        raise ValueError(f"fault gates {fault_gates} not among {gates}")
    log(f"serve: {cfg.name} {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, experts "
        f"{cfg.num_experts} top-{cfg.num_experts_per_tok}, "
        f"extra {({k: tuple(v.shape) for k, v in (extra or {}).items()})}, "
        f"{cfg.dtype}; {param_count(params)} parameters; batch "
        f"{SERVE_BATCH}, prompt {prompts.shape[1]}, {SERVE_NEW} new tokens")
    ops.reset_launch_counts()
    toks = generate(model, params, prompts, max_new=SERVE_NEW,
                    extra_batch=extra)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    by_kv = {str(s): n for s, n in ops.launch_counts_by_key(
        "flash_decode").items()}
    want = {name: 0 for name in launches}
    per_step, in_prefill = fd_calls(cfg)
    want["flash_decode"] = per_step * (SERVE_NEW - 1) + in_prefill
    if launches != want:
        raise AssertionError(f"serve {cfg.name}: launches {launches}, want "
                             f"{want}")
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or int(toks.min()) < 0 or int(
            toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"serve {cfg.name}: bad tokens {toks.shape}")
    timed = []  # the decode loop is host-bound: its time varies by run
    for _ in range(SERVE_TIMED_RUNS):
        stats = {}
        again = generate(model, params, prompts, max_new=SERVE_NEW,
                         stats=stats, extra_batch=extra)
        if not torch.equal(toks, again):
            raise AssertionError(f"serve {cfg.name}: a second run gave "
                                 f"other tokens")
        timed.append(stats)
    timed.sort(key=lambda st: st["decode_ms"])
    stats = timed[len(timed) // 2]
    steps = stats["decode_steps"]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "params": param_count(params),
           "prefill_ms": stats["prefill_ms"],
           "decode_ms_per_token": stats["decode_ms"] / steps,
           "decode_window_ms": stats["decode_ms"], "decode_steps": steps,
           "tokens_per_s": SERVE_BATCH * steps * 1e3 / stats["decode_ms"],
           "decode_step_ms_median": statistics.median(
               stats["decode_step_ms"]),
           "decode_ms_per_token_runs": [st["decode_ms"] / steps
                                        for st in timed],
           "prefill_ms_runs": [st["prefill_ms"] for st in timed],
           "decode_step_ms": stats["decode_step_ms"],
           "batch": SERVE_BATCH, "prompt": prompts.shape[1],
           "new": SERVE_NEW, "patches": patch_len(extra),
           "frames": extra["frames"].shape[1] if extra and "frames" in extra
           else 0, "launches": launches["flash_decode"],
           "launches_by_kv_positions": by_kv}
    forced = functools.partial(teacher_forced, model, params, prompts, toks,
                               extra=extra)
    with routing_recorded() as routes:
        lk = forced(True)
    with decode_attention_held() as seen:
        again = forced(True)
    held = held_summary(seen) if seen else {"calls": 0, "past_tol": False}
    del seen
    if not torch.equal(bits(lk), bits(again)):
        raise AssertionError(f"serve {cfg.name}: two kernel runs' logits "
                             f"differ")
    if held["past_tol"] or held["calls"] != want["flash_decode"] or (
            held["calls"] and held["calls_by_kv_positions"] != by_kv):
        raise AssertionError(f"serve {cfg.name}: flash_decode against its "
                             f"plain version in the decode: {held}")
    del again
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"serve {cfg.name}: logits are not finite")
    if not torch.equal(lk.argmax(-1).to(torch.int32), toks):
        raise AssertionError(f"serve {cfg.name}: teacher-forced logits != "
                             f"generate's tokens")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if not per_step:  # no kernel on this path
        log(f"serve {cfg.name}: no kernel launched; tokens and logits "
            f"repeat bit for bit")
        return out
    with routing_replayed(routes) as flipped:
        lp = forced(False)
    if not in_prefill and not torch.equal(bits(lp[:, 0]), bits(lk[:, 0])):
        raise AssertionError(f"serve {cfg.name}: prefill logits differ (no "
                             f"kernel there)")
    flips = {"prefill": sum(int(f.sum()) for f in flipped[:cfg.num_layers]),
             "decode": 0, "decode_rows_steps": 0}
    if flipped:  # the decode steps' calls: [step, layer, row]
        per = torch.stack(flipped[cfg.num_layers:]).reshape(
            SERVE_NEW - 1, cfg.num_layers, SERVE_BATCH)
        flips["decode"] = int(per.sum())
        flips["decode_rows_steps"] = int(per.any(1).sum())
    del flipped
    with decode_attention_plain(), routing_replayed(routes):
        lq = forced(True)
    gap = {"plain": decode_gap(lk, lp), "kernel_plain": decode_gap(lk, lq)}
    for label, g in gap.items():
        g["within_gate"] = within_gate(g, gates.get(label))
    faults = {}
    for name, fault in fd_faults().items():
        with decode_attention_held(fault) as seen, routing_replayed(routes):
            lf = forced(True)
        faults[name] = {"in_decode": held_summary(seen)}
        for label, base in (("plain", lp), ("kernel_plain", lq)):
            fgap = decode_gap(lf, base)
            faults[name][label] = {
                **fgap, "caught": not within_gate(fgap, gates.get(label))}
        del lf, seen
    del routes, lq
    log(f"serve {cfg.name}: flash_decode x{launches['flash_decode']}, tokens "
        f"and logits repeat bit for bit; each call against its plain "
        f"version {held}; routing flips the plain decode would have taken "
        f"(it replays the kernel decode's) {flips}; kernel decode against "
        f"{gap}; planted faults {faults}")
    for label, tol in gates.items():
        if not gap[label]["within_gate"]:
            raise AssertionError(
                f"serve {cfg.name}: kernel decode vs {label} decode logits "
                f"{gap[label]} past rms, max {tol}")
    blind = [name for name, f in faults.items()
             if not f["in_decode"]["past_tol"]
             or not all(f[label]["caught"] for label in fault_gates)]
    if blind:
        raise AssertionError(f"serve {cfg.name}: blind to the planted faults "
                             f"{blind}: {faults}")
    out.update({"kernel_vs": gap, "kernel_vs_plain_in_decode": held,
                "routing_flips": flips, "planted_faults": faults,
                "gated": list(gates), "fault_gates": list(fault_gates),
                "gate": {label: gates.get(label)
                         or [SERVE_RMS_TOL, SERVE_MAX_TOL] for label in gap},
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    return out


def main_path_serve() -> dict:
    """Phase 8: :func:`serve_run` on llama3-8b at full width and depth
    (bf16, random weights), batch 4, a 2048-token prompt, 32 new greedy
    tokens (flash_decode 32 x 31 times), then one decode step under the
    profiler."""
    import torch
    from repro_torch.configs import get_config

    model, params, prompts, _ = serve_setup(get_config("llama3-8b"))
    tol = (SERVE_RMS_TOL, SERVE_MAX_TOL)
    out = serve_run(model, params, prompts,
                    gates={"plain": tol, "kernel_plain": tol},
                    fault_gates=("plain",))
    # one decode step under the profiler: flash_decode against the matmuls
    with torch.inference_mode():
        st = model.init_decode_state(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW,
                                     device=prompts.device)
        lg, st = model.prefill(params, {"tokens": prompts}, st)
        tok = lg.argmax(-1).to(torch.int32)
        out["profile_decode_step"] = profile_fn(
            lambda: model.decode_step(params, st, tok),
            out["decode_ms_per_token"], top=10,
            groups={"flash_decode": ("fold_chunks",),
                    "matmul": ("gemm", "cutlass", "xmma", "nvjet")})
    del params, st
    torch.cuda.empty_cache()
    return out


def flash_decode_rows(rng, launches, ops_count, slice_launches,
                      phase16_launches) -> dict:
    """Phase 9, B8: the kernel, its plain version and SDPA (with GQA and
    the kv_len mask, a yardstick the port never calls) at llama3-8b's
    decode shape (bf16, every row at S = 2080) and, nested, at the bench
    shape (f32, S = 8192), phase 15's shapes and phase 16's G = 1 shapes
    (bf16, with their launches a ``generate``, ``slice_launches`` and
    ``phase16_launches``); ``ops_count``: the device operations of phase
    2b."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode_plain

    def row(shape, dtype, label):
        b, h, hkv, d, s = shape
        q, k, v, kvl = decode_inputs(rng, *shape, dtype, [s] * b)
        qs = q[:, :, None, :]
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(s, device="cuda")[None, :] < kvl[:, None])[
            :, None, None, :]
        kern = lambda: ops.flash_decode(q, k, v, kvl)  # noqa: E731
        plain = lambda: flash_decode_plain(q, k, v, kvl)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
        got = kern()
        err = (got - plain()).abs().max().item()
        lib_err = (lib()[:, :, 0].float() - got).abs().max().item()
        item = k.element_size()
        n_kv = int(kvl.clamp(max=s).sum())
        nbytes = (2 * n_kv * hkv * d * item + q.numel() * item + b * 4
                  + b * h * d * 4)
        n_ops = 4 * n_kv * (h // hkv) * hkv * d  # q.k and p.v, 2 flops each
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        ms = time_ms(kern, 200)
        return {"max_abs_err": err, "ms": ms, "kernel_ms": ms,
                "plain_ms": time_ms(plain, 50),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(lib, 200),
                "graph_ms": graph_ms(kern, 200),
                "library_graph_ms": graph_ms(lib, 200),
                "device_ops": ops_count[label],
                "library_max_abs_err": lib_err,
                "shape": {"b": b, "h": h, "hkv": hkv, "d": d, "s": s,
                          "kv_len": s, "dtype": dtype}}

    main = row(FD_LLAMA_SHAPE, "bf16", "flash_decode")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:72",
            "launches": launches, **main,
            "bench_shape": row(FD_BENCH_SHAPE, "f32",
                               "flash_decode/bench_shape"),
            "phase15_shapes": {
                arch: {**row(shape, "bf16", f"flash_decode/{arch}"),
                       "launches": slice_launches[arch]}
                for arch, shape in FD_SLICE_SHAPES.items()},
            "phase16_shapes": {
                key: {**row(shape, "bf16", f"flash_decode/{key}"),
                      "launches": phase16_launches[key]}
                for key, shape in FD_PHASE16_SHAPES.items()}}


#: the combine flow past the one-hot cutoff: KeyedSum at K = 2^16, 2^22 pairs
COMBINE_LARGE_K, COMBINE_LARGE_ITEMS = 1 << 16, 1 << 19


def main_path_combine_large_k():
    """Phase 6c: ``MapReduce(KeyedSum(2^16), flow="combine")`` on 2^22 pairs
    takes the scatter lowering, and its add leaf the sort route
    (radix_partition + segment_reduce, never combine_scatter); counts exact,
    sums against float64 numpy, two runs bit for bit."""
    import warnings

    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.core import collector as col
    from repro_torch.data import datasets
    from repro_torch.kernels import ops

    k = COMBINE_LARGE_K
    mr = MapReduce(apps.KeyedSum(k), flow="combine")
    keys, weights = datasets.keyed_sum_data(
        np.random.default_rng(4), items=COMBINE_LARGE_ITEMS, key_space=k)
    items = (torch.from_numpy(keys).cuda(), torch.from_numpy(weights).cuda())
    with warnings.catch_warnings():  # the sum's scatter lowering past 2048
        warnings.simplefilter("ignore", col.LoweringFallbackWarning)
        mr.lower(items).compile()  # staged first (the warm-up's launches)
        ops.reset_launch_counts()
        res = mr.run(items)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        again = mr.run(items)
    if (launches["combine_scatter"] or not launches["segment_reduce"]
            or not launches["radix_partition"] + launches[
                "radix_partition_multi"]):
        raise AssertionError(f"combine K={k}: launches {launches}")
    if mr.plan.lowering != f"scatter (K={k}: add sort_segment_fold)":
        raise AssertionError(f"combine K={k}: explain() names another "
                             f"route:\n{mr.explain()}")
    if not (torch.equal(bits(res.values), bits(again.values))
            and torch.equal(res.counts, again.counts)):
        raise AssertionError(f"combine K={k}: two runs differ")
    flat = keys.reshape(-1)
    if not np.array_equal(res.counts.cpu().numpy(),
                          np.bincount(flat, minlength=k)):
        raise AssertionError(f"combine K={k}: counts != np.bincount")
    want = np.bincount(flat, weights=weights.reshape(-1).astype(np.float64),
                       minlength=k)
    got = res.values.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_RTOL)
    log(mr.explain())
    log(f"main path combine: KeyedSum K={k} {flat.size} pairs, sort route, "
        f"counts exact, sums max abs err {np.abs(got - want).max():.3g}, two "
        f"runs bit for bit, launches {launches}")
    return mr, items


# -- the sort flow -----------------------------------------------------------


def sort_pairs(rng, n, d, k, *, specials: bool):
    """Keys in [0, K) with sentinel (K), keys past the last bucket and
    negative keys mixed in; f32 values (NaN and signed zeros with
    ``specials``)."""
    import torch
    keys = rng.integers(0, k, size=n).astype(np.int32)
    bad = rng.random(n) < 0.1
    keys[bad] = rng.choice(np.array([k, k + 3, 2 * k + 5, -1, -7], np.int32),
                           size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    if specials:
        plant_specials(rng, vals)
    return torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()


def same_layout(got, want, k, what):
    """pkeys and starts bit for bit, values bit for bit at real slots."""
    import torch
    gk, gv, gs = got
    wk, wv, ws = want
    if not torch.equal(gs, ws):
        raise AssertionError(f"{what}: starts differ")
    if not torch.equal(gk, wk):
        raise AssertionError(f"{what}: keys differ at "
                             f"{int((gk != wk).sum())} slots")
    real = wk < k
    if not torch.equal(bits(gv[real]), bits(wv[real])):
        raise AssertionError(f"{what}: values differ at real slots")


def check_sort_kernels(rng) -> None:
    """Phase 2, sort flow: radix_partition, radix_partition_multi and
    segment_reduce against their plain versions on the card."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_partition import (
        partition_plan, radix_partition_multi_plain, radix_partition_plain)
    from repro_torch.kernels.segment_reduce import segment_reduce_plain

    def twice(fn, what):
        a, b = fn(), fn()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if not torch.equal(bits(x) if x.is_floating_point() else x,
                               bits(y) if y.is_floating_point() else y):
                raise AssertionError(f"{what}: two runs differ")
        return a

    def check_reduce(pk, pv, k, bs, pa, label):
        for op in ("add", "max", "min"):
            specials = op != "add"
            acc = torch.randn((k, pv.shape[1]), device=pv.device)
            if specials:  # the same layout; NaN payloads and signed zeros
                pv, acc = pv.cpu().numpy(), acc.cpu().numpy()  # in values
                for arr in (pv, acc):  # and in acc
                    plant_specials(rng, arr)
                pv, acc = torch.from_numpy(pv).cuda(), \
                    torch.from_numpy(acc).cuda()
            got = twice(lambda: ops.segment_reduce(pk, pv, k, op, tile_n=pa,
                                                   block_k=bs),
                        f"segment_reduce {op} ({label})")
            want = segment_reduce_plain(pk, pv, k, op)
            folded = twice(lambda: ops.segment_reduce(
                pk, pv, k, op, tile_n=pa, block_k=bs, acc=acc),
                f"segment_reduce {op} + acc ({label})")
            if op == "add":
                tol = SUM_RTOL * segment_reduce_plain(pk, pv.abs(), k, op) \
                    + 1e-6
                err = (got - want).abs()
                err_f = (folded - (acc + want)).abs()
                if not bool((err <= tol).all()) or not bool(
                        (err_f <= tol + SUM_RTOL * acc.abs()).all()):
                    raise AssertionError(
                        f"segment_reduce add != plain ({label}): max abs "
                        f"err {err.max().item()}")
            else:
                from repro_torch import numerics
                f = numerics.maximum if op == "max" else numerics.minimum
                if not torch.equal(bits(got), bits(want)) or not torch.equal(
                        bits(folded), bits(f(acc, want))):
                    raise AssertionError(
                        f"segment_reduce {op} != plain bitwise ({label})")

    def layout_keys(keys, k, bs, mix):
        """Keys of a case mix: as drawn, half of them in one bucket, or
        every one invalid (negative or past the last bucket)."""
        if mix == "half_one_bucket":
            half = torch.rand(keys.shape, device=keys.device) < 0.5
            keys = torch.where(half, min(5 * bs + 7, k - 1), keys)
        elif mix == "all_invalid":
            nb = -(-k // bs)
            keys = torch.where(keys % 2 == 0, -1 - keys.abs() % 7,
                               nb * bs + keys.abs() % 5)
        return keys.to(torch.int32).contiguous()

    def unaligned(keys, vals):
        """The same pairs as contiguous views one element into larger
        buffers: neither pointer is 8-byte aligned."""
        n, d = vals.shape
        kb = torch.empty(n + 1, dtype=keys.dtype, device=keys.device)
        vb = torch.empty(n * d + 1, dtype=vals.dtype, device=vals.device)
        k1, v1 = kb[1:], vb[1:].view(n, d)
        k1.copy_(keys)
        v1.copy_(vals)
        assert v1.data_ptr() % 8 and k1.data_ptr() % 8
        return k1, v1

    one_level = [  # (n, d, k, bucket_size, pad_align, label[, mix])
        (CUDA_CHUNK_PAIRS, 2, 1 << 18, 8192, 256,
         "main path (KeyedSum K=2^18 [K, 1+1])"),
        (1_000_003, 3, 100_000, 4096, 16, "ragged, K % bucket != 0"),
        (5_001, 1, 1000, 64, 16, "small buckets"),
        (777, 2, 300, 300, 16, "one bucket"),
        (3, 2, 50, 16, 256, "fewer pairs than a tile"),
        (1_000_003, 2, 1 << 18, 8192, 256, "one bucket holds half the pairs",
         "half_one_bucket"),
        (100_003, 2, 1 << 18, 8192, 256, "every key invalid", "all_invalid"),
        (300_007, 8, 100_000, 4096, 256, "D = 8"),
        (100_003, 300, 10_000, 64, 16, "D = 300, values not staged"),
        (1_000_003, 3, 100_000, 4096, 16,
         "keys and values not 8-byte aligned (views at offset 1)",
         "unaligned"),
        (1_000_003, 2, 100_000, 4096, 256,
         "D = 2, not 8-byte aligned (views at offset 1)", "unaligned"),
        (1_000_003, 1, 1 << 16, 64, 8, "1024 buckets (two passes), pad 8"),
    ]
    for n, d, k, bs, pa, label, *how in one_level:
        mix = how[0] if how else "uniform"
        keys, vals = sort_pairs(rng, n, d, k, specials=False)
        keys = layout_keys(keys, k, bs, mix)
        if mix == "unaligned":
            keys, vals = unaligned(keys, vals)
        got = twice(lambda: ops.radix_partition(keys, vals, k,
                                                bucket_size=bs, pad_align=pa),
                    f"radix_partition ({label})")
        want = radix_partition_plain(keys, vals, k, bucket_size=bs,
                                     pad_align=pa)
        same_layout(got, want, k, f"radix_partition ({label})")
        check_reduce(got[0], got[1], k, bs, pa, label)
        log(f"radix_partition + segment_reduce == plain: {label} n={n} "
            f"d={d} k={k} bucket={bs} pad={pa}")

    multi = [  # (n, d, k, bucket_size, fanouts, pad_align, label)
        (CUDA_CHUNK_PAIRS, 2, 1 << 20, 16384, (8, 8), 256,
         "main path (KeyedSum K=2^20 [K, 1+1])"),
        (200_001, 3, 100, 8, (4, 4), 16, "cover > K"),
        (500_000, 2, 1000, 16, (4, 4, 4), 16, "three levels"),
        (333_333, 1, 2000, 64, (8, 4), 256, "uneven fan-outs"),
        (1, 1, 13, 4, (2, 2), 8, "one pair, pad 8 (the reference's C.1)"),
        (CUDA_CHUNK_PAIRS, 2, 1 << 25, 16384, (16, 16, 8), 256,
         "2048 leaves (two passes)"),
        (1_000_003, 2, 1 << 16, 64, (2, 512), 16,
         "a level of 512 buckets (two passes of 32)"),
    ]
    for n, d, k, bs, fan, pa, label in multi:
        keys, vals = sort_pairs(rng, n, d, k, specials=False)
        got = twice(lambda: ops.radix_partition(
            keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa),
            f"radix_partition_multi ({label})")
        same_layout(got, radix_partition_multi_plain(
            keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa), k,
            f"radix_partition_multi ({label})")
        one = ops.radix_partition(keys, vals, k, bucket_size=bs,
                                  pad_align=pa)
        same_layout(got, one, k, f"radix_partition_multi vs one level "
                                 f"({label})")
        if k <= 1 << 20:
            check_reduce(got[0], got[1], k, bs, pa, label)
        plan = partition_plan(n, d, k, bs, pa)
        log(f"radix_partition_multi == plain == one level: {label} n={n} "
            f"d={d} k={k} bucket={bs} fanouts={fan} pad={pa} passes="
            f"{[(p.range_, p.digits) for p in plan.passes]}")

    keys, vals = sort_pairs(rng, 100_000, 2, 5000, specials=False)
    skeys, order = torch.sort(keys)
    svals = vals[order].contiguous()
    for op in ("max", "min"):
        got = ops.segment_reduce(skeys, svals, 5000, op)
        if not torch.equal(bits(got), bits(segment_reduce_plain(
                skeys, svals, 5000, op))):
            raise AssertionError(f"segment_reduce {op} on a sorted stream")
    log("segment_reduce on a key-sorted stream (block_k from the keys) == "
        "plain")


def sort_items(key_space: int):
    """(items on the card, flat keys, flat weights) of the KeyedSum app."""
    import torch
    from repro_torch.data import datasets
    keys, weights = datasets.keyed_sum_data(
        np.random.default_rng(3), items=SORT_ITEMS, key_space=key_space)
    items = (torch.from_numpy(keys).cuda(), torch.from_numpy(weights).cuda())
    return items, keys.reshape(-1), weights.reshape(-1)


def main_path_sort(key_space: int):
    """Phase 5: the sort flow on 2^24 pairs at one key space."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    mr = MapReduce(apps.KeyedSum(key_space), flow="sort")
    levels = 1 if key_space == SORT_KEY_SPACES[0] else 2
    partition = "radix_partition" if levels == 1 else "radix_partition_multi"
    t = mr.tiling
    if (mr.plan.flow, t.levels, t.use_kernel) != ("sort", levels, True):
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    items, keys, weights = sort_items(key_space)
    mr.lower(items).compile()  # staged first (the warm-up's launches)
    ops.reset_launch_counts()
    res = mr.run(items)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches[partition] <= 0 or launches["segment_reduce"] <= 0:
        raise AssertionError(f"{partition} / segment_reduce never "
                             f"launched: {launches}")
    log(mr.explain())
    want_counts = np.bincount(keys, minlength=key_space)
    if not np.array_equal(res.counts.cpu().numpy(), want_counts):
        raise AssertionError(f"KeyedSum K={key_space}: counts != bincount")
    want = np.bincount(keys, weights=weights.astype(np.float64),
                       minlength=key_space)
    got = res.values.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_RTOL)
    log(f"main path sort: KeyedSum K={key_space} {keys.size} pairs, "
        f"{levels} radix level(s), counts exact, sums max abs err "
        f"{np.abs(got - want).max():.3g}, launches {launches}")
    return mr, items, launches


def device_ops(fn) -> int | None:
    """Device operations (kernels, copies, memsets) one call of ``fn``
    issues, counted by torch.profiler (early in the script: see
    :func:`early_device_ops`).  None, with a line naming the cause, when
    the profiler recorded no device operation of a call that launched a
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import ops

    fn()
    torch.cuda.synchronize()
    before = ops.launch_counts()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched = sum(v - before[k] for k, v in ops.launch_counts().items())
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    if count == 0 and launched:
        log(f"device_ops: torch.profiler recorded no device operation of a "
            f"call that launched {launched} kernel(s); the row prints null")
        return None
    return count


def partition_shapes() -> dict:
    """(n, d, K, bucket, fan-outs) of each radix partition the kernels
    line reports."""
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS

    n = CUDA_CHUNK_PAIRS
    return {"radix_partition": (n, 2, 1 << 18, 8192, ()),
            "radix_partition/bounding_box_combine": (N_POINTS, 3, 100, 100,
                                                     ()),
            "radix_partition/bounding_box_combine_d1": (N_POINTS, 1, 100,
                                                        100, ()),
            "radix_partition/keyed_sum_combine_k65536": (1 << 22, 1, 1 << 16,
                                                         2048, ()),
            "radix_partition_multi": (n, 2, 1 << 20, 16384, (8, 8)),
            "radix_partition_multi/k33554432": (n, 2, 1 << 25, 16384,
                                                (16, 16, 8))}


def early_device_ops() -> dict:
    """Phase 2b: the device operations one call of each kernel issues at
    each shape the ``kernels`` line reports, counted right after phase 2
    holds the kernels against their plain versions, and carried to the
    line (phase 9).  A torch.profiler session late in this script loses
    the device records at its end (torch 2.11 on an H100: after phase 13
    a session of one B1 call recorded none of its 2 operations, a session
    of 20 calls 35 of 40), so the line's counts are taken here, where a
    session records them all.  A count is the same on any data: it follows the kernel's
    plan, which follows the shape."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(11)

    def pairs(n, d, k):
        return (torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                              generator=gen),
                torch.rand((n, d), device="cuda", generator=gen))

    out = {}
    n, k = CUDA_CHUNK_PAIRS, 100
    for name, d in (("onehot_fold", 4), ("chunk_monoid_fold", 3)):
        keys, vals = pairs(n, d, k)
        acc = torch.rand((k, d), device="cuda", generator=gen)
        out[name] = device_ops(
            (lambda: ops.onehot_fold(keys, vals, acc)) if name == "onehot_fold"
            else (lambda: ops.chunk_monoid_fold(keys, vals, acc, "max")))
    pa = 256
    for label, (m, d, kk, bs, fan) in partition_shapes().items():
        keys, vals = pairs(m, d, kk)
        out[label] = device_ops(lambda: ops.radix_partition(
            keys, vals, kk, bucket_size=bs, fanouts=fan, pad_align=pa))
    kk, bs = 1 << 18, 8192
    keys, vals = pairs(n, 2, kk)
    pk, pv, _ = ops.radix_partition(keys, vals, kk, bucket_size=bs,
                                    pad_align=pa)
    acc = torch.rand((kk, 2), device="cuda", generator=gen)
    out["segment_reduce"] = device_ops(lambda: ops.segment_reduce(
        pk, pv, kk, "add", tile_n=pa, block_k=bs, acc=acc))
    keys, vals = pairs(N_POINTS, 3, k)
    out["onehot_combine"] = device_ops(lambda: ops.onehot_combine(keys, vals,
                                                                  k))
    out["combine_scatter"] = device_ops(lambda: ops.combine_scatter(
        keys, vals, k, "add"))
    for label, m, d, kk, _ in INT_FOLD_SHAPES:  # the copies and the kernel
        ikeys = torch.randint(0, kk, (m,), dtype=torch.int32,
                              device="cuda", generator=gen)
        rows = torch.ones((m, d), dtype=torch.int64, device="cuda")
        table = torch.zeros((kk, d), dtype=torch.int64, device="cuda")
        cnt = torch.zeros((kk,), dtype=torch.int32, device="cuda")
        out[f"int_fold/{label}"] = device_ops(
            lambda: ops.int_fold(ikeys, rows, table, cnt))
    rng = np.random.default_rng(12)
    for label, shape, dtype in (("flash_decode", FD_LLAMA_SHAPE, "bf16"),
                                ("flash_decode/bench_shape", FD_BENCH_SHAPE,
                                 "f32"),
                                *((f"flash_decode/{arch}", shape, "bf16")
                                  for arch, shape
                                  in {**FD_SLICE_SHAPES,
                                      **FD_PHASE16_SHAPES}.items())):
        q, kc, vc, kvl = decode_inputs(rng, *shape, dtype, [shape[4]]
                                       * shape[0])
        out[label] = device_ops(lambda: ops.flash_decode(q, kc, vc, kvl))
    log(f"device operations a call (phase 2b): {out}")
    return out


def partition_timing(n, d, k, bs, fan, pa, n_ops, iters: int = 20,
                     seed: int = 6) -> dict:
    """B3 (no ``fan``) or B4 at one shape: kernel, plain and library times
    (eager and from a CUDA graph), its bound, passes and device operations
    a call (``n_ops``, of phase 2b); the layout must equal the plain
    version's bit for bit."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_partition import (
        partition_plan, radix_partition_multi_plain, radix_partition_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                         generator=gen)
    vals = torch.rand((n, d), device="cuda", generator=gen)
    kern = lambda: ops.radix_partition(  # noqa: E731
        keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa)
    if len(fan) > 1:
        plain = lambda: radix_partition_multi_plain(  # noqa: E731
            keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa)
    else:
        plain = lambda: radix_partition_plain(  # noqa: E731
            keys, vals, k, bucket_size=bs, pad_align=pa)

    def lib():  # the library's stable sort by bucket, and the gathers
        order = torch.argsort(keys // bs, stable=True)
        return keys[order], vals[order]

    got, want = kern(), plain()
    same_layout(got, want, k, f"radix_partition k={k} fanouts={fan}")
    real = want[0] < k
    err = (got[1][real] - want[1][real]).abs().max().item()
    np_ = got[0].shape[0]
    nbytes = n * (4 + 4 * d) + np_ * (4 + 4 * d) + got[2].numel() * 4
    plan = partition_plan(n, d, k, bs, pa)
    ms = time_ms(kern, iters)
    return {"max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "graph_ms": graph_ms(kern, iters),
            "plain_ms": time_ms(plain, 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(lib, iters),
            "library_graph_ms": graph_ms(lib, iters),
            "device_ops": n_ops,
            "passes": [{"range": p.range_, "digits": p.digits,
                        "tile": p.tile, "grid": p.grid, "smem": p.smem,
                        "staged": p.staged} for p in plan.passes],
            "shape": {"n": n, "d": d, "k": k, "bucket_size": bs,
                      "fanouts": list(fan), "pad_align": pa, "slots": np_}}


def sort_kernel_rows(rng, launches, ops_count) -> list[dict]:
    """Phase 8, sort flow: B3, B4 and B5 at the main paths' shapes; B3 also
    at the combine flow's sort-route shapes (BoundingBox: 2^24 pairs of
    D = 3 in one bucket, and at D = 1; KeyedSum K = 2^16: 2^22 pairs of
    D = 1 in 32 buckets), B4 also at K = 2^25 (2048 leaves, two passes);
    ``ops_count``: the device operations of phase 2b."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import segment_reduce_plain

    n, d, pa = CUDA_CHUNK_PAIRS, 2, 256
    src = "src/repro_torch/kernels/csrc/"
    shapes = partition_shapes()
    b3 = {"name": "radix_partition", "route": "cuda",
          "source": src + "radix_partition.cu",
          "replaces": "src/repro/kernels/radix_partition.py:189",
          "launches": launches["radix_partition"],
          **partition_timing(*shapes["radix_partition"], pa,
                             ops_count["radix_partition"])}
    for label in ("bounding_box_combine", "bounding_box_combine_d1",
                  "keyed_sum_combine_k65536"):
        key = f"radix_partition/{label}"
        b3[label] = partition_timing(*shapes[key], pa, ops_count[key],
                                     iters=10 if "bounding" in label else 20)
    b4 = {"name": "radix_partition_multi", "route": "cuda",
          "source": src + "radix_partition.cu",
          "replaces": "src/repro/kernels/radix_partition.py:268",
          "launches": launches["radix_partition_multi"],
          **partition_timing(*shapes["radix_partition_multi"], pa,
                             ops_count["radix_partition_multi"])}
    b4["k33554432"] = partition_timing(
        *shapes["radix_partition_multi/k33554432"], pa,
        ops_count["radix_partition_multi/k33554432"])
    rows = [b3, b4]
    k, bs = 1 << 18, 8192
    keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda")
    vals = torch.rand((n, d), device="cuda")
    pk, pv, _ = ops.radix_partition(keys, vals, k, bucket_size=bs,
                                    pad_align=pa)
    acc = torch.rand((k, d), device="cuda")
    kern = lambda: ops.segment_reduce(  # noqa: E731
        pk, pv, k, "add", tile_n=pa, block_k=bs, acc=acc)
    plain = lambda: acc + segment_reduce_plain(pk, pv, k, "add")  # noqa
    pk64 = pk.long()
    lib = lambda: torch.cat([acc, torch.zeros((1, d), device="cuda")]  # noqa
                            ).index_add_(0, pk64, pv)[:k]
    err = (kern() - plain()).abs().max().item()
    np_ = pk.shape[0]
    nbytes = np_ * (4 + 4 * d) + 2 * k * d * 4
    ms = time_ms(kern, 20)
    bbox = segment_reduce_bbox_row()
    rows.append({
        "name": "segment_reduce", "route": "cuda",
        "source": src + "segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:152",
        "launches": launches["segment_reduce"], "max_abs_err": err,
        "ms": ms, "kernel_ms": ms, "plain_ms": time_ms(plain, 5),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lib, 20),
        "graph_ms": graph_ms(kern, 20), "library_graph_ms": graph_ms(lib, 20),
        "device_ops": ops_count["segment_reduce"],
        "shape": {"slots": np_, "d": d, "k": k, "block_k": bs, "tile": pa,
                  "op": "add", "with_acc": True},
        "bounding_box_max": bbox,
    })
    return rows


#: leaves of the pass sweep, 2^22 pairs of D = 2 at 16384-key leaves, and
#: the fan-outs of the passes it times for each: one pass where the kernel
#: takes it, two, and at 2048 leaves (two passes at any limit) the plan's
#: even split beside uneven ones
PASS_SWEEP = {64: ((64,), (8, 8)), 256: ((256,), (16, 16)),
              1024: ((32, 32), (8, 128)),
              2048: ((64, 32), (32, 64), (16, 128), (8, 256))}


def radix_pass_sweep() -> dict:
    """B4 over :data:`PASS_SWEEP`: each chain of passes' time from a CUDA
    graph; every chain's layout must equal the first's bit for bit."""
    import torch
    from repro_torch.kernels.radix_partition import (
        Pass, plan_passes, radix_partition_cuda)

    n, d, bs, pa = 1 << 22, 2, 16384, 256
    out = {"n": n, "d": d, "bucket_size": bs, "rows": []}
    for leaves, chains in PASS_SWEEP.items():
        k = bs * leaves
        gen = torch.Generator(device="cuda").manual_seed(7)
        keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                             generator=gen)
        vals = torch.rand((n, d), device="cuda", generator=gen)
        row, first = {"leaves": leaves, "k": k}, None
        for fan in chains:
            ranges = [bs]
            for f in reversed(fan[1:]):
                ranges.insert(0, ranges[0] * f)
            plan = plan_passes(n, d, k, [Pass(r, f) for r, f in
                                         zip(ranges, fan)], pa)
            fn = lambda: radix_partition_cuda(  # noqa: E731
                keys, vals, k, plan, pad_align=pa, multi=True)
            got = fn()
            if first is None:
                first = got
            else:
                same_layout(got, first, k, f"pass sweep {leaves} {fan}")
            label = "x".join(map(str, fan))
            row[f"{label}_graph_ms"] = graph_ms(fn, 20)
            row[f"{label}_tiles"] = [p.tile for p in plan.passes]
        out["rows"].append(row)
    return out


def segment_reduce_bbox_row() -> dict:
    """B5 at the BoundingBox combine shape: max over 2^24 pairs of D = 3 at
    K = 100 (the sort route's one-bucket layout), beside scatter_reduce_'s
    amax (which drops JAX's signed-zero rule) as its yardstick."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import segment_reduce_plain

    n, d, k, pa = N_POINTS, 3, 100, 256
    gen = torch.Generator(device="cuda").manual_seed(5)
    keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                         generator=gen)
    vals = torch.randn((n, d), device="cuda", generator=gen)
    pk, pv, _ = ops.radix_partition(keys, vals, k, bucket_size=k,
                                    pad_align=pa)
    kern = lambda: ops.segment_reduce(pk, pv, k, "max", tile_n=pa,  # noqa
                                      block_k=k)
    got = kern()
    if not torch.equal(bits(got), bits(segment_reduce_plain(pk, pv, k,
                                                            "max"))):
        raise AssertionError("segment_reduce max (BoundingBox shape) != "
                             "plain bitwise")
    idx = pk.long().clamp(max=k)[:, None].expand(-1, d)
    lib = lambda: torch.full((k + 1, d), float("-inf"),  # noqa: E731
                             device="cuda").scatter_reduce_(
        0, idx, pv, "amax")[:k]
    np_ = pk.shape[0]
    return {"ms": time_ms(kern, 10), "library_ms": time_ms(lib, 10),
            "graph_ms": graph_ms(kern, 10),
            "bound_ms": (np_ * (4 + 4 * d) + k * d * 4) / HBM_BYTES_PER_S
            * 1e3, "bound_by": "bytes",
            "shape": {"slots": np_, "d": d, "k": k, "block_k": k,
                      "tile": pa, "op": "max", "with_acc": False}}


def profile(mr, items, wall_ms: float, top: int = 8) -> dict:
    """Device time of one warm main-path run by kernel (torch.profiler),
    and its share of ``wall_ms``, the run's median wall time measured
    without the profiler (which slows the host side)."""
    return profile_fn(lambda: mr.run(items), wall_ms, top)


def profile_fn(fn, wall_ms: float, top: int = 8, groups=None) -> dict:
    """:func:`profile` of one warm call of ``fn``; ``groups`` maps a label
    to the words (lower case) of the kernel names whose device time it
    sums."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: an op's own entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [{"name": name[:80], "ms": ms, "calls": calls}
                    for name, ms, calls in rows[:top]],
            **({"groups": {
                g: sum(ms for name, ms, _ in rows
                       if any(w in name.lower() for w in words))
                for g, words in groups.items()}} if groups else {})}


def run_ms(mr, items, reps: int = 3) -> float:
    """Median wall milliseconds of ``mr.run(items)`` after a warm-up run."""
    import torch
    mr.run(items)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mr.run(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


COST_KEYS = (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 20)
COST_PAIRS = (1 << 22, 1 << 24)  # KeyedSum items of 8 pairs: 2^19, 2^21
COST_GRID = tuple(1 << b for b in range(6, 25))  # the model's crossover
#: the device time of each fitted term's kernels, by torch.profiler name
COST_GROUPS = {"fold": ("lane_fold::", "keyed_fold::"),
               "partition": ("radix::",), "segment": ("segred::",)}
#: a measured winner by this factor or more must be the model's choice
COST_GATE_MARGIN = 2.0
#: timed runs of each flow at a swept shape, taken in turn (median)
COST_REPS = 9


def in_turn(items):
    """A function that hands out ``items`` and a copy of them in turn: no
    call gets the tensors of the call before, so a run called with it
    keeps the stream flow's chunk loop eager (``engine.LocalRun`` captures
    a CUDA graph only over items that repeat), which is what the cost
    model prices: a call over items the run has not just seen."""
    from torch.utils import _pytree as pytree

    copies, turn = (items, pytree.tree_map(lambda t: t.clone(), items)), [0]

    def next_items():
        turn[0] ^= 1
        return copies[turn[0]]
    return next_items


def interleaved_ms(mrs: dict, items, reps: int = COST_REPS) -> dict:
    """Median wall milliseconds of ``mr.run`` for each ``mr`` in ``mrs``
    (by label), after a warm-up run of each, over ``items`` and a copy in
    turn (:func:`in_turn`: the eager loop).  The runs take turns, ``reps``
    rounds of one run each, so that a stretch of load on the host's
    shared cores falls on every flow alike rather than on the flow timed
    while it lasts."""
    import torch
    times = {label: [] for label in mrs}
    feeds = {label: in_turn(items) for label in mrs}
    for label, mr in mrs.items():
        mr.run(feeds[label]())
    torch.cuda.synchronize()
    for _ in range(reps):
        for label, mr in mrs.items():
            it = feeds[label]()
            t0 = time.perf_counter()
            mr.run(it)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    return {label: float(np.median(t)) for label, t in times.items()}


def cost_run(mr, items, wall: float, *, label, k, n, d, value_bytes,
             lmax) -> dict:
    """One refit row: the run's median wall ``wall`` (:func:`interleaved_ms`),
    its device time by kernel group (torch.profiler) and the units the
    ``cuda`` profile prices for it (``cost_model.cuda_work``)."""
    from repro_torch.core import cost_model as cm

    feed = in_turn(items)  # the eager loop, as timed
    prof = profile_fn(lambda: mr.run(feed()), wall, top=0,
                      groups=COST_GROUPS)
    fold_op = ("add" if mr.plan.spec is None or mr.plan.spec.sum_lowerable
               else "max")
    return {"app": label, "flow": mr.plan.flow, "K": k, "n": n,
            "wall_ms": wall, "device_ms": prof["device_ms"],
            "groups_ms": prof["groups"],
            "work": cm.cuda_work(mr.plan.flow, n_pairs=n, key_space=k, d=d,
                                 value_bytes=value_bytes,
                                 max_values_per_key=lmax, fold_op=fold_op)}


def fit_cost_profile(rows: list[dict]) -> dict:
    """Refit ``CUDA_COEFF`` from the rows: each byte term's coefficient by
    least squares through the origin of its kernels' device time (at the
    HBM rate, in bytes) against its bytes; ``map`` from the device time no
    group holds; ``reduce`` from the reduce rows' device time less their
    map term; ``dispatch`` and ``chunk`` by least squares of the wall less
    the device time against the chunks."""
    from repro_torch.roofline import analysis as roofline

    rate = roofline.H100_SXM_HBM_BYTES_PER_S

    def ratio(pairs):
        if not pairs:
            raise AssertionError("cost profile: a term has no run to fit")
        xs = np.array([x for x, _ in pairs], dtype=np.float64)
        ys = np.array([y for _, y in pairs], dtype=np.float64)
        return float((xs * ys).sum() / (xs * xs).sum())

    def eq_bytes(ms):
        return ms * 1e-3 * rate

    fit = {}
    for name, group in (("fold_lane", "fold"), ("fold_table", "fold"),
                        ("partition", "partition"),
                        ("segment", "segment")):
        fit[name] = ratio([(r["work"][name], eq_bytes(r["groups_ms"][group]))
                           for r in rows if name in r["work"]])
    kernels = [r for r in rows if r["flow"] != "reduce"]
    fit["map"] = ratio([(r["work"]["map"], eq_bytes(
        r["device_ms"] - sum(r["groups_ms"].values()))) for r in kernels])
    fit["reduce"] = ratio([(r["work"]["reduce"], eq_bytes(r["device_ms"])
                            - fit["map"] * r["work"]["map"])
                           for r in rows if r["flow"] == "reduce"])
    host = np.array([(r["wall_ms"] - r["device_ms"]) * 1e-3 for r in rows])
    chunks = np.array([r["work"]["chunk"] for r in rows])
    (chunk, dispatch), *_ = np.linalg.lstsq(
        np.stack([chunks, np.ones_like(chunks)], axis=1), host, rcond=None)
    if chunk < 0 or dispatch < 0:  # one term alone where both cannot hold
        chunk, dispatch = ((0.0, max(float(host.mean()), 0.0)) if chunk < 0
                           else (max(ratio(list(zip(chunks, host))), 0.0),
                                 0.0))
    fit["dispatch"], fit["chunk"] = float(dispatch), float(chunk)
    return fit


def sort_from(ks, sort_wins) -> int | None:
    """The smallest of the increasing key spaces ``ks`` from which the sort
    flow wins at every larger one (None: it does not win at the last)."""
    first = None
    for k, wins in zip(ks, sort_wins):
        first = (first or k) if wins else None
    return first


def cost_gate(rows: list[dict], plans: dict) -> dict:
    """Phase 7c(b): with the committed coefficients, the cost model's
    choice (``plan.flow_cost_report`` on the card's profile) against the
    measured winner of the stream and sort walls at every swept shape; a
    winner by ``COST_GATE_MARGIN`` or more must be the choice.  Also the
    crossover at each n: the K from which the sort flow wins at every
    larger K, by wall, by device time, by the model at the swept K and on
    ``COST_GRID``."""
    from repro_torch import apps
    from repro_torch.core import plan as planner

    runs = {}
    for r in rows:
        if r["flow"] in ("stream", "sort"):
            runs.setdefault((r["app"], r["K"], r["n"]), {})[r["flow"]] = r
    shapes, failed = [], []
    for (label, k, n), run in sorted(runs.items()):
        app, spec = plans[(label, k)]
        report = planner.flow_cost_report(app, spec, n, device="cuda")
        w = {f: r["wall_ms"] for f, r in run.items()}
        winner = min(w, key=w.get)
        margin = max(w.values()) / min(w.values())
        gated = margin >= COST_GATE_MARGIN
        ok = report.chosen == winner
        shapes.append({
            "app": label, "K": k, "n": n, "stream_ms": w["stream"],
            "sort_ms": w["sort"],
            "stream_device_ms": run["stream"]["device_ms"],
            "sort_device_ms": run["sort"]["device_ms"], "winner": winner,
            "margin": margin, "model": report.chosen,
            "model_stream_ms": report.cost_of("stream").est_s * 1e3,
            "model_sort_ms": report.cost_of("sort").est_s * 1e3,
            "verdict": ("agree" if ok else "DISAGREE") if gated
            else f"not gated ({'agree' if ok else 'close'})"})
        if gated and not ok:
            failed.append(shapes[-1])
    crossover = {}
    _, spec = plans[("keyed_sum", COST_KEYS[0])]
    for n in COST_PAIRS:
        swept = [s for s in shapes if s["app"] == "keyed_sum" and s["n"] == n]
        ks = [s["K"] for s in swept]
        crossover[str(n)] = {
            "wall": sort_from(ks, [s["winner"] == "sort" for s in swept]),
            "device": sort_from(ks, [s["sort_device_ms"] < s["stream_device_ms"]
                                     for s in swept]),
            "model_swept": sort_from(ks, [s["model"] == "sort"
                                          for s in swept]),
            "model_grid": sort_from(COST_GRID, [
                planner.flow_cost_report(apps.KeyedSum(k), spec, n,
                                         device="cuda").chosen == "sort"
                for k in COST_GRID])}
    return {"shapes": shapes, "crossover": crossover, "failed": failed}


def cost_refit(card: str):
    """Phase 7c(a): time the stream and sort flows of KeyedSum (f32
    weights) at ``COST_KEYS`` x ``COST_PAIRS``, KMeans at 2^24 points and
    two reduce-flow runs (the flows of a shape timed in turn,
    :func:`interleaved_ms`), and refit the ``cuda`` profile from them: the
    ``cost_profile`` line gives ``CUDA_COEFF`` beside the refit.  Returns
    the rows, the apps' derived specs, and the KMeans items."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.core import cost_model as cm
    from repro_torch.data import datasets

    rows, plans = [], {}
    for k in COST_KEYS:
        full, _, _ = sort_items(k)
        for n in COST_PAIRS:
            items = tuple(t[:n // 8] for t in full)
            mrs = {flow: MapReduce(apps.KeyedSum(k), flow=flow)
                   for flow in ("stream", "sort")}
            plans[("keyed_sum", k)] = (apps.KeyedSum(k),
                                       mrs["stream"].plan.spec)
            walls = interleaved_ms(mrs, items)
            for flow, mr in mrs.items():
                rows.append(cost_run(mr, items, walls[flow],
                                     label="keyed_sum", k=k, n=n, d=1,
                                     value_bytes=4, lmax=64))
        if k == 1 << 14:
            mr = MapReduce(apps.KeyedSum(k), flow="reduce")
            items = tuple(t[:COST_PAIRS[0] // 8] for t in full)
            rows.append(cost_run(mr, items, run_ms(mr, items),
                                 label="keyed_sum", k=k, n=COST_PAIRS[0],
                                 d=1, value_bytes=4, lmax=64))
        del full
    pts, assign, _ = datasets.kmeans_data(np.random.default_rng(1),
                                          points=N_POINTS)
    kitems = (torch.from_numpy(assign).cuda(), torch.from_numpy(pts).cuda())
    mrs = {flow: MapReduce(apps.KMeans(), flow=flow)
           for flow in ("stream", "sort", "reduce")}
    plans[("kmeans", 100)] = (apps.KMeans(), mrs["stream"].plan.spec)
    walls = interleaved_ms(mrs, kitems)
    for flow, mr in mrs.items():
        rows.append(cost_run(mr, kitems, walls[flow], label="kmeans", k=100,
                             n=N_POINTS, d=3, value_bytes=12,
                             lmax=apps.KMeans.max_values_per_key))
    log(json.dumps({"cost_profile": {
        "card": card, "committed": cm.CUDA_COEFF,
        "refit": fit_cost_profile(rows),
        "runs": [{key: r[key] for key in ("app", "flow", "K", "n", "wall_ms",
                                          "device_ms", "groups_ms")}
                 for r in rows]}}))
    return rows, plans, kitems


def main_path_hinted(kitems) -> dict:
    """Phase 7c(c): ``MapReduce(KeyedSum(2^20), n_pairs_hint=2^24)`` and
    ``MapReduce(KMeans(), n_pairs_hint=2^24)`` on the card: the plan's
    profile is ``cuda``, the chosen flow's kernels launch (B3/B4 and B5
    for the sort flow, B1 for the stream flow), and the result equals the
    same flow forced, bit for bit."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    sitems, _, _ = sort_items(1 << 20)
    hinted = {}
    for label, app, items in (("keyed_sum_K1048576", apps.KeyedSum(1 << 20),
                               sitems),
                              ("kmeans", apps.KMeans(), kitems)):
        mr = MapReduce(app, n_pairs_hint=SORT_ITEMS * 8)
        if mr.plan.cost is None or mr.plan.cost.backend != "cuda":
            raise AssertionError(f"{label}: the hint did not plan with the "
                                 f"cuda profile:\n{mr.explain()}")
        mr.lower(items).compile()  # staged first (the warm-up's launches)
        ops.reset_launch_counts()
        res = mr.run(items)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if mr.plan.flow == "sort":
            ran = (launches["radix_partition"]
                   + launches["radix_partition_multi"] > 0
                   and launches["segment_reduce"] > 0)
        else:
            ran = launches["onehot_fold"] > 0
        if not ran:
            raise AssertionError(f"{label}: {mr.plan.flow} flow's kernels "
                                 f"never launched: {launches}")
        forced = MapReduce(app, flow=mr.plan.flow).run(items)
        for got, want in ((res.counts, forced.counts),
                          (res.values, forced.values)):
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{label}: auto with the hint != "
                                     f"flow={mr.plan.flow!r} forced")
        log(mr.explain())
        log(f"main path auto with n_pairs_hint: {label} -> {mr.plan.flow} "
            f"(cuda profile), bit for bit with the forced flow, launches "
            f"{launches}")
        hinted[label] = {"flow": mr.plan.flow, "launches": launches,
                         "wall_ms": run_ms(mr, items)}
    return hinted


def cost_model_on_card(card: str) -> dict:
    """Phase 7c: refit the ``cuda`` profile (a), gate the committed one
    (b: raises on a shape it ranks wrong by ``COST_GATE_MARGIN``), then
    the auto-with-hint main paths (c)."""
    rows, plans, kitems = cost_refit(card)
    gate = cost_gate(rows, plans)
    log(json.dumps({"cost_gate": {"card": card,
                                  "margin": COST_GATE_MARGIN, **gate}}))
    if gate["failed"]:
        raise AssertionError(f"cost model: the committed CUDA_COEFF picks "
                             f"the loser at {len(gate['failed'])} shape(s) "
                             f"with a margin of {COST_GATE_MARGIN}x or more: "
                             f"{gate['failed']}")
    return main_path_hinted(kitems)


# -- the staged path, the plan cache and pipelines ---------------------------

#: (c): item counts below 2^24 that share its pow2 bucket
POW2_NS = (N_POINTS - 4099, N_POINTS - 8191)
#: (d): the pipeline's first stage, KeyedSum over 2^24 pairs
PIPE_K = 1 << 16


def wall_ms(fn, reps: int = 3) -> float:
    """Median wall milliseconds of ``fn()`` after a warm-up call, each
    ending in ``torch.cuda.synchronize()``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def same_bits(a, b) -> bool:
    import torch
    return (torch.equal(a.counts, b.counts)
            and torch.equal(bits(a.values), bits(b.values)))


def staged_on_card(card: str, kitems,
                   first_plan_ms: float | None = None) -> dict:
    """Phase 10: the staged path (``lower().optimize().compile()``), the
    plan cache, pow2 bucketing, pipelines and the measured probe on the
    card.  (a) KMeans (stream, B1), BoundingBox (stream, B2 and int_fold),
    WordCount (stream, 2^16 words, int_fold), KeyedSum K = 2^20 (sort, B4
    + B5) and KMeans ``flow="combine"`` (B6) at 2^24 pairs: the compiled
    call equals an uncached ``run()`` bit for bit and
    launches each kernel; a second call leaves the first call's tensors as
    they were.  (b) A second MapReduce over an equal app derives, tunes
    and prepares nothing (``stats_snapshot``), ``cache_event == "hit"``;
    the plan stage's ms on a miss and a hit, beside the process's first
    plan (``first_plan_ms``, phase 3).  (c) KMeans and BoundingBox
    at 2^24 - 4099 points, ``items_bucket="pow2"``: the bits of the exact
    run, also when the caller passes the bucket's 2^24 rows; a second N
    in the bucket prepares nothing; and, a diagnostic, whether a chunk
    folded with a masked tail (sentinel keys up to its capacity) keeps
    the short chunk's bits.  (d) KeyedSum K = 2^16 then a 64-bucket
    histogram weighted by each sum (reads the values), or key presence
    mod 8 (dead values): fused == unfused == the stages run one by one,
    bit for bit; walls and ``model_bytes``.  (e) ``autotune_probe=True``
    with a tune cache file: the candidates' times, then ``source ==
    "cache"``.  (f) Host syncs of one compiled call in each flow of (a).
    Prints one ``staged`` line."""
    import os
    import tempfile

    import torch
    from repro_torch import ExecutionOptions, MapReduce, Pipeline, apps
    from repro_torch import make_app
    from repro_torch.core import autotune as at
    from repro_torch.core import plan_cache as pc
    from repro_torch.core import ValueSpec
    from repro_torch.data import datasets
    from repro_torch.kernels import ops

    from portbench.syncs import host_syncs

    out: dict = {"card": card}
    sitems, _, _ = sort_items(1 << 20)
    toks, vocab = datasets.wordcount_data(
        np.random.default_rng(6), tokens=INT_WC_TOKENS, vocab=INT_WC_VOCAB)
    witems = torch.from_numpy(toks.reshape(-1, 16)).cuda()
    cases = (("kmeans_stream", apps.KMeans, {}, kitems, ("onehot_fold",)),
             ("bounding_box_stream", apps.BoundingBox, {}, kitems,
              ("chunk_monoid_fold", "int_fold")),
             ("wordcount_stream", lambda: apps.WordCount(vocab), {}, witems,
              ("int_fold",)),
             ("keyed_sum_K1048576_sort", lambda: apps.KeyedSum(1 << 20),
              {"flow": "sort"}, sitems,
              ("radix_partition_multi", "segment_reduce")),
             ("kmeans_combine", apps.KMeans, {"flow": "combine"}, kitems,
              ("onehot_combine",)))
    staged, syncs = {}, {}
    for label, make, kw, items, kernels in cases:  # (a) and (f)
        mr = MapReduce(make(), **kw)
        want = MapReduce(make(), cache=False, **kw).run(
            items, options=ExecutionOptions(cache=False))
        comp = mr.lower(items).optimize().compile()
        ops.reset_launch_counts()
        got = comp(items)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if not all(launches[k] > 0 for k in kernels):
            raise AssertionError(f"staged {label}: {kernels} not all "
                                 f"launched: {launches}")
        if not same_bits(got, want):
            raise AssertionError(f"staged {label}: compiled call != run()")
        kept = (got.values.clone(), got.counts.clone())
        again = comp(items)
        torch.cuda.synchronize()
        if not (torch.equal(bits(got.values), bits(kept[0]))
                and torch.equal(got.counts, kept[1])
                and same_bits(again, want)):
            raise AssertionError(f"staged {label}: a second call changed "
                                 f"the first call's tensors or its bits")
        syncs[label] = host_syncs(lambda: comp(items))
        staged[label] = {
            "launches": {k: launches[k] for k in kernels},
            "compiled_ms": wall_ms(lambda: comp(items)),
            "run_ms": wall_ms(lambda: mr.run(items)),
            "memory": comp.memory_analysis()}
        log(f"staged {label}: compiled call == run() bit for bit, "
            f"launches {staged[label]['launches']}, a second call leaves "
            f"the first's tensors; launch plan:\n{comp.as_text()}")
    out["compiled"] = staged
    out["host_syncs_per_call"] = syncs

    pc.clear()  # (b)
    t0 = time.perf_counter()
    cold = MapReduce(apps.KMeans())
    miss_ms = (time.perf_counter() - t0) * 1e3
    cold.run(kitems)
    s0 = pc.stats_snapshot()
    t0 = time.perf_counter()
    warm = MapReduce(apps.KMeans())
    hit_ms = (time.perf_counter() - t0) * 1e3
    if not same_bits(warm.run(kitems), cold.run(kitems)):
        raise AssertionError("warm hit: results differ")
    d = {k: v - s0[k] for k, v in pc.stats_snapshot().items()}
    if (d["derives"], d["autotunes"], d["compiles"]) != (0, 0, 0) or \
            warm.plan.cache_event != "hit":
        raise AssertionError(f"warm hit derived, tuned or compiled: {d}, "
                             f"cache_event {warm.plan.cache_event!r}")
    out["warm_hit"] = {"first_plan_ms": first_plan_ms,
                       "plan_miss_ms": miss_ms, "plan_hit_ms": hit_ms,
                       "stats_delta": d}
    log(f"plan cache: a miss plans in {miss_ms:.3f} ms, a hit in "
        f"{hit_ms:.3f} ms; warm repeat {d}")

    pow2 = ExecutionOptions(items_bucket="pow2")  # (c)
    buckets = {}
    for label, make in (("kmeans", apps.KMeans),
                        ("bounding_box", apps.BoundingBox)):
        mr = MapReduce(make())
        n0, n1 = POW2_NS
        part = tuple(a[:n0] for a in kitems)
        exact = mr.run(part)
        comp = mr.lower(part, options=pow2).compile()
        if comp.n_bucket != N_POINTS:
            raise AssertionError(f"pow2 {label}: bucket {comp.n_bucket}")
        if not (same_bits(comp(part), exact)
                and same_bits(comp(kitems), exact)):
            raise AssertionError(f"pow2 {label}: padded != exact bits")
        s0 = pc.stats_snapshot()
        part1 = tuple(a[:n1] for a in kitems)
        comp1 = mr.lower(part1, options=pow2).compile()
        if pc.stats_snapshot()["compiles"] != s0["compiles"] or \
                comp1.cache_event != "hit":
            raise AssertionError(f"pow2 {label}: N={n1} compiled again")
        if not same_bits(comp1(part1), mr.run(part1)):
            raise AssertionError(f"pow2 {label}: N={n1} != exact bits")
        buckets[label] = {"n": [n0, n1], "bucket": comp.n_bucket,
                          "bits_equal": True}
    out["pow2"] = buckets
    out["masked_tail_bits_equal"] = masked_tail_bits()
    log(f"pow2: KMeans and BoundingBox at N={POW2_NS} equal the exact runs "
        f"bit for bit, one compile a bucket; masked-tail diagnostic "
        f"{out['masked_tail_bits_equal']}")

    keys, weights = sort_items(PIPE_K)[0]  # (d)

    def hist_map(item, emit):
        b = torch.clamp((item[1] - 96.0).floor().to(torch.int32), 0, 63)
        emit(b, item[1], valid=item[2] > 0)

    def presence_map(item, emit):
        emit(item[0] % 8, torch.ones_like(item[0]))

    hist = make_app(hist_map, lambda k, v, c: v.sum(0), key_space=64,
                    value_spec=ValueSpec((), torch.float32), emit_capacity=1)
    presence = make_app(presence_map, lambda k, v, c: v.sum(0), key_space=8,
                        value_spec=ValueSpec((), torch.int32),
                        emit_capacity=1)
    pipes = {}
    for label, consumer in (("histogram", hist), ("presence", presence)):
        p = Pipeline(apps.KeyedSum(PIPE_K)).then(consumer)
        fused, unfused = p.run((keys, weights)), p.run_unfused((keys, weights))
        first = MapReduce(apps.KeyedSum(PIPE_K)).run((keys, weights))
        alone = MapReduce(consumer).run(
            (first.keys, first.values, first.counts))
        if not (same_bits(fused, unfused) and same_bits(fused, alone)):
            raise AssertionError(f"pipeline {label}: fused, unfused and the "
                                 f"stages one by one differ")
        if label == "histogram" and int(fused.counts.sum()) != PIPE_K:
            raise AssertionError("pipeline histogram: counts != K")
        pipes[label] = {
            "dead_value": p.stages[1].dead_value,
            "fused_ms": wall_ms(lambda: p.run((keys, weights))),
            "unfused_ms": wall_ms(lambda: p.run_unfused((keys, weights))),
            "model_bytes_fused": p.model_bytes(SORT_ITEMS, fused=True),
            "model_bytes_unfused": p.model_bytes(SORT_ITEMS, fused=False)}
        log(f"pipeline {label}: fused == unfused == stages one by one, bit "
            f"for bit\n{p.explain()}")
    out["pipeline"] = pipes

    with tempfile.TemporaryDirectory() as tmp:  # (e)
        os.environ[at.TUNE_CACHE_ENV] = os.path.join(tmp, "tune.json")
        try:
            pc.clear()
            probed = MapReduce(apps.KMeans(), autotune_probe=True)
            pc.clear()
            cached = MapReduce(apps.KMeans(), autotune_probe=True)
        finally:
            del os.environ[at.TUNE_CACHE_ENV]
    if (probed.tiling.source, cached.tiling.source) != ("probe", "cache"):
        raise AssertionError(f"probe: sources {probed.tiling.source!r}, "
                             f"{cached.tiling.source!r}:\n"
                             f"{probed.explain()}")
    out["probe"] = {"notes": list(probed.tiling.notes),
                    "chunk_pairs": probed.tiling.chunk_pairs,
                    "second_source": cached.tiling.source}
    log(f"probe: {probed.tiling.notes}; second construction "
        f"{cached.tiling.source}")
    pc.clear()
    log(json.dumps({"staged": out}))
    return out


def masked_tail_bits() -> dict:
    """A diagnostic, not a gate: does a chunk folded with its tail masked
    (sentinel keys up to the chunk's capacity, as the reference's padded
    call folds it) keep the short chunk's bits?  B1's sum, KMeans width
    (D = 4 with the counts), at the main path's last chunk and a short
    one.  The port's padded calls never fold a masked tail."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops

    rng = np.random.default_rng(9)
    res = {}
    for n, cap in ((CUDA_CHUNK_PAIRS - 4099, CUDA_CHUNK_PAIRS),
                   (5000, 8192)):
        keys = torch.from_numpy(rng.integers(0, 100, size=cap)
                                .astype(np.int32)).cuda()
        vals = torch.from_numpy(rng.standard_normal((cap, 4))
                                .astype(np.float32)).cuda()
        keys[n:] = 100
        acc = torch.zeros((100, 4), device="cuda")
        short = ops.onehot_fold(keys[:n].contiguous(),
                                vals[:n].contiguous(), acc)
        masked = ops.onehot_fold(keys, vals, acc)
        res[f"n={n} in {cap}"] = bool(torch.equal(bits(short),
                                                  bits(masked)))
    return res


# -- phase 11: the streaming service (A13) ------------------------------------

STREAM_CAP = 1 << 22  # KMeans / BoundingBox points a micro-batch: one chunk
STREAM_KS_CAP = 1 << 19  # KeyedSum items a micro-batch: 2^22 pairs
STREAM_KS_K = 1 << 16
STREAM_RAGGED = (1 << 22, (1 << 22) - 4099, 5000, 1, 0, 1 << 22)
STREAM_WIN_N = 1 << 20  # points a micro-batch of the windowed phases
STREAM_STEADY_INGESTS = 50
STREAM_QUEUE_BATCHES = 30


def window_batch(arrays, i: int):
    """Micro-batch ``i`` of :data:`STREAM_WIN_N` points (views of
    ``arrays``; batch 16 starts over at point 0)."""
    n = STREAM_WIN_N
    lo = (i * n) % N_POINTS
    return tuple(a[lo:lo + n] for a in arrays)


def stream_check(label, res, pts, assign) -> None:
    """Counts exact; KMeans centroids within SUM_RTOL of float64 numpy,
    boxes bit for bit numpy's per-key max/min."""
    want_counts, want = kmeans_centroids(pts, assign)
    if not np.array_equal(res.counts.cpu().numpy(), want_counts):
        raise AssertionError(f"streaming {label}: counts != np.bincount")
    got = res.values.cpu().numpy()
    if label.startswith("bounding_box"):
        if not np.array_equal(got.view(np.uint32),
                              numpy_boxes(pts, assign).view(np.uint32)):
            raise AssertionError(f"streaming {label}: boxes != numpy")
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_RTOL)


def keyed_sum_check(label, res, keys, weights) -> float:
    """KeyedSum: counts equal ``np.bincount``; each key's sum within
    SUM_RTOL of float64 numpy's.  Returns the largest absolute error."""
    k = STREAM_KS_K
    if not np.array_equal(res.counts.cpu().numpy(),
                          np.bincount(keys, minlength=k)):
        raise AssertionError(f"streaming {label}: counts != np.bincount")
    want = np.bincount(keys, weights=weights.astype(np.float64),
                       minlength=k)
    got = res.values.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_RTOL)
    return float(np.abs(got - want).max())


def streaming_parity(label, make, items, cap, item_spec, kernel):
    """(a): ``cap``-item ingests of ``items`` against one batch run whose
    chunk is the micro-batch, bit for bit; the launches and plan shapes of
    ``kernel`` in the ingests alone."""
    import torch
    from repro_torch import ExecutionOptions, MapReduce
    from repro_torch.kernels import ops

    app = make()
    svc = MapReduce(app, streaming=True).serve(batch_capacity=cap,
                                               item_spec=item_spec)
    n = items[0].shape[0]
    batches = [tuple(a[lo:lo + cap] for a in items)
               for lo in range(0, n, cap)]
    torch.cuda.synchronize()
    with fold_shapes() as seen:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for b in batches:
            svc.ingest(b)
        torch.cuda.synchronize()
        ingest_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
    got = svc.snapshot()
    want = MapReduce(make(), flow="stream").run(
        items, options=ExecutionOptions(
            chunk_pairs=cap * max(app.emit_capacity, 1)))
    if not same_bits(got, want):
        raise AssertionError(f"streaming {label}: {len(batches)} ingests != "
                             f"the chunk-aligned batch run")
    if launches[kernel] <= 0:
        raise AssertionError(f"streaming {label}: {kernel} never launched: "
                             f"{launches}")
    return svc, {"ingests": len(batches), "launches": launches[kernel],
                 "plans": sorted(set(seen.get(kernel, []))),
                 "ingests_ms": ingest_ms, "bits_equal": True}


def streaming_on_card(card: str, pts, assign, items) -> dict:
    """Phase 11: ``MapReduce(app, streaming=True).serve(...)`` on the card.
    (a) KMeans and BoundingBox at 2^24 points in four 2^22-point ingests,
    KeyedSum K = 2^16 in four ingests of 2^19 items (2^22 pairs): bit for
    bit with the chunk-aligned batch run, and KeyedSum's snapshot against
    float64 numpy's per-key sums and counts; B1 launches 4 a run (lane
    plan for KMeans, the index-order pass at K = 2^16), B2 8.  (b) Ragged
    micro-batches 2^22, 2^22 - 4099, 5000, 1, 0, 2^22: counts exact, boxes
    bit for bit numpy's, centroids against float64 numpy, a second service
    fed the same batches gives the same bits.  (c) 20 ingests of 2^20
    points under ``sliding(8, 2)``: each snapshot covers exactly the live
    periods; ``tumbling(2)`` drops a key seen only in expired batches.
    (d) Steady state: 50 ingests of one 2^22-point KMeans batch, each
    ending in a synchronize (median and p99 ms, pairs/s), against
    ``run()`` of the batch; host syncs an ingest; device busy share; zero
    derives, tunes, probes and compiles; a second service is a
    compiled-cache hit.  (e) An ``IngestionQueue`` worker folds 30 batches
    of 2^20 points under ``sliding(4, 1)`` while the main thread takes
    snapshots: each covers whole batches, generations are monotone.
    (f) Warm restart: ``ckpt_every=4`` under ``sliding(8, 2)``, a fresh
    service restores step 8 and replays to 12 bit for bit; the newest
    step restores the final tables.  Prints one ``streaming`` line."""
    import os
    import tempfile
    import threading

    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.core import plan_cache as pc
    from repro_torch.core.plan_cache import TensorSpec
    from repro_torch.streaming import IngestionQueue, sliding, tumbling

    from portbench.syncs import host_syncs

    out: dict = {"card": card}
    spec = (TensorSpec((), torch.int32), TensorSpec((3,), torch.float32))

    def serve(make, cap, **kw):
        return MapReduce(make(), streaming=True).serve(
            batch_capacity=cap, item_spec=spec, **kw)

    parity = {}  # (a)
    for label, make, kernel in (("kmeans", apps.KMeans, "onehot_fold"),
                                ("bounding_box", apps.BoundingBox,
                                 "chunk_monoid_fold")):
        _, parity[label] = streaming_parity(label, make, items, STREAM_CAP,
                                            spec, kernel)
    sitems, skeys, sweights = sort_items(STREAM_KS_K)
    ks_svc, parity["keyed_sum_K65536"] = streaming_parity(
        "keyed_sum_K65536", lambda: apps.KeyedSum(STREAM_KS_K), sitems,
        STREAM_KS_CAP, (TensorSpec((8,), torch.int32),
                        TensorSpec((8,), torch.float32)), "onehot_fold")
    # the ingests and the batch run share B1's launches: hold the pair
    # against numpy too, so a wrong kernel at this shape cannot pass
    parity["keyed_sum_K65536"]["max_abs_err_vs_numpy"] = keyed_sum_check(
        "keyed_sum_K65536", ks_svc.snapshot(), skeys, sweights)
    want_launches = {"kmeans": 4, "bounding_box": 8, "keyed_sum_K65536": 4}
    for label, n in want_launches.items():
        if parity[label]["launches"] != n:
            raise AssertionError(f"streaming {label}: {parity[label]} "
                                 f"launches, {n} expected")
    if parity["kmeans"]["plans"] != ["lane"]:
        raise AssertionError(f"streaming kmeans plans {parity['kmeans']}")
    if "lane" in parity["keyed_sum_K65536"]["plans"]:
        raise AssertionError(f"streaming keyed_sum K=2^16 took the lane "
                             f"plan: {parity['keyed_sum_K65536']}")
    out["parity"] = parity
    log(f"streaming parity: KMeans, BoundingBox, KeyedSum K=2^16 ingests "
        f"== chunk-aligned batch runs bit for bit: {parity}")

    ragged = {}  # (b)
    total = sum(STREAM_RAGGED)
    for label, make in (("kmeans", apps.KMeans),
                        ("bounding_box", apps.BoundingBox)):
        snaps = []
        for _ in range(2):
            svc = serve(make, STREAM_CAP)
            lo = 0
            for n in STREAM_RAGGED:
                svc.ingest(tuple(a[lo:lo + n] for a in items))
                lo += n
            snaps.append(svc.snapshot())
        stream_check(f"{label} ragged", snaps[0], pts[:total], assign[:total])
        if not same_bits(snaps[0], snaps[1]):
            raise AssertionError(f"streaming {label} ragged: a second "
                                 f"service gave other bits")
        ragged[label] = {"sizes": list(STREAM_RAGGED), "points": total,
                         "batch_id": snaps[0].batch_id, "repeat_bits": True}
    out["ragged"] = ragged
    log(f"streaming ragged {STREAM_RAGGED}: counts exact, boxes bit for "
        f"bit, centroids within {SUM_RTOL}, repeats bit for bit")

    windows = {}  # (c)
    np_arrays = (assign, pts)
    for label, make in (("kmeans", apps.KMeans),
                        ("bounding_box", apps.BoundingBox)):
        svc = serve(make, STREAM_WIN_N, window=sliding(8, 2))
        checked = []
        for i in range(20):
            svc.ingest(window_batch(items, i))
            b = i + 1
            if b not in (11, 20):
                continue
            p = (b - 1) // 2  # the current slide period
            first = 2 * max(0, p - 3)  # the oldest live period's batch
            live = [window_batch(np_arrays, j) for j in range(first, b)]
            stream_check(f"{label} sliding(8, 2) at batch {b}",
                         svc.snapshot(),
                         np.concatenate([x[1] for x in live]),
                         np.concatenate([x[0] for x in live]))
            checked.append({"batch_id": b, "live_batches": [first, b - 1]})
        windows[label] = checked
    tum = serve(apps.KMeans, STREAM_WIN_N, window=tumbling(2))
    hot = (torch.full((STREAM_WIN_N,), 7, dtype=torch.int32,
                      device=items[0].device),
           items[1][:STREAM_WIN_N])
    cold = (torch.full_like(hot[0], 9), hot[1])
    tum.ingest(hot)
    tum.ingest(hot)
    before = tum.snapshot().counts.cpu().numpy()
    tum.ingest(cold)
    after = tum.snapshot().counts.cpu().numpy()
    if (before[7], after[7], after[9]) != (2 * STREAM_WIN_N, 0,
                                           STREAM_WIN_N):
        raise AssertionError(f"streaming tumbling(2) expiry: key 7 "
                             f"{before[7]} -> {after[7]}, key 9 {after[9]}")
    windows["tumbling_expiry"] = {"key7_before": int(before[7]),
                                  "key7_after": int(after[7]),
                                  "key9_after": int(after[9])}
    out["windows"] = windows
    log(f"streaming windows: {windows}")

    batch = tuple(a[:STREAM_CAP] for a in items)  # (d)
    svc = serve(apps.KMeans, STREAM_CAP)
    svc.ingest(batch)
    torch.cuda.synchronize()
    s0 = pc.stats_snapshot()
    times = []
    for _ in range(STREAM_STEADY_INGESTS):
        t0 = time.perf_counter()
        svc.ingest(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    delta = {k: v - s0[k] for k, v in pc.stats_snapshot().items()}
    if any(delta[k] for k in ("derives", "autotunes", "probes", "compiles")):
        raise AssertionError(f"streaming steady state re-staged: {delta}")
    med = float(np.median(times))
    mr = MapReduce(apps.KMeans())
    mr.lower(batch).compile()
    s1 = pc.stats_snapshot()
    svc2 = serve(apps.KMeans, STREAM_CAP)
    if ("compiled-cache: hit" not in svc2.explain()
            or pc.stats_snapshot()["compiles"] != s1["compiles"]):
        raise AssertionError(f"streaming: a second service compiled "
                             f"again:\n{svc2.explain()}")
    out["steady"] = {
        "ingests": STREAM_STEADY_INGESTS, "pairs_per_ingest": STREAM_CAP,
        "ingest_ms_p50": med, "ingest_ms_p99": float(np.percentile(times,
                                                                   99)),
        "ingest_ms_min": float(min(times)),
        "pairs_per_s": STREAM_CAP / (med / 1e3),
        "run_ms": wall_ms(lambda: mr.run(batch)),
        "host_syncs_per_ingest": host_syncs(lambda: svc.ingest(batch)),
        "profile": profile_fn(lambda: svc.ingest(batch), med, groups={
            "onehot_fold": ("fold_runs", "fold_segments", "merge_segments"),
            "cat": ("catarray",)}),
        "ingest_event_ms": event_ms(lambda: svc.ingest(batch)),
        "stats_delta": delta, "second_service": "hit"}
    prof = out["steady"]["profile"]
    out["steady"]["ingest_device_ms"] = prof["device_ms"]
    log(f"streaming ingest: {STREAM_CAP} KMeans points, device "
        f"{prof['device_ms']:.4f} ms (kernels' sum: B1 "
        f"{prof['groups']['onehot_fold']:.4f} ms, cat "
        f"{prof['groups']['cat']:.4f} ms), first to last op "
        f"{out['steady']['ingest_event_ms']:.4f} ms, wall p50 {med:.4f} ms "
        f"[{card}]")
    log(f"streaming steady state: {out['steady']}\n{svc2.explain()}")

    svc = serve(apps.KMeans, STREAM_WIN_N, window=sliding(4, 1))  # (e)
    q = IngestionQueue(svc, maxsize=4)
    producer = threading.Thread(target=lambda: [
        q.put(window_batch(items, i), timeout=120.0)
        for i in range(STREAM_QUEUE_BATCHES)], daemon=True)
    producer.start()
    deadline = time.monotonic() + 300.0
    seen, snap_ms = [], []
    while (svc.batch_id < STREAM_QUEUE_BATCHES
           and time.monotonic() < deadline):
        if svc.batch_id == 0:
            time.sleep(0.001)
            continue
        t0 = time.perf_counter()
        snap = svc.snapshot()
        covered = int(snap.counts.sum())  # waits for the snapshot's work
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        if covered != min(snap.batch_id, 4) * STREAM_WIN_N:
            raise AssertionError(f"streaming snapshot under ingestion: "
                                 f"{covered} points at batch "
                                 f"{snap.batch_id}")
        seen.append(snap.batch_id)
    producer.join(timeout=120.0)
    q.close()
    final = svc.snapshot()
    if (producer.is_alive() or final.batch_id != STREAM_QUEUE_BATCHES
            or seen != sorted(seen) or not seen
            or int(final.counts.sum()) != 4 * STREAM_WIN_N):
        raise AssertionError(f"streaming queue: final batch "
                             f"{final.batch_id}, generations {seen}")
    out["queue"] = {"batches": STREAM_QUEUE_BATCHES, "snapshots": len(seen),
                    "generations_seen": len(set(seen)),
                    "snapshot_ms_p50": float(np.median(snap_ms)),
                    "snapshot_ms_p99": float(np.percentile(snap_ms, 99)),
                    "snapshot_ms_includes": "the snapshot's merge and "
                    "finalize and the ingest work queued before it on "
                    "the same stream (ends in a sync on counts.sum())",
                    "all_consistent": True}
    log(f"streaming queue: {out['queue']}")

    restart = {}  # (f)
    for label, make in (("kmeans", apps.KMeans),
                        ("bounding_box", apps.BoundingBox)):
        with tempfile.TemporaryDirectory() as d:
            def build():
                return serve(make, STREAM_WIN_N, window=sliding(8, 2),
                             ckpt_dir=d, ckpt_every=4)
            a = build()
            for i in range(12):
                a.ingest(window_batch(items, i))
            want = a.snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = a.checkpoint()
            ckpt_ms = (time.perf_counter() - t0) * 1e3
            b = build()
            t0 = time.perf_counter()
            if b.restore(step=8) != 8:
                raise AssertionError("streaming restore: step 8 expected")
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            for i in range(8, 12):
                b.ingest(window_batch(items, i))
            c = build()
            if c.restore() != 12:
                raise AssertionError("streaming restore: step 12 expected")
            if not (same_bits(b.snapshot(), want)
                    and same_bits(c.snapshot(), want)):
                raise AssertionError(f"streaming {label} restore: other "
                                     f"bits than the unfailed service")
            restart[label] = {
                "checkpoint_ms": ckpt_ms, "restore_ms": restore_ms,
                "checkpoint_bytes": os.path.getsize(
                    os.path.join(path, "arrays.npz")),
                "bits_equal": True}
    out["restart"] = restart
    log(f"streaming restart: {restart}")
    log(json.dumps({"streaming": out}))
    return out


DIST_SHARDS = (1, 2, 4)
DIST_KS_KEYS = (1 << 20, 1 << 22)  # K_local 2^18 (B3) and 2^20 (B4) at S = 4
DIST_WC_TOKENS = 1 << 24
DIST_WC_VOCAB = 1 << 16
DIST_WIRE_SHARDS = 16
DIST_WIRE_PAIRS = 1 << 22
DIST_WIRE_K = 8192  # the reference's wire rows: span 512 at 16 shards
DIST_NOTE = ("the S shards of a LocalMesh run in turn on one card: their "
             "kernels and collectives are on the device, their exchange is a "
             "copy within the card's memory, not a link between cards")


@contextlib.contextmanager
def per_shard_launches():
    """Each shard's kernel launches in the block: the launch counters'
    deltas across every call of the shard bodies' folds (the stream flow's
    ``LocalRun.tables``, the combine flow's ``_combine_local_tables``, the
    sort flow's ``_sort_range_tables``, the reduce flow's
    ``_reduce_range``), one dict a call, in order."""
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops

    seen: list[dict] = []
    names = ("tables", "_combine_local_tables", "_sort_range_tables",
             "_reduce_range")
    owners = (eng.LocalRun, eng, eng, eng)
    saved = [getattr(o, n) for o, n in zip(owners, names)]

    def wrap(fn):
        def call(*args, **kwargs):
            before = ops.launch_counts()
            out = fn(*args, **kwargs)
            after = ops.launch_counts()
            seen.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
            return out
        return call

    for o, n, fn in zip(owners, names, saved):
        setattr(o, n, wrap(fn))
    try:
        yield seen
    finally:
        for o, n, fn in zip(owners, names, saved):
            setattr(o, n, fn)


def dist_run(label, mr, items, opts, kernels, shards, *, profile_it=True):
    """One distributed run of ``mr`` over ``items``: the compiled call
    (staged first), its per-shard launches (each of ``kernels`` on every
    shard), the median wall of 3 and its device time.  Returns
    ``(compiled, result, record)``."""
    import torch

    comp = mr.lower(items, options=opts).compile()
    torch.cuda.synchronize()
    with per_shard_launches() as seen:
        res = comp(items)
        torch.cuda.synchronize()
    if len(seen) != shards:
        raise AssertionError(f"distributed {label}: {len(seen)} shard folds "
                             f"for {shards} shards")
    for name in kernels:
        got = [s.get(name, 0) for s in seen]
        if min(got) <= 0:
            raise AssertionError(f"distributed {label}: {name} did not launch "
                                 f"on every shard: {got}")
    rec = {"shards": shards, "launches_per_shard": seen}
    if profile_it:
        rec["wall_ms"] = wall_ms(lambda: comp(items))
        prof = profile_fn(lambda: comp(items), rec["wall_ms"], top=4)
        rec["device_ms"] = prof["device_ms"]
        rec["busy_share"] = prof["busy_share"]
    log(f"distributed {label}: S={shards} launches/shard {seen}"
        + (f", wall {rec['wall_ms']:.2f} ms, device {rec['device_ms']:.2f} "
           f"ms" if profile_it else ""))
    return comp, res, rec


def merged_bits(label, mr, comp, items, res, flow, combine_impl="auto"):
    """The distributed result is ``engine.merge_partial_tables`` over the
    shards' own partial tables (the stream flow's ``LocalRun.tables`` at
    the run's tiling, the combine flow's shard fold), bit for bit."""
    import torch
    from repro_torch.core import engine as eng

    run = comp._entry.executable
    blocks = eng.shard_items(items, run.mesh.size)
    parts = []
    for b in blocks:
        if flow == "stream":
            lr = eng.LocalRun(mr.app, "stream", mr.plan.spec, device="cuda",
                              use_kernels=True, chunk_pairs=run.chunk_pairs,
                              key_block=run.key_block)
            parts.append(lr.tables(b)[1:])
        else:
            parts.append(eng._combine_local_tables(
                mr.app, mr.plan.spec, eng.map_phase(mr.app, b,
                                                    torch.device("cuda")),
                combine_impl=combine_impl, use_kernels=True))
    k, v, c = eng.merge_partial_tables(mr.app, mr.plan.spec,
                                       [p[0] for p in parts],
                                       [p[1] for p in parts])
    if not (torch.equal(res.counts, c) and torch.equal(bits(res.values),
                                                       bits(v))):
        raise AssertionError(f"distributed {label}: != merge_partial_tables "
                             f"over the shards' tables")


def dist_kmeans(pts, assign, items, rows: dict, launches: dict) -> None:
    """KMeans (B1) at S = 1, 2, 4 and key-sharded at 4; BoundingBox (B2);
    the combine flow, one-hot (B6) and scatter (B7)."""
    from repro_torch import ExecutionOptions, MapReduce, apps
    from repro_torch.distributed import LocalMesh

    want_counts, want = kmeans_centroids(pts, assign)
    boxes = numpy_boxes(pts, assign)
    replicated = None
    for S in DIST_SHARDS:
        mr = MapReduce(apps.KMeans())
        label = f"kmeans_stream_S{S}"
        comp, res, rows[label] = dist_run(
            label, mr, items, ExecutionOptions(mesh=LocalMesh(S)),
            ["onehot_fold"], S)
        launches[label] = rows[label]["launches_per_shard"]
        np.testing.assert_array_equal(res.counts.cpu().numpy(), want_counts)
        np.testing.assert_allclose(res.values.cpu().numpy(), want,
                                   rtol=SUM_RTOL, atol=SUM_RTOL)
        merged_bits(label, mr, comp, items, res, "stream")
        replicated = res
    mr = MapReduce(apps.KMeans())
    comp, res, rec = dist_run(
        "kmeans_stream_S4_scatter", mr, items,
        ExecutionOptions(mesh=LocalMesh(4), scatter_output=True),
        ["onehot_fold"], 4, profile_it=False)
    if not same_bits(res, replicated):
        raise AssertionError("distributed KMeans scatter_output != the "
                             "replicated result")
    rows["kmeans_stream_S4_scatter"] = {"bits_equal_replicated": True}
    mr = MapReduce(apps.BoundingBox())
    local = mr.run(items)
    comp, res, rows["bbox_stream_S4"] = dist_run(
        "bbox_stream_S4", mr, items, ExecutionOptions(mesh=LocalMesh(4)),
        ["chunk_monoid_fold"], 4)
    launches["bbox_stream_S4"] = rows["bbox_stream_S4"]["launches_per_shard"]
    if not (np.array_equal(res.values.cpu().numpy().view(np.uint32),
                           boxes.view(np.uint32))
            and same_bits(res, local)):
        raise AssertionError("distributed BoundingBox != numpy / local run")
    merged_bits("bbox_stream_S4", mr, comp, items, res, "stream")
    for impl, kernel in (("onehot", "onehot_combine"),
                         ("scatter", "combine_scatter")):
        label = f"kmeans_combine_{impl}_S4"
        mr = MapReduce(apps.KMeans(), flow="combine", combine_impl=impl)
        comp, res, rows[label] = dist_run(
            label, mr, items, ExecutionOptions(mesh=LocalMesh(4)), [kernel],
            4)
        launches[label] = rows[label]["launches_per_shard"]
        np.testing.assert_array_equal(res.counts.cpu().numpy(), want_counts)
        np.testing.assert_allclose(res.values.cpu().numpy(), want,
                                   rtol=SUM_RTOL, atol=SUM_RTOL)
        merged_bits(label, mr, comp, items, res, "combine", impl)


def dist_keyed_sum(rows: dict, launches: dict, exchange: dict) -> None:
    """KeyedSum, 2^24 pairs, sort flow at S = 4: K = 2^20 (B3 + B5 on each
    shard's 2^18 keys) and K = 2^22 (B4 + B5 on 2^20): counts exact, sums
    against float64 numpy, delta bit for bit with raw, the encoded bytes a
    shard equal to the roofline's model, and the exchange's stages timed."""
    import torch
    from repro_torch import ExecutionOptions, MapReduce, ShuffleOptions, apps
    from repro_torch.distributed import LocalMesh
    from repro_torch.roofline import analysis as roofline

    for k in DIST_KS_KEYS:
        items, keys, weights = sort_items(k)
        part = ("radix_partition" if k == DIST_KS_KEYS[0]
                else "radix_partition_multi")
        results = {}
        for codec in ("raw", "delta"):
            label = f"keyed_sum_K{k}_sort_S4_{codec}"
            mr = MapReduce(apps.KeyedSum(k), flow="sort")
            comp, res, rec = dist_run(
                label, mr, items, ExecutionOptions(
                    mesh=LocalMesh(4), shuffle=ShuffleOptions(
                        wire=codec, strict=True)),
                [part, "segment_reduce"], 4, profile_it=codec == "raw")
            rows[label] = rec
            launches[label] = rec["launches_per_shard"]
            np.testing.assert_array_equal(res.counts[:k].cpu().numpy(),
                                          np.bincount(keys, minlength=k))
            want = np.bincount(keys, weights=weights.astype(np.float64),
                               minlength=k)
            got = res.values[:k].cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=SUM_RTOL,
                                       atol=SUM_RTOL)
            rec["max_abs_err"] = float(np.abs(got - want).max())
            run = comp._entry.executable
            model = roofline.shuffle_wire_bytes(
                codec, n_pairs=keys.size, key_space=k, num_shards=4,
                value_bytes=4, value_dtype="float32")
            measured = run.last_exchange["sent_bytes"] * 3 / 4
            if measured != model:
                raise AssertionError(f"distributed {label}: wire bytes "
                                     f"{measured} != model {model}")
            rec["wire_bytes_per_shard"] = measured
            results[codec] = res
            if codec == "raw" and k == DIST_KS_KEYS[0]:
                run.time_exchange = True
                stages = []
                for _ in range(3):
                    comp(items)
                    stages.append(dict(run.last_exchange["seconds"]))
                run.time_exchange = False
                a2a = float(np.median([st["all_to_all"] for st in stages]))
                sent = run.last_exchange["sent_bytes"]
                exchange.update({
                    "run": label, "encoded_bytes_per_shard": sent,
                    "wire_bytes_per_shard": measured,
                    "stage_ms": {st: float(np.median(
                        [x[st] for x in stages])) * 1e3
                        for st in stages[0]},
                    "all_to_all_ms": a2a * 1e3,
                    # S shards' sends over the exchange's wall: the rate
                    # the cuda profile's wire term divides by
                    "bytes_per_s": 4 * measured / a2a,
                    "what": "LocalMesh all-to-all: a copy within one "
                            "card's memory, no link"})
        if not same_bits(results["raw"], results["delta"]):
            raise AssertionError(f"KeyedSum K={k}: delta != raw")
        torch.cuda.synchronize()


def dist_wire_gate(rows: dict) -> None:
    """The reference's wire gate (``bench_flow_sweep --wire``) at 2^22
    pairs over 16 shards: sorted Zipf(1.1) keys over K = 8192, int16
    values, capacity a shard's pairs; delta bit for bit with raw and the
    counts of numpy; delta's measured bytes a shard <= 0.6x raw's and
    equal to the model."""
    import torch
    from repro_torch import (ExecutionOptions, MapReduce, ShuffleOptions,
                             ValueSpec, make_app)
    from repro_torch.distributed import LocalMesh
    from repro_torch.roofline import analysis as roofline

    S, n, k = DIST_WIRE_SHARDS, DIST_WIRE_PAIRS, DIST_WIRE_K
    keys = np.sort((np.random.default_rng(3).zipf(1.1, size=n) % k)
                   .astype(np.int32))
    items = torch.from_numpy(keys.reshape(-1, 8)).cuda()
    per = n // S
    app = make_app(lambda item, emit: emit(item, (item % 1000).to(
                       torch.int16)),
                   lambda kk, v, c: v.amax(), key_space=k,
                   value_spec=ValueSpec((), torch.int16), emit_capacity=8)
    out, nbytes = {}, {}
    for codec in ("raw", "delta"):
        mr = MapReduce(app, flow="sort")
        comp = mr.lower(items, options=ExecutionOptions(
            mesh=LocalMesh(S), shuffle=ShuffleOptions(
                wire=codec, capacity=per, strict=True))).compile()
        t0 = time.perf_counter()
        out[codec] = comp(items)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        run = comp._entry.executable
        nbytes[codec] = run.last_exchange["sent_bytes"] * (S - 1) / S
        model = roofline.shuffle_wire_bytes(
            codec, n_pairs=n, key_space=k, num_shards=S, value_bytes=2,
            value_dtype="int16", capacity=per)
        if nbytes[codec] != model:
            raise AssertionError(f"wire gate {codec}: {nbytes[codec]} bytes "
                                 f"!= model {model}")
        rows[f"wire_gate_{codec}_ms"] = ms
    if not same_bits(out["raw"], out["delta"]):
        raise AssertionError("wire gate: delta != raw")
    np.testing.assert_array_equal(out["delta"].counts[:k].cpu().numpy(),
                                  np.bincount(keys, minlength=k))
    ratio = nbytes["delta"] / nbytes["raw"]
    if ratio > 0.6:
        raise AssertionError(f"wire gate: delta {ratio:.3f}x raw > 0.6x")
    rows["wire_gate"] = {"shards": S, "pairs": n, "key_space": k,
                         "bytes_per_shard": nbytes, "delta_over_raw": ratio}
    log(f"distributed wire gate: S={S} delta/raw {ratio:.3f}")


def dist_wordcount(rows: dict) -> dict:
    """WordCount on zipf text, 2^24 tokens over 2^16 words, reduce and
    sort flows at S = 4: ``skew="off"`` (capacity a shard's pairs) and
    ``skew="auto"`` (balanced boundaries; a hot key split on the sort
    flow), counts exact against ``np.bincount`` and bit for bit between
    the two; nothing overflows under ``strict``; the default capacity
    overflows, which raises under ``strict`` and otherwise warns and lands
    in ``plan.diagnostics``."""
    import warnings

    import torch
    from repro_torch import (ExecutionOptions, LoweringFallbackWarning,
                             MapReduce, ShuffleOptions, apps)
    from repro_torch.core import skew
    from repro_torch.data import datasets
    from repro_torch.distributed import LocalMesh

    toks, vocab = datasets.wordcount_data(
        np.random.default_rng(6), tokens=DIST_WC_TOKENS, vocab=DIST_WC_VOCAB)
    items = torch.from_numpy(toks.reshape(-1, 16)).cuda()
    want = np.bincount(toks, minlength=vocab)
    per = DIST_WC_TOKENS // 4
    overflow = {}
    for flow in ("reduce", "sort"):
        got = {}
        for mode, sh in (("off", ShuffleOptions(capacity=per, strict=True)),
                         ("auto", ShuffleOptions(skew="auto", strict=True))):
            label = f"wordcount_{flow}_S4_skew_{mode}"
            mr = MapReduce(apps.WordCount(vocab), flow=flow)
            comp, res, rows[label] = dist_run(
                label, mr, items, ExecutionOptions(mesh=LocalMesh(4),
                                                   shuffle=sh), [], 4)
            counts = res.counts.cpu().numpy()[:vocab]
            np.testing.assert_array_equal(counts, want)
            got[mode] = res
            if mode == "auto":
                text = mr.explain()
                if "skew: boundaries: 4 ranges" not in text or (
                        flow == "sort" and "hot keys split" not in text):
                    raise AssertionError(f"{label}: no skew plan:\n{text}")
                rows[label]["skew"] = list(mr.plan.skew)
        if not (torch.equal(got["off"].counts[:vocab], got["auto"].counts)
                and torch.equal(got["off"].values[:vocab],
                                got["auto"].values)):
            raise AssertionError(f"WordCount {flow}: skew auto != off")
        mr = MapReduce(apps.WordCount(vocab), flow=flow)
        try:
            mr.run_distributed(items, mesh=LocalMesh(4), options=(
                ExecutionOptions(shuffle=ShuffleOptions(strict=True))))
            raise AssertionError(f"WordCount {flow}: strict overflow did "
                                 f"not raise")
        except ValueError as e:
            if "shuffle overflow" not in str(e):
                raise
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = mr.run_distributed(items, mesh=LocalMesh(4))
        warned = [x for x in w
                  if issubclass(x.category, LoweringFallbackWarning)
                  and "overflow" in str(x.message)]
        diag = [d for d in res.diagnostics if "shuffle overflow" in d]
        if not (warned and diag):
            raise AssertionError(f"WordCount {flow}: overflow not reported")
        overflow[flow] = {"strict": "raised", "warned": len(warned),
                          "dropped_pairs": int(DIST_WC_TOKENS
                                               - res.counts.sum().item())}
    overflow["skew_stats"] = skew.stats_snapshot()
    return overflow


def dist_process_group_nccl(items, rows: dict) -> None:
    """``ProcessGroupMesh`` over NCCL at world size 1 on the card: its
    collectives launch on the card, and KMeans (stream) and KeyedSum
    K = 2^20 (sort) equal ``LocalMesh(1)`` bit for bit.  More ranks need
    a card each."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch import ExecutionOptions, MapReduce, apps
    from repro_torch.distributed import LocalMesh, ProcessGroupMesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = ProcessGroupMesh()
        kitems = sort_items(DIST_KS_KEYS[0])[0]
        for label, make, flow, its in (
                ("kmeans_stream", apps.KMeans, "stream", items),
                ("keyed_sum_sort", lambda: apps.KeyedSum(DIST_KS_KEYS[0]),
                 "sort", kitems)):
            pg = MapReduce(make(), flow=flow).run_distributed(
                its, mesh=mesh).gather_result()
            lo = MapReduce(make(), flow=flow).run_distributed(
                its, mesh=LocalMesh(1))
            if not same_bits(pg, lo):
                raise AssertionError(f"NCCL world 1 {label} != LocalMesh(1)")
            rows[f"nccl_world1_{label}"] = {"bits_equal_local_mesh": True,
                                            "backend": mesh.backend}
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    log("distributed: ProcessGroupMesh over NCCL, world 1: bit for bit")


def dist_repeat(items) -> dict:
    """A second ``compile()`` of the same distributed plan is a cache hit:
    no derive, tune or compile."""
    from repro_torch import ExecutionOptions, MapReduce, apps
    from repro_torch.core import plan_cache as pc
    from repro_torch.distributed import LocalMesh

    opts = ExecutionOptions(mesh=LocalMesh(4))
    MapReduce(apps.KMeans()).lower(items, options=opts).compile()
    before = pc.stats_snapshot()
    comp = MapReduce(apps.KMeans()).lower(items, options=opts).compile()
    delta = {k: v - before[k] for k, v in pc.stats_snapshot().items()}
    if comp.cache_event != "hit" or any(
            delta[k] for k in ("derives", "autotunes", "compiles")):
        raise AssertionError(f"distributed repeat compile: "
                             f"{comp.cache_event}, deltas {delta}")
    return {"cache_event": comp.cache_event, "deltas": delta}


def distributed_on_card(card: str, pts, assign, items) -> dict:
    """Phase 12: distribution on the card (``LocalMesh(S)``; see the
    module docstring).  Returns the ``distributed`` line's record; its
    ``launches`` map each run to its per-shard kernel launches."""
    t0 = time.perf_counter()
    rows: dict = {}
    launches: dict = {}
    exchange: dict = {}
    dist_kmeans(pts, assign, items, rows, launches)
    dist_keyed_sum(rows, launches, exchange)
    dist_wire_gate(rows)
    overflow = dist_wordcount(rows)
    dist_process_group_nccl(items, rows)
    repeat = dist_repeat(items)
    return {"card": card, "note": DIST_NOTE, "runs": rows,
            "exchange": exchange, "overflow": overflow, "repeat": repeat,
            "launches": launches,
            "phase_wall_s": time.perf_counter() - t0}


RES_HOSTS = 4
RES_DRILL_SHARDS = 8
RES_NOTE = ("run_resilient drives every shard in this process on the card "
            "(C.48); a drill's hosts are ranks of the stateless assignment, "
            "its clock synthetic: a wall here is the card's and the host's "
            "work, with no network and no sleep")


@contextlib.contextmanager
def partial_launches():
    """The kernel launches of each shard partial the block computes
    (``DistributedRun.shard_partial``) and of each phase B of the reduce
    and sort flows (``DistributedRun.shuffle_receive``), a dict of launch
    deltas a call, in order."""
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops

    rec: dict = {"partials": [], "phase_b": []}
    cls = eng.DistributedRun
    saved = {"partials": cls.shard_partial, "phase_b": cls.shuffle_receive}

    def wrap(fn, key):
        def call(self, *args, **kwargs):
            before = ops.launch_counts()
            out = fn(self, *args, **kwargs)
            after = ops.launch_counts()
            rec[key].append({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
            return out
        return call

    cls.shard_partial = wrap(saved["partials"], "partials")
    cls.shuffle_receive = wrap(saved["phase_b"], "phase_b")
    try:
        yield rec
    finally:
        cls.shard_partial = saved["partials"]
        cls.shuffle_receive = saved["phase_b"]


def summed(dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def resilient_call(label, fn, kernels, *, dropped: int = 0,
                   phase_b: dict | None = None):
    """One resilient run ``fn()`` with its launches accounted: the shard
    partials it computed must be the calls its log accounts for (computed,
    recomputed, speculated, and ``dropped``, a partitioned host's work),
    each with the same launches, and every launch of the run a partial's
    or phase B's (``phase_b``: the fault-free run's, when given); each of
    ``kernels`` launched.  Returns ``(result, record)``."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    with partial_launches() as rec:
        ops.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        total = {k: v for k, v in ops.launch_counts().items() if v}
    log = res.recovery
    calls = (len(log.computed) + len(log.recomputed) + len(log.speculated)
             + dropped)
    parts = rec["partials"]
    if len(parts) != calls:
        raise AssertionError(f"resilient {label}: {len(parts)} shard partials "
                             f"computed, the log accounts for {calls}")
    per = parts[0] if parts else {}
    if any(p != per for p in parts):
        raise AssertionError(f"resilient {label}: partials launched "
                             f"differently: {parts}")
    got_b = summed(rec["phase_b"])
    if phase_b is not None and got_b != phase_b:
        raise AssertionError(f"resilient {label}: phase B launched {got_b}, "
                             f"the fault-free run {phase_b}")
    for name in set(total) | set(per) | set(got_b):
        want = calls * per.get(name, 0) + got_b.get(name, 0)
        if total.get(name, 0) != want:
            raise AssertionError(
                f"resilient {label}: {name} launched {total.get(name, 0)} "
                f"times, {calls} partials x {per.get(name, 0)} + phase B "
                f"{got_b.get(name, 0)} = {want}")
    for name in kernels:
        if total.get(name, 0) <= 0:
            raise AssertionError(f"resilient {label}: {name} never launched")
    return res, {"partial_calls": calls, "launches_per_partial": per,
                 "phase_b_launches": got_b, "launches": total}


def resilient_clean(label, make_mr, items, S, kernels, check, rows,
                    launches, opts=None):
    """(a) The fault-free ``run_resilient`` over ``RES_HOSTS`` hosts and S
    shards: bit for bit ``run_distributed(LocalMesh(S))``, ``check``
    (numpy's counts, max/min, sums), launches accounted, and both walls
    (median of 3)."""
    import dataclasses

    import torch
    from repro_torch import ExecutionOptions
    from repro_torch.distributed import LocalMesh

    base = opts or ExecutionOptions()
    ropts = dataclasses.replace(base, num_hosts=RES_HOSTS, num_shards=S)
    mr = make_mr()
    res, rec = resilient_call(
        label, lambda: mr.run_resilient(items, options=ropts), kernels)
    dmr = make_mr()
    dopts = dataclasses.replace(base, mesh=LocalMesh(S))
    dist = dmr.run_distributed(items, options=dopts)
    if not (same_bits(res, dist) and torch.equal(res.keys, dist.keys)):
        raise AssertionError(f"resilient {label}: != run_distributed bits")
    if len(res.recovery.computed) != S or res.recovery.recomputed:
        raise AssertionError(f"resilient {label}: fault-free log "
                             f"{res.recovery.summary()}")
    check(res)
    rec["wall_ms"] = wall_ms(lambda: mr.run_resilient(items, options=ropts))
    rec["distributed_wall_ms"] = wall_ms(
        lambda: dmr.run_distributed(items, options=dopts))
    rec["over_distributed"] = rec["wall_ms"] / rec["distributed_wall_ms"]
    rec["shards"], rec["hosts"] = S, RES_HOSTS
    rows[label] = rec
    launches[label] = rec["launches"]
    log(f"resilient {label}: S={S} bit for bit run_distributed, launches "
        f"{rec['launches']} ({rec['partial_calls']} partials x "
        f"{rec['launches_per_partial']}), wall {rec['wall_ms']:.2f} ms vs "
        f"distributed {rec['distributed_wall_ms']:.2f} ms")
    return mr, res, rec


def kmeans_checks(pts, assign):
    """``check`` functions of the KMeans points: counts exact, centroids
    within SUM_RTOL of float64 numpy; boxes bit for bit numpy's."""
    want_counts, want = kmeans_centroids(pts, assign)
    boxes = numpy_boxes(pts, assign)

    def centroids(res):
        np.testing.assert_array_equal(res.counts.cpu().numpy(), want_counts)
        np.testing.assert_allclose(res.values.cpu().numpy(), want,
                                   rtol=SUM_RTOL, atol=SUM_RTOL)

    def bbox(res):
        np.testing.assert_array_equal(res.counts.cpu().numpy(), want_counts)
        if not np.array_equal(res.values.cpu().numpy().view(np.uint32),
                              boxes.view(np.uint32)):
            raise AssertionError("resilient BoundingBox != numpy max/min")

    return centroids, bbox


def keyed_sum_numpy_check(k, keys, weights):
    counts = np.bincount(keys, minlength=k)
    want = np.bincount(keys, weights=weights.astype(np.float64), minlength=k)

    def check(res):
        np.testing.assert_array_equal(res.counts[:k].cpu().numpy(), counts)
        np.testing.assert_allclose(res.values[:k].cpu().numpy(), want,
                                   rtol=SUM_RTOL, atol=SUM_RTOL)
    return check


def resilient_fault_free(pts, assign, items, rows, launches) -> None:
    """(a): KMeans stream S = 4, 8 (B1); BoundingBox S = 8 (B2); the
    KMeans combine flow one-hot (B6) and scatter (B7), S = 4; KeyedSum
    sort S = 4 at K = 2^20 (B3 + B5) and 2^22 (B4 + B5), raw and delta;
    WordCount on zipf text, sort, S = 4, skew="auto" (hot split)."""
    import torch
    from repro_torch import ExecutionOptions, MapReduce, ShuffleOptions, apps
    from repro_torch.data import datasets

    centroids, bbox = kmeans_checks(pts, assign)
    for S in (4, RES_DRILL_SHARDS):
        resilient_clean(f"kmeans_stream_S{S}", lambda: MapReduce(
            apps.KMeans()), items, S, ["onehot_fold"], centroids, rows,
            launches)
    resilient_clean(f"bbox_stream_S{RES_DRILL_SHARDS}",
                    lambda: MapReduce(apps.BoundingBox()), items,
                    RES_DRILL_SHARDS, ["chunk_monoid_fold"], bbox, rows,
                    launches)
    for impl, kernel in (("onehot", "onehot_combine"),
                         ("scatter", "combine_scatter")):
        resilient_clean(f"kmeans_combine_{impl}_S4", lambda impl=impl:
                        MapReduce(apps.KMeans(), flow="combine",
                                  combine_impl=impl), items, 4, [kernel],
                        centroids, rows, launches)
    for k in DIST_KS_KEYS:
        kitems, keys, weights = sort_items(k)
        part = ("radix_partition" if k == DIST_KS_KEYS[0]
                else "radix_partition_multi")
        for codec in ("raw", "delta"):
            resilient_clean(
                f"keyed_sum_K{k}_sort_S4_{codec}",
                lambda k=k: MapReduce(apps.KeyedSum(k), flow="sort"), kitems,
                4, [part, "segment_reduce"],
                keyed_sum_numpy_check(k, keys, weights), rows, launches,
                ExecutionOptions(shuffle=ShuffleOptions(wire=codec,
                                                        strict=True)))
        del kitems
        torch.cuda.empty_cache()
    toks, vocab = datasets.wordcount_data(
        np.random.default_rng(6), tokens=DIST_WC_TOKENS, vocab=DIST_WC_VOCAB)
    witems = torch.from_numpy(toks.reshape(-1, 16)).cuda()
    want = np.bincount(toks, minlength=vocab)

    def wc_check(res):
        np.testing.assert_array_equal(res.counts.cpu().numpy(), want)
        np.testing.assert_array_equal(res.values.cpu().numpy(), want)
        if not any("hot keys split" in x for x in res.recovery.skew_plan):
            raise AssertionError("resilient WordCount: no hot-key split")

    resilient_clean("wordcount_sort_S4_skew_auto", lambda: MapReduce(
        apps.WordCount(vocab), flow="sort"), witems, 4, [], wc_check, rows,
        launches, ExecutionOptions(shuffle=ShuffleOptions(skew="auto",
                                                          strict=True)))


def drill_scripts():
    """(b): label -> (options of the drill, shards, the log's expected
    values, partitioned hosts' dropped partials).  ``ckpt_dir`` and
    ``coord`` are filled in a fresh temp dir each run."""
    from repro_torch.distributed import (ChaosPlan, FaultInjection,
                                         RetryPolicy)
    S = RES_DRILL_SHARDS

    def recomputed(log):
        return [s for s, _ in log.recomputed]

    return {
        "kill_host": (dict(inject=FaultInjection(dead_hosts=(2,))), S,
                      lambda log: log.recomputed == [(2, 3), (6, 3)], 0),
        "ckpt_restore": (dict(ckpt=True, inject=FaultInjection(
            dead_hosts=(1,), die_after_shards=1)), S,
            lambda log: log.restored == [1] and log.recomputed == [(5, 2)],
            0),
        "dead_disk": (dict(ckpt=True, inject=FaultInjection(
            dead_hosts=(1,), die_after_shards=1, checkpoint_survives=False)),
            S, lambda log: not log.restored and recomputed(log) == [1, 5],
            0),
        "straggler_S4": (dict(inject=FaultInjection(straggler_hosts=(1,))),
                         4, lambda log: log.speculated == [(1, 2)], 0),
        "elastic_4_to_3": (dict(mesh=True, inject=FaultInjection(
            resize_to=3)), 4, lambda log: (
                recomputed(log) == [3] and log.resized == (4, 3)
                and log.final_mesh.kind == "local"
                and log.final_mesh.size == 3), 0),
        "chaos": (dict(ckpt=True, coord=True, retry=RetryPolicy(
            max_attempts=4, base_delay_s=0.01), chaos=ChaosPlan()
            .kill_coordinator(after=1).corrupt_checkpoint(5).partition(3)
            .delay_store(2)), S, lambda log: (
                log.failover == (0, 1, 2) and log.corrupt == [5]
                and log.partitioned == [3] and 3 in log.dead_hosts
                and sum("backing off" in e for e in log.store_events) == 2),
            2),
    }


def drill_fn(mr, items, script, S, tmp_root):
    """``fn()`` that runs the drill in a fresh directory under
    ``tmp_root``: its ``ckpt_dir`` and, for chaos, a ``FileKVStore``."""
    import os
    import shutil
    import tempfile

    from repro_torch import ExecutionOptions
    from repro_torch.distributed import FileKVStore, LocalMesh

    def fn(keep=None):
        d = tempfile.mkdtemp(dir=tmp_root)
        kw = {k: v for k, v in script.items()
              if k not in ("ckpt", "coord", "mesh")}
        if script.get("ckpt"):
            kw["ckpt_dir"] = d
        if script.get("coord"):
            kw["coord"] = FileKVStore(os.path.join(d, "coord"))
        mesh = LocalMesh(S) if script.get("mesh") else None
        if mesh is None:
            kw.update(num_hosts=RES_HOSTS, num_shards=S)
        res = mr.run_resilient(items, mesh=mesh,
                               options=ExecutionOptions(**kw))
        if keep is not None:
            keep.append(d)
        else:
            shutil.rmtree(d)
        return res

    return fn


def resilient_drills(label, make_mr, items, kernels, clean_rows, rows,
                     launches, tmp_root) -> None:
    """(b) on one app: each drill bit for bit its fault-free run, the
    log's expected values, launches accounted (phase B the fault-free
    run's), a chaos drill's quarantined ``*.corrupt``; wall (median of 3),
    device time and busy share."""
    import os
    import shutil

    from repro_torch.checkpoint import ckpt

    clean = {}
    for name, (script, S, expect, dropped) in drill_scripts().items():
        mr = make_mr()
        fn = drill_fn(mr, items, script, S, tmp_root)
        base_label = f"{label}_S{S}"
        if S not in clean:
            clean[S] = mr.run_resilient(items, options=_res_opts(S))
        dirs: list = []
        res, rec = resilient_call(
            f"{base_label} {name}", lambda: fn(dirs), kernels,
            dropped=dropped,
            phase_b=clean_rows[base_label]["phase_b_launches"])
        if not same_bits(res, clean[S]):
            raise AssertionError(f"resilient {label} {name}: != fault-free")
        if not expect(res.recovery):
            raise AssertionError(f"resilient {label} {name}: log "
                                 f"{res.recovery.summary()}")
        if name == "chaos" and not os.path.isdir(os.path.join(
                ckpt.shard_partial_dir(dirs[0], 5), "step_0.corrupt")):
            raise AssertionError(f"resilient {label} chaos: no *.corrupt")
        for d in dirs:
            shutil.rmtree(d)
        rec["wall_ms"] = wall_ms(fn)
        prof = profile_fn(fn, rec["wall_ms"], top=4)
        rec["device_ms"] = prof["device_ms"]
        rec["busy_share"] = prof["busy_share"]
        rec["summary"] = list(res.recovery.summary())
        rows[f"{label}_{name}"] = rec
        launches[f"{label}_{name}"] = rec["launches"]
        log(f"resilient drill {label} {name}: bit for bit, "
            f"{rec['partial_calls']} partials, wall {rec['wall_ms']:.2f} ms, "
            f"device {rec['device_ms']:.2f} ms, busy "
            f"{rec['busy_share']:.3f}")


def _res_opts(S):
    from repro_torch import ExecutionOptions
    return ExecutionOptions(num_hosts=RES_HOSTS, num_shards=S)


def recover_one_shard(label, mr, items, S, tmp_root) -> dict:
    """(c) The time to recover one shard: recompute its partial, or
    restore its checkpoint (read, verify, to the card); and a checkpoint's
    ms and bytes."""
    import os
    import tempfile

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import engine as eng
    from repro_torch.distributed import wire as wirelib

    comp = mr.lower(items, mode="resilient", options=_res_opts(S)).compile()
    n = eng.items_length(items)
    run = comp._entry.executable.prepared(n)
    per = n // S
    block = eng.shard_items(items, S)[1]
    p = run.shard_partial(1, block)
    d = tempfile.mkdtemp(dir=tmp_root)
    save_ms = wall_ms(lambda: ckpt.save(d, 0, p))
    disk = os.path.getsize(os.path.join(d, "step_0", "arrays.npz"))

    def restore():
        tree, _ = ckpt.restore(d, p, step=0, device="cpu")
        return eng._partial_to(tree, torch.device("cuda"))

    got = restore()
    if not all(np.array_equal(a.cpu().numpy(), b.cpu().numpy()) for a, b in
               zip(ckpt.flatten(got)[0], ckpt.flatten(p)[0])):
        raise AssertionError(f"resilient {label}: restored partial differs")
    out = {"shards": S, "items_per_shard": per,
           "recompute_ms": wall_ms(lambda: run.shard_partial(1, block)),
           "restore_ms": wall_ms(restore), "checkpoint_ms": save_ms,
           "partial_bytes": wirelib.tree_nbytes(p), "checkpoint_bytes": disk}
    log(f"resilient {label}: recover one shard of S={S}: recompute "
        f"{out['recompute_ms']:.2f} ms, restore {out['restore_ms']:.2f} ms; "
        f"checkpoint {save_ms:.2f} ms, {disk} B on disk")
    return out


def resilient_epoch_reject(kitems, tmp_root) -> dict:
    """A partial checkpointed under the delta codec is rejected by its wire
    epoch under raw and recomputed, bit for bit the fault-free run."""
    import tempfile

    from repro_torch import ExecutionOptions, MapReduce, ShuffleOptions, apps
    from repro_torch.distributed import FaultInjection

    k = DIST_KS_KEYS[0]
    d = tempfile.mkdtemp(dir=tmp_root)
    S = RES_DRILL_SHARDS
    mr = MapReduce(apps.KeyedSum(k), flow="sort")
    mr.run_resilient(kitems, options=ExecutionOptions(
        num_hosts=RES_HOSTS, num_shards=S, ckpt_dir=d,
        shuffle=ShuffleOptions(wire="delta")))
    res = mr.run_resilient(kitems, options=ExecutionOptions(
        num_hosts=RES_HOSTS, num_shards=S, ckpt_dir=d,
        inject=FaultInjection(dead_hosts=(3,))))
    log_ = res.recovery
    if log_.epoch_rejects != [3, 7] or log_.restored:
        raise AssertionError(f"resilient epoch reject: {log_.summary()}")
    if not same_bits(res, mr.run_resilient(kitems, options=_res_opts(S))):
        raise AssertionError("resilient epoch reject: != fault-free")
    return {"epoch_rejects": log_.epoch_rejects,
            "recomputed": log_.recomputed}


def resilient_repeat(items) -> dict:
    """(d) A repeat ``run_resilient`` derives, tunes and compiles
    nothing."""
    from repro_torch import MapReduce, apps
    from repro_torch.core import plan_cache as pc

    mr = MapReduce(apps.KMeans())
    mr.run_resilient(items, options=_res_opts(4))
    before = pc.stats_snapshot()
    mr.run_resilient(items, options=_res_opts(4))
    delta = {k: v - before[k] for k, v in pc.stats_snapshot().items()}
    if any(delta[k] for k in ("derives", "autotunes", "compiles")):
        raise AssertionError(f"resilient repeat: deltas {delta}")
    return {"deltas": delta}


def resilient_on_card(card: str, pts, assign, items) -> dict:
    """Phase 13: resilience on the card (see the module docstring).
    Returns the ``resilient`` line's record; its ``launches`` map each run
    to its kernel launches."""
    import shutil
    import tempfile

    import torch
    from repro_torch import MapReduce, apps

    t0 = time.perf_counter()
    rows: dict = {}
    launches: dict = {}
    tmp_root = tempfile.mkdtemp(prefix="resilient_")
    try:
        resilient_fault_free(pts, assign, items, rows, launches)
        drills: dict = {}
        kitems = sort_items(DIST_KS_KEYS[0])[0]
        k = DIST_KS_KEYS[0]
        apps_ = (("kmeans", lambda: MapReduce(apps.KMeans()), items,
                  ["onehot_fold"]),
                 (f"keyed_sum_K{k}_sort", lambda: MapReduce(
                     apps.KeyedSum(k), flow="sort"), kitems,
                  ["radix_partition", "segment_reduce"]))
        for label, make, its, kernels in apps_:
            clean_rows: dict = {}
            for S in (4, RES_DRILL_SHARDS):
                resilient_clean(f"{label}_S{S}", make, its, S, kernels,
                                lambda res: None, clean_rows, {})
            resilient_drills(label, make, its, kernels, clean_rows, drills,
                             launches, tmp_root)
        recover = {
            "kmeans": recover_one_shard("kmeans", MapReduce(apps.KMeans()),
                                        items, RES_DRILL_SHARDS, tmp_root),
            f"keyed_sum_K{k}_sort": recover_one_shard(
                f"keyed_sum_K{k}_sort", MapReduce(apps.KeyedSum(k),
                                                  flow="sort"),
                kitems, RES_DRILL_SHARDS, tmp_root)}
        epoch = resilient_epoch_reject(kitems, tmp_root)
        del kitems
        torch.cuda.empty_cache()
        repeat = resilient_repeat(items)
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)
    return {"card": card, "note": RES_NOTE, "fault_free": rows,
            "drills": drills, "recover_one_shard": recover,
            "epoch_reject": epoch, "repeat": repeat, "launches": launches,
            "phase_wall_s": time.perf_counter() - t0}


# -- phase 14: dense-family training (A14b-1) ---------------------------------

TRAIN_SEQ = 1024
TRAIN_STEPS = 4
TRAIN_CHUNK = 8192
#: (arch, global batch, microbatches, accumulation modes): full width, two
#: layers (llama3-8b: 32 -> 2; gemma2-27b: 46 -> 2, one local, one global)
TRAIN_CELLS = (("llama3-8b", 8, 4, ("combiner", "materialize")),
               ("gemma2-27b", 2, 2, ("combiner",)))
TRAIN_LAYERS = 2
#: AdamW's peak rate: at full width the default 3e-4 with one warm-up step
#: overshoots (llama3-8b at 2 layers, bf16 and f32 alike: losses 12.26,
#: 12.22, 22.1, 15.2), 3e-5 falls (12.26, 12.22, 10.67, 9.86)
TRAIN_LR = 3e-5
LOSS_RTOL = 1e-5  # the two accumulation modes' first loss
XENT_MODES_RTOL = 1e-4  # chunked against materialized loss
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores


def tree_to(tree, device):
    """A copy of a tensor tree on ``device`` (new tensors)."""
    from repro_torch.training import optim
    return optim.tree_map(lambda x: x.detach().to(device, copy=True), tree)


def state_digest(state) -> list:
    """A fingerprint of every bit of a train state: per leaf, the sum of
    its 32-bit words and of the words weighted by their position mod
    65521, in int64 (wrapping, so equal bits give equal digests)."""
    import torch
    from repro_torch.checkpoint.ckpt import flatten
    out = []
    for x in flatten(state)[0]:
        words = x.detach().reshape(-1).view(torch.int32)
        s = w = 0
        for lo in range(0, words.numel(), 1 << 26):
            c = words[lo:lo + (1 << 26)].to(torch.int64)
            pos = torch.arange(lo, lo + c.numel(), device=c.device) % 65521
            s += int(c.sum())
            w += int((c * pos).sum())
            del c, pos
        out.append((s, w))
    return out


def train_flops(cfg, tokens: int, group: int = 0,
                enc_tokens: int = 0) -> dict:
    """Operations a step of ``tokens`` positions needs (counted from the
    shapes; vlm: the patches too, whose -1 labels the loss masks after
    computing them): the chunked loss's four f32 GEMMs over the vocabulary
    (forward, the backward's recompute, d_hidden and d_unembed), and the
    layers' bf16 matmuls with remat (forward twice, backward twice).  An
    MoE layer's experts compute every slot of their capacity, padding too:
    C slots an expert for each dispatch group of ``group`` tokens (a
    row).  The SSM, hybrid and audio families count their weights'
    matmuls only (not the SSD's quadratic terms or the attention scores,
    so their bound is a lower one); whisper's encoder and cross K/V run
    over ``enc_tokens`` frames."""
    E, V = cfg.d_model, cfg.vocab_size
    attn_w = E * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * E
    if cfg.family in ("ssm", "hybrid", "audio"):
        if cfg.family == "audio":
            mlp = 2 * E * cfg.d_ff
            enc = (attn_w + mlp) * (cfg.enc_layers or cfg.num_layers)
            dec = (attn_w + 2 * E * cfg.q_dim + mlp) * cfg.num_layers
            work = (enc * enc_tokens + dec * tokens
                    + 2 * E * cfg.kv_dim * cfg.num_layers * enc_tokens)
        else:
            d_in = cfg.ssm_d_inner
            mamba = E * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads) + (
                d_in * E)
            work = mamba * cfg.num_layers * tokens
            if cfg.family == "hybrid":
                work += ((attn_w + 3 * E * cfg.d_ff) * tokens
                         * (cfg.num_layers // cfg.hybrid_attn_every))
        return {"xent_f32": 4 * 2 * tokens * V * E,
                "layers_bf16": 4 * 2 * work}
    ffn = 3 * E * cfg.d_ff
    if cfg.num_experts:
        from repro_torch.models.moe import capacity
        X = cfg.num_experts
        C = capacity(group, cfg.num_experts_per_tok, X, 1.25)
        ffn = E * X + ffn * X * C / group
    layer = E * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * E + ffn
    return {"xent_f32": 4 * 2 * tokens * V * E,
            "layers_bf16": 4 * 2 * tokens * layer * cfg.num_layers}


def train_mode_run(model, host_state, tc, batches, *,
                   must_fall: bool = True) -> dict:
    """One accumulation mode: a fresh device copy of ``host_state``, the
    steps over ``batches`` with the first as the warm step; each step's
    loss, grad_norm and ms (host clock, ended by a synchronize), the
    digest of the state after step 2 (step 1 runs at learning rate 0, the
    schedule's first warm-up step), and the peak device memory above what
    was allocated before."""
    import torch
    from repro_torch.training.train_step import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = tree_to(host_state, "cuda")
    resident = [torch.cuda.memory_allocated() - base]
    step = make_train_step(model, tc)
    losses, gnorms, lbs, ms, digest = [], [], [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lbs.append(float(m["load_balance_loss"]))
        resident.append(torch.cuda.memory_allocated() - base)
        if i == 1:
            digest = state_digest(state)
    peak = torch.cuda.max_memory_allocated()
    del state, m
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all() or not np.isfinite(gnorms).all():
        raise AssertionError(f"train: losses {losses}, grad norms {gnorms}")
    if must_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    timed = ms[1:]
    return {"losses": losses, "grad_norms": gnorms,
            "load_balance_losses": lbs, "step_ms": ms,
            "step_ms_warm_mean": sum(timed) / len(timed),
            "step_ms_warm_median": float(np.median(timed)),
            "peak_bytes": peak - base, "base_bytes": base,
            "resident_bytes": resident, "digest": digest}


def loss_alone(model, params, batch, mode: str, chunk: int) -> dict:
    """The loss function alone, forward plus backward, on one
    microbatch's final hidden states (the model's forward run without
    gradients): ``losses.xent_chunked`` or ``xent_materialize`` with
    respect to the hidden states and the unembedding.  The loss, ms (CUDA
    events, after a warm call) and the peak device memory above what was
    allocated before."""
    import torch
    from repro_torch.training import losses

    with torch.no_grad():
        hidden, _ = model.forward(params, batch)
    w = model.unembed_matrix(params)
    labels = batch["labels"]

    def once():
        h = hidden.detach().requires_grad_(True)
        u = w.detach().requires_grad_(True)
        if mode == "chunked":
            loss = losses.xent_chunked(h, u, labels, chunk=chunk,
                                       softcap=model.logit_softcap)
        else:
            loss = losses.xent_materialize(h, u, labels,
                                           softcap=model.logit_softcap)
        torch.autograd.grad(loss, (h, u))
        return loss.detach()

    once()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = once()
    stop.record()
    torch.cuda.synchronize()
    return {"loss": float(loss), "ms": start.elapsed_time(stop),
            "peak_bytes": torch.cuda.max_memory_allocated() - base}


def train_on_card(card: str) -> dict:
    """Phase 14: ``training.train_step`` at full model width, two layers,
    random weights from seed 0 on the card, batches from
    ``data.pipeline.global_batch``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.models.registry import get_model, param_count
    from repro_torch.training import optim
    from repro_torch.training.train_step import (TrainConfig, batch_to,
                                                 init_train_state)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "vocab_chunk": TRAIN_CHUNK, "lr": TRAIN_LR,
           "resident_bytes_at_start": torch.cuda.memory_allocated()}
    for arch, gbatch, mbs, modes in TRAIN_CELLS:
        cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_LAYERS)
        model = get_model(cfg)
        tc = TrainConfig(adam=optim.AdamWConfig(lr=TRAIN_LR),
                         num_microbatches=mbs, warmup_steps=1,
                         total_steps=50, vocab_chunk=TRAIN_CHUNK)
        dc = DataConfig(seed=0, vocab_size=cfg.vocab_size,
                        seq_len=TRAIN_SEQ, global_batch=gbatch)
        batches = [global_batch(dc, i) for i in range(TRAIN_STEPS)]
        t0 = time.perf_counter()
        state = init_train_state(model, torch.Generator("cuda").manual_seed(0))
        P = param_count(state["master"])
        host = tree_to(state, "cpu")
        del state
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        tokens = gbatch * TRAIN_SEQ
        row = {"arch": arch, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "params": P, "batch": gbatch, "microbatches": mbs,
               "tokens_per_step": tokens, "init_s": init_s, "modes": {}}
        flops = train_flops(cfg, tokens)
        row["step_flops"] = flops
        row["step_bound_ms"] = (flops["xent_f32"] / F32_OPS_PER_S
                                + flops["layers_bf16"] / BF16_OPS_PER_S
                                ) * 1e3
        for mode in modes:
            r = train_mode_run(model, host, dataclasses.replace(
                tc, accum_mode=mode), batches)
            r["tokens_per_s"] = tokens * 1e3 / r["step_ms_warm_median"]
            r["peak_over_4P"] = r["peak_bytes"] / (4 * P)
            row["modes"][mode] = r
            log(f"train: {arch} {cfg.num_layers} layers {mode}: losses "
                f"{r['losses']}, step {r['step_ms_warm_median']:.1f} ms "
                f"({r['tokens_per_s']:.0f} tokens/s), peak "
                f"{r['peak_bytes'] / 2**30:.2f} GiB ({r['peak_over_4P']:.2f}"
                f" x 4P; resident before {r['base_bytes']} B, after the "
                f"copy and each step {r['resident_bytes']} B) [{card}]")
        comb = row["modes"]["combiner"]
        # combiner steps from one cloned state repeat bit for bit
        again = train_mode_run(model, host, tc, batches[:2], must_fall=False)
        row["repeat_bit_for_bit"] = (again["losses"] == comb["losses"][:2]
                                     and again["digest"] == comb["digest"])
        if not row["repeat_bit_for_bit"]:
            raise AssertionError(
                f"train: {arch}: two combiner steps from one cloned state "
                f"gave other losses or state ({again['losses']!r} against "
                f"{comb['losses'][:2]!r}; digests equal: "
                f"{again['digest'] == comb['digest']})")
        if "materialize" in row["modes"]:
            mat = row["modes"]["materialize"]
            l1, l2 = comb["losses"][0], mat["losses"][0]
            if abs(l1 - l2) > LOSS_RTOL * abs(l2):
                raise AssertionError(f"train: {arch}: step-1 losses "
                                     f"combiner {l1} materialize {l2}")
            diff = mat["peak_bytes"] - comb["peak_bytes"]
            row["materialize_minus_combiner_peak_bytes"] = diff
            row["materialize_minus_combiner_over_4P"] = diff / (4 * P)
            log(f"train: {arch}: materialize peak - combiner peak = "
                f"{diff / 2**30:.2f} GiB = {diff / (4 * P):.2f} x 4P "
                f"[{card}]")
            if diff < 2 * 4 * P:
                raise AssertionError(
                    f"train: {arch}: materialize peak exceeds the "
                    f"combiner's by {diff} B, under 2 x 4P = {8 * P} B")
            # the loss alone: chunked against materialized xent
            params = optim.model_params(
                {"master": tree_to(host["master"], "cuda")}, cfg.dtype)
            mb = batch_to({k: v[:gbatch // mbs]
                           for k, v in batches[0].items()}, "cuda")
            la = {mode: loss_alone(model, params, mb, mode, TRAIN_CHUNK)
                  for mode in ("chunked", "materialize")}
            del params
            torch.cuda.empty_cache()
            row["loss_alone"] = la
            ch, ma = la["chunked"], la["materialize"]
            logits = mb["labels"].numel() * cfg.vocab_size * 4
            row["loss_alone"]["logits_f32_bytes"] = logits
            log(f"train: {arch} loss alone (one microbatch): {la} [{card}]")
            if abs(ch["loss"] - ma["loss"]) > XENT_MODES_RTOL * abs(
                    ma["loss"]):
                raise AssertionError(f"train: {arch}: chunked loss "
                                     f"{ch['loss']}, materialized "
                                     f"{ma['loss']}")
            if ma["peak_bytes"] - ch["peak_bytes"] < logits / 2:
                raise AssertionError(
                    f"train: {arch}: chunked peak {ch['peak_bytes']} B is "
                    f"not half a logits tensor ({logits} B) below the "
                    f"materialized {ma['peak_bytes']} B")
        for r in row["modes"].values():
            del r["digest"]
        out[arch] = row
        del host
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# -- phase 15: the transformer's MoE and VLM branches (A14b-2, A14b-4) ------

#: (arch, layers; None: full depth) served at full width, batch 4, a
#: 2048-token prompt, 32 new tokens: llama4-scout-17b-a16e cut 48 -> 4
#: layers (all 48 are 203 GB in bf16); qwen3-moe-30b-a3b and internvl2-26b
#: cut 48 -> 12 to keep the script within its time (served whole they
#: took 91.6 s and 51.0 s of the phase; PERF.md keeps those numbers)
MOE_SERVE = (("qwen3-moe-30b-a3b", 12), ("llama4-scout-17b-a16e", 4),
             ("internvl2-26b", 12))
#: (arch, global batch, microbatches, MoE modes) trained at full width,
#: 48 -> 2 layers, 1024 tokens a row (internvl2: 256 patches in front)
MOE_TRAIN = (("qwen3-moe-30b-a3b", 8, 4, ("combiner", "materialize")),
             ("internvl2-26b", 2, 2, ("combiner",)))
#: the MoE modes' first training losses, relative.  In bf16 the combiner
#: adds a token's K expert outputs in bf16 and materialize sums them in
#: f32 and rounds once, and the layer after may route a token near a tie
#: differently; tests/test_torch_moe.py holds the two within this at
#: reduced width in bf16 (top-8 of 16 experts: 1.7e-4)
MOE_LOSS_RTOL = 1e-3
MOE_PREFILL_RUNS = 3  # prefill timed per MoE mode, after one warm run


@contextlib.contextmanager
def moe_modes_compared():
    """While open, each combiner call of ``moe.moe_ffn`` (a prefill's
    layers) also runs ``materialize`` on the same input, so both modes
    route alike.  Yields a list that receives, a call, rms(Δ)/rms(out)
    and max|Δ|/max|out| of the two outputs and whether a second combiner
    call repeats bit for bit."""
    import torch
    from repro_torch.models import moe

    real, seen = moe.moe_ffn, []

    def ffn(cfg, p, x, *, mode="combiner", **kw):
        out, aux = real(cfg, p, x, mode=mode, **kw)
        if mode == "combiner":
            mat = real(cfg, p, x, mode="materialize", **kw)[0].float()
            again = real(cfg, p, x, mode=mode, **kw)[0]
            diff = out.float() - mat
            seen.append((float(diff.pow(2).mean().sqrt()
                               / mat.pow(2).mean().sqrt()),
                         float(diff.abs().max() / mat.abs().max()),
                         torch.equal(bits(out), bits(again))))
        return out, aux

    moe.moe_ffn = ffn
    try:
        yield seen
    finally:
        moe.moe_ffn = real


def moe_prefill(model, params, prompts) -> dict:
    """Prefill alone in each MoE mode: ms (host clock between
    synchronizes, after a warm run), the two modes' last-position logits
    against each other (each routing on its own: a reading, with the
    routings that differ between them counted), and the two modes on the
    same input at every layer (:func:`moe_modes_compared`): within the
    serve gate (SERVE_*_TOL), and the combiner bit for bit on a repeat."""
    import torch

    cfg = model.cfg
    b, s = prompts.shape
    out, logits, routes = {}, {}, {}

    def once(mode):
        st = model.init_decode_state(b, s + 1, device=prompts.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, st = model.prefill(params, {"tokens": prompts}, st,
                               moe_mode=mode)
        torch.cuda.synchronize()
        return lg, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        for mode in ("combiner", "materialize"):
            with routing_recorded() as routes[mode]:
                logits[mode], _ = once(mode)
            ms = [once(mode)[1] for _ in range(MOE_PREFILL_RUNS)]
            out[f"{mode}_ms"] = float(np.median(ms))
            out[f"{mode}_ms_runs"] = ms
        flips = [int((torch.sort(a, -1).values
                      != torch.sort(c, -1).values).any(-1).sum())
                 for a, c in zip(routes["combiner"], routes["materialize"])]
        del routes
        out["free_running_logits"] = {
            **decode_gap(logits["materialize"][:, None],
                         logits["combiner"][:, None]),
            "routing_flips_per_layer": flips,
            "token_layer_routings": cfg.num_layers * b * s}
        with moe_modes_compared() as seen:
            once("combiner")
    rms = max(r for r, _, _ in seen)
    mx = max(m for _, m, _ in seen)
    out["same_input_layers"] = {"layers": len(seen), "rms_rel_max": rms,
                                "max_rel_max": mx,
                                "repeat_bit_for_bit": all(e for *_, e in seen)}
    if len(seen) != cfg.num_layers or not out["same_input_layers"][
            "repeat_bit_for_bit"]:
        raise AssertionError(f"moe {cfg.name}: prefill modes {out}")
    if rms > SERVE_RMS_TOL or mx > SERVE_MAX_TOL:
        raise AssertionError(f"moe {cfg.name}: combiner vs materialize on "
                             f"one input past the serve gate: {out}")
    return out


#: the families whose prefill :func:`serve_model` also profiles (phase
#: 16's: their prefill is a chunked scan or an encoder, not attention)
PREFILL_PROFILED = ("ssm", "hybrid", "audio")


def serve_model(card: str, arch: str, layers, dtype=None,
                **serve_kw) -> dict:
    """Phase 15 (a)-(c) and phase 16 (a)-(b): :func:`serve_run` on
    ``arch`` at full width (and ``layers`` deep, None for full depth),
    random weights from seed 0, one decode step profiled (and the prefill,
    for the families of PREFILL_PROFILED), then for MoE the prefill modes
    (:func:`moe_prefill`); peak device memory from a reset
    before the weights.  ``dtype`` replaces the model dtype; ``serve_kw``
    go to :func:`serve_run`."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    t0 = time.perf_counter()
    model, params, prompts, extra = serve_setup(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - base
    out = {"card": card, **serve_run(model, params, prompts, extra,
                                     **serve_kw),
           "published_layers": get_config(arch).num_layers,
           "init_s": init_s, "weight_bytes": weights}
    out["serve_s"] = time.perf_counter() - t0 - init_s
    # one decode step under the profiler: flash_decode, the matmuls (the
    # experts' bmm among them) and the rest
    with torch.inference_mode():
        st = model.init_decode_state(
            SERVE_BATCH, prompts.shape[1] + SERVE_NEW + out["patches"],
            device=prompts.device)
        lg, st = model.prefill(params, {"tokens": prompts, **(extra or {})},
                               st)
        tok = lg.argmax(-1).to(torch.int32)
        out["profile_decode_step"] = profile_fn(
            lambda: model.decode_step(params, st, tok),
            out["decode_ms_per_token"], top=10,
            groups={"flash_decode": ("fold_chunks",),
                    "matmul": ("gemm", "cutlass", "xmma", "nvjet"),
                    "sort": ("sort", "radix")})
        del st, lg
        if cfg.family in PREFILL_PROFILED:  # where the prefill's time goes

            def prefill():
                st = model.init_decode_state(
                    SERVE_BATCH, prompts.shape[1] + SERVE_NEW
                    + out["patches"], device=prompts.device)
                return model.prefill(
                    params, {"tokens": prompts, **(extra or {})}, st)

            out["profile_prefill"] = profile_fn(
                prefill, out["prefill_ms"], top=10,
                groups={"flash_decode": ("fold_chunks",),
                        "matmul": ("gemm", "cutlass", "xmma", "nvjet"),
                        "elementwise": ("elementwise",),
                        "reduce": ("reduce",)})
    if cfg.num_experts:
        out["prefill_modes"] = moe_prefill(model, params, prompts)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["wall_s"] = time.perf_counter() - t0
    del params, prompts, extra, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{cfg.family} serve {arch} {cfg.dtype} ({cfg.num_layers} of "
        f"{out['published_layers']} layers): prefill "
        f"{out['prefill_ms']:.1f} ms, decode "
        f"{out['decode_ms_per_token']:.2f} ms a token "
        f"({out['tokens_per_s']:.1f} tokens/s), peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB; init {init_s:.1f} s, serve "
        f"{out['serve_s']:.1f} s, all {out['wall_s']:.1f} s [{card}]")
    return out


def train_run(card: str, arch: str, gbatch: int, mbs: int, modes, *,
              layers=TRAIN_LAYERS, seq: int = TRAIN_SEQ,
              tag: str = "moe") -> dict:
    """Phase 15 (d)-(e) and phase 16 (d): ``training.train_step`` at full
    width, ``layers`` deep (None: full depth), random weights from seed 0,
    the launcher's batches of ``seq`` positions
    (``launch.train.make_batch_fn``: vlm adds patches, -1 labels over
    them; audio draws ``seq`` frames and cuts the tokens to ``dec_len``),
    combiner accumulation, TRAIN_STEPS steps in each MoE mode from a fresh
    copy of one initial state; each mode's step ms, tokens/s, peak memory
    and load-balance loss; losses finite and falling, every gradient
    finite (a finite grad_norm), two steps from the cloned state bit for
    bit in each mode, and the modes' first losses within
    MOE_LOSS_RTOL."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.registry import (active_param_count, get_model,
                                             param_count)
    from repro_torch.training import optim
    from repro_torch.training.train_step import TrainConfig, init_train_state

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = get_model(cfg)
    tc = TrainConfig(adam=optim.AdamWConfig(lr=TRAIN_LR),
                     num_microbatches=mbs, warmup_steps=1, total_steps=50,
                     vocab_chunk=TRAIN_CHUNK)
    batch_fn = make_batch_fn(cfg, DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=gbatch))
    batches = [batch_fn(i) for i in range(TRAIN_STEPS)]
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator("cuda").manual_seed(0))
    P = param_count(state["master"])
    active = active_param_count(cfg, state["master"])
    host = tree_to(state, "cpu")
    del state
    torch.cuda.empty_cache()
    pn = cfg.num_patches if cfg.family == "vlm" else 0
    audio = cfg.family == "audio"
    # the decoder positions the loss sees
    dec = min(seq, cfg.dec_len) if audio else seq
    tokens = gbatch * dec
    row = {"arch": arch, "layers": cfg.num_layers,
           "published_layers": get_config(arch).num_layers,
           "d_model": cfg.d_model,
           "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
           "params": P, "active_params": active, "batch": gbatch,
           "microbatches": mbs, "patches": pn, "tokens_per_step": tokens,
           "frames_per_step": gbatch * seq if audio else 0,
           "positions_per_step": gbatch * (dec + pn),
           "init_s": time.perf_counter() - t0, "modes": {}}
    flops = train_flops(cfg, gbatch * (dec + pn), dec + pn,
                        enc_tokens=gbatch * seq if audio else 0)
    row["step_flops"] = flops
    row["step_bound_ms"] = (flops["xent_f32"] / F32_OPS_PER_S
                            + flops["layers_bf16"] / BF16_OPS_PER_S) * 1e3
    row["wall_s"] = {}
    for mode in modes:
        t0 = time.perf_counter()
        mtc = dataclasses.replace(tc, moe_mode=mode)
        r = train_mode_run(model, host, mtc, batches)
        again = train_mode_run(model, host, mtc, batches[:2],
                               must_fall=False)
        r["repeat_bit_for_bit"] = (again["losses"] == r["losses"][:2]
                                   and again["digest"] == r["digest"])
        r["tokens_per_s"] = tokens * 1e3 / r["step_ms_warm_median"]
        r["peak_over_4P"] = r["peak_bytes"] / (4 * P)
        del r["digest"]
        row["modes"][mode] = r
        row["wall_s"][mode] = time.perf_counter() - t0
        log(f"{tag} train: {arch} {cfg.num_layers} layers {mode}: losses "
            f"{r['losses']}, load balance {r['load_balance_losses']}, step "
            f"{r['step_ms_warm_median']:.1f} ms ({r['tokens_per_s']:.0f} "
            f"tokens/s), peak {r['peak_bytes'] / 2**30:.2f} GiB, repeat bit "
            f"for bit {r['repeat_bit_for_bit']} [{card}]")
        if not r["repeat_bit_for_bit"]:
            raise AssertionError(
                f"{tag} train: {arch} {mode}: two steps from one cloned state "
                f"gave other losses or state ({again['losses']!r} against "
                f"{r['losses'][:2]!r})")
    if len(modes) == 2:
        l1, l2 = (row["modes"][m]["losses"][0] for m in modes)
        row["first_loss_rel_diff"] = abs(l1 - l2) / abs(l2)
        if row["first_loss_rel_diff"] > MOE_LOSS_RTOL:
            raise AssertionError(f"{tag} train: {arch}: first losses {modes} "
                                 f"{l1} {l2}, past {MOE_LOSS_RTOL}")
    del host
    torch.cuda.empty_cache()
    return row


def moe_on_card(card: str) -> dict:
    """Phase 15, after phase 14 has released its memory: serve
    qwen3-moe-30b-a3b (12 of 48 layers), llama4-scout-17b-a16e (4 of 48)
    and internvl2-26b (12 of 48) at full width through ``generate``
    (:func:`serve_model`), then train qwen3-moe-30b-a3b in both MoE modes
    and internvl2-26b with patches, 2 layers each (:func:`train_run`)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "resident_bytes_at_start":
           torch.cuda.memory_allocated(), "serve": {}, "train": {}}
    for arch, layers in MOE_SERVE:
        out["serve"][arch] = serve_model(card, arch, layers)
    for arch, gbatch, mbs, modes in MOE_TRAIN:
        out["train"][arch] = train_run(card, arch, gbatch, mbs, modes)
    out["launches"] = {arch: r["launches"]
                       for arch, r in out["serve"].items()}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# -- phase 16: the SSM, hybrid and audio families (A14b-3, A14b-4) ---------

#: served at full width and depth, batch 4, 32 new greedy tokens: mamba2 and
#: zamba2 after a 2048-token prompt (8 chunks of 256), whisper after
#: WHISPER_FRAMES frames and a BOS token
SSM_SERVE = ("mamba2-2.7b", "zamba2-1.2b", "whisper-medium")
#: (arch, layers (None: all), global batch, microbatches, positions a row)
#: trained at full width, combiner accumulation: mamba2 cut 64 -> 8 layers
#: at the published chunk of 256 (where C.63 would show), zamba2 cut 38 ->
#: 14 (two groups of 6 and the tail of 2) for time, whisper whole (1500
#: frames, tokens cut to dec_len = 448)
SSM_TRAIN = (("mamba2-2.7b", 8, 2, 2, 1024), ("zamba2-1.2b", 14, 2, 2, 1024),
             ("whisper-medium", None, 2, 2, WHISPER_FRAMES))
#: the SSD prefill against the recurrence (f32, full width): a prompt of
#: SSD_LEN tokens (two chunks), batch SSD_BATCH, SSD_LAYERS deep (mamba2 64
#: -> 32, zamba2 38 -> 20: three groups of 6 and the tail; at full depth
#: they took 35.5 s and 28.0 s of the phase)
SSD_LEN, SSD_BATCH = 512, 2
SSD_LAYERS = {"mamba2-2.7b": 32, "zamba2-1.2b": 20}
#: the reference's own tolerance on the softmax
#: (tests/models/test_prefill_consistency.py), applied also to the logits
#: (rms and max, relative, as the serve gate reads them): at a vocabulary
#: of 32 000-50 280 with random weights no probability reaches 2e-2, so the
#: softmax alone would pass any logits (ROADMAP C.68)
SSD_TOL = 2e-2
#: positions of the stepwise decode under the shifted-window fault (it
#: moves every position's logits from the first)
SSD_FAULT_STEPS = 64
#: the logits gate of zamba2's f32 serve run against the decode through
#: the kernel's plain version (ROADMAP C.69): in bf16 the 38-layer random
#: hybrid's rounding alone moves its logits by 0.044 / 0.064 (rms / max),
#: above 2^-5, while each B8 call agrees with its plain version within
#: 4.8e-7; in f32 the sound kernel reads 3.8e-6 / 5.7e-6 and the weakest
#: planted fault 3.9e-3 / 5.8e-3 (NVIDIA H100 80GB HBM3, 700.00 W), so the
#: gate sits 4x below that fault and 250x above the sound reading
F32_LOGIT_TOL = 2.0 ** -10


@contextlib.contextmanager
def ssd_fault(name: str):
    """A planted fault of the SSM layers while open:
    ``inclusive_chunk_state``, each chunk enters with its own inclusive
    state (the prefill's exclusive scan made inclusive), and
    ``conv_window_shifted``, the decode's conv taps read the window one
    row back (the newest token left out of its own conv; the state kept
    right)."""
    import torch
    from repro_torch.models import ssm

    if name == "inclusive_chunk_state":
        attr, real = "_chunk_states", ssm._chunk_states

        def fault(decay, s):
            prev, last = real(decay, s)
            return torch.cat([prev[:, 1:], last[:, None]], dim=1), last
    else:
        attr, real = "_decode_conv", ssm._decode_conv

        def fault(window, w, b):
            return real(torch.cat([window[:, :1], window[:, :-1]], dim=1),
                        w, b)
    setattr(ssm, attr, fault)
    try:
        yield
    finally:
        setattr(ssm, attr, real)


def ssd_prefill_side(model, params, prompt, tok=None):
    """[B, 2, V]: the prefill's last-position logits and one decode step
    after it (fed ``tok``, by default the prefill's argmax), and the
    token."""
    import torch
    b, s = prompt.shape
    st = model.init_decode_state(b, s + 2, device=prompt.device)
    la, st = model.prefill(params, {"tokens": prompt}, st)
    if tok is None:
        tok = la.argmax(-1).to(torch.int32)
    la2, _ = model.decode_step(params, st, tok)
    return torch.stack([la, la2], dim=1), tok


def ssd_forward_side(model, params, prompt):
    """[B, S, V]: the chunked forward's logits at every prompt position."""
    hidden, _ = model.forward(params, {"tokens": prompt}, remat=False)
    return model.logits_of_hidden(params, hidden)


def ssd_step_side(model, params, prompt, tok=None, steps=None):
    """The prompt (its first ``steps`` tokens) decoded one token at a time:
    the logits at every position [B, steps, V], and with ``tok`` also
    [B, 2, V], the last position's and one step after it (fed ``tok``)."""
    import torch
    b, s = prompt.shape
    steps = steps or s
    st = model.init_decode_state(b, s + 2, device=prompt.device)
    every = []
    for t in range(steps):
        lb, st = model.decode_step(params, st, prompt[:, t])
        every.append(lb)
    every = torch.stack(every, dim=1)
    if tok is None:
        return every, None
    lb2, _ = model.decode_step(params, st, tok)
    return every, torch.stack([every[:, -1], lb2], dim=1)


def ssd_gap(la, lb) -> dict:
    """The reference's reading (max |softmax(a) - softmax(b)|) and
    :func:`decode_gap`'s on the logits, per position, against SSD_TOL."""
    import torch
    sm = float((torch.softmax(la, -1) - torch.softmax(lb, -1)).abs().max())
    g = decode_gap(la, lb)
    return {"softmax_max_abs": sm, **g,
            "max_prob": float(torch.softmax(lb, -1).max()),
            "within": (sm < SSD_TOL and g["rms_rel_max"] <= SSD_TOL
                       and g["max_rel_max"] <= SSD_TOL)}


def ssd_check(card: str, arch: str) -> dict:
    """Phase 16 (c): ``arch`` at full width, SSD_LAYERS deep, in f32 (IEEE
    matmuls), random weights from seed 0, a prompt of SSD_LEN random
    tokens, batch SSD_BATCH, against the same prompt decoded one token at
    a time (the recurrence): the chunked-SSD prefill's last-position
    logits and one step after it (``last``, the reference's test), and the
    chunked
    forward's logits at every position (``every``: the reference's random
    init decays a state within a few tokens, A = -1, so only the first
    positions of a chunk read the state entering it), each within SSD_TOL
    (:func:`ssd_gap`).  Each fault of :func:`ssd_fault` must fall outside
    it: the inclusive state in the forward, the shifted conv window in a
    stepwise decode of the first SSD_FAULT_STEPS tokens."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                              num_layers=SSD_LAYERS[arch])
    model = get_model(cfg)
    params = model.init_params(torch.Generator("cuda").manual_seed(0))
    prompt = torch.randint(
        0, cfg.vocab_size, (SSD_BATCH, SSD_LEN), dtype=torch.int32,
        device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    out = {"arch": arch, "layers": cfg.num_layers, "dtype": "float32",
           "batch": SSD_BATCH, "prompt": SSD_LEN, "tol": SSD_TOL,
           "fault_steps": SSD_FAULT_STEPS}
    with torch.inference_mode():
        ts = time.perf_counter()
        la, tok = ssd_prefill_side(model, params, prompt)
        lf_every = ssd_forward_side(model, params, prompt)
        torch.cuda.synchronize()
        out["prefill_side_s"] = time.perf_counter() - ts
        ts = time.perf_counter()
        lb_every, lb = ssd_step_side(model, params, prompt, tok)
        torch.cuda.synchronize()
        out["step_side_s"] = time.perf_counter() - ts
        out["finite"] = bool(torch.isfinite(la).all()
                             and torch.isfinite(lb_every).all())
        out["sound"] = {"last": ssd_gap(la, lb),
                        "every": ssd_gap(lf_every, lb_every)}
        faults = {}
        with ssd_fault("inclusive_chunk_state"):
            lf = ssd_forward_side(model, params, prompt)
        faults["inclusive_chunk_state"] = ssd_gap(lf, lb_every)
        with ssd_fault("conv_window_shifted"):
            lf, _ = ssd_step_side(model, params, prompt,
                                  steps=SSD_FAULT_STEPS)
        faults["conv_window_shifted"] = ssd_gap(
            lf_every[:, :SSD_FAULT_STEPS], lf)
        del lf
    out["planted_faults"] = faults
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del params, la, lb, lf_every, lb_every
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"ssd check {arch} ({cfg.num_layers} layers, f32, {SSD_BATCH} x "
        f"{SSD_LEN}): prefill vs recurrence {out['sound']}; planted faults "
        f"{faults}; {out['wall_s']:.1f} s [{card}]")
    if not out["finite"] or not all(g["within"]
                                    for g in out["sound"].values()):
        raise AssertionError(f"ssd check {arch}: prefill against the "
                             f"recurrence past {SSD_TOL}: {out}")
    blind = [name for name, f in faults.items() if f["within"]]
    if blind:
        raise AssertionError(f"ssd check {arch}: blind to the planted faults "
                             f"{blind}: {faults}")
    return out


def ssm_on_card(card: str) -> dict:
    """Phase 16, after phase 15 has released its memory: serve mamba2-2.7b,
    zamba2-1.2b and whisper-medium at full width and depth through
    ``generate`` (:func:`serve_model`: B8 in zamba2's shared attention and
    whisper's self- and cross-attention, each call held against its plain
    version, the faults planted), check the SSD prefill against the
    recurrence in f32 (:func:`ssd_check`), and train the three at full
    width (:func:`train_run`)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "resident_bytes_at_start":
           torch.cuda.memory_allocated(), "serve": {}, "ssd_check": {},
           "train": {}}
    for arch in SSM_SERVE:
        # zamba2 in bf16: the logits read, not gated (C.69); its f32 run
        # below gates them
        gate = ({"gates": {}} if arch == "zamba2-1.2b"
                else {"fault_gates": ("kernel_plain",)})
        out["serve"][arch] = serve_model(card, arch, None, **gate)
    out["serve_f32"] = {"zamba2-1.2b": serve_model(
        card, "zamba2-1.2b", None, dtype=torch.float32,
        gates={"kernel_plain": (F32_LOGIT_TOL, F32_LOGIT_TOL)},
        fault_gates=("kernel_plain",))}
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        out["ssd_check"][arch] = ssd_check(card, arch)
    for arch, layers, gbatch, mbs, seq in SSM_TRAIN:
        out["train"][arch] = train_run(card, arch, gbatch, mbs,
                                       ("combiner",), layers=layers, seq=seq,
                                       tag="ssm")
    zamba, whisper = (out["serve"][a] for a in ("zamba2-1.2b",
                                                "whisper-medium"))
    by_s = whisper["launches_by_kv_positions"]  # generate's own launches
    out["launches"] = {
        "zamba2-1.2b": zamba["launches"],
        "whisper-medium/self": sum(n for s, n in by_s.items()
                                   if int(s) != WHISPER_FRAMES),
        "whisper-medium/cross": by_s.get(str(WHISPER_FRAMES), 0),
        "whisper-medium": whisper["launches"]}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# -- phase 17: sharding and the dry-run (A14b-5) -------------------------------

#: the dry-run's gated cells (the reference's
#: test_dryrun_smallmesh_train_and_decode), on the pod mesh
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"))
DRYRUN_TIMEOUT_S = 240
#: the sharded step's steps from the cloned state (the first at rate 0)
SHARD_STEPS = 3


def start_dryruns(out_dir: str) -> list:
    """Phase 17 (c), started first so that it overlaps (a) and (b): one
    ``python -m repro_torch.launch.dryrun`` process a cell, on the CPU."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        procs.append(((arch, shape), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--out", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def spec_argument_bytes(arch: str, shape_name: str) -> int:
    """A dry-run cell's argument bytes a chip from the specs' arithmetic on
    a shape-only 16 x 16 mesh (each leaf's dims divided by the sizes of the
    axes that shard them), independent of the DTensors the dry-run
    builds."""
    import torch
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import (SHAPES, default_kv_dtype, get_config,
                                     input_specs, state_specs)
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.registry import get_model
    from repro_torch.training.train_step import abstract_train_state

    class Pod:
        shape = {"data": 16, "model": 16}

    def nbytes(tree, specs):  # the state's position lives on the host
        total = 0
        for (keys, x), sp in zip(shd.leaves_with_paths(tree),
                                 flatten(specs)[0]):
            if isinstance(x, torch.Tensor) and keys[-1:] != ("pos",):
                n = 1
                for d in shd.local_shape(x.shape, sp, Pod):
                    n *= d
                total += n * x.element_size()
        return total

    cfg, shape = get_config(arch), SHAPES[shape_name]
    model = get_model(cfg)
    inputs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = abstract_train_state(model)
        return (nbytes(opt, shd.param_pspecs(opt, Pod))
                + nbytes(inputs, shd.batch_pspecs(inputs, Pod)))
    params = model.abstract_params()
    state = state_specs(cfg, shape, kv_dtype=default_kv_dtype(arch,
                                                              shape_name))
    toks = inputs["tokens"]
    return (nbytes(params, shd.param_pspecs(params, Pod, fsdp=False))
            + nbytes(state, shd.decode_state_pspecs(state, Pod, cfg))
            + nbytes(toks, shd.tokens_pspec(shape.global_batch, Pod)))


def finish_dryruns(procs, out_dir: str, card: str) -> dict:
    """Phase 17 (c): each dry-run process exits 0 with its cell ``ok``,
    its argument bytes equal to :func:`spec_argument_bytes`, and no CUDA
    context made."""
    import os

    import torch

    rows = {}
    for (arch, shape), proc in procs:
        try:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            proc.kill()
        path = os.path.join(out_dir, f"{arch}_{shape}_pod.json")
        if proc.returncode != 0 or not os.path.exists(path):
            raise AssertionError(f"dry-run {arch} x {shape}: exit "
                                 f"{proc.returncode}: {text[-3000:]}")
        with open(path) as f:
            r = json.load(f)
        want = spec_argument_bytes(arch, shape)
        mem, rl = r["memory"], r["roofline"]
        row = {"status": r["status"], "trace_s": r["compile_s"],
               "argument_bytes": mem["argument_bytes"],
               "spec_argument_bytes": want,
               "peak_per_chip_gib": mem["peak_per_chip_gib"],
               "fits": mem["fits"], "dominant": rl["dominant"],
               "step_s": rl["step_s"], "mfu": rl["mfu"],
               "attention": r["attention"],
               "cuda_initialized": r["cuda_initialized"],
               "n_params": r["n_params"], "n_active": r["n_active"],
               "flops_per_chip": rl["flops_per_chip"],
               "bytes_per_chip": rl["bytes_per_chip"],
               "collective_bytes_per_chip": rl["collective_bytes_per_chip"],
               "collective_ops": rl["collective_ops"],
               "modelled": "H100 SXM5 data-sheet roofline of a 256-card "
                           "mesh, not a measurement"}
        rows[f"{arch}/{shape}"] = row
        log(f"dry-run {arch} x {shape} (pod, 256 ranks, fake): {row}")
        if r["status"] != "ok" or mem["argument_bytes"] != want or r[
                "cuda_initialized"]:
            raise AssertionError(f"dry-run {arch} x {shape}: {row}")
    rows["card_total_memory_bytes"] = torch.cuda.get_device_properties(
        0).total_memory
    rows["dryrun_card_bytes"] = 80e9
    log(f"dry-run: the card holds {rows['card_total_memory_bytes']} B "
        f"against the dry-run's 80 GB [{card}]")
    return rows


def sharding_on_card(card: str) -> dict:
    """Phase 17: (a) the sharded train step and (b) the elastic restore
    at world size 1 over NCCL, a ``("data", "model")`` mesh of (1, 1); (c)
    the dry-run of two cells in subprocesses on the CPU, started first."""
    import gc
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "resident_bytes_at_start":
           torch.cuda.memory_allocated()}
    tmp = tempfile.mkdtemp()
    procs = start_dryruns(tmp)
    try:
        sharded_train_and_restore(card, out, tmp)
        out["dryrun"] = finish_dryruns(procs, tmp, card)
    finally:
        for _, proc in procs:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"sharding: phase 17 in {out['phase_wall_s']:.1f} s [{card}]")
    return out


def sharded_train_and_restore(card: str, out: dict, tmp: str) -> None:
    """Phase 17 (a) and (b), into ``out``."""
    import dataclasses
    import gc
    import socket
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.training import optim
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        arch, gbatch, mbs, _ = TRAIN_CELLS[0]  # phase 14's llama3-8b cell
        cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_LAYERS)
        model = get_model(cfg)
        tc = TrainConfig(adam=optim.AdamWConfig(lr=TRAIN_LR),
                         num_microbatches=mbs, warmup_steps=1,
                         total_steps=50, vocab_chunk=TRAIN_CHUNK)
        dc = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=gbatch)
        batches = [global_batch(dc, i) for i in range(SHARD_STEPS)]
        state = init_train_state(model, torch.Generator("cuda").manual_seed(0))
        host = tree_to(state, "cpu")
        del state
        torch.cuda.empty_cache()
        pspecs = shd.param_pspecs(host["master"], mesh)
        runs = {}
        for label in ("unsharded", "sharded"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            st = tree_to(host, "cuda")
            if label == "sharded":
                st = shd.distribute(st, shd.param_shardings(st, mesh))
                step = make_train_step(
                    model, tc, param_pspecs=pspecs,
                    batch_pspecs=shd.batch_pspecs(batches[0], mesh))
            else:
                step = make_train_step(model, tc)
            resident = torch.cuda.memory_allocated() - base
            losses, gnorms, ms = [], [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = step(st, b)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            local = {k: optim.tree_map(
                lambda x: x.to_local() if hasattr(x, "to_local") else x,
                st[k]) for k in ("master", "m", "v")}
            runs[label] = {
                "losses": losses, "grad_norms": gnorms, "step_ms": ms,
                "step_ms_warm_median": float(np.median(ms[1:])),
                "peak_bytes_above_resident":
                    torch.cuda.max_memory_allocated() - base - resident,
                "digest": state_digest(local),
                "comm_bytes": dict(getattr(step, "comm", {}))}
            if label == "unsharded":  # (b) saves these parameters
                params = optim.model_params({"master": local["master"]},
                                            cfg.dtype)
                params = tree_to(params, "cpu")
            del st, local, m
            gc.collect()
            torch.cuda.empty_cache()
        a, b = runs["unsharded"], runs["sharded"]
        same = (a["losses"] == b["losses"] and a["grad_norms"]
                == b["grad_norms"] and a["digest"] == b["digest"])
        for r in runs.values():
            del r["digest"]
        out["train"] = {"arch": arch, "layers": cfg.num_layers,
                        "batch": gbatch, "seq": TRAIN_SEQ,
                        "microbatches": mbs, "mesh": [1, 1],
                        "bit_for_bit": same, **runs}
        log(f"sharding: {arch} {cfg.num_layers} layers, sharded step at "
            f"world 1 against the unsharded one: bit for bit {same}; "
            f"{runs} [{card}]")
        if not same:
            raise AssertionError(f"sharding: the sharded step at world 1 "
                                 f"differs from the unsharded: {runs}")
        # (b) the bf16 parameters saved and restored through elastic_restore
        d = tempfile.mkdtemp(dir=tmp)
        sharded = shd.distribute(tree_to(params, "cuda"),
                                 shd.param_shardings(params, mesh))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(d, 1, sharded)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        restored, step_no = elastic.elastic_restore(d, params, mesh)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        got = [x.to_local() for x in flatten(restored)[0]]
        want = [x.to_local() for x in flatten(sharded)[0]]
        same = step_no == 1 and all(
            g.dtype == w.dtype and torch.equal(
                g.contiguous().view(torch.uint8),
                w.contiguous().view(torch.uint8))
            for g, w in zip(got, want))
        nbytes = sum(x.numel() * x.element_size() for x in want)
        out["elastic"] = {"bytes": nbytes, "save_ms": save_ms,
                          "restore_ms": restore_ms, "bit_for_bit": same,
                          "grid_of_8": list(elastic.best_grid(8))}
        log(f"sharding: elastic_restore of {nbytes} B of bf16 parameters "
            f"at world 1: save {save_ms:.0f} ms, restore {restore_ms:.0f} "
            f"ms, bit for bit {same} [{card}]")
        del sharded, restored, got, want, params
        if not same:
            raise AssertionError("sharding: elastic_restore changed bits")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 18: the op trace (roofline.op_trace) ------------------------------

#: phase 18 (b): items of the same calls on the card and on the CPU
TRACE_SMALL_ITEMS = 1 << 14
#: phase 18 (c): WordCount pairs of the two distributed runs a mesh size
TRACE_DIST_PAIRS = (1 << 20, 1 << 22)
TRACE_DIST_VOCAB = 1 << 13
#: PR 29's readings of the dry-run's two gated cells (pod mesh), by
#: ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh pod``
#: at commit 97f7553: FLOPs and bytes a chip (FlopCounterMode over the
#: matmuls, ATen operands with the optimizer counted M times), wire bytes
#: a chip (the step's own count)
DRYRUN_PR29 = {
    "llama3-8b/train_4k": {"flops_per_chip": 4182404793106432.0,
                           "bytes_per_chip": 78659471892672.0,
                           "collective_bytes_per_chip": 46141685760.0},
    "qwen3-moe-30b-a3b/decode_32k": {
        "flops_per_chip": 1153546846208.0, "bytes_per_chip": 280479591232.0,
        "collective_bytes_per_chip": 81382932480.0},
}


def event_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event milliseconds of ``fn()`` on the current stream
    after a warm-up call: the device's time from the call's first
    operation to its last, host gaps between them included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ops(cost) -> dict:
    """The ``repro_torch::<kernel>`` ops of an ``OpCost``: calls, bytes."""
    return {k: {"calls": v, "bytes": cost.bytes_by_op[k]}
            for k, v in sorted(cost.op_counts.items())
            if k.startswith("repro_torch::")}


#: KMeans at 2^24 points: the stream flow's traced peak before B1 folded
#: the counts column itself (phase 18's reading on the card with the
#: [values, valid] fold, NVIDIA H100 80GB HBM3, 700.00 W)
KMEANS_STREAM_PEAK_BEFORE = 155_827_200


def traced_flows(card: str, label: str, make, items, check, *,
                 kernels=None, bytes_gate: bool = False) -> dict:
    """Phase 18 (a) for one app: the stream, combine and reduce flows'
    traced bytes, FLOPs and peak, the modelled bytes, an untraced warm
    call's device time and the traced bytes over it as a share of
    HBM_BYTES_PER_S; every launch counted in a traced call is one op of
    its trace.  The stream and combine flows' peaks again over the first
    half of the items: the stream flow's stays (its chunk's and its
    tables'), the combine flow's grows with the pairs.  ``kernels``
    (stream kernel, combine kernel) gates the stream flow: no more bytes
    than the combine flow, the same FLOPs in its kernel ops as the combine
    flow's, and a peak no higher than :data:`KMEANS_STREAM_PEAK_BEFORE`;
    ``bytes_gate`` (or ``kernels``) gates the stream flow's bytes at no
    more than the combine flow's."""
    import torch
    from repro_torch.kernels import ops

    out = {}
    for flow in ("stream", "combine", "reduce"):
        comp = make(flow).lower(items).compile()
        ops.reset_launch_counts()
        cost = comp.traced_cost(items)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        traced = {k.split("::", 1)[1]: v for k, v in cost.op_counts.items()
                  if k.startswith("repro_torch::")}
        if launches != traced:
            raise AssertionError(f"traced {label} {flow}: launches "
                                 f"{launches} != kernel ops {traced}")
        check(flow, comp(items))
        dev = event_ms(lambda c=comp: c(items))
        share = cost.bytes_accessed / (dev * 1e-3) / HBM_BYTES_PER_S
        out[flow] = {
            "traced_bytes": cost.bytes_accessed, "flops": cost.flops,
            "kernel_flops": {k: v for k, v in cost.flops_by_op.items()
                             if k.startswith("repro_torch::")},
            "peak_bytes": cost.peak_bytes,
            "model_bytes": comp.cost_analysis()["model_bytes"],
            "device_ms": dev, "hbm_share": share, "launches": launches,
            "top_bytes": cost.top_bytes(4), "card": card}
        log(f"traced {label} {flow}: {cost.bytes_accessed:.6g} B, "
            f"{cost.flops:.6g} FLOPs, peak {cost.peak_bytes:.6g} B, model "
            f"{out[flow]['model_bytes']:.6g} B, device {dev:.4f} ms, "
            f"{share:.4f} of 3.35 TB/s, launches {launches} [{card}]")
    b = {f: out[f]["traced_bytes"] for f in out}
    p = {f: out[f]["peak_bytes"] for f in out}
    half = torch.utils._pytree.tree_map(lambda t: t[:t.shape[0] // 2], items)
    p_half = {f: make(f).lower(half).compile().traced_cost(half).peak_bytes
              for f in ("stream", "combine")}
    out["stream_le_combine"] = b["stream"] <= b["combine"]
    out["stream_over_combine_bytes"] = b["stream"] / b["combine"]
    out["stream_over_combine_peak"] = p["stream"] / p["combine"]
    out["half_items_peak_bytes"] = p_half
    log(f"traced {label}: peaks at half the items {p_half}; stream over "
        f"combine peak {p['stream'] / p['combine']:.4f}, stream bytes <= "
        f"combine bytes: {out['stream_le_combine']} [{card}]")
    if not (b["stream"] < b["reduce"] and b["combine"] < b["reduce"]):
        raise AssertionError(f"traced {label}: an optimized flow moves no "
                             f"fewer bytes than the reduce flow: {b}")
    if bytes_gate and not out["stream_le_combine"]:
        raise AssertionError(f"traced {label}: the stream flow moves more "
                             f"bytes than the combine flow: {b}")
    if kernels is not None:
        kf = {f: sum(v for k, v in out[f]["kernel_flops"].items()
                     if k == f"repro_torch::{name}")
              for f, name in zip(("stream", "combine"), kernels)}
        log(f"traced {label}: stream over combine bytes "
            f"{b['stream'] / b['combine']:.4f}, kernel FLOPs {kf}, stream "
            f"FLOPs {out['stream']['flops']:.6g}, stream peak "
            f"{p['stream']:.6g} B (before: {KMEANS_STREAM_PEAK_BEFORE}) "
            f"[{card}]")
        if not (b["stream"] <= b["combine"] and kf["stream"] > 0
                and kf["stream"] == kf["combine"]
                and p["stream"] <= KMEANS_STREAM_PEAK_BEFORE):
            raise AssertionError(
                f"traced {label}: the stream flow moves more bytes than the "
                f"combine flow, or its kernels' FLOPs differ, or its peak "
                f"rose: bytes {b}, kernel FLOPs {kf}, peak {p['stream']}")
    if not (0 < p["stream"] < p["combine"] / 2
            and p["stream"] <= 1.05 * p_half["stream"]
            and p["combine"] >= 1.5 * p_half["combine"]):
        raise AssertionError(f"traced {label}: the stream flow's peak is "
                             f"not under half the combine flow's, or not "
                             f"flat in the items, or the combine flow's "
                             f"does not grow: {p}, half {p_half}")
    return out


def traced_on_card(card: str, pts, assign, items, dryrun: dict) -> dict:
    """Phase 18: ``Compiled.traced_cost`` on the card.  (a) KMeans (2^24
    points; the reduce flow's Lmax the largest count, as phase 7) and
    WordCount (2^24 zipf tokens, 2^16 words) in the stream,
    combine and reduce flows (:func:`traced_flows`): the optimized flows
    under the reduce flow in bytes, the stream flow's peak under half the
    combine flow's and flat from half the items to all (the combine
    flow's grows), every counted launch an op of the trace; KMeans's
    stream flow moves no more bytes than its combine flow, with the same
    kernel FLOPs, and so does WordCount's (its integer stream fold one
    ``int_fold`` op a chunk).  (b) The stream and combine flows of both at 2^14
    items, kernels on, on the card and on the CPU at one chunk size: their
    kernel ops and bytes equal.  (c) ``run_distributed`` of WordCount on
    ``LocalMesh(S)``, S = 2 and 4, stream and reduce flows at 2^20 and
    2^22 pairs: the stream flow's wire bytes a shard equal at both sizes,
    the reduce flow's grow.  (d) The dry-run's two gated cells (phase 17's
    rows) beside PR 29's readings."""
    import torch
    from repro_torch import ExecutionOptions, MapReduce, ShuffleOptions, apps
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.data import datasets
    from repro_torch.distributed import LocalMesh

    t_phase = time.perf_counter()
    out = {"card": card}
    km_counts, km_cent = kmeans_centroids(pts, assign)
    toks, vocab = datasets.wordcount_data(
        np.random.default_rng(6), tokens=DIST_WC_TOKENS, vocab=DIST_WC_VOCAB)
    witems = torch.from_numpy(toks.reshape(-1, 16)).cuda()
    wc_want = np.bincount(toks, minlength=vocab)
    lmax = apps.WordCount(vocab).max_values_per_key

    def km_check(flow, res):
        if not np.array_equal(res.counts.cpu().numpy(), km_counts):
            raise AssertionError(f"traced kmeans {flow}: counts")
        np.testing.assert_allclose(res.values.cpu().numpy(), km_cent,
                                   rtol=1e-5, atol=1e-5)

    def wc_check(flow, res):
        got = res.values.cpu().numpy()
        if not np.array_equal(res.counts.cpu().numpy(), wc_want):
            raise AssertionError(f"traced wordcount {flow}: counts")
        # the reduce flow folds a key's first Lmax values (its windows)
        keep = wc_want <= lmax if flow == "reduce" else slice(None)
        if not np.array_equal(got[keep], wc_want[keep]):
            raise AssertionError(f"traced wordcount {flow}: values")

    def kmeans(flow):  # the reduce flow's windows hold every value (phase 7)
        app = apps.KMeans()
        if flow == "reduce":
            app.max_values_per_key = int(km_counts.max())
        return MapReduce(app, flow=flow)

    out["kmeans"] = traced_flows(card, "kmeans", kmeans, items, km_check,
                                 kernels=("onehot_fold", "onehot_combine"))
    out["wordcount"] = traced_flows(
        card, "wordcount", lambda f: MapReduce(apps.WordCount(vocab),
                                               flow=f), witems, wc_check,
        bytes_gate=True)

    # (b) the same calls on the card and on the CPU
    n = TRACE_SMALL_ITEMS
    small = {"kmeans": (apps.KMeans(), (torch.from_numpy(assign[:n]),
                                        torch.from_numpy(pts[:n]))),
             "wordcount": (apps.WordCount(vocab),
                           torch.from_numpy(toks[:16 * n].reshape(n, 16)))}
    same = {}
    for label, (app, host) in small.items():
        card_items = torch.utils._pytree.tree_map(lambda t: t.cuda(), host)
        for flow in ("stream", "combine"):
            got = {}
            for dev, it in (("cuda", card_items), ("cpu", host)):
                mr = MapReduce(app, flow=flow, device=dev, use_kernels=True,
                               stream_chunk_pairs=CUDA_CHUNK_PAIRS)
                got[dev] = kernel_ops(mr.lower(it).compile().traced_cost(it))
            if got["cuda"] != got["cpu"]:
                raise AssertionError(f"traced {label} {flow} at {n} items: "
                                     f"card {got['cuda']} != CPU "
                                     f"{got['cpu']}")
            same[f"{label}_{flow}"] = got["cuda"]
    out["card_equals_cpu"] = same
    log(f"traced: kernel ops at {n} items, card == CPU: {same} [{card}]")

    # (c) wire bytes a shard against the pair count (the paper's Fig 5)
    rng = np.random.default_rng(7)
    wire = {}
    for S in (2, 4):
        for flow in ("stream", "reduce"):
            row = []
            for pairs in TRACE_DIST_PAIRS:
                t = rng.integers(0, TRACE_DIST_VOCAB, pairs).astype(np.int32)
                it = torch.from_numpy(t.reshape(-1, 16)).cuda()
                mr = MapReduce(apps.WordCount(TRACE_DIST_VOCAB), flow=flow)
                low = mr.lower(it, options=ExecutionOptions(
                    mesh=LocalMesh(S), shuffle=ShuffleOptions(
                        capacity=pairs // S, strict=True)))
                res = low.compile()(it).gather_result()
                if not np.array_equal(res.counts.cpu().numpy(), np.bincount(
                        t, minlength=TRACE_DIST_VOCAB)):
                    raise AssertionError(f"traced wordcount {flow} S={S}: "
                                         f"counts")
                cost = low.traced_cost(it)
                row.append({"pairs": pairs, "wire_bytes_a_shard":
                            cost.collective_bytes,
                            "by_op": cost.collective_ops})
            wire[f"{flow}_S{S}"] = row
            a, b = (r["wire_bytes_a_shard"] for r in row)
            grows = b > a
            if (flow == "stream" and (a != b or a <= 0)) or (
                    flow == "reduce" and not grows):
                raise AssertionError(f"traced wordcount {flow} S={S}: wire "
                                     f"{a} -> {b}")
            log(f"traced wordcount {flow} LocalMesh({S}): wire bytes a "
                f"shard {a:.6g} at {row[0]['pairs']} pairs, {b:.6g} at "
                f"{row[1]['pairs']}; by op {row[1]['by_op']} [{card}]")
    out["wire"] = wire

    # (d) the dry-run's gated cells: phase 17's rows beside PR 29's
    cells = {}
    for key, old in DRYRUN_PR29.items():
        new = dryrun[key]
        cells[key] = {k: {"pr29": old[k], "now": new[k]} for k in old}
        cells[key]["collective_ops"] = new["collective_ops"]
        log(f"traced dry-run {key} (pod, modelled): {cells[key]}")
    out["dryrun"] = cells
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"traced: phase 18 in {out['phase_wall_s']:.1f} s [{card}]")
    return out


# -- phase 19: the examples on the card (A16) ----------------------------------

#: the single-card examples of examples/torch/ and their arguments
EXAMPLE_ARGS = {"quickstart": [], "pipeline_wordcount_topk": [],
                "serve_lm": [], "train_lm": ["--steps", "4"]}


def examples_on_card(card: str) -> dict:
    """Phase 19: the port's single-card examples (``examples/torch/``),
    each run in this process through its ``main`` on the card (its default
    device): quickstart's counts against ``np.bincount``, the pipeline's
    fused result against its unfused run (inside the example), serve_lm's
    tokens twice the same, train_lm's losses finite; each one's wall."""
    import importlib.util
    import math

    import torch

    out = {"card": card}
    mods = {}
    for name in EXAMPLE_ARGS:
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", ROOT / "examples" / "torch" /
            f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    t_phase = time.perf_counter()
    for name, args in EXAMPLE_ARGS.items():
        t0 = time.perf_counter()
        got = mods[name].main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "quickstart":
            ids = mods[name].windows_of(mods[name].TEXT).reshape(-1)
            want = np.bincount(ids[ids < mods[name].VOCAB],
                               minlength=mods[name].VOCAB)
            ok = (got.counts.device.type == "cuda" and np.array_equal(
                got.counts.cpu().numpy(), want))
        elif name == "pipeline_wordcount_topk":
            ok = got[0].values.device.type == "cuda"
        elif name == "serve_lm":
            again = mods[name].main(args)
            ok = got.device.type == "cuda" and torch.equal(got, again)
        else:
            ok = len(got) == 4 and all(map(math.isfinite, got.values()))
        if not ok:
            raise AssertionError(f"example {name} on the card: {got}")
        out[name] = {"wall_s": wall}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"examples: {out} [{card}]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data import datasets
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # IEEE f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)  # name, power limit: as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, "
        f"{len(_build.LIBRARIES)} libraries, into {_build.build_dir()})")
    for name in ("chunk_monoid_fold", "radix_partition", "segment_reduce",
                 "flash_decode", "int_fold"):
        log(f"build: {name}: " + "; ".join(
            f"{r['function']} {r['registers']} registers, {r['smem_bytes']} "
            f"B static smem, {r['spill_bytes']} B spilled"
            for r in _build.ptxas_report(name)))
    lane = [r for r in _build.ptxas_report("onehot_fold")
            if "lane_fold" in r["function"]]
    if not lane:
        raise AssertionError("build: no lane-table kernel in onehot_fold")
    log("build: lane-table fold (onehot_fold): " + "; ".join(
        f"{r['function']} {r['registers']} registers, {r['smem_bytes']} B "
        f"static smem, {r['spill_bytes']} B spilled" for r in lane))

    rng = np.random.default_rng(0)
    check_kernels(rng)
    check_counts_column(rng)
    check_int_fold(rng)
    check_sort_kernels(rng)
    check_combine_kernels(rng)
    check_lane_folds(rng)
    check_flash_decode(rng)
    ops_count = early_device_ops()

    pts, assign, clusters = datasets.kmeans_data(
        np.random.default_rng(1), points=N_POINTS)
    assert clusters == 100
    mr_add, items, launches_add, first_plan_ms = main_path_additive(
        pts, assign)
    mr_dense, launches_dense = main_path_dense(pts, assign, items)
    int_runs = main_path_int_fold()
    phoenix_on_card()
    sort_runs = {k: main_path_sort(k) for k in SORT_KEY_SPACES}
    phoenix_on_card("sort")
    combine_runs = main_path_combine(pts, assign, items)
    mr_large, items_large = main_path_combine_large_k()
    phoenix_on_card("combine")
    mr_reduce = main_path_reduce(pts, assign, items)
    phoenix_on_card("reduce")
    hinted = cost_model_on_card(card)
    serve = main_path_serve()
    staged_on_card(card, items, first_plan_ms)
    streaming = streaming_on_card(card, pts, assign, items)
    distributed = distributed_on_card(card, pts, assign, items)
    log(json.dumps({"distributed": distributed}))
    resilient = resilient_on_card(card, pts, assign, items)
    log(json.dumps({"resilient": resilient}))
    log(json.dumps({"train": train_on_card(card)}))
    moe = moe_on_card(card)
    ssm = ssm_on_card(card)
    sharding = sharding_on_card(card)
    log(json.dumps({"sharding": sharding}))
    log(json.dumps({"traced": traced_on_card(card, pts, assign, items,
                                             sharding["dryrun"])}))
    log(json.dumps({"examples": examples_on_card(card)}))

    rows = kernel_rows(rng, launches_add, launches_dense, ops_count)
    for row in rows:  # B1, B2: their launches on the streaming path too
        row["streaming_launches"] = {
            label: run["launches"]
            for label, run in streaming["parity"].items()
            if (row["name"] == "chunk_monoid_fold")
            == (label == "bounding_box")}
    launches_sort = {name: sum(run[2][name] for run in sort_runs.values())
                     for name in ("radix_partition", "radix_partition_multi",
                                  "segment_reduce")}
    rows += cell_fold_rows(rng)
    rows += sort_kernel_rows(rng, launches_sort, ops_count)
    rows += combine_kernel_rows(rng, {
        "onehot_combine": combine_runs["kmeans"][1]["onehot_combine"],
        "combine_scatter":
            combine_runs["kmeans_scatter"][1]["combine_scatter"]},
        ops_count)
    rows += int_fold_rows(rng, {
        "wordcount": int_runs["wordcount"][2]["int_fold"],
        "histogram": int_runs["histogram"][2]["int_fold"],
        "counts_k100": launches_dense["int_fold"]}, ops_count)
    for row in rows:  # B1-B7, int_fold: their launches a shard on the
        # distributed path
        row["distributed_launches"] = {
            label: [s.get(row["name"], 0) for s in shards]
            for label, shards in distributed["launches"].items()
            if any(s.get(row["name"], 0) for s in shards)}
    for row in rows:  # B1-B7, int_fold: their launches on the resilient path
        row["resilient_launches"] = {
            label: total[row["name"]]
            for label, total in resilient["launches"].items()
            if total.get(row["name"], 0)}
    rows.append(flash_decode_rows(rng, serve["launches"], ops_count,
                                  moe["launches"], ssm["launches"]))
    log(json.dumps({"combine_route_sweep": {"card": card,
                                            **combine_route_sweep(rng)}}))
    log(json.dumps({"keyed_fold_sweep": {"card": card,
                                         **keyed_fold_sweep(rng)}}))
    log(json.dumps({"radix_pass_sweep": {"card": card,
                                         **radix_pass_sweep()}}))
    main_ms = {"kmeans_ms": run_ms(mr_add, items),
               "bounding_box_ms": run_ms(mr_dense, items),
               "points": N_POINTS, "card": card}
    for k, (mr, sitems, _) in sort_runs.items():
        main_ms[f"keyed_sum_K{k}_ms"] = run_ms(mr, sitems)
    main_ms["sort_pairs"] = SORT_ITEMS * 8
    flows = {"kmeans_combine": combine_runs["kmeans"][0],
             "bounding_box_combine": combine_runs["bounding_box"][0],
             "kmeans_scatter_combine": combine_runs["kmeans_scatter"][0],
             "kmeans_reduce": mr_reduce}
    for label, mr in flows.items():
        main_ms[f"{label}_ms"] = run_ms(mr, items)
    # the paper's quantity: the baseline reduce flow over an optimized flow
    main_ms["kmeans_reduce_over_combine"] = (main_ms["kmeans_reduce_ms"]
                                             / main_ms["kmeans_combine_ms"])
    main_ms["kmeans_reduce_over_stream"] = (main_ms["kmeans_reduce_ms"]
                                            / main_ms["kmeans_ms"])
    main_ms[f"keyed_sum_combine_K{COMBINE_LARGE_K}_ms"] = run_ms(
        mr_large, items_large)
    for label in ("bounding_box", "kmeans_scatter"):
        main_ms[f"{label}_combine_routes"] = scatter_routes(
            combine_runs[label][0], items)
    main_ms["combine_large_k_pairs"] = COMBINE_LARGE_ITEMS * 8
    for label, run in hinted.items():
        main_ms[f"{label}_auto_hint_ms"] = run["wall_ms"]
    for label, (mr, iitems, _) in int_runs.items():
        main_ms[f"{label}_ms"] = run_ms(mr, iitems)
    log(json.dumps({"main_path": main_ms}))
    log(json.dumps({"serve": {"card": card, **serve}}))
    log(json.dumps({"moe": moe}))
    log(json.dumps({"ssm": ssm}))
    for label, mr in (("kmeans", mr_add), ("bounding_box", mr_dense),
                      *flows.items()):
        log(json.dumps({"profile": label,
                        **profile(mr, items, main_ms[f"{label}_ms"])}))
    for k, (mr, sitems, _) in sort_runs.items():
        label = f"keyed_sum_K{k}"
        log(json.dumps({"profile": label,
                        **profile(mr, sitems, main_ms[f"{label}_ms"])}))
    for label, (mr, iitems, _) in int_runs.items():
        log(json.dumps({"profile": label,
                        **profile(mr, iitems, main_ms[f"{label}_ms"])}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
