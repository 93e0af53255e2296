#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  The phases
run in order and the first failure exits non-zero:

  1. the card and toolchain lines;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. each kernel, in each stored form (f32, bf16, int8, int4), against
     its plain PyTorch version, at the small test shapes and at the
     Sift1M shape (512 queries, full N, 10% tombstones); the fused
     kernel at k_scan 129 and 512 (its carry in device memory); and the
     merge kernel, bit for bit, on carries dense in ties (both zeros,
     masked tails) over a grid of splits x k_scan x M that runs both of
     its paths;
  4. the f32 main path at the Sift1M shape (N=1,000,000, D=128, l2, k=10,
     recall target 0.95, 10,000 queries): ``Index.build`` -> ``search``
     -> recall against an exact oracle -> ``add`` 10,000 rows ->
     ``delete`` 50,000 ids -> ``search`` again, and the two-pass path
     (``fused_select=False``) against the fused one;
  5. the same at the Glove1.2M shape (N=1,183,514, D=100, cosine), with
     fewer queries after the updates;
  6. the quantized main path: phase 4 once per storage tier (bf16, int8,
     int4) at the Sift1M shape, and int4 at the Glove1.2M shape (2,000
     queries after the updates), each also checking that the returned
     values are the exact scores of the returned ids (the rescore ran);
  7. launch counts, read after each path (every kernel of the path
     launched, no plain version called; 2 launches a fused search, 1 a
     two-pass one); then each kernel against its plain version at the
     main paths' own shapes (all 10,000 queries);
  8. CUDA-event timings at the Sift1M shape, f32 and each tier, of both
     scan kernels at M=10,000 and M=16 beside their bounds (tensor
     cores, bytes, the instructions a score the function needs; beside
     them the kernel's own epilogue count and the f32 FFMA bound of the
     earlier kernel) and their earlier times, each tier's stored bytes
     per row, the fused kernel at k_scan 32 (carry in shared memory), 33
     and 512 (in device memory), and the launches of one search; and per
     tier at M=10,000 and M=16 (and int4 at k=20) the merge at the split
     count the plan chose, checked bit for bit, beside its byte bound, an
     empty kernel's launch and ``torch.topk`` over the same carries (device
     times of calls queued back to back);
  9. the planner and the bitonic network: ``detect_device()`` must name
     the ``"h100"`` profile; each Sift1M tier's model plan (and Glove1.2M
     f32's) must have PERF.md's bins, and ``explain(measure=True)`` at
     M=10,000 and M=16 prints the predicted bound, its wall and the
     measured search (a prediction within 1% of phase 8's tensor bound
     at M=10,000 and byte bound at M=16, and no search faster than 0.95
     x its prediction); ``plan="measure"`` at the Sift1M shape (f32,
     int4) prints each candidate's time and the winner, a second build
     on the same cache must time nothing and give the same plan, and its
     search passes phase 4's recall check; ``exact_rescoring`` with the
     bitonic network on 10,000 x 60 candidates against the stable sort,
     and an int8 search with ``use_bitonic=True`` against the default
     one, both timed; an int4 index of 12 rows grown by 100 without
     growth must take ``k_scan`` 30 and search as the same index on the
     CPU.  Its searches are one more path whose launches are counted;
 10. the one-pass forms (bf16 queries, ``dtype="bfloat16"``): each of the
     six one-pass instantiations against its plain version at the small
     test shapes and on 512 queries at the Sift1M shape, and bit for bit
     on integer-valued inputs; then ``dtype="bfloat16"`` indexes at the
     Sift1M shape (storage f32, int8, int4) searched at M=10,000 and
     M=16, recall against an exact oracle in the compute dtype (the
     bf16-cast rows, prepared as the index prepares them) at E[recall] -
     eps, the launch counts of the path (the one-pass kernels, no plain
     version), and the kernels' and searches' times beside the tensor,
     score-operation and byte bounds of one pass (and the kernel's own
     epilogue count);
 11. clusters on Gaussian data (C3): ``Index.build(db)`` at the Sift1M
     shape (``cluster="auto"``, the default) timed beside
     ``cluster="off"``: the crossover enables pruning, the ``"h100"``
     profile must veto it (both predicted times printed), the build must
     run no k-means, and the search must be bit-identical to
     ``cluster="off"``;
 12. clusters on a mixture corpus (the Sift1M shape drawn as
     ``tests/test_cluster.py`` draws its corpora: 64 components, centers
     N(0, 1) x 2.5, unit noise, queries from the same centers): the plan
     must be C=1024, R=1224, 32 probes, a spill block of 15,632; the
     build's seconds (k-means, the host assignment loop, the miss check)
     and its sampled miss rate; recall at E[recall] - eps (the collision
     x miss product) for f32 and int8, before and after an add of 10,000
     rows and a delete of 50,000; the pruned search timed at M=10,000 and
     M=16 beside the same corpus with ``cluster="off"``, the ``"h100"``
     profile's prediction of each and the peak device memory.  The indexes
     are built with ``profile="a100"``, which keeps the reference's
     decision (the card's own profile vetoes the pruned scan).  The pruned
     scan is plain PyTorch (the reference has no Pallas kernel there), so
     its path must launch no kernel and call no plain version;
 13. serving at the Sift1M shape, for the f32 tier, int8 and f32 at bf16
     compute: ``SearchServer(index, warmup=True)`` captures one CUDA graph
     per bucket (the ladder, the captures and each bucket's warm-up and
     capture seconds printed; each graph must hold the path's scan and
     merge once and no plain version); a seeded stream of 200 requests of
     1-64 rows, each with its own k, on a virtual clock, every ticket
     bit-equal to a direct ``Index.search`` of its rows and every batch a
     graph replay; at M=16 an eager call, a replay with its host round
     trip, a served request from submit to result and the card's queued
     time; a transient fault at ``serve.dispatch`` retried to the clean
     result; then four threads sending 2,000 requests on the wall clock,
     with an add of 10,000 rows (growth: recapture) and a delete of 50,000
     under ``server.mutation()`` midway: QPS, occupancy, p50 and p99,
     replays against batches, recaptures, and every request after the
     mutation bit-equal to a direct search;
 14. snapshots: a card index (f32 and int8, with and without cluster
     tables) saved and restored on the card, searching bit for bit the
     same with no build work at restore, and an index written on the CPU
     restored on the card;
 15. the host-RAM cold tier at the Sift1M shape (``residency="host"``):
     the f32 index of 131,072-row segments (eight waves of whole bins)
     bit-equal to the HBM index at M=10,000 and M=16, before and after
     add 10,000 / delete 50,000; f32, int8 and int4 under the budget that
     ``plan_segments`` turns into nine waves: recall at the wave plan's
     E[recall] - eps before and after the same updates, two launches and
     one ``"host"`` dispatch a wave and no plain version, the device
     memory a search adds (its two slots within the budget, and no more
     query-sized work than the HBM index's search), each kernel against
     its plain version at a wave's shape; the pinned link's rate, each
     wave's copy and scan (CUDA events) and the search beside
     max(copies, scans) at M=10,000 and M=16;
 16. kNN-LM serving at full width: a ``KNNDatastore`` of 2^21 Gaussian
     keys at D=2048 (f32, 16 GiB, k=32, room for 65,536 more; its
     build's seconds and the h100 profile's cluster decision), lookups
     of 1,024 queries at E[recall] - eps against an exact oracle before
     and after ``extend`` 65,536 / ``forget`` 100,000 (two launches a
     lookup, no plain call), the functional ``search`` over the raw
     keys, and a served lookup bit-equal to a direct one; internlm2-1.8b
     FULL (bf16, random weights from ``--seed``) behind
     ``ServingEngine(batch=8, max_seq=2048)``: 8 prompts of 64 tokens,
     32 decode steps with exact and with kNN attention, each step's
     input token embeddings looked up directly and through the
     ``SearchServer`` (bit-equal, one graph replay) and mixed by
     ``knn_lm_logits``; finite logits, no padded id sampled, kNN
     attention's keys at the last step at E[recall] - eps; then the
     fused scan, the merge and the two-pass scan at this shape (M=8 and
     M=128) against their plain versions (phase 7's tolerances) and
     timed beside their bounds, and the decode step beside its weight
     bytes;
 17. the other model families at full width: granite-moe-3b-a800m
     (32 layers, 40 experts top-8, bf16) as phase 16 over a datastore of
     2^21 Gaussian keys at its d_model, D=1536 (12 stages a tile; value
     tokens in its vocabulary), the kNN run with ``router_topk_impl=
     "approx"``, the D=1536 kernels against their plain versions and
     timed; then behind ``ServingEngine(batch=8, max_seq=2048)``, 8
     prompts of 64 tokens and 16 decode steps each: deepseek-v2-236b at
     4 of its 60 layers (one ``mla_dense``, three ``mla_moe``; exact and
     kNN attention), mamba2-2.7b, qwen2-vl-2b (exact and kNN, and a
     prefill step from (8, 64, 1536) patch embeddings) and
     recurrentgemma-9b; whisper-medium's prefill step over (8, 1500,
     1024) frame embeddings and a 64-token prompt, then the prompt and
     16 sampled steps through ``make_decode_step`` with its cross KV;
     each model's decode step beside its weight bytes, its init and
     its seconds, each freed before the next; no plain kernel version
     on any of these paths;
 18. the rest of the search package and sharding, at the Sift1M shape:
     ``stream=False`` (f32, int8) at M=10,000, one dispatch and two
     launches a ``query_block`` and no plain call, bit-equal to the
     one-call search, both timed, and ``explain(validate_hlo=True)`` at
     M=16 and M=10,000 within 1%; the index on a mesh of 4 logical shards
     of ``cuda:0`` (f32, int8, int4): 2 launches a shard at M=10,000 and
     M=16 and no plain call, recall at E[recall] - eps, bit-equal to the
     composition of each shard's rows searched alone (recall against the
     global N), offset and merged; each shard's kernels against their
     plain versions; a (2, 2) mesh with ``batch_axis`` bit-equal to 2
     shards; add 10,000 / delete 50,000 with recall and no deleted id;
     times beside the unsharded index's and the kernel rows at the
     shard's shape; a ``KNNDatastore`` of 2^19 x 2048 keys over 2
     logical shards (recall, a served lookup bit-equal to a direct one);
     ``_knn_decode_attention_cp`` over 4 shards at internlm2-1.8b's
     decode shape (batch 8, S=2,048) against the unsharded attention;
     ``explain(measure=True)`` on the 4 logical shards reports (f32) a
     ``roofline_fraction`` within 20% of the unsharded index's (C7);
 19. training: the kNN workload registry at full N (``make_vector_
     dataset`` for Sift1M and Glove1.2M, ``Index.build(..., cluster=
     "off")`` with the registry plan's bins and ``k_scan``, a search at
     M=10,000 at E[recall] - eps, the fused scan and the merge launched,
     no plain version); each of the ten smoke configs trained 5 steps at
     lr 3e-3 (finite, the loss falling, the first step's loss and
     grad_norm within 1e-4 and 1e-3 relative of a CPU step's on the same
     weights and batch, an ``AsyncCheckpointer`` checkpoint restored
     onto the card bit for bit); internlm2-1.8b at
     full width (f32 masters, bf16 compute, ``remat="dots"``, batch 4 x
     2,048): a step's ms and tokens/s beside its ``model_flops`` bound,
     its peak memory beside the state's 16 bytes a parameter, and the
     lower peak of ``microbatches=2``;
 20. the mesh rules and the dry run: internlm2-1.8b's kNN decode step at
     full width over a long_500k cache (524,288 positions, or the
     largest power of two that fits), under ``use_mesh`` of a logical
     (1, 4) mesh of ``cuda:0`` with ``cell_rules(cfg, long_500k,
     mesh)``: every layer through ``_knn_decode_attention_cp``, layer
     0's recall at phase 18d's floor, the logits beside the unsharded
     kNN step's, both timed, beside the dry run's count of the cell; the
     trainer with ``--model-parallel 2`` bit-equal to ``1`` (PyTorch's
     deterministic algorithms on);
     ``remesh_state`` and ``restore_checkpoint(shardings=)`` onto the
     card bit for bit; ``count_cell`` of phase 19's full-width training
     shape on fake tensors against the same step run under
     ``FlopCounterMode`` (the same dot FLOPs), its counted peak beside
     ``torch.cuda.max_memory_allocated`` and its roofline beside the
     measured step;
 21. training across processes (``parallel.distributed``), every run
     with PyTorch's deterministic algorithms: one torchrun launch of two
     ranks (this script with ``--train-ranks``) starts before phase 20
     and waits while this process runs phase 20, then (a) one NCCL rank
     on a (1, 1) mesh in this
     process (a ``file://`` store), internlm2-1.8b at full width, batch
     4 x 2,048, 3 steps: every loss and grad_norm bit-equal to the
     single-process trainer's at the same seed; and the single-process
     references of (b) and (c), two steps each.  Then the ranks run (b)
     two ranks sharing ``cuda:0`` over gloo (host staged) on a (1, 2)
     tensor-parallel mesh, full width and depth, batch 2 x 2,048, 2
     steps, and (c) the same on a (2, 1) data-parallel mesh at 8 layers
     (two full-depth replicas do not fit one card): both steps' losses
     and grad norms within ``DIST_RTOL`` (relative, by step) of the
     single process's; each rank's peak memory and step seconds beside
     the single process's, rank 0's seconds in collectives, and where
     each run's seconds went; no kernel of the port and no plain version
     runs (training reaches none);
 22. ZeRO-3 across processes, the same launch's next run: granite-20b at
     full width (d_model 6,144, a single kv head, bf16 compute, ``"dots"``
     remat, its ``fsdp_params``) cut to 2 layers, two ranks sharing
     ``cuda:0`` over gloo on a (2, 1) mesh, so every parameter's embed dim
     is split over "data", each layer gathered as it runs and its
     gradients reduce-scattered, batch 2 x 2,048, 2 steps, against the
     single process (run before the go): both steps' losses and grad
     norms within ``ZERO3_RTOL``; each rank's state drawn by shards
     peaking at no more than its shard plus two of the largest whole
     leaf; each rank's step peak below the single process's; rank 0's
     all-gather and reduce-scatter calls, GB and seconds a step; no kernel
     or plain version runs.  recurrentgemma-9b's and deepseek-v2-236b's
     ZeRO-3 are held to the reference on the CPU only;
 23. tensor parallelism for the dense layer's other inputs, the same
     launch's next two runs, two ranks sharing ``cuda:0`` over gloo on a
     (1, 2) mesh, batch 2, 2 steps, each against its single process (run
     before the go): (q) qwen2-vl-2b at full width cut to 4 of its 28
     layers, 2,048 positions of float patch embeddings with M-RoPE (its
     embedding table never read), and (w) whisper-medium at full width
     cut to 4 encoder and 4 decoder layers, its decoder over 448 tokens
     (its text context) and its encoder over the 1,500 frames: both
     steps' losses and grad norms within ``TP_INPUTS_RTOL``; rank 0's
     all-reduces over "model" a step exactly those of the brackets
     (``tp_collectives``), with their MB and host seconds; each rank's
     step peak below the single process's; no kernel or plain version
     runs;
 24. tensor parallelism for MoE experts and MLA heads, the launch's runs
     after 23's, in the same way: (e) granite-moe-3b-a800m at full width
     (40 experts top-8, 20 a rank) cut to 4 of its 32 layers, batch 2 x
     2,048, and (m) deepseek-v2-236b at full width (128 MLA heads, 64 a
     rank) cut to its first layer (dense MLP: its first MoE layer's
     3.77B parameters, with their moments and gradients, pass what one
     card holds for two ranks and the single process; its MoE layers are
     held to the reference on the CPU only): both steps' losses and
     grad norms within ``TP_MOE_RTOL``; the all-reduces over "model" a
     step exactly ``tp_collectives``'s; each rank's state bytes and step
     peak below the single process's; and for (e) the (token, choice)
     pairs of step 1 whose expert (or whose place under the capacity)
     differs from the single process's routing (at most
     ``ROUTE_FLIP_LIMIT`` of them), and between the ranks (none may);
 25. tensor parallelism for the recurrent blocks, the launch's last two
     runs, in the same way: (s) mamba2-2.7b at full width (80 SSD heads,
     40 a rank; ``in_proj`` and the conv gathered over "model", since
     their contiguous cut does not follow the heads) cut to 4 of its 64
     layers, and (r) recurrentgemma-9b at full width cut to 3 of its 38
     layers (RG-LRU, RG-LRU, local attention: 2,048 of the 4,096 LRU
     channels and 8 of the 16 heads a rank, the one kv head whole, the
     dense gates' outputs reduce-scattered), batch 2 x 2,048: both steps'
     losses and grad norms within ``TP_RECURRENT_RTOL``; the all-reduces,
     all-gathers and reduce-scatters over "model" a step exactly
     ``tp_collectives``'s; each rank's step peak below the single
     process's.  recurrentgemma's single process (44 GB of f32 state
     whole) and its two ranks (22 GB each) do not fit the card at once:
     the single process runs in this process before the go, while the
     ranks hold only their CUDA contexts, and frees the card before they
     draw their shards;
 26. checkpoints a slab at a time and re-meshing in place, the launch's
     last run (:func:`ckpt_ranks`): (a) phase 22's granite-20b (full
     width, 2 layers, 16.4 GB of f32 state whole) steps once on (2, 1)
     (ZeRO-3), batch 2 x 2,048, and is saved twice, synchronously and
     with ``AsyncCheckpointer`` plus ``wait()``: the two byte-equal as
     arrays; (b) ``remesh_state`` moves it onto (1, 2), tensor
     parallelism; (c) the save restored at (1, 2) into a fresh shard is
     bit-equal to (b), and step 2 on each gives the same loss and
     grad_norm; (d) after the launch this process restores the save whole
     on ``cuda:0``, every leaf (cut as each rank held it) equal to the
     ranks' step-1 shards by sha256.  Each rank's ``HOST_PEAK`` over each
     save and the restore is at most one slab (the largest, the 49,152 x
     6,144 f32 embedding, 1.21 GB), its share (the async save's copy)
     and ``CKPT_SLACK``, beside the growth of its ``VmHWM`` (``ru_maxrss``
     where /proc/self/status has no such line) and the whole state the
     old path held on every rank (computed); the seconds of the
     saves, the restore and the re-mesh, the checkpoint's GB and the free
     disk before the saves (too little fails the run);
 27. a rank of eight whose attention runs whole, counted: a second
     torchrun launch of chip_smoke (``--train-ranks``), eight gloo ranks
     sharing ``cuda:0`` on a (1, 8) mesh, started after phase 26,
     trains starcoder2-7b at full width cut to 2 of its 32 layers, batch
     1 x 2,048, 2 steps at lr 3e-6 (``WHOLE``): its 36 query heads and 4
     kv heads stay whole on every rank (8 does not divide 36: the
     attention block runs whole, outside "f" and "g"), its d_ff of
     18,432 and its vocabulary of 49,152 split 8 ways.  Both steps' loss
     and grad norm against one process on ``cuda:0`` at the same weights
     and batch (run once every rank is ready, before the go) within
     ``WHOLE_RTOL``; step 2, the warm step, is timed; rank 0's
     collectives in step 1
     (calls and bytes by op and axes) equal to ``launch.dryrun
     .count_cell``'s count of the same step as rank 0 of a fake (1, 8)
     process mesh, and rank 0's dot FLOPs of step 1 under
     ``FlopCounterMode`` (step 2 runs bare) equal to the count's; each rank's step peak
     below the single process's; the step seconds and the share of them
     rank 0 spent in host-staged collectives; no kernel or plain
     version runs.

The build step prints, per kernel, ptxas's registers, spills and shared
memory, and the tensor-core (HGMMA) instructions in its SASS; a scan
instantiation without any, a scan or merge instantiation with a stack
frame or a spill, or a build without the six one-pass scan
instantiations fails the run.

It prints the ``kernels`` JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Data is random from
``--seed``; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

# H100 SXM peaks (NVIDIA data sheet): bf16 dense on the tensor cores (the
# scan's split products), f32 outside them (the earlier FFMA scan, kept as
# a column), HBM3, and CUDA-core instructions: 132 SMs x 4 schedulers x
# 32 lanes at the 1,980 MHz boost clock.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_INSTR = 132 * 4 * 32 * 1.98e9
# CUDA-core instructions per score that the scan's function needs,
# whatever the kernel: one add of the bias (one FFMA with the scale where
# there is one), then one compare and two selects (value and index) to
# keep the bin's winner.  This is the operations part of the bound.
SCORE_INSTR = 4
# Epilogue instructions per score of this kernel on the main paths (bins
# of 16 rows and more), counted from csrc/partial_reduce.cu: 1 add of the
# bias (and 1 multiply by the scale), 1.5 to pick the better of each
# thread's two rows, then 3 shuffle levels of 8 (two shuffles, three
# compares, two selects and a predicate) over half the scores.  The
# butterfly follows from the wgmma accumulator's layout, a choice of the
# kernel, so this count is printed beside the bound, never part of it.
EPILOGUE_INSTR = {"f32": 14.5, "bf16": 14.5, "int8": 15.5, "int4": 15.5}
# Tensor-core passes of the split product: three query parts against the
# stored rows, six products for f32 rows (split in three as well); one
# for bf16 queries (the one-pass forms).
PASSES = {"f32": 6, "bf16": 3, "int8": 3, "int4": 3}
ONE_PASS_FORMS = ("bf16", "int8", "int4")
# The scan kernels' times with the earlier FFMA main loop (Sift1M shape,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): (fused, two-pass) at
# M=10,000, and the fused one at M=16 (two-pass not timed there then).
FFMA_KERNEL_MS = {"f32": (86.228, 84.481, 1.963), "bf16": (82.944, 85.268, 1.784),
           "int8": (89.454, 82.503, 2.097), "int4": (167.508, 152.351, 3.771)}
DELTA = 1e-6  # Hoeffding false-failure budget of the recall checks

SIFT = dict(name="sift1m", n=1_000_000, d=128, metric="l2", m=10_000)
GLOVE = dict(name="glove1.2m", n=1_183_514, d=100, metric="cosine", m=10_000)
K, TARGET = 10, 0.95
TIERS = ("bf16", "int8", "int4")
FORMS = ("f32",) + TIERS
SRC = "src/repro_torch/kernels/csrc/partial_reduce.cu"
REF = "src/repro/kernels/partial_reduce.py"
# The Pallas body each (kernel, form) replaces: f32 as listed since the
# first slice (the entry points), bf16 the unscaled bodies, int8 and int4
# the scaled ones.
REPLACES = {
    ("partial_reduce_fused", "f32"): f"{REF}:417",
    ("partial_reduce_packed", "f32"): f"{REF}:352",
    ("partial_reduce_fused", "bf16"): f"{REF}:316",
    ("partial_reduce_packed", "bf16"): f"{REF}:285",
    ("partial_reduce_fused", "int8"): f"{REF}:323",
    ("partial_reduce_packed", "int8"): f"{REF}:300",
    ("partial_reduce_fused", "int4"): f"{REF}:323",
    ("partial_reduce_packed", "int4"): f"{REF}:300",
}


def log(*parts):
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hoeffding_eps(n: int) -> float:
    return math.sqrt(math.log(1.0 / DELTA) / (2.0 * n))


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def queued_ms(fn, reps: int = 50) -> float:
    """Device time per call of ``fn()``: ``reps`` calls queued behind a
    sleep kernel, so the card runs them back to back (one call between two
    events would time the host's Python as well, which is longer than a
    kernel of a few microseconds); the median of three such runs, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # holds the stream while the host queues
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def scan_bounds(form: str, m: int, n_pad: int, d: int, nbytes: float,
                passes=None) -> dict:
    """The scan's bound, the largest of its tensor-core passes over the
    lanes the loop covers (d rounded up to 16; ``passes`` default the
    split's, 1 for bf16 queries), the bytes it must move and the
    CUDA-core instructions per score its function needs, each printed;
    beside it, not part of it, this kernel's own epilogue instructions
    per score (``epilogue_ms``), and the FFMA bound of the earlier kernel
    (f32 operations over d rounded up to 128, or the bytes)."""
    d16, d128 = -(-d // 16) * 16, -(-d // 128) * 128
    passes = PASSES[form] if passes is None else passes
    parts = {
        "tensor_ms": 1e3 * passes * 2.0 * m * n_pad * d16 / PEAK_BF16_FLOPS,
        "bytes_ms": 1e3 * nbytes / PEAK_HBM_BYTES,
        "score_ops_ms": 1e3 * SCORE_INSTR * m * n_pad / PEAK_INSTR,
    }
    top = max(parts, key=parts.get)
    return dict(bound_ms=parts[top],
                bound_by="bytes" if top == "bytes_ms" else "operations",
                bound_parts=parts,
                epilogue_ms=1e3 * EPILOGUE_INSTR[form] * m * n_pad / PEAK_INSTR,
                ffma_bound_ms=bound_ms(2.0 * m * n_pad * d128, nbytes)[0])


def kernel_label(mangled: str) -> str:
    """``pr_scan_kernel<fused, form, query parts>`` or
    ``pr_merge_kernel<lanes, per_lane, staged>`` from a mangled kernel
    name."""
    merge = re.search(r"pr_merge_kernelILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if merge:
        lanes, per_lane, staged = merge.groups()
        return (f"pr_merge_kernel<{lanes}, {per_lane}, "
                f"{'staged' if staged == '1' else 'global'}>")
    found = re.search(r"(pr_[a-z_]*kernel)(?:ILb([01])E(?:Li(\d)E)?(?:Li(\d)E)?E)?",
                      mangled)
    if not found:
        return mangled
    name, fused, form, parts = found.groups()
    args = [{"0": "two-pass", "1": "fused"}[fused]] if fused else []
    args += [FORMS[int(form)]] if form else []
    args += [f"{parts} query part{'s' if parts != '1' else ''}"] if parts else []
    return f"{name}<{', '.join(args)}>" if args else name


def names_of(form: str, qparts: int = 3):
    """Counter names of the kernels of one stored form (``qparts`` 1: the
    one-pass forms, bf16 queries)."""
    from repro_torch.kernels.partial_reduce import kernel_name

    return (kernel_name("partial_reduce_fused", form, qparts), "fused_carry_merge",
            kernel_name("partial_reduce_packed", form, qparts))


def exact_topk(metric, q, rows, live, k, chunk=1000):
    """Exact oracle: chunked f32 matmul + topk over the live rows."""
    from repro_torch.search import half_norms, l2_normalize

    if metric == "cosine":
        q, rows = l2_normalize(q), l2_normalize(rows)
    bias = torch.where(live, 0.0, float("-inf"))
    if metric == "l2":
        bias = bias - half_norms(rows)
    out = []
    for s in range(0, q.shape[0], chunk):
        scores = q[s : s + chunk] @ rows.T + bias
        out.append(torch.topk(scores, k, dim=1).indices)
    return torch.cat(out)


def exact_values(metric, q, rows, idx):
    """float64 public values (the metric's value contract) of the rows
    ``idx`` (m, k) for each query: what a rescored search returns."""
    x, qq = rows[idx.long().clamp_min(0)].double(), q.double()
    if metric == "cosine":
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        qq = qq / qq.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    dots = (x @ qq[:, :, None])[..., 0]
    return 0.5 * (x * x).sum(-1) - dots if metric == "l2" else dots


def recall(approx: torch.Tensor, truth: torch.Tensor) -> float:
    a, t = approx.long(), truth.long()
    hits = (a[:, :, None] == t[:, None, :]).any(dim=2).sum(dim=1)
    return float(hits.float().mean()) / t.shape[1]


def card_lines() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"nvcc: {nvcc}, SMs: {props.multi_processor_count}")
    return smi


def widened_rows(db, scale, int4_packed):
    """A packed database's stored rows as f32, scale applied: what the
    kernels score against, for the tie-tolerant scorer."""
    from repro_torch.search import dequantize_rows, unpack_int4_rows

    rows = unpack_int4_rows(db) if int4_packed else db
    return dequantize_rows(rows, None if scale is None else scale[0])


def compare_kernels(prk, testing, label, q, db, bias, bs, ks, acc, *,
                    scale=None, int4_packed=False, chunk=512):
    """Each kernel against its plain version on one set of operands, on
    the card.  The plain versions run ``chunk`` queries at a time to
    bound their (chunk, n_pad) score tile; ``acc`` gathers the largest
    difference and the index agreement of each kernel."""
    from repro_torch.search import pad_queries_to

    form = prk.storage_form(db, scale, int4_packed)
    fused, merge, packed = names_of(form, prk.query_parts(q, form))
    widened = widened_rows(db, scale, int4_packed)
    qp = pad_queries_to(q, widened.shape[1]).contiguous()
    score = testing.bias_scorer(q, widened, bias)
    kw = dict(bin_size=bs, int4_packed=int4_packed)
    v, i = prk.partial_reduce_packed(q, db, bias, scale, **kw)
    carries = prk.fused_scan(qp, db, bias, scale, k_scan=ks, **kw)
    fv, fi = prk.fused_carry_merge(*carries)
    torch.cuda.synchronize()
    plain_packed, plain_fused = [], []
    for s in range(0, qp.shape[0], chunk):
        plain_packed.append(prk.partial_reduce_packed_plain(
            qp[s : s + chunk], db, bias, scale, **kw))
        plain_fused.append(prk.partial_reduce_fused_plain(
            qp[s : s + chunk], db, bias, scale, k_scan=ks, **kw))
    pv, pi = (torch.cat(t) for t in zip(*plain_packed))
    pfv, pfi = (torch.cat(t) for t in zip(*plain_fused))
    mv, mi = prk.fused_carry_merge_plain(*carries)
    testing.assert_bin_winners_close(pv.cpu(), pi.cpu(), v.cpu(), i.cpu(),
                                     bin_size=bs, score=score)
    testing.assert_topk_close(pfv.cpu(), pfi.cpu(), fv.cpu(), fi.cpu(),
                              score=score)
    if not (testing.bits_equal(mv, fv) and torch.equal(mi, fi)):
        fail(f"{label}: fused_carry_merge differs from its plain version")
    for kernel, a, b, x, y in ((packed, i, pi, v, pv), (fused, fi, pfi, fv, pfv),
                               (merge, fi, mi, fv, mv)):
        acc["agree"][kernel] += int((a == b).sum())
        acc["total"][kernel] += a.numel()
        acc["errs"][kernel] = max(acc["errs"][kernel], float((x - y).abs().max()))
    log(f"kernels vs plain [{label}, {fused}]: m={q.shape[0]} n_pad={db.shape[0]} "
        f"bin={bs} k_scan={ks} splits={carries[0].shape[0]}: ok (max |diff| "
        f"packed {float((v - pv).abs().max()):.3g}, fused "
        f"{float((fv - pfv).abs().max()):.3g})")


# Bins and k_scan that plan_bins gives the Sift1M shape per tier (the
# main path's own; k_scan = quant.scan_k).
SIFT_PLAN = {"f32": (4096, K), "bf16": (2048, 15), "int8": (2048, 20),
             "int4": (1024, 30)}
# Each index's plan as PERF.md section 4 lists it (k_scan, bins, rows a
# bin, E[recall] to 4 places): the reference's plan_bins.
PLAN_TABLE = {("sift1m", "f32"): (10, 245, 4096, 0.9639),
              ("sift1m", "bf16"): (15, 489, 2048, 0.9717),
              ("sift1m", "int8"): (20, 489, 2048, 0.9619),
              ("sift1m", "int4"): (30, 977, 1024, 0.9707),
              ("glove1.2m", "f32"): (10, 289, 4096, 0.9693)}
# k_scan of the fused kernel's carry-placement timings: the largest in
# shared memory (SMEM_K_SCAN), the smallest in device memory, and a large
# one.
KSCAN_TIMED = (32, 33, 512)


def phase_kernels(prk, testing, seed, acc):
    """Phase 3: every kernel in every stored form against its plain
    version at the small test shapes and on 512 queries at the Sift1M
    shape; then the fused kernel at k_scan 129 and 512."""
    cases = dict(testing.KERNEL_CASES)
    cases["sift1m_512"] = dict(m=512, n=SIFT["n"], d=SIFT["d"], bin_size=4096,
                               k_scan=K, dead=0.1, l2=True)
    for name, case in cases.items():
        q, db, bias = testing.packed_operands(**case, seed=seed, device="cuda")
        for form in FORMS:
            bs, ks = case["bin_size"], case["k_scan"]
            if name == "sift1m_512":
                bs, ks = SIFT_PLAN[form]
            stored, scale, packed, _ = testing.stored_operands(db, form)
            compare_kernels(prk, testing, name, q, stored, bias, bs, ks, acc,
                            scale=scale, int4_packed=packed)
            del stored, scale
        if name == "sift1m_512":  # the carry in device memory
            for ks in (129, 512):
                compare_kernels(prk, testing, f"{name} k_scan={ks}", q, db,
                                bias, 256, ks, acc)
        del q, db, bias


# The merge kernel's grid on carries dense in ties (tests/test_torch_cuda.py
# test_merge_bit_equal): group widths of 8, 16 and 32 lanes, 1 to 8 splits
# a lane, carries staged in shared memory and read from device memory.
MERGE_SPLITS = (1, 2, 5, 31, 32, 33, 82, 123, 256)
MERGE_K_SCAN = (1, 10, 30, 32, 33, 129, 512)
MERGE_M = (1, 16, 129, 1000)


def merge_equal(prk, testing, carries, label):
    """The merge kernel against its plain version on ``carries``, bit for
    bit; fails the run on any difference."""
    v, i = prk.fused_carry_merge(*carries)
    pv, pi = prk.fused_carry_merge_plain(*carries)
    if not (testing.bits_equal(v, pv) and torch.equal(i, pi)):
        fail(f"{label}: fused_carry_merge differs from its plain version")


def phase_merge_ties(prk, testing, seed):
    """Phase 3, the merge: bit for bit on the tie-heavy grid, which must
    run both of its paths (carries staged in shared memory, and not)."""
    paths = set()
    for splits in MERGE_SPLITS:
        for k_scan in MERGE_K_SCAN:
            paths.add(prk.merge_plan(splits, k_scan)["staged_bytes"] > 0)
            for m in MERGE_M:
                carries = testing.tied_carries(splits, m, k_scan,
                                               seed=seed + splits * 1000 + k_scan,
                                               device="cuda")
                merge_equal(prk, testing, carries,
                            f"tied carries splits={splits} k_scan={k_scan} m={m}")
                del carries
    if paths != {True, False}:
        fail(f"the merge grid ran only staged={paths}")
    log(f"merge vs plain on tied carries: splits {MERGE_SPLITS} x k_scan "
        f"{MERGE_K_SCAN} x m {MERGE_M}, both paths: bit-equal")


def make_data(cfg, seed):
    """The random database, queries, appended rows and deleted ids of one
    shape, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d = cfg["n"], cfg["d"]
    db = torch.randn((n, d), generator=g, device="cuda")
    q = torch.randn((cfg["m"], d), generator=g, device="cuda")
    extra = torch.randn((10_000, d), generator=g, device="cuda")
    dead = torch.randperm(n, generator=g, device="cuda")[:50_000]
    return db, q, extra, dead


def launches_of(search, want: int, label: str):
    """Run ``search()``; fail unless it launched ``want`` kernels."""
    from repro_torch.kernels import partial_reduce as prk

    before = sum(prk.LAUNCHES.values())
    out = search()
    got = sum(prk.LAUNCHES.values()) - before
    if got != want:
        fail(f"{label} search launched {got} kernels, not {want}")
    return out


def drive(cfg, data, m_after, results, storage="f32"):
    """Phases 4-6: build -> search -> recall -> add -> delete -> search,
    and the two-pass path against the fused one; a quantized tier also
    returns the exact scores of its ids (the rescore ran)."""
    from repro_torch.search import Index
    from repro_torch.testing import assert_topk_close, public_scorer

    db, q, extra, dead = data
    n, metric = cfg["n"], cfg["metric"]
    label = cfg["name"] if storage == "f32" else f"{cfg['name']} {storage}"
    kw = dict(metric=metric, k=K, recall_target=TARGET, cluster="off",
              storage=storage)

    t0 = time.perf_counter()
    index = Index.build(db, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = index.plan
    log(f"[{label}] build {build_s:.2f} s: L={plan.num_bins} bins of "
        f"{plan.bin_size}, k_scan={index.k_scan}, E[recall]="
        f"{plan.expected_recall:.4f}, backend={index._resolve_backend()}")
    v, i = index.search(q)
    torch.cuda.synchronize()
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    truth = exact_topk(metric, q, db, live, K)
    r1 = recall(i, truth)
    floor = plan.expected_recall - hoeffding_eps(q.shape[0])
    log(f"[{label}] search M={q.shape[0]}: recall {r1:.4f} (floor {floor:.4f})")
    if not r1 >= floor:
        fail(f"{label}: recall {r1} < {floor}")
    if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], K):
        fail(f"{label}: non-finite or misshapen values")

    two_pass = Index.build(db, fused_select=False, **kw)
    for idx in (index, two_pass):
        idx.add(extra)
        idx.delete(dead)
    plan = index.plan
    qa = q[:m_after]
    v, i = launches_of(lambda: index.search(qa), 2, f"{label} fused")
    tv, ti = launches_of(lambda: two_pass.search(qa), 1, f"{label} two-pass")
    torch.cuda.synchronize()
    rows = torch.cat([db, extra])
    live = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live[dead] = False
    if torch.isin(i.long(), dead).any() or torch.isin(ti.long(), dead).any():
        fail(f"{label}: a deleted id was returned")
    if index.size != n + 10_000 - 50_000:
        fail(f"{label}: size {index.size}")
    r2 = recall(i, exact_topk(metric, qa, rows, live, K))
    floor = plan.expected_recall - hoeffding_eps(qa.shape[0])
    log(f"[{label}] add 10000 + delete 50000 -> capacity {index.capacity}, "
        f"L={plan.num_bins}: recall {r2:.4f} (floor {floor:.4f})")
    if not r2 >= floor:
        fail(f"{label}: recall after updates {r2} < {floor}")
    assert_topk_close(v.cpu(), i.cpu(), tv.cpu(), ti.cpu(),
                      score=public_scorer(metric, qa, rows))
    log(f"[{label}] fused_select=False agrees with the fused path")
    if storage != "f32":
        exact = exact_values(metric, qa, rows, i)
        err = float(((v.double() - exact).abs()
                     - 1e-5 * exact.abs()).max())
        if (i < 0).any() or not err <= 1e-4:
            fail(f"{label}: returned values are not the exact scores of the "
                 f"returned ids (excess {err})")
        log(f"[{label}] values are the exact scores of the returned ids "
            f"(largest |diff| beyond rtol 1e-5: {err:.3g})")
    results[label] = dict(
        build_s=build_s, recall=r1, recall_after_updates=r2,
        expected_recall=index.expected_recall, bins=plan.num_bins,
        k_scan=index.k_scan,
    )
    del two_pass
    return index


def read_counts(prk, label, forms, results, two_pass=True, qparts=3):
    """The launches of the path just driven: every kernel of ``forms``
    (without the two-pass kernel unless ``two_pass``; the one-pass forms
    for ``qparts`` 1) launched at least once, no plain version called."""
    launches, plain = dict(prk.LAUNCHES), dict(prk.PLAIN_CALLS)
    log(f"[{label}] launches {launches}, plain calls {plain}")
    for form in forms:
        for name in names_of(form, qparts)[:3 if two_pass else 2]:
            if launches.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the {label} path")
    if sum(plain.values()):
        fail(f"plain versions ran on the {label} path: {plain}")
    for key, counts in (("launches", launches), ("plain_calls", plain)):
        for name, count in counts.items():
            results[key][name] = results[key].get(name, 0) + count


def phase_main_shapes(prk, testing, cases, acc):
    """Phase 7: every kernel against its plain version at the main paths'
    own shapes: all of each index's queries, over its packed operands."""
    from repro_torch.search import get_metric

    for label, cfg, index, q in cases:
        pk = index.pack()
        ops = pk.operands()
        scale = None if pk.storage == "f32" else ops[2]
        qm = get_metric(cfg["metric"]).prepare_queries(q)
        compare_kernels(prk, testing, f"{label} M={q.shape[0]}", qm, ops[0],
                        ops[1], pk.bin_size, index.k_scan, acc, scale=scale,
                        int4_packed=pk.int4_packed)


def time_merge(prk, testing, carries, label, rows, empty_ms):
    """The merge on one plan's carries: bit for bit against its plain
    version, then its device time beside ``torch.topk`` over the same
    carries laid end to end (one PyTorch call that computes the same
    values; the port never calls it), its byte bound (each carry entry
    read once, each output written once) and an empty launch; appended
    to ``rows`` and logged."""
    merge_equal(prk, testing, carries, label)
    splits, m, k_scan = carries[0].shape
    flat = carries[0].permute(1, 0, 2).reshape(m, splits * k_scan).contiguous()
    row = dict(label=label, m=m, splits=splits, k_scan=k_scan,
               plan=prk.merge_plan(splits, k_scan),
               ms=queued_ms(lambda: prk.fused_carry_merge(*carries)),
               topk_ms=queued_ms(lambda: torch.topk(flat, k_scan, dim=1)),
               bound_ms=1e3 * 8.0 * (splits + 1) * m * k_scan / PEAK_HBM_BYTES,
               empty_ms=empty_ms)
    rows.append(row)
    log(f"  merge [{label}] M={m}: {splits} splits, k_scan {k_scan}, plan "
        f"{row['plan']}: {row['ms']:.4f} ms, torch.topk {row['topk_ms']:.4f} "
        f"ms, byte bound {row['bound_ms']:.5f} ms, empty launch "
        f"{empty_ms:.4f} ms; bit-equal to its plain version")
    return row


def time_form(prk, testing, db, q, storage, results, empty_ms, merge_rows):
    """Phase 8, one stored form: CUDA-event timings at the Sift1M shape on
    a fresh index of the form over the main path's data (before its
    updates), at M=10,000 and M=16: both scan kernels, the merge, their
    plain versions, a quantized tier's rescore stage and the whole
    search (at M=16 also as the device time of searches queued back to
    back: a single search there takes about as long on the host as on
    the card); for f32 also cuBLAS's f32 GEMM of the same product (a
    yardstick the port never calls) and the fused kernel at bins of 256
    rows for each k_scan of KSCAN_TIMED; for int4 also the fused scan of
    an index at k=20, whose carry lives in device memory.  The merge at
    each of these plans goes through :func:`time_merge`."""
    from repro_torch.search import (Index, get_metric, pad_queries_to,
                                    rescore_candidates)

    index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                        cluster="off", storage=storage)
    pk = index.pack()
    ops = pk.operands()
    sdb, bias = ops[0], ops[1]
    scale = None if storage == "f32" else ops[2]
    bs, ks, i4 = pk.bin_size, index.k_scan, pk.int4_packed
    m, n_pad, d = q.shape[0], sdb.shape[0], SIFT["d"]
    d_pad = sdb.shape[1] * (2 if i4 else 1)
    row_bytes = sdb.shape[1] * sdb.element_size()
    qm = get_metric(SIFT["metric"]).prepare_queries(q)
    qp = pad_queries_to(qm, d_pad).contiguous()
    kw = dict(bin_size=bs, int4_packed=i4)

    def fused(qq, k_scan=ks, **extra):
        return prk.fused_scan(pad_queries_to(qq, d_pad).contiguous(), sdb,
                              bias, scale, k_scan=k_scan, width=d,
                              **{**kw, **extra})

    def packed(qq):
        return prk.partial_reduce_packed(qq, sdb, bias, scale, **kw)

    def plain(fn, **extra):
        for s in range(0, m, 512):
            fn(qp[s : s + 512], sdb, bias, scale, **kw, **extra)

    carries = fused(qm)
    splits = carries[0].shape[0]
    q16 = qm[:16].contiguous()
    c16 = fused(q16)
    merge = {m_: time_merge(prk, testing, c, storage, merge_rows, empty_ms)
             for m_, c in ((m, carries), (16, c16))}
    t = {
        "fused": cuda_ms(lambda: fused(qm)),
        "merge": merge[m]["ms"],
        "packed": cuda_ms(lambda: packed(qm)),
        "fused_m16": cuda_ms(lambda: fused(q16), reps=20),
        "merge_m16": merge[16]["ms"],
        "packed_m16": cuda_ms(lambda: packed(q16), reps=20),
        "search": cuda_ms(lambda: index.search(q)),
        "search_m16": cuda_ms(lambda: index.search(q[:16]), reps=20),
        "search_m16_device": queued_ms(lambda: index.search(q[:16])),
        "fused_plain": cuda_ms(lambda: plain(prk.partial_reduce_fused_plain,
                                             k_scan=ks), reps=3),
        "packed_plain": cuda_ms(lambda: plain(prk.partial_reduce_packed_plain),
                                reps=3),
    }
    if storage == "f32":
        def gemm():
            for s in range(0, m, 1000):
                torch.matmul(qp[s : s + 1000], sdb.T)
        t["merge_plain"] = queued_ms(
            lambda: prk.fused_carry_merge_plain(*carries))
        t["gemm"] = cuda_ms(gemm, reps=3)
        # The carry in shared memory (k_scan <= SMEM_K_SCAN) against the
        # carry in device memory (above), at bins of 256 rows: 3,920
        # bins, enough winners to fill a carry of 512.
        for k_scan in KSCAN_TIMED:
            ck = fused(qm, k_scan=k_scan, bin_size=256)
            t[f"fused_k{k_scan}"] = cuda_ms(
                lambda: fused(qm, k_scan=k_scan, bin_size=256))
            t[f"merge_k{k_scan}"] = queued_ms(lambda: prk.fused_carry_merge(*ck))
            del ck
    else:
        fv, fi = prk.fused_carry_merge(*carries)
        rdb, rbias = ops[3], ops[4]
        t["rescore"] = cuda_ms(lambda: rescore_candidates(qm, fv, fi, rdb, rbias,
                                                          K, ks), reps=20)
    if storage == "int4":
        # An int4 index at k=20: its carry (k_scan 3k = 60) is above
        # SMEM_K_SCAN, so it lives in device memory.
        i20 = Index.build(db, metric=SIFT["metric"], k=20, recall_target=TARGET,
                          cluster="off", storage=storage)
        p20 = i20.pack()
        o20 = p20.operands()
        k20 = dict(k=20, k_scan=i20.k_scan, bin_size=p20.bin_size)

        def fused20(qq):
            return prk.fused_scan(pad_queries_to(qq, d_pad).contiguous(), o20[0],
                                  o20[1], o20[2], k_scan=k20["k_scan"],
                                  bin_size=k20["bin_size"], int4_packed=True,
                                  width=d)
        c20 = fused20(qm)
        t["fused_k20"] = cuda_ms(lambda: fused20(qm))
        t["merge_k20"] = time_merge(prk, testing, c20, "int4 k=20", merge_rows,
                                    empty_ms)["ms"]
        t["fused_k20_m16"] = cuda_ms(lambda: fused20(q16), reps=20)
        t["merge_k20_m16"] = time_merge(prk, testing, fused20(q16), "int4 k=20",
                                        merge_rows, empty_ms)["ms"]
        t["search_k20_m16"] = cuda_ms(lambda: i20.search(q[:16]), reps=20)
        t["search_k20_m16_device"] = queued_ms(lambda: i20.search(q[:16]))
        del i20, p20, o20, c20
    prk.reset_counts()
    index.search(q)
    torch.cuda.synchronize()
    per_search = dict(prk.LAUNCHES)
    if sum(per_search.values()) != 2:
        fail(f"{storage}: one search launched {per_search}, not 2 kernels")

    stored = row_bytes * n_pad + 4.0 * n_pad * (1 if scale is None else 2)

    def bounds(rows, out_bytes):
        return scan_bounds(storage, rows, n_pad, d,
                           4.0 * rows * d + stored + out_bytes)
    fb = bounds(m, 8.0 * splits * m * ks)
    pb = bounds(m, 8.0 * m * (n_pad // bs))
    fb16 = bounds(16, 8.0 * c16[0].shape[0] * 16 * ks)
    pb16 = bounds(16, 8.0 * 16 * (n_pad // bs))
    fname, mname, pname = names_of(storage)
    err = results["max_abs_err"]
    was = FFMA_KERNEL_MS[storage]

    def counts(name):
        """Main-path launches and plain calls, and the share of indices
        equal to the plain version's in the kernel comparisons (the rest
        are near ties)."""
        return dict(launches=results["launches"].get(name, 0),
                    plain_calls=results["plain_calls"].get(name, 0),
                    index_agreement=results["index_agreement"][name])

    def entry(name, kind, b, b16, **extra):
        fused_kernel = kind == "partial_reduce_fused"
        return dict(
            name=name, route="cuda", source=SRC,
            replaces=REPLACES[(kind, storage)], **counts(name),
            max_abs_err=err[name], ms=t["fused" if fused_kernel else "packed"],
            plain_ms=t["fused_plain" if fused_kernel else "packed_plain"],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None,
            bound_parts=b["bound_parts"], epilogue_ms=b["epilogue_ms"],
            ffma_bound_ms=b["ffma_bound_ms"],
            ms_m16=t["fused_m16" if fused_kernel else "packed_m16"],
            bound_ms_m16=b16["bound_ms"], bound_by_m16=b16["bound_by"],
            bound_parts_m16=b16["bound_parts"],
            stored_bytes_per_row=row_bytes,
            smem=prk.scan_smem(storage, fused_kernel, d, ks if fused_kernel else 0),
            **extra)
    extra = dict(splits=splits, splits_m16=c16[0].shape[0],
                 merge_ms=t["merge"], merge_ms_m16=t["merge_m16"],
                 search_ms=t["search"], qps=m / t["search"] * 1e3,
                 search_ms_m16=t["search_m16"],
                 search_ms_m16_device=t["search_m16_device"],
                 recall=results["sift1m" if storage == "f32"
                                 else f"sift1m {storage}"]["recall"])
    if storage == "f32":
        extra.update(gemm_ms=t["gemm"],
                     ms_bin256_by_k_scan={k: t[f"fused_k{k}"] for k in KSCAN_TIMED},
                     merge_ms_bin256_by_k_scan={k: t[f"merge_k{k}"]
                                                for k in KSCAN_TIMED})
    else:
        extra.update(rescore_ms=t["rescore"])
    if storage == "int4":
        extra.update(k20={**k20, "ms": t["fused_k20"], "merge_ms": t["merge_k20"],
                          "ms_m16": t["fused_k20_m16"],
                          "merge_ms_m16": t["merge_k20_m16"],
                          "search_ms_m16": t["search_k20_m16"],
                          "search_ms_m16_device": t["search_k20_m16_device"]})
    kernels = [entry(fname, "partial_reduce_fused", fb, fb16, **extra),
               entry(pname, "partial_reduce_packed", pb, pb16)]
    if storage == "f32":
        mb = bound_ms(m * K * splits, 8.0 * (splits + 1) * m * K)
        kernels.insert(1, dict(
            name=mname, route="cuda", source=SRC, replaces=f"{REF}:219",
            **counts(mname), max_abs_err=err[mname], ms=t["merge"],
            plain_ms=t["merge_plain"], bound_ms=mb[0], bound_by=mb[1],
            library_ms=merge[m]["topk_ms"], ms_m16=t["merge_m16"],
            library_ms_m16=merge[16]["topk_ms"],
            bound_ms_m16=merge[16]["bound_ms"], empty_launch_ms=empty_ms))

    log(f"timing {storage} at M={m}, n_pad={n_pad}, d={d} (d_pad {d_pad}), "
        f"{row_bytes} stored bytes a row, bin={bs}, k_scan={ks}, "
        f"splits={splits} ({c16[0].shape[0]} at M=16; CUDA events, median):")
    for key, ms in t.items():
        log(f"  {key:13s} {ms:10.3f} ms")
    for label, ms, b, ffma in (("fused", t["fused"], fb, was[0]),
                               ("two-pass", t["packed"], pb, was[1]),
                               ("fused M=16", t["fused_m16"], fb16, was[2]),
                               ("two-pass M=16", t["packed_m16"], pb16, None)):
        parts = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in b["bound_parts"].items())
        log(f"  {storage} {label} scan {ms:.3f} ms (FFMA kernel, as recorded "
            f"in PERF.md: {'not timed' if ffma is None else f'{ffma:.3f} ms'}): "
            f"{100 * b['bound_ms'] / ms:.1f}% of its {b['bound_by']} bound "
            f"{b['bound_ms']:.4f} ms ({parts}); this kernel's epilogue "
            f"{b['epilogue_ms']:.4f} ms; FFMA bound {b['ffma_bound_ms']:.4f} ms")
    log(f"  search QPS {m / t['search'] * 1e3:.0f} at recall "
        f"{extra['recall']:.4f}; launches per search: {per_search}")
    return kernels, row_bytes


def phase_planner(prk, testing, sift, glove, bounds, results, seed):
    """Phase 9: the planner and the bitonic network on the card (see the
    module docstring), on the device of the ``sift`` and ``glove`` (db,
    queries) pairs; ``bounds`` holds phase 8's bounds by tier: the
    tensor-core bound at M=10,000 and the byte bound at M=16.  Returns
    what it measured, for the JSON line."""
    from repro_torch.core import exact_rescoring
    from repro_torch.search import Index, PlanCache, detect_device
    from repro_torch.search import plan as planlib

    out = {"profile": detect_device()}
    log(f"planner: detect_device() = {out['profile']!r}")
    if out["profile"] != "h100":
        fail(f"detect_device() gave {out['profile']!r} on this card, not 'h100'")
    timed = []  # (query_block, seconds) of every time_search call
    real_time_search = planlib.time_search

    def counting(index, queries, **kw):
        wall = real_time_search(index, queries, **kw)
        timed.append((index.spec.query_block, wall))
        return wall
    planlib.time_search = counting

    dev = sift[0].device
    prk.reset_counts()
    models, explained = {}, []
    for cfg, (db, q), storages in ((SIFT, sift, FORMS), (GLOVE, glove, ("f32",))):
        for storage in storages:
            label = f"{cfg['name']} {storage}"
            index = Index.build(db, metric=cfg["metric"], k=K,
                                recall_target=TARGET, cluster="off",
                                storage=storage, device=dev)
            kp = index.kernel_plan
            got = (kp.k_scan, kp.num_bins, kp.bin_size,
                   round(kp.expected_recall, 4))
            if got != PLAN_TABLE[cfg["name"], storage]:
                fail(f"{label}: plan {got}, not PERF.md's "
                     f"{PLAN_TABLE[cfg['name'], storage]}")
            for m in (cfg["m"], 16):
                rep = index.explain(m=m, measure=True)
                pred, meas = rep["predicted"], rep["measured"]
                row = dict(label=label, m=m, predicted_ms=1e3 * pred["wall_s"],
                           bottleneck=pred["bottleneck"],
                           measured_ms=1e3 * meas["wall_s"],
                           share=meas["roofline_fraction"],
                           splits=rep["plan"]["splits"])
                explained.append(row)
                log(f"  explain [{label}] M={m}: predicted {row['predicted_ms']:.4f}"
                    f" ms ({row['bottleneck']}), measured {row['measured_ms']:.4f}"
                    f" ms, {100 * row['share']:.1f}% of the roof; "
                    f"{row['splits']} splits")
                if meas["wall_s"] < 0.95 * pred["wall_s"]:
                    fail(f"{label} M={m}: measured {meas['wall_s']} s beats "
                         f"0.95 x the bound {pred['wall_s']} s (a wrong count)")
                want = bounds.get((storage, m)) if cfg is SIFT else None
                if want is not None and abs(row["predicted_ms"] / want - 1) > 0.01:
                    fail(f"{label} M={m}: predicted {row['predicted_ms']} ms, "
                         f"not within 1% of phase 8's bound {want} ms")
            if cfg is SIFT:
                models[storage] = index
            del index
    out["explain"] = explained

    # plan="measure": the sweep, its cache, and a search with its plan
    db, q = sift
    live = torch.ones(db.shape[0], dtype=torch.bool, device=dev)
    truth = exact_topk(SIFT["metric"], q, db, live, K)
    out["measure"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(str(pathlib.Path(tmp) / "plans.json"))
        for storage in ("f32", "int4"):
            kw = dict(metric=SIFT["metric"], k=K, recall_target=TARGET,
                      cluster="off", storage=storage, device=dev)
            del timed[:]
            t0 = time.perf_counter()
            index = Index.build(db, plan="measure", plan_cache=cache, **kw)
            sweep_s = time.perf_counter() - t0
            cands = list(timed)
            kp = index.kernel_plan
            log(f"  plan=measure [sift1m {storage}] sweep {sweep_s:.2f} s, "
                f"query_block: seconds a search {cands}; winner query_block "
                f"{kp.query_block} ({kp.source})")
            del timed[:]
            again = Index.build(db, plan="measure", plan_cache=cache, **kw)
            if timed or again.kernel_plan != kp or kp.source != "measure":
                fail(f"sift1m {storage}: the second plan=measure build timed "
                     f"{len(timed)} searches or planned {again.kernel_plan}")
            del again
            _, i = index.search(q)
            r = recall(i, truth)
            floor = index.plan.expected_recall - hoeffding_eps(q.shape[0])
            log(f"  plan=measure [sift1m {storage}] cache hit, no timing; "
                f"search M={q.shape[0]}: recall {r:.4f} (floor {floor:.4f})")
            if not r >= floor:
                fail(f"sift1m {storage} measured plan: recall {r} < {floor}")
            out["measure"][storage] = dict(candidates=cands,
                                           query_block=kp.query_block,
                                           sweep_s=sweep_s, recall=r)
            del index
    planlib.time_search = real_time_search

    # the bitonic network: a rescore's shape, then an int8 search
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randint(-3, 4, (q.shape[0], 60), generator=g, device=dev).float()
    vals = torch.where((vals == 0) & (torch.randint(0, 2, vals.shape, generator=g,
                                                    device=dev) == 1),
                       torch.full_like(vals, -0.0), vals)
    idxs = torch.randperm(vals.numel(), generator=g,
                          device=dev).int().reshape(vals.shape)
    bv, bi = exact_rescoring(vals, idxs, 2 * K)
    sv, si = exact_rescoring(vals, idxs, 2 * K, use_bitonic=False)
    value_of = torch.empty(vals.numel())  # each index's value (a scorer)
    value_of[idxs.flatten().long().cpu()] = vals.flatten().cpu()
    testing.assert_topk_close(
        sv.cpu(), si.cpu(), bv.cpu(), bi.cpu(), rtol=0.0, atol=0.0,
        score=lambda row, idx: value_of[torch.as_tensor(idx).long()].double().numpy())
    out["bitonic"] = dict(
        ms=cuda_ms(lambda: exact_rescoring(vals, idxs, 2 * K)),
        stable_ms=cuda_ms(lambda: exact_rescoring(vals, idxs, 2 * K,
                                                  use_bitonic=False)))
    bitonic = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                          cluster="off", storage="int8", use_bitonic=True,
                          device=dev)
    v, i = bitonic.search(q)
    dv, di = models["int8"].search(q)
    testing.assert_topk_close(dv.cpu(), di.cpu(), v.cpu(), i.cpu(),
                              score=testing.public_scorer(SIFT["metric"], q, db))
    out["bitonic"].update(
        search_ms=cuda_ms(lambda: bitonic.search(q)),
        default_search_ms=cuda_ms(lambda: models["int8"].search(q)))
    log(f"  bitonic exact_rescoring {tuple(vals.shape)} -> top {2 * K}: "
        f"{out['bitonic']['ms']:.3f} ms (stable sort {out['bitonic']['stable_ms']:.3f}"
        f" ms), equal up to the order of tied values; sift1m int8 search "
        f"M={q.shape[0]} use_bitonic=True {out['bitonic']['search_ms']:.3f} ms, "
        f"default {out['bitonic']['default_search_ms']:.3f} ms: same results")
    del bitonic, models

    # C1: an add without growth lifts the over-fetch cap of a small index
    small = db[:112]
    c1 = Index.build(small[:12], metric=SIFT["metric"], k=K, storage="int4",
                     capacity=1024, device=dev)
    c1.add(small[12:])
    cv, ci = c1.search(q[:100])
    read_counts(prk, "planner", FORMS, results, two_pass=False)
    out["c1"] = dict(k_scan=c1.k_scan, capacity=c1.capacity)
    if (c1.k_scan, c1.capacity) != (3 * K, 1024):
        fail(f"C1: k_scan {c1.k_scan} after add without growth, not {3 * K}")
    cpu = Index.build(small[:12].cpu(), metric=SIFT["metric"], k=K,
                      storage="int4", capacity=1024, device="cpu", backend="cuda")
    cpu.add(small[12:].cpu())
    pv, pi = cpu.search(q[:100].cpu())
    testing.assert_topk_close(pv, pi, cv.cpu(), ci.cpu(),
                              score=testing.public_scorer(SIFT["metric"], q[:100],
                                                          small))
    log(f"  C1: int4 index of 12 rows (capacity 1024) + 100 rows: k_scan "
        f"{c1.k_scan}, search equal to the same index on the CPU")
    return out


def exact_topk_bf16(metric, q, rows, live, k, chunk=1000):
    """Exact oracle in the bf16 compute dtype: the rows and queries cast
    to bf16 and prepared as the index prepares them (its bf16 norms and
    bias), scored with exact products and f32 sums."""
    from repro_torch.search import get_metric

    m_obj = get_metric(metric)
    prepped, bias = m_obj.prepare_database(rows.to(torch.bfloat16))
    prepped = prepped.float()
    qq = m_obj.prepare_queries(q.to(torch.bfloat16)).float()
    full = torch.where(live, 0.0, float("-inf"))
    if bias is not None:
        full = full + bias.float()
    out = []
    for s in range(0, qq.shape[0], chunk):
        out.append(torch.topk(qq[s : s + chunk] @ prepped.T + full, k,
                              dim=1).indices)
    return torch.cat(out)


def integer_bits_equal(prk, label, m, n, d, bin_size, k_scan, seed):
    """Integer-valued bf16 queries and rows in each one-pass form: both
    kernels bit-equal to their plain versions (every sum is exact)."""
    from repro_torch.search import pad_queries_to, quant

    g = torch.Generator(device="cuda").manual_seed(seed)
    block = max(bin_size, 128)
    n_pad = -(-n // block) * block
    d_pad = -(-d // 128) * 128
    q = torch.randint(-3, 4, (m, d), generator=g, device="cuda").float()
    db = torch.zeros((n_pad, d_pad), device="cuda")
    db[:n, :d] = torch.randint(-7, 8, (n, d), generator=g, device="cuda").float()
    bias = torch.full((1, n_pad), -3.4028234663852886e38, device="cuda")
    live = torch.rand(n, generator=g, device="cuda") >= 0.1
    bias[0, :n] = torch.where(live, -0.5 * (db[:n] * db[:n]).sum(1), bias[0, :n])
    qb = q.to(torch.bfloat16)
    qp = pad_queries_to(qb, d_pad)
    for form in ONE_PASS_FORMS:
        scale = None
        if form == "bf16":
            stored = db.to(torch.bfloat16)
        else:
            stored = db.to(torch.int8)
            scale = torch.ones((1, n_pad), device="cuda")
            if form == "int4":
                stored = quant.pack_int4_rows(stored)
        kw = dict(bin_size=bin_size, int4_packed=form == "int4")
        got = (*prk.partial_reduce_packed(qb, stored, bias, scale, **kw),
               *prk.partial_reduce_fused(qb, stored, bias, scale, k_scan=k_scan,
                                         **kw))
        want = (*prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw),
                *prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                                k_scan=k_scan, **kw))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"one-pass {form} [{label}]: not bit-equal to its plain "
                 f"version on integer-valued inputs")
    log(f"one-pass kernels vs plain on integer-valued inputs [{label}]: m={m} "
        f"n={n} d={d} bin={bin_size} k_scan={k_scan}, {ONE_PASS_FORMS}: "
        f"bit-equal")


def phase_one_pass_kernels(prk, testing, seed, acc):
    """Phase 10, the kernels: each one-pass instantiation against its
    plain version at the small test shapes and on 512 bf16 queries at the
    Sift1M shape, and bit for bit on integer-valued inputs."""
    cases = dict(testing.KERNEL_CASES)
    cases["sift1m_512"] = dict(m=512, n=SIFT["n"], d=SIFT["d"], bin_size=4096,
                               k_scan=K, dead=0.1, l2=True)
    for name, case in cases.items():
        q, db, bias = testing.packed_operands(**case, seed=seed, device="cuda")
        qb = q.to(torch.bfloat16)
        for form in ONE_PASS_FORMS:
            bs, ks = case["bin_size"], case["k_scan"]
            if name == "sift1m_512":
                bs, ks = SIFT_PLAN[form]
            stored, scale, packed, _ = testing.stored_operands(db, form)
            compare_kernels(prk, testing, f"{name} bf16 queries", qb, stored,
                            bias, bs, ks, acc, scale=scale, int4_packed=packed)
            del stored, scale
        del q, qb, db, bias
    integer_bits_equal(prk, "small", 150, 2000, 100, 16, 10, seed)
    integer_bits_equal(prk, "sift1m", 512, SIFT["n"], SIFT["d"], 2048, 20, seed)
    integer_bits_equal(prk, "sift1m k_scan 129", 300, SIFT["n"], SIFT["d"], 256,
                       129, seed)


def drive_bf16(data, storage, results):
    """Phase 10, the path: a ``dtype="bfloat16"`` index at the Sift1M shape,
    searched at M=10,000 and M=16, recall against the bf16 oracle, the
    two-pass path against the fused one after an add and a delete."""
    from repro_torch.search import Index
    from repro_torch.testing import assert_topk_close, public_scorer

    db, q, extra, dead = data
    label = f"sift1m bf16-compute {storage}"
    kw = dict(metric=SIFT["metric"], k=K, recall_target=TARGET, cluster="off",
              storage=storage, dtype="bfloat16")
    t0 = time.perf_counter()
    index = Index.build(db, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = index.plan
    live = torch.ones(db.shape[0], dtype=torch.bool, device="cuda")
    truth = exact_topk_bf16(SIFT["metric"], q, db, live, K)
    v, i = index.search(q)
    v16, i16 = index.search(q[:16])
    torch.cuda.synchronize()
    r1 = recall(i, truth)
    floor = plan.expected_recall - hoeffding_eps(q.shape[0])
    log(f"[{label}] build {build_s:.2f} s: L={plan.num_bins} bins of "
        f"{plan.bin_size}, k_scan={index.k_scan}; search M={q.shape[0]}: recall "
        f"{r1:.4f} against the bf16 oracle (floor {floor:.4f})")
    if not r1 >= floor:
        fail(f"{label}: recall {r1} < {floor}")
    if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], K):
        fail(f"{label}: non-finite or misshapen values")
    # the same rows, scanned in another split plan (and rescored in a batch
    # of another size): equal up to the order of f32 sums
    assert_topk_close(v[:16].cpu(), i[:16].cpu(), v16.cpu(), i16.cpu(),
                      score=public_scorer(SIFT["metric"], q[:16], db,
                                          dtype="bfloat16"))
    two_pass = Index.build(db, fused_select=False, **kw)
    for idx in (index, two_pass):
        idx.add(extra)
        idx.delete(dead)
    qa = q[:2_000]
    v, i = launches_of(lambda: index.search(qa), 2, f"{label} fused")
    tv, ti = launches_of(lambda: two_pass.search(qa), 1, f"{label} two-pass")
    rows = torch.cat([db, extra])
    live = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live[dead] = False
    if torch.isin(i.long(), dead).any() or torch.isin(ti.long(), dead).any():
        fail(f"{label}: a deleted id was returned")
    r2 = recall(i, exact_topk_bf16(SIFT["metric"], qa, rows, live, K))
    floor2 = index.plan.expected_recall - hoeffding_eps(qa.shape[0])
    log(f"[{label}] add 10000 + delete 50000: recall {r2:.4f} (floor "
        f"{floor2:.4f}); fused_select=False agrees with the fused path")
    if not r2 >= floor2:
        fail(f"{label}: recall after updates {r2} < {floor2}")
    assert_topk_close(v.cpu(), i.cpu(), tv.cpu(), ti.cpu(),
                      score=public_scorer(SIFT["metric"], qa, rows,
                                          dtype="bfloat16"))
    results[label] = dict(build_s=build_s, recall=r1, recall_after_updates=r2,
                          expected_recall=plan.expected_recall, k_scan=index.k_scan)
    del two_pass, index
    return label


def time_one_pass(prk, db, q, storage, results, empty_ms):
    """Phase 10, the timings: on a fresh ``dtype="bfloat16"`` index of the
    Sift1M data, both one-pass scan kernels at M=10,000 and M=16 beside
    one pass's tensor, score-operation and byte bounds (and the kernel's
    own epilogue count beside them), their plain versions, the
    whole search (M=16 also queued), and, for context, ``torch.matmul`` of
    the bf16 product alone (not the scan's function: no bias, no bin
    top-1; the port never calls it)."""
    from repro_torch.search import Index, get_metric, pad_queries_to

    index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                        cluster="off", storage=storage, dtype="bfloat16")
    pk = index.pack()
    ops = pk.operands()
    sdb, bias = ops[0], ops[1]
    scale = None if storage == "f32" else ops[2]
    form = prk.storage_form(sdb, scale, pk.int4_packed)
    bs, ks, i4 = pk.bin_size, index.k_scan, pk.int4_packed
    m, n_pad, d = q.shape[0], sdb.shape[0], SIFT["d"]
    d_pad = sdb.shape[1] * (2 if i4 else 1)
    row_bytes = sdb.shape[1] * sdb.element_size()
    qm = get_metric(SIFT["metric"]).prepare_queries(q.to(torch.bfloat16))
    qp = pad_queries_to(qm, d_pad).contiguous()
    kw = dict(bin_size=bs, int4_packed=i4)

    def fused(qq):
        return prk.fused_scan(pad_queries_to(qq, d_pad).contiguous(), sdb, bias,
                              scale, k_scan=ks, width=d, **kw)

    def packed(qq):
        return prk.partial_reduce_packed(qq, sdb, bias, scale, **kw)

    def plain(fn, **extra):
        for s in range(0, m, 512):
            fn(qp[s : s + 512], sdb, bias, scale, **kw, **extra)

    rows16 = sdb if form == "bf16" else torch.ones(
        (n_pad, d_pad), dtype=torch.bfloat16, device="cuda")

    def gemm():
        for s in range(0, m, 1000):
            torch.matmul(qp[s : s + 1000], rows16.T)

    carries = fused(qm)
    splits = carries[0].shape[0]
    q16 = qm[:16].contiguous()
    c16 = fused(q16)
    t = {
        "fused": cuda_ms(lambda: fused(qm)),
        "packed": cuda_ms(lambda: packed(qm)),
        "fused_m16": cuda_ms(lambda: fused(q16), reps=20),
        "packed_m16": cuda_ms(lambda: packed(q16), reps=20),
        "merge": queued_ms(lambda: prk.fused_carry_merge(*carries)),
        "search": cuda_ms(lambda: index.search(q)),
        "search_m16": cuda_ms(lambda: index.search(q[:16]), reps=20),
        "search_m16_device": queued_ms(lambda: index.search(q[:16])),
        "fused_plain": cuda_ms(lambda: plain(prk.partial_reduce_fused_plain,
                                             k_scan=ks), reps=3),
        "packed_plain": cuda_ms(lambda: plain(prk.partial_reduce_packed_plain),
                                reps=3),
        "bf16_gemm": cuda_ms(gemm, reps=3),
    }
    stored = row_bytes * n_pad + 4.0 * n_pad * (1 if scale is None else 2)

    def bounds(rows, out_bytes):
        return scan_bounds(form, rows, n_pad, d,
                           2.0 * rows * d + stored + out_bytes, passes=1)
    fb = bounds(m, 8.0 * splits * m * ks)
    pb = bounds(m, 8.0 * m * (n_pad // bs))
    fb16 = bounds(16, 8.0 * c16[0].shape[0] * 16 * ks)
    pb16 = bounds(16, 8.0 * 16 * (n_pad // bs))
    fname, _, pname = names_of(form, 1)
    kernels = []
    for name, kind, key, b, b16 in (
            (fname, "partial_reduce_fused", "fused", fb, fb16),
            (pname, "partial_reduce_packed", "packed", pb, pb16)):
        kernels.append(dict(
            name=name, route="cuda", source=SRC, replaces=REPLACES[(kind, form)],
            launches=results["launches"].get(name, 0),
            plain_calls=results["plain_calls"].get(name, 0),
            index_agreement=results["index_agreement"].get(name),
            max_abs_err=results["max_abs_err"].get(name), ms=t[key],
            plain_ms=t[f"{key}_plain"], bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], library_ms=None,
            bound_parts=b["bound_parts"], epilogue_ms=b["epilogue_ms"],
            ms_m16=t[f"{key}_m16"],
            bound_ms_m16=b16["bound_ms"], bound_by_m16=b16["bound_by"],
            bound_parts_m16=b16["bound_parts"], stored_bytes_per_row=row_bytes,
            bf16_gemm_ms_not_the_scan=t["bf16_gemm"], index_storage=storage,
            smem=prk.scan_smem(form, kind == "partial_reduce_fused", d,
                               ks if kind == "partial_reduce_fused" else 0,
                               qparts=1)))
    kernels[0].update(splits=splits, splits_m16=c16[0].shape[0],
                      merge_ms=t["merge"], search_ms=t["search"],
                      qps=m / t["search"] * 1e3, search_ms_m16=t["search_m16"],
                      search_ms_m16_device=t["search_m16_device"],
                      recall=results[f"sift1m bf16-compute {storage}"]["recall"])
    log(f"timing one-pass {form} (dtype=bfloat16, storage={storage}) at M={m}, "
        f"n_pad={n_pad}, bin={bs}, k_scan={ks}, splits={splits} "
        f"({c16[0].shape[0]} at M=16; CUDA events, median):")
    for key, ms in t.items():
        log(f"  {key:18s} {ms:10.3f} ms")
    for label, ms, b in (("fused", t["fused"], fb), ("two-pass", t["packed"], pb),
                         ("fused M=16", t["fused_m16"], fb16),
                         ("two-pass M=16", t["packed_m16"], pb16)):
        parts = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in b["bound_parts"].items())
        log(f"  one-pass {form} {label} scan {ms:.3f} ms: "
            f"{100 * b['bound_ms'] / ms:.1f}% of its {b['bound_by']} bound "
            f"{b['bound_ms']:.4f} ms ({parts}); this kernel's epilogue "
            f"{b['epilogue_ms']:.4f} ms")
        if ms < 0.95 * b["bound_ms"]:
            fail(f"one-pass {form} {label}: {ms} ms beats 0.95 x its bound")
    log(f"  search QPS {m / t['search'] * 1e3:.0f}; bf16 torch.matmul of the "
        f"product alone (not the scan's function) {t['bf16_gemm']:.3f} ms")
    del index
    return kernels


def phase_clusters_gaussian(prk, data, results):
    """Phase 11 (C3): the default build (``cluster="auto"``) on the Sift1M
    Gaussian data beside ``cluster="off"``.  The crossover enables pruning,
    the ``"h100"`` profile must veto it (the pruned scan priced at least
    as high as the dense one; both times printed), the build must run no
    k-means (no cluster timings, no tables, no miss check) and the search
    must equal ``cluster="off"`` bit for bit."""
    from repro_torch.search import Index

    db, q = data[:2]
    kw = dict(metric=SIFT["metric"], k=K, recall_target=TARGET)

    def timed(**extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = Index.build(db, **kw, **extra)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    prk.reset_counts()
    timed(cluster="off")  # the allocator's first growth, outside the times
    off, off_s = timed(cluster="off")
    auto, build_s = timed()
    cp, pk = auto.kernel_plan.cluster, auto.pack()
    veto = auto.kernel_plan.cluster_veto
    block = auto.explain()["cluster"]
    out = dict(build_s=build_s, off_build_s=off_s, timings=auto.pack_timings,
               veto=block, m=auto.kernel_plan.query_block,
               plan=dict(num_clusters=cp.num_clusters, probes=cp.probes,
                         scan_rows=cp.scan_rows, enabled=cp.enabled))
    log(f"[sift1m gaussian] Index.build(db) {build_s:.3f} s, cluster=\"off\" "
        f"{off_s:.3f} s (PR 18: 2.05 s against 0.03 s); cluster timings "
        f"{auto.pack_timings}; h100 veto at the plan's batch "
        f"{out['m']}: pruned {block.get('predicted_pruned_s')} s, dense "
        f"{block.get('predicted_dense_s')} s")
    if veto is None or cp.enabled or veto[0] < veto[1]:
        fail(f"gaussian data: the h100 profile must veto pruning ({veto})")
    if pk.cluster is not None or pk.cluster_rejected_miss is not None \
            or auto.pack_timings:
        fail("gaussian data: the default build ran k-means or the miss check")
    va, ia = auto.search(q)
    vo, io = off.search(q)
    torch.cuda.synchronize()
    if not (torch.equal(va, vo) and torch.equal(ia, io)):
        fail("gaussian data: the default build is not bit-identical to "
             "cluster=off")
    log("[sift1m gaussian] default search bit-identical to cluster=off")
    read_counts(prk, "cluster gaussian", ("f32",), results, two_pass=False)
    results["cluster_gaussian"] = out
    return out


def mixture_data(seed, n, d, m):
    """The mixture corpus of ``tests/test_cluster.py`` at the given shape,
    on the card: 64 components, centers N(0, 1) x 2.5, unit noise,
    queries from the same centers; rows to add and ids to delete."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn((64, d), generator=g, device="cuda") * 2.5

    def draw(count):
        pick = torch.randint(0, 64, (count,), generator=g, device="cuda")
        return centers[pick] + torch.randn((count, d), generator=g, device="cuda")
    db, q, extra = draw(n), draw(m), draw(10_000)
    dead = torch.randperm(n, generator=g, device="cuda")[:50_000]
    return db, q, extra, dead


def phase_clusters_mixture(prk, seed, results):
    """Phase 12 (see the module docstring).  Returns what it measured."""
    from repro_torch.search import Index, plan_search

    db, q, extra, dead = mixture_data(seed, SIFT["n"], SIFT["d"], SIFT["m"])
    metric = SIFT["metric"]
    live = torch.ones(db.shape[0], dtype=torch.bool, device="cuda")
    truth = exact_topk(metric, q, db, live, K)
    rows = torch.cat([db, extra])
    live_after = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live_after[dead] = False
    qa = q[:2_000]
    truth_after = exact_topk(metric, qa, rows, live_after, K)
    out = {}
    for storage in ("f32", "int8"):
        label = f"mixture {storage}"
        kw = dict(metric=metric, k=K, recall_target=TARGET, storage=storage)
        prk.reset_counts()
        t0 = time.perf_counter()
        # the "a100" profile keeps the reference's decision (the card's own
        # vetoes the pruned scan), so the pruned path is measured here
        index = Index.build(db, profile="a100", **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cp, cs = index.kernel_plan.cluster, index.pack().cluster
        got = (cp.num_clusters, cp.rows_per_cluster, cp.probes, cp.spill_capacity)
        if got != (1024, 1224, 32, 15_632) or not cp.enabled:
            fail(f"{label}: cluster plan {got}, enabled={cp.enabled}")
        if cs is None:
            fail(f"{label}: the miss check dropped the tables "
                 f"({index.pack().cluster_rejected_miss})")
        v, i = index.search(q)
        torch.cuda.synchronize()
        r1 = recall(i, truth)
        floor = index.expected_recall - hoeffding_eps(q.shape[0])
        log(f"[{label}] build {build_s:.2f} s {index.pack_timings}; plan C="
            f"{cp.num_clusters} R={cp.rows_per_cluster} probes={cp.probes} spill="
            f"{cp.spill_capacity} S={cp.scan_rows}, spill used "
            f"{cs.spill_count}; search M={q.shape[0]}: recall {r1:.4f} (floor "
            f"{floor:.4f}, E[recall] {index.expected_recall:.4f})")
        if not r1 >= floor:
            fail(f"{label}: recall {r1} < {floor}")
        if not torch.isfinite(v).all():
            fail(f"{label}: non-finite values")
        launches, plain = dict(prk.LAUNCHES), dict(prk.PLAIN_CALLS)
        if sum(launches.values()) or sum(plain.values()):
            fail(f"{label}: the pruned path launched {launches} or called "
                 f"{plain}; it has no kernel")
        log(f"[{label}] launches {launches}, plain calls {plain} (the pruned "
            f"scan is a gather and a bmm in plain PyTorch, as the reference's "
            f"is XLA)")
        timed = {}
        off = Index.build(db, cluster="off", **kw)

        def h100_ms(m, mode):
            """The "h100" profile's price of the pruned path (kept) or of
            the dense scan, at a batch of m."""
            return 1e3 * plan_search(
                n=index.capacity, d=SIFT["d"], k=K, m=m, metric=metric,
                recall_target=TARGET, storage=storage, backend="cuda",
                device="h100", cluster=mode, cluster_veto=False).predicted_s
        for name, idx, mode in (("pruned", index, "auto"), ("off", off, "off")):
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            timed[name] = dict(
                ms=cuda_ms(lambda: idx.search(q), reps=3),
                ms_m16=cuda_ms(lambda: idx.search(q[:16]), reps=20),
                ms_m16_device=queued_ms(lambda: idx.search(q[:16]), reps=20),
                predicted_ms=h100_ms(q.shape[0], mode),
                predicted_ms_m16=h100_ms(16, mode),
                peak_extra_bytes=torch.cuda.max_memory_allocated() - base_mem)
        _, io = off.search(q)
        timed["off"]["recall"] = recall(io, truth)
        del off
        index.add(extra)
        index.delete(dead)
        v, i = index.search(qa)
        if torch.isin(i.long(), dead).any():
            fail(f"{label}: a deleted id was returned")
        r2 = recall(i, truth_after)
        floor2 = index.expected_recall - hoeffding_eps(qa.shape[0])
        log(f"[{label}] add 10000 + delete 50000: recall {r2:.4f} (floor "
            f"{floor2:.4f}); spill used {index.pack().cluster.spill_count}")
        if not r2 >= floor2:
            fail(f"{label}: recall after updates {r2} < {floor2}")
        for name in ("pruned", "off"):
            tt = timed[name]
            log(f"  [{label}] {name:6s}: M={q.shape[0]} {tt['ms']:.3f} ms "
                f"(h100 prediction {tt['predicted_ms']:.3f}), M=16 "
                f"{tt['ms_m16']:.3f} ms, queued {tt['ms_m16_device']:.3f} ms "
                f"(prediction {tt['predicted_ms_m16']:.4f}); peak memory "
                f"above the index {tt['peak_extra_bytes'] / 2**30:.2f} GiB")
        out[storage] = dict(build_s=build_s, timings=index.pack_timings,
                            recall=r1, recall_after_updates=r2,
                            expected_recall=index.expected_recall,
                            spill_count=cs.spill_count, **timed)
        del index
    results["cluster_mixture"] = out
    return out


# Phase 13: the tiers served (storage, compute dtype, label)
SERVE_TIERS = (("f32", None, "f32"), ("int8", None, "int8"),
               ("f32", "bfloat16", "f32 at bf16 compute"))


def served_requests(seed, count, d):
    """A seeded stream of requests: 1-64 rows of unit-normal queries (host
    f32), each with its own k of at most K."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(1, 65)), d), dtype=np.float32),
             int(rng.integers(1, K + 1))) for _ in range(count)]


def served_mismatches(index, pairs):
    """(ticket results, queries, k) triples that differ from a direct
    ``Index.search`` of the same rows in any bit."""
    bad = []
    for got, q, k in pairs:
        direct = index.search(q)
        if not (torch.equal(got.values, direct.values[:, :k].cpu())
                and torch.equal(got.indices, direct.indices[:, :k].cpu())):
            diff = float((got.values - direct.values[:, :k].cpu()).abs().max())
            bad.append((q.shape[0], k, diff))
    return bad


def host_ms(fn, reps: int = 100) -> float:
    """Median host wall time of ``fn()`` (which ends in a synchronize),
    after three warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def serve_latency(index, server_cls, config_cls, q16):
    """The four times of one M=16 search: an eager ``Index.search`` call
    (CUDA events around one call, the host's Python included), a graph
    replay with its host round trip (pinned copy in, replay, copy out,
    synchronize), a served request from submit to result (a wall-clock
    server with no coalescing window, one client), and the card's time of
    replays queued back to back (and of eager searches)."""
    q_dev = torch.as_tensor(q16, device="cuda")
    graph = index.search_graph(16)
    pinned = torch.as_tensor(q16).to(index.query_dtype).pin_memory()
    out_v = torch.empty(graph.values.shape, dtype=graph.values.dtype,
                        pin_memory=True)
    out_i = torch.empty(graph.indices.shape, dtype=graph.indices.dtype,
                        pin_memory=True)

    def round_trip():
        graph.queries.copy_(pinned, non_blocking=True)
        index.replay_graph(graph)
        out_v.copy_(graph.values, non_blocking=True)
        out_i.copy_(graph.indices, non_blocking=True)
        torch.cuda.current_stream().synchronize()

    server = server_cls(index, config_cls(max_delay_s=0.0))
    try:
        served = host_ms(lambda: server.submit(q16).result(timeout=60))
    finally:
        server.close(timeout=60)
    return dict(eager_ms=cuda_ms(lambda: index.search(q_dev), reps=51),
                replay_round_trip_ms=host_ms(round_trip),
                served_ms=served,
                replay_queued_ms=queued_ms(lambda: index.replay_graph(graph)),
                eager_queued_ms=queued_ms(lambda: index.search(q_dev)))


def serve_wall_clock(index, data, server_cls, config_cls, label, seed):
    """Four submitting threads send 2,000 requests of 1-64 rows (groups of
    8 in flight each); after half of them, ``server.mutation()`` adds
    10,000 rows (growth: every graph is recaptured) and deletes 50,000.
    Requests submitted after the mutation must equal direct searches."""
    import threading

    import numpy as np

    _, _, extra, dead = data
    server = server_cls(index, config_cls())
    captures0 = index.cache_info()["captures"]
    per_thread, threads = 500, 4
    done = [0]
    lock = threading.Lock()
    tickets, errors = [], []

    def client(cid):
        try:
            reqs = served_requests(seed + 100 + cid, per_thread, SIFT["d"])
            for s in range(0, per_thread, 8):
                group = [(server.submit(q, k=k), q, k) for q, k in reqs[s:s + 8]]
                for t, q, k in group:
                    t.result(timeout=120)
                with lock:
                    tickets.extend(group)
                    done[0] += len(group)
        except Exception as e:  # surfaced below
            errors.append(e)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client, args=(c,)) for c in range(threads)]
    for w in workers:
        w.start()
    while done[0] < threads * per_thread // 2 and not errors \
            and any(w.is_alive() for w in workers):
        time.sleep(0.002)
    with server.mutation():
        index.add(extra)
        index.delete(dead)
    mutated_at = time.monotonic()
    for w in workers:
        w.join(300)
    elapsed = time.perf_counter() - t0
    server.close(timeout=60)
    if errors or any(w.is_alive() for w in workers):
        fail(f"[serve {label}] wall-clock run: {errors[:3]}")
    after = [(t.result(), q, k) for t, q, k in tickets if t.submitted_at > mutated_at]
    bad = served_mismatches(index, after)
    lat = sorted(t.latency_s for t, _, _ in tickets)
    st = server.stats()
    info = index.cache_info()
    out = dict(requests=len(tickets), rows=sum(q.shape[0] for _, q, _ in tickets),
               seconds=elapsed, batches=st["batches"],
               graph_replays=st["graph_replays"],
               eager_batches=st["eager_batches"], occupancy=st["occupancy"],
               p50_ms=1e3 * lat[len(lat) // 2],
               p99_ms=1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               recaptures=info["captures"] - captures0,
               invalidations=info["invalidations"], checked_after=len(after))
    out["qps"] = out["rows"] / elapsed
    out["requests_per_s"] = out["requests"] / elapsed
    log(f"[serve {label}] wall clock: {out['requests']} requests, "
        f"{out['rows']} rows in {elapsed:.3f} s: {out['qps']:.0f} QPS "
        f"({out['requests_per_s']:.0f} requests/s), p50 {out['p50_ms']:.3f} ms, "
        f"p99 {out['p99_ms']:.3f} ms, occupancy {out['occupancy']:.3f}, "
        f"graph_replays {out['graph_replays']} of {out['batches']} batches, "
        f"recaptures {out['recaptures']} after the mutation (add 10000 + "
        f"delete 50000); {len(after)} requests after it checked")
    if bad:
        fail(f"[serve {label}] {len(bad)} of {len(after)} requests after the "
             f"mutation differ from direct searches: {bad[:5]}")
    if out["graph_replays"] != out["batches"] or out["recaptures"] < 1:
        fail(f"[serve {label}] graph replays {out['graph_replays']} of "
             f"{out['batches']} batches, {out['recaptures']} recaptures")
    return out


def compare_bucket_kernels(prk, testing, index, buckets, label, seed, acc):
    """Each kernel against its plain version at every bucket's shape: the
    bucket's rows of seeded queries, prepared and cast as a search does,
    over the index's packed operands (each bucket has its own split
    plan)."""
    import numpy as np

    from repro_torch.search import get_metric

    pk = index.pack()
    ops = pk.operands()
    scale = None if pk.storage == "f32" else ops[2]
    rng = np.random.default_rng(seed)
    for b in buckets:
        q = torch.as_tensor(rng.standard_normal((b, index.dim), dtype=np.float32),
                            device="cuda").to(index.query_dtype)
        qm = get_metric(index.spec.metric).prepare_queries(q)
        compare_kernels(prk, testing, f"serve {label} bucket M={b}", qm, ops[0],
                        ops[1], pk.bin_size, index.k_scan, acc, scale=scale,
                        int4_packed=pk.int4_packed)


def phase_serve(prk, testing, data, results, seed, acc):
    """Phase 13: ``SearchServer`` on the card at the Sift1M shape, one CUDA
    graph per bucket, for the f32 tier, int8 and f32 at bf16 compute."""
    import numpy as np

    from repro_torch.search import (
        DISPATCH_COUNTS,
        Index,
        SearchServer,
        ServeConfig,
        VirtualClock,
    )
    from repro_torch.search.faults import FaultInjector

    db = data[0]
    out = {}
    for storage, dtype, label in SERVE_TIERS:
        t_phase = time.perf_counter()
        form, qparts = storage, 3
        if dtype == "bfloat16":
            form, qparts = "bf16" if storage == "f32" else storage, 1
        prk.reset_counts()
        DISPATCH_COUNTS.clear()
        index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                            storage=storage, dtype=dtype)
        server = SearchServer(index, clock=VirtualClock(), warmup=True)
        graphs = {b: index.search_graph(b) for b in server.buckets}
        row = dict(buckets=list(server.buckets),
                   capture_s={str(b): v for b, v in server.capture_s.items()},
                   captures=index.cache_info()["captures"],
                   capture_launches={str(b): g.launches for b, g in graphs.items()})
        log(f"[serve {label}] ladder {server.buckets}, captures "
            f"{row['captures']}, warm-up + capture s per bucket "
            + ", ".join(f"{b}: {v:.3f}" for b, v in server.capture_s.items()))
        want = names_of(form, qparts)[:2]
        for b, g in graphs.items():
            if g.plain_calls or any(g.launches.get(n, 0) != 1 for n in want):
                fail(f"[serve {label}] the graph of bucket {b} holds "
                     f"{g.launches} (plain {g.plain_calls}), not one of each of {want}")
        log(f"[serve {label}] each graph holds {want} once")
        # the path's launches: the warm-up and capture (a replay passes no
        # front end; the direct searches below are the checks')
        read_counts(prk, f"serve {label} (warm-up and capture)", (form,),
                    results, two_pass=False, qparts=qparts)
        compare_bucket_kernels(prk, testing, index, server.buckets, label,
                               seed + 2, acc)
        # the virtual clock: a seeded stream, every ticket a direct search
        reqs = served_requests(seed, 200, SIFT["d"])
        tickets = []
        for s in range(0, len(reqs), 10):
            tickets += [(server.submit(q, k=k), q, k) for q, k in reqs[s:s + 10]]
            server.run_until_idle()
        st = server.stats()
        bad = served_mismatches(index, [(t.result(), q, k) for t, q, k in tickets])
        log(f"[serve {label}] virtual clock: {len(reqs)} requests in "
            f"{st['batches']} batches ({st['graph_replays']} graph replays, "
            f"{st['eager_batches']} eager), occupancy {st['occupancy']:.3f}; "
            f"{len(reqs) - len(bad)} of {len(reqs)} bit-equal to direct searches")
        if bad:
            fail(f"[serve {label}] served results differ from direct searches "
                 f"(rows, k, max |diff|): {bad[:5]}")
        if st["graph_replays"] != st["batches"]:
            fail(f"[serve {label}] {st['graph_replays']} replays for "
                 f"{st['batches']} batches")
        row["virtual"] = dict(requests=len(reqs), batches=st["batches"],
                              graph_replays=st["graph_replays"],
                              occupancy=st["occupancy"])
        q16 = np.random.default_rng(seed + 1).standard_normal(
            (16, SIFT["d"]), dtype=np.float32)
        row["m16"] = serve_latency(index, SearchServer, ServeConfig, q16)
        m16 = row["m16"]
        log(f"[serve {label}] M=16: eager call {m16['eager_ms']:.4f} ms, graph "
            f"replay + host round trip {m16['replay_round_trip_ms']:.4f} ms, "
            f"served request {m16['served_ms']:.4f} ms, card time queued: "
            f"replay {m16['replay_queued_ms']:.4f} ms, eager "
            f"{m16['eager_queued_ms']:.4f} ms")
        # a transient fault at serve.dispatch: the retry gives the clean result
        inj = FaultInjector(schedule=[("serve.dispatch", 1, "transient")])
        faulty = SearchServer(index, clock=VirtualClock(), faults=inj)
        got = faulty.submit(q16).result()
        fs = faulty.stats()
        if served_mismatches(index, [(got, q16, K)]) or \
                (fs["transient_faults"], fs["dispatch_retries"]) != (1, 1):
            fail(f"[serve {label}] the retried dispatch differs or was not "
                 f"retried once: {fs['transient_faults']} faults, "
                 f"{fs['dispatch_retries']} retries")
        log(f"[serve {label}] transient fault at serve.dispatch: retried once, "
            f"result bit-equal to a direct search")
        row["wall"] = serve_wall_clock(index, data, SearchServer, ServeConfig,
                                       label, seed)
        row["dispatches"] = dict(DISPATCH_COUNTS)
        row["seconds"] = time.perf_counter() - t_phase
        log(f"[serve {label}] phase {row['seconds']:.1f} s")
        out[label] = row
        del index, server, faulty, graphs
    results["serve"] = out
    return out


def phase_snapshots(prk, seed, results):
    """Phase 14: snapshots on the card.  A card index of a mixture corpus
    (N=100,000, D=128, l2), f32 and int8, with cluster tables (the
    ``"a100"`` profile keeps them) and without (the default), saved and
    restored on the card: the same tables and the same search bits, and
    no preparation, quantization or k-means at restore; then a snapshot
    the port wrote on the CPU restored on the card, searching as the CPU
    index does (the kernels against the plain versions: the shared
    tie-aware helper)."""
    import tempfile

    from repro_torch.search import PACK_EVENTS, Index
    from repro_torch.testing import assert_topk_close

    db, q, _, _ = mixture_data(seed, 100_000, SIFT["d"], 500)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for storage in ("f32", "int8"):
            for profile, tables in ((None, False), ("a100", True)):
                label = f"{storage} {'with' if tables else 'without'} tables"
                index = Index.build(db, metric=SIFT["metric"], k=K,
                                    recall_target=TARGET, storage=storage,
                                    profile=profile)
                if (index.pack().cluster is not None) != tables:
                    fail(f"[snapshot {label}] tables {index.pack().cluster}")
                v, i = index.search(q)
                t0 = time.perf_counter()
                path = index.save(f"{tmp}/{storage}-{tables}")
                save_s = time.perf_counter() - t0
                PACK_EVENTS.clear()
                t0 = time.perf_counter()
                back = Index.restore(path)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                rv, ri = back.search(q)
                if dict(PACK_EVENTS) != {"restore": 1}:
                    fail(f"[snapshot {label}] restore did build work: "
                         f"{dict(PACK_EVENTS)}")
                if tables and not all(torch.equal(getattr(back.pack().cluster, n),
                                                  getattr(index.pack().cluster, n))
                                      for n in ("centroids", "cluster_rows",
                                                "spill_rows")):
                    fail(f"[snapshot {label}] restored tables differ")
                if not (torch.equal(v, rv) and torch.equal(i, ri)):
                    fail(f"[snapshot {label}] restored search differs")
                out[label] = dict(save_s=save_s, restore_s=restore_s)
                log(f"[snapshot {label}] save {save_s:.3f} s, restore on the "
                    f"card {restore_s:.3f} s, search bit-equal")
                del index, back
        cpu = Index.build(db[:20_000].cpu(), metric=SIFT["metric"], k=K,
                          storage="int8", cluster="off", device="cpu")
        path = cpu.save(f"{tmp}/cpu")
        PACK_EVENTS.clear()
        prk.reset_counts()
        card = Index.restore(path)
        v, i = card.search(q[:200])
        torch.cuda.synchronize()
        cv, ci = cpu.search(q[:200].cpu())
        assert_topk_close(cv.numpy(), ci.numpy(), v.cpu().numpy(), i.cpu().numpy())
        if dict(PACK_EVENTS) != {"restore": 1} or card.device.type != "cuda" \
                or not prk.LAUNCHES:
            fail(f"[snapshot cpu -> card] {dict(PACK_EVENTS)}, "
                 f"{dict(prk.LAUNCHES)}")
        log(f"[snapshot cpu -> card] an int8 index written on the CPU restored on "
            f"the card: its kernels {dict(prk.LAUNCHES)}, search agrees with the "
            f"CPU's")
    results["snapshots"] = out
    return out


# Phase 15: the host tier's segment rows a wave under the budget-planned
# runs: 30 bins of 4096 rows (60 of 2048, 120 of 1024), so every tier's
# wave holds whole bins and its two slots fit the budget exactly; nine
# waves at the Sift1M shape.
HOST_SEGMENT_ROWS = 122_880
# ... and of the bit-equality run: 32 bins of 4096 rows, eight waves.
HOST_ALIGNED_ROWS = 131_072


def link_rate(nbytes: int = 256 << 20) -> float:
    """Bytes a second of a pinned host-to-device copy of ``nbytes`` (the
    median of five CUDA-event timings)."""
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True))
    return nbytes / (ms / 1e3)


def host_peak(search) -> int:
    """Device bytes at the peak of ``search()`` above what was allocated
    before it (the allocator's cache emptied first, so that no request is
    served by a larger cached block, which the allocated bytes would
    count whole)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    search()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def wave_times(index, q):
    """One search of ``q`` with each wave's CUDA events: the copies' and
    the scans' milliseconds."""
    searcher = index.host_searcher()
    searcher.record_timing = True
    index.search(q)
    torch.cuda.synchronize()
    searcher.record_timing = False
    copies = [c0.elapsed_time(c1) for c0, c1, _, _ in searcher.wave_events]
    scans = [s0.elapsed_time(s1) for _, _, s0, s1 in searcher.wave_events]
    return copies, scans


def compare_wave_kernels(prk, testing, index, q, label, acc):
    """Each kernel against its plain version on a host index's slot (a
    wave's operands, as the last search staged them), at both batches the
    phase searches, M=16 and M=10,000: each has its own split plan."""
    from repro_torch.search import get_metric

    searcher = index.host_searcher()
    slot = searcher.slots[0]
    for m in (16, SIFT["m"]):
        qm = get_metric(index.spec.metric).prepare_queries(q[:m])
        compare_kernels(prk, testing, f"{label} wave M={m}", qm, slot["db"],
                        slot["bias"], searcher.bin_size, searcher.wave_k_scan,
                        acc, scale=slot["scale"],
                        int4_packed=index.pack().int4_packed)


def phase_host_tier(prk, testing, data, results, acc):
    """Phase 15: the host-RAM cold tier at the Sift1M shape.

    The f32 index of 131,072-row segments (eight waves, capacity
    1,048,576, whole 4,096-row bins) searches bit for bit as the HBM
    index at M=10,000 and M=16, before and after an add of 10,000 rows
    and a delete of 50,000.  Then f32, int8 and int4 built with the
    budget that ``plan_segments`` turns into 122,880-row segments (nine
    waves): recall at the wave plan's E[recall] - eps against the exact
    oracle, before and after the same updates; two launches a wave and no
    plain version; one ``"host"`` dispatch a wave; the device memory a
    search adds is its two slots (allocated at the first search and kept;
    their bytes within the budget) and no more query-sized work than the
    HBM index's search of the same queries plus the carry merges of the
    waves (64 bytes a carry entry); each kernel against its plain version
    on a wave's operands at M=16 and M=10,000, for the aligned index and
    every tier (phase 7's tolerances).  Timings: the pinned link's
    rate, each wave's copy and scan, and the search beside
    max(copies, scans) at M=10,000 and M=16."""
    from repro_torch.search import DISPATCH_COUNTS, Index

    t_phase = time.perf_counter()
    db, q, extra, dead = data
    n, d, metric = SIFT["n"], SIFT["d"], SIFT["metric"]
    kw = dict(metric=metric, k=K, recall_target=TARGET, cluster="off")
    rows = torch.cat([db, extra])
    live = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live[n:] = False
    truth = exact_topk(metric, q, rows, live, K)
    live[n:] = True
    live[dead] = False
    truth_after = exact_topk(metric, q, rows, live, K)
    rate = link_rate()
    out = {"link_gb_s": rate / 1e9}
    log(f"[host] pinned host-to-device copy of 256 MiB: {rate / 1e9:.2f} GB/s")

    # bit-equality with the HBM index at segments of whole bins
    hbm = Index.build(db, **kw)
    host = Index.build(db, residency="host", segment_rows=HOST_ALIGNED_ROWS,
                       **kw)
    waves = host.capacity // HOST_ALIGNED_ROWS
    if (waves, host.capacity) != (8, 1_048_576) or host.device.type != "cuda" \
            or not host.pack().db.is_pinned():
        fail(f"[host aligned] {waves} waves, capacity {host.capacity}")
    if HOST_ALIGNED_ROWS % host.host_searcher().bin_size:
        fail(f"[host aligned] wave bins of {host.host_searcher().bin_size}")
    for when in ("before", "after"):
        if when == "after":
            for idx in (hbm, host):
                idx.add(extra)
                idx.delete(dead)
        for m in (SIFT["m"], 16):
            a, b = host.search(q[:m]), hbm.search(q[:m])
            if not (torch.equal(a.values, b.values)
                    and torch.equal(a.indices, b.indices)):
                fail(f"[host aligned] M={m} {when} the updates: not the HBM "
                     "index's bits")
    log(f"[host aligned] {waves} waves of {HOST_ALIGNED_ROWS} rows: bit-equal "
        f"to the HBM index at M={SIFT['m']} and M=16, before and after "
        f"add 10000 + delete 50000")
    compare_wave_kernels(prk, testing, host, q, "sift1m f32 host aligned", acc)
    del host, hbm

    for storage in ("f32", "int8", "int4"):
        label = f"sift1m {storage} host"
        hbm = Index.build(db, storage=storage, **kw)
        hbm_added = {m: host_peak(lambda: hbm.search(q[:m]))
                     for m in (16, SIFT["m"])}
        del hbm
        # the budget plan_segments turns into HOST_SEGMENT_ROWS rows a wave
        per_row = d * (0.5 if storage == "int4" else
                       {"f32": 4, "int8": 1}[storage]) + 8
        if storage != "f32":
            per_row += 4 * d + 4
        budget = 2 * per_row * HOST_SEGMENT_ROWS
        t0 = time.perf_counter()
        index = Index.build(db, storage=storage, residency="host",
                            hbm_budget_bytes=budget, **kw)
        build_s = time.perf_counter() - t0
        res = index.explain()["residency"]
        waves = res["num_segments"]
        if res["segment_rows"] != HOST_SEGMENT_ROWS or waves < 8:
            fail(f"[{label}] budget {budget}: {res['segment_rows']} rows a "
                 f"wave, {waves} waves")
        row = dict(budget_bytes=budget, waves=waves, build_s=build_s,
                   segment_rows=HOST_SEGMENT_ROWS, capacity=index.capacity)
        # the two slots, made at the first search and kept
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        searcher = index.host_searcher()
        slot_alloc = torch.cuda.memory_allocated() - before
        slot_bytes = sum(t.numel() * t.element_size() for s in searcher.slots
                         for t in s.values() if t is not None)
        # the path: counts from 0 just before, read just after
        prk.reset_counts()
        DISPATCH_COUNTS.clear()
        added = {16: host_peak(lambda: index.search(q[:16]))}
        out_m = {}
        added[SIFT["m"]] = host_peak(
            lambda: out_m.update(r=index.search(q)))
        v, i = out_m.pop("r")
        wave_floor = searcher.wave_plan.expected_recall
        r1 = recall(i, truth)
        for m, got in added.items():
            allowed = hbm_added[m] + 64 * m * K
            log(f"[{label}] M={m}: the search adds {(slot_alloc + got) / 2**20:.1f}"
                f" MiB of device memory: slots {slot_alloc / 2**20:.1f} MiB "
                f"({slot_bytes} bytes; budget {budget}) and "
                f"{got / 2**20:.2f} MiB of query-sized work (the HBM index's "
                f"search {hbm_added[m] / 2**20:.2f} MiB, carry merges "
                f"{64 * m * K / 2**20:.2f} MiB)")
            if slot_bytes > budget or got > allowed:
                fail(f"[{label}] M={m}: slots {slot_bytes} bytes (budget "
                     f"{budget}), {got} bytes beside them (allowed {allowed})")
            row[f"added_bytes_m{m}"] = slot_alloc + got
            row[f"query_bytes_m{m}"] = got
            row[f"hbm_added_bytes_m{m}"] = hbm_added[m]
        row.update(slot_bytes=slot_bytes, slot_alloc_bytes=slot_alloc)
        index.add(extra)
        index.delete(dead)
        va, ia = index.search(q)
        torch.cuda.synchronize()
        launches, plain = dict(prk.LAUNCHES), dict(prk.PLAIN_CALLS)
        dispatches = dict(DISPATCH_COUNTS)
        fused, merge = names_of(storage)[:2]
        searches = 3
        if launches != {fused: searches * waves, merge: searches * waves} \
                or plain or dispatches != {"host": searches * waves}:
            fail(f"[{label}] launches {launches}, plain {plain}, dispatches "
                 f"{dispatches} for {searches} searches of {waves} waves")
        read_counts(prk, label, (storage,), results, two_pass=False)
        wave_floor_after = index.host_searcher().wave_plan.expected_recall
        r2 = recall(ia, truth_after)
        eps = hoeffding_eps(q.shape[0])
        log(f"[{label}] build {build_s:.2f} s, {waves} waves of "
            f"{HOST_SEGMENT_ROWS} rows (wave bins of {searcher.bin_size}, "
            f"k_scan {searcher.wave_k_scan}): recall {r1:.4f} (floor "
            f"{wave_floor - eps:.4f}), after add 10000 + delete 50000 "
            f"{r2:.4f} (floor {wave_floor_after - eps:.4f}); launches "
            f"{launches}, dispatches {dispatches}")
        if not (r1 >= wave_floor - eps and r2 >= wave_floor_after - eps):
            fail(f"[{label}] recall {r1} / {r2}")
        if not torch.isfinite(va).all() or torch.isin(ia.long(), dead).any():
            fail(f"[{label}] non-finite values or a deleted id")
        row.update(recall=r1, recall_after_updates=r2,
                   expected_recall=wave_floor, launches=launches)
        # timings: each wave's copy and scan, and the search
        for m in (SIFT["m"], 16):
            copies, scans = wave_times(index, q[:m])
            search_ms = cuda_ms(lambda: index.search(q[:m]))
            wave_bytes = searcher.wave_bytes
            row[f"m{m}"] = dict(
                search_ms=search_ms, copies_ms=copies, scans_ms=scans,
                sum_copies_ms=sum(copies), sum_scans_ms=sum(scans),
                wave_bytes=wave_bytes,
                copy_gb_s=wave_bytes / (sorted(copies)[len(copies) // 2] / 1e3)
                / 1e9)
            log(f"[{label}] M={m}: search {search_ms:.3f} ms beside "
                f"max(copies {sum(copies):.3f}, scans {sum(scans):.3f}) = "
                f"{max(sum(copies), sum(scans)):.3f} ms (serial "
                f"{sum(copies) + sum(scans):.3f}); a wave's copy "
                f"{sorted(copies)[len(copies) // 2]:.3f} ms "
                f"({wave_bytes / 2**20:.1f} MiB, "
                f"{row[f'm{m}']['copy_gb_s']:.2f} GB/s), scan "
                f"{sorted(scans)[len(scans) // 2]:.3f} ms")
        # each kernel against its plain version at the path's wave shapes
        compare_wave_kernels(prk, testing, index, q, label, acc)
        out[storage] = row
        del index, searcher
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[host] phase 15: {out['seconds']:.1f} s")
    results["host_tier"] = out
    return out


# Phase 16: the kNN-LM datastore (2^21 Gaussian keys at D=2048, f32, k=32
# and the reference's default recall target, room for 65,536 more) and
# internlm2-1.8b at full width behind the serving engine.
KNN_LM = dict(n=1 << 21, d=2048, k=32, extra=65_536, forget=100_000,
              queries=1_024, arch="internlm2-1.8b", vocab=92_544, batch=8,
              max_seq=2048, prompt=64, steps=32, seed=16)
# Phase 17: granite-moe-3b-a800m (d_model 1536) with a datastore of the
# same size at its width, value tokens in its vocabulary; then the other
# families at full width (deepseek-v2 cut to 4 of its 60 layers: one
# mla_dense, three mla_moe), each behind the engine for 16 decode steps:
# (arch, layers kept, kNN attention too).  SSM and RG-LRU layers have no global
# attention, so their kNN run would be the exact one.
FAMILY_LM = dict(KNN_LM, d=1536, arch="granite-moe-3b-a800m", vocab=49_155,
                 seed=18)
FAMILY_RUNS = (("deepseek-v2-236b", 4, True), ("mamba2-2.7b", None, False),
               ("qwen2-vl-2b", None, True), ("recurrentgemma-9b", None, False))
WHISPER = dict(arch="whisper-medium", batch=8, prompt=64, steps=16, max_seq=2048)


def timed_ms(fn):
    """Host wall time of ``fn()`` in ms, the card synchronized on both
    sides (a decode step or a retrieval: host work and kernels)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def median(xs):
    return sorted(xs)[len(xs) // 2]


def datastore_recall(ds, q, label, floor_of):
    """One direct lookup of ``q`` (two launches, no plain call), its ids
    against an exact top-k of the live keys and its tokens against the
    value tokens of its ids; returns the recall."""
    from repro_torch.kernels import partial_reduce as prk

    from repro_torch.testing import bits_equal

    plain = sum(prk.PLAIN_CALLS.values())
    v, i = launches_of(lambda: ds.index.search(q), 2, label)
    vals, toks = ds.lookup(q)
    if sum(prk.PLAIN_CALLS.values()) != plain:
        fail(f"{label}: a plain version ran")
    if not (bits_equal(vals, v) and torch.equal(toks, ds.value_tokens[i.long()])):
        fail(f"{label}: lookup differs from the index's search")
    if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], ds.k):
        fail(f"{label}: non-finite or misshapen values")
    truth = exact_topk("mips", q, ds.keys, ds.index._live, ds.k, chunk=256)
    r = recall(i, truth)
    floor = floor_of - hoeffding_eps(q.shape[0])
    log(f"[knn-lm] {label}: M={q.shape[0]} recall {r:.4f} (floor {floor:.4f})")
    if not r >= floor:
        fail(f"{label}: recall {r} < {floor}")
    return r


def knn_attention_recall(records, target):
    """kNN attention's selected keys at one decode step against the exact
    top-k over each layer's live cache positions; the masked positions it
    selects must weigh exactly 0."""
    from repro_torch.core.binning import plan_bins
    from repro_torch.core.topk import approx_max_k
    from repro_torch.models import attention as attn

    hits = total = 0
    for q, keys, values, valid, k, groups in records:
        scores = attn._group_scores(q, keys, groups) * attn._const(
            q.shape[-1] ** -0.5, q)
        scores = torch.where(valid, scores, attn._const(attn._NEG_INF, scores))
        top, idx = approx_max_k(scores, k, recall_target=target)
        probs = torch.softmax(top.float(), dim=-1)
        if (probs[~valid[idx.long()]] != 0).any():
            fail("kNN attention weighs a masked position")
        live = min(k, int(valid.sum()))
        exact = torch.topk(scores.float(), live, dim=-1).indices
        sel = torch.where(valid[idx.long()], idx.long(), -1)
        hits += int((sel[..., :, None] == exact[..., None, :]).any(-1).sum())
        total += exact.numel()
        s = keys.shape[1]
    r = hits / total
    floor = plan_bins(s, k, target).expected_recall - hoeffding_eps(total // live)
    log(f"[knn-lm] kNN attention at the last step: {len(records)} layers, "
        f"{total // live} (query, head) rows, {live} live positions, k={k}: "
        f"recall {r:.4f} (floor {floor:.4f})")
    if not r >= floor:
        fail(f"kNN attention recall {r} < {floor}")
    return r


def run_engine(cfg, model, c, use_knn, seed, ds=None, server=None):
    """``ServingEngine(batch, max_seq)`` of ``c``: admit ``batch`` prompts
    of ``prompt`` tokens, then ``steps`` decode steps (finite logits, no
    padded id sampled, the step captured as a CUDA graph).  With a
    datastore ``ds``, each step is followed by a retrieval of the step's
    input token embeddings, directly and then through ``server``
    (bit-equal, one graph replay), mixed with ``knn_lm_logits``; with kNN
    attention over GQA caches, its keys at the last step are checked
    against an exact top-k."""
    import numpy as np

    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.retrieval.datastore import knn_lm_logits
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.testing import bits_equal

    engine = ServingEngine(cfg, model, batch=c["batch"], max_seq=c["max_seq"],
                           use_knn=use_knn, seed=seed)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, c["prompt"])
                    .astype(np.int32), max_new_tokens=c["steps"])
            for i in range(c["batch"])]
    prefill_ms, _ = timed_ms(lambda: engine.admit(reqs))
    table = model.embed.embedding
    step_ms, direct_ms, served_ms, records = [], [], [], []
    knn = attn.knn_decode_attention

    def recording(q, keys, values, valid, **kw):
        records.append((q, keys, values, valid, kw["k"], kw["kv_groups"]))
        return knn(q, keys, values, valid, **kw)

    for step in range(c["steps"]):
        inp, position = engine.tokens.clone(), engine.cur_index
        ms, out = timed_ms(engine.step)
        step_ms.append(ms)
        logits = engine.last_logits[:, 0]
        if not torch.isfinite(logits.float()).all():
            fail(f"{cfg.name}: non-finite logits at step {step} (knn={use_knn})")
        if (out >= cfg.vocab_size).any():
            fail(f"{cfg.name}: a padded vocabulary id was sampled: {out}")
        if ds is None:
            continue
        q = table[inp[:, 0].long()].float()
        engine.attach_retrieval(ds.index, ds.value_tokens)
        ms, (dv, dt) = timed_ms(lambda: engine.retrieve(q))
        direct_ms.append(ms)
        engine.attach_retrieval(ds.index, ds.value_tokens, server=server)
        replays = ds.index.cache_info()["replays"]
        ms, (sv, st) = timed_ms(lambda: engine.retrieve(q))
        served_ms.append(ms)
        if ds.index.cache_info()["replays"] != replays + 1:
            fail("a served retrieval was not one graph replay")
        if not (bits_equal(sv, dv) and torch.equal(st, dt)):
            fail("a served retrieval differs from the direct one")
        mixed = knn_lm_logits(logits.float(), dv, dt)
        if not torch.isfinite(mixed).all():
            fail("non-finite kNN-LM logits")
    if not all(len(r.generated) == c["steps"] for r in reqs):
        fail(f"{cfg.name}: a request did not generate its tokens")
    if engine._graph is None:
        fail(f"{cfg.name}: the engine's decode step was not captured as a CUDA graph")
    gqa = any(k in ("dense", "moe") for k in cfg.layer_kinds())
    if use_knn and gqa:
        # the last step again, eagerly on copies of the caches (a graph
        # replay runs no Python), recording each layer's kNN attention
        caches = [type(ch)(*(f.clone() for f in ch)) for ch in engine.caches]
        attn.knn_decode_attention = recording
        try:
            tfm.forward_decode(model, inp, caches, position, use_knn=True)
        finally:
            attn.knn_decode_attention = knn
        del caches
    out = dict(prefill_ms=prefill_ms, step_ms=median(step_ms))
    if ds is not None:
        out.update(retrieval_ms=median(direct_ms), served_retrieval_ms=median(served_ms))
    if use_knn and gqa:
        out["knn_attention_recall"] = knn_attention_recall(
            records, cfg.knn_recall_target)
    del engine
    return out


def build_datastore(testing, c, seed):
    """A ``KNNDatastore`` of ``c["n"]`` Gaussian keys at ``c["d"]`` (f32),
    value tokens in ``[0, c["vocab"])``: the build (the h100 cluster
    decision and the seconds), lookups of ``c["queries"]`` queries at
    E[recall] - eps before and after ``extend`` and ``forget``, the
    functional search over the raw keys, and a served lookup bit-equal to
    a direct one.  Returns (datastore, its server, the queries, the
    record)."""
    from repro_torch.core.binning import plan_bins
    from repro_torch.retrieval.datastore import KNNDatastore
    from repro_torch.search import functional

    g = torch.Generator(device="cuda").manual_seed(seed + c["seed"])
    keys = torch.randn((c["n"], c["d"]), generator=g, device="cuda")
    tokens = torch.randint(0, c["vocab"], (c["n"],), generator=g, device="cuda",
                           dtype=torch.int32)
    q = torch.randn((c["queries"], c["d"]), generator=g, device="cuda")
    build_s, ds = timed_ms(lambda: KNNDatastore(
        keys, tokens, k=c["k"], capacity=c["n"] + c["extra"]))
    build_s /= 1e3
    kp = ds.index.kernel_plan
    log(f"[knn-lm] datastore build {build_s:.2f} s: N={c['n']}, D={c['d']}, "
        f"capacity {ds.index.capacity}, k={c['k']}, L={ds.index.plan.num_bins} "
        f"bins of {ds.index.plan.bin_size}, k_scan {ds.index.k_scan}, "
        f"E[recall] {ds.index.expected_recall:.4f}; cluster='auto': the "
        f"h100 profile vetoed pruning: {kp.cluster_veto is not None} "
        f"(pruned, dense predicted s {kp.cluster_price}), tables built: "
        f"{ds.index.pack().cluster is not None}")
    out = dict(d=c["d"], build_s=build_s, capacity=ds.index.capacity,
               bins=ds.index.plan.num_bins, bin_size=ds.index.plan.bin_size,
               cluster_vetoed=kp.cluster_veto is not None,
               cluster_price=kp.cluster_price,
               tables=ds.index.pack().cluster is not None)
    del keys
    torch.cuda.empty_cache()
    out["recall"] = datastore_recall(ds, q, "lookup", ds.index.plan.expected_recall)
    fv, fi = launches_of(lambda: functional.search(
        q, ds.keys[: c["n"]], k=c["k"]), 2, "functional search")
    truth = exact_topk("mips", q, ds.keys[: c["n"]],
                       torch.ones(c["n"], dtype=torch.bool, device="cuda"),
                       c["k"], chunk=256)
    fr = recall(fi, truth)
    ffloor = (plan_bins(c["n"], c["k"], TARGET).expected_recall
              - hoeffding_eps(q.shape[0]))
    log(f"[knn-lm] functional search over the raw keys: recall {fr:.4f} "
        f"(floor {ffloor:.4f})")
    if not fr >= ffloor:
        fail(f"functional search recall {fr} < {ffloor}")
    del fv, fi, truth
    torch.cuda.empty_cache()
    extra = torch.randn((c["extra"], c["d"]), generator=g, device="cuda")
    ds.extend(extra, torch.randint(0, c["vocab"], (c["extra"],), generator=g,
                                   device="cuda", dtype=torch.int32))
    dead = torch.randperm(ds.index.capacity, generator=g, device="cuda")[: c["forget"]]
    ds.forget(dead)
    if len(ds) != c["n"] + c["extra"] - c["forget"] or ds.index.capacity != out["capacity"]:
        fail(f"datastore size {len(ds)}, capacity {ds.index.capacity} after updates")
    out["recall_after_updates"] = datastore_recall(
        ds, q, "lookup after extend + forget", ds.index.plan.expected_recall)
    del extra
    server_s, server = timed_ms(lambda: ds.attach_server(warmup=True))
    log(f"[knn-lm] SearchServer: buckets {server.buckets}, warm-up and "
        f"capture {server_s / 1e3:.2f} s")
    sv, st = ds.lookup(q[:8])
    ds.server = None
    dv, dt = ds.lookup(q[:8])
    if not (testing.bits_equal(sv, dv) and torch.equal(st, dt)):
        fail("the served lookup differs from the direct one")
    return ds, server, q, out


def init_full(arch, seed, layers=None):
    """A FULL config (``layers`` kept where given) with random bf16
    weights drawn on the card: (cfg, model, init seconds, weight bytes)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gm = torch.Generator(device="cuda").manual_seed(seed)
    init_ms, model = timed_ms(lambda: tfm.init_model(cfg, gm, device="cuda",
                                                      dtype=torch.bfloat16))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{arch}] {cfg.num_layers} layers (runs {tfm.runs_of(cfg)}), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {weight_bytes / 1e9:.3f} GB of "
        f"bf16 weights, init on the card {init_ms / 1e3:.2f} s")
    return cfg, model, init_ms / 1e3, weight_bytes


def datastore_kernels(prk, testing, ds, q, counts, smi):
    """The datastore's kernels against their plain versions at M=8 and
    M=128 (phase 7's tolerances), then timed beside their bounds: rows of
    the kernels line, and the times by M."""
    acc = {key: dict.fromkeys(names_of("f32"), 0.0 if key == "errs" else 0)
           for key in ("errs", "agree", "total")}
    from repro_torch.search import pad_queries_to

    pk = ds.index.pack()
    db, bias, bs, ks = pk.db, pk.bias, pk.bin_size, ds.index.k_scan
    n_pad, d = db.shape
    stored = 4.0 * n_pad * d + 4.0 * n_pad
    kernels, times = [], {}
    for m in (8, 128):
        qm = q[:m].contiguous()
        compare_kernels(prk, testing, f"knn-lm datastore D={d} M={m}", qm, db, bias,
                        bs, ks, acc, chunk=128)
        qp = pad_queries_to(qm, d).contiguous()
        carries = prk.fused_scan(qp, db, bias, k_scan=ks, bin_size=bs)
        splits = carries[0].shape[0]
        flat = carries[0].permute(1, 0, 2).reshape(m, splits * ks).contiguous()
        t = dict(
            fused=cuda_ms(lambda: prk.fused_scan(qp, db, bias, k_scan=ks, bin_size=bs)),
            merge=queued_ms(lambda: prk.fused_carry_merge(*carries)),
            packed=cuda_ms(lambda: prk.partial_reduce_packed(qm, db, bias, bin_size=bs)),
            fused_plain=cuda_ms(lambda: prk.partial_reduce_fused_plain(
                qp, db, bias, k_scan=ks, bin_size=bs), reps=3),
            merge_plain=queued_ms(lambda: prk.fused_carry_merge_plain(*carries)),
            packed_plain=cuda_ms(lambda: prk.partial_reduce_packed_plain(
                qp, db, bias, bin_size=bs), reps=3),
            topk=queued_ms(lambda: torch.topk(flat, ks, dim=1)),
            search=cuda_ms(lambda: ds.index.search(qm)),
        )
        fb = scan_bounds("f32", m, n_pad, d, 4.0 * m * d + stored + 8.0 * splits * m * ks)
        pb = scan_bounds("f32", m, n_pad, d, 4.0 * m * d + stored
                         + 8.0 * m * (n_pad // bs))
        mb = bound_ms(m * ks * splits, 8.0 * (splits + 1) * m * ks)
        shape = f"knn-lm datastore D={d} M={m}"
        fname, mname, pname = names_of("f32")
        for name, kind, ms, plain_ms, b, by, lib in (
                (fname, "partial_reduce_fused", t["fused"], t["fused_plain"],
                 fb["bound_ms"], fb["bound_by"], None),
                (mname, None, t["merge"], t["merge_plain"], mb[0], mb[1], t["topk"]),
                (pname, "partial_reduce_packed", t["packed"], t["packed_plain"],
                 pb["bound_ms"], pb["bound_by"], None)):
            kernels.append(dict(
                name=name, shape=shape, route="cuda", source=SRC,
                replaces=REPLACES[(kind, "f32")] if kind else f"{REF}:219",
                launches=counts.get(name, 0), max_abs_err=acc["errs"][name],
                index_agreement=acc["agree"][name] / max(acc["total"][name], 1),
                ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib, splits=splits, bin_size=bs, k_scan=ks))
        log(f"[knn-lm] D={d} M={m}: fused scan {t['fused']:.3f} ms ({fb['bound_by']} "
            f"bound {fb['bound_ms']:.3f} ms: {100 * fb['bound_ms'] / t['fused']:.1f}%; "
            f"parts {fb['bound_parts']}), merge {t['merge']:.4f} ms ({splits} "
            f"splits; bound {mb[0]:.5f}, torch.topk {t['topk']:.4f}), two-pass "
            f"{t['packed']:.3f} ms (bound {pb['bound_ms']:.3f}); plain fused "
            f"{t['fused_plain']:.3f}, plain two-pass {t['packed_plain']:.3f} ms; "
            f"search {t['search']:.3f} ms; on {smi}")
        times[f"m{m}"] = t
    return kernels, times


def serve_with_datastore(prk, testing, c, seed, results, smi, label):
    """A datastore of ``c``, then ``c["arch"]`` FULL behind the engine with
    exact and kNN attention and a retrieval each step (the path's counts
    from 0 to the end of the engine runs: the fused scan and the merge
    launched, no plain version), then the datastore's kernels; the
    datastore and the model are freed."""
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    prk.reset_counts()
    ds, server, q, out = build_datastore(testing, c, seed)
    cfg, model, init_s, weight_bytes = init_full(c["arch"], seed + c["seed"] + 1)
    cache_bytes = sum(f.numel() * f.element_size()
                      for ch in tfm.init_caches(cfg, 1, 1, device="meta") for f in ch
                      ) * c["batch"] * c["max_seq"]
    engines = {}
    for use_knn in (False, True):
        if use_knn and cfg.num_experts:  # the forwards read the model's cfg
            import dataclasses

            model.cfg = dataclasses.replace(cfg, router_topk_impl="approx")
        engines["knn" if use_knn else "exact"] = run_engine(
            model.cfg, model, c, use_knn, seed, ds=ds, server=server)
    model.cfg = cfg
    server.close()
    read_counts(prk, label, ("f32",), results, two_pass=False)
    counts = dict(prk.LAUNCHES)
    bound_w = 1e3 * weight_bytes / PEAK_HBM_BYTES
    bound_wc = 1e3 * (weight_bytes + cache_bytes) / PEAK_HBM_BYTES
    for name, e in engines.items():
        log(f"[{c['arch']}] {name} attention"
            + (" (approx router)" if name == "knn" and cfg.num_experts else "")
            + f": prefill replay {e['prefill_ms']:.1f} ms ({c['prompt']} steps), "
            f"decode step {e['step_ms']:.3f} ms (weight bytes bound {bound_w:.3f} "
            f"ms, with the whole KV cache {bound_wc:.3f} ms); retrieval per step "
            f"direct {e['retrieval_ms']:.3f} ms, served "
            f"{e['served_retrieval_ms']:.3f} ms; on {smi}")
    out.update(arch=c["arch"], engines=engines, weight_bytes=weight_bytes,
               init_s=init_s, weight_bound_ms=bound_w,
               weight_cache_bound_ms=bound_wc, launches=counts)
    del model
    torch.cuda.empty_cache()
    kernels, times = datastore_kernels(prk, testing, ds, q, counts, smi)
    out.update(times)
    del ds, server, q
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[knn-lm] {label}: {out['seconds']:.1f} s")
    return out, kernels


def phase_knn_lm(prk, testing, seed, results, smi):
    """Phase 16: kNN-LM serving at full width.  The datastore's build (the
    h100 cluster decision and the seconds), lookups of 1,024 queries at
    E[recall] - eps before and after ``extend`` and ``forget``, the
    functional search over the raw keys, then internlm2-1.8b behind
    ``ServingEngine`` with exact and kNN attention and a retrieval each
    decode step (direct and served); then the path's kernels against their
    plain versions at M=8 and M=128 and their times beside their bounds."""
    return serve_with_datastore(prk, testing, KNN_LM, seed, results, smi,
                                "phase 16")


def whisper_run(seed, smi):
    """whisper-medium FULL: ``make_prefill_step`` over random frame
    embeddings (8, 1500, 1024) and a 64-token prompt (logits, caches,
    cross KV), then the prompt replayed and 16 sampled steps through
    ``make_decode_step`` with the cross KV, from ``init_caches``."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm

    c = WHISPER
    cfg, model, init_s, weight_bytes = init_full(c["arch"], seed + 40)
    g = torch.Generator(device="cuda").manual_seed(seed + 41)
    b = c["batch"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, c["prompt"]), generator=g,
                                     device="cuda", dtype=torch.int32),
             "enc_embeds": torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                                       device="cuda", dtype=torch.bfloat16)}
    prefill_ms, (logits, caches, cross) = timed_ms(
        lambda: M.make_prefill_step(cfg)(model, batch))
    if not torch.isfinite(logits.float()).all():
        fail("whisper: non-finite prefill logits")
    if len(cross) != cfg.num_layers or tuple(cross[0].k.shape) != (
            b, cfg.encoder_seq, cfg.num_heads, cfg.resolved_head_dim):
        fail(f"whisper: cross KV {len(cross)} x {tuple(cross[0].k.shape)}")
    del caches
    step = M.make_decode_step(cfg)
    caches = tfm.init_caches(cfg, b, c["max_seq"], device="cuda")
    tok, step_ms = batch["tokens"][:, :1], []
    for t in range(c["prompt"] + c["steps"]):
        forced = t < c["prompt"]
        inp = batch["tokens"][:, t : t + 1] if forced else tok
        ms, (tok, logits, caches) = timed_ms(
            lambda: step(model, inp, caches, t, g, cross_kv=cross))
        if not forced:
            step_ms.append(ms)
        if not torch.isfinite(logits.float()).all() or (tok >= cfg.vocab_size).any():
            fail(f"whisper: non-finite logits or a padded id at step {t}")
    # a decode step reads the decoder's weights (not the encoder's), and
    # the cross KV and its self cache where attention reads them whole
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    dec_bytes = weight_bytes - nbytes([*model.encoder.parameters(),
                                       model.enc_final_norm])
    kv_bytes = nbytes([f for kv in (*cross, *caches) for f in kv])
    out = dict(init_s=init_s, weight_bytes=weight_bytes, prefill_ms=prefill_ms,
               step_ms=median(step_ms), decoder_bytes=dec_bytes,
               weight_bound_ms=1e3 * dec_bytes / PEAK_HBM_BYTES,
               weight_cache_bound_ms=1e3 * (dec_bytes + kv_bytes) / PEAK_HBM_BYTES)
    log(f"[whisper-medium] prefill step (encoder over {cfg.encoder_seq} frames, "
        f"{c['prompt']}-token prompt, cross KV) {prefill_ms:.1f} ms; eager decode "
        f"step {out['step_ms']:.3f} ms (decoder weight bytes bound "
        f"{out['weight_bound_ms']:.3f} ms, with the cross KV and the whole "
        f"self cache {out['weight_cache_bound_ms']:.3f} ms); on {smi}")
    del model, caches, cross
    torch.cuda.empty_cache()
    return out


def phase_families(prk, testing, seed, results, smi):
    """Phase 17: granite-moe-3b-a800m behind the engine with a D=1536
    datastore (as phase 16, the kNN run with the approx router), then
    deepseek-v2 (4 layers), mamba2, qwen2-vl (also a prefill step from
    patch embeddings) and recurrentgemma at full width behind the engine,
    and whisper through its step functions; each model freed before the
    next.  No plain kernel version runs on these paths."""
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    out, kernels = serve_with_datastore(prk, testing, FAMILY_LM, seed, results, smi,
                                        "phase 17 granite-moe")
    plain = sum(prk.PLAIN_CALLS.values())  # after the datastore's comparisons
    c = dict(FAMILY_LM, steps=16)
    models = {}
    for i, (arch, layers, knn) in enumerate(FAMILY_RUNS):
        t_model = time.perf_counter()
        cfg, model, init_s, weight_bytes = init_full(arch, seed + 21 + i, layers)
        row = dict(layers=cfg.num_layers, init_s=init_s, weight_bytes=weight_bytes,
                   weight_bound_ms=1e3 * weight_bytes / PEAK_HBM_BYTES)
        if cfg.input_mode == "embeddings":
            g = torch.Generator(device="cuda").manual_seed(seed + 30)
            emb = torch.randn((c["batch"], c["prompt"], cfg.d_model), generator=g,
                              device="cuda", dtype=torch.bfloat16)
            ms, (logits, caches) = timed_ms(
                lambda: M.make_prefill_step(cfg)(model, {"embeddings": emb}))
            if not torch.isfinite(logits.float()).all():
                fail(f"{arch}: non-finite prefill logits from patch embeddings")
            row["prefill_from_embeddings_ms"] = ms
            del caches, emb
        for use_knn in (False, True) if knn else (False,):
            row["knn" if use_knn else "exact"] = run_engine(cfg, model, c, use_knn, seed)
        row["seconds"] = time.perf_counter() - t_model
        for name in ("exact", "knn"):
            if name in row:
                log(f"[{arch}] {name} attention: decode step "
                    f"{row[name]['step_ms']:.3f} ms (weight bytes bound "
                    f"{row['weight_bound_ms']:.3f} ms), prefill replay "
                    f"{row[name]['prefill_ms']:.1f} ms; init {init_s:.2f} s, "
                    f"{row['seconds']:.1f} s in all; on {smi}")
        models[arch] = row
        del model
        torch.cuda.empty_cache()
    models["whisper-medium"] = whisper_run(seed, smi)
    if sum(prk.PLAIN_CALLS.values()) != plain:
        fail(f"plain versions ran in phase 17: {dict(prk.PLAIN_CALLS)}")
    out["models"] = models
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[families] phase 17: {out['seconds']:.1f} s")
    return out, kernels


# Phase 18: the per-block loop, logical shards, the FLOP cross-check, a
# sharded datastore and context-parallel kNN attention.  The attention
# shape is internlm2-1.8b's decode (configs/internlm2_1_8b.py: 16 heads, 8
# KV heads of 128 lanes) at batch 8 over a 2,048-position cache.
SHARDS = 4
SHARD_DS = dict(n=1 << 19, d=2048, k=32, queries=1_024, shards=2)
CP_ATTN = dict(batch=8, seq=2048, heads=16, kv_heads=8, head_dim=128, k=128,
               live=1_900)


def logical_mesh(shape, names):
    from repro_torch.parallel import make_mesh

    return make_mesh(shape, names, devices=["cuda:0"] * math.prod(shape))


def shard_kernel_rows(prk, testing, label, q, pk, ks, counts, smi, acc):
    """One shard's kernels (its packed operands, the form of its tier)
    against their plain versions (phase 7's tolerances) and timed beside
    their bounds at M = len(q): rows of the kernels line."""
    from repro_torch.search import pad_queries_to

    db, bias, scale, bs = pk.db, pk.bias, pk.scale, pk.bin_size
    i4 = pk.int4_packed
    m = q.shape[0]
    compare_kernels(prk, testing, label, q, db, bias, bs, ks, acc, scale=scale,
                    int4_packed=i4)
    form = prk.storage_form(db, scale, i4)
    n_pad, width = db.shape[0], db.shape[1] * (2 if i4 else 1)
    qp = pad_queries_to(q, width).contiguous()
    kw = dict(bin_size=bs, int4_packed=i4)
    carries = prk.fused_scan(qp, db, bias, scale, k_scan=ks, **kw)
    splits = carries[0].shape[0]
    flat = carries[0].permute(1, 0, 2).reshape(m, splits * ks).contiguous()
    t = dict(
        fused=cuda_ms(lambda: prk.fused_scan(qp, db, bias, scale, k_scan=ks, **kw)),
        merge=queued_ms(lambda: prk.fused_carry_merge(*carries)),
        packed=cuda_ms(lambda: prk.partial_reduce_packed(q, db, bias, scale, **kw)),
        fused_plain=cuda_ms(lambda: prk.partial_reduce_fused_plain(
            qp, db, bias, scale, k_scan=ks, **kw), reps=3),
        merge_plain=queued_ms(lambda: prk.fused_carry_merge_plain(*carries)),
        packed_plain=cuda_ms(lambda: prk.partial_reduce_packed_plain(
            qp, db, bias, scale, **kw), reps=3),
        topk=queued_ms(lambda: torch.topk(flat, ks, dim=1)),
    )
    stored = n_pad * (db.shape[1] * db.element_size() + 4.0
                      + (4.0 if scale is not None else 0.0))
    fb = scan_bounds(form, m, n_pad, pk.d, 4.0 * m * pk.d + stored
                     + 8.0 * splits * m * ks)
    pb = scan_bounds(form, m, n_pad, pk.d, 4.0 * m * pk.d + stored
                     + 8.0 * m * (n_pad // bs))
    mb = bound_ms(m * ks * splits, 8.0 * (splits + 1) * m * ks)
    fname, mname, pname = names_of(form)
    rows = []
    for name, kind, ms, plain_ms, b, by, lib in (
            (fname, "partial_reduce_fused", t["fused"], t["fused_plain"],
             fb["bound_ms"], fb["bound_by"], None),
            (mname, None, t["merge"], t["merge_plain"], mb[0], mb[1], t["topk"]),
            (pname, "partial_reduce_packed", t["packed"], t["packed_plain"],
             pb["bound_ms"], pb["bound_by"], None)):
        rows.append(dict(
            name=name, shape=label, route="cuda", source=SRC,
            replaces=REPLACES[(kind, form)] if kind else f"{REF}:219",
            launches=counts.get(name, 0), max_abs_err=acc["errs"][name],
            index_agreement=acc["agree"][name] / max(acc["total"][name], 1),
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib,
            splits=splits, bin_size=bs, k_scan=ks))
    log(f"[{label}] fused scan {t['fused']:.3f} ms ({fb['bound_by']} bound "
        f"{fb['bound_ms']:.3f} ms), merge {t['merge']:.4f} ms ({splits} splits; "
        f"torch.topk {t['topk']:.4f}), two-pass {t['packed']:.3f} ms (bound "
        f"{pb['bound_ms']:.3f}); plain fused {t['fused_plain']:.3f}, plain "
        f"two-pass {t['packed_plain']:.3f} ms; on {smi}")
    return rows


def phase_loop(prk, testing, data, out, smi):
    """Phase 18a: ``stream=False`` at the Sift1M shape, f32 and int8: one
    dispatch and 2 launches a ``query_block`` and no plain call, the
    result bit-equal to the one-call search (else, with the reason
    logged, the tie-aware helper), both timed; then ``explain(m,
    validate_hlo=True)`` at M=16 and M=10,000 within 1%."""
    from repro_torch.search import DISPATCH_COUNTS, Index
    from repro_torch.testing import assert_topk_close, public_scorer

    db, q = data[:2]
    for storage in ("f32", "int8"):
        kw = dict(metric="l2", k=K, recall_target=TARGET, cluster="off",
                  storage=storage)
        one = Index.build(db, **kw)
        loop = Index.build(db, stream=False, **kw)
        qb = loop.spec.query_block
        want = one.search(q)
        loop.search(q[:qb])
        torch.cuda.synchronize()
        DISPATCH_COUNTS.clear()
        prk.reset_counts()
        got = loop.search(q)
        torch.cuda.synchronize()
        blocks = -(-q.shape[0] // qb)
        launches, plain = sum(prk.LAUNCHES.values()), dict(prk.PLAIN_CALLS)
        if dict(DISPATCH_COUNTS) != {"cuda": blocks} or launches != 2 * blocks \
                or plain:
            fail(f"stream=False {storage}: dispatches {dict(DISPATCH_COUNTS)}, "
                 f"launches {launches}, plain {plain}; want {blocks} blocks")
        bit_equal = bool(torch.equal(got.values, want.values)
                         and torch.equal(got.indices, want.indices))
        if not bit_equal:
            log(f"[loop {storage}] not bit-equal to the one call (the split "
                f"plan differs by M); held to the tie-aware helper")
            assert_topk_close(want.values.cpu(), want.indices.cpu(),
                              got.values.cpu(), got.indices.cpu(),
                              score=public_scorer("l2", q, db))
        one_ms = cuda_ms(lambda: one.search(q), reps=3)
        loop_ms = cuda_ms(lambda: loop.search(q), reps=3)
        hlo = {}
        for m in (16, q.shape[0]):
            h = one.explain(m=m, validate_hlo=True)["hlo"]
            if not abs(h["flops_ratio"] - 1.0) < 0.01:
                fail(f"validate_hlo {storage} m={m}: flops_ratio "
                     f"{h['flops_ratio']}")
            hlo[m] = {key: h[key] for key in ("flops_ratio", "split_passes",
                                              "hlo_dot_flops", "model_flops")}
        log(f"[loop {storage}] M={q.shape[0]}, query_block {qb}: {blocks} "
            f"dispatches, {launches} launches, no plain call, bit-equal "
            f"{bit_equal}; one call {one_ms:.3f} ms, loop {loop_ms:.3f} ms; "
            f"validate_hlo flops_ratio {hlo[16]['flops_ratio']:.6f} (M=16), "
            f"{hlo[q.shape[0]]['flops_ratio']:.6f} (M={q.shape[0]}), split "
            f"passes {hlo[16]['split_passes']}; on {smi}")
        out[f"loop {storage}"] = dict(query_block=qb, blocks=blocks,
                                      launches=launches, bit_equal=bit_equal,
                                      one_call_ms=one_ms, loop_ms=loop_ms,
                                      hlo=hlo)
        del one, loop


def phase_shards(prk, testing, data, out, smi, results):
    """Phase 18b: the Sift1M index on 4 logical shards of cuda:0, f32,
    int8 and int4 (the path's counts from 0 just before its searches,
    read just after): 2 launches a shard, recall at E[recall] - eps,
    bit-equal to the per-shard composition; each shard's kernels against
    their plain versions; a (2, 2) mesh with ``batch_axis`` bit-equal to
    2 shards; add 10,000 / delete 50,000 (growth) with recall and no
    deleted id; times beside the unsharded index's, and the kernel rows
    at the shard's shape."""
    from repro_torch.search import Index, merge_topk

    db, q, extra, dead = data
    n = db.shape[0]
    mesh = logical_mesh((SHARDS,), ("model",))
    kernels = []
    acc = {key: {name: (0.0 if key == "errs" else 0)
                 for form in FORMS for name in names_of(form)}
           for key in ("errs", "agree", "total")}
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    truth = exact_topk("l2", q, db, live, K)
    rows_after = torch.cat([db, extra])
    live_after = torch.ones(rows_after.shape[0], dtype=torch.bool, device="cuda")
    live_after[dead] = False
    truth_after = exact_topk("l2", q, rows_after, live_after, K)
    for storage in ("f32", "int8", "int4"):
        kw = dict(metric="l2", k=K, recall_target=TARGET, cluster="off",
                  storage=storage)
        base = Index.build(db, **kw)
        sh = base.shard(mesh)
        q16 = q[:16]
        sh.search(q16)  # the kernels are built: launches only from here
        torch.cuda.synchronize()
        prk.reset_counts()
        v, i = launches_of(lambda: sh.search(q), 2 * SHARDS, f"sharded {storage}")
        v16, i16 = launches_of(lambda: sh.search(q16), 2 * SHARDS,
                               f"sharded {storage} M=16")
        torch.cuda.synchronize()
        read_counts(prk, f"phase 18 sharded {storage}", (storage,), results,
                    two_pass=False)
        counts = dict(prk.LAUNCHES)
        r = recall(i, truth)
        floor = sh.expected_recall - hoeffding_eps(q.shape[0])
        if not r >= floor:
            fail(f"sharded {storage}: recall {r} < {floor}")
        if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], K):
            fail(f"sharded {storage}: non-finite or misshapen values")
        # the composition: each shard's rows searched alone (recall
        # against the global N), offset, merged in shard order
        n_local, parts_v, parts_i = n // SHARDS, [], []
        for j in range(SHARDS):
            part = Index.build(db[j * n_local:(j + 1) * n_local],
                               reduction_input_size_override=n, **kw)
            pv, pi = part.search(q)
            parts_v.append(-pv)
            parts_i.append(torch.where(pi >= 0, pi + j * n_local, pi).int())
            del part
        mv, mi = merge_topk(torch.cat(parts_v, 1), torch.cat(parts_i, 1), K)
        if not (torch.equal(-mv, v) and torch.equal(mi, i)):
            fail(f"sharded {storage}: not bit-equal to the per-shard composition")
        pk = sh.pack()
        for j, shard in enumerate(pk.shards):
            qj = q if j == 0 else q16
            compare_kernels(prk, testing, f"shard {j} of {SHARDS} {storage} "
                            f"M={qj.shape[0]}", qj, shard.db, shard.bias,
                            shard.bin_size, sh.k_scan, acc, scale=shard.scale,
                            int4_packed=shard.int4_packed)
        batch_equal = None
        if storage == "f32":
            two = base.shard(logical_mesh((2, 2), ("data", "model")),
                             batch_axis="data")
            one = base.shard(logical_mesh((2,), ("model",)))
            a, b = two.search(q), one.search(q)
            batch_equal = bool(torch.equal(a.values, b.values)
                               and torch.equal(a.indices, b.indices))
            if not batch_equal:
                fail("the (2, 2) mesh with batch_axis differs from 2 shards")
            del two, one
        t = dict(
            sharded_ms=cuda_ms(lambda: sh.search(q), reps=3),
            unsharded_ms=cuda_ms(lambda: base.search(q), reps=3),
            sharded_m16_ms=cuda_ms(lambda: sh.search(q16)),
            unsharded_m16_ms=cuda_ms(lambda: base.search(q16)),
            sharded_m16_queued_ms=queued_ms(lambda: sh.search(q16), reps=20),
            unsharded_m16_queued_ms=queued_ms(lambda: base.search(q16), reps=20),
        )
        kernels += shard_kernel_rows(
            prk, testing, f"shard of {SHARDS} sift1m {storage} M={q.shape[0]}",
            q, pk.shards[0], sh.k_scan, counts, smi, acc)
        kernels += shard_kernel_rows(
            prk, testing, f"shard of {SHARDS} sift1m {storage} M=16",
            q16, pk.shards[0], sh.k_scan, counts, smi, acc)
        sh.add(extra)
        sh.delete(dead)
        v2, i2 = sh.search(q)
        if torch.isin(i2.long(), dead).any():
            fail(f"sharded {storage}: a deleted id came back")
        r2 = recall(i2, truth_after)
        floor2 = sh.expected_recall - hoeffding_eps(q.shape[0])
        if not r2 >= floor2 or sh.size != n + 10_000 - 50_000:
            fail(f"sharded {storage} after updates: recall {r2} < {floor2} or "
                 f"size {sh.size}")
        # C7: the h100 plan of shards that share the card prices them one
        # after another, so the share of the bound reached is the
        # unsharded index's within 20%
        fractions = [ix.explain(m=q.shape[0], measure=True)["measured"][
            "roofline_fraction"] for ix in (sh, base)]
        fraction_ratio = fractions[0] / fractions[1]
        if storage == "f32" and not 0.8 <= fraction_ratio <= 1.2:
            fail(f"sharded {storage}: explain(measure=True) roofline_fraction "
                 f"{fractions[0]:.4f} not within 20% of the unsharded "
                 f"{fractions[1]:.4f}")
        plan = sh._replan(n=sh.capacity, m=q.shape[0], pin_from=sh.kernel_plan)
        base_plan = base._replan(n=base.capacity, m=q.shape[0],
                                 pin_from=base.kernel_plan)
        log(f"[sharded {storage}] {SHARDS} logical shards of {n_local} rows "
            f"(bins of {pk.shards[0].bin_size}, k_scan {sh.k_scan}): M="
            f"{q.shape[0]} recall {r:.4f} (floor {floor:.4f}), 2 launches a "
            f"shard, bit-equal to the per-shard composition"
            + (f", (2, 2) batch_axis = 2 shards" if batch_equal else "")
            + f"; after add/delete capacity {sh.capacity}, recall {r2:.4f}; "
            f"M={q.shape[0]} sharded {t['sharded_ms']:.3f} ms vs unsharded "
            f"{t['unsharded_ms']:.3f} ms; M=16 {t['sharded_m16_ms']:.3f} vs "
            f"{t['unsharded_m16_ms']:.3f} ms (queued {t['sharded_m16_queued_ms']:.3f}"
            f" vs {t['unsharded_m16_queued_ms']:.3f}); plan: {plan.db_shards} "
            f"shards ({plan.shards_per_device} on the busiest device, "
            f"{plan.db_devices} device), predicted {1e3 * plan.predicted_s:.3f} "
            f"ms of which gather {1e3 * plan.ici_s:.5f} ms at M={q.shape[0]} "
            f"(unsharded {1e3 * base_plan.predicted_s:.3f} ms); explain("
            f"measure=True) roofline_fraction sharded {fractions[0]:.4f}, "
            f"unsharded {fractions[1]:.4f} (ratio {fraction_ratio:.4f}); on {smi}")
        out[f"sharded {storage}"] = dict(
            recall=r, recall_after_updates=r2, expected_recall=sh.expected_recall,
            capacity_after=sh.capacity, shard_bin_size=pk.shards[0].bin_size,
            k_scan=sh.k_scan, batch_axis_equal=batch_equal, launches=counts,
            predicted_ms=1e3 * plan.predicted_s, ici_ms=1e3 * plan.ici_s,
            unsharded_predicted_ms=1e3 * base_plan.predicted_s,
            roofline_fraction=fractions[0],
            unsharded_roofline_fraction=fractions[1], **t)
        del base, sh, pk
        torch.cuda.empty_cache()
    return kernels


def phase_shard_datastore(prk, seed, out, smi):
    """Phase 18c: a ``KNNDatastore`` of 2^19 Gaussian keys at D=2048 over
    2 logical shards (4 launches a lookup, no plain call), its recall at
    E[recall] - eps against an exact oracle, and a served lookup (eager)
    bit-equal to a direct one."""
    from repro_torch.retrieval.datastore import KNNDatastore
    from repro_torch.search import ServeConfig

    c = SHARD_DS
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    keys = torch.randn((c["n"], c["d"]), generator=g, device="cuda")
    toks = torch.randint(0, 92_544, (c["n"],), generator=g, device="cuda")
    q = torch.randn((c["queries"], c["d"]), generator=g, device="cuda")
    t0 = time.perf_counter()
    ds = KNNDatastore(keys, toks, logical_mesh((1, c["shards"]), ("data", "model")),
                      k=c["k"], cluster="off")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ds.lookup(q[:8])
    torch.cuda.synchronize()
    prk.reset_counts()
    v, i = launches_of(lambda: ds.index.search(q), 2 * c["shards"], "sharded datastore")
    if prk.PLAIN_CALLS:
        fail(f"sharded datastore: plain calls {dict(prk.PLAIN_CALLS)}")
    vals, got_toks = ds.lookup(q)
    if not (torch.equal(vals, v) and torch.equal(got_toks, toks[i.long()])):
        fail("sharded datastore: lookup differs from the index's search")
    truth = exact_topk("mips", q, keys, ds.index._live, c["k"], chunk=256)
    r = recall(i, truth)
    floor = ds.index.expected_recall - hoeffding_eps(q.shape[0])
    if not r >= floor:
        fail(f"sharded datastore: recall {r} < {floor}")
    ds.attach_server(config=ServeConfig(max_batch=64))
    served = ds.lookup(q[:16])
    direct = ds.index.search(q[:16])
    ds.server.close()
    if not (torch.equal(served[0], direct.values)
            and torch.equal(served[1], toks[direct.indices.long()])):
        fail("sharded datastore: a served lookup differs from a direct one")
    ms = cuda_ms(lambda: ds.index.search(q), reps=3)
    log(f"[sharded datastore] 2^19 x {c['d']} over {c['shards']} logical "
        f"shards: build {build_s:.2f} s, M={q.shape[0]} recall {r:.4f} (floor "
        f"{floor:.4f}), served = direct, lookup {ms:.3f} ms; on {smi}")
    out["sharded datastore"] = dict(build_s=build_s, recall=r, floor=floor,
                                    lookup_ms=ms)
    del ds, keys, toks, q
    torch.cuda.empty_cache()


def phase_cp_attention(seed, out, smi):
    """Phase 18d: ``_knn_decode_attention_cp`` over 4 context-parallel
    logical shards at internlm2-1.8b's decode shape against the unsharded
    ``knn_decode_attention``: its selected positions at E[recall] - eps
    against the exact top-k (phase 16's check), its output equal to the
    softmax over them, and beside the unsharded output."""
    from repro_torch.core.binning import plan_bins
    from repro_torch.core.rescoring import stable_topk
    from repro_torch.models import attention as attn

    c = CP_ATTN
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    b, s, h, kv, hd = c["batch"], c["seq"], c["heads"], c["kv_heads"], c["head_dim"]
    q = torch.randn((b, h, hd), generator=g, device="cuda").bfloat16()
    keys = torch.randn((b, s, kv, hd), generator=g, device="cuda").bfloat16()
    values = torch.randn((b, s, kv, hd), generator=g, device="cuda").bfloat16()
    valid = torch.arange(s, device="cuda") < c["live"]
    mesh = logical_mesh((SHARDS,), ("model",))
    kw = dict(k=c["k"], recall_target=0.95, kv_groups=h // kv)
    got = attn._knn_decode_attention_cp(q, keys, values, valid, mesh=mesh,
                                        cp_axes=("model",), **kw)
    whole = attn.knn_decode_attention(q, keys, values, valid, **kw)
    vals, pos, _ = attn._knn_cp_candidates(q, keys, values, valid, mesh=mesh,
                                           cp_axes=("model",), **kw)
    _, sel = stable_topk(vals, c["k"])
    chosen = torch.gather(pos, 2, sel)
    scores = attn._group_scores(q, keys, h // kv) * attn._const(hd ** -0.5, q)
    scores = torch.where(valid, scores, attn._const(attn._NEG_INF, scores))
    exact = torch.topk(scores.float(), c["k"], dim=-1).indices
    r = float((chosen[..., :, None] == exact[..., None, :]).any(-1).float().mean())
    floor = plan_bins(s // SHARDS, c["k"], 0.95,
                      reduction_input_size_override=s).expected_recall \
        - hoeffding_eps(b * h)
    if not r >= floor:
        fail(f"context-parallel attention: recall {r} < {floor}")
    if not (torch.isfinite(got.float()).all() and got.shape == whole.shape):
        fail("context-parallel attention: non-finite or misshapen output")
    diff = float((got.float() - whole.float()).abs().max())
    ms = cuda_ms(lambda: attn._knn_decode_attention_cp(
        q, keys, values, valid, mesh=mesh, cp_axes=("model",), **kw))
    whole_ms = cuda_ms(lambda: attn.knn_decode_attention(q, keys, values, valid,
                                                         **kw))
    log(f"[cp attention] B={b} S={s} H={h} KV={kv} hd={hd} k={c['k']} over "
        f"{SHARDS} shards: recall {r:.4f} (floor {floor:.4f}), max |diff| vs "
        f"unsharded {diff:.4g}; {ms:.3f} ms vs unsharded {whole_ms:.3f} ms; "
        f"on {smi}")
    out["cp attention"] = dict(recall=r, floor=floor, max_abs_diff=diff, ms=ms,
                               unsharded_ms=whole_ms)


def phase_sharding(prk, testing, seed, results, smi):
    """Phase 18: the rest of the search package and sharding (see the
    module docstring); returns its report and its kernel rows."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    data = make_data(SIFT, seed)
    phase_loop(prk, testing, data, out, smi)
    kernels = phase_shards(prk, testing, data, out, smi, results)
    del data
    torch.cuda.empty_cache()
    phase_shard_datastore(prk, seed, out, smi)
    phase_cp_attention(seed, out, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 18] {out['seconds']:.1f} s")
    return out, kernels


# --- phase 19: training -------------------------------------------------------

TRAIN_LR = 3e-3  # phase 19b's steps, as the reference's loss-decrease test
# phase 19b: the card's first-step loss and grad_norm against the CPU's,
# relative; the largest spreads measured over the ten smoke configs were
# 1.64e-5 and 2.56e-4 (H100 80GB HBM3, 700 W)
TRAIN_PARITY_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
FULL_TRAIN = dict(arch="internlm2-1.8b", batch=4, seq=2048)


def phase_registry(prk, seed, results, smi):
    """Phase 19a: the kNN workload registry at full N.  Each workload's
    vectors from ``make_vector_dataset`` (its corpus and its M queries
    drawn as one set, so they share the clusters), ``Index.build(...,
    cluster="off")`` on the card; the index's bins and ``k_scan`` equal
    ``KNN_WORKLOADS[name].plan()``'s; a search at M=10,000 (the path's
    counts from 0 just before it, read just after: the fused scan and
    the merge, no plain version) at E[recall] - eps against the exact
    oracle, and timed."""
    from repro_torch.configs import KNN_WORKLOADS
    from repro_torch.data.pipeline import make_vector_dataset
    from repro_torch.search import Index

    out = {}
    for i, name in enumerate(("sift1m", "glove1.2m")):
        kc = KNN_WORKLOADS[name]
        t0 = time.perf_counter()
        rows = make_vector_dataset(kc.n + kc.m, kc.d, seed=seed + i,
                                   metric=kc.metric)
        db = torch.from_numpy(rows[: kc.n]).cuda()
        q = torch.from_numpy(rows[kc.n :]).cuda()
        del rows
        data_s = time.perf_counter() - t0
        index = Index.build(db, metric=kc.metric, k=kc.k,
                            recall_target=kc.recall_target, cluster="off")
        plan, kp = kc.plan(), index.kernel_plan
        got = (kp.num_bins, kp.bin_size, kp.k_scan, kp.device, kp.backend)
        want = (plan.num_bins, plan.bin_size, plan.k_scan, plan.device,
                plan.backend)
        if got != want:
            fail(f"registry {name}: the index's plan {got} is not the "
                 f"registry's {want}")
        index.search(q[:16])  # the kernels are built: launches only from here
        torch.cuda.synchronize()
        prk.reset_counts()
        v, idx = index.search(q)
        torch.cuda.synchronize()
        read_counts(prk, f"phase 19 registry {name}", ("f32",), results,
                    two_pass=False)
        live = torch.ones(kc.n, dtype=torch.bool, device="cuda")
        r = recall(idx, exact_topk(kc.metric, q, db, live, kc.k))
        floor = index.expected_recall - hoeffding_eps(kc.m)
        if not r >= floor:
            fail(f"registry {name}: recall {r} < {floor}")
        if not torch.isfinite(v).all() or tuple(v.shape) != (kc.m, kc.k):
            fail(f"registry {name}: non-finite or misshapen values")
        ms = cuda_ms(lambda: index.search(q), reps=3)
        log(f"[registry {name}] N={kc.n} d={kc.d} {kc.metric}, "
            f"make_vector_dataset {data_s:.1f} s; plan = registry's (bins "
            f"{kp.num_bins} of {kp.bin_size}, k_scan {kp.k_scan}, predicted "
            f"{1e3 * plan.predicted_s:.3f} ms at M={kc.m}); M={kc.m} recall "
            f"{r:.4f} (floor {floor:.4f}), search {ms:.3f} ms; on {smi}")
        out[name] = dict(n=kc.n, d=kc.d, metric=kc.metric, num_bins=kp.num_bins,
                         bin_size=kp.bin_size, k_scan=kp.k_scan, recall=r,
                         recall_floor=floor, search_ms=ms,
                         predicted_ms=1e3 * plan.predicted_s,
                         cops_per_dot=kc.cops_per_dot)
        del index, db, q
        torch.cuda.empty_cache()
    return out


def phase_train_smoke(seed, smi):
    """Phase 19b: each of the ten smoke configs as shipped (bf16 compute,
    f32 masters, ``remat="dots"``) trains 5 steps on the card at lr 3e-3
    over ``SyntheticTokenSource`` batches of 4 x 64: loss and grad_norm
    finite, the last loss below the first; the first step's loss and
    grad_norm within ``TRAIN_PARITY_RTOL`` of the port's CPU step on the
    same weights and batch; the state after the steps saved with
    ``AsyncCheckpointer`` and restored onto the card bit for bit
    (parameters, moments, step)."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.configs import get_config, list_configs
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch.train import to_device
    from repro_torch.models import model as M

    out = {}
    dev = torch.device("cuda")
    for name in sorted(n for n in list_configs() if n.endswith("-smoke")):
        t0 = time.perf_counter()
        cfg = get_config(name)
        state = M.init_train_state(torch.Generator(device=dev).manual_seed(seed),
                                   cfg, device=dev)
        src = SyntheticTokenSource(
            cfg.vocab_size, 64, 4, seed=seed,
            input_mode=cfg.input_mode if not cfg.is_encoder_decoder else "tokens",
            d_model=cfg.d_model,
            enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
            mrope=cfg.mrope)
        step = M.make_train_step(cfg, learning_rate=TRAIN_LR)
        cpu = M.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                 device="cpu")
        cpu.params.load_state_dict({k: v.detach().cpu()
                                    for k, v in state.params.state_dict().items()})
        _, cpu_metrics = step(cpu, to_device(src.batch(0), torch.device("cpu")))
        cpu_loss = float(cpu_metrics["loss"])
        cpu_norm = float(cpu_metrics["grad_norm"])
        del cpu
        losses, norms = [], []
        for i in range(5):
            state, metrics = step(state, to_device(src.batch(i), dev))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f"train {name}: non-finite loss or grad_norm {losses} {norms}")
        if not losses[-1] < losses[0]:
            fail(f"train {name}: the loss did not fall over 5 steps: {losses}")
        rel = {"loss": abs(losses[0] - cpu_loss) / abs(cpu_loss),
               "grad_norm": abs(norms[0] - cpu_norm) / abs(cpu_norm)}
        for key, err in rel.items():
            if not err <= TRAIN_PARITY_RTOL[key]:
                fail(f"train {name}: the card's first-step {key} differs from "
                     f"the CPU's by {err:.3e} relative (limit "
                     f"{TRAIN_PARITY_RTOL[key]}): {losses[0]}/{norms[0]} against "
                     f"{cpu_loss}/{cpu_norm}")
        with tempfile.TemporaryDirectory() as d:
            writer = AsyncCheckpointer(d)
            writer.save(5, state)
            writer.wait()
            like = M.init_train_state(
                torch.Generator(device=dev).manual_seed(seed + 1), cfg, device=dev)
            restored, at = restore_checkpoint(d, like)
        same = (at == 5 and int(restored.step) == int(state.step) == 5
                and all(torch.equal(a, b) for a, b in zip(
                    restored.params.parameters(), state.params.parameters()))
                and all(torch.equal(restored.opt_state.m[k], state.opt_state.m[k])
                        and torch.equal(restored.opt_state.v[k], state.opt_state.v[k])
                        for k in state.opt_state.m))
        if not same:
            fail(f"train {name}: the checkpoint restored onto the card differs")
        secs = time.perf_counter() - t0
        log(f"[train {name}] losses {[round(x, 4) for x in losses]}, grad_norm "
            f"{[round(x, 4) for x in norms]}, first step vs CPU: loss "
            f"{losses[0]:.6f} / {cpu_loss:.6f} (rel {rel['loss']:.3e}), "
            f"grad_norm {norms[0]:.6f} / {cpu_norm:.6f} (rel "
            f"{rel['grad_norm']:.3e}), checkpoint restored bit-equal, "
            f"{secs:.1f} s")
        out[name] = dict(losses=losses, grad_norms=norms, cpu_loss=cpu_loss,
                         cpu_grad_norm=cpu_norm, rel_err=rel,
                         checkpoint_equal=same, seconds=secs)
        del state, like, restored
    torch.cuda.empty_cache()
    return out


def _timed_steps(step, state, batches):
    """CUDA-event ms of each step over ``batches``, and the last state and
    metrics."""
    times = []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, state, metrics


def phase_train_full(seed, smi):
    """Phase 19c: internlm2-1.8b at full width (24 layers, d 2048, vocab
    92,544): f32 masters on the card, bf16 compute, ``remat="dots"``,
    synthetic tokens, batch 4 x seq 2,048.  2 warm steps, then 5 timed
    (CUDA events; loss and grad_norm finite); ms a step and tokens/s
    beside ``model_flops`` over the ``"h100"`` profile's bf16 peak; the
    peak of ``torch.cuda.max_memory_allocated`` over the timed steps
    beside the state's 16 bytes a parameter; then 2 steps with
    ``microbatches=2``, whose peak must be lower."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.roofline import HARDWARE
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch.dryrun import ideal_memory_bytes, model_flops
    from repro_torch.launch.train import to_device
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(FULL_TRAIN["arch"])
    b, s = FULL_TRAIN["batch"], FULL_TRAIN["seq"]
    if (cfg.remat, cfg.dtype) != ("dots", "bfloat16"):
        fail(f"{cfg.name}: remat {cfg.remat}, dtype {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = M.init_train_state(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    state_bytes = 16 * n_params  # f32 params, grads, m and v
    src = SyntheticTokenSource(cfg.vocab_size, s, b, seed=seed)
    batches = [to_device(src.batch(i), dev) for i in range(7)]
    step = M.make_train_step(cfg, learning_rate=3e-4)
    warm, state, _ = _timed_steps(step, state, batches[:2])
    torch.cuda.reset_peak_memory_stats()
    times, state, metrics = _timed_steps(step, state, batches[2:])
    peak1 = torch.cuda.max_memory_allocated()
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        fail(f"{cfg.name} training: loss {loss}, grad_norm {gnorm}")
    ms = median(times)
    shape = ShapeConfig("train", s, b, "train")
    flops = model_flops(cfg, shape)
    peak_flops = HARDWARE["h100"].peak_flops
    bound = 1e3 * flops / peak_flops
    step2 = M.make_train_step(cfg, learning_rate=3e-4, microbatches=2)
    torch.cuda.reset_peak_memory_stats()
    times2, state, metrics2 = _timed_steps(step2, state, batches[:2])
    peak2 = torch.cuda.max_memory_allocated()
    if not math.isfinite(float(metrics2["loss"])):
        fail(f"{cfg.name} training with 2 microbatches: non-finite loss")
    if not peak2 < peak1:
        fail(f"{cfg.name}: peak memory with 2 microbatches {peak2} is not "
             f"below one batch's {peak1}")
    out = dict(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params, batch=b, seq=s,
        init_s=init_s, warm_ms=warm, step_ms=times, median_step_ms=ms,
        tokens_per_s=b * s / (ms / 1e3), model_flops=flops,
        bound_ms=bound, bound_share=bound / ms,
        ideal_memory_bytes=ideal_memory_bytes(cfg, shape),
        peak_bytes=peak1, state_bytes=state_bytes,
        microbatches2_step_ms=times2, microbatches2_peak_bytes=peak2,
        loss=loss, grad_norm=gnorm)
    del state, batches
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[train {cfg.name}] {n_params / 1e9:.3f} B parameters, init "
        f"{init_s:.1f} s; batch {b} x seq {s}, bf16 compute, remat "
        f"{cfg.remat}: step {ms:.1f} ms (timed {[round(x, 1) for x in times]}, "
        f"warm {[round(x, 1) for x in warm]}), {out['tokens_per_s']:.0f} "
        f"tokens/s; model_flops {flops:.4e} -> bound {bound:.1f} ms at "
        f"{peak_flops / 1e12:.1f} TFLOP/s bf16, share {bound / ms:.4f}; peak "
        f"memory {peak1 / 1e9:.2f} GB beside the state's {state_bytes / 1e9:.2f} "
        f"GB (16 B a parameter); microbatches=2: peak {peak2 / 1e9:.2f} GB, "
        f"steps {[round(x, 1) for x in times2]} ms; loss {loss:.4f}, grad_norm "
        f"{gnorm:.4f}; {out['seconds']:.1f} s; on {smi}")
    return out


def phase_training(prk, seed, results, smi):
    """Phase 19: the registry, the smoke families' training and
    internlm2-1.8b's at full width; returns its report."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"registry": phase_registry(prk, seed, results, smi)}
    prk.reset_counts()
    out["smoke"] = phase_train_smoke(seed, smi)
    out["full"] = phase_train_full(seed, smi)
    # training runs no kernel of the port's: no launch, no plain version
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        fail(f"phase 19 training launched {dict(prk.LAUNCHES)}, plain calls "
             f"{dict(prk.PLAIN_CALLS)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 19] {out['seconds']:.1f} s")
    return out


# --- phase 20: the mesh rules and the dry run ------------------------------------

CP_DECODE = dict(arch="internlm2-1.8b", seq=524_288, batch=1)
# phase 20a: the context-parallel step's logits beside the unsharded kNN
# step's, relative to the largest |logit| (a sanity bound set before the
# first run: both select ~k of S keys a head, from bins of other sizes)
CP_LOGIT_REL = 0.1


def _cp_caches(cfg, seq, batch, seed):
    """Random bf16 KV caches of every layer at ``seq`` positions, the
    largest power of two from ``seq`` down that fits beside a 4 GB
    margin."""
    from repro_torch.models import attention as attn

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = lambda s: (batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    while True:
        need = 2 * cfg.num_layers * math.prod(shape(seq)) * 2
        if need + 4e9 < torch.cuda.mem_get_info()[0]:
            break
        seq //= 2
    return seq, [attn.KVCache(
        k=torch.randn(shape(seq), generator=g, device="cuda", dtype=torch.bfloat16),
        v=torch.randn(shape(seq), generator=g, device="cuda", dtype=torch.bfloat16))
        for _ in range(cfg.num_layers)]


def phase_cp_decode(seed, smi):
    """Phase 20a: internlm2-1.8b's kNN decode step (greedy) at full width
    over random bf16 caches of the long_500k length (written at the last
    position, every position live), under ``use_mesh`` of a logical
    (1, 4) mesh with ``cell_rules(cfg, long_500k, mesh)``: every layer
    through ``_knn_decode_attention_cp`` over ("model",), layer 0's
    recall against the exact top-k at phase 18d's floor; the unsharded
    kNN step on the same caches: logits within ``CP_LOGIT_REL`` of the
    largest |logit|, greedy tokens compared; both steps timed (median of
    3) beside the dry run's count of the cell."""
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.core.binning import plan_bins
    from repro_torch.core.rescoring import stable_topk
    from repro_torch.launch.dryrun import count_cell, roofline
    from repro_torch.launch.shardspecs import cell_rules
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    from repro_torch.parallel import use_mesh

    torch.cuda.empty_cache()
    cfg, model, _, weight_bytes = init_full(CP_DECODE["arch"], seed)
    b = CP_DECODE["batch"]
    seq, caches = _cp_caches(cfg, CP_DECODE["seq"], b, seed + 20)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
    pos = seq - 1
    mesh = logical_mesh((1, SHARDS), ("data", "model"))
    rules = cell_rules(cfg, SHAPES["long_500k"], mesh)
    step = M.make_decode_step(cfg, use_knn=True, sample="greedy")
    calls, records = [], []
    real = attn._knn_decode_attention_cp

    def spy(q, keys, values, valid, **kw):
        calls.append(tuple(kw["cp_axes"]))
        if not records:
            records.append((q, keys, values, valid, kw))
        return real(q, keys, values, valid, **kw)

    def cp_step():
        with use_mesh(mesh, rules=rules):
            return step(model, tokens, caches, pos, None)
    attn._knn_decode_attention_cp = spy
    try:
        _, (cp_tok, cp_logits, _) = timed_ms(cp_step)
    finally:
        attn._knn_decode_attention_cp = real
    if calls != [("model",)] * cfg.num_layers:
        fail(f"context-parallel decode: {len(calls)} calls of "
             f"_knn_decode_attention_cp over {set(calls)}, want {cfg.num_layers} "
             f"over ('model',)")
    q, keys, values, valid, kw = records[0]
    h, hd, k = q.shape[1], q.shape[-1], kw["k"]
    vals, cpos, _ = attn._knn_cp_candidates(q, keys, values, valid, **kw)
    _, sel = stable_topk(vals, k)
    chosen = torch.gather(cpos, 2, sel)
    scores = attn._group_scores(q, keys, kw["kv_groups"]) * attn._const(hd ** -0.5, q)
    exact = torch.topk(scores.float(), k, dim=-1).indices
    r = float((chosen[..., :, None] == exact[..., None, :]).any(-1).float().mean())
    floor = plan_bins(seq // SHARDS, k, kw["recall_target"],
                      reduction_input_size_override=seq).expected_recall \
        - hoeffding_eps(b * h)
    del records, q, keys, values, valid, vals, cpos, scores
    if not r >= floor:
        fail(f"context-parallel decode: layer 0 recall {r} < {floor}")
    _, (tok, logits, _) = timed_ms(lambda: step(model, tokens, caches, pos, None))
    if not (torch.isfinite(cp_logits.float()).all() and cp_logits.shape == logits.shape):
        fail("context-parallel decode: non-finite or misshapen logits")
    diff = float((cp_logits.float() - logits.float()).abs().max())
    top = float(logits.float().abs().max())
    if not diff <= CP_LOGIT_REL * top:
        fail(f"context-parallel decode: logits differ by {diff} (largest |logit| "
             f"{top}) from the unsharded kNN step")
    top1 = bool(torch.equal(cp_tok, tok))
    cp_ms = median([timed_ms(cp_step)[0] for _ in range(3)])
    ms = median([timed_ms(lambda: step(model, tokens, caches, pos, None))[0]
                 for _ in range(3)])
    shape = ShapeConfig("long_500k", seq, b, "decode")
    t0 = time.perf_counter()
    cost = count_cell(cfg, shape, make_meta_mesh())
    count_s = time.perf_counter() - t0
    roof = roofline(cfg, shape, cost, 0.0)
    log(f"[cp decode] {cfg.name} kNN decode (greedy) over a {seq}-position "
        f"cache ({cache_bytes / 1e9:.2f} GB bf16 KV beside {weight_bytes / 1e9:.2f} "
        f"GB of weights), logical (1, {SHARDS}) mesh with long_500k's rules: "
        f"{len(calls)} layers through _knn_decode_attention_cp over ('model',); "
        f"layer 0 recall {r:.4f} (floor {floor:.4f}, k={k}); logits max |diff| "
        f"vs unsharded {diff:.4g} (largest |logit| {top:.4g}), greedy token "
        f"equal {top1}; step {cp_ms:.3f} ms vs unsharded {ms:.3f} ms; dry run "
        f"(counted in {count_s:.1f} s): memory term {1e3 * roof['memory_s']:.3f} "
        f"ms, ideal {1e3 * roof['ideal_step_s']:.3f} ms, {cost.hbm_bytes:.4e} "
        f"bytes, {cost.dot_flops:.4e} dot FLOPs; on {smi}")
    out = dict(seq=seq, batch=b, cache_bytes=cache_bytes, weight_bytes=weight_bytes,
               cp_calls=len(calls), recall=r, recall_floor=floor, k=k,
               max_abs_diff=diff, max_abs_logit=top, top1_equal=top1,
               cp_step_ms=cp_ms, unsharded_step_ms=ms,
               dryrun=dict(dot_flops=cost.dot_flops, hbm_bytes=cost.hbm_bytes,
                           peak_bytes=cost.peak_bytes, count_s=count_s, **roof))
    del model, caches, cp_logits, logits
    torch.cuda.empty_cache()
    return out


def make_meta_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(1, devices=["meta"])


def phase_model_parallel(smi):
    """Phase 20b: ``launch.train.main`` with ``--model-parallel 2`` on the
    card (one card: a (1, 1) mesh), the losses and the final state
    bit-equal to ``--model-parallel 1``'s, both run with PyTorch's
    deterministic algorithms (the embedding's backward otherwise adds
    with atomics in no fixed order); returns its state for 20c."""
    from repro_torch.launch import train

    args = ["--arch", "internlm2-1.8b-smoke", "--steps", "5", "--seq", "64",
            "--global-batch", "8", "--lr", "3e-3", "--log-every", "1"]
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one = train.main(args + ["--model-parallel", "1"])
        two = train.main(args + ["--model-parallel", "2"])
    finally:
        torch.use_deterministic_algorithms(False)
    same = (one["losses"] == two["losses"] and all(
        torch.equal(p, q) for p, q in zip(one["state"].params.parameters(),
                                          two["state"].params.parameters())))
    if not same or tuple(two["mesh"].shape.values()) != (1, 1):
        fail(f"--model-parallel 2 on {dict(two['mesh'].shape)} is not bit-equal "
             f"to 1: {one['losses']} vs {two['losses']}")
    secs = time.perf_counter() - t0
    log(f"[model parallel] internlm2-1.8b-smoke, 5 steps: --model-parallel 2 on "
        f"a {tuple(two['mesh'].shape.values())} mesh of {two['mesh'].devices.flat[0]} "
        f"bit-equal to 1 (losses {[round(x, 4) for _, x in two['losses']]}); "
        f"{secs:.1f} s; on {smi}")
    return dict(losses=[x for _, x in two["losses"]], bit_equal=same,
                mesh=list(two["mesh"].shape.values()), seconds=secs), two["state"]


def phase_remesh(state, smi):
    """Phase 20c: a CPU copy of 20b's state placed onto a logical (1, 2)
    mesh of the card by ``remesh_state``, and 20b's checkpoint restored
    from disk into a CPU state with ``shardings=`` for that mesh: every
    leaf on ``cuda:0`` and bit-equal to the card's state."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.ft import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWState

    cfg = state.params.cfg
    mesh = logical_mesh((1, 2), ("data", "model"))

    def cpu_state(seed):
        return M.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")

    def equal(a, b):
        pa, pb = dict(a.params.named_parameters()), dict(b.params.named_parameters())
        return int(a.step) == int(b.step) and all(
            pa[n].device == mesh.devices.flat[0] and torch.equal(pa[n], pb[n])
            and torch.equal(a.opt_state.m[n], b.opt_state.m[n])
            and torch.equal(a.opt_state.v[n], b.opt_state.v[n]) for n in pb)
    host = cpu_state(1)
    with torch.no_grad():
        for n, p in host.params.named_parameters():
            p.copy_(state.params.get_parameter(n).cpu())
            host.opt_state.m[n].copy_(state.opt_state.m[n].cpu())
            host.opt_state.v[n].copy_(state.opt_state.v[n].cpu())
    host = host._replace(step=state.step.clone())
    axes = tfm.model_axes(cfg)
    moved = remesh_state(host, M.TrainState(step=(), params=axes, opt_state=AdamWState(
        m=axes, v=axes)), mesh)
    remeshed = equal(moved, state)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, int(state.step), state)
        like = cpu_state(2)
        sh = SS.sanitize_tree(SS.train_state_shardings(cfg, mesh), like, mesh)
        restored, _ = restore_checkpoint(d, like, shardings=sh)
    restored_equal = equal(restored, state)
    if not (remeshed and restored_equal):
        fail(f"remesh_state bit-equal {remeshed}, restore_checkpoint(shardings=) "
             f"bit-equal {restored_equal}")
    log(f"[remesh] {cfg.name}: remesh_state of a CPU copy onto a logical (1, 2) "
        f"mesh of the card and restore_checkpoint(shardings=) from disk: every "
        f"leaf on {mesh.devices.flat[0]}, bit-equal; on {smi}")
    return dict(remesh_equal=remeshed, restore_equal=restored_equal)


def phase_dryrun_train(seed, smi):
    """Phase 20d: ``count_cell`` of phase 19's full-width training shape
    (internlm2-1.8b, batch 4 x 2,048) on fake tensors on the host, then
    the same step on the card: one under ``FlopCounterMode`` (the dot
    FLOPs must equal the count's: the same program), then 3 timed (CUDA
    events) with the peak of ``torch.cuda.max_memory_allocated`` beside
    the count's peak, and the step time beside the dry run's
    ``step_time_s`` and ``ideal_step_s`` on the ``"h100"`` profile."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch.dryrun import count_cell, roofline
    from repro_torch.launch.train import to_device
    from repro_torch.models import model as M

    cfg = get_config(FULL_TRAIN["arch"])
    b, s = FULL_TRAIN["batch"], FULL_TRAIN["seq"]
    shape = ShapeConfig("train", s, b, "train")
    t0 = time.perf_counter()
    cost = count_cell(cfg, shape, make_meta_mesh())
    count_s = time.perf_counter() - t0
    roof = roofline(cfg, shape, cost, 0.0)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    state = M.init_train_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                               device=dev)
    src = SyntheticTokenSource(cfg.vocab_size, s, b, seed=seed)
    batches = [to_device(src.batch(i), dev) for i in range(5)]
    step = M.make_train_step(cfg, learning_rate=3e-4,
                             microbatches=cfg.train_microbatches)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as flops:
        state, _ = step(state, batches[1])
    torch.cuda.synchronize()
    real = float(flops.get_total_flops())
    if real != cost.dot_flops:
        fail(f"{cfg.name} train step: counted {cost.dot_flops} dot FLOPs on fake "
             f"tensors, {real} on the card")
    torch.cuda.reset_peak_memory_stats()
    times, state, metrics = _timed_steps(step, state, batches[2:])
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(float(metrics["loss"])):
        fail(f"{cfg.name} train step: non-finite loss")
    ms = median(times)
    out = dict(arch=cfg.name, batch=b, seq=s, count_s=count_s,
               dot_flops=cost.dot_flops, card_dot_flops=real,
               hbm_bytes=cost.hbm_bytes, hbm_bytes_lo=cost.hbm_bytes_lo,
               hbm_bytes_hi=cost.hbm_bytes_hi, cop_count=cost.cop_count,
               argument_bytes=cost.argument_bytes, counted_peak_bytes=cost.peak_bytes,
               card_peak_bytes=peak, step_ms=times, median_step_ms=ms,
               roofline=roof)
    log(f"[dry run] {cfg.name} train {b} x {s}: counted on fake tensors in "
        f"{count_s:.1f} s: {cost.dot_flops:.6e} dot FLOPs (the card's step under "
        f"FlopCounterMode: {real:.6e}, equal), {cost.hbm_bytes:.4e} bytes "
        f"({cost.hbm_bytes_lo:.4e}..{cost.hbm_bytes_hi:.4e}), {cost.cop_count:.4e} "
        f"COPs; peak {cost.peak_bytes / 1e9:.2f} GB counted vs "
        f"{peak / 1e9:.2f} GB max_memory_allocated; roofline on h100: compute "
        f"{1e3 * roof['compute_s']:.1f} ms, memory {1e3 * roof['memory_s']:.1f} ms, "
        f"instruction {1e3 * roof['instruction_s']:.1f} ms -> step_time_s "
        f"{1e3 * roof['step_time_s']:.1f} ms ({roof['dominant']}), ideal "
        f"{1e3 * roof['ideal_step_s']:.1f} ms; measured {ms:.1f} ms (timed "
        f"{[round(x, 1) for x in times]}): {roof['step_time_s'] * 1e3 / ms:.4f} "
        f"of the counted bound, {roof['ideal_step_s'] * 1e3 / ms:.4f} of the "
        f"ideal; on {smi}")
    del state, batches
    torch.cuda.empty_cache()
    return out


def phase_mesh_and_dryrun(prk, seed, smi):
    """Phase 20 (see the module docstring); returns its report."""
    t0 = time.perf_counter()
    prk.reset_counts()
    out = {"cp_decode": phase_cp_decode(seed, smi)}
    out["model_parallel"], state = phase_model_parallel(smi)
    out["remesh"] = phase_remesh(state, smi)
    del state
    out["dryrun_train"] = phase_dryrun_train(seed, smi)
    # the mesh rules and the dry run reach no kernel of the port's
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        fail(f"phase 20 launched {dict(prk.LAUNCHES)}, plain calls "
             f"{dict(prk.PLAIN_CALLS)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 20] {out['seconds']:.1f} s")
    return out


DIST_ARCH = "internlm2-1.8b"
# The two ranks' losses and grad norms against one process's, relative,
# at steps 1 and 2: about ten times the largest error of 21b and 21c on
# the card (2.75e-6 and 6.34e-6 for the loss, 4.90e-5 and 2.22e-5 for
# the grad norm: the same in every run, deterministic algorithms on;
# PERF.md section 6).
DIST_RTOL = {"loss": (3e-5, 7e-5), "grad_norm": (5e-4, 3e-4)}
DIST_DP_LAYERS = 8  # two full-depth replicas (30 GB of state each) won't fit


def cut_config(arch: str, layers: Optional[int]) -> str:
    """The name of ``arch`` cut to ``layers`` layers (an encoder-decoder's
    encoder too), registered in this process (``arch`` itself where
    ``layers`` is None)."""
    from repro_torch.configs import get_config, register

    if layers is None:
        return arch
    cfg = get_config(arch)
    name = f"{arch}-{layers}-layers"
    register(dataclasses.replace(
        cfg, name=name, num_layers=layers,
        encoder_layers=layers if cfg.is_encoder_decoder else cfg.encoder_layers))
    return name


def train_ranks(spec_path: str) -> int:
    """A rank of phase 21's torchrun launch (``--train-ranks SPEC``), or
    of phase 27's: it makes its CUDA context, touches ``{go}.ready{RANK}``
    and waits for the spec's ``go`` file (the parent runs phase 20, 21a
    and the single-process references meanwhile), then runs
    ``launch.train.main`` on each entry's ``argv``, all under one process
    group, rank 0 touching the entry's ``done`` file after each; an entry
    with ``layers`` trains ``arch`` cut to that depth, one with ``flops``
    counts step 1's dot FLOPs (:func:`counting_flops`); phase 26's
    entry (``ckpt``) runs :func:`ckpt_ranks`."""
    import torch.distributed as dist

    from repro_torch.launch import train

    with open(spec_path) as f:
        spec = json.load(f)
    torch.zeros(1, device=spec["device"])
    # every run asks for them; the first call in a process takes ~8 s on
    # the card's machine (PERF.md section 6), paid here while waiting
    torch.use_deterministic_algorithms(True, warn_only=True)
    open(f"{spec['go']}.ready{os.environ['RANK']}", "w").close()
    deadline, agent = time.monotonic() + 900, os.getppid()
    while not os.path.exists(spec["go"]):
        if time.monotonic() > deadline or os.getppid() != agent:
            print("chip_smoke: no go from the parent", file=sys.stderr)
            return 3
        time.sleep(0.05)
    for run in spec["runs"]:
        argv = list(run["argv"])
        at = argv.index("--arch") + 1
        argv[at] = cut_config(argv[at], run["layers"])
        if run.get("ckpt"):  # phase 26: step, save, re-mesh, restore
            ckpt_ranks(argv, run)
        else:
            rank = int(os.environ["RANK"])
            with recording_routes(run.get("routes"), argv[at], rank), \
                    counting_flops(run.get("flops"), rank):
                train.main(argv)
        gc.collect()
        torch.cuda.empty_cache()
        if dist.get_rank() == 0:  # its report is written
            open(run["done"], "w").close()
    dist.destroy_process_group()
    return 0


def start_ranks(nproc: int, spec: dict, d: str):
    """``torchrun --standalone --nproc-per-node nproc chip_smoke.py
    --train-ranks`` over ``spec`` (written to ``d``), from the checkout,
    in a session of its own (so a failure kills every rank); its output
    goes to files in ``d``."""
    path = os.path.join(d, "ranks.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    src = pathlib.Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    if os.path.exists("/sys/class/net/lo"):  # no network: the loopback
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", str(pathlib.Path(__file__).resolve()),
           "--train-ranks", path]
    with open(os.path.join(d, "ranks.out"), "w") as out, \
            open(os.path.join(d, "ranks.err"), "w") as err:
        return subprocess.Popen(cmd, stdout=out, stderr=err, env=env,
                                start_new_session=True)


def stop_ranks(proc) -> None:
    """Ends the launch: SIGTERM has torchrun stop its ranks (each in a
    session of its own), SIGKILL follows after 30 s."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _ranks_failed(d: str, rc) -> None:
    tails = [pathlib.Path(d, n).read_text()[-4000:] for n in ("ranks.out",
                                                             "ranks.err")]
    fail(f"torchrun of phases 21b/c to 24 exited with {rc}:\n" + "\n".join(tails))


def wait_ranks(proc, d: str, timeout: float = 400) -> None:
    """Waits for the launch; fails (killing it) on a timeout or a non-zero
    exit, with the tails of its output."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = "a timeout"
    stop_ranks(proc)
    if rc != 0:
        _ranks_failed(d, rc)


def wait_done(proc, d: str, paths, timeout: float = 240) -> None:
    """Waits until every file of ``paths`` exists (the launch's runs whose
    reports are written); fails (killing the launch) if it exits first or
    on a timeout."""
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        rc = proc.poll()
        if rc is not None or time.monotonic() > deadline:
            stop_ranks(proc)
            _ranks_failed(d, "a timeout" if rc is None else rc)
        time.sleep(0.05)


@contextlib.contextmanager
def recording_routes(path: Optional[str], arch: str, rank: int = 0):
    """With ``path``, ``models.moe._route`` recorded in this process while
    the block trains ``arch``: its first calls, one a MoE layer (the first
    step's forward), each call's experts (G, g, k) and kept pairs, saved
    to ``{path}.{rank}.npz`` after."""
    if path is None:
        yield
        return
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    layers = sum(k.endswith("moe") for k in get_config(arch).layer_kinds())
    inner, calls = moe._route, []

    def route(*args, **kw):
        out = inner(*args, **kw)
        if len(calls) < layers:
            calls.append((out[1].to(torch.int16).cpu().numpy(), out[3].cpu().numpy()))
        return out

    moe._route = route
    try:
        yield
    finally:
        moe._route = inner
    np.savez(f"{path}.{rank}.npz",
             **{f"experts{i}": e for i, (e, _) in enumerate(calls)},
             **{f"kept{i}": k for i, (_, k) in enumerate(calls)})


@contextlib.contextmanager
def counting_flops(path: Optional[str], rank: int = 0):
    """With ``path``, the first step that a train step built by
    ``models.model.make_train_step`` in this process takes while the
    block runs is run under ``FlopCounterMode`` (later steps, the timed
    ones, run bare): step 1's dot FLOPs, saved to ``{path}.{rank}.json``
    after."""
    if path is None:
        yield
        return
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import model as M

    inner, counted = M.make_train_step, []

    def make(*args, **kw):
        step = inner(*args, **kw)

        def counted_step(state, batch):
            if counted:  # step 1 is counted; the timed steps run bare
                return step(state, batch)
            with FlopCounterMode(display=False) as flops:
                out = step(state, batch)
            counted.append(float(flops.get_total_flops()))
            return out
        return counted_step

    M.make_train_step = make
    try:
        yield
    finally:
        M.make_train_step = inner
    with open(f"{path}.{rank}.json", "w") as f:
        json.dump(counted, f)


def route_differences(path_a: str, path_b: str) -> dict:
    """The (token, choice) pairs of two :func:`recording_routes` files:
    in all, whose expert differs, and whose keep under the capacity
    differs (of those with the same expert)."""
    import numpy as np

    with np.load(path_a) as a, np.load(path_b) as b:
        if sorted(a.files) != sorted(b.files):
            fail(f"routes {path_a} and {path_b} hold other layers: "
                 f"{a.files} / {b.files}")
        out = dict(layers=len(a.files) // 2, pairs=0, expert=0, kept=0)
        for i in range(out["layers"]):
            ea, eb = a[f"experts{i}"], b[f"experts{i}"]
            same = ea == eb
            out["pairs"] += ea.size
            out["expert"] += int((~same).sum())
            out["kept"] += int((same & (a[f"kept{i}"] != b[f"kept{i}"])).sum())
    return out


def single_run(argv, report, routes: Optional[str] = None):
    """``launch.train.main(argv)`` in this process (no torchrun: the
    single-process trainer); its report, the deterministic algorithms
    switched off after; with ``routes``, step 1's MoE routing recorded
    (:func:`recording_routes`)."""
    from repro_torch.launch import train

    try:
        with recording_routes(routes, argv[argv.index("--arch") + 1]):
            train.main(argv + ["--report", report])
    finally:
        torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    with open(report) as f:
        return json.load(f)


def nccl_rank(argv, report, store):
    """:func:`single_run` as the one rank of an NCCL process group in
    this process: the environment torchrun gives a world of one, a
    ``file://`` store at ``store``; the group is destroyed and the
    environment restored after."""
    import torch.distributed as dist

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        return single_run(argv, report)
    finally:
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _gb(xs):
    return [round(x / 1e9, 2) for x in xs]


def _steps(rep):
    return [round(x * 1e3, 1) for x in rep["step_s"]]


def _collective_s(rep):
    """Rank 0's host seconds in collectives, and MB moved, each step."""
    return [(round(sum(c["seconds"] for c in step.values()), 3),
             round(sum(c["bytes"] for c in step.values()) / 1e6, 1))
            for step in rep["collectives"]]


def _phases(rep):
    """Where a ``main``'s seconds went: the mesh, the state, the steps,
    the rest."""
    s = rep["seconds"]
    return {"main": round(s["total"], 1), "mesh": round(s["mesh"], 1),
            "init": round(s["init"], 1), "steps": round(sum(rep["step_s"]), 1),
            "rest": round(s["total"] - s["mesh"] - s["init"]
                          - sum(rep["step_s"]), 1)}


def _rel(rank, one):
    """The ranks' relative errors from one process's, a list by step, for
    the loss and the grad norm."""
    return {k: [abs(r - o) / abs(o) for (_, r), (_, o) in zip(rank[v], one[v])]
            for k, v in (("loss", "losses"), ("grad_norm", "grad_norms"))}


# phase 21's arguments: every run with deterministic algorithms (21a's
# bit-equality needs them), warmup 1 (the first AdamW update, which step
# 2 reads, at the full rate)
DIST_COMMON = ["--seq", "2048", "--log-every", "1", "--lr", "3e-4",
               "--warmup", "1", "--deterministic"]
# the launch's runs: arch, model-parallel, layers; 21b and 21c, then 22,
# then 23's two, 24's two and 25's two
DIST_CASES = {"b": (DIST_ARCH, 2, None), "c": (DIST_ARCH, 1, DIST_DP_LAYERS),
              "z": ("granite-20b", 1, 2), "q": ("qwen2-vl-2b", 2, 4),
              "w": ("whisper-medium", 2, 4), "e": ("granite-moe-3b-a800m", 2, 4),
              "m": ("deepseek-v2-236b", 2, 1), "s": ("mamba2-2.7b", 2, 4),
              "r": ("recurrentgemma-9b", 2, 3)}
# the runs whose step-1 MoE routing is recorded (deepseek's first layer
# is dense)
ROUTED = ("e",)
# a run's arguments beyond DIST_COMMON's: whisper's decoder over its text
# context of 448 tokens (its encoder over the config's 1,500 frames)
DIST_EXTRA = {"w": ["--seq", "448"]}


def start_distributed(seed, d):
    """Starts the torchrun launch of two ranks for 21b, 21c and 22 to 26,
    reporting into ``d``; they wait for :func:`phase_distributed`."""
    common = DIST_COMMON + ["--seed", str(seed)]
    runs = {key: common + ["--arch", arch, "--global-batch", "2", "--steps", "2"]
            + DIST_EXTRA.get(key, []) for key, (arch, _, _) in DIST_CASES.items()}
    spec = dict(go=os.path.join(d, "go"), device="cuda:0", runs=[dict(
        layers=layers, done=f"{d}/{key}.done",
        routes=f"{d}/{key}_routes" if key in ROUTED else None,
        argv=runs[key] + ["--model-parallel", str(mp), "--device", "cuda:0",
                          "--dist-backend", "gloo", "--report", f"{d}/{key}.json"])
        for key, (_, mp, layers) in DIST_CASES.items()])
    spec["runs"].append(dict(
        ckpt=True, layers=CKPT["layers"], done=f"{d}/k.done", dir=d,
        report=f"{d}/k.json", seed=seed,
        argv=common + ["--arch", CKPT["arch"], "--global-batch", "2", "--steps",
                       "1", "--model-parallel", "1", "--device", "cuda:0",
                       "--dist-backend", "gloo"]))
    return dict(d=d, go=spec["go"], runs=runs, t_launch=time.perf_counter(),
                proc=start_ranks(2, spec, d))


def phase_distributed(prk, seed, smi, ranks):
    """Phase 21 (see the module docstring) with the ranks
    :func:`start_distributed` started; returns its report.  This process
    runs 21a and the single-process references, frees the card, and
    lets the ranks step."""
    t0 = time.perf_counter()
    prk.reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    d, runs, proc = ranks["d"], ranks["runs"], ranks["proc"]
    common = DIST_COMMON + ["--seed", str(seed)]
    out = {}
    # (a) one NCCL rank in this process against the single process
    argv = common + ["--arch", DIST_ARCH, "--global-batch", "4", "--steps", "3"]
    one = single_run(argv + ["--device", "cuda"], f"{d}/single_a.json")
    rank = nccl_rank(argv + ["--dist-backend", "nccl"], f"{d}/a.json",
                     f"{d}/store_a")
    same = (rank["losses"] == one["losses"]
            and rank["grad_norms"] == one["grad_norms"]
            and len(one["losses"]) == 3)
    if not same or rank["mesh"] != {"data": 1, "model": 1} \
            or rank["backend"] != "nccl":
        fail(f"phase 21a: one NCCL rank on {rank['mesh']} ({rank['backend']}) "
             f"is not bit-equal to the single process: losses "
             f"{rank['losses']} / {one['losses']}, grad norms "
             f"{rank['grad_norms']} / {one['grad_norms']}")
    out["a"] = dict(losses=rank["losses"], grad_norms=rank["grad_norms"],
                    bit_equal=same, step_ms=_steps(rank),
                    single_step_ms=_steps(one), peak_bytes=rank["peak_bytes"],
                    single_peak_bytes=one["peak_bytes"], main=_phases(rank),
                    single_main=_phases(one))
    log(f"[phase 21a] {DIST_ARCH}, batch 4 x 2048, 3 steps: one NCCL rank (in "
        f"this process, a file:// store) on a (1, 1) mesh bit-equal to the "
        f"single process (losses {[round(x, 4) for _, x in rank['losses']]}, "
        f"grad norms {[round(x, 4) for _, x in rank['grad_norms']]}); step ms "
        f"{_steps(rank)} vs {_steps(one)}; peak {_gb(rank['peak_bytes'])} vs "
        f"{_gb(one['peak_bytes'])} GB; main {_phases(rank)}; on {smi}")
    # the single-process references of (b), (c) and phases 22 to 24, two
    # steps each
    singles = ranks["singles"] = {}
    for key, (arch, _, layers) in DIST_CASES.items():
        argv = list(runs[key])
        argv[argv.index("--arch") + 1] = cut_config(arch, layers)
        singles[key] = single_run(
            argv + ["--device", "cuda"], f"{d}/single_{key}.json",
            f"{d}/single_{key}_routes" if key in ROUTED else None)
    t_go = ranks["t_go"] = time.perf_counter()
    open(ranks["go"], "w").close()
    wait_done(proc, d, [f"{d}/{key}.done" for key in ("b", "c")])
    t_end = time.perf_counter()
    # (b) and (c): two ranks sharing cuda:0 over gloo
    for key in ("b", "c"):
        _, mp, layers = DIST_CASES[key]
        with open(f"{d}/{key}.json") as f:
            rank = json.load(f)
        one = singles[key]
        want = {"data": 2 // mp, "model": mp}
        rel = _rel(rank, one)
        ok = (rank["mesh"] == want and rank["backend"] == "gloo"
              and len(rank["losses"]) == len(one["losses"]) == 2
              and all(e <= lim for k in rel
                      for e, lim in zip(rel[k], DIST_RTOL[k]))
              and all(math.isfinite(x) for _, x in rank["losses"]
                      + rank["grad_norms"]))
        if not ok:
            fail(f"phase 21{key}: {rank['mesh']} ({rank['backend']}) against "
                 f"the single process: relative {rel} (limits by step "
                 f"{DIST_RTOL}); losses {rank['losses']} / {one['losses']}, "
                 f"grad norms {rank['grad_norms']} / {one['grad_norms']}")
        out[key] = dict(mesh=rank["mesh"], layers=layers or "all",
                        losses=rank["losses"], grad_norms=rank["grad_norms"],
                        single_losses=one["losses"],
                        single_grad_norms=one["grad_norms"], rel_err=rel,
                        step_ms=_steps(rank), single_step_ms=_steps(one),
                        peak_bytes=rank["peak_bytes"],
                        single_peak_bytes=one["peak_bytes"],
                        init_peak_bytes=rank["init_peak_bytes"],
                        main=_phases(rank), collective_s_mb=_collective_s(rank),
                        collectives=rank["collectives"])
        why = ("" if layers is None else f" ({layers} layers: two full-depth "
               "replicas, about 30 GB of state each plus activations, do not "
               "fit one 80 GB card)")
        log(f"[phase 21{key}] {DIST_ARCH}{why}, batch 2 x 2048: two ranks on "
            f"cuda:0 over gloo, a {tuple(want.values())} mesh: losses "
            f"{[round(x, 6) for _, x in rank['losses']]} vs "
            f"{[round(x, 6) for _, x in one['losses']]} (rel by step "
            f"{[f'{e:.2e}' for e in rel['loss']]}), grad norms "
            f"{[round(x, 6) for _, x in rank['grad_norms']]} vs "
            f"{[round(x, 6) for _, x in one['grad_norms']]} (rel "
            f"{[f'{e:.2e}' for e in rel['grad_norm']]}); step ms {_steps(rank)} "
            f"(host-staged collectives: no interconnect measured; rank 0's "
            f"collective s and MB a step {_collective_s(rank)}) vs "
            f"{_steps(one)} alone; peak per rank {_gb(rank['peak_bytes'])} GB "
            f"vs {_gb(one['peak_bytes'])} GB alone (drawing and placing the "
            f"state {_gb(rank['init_peak_bytes'])} GB); main {_phases(rank)}; "
            f"on {smi}")
        for r in (rank, one):
            if r["launches"] or r["plain_calls"]:
                fail(f"phase 21{key}: the trainer launched {r['launches']}, "
                     f"plain calls {r['plain_calls']}")
    out["launch"] = dict(seconds=t_end - ranks["t_launch"],
                         go_after_s=t_go - ranks["t_launch"],
                         after_go_s=t_end - t_go,
                         mains_s=[out[k]["main"]["main"] for k in ("b", "c")])
    log(f"[phase 21] torchrun of 21b and 21c (started before phase 20): "
        f"{out['launch']['seconds']:.1f} s in all, the go at "
        f"{out['launch']['go_after_s']:.1f} s, then {t_end - t_go:.1f} s (main "
        f"{out['launch']['mains_s']} s)")
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        fail(f"phase 21 launched {dict(prk.LAUNCHES)}, plain calls "
             f"{dict(prk.PLAIN_CALLS)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 21] {out['seconds']:.1f} s")
    return out


# Phase 22's ranks against one process, relative, at steps 1 and 2:
# about ten times the first run's errors on the card (the loss 0, then
# 4.55e-5; the grad norm 1.17e-5, then 7.23e-5: each rank's bf16
# gradients are summed in f32 where one process rounds the whole batch's
# once; PERF.md section 6); step 1's loss was bit-equal.
ZERO3_RTOL = {"loss": (1e-6, 5e-4), "grad_norm": (1.2e-4, 7e-4)}


def _per_step(rep, op):
    """Rank 0's calls, GB and host seconds of collective ``op`` a step."""
    return [(sum(c["calls"] for k, c in step.items() if k.startswith(op)),
             round(sum(c["bytes"] for k, c in step.items() if k.startswith(op))
                   / 1e9, 3),
             round(sum(c["seconds"] for k, c in step.items() if k.startswith(op)),
                   3))
            for step in rep["collectives"]]


def phase_zero3(prk, smi, ranks):
    """Phase 22 (see the module docstring): the launch's run after 21c,
    ZeRO-3, against the single process :func:`phase_distributed` ran
    before the go; returns its report."""
    t0 = time.perf_counter()
    d, proc = ranks["d"], ranks["proc"]
    arch, _, layers = DIST_CASES["z"]
    wait_done(proc, d, [f"{d}/z.done"])
    t_end = time.perf_counter()
    with open(f"{d}/z.json") as f:
        rank = json.load(f)
    one = ranks["singles"]["z"]
    rel = _rel(rank, one)
    # a rank's draw holds its shard and one whole leaf at a time
    init_limit = [b + 2 * rank["largest_leaf_bytes"] for b in rank["state_bytes"]]
    gathers, scatters = _per_step(rank, "all_gather"), _per_step(rank, "reduce_scatter")
    out = dict(arch=arch, layers=layers, mesh=rank["mesh"],
               losses=rank["losses"], grad_norms=rank["grad_norms"],
               single_losses=one["losses"], single_grad_norms=one["grad_norms"],
               rel_err=rel, limits=ZERO3_RTOL, step_ms=_steps(rank),
               single_step_ms=_steps(one), peak_bytes=rank["peak_bytes"],
               single_peak_bytes=one["peak_bytes"],
               init_peak_bytes=rank["init_peak_bytes"],
               single_init_peak_bytes=one["init_peak_bytes"],
               state_bytes=rank["state_bytes"],
               single_state_bytes=one["state_bytes"],
               largest_leaf_bytes=rank["largest_leaf_bytes"],
               init_limit_bytes=init_limit,
               all_gather_calls_gb_s=gathers, reduce_scatter_calls_gb_s=scatters,
               collective_s_mb=_collective_s(rank), main=_phases(rank),
               single_main=_phases(one), after_go_s=t_end - ranks["t_go"])
    log(f"[phase 22] {arch} at full width, {layers} layers (the ZeRO-3 of "
        f"recurrentgemma-9b and deepseek-v2-236b is held to the reference on "
        f"the CPU only), batch 2 x 2048: two ranks on cuda:0 over gloo, "
        f"a (2, 1) mesh, ZeRO-3 (embed dim over 'data'): losses "
        f"{[round(x, 6) for _, x in rank['losses']]} vs "
        f"{[round(x, 6) for _, x in one['losses']]} (rel by step "
        f"{[f'{e:.2e}' for e in rel['loss']]}), grad norms "
        f"{[round(x, 6) for _, x in rank['grad_norms']]} vs "
        f"{[round(x, 6) for _, x in one['grad_norms']]} (rel "
        f"{[f'{e:.2e}' for e in rel['grad_norm']]}); step ms {_steps(rank)} vs "
        f"{_steps(one)} alone; rank 0's all-gathers (calls, GB, s) a step "
        f"{gathers}, reduce-scatters {scatters} (host-staged: no interconnect "
        f"measured); peak per rank {_gb(rank['peak_bytes'])} GB vs "
        f"{_gb(one['peak_bytes'])} GB alone; drawing the state by shards "
        f"{_gb(rank['init_peak_bytes'])} GB a rank (limit: shard "
        f"{_gb(rank['state_bytes'])} + 2 x {rank['largest_leaf_bytes'] / 1e9:.2f}) "
        f"vs {_gb(one['init_peak_bytes'])} GB for the whole draw alone; main "
        f"{_phases(rank)}; on {smi}")
    ok = (rank["mesh"] == {"data": 2, "model": 1} and rank["backend"] == "gloo"
          and len(rank["losses"]) == len(one["losses"]) == 2
          and all(e <= lim for k in rel for e, lim in zip(rel[k], ZERO3_RTOL[k]))
          and all(math.isfinite(x) for _, x in rank["losses"] + rank["grad_norms"]))
    if not ok:
        fail(f"phase 22: {rank['mesh']} ({rank['backend']}) against the single "
             f"process: relative {rel} (limits by step {ZERO3_RTOL})")
    if not all(g[0] and s[0] for g, s in zip(gathers, scatters)):
        fail(f"phase 22: no ZeRO-3 collectives: {rank['collectives']}")
    if any(p > lim for p, lim in zip(rank["init_peak_bytes"], init_limit)):
        fail(f"phase 22: drawing the state peaked at {rank['init_peak_bytes']} "
             f"bytes a rank, above its shard plus two largest leaves {init_limit}")
    if not all(p < one["peak_bytes"][0] for p in rank["peak_bytes"]):
        fail(f"phase 22: a rank's step peak {rank['peak_bytes']} is not below "
             f"the single process's {one['peak_bytes']}")
    for r in (rank, one):
        if r["launches"] or r["plain_calls"]:
            fail(f"phase 22: the trainer launched {r['launches']}, plain calls "
                 f"{r['plain_calls']}")
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        fail(f"phase 22 launched {dict(prk.LAUNCHES)}, plain calls "
             f"{dict(prk.PLAIN_CALLS)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 22] {out['seconds']:.1f} s (the ranks' run after 21c: "
        f"main {out['main']['main']} s)")
    return out


# --- phase 23: tensor parallelism for embeddings input and whisper -------------

# Phase 23's ranks against one process, relative, at steps 1 and 2, by
# run: about ten times the errors of the first run on the card (qwen2-vl
# 7.99e-7 and 7.99e-7 for the loss, 2.52e-6 and 1.01e-5 for the grad
# norm; whisper 8.78e-7 and 3.44e-6, 1.99e-5 and 1.69e-5; deterministic
# algorithms on; PERF.md section 6).
TP_INPUTS_RTOL = {"q": {"loss": (8e-6, 8e-6), "grad_norm": (2.5e-5, 1e-4)},
                  "w": {"loss": (9e-6, 3.5e-5), "grad_norm": (2e-4, 1.7e-4)}}


MODEL_OPS = ("all_reduce", "all_gather", "reduce_scatter")


def tp_collectives(cfg, mp: int = 2) -> dict:
    """The collectives over "model" of one training step of ``cfg`` on a
    (1, ``mp``) tensor-parallel mesh under ``remat="dots"``, by op.
    All-reduces: per layer a "g" after each block's output, an "f" after
    each norm that feeds a column-parallel matmul, and the "g"s the
    backward recomputes (2 + 2 + 1 in a dense, MoE, MLA, encoder,
    local-attention or RG-LRU layer, 3 + 3 + 2 in a decoder layer with
    cross-attention; an SSD layer's "f" and "g", its gated norm's sum of
    squares forward and backward, and that sum again in the recompute);
    the vocabulary-parallel lookup of token ids (one "g"), the encoder
    output's "f", the final norm's "f", the cross entropy's max, sum and
    target, the grad norm, and one coalesced sum of the partial gradients
    where a split block holds a whole leaf (the MoE router, MLA's latent
    projections, kv heads that do not divide ``mp``).  An SSD layer
    all-gathers ``in_proj``, ``conv_w`` and ``conv_b`` in the forward and
    the recompute and reduce-scatters their gradients; an RG-LRU layer's
    dense gates reduce-scatter their outputs in the forward and the
    recompute and all-gather their gradients (block-diagonal gates need
    neither)."""
    kinds = list(cfg.layer_kinds())
    enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    tokens = cfg.input_mode != "embeddings" or cfg.is_encoder_decoder
    attn = any(k in ("dense", "moe", "local_attn", "dec") for k in kinds)
    partial = (any(k.endswith("moe") or k.startswith("mla") for k in kinds)
               or (attn and cfg.num_kv_heads % mp != 0))
    dense_gates = 0 if cfg.lru_gate_blocks else kinds.count("rglru")
    ssm = kinds.count("ssm")
    reduces = (sum(8 if k == "dec" else 5 for k in kinds) + 5 * enc + int(tokens)
               + int(cfg.is_encoder_decoder) + 1 + 3 + 1 + int(partial))
    return {"all_reduce": reduces, "all_gather": 6 * ssm + 2 * dense_gates,
            "reduce_scatter": 3 * ssm + 4 * dense_gates}


def _tp_runs(prk, smi, ranks, phase: str, keys, rtol) -> dict:
    """Phases 23 to 25's runs ``keys`` of the launch (their reports
    written): each held to its single process within ``rtol`` (by key),
    its collectives over "model" a step to :func:`tp_collectives`, its
    step peak below the single process's; no kernel or plain version
    runs.  Returns the report by key."""
    from repro_torch.configs import get_config

    d, out = ranks["d"], {}
    for key in keys:
        arch, mp, layers = DIST_CASES[key]
        cfg = get_config(cut_config(arch, layers))
        with open(f"{d}/{key}.json") as f:
            rank = json.load(f)
        one = ranks["singles"][key]
        rel = _rel(rank, one)
        limits = rtol[key]
        ops = {op: [(n, round(gb * 1e3, 1), sec) for n, gb, sec
                    in _per_step(rank, f"{op}[model]")] for op in MODEL_OPS}
        want = tp_collectives(cfg, mp)
        seq = DIST_EXTRA.get(key, ["--seq", "2048"])[1]
        if cfg.is_encoder_decoder:
            what = (f"{layers} + {layers} layers, decoder 2 x {seq} over "
                    f"{cfg.encoder_seq} frames")
        elif cfg.input_mode == "embeddings":
            what = f"{layers} layers, batch 2 x {seq} of embeddings, M-RoPE"
        else:
            what = f"{layers} layers {cfg.layer_kinds()}, batch 2 x {seq}"
        out[key] = dict(arch=arch, layers=layers, mesh=rank["mesh"],
                        losses=rank["losses"], grad_norms=rank["grad_norms"],
                        single_losses=one["losses"],
                        single_grad_norms=one["grad_norms"], rel_err=rel,
                        limits=limits, step_ms=_steps(rank),
                        single_step_ms=_steps(one), peak_bytes=rank["peak_bytes"],
                        single_peak_bytes=one["peak_bytes"],
                        init_peak_bytes=rank["init_peak_bytes"],
                        state_bytes=rank["state_bytes"],
                        single_state_bytes=one["state_bytes"],
                        model_calls_mb_s=ops, model_calls_predicted=want,
                        collectives=rank["collectives"], main=_phases(rank),
                        single_main=_phases(one))
        log(f"[phase {phase}{key}] {arch} at full width, {what}: two ranks on "
            f"cuda:0 over gloo, a (1, {mp}) tensor-parallel mesh: losses "
            f"{[round(x, 6) for _, x in rank['losses']]} vs "
            f"{[round(x, 6) for _, x in one['losses']]} (rel by step "
            f"{[f'{e:.2e}' for e in rel['loss']]}), grad norms "
            f"{[round(x, 6) for _, x in rank['grad_norms']]} vs "
            f"{[round(x, 6) for _, x in one['grad_norms']]} (rel "
            f"{[f'{e:.2e}' for e in rel['grad_norm']]}; limits {limits}); step "
            f"ms {_steps(rank)} vs {_steps(one)} alone; rank 0's collectives "
            f"over 'model' (calls, MB, s) a step {ops} (predicted {want} calls; "
            f"host-staged: no interconnect measured); peak per rank "
            f"{_gb(rank['peak_bytes'])} GB vs {_gb(one['peak_bytes'])} GB alone "
            f"(state {_gb(rank['state_bytes'])} vs {_gb(one['state_bytes'])}); "
            f"main {_phases(rank)}; on {smi}")
        ok = (rank["mesh"] == {"data": 1, "model": mp} and rank["backend"] == "gloo"
              and len(rank["losses"]) == len(one["losses"]) == 2
              and all(e <= lim for k in rel for e, lim in zip(rel[k], limits[k]))
              and all(math.isfinite(x) for _, x in rank["losses"]
                      + rank["grad_norms"]))
        if not ok:
            fail(f"phase {phase}{key}: {rank['mesh']} ({rank['backend']}) against "
                 f"the single process: relative {rel} (limits by step {limits}); "
                 f"losses {rank['losses']} / {one['losses']}, grad norms "
                 f"{rank['grad_norms']} / {one['grad_norms']}")
        counts = [{op: step.get(f"{op}[model]", {}).get("calls", 0)
                   for op in MODEL_OPS} for step in rank["collectives"]]
        if counts != [want] * 2:
            fail(f"phase {phase}{key}: collectives over 'model' a step {counts}, "
                 f"not the {want} of the tensor-parallel brackets")
        if not all(p < one["peak_bytes"][0] for p in rank["peak_bytes"]):
            fail(f"phase {phase}{key}: a rank's step peak {rank['peak_bytes']} is "
                 f"not below the single process's {one['peak_bytes']}")
        for r in (rank, one):
            if r["launches"] or r["plain_calls"]:
                fail(f"phase {phase}{key}: the trainer launched {r['launches']}, "
                     f"plain calls {r['plain_calls']}")
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        fail(f"phase {phase} launched {dict(prk.LAUNCHES)}, plain calls "
             f"{dict(prk.PLAIN_CALLS)}")
    return out


def phase_tp_inputs(prk, smi, ranks):
    """Phase 23 (see the module docstring): the launch's runs after 22,
    tensor parallelism over "model" for qwen2-vl-2b (embeddings input,
    M-RoPE) and whisper-medium (encoder-decoder), against the single
    processes :func:`phase_distributed` ran before the go; returns its
    report."""
    t0 = time.perf_counter()
    wait_done(ranks["proc"], ranks["d"], [f"{ranks['d']}/{k}.done" for k in "qw"])
    t_end = time.perf_counter()
    out = _tp_runs(prk, smi, ranks, "23", ("q", "w"), TP_INPUTS_RTOL)
    out["after_z_s"] = t_end - t0
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 23] {out['seconds']:.1f} s (the ranks' runs after 22: main "
        f"{[out[k]['main']['main'] for k in ('q', 'w')]} s)")
    return out


# --- phase 24: tensor parallelism for MoE experts and MLA heads ----------------

# Phase 24's ranks against one process, relative, at steps 1 and 2, by
# run: about ten times the errors of the first run on the card
# (granite-moe 5.29e-7 and 7.06e-7 for the loss, 2.13e-6 and 3.40e-6 for
# the grad norm, with 891 of step 1's 131,072 routing pairs on another
# expert; deepseek 4.95e-7 and 7.42e-7, 6.21e-6 and 2.38e-6;
# deterministic algorithms on; PERF.md section 6).
TP_MOE_RTOL = {"e": {"loss": (5e-6, 7e-6), "grad_norm": (2e-5, 3.5e-5)},
               "m": {"loss": (5e-6, 7.5e-6), "grad_norm": (6e-5, 2.5e-5)}}
# the share of step 1's (token, choice) pairs that may take another
# expert than one process's: about ten times the first run's 0.68%
ROUTE_FLIP_LIMIT = 0.07


def phase_tp_moe(prk, smi, ranks):
    """Phase 24 (see the module docstring): the launch's runs after 23's,
    tensor parallelism over "model" for granite-moe-3b-a800m (experts)
    and deepseek-v2-236b (MLA heads), against the single processes
    :func:`phase_distributed` ran before the go, and (e)'s step-1 routing
    against the single process's; returns its report."""
    t0 = time.perf_counter()
    d, proc = ranks["d"], ranks["proc"]
    wait_done(proc, d, [f"{d}/{k}.done" for k in "em"])
    t_end = time.perf_counter()
    out = _tp_runs(prk, smi, ranks, "24", ("e", "m"), TP_MOE_RTOL)
    for key in ROUTED:
        one = f"{d}/single_{key}_routes.0.npz"
        vs_one = route_differences(f"{d}/{key}_routes.0.npz", one)
        between = route_differences(f"{d}/{key}_routes.0.npz",
                                    f"{d}/{key}_routes.1.npz")
        out[key]["routes_vs_single"] = vs_one
        out[key]["routes_between_ranks"] = between
        log(f"[phase 24{key}] step 1's routing, {vs_one['layers']} MoE layers, "
            f"{vs_one['pairs']} (token, choice) pairs: {vs_one['expert']} take "
            f"another expert than the single process's and {vs_one['kept']} "
            f"another keep under the capacity (bf16 compute: \"g\" sums the "
            f"attention output in another order); between the two ranks "
            f"{between['expert']} and {between['kept']}; on {smi}")
        if between["expert"] or between["kept"] or not vs_one["pairs"]:
            fail(f"phase 24{key}: the ranks routed apart ({between}) or no "
                 f"routing was recorded ({vs_one})")
        if vs_one["expert"] + vs_one["kept"] > ROUTE_FLIP_LIMIT * vs_one["pairs"]:
            fail(f"phase 24{key}: {vs_one} of step 1's routing pairs differ "
                 f"from the single process's, above {ROUTE_FLIP_LIMIT:.0%}")
    out["after_w_s"] = t_end - t0
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 24] {out['seconds']:.1f} s (the ranks' runs after 23: main "
        f"{[out[k]['main']['main'] for k in ('e', 'm')]} s)")
    return out


# --- phase 25: tensor parallelism for the recurrent blocks ----------------------

# Phase 25's ranks against one process, relative, at steps 1 and 2, by
# run: about ten times the errors of the first run on the card (mamba2
# 1.49e-6 and 8.83e-6 for the loss, 1.65e-4 and 6.71e-5 for the grad
# norm: each rank's part of in_proj's bf16 gradient is rounded before
# the reduce-scatter sums it; recurrentgemma 1.38e-6 and 1.15e-6,
# 1.89e-5 and 1.33e-5; deterministic algorithms on; PERF.md section 6).
TP_RECURRENT_RTOL = {"s": {"loss": (1.5e-5, 9e-5), "grad_norm": (1.7e-3, 7e-4)},
                     "r": {"loss": (1.4e-5, 1.2e-5), "grad_norm": (1.9e-4, 1.4e-4)}}


def phase_tp_recurrent(prk, smi, ranks):
    """Phase 25 (see the module docstring): the launch's two runs before
    phase 26's, tensor parallelism over "model" for mamba2-2.7b (SSD heads) and
    recurrentgemma-9b (RG-LRU channels and local attention's heads),
    against the single processes :func:`phase_distributed` ran before the
    go (recurrentgemma's 44 GB of state whole never beside the ranks'
    shards); returns its report."""
    t0 = time.perf_counter()
    d, proc = ranks["d"], ranks["proc"]
    wait_done(proc, d, [f"{d}/{key}.done" for key in ("s", "r")])
    t_end = time.perf_counter()
    out = _tp_runs(prk, smi, ranks, "25", ("s", "r"), TP_RECURRENT_RTOL)
    out["after_m_s"] = t_end - t0
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 25] {out['seconds']:.1f} s (the ranks' runs after 24: main "
        f"{[out[k]['main']['main'] for k in ('s', 'r')]} s; single processes, "
        f"before the go: main "
        f"{[_phases(ranks['singles'][k])['main'] for k in ('s', 'r')]} s)")
    return out


# --- phase 26: checkpoints a slab at a time, and re-meshing in place -----------

# granite-20b at full width cut to 2 layers (phase 22's): ZeRO-3 on (2, 1)
CKPT = dict(arch="granite-20b", layers=2)
# a rank's HOST_PEAK beyond its largest slab (and, in an async save, its
# share): gloo's staging of one gather round on rank 0 (two ranks' parts
# of 64 MiB), a part's round copied to the host and a written chunk
CKPT_SLACK = 4 * (64 << 20)
# free disk the two saves need beyond their 2 x the checkpoint's bytes
CKPT_DISK_MARGIN = 4e9


def vm_hwm() -> int:
    """This process's peak resident set, bytes: ``VmHWM`` of
    /proc/self/status (read only), or where that line is missing (the
    card's sandbox has none) ``getrusage``'s ``ru_maxrss``, the same
    mark."""
    import resource

    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def sha256s(tensors: dict, threads: int = 4) -> dict:
    """sha256 of each tensor's bytes (as stored: f32), by key: each copied
    to the host in turn and hashed on a thread (hashlib releases the GIL),
    at most ``threads`` in flight."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def digest(t):
        return hashlib.sha256(memoryview(t.numpy().reshape(-1).view(np.uint8))).hexdigest()

    out, pending = {}, []
    with ThreadPoolExecutor(threads) as pool:
        for key, t in tensors.items():
            pending.append((key, pool.submit(digest, t.detach().to("cpu").contiguous())))
            if len(pending) >= threads:
                k, fut = pending.pop(0)
                out[k] = fut.result()
        for k, fut in pending:
            out[k] = fut.result()
    return out


def state_tensors(state) -> dict:
    """A train state's parameters and moments by ``p:``/``m:``/``v:`` +
    name."""
    out = {f"p:{n}": p.detach() for n, p in state.params.named_parameters()}
    for tree in ("m", "v"):
        out.update({f"{tree}:{n}": t for n, t in getattr(state.opt_state, tree).items()})
    return out


def rank_part(t, spec, mesh, coords: dict):
    """The part of the whole ``t`` under ``spec`` that the rank at
    ``coords`` (index by axis) of a mesh of ``mesh``'s shape holds, as
    ``parallel.distributed.local_shard`` cuts it."""
    from repro_torch.parallel import distributed as D

    for dim, axis in D.spec_cuts(spec, t.ndim, mesh):
        t = t.chunk(mesh.shape[axis], dim=dim)[coords[axis]]
    return t


def same_checkpoints(a: str, b: str) -> list:
    """The entries of two ``arrays.npz`` whose bytes differ (and those in
    one only), compared a slab at a time over memory maps."""
    import zipfile

    import numpy as np

    from repro_torch.checkpoint import checkpoint as ck

    names = []
    for path in (a, b):
        with zipfile.ZipFile(path) as z:
            names.append(sorted(n[:-len(".npy")] for n in z.namelist()))
    ra, rb = ck._NpzReader(a), ck._NpzReader(b)
    try:
        bad = sorted(set(names[0]) ^ set(names[1]))
        for key in names[0]:
            if key in bad:
                continue
            _, shape, dtype = ra.head(key)
            if rb.head(key)[1:] != (shape, dtype):
                bad.append(key)
                continue
            for j in range(shape[0]) if len(shape) > 2 else [None]:
                with ra.slab(key, j) as x, rb.slab(key, j) as y:
                    word = np.uint64 if x.nbytes % 8 == 0 else np.uint8
                    if not np.array_equal(x.reshape(-1).view(word),
                                          y.reshape(-1).view(word)):
                        bad.append(key)
                        break
    finally:
        ra.close()
        rb.close()
    return bad


def ckpt_ranks(argv, run) -> None:
    """Phase 26's side in each rank of the launch: (a) the trainer's step
    1 on (2, 1) (ZeRO-3), saved synchronously and with
    ``AsyncCheckpointer`` (each timed, with ``HOST_PEAK`` and the growth
    of ``VmHWM``), the two saves compared on rank 0, each rank's
    step-1 shards hashed; (b) ``remesh_state`` onto (1, 2); (c) the sync
    save restored into a fresh (1, 2) shard; (b) and (c) held bit-equal,
    then step 2 on each.  Rank 0 writes the ranks' reports to
    ``run["report"]``, each rank its digests beside it."""
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.ft.elastic import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import use_mesh

    rank, d = int(os.environ["RANK"]), run["dir"]
    device = torch.device(argv[argv.index("--device") + 1])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = train.main(argv)
    state, mesh = out["state"], out["mesh"]
    cfg = state.params.cfg
    whole = tfm.Transformer(cfg, device="meta")
    whole_bytes = 12 * sum(p.numel() for p in whole.parameters())
    slab = 4 * max(p.numel() for p in whole.parameters())
    share = sum(t.numel() * t.element_size() for t in state_tensors(state).values())
    me = dict(rank=rank, mesh=dict(mesh.shape), losses=out["losses"],
              grad_norms=out["grad_norms"], whole_bytes=whole_bytes, slab=slab,
              share=share)
    me["free_disk"] = shutil.disk_usage(d).free
    if me["free_disk"] < 2 * whole_bytes + CKPT_DISK_MARGIN:
        raise RuntimeError(f"phase 26: {me['free_disk'] / 1e9:.1f} GB free in {d}; "
                           f"two checkpoints of {whole_bytes / 1e9:.1f} GB need "
                           f"{(2 * whole_bytes + CKPT_DISK_MARGIN) / 1e9:.1f}")
    dirs = {k: f"{d}/ck_{k}" for k in ("sync", "async")}

    def measured(label, fn):
        sync()
        hwm, t0 = vm_hwm(), time.perf_counter()
        ck.reset_host_peak()
        result = fn()
        sync()
        me[f"{label}_s"] = time.perf_counter() - t0
        me[f"{label}_host_peak"] = ck.reset_host_peak()
        me[f"{label}_hwm_before"], me[f"{label}_hwm_after"] = hwm, vm_hwm()
        return result

    measured("save", lambda: ck.save_checkpoint(dirs["sync"], 1, state))
    writer = ck.AsyncCheckpointer(dirs["async"], mesh=mesh)

    def async_save():
        t0 = time.perf_counter()
        writer.save(1, state)
        me["async_blocked_s"] = time.perf_counter() - t0
        writer.wait(timeout=600)

    measured("async", async_save)
    me["held_after_saves"] = ck.HOST_PEAK["held"]
    if rank == 0:
        step1 = {k: f"{dirs[k]}/step_00000001" for k in dirs}
        me["ckpt_bytes"] = os.path.getsize(f"{step1['sync']}/arrays.npz")
        t0 = time.perf_counter()
        me["saves_differ"] = same_checkpoints(*(f"{step1[k]}/arrays.npz"
                                                for k in ("sync", "async")))
        me["compare_s"] = time.perf_counter() - t0
        metas = [pathlib.Path(step1[k], "META.json").read_text() for k in dirs]
        me["metas_equal"] = metas[0] == metas[1]
    t0 = time.perf_counter()
    with open(f"{run['report']}.digests.{rank}", "w") as f:
        json.dump(sha256s(state_tensors(state)), f)
    me["hash_s"] = time.perf_counter() - t0
    # (b) the state re-meshed in place onto (1, 2)
    mesh12 = D.init_process_mesh(2, device=device, backend="gloo")
    state_b = measured("remesh", lambda: remesh_state(state, tfm.model_axes(cfg),
                                                      mesh12))
    layout = state_b.params.layout
    me["remesh_holds_old_mesh"] = (layout.mesh is not mesh12
                                   or state_b.params.tp.mesh is not mesh12)
    del state, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (c) the sync save restored into a fresh (1, 2) shard
    specs = SS.train_state_specs(cfg, mesh12)
    with use_mesh(mesh12):
        like = M.init_train_state(
            torch.Generator(device=device).manual_seed(run["seed"] + 1), cfg,
            shardings=specs)
    state_c, at = measured("restore", lambda: ck.restore_checkpoint(
        dirs["sync"], like, shardings=specs))
    tb, tc = state_tensors(state_b), state_tensors(state_c)
    me["b_c_unequal"] = [k for k in tb if tb[k].shape != tc[k].shape
                         or not torch.equal(tb[k].view(torch.int32),
                                            tc[k].view(torch.int32))]
    me["steps_bc"] = (int(state_b.step), int(state_c.step), at)
    # step 2 on each, the batch the trainer's step 2 takes
    src = SyntheticTokenSource(cfg.vocab_size, 2048, 2, seed=run["seed"],
                               input_mode=cfg.input_mode, d_model=cfg.d_model)
    batch = train.to_device(D.local_batch(src.batch(1), mesh12), device)
    step = M.make_train_step(cfg, learning_rate=cosine_schedule(3e-4, 1, 2))
    for key, st in (("b", state_b), ("c", state_c)):
        t0 = time.perf_counter()
        with use_mesh(mesh12):
            st, m = step(st, batch)
        me[f"step2_{key}"] = (float(m["loss"]), float(m["grad_norm"]))
        me[f"step2_{key}_s"] = time.perf_counter() - t0
    me["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else 0)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, me)
    if rank == 0:
        with open(run["report"], "w") as f:
            json.dump(every, f)


def phase_ckpt(prk, smi, ranks, seed):
    """Phase 26 (see the module docstring): the launch's last run
    (:func:`ckpt_ranks`), then (d) in this process after the launch
    ends: the sync save restored whole on ``cuda:0``, every leaf cut as
    each rank held it and hashed against the ranks' step-1 digests;
    returns its report."""
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    d, proc = ranks["d"], ranks["proc"]
    wait_ranks(proc, d)
    t_end = time.perf_counter()
    prk.reset_counts()
    with open(f"{d}/k.json") as f:
        every = json.load(f)
    r0 = every[0]
    whole, slab = r0["whole_bytes"], r0["slab"]
    def gb(nbytes):
        return round(nbytes / 1e9, 3)

    # (d) one process: the checkpoint restored whole on the card
    cfg = get_config(cut_config(CKPT["arch"], CKPT["layers"]))
    like = M.init_train_state(torch.Generator(device="cuda").manual_seed(seed + 2),
                              cfg, device="cuda")
    hwm = vm_hwm()
    torch.cuda.synchronize()
    ck.reset_host_peak()
    t1 = time.perf_counter()
    one, at = ck.restore_checkpoint(f"{d}/ck_sync", like)
    torch.cuda.synchronize()
    one_s, one_peak, one_hwm = time.perf_counter() - t1, ck.reset_host_peak(), vm_hwm()
    mesh21 = logical_mesh((2, 1), ("data", "model"))
    specs = SS.train_state_specs(cfg, mesh21)
    differ = []
    t1 = time.perf_counter()
    for r in range(2):
        with open(f"{d}/k.json.digests.{r}") as f:
            want = json.load(f)
        coords = {"data": r, "model": 0}
        parts = {k: rank_part(t, specs.params[k.split(":", 1)[1]].spec, mesh21, coords)
                 for k, t in state_tensors(one).items()}
        got = sha256s(parts, threads=8)
        differ += [(r, k) for k in want if got.get(k) != want[k]]
        differ += [(r, k) for k in got if k not in want]
    hash_s = time.perf_counter() - t1
    one_step = int(one.step)
    del like, one
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(ranks=every, one=dict(restore_s=one_s, host_peak=one_peak,
                                     hwm_before=hwm, hwm_after=one_hwm, at=at,
                                     step=one_step, differ=differ, hash_s=hash_s),
               whole_bytes=whole, slab=slab, after_25_s=t_end - t0)
    for r in every:
        log(f"[phase 26a] rank {r['rank']}, {CKPT['arch']} at full width, "
            f"{CKPT['layers']} layers, ZeRO-3 {tuple(r['mesh'].values())}: step 1 "
            f"loss {r['losses']}, grad norm {r['grad_norms']}; save "
            f"{r['save_s']:.2f} s, HOST_PEAK {gb(r['save_host_peak'])} GB, VmHWM "
            f"{gb(r['save_hwm_before'])} -> {gb(r['save_hwm_after'])} GB; async "
            f"save blocked {r['async_blocked_s']:.2f} s, done in "
            f"{r['async_s']:.2f} s, HOST_PEAK {gb(r['async_host_peak'])} GB (its "
            f"share {gb(r['share'])}), VmHWM {gb(r['async_hwm_before'])} -> "
            f"{gb(r['async_hwm_after'])} GB; (b) remesh onto (1, 2) "
            f"{r['remesh_s']:.2f} s; (c) restore at (1, 2) {r['restore_s']:.2f} s, "
            f"HOST_PEAK {gb(r['restore_host_peak'])} GB, VmHWM "
            f"{gb(r['restore_hwm_before'])} -> {gb(r['restore_hwm_after'])} GB; "
            f"step 2 (b) {r['step2_b']} in {r['step2_b_s']:.2f} s, (c) "
            f"{r['step2_c']} in {r['step2_c_s']:.2f} s; card peak "
            f"{gb(r['peak_device_bytes'])} GB; the old path held the whole "
            f"state on every rank's host: {gb(whole)} GB (computed); the largest "
            f"slab {gb(slab)} GB; free disk before the save "
            f"{gb(r['free_disk'])} GB; on {smi}")
    log(f"[phase 26a] checkpoint {gb(r0['ckpt_bytes'])} GB; the sync and async "
        f"saves differ in {r0['saves_differ']} (compared in "
        f"{r0['compare_s']:.1f} s); the ranks hashed their step-1 shards in "
        f"{[round(r['hash_s'], 1) for r in every]} s")
    log(f"[phase 26d] this process restored the checkpoint whole on cuda:0 in "
        f"{one_s:.2f} s, HOST_PEAK {gb(one_peak)} GB, VmHWM {gb(hwm)} -> "
        f"{gb(one_hwm)} GB; every leaf cut as each rank held it against the "
        f"ranks' step-1 sha256: {len(differ)} differ (hashed in {hash_s:.1f} s)")
    problems = []
    for r in every:
        if r["b_c_unequal"] or r["steps_bc"] != [1, 1, 1]:
            problems.append(f"rank {r['rank']}: (b) and (c) differ in "
                            f"{r['b_c_unequal'][:5]}, steps {r['steps_bc']}")
        if r["step2_b"] != r["step2_c"] or not all(
                math.isfinite(x) for x in r["step2_b"]):
            problems.append(f"rank {r['rank']}: step 2 (b) {r['step2_b']} != (c) "
                            f"{r['step2_c']}")
        if r["remesh_holds_old_mesh"] or r["held_after_saves"]:
            problems.append(f"rank {r['rank']}: the re-meshed state holds the old "
                            f"mesh, or {r['held_after_saves']} host bytes held")
        for op, share in (("save", 0), ("restore", 0), ("async", r["share"])):
            limit = slab + share + CKPT_SLACK
            if not r[f"{op}_host_peak"] <= limit or (
                    not share and r[f"{op}_host_peak"] >= whole / 2):
                problems.append(f"rank {r['rank']}: HOST_PEAK over the {op} "
                                f"{r[f'{op}_host_peak']} B, limit {limit} B (one "
                                f"slab, share, slack; under half the whole state)")
    if every[0]["save_host_peak"] < slab:
        problems.append(f"rank 0's save HOST_PEAK {every[0]['save_host_peak']} B "
                        f"is below the slab it writes, {slab} B")
    if r0["saves_differ"] or not r0["metas_equal"]:
        problems.append(f"the sync and async saves differ: {r0['saves_differ']}")
    if differ or one_step != 1 or at != 1:
        problems.append(f"(d) the whole restore differs from the ranks' step-1 "
                        f"shards in {differ[:5]} (step {one_step}, at {at})")
    if not one_peak <= slab + CKPT_SLACK:
        problems.append(f"(d) HOST_PEAK {one_peak} B over one slab {slab} B")
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        problems.append(f"launched {dict(prk.LAUNCHES)}, plain calls "
                        f"{dict(prk.PLAIN_CALLS)}")
    if problems:
        fail("phase 26: " + "; ".join(problems))
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 26] {out['seconds']:.1f} s (the ranks' run after 25 "
        f"{t_end - t0:.1f} s)")
    return out


# --- phase 27: a rank of eight whose attention runs whole, counted -------------

# starcoder2-7b at full width on (1, 8): its 36 heads (and 4 kv heads)
# whole on every rank, d_ff and the vocabulary split 8 ways; lr a
# hundredth of phase 21's: AdamW's first update is lr x sign(g) on every
# element, so elements whose gradient is rounding noise move by the full
# rate in either run (at 3e-4, on an H100, both runs' loss went from
# 10.85 to 12.3 and step 2's errors to 5.33e-4 for the loss and 1.02e-3
# for the grad norm, beyond phase 23's limits)
WHOLE = {"arch": "starcoder2-7b", "ranks": 8, "layers": 2, "lr": "3e-6"}
# Both steps' loss and grad norm against one process's, relative: phase
# 23's limits by step for two gloo ranks, the larger of its two runs'
# (TP_INPUTS_RTOL)
WHOLE_RTOL = {k: tuple(max(TP_INPUTS_RTOL[run][k][i] for run in "qw")
                       for i in range(2)) for k in ("loss", "grad_norm")}


def start_whole(seed, d):
    """Starts phase 27's torchrun launch of eight ranks reporting into
    ``d``; they wait for :func:`phase_whole`."""
    os.makedirs(d, exist_ok=True)
    argv = list(DIST_COMMON)
    argv[argv.index("--lr") + 1] = WHOLE["lr"]
    argv += ["--seed", str(seed), "--arch", WHOLE["arch"], "--global-batch",
             "1", "--steps", "2"]
    spec = dict(go=os.path.join(d, "go"), device="cuda:0", runs=[dict(
        layers=WHOLE["layers"], done=f"{d}/x.done", flops=f"{d}/x_flops",
        argv=argv + ["--model-parallel", str(WHOLE["ranks"]), "--device",
                     "cuda:0", "--dist-backend", "gloo", "--report",
                     f"{d}/x.json"])])
    return dict(d=d, go=spec["go"], argv=argv, t_launch=time.perf_counter(),
                proc=start_ranks(WHOLE["ranks"], spec, d))


def phase_whole(prk, smi, ranks, seed):
    """Phase 27 (see the module docstring) with the ranks
    :func:`start_whole` started: once every rank is ready, the single
    process in this process, then the go, the ranks' report held to it
    and to the dry run's count of rank 0's step; returns its report."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.parallel.distributed import fake_process_mesh

    t0 = time.perf_counter()
    prk.reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    d, proc = ranks["d"], ranks["proc"]
    # the ranks' Python, torch and CUDA contexts start beside no timed run
    wait_done(proc, d, [f"{ranks['go']}.ready{r}" for r in range(WHOLE["ranks"])])
    t_ready = time.perf_counter()
    name = cut_config(WHOLE["arch"], WHOLE["layers"])
    argv = list(ranks["argv"])
    argv[argv.index("--arch") + 1] = name
    one = single_run(argv + ["--device", "cuda"], f"{d}/single_x.json")
    gc.collect()
    torch.cuda.empty_cache()
    t_go = time.perf_counter()
    open(ranks["go"], "w").close()
    wait_ranks(proc, d)
    t_end = time.perf_counter()
    with open(f"{d}/x.json") as f:
        rank = json.load(f)
    with open(f"{d}/x_flops.0.json") as f:
        card_flops = json.load(f)
    # the dry run's count of the same step, rank 0 of a fake (1, 8) mesh
    cfg = get_config(name)
    seq = int(argv[argv.index("--seq") + 1])
    t_count = time.perf_counter()
    with fake_process_mesh((1, WHOLE["ranks"]), ("data", "model")) as mesh:
        cost = count_cell(cfg, ShapeConfig("train", seq, 1, "train"), mesh)
    count_s = time.perf_counter() - t_count
    card = {k: {"calls": v["calls"], "bytes": v["bytes"]}
            for k, v in rank["collectives"][0].items()}
    rel = _rel(rank, one)
    staged = [sum(c["seconds"] for c in step.values()) for step in rank["collectives"]]
    share = [s / t for s, t in zip(staged, rank["step_s"])]
    out = dict(arch=WHOLE["arch"], layers=WHOLE["layers"], mesh=rank["mesh"],
               losses=rank["losses"], grad_norms=rank["grad_norms"],
               single_losses=one["losses"], single_grad_norms=one["grad_norms"],
               rel_err=rel, limits=WHOLE_RTOL, step_ms=_steps(rank),
               single_step_ms=_steps(one), collective_s=staged,
               collective_share=share, peak_bytes=rank["peak_bytes"],
               single_peak_bytes=one["peak_bytes"],
               state_bytes=rank["state_bytes"],
               single_state_bytes=one["state_bytes"],
               collectives=rank["collectives"], counted_collectives=cost.collectives,
               card_dot_flops=card_flops, counted_dot_flops=cost.dot_flops,
               count_s=count_s, main=_phases(rank), single_main=_phases(one),
               before_go_s=t_go - t0, after_go_s=t_end - t_go)
    log(f"[phase 27] {WHOLE['arch']} at full width, {WHOLE['layers']} layers, "
        f"batch 1 x {seq}: {WHOLE['ranks']} ranks on cuda:0 over gloo, a "
        f"{rank['mesh']} mesh, attention whole on every rank: losses "
        f"{[round(x, 6) for _, x in rank['losses']]} vs "
        f"{[round(x, 6) for _, x in one['losses']]} (rel by step "
        f"{[f'{e:.2e}' for e in rel['loss']]}), grad norms "
        f"{[round(x, 6) for _, x in rank['grad_norms']]} vs "
        f"{[round(x, 6) for _, x in one['grad_norms']]} (rel "
        f"{[f'{e:.2e}' for e in rel['grad_norm']]}; limits by step "
        f"{WHOLE_RTOL}; lr {WHOLE['lr']}); on {smi}")
    log(f"[phase 27] peak per rank {_gb(rank['peak_bytes'])} GB vs "
        f"{_gb(one['peak_bytes'])} GB for one process (state "
        f"{_gb(rank['state_bytes'])} vs {_gb(one['state_bytes'])} GB); on {smi}")
    log(f"[phase 27] step ms {_steps(rank)} vs {_steps(one)} alone; rank 0's "
        f"host-staged collectives {[round(s, 3) for s in staged]} s a step, "
        f"{[round(x, 4) for x in share]} of the step (calls, MB, s: "
        f"{_collective_s(rank)}); on {smi}")
    log(f"[phase 27] rank 0's step 1 against the dry run's count as rank 0 of a "
        f"fake (1, {WHOLE['ranks']}) mesh (counted in {count_s:.1f} s): "
        f"collectives {card} vs {cost.collectives}; dot FLOPs {card_flops} vs "
        f"{cost.dot_flops}; the ranks' main {_phases(rank)}, before the go "
        f"{t_go - t0:.1f} s, after it {t_end - t_go:.1f} s")
    ok = (rank["mesh"] == {"data": 1, "model": WHOLE["ranks"]}
          and rank["backend"] == "gloo"
          and len(rank["losses"]) == len(one["losses"]) == 2
          and all(e <= lim for k in rel for e, lim in zip(rel[k], WHOLE_RTOL[k]))
          and all(math.isfinite(x) for _, x in rank["losses"] + rank["grad_norms"]))
    if not ok:
        fail(f"phase 27: {rank['mesh']} ({rank['backend']}) against the single "
             f"process: relative {rel} (limits by step {WHOLE_RTOL}); losses "
             f"{rank['losses']} / {one['losses']}, grad norms "
             f"{rank['grad_norms']} / {one['grad_norms']}")
    if card != cost.collectives:
        fail(f"phase 27: rank 0's collectives in step 1 {card}, the dry run's "
             f"count {cost.collectives}")
    if not card_flops or card_flops[0] != cost.dot_flops:
        fail(f"phase 27: rank 0's step-1 dot FLOPs {card_flops}, the dry run's "
             f"count {cost.dot_flops}")
    if not all(p < one["peak_bytes"][0] for p in rank["peak_bytes"]):
        fail(f"phase 27: a rank's step peak {rank['peak_bytes']} is not below "
             f"the single process's {one['peak_bytes']}")
    for r in (rank, one):
        if r["launches"] or r["plain_calls"]:
            fail(f"phase 27: the trainer launched {r['launches']}, plain calls "
                 f"{r['plain_calls']}")
    if sum(prk.LAUNCHES.values()) or sum(prk.PLAIN_CALLS.values()):
        fail(f"phase 27 launched {dict(prk.LAUNCHES)}, plain calls "
             f"{dict(prk.PLAIN_CALLS)}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 27] {out['seconds']:.1f} s (the 8 ranks ready "
        f"{t_ready - ranks['t_launch']:.1f} s after torchrun's start)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-ranks", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    def clock(label):  # seconds since the start, at each phase's end
        log(f"[clock] {label}: {time.perf_counter() - t_run:.1f} s")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.train_ranks:  # a rank of phase 21's torchrun launch
        return train_ranks(args.train_ranks)
    from repro_torch import testing
    from repro_torch.kernels import build, partial_reduce as prk
    from repro_torch.search import DISPATCH_COUNTS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_lines()

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info()
    log(f"build: {time.perf_counter() - t0:.1f} s ({info['command']})")
    one_pass = []
    for row in build.report(info["library"], info["ptxas"]):
        label = kernel_label(row["kernel"])
        log(f"  {label}: {row['registers']} registers, stack frame "
            f"{row['stack']} B, spill stores {row['spill_stores']} B, loads "
            f"{row['spill_loads']} B, static smem {row['smem']} B, "
            f"{row['hgmma']} HGMMA"
            + "".join(f"\n    {w}" for w in row["warnings"]))
        if label.startswith("pr_scan_kernel") and not row["hgmma"]:
            fail(f"{label} has no tensor-core (HGMMA) instruction")
        if label.startswith(("pr_merge_kernel", "pr_scan_kernel")) and (
                row["stack"] or row["spill_stores"] or row["spill_loads"]):
            fail(f"{label} has a stack frame or spills")
        if "1 query part" in label:
            one_pass.append(label)
    if len(one_pass) != 2 * len(ONE_PASS_FORMS):
        fail(f"the build has {len(one_pass)} one-pass scan instantiations, "
             f"not {2 * len(ONE_PASS_FORMS)}: {one_pass}")
    for form in FORMS:
        ks = SIFT_PLAN[form][1]
        log(f"  scan shared memory at d={SIFT['d']}, {form}: fused (k_scan "
            f"{ks}) {prk.scan_smem(form, True, SIFT['d'], ks)}, two-pass "
            f"{prk.scan_smem(form, False, SIFT['d'])}")

    clock("phases 1-2")
    lib = build.load_library()
    empty_ms = queued_ms(lambda: build.check(
        lib, lib.pr_empty(torch.cuda.current_stream().cuda_stream), "empty kernel"))
    log(f"empty kernel launch: {empty_ms:.4f} ms (device time per call, "
        f"queued back to back)")

    names = sorted({n for form in FORMS for n in names_of(form)}
                   | {n for form in ONE_PASS_FORMS for n in names_of(form, 1)})
    acc = {"errs": dict.fromkeys(names, 0.0), "agree": dict.fromkeys(names, 0),
           "total": dict.fromkeys(names, 0)}
    phase_kernels(prk, testing, args.seed, acc)
    phase_merge_ties(prk, testing, args.seed)
    phase_one_pass_kernels(prk, testing, args.seed, acc)
    clock("phase 3")

    results = {"launches": {}, "plain_calls": {}}
    data = {cfg["name"]: make_data(cfg, args.seed + i)
            for i, cfg in enumerate((SIFT, GLOVE))}
    # Each path: the counts set to 0 just before it, read just after.
    prk.reset_counts()
    DISPATCH_COUNTS.clear()
    f32 = {"sift1m": drive(SIFT, data["sift1m"], SIFT["m"], results),
           "glove1.2m": drive(GLOVE, data["glove1.2m"], 2_000, results)}
    read_counts(prk, "f32", ("f32",), results)
    tiers = {}
    for storage in TIERS:
        prk.reset_counts()
        tiers[storage] = drive(SIFT, data["sift1m"], SIFT["m"], results, storage)
        if storage == "int4":
            tiers["glove int4"] = drive(GLOVE, data["glove1.2m"], 2_000, results,
                                        storage)
        read_counts(prk, storage, (storage,), results)
    log(f"searches {dict(DISPATCH_COUNTS)}")
    clock("phases 4-6")

    from repro_torch.search import Index

    sift_q, glove_q = data["sift1m"][1], data["glove1.2m"][1]
    shapes = []
    for cfg, q in ((SIFT, sift_q), (GLOVE, glove_q)):
        fresh = Index.build(data[cfg["name"]][0], metric=cfg["metric"], k=K,
                            recall_target=TARGET, cluster="off")
        shapes += [(f"{cfg['name']} before updates", cfg, fresh, q),
                   (f"{cfg['name']} after updates", cfg, f32[cfg["name"]], q)]
    shapes += [(f"sift1m {s} after updates", SIFT, tiers[s], sift_q) for s in TIERS]
    shapes.append(("glove1.2m int4 after updates", GLOVE, tiers["glove int4"],
                   glove_q[:2_000]))
    phase_main_shapes(prk, testing, shapes, acc)
    clock("phase 7")
    del f32, tiers, shapes
    results["max_abs_err"] = acc["errs"]
    results["index_agreement"] = {k: acc["agree"][k] / max(acc["total"][k], 1)
                                  for k in names}
    sift = data["sift1m"]
    db, q = sift[:2]
    del data
    kernels, row_bytes, merge_rows = [], {}, []
    for storage in FORMS:
        ks, row_bytes[storage] = time_form(prk, testing, db, q, storage, results,
                                           empty_ms, merge_rows)
        kernels += ks
    slow = [r for r in merge_rows if r["ms"] > r["topk_ms"]]
    log(f"merge slower than torch.topk on the same carries at "
        f"{len(slow)} of {len(merge_rows)} plans: "
        f"{[(r['label'], r['m']) for r in slow]}")
    next(k for k in kernels if k["name"] == "fused_carry_merge")["plans"] = [
        {key: r[key] for key in ("label", "m", "splits", "k_scan", "ms",
                                 "topk_ms", "bound_ms")} for r in merge_rows]
    log(f"stored bytes per row at D={SIFT['d']} (beside a 4-byte bias, and "
        f"a 4-byte scale for int8 and int4): {row_bytes}")
    if 2 * row_bytes["int4"] != row_bytes["int8"]:
        fail(f"int4 rows take {row_bytes['int4']} bytes, not half of int8's "
             f"{row_bytes['int8']}")
    clock("phase 8")
    fused = {k["name"]: k for k in kernels}
    bounds = {}
    for form in FORMS:
        entry = fused[names_of(form)[0]]
        bounds[form, SIFT["m"]] = entry["bound_parts"]["tensor_ms"]
        bounds[form, 16] = entry["bound_parts_m16"]["bytes_ms"]
    planner = phase_planner(prk, testing, (db, q),
                            make_data(GLOVE, args.seed + 1)[:2], bounds, results,
                            args.seed)
    clock("phase 9")

    # phase 10: the bf16 compute dtype, each path's counts from 0
    prk.reset_counts()
    for storage in ("f32", "int8", "int4"):
        drive_bf16(sift, storage, results)
    read_counts(prk, "bf16 compute", ONE_PASS_FORMS, results, qparts=1)
    for storage in ("f32", "int8", "int4"):
        kernels += time_one_pass(prk, db, q, storage, results, empty_ms)
    clock("phase 10")
    # phases 11 and 12: cluster pruning
    clusters = {"gaussian": phase_clusters_gaussian(prk, sift, results)}
    del sift, db, q
    clusters["mixture"] = phase_clusters_mixture(prk, args.seed + 7, results)
    clock("phases 11-12")
    # phase 13: serving, one CUDA graph per bucket; phase 14: snapshots
    serve = phase_serve(prk, testing, make_data(SIFT, args.seed), results,
                        args.seed, acc)
    snapshots = phase_snapshots(prk, args.seed + 9, results)
    clock("phases 13-14")
    # phase 15: the host-RAM cold tier
    host_tier = phase_host_tier(prk, testing, make_data(SIFT, args.seed),
                                results, acc)
    clock("phase 15")
    # phase 16: kNN-LM serving at full width; phase 17: the other families
    knn_lm, knn_kernels = phase_knn_lm(prk, testing, args.seed, results, smi)
    families, family_kernels = phase_families(prk, testing, args.seed, results, smi)
    clock("phases 16-17")
    # phase 18: stream=False, logical shards, the FLOP cross-check, the
    # sharded datastore and context-parallel attention
    sharding, shard_kernels = phase_sharding(prk, testing, args.seed, results,
                                             smi)
    clock("phase 18")
    # phase 19: the kNN workload registry, then training on the card
    training = phase_training(prk, args.seed, results, smi)
    clock("phase 19")
    whole_ranks = None
    with tempfile.TemporaryDirectory() as d21:
        # phase 21's two ranks start Python, torch and their CUDA contexts
        # while phase 20 runs, then wait
        ranks = start_distributed(args.seed, d21)  # 21b, 21c and 22 to 26
        try:
            # phase 20: the mesh rules and the dry run
            mesh_dryrun = phase_mesh_and_dryrun(prk, args.seed, smi)
            clock("phase 20")
            # phase 21: training across processes
            distributed = phase_distributed(prk, args.seed, smi, ranks)
            clock("phase 21")
            # phase 22: ZeRO-3 across processes
            zero3 = phase_zero3(prk, smi, ranks)
            clock("phase 22")
            # phase 23: tensor parallelism for embeddings input and whisper
            tp_inputs = phase_tp_inputs(prk, smi, ranks)
            clock("phase 23")
            # phase 24: tensor parallelism for MoE experts and MLA heads
            tp_moe = phase_tp_moe(prk, smi, ranks)
            clock("phase 24")
            # phase 25: tensor parallelism for the recurrent blocks
            tp_recurrent = phase_tp_recurrent(prk, smi, ranks)
            clock("phase 25")
            # phase 26: checkpoints a slab at a time, re-meshing in place
            ckpt = phase_ckpt(prk, smi, ranks, args.seed)
            clock("phase 26")
            # phase 27: a rank of eight with whole attention, counted
            whole_ranks = start_whole(args.seed, os.path.join(d21, "whole"))
            whole = phase_whole(prk, smi, whole_ranks, args.seed)
            clock("phase 27")
        finally:
            stop_ranks(ranks["proc"])
            if whole_ranks is not None:
                stop_ranks(whole_ranks["proc"])
    for k in kernels:
        for key in ("launches", "plain_calls"):
            k[key] = results[key].get(k["name"], 0)
        if k["name"] in acc["errs"]:  # phase 13's bucket shapes included
            k["max_abs_err"] = acc["errs"][k["name"]]
            k["index_agreement"] = (acc["agree"][k["name"]]
                                    / max(acc["total"][k["name"]], 1))
    log(json.dumps({"planner": planner}))
    log(json.dumps({"clusters": clusters}))
    log(json.dumps({"serve": serve, "snapshots": snapshots}))
    log(json.dumps({"host_tier": host_tier}))
    log(json.dumps({"knn_lm": knn_lm}))
    log(json.dumps({"families": families}))
    log(json.dumps({"sharding": sharding}))
    log(json.dumps({"training": training}))
    log(json.dumps({"mesh_and_dryrun": mesh_dryrun}))
    log(json.dumps({"distributed": distributed}))
    log(json.dumps({"zero3": zero3}))
    log(json.dumps({"tp_inputs": tp_inputs}))
    log(json.dumps({"tp_moe": tp_moe}))
    log(json.dumps({"tp_recurrent": tp_recurrent}))
    log(json.dumps({"ckpt": ckpt}))
    log(json.dumps({"whole_tp": whole}))
    log(json.dumps({"kernels": kernels + knn_kernels + family_kernels
                    + shard_kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
