"""Production-shaped training entry point.

Wires together: config registry -> data pipeline (prefetched, per-host
sharded) -> train step on the device -> async checkpointing -> auto-resume
-> straggler tracking.

Port of ``src/repro/launch/train.py`` with its flags, and ``--device``
(default "cuda", which must exist; "cpu" runs on the CPU).  Batches move
to the card through pinned host memory.  The model's f32 master weights
are drawn on the device from ``--seed``; each step computes in the
config's dtype.  As the reference does, the run builds a host mesh
(``launch.mesh.make_host_mesh(--model-parallel)``: over the visible
cards, or over the one ``--device`` named, such as ``cpu``), places the
state by its sanitized shardings
(``launch.shardspecs.train_state_specs``) and steps under
``parallel.sharding.use_mesh``.  In one process the port has no
partitioner: the state lies whole on the mesh's first device (the
``--device``), and one card with ``--model-parallel 2`` gives the
reference's (1, 1) mesh, so the losses equal ``--model-parallel 1``'s bit
for bit.

Under torchrun (``WORLD_SIZE`` set) the run is one process a device:
``parallel.distributed.init_process_mesh(--model-parallel)`` lays the
ranks out as a ("data", "model") mesh, every rank draws the state from
``--seed`` on its device by shards (``models.model.init_train_state(...,
shardings=)``: each leaf whole in turn, its shard kept; the values of
placing the whole draw), takes its rows of each global batch
(``distributed.local_batch``) and steps; the gradients are reduced over
the mesh, tensor parallelism (Megatron's, over "model") runs for every
layer kind (MoE splits its experts, MLA its heads, the SSD its heads,
RG-LRU its channels), and the ``fsdp_params`` archs' parameters are
split over the data axis too (ZeRO-3, ``parallel.zero3``: gathered a
layer at a time, their gradients reduce-scattered).  The default device
is ``cuda:{LOCAL_RANK}`` (it must exist); ``--dist-backend gloo`` lets
ranks share one card (``--device cuda:0``) or run on the CPU
(``--device cpu``, where gloo is the default).  Rank 0 logs, writes
the checkpoints (the reference's format: each slab gathered to it on
the checkpointer's thread of every rank, over gloo groups of its own,
``checkpoint.AsyncCheckpointer``) and ``--report``.  A run resumes from
``--ckpt-dir`` at any process count: to change the count, stop and
relaunch torchrun with the same ``--ckpt-dir`` (the shards of any mesh
restore a slab at a time; re-meshing in place over the same ranks is
``ft.elastic.remesh_state``).

CPU-runnable end to end with the smoke configs:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b-smoke \\
      --steps 50 --seq 64 --global-batch 8 --ckpt-dir ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch internlm2-1.8b-smoke --model-parallel 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticTokenSource
from repro_torch.ft.straggler import StragglerPolicy
from repro_torch.launch import shardspecs as SS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.parallel import distributed as D
from repro_torch.parallel.sharding import place, use_mesh


def to_device(host_batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: through pinned memory, copied without
    blocking the host, on a card; as it is on the CPU."""
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda (cuda:{LOCAL_RANK} under torchrun); cpu")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="under torchrun: nccl (cards) or gloo (the CPU, or "
                         "ranks sharing one card)")
    ap.add_argument("--deterministic", action="store_true",
                    help="PyTorch's deterministic algorithms (the embedding's "
                         "backward otherwise adds with atomics on a card)")
    ap.add_argument("--report", default=None,
                    help="rank 0 writes the run's numbers here as JSON")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    env = D.torchrun_env()
    if env is None:
        device = tfm.resolve_device(args.device or "cuda")
    else:
        device = tfm.resolve_device(args.device or f"cuda:{env[2]}")
    cfg = get_config(args.arch)
    if env is None:
        # over every visible card for "cuda"; a named card or the CPU alone
        mesh = make_host_mesh(args.model_parallel,
                              devices=None if device == torch.device("cuda")
                              else [device])
    else:
        mesh = D.init_process_mesh(args.model_parallel, device=device,
                                   backend=args.dist_backend)
    lead = not D.is_process_mesh(mesh) or mesh.rank == 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_mesh = time.perf_counter()
    sched = cosine_schedule(args.lr, args.warmup, args.steps)
    step_fn = M.make_train_step(
        cfg, learning_rate=sched,
        grad_dtype="bfloat16" if args.grad_compression else None,
    )

    src = SyntheticTokenSource(
        cfg.vocab_size, args.seq, args.global_batch, seed=args.seed,
        input_mode=cfg.input_mode if not cfg.is_encoder_decoder else "tokens",
        d_model=cfg.d_model,
        enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
        mrope=cfg.mrope,
    )

    with use_mesh(mesh):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state_sh = SS.train_state_specs(cfg, mesh)
        if D.is_process_mesh(mesh):  # drawn by shards
            state = M.init_train_state(gen, cfg, shardings=state_sh)
        else:
            state = place(M.init_train_state(gen, cfg, device=device), state_sh)
        device = state.params.device

        start = 0
        ck = None
        if args.ckpt_dir:
            # every rank: its groups are made here, by all ranks
            ck = AsyncCheckpointer(args.ckpt_dir,
                                   mesh=mesh if D.is_process_mesh(mesh) else None)
            at = latest_step(args.ckpt_dir)
            if D.is_process_mesh(mesh):  # every rank resumes rank 0's step
                at = torch.tensor([-1 if at is None else at], device=device)
                at = int(D.broadcast(at, 0, mesh=mesh).item())
                at = None if at < 0 else at
            if at is not None:
                state, start = restore_checkpoint(args.ckpt_dir, state, step=at,
                                                  shardings=state_sh)
                if lead:
                    print(f"[train] resumed from step {start}")

    pf = Prefetcher(src, start_step=start)
    policy = StragglerPolicy()
    losses, norms, step_s, collectives = [], [], [], []
    t_init = time.perf_counter()
    D.reset_collectives()
    metrics = None
    t_last = time.time()
    init_peak = 0
    if device.type == "cuda":
        init_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    try:
        for _ in range(start, args.steps):
            step_i, host_batch = pf.next()
            if D.is_process_mesh(mesh):
                host_batch = D.local_batch(host_batch, mesh)
            t_step = time.perf_counter()
            with use_mesh(mesh):
                state, metrics = step_fn(state, to_device(host_batch, device))
            if (step_i + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                step_s.append(time.perf_counter() - t_step)
                collectives.append(D.reset_collectives())
                losses.append((step_i + 1, loss))
                norms.append((step_i + 1, gnorm))
                dt = time.time() - t_last
                t_last = time.time()
                if lead:
                    print(f"[train] step={step_i + 1} loss={loss:.4f} "
                          f"gnorm={gnorm:.3f} {dt / args.log_every:.3f}s/step")
                act = policy.observe({0: dt / args.log_every})
                if act.kind != "none" and lead:
                    print(f"[ft] straggler action: {act}")
            if ck and (step_i + 1) % args.ckpt_every == 0:
                ck.save(step_i + 1, state)
        if ck:
            ck.save(args.steps, state)
            ck.wait()
    finally:
        pf.close()
    final = float(metrics["loss"]) if metrics is not None else None
    if D.is_process_mesh(mesh):
        D.barrier(mesh)  # rank 0's checkpoint is committed for every rank
    if lead and final is None:
        print(f"[train] nothing to do: resumed at step {start} of {args.steps}")
    elif lead:
        print(f"[train] done at step {args.steps}, final loss {final:.4f}")
    out = {"start": start, "step": args.steps, "losses": losses,
           "grad_norms": norms, "final_loss": final, "state": state,
           "mesh": mesh}
    if args.report:
        phases = {"mesh": t_mesh - t_start, "init": t_init - t_mesh,
                  "total": time.perf_counter() - t_start}
        _report(args.report, out, mesh, device, step_s, collectives, phases,
                init_peak, lead)
    return out


def _report(path: str, out: dict, mesh, device, step_s, collectives, phases,
            init_peak: int, lead: bool) -> None:
    """``--report``: the run's logged losses, grad norms and step seconds
    (host clock, the step's result read), rank 0's collectives in each
    logged step (``parallel.distributed.COLLECTIVES``; ZeRO-3's under
    ``all_gather[...]`` and ``reduce_scatter[...]``), the seconds to the
    mesh, to the state and in all, the mesh, and each rank's peak device
    memory in the steps and, before them, in drawing
    and placing the state (``init_peak_bytes``), beside the bytes of its
    parameters and moments (``state_bytes``; vectors over the ranks) and
    the largest whole parameter's f32 bytes (``largest_leaf_bytes``), as
    JSON by rank 0."""
    from repro_torch.kernels import partial_reduce as prk

    world = mesh.size if D.is_process_mesh(mesh) else 1
    rank = mesh.rank if D.is_process_mesh(mesh) else 0
    state = out["state"]
    tensors = [*state.params.parameters(), *state.opt_state.m.values(),
               *state.opt_state.v.values()]
    peaks = torch.zeros(3, world, dtype=torch.float64, device=device)
    peaks[2, rank] = sum(t.numel() * t.element_size() for t in tensors)
    if device.type == "cuda":
        peaks[0, rank] = torch.cuda.max_memory_allocated(device)
        peaks[1, rank] = init_peak
    if D.is_process_mesh(mesh):
        D.all_reduce(peaks, mesh.axis_names, mesh=mesh)
    if not lead:
        return
    report = {
        "mesh": dict(mesh.shape), "world": world, "device": str(device),
        "backend": getattr(mesh, "backend", None),
        "losses": out["losses"], "grad_norms": out["grad_norms"],
        "step_s": step_s, "collectives": collectives, "seconds": phases,
        "peak_bytes": [int(x) for x in peaks[0].tolist()],
        "init_peak_bytes": [int(x) for x in peaks[1].tolist()],
        "state_bytes": [int(x) for x in peaks[2].tolist()],
        "largest_leaf_bytes": 4 * max(
            math.prod(p.shape)
            for p in tfm.Transformer(state.params.cfg, device="meta").parameters()),
        "launches": dict(prk.LAUNCHES), "plain_calls": dict(prk.PLAIN_CALLS),
    }
    with open(path, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
