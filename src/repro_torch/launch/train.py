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
cards, or over the one ``--device`` named, such as ``cpu``), places the state by
``launch.shardspecs.train_state_shardings`` and steps under
``parallel.sharding.use_mesh``.  The port has no partitioner: the state
lies whole on the mesh's first device (the ``--device``), and one card
with ``--model-parallel 2`` gives the reference's (1, 1) mesh, so the
losses equal ``--model-parallel 1``'s bit for bit.

CPU-runnable end to end with the smoke configs:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b-smoke \\
      --steps 50 --seq 64 --global-batch 8 --ckpt-dir ckpt --device cpu
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = tfm.resolve_device(args.device)
    cfg = get_config(args.arch)
    # over every visible card for "cuda"; a named card or the CPU alone
    mesh = make_host_mesh(args.model_parallel,
                          devices=None if device == torch.device("cuda") else [device])
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
        state = M.init_train_state(gen, cfg, device=device)
        state_sh = SS.sanitize_tree(SS.train_state_shardings(cfg, mesh), state,
                                    mesh)
        state = place(state, state_sh)
        device = state.params.device

        start = 0
        ck = None
        if args.ckpt_dir:
            ck = AsyncCheckpointer(args.ckpt_dir)
            if latest_step(args.ckpt_dir) is not None:
                state, start = restore_checkpoint(args.ckpt_dir, state,
                                                  shardings=state_sh)
                print(f"[train] resumed from step {start}")

    pf = Prefetcher(src, start_step=start)
    policy = StragglerPolicy()
    losses = []
    metrics = None
    t_last = time.time()
    try:
        for _ in range(start, args.steps):
            step_i, host_batch = pf.next()
            with use_mesh(mesh):
                state, metrics = step_fn(state, to_device(host_batch, device))
            if (step_i + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                losses.append((step_i + 1, loss))
                dt = time.time() - t_last
                t_last = time.time()
                print(
                    f"[train] step={step_i + 1} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"{dt / args.log_every:.3f}s/step"
                )
                act = policy.observe({0: dt / args.log_every})
                if act.kind != "none":
                    print(f"[ft] straggler action: {act}")
            if ck and (step_i + 1) % args.ckpt_every == 0:
                ck.save(step_i + 1, state)
        if ck:
            ck.save(args.steps, state)
            ck.wait()
    finally:
        pf.close()
    final = float(metrics["loss"]) if metrics is not None else None
    if final is None:
        print(f"[train] nothing to do: resumed at step {start} of {args.steps}")
    else:
        print(f"[train] done at step {args.steps}, final loss {final:.4f}")
    return {"start": start, "step": args.steps, "losses": losses,
            "final_loss": final, "state": state, "mesh": mesh}


if __name__ == "__main__":
    main()
