#!/usr/bin/env python3
"""Where a training step of the port spends its time.

Builds a train state of a repository config (default internlm2-1.8b at
full width: f32 masters, the config's compute dtype and remat) on the
card, then times the step's parts with CUDA events over a synthetic
batch: the forward (``loss_fn`` with autograd on), the backward (forward
and backward less the forward), and the rest of the step (gradient
norm, clipping, AdamW: the whole ``make_train_step`` less forward and
backward); then profiles whole steps with ``torch.profiler``: kernels
a step, their summed device time (so the device's idle share is 1 -
device time / wall time) and the top device ops.  Run from the root of a
checkout:

  PYTHONPATH=src python scripts/profile_torch_train.py [--batch 4 --seq 2048]

It prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile


def events_ms(fn, reps: int):
    """Median CUDA-event ms of ``fn()`` over ``reps`` runs (no warm-up)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None, help="override cfg.remat")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device")
        return 2
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.roofline import HARDWARE
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.train import to_device
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    state = M.init_train_state(torch.Generator(device=dev).manual_seed(args.seed),
                               cfg, device=dev)
    src = SyntheticTokenSource(
        cfg.vocab_size, args.seq, args.batch, seed=args.seed,
        input_mode=cfg.input_mode if not cfg.is_encoder_decoder else "tokens",
        d_model=cfg.d_model,
        enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0, mrope=cfg.mrope)
    batch = to_device(src.batch(0), dev)
    step = M.make_train_step(cfg, learning_rate=3e-4,
                             microbatches=args.microbatches)
    for _ in range(2):  # warm-up: allocator, cuBLAS plans
        state, _ = step(state, batch)
    model = state.params

    def forward():  # with autograd on: the saved tensors are made, then freed
        M.loss_fn(model, cfg, batch)

    def forward_backward():
        M.loss_fn(model, cfg, batch).backward()
        for p in model.parameters():
            p.grad = None

    holder = [state]

    def whole():
        holder[0], _ = step(holder[0], batch)

    fwd_ms = events_ms(forward, args.steps)
    fwd_bwd_ms = events_ms(forward_backward, args.steps)
    step_ms = events_ms(whole, args.steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            whole()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time for e in kernels) / 1e6 / args.steps
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:15]
    flops = model_flops(cfg, ShapeConfig("train", args.seq, args.batch, "train"))
    bound_ms = 1e3 * flops / HARDWARE["h100"].peak_flops
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch, "seq": args.seq,
        "microbatches": args.microbatches, "remat": cfg.remat,
        "dtype": cfg.dtype, "card": torch.cuda.get_device_name(0),
        "step_ms": step_ms, "forward_ms": fwd_ms,
        "backward_ms": fwd_bwd_ms - fwd_ms,
        "rest_of_step_ms": step_ms - fwd_bwd_ms,
        "bound_ms": bound_ms, "bound_share": bound_ms / step_ms,
        "profiled_step_ms": 1e3 * wall,
        "kernels_per_step": len(kernels) / args.steps,
        "device_ms_per_step": 1e3 * device_s,
        "device_idle_share": 1.0 - device_s / wall,
        "top_device_ops_ms": {e.key: e.device_time_total / 1e3 / args.steps
                              for e in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
