#!/usr/bin/env python3
"""Where a decode step of the port's serving engine spends its time.

Builds a dense model of the repository (default internlm2-1.8b at full
width, bf16, random weights from --seed) on the card, replays a prompt
through ``ServingEngine`` and then profiles decode steps with
``torch.profiler``: the step's wall time, the CUDA kernels it launches
and their summed device time, so the device's idle share is
1 - device time / wall time.  Run from the root of a checkout:

  PYTHONPATH=src python scripts/profile_torch_decode.py [--knn-attention]

It prints one JSON line per attention mode.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def measure(cfg, model, use_knn: bool, args) -> dict:
    from repro_torch.serving.engine import Request, ServingEngine

    engine = ServingEngine(cfg, model, batch=args.batch, max_seq=args.max_seq,
                           use_knn=use_knn, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    engine.admit([Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, args.prompt)
                          .astype(np.int32), max_new_tokens=10 * args.steps)
                  for i in range(args.batch)])
    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time for e in kernels) / 1e6 / args.steps
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]
    return {
        "attention": "knn" if use_knn else "exact",
        "step_ms": 1e3 * sorted(walls)[len(walls) // 2],
        "profiled_step_ms": 1e3 * wall,
        "kernels_per_step": len(kernels) / args.steps,
        "device_ms_per_step": 1e3 * device_s,
        "device_idle_share": 1.0 - device_s / wall,
        "top_device_ops_ms": {e.key: e.device_time_total / 1e3 / args.steps
                              for e in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--knn-attention", action="store_true",
                    help="profile kNN attention only (default: both modes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = tfm.init_model(cfg, gen, device="cuda", dtype=tfm._compute_dtype(cfg))
    for use_knn in ((True,) if args.knn_attention else (False, True)):
        print(json.dumps(measure(cfg, model, use_knn, args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
