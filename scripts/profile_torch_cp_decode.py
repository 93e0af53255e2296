#!/usr/bin/env python3
"""Where a kNN decode step over a long cache spends its time, unsharded and
context-parallel.

Builds a repository config (default internlm2-1.8b at full width, bf16
weights) on the card with random bf16 KV caches of ``--seq`` positions
(default long_500k's 524,288), then runs its greedy kNN decode step at
the last position twice: unsharded, and under ``use_mesh`` of a logical
(1, ``--shards``) mesh of the card with ``cell_rules(cfg, long_500k,
mesh)`` (the paper's §7 path in every attention layer).  For each: the
CUDA-event time of a step (median), then ``torch.profiler`` over the
steps: kernels a step, their summed device time (the device's idle share
is 1 - device time / wall time) and the top device ops.  Run from the
root of a checkout:

  PYTHONPATH=src python scripts/profile_torch_cp_decode.py [--seq 524288]

It prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile


def events_ms(fn, reps: int):
    """Median CUDA-event ms of ``fn()`` over ``reps`` runs."""
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


def profiled(fn, steps: int) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time for e in kernels) / 1e6 / steps
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:10]
    return {"profiled_step_ms": 1e3 * wall,
            "kernels_per_step": len(kernels) / steps,
            "device_ms_per_step": 1e3 * device_s,
            "device_idle_share": 1.0 - device_s / wall,
            "top_device_ops_ms": {e.key: e.device_time_total / 1e3 / steps
                                  for e in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--seq", type=int, default=524_288)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_cp_decode: no CUDA device")
        return 2
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.shardspecs import cell_rules
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import make_mesh, use_mesh

    cfg = get_config(args.arch)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    model = tfm.init_model(cfg, g, device="cuda", dtype=torch.bfloat16)
    shape = (1, args.seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    caches = [attn.KVCache(
        k=torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16),
        v=torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16))
        for _ in range(cfg.num_layers)]
    tokens = torch.randint(0, cfg.vocab_size, (1, 1), generator=g, device="cuda")
    step = M.make_decode_step(cfg, use_knn=True, sample="greedy")
    mesh = make_mesh((1, args.shards), ("data", "model"),
                     devices=["cuda:0"] * args.shards)
    rules = cell_rules(cfg, SHAPES["long_500k"], mesh)

    def unsharded():
        step(model, tokens, caches, args.seq - 1, None)

    def sharded():
        with use_mesh(mesh, rules=rules):
            step(model, tokens, caches, args.seq - 1, None)

    out = {"arch": cfg.name, "seq": args.seq, "shards": args.shards,
           "card": torch.cuda.get_device_name(0),
           "cache_bytes": sum(t.numel() * t.element_size()
                              for c in caches for t in c)}
    for name, fn in (("unsharded", unsharded), ("context_parallel", sharded)):
        fn()  # warm-up
        out[name] = {"step_ms": events_ms(fn, args.steps), **profiled(fn, args.steps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
