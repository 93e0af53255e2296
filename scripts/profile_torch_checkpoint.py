#!/usr/bin/env python3
"""Where a checkpoint's and a re-mesh's seconds go across processes.

Two gloo ranks share ``cuda:0`` (as chip_smoke's phases 21-26 run them).
Each draws its shard of a repository config (default granite-20b at full
width cut to 2 layers, ``fsdp_params``: ZeRO-3 on a (2, 1) mesh) by
shards, then ``cProfile`` runs over a synchronous ``save_checkpoint`` and
over ``remesh_state`` onto (1, 2): each rank's seconds and its top
functions by their own time.  Then the parts those are made of, at
``--gib`` GiB: a gloo gather to rank 0 and an all-gather of host tensors,
and on rank 0 alone pageable and pinned copies from the card, zlib's
CRC-32 (what the zip writer computes over every byte), and a write to
the page cache.  Run from the root of a checkout on the card's machine:

  PYTHONPATH=src python scripts/profile_torch_checkpoint.py [--arch granite-20b --layers 2]

It prints one JSON line (host clock; cProfile adds its cost to every
Python call, not to the native work).
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import os
import pstats
import tempfile
import time
import zlib

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _top(prof: cProfile.Profile, count: int):
    """The ``count`` functions with the most own time: (name, calls, s)."""
    stats = pstats.Stats(prof, stream=io.StringIO())
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:count]
    return [(f"{os.path.basename(f)}:{line}({name})", calls, round(own, 3))
            for (f, line, name), (_, calls, own, _, _) in rows]


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _rank(rank: int, args, store: str, d: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.ft.elastic import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import use_mesh

    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    mesh = D.init_process_mesh(1, device="cuda:0", backend="gloo")
    with use_mesh(mesh):
        state = M.init_train_state(torch.Generator(device="cuda:0").manual_seed(0),
                                   cfg, shardings=SS.train_state_specs(cfg, mesh))
    mine = {"rank": rank}
    for label, fn in (
            ("save", lambda: ck.save_checkpoint(os.path.join(d, "ck"), 1, state)),
            ("remesh", lambda: remesh_state(state, tfm.model_axes(cfg),
                                            D.init_process_mesh(2, device="cuda:0",
                                                                backend="gloo")))):
        dist.barrier()
        prof = cProfile.Profile()
        prof.enable()
        seconds = _timed(fn)
        prof.disable()
        mine[label] = dict(seconds=round(seconds, 3), top=_top(prof, args.top))
    n = args.gib << 28  # f32 values
    host = torch.full((n,), float(rank))
    dist.barrier()
    t0 = time.perf_counter()
    buf = torch.empty((2, n)) if rank == 0 else None
    dist.gather(host, list(buf.unbind(0)) if rank == 0 else None, dst=0)
    mine["gloo_gather_s"] = time.perf_counter() - t0
    del buf
    dist.barrier()
    t0 = time.perf_counter()
    parts = [torch.empty_like(host) for _ in range(2)]
    dist.all_gather(parts, host)
    mine["gloo_all_gather_s"] = time.perf_counter() - t0
    del parts
    if rank == 0:
        card = host.to("cuda:0")
        pinned = torch.empty(n, pin_memory=True)
        mine["pageable_d2h_s"] = _timed(lambda: card.cpu())
        mine["pinned_d2h_s"] = _timed(lambda: pinned.copy_(card))
        view = host.numpy().view("uint8")
        t0 = time.perf_counter()
        zlib.crc32(view)
        mine["crc32_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(os.path.join(d, "write.bin"), "wb") as f:
            for _ in range(4):
                f.write(view)
        mine["page_cache_write_4x_s"] = time.perf_counter() - t0
    every = [None] * 2
    dist.all_gather_object(every, mine)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(dict(arch=args.arch, layers=args.layers, gib=args.gib,
                           ranks=every), f)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--gib", type=int, default=1,
                    help="GiB a rank for the gather, copy, CRC and write parts")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_checkpoint: no CUDA device")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "report.json")
        mp.spawn(_rank, args=(args, os.path.join(d, "store"), d, out), nprocs=2)
        with open(out) as f:
            report = json.load(f)
    report["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
