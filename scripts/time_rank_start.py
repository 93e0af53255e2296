#!/usr/bin/env python3
"""Where a fresh trainer rank's seconds go before its first step.

Run from the repository root under torchrun, on a machine with a card
(two ranks share ``cuda:0`` over gloo, as chip_smoke's phase 21 runs
them)::

    GLOO_SOCKET_IFNAME=lo python -m torch.distributed.run --standalone \\
        --nproc-per-node=2 scripts/time_rank_start.py det
    GLOO_SOCKET_IFNAME=lo python -m torch.distributed.run --standalone \\
        --nproc-per-node=2 scripts/time_rank_start.py plain

Rank 0 prints one JSON list of (stage, seconds): importing torch and the
trainer, ``torch.use_deterministic_algorithms(True)`` (``det`` only),
the CUDA context, the gloo group, the ("data", "model") device mesh, a
pinned buffer, one all-reduce staged through it, a bf16 matmul and an
embedding's backward.
"""
import json
import os
import sys
import time

marks = [("start", time.perf_counter())]


def mark(stage):
    marks.append((stage, time.perf_counter()))


import torch  # noqa: E402

mark("import torch")
sys.path.insert(0, "src")
from repro_torch.launch import train  # noqa: E402,F401

mark("import train")
if sys.argv[1:] == ["det"]:
    torch.use_deterministic_algorithms(True, warn_only=True)
mark("deterministic")
torch.zeros(1, device="cuda:0")
mark("context")
import torch.distributed as dist  # noqa: E402

dist.init_process_group("gloo", init_method="env://")
mark("init_process_group")
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

init_device_mesh("cuda", (1, dist.get_world_size()),
                 mesh_dim_names=("data", "model"))
mark("device_mesh")
buf = torch.empty(4, dtype=torch.float32, pin_memory=True)
mark("pinned")
one = torch.ones(1, device="cuda:0")
buf[:1].copy_(one)
dist.all_reduce(buf[:1])
one.copy_(buf[:1])
mark("all_reduce")
a = torch.randn(256, 256, device="cuda:0", dtype=torch.bfloat16)
(a @ a).sum().item()
mark("bf16 matmul")
table = torch.randn(10, 4, device="cuda:0", requires_grad=True)
torch.nn.functional.embedding(torch.tensor([[1, 2]], device="cuda:0"),
                              table).sum().backward()
mark("embedding backward")
if int(os.environ.get("RANK", "0")) == 0:
    print(sys.argv[1:], json.dumps([(k, round(t - marks[i][1], 2))
                                    for i, (k, t) in enumerate(marks[1:])]),
          flush=True)
dist.destroy_process_group()
