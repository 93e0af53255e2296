#!/usr/bin/env python
"""Time the PyTorch port's scan kernels and carry merge on one CUDA card.

    PYTHONPATH=src python scripts/bench_torch_scan.py [--forms f32,int4]
        [--k 10] [--m 10000,16] [--splits 5,33,123] [--reps 5] [--seed 0]
    PYTHONPATH=src python scripts/bench_torch_scan.py --merge
        [--m 10000,16] [--splits 1,5,123] [--kscan 10,30] [--reps 5]
    PYTHONPATH=src python scripts/bench_torch_scan.py --search [--m 16]
    PYTHONPATH=src python scripts/bench_torch_scan.py --datastore [--m 8,128]

Times the ``repro_torch`` package that ``PYTHONPATH`` names, so two
versions of the port (two checkouts, or a copy with an edited kernel
source) compare by running the script once for each, in one session on
one card, in the order A B B A.  The data are random: N=1,000,000 rows
of D=128, l2, and for each stored form an ``Index`` at ``--k`` (its own
bins and k_scan, as that tier searches).  For each form and batch M it
prints one JSON line: the card and its power limit, the plan, and the
CUDA-event medians of the fused scan, the carry merge and the two-pass
kernel.  ``--splits`` replaces the planner's split count of the row
range by each of the given counts in turn (the cost model of
``kernels.partial_reduce.split_plan`` is fitted to such a sweep).

``--merge`` times the carry merge alone, for each M, split count and
``--kscan``, on carries dense in ties (``repro_torch.testing.tied_carries``;
its time does not depend on the values): the kernel (checked bit for bit
against its plain version first), ``torch.topk`` over the same carries
laid end to end (a yardstick the port never calls), an empty kernel
launch, the merge's launch plan and its byte bound.  The merge's times,
here and beside the scans, are device times per call of calls queued back
to back behind a sleep kernel (a single call's events would time the
host's Python as well).

``--search`` times ``Index.search`` instead, for each form and M (the
index's own plan): one search between two CUDA events (median of at
least 20: what a caller waits), the card's time per search of searches
queued back to back, and the host's time to issue one (nothing in a
search waits for the card, so a loop of them without a synchronize
times the host alone).

``--datastore`` times both scans and the merge at the kNN-LM datastore's
shape instead (chip_smoke.py phase 16: mips, 2^21 Gaussian keys of
D=2048 with room for 65,536 more, k=32), and measures how far the
two-pass kernel's bin winners and its plain version's lie from their
float64 scores (the largest error relative to max(1, |score|), over the
first 8 queries).
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time

import torch

PEAK_HBM_BYTES = 3.35e12  # H100 SXM (NVIDIA data sheet)


def median_ms(fn, reps: int) -> float:
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


def queued_ms(fn, reps: int) -> float:
    """Device time per call of ``fn()``: ``reps`` calls queued behind a
    sleep kernel, so the card runs them back to back; the median of three
    such runs, after one warm-up call."""
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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def forced_plan(prk, splits: int):
    """A stand-in for ``split_plan`` that cuts the row range into about
    ``splits`` bin-aligned splits."""
    def plan(m, n_pad, bin_size, num_sms, *_, **__):
        tiles_per_bin = max(1, bin_size // prk.BLOCK_N)
        groups = n_pad // prk.BLOCK_N // tiles_per_bin
        per = -(-groups // min(splits, groups))
        return per * tiles_per_bin, -(-groups // per)
    return plan


def bench_merge(prk, build, ms, args) -> None:
    """The ``--merge`` sweep: one JSON line per (M, splits, k_scan)."""
    from repro_torch.testing import bits_equal, tied_carries

    lib = build.load_library()

    def empty():
        build.check(lib, lib.pr_empty(torch.cuda.current_stream().cuda_stream),
                    "empty kernel")

    reps = max(args.reps, 20)
    empty_ms = queued_ms(empty, reps)
    splits_list = [int(x) for x in
                   (args.splits or "1,5,16,33,64,82,123,131,196,245").split(",")]
    for m in ms:
        for splits in splits_list:
            for k_scan in [int(x) for x in args.kscan.split(",")]:
                part_v, part_i = tied_carries(splits, m, k_scan, seed=args.seed,
                                              device="cuda")
                got = prk.fused_carry_merge(part_v, part_i)
                want = prk.fused_carry_merge_plain(part_v, part_i)
                if not (bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise SystemExit(f"merge differs from its plain version at "
                                     f"m={m}, splits={splits}, k_scan={k_scan}")
                flat = part_v.permute(1, 0, 2).reshape(m, splits * k_scan).contiguous()
                print(json.dumps(dict(
                    mode="merge", m=m, splits=splits, k_scan=k_scan,
                    plan=prk.merge_plan(splits, k_scan),
                    merge_ms=queued_ms(lambda: prk.fused_carry_merge(
                        part_v, part_i), reps),
                    topk_ms=queued_ms(lambda: torch.topk(flat, k_scan, dim=1), reps),
                    empty_ms=empty_ms,
                    bound_ms=1e3 * 8.0 * (splits + 1) * m * k_scan / PEAK_HBM_BYTES,
                )), flush=True)
                del part_v, part_i, flat


def bench_search(index, form, q, ms, args) -> None:
    """The ``--search`` timings of one index: one JSON line per M."""
    reps = max(args.reps, 20)
    for m in ms:
        qm = q[:m].contiguous()

        def search():
            return index.search(qm)

        search()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            search()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        print(json.dumps(dict(
            mode="search", form=form, k=args.k, k_scan=index.k_scan, m=m,
            single_ms=median_ms(search, reps), device_ms=queued_ms(search, reps),
            host_ms=host_ms)), flush=True)


def bench_datastore(prk, ms, args) -> None:
    """The ``--datastore`` timings and errors: one JSON line per M."""
    from repro_torch.search import Index, pad_queries_to

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    n, d = 1 << 21, 2048
    keys = torch.randn((n, d), generator=g, device="cuda")
    index = Index.build(keys, metric="mips", k=32, cluster="off",
                        capacity=n + 65_536)
    del keys
    pk = index.pack()
    db, bias, bs, ks = pk.db, pk.bias, pk.bin_size, index.k_scan
    q = torch.randn((max(ms), d), generator=g, device="cuda")

    def f64_error(v, i, qm):
        live = v > -1e30
        rows = db[i.long().clamp_min(0)].double()
        exact = (rows @ qm.double()[:, :, None])[..., 0] \
            + bias[0, i.long().clamp_min(0)].double()
        err = (v.double() - exact).abs() / exact.abs().clamp_min(1.0)
        return float(err[live].max())

    q8 = q[:8].contiguous()
    kernel_err = f64_error(*prk.partial_reduce_packed(q8, db, bias, bin_size=bs), q8)
    plain_err = f64_error(*prk.partial_reduce_packed_plain(
        q8, db, bias, bin_size=bs), q8)
    for m in ms:
        qm = q[:m].contiguous()
        qp = pad_queries_to(qm, d).contiguous()
        carries = prk.fused_scan(qp, db, bias, k_scan=ks, bin_size=bs)
        print(json.dumps(dict(
            mode="datastore", n_pad=db.shape[0], d=d, bin_size=bs, k_scan=ks,
            m=m, splits=carries[0].shape[0],
            fused_ms=median_ms(lambda: prk.fused_scan(
                qp, db, bias, k_scan=ks, bin_size=bs), args.reps),
            merge_ms=queued_ms(lambda: prk.fused_carry_merge(*carries),
                               max(args.reps, 20)),
            packed_ms=median_ms(lambda: prk.partial_reduce_packed(
                qm, db, bias, bin_size=bs), args.reps),
            kernel_f64_rel_err=kernel_err, plain_f64_rel_err=plain_err,
        )), flush=True)
        del carries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forms", default="f32,bf16,int8,int4")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--m", default="10000,16")
    ap.add_argument("--splits", default="", help="split counts to force")
    ap.add_argument("--merge", action="store_true",
                    help="time the carry merge alone (see above)")
    ap.add_argument("--kscan", default="10,15,20,30,60",
                    help="k_scan values of the --merge sweep")
    ap.add_argument("--search", action="store_true",
                    help="time Index.search (see above)")
    ap.add_argument("--datastore", action="store_true",
                    help="the kNN-LM datastore's shape (see above)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_scan: needs a CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import partial_reduce as prk
    from repro_torch.search import Index, get_metric, pad_queries_to

    t0 = time.perf_counter()
    build.load_library()
    print(json.dumps({"package": prk.__file__, "card": card(),
                      "build_s": time.perf_counter() - t0}), flush=True)
    ms = [int(x) for x in args.m.split(",")]
    if args.merge:
        bench_merge(prk, build, ms, args)
        return 0
    if args.datastore:
        bench_datastore(prk, ms, args)
        return 0
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = torch.randn((1_000_000, 128), generator=g, device="cuda")
    q = get_metric("l2").prepare_queries(
        torch.randn((max(ms), 128), generator=g, device="cuda"))
    planner = prk.split_plan
    with_width = "width" in inspect.signature(prk.fused_scan).parameters
    for form in args.forms.split(","):
        index = Index.build(rows, metric="l2", k=args.k, cluster="off",
                            storage=form)
        if args.search:
            bench_search(index, form, q, ms, args)
            continue
        pk = index.pack()
        ops = pk.operands()
        db, bias = ops[0], ops[1]
        scale = None if form == "f32" else ops[2]
        d_pad = db.shape[1] * (2 if pk.int4_packed else 1)
        kw = dict(bin_size=pk.bin_size, int4_packed=pk.int4_packed)
        ks = index.k_scan
        if with_width:
            kw_fused = dict(kw, k_scan=ks, width=q.shape[1])
        else:
            kw_fused = dict(kw, k_scan=ks)
        for m in ms:
            qm = q[:m].contiguous()
            qp = pad_queries_to(qm, d_pad).contiguous()
            for s in [int(x) for x in args.splits.split(",") if x] or [None]:
                prk.split_plan = planner if s is None else forced_plan(prk, s)
                try:
                    carries = prk.fused_scan(qp, db, bias, scale, **kw_fused)
                    row = dict(
                        form=form, k=args.k, k_scan=ks, bin_size=pk.bin_size,
                        m=m, splits=carries[0].shape[0],
                        fused_ms=median_ms(lambda: prk.fused_scan(
                            qp, db, bias, scale, **kw_fused), args.reps),
                        merge_ms=queued_ms(lambda: prk.fused_carry_merge(
                            *carries), max(args.reps, 20)),
                        packed_ms=median_ms(lambda: prk.partial_reduce_packed(
                            qm, db, bias, scale, **kw), args.reps))
                finally:
                    prk.split_plan = planner
                print(json.dumps(row), flush=True)
                del carries
        del index, pk, ops, db, bias, scale
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
