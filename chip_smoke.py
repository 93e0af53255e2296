#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  The phases
run in order and the first failure exits non-zero:

  1. the card and toolchain lines;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version, at the small test
     shapes and at the Sift1M shape (512 queries, full N, 10% tombstones);
  4. the main path at the Sift1M shape (N=1,000,000, D=128, l2, k=10,
     recall target 0.95, 10,000 queries): ``Index.build`` -> ``search``
     -> recall against an exact oracle -> ``add`` 10,000 rows ->
     ``delete`` 50,000 ids -> ``search`` again, and the two-pass path
     (``fused_select=False``) against the fused one;
  5. the same at the Glove1.2M shape (N=1,183,514, D=100, cosine), with
     fewer queries after the updates;
  6. launch counts of the main path (every kernel launched, no plain
     version called); then each kernel against its plain version at the
     main path's own shapes (all 10,000 queries, Sift1M and Glove1.2M,
     before and after the updates);
  7. CUDA-event timings at the Sift1M shape, and the launches of one
     search.

It prints the ``kernels`` JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Data is random from
``--seed``; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores (the
# f32 tier may not use TF32), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
DELTA = 1e-6  # Hoeffding false-failure budget of the recall checks

SIFT = dict(name="sift1m", n=1_000_000, d=128, metric="l2", m=10_000)
GLOVE = dict(name="glove1.2m", n=1_183_514, d=100, metric="cosine", m=10_000)
K, TARGET = 10, 0.95


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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def compare_kernels(prk, testing, label, q, db, bias, bs, ks, acc, chunk=512):
    """Each kernel against its plain version on one set of operands, on
    the card.  The plain versions run ``chunk`` queries at a time to
    bound their (chunk, n_pad) score tile; ``acc`` gathers the largest
    difference and the index agreement of each kernel."""
    from repro_torch.search import pad_queries_to

    qp = pad_queries_to(q, db.shape[1]).contiguous()
    score = testing.bias_scorer(q, db, bias)
    v, i = prk.partial_reduce_packed(q, db, bias, bin_size=bs)
    carries = prk.fused_scan(qp, db, bias, k_scan=ks, bin_size=bs)
    fv, fi = prk.fused_carry_merge(*carries)
    torch.cuda.synchronize()
    packed, fused = [], []
    for s in range(0, qp.shape[0], chunk):
        packed.append(prk.partial_reduce_packed_plain(qp[s : s + chunk], db, bias,
                                                      bin_size=bs))
        fused.append(prk.partial_reduce_fused_plain(qp[s : s + chunk], db, bias,
                                                    k_scan=ks, bin_size=bs))
    pv, pi = (torch.cat(t) for t in zip(*packed))
    pfv, pfi = (torch.cat(t) for t in zip(*fused))
    mv, mi = prk.fused_carry_merge_plain(*carries)
    testing.assert_bin_winners_close(pv.cpu(), pi.cpu(), v.cpu(), i.cpu(),
                                     bin_size=bs, score=score)
    testing.assert_topk_close(pfv.cpu(), pfi.cpu(), fv.cpu(), fi.cpu(),
                              score=score)
    if not (torch.equal(mv, fv) and torch.equal(mi, fi)):
        fail(f"{label}: fused_carry_merge differs from its plain version")
    for kernel, a, b, x, y in (("partial_reduce_packed", i, pi, v, pv),
                               ("partial_reduce_fused", fi, pfi, fv, pfv),
                               ("fused_carry_merge", fi, mi, fv, mv)):
        acc["agree"][kernel] += int((a == b).sum())
        acc["total"][kernel] += a.numel()
        acc["errs"][kernel] = max(acc["errs"][kernel], float((x - y).abs().max()))
    log(f"kernels vs plain [{label}]: m={q.shape[0]} n_pad={db.shape[0]} "
        f"bin={bs} k_scan={ks} splits={carries[0].shape[0]}: ok (max |diff| "
        f"packed {float((v - pv).abs().max()):.3g}, fused "
        f"{float((fv - pfv).abs().max()):.3g})")


def phase_kernels(prk, testing, seed, acc):
    """Phase 3: every kernel against its plain version at the small test
    shapes and on 512 queries at the Sift1M shape."""
    cases = dict(testing.KERNEL_CASES)
    cases["sift1m_512"] = dict(m=512, n=SIFT["n"], d=SIFT["d"], bin_size=4096,
                               k_scan=K, dead=0.1, l2=True)
    for name, case in cases.items():
        q, db, bias = testing.packed_operands(**case, seed=seed, device="cuda")
        compare_kernels(prk, testing, name, q, db, bias, case["bin_size"],
                        case["k_scan"], acc)
        del q, db, bias


def phase_main_shapes(prk, testing, data, acc):
    """Phase 6: every kernel against its plain version at the main path's
    own shapes: all of its queries over each shape's index before the
    updates (a fresh build over the same rows) and after them
    (tombstones, appended rows, bins re-planned for the new capacity)."""
    from repro_torch.search import Index, get_metric

    for cfg in (SIFT, GLOVE):
        db, q, updated = data[cfg["name"]]
        fresh = Index.build(db, metric=cfg["metric"], k=K,
                            recall_target=TARGET, cluster="off")
        qm = get_metric(cfg["metric"]).prepare_queries(q)
        for when, index in (("before updates", fresh), ("after updates", updated)):
            pk = index.pack()
            compare_kernels(prk, testing, f"{cfg['name']} M={q.shape[0]} {when}",
                            qm, *pk.operands(), pk.bin_size, K, acc)
        del fresh


def drive(cfg, seed, m_after, results):
    """Phases 4/5: build -> search -> recall -> add -> delete -> search,
    and the two-pass path against the fused one."""
    from repro_torch.search import Index
    from repro_torch.testing import assert_topk_close, public_scorer

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d, metric = cfg["n"], cfg["d"], cfg["metric"]
    db = torch.randn((n, d), generator=g, device="cuda")
    q = torch.randn((cfg["m"], d), generator=g, device="cuda")
    extra = torch.randn((10_000, d), generator=g, device="cuda")
    dead = torch.randperm(n, generator=g, device="cuda")[:50_000]

    t0 = time.perf_counter()
    index = Index.build(db, metric=metric, k=K, recall_target=TARGET,
                        cluster="off")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = index.plan
    log(f"[{cfg['name']}] build {build_s:.2f} s: L={plan.num_bins} bins of "
        f"{plan.bin_size}, E[recall]={plan.expected_recall:.4f}, "
        f"backend={index._resolve_backend()}")
    v, i = index.search(q)
    torch.cuda.synchronize()
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    truth = exact_topk(metric, q, db, live, K)
    r1 = recall(i, truth)
    floor = plan.expected_recall - hoeffding_eps(q.shape[0])
    log(f"[{cfg['name']}] search M={q.shape[0]}: recall {r1:.4f} "
        f"(floor {floor:.4f})")
    if not r1 >= floor:
        fail(f"{cfg['name']}: recall {r1} < {floor}")
    if not torch.isfinite(v).all() or tuple(v.shape) != (q.shape[0], K):
        fail(f"{cfg['name']}: non-finite or misshapen values")

    two_pass = Index.build(db, metric=metric, k=K, recall_target=TARGET,
                           cluster="off", fused_select=False)
    for idx in (index, two_pass):
        idx.add(extra)
        idx.delete(dead)
    plan = index.plan
    qa = q[:m_after]
    v, i = index.search(qa)
    tv, ti = two_pass.search(qa)
    torch.cuda.synchronize()
    rows = torch.cat([db, extra])
    live = torch.ones(rows.shape[0], dtype=torch.bool, device="cuda")
    live[dead] = False
    if torch.isin(i.long(), dead).any():
        fail(f"{cfg['name']}: a deleted id was returned")
    if index.size != n + 10_000 - 50_000:
        fail(f"{cfg['name']}: size {index.size}")
    r2 = recall(i, exact_topk(metric, qa, rows, live, K))
    floor = plan.expected_recall - hoeffding_eps(qa.shape[0])
    log(f"[{cfg['name']}] add 10000 + delete 50000 -> capacity "
        f"{index.capacity}, L={plan.num_bins}: recall {r2:.4f} (floor "
        f"{floor:.4f})")
    if not r2 >= floor:
        fail(f"{cfg['name']}: recall after updates {r2} < {floor}")
    assert_topk_close(v.cpu(), i.cpu(), tv.cpu(), ti.cpu(),
                      score=public_scorer(metric, qa, rows))
    log(f"[{cfg['name']}] fused_select=False agrees with the fused path")
    results[cfg["name"]] = dict(
        build_s=build_s, recall=r1, recall_after_updates=r2,
        expected_recall=index.expected_recall, bins=plan.num_bins,
    )
    return db, q, index


def time_sift(prk, db, q, results):
    """Phase 7: CUDA-event timings at the Sift1M shape (M=10,000), on a
    fresh index over the main path's data (before its updates)."""
    from repro_torch.search import Index, pad_queries_to

    index = Index.build(db, metric=SIFT["metric"], k=K, recall_target=TARGET,
                        cluster="off")
    db, bias = index.pack().operands()
    bs = index.pack().bin_size
    m, (n_pad, d_pad) = q.shape[0], db.shape
    qp = pad_queries_to(q, d_pad).contiguous()
    carries = prk.fused_scan(qp, db, bias, k_scan=K, bin_size=bs)
    splits = carries[0].shape[0]
    flops = 2.0 * m * n_pad * d_pad
    in_bytes = 4.0 * (m * d_pad + n_pad * d_pad + n_pad)
    chunk = 512

    def plain(fn, **kw):
        for s in range(0, m, chunk):
            fn(qp[s : s + chunk], db, bias, bin_size=bs, **kw)

    def merge_plain():
        prk.fused_carry_merge_plain(*carries)

    def gemm():
        torch.backends.cuda.matmul.allow_tf32 = False
        for s in range(0, m, 1000):
            torch.matmul(qp[s : s + 1000], db.T)

    t = {
        "fused": cuda_ms(lambda: prk.fused_scan(qp, db, bias, k_scan=K, bin_size=bs)),
        "merge": cuda_ms(lambda: prk.fused_carry_merge(*carries), reps=20),
        "packed": cuda_ms(lambda: prk.partial_reduce_packed(qp, db, bias, bin_size=bs)),
        "search": cuda_ms(lambda: index.search(q)),
        "fused_plain": cuda_ms(lambda: plain(prk.partial_reduce_fused_plain, k_scan=K), reps=3),
        "packed_plain": cuda_ms(lambda: plain(prk.partial_reduce_packed_plain), reps=3),
        "merge_plain": cuda_ms(merge_plain, reps=20),
        "gemm": cuda_ms(gemm, reps=3),
    }
    prk.reset_counts()
    index.search(q)
    torch.cuda.synchronize()
    per_search = sum(prk.LAUNCHES.values())
    err = results["max_abs_err"]

    def counts(name):
        """Main-path launches and plain calls, and the share of indices
        equal to the plain version's in phases 3 and 6 (the rest are near
        ties)."""
        return dict(launches=results["launches"][name],
                    plain_calls=results["plain_calls"].get(name, 0),
                    index_agreement=results["index_agreement"][name])
    fb = bound_ms(flops, in_bytes + 8.0 * splits * m * K)
    pb = bound_ms(flops, in_bytes + 8.0 * m * (n_pad // bs))
    mb = bound_ms(m * K * splits, 8.0 * (splits + 1) * m * K)
    src = "src/repro_torch/kernels/csrc/partial_reduce.cu"
    ref = "src/repro/kernels/partial_reduce.py"
    kernels = [
        dict(name="partial_reduce_fused", route="cuda", source=src,
             replaces=f"{ref}:417", **counts("partial_reduce_fused"),
             max_abs_err=err["partial_reduce_fused"], ms=t["fused"],
             plain_ms=t["fused_plain"], bound_ms=fb[0], bound_by=fb[1],
             library_ms=None, gemm_ms=t["gemm"]),
        dict(name="fused_carry_merge", route="cuda", source=src,
             replaces=f"{ref}:417", **counts("fused_carry_merge"),
             max_abs_err=err["fused_carry_merge"], ms=t["merge"],
             plain_ms=t["merge_plain"], bound_ms=mb[0], bound_by=mb[1],
             library_ms=None),
        dict(name="partial_reduce_packed", route="cuda", source=src,
             replaces=f"{ref}:352", **counts("partial_reduce_packed"),
             max_abs_err=err["partial_reduce_packed"], ms=t["packed"],
             plain_ms=t["packed_plain"], bound_ms=pb[0], bound_by=pb[1],
             library_ms=None, gemm_ms=t["gemm"]),
    ]
    log(f"timing at M={m}, n_pad={n_pad}, d_pad={d_pad}, bin={bs}, "
        f"splits={splits} (CUDA events, median):")
    for key, ms in t.items():
        log(f"  {key:13s} {ms:10.3f} ms")
    log(f"  fused scan: {flops / t['fused'] / 1e9:.1f} TFLOP/s "
        f"({100 * fb[0] / t['fused']:.1f}% of the {fb[1]} bound), "
        f"{in_bytes / t['fused'] / 1e6:.1f} GB/s; search QPS "
        f"{m / t['search'] * 1e3:.0f} at recall "
        f"{results['sift1m']['recall']:.4f}; launches per search: {per_search}")
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import testing
    from repro_torch.kernels import build, partial_reduce as prk
    from repro_torch.search import DISPATCH_COUNTS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_lines()

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.build_info()['command']})")
    for line in build.build_info()["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    names = ("partial_reduce_fused", "fused_carry_merge", "partial_reduce_packed")
    acc = {"errs": dict.fromkeys(names, 0.0), "agree": dict.fromkeys(names, 0),
           "total": dict.fromkeys(names, 0)}
    phase_kernels(prk, testing, args.seed, acc)

    results = {}
    prk.reset_counts()
    DISPATCH_COUNTS.clear()
    data = {SIFT["name"]: drive(SIFT, args.seed, SIFT["m"], results),
            GLOVE["name"]: drive(GLOVE, args.seed + 1, 2_000, results)}
    results["launches"] = dict(prk.LAUNCHES)
    results["plain_calls"] = dict(prk.PLAIN_CALLS)
    log(f"main path: launches {dict(prk.LAUNCHES)}, plain calls "
        f"{dict(prk.PLAIN_CALLS)}, searches {dict(DISPATCH_COUNTS)}")
    for name in names:
        if prk.LAUNCHES[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if sum(prk.PLAIN_CALLS.values()):
        fail(f"plain versions ran on the main path: {dict(prk.PLAIN_CALLS)}")

    phase_main_shapes(prk, testing, data, acc)
    results["max_abs_err"] = acc["errs"]
    results["index_agreement"] = {k: acc["agree"][k] / acc["total"][k] for k in names}
    db, q, _ = data[SIFT["name"]]
    del data
    kernels = time_sift(prk, db, q, results)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
