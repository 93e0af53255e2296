"""Quickstart: the paper's algorithm behind the port's ``repro_torch.search``
API, the counterpart of ``examples/quickstart.py``.

One front door for every metric and backend:

    index = Index.build(db, metric=..., k=..., recall_target=...)
    values, indices = index.search(queries)

Runs MIPS, L2 and cosine search on the ``"torch"`` path and the
``"cuda"`` kernels (their plain versions on the CPU), the frequent-update
path (add and delete with no rebuild) with recall against
``exact_search``, the search-graph counters (``cache_info()``) and the
plan behind the index (``explain()``, with its FLOP cross-check).

  python examples/torch_quickstart.py                    # on the card
  python examples/torch_quickstart.py --device cpu --n 20000
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.search import Index, exact_search  # noqa: E402

K = 10


def recall(approx_idx, exact_idx) -> float:
    return float(np.mean([
        len(set(a.tolist()) & set(e.tolist())) / len(e)
        for a, e in zip(approx_idx.cpu().numpy(), exact_idx.cpu().numpy())
    ]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    g = torch.Generator().manual_seed(args.seed)
    qy = torch.randn((args.m, args.d), generator=g).to(dev)
    db = torch.randn((args.n, args.d), generator=g).to(dev)
    out = {}

    # --- one Index, every metric, both backends ----------------------------
    for metric in ("mips", "l2", "cosine"):
        _, exact = exact_search(qy, db, K, metric=metric)
        for backend in ("torch", "cuda"):  # cuda: plain versions on the CPU
            index = Index.build(db, metric=metric, k=K, recall_target=0.95,
                                backend=backend, cluster="off", device=dev)
            _, idxs = index.search(qy)
            r = out[metric, backend] = recall(idxs, exact)
            print(f"{metric:6s} {backend:5s} recall={r:.3f} "
                  f"(plan E[recall]={index.expected_recall:.3f}, "
                  f"L={index.plan.num_bins} bins of 2^"
                  f"{index.plan.log2_bin_size})")

    # --- frequent updates: no index rebuild --------------------------------
    n0 = args.n * 9 // 10
    index = Index.build(db[:n0], metric="mips", k=K, recall_target=0.95,
                        cluster="off", device=dev)
    index.add(db[n0:])
    _, exact = exact_search(qy, db, K, metric="mips")
    _, idxs = index.search(qy)
    out["after_add"] = recall(idxs, exact)
    print(f"after add:    recall={out['after_add']:.3f} (size={index.size})")
    top1 = exact[:, 0]
    index.delete(top1)
    _, idxs = index.search(qy)
    leaked = set(idxs.cpu().numpy().ravel().tolist()) & set(
        top1.cpu().numpy().tolist())
    out["leaked"] = bool(leaked)
    print(f"after delete: top-1 rows gone={not leaked} (size={index.size})")

    # --- the search graphs (the counterpart of the compile cache) ----------
    if dev.type == "cuda":
        index.replay_graph(index.search_graph(args.m))
        index.replay_graph(index.search_graph(args.m))
    out["cache_info"] = index.cache_info()
    print(f"search graphs: {out['cache_info']}")

    # --- the model-driven plan behind the index ---------------------------
    report = index.explain(m=args.m, validate_hlo=True)
    plan, pred, hlo = report["plan"], report["predicted"], report["hlo"]
    out["flops_ratio"] = hlo["flops_ratio"]
    print(f"plan[{plan['source']}]: tiles=({plan['block_m']}, "
          f"{plan['block_n']}, {plan['query_block']}) "
          f"L={plan['num_bins']}x2^{plan['log2_bin_size']} -> "
          f"{pred['bottleneck']}-bound, attainable "
          f"{pred['attainable_flops'] / 1e12:.1f} TFLOP/s on {pred['device']}; "
          f"counted/model FLOPs={hlo['flops_ratio']:.4f} "
          f"(split passes {hlo['split_passes']})")
    return out


if __name__ == "__main__":
    main()
