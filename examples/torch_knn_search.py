"""Distributed kNN (paper §7) through the port's search API, the
counterpart of ``examples/knn_search.py``: shard an ``Index`` over a mesh
of torch devices, scan each shard on its device with the recall
accounted against the global N, gather the shards' winners and merge them.

Also shows an add on the sharded index, the cluster-pruned l2 search on a
clusterable corpus, and the kNN-LM datastore over the mesh.  The mesh is
(2, 4) ("data", "model"): the rows split over "model", the queries over
"data".  It needs eight cards; ``--logical`` names one card eight times
(eight logical shards through the same code), ``--device cpu`` eight
logical shards on the CPU.

  python examples/torch_knn_search.py --logical          # one card
  python examples/torch_knn_search.py --device cpu --n 16384
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.parallel import make_mesh  # noqa: E402
from repro_torch.retrieval.datastore import (  # noqa: E402
    KNNDatastore,
    knn_lm_logits,
)
from repro_torch.search import Index, exact_search  # noqa: E402


def recall(a, e) -> float:
    return float(np.mean([
        len(set(x.tolist()) & set(y.tolist())) / len(y)
        for x, y in zip(a.cpu().numpy(), e.cpu().numpy())
    ]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="one device for every shard (default: cuda:0..7)")
    ap.add_argument("--logical", action="store_true",
                    help="eight logical shards on cuda:0")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    devices = None
    if args.logical:
        devices = ["cuda:0"] * 8
    elif args.device is not None:
        devices = [args.device] * 8
    mesh = make_mesh((2, 4), ("data", "model"), devices=devices)
    home = mesh.devices.flat[0]
    print(f"mesh: {dict(mesh.shape)} over "
          f"{sorted({str(d) for d in mesh.devices.flat})}")
    out = {}

    # unit-norm rows, queries drawn from the same distribution
    g = torch.Generator().manual_seed(args.seed)
    full = torch.randn((args.n + 64, 64), generator=g)
    full = (full / full.norm(dim=1, keepdim=True)).to(home)
    db, q = full[:args.n], full[args.n:]

    for metric in ("mips", "l2"):
        index = Index.build(db, metric=metric, k=10, recall_target=0.95,
                            cluster="off", device=home)
        sharded = index.shard(mesh, db_axis="model", batch_axis="data")
        _, idx = sharded.search(q)
        _, exact = exact_search(q, db, 10, metric=metric)
        r = out["recall", metric] = recall(idx, exact)
        print(f"distributed {metric:4s} recall: {r:.3f}  ({sharded!r})")

    # index-free updates work sharded too: append rows, tombstone others
    n0 = args.n - 512
    sharded = Index.build(db[:n0], k=10, cluster="off", device=home).shard(
        mesh, db_axis="model")
    sharded.add(db[n0:])
    _, idx = sharded.search(q)
    _, exact = exact_search(q, db, 10)
    out["after_add"] = recall(idx, exact)
    print(f"after sharded add:   recall={out['after_add']:.3f}")

    # the cluster-pruned scan on a clusterable corpus (the "a100" profile
    # prices it as the reference does; the "h100" one vetoes it at this
    # size), sharded: the tables replicated, each shard scores the slots
    # it owns
    rng = np.random.default_rng(7)
    centers = 3.0 * rng.standard_normal((64, 32)).astype(np.float32)
    cn = max(8192, args.n // 2)
    cdb = torch.from_numpy(centers[rng.integers(0, 64, size=cn)]
                           + rng.standard_normal((cn, 32)).astype(np.float32))
    cq = torch.from_numpy(centers[rng.integers(0, 64, size=256)]
                          + rng.standard_normal((256, 32)).astype(np.float32))
    cdb, cq = cdb.to(home), cq.to(home)
    clustered = Index.build(cdb, metric="l2", k=10, recall_target=0.9,
                            cluster="auto", device=home,
                            profile="a100" if home.type == "cuda" else None)
    clustered = clustered.shard(mesh, db_axis="model")
    info = clustered.explain()["cluster"]
    _, idx = clustered.search(cq)
    _, exact = exact_search(cq, cdb, 10, metric="l2")
    out["cluster"] = recall(idx, exact)
    if info["enabled"]:
        print(f"cluster-pruned l2:   recall={out['cluster']:.3f} "
              f"(expected {info['expected_recall']:.3f} = "
              f"{info['collision_term']:.3f} collision x "
              f"{info['miss_term']:.3f} miss), scanned "
              f"{info['scanned_fraction']:.1%} of N with "
              f"{info['probes']}/{info['num_clusters']} probes")
    else:
        print(f"cluster-pruned l2:   tables not kept, recall="
              f"{out['cluster']:.3f}")

    # kNN-LM: neighbour tokens from the sharded datastore, interpolated
    value_tokens = torch.randint(0, 1000, (db.shape[0],), generator=g)
    store = KNNDatastore(db, value_tokens, mesh, k=16, cluster="off")
    scores, toks = store.lookup(q)
    lm_logits = torch.randn((q.shape[0], 1000), generator=g).to(home)
    mixed = knn_lm_logits(lm_logits, scores, toks, lam=0.25)
    out["finite"] = bool(torch.isfinite(mixed).all())
    print(f"kNN-LM mixed logits: {tuple(mixed.shape)}, finite={out['finite']}")
    return out


if __name__ == "__main__":
    main()
