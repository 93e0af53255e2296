"""The port's sharding over a mesh of torch devices against the reference's.

``Index.shard`` on the port's CPU mesh of 4 logical shards
(``make_mesh(..., devices=["cpu"] * 4)``) against ``repro.search``'s
sharded index on 4 fake host devices.  The reference side needs
``--xla_force_host_platform_device_count``, so one subprocess a module
(the ``ref`` fixture) builds every reference result at once and publishes
them: mips/l2/cosine x f32/int8/int4 on a 1-D mesh, a (2, 2) mesh with
``batch_axis``, a tuple ``db_axis``, cluster pruning on the mixture corpus
of ``tests/test_torch_cluster.py``, add and delete (mutated unsharded,
then sharded: the reference's sharded ``add`` fails on jax 0.9), the
snapshots both ways, the functional ``mesh=``, ``KNNDatastore(mesh=)`` and
``_knn_decode_attention_cp``.

Parity criteria (ROADMAP): plans exact; values ``allclose``; indices equal
outside the tie positions of ``repro_torch.testing.assert_topk_close``.
The port's ``"torch"`` shards and its ``"cuda"`` shards (the kernels'
plain versions on the CPU) are both held to the reference's one sharded
program.
"""
import os

import numpy as np
import pytest
import torch

from repro.core.binning import plan_bins as ref_plan_bins
from repro.search import plan as ref_plan
from repro_torch.kernels import partial_reduce as prk
from repro_torch.models import attention as attn
from repro_torch.parallel import make_mesh
from repro_torch.retrieval.datastore import KNNDatastore
from repro_torch.search import (
    DISPATCH_COUNTS,
    Index,
    exact_search,
    functional,
    merge_topk,
    plan_search,
)
from repro_torch.testing import assert_topk_close, public_scorer

N, D, M, K = 4000, 32, 24, 7
METRICS = ["mips", "l2", "cosine"]
STORAGES = ["f32", "int8", "int4"]
CN, COMPONENTS = 8192, 64  # the cluster corpus of tests/test_torch_cluster.py
MUT_N0, MUT_ADD = 3000, 1500  # growth past 4096: a capacity block and a shard pad
# internlm2-1.8b's decode attention cut to test size: GQA 2 query heads a
# KV head, S split into 4 context-parallel shards
AB, AH, AKV, AHD, AS, AK = 2, 4, 2, 16, 256, 8


def _data(seed=7, n=N, m=M, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((m, d), dtype=np.float32))


def _mixture(seed=0, n=CN, m=64, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(COMPONENTS, d)) * 2.5
    db = centers[rng.integers(0, COMPONENTS, n)] + rng.normal(size=(n, d))
    q = centers[rng.integers(0, COMPONENTS, m)] + rng.normal(size=(m, d))
    return db.astype(np.float32), q.astype(np.float32)


def _attn_inputs(seed=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((AB, AH, AHD), dtype=np.float32)
    keys = rng.standard_normal((AB, AS, AKV, AHD), dtype=np.float32)
    values = rng.standard_normal((AB, AS, AKV, AHD), dtype=np.float32)
    valid = np.arange(AS) < 200  # a decode 200 positions in
    return q, keys, values, valid


def _mesh(shape=(4,), names=("model",)):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _dead(n):
    return np.arange(0, n, 5)


_CHILD = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.search import Index, functional
from repro.retrieval.datastore import KNNDatastore
from repro.models.attention import _knn_decode_attention_cp

inp = dict(np.load(@INPUTS@))
db, q = jnp.asarray(inp["db"]), jnp.asarray(inp["q"])
mesh1 = jax.make_mesh((4,), ("model",))
mesh2 = jax.make_mesh((2, 2), ("data", "model"))
K = @K@
out = {}

def res(r):
    return np.asarray(r[0]), np.asarray(r[1])

def plan(ix):
    p = ix.kernel_plan
    return dict(db_shards=p.db_shards, ici_bytes=p.ici_bytes, ici_s=p.ici_s,
                flops=p.flops, hbm_bytes=p.hbm_bytes, n=p.n,
                num_bins=p.num_bins, query_block=p.query_block,
                predicted_s=p.predicted_s, bin_size=ix.plan.bin_size,
                expected_recall=ix.expected_recall, capacity=ix.capacity)

for metric in ("mips", "l2", "cosine"):
    for storage in ("f32", "int8", "int4"):
        ix = Index.build(db, metric=metric, k=K, storage=storage,
                         cluster="off", backend="xla").shard(mesh1)
        out["dense", metric, storage] = res(ix.search(q)) + (plan(ix),)
    out["functional", metric] = res(functional.search(q, db, metric=metric,
                                                      k=K, mesh=mesh1))

f32 = Index.build(db, metric="mips", k=K, cluster="off", backend="xla")
out["batch_axis"] = res(f32.shard(mesh2, batch_axis="data").search(q))
out["tuple_axis"] = res(Index.build(db, metric="l2", k=K, cluster="off",
                                    backend="xla")
                        .shard(mesh2, db_axis=("data", "model")).search(q))

mix, mq = jnp.asarray(inp["mix"]), jnp.asarray(inp["mq"])
for metric in ("mips", "l2", "cosine"):
    ix = Index.build(mix, metric=metric, k=10, backend="xla").shard(mesh1)
    out["cluster", metric] = res(ix.search(mq)) + (
        ix.pack().cluster is not None, ix.expected_recall)

for storage in ("f32", "int4"):
    ix = Index.build(db[:@N0@], metric="l2", k=K, storage=storage,
                     cluster="off", backend="xla")
    ix.add(db[@N0@:@N0@ + @ADD@])
    ix.delete(jnp.asarray(inp["dead"]))
    sh = ix.shard(mesh1)
    out["mutate", storage] = res(sh.search(q)) + (plan(sh),)

snap = Index.build(db, metric="cosine", k=K, storage="int8", cluster="off",
                   backend="xla")
snap.delete(jnp.asarray(inp["dead"]))  # before shard: see the module doc
snap = snap.shard(mesh1)
snap.save(@REF_SNAP@)
out["snap_ref"] = res(snap.search(q))
port = Index.restore(@PORT_SNAP@)
out["snap_port"] = (port.spec.backend,) + res(port.shard(mesh1).search(q))

ds = KNNDatastore(db, jnp.asarray(inp["toks"]), mesh2, k=K)
# its lookup's jnp.take of batch-sharded ids fails on jax 0.9: the search
# it runs, then the tokens on the host
dv, di = res(ds.index.search(q))
out["datastore"] = (dv, inp["toks"][di])

a = {k: jnp.asarray(inp["a_" + k]) for k in ("q", "keys", "values", "valid")}
out["attn"] = np.asarray(_knn_decode_attention_cp(
    a["q"], a["keys"], a["values"], a["valid"], k=@AK@, recall_target=0.95,
    mesh=mesh1, cp_axes=("model",), kv_groups=@G@))
publish(out)
"""


def _port_snapshot(path, db, q):
    ix = Index.build(db, metric="l2", k=K, storage="int4", cluster="off",
                     device="cpu").shard(_mesh())
    ix.delete(_dead(N))
    ix.save(path)
    return ix.search(q)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference result, from one subprocess on 4 fake devices, and
    the port's snapshot it restores."""
    from conftest import FakeDeviceRunner

    tmp = tmp_path_factory.mktemp("sharded")
    db, q = _data()
    mix, mq = _mixture()
    aq, akeys, avalues, avalid = _attn_inputs()
    toks = np.random.default_rng(3).integers(0, 1000, N).astype(np.int32)
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, db=db, q=q, mix=mix, mq=mq, dead=_dead(N), toks=toks,
             a_q=aq, a_keys=akeys, a_values=avalues, a_valid=avalid)
    port_snap = os.path.join(tmp, "port_snap")
    port_search = _port_snapshot(port_snap, db, q)
    source = _CHILD
    for key, val in {"@INPUTS@": repr(inputs), "@K@": str(K),
                     "@N0@": str(MUT_N0), "@ADD@": str(MUT_ADD),
                     "@REF_SNAP@": repr(os.path.join(tmp, "ref_snap")),
                     "@PORT_SNAP@": repr(port_snap), "@AK@": str(AK),
                     "@G@": str(AH // AKV)}.items():
        source = source.replace(key, val)
    out = FakeDeviceRunner()(source, n=4, timeout=600)
    out["port_snap_search"] = port_search
    out["ref_snap_path"] = os.path.join(tmp, "ref_snap")
    out["toks"] = toks
    return out


def _close(ref_res, ours, metric, q, db, **tol):
    rv, ri = ref_res[:2]
    assert_topk_close(rv, ri, ours[0].numpy(), ours[1].numpy(),
                      score=public_scorer(metric, q, db), **tol)


# --- dense, every metric and tier, both port backends -------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_dense_matches_reference(ref, metric, storage, backend):
    db, q = _data()
    ix = Index.build(db, metric=metric, k=K, storage=storage, cluster="off",
                     backend=backend, device="cpu").shard(_mesh())
    rv, ri, rplan = ref["dense", metric, storage]
    _close((rv, ri), ix.search(q), metric, q, db)
    # plans exact: the sharded kernel plan and each shard's bins
    p = ix.kernel_plan
    for key in ("db_shards", "ici_bytes", "ici_s", "flops", "hbm_bytes", "n",
                "num_bins", "query_block", "predicted_s"):
        assert getattr(p, key) == rplan[key], key
    assert ix.plan.bin_size == rplan["bin_size"]
    assert ix.expected_recall == rplan["expected_recall"]
    assert ix.capacity == rplan["capacity"]
    pk = ix.pack()
    want = ref_plan_bins(N // 4, min(ix.k_scan, N // 4), 0.95,
                         reduction_input_size_override=N)
    assert all(s.bin_size == want.bin_size and s.n == N // 4
               for s in pk.shards)
    # each shard keeps the layout of the backend the index was built for
    # ("cuda" on the CPU: the kernels' plain versions)
    assert {s.backend for s in pk.shards} == {backend}
    assert repr(ix).endswith("mesh={'model': 4})")


@pytest.mark.parametrize("profile", ["cpu", "a100"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_plan_sharded_fields_equal_reference(profile, storage, shards):
    for m in (None, 16, 10_000):
        kw = dict(n=1 << 20, d=128, k=10, m=m, backend="sharded",
                  device=profile, storage=storage, db_shards=shards)
        ours, theirs = plan_search(**kw), ref_plan.plan_search(**kw)
        for key in ("db_shards", "ici_bytes", "ici_s", "flops", "hbm_bytes",
                    "cops", "predicted_s", "num_bins", "query_block",
                    "k_scan"):
            assert getattr(ours, key) == getattr(theirs, key), (key, m)


def test_plan_sharded_on_h100_prices_the_cuda_shards():
    """On the ``"h100"`` profile each shard is the port's CUDA scan of its
    rows, and each sends its top-``k_scan`` (f32 value, int32 id)."""
    one = plan_search(n=1 << 20, d=128, k=10, m=10_000, backend="cuda",
                      device="h100")
    four = plan_search(n=1 << 20, d=128, k=10, m=10_000, backend="sharded",
                       device="h100", db_shards=4)
    assert four.ici_bytes == 8.0 * 10_000 * 10 * 4
    assert four.ici_s == four.ici_bytes / 450e9
    assert four.flops < one.flops / 3.5
    from repro_torch.search.plan import PlanCache
    assert PlanCache.key(four).endswith("/sh4")


SIFT = dict(n=1_000_000, d=128, k=10, m=10_000, metric="l2",
            recall_target=0.95)


@pytest.mark.parametrize("storage", STORAGES)
def test_h100_plan_of_shards_sharing_a_device_is_the_unsharded_scan(storage):
    """C7: on the ``"h100"`` profile, 4 shards that one device holds are
    scanned one after another (the busiest device's rows are all N) with
    no gather, so the prediction is the unsharded scan's within the
    shards' padding to whole bins (rtol 2e-2; each shard pads its rows)."""
    one = plan_search(**SIFT, storage=storage, backend="cuda", device="h100")
    rep = plan_search(**SIFT, storage=storage, backend="sharded",
                      device="h100", db_shards=4, shards_per_device=4)
    assert rep.db_devices == 1 and rep.shards_per_device == 4
    assert rep.ici_bytes == 0.0 and rep.ici_s == 0.0
    np.testing.assert_allclose(rep.predicted_s, one.predicted_s, rtol=2e-2)
    np.testing.assert_allclose(rep.flops, one.flops, rtol=2e-2)
    # distinct devices (the default): one shard's scan plus the gather
    four = plan_search(**SIFT, storage=storage, backend="sharded",
                       device="h100", db_shards=4)
    assert four.db_devices == 4 and four.ici_s > 0
    assert four.predicted_s < rep.predicted_s / 3.5
    # two devices, two shards each: two shards' scans and the gather of
    # one block a device, half of four devices' (a tier's rescore is
    # priced once: rtol 1e-4)
    two = plan_search(**SIFT, storage=storage, backend="sharded",
                      device="h100", db_shards=4, shards_per_device=2)
    assert two.db_devices == 2 and two.ici_bytes == four.ici_bytes / 2
    np.testing.assert_allclose(two.flops, 2 * four.flops, rtol=1e-4)
    # an uneven layout (2 + 1 + 1 shards): the busiest device's two scans
    # and three devices' blocks
    three = plan_search(**SIFT, storage=storage, backend="sharded",
                        device="h100", db_shards=4, shards_per_device=2,
                        db_devices=3)
    assert three.ici_bytes == 3 * four.ici_bytes / 4
    assert three.flops == two.flops


@pytest.mark.parametrize("profile", ["cpu", "v100", "a100"])
@pytest.mark.parametrize("per_device", [1, 4])
def test_other_profiles_ignore_the_shards_devices(profile, per_device):
    """C7 is repaired on ``"h100"`` only: the other profiles' sharded
    plans stay the reference's field for field, wherever the shards lie."""
    for storage in STORAGES:
        kw = dict(n=1 << 20, d=128, k=10, m=10_000, backend="sharded",
                  device=profile, storage=storage, db_shards=4)
        ours = plan_search(**kw, shards_per_device=per_device)
        theirs = ref_plan.plan_search(**kw)
        for key in ("db_shards", "ici_bytes", "ici_s", "flops", "hbm_bytes",
                    "cops", "predicted_s", "num_bins", "k_scan"):
            assert getattr(ours, key) == getattr(theirs, key), key


def test_index_on_a_mesh_repeating_one_device_prices_the_unsharded_scan():
    """``Index.shard`` over a mesh that names one device four times
    passes the planner the busiest device's shard count and the distinct
    devices: on ``"h100"`` the prediction is the unsharded index's and
    ``ici_s`` is 0; ``explain()`` reports both counts."""
    db, _ = _data()
    base = Index.build(db, metric="l2", k=K, cluster="off", backend="cuda",
                       device="cpu", profile="h100")
    sh = base.shard(_mesh())
    p = sh.kernel_plan
    assert (p.db_shards, p.shards_per_device, p.db_devices) == (4, 4, 1)
    assert p.ici_s == 0.0
    for m in (16, 10_000):
        ours = sh.explain(m=m)
        want = base.explain(m=m)["predicted"]["wall_s"]
        np.testing.assert_allclose(ours["predicted"]["wall_s"], want,
                                   rtol=2e-2)
        assert ours["sharding"]["ici_s"] == 0.0
        assert ours["sharding"]["db_devices"] == 1


@pytest.mark.parametrize("grid, want", [
    (None, (1, None)),
    ([["cuda:0", "cuda:1", "cuda:2", "cuda:3"]], (1, 4)),
    ([["cuda:0", "cuda:0", "cuda:1", "cuda:2"]], (2, 3)),
    ([["cuda:0"] * 4, ["cuda:1"] * 4], (4, 1)),
])
def test_shard_devices_reads_the_busiest_device_and_the_distinct_ones(grid, want):
    """What ``Index._replan`` passes the planner: the shards the busiest
    device of a batch group holds and the distinct devices among them."""
    from repro_torch.search.index import _shard_devices
    assert _shard_devices(grid) == want


# --- meshes: batch axis, tuple db axis -----------------------------------------


def test_batch_axis_2d_matches_reference(ref):
    db, q = _data()
    base = Index.build(db, metric="mips", k=K, cluster="off", device="cpu")
    two = base.shard(_mesh((2, 2), ("data", "model")), batch_axis="data")
    res = two.search(q)
    _close(ref["batch_axis"], res, "mips", q, db)
    one = base.shard(_mesh((2,), ("model",)))
    assert all(torch.equal(a, b) for a, b in zip(res, one.search(q)))
    # rows that do not divide over the batch axis are replicated
    odd = two.search(q[:5])
    assert all(torch.equal(a, b) for a, b in zip(odd, one.search(q[:5])))
    assert two.explain()["sharding"]["batch_axis"] == "data"


def test_tuple_db_axis_matches_reference(ref):
    db, q = _data()
    ix = Index.build(db, metric="l2", k=K, cluster="off", device="cpu").shard(
        _mesh((2, 2), ("data", "model")), db_axis=("data", "model"))
    assert ix.kernel_plan.db_shards == 4
    assert ix.explain()["sharding"]["db_axes"] == ["data", "model"]
    _close(ref["tuple_axis"], ix.search(q), "l2", q, db)


def test_axis_errors():
    ix = Index.build(_data()[0], k=K, cluster="off", device="cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        ix.shard(_mesh(), db_axis="data")
    with pytest.raises(ValueError, match="cannot also shard"):
        ix.shard(_mesh((2, 2), ("data", "model")), batch_axis="model")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        if torch.cuda.is_available():
            pytest.skip("the default devices exist here")
        make_mesh((2,), ("model",))


# --- cluster pruning, mutations, snapshots -------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_clustered_matches_reference(ref, metric):
    db, q = _mixture()
    ix = Index.build(db, metric=metric, k=10, device="cpu").shard(_mesh())
    rv, ri, ref_tables, ref_recall = ref["cluster", metric]
    pk = ix.pack()
    assert (pk.cluster is not None) == ref_tables
    assert ix.expected_recall == ref_recall
    _close((rv, ri), ix.search(q), metric, q, db, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("storage", ["f32", "int4"])
def test_add_delete_matches_reference(ref, storage):
    """The port mutates its sharded index; the reference (whose sharded
    ``add`` fails on jax 0.9) mutates its unsharded one, then shards."""
    db, q = _data()
    ix = Index.build(db[:MUT_N0], metric="l2", k=K, storage=storage,
                     cluster="off", device="cpu").shard(_mesh())
    ix.add(db[MUT_N0:MUT_N0 + MUT_ADD])
    ix.delete(_dead(N))
    rv, ri, rplan = ref["mutate", storage]
    assert ix.capacity == rplan["capacity"] and ix.size == len(ix)
    assert ix.kernel_plan.db_shards == 4 and ix.kernel_plan.n == rplan["n"]
    res = ix.search(q)
    _close((rv, ri), res, "l2", q, db[:MUT_N0 + MUT_ADD])
    assert not set(_dead(N).tolist()) & set(res.indices.numpy().ravel().tolist())
    assert ix.pack().n_local * 4 == ix.capacity


def test_snapshot_reference_to_port(ref):
    db, q = _data()
    r = Index.restore(ref["ref_snap_path"], device="cpu")
    assert r.spec.backend == "sharded" and r.mesh is None
    with pytest.raises(ValueError, match=r"\.shard\(mesh"):
        r.search(q)
    _close(ref["snap_ref"], r.shard(_mesh()).search(q), "cosine", q, db)


def test_snapshot_port_to_reference(ref):
    db, q = _data()
    backend, rv, ri = ref["snap_port"]
    assert backend == "sharded"
    ours = ref["port_snap_search"]
    _close((rv, ri), ours, "l2", q, db)
    # and back: the port's own snapshot restored in the port
    path = os.path.join(os.path.dirname(ref["ref_snap_path"]), "port_snap")
    again = Index.restore(path, device="cpu").shard(_mesh()).search(q)
    assert all(torch.equal(a, b) for a, b in zip(again, ours))


# --- functional, datastore, attention ----------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_functional_mesh_matches_reference(ref, metric):
    db, q = _data()
    res = functional.search(q, db, metric=metric, k=K, mesh=_mesh())
    _close(ref["functional", metric], res, metric, q, db)


def test_datastore_mesh_matches_reference(ref):
    db, q = _data()
    ds = KNNDatastore(db, ref["toks"], _mesh((2, 2), ("data", "model")),
                      k=K, cluster="off")
    assert ds.index.device.type == "cpu"
    scores, toks = ds.lookup(q)
    rs, rt = ref["datastore"]
    np.testing.assert_allclose(scores.numpy(), rs, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(toks.numpy(), rt)


def test_cp_attention_matches_reference(ref):
    q, keys, values, valid = (torch.from_numpy(np.asarray(a))
                              for a in _attn_inputs())
    out = attn._knn_decode_attention_cp(
        q, keys, values, valid, k=AK, recall_target=0.95, mesh=_mesh(),
        cp_axes=("model",), kv_groups=AH // AKV)
    np.testing.assert_allclose(out.numpy(), ref["attn"], rtol=1e-5, atol=1e-5)
    # against the unsharded attention: the same keys where the shards'
    # bins agree with the global ones (here all of them)
    whole = attn.knn_decode_attention(q, keys, values, valid, k=AK,
                                      recall_target=0.95, kv_groups=AH // AKV)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-2,
                               atol=1e-2)


# --- the port's own invariants -------------------------------------------------


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_equals_per_shard_composition(backend, storage):
    """The sharded search is bit for bit the composition of its parts:
    the one-device search of each shard's rows with the recall accounted
    against the global N, its ids offset, then ``merge_topk`` in shard
    order (what chip_smoke's phase 18 holds on the card)."""
    db, q = _data()
    ix = Index.build(db, metric="l2", k=K, storage=storage, cluster="off",
                     backend=backend, device="cpu").shard(_mesh())
    v, i = ix.search(q)
    n_local, parts_v, parts_i = N // 4, [], []
    for j in range(4):
        part = Index.build(db[j * n_local:(j + 1) * n_local], metric="l2",
                           k=K, storage=storage, cluster="off",
                           backend=backend, device="cpu",
                           reduction_input_size_override=N)
        part._k_scan = ix.k_scan if storage != "f32" else K
        pv, pi = part.search(q)
        parts_v.append(-pv)  # back to the internal max convention
        parts_i.append(torch.where(pi >= 0, pi + j * n_local, pi).int())
    mv, mi = merge_topk(torch.cat(parts_v, 1), torch.cat(parts_i, 1), K)
    assert torch.equal(-mv, v) and torch.equal(mi, i)


def test_ties_go_to_the_lowest_global_id():
    rows = np.random.default_rng(5).standard_normal((8, D), dtype=np.float32)
    db = np.tile(rows, (4 * 128, 1))  # every row repeated in every shard
    ix = Index.build(db, metric="mips", k=4, cluster="off", device="cpu",
                     recall_target=0.999).shard(_mesh())
    _, i = ix.search(rows[:3])
    assert i[:, 0].tolist() == [0, 1, 2]


def test_recall_and_dispatch_counts():
    db, q = _data()
    ix = Index.build(db, metric="l2", k=K, cluster="off", device="cpu",
                     backend="cuda").shard(_mesh())
    DISPATCH_COUNTS.clear()
    prk.reset_counts()
    v, i = ix.search(q)
    assert dict(DISPATCH_COUNTS) == {"sharded": 1}
    # four shards, one fused scan each (plain versions on the CPU)
    assert sum(prk.PLAIN_CALLS.values()) == 4 and not prk.LAUNCHES
    _, ei = exact_search(torch.from_numpy(q), torch.from_numpy(db), k=K,
                         metric="l2")
    recall = np.mean([len(set(a) & set(b)) / K
                      for a, b in zip(i.numpy(), ei.numpy())])
    assert recall >= ix.expected_recall - 0.05


def test_refusals():
    db, q = _data()
    host = Index.build(db, k=K, cluster="off", device="cpu",
                       residency="host", hbm_budget_bytes=2 ** 18)
    with pytest.raises(ValueError, match="host-resident"):
        host.shard(_mesh())
    lazy = Index.build(db, k=K, cluster="off", device="cpu",
                       backend="sharded")
    with pytest.raises(ValueError, match=r"\.shard\(mesh"):
        lazy.search(q)
    sh = lazy.shard(_mesh())
    assert sh.search(q).indices.shape == (M, K)
    with pytest.raises(RuntimeError, match="CUDA graphs|eagerly"):
        sh.search_graph(8)


def test_explain_validate_hlo_on_a_shard():
    db, _ = _data()
    ix = Index.build(db, metric="mips", k=K, cluster="off", backend="torch",
                     device="cpu").shard(_mesh())
    rep = ix.explain(m=64, validate_hlo=True)
    assert rep["sharding"]["per_shard_n"] == N // 4
    assert rep["hlo"]["hlo_dot_flops"] == 2 * 64 * (N // 4) * D
    assert rep["hlo"]["flops_ratio"] == pytest.approx(1.0)
    assert len(rep["packed"]["shards"]) == 4
