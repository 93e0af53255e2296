"""Crash-safe index snapshots: ``Index.save`` / ``Index.restore`` of the
port, and snapshots crossing between the port and ``repro.search``.

The port of ``tests/test_faults.py``'s snapshot cases (a round trip
re-runs no preparation, quantization or k-means and searches bit for
bit the same; a fault between the tmp write and the commit leaves the
committed snapshot loadable; ``index.save`` fires before any write;
foreign and future snapshots are refused), and the cross-loads: a
snapshot the reference wrote (its ``"xla"`` or ``"pallas"`` layout)
restores in the port, and one the port wrote restores in the reference
wherever the layouts agree, each searching as the writer did (indices
equal except at ties, through the shared helper).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.search import Index as RefIndex
from repro_torch.checkpoint import save_snapshot
from repro_torch.search import (
    PACK_EVENTS,
    SNAPSHOT_FORMAT,
    SNAPSHOT_VERSION,
    Index,
    SearchServer,
    ServeConfig,
    VirtualClock,
    faults,
)
from repro_torch.search.faults import FatalFault, FaultInjector
from repro_torch.testing import assert_topk_close

D = 16


def _data(seed, n, m=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D), dtype=np.float32),
            rng.standard_normal((m, D), dtype=np.float32))


def _mixture(seed, n, m=12):
    """Clustered rows and queries (16 centers), where cluster="auto" keeps
    its tables."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, D)).astype(np.float32) * 2.5

    def draw(count):
        return centers[rng.integers(0, 16, count)] + rng.standard_normal(
            (count, D), dtype=np.float32)
    return draw(n), draw(m)


@pytest.fixture(autouse=True)
def _clean():
    PACK_EVENTS.clear()
    yield
    faults.uninstall()


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _close(ref, got):
    rv, ri = (np.asarray(x) for x in ref)
    gv, gi = (np.asarray(x) for x in got)
    assert_topk_close(rv, ri, gv, gi)


@pytest.mark.parametrize("storage,dtype", [
    ("f32", None), ("bf16", None), ("int8", None), ("int4", None),
    ("f32", "bfloat16"), ("int8", "bfloat16"),
])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_round_trip_is_bit_identical_without_rebuild(tmp_path, storage, dtype,
                                                     backend):
    db, q = _data(1, 700)
    ix = Index.build(db, metric="l2", k=5, storage=storage, dtype=dtype,
                     backend=backend, capacity=1024, device="cpu")
    ix.add(_data(2, 40)[0])
    ix.delete([3, 5, 700])
    direct = ix.search(q)
    path = ix.save(os.path.join(tmp_path, "snap"))
    PACK_EVENTS.clear()
    restored = Index.restore(path, device="cpu")
    assert dict(PACK_EVENTS) == {"restore": 1}  # nothing prepared or packed
    assert (restored.size, restored.capacity, restored.num_appended) \
        == (ix.size, ix.capacity, ix.num_appended)
    assert restored.spec == ix.spec and restored.k_scan == ix.k_scan
    assert _equal(restored.search(q), direct)
    # the restored index keeps taking updates
    restored.add(_data(3, 5)[0])
    assert restored.size == ix.size + 5


def test_clustered_round_trip_keeps_the_tables(tmp_path):
    db, q = _mixture(4, 12_000)
    ix = Index.build(db, metric="l2", k=10, device="cpu")
    cs = ix.pack().cluster
    assert cs is not None
    direct = ix.search(q)
    path = ix.save(os.path.join(tmp_path, "snap"))
    PACK_EVENTS.clear()
    restored = Index.restore(path, device="cpu")
    assert PACK_EVENTS["cluster_built"] == 0 and PACK_EVENTS["restore"] == 1
    rs = restored.pack().cluster
    assert rs.plan == cs.plan and np.array_equal(rs.counts, cs.counts)
    for name in ("centroids", "centroid_bias", "cluster_rows", "spill_rows"):
        assert torch.equal(getattr(rs, name), getattr(cs, name)), name
    assert restored.kernel_plan.cluster.enabled
    assert _equal(restored.search(q), direct)


def test_commit_fault_leaves_previous_snapshot_loadable(tmp_path):
    db, q = _data(71, 256, 4)
    ix = Index.build(db, metric="mips", k=4, capacity=512, device="cpu")
    before = ix.search(q)
    path = os.path.join(tmp_path, "snap")
    ix.save(path)
    ix.add(_data(73, 8)[0])
    with faults.injected(
            FaultInjector(schedule=[("checkpoint.commit", 1, "fatal")])):
        with pytest.raises(FatalFault):
            ix.save(path)  # crashes after the tmp write, before the rename
    survivor = Index.restore(path, device="cpu")
    assert survivor.size == 256
    assert _equal(survivor.search(q), before)
    ix.save(path)
    assert Index.restore(path, device="cpu").size == 264


def test_index_save_fault_fires_before_any_write(tmp_path):
    ix = Index.build(_data(74, 256)[0], metric="mips", k=4, device="cpu")
    path = os.path.join(tmp_path, "snap")
    with faults.injected(FaultInjector(schedule=[("index.save", 1, "fatal")])):
        with pytest.raises(FatalFault):
            ix.save(path)
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_restore_rejects_foreign_and_future_snapshots(tmp_path):
    alien = os.path.join(tmp_path, "alien")
    save_snapshot(alien, {"x": np.zeros(2)}, {"format": "other.thing"})
    with pytest.raises(ValueError, match="not an index snapshot"):
        Index.restore(alien, device="cpu")
    future = os.path.join(tmp_path, "future")
    save_snapshot(future, {"x": np.zeros(2)},
                  {"format": SNAPSHOT_FORMAT, "version": SNAPSHOT_VERSION + 1})
    with pytest.raises(ValueError, match="version"):
        Index.restore(future, device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    ix = Index.build(_data(75, 64)[0], k=4, device="cpu")
    path = ix.save(os.path.join(tmp_path, "snap"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.restore(path)


def test_restore_then_serve_matches_direct(tmp_path):
    db, q = _data(76, 2048, 6)
    ix = Index.build(db, metric="mips", k=10, backend="torch", device="cpu")
    restored = Index.restore(ix.save(os.path.join(tmp_path, "snap")),
                             device="cpu")
    server = SearchServer(restored, ServeConfig(max_batch=32),
                          clock=VirtualClock())
    _close(ix.search(q), server.submit(q).result())
    server.close()


# --- snapshots across the two packages ---------------------------------------


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
@pytest.mark.parametrize("layout", ["xla", "pallas"])
def test_reference_snapshot_restores_in_the_port(tmp_path, storage, layout):
    db, q = _data(5, 1000)
    ref = RefIndex.build(jnp.asarray(db), metric="mips", k=6, storage=storage,
                         backend=layout, cluster="off", capacity=1024)
    ref.add(jnp.asarray(_data(6, 20)[0]))
    ref.delete(jnp.asarray([1, 2, 3]))
    path = ref.save(os.path.join(tmp_path, "snap"))
    PACK_EVENTS.clear()
    ours = Index.restore(path, device="cpu")
    assert dict(PACK_EVENTS) == {"restore": 1}
    assert (ours.size, ours.capacity, ours.spec.storage, ours.spec.backend) \
        == (ref.size, ref.capacity, storage, {"xla": "torch", "pallas": "cuda"}[layout])
    assert ours.spec.serve_buckets == ref.spec.serve_buckets
    _close(ref.search(jnp.asarray(q)), ours.search(q))


@pytest.mark.parametrize("backend,storage", [
    ("torch", "f32"), ("torch", "int8"), ("torch", "int4"),
    ("cuda", "f32"), ("cuda", "int8"), ("cuda", "int4"),
])
def test_port_snapshot_restores_in_the_reference(tmp_path, backend, storage):
    """The port's "torch" layout is the reference's "xla" one, and its
    "cuda" layout the reference's "pallas" one (int4 written at the
    reference's 256 lanes)."""
    db, q = _data(7, 1000)
    ours = Index.build(db, metric="mips", k=6, storage=storage,
                       backend=backend, capacity=1024, device="cpu")
    ours.add(_data(8, 20)[0])
    ours.delete([1, 2, 3])
    path = ours.save(os.path.join(tmp_path, "snap"))
    ref = RefIndex.restore(path)
    assert (ref.size, ref.capacity, ref.spec.storage) \
        == (ours.size, ours.capacity, storage)
    assert ref.spec.backend == {"torch": "xla", "cuda": "pallas"}[backend]
    _close(ours.search(q), ref.search(jnp.asarray(q)))


def test_clustered_snapshots_cross_both_ways(tmp_path):
    db, q = _mixture(9, 12_000)
    ours = Index.build(db, metric="l2", k=10, backend="torch", device="cpu")
    assert ours.pack().cluster is not None
    ref = RefIndex.restore(ours.save(os.path.join(tmp_path, "ours")))
    assert ref._packed.cluster is not None
    _close(ours.search(q), ref.search(jnp.asarray(q)))
    back = Index.restore(ref.save(os.path.join(tmp_path, "ref")), device="cpu")
    assert back.pack().cluster is not None
    assert _equal(back.search(q), ours.search(q))
