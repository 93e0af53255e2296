"""``SearchSpec(stream=False)``, the per-block loop, against the one-call
search and the reference's loop.

``Index._search_loop`` is the reference's (``src/repro/search/index.py``):
one search of each ``query_block`` rows on every backend.  Modelled on
``tests/test_packed.py``'s stream-versus-loop parity: the loop is bit for
bit the ``stream=True`` search of the same index (each result row depends
on its query only), it counts one dispatch a block, and it agrees with
the reference's ``stream=False`` index (its ``"xla"`` path, which both
port backends are held to on the CPU) through the near-tie rule.  A host
index streams its waves over the whole batch either way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.search import Index as RefIndex
from repro.search import SearchSpec as RefSpec
from repro_torch.parallel import make_mesh
from repro_torch.search import DISPATCH_COUNTS, Index, SearchSpec
from repro_torch.testing import assert_topk_close, public_scorer

N, D, K, QB = 1024, 32, 7, 8
METRICS = ["mips", "l2", "cosine"]
STORAGES = ["f32", "int8", "int4"]


def _data(m, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D), dtype=np.float32),
            rng.standard_normal((m, D), dtype=np.float32))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("m", [24, 21])  # divisible / ragged by query_block
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_loop_equals_stream_and_reference(metric, storage, backend, m):
    db, q = _data(m)
    kw = dict(metric=metric, k=K, storage=storage, cluster="off",
              query_block=QB)
    stream = Index.build(db, backend=backend, device="cpu", **kw)
    loop = Index.build(db, backend=backend, device="cpu", stream=False, **kw)
    assert not loop.spec.stream and loop.spec.query_block == QB
    DISPATCH_COUNTS.clear()
    res = loop.search(q)
    assert dict(DISPATCH_COUNTS) == {backend: -(-m // QB)}
    assert _same(res, stream.search(q))
    ref = RefIndex.build(jnp.asarray(db), backend="xla",
                         spec=RefSpec(backend="xla", stream=False, **kw))
    rv, ri = ref.search(jnp.asarray(q))
    assert_topk_close(np.asarray(rv), np.asarray(ri), res.values.numpy(),
                      res.indices.numpy(), score=public_scorer(metric, q, db))


def test_loop_under_one_block_is_one_dispatch():
    db, q = _data(5)
    loop = Index.build(db, k=K, cluster="off", device="cpu",
                       spec=SearchSpec(k=K, query_block=QB, stream=False,
                                       cluster="off"))
    DISPATCH_COUNTS.clear()
    loop.search(q)
    assert sum(DISPATCH_COUNTS.values()) == 1


def test_host_index_streams_whole_batch_either_way():
    db, q = _data(24)
    kw = dict(k=K, cluster="off", query_block=QB, residency="host",
              device="cpu", hbm_budget_bytes=2 ** 18)
    stream = Index.build(db, **kw)
    loop = Index.build(db, stream=False, **kw)
    DISPATCH_COUNTS.clear()
    res = loop.search(q)
    assert set(DISPATCH_COUNTS) == {"host"}
    assert _same(res, stream.search(q))


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_sharded_loop_equals_stream(storage):
    db, q = _data(24)
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    kw = dict(k=K, storage=storage, cluster="off", query_block=QB,
              device="cpu")
    stream = Index.build(db, **kw).shard(mesh)
    loop = Index.build(db, stream=False, **kw).shard(mesh)
    DISPATCH_COUNTS.clear()
    res = loop.search(q)
    assert dict(DISPATCH_COUNTS) == {"sharded": 3}
    assert _same(res, stream.search(q))
