"""repro_torch.retrieval.datastore against repro.retrieval.datastore.

The same seeded numpy keys, value tokens and queries go into both
datastores: the port's plain path (``"torch"``) against the reference's
``"xla"``, and the port's ``"cuda"`` backend (the kernels' plain versions
on the CPU) against an index of the reference's ``"pallas"`` backend in
interpret mode.  Scores are held at rtol 1e-5 / atol 1e-4 and ids equal
up to the reference's own near ties (``repro_torch.testing``); tokens
are the value tokens of those ids.  ``knn_lm_logits`` at rtol 1e-5 /
atol 1e-6 (a repeated token sums its weights in another order).  The
port's served lookup is held to its own direct lookup (the reference's
served lookup test is a known red, ROADMAP "Reference caveats").
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.search as ref_search
from repro.retrieval import datastore as ref_ds
from repro_torch.retrieval import datastore as port_ds
from repro_torch.search import SearchServer, ServeConfig, VirtualClock
from repro_torch.testing import assert_topk_close, public_scorer

PAIRS = {"torch": "xla", "cuda": "pallas"}


def _data(seed, n=3000, d=24, m=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.integers(0, 500, n).astype(np.int32),
            rng.standard_normal((m, d), dtype=np.float32))


def _pair(keys, toks, backend, **kw):
    ours = port_ds.KNNDatastore(keys, toks, device="cpu", backend=backend,
                                cluster="off", **kw)
    ref = ref_ds.KNNDatastore(jnp.asarray(keys), jnp.asarray(toks), **kw)
    if backend == "cuda":  # the reference's kernel path, interpreted
        ref.index = ref_search.Index.build(
            jnp.asarray(keys), metric=kw.get("metric", "mips"), k=kw.get("k", 32),
            capacity=kw.get("capacity"), backend="pallas", cluster="off")
    return ours, ref


def _check(ours, ref, q, rows, metric="mips"):
    v, i = ours.index.search(q)
    rv, ri = ref.index.search(jnp.asarray(q))
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer(metric, q, rows))
    vals, toks = ours.lookup(q)
    rvals, rtoks = ref.lookup(jnp.asarray(q))
    assert torch.equal(vals, v)
    assert torch.equal(toks, ours.value_tokens[i.long()])
    same = np.asarray(ri) == i.numpy()
    np.testing.assert_array_equal(toks.numpy()[same], np.asarray(rtoks)[same])
    return i


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("metric", ["mips", "l2"])
def test_lookup_matches_reference(backend, metric):
    keys, toks, q = _data(1)
    ours, ref = _pair(keys, toks, backend, k=16, metric=metric)
    assert len(ours) == len(ref) == keys.shape[0]
    _check(ours, ref, q, keys, metric)
    np.testing.assert_array_equal(ours.keys.numpy(), np.asarray(ref.keys))


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_extend_and_forget_match_reference(backend):
    """Extends within the pre-allocated capacity, then past it (growth),
    forgets (repeated ids too): the row space, value tokens and every
    lookup equal the reference's; forgotten ids never come back."""
    keys, toks, q = _data(2, n=2000)
    ours, ref = _pair(keys, toks, backend, k=8, capacity=2500)
    rows = keys
    rng = np.random.default_rng(3)
    for r in (300, 600, 1):
        new = rng.standard_normal((r, keys.shape[1]), dtype=np.float32)
        new_t = rng.integers(0, 500, r).astype(np.int32)
        ours.extend(new, new_t)
        ref.extend(jnp.asarray(new), jnp.asarray(new_t))
        rows = np.concatenate([rows, new])
        dead = rng.integers(0, rows.shape[0], 150)
        ours.forget(dead)
        ref.forget(jnp.asarray(dead))
        assert ours.index.capacity == ref.index.capacity
        assert ours.index.num_appended == ref.index.num_appended == rows.shape[0]
        assert len(ours) == len(ref)
        np.testing.assert_array_equal(ours.value_tokens.numpy(),
                                      np.asarray(ref.value_tokens))
        i = _check(ours, ref, q, np.pad(rows, ((0, ours.index.capacity - rows.shape[0]),
                                               (0, 0))))
        assert not set(i.numpy().ravel().tolist()) & set(dead.tolist())
    with pytest.raises(ValueError, match="keys vs"):
        ours.extend(keys[:3], toks[:2])


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_masked_tail_maps_as_the_reference(backend):
    """Fewer live keys than k: the kernel path returns id -1 there, which
    both map to the last value token (jnp.take's negative index; the
    port's advanced indexing); the plain path returns (MASK, 0, 1, ...)."""
    keys, toks, q = _data(4, n=40)
    ours, ref = _pair(keys, toks, backend, k=8)
    ours.forget(np.arange(35))
    ref.forget(jnp.arange(35))
    vals, tk = ours.lookup(q)
    rvals, rtk = ref.lookup(jnp.asarray(q))
    _, i = ours.index.search(q)
    _, ri = ref.index.search(jnp.asarray(q))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rtk))
    np.testing.assert_allclose(vals.numpy()[:, :5], np.asarray(rvals)[:, :5],
                               rtol=1e-5, atol=1e-4)
    tail = i.numpy()[:, 5:]
    if backend == "cuda":
        assert (tail == -1).all() and (tk.numpy()[:, 5:] == toks[-1]).all()
    else:
        assert (tail == np.arange(3)).all()


def test_stats_keys_equal_reference():
    keys, toks, _ = _data(5, n=500)
    ours, ref = _pair(keys, toks, "torch", k=8, capacity=1024)
    mine, theirs = ours.stats(), ref.stats()
    assert set(theirs) <= set(mine)
    assert set(mine["telemetry"]) == set(theirs["telemetry"])
    assert (mine["capacity"], mine["appended"]) == (theirs["capacity"],
                                                    theirs["appended"])
    server = ours.attach_server(config=ServeConfig(max_batch=16),
                                clock=VirtualClock())
    assert ours.stats()["server"]["max_batch"] == server.max_batch == 16


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_served_lookup_matches_direct(backend):
    keys, toks, q = _data(6)
    ours = port_ds.KNNDatastore(keys, toks, k=8, device="cpu", backend=backend,
                                cluster="off")
    dv, dt = ours.lookup(q)
    server = ours.attach_server(config=ServeConfig(max_batch=32),
                                clock=VirtualClock())
    ticket = server.submit(q[:3])
    sv, st = ours.lookup(q)  # rides the queue behind the other client
    assert ticket.done and server.stats()["batches"] == 1
    _, di = ours.index.search(q)
    si = server.search(q).indices
    assert_topk_close(dv.numpy(), di.numpy(), sv.numpy(), si.numpy(),
                      score=public_scorer("mips", q, keys))
    assert torch.equal(st, ours.value_tokens[si.long()])
    same = (si == di).numpy()
    assert torch.equal(st[same], dt[same])
    ours.extend(keys[:2] * 3, np.array([7, 9]))  # through the mutation gate
    _, new = ours.lookup(keys[:2] * 3)
    assert (new[:, 0].numpy() == [7, 9]).all()
    with pytest.raises(ValueError, match="different Index"):
        other = port_ds.KNNDatastore(keys, toks, k=8, device="cpu")
        ours.attach_server(SearchServer(other.index, clock=VirtualClock()))


def test_knn_lm_logits_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((5, 300), dtype=np.float32) * 3
    scores = rng.standard_normal((5, 16), dtype=np.float32) * 4
    tokens = rng.integers(0, 20, (5, 16)).astype(np.int32)  # many repeats
    for lam, temp in ((0.25, 1.0), (0.6, 3.0)):
        ours = port_ds.knn_lm_logits(torch.from_numpy(logits),
                                     torch.from_numpy(scores),
                                     torch.from_numpy(tokens), lam=lam,
                                     temperature=temp)
        ref = ref_ds.knn_lm_logits(jnp.asarray(logits), jnp.asarray(scores),
                                   jnp.asarray(tokens), lam=lam, temperature=temp)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_mesh_raises_item_11():
    """Item 11 is ported: ``mesh=`` shards the datastore (here 2 logical
    shards on the CPU); a lookup equals the unsharded one's."""
    from repro_torch.parallel import make_mesh

    keys, toks, q = _data(8, n=64)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    sharded = port_ds.KNNDatastore(keys, toks, mesh=mesh, k=4,
                                   cluster="off", device="cpu")
    plain = port_ds.KNNDatastore(keys, toks, k=4, cluster="off",
                                 device="cpu")
    assert sharded.index.mesh is mesh and sharded.mesh is mesh
    assert sharded.index.kernel_plan.db_shards == 2
    (sv, st), (pv, pt) = sharded.lookup(q), plain.lookup(q)
    np.testing.assert_allclose(sv.numpy(), pv.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(st.numpy(), pt.numpy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_default_device_is_the_card():
    keys, toks, _ = _data(9, n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ds.KNNDatastore(keys, toks)
