"""repro_torch.search.functional against repro.search.functional.

The same seeded numpy inputs go through both: the port's plain path
(``backend="torch"`` or ``"auto"`` on the CPU) against the reference's
``"xla"``, and the port's ``"cuda"`` backend (the kernels' plain versions
on the CPU) against ``"pallas"`` in interpret mode.  Values are held at
``repro_torch.testing``'s rtol 1e-5 / atol 1e-4, indices equal up to
near ties (the tie-aware helper); every bin winner
(``aggregate_to_topk=False``) at the same tolerances, indices within
their bin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.search.functional as ref
from repro_torch.core.binning import plan_bins
from repro_torch.search import functional as port
from repro_torch.testing import (
    assert_bin_winners_close,
    assert_topk_close,
    public_scorer,
)

METRICS = ["mips", "l2", "cosine"]
PAIRS = {"torch": "xla", "cuda": "pallas"}


def _data(seed, n=1500, d=40, m=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d), dtype=np.float32),
            rng.standard_normal((n, d), dtype=np.float32))


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_reference(metric, backend):
    q, db = _data(1)
    v, i = port.search(q, db, metric=metric, k=10, backend=backend, device="cpu")
    rv, ri = ref.search(jnp.asarray(q), jnp.asarray(db), metric=metric, k=10,
                        backend=PAIRS[backend])
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer(metric, q, db))


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_row_bias_matches_reference(backend):
    """A caller's bias (here half the rows masked, the rest shifted) on
    top of the metric's: masked rows never come back."""
    q, db = _data(2)
    rng = np.random.default_rng(3)
    bias = np.where(rng.random(db.shape[0]) < 0.5, -1e30,
                    rng.standard_normal(db.shape[0])).astype(np.float32)
    v, i = port.search(q, db, metric="l2", k=10, backend=backend,
                       row_bias=bias, device="cpu")
    rv, ri = ref.search(jnp.asarray(q), jnp.asarray(db), metric="l2", k=10,
                        backend=PAIRS[backend], row_bias=jnp.asarray(bias))
    assert (bias[i.numpy()] > -1e29).all()

    def score(row, idx):  # the reference's value: relaxed distance - bias
        return public_scorer("l2", q, db)(row, idx) - bias[np.asarray(idx)]
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=score)


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("override", [-1, 12_000])
def test_bin_winners_and_override_match_reference(backend, override):
    """``aggregate_to_topk=False``: every bin winner, (m, L) with L the
    plan's, against the reference's; ``reduction_input_size_override``
    plans the bins for a larger (global) N, as a shard does."""
    q, db = _data(4)
    kw = dict(metric="mips", k=10, reduction_input_size_override=override,
              aggregate_to_topk=False)
    v, i = port.search(q, db, backend=backend, device="cpu", **kw)
    rv, ri = ref.search(jnp.asarray(q), jnp.asarray(db), backend=PAIRS[backend],
                        **kw)
    plan = plan_bins(db.shape[0], 10, 0.95, reduction_input_size_override=override)
    rv, ri = np.asarray(rv), np.asarray(ri)
    width = v.shape[1]
    if backend == "torch":
        assert v.shape == rv.shape == (q.shape[0], plan.num_bins)
    else:
        # the port pads N to whole 128-row blocks, the reference's Pallas
        # layout to its larger planned block: its extra bins are padding
        assert width == -(-db.shape[0] // max(plan.bin_size, 128)) * max(
            plan.bin_size, 128) // plan.bin_size
        assert (ri[:, width:] == -1).all()
    assert_bin_winners_close(rv[:, :width], ri[:, :width], v.numpy(),
                             i.numpy(), bin_size=plan.bin_size,
                             score=public_scorer("mips", q, db))


@pytest.mark.parametrize("override", [-1, 12_000])
def test_override_top_k_matches_reference(override):
    q, db = _data(5)
    kw = dict(k=10, reduction_input_size_override=override)
    v, i = port.search(q, db, device="cpu", **kw)
    rv, ri = ref.search(jnp.asarray(q), jnp.asarray(db), backend="xla", **kw)
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer("mips", q, db))


@pytest.mark.parametrize("fn", ["mips", "l2nns", "cosine_nns"])
def test_legacy_entry_points_match_reference(fn):
    q, db = _data(6)
    if fn == "cosine_nns":
        db = db / np.linalg.norm(db, axis=1, keepdims=True)
    metric = {"mips": "mips", "l2nns": "l2", "cosine_nns": "cosine"}[fn]
    v, i = getattr(port, fn)(q, db, 10, device="cpu")
    rv, ri = getattr(ref, fn)(jnp.asarray(q), jnp.asarray(db), 10)
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer(metric, q, db))


def test_l2nns_with_given_half_norms_matches_reference():
    q, db = _data(7)
    hn = port.half_norms(torch.from_numpy(db))
    v, i = port.l2nns(q, db, 10, db_half_norm=hn, device="cpu")
    rv, ri = ref.l2nns(jnp.asarray(q), jnp.asarray(db), 10,
                       db_half_norm=jnp.asarray(hn.numpy()))
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer("l2", q, db))


def test_cuda_backend_on_cpu_is_the_plain_version_of_the_kernels():
    """On CPU tensors the "cuda" backend runs the kernels' plain versions
    (counted as plain calls, nothing launched)."""
    from repro_torch.kernels import partial_reduce as prk

    q, db = _data(8)
    prk.reset_counts()
    port.search(q, db, k=10, backend="cuda", device="cpu")
    assert prk.PLAIN_CALLS["partial_reduce_fused"] == 1 and not prk.LAUNCHES


def test_mesh_and_sharded_raise_item_11():
    """Item 11 is ported: ``mesh=`` searches the rows split over the
    mesh's devices (4 logical shards on the CPU) and agrees with the
    one-device search; ``backend="sharded"`` without a mesh raises."""
    from repro_torch.parallel import make_mesh

    q, db = _data(9, n=64)
    mesh = make_mesh((4,), ("model",), devices=["cpu"] * 4)
    (sv, si), (pv, pi) = (port.search(q, db, k=4, mesh=mesh),
                          port.search(q, db, k=4, device="cpu"))
    assert_topk_close(pv.numpy(), pi.numpy(), sv.numpy(), si.numpy())
    with pytest.raises(ValueError, match="requires a mesh"):
        port.search(q, db, backend="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        port.search(q, db, backend="xla", device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_default_device_is_the_card():
    q, db = _data(10, n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.search(q, db)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.mips(q, db)


def test_exports_equal_reference():
    assert port.__all__ == ref.__all__
    for name in ("exact_mips", "exact_l2nns", "exact_cosine_nns", "exact_search",
                 "half_norms"):
        assert callable(getattr(port, name))
