"""The port's bf16 compute dtype against the reference's, on the CPU.

``SearchSpec(dtype="bfloat16")`` casts rows and queries to bf16 before
preparation.  The same numpy inputs go through
``repro.search.Index(dtype="bfloat16", cluster="off")`` and
``repro_torch.search.Index(dtype="bfloat16")``, the port's ``"torch"``
backend against ``"xla"`` and its ``"cuda"`` backend (the kernels' plain
versions on the CPU) against ``"pallas"`` in interpret mode (``"xla"`` for
l2 over int8/int4: ROADMAP "Reference caveats").

Tolerances.  Prepared rows, codes, scales and rescore rows are bit-equal
(the port rounds bf16 norms where XLA's CPU code rounds them).  Every
path multiplies bf16 values exactly into f32 (the reference's jitted XLA
program keeps its bf16 einsum's f32 sum: XLA's excess precision), so
mips and l2 differ in the order of the f32 sum only: ``rtol = atol =
1e-5``.  cosine normalizes the bf16 queries; the port rounds the result
to bf16, as the compute dtype says, while the reference's jitted search
keeps it in f32 (excess precision again), so its values may differ by
the bf16 rounding of the query: ``rtol = atol = 2^-7``.  Indices are equal
except at the reference's own ties, through ``repro_torch.testing``; the
scorer for that rule scores as a bf16 index does
(``public_scorer(..., dtype="bfloat16")``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.search as ref_search
from repro.kernels.partial_reduce import partial_reduce_fused as ref_fused
from repro_torch.kernels import partial_reduce as prk
from repro_torch.search import Index, SearchSpec, get_metric, quant
from repro_torch.search.metrics import half_norms, l2_normalize
from repro_torch.testing import assert_topk_close, public_scorer

METRICS = ["mips", "l2", "cosine"]
STORAGES = ["f32", "bf16", "int8", "int4"]
PAIRS = {"torch": "xla", "cuda": "pallas"}
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-7)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _ref_backend(backend, metric, storage):
    if backend == "cuda" and metric == "l2" and storage in ("int8", "int4"):
        return "xla"
    return PAIRS[backend]


def _tol(metric):
    """The bf16 rounding of a normalized query for cosine; the order of an
    f32 sum elsewhere."""
    return BF16_TOL if metric == "cosine" else F32_TOL


def _data(seed, n=700, d=24, m=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((m, d), dtype=np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_preparation_bit_equal(metric):
    """Prepared rows and the metric bias of bf16 rows, and the queries,
    are the reference's bit for bit (half_norms, l2_normalize)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2000, 100), dtype=np.float32)
    x *= (10.0 ** rng.uniform(-2, 2, (2000, 1))).astype(np.float32)
    ours = get_metric(metric)
    ref = ref_search.get_metric(metric)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    rows, bias = ours.prepare_database(xt)
    ref_rows, ref_bias = ref.prepare_database(xj)
    assert rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(rows), _np(ref_rows))
    assert (bias is None) == (ref_bias is None)
    if bias is not None:
        np.testing.assert_array_equal(_np(bias), _np(ref_bias))
    np.testing.assert_array_equal(_np(ours.prepare_queries(xt)),
                                  _np(ref.prepare_queries(xj)))
    np.testing.assert_array_equal(_np(half_norms(xt)),
                                  _np(ref_search.metrics.half_norms(xj)))
    np.testing.assert_array_equal(_np(l2_normalize(xt)),
                                  _np(ref_search.metrics.l2_normalize(xj)))


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_packed_state_equals_reference(metric, storage):
    """The packed rows (codes), scales and rescore rows of a bf16-compute
    index are the reference's bit for bit; the fused biases too where they
    are bf16 norms, and within 1e-6 where a quantized tier's bias is an
    f32 sum of the dequantized rows' squares (summed in another order)."""
    rows, _ = _data(3 + STORAGES.index(storage))
    ours = Index.build(rows, metric=metric, k=6, storage=storage,
                       dtype="bfloat16", backend="torch", device="cpu")
    ref = ref_search.Index.build(jnp.asarray(rows), metric=metric, k=6,
                                 storage=storage, dtype="bfloat16",
                                 backend="xla", cluster="off")
    a, b = ours.pack(), ref.pack()
    assert a.compute_dtype == "bfloat16"
    stored = a.rows()
    assert stored.dtype == {"f32": torch.bfloat16, "bf16": torch.bfloat16,
                            "int8": torch.int8, "int4": torch.int8}[storage]
    for x, y in ((stored, b.rows()), (a.scale_row(), b.scale_row()),
                 (a.rescore_db, b.rescore_db), (a.rescore_bias, b.rescore_bias)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(_np(x), _np(y))
    if storage == "f32":
        np.testing.assert_array_equal(_np(a.bias_row()), _np(b.bias_row()))
    else:
        np.testing.assert_allclose(_np(a.bias_row()), _np(b.bias_row()),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_bf16_index_matches_reference(metric, storage, backend):
    """Build, search, add past the capacity, delete, search: the plans and
    results of ``dtype="bfloat16"`` equal the reference's, no deleted id
    returns, and the kernels' path ran the one-pass forms' plain
    versions."""
    rows, q = _data(10 * METRICS.index(metric) + STORAGES.index(storage))
    kw = dict(metric=metric, k=6, recall_target=0.9, storage=storage,
              dtype="bfloat16", capacity=800, capacity_block=512)
    ours = Index.build(rows, device="cpu", backend=backend, **kw)
    ref = ref_search.Index.build(
        jnp.asarray(rows), cluster="off",
        backend=_ref_backend(backend, metric, storage), **kw)
    tol = _tol(metric)
    deleted = set()
    rng = np.random.default_rng(7)
    for step in range(3):
        if step == 1:
            new = rng.standard_normal((300, rows.shape[1]), dtype=np.float32)
            rows = np.concatenate([rows, new])
            for index in (ours, ref):
                index.add(new)
        elif step == 2:
            ids = rng.choice(len(rows), size=400, replace=False)
            deleted.update(ids.tolist())
            for index in (ours, ref):
                index.delete(ids)
        assert dataclasses.astuple(ours.plan) == dataclasses.astuple(ref.plan)
        prk.reset_counts()
        v, i = ours.search(q)
        rv, ri = ref.search(jnp.asarray(q))
        if backend == "cuda":
            assert set(prk.PLAIN_CALLS) >= {
                prk.kernel_name("partial_reduce_fused",
                                "bf16" if storage == "f32" else storage, 1)}
        assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                          score=public_scorer(metric, q, rows, dtype="bfloat16"),
                          **tol)
        assert not deleted & set(i[i >= 0].tolist())
    assert ours.capacity > 800


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_incremental_add_equals_full_pack(backend, storage):
    """``tests/test_quant.py``'s bf16-compute case: rows appended by add
    repeat the full pack's cast-then-prepare-then-quantize order."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((1100, 20), dtype=np.float32)
    kw = dict(metric="l2", k=4, storage=storage, dtype="bfloat16",
              backend=backend, device="cpu", capacity=1280)
    inc = Index.build(rows[:600], **kw)
    inc.add(rows[600:900]).add(rows[900:])
    full = Index.build(rows, **kw)
    a, b = inc.pack(), full.pack()
    for x, y in ((a.db, b.db), (a.bias, b.bias), (a.scale, b.scale),
                 (a.rescore_db, b.rescore_db), (a.rescore_bias, b.rescore_bias)):
        if x is not None:
            np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("form", ["bf16", "int8", "int4"])
def test_one_pass_plain_matches_pallas(form):
    """The one-pass kernels' plain version (bf16 queries widened to f32)
    against the reference's fused Pallas kernel on bf16 queries, in
    interpret mode: values within the f32 sum order, the same winners."""
    rng = np.random.default_rng(11)
    m, n, d, bin_size = 9, 1024, 128, 16
    q = rng.standard_normal((m, d), dtype=np.float32)
    x = rng.standard_normal((n, d), dtype=np.float32)
    bias = rng.standard_normal((1, n), dtype=np.float32)
    scale = None
    db, sc = quant.quantize_rows(torch.from_numpy(x).to(torch.bfloat16), form)
    if form == "int4":
        db = quant.pack_int4_rows(db)
    if sc is not None:
        scale = sc[None, :]
    qb = torch.from_numpy(q).to(torch.bfloat16)
    prk.reset_counts()
    v, i = prk.partial_reduce_fused(qb, db, torch.from_numpy(bias), scale,
                                    k_scan=10, bin_size=bin_size,
                                    int4_packed=form == "int4")
    assert dict(prk.PLAIN_CALLS) == {prk.kernel_name("partial_reduce_fused",
                                                     form, 1): 1}
    ref_db = (jnp.asarray(x).astype(jnp.bfloat16) if form == "bf16"
              else jnp.asarray(db.numpy()))
    rv, ri = ref_fused(
        jnp.asarray(q).astype(jnp.bfloat16), ref_db,
        jnp.asarray(bias), None if scale is None else jnp.asarray(scale.numpy()),
        k_scan=10, bin_size=bin_size, block_m=8, block_n=128, interpret=True,
        int4_packed=form == "int4")
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      **F32_TOL)


def test_front_end_dtype_contract():
    """bf16 queries go with bf16, int8 and int4 rows only; the kernels'
    counters name the one-pass forms apart from the three-pass ones."""
    q = torch.zeros((2, 16), dtype=torch.bfloat16)
    bias = torch.zeros((1, 128))
    with pytest.raises(ValueError, match="bf16 queries need"):
        prk.partial_reduce_packed(q, torch.zeros((128, 16)), bias, bin_size=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prk.partial_reduce_packed(q.half(), torch.zeros((128, 16)), bias,
                                  bin_size=1)
    assert prk.kernel_name("partial_reduce_fused", "bf16", 1) != \
        prk.kernel_name("partial_reduce_fused", "bf16")
    assert SearchSpec(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="dtype"):
        SearchSpec(dtype="float16")
