"""The port's quantized storage tiers against the reference's, on the CPU.

The same numpy inputs go through ``repro.search.quant`` and
``repro_torch.search.quant`` (codes and scales must be bit-equal), through
the Pallas kernels in interpret mode and the port's plain kernel versions
for every stored form, and through whole indexes:
``repro_torch.search.Index(storage=...)`` against
``repro.search.Index(storage=..., cluster="off")``, the port's ``"torch"``
backend against ``"xla"`` and its ``"cuda"`` backend (plain versions on
the CPU) against ``"pallas"``.  Values are compared with rtol/atol 1e-5
(f32 sums in another order) and indices through the near-tie rule of
``repro_torch.testing``.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.search as ref_search
from repro.kernels.partial_reduce import partial_reduce_fused as ref_fused
from repro.kernels.partial_reduce import partial_reduce_packed as ref_packed
from repro.search import quant as ref_quant
from repro.search.metrics import get_metric as ref_get_metric
from repro.search.packed import snapshot_state
from repro.search.stages import rescore_candidates as ref_rescore
from repro_torch.kernels import partial_reduce as prk
from repro_torch.search import (
    Index,
    SearchSpec,
    cuda_search_packed_quant,
    dense_search_quant,
    exact_search,
    get_metric,
    quant,
    rescore_candidates,
    state_from_arrays,
)
from repro_torch.testing import (
    KERNEL_CASES,
    assert_bin_winners_close,
    assert_topk_close,
    bias_scorer,
    packed_operands,
    public_scorer,
    stored_operands,
)

TIERS = ["bf16", "int8", "int4"]
METRICS = ["mips", "l2", "cosine"]
PAIRS = {"torch": "xla", "cuda": "pallas"}
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    """A tensor or jax array as a numpy array (bf16 widened to f32)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32)
                      if t.dtype == jnp.bfloat16 else t)


def _rows(seed, n=300, d=33):
    """Rows over six decades of scale, an all-zero row, and a row whose
    int8 codes are exact halves (round half to even decides them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= (10.0 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)
    x[3] = 0.0
    x[5, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[5, 6:] = 0.0
    return x


# --- quant primitives ---------------------------------------------------------


@pytest.mark.parametrize("storage", ["f32"] + TIERS)
def test_quantize_rows_bit_equal(storage):
    x = _rows(1)
    ours, scale = quant.quantize_rows(torch.from_numpy(x), storage)
    ref, ref_scale = ref_quant.quantize_rows(jnp.asarray(x), storage)
    assert ours.dtype == quant.storage_dtype(storage)
    np.testing.assert_array_equal(_np(ours), _np(ref))
    assert (scale is None) == (ref_scale is None)
    if scale is not None:
        np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
        np.testing.assert_array_equal(
            quant.dequantize_rows(ours, scale).numpy(),
            np.asarray(ref_quant.dequantize_rows(ref, ref_scale)))
    if storage == "int8":  # the exact halves rounded to even
        assert ours[5, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("d", [1, 6, 33, 128])
def test_int4_pack_unpack(d):
    codes = np.random.default_rng(d).integers(-7, 8, (9, d)).astype(np.int8)
    ours = quant.pack_int4_rows(torch.from_numpy(codes))
    ref = ref_quant.pack_int4_rows(jnp.asarray(codes))
    assert tuple(ours.shape) == (9, (d + 1) // 2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    back = quant.unpack_int4_rows(ours)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(ref_quant.unpack_int4_rows(ref)))
    np.testing.assert_array_equal(back[:, :d].numpy(), codes)
    assert (back[:, d:] == 0).all()


def test_tier_bookkeeping_matches_reference():
    for storage in ["f32"] + TIERS:
        assert quant.storage_bytes(storage) == ref_quant.storage_bytes(storage)
        assert quant.is_quantized(storage) == ref_quant.is_quantized(storage)
        for k in (1, 7, 10, 33):
            for n in (None, 5, 1000):
                assert quant.scan_k(storage, k, n=n) == ref_quant.scan_k(
                    storage, k, n=n)
    with pytest.raises(ValueError, match="unknown storage"):
        quant.storage_bytes("fp8")
    narrow = dataclasses.replace(get_metric("cosine"), name="raw",
                                 storage_tiers=("f32", "bf16"))
    quant.check_metric_storage(narrow, "bf16")
    with pytest.raises(ValueError, match="does not support storage"):
        quant.check_metric_storage(narrow, "int8")
    with pytest.raises(ValueError, match="expected torch.int8"):
        quant.validate_restored("int4", torch.float32, has_scale=True)
    with pytest.raises(ValueError, match="missing its per-row scale"):
        quant.validate_restored("int8", torch.int8, has_scale=False)
    with pytest.raises(ValueError, match="unexpected scale"):
        quant.validate_restored("bf16", torch.bfloat16, has_scale=True)


@pytest.mark.parametrize("storage", TIERS)
@pytest.mark.parametrize("metric", METRICS)
def test_prepare_storage_matches_reference(metric, storage):
    """Codes and scales are bit-equal on the same prepared rows.  cosine's
    preparation divides by a norm that XLA and PyTorch sum in another
    order (one ulp apart), so its own codes may differ where a prepared
    value sits on a rounding boundary; mips and l2 prepare exactly."""
    x = _rows(2, d=24)
    ours = get_metric(metric).prepare_storage(torch.from_numpy(x), storage)
    ref = ref_get_metric(metric).prepare_storage(jnp.asarray(x), storage)
    np.testing.assert_allclose(ours.exact_rows.numpy(), np.asarray(ref.exact_rows),
                               **TOL)
    same_input = quant.quantize_rows(torch.from_numpy(np.array(ref.exact_rows)),
                                     storage)
    pairs = [(same_input, (ref.rows, ref.scale))]
    if metric != "cosine":
        pairs.append(((ours.rows, ours.scale), (ref.rows, ref.scale)))
    for (rows, scale), (ref_rows, ref_scale) in pairs:
        np.testing.assert_array_equal(_np(rows), _np(ref_rows))
        if ref_scale is not None:
            np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    for a, b in ((ours.bias, ref.bias), (ours.exact_bias, ref.exact_bias)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# --- kernels: plain versions of every stored form against Pallas --------------


@pytest.mark.parametrize("form", TIERS)
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_stored_plain_matches_pallas(name, form):
    case = KERNEL_CASES[name]
    q, db, bias = packed_operands(**case, seed=len(name) + 7)
    stored, scale, packed, widened = stored_operands(db, form)
    score = bias_scorer(q, widened, bias)
    bs, k_scan = case["bin_size"], case["k_scan"]
    n_pad = db.shape[0]
    jargs = [jnp.asarray(_np(t)) if t.dtype != torch.bfloat16
             else jnp.asarray(_np(t), jnp.bfloat16)
             for t in (q, stored, bias)]
    jscale = None if scale is None else jnp.asarray(scale.numpy())
    kw = dict(bin_size=bs, interpret=True, int4_packed=packed,
              block_n=next(b for b in (1024, 512, 256, 128, bs)
                           if b >= bs and n_pad % b == 0))
    prk.reset_counts()
    v, i = prk.partial_reduce_packed(q, stored, bias, scale, bin_size=bs,
                                     int4_packed=packed)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, scale, k_scan=k_scan,
                                      bin_size=bs, int4_packed=packed)
    assert dict(prk.PLAIN_CALLS) == {f"partial_reduce_packed[{form}]": 1,
                                     f"partial_reduce_fused[{form}]": 1}
    assert not prk.LAUNCHES
    rv, ri = ref_packed(*jargs, jscale, **kw)
    assert_bin_winners_close(rv, ri, v, i, bin_size=bs, score=score, **TOL)
    rfv, rfi = ref_fused(*jargs, jscale, k_scan=k_scan, **kw)
    assert_topk_close(rfv, rfi, fv, fi, score=score, **TOL)


def test_stored_front_end_contract():
    q, db, bias = packed_operands(m=4, n=256, d=8, bin_size=16)
    stored, scale, _, _ = stored_operands(db, "int8")
    with pytest.raises(ValueError, match="per-row scale"):
        prk.partial_reduce_packed(q, stored, bias, bin_size=16)
    with pytest.raises(ValueError, match="per-row scale"):
        prk.partial_reduce_fused(q, db, bias, scale, k_scan=2, bin_size=16)
    with pytest.raises(ValueError, match="scale must be"):
        prk.partial_reduce_packed(q, stored, bias, scale[:, :-1], bin_size=16)
    with pytest.raises(ValueError, match="int4_packed needs int8"):
        prk.partial_reduce_packed(q, db, bias, bin_size=16, int4_packed=True)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        prk.partial_reduce_packed(q, db.half(), bias, bin_size=16)


def test_rescore_candidates_matches_reference():
    """Cut to k_scan, gather (-1 wraps to the last row, then is masked),
    exact dot + bias, top-k."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 16), dtype=np.float32)
    rows = rng.standard_normal((50, 16), dtype=np.float32)
    rbias = rng.standard_normal(50).astype(np.float32)
    vals = np.sort(rng.standard_normal((6, 12)).astype(np.float32))[:, ::-1]
    idxs = rng.integers(0, 50, (6, 12)).astype(np.int32)
    vals[:, 9:] = float(np.finfo(np.float32).min)
    idxs[:, 9:] = -1
    vals = np.ascontiguousarray(vals)
    for k_scan in (12, 8):
        v, i = rescore_candidates(*map(torch.from_numpy, (q, vals, idxs, rows,
                                                          rbias)), 5, k_scan)
        rv, ri = ref_rescore(*map(jnp.asarray, (q, vals, idxs, rows, rbias)),
                             5, k_scan)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), **TOL)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


# --- the slice as a whole ---------------------------------------------------------


def _ref_backend(backend, metric, storage):
    """The reference path the port's backend is held against.

    The reference's "pallas" path misranks on the CPU for l2 over a
    scaled tier: jitted around the interpret-mode kernel, a bin winner's
    index comes out as the next bin's first row (ROADMAP "Reference
    caveats").  Those cases are held against "xla", which shares the
    plan and the bins.
    """
    if backend == "cuda" and metric == "l2" and storage in ("int8", "int4"):
        return "xla"
    return PAIRS[backend]


def _build_pair(db, backend, **kw):
    ours = Index.build(db, device="cpu", backend=backend, **kw)
    ref = ref_search.Index.build(
        jnp.asarray(db), cluster="off", **kw,
        backend=_ref_backend(backend, kw["metric"], kw["storage"]))
    return ours, ref


def _check(ours, ref, q, metric, rows):
    assert dataclasses.astuple(ours.plan) == dataclasses.astuple(ref.plan)
    assert ours.size == ref.size and ours.capacity == ref.capacity
    v, i = ours.search(q)
    rv, ri = ref.search(jnp.asarray(q))
    assert v.shape == (q.shape[0], ours.spec.k) and i.dtype == torch.int32
    score = public_scorer(metric, q, rows)
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=score, **TOL)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("storage", TIERS)
@pytest.mark.parametrize("metric", METRICS)
def test_quant_index_matches_reference(metric, storage, backend):
    """Build, search, add past the capacity (bin re-plan), delete (repeated
    ids), search: plans, k_scan and results equal the reference's, no
    deleted id returns, and the values are the exact scores of the
    returned rows (the rescore ran)."""
    rng = np.random.default_rng(10 * METRICS.index(metric) + TIERS.index(storage))
    d = 24
    rows = rng.standard_normal((700, d), dtype=np.float32)
    q = rng.standard_normal((12, d), dtype=np.float32)
    ours, ref = _build_pair(rows, backend, metric=metric, k=6,
                            recall_target=0.9, storage=storage,
                            capacity=800, capacity_block=512)
    assert ours.k_scan == quant.scan_k(storage, 6)
    deleted = set()
    for step in range(3):
        if step == 1:
            new = rng.standard_normal((300, d), dtype=np.float32)
            rows = np.concatenate([rows, new])
            for index in (ours, ref):
                index.add(new)
        elif step == 2:
            ids = rng.choice(len(rows), size=400, replace=False)
            ids = np.concatenate([ids, ids[:5]])
            deleted.update(ids.tolist())
            for index in (ours, ref):
                index.delete(ids)
        v, i = _check(ours, ref, q, metric, rows)
        assert not deleted & set(i[i >= 0].tolist())
        score = public_scorer(metric, q, rows)
        for r in range(q.shape[0]):
            np.testing.assert_allclose(v[r], score(r, i[r]), rtol=1e-5, atol=1e-4)
    assert ours.capacity > 800


@pytest.mark.parametrize("backend,metric,storage,rescore,fused", [
    ("torch", "l2", "int8", False, None),
    ("torch", "l2", "int4", False, None),
    ("cuda", "l2", "bf16", False, True),
    ("cuda", "mips", "int4", False, True),
    ("cuda", "mips", "int8", False, False),
    ("cuda", "cosine", "int4", None, False),
    ("cuda", "l2", "bf16", None, False),
    ("cuda", "l2", "int8", None, False),
])
def test_quant_paths_match_reference(backend, metric, storage, rescore, fused):
    """rescore=False (the scan's own, approximate, values) and the
    two-pass kernel path (fused_select=False), against the reference."""
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((900, 40), dtype=np.float32)
    q = rng.standard_normal((10, 40), dtype=np.float32)
    ours, ref = _build_pair(rows, backend, metric=metric, k=8,
                            storage=storage, rescore=rescore,
                            fused_select=fused)
    assert ours.k_scan == (8 if rescore is False else quant.scan_k(storage, 8))
    _check(ours, ref, q, metric, rows)
    ids = np.arange(0, 900, 4)
    for index in (ours, ref):
        index.delete(ids)
    _, i = _check(ours, ref, q, metric, rows)
    assert not set(ids.tolist()) & set(i[i >= 0].tolist())


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("storage", TIERS)
def test_incremental_add_equals_full_pack(storage, backend):
    """Rows appended by add (quantized slice by slice, past a growth) are
    stored exactly as a full pack of all rows stores them."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((1100, 20), dtype=np.float32)
    grown = Index.build(rows[:600], metric="l2", k=4, storage=storage,
                        backend=backend, device="cpu", capacity_block=256)
    grown.add(rows[600:900]).add(rows[900:])
    full = Index.build(rows, metric="l2", k=4, storage=storage,
                       backend=backend, device="cpu", capacity=1280,
                       capacity_block=256)
    a, b = grown.pack(), full.pack()
    assert a.n == b.n == 1280 and a.plan == b.plan
    n = len(rows)  # the spare capacity differs: grown rows are dead padding
    assert (a.scale is None) == (b.scale is None) == (storage == "bf16")
    for x, y in ((a.rows(), b.rows()), (a.scale_row(), b.scale_row()),
                 (a.bias_row(), b.bias_row()), (a.rescore_db, b.rescore_db),
                 (a.rescore_bias, b.rescore_bias)):
        if x is not None:
            np.testing.assert_array_equal(_np(x[:n]), _np(y[:n]))


def _hoeffding_eps(n_samples, delta=1e-6):
    return math.sqrt(math.log(1.0 / delta) / (2.0 * n_samples))


# tests/test_recall_guarantee.py::QUANT_CORNERS, the "pallas" corners on
# the port's "cuda" backend and the "xla" ones on "torch".
QUANT_CORNERS = [
    ("mips", "torch", "bf16", 10, 0.95, 4, 256),
    ("l2", "torch", "int8", 10, 0.95, 4, 256),
    ("cosine", "torch", "int8", 4, 0.99, 4, 256),
    ("l2", "cuda", "bf16", 16, 0.90, 2, 128),
    ("mips", "cuda", "int8", 8, 0.90, 2, 128),
    ("l2", "torch", "int4", 10, 0.90, 4, 256),
    ("mips", "cuda", "int4", 8, 0.90, 2, 128),
]


@pytest.mark.parametrize("metric,backend,storage,k,target,trials,m",
                         QUANT_CORNERS)
def test_quant_recall_meets_target(metric, backend, storage, k, target,
                                   trials, m):
    """Mean recall over fresh draws (N=2048, D=24) stays above the target
    and the over-fetched layout's E[recall], each minus the Hoeffding
    margin at delta = 1e-6."""
    samples, expected = [], None
    for trial in range(trials):
        rng = np.random.default_rng(300 + trial)
        db = rng.standard_normal((2048, 24), dtype=np.float32)
        q = rng.standard_normal((m, 24), dtype=np.float32)
        index = Index.build(db, metric=metric, k=k, recall_target=target,
                            backend=backend, storage=storage, device="cpu")
        assert index.expected_recall >= target
        expected = index.expected_recall
        _, approx = index.search(q)
        _, truth = exact_search(torch.from_numpy(q), torch.from_numpy(db), k,
                                metric=metric)
        for a, t in zip(approx.numpy(), truth.numpy()):
            samples.append(len(set(a.tolist()) & set(t.tolist())) / k)
    eps = _hoeffding_eps(len(samples))
    mean = float(np.mean(samples))
    assert mean >= target - eps and mean >= expected - eps, (mean, expected)


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("storage", TIERS)
def test_state_from_quantized_snapshot(storage, ref_backend):
    """A reference index of each tier, restored into the port (stored
    rows, scale, fused bias and rescore tail as saved), searches the
    same on both port backends."""
    rng = np.random.default_rng(8)
    db = rng.standard_normal((1200, 40), dtype=np.float32)
    q = rng.standard_normal((9, 40), dtype=np.float32)
    kw = dict(metric="l2", k=6, storage=storage)
    ref = ref_search.Index.build(jnp.asarray(db), backend=ref_backend,
                                 cluster="off", **kw)
    ref.delete(jnp.arange(0, 1200, 5))
    arrays, meta = snapshot_state(ref._packed)
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    rv, ri = ref.search(jnp.asarray(q))
    k_scan = quant.scan_k(storage, 6)
    for backend in ("torch", "cuda"):
        st = state_from_arrays(arrays, meta, SearchSpec(backend=backend, **kw),
                               "cpu")
        assert dataclasses.astuple(st.plan) == dataclasses.astuple(ref.plan)
        assert st.backend == backend and st.storage == storage
        canonical = ref._packed.rows()
        np.testing.assert_array_equal(_np(st.rows()), _np(canonical))
        if backend == "torch":
            v, i = dense_search_quant(torch.from_numpy(q), *st.operands(),
                                      metric="l2", k=6, k_scan=k_scan)
        else:
            v, i = cuda_search_packed_quant(
                torch.from_numpy(q), *st.operands(), metric="l2", k=6,
                k_scan=k_scan, n=st.n, bin_size=st.bin_size,
                fused_select=True, int4_packed=st.int4_packed)
        assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                          score=public_scorer("l2", q, db), **TOL)
    with pytest.raises(ValueError, match="storage"):
        state_from_arrays(arrays, meta, SearchSpec(metric="l2", k=6), "cpu")


def test_int4_layout_at_128_lanes():
    """The port's "cuda" layout pads int4 to 128 lanes like every tier:
    64 bytes a row at D<=128, half of int8's, with the reference's codes,
    scales and bin plan.  A reference snapshot in the pallas layout (256
    lanes, 128 bytes a row) restores into it and searches the same."""
    rng = np.random.default_rng(12)
    db = rng.standard_normal((1500, 100), dtype=np.float32)
    q = rng.standard_normal((7, 100), dtype=np.float32)
    kw = dict(metric="l2", k=6)
    ours = {s: Index.build(db, storage=s, backend="cuda", device="cpu", **kw)
            for s in ("int8", "int4")}
    i4, i8 = ours["int4"].pack(), ours["int8"].pack()
    assert tuple(i4.db.shape) == (i8.db.shape[0], 64) and i4.int4_packed
    assert i8.db.shape[1] == 128 and i4.db.dtype == i8.db.dtype == torch.int8
    ref = ref_search.Index.build(jnp.asarray(db), backend="pallas",
                                 cluster="off", storage="int4", **kw)
    assert ref._packed.db.shape[1] == 128  # the TPU layout: 256 lanes
    assert dataclasses.astuple(i4.plan) == dataclasses.astuple(ref.plan)
    np.testing.assert_array_equal(i4.rows().numpy(),
                                  np.asarray(ref._packed.rows()))
    np.testing.assert_array_equal(i4.scale_row().numpy(),
                                  np.asarray(ref._packed.scale_row()))
    ref.delete(jnp.arange(0, 1500, 7))
    arrays, meta = snapshot_state(ref._packed)
    st = state_from_arrays({k: np.asarray(a) for k, a in arrays.items()},
                           meta, SearchSpec(backend="cuda", storage="int4", **kw),
                           "cpu")
    assert tuple(st.db.shape) == (st.db.shape[0], 64) and st.int4_packed
    np.testing.assert_array_equal(st.rows().numpy(),
                                  np.asarray(ref._packed.rows()))
    v, i = cuda_search_packed_quant(
        torch.from_numpy(q), *st.operands(), metric="l2", k=6,
        k_scan=quant.scan_k("int4", 6), n=st.n, bin_size=st.bin_size,
        fused_select=True, int4_packed=True)
    rv, ri = ref.search(jnp.asarray(q))
    assert_topk_close(np.asarray(rv), np.asarray(ri), v.numpy(), i.numpy(),
                      score=public_scorer("l2", q, db), **TOL)


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_add_without_growth_restores_the_over_fetch(storage, backend):
    """An index built with fewer live rows than its over-fetch and spare
    capacity, then grown by ``add`` without growth: ``k_scan`` is the
    uncapped ``quant.scan_k`` again, and the search is the reference's
    (its add made before its first search, which binds ``k_scan``)."""
    rng = np.random.default_rng(TIERS.index(storage))
    d = 16
    rows = rng.standard_normal((112, d), dtype=np.float32)
    q = rng.standard_normal((5, d), dtype=np.float32)
    kw = dict(metric="mips", k=10, storage=storage, capacity=1024)
    ours = Index.build(rows[:12], device="cpu", backend=backend, **kw)
    ref = ref_search.Index.build(jnp.asarray(rows[:12]), backend="xla",
                                 cluster="off", **kw)
    assert ours.k_scan == 12
    ours.add(rows[12:])
    ref.add(jnp.asarray(rows[12:]))
    assert ours.capacity == ref.capacity == 1024
    assert ours.k_scan == quant.scan_k(storage, 10) == (20 if storage == "int8"
                                                         else 30)
    _check(ours, ref, q, "mips", rows)


@pytest.mark.parametrize("backend", sorted(PAIRS))
@pytest.mark.parametrize("storage", TIERS)
def test_bitonic_search_matches_reference(storage, backend):
    """``SearchSpec(use_bitonic=True)`` runs the bitonic network in the
    rescore (and, two-pass, the merge): the same results as the
    reference's bitonic search, and as the port's default search."""
    rng = np.random.default_rng(30 + TIERS.index(storage))
    rows = rng.standard_normal((1500, 33), dtype=np.float32)
    q = rng.standard_normal((9, 33), dtype=np.float32)
    kw = dict(metric="l2", k=10, storage=storage, use_bitonic=True)
    ours, ref = _build_pair(rows, backend, **kw)
    v, i = _check(ours, ref, q, "l2", rows)
    default = Index.build(rows, device="cpu", backend=backend, metric="l2",
                          k=10, storage=storage)
    dv, di = default.search(q)
    assert_topk_close(dv.numpy(), di.numpy(), v, i,
                      score=public_scorer("l2", q, rows), **TOL)
    if backend == "cuda":  # the two-pass path's merge
        two = Index.build(rows, device="cpu", backend=backend,
                          fused_select=False, **kw)
        tv, ti = two.search(q)
        assert_topk_close(v, i, tv.numpy(), ti.numpy(),
                          score=public_scorer("l2", q, rows), **TOL)


def test_spec_quantized_checks():
    assert SearchSpec(storage="int4").rescore_enabled
    assert not SearchSpec(storage="int8", rescore=False).rescore_enabled
    assert not SearchSpec(storage="bf16", aggregate_to_topk=False).rescore_enabled
    with pytest.raises(ValueError, match="quantized storage tier"):
        SearchSpec(rescore=True)
    with pytest.raises(ValueError, match="aggregate_to_topk"):
        SearchSpec(storage="int8", rescore=True, aggregate_to_topk=False)
    with pytest.raises(ValueError, match="unknown storage"):
        SearchSpec(storage="int2")
    spec = SearchSpec(dtype="bfloat16", storage="bf16")  # the bf16 compute dtype
    assert spec.dtype == "bfloat16" and spec.rescore_enabled
