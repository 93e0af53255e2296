"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc, and skips without one.
This file imports neither JAX nor ``repro``, so it runs on a machine
that has only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import partial_reduce as prk
from repro_torch.search import Index, pad_queries_to
from repro_torch.testing import (
    KERNEL_CASES,
    assert_bin_winners_close,
    assert_topk_close,
    bias_scorer,
    bits_equal,
    packed_operands,
    public_scorer,
    stored_operands,
    tied_carries,
)

pytestmark = pytest.mark.cuda

# Beyond the small cases: many column tiles and splits, a bin as wide as
# the slice's 4096-row bins, and a batch spanning several query tiles.
CUDA_CASES = dict(
    KERNEL_CASES,
    wide_bins=dict(m=300, n=200_000, d=128, bin_size=4096, k_scan=10,
                   dead=0.1, l2=True),
    exact_layout=dict(m=70, n=5000, d=64, bin_size=1, k_scan=100),
    many_splits=dict(m=3, n=65_536, d=100, bin_size=128, k_scan=128),
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernels_match_plain(cuda_device, name):
    case = CUDA_CASES[name]
    q, db, bias = packed_operands(**case, seed=3, device=cuda_device)
    score = bias_scorer(q, db, bias)
    bin_size, k_scan = case["bin_size"], case["k_scan"]
    prk.reset_counts()
    v, i = prk.partial_reduce_packed(q, db, bias, bin_size=bin_size)
    fv, fi = prk.partial_reduce_fused(q, db, bias, k_scan=k_scan,
                                      bin_size=bin_size)
    torch.cuda.synchronize()
    assert dict(prk.LAUNCHES) == {"partial_reduce_packed": 1,
                                  "partial_reduce_fused": 1,
                                  "fused_carry_merge": 1}
    assert not prk.PLAIN_CALLS
    qp = pad_queries_to(q, db.shape[1])
    pv, pi = prk.partial_reduce_packed_plain(qp, db, bias, bin_size=bin_size)
    assert_bin_winners_close(pv.cpu(), pi.cpu(), v.cpu(), i.cpu(),
                             bin_size=bin_size, score=score)
    pfv, pfi = prk.partial_reduce_fused_plain(qp, db, bias, k_scan=k_scan,
                                              bin_size=bin_size)
    assert_topk_close(pfv.cpu(), pfi.cpu(), fv.cpu(), fi.cpu(), score=score)
    # the merge kernel against its plain version on the same carries: the
    # same values reordered by one rule, so exactly equal
    carries = prk.fused_scan(qp, db, bias, k_scan=k_scan, bin_size=bin_size)
    for a, b in zip(prk.fused_carry_merge(*carries),
                    prk.fused_carry_merge_plain(*carries)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CUDA_CASES))
@pytest.mark.parametrize("form", ["bf16", "int8", "int4"])
def test_stored_forms_match_plain(cuda_device, name, form):
    """Each stored form's kernels (two-pass and fused) against their plain
    versions on the same stored operands."""
    case = CUDA_CASES[name]
    q, db, bias = packed_operands(**case, seed=4, device=cuda_device)
    stored, scale, packed, widened = stored_operands(db, form)
    score = bias_scorer(q, widened, bias)
    kw = dict(bin_size=case["bin_size"], int4_packed=packed)
    k_scan = case["k_scan"]
    prk.reset_counts()
    v, i = prk.partial_reduce_packed(q, stored, bias, scale, **kw)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, scale, k_scan=k_scan, **kw)
    torch.cuda.synchronize()
    assert dict(prk.LAUNCHES) == {f"partial_reduce_packed[{form}]": 1,
                                  f"partial_reduce_fused[{form}]": 1,
                                  "fused_carry_merge": 1}
    assert not prk.PLAIN_CALLS
    qp = pad_queries_to(q, widened.shape[1])
    pv, pi = prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw)
    assert_bin_winners_close(pv.cpu(), pi.cpu(), v.cpu(), i.cpu(),
                             bin_size=case["bin_size"], score=score)
    pfv, pfi = prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                              k_scan=k_scan, **kw)
    assert_topk_close(pfv.cpu(), pfi.cpu(), fv.cpu(), fi.cpu(), score=score)


def _integer_operands(form, bin_size, seed, d=100):
    """Small-integer queries and rows (every dot product and bias sum is
    exact in f32) in the port's layout, 10% tombstones, l2 bias; a query
    count that leaves the last query block part full and one of its
    warpgroups empty, and by default D=100 (7 k-steps of 16 in a 128-lane
    row)."""
    rng = np.random.default_rng(seed)
    m, n = 150, max(3 * bin_size, 2000)
    block_n = max(bin_size, 128)
    n_pad = -(-n // block_n) * block_n
    q = rng.integers(-3, 4, (m, d)).astype(np.float32)
    rows = rng.integers(-7, 8, (n, d)).astype(np.float32)
    db = np.zeros((n_pad, -(-d // 128) * 128), np.float32)
    db[:n, :d] = rows
    bias = np.full((1, n_pad), np.finfo(np.float32).min, np.float32)
    bias[0, :n] = np.where(rng.random(n) >= 0.1,
                           -0.5 * (rows * rows).sum(1), bias[0, :n])
    q, db, bias = (torch.from_numpy(a).cuda() for a in (q, db, bias))
    stored, scale, packed, _ = stored_operands(db, form)
    return q, stored, bias, scale, packed


@pytest.mark.parametrize("log2_bin", range(13))
@pytest.mark.parametrize("k_scan", [10, 129])
@pytest.mark.parametrize("form", ["f32", "bf16", "int8", "int4"])
def test_integer_inputs_bit_equal(cuda_device, form, k_scan, log2_bin):
    """With integer-valued queries and rows every sum is exact, on the
    tensor cores as in the plain version: both kernels give the plain
    versions' values bit for bit and their indices exactly, ties
    included, at bins of 1 to 4096 rows and with the fused carry in
    shared (k_scan 10) and device (129) memory."""
    bin_size = 1 << log2_bin
    q, stored, bias, scale, packed = _integer_operands(form, bin_size, log2_bin)
    kw = dict(bin_size=bin_size, int4_packed=packed)
    v, i = prk.partial_reduce_packed(q, stored, bias, scale, **kw)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, scale, k_scan=k_scan, **kw)
    qp = pad_queries_to(q, 128)
    pv, pi = prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw)
    pfv, pfi = prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                              k_scan=k_scan, **kw)
    torch.cuda.synchronize()
    for got, want in ((v, pv), (i, pi), (fv, pfv), (fi, pfi)):
        assert torch.equal(got, want)


def _fixed_point(rng, shape, bits):
    """Values of exactly ``bits`` significant bits on the grid 2^(1-bits),
    each sign: |v| in [1, 2)."""
    mag = rng.integers(1 << (bits - 1), 1 << bits, shape)
    return (mag * rng.choice([-1, 1], shape) * 2.0 ** (1 - bits)).astype(np.float32)


def _split_parts_operands(form, wide, bin_size, seed):
    """Queries and rows with more significant bits than bf16's 8, so the
    kernels' split parts beyond the first are not zero, and every sum of
    the scan is still exact in f32.  ``wide`` names the operand that has
    them:

    * "queries": 19-bit queries (q = q0 + q1 + q2, q2 nonzero for about
      half the values) against rows in {-1, 0, 1}, D=32: |q.x| < 64 on
      the grid 2^-18, within f32's 24 bits;
    * "rows" (f32 only): 19-bit rows against queries in {-1, 0, 1};
    * "both" (f32 only): 10-bit queries and 9-bit rows, D=16, so q1 . x1
      is not zero: |q.x| < 32 on the grid 2^-18.

    The int8 and int4 forms get a random positive per-row scale; 10% of
    the rows are tombstoned, the others get a random bias."""
    rng = np.random.default_rng(seed)
    m, n = 150, max(3 * bin_size, 2000)
    d = 16 if wide == "both" else 32
    n_pad = -(-n // max(bin_size, 128)) * max(bin_size, 128)
    small = lambda shape: rng.integers(-1, 2, shape).astype(np.float32)  # noqa: E731
    if wide == "both":
        q = _fixed_point(rng, (m, d), 10)
        rows = _fixed_point(rng, (n, d), 9) * 0.5
    else:
        q = _fixed_point(rng, (m, d), 19) if wide == "queries" else small((m, d))
        rows = _fixed_point(rng, (n, d), 19) if wide == "rows" else small((n, d))
    db = np.zeros((n_pad, 128), np.float32)
    db[:n, :d] = rows
    bias = np.full((1, n_pad), np.finfo(np.float32).min, np.float32)
    bias[0, :n] = np.where(rng.random(n) >= 0.1,
                           rng.standard_normal(n).astype(np.float32), bias[0, :n])
    q, db, bias = (torch.from_numpy(a).cuda() for a in (q, db, bias))
    scale = None
    if form == "f32":
        stored = db
    elif form == "bf16":
        stored = db.to(torch.bfloat16)
    else:
        from repro_torch.search import quant

        stored = db.to(torch.int8)
        if form == "int4":
            stored = quant.pack_int4_rows(stored)
        scale = torch.from_numpy(
            rng.uniform(0.01, 2.0, (1, n_pad)).astype(np.float32)).cuda()
    return q, rows, stored, bias, scale


@pytest.mark.parametrize("bin_size", [1, 16, 1024])
@pytest.mark.parametrize("form, wide", [
    ("f32", "queries"), ("f32", "rows"), ("f32", "both"),
    ("bf16", "queries"), ("int8", "queries"), ("int4", "queries"),
])
def test_split_parts_bit_equal(cuda_device, form, wide, bin_size):
    """The exact bf16 split on the tensor cores, every part used: inputs
    whose second and third split parts are not zero but whose sums are
    exact in f32, so both kernels give the plain versions' values bit
    for bit (a pass left out, or one of f32's six products, changes
    them)."""
    q, rows, stored, bias, scale = _split_parts_operands(form, wide, bin_size,
                                                         bin_size)
    # the parts the test is about are there
    for name, x in (("queries", q.cpu()), ("rows", torch.from_numpy(rows))):
        if wide in (name, "both"):
            parts = prk.split_queries(x)
            assert (parts[1] != 0).float().mean() > 0.2, name
            if wide != "both":
                assert (parts[2] != 0).float().mean() > 0.4, name
    kw = dict(bin_size=bin_size, int4_packed=form == "int4")
    v, i = prk.partial_reduce_packed(q, stored, bias, scale, **kw)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, scale, k_scan=10, **kw)
    qp = pad_queries_to(q, 128)
    pv, pi = prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw)
    pfv, pfi = prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                              k_scan=10, **kw)
    torch.cuda.synchronize()
    for got, want in ((v, pv), (i, pi), (fv, pfv), (fi, pfi)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("d", [200, 256])
@pytest.mark.parametrize("form", ["f32", "bf16", "int8", "int4"])
def test_wide_rows_bit_equal(cuda_device, form, d):
    """Rows wider than one 128-lane stage: two stages a tile (one bulk
    copy a row), the split queries reloaded at each stage where they do
    not fit in shared memory, and at D=200 a last stage of 5 k-steps;
    integer inputs, so bit-equal to the plain versions."""
    q, stored, bias, scale, packed = _integer_operands(form, 64, d, d=d)
    kw = dict(bin_size=64, int4_packed=packed)
    v, i = prk.partial_reduce_packed(q, stored, bias, scale, **kw)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, scale, k_scan=10, **kw)
    qp = pad_queries_to(q, stored.shape[1] * (2 if packed else 1))
    pv, pi = prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw)
    pfv, pfi = prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                              k_scan=10, **kw)
    torch.cuda.synchronize()
    for got, want in ((v, pv), (i, pi), (fv, pfv), (fi, pfi)):
        assert torch.equal(got, want)
    plan = prk.scan_smem(form, True, d, 10)
    if form in ("f32", "bf16") and d == 256:
        assert not plan["resident"]


@pytest.mark.parametrize("k_scan", [33, 129, 512])
def test_fused_k_scan_limit(cuda_device, k_scan):
    """Above SMEM_K_SCAN (32) entries the carry lives in device memory;
    the kernel answers as its plain version does."""
    q, db, bias = packed_operands(m=70, n=100_000, d=64, bin_size=16,
                                  dead=0.2, l2=True, device=cuda_device)
    fv, fi = prk.partial_reduce_fused(q, db, bias, k_scan=k_scan, bin_size=16)
    pv, pi = prk.partial_reduce_fused_plain(pad_queries_to(q, db.shape[1]),
                                            db, bias, k_scan=k_scan,
                                            bin_size=16)
    assert_topk_close(pv.cpu(), pi.cpu(), fv.cpu(), fi.cpu(),
                      score=bias_scorer(q, db, bias))
    # fewer live rows than k_scan: the rest of the carry is (MASK, -1)
    few = packed_operands(m=5, n=100, d=16, bin_size=1, device=cuda_device)
    fv, fi = prk.partial_reduce_fused(*few, k_scan=k_scan, bin_size=1)
    assert (fi[:, :100] >= 0).all() and (fi[:, 100:] == -1).all()


@pytest.mark.parametrize("metric", ["mips", "l2", "cosine"])
@pytest.mark.parametrize("fused", [True, False])
def test_index_on_card_matches_cpu(cuda_device, metric, fused):
    rng = np.random.default_rng(5)
    db = rng.standard_normal((20_000, 100), dtype=np.float32)
    extra = rng.standard_normal((3000, 100), dtype=np.float32)
    q = rng.standard_normal((500, 100), dtype=np.float32)
    kw = dict(metric=metric, k=10, recall_target=0.95, fused_select=fused)
    gpu = Index.build(db, **kw)
    cpu = Index.build(db, device="cpu", backend="cuda", **kw)
    for index in (gpu, cpu):
        index.add(extra)
        index.delete(np.arange(0, 20_000, 3))
    prk.reset_counts()
    v, i = gpu.search(q)
    torch.cuda.synchronize()
    launched = "partial_reduce_fused" if fused else "partial_reduce_packed"
    assert prk.LAUNCHES[launched] == 1 and not prk.PLAIN_CALLS
    rv, ri = cpu.search(q)
    assert not set(i.cpu().numpy().ravel().tolist()) & set(range(0, 20_000, 3))
    assert_topk_close(rv.numpy(), ri.numpy(), v.cpu().numpy(), i.cpu().numpy(),
                      score=public_scorer(metric, q, np.concatenate([db, extra])))


@pytest.mark.parametrize("storage", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("fused", [True, False])
def test_quantized_index_on_card_matches_cpu(cuda_device, storage, fused):
    """An index per tier on the card against the same index on the CPU
    (the kernels' plain versions), after an add and deletes; the values
    are the exact scores of the returned rows (the rescore ran)."""
    rng = np.random.default_rng(6)
    db = rng.standard_normal((20_000, 100), dtype=np.float32)
    extra = rng.standard_normal((3000, 100), dtype=np.float32)
    q = rng.standard_normal((300, 100), dtype=np.float32)
    kw = dict(metric="l2", k=10, storage=storage, fused_select=fused)
    gpu = Index.build(db, **kw)
    cpu = Index.build(db, device="cpu", backend="cuda", **kw)
    for index in (gpu, cpu):
        index.add(extra)
        index.delete(np.arange(0, 20_000, 3))
    prk.reset_counts()
    v, i = gpu.search(q)
    torch.cuda.synchronize()
    base = "partial_reduce_fused" if fused else "partial_reduce_packed"
    assert prk.LAUNCHES[f"{base}[{storage}]"] == 1 and not prk.PLAIN_CALLS
    rv, ri = cpu.search(q)
    assert not set(i.cpu().numpy().ravel().tolist()) & set(range(0, 20_000, 3))
    score = public_scorer("l2", q, np.concatenate([db, extra]))
    assert_topk_close(rv.numpy(), ri.numpy(), v.cpu().numpy(), i.cpu().numpy(),
                      score=score)
    for row in range(0, 300, 37):
        np.testing.assert_allclose(v[row].cpu().numpy(),
                                   score(row, i[row].cpu().numpy()),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
def test_search_steady_state_on_card(cuda_device, storage):
    """Any M is one scan launch plus one merge launch for every tier, and
    a search allocates nothing near the size of the database (a
    quantized tier's rescore gathers only O(M * k_scan * D))."""
    rng = np.random.default_rng(9)
    index = Index.build(rng.standard_normal((400_000, 128), dtype=np.float32),
                        metric="l2", k=10, storage=storage)
    pk = index.pack()
    db_bytes = sum(t.numel() * t.element_size() for t in pk.operands()
                   if t is not None)
    form = "" if storage == "f32" else f"[{storage}]"
    for m in (1, 100, 1000):
        q = torch.randn((m, 128), device=cuda_device)
        index.search(q)
        torch.cuda.synchronize()
        prk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        index.search(q)
        torch.cuda.synchronize()
        assert dict(prk.LAUNCHES) == {f"partial_reduce_fused{form}": 1,
                                      "fused_carry_merge": 1}
        assert torch.cuda.max_memory_allocated() - before < db_bytes // 4


# The merge kernel's grid: group widths of 8, 16 and 32 lanes, 1 to 8
# splits a lane; carries staged in shared memory and (k_scan 129 and 512
# at many splits) read from device memory; query blocks part full.
MERGE_SPLITS = [1, 2, 5, 31, 32, 33, 82, 123, 256]
MERGE_K_SCAN = [1, 10, 30, 32, 33, 129, 512]


@pytest.mark.parametrize("m", [1, 16, 129, 1000])
@pytest.mark.parametrize("k_scan", MERGE_K_SCAN)
@pytest.mark.parametrize("splits", MERGE_SPLITS)
def test_merge_bit_equal(cuda_device, splits, k_scan, m):
    """The merge kernel gives its plain version's values (bits: -0.0 is
    not +0.0) and indices exactly, on carries dense in ties across and
    within splits, with zeros of both signs and masked tails."""
    part_v, part_i = tied_carries(splits, m, k_scan, seed=splits * 1000 + k_scan,
                                  device=cuda_device)
    prk.reset_counts()
    v, i = prk.fused_carry_merge(part_v, part_i)
    torch.cuda.synchronize()
    assert dict(prk.LAUNCHES) == {"fused_carry_merge": 1}
    pv, pi = prk.fused_carry_merge_plain(part_v, part_i)
    assert bits_equal(v, pv) and torch.equal(i, pi)


def test_merge_plan_takes_both_paths(cuda_device):
    """The grid of test_merge_bit_equal runs both of the merge's paths,
    and every main-path plan stages its carries in shared memory."""
    staged = {prk.merge_plan(s, k)["staged_bytes"] > 0
              for s in MERGE_SPLITS for k in MERGE_K_SCAN}
    assert staged == {True, False}
    for splits, k_scan in ((5, 10), (5, 30), (123, 10), (123, 30), (131, 60)):
        assert prk.merge_plan(splits, k_scan)["staged_bytes"] > 0


# --- the planner and the bitonic network on the card ------------------------


def test_bitonic_on_card_equals_cpu(cuda_device):
    """The bitonic network on CUDA tensors at a rescore's shape (the int4
    k=20 over-fetch, 60 candidates): the CPU's result bit for bit, and
    the stable sort's up to the order of tied values."""
    from repro_torch.core import exact_rescoring

    g = torch.Generator().manual_seed(5)
    vals = torch.randint(-3, 4, (2000, 60), generator=g).float()
    vals = torch.where((vals == 0) & (torch.rand(vals.shape, generator=g) < 0.5),
                       torch.full_like(vals, -0.0), vals)
    idxs = torch.randperm(2000 * 60, generator=g).int().reshape(2000, 60)
    v, i = exact_rescoring(vals.to(cuda_device), idxs.to(cuda_device), 20)
    cv, ci = exact_rescoring(vals, idxs, 20)
    assert bits_equal(v.cpu(), cv) and torch.equal(i.cpu(), ci)
    sv, si = exact_rescoring(vals, idxs, 20, use_bitonic=False)
    value_of = torch.empty(vals.numel())  # each index's value (a scorer)
    value_of[idxs.flatten().long()] = vals.flatten()
    assert_topk_close(sv, si, v.cpu(), i.cpu(), rtol=0.0, atol=0.0,
                      score=lambda row, idx: value_of[idx].double().numpy())


def test_detect_device_names_the_card(cuda_device):
    from repro_torch.search import detect_device

    name = torch.cuda.get_device_name(cuda_device)
    assert detect_device() == ("h100" if "H100" in name else "a100")
    assert detect_device(device="cpu") == "cpu"


@pytest.mark.parametrize("storage", ["f32", "int4"])
def test_measured_plan_on_card(cuda_device, storage, tmp_path, monkeypatch):
    """plan="measure" on the card: the sweep's plan, a cache hit on the
    second build, the model plan's results, and a measured search no
    faster than the model's bound."""
    from repro_torch.search import PlanCache
    from repro_torch.search import plan as planlib

    rng = np.random.default_rng(7)
    db = torch.from_numpy(rng.standard_normal((60_000, 96), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((300, 96), dtype=np.float32))
    kw = dict(metric="l2", k=10, storage=storage, device=cuda_device)
    cache = PlanCache(str(tmp_path / "plans.json"))
    measured = Index.build(db, plan="measure", plan_cache=cache, **kw)
    assert measured.kernel_plan.source == "measure" and len(cache) == 1
    timed = []
    real = planlib.time_search
    monkeypatch.setattr(planlib, "time_search",
                        lambda *a, **k: timed.append(1) or real(*a, **k))
    again = Index.build(db, plan="measure", plan_cache=cache, **kw)
    assert not timed and again.kernel_plan == measured.kernel_plan
    model = Index.build(db, **kw)
    (v, i), (mv, mi) = measured.search(q), model.search(q)
    assert_topk_close(mv.cpu(), mi.cpu(), v.cpu(), i.cpu(),
                      score=public_scorer("l2", q, db))
    rep = measured.explain(m=300, measure=True)
    assert (rep["plan"]["splits"] is not None) == (rep["predicted"]["device"]
                                                   == "h100")
    assert rep["measured"]["wall_s"] >= 0.95 * rep["predicted"]["wall_s"]


# --- the one-pass forms (bf16 queries) and the cluster-pruned path -----------


@pytest.mark.parametrize("log2_bin", [0, 4, 7, 12])
@pytest.mark.parametrize("k_scan", [10, 129])
@pytest.mark.parametrize("form", ["bf16", "int8", "int4"])
def test_one_pass_integer_inputs_bit_equal(cuda_device, form, k_scan, log2_bin):
    """bf16 queries (the one-pass instantiations): on integer-valued
    inputs both kernels give their plain versions' values bit for bit and
    their indices exactly, under the one-pass counter names."""
    bin_size = 1 << log2_bin
    q, stored, bias, scale, packed = _integer_operands(form, bin_size, log2_bin)
    q = q.to(torch.bfloat16)
    kw = dict(bin_size=bin_size, int4_packed=packed)
    prk.reset_counts()
    v, i = prk.partial_reduce_packed(q, stored, bias, scale, **kw)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, scale, k_scan=k_scan, **kw)
    torch.cuda.synchronize()
    assert dict(prk.LAUNCHES) == {
        prk.kernel_name("partial_reduce_packed", form, 1): 1,
        prk.kernel_name("partial_reduce_fused", form, 1): 1,
        "fused_carry_merge": 1}
    qp = pad_queries_to(q, 128)
    pv, pi = prk.partial_reduce_packed_plain(qp, stored, bias, scale, **kw)
    pfv, pfi = prk.partial_reduce_fused_plain(qp, stored, bias, scale,
                                              k_scan=k_scan, **kw)
    for got, want in ((v, pv), (i, pi), (fv, pfv), (fi, pfi)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
def test_pack_on_card_equals_cpu(cuda_device, storage, dtype):
    """The card's packed operands are the CPU's: stored rows, codes and
    scales bit for bit, biases to the order of their f32 sums of d
    squares (2 d 2^-24 of the bias), as are the rescore rows' biases."""
    rng = np.random.default_rng(8)
    db = rng.standard_normal((20_000, 100), dtype=np.float32)
    kw = dict(metric="l2", k=10, storage=storage, dtype=dtype, cluster="off")
    g = Index.build(db, **kw).pack()
    c = Index.build(db, device="cpu", backend="cuda", **kw).pack()
    rtol = 2 * 100 * 2.0 ** -24
    for name in ("db", "scale", "rescore_db"):
        a, b = getattr(g, name, None), getattr(c, name, None)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a.cpu(), b), name
    for name in ("bias", "rescore_bias"):
        a, b = getattr(g, name, None), getattr(c, name, None)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=rtol,
                                       atol=0, err_msg=name)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("fused", [True, False])
def test_bf16_index_on_card_matches_cpu(cuda_device, storage, fused):
    """``dtype="bfloat16"`` on the card runs the one-pass kernels and no
    plain version, and searches as the same index on the CPU under the
    near-tie rule of ``repro_torch.testing``, every query (the card packs
    the CPU's codes and scales, ``test_pack_on_card_equals_cpu``)."""
    rng = np.random.default_rng(8)
    db = rng.standard_normal((20_000, 100), dtype=np.float32)
    q = rng.standard_normal((300, 100), dtype=np.float32)
    kw = dict(metric="l2", k=10, storage=storage, dtype="bfloat16",
              fused_select=fused, cluster="off")
    gpu = Index.build(db, **kw)
    cpu = Index.build(db, device="cpu", backend="cuda", **kw)
    for index in (gpu, cpu):
        index.delete(np.arange(0, 20_000, 3))
    prk.reset_counts()
    v, i = gpu.search(q)
    torch.cuda.synchronize()
    base = "partial_reduce_fused" if fused else "partial_reduce_packed"
    form = "bf16" if storage == "f32" else storage
    assert prk.LAUNCHES[prk.kernel_name(base, form, 1)] == 1
    assert not prk.PLAIN_CALLS
    rv, ri = cpu.search(q)
    assert_topk_close(rv.numpy(), ri.numpy(), v.cpu().numpy(), i.cpu().numpy(),
                      score=public_scorer("l2", q, db, dtype="bfloat16"))


def _mixture(seed, n, m, d=32, components=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(components, d)) * 2.5
    db = centers[rng.integers(0, components, n)] + rng.normal(size=(n, d))
    q = centers[rng.integers(0, components, m)] + rng.normal(size=(m, d))
    return db.astype(np.float32), q.astype(np.float32)


def test_kmeans_segment_sums_on_card_equal_cpu(cuda_device):
    """k-means' segment sums on the card are the CPU's bit for bit (each
    cluster's rows added in row order, no atomics), run after run."""
    from repro_torch.search import cluster

    rng = np.random.default_rng(10)
    rows = torch.from_numpy(rng.standard_normal((200_000, 128), dtype=np.float32))
    assign = torch.from_numpy(rng.integers(0, 1024, 200_000))
    assign[assign == 7] = 8  # an empty segment
    want = cluster._segment_sums(rows, assign, 1024)
    for _ in range(2):
        got = cluster._segment_sums(rows.to(cuda_device), assign.to(cuda_device),
                                    1024)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
def test_clustered_index_on_card_matches_cpu(cuda_device, storage):
    """``cluster="auto"`` on a mixture corpus builds its tables on the
    card (under the ``"a100"`` profile, which keeps the reference's
    decision; the card's own profile vetoes the pruned scan): the same
    bits in two builds, centroids allclose to the CPU index's (rtol and
    atol 1e-5, as against the reference) and the same slot tables; given
    the CPU index's tables, the card's pruned search equals the CPU's, and
    deleted rows never return."""
    from repro_torch.search import cluster

    db, q = _mixture(9, 20_000, 400)
    kw = dict(metric="l2", k=10, storage=storage)
    gpu = Index.build(db, profile="a100", **kw)
    cpu = Index.build(db, device="cpu", **kw)
    g, c = gpu.pack().cluster, cpu.pack().cluster
    assert g is not None and c is not None and g.plan == c.plan
    assert gpu.pack_timings["sampled_miss"] <= cluster.miss_check_threshold(
        g.plan.miss_budget)
    again = Index.build(db, profile="a100", **kw).pack().cluster
    for name in ("centroids", "centroid_bias", "cluster_rows", "spill_rows"):
        assert torch.equal(getattr(g, name), getattr(again, name)), name
    np.testing.assert_allclose(g.centroids.cpu().numpy(), c.centroids.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g.cluster_rows.cpu().numpy(),
                                  c.cluster_rows.numpy())
    np.testing.assert_array_equal(g.spill_rows.cpu().numpy(), c.spill_rows.numpy())
    np.testing.assert_array_equal(g.counts, c.counts)
    arrays, meta = cluster.snapshot_tables(c)
    gpu.pack().cluster = cluster.restore_tables(arrays, meta, cuda_device)
    for index in (gpu, cpu):
        index.delete(np.arange(0, 20_000, 3))
    v, i = gpu.search(q)
    rv, ri = cpu.search(q)
    assert not set(i.cpu().numpy().ravel().tolist()) & set(range(0, 20_000, 3))
    assert_topk_close(rv.numpy(), ri.numpy(), v.cpu().numpy(), i.cpu().numpy(),
                      score=public_scorer("l2", q, db))


# --- C3: the default build on the card runs no k-means ------------------------


def test_default_build_skips_kmeans_at_the_sift1m_shape(cuda_device):
    """Gaussian data at the Sift1M shape (N=1,000,000, D=128, l2, k=10):
    the ``"h100"`` profile vetoes the cluster plan, so the default build
    runs no k-means, takes about as long as ``cluster="off"`` (it took
    2.05 s against 0.03 s before the veto) and searches bit-identically."""
    import time

    g = torch.Generator(device=cuda_device).manual_seed(0)
    db = torch.randn((1_000_000, 128), generator=g, device=cuda_device)
    q = torch.randn((100, 128), generator=g, device=cuda_device)

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = Index.build(db, metric="l2", k=10, **kw)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    timed(cluster="off")  # the allocator's first growth
    off, t_off = timed(cluster="off")
    auto, t_auto = timed()
    veto = auto.kernel_plan.cluster_veto
    assert veto is not None and veto[0] >= veto[1]
    assert auto.pack().cluster is None and auto.pack().cluster_rejected_miss is None
    assert auto.pack_timings == {}
    assert t_auto < t_off + 0.5, (t_auto, t_off)
    (va, ia), (vo, io) = auto.search(q), off.search(q)
    assert torch.equal(va, vo) and torch.equal(ia, io)


# --- serving: one CUDA graph per bucket ---------------------------------------

# every tier, and the f32 tier at the bf16 compute dtype
SERVE_CASES = [("f32", None), ("bf16", None), ("int8", None), ("int4", None),
               ("f32", "bfloat16")]


def _serve_index(storage, dtype, n=60_000, room=0):
    rng = np.random.default_rng(11)
    db = rng.standard_normal((n, 64), dtype=np.float32)
    return Index.build(db, metric="l2", k=10, storage=storage, dtype=dtype,
                       capacity=n + room, capacity_block=1024)


def _requests(seed, count, d=64):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(1, 65)), d), dtype=np.float32),
             int(rng.integers(1, 11))) for _ in range(count)]


def _bits_equal_direct(index, q, k, got):
    direct = index.search(q)
    assert torch.equal(got.values, direct.values[:, :k].cpu())
    assert torch.equal(got.indices, direct.indices[:, :k].cpu())


@pytest.mark.parametrize("storage,dtype", SERVE_CASES)
def test_graph_replay_bit_equal_to_eager(cuda_device, storage, dtype):
    """A replayed search graph gives the eager search's bits; a replay
    passes no kernel front end (the kernels' counters stay still), and the
    capture counted the path's kernels and no plain version."""
    index = _serve_index(storage, dtype)
    for m in (1, 16, 128):
        q = torch.randn((m, 64), device=cuda_device)
        eager = index.search(q)
        graph = index.search_graph(m)
        assert graph.launches and not graph.plain_calls
        graph.queries.copy_(q.to(index.query_dtype))
        prk.reset_counts()
        index.replay_graph(graph)
        torch.cuda.synchronize()
        assert not prk.LAUNCHES and not prk.PLAIN_CALLS
        assert torch.equal(graph.values, eager.values)
        assert torch.equal(graph.indices, eager.indices)
    info = index.cache_info()
    assert (info["captures"], info["replays"], info["entries"]) == (3, 3, 3)


@pytest.mark.parametrize("storage,dtype", SERVE_CASES)
def test_served_requests_bit_equal_to_direct(cuda_device, storage, dtype):
    """A seeded stream of 1-64-row requests, each with its own k, on a
    virtual clock: every ticket is a direct search of its rows, bit for
    bit, and every batch is one graph replay."""
    from repro_torch.search import SearchServer, ServeConfig, VirtualClock

    index = _serve_index(storage, dtype)
    server = SearchServer(index, ServeConfig(max_batch=128),
                          clock=VirtualClock(), warmup=True)
    assert server.buckets == (8, 16, 32, 64, 128)
    reqs = _requests(1, 40)
    tickets = [server.submit(q, k=k) for q, k in reqs]
    server.run_until_idle()
    for (q, k), t in zip(reqs, tickets):
        _bits_equal_direct(index, q, k, t.result())
    s = server.stats()
    assert s["graph_replays"] == s["batches"] and s["eager_batches"] == 0
    assert s["cache"]["captures"] == len(server.buckets)


@pytest.mark.parametrize("storage,dtype", SERVE_CASES)
def test_same_bucket_batches_in_flight(cuda_device, storage, dtype):
    """Two batches of one bucket enqueued before either runs (the server's
    stream held by a sleep): the second replay overwrites the graph's
    outputs only after the first batch's copy out, so both are right."""
    from repro_torch.search import SearchServer, ServeConfig, VirtualClock

    index = _serve_index(storage, dtype)
    server = SearchServer(index, ServeConfig(max_batch=32, buckets=(32,)),
                          clock=VirtualClock(), warmup=True)
    (qa, _), (qb, _) = _requests(2, 2)
    qa, qb = qa[:20], qb[:24]
    with torch.cuda.stream(server._stream):
        torch.cuda._sleep(50_000_000)
    ta = server.submit(qa)
    assert server.step()          # A enqueued behind the sleep
    tb = server.submit(qb)
    assert server.step()          # B enqueued; then A is waited on
    assert not server.step()
    _bits_equal_direct(index, qa, 10, ta.result())
    _bits_equal_direct(index, qb, 10, tb.result())
    assert server.stats()["graph_replays"] == 2


@pytest.mark.parametrize("storage,dtype", SERVE_CASES)
def test_replay_after_mutations_equals_direct(cuda_device, storage, dtype):
    """Through ``server.mutation()``: a delete and an add in place keep the
    graphs (no recapture) and the replays see them; an add that grows the
    index recaptures; every served result is a direct search's bits."""
    from repro_torch.search import SearchServer, ServeConfig, VirtualClock

    index = _serve_index(storage, dtype, room=2048)
    server = SearchServer(index, ServeConfig(max_batch=64),
                          clock=VirtualClock(), warmup=True)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((48, 64), dtype=np.float32)

    def serve_and_check():
        t = server.submit(q)
        server.run_until_idle()
        _bits_equal_direct(index, q, 10, t.result())
        return t.result().indices

    first = serve_and_check()
    captures = index.cache_info()["captures"]
    with server.mutation():
        index.delete(first[:, 0].long())
    after_delete = serve_and_check()
    assert not set(after_delete.ravel().tolist()) & set(first[:, 0].tolist())
    with server.mutation():
        index.add(q + 0.01)  # near copies of the queries, in place
    after_add = serve_and_check()
    assert (after_add[:, 0] >= 60_000).all()
    assert index.cache_info()["captures"] == captures
    with server.mutation():
        index.add(rng.standard_normal((4096, 64), dtype=np.float32))  # grows
    serve_and_check()
    info = index.cache_info()
    assert info["invalidations"] == 1 and info["captures"] == captures + 1


def test_clustered_index_is_served_through_graphs(cuda_device):
    """A clustered index (mixture corpus, the ``"a100"`` profile keeps its
    tables) is captured like any other: its pruned path holds no host
    sync, and every served ticket is a direct search's bits."""
    from repro_torch.search import SearchServer, ServeConfig, VirtualClock

    db, _ = _mixture(12, 20_000, 1)
    index = Index.build(db, metric="l2", k=10, profile="a100")
    assert index.pack().cluster is not None
    server = SearchServer(index, ServeConfig(max_batch=64, buckets=(16, 64)),
                          clock=VirtualClock(), warmup=True)
    reqs = [(q[:, :32], k) for q, k in _requests(3, 12)]
    tickets = [server.submit(q, k=k) for q, k in reqs]
    server.run_until_idle()
    for (q, k), t in zip(reqs, tickets):
        _bits_equal_direct(index, q, k, t.result())
    s = server.stats()
    assert s["graph_replays"] == s["batches"] and s["cache"]["captures"] == 2


def test_failed_capture_raises(cuda_device):
    """A capture that fails raises; nothing falls back to eager work."""
    from repro_torch.search import backends

    def syncs(q):
        return q * float(q.sum()), q  # a host sync: not capturable

    with pytest.raises(RuntimeError):
        backends.capture_search(syncs, 8, 4, torch.float32, cuda_device)
