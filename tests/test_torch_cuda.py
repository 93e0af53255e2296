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


# --- the host-RAM cold tier ---------------------------------------------------


def _host_pair(storage="f32", n=200_000, d=128, seg=32_768, metric="l2",
               hbm=True):
    """A host index of ``seg``-row waves and (``hbm``) the HBM index of the
    same rows, both on the card, and the rows."""
    rng = np.random.default_rng(21)
    db = rng.standard_normal((n, d), dtype=np.float32)
    kw = dict(metric=metric, k=10, storage=storage, cluster="off")
    return (Index.build(db, residency="host", segment_rows=seg, **kw),
            Index.build(db, **kw) if hbm else None, db)


@pytest.mark.parametrize("metric", ["l2", "mips", "cosine"])
def test_host_f32_bit_equal_to_hbm_on_card(cuda_device, metric):
    """Segments of whole 4096-row bins: the waves' kernels and carry merge
    give the HBM index's bits (rows prepared on the card a segment at a
    time, as the HBM index prepares them all at once)."""
    host, hbm, _ = _host_pair(metric=metric)
    assert host.pack().db.is_pinned() and host.device.type == "cuda"
    assert host.capacity == 7 * 32_768
    assert 32_768 % host.host_searcher().bin_size == 0
    rng = np.random.default_rng(22)
    for m in (16, 300):
        q = torch.from_numpy(rng.standard_normal((m, 128), dtype=np.float32))
        a, b = host.search(q), hbm.search(q)
        assert torch.equal(a.values, b.values) and torch.equal(a.indices, b.indices)
    dead = torch.arange(0, 200_000, 3)
    host.delete(dead), hbm.delete(dead.cuda())
    a, b = host.search(q), hbm.search(q)
    assert torch.equal(a.values, b.values) and torch.equal(a.indices, b.indices)


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
def test_host_waves_launch_two_kernels_each(cuda_device, storage):
    host, _, db = _host_pair(storage=storage, hbm=False)
    waves = host.capacity // 32_768
    q = torch.from_numpy(db[:40] + 0.01)
    host.search(q)
    prk.reset_counts()
    from repro_torch.search import DISPATCH_COUNTS
    DISPATCH_COUNTS.clear()
    got = host.search(q)
    torch.cuda.synchronize()
    form = prk.kernel_name("partial_reduce_fused", storage, 3)
    assert dict(prk.LAUNCHES) == {form: waves, "fused_carry_merge": waves}
    assert not prk.PLAIN_CALLS
    assert dict(DISPATCH_COUNTS) == {"host": waves}
    assert (got.indices[:, 0].cpu() == torch.arange(40)).all()


@pytest.mark.parametrize("held", ["scan", "copy"])
def test_host_slots_ordered_behind_a_sleep(cuda_device, held):
    """With the compute stream held behind a sleep, the copies run ahead
    and the third wave's copy must wait for the first wave's scan of the
    same slot; with the copy stream held, every scan must wait for its
    copy.  Either way the result is the unheld search's bits."""
    host, _, db = _host_pair(n=150_000, seg=16_384, hbm=False)
    assert host.capacity // 16_384 >= 9
    q = torch.from_numpy(db[:64] * 0.5)
    want = host.search(q)
    torch.cuda.synchronize()
    searcher = host.host_searcher()
    stream = (torch.cuda.current_stream() if held == "scan"
              else searcher._copy_stream)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)
    got = host.search(q)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.indices, want.indices)


def test_host_search_adds_no_database_sized_allocation(cuda_device):
    """The index holds nothing on the card; a search adds its two slots
    (allocated once) and query-sized work, never the database."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    host, _, db = _host_pair(n=300_000, seg=32_768, hbm=False)
    torch.cuda.synchronize()
    db_bytes = host.capacity * 128 * 4
    slot_bytes = 32_768 * (128 * 4 + 8)
    q = torch.from_numpy(db[:16])
    host.search(q)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert held <= 2 * slot_bytes + (1 << 20), held
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    host.search(q)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - before
    assert added < slot_bytes and added < db_bytes // 100, added


def test_host_searches_from_two_threads_equal_serial(cuda_device):
    """Two threads search one host index at once, one on its own stream:
    the searcher issues one search's waves at a time, so neither stages
    into the other's slot, and every result is its serial search's
    bits."""
    import threading

    host, _, db = _host_pair(n=150_000, seg=16_384, hbm=False)
    qs = [torch.from_numpy(db[i * 50 : i * 50 + 32] * 0.7) for i in range(12)]
    want = [host.search(q) for q in qs]
    torch.cuda.synchronize()
    got, errors = {}, []

    def worker(idx, side):
        try:
            stream = torch.cuda.Stream() if side else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                for i in idx:
                    got[i] = host.search(qs[i])
                stream.synchronize()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(range(p, 12, 2), p))
               for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(got) == 12
    for i, w in enumerate(want):
        assert torch.equal(got[i].values, w.values)
        assert torch.equal(got[i].indices, w.indices)


def test_host_measure_times_on_the_card(cuda_device, monkeypatch):
    """plan="measure" for a host index on the card: its rows stay in host
    memory, its candidates search on the card, and the plan is cached
    under the card's name."""
    from repro_torch.search import plan as planlib

    timed = []
    real = planlib.time_search

    def spy(index, queries, **kw):
        timed.append((index.device.type, index.spec.residency,
                       index.pack().db.device.type))
        return real(index, queries, **kw)

    monkeypatch.setattr(planlib, "time_search", spy)
    db = np.random.default_rng(24).standard_normal((40_000, 128),
                                                   dtype=np.float32)
    cache = planlib.PlanCache()
    index = Index.build(db, metric="l2", k=10, cluster="off",
                        residency="host", segment_rows=16_384,
                        plan="measure", plan_cache=cache)
    assert index.kernel_plan.source == "measure"
    assert timed and set(timed) == {("cuda", "host", "cpu")}
    (key,) = cache._entries
    assert key.startswith(torch.cuda.get_device_name(0) + "/")
    assert key.endswith("/host16384")


def test_host_unaligned_budget_on_card(cuda_device):
    """A budget-planned segment that the planned bins do not tile: the
    card's kernels scan the capped bins within the budget, and match the
    same index's plain versions on the CPU."""
    rng = np.random.default_rng(25)
    n, d = 15_000, 16
    db = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((40, d), dtype=np.float32)
    kw = dict(k=2, recall_target=0.8, cluster="off", backend="cuda",
              residency="host", hbm_budget_bytes=2 * 3072 * (128 * 4 + 8))
    card = Index.build(db, **kw)
    cpu = Index.build(db, device="cpu", **kw)
    searcher = card.host_searcher()
    assert searcher.segment_rows == searcher.slot_rows == 3072
    assert searcher.bin_size == 1024
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    card.search(q)
    torch.cuda.synchronize()
    slot_bytes = sum(t.numel() * t.element_size() for s in searcher.slots
                     for t in s.values() if t is not None)
    assert slot_bytes <= kw["hbm_budget_bytes"]
    assert torch.cuda.memory_allocated() - before < slot_bytes
    a, b = card.search(q), cpu.search(q)
    assert_topk_close(b.values.numpy(), b.indices.numpy(),
                      a.values.cpu().numpy(), a.indices.cpu().numpy())


def test_host_index_is_served_eagerly(cuda_device):
    from repro_torch.search import SearchServer, ServeConfig, VirtualClock

    host, _, _ = _host_pair(n=70_000, seg=16_384, hbm=False)
    server = SearchServer(host, ServeConfig(max_batch=64),
                          clock=VirtualClock(), warmup=True)
    reqs = _requests(4, 6, d=128)
    tickets = [server.submit(q, k=k) for q, k in reqs]
    server.run_until_idle()
    for (q, k), t in zip(reqs, tickets):
        _bits_equal_direct(host, q, k, t.result())
    s = server.stats()
    assert s["graph_replays"] == 0 and s["eager_batches"] == s["batches"]
    with pytest.raises(RuntimeError, match="eagerly"):
        host.search_graph(16)


def test_restored_clustered_snapshot_reports_its_h100_price(cuda_device,
                                                           tmp_path):
    """C6: a snapshot with cluster tables restored on the card keeps them
    (bit-identical results) and reports the "h100" model's price of the
    pruned scan beside the dense one."""
    import os

    db, q = _mixture(12, 20_000, 40)
    index = Index.build(db, metric="l2", k=10, profile="a100")
    assert index.pack().cluster is not None
    direct = index.search(q)
    restored = Index.restore(index.save(os.path.join(tmp_path, "snap")))
    assert restored.kernel_plan.device == "h100"
    assert restored.pack().cluster is not None
    got = restored.search(q)
    assert torch.equal(got.values, direct.values)
    assert torch.equal(got.indices, direct.indices)
    for m in (None, 10_000):
        cl = restored.explain(m=m)["cluster"]
        assert cl["enabled"] and cl["predicted_pruned_s"] > 0
        assert cl["predicted_dense_s"] > 0 and "vetoed_by" not in cl


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_host_snapshot_round_trip_on_card(cuda_device, storage, tmp_path):
    """A host index saved and restored on the card: the state re-pinned in
    the kernels' layout, the same search bits, no build work."""
    import os

    from repro_torch.search import PACK_EVENTS

    host, _, db = _host_pair(storage=storage, n=70_000, seg=16_384, hbm=False)
    q = torch.from_numpy(db[:30] + 0.1)
    host.delete(torch.arange(0, 70_000, 9))
    direct = host.search(q)
    PACK_EVENTS.clear()
    back = Index.restore(host.save(os.path.join(tmp_path, "snap")))
    assert dict(PACK_EVENTS) == {"restore": 1}
    pk = back.pack()
    assert pk.backend == "cuda" and pk.db.is_pinned() and pk.db.device.type == "cpu"
    got = back.search(q)
    assert torch.equal(got.values, direct.values)
    assert torch.equal(got.indices, direct.indices)


# --- the kNN-LM slice: the datastore's key width, the decode step -----------


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("d", [1024, 1536, 2048])
def test_datastore_widths_match_plain(cuda_device, d, m):
    """Gaussian rows of 1024, 1536 and 2048 lanes (8, 12 and 16 stages a tile, one
    bulk copy a row, the queries reloaded each stage, each stage summed
    apart and folded in): both scans at k_scan 32 (the carry at the
    edge of shared memory) against their plain versions at the usual
    tolerances."""
    q, db, bias = packed_operands(m, 40_000, d, bin_size=256, dead=0.1,
                                  seed=d + m, device=cuda_device)
    score = bias_scorer(q, db, bias)
    v, i = prk.partial_reduce_packed(q, db, bias, bin_size=256)
    fv, fi = prk.partial_reduce_fused(q, db, bias, k_scan=32, bin_size=256)
    pv, pi = prk.partial_reduce_packed_plain(q, db, bias, bin_size=256)
    pfv, pfi = prk.partial_reduce_fused_plain(q, db, bias, k_scan=32, bin_size=256)
    torch.cuda.synchronize()
    assert_bin_winners_close(pv.cpu(), pi.cpu(), v.cpu(), i.cpu(), bin_size=256,
                             score=score)
    assert_topk_close(pfv.cpu(), pfi.cpu(), fv.cpu(), fi.cpu(), score=score)


@pytest.mark.parametrize("d", [1024, 1536, 2048])
def test_datastore_widths_integer_inputs_bit_equal(cuda_device, d):
    q, stored, bias, scale, packed = _integer_operands("f32", 256, 21, d=d)
    v, i = prk.partial_reduce_packed(q, stored, bias, bin_size=256)
    fv, fi = prk.partial_reduce_fused(q, stored, bias, k_scan=32, bin_size=256)
    pv, pi = prk.partial_reduce_packed_plain(q, stored, bias, bin_size=256)
    pfv, pfi = prk.partial_reduce_fused_plain(q, stored, bias, k_scan=32,
                                              bin_size=256)
    torch.cuda.synchronize()
    for got, want in ((v, pv), (i, pi), (fv, pfv), (fi, pfi)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_knn", [False, True])
def test_decode_step_on_card_matches_cpu(cuda_device, dtype, use_knn):
    """A dense smoke model moved to the card: prompt replay and decode
    steps give the CPU's logits (f32 within 1e-4 of the largest |logit|,
    bf16 within 2^-5), and greedy engines the same tokens at f32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("internlm2-1.8b-smoke"), dtype=dtype)
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = tfm.Transformer(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32))
    caches = [tfm.init_caches(cfg, 3, 160, device=dev) for dev in ("cpu", cuda_device)]
    rel = 1e-4 if dtype == "float32" else 2.0 ** -5
    for t in range(12):
        a, caches[0] = tfm.forward_decode(cpu, toks[:, t : t + 1], caches[0], t,
                                          use_knn=use_knn)
        b, caches[1] = tfm.forward_decode(card, toks[:, t : t + 1].to(cuda_device),
                                          caches[1], t, use_knn=use_knn)
        err = (a.float() - b.float().cpu()).abs().max()
        assert err <= rel * a.float().abs().max()
    if dtype == "float32":
        out = []
        for model in (cpu, card):
            eng = ServingEngine(cfg, model, batch=3, max_seq=160, use_knn=use_knn,
                                sample="greedy")
            reqs = [Request(rid=i, prompt=toks[i].numpy(), max_new_tokens=6)
                    for i in range(3)]
            eng.admit(reqs)
            eng.run(6)
            out.append([r.generated for r in reqs])
        assert out[0] == out[1]


def test_datastore_and_functional_search_on_card_match_cpu(cuda_device):
    """A datastore and the functional search on the card (the fused kernel
    and the merge: two launches, no plain call) against the same on the
    CPU, then after extend and forget."""
    from repro_torch.retrieval.datastore import KNNDatastore
    from repro_torch.search import functional

    rng = np.random.default_rng(4)
    keys = rng.standard_normal((30_000, 256), dtype=np.float32)
    toks = rng.integers(0, 1000, 30_000)
    q = rng.standard_normal((8, 256), dtype=np.float32)
    stores = [KNNDatastore(keys, toks, k=32, capacity=40_000, device=dev,
                           cluster="off", backend="cuda")
              for dev in ("cpu", cuda_device)]
    score = public_scorer("mips", q, keys)
    for step in range(2):
        prk.reset_counts()
        (cv, ct), (gv, gt) = (s.lookup(q) for s in stores)
        assert prk.LAUNCHES["partial_reduce_fused"] == 1 and len(prk.LAUNCHES) == 2
        gi = stores[1].index.search(q).indices
        assert_topk_close(cv, stores[0].index.search(q).indices, gv.cpu(), gi.cpu(),
                          score=score)
        assert torch.equal(gt, stores[1].value_tokens[gi.long()])
        extra = rng.standard_normal((5_000, 256), dtype=np.float32)
        keys = np.concatenate([keys, extra])
        score = public_scorer("mips", q, keys)
        for s in stores:
            s.extend(extra, np.arange(5_000))
            s.forget(np.arange(0, 30_000, 7))
    prk.reset_counts()
    fv, fi = functional.search(q, keys[:30_000], k=32)
    assert dict(prk.LAUNCHES) == {"partial_reduce_fused": 1, "fused_carry_merge": 1}
    cv, ci = functional.search(q, keys[:30_000], k=32, device="cpu")
    assert_topk_close(cv, ci, fv.cpu(), fi.cpu(),
                      score=public_scorer("mips", q, keys[:30_000]))


@pytest.mark.parametrize("use_knn", [False, True])
def test_engine_decode_graph_equals_eager_steps(cuda_device, use_knn):
    """On the card the engine replays one CUDA graph of the decode step
    from its second step on: logits and sampled tokens bit-equal to eager
    decode steps on the same inputs, position and Gumbel draws."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("internlm2-1.8b-smoke")
    model = tfm.init_model(cfg, torch.Generator(cuda_device).manual_seed(5),
                           device=cuda_device)
    engine = ServingEngine(cfg, model, batch=4, max_seq=160, use_knn=use_knn,
                           seed=9)
    step = M.make_decode_step(cfg, use_knn=use_knn)
    caches = tfm.init_caches(cfg, 4, 160, device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (4, 1), device=cuda_device,
                         dtype=torch.int32)
    for t in range(10):
        out = engine.step(forced_tokens=toks if t < 3 else None)
        noise = M.gumbel((4, cfg.decode_sample_k), gen, device=cuda_device)
        want, logits, caches = step(model, toks, caches, t, None, noise)
        assert bits_equal(engine.last_logits, logits)
        assert torch.equal(engine.tokens, want)
        assert (out == want[:, 0].cpu().numpy()).all()
        toks = want
    assert engine._graph is not None


# --- the other model families ------------------------------------------------

FAMILIES = ["deepseek-v2-236b-smoke", "granite-moe-3b-a800m-smoke",
            "mamba2-2.7b-smoke", "qwen2-vl-2b-smoke", "recurrentgemma-9b-smoke"]


@pytest.mark.parametrize("use_knn", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_engine_graph_equals_eager_steps(cuda_device, name, use_knn):
    """Each decoder-only family at smoke size: the engine's CUDA graph
    replays give the logits and tokens of eager steps on their own
    caches, bit for bit.  A cache the step rebinds instead of writing in
    place (an SSM state, a conv window, a ring slot, a latent row) goes
    stale from the second replay and fails this.  recurrentgemma runs 24
    steps into its window of 16, so the ring wraps under the graph."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(name)
    model = tfm.init_model(cfg, torch.Generator(cuda_device).manual_seed(5),
                           device=cuda_device, dtype=tfm._compute_dtype(cfg))
    engine = ServingEngine(cfg, model, batch=4, max_seq=160, use_knn=use_knn,
                           seed=9)
    step = M.make_decode_step(cfg, use_knn=use_knn)
    caches = tfm.init_caches(cfg, 4, 160, device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (4, 1), device=cuda_device,
                         dtype=torch.int32)
    for t in range(24 if cfg.local_window else 10):
        out = engine.step(forced_tokens=toks if t < 3 else None)
        noise = M.gumbel((4, cfg.decode_sample_k), gen, device=cuda_device)
        want, logits, caches = step(model, toks, caches, t, None, noise)
        assert bits_equal(engine.last_logits, logits), t
        assert torch.equal(engine.tokens, want)
        assert (out == want[:, 0].cpu().numpy()).all()
        toks = want
    assert engine._graph is not None
    for ours, theirs in zip(engine.caches, caches):
        for a, b in zip(ours, theirs):
            assert bits_equal(a, b)


@pytest.mark.parametrize("routing", ["exact", "approx"])
def test_moe_routing_on_card_equals_cpu(cuda_device, routing):
    """Integer-valued router inputs (exact logits, ties among them): the
    experts, queue places and drops on the card equal the CPU's, the
    weights to f32 rounding; the layer's output to 1e-5 relative."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(3)
    x = torch.randint(-3, 4, (1, 256, 32), generator=g).float()
    p = {k: torch.randn(v.shape, generator=g) * 0.2
         for k, v in moe.moe_defs(32, 16, 40, num_shared_experts=1).items()}
    p["router"] = torch.randint(-2, 3, (32, 40), generator=g).float()
    kw = dict(experts_per_token=8, num_experts=40, cap=moe._capacity(256, 8, 40, 0.5),
              routing=routing)
    cpu = moe._route(p, x, **kw)
    card = moe._route({k: v.to(cuda_device) for k, v in p.items()}, x.to(cuda_device),
                      **kw)
    for a, b in zip(cpu[1:], card[1:]):
        assert torch.equal(a, b.cpu())
    assert not cpu[3].all()
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-6, atol=1e-7)
    args = dict(experts_per_token=8, num_experts=40, capacity_factor=0.5,
                group_size=256, routing=routing)
    y = moe.moe_apply(p, x, **args)
    yc = moe.moe_apply({k: v.to(cuda_device) for k, v in p.items()},
                       x.to(cuda_device), **args)
    torch.testing.assert_close(yc.cpu(), y, rtol=1e-5, atol=1e-5)


def test_whisper_decode_on_card_matches_cpu(cuda_device):
    """whisper-medium-smoke at f32: the prefill step's logits and cross KV,
    then 12 decode steps reading it, on the card against the CPU within
    1e-4 of the largest |logit|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config("whisper-medium-smoke"), dtype="float32")
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = tfm.Transformer(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 12), generator=g,
                                     dtype=torch.int32),
             "enc_embeds": torch.randn((3, cfg.encoder_seq, cfg.d_model), generator=g)}
    prefill = M.make_prefill_step(cfg)
    a = prefill(cpu, batch)
    b = prefill(card, {k: v.to(cuda_device) for k, v in batch.items()})
    assert (a[0] - b[0].cpu()).abs().max() <= 1e-4 * a[0].abs().max()
    caches = [tfm.init_caches(cfg, 3, 64, device=dev) for dev in ("cpu", cuda_device)]
    for t in range(12):
        tok = batch["tokens"][:, t : t + 1]
        la, caches[0] = tfm.forward_decode(cpu, tok, caches[0], t, cross_kv=a[2])
        lb, caches[1] = tfm.forward_decode(card, tok.to(cuda_device), caches[1], t,
                                           cross_kv=b[2])
        assert (la - lb.cpu()).abs().max() <= 1e-4 * la.abs().max()


# --- sharding over a mesh of logical shards, stream=False, validate_hlo --------


def _logical_mesh(shape=(4,), names=("model",)):
    from repro_torch.parallel import make_mesh

    return make_mesh(shape, names, devices=["cuda:0"] * int(np.prod(shape)))


@pytest.mark.parametrize("storage", ["f32", "int8", "int4"])
def test_sharded_on_card_equals_per_shard_composition(cuda_device, storage):
    """Four logical shards on the card: 2 launches a shard and no plain
    call, bit for bit the one-device search of each shard's rows (recall
    accounted against the global N), offset, then ``merge_topk``."""
    from repro_torch.search import merge_topk

    rng = np.random.default_rng(4)
    n, d, k = 40_000, 128, 10
    db = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((100, d), dtype=np.float32)).cuda()
    ix = Index.build(db, metric="l2", k=k, storage=storage, cluster="off")
    sh = ix.shard(_logical_mesh())
    sh.search(q)  # builds the kernels
    torch.cuda.synchronize()
    prk.reset_counts()
    v, i = sh.search(q)
    torch.cuda.synchronize()
    assert sum(prk.LAUNCHES.values()) == 8 and not prk.PLAIN_CALLS
    n_local, parts_v, parts_i = n // 4, [], []
    for j in range(4):
        part = Index.build(db[j * n_local:(j + 1) * n_local], metric="l2",
                           k=k, storage=storage, cluster="off",
                           reduction_input_size_override=n)
        pv, pi = part.search(q)
        parts_v.append(-pv)
        parts_i.append(torch.where(pi >= 0, pi + j * n_local, pi).int())
    mv, mi = merge_topk(torch.cat(parts_v, 1), torch.cat(parts_i, 1), k)
    assert torch.equal(-mv, v) and torch.equal(mi, i)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_stream_false_on_card_bit_equal_to_one_call(cuda_device, storage):
    rng = np.random.default_rng(6)
    db = torch.from_numpy(rng.standard_normal((50_000, 128), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((300, 128), dtype=np.float32))
    kw = dict(metric="l2", k=10, storage=storage, cluster="off",
              query_block=64)
    one = Index.build(db.cuda(), **kw)
    loop = Index.build(db.cuda(), stream=False, **kw)
    want = one.search(q.cuda())
    from repro_torch.search import DISPATCH_COUNTS

    DISPATCH_COUNTS.clear()
    prk.reset_counts()
    got = loop.search(q.cuda())
    torch.cuda.synchronize()
    assert dict(DISPATCH_COUNTS) == {"cuda": 5}
    assert sum(prk.LAUNCHES.values()) == 10 and not prk.PLAIN_CALLS
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.indices, want.indices)


@pytest.mark.parametrize("m", [16, 10_000])
def test_validate_hlo_on_card_within_one_percent(cuda_device, m):
    db = torch.randn(100_000, 128, device="cuda")
    ix = Index.build(db, metric="l2", k=10, cluster="off")
    prk.reset_counts()
    hlo = ix.explain(m=m, validate_hlo=True)["hlo"]
    assert abs(hlo["flops_ratio"] - 1.0) < 0.01 and hlo["split_passes"] == 6
    assert not prk.LAUNCHES and not prk.PLAIN_CALLS  # counted, not run


def test_sharded_index_refuses_search_graph(cuda_device):
    sh = Index.build(torch.randn(4096, 64, device="cuda"), k=5,
                     cluster="off").shard(_logical_mesh())
    with pytest.raises(RuntimeError, match="eagerly"):
        sh.search_graph(16)


def test_sharded_index_served_eagerly_equals_direct(cuda_device):
    from repro_torch.search import SearchServer, ServeConfig, VirtualClock

    db = torch.randn(8192, 128, device="cuda")
    sh = Index.build(db, k=10, cluster="off").shard(_logical_mesh())
    server = SearchServer(sh, ServeConfig(max_batch=64),
                          clock=VirtualClock(), warmup=True)
    reqs = _requests(4, 6, d=128)
    tickets = [server.submit(q, k=k) for q, k in reqs]
    server.run_until_idle()
    for (q, k), t in zip(reqs, tickets):
        _bits_equal_direct(sh, q, k, t.result())
    s = server.stats()
    assert s["graph_replays"] == 0 and s["eager_batches"] == s["batches"]


def test_sharded_roofline_fraction_within_20_percent_of_unsharded(cuda_device):
    """C7: on the ``"h100"`` profile 4 logical shards of one card are
    priced one after another, so ``explain(measure=True)`` at the Sift1M
    shape reports a share of the bound within 20% of the unsharded
    index's."""
    db = torch.randn(1_000_000, 128, device="cuda")
    base = Index.build(db, metric="l2", k=10, cluster="off")
    sh = base.shard(_logical_mesh())
    p = sh.kernel_plan
    assert (p.shards_per_device, p.db_devices, p.ici_s) == (4, 1, 0.0)
    fractions = [ix.explain(m=10_000, measure=True)["measured"]["roofline_fraction"]
                 for ix in (sh, base)]
    assert 0.8 <= fractions[0] / fractions[1] <= 1.2, fractions


# --- training on the card (item 13b) -----------------------------------------


def _smoke_train(name="internlm2-1.8b-smoke", dtype=None, remat=None, seed=0):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch.train import to_device
    from repro_torch.models import model as M

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, **{k: v for k, v in
                                      (("dtype", dtype), ("remat", remat)) if v})
    state = M.init_train_state(torch.Generator(device="cuda").manual_seed(seed),
                               cfg, device="cuda")
    src = SyntheticTokenSource(
        cfg.vocab_size, 64, 4, seed=seed,
        input_mode=cfg.input_mode if not cfg.is_encoder_decoder else "tokens",
        d_model=cfg.d_model,
        enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0, mrope=cfg.mrope)
    return cfg, state, [to_device(src.batch(i), torch.device("cuda")) for i in range(3)]


def test_train_step_on_card_moves_the_parameters(cuda_device):
    from repro_torch.models import model as M

    cfg, state, batches = _smoke_train()
    before = [p.detach().clone() for p in state.params.parameters()]
    state, metrics = M.make_train_step(cfg, learning_rate=3e-3)(state, batches[0])
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert metrics["loss"].device.type == "cuda" and int(state.step) == 1
    moved = [not torch.equal(a, p) for a, p in zip(before, state.params.parameters())]
    assert all(moved)
    assert all(p.grad is None for p in state.params.parameters())


@pytest.mark.parametrize("name", ["internlm2-1.8b-smoke", "granite-moe-3b-a800m-smoke"])
def test_remat_dots_equals_none_on_card(cuda_device, name):
    """At f32 the recomputed layers give the gradients of the unrecomputed
    ones (rtol 1e-5, atol 1e-7: the embedding's backward adds with
    atomics, in no fixed order)."""
    from repro_torch.models import model as M

    grads = {}
    for remat in ("none", "dots"):
        cfg, state, batches = _smoke_train(name, dtype="float32", remat=remat)
        loss = M.loss_fn(state.params, cfg, batches[0])
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in state.params.named_parameters()}
    for n, g in grads["none"].items():
        torch.testing.assert_close(grads["dots"][n], g, rtol=1e-5, atol=1e-7)


def test_checkpoint_from_card_restores_onto_card(cuda_device, tmp_path):
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.models import model as M

    cfg, state, batches = _smoke_train("whisper-medium-smoke")
    step = M.make_train_step(cfg, learning_rate=3e-3)
    for b in batches[:2]:
        state, _ = step(state, b)
    writer = AsyncCheckpointer(str(tmp_path))
    writer.save(2, state)
    writer.wait()
    like = M.init_train_state(torch.Generator(device="cuda").manual_seed(1), cfg,
                              device="cuda")
    restored, at = restore_checkpoint(str(tmp_path), like)
    assert at == 2 and int(restored.step) == 2
    for a, b in zip(restored.params.parameters(), state.params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    for k in state.opt_state.m:
        assert torch.equal(restored.opt_state.m[k], state.opt_state.m[k])
        assert torch.equal(restored.opt_state.v[k], state.opt_state.v[k])


# --- the mesh rules and the dry run (item 13b steps 5–6) ----------------------


def test_knn_attention_under_a_mesh_on_card_takes_the_cp_path(cuda_device):
    """Under ``use_mesh`` of a logical (1, 4) mesh of the card, the public
    kNN attention equals the explicit context-parallel call bit for bit,
    and the card's value is the CPU's (rtol 1e-5, atol 1e-5)."""
    from repro_torch.models import attention as attn
    from repro_torch.parallel import make_mesh, use_mesh

    g = torch.Generator().manual_seed(5)
    q, keys, values = (torch.randn(s, generator=g) for s in
                       ((2, 4, 16), (2, 256, 2, 16), (2, 256, 2, 16)))
    valid = torch.arange(256) < 200
    kw = dict(k=8, recall_target=0.95, kv_groups=2)
    out = {}
    for dev in ("cpu", "cuda:0"):
        mesh = make_mesh((1, 4), ("data", "model"), devices=[dev] * 4)
        a = [t.to(dev) for t in (q, keys, values, valid)]
        with use_mesh(mesh):
            out[dev] = attn.knn_decode_attention(*a, **kw)
        want = attn._knn_decode_attention_cp(*a, mesh=mesh, cp_axes=("model",), **kw)
        assert torch.equal(out[dev], want)
    torch.testing.assert_close(out["cuda:0"].cpu(), out["cpu"], rtol=1e-5, atol=1e-5)


def test_trainer_model_parallel_on_card_equals_one(cuda_device):
    """``--model-parallel 2`` on one card is a (1, 1) mesh: the losses and
    the state equal ``--model-parallel 1``'s bit for bit (deterministic
    algorithms on: the embedding's backward otherwise adds with atomics
    in no fixed order)."""
    from repro_torch.launch import train

    args = ["--arch", "internlm2-1.8b-smoke", "--steps", "3", "--seq", "32",
            "--log-every", "1"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one = train.main(args + ["--model-parallel", "1"])
        two = train.main(args + ["--model-parallel", "2"])
    finally:
        torch.use_deterministic_algorithms(False)
    assert tuple(two["mesh"].shape.values()) == (1, 1)
    assert two["losses"] == one["losses"]
    for p, q in zip(one["state"].params.parameters(), two["state"].params.parameters()):
        assert p.device.type == "cuda" and torch.equal(p, q)


@pytest.mark.parametrize("kind", ["train", "knn_decode"])
def test_count_cell_equals_the_cards_flop_counter(cuda_device, kind):
    """The dry run's dot FLOPs of a smoke step (counted on fake tensors)
    are those of the same step run on the card under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardspecs import cell_rules
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import use_mesh

    cfg = get_config("internlm2-1.8b-smoke")
    shape = (ShapeConfig("train", 64, 4, "train") if kind == "train"
             else ShapeConfig("long_500k", 512, 1, "decode"))
    counted = count_cell(cfg, shape, make_host_mesh(1, devices=["meta"])).dot_flops
    g = torch.Generator(device="cuda").manual_seed(0)
    mesh = make_host_mesh(1)
    with use_mesh(mesh, rules=cell_rules(cfg, shape, mesh)):
        if kind == "train":
            state = M.init_train_state(g, cfg, device="cuda")
            batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), device="cuda",
                                      dtype=torch.int32) for k in ("tokens", "labels")}
            step = M.make_train_step(cfg)
            with FlopCounterMode(display=False) as flops:
                step(state, batch)
        else:
            model = tfm.init_model(cfg, g, device="cuda")
            caches = tfm.init_caches(cfg, 1, 512, device="cuda")
            step = M.make_decode_step(cfg, use_knn=True)
            noise = torch.zeros((1, cfg.decode_sample_k), device="cuda")
            with FlopCounterMode(display=False) as flops:
                step(model, torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
                     caches, 511, None, noise=noise)
    assert flops.get_total_flops() == counted > 0


def test_restore_checkpoint_with_shardings_onto_the_card(cuda_device, tmp_path):
    """A CPU state's checkpoint restored into a CPU state with ``shardings=``
    of a logical (1, 2) mesh of the card (the elastic restart), and the
    CPU state re-placed there by ``remesh_state``: every leaf on the card,
    bit-equal."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.ft import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import make_mesh

    from repro_torch.configs import get_config

    cfg = get_config("internlm2-1.8b-smoke")
    state = M.init_train_state(torch.Generator().manual_seed(3), cfg, device="cpu")
    want = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    save_checkpoint(str(tmp_path), 0, state)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
    like = M.init_train_state(torch.Generator().manual_seed(4), cfg, device="cpu")
    sh = SS.sanitize_tree(SS.train_state_shardings(cfg, mesh), like, mesh)
    restored, _ = restore_checkpoint(str(tmp_path), like, shardings=sh)
    axes = tfm.model_axes(cfg)
    moved = remesh_state(state, M.TrainState(step=(), params=axes,
                                             opt_state=AdamWState(m=axes, v=axes)), mesh)
    for s in (restored, moved):
        for n, p in s.params.named_parameters():
            assert p.device == torch.device("cuda", 0) and torch.equal(p.cpu(), want[n])
            assert s.opt_state.m[n].device.type == "cuda"


# -- training across processes (parallel.distributed) --------------------------

_DIST_ARGS = ["--arch", "internlm2-1.8b-smoke", "--seq", "32", "--global-batch",
              "4", "--lr", "3e-3", "--log-every", "1", "--steps", "3",
              "--deterministic"]


def _dist_trainer(rank, argv):
    from repro_torch.launch import train

    out = train.main(argv)
    return dict(losses=out["losses"], grad_norms=out["grad_norms"],
                mesh=tuple(out["mesh"].shape.values()),
                params={n: p.detach().cpu().numpy()
                        for n, p in out["state"].params.named_parameters()})


def test_nccl_world_of_one_is_bit_equal_to_the_single_process(cuda_device,
                                                              tmp_path,
                                                              monkeypatch):
    """One NCCL rank (a (1, 1) process mesh) steps the trainer as the
    single process does, bit for bit (deterministic algorithms on)."""
    import torch_dist_parity as P

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    try:
        one = _dist_trainer(0, _DIST_ARGS + ["--device", "cuda"])
    finally:
        torch.use_deterministic_algorithms(False)
    rank = P.spawn(1, _dist_trainer, _DIST_ARGS + ["--dist-backend", "nccl"],
                   str(tmp_path), backend="nccl")
    assert rank["mesh"] == (1, 1)
    assert rank["losses"] == one["losses"] and rank["grad_norms"] == one["grad_norms"]
    for name, p in one["params"].items():
        assert np.array_equal(rank["params"][name], p), name


def test_two_gloo_ranks_on_one_card_match_the_cpu(cuda_device, tmp_path):
    """Two ranks sharing the card over gloo (collectives staged through
    pinned host memory), on a (1, 2) tensor-parallel and a (2, 1)
    data-parallel mesh, internlm2-1.8b-smoke at f32, agree with the same
    two meshes on the CPU: losses and grad norms within rtol 1e-5, the
    parameters within rtol 1e-5 / atol 1e-6 where no step's gradient fell
    below 1e-6."""
    import torch_dist_parity as P

    cases = {m: P.case("internlm2-1.8b-smoke", m) for m in ("tp2", "dp2")}
    cpu = P.spawn(2, P.port_cases, {k: (c, None) for k, c in cases.items()},
                  str(tmp_path))
    card = P.spawn(2, P.port_cases, {k: (dict(c, device="cuda:0"), None)
                                     for k, c in cases.items()}, str(tmp_path))
    for key, c in cases.items():
        got, want = card[key], cpu[key]
        assert not got["bad_shapes"]
        for name in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[name], want[name], rtol=P.F32_RTOL,
                                       err_msg=f"{key} {name}")
        for name, p in got["final"].items():
            keep = ~(want["small"][name] | got["small"][name])
            np.testing.assert_allclose(p[keep], want["final"][name][keep],
                                       rtol=P.F32_RTOL, atol=P.F32_ATOL,
                                       err_msg=f"{key} {name}")


def test_two_gloo_ranks_on_one_card_tp_inputs_match_the_cpu(cuda_device, tmp_path):
    """Tensor parallelism for an encoder-decoder with two ranks sharing the
    card over gloo: whisper-medium-smoke at f32 on a (1, 2) mesh (the
    encoder's layers, the decoder's self- and cross-attention and the
    MLPs split by heads and d_ff, the encoder output's gradient summed
    over "model" once), agrees with the same ranks on the CPU: losses and
    grad norms within rtol 1e-5, the parameters within rtol 1e-5 / atol
    1e-6 where no step's gradient fell below 1e-6, and the same
    collectives a step."""
    import torch_dist_parity as P

    cases = {"whisper": P.case("whisper-medium-smoke", "tp2")}
    cpu = P.spawn(2, P.port_cases, {k: (c, None) for k, c in cases.items()},
                  str(tmp_path))
    card = P.spawn(2, P.port_cases, {k: (dict(c, device="cuda:0"), None)
                                     for k, c in cases.items()}, str(tmp_path))
    got, want = card["whisper"], cpu["whisper"]
    assert not got["bad_shapes"] and got["split"] == want["split"]
    assert {"encoder.0.attn.wq", "layers.0.cross.wk"} <= set(got["split"])
    assert got["collectives"] == want["collectives"]
    for name in ("losses", "grad_norms"):
        np.testing.assert_allclose(got[name], want[name], rtol=P.F32_RTOL,
                                   err_msg=name)
    for name, p in got["final"].items():
        keep = ~(want["small"][name] | got["small"][name])
        np.testing.assert_allclose(p[keep], want["final"][name][keep],
                                   rtol=P.F32_RTOL, atol=P.F32_ATOL, err_msg=name)


def test_two_gloo_ranks_on_one_card_moe_mla_match_the_cpu(cuda_device, tmp_path):
    """Tensor parallelism for MoE experts and MLA heads with two ranks
    sharing the card over gloo: granite-moe-3b-a800m-smoke and
    deepseek-v2-236b-smoke at f32 on a (1, 2) mesh (half the experts and
    heads a rank, every token routed on each, the router's and MLA's
    latent projections' gradients summed over "model") agree with the
    same ranks on the CPU: losses and grad norms within rtol 1e-5, the
    parameters within rtol 1e-5 / atol 1e-6 where no step's gradient fell
    below 1e-6, the same names split and summed, and the same collectives
    a step."""
    import torch_dist_parity as P

    cases = {"moe": P.case("granite-moe-3b-a800m-smoke", "tp2"),
             "mla": P.case("deepseek-v2-236b-smoke", "tp2")}
    cpu = P.spawn(2, P.port_cases, {k: (c, None) for k, c in cases.items()},
                  str(tmp_path))
    card = P.spawn(2, P.port_cases, {k: (dict(c, device="cuda:0"), None)
                                     for k, c in cases.items()}, str(tmp_path))
    for key in cases:
        got, want = card[key], cpu[key]
        assert not got["bad_shapes"] and got["split"] == want["split"]
        assert got["partial"] == want["partial"] and got["partial"]
        assert got["collectives"] == want["collectives"]
        for name in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[name], want[name], rtol=P.F32_RTOL,
                                       err_msg=f"{key} {name}")
        for name, p in got["final"].items():
            keep = ~(want["small"][name] | got["small"][name])
            np.testing.assert_allclose(p[keep], want["final"][name][keep],
                                       rtol=P.F32_RTOL, atol=P.F32_ATOL,
                                       err_msg=f"{key} {name}")


def test_two_gloo_ranks_on_one_card_recurrent_match_the_cpu(cuda_device, tmp_path):
    """Tensor parallelism for the SSD and RG-LRU with local attention with
    two ranks sharing the card over gloo: mamba2-2.7b-smoke and
    recurrentgemma-9b-smoke at f32 on a (1, 2) mesh (half the SSD heads,
    ``in_proj`` and the conv gathered over "model"; half the RG-LRU
    channels, the dense gates' outputs reduce-scattered; the one kv head
    whole, its gradients summed) agree with the same ranks on the CPU:
    losses and grad norms within rtol 1e-5, the parameters within rtol
    1e-5 / atol 1e-6 where no step's gradient fell below 1e-6, the same
    names split and summed, and the same collectives a step."""
    import torch_dist_parity as P

    cases = {"ssm": P.case("mamba2-2.7b-smoke", "tp2"),
             "rglru": P.case("recurrentgemma-9b-smoke", "tp2")}
    cpu = P.spawn(2, P.port_cases, {k: (c, None) for k, c in cases.items()},
                  str(tmp_path))
    card = P.spawn(2, P.port_cases, {k: (dict(c, device="cuda:0"), None)
                                     for k, c in cases.items()}, str(tmp_path))
    for key in cases:
        got, want = card[key], cpu[key]
        assert not got["bad_shapes"] and got["split"] == want["split"]
        assert got["partial"] == want["partial"]
        assert got["collectives"] == want["collectives"]
        assert any(k.startswith("reduce_scatter[model]")
                   for k in got["collectives"][0])
        for name in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[name], want[name], rtol=P.F32_RTOL,
                                       err_msg=f"{key} {name}")
        for name, p in got["final"].items():
            keep = ~(want["small"][name] | got["small"][name])
            np.testing.assert_allclose(p[keep], want["final"][name][keep],
                                       rtol=P.F32_RTOL, atol=P.F32_ATOL,
                                       err_msg=f"{key} {name}")


def test_two_gloo_ranks_on_one_card_zero3_match_the_cpu(cuda_device, tmp_path):
    """ZeRO-3 with two ranks sharing the card over gloo: granite-20b-smoke
    with ``fsdp_params`` at f32 on a (2, 1) mesh, each layer's parameters
    all-gathered and their gradients reduce-scattered through pinned host
    memory (input and output side by side in the staging buffer), agrees
    with the same ranks on the CPU: losses and grad norms within rtol
    1e-5, the parameters within rtol 1e-5 / atol 1e-6 where no step's
    gradient fell below 1e-6, and the same collectives a step."""
    import torch_dist_parity as P

    cases = {"zero3": P.case("granite-20b-smoke", "dp2", fsdp=True)}
    cpu = P.spawn(2, P.port_cases, {k: (c, None) for k, c in cases.items()},
                  str(tmp_path))
    card = P.spawn(2, P.port_cases, {k: (dict(c, device="cuda:0"), None)
                                     for k, c in cases.items()}, str(tmp_path))
    got, want = card["zero3"], cpu["zero3"]
    assert not got["bad_shapes"] and got["data_split"] == want["data_split"]
    assert got["data_split"] and got["collectives"] == want["collectives"]
    assert got["collectives"][0]["reduce_scatter[data]"] == len(got["data_split"])
    for name in ("losses", "grad_norms"):
        np.testing.assert_allclose(got[name], want[name], rtol=P.F32_RTOL,
                                   err_msg=name)
    for name, p in got["final"].items():
        keep = ~(want["small"][name] | got["small"][name])
        np.testing.assert_allclose(p[keep], want["final"][name][keep],
                                   rtol=P.F32_RTOL, atol=P.F32_ATOL, err_msg=name)
