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
    packed_operands,
    public_scorer,
    stored_operands,
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


@pytest.mark.parametrize("k_scan", [129, 512])
def test_fused_k_scan_limit(cuda_device, k_scan):
    """Above 128 entries the carry lives in device memory; the kernel
    answers as its plain version does."""
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
