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


def test_fused_k_scan_limit(cuda_device):
    q, db, bias = packed_operands(m=4, n=4096, d=16, bin_size=1,
                                  device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        prk.partial_reduce_fused(q, db, bias, k_scan=prk.MAX_K_SCAN + 1,
                                 bin_size=1)


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


def test_search_steady_state_on_card(cuda_device):
    """Any M is one scan launch plus one merge launch, and a search
    allocates nothing near the size of the database."""
    rng = np.random.default_rng(9)
    index = Index.build(rng.standard_normal((100_000, 128), dtype=np.float32),
                        metric="l2", k=10)
    db_bytes = index.pack().db.numel() * 4
    for m in (1, 100, 5000):
        q = torch.randn((m, 128), device=cuda_device)
        index.search(q)
        torch.cuda.synchronize()
        prk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        index.search(q)
        torch.cuda.synchronize()
        assert dict(prk.LAUNCHES) == {"partial_reduce_fused": 1,
                                      "fused_carry_merge": 1}
        assert torch.cuda.max_memory_allocated() - before < db_bytes // 4
