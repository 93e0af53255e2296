"""repro_torch's kernel front ends (plain versions, on the CPU) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

Values must be allclose and indices equal up to near ties
(``repro_torch.testing``).  The CUDA kernels themselves are held against
these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.partial_reduce import partial_reduce_fused as ref_fused
from repro.kernels.partial_reduce import partial_reduce_packed as ref_packed
from repro_torch import testing
from repro_torch.kernels import partial_reduce as prk
from repro_torch.search.stages import (
    MASK_VALUE,
    merge_topk,
    pad_queries_to,
    sentinelize_masked,
)
from repro_torch.testing import (
    KERNEL_CASES,
    assert_bin_winners_close,
    assert_topk_close,
    bias_scorer,
    packed_operands,
)


def _ref_block_n(n_pad, bin_size):
    """A reference tile that divides the port's padded layout."""
    return next(b for b in (1024, 512, 256, 128, bin_size)
                if b >= bin_size and n_pad % b == 0)


def _case(name):
    case = KERNEL_CASES[name]
    q, db, bias = packed_operands(**case, seed=len(name))
    jq, jdb, jbias = (jnp.asarray(t.numpy()) for t in (q, db, bias))
    kw = dict(bin_size=case["bin_size"],
              block_n=_ref_block_n(db.shape[0], case["bin_size"]),
              interpret=True)
    return case, (q, db, bias), (jq, jdb, jbias), kw


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_packed_plain_matches_pallas(name):
    case, (q, db, bias), (jq, jdb, jbias), kw = _case(name)
    ref_v, ref_i = ref_packed(jq, jdb, jbias, **kw)
    prk.reset_counts()
    vals, idxs = prk.partial_reduce_packed(q, db, bias, bin_size=case["bin_size"])
    assert prk.PLAIN_CALLS["partial_reduce_packed"] == 1 and not prk.LAUNCHES
    assert vals.shape == (case["m"], db.shape[0] // case["bin_size"])
    assert idxs.dtype == torch.int32
    assert_bin_winners_close(ref_v, ref_i, vals, idxs,
                             bin_size=case["bin_size"],
                             score=bias_scorer(q, db, bias))


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_fused_plain_matches_pallas(name):
    case, (q, db, bias), (jq, jdb, jbias), kw = _case(name)
    k_scan = case["k_scan"]
    ref_v, ref_i = ref_fused(jq, jdb, jbias, k_scan=k_scan, **kw)
    vals, idxs = prk.partial_reduce_fused(
        q, db, bias, k_scan=k_scan, bin_size=case["bin_size"]
    )
    assert vals.shape == idxs.shape == (case["m"], k_scan)
    assert_topk_close(ref_v, ref_i, vals, idxs, score=bias_scorer(q, db, bias))
    # masked entries are exactly (MASK, -1), live ones sorted descending
    masked = idxs.numpy() < 0
    assert (vals.numpy()[masked] == MASK_VALUE).all()
    assert (np.diff(vals.numpy(), axis=1) <= 0).all()
    if name == "kscan_gt_bins":
        assert masked[:, -(k_scan - db.shape[0] // case["bin_size"]):].all()


@pytest.mark.parametrize("name", [n for n, c in KERNEL_CASES.items()
                                  if c["k_scan"] * c["bin_size"] <= c["n"]])
def test_fused_equals_two_pass_merge(name):
    """fused == two-pass + sentinelize_masked + merge_topk, exactly: the
    same scores, ordered by one stable rule."""
    case = KERNEL_CASES[name]
    q, db, bias = packed_operands(**case, seed=1)
    fv, fi = prk.partial_reduce_fused(
        q, db, bias, k_scan=case["k_scan"], bin_size=case["bin_size"]
    )
    v, i = prk.partial_reduce_packed(q, db, bias, bin_size=case["bin_size"])
    mv, mi = merge_topk(v, sentinelize_masked(v, i, case["n"]), case["k_scan"])
    np.testing.assert_array_equal(fv.numpy(), mv.numpy())
    np.testing.assert_array_equal(fi.numpy(), mi.numpy())


@pytest.mark.parametrize("name", ["bin16_d100", "tomb90_l2", "masked_tile"])
def test_split_carries_merge_to_one_carry(name):
    """The CUDA design in plain form: carries of bin-aligned row splits,
    merged by fused_carry_merge, equal the carry of the whole range."""
    case = KERNEL_CASES[name]
    q, db, bias = packed_operands(**case, seed=2)
    qp = pad_queries_to(q, db.shape[1])
    kw = dict(k_scan=case["k_scan"], bin_size=case["bin_size"])
    whole = prk.partial_reduce_fused_plain(qp, db, bias, **kw)
    bounds = [0, 128, 384, 512, db.shape[0]]
    parts = []
    for a, b in zip(bounds, bounds[1:]):
        v, i = prk.partial_reduce_fused_plain(qp, db[a:b], bias[:, a:b], **kw)
        parts.append((v, torch.where(i >= 0, i + a, i)))
    merged = prk.fused_carry_merge(torch.stack([v for v, _ in parts]),
                                   torch.stack([i for _, i in parts]))
    for a, b in zip(whole, merged):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_tie_order_is_stable_sort():
    """Among exactly equal scores the earlier row comes first, and every
    fully masked bin is (MASK, -1) — the order the reference's carry
    produces, pinned on data made of ties."""
    bin_size, n = 4, 256
    q = torch.ones((3, 128))
    db = torch.zeros((n, 128))
    db[:, 0] = torch.tensor(np.random.default_rng(0).integers(0, 3, n),
                            dtype=torch.float32)
    bias = torch.zeros((1, n))
    bias[0, 40:120] = MASK_VALUE
    vals, idxs = prk.partial_reduce_fused(q, db, bias, k_scan=n // bin_size,
                                          bin_size=bin_size)
    ref_v, ref_i = ref_fused(jnp.asarray(q.numpy()), jnp.asarray(db.numpy()),
                             jnp.asarray(bias.numpy()), k_scan=n // bin_size,
                             bin_size=bin_size, block_n=128, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ref_i))
    live = idxs[0][idxs[0] >= 0].numpy()
    keyed = list(zip(-vals[0][: len(live)].numpy(), live))
    assert keyed == sorted(keyed)
    assert (idxs[0][len(live):] == -1).all()


def test_front_end_contract():
    q, db, bias = packed_operands(m=4, n=256, d=8, bin_size=16)
    with pytest.raises(ValueError, match="bias must be"):
        prk.partial_reduce_packed(q, db, bias[:, :-1], bin_size=16)
    with pytest.raises(ValueError, match="power of two"):
        prk.partial_reduce_packed(q, db, bias, bin_size=24)
    with pytest.raises(ValueError, match="exceeds packed dim"):
        prk.partial_reduce_fused(torch.zeros((4, 200)), db, bias, k_scan=2,
                                 bin_size=16)
    with pytest.raises(ValueError, match="float32"):
        prk.partial_reduce_fused(q.double(), db, bias, k_scan=2, bin_size=16)
    with pytest.raises(ValueError, match="k_scan"):
        prk.partial_reduce_fused(q, db, bias, k_scan=0, bin_size=16)


def test_ptxas_table_reads_each_kernel():
    from repro_torch.kernels.build import ptxas_table

    report = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z5mergev' for 'sm_90a'
ptxas info    : Function properties for _Z5mergev
    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 256 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z4scanILb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4scanILb1EEvv
    32 bytes stack frame, 28 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 32 bytes cumulative stack size
"""
    assert ptxas_table(report) == [
        {"kernel": "_Z5mergev", "registers": 32, "stack": 256,
         "spill_stores": 0, "spill_loads": 0, "smem": 0},
        {"kernel": "_Z4scanILb1EEvv", "registers": 64, "stack": 32,
         "spill_stores": 28, "spill_loads": 32, "smem": 0},
    ]


def _signed(lo, hi):
    """f32 values of magnitude in [lo, hi], either sign, and 0."""
    mag = st.floats(min_value=lo, max_value=hi, width=32) | st.just(0.0)
    return st.tuples(mag, st.booleans()).map(lambda t: -t[0] if t[1] else t[0])


@settings(max_examples=300, deadline=None)
@given(st.lists(_signed(2.0**-100, 2.0**127), min_size=1, max_size=48))
def test_query_split_reconstructs_exactly(values):
    """The CUDA kernels' bf16 split of the queries: three bf16 parts whose
    sum is the f32 value, exactly, across f32's range."""
    q = torch.tensor([values], dtype=torch.float32)
    parts = prk.split_queries(q)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *q.shape)
    assert torch.equal(parts.double().sum(0), q.double())
    # the larger parts come first: each is the rounding of what is left
    assert torch.equal(parts[0], q.to(torch.bfloat16))


@settings(max_examples=300, deadline=None)
@given(st.lists(_signed(2.0**-60, 2.0**60), min_size=1, max_size=48),
       st.integers(0, 2**32 - 1))
def test_query_split_products_are_exact(values, seed):
    """A part times a stored value of each quantized tier (int8 codes,
    int4 codes, bf16 rows) is exact in f32: the tensor cores' products
    lose nothing, only their f32 sum rounds."""
    q = torch.tensor([values], dtype=torch.float32)
    rng = np.random.default_rng(seed)
    d = q.shape[1]
    stored = [
        torch.from_numpy(rng.integers(-127, 128, d).astype(np.float32)),
        torch.from_numpy(rng.integers(-7, 8, d).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(d).astype(np.float32)
                         * np.float32(10.0 ** rng.uniform(-3, 3))
                         ).to(torch.bfloat16).float(),
    ]
    for part in prk.split_queries(q):
        for x in stored:
            assert torch.equal((part.float() * x).double(),
                               part.double() * x.double())


# (m, n_pad, bin_size): the Sift1M shape at the f32 and int4 bins, Glove1.2M
# at int4's, and small tables with few bins or many splits.
PLAN_CASES = [(10_000, 1_003_520, 4096), (16, 1_003_520, 4096),
              (16, 1_000_448, 1024), (2000, 1_193_984, 2048),
              (300, 200_704, 4096), (3, 65_536, 128), (1, 3072, 32)]


@pytest.mark.parametrize("m, n_pad, bin_size", PLAN_CASES)
@pytest.mark.parametrize("k_scan", [0, 10, 30, 512])
def test_split_plan_covers_the_rows(m, n_pad, bin_size, k_scan):
    """The split plan cuts the rows into bin-aligned splits, none empty,
    within the merge kernel's limit; a carry to merge (k_scan; 0 for the
    two-pass kernel, which merges nothing) never asks for more splits
    than no carry, and with nothing to merge a small batch spreads over
    the SMs."""
    tps, splits = prk.split_plan(m, n_pad, bin_size, 132, k_scan)
    tiles, per_bin = n_pad // prk.BLOCK_N, max(1, bin_size // prk.BLOCK_N)
    assert tps % per_bin == 0 and 1 <= splits <= prk.MAX_SPLITS
    assert (splits - 1) * tps < tiles <= splits * tps
    assert splits <= prk.split_plan(m, n_pad, bin_size, 132, 0)[1]
    if k_scan == 0 and m <= prk.BLOCK_M:
        assert splits >= min(tiles // per_bin, 132) // 2


@pytest.mark.parametrize("first", [-0.0, 0.0])
def test_plain_merge_ties_signed_zeros(first):
    """-0.0 and +0.0 are equal to the merge (``torch.sort`` ranks them
    so): the lower split comes first, each with the value bits it had."""
    part_v = torch.tensor([[[first, -1.0]], [[-first, MASK_VALUE]]])
    part_i = torch.tensor([[[7, 8]], [[3, -1]]], dtype=torch.int32)
    v, i = prk.fused_carry_merge(part_v, part_i)
    assert i.tolist() == [[7, 3]]
    assert testing.bits_equal(v, torch.tensor([[first, -first]]))


def _k_way_merge(part_v, part_i):
    """The merge kernel's rule in plain Python: repeatedly take the largest
    head of the splits' carries, the lowest split among equal values."""
    splits, m, k_scan = part_v.shape
    vals, idxs = np.zeros((m, k_scan), np.float32), np.zeros((m, k_scan), np.int32)
    for row in range(m):
        head = [0] * splits
        for j in range(k_scan):
            s = max((s for s in range(splits) if head[s] < k_scan),
                    key=lambda s: (float(part_v[s, row, head[s]]), -s))
            vals[row, j] = part_v[s, row, head[s]]
            idxs[row, j] = part_i[s, row, head[s]]
            head[s] += 1
    return torch.from_numpy(vals), torch.from_numpy(idxs)


@pytest.mark.parametrize("splits, m, k_scan", [(1, 3, 5), (2, 4, 1), (5, 7, 10),
                                               (33, 2, 30), (9, 5, 33)])
def test_plain_merge_is_a_k_way_merge(splits, m, k_scan):
    """On sorted carries dense in ties (both zeros, masked tails), the
    plain merge's stable sort is the k-way merge the CUDA kernel runs,
    bit for bit."""
    part_v, part_i = testing.tied_carries(splits, m, k_scan, seed=splits + k_scan)
    v, i = prk.fused_carry_merge(part_v, part_i)
    kv, ki = _k_way_merge(part_v.numpy(), part_i.numpy())
    assert testing.bits_equal(v, kv) and torch.equal(i, ki)


@pytest.mark.parametrize("m, n_pad, bin_size",
                         [c for c in PLAN_CASES if c[0] <= prk.BLOCK_M])
@pytest.mark.parametrize("k_scan", [10, 30])
def test_split_plan_spreads_a_small_batch(m, n_pad, bin_size, k_scan):
    """With a carry to merge, a small batch still spreads over the SMs as
    it does with none: the merge no longer holds the split count down."""
    _, splits = prk.split_plan(m, n_pad, bin_size, 132, k_scan)
    groups = n_pad // prk.BLOCK_N // max(1, bin_size // prk.BLOCK_N)
    assert splits >= min(groups, 132) // 2


@pytest.mark.parametrize("m", [1, 16, 129, 10_000])
@pytest.mark.parametrize("k_scan", [1, 10, 30, 60, 512])
def test_merge_cost_non_decreasing(m, k_scan):
    """The split plan's merge cost never falls as the splits grow, and is
    0 without a carry."""
    costs = [prk.merge_cost(m, s, k_scan) for s in range(1, prk.MAX_SPLITS + 1)]
    assert all(a <= b for a, b in zip(costs, costs[1:]))
    assert costs[0] > 0 and prk.merge_cost(m, prk.MAX_SPLITS, 0) == 0
