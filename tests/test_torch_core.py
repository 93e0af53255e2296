"""repro_torch.core against repro.core: bin planning, PartialReduce,
exact rescoring and approx top-k, on the same numpy inputs.

Integers and plans must be equal.  The reductions do no arithmetic, so
their values and indices must be equal too, ties included: inputs drawn
from a few integers are mostly ties.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import binning as ref_binning
from repro.core.partial_reduce import partial_reduce_with_plan as ref_partial_reduce
from repro.core.rescoring import bitonic_sort_pairs as ref_bitonic
from repro.core.rescoring import exact_rescoring as ref_exact_rescoring
from repro.core.topk import approx_max_k as ref_approx_max_k
from repro.core.topk import approx_min_k as ref_approx_min_k
from repro_torch.core import (
    approx_max_k,
    approx_min_k,
    bins_for_recall,
    bitonic_sort_pairs,
    exact_rescoring,
    expected_recall,
    partial_reduce_with_plan,
    plan_bins,
)
from repro_torch.testing import bits_equal

SIZES = [1, 2, 7, 100, 1000, 2048, 4097, 65537, 1_000_000, 1_183_514]
KS = [1, 2, 10, 64, 100]
TARGETS = [0.5, 0.9, 0.95, 0.99, 0.999]


def _plan_pair(n, k, r, override):
    ours = plan_bins(n, k, r, reduction_input_size_override=override)
    ref = ref_binning.plan_bins(n, k, r, reduction_input_size_override=override)
    return dataclasses.astuple(ours), dataclasses.astuple(ref)


@pytest.mark.parametrize("override_factor", [0, 1, 4])
def test_plan_bins_grid_equals_reference(override_factor):
    for n in SIZES:
        for k in KS:
            if k > n:
                continue
            for r in TARGETS:
                override = n * override_factor if override_factor else -1
                ours, ref = _plan_pair(n, k, r, override)
                assert ours == ref, (n, k, r, override)


@settings(max_examples=40, derandomize=True, deadline=None, database=None)
@given(
    n=st.integers(1, 5_000_000),
    k=st.integers(1, 512),
    r=st.floats(0.01, 0.999),
    override_factor=st.sampled_from([0, 1, 2, 8]),
)
def test_plan_bins_random_equals_reference(n, k, r, override_factor):
    k = min(k, n)
    ours, ref = _plan_pair(n, k, r, n * override_factor if override_factor else -1)
    assert ours == ref


def test_recall_math_equals_reference():
    for k in KS:
        for r in TARGETS:
            assert bins_for_recall(k, r) == ref_binning.bins_for_recall(k, r)
        for num_bins in [1, 2, 3, 10, 245, 289, 4096]:
            assert expected_recall(num_bins, k) == ref_binning.expected_recall(
                num_bins, k
            )
    with pytest.raises(ValueError):
        plan_bins(10, 11)
    with pytest.raises(ValueError):
        bins_for_recall(10, 1.0)


def _scores(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 3, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("n,k,r", [(1000, 10, 0.95), (37, 5, 0.99), (4096, 1, 0.9)])
def test_partial_reduce_with_plan_equals_reference(kind, mode, n, k, r):
    scores = _scores(kind, (6, n), seed=n + k)
    plan = plan_bins(n, k, r)
    ours = partial_reduce_with_plan(torch.from_numpy(scores), plan, mode=mode)
    ref = ref_partial_reduce(
        jnp.asarray(scores), ref_binning.plan_bins(n, k, r), mode=mode
    )
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert ours[1].dtype == torch.int32


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_exact_rescoring_equals_reference(kind, mode, k):
    vals = _scores(kind, (5, 64), seed=k)
    idxs = np.random.default_rng(k).permutation(5 * 64).reshape(5, 64).astype(np.int32)
    ours = exact_rescoring(torch.from_numpy(vals), torch.from_numpy(idxs), k,
                           mode=mode, use_bitonic=False)
    ref = ref_exact_rescoring(
        jnp.asarray(vals), jnp.asarray(idxs), k, mode=mode, use_bitonic=False
    )
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    with pytest.raises(ValueError):
        exact_rescoring(torch.from_numpy(vals), torch.from_numpy(idxs), 65)
    # the bitonic network, the default of both packages: bit for bit
    ours = exact_rescoring(torch.from_numpy(vals), torch.from_numpy(idxs), k,
                           mode=mode)
    ref = ref_exact_rescoring(jnp.asarray(vals), jnp.asarray(idxs), k, mode=mode)
    assert bits_equal(ours[0], torch.from_numpy(np.array(ref[0])))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("length", [1, 3, 64, 100, 256])
def test_bitonic_sort_pairs_bit_equal(length, descending):
    """The network's order, ties included: values drawn from a few
    integers, +0.0 and -0.0, -inf and NaN; the reference unjitted (a
    jitted network at L=256 compiles for minutes on the CPU)."""
    rng = np.random.default_rng(length)
    vals = rng.integers(-2, 3, size=(6, length)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = -0.0
    vals[rng.random(vals.shape) < 0.1] = -np.inf
    vals[rng.random(vals.shape) < 0.03] = np.nan
    idxs = rng.permutation(6 * length).reshape(6, length).astype(np.int32)
    ours = bitonic_sort_pairs(torch.from_numpy(vals), torch.from_numpy(idxs),
                              descending=descending)
    ref = ref_bitonic(jnp.asarray(vals), jnp.asarray(idxs),
                      descending=descending)
    assert bits_equal(ours[0], torch.from_numpy(np.array(ref[0])))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("fn,ref_fn", [
    (approx_max_k, ref_approx_max_k),
    (approx_min_k, ref_approx_min_k),
])
def test_approx_k_equals_reference(kind, aggregate, fn, ref_fn):
    scores = _scores(kind, (8, 3000), seed=7)
    kw = dict(recall_target=0.9, aggregate_to_topk=aggregate)
    ours = fn(torch.from_numpy(scores), 10, **kw)
    ref = ref_fn(jnp.asarray(scores), 10, **kw)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    # recall accounting against a larger global N changes the layout the
    # same way in both packages
    ours = fn(torch.from_numpy(scores), 10, reduction_input_size_override=12000)
    ref = ref_fn(jnp.asarray(scores), 10, reduction_input_size_override=12000)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
