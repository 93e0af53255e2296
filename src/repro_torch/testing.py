"""Tie-tolerant comparison of top-k results, shared by the tests and
``chip_smoke.py``.

Two implementations of the same search may order near-equal scores
differently: their f32 sums run in another order (CPU BLAS, XLA, FFMA on
the card), so a near tie inside one bin, or between two results, can
flip.  The rule:

  * values must be ``allclose`` with the stated tolerance;
  * indices must be equal, except at a position where they may
    legitimately differ: the reference's own values tie there within the
    tolerance (a tie group, compared as a set; a group that reaches the
    last position may be cut anywhere), or — when ``score`` is given —
    the returned index really scores the returned value, which is a near
    tie inside a bin that the reference's output does not show.

The default tolerance, ``rtol=1e-5, atol=1e-4``, is for unit-normal data
at D <= 128 in f32: a dot product of 128 such terms carries a rounding
error of a few 1e-6 relative to its magnitude (~1e1), and the two sides
round independently.

It also makes the carry merge's hardest inputs (:func:`tied_carries`)
and compares its results bit for bit (:func:`bits_equal`).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "ATOL", "KERNEL_CASES", "RTOL", "assert_bin_winners_close",
    "assert_topk_close", "bias_scorer", "bits_equal", "packed_operands",
    "public_scorer", "stored_operands", "tied_carries",
]

RTOL = 1e-5
ATOL = 1e-4

_MASK = float(np.finfo(np.float32).min)

# Small kernel shapes (m, n, d, bin_size, k_scan, dead share, dead row
# range, l2 bias): bin_size 1 (the exact layout) up to bins wider than one
# CUDA column tile, M not a multiple of 8, D=100 padded to 128, 90%
# tombstones, a fully masked range, and k_scan above the live bin count.
KERNEL_CASES = {
    "bin1": dict(m=13, n=100, d=24, bin_size=1, k_scan=10),
    "bin16_d100": dict(m=13, n=1000, d=100, bin_size=16, k_scan=10),
    "tomb90_l2": dict(m=21, n=1000, d=64, bin_size=16, k_scan=10, dead=0.9,
                      l2=True),
    "masked_tile": dict(m=8, n=1024, d=32, bin_size=8, k_scan=10,
                        dead_rows=(256, 768)),
    "kscan_gt_bins": dict(m=5, n=512, d=16, bin_size=64, k_scan=12, dead=0.5),
    "bin256": dict(m=5, n=2000, d=128, bin_size=256, k_scan=6),
    "m1": dict(m=1, n=3000, d=100, bin_size=32, k_scan=10, l2=True),
}


def packed_operands(m: int, n: int, d: int, *, bin_size: int, dead: float = 0.0,
                    dead_rows=None, l2: bool = False, seed: int = 0,
                    device="cpu", **_):
    """(queries (m, d), packed db (n_pad, d_pad), bias (1, n_pad)) in the
    port's layout, from unit-normal numpy data: ``dead`` is the share of
    rows tombstoned at random, ``dead_rows`` a (start, stop) range
    tombstoned whole, ``l2`` adds the -||x||^2/2 metric bias.  Other keys
    of a ``KERNEL_CASES`` entry (``k_scan``) are ignored."""
    block_n = max(bin_size, 128)
    n_pad = -(-max(n, block_n) // block_n) * block_n
    d_pad = -(-d // 128) * 128
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, d), dtype=np.float32)
    rows = rng.standard_normal((n, d), dtype=np.float32)
    live = rng.random(n) >= dead
    if dead_rows is not None:
        live[dead_rows[0]:dead_rows[1]] = False
    body = -0.5 * np.einsum("ij,ij->i", rows, rows) if l2 else np.zeros(n, np.float32)
    bias = np.full((1, n_pad), _MASK, np.float32)
    bias[0, :n] = np.where(live, body, _MASK)
    db = np.zeros((n_pad, d_pad), np.float32)
    db[:n, :d] = rows
    return tuple(torch.from_numpy(a).to(device) for a in (q, db, bias))


def tied_carries(splits: int, m: int, k_scan: int, *, seed: int = 0,
                 device="cpu"):
    """(splits, m, k_scan) carries as the fused scan leaves them, dense in
    ties: each carry sorted descending (stable), its values integers in
    [-3, 3] with zeros of both signs (``torch.sort`` ranks them equal),
    half of the carries cut after a random number of live entries and
    filled with (MASK_VALUE, -1), random int32 indices elsewhere.

    >>> v, i = tied_carries(3, 2, 8)
    >>> bool((v[..., :-1] >= v[..., 1:]).all()), bool(((i == -1) == (v == v.min())).all())
    (True, True)
    """
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (splits, m, k_scan)

    def draw(lo, hi, size=shape):
        return torch.randint(lo, hi, size, generator=g, device=device)

    vals = torch.sort(draw(-3, 4).float(), dim=-1, descending=True,
                      stable=True).values
    vals = torch.where((vals == 0) & draw(0, 2).bool(),
                       torch.full_like(vals, -0.0), vals)
    live = torch.where(draw(0, 2, (splits, m, 1)).bool(),
                       draw(0, k_scan + 1, (splits, m, 1)), k_scan)
    masked = torch.arange(k_scan, device=device) >= live
    vals = torch.where(masked, torch.full_like(vals, _MASK), vals)
    idxs = torch.where(masked, -1, draw(0, 2**31 - 1).int())
    return vals, idxs.to(torch.int32)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and dtype, and the same bits (``torch.equal`` takes -0.0
    for +0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def stored_operands(db: torch.Tensor, form: str):
    """The packed f32 rows of :func:`packed_operands` in a stored form
    (``kernels.partial_reduce.FORMS``), quantized by
    ``repro_torch.search.quant`` as the packed layout stores them.

    Returns ``(stored, scale, int4_packed, widened)``: the kernel operands
    (``scale`` (1, n_pad) or None; int4 codes packed two per byte, d_pad
    / 2 bytes a row) and the stored values widened back to f32 rows
    (n_pad, d_pad), scale applied, for :func:`bias_scorer`."""
    from repro_torch.search import quant

    if form == "f32":
        return db, None, False, db
    stored, scale = quant.quantize_rows(db, form)
    widened = quant.dequantize_rows(stored, scale)
    if form == "int4":
        stored = quant.pack_int4_rows(stored)
    if scale is not None:
        scale = scale[None, :].contiguous()
    return stored, scale, form == "int4", widened


def bias_scorer(q: torch.Tensor, db: torch.Tensor, bias: torch.Tensor):
    """``score(row, indices)``: biased float64 scores of packed rows for
    one query row (the internal max convention of the kernels)."""
    def score(row, idx):
        sel = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=db.device)
        x = db[sel].double().cpu()
        qr = F.pad(q[row], (0, db.shape[1] - q.shape[1])).double().cpu()
        return (x @ qr + bias[0, sel].double().cpu()).numpy()
    return score


def public_scorer(metric: str, queries, rows, dtype: Optional[str] = None):
    """``score(row, indices)``: float64 public values (the metric's value
    contract) of raw database ``rows`` for one of the raw ``queries``
    (numpy arrays or tensors, on any device).  ``dtype="bfloat16"``
    scores what an index of that compute dtype scores: rows and queries
    cast to bf16 and prepared by the port's metric (its bf16 norms and
    bias), then the products and sums in float64."""
    queries, rows = torch.as_tensor(queries), torch.as_tensor(rows)
    if dtype is not None:
        from repro_torch.search.metrics import get_metric

        m_obj = get_metric(metric)
        prepped, bias = m_obj.prepare_database(rows.to(getattr(torch, dtype)))
        qp = m_obj.prepare_queries(queries.to(getattr(torch, dtype))).double()
        prepped = prepped.double()
        bias = None if bias is None else bias.double()
        sign = -1.0 if m_obj.negate_output else 1.0

        def score_dtype(row, idx):
            sel = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                  device=prepped.device)
            out = prepped[sel] @ qp[row]
            if bias is not None:
                out = out + bias[sel]
            return (sign * out).cpu().numpy()
        return score_dtype

    def score(row, idx):
        sel = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=rows.device)
        x, qr = rows[sel].double(), queries[row].double()
        if metric == "cosine":
            x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
            qr = qr / qr.norm().clamp_min(1e-12)
        dots = x @ qr
        out = 0.5 * (x * x).sum(dim=1) - dots if metric == "l2" else dots
        return out.cpu().numpy()
    return score


def _close(a, b, rtol, atol) -> np.ndarray:
    return np.abs(a - b) <= atol + rtol * np.abs(b)


def _topk_mismatches(
    ref_vals,
    ref_idx,
    vals,
    idx,
    *,
    rtol: float = RTOL,
    atol: float = ATOL,
    score: Optional[Callable[[int, np.ndarray], np.ndarray]] = None,
) -> list:
    """(row, position, why) for every entry the rule rejects.

    ``score(row, indices)`` returns the values the compared search should
    report for those indices of that query row (same value convention).
    """
    ref_vals, vals = np.asarray(ref_vals, np.float64), np.asarray(vals, np.float64)
    ref_idx, idx = np.asarray(ref_idx), np.asarray(idx)
    if ref_vals.shape != vals.shape or ref_idx.shape != idx.shape:
        return [(-1, -1, f"shape {vals.shape}/{idx.shape} != "
                 f"{ref_vals.shape}/{ref_idx.shape}")]
    bad = []
    close = _close(vals, ref_vals, rtol, atol)
    for r, c in zip(*np.nonzero(~close)):
        bad.append((int(r), int(c), f"value {vals[r, c]} vs {ref_vals[r, c]}"))
    k = ref_vals.shape[1]
    for r in np.nonzero((ref_idx != idx).any(axis=1))[0]:
        rv = ref_vals[r]
        # tie groups: runs of positions whose neighbouring values are close
        tie = _close(rv[1:], rv[:-1], rtol, atol)
        start = 0
        for p in range(1, k + 1):
            if p < k and tie[p - 1]:
                continue
            group = slice(start, p)
            start = p
            if (ref_idx[r, group] == idx[r, group]).all():
                continue
            same_set = sorted(ref_idx[r, group]) == sorted(idx[r, group])
            if p - group.start > 1 and (same_set or p == k):
                continue
            for c in range(group.start, p):
                if ref_idx[r, c] == idx[r, c]:
                    continue
                if score is not None and idx[r, c] >= 0 and _close(
                    score(int(r), idx[r, c : c + 1])[0], vals[r, c], rtol, atol
                ):
                    continue
                bad.append((int(r), c, f"index {idx[r, c]} vs {ref_idx[r, c]}"))
    return bad


def assert_bin_winners_close(ref_vals, ref_idx, vals, idx, *, bin_size: int,
                             score, rtol: float = RTOL, atol: float = ATOL):
    """Bin winners (m, L) of two implementations: values ``allclose``;
    an index may differ only within its bin, and only to a row that
    really scores the reported value (a near tie inside the bin).
    ``score(row, indices)`` gives the biased scores of those rows."""
    ref_vals, vals = np.asarray(ref_vals, np.float64), np.asarray(vals, np.float64)
    ref_idx, idx = np.asarray(ref_idx), np.asarray(idx)
    if ref_vals.shape != vals.shape or ref_idx.shape != idx.shape:
        raise AssertionError(f"shape {vals.shape} != {ref_vals.shape}")
    np.testing.assert_allclose(vals, ref_vals, rtol=rtol, atol=atol)
    for r, c in zip(*np.nonzero(ref_idx != idx)):
        got = score(int(r), idx[r, c : c + 1])[0]
        if idx[r, c] // bin_size != ref_idx[r, c] // bin_size or not _close(
            got, vals[r, c], rtol, atol
        ):
            raise AssertionError(
                f"row {r} bin {c}: index {idx[r, c]} (scores {got}) vs "
                f"{ref_idx[r, c]}, value {vals[r, c]}"
            )


def assert_topk_close(ref_vals, ref_idx, vals, idx, *, rtol: float = RTOL,
                      atol: float = ATOL, score=None, live_unique: bool = True):
    """Raise ``AssertionError`` listing the first mismatches under the rule
    above; with ``live_unique``, also require every row's non-negative
    indices to be distinct."""
    bad = _topk_mismatches(ref_vals, ref_idx, vals, idx, rtol=rtol, atol=atol,
                          score=score)
    if live_unique:
        for r, row in enumerate(np.asarray(idx)):
            live = row[row >= 0]
            if len(set(live.tolist())) != len(live):
                bad.append((r, -1, f"duplicate indices {row.tolist()}"))
    if bad:
        raise AssertionError(
            f"{len(bad)} top-k mismatches (rtol={rtol}, atol={atol}); first: "
            + "; ".join(f"row {r} pos {c}: {why}" for r, c, why in bad[:5])
        )
