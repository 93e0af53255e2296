"""Quantized storage tiers: bf16/int8/int4 stored rows with exact rescoring.

Port of ``src/repro/search/quant.py``.  A tier sets the bytes each stored
database element costs, and so where the scan's roofline knee lands
(Eq. 10):

  * ``"f32"``  — 4 bytes/element, the exact path (the default).
  * ``"bf16"`` — 2 bytes/element; the scan widens the rows to f32.
  * ``"int8"`` — 1 byte/element with a per-row symmetric scale
    (``row ≈ scale * int8``).
  * ``"int4"`` — 0.5 bytes/element with a per-row symmetric scale
    (codes in [-7, 7]).  The canonical form above the kernels is one int8
    code per element; the ``"cuda"`` layout packs two codes per byte
    (:func:`pack_int4_rows`) and the scan kernel unpacks the nibbles in
    shared memory, so only the packed bytes cross HBM.

A quantized tier searches in two passes: the scan over the stored rows
keeps an over-fetched candidate set (bins planned for :func:`scan_k`),
then ``stages.rescore_candidates`` re-scores those candidates exactly
against the full-precision rescore tail.  The over-fetch derivation is
the reference's module docstring: a true top-K entry can lose its bin to
a rival that quantization promotes past it, so the bins are planned for
``K' = K + T`` with the confusion budgets

    T(bf16) = ceil(K/2)        T(int8) = K        T(int4) = 2K.

Codes and scales equal the reference's bit for bit: both frameworks
divide exactly and round half to even.  Nothing here imports the rest of
``repro_torch.search``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = [
    "STORAGE_TIERS",
    "QuantizedRows",
    "check_metric_storage",
    "dequantize_rows",
    "is_quantized",
    "pack_int4_rows",
    "quantize_rows",
    "scan_k",
    "storage_bytes",
    "storage_dtype",
    "unpack_int4_rows",
    "validate_restored",
]

# The legal ``SearchSpec.storage`` values, in decreasing bytes/element.
STORAGE_TIERS: Tuple[str, ...] = ("f32", "bf16", "int8", "int4")

_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}
# Stored container dtype per tier (int4 codes live in int8: one code per
# byte in the canonical form, two per byte in the "cuda" layout).
_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "int4": torch.int8,
}

# Smallest per-row scale: an all-zero row quantizes to zeros.
_SCALE_FLOOR = 1e-30

_INT8_MAX = 127.0
_INT4_MAX = 7.0

# Tiers that carry a per-row scale beside the stored rows.
_SCALED_TIERS = ("int8", "int4")


def is_quantized(storage: str) -> bool:
    """True for tiers that store fewer than 4 bytes per element."""
    return storage_bytes(storage) < 4


def storage_bytes(storage: str) -> float:
    """Bytes per stored database element for a tier.

    >>> [storage_bytes(s) for s in STORAGE_TIERS]
    [4, 2, 1, 0.5]
    """
    try:
        return _BYTES[storage]
    except KeyError:
        raise ValueError(
            f"unknown storage tier {storage!r}; expected one of "
            f"{STORAGE_TIERS}"
        ) from None


def storage_dtype(storage: str) -> torch.dtype:
    """The torch dtype rows of a tier are stored in."""
    storage_bytes(storage)  # validate
    return _DTYPES[storage]


def quantize_rows(
    rows: torch.Tensor, storage: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize metric-prepared rows into a tier's stored form.

    Returns ``(stored, scale)``: ``scale`` is the per-row symmetric scale
    of the scaled tiers (``rows ≈ stored * scale[:, None]``), else None.
    Per-row math only, so ``Index.add`` quantizes just the appended
    slice.  int4 returns the canonical unpacked codes (one int8 per
    element, in [-7, 7]).

    >>> q, s = quantize_rows(torch.ones((2, 3)), "int8")
    >>> (q.dtype, tuple(s.shape))
    (torch.int8, (2,))
    >>> q4, _ = quantize_rows(torch.ones((2, 3)), "int4")
    >>> int(q4.max())
    7
    """
    rows = rows.to(torch.float32)
    if storage == "f32":
        return rows, None
    if storage == "bf16":
        return rows.to(torch.bfloat16), None
    if storage in _SCALED_TIERS:
        qmax = _INT8_MAX if storage == "int8" else _INT4_MAX
        amax = rows.abs().amax(dim=-1)
        # A tensor divisor: on CUDA PyTorch multiplies by the reciprocal of
        # a Python-number divisor, an ulp off the quotient in some rows.
        scale = torch.clamp(amax / torch.full_like(amax, qmax), min=_SCALE_FLOOR)
        q = torch.clamp(torch.round(rows / scale[:, None]), -qmax, qmax)
        return q.to(torch.int8), scale
    raise ValueError(
        f"unknown storage tier {storage!r}; expected one of {STORAGE_TIERS}"
    )


def dequantize_rows(
    stored: torch.Tensor, scale: Optional[torch.Tensor]
) -> torch.Tensor:
    """f32 view of stored rows: the values the quantized scan ranks by."""
    rows = stored.to(torch.float32)
    if scale is not None:
        rows = rows * scale[:, None]
    return rows


def pack_int4_rows(codes: torch.Tensor) -> torch.Tensor:
    """Pack canonical int4 codes (one int8 per element) two per byte.

    Column ``2j`` lands in byte ``j``'s low nibble, column ``2j+1`` in its
    high nibble; an odd trailing column is padded with a zero code.

    >>> codes = torch.tensor([[-7, 3, 5, -1]], dtype=torch.int8)
    >>> packed = pack_int4_rows(codes)
    >>> tuple(packed.shape), bool((unpack_int4_rows(packed) == codes).all())
    ((1, 2), True)
    """
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    lo = codes[..., 0::2].to(torch.int32)
    hi = codes[..., 1::2].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: bytes back to int8 codes, twice
    as wide (callers slice off an odd ``d``'s pad column)."""
    b = packed.to(torch.int32)
    lo = (b << 28) >> 28  # arithmetic shifts sign-extend the low nibble
    hi = b >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], -1
    ).to(torch.int8)


def scan_k(storage: str, k: int, *, n: Optional[int] = None) -> int:
    """Neighbour count the quantized scan plans its bins for, ``K + T``,
    clamped to ``n`` when given.

    >>> [scan_k(s, 10) for s in STORAGE_TIERS]
    [10, 15, 20, 30]
    """
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if storage == "bf16":
        k = k + math.ceil(k / 2)
    elif storage == "int8":
        k = 2 * k
    elif storage == "int4":
        k = 3 * k
    else:
        storage_bytes(storage)  # validate the tier name
    if n is not None:
        k = min(k, n)
    return k


def check_metric_storage(metric, storage: str) -> None:
    """Reject a metric × storage combination the metric does not declare
    in ``Metric.storage_tiers`` (duck-typed: this module imports no
    metric)."""
    storage_bytes(storage)  # validate the tier name first
    tiers = getattr(metric, "storage_tiers", STORAGE_TIERS)
    if storage not in tiers:
        raise ValueError(
            f"metric {metric.name!r} does not support storage="
            f"{storage!r} (supported tiers: {tuple(tiers)}).  Either pick "
            "a supported tier, or register the metric with a "
            "quantization-compatible preparation (normalized/bounded rows) "
            "and declare it via Metric(storage_tiers=...)."
        )


def validate_restored(storage: str, db_dtype: torch.dtype,
                      has_scale: bool) -> None:
    """Check that restored stored rows agree with the tier a snapshot
    names: the dtype, and a scale table exactly for the scaled tiers.

    >>> validate_restored("int8", torch.int8, has_scale=True)
    >>> validate_restored("f32", torch.float32, has_scale=False)
    """
    expected = storage_dtype(storage)
    if is_quantized(storage) and db_dtype != expected:
        raise ValueError(
            f"snapshot claims storage={storage!r} but the stored rows are "
            f"{db_dtype} (expected {expected}) — corrupt or version-skewed "
            "snapshot; rebuild the index"
        )
    if (storage in _SCALED_TIERS) != has_scale:
        raise ValueError(
            f"snapshot storage={storage!r} "
            + ("is missing its per-row scale table"
               if storage in _SCALED_TIERS
               else "carries an unexpected scale table")
            + " — corrupt or version-skewed snapshot; rebuild the index"
        )


@dataclasses.dataclass
class QuantizedRows:
    """One metric-prepared, tier-quantized row slice (build or ``add``).

    Attributes:
      rows: stored-dtype rows (canonical unpacked codes for int4).
      scale: per-row f32 scale (int8/int4) or None.
      bias: metric bias of the stored (dequantized) values, or None.
      exact_rows: full-precision metric-prepared rows, the rescore tail.
      exact_bias: metric bias of ``exact_rows``, or None.
    """

    rows: torch.Tensor
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    exact_rows: torch.Tensor
    exact_bias: Optional[torch.Tensor]
