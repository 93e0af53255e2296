"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``src/repro/models/rglru.py``.  Block = (linear -> short conv ->
RG-LRU) ⊙ (linear -> GeLU), then out-proj.  The diagonal recurrence
h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙ x_t) runs over a full
sequence as a log-depth associative scan (``_associative_scan``: the
odd/even recursion of ``jax.lax.associative_scan``, written in torch
ops, since PyTorch has no stable associative-scan API) or chunked
(``scan_impl="linear"``), and one step a token in decode, written into
the cache in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef
from repro_torch.parallel import tensor_parallel as TP

__all__ = ["rglru_defs", "rglru_train", "rglru_decode", "RGLRUCache",
           "rglru_init_cache"]

CONV_W = 4
_C = 8.0  # the paper's fixed recurrence temperature


class RGLRUCache(NamedTuple):
    state: torch.Tensor  # (B, lru_width) recurrent state, f32
    conv: torch.Tensor   # (B, CONV_W - 1, lru_width)


def rglru_defs(d_model: int, lru_width: int, *, gate_blocks: int = 0):
    """RG-LRU parameters.  ``gate_blocks > 0`` makes the input and
    recurrence gates block-diagonal, (blocks, lru/blocks, lru/blocks) (the
    Griffin design); 0 keeps dense gates."""
    defs = {
        "wx": ParamDef((d_model, lru_width), ("embed", "lru_width")),
        "wy": ParamDef((d_model, lru_width), ("embed", "lru_width")),
        "conv_w": ParamDef((CONV_W, lru_width), (None, "lru_width")),
        "conv_b": ParamDef((lru_width,), ("lru_width",), "zeros"),
        "b_input_gate": ParamDef((lru_width,), ("lru_width",), "zeros"),
        "b_rec_gate": ParamDef((lru_width,), ("lru_width",), "zeros"),
        # Lambda init so a = sigmoid(L)^(c*r) starts near 0.9..0.999.
        "lam": ParamDef((lru_width,), ("lru_width",), 0.8),
        "wo": ParamDef((lru_width, d_model), ("lru_width", "embed")),
    }
    if gate_blocks:
        blk = lru_width // gate_blocks
        defs["w_input_gate"] = ParamDef((gate_blocks, blk, blk), ("lru_width", None, None))
        defs["w_rec_gate"] = ParamDef((gate_blocks, blk, blk), ("lru_width", None, None))
    else:
        defs["w_input_gate"] = ParamDef((lru_width, lru_width), ("lru_width", None))
        defs["w_rec_gate"] = ParamDef((lru_width, lru_width), ("lru_width", None))
    return defs


def _gate_matmul(x, w, tp=None):
    """``x`` through a gate.  Under ``tp`` ``x`` holds the rank's
    channels: a block-diagonal gate's blocks are the rank's (no
    collective); a dense gate's rows are, so ``x @ w`` is a partial sum
    of every output channel, reduce-scattered to the rank's."""
    if w.ndim == 3:  # block-diagonal (blocks, blk, blk)
        blocks, blk, _ = w.shape
        xb = x.reshape(x.shape[:-1] + (blocks, blk))
        return torch.einsum("...hk,hkl->...hl", xb, w).reshape(x.shape)
    if tp is not None:
        return TP.reduce_scatter_to_model(x @ w, tp)
    return x @ w


def _gates(params, x, tp=None):
    r = torch.sigmoid(_gate_matmul(x, params["w_rec_gate"], tp)
                      + params["b_rec_gate"])
    i = torch.sigmoid(_gate_matmul(x, params["w_input_gate"], tp)
                      + params["b_input_gate"])
    log_a = -_C * r * F.softplus(params["lam"])   # log a_t  (<= 0)
    a = torch.exp(log_a)
    gated_x = i * x
    # sqrt(1 - a^2) input normaliser.
    floor = torch.full((), 1e-6, dtype=log_a.dtype, device=log_a.device)
    beta = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a), floor))
    return a.to(torch.float32), (beta * gated_x).to(torch.float32)


def _conv(params, x, s):
    x_pad = F.pad(x, (0, 0, CONV_W - 1, 0))
    return sum(
        x_pad[:, i : i + s] * params["conv_w"][i] for i in range(CONV_W)
    ) + params["conv_b"]


def _combine(a_l, b_l, a_r, b_r):
    return a_l * a_r, a_r * b_l + b_r


def _interleave(even, odd):
    """Interleave along dim 1: even[0], odd[0], even[1], ... (even holds
    as many elements as odd, or one more)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1) if even.shape[1] > n else both


def _associative_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0):
    (prefix products of a, h).  The odd/even recursion of
    ``jax.lax.associative_scan``: log depth, O(S) work."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_train(params: Dict, u: torch.Tensor, *, return_cache: bool = False,
                scan_impl: str = "associative", scan_chunk: int = 256, tp=None):
    """RG-LRU over a full sequence.  ``scan_impl="associative"`` scans the
    whole sequence at once; ``"linear"`` (used for S > ``scan_chunk``, a
    multiple of it) scans each chunk and carries the state across
    chunks, so the scan's intermediates are O(B, chunk, lru).  Under
    ``tp`` (the layer's tensor-parallel shard) every leaf holds the
    rank's channels (``wx``/``wy`` column-parallel, ``wo`` row-parallel):
    the conv, the gates, the scan and the GeLU gate run on them, and the
    output is the rank's part of ``wo``'s, which the caller sums over
    ``"model"``."""
    b, s, d = u.shape
    x_raw = u @ params["wx"]
    x = _conv(params, x_raw, s)
    a, bx = _gates(params, x, tp)

    if scan_impl == "linear" and s > scan_chunk and s % scan_chunk == 0:
        h0 = torch.zeros((b, a.shape[-1]), dtype=torch.float32, device=u.device)
        hs = []
        for c in range(0, s, scan_chunk):
            pa, pb = _associative_scan(a[:, c : c + scan_chunk], bx[:, c : c + scan_chunk])
            h_c = pb + pa * h0[:, None, :]
            h0 = h_c[:, -1]
            hs.append(h_c)
        h = torch.cat(hs, dim=1)
    else:
        _, h = _associative_scan(a, bx)
    gate = F.gelu(u @ params["wy"], approximate="tanh")
    out = (h.to(u.dtype) * gate) @ params["wo"]
    if return_cache:
        return out, RGLRUCache(state=h[:, -1], conv=x_raw[:, -(CONV_W - 1):])
    return out


def rglru_init_cache(batch: int, lru_width: int, dtype=torch.float32,
                     device=None) -> RGLRUCache:
    return RGLRUCache(
        state=torch.zeros((batch, lru_width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_W - 1, lru_width), dtype=dtype, device=device),
    )


def rglru_decode(
    params: Dict, u: torch.Tensor, cache: RGLRUCache
) -> Tuple[torch.Tensor, RGLRUCache]:
    """One token; writes the new state and conv window into ``cache`` in
    place and returns it."""
    x = (u @ params["wx"])[:, 0]
    window = torch.cat([cache.conv, x[:, None]], dim=1)
    x = torch.einsum("bwk,wk->bk", window, params["conv_w"]) + params["conv_b"]
    a, bx = _gates(params, x)
    h = a * cache.state + bx
    gate = F.gelu((u @ params["wy"])[:, 0], approximate="tanh")
    y = ((h.to(u.dtype) * gate) @ params["wo"])[:, None]
    cache.state.copy_(h)
    cache.conv.copy_(window[:, 1:])
    return y, cache
