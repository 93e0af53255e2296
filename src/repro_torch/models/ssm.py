"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Port of ``src/repro/models/ssm.py``.  The full-sequence forward is the
chunked SSD algorithm: intra-chunk attention-like products plus an
inter-chunk recurrence over the (H, P, N) state, O(S) in the sequence
length.  Decode is one recurrent state update a token, written into the
cache in place (the state and the conv window), so a CUDA graph of the
step keeps it.  The state stays f32; the casts sit where the
reference's ``.astype`` calls are.

Under tensor parallelism a rank runs its heads.  ``in_proj`` and the
conv are stored as the spec cuts them, contiguously over ``"conv_dim"``,
which does not follow the heads; the forward gathers the weights over
``"model"`` and takes the rank's columns (the weight route: the
weight's bytes, 54.1 MB a layer at mamba2-2.7b's width in bf16, stay
below the 86.6 MB of ``in_proj``'s output at batch 2 x 2,048, and do not
grow with the batch; ``parallel.tensor_parallel.gather_from_model``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef
from repro_torch.parallel import tensor_parallel as TP

__all__ = ["ssm_dims", "ssm_defs", "ssm_train", "ssm_decode", "SSMCache",
           "ssm_init_cache"]

CONV_W = 4  # short causal conv window


class SSMCache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) recurrent SSM state, f32
    conv: torch.Tensor       # (B, CONV_W - 1, conv_dim) conv tail


def ssm_dims(d_model: int, *, expand: int = 2, head_dim: int = 64, n_state: int = 128):
    d_inner = expand * d_model
    num_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_state  # x, B, C go through the conv
    return d_inner, num_heads, conv_dim


def ssm_defs(d_model: int, *, expand: int = 2, head_dim: int = 64, n_state: int = 128):
    d_inner, num_heads, conv_dim = ssm_dims(
        d_model, expand=expand, head_dim=head_dim, n_state=n_state
    )
    return {
        # order: [z (gate), x, B, C, dt]
        "in_proj": ParamDef(
            (d_model, 2 * d_inner + 2 * n_state + num_heads), ("embed", "conv_dim")
        ),
        "conv_w": ParamDef((CONV_W, conv_dim), (None, "conv_dim")),
        "conv_b": ParamDef((conv_dim,), ("conv_dim",), "zeros"),
        "a_log": ParamDef((num_heads,), ("ssm_heads",), 0.5),
        "d_skip": ParamDef((num_heads,), ("ssm_heads",), "ones"),
        "dt_bias": ParamDef((num_heads,), ("ssm_heads",), "zeros"),
        "norm": ParamDef((d_inner,), ("conv_dim",), "ones"),
        "out_proj": ParamDef((d_inner, d_model), ("conv_dim", "embed")),
    }


def _split_proj(proj, d_inner, n_state, num_heads):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : 2 * d_inner + 2 * n_state]
    dt = proj[..., 2 * d_inner + 2 * n_state :]
    return z, xbc, dt


def _gated_norm(y, z, scale, eps=1e-5, tp=None, width=None):
    """RMS norm of ``y * silu(z)`` over its last dim; under ``tp`` the
    rank's channels of a ``width``-wide whole, their mean of squares
    taken over the group."""
    y = y * F.silu(z)
    if tp is None:
        var = torch.mean(torch.square(y.to(torch.float32)), dim=-1, keepdim=True)
    else:
        var = TP.sum_squares(y, tp) / width
    return (y.to(torch.float32) * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _rank_inputs(params, tp, d_inner, n_state, head_dim):
    """``in_proj``, ``conv_w`` and ``conv_b`` for the rank's heads under
    ``tp``: each leaf gathered whole over ``"model"`` (its contiguous cut
    does not follow the heads), then the rank's ``z``, ``x`` and ``dt``
    columns and the whole ``B`` and ``C`` (one group, read by every
    head) taken, in ``_split_proj``'s order."""
    h0, hn = tp.ssm_head_start, tp.ssm_heads
    c0, cn = h0 * head_dim, hn * head_dim
    bc = slice(2 * d_inner, 2 * d_inner + 2 * n_state)
    w = TP.gather_from_model(params["in_proj"], 1, tp)
    dt0 = 2 * d_inner + 2 * n_state + h0
    w_in = torch.cat([w[:, c0:c0 + cn], w[:, d_inner + c0:d_inner + c0 + cn],
                      w[:, bc], w[:, dt0:dt0 + hn]], dim=1)
    conv = [TP.gather_from_model(params[k], -1, tp) for k in ("conv_w", "conv_b")]
    conv_w, conv_b = (torch.cat([t[..., c0:c0 + cn], t[..., d_inner:]], dim=-1)
                      for t in conv)
    return w_in, conv_w, conv_b


def ssm_train(
    params: Dict,
    u: torch.Tensor,         # (B, S, d_model)
    *,
    expand: int = 2,
    head_dim: int = 64,
    n_state: int = 128,
    chunk: int = 256,
    return_cache: bool = False,
    tp=None,
):
    """The SSD block over a full sequence.  Under ``tp`` (the layer's
    tensor-parallel shard) it runs the rank's ``tp.ssm_heads`` heads
    (:func:`_rank_inputs`) and returns its part of ``out_proj``'s
    output, which the caller sums over ``"model"``."""
    b, s, d_model = u.shape
    d_inner, nh, conv_dim = ssm_dims(
        d_model, expand=expand, head_dim=head_dim, n_state=n_state
    )
    p = head_dim
    width = d_inner
    if tp is None:
        w_in, conv_w, conv_b = params["in_proj"], params["conv_w"], params["conv_b"]
    else:
        w_in, conv_w, conv_b = _rank_inputs(params, tp, d_inner, n_state, p)
        d_inner, nh = tp.ssm_heads * p, tp.ssm_heads
    proj = u @ w_in
    z, xbc, dt = _split_proj(proj, d_inner, n_state, nh)
    # Short causal conv over (x, B, C).
    xbc_pad = F.pad(xbc, (0, 0, CONV_W - 1, 0))
    conv = sum(
        xbc_pad[:, i : i + s] * conv_w[i] for i in range(CONV_W)
    ) + conv_b
    conv = F.silu(conv)
    x = conv[..., :d_inner].reshape(b, s, nh, p)
    B = conv[..., d_inner : d_inner + n_state]             # (B, S, N), 1 group
    C = conv[..., d_inner + n_state :]
    dt = F.softplus(dt + params["dt_bias"])                # (B, S, H)
    a = -torch.exp(params["a_log"].to(torch.float32))      # (H,) negative
    da = dt.to(torch.float32) * a                          # (B, S, H) log-decay

    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, nh, p)
    Br = B.reshape(b, nc, chunk, n_state)
    Cr = C.reshape(b, nc, chunk, n_state)
    dar = da.reshape(b, nc, chunk, nh)
    dtr = dt.reshape(b, nc, chunk, nh)

    # Intra-chunk cumulative decays.
    cum = torch.cumsum(dar, dim=2)                         # (B, nc, c, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B, nc, c, c, H) log decay i<-j
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=u.device))
    # masked before the exp (the same values as the reference's
    # where(causal, exp(seg), 0)): over a long chunk the anti-causal
    # entries' exp overflows, and where's backward turns 0 * inf into NaN
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], -torch.inf))

    # Diagonal (intra-chunk) term: Y_intra = (C Bᵀ ⊙ decay ⊙ dt) X
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)            # (B, nc, c, c)
    w = cb[..., None] * decay * dtr[:, :, None, :, :]       # (B, nc, c, c, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(x.dtype), xr)

    # Chunk-final states: S_n = sum_j exp(cum_end - cum_j) dt_j B_j x_jᵀ
    end_decay = torch.exp(cum[:, :, -1:, :] - cum)         # (B, nc, c, H)
    contrib = torch.einsum(
        "bcjh,bcjn,bcjhp->bchpn",
        (end_decay * dtr).to(x.dtype), Br, xr,
    )                                                      # (B, nc, H, P, N)

    # Inter-chunk recurrence over chunk states (the state *before* each
    # chunk is what the chunk reads).
    chunk_decay = torch.exp(torch.sum(dar, dim=2))         # (B, nc, H)
    state = torch.zeros((b, nh, p, n_state), dtype=torch.float32, device=u.device)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = (state * chunk_decay[:, n, :, None, None]
                 + contrib[:, n].to(torch.float32))
    prev_states = torch.stack(prev, dim=1)                 # (B, nc, H, P, N)

    # Inter-chunk term: Y_inter[i] = C_i · (decay_to_i * prev_state)
    in_decay = torch.exp(cum)                              # decay from chunk start
    y_inter = torch.einsum(
        "bcin,bchpn,bcih->bcihp",
        Cr, prev_states.to(x.dtype), in_decay.to(x.dtype),
    )

    y = (y_intra + y_inter).reshape(b, s, nh, p)
    y = y + x * params["d_skip"][None, None, :, None].to(x.dtype)
    y = _gated_norm(y.reshape(b, s, d_inner), z, params["norm"], tp=tp,
                    width=width)
    out = y @ params["out_proj"]
    if return_cache:
        return out, SSMCache(state=state, conv=xbc[:, -(CONV_W - 1):])
    return out


def ssm_init_cache(batch: int, d_model: int, *, expand=2, head_dim=64, n_state=128,
                   dtype=torch.float32, device=None) -> SSMCache:
    d_inner, nh, conv_dim = ssm_dims(d_model, expand=expand, head_dim=head_dim,
                                     n_state=n_state)
    return SSMCache(
        state=torch.zeros((batch, nh, head_dim, n_state), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, CONV_W - 1, conv_dim), dtype=dtype, device=device),
    )


def ssm_decode(
    params: Dict,
    u: torch.Tensor,         # (B, 1, d_model)
    cache: SSMCache,
    *,
    expand: int = 2,
    head_dim: int = 64,
    n_state: int = 128,
) -> Tuple[torch.Tensor, SSMCache]:
    """One token; writes the new state and conv window into ``cache`` in
    place and returns it."""
    b, _, d_model = u.shape
    d_inner, nh, conv_dim = ssm_dims(
        d_model, expand=expand, head_dim=head_dim, n_state=n_state
    )
    p = head_dim
    proj = (u @ params["in_proj"])[:, 0]
    z, xbc, dt = _split_proj(proj, d_inner, n_state, nh)
    window = torch.cat([cache.conv, xbc[:, None]], dim=1)
    conv = torch.einsum("bwk,wk->bk", window, params["conv_w"]) + params["conv_b"]
    conv = F.silu(conv)
    x = conv[:, :d_inner].reshape(b, nh, p)
    B = conv[:, d_inner : d_inner + n_state]
    C = conv[:, d_inner + n_state :]
    dt = F.softplus(dt + params["dt_bias"])                # (B, H)
    a = -torch.exp(params["a_log"].to(torch.float32))
    decay = torch.exp(dt.to(torch.float32) * a)            # (B, H)
    new_state = (
        cache.state * decay[..., None, None]
        + torch.einsum("bh,bn,bhp->bhpn", dt, B, x).to(torch.float32)
    )
    y = torch.einsum("bn,bhpn->bhp", C, new_state.to(x.dtype))
    y = y + x * params["d_skip"][None, :, None].to(x.dtype)
    y = _gated_norm(y.reshape(b, d_inner), z, params["norm"])
    out = (y @ params["out_proj"])[:, None]
    cache.state.copy_(new_state)
    cache.conv.copy_(window[:, 1:])
    return out, cache
