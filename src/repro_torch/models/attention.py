"""Attention: GQA/MQA/MHA (full-sequence and decode), MLA (deepseek-v2),
cross-attention (whisper's decoder) and the paper-integrated kNN top-k
decode attention.

Port of ``src/repro/models/attention.py`` (one device: no sharding
hints).  Prefill runs a query-chunked exact attention so the (S, S)
score matrix never materialises.
``knn_decode_attention`` treats the KV cache as the paper's database:
scores are one matmul, PartialReduce selects the top-k keys (Eq. 13
recall guarantee; ``repro_torch.core.approx_max_k``), and exact softmax
runs over the k survivors.

Decode updates its cache in place (the ``KVCache`` rows, the
``MLACache`` latent rows) and returns it.  MLA's decode attends in the
compressed latent space (the absorbed matmuls); its kNN branch gathers
each (batch, head)'s selected latent rows from the (B, S, r) cache
where the reference widens the cache to (B, H, S, r) first (the same
values).  The score tiles' dtype is ``cfg.attn_scores_dtype`` (the
reference sets it as module state).  ``knn_decode_attention`` takes
the context-parallel path (:func:`_knn_decode_attention_cp`, paper §7)
where the active mesh's rules map ``"cp_seq"`` to axes present on it
(``repro_torch.parallel.sharding``), as the reference's does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.rescoring import stable_topk
from repro_torch.core.topk import approx_max_k
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamDef
from repro_torch.models.rope import apply_mrope, apply_rope
from repro_torch.parallel.sharding import current_mesh, logical_to_spec

__all__ = [
    "attn_defs",
    "mla_defs",
    "cross_attn_defs",
    "attention_train",
    "attention_decode",
    "mla_train",
    "mla_decode",
    "cross_attention",
    "encode_cross_kv",
    "knn_decode_attention",
    "KVCache",
    "MLACache",
]

_NEG_INF = -1e30  # finite mask value: avoids NaN from (-inf) - (-inf)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S, KV, hd)
    v: torch.Tensor      # (B, S, KV, hd)


class MLACache(NamedTuple):
    c_kv: torch.Tensor   # (B, S, kv_lora)
    k_rope: torch.Tensor  # (B, S, qk_rope)


def attn_defs(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int):
    return {
        "wq": ParamDef((d_model, num_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d_model, num_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((num_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }


def mla_defs(
    d_model: int,
    num_heads: int,
    *,
    q_lora_rank: int,
    kv_lora_rank: int,
    qk_nope_dim: int = 128,
    qk_rope_dim: int = 64,
    v_head_dim: int = 128,
):
    defs = {
        "wkv_a": ParamDef((d_model, kv_lora_rank + qk_rope_dim), ("embed", "kv_lora")),
        "kv_norm": ParamDef((kv_lora_rank,), ("kv_lora",), "ones"),
        "wk_b": ParamDef((kv_lora_rank, num_heads, qk_nope_dim), ("kv_lora", "heads", "head_dim")),
        "wv_b": ParamDef((kv_lora_rank, num_heads, v_head_dim), ("kv_lora", "heads", "head_dim")),
        "wo": ParamDef((num_heads, v_head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if q_lora_rank:
        defs["wq_a"] = ParamDef((d_model, q_lora_rank), ("embed", None))
        defs["q_norm"] = ParamDef((q_lora_rank,), (None,), "ones")
        defs["wq_b"] = ParamDef(
            (q_lora_rank, num_heads, qk_nope_dim + qk_rope_dim),
            (None, "heads", "head_dim"),
        )
    else:
        defs["wq"] = ParamDef(
            (d_model, num_heads, qk_nope_dim + qk_rope_dim),
            ("embed", "heads", "head_dim"),
        )
    return defs


def cross_attn_defs(d_model: int, num_heads: int, head_dim: int):
    return attn_defs(d_model, num_heads, num_heads, head_dim)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number in ``like``'s dtype, as JAX's weak typing makes it
    (``bf16_array * 0.088`` multiplies by the bf16-rounded constant).
    Filled on the device: ``torch.tensor(value, device=...)`` would copy
    from the host and wait for the stream on every call."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd) by repetition (GQA)."""
    if groups == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, kv * groups, hd)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk")."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _attend_chunked(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Skv, H, hd)  (already GQA-expanded)
    v: torch.Tensor,              # (B, Skv, H, hd)
    q_positions: torch.Tensor,    # (Sq,)
    kv_positions: torch.Tensor,   # (Skv,)
    *,
    causal: bool,
    window: Optional[int],
    chunk: int = 512,
    scores_dtype: str = "float32",
) -> torch.Tensor:
    """Exact attention over query chunks (scores stay O(chunk*Skv)); the
    value head dim may differ from the query's (MLA)."""
    sq, hd = q.shape[1], q.shape[-1]
    scale = hd ** -0.5
    if sq % chunk:
        # Largest power-of-two divisor of sq not exceeding the request;
        # degenerate seqs fall back to a single block.
        c = 1
        while c * 2 <= chunk and sq % (c * 2) == 0:
            c *= 2
        chunk = c if c >= 16 else sq
    if sq <= chunk:
        return _attend_block(q, k, v, q_positions, kv_positions, scale, causal,
                             window, scores_dtype)
    return torch.cat([
        _attend_block(q[:, s : s + chunk], k, v, q_positions[s : s + chunk],
                      kv_positions, scale, causal, window, scores_dtype)
        for s in range(0, sq, chunk)
    ], dim=1)


def _attend_block(q, k, v, q_pos, kv_pos, scale, causal, window, scores_dtype):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * _const(scale, q)
    mask = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    scores = torch.where(mask[None, None], scores, _const(_NEG_INF, scores))
    if scores_dtype == "bfloat16":
        s16 = scores.to(torch.bfloat16)
        m = torch.amax(s16, dim=-1, keepdim=True)
        e = torch.exp((s16 - m).to(torch.float32)).to(torch.bfloat16)
        denom = torch.sum(e.to(torch.float32), dim=-1, keepdim=True)
        probs = (e / denom.to(torch.bfloat16)).to(q.dtype)
    else:
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _qkv(params, x, positions, *, rope_theta, mrope, mrope_positions):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if mrope:
        pos3 = (mrope_positions if mrope_positions is not None
                else torch.stack([positions] * 3, dim=0))
        q = apply_mrope(q, pos3, theta=rope_theta)
        k = apply_mrope(k, pos3, theta=rope_theta)
    elif rope_theta:
        q = apply_rope(q, positions, theta=rope_theta)
        k = apply_rope(k, positions, theta=rope_theta)
    return q, k, v


def _out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d")."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


def attention_train(
    params: Dict,
    x: torch.Tensor,                # (B, S, d)
    positions: torch.Tensor,        # (S,)
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    causal: bool = True,
    window: Optional[int] = None,
    mrope: bool = False,
    mrope_positions: Optional[torch.Tensor] = None,
    q_chunk: int = 512,
    return_cache: bool = False,
    scores_dtype: str = "float32",
    kv_index: Optional[torch.Tensor] = None,
):
    """Full-sequence self attention (prefill and training).  ``kv_index``
    (H,) names each query head's kv head where the mapping is not GQA's
    contiguous groups (a tensor-parallel shard whose kv heads are whole:
    ``parallel.tensor_parallel.TensorParallel.kv_index``)."""
    q, k, v = _qkv(params, x, positions, rope_theta=rope_theta, mrope=mrope,
                   mrope_positions=mrope_positions)
    if kv_index is None:
        groups = num_heads // num_kv_heads
        kk, vv = _repeat_kv(k, groups), _repeat_kv(v, groups)
    else:
        kk, vv = k.index_select(2, kv_index), v.index_select(2, kv_index)
    out = _attend_chunked(
        q, kk, vv, positions, positions,
        causal=causal, window=window, chunk=q_chunk, scores_dtype=scores_dtype,
    )
    y = _out(out, params["wo"])
    if return_cache:
        return y, KVCache(k=k, v=v)
    return y


def _position(cur_index, device) -> torch.Tensor:
    """The position being generated as a (1,) int64 tensor: from an int,
    or from a one-element tensor (what a CUDA graph of the decode step
    reads, so the step needs no host value)."""
    if isinstance(cur_index, torch.Tensor):
        return cur_index.reshape(1).to(torch.int64)
    return torch.full((1,), cur_index, dtype=torch.int64, device=device)


def _group_scores(q: torch.Tensor, keys: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, H, hd) x (B, S, KV, hd) -> (B, H, S): each head against its KV
    head's keys, the cache never widened to H heads."""
    b, h, hd = q.shape
    kv = keys.shape[2]
    qg = q.reshape(b, kv, groups, hd)
    return (qg @ keys.permute(0, 2, 3, 1)).reshape(b, h, -1)


def attention_decode(
    params: Dict,
    x: torch.Tensor,                # (B, 1, d)
    cache: KVCache,
    cur_index,                      # position being generated: int or tensor
    *,
    num_heads: int,
    num_kv_heads: int,
    rope_theta: float = 10000.0,
    window: Optional[int] = None,
    mrope: bool = False,
    knn_k: int = 0,
    knn_recall_target: float = 0.95,
) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode; writes position ``cur_index`` of ``cache`` in
    place and returns it.

    With ``knn_k > 0`` key selection runs through the paper's PartialReduce
    (``knn_decode_attention``) instead of full softmax over S.
    """
    pos = _position(cur_index, x.device)
    q, k_new, v_new = _qkv(params, x, pos.to(torch.int32), rope_theta=rope_theta,
                           mrope=mrope, mrope_positions=None)
    cache.k.index_copy_(1, pos, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, pos, v_new.to(cache.v.dtype))
    groups = num_heads // num_kv_heads

    q1 = q[:, 0]                    # (B, H, hd)
    kv_pos = torch.arange(cache.k.shape[1], dtype=torch.int64, device=x.device)
    valid = kv_pos <= pos
    if window is not None:
        valid &= pos - kv_pos < window
    if knn_k:
        out = knn_decode_attention(q1, cache.k, cache.v, valid, k=knn_k,
                                   recall_target=knn_recall_target,
                                   kv_groups=groups)
    else:
        scores = _group_scores(q1, cache.k, groups) * _const(q1.shape[-1] ** -0.5, q1)
        scores = torch.where(valid, scores, _const(_NEG_INF, scores))
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q1.dtype)
        b, h, s = probs.shape
        out = (probs.reshape(b, -1, groups, s) @ cache.v.transpose(1, 2)).reshape(b, h, -1)
    return _out(out, params["wo"])[:, None], cache


def knn_decode_attention(
    q: torch.Tensor,        # (B, H, hd)
    keys: torch.Tensor,     # (B, S, KV, hd)  raw (kv_groups expands to H)
    values: torch.Tensor,   # (B, S, KV, hd)
    valid: torch.Tensor,    # (S,) bool
    *,
    k: int,
    recall_target: float = 0.95,
    kv_groups: int = 1,
) -> torch.Tensor:
    """Paper-technique attention over a KV cache: all scores in one
    matmul, ``approx_max_k`` keeps k keys with E[recall] per Eq. 13, an
    exact softmax over them weighs their values.  Early in a decode
    (fewer live positions than k) the masked positions it returns weigh
    exactly 0.

    When the cache sequence is context-parallel (the active mesh's rules
    map the ``"cp_seq"`` logical axis to axes of that mesh), this runs
    the paper's §7 algorithm, :func:`_knn_decode_attention_cp` over those
    axes: PartialReduce per shard against the global S, only the bin
    winners and their value rows gathered, the global top-k and softmax
    after."""
    mesh = current_mesh()
    cp = None
    if mesh is not None:
        spec = logical_to_spec(("cp_seq",))[0]
        if spec is not None:
            cp = spec if isinstance(spec, tuple) else (spec,)
    if cp:
        return _knn_decode_attention_cp(
            q, keys, values, valid, k=k, recall_target=recall_target,
            mesh=mesh, cp_axes=cp, kv_groups=kv_groups)
    b, h, hd = q.shape
    scores = _group_scores(q, keys, kv_groups) * _const(hd ** -0.5, q)
    scores = torch.where(valid, scores, _const(_NEG_INF, scores))
    top_scores, top_idx = approx_max_k(scores, k, recall_target=recall_target)
    probs = torch.softmax(top_scores.to(torch.float32), dim=-1).to(q.dtype)
    # the selected values, (B, H, k, hd): head h reads KV head h // groups
    heads = torch.arange(h, device=q.device) // kv_groups
    batch = torch.arange(b, device=q.device)
    sel = values.transpose(1, 2)[batch[:, None, None], heads[None, :, None],
                                 top_idx.long()]
    return torch.einsum("bhk,bhkd->bhd", probs, sel)


def _knn_cp_candidates(q, keys, values, valid, *, k: int,
                       recall_target: float, mesh, cp_axes,
                       kv_groups: int = 1):
    """Every context-parallel shard's bin winners, gathered to ``q``'s
    device in shard order: values (B, H, L) f32, their global cache
    positions (B, H, L) and value rows (B, H, L, hd) in bf16."""
    cp_axes = (cp_axes,) if isinstance(cp_axes, str) else tuple(cp_axes)
    devices = mesh.device_grid(cp_axes)[0]
    b, h, hd = q.shape
    global_s = keys.shape[1]
    if global_s % len(devices):
        raise ValueError(f"S={global_s} does not split into {len(devices)} "
                         "context-parallel shards")
    s_l = global_s // len(devices)
    home = q.device
    all_vals, all_pos, all_v = [], [], []
    for j, dev in enumerate(devices):
        part = slice(j * s_l, (j + 1) * s_l)
        ql, keys_l = q.to(dev), keys[:, part].to(dev)
        values_l, valid_l = values[:, part].to(dev), valid[part].to(dev)
        scores = _group_scores(ql, keys_l, kv_groups) * _const(hd ** -0.5, ql)
        scores = torch.where(valid_l, scores, _const(_NEG_INF, scores))
        vals, idxs = approx_max_k(scores, min(k, s_l),
                                  recall_target=recall_target,
                                  reduction_input_size_override=global_s,
                                  aggregate_to_topk=False)
        heads = torch.arange(h, device=dev) // kv_groups
        batch = torch.arange(b, device=dev)
        # the winners' value rows travel in bf16 (scores stay f32)
        sel = values_l.transpose(1, 2)[batch[:, None, None],
                                       heads[None, :, None],
                                       idxs.long()].to(torch.bfloat16)
        all_vals.append(vals.to(home))
        all_pos.append(idxs.long().to(home) + j * s_l)
        all_v.append(sel.to(home))
    return (torch.cat(all_vals, dim=2), torch.cat(all_pos, dim=2),
            torch.cat(all_v, dim=2))


def _knn_decode_attention_cp(q, keys, values, valid, *, k: int,
                             recall_target: float, mesh, cp_axes,
                             kv_groups: int = 1) -> torch.Tensor:
    """kNN attention over a sequence-sharded cache (paper §7), the
    reference's ``_knn_decode_attention_cp`` on a mesh of torch devices
    (``repro_torch.parallel.mesh``).

    The cache's S positions split into the shards of ``cp_axes``
    (row-major over them).  Each shard, on its device, scores its keys
    group-wise and keeps its bin winners (``approx_max_k`` against the
    global S, ``aggregate_to_topk=False``) with their value rows in bf16;
    the winners are gathered to the first device in shard order
    (:func:`_knn_cp_candidates`), and a global top-k (the earliest
    position wins a tie) and an exact softmax weigh the values.  Shapes
    as :func:`knn_decode_attention`.
    """
    vals, _, sel_v = _knn_cp_candidates(
        q, keys, values, valid, k=k, recall_target=recall_target, mesh=mesh,
        cp_axes=cp_axes, kv_groups=kv_groups)
    top_vals, pos = stable_topk(vals, k)
    probs = torch.softmax(top_vals.to(torch.float32), dim=-1).to(q.dtype)
    top_v = torch.gather(sel_v, 2,
                         pos[..., None].expand(-1, -1, -1, q.shape[-1]))
    return torch.einsum("bhk,bhkd->bhd", probs, top_v.to(q.dtype))


# --------------------------------------------------------------------------
# MLA (deepseek-v2 multi-head latent attention)
# --------------------------------------------------------------------------


def _mla_q(params, x, positions, *, qk_nope_dim, qk_rope_dim, rope_theta):
    if "wq_a" in params:
        cq = rms_norm(x @ params["wq_a"], params["q_norm"])
        q = _project(cq, params["wq_b"])
    else:
        q = _project(x, params["wq"])
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, theta=rope_theta)
    return q_nope, q_rope


def mla_train(
    params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    num_heads: int,
    kv_lora_rank: int,
    qk_nope_dim: int = 128,
    qk_rope_dim: int = 64,
    rope_theta: float = 10000.0,
    q_chunk: int = 512,
    return_cache: bool = False,
    scores_dtype: str = "float32",
):
    """MLA over the full sequence (prefill): the latent expanded to each
    head's keys and values, then exact causal attention."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, positions, qk_nope_dim=qk_nope_dim,
                            qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    kv_a = x @ params["wkv_a"]
    c_kv = rms_norm(kv_a[..., :kv_lora_rank], params["kv_norm"])
    k_rope = apply_rope(kv_a[..., None, kv_lora_rank:], positions,
                        theta=rope_theta)  # (B, S, 1, rope_dim) shared across heads
    k_nope = _project(c_kv, params["wk_b"])
    value = _project(c_kv, params["wv_b"])
    k_full = torch.cat([k_nope, k_rope.expand(b, s, num_heads, qk_rope_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = _attend_chunked(q_full, k_full, value, positions, positions, causal=True,
                          window=None, chunk=q_chunk, scores_dtype=scores_dtype)
    y = _out(out, params["wo"])
    if return_cache:
        return y, MLACache(c_kv=c_kv, k_rope=k_rope[:, :, 0, :])
    return y


def mla_decode(
    params: Dict,
    x: torch.Tensor,               # (B, 1, d)
    cache: MLACache,
    cur_index,                     # position being generated: int or tensor
    *,
    num_heads: int,
    kv_lora_rank: int,
    qk_nope_dim: int = 128,
    qk_rope_dim: int = 64,
    rope_theta: float = 10000.0,
    knn_k: int = 0,
    knn_recall_target: float = 0.95,
) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-matmul MLA decode: attends in the compressed kv_lora space
    (score = q_nopeᵀ(W_kb c) + q_ropeᵀ k_rope, W_kb absorbed into the
    query); writes position ``cur_index`` of ``cache`` in place."""
    b = x.shape[0]
    pos = _position(cur_index, x.device)
    positions = pos.to(torch.int32)
    q_nope, q_rope = _mla_q(params, x, positions, qk_nope_dim=qk_nope_dim,
                            qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    kv_a = x @ params["wkv_a"]
    c_new = rms_norm(kv_a[..., :kv_lora_rank], params["kv_norm"])
    kr_new = apply_rope(kv_a[..., None, kv_lora_rank:], positions,
                        theta=rope_theta)[:, :, 0]
    cache.c_kv.index_copy_(1, pos, c_new.to(cache.c_kv.dtype))
    cache.k_rope.index_copy_(1, pos, kr_new.to(cache.k_rope.dtype))
    c_kv, k_rope = cache.c_kv, cache.k_rope

    # Absorb W_kb into q: (B, H, kv_lora).
    q_c = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wk_b"])
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5
    scores = (q_c @ c_kv.transpose(1, 2)
              + q_rope[:, 0] @ k_rope.transpose(1, 2)) * _const(scale, q_c)
    valid = torch.arange(c_kv.shape[1], device=x.device) <= pos
    scores = torch.where(valid, scores, _const(_NEG_INF, scores))

    if knn_k:
        top_scores, top_idx = approx_max_k(scores, knn_k,
                                           recall_target=knn_recall_target)
        probs = torch.softmax(top_scores.to(torch.float32), dim=-1).to(x.dtype)
        # each (batch, head)'s selected latent rows, (B, H, k, r)
        batch = torch.arange(b, device=x.device)
        sel = c_kv[batch[:, None, None], top_idx.long()]
        attn_c = torch.einsum("bhk,bhkr->bhr", probs, sel)
    else:
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        attn_c = probs @ c_kv
    out = torch.einsum("bhr,rhk->bhk", attn_c, params["wv_b"])
    return _out(out, params["wo"])[:, None], cache


# --------------------------------------------------------------------------
# Cross attention (whisper decoder)
# --------------------------------------------------------------------------


def cross_attention(
    params: Dict,
    x: torch.Tensor,               # (B, Sq, d)
    enc_kv: KVCache,               # precomputed from the encoder output
    *,
    num_heads: int,
    q_chunk: int = 512,
    scores_dtype: str = "float32",
):
    q = _project(x, params["wq"])
    sq, skv = x.shape[1], enc_kv.k.shape[1]
    out = _attend_chunked(
        q, enc_kv.k, enc_kv.v,
        torch.arange(sq, device=x.device), torch.arange(skv, device=x.device),
        causal=False, window=None, chunk=q_chunk, scores_dtype=scores_dtype,
    )
    return _out(out, params["wo"])


def encode_cross_kv(params: Dict, enc_out: torch.Tensor) -> KVCache:
    return KVCache(k=_project(enc_out, params["wk"]), v=_project(enc_out, params["wv"]))
