"""Mixture-of-Experts layer: token-choice top-k routing, grouped capacity
dispatch, plus deepseek-style shared experts.

Port of ``src/repro/models/moe.py``.  Router top-k is ``"exact"`` (the
reference's ``lax.top_k``: a stable descending sort here, so the lowest
expert index wins a tie) by default; ``"approx"`` runs the paper's
``approx_max_k`` over the softmaxed probabilities (when k > 1 and
E >= 2k).  Capacity and drops are the reference's: ``cap =
int(min(g, max(k, round(g·k/E·cf))))`` (Python's ``round``, halves to
even), a token's place in its expert's queue counted over the
token-major (t, k) order, and a pair kept while its place is below the
capacity.

The reference dispatches and combines with one-hot einsums (the TPU's
lowering).  Each (expert, slot) receives exactly one token or none, so
the port gathers instead: a slot's token index (a plain scatter of
unique destinations; dropped pairs land in a discarded column), the
tokens gathered into the expert batches, and each token's k outputs
gathered back and weighed.  No atomic add anywhere: a CUDA graph replay
of a step is bit-equal to an eager one.  The backward keeps that: the
gradient of a token is the sum of its k slots' gradients, gathered
(:class:`_Dispatch`), and the gradient of an expert output row is its one
pair's, scattered to a unique destination (:class:`_Combine`); autograd's
own backward of a gather would add them with atomics.

Under tensor parallelism (``parallel.tensor_parallel``) ``params`` holds
one rank's experts, ``first_expert`` on: every rank routes every token
(the router is whole), so the top-k, the queue places and the drops are
the whole layer's, and a rank dispatches only the pairs of its experts
(the others go to the discarded column and weigh 0).  Its output, and
its part of the shared experts' (split over ``"ffn"`` as the dense
MLP), is a partial sum the caller completes over ``"model"``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.topk import approx_max_k
from repro_torch.models.params import ParamDef

__all__ = ["moe_defs", "moe_apply"]


def moe_defs(
    d_model: int,
    moe_d_ff: int,
    num_experts: int,
    *,
    num_shared_experts: int = 0,
):
    defs = {
        "router": ParamDef((d_model, num_experts), ("embed", None)),
        "wi": ParamDef((num_experts, d_model, moe_d_ff), ("experts", "embed", "moe_ffn")),
        "wg": ParamDef((num_experts, d_model, moe_d_ff), ("experts", "embed", "moe_ffn")),
        "wo": ParamDef((num_experts, moe_d_ff, d_model), ("experts", "moe_ffn", "embed")),
    }
    if num_shared_experts:
        shared_ff = num_shared_experts * moe_d_ff
        defs["shared_wi"] = ParamDef((d_model, shared_ff), ("embed", "ffn"))
        defs["shared_wg"] = ParamDef((d_model, shared_ff), ("embed", "ffn"))
        defs["shared_wo"] = ParamDef((shared_ff, d_model), ("ffn", "embed"))
    return defs


def _router_topk(probs, k, routing: str, recall_target: float):
    if routing == "approx" and k > 1 and probs.shape[-1] >= 2 * k:
        return approx_max_k(probs, k, recall_target=recall_target)
    # lax.top_k: the lowest index wins a tie (torch.topk promises no order)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _Dispatch(torch.autograd.Function):
    """``xt`` (G, g, d) -> the (G, E·cap, d) expert batches: slot j reads
    token ``src[:, j]`` (g, the zero row, for an empty slot).  ``dst``
    (G, g·k) is each (token, choice) pair's slot, E·cap for a dropped
    pair; the backward gathers each token's k slot gradients and sums
    them in choice order."""

    @staticmethod
    def forward(ctx, xt, src, dst, k):
        ctx.save_for_backward(dst)
        ctx.k = k
        d = xt.shape[-1]
        return torch.gather(F.pad(xt, (0, 0, 0, 1)), 1,
                            src[..., None].expand(-1, -1, d))

    @staticmethod
    def backward(ctx, grad):
        (dst,) = ctx.saved_tensors
        n_groups, _, d = grad.shape
        per = torch.gather(F.pad(grad, (0, 0, 0, 1)), 1,
                           dst[..., None].expand(-1, -1, d))
        return per.reshape(n_groups, -1, ctx.k, d).sum(2), None, None, None


class _Combine(torch.autograd.Function):
    """The (G, E·cap, d) expert outputs -> each (token, choice) pair's
    row (G, g·k, d), a zero row for a dropped pair (``dst`` E·cap).  The
    kept pairs' slots are unique, so the backward scatters without
    accumulating (the dropped pairs write the cut-off row)."""

    @staticmethod
    def forward(ctx, expert_out, dst):
        ctx.save_for_backward(dst)
        ctx.rows = expert_out.shape[1]
        d = expert_out.shape[-1]
        return torch.gather(F.pad(expert_out, (0, 0, 0, 1)), 1,
                            dst[..., None].expand(-1, -1, d))

    @staticmethod
    def backward(ctx, grad):
        (dst,) = ctx.saved_tensors
        n_groups, _, d = grad.shape
        out = grad.new_zeros((n_groups, ctx.rows + 1, d))
        out.scatter_(1, dst[..., None].expand(-1, -1, d), grad)
        return out[:, : ctx.rows], None


def _capacity(g: int, k: int, num_experts: int, capacity_factor: float) -> int:
    return int(min(g, max(k, round(g * k / num_experts * capacity_factor))))


def _route(params: Dict, xt: torch.Tensor, *, experts_per_token: int,
          num_experts: int, cap: int, routing: str = "exact",
          recall_target: float = 0.95, router_scale: Optional[float] = None):
    """Router of ``xt`` (G, g, d) -> (weights (G, g, k) f32, experts
    (G, g, k), slots (G, g, k), kept (G, g, k) bool): each (token, choice)
    pair's renormalised probability, expert, place in that expert's
    queue and whether the place is below ``cap``."""
    k = experts_per_token
    logits = xt @ params["router"]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_e = _router_topk(probs, k, routing, recall_target)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)  # renormalise
    if router_scale:
        top_p = top_p * router_scale
    top_e = top_e.long()
    # Place of each (token, choice) in its expert's queue: a running count
    # over the token-major (t, k) order, as the reference's one-hot cumsum.
    n_groups, g = xt.shape[:2]
    sel = top_e[..., None] == torch.arange(num_experts, device=xt.device)
    counts = torch.cumsum(sel.reshape(n_groups, g * k, num_experts).to(torch.int32),
                          dim=1).reshape(n_groups, g, k, num_experts)
    slot = torch.gather(counts, -1, top_e[..., None])[..., 0] - 1
    return top_p, top_e, slot, slot < cap


def moe_apply(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d)
    *,
    experts_per_token: int,
    num_experts: int,
    capacity_factor: float = 1.5,
    group_size: int = 1024,
    routing: str = "exact",          # "exact" | "approx"
    recall_target: float = 0.95,
    router_scale: Optional[float] = None,
    first_expert: int = 0,
) -> torch.Tensor:
    """Grouped-capacity MoE forward: tokens reshaped to (G, g), each group
    dispatched to (E, cap) slots independently.  ``params["wi"]`` holds
    experts ``first_expert`` on (all ``num_experts`` of them in a whole
    model); the output sums those experts' pairs only."""
    b, s, d = x.shape
    k = experts_per_token
    tokens = b * s
    g = min(group_size, tokens)
    if tokens % g:
        raise ValueError(f"tokens {tokens} not divisible by group {g}")
    n_groups = tokens // g
    cap = _capacity(g, k, num_experts, capacity_factor)
    xt = x.reshape(n_groups, g, d)
    top_p, top_e, slot, keep = _route(
        params, xt, experts_per_token=k, num_experts=num_experts, cap=cap,
        routing=routing, recall_target=recall_target, router_scale=router_scale)

    # Dispatch: the token of each (expert, slot) of the local experts; an
    # empty slot reads the zero row g.  Destinations of kept pairs are
    # unique; dropped pairs and another rank's all go to the column
    # local * cap, which is cut off.
    local = params["wi"].shape[0]
    mine = keep & (top_e >= first_expert) & (top_e < first_expert + local)
    flat = (top_e - first_expert) * cap + slot
    dst = torch.where(mine, flat, local * cap).reshape(n_groups, g * k)
    tok = torch.arange(g, device=x.device)[:, None].expand(g, k).reshape(1, g * k)
    tok = tok.expand(n_groups, -1)
    src = torch.full((n_groups, local * cap + 1), g, dtype=torch.long,
                     device=x.device)
    src.scatter_(1, dst, tok)
    expert_in = _Dispatch.apply(xt, src[:, : local * cap], dst, k
                                ).reshape(n_groups, local, cap, d)

    # Expert FFNs: (G, E, cap, d) x (E, d, f).
    h = expert_in @ params["wi"]
    gate = expert_in @ params["wg"]
    h = F.silu(gate) * h
    expert_out = (h @ params["wo"]).reshape(n_groups, local * cap, d)

    # Combine: each token's k outputs (a dropped pair, or another rank's,
    # weighs 0), weights in the compute dtype as the reference's combine
    # tensor holds them.
    got = _Combine.apply(expert_out, dst).reshape(n_groups, g, k, d)
    w = torch.where(mine, top_p, 0.0).to(x.dtype)
    y = (w[..., None, :] @ got)[..., 0, :]

    if "shared_wi" in params:
        sh = F.silu(xt @ params["shared_wg"]) * (xt @ params["shared_wi"])
        y = y + sh @ params["shared_wo"]
    return y.reshape(b, s, d)
