"""Megatron tensor parallelism over the ``"model"`` axis of a process mesh.

The reference's GSPMD partitions the dense layer by its parameters' specs
(heads, kv_heads, ffn and vocab over ``"model"``,
``src/repro/launch/shardspecs.py``); the port writes the same partition
out as Megatron-LM's operators (Shoeybi et al., 2019), each a
``torch.autograd.Function``:

  * :func:`copy_to_model` ("f"): identity forward, all-reduce of the
    gradient backward.  It sits after each norm whose output feeds a
    column-parallel matmul (wq/wk/wv, wi/wg, a cross-attention's wq, the
    unembedding), and once on an encoder-decoder's encoder output, which
    feeds every decoder layer's column-parallel cross wk/wv.
  * :func:`reduce_from_model` ("g"): all-reduce forward, identity
    backward, after each row-parallel matmul (attention's and the MLP's
    ``wo``) and after the MoE block, whose output is each rank's experts'
    part (``models.moe.moe_apply`` with ``first_expert=``) plus its part of
    the shared experts.
  * :func:`vocab_parallel_embed`: each rank looks up the ids of its
    vocabulary rows (the others' give zeros), then "g".
  * :func:`vocab_parallel_cross_entropy`: the max, the sum of exponents
    and the target's logit all-reduced over the vocabulary's parts, the
    padded ids masked as the reference's ``loss_fn`` masks them.

:class:`TensorParallel` is a model's part of one ``"model"`` group: its
heads, its kv heads, its experts and its vocabulary rows.  Where the kv
heads do not divide the group (``launch.shardspecs._sanitize_spec`` keeps
them whole, Megatron's GQA convention), each local query head reads its
global kv head (:meth:`TensorParallel.kv_index`).

A block of a split layer (:data:`SPLIT_BLOCKS`) runs between an "f" and
a "g", so every rank reads each of its leaves; a leaf that ``"model"``
leaves whole there (those whole kv heads; MLA's ``wq_a``, ``q_norm``,
``wkv_a`` and ``kv_norm``, which feed every head; the MoE router, which
routes to every expert) then gets only this rank's heads' or experts'
part of its gradient, and the training step sums it over ``"model"``
(``parallel.distributed.ShardLayout.partial``).  MoE is split as the
reference's GSPMD splits its one-hot dispatch: every rank routes every
token of its data shard (the same top-k, queue places and capacity drops
on each) and runs only its experts' slots; no all-to-all.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel import distributed as D

__all__ = [
    "TensorParallel",
    "unsupported_kind",
    "TP_KINDS",
    "SPLIT_BLOCKS",
    "copy_to_model",
    "reduce_from_model",
    "vocab_parallel_embed",
    "vocab_parallel_cross_entropy",
]


# what each missing tensor-parallel case waits for (ROADMAP item 14b.2c)
_KIND_ITEMS = {"ssm": "the Mamba-2 SSD block", "rglru": "RG-LRU",
               "local_attn": "local attention"}
# the layer kinds with a tensor-parallel path: the dense decoder layer,
# whisper's encoder and decoder layers, MoE (experts over "model") and
# MLA (heads over "model") with a dense MLP or MoE
TP_KINDS = frozenset({"dense", "enc", "dec", "moe", "mla_dense", "mla_moe"})
# the blocks of a TP_KINDS layer that run between an "f" and a "g"
SPLIT_BLOCKS = frozenset({"attn", "cross", "mlp", "moe"})


def unsupported_kind(kind: str) -> str:
    """Why a layer of ``kind`` has no tensor-parallel path yet."""
    what = _KIND_ITEMS.get(kind, kind)
    return (f"tensor parallelism for {kind} layers ({what}) is ROADMAP item "
            f"14b.2c; the dense, enc, dec, moe, mla_dense and mla_moe layers "
            f"have a tensor-parallel path")


class TensorParallel:
    """The calling rank's part of the ``"model"`` axis of ``mesh`` for a
    model of ``cfg`` (global sizes): ``num_heads`` query heads from
    head ``rank * num_heads``, ``num_kv_heads`` kv heads (all of them
    where they do not divide the group, ``kv_sharded`` False),
    ``num_experts`` routed experts from ``expert_start`` and
    ``vocab_size`` rows of the (padded) vocabulary from ``vocab_start``.
    A cross-attention's kv heads are its query heads
    (``attention.cross_attn_defs``), so they split with them: its local
    heads are ``num_heads``.  MLA has no kv heads: its ``wk_b`` and
    ``wv_b`` split with its query heads, and it never reads
    :meth:`kv_index`."""

    def __init__(self, mesh, cfg, *, kv_sharded: bool):
        self.mesh = mesh
        self.size = mesh.shape["model"]
        self.rank = mesh.axis_index("model")
        self.global_heads = cfg.num_heads
        self.global_kv_heads = cfg.num_kv_heads
        self.num_heads = cfg.num_heads // self.size
        self.kv_sharded = kv_sharded
        self.num_kv_heads = (cfg.num_kv_heads // self.size if kv_sharded
                             else cfg.num_kv_heads)
        self.num_experts = cfg.num_experts // self.size
        self.expert_start = self.rank * self.num_experts
        self.vocab_size = cfg.padded_vocab // self.size
        self.vocab_start = self.rank * self.vocab_size
        self.true_vocab = cfg.vocab_size

    def kv_index(self, device) -> Optional[torch.Tensor]:
        """Where the kv heads are whole: each local query head's global kv
        head (its global index over the query heads a kv head serves);
        None where they are split with the query heads."""
        if self.kv_sharded:
            return None
        groups = self.global_heads // self.global_kv_heads
        first = self.rank * self.num_heads
        return torch.arange(first, first + self.num_heads, device=device) // groups

    def __repr__(self) -> str:
        experts = (f"experts {self.expert_start}.."
                   f"{self.expert_start + self.num_experts}, "
                   if self.num_experts else "")
        return (f"TensorParallel(rank {self.rank} of {self.size}: {self.num_heads} "
                f"heads, {self.num_kv_heads} kv heads"
                f"{'' if self.kv_sharded else ' (whole)'}, {experts}vocab rows "
                f"{self.vocab_start}..{self.vocab_start + self.vocab_size})")


def _reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    return D.all_reduce(t.contiguous().clone(), "model", op, mesh=mesh)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.mesh), None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Megatron's "f": ``x`` (replicated over ``"model"``) as the input
    of a column-parallel matmul; its gradient is summed over the group."""
    return _CopyToModel.apply(x, tp.mesh)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Megatron's "g": the sum over the group of each rank's partial
    ``x`` (a row-parallel matmul's output)."""
    return D.sum_forward(x, "model", tp.mesh)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor,
                         tp: TensorParallel) -> torch.Tensor:
    """Rows ``ids`` of the vocabulary-parallel ``table`` (this rank's
    ``tp.vocab_size`` rows): each rank looks up the ids it holds, zeros
    for the rest, summed over the group (exact: one rank holds each
    id)."""
    local = ids - tp.vocab_start
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    return reduce_from_model(rows, tp)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over logits split on
    the vocabulary; labels outside this rank's rows (and negative
    labels) contribute 0 to the target's sum."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        n = logits.shape[-1]
        if tp.vocab_start + n > tp.true_vocab:  # the padded ids, as loss_fn
            ids = torch.arange(tp.vocab_start, tp.vocab_start + n,
                               device=logits.device)
            logits = logits - 1e9 * (ids >= tp.true_vocab)
        top = _reduce(torch.amax(logits, dim=-1), tp.mesh, "max")
        shifted = logits - top[..., None]
        exp = torch.exp(shifted)
        total = _reduce(exp.sum(dim=-1), tp.mesh)
        local = labels - tp.vocab_start
        inside = (local >= 0) & (local < n)
        local = torch.where(inside, local, 0)
        target = torch.gather(shifted, -1, local[..., None])[..., 0]
        target = _reduce(torch.where(inside, target, torch.zeros_like(target)),
                         tp.mesh)
        exp.div_(total[..., None])
        ctx.save_for_backward(exp, local, inside)
        return torch.log(total) - target

    @staticmethod
    def backward(ctx, grad):
        probs, local, inside = ctx.saved_tensors
        out = probs * grad[..., None]
        take = torch.where(inside, grad, torch.zeros_like(grad))
        out.scatter_add_(-1, local[..., None], -take[..., None])
        return out, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 tp: TensorParallel) -> torch.Tensor:
    """Each token's cross entropy ``-log softmax(logits)[label]`` (B, S),
    f32, from this rank's (B, S, V / size) f32 logits; a label < 0 gives
    a finite value the caller masks."""
    return _VocabParallelCE.apply(logits, labels.long(), tp)
