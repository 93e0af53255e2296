"""Megatron tensor parallelism over the ``"model"`` axis of a process mesh.

The reference's GSPMD partitions each layer by its parameters' specs
(heads, kv_heads, ffn, experts, vocab, ssm_heads, conv_dim and lru_width
over ``"model"``, ``src/repro/launch/shardspecs.py``,
``src/repro/parallel/sharding.py``); the port writes the same partition
out as Megatron-LM's operators (Shoeybi et al., 2019), each a
``torch.autograd.Function``:

  * :func:`copy_to_model` ("f"): identity forward, all-reduce of the
    gradient backward.  It sits after each norm whose output feeds a
    column-parallel matmul (wq/wk/wv, wi/wg, a cross-attention's wq,
    RG-LRU's wx/wy, the SSD's gathered ``in_proj``, the unembedding),
    and once on an encoder-decoder's encoder output, which feeds every
    decoder layer's column-parallel cross wk/wv.
  * :func:`reduce_from_model` ("g"): all-reduce forward, identity
    backward, after each row-parallel matmul (attention's, the MLP's and
    RG-LRU's ``wo``, the SSD's ``out_proj``) and after the MoE block,
    whose output is each rank's experts' part (``models.moe.moe_apply``
    with ``first_expert=``) plus its part of the shared experts.
  * :func:`sum_squares`: a sum of squares over a dim split over
    ``"model"``, all-reduced forward and backward (each rank's part of
    the SSD's gated RMS norm reads the whole; an identity backward, as
    "g"'s, would drop the other ranks' share of its gradient).
  * :func:`gather_from_model`: a leaf's contiguous cuts gathered whole,
    its gradient reduce-scattered back.  The SSD's ``in_proj`` and conv
    are cut where no head boundary falls (their ``[z | x | B | C | dt]``
    and ``[x | B | C]`` concatenations over ``"conv_dim"``), so each
    layer gathers them and takes its heads' columns and the whole ``B``
    and ``C`` (one group, read by every head, so each rank's gradient of
    them is its heads' part, summed by the reduce-scatter).  Gathering
    the weight moves ``d_model x (2 d_inner + 2 n_state + heads)``
    values a layer whatever the batch (54.1 MB at mamba2-2.7b's width in
    bf16); gathering ``in_proj``'s output instead moves the tokens'
    activations (86.6 MB at batch 2 x 2,048).
  * :func:`reduce_scatter_to_model`: a partial sum of every channel
    reduce-scattered to the rank's channels, its gradient all-gathered:
    RG-LRU's dense gates are cut on their rows (``("lru_width",
    None)``), the contraction dim, so ``x @ w`` on a rank's channels is a
    partial sum of every output channel (one collective a gate a layer;
    block-diagonal gates hold the rank's blocks and need none).
  * :func:`vocab_parallel_embed`: each rank looks up the ids of its
    vocabulary rows (the others' give zeros), then "g".
  * :func:`vocab_parallel_cross_entropy`: the max, the sum of exponents
    and the target's logit all-reduced over the vocabulary's parts, the
    padded ids masked as the reference's ``loss_fn`` masks them.

:class:`TensorParallel` is a model's part of one ``"model"`` group: its
heads, its kv heads, its experts, its SSD heads, its RG-LRU channels and
its vocabulary rows.  The recurrent blocks' per-head and per-channel
leaves (``a_log``, ``dt_bias``, ``d_skip``, the SSD's ``norm`` and
``out_proj`` rows; RG-LRU's ``wx``/``wy`` columns, conv, gate biases,
``lam`` and ``wo`` rows) are cut in the rank's order, so the chunked
SSD scan and the RG-LRU scan run on the rank's part with no
collective.  Where the kv heads do not divide the group
(``launch.shardspecs._sanitize_spec`` keeps them whole, Megatron's GQA
convention), each local query head reads its global kv head
(:meth:`TensorParallel.kv_index`).

A block of a split layer (:data:`SPLIT_BLOCKS`) runs between an "f" and
a "g", so every rank reads each of its leaves; a leaf that ``"model"``
leaves whole there (those whole kv heads, local attention's among them;
MLA's ``wq_a``, ``q_norm``, ``wkv_a`` and ``kv_norm``, which feed every
head; the MoE router, which routes to every expert) then gets only this
rank's heads' or experts' part of its gradient, and the training step
sums it over ``"model"``
(``parallel.distributed.ShardLayout.partial``).  MoE is split as the
reference's GSPMD splits its one-hot dispatch: every rank routes every
token of its data shard (the same top-k, queue places and capacity drops
on each) and runs only its experts' slots; no all-to-all.

A block whose dims ``"model"`` leaves whole (``launch.shardspecs
._sanitize_spec`` keeps whole a dim the axis does not divide:
starcoder2-7b's 36 heads, granite-moe's 24 heads and 40 experts over 16)
runs whole on every rank of the group, the values of the reference's
step on those replicated specs (whose partitioner may still split the
block's dots among the devices): :meth:`TensorParallel.block` gives
None for it, so it sits outside the operators (no "f" before it: its
input's gradient is the same on every rank, and an all-reduce would sum
``size`` equal copies; no "g" after it).  Its leaves' gradients are then
the same on every rank and are reduced over the data axes only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel import distributed as D

__all__ = [
    "TensorParallel",
    "TP_KINDS",
    "SPLIT_BLOCKS",
    "copy_to_model",
    "reduce_from_model",
    "sum_squares",
    "gather_from_model",
    "reduce_scatter_to_model",
    "vocab_parallel_embed",
    "vocab_parallel_cross_entropy",
]


# the layer kinds with a tensor-parallel path: every kind
# ``ModelConfig.layer_kinds`` gives
TP_KINDS = frozenset({"dense", "enc", "dec", "moe", "mla_dense", "mla_moe",
                      "local_attn", "rglru", "ssm"})
# the blocks of a layer that run between an "f" and a "g"
SPLIT_BLOCKS = frozenset({"attn", "cross", "mlp", "moe", "rglru", "ssm"})


class TensorParallel:
    """The calling rank's part of the ``"model"`` axis of ``mesh`` for a
    model of ``cfg`` (global sizes): ``num_heads`` query heads from
    head ``rank * num_heads``, ``num_kv_heads`` kv heads (all of them
    where they do not divide the group, ``kv_sharded`` False),
    ``num_experts`` routed experts from ``expert_start`` and
    ``vocab_size`` rows of the (padded) vocabulary from ``vocab_start``,
    ``ssm_heads`` SSD heads from ``ssm_head_start`` and ``lru_width``
    RG-LRU channels from ``lru_start``.  A cross-attention's kv heads are
    its query heads (``attention.cross_attn_defs``), so they split with
    them: its local heads are ``num_heads``.  MLA has no kv heads: its
    ``wk_b`` and ``wv_b`` split with its query heads, and it never reads
    :meth:`kv_index`.  ``whole`` names the blocks (of
    :data:`SPLIT_BLOCKS`) that run whole on every rank: their sizes are
    the global ones (every head, every expert, from 0)."""

    def __init__(self, mesh, cfg, *, kv_sharded: bool, whole=frozenset()):
        self.mesh = mesh
        self.size = mesh.shape["model"]
        self.rank = mesh.axis_index("model")
        self.whole = frozenset(whole)
        self.global_heads = cfg.num_heads
        self.global_kv_heads = cfg.num_kv_heads
        self.num_heads = self._part("attn", cfg.num_heads)
        self.kv_sharded = kv_sharded and "attn" not in self.whole
        self.num_kv_heads = (cfg.num_kv_heads // self.size if self.kv_sharded
                             else cfg.num_kv_heads)
        self.num_experts = self._part("moe", cfg.num_experts)
        self.expert_start = self._start("moe", self.num_experts)
        self.vocab_size = cfg.padded_vocab // self.size
        self.vocab_start = self.rank * self.vocab_size
        self.true_vocab = cfg.vocab_size
        kinds = set(cfg.layer_kinds())
        ssm_heads = (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
                     if "ssm" in kinds else 0)
        self.ssm_heads = self._part("ssm", ssm_heads)
        self.ssm_head_start = self._start("ssm", self.ssm_heads)
        lru = (cfg.lru_width or cfg.d_model) if "rglru" in kinds else 0
        self.lru_width = self._part("rglru", lru)
        self.lru_start = self._start("rglru", self.lru_width)

    def _part(self, block: str, n: int) -> int:
        return n if block in self.whole else n // self.size

    def _start(self, block: str, part: int) -> int:
        return 0 if block in self.whole else self.rank * part

    def block(self, name: str) -> Optional["TensorParallel"]:
        """What block ``name`` (of :data:`SPLIT_BLOCKS`) runs under: this
        shard where the block is split, None where it runs whole."""
        return None if name in self.whole else self

    def __deepcopy__(self, memo):
        # a copy of a shard's model lies on the same ranks (the fake
        # copies of ``analysis.op_cost.program_cost``)
        return self

    def kv_index(self, device) -> Optional[torch.Tensor]:
        """Where the kv heads are whole: each local query head's global kv
        head (its global index over the query heads a kv head serves);
        None where they are split with the query heads."""
        if self.kv_sharded:
            return None
        groups = self.global_heads // self.global_kv_heads
        first = self._start("attn", self.num_heads)
        return torch.arange(first, first + self.num_heads, device=device) // groups

    def __repr__(self) -> str:
        experts = (f"experts {self.expert_start}.."
                   f"{self.expert_start + self.num_experts}, "
                   if self.num_experts else "")
        ssm = (f"ssm heads {self.ssm_head_start}.."
               f"{self.ssm_head_start + self.ssm_heads}, " if self.ssm_heads else "")
        lru = (f"lru channels {self.lru_start}.."
               f"{self.lru_start + self.lru_width}, " if self.lru_width else "")
        whole = f"whole {sorted(self.whole)}, " if self.whole else ""
        return (f"TensorParallel(rank {self.rank} of {self.size}: {self.num_heads} "
                f"heads, {self.num_kv_heads} kv heads"
                f"{'' if self.kv_sharded else ' (whole)'}, {experts}{ssm}{lru}"
                f"{whole}vocab rows {self.vocab_start}.."
                f"{self.vocab_start + self.vocab_size})")


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


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.mesh), None


def sum_squares(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of squares of ``x`` over its last dim and over the group
    (keepdim), f32: each rank's part of a norm over a dim split over
    ``"model"`` reads the whole.  All-reduced forward and backward: every
    rank's normalized part reads the sum, so its gradient is the sum of
    every rank's (an identity backward, as "g"'s, loses the others')."""
    part = torch.sum(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return _SumBoth.apply(part, tp.mesh)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return D.all_gather(x, "model", dim, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        return D.reduce_scatter(grad, "model", ctx.dim, mesh=ctx.mesh), None, None


def gather_from_model(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    leaf's contiguous cuts made whole); the gradient reduce-scattered
    back, so each rank's cut gets the sum of every rank's part."""
    return _GatherModel.apply(x, dim % x.ndim, tp.mesh)


class _ScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return D.reduce_scatter(x, "model", x.ndim - 1, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        return D.all_gather(grad, "model", grad.ndim - 1, mesh=ctx.mesh), None


def reduce_scatter_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the group of each rank's partial ``x``, cut along its
    last dim: this rank's part (a matmul whose contraction dim is split,
    its output channels then split as its input's); the gradient
    all-gathered."""
    return _ScatterModel.apply(x, tp.mesh)


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
