"""Step functions: training, and prefill and decode with the paper's
approx top-k sampler; abstract input specs.

Port of ``src/repro/models/model.py``.  Training: :class:`TrainState`
holds the step (a CPU int32 scalar), the model (its parameters the f32
masters, requiring grad) and AdamW's f32 moments keyed by the model's
parameter names; :func:`make_train_step` updates the model and the
moments in place and returns the next state (the reference returns new
arrays).  Each step casts the masters to the compute dtype inside the
forward (``transformer._cast_params``; on a ZeRO-3 shard each shard just
before its gather).  :func:`input_specs` returns
``device="meta"`` tensors where the reference returns
``ShapeDtypeStruct`` stand-ins.

Sampling runs the paper's op over the
vocabulary: the padded vocabulary ids are pushed down by 1e9,
``approx_max_k`` keeps the top ``cfg.decode_sample_k`` logits (the MIPS
against the unembedding), then a Gumbel draw picks one.  The draw comes
from the caller's ``torch.Generator``; :func:`sample_tokens` takes the
noise itself, so a test can hand it the reference's
``jax.random.gumbel`` draw.  A batch's main input is ``"tokens"``, or
``"embeddings"`` for a stubbed modality frontend (qwen2-vl's patches);
an encoder-decoder's (whisper) also holds ``"enc_embeds"``, and its
prefill step returns the cross-attention KV its decode step takes.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.topk import approx_max_k
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.parallel import distributed as D
from repro_torch.parallel import tensor_parallel as TP

__all__ = [
    "loss_fn",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "input_specs",
    "init_train_state",
    "TrainState",
    "gumbel",
    "sample_tokens",
]


class TrainState(NamedTuple):
    step: torch.Tensor          # () int32, on the CPU
    params: tfm.Transformer     # f32 masters, requires_grad
    opt_state: AdamWState


def _model_inputs(cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    use_embeds = cfg.input_mode == "embeddings" and not cfg.is_encoder_decoder
    main = batch["embeddings"] if use_embeds else batch["tokens"]
    kwargs = {}
    if cfg.is_encoder_decoder:
        kwargs["enc_embeds"] = batch["enc_embeds"]
    if cfg.mrope and "mrope_positions" in batch:
        kwargs["mrope_positions"] = batch["mrope_positions"]
    return main, kwargs


def loss_fn(model: tfm.Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *,
            grad_dtype: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy (labels provided explicitly; a label < 0
    is masked), f32: the masked mean over the batch.

    A rank's shard under a process mesh (``model.layout``) takes its rows
    of the global batch: the numerator is its own, the count of labels
    is summed over ``("pod", "data")``, and the quotient is summed over
    them with its gradient passed through, so every rank returns the
    global mean and its backward yields its share of the gradient.
    Under tensor parallelism (``model.tp``) the cross entropy runs over
    the vocabulary's parts (``parallel.tensor_parallel``).  On a ZeRO-3
    shard the backward reduce-scatters each gathered parameter's
    gradient into its shard, in bf16 under ``grad_dtype="bfloat16"``
    (``transformer.forward_train``)."""
    main, kwargs = _model_inputs(cfg, batch)
    logits = tfm.forward_train(model, main, grad_dtype=grad_dtype,
                               **kwargs).to(torch.float32)
    labels = batch["labels"].long()
    mask = (labels >= 0).to(torch.float32)
    if model.tp is not None:
        nll = TP.vocab_parallel_cross_entropy(logits, labels, model.tp)
        num = (nll * mask).sum()
    else:
        if cfg.padded_vocab != cfg.vocab_size:
            pad_mask = (torch.arange(cfg.padded_vocab, device=logits.device)
                        >= cfg.vocab_size)
            logits = logits - 1e9 * pad_mask
        logp = torch.log_softmax(logits, dim=-1)
        take = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        num = -(take * mask).sum()
    layout = model.layout
    if layout is None or layout.data_size == 1:
        return num / torch.clamp(mask.sum(), min=1.0)
    dp = ("pod", "data")
    count = D.all_reduce(mask.sum().detach(), dp, mesh=layout.mesh)
    return D.sum_forward(num / torch.clamp(count, min=1.0), dp, layout.mesh)


def _split(batch: Dict[str, torch.Tensor], microbatches: int):
    """The batch's microbatches: every array whose leading dim is the
    batch's split on it, the rest (M-RoPE streams) shared."""
    bsz = batch["labels"].shape[0]
    if bsz % microbatches:
        raise ValueError(f"batch {bsz} not divisible by microbatches {microbatches}")
    split = {k for k, v in batch.items() if v.ndim >= 1 and v.shape[0] == bsz}
    static = {k: v for k, v in batch.items() if k not in split}
    parts = {k: batch[k].chunk(microbatches) for k in split}
    return [{**static, **{k: parts[k][i] for k in split}}
            for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, *, learning_rate=3e-4,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    grad_dtype: Optional[str] = None, microbatches: int = 1):
    """Build train_step(state, batch) -> (state, metrics).

    The batch is a dict of tensors on the model's device (as
    :func:`input_specs` lays it out).  ``grad_dtype="bfloat16"`` rounds
    the gradients to bf16 and back (the compressed reduction);
    ``microbatches > 1`` splits the batch on dim 0 and accumulates each
    part's gradients in f32 (the masters' ``.grad``), the loss and the
    gradients averaged, so the activations held drop by the factor.  The
    gradients are clipped to a global norm of ``grad_clip``;
    ``learning_rate`` is a float or callable(step).  ``metrics`` holds
    ``loss``, ``grad_norm`` (before clipping; device tensors) and
    ``step``.

    A rank's shard under a process mesh (``model.layout``, placed by
    ``parallel.sharding.place``) steps on its rows of the global batch
    (``parallel.distributed.local_batch``): the gradients are summed over
    ``"model"`` where a whole leaf holds one rank's part and over
    ``("pod", "data")`` (in buckets; in bf16 with ``grad_dtype``), the
    norm counts each shard once, and AdamW updates the shards.  On a
    ZeRO-3 shard (the ``fsdp_params`` archs' embed dim cut over the data
    axis, ``parallel.zero3``) each microbatch's backward reduce-scatters
    the gathered parameters' gradients into their shards' ``.grad``,
    which accumulate there; those leaves skip the data all-reduce.
    """

    def train_step(state: TrainState, batch):
        model = state.params
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        for _, p in named:
            p.grad = None
        parts = [batch] if microbatches <= 1 else _split(batch, microbatches)
        loss = None
        for part in parts:
            part_loss = loss_fn(model, cfg, part, grad_dtype=grad_dtype)
            part_loss.backward()
            part_loss = part_loss.detach()
            loss = part_loss if loss is None else loss + part_loss
        grads = []
        for _, p in named:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
            grads.append(g)
        if microbatches > 1:
            inv = 1.0 / microbatches
            loss = loss * inv
            torch._foreach_mul_(grads, inv)
        layout = model.layout
        if layout is not None:
            names = [n for n, _ in named]
            grads = layout.reduce_gradients(names, grads, grad_dtype)
            gnorm = layout.grad_norm(names, grads)
        else:
            if grad_dtype == "bfloat16":
                grads = [g.to(torch.bfloat16).to(torch.float32) for g in grads]
            grads = [g.to(torch.float32) for g in grads]
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        torch._foreach_mul_(grads, scale)
        adamw_update(
            {n: p for n, p in named}, {n: g for (n, _), g in zip(named, grads)},
            state.opt_state, step=state.step, learning_rate=learning_rate,
            weight_decay=weight_decay,
        )
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        return TrainState(step=state.step + 1, params=model,
                          opt_state=state.opt_state), metrics

    return train_step


def init_train_state(generator: torch.Generator, cfg: ModelConfig, *,
                     device=None, shardings=None) -> TrainState:
    """Step 0, a model of f32 master parameters drawn from ``generator``
    (a generator of ``device``, default "cuda"), requiring grad, and
    AdamW's zero moments.

    ``shardings`` (a sanitized ``TrainState`` of shardings on a process
    mesh, ``launch.shardspecs.train_state_specs``) draws the calling
    rank's shard of the state instead, by shards
    (``transformer.init_shard``: each leaf whole in turn on the rank's
    device, the rank's shard kept; the moments zeros of the shards'
    shapes), so a rank never holds the whole state: the values of
    ``parallel.sharding.place(init_train_state(...), shardings)``.
    ``generator`` is then a generator of the rank's device, where the
    state lies."""
    if shardings is not None:
        model = tfm.init_shard(cfg, generator, shardings.params)
    else:
        model = tfm.init_model(cfg, generator, device=device)
    model.requires_grad_(True)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=model,
                      opt_state=adamw_init(dict(model.named_parameters())))


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(model, batch) -> (last logits (B, 1, V), caches), and
    for an encoder-decoder (logits, caches, cross_kv); ``batch["tokens"]``
    (B, S) or ``batch["embeddings"]`` (B, S, d), and ``batch["enc_embeds"]``
    (B, S_enc, d) for an encoder-decoder.  The encoder runs once."""

    @torch.no_grad()
    def prefill_step(model, batch):
        if cfg.is_encoder_decoder:
            tfm._refuse_shard(model, "prefill")
            params = tfm._cast_params(model.params(), cfg)
            enc_out = tfm._encode(params, cfg, batch["enc_embeds"])
            logits, caches = tfm._prefill(params, cfg, batch["tokens"], enc_out=enc_out)
            return logits, caches, tfm.build_cross_kv(params, cfg, enc_out)
        main = batch["embeddings"] if cfg.input_mode == "embeddings" else batch["tokens"]
        return tfm.forward_prefill(model, main)

    return prefill_step


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` over u uniform in
    [tiny, 1) (``jax.random.gumbel``'s form)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(cfg: ModelConfig, logits: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, *,
                  sample: str = "approx_topk",
                  temperature: float = 0.8) -> torch.Tensor:
    """Next tokens (B, 1) from logits (B, S, V): the last position, padded
    ids masked, then greedy argmax or ``approx_max_k`` + the Gumbel
    ``noise`` (B, decode_sample_k) over the candidates."""
    logits = logits[:, -1].to(torch.float32)  # (B, V)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits - 1e9 * pad_mask
    if sample == "greedy":
        return torch.argmax(logits, dim=-1)[:, None]
    vals, idxs = approx_max_k(logits, cfg.decode_sample_k,
                              recall_target=cfg.knn_recall_target)
    choice = torch.argmax(vals / temperature + noise, dim=-1)
    return torch.gather(idxs, -1, choice[:, None])


def make_decode_step(cfg: ModelConfig, *, use_knn: bool = False,
                     sample: str = "approx_topk", temperature: float = 0.8):
    """decode_step(model, tokens, caches, cur_index, generator, noise=None,
    cross_kv=None) -> (next tokens (B, 1) int32, logits (B, 1, V),
    caches).  The Gumbel ``noise`` (B, decode_sample_k) is drawn from
    ``generator`` unless given (a CUDA graph of the step reads it from a
    buffer); ``cross_kv`` is an encoder-decoder's, from the prefill
    step."""

    def decode_step(model, tokens, caches, cur_index, generator, noise=None,
                    cross_kv=None):
        logits, caches = tfm.forward_decode(model, tokens, caches, cur_index,
                                            use_knn=use_knn, cross_kv=cross_kv)
        if sample != "greedy" and noise is None:
            noise = gumbel((tokens.shape[0], cfg.decode_sample_k), generator,
                           device=logits.device)
        next_tokens = sample_tokens(cfg, logits, noise, sample=sample,
                                    temperature=temperature)
        return next_tokens.to(torch.int32), logits, caches

    return decode_step


# --------------------------------------------------------------------------
# Abstract input specs (tensors on the "meta" device, no allocation)
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract inputs for one (arch x shape) cell, as ``device="meta"``
    tensors.

    train/prefill: token (or stub-embedding) batch + labels.
    decode: single token + fully-populated caches (one a layer) +
    cur_index + rng (the reference's two-word key; the port's step takes
    a ``torch.Generator``) and an encoder-decoder's cross KV, one a layer.
    """
    b, s = shape.global_batch, shape.seq_len
    f = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"labels": _meta((b, s), torch.int32)}
        if cfg.input_mode == "embeddings" and not cfg.is_encoder_decoder:
            batch["embeddings"] = _meta((b, s, cfg.d_model), f)
        else:
            batch["tokens"] = _meta((b, s), torch.int32)
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = _meta((b, cfg.encoder_seq, cfg.d_model), f)
        if cfg.mrope:
            batch["mrope_positions"] = _meta((3, s), torch.int32)
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    spec = {
        "tokens": _meta((b, 1), torch.int32),
        "caches": tfm.init_caches(cfg, b, s, device="meta"),
        "cur_index": _meta((), torch.int32),
        "rng": _meta((2,), torch.uint32),
    }
    if cfg.is_encoder_decoder:
        from repro_torch.models.attention import KVCache

        hd = cfg.resolved_head_dim
        kv = (b, cfg.encoder_seq, cfg.num_heads, hd)
        spec["cross_kv"] = [
            KVCache(k=_meta(kv, f), v=_meta(kv, f)) if kind == "dec" else None
            for kind in cfg.layer_kinds()
        ]
    return spec
