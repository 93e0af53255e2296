"""Step functions of the serving path: prefill and decode with the paper's
approx top-k sampler.

Port of ``make_prefill_step``/``make_decode_step`` of
``src/repro/models/model.py``.  Sampling runs the paper's op over the
vocabulary: the padded vocabulary ids are pushed down by 1e9,
``approx_max_k`` keeps the top ``cfg.decode_sample_k`` logits (the MIPS
against the unembedding), then a Gumbel draw picks one.  The draw comes
from the caller's ``torch.Generator``; :func:`sample_tokens` takes the
noise itself, so a test can hand it the reference's
``jax.random.gumbel`` draw.  A batch's main input is ``"tokens"``, or
``"embeddings"`` for a stubbed modality frontend (qwen2-vl's patches);
an encoder-decoder's (whisper) also holds ``"enc_embeds"``, and its
prefill step returns the cross-attention KV its decode step takes.
Training (``loss_fn``, ``make_train_step``, ``TrainState``,
``input_specs``) is ROADMAP queue A item 13b.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk import approx_max_k
from repro_torch.models import transformer as tfm

__all__ = ["make_prefill_step", "make_decode_step", "gumbel", "sample_tokens"]


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(model, batch) -> (last logits (B, 1, V), caches), and
    for an encoder-decoder (logits, caches, cross_kv); ``batch["tokens"]``
    (B, S) or ``batch["embeddings"]`` (B, S, d), and ``batch["enc_embeds"]``
    (B, S_enc, d) for an encoder-decoder.  The encoder runs once."""

    @torch.no_grad()
    def prefill_step(model, batch):
        if cfg.is_encoder_decoder:
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
