"""Model assembly for the dense layer kind: defs, init, prefill and decode.

Port of the ``"dense"`` parts of ``src/repro/models/transformer.py``: a
layer is GQA attention + the (gated) MLP, each behind an RMSNorm.  The
reference scans each run of identical layers with ``lax.scan`` over
stacked params; the port holds one :class:`ParamTree` a layer in an
``nn.ModuleList`` (``layers.{i}.attn.wq``, ...) and one KV cache a
layer, and loops.  Every forward casts f32 parameters to the compute
dtype first (``_cast_params``), as the reference does; a model built in
the compute dtype (``init_model(..., dtype=torch.bfloat16)``) skips the
cast.

The other layer kinds (``moe``, ``mla_*``, ``ssm``, ``rglru``,
``local_attn``, ``dec``), ``input_mode="embeddings"`` and whisper's
sinusoidal positions are ROADMAP queue A item 12b and raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_defs, rms_norm
from repro_torch.models.params import ParamDef, ParamTree, init_params

__all__ = [
    "runs_of",
    "layer_defs",
    "model_defs",
    "Transformer",
    "resolve_device",
    "init_model",
    "init_layer_cache",
    "init_caches",
    "layer_train",
    "layer_decode",
    "forward_prefill",
    "forward_decode",
]


def runs_of(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Group consecutive identical layer kinds: [(kind, count), ...]."""
    runs: List[Tuple[str, int]] = []
    for kind in cfg.layer_kinds():
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def _check_kind(kind: str) -> None:
    if kind != "dense":
        raise NotImplementedError(
            f"layer kind {kind!r} is ROADMAP queue A item 12b of the port "
            "(only the dense kind is ported)"
        )


def _norm_def(cfg: ModelConfig):
    return ParamDef((cfg.d_model,), ("embed",), "ones")


def layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    _check_kind(kind)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "pre_norm": _norm_def(cfg),
        "attn": attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads, hd),
        "mlp_norm": _norm_def(cfg),
        "mlp": mlp_defs(d, cfg.d_ff, gated=cfg.gated_mlp),
    }


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    # vocab padded to a 128 multiple, as the reference's (TP-shardable)
    defs: Dict[str, Any] = {
        "embed": {"embedding": ParamDef((cfg.padded_vocab, cfg.d_model),
                                        ("vocab", "embed"), 1.0)},
        "final_norm": _norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = {
            "embedding": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"))
        }
    return defs


def _check_config(cfg: ModelConfig) -> None:
    for kind, _ in runs_of(cfg):
        _check_kind(kind)
    if cfg.input_mode != "tokens" or cfg.rope_theta == 0:
        raise NotImplementedError(
            f"input_mode={cfg.input_mode!r} (a stubbed modality frontend) and "
            "absolute sinusoidal positions (rope_theta=0) are ROADMAP queue A "
            "item 12b of the port"
        )


def resolve_device(device=None) -> torch.device:
    """``device``, default "cuda", which must exist ("cpu" runs the
    plain path)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the model runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


class Transformer(ParamTree):
    """A dense decoder's parameters under the reference's names:
    ``embed.embedding``, ``final_norm``, ``lm_head.embedding`` and
    ``layers.{i}.{pre_norm, attn.{wq,wk,wv,wo}, mlp_norm, mlp.{wi,wo,wg}}``
    (``load_state_dict(params.from_reference(...))`` loads the
    reference's), allocated uninitialized on ``device`` (default "cuda",
    which must exist; pass "cpu" for the CPU) in ``dtype``."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        _check_config(cfg)
        device = resolve_device(device)
        super().__init__(model_defs(cfg), device=device, dtype=dtype)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            ParamTree(layer_defs(cfg, kind), device=device, dtype=dtype)
            for kind in cfg.layer_kinds()
        )

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def params(self) -> Dict[str, Any]:
        """The parameter tree the forwards read: the reference's dict
        layout, ``layers`` a list of per-layer dicts."""
        tree = self.tree()
        tree["layers"] = [layer.tree() for layer in self.layers]
        return tree


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None,
               dtype=torch.float32) -> Transformer:
    """A :class:`Transformer` with the port's random parameters, drawn
    from ``generator`` (a generator of the model's device) as the
    reference's ``ParamDef`` scales say.  ``dtype=torch.bfloat16`` builds
    the model in the bf16 compute dtype directly (what ``_cast_params``
    would make of f32 master weights)."""
    model = Transformer(cfg, device=device, dtype=dtype)
    init_params(model, generator)
    for layer in model.layers:
        init_params(layer, generator)
    return model


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device=None) -> attn.KVCache:
    _check_kind(kind)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = _compute_dtype(cfg)
    return attn.KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                        v=torch.zeros(shape, dtype=dt, device=device))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device=None) -> List[attn.KVCache]:
    """One decode cache a layer (the reference stacks them per run)."""
    return [init_layer_cache(cfg, kind, batch, max_seq, device)
            for kind in cfg.layer_kinds()]


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def layer_train(params, x, positions, cfg: ModelConfig, kind: str = "dense",
                return_cache: bool = False):
    """One layer over the full sequence (prefill; forward only)."""
    _check_kind(kind)
    h = rms_norm(x, params["pre_norm"], cfg.norm_eps)
    out = attn.attention_train(
        params["attn"], h, positions,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        rope_theta=cfg.rope_theta, mrope=cfg.mrope, q_chunk=cfg.q_chunk,
        return_cache=return_cache, scores_dtype=cfg.attn_scores_dtype,
    )
    cache = None
    if return_cache:
        out, cache = out
    x = x + out
    h = rms_norm(x, params["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(params["mlp"], h, act=cfg.act), cache


def layer_decode(params, x, cache, cur_index, cfg: ModelConfig,
                 kind: str = "dense", use_knn: bool = False):
    _check_kind(kind)
    h = rms_norm(x, params["pre_norm"], cfg.norm_eps)
    y, cache = attn.attention_decode(
        params["attn"], h, cache, cur_index,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        rope_theta=cfg.rope_theta, mrope=cfg.mrope,
        knn_k=cfg.knn_attention_k if use_knn else 0,
        knn_recall_target=cfg.knn_recall_target,
    )
    x = x + y
    h = rms_norm(x, params["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(params["mlp"], h, act=cfg.act), cache


# --------------------------------------------------------------------------
# Forwards
# --------------------------------------------------------------------------


def _cast_params(params, cfg: ModelConfig):
    """Cast master (f32) params to the compute dtype (norms upcast internally)."""
    dt = _compute_dtype(cfg)
    if isinstance(params, dict):
        return {k: _cast_params(v, cfg) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_params(v, cfg) for v in params]
    return params.to(dt) if params.dtype == torch.float32 else params


def _embed_in(params, cfg: ModelConfig, tokens: torch.Tensor):
    return params["embed"]["embedding"][tokens.long()].to(_compute_dtype(cfg))


def _unembed(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = (params["embed"]["embedding"] if cfg.tie_embeddings
             else params["lm_head"]["embedding"])
    return x @ table.to(x.dtype).T


@torch.no_grad()
def forward_prefill(model: Transformer, tokens: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None):
    """Prefill: full forward -> (last position's logits (B, 1, V), one
    KV cache a layer of the prompt's length)."""
    cfg = model.cfg
    params = _cast_params(model.params(), cfg)
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = _embed_in(params, cfg, tokens)
    caches = []
    for layer_params in params["layers"]:
        h, cache = layer_train(layer_params, x, positions, cfg, return_cache=True)
        x = h.to(x.dtype)
        caches.append(cache)
    return _unembed(params, cfg, x[:, -1:]), caches


@torch.no_grad()
def forward_decode(model: Transformer, tokens: torch.Tensor, caches,
                   cur_index, *, use_knn: bool = False):
    """Single-token decode step: tokens (B, 1) -> (logits (B, 1, V),
    caches, each written at ``cur_index`` in place).  ``cur_index`` is an
    int or a one-element device tensor (a CUDA graph of the step reads
    it)."""
    cfg = model.cfg
    params = _cast_params(model.params(), cfg)
    x = _embed_in(params, cfg, tokens)
    new_caches = []
    for layer_params, cache in zip(params["layers"], caches):
        h, cache = layer_decode(layer_params, x, cache, cur_index, cfg,
                                use_knn=use_knn)
        x = h.to(x.dtype)
        new_caches.append(cache)
    return _unembed(params, cfg, x), new_caches
