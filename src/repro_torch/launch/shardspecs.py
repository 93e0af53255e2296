"""Sharding trees for every (arch x shape x mesh) cell.

Port of ``src/repro/launch/shardspecs.py`` over the port's
:class:`repro_torch.parallel.sharding.NamedSharding` (a
``PartitionSpec`` on a :class:`repro_torch.parallel.mesh.Mesh`).

Policy:
  * params: Megatron TP over "model" (heads/ffn/experts/vocab); archs with
    ``fsdp_params`` additionally shard the embed dim over ("pod","data").
  * train batch: sharded over ("pod","data").
  * decode caches: kv-heads over "model" when divisible, else the cache
    sequence is context-parallel over "model"; long_500k (batch=1) shards
    the sequence over every mesh axis.
  * optimizer state: exactly like params.

The trees follow the port's state, not the reference's stacked runs: the
parameters (and AdamW's moments) are a dict by parameter name
(``transformer.model_axes``), the decode caches and an encoder-decoder's
cross KV a list with one entry a layer.  Each leaf's spec is the
reference's for the same tensor with the leading ``"layers"`` axis (a
run's stack, which maps to no mesh axis) left out.  :func:`sanitize_tree`
takes ``device="meta"`` tensors (``models.model.input_specs``, a model
built on ``"meta"``) where the reference takes abstract values; a model
(an ``nn.Module``) pairs with its dict of shardings by parameter name.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.model import TrainState
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import (
    LOGICAL_RULES,
    NamedSharding,
    PartitionSpec as P,
    named_shardings,
    use_mesh,
)

__all__ = [
    "cell_rules",
    "param_shardings",
    "train_state_shardings",
    "train_state_specs",
    "batch_shardings",
    "cache_shardings",
    "decode_arg_shardings",
    "sanitize_tree",
]


def _sanitize_spec(sharding: NamedSharding, aval, mesh: Mesh) -> NamedSharding:
    """Drop mesh axes whose product doesn't divide the tensor dim.

    E.g. kv_heads=8 over a 16-way "model" axis falls back to replication
    (Megatron's GQA convention when kv < TP degree)."""
    if not hasattr(aval, "shape"):
        return sharding
    new_axes = []
    for i, entry in enumerate(sharding.spec):
        if entry is None or i >= len(aval.shape):
            new_axes.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for a in axes:
            if aval.shape[i] % (prod * mesh.shape[a]) == 0:
                kept.append(a)
                prod *= mesh.shape[a]
        new_axes.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return NamedSharding(mesh, P(*new_axes))


def sanitize_tree(shardings, abstract, mesh: Mesh):
    """Apply :func:`_sanitize_spec` leaf-wise (``abstract`` holds a tensor
    where ``shardings`` holds a sharding)."""
    if isinstance(shardings, NamedSharding):
        return _sanitize_spec(shardings, abstract, mesh)
    if isinstance(abstract, nn.Module):
        abstract = dict(abstract.named_parameters())
    if hasattr(shardings, "_fields"):
        return type(shardings)(*(sanitize_tree(getattr(shardings, f),
                                               getattr(abstract, f), mesh)
                                 for f in shardings._fields))
    if isinstance(shardings, dict):
        return {k: sanitize_tree(s, abstract[k], mesh) for k, s in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        return type(shardings)(sanitize_tree(s, a, mesh)
                               for s, a in zip(shardings, abstract))
    return shardings


def _dp_size(mesh: Mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def cell_rules(cfg: ModelConfig, shape: Optional[ShapeConfig], mesh: Mesh):
    """Logical rule table adjusted for this cell."""
    rules = dict(LOGICAL_RULES)
    if shape is not None and shape.kind == "decode" and shape.global_batch < _dp_size(mesh):
        # batch too small to shard (long_500k): context-parallel everything.
        rules["batch"] = None
        rules["cp_seq"] = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return tuple(rules.items())


def _param_rules(cfg: ModelConfig, base_rules):
    rules = dict(base_rules)
    if cfg.fsdp_params:
        rules["embed"] = ("pod", "data")
    return tuple(rules.items())


def _spec_tree(axes_tree, mesh: Mesh, rules):
    with use_mesh(mesh, rules=rules):
        return named_shardings(axes_tree, mesh)


def param_shardings(cfg: ModelConfig, mesh: Mesh, shape=None):
    """A sharding per parameter name."""
    rules = _param_rules(cfg, cell_rules(cfg, shape, mesh))
    return _spec_tree(tfm.model_axes(cfg), mesh, rules)


def train_state_shardings(cfg: ModelConfig, mesh: Mesh, shape=None) -> TrainState:
    p = param_shardings(cfg, mesh, shape)
    repl = NamedSharding(mesh, P())
    return TrainState(step=repl, params=p, opt_state=AdamWState(m=p, v=p))


def train_state_specs(cfg: ModelConfig, mesh: Mesh, shape=None) -> TrainState:
    """:func:`train_state_shardings` sanitized against the state's shapes
    (a ``"meta"`` model and moments: nothing is allocated), as the
    trainer places a state before drawing it."""
    from repro_torch.optim.adamw import adamw_init

    model = tfm.Transformer(cfg, device="meta")
    abstract = TrainState(step=None, params=model,
                          opt_state=adamw_init(dict(model.named_parameters())))
    return sanitize_tree(train_state_shardings(cfg, mesh, shape), abstract, mesh)


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    b2 = NamedSharding(mesh, P(dp, None))
    b3 = NamedSharding(mesh, P(dp, None, None))
    repl = NamedSharding(mesh, P())
    out = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings" and not cfg.is_encoder_decoder:
            out["embeddings"] = b3
        else:
            out["tokens"] = b2
        if shape.kind == "train":
            out["labels"] = b2
        if cfg.is_encoder_decoder:
            out["enc_embeds"] = b3
        if cfg.mrope:
            out["mrope_positions"] = repl
    return out


def _cache_axes_for_kind(cfg: ModelConfig, kind: str, shape: ShapeConfig, mesh: Mesh):
    """One layer's decode-cache axes (the reference's, without its run's
    leading "layers" axis)."""
    model_n = mesh.shape.get("model", 1)
    kv_shardable = (
        cfg.num_kv_heads % model_n == 0 and cfg.num_kv_heads >= model_n
        and not cfg.use_mla
    )
    small_batch = shape.global_batch < _dp_size(mesh)
    if kind == "ssm":
        return SSMCache(state=("batch", "ssm_heads", None, None),
                        conv=("batch", None, "conv_dim"))
    if kind == "rglru":
        return RGLRUCache(state=("batch", "lru_width"),
                          conv=("batch", None, "lru_width"))
    if kind == "local_attn":
        return tfm.LocalKVCache(k=("batch", None, None, None),
                                v=("batch", None, None, None), pos=(None,))
    if kind.startswith("mla"):
        return MLACache(c_kv=("batch", "cp_seq", None),
                        k_rope=("batch", "cp_seq", None))
    if kv_shardable and not small_batch:
        axes = ("batch", None, "kv_heads", None)
    else:
        axes = ("batch", "cp_seq", None, None)
    return KVCache(k=axes, v=axes)


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """A sharding tree a layer, as ``transformer.init_caches`` lays the
    caches out."""
    rules = cell_rules(cfg, shape, mesh)
    axes = [_cache_axes_for_kind(cfg, kind, shape, mesh)
            for kind in cfg.layer_kinds()]
    return _spec_tree(axes, mesh, rules)


def decode_arg_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """Shardings for decode_step(params, tokens, caches, cur_index,
    rng[, cross_kv]); ``cross_kv`` one entry a layer (None where the
    layer is not a decoder layer)."""
    rules = cell_rules(cfg, shape, mesh)
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    small_batch = shape.global_batch < _dp_size(mesh)
    bspec = NamedSharding(mesh, P(None if small_batch else dp, None))
    repl = NamedSharding(mesh, P())
    args = {
        "params": param_shardings(cfg, mesh, shape),
        "tokens": bspec,
        "caches": cache_shardings(cfg, shape, mesh),
        "cur_index": repl,
        "rng": repl,
    }
    if cfg.is_encoder_decoder:
        ax = KVCache(k=("batch", None, "heads", None),
                     v=("batch", None, "heads", None))
        args["cross_kv"] = [_spec_tree(ax, mesh, rules) if kind == "dec" else None
                            for kind in cfg.layer_kinds()]
    return args
