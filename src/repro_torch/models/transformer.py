"""Model assembly: per-layer defs and forwards for every layer kind, init,
caches, and the full-sequence, prefill and decode forwards.

Port of ``src/repro/models/transformer.py``.  Layer kinds:
  dense      GQA attention + gated MLP
  moe        GQA attention + MoE FFN (+ shared experts)
  mla_dense  MLA attention + gated MLP        (deepseek-v2)
  mla_moe    MLA attention + MoE FFN
  local_attn GQA attention with sliding window + MLP   (recurrentgemma)
  rglru      RG-LRU recurrent block + MLP
  ssm        Mamba-2 SSD block (no separate MLP)
  enc        bidirectional attention + MLP    (whisper encoder)
  dec        causal self-attn + cross-attn + MLP (whisper decoder)

The reference scans each run of identical layers with ``lax.scan`` over
stacked params; the port holds one :class:`ParamTree` a layer in an
``nn.ModuleList`` (``layers.{i}.attn.wq``, ..., and whisper's
``encoder.{i}.…``) and one decode cache a layer, and loops.  Every
forward casts f32 parameters to the compute dtype first
(``_cast_params``), as the reference does; a model built in the compute
dtype (``init_model(..., dtype=torch.bfloat16)``) skips the cast.

:func:`forward_train` records autograd wherever the parameters require
grad (the training step's f32 masters) and honours ``cfg.remat`` per
layer, as the reference's ``_maybe_remat``: ``"none"`` keeps every
activation, ``"full"`` recomputes the layer in the backward
(``torch.utils.checkpoint``), ``"dots"`` saves the outputs of the
matmuls without batch dims (``aten.mm``/``aten.addmm``, the counterpart
of ``dots_with_no_batch_dims_saveable``) and recomputes the rest.  The
prefill and decode forwards run without autograd.  On a ZeRO-3 shard
(``parallel.zero3``) each layer gathers its parameters inside the
function remat wraps, and the tables are gathered where they are read.

Decode writes every cache in place: the KV rows and MLA latent rows at
the position, the ring slot ``position % window`` of a local-attention
cache, the SSM and RG-LRU state and conv window.  The engine captures
one CUDA graph of the decode step and keeps no cache the step returns,
so a cache rebound instead of written would go stale from the second
replay on.  The position may be a device tensor (the graph's input):
nothing in the step reads it on the host.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import mlp_apply, mlp_defs, rms_norm
from repro_torch.models.params import ParamDef, ParamTree, init_params, param_axes
from repro_torch.parallel import distributed as D
from repro_torch.parallel import tensor_parallel as TP
from repro_torch.parallel import zero3 as Z

__all__ = [
    "runs_of",
    "layer_defs",
    "model_defs",
    "model_axes",
    "Transformer",
    "resolve_device",
    "init_model",
    "init_shard",
    "reshard_model",
    "init_layer_cache",
    "init_caches",
    "layer_train",
    "layer_decode",
    "forward_train",
    "forward_prefill",
    "forward_decode",
    "build_cross_kv",
    "LocalKVCache",
]


class LocalKVCache(NamedTuple):
    """Ring-buffer KV cache for sliding-window attention."""

    k: torch.Tensor      # (B, W, KV, hd)
    v: torch.Tensor      # (B, W, KV, hd)
    pos: torch.Tensor    # (W,) absolute position stored in each slot (-1 empty)


def runs_of(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Group consecutive identical layer kinds: [(kind, count), ...]."""
    runs: List[Tuple[str, int]] = []
    for kind in cfg.layer_kinds():
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def _norm_def(cfg: ModelConfig):
    return ParamDef((cfg.d_model,), ("embed",), "ones")


def layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == "ssm":
        return {
            "pre_norm": _norm_def(cfg),
            "ssm": ssm_lib.ssm_defs(d, expand=cfg.ssm_expand,
                                    head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state),
        }
    if kind == "rglru":
        return {
            "pre_norm": _norm_def(cfg),
            "rglru": rglru_lib.rglru_defs(d, cfg.lru_width or d,
                                          gate_blocks=cfg.lru_gate_blocks),
            "mlp_norm": _norm_def(cfg),
            "mlp": mlp_defs(d, cfg.d_ff, gated=cfg.gated_mlp),
        }
    defs: Dict[str, Any] = {"pre_norm": _norm_def(cfg)}
    if kind.startswith("mla"):
        defs["attn"] = attn.mla_defs(
            d, cfg.num_heads,
            q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
            v_head_dim=cfg.v_head_dim,
        )
    else:
        defs["attn"] = attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads, hd)
    if kind == "dec":
        defs["cross_norm"] = _norm_def(cfg)
        defs["cross"] = attn.cross_attn_defs(d, cfg.num_heads, hd)
    defs["mlp_norm"] = _norm_def(cfg)
    if kind.endswith("moe"):
        defs["moe"] = moe_lib.moe_defs(d, cfg.moe_d_ff, cfg.num_experts,
                                       num_shared_experts=cfg.num_shared_experts)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff, gated=cfg.gated_mlp)
    return defs


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
    if cfg.is_encoder_decoder:
        defs["enc_final_norm"] = _norm_def(cfg)
    return defs


def _flat_axes(tree, prefix: str, out: Dict[str, Tuple]) -> None:
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _flat_axes(sub, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = sub


def model_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Each parameter's logical axes by its name in the model's state dict
    (``layers.{i}.attn.wq``, ...).  The reference's ``model_axes`` nests
    the same axes with each run stacked (a leading ``"layers"`` axis,
    which maps to no mesh axis)."""
    out: Dict[str, Tuple] = {}
    _flat_axes(param_axes(model_defs(cfg)), "", out)
    for i, kind in enumerate(cfg.layer_kinds()):
        _flat_axes(param_axes(layer_defs(cfg, kind)), f"layers.{i}.", out)
    for i in range(cfg.encoder_layers if cfg.is_encoder_decoder else 0):
        _flat_axes(param_axes(layer_defs(cfg, "enc")), f"encoder.{i}.", out)
    return out


def _local_defs(defs: Dict[str, Any], prefix: str,
                shapes: Optional[Dict[str, Tuple[int, ...]]]) -> Dict[str, Any]:
    """``defs`` with each parameter named in ``shapes`` (by its full name,
    ``prefix`` + its key) given that shape: a rank's shard."""
    if not shapes:
        return defs
    out = {}
    for name, d in defs.items():
        if isinstance(d, ParamDef):
            shape = shapes.get(prefix + name, d.shape)
            out[name] = d if shape == d.shape else ParamDef(shape, d.axes, d.init)
        else:
            out[name] = _local_defs(d, f"{prefix}{name}.", shapes)
    return out


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
    """A model's parameters under the reference's names:
    ``embed.embedding``, ``final_norm``, ``lm_head.embedding``,
    ``layers.{i}.…`` as ``layer_defs`` names them for the layer's kind
    (``pre_norm``, ``attn.wq``, ``moe.router``, ``ssm.in_proj``, ...), and
    for an encoder-decoder ``enc_final_norm`` and ``encoder.{i}.…``
    (``load_state_dict(params.from_reference(...))`` loads the
    reference's), allocated uninitialized on ``device`` (default "cuda",
    which must exist; pass "cpu" for the CPU) in ``dtype``.

    ``shapes`` (parameter name -> shape) allocates those parameters at a
    shard's shape: a rank's part of the model under a process mesh
    (:meth:`shard`, :func:`init_shard`), which then sets ``layout`` (a
    ``parallel.distributed.ShardLayout``: the mesh, each parameter's
    spec, the names each axis cuts) and, where the ``"model"`` axis
    splits it, ``tp`` (a ``parallel.tensor_parallel.TensorParallel``);
    both are None for a whole model."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32,
                 shapes: Optional[Dict[str, Tuple[int, ...]]] = None):
        device = resolve_device(device)
        super().__init__(_local_defs(model_defs(cfg), "", shapes), device=device,
                         dtype=dtype)
        self.cfg = cfg
        self.layout = None
        self.tp = None
        self.layers = nn.ModuleList(
            ParamTree(_local_defs(layer_defs(cfg, kind), f"layers.{i}.", shapes),
                      device=device, dtype=dtype)
            for i, kind in enumerate(cfg.layer_kinds())
        )
        self.encoder = nn.ModuleList(
            ParamTree(_local_defs(layer_defs(cfg, "enc"), f"encoder.{i}.", shapes),
                      device=device, dtype=dtype)
            for i in range(cfg.encoder_layers if cfg.is_encoder_decoder else 0)
        )

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def params(self) -> Dict[str, Any]:
        """The parameter tree the forwards read: the reference's dict
        layout, ``layers`` (and ``encoder``) a list of per-layer dicts."""
        tree = self.tree()
        tree["layers"] = [layer.tree() for layer in self.layers]
        if self.cfg.is_encoder_decoder:
            tree["encoder"] = [layer.tree() for layer in self.encoder]
        return tree

    @torch.no_grad()
    def shard(self, shardings: Dict) -> "Transformer":
        """The calling rank's part of this model under ``shardings`` (a
        sanitized ``parallel.sharding.NamedSharding`` a parameter name, on
        a ``parallel.distributed.ProcessMesh``), on the rank's device,
        with its ``layout`` set (and ``tp`` where ``"model"`` cuts it).
        A whole model is cut; a shard on another process mesh of the same
        ranks is re-placed (:func:`reshard_model`).  Raises where the port
        has no path for the layout (:func:`_shard_plan`)."""
        mesh = next(iter(shardings.values())).mesh
        if self.layout is not None:
            if self.layout.mesh is mesh:
                return self
            return reshard_model(self, shardings)[0]
        params = dict(self.named_parameters())
        cut, layout, tp = _shard_plan(
            self.cfg, shardings, {n: tuple(p.shape) for n, p in params.items()})
        grad = any(p.requires_grad for p in params.values())
        if cut:
            local = Transformer(self.cfg, device=mesh.device,
                                dtype=next(iter(params.values())).dtype,
                                shapes=cut)
            for name, p in local.named_parameters():
                p.copy_(D.local_shard(params[name], layout.specs[name], mesh))
        else:
            local = self.to(mesh.device)
        local.requires_grad_(grad)
        local.layout = layout
        local.tp = tp
        return local


@torch.no_grad()
def reshard_model(model: Transformer, shardings: Dict, moments=()):
    """``model`` (a rank's shard on one process mesh) re-placed onto the
    process mesh of ``shardings`` (sanitized, over the same ranks; every
    rank calls this): a new local model with ``_shard_plan``'s cut,
    ``layout`` and ``tp`` for the new mesh; a name at a time, the
    parameter and its entry in each of ``moments`` (dicts of tensors
    keyed and cut as the parameters, such as AdamW's ``m`` and ``v``)
    gathered whole over the old cut, cut for the new mesh and freed
    before the next (``parallel.distributed.reshard``).  Returns ``(local, [moments
    re-placed])``.  Nothing of the result holds the old mesh (its groups
    stay alive for other meshes' use)."""
    old = model.layout
    mesh = next(iter(shardings.values())).mesh
    if old is None or not D.is_process_mesh(mesh):
        raise ValueError("reshard_model re-places a shard onto a process mesh")
    whole = {n: tuple(p.shape)
             for n, p in Transformer(model.cfg, device="meta").named_parameters()}
    cut, layout, tp = _shard_plan(model.cfg, shardings, whole)
    params = dict(model.named_parameters())
    local = Transformer(model.cfg, device=mesh.device,
                        dtype=next(iter(params.values())).dtype, shapes=cut)
    out = [{} for _ in moments]
    for name, p in local.named_parameters():
        def move(t):
            return D.reshard(t, old.specs[name], old.mesh, layout.specs[name], mesh)

        p.copy_(move(params[name]))
        for tree, new in zip(moments, out):
            new[name] = move(tree[name])
    local.requires_grad_(any(p.requires_grad for p in params.values()))
    local.layout, local.tp = layout, tp
    return local, out


def _shard_plan(cfg: ModelConfig, shardings: Dict, shapes: Dict[str, Tuple[int, ...]]):
    """How a rank holds a model of ``cfg`` (whole parameter ``shapes`` by
    name) under ``shardings`` (sanitized, on a process mesh):
    ``(cut, layout, tp)`` — the local shape of each parameter an axis
    cuts, the ``parallel.distributed.ShardLayout`` and the
    ``TensorParallel`` (None without a ``"model"`` axis > 1).  The data
    axis may cut any family (ZeRO-3, ``parallel.zero3``) and the
    ``"model"`` axis any layer kind (``TP.TP_KINDS``); a ``"pod"`` axis
    > 1 raises (ROADMAP item 14b.4).

    Under tensor parallelism each block (``layers.{i}.attn``, ``.mlp``,
    ... of ``TP.SPLIT_BLOCKS``) is split or whole over ``"model"``: every
    dim whose logical axis maps to it (heads, d_ff, experts, SSD heads
    and ``conv_dim``, ``lru_width``) cut, or none.  A whole block (the
    sanitized spec keeps its heads or experts whole where the axis does
    not divide them) runs at full size on every rank
    (``TensorParallel.block``); a block that is cut in part raises,
    naming the leaf.  In a split block only kv heads may stay whole
    (Megatron's GQA convention); in a whole one they are whole too.  The
    vocabulary must be cut.  Every leaf keeps the spec's contiguous cut:
    the SSD's ``in_proj`` and conv, whose cut does not follow the heads,
    are gathered where they are read (``models.ssm``).  A leaf of a
    split block that ``"model"`` leaves whole is ``partial``: the kv
    heads where they are whole, MLA's latent projections and norms, the
    MoE router."""
    from repro_torch.launch import shardspecs as SS

    mesh = next(iter(shardings.values())).mesh
    specs = {name: s.spec for name, s in shardings.items()}
    local = {n: D.local_shape(shape, specs[n], mesh) for n, shape in shapes.items()}
    mp = mesh.shape.get("model", 1)
    tp, split, partial = None, (), ()
    if mp > 1:
        blocks = _model_blocks(cfg, mesh, specs, shapes, SS.param_shardings(cfg, mesh))
        whole = {b.split(".")[2] for b, s in blocks.items() if not s}
        for name in {b.split(".")[2] for b, s in blocks.items() if s} & whole:
            raise ValueError(f"{cfg.name}: the {name} blocks are split over "
                             f"'model' in some layers and whole in others")
        split = [n for n, s in specs.items() if "model" in D.spec_axes(s)]
        partial = [n for n in specs if n not in split and blocks.get(_block_of(n))]
        wk = [n for n in shapes if n.endswith(".attn.wk")]
        tp = TP.TensorParallel(mesh, cfg, kv_sharded=set(wk) <= set(split),
                               whole=whole)
    data_dims = {n: dim for n in shapes
                 if (dim := D.data_dim(specs[n], len(shapes[n]), mesh)) is not None}
    layout = D.ShardLayout(mesh, specs, split, partial, data_dims)
    cut = {n: local[n] for n in shapes if local[n] != tuple(shapes[n])}
    return cut, layout, tp


def _block_of(name: str) -> Optional[str]:
    """The block a parameter belongs to (``layers.3.attn``), or None
    outside the layers' blocks."""
    parts = name.split(".")
    if parts[0] in ("layers", "encoder") and parts[2] in TP.SPLIT_BLOCKS:
        return ".".join(parts[:3])
    return None


def _model_blocks(cfg: ModelConfig, mesh, specs, shapes, logical) -> Dict[str, bool]:
    """Each block's cut over ``"model"`` under the sanitized ``specs``:
    True where split, False where whole (see :func:`_shard_plan`).
    Raises for a block cut in part, naming the leaf, and for a leaf
    outside the blocks (the vocabulary) that the axis leaves whole."""
    axes = model_axes(cfg)
    mp = mesh.shape["model"]
    states: Dict[str, Dict[str, str]] = {}
    for name in shapes:
        dims = [(dim, ax) for dim, (ax, entry) in
                enumerate(zip(axes[name], logical[name].spec))
                if "model" in D.spec_axes((entry,))]
        cut = {tuple(specs[name])[dim] == "model" for dim, ax in dims
               if ax != "kv_heads"}
        block = _block_of(name)
        if block is None:
            if False in cut:
                dim, ax = next((d, a) for d, a in dims
                               if tuple(specs[name])[d] != "model")
                raise ValueError(
                    f"{cfg.name}: {name} is not split over a 'model' axis of "
                    f"{mp} (spec {tuple(specs[name])}); tensor parallelism "
                    f"needs its {ax} ({shapes[name][dim]}) divisible by {mp}")
            continue
        kv = [tuple(specs[name])[dim] == "model" for dim, ax in dims
              if ax == "kv_heads"]
        state = ("part" if len(cut) > 1 else "split" if True in cut
                 else "whole" if cut else "kv cut" if any(kv) else None)
        if state is not None:
            states.setdefault(block, {})[name] = state
    out = {}
    for block, leaves in states.items():
        split = [n for n, s in leaves.items() if s == "split"]
        bad = [n for n, s in leaves.items()
               if s == "part" or (split and s == "whole")
               or (not split and s == "kv cut")]
        if bad:
            other = f" while {split[0]} is split" if split else ""
            raise ValueError(
                f"{cfg.name}: {bad[0]} (spec {tuple(specs[bad[0]])}) is cut "
                f"over 'model' otherwise than the rest of {block}{other}: a "
                f"block is split over a 'model' axis of {mp} or runs whole on "
                f"every rank")
        out[block] = bool(split)
    return out


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None,
               dtype=torch.float32) -> Transformer:
    """A :class:`Transformer` with the port's random parameters, drawn
    from ``generator`` (a generator of the model's device) as the
    reference's ``ParamDef`` scales say.  ``dtype=torch.bfloat16`` builds
    the model in the bf16 compute dtype directly (what ``_cast_params``
    would make of f32 master weights)."""
    model = Transformer(cfg, device=device, dtype=dtype)
    init_params(model, generator)
    for layer in (*model.layers, *model.encoder):
        init_params(layer, generator)
    return model


@torch.no_grad()
def init_shard(cfg: ModelConfig, generator: torch.Generator,
               shardings: Dict) -> Transformer:
    """The calling rank's part of :func:`init_model`'s f32 model under
    ``shardings`` (sanitized, on a process mesh), drawn by shards: each
    leaf is drawn whole on the rank's device from ``generator`` in
    :func:`init_model`'s order, the rank's shard kept and the leaf freed
    before the next, so the values equal ``init_model(...).shard(
    shardings)``'s bit for bit while the rank holds its shard and one
    whole leaf at a time."""
    if not D.is_process_mesh(next(iter(shardings.values())).mesh):
        raise ValueError("a draw by shards takes shardings on a process mesh; "
                         "place a whole model (parallel.sharding.place) "
                         "on any other mesh")
    whole = {n: tuple(p.shape)
             for n, p in Transformer(cfg, device="meta").named_parameters()}
    cut, layout, tp = _shard_plan(cfg, shardings, whole)
    model = Transformer(cfg, device=layout.mesh.device, shapes=cut)

    def part(name, t):
        return D.local_shard(t, layout.specs[name], layout.mesh)

    init_params(model, generator, whole=whole, part=part)
    for stack, layers in (("layers", model.layers), ("encoder", model.encoder)):
        for i, layer in enumerate(layers):
            init_params(layer, generator, whole=whole, part=part,
                        prefix=f"{stack}.{i}.")
    model.layout, model.tp = layout, tp
    return model


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device=None):
    dt = _compute_dtype(cfg)
    hd = cfg.resolved_head_dim
    if kind == "ssm":
        return ssm_lib.ssm_init_cache(
            batch, cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            n_state=cfg.ssm_state, dtype=dt, device=device)
    if kind == "rglru":
        return rglru_lib.rglru_init_cache(batch, cfg.lru_width or cfg.d_model,
                                          dtype=dt, device=device)
    if kind == "local_attn":
        w = min(cfg.local_window, max_seq)
        shape = (batch, w, cfg.num_kv_heads, hd)
        return LocalKVCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            pos=torch.full((w,), -1, dtype=torch.int32, device=device))
    if kind.startswith("mla"):
        return attn.MLACache(
            c_kv=torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dt, device=device),
            k_rope=torch.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dt,
                               device=device))
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    return attn.KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                        v=torch.zeros(shape, dtype=dt, device=device))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> List:
    """One decode cache a layer (the reference stacks them per run)."""
    return [init_layer_cache(cfg, kind, batch, max_seq, device)
            for kind in cfg.layer_kinds()]


# --------------------------------------------------------------------------
# Layers (full sequence)
# --------------------------------------------------------------------------


def _moe(params, h, cfg: ModelConfig, group_size: int, tp=None):
    return moe_lib.moe_apply(
        params["moe"], h,
        experts_per_token=cfg.experts_per_token, num_experts=cfg.num_experts,
        capacity_factor=cfg.moe_capacity_factor, group_size=group_size,
        routing=cfg.router_topk_impl, recall_target=cfg.knn_recall_target,
        first_expert=0 if tp is None else tp.expert_start,
    )


def _block(tp, name: str):
    """The shard block ``name`` runs under: ``tp``, or None where the
    block runs whole (or no shard)."""
    return None if tp is None else tp.block(name)


def _split_in(h, tp):
    """A block's input under ``tp``: "f" (else ``h``)."""
    return h if tp is None else TP.copy_to_model(h, tp)


def _split_out(y, tp):
    """A block's output under ``tp``: "g" over its ranks' parts."""
    return y if tp is None else TP.reduce_from_model(y, tp)


def _apply_attn_train(params, x, positions, cfg: ModelConfig, kind: str,
                      return_cache: bool, enc_out=None, mrope_positions=None,
                      tp=None):
    """An attention layer over the full sequence.  Under tensor
    parallelism (``tp``, the layer's shard) Megatron's operators bracket
    each block, the decoder's cross-attention too: ``copy_to_model``
    after its norm, ``reduce_from_model`` after its ``wo`` (after the
    MoE block's output: its experts' and shared experts' parts).  MLA
    runs its heads of ``wq_b``/``wk_b``/``wv_b``/``wo`` from the whole
    latent projections, MoE its experts of every token's routing.  A
    block that runs whole (``TensorParallel.block``) takes neither."""
    layer_tp, tp = tp, _block(tp, "attn")
    h = _split_in(rms_norm(x, params["pre_norm"], cfg.norm_eps), tp)
    cache = None
    if kind.startswith("mla"):
        out = attn.mla_train(
            params["attn"], h, positions,
            num_heads=cfg.num_heads if tp is None else tp.num_heads,
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
            rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
            return_cache=return_cache, scores_dtype=cfg.attn_scores_dtype,
        )
    else:
        out = attn.attention_train(
            params["attn"], h, positions,
            num_heads=cfg.num_heads if tp is None else tp.num_heads,
            num_kv_heads=cfg.num_kv_heads if tp is None else tp.num_kv_heads,
            rope_theta=cfg.rope_theta, causal=(kind != "enc"),
            window=cfg.local_window if kind == "local_attn" else None,
            mrope=cfg.mrope, mrope_positions=mrope_positions,
            q_chunk=cfg.q_chunk, return_cache=return_cache,
            scores_dtype=cfg.attn_scores_dtype,
            kv_index=None if tp is None else tp.kv_index(h.device),
        )
    if return_cache:
        out, cache = out
    x = x + _split_out(out, tp)
    if kind == "dec":
        tp = _block(layer_tp, "cross")
        h = _split_in(rms_norm(x, params["cross_norm"], cfg.norm_eps), tp)
        enc_kv = attn.encode_cross_kv(params["cross"], enc_out)
        out = attn.cross_attention(
            params["cross"], h, enc_kv,
            num_heads=cfg.num_heads if tp is None else tp.num_heads,
            q_chunk=cfg.q_chunk, scores_dtype=cfg.attn_scores_dtype)
        x = x + _split_out(out, tp)
    tp = _block(layer_tp, "moe" if kind.endswith("moe") else "mlp")
    h = _split_in(rms_norm(x, params["mlp_norm"], cfg.norm_eps), tp)
    if kind.endswith("moe"):
        y = _moe(params, h, cfg, cfg.moe_group_size, tp)
    else:
        y = mlp_apply(params["mlp"], h, act=cfg.act)
    return x + _split_out(y, tp), cache


def layer_train(params, x, positions, cfg: ModelConfig, kind: str = "dense",
                return_cache: bool = False, enc_out=None, mrope_positions=None,
                tp=None):
    """One layer over the full sequence -> (output, cache): with
    ``return_cache`` the layer's decode cache for the sequence, else None.
    Differentiable in every input and parameter (the decode caches are
    built from the forward's values, not written in place).  ``tp``: the
    layer's tensor-parallel shard (``parallel.tensor_parallel``): every
    block runs between "f" (after its norm) and "g" (the sum of the
    ranks' parts of its output): attention and the MLP on a rank's heads
    and ``d_ff`` (a local-attention layer's too, its kv head whole), MoE
    on its experts, RG-LRU on its channels (the dense gates'
    outputs reduce-scattered), the SSD on its heads (``in_proj`` and the
    conv gathered, the gated norm's sum of squares summed); a dec
    layer's ``enc_out`` has passed ``copy_to_model`` already
    (:func:`forward_train`).  A block that runs whole on every rank
    (``TensorParallel.block``) runs as in one process, outside "f" and
    "g"."""
    if kind == "ssm":
        tp = _block(tp, "ssm")
        h = _split_in(rms_norm(x, params["pre_norm"], cfg.norm_eps), tp)
        y = ssm_lib.ssm_train(
            params["ssm"], h, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            n_state=cfg.ssm_state, chunk=cfg.ssm_chunk, return_cache=return_cache,
            tp=tp,
        )
        cache = None
        if return_cache:
            y, cache = y
        return x + _split_out(y, tp), cache
    if kind == "rglru":
        rtp, mtp = _block(tp, "rglru"), _block(tp, "mlp")
        h = _split_in(rms_norm(x, params["pre_norm"], cfg.norm_eps), rtp)
        y = rglru_lib.rglru_train(params["rglru"], h, return_cache=return_cache,
                                  scan_impl=cfg.lru_scan_impl, tp=rtp)
        cache = None
        if return_cache:
            y, cache = y
        x = x + _split_out(y, rtp)
        h = _split_in(rms_norm(x, params["mlp_norm"], cfg.norm_eps), mtp)
        return x + _split_out(mlp_apply(params["mlp"], h, act=cfg.act), mtp), cache
    x, cache = _apply_attn_train(params, x, positions, cfg, kind, return_cache,
                                 enc_out, mrope_positions, tp)
    if return_cache and kind == "local_attn":
        cache = _to_ring_cache(cache, positions, cfg)
    return x, cache


def _to_ring_cache(cache: attn.KVCache, positions, cfg: ModelConfig) -> LocalKVCache:
    """Convert a full prefill KV cache to the sliding-window ring buffer."""
    s = cache.k.shape[1]
    w = min(cfg.local_window, s)
    # Roll so that slot j holds the position p with p % w == j.
    shift = s % w
    return LocalKVCache(k=torch.roll(cache.k[:, -w:], shift, dims=1),
                        v=torch.roll(cache.v[:, -w:], shift, dims=1),
                        pos=torch.roll(positions[-w:], shift, dims=0).to(torch.int32))


# --------------------------------------------------------------------------
# Layers (single-token decode)
# --------------------------------------------------------------------------


def layer_decode(params, x, cache, cur_index, cfg: ModelConfig,
                 kind: str = "dense", use_knn: bool = False, cross_kv=None):
    """One layer, one token: writes the layer's cache in place and
    returns (output, cache)."""
    h = rms_norm(x, params["pre_norm"], cfg.norm_eps)
    knn_k = cfg.knn_attention_k if use_knn else 0
    if kind == "ssm":
        y, cache = ssm_lib.ssm_decode(
            params["ssm"], h, cache, expand=cfg.ssm_expand,
            head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
        )
        return x + y, cache
    if kind == "rglru":
        y, cache = rglru_lib.rglru_decode(params["rglru"], h, cache)
        x = x + y
        h = rms_norm(x, params["mlp_norm"], cfg.norm_eps)
        return x + mlp_apply(params["mlp"], h, act=cfg.act), cache
    if kind.startswith("mla"):
        y, cache = attn.mla_decode(
            params["attn"], h, cache, cur_index,
            num_heads=cfg.num_heads, kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
            rope_theta=cfg.rope_theta,
            knn_k=knn_k, knn_recall_target=cfg.knn_recall_target,
        )
    elif kind == "local_attn":
        y, cache = _local_attn_decode(params["attn"], h, cache, cur_index, cfg)
    else:
        y, cache = attn.attention_decode(
            params["attn"], h, cache, cur_index,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, mrope=cfg.mrope,
            knn_k=knn_k, knn_recall_target=cfg.knn_recall_target,
        )
    x = x + y
    if kind == "dec":
        h = rms_norm(x, params["cross_norm"], cfg.norm_eps)
        x = x + attn.cross_attention(params["cross"], h, cross_kv,
                                     num_heads=cfg.num_heads, q_chunk=cfg.q_chunk,
                                     scores_dtype=cfg.attn_scores_dtype)
    h = rms_norm(x, params["mlp_norm"], cfg.norm_eps)
    if kind.endswith("moe"):
        y = _moe(params, h, cfg, min(cfg.moe_group_size, h.shape[0] * h.shape[1]))
    else:
        y = mlp_apply(params["mlp"], h, act=cfg.act)
    return x + y, cache


def _local_attn_decode(params, x, cache: LocalKVCache, cur_index, cfg: ModelConfig):
    """Sliding-window decode on a ring-buffer cache (W slots): the new key
    and value go to slot ``position % W``, in place."""
    w = cache.k.shape[1]
    pos = attn._position(cur_index, x.device)
    q, k_new, v_new = attn._qkv(params, x, pos.to(torch.int32),
                                rope_theta=cfg.rope_theta, mrope=False,
                                mrope_positions=None)
    slot = torch.remainder(pos, w)
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    cache.pos.index_copy_(0, slot, pos.to(cache.pos.dtype))
    groups = cfg.num_heads // cfg.num_kv_heads
    q1 = q[:, 0]                    # (B, H, hd)
    scores = attn._group_scores(q1, cache.k, groups) * attn._const(
        q1.shape[-1] ** -0.5, q1)
    valid = ((cache.pos >= 0) & (cache.pos <= pos)
             & (pos - cache.pos < cfg.local_window))
    scores = torch.where(valid, scores, attn._const(attn._NEG_INF, scores))
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    b, h, s = probs.shape
    out = (probs.reshape(b, -1, groups, s) @ cache.v.transpose(1, 2)).reshape(b, h, -1)
    return attn._out(out, params["wo"])[:, None], cache


# --------------------------------------------------------------------------
# Forwards
# --------------------------------------------------------------------------


# matmuls without batch dims: what "dots" saves (every other op recomputes)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat`` where autograd records (see the module
    docstring); ``fn`` itself without grad or with ``"none"``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    return functools.partial(
        ckpt.checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _dots_policy))


def _cast_params(params, cfg: ModelConfig):
    """Cast master (f32) params to the compute dtype (norms upcast internally)."""
    dt = _compute_dtype(cfg)
    if isinstance(params, dict):
        return {k: _cast_params(v, cfg) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_params(v, cfg) for v in params]
    return params.to(dt) if params.dtype == torch.float32 else params


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    # filled on the device: a host scalar would be a copy (and a graph
    # capture refuses one)
    step = torch.log(torch.full((), 10000.0, device=positions.device)) / half
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) * step)
    ang = positions[:, None].to(torch.float32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _take(zero3, p: torch.Tensor, name: str) -> torch.Tensor:
    """Parameter ``name`` as a forward reads it: ``p`` (cast already), or
    gathered and cast on a ZeRO-3 shard."""
    return p if zero3 is None else zero3.leaf(p, name)


def _regathering(zero3):
    """Around a table's read on a ZeRO-3 shard: what the backward needs
    of the gathered table is gathered again."""
    return contextlib.nullcontext() if zero3 is None else zero3.regather_saved()


def _embed_in(params, cfg: ModelConfig, tokens_or_embeds: torch.Tensor, positions,
              tp=None, zero3=None):
    """The decoder's input: token ids looked up in the table (vocabulary-
    parallel under ``tp``), or float embeddings taken as they are (a
    stubbed frontend's; under ``tp`` each rank's replicated copy: no
    collective, and the table is not read, so its gradient is zeros)."""
    if tokens_or_embeds.is_floating_point():
        x = tokens_or_embeds  # stubbed modality frontend output
    else:
        with _regathering(zero3):
            table = _take(zero3, params["embed"]["embedding"], "embed.embedding")
            if tp is not None:
                x = TP.vocab_parallel_embed(table, tokens_or_embeds.long(), tp)
            else:
                x = table[tokens_or_embeds.long()]
    x = x.to(_compute_dtype(cfg))
    if cfg.rope_theta == 0:  # absolute sinusoidal (whisper-style)
        x = x + _sinusoid(positions, cfg.d_model)[None].to(x.dtype)
    return x


def _unembed(params, cfg: ModelConfig, x, tp=None, zero3=None):
    """Logits (B, S, V); under tensor parallelism this rank's part of the
    vocabulary (B, S, V / size)."""
    with _regathering(zero3):
        x = rms_norm(x, _take(zero3, params["final_norm"], "final_norm"),
                     cfg.norm_eps)
        if tp is not None:
            x = TP.copy_to_model(x, tp)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        table = _take(zero3, params[name]["embedding"], f"{name}.embedding")
        return x @ table.to(x.dtype).T


def _stack_layer(cfg: ModelConfig, stack: str, zero3=None):
    """``run(i, layer_params, *args, **kwargs)``: :func:`layer_train` for
    layer ``i`` of ``stack`` (``"layers"`` or ``"encoder"``) under
    ``cfg.remat``.  On a ZeRO-3 shard the layer's parameters are gathered
    inside the function remat wraps, so the backward's recompute gathers
    them again; with ``remat="none"`` the saved gathered weights are
    dropped and gathered again (``Zero3.regather_saved``)."""
    if zero3 is None:
        plain = _maybe_remat(layer_train, cfg)
        return lambda i, params, *args, **kw: plain(params, *args, **kw)

    def gathered(prefix, params, *args, **kw):
        return layer_train(zero3.tree(params, prefix), *args, **kw)

    run = _maybe_remat(gathered, cfg)
    if run is gathered:
        def run(prefix, params, *args, **kw):
            with zero3.regather_saved():
                return gathered(prefix, params, *args, **kw)
    return lambda i, params, *args, **kw: run(f"{stack}.{i}.", params, *args, **kw)


def _encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor, zero3=None,
            tp=None):
    """Whisper's encoder: the bidirectional ``enc`` layers over the frame
    embeddings plus sinusoidal positions, then ``enc_final_norm``
    (replicated).  Under ``tp`` each layer is split as the decoder's;
    the output is then ``copy_to_model``'s: every decoder layer's
    column-parallel cross wk/wv reads it, so its gradient, summed over
    the decoder layers, is all-reduced over ``"model"`` once (not where
    the cross-attention runs whole: its gradient is then every rank's
    own)."""
    s = enc_embeds.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=enc_embeds.device)
    x = enc_embeds.to(_compute_dtype(cfg))
    x = x + _sinusoid(positions, cfg.d_model)[None].to(x.dtype)
    layer = _stack_layer(cfg, "encoder", zero3)
    for i, layer_params in enumerate(params["encoder"]):
        h, _ = layer(i, layer_params, x, positions, cfg, "enc", tp=tp)
        x = h.to(x.dtype)
    with _regathering(zero3):
        x = rms_norm(x, _take(zero3, params["enc_final_norm"], "enc_final_norm"),
                     cfg.norm_eps)
    cross = _block(tp, "cross")
    return x if cross is None else TP.copy_to_model(x, cross)


def _forward(params, cfg: ModelConfig, tokens_or_embeds, positions, *,
             enc_out=None, mrope_positions=None, return_cache=False, tp=None,
             zero3=None):
    """The decoder stack over a full sequence -> (final hidden states,
    one cache a layer or None)."""
    s = tokens_or_embeds.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens_or_embeds.device)
    x = _embed_in(params, cfg, tokens_or_embeds, positions, tp, zero3)
    layer = _stack_layer(cfg, "layers", zero3)
    caches = []
    for i, (kind, layer_params) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        h, cache = layer(i, layer_params, x, positions, cfg, kind,
                         return_cache=return_cache, enc_out=enc_out,
                         mrope_positions=mrope_positions, tp=tp)
        x = h.to(x.dtype)
        caches.append(cache)
    return x, caches


def forward_train(model: Transformer, tokens_or_embeds: torch.Tensor, *,
                  enc_embeds=None, positions=None, mrope_positions=None,
                  grad_dtype: Optional[str] = None):
    """Full-sequence forward -> logits (B, S, V): token ids (B, S) or, for
    a stubbed frontend, float embeddings (B, S, d); ``mrope_positions``
    (3, S) the M-RoPE streams; ``enc_embeds`` whisper's frames.  Autograd
    records where the model's parameters require grad (the training
    step), each layer under ``cfg.remat``; a serving model's do not.  A
    tensor-parallel shard (``model.tp``) returns its part of the
    vocabulary's logits (B, S, V / size).  A ZeRO-3 shard (its layout
    cuts leaves over the data axis) gathers each layer's parameters as
    the layer runs and the tables where they are read, casting each
    shard to the compute dtype before its gather; ``grad_dtype=
    "bfloat16"`` reduce-scatters their gradients in bf16 (the compressed
    reduction), else in f32."""
    cfg = model.cfg
    zero3 = Z.Zero3.of(model, _compute_dtype(cfg), grad_dtype)
    params = model.params()
    if zero3 is None:
        params = _cast_params(params, cfg)
    enc_out = (_encode(params, cfg, enc_embeds, zero3, model.tp)
               if cfg.is_encoder_decoder else None)
    x, _ = _forward(params, cfg, tokens_or_embeds, positions, enc_out=enc_out,
                    mrope_positions=mrope_positions, tp=model.tp, zero3=zero3)
    return _unembed(params, cfg, x, model.tp, zero3)


def _prefill(params, cfg: ModelConfig, tokens_or_embeds, positions=None,
             enc_out=None):
    x, caches = _forward(params, cfg, tokens_or_embeds, positions,
                         enc_out=enc_out, return_cache=True)
    return _unembed(params, cfg, x[:, -1:]), caches


def _refuse_shard(model: Transformer, what: str) -> None:
    split = model.layout is not None and model.layout.data_split
    if model.tp is not None or split:
        kind = "a tensor-parallel" if model.tp is not None else "a ZeRO-3"
        raise NotImplementedError(
            f"{what} on {kind} shard: serving runs whole models "
            "(the process mesh is the trainer's)")


@torch.no_grad()
def forward_prefill(model: Transformer, tokens_or_embeds: torch.Tensor, *,
                    enc_embeds=None, positions: Optional[torch.Tensor] = None):
    """Prefill: full forward -> (last position's logits (B, 1, V), one
    cache a layer of the prompt's length; a local-attention layer's is
    its ring buffer of min(window, S) slots).  As the reference's, the
    M-RoPE streams are the 1-D positions stacked."""
    cfg = model.cfg
    _refuse_shard(model, "prefill")
    params = _cast_params(model.params(), cfg)
    enc_out = _encode(params, cfg, enc_embeds) if cfg.is_encoder_decoder else None
    return _prefill(params, cfg, tokens_or_embeds, positions, enc_out)


@torch.no_grad()
def forward_decode(model: Transformer, tokens: torch.Tensor, caches,
                   cur_index, *, use_knn: bool = False, cross_kv=None):
    """Single-token decode step: tokens (B, 1) -> (logits (B, 1, V),
    caches, each written at ``cur_index`` in place).  ``cur_index`` is an
    int or a one-element device tensor (a CUDA graph of the step reads
    it).  ``cross_kv`` (whisper) holds one cross-attention ``KVCache`` a
    layer (``build_cross_kv``)."""
    cfg = model.cfg
    if cfg.is_encoder_decoder and cross_kv is None:
        raise ValueError("an encoder-decoder's decode step attends to the "
                         "cross_kv of its prefill step (make_prefill_step)")
    _refuse_shard(model, "decode")
    params = _cast_params(model.params(), cfg)
    x = _embed_in(params, cfg, tokens, attn._position(cur_index, tokens.device))
    new_caches = []
    for i, (kind, layer_params, cache) in enumerate(
            zip(cfg.layer_kinds(), params["layers"], caches)):
        h, cache = layer_decode(
            layer_params, x, cache, cur_index, cfg, kind, use_knn=use_knn,
            cross_kv=cross_kv[i] if cross_kv is not None else None)
        x = h.to(x.dtype)
        new_caches.append(cache)
    return _unembed(params, cfg, x), new_caches


def build_cross_kv(params, cfg: ModelConfig, enc_out: torch.Tensor) -> List:
    """Each decoder layer's cross-attention KV from the encoder output
    (whisper; None for a layer of another kind)."""
    return [attn.encode_cross_kv(p["cross"], enc_out) if kind == "dec" else None
            for kind, p in zip(cfg.layer_kinds(), params["layers"])]
