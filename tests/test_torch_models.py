"""repro_torch.configs and repro_torch.models against the reference.

Configs are pure data and must be equal field for field (and in
``param_count()``).  The layers, rotary embeddings and attention take
the same seeded numpy inputs as the reference's; the dense smoke models
take the reference's own parameters through ``params.from_reference``.
Tolerances: f32 within 1e-5 relative (elementwise, ``assert_allclose``
with atol 1e-6) for the single layers, and for whole models at f32
within 1e-4 of the largest |logit|; the bf16 models (``cfg.dtype``, the
configs' default) within 2^-5 of the largest |logit| (8 bf16 ulps: each
matmul rounds its output to bf16, as the reference's does, and the two
libraries sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.core.topk import approx_max_k as ref_approx_max_k
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models import params as ref_params
from repro.models import rope as ref_rope
from repro.models import transformer as ref_tfm
import repro_torch.configs as port_configs
from repro_torch.core.topk import approx_max_k
from repro_torch.models import attention as attn
from repro_torch.models import layers, params, rope
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm

DENSE = ["internlm2-1.8b-smoke", "granite-20b-smoke", "starcoder2-7b-smoke",
         "stablelm-1.6b-smoke"]
NOT_DENSE = ["deepseek-v2-236b-smoke", "granite-moe-3b-a800m-smoke",
             "mamba2-2.7b-smoke", "qwen2-vl-2b-smoke", "recurrentgemma-9b-smoke",
             "whisper-medium-smoke"]
F32_REL, BF16_REL = 1e-4, 2.0 ** -5


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- configs -----------------------------------------------------------------


def test_registry_equals_reference():
    assert port_configs.list_configs() == ref_configs.list_configs()
    assert port_configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    assert ({k: dataclasses.astuple(v) for k, v in port_configs.SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in ref_configs.SHAPES.items()})
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ref_configs.list_configs())
def test_config_fields_and_counts_equal_reference(name):
    ours, ref = port_configs.get_config(name), ref_configs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.layer_kinds() == ref.layer_kinds()
    assert (ours.padded_vocab, ours.resolved_head_dim) == (
        ref.padded_vocab, ref.resolved_head_dim)
    assert tfm.runs_of(ours) == ref_tfm.runs_of(ref)


# --- parameters ----------------------------------------------------------------


def _defs_equal(ours, ref):
    if isinstance(ours, params.ParamDef):
        return (ours.shape, ours.axes, ours.init) == (ref.shape, ref.axes, ref.init)
    return set(ours) == set(ref) and all(_defs_equal(ours[k], ref[k]) for k in ours)


@pytest.mark.parametrize("name", DENSE)
def test_defs_and_state_dict_follow_reference_names(name):
    cfg = port_configs.get_config(name)
    rcfg = ref_configs.get_config(name)
    assert _defs_equal(tfm.model_defs(cfg), ref_tfm.model_defs(rcfg))
    assert _defs_equal(tfm.layer_defs(cfg, "dense"), ref_tfm.layer_defs(rcfg, "dense"))
    assert params.param_axes(tfm.layer_defs(cfg, "dense")) == \
        ref_params.param_axes(ref_tfm.layer_defs(rcfg, "dense"))
    ref_p = ref_tfm.init_model(jax.random.PRNGKey(0), rcfg)
    state = params.from_reference(ref_p, cfg)
    model = tfm.Transformer(cfg, device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.numpy(), np.asarray(ref_p["layers"][0]["attn"]["wq"][1]))
    np.testing.assert_array_equal(model.embed.embedding.numpy(),
                                  np.asarray(ref_p["embed"]["embedding"]))


@pytest.mark.parametrize("name", NOT_DENSE)
def test_every_kind_defs_follow_reference(name):
    """Each layer kind's defs (and whisper's ``enc``) with the reference's
    names, shapes, axes and inits (each family's test loads the
    reference's parameters through ``from_reference``; qwen2-vl's layers
    are dense)."""
    cfg = port_configs.get_config(name)
    rcfg = ref_configs.get_config(name)
    assert _defs_equal(tfm.model_defs(cfg), ref_tfm.model_defs(rcfg))
    kinds = set(cfg.layer_kinds()) | ({"enc"} if cfg.is_encoder_decoder else set())
    for kind in kinds:
        assert _defs_equal(tfm.layer_defs(cfg, kind), ref_tfm.layer_defs(rcfg, kind))
        assert params.param_axes(tfm.layer_defs(cfg, kind)) == \
            ref_params.param_axes(ref_tfm.layer_defs(rcfg, kind))


def _reference_shapes(rcfg):
    """{state-dict name: shape} of the reference's parameters, from its
    abstract init (no allocation), layers unstacked as from_reference
    names them."""
    tree = jax.eval_shape(lambda: ref_tfm.init_model(jax.random.PRNGKey(0), rcfg))
    out = {}

    def walk(sub, prefix, stack=None):
        if isinstance(sub, dict):
            for k, v in sub.items():
                walk(v, f"{prefix}{k}.", stack)
        elif stack is None:
            out[prefix[:-1]] = tuple(sub.shape)
        else:
            key, start, count = stack
            for j in range(count):
                out[f"{key}.{start + j}.{prefix[:-1]}"] = tuple(sub.shape[1:])

    walk({k: v for k, v in tree.items() if k not in ("layers", "encoder")}, "")
    start = 0
    for (_, count), stacked in zip(ref_tfm.runs_of(rcfg), tree["layers"]):
        walk(stacked, "", ("layers", start, count))
        start += count
    if "encoder" in tree:
        walk(tree["encoder"], "", ("encoder", 0, rcfg.encoder_layers))
    return out


@pytest.mark.parametrize("name", ref_configs.list_configs())
def test_every_registered_config_builds_with_reference_shapes(name):
    """FULL, SMOKE and OPT: the port's parameters are the reference's,
    name for name and shape for shape (FULL and OPT on the meta device:
    no memory; the smoke configs on the CPU)."""
    cfg = port_configs.get_config(name)
    device = "cpu" if name.endswith("-smoke") else "meta"
    model = tfm.Transformer(cfg, device=device)
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == _reference_shapes(ref_configs.get_config(name))
    assert model.device.type == device


def test_init_model_is_seeded_and_scaled():
    cfg = port_configs.get_config("internlm2-1.8b-smoke")
    a = tfm.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tfm.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert torch.equal(a.layers[0].pre_norm, torch.ones(cfg.d_model))
    wi = a.layers[0].mlp.wi
    assert abs(float(wi.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    bf = tfm.init_model(cfg, torch.Generator().manual_seed(3), device="cpu",
                        dtype=torch.bfloat16)
    assert bf.layers[0].attn.wq.dtype == torch.bfloat16


# --- layers and rope -----------------------------------------------------------


def test_norms_and_mlps_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(scale), 1e-5).numpy(),
        _np(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        layers.layer_norm(_t(x), _t(scale), _t(bias)).numpy(),
        _np(ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias))),
        rtol=1e-5, atol=1e-6)
    for gated, act in ((True, "silu"), (False, "gelu"), (True, "relu")):
        defs = layers.mlp_defs(16, 24, gated=gated)
        p = {k: rng.standard_normal(d.shape, dtype=np.float32) * 0.3
             for k, d in defs.items()}
        np.testing.assert_allclose(
            layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), act=act).numpy(),
            _np(ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), act=act)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_rope_matches_reference(rotary_dim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    np.testing.assert_allclose(rope.rope_freqs(16).numpy(),
                               _np(ref_rope.rope_freqs(16)), rtol=1e-6)
    np.testing.assert_allclose(
        rope.apply_rope(_t(x), _t(pos), rotary_dim=rotary_dim).numpy(),
        _np(ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                rotary_dim=rotary_dim)),
        rtol=1e-5, atol=1e-5)


def test_mrope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos3 = rng.integers(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_allclose(
        rope.apply_mrope(_t(x), _t(pos3)).numpy(),
        _np(ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3))),
        rtol=1e-5, atol=1e-5)
    pos = np.arange(7, dtype=np.int32)
    np.testing.assert_array_equal(
        rope.default_mrope_positions(_t(pos)).numpy(),
        np.asarray(ref_rope.default_mrope_positions(jnp.asarray(pos))))


# --- attention -----------------------------------------------------------------


def _attn_case(seed, *, heads=4, kv=2, hd=16, d=32, b=2, s=160):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.2
         for k, v in attn.attn_defs(d, heads, kv, hd).items()}
    cache = [rng.standard_normal((b, s, kv, hd), dtype=np.float32) for _ in range(2)]
    x = rng.standard_normal((b, 1, d), dtype=np.float32)
    return p, cache, x


@pytest.mark.parametrize("knn_k", [0, 16, 128])
@pytest.mark.parametrize("cur", [5, 150])
def test_attention_decode_matches_reference(knn_k, cur):
    """Exact and kNN decode over a cache of 160 positions; at cur=5 with
    k=16 or 128 most selected positions are masked (early decode)."""
    p, (k0, v0), x = _attn_case(3)
    kw = dict(num_heads=4, num_kv_heads=2, knn_k=knn_k)
    y, cache = attn.attention_decode({k: _t(v) for k, v in p.items()}, _t(x),
                                     attn.KVCache(_t(k0.copy()), _t(v0.copy())),
                                     cur, **kw)
    ry, rcache = ref_attn.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        ref_attn.KVCache(jnp.asarray(k0), jnp.asarray(v0)), jnp.int32(cur), **kw)
    np.testing.assert_allclose(y.numpy(), _np(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(rcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(rcache.v))


@pytest.mark.parametrize("live", [3, 40, 160])
def test_knn_decode_attention_selection_and_masked_slots(live):
    """The keys approx_max_k selects (equal to the reference's, masked
    ties to the lowest positions), masked slots weighing exactly 0, and
    the output against the reference's."""
    rng = np.random.default_rng(4)
    b, h, kv, hd, s, k = 2, 4, 2, 16, 160, 32
    q = rng.standard_normal((b, h, hd), dtype=np.float32)
    keys = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    values = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    valid = np.arange(s) < live
    out = attn.knn_decode_attention(_t(q), _t(keys), _t(values), _t(valid), k=k,
                                    kv_groups=h // kv)
    rout = ref_attn.knn_decode_attention(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid),
        k=k, kv_groups=h // kv)
    np.testing.assert_allclose(out.numpy(), _np(rout), rtol=1e-5, atol=1e-5)
    scores = attn._group_scores(_t(q), _t(keys), h // kv) * hd ** -0.5
    scores = torch.where(_t(valid), scores, attn._NEG_INF)
    top, idx = approx_max_k(scores, k)
    rtop, ridx = ref_approx_max_k(jnp.asarray(scores.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    probs = torch.softmax(top, dim=-1)
    assert (probs[~_t(valid)[idx.long()]] == 0).all()
    assert int((~_t(valid)[idx.long()]).sum()) == b * h * max(k - live, 0)


def test_context_parallel_knn_attention_raises_item_11(monkeypatch):
    """The context-parallel kNN attention is chosen by the active mesh's
    rules, not by an argument (the reference's ``knn_decode_attention``):
    "cp_seq" mapped to axes present on the mesh takes
    ``_knn_decode_attention_cp`` over them (its value exactly); no mesh, a
    mesh without those axes, or rules mapping "cp_seq" to nothing take the
    local path.  (Item 11 ported the explicit form; item 13b's rules pick
    the axes.)"""
    from repro_torch.parallel import LOGICAL_RULES, make_mesh, use_mesh

    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((1, 4, 8), dtype=np.float32))
    keys = _t(rng.standard_normal((1, 64, 2, 8), dtype=np.float32))
    values = _t(rng.standard_normal((1, 64, 2, 8), dtype=np.float32))
    valid = torch.arange(64) < 50
    kw = dict(k=4, kv_groups=2)
    calls = []
    real = attn._knn_decode_attention_cp

    def spy(*a, **k):
        calls.append(tuple(k["cp_axes"]))
        return real(*a, **k)
    monkeypatch.setattr(attn, "_knn_decode_attention_cp", spy)
    local = attn.knn_decode_attention(q, keys, values, valid, **kw)
    assert calls == []
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with use_mesh(mesh):
        out = attn.knn_decode_attention(q, keys, values, valid, **kw)
    assert calls == [("model",)]
    want = real(q, keys, values, valid, recall_target=0.95, mesh=mesh,
                cp_axes=("model",), **kw)
    assert torch.equal(out, want)
    rules = dict(LOGICAL_RULES)
    for m, r in ((make_mesh((4,), ("data",), devices=["cpu"] * 4), None),
                 (mesh, tuple(dict(rules, cp_seq=None).items()))):
        with use_mesh(m, rules=r):
            assert torch.equal(attn.knn_decode_attention(q, keys, values, valid, **kw),
                               local)
    assert calls == [("model",)]


# --- whole models --------------------------------------------------------------


def _pair(name, dtype):
    rcfg = dataclasses.replace(ref_configs.get_config(name), dtype=dtype)
    cfg = dataclasses.replace(port_configs.get_config(name), dtype=dtype)
    ref_p = ref_tfm.init_model(jax.random.PRNGKey(7), rcfg)
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(params.from_reference(ref_p, cfg))
    return cfg, rcfg, model, ref_p


def _close(ours, ref, rel):
    ours, ref = ours.float().numpy(), _np(ref)
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_replay_match_reference(name, dtype):
    """forward_prefill over 40 tokens, then 12 decode steps replaying the
    tokens (exact attention, then kNN attention) from fresh caches: every
    step's logits and the final caches against the reference's."""
    cfg, rcfg, model, ref_p = _pair(name, dtype)
    rel = F32_REL if dtype == "float32" else BF16_REL
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    logits, caches = M.make_prefill_step(cfg)(model, {"tokens": _t(toks)})
    rlogits, rcaches = jax.jit(ref_model.make_prefill_step(rcfg))(
        ref_p, {"tokens": jnp.asarray(toks)})
    _close(logits, rlogits, rel)
    _close(torch.stack([c.k for c in caches]), rcaches[0].k, rel)
    for use_knn in (False, True):
        caches = tfm.init_caches(cfg, 2, 160, device="cpu")
        rcaches = ref_tfm.init_caches(rcfg, 2, 160)
        step = jax.jit(ref_model.make_decode_step(rcfg, use_knn=use_knn,
                                                  sample="greedy"))
        for t in range(12):
            logits, caches = tfm.forward_decode(model, _t(toks[:, t : t + 1]), caches,
                                                t, use_knn=use_knn)
            _, rlogits, rcaches = step(ref_p, jnp.asarray(toks[:, t : t + 1]),
                                       rcaches, jnp.int32(t), jax.random.PRNGKey(0))
            _close(logits, rlogits, rel)
        _close(torch.stack([c.v for c in caches]), rcaches[0].v, rel)


@pytest.mark.parametrize("name", DENSE)
def test_decode_replay_equals_full_forward(name):
    """The port against itself at f32: position t's logits from a replay
    of tokens 0..t through the decode step equal the full forward's."""
    cfg, _, model, _ = _pair(name, "float32")
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32))
    caches = tfm.init_caches(cfg, 2, 128, device="cpu")
    for t in range(20):
        logits, caches = tfm.forward_decode(model, toks[:, t : t + 1], caches, t)
        full, _ = tfm.forward_prefill(model, toks[:, : t + 1])
        err = (logits - full).abs().max()
        assert err <= F32_REL * full.abs().max()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.Transformer(port_configs.get_config("internlm2-1.8b-smoke"))
