"""The port's mesh rules against the reference's, on the CPU.

``repro_torch.parallel.sharding`` (the rules table, ``logical_to_spec``),
``repro_torch.ft.elastic`` (``choose_mesh_shape``, ``remesh_state``),
``repro_torch.launch.{mesh,shardspecs}`` (every spec tree of the ten
archs x four shapes x both production meshes) and
``knn_decode_attention`` under an active mesh.

The spec trees are compared on the reference's side over
``jax.sharding.AbstractMesh`` (no devices needed) with abstract values
from ``jax.eval_shape``; the port's over ``make_production_mesh`` on
``"meta"`` with ``device="meta"`` tensors.  The port keeps one tree entry
a layer where the reference stacks each run of layers: the reference's
trees are unstacked for the comparison (each stacked spec is its leading
``"layers"`` entry, always None, then the port's spec for every layer of
the run).  The kNN attention runs in one reference subprocess on 4 fake
host devices (the ``ref`` fixture), as ``tests/test_torch_sharded.py``
does, and is held to its tolerances.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as ref_configs
from repro.checkpoint import checkpoint as ref_ck
from repro.ft import elastic as ref_elastic
from repro.launch import shardspecs as ref_ss
from repro.models import model as ref_model
from repro.models import transformer as ref_tfm
from repro.parallel import sharding as ref_sharding
import repro_torch.configs as port_configs
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.ft import elastic
from repro_torch.launch import shardspecs as ss
from repro_torch.launch.dryrun import _abstract_train_state
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models import params
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import make_mesh, sharding

from torch_train_parity import few_threads  # noqa: F401 (a fixture)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# the attention of tests/test_torch_sharded.py: internlm2-1.8b's decode
# cut to test size, GQA 2 query heads a KV head, S over 4 shards
AB, AH, AKV, AHD, AS, AK = 2, 4, 2, 16, 256, 8
# the whole smoke model's kNN decode step: a cache of 512 positions (4
# shards of 128) written at position 400
LM, LM_S, LM_POS = "internlm2-1.8b-smoke", 512, 400


def _ref_mesh(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names)


def _port_mesh(kind):
    return make_production_mesh(multi_pod=kind == "multi")


def _spec(s):
    return tuple(s.spec)


# --- the rules ------------------------------------------------------------------


def test_logical_rules_are_the_references():
    assert sharding.LOGICAL_RULES == ref_sharding.LOGICAL_RULES


@pytest.mark.parametrize("rules", ["default", "train_4k", "long_500k", "fsdp"])
@pytest.mark.parametrize("kind", list(MESHES))
def test_logical_to_spec_matches_reference(kind, rules):
    """Every rule name (and None), alone and in a multi-axis spec, with the
    default rules, a cell's rules (long_500k rewrites batch and cp_seq)
    and an override table; no mesh at all maps everything to None."""
    rmesh, mesh = _ref_mesh(kind), _port_mesh(kind)
    names = [n for n, _ in sharding.LOGICAL_RULES] + [None, "layers"]
    if rules == "default":
        rtab = tab = None
    elif rules == "fsdp":
        rtab = tab = tuple(dict(sharding.LOGICAL_RULES, embed=("pod", "data"),
                                heads=None).items())
    else:
        cfg = port_configs.get_config("internlm2-1.8b")
        shape = port_configs.SHAPES[rules]
        rtab = ref_ss.cell_rules(ref_configs.get_config("internlm2-1.8b"),
                                 ref_configs.SHAPES[rules], rmesh)
        tab = ss.cell_rules(cfg, shape, mesh)
        assert tab == rtab
    combos = [(n,) for n in names] + [tuple(names), ("batch", "cp_seq", None, "heads")]
    with ref_sharding.use_mesh(rmesh, rules=rtab):
        want = [tuple(ref_sharding.logical_to_spec(c)) for c in combos]
        want_p = tuple(ref_sharding.param_spec("vocab", "embed"))
    with sharding.use_mesh(mesh, rules=tab):
        got = [tuple(sharding.logical_to_spec(c)) for c in combos]
        assert tuple(sharding.param_spec("vocab", "embed")) == want_p
        assert sharding.current_mesh() is mesh
    assert got == want
    assert sharding.current_mesh() is None
    assert sharding.logical_to_spec(("batch", "heads")) == (None, None)
    x = torch.ones(3)
    with sharding.use_mesh(mesh):
        assert sharding.shard(x, "batch") is x


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_choose_mesh_shape_matches_reference(mp):
    for n in range(1, 1025):
        assert elastic.choose_mesh_shape(n, model_parallel=mp) == \
            ref_elastic.choose_mesh_shape(n, model_parallel=mp), n


def test_meshes():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        shape, names = MESHES["multi" if multi else "single"]
        assert tuple(m.shape.values()) == shape and m.axis_names == names
        assert {str(d) for d in m.devices.flat} == {"meta"}
    # one device: model_parallel halves until it divides (the reference's)
    for mp, n, want in ((2, 1, (1, 1)), (2, 4, (2, 2)), (4, 6, (3, 2)),
                        (16, 8, (1, 8))):
        m = make_host_mesh(mp, devices=["cpu"] * n)
        assert tuple(m.shape.values()) == want and m.axis_names == ("data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_host_mesh(2)
    m = elastic.survivors_mesh(["cpu"] * 20, model_parallel=16)
    assert tuple(m.shape.values()) == (5, 4) and m.size == 20


# --- spec trees -----------------------------------------------------------------


def _unstack(ref_tree, cfg):
    """A reference tree of one entry a run (``runs_of``) as one a layer."""
    out = []
    for (_, count), run in zip(tfm.runs_of(cfg), ref_tree):
        out += [run] * count
    return out


def _drop_layers(spec):
    assert spec[0] is None, spec
    return spec[1:]


def _ref_params(tree, cfg):
    """The reference's param sharding tree by the port's parameter names."""
    flat = jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in tree.items() if k not in ("layers", "encoder")})[0]
    out = {".".join(p.key for p in path): _spec(s) for path, s in flat}
    layer = 0
    for (_, count), run in zip(tfm.runs_of(cfg), tree["layers"]):
        for path, s in jax.tree_util.tree_flatten_with_path(run)[0]:
            name = ".".join(p.key for p in path)
            for j in range(count):
                out[f"layers.{layer + j}.{name}"] = _drop_layers(_spec(s))
        layer += count
    if "encoder" in tree:
        for path, s in jax.tree_util.tree_flatten_with_path(tree["encoder"])[0]:
            name = ".".join(p.key for p in path)
            for j in range(cfg.encoder_layers):
                out[f"encoder.{j}.{name}"] = _drop_layers(_spec(s))
    return out


def _ref_per_layer(tree, cfg):
    """A per-run list of namedtuples (caches, cross KV) as one spec tuple
    a field a layer."""
    return [None if run is None else
            type(run)(*(_drop_layers(_spec(f)) for f in run))
            for run in _unstack(tree, cfg)]


def _port_per_layer(tree):
    return [None if c is None else type(c)(*(_spec(f) for f in c)) for c in tree]


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    rcfg = ref_configs.get_config(arch)
    return (jax.eval_shape(functools.partial(ref_model.init_train_state, cfg=rcfg),
                           jax.random.PRNGKey(0)),
            jax.eval_shape(functools.partial(ref_tfm.init_model, cfg=rcfg),
                           jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", port_configs.ASSIGNED_ARCHS)
def test_spec_trees_match_reference(arch):
    """``param_shardings``, ``train_state_shardings``, ``batch_shardings``,
    ``cache_shardings`` and ``decode_arg_shardings``, raw and through
    ``sanitize_tree``, for the four shapes on both production meshes."""
    cfg, rcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    rstate, rparams = _ref_abstract(arch)
    state = _abstract_train_state(cfg)
    model = state.params
    for kind in MESHES:
        rmesh, mesh = _ref_mesh(kind), _port_mesh(kind)
        for name, shape in port_configs.SHAPES.items():
            rshape = ref_configs.SHAPES[name]
            label = (arch, kind, name)
            assert ss.cell_rules(cfg, shape, mesh) == ref_ss.cell_rules(rcfg, rshape, rmesh)
            for sanitize in (False, True):
                rts = ref_ss.train_state_shardings(rcfg, rmesh, rshape)
                ts = ss.train_state_shardings(cfg, mesh, shape)
                if sanitize:
                    rts = ref_ss.sanitize_tree(rts, rstate, rmesh)
                    ts = ss.sanitize_tree(ts, state, mesh)
                assert _spec(ts.step) == _spec(rts.step) == ()
                for ours, ref in ((ts.params, rts.params), (ts.opt_state.m, rts.opt_state.m),
                                  (ts.opt_state.v, rts.opt_state.v)):
                    assert {n: _spec(s) for n, s in ours.items()} == \
                        _ref_params(ref, cfg), label
                want = _ref_params(ref_ss.sanitize_tree(ref_ss.param_shardings(
                    rcfg, rmesh, rshape), rparams, rmesh) if sanitize else
                    ref_ss.param_shardings(rcfg, rmesh, rshape), cfg)
                got = ss.param_shardings(cfg, mesh, shape)
                if sanitize:
                    got = ss.sanitize_tree(got, model, mesh)
                assert {n: _spec(s) for n, s in got.items()} == want, label
            specs = M.input_specs(cfg, shape)
            rspecs = ref_model.input_specs(rcfg, rshape)
            if shape.kind != "decode":
                rb = ref_ss.batch_shardings(rcfg, rshape, rmesh)
                b = ss.batch_shardings(cfg, shape, mesh)
                assert {k: _spec(s) for k, s in b.items()} == \
                    {k: _spec(s) for k, s in rb.items()}, label
                sb = ss.sanitize_tree(b, specs, mesh)
                rsb = ref_ss.sanitize_tree(rb, rspecs, rmesh)
                assert {k: _spec(s) for k, s in sb.items()} == \
                    {k: _spec(s) for k, s in rsb.items()}, label
                continue
            rd = ref_ss.decode_arg_shardings(rcfg, rshape, rmesh)
            d = ss.decode_arg_shardings(cfg, shape, mesh)
            assert sorted(d) == sorted(rd), label
            for key in ("tokens", "cur_index", "rng"):
                assert _spec(d[key]) == _spec(rd[key]), (label, key)
            assert {n: _spec(s) for n, s in d["params"].items()} == \
                _ref_params(rd["params"], cfg), label
            c = ss.cache_shardings(cfg, shape, mesh)
            assert _port_per_layer(c) == _port_per_layer(d["caches"])
            assert _port_per_layer(c) == _ref_per_layer(rd["caches"], cfg), label
            sc = ss.sanitize_tree(c, specs["caches"], mesh)
            rsc = ref_ss.sanitize_tree(rd["caches"], rspecs["caches"], rmesh)
            assert _port_per_layer(sc) == _ref_per_layer(rsc, cfg), label
            if cfg.is_encoder_decoder:
                assert _port_per_layer(d["cross_kv"]) == \
                    _ref_per_layer(rd["cross_kv"], cfg), label
                sx = ss.sanitize_tree(d["cross_kv"], specs["cross_kv"], mesh)
                rsx = ref_ss.sanitize_tree(rd["cross_kv"], rspecs["cross_kv"], rmesh)
                assert _port_per_layer(sx) == _ref_per_layer(rsx, cfg), label


# --- placement: remesh and the elastic restore ---------------------------------


def _state(name="internlm2-1.8b-smoke", seed=0):
    cfg = port_configs.get_config(name)
    return cfg, M.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                   device="cpu")


def _same_state(a, b):
    assert int(a.step) == int(b.step)
    pa, pb = dict(a.params.named_parameters()), dict(b.params.named_parameters())
    assert sorted(pa) == sorted(pb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        for tree in ("m", "v"):
            assert torch.equal(getattr(a.opt_state, tree)[n],
                               getattr(b.opt_state, tree)[n]), n


def _axes(cfg):
    axes = tfm.model_axes(cfg)
    return M.TrainState(step=(), params=axes, opt_state=AdamWState(m=axes, v=axes))


def test_remesh_state_keeps_every_leaf():
    cfg, state = _state()
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    for shape in ((1, 2), (2, 2), (1, 1)):
        mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))
        out = elastic.remesh_state(state, _axes(cfg), mesh)
        assert out.params is state.params  # placed in place: one device
        _same_state(out, state)
        for n, p in out.params.named_parameters():
            assert torch.equal(p, before[n]) and p.device == mesh.devices.flat[0]
    # a plain tree of tensors: the reference's leaf-for-leaf form
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4)]}
    out = elastic.remesh_state(tree, {"a": ("batch", "heads"), "b": [("embed",)]},
                               make_mesh((2,), ("data",), devices=["cpu"] * 2))
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"][0], tree["b"][0])


def test_restore_checkpoint_onto_a_new_mesh(tmp_path):
    """A state saved from one mesh restores onto another through
    ``shardings=`` (the elastic restart), bit for bit; the reference reads
    the same directory with its own ``shardings=`` to the same values."""
    cfg, state = _state()
    step = M.make_train_step(cfg, learning_rate=1e-3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)}
    state, _ = step(state, batch)
    ck.save_checkpoint(str(tmp_path), 1, state)
    mesh = make_host_mesh(16, devices=["cpu"] * 6)  # (3, 2): a shrunk mesh
    like = _state(seed=9)[1]
    sh = ss.sanitize_tree(ss.train_state_shardings(cfg, mesh), like, mesh)
    restored, at = ck.restore_checkpoint(str(tmp_path), like, shardings=sh)
    assert at == 1
    _same_state(restored, state)
    rcfg = ref_configs.get_config(cfg.name)
    rmesh = ref_elastic.survivors_mesh(jax.devices(), model_parallel=2)
    rlike = jax.eval_shape(lambda: ref_model.init_train_state(jax.random.PRNGKey(0), rcfg))
    rsh = ref_ss.sanitize_tree(ref_ss.train_state_shardings(rcfg, rmesh), rlike, rmesh)
    rstate, _ = ref_ck.restore_checkpoint(str(tmp_path), rlike, shardings=rsh)
    got = params.from_reference(jax.tree.map(np.asarray, rstate.params), cfg)
    for n, p in restored.params.named_parameters():
        assert torch.equal(p.detach(), got[n]), n


# --- kNN attention under an active mesh -----------------------------------------


def _attn_inputs(seed=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((AB, AH, AHD), dtype=np.float32)
    keys = rng.standard_normal((AB, AS, AKV, AHD), dtype=np.float32)
    values = rng.standard_normal((AB, AS, AKV, AHD), dtype=np.float32)
    valid = np.arange(AS) < 200
    return q, keys, values, valid


def _lm_inputs(cfg, seed=13):
    """A (B, S) cache of every layer stacked (L, B, S, KV, hd), and the
    tokens of one decode step."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, 2, LM_S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32),
            rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32))


_CHILD = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
import repro.configs as C
from repro.launch.mesh import _make_mesh
from repro.launch.shardspecs import cell_rules
from repro.models import model as M, transformer as T
from repro.models.attention import KVCache, knn_decode_attention
from repro.parallel.sharding import use_mesh

inp = dict(np.load(@INPUTS@))
a = [jnp.asarray(inp["a_" + k]) for k in ("q", "keys", "values", "valid")]
mesh1 = _make_mesh((4,), ("model",))  # Auto axes, as the reference's meshes
mesh2 = _make_mesh((2, 2), ("data", "model"))
mesh3 = _make_mesh((1, 4), ("data", "model"))
cfg = dataclasses.replace(C.get_config(@LM@), dtype="float32")
long = C.SHAPES["long_500k"]
out = {}
kw = dict(k=@AK@, recall_target=0.95, kv_groups=@G@)
with use_mesh(mesh1):
    out["model"] = np.asarray(knn_decode_attention(*a, **kw))
with use_mesh(mesh2, rules=cell_rules(cfg, long, mesh2)):
    out["long"] = np.asarray(knn_decode_attention(*a, **kw))
params = T.init_model(jax.random.PRNGKey(7), cfg)
out["params"] = jax.tree.map(np.asarray, params)
caches = [KVCache(k=jnp.asarray(inp["ck"]), v=jnp.asarray(inp["cv"]))]
step = jax.jit(M.make_decode_step(cfg, use_knn=True, sample="greedy"))
args = (params, jnp.asarray(inp["tokens"]), caches, jnp.int32(@POS@),
        jax.random.PRNGKey(0))
with use_mesh(mesh3, rules=cell_rules(cfg, long, mesh3)):
    tok, logits, _ = step(*args)
out["lm"] = (np.asarray(tok), np.asarray(logits))
publish(out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's kNN attention under ``use_mesh`` on 4 fake devices
    and its smoke model's kNN decode step, from one subprocess."""
    from conftest import FakeDeviceRunner

    tmp = tmp_path_factory.mktemp("mesh_rules")
    cfg = port_configs.get_config(LM)
    q, keys, values, valid = _attn_inputs()
    ck_, cv, tokens = _lm_inputs(cfg)
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, a_q=q, a_keys=keys, a_values=values, a_valid=valid,
             ck=ck_, cv=cv, tokens=tokens)
    source = _CHILD
    for key, val in {"@INPUTS@": repr(inputs), "@AK@": str(AK),
                     "@G@": str(AH // AKV), "@LM@": repr(LM),
                     "@POS@": str(LM_POS)}.items():
        source = source.replace(key, val)
    return FakeDeviceRunner()(source, n=4, timeout=600)


class _Spy:
    """Counts ``_knn_decode_attention_cp`` calls and their axes."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = attn._knn_decode_attention_cp

        def spy(*a, **kw):
            self.calls.append(tuple(kw["cp_axes"]))
            return real(*a, **kw)
        monkeypatch.setattr(attn, "_knn_decode_attention_cp", spy)


@pytest.mark.parametrize("case", ["model", "long"])
def test_knn_attention_under_a_mesh_matches_reference(ref, case, monkeypatch):
    """A (4,) "model" mesh with the default rules (cp_seq -> model), and a
    (2, 2) mesh with long_500k's cell rules (cp_seq -> (data, model)):
    both take the context-parallel path over 4 logical CPU shards."""
    spy = _Spy(monkeypatch)
    a = [torch.from_numpy(np.asarray(x)) for x in _attn_inputs()]
    kw = dict(k=AK, recall_target=0.95, kv_groups=AH // AKV)
    if case == "model":
        mesh, rules, axes = make_mesh((4,), ("model",), devices=["cpu"] * 4), None, ("model",)
    else:
        mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
        rules = ss.cell_rules(port_configs.get_config(LM), port_configs.SHAPES["long_500k"],
                              mesh)
        axes = ("data", "model")
    with sharding.use_mesh(mesh, rules=rules):
        out = attn.knn_decode_attention(*a, **kw)
    assert spy.calls == [axes]
    np.testing.assert_allclose(out.numpy(), ref[case], rtol=1e-5, atol=1e-5)


def test_knn_decode_step_under_long_500k_rules_matches_reference(ref, monkeypatch):
    """The smoke model's kNN decode step (f32) under ``use_mesh`` of a
    logical (1, 4) mesh with long_500k's rules: every attention layer takes
    the §7 path; logits within 1e-4 of the largest |logit| of the
    reference's under 4 fake devices, the greedy tokens equal."""
    spy = _Spy(monkeypatch)
    cfg = dataclasses.replace(port_configs.get_config(LM), dtype="float32")
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(params.from_reference(ref["params"], cfg))
    ck_, cv, tokens = _lm_inputs(cfg)
    caches = [attn.KVCache(k=torch.from_numpy(ck_[i].copy()),
                           v=torch.from_numpy(cv[i].copy()))
              for i in range(cfg.num_layers)]
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    step = M.make_decode_step(cfg, use_knn=True, sample="greedy")
    with sharding.use_mesh(mesh, rules=ss.cell_rules(cfg, port_configs.SHAPES["long_500k"],
                                                     mesh)):
        tok, logits, _ = step(model, torch.from_numpy(tokens), caches, LM_POS, None)
    assert spy.calls == [("model",)] * cfg.num_layers
    rtok, rlogits = ref["lm"]
    err = np.abs(logits.numpy() - rlogits).max()
    assert err <= 1e-4 * np.abs(rlogits).max(), err
    np.testing.assert_array_equal(tok.numpy(), rtok)
