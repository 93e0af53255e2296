"""Re-meshing a sharded train state in place, and checkpoints a slab at a
time, across processes: the helpers of
``tests/test_torch_distributed_remesh.py``.

The port's side runs in ranks spawned over gloo
(``torch_dist_parity.spawn``), every check of the file in one spawn of 4
ranks (:func:`port_ranks`); the reference's in one subprocess on 4 fake
host devices (:func:`reference_run`).  Nothing here imports JAX at module
level: the spawned ranks import this module.
"""
import os

import numpy as np

import torch_dist_parity as P

# every ordered pair of the three meshes of 4 ranks, as one cycle
CYCLE = [(4, 1), (2, 2), (1, 4), (4, 1), (1, 4), (2, 2), (4, 1)]
# the families re-meshed: arch, fsdp_params (granite-20b's ZeRO-3)
FAMILIES = [("internlm2-1.8b-smoke", False), ("granite-20b-smoke", True),
            ("granite-moe-3b-a800m-smoke", False), ("deepseek-v2-236b-smoke", False),
            ("mamba2-2.7b-smoke", False), ("recurrentgemma-9b-smoke", False),
            ("qwen2-vl-2b-smoke", False), ("whisper-medium-smoke", False)]
# step 1 on (4, 1), then (2, 2), then step 2.  "remesh": the reference
# re-meshes with its own remesh_state; "restore": its remesh_state puts
# the unsanitized spec (granite's one kv head over a "model" axis of 2),
# which device_put refuses, so it restores its step-1 checkpoint with the
# sanitized shardings of (2, 2) instead (its elastic restart)
STEP_CASES = {"dense": (P.case("internlm2-1.8b-smoke", "dp"), "remesh"),
              "zero3": (P.case("granite-20b-smoke", "dp", fsdp=True), "restore")}
# the host-memory case: a config of 6 layers with ``fsdp_params`` on
# (2, 2), where one slab is far below half of the whole state and a
# rank's share (an async save's copy) a quarter of it
PEAK_ARCH = "internlm2-1.8b-smoke-6-layers"


def family_name(arch, fsdp):
    return arch + ("+fsdp" if fsdp else "")


# -- the reference, in a subprocess on 4 fake devices -------------------------


def _reference_case(c, how, root):
    import jax
    import jax.numpy as jnp

    import repro.configs as rc
    from repro.checkpoint import checkpoint as ref_ck
    from repro.data.pipeline import SyntheticTokenSource
    from repro.ft import elastic
    from repro.launch import shardspecs as SS
    from repro.models import model as M
    from repro.models import transformer as T
    from repro.optim.adamw import AdamWState

    from repro.parallel.sharding import use_mesh

    cfg = P.config(rc, c)

    def mesh(shape):
        devices = np.array(jax.devices()[:4]).reshape(shape)
        return jax.sharding.Mesh(devices, ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def stepped(state, m, i):
        """Step ``i`` jitted on mesh ``m``, as ``launch/train.py`` steps."""
        with use_mesh(m):
            sh = SS.sanitize_tree(SS.train_state_shardings(cfg, m),
                                  jax.eval_shape(lambda: state), m)
            fn = jax.jit(M.make_train_step(cfg, learning_rate=P.LR),
                         in_shardings=(sh, None), out_shardings=(sh, None))
            b = {k: jnp.asarray(v)
                 for k, v in P.batch_of(SyntheticTokenSource, cfg, c, i).items()}
            return fn(state, b)

    m41, m22 = mesh((4, 1)), mesh((2, 2))
    with use_mesh(m41):
        state = jax.jit(M.init_train_state, static_argnums=1)(
            jax.random.PRNGKey(c["seed"]), cfg)
        init = jax.tree.map(np.asarray, state.params)
        sh = SS.sanitize_tree(SS.train_state_shardings(cfg, m41),
                              jax.eval_shape(lambda: state), m41)
        state = jax.tree.map(jax.device_put, state, sh)
    state, m1 = stepped(state, m41, 0)
    directory = os.path.join(root, f"ref_{c['arch']}")
    ref_ck.save_checkpoint(directory, 1, state)
    if how == "remesh":
        axes = T.model_axes(cfg)
        state = elastic.remesh_state(
            state, M.TrainState(step=(), params=axes,
                                opt_state=AdamWState(m=axes, v=axes)), m22)
    else:
        with use_mesh(m22):
            like = jax.eval_shape(lambda: state)
            sh22 = SS.sanitize_tree(SS.train_state_shardings(cfg, m22), like, m22)
            state, _ = ref_ck.restore_checkpoint(directory, like, shardings=sh22)
    state, m2 = stepped(state, m22, 1)
    return dict(init=init, losses=[float(m1["loss"]), float(m2["loss"])],
                grad_norms=[float(m1["grad_norm"]), float(m2["grad_norm"])],
                checkpoint=directory)


def reference_run(cases, root):
    """Every step case's reference (run in the child): its initial
    parameters, both steps' losses and grad norms, and its step-1
    checkpoint's directory."""
    return {key: _reference_case(c, how, root) for key, (c, how) in cases.items()}


_CHILD = """
import sys
sys.path.insert(0, "tests")
import torch_remesh_parity
publish(torch_remesh_parity.reference_run(@CASES@, @ROOT@))
"""


def reference(root):
    """:func:`reference_run` of ``STEP_CASES`` in one subprocess on 4
    fake host devices."""
    from conftest import FakeDeviceRunner

    src = _CHILD.replace("@CASES@", repr(STEP_CASES)).replace("@ROOT@", repr(root))
    return FakeDeviceRunner()(src, n=4, timeout=600)


# -- the port, in 4 spawned ranks ------------------------------------------------


def _config(arch, fsdp=False, layers=None):
    import dataclasses

    import repro_torch.configs as pc

    cfg = dataclasses.replace(pc.get_config(arch), dtype="float32")
    if fsdp:
        cfg = dataclasses.replace(cfg, fsdp_params=True)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def _tensors(state):
    """A state's tensors by ``(tree, name)``."""
    out = {("p", n): p.detach() for n, p in state.params.named_parameters()}
    for tree in ("m", "v"):
        out.update({(tree, n): t for n, t in getattr(state.opt_state, tree).items()})
    return out


def _unequal(a, b):
    """The keys whose tensors differ in shape or in a bit, and a step
    that differs."""
    ta, tb = (x if isinstance(x, dict) else _tensors(x) for x in (a, b))
    out = sorted(set(ta) ^ set(tb))
    out += [k for k in ta if k in tb and (ta[k].shape != tb[k].shape
                                          or not _bits_equal(ta[k], tb[k]))]
    return out


def _bits_equal(x, y) -> bool:
    """Whether two f32 tensors hold the same bits (NaN and -0 too)."""
    import torch

    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def _whole_state(cfg, seed):
    """A whole state on the CPU: the port's draw, and moments drawn too
    (zeros would hide a moment left unmoved), at step 5."""
    import torch

    from repro_torch.models import model as M

    state = M.init_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in state.opt_state.m.values():
            t.normal_(generator=g)
        for t in state.opt_state.v.values():
            t.uniform_(generator=g)
    return state._replace(step=torch.tensor(5, dtype=torch.int32))


def _cut(whole, specs, mesh):
    """Each tensor of a whole state's :func:`_tensors` as the calling
    rank's shard under ``specs`` (``train_state_specs``)."""
    from repro_torch.parallel import distributed as D

    return {(tree, n): D.local_shard(t, specs.params[n].spec, mesh)
            for (tree, n), t in whole.items()}


def _family(arch, fsdp, root, meshes):
    """``arch``'s whole state placed on (4, 1), then re-meshed around
    :data:`CYCLE`: at each move, against the state saved on the old mesh
    and restored at the new one (``shardings=``) and against the whole
    state cut for the new mesh; and whether the result holds any mesh but
    the new one."""
    import torch

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.ft.elastic import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import place, use_mesh

    cfg = _config(arch, fsdp)
    axes = tfm.model_axes(cfg)
    specs = {k: SS.train_state_specs(cfg, pm) for k, pm in meshes.items()}
    whole_state = _whole_state(cfg, 7)
    whole = {k: t.clone() for k, t in _tensors(whole_state).items()}
    with use_mesh(meshes[CYCLE[0]]):
        state = place(whole_state, specs[CYCLE[0]])
    directory = os.path.join(root, family_name(arch, fsdp))
    moves = []
    for i, (a, b) in enumerate(zip(CYCLE, CYCLE[1:])):
        save_checkpoint(directory, i, state)
        new = remesh_state(state, axes, meshes[b])
        like = M.init_train_state(torch.Generator().manual_seed(9), cfg,
                                  shardings=specs[b])
        back, at = restore_checkpoint(directory, like, step=i, shardings=specs[b])
        model = new.params
        held = {id(model.layout.mesh), id(getattr(model.tp, "mesh", meshes[b]))}
        moves.append(dict(
            pair=(a, b), at=at, steps=(int(new.step), int(back.step)),
            vs_checkpoint=_unequal(new, back),
            vs_cut=_unequal(new, _cut(whole, specs[b], meshes[b])),
            other_mesh=held != {id(meshes[b])},
            data_split=len(model.layout.data_split), tp=model.tp is not None))
        state = new
    return moves


def _step_case(c, init, meshes):
    """The reference's initial parameters placed on (4, 1), step 1, the
    state re-meshed onto (2, 2), step 2: both steps' losses and grad
    norms and the final state gathered."""
    import torch

    import repro_torch.configs as pc
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.ft.elastic import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import params
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import place, use_mesh

    cfg = P.config(pc, c)
    state = M.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    whole = params.from_reference(init, cfg)
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            p.copy_(whole[name])
    pm41, pm22 = meshes[(4, 1)], meshes[(2, 2)]
    with use_mesh(pm41):
        state = place(state, SS.train_state_specs(cfg, pm41))
    step = M.make_train_step(cfg, learning_rate=P.LR)
    losses, norms = [], []
    for i, pm in enumerate((pm41, pm22)):
        if i:
            state = remesh_state(state, tfm.model_axes(cfg), pm)
        with use_mesh(pm):
            b = D.local_batch(P.batch_of(SyntheticTokenSource, cfg, c, i), pm)
            b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
            state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, grad_norms=norms, state=state)


def _restored(directory, arch, pm):
    """A reference checkpoint restored into a fresh shard on ``pm``,
    gathered (:func:`torch_dist_parity.state_numpy`)."""
    import torch

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import use_mesh

    cfg = _config(arch)
    with use_mesh(pm):
        sh = SS.train_state_specs(cfg, pm)
        like = M.init_train_state(torch.Generator().manual_seed(9), cfg, shardings=sh)
        state, at = restore_checkpoint(directory, like, shardings=sh)
    return dict(at=at, step=int(state.step), state=P.state_numpy(state))


def _host_peaks(root, pm):
    """The 6-layer config's whole state on (2, 2) (ZeRO-3 with tensor
    parallelism: a rank holds a quarter of most leaves): each rank's
    ``HOST_PEAK`` over a save, a restore and an async save (every wait
    with a timeout), beside its largest slab, a part of it, and the
    rank's share; the two saves' directories."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import place, use_mesh

    cfg = dataclasses.replace(_config("internlm2-1.8b-smoke", fsdp=True, layers=6),
                              name=PEAK_ARCH)
    whole_state = _whole_state(cfg, 11)
    shapes = [tuple(p.shape) for p in tfm.Transformer(cfg, device="meta").parameters()]
    whole_bytes = 3 * 4 * sum(int(np.prod(s)) for s in shapes)
    slab = 4 * max(int(np.prod(s)) for s in shapes)
    with use_mesh(pm):
        sh = SS.train_state_specs(cfg, pm)
        state = place(whole_state, sh)
    share = sum(t.numel() * t.element_size() for t in _tensors(state).values())
    part = max(t.numel() * t.element_size() for t in _tensors(state).values())
    sync_dir, async_dir = (os.path.join(root, f"peak_{x}") for x in ("sync", "async"))
    peaks = {}
    ck.reset_host_peak()
    ck.save_checkpoint(sync_dir, 1, state)
    peaks["save"] = ck.reset_host_peak()
    like = M.init_train_state(torch.Generator().manual_seed(9), cfg, shardings=sh)
    back, _ = ck.restore_checkpoint(sync_dir, like, shardings=sh)
    peaks["restore"] = ck.reset_host_peak()
    writer = ck.AsyncCheckpointer(async_dir, mesh=pm)
    writer.save(1, state)
    writer.wait(timeout=60)
    peaks["async"] = ck.reset_host_peak()
    mine = dict(rank=pm.rank, peaks=peaks, share=share, part=part,
                held=ck.HOST_PEAK["held"], restored=_unequal(back, state))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return dict(ranks=every, whole_bytes=whole_bytes, slab=slab,
                chunk=ck._CHUNK_BYTES, world=dist.get_world_size(),
                sync_dir=sync_dir, async_dir=async_dir)


def _refusal(meshes):
    """A shard re-meshed onto a mesh that is not a process mesh: the
    exception's type and message."""
    import torch

    from repro_torch.ft.elastic import remesh_state
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.mesh import make_mesh

    cfg = _config("internlm2-1.8b-smoke")
    pm = meshes[(2, 2)]
    state = M.init_train_state(torch.Generator().manual_seed(0), cfg,
                               shardings=SS.train_state_specs(cfg, pm))
    logical = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    try:
        remesh_state(state, tfm.model_axes(cfg), logical)
    except Exception as e:  # noqa: BLE001 (the refusal is the result)
        return type(e).__name__, str(e)
    return None


def port_ranks(rank, payload):
    """Every port check of the file on this rank of 4: the families
    re-meshed (:func:`_family`), the step cases on (4, 1) then (2, 2)
    with a (2, 2) checkpoint of each, the reference's checkpoints
    restored on (4, 1) and (2, 2), the host peaks and the refusal."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.parallel import distributed as D

    root, ref = payload["root"], payload["ref"]
    meshes = {(4 // mp, mp): D.init_process_mesh(mp, device="cpu") for mp in (1, 2, 4)}
    out = {"families": {family_name(a, f): _family(a, f, os.path.join(root, "fam"),
                                                   meshes)
                        for a, f in FAMILIES}}
    steps = {}
    for key, (c, _) in STEP_CASES.items():
        got = _step_case(c, ref[key]["init"], meshes)
        directory = os.path.join(root, f"port22_{key}")
        save_checkpoint(directory, 2, got["state"])
        steps[key] = dict(losses=got["losses"], grad_norms=got["grad_norms"],
                          state=P.state_numpy(got["state"]), checkpoint=directory)
    out["steps"] = steps
    dense = STEP_CASES["dense"][0]["arch"]
    out["restored"] = {shape: _restored(ref["dense"]["checkpoint"], dense, meshes[shape])
                       for shape in ((4, 1), (2, 2))}
    out["peaks"] = _host_peaks(root, meshes[(2, 2)])
    out["refusal"] = _refusal(meshes)
    return out
