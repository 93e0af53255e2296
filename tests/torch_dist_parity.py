"""Training across processes against the reference's GSPMD partition.

The helpers of ``tests/test_torch_distributed*.py``.  A case is a smoke
config (an f32 variant by default), a ``(data, model)`` mesh and a few
steps over ``SyntheticTokenSource``'s global batches (seed 1), possibly
with a label mask that differs across the batch's rows (so across the
data ranks).  Its reference runs in one subprocess on 4 fake host
devices (:func:`reference`): ``init_train_state`` from
``PRNGKey(seed)``, the state placed by the sanitized
``train_state_shardings`` and the step jitted with
``in_shardings=(state_sh, None)`` under ``use_mesh``, as
``src/repro/launch/train.py`` steps; it publishes every case's initial
parameters, losses, grad norms and final parameters at once.  The port
runs the same cases in processes spawned over gloo with a ``file://``
store, one thread a rank (:func:`spawn`): each rank loads the
reference's initial parameters into a whole state, places it
(``parallel.sharding.place``: its shard), steps on its rows of each
batch and gathers the final parameters to rank 0.

Nothing here imports JAX at module level: the spawned ranks import this
module.
"""
import dataclasses
import os
import pickle

import numpy as np

MESHES = {"dp": (4, 1), "dp2": (2, 1), "tp2": (1, 2), "tp22": (2, 2),
          "tp4": (1, 4), "one": (1, 1)}
LR = 1e-3
STEPS = 3
# f32 cases: the tolerances of tests/torch_train_parity.py::check_f32_step;
# the config's own dtype (bf16 compute): check_bf16_step's
F32_RTOL, F32_ATOL = 1e-5, 1e-6
# parameters whose gradient fell below this (and was not 0) at some step
# are left out (check_f32_step's floor: AdamW's update there follows
# rounding error)
GRAD_FLOOR = 1e-6
BF16_RTOL = 2e-2


def case(arch, mesh, *, dtype="float32", seq=32, batch=4, grad_dtype=None,
         mask=False, seed=3, device="cpu", fsdp=False, remat=None,
         microbatches=1, partial_grads=False, override=None):
    """One run: ``arch`` at ``dtype`` (None: the config's own) on a
    ``mesh`` of ``MESHES`` of ranks on ``device``, ``batch`` x ``seq``
    tokens a step in ``microbatches`` parts; ``fsdp`` sets the config's
    ``fsdp_params`` (the embed dim over the data axis: ZeRO-3), ``remat``
    its remat policy (None: the config's own); ``partial_grads`` holds the
    first step's reduced gradients of the layout's ``partial`` leaves
    against the whole model's on the global batch and across the ranks
    (:func:`_partial_check`); ``override`` (field -> value) replaces
    other fields of the config, alike in both packages."""
    return dict(arch=arch, mesh=MESHES[mesh], dtype=dtype, seq=seq, batch=batch,
                grad_dtype=grad_dtype, mask=mask, seed=seed, device=device,
                fsdp=fsdp, remat=remat, microbatches=microbatches,
                partial_grads=partial_grads, override=override)


def config(module, c):
    """The case's config of ``module``'s registry (the reference's or the
    port's), with the case's dtype, ``fsdp_params``, remat and
    ``override``."""
    cfg = module.get_config(c["arch"])
    if c.get("override"):
        cfg = dataclasses.replace(cfg, **c["override"])
    if c["dtype"]:
        cfg = dataclasses.replace(cfg, dtype=c["dtype"])
    if c.get("fsdp"):
        cfg = dataclasses.replace(cfg, fsdp_params=True)
    if c.get("remat"):
        cfg = dataclasses.replace(cfg, remat=c["remat"])
    return cfg


def batch_of(source_cls, cfg, c, step):
    """The global batch of ``step``; with ``mask``, row r's first
    ``r * seq // batch`` labels are -1 (every data rank a different
    count)."""
    src = source_cls(cfg.vocab_size, c["seq"], c["batch"], seed=1,
                     input_mode=cfg.input_mode if not cfg.is_encoder_decoder
                     else "tokens",
                     d_model=cfg.d_model,
                     enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
                     mrope=cfg.mrope)
    b = src.batch(step)
    if c["mask"]:
        labels = b["labels"].copy()
        for r in range(labels.shape[0]):
            labels[r, : r * c["seq"] // c["batch"]] = -1
        b["labels"] = labels
    return b


# -- the reference, in a subprocess on 4 fake devices -------------------------


def _reference_case(c):
    import jax
    import jax.numpy as jnp

    import repro.configs as rc
    from repro.data.pipeline import SyntheticTokenSource
    from repro.launch import shardspecs as SS
    from repro.models import model as M
    from repro.parallel.sharding import use_mesh

    cfg = config(rc, c)
    shape = c["mesh"]
    devices = np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    mesh = jax.sharding.Mesh(devices, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with use_mesh(mesh):
        state = jax.jit(M.init_train_state, static_argnums=1)(
            jax.random.PRNGKey(c["seed"]), cfg)
        init = jax.tree.map(np.asarray, state.params)
        sh = SS.sanitize_tree(SS.train_state_shardings(cfg, mesh),
                              jax.eval_shape(lambda: state), mesh)
        state = jax.tree.map(jax.device_put, state, sh)
        step = jax.jit(M.make_train_step(cfg, learning_rate=LR,
                                         grad_dtype=c["grad_dtype"],
                                         microbatches=c.get("microbatches", 1)),
                       in_shardings=(sh, None), out_shardings=(sh, None),
                       donate_argnums=(0,))
        losses, norms = [], []
        for i in range(STEPS):
            b = {k: jnp.asarray(v)
                 for k, v in batch_of(SyntheticTokenSource, cfg, c, i).items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return dict(init=init, losses=losses, grad_norms=norms,
                final=jax.tree.map(np.asarray, state.params))


def reference_run(cases):
    """Every case's reference results, by key (run in the child)."""
    return {key: _reference_case(c) for key, c in cases.items()}


_CHILD = """
import sys
sys.path.insert(0, "tests")
import torch_dist_parity
publish(torch_dist_parity.reference_run(@CASES@))
"""


def reference(cases):
    """:func:`reference_run` in one subprocess on 4 fake host devices."""
    from conftest import FakeDeviceRunner

    return FakeDeviceRunner()(_CHILD.replace("@CASES@", repr(cases)), n=4,
                              timeout=900)


# -- the port, in spawned ranks ------------------------------------------------


def _rank_main(rank, world, store, fn, payload, out, backend):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if backend == "nccl":  # a card a rank, gloo beside it for host tensors
        backend = "cpu:gloo,cuda:nccl"
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = fn(rank, payload)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)


def spawn(world, fn, payload, tmp, backend="gloo"):
    """``fn(rank, payload)`` on ``world`` spawned ranks under a process
    group of ``backend`` (a ``file://`` store in ``tmp``); returns rank
    0's result."""
    import torch.multiprocessing as mp

    store = os.path.join(tmp, f"store{world}")
    out = os.path.join(tmp, f"rank0_{world}.pkl")
    for path in (store, out):
        if os.path.exists(path):
            os.remove(path)
    mp.spawn(_rank_main, args=(world, store, fn, payload, out, backend),
             nprocs=world)
    with open(out, "rb") as f:
        return pickle.load(f)


def _gradients(state, cfg, batch, specs, pm):
    """The step's reduced gradients, gathered whole (numpy, by name)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.parallel import distributed as D

    model = state.params
    named = list(model.named_parameters())
    M.loss_fn(model, cfg, batch).backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for _, p in named]
    for _, p in named:
        p.grad = None
    grads = model.layout.reduce_gradients([n for n, _ in named], grads)
    return {n: D.gather_full(g, specs[n].spec, pm).cpu().numpy()
            for (n, _), g in zip(named, grads)}


def _whole_gradients(model, cfg, batch):
    """The gradients of a whole model's loss on ``batch`` (numpy, by
    name), the parameters' ``grad`` cleared after."""
    import torch

    from repro_torch.models import model as M

    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    M.loss_fn(model, cfg, batch).backward()
    out = {}
    for n, p in model.named_parameters():
        out[n] = p.grad.numpy().copy()
        p.grad = None
    return out


def _partial_check(names, grads, whole):
    """The reduced gradients of ``names`` (gathered whole on each rank):
    whether every rank holds the same values bit for bit, and each leaf's
    largest difference from the whole model's gradient ``whole``,
    relative to that gradient's largest magnitude."""
    import torch.distributed as dist

    mine = {n: grads[n] for n in names}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    equal = all(np.array_equal(other[n], mine[n]) for other in every for n in names)
    err = {n: float(np.max(np.abs(mine[n] - whole[n])) / np.max(np.abs(whole[n])))
           for n in names}
    return dict(names=sorted(names), equal=equal, err=err)


def _port_case(c, init):
    """One case on this rank: the reference's initial parameters (or,
    with ``init`` None, the port's from a CPU generator seeded with the
    case's seed) placed by the sanitized specs, ``STEPS`` steps; the
    losses, grad norms and the final parameters gathered whole, and
    where a parameter's or a moment's local shape differs from its
    spec's."""
    import torch

    import repro_torch.configs as pc
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.models import params
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import place, use_mesh

    cfg = config(pc, c)
    pm = D.init_process_mesh(c["mesh"][1], device=c["device"], backend="gloo")
    assert tuple(pm.shape.values()) == c["mesh"], (pm.shape, c["mesh"])
    with use_mesh(pm):
        sh = SS.train_state_specs(cfg, pm)
        state = M.init_train_state(torch.Generator().manual_seed(c["seed"]), cfg,
                                   device="cpu")
        if init is None:
            whole = {n: p.detach().clone()
                     for n, p in state.params.named_parameters()}
        else:
            whole = params.from_reference(init, cfg)
        with torch.no_grad():
            for name, p in state.params.named_parameters():
                p.copy_(whole[name])
        whole_grads = (_whole_gradients(state.params, cfg,
                                        batch_of(SyntheticTokenSource, cfg, c, 0))
                       if c.get("partial_grads") else None)
        state = place(state, sh)
        bad = []
        for tree, specs in ((dict(state.params.named_parameters()), sh.params),
                            (state.opt_state.m, sh.opt_state.m),
                            (state.opt_state.v, sh.opt_state.v)):
            for name, t in tree.items():
                want = D.local_shape(whole[name].shape, specs[name].spec, pm)
                if tuple(t.shape) != want:
                    bad.append((name, tuple(t.shape), want))
        step = M.make_train_step(cfg, learning_rate=LR, grad_dtype=c["grad_dtype"],
                                 microbatches=c.get("microbatches", 1))
        losses, norms, small, collectives, partial = [], [], None, [], None
        for i in range(STEPS):
            b = D.local_batch(batch_of(SyntheticTokenSource, cfg, c, i), pm)
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(pm.device)
                 for k, v in b.items()}
            grads = _gradients(state, cfg, b, sh.params, pm)
            if i == 0 and whole_grads is not None:
                partial = _partial_check(state.params.layout.partial, grads,
                                         whole_grads)
            small = {n: ((np.abs(g) < GRAD_FLOOR) & (g != 0))
                     | (small[n] if small else False) for n, g in grads.items()}
            D.reset_collectives()
            state, m = step(state, b)
            collectives.append({k: v["calls"] for k, v in D.reset_collectives().items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        final = {n: D.gather_full(p.detach(), sh.params[n].spec, pm).cpu().numpy()
                 for n, p in state.params.named_parameters()}
    layout = state.params.layout
    return dict(losses=losses, grad_norms=norms, final=final, small=small,
                bad_shapes=bad, collectives=collectives, partial_grads=partial,
                shapes={n: tuple(p.shape) for n, p in state.params.named_parameters()},
                tp=repr(state.params.tp), split=sorted(layout.split),
                partial=sorted(layout.partial), data_split=sorted(layout.data_split))


def _draw_case(c):
    """The state drawn by shards (``init_train_state(..., shardings=)``)
    against the whole draw placed (``place``), from one CPU generator
    seed: whether every parameter and moment is equal bit for bit, at
    the same local shape, and the names the data axis cuts."""
    import torch

    import repro_torch.configs as pc
    from repro_torch.launch import shardspecs as SS
    from repro_torch.models import model as M
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import place, use_mesh

    cfg = config(pc, c)
    pm = D.init_process_mesh(c["mesh"][1], device=c["device"], backend="gloo")
    with use_mesh(pm):
        sh = SS.train_state_specs(cfg, pm)
        drawn = M.init_train_state(torch.Generator().manual_seed(c["seed"]), cfg,
                                   shardings=sh)
        placed = place(M.init_train_state(torch.Generator().manual_seed(c["seed"]),
                                          cfg, device="cpu"), sh)
    unequal = []
    for tree in ("params", "m", "v"):
        a, b = ((dict(s.params.named_parameters()) if tree == "params"
                 else getattr(s.opt_state, tree)) for s in (drawn, placed))
        assert a.keys() == b.keys()
        unequal += [(tree, n) for n in a if a[n].shape != b[n].shape
                    or not torch.equal(a[n], b[n])]
    layout = drawn.params.layout
    return dict(unequal=unequal, count=len(sh.params),
                shapes={n: tuple(p.shape) for n, p in drawn.params.named_parameters()},
                split=sorted(layout.split), data_split=sorted(layout.data_split),
                tp=repr(drawn.params.tp))


def port_cases(rank, payload):
    """Every case of ``payload`` (key -> (case, initial parameters)) on
    this rank, in order."""
    return {key: _draw_case(c) if c.get("check") == "draw" else _port_case(c, init)
            for key, (c, init) in payload.items()}


def port(cases, ref, tmp):
    """Each case's port results: the cases grouped by their world size,
    one spawn a world size."""
    out = {}
    worlds = sorted({c["mesh"][0] * c["mesh"][1] for c in cases.values()})
    for world in worlds:
        payload = {k: (c, ref[k]["init"] if k in ref else None)
                   for k, c in cases.items()
                   if c["mesh"][0] * c["mesh"][1] == world}
        out.update(spawn(world, port_cases, payload, tmp))
    return out


def _operator_case(op, tp, pm, gen):
    """One operator of ``parallel.tensor_parallel`` on this rank's cut of
    whole inputs drawn from ``gen`` (the same on every rank), against
    the whole computation under autograd: the largest differences of
    its output and of each input's gradient from the whole's cut.  The
    loss is each rank's part weighted by coefficients of its own, so the
    whole's gradient sums every rank's."""
    import torch

    from repro_torch.parallel import tensor_parallel as TP

    n, r = tp.size, tp.rank
    b, s, w = 2, 3, 8 * n

    def draw(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).float()

    cut = slice(r * w // n, (r + 1) * w // n)
    if op == "sum_squares":  # an RMS norm over a split last dim
        x, c = draw(b, s, w), draw(b, s, w)
        whole = {"x": x.clone().requires_grad_()}
        xw = whole["x"]
        want = xw * torch.rsqrt(torch.mean(xw * xw, -1, keepdim=True) + 1e-5)
        (c * want).sum().backward()
        mine = {"x": x[..., cut].clone().requires_grad_()}
        xr = mine["x"]
        got = xr * torch.rsqrt(TP.sum_squares(xr, tp) / w + 1e-5)
        (c[..., cut] * got).sum().backward()
        want, cuts = want[..., cut], {"x": (Ellipsis, cut)}
    elif op == "reduce_scatter":  # a matmul over a split contraction dim
        x, m, c = draw(b, s, w), draw(w, w), draw(b, s, w)
        whole = {"x": x.clone().requires_grad_(), "w": m.clone().requires_grad_()}
        want = whole["x"] @ whole["w"]
        (c * want).sum().backward()
        mine = {"x": x[..., cut].clone().requires_grad_(),
                "w": m[cut].clone().requires_grad_()}
        got = TP.reduce_scatter_to_model(mine["x"] @ mine["w"], tp)
        (c[..., cut] * got).sum().backward()
        want, cuts = want[..., cut], {"x": (Ellipsis, cut), "w": (cut,)}
    else:  # "gather": a leaf's cuts made whole, each rank's loss its own
        t, cs = draw(5, w), [draw(5, w) for _ in range(n)]
        whole = {"t": t.clone().requires_grad_()}
        want = whole["t"]
        sum((ci * want).sum() for ci in cs).backward()
        mine = {"t": t[:, cut].clone().requires_grad_()}
        got = TP.gather_from_model(mine["t"], 1, tp)
        (cs[r] * got).sum().backward()
        cuts = {"t": (slice(None), cut)}
    return dict(forward=float((got - want).detach().abs().max()),
                grads={k: float((mine[k].grad - whole[k].grad[cuts[k]]).abs().max())
                       for k in mine})


def operator_checks(rank, payload):
    """Each operator of ``payload`` (:func:`_operator_case`) on a (1, n)
    mesh of the CPU: every rank's errors, by operator."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel import tensor_parallel as TP

    pm = D.init_process_mesh(dist.get_world_size(), device="cpu")
    tp = TP.TensorParallel(pm, get_config("internlm2-1.8b-smoke"), kv_sharded=True)
    gen = torch.Generator().manual_seed(5)
    mine = {op: _operator_case(op, tp, pm, gen) for op in payload}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _close(a, b):
    """Where ``a`` is within the f32 tolerances of ``b``."""
    return np.abs(a - b) <= F32_ATOL + F32_RTOL * np.abs(b)


def check(key, c, got, want, witness=None):
    """The port's run against the reference's: every step's loss and grad
    norm, and the final parameters where every step's gradient is at
    least ``GRAD_FLOOR`` (f32; the bf16 config at its loss and grad-norm
    tolerance only, as ``check_bf16_step``).

    ``witness``: the reference's run of the same case on another number
    of devices.  An entry outside the tolerance of ``want`` where the two
    reference runs differ is held to the witness instead (the reference's
    own f32 rounding moves it).  Returns those entries, as
    ``(name, index)``."""
    import repro_torch.configs as pc
    from repro_torch.models import params

    assert not got["bad_shapes"], got["bad_shapes"]
    rtol = F32_RTOL if c["dtype"] == "float32" else BF16_RTOL
    for name in ("losses", "grad_norms"):
        assert np.all(np.isfinite(got[name])), (key, name, got[name])
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   err_msg=f"{key} {name}")
    if c["dtype"] != "float32":
        return []
    ref = params.from_reference(want["final"], config(pc, c))
    other = (None if witness is None
             else params.from_reference(witness["final"], config(pc, c)))
    assert set(ref) == set(got["final"])
    left_out, total, held = 0, 0, []
    for name, p in got["final"].items():
        keep = ~got["small"][name]
        left_out += int((~keep).sum())
        total += keep.size
        target = ref[name].numpy()
        if other is not None:
            second = other[name].numpy()
            apart = keep & ~_close(p, target) & (second != target)
            held += [(name, tuple(int(i) for i in at)) for at in np.argwhere(apart)]
            target = np.where(apart, second, target)
        np.testing.assert_allclose(p[keep], target[keep],
                                   rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=f"{key} {name}")
    print(f"{key}: {left_out} of {total} entries with 0 < |grad| < "
          f"{GRAD_FLOOR} at some step left out; held to the witness: {held}")
    return held


# -- trainer states and checkpoints ------------------------------------------------


def trainer_meshes(rank, payload):
    """On 4 ranks, ``payload`` ``(arch, argv, root)``: the trainer with
    ``argv`` on (2, 2), checkpointing into ``root`` at steps 1 and 2; then
    the step-1 checkpoint restored as (4, 1) shards, gathered."""
    import torch

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import shardspecs as SS
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.parallel import distributed as D
    from repro_torch.parallel.sharding import use_mesh

    arch, argv, root = payload
    out = train.main(argv + ["--model-parallel", "2", "--ckpt-dir", root])
    a = dict(mesh=tuple(out["mesh"].shape.values()), tp=repr(out["state"].params.tp),
             state=state_numpy(out["state"]), losses=out["losses"])
    pm = D.init_process_mesh(1, device="cpu")
    cfg = get_config(arch)
    with use_mesh(pm):
        sh = SS.train_state_specs(cfg, pm)
        like = M.init_train_state(torch.Generator().manual_seed(9), cfg,
                                  shardings=sh)
        state, at = restore_checkpoint(root, like, step=1, shardings=sh)
    return dict(a=a, on_41=dict(at=at, state=state_numpy(state),
                                mesh=tuple(pm.shape.values())))


def check_checkpoint_meshes(arch, argv, root, tp_has):
    """``arch`` trained by :func:`trainer_meshes` (its ``repr(tp)`` holds
    ``tp_has``): the step-1 checkpoint restores bit for bit on (4, 1) and
    in one process, and the reference reads the step-2 checkpoint as the
    (2, 2) run's gathered state."""
    import torch

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    out = spawn(4, trainer_meshes, (arch, argv, root), root)
    a, on_41 = out["a"], out["on_41"]
    assert a["mesh"] == (2, 2) and tp_has in a["tp"] and len(a["losses"]) == 2
    assert on_41["mesh"] == (4, 1) and on_41["at"] == 1
    want = saved_state(root, 1, arch)
    assert want.keys() == on_41["state"].keys()
    for k, v in want.items():
        assert np.array_equal(on_41["state"][k], v), k
    like = M.init_train_state(torch.Generator().manual_seed(9), get_config(arch),
                              device="cpu")
    state, at = restore_checkpoint(root, like, step=1)
    assert at == 1 and state.params.layout is None
    here = state_numpy(state)
    for k, v in want.items():
        assert np.array_equal(here[k], v), k
    # the reference reads the last checkpoint as the gathered state
    at, got = reference_checkpoint(root, arch)
    assert at == 2
    assert got.keys() == a["state"].keys()
    for k, v in a["state"].items():
        assert np.array_equal(got[k], v), k


def state_numpy(state):
    """A trainer state's parameters and moments whole (numpy, the shards
    gathered on a process mesh), keyed ``p:``/``m:``/``v:`` + name."""
    from repro_torch.parallel import distributed as D

    layout = state.params.layout
    out = {}
    for prefix, tensors in (("p", dict(state.params.named_parameters())),
                            ("m", state.opt_state.m), ("v", state.opt_state.v)):
        for name, t in tensors.items():
            t = t.detach()
            if layout is not None:
                t = D.gather_full(t, layout.specs[name], layout.mesh)
            out[f"{prefix}:{name}"] = t.numpy().copy()
    return out


def saved_state(directory, step, arch):
    """The arrays of ``arch``'s checkpoint of ``step`` in ``directory``
    (the reference's paths) by :func:`state_numpy`'s keys."""
    from repro_torch.checkpoint.checkpoint import _reference_paths
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    cfg = get_config(arch)
    names = list(tfm.model_axes(cfg))
    paths = _reference_paths(names, cfg)
    out = {}
    for prefix, tag in ((".params", "p"), (".opt_state/.m", "m"),
                        (".opt_state/.v", "v")):
        for name in names:
            path, j = paths[name]
            arr = arrays[f"{prefix}/{path}"]
            out[f"{tag}:{name}"] = arr if j is None else arr[j]
    return out


def reference_checkpoint(directory, arch):
    """The reference's ``restore_checkpoint`` of the last checkpoint in
    ``directory`` (``arch``'s state): its step and its arrays by
    :func:`state_numpy`'s keys."""
    import jax

    import repro.configs as rc
    from repro.checkpoint import checkpoint as ref_ck
    from repro.models import model as ref_model
    from repro_torch.configs import get_config
    from repro_torch.models import params

    like = jax.eval_shape(lambda: ref_model.init_train_state(
        jax.random.PRNGKey(0), rc.get_config(arch)))
    state, at = ref_ck.restore_checkpoint(directory, like)
    assert int(state.step) == at
    out = {}
    for prefix, tree in (("p", state.params), ("m", state.opt_state.m),
                         ("v", state.opt_state.v)):
        for name, t in params.from_reference(jax.tree.map(np.asarray, tree),
                                             get_config(arch)).items():
            out[f"{prefix}:{name}"] = t.numpy()
    return at, out
