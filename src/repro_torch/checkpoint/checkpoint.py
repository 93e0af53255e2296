"""Fault-tolerant checkpointing: atomic training-step directories, an
async writer, and named snapshots (one logical state in a directory).

Port of ``src/repro/checkpoint/checkpoint.py`` with its on-disk formats,
so that either package reads what the other writes.

Training checkpoints (:func:`save_checkpoint`, :func:`latest_step`,
:func:`restore_checkpoint`, :class:`AsyncCheckpointer`)::

  <dir>/step_00000123.tmp/   -> written, then renamed to
  <dir>/step_00000123/       (rename is the commit point)
      arrays.npz           flat {path: np.ndarray} of the full state
      META.json            {"step": int, "leaf_paths": [...]}

A state is written in the reference's layout: a port
``models.model.TrainState`` becomes ``.step``, ``.params/...`` and
``.opt_state/.m|.v/...`` with each run of layers stacked
(``params.to_reference``), the paths ``jax.tree_util.keystr`` spells
(``.params/['layers']/[0]/['attn']/['wq']``), dict keys in sorted order,
as the reference flattens its pytree.

Under a process mesh (``parallel.distributed``: one process a device)
a state is a rank's shard.  Saving gathers every leaf whole over each
axis that cuts it, ``"model"`` and, for a ZeRO-3 state, the data axis
(host tensors: gloo, also beside NCCL), and rank 0 writes it; every rank
calls the save.  Restoring reads the whole arrays on every rank and
keeps each rank's shard, as the reference's restore with ``shardings=``
does, so a checkpoint written under one mesh resumes under another, in
a single process, or as ZeRO-3 shards (a rank then holds the whole
arrays on the host for a moment: the limit for a model whose state
does not fit one host).

Named snapshots (``save_snapshot``/``load_snapshot``) keep
``arrays.npz`` plus ``META.json`` (its ``array_dtypes`` names each
array's logical dtype), bf16 stored as its 16-bit pattern (numpy has no
bf16), so that a snapshot written by either package loads in the other.
Arrays are written from tensors or numpy arrays; :func:`load_snapshot`
returns numpy arrays, and a bf16 array as a CPU ``torch.bfloat16``
tensor.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import place
from repro_torch.search import faults

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "AsyncCheckpointer",
    "save_snapshot",
    "load_snapshot",
]


# -- training checkpoints ----------------------------------------------------


def _is_train_state(state) -> bool:
    from repro_torch.models.transformer import Transformer

    return (hasattr(state, "_fields") and "params" in state._fields
            and isinstance(state.params, Transformer))


def _layout(state):
    """A TrainState's shard layout (``Transformer.layout``), or None."""
    return state.params.layout if _is_train_state(state) else None


def _lead(state) -> bool:
    """Whether this process writes ``state``: rank 0 of a process mesh,
    or the only process."""
    layout = _layout(state)
    return layout is None or layout.mesh.rank == 0


def _whole(tensors, layout):
    """A dict of a shard's tensors gathered whole (on the host) over
    every axis that cuts each."""
    from repro_torch.parallel.distributed import gather_full

    return {k: gather_full(t.detach().cpu(), layout.specs[k], layout.mesh)
            for k, t in tensors.items()}


def _reference_tree(state):
    """``state`` in the reference's layout: a port TrainState with its
    model and moments restacked per run (a shard's gathered whole first:
    a collective, every rank calls it); any other tree as it is."""
    if not _is_train_state(state):
        return state
    from repro_torch.models.params import to_reference
    from repro_torch.optim.adamw import AdamWState

    cfg = state.params.cfg
    params = {k: v.detach() for k, v in state.params.state_dict().items()}
    m, v = state.opt_state.m, state.opt_state.v
    layout = _layout(state)
    if layout is not None:
        params, m, v = (_whole(t, layout) for t in (params, m, v))
    return type(state)(
        step=state.step,
        params=to_reference(params, cfg),
        opt_state=AdamWState(m=to_reference(m, cfg), v=to_reference(v, cfg)),
    )


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order and spelling: a named
    tuple's fields ``.name``, dict keys sorted as ``['key']``, sequence
    items ``[i]``, joined by ``/``; None is an empty subtree."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], join(f"[{k!r}]"))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, join(f"[{i}]"))]
    return [(prefix, tree)]


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array (a bf16 tensor widened to f32: npz
    has no bf16; a restore casts it back to the target's dtype); with
    ``copy`` never a view of the leaf's memory."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        elif copy and leaf.device.type == "cpu":
            leaf = leaf.clone()
        return leaf.cpu().numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _to_host(tree):
    """The reference-layout tree with every leaf copied to a host numpy
    array."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return _host(tree, copy=True)


def save_checkpoint(directory: str, step: int, state) -> str:
    """Synchronous atomic save of ``state`` (a port TrainState, or a tree
    of named tuples, dicts, lists and arrays/tensors) in the reference's
    layout.  Returns the committed path.  A shard on a process mesh is
    gathered (every rank calls this) and rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    tree = _reference_tree(state)
    if not _lead(state):
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten_with_paths(tree)
    arrays = {k: _host(v) for k, v in leaves}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump({"step": step, "leaf_paths": [k for k, _ in leaves]}, f)
    # Commit.
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under ``directory`` (``.tmp`` and
    directories without ``META.json`` do not count), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            meta = os.path.join(directory, name, "META.json")
            if os.path.exists(meta):  # only committed checkpoints count
                steps.append(int(name[5:]))
    return max(steps) if steps else None


@torch.no_grad()
def _fill(like, arrays, prefix: str = ""):
    """``like`` with each leaf restored from ``arrays`` (path -> array):
    a tensor copied into in place, a numpy leaf replaced."""
    if like is None:
        return None
    if hasattr(like, "_fields"):
        return type(like)(*(_fill(getattr(like, f), arrays, _join(prefix, f".{f}"))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _fill(v, arrays, _join(prefix, f"[{k!r}]"))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, arrays, _join(prefix, f"[{i}]"))
                          for i, v in enumerate(like))
    arr = arrays[prefix]
    if isinstance(like, torch.Tensor):
        _copy_in(like, arr, prefix)
        return like
    if hasattr(like, "dtype") and arr.dtype != like.dtype:
        arr = arr.astype(like.dtype)
    return arr


def _join(prefix: str, part: str) -> str:
    return f"{prefix}/{part}" if prefix else part


def _copy_in(target: torch.Tensor, arr, path: str) -> None:
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{path}: checkpoint shape {tuple(arr.shape)} != "
                         f"{tuple(target.shape)}")
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    target.copy_(arr.to(target.dtype))


def _reference_paths(names, cfg):
    """Each port parameter name -> (its reference path under ``.params``,
    its index in the run's stack or None)."""
    from repro_torch.models.transformer import runs_of

    run_of = []
    for r, (_, count) in enumerate(runs_of(cfg)):
        run_of += [(r, j) for j in range(count)]

    def spell(parts):
        return "/".join(f"[{p!r}]" for p in parts)

    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            r, j = run_of[int(parts[1])]
            out[name] = (f"['layers']/[{r}]/" + spell(parts[2:]), j)
        elif parts[0] == "encoder":
            out[name] = ("['encoder']/" + spell(parts[2:]), int(parts[1]))
        else:
            out[name] = (spell(parts), None)
    return out


@torch.no_grad()
def _restore_train_state(like, arrays):
    model = like.params
    paths = _reference_paths([n for n, _ in model.named_parameters()],
                             model.cfg)
    targets = [(".params", dict(model.named_parameters())),
               (".opt_state/.m", like.opt_state.m),
               (".opt_state/.v", like.opt_state.v)]
    layout = model.layout
    for prefix, tensors in targets:
        for name, t in tensors.items():
            path, j = paths[name]
            key = f"{prefix}/{path}"
            arr = arrays[key] if j is None else arrays[key][j]
            if layout is not None:  # the whole array: keep the rank's shard
                from repro_torch.parallel.distributed import local_shard

                arr = local_shard(torch.from_numpy(np.ascontiguousarray(arr)),
                                  layout.specs[name], layout.mesh)
            _copy_in(t, arr, key)
    return like._replace(step=torch.as_tensor(arrays[".step"], dtype=torch.int32))


def restore_checkpoint(directory: str, like, step: Optional[int] = None,
                       shardings=None):
    """Restore the checkpoint of ``step`` (default the latest committed
    one) into the structure of ``like``; returns ``(state, step)``.

    ``like`` is a port TrainState (its model's parameters and its moments
    are overwritten in place, on their devices; the returned state holds
    them and a new step) or a tree of tensors (copied into in place) and
    numpy arrays (replaced).  The checkpoint may come from either
    package; each array is cast to the dtype of its target.

    ``shardings``: a matching tree of ``parallel.sharding.NamedSharding``
    (``launch.shardspecs.train_state_shardings``).  ``like`` is placed on
    their devices first (``parallel.sharding.place``) and the arrays are
    copied there straight from the file: the elastic-restart path onto
    another mesh.  On a process mesh every rank reads the whole arrays
    and keeps its shard (a ``like`` placed already stays as it is)."""
    if shardings is not None and _layout(like) is None:
        like = place(like, shardings)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    if _is_train_state(like):
        return _restore_train_state(like, arrays), step
    return _fill(like, arrays), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at-most-one in flight.

    ``save`` copies the state to host memory synchronously (the only part
    that blocks the train loop) and commits it on the worker thread;
    ``wait()`` joins outstanding work (call before exit).  The ``keep``
    newest committed steps survive each save.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def save(self, step: int, state):
        host_state = _to_host(_reference_tree(state))
        if not _lead(state):  # a shard: gathered to rank 0, which writes
            return
        self.wait()

        def worker():
            save_checkpoint(self.directory, step, host_state)
            self._gc()

        with self._lock:
            self._pending = threading.Thread(target=worker, daemon=True)
            self._pending.start()

    def wait(self):
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()

    def _gc(self):
        steps = sorted(
            int(n[5:])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


# -- named snapshots (single logical state, e.g. Index.save/restore) ---------


def _encode_array(a) -> Tuple[np.ndarray, str]:
    """npz-safe encoding: a bf16 array as its uint16 bit pattern plus the
    logical dtype name; every other dtype passes through."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _decode_array(a: np.ndarray, logical: str):
    if logical == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _fsync_dir_contents(path: str) -> None:
    for name in os.listdir(path):
        fd = os.open(os.path.join(path, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def save_snapshot(path: str, arrays: dict, meta: dict) -> str:
    """Atomically write one named snapshot directory; returns its path.

    Protocol (crash-safe at every step):
      1. write ``<path>.tmp/`` (arrays.npz + META.json), fsync the files;
      2. move any committed ``<path>`` aside to ``<path>.old``;
      3. rename ``<path>.tmp`` -> ``<path>`` — the commit point;
      4. delete ``<path>.old``.

    A crash before step 3 leaves the old snapshot committed; a crash
    between 2 and 3 leaves ``.old``, which :func:`load_snapshot` falls
    back to.  The ``checkpoint.commit`` fault point fires between 1 and 2.
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp, old = path + ".tmp", path + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    encoded, logical = {}, {}
    for key, value in arrays.items():
        encoded[key], logical[key] = _encode_array(value)
    meta = dict(meta, array_dtypes=logical)
    np.savez(os.path.join(tmp, "arrays.npz"), **encoded)
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump(meta, f)
    _fsync_dir_contents(tmp)
    faults.fire("checkpoint.commit")
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)  # commit
    if os.path.exists(old):
        shutil.rmtree(old, ignore_errors=True)
    return path


def load_snapshot(path: str) -> Tuple[dict, dict]:
    """Load a committed snapshot: returns ``(meta, arrays)``.

    Falls back to ``<path>.old`` when only the aside copy exists (a crash
    between the move-aside and the commit); ``.tmp`` is never read.
    """
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, "META.json")):
        old = path + ".old"
        if os.path.exists(os.path.join(old, "META.json")):
            path = old
        else:
            raise FileNotFoundError(f"no committed snapshot at {path}")
    with open(os.path.join(path, "META.json")) as f:
        meta = json.load(f)
    logical = meta.get("array_dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {
            key: _decode_array(data[key], logical.get(key, ""))
            for key in data.files
        }
    return meta, arrays
