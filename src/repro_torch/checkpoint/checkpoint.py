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

``arrays.npz`` is what ``np.savez`` writes (a ZIP of stored ``.npy``
entries with zip64 extras), written and read **a slab at a time**: one
unstacked leaf, or one layer's array of a stacked run (a C-order stack is
its layers' slabs back to back under one header for the whole
``(count, ...)`` shape).  A restore reads each slab at its offset in the
file through a memory map; a compressed entry, which neither package
writes, raises.  So the host holds one slab, never the state:
``HOST_PEAK`` keeps the high-water mark of the host bytes this code
holds (:func:`reset_host_peak`).

Under a process mesh (``parallel.distributed``: one process a device) a
state is a rank's shard, and every rank calls the save and the restore.
Saving gathers each slab **to rank 0 only** (``dist.gather`` over the
group of the axes that cut it, ``"model"``, the data axis of a ZeRO-3
leaf or both, on host tensors: gloo, also beside NCCL, in rounds of at
most 64 MiB a rank), and rank 0 writes it and drops it before the next:
a rank holds its part of one slab in flight, rank 0 one slab.
Restoring, each rank maps each slab, keeps its shard and drops the slab,
so a checkpoint written under one mesh resumes under another, in a
single process, or as ZeRO-3 shards (as the reference's restore with
``shardings=`` does).  :class:`AsyncCheckpointer` copies the rank's own
part to the host at ``save`` (what blocks the step) and gathers and
writes on a thread of every rank, over gloo groups of its own.

Named snapshots (``save_snapshot``/``load_snapshot``) keep
``arrays.npz`` plus ``META.json`` (its ``array_dtypes`` names each
array's logical dtype), bf16 stored as its 16-bit pattern (numpy has no
bf16), so that a snapshot written by either package loads in the other.
Arrays are written from tensors or numpy arrays; :func:`load_snapshot`
returns numpy arrays, and a bf16 array as a CPU ``torch.bfloat16``
tensor.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import struct
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import place
from repro_torch.search import faults

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "AsyncCheckpointer",
    "HOST_PEAK",
    "reset_host_peak",
    "save_snapshot",
    "load_snapshot",
]


# -- the host bytes a checkpoint holds ----------------------------------------

# ``held``: the host bytes this process's checkpoint code holds now (a
# slab mapped or gathered, a part in flight, an async save's copies);
# ``peak``: their high-water mark since :func:`reset_host_peak`
HOST_PEAK: Dict[str, int] = {"held": 0, "peak": 0}
_HOST_LOCK = threading.Lock()
# a gather's round and a written chunk of an assembled slab, at most
_CHUNK_BYTES = 64 << 20


def reset_host_peak() -> int:
    """``HOST_PEAK["peak"]`` as it stands; the mark is then reset to
    what is held now."""
    with _HOST_LOCK:
        peak = HOST_PEAK["peak"]
        HOST_PEAK["peak"] = HOST_PEAK["held"]
    return peak


def _hold(nbytes: int) -> None:
    with _HOST_LOCK:
        HOST_PEAK["held"] += nbytes
        HOST_PEAK["peak"] = max(HOST_PEAK["peak"], HOST_PEAK["held"])


def _release(nbytes: int) -> None:
    with _HOST_LOCK:
        HOST_PEAK["held"] -= nbytes


@contextlib.contextmanager
def _holding(nbytes: int):
    _hold(nbytes)
    try:
        yield
    finally:
        _release(nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else t.nbytes


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


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The stored dtype of a tensor's values: f32 for bf16 (npz has no
    bf16; a restore casts back to the target's dtype)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array (a bf16 tensor widened to f32); with
    ``copy`` never a view of the leaf's memory."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        elif copy and leaf.device.type == "cpu":
            leaf = leaf.clone()
        return leaf.cpu().numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


class _Part:
    """A slab's source in this process: ``value`` (a tensor on any
    device, its part under ``spec`` on a process mesh; or a numpy leaf)
    and the host bytes an async save's copy of it holds (``held``)."""

    __slots__ = ("value", "spec", "held")

    def __init__(self, value, spec=None):
        self.value, self.spec, self.held = value, spec, 0


class _Entry:
    """One ``.npy`` entry: its path, whole shape and stored dtype, and
    its slabs' parts in order (a stacked run's layers, or one)."""

    __slots__ = ("key", "shape", "dtype", "stacked", "parts")

    def __init__(self, key, shape, dtype, stacked, parts):
        self.key, self.shape, self.dtype = key, tuple(shape), np.dtype(dtype)
        self.stacked, self.parts = stacked, parts


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


def _train_entries(state) -> List[_Entry]:
    """A TrainState's entries in the reference's layout and flatten
    order, each slab's part one of ``state``'s tensors (a rank's shard,
    its spec beside it, on a process mesh); ``.step`` is ``state.step``.
    The shapes are the whole arrays' (a ``"meta"`` model's)."""
    from repro_torch.models.params import to_reference
    from repro_torch.models.transformer import Transformer

    model = state.params
    cfg = model.cfg
    whole = {n: tuple(p.shape)
             for n, p in Transformer(cfg, device="meta").named_parameters()}
    paths = _reference_paths(list(whole), cfg)
    layout = model.layout
    slabs: Dict[str, list] = {}
    for prefix, tensors in ((".params", dict(model.named_parameters())),
                            (".opt_state/.m", state.opt_state.m),
                            (".opt_state/.v", state.opt_state.v)):
        for name, (path, j) in paths.items():
            spec = layout.specs[name] if layout is not None else None
            slabs.setdefault(f"{prefix}/{path}", []).append(
                (j, name, _Part(tensors[name], spec)))
    skeleton = to_reference({n: torch.empty(0, device="meta") for n in whole}, cfg)
    order = _flatten_with_paths(type(state)(
        step=0, params=skeleton,
        opt_state=type(state.opt_state)(m=skeleton, v=skeleton)))
    out = []
    for key, _ in order:
        if key == ".step":
            step = np.asarray(_host(state.step))
            out.append(_Entry(key, step.shape, step.dtype, False, [_Part(step)]))
            continue
        parts = sorted(slabs[key], key=lambda s: s[0] or 0)
        j, name, first = parts[0]
        shape = whole[name] if j is None else (len(parts),) + whole[name]
        out.append(_Entry(key, shape, _np_dtype(first.value.dtype), j is not None,
                          [p for _, _, p in parts]))
    return out


def _tree_entries(tree) -> List[_Entry]:
    """Any other tree's entries: one a leaf, in the reference's order."""
    out = []
    for key, leaf in _flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            shape, dtype = tuple(leaf.shape), _np_dtype(leaf.dtype)
        else:
            a = np.asarray(leaf)
            shape, dtype = a.shape, a.dtype
        out.append(_Entry(key, shape, dtype, False, [_Part(leaf)]))
    return out


def _entries(state) -> List[_Entry]:
    return _train_entries(state) if _is_train_state(state) else _tree_entries(state)


def _bytes_of(a) -> memoryview:
    """The bytes of a contiguous array or tensor, C order."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _host_chunk(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor of ``t``'s values (bf16 widened to f32):
    ``t``'s own memory where it is one."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.to("cpu").contiguous()


def _copied(host: torch.Tensor, t: torch.Tensor) -> int:
    """The bytes of ``host`` (``_host_chunk(t)``) where it is a copy, 0
    where it is ``t``'s own memory."""
    same = (t.device.type == "cpu"
            and host.untyped_storage().data_ptr() == t.untyped_storage().data_ptr())
    return 0 if same else _nbytes(host)


class _NpzWriter:
    """``arrays.npz`` as ``np.savez`` writes it, an entry at a time:
    :meth:`entry` writes the ``.npy`` header for the entry's whole shape
    and yields the open entry, into which the caller writes the data in
    C order."""

    def __init__(self, path: str):
        self._zip = zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                                    allowZip64=True)

    @contextlib.contextmanager
    def entry(self, key: str, shape, dtype):
        with self._zip.open(key + ".npy", mode="w", force_zip64=True) as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                "fortran_order": False, "shape": tuple(int(s) for s in shape)})
            yield f

    def close(self) -> None:
        self._zip.close()


class _NpzReader:
    """An ``arrays.npz`` read a slab at a time at its offset in the file:
    an entry's ``.npy`` header from its stored data, then a memory map
    over the slab's bytes (never an entry from its start, never every
    entry)."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._zip = zipfile.ZipFile(self._file)
        self._heads: Dict[str, Tuple[int, Tuple[int, ...], np.dtype]] = {}

    def close(self) -> None:
        self._zip.close()
        self._file.close()

    def head(self, key: str) -> Tuple[int, Tuple[int, ...], np.dtype]:
        """Entry ``key``'s data offset in the file, shape and dtype."""
        if key in self._heads:
            return self._heads[key]
        try:
            info = self._zip.getinfo(key + ".npy")
        except KeyError:
            raise KeyError(f"{key}: no such array in {self.path}") from None
        if info.compress_type != zipfile.ZIP_STORED or info.flag_bits & 0x1:
            raise ValueError(
                f"{key}: a compressed or encrypted entry in {self.path}; "
                "checkpoints are written stored (as np.savez writes them) and "
                "read a slab at a time at its offset, which such an entry has not")
        self._file.seek(info.header_offset)
        local = struct.unpack(zipfile.structFileHeader,
                              self._file.read(zipfile.sizeFileHeader))
        if local[0] != zipfile.stringFileHeader:
            raise ValueError(f"{key}: a bad local header in {self.path}")
        # the local header's own name and extra-field lengths
        self._file.seek(info.header_offset + zipfile.sizeFileHeader
                        + local[10] + local[11])
        version = np.lib.format.read_magic(self._file)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read is None:
            raise ValueError(f"{key}: .npy format {version} in {self.path}")
        shape, fortran, dtype = read(self._file)
        if fortran or dtype.hasobject:
            raise ValueError(f"{key}: a Fortran-order or object array in {self.path}")
        self._heads[key] = (self._file.tell(), tuple(shape), dtype)
        return self._heads[key]

    @contextlib.contextmanager
    def slab(self, key: str, index: Optional[int] = None):
        """Entry ``key`` (or its ``index``-th slab along dim 0: a layer of
        a stacked run) as a numpy array over the file's bytes, counted in
        ``HOST_PEAK`` while the block runs."""
        offset, shape, dtype = self.head(key)
        if index is not None:
            if not shape or not 0 <= index < shape[0]:
                raise ValueError(f"{key}: no slab {index} in shape {shape}")
            shape = shape[1:]
            offset += index * math.prod(shape) * dtype.itemsize
        nbytes = math.prod(shape) * dtype.itemsize
        with _holding(nbytes):
            if not shape or not nbytes:  # a scalar, or empty: read as it is
                self._file.seek(offset)
                arr = np.frombuffer(self._file.read(nbytes), dtype=dtype)
                yield arr.reshape(shape).copy()
            else:  # copy-on-write: a writable view the file never sees
                arr = np.memmap(self.path, dtype=dtype, mode="c", offset=offset,
                                shape=shape)
                yield arr
                del arr


# -- saving --------------------------------------------------------------------


def _cut_group(spec, ndim: int, mesh) -> Tuple[list, Optional[str]]:
    """The cuts of a leaf under ``spec`` (``distributed.spec_cuts``) and
    the group its gather to rank 0 runs over: ``"model"``, ``"data"``,
    ``"world"`` (both cut), or None (nothing cuts it)."""
    from repro_torch.parallel import distributed as D

    cuts = D.spec_cuts(spec, ndim, mesh)
    axes = {axis for _, axis in cuts}
    if not axes:
        return cuts, None
    return cuts, "world" if len(axes) > 1 else axes.pop()


def _sends(spec, ndim: int, mesh) -> bool:
    """Whether the calling rank's part of a leaf under ``spec`` goes to
    rank 0: rank 0's own, or a part of a cut leaf from a rank at index 0
    of every axis that does not cut it (the others hold copies)."""
    cuts, group = _cut_group(spec, ndim, mesh)
    if group is None:
        return mesh.rank == 0
    cutting = {axis for _, axis in cuts}
    return all(mesh.axis_index(a) == 0 for a in ("data", "model")
               if a not in cutting)


@contextlib.contextmanager
def _gathered(part: torch.Tensor, spec, mesh, groups, rounds: Dict):
    """This rank's ``part`` of a slab under ``spec`` gathered to rank 0,
    which gets ``(pieces, cuts)``: each rank's part by its index along
    every cut axis (in the cuts' order), in one host buffer the size of
    the slab; every other rank gets None.  ``dist.gather`` over the cut
    axes' group of ``groups`` in rounds of at most ``_CHUNK_BYTES`` a
    rank (gloo stages a round's parts in a temporary on rank 0), each
    round's part copied to the host just before it is sent: from a card
    into one pinned buffer of a round, kept in ``rounds`` for the save's
    next slabs."""
    import torch.distributed as dist

    cuts, kind = _cut_group(spec, part.ndim, mesh)
    lead = mesh.rank == 0
    if kind is None or not _sends(spec, part.ndim, mesh):
        if lead:  # whole on rank 0 already
            whole = _host_chunk(part.detach())
            with _holding(_copied(whole, part)):
                yield {(): whole}, cuts
        else:
            yield None
        return
    m = mesh.shape.get("model", 1)
    n = {"world": mesh.size, "model": m, "data": mesh.shape.get("data", 1)}[kind]
    flat = part.detach().reshape(-1)
    dtype = torch.float32 if flat.dtype == torch.bfloat16 else flat.dtype
    size = torch.empty(0, dtype=dtype).element_size()
    buf = torch.empty((n, flat.numel()), dtype=dtype) if lead else None
    step = max(1, _CHUNK_BYTES // size)
    if flat.is_cuda and "pinned" not in rounds:
        rounds["pinned"] = torch.empty(_CHUNK_BYTES, dtype=torch.uint8,
                                       pin_memory=True)
        _hold(_CHUNK_BYTES)  # released at the save's end
    with _holding(_nbytes(buf) if lead else 0):
        for lo in range(0, flat.numel(), step):
            hi = min(lo + step, flat.numel())
            if flat.is_cuda:
                src = rounds["pinned"][:(hi - lo) * size].view(dtype)
                src.copy_(flat[lo:hi])
                extra = 0
            else:
                src = _host_chunk(flat[lo:hi])
                extra = _copied(src, flat)
            temp = n * (hi - lo) * size if lead else 0
            with _holding(temp + extra):
                dist.gather(src, [buf[i, lo:hi] for i in range(n)] if lead else None,
                            dst=0, group=groups[kind])
            del src
        if not lead:
            yield None
            return

        def coords(i):
            at = {"model": {"model": i}, "data": {"data": i},
                  "world": {"data": i // m, "model": i % m}}[kind]
            return tuple(at[axis] for _, axis in cuts)

        yield {coords(i): buf[i].view(part.shape) for i in range(n)}, cuts


def _join(pieces: Dict[tuple, torch.Tensor], cuts) -> torch.Tensor:
    """The pieces (by their index along each cut) concatenated whole."""
    if not cuts:
        return pieces[()]
    dim = cuts[0][0]
    count = 1 + max(c[0] for c in pieces)
    return torch.cat([_join({c[1:]: t for c, t in pieces.items() if c[0] == i},
                            cuts[1:]) for i in range(count)], dim=dim)


def _write_slab(f, pieces: Dict[tuple, torch.Tensor], cuts) -> None:
    """The slab the pieces make, written to ``f`` in C order a chunk of
    dim-0 rows at a time (each chunk concatenated from the pieces' rows,
    at most ``_CHUNK_BYTES``)."""
    if not cuts:
        f.write(_bytes_of(pieces[()]))
        return
    counts = [1 + max(c[k] for c in pieces) for k in range(len(cuts))]
    piece = next(iter(pieces.values()))
    whole = list(piece.shape)
    for (dim, _), count in zip(cuts, counts):
        whole[dim] *= count
    step = max(1, _CHUNK_BYTES // max(1, math.prod(whole[1:]) * piece.element_size()))
    first = cuts[0][0] == 0  # dim 0 is cut: a chunk lies in one piece's rows
    rest = cuts[1:] if first else cuts
    for i in range(counts[0] if first else 1):
        sub = ({c[1:]: t for c, t in pieces.items() if c[0] == i} if first
               else pieces)
        for lo in range(0, piece.shape[0], step):
            chunk = _join({c: t[lo:lo + step] for c, t in sub.items()}, rest)
            with _holding(_nbytes(chunk) if rest else 0):
                f.write(_bytes_of(chunk))
            del chunk


def _emit(f, part: _Part, layout, groups, rounds: Dict) -> None:
    """One slab: this process's part written (the only process) or
    gathered to rank 0, which writes it to ``f`` (``rounds``: the save's
    pinned round buffer, :func:`_gathered`)."""
    value = part.value
    if layout is None:
        if isinstance(value, torch.Tensor):
            host = _host_chunk(value.detach())
            with _holding(_copied(host, value)):
                f.write(_bytes_of(host))
        else:
            f.write(_bytes_of(np.asarray(value)))
        return
    if value is None:  # an async save's copy another rank sends
        return
    if not isinstance(value, torch.Tensor):  # the step: rank 0's own
        if f is not None:
            f.write(_bytes_of(np.asarray(part.value)))
        return
    with _gathered(part.value, part.spec, layout.mesh, groups, rounds) as got:
        if got is not None:
            _write_slab(f, *got)


def _write(directory: str, step: int, entries: List[_Entry], layout,
           groups) -> str:
    """Every entry's slabs in order: written by this process, or under a
    process mesh gathered to rank 0 (every rank calls this), which writes
    and commits ``step_XXXXXXXX``; every rank returns after the commit.
    An async save's host copies are released as each slab is sent."""
    from repro_torch.parallel import distributed as D

    final = os.path.join(directory, f"step_{step:08d}")
    lead = layout is None or layout.mesh.rank == 0
    groups = groups or (None if layout is None else D.axis_groups(layout.mesh))
    writer, rounds = None, {}
    if lead:
        os.makedirs(directory, exist_ok=True)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        writer = _NpzWriter(os.path.join(tmp, "arrays.npz"))
    try:
        for entry in entries:
            block = (writer.entry(entry.key, entry.shape, entry.dtype) if lead
                     else contextlib.nullcontext())
            with block as f:
                for part in entry.parts:
                    _emit(f, part, layout, groups, rounds)
                    _release(part.held)
                    part.value, part.held = None, 0
    finally:
        if writer is not None:
            writer.close()
        if rounds.pop("pinned", None) is not None:
            _release(_CHUNK_BYTES)
    if lead:
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump({"step": step, "leaf_paths": [e.key for e in entries]}, f)
        # Commit.
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if layout is not None:  # every rank returns once rank 0 has committed
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1), group=groups["world"])
    return final


def save_checkpoint(directory: str, step: int, state) -> str:
    """Synchronous atomic save of ``state`` (a port TrainState, or a tree
    of named tuples, dicts, lists and arrays/tensors) in the reference's
    layout, a slab at a time.  Returns the committed path.  A shard on a
    process mesh is gathered to rank 0 a slab at a time over the mesh's
    groups (every rank calls this), rank 0 writes, and every rank returns
    once it has committed."""
    return _write(directory, step, _entries(state), _layout(state), None)


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


# -- restoring -----------------------------------------------------------------


def _join_path(prefix: str, part: str) -> str:
    return f"{prefix}/{part}" if prefix else part


@torch.no_grad()
def _copy_in(target: torch.Tensor, arr, path: str, spec=None, mesh=None) -> None:
    """``target`` overwritten with ``arr`` (a slab; on a process mesh the
    rank's shard of it under ``spec``), cast to its dtype."""
    src = torch.from_numpy(arr) if isinstance(arr, np.ndarray) else arr
    if spec is not None:
        from repro_torch.parallel.distributed import local_shard

        src = local_shard(src, spec, mesh)
    if tuple(src.shape) != tuple(target.shape):
        raise ValueError(f"{path}: checkpoint shape {tuple(src.shape)} != "
                         f"{tuple(target.shape)}")
    # a copy to a card goes through a contiguous host temporary in the
    # target's dtype where the shard is strided or of another dtype
    temp = (target.device.type != "cpu"
            and (not src.is_contiguous() or src.dtype != target.dtype))
    with _holding(src.numel() * target.element_size() if temp else 0):
        target.copy_(src)


@torch.no_grad()
def _fill(like, reader: _NpzReader, prefix: str = ""):
    """``like`` with each leaf restored from ``reader`` an entry at a
    time: a tensor copied into in place, a numpy leaf replaced."""
    if like is None:
        return None
    if hasattr(like, "_fields"):
        return type(like)(*(_fill(getattr(like, f), reader, _join_path(prefix, f".{f}"))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _fill(v, reader, _join_path(prefix, f"[{k!r}]"))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, reader, _join_path(prefix, f"[{i}]"))
                          for i, v in enumerate(like))
    with reader.slab(prefix) as arr:
        if isinstance(like, torch.Tensor):
            _copy_in(like, arr, prefix)
            return like
        out = np.array(arr)
    if hasattr(like, "dtype") and out.dtype != like.dtype:
        out = out.astype(like.dtype)
    return out


@torch.no_grad()
def _restore_train_state(like, reader: _NpzReader):
    layout = _layout(like)
    step = None
    for entry in _train_entries(like):
        if entry.key == ".step":
            with reader.slab(entry.key) as arr:
                step = torch.as_tensor(np.array(arr), dtype=torch.int32)
            continue
        got = reader.head(entry.key)[1]
        if got != entry.shape:
            raise ValueError(f"{entry.key}: checkpoint shape {got} != {entry.shape}")
        for j, part in enumerate(entry.parts):
            key = f"{entry.key}[{j}]" if entry.stacked else entry.key
            with reader.slab(entry.key, j if entry.stacked else None) as arr:
                _copy_in(part.value, arr, key, part.spec,
                         None if layout is None else layout.mesh)
    return like._replace(step=step)


def restore_checkpoint(directory: str, like, step: Optional[int] = None,
                       shardings=None):
    """Restore the checkpoint of ``step`` (default the latest committed
    one) into the structure of ``like``; returns ``(state, step)``.

    ``like`` is a port TrainState (its model's parameters and its moments
    are overwritten in place, on their devices; the returned state holds
    them and a new step) or a tree of tensors (copied into in place) and
    numpy arrays (replaced).  The checkpoint may come from either
    package; each array is cast to the dtype of its target.  A slab (one
    layer of a stacked run, or one leaf) is read at a time through a
    memory map of the file, and dropped before the next.

    ``shardings``: a matching tree of ``parallel.sharding.NamedSharding``
    (``launch.shardspecs.train_state_shardings``).  ``like`` is placed on
    their devices first (``parallel.sharding.place``) and the arrays are
    copied there straight from the file: the elastic-restart path onto
    another mesh.  On a process mesh every rank reads each slab and keeps
    its shard (a ``like`` placed already stays as it is)."""
    if shardings is not None and _layout(like) is None:
        like = place(like, shardings)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    reader = _NpzReader(os.path.join(directory, f"step_{step:08d}", "arrays.npz"))
    try:
        if _is_train_state(like):
            return _restore_train_state(like, reader), step
        return _fill(like, reader), step
    finally:
        reader.close()


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at-most-one in flight.

    ``save`` copies the state to host memory synchronously (the only part
    that blocks the train loop) and writes it on a worker thread;
    ``wait()`` joins outstanding work (call before exit) and raises what
    the worker raised.  The ``keep`` newest committed steps survive each
    save.

    Under a process mesh every rank constructs it and calls ``save`` and
    ``wait``: ``save`` copies only the rank's own part of each slab it
    sends to rank 0 (see :func:`save_checkpoint`), and every rank's
    worker gathers them to rank 0 a slab at a time over gloo groups of
    the checkpointer's own (``parallel.distributed.host_groups``), never
    the mesh's, so its collectives cannot interleave with the step's.
    ``mesh`` makes the groups at construction (every rank, in the same
    order); a state on another process mesh makes its own at its first
    ``save``."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.directory = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._groups: Dict[tuple, Dict[str, object]] = {}
        if getattr(mesh, "is_process_mesh", False):
            self._groups_of(mesh)

    def _groups_of(self, mesh):
        from repro_torch.parallel.distributed import host_groups

        key = tuple(mesh.shape.items())
        if key not in self._groups:
            self._groups[key] = host_groups(mesh)
        return self._groups[key]

    def save(self, step: int, state):
        self.wait()
        layout = _layout(state)
        groups = None if layout is None else self._groups_of(layout.mesh)
        entries = _entries(state)
        for entry in entries:  # the host copies the worker writes or sends
            for part in entry.parts:
                if layout is not None and isinstance(part.value, torch.Tensor) \
                        and not _sends(part.spec, part.value.ndim, layout.mesh):
                    part.value = None  # another rank sends this copy
                    continue
                value = part.value
                if isinstance(value, torch.Tensor):
                    host = _host_chunk(value.detach())
                    part.value = host if _copied(host, value) else host.clone()
                else:
                    part.value = _host(value, copy=True)
                part.held = _nbytes(part.value)
                _hold(part.held)
        lead = _lead(state)

        def worker():
            try:
                _write(self.directory, step, entries, layout, groups)
                if lead:
                    self._gc()
            except BaseException as e:  # noqa: BLE001 (raised again by wait)
                self._error = e
            finally:
                for entry in entries:
                    for part in entry.parts:
                        _release(part.held)
                        part.value, part.held = None, 0

        with self._lock:
            self._pending = threading.Thread(target=worker, daemon=True)
            self._pending.start()

    def wait(self, timeout: Optional[float] = None):
        """Joins the worker (at most ``timeout`` seconds: then raises
        ``TimeoutError``) and raises what it raised."""
        with self._lock:
            t = self._pending
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(f"a checkpoint is still being written after "
                                   f"{timeout} s")
        with self._lock:
            if self._pending is t:
                self._pending = None
            error, self._error = self._error, None
        if error is not None:
            raise error

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
