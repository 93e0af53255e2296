"""Named snapshots: one logical state in a directory, committed atomically.

Port of ``save_snapshot``/``load_snapshot`` of
``src/repro/checkpoint/checkpoint.py`` with the same on-disk format:
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
from typing import Tuple

import numpy as np
import torch

from repro_torch.search import faults

__all__ = ["load_snapshot", "save_snapshot"]


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
