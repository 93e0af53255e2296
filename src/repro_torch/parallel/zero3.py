"""ZeRO-3 over the data axis of a process mesh: the ``fsdp_params``
archs' parameters split along their embed dim, gathered a layer at a
time.

The reference shards the embed dim of every parameter over
``("pod", "data")`` (``launch/shardspecs.py``: "all-gathered per layer
inside the scan") and leaves the gathers to GSPMD.  The port writes them
out (Rajbhandari et al., 2020): each rank holds its shard of every
parameter and of AdamW's moments (``parallel.distributed.ShardLayout``'s
``data_split``), and the forward gathers a layer's parameters just
before the layer runs, so the layer computes on its whole (tensor-
parallel shard's) weights.

* :class:`Zero3` gathers one forward's leaves.  Each data-split leaf
  goes through one autograd function: its forward casts the f32 master
  shard to the compute dtype and all-gathers it over the data axis along
  its embed dim (the cast shard: the same values, half the bytes under
  bf16); its backward widens the gathered weight's gradient to f32 (bf16
  under ``--grad-compression``) and reduce-scatters it into the shard's
  gradient, so the shard's gradient is summed over the data axis and
  skips the step's data-parallel all-reduce.  A leaf the split leaves
  whole is cast as ``transformer._cast_params`` casts it.
* No gathered weight outlives its layer's forward, except as something
  that can be gathered again.  Under ``remat="dots"`` or ``"full"`` the
  gathers run inside the checkpointed layer function, so the backward's
  recompute gathers again.  Under ``remat="none"``, and around the
  tables' reads, :meth:`Zero3.regather_saved` installs saved-tensor
  hooks: a saved tensor that shares a gathered weight's storage is kept
  as its shard and its view's geometry and gathered again when the
  backward unpacks it.

Collectives a step (one microbatch), all counted in
``parallel.distributed.COLLECTIVES``: an all-gather for each data-split
leaf of each layer and for each table read (the embedding's lookup, the
final norm and the LM head or tied table in the unembed), as many again
in the backward where it recomputes or unpacks, and one reduce-scatter
for each forward gather.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.parallel import distributed as D

__all__ = ["Zero3"]


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its views share it), fake and
    meta tensors' too (whose data pointers are all 0)."""
    return t.untyped_storage()._cdata


class _Gather(torch.autograd.Function):
    """``shard`` cast to ``dtype`` and all-gathered over the data axis
    along ``dim``; the backward reduce-scatters the gradient in
    ``grad_dtype`` and returns it in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, dim, dtype, grad_dtype, mesh):
        ctx.dim, ctx.grad_dtype, ctx.mesh = dim, grad_dtype, mesh
        ctx.shard_dtype = shard.dtype
        return D.all_gather(shard.to(dtype), D.DATA, dim, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        part = D.reduce_scatter(grad.to(ctx.grad_dtype), D.DATA, ctx.dim,
                                mesh=ctx.mesh)
        return part.to(ctx.shard_dtype), None, None, None, None


class Zero3:
    """The gathers of one forward of a ZeRO-3 shard (a model whose
    ``layout.data_split`` is not empty): :meth:`leaf` and :meth:`tree`
    give parameters in ``dtype`` (the compute dtype), whole along the
    data axis; ``grad_dtype="bfloat16"`` sums their gradients in bf16."""

    def __init__(self, layout: D.ShardLayout, dtype: torch.dtype,
                 grad_dtype: Optional[str] = None):
        self.mesh = layout.mesh
        self.dims = layout.data_dims
        self.dtype = dtype
        self.grad_dtype = (torch.bfloat16 if grad_dtype == "bfloat16"
                           else torch.float32)
        self._live: Optional[Dict[int, tuple]] = None

    @classmethod
    def of(cls, model, dtype: torch.dtype, grad_dtype: Optional[str] = None):
        """A :class:`Zero3` for ``model`` where its layout cuts a leaf
        over the data axis, else None."""
        layout = getattr(model, "layout", None)
        if layout is None or not layout.data_split:
            return None
        return cls(layout, dtype, grad_dtype)

    def leaf(self, p: torch.Tensor, name: str) -> torch.Tensor:
        """Parameter ``name`` (this rank's ``p``) in the compute dtype,
        gathered where the data axis cuts it."""
        if name not in self.dims:
            return p.to(self.dtype) if p.dtype == torch.float32 else p
        out = _Gather.apply(p, self.dims[name], self.dtype, self.grad_dtype,
                            self.mesh)
        if self._live is not None:
            self._live[_storage(out)] = (out, name, p)
        return out

    def tree(self, tree: Dict, prefix: str) -> Dict:
        """A (nested) dict of parameters named ``prefix`` + its keys
        joined by dots, each through :meth:`leaf`."""
        return {k: self.tree(v, f"{prefix}{k}.") if isinstance(v, dict)
                else self.leaf(v, prefix + k) for k, v in tree.items()}

    @contextlib.contextmanager
    def regather_saved(self):
        """Inside: every gathered weight (or a view of one) that autograd
        saves is kept as its shard and gathered again when the backward
        unpacks it."""
        self._live = {}
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._live = None

    def _pack(self, t: torch.Tensor):
        hit = None
        if self._live is not None and t.layout == torch.strided:
            hit = self._live.get(_storage(t))
        if hit is None or hit[0].dtype != t.dtype:
            return t
        _, name, shard = hit
        return (name, shard, tuple(t.shape), t.stride(), t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        name, shard, shape, stride, offset = packed
        with torch.no_grad():
            whole = D.all_gather(shard.to(self.dtype), D.DATA, self.dims[name],
                                 mesh=self.mesh)
        return whole.as_strided(shape, stride, offset)
