"""Dry run: count a cell's step on fake tensors, and its rooflines.

Port of ``src/repro/launch/dryrun.py``.  For each (arch x shape) cell
this writes ``{arch}_{shape}_{mesh}.json`` (into ``--out``) with the
reference's keys:
  * the counted cost of rank 0's step (``analysis.op_cost.program_cost``:
    dot FLOPs, bytes, COPs, the live-bytes peak) where the reference
    compiles the per-device program and reads its HLO,
  * its collectives (``collective_bytes``, ``collective_breakdown``,
    ``collective_counts``): what the port's own collective layer records
    in the step (``parallel.distributed.COLLECTIVES``), priced by the
    reference's ring conventions (``analysis.op_cost.collective_traffic``),
  * the roofline terms on a hardware profile (``"h100"`` by default),
  * MODEL_FLOPS = 6*N(_active)*D and the useful-compute ratio.

:func:`count_cell` counts a cell's step on a mesh.  On a process mesh
of fake ranks (``launch.mesh.production_process_mesh``, the reference's
(16, 16) ``("data", "model")`` mesh of 256 chips, as rank 0) it builds
the rank's shard of the train state on ``device="meta"`` (nothing drawn
or allocated), places its rows of the batch and counts the port's own
tensor-parallel and ZeRO-3 train step, collectives included.  On a
logical mesh (a (1, 1) one over ``"meta"``) it places the whole state,
or the parameters, and counts the train, prefill or decode step of one
process.  ``"single"`` (:func:`run_cell`) is the reference's cell:
rank 0 of (16, 16), ``chips: 256``.  It counts the port's program for
that rank, which is not the reference's where a block stays whole over
"model" (heads or experts 16 does not divide: starcoder2-7b,
qwen2-vl-2b, granite-moe-3b-a800m): the port runs such a block at full
size on every rank, where GSPMD still splits its dots (6 heads over 4
count 2.069x the reference's FLOPs; ROADMAP item 14c.4).  Its serving cells (prefill, decode,
``long_500k``) raise: serving a shard is ROADMAP item 14c.2 (count one
on a (1, 1) mesh with :func:`count_cell`).  ``"multi"`` (512 chips) has
a ``"pod"`` axis: ROADMAP item 14b.4.

Usage (on the CPU; nothing runs on a card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.analysis.op_cost import (
    ProgramCost,
    collective_traffic,
    program_cost,
)
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.roofline import HARDWARE
from repro_torch.launch import shardspecs as SS
from repro_torch.launch.mesh import production_process_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import distributed as D
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import place, use_mesh

__all__ = ["model_flops", "ideal_memory_bytes", "count_cell", "roofline",
           "cell_record", "run_cell", "main"]

# what serving a shard on a process mesh waits for
SERVING_ITEM = "serving a shard (prefill and decode on a process mesh) is ROADMAP item 14c.2"


def _knn_attn_for_cell(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k uses the paper's knn top-k attention for KV-cache archs."""
    if shape.name != "long_500k":
        return False
    kinds = set(cfg.layer_kinds())
    return any(k in kinds for k in ("dense", "moe", "mla_dense", "mla_moe", "dec"))


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6 * N(_active) * tokens (+ attention KV term on decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token/sequence + attention reads of the cache
    tokens = shape.global_batch
    attn = 0.0
    hd = cfg.resolved_head_dim
    for kind in cfg.layer_kinds():
        if kind in ("dense", "moe", "dec", "enc"):
            attn += 4.0 * cfg.num_heads * hd * shape.seq_len
        elif kind.startswith("mla"):
            attn += 4.0 * cfg.num_heads * cfg.kv_lora_rank * shape.seq_len
        elif kind == "local_attn":
            attn += 4.0 * cfg.num_heads * hd * min(cfg.local_window, shape.seq_len)
    return (2.0 * n + attn) * tokens


def ideal_memory_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Unavoidable global HBM traffic per step (roofline denominator).

    train:   read f32 params + m + v, write all three, plus one bf16
             read/write of activations at the layer boundaries.
    prefill: read bf16 params once + write the KV cache.
    decode:  read bf16 active params + read the whole cache once.
    """
    n = cfg.active_param_count()
    n_total = cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        act = 2.0 * tokens * cfg.d_model * max(
            len(cfg.layer_kinds()), 1
        ) * 2  # save + reload once per layer boundary
        return 6.0 * 4.0 * n_total + act
    from repro_torch.serving.kvcache import cache_bytes_per_token

    cache = cache_bytes_per_token(cfg) * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_total + cache
    return 2.0 * n + cache


def _abstract_train_state(cfg: ModelConfig) -> M.TrainState:
    """``models.model.init_train_state``'s layout on ``"meta"``: f32
    masters requiring grad, zero moments, step 0 (on the host)."""
    model = tfm.Transformer(cfg, device="meta")
    model.requires_grad_(True)
    return M.TrainState(step=torch.zeros((), dtype=torch.int32), params=model,
                        opt_state=adamw_init(dict(model.named_parameters())))


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> ProgramCost:
    """The cell's step (train, prefill, or decode with the kNN attention
    where ``_knn_attn_for_cell`` says) counted on fake tensors, its
    arguments built on ``"meta"`` and placed by the cell's shardings,
    under ``use_mesh(mesh, rules=shardspecs.cell_rules(...))``.  On a
    process mesh (``parallel.distributed.fake_process_mesh``) the count
    is the calling rank's: ``place`` keeps its shard of the state and its
    rows of the batch, still on ``"meta"``, and the result's
    ``collectives`` are those it runs; a serving step there raises
    (:data:`SERVING_ITEM`)."""
    specs = M.input_specs(cfg, shape)
    ranks = D.is_process_mesh(mesh)
    if ranks and shape.kind != "train":
        raise NotImplementedError(
            f"{cfg.name} x {shape.name} on a process mesh {dict(mesh.shape)}: "
            f"{SERVING_ITEM}; count_cell counts its step on a (1, 1) mesh")
    with use_mesh(mesh, rules=SS.cell_rules(cfg, shape, mesh)):
        if shape.kind == "train":
            state = _abstract_train_state(cfg)
            state = place(state, SS.sanitize_tree(
                SS.train_state_shardings(cfg, mesh, shape), state, mesh))
            batch = place(specs, SS.sanitize_tree(
                SS.batch_shardings(cfg, shape, mesh), specs, mesh))
            step = M.make_train_step(cfg, microbatches=cfg.train_microbatches)
            return program_cost(step, state, batch)
        model = tfm.Transformer(cfg, device="meta")
        if shape.kind == "prefill":
            model = place(model, SS.sanitize_tree(
                SS.param_shardings(cfg, mesh, shape), model, mesh))
            batch = place(specs, SS.sanitize_tree(
                SS.batch_shardings(cfg, shape, mesh), specs, mesh))
            return program_cost(M.make_prefill_step(cfg), model, batch)
        arg_sh = SS.decode_arg_shardings(cfg, shape, mesh)
        model = place(model, SS.sanitize_tree(arg_sh["params"], model, mesh))
        caches = place(specs["caches"], SS.sanitize_tree(
            arg_sh["caches"], specs["caches"], mesh))
        cross_kv = specs.get("cross_kv")
        if cross_kv is not None:
            cross_kv = place(cross_kv, SS.sanitize_tree(
                arg_sh["cross_kv"], cross_kv, mesh))
        # the Gumbel draw is the step's input (the engine draws it outside)
        noise = torch.empty((shape.global_batch, cfg.decode_sample_k),
                            device="meta")
        step = M.make_decode_step(cfg, use_knn=_knn_attn_for_cell(cfg, shape))
        return program_cost(step, model, specs["tokens"], caches,
                            specs["cur_index"], None, noise=noise,
                            cross_kv=cross_kv)


def roofline(cfg: ModelConfig, shape: ShapeConfig, cost: ProgramCost,
             coll_bytes: float, hw_name: str = "h100",
             chips: int = 1) -> Dict[str, Any]:
    """The reference's ``roofline`` dict of a counted step: its four terms
    on ``HARDWARE[hw_name]`` (the largest is ``step_time_s``), the ideal
    step from ``model_flops`` and ``ideal_memory_bytes``, and their
    ratios."""
    hw = HARDWARE[hw_name]
    compute_s = cost.dot_flops / hw.peak_flops
    memory_s = cost.hbm_bytes / hw.hbm_bandwidth
    collective_s = coll_bytes / hw.ici_bandwidth
    instruction_s = cost.cop_count / hw.peak_cops  # the paper's third wall
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s, "instruction": instruction_s}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    mf = model_flops(cfg, shape)
    mf_per_device = mf / chips
    # Ideal step time: the better of the compute roofline and the
    # unavoidable-traffic memory roofline — decode is *supposed* to be
    # memory-bound, so MFU alone would misgrade it.
    ideal_bytes_dev = ideal_memory_bytes(cfg, shape) / chips
    t_ideal = max(mf_per_device / hw.peak_flops, ideal_bytes_dev / hw.hbm_bandwidth)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "instruction_s": instruction_s,
        "dominant": dominant,
        "step_time_s": step_time,
        "model_flops": mf,
        "ideal_bytes_per_device": ideal_bytes_dev,
        "ideal_step_s": t_ideal,
        "useful_ratio": mf_per_device / cost.dot_flops if cost.dot_flops else 0.0,
        "mfu_bound": (mf_per_device / hw.peak_flops) / step_time if step_time else 0.0,
        "roofline_fraction": t_ideal / step_time if step_time else 0.0,
    }


def cell_record(cfg: ModelConfig, shape: ShapeConfig, mesh_kind: str,
                cost: ProgramCost, chips: int, hw_name: str = "h100",
                lower_s: float = 0.0) -> Dict[str, Any]:
    """A counted step as the reference's cell record: ``cost`` is one
    device's program (rank 0's) on a mesh of ``chips``.  ``lower_s`` is
    the time to build and count the step (the port compiles nothing:
    ``compile_s`` is 0), ``xla_cost_analysis`` holds the counted FLOPs
    and the fusion-boundary bytes, ``memory`` the exact argument and
    output bytes and the counted peak, the collectives those of
    ``cost.collectives`` by the reference's kinds."""
    result: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind, "chips": chips,
        "knn_attention": _knn_attn_for_cell(cfg, shape),
    }
    result["lower_s"] = lower_s
    result["compile_s"] = 0.0
    result["xla_cost_analysis"] = {"flops": cost.dot_flops,
                                   "bytes": cost.hbm_bytes_hi}
    result["memory"] = {
        "argument_bytes": cost.argument_bytes,
        "output_bytes": cost.output_bytes,
        "temp_bytes": cost.peak_bytes - cost.argument_bytes,
        "peak_bytes": cost.peak_bytes,
    }
    t2 = time.time()
    coll_total, coll_kinds, coll_calls = collective_traffic(cost.collectives)
    result["analyze_s"] = round(time.time() - t2, 2)
    result["hlo_flops_per_device"] = cost.dot_flops
    result["hlo_bytes_per_device"] = cost.hbm_bytes
    result["hlo_cops_per_device"] = cost.cop_count
    result["hlo_flops"] = cost.dot_flops * chips
    result["hlo_bytes"] = cost.hbm_bytes * chips
    result["while_trips"] = cost.while_trips
    result["collective_bytes"] = coll_total
    result["collective_breakdown"] = coll_kinds
    result["collective_counts"] = coll_calls
    result["roofline"] = roofline(cfg, shape, cost, coll_total, hw_name, chips)
    return result


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             hw_name: str = "h100") -> Dict[str, Any]:
    """One cell's record (:func:`cell_record`): ``"single"`` is rank 0 of
    the reference's (16, 16) mesh of 256 chips, counted on a fake process
    mesh (``launch.mesh.production_process_mesh``; ``hlo_flops`` is its
    FLOPs x 256).  The port's program: a block kept whole over "model"
    counts at full size, more than the reference's split dots (module
    docstring).  A serving cell there raises (:data:`SERVING_ITEM`),
    and so does ``"multi"`` (ROADMAP item 14b.4)."""
    if mesh_kind == "multi":
        raise NotImplementedError(
            f"the multi-pod cell (512 chips, a (2, 16, 16) mesh): {D.POD_ITEM}")
    if mesh_kind != "single":
        raise ValueError(f"mesh_kind {mesh_kind!r}: 'single' or 'multi'")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    with production_process_mesh() as mesh:
        cost = count_cell(cfg, shape, mesh)
        chips = mesh.size
    return cell_record(cfg, shape, mesh_kind, cost, chips, hw_name,
                       lower_s=round(time.time() - t0, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every arch, and every shape unless --shape names one")
    ap.add_argument("--out", default="dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ASSIGNED_ARCHS) if args.all or not args.arch else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = os.path.join(args.out, f"{arch}_{shape}_{mesh_kind}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {path}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind)
                    dom = res["roofline"]["dominant"]
                    print(
                        f"  ok: count={res['lower_s']}s flops={res['hlo_flops']:.3e} "
                        f"coll={res['collective_bytes']:.3e}B dominant={dom}",
                        flush=True,
                    )
                except Exception as e:
                    failures += 1
                    res = {
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(f"  FAIL: {type(e).__name__}: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
