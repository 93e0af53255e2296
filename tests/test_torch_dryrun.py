"""The port's dry run and its analysis against the reference's, on the CPU.

``analysis.op_cost.program_cost`` counts a program on fake tensors;
``launch.dryrun.count_cell`` counts a cell's step with it.  Its dot FLOPs
are held to the reference's ``analyze_hlo(lower_cell(...).compile()
.as_text())`` on a one-device mesh (``tests/torch_dryrun_parity.py``: the
dense family here, exactly; the other families in
``test_torch_dryrun_families.py`` at their stated ratios).
``search_cost`` (rebuilt on ``program_cost``) keeps the parent's counts.
``analysis.rooflines`` renders the reference's strings from the same cell
records and the same plans.  The full-width internlm2-1.8b ``train_4k``
cell is counted without allocating its 22.7 GB of state, with the
reference's record keys.
"""
import json
import re
import resource

import numpy as np
import pytest
import torch

from repro.analysis import rooflines as ref_rooflines
from repro.configs.knn_workloads import KNN_WORKLOADS as REF_WORKLOADS
from repro_torch.analysis import rooflines
from repro_torch.analysis.op_cost import (
    OpCost,
    collective_bytes,
    op_census,
    program_cost,
    search_cost,
)
from repro_torch.configs import KNN_WORKLOADS
from repro_torch.launch import dryrun
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.parallel import make_mesh
from repro_torch.search import Index

import torch_dryrun_parity as parity
from torch_train_parity import few_threads  # noqa: F401 (a fixture)

REF_DRYRUN = "src/repro/launch/dryrun.py"


@pytest.mark.parametrize("arch,step", parity.cases(["internlm2-1.8b-smoke"]))
def test_dense_dot_flops_equal_the_references(arch, step):
    """Train, prefill, decode and kNN decode (the context-parallel path on
    the (1, 1) mesh in both): the same dot FLOPs, well within 1%."""
    parity.check(arch, step)


@pytest.mark.parametrize("kind", ["train", "knn_decode"])
def test_count_cell_is_the_step_it_counts(kind):
    """The dry run's dot FLOPs of a smoke step equal those of the same step
    run for real on the CPU under ``FlopCounterMode`` (chip_smoke's phase
    20d holds the full-width step so on the card)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardspecs import cell_rules
    from repro_torch.models import model as M
    from repro_torch.parallel import use_mesh

    cfg = get_config("internlm2-1.8b-smoke")
    shape = (ShapeConfig("train", 32, 2, "train") if kind == "train"
             else ShapeConfig("long_500k", 512, 1, "decode"))
    counted = dryrun.count_cell(cfg, shape, make_host_mesh(1, devices=["meta"]))
    g = torch.Generator().manual_seed(0)
    mesh = make_host_mesh(1, devices=["cpu"])
    with use_mesh(mesh, rules=cell_rules(cfg, shape, mesh)):
        if kind == "train":
            state = M.init_train_state(g, cfg, device="cpu")
            batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                                      dtype=torch.int32) for k in ("tokens", "labels")}
            with FlopCounterMode(display=False) as flops:
                M.make_train_step(cfg)(state, batch)
        else:
            model = tfm.init_model(cfg, g, device="cpu")
            caches = tfm.init_caches(cfg, 1, 512, device="cpu")
            with FlopCounterMode(display=False) as flops:
                M.make_decode_step(cfg, use_knn=True)(
                    model, torch.zeros((1, 1), dtype=torch.int32), caches, 511, None,
                    noise=torch.zeros((1, cfg.decode_sample_k)))
    assert flops.get_total_flops() == counted.dot_flops > 0


# --- program_cost ----------------------------------------------------------------


def test_program_cost_counts_flops_bytes_and_the_live_peak():
    a = torch.empty(1000, device="meta")
    cost = program_cost(lambda x: (x * 2) * 3, a)
    # x*2 lives while (x*2)*3 is made: 4,000 + 8,000 bytes at the peak
    assert cost.argument_bytes == 4000 and cost.output_bytes == 4000
    assert cost.peak_bytes == 4000 + 8000
    assert cost.dot_flops == 0 and cost.cop_count == 2000
    assert cost.hbm_bytes_hi == 4 * 4000 and cost.hbm_bytes_lo == 8000
    assert cost.hbm_bytes == pytest.approx((8000 * 16000) ** 0.5)
    assert cost.while_trips == {}
    assert op_census(cost.trace) == {"mul": 2}
    m = program_cost(torch.mm, torch.empty(64, 32, device="meta"),
                     torch.empty(32, 16, device="meta"))
    assert m.dot_flops == 2 * 64 * 32 * 16 and m.cop_count == 0


def test_program_cost_runs_nothing_on_real_tensors():
    """Real arguments are stood in for: an in-place op leaves them as they
    were, and a CPU scalar's value reaches the host as a constant."""
    x = torch.arange(4.0)
    step = torch.tensor(3, dtype=torch.int32)

    def fn(x, step):
        x.add_(int(step))
        return x, step + 1
    cost = program_cost(fn, x, step)
    assert torch.equal(x, torch.arange(4.0)) and int(step) == 3
    assert cost.argument_bytes == 16 + 4 and cost.peak_bytes == 20 + 4


@pytest.mark.parametrize("devices,want", [
    (["cpu", "meta", "meta", "meta"], True), (["cpu"] * 4, False)])
def test_collective_bytes_count_copies_between_distinct_devices(devices, want):
    """``_knn_decode_attention_cp`` over 4 shards: the 3 shards on another
    device than the first get their slices (cpu->meta bytes) and send
    their winners back (meta->cpu); 4 shards of one device send nothing
    (C7's rule)."""
    mesh = make_mesh((4,), ("model",), devices=devices)
    b, s, kv, hd, h, k = 2, 256, 2, 16, 4, 8
    args = [torch.empty(b, h, hd, device="meta"),
            torch.empty(b, s, kv, hd, device="meta"),
            torch.empty(b, s, kv, hd, device="meta"),
            torch.empty(s, dtype=torch.bool, device="meta")]
    cost = program_cost(
        lambda *a: attn._knn_decode_attention_cp(
            *a, k=k, recall_target=0.95, mesh=mesh, cp_axes=("model",),
            kv_groups=h // kv), *args, device="cpu")
    total, kinds = collective_bytes(cost.trace)
    if not want:
        assert total == 0 and kinds == {}
        return
    assert total == kinds["cpu->meta"] + kinds["meta->cpu"]
    # out: 3 shards' q, keys, values and valid rows; back: 3 shards'
    # winners (f32 values, int64 positions, bf16 value rows)
    assert kinds["cpu->meta"] == 3 * (b * h * hd * 4 + 2 * b * (s // 4) * kv * hd * 4
                                      + s // 4)
    assert kinds["meta->cpu"] % (3 * b * h * (4 + 8 + hd * 2)) == 0


# --- search_cost, rebuilt on program_cost ----------------------------------------

# the parent tree's counts (fb6322d) of one search of 64 queries, N=3000,
# d=40, k=5, cluster="off", on the CPU
SEARCH_COST = [
    (dict(backend="torch"), OpCost(
        dot_flops=15360000.0, kernel_dot_flops=0.0, hbm_bytes=2479860.445105732,
        hbm_bytes_lo=504800.0, hbm_bytes_hi=12182464.0, cop_count=427132.0)),
    (dict(backend="cuda"), OpCost(
        dot_flops=18874368.0, kernel_dot_flops=18874368.0,
        hbm_bytes=4528800.449390545, hbm_bytes_lo=1597952.0,
        hbm_bytes_hi=12835200.0, cop_count=387584.0)),
    (dict(backend="cuda", storage="int8"), OpCost(
        dot_flops=18925568.0, kernel_dot_flops=18874368.0,
        hbm_bytes=4110396.6802944946, hbm_bytes_lo=922592.0,
        hbm_bytes_hi=18312928.0, cop_count=910016.0)),
    (dict(backend="torch", storage="int4"), OpCost(
        dot_flops=15436800.0, kernel_dot_flops=0.0, hbm_bytes=3574689.0035358323,
        hbm_bytes_lo=648800.0, hbm_bytes_hi=19695440.0, cop_count=880430.0)),
]


@pytest.mark.parametrize("kw,want", SEARCH_COST)
def test_search_cost_is_unchanged(kw, want):
    db = torch.randn(3000, 40, generator=torch.Generator().manual_seed(0))
    idx = Index.build(db, k=5, device="cpu", cluster="off", **kw)
    assert search_cost(idx, 64) == want


# --- the dry run: a full-width cell -----------------------------------------------


def _ref_keys():
    """The record keys of the reference's ``run_cell``, read from its
    source: the top level, ``memory`` and ``roofline``."""
    with open(REF_DRYRUN) as f:
        src = f.read()
    src = src[src.index("def run_cell("):src.index("def main(")]

    def block(start):
        body = src[src.index(start):]
        return set(re.findall(r'"(\w+)":', body[:body.index("}")]))
    top = block("result: Dict[str, Any] = {") | set(
        re.findall(r'result\["(\w+)"\] =', src))
    top -= {"cost_analysis_error", "memory_error"}
    return top, block('result["memory"] = {'), block('result["roofline"] = {')


@pytest.fixture(scope="module")
def full_cell():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cell = dryrun.run_cell("internlm2-1.8b", "train_4k")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    return cell, grown * 1024  # ru_maxrss is in KiB on Linux


def test_full_width_train_cell_is_counted_without_allocating(full_cell):
    cell, grown = full_cell
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config("internlm2-1.8b")
    n = sum(p.numel() for p in tfm.Transformer(cfg, device="meta").parameters())
    top, memory, roof = _ref_keys()
    assert set(cell) == top
    assert set(cell["memory"]) == memory and set(cell["roofline"]) == roof
    # f32 masters and both moments (12 bytes a parameter), the step, the batch
    batch = 2 * SHAPES["train_4k"].global_batch * SHAPES["train_4k"].seq_len * 4
    assert cell["memory"]["argument_bytes"] == 12 * n + 4 + batch
    assert grown < 2e9 < cell["memory"]["argument_bytes"]
    assert cell["memory"]["peak_bytes"] > cell["memory"]["argument_bytes"]
    assert cell["chips"] == 1 and cell["mesh"] == "single"
    assert cell["collective_bytes"] == 0.0 and cell["collective_counts"] == {}
    r = cell["roofline"]
    assert r["model_flops"] == dryrun.model_flops(cfg, SHAPES["train_4k"])
    # the port's dots beyond 6·N·D: attention's scores and values, the
    # forward again where remat="dots" recomputes the batched products
    assert 0.8 < r["useful_ratio"] < 0.9 and r["dominant"] == "compute"
    assert r["step_time_s"] == max(r[k] for k in ("compute_s", "memory_s",
                                                  "collective_s", "instruction_s"))
    with pytest.raises(ValueError, match="partitioner"):
        dryrun.run_cell("internlm2-1.8b", "train_4k", "multi")


def test_cli_writes_cells_and_the_tables_render(tmp_path, capsys):
    out = str(tmp_path)
    rc = dryrun.main(["--arch", "internlm2-1.8b-smoke", "--shape", "long_500k",
                      "--mesh", "both", "--out", out])
    assert rc == 1  # the multi cell is refused and written as an error
    with open(tmp_path / "internlm2-1.8b-smoke_long_500k_single.json") as f:
        single = json.load(f)
    with open(tmp_path / "internlm2-1.8b-smoke_long_500k_multi.json") as f:
        multi = json.load(f)
    assert single["knn_attention"] and "error" not in single
    assert multi["error"].startswith("ValueError")
    rooflines.main(["--dir", out])
    text = capsys.readouterr().out
    assert "| internlm2-1.8b-smoke | long_500k | **memory** |" in text
    assert "| internlm2-1.8b-smoke | long_500k | multi | FAIL |" in text
    rooflines.main(["--knn"])
    assert "| sift1m | h100 | 245 x 2^12 |" in capsys.readouterr().out


def test_tables_are_the_references(full_cell, tmp_path):
    """The same cell records through both modules: the dry-run table, the
    roofline tables and the hill-climb picks; the plan table over the
    reference's a100 plans and over the port's."""
    small = dryrun.run_cell("internlm2-1.8b-smoke", "long_500k")
    cells = [full_cell[0], small, dict(small, mesh="multi"),
             {"arch": "x", "shape": "y", "mesh": "single", "error": "E" * 80}]
    assert rooflines.dryrun_table(cells) == ref_rooflines.dryrun_table(cells)
    for mesh in ("single", "multi"):
        assert rooflines.roofline_table(cells, mesh) == \
            ref_rooflines.roofline_table(cells, mesh)
    assert rooflines.pick_hillclimb(cells) == ref_rooflines.pick_hillclimb(cells)
    for i, c in enumerate(cells):
        with open(tmp_path / f"{i}.json", "w") as f:
            json.dump(c, f)
    assert rooflines.load_cells(str(tmp_path)) == ref_rooflines.load_cells(str(tmp_path))
    for plans in ([(n, w.plan(device="a100")) for n, w in REF_WORKLOADS.items()],
                  [(n, w.plan(device="a100")) for n, w in KNN_WORKLOADS.items()]):
        assert rooflines.knn_plan_table(plans) == ref_rooflines.knn_plan_table(plans)
    assert np.isfinite(small["roofline"]["roofline_fraction"])
