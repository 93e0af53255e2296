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
cell is counted as rank 0 of the reference's (16, 16) mesh without
allocating its shard's 2.6 GB of state, leaving no process group, with
the reference's record keys (``test_torch_dryrun_mesh.py`` holds rank 0's counts on small meshes to
the reference's per-device programs).
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
    op_census,
    program_cost,
    search_cost,
)
from repro_torch.configs import KNN_WORKLOADS
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tfm
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


def _shard_params(cfg, model: int = 16) -> int:
    """The parameters of rank 0's shard: each dim whose logical axis maps
    to "model" (heads, kv heads, d_ff, vocabulary) divided where 16
    divides it, as the reference's ``_sanitize_spec`` keeps it."""
    over = {"heads", "kv_heads", "ffn", "vocab"}
    total = 0
    for name, p in tfm.Transformer(cfg, device="meta").named_parameters():
        n = 1
        for size, ax in zip(p.shape, tfm.model_axes(cfg)[name]):
            n *= size // model if ax in over and size % model == 0 else size
        total += n
    return total


@pytest.fixture(scope="module")
def full_cell():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cell = dryrun.run_cell("internlm2-1.8b", "train_4k")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    return cell, grown * 1024  # ru_maxrss is in KiB on Linux


def test_full_width_train_cell_is_counted_without_allocating(full_cell):
    cell, grown = full_cell
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config

    cfg = get_config("internlm2-1.8b")
    assert not dist.is_initialized()  # run_cell's fake group is gone
    top, memory, roof = _ref_keys()
    assert set(cell) == top
    assert set(cell["memory"]) == memory and set(cell["roofline"]) == roof
    # rank 0 of (16, 16): f32 masters and both moments of its shard (12
    # bytes a parameter; the 8 kv heads whole over 16), the step, its 16
    # of the batch's 256 rows
    batch = 2 * SHAPES["train_4k"].global_batch // 16 * SHAPES["train_4k"].seq_len * 4
    assert cell["memory"]["argument_bytes"] == 12 * _shard_params(cfg) + 4 + batch
    assert grown < 2e9 < cell["memory"]["argument_bytes"]
    assert cell["memory"]["peak_bytes"] > cell["memory"]["argument_bytes"]
    assert cell["chips"] == 256 and cell["mesh"] == "single"
    assert cell["hlo_flops"] == 256 * cell["hlo_flops_per_device"]
    kinds = cell["collective_breakdown"]
    assert cell["collective_bytes"] == sum(kinds.values()) > 0
    # no ZeRO-3 (internlm2 has no fsdp_params): all-reduces only, of the
    # data axis' gradients and "model"'s operators
    assert set(kinds) == set(cell["collective_counts"]) == {"all-reduce"}
    r = cell["roofline"]
    assert r["model_flops"] == dryrun.model_flops(cfg, SHAPES["train_4k"])
    # the port's dots beyond 6·N·D / 256: attention's scores and values,
    # the forward again where remat="dots" recomputes the batched
    # products, and the whole kv heads' projections on every rank of
    # "model"; Megatron's all-reduces of 16 x 4,096 tokens over the h100
    # profile's link dominate
    assert 0.4 < r["useful_ratio"] < 0.6 and r["dominant"] == "collective"
    assert r["step_time_s"] == max(r[k] for k in ("compute_s", "memory_s",
                                                  "collective_s", "instruction_s"))
    with pytest.raises(NotImplementedError, match=r"14b\.4"):
        dryrun.run_cell("internlm2-1.8b", "train_4k", "multi")


def test_cli_writes_cells_and_the_tables_render(tmp_path, capsys):
    """Every shape of a smoke arch on both meshes: the training cell on
    "single" counts (rank 0 of (16, 16)); the serving cells there
    (ROADMAP item 14c.2) and every "multi" cell (item 14b.4) are written
    as error records."""
    out = str(tmp_path)
    rc = dryrun.main(["--arch", "internlm2-1.8b-smoke", "--mesh", "both",
                      "--out", out])
    assert rc == 1  # the refused cells are written as errors
    cells = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for mesh in ("single", "multi"):
            with open(tmp_path / f"internlm2-1.8b-smoke_{shape}_{mesh}.json") as f:
                cells[shape, mesh] = json.load(f)
    single = cells["train_4k", "single"]
    assert "error" not in single and single["chips"] == 256
    assert single["collective_bytes"] > 0
    for (shape, mesh), cell in cells.items():
        if (shape, mesh) != ("train_4k", "single"):
            assert cell["error"].startswith("NotImplementedError")
            assert ("14b.4" if mesh == "multi" else "14c.2") in cell["error"]
    rooflines.main(["--dir", out])
    text = capsys.readouterr().out
    assert "| internlm2-1.8b-smoke | train_4k | **" in text
    assert "| internlm2-1.8b-smoke | long_500k | multi | FAIL |" in text
    assert "| internlm2-1.8b-smoke | long_500k | single | FAIL |" in text
    rooflines.main(["--knn"])
    assert "| sift1m | h100 | 245 x 2^12 |" in capsys.readouterr().out


def test_tables_are_the_references(full_cell, tmp_path):
    """The same cell records through both modules: the dry-run table, the
    roofline tables and the hill-climb picks; the plan table over the
    reference's a100 plans and over the port's."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_host_mesh

    # a serving cell counted on a (1, 1) mesh (the production mesh's
    # serving cells are ROADMAP item 14c.2)
    cfg, shape = get_config("internlm2-1.8b-smoke"), SHAPES["long_500k"]
    cost = dryrun.count_cell(cfg, shape, make_host_mesh(1, devices=["meta"]))
    small = dryrun.cell_record(cfg, shape, "single", cost, chips=1)
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
