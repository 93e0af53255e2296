"""Dry-run and roofline tables from the per-cell JSON records written by
``repro_torch.launch.dryrun``, and kNN kernel-plan tables.

Port of ``src/repro/analysis/rooflines.py`` (its own copy: the reference
module imports no JAX, but the port imports nothing of the reference).
The terms are per card on the ``"h100"`` profile (the dry run's default);
the port has no TPU profile.

  PYTHONPATH=src python -m repro_torch.analysis.rooflines [--dir dryrun_torch]

``knn_plan_table`` renders ``repro_torch.search.plan.Plan`` rows, the
registry's workloads on the port's GPU profiles:

  PYTHONPATH=src python -m repro_torch.analysis.rooflines --knn
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load_cells(directory: str) -> List[Dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(cells: List[Dict], mesh: str = "single") -> str:
    rows = [
        "| arch | shape | dominant | compute | memory | collective | instr "
        "| roofline frac | useful ratio | notes |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("mesh") != mesh or "error" in c:
            continue
        r = c["roofline"]
        notes = "knn-attn" if c.get("knn_attention") else ""
        rows.append(
            f"| {c['arch']} | {c['shape']} | **{r['dominant']}** "
            f"| {_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} "
            f"| {_fmt_s(r['collective_s'])} | {_fmt_s(r['instruction_s'])} "
            f"| {r['roofline_fraction']:.3f} | {r['useful_ratio']:.2f} | {notes} |"
        )
    return "\n".join(rows)


def dryrun_table(cells: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | compile | flops/dev | bytes/dev (lo..hi) "
        "| collective B/dev | top collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if "error" in c:
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | FAIL | | | "
                f"| {c['error'][:60]} |"
            )
            continue
        kinds = c.get("collective_breakdown", {})
        top = ", ".join(
            f"{k}:{v / 1e6:.0f}MB"
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])[:2]
        )
        lo = c.get("hlo_bytes_per_device", 0)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['compile_s']}s "
            f"| {c['hlo_flops_per_device']:.2e} | {lo:.2e} "
            f"| {c['collective_bytes']:.2e} | {top} |"
        )
    return "\n".join(rows)


def knn_plan_table(plans) -> str:
    """Markdown table over ``repro_torch.search.plan.Plan`` rows: one row
    per planned workload, straight from the planner that configures the
    live kernels."""
    rows = [
        "| workload | device | L x 2^W | tiles (bm, bn, qb) | I_MEM | I_COP "
        "| wall | attainable | E[recall] |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for label, p in plans:
        rows.append(
            f"| {label} | {p.device} | {p.num_bins} x 2^{p.log2_bin_size} "
            f"| ({p.block_m}, {p.block_n}, {p.query_block}) "
            f"| {p.i_mem:.0f} | {p.i_cop:.1f} | **{p.bottleneck}** "
            f"| {p.attainable_flops / 1e12:.1f} TF/s "
            f"| {p.expected_recall:.4f} |"
        )
    return "\n".join(rows)


def knn_main() -> None:
    """Print the registry's plan table on the card's profile and the two
    older GPUs' (the port has no TPU profile)."""
    from repro_torch.configs.knn_workloads import KNN_WORKLOADS

    plans = [
        (name, w.plan(device=dev))
        for name, w in KNN_WORKLOADS.items()
        for dev in ("h100", "a100", "v100")
    ]
    print("## KNN kernel plans (repro_torch.search.plan)\n")
    print(knn_plan_table(plans))


def pick_hillclimb(cells: List[Dict]):
    """worst roofline fraction / most collective-bound / most paper-like."""
    ok = [c for c in cells if "error" not in c and c["mesh"] == "single"]
    worst = min(ok, key=lambda c: c["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda c: c["roofline"]["collective_s"]
               / max(c["roofline"]["step_time_s"], 1e-12))
    knn = [c for c in ok if c.get("knn_attention")]
    paper = max(knn, key=lambda c: c["hlo_flops_per_device"]) if knn else ok[0]
    return worst, coll, paper


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="dryrun_torch")
    ap.add_argument("--knn", action="store_true",
                    help="print planner-derived KNN kernel plan tables")
    args = ap.parse_args(argv)
    if args.knn:
        knn_main()
        return
    cells = load_cells(args.dir)
    print("## Dry-run (all cells)\n")
    print(dryrun_table(cells))
    print("\n## Roofline (one card, per-device terms, H100)\n")
    print(roofline_table(cells, "single"))
    w, c, p = pick_hillclimb(cells)
    print(
        f"\nhillclimb picks: worst-frac={w['arch']}x{w['shape']} "
        f"(frac {w['roofline']['roofline_fraction']:.3f}); "
        f"collective-bound={c['arch']}x{c['shape']}; "
        f"paper-representative={p['arch']}x{p['shape']} (knn-attn)"
    )


if __name__ == "__main__":
    main()
