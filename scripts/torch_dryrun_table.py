"""The port's dry-run records as one Markdown table of counts.

Reads the ``{arch}_{shape}_single.json`` records that ``python -m
repro_torch.launch.dryrun`` writes (``--dir``, default ``dryrun_torch``;
every ``"multi"`` cell is refused until ROADMAP item 14b.4) and prints, for each counted cell, rank 0's dot FLOPs and HBM bytes, its
collectives' wire bytes by the reference's kinds, its argument and peak
bytes, and the dominant roofline term with ``roofline_fraction`` on the
record's hardware profile.  These are counts and profile arithmetic on
the CPU, not times.  A refused cell is listed with its error.

Usage:
  PYTHONPATH=src python scripts/torch_dryrun_table.py --dir dryrun_torch
"""
import argparse
import glob
import json
import os

KINDS = ("all-reduce", "all-gather", "reduce-scatter")


def _gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.2f}"


def table(cells) -> str:
    rows = ["| arch | shape | chips | dot FLOPs/dev | HBM B/dev | "
            + " | ".join(f"{k} GB" for k in KINDS)
            + " | argument GB | peak GB | dominant | roofline_fraction |",
            "|---" * (9 + len(KINDS)) + "|"]
    for c in cells:
        if "error" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | | refused: "
                        f"{c['error'][:70]} |" + " |" * (5 + len(KINDS)))
            continue
        kinds = c["collective_breakdown"]
        mem, roof = c["memory"], c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['chips']} "
            f"| {c['hlo_flops_per_device']:.4e} | {c['hlo_bytes_per_device']:.4e} | "
            + " | ".join(_gb(kinds.get(k, 0.0)) for k in KINDS)
            + f" | {_gb(mem['argument_bytes'])} | {_gb(mem['peak_bytes'])} "
            f"| {roof['dominant']} | {roof['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="dryrun_torch")
    args = ap.parse_args(argv)
    cells = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*_single.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    print(table(cells))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
