"""Render the §Dry-run / §Roofline tables from the H100 dry-run's records.

  PYTHONPATH=src python -m repro_torch.launch.report \
      [--dir experiments/dryrun_torch]

The port of ``repro.launch.report``: the same tables, the same text from
the same records; only the default directory differs (the records of
``python -m repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List


def load(dirname: str) -> List[dict]:
    recs = []
    for f in sorted(os.listdir(dirname)):
        if f.endswith(".json"):
            with open(os.path.join(dirname, f)) as fh:
                recs.append(json.load(fh))
    return recs


def fmt_flops(x: float) -> str:
    return f"{x / 1e12:.2f}T" if x >= 1e12 else f"{x / 1e9:.2f}G"


def fmt_bytes(x: float) -> str:
    if x >= 2**30:
        return f"{x / 2**30:.2f}GiB"
    return f"{x / 2**20:.1f}MiB"


def roofline_table(recs: List[dict], mesh: str = "16x16") -> str:
    rows = ["| arch | shape | t_comp ms | t_mem ms | t_coll ms | bound | "
            "useful | roofline |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skip | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | FAILED | | | | | |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_ms']:.2f} | "
            f"{r['t_memory_ms']:.2f} | {r['t_collective_ms']:.2f} | "
            f"{r['dominant'][:4]} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.4f} |")
    return "\n".join(rows)


def dryrun_table(recs: List[dict]) -> str:
    rows = ["| arch | shape | mesh | status | flops/dev | HLO bytes/dev | "
            "coll/dev | peak mem |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "ok":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                f"{fmt_flops(r['flops_dev'])} | "
                f"{fmt_bytes(r.get('bytes_hlo_dev', 0))} | "
                f"{fmt_bytes(r['coll_dev'])} | "
                f"{r['peak_memory_gb']:.2f}GB |")
        else:
            why = r.get("reason", r.get("error", ""))[:40]
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{r['status']} | {why} | | | |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--table", choices=["roofline", "dryrun", "both"],
                    default="both")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.table in ("dryrun", "both"):
        print("## Dry-run records\n")
        print(dryrun_table(recs))
        print()
    if args.table in ("roofline", "both"):
        print(f"## Roofline ({args.mesh})\n")
        print(roofline_table(recs, args.mesh))
    ok = sum(1 for r in recs if r["status"] == "ok")
    skip = sum(1 for r in recs if r["status"] == "skipped")
    fail = len(recs) - ok - skip
    print(f"\ncells: {ok} ok / {skip} skipped / {fail} failed "
          f"of {len(recs)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
