"""Render the dry run's cells as a markdown table, from its JSON records.

The port of the reference's ``tools/make_roofline_table.py`` for the port's
records (``repro_torch.launch.dryrun``, ``repro_torch.tools.hillclimb``):
the same columns and rows, except that a record's ``peak_hbm_bytes``,
which the port's dry run leaves null (nothing allocates on the ``meta``
device), renders as ``—`` where the reference's table fails on it. It
reads JSON and touches no device.

    PYTHONPATH=src python -m repro_torch.tools.make_roofline_table dryrun.json [single|multi]
"""

from __future__ import annotations

import json
import sys


def fmt_row(r) -> str:
    if r.get("skipped"):
        return (f"| {r['arch']} | {r['shape']} | — | skipped: {r['reason']} "
                f"| | | | | |")
    if "error" in r:
        return f"| {r['arch']} | {r['shape']} | — | ERROR | | | | | |"
    t = r["roofline_s"]
    pd = r["per_device"]
    mesh = "2×16×16" if r.get("multi_pod") else "16×16"
    hbm = pd["peak_hbm_bytes"]
    return ("| {a} | {s} | {m} | {hbm} | {c:.3f} | {me:.3f} | {co:.3f} "
            "| {b} | {u:.2f} | {rf:.1%} |").format(
        a=r["arch"], s=r["shape"], m=mesh,
        hbm="—" if hbm is None else f"{hbm / 2**30:.1f}",
        c=t["compute"], me=t["memory"], co=t["collective"],
        b=r["bottleneck"], u=r["useful_flops_ratio"],
        rf=r["roofline_fraction"] if r["shape"].startswith(("train", "prefill"))
        else r.get("bandwidth_fraction", 0.0))


def main(path: str, multi_pod: bool | None = None):
    with open(path) as f:
        rows = json.load(f)
    print("| arch | shape | mesh | HBM GiB/dev | compute s | memory s "
          "| collective s | bottleneck | useful-FLOPs | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    seen = set()
    for r in rows:
        if multi_pod is not None and bool(r.get("multi_pod")) != multi_pod:
            continue
        key = (r["arch"], r["shape"], r.get("skipped", False))
        if r.get("skipped") and key in seen:
            continue  # one skip record per mesh — show once
        seen.add(key)
        print(fmt_row(r))


if __name__ == "__main__":
    mp = None
    if len(sys.argv) > 2:
        mp = sys.argv[2] == "multi"
    main(sys.argv[1], mp)
