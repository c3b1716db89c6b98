"""Hillclimb: re-measure the chosen dry-run cells with the
optimization under test and emit their records as JSON.

The port of the reference's ``tools/hillclimb.py`` on
:func:`repro_torch.launch.dryrun.run_cell`, which places and steps each
cell on the ``meta`` device as rank 0 of a fake process group (so no host
devices are forced into being, and nothing runs on a card). It keeps
``--only`` (a substring of the cell labels) and ``--out``, and writes the
file after every cell. It exits 1 when any cell's record holds an
``error``, 0 otherwise.

``--device`` (default ``cuda``) is checked as by the other tools: without
a card the tool exits with the engine's error unless given ``--device
cpu``. The cells themselves need no card.

The fake process group takes the process's default group, so run this as
its own process:

    PYTHONPATH=src python -m repro_torch.tools.hillclimb --out hillclimb.json
    PYTHONPATH=src python -m repro_torch.tools.hillclimb --only internlm2_train --device cpu
"""

from __future__ import annotations

import argparse
import json

from ..kernels.ops import resolve_device
from ..launch.dryrun import run_cell

CELLS = [
    # (label, arch, shape, kwargs)
    ("arctic_train/grouped_moe", "arctic-480b", "train_4k", {}),
    ("granite_train/grouped_moe", "granite-moe-3b-a800m", "train_4k", {}),
    ("qwen3_train/dp_zero", "qwen3-8b", "train_4k", {"profile": "dp"}),
    ("internlm2_train/dp_zero", "internlm2-1.8b", "train_4k", {"profile": "dp"}),
    ("deepseek_decode/compressed", "deepseek-67b", "decode_32k",
     {"compressed": True}),
    ("qwen3_decode/compressed", "qwen3-8b", "decode_32k",
     {"compressed": True}),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.hillclimb")
    ap.add_argument("--out", default="hillclimb.json")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="checked as by the other tools; the cells run on 'meta'")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    results = []
    for label, arch, shape, kw in CELLS:
        if args.only and args.only not in label:
            continue
        print(f"\n### {label}: {arch} × {shape} {kw}")
        try:
            rec = run_cell(arch, shape, multi_pod=False, **kw)
            rec["label"] = label
        except Exception as e:  # a failed cell is recorded and fails the run
            rec = {"label": label, "error": repr(e)[:500]}
            print(f"!! {label} failed: {e!r}")
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if any("error" in rec for rec in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
