"""The paper's e-commerce scenario: one pretrained model, many per-segment
fine-tunes. NeurStore dedups them against shared base tensors; compare
against PostgresML-blob and ELF*-file stores.

The port of the reference's ``examples/finetune_dedup.py``: the same 7
models and three stores, prints and bound. On the card the NeurStore
saves probe their indexes through the ``quantized_l2`` kernel.

    PYTHONPATH=src python -m repro_torch.examples.finetune_dedup [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from ..baselines import BlobStore, FileStore
from ..core import StorageEngine
from ..kernels.ops import resolve_device
from ._workload import finetune, transformer_tensors

N_SEGMENTS = 6  # user segments, each with its own fine-tune


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.finetune_dedup")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the NeurStore engine's index mirrors and kernel run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = transformer_tensors(d=128, layers=4, seed=0)
    models = [("pretrained", base)] + [
        (f"segment{i}", finetune(base, seed=10 + i, sigma=5e-4))
        for i in range(N_SEGMENTS)
    ]
    orig = sum(sum(t.size * 4 for t in ts.values()) for _, ts in models)
    totals = {}

    with tempfile.TemporaryDirectory() as root:
        stores = {
            "neurstore": StorageEngine(root + "/ns", device=dev),
            "postgresml(blob)": BlobStore(root + "/pg"),
            "elf*(file)": FileStore(root + "/elf"),
        }
        ns = stores["neurstore"]
        try:
            print(f"{len(models)} models, {orig/1e6:.1f} MB raw")
            for name, store in stores.items():
                for mn, ts in models:
                    store.save_model(mn, {"task": "ctr"}, ts)
                total = totals[name] = store.storage_bytes()["total"]
                print(f"  {name:18s} {total/1e6:7.1f} MB  ratio {orig/total:.2f}x")
            rep = ns.load_model("segment0").materialize()
        finally:
            ns.close()
    err = max(np.abs(rep[k] - dict(models)["segment0"][k]).max() for k in rep)
    # Bound: p (compression) + half-ulp of the float32 output cast.
    print(f"segment0 reconstruction max err: {err:.2e} "
          f"(p + f32 rounding = {2**-24 + 2**-24:.2e})")
    if not err <= 2 ** -23:
        raise AssertionError(f"segment0 reconstruction max err {err} > 2**-23")
    return {"models": len(models), "raw_bytes": orig, "totals": totals,
            "ratios": {name: orig / total for name, total in totals.items()},
            "max_err": float(err)}


if __name__ == "__main__":
    main()
