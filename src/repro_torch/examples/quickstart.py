"""Quickstart: save two related models into NeurStore, load one back
compression-aware, and run a compute-on-compressed matmul.

The port of the reference's ``examples/quickstart.py``: the same models,
saves, prints and numbers, with the matmul on the port's
``dequant_matmul`` (one launch of the int8 kernel on the card; its plain
version with ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..core import StorageEngine
from ..kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine's index mirrors and the matmul run")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    rng = np.random.default_rng(0)

    with tempfile.TemporaryDirectory() as root:
        engine = StorageEngine(root, device=dev)
        try:
            # A "pretrained" model and a fine-tune of it.
            base = {"proj/w": rng.normal(0, 0.02, (256, 256)).astype(np.float32)}
            ft = {"proj/w": base["proj/w"]
                  + rng.normal(0, 3e-4, (256, 256)).astype(np.float32)}

            r0 = engine.save_model("pretrained", {"family": "demo"}, base)
            r1 = engine.save_model("finetune", {"family": "demo"}, ft)
            print(f"pretrained: {r0.n_new_bases} new bases, page {r0.page_bytes}B")
            print(f"finetune:   {r1.n_new_bases} new bases (deduped!), page "
                  f"{r1.page_bytes}B, ratio {r1.original_bytes / r1.page_bytes:.2f}x, "
                  f"mean {r1.mean_nbit:.1f} bits/weight")

            # Compression-aware load: quantized components, no full decompress.
            lm = engine.load_model("finetune", bits=8)   # flexible 8-bit loading
            try:
                comp = lm.compressed_params()["proj/w"]
            finally:
                lm.close()

            # Compute directly on the compressed tensor (fused dequant+matmul:
            # on the card the float32 weight never exists in device memory).
            x = rng.normal(0, 1, (8, 256)).astype(np.float32)
            y = ops.dequant_matmul(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(comp["base_codes"]).to(dev),
                comp["base_scale"], comp["base_zp"],
                torch.from_numpy(comp["qdelta_i8"]).to(dev),
                comp["delta_scale"], comp["delta_zp_i8"])
            y_ref = x @ ft["proj/w"]
            err = np.abs(y.cpu().numpy() - y_ref).max() / np.abs(y_ref).max()
            print(f"compute-on-compressed rel err: {err:.2e}")
            storage = engine.storage_bytes()
            print(f"storage: {storage}")
        finally:
            engine.close()
    return {"pretrained_new_bases": r0.n_new_bases, "pretrained_page_bytes": r0.page_bytes,
            "finetune_new_bases": r1.n_new_bases, "finetune_page_bytes": r1.page_bytes,
            "finetune_ratio": r1.original_bytes / r1.page_bytes,
            "finetune_mean_nbit": r1.mean_nbit, "rel_err": float(err), "storage": storage}


if __name__ == "__main__":
    main()
