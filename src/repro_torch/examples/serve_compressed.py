"""Compression-aware serving: store a small LM in NeurStore, reload it with
flexible 8-bit deltas, and decode tokens computing directly on quantized
weights — reconstruction error stays bounded and generation matches.

The port of the reference's ``examples/serve_compressed.py``: qwen3-8b at
smoke size (head dim 16), saved through ``CheckpointManager`` and restored
exact and at ``bits=8``, then 16 greedy ``decode_step`` tokens from each.
Decode runs the plain attention over the cache (the attention kernel takes
head dims 32, 64, 80, 128 and 256, and a decode-only loop reaches none).

    PYTHONPATH=src python -m repro_torch.examples.serve_compressed [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..kernels.ops import resolve_device
from ..models import decode_step, init_cache, init_params

ARCH = "qwen3-8b"
SEED = 0


def _decode_n(params, cfg, dev, n=16):
    """``n`` greedy tokens at batch 2 from token 0: (2, n) int tensor."""
    with torch.inference_mode():
        cache = init_cache(cfg, 2, 64, device=dev)
        toks = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        out = []
        for t in range(n):
            logits, cache = decode_step(params, cache, {"tokens": toks}, t, cfg)
            toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out.append(toks)
    return torch.cat(out, 1)


def serve(cfg, params, device) -> dict:
    """Save ``params`` as step 0, restore exact and at ``bits=8``, decode
    from both; prints and returns the agreement and the storage report."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root, device=dev)
        try:
            mgr.save(0, params)

            # Full-precision restore vs flexible 8-bit restore.
            _, exact = mgr.restore()
            _, flex = mgr.restore(bits=8)

            g_exact = _decode_n(exact["params"], cfg, dev)
            g_flex = _decode_n(flex["params"], cfg, dev)
            agree = float((g_exact == g_flex).float().mean())
            print(f"greedy decode agreement exact vs flexible-8bit: {agree:.2%}")
            report = mgr.storage_report()
            print(f"storage report: {report}")
        finally:
            mgr.close()
    return {"agreement": agree, "storage_report": report,
            "tokens_exact": g_exact.cpu().tolist(), "tokens_flex": g_flex.cpu().tolist()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_compressed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model, the decode and the engine's kernel run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(ARCH, smoke=True)
    return serve(cfg, init_params(cfg, SEED, device=dev), dev)


if __name__ == "__main__":
    main()
