"""Time a ``flash_attention`` route at the prefill and test shapes.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash [--dtype float32|bfloat16]
        [--reps 10] [--src DIR]

float32 (the default): at recurrentgemma-9b's prefill shape (``chip_smoke.py``'s
``FA_RG_PREFILL``: q (1, 8192, 16, 256), k/v (1, 8192, 1, 256), causal,
window 2048), at the internlm2-1.8b prefill shape (``FA_PREFILL``: q (4,
2048, 16, 128), k/v (4, 2048, 8, 128), causal) and at the shapes of the
reference's kernel tests, at their own head dims (``FA_TEST_SHAPES``) and at
256 (``FA_TEST_SHAPES_256``), held against the plain version within rtol
1e-4, atol 2e-5; the bound is the larger of the bytes over the card's
memory rate and three tf32 products for each operation the inputs need at
the tf32 tensor-core rate (one tf32 product misses the tolerance), with the
float32 CUDA-core figure beside it; at head dim 256 each shape also prints
the K/V tile bytes a launch loads at the float32 kernel's 64-row blocks.
bfloat16: at recurrentgemma-9b's prefill shape
(``FA_RG_PREFILL``: q (1, 8192, 16, 256), k/v (1, 8192, 1, 256), causal,
window 2048), the internlm2-1.8b prefill and the head-dim-256 test shapes,
held within rtol 1e-2, atol 1e-5 (``FA_BF16_TOL``); the bound takes the bf16
tensor-core rate, and each shape also prints the K/V tile bytes a launch
loads at 128-row and at 64-row blocks (``flash_attention.kv_tile_bytes``).

Each shape is timed on the device alone (``profile_steps.kernel_rounds_ms``:
the durations of the kernels one call launches, in a ``torch.profiler``
trace of ``reps`` x (L2 flush, call); the median and the range over the
rounds) and host-inclusive (CUDA events around each call after an L2 flush,
the median of ``reps``), the two back to back in each turn. ``--src DIR``
also loads the kernels of the port under ``DIR`` (an earlier tree unpacked
by ``git archive``; its ``kernels`` package is loaded under a name of its
own and builds into that tree) and times the two in turns, ``DIR``'s, this
tree's, this tree's, ``DIR``'s, at each shape, in one process on one card:

    PYTHONPATH=src python -m repro_torch.launch.bench_flash --dtype float32 \\
        --src build/parent/src

The card's SM clock, power draw and temperature (``nvidia-smi``) are
printed before and after each shape. It prints each shape and one JSON
line. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels.flash_attention import F32_DH256_BLOCK_ROWS, kv_tile_bytes
from .bench_l2 import _events_ms, _kernels
from .profile_steps import card_state, kernel_rounds_ms

__all__ = ["SHAPES", "main"]

# (B, Sq, Sk, H, KV, dh, causal, window): the prefill, then the test shapes.
PREFILL = (4, 2048, 2048, 16, 8, 128, True, 0)
RG_PREFILL = (1, 8192, 8192, 16, 1, 256, True, 2048)
TEST_SHAPES = [(2, 256, 256, 8, 4, 64, True, 0), (1, 256, 256, 4, 1, 128, True, 64),
               (2, 128, 128, 8, 8, 64, False, 0), (1, 200, 256, 8, 2, 64, True, 0),
               (1, 384, 384, 16, 16, 80, False, 0), (1, 37, 37, 4, 2, 64, False, 0),
               (2, 50, 100, 8, 4, 32, False, 0), (1, 100, 50, 4, 4, 64, False, 0)]
SHAPES = {
    "float32": [RG_PREFILL, PREFILL, *TEST_SHAPES,
                *(shape[:5] + (256,) + shape[6:] for shape in TEST_SHAPES)],
    "bfloat16": [RG_PREFILL, PREFILL,
                 (1, 256, 256, 16, 1, 256, True, 64), (1, 96, 96, 8, 8, 256, True, 0)],
}
TOL = {"float32": (1e-4, 2e-5), "bfloat16": (1e-2, 1e-5)}
SEED = 0
HBM_SXM = 3.35e12      # bytes/s, the H100 SXM data sheet
BF16_TC_PEAK = 989e12  # dense bf16 tensor-core rate
TF32_TC_PEAK = 495e12  # dense tf32 tensor-core rate
FP32_PEAK = 67e12      # float32 outside the tensor cores
SPLIT = 3              # tf32 products a float32 operation takes (hi hi + hi lo + lo hi)


def _pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    q = np.arange(sq)
    hi = np.minimum(sk, q + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", choices=sorted(SHAPES), default="float32")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--src", type=Path, default=None,
                   help="the src/ directory of another port to time in turns with this one")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_flash: needs a CUDA card")
    ops, ref = _kernels(None)
    trees = {"this": ops}
    if args.src is not None:
        trees["other"] = _kernels(args.src.resolve())[0]
    turns = ["other", "this", "this", "other"] if "other" in trees else ["this"]
    dtype = getattr(torch, args.dtype)
    rtol, atol = TOL[args.dtype]
    dev = torch.device("cuda")
    buf = torch.zeros(64 << 20, dtype=torch.float32, device=dev)  # 256 MB > L2
    flush = lambda: buf.add_(1.0)  # noqa: E731
    rng = np.random.default_rng(SEED)
    out = {"device": torch.cuda.get_device_name(0), "dtype": args.dtype,
           "src": {k: str(Path(m.__file__).resolve().parents[2]) for k, m in trees.items()},
           "turns": turns, "shapes": []}
    print(f"bench_flash: {out['device']}, {args.dtype}, kernels of {out['src']}, turns {turns}",
          flush=True)
    for shape in SHAPES[args.dtype]:
        b, sq, sk, h, kv, dh, causal, window = shape
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, s, n, dh)).astype(np.float32))
                   .to(dev, dtype) for s, n in ((sq, h), (sk, kv), (sk, kv)))
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        row = {"shape": list(shape), "smi_before": card_state()}
        for name, mod in trees.items():
            got = mod.flash_attention(q, k, v, causal=causal, window=window)
            err = (got.double() - want.double()).abs()
            ratio = float((err / (atol + rtol * want.double().abs())).max())
            if ratio > 1.0 or not torch.isfinite(got).all():
                sys.exit(f"bench_flash: {name} at {shape}: allclose ratio {ratio:.3f} "
                         f"(rtol {rtol}, atol {atol})")
            row[f"{name}_ratio"] = ratio
        for i, name in enumerate(turns):
            call = lambda m=trees[name]: m.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                                           window=window)
            rounds = kernel_rounds_ms(call, args.reps, flush)
            row[f"{name}_device_ms_{i}"] = float(np.median(rounds))
            row[f"{name}_device_range_{i}"] = [min(rounds), max(rounds)]
            row[f"{name}_ms_{i}"] = _events_ms(call, args.reps, flush)
        row["smi_after"] = card_state()
        flops = 4 * b * h * dh * _pairs(sq, sk, causal, window)
        nbytes = (2 * b * sq * h + 2 * b * sk * kv) * dh * q.element_size()
        t_bytes = nbytes / HBM_SXM * 1e3
        if dtype == torch.bfloat16:
            t_ops = flops / BF16_TC_PEAK * 1e3
            row["kv_tile_bytes"] = {
                str(rows): kv_tile_bytes(b, sq, sk, h, kv, dh, causal=causal, window=window,
                                         block_rows=rows) for rows in (128, 64)}
        else:
            t_ops = SPLIT * flops / TF32_TC_PEAK * 1e3
            row["fp32_core_bound_ms"] = flops / FP32_PEAK * 1e3
            if dh == 256:
                row["kv_tile_bytes"] = {str(F32_DH256_BLOCK_ROWS): kv_tile_bytes(
                    b, sq, sk, h, kv, dh, causal=causal, window=window,
                    block_rows=F32_DH256_BLOCK_ROWS, elem_bytes=4)}
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for name in trees:
            for what in ("device_ms", "ms"):
                times = [row[f"{name}_{what}_{i}"] for i, t in enumerate(turns) if t == name]
                row[f"{name}_{what}"] = float(np.mean(times))
            row[f"{name}_share_of_bound"] = row["bound_ms"] / row[f"{name}_device_ms"]
        out["shapes"].append(row)
        line = "; ".join(
            f"{t} device {row[f'{t}_device_ms_{i}']:.6f} "
            f"({row[f'{t}_device_range_{i}'][0]:.6f}-{row[f'{t}_device_range_{i}'][1]:.6f}) "
            f"host-inclusive {row[f'{t}_ms_{i}']:.6f}" for i, t in enumerate(turns))
        extra = ("" if dtype == torch.bfloat16
                 else f" (float32 CUDA-core figure {row['fp32_core_bound_ms']:.6f})")
        if "kv_tile_bytes" in row:
            extra += "; K/V tile bytes a launch " + ", ".join(
                f"{n} at {rows}-row blocks" for rows, n in row["kv_tile_bytes"].items())
        print(f"{shape}: in turns: {line}; bound {row['bound_ms']:.6f} ({row['bound_by']})"
              f"{extra}; this tree {row['this_share_of_bound']:.4f} of it"
              + (f", other {row['other_share_of_bound']:.4f}; device speed-up "
                 f"{row['other_device_ms'] / row['this_device_ms']:.3f}x" if "other" in trees
                 else "")
              + f"; nvidia-smi clocks.sm, power.draw, temperature before [{row['smi_before']}] "
              f"after [{row['smi_after']}]", flush=True)
        del q, k, v, want, got
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
