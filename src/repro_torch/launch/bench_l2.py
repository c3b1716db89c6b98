"""Time the ``quantized_l2`` kernel at the save probe's distance blocks.

    PYTHONPATH=src python -m repro_torch.launch.bench_l2 [--reps 20] [--src DIR]

For each (B, N, D) distance block of a fine-tune save (``chip_smoke.py``'s
``L2_SHAPES``: internlm2-1.8b widths), holds the kernel against its plain
version (rtol 2e-3, the same argmin, bit-identical on repeat) and times it
on the device alone (``profile_steps.kernel_ms``: the durations of all the
kernels one call launches, in a ``torch.profiler`` trace of ``reps`` x (L2
flush, call)) and host-inclusive (CUDA events around one call), beside its
bound: the codes' and queries' bytes over the card's memory rate. It prints
each shape, the totals of a save and one JSON line. ``--src DIR`` times the
kernels of the port under ``DIR`` instead (an earlier tree unpacked by
``git archive``; its ``kernels`` package is loaded under a name of its own
and builds into that tree), with this script's timing:

    PYTHONPATH=src python -m repro_torch.launch.bench_l2 --src build/parent/src

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .profile_steps import kernel_ms

__all__ = ["SHAPES", "main"]

# (B, N, D) distance blocks of a fine-tune save and their count a save.
SHAPES = {(2, 4, 4194304): 2, (4, 4, 2097152): 1, (1, 6, 16777216): 6,
          (1, 2, 189530112): 2, (5, 1, 2048): 1}
SEED = 0
HBM_SXM = 3.35e12  # bytes/s, the H100 SXM data sheet


def _events_ms(fn, reps: int, flush) -> float:
    """Median ms of one call between CUDA events, after an L2 flush."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernels(src: Path | None):
    """(ops, ref) of this port's kernels, or of the port under ``src``."""
    if src is None:
        from ..kernels import ops, ref
        return ops, ref
    name, pkg = "_kernels_under_test", src / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops"), importlib.import_module(f"{name}.ref")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--src", type=Path, default=None,
                   help="the src/ directory of the port whose kernels to time (default: this one)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_l2: needs a CUDA card")
    ops, ref = _kernels(args.src and args.src.resolve())
    src = Path(ops.__file__).resolve().parents[2]
    dev = torch.device("cuda")
    buf = torch.zeros(64 << 20, dtype=torch.float32, device=dev)  # 256 MB > L2
    flush = lambda: buf.add_(1.0)  # noqa: E731
    rng = np.random.default_rng(SEED)
    out = {"device": torch.cuda.get_device_name(0), "src": str(src), "shapes": []}
    print(f"bench_l2: {out['device']}, kernels of the port under {src}", flush=True)
    tot = {"device_ms": 0.0, "ms": 0.0, "bound_ms": 0.0}
    for (b, n, d), mult in SHAPES.items():
        base = rng.normal(0, 1, d).astype(np.float32)
        q = torch.from_numpy(np.stack([base + rng.normal(0, 0.01 * (i + 1), d).astype(np.float32)
                                       for i in range(b)])).to(dev)
        codes = torch.from_numpy(rng.integers(0, 256, (n, d), dtype=np.uint8)).to(dev)
        scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, n)).to(dev)
        if n > 1:
            scales[n - 1] = 0.0  # a constant row
        zps = torch.from_numpy(rng.integers(0, 256, n).astype(np.float64)).to(dev)
        mids = torch.from_numpy(rng.normal(0, 0.5, n)).to(dev)
        call = (q, codes, scales, zps, mids)
        got = ops.quantized_l2(*call)
        want = ref.quantized_l2(*call)
        rel = float(((got - want).abs() / want.abs()).max())
        same = all(torch.equal(ops.quantized_l2(*call), got) for _ in range(3))
        if rel > 2e-3 or not torch.equal(got.argmin(1), want.argmin(1)) or not same:
            sys.exit(f"bench_l2: B={b} N={n} D={d}: rel err {rel:.3e}, argmin "
                     f"{got.argmin(1).tolist()} vs {want.argmin(1).tolist()}, repeat {same}")
        dev_ms = kernel_ms(lambda: ops.quantized_l2(*call), args.reps, flush)
        ms = _events_ms(lambda: ops.quantized_l2(*call), args.reps, flush)
        bound = (n * d + 4 * b * d) / HBM_SXM * 1e3
        row = {"b": b, "n": n, "d": d, "per_save": mult, "device_ms": dev_ms, "ms": ms,
               "bound_ms": bound, "share_of_bound": bound / dev_ms, "max_rel_err": rel}
        out["shapes"].append(row)
        print(f"B={b} N={n} D={d} x{mult}: device_ms {dev_ms:.6f} ms {ms:.6f} bound "
              f"{bound:.6f} ({bound / dev_ms:.4f} of it on the device), rel err {rel:.3e}",
              flush=True)
        for k in tot:
            tot[k] += mult * row[k]
        del q, codes, call, got, want
        torch.cuda.empty_cache()
    out.update(tot, share_of_bound=tot["bound_ms"] / tot["device_ms"])
    print(f"a save: device_ms {tot['device_ms']:.6f} ms {tot['ms']:.6f} bound "
          f"{tot['bound_ms']:.6f} ({out['share_of_bound']:.4f} of it on the device)",
          flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
