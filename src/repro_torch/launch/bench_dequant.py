"""Sweep the ``dequant_matmul`` kernels' launch plans at the decode shapes.

    PYTHONPATH=src python -m repro_torch.launch.bench_dequant [--reps 20] [--flush dirty|clean]

For each (K, N) of the compressed decode step of ``chip_smoke.py``'s phase
4 (internlm2-1.8b widths, x of 4 rows) and each kernel (int8 and int4
delta), launches the kernel under every plan (``tn`` column threads,
``cluster`` blocks splitting K) that gives at least half as many blocks as
the card has SMs, and times it on the device alone
(``profile_steps.kernel_ms``: its kernels' durations in a ``torch.profiler``
trace of ``reps`` x (L2 flush, launch)). ``--flush dirty`` flushes by writing 256 MB (as ``chip_smoke.py``
does, which leaves the L2 full of lines to write back), ``clean`` by
reading them. It prints each plan's time, the plan that
``kernels.dequant_matmul.plan`` picks and the fastest, and ends with one
JSON line. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from ..kernels import dequant_matmul as dm
from ..kernels import ops
from .profile_steps import kernel_ms

__all__ = ["main"]

SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048), (2048, 92544)]
M, SEED = 4, 0
SCALARS = {False: (0.013, -11.0, 3.1e-4, -64.0), True: (0.013, -11.0, 5e-4, 8.0)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--flush", choices=("dirty", "clean"), default="dirty")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_dequant: needs a CUDA card")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.zeros(64 << 20, dtype=torch.float32, device=dev)  # 256 MB > L2
    flush = (lambda: buf.add_(1.0)) if args.flush == "dirty" else (lambda: buf.sum())
    lib = dm._library()
    rng = np.random.default_rng(SEED)
    out = {"device": torch.cuda.get_device_name(0), "sms": sms, "flush": args.flush,
           "shapes": []}
    print(f"bench_dequant: {out['device']}, {sms} SMs, M={M}, {args.flush} flush", flush=True)
    for k, n in SHAPES:
        x = torch.from_numpy(rng.normal(0, 1, (M, k)).astype(np.float32)).to(dev)
        base = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev)
        codes = {False: torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev),
                 True: ops.pack_int4(torch.from_numpy(
                     rng.integers(0, 16, (k, n), dtype=np.uint8)).to(dev))}
        for packed in (False, True):
            fn = lib.dequant_matmul_int4 if packed else lib.dequant_matmul_int8
            scal = SCALARS[packed]
            delta = codes[packed]
            y = torch.empty((M, n), dtype=torch.float32, device=dev)
            picked = dm.plan(M, k, n, sms, packed)
            name = "int4" if packed else "int8"
            stream = torch.cuda.current_stream().cuda_stream
            rows = []
            for tn in (32, 16, 8, 4, 2):
                strips = math.ceil(n / (16 * tn))
                for cluster in range(1, 9):
                    if strips * cluster < sms // 2 or strips * cluster > 16 * sms:
                        continue
                    unit = 2 if packed else 1
                    kblock = math.ceil(math.ceil(k / cluster) / unit) * unit
                    if kblock * (cluster - 1) >= k:
                        continue

                    def launch(tn=tn, strips=strips, cluster=cluster, kblock=kblock):
                        err = fn(x.data_ptr(), base.data_ptr(), delta.data_ptr(), y.data_ptr(),
                                 M, k, n, *scal, picked.groups, tn, strips, cluster, kblock, 1,
                                 stream)
                        if err:
                            raise RuntimeError(f"launch failed: {err}")

                    us = kernel_ms(launch, args.reps, flush, match="dq_matmul_kernel") * 1e3
                    rows.append({"tn": tn, "cluster": cluster, "blocks": strips * cluster,
                                 "us": us})
            best = min(rows, key=lambda r: r["us"])
            mine = next(r for r in rows if (r["tn"], r["cluster"]) == (picked.tn, picked.cluster))
            print(f"K={k} N={n} {name}: plan tn={picked.tn} cluster={picked.cluster} "
                  f"{mine['us']:.3f} us; fastest tn={best['tn']} cluster={best['cluster']} "
                  f"{best['us']:.3f} us", flush=True)
            print("  " + "  ".join(f"{r['tn']}/{r['cluster']}:{r['us']:.2f}" for r in rows),
                  flush=True)
            out["shapes"].append({"k": k, "n": n, "kernel": name, "plan": [picked.tn,
                                  picked.cluster], "plan_us": mine["us"], "best": best,
                                  "all": rows})
        del x, base, codes
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
