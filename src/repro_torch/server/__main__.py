"""``python -m repro_torch.server`` — stand up a model-store server.

Example::

    python -m repro_torch.server --store /tmp/store --port 8750 \
        --quota-default $((1 << 30)) --max-epoch-lag 512

The engine runs on the card (``--device cuda``, the default) and exits
with its error where there is none; ``--device cpu`` selects the plain
path explicitly.
"""

from __future__ import annotations

import argparse

from ..core.engine import DEFAULT_TAU, DEFAULT_TOLERANCE, StorageEngine
from .admission import AdmissionPolicy
from .app import ModelStoreServer
from .quota import QuotaManager


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.server",
        description="Serve a NeurStore model store over HTTP.")
    ap.add_argument("--store", required=True, help="store directory path")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8750)
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="store-default quantization error bound p")
    ap.add_argument("--tau", type=float, default=DEFAULT_TAU,
                    help="store-default delta-range similarity threshold")
    ap.add_argument("--pool-bytes", type=int, default=1 << 30,
                    help="buffer pool byte budget")
    ap.add_argument("--quota-default", type=int, default=None,
                    help="default per-tenant byte quota (unset = unlimited)")
    ap.add_argument("--max-pool-utilization", type=float, default=0.95)
    ap.add_argument("--max-epoch-lag", type=int, default=256)
    ap.add_argument("--no-maintenance", action="store_true",
                    help="disable the background maintenance daemon")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the index mirrors and their kernel run")
    args = ap.parse_args(argv)

    engine = StorageEngine(
        args.store,
        tolerance=args.tolerance,
        tau=args.tau,
        pool_bytes=args.pool_bytes,
        auto_maintenance=not args.no_maintenance,
        device=args.device,
    )
    server = ModelStoreServer(
        engine,
        host=args.host,
        port=args.port,
        quotas=QuotaManager(default_limit=args.quota_default),
        admission=AdmissionPolicy(
            max_pool_utilization=args.max_pool_utilization,
            max_epoch_lag=args.max_epoch_lag,
        ),
    )
    print(f"serving {args.store} on http://{server.host}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
