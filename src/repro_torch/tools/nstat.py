"""``nstat`` — one-shot or watch-mode dashboard over NeurStore metrics.

The port of the reference's ``tools/nstat.py``: the same flags, rendering
and exit codes, on ``repro_torch``'s metrics registry, trace ring and
store facade, with ``--device``.

Two sources, one output:

* ``--url http://host:port`` scrapes a running server's ``/v1/metrics``
  (Prometheus text) over stdlib ``urllib``.
* ``PATH`` opens the store embedded (read-only open of the engine is not
  needed — metrics are process-wide, so opening the store and issuing a
  ``stats()`` call is enough to populate gauges) and renders the
  in-process registry. This mode is for debugging a store *in this
  process*; to observe a live server, scrape it.

Output groups the ``neurstore_*`` families by subsystem (engine / pool /
hnsw / maintenance / server) and prints ``name{labels} value`` lines,
plus histogram summaries as ``count`` / ``mean``. ``--watch N`` clears
and re-renders every N seconds, adding per-interval rates for counters.
``--traces`` additionally dumps the recent-trace ring (embedded mode
only — the ring is per-process).

``--space`` switches to the du-style space-accounting view (logical vs
physical bytes, base/delta/metadata split, compression ratio — see
``docs/observability.md``): embedded mode asks the engine's
``SpaceAccountant``, ``--url`` mode fetches ``GET /v1/accounting``.

``--device`` (default ``cuda``) is where an embedded store's engine runs;
``--url`` mode opens no engine. Without a card the tool exits with the
engine's error unless given ``--device cpu``.

Examples::

    PYTHONPATH=src python -m repro_torch.tools.nstat --url http://127.0.0.1:8080
    PYTHONPATH=src python -m repro_torch.tools.nstat --url http://127.0.0.1:8080 --watch 2
    PYTHONPATH=src python -m repro_torch.tools.nstat /path/to/store --traces --device cpu
    PYTHONPATH=src python -m repro_torch.tools.nstat /path/to/store --space
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from ..kernels.ops import resolve_device
from ..obs.metrics import parse_prometheus_text

_GROUPS = ("engine", "pool", "hnsw", "maintenance", "server", "slow")


def _fetch_text(url: str) -> str:
    with urllib.request.urlopen(url.rstrip("/") + "/v1/metrics",
                                timeout=10) as resp:
        ctype = resp.headers.get("Content-Type", "")
        if "text/plain" not in ctype:
            raise SystemExit(f"unexpected Content-Type {ctype!r} from {url}")
        return resp.read().decode("utf-8")


def _embedded_text(path: str, device="cuda") -> str:
    from ..store import NeurStore
    with NeurStore.open(path, device=device) as store:
        store.stats()  # touch the engine so attached gauges have owners
        return store.metrics_text()


def _group_of(family: str) -> str:
    for g in _GROUPS:
        if family.startswith(f"neurstore_{g}_"):
            return g
    if family.startswith("neurstore_slow_ops"):
        return "slow"
    return "other"


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _sample_key(sample: dict) -> tuple:
    return (sample["name"], tuple(sorted(sample["labels"].items())))


def _render(families: dict, prev: dict | None, interval_s: float) -> str:
    """Human-oriented rendering; histogram families collapse to
    count/mean, counters show a per-second rate when ``prev`` given."""
    by_group: dict[str, list[str]] = {}
    for fam_name in sorted(families):
        fam = families[fam_name]
        group = _group_of(fam_name)
        lines = by_group.setdefault(group, [])
        if fam["type"] == "histogram":
            sums: dict[tuple, float] = {}
            counts: dict[tuple, tuple] = {}
            for s in fam["samples"]:
                labels = tuple(sorted(s["labels"].items()))
                if s["name"].endswith("_sum"):
                    sums[labels] = s["value"]
                elif s["name"].endswith("_count"):
                    counts[labels] = s["value"]
            for labels in sorted(counts):
                n = counts[labels]
                mean = (sums.get(labels, 0.0) / n) if n else 0.0
                lines.append(
                    f"  {fam_name}{_fmt_labels(dict(labels))}"
                    f"  count={n:.0f}  mean={mean * 1e3:.3f}ms")
            continue
        prev_values = {}
        if prev is not None and fam_name in prev:
            prev_values = {_sample_key(s): s["value"]
                           for s in prev[fam_name]["samples"]}
        for s in sorted(fam["samples"], key=_sample_key):
            value = s["value"]
            rate = ""
            if prev is not None and fam["type"] == "counter":
                before = prev_values.get(_sample_key(s), 0.0)
                rate = f"  ({(value - before) / interval_s:+.1f}/s)"
            val = f"{value:.0f}" if value == int(value) else f"{value:.3f}"
            lines.append(
                f"  {s['name']}{_fmt_labels(s['labels'])} = {val}{rate}")
    out = []
    for group in (*_GROUPS, "other"):
        if group in by_group:
            out.append(f"[{group}]")
            out.extend(by_group[group])
    return "\n".join(out)


def _fetch_accounting(url: str) -> dict:
    with urllib.request.urlopen(url.rstrip("/") + "/v1/accounting",
                                timeout=10) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _embedded_accounting(path: str, device="cuda") -> dict:
    from ..store import NeurStore
    with NeurStore.open(path, device=device) as store:
        return store.accounting()


def _human(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _ratio_txt(r) -> str:
    return f"{r:.3f}" if r is not None else "-"


def _render_space(report: dict) -> str:
    """du-style rendering of the accounting report."""
    out = []
    s = report["store"]
    if not s["models"]:
        return "[store]  0 models (empty)"
    out.append(
        f"[store]  models={s['models']}  logical={_human(s['logical_bytes'])}"
        f"  physical={_human(s['physical_bytes'])}"
        f"  ratio={_ratio_txt(s.get('compression_ratio'))}")
    out.append(
        f"         pages={_human(s['page_bytes'])}"
        f" (delta {_human(s['delta_bytes'])}"
        f" + metadata {_human(s['metadata_bytes'])})"
        f"  shared base={_human(s['base_bytes'])}")
    per_model = report.get("per_model", {})
    if per_model:
        out.append("[per model]   physical  logical   ratio  reclaim  name")
        ordered = sorted(per_model.items(),
                         key=lambda kv: -kv[1]["physical_bytes"])
        for name, m in ordered:
            out.append(
                f"  {_human(m['physical_bytes']):>9}"
                f"  {_human(m['logical_bytes']):>8}"
                f"  {_ratio_txt(m.get('compression_ratio')):>6}"
                f"  {_human(m['reclaimable_bytes']):>7}  {name}")
    per_dim = report.get("per_dim", {})
    if per_dim:
        out.append("[per dim-group]  tensors  bases  base bytes  delta bytes")
        for dim, d in per_dim.items():
            out.append(
                f"  dim {dim:>10}  {d['tensors']:>7}  {d['base_vertices']:>5}"
                f"  {_human(d['base_bytes']):>10}"
                f"  {_human(d['delta_bytes']):>11}")
    per_tenant = report.get("per_tenant", {})
    if per_tenant:
        out.append("[per tenant]  models  physical  logical  ratio")
        for tenant, t in sorted(per_tenant.items()):
            out.append(
                f"  {tenant:<12}  {t['models']:>5}"
                f"  {_human(t['physical_bytes']):>8}"
                f"  {_human(t['logical_bytes']):>8}"
                f"  {_ratio_txt(t.get('compression_ratio'))}")
    return "\n".join(out)


def _dump_traces(n: int) -> str:
    from ..obs.trace import recent_traces
    roots = recent_traces(n)
    if not roots:
        return "(no completed traces in this process)"
    return "\n".join(root.format_tree() for root in roots)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.nstat",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("path", nargs="?", help="store directory (embedded mode)")
    ap.add_argument("--url", help="scrape a running server's /v1/metrics")
    ap.add_argument("--watch", type=float, metavar="SECONDS",
                    help="refresh every N seconds until interrupted")
    ap.add_argument("--traces", type=int, nargs="?", const=8, metavar="N",
                    help="also dump the last N recent traces (embedded only)")
    ap.add_argument("--raw", action="store_true",
                    help="print the Prometheus text verbatim and exit")
    ap.add_argument("--space", action="store_true",
                    help="du-style space accounting view (logical vs "
                         "physical bytes, per model/dim/tenant)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where an embedded store's engine runs")
    args = ap.parse_args(argv)
    if bool(args.path) == bool(args.url):
        ap.error("give exactly one of PATH (embedded) or --url (scrape)")
    device = resolve_device(args.device)

    if args.space:
        report = (_fetch_accounting(args.url) if args.url
                  else _embedded_accounting(args.path, device))
        print(_render_space(report))
        return 0

    def snapshot() -> str:
        return _fetch_text(args.url) if args.url else _embedded_text(args.path, device)

    if args.raw:
        sys.stdout.write(snapshot())
        return 0

    prev = None
    while True:
        text = snapshot()
        families = parse_prometheus_text(text)
        if args.watch:
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
        stamp = time.strftime("%H:%M:%S")
        print(f"nstat @ {stamp} — {len(families)} families")
        print(_render(families, prev, args.watch or 1.0))
        if args.traces is not None:
            print("\n[recent traces]")
            print(_dump_traces(args.traces))
        if not args.watch:
            return 0
        prev = families
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
