"""Observability contract tests (``repro_torch.obs`` + instrumentation).

The reference suite ``tests/test_obs.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).

What's under test (``docs/observability.md``):

- the metric **name contract**: every documented family exists in the
  process registry with the documented type and label schema after a
  representative workload — renaming a metric is a breaking change and
  must fail here;
- counters are monotonic and move when the instrumented hot paths run
  (save/load/vacuum/delete, pool hits/misses, HNSW search);
- Prometheus text round-trips through the strict parser, and the parser
  actually rejects malformed exposition;
- spans nest into trees, propagate W3C ``traceparent`` from
  ``StoreClient`` through the server into engine spans, and slow roots
  hit the slow-op log with their full tree;
- disabling observability stops recording but never breaks timing
  (``SaveReport.seconds`` still real);
- ``/v1/metrics`` stays valid under concurrent read/write load with
  zero 5xx.

The registry is process-global, so every assertion is on *deltas*
around the workload, never absolutes.
"""

import json
import logging
import threading
import urllib.request

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.obs.metrics import (
    MetricsRegistry,
    default_registry,
    parse_prometheus_text,
    set_enabled,
)
from repro_torch.obs.trace import (
    parse_traceparent,
    recent_traces,
    set_slow_op_threshold,
    trace,
)
from repro_torch.server import ModelStoreServer, StoreClient
from repro_torch.store import NeurStore, SaveRequest

RNG = np.random.default_rng(7)


def _tensors(n=3, d=48, seed=None):
    rng = np.random.default_rng(seed) if seed is not None else RNG
    return {f"t{i}": rng.standard_normal((d,)).astype(np.float32)
            for i in range(n)}


@pytest.fixture(autouse=True)
def _obs_state_guard():
    """Tests may flip global obs switches; always restore them."""
    prev_thresh = set_slow_op_threshold(1.0)
    set_enabled(True)
    yield
    set_enabled(True)
    set_slow_op_threshold(prev_thresh)


def _value(name, labels=None):
    return default_registry().sample_value(name, labels or {}) or 0.0


# ------------------------------------------------------------ name contract
# The documented metric families (docs/observability.md). A rename or
# type/label change here is a breaking change to the scrape contract.
CONTRACT = [
    ("neurstore_engine_ops_total", "counter", ("op",)),
    ("neurstore_engine_op_seconds", "histogram", ("op",)),
    ("neurstore_engine_page_reads_total", "counter", ()),
    ("neurstore_engine_page_read_bytes_total", "counter", ()),
    ("neurstore_engine_quarantines_total", "counter", ()),
    ("neurstore_engine_models", "gauge", ()),
    ("neurstore_engine_epoch", "gauge", ()),
    ("neurstore_engine_snapshots_live", "gauge", ()),
    ("neurstore_pool_hits_total", "counter", ()),
    ("neurstore_pool_misses_total", "counter", ()),
    ("neurstore_pool_evictions_total", "counter", ()),
    ("neurstore_pool_decoded_hits_total", "counter", ()),
    ("neurstore_pool_decoded_misses_total", "counter", ()),
    ("neurstore_pool_resident_bytes", "gauge", ()),
    ("neurstore_pool_pinned_bytes", "gauge", ()),
    ("neurstore_pool_budget_bytes", "gauge", ()),
    ("neurstore_hnsw_distance_evals_total", "counter", ()),
    ("neurstore_hnsw_visited_total", "counter", ()),
    ("neurstore_hnsw_searches_total", "counter", ()),
    ("neurstore_hnsw_inserts_total", "counter", ()),
    ("neurstore_maintenance_steps_total", "counter", ()),
    ("neurstore_maintenance_errors_total", "counter", ()),
    ("neurstore_maintenance_restarts_total", "counter", ()),
    ("neurstore_maintenance_consecutive_errors", "gauge", ()),
    ("neurstore_maintenance_last_error_age_seconds", "gauge", ()),
    ("neurstore_server_requests_total", "counter",
     ("route", "method", "status")),
    ("neurstore_server_request_seconds", "histogram", ("route",)),
    ("neurstore_server_inflight_requests", "gauge", ()),
    ("neurstore_server_response_cache_hits_total", "counter", ()),
    ("neurstore_server_response_cache_misses_total", "counter", ()),
    ("neurstore_server_response_cache_admissions_total", "counter", ()),
    ("neurstore_server_response_cache_bypasses_total", "counter", ()),
    ("neurstore_server_response_cache_evictions_total", "counter", ()),
    ("neurstore_server_admission_rejects_total", "counter", ("reason",)),
    ("neurstore_slow_ops_total", "counter", ("op",)),
    ("neurstore_dedup_outcomes_total", "counter", ("outcome",)),
    ("neurstore_delta_bits", "histogram", ()),
    ("neurstore_logical_bytes", "gauge", ()),
    ("neurstore_physical_bytes", "gauge", ()),
]


def test_metric_name_contract():
    # Importing the instrumented modules registered every family; the
    # registry's own idempotent constructors verify type + label schema
    # (they raise on mismatch).
    import repro_torch.server.admission  # noqa: F401 — registers its family
    reg = default_registry()
    for name, mtype, labels in CONTRACT:
        fam = {"counter": reg.counter, "gauge": reg.gauge,
               "histogram": reg.histogram}[mtype]
        fam(name, "help ignored on re-get", labels)  # raises on drift


def test_counters_move_and_are_monotonic(tmp_path):
    before = {
        "saves": _value("neurstore_engine_ops_total", {"op": "save"}),
        "loads": _value("neurstore_engine_ops_total", {"op": "load"}),
        "pool": (_value("neurstore_pool_hits_total")
                 + _value("neurstore_pool_misses_total")),
        "reads": _value("neurstore_engine_page_reads_total"),
        "inserts": _value("neurstore_hnsw_inserts_total"),
    }
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("a", {"f": 1}, _tensors(seed=1))
    eng.save_model("b", {"f": 1}, _tensors(seed=2))
    for _ in range(3):
        eng.load_model("a").close()
    eng.vacuum()
    eng.delete_model("b")
    eng.close()

    assert _value("neurstore_engine_ops_total", {"op": "save"}) \
        == before["saves"] + 2
    assert _value("neurstore_engine_ops_total", {"op": "load"}) \
        == before["loads"] + 3
    assert (_value("neurstore_pool_hits_total")
            + _value("neurstore_pool_misses_total")) >= before["pool"] + 3
    assert _value("neurstore_engine_page_reads_total") > before["reads"]
    assert _value("neurstore_hnsw_inserts_total") > before["inserts"]
    # Histogram count mirrors the op counter.
    fams = parse_prometheus_text(default_registry().render())
    count = [s["value"] for s in fams["neurstore_engine_op_seconds"]["samples"]
             if s["name"].endswith("_count") and s["labels"] == {"op": "save"}]
    assert count and count[0] >= before["saves"] + 2


def test_gauges_track_engine_state(tmp_path):
    base_models = _value("neurstore_engine_models")
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("a", {"f": 1}, _tensors(seed=3))
    assert _value("neurstore_engine_models") == base_models + 1
    lm = eng.load_model("a")
    assert _value("neurstore_engine_snapshots_live") >= 1
    assert _value("neurstore_pool_resident_bytes") > 0
    lm.close()
    eng.delete_model("a")
    assert _value("neurstore_engine_models") == base_models
    eng.close()
    # A collected engine drops out of the gauge sum (weakref semantics).
    del eng
    assert _value("neurstore_engine_models") == base_models


# --------------------------------------------------------------- exposition
def test_prometheus_round_trip():
    reg = MetricsRegistry()
    c = reg.counter("rt_ops_total", "ops", ("kind",))
    c.labels("read").inc(3)
    c.labels('we"ird\\la{bel}').inc()  # escaping must survive the trip
    g = reg.gauge("rt_depth", "depth")
    g.set(-2.5)
    h = reg.histogram("rt_seconds", "latency")
    for v in (1e-6, 0.003, 0.5, 99.0):
        h.observe(v)
    fams = parse_prometheus_text(reg.render())
    assert fams["rt_ops_total"]["type"] == "counter"
    by_kind = {s["labels"]["kind"]: s["value"]
               for s in fams["rt_ops_total"]["samples"]}
    assert by_kind["read"] == 3
    assert by_kind['we"ird\\la{bel}'] == 1
    assert fams["rt_depth"]["samples"][0]["value"] == -2.5
    hist = fams["rt_seconds"]["samples"]
    count = [s for s in hist if s["name"] == "rt_seconds_count"][0]
    assert count["value"] == 4
    inf = [s for s in hist if s["labels"].get("le") == "+Inf"]
    assert inf and inf[0]["value"] == 4  # cumulative buckets end at +Inf


@pytest.mark.parametrize("bad", [
    "no_type_announcement 1",
    "# TYPE x counter\nx one",
    "# TYPE x notatype\nx 1",
    '# TYPE x counter\nx{a="unterminated 1',
])
def test_parser_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_prometheus_text(bad)


def test_registry_rejects_schema_drift():
    reg = MetricsRegistry()
    reg.counter("drift_total", "x", ("a",))
    with pytest.raises(ValueError):
        reg.gauge("drift_total", "x")  # type change
    with pytest.raises(ValueError):
        reg.counter("drift_total", "x", ("b",))  # label change


# ------------------------------------------------------------------- traces
def test_span_tree_and_ring():
    with trace("outer", who="t") as outer:
        with trace("inner"):
            with trace("leaf"):
                pass
    assert [s.name for s in outer.walk()] == ["outer", "inner", "leaf"]
    assert outer.find("leaf") is not None
    assert recent_traces()[-1] is outer
    # traceparent emitted by a span parses back to its own ids.
    assert parse_traceparent(outer.traceparent()) == \
        (outer.trace_id, outer.span_id)


def test_save_report_seconds_comes_from_span(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    report = eng.save_model("m", {"f": 1}, _tensors(seed=4))
    root = [s for s in recent_traces() if s.name == "engine.save"][-1]
    # report.seconds is read off the same span just before it closes, so
    # it can only trail the closed span by bookkeeping microseconds.
    assert 0 < report.seconds <= root.elapsed()
    assert root.elapsed() - report.seconds < 5e-3
    children = {c.name for c in root.children}
    assert {"probe", "quantize", "commit"} <= children
    eng.close()


def test_slow_op_log_fires(tmp_path, caplog):
    before = _value("neurstore_slow_ops_total", {"op": "engine.save"})
    set_slow_op_threshold(0.0)  # everything is slow now
    eng = StorageEngine(str(tmp_path), device="cpu")
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs.slow"):
        eng.save_model("m", {"f": 1}, _tensors(seed=5))
    eng.close()
    msgs = [r.getMessage() for r in caplog.records
            if "engine.save" in r.getMessage()]
    assert msgs, "slow-op log never fired"
    # The log carries the indented span tree, not just the root.
    assert "- probe" in msgs[0] and "- commit" in msgs[0]
    assert _value("neurstore_slow_ops_total", {"op": "engine.save"}) \
        > before


def test_disabled_mode_records_nothing_but_still_times(tmp_path):
    before = _value("neurstore_engine_ops_total", {"op": "save"})
    ring_before = len(recent_traces())
    set_enabled(False)
    eng = StorageEngine(str(tmp_path), device="cpu")
    report = eng.save_model("m", {"f": 1}, _tensors(seed=6))
    eng.close()
    assert report.seconds > 0  # timing survives disablement
    assert _value("neurstore_engine_ops_total", {"op": "save"}) == before
    assert len(recent_traces()) == ring_before
    set_enabled(True)


# ------------------------------------------- propagation through the server
@pytest.fixture
def served(tmp_path):
    engine = StorageEngine(str(tmp_path), device="cpu")
    server = ModelStoreServer(engine).start()
    yield engine, server
    server.stop()
    engine.close()


def test_traceparent_client_to_engine(served):
    engine, server = served
    client = StoreClient(server.host, server.port, tenant="acme")
    client.save(SaveRequest("m", _tensors(seed=8), architecture={"v": 1}))
    with trace("app.load") as root:
        client.load("m").close()
    # The server handled the download on another thread, as a SEPARATE
    # local root — joined to our trace only by the propagated trace id.
    server_roots = [
        s for s in recent_traces()
        if s.name == "http.request" and s.trace_id == root.trace_id
        and s.attrs.get("method") == "GET"
    ]
    assert server_roots, "server span tree did not adopt the client trace id"
    tree = server_roots[-1]
    load = tree.find("engine.load")
    assert load is not None
    # Latency attribution: the documented child phases are all present.
    assert {"probe", "pool", "snapshot"} <= {c.name for c in load.children}
    assert tree.find("page.io") is not None or \
        tree.find("decode") is not None
    client.close()


def test_metrics_endpoint_under_concurrent_load(served):
    engine, server = served
    writer = StoreClient(server.host, server.port, tenant="acme")
    writer.save(SaveRequest("hot", _tensors(seed=9), architecture={"v": 1}))
    url = f"http://{server.host}:{server.port}"
    stop = threading.Event()
    failures: list[str] = []

    def reader():
        c = StoreClient(server.host, server.port, tenant="acme")
        while not stop.is_set():
            try:
                c.load("hot").close()
            except Exception as exc:  # noqa: BLE001
                failures.append(f"read: {exc!r}")
        c.close()

    def scraper():
        while not stop.is_set():
            try:
                with urllib.request.urlopen(f"{url}/v1/metrics") as resp:
                    assert resp.status == 200
                    parse_prometheus_text(resp.read().decode("utf-8"))
            except Exception as exc:  # noqa: BLE001
                failures.append(f"scrape: {exc!r}")

    threads = [threading.Thread(target=reader) for _ in range(3)] + \
              [threading.Thread(target=scraper) for _ in range(2)]
    for t in threads:
        t.start()
    for i in range(5):
        writer.save(SaveRequest(f"w{i}", _tensors(seed=10 + i),
                                architecture={"v": 1}))
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not failures, failures[:5]
    assert server.server_stats()["errors_5xx"] == 0
    # Per-route request accounting saw the scrapes and downloads as 2xx.
    assert _value("neurstore_server_requests_total",
                  {"route": "metrics", "method": "GET", "status": "2xx"}) > 0
    assert _value("neurstore_server_requests_total",
                  {"route": "model.download", "method": "GET",
                   "status": "2xx"}) > 0
    writer.close()


def test_healthz_reports_maintenance_and_uptime(served):
    engine, server = served
    daemon = engine.start_maintenance()
    try:
        url = f"http://{server.host}:{server.port}/v1/healthz"
        with urllib.request.urlopen(url) as resp:
            body = json.loads(resp.read())
        assert body["ok"] is True
        assert body["stats_schema_version"] >= 1
        assert body["uptime_s"] > 0
        assert body["read_only"] is False
        assert body["maintenance"]["running"] is True
        assert body["maintenance"]["consecutive_errors"] == 0
    finally:
        daemon.stop()


def test_facade_metrics_snapshot(tmp_path):
    with NeurStore.open(str(tmp_path), device="cpu") as store:
        store.save(SaveRequest("m", _tensors(seed=11),
                               architecture={"v": 1}))
        snap = store.metrics()
        text = store.metrics_text()
    assert snap.keys() == parse_prometheus_text(text).keys()
    assert "neurstore_engine_ops_total" in snap
