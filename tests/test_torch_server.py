"""End-to-end tests for the networked front door (``repro_torch.server``).

The reference suite ``tests/test_server.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).

The contract under test (``docs/serving.md``):

- a model saved through ``StoreClient`` streams back down byte-identical
  to what the embedded engine reconstructs for the same catalog entry;
- concurrent served readers + a writer see snapshot-consistent models
  and zero 5xx responses;
- tenant byte quotas reject the offending save atomically at commit
  time (nothing durable, catalog unchanged);
- the admission policy sheds writes with HTTP 429 + ``Retry-After``
  while a lagging snapshot pins old epochs, and admits again once the
  reader drains;
- storage corruption surfaces to the remote client as the *same typed
  exception* the embedded API raises, via the stable error-code
  registry (parametrized contract test);
- the streaming wire format fails typed on truncation and bit damage.
"""

import os
import threading

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core.catalog import Catalog
from repro_torch.core.engine import STATS_SCHEMA_VERSION
from repro_torch.core.integrity import (
    CorruptPageError,
    ReadOnlyStoreError,
)
from repro_torch.core.loader import KernelNotReady
from repro_torch.server import (
    AdmissionPolicy,
    ModelStoreServer,
    QuotaManager,
    StoreClient,
    WireError,
)
from repro_torch.server import wire as wire_mod
from repro_torch.store import SaveRequest
from repro_torch.store.errors import (
    ERROR_CODES,
    AdmissionRejectedError,
    QuotaExceededError,
    RemoteStoreError,
    error_payload,
    raise_for_code,
)

RNG = np.random.default_rng(23)


def _tensors(n=3, d=48, seed=None, fill=None):
    if fill is not None:
        return {f"t{i}": np.full((d,), float(fill), dtype=np.float32)
                for i in range(n)}
    rng = np.random.default_rng(seed) if seed is not None else RNG
    return {f"t{i}": rng.standard_normal((d,)).astype(np.float32)
            for i in range(n)}


@pytest.fixture
def served(tmp_path):
    """(engine, server) pair on an ephemeral port, torn down after."""
    engine = StorageEngine(str(tmp_path), device="cpu")
    server = ModelStoreServer(engine).start()
    yield engine, server
    server.stop()
    engine.close()


def _client(server, tenant="acme"):
    return StoreClient(server.host, server.port, tenant=tenant)


# ---------------------------------------------------------------- roundtrip
def test_save_then_load_byte_identical_across_clients(served):
    engine, server = served
    tensors = _tensors(seed=1)
    writer = _client(server)
    report = writer.save(SaveRequest("m", tensors, architecture={"v": 1}))
    assert report.n_tensors == len(tensors)
    assert report.name == "m"  # tenant prefix never leaks back out

    reader = _client(server)  # a SECOND client: nothing shared but the wire
    with reader.load("m") as handle:
        served_params = handle.materialize()
        assert handle.architecture == {"v": 1}

    embedded = engine.load_model("acme/m")
    try:
        for k in tensors:
            np.testing.assert_array_equal(
                served_params[k], embedded.tensor(k))
    finally:
        embedded.close()


def test_streamed_load_matches_eager_and_preserves_order(served):
    _, server = served
    c = _client(server)
    c.save(SaveRequest("m", _tensors(seed=2)))
    eager = c.load("m").materialize()
    lazy = c.load("m", stream=True)
    try:
        order = []
        for name, arr in lazy.tensors():
            order.append(name)
            np.testing.assert_array_equal(arr, eager[name])
    finally:
        lazy.close()
    assert order == ["t0", "t1", "t2"]  # architecture/page order


def test_flexible_loading_bits_over_the_wire(served):
    engine, server = served
    c = _client(server)
    c.save(SaveRequest("m", _tensors(seed=3)))
    coarse = c.load("m", bits=2).materialize()
    embedded = engine.load_model("acme/m", bits=2)
    try:
        for k, arr in coarse.items():
            np.testing.assert_array_equal(arr, embedded.tensor(k))
    finally:
        embedded.close()


def test_replace_delete_info_and_listing(served):
    _, server = served
    c = _client(server)
    with pytest.raises(KeyError):
        c.replace(SaveRequest("m", _tensors(seed=4)))
    c.save(SaveRequest("m", _tensors(seed=4)))
    rep = c.replace(SaveRequest("m", _tensors(seed=5)))
    assert rep.model_id >= 1
    info = c.model_info("m")
    assert info["name"] == "m" and info["page_bytes"] > 0
    assert c.models() == ["m"]
    c.delete("m")
    assert c.models() == []
    with pytest.raises(KeyError):
        c.load("m")


def test_tenant_namespaces_are_isolated(served):
    engine, server = served
    a, b = _client(server, "alice"), _client(server, "bob")
    a.save(SaveRequest("m", _tensors(seed=6)))
    b.save(SaveRequest("m", _tensors(seed=7)))
    assert a.models() == ["m"] and b.models() == ["m"]
    assert set(engine.list_models()) == {"alice/m", "bob/m"}
    # Different content despite the same visible name.
    ta, tb = a.load("m").materialize(), b.load("m").materialize()
    assert not np.array_equal(ta["t0"], tb["t0"])
    with pytest.raises(ValueError):
        _client(server, "../escape").models()  # invalid tenant id


# -------------------------------------------------------------- concurrency
def test_four_readers_one_writer_no_5xx_snapshot_consistent(served):
    """Served reads stay consistent and error-free under writer churn.

    The writer replaces the model with tensors all equal to the version
    number; any torn read (tensors from two different versions in one
    response) or 5xx fails the test.
    """
    engine, server = served
    writer = _client(server)
    writer.save(SaveRequest("m", _tensors(fill=0)))

    stop = threading.Event()
    failures: list[str] = []

    def write_loop():
        version = 0
        while not stop.is_set():
            version += 1
            try:
                writer.replace(SaveRequest("m", _tensors(fill=version)))
            except AdmissionRejectedError:
                continue  # shed writes are allowed; 5xx is not
            except Exception as exc:  # noqa: BLE001
                failures.append(f"writer: {exc!r}")
                return

    def read_loop(idx):
        c = _client(server)
        reads = 0
        while not stop.is_set() or reads == 0:
            try:
                got = c.load("m").materialize()
            except Exception as exc:  # noqa: BLE001
                failures.append(f"reader{idx}: {exc!r}")
                return
            versions = {int(round(float(arr[0]))) for arr in got.values()}
            if len(versions) != 1:
                failures.append(f"reader{idx}: torn read {versions}")
                return
            reads += 1

    threads = [threading.Thread(target=write_loop)] + [
        threading.Thread(target=read_loop, args=(i,)) for i in range(4)
    ]
    for t in threads:
        t.start()
    stop_timer = threading.Timer(2.0, stop.set)
    stop_timer.start()
    for t in threads:
        t.join(timeout=30)
    stop.set()
    stop_timer.cancel()

    assert failures == []
    assert server.server_stats()["errors_5xx"] == 0


# -------------------------------------------------------------------- quota
def test_quota_rejects_save_atomically(tmp_path):
    engine = StorageEngine(str(tmp_path), device="cpu")
    quotas = QuotaManager()
    server = ModelStoreServer(engine, quotas=quotas).start()
    try:
        c = _client(server)
        c.save(SaveRequest("m1", _tensors(seed=8)))
        used = quotas.usage(engine, "acme")
        assert used > 0 and c.quota()["used_bytes"] == used

        quotas.set_limit("acme", used + 16)  # room for nothing more
        epoch_before = engine.stats()["epoch"]
        with pytest.raises(QuotaExceededError):
            c.save(SaveRequest("m2", _tensors(seed=9)))
        # Rejected pre-durability: no catalog entry, no epoch bump.
        assert c.models() == ["m1"]
        assert engine.stats()["epoch"] == epoch_before

        # Replace charges only the DELTA, so it fits under the cap...
        c.replace(SaveRequest("m1", _tensors(seed=8)))
        # ...and another tenant is not constrained by acme's limit.
        _client(server, "other").save(SaveRequest("big", _tensors(seed=10)))
    finally:
        server.stop()
        engine.close()


# ------------------------------------------------------------- backpressure
def test_backpressure_sheds_writes_until_reader_drains(tmp_path):
    engine = StorageEngine(str(tmp_path), device="cpu")
    server = ModelStoreServer(
        engine, admission=AdmissionPolicy(max_epoch_lag=0)).start()
    try:
        c = _client(server)
        c.save(SaveRequest("m", _tensors(seed=11)))  # epoch 0 → 1, no lag
        lagging = engine.load_model("acme/m")  # pins epoch 1
        c.save(SaveRequest("m2", _tensors(seed=12)))  # lag 0: admitted → epoch 2
        with pytest.raises(AdmissionRejectedError):
            c.save(SaveRequest("m3", _tensors(seed=13)))  # lag 1 > 0: shed
        assert server.admission.stats()["rejected"] == 1
        assert "m3" not in c.models()
        lagging.close()  # reader drains → lag back to 0
        c.save(SaveRequest("m3", _tensors(seed=13)))  # admitted again
        assert sorted(c.models()) == ["m", "m2", "m3"]
        # Reads were never gated, even while writes shed.
        assert c.load("m").materialize()
    finally:
        server.stop()
        engine.close()


# ----------------------------------------------------------- error contract
_REPRESENTATIVE = {
    "not_found": KeyError("m"),
    "corrupt": CorruptPageError("crc mismatch"),
    "read_only": ReadOnlyStoreError("degraded"),
    "quota_exceeded": QuotaExceededError("over"),
    "backpressure": AdmissionRejectedError("shed"),
    "kernel_not_ready": KernelNotReady("pallas kernel unavailable"),
    "invalid_request": ValueError("bad body"),
    "internal": RemoteStoreError("boom"),
}


@pytest.mark.parametrize("code", sorted(ERROR_CODES))
def test_error_contract(code):
    """code ↔ status ↔ exception is one bidirectional registry."""
    exc = _REPRESENTATIVE[code]
    status, payload = error_payload(exc)
    assert status == ERROR_CODES[code]
    assert payload["error"]["code"] == code
    assert payload["error"]["message"]  # never empty
    # The client turns the code back into the SAME exception type
    # (or a superclass-compatible one) the embedded API raises.
    with pytest.raises(type(exc)):
        raise_for_code(code, payload["error"]["message"])


def test_unknown_error_code_degrades_typed():
    with pytest.raises(RemoteStoreError, match=r"\[sharding_conflict\]"):
        raise_for_code("sharding_conflict", "from a newer server")


def test_served_error_statuses_match_registry(served):
    _, server = served
    c = _client(server)
    with pytest.raises(KeyError):  # 404 over the wire
        c.load("never-saved")
    with pytest.raises(KeyError):
        c.delete("never-saved")
    with pytest.raises(ValueError):  # 400: malformed upload body
        c._json("POST", c._model_path("m"), body=b"not a stream")


def test_corrupt_model_surfaces_same_typed_error_remotely(tmp_path):
    """Bit damage on disk → CorruptPageError through the socket (S4)."""
    root = str(tmp_path)
    engine = StorageEngine(root, device="cpu")
    server = ModelStoreServer(engine).start()
    c = _client(server)
    c.save(SaveRequest("good", _tensors(seed=14)))
    c.save(SaveRequest("bad", _tensors(seed=15)))
    server.stop()
    engine.close()

    page = os.path.join(root, "pages", Catalog(root).get("acme/bad").page)
    size = os.path.getsize(page)
    with open(page, "r+b") as f:  # flip one bit mid-payload
        f.seek(size // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x10]))

    engine = StorageEngine(root, device="cpu")
    server = ModelStoreServer(engine).start()
    try:
        c = _client(server)
        with pytest.raises(CorruptPageError):
            c.load("bad")
        # Containment holds over the wire too: the healthy model still
        # serves and the store stays writable.
        assert c.load("good").materialize()
        c.save(SaveRequest("new", _tensors(seed=16)))
        assert c.stats().corrupt_models == 1
    finally:
        server.stop()
        engine.close()


# -------------------------------------------------------------- wire format
class _Buf:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, n: int) -> bytes:
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out


def _encode(tensors) -> bytes:
    return b"".join(wire_mod.encode_model_stream(
        {"name": "m"}, iter(tensors.items())))


def test_wire_roundtrip_and_trailer_validation():
    tensors = _tensors(seed=17)
    blob = _encode(tensors)
    header, records = wire_mod.decode_model_stream(_Buf(blob))
    assert header["name"] == "m"
    assert header["stream_version"] == wire_mod.STREAM_VERSION
    got = dict(records)  # exhausting validates the trailer
    for k in tensors:
        np.testing.assert_array_equal(got[k], tensors[k])


def test_wire_truncation_is_typed_never_partial():
    blob = _encode(_tensors(seed=18))
    for cut in (3, len(blob) // 2, len(blob) - 1):
        with pytest.raises(WireError):  # at decode (header) or iteration
            _, records = wire_mod.decode_model_stream(_Buf(blob[:cut]))
            list(records)


def test_wire_bit_damage_fails_crc():
    blob = bytearray(_encode(_tensors(seed=19)))
    blob[len(blob) // 2] ^= 0x01  # mid-stream → lands in a tensor payload
    _, records = wire_mod.decode_model_stream(_Buf(bytes(blob)))
    with pytest.raises(WireError):
        list(records)


def test_wire_rejects_unknown_stream_version():
    blob = _encode(_tensors(seed=20))
    bad = blob.replace(b'"stream_version": 1', b'"stream_version": 9', 1)
    with pytest.raises(WireError, match="stream_version"):
        wire_mod.decode_model_stream(_Buf(bad))


# -------------------------------------------------------------------- stats
def test_stats_endpoint_is_versioned_and_documented(served):
    _, server = served
    c = _client(server)
    c.save(SaveRequest("m", _tensors(seed=21)))
    st = c.stats()
    assert st.schema_version == STATS_SCHEMA_VERSION
    assert st.models == 1 and st.epoch >= 1
    assert st.pool_budget_bytes > 0 and not st.read_only
    # The admission signals are derivable from documented fields alone.
    assert st.pool_utilization >= 0.0 and st.epoch_lag == 0
    # Server-side telemetry rides along in the raw dump.
    assert st.raw["server"]["requests"] >= 2
    assert st.raw["server"]["errors_5xx"] == 0


def test_healthz_and_vacuum_admin(served):
    _, server = served
    c = _client(server)
    assert c.healthz()
    c.save(SaveRequest("m", _tensors(seed=22)))
    c.delete("m")
    report = c.vacuum()
    assert "vertices_dropped" in report


# ----------------------------------------------------------- response cache
def test_response_cache_admission_knob(tmp_path):
    """Oversized downloads bypass the cache instead of wiping it, and the
    policy is visible in stats (admissions/bypasses/evictions)."""
    from repro_torch.server.app import _ResponseCache

    cache = _ResponseCache(budget_bytes=1000)  # default max_entry = 500
    assert cache.max_entry_bytes == 500
    cache.put(("big", None), b"x" * 501)  # refused, counted
    assert cache.get(("big", None)) is None
    cache.put(("a", None), b"x" * 400)
    cache.put(("b", None), b"y" * 400)
    assert cache.get(("a", None)) is not None
    cache.put(("c", None), b"z" * 400)  # budget forces an eviction
    st = cache.stats()
    assert st["bypasses"] == 1
    assert st["admissions"] == 3
    assert st["evictions"] >= 1
    assert st["max_entry_bytes"] == 500
    assert st["bytes"] <= st["budget_bytes"]


def test_response_cache_max_entry_passthrough(tmp_path):
    engine = StorageEngine(str(tmp_path), device="cpu")
    server = ModelStoreServer(
        engine, response_cache_bytes=1 << 20,
        response_cache_max_entry_bytes=64,  # every real model bypasses
    ).start()
    try:
        c = _client(server)
        c.save(SaveRequest("m", _tensors(seed=30)))
        for _ in range(2):
            c.load("m").close()
        st = server.response_cache.stats()
        assert st["max_entry_bytes"] == 64
        assert st["bypasses"] >= 1 and st["admissions"] == 0
        assert st["hits"] == 0  # nothing was ever admitted
        c.close()
    finally:
        server.stop()
        engine.close()


def test_healthz_shape_is_enriched(served):
    """/v1/healthz is a contract: schema version, uptime, degraded flag,
    maintenance health — not just a liveness bit."""
    import json as _json
    import urllib.request

    _, server = served
    url = f"http://{server.host}:{server.port}/v1/healthz"
    with urllib.request.urlopen(url) as resp:
        body = _json.loads(resp.read())
    assert set(body) == {
        "ok", "stats_schema_version", "uptime_s", "read_only", "maintenance",
        "slow_op_threshold_s"}
    assert set(body["maintenance"]) == {
        "running", "consecutive_errors", "last_error_age_s"}
    assert body["stats_schema_version"] == STATS_SCHEMA_VERSION
    assert body["slow_op_threshold_s"] > 0


def test_metrics_route_serves_prometheus_text(served):
    import urllib.request

    from repro_torch.obs.metrics import parse_prometheus_text

    _, server = served
    c = _client(server)
    c.save(SaveRequest("m", _tensors(seed=31)))
    c.load("m").close()
    url = f"http://{server.host}:{server.port}/v1/metrics"
    with urllib.request.urlopen(url) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        fams = parse_prometheus_text(resp.read().decode("utf-8"))
    # One family from every instrumented subsystem answers the scrape.
    for name in ("neurstore_engine_ops_total", "neurstore_pool_hits_total",
                 "neurstore_hnsw_searches_total",
                 "neurstore_maintenance_steps_total",
                 "neurstore_server_requests_total"):
        assert name in fams, name
    c.close()


def test_unknown_route_counts_as_4xx_not_5xx(served):
    from repro_torch.obs.metrics import default_registry

    _, server = served

    def val():
        return default_registry().sample_value(
            "neurstore_server_requests_total",
            {"route": "unknown", "method": "GET", "status": "4xx"}) or 0.0

    before = val()
    c = _client(server)
    with pytest.raises(Exception):
        c._json("GET", "/v1/nope")
    assert val() == before + 1
    assert server.server_stats()["errors_5xx"] == 0
    c.close()
