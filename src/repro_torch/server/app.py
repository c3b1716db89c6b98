"""The networked model-store front door — stdlib-only HTTP service.

``ModelStoreServer`` mounts one :class:`~repro_torch.core.engine.StorageEngine`
behind a ``ThreadingHTTPServer``: every request handler thread is exactly
one of the N concurrent readers the snapshot read path was built for —
a ``GET`` pins an epoch-stamped snapshot and streams the model out
record-by-record without ever blocking writers; writes pass the
admission policy, then run the engine's ordinary journaled commit with
the tenant quota gate inside the transaction.

Routes (wire details in ``docs/serving.md``)::

    GET    /v1/healthz                              liveness
    GET    /v1/stats                                StoreStats (versioned)
    GET    /v1/accounting                           space accounting report
    POST   /v1/admin/vacuum                         {"min_dead_fraction"}
    GET    /v1/tenants/{t}/models                   list model names
    GET    /v1/tenants/{t}/models/{name}/explain    save EXPLAIN + space
    GET    /v1/tenants/{t}/quota                    quota usage report
    POST   /v1/tenants/{t}/models/{name}            save   (streamed body)
    PUT    /v1/tenants/{t}/models/{name}            replace (streamed body)
    GET    /v1/tenants/{t}/models/{name}[?bits=b]   download (streamed)
    GET    /v1/tenants/{t}/models/{name}?info=1     catalog entry JSON
    DELETE /v1/tenants/{t}/models/{name}            delete

Uploads stream record-by-record (chunked transfer encoding, one frame
per tensor — see ``repro_torch.server.wire``), so a multi-GB model never
materializes server-side as a single buffer; downloads stream the same
format off :meth:`LoadedModel.iter_tensors`. Handlers speak only the
typed dataclasses from :mod:`repro_torch.store.api` and map every failure
through the :mod:`repro_torch.store.errors` registry — same codes, same
statuses, on every route.

The device is the mounted engine's: an upload's HNSW probes run
``quantized_l2`` on its index mirrors from the handler thread, and a
vacuum compacts those mirrors in place of the old ones.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlsplit

from ..core.engine import STATS_SCHEMA_VERSION
from ..obs.metrics import default_registry
from ..obs.trace import (
    get_slow_op_threshold,
    parse_traceparent,
    set_slow_op_threshold,
    trace,
)
from ..store.api import SaveRequest, StoreStats
from ..store.errors import error_payload
from . import wire
from .admission import AdmissionPolicy
from .quota import (
    QuotaManager,
    split_tenant,
    tenant_model_name,
    validate_tenant,
)

__all__ = ["ModelStoreServer"]

_WRITE_METHODS = frozenset({"POST", "PUT", "DELETE"})

# Process-wide server metrics (docs/observability.md). Route labels are
# fixed templates assigned at dispatch — never raw paths — so label
# cardinality is bounded by the route table.
_REG = default_registry()
_M_REQUESTS = _REG.counter(
    "neurstore_server_requests_total",
    "HTTP requests by route template, method and status class.",
    ("route", "method", "status"),
)
_M_REQ_SECONDS = _REG.histogram(
    "neurstore_server_request_seconds",
    "HTTP request wall time by route template.",
    ("route",),
)
_M_INFLIGHT = _REG.gauge(
    "neurstore_server_inflight_requests",
    "HTTP requests currently being handled.",
)
_M_RC_HITS = _REG.counter(
    "neurstore_server_response_cache_hits_total",
    "Response-cache hits (download served as one send).",
)
_M_RC_MISSES = _REG.counter(
    "neurstore_server_response_cache_misses_total",
    "Response-cache misses (download reconstructed from the store).",
)
_M_RC_ADMITTED = _REG.counter(
    "neurstore_server_response_cache_admissions_total",
    "Encoded downloads admitted to the response cache.",
)
_M_RC_BYPASSED = _REG.counter(
    "neurstore_server_response_cache_bypasses_total",
    "Encoded downloads refused admission (larger than max_entry_bytes).",
)
_M_RC_EVICTED = _REG.counter(
    "neurstore_server_response_cache_evictions_total",
    "Response-cache entries evicted by the byte budget.",
)


class _ResponseSent(Exception):
    """A failure occurred after response bytes hit the wire; the
    connection is already marked for close — no error body may follow."""


class _BoundedReader:
    """``.read(n)`` over a Content-Length-delimited request body."""

    def __init__(self, rfile, length: int):
        self._r = rfile
        self._left = length

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        take = self._left if n is None or n < 0 else min(n, self._left)
        data = self._r.read(take)
        self._left -= len(data)
        return data


class _ChunkedReader:
    """``.read(n)`` decoding a chunked transfer-encoded request body.

    ``BaseHTTPRequestHandler`` does not decode chunked bodies; streamed
    uploads need it (the client cannot know Content-Length up front).
    """

    def __init__(self, rfile):
        self._r = rfile
        self._chunk_left = 0
        self._eof = False

    def _next_chunk(self) -> None:
        line = self._r.readline(1 << 16)
        if line in (b"\r\n", b"\n"):  # separator after previous chunk
            line = self._r.readline(1 << 16)
        try:
            self._chunk_left = int(line.split(b";", 1)[0].strip(), 16)
        except ValueError as exc:
            raise wire.WireError(f"bad chunk size line {line!r}") from exc
        if self._chunk_left == 0:
            # Consume the (possibly empty) trailer section up to CRLF.
            while True:
                trailer = self._r.readline(1 << 16)
                if trailer in (b"\r\n", b"\n", b""):
                    break
            self._eof = True

    def read(self, n: int = -1) -> bytes:
        out = []
        want = None if n is None or n < 0 else n
        while not self._eof and (want is None or want > 0):
            if self._chunk_left == 0:
                self._next_chunk()
                continue
            take = self._chunk_left if want is None else min(want, self._chunk_left)
            data = self._r.read(take)
            if not data:
                raise wire.WireError("chunked body truncated mid-chunk")
            self._chunk_left -= len(data)
            if want is not None:
                want -= len(data)
            out.append(data)
        return b"".join(out)


class _ResponseCache:
    """Byte-budgeted LRU of fully-encoded download streams.

    A committed model version is immutable, so its encoded wire stream
    (frames, CRCs and all) is deterministic given ``(model_id, bits)`` —
    ``model_id`` is allocated fresh by every save/replace, which makes
    writer churn invalidate hot entries by key drift, with no explicit
    invalidation hook. A hit turns a read into one socket send: no
    snapshot, no reconstruction, no re-CRC.
    """

    def __init__(self, budget_bytes: int, max_entry_bytes: int | None = None):
        self.budget = budget_bytes
        # Admission policy for very large models: an entry above this
        # threshold bypasses the cache instead of wiping it. Default:
        # a single entry may use at most half the budget, so at least
        # two hot models can stay resident. The bypass is *counted*
        # (admissions/bypasses/evictions below and in the registry), so
        # the policy is visible instead of silent.
        if max_entry_bytes is None:
            max_entry_bytes = budget_bytes // 2
        self.max_entry_bytes = int(max_entry_bytes)
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.bypasses = 0
        self.evictions = 0

    def get(self, key: tuple) -> bytes | None:
        with self._lock:
            blob = self._entries.get(key)
            if blob is None:
                self.misses += 1
                _M_RC_MISSES.inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            _M_RC_HITS.inc()
            return blob

    def put(self, key: tuple, blob: bytes) -> None:
        if len(blob) > self.max_entry_bytes:
            with self._lock:
                self.bypasses += 1
            _M_RC_BYPASSED.inc()
            return
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = blob
            self._bytes += len(blob)
            self.admissions += 1
            _M_RC_ADMITTED.inc()
            while self._bytes > self.budget and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= len(old)
                self.evictions += 1
                _M_RC_EVICTED.inc()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget,
                "max_entry_bytes": self.max_entry_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "admissions": self.admissions,
                "bypasses": self.bypasses,
                "evictions": self.evictions,
            }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "neurstore"
    # Latency hygiene: without these, a streamed response is one small
    # send per frame and Nagle + delayed ACK turn every request into a
    # ~40ms stall on loopback.
    disable_nagle_algorithm = True
    wbufsize = 1 << 16  # handle_one_request() flushes per response

    # The owning ModelStoreServer (set on the server object at mount).
    @property
    def ctx(self) -> "ModelStoreServer":
        return self.server.ctx  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default; ctx counts
        pass

    def send_response(self, code, message=None):
        # Remember the status for the per-route metrics in _route()
        # (BaseHTTPRequestHandler has no other hook for it).
        self._last_status = code
        super().send_response(code, message)

    # ------------------------------------------------------------ plumbing
    def _send_json(self, status: int, obj: dict, headers: dict | None = None):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_for(self, exc: BaseException) -> None:
        status, payload = error_payload(exc)
        headers = {}
        if payload["error"]["code"] == "backpressure":
            headers["Retry-After"] = str(self.ctx.admission.retry_after_s)
        if status >= 500:
            self.ctx.count("errors_5xx")
        if self.headers.get("Transfer-Encoding") or \
                int(self.headers.get("Content-Length") or 0):
            # The request body may be partially unread (an admission
            # reject fires before the upload is consumed); anything left
            # on the socket would be misparsed as the next request, so
            # this connection must not be reused.
            self.close_connection = True
            headers["Connection"] = "close"
        self._send_json(status, payload, headers)

    def _body_reader(self):
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            return _ChunkedReader(self.rfile)
        length = int(self.headers.get("Content-Length") or 0)
        return _BoundedReader(self.rfile, length)

    def _read_json_body(self) -> dict:
        data = self._body_reader().read(-1)
        if not data:
            return {}
        try:
            obj = json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"request body is not JSON: {exc}") from exc
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    # -------------------------------------------------------------- routes
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_DELETE(self):
        self._route("DELETE")

    def _route(self, method: str) -> None:
        """Metrics/tracing envelope around the actual dispatch.

        The request span adopts a client-supplied ``traceparent`` (W3C
        format), so engine spans opened on this handler thread hang off
        the caller's trace id. Per-route counters use fixed route
        templates (``self._route_label``, assigned at dispatch) and the
        status class of the *first* response line sent.
        """
        ctx = self.ctx
        ctx.count("requests")
        parent = parse_traceparent(self.headers.get("traceparent") or "")
        self._route_label = "unknown"
        self._last_status = 0
        span = trace("http.request", parent=parent, method=method,
                     path=self.path)
        _M_INFLIGHT.inc()
        try:
            with span:
                self._dispatch(method)
        finally:
            _M_INFLIGHT.dec()
            status = f"{self._last_status // 100}xx" if self._last_status \
                else "aborted"
            _M_REQUESTS.labels(self._route_label, method, status).inc()
            _M_REQ_SECONDS.labels(self._route_label).observe(span.elapsed())

    def _dispatch(self, method: str) -> None:
        ctx = self.ctx
        url = urlsplit(self.path)
        query = parse_qs(url.query)
        parts = [unquote(p) for p in url.path.strip("/").split("/")]
        try:
            if parts[:1] != ["v1"]:
                raise KeyError(url.path)
            rest = parts[1:]
            if rest == ["healthz"] and method == "GET":
                self._route_label = "healthz"
                self._healthz()
                return
            if rest == ["stats"] and method == "GET":
                self._route_label = "stats"
                self._get_stats()
                return
            if rest == ["metrics"] and method == "GET":
                self._route_label = "metrics"
                self._get_metrics()
                return
            if rest == ["accounting"] and method == "GET":
                self._route_label = "accounting"
                self._send_json(200, _jsonable(ctx.engine.accounting_report(
                    tenant_of=_tenant_of)))
                return
            if rest == ["admin", "vacuum"] and method == "POST":
                self._route_label = "admin.vacuum"
                body = self._read_json_body()
                report = ctx.engine.vacuum(
                    min_dead_fraction=float(body.get("min_dead_fraction", 0.0))
                )
                self._send_json(200, _jsonable(report))
                return
            if len(rest) >= 3 and rest[0] == "tenants":
                tenant = validate_tenant(rest[1])
                if rest[2:] == ["models"] and method == "GET":
                    self._route_label = "tenant.models"
                    self._list_models(tenant)
                    return
                if rest[2:] == ["quota"] and method == "GET":
                    self._route_label = "tenant.quota"
                    self._send_json(
                        200, ctx.quotas.report(ctx.engine, tenant))
                    return
                if (len(rest) >= 5 and rest[2] == "models"
                        and rest[-1] == "explain" and method == "GET"):
                    # Checked before the generic model routes: model
                    # names may contain "/", so ".../models/x/explain"
                    # would otherwise parse as model "x/explain".
                    self._route_label = "model.explain"
                    name = "/".join(rest[3:-1])
                    self._send_json(200, _jsonable(ctx.engine.model_explain(
                        tenant_model_name(tenant, name))))
                    return
                if len(rest) >= 4 and rest[2] == "models":
                    name = "/".join(rest[3:])
                    if method in _WRITE_METHODS:
                        ctx.admission.check_write(
                            StoreStats.from_engine(ctx.engine.stats()))
                    if method == "GET":
                        if query.get("info"):
                            self._route_label = "model.info"
                            self._model_info(tenant, name)
                        else:
                            self._route_label = "model.download"
                            self._download(tenant, name, query)
                        return
                    if method in ("POST", "PUT"):
                        self._route_label = (
                            "model.replace" if method == "PUT"
                            else "model.upload"
                        )
                        self._upload(tenant, name, replace=(method == "PUT"))
                        return
                    if method == "DELETE":
                        self._route_label = "model.delete"
                        ctx.engine.delete_model(
                            tenant_model_name(tenant, name))
                        self._send_json(200, {"deleted": name})
                        return
            raise KeyError(url.path)
        except _ResponseSent:
            pass  # connection already aborted mid-stream
        except BrokenPipeError:
            self.close_connection = True
        except BaseException as exc:  # noqa: BLE001 — typed via the registry
            try:
                self._send_error_for(exc)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

    # ------------------------------------------------------------ handlers
    def _healthz(self) -> None:
        """Liveness plus the facts a probe needs to page on: schema
        version, uptime, degraded-mode flag, maintenance-daemon health."""
        ctx = self.ctx
        engine = ctx.engine
        daemon = engine.maintenance
        maint = {"running": False, "consecutive_errors": 0,
                 "last_error_age_s": None}
        if daemon is not None:
            maint = {
                "running": daemon.running,
                "consecutive_errors": daemon.consecutive_errors,
                "last_error_age_s": daemon.last_error_age_s(),
            }
        self._send_json(200, {
            "ok": True,
            "stats_schema_version": STATS_SCHEMA_VERSION,
            "uptime_s": time.monotonic() - ctx.started_at,
            "read_only": engine.read_only,
            "slow_op_threshold_s": get_slow_op_threshold(),
            "maintenance": maint,
        })

    def _get_metrics(self) -> None:
        """Prometheus text exposition of the process-wide registry."""
        body = default_registry().render().encode("utf-8")
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _get_stats(self) -> None:
        stats = StoreStats.from_engine(self.ctx.engine.stats())
        out = stats.to_dict()
        # Server-side telemetry rides in the undocumented raw dump; the
        # documented schema stays exactly the StoreStats fields.
        out["raw"]["server"] = self.ctx.server_stats()
        self._send_json(200, out)

    def _list_models(self, tenant: str) -> None:
        prefix = f"{tenant}/"
        names = [
            n[len(prefix):]
            for n in self.ctx.engine.list_models()
            if n.startswith(prefix)
        ]
        self._send_json(200, {"models": names})

    def _model_info(self, tenant: str, name: str) -> None:
        full = tenant_model_name(tenant, name)
        entry = self.ctx.engine.model_info(full)
        if entry is None:
            raise KeyError(name)
        info = entry.to_dict()
        info["name"] = name
        info["page_bytes"] = self.ctx.engine._page_size(entry)
        self._send_json(200, info)

    def _upload(self, tenant: str, name: str, replace: bool) -> None:
        """Streamed save: decode tensors record-by-record, commit, report.

        Tensor arrays are collected as independent per-record buffers
        (the dict the engine's Algorithm-1 pipeline wants); the *model*
        never exists as one contiguous buffer on this side of the wire.
        """
        full = tenant_model_name(tenant, name)
        reader = self._body_reader()
        header, records = wire.decode_model_stream(reader)
        tensors = OrderedDict()
        for tname, arr in records:
            if tname in tensors:
                raise ValueError(f"duplicate tensor {tname!r} in upload")
            tensors[tname] = arr
        # Drain the body to its end (the chunked terminator / any slack)
        # so the keep-alive connection is positioned at the next request.
        reader.read(-1)
        req = SaveRequest.from_wire(header, tensors)
        engine = self.ctx.engine
        if replace:
            report = engine.replace_model(
                full, req.architecture, req.tensors,
                tolerance=req.tolerance, tau=req.tau)
        else:
            report = engine.save_model(
                full, req.architecture, req.tensors,
                tolerance=req.tolerance, tau=req.tau)
        out = report.to_dict()
        out["name"] = name  # strip the tenant prefix from the wire name
        self._send_json(200, out)

    def _download(self, tenant: str, name: str, query: dict) -> None:
        full = tenant_model_name(tenant, name)
        bits = None
        if query.get("bits"):
            bits = int(query["bits"][0])
        cache = self.ctx.response_cache
        entry = self.ctx.engine.model_info(full)
        if entry is not None:
            blob = cache.get((entry.model_id, bits))
            if blob is not None:  # hot path: one send, nothing recomputed
                self._send_stream_headers()
                self._stream_body([blob])
                return
        # Open the handle (snapshot capture) BEFORE committing to a 200:
        # not_found/corrupt surface as proper statuses. After streaming
        # starts the only honest failure mode is connection abort — the
        # client detects it via the missing trailer frame.
        lm = self.ctx.engine.load_model(full, bits=bits)
        try:
            header = {
                "name": name,
                "architecture": lm.info["architecture"],
                "bits": bits,
                "n_tensors": len(lm.tensor_names()),
            }
            frames: list[bytes] = []
            self._send_stream_headers()
            # The span covers dequant + wire encode + socket writes — the
            # part of a cold download the response cache saves on a hit.
            with trace("decode", model=name, n_tensors=header["n_tensors"]):
                self._stream_body(
                    wire.encode_model_stream(header, lm.iter_tensors()),
                    collect=frames)
            if frames:
                cache.put((lm.info["id"], bits), b"".join(frames))
        finally:
            lm.close()

    def _send_stream_headers(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-neurstore-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _stream_body(self, frames, collect: list | None = None) -> None:
        """Send frames as chunks; on ``collect`` success-only accumulate."""
        try:
            for frame in frames:
                self._write_chunk(frame)
                if collect is not None:
                    collect.append(frame)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            if collect is not None:
                collect.clear()  # encode may not have finished cleanly
        except BaseException as exc:
            # Mid-stream failure after the 200 went out: abort the
            # connection so the client sees a truncated stream
            # (WireError), never a silently short model — and never a
            # second response spliced into the chunk sequence.
            self.ctx.count("errors_5xx")
            self.close_connection = True
            raise _ResponseSent() from exc

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")


def _tenant_of(full_name: str) -> str | None:
    """Accounting tenant attribution: the validated tenant namespace of
    a catalog name, or ``None`` for embedded (non-namespaced) models."""
    parsed = split_tenant(full_name)
    return parsed[0] if parsed is not None else None


def _jsonable(obj):
    """Deep-convert a report dict to JSON-safe types (int dict keys)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v) for v in obj]
    return obj


class ModelStoreServer:
    """One engine behind a threaded HTTP front door.

    ``port=0`` binds an ephemeral port (read it back via ``.port``).
    The server installs the tenant quota gate as the engine's
    ``commit_gate`` for its lifetime; embedded (non-namespaced) saves
    through the same engine are unaffected by tenant quotas.
    """

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 0,
        quotas: QuotaManager | None = None,
        admission: AdmissionPolicy | None = None,
        response_cache_bytes: int = 256 << 20,
        response_cache_max_entry_bytes: int | None = None,
        slow_op_threshold_s: float | None = None,
    ):
        self.engine = engine
        if slow_op_threshold_s is not None:
            # Process-wide knob (one trace ring, one threshold); the
            # active value is surfaced in /v1/healthz. None = leave the
            # env-var / set_slow_op_threshold() configured value alone.
            set_slow_op_threshold(slow_op_threshold_s)
        self.quotas = quotas if quotas is not None else QuotaManager()
        self.admission = admission if admission is not None else AdmissionPolicy()
        self.started_at = time.monotonic()
        # Hot downloads skip reconstruction entirely (keyed by immutable
        # model version, so replaces invalidate by key drift).
        self.response_cache = _ResponseCache(
            response_cache_bytes,
            max_entry_bytes=response_cache_max_entry_bytes,
        )
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.ctx = self  # type: ignore[attr-defined]
        self._counters: dict[str, int] = {"requests": 0, "errors_5xx": 0}
        self._counter_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        engine.commit_gate = self.quotas.gate(engine)

    # ------------------------------------------------------------- control
    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "ModelStoreServer":
        """Serve on a background thread (returns immediately)."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="neurstore-server", daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (the ``python -m repro_torch.server`` path)."""
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # The engine may outlive the server (caller-owned), but queued
        # EXPLAIN sidecars should not wait for its close().
        self.engine.flush_explains()
        if self.engine.commit_gate is not None:
            self.engine.commit_gate = None

    def __enter__(self) -> "ModelStoreServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------- telemetry
    def count(self, key: str) -> None:
        with self._counter_lock:
            self._counters[key] = self._counters.get(key, 0) + 1

    def server_stats(self) -> dict:
        with self._counter_lock:
            out = dict(self._counters)
        out["admission"] = self.admission.stats()
        out["response_cache"] = self.response_cache.stats()
        return out
