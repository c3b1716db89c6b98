"""``StoreClient`` — the typed network client (stdlib ``http.client``).

Mirrors the embedded :class:`repro_torch.store.NeurStore` facade method for
method and speaks the same dataclasses (:class:`SaveRequest` in,
:class:`SaveReport`/:class:`LoadHandle`/:class:`StoreStats` out), so
swapping embedded ↔ served access is a one-line change at the call
site. Uploads stream chunked record-by-record (the client never builds
one model-sized buffer either); downloads default to eager
materialization so the keep-alive connection is immediately reusable —
pass ``stream=True`` for a bounded-memory lazy handle that owns the
connection until closed.

Error contract: a non-2xx response body is ``{"error": {"code",
"message"}}``; the client re-raises the **same typed exception** the
embedded API would (``KeyError``, ``CorruptPageError``,
``QuotaExceededError``, ``AdmissionRejectedError``, ...) via
:func:`repro_torch.store.errors.raise_for_code`.

Connections are per-thread (thread-local keep-alive), so one client
instance is safe to share across reader threads. A request that hits a
dead keep-alive socket (server restarted, idle timeout) reconnects and
retries once before surfacing the failure.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
from urllib.parse import quote

from ..obs.trace import trace
from ..store.api import LoadHandle, SaveReport, SaveRequest, StoreStats
from ..store.errors import RemoteStoreError, raise_for_code
from . import wire

__all__ = ["StoreClient"]

_RETRYABLE = (
    http.client.RemoteDisconnected,
    http.client.CannotSendRequest,
    BrokenPipeError,
    ConnectionResetError,
    ConnectionAbortedError,
)


class _BufferedResponse:
    """A fully-read response detached from its (now closed) connection."""

    def __init__(self, status: int, data: bytes):
        self.status = status
        self._data = data

    def read(self, n: int = -1) -> bytes:
        out = self._data if n is None or n < 0 else self._data[:n]
        self._data = b"" if n is None or n < 0 else self._data[len(out):]
        return out


class StoreClient:
    """Typed client for one tenant namespace on one model-store server."""

    def __init__(self, host: str, port: int, tenant: str = "default",
                 timeout: float = 60.0):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.timeout = timeout
        self._local = threading.local()

    # --------------------------------------------------------- connections
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
            conn.connect()
            # Chunked uploads are many small sends; Nagle + delayed ACK
            # would add ~40ms per request on loopback.
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def close(self) -> None:
        """Close this thread's keep-alive connection (others unaffected)."""
        self._drop_conn()

    def __enter__(self) -> "StoreClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ plumbing
    def _request(self, method: str, path: str, body=None,
                 chunked: bool = False):
        """One request with a single reconnect-and-retry on a dead socket.

        ``body`` may be a callable returning a fresh bytes-iterator so a
        chunked upload can be replayed on retry (a plain generator would
        be half-exhausted after the first attempt).

        Every request carries a W3C ``traceparent`` header, so the
        server's ``http.request`` span (and the engine spans under it)
        joins this client's trace — nested under the caller's span when
        one is active on this thread, a fresh trace otherwise.
        """
        with trace("client.request", method=method, path=path) as span:
            headers = {"traceparent": span.traceparent()}
            for attempt in (0, 1):
                conn = self._conn()
                try:
                    payload = body() if callable(body) else body
                    try:
                        if chunked:
                            headers["Transfer-Encoding"] = "chunked"
                            conn.request(method, path, body=payload,
                                         headers=headers,
                                         encode_chunked=True)
                        else:
                            conn.request(method, path, body=payload,
                                         headers=headers)
                    except (BrokenPipeError, ConnectionResetError):
                        # The server can reject an upload EARLY (e.g. 429
                        # backpressure) and stop reading mid-body; the
                        # error response is already waiting on the socket
                        # — read it instead of surfacing the pipe failure.
                        early = self._read_early_response(conn)
                        if early is not None:
                            return early
                        raise
                    return conn.getresponse()
                except _RETRYABLE:
                    self._drop_conn()
                    if attempt:
                        raise
                except OSError:
                    self._drop_conn()
                    raise
        raise AssertionError("unreachable")

    def _read_early_response(self, conn):
        """Salvage a response the server sent before the upload finished.

        The connection is misaligned afterwards (part of our body is
        unconsumed), so the response is buffered fully and the socket
        dropped before returning.
        """
        try:
            resp = conn.getresponse()
            buffered = _BufferedResponse(resp.status, resp.read())
        except Exception:  # noqa: BLE001 — no response to salvage
            return None
        finally:
            self._drop_conn()
        return buffered

    def _json(self, method: str, path: str, body=None, chunked=False) -> dict:
        resp = self._request(method, path, body=body, chunked=chunked)
        data = resp.read()  # fully drain → connection stays reusable
        if resp.status >= 400:
            self._raise_error(resp.status, data)
        try:
            return json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise RemoteStoreError(
                f"malformed response body from server: {exc}") from exc

    def _raise_error(self, status: int, data: bytes) -> None:
        try:
            err = json.loads(data.decode("utf-8"))["error"]
            code, message = err["code"], err.get("message", "")
        except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
                TypeError):
            raise RemoteStoreError(
                f"HTTP {status}: {data[:200]!r}") from None
        raise_for_code(code, message)

    def _model_path(self, name: str, suffix: str = "") -> str:
        return (f"/v1/tenants/{quote(self.tenant, safe='')}"
                f"/models/{quote(name, safe='/')}"  # names may contain '/'
                f"{suffix}")

    # --------------------------------------------------------------- writes
    def save(self, request: SaveRequest) -> SaveReport:
        """Stream one model up and commit it (server-side Algorithm 1)."""
        return self._save(request, method="POST")

    def replace(self, request: SaveRequest) -> SaveReport:
        """Atomic replace: new version in, old version dropped, one txn."""
        return self._save(request, method="PUT")

    def _save(self, request: SaveRequest, method: str) -> SaveReport:
        def body():
            return wire.encode_model_stream(
                request.wire_header(), iter(request.tensors.items()))

        out = self._json(method, self._model_path(request.name),
                         body=body, chunked=True)
        return SaveReport.from_dict(out)

    def delete(self, name: str) -> None:
        self._json("DELETE", self._model_path(name))

    def vacuum(self, min_dead_fraction: float = 0.0) -> dict:
        return self._json("POST", "/v1/admin/vacuum",
                          body=json.dumps(
                              {"min_dead_fraction": min_dead_fraction}
                          ).encode("utf-8"))

    # ---------------------------------------------------------------- reads
    def load(self, name: str, bits: int | None = None,
             stream: bool = False) -> LoadHandle:
        """Download a model as a :class:`LoadHandle`.

        Default is **eager**: the stream is fully decoded into the
        handle's cache before returning, so the trailer (completeness
        proof) is verified here and the connection is free for the next
        request. ``stream=True`` returns a lazy one-shot handle — bounded
        memory, but it owns this thread's connection until consumed or
        closed.
        """
        suffix = f"?bits={int(bits)}" if bits is not None else ""
        resp = self._request("GET", self._model_path(name, suffix))
        if resp.status >= 400:
            self._raise_error(resp.status, resp.read())
        header, records = wire.decode_model_stream(resp)

        def _close():
            # Abandon the response mid-stream: kill the socket rather
            # than read an unbounded remainder.
            resp.close()
            self._drop_conn()

        handle = LoadHandle.from_stream(header, records, close=_close)
        if not stream:
            try:
                handle.materialize()  # validates trailer + per-tensor CRCs
            except BaseException:
                _close()
                raise
            resp.read()  # response exhausted → keep-alive stays valid
            handle._close = None
        return handle

    def model_info(self, name: str) -> dict:
        return self._json("GET", self._model_path(name, "?info=1"))

    def models(self) -> list[str]:
        path = f"/v1/tenants/{quote(self.tenant, safe='')}/models"
        return list(self._json("GET", path)["models"])

    def quota(self) -> dict:
        path = f"/v1/tenants/{quote(self.tenant, safe='')}/quota"
        return self._json("GET", path)

    def stats(self) -> StoreStats:
        return StoreStats.from_dict(self._json("GET", "/v1/stats"))

    def accounting(self) -> dict:
        """Store-wide space accounting report (``GET /v1/accounting``).

        Same shape as the embedded ``NeurStore.accounting()``:
        ``{"store", "per_model", "per_dim", "per_tenant"}`` — see
        ``docs/observability.md`` for field semantics.
        """
        return self._json("GET", "/v1/accounting")

    def explain(self, name: str) -> dict:
        """Persisted save EXPLAIN + space attribution for one model."""
        return self._json("GET", self._model_path(name, "/explain"))

    def healthz(self) -> bool:
        return bool(self._json("GET", "/v1/healthz").get("ok"))
