"""Spans, trace context propagation, recent-trace ring, slow-op log.

A *span* is one timed operation; spans nest into a tree via a
``contextvars.ContextVar`` holding the current span (contextvars are
per-thread under ``ThreadingHTTPServer``, so concurrent requests never
cross-contaminate).  The root span of each tree carries the W3C-style
``trace_id``; ``Span.traceparent()`` / ``parse_traceparent()`` move it
across the HTTP hop (``StoreClient`` sends the header on every request,
``ModelStoreServer`` adopts it), so a client-side trace id names the
server-side span tree for the same logical operation.

Completed **root** spans go two places:

- a bounded in-memory ring (``recent_traces()``), newest last, for
  ``tools/nstat.py`` and post-hoc debugging;
- the slow-op log: a root span whose elapsed time exceeds
  ``set_slow_op_threshold()`` emits its full indented span tree at
  WARNING via ``logging.getLogger("repro_torch.obs.slow")``.

Timing is monotonic (``time.perf_counter``).  ``trace()`` always times —
even with observability disabled — because engine wall-time reporting
(``SaveReport.seconds``) is derived from spans; disabling only stops
recording (no ring append, no slow-op log, no attr retention).
"""

from __future__ import annotations

import contextvars
import logging
import os
import secrets
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from repro_torch.obs import metrics as _metrics

__all__ = [
    "Span",
    "current_span",
    "get_slow_op_threshold",
    "parse_traceparent",
    "recent_traces",
    "set_slow_op_threshold",
    "set_trace_ring_size",
    "trace",
]

_slow_log = logging.getLogger("repro_torch.obs.slow")

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_obs_current_span", default=None
)

_ring_lock = threading.Lock()
_ring: Deque["Span"] = deque(maxlen=256)

# Seconds; roots slower than this dump their tree to the slow-op log.
# Default 1.0 s: a full-model save at bench scale sits well under it,
# so production logs stay quiet unless something is actually slow.
# Overridable without code via NEURSTORE_SLOW_OP_THRESHOLD_S (read once
# at import; invalid values fall back to the default), and at runtime
# via set_slow_op_threshold() / the ModelStoreServer knob.
DEFAULT_SLOW_OP_THRESHOLD_S = 1.0


def _threshold_from_env() -> float:
    raw = os.environ.get("NEURSTORE_SLOW_OP_THRESHOLD_S")
    if raw is None:
        return DEFAULT_SLOW_OP_THRESHOLD_S
    try:
        val = float(raw)
    except ValueError:
        return DEFAULT_SLOW_OP_THRESHOLD_S
    if not (val > 0.0):  # rejects NaN, zero and negatives
        return DEFAULT_SLOW_OP_THRESHOLD_S
    return val


_slow_threshold_s = _threshold_from_env()

_slow_ops_total = _metrics.default_registry().counter(
    "neurstore_slow_ops_total",
    "Root spans exceeding the slow-op threshold, by root span name.",
    labelnames=("op",),
)


def set_trace_ring_size(n: int) -> None:
    """Resize the recent-trace ring (drops existing entries)."""
    global _ring
    with _ring_lock:
        _ring = deque(maxlen=max(1, int(n)))


def set_slow_op_threshold(seconds: float) -> float:
    """Set the slow-op threshold; returns the previous value."""
    global _slow_threshold_s
    prev = _slow_threshold_s
    _slow_threshold_s = float(seconds)
    return prev


def get_slow_op_threshold() -> float:
    return _slow_threshold_s


def recent_traces(n: Optional[int] = None) -> List["Span"]:
    """Most recent completed root spans, oldest first."""
    with _ring_lock:
        items = list(_ring)
    return items if n is None else items[-n:]


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


def parse_traceparent(header: str) -> Optional[Tuple[str, str]]:
    """Parse a W3C traceparent header -> (trace_id, parent_span_id).

    Accepts ``{version}-{trace_id:32hex}-{span_id:16hex}-{flags}``;
    returns None on anything malformed (callers start a fresh trace).
    """
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


class Span:
    """One timed operation.  Use via ``trace()``; not constructed directly.

    Attributes are public and stable for tools/tests: ``name``,
    ``trace_id``, ``span_id``, ``parent_id``, ``attrs``, ``children``,
    ``start`` / ``end`` (perf_counter seconds; ``end`` is None while
    open).
    """

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "attrs",
        "children",
        "start",
        "end",
        "_token",
        "_recording",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        recording: bool,
        attrs: Optional[Dict[str, object]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self.children: List[Span] = []
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self._token: Optional[contextvars.Token] = None
        self._recording = recording

    def elapsed(self) -> float:
        """Seconds since start (wall time of the span once closed)."""
        return (self.end if self.end is not None else time.perf_counter()) - self.start

    def set_attr(self, key: str, value: object) -> None:
        if self._recording:
            self.attrs[key] = value

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    # -- context manager -------------------------------------------------

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end = time.perf_counter()
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if not self._recording:
            return
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        # Local root (no enclosing span in this context — a span adopted
        # from a remote traceparent has a parent_id but is still the
        # local root): publish to the ring + slow-op log.
        if _current.get() is None:
            self._finish_root()

    def _finish_root(self) -> None:
        with _ring_lock:
            _ring.append(self)
        took = self.elapsed()
        if took >= _slow_threshold_s:
            _slow_ops_total.labels(self.name).inc()
            _slow_log.warning(
                "slow op: %s took %.3fs (threshold %.3fs)\n%s",
                self.name,
                took,
                _slow_threshold_s,
                self.format_tree(),
            )

    # -- inspection ------------------------------------------------------

    def walk(self) -> Iterator["Span"]:
        yield self
        for child in self.children:
            yield from child.walk()

    def find(self, name: str) -> Optional["Span"]:
        for span in self.walk():
            if span.name == name:
                return span
        return None

    def format_tree(self, indent: int = 0) -> str:
        """Indented one-line-per-span rendering (the slow-op log format)."""
        attrs = ""
        if self.attrs:
            attrs = " " + " ".join(
                f"{k}={v}" for k, v in sorted(self.attrs.items())
            )
        lines = [
            f"{'  ' * indent}- {self.name} {self.elapsed() * 1e3:.3f}ms"
            f" [{self.span_id}]{attrs}"
        ]
        for child in self.children:
            lines.append(child.format_tree(indent + 1))
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "elapsed_s": self.elapsed(),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, trace={self.trace_id[:8]}…, "
            f"elapsed={self.elapsed():.6f}s, children={len(self.children)})"
        )


def current_span() -> Optional[Span]:
    return _current.get()


def trace(
    name: str,
    parent: Optional[Tuple[str, str]] = None,
    **attrs: object,
) -> Span:
    """Open a span as a context manager.

    Nesting is implicit: a ``trace()`` inside an active span becomes its
    child.  ``parent=(trace_id, span_id)`` (from ``parse_traceparent``)
    grafts this span under a **remote** parent instead — used by the
    server to adopt a client's trace id.

    With observability disabled the span still measures time (callers
    rely on ``elapsed()``) but records nothing: no child linkage beyond
    the context var, no ring, no slow-op log.
    """
    recording = _metrics.metrics_enabled()
    cur = _current.get()
    if not recording:
        # Disabled: a timer-only span.  No id generation (os.urandom is
        # the dominant cost of span creation), no child linkage.
        return Span(
            name,
            trace_id="0" * 32,
            span_id="0" * 16,
            parent_id=None,
            recording=False,
        )
    if parent is not None:
        trace_id, parent_id = parent
    elif cur is not None:
        trace_id, parent_id = cur.trace_id, cur.span_id
    else:
        trace_id, parent_id = _new_trace_id(), None
    span = Span(
        name,
        trace_id=trace_id,
        span_id=_new_span_id(),
        parent_id=parent_id,
        recording=recording,
        attrs=attrs,
    )
    if recording and cur is not None and parent is None:
        cur.children.append(span)
    return span
