"""Process-wide metrics registry with a Prometheus text renderer.

Design constraints, in order:

1. **Hot-path cost.**  ``Counter.inc()`` sits inside HNSW search loops
   and the buffer-pool ``get()``.  An increment is one attribute load,
   one branch, one float ``+=`` — "atomic enough" under the GIL: a
   single ``+=`` on an instance attribute can interleave and drop an
   update under free-threading, but never corrupts, and the serving
   workload is orders of magnitude below where drops are observable.
   No lock is taken on increment; locks guard only child creation and
   rendering.
2. **Near-zero when disabled.**  ``set_enabled(False)`` flips one
   module-global checked at the top of every mutate call.  The
   counter-increment microbench in ``serving_bench.py`` records both
   costs.
3. **Stable exposition.**  ``render()`` emits Prometheus text format
   (``# HELP`` / ``# TYPE``, cumulative ``_bucket{le=...}`` histograms);
   ``parse_prometheus_text`` round-trips it for tests and for the
   bench-smoke scrape check.

Metric families are created idempotently: ``registry.counter(name, ...)``
returns the existing family if the name is taken (and asserts the type
matches), so every instrumented module can declare its own families at
import time without coordination.

Gauges support two styles: direct ``set()``/``inc()`` for values owned
by one writer (e.g. requests in flight), and **weakref callbacks**
(``gauge.attach(owner, fn)``) for values derived from live objects
(bytes resident in a buffer pool).  Tests open many engines per
process; attaching via weakref means a closed/collected engine silently
drops out of the sum instead of pinning itself alive or reporting stale
bytes.
"""

from __future__ import annotations

import math
import re
import threading
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "parse_prometheus_text",
    "set_enabled",
    "LATENCY_BUCKETS",
]

# Toggled by set_enabled(); read (not imported) by every mutate call so
# the flip is visible process-wide without rebinding callers.
_ENABLED = True

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Fixed log-scaled latency buckets (seconds): 1 us .. 10 s, x10 per
# decade with a 2.5/5 split — fine enough to separate a pool hit from a
# page read from a full-model decode, coarse enough that a histogram is
# 23 floats.  Shared by every latency histogram so dashboards align.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(base * 10.0**exp, 12)
    for exp in range(-6, 1)
    for base in (1.0, 2.5, 5.0)
) + (10.0,)


def set_enabled(enabled: bool) -> None:
    """Enable/disable all metric mutation process-wide (render still works)."""
    global _ENABLED
    _ENABLED = bool(enabled)


def metrics_enabled() -> bool:
    return _ENABLED


def _fmt(v: float) -> str:
    """Prometheus-style float: integers bare, +Inf spelled, else repr."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Family:
    """Base for one named metric family with a fixed label schema."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, *values: object):
        """Child for one label-value tuple (created on first use)."""
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            if len(key) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected {len(self.labelnames)} label "
                    f"values, got {len(key)}"
                )
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        """Yield (name_suffix, label_str, value) triples for render()."""
        raise NotImplementedError  # pragma: no cover - abstract


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value += amount


class Counter(_Family):
    """Monotonic counter family.  Unlabeled families inc on self."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._self_child = _CounterChild() if not labelnames else None

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        if self._self_child is None:
            raise ValueError(f"{self.name} is labeled; use .labels(...).inc()")
        if _ENABLED:
            self._self_child.value += amount

    @property
    def value(self) -> float:
        if self._self_child is None:
            raise ValueError(f"{self.name} is labeled; read children instead")
        return self._self_child.value

    def samples(self):
        # Text format 0.0.4: the counter sample name IS the family name
        # (the `_total` suffix is a naming convention, not appended).
        if self._self_child is not None:
            yield "", "", self._self_child.value
            return
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            yield "", _label_str(self.labelnames, key), child.value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        if _ENABLED:
            self.value = value

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value -= amount


class Gauge(_Family):
    """Gauge family: direct set/inc/dec plus weakref-bound callbacks.

    ``attach(owner, fn)`` registers ``fn()`` to be summed into the
    unlabeled value at render time for as long as ``owner`` is alive.
    A callback that raises contributes 0 (render must never fail
    because one engine is mid-close).
    """

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._self_child = _GaugeChild() if not labelnames else None
        self._callbacks: List[Tuple[weakref.ref, Callable[[], float]]] = []

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        if self._self_child is None:
            raise ValueError(f"{self.name} is labeled; use .labels(...).set()")
        if _ENABLED:
            self._self_child.value = value

    def inc(self, amount: float = 1.0) -> None:
        if self._self_child is None:
            raise ValueError(f"{self.name} is labeled; use .labels(...).inc()")
        if _ENABLED:
            self._self_child.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def attach(self, owner: object, fn: Callable[[object], float]) -> None:
        """Sum ``fn(owner)`` into this gauge while ``owner`` is alive.

        ``fn`` receives the (still-live) owner as its only argument — it
        must NOT close over the owner, or the strong reference in the
        closure would defeat the weakref and pin the owner forever.
        """
        if self._self_child is None:
            raise ValueError(f"{self.name} is labeled; attach is unlabeled-only")
        with self._lock:
            self._callbacks.append((weakref.ref(owner), fn))

    def _callback_sum(self) -> float:
        total = 0.0
        dead = False
        with self._lock:
            callbacks = list(self._callbacks)
        for ref, fn in callbacks:
            obj = ref()
            if obj is None:
                dead = True
                continue
            try:
                total += float(fn(obj))
            except Exception:
                continue
        if dead:
            with self._lock:
                self._callbacks = [
                    (r, f) for r, f in self._callbacks if r() is not None
                ]
        return total

    @property
    def value(self) -> float:
        if self._self_child is None:
            raise ValueError(f"{self.name} is labeled; read children instead")
        return self._self_child.value + self._callback_sum()

    def samples(self):
        if self._self_child is not None:
            yield "", "", self._self_child.value + self._callback_sum()
            return
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            yield "", _label_str(self.labelnames, key), child.value


class _HistogramChild:
    __slots__ = ("bucket_counts", "sum", "count", "buckets")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self.buckets = buckets
        self.bucket_counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        buckets = self.buckets
        lo, hi = 0, len(buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        if lo < len(buckets):
            self.bucket_counts[lo] += 1
        self.sum += value
        self.count += 1


class Histogram(_Family):
    """Histogram family with fixed buckets (defaults to LATENCY_BUCKETS)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(buckets if buckets is not None else LATENCY_BUCKETS))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b
        self._self_child = _HistogramChild(b) if not labelnames else None

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        if self._self_child is None:
            raise ValueError(
                f"{self.name} is labeled; use .labels(...).observe()"
            )
        self._self_child.observe(value)

    def _child_samples(self, label_key: Tuple[str, ...], child: _HistogramChild):
        cumulative = 0
        for ub, n in zip(child.buckets, child.bucket_counts):
            cumulative += n
            names = self.labelnames + ("le",)
            values = label_key + (_fmt(ub),)
            yield "_bucket", _label_str(names, values), float(cumulative)
        names = self.labelnames + ("le",)
        values = label_key + ("+Inf",)
        yield "_bucket", _label_str(names, values), float(child.count)
        base = _label_str(self.labelnames, label_key)
        yield "_sum", base, child.sum
        yield "_count", base, float(child.count)

    def samples(self):
        if self._self_child is not None:
            yield from self._child_samples((), self._self_child)
            return
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            yield from self._child_samples(key, child)


class MetricsRegistry:
    """Named families, created idempotently, rendered as Prometheus text."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label schema"
                    )
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out: List[str] = []
        for fam in self.families():
            help_text = fam.help.replace("\\", "\\\\").replace("\n", "\\n")
            out.append(f"# HELP {fam.name} {help_text}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for suffix, labels, value in fam.samples():
                out.append(f"{fam.name}{suffix}{labels} {_fmt(value)}")
        return "\n".join(out) + "\n"

    def sample_value(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        """Test/tool helper: current value of one rendered sample."""
        parsed = parse_prometheus_text(self.render())
        want = dict(labels or {})
        for fam in parsed.values():
            for sample in fam["samples"]:
                if sample["name"] == name and sample["labels"] == want:
                    return sample["value"]
        return None


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def _strip_hist_suffix(sample_name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\d+)?$"
)
_LABEL_PAIR_RE = re.compile(
    r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"'
)


def _unescape_label(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse exposition text back into {family: {type, help, samples}}.

    Strict enough to catch malformed output (used by the bench-smoke
    scrape check): every non-comment line must match the sample grammar,
    every sample must belong to a family announced by ``# TYPE``.
    Raises ``ValueError`` on violation.
    """
    families: Dict[str, dict] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP ") :].split(" ", 1)
            fam = families.setdefault(
                parts[0], {"type": None, "help": "", "samples": []}
            )
            fam["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE ") :].split(" ", 1)
            if len(parts) != 2 or parts[1] not in (
                "counter",
                "gauge",
                "histogram",
                "summary",
                "untyped",
            ):
                raise ValueError(f"line {lineno}: bad TYPE line: {raw!r}")
            fam = families.setdefault(
                parts[0], {"type": None, "help": "", "samples": []}
            )
            fam["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(m.group("labels")):
                labels[pm.group("name")] = _unescape_label(pm.group("value"))
                consumed += 1
            # Every comma-separated pair must have parsed.
            n_pairs = len([p for p in m.group("labels").split(",") if p])
            if consumed != n_pairs:
                raise ValueError(f"line {lineno}: malformed labels: {raw!r}")
        name = m.group("name")
        # Exact family-name match wins (a counter named *_count is its
        # own family); otherwise strip histogram sample suffixes.
        if name in families and families[name]["type"] is not None:
            base = name
        else:
            base = _strip_hist_suffix(name)
        if base not in families or families[base]["type"] is None:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no # TYPE announcement"
            )
        families[base]["samples"].append(
            {"name": name, "labels": labels, "value": _parse_value(m.group("value"))}
        )
    return families
