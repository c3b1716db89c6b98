"""Background maintenance daemon — incremental auto-vacuum + pool trims.

The write path never has to stop the world to reclaim space: a daemon
thread watches the store and does one small increment of work per step,
yielding the engine lock between steps so reader snapshots and writer
commits interleave freely.

Each :meth:`MaintenanceDaemon.step` does exactly:

1. **one dim-group of auto-vacuum** — round-robin over the index dims,
   calling ``engine.vacuum(min_dead_fraction=…, dims=[dim])`` for the
   single dim under the cursor. The engine's vacuum already skips dims
   with in-flight saves and is copy-on-write, so a step never invalidates
   a live reader; the dead-vertex threshold keeps steps cheap until
   enough garbage accrues to be worth a compaction.
2. **buffer-pool pressure trim** — when resident bytes exceed the high
   watermark, evict unpinned frames back down to it.
3. **index-cache trim** — the existing commit-boundary budget enforcement,
   run off the write path too so a read-only workload also converges.
4. **one scrub increment** — ``engine.scrub(scrub_models)`` verifies the
   next committed page's checksums (round-robin), so latent disk
   corruption is quarantined before a reader trips on it.

Tests drive ``step()`` synchronously for determinism; ``start()`` spawns
the daemon thread that calls it every ``interval_s`` seconds.

Failure containment (the daemon must never die silently): a step that
raises is counted and remembered (``errors`` / ``last_error``), and the
loop backs off exponentially (capped at ``max_backoff_s``) while errors
persist, resetting to ``interval_s`` on the first success. If the loop
body itself somehow escapes — a ``BaseException``, an error in the backoff
logic — a supervisor wrapper records it, increments ``restarts``, and
restarts the loop rather than leaving a dead thread that looks alive from
``stats()``.
"""

from __future__ import annotations

import threading
import time

from ..obs.metrics import default_registry
from ..obs.trace import trace

__all__ = ["MaintenanceDaemon"]

# Process-wide maintenance metrics (docs/observability.md), summed over
# every daemon in the process.
_REG = default_registry()
_M_STEPS = _REG.counter(
    "neurstore_maintenance_steps_total", "Completed maintenance steps."
)
_M_VACUUMED = _REG.counter(
    "neurstore_maintenance_vacuumed_vertices_total",
    "Dead vertices reclaimed by auto-vacuum.",
)
_M_TRIMMED = _REG.counter(
    "neurstore_maintenance_pool_bytes_trimmed_total",
    "Buffer-pool bytes evicted by pressure trims.",
)
_M_SCRUBBED = _REG.counter(
    "neurstore_maintenance_pages_scrubbed_total",
    "Pages checksum-verified by the scrubber.",
)
_M_CORRUPT = _REG.counter(
    "neurstore_maintenance_corrupt_found_total",
    "Corrupt pages found (and quarantined) by the scrubber.",
)
_M_ERRORS = _REG.counter(
    "neurstore_maintenance_errors_total", "Maintenance steps that raised."
)
_M_RESTARTS = _REG.counter(
    "neurstore_maintenance_restarts_total",
    "Supervisor restarts of an escaped maintenance loop.",
)
_M_CONSEC = _REG.gauge(
    "neurstore_maintenance_consecutive_errors",
    "Consecutive failed steps, summed over running daemons.",
)
_M_ERR_AGE = _REG.gauge(
    "neurstore_maintenance_last_error_age_seconds",
    "Seconds since the most recent step error (0 when none yet).",
)


class MaintenanceDaemon:
    """Incremental auto-vacuum + cache-pressure trims for a StorageEngine."""

    def __init__(
        self,
        engine,
        dead_fraction: float = 0.25,
        interval_s: float = 1.0,
        pool_high_watermark: float = 0.9,
        scrub_models: int = 1,
        max_backoff_s: float = 30.0,
    ):
        self.engine = engine
        self.dead_fraction = float(dead_fraction)
        self.interval_s = float(interval_s)
        self.pool_high_watermark = float(pool_high_watermark)
        self.scrub_models = int(scrub_models)
        self.max_backoff_s = float(max_backoff_s)
        self._cursor = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # one step at a time (thread + tests)
        self.steps = 0
        self.vacuumed_vertices = 0
        self.pages_rewritten = 0
        self.pool_bytes_trimmed = 0
        self.pages_scrubbed = 0
        self.corrupt_found = 0
        self.errors = 0
        self.last_error: str | None = None
        self.last_error_at: float | None = None  # time.monotonic() stamp
        self.restarts = 0
        self.consecutive_errors = 0
        _M_CONSEC.attach(self, lambda d: d.consecutive_errors)
        _M_ERR_AGE.attach(self, lambda d: d.last_error_age_s() or 0.0)

    # ------------------------------------------------------------- stepping
    def _note_error(self, exc: BaseException) -> None:
        self.errors += 1
        self.consecutive_errors += 1
        self.last_error = repr(exc)
        self.last_error_at = time.monotonic()
        _M_ERRORS.inc()

    def last_error_age_s(self) -> float | None:
        """Seconds since the most recent step error; None when none yet."""
        if self.last_error_at is None:
            return None
        return time.monotonic() - self.last_error_at

    def step(self) -> dict:
        """One deterministic maintenance increment (see module docstring)."""
        with trace("maintenance.step"), self._lock:
            report = {
                "dim_checked": None,
                "vertices_dropped": 0,
                "pages_rewritten": 0,
                "pool_bytes_trimmed": 0,
                "pages_scrubbed": 0,
                "scrub_corrupt": [],
            }
            engine = self.engine
            engine._drain_released()
            dims = engine.index_cache.dims()
            # A degraded (read-only) store never mutates disk: vacuum is
            # skipped, but scrubbing and cache trims still run.
            if dims and not engine.read_only:
                self._cursor %= len(dims)
                dim = dims[self._cursor]
                self._cursor += 1
                report["dim_checked"] = dim
                rep = engine.vacuum(
                    min_dead_fraction=self.dead_fraction, dims=[dim]
                )
                report["vertices_dropped"] = rep["vertices_dropped"]
                report["pages_rewritten"] = rep["pages_rewritten"]
                self.vacuumed_vertices += rep["vertices_dropped"]
                self.pages_rewritten += rep["pages_rewritten"]
                _M_VACUUMED.inc(rep["vertices_dropped"])
            if self.scrub_models > 0:
                srep = engine.scrub(self.scrub_models)
                report["pages_scrubbed"] = srep["scanned"]
                report["scrub_corrupt"] = srep["corrupt"]
                self.pages_scrubbed += srep["scanned"]
                self.corrupt_found += len(srep["corrupt"])
                _M_SCRUBBED.inc(srep["scanned"])
                _M_CORRUPT.inc(len(srep["corrupt"]))
            pool = engine.page_pool
            target = int(pool.budget * self.pool_high_watermark)
            if pool.resident_bytes() > target:
                trimmed = pool.trim(target)
                report["pool_bytes_trimmed"] = trimmed
                self.pool_bytes_trimmed += trimmed
                _M_TRIMMED.inc(trimmed)
            engine.index_cache.trim()
            self.steps += 1
            _M_STEPS.inc()
            return report

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._supervise, name="neurstore-maintenance", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _backoff_s(self) -> float:
        """Current sleep: interval_s doubled per consecutive error, capped."""
        if self.consecutive_errors == 0:
            return self.interval_s
        return min(
            self.interval_s * (2.0 ** self.consecutive_errors),
            self.max_backoff_s,
        )

    def _run(self) -> None:
        while not self._stop.wait(self._backoff_s()):
            try:
                self.step()
                self.consecutive_errors = 0
            except Exception as exc:  # counted, never fatal to the daemon
                self._note_error(exc)

    def _supervise(self) -> None:
        """Restart ``_run`` if it ever escapes — a maintenance thread that
        died silently would look alive from ``stats()`` forever."""
        while not self._stop.is_set():
            try:
                self._run()
            except BaseException as exc:
                self._note_error(exc)
                if self._stop.is_set():
                    return
                self.restarts += 1
                _M_RESTARTS.inc()
                self._stop.wait(self._backoff_s())

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "running": self.running,
            "steps": self.steps,
            "vacuumed_vertices": self.vacuumed_vertices,
            "pages_rewritten": self.pages_rewritten,
            "pool_bytes_trimmed": self.pool_bytes_trimmed,
            "pages_scrubbed": self.pages_scrubbed,
            "corrupt_found": self.corrupt_found,
            "errors": self.errors,
            "last_error": self.last_error,
            "last_error_age_s": self.last_error_age_s(),
            "restarts": self.restarts,
            "consecutive_errors": self.consecutive_errors,
            "backoff_s": self._backoff_s(),
        }
