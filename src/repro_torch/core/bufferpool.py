"""Tensor-page buffer pool — the single path to page bytes (concurrency PR).

A database-style buffer pool over NeurStore's read-only tensor pages: a
fixed byte budget, LRU eviction, pin counts, and per-frame locks. Every
page read in the engine and the loader goes through :meth:`BufferPool.get`,
so N concurrent readers of one model share ONE copy of the page bytes and
ONE decoded copy of each bit-packed payload instead of re-reading and
re-unpacking per handle (the seed behaviour).

Design points (see ``docs/concurrency.md``):

* **Frames are immutable once loaded.** A tensor page is read-only on disk
  (pages are never patched in place — vacuum rewrites are copy-on-write
  under a *new* page name), so ``frame.data`` never changes after the load
  completes and readers need no lock to use it.
* **Pin counts, not borrow checking.** ``get`` returns the frame pinned;
  a pinned frame is never evicted, so a snapshot reader can hold page
  bytes across an arbitrarily long materialization while unrelated reads
  churn the pool. Unpin when done (snapshot release does this).
* **Per-frame read-mostly locks.** The pool lock covers only the frame
  table and byte accounting. Loading a missed page and populating the
  frame's decoded-payload cache happen under the *frame's* lock (or an
  event wait), so a slow page read never blocks hits on other frames.
* **Detached frames.** ``invalidate`` (called when a writer unlinks or
  rewrites a page) removes the frame from the table; if readers still pin
  it, the frame survives *detached* — its bytes stay valid for those
  readers, it no longer counts against the budget, and it is dropped when
  the last pin goes.
* **Budget invariant.** After every operation,
  ``resident_bytes() <= max(budget, pinned_bytes())``: the pool only
  exceeds its budget when pinned frames alone exceed it (it can never
  evict those), and then holds nothing unpinned. The hypothesis property
  test in ``tests/test_bufferpool.py`` drives random op sequences against
  exactly this invariant.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..obs.metrics import default_registry

__all__ = ["BufferPool", "PageFrame"]

# Process-wide pool metrics (docs/observability.md). Counters sum over
# every pool in the process; the byte gauges attach per-pool weakly via
# attach_gauges() (called by the owning engine) so a collected pool
# drops out of the sum.
_REG = default_registry()
_M_HITS = _REG.counter(
    "neurstore_pool_hits_total", "Buffer-pool frame hits."
)
_M_MISSES = _REG.counter(
    "neurstore_pool_misses_total", "Buffer-pool frame misses (page loads)."
)
_M_EVICTIONS = _REG.counter(
    "neurstore_pool_evictions_total", "Buffer-pool frames evicted."
)
_M_DECODED_HITS = _REG.counter(
    "neurstore_pool_decoded_hits_total",
    "Decoded-payload cache hits (shared dequant skipped).",
)
_M_DECODED_MISSES = _REG.counter(
    "neurstore_pool_decoded_misses_total",
    "Decoded-payload cache misses (payload unpacked).",
)
_M_RESIDENT = _REG.gauge(
    "neurstore_pool_resident_bytes",
    "Bytes resident in buffer pools, summed over open pools.",
)
_M_PINNED = _REG.gauge(
    "neurstore_pool_pinned_bytes",
    "Resident bytes pinned by live snapshots, summed over open pools.",
)
_M_BUDGET = _REG.gauge(
    "neurstore_pool_budget_bytes",
    "Buffer-pool byte budget, summed over open pools.",
)


class PageFrame:
    """One resident page: immutable bytes + a shared decoded-payload cache.

    ``data`` is the raw page image (never mutated after load). ``decoded``
    maps ``(record_index, bits)`` to a read-only ndarray of unpacked delta
    codes, shared by every handle over this page version; ``page`` caches
    the parsed header. Both are populated under ``lock`` (read-mostly:
    lookups are lock-free dict reads, inserts take the lock and re-check).
    """

    __slots__ = (
        "key", "data", "size", "extra", "pins", "lock", "decoded", "page",
        "ready", "error", "detached",
    )

    def __init__(self, key: str):
        self.key = key
        self.data: bytes | None = None
        self.size = 0
        self.extra = 0          # decoded-cache bytes accounted on top of data
        self.pins = 0
        self.lock = threading.Lock()
        self.decoded: dict[tuple[int, int | None], object] = {}
        self.page = None        # parsed TensorPage (loader-level cache)
        self.ready = threading.Event()
        self.error: BaseException | None = None
        self.detached = False

    @property
    def nbytes(self) -> int:
        return self.size + self.extra


class BufferPool:
    """Byte-budgeted LRU pool of :class:`PageFrame` objects."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._frames: "OrderedDict[str, PageFrame]" = OrderedDict()
        self._detached: set[PageFrame] = set()
        self._resident = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.decoded_hits = 0
        self.decoded_misses = 0

    def attach_gauges(self) -> None:
        """Sum this pool's byte gauges into the process-wide registry.

        Called by the owning engine (not __init__) so bare pools built by
        unit tests don't pollute the process gauges. Idempotence is not
        required — attach once per pool.
        """
        _M_RESIDENT.attach(self, lambda p: p._resident)
        _M_PINNED.attach(self, lambda p: p.pinned_bytes())
        _M_BUDGET.attach(self, lambda p: p.budget)

    def count_decoded(self, hit: bool) -> None:
        """Decoded-payload cache accounting (called by the loader)."""
        if hit:
            self.decoded_hits += 1
            _M_DECODED_HITS.inc()
        else:
            self.decoded_misses += 1
            _M_DECODED_MISSES.inc()

    # ------------------------------------------------------------------ get
    def get(self, key: str, loader) -> PageFrame:
        """Fetch the frame for ``key``, loading via ``loader()`` on a miss.

        Returns the frame **pinned** — the caller owns one pin and must
        :meth:`unpin` when done. Concurrent getters of the same missing
        key block on the loading frame's event instead of the pool lock,
        so one disk read serves all of them.
        """
        owner = False
        with self._lock:
            frame = self._frames.get(key)
            if frame is not None:
                frame.pins += 1
                self._frames.move_to_end(key)
                self.hits += 1
                _M_HITS.inc()
            else:
                self.misses += 1
                _M_MISSES.inc()
                frame = PageFrame(key)
                frame.pins = 1
                self._frames[key] = frame
                owner = True
        if not owner:
            frame.ready.wait()
            if frame.error is not None:
                self.unpin(frame)
                raise frame.error
            return frame
        try:
            data = loader()
        except BaseException as exc:
            frame.error = exc
            with self._lock:
                frame.pins -= 1
                if self._frames.get(key) is frame:
                    del self._frames[key]
                if frame.pins <= 0 and frame.detached:
                    # An invalidate() raced the failed load (it popped the
                    # frame and parked it as detached): drop it here, or it
                    # would sit in _detached with zero pins forever.
                    self._detached.discard(frame)
            frame.ready.set()
            raise
        with self._lock:
            # size is assigned and accounted in ONE critical section: an
            # invalidate() racing this load pops the frame while its size
            # is still 0, so it can never subtract bytes never added.
            frame.data = data
            frame.size = len(data)
            if self._frames.get(key) is frame:
                self._resident += frame.nbytes
                self._evict_locked(self.budget)
        frame.ready.set()
        return frame

    # ----------------------------------------------------------- pin/unpin
    def pin(self, frame: PageFrame) -> None:
        with self._lock:
            frame.pins += 1

    def unpin(self, frame: PageFrame) -> None:
        with self._lock:
            frame.pins -= 1
            if frame.pins <= 0 and frame.detached:
                self._detached.discard(frame)
            elif frame.pins <= 0:
                # A pinned-over-budget pool shrinks as soon as pins drain.
                self._evict_locked(self.budget)

    # ------------------------------------------------------------- account
    def note_extra(self, frame: PageFrame, nbytes: int) -> None:
        """Account decoded-cache growth on ``frame`` against the budget."""
        with self._lock:
            frame.extra += nbytes
            if not frame.detached and self._frames.get(frame.key) is frame:
                self._resident += nbytes
                self._evict_locked(self.budget)

    def invalidate(self, key: str) -> None:
        """Forget ``key`` (the page was unlinked or rewritten copy-on-write).

        Pinned frames survive detached: their bytes stay valid for the
        snapshot readers holding them, but new ``get`` calls load fresh.
        """
        with self._lock:
            frame = self._frames.pop(key, None)
            if frame is None:
                return
            self._resident -= frame.nbytes
            if frame.pins > 0:
                frame.detached = True
                self._detached.add(frame)

    # ------------------------------------------------------------ eviction
    def _evict_locked(self, target: int) -> None:
        while self._resident > target:
            victim = None
            for f in self._frames.values():  # oldest-first (LRU order)
                if f.pins <= 0 and f.ready.is_set():
                    victim = f
                    break
            if victim is None:
                return  # everything resident is pinned (or still loading)
            del self._frames[victim.key]
            self._resident -= victim.nbytes
            self.evictions += 1
            _M_EVICTIONS.inc()

    def trim(self, target_bytes: int | None = None) -> int:
        """Evict unpinned frames until resident bytes reach ``target_bytes``
        (the budget by default). Returns bytes reclaimed — the maintenance
        daemon calls this on pool pressure."""
        with self._lock:
            before = self._resident
            self._evict_locked(self.budget if target_bytes is None
                               else int(target_bytes))
            return before - self._resident

    # --------------------------------------------------------------- stats
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_locked()

    def _pinned_locked(self) -> int:
        pinned = sum(f.nbytes for f in self._frames.values() if f.pins > 0)
        pinned += sum(f.nbytes for f in self._detached)
        return pinned

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "decoded_hits": self.decoded_hits,
                "decoded_misses": self.decoded_misses,
                "resident": len(self._frames),
                "resident_bytes": self._resident,
                "pinned_bytes": self._pinned_locked(),
                "detached": len(self._detached),
                "budget_bytes": self.budget,
            }
