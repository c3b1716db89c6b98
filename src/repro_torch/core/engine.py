"""NeurStore storage engine (paper §3, §4.1, §4.2 / Algorithm 1).

Components mirroring Figure 3:

* **Index storage** — a pool of HNSW indexes, one per flattened tensor
  length, holding 8-bit quantized base tensors; fronted by a byte-budgeted
  **index cache** with LRU eviction (evicted indexes are serialized to disk
  and reloaded on demand — paper §4.1 "Index Cache", §5 "32 GB default").
* **Delta tensor storage** — read-only tensor pages, one per model, records
  ordered by the model architecture for locality (paper §4.1).
* **Catalog** — the transactional model table (``repro_torch.core.catalog``):
  typed entries, monotonic model ids, vertex reference counts, and a
  write-ahead journal that makes every lifecycle operation atomic.

``save_model`` is Algorithm 1 verbatim: decouple → per-tensor ANN search →
delta encode → SHOULDCOMPRESS(δ) range-vs-τ check → (maybe) new vertex →
adaptive n-bit quantization → page write.

Device: the engine runs its HNSW distance blocks on ``device`` ("cuda" by
default; "cpu" selects the numpy path). The device is handed to every index
the engine creates or reads, and is never written to disk, so a store opens
on either device and in either package.

Save-pipeline hot path (this is the throughput-critical write side):

* tensors are **grouped by flattened dim** so each HNSW index is fetched
  from the cache once per save instead of once per tensor;
* only the index search/insert and catalog mutation run under the global
  lock — delta quantization, planar bit-packing and page assembly happen
  outside it, so concurrent saves overlap their CPU-heavy encode work;
* the index cache tracks a **dirty flag per index**: ``flush()`` (called at
  commit) reserializes only indexes that gained a vertex during this save.

Model lifecycle (this is what makes the engine a catalog, not an archive):

* ``delete_model`` / ``replace_model`` decrement ``vertex_refs``, unlink
  the model's page, and tombstone base vertices whose reference count
  drops to zero (the vertex stays in the graph as a waypoint until vacuum).
* ``vacuum(min_dead_fraction=…)`` compacts each index past the dead-vertex
  threshold: tombstones are dropped from the vertex arrays and adjacency,
  surviving page records are rewritten with the old→new vertex-id remap,
  and the reference table is renumbered — all under one journal
  transaction, so a crash at any point rolls forward or back cleanly.
* Every operation follows the same protocol: journal intent → physical
  side effects → atomic catalog snapshot (the commit point) → cleanup →
  journal commit. ``StorageEngine.__init__`` replays any interrupted
  transaction, leaving no orphan pages and no dangling ``vertex_refs``.
  See ``docs/lifecycle.md`` for the full state machine.

Concurrent read path (this is what lets N readers serve while writers run;
see ``docs/concurrency.md``):

* all page bytes flow through one **buffer pool**
  (``repro_torch.core.bufferpool``): a byte-budgeted LRU of pinned frames whose
  decoded payloads are shared across every handle over a page version;
* ``load_model`` captures an epoch-stamped :class:`ModelSnapshot` (catalog
  entry + pinned page frame + per-dim index references) in one short
  critical section and **never takes the engine lock again** — writers
  bump the epoch at their atomic ``meta.json`` commit point;
* vacuum is **copy-on-write**: it compacts a clone of the index and
  rewrites affected pages under *new* page names, so a reader that opened
  before the vacuum keeps materializing bit-identically from its pinned
  snapshot while later readers see the compacted store;
* a background :class:`~repro_torch.core.maintenance.MaintenanceDaemon` can run
  incremental auto-vacuum and buffer-pool pressure trims off the write
  path (``start_maintenance``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import Counter, OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .bufferpool import BufferPool
from .catalog import (
    STATUS_COMMITTED,
    STATUS_CORRUPT,
    STATUS_PENDING,
    Catalog,
    ModelEntry,
    explain_pack,
    explain_unpack,
    maybe_fail,
)
from .faultfs import FaultFS
from .hnsw import HNSWIndex
from ..kernels.ops import resolve_device
from .integrity import (
    CorruptIndexError,
    CorruptJournalError,
    CorruptMetaError,
    CorruptPageError,
    ReadOnlyStoreError,
    frame_index,
    unframe_index,
)
from .pages import (
    TensorPage,
    TensorRecord,
    encode_payload,
    page_dim_keys,
    read_page_header,
    read_page_refs,
    read_record,
    remap_page_vertices,
    salvage_page_refs,
    verify_page,
    write_page,
)
from .quantize import (
    dequantize_delta,
    dequantize_linear_batch,
    quantize_delta,
    quantize_linear_batch,
)
from ..obs.accounting import ModelSpace, SpaceAccountant, TensorSpace
from ..obs.metrics import default_registry
from ..obs.trace import trace

__all__ = [
    "StorageEngine", "SaveReport", "DEFAULT_TOLERANCE", "DEFAULT_TAU",
    "STATS_SCHEMA_VERSION",
]

# Paper §4.2 Discussion: default p = 2^-24 (below f32 machine epsilon);
# §6.1.3: default similarity threshold tau = 0.16.
DEFAULT_TOLERANCE = 2.0 ** -24
DEFAULT_TAU = 0.16

# Version stamp on StorageEngine.stats(): the documented counters (see
# docs/serving.md) are API — the serving admission policy and StoreStats
# consume them — so layout changes must bump this.
STATS_SCHEMA_VERSION = 1

# Process-wide observability families (docs/observability.md is the
# stability contract for these names). Counters sum over every engine
# open in the process; gauges attach per-engine via weakref callbacks so
# a closed/collected engine drops out of the sum.
_REG = default_registry()
_M_OPS = _REG.counter(
    "neurstore_engine_ops_total",
    "Completed engine operations by type.",
    ("op",),
)
_M_OP_SECONDS = _REG.histogram(
    "neurstore_engine_op_seconds",
    "Engine operation wall time by type.",
    ("op",),
)
_M_PAGE_READS = _REG.counter(
    "neurstore_engine_page_reads_total",
    "Page files read and verified (buffer-pool frame loads).",
)
_M_PAGE_READ_BYTES = _REG.counter(
    "neurstore_engine_page_read_bytes_total",
    "Bytes read from page files.",
)
_M_QUARANTINES = _REG.counter(
    "neurstore_engine_quarantines_total",
    "Models quarantined after failing an integrity check.",
)
_M_MODELS = _REG.gauge(
    "neurstore_engine_models",
    "Committed catalog entries, summed over open engines.",
)
_M_EPOCH = _REG.gauge(
    "neurstore_engine_epoch",
    "Snapshot-isolation epoch, summed over open engines.",
)
_M_SNAPSHOTS_LIVE = _REG.gauge(
    "neurstore_engine_snapshots_live",
    "Live reader snapshots, summed over open engines.",
)
_M_DEDUP_OUTCOMES = _REG.counter(
    "neurstore_dedup_outcomes_total",
    "Save-time dedup decision per stored tensor "
    "(new_base / delta / intra_save_dedup).",
    ("outcome",),
)
_M_DELTA_BITS = _REG.histogram(
    "neurstore_delta_bits",
    "Adaptive delta-quantization bit-width chosen per stored tensor.",
    buckets=tuple(range(0, 33)),  # nbit is an integer in [0, MAX_NBIT]
)
_M_LOGICAL_BYTES = _REG.gauge(
    "neurstore_logical_bytes",
    "Uncompressed float32 bytes of committed models, summed over engines.",
)
_M_PHYSICAL_BYTES = _REG.gauge(
    "neurstore_physical_bytes",
    "Physical bytes (pages + shared base codes), summed over engines.",
)

# Save-probe regime switch (`_probe_dim_group`): brute-force the whole
# (G, N) distance block while the index is small or the group is fat
# relative to it; fall back to per-tensor HNSW descents on a grown index
# so save latency stays O(polylog N). A graph walk evaluates roughly
# ef·m·levels ≈ 512 candidate rows, hence the group factor.
BRUTE_PROBE_MAX_INDEX = 4096
BRUTE_PROBE_GROUP_FACTOR = 512

# A save's per-tensor EXPLAIN is persisted for the first this-many
# tensors only (the full list always rides the SaveReport). It lives in
# a per-model sidecar file (explain/model_<id>.json), written behind the
# save path and never fsynced: folding it into meta.json would make
# EVERY later commit's snapshot serialize+fsync pay for it, and even one
# extra file create per save is visible in the lifecycle benchmark's
# accounting gate — EXPLAIN is advisory, so losing a queued sidecar in a
# crash only degrades model_explain(), never correctness.
EXPLAIN_PERSIST_MAX = 256

# Pending EXPLAIN sidecars are flushed to disk once this many saves have
# queued (and always at close()/vacuum()): bounds queue memory while
# keeping the amortized save-path cost at 1/EXPLAIN_FLUSH_MAX writes.
EXPLAIN_FLUSH_MAX = 128

# Dim groups are probed in chunks of at most this many float64 elements
# (~64 MB for the stacked block), so a save's peak memory stays bounded by
# the chunk and not the whole group. Bases a chunk creates are resident
# before the next chunk probes, so cross-chunk dedup still happens — via
# the index itself instead of an in-memory candidate matrix.
PROBE_CHUNK_ELEMS = 1 << 23

# Threads of a save's quantize stage: each delta's quantization and planar
# bit-packing are numpy sweeps that release the GIL, so a save's tensors
# encode side by side (the records keep the tensors' order, and the page
# its bytes).
ENCODE_WORKERS = min(6, os.cpu_count() or 1)


def _encode_records(jobs: list, p: float) -> list[TensorRecord]:
    """The page record of each ``jobs[i] = (name, shape, dim_key,
    vertex_id, delta)``: its delta quantized at tolerance ``p`` and
    planar-packed, over ``ENCODE_WORKERS`` threads, in the jobs' order.
    Each job is dropped once encoded, releasing its delta."""
    def one(i: int) -> TensorRecord:
        name, shape, dim_key, vid, delta = jobs[i]
        jobs[i] = None
        qd, meta = quantize_delta(delta, p)
        rec = TensorRecord(name=name, shape=shape, dim_key=dim_key, vertex_id=vid,
                           meta=meta, qdelta=qd)
        rec.payload = encode_payload(rec)
        return rec

    with ThreadPoolExecutor(max_workers=ENCODE_WORKERS) as pool:
        return list(pool.map(one, range(len(jobs))))


@dataclasses.dataclass
class SaveReport:
    """Statistics from one ``save_model`` call (feeds the benchmarks)."""

    model_id: int
    name: str
    original_bytes: int
    page_bytes: int
    n_tensors: int
    n_new_bases: int
    n_deltas: int
    nbits: list[int]
    seconds: float
    # Per-tensor EXPLAIN, in tensor order: how Algorithm 1 stored each
    # tensor — {"tensor", "dim", "vertex_id", "outcome", "probe_distance"
    # (squared L2 of the ANN match, None if the index was empty),
    # "delta_range" (the quantity SHOULDCOMPRESS compares), "tau",
    # "nbit", "delta_bytes", "error_bound"}. See docs/observability.md.
    explain: list | None = None

    @property
    def mean_nbit(self) -> float:
        return float(np.mean(self.nbits)) if self.nbits else 0.0

    def to_dict(self) -> dict:
        """JSON-safe form — this IS the wire body of a served save."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SaveReport":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class _Retry(Exception):
    """Internal: snapshot capture raced a writer — retry the loop."""


class _SnapshotRelease:
    """GC-safe snapshot release: appends to the engine's release queue.

    Runs from a ``weakref`` finalizer, possibly inside garbage collection
    on an arbitrary thread — so it must not take any lock. ``deque.append``
    is atomic; the engine drains the queue at its next operation boundary.
    Holds the queue (not the engine) so a dropped engine can still be
    collected.
    """

    __slots__ = ("queue", "token", "frame")

    def __init__(self, queue, token, frame):
        self.queue = queue
        self.token = token
        self.frame = frame

    def __call__(self):
        self.queue.append((self.token, self.frame))


class _IndexCache:
    """LRU cache of deserialized HNSW indexes, bounded by bytes (paper §4.1).

    Tracks a dirty flag per resident index: ``flush()`` writes only indexes
    mutated since their last serialization, and eviction skips the disk
    write for clean indexes that already have an on-disk copy. A save in
    progress **pins** the dims it is mutating so a concurrent load's
    ``get`` can never evict an index out from under the insert loop (a
    detached-but-still-mutating index would silently lose vertices).

    Budget enforcement happens at two points: ``_evict`` (on ``get``)
    spills least-recently-used indexes but always keeps the index being
    handed to the caller resident, and ``trim`` (called by the engine at
    commit boundaries, when no handle is outstanding) may spill *every*
    unpinned index — including a single resident index larger than the
    whole budget, which ``_evict`` alone could never reclaim.
    """

    def __init__(self, root: str, budget_bytes: int, fs: FaultFS | None = None,
                 device="cuda"):
        self.root = root
        self.budget = budget_bytes
        self.fs = fs if fs is not None else FaultFS()
        self.device = device
        self._live: OrderedDict[int, HNSWIndex] = OrderedDict()
        self._dirty: set[int] = set()
        self._pins: dict[int, int] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.dirty_flushes = 0

    def _path(self, dim: int) -> str:
        return os.path.join(self.root, f"hnsw_{dim}.idx")

    def get(self, dim: int, create: bool = False) -> HNSWIndex | None:
        with self._lock:
            if dim in self._live:
                self._live.move_to_end(dim)
                self.hits += 1
                return self._live[dim]
            path = self._path(dim)
            if os.path.exists(path):
                self.misses += 1
                idx = self._read(path)
            elif create:
                # A fresh index is still a miss: nothing resident served it.
                self.misses += 1
                idx = HNSWIndex(dim, device=self.device)
            else:
                return None
            self._live[dim] = idx
            self._evict()
            return idx

    def mark_dirty(self, dim: int) -> None:
        """Record that the resident index for ``dim`` was mutated."""
        with self._lock:
            self._dirty.add(dim)

    def mark_clean(self, dim: int) -> None:
        """Resident index already matches disk (e.g. vacuum just wrote it)."""
        with self._lock:
            self._dirty.discard(dim)

    def drop(self, dim: int) -> None:
        """Discard a resident index without writing it (failed mutation)."""
        with self._lock:
            self._live.pop(dim, None)
            self._dirty.discard(dim)

    def pin(self, dim: int) -> None:
        """Exempt ``dim`` from eviction while a save mutates it."""
        with self._lock:
            self._pins[dim] = self._pins.get(dim, 0) + 1

    def unpin(self, dim: int) -> None:
        with self._lock:
            n = self._pins.get(dim, 0) - 1
            if n > 0:
                self._pins[dim] = n
            else:
                self._pins.pop(dim, None)

    def _read(self, path: str) -> HNSWIndex:
        """Load an index file, verifying its frame CRC before unpickling.

        A flipped bit in a pickle can deserialize into silently wrong
        vertex codes — the worst failure mode, since every delta decodes
        against a wrong base — so the payload is checksum-verified first
        (:func:`~repro_torch.core.integrity.unframe_index`); legacy unframed
        files get their parse errors wrapped as :class:`CorruptIndexError`.
        """
        payload = unframe_index(self.fs.read_bytes(path, site="index.read"), path)
        try:
            return HNSWIndex.from_bytes(payload, device=self.device)
        except Exception as exc:
            raise CorruptIndexError(f"{path}: does not parse: {exc!r}") from exc

    def _write(self, dim: int, idx: HNSWIndex) -> None:
        # fsync: the save protocol commits the catalog only after vertices
        # are durable — a page must never reference a vertex the index
        # file could lose in a power cut.
        self.fs.write_durable(
            self._path(dim), frame_index(idx.to_bytes()), site="index.write"
        )

    def _evict(self) -> None:
        while len(self._live) > 1 and self.resident_bytes() > self.budget:
            newest = next(reversed(self._live))  # being handed to a caller
            victim = next(
                (d for d in self._live if d not in self._pins and d != newest),
                None,
            )
            if victim is None:
                return  # everything else resident is pinned by in-flight saves
            idx = self._live.pop(victim)
            self.evictions += 1
            if victim in self._dirty or not os.path.exists(self._path(victim)):
                self._write(victim, idx)
                self._dirty.discard(victim)

    def trim(self) -> None:
        """Enforce the byte budget with no outstanding handle (commit time).

        Unlike ``_evict`` this may spill the sole resident index, closing
        the gap where one index larger than the entire budget stayed
        resident forever and its bytes were never reclaimed.
        """
        with self._lock:
            while self._live and self.resident_bytes() > self.budget:
                victim = next((d for d in self._live if d not in self._pins), None)
                if victim is None:
                    return
                idx = self._live.pop(victim)
                self.evictions += 1
                if victim in self._dirty or not os.path.exists(self._path(victim)):
                    self._write(victim, idx)
                    self._dirty.discard(victim)

    def resident_bytes(self) -> int:
        return sum(i.nbytes for i in self._live.values())

    def flush(self) -> None:
        """Serialize mutated resident indexes only (dirty-aware)."""
        with self._lock:
            for dim, idx in self._live.items():
                if dim in self._dirty or not os.path.exists(self._path(dim)):
                    self._write(dim, idx)
                    self.dirty_flushes += 1
            self._dirty.clear()

    def replace(self, dim: int, idx: HNSWIndex) -> None:
        """Install ``idx`` as the resident index for ``dim`` (clean).

        Copy-on-write vacuum compacts a clone and swaps it in here; the
        previous object stays alive for the snapshots that captured it.
        The clone was just written to disk, so it installs clean.
        """
        with self._lock:
            self._live[dim] = idx
            self._live.move_to_end(dim)
            self._dirty.discard(dim)

    def stats(self) -> dict:
        """Cache counters for the benchmarks (hnsw_bench reports these)."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "dirty_flushes": self.dirty_flushes,
                "resident": len(self._live),
                "dirty": len(self._dirty),
            }

    def dims(self) -> list[int]:
        with self._lock:
            on_disk = {
                int(f[len("hnsw_"):-len(".idx")])
                for f in os.listdir(self.root)
                if f.startswith("hnsw_") and f.endswith(".idx")
            }
            return sorted(on_disk | set(self._live))


class StorageEngine:
    """The NeurStore tensor-based storage engine."""

    def __init__(
        self,
        root: str,
        tolerance: float = DEFAULT_TOLERANCE,
        tau: float = DEFAULT_TAU,
        cache_bytes: int = 32 << 30,
        ef_search: int = 32,
        pool_bytes: int = 1 << 30,
        auto_maintenance: bool = False,
        fs: FaultFS | None = None,
        checksums: bool = True,
        accounting: bool = True,
        device="cuda",
    ):
        # Resolved first: without CUDA the default raises before the store
        # directory is touched (only an explicit device="cpu" runs there).
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(os.path.join(root, "pages"), exist_ok=True)
        os.makedirs(os.path.join(root, "index"), exist_ok=True)
        os.makedirs(os.path.join(root, "explain"), exist_ok=True)
        self.tolerance = tolerance
        self.tau = tau
        self.ef_search = ef_search
        # All file access routes through one FaultFS shim so tests can
        # inject EIO / torn writes / bit flips / crash-at-fsync at any
        # individual I/O call; checksums=False skips page CRC compute +
        # verify (the durability benchmark's baseline mode).
        self.fs = fs if fs is not None else FaultFS()
        self.checksums = checksums
        # Incremental space accounting (docs/observability.md): the
        # ledger is updated at every commit point and reseeded by a full
        # rescan at open and after vacuum (which renumbers vertex ids).
        # accounting=False skips ledger maintenance and catalog EXPLAIN
        # persistence (SaveReport.explain is still produced) — the
        # lifecycle benchmark prices the difference.
        self.accounting = accounting
        self._accountant = SpaceAccountant()
        # Write-behind queue for EXPLAIN sidecars: model_id → bounded
        # explain slice, flushed to explain/model_<id>.json on close(),
        # vacuum(), or when EXPLAIN_FLUSH_MAX saves are pending. The
        # sidecar is advisory, so deferring it keeps its (measurable)
        # file-create cost out of the save path entirely; a crash loses
        # at most the queued tail, never ledger or model state.
        self._pending_explains: dict[int, list] = {}
        # Degraded read-only mode: set when the journal body or meta.json
        # is corrupt — serving the last good state is safe, mutating on
        # top of it is not.
        self.read_only = False
        self.degraded_reason: str | None = None
        self._corrupt_reasons: dict[str, str] = {}
        self._scrub_cursor = 0
        self.index_cache = _IndexCache(
            os.path.join(root, "index"), cache_bytes, fs=self.fs,
            device=self.device,
        )
        # Single path to page bytes: every load shares frames (and decoded
        # payloads) here instead of re-reading files per handle.
        self.page_pool = BufferPool(pool_bytes)
        self.catalog = Catalog(root, fs=self.fs)
        if self.catalog.meta_fallback is not None:
            self._degrade(f"meta.json corrupt, serving last good snapshot "
                          f"({self.catalog.meta_fallback})")
        # (dim, vid) refs held by saves between ANN match and commit: keeps
        # a concurrent delete/vacuum from tombstoning a base an in-flight
        # page is about to reference.
        self._inflight: Counter = Counter()
        # Live reader snapshots: token → epoch. Handles release through
        # _released (a GC-safe queue drained at operation boundaries), so
        # stats() can report the oldest live snapshot and the pool can
        # unpin frames promptly.
        self._live_snapshots: dict[int, int] = {}
        self._snap_token = 0
        self._released: deque = deque()  # (token, frame) — append is atomic
        # Dims whose vacuum failed in-process (not a crash): the on-disk
        # index/pages/refs may be half-switched, so further use of the dim
        # must fail loudly until a reopen replays the journal.
        self._quarantined_dims: set[int] = set()
        # Optional save-commit veto hook (the serving layer's quota
        # enforcement point). Called under the engine lock, immediately
        # before a save's journal intent, with a list of
        # ``{"name", "page_bytes", "old_page_bytes"}`` dicts — one per
        # model in the transaction. Raising aborts the save before any
        # durable side effect is journaled (vertices already inserted in
        # phase 1 become unreferenced and are swept by vacuum, the same
        # contract as a crashed save). The hook must not invoke engine
        # write operations; read-only catalog access is safe (RLock).
        self.commit_gate = None
        self._lock = threading.RLock()
        self.maintenance = None
        self._recover()
        if self.accounting:
            self._accountant.reset(self._scan_model_spaces())
        # Gauge callbacks receive the engine weakly (no closure over
        # self): an engine that goes away stops being summed.
        _M_MODELS.attach(self, lambda e: len(e.catalog.state.models))
        _M_EPOCH.attach(self, lambda e: e.catalog.state.epoch)
        _M_SNAPSHOTS_LIVE.attach(self, lambda e: len(e._live_snapshots))
        _M_LOGICAL_BYTES.attach(
            self, lambda e: e._accountant.totals(e.catalog.ref_count)[0])
        _M_PHYSICAL_BYTES.attach(
            self, lambda e: e._accountant.totals(e.catalog.ref_count)[1])
        self.page_pool.attach_gauges()
        if auto_maintenance:
            self.start_maintenance()

    # --------------------------------------------------------------- helpers
    @property
    def _meta(self) -> dict:
        """Legacy read-only view of the catalog (pre-catalog dict format)."""
        return self.catalog.snapshot_dict()

    def _degrade(self, reason: str) -> None:
        """Enter read-only mode: loads keep serving, writes fail typed."""
        self.read_only = True
        if self.degraded_reason is None:
            self.degraded_reason = reason

    def _check_writable(self) -> None:
        if self.read_only:
            raise ReadOnlyStoreError(
                f"store is read-only: {self.degraded_reason}"
            )

    def _page_file(self, page_name: str) -> str:
        return os.path.join(self.root, "pages", page_name)

    def _page_path(self, model_id: int) -> str:
        return self._page_file(f"model_{model_id}.page")

    def _explain_file(self, model_id: int) -> str:
        return os.path.join(self.root, "explain", f"model_{model_id}.json")

    def _write_explain_sidecar(self, model_id: int, explain: list) -> None:
        """Persist the bounded EXPLAIN slice beside the catalog (packed
        rows, see ``catalog.EXPLAIN_FIELDS``). One plain write, no fsync
        — EXPLAIN is advisory, and an injected/real I/O error must never
        fail the already-committed save it annotates."""
        rows = explain_pack(explain[:EXPLAIN_PERSIST_MAX])
        data = json.dumps(rows).encode("utf-8")
        try:
            with self.fs.open(
                self._explain_file(model_id), "wb", site="explain.write"
            ) as f:
                f.write(data)
        except OSError:
            pass

    def flush_explains(self) -> int:
        """Drain the EXPLAIN write-behind queue to sidecar files.

        Runs automatically at close(), vacuum(), and every
        EXPLAIN_FLUSH_MAX queued saves; callers that need sidecars on
        disk *now* (e.g. before handing the store directory to another
        process) may invoke it directly. Returns the number flushed."""
        with self._lock:
            pending, self._pending_explains = self._pending_explains, {}
        for model_id, explain in pending.items():
            self._write_explain_sidecar(model_id, explain)
        return len(pending)

    def _load_explain_sidecar(self, model_id: int) -> list | None:
        """Read a model's persisted EXPLAIN rows back into dict form.
        None when absent/unreadable (pre-EXPLAIN stores, accounting-off
        saves, or a crash that outran the advisory write)."""
        try:
            rows = json.loads(self.fs.read_bytes(
                self._explain_file(model_id), site="explain.read"))
            if not isinstance(rows, list):
                return None
            return explain_unpack(rows)
        except (OSError, ValueError, TypeError):
            return None

    def _page_size(self, entry: ModelEntry | None) -> int:
        """On-disk bytes of an entry's page (0 when absent/unreadable)."""
        if entry is None:
            return 0
        try:
            return os.path.getsize(self._page_file(entry.page))
        except OSError:
            return 0

    def _unlink(self, path: str) -> None:
        try:
            self.fs.unlink(path, site="unlink")
        except FileNotFoundError:
            pass

    def _page_refs(self, page_name: str, strict: bool = False) -> Counter:
        """(dim, vertex_id) → count of records in a page (empty if missing).

        Header-only scan (``read_page_refs``): lifecycle ops run this under
        the engine lock, so it must not read whole page payloads. On a
        damaged page (unless ``strict``) it falls back to salvaging refs
        from records whose CRCs still verify — under-counting only *leaks*
        references (fsck rebuilds them); it never frees a base a surviving
        record depends on.
        """
        path = self._page_file(page_name)
        refs: Counter = Counter()
        if not os.path.exists(path):
            return refs
        try:
            with self.fs.open(path, "rb", site="page.refs") as f:
                for dim, vid in read_page_refs(f):
                    refs[(dim, vid)] += 1
        except CorruptPageError:
            if strict:
                raise
            refs = Counter()
            try:
                buf = self.fs.read_bytes(path, site="page.refs")
            except OSError:
                return refs
            for dim, vid in salvage_page_refs(buf):
                refs[(dim, vid)] += 1
        except OSError:
            if strict:
                raise
            return Counter()
        return refs

    def _check_quarantine(self, dim: int) -> None:
        if dim in self._quarantined_dims:
            raise RuntimeError(
                f"dim {dim} has a half-applied vacuum (in-process failure); "
                "reopen the engine to replay the journal"
            )

    def _tombstone_unreferenced(self, pairs) -> None:
        """Tombstone vertices from ``pairs`` with zero live references."""
        by_dim: dict[int, list[int]] = {}
        for dim, vid in pairs:
            if (
                self.catalog.ref_count(dim, vid) <= 0
                and self._inflight.get((dim, vid), 0) <= 0
            ):
                by_dim.setdefault(dim, []).append(vid)
        for dim, vids in by_dim.items():
            try:
                idx = self.index_cache.get(dim)
            except CorruptIndexError:
                # Nothing sound to tombstone in a corrupt index; fsck
                # removes/rebuilds the file once nothing references it.
                continue
            if idx is None:
                continue
            changed = False
            for vid in vids:
                # A crash can leave intents naming vertices that were never
                # flushed; skip ids past the durable end of the index.
                if 0 <= vid < len(idx) and not idx.is_deleted(vid):
                    idx.mark_deleted(vid)
                    changed = True
            if changed:
                self.index_cache.mark_dirty(dim)

    # --------------------------------------------------------------- recovery
    def _recover(self) -> None:
        """Replay the catalog journal: roll interrupted operations forward
        (catalog snapshot already switched) or back (snapshot untouched).

        Skipped entirely in degraded mode: replaying intents against a
        fallback (possibly stale) snapshot could roll back transactions
        that actually committed — read-only means *no* disk mutation.
        A corrupt journal body (damage before a valid record) likewise
        degrades instead of replaying guesses.
        """
        if self.read_only:
            return
        try:
            pending = self.catalog.recover_journal()
        except CorruptJournalError as exc:
            self._degrade(f"journal corrupt, replay skipped ({exc})")
            return
        dirty = self._drop_pending_entries()
        for group in pending:
            head = group[0]
            op = head.get("op")
            if op in ("save", "replace"):
                self._recover_put(head)
            elif op == "save_batch":
                self._recover_save_batch(head)
            elif op == "delete":
                self._recover_delete(head)
            elif op == "vacuum":
                switch = next(
                    (r for r in group if r.get("op") == "vacuum_switch"), None
                )
                if switch is None:
                    self._recover_vacuum_rollback(head)
                else:
                    self._recover_vacuum_forward(switch)
            dirty = True
        if dirty:
            self.index_cache.flush()
            self.catalog.save_snapshot()
        if pending:
            self.catalog.truncate_journal()
        self._sweep_orphan_pages()

    def _sweep_orphan_pages(self) -> None:
        """Unlink page files no committed entry references (post-replay the
        journal is empty, so anything unreferenced is dead weight: garbage
        from torn writes, or ``.vac`` side files a rollback left behind).
        EXPLAIN sidecars of dead model ids go the same way — theirs is the
        one gap the unlink-on-delete protocol can leave (a crash between a
        delete's commit point and its cleanup)."""
        pages_dir = os.path.join(self.root, "pages")
        referenced = {
            self.catalog.state.models[n].page for n in self.catalog.state.models
        }
        for fname in os.listdir(pages_dir):
            if fname in referenced:
                continue
            if fname.endswith(".vac") or (
                fname.startswith("model_") and fname.endswith(".page")
            ):
                self._unlink(os.path.join(pages_dir, fname))
        live_ids = {
            f"model_{self.catalog.state.models[n].model_id}.json"
            for n in self.catalog.state.models
        }
        explain_dir = os.path.join(self.root, "explain")
        for fname in os.listdir(explain_dir):
            if fname not in live_ids:
                self._unlink(os.path.join(explain_dir, fname))

    def _drop_pending_entries(self) -> bool:
        """Defensive sweep: a snapshot should never hold non-committed
        entries; if one appears (torn external edit), roll it back."""
        changed = False
        for name in list(self.catalog.state.models):
            entry = self.catalog.state.models[name]
            if entry.status != STATUS_PENDING:
                # Committed entries are fine; quarantined (corrupt) entries
                # must survive reopen so the damage stays visible until
                # repaired or explicitly dropped.
                continue
            refs = self._page_refs(entry.page)
            del self.catalog.state.models[name]
            for (dim, vid), c in refs.items():
                self.catalog.ref(dim, vid, -c)
            self._tombstone_unreferenced(refs)
            self._unlink(self._page_file(entry.page))
            changed = True
        return changed

    def _recover_put(self, rec: dict) -> None:
        entry = self.catalog.get(rec["name"])
        if entry is not None and entry.model_id == rec["id"]:
            # Snapshot switched before the crash: the save committed. For a
            # replace, finish dropping the old version's remains.
            if rec["op"] == "replace":
                old_refs = [(int(d), int(v)) for d, v, _c in rec.get("old_refs", [])]
                self._tombstone_unreferenced(old_refs)
                if rec.get("old_page"):
                    self._unlink(self._page_file(rec["old_page"]))
            return
        # Snapshot never switched: undo the physical side effects.
        self._unlink(self._page_file(rec["page"]))
        new_pairs = [(int(d), int(v)) for d, v in rec.get("new_vertices", [])]
        self._tombstone_unreferenced(new_pairs)

    def _recover_save_batch(self, rec: dict) -> None:
        """Replay an interrupted ``save_models``: all-or-nothing.

        The snapshot replace is the single commit point for every model in
        the batch, so checking any one member tells the whole story: if its
        entry is present with the batch's model id the batch committed
        (finish dropping replaced versions' remains), otherwise none of it
        did (undo every page and every vertex the batch created).
        """
        models = rec.get("models", [])
        if not models:
            return
        head = models[0]
        entry = self.catalog.get(head["name"])
        if entry is not None and entry.model_id == head["id"]:
            for m in models:
                if m.get("old_page"):
                    old_refs = [
                        (int(d), int(v)) for d, v, _c in m.get("old_refs", [])
                    ]
                    self._tombstone_unreferenced(old_refs)
                    self._unlink(self._page_file(m["old_page"]))
            return
        for m in models:
            self._unlink(self._page_file(m["page"]))
        new_pairs = [(int(d), int(v)) for d, v in rec.get("new_vertices", [])]
        self._tombstone_unreferenced(new_pairs)

    def _recover_delete(self, rec: dict) -> None:
        entry = self.catalog.get(rec["name"])
        if entry is not None and entry.model_id == rec["id"]:
            return  # intent never committed — the model is untouched
        refs = [(int(d), int(v)) for d, v, _c in rec.get("refs", [])]
        self._tombstone_unreferenced(refs)
        self._unlink(self._page_file(rec["page"]))

    def _recover_vacuum_rollback(self, rec: dict) -> None:
        """No switch record: side files may be half-written, catalog is
        untouched — discard the ``.vac`` index (new-named page side files
        are unreferenced and fall to the orphan sweep)."""
        dim = rec["dim"]
        self._unlink(self.index_cache._path(dim) + ".vac")
        for page_name in rec.get("pages", []):
            # Legacy in-place protocol (pre-concurrency stores) staged
            # page rewrites as ``.vac`` side files under the same name.
            self._unlink(self._page_file(page_name) + ".vac")

    def _recover_vacuum_forward(self, switch: dict) -> None:
        """Switch record present: every side file was durable before it,
        so roll forward — re-point entries at the rewritten pages (a crash
        before the snapshot switch leaves them on the old names), install
        the compacted index, drop the old pages, replace the dim's refs
        wholesale (idempotent)."""
        dim = switch["dim"]
        # An earlier replay step may have loaded the pre-compaction index
        # into the cache (and marked it dirty); drop it so the final flush
        # cannot clobber the compacted file we are about to install.
        self.index_cache.drop(dim)
        vac = self.index_cache._path(dim) + ".vac"
        if os.path.exists(vac):
            self.fs.replace(vac, self.index_cache._path(dim),
                            site="index.replace")
        for name, old_page, new_page in switch.get("moves", []):
            entry = self.catalog.get(name)
            if entry is not None and entry.page == old_page:
                entry.page = new_page
            self._unlink(self._page_file(old_page))
        for page_name in switch.get("pages", []):
            # Legacy in-place protocol: swap the same-name side files in.
            pvac = self._page_file(page_name) + ".vac"
            if os.path.exists(pvac):
                self.fs.replace(pvac, self._page_file(page_name),
                                site="page.replace")
        self.catalog.set_dim_refs(
            dim, {int(v): int(c) for v, c in switch.get("refs", {}).items()}
        )

    # ----------------------------------------------------------- save (Alg 1)
    @staticmethod
    def _iter_group_chunks(positions: list, dim: int):
        """Split one dim group into probe chunks of bounded element count,
        so the (chunk, dim) float64 stack — and every intermediate
        ``_probe_dim_group`` builds from it — stays ~PROBE_CHUNK_ELEMS
        regardless of how many tensors share the dim."""
        step = max(1, PROBE_CHUNK_ELEMS // max(dim, 1))
        for i in range(0, len(positions), step):
            yield positions[i:i + step]

    def _probe_dim_group(
        self, index: HNSWIndex, flats: np.ndarray, tau_: float
    ) -> tuple[list[tuple[int, np.ndarray]], list[int], list[dict]]:
        """Batched Algorithm 1 lines 2–3 for one dim group (engine lock held).

        ``flats`` is the (G, dim) float64 block of every tensor in the
        group. Instead of G independent HNSW descents, one
        ``nearest_live_batch`` distance block (through the kernel dispatch
        seam) finds each tensor's closest live base; tensors whose delta
        range beats tau are quantized in **one** ``quantize_linear_batch``
        sweep (the per-group hoist — bit-exact with per-tensor
        ``quantize_linear``, see tests), checked against earlier in-group
        bases so intra-save dedup matches the sequential path (a tensor
        similar to a base created moments earlier in the same save becomes
        a delta, not a second base), and inserted via ``insert_batch``.

        Returns ``(bases, new_vids, explains)``: ``bases[j] =
        (vertex_id, delta)`` in group order, ``new_vids`` the vertex ids
        created, and ``explains[j]`` the per-tensor EXPLAIN skeleton —
        ``{"vertex_id", "outcome", "probe_distance", "delta_range"}`` —
        that the quantize phase completes. Callers bound ``flats`` to
        ``PROBE_CHUNK_ELEMS`` (see ``_iter_group_chunks``); the
        intermediates here are all O(chunk).
        """
        g = flats.shape[0]
        bases: list = [None] * g
        explains: list = [None] * g
        best_vid = np.full(g, -1, dtype=np.int64)
        best_dist = np.full(g, np.inf)
        if len(index):
            # Small index or fat group: one exact (G, N) distance block
            # beats G graph descents. Large index with a thin group: keep
            # the O(polylog N) HNSW descent per tensor — a brute-force
            # scan there would make save latency grow linearly with the
            # store.
            if (
                len(index) <= BRUTE_PROBE_MAX_INDEX
                or g * BRUTE_PROBE_GROUP_FACTOR >= len(index)
            ):
                best_vid, best_dist = index.nearest_live_batch(flats)
            else:
                for j in range(g):
                    hit = index.search(flats[j], k=1, ef=self.ef_search)
                    if hit:
                        best_dist[j], best_vid[j] = hit[0]
        deq_cache: dict[int, np.ndarray] = {}
        cand_pos: list[int] = []
        for j in range(g):
            vid = int(best_vid[j])
            dist = (
                float(best_dist[j])
                if vid >= 0 and np.isfinite(best_dist[j]) else None
            )
            if vid >= 0:
                base = deq_cache.get(vid)
                if base is None:
                    base = deq_cache[vid] = index.dequantize_vertex(vid)
                delta = flats[j] - base
                rng = float(delta.max() - delta.min())
                # SHOULDCOMPRESS: delta range vs tau (§4.2).
                if rng <= tau_:
                    bases[j] = (vid, delta)
                    explains[j] = {
                        "vertex_id": vid, "outcome": "delta",
                        "probe_distance": dist, "delta_range": rng,
                    }
                    continue
            cand_pos.append(j)
            explains[j] = {"probe_distance": dist}  # completed below
        if not cand_pos:
            return bases, [], explains
        cand = flats[cand_pos]
        qc, qs, qz, qm = quantize_linear_batch(cand, nbit=8)
        deq = dequantize_linear_batch(qc, qs, qz, qm)
        accepted: list[int] = []  # local candidate indices → new bases
        batch_refs: list[int] = []  # group positions resolved after insert
        acc_mat = np.empty_like(cand)  # dequantized accepted bases, in order
        for local_j, j in enumerate(cand_pos):
            flat = flats[j]
            if accepted:
                diff = acc_mat[: len(accepted)] - flat
                k = int(np.argmin(np.einsum("ad,ad->a", diff, diff)))
                delta = flat - acc_mat[k]
                rng = float(delta.max() - delta.min())
                if rng <= tau_:
                    bases[j] = (k, delta)  # k resolved to a vid below
                    batch_refs.append(j)
                    explains[j].update(
                        outcome="intra_save_dedup", delta_range=rng)
                    continue
            acc_mat[len(accepted)] = deq[local_j]
            delta = flats[j] - deq[local_j]
            bases[j] = (len(accepted), delta)
            batch_refs.append(j)
            accepted.append(local_j)
            explains[j].update(
                outcome="new_base",
                delta_range=float(delta.max() - delta.min()),
            )
        sel = np.asarray(accepted, dtype=np.int64)
        vids = index.insert_batch(
            cand[sel], quantized=(qc[sel], qs[sel], qz[sel], qm[sel])
        )
        for j in batch_refs:
            k, delta = bases[j]
            bases[j] = (vids[k], delta)
            explains[j]["vertex_id"] = int(vids[k])
        return bases, vids, explains

    def _account_committed_save(
        self, name: str, model_id: int, page_name: str, page_bytes: int,
        logical_bytes: int, tensors: tuple, explain: list,
    ) -> None:
        """Post-commit bookkeeping for one saved model: push the space
        facts into the ledger (replace-by-name covers ``replace_model``),
        persist the EXPLAIN sidecar, and publish the dedup-outcome /
        bit-width metric families."""
        if self.accounting:
            self._accountant.record_save(ModelSpace(
                name=name,
                page=page_name,
                page_bytes=page_bytes,
                logical_bytes=logical_bytes,
                tensors=tensors,
            ))
            self._pending_explains[model_id] = explain[:EXPLAIN_PERSIST_MAX]
            if len(self._pending_explains) >= EXPLAIN_FLUSH_MAX:
                self.flush_explains()
        for ex in explain:
            _M_DEDUP_OUTCOMES.labels(ex["outcome"]).inc()
            _M_DELTA_BITS.observe(ex["nbit"])

    def save_model(
        self,
        name: str,
        architecture: dict,
        tensors: "OrderedDict[str, np.ndarray] | dict[str, np.ndarray]",
        tolerance: float | None = None,
        tau: float | None = None,
    ) -> SaveReport:
        """Algorithm 1: delta-quantize ``tensors`` and persist one page.

        ``tensors`` is name → float array, iterated in architecture order so
        records land in page order matching the computation graph (paper
        §4.1 "delta tensors are organized in the order defined by the model
        architecture").

        The index work is grouped by flattened dim (one cache fetch per
        index) and runs under the engine lock; the CPU-heavy delta
        quantization + planar bit-packing run after the lock is released.
        Page records keep the original tensor order regardless of grouping.

        Saving under an existing name is a **replace**: the new version is
        written first, then the old page and its vertex references are
        dropped, all under one journal transaction.
        """
        with trace("engine.save", model=name) as op:
            report = self._save_model_impl(
                name, architecture, tensors, tolerance, tau, op
            )
        _M_OPS.labels("save").inc()
        _M_OP_SECONDS.labels("save").observe(op.elapsed())
        return report

    def _save_model_impl(
        self,
        name: str,
        architecture: dict,
        tensors,
        tolerance: float | None,
        tau: float | None,
        op,
    ) -> SaveReport:
        # `op` is the open engine.save span: SaveReport.seconds is derived
        # from it, so wall time in the report and the trace cannot differ.
        self._check_writable()
        self._drain_released()
        p = self.tolerance if tolerance is None else tolerance
        tau_ = self.tau if tau is None else tau
        # Grouping needs only names/shapes — no float64 upcast is made here.
        items: list[tuple[str, tuple[int, ...], object]] = []
        by_dim: "OrderedDict[int, list[int]]" = OrderedDict()
        original_bytes = 0
        for tname, tensor in tensors.items():
            src = np.asarray(tensor)
            original_bytes += src.size * 4  # stored models are float32
            by_dim.setdefault(src.size, []).append(len(items))
            items.append((tname, tuple(int(s) for s in src.shape), src))

        # Phase 1 (locked): per-dim batched ANN probe / batch vertex insert
        # (Alg. 1 l.2-3 through `_probe_dim_group`): one distance block +
        # one quantization sweep + one `insert_batch` per dim instead of
        # per-tensor graph probes. Dims are pinned so a concurrent load's
        # cache fetch cannot evict an index this save is mutating. The
        # float64 upcast now lives per *group* (the batch paths need the
        # (G, dim) block), released as each group resolves.
        bases: list[tuple[int, np.ndarray] | None] = [None] * len(items)
        probe_ex: list[dict | None] = [None] * len(items)
        refs: Counter = Counter()
        new_vertices: list[tuple[int, int]] = []
        n_new = 0
        try:
            for dim in by_dim:
                self.index_cache.pin(dim)
            try:
                with trace("probe", n_dims=len(by_dim)), self._lock:
                    for dim, positions in by_dim.items():
                        self._check_quarantine(dim)
                        index = self.index_cache.get(dim, create=True)
                        for chunk in self._iter_group_chunks(positions, dim):
                            flats = np.stack([
                                np.asarray(items[pos][2],
                                           dtype=np.float64).ravel()
                                for pos in chunk
                            ])
                            group_bases, group_new, group_ex = (
                                self._probe_dim_group(index, flats, tau_)
                            )
                            if group_new:
                                self.index_cache.mark_dirty(dim)
                                new_vertices.extend(
                                    (dim, v) for v in group_new
                                )
                                n_new += len(group_new)
                            for gj, pos in enumerate(chunk):
                                vid, delta = group_bases[gj]
                                bases[pos] = (vid, delta)
                                probe_ex[pos] = group_ex[gj]
                                refs[(dim, vid)] += 1
                                # Hold the ref until commit so a concurrent
                                # delete cannot tombstone this base under
                                # the page.
                                self._inflight[(dim, vid)] += 1
            finally:
                for dim in by_dim:
                    self.index_cache.unpin(dim)

            # Phase 2 (unlocked): adaptive n-bit quantization of each delta
            # (Eq. 2/3) + planar bit-packing + page assembly, in tensor
            # order. Deltas are released as they are consumed.
            nbits: list[int] = []
            explain: list[dict] = []
            with trace("quantize", n_tensors=len(items)):
                jobs = [(tname, shape, src.size, *bases[i])
                        for i, (tname, shape, src) in enumerate(items)]
                bases = None
                records = _encode_records(jobs, p)
                for i, rec in enumerate(records):
                    nbits.append(rec.meta.nbit)
                    ex = probe_ex[i]
                    explain.append({
                        "tensor": rec.name,
                        "dim": int(rec.dim_key),
                        "vertex_id": int(ex["vertex_id"]),
                        "outcome": ex["outcome"],
                        "probe_distance": ex["probe_distance"],
                        "delta_range": ex["delta_range"],
                        "tau": float(tau_),
                        "nbit": int(rec.meta.nbit),
                        "delta_bytes": len(rec.payload),
                        "error_bound": float(p),
                    })
            with trace("pack"):
                page = write_page(records, checksums=self.checksums)

            # Phase 3 (locked): the journaled commit. Intent → index flush
            # (vertices durable before the page references them) → page
            # write → atomic catalog snapshot (commit point) → old-version
            # cleanup → journal commit. The span opens before the lock so
            # lock-wait time is attributed to the commit.
            with trace("commit"), self._lock:
                old = self.catalog.get(name)
                old_refs = self._page_refs(old.page) if old else Counter()
                if self.commit_gate is not None:
                    self.commit_gate([{
                        "name": name,
                        "page_bytes": len(page),
                        "old_page_bytes": self._page_size(old),
                    }])
                model_id = self.catalog.allocate_id()
                page_name = f"model_{model_id}.page"
                intent = {
                    "op": "replace" if old else "save",
                    "name": name,
                    "id": model_id,
                    "page": page_name,
                    "new_vertices": [[d, v] for d, v in new_vertices],
                }
                if old:
                    intent["old_id"] = old.model_id
                    intent["old_page"] = old.page
                    intent["old_refs"] = [
                        [d, v, c] for (d, v), c in old_refs.items()
                    ]
                with trace("journal"):
                    tx = self.catalog.begin(intent)
                maybe_fail("save.after_intent")
                self.index_cache.flush()
                maybe_fail("save.after_index_flush")
                self.fs.write_durable(
                    self._page_file(page_name), page, site="page.write"
                )
                maybe_fail("save.after_page_write")
                entry = ModelEntry(
                    model_id=model_id,
                    name=name,
                    architecture=architecture,
                    page=page_name,
                    n_tensors=len(records),
                    original_bytes=original_bytes,
                    status=STATUS_PENDING,
                    explain=(explain[:EXPLAIN_PERSIST_MAX]
                             if self.accounting else None),
                )
                self.catalog.state.models[name] = entry
                for (dim, vid), c in refs.items():
                    self.catalog.ref(dim, vid, c)
                if old:
                    for (dim, vid), c in old_refs.items():
                        self.catalog.ref(dim, vid, -c)
                entry.status = STATUS_COMMITTED
                self.catalog.save_snapshot()  # ← commit point
                self._account_committed_save(
                    name, model_id, page_name, len(page), original_bytes,
                    tuple(
                        TensorSpace(rec.dim_key, rec.vertex_id, rec.numel,
                                    len(rec.payload))
                        for rec in records
                    ),
                    explain,
                )
                maybe_fail("save.after_snapshot")
                if old:
                    self._tombstone_unreferenced(old_refs)
                    self.index_cache.flush()
                    self._unlink(self._page_file(old.page))
                    self._pending_explains.pop(old.model_id, None)
                    self._unlink(self._explain_file(old.model_id))
                    self.page_pool.invalidate(old.page)
                self.catalog.commit_tx(tx)
                self.index_cache.trim()
        finally:
            with self._lock:
                for pair, c in refs.items():
                    left = self._inflight[pair] - c
                    if left > 0:
                        self._inflight[pair] = left
                    else:
                        del self._inflight[pair]
        return SaveReport(
            model_id=model_id,
            name=name,
            original_bytes=original_bytes,
            page_bytes=len(page),
            n_tensors=len(records),
            n_new_bases=n_new,
            n_deltas=len(records) - n_new,
            nbits=nbits,
            seconds=op.elapsed(),
            explain=explain,
        )

    def save_models(
        self,
        models,
        tolerance: float | None = None,
        tau: float | None = None,
    ) -> list[SaveReport]:
        """Save several models under ONE catalog transaction (batch ingest).

        ``models`` is an iterable of ``(name, architecture, tensors)``
        triples. Tensor groups are formed **across the whole batch** per
        flattened dim, so a checkpoint sweep pays one index fetch, one
        batched probe and one ``insert_batch`` per dim for all models
        together (fine-tunes later in the batch dedup against bases the
        batch itself just created), and the commit protocol runs once:
        one journal intent, one index flush, one atomic ``meta.json``
        replace for every model — amortizing the fsyncs that dominate
        small-model save latency.

        All-or-nothing: a crash at any point replays to either every model
        committed or none (op ``save_batch`` in the journal; failpoints
        ``save_batch.after_intent`` / ``after_index_flush`` /
        ``after_page_write`` / ``after_snapshot``). Saving over an existing
        name is a replace, exactly as in :meth:`save_model`.

        Returns one :class:`SaveReport` per model, in input order, with the
        batch wall time amortized evenly over the ``seconds`` fields.
        """
        with trace("engine.save_batch") as op:
            reports = self._save_models_impl(models, tolerance, tau, op)
        _M_OPS.labels("save_batch").inc()
        _M_OP_SECONDS.labels("save_batch").observe(op.elapsed())
        return reports

    def _save_models_impl(self, models, tolerance, tau, op) -> list[SaveReport]:
        self._check_writable()
        p = self.tolerance if tolerance is None else tolerance
        tau_ = self.tau if tau is None else tau
        specs = [(str(n), a, t) for n, a, t in models]
        names = [n for n, _, _ in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in batch: {names}")
        if not specs:
            return []

        # Flatten: per-model item lists + one cross-model dim grouping.
        all_items: list[list[tuple[str, tuple[int, ...], object]]] = []
        original_bytes: list[int] = []
        by_dim: "OrderedDict[int, list[tuple[int, int]]]" = OrderedDict()
        for mi, (_name, _arch, tensors) in enumerate(specs):
            items: list[tuple[str, tuple[int, ...], object]] = []
            nbytes = 0
            for tname, tensor in tensors.items():
                src = np.asarray(tensor)
                nbytes += src.size * 4  # stored models are float32
                by_dim.setdefault(src.size, []).append((mi, len(items)))
                items.append((tname, tuple(int(s) for s in src.shape), src))
            all_items.append(items)
            original_bytes.append(nbytes)

        # Phase 1 (locked): one batched probe + insert per dim for the
        # whole batch — the cross-model half of the ingest amortization.
        bases: list[list] = [[None] * len(items) for items in all_items]
        probe_ex: list[list] = [[None] * len(items) for items in all_items]
        refs: Counter = Counter()
        new_vertices: list[tuple[int, int]] = []
        n_new_per_model = [0] * len(specs)
        try:
            for dim in by_dim:
                self.index_cache.pin(dim)
            try:
                with trace("probe", n_dims=len(by_dim)), self._lock:
                    for dim, positions in by_dim.items():
                        self._check_quarantine(dim)
                        index = self.index_cache.get(dim, create=True)
                        for chunk in self._iter_group_chunks(positions, dim):
                            flats = np.stack([
                                np.asarray(
                                    all_items[mi][pos][2], dtype=np.float64
                                ).ravel()
                                for mi, pos in chunk
                            ])
                            group_bases, group_new, group_ex = (
                                self._probe_dim_group(index, flats, tau_)
                            )
                            if group_new:
                                self.index_cache.mark_dirty(dim)
                                new_vertices.extend(
                                    (dim, v) for v in group_new
                                )
                            group_new_set = set(group_new)
                            for gj, (mi, pos) in enumerate(chunk):
                                vid, delta = group_bases[gj]
                                bases[mi][pos] = (vid, delta)
                                probe_ex[mi][pos] = group_ex[gj]
                                refs[(dim, vid)] += 1
                                self._inflight[(dim, vid)] += 1
                                if vid in group_new_set:
                                    group_new_set.discard(vid)
                                    n_new_per_model[mi] += 1
            finally:
                for dim in by_dim:
                    self.index_cache.unpin(dim)

            # Phase 2 (unlocked): encode every model's page.
            pages: list[bytes] = []
            nbits_per_model: list[list[int]] = []
            explain_per_model: list[list[dict]] = []
            spaces_per_model: list[tuple] = []
            with trace("quantize", n_models=len(all_items)):
                for mi, items in enumerate(all_items):
                    nbits: list[int] = []
                    explain: list[dict] = []
                    jobs = [(tname, shape, src.size, *bases[mi][i])
                            for i, (tname, shape, src) in enumerate(items)]
                    bases[mi] = None  # the jobs release each delta
                    records = _encode_records(jobs, p)
                    for i, rec in enumerate(records):
                        nbits.append(rec.meta.nbit)
                        ex = probe_ex[mi][i]
                        explain.append({
                            "tensor": rec.name,
                            "dim": int(rec.dim_key),
                            "vertex_id": int(ex["vertex_id"]),
                            "outcome": ex["outcome"],
                            "probe_distance": ex["probe_distance"],
                            "delta_range": ex["delta_range"],
                            "tau": float(tau_),
                            "nbit": int(rec.meta.nbit),
                            "delta_bytes": len(rec.payload),
                            "error_bound": float(p),
                        })
                    with trace("pack"):
                        pages.append(
                            write_page(records, checksums=self.checksums)
                        )
                    nbits_per_model.append(nbits)
                    explain_per_model.append(explain)
                    spaces_per_model.append(tuple(
                        TensorSpace(rec.dim_key, rec.vertex_id, rec.numel,
                                    len(rec.payload))
                        for rec in records
                    ))

            # Phase 3 (locked): ONE journaled commit for the whole batch.
            with trace("commit"), self._lock:
                olds = [self.catalog.get(n) for n in names]
                old_refs = [
                    self._page_refs(o.page) if o else Counter() for o in olds
                ]
                if self.commit_gate is not None:
                    self.commit_gate([
                        {
                            "name": names[mi],
                            "page_bytes": len(pages[mi]),
                            "old_page_bytes": self._page_size(olds[mi]),
                        }
                        for mi in range(len(specs))
                    ])
                model_ids = [self.catalog.allocate_id() for _ in specs]
                page_names = [f"model_{mid}.page" for mid in model_ids]
                intent_models = []
                for mi, (name, _arch, _t) in enumerate(specs):
                    m: dict = {
                        "name": name,
                        "id": model_ids[mi],
                        "page": page_names[mi],
                    }
                    if olds[mi]:
                        m["old_id"] = olds[mi].model_id
                        m["old_page"] = olds[mi].page
                        m["old_refs"] = [
                            [d, v, c] for (d, v), c in old_refs[mi].items()
                        ]
                    intent_models.append(m)
                with trace("journal"):
                    tx = self.catalog.begin({
                        "op": "save_batch",
                        "models": intent_models,
                        "new_vertices": [[d, v] for d, v in new_vertices],
                    })
                maybe_fail("save_batch.after_intent")
                self.index_cache.flush()
                maybe_fail("save_batch.after_index_flush")
                for mi in range(len(specs)):
                    self.fs.write_durable(
                        self._page_file(page_names[mi]), pages[mi],
                        site="page.write",
                    )
                maybe_fail("save_batch.after_page_write")
                for mi, (name, arch, _t) in enumerate(specs):
                    self.catalog.state.models[name] = ModelEntry(
                        model_id=model_ids[mi],
                        name=name,
                        architecture=arch,
                        page=page_names[mi],
                        n_tensors=len(all_items[mi]),
                        original_bytes=original_bytes[mi],
                        status=STATUS_COMMITTED,
                        explain=(
                            explain_per_model[mi][:EXPLAIN_PERSIST_MAX]
                            if self.accounting else None
                        ),
                    )
                for (dim, vid), c in refs.items():
                    self.catalog.ref(dim, vid, c)
                for mi in range(len(specs)):
                    for (dim, vid), c in old_refs[mi].items():
                        self.catalog.ref(dim, vid, -c)
                self.catalog.save_snapshot()  # ← commit point for ALL models
                for mi in range(len(specs)):
                    self._account_committed_save(
                        names[mi], model_ids[mi], page_names[mi],
                        len(pages[mi]), original_bytes[mi],
                        spaces_per_model[mi], explain_per_model[mi],
                    )
                maybe_fail("save_batch.after_snapshot")
                dropped_old = False
                for mi in range(len(specs)):
                    if olds[mi]:
                        self._tombstone_unreferenced(old_refs[mi])
                        self._unlink(self._page_file(olds[mi].page))
                        self._pending_explains.pop(olds[mi].model_id, None)
                        self._unlink(self._explain_file(olds[mi].model_id))
                        self.page_pool.invalidate(olds[mi].page)
                        dropped_old = True
                if dropped_old:
                    self.index_cache.flush()
                self.catalog.commit_tx(tx)
                self.index_cache.trim()
        finally:
            with self._lock:
                for pair, c in refs.items():
                    left = self._inflight[pair] - c
                    if left > 0:
                        self._inflight[pair] = left
                    else:
                        del self._inflight[pair]
        per_model_s = op.elapsed() / len(specs)
        return [
            SaveReport(
                model_id=model_ids[mi],
                name=names[mi],
                original_bytes=original_bytes[mi],
                page_bytes=len(pages[mi]),
                n_tensors=len(all_items[mi]),
                n_new_bases=n_new_per_model[mi],
                n_deltas=len(all_items[mi]) - n_new_per_model[mi],
                nbits=nbits_per_model[mi],
                seconds=per_model_s,
                explain=explain_per_model[mi],
            )
            for mi in range(len(specs))
        ]

    # -------------------------------------------------------------- lifecycle
    def delete_model(self, name: str) -> None:
        """Drop a model: journal intent → catalog commit → tombstone
        zero-ref vertices → unlink page. Crash-safe at every step.

        Quarantined (corrupt) models can be deleted too — that is the
        repair path for unrecoverable damage; their reference counts come
        from whatever records still verify (see :meth:`_page_refs`)."""
        self._check_writable()
        self._drain_released()
        with trace("engine.delete", model=name) as op, self._lock:
            entry = self.catalog.get(name)
            if entry is None or entry.status not in (
                STATUS_COMMITTED, STATUS_CORRUPT
            ):
                raise KeyError(name)
            refs = self._page_refs(entry.page)
            for dim, _vid in refs:
                self._check_quarantine(dim)
            tx = self.catalog.begin({
                "op": "delete",
                "name": name,
                "id": entry.model_id,
                "page": entry.page,
                "refs": [[d, v, c] for (d, v), c in refs.items()],
            })
            maybe_fail("delete.after_intent")
            del self.catalog.state.models[name]
            for (dim, vid), c in refs.items():
                self.catalog.ref(dim, vid, -c)
            self.catalog.save_snapshot()  # ← commit point
            if self.accounting:
                self._accountant.record_delete(name)
            maybe_fail("delete.after_snapshot")
            self._tombstone_unreferenced(refs)
            self.index_cache.flush()
            maybe_fail("delete.after_index_flush")
            self._unlink(self._page_file(entry.page))
            self._pending_explains.pop(entry.model_id, None)
            self._unlink(self._explain_file(entry.model_id))
            self.page_pool.invalidate(entry.page)
            self._corrupt_reasons.pop(name, None)
            self.catalog.commit_tx(tx)
        _M_OPS.labels("delete").inc()
        _M_OP_SECONDS.labels("delete").observe(op.elapsed())

    def replace_model(
        self,
        name: str,
        architecture: dict,
        tensors: "OrderedDict[str, np.ndarray] | dict[str, np.ndarray]",
        tolerance: float | None = None,
        tau: float | None = None,
    ) -> SaveReport:
        """Save a new version of an existing model and drop the old one
        under a single journal transaction (save-new-then-drop-old)."""
        # Hold the (reentrant) lock across the save so a concurrent delete
        # cannot void the existence check and silently turn the replace
        # into a fresh save.
        with trace("engine.replace", model=name) as op, self._lock:
            if self.catalog.get(name) is None:
                raise KeyError(name)
            report = self.save_model(name, architecture, tensors, tolerance, tau)
        _M_OPS.labels("replace").inc()
        _M_OP_SECONDS.labels("replace").observe(op.elapsed())
        return report

    def vacuum(self, min_dead_fraction: float = 0.0, dims=None) -> dict:
        """Compact indexes whose dead-vertex fraction is ≥ the threshold.

        Copy-on-write per dim: sweep (any vertex with zero catalog
        references becomes a tombstone) → journal intent → compact a
        **clone** of the index (the resident object, shared with snapshot
        readers, is never restructured) → write the compacted index as a
        ``.vac`` side file and every remapped page under a **new page
        name** → journal the switch record (page moves + the full
        post-remap reference table) → switch the catalog (entries point at
        the new pages; refs replaced; atomic snapshot = commit point) →
        install the index file and clone, unlink the old pages → commit.
        Mid-vacuum crashes roll forward from the switch record (all side
        files are durable before it) or roll back by discarding side
        files. Every surviving model materializes bit-identically before
        vs. after (vertex codes are copied verbatim and page payloads are
        untouched), and readers that loaded *before* the vacuum keep
        materializing from their pinned snapshot — old index object, old
        page bytes — also bit-identically.

        Returns a report: per-dim dropped/live counts, pages rewritten,
        and dims skipped because an in-flight save holds references.
        """
        self._check_writable()
        self._drain_released()
        self.flush_explains()
        report: dict = {
            "dims": {},
            "skipped_dims": [],
            "vertices_dropped": 0,
            "pages_rewritten": 0,
        }
        with trace("engine.vacuum") as op, self._lock:
            corrupt = self.catalog.corrupt_names()
            if corrupt:
                # Compaction renumbers vertex ids and rewrites page refs;
                # a quarantined page cannot be remapped, so a vacuum now
                # would strand it pointing at pre-compaction ids forever.
                # Repair or drop the quarantined models first.
                report["skipped_reason"] = (
                    f"{len(corrupt)} quarantined model(s) pin vertex ids: "
                    f"{sorted(corrupt)}"
                )
                return report
            # Lazy, one scan per page for the whole vacuum: which dims each
            # page references never changes (rewrites only renumber
            # vertices, renames are tracked below). Built only when some
            # dim actually passes the dead-fraction threshold, so the
            # maintenance daemon's steady-state no-op steps never pay a
            # store-wide page header sweep under the engine lock.
            dims_by_page_cache: list[dict[str, set[int]]] = []

            def dims_by_page() -> dict[str, set[int]]:
                # STRICT scan: a page this planner cannot read must abort
                # the vacuum. Treating it as reference-free would skip its
                # remap during renumbering and strand live records on
                # stale vertex ids — the unsafe direction.
                if not dims_by_page_cache:
                    by_page: dict[str, set[int]] = {}
                    for entry in (self.catalog.get(n)
                                  for n in self.catalog.names()):
                        try:
                            by_page[entry.page] = {
                                d for d, _ in self._page_refs(
                                    entry.page, strict=True)
                            }
                        except CorruptPageError as exc:
                            self._quarantine_model(
                                entry.name, entry.page,
                                f"vacuum scan: {exc}", persist=False,
                            )
                            raise
                    dims_by_page_cache.append(by_page)
                return dims_by_page_cache[0]

            for dim in (dims if dims is not None else self.index_cache.dims()):
                if (
                    dim in self._quarantined_dims
                    or any(pair[0] == dim for pair in self._inflight)
                ):
                    report["skipped_dims"].append(dim)
                    continue
                idx = self.index_cache.get(dim)
                if idx is None or len(idx) == 0:
                    continue
                self.index_cache.pin(dim)
                try:
                    self._vacuum_dim(dim, idx, min_dead_fraction, report,
                                     dims_by_page)
                except BaseException:
                    # The on-disk state may be half-switched and the journal
                    # still holds the recovery records: drop the resident
                    # object and quarantine the dim until a reopen replays.
                    self.index_cache.drop(dim)
                    self._quarantined_dims.add(dim)
                    raise
                finally:
                    self.index_cache.unpin(dim)
            self.index_cache.flush()
            self.index_cache.trim()
            if self.accounting and report["dims"]:
                # Compaction renumbered vertex ids and renamed pages:
                # the incremental ledger's facts are stale — reseed it
                # from the post-vacuum store (the same full rescan that
                # runs at open).
                self._accountant.reset(self._scan_model_spaces())
        _M_OPS.labels("vacuum").inc()
        _M_OP_SECONDS.labels("vacuum").observe(op.elapsed())
        return report

    def _vacuum_dim(
        self,
        dim: int,
        idx: HNSWIndex,
        min_dead_fraction: float,
        report: dict,
        page_map,
    ) -> None:
        """``page_map`` is a lazy callable → {page_name: dims referenced};
        only invoked past the threshold check so no-op sweeps stay cheap."""
        refs = self.catalog.refs_for_dim(dim)
        # Sweep: liveness is defined by the reference table, so orphan
        # vertices from crashed saves are collected here too.
        for vid in range(len(idx)):
            if refs.get(vid, 0) <= 0 and not idx.is_deleted(vid):
                idx.mark_deleted(vid)
                self.index_cache.mark_dirty(dim)
        dead = idx.dead_count
        if dead == 0 or idx.dead_fraction() < min_dead_fraction:
            return
        dims_by_page = page_map()
        affected = [
            entry
            for entry in (
                self.catalog.get(n) for n in self.catalog.names()
            )
            if dim in dims_by_page.get(entry.page, ())
        ]
        tx = self.catalog.begin({
            "op": "vacuum",
            "dim": dim,
            "pages": [e.page for e in affected],
        })
        maybe_fail("vacuum.after_intent")
        # Copy-on-write: compact a clone. The resident object — shared
        # with every snapshot captured before this point — keeps its rows
        # and numbering, so concurrent readers stay lock-free and valid.
        new_idx = idx.clone()
        remap = new_idx.compact()
        self.fs.write_durable(
            self.index_cache._path(dim) + ".vac",
            frame_index(new_idx.to_bytes()),
            site="index.vac",
        )
        moves: list[tuple[ModelEntry, str, str]] = []
        for entry in affected:
            buf = self.fs.read_bytes(
                self._page_file(entry.page), site="page.vacuum"
            )
            if self.checksums:
                try:
                    verify_page(buf)
                except CorruptPageError as exc:
                    # Never remap a damaged page: quarantine the model and
                    # abort this dim (rolled back at the next reopen).
                    self._quarantine_model(
                        entry.name, entry.page, f"vacuum: {exc}",
                        persist=False,
                    )
                    raise
            new_buf, changed = remap_page_vertices(buf, remap, dim)
            if changed:
                # Generation ids come from the catalog's monotonic counter,
                # but a pre-commit crash loses the allocation — skip any id
                # whose page name already exists (e.g. our own current name
                # after a replayed vacuum) so old and new never collide.
                new_page = entry.page
                while (new_page == entry.page
                       or os.path.exists(self._page_file(new_page))):
                    new_page = (
                        f"model_{entry.model_id}"
                        f".g{self.catalog.allocate_id()}.page"
                    )
                self.fs.write_durable(
                    self._page_file(new_page), new_buf, site="page.write"
                )
                moves.append((entry, entry.page, new_page))
        maybe_fail("vacuum.after_sidefiles")
        new_refs = {str(remap[v]): c for v, c in refs.items() if c > 0}
        self.catalog.log(tx, {
            "op": "vacuum_switch",
            "dim": dim,
            "moves": [[e.name, old, new] for e, old, new in moves],
            "refs": new_refs,
        })
        maybe_fail("vacuum.after_switch_log")
        # Catalog switch: entries point at the rewritten pages, the dim's
        # reference table is renumbered, and the atomic snapshot commits
        # both (bumping the reader-visible epoch).
        for entry, old_page, new_page in moves:
            entry.page = new_page
            if old_page in dims_by_page:
                dims_by_page[new_page] = dims_by_page.pop(old_page)
        self.catalog.set_dim_refs(dim, {int(v): c for v, c in new_refs.items()})
        self.catalog.save_snapshot()  # ← commit point
        maybe_fail("vacuum.mid_switch")
        self.fs.replace(self.index_cache._path(dim) + ".vac",
                        self.index_cache._path(dim), site="index.replace")
        for _entry, old_page, _new_page in moves:
            self._unlink(self._page_file(old_page))
            self.page_pool.invalidate(old_page)
        self.catalog.commit_tx(tx)
        # Future loads see the compacted clone; snapshots keep the old one.
        self.index_cache.replace(dim, new_idx)
        report["dims"][dim] = {
            "dropped": dead,
            "live": len(new_idx),
            "pages_rewritten": len(moves),
        }
        report["vertices_dropped"] += dead
        report["pages_rewritten"] += len(moves)

    # ------------------------------------------------------------------ load
    def _read_page_bytes(self, page_name: str) -> bytes:
        """Read + verify page bytes — the buffer pool's frame loader.

        Verification happens here, at frame *admission*: every reader of a
        cached frame shares one CRC pass instead of re-verifying per load.
        """
        with trace("page.io", page=page_name):
            data = self.fs.read_bytes(
                self._page_file(page_name), site="page.read"
            )
            if self.checksums:
                verify_page(data)
        _M_PAGE_READS.inc()
        _M_PAGE_READ_BYTES.inc(len(data))
        return data

    def _quarantine_model(
        self, name: str, page_name: str, reason: str, persist: bool = True
    ) -> bool:
        """Mark a model corrupt; the store keeps serving healthy models.

        Re-validates that the entry still points at ``page_name`` — a
        racing replace/vacuum may have swapped the page, in which case the
        damage belongs to a dead file, not the live model. The quarantine
        is persisted through a catalog snapshot unless the store is
        read-only (degraded mode never mutates disk).
        """
        with self._lock:
            entry = self.catalog.get(name)
            if (
                entry is None
                or entry.page != page_name
                or entry.status == STATUS_CORRUPT
            ):
                return False
            entry.status = STATUS_CORRUPT
            self._corrupt_reasons[name] = reason
            self.page_pool.invalidate(page_name)
            if self.accounting:
                # A quarantined model is no longer servable (and the
                # rescan skips it), so it leaves the space ledger too.
                self._accountant.record_delete(name)
            _M_QUARANTINES.inc()
            if persist and not self.read_only:
                try:
                    self.catalog.save_snapshot()
                except OSError:
                    pass  # quarantine still holds in memory; next commit persists
            return True

    def _corrupt_error(self, name: str) -> CorruptPageError:
        reason = self._corrupt_reasons.get(name, "failed an integrity check")
        return CorruptPageError(f"model {name!r} is quarantined: {reason}")

    def _parse_frame(self, frame) -> TensorPage:
        """Parsed-header cache on the frame (shared across handles)."""
        page = frame.page
        if page is None:
            with frame.lock:
                page = frame.page
                if page is None:
                    page = frame.page = read_page_header(frame.data)
        return page

    def _drain_released(self) -> None:
        """Apply queued snapshot releases (GC finalizers only enqueue —
        they must not take locks from inside garbage collection)."""
        while True:
            try:
                token, frame = self._released.popleft()
            except IndexError:
                return
            with self._lock:
                self._live_snapshots.pop(token, None)
            if frame is not None:
                self.page_pool.unpin(frame)

    def open_page(self, name: str) -> tuple[TensorPage, ModelEntry]:
        with self._lock:
            entry = self.catalog.get(name)
            if entry is None or entry.status != STATUS_COMMITTED:
                if entry is not None and entry.status == STATUS_CORRUPT:
                    raise self._corrupt_error(name)
                raise KeyError(name)
            page_name = entry.page
        try:
            frame = self.page_pool.get(
                page_name, lambda: self._read_page_bytes(page_name)
            )
        except CorruptPageError as exc:
            self._quarantine_model(name, page_name, str(exc))
            raise
        try:
            page = self._parse_frame(frame)
        except CorruptPageError as exc:
            self._quarantine_model(name, page_name, str(exc))
            raise
        finally:
            self.page_pool.unpin(frame)
        return page, entry

    def load_model(self, name: str, bits: int | None = None, *,
                   shared_cache: bool = True):
        """Compression-aware load — see :mod:`repro_torch.core.loader`.

        Returns a :class:`~repro_torch.core.loader.LoadedModel` backed by an
        epoch-stamped :class:`~repro_torch.core.loader.ModelSnapshot`: after the
        short capture critical section the handle never takes the engine
        lock again, so concurrent writers (save/delete/replace/vacuum)
        cannot stall — or invalidate — this reader. ``shared_cache=False``
        bypasses the buffer pool (private page bytes and decoded payloads
        — the pre-concurrency behaviour; the concurrency benchmark uses it
        as the serialized baseline).
        """
        with trace("engine.load", model=name) as op:
            lm = self._load_model_impl(name, bits, shared_cache)
        _M_OPS.labels("load").inc()
        _M_OP_SECONDS.labels("load").observe(op.elapsed())
        return lm

    def _load_model_impl(self, name: str, bits: int | None,
                         shared_cache: bool):
        from .loader import LoadedModel, ModelSnapshot

        self._drain_released()
        for _attempt in range(64):
            with trace("probe"), self._lock:
                entry = self.catalog.get(name)
                if entry is None or entry.status != STATUS_COMMITTED:
                    if entry is not None and entry.status == STATUS_CORRUPT:
                        raise self._corrupt_error(name)
                    raise KeyError(name)
                page_name = entry.page
            # Page bytes + header parse + payload slicing run outside the
            # engine lock: page files are immutable per *name* (vacuum
            # rewrites copy-on-write under new names), so bytes read here
            # are consistent with whatever entry we re-validate below.
            frame = None
            try:
                with trace("pool", page=page_name):
                    if shared_cache:
                        frame = self.page_pool.get(
                            page_name,
                            lambda: self._read_page_bytes(page_name),
                        )
                        page = self._parse_frame(frame)
                    else:
                        page = read_page_header(
                            self._read_page_bytes(page_name)
                        )
                    dims = page_dim_keys(page)
            except FileNotFoundError as exc:
                # Raced a delete/replace/vacuum: re-read the entry. A frame
                # returned by get() cannot be the raiser (its bytes loaded),
                # but unpin defensively in case the parse path ever throws.
                if frame is not None:
                    self.page_pool.unpin(frame)
                if self.read_only:
                    # No writers exist in a degraded store: the fallback
                    # snapshot predates this page's cleanup and the file
                    # is permanently gone — fail typed, don't spin.
                    self._quarantine_model(
                        name, page_name, f"page file missing: {exc}"
                    )
                    raise self._corrupt_error(name) from exc
                continue
            except CorruptPageError as exc:
                # Contain the damage: quarantine THIS model (the catalog
                # keeps serving every healthy one) and fail typed. Plain
                # I/O errors (EIO) do NOT quarantine — the disk said
                # nothing about the bytes, only about this read.
                if frame is not None:
                    self.page_pool.unpin(frame)
                self._quarantine_model(name, page_name, str(exc))
                raise
            except BaseException:
                if frame is not None:
                    self.page_pool.unpin(frame)  # corrupt page: no pin leak
                raise
            try:
                with trace("snapshot"), self._lock:
                    cur = self.catalog.get(name)
                    if cur is not None and cur.status == STATUS_CORRUPT:
                        raise self._corrupt_error(name)
                    if (cur is None or cur.status != STATUS_COMMITTED
                            or cur.page != page_name):
                        raise _Retry
                    for dim in dims:
                        self._check_quarantine(dim)
                    indexes: dict[int, HNSWIndex] = {}
                    for dim in dims:
                        idx = self.index_cache.get(dim)
                        if idx is None:
                            raise RuntimeError(
                                f"model {name!r} references dim {dim} but no "
                                "index exists for it (corrupt store?)"
                            )
                        indexes[dim] = idx
                    epoch = self.catalog.state.epoch
                    token = self._snap_token
                    self._snap_token += 1
                    self._live_snapshots[token] = epoch
                    # The snapshot owns a COPY of the catalog row: vacuum
                    # re-points the live entry's page at the rewritten
                    # file, and an "immutable view" must keep naming the
                    # page version it actually pinned.
                    cur = dataclasses.replace(cur)
            except _Retry:
                if frame is not None:
                    self.page_pool.unpin(frame)
                continue
            except CorruptIndexError as exc:
                # The page is fine but a referenced index file is not:
                # this model cannot materialize, so quarantine it (other
                # dims' models keep serving).
                if frame is not None:
                    self.page_pool.unpin(frame)
                self._quarantine_model(name, page_name, str(exc))
                raise
            except BaseException:
                if frame is not None:
                    self.page_pool.unpin(frame)
                raise
            snap = ModelSnapshot(
                epoch=epoch, entry=cur, frame=frame, indexes=indexes,
                release=_SnapshotRelease(self._released, token, frame),
            )
            return LoadedModel(engine=self, page=page, info=cur, bits=bits,
                               snapshot=snap)
        raise RuntimeError(
            f"load_model({name!r}): catalog kept changing under the capture "
            "loop (writer livelock?)"
        )

    def load_models(self, names, bits: int | None = None) -> list:
        """Open handles over several models under ONE snapshot epoch.

        Returns one :class:`~repro_torch.core.loader.LoadedModel` per name, in
        order. Unlike a loop of :meth:`load_model` calls — where a writer
        committing between two captures hands the batch a mixed-epoch,
        mutually inconsistent view — the whole set is validated and
        captured inside a single critical section, so every handle shares
        the same epoch. Page I/O and header parsing still run outside the
        lock (the expensive part); the critical section only re-validates
        entries and stamps snapshots, retrying the batch when a writer
        raced the reads. Feed the result to
        :func:`repro_torch.core.loader.materialize_many` to reconstruct with
        each base shared *across* handles de-quantized once.
        """
        names = list(names)
        if not names:
            return []
        with trace("engine.load_batch", n_models=len(names)) as op:
            handles = self._load_models_impl(names, bits)
        _M_OPS.labels("load_batch").inc()
        _M_OP_SECONDS.labels("load_batch").observe(op.elapsed())
        return handles

    def _load_models_impl(self, names: list, bits: int | None) -> list:
        from .loader import LoadedModel, ModelSnapshot
        self._drain_released()
        for _attempt in range(64):
            # Phase 1 (no lock held across I/O): resolve each name to its
            # committed page, pin + parse the frame. Same race handling as
            # load_model — FileNotFoundError means a delete/replace/vacuum
            # won; retry the whole batch so the view stays one-epoch.
            # Entries are mutable lists: once a ModelSnapshot takes
            # ownership of a frame (its finalizer unpins), the slot is
            # nulled so the failure path can't double-unpin it.
            prepared: list = []  # [name, page_name, frame, page, dims]
            corrupt_at: list = []  # (name, page_name) of an index failure

            def _unpin_prepared() -> None:
                for rec in prepared:
                    if rec[2] is not None:
                        self.page_pool.unpin(rec[2])
                        rec[2] = None

            try:
                for name in names:
                    with self._lock:
                        entry = self.catalog.get(name)
                        if entry is None or entry.status != STATUS_COMMITTED:
                            if (entry is not None
                                    and entry.status == STATUS_CORRUPT):
                                raise self._corrupt_error(name)
                            raise KeyError(name)
                        page_name = entry.page
                    frame = None
                    try:
                        frame = self.page_pool.get(
                            page_name,
                            lambda: self._read_page_bytes(page_name),
                        )
                        page = self._parse_frame(frame)
                        dims = page_dim_keys(page)
                    except FileNotFoundError as exc:
                        if frame is not None:
                            self.page_pool.unpin(frame)
                        if self.read_only:
                            self._quarantine_model(
                                name, page_name, f"page file missing: {exc}"
                            )
                            raise self._corrupt_error(name) from exc
                        raise _Retry from exc
                    except CorruptPageError as exc:
                        if frame is not None:
                            self.page_pool.unpin(frame)
                        self._quarantine_model(name, page_name, str(exc))
                        raise
                    except BaseException:
                        if frame is not None:
                            self.page_pool.unpin(frame)
                        raise
                    prepared.append([name, page_name, frame, page, dims])

                # Phase 2: ONE critical section — re-validate every entry
                # against the page version actually pinned, then stamp all
                # snapshots with the same epoch.
                with self._lock:
                    entries = []
                    for name, page_name, _frame, _page, dims in prepared:
                        cur = self.catalog.get(name)
                        if cur is not None and cur.status == STATUS_CORRUPT:
                            raise self._corrupt_error(name)
                        if (cur is None or cur.status != STATUS_COMMITTED
                                or cur.page != page_name):
                            raise _Retry
                        for dim in dims:
                            self._check_quarantine(dim)
                        entries.append(dataclasses.replace(cur))
                    index_sets = []
                    for rec in prepared:
                        name, page_name, _fr, _pg, dims = rec
                        corrupt_at[:] = [(name, page_name)]
                        indexes: dict[int, HNSWIndex] = {}
                        for dim in dims:
                            idx = self.index_cache.get(dim)
                            if idx is None:
                                raise RuntimeError(
                                    f"model {name!r} references dim {dim} "
                                    "but no index exists for it (corrupt "
                                    "store?)"
                                )
                            indexes[dim] = idx
                        index_sets.append(indexes)
                    epoch = self.catalog.state.epoch
                    snaps = []
                    for rec, cur, indexes in zip(
                            prepared, entries, index_sets):
                        frame = rec[2]
                        token = self._snap_token
                        self._snap_token += 1
                        self._live_snapshots[token] = epoch
                        snaps.append(ModelSnapshot(
                            epoch=epoch, entry=cur, frame=frame,
                            indexes=indexes,
                            release=_SnapshotRelease(
                                self._released, token, frame),
                        ))
                        rec[2] = None  # frame now owned by the snapshot
            except _Retry:
                _unpin_prepared()
                continue
            except CorruptIndexError as exc:
                # Index damage discovered during capture: quarantine the
                # model whose dims were being resolved; fail the batch typed
                # (other models stay healthy).
                _unpin_prepared()
                for name, page_name in corrupt_at:
                    self._quarantine_model(name, page_name, str(exc))
                raise
            except BaseException:
                _unpin_prepared()
                raise
            return [
                LoadedModel(engine=self, page=rec[3], info=snap.entry,
                            bits=bits, snapshot=snap)
                for rec, snap in zip(prepared, snaps)
            ]
        raise RuntimeError(
            f"load_models({names!r}): catalog kept changing under the batch "
            "capture loop (writer livelock?)"
        )

    # ------------------------------------------------------------- integrity
    def scrub(self, max_models: int = 1) -> dict:
        """Incremental integrity scrub: verify up to ``max_models`` pages.

        A round-robin cursor walks the committed models so repeated calls
        (one per maintenance-daemon step) cover the whole store, finding
        latent disk corruption and quarantining it *before* a reader trips
        on it. Only page bytes are read — no payload decode, no lock held
        during I/O.
        """
        report: dict = {"scanned": 0, "corrupt": [], "io_errors": 0}
        for _ in range(max(0, int(max_models))):
            with self._lock:
                names = self.catalog.names()
                if not names:
                    break
                self._scrub_cursor %= len(names)
                name = names[self._scrub_cursor]
                self._scrub_cursor += 1
                page_name = self.catalog.get(name).page
            try:
                verify_page(self.fs.read_bytes(
                    self._page_file(page_name), site="page.scrub"
                ))
            except FileNotFoundError:
                continue  # raced a delete/replace/vacuum
            except CorruptPageError as exc:
                if self._quarantine_model(name, page_name, f"scrub: {exc}"):
                    report["corrupt"].append(name)
            except OSError:
                report["io_errors"] += 1
            report["scanned"] += 1
        return report

    def verify_store(self, quarantine: bool = False) -> dict:
        """Full integrity sweep over every page and index file.

        With ``quarantine=True`` (the repair path — ``tools/fsck.py``),
        models whose page fails verification, whose page file is missing,
        or whose referenced index file is corrupt are marked corrupt in
        the catalog (one snapshot at the end persists them all).
        """
        report: dict = {"pages": {}, "indexes": {}, "quarantined": []}
        bad_dims: set[int] = set()
        for dim in self.index_cache.dims():
            path = self.index_cache._path(dim)
            if not os.path.exists(path):
                continue  # resident-only index: consistent by construction
            try:
                payload = unframe_index(
                    self.fs.read_bytes(path, site="index.scrub"), path
                )
                # A parse check: on the CPU, so no index is uploaded to the card.
                HNSWIndex.from_bytes(payload, device="cpu")
                report["indexes"][dim] = "ok"
            except Exception as exc:
                report["indexes"][dim] = f"corrupt: {exc}"
                bad_dims.add(dim)
        with self._lock:
            names = self.catalog.names(committed_only=False)
        changed = False
        for name in names:
            with self._lock:
                entry = self.catalog.get(name)
                if entry is None:
                    continue
                if entry.status == STATUS_CORRUPT:
                    report["pages"][name] = "quarantined"
                    continue
                page_name = entry.page
            status = "ok"
            reason = None
            try:
                page = verify_page(self.fs.read_bytes(
                    self._page_file(page_name), site="page.scrub"
                ))
                broken = sorted(set(page_dim_keys(page)) & bad_dims)
                if broken:
                    reason = f"references corrupt index dim(s) {broken}"
                    status = f"corrupt: {reason}"
            except FileNotFoundError:
                reason = "page file missing"
                status = f"corrupt: {reason}"
            except CorruptPageError as exc:
                reason = str(exc)
                status = f"corrupt: {reason}"
            if reason is not None and quarantine:
                if self._quarantine_model(
                    name, page_name, reason, persist=False
                ):
                    report["quarantined"].append(name)
                    changed = True
            report["pages"][name] = status
        if changed and not self.read_only:
            with self._lock:
                self.catalog.save_snapshot()
        return report

    def drop_corrupt_models(self) -> list[str]:
        """Delete every quarantined model (the destructive half of repair)."""
        self._check_writable()
        dropped = []
        with self._lock:
            for name in self.catalog.corrupt_names():
                self.delete_model(name)
                dropped.append(name)
        return dropped

    def rebuild_vertex_refs(self) -> dict:
        """Re-derive ``vertex_refs`` wholesale from committed pages.

        The repair path for leaked references (quarantine accounting is
        deliberately conservative — see :meth:`_page_refs`). Requires no
        quarantined models: their unreadable records hold references this
        rebuild cannot see, and dropping those would free live bases.
        Newly unreferenced vertices are tombstoned for a later vacuum.
        """
        self._check_writable()
        with self._lock:
            if self.catalog.corrupt_names():
                raise RuntimeError(
                    "cannot rebuild refs while quarantined models exist — "
                    "repair or drop them first"
                )
            derived: Counter = Counter()
            for n in self.catalog.names():
                derived.update(
                    self._page_refs(self.catalog.get(n).page, strict=True)
                )
            old_keys = set(self.catalog.state.vertex_refs)
            self.catalog.state.vertex_refs = {
                f"{d}:{v}": int(c) for (d, v), c in derived.items()
            }
            pairs = {
                tuple(int(x) for x in k.split(":")) for k in old_keys
            } | set(derived)
            self._tombstone_unreferenced(pairs)
            self.index_cache.flush()
            self.catalog.save_snapshot()
            return {
                "refs": len(derived),
                "dropped": len(
                    old_keys - set(self.catalog.state.vertex_refs)
                ),
            }

    # ----------------------------------------------------------- maintenance
    def start_maintenance(self, **kwargs):
        """Start the background maintenance daemon (idempotent).

        Keyword arguments are forwarded to
        :class:`repro_torch.core.maintenance.MaintenanceDaemon` (thresholds,
        interval). Returns the daemon; ``close()`` stops it.
        """
        from .maintenance import MaintenanceDaemon

        with self._lock:
            if self.maintenance is None:
                self.maintenance = MaintenanceDaemon(self, **kwargs)
                self.maintenance.start()
            return self.maintenance

    def close(self) -> None:
        """Stop background maintenance, flush queued EXPLAIN sidecars,
        and release queued snapshot pins."""
        daemon = self.maintenance
        if daemon is not None:
            daemon.stop()
            self.maintenance = None
        self.flush_explains()
        self._drain_released()

    # ------------------------------------------------------------ accounting
    def stats(self) -> dict:
        """Engine-wide counters — a versioned API, not an internal dump.

        ``schema_version`` stamps the layout (``STATS_SCHEMA_VERSION``);
        every counter is documented in ``docs/serving.md``, and the
        serving admission policy consumes only the documented fields
        (through :class:`repro.store.api.StoreStats`).

        ``buffer_pool``: page-frame hits/misses/evictions, resident and
        pinned bytes, shared-decode hit rate. ``epoch``: the current
        snapshot-isolation epoch (bumped at every writer commit).
        ``snapshots``: live reader snapshots and the oldest epoch still
        pinned. ``index_cache``: the existing HNSW cache counters.
        ``models``: committed (servable) catalog entries.
        """
        self._drain_released()
        with self._lock:
            live = list(self._live_snapshots.values())
            out = {
                "schema_version": STATS_SCHEMA_VERSION,
                "epoch": self.catalog.state.epoch,
                "models": len(self.catalog.names()),
                "snapshots": {
                    "live": len(live),
                    "oldest_epoch": min(live) if live else None,
                },
                "buffer_pool": self.page_pool.stats(),
                "index_cache": self.index_cache.stats(),
                "integrity": {
                    "read_only": self.read_only,
                    "degraded_reason": self.degraded_reason,
                    "checksums": self.checksums,
                    "corrupt_models": sorted(self.catalog.corrupt_names()),
                },
                "accounting": self._accounting_stats(),
            }
            if self.maintenance is not None:
                out["maintenance"] = self.maintenance.stats()
            return out

    def list_models(self) -> list[str]:
        return self.catalog.names()

    def model_info(self, name: str) -> ModelEntry | None:
        return self.catalog.get(name)

    def storage_bytes(self) -> dict:
        """Total storage split: pages vs index (paper Fig. 10a breakdown).

        Takes the engine lock so the flush never serializes an index that a
        concurrent ``save_model`` phase 1 is mutating.
        """
        with self._lock:
            pages = sum(
                os.path.getsize(self._page_file(self.catalog.get(n).page))
                for n in self.catalog.names()
            )
            self.index_cache.flush()
            index = sum(
                os.path.getsize(os.path.join(self.root, "index", f))
                for f in os.listdir(os.path.join(self.root, "index"))
                if f.endswith(".idx")
            )
        return {"pages": pages, "index": index, "total": pages + index}

    def per_model_bytes(self, name: str) -> float:
        """Page bytes + amortized share of referenced base-tensor storage.

        Paper §6.3.2: "evenly distribute the storage cost of each base tensor
        in the index across all tensors that reference it".
        """
        page, entry = self.open_page(name)
        total = float(os.path.getsize(self._page_file(entry.page)))
        for i in range(page.n_records):
            rec = read_record(page, i, with_payload=False)
            share = self.catalog.ref_count(rec.dim_key, rec.vertex_id)
            # 8-bit base codes + graph overhead approximated by codes size.
            total += rec.numel / max(share, 1)
        return total

    def _accounting_stats(self) -> dict:
        """The ``accounting`` section of :meth:`stats` (documented —
        StoreStats projects ``logical_bytes`` / ``physical_bytes`` /
        ``compression_ratio`` out of it)."""
        logical, physical = self._accountant.totals(self.catalog.ref_count)
        return {
            "enabled": self.accounting,
            "logical_bytes": logical,
            "physical_bytes": physical,
            "compression_ratio": (
                physical / logical if logical > 0 else None
            ),
        }

    def _scan_model_spaces(self) -> list[ModelSpace]:
        """Full-rescan ground truth for the space accountant.

        Metadata-only page scans (no payload decode) over every committed
        model; unreadable or damaged pages are skipped — accounting must
        never turn an I/O hiccup into an open failure (fsck owns damage
        reporting). Uses its own fault site (``page.accounting``) so the
        existing fault-campaign schedules are not perturbed.
        """
        spaces: list[ModelSpace] = []
        for name in self.catalog.names():
            entry = self.catalog.get(name)
            path = self._page_file(entry.page)
            try:
                buf = self.fs.read_bytes(path, site="page.accounting")
                page = read_page_header(buf)
                tensors = tuple(
                    TensorSpace(rec.dim_key, rec.vertex_id, rec.numel,
                                rec.payload_nbytes)
                    for rec in (
                        read_record(page, i, with_payload=False)
                        for i in range(page.n_records)
                    )
                )
            except (OSError, CorruptPageError):
                continue
            spaces.append(ModelSpace(
                name=name,
                page=entry.page,
                page_bytes=len(buf),
                logical_bytes=entry.original_bytes,
                tensors=tensors,
            ))
        return spaces

    def accounting_report(self, tenant_of=None) -> dict:
        """Space-attribution report (see ``repro_torch.obs.accounting``).

        With accounting disabled the report is computed from a one-off
        rescan instead of the (empty) incremental ledger, so the surface
        stays queryable either way. ``tenant_of(name)`` optionally maps a
        model name to its tenant for the per-tenant breakdown.
        """
        with self._lock:
            acct = self._accountant
            if not self.accounting:
                acct = SpaceAccountant()
                acct.reset(self._scan_model_spaces())
            return acct.report(self.catalog.ref_count, tenant_of=tenant_of)

    def accounting_drift(self) -> list[str]:
        """Cross-check the incremental ledger against a fresh rescan.

        Returns one human-readable line per discrepancy (empty = clean).
        This is the fsck ``--accounting`` check: any drift means a commit
        point failed to keep the ledger in step with the store.
        """
        if not self.accounting:
            return []
        with self._lock:
            truth = SpaceAccountant()
            truth.reset(self._scan_model_spaces())
            return self._accountant.diff(truth)

    def model_explain(self, name: str) -> dict:
        """The persisted save-EXPLAIN + current space attribution for one
        model (the ``GET …/models/{name}/explain`` body)."""
        with self._lock:
            entry = self.catalog.get(name)
            if entry is None:
                raise KeyError(name)
            if entry.explain is None:
                # Not in memory (engine reopened since the save): pull
                # the persisted sidecar and cache it on the entry.
                entry.explain = self._load_explain_sidecar(entry.model_id)
            explain = list(entry.explain) if entry.explain else []
            out = {
                "name": name,
                "model_id": entry.model_id,
                "n_tensors": entry.n_tensors,
                "explain": explain,
                # True when the save had more tensors than the catalog
                # persists (EXPLAIN_PERSIST_MAX) or predates EXPLAIN.
                "truncated": len(explain) < entry.n_tensors,
            }
        out["accounting"] = self.accounting_report()["per_model"].get(name)
        return out

    def reconstruct_tensor(self, rec: TensorRecord) -> np.ndarray:
        """Full reconstruction: de-quantized base + de-quantized delta."""
        with self._lock:  # atomic vs vacuum's in-place index compaction
            self._check_quarantine(rec.dim_key)
            index = self.index_cache.get(rec.dim_key)
            base = index.dequantize_vertex(rec.vertex_id)
        delta = dequantize_delta(rec.qdelta, rec.meta)
        return (base + delta).reshape(rec.shape).astype(np.float32)
