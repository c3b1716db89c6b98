"""Transactional model catalog — typed metadata + write-ahead journal.

The catalog is the database half of the storage engine: it owns the model
table (name → :class:`ModelEntry`), the monotonic model-id counter, and the
``vertex_refs`` reference counts that tie tensor-page records to HNSW base
vertices. It replaces the seed's untyped ``_meta`` dict-poking with typed
records plus a crash-recovery protocol (DLRDB/MorphingDB treat model
insert/update/drop as first-class transactional operations; so do we).

Durability model
----------------

* **Snapshot** — ``meta.json`` is the authoritative catalog state, written
  atomically via ``os.replace``. A model exists iff its committed entry is
  in the snapshot; ``vertex_refs`` live in the same snapshot, so a model's
  entry and its reference counts commit in one atomic step. The file format
  is a superset of the seed's ``meta.json`` (old stores load unchanged).
* **Journal** — ``journal.jsonl`` is a write-ahead intent log. Every
  lifecycle operation appends an *intent* record (fsync'd) **before** any
  page/index side effect, and a ``commit`` record after the snapshot has
  been replaced and all side effects are durable. On open,
  :meth:`Catalog.pending` returns intents with no commit record; the engine
  replays them — rolling an interrupted operation forward (snapshot already
  switched) or back (snapshot untouched), so a crash at any point leaves no
  orphan pages and no dangling ``vertex_refs``. Commits remove only their
  own transaction's records, so an operation that failed *in-process*
  (exception, not crash) keeps its recovery records pending until the next
  open replays them.

Record shapes (all JSON, one object per line; see ``docs/lifecycle.md``):

* ``{"tx", "op": "save",    "name", "id", "page", "new_vertices"}``
* ``{"tx", "op": "delete",  "name", "id", "page", "refs"}``
* ``{"tx", "op": "replace", "name", "id", "page", "new_vertices",
  "old_id", "old_page", "old_refs"}``
* ``{"tx", "op": "save_batch", "models": [{"name", "id", "page"[,
  "old_id", "old_page", "old_refs"]}, …], "new_vertices"}``
* ``{"tx", "op": "vacuum",        "dim", "pages"}``
* ``{"tx", "op": "vacuum_switch", "dim", "index", "pages", "refs"}``
* ``{"tx", "op": "commit"}``

``refs``/``old_refs`` are ``[[dim, vertex_id, count], …]`` (the references
the model held); ``new_vertices`` is ``[[dim, vertex_id], …]`` (vertices
first created by the interrupted save). ``vacuum_switch.refs`` is the full
post-remap ``{vertex_id: count}`` map for the dim, recorded wholesale so
roll-forward replay is idempotent. ``save_batch`` (``save_models``) commits
every listed model through ONE snapshot replace — replay is all-or-nothing
across the batch, keyed off the first member's presence in the snapshot.

Fault injection: tests add point names to :data:`FAILPOINTS`;
:func:`maybe_fail` raises :class:`InjectedCrash` at matching points inside
the engine's lifecycle operations, simulating a crash between any two
protocol steps. The I/O layer below those steps is additionally faultable
through :class:`~repro_torch.core.faultfs.FaultFS` — all catalog file access
routes through the engine's shim instance.

Integrity (this layer's additions — see ``docs/durability.md``):

* every journal record embeds a self-CRC (``integrity.journal_line``) and
  ``meta.json`` carries a whole-snapshot CRC stamp, both verified on read;
* a contiguous *suffix* of damaged journal lines is a torn tail (crash
  mid-append) — tolerated by :meth:`Catalog.pending` and physically
  truncated by :meth:`Catalog.recover_journal` at open; a damaged record
  *followed by a valid one* means the journal body is corrupt and raises
  :class:`~repro_torch.core.integrity.CorruptJournalError` (the engine degrades
  to read-only rather than replay guesses);
* :meth:`Catalog.save_snapshot` first copies the current ``meta.json`` to
  ``meta.json.prev`` (durable) before replacing it, so a snapshot that is
  later found corrupt can fall back to the last good one (read-only).
"""

from __future__ import annotations

import dataclasses
import json
import os

from .faultfs import FaultFS
from .integrity import (
    CorruptJournalError,
    CorruptMetaError,
    journal_line,
    meta_payload,
    parse_journal_record,
    parse_meta,
)

__all__ = [
    "Catalog",
    "CatalogState",
    "EXPLAIN_FIELDS",
    "InjectedCrash",
    "ModelEntry",
    "explain_pack",
    "explain_unpack",
    "STATUS_COMMITTED",
    "STATUS_PENDING",
    "STATUS_CORRUPT",
    "FAILPOINTS",
    "maybe_fail",
    "read_journal",
]

STATUS_COMMITTED = "committed"
STATUS_PENDING = "pending"
STATUS_CORRUPT = "corrupt"

# ------------------------------------------------------------ fault injection
FAILPOINTS: set[str] = set()


class InjectedCrash(RuntimeError):
    """Raised by :func:`maybe_fail` to simulate a crash mid-transaction."""


def maybe_fail(point: str) -> None:
    if point in FAILPOINTS:
        raise InjectedCrash(point)


# Persisted EXPLAIN row layout (the engine's per-model sidecar files —
# deliberately NOT part of meta.json, whose snapshot is re-serialized
# and fsynced at every commit and must not grow with EXPLAIN). Entries
# are stored as fixed-order rows (no repeated keys) with floats trimmed
# to 6 significant digits — about 3x smaller/faster to dump than the
# verbose per-tensor dicts the engine hands out.
EXPLAIN_FIELDS = (
    "tensor", "dim", "vertex_id", "outcome", "probe_distance",
    "delta_range", "tau", "nbit", "delta_bytes", "error_bound",
)


def _trim(v):
    return float(f"{v:.6g}") if isinstance(v, float) else v


def explain_pack(entries: list) -> list:
    return [[_trim(e.get(k)) for k in EXPLAIN_FIELDS] for e in entries]


def explain_unpack(rows) -> list | None:
    if rows is None:
        return None
    return [dict(zip(EXPLAIN_FIELDS, row)) for row in rows]


# ------------------------------------------------------------- typed records
@dataclasses.dataclass
class ModelEntry:
    """One catalog row: a stored model and where its page lives."""

    model_id: int
    name: str
    architecture: dict
    page: str
    n_tensors: int
    original_bytes: int
    status: str = STATUS_COMMITTED
    # Bounded per-tensor save EXPLAIN (first EXPLAIN_PERSIST_MAX tensors,
    # see engine.py): how each tensor was stored — matched vertex, probe
    # distance vs tau, dedup outcome, delta bit-width/bytes. In-memory
    # only: the durable copy lives in the engine's per-model sidecar
    # file (explain/model_<id>.json), never in the snapshot — meta.json
    # is rewritten+fsynced per commit and must stay O(models), not
    # O(models × tensors). None when accounting is disabled and on
    # entries loaded from disk until the sidecar is read.
    explain: list | None = None

    def __getitem__(self, key: str):
        # Legacy dict-style access ("id", "page", ...) for pre-catalog callers.
        if key == "id":
            return self.model_id
        return getattr(self, key)

    def to_dict(self) -> dict:
        out = {
            "id": self.model_id,
            "architecture": self.architecture,
            "page": self.page,
            "n_tensors": self.n_tensors,
            "original_bytes": self.original_bytes,
            "status": self.status,
        }
        return out

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "ModelEntry":
        return cls(
            model_id=int(d["id"]),
            name=name,
            architecture=d.get("architecture", {}),
            page=d["page"],
            n_tensors=int(d.get("n_tensors", 0)),
            original_bytes=int(d.get("original_bytes", 0)),
            # Seed-format entries carry no status: they were only ever
            # written after a completed save, i.e. committed.
            status=d.get("status", STATUS_COMMITTED),
        )


@dataclasses.dataclass
class CatalogState:
    """In-memory catalog: model table, id counter, vertex reference counts.

    ``epoch`` is the snapshot-isolation clock: every committed snapshot
    carries a strictly increasing epoch, bumped by :meth:`Catalog.save_snapshot`
    at the writer's atomic ``meta.json`` commit point. Readers stamp the
    epoch into their :class:`~repro_torch.core.loader.ModelSnapshot` at load time
    and never consult shared catalog state again (seed-format stores load
    at epoch 0).
    """

    models: dict[str, ModelEntry] = dataclasses.field(default_factory=dict)
    next_id: int = 0
    vertex_refs: dict[str, int] = dataclasses.field(default_factory=dict)
    epoch: int = 0

    def to_dict(self) -> dict:
        return {
            "models": {n: e.to_dict() for n, e in self.models.items()},
            "next_id": self.next_id,
            "vertex_refs": self.vertex_refs,
            "epoch": self.epoch,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CatalogState":
        return cls(
            models={
                n: ModelEntry.from_dict(n, e)
                for n, e in d.get("models", {}).items()
            },
            next_id=int(d.get("next_id", 0)),
            vertex_refs={k: int(v) for k, v in d.get("vertex_refs", {}).items()},
            epoch=int(d.get("epoch", 0)),
        )


def _ref_key(dim: int, vid: int) -> str:
    return f"{dim}:{vid}"


def read_journal(path: str) -> tuple[list[dict], int, int | None, str | None]:
    """Parse + verify a journal file without mutating anything.

    Returns ``(records, max_tx, torn_offset, corrupt_reason)``: the valid
    records in file order, the highest tx id seen, the byte offset where a
    torn tail starts (``None`` if the file ends cleanly), and a reason
    string when a damaged record *precedes* a valid one (body corruption —
    replay would be unsound). Appends only ever damage the tail, so any
    contiguous damaged suffix is classified as torn.
    """
    if not os.path.exists(path):
        return [], 0, None, None
    with open(path, "rb") as f:
        raw = f.read()
    records: list[dict] = []
    max_tx = 0
    bad_offset: int | None = None
    corrupt: str | None = None
    pos = 0
    for chunk in raw.split(b"\n"):
        start = pos
        pos += len(chunk) + 1
        if not chunk.strip():
            continue
        try:
            rec = parse_journal_record(chunk.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            if bad_offset is None:
                bad_offset = start
            continue
        if bad_offset is not None and corrupt is None:
            corrupt = (
                f"damaged record at byte {bad_offset} precedes a valid record"
            )
        records.append(rec)
        max_tx = max(max_tx, int(rec.get("tx", 0)))
    return records, max_tx, bad_offset, corrupt


def _group_pending(records: list[dict]) -> list[list[dict]]:
    groups: dict[int, list[dict]] = {}
    committed: set[int] = set()
    for rec in records:
        tx = int(rec.get("tx", 0))
        if rec.get("op") == "commit":
            committed.add(tx)
        else:
            groups.setdefault(tx, []).append(rec)
    return [recs for tx, recs in sorted(groups.items()) if tx not in committed]


class Catalog:
    """Snapshot + journal manager. All mutation goes through the engine lock."""

    def __init__(self, root: str, fs: FaultFS | None = None):
        self.root = root
        self.fs = fs if fs is not None else FaultFS()
        self.meta_path = os.path.join(root, "meta.json")
        self.prev_path = self.meta_path + ".prev"
        self.journal_path = os.path.join(root, "journal.jsonl")
        self.state = CatalogState()
        # Set when meta.json was corrupt and state came from meta.json.prev
        # — the engine must degrade to read-only (the view may be stale).
        self.meta_fallback: str | None = None
        self._load_state()
        self._next_tx = 1

    def _load_state(self) -> None:
        if os.path.exists(self.meta_path):
            try:
                self.state = CatalogState.from_dict(parse_meta(
                    self.fs.read_text(self.meta_path, site="meta.read"),
                    self.meta_path,
                ))
                return
            except (CorruptMetaError, UnicodeDecodeError) as exc:
                # A bit flip can damage the UTF-8 encoding itself before
                # the CRC is even consulted — same corruption, same path.
                primary: Exception = exc
        elif os.path.exists(self.prev_path):
            primary = CorruptMetaError(
                f"{self.meta_path}: missing, but a prev snapshot exists"
            )
        else:
            return  # fresh store
        try:
            self.state = CatalogState.from_dict(parse_meta(
                self.fs.read_text(self.prev_path, site="meta.read_prev"),
                self.prev_path,
            ))
        except (CorruptMetaError, UnicodeDecodeError, OSError) as exc:
            raise CorruptMetaError(
                f"catalog unrecoverable: {primary}; fallback failed: {exc}"
            ) from exc
        self.meta_fallback = str(primary)

    # ----------------------------------------------------------- model table
    def get(self, name: str) -> ModelEntry | None:
        return self.state.models.get(name)

    def names(self, committed_only: bool = True) -> list[str]:
        if not committed_only:
            return list(self.state.models)
        return [
            n for n, e in self.state.models.items()
            if e.status == STATUS_COMMITTED
        ]

    def corrupt_names(self) -> list[str]:
        """Models quarantined after failing an integrity check."""
        return [
            n for n, e in self.state.models.items()
            if e.status == STATUS_CORRUPT
        ]

    def allocate_id(self) -> int:
        mid = self.state.next_id
        self.state.next_id = mid + 1
        return mid

    # ------------------------------------------------------- reference counts
    def ref_count(self, dim: int, vid: int) -> int:
        return self.state.vertex_refs.get(_ref_key(dim, vid), 0)

    def ref(self, dim: int, vid: int, delta: int = 1) -> int:
        key = _ref_key(dim, vid)
        refs = self.state.vertex_refs
        n = refs.get(key, 0) + delta
        if n > 0:
            refs[key] = n
        else:
            refs.pop(key, None)
        return n

    def refs_for_dim(self, dim: int) -> dict[int, int]:
        prefix = f"{dim}:"
        return {
            int(k[len(prefix):]): v
            for k, v in self.state.vertex_refs.items()
            if k.startswith(prefix)
        }

    def set_dim_refs(self, dim: int, refs: dict[int, int]) -> None:
        """Replace every ref for ``dim`` wholesale (idempotent vacuum replay)."""
        prefix = f"{dim}:"
        table = self.state.vertex_refs
        for k in [k for k in table if k.startswith(prefix)]:
            del table[k]
        for vid, count in refs.items():
            if int(count) > 0:
                table[_ref_key(dim, int(vid))] = int(count)

    # --------------------------------------------------------------- snapshot
    def save_snapshot(self) -> None:
        """Atomically persist the catalog state — the transaction commit point.

        Bumps the snapshot-isolation epoch: every commit is a new epoch,
        so a reader that captured its view before this call is observably
        older than one opened after it.

        Before replacing ``meta.json`` the current bytes are copied to
        ``meta.json.prev`` (durably, best-effort), so a later corruption
        of the live snapshot degrades to last-good read-only instead of
        an unopenable store. The new snapshot carries a whole-file CRC
        stamp (``integrity.meta_payload``).
        """
        self.state.epoch += 1
        if os.path.exists(self.meta_path):
            try:
                prev = self.fs.read_bytes(self.meta_path, site="meta.read")
            except OSError:
                prev = None
            if prev is not None:
                try:
                    self.fs.write_durable(self.prev_path, prev, site="meta.prev")
                except OSError:
                    pass  # fallback copy is best-effort; the commit is not
        tmp = self.meta_path + ".tmp"
        payload = meta_payload(self.state.to_dict()).encode("utf-8")
        self.fs.write_durable(tmp, payload, site="meta.tmp")
        self.fs.replace(tmp, self.meta_path, site="meta.replace")

    def snapshot_dict(self) -> dict:
        """Legacy ``_meta``-shaped read-only view of the catalog state."""
        return self.state.to_dict()

    # ---------------------------------------------------------------- journal
    def _append(self, record: dict) -> None:
        self.fs.append_durable(
            self.journal_path, journal_line(record), site="journal.append"
        )

    def begin(self, record: dict) -> int:
        """Append a write-intent record; returns its transaction id."""
        tx = self._next_tx
        self._next_tx += 1
        self._append({"tx": tx, **record})
        return tx

    def log(self, tx: int, record: dict) -> None:
        """Append a follow-up record (e.g. ``vacuum_switch``) for ``tx``."""
        self._append({"tx": tx, **record})

    def commit_tx(self, tx: int) -> None:
        """Mark ``tx`` durable and drop its records from the journal.

        Only committed transactions are removed: an earlier transaction
        that *failed in-process* (exception, not crash) can leave a
        pending intent — or a pending ``vacuum_switch`` roll-forward
        record — that must survive until the next open replays it.
        Truncating the whole file here would erase that recovery state.
        """
        self._append({"tx": tx, "op": "commit"})
        remaining = self.pending()
        if not remaining:
            self.truncate_journal()
            return
        tmp = self.journal_path + ".tmp"
        buf = "".join(
            journal_line(rec) for group in remaining for rec in group
        )
        self.fs.write_durable(tmp, buf.encode("utf-8"), site="journal.rewrite")
        self.fs.replace(tmp, self.journal_path, site="journal.replace")

    def truncate_journal(self) -> None:
        self.fs.write_durable(self.journal_path, b"", site="journal.clear")

    def pending(self) -> list[list[dict]]:
        """Uncommitted transactions from the journal, oldest first.

        Each element is the ordered list of records sharing one ``tx`` (a
        vacuum contributes up to two: intent + switch). A torn tail (crash
        mid-append) is tolerated — the damaged intent never became durable,
        so by protocol nothing after it happened; :meth:`recover_journal`
        additionally truncates it at open. Damage *before* a valid record
        raises :class:`CorruptJournalError`.
        """
        records, max_tx, _torn, corrupt = read_journal(self.journal_path)
        if corrupt is not None:
            raise CorruptJournalError(f"{self.journal_path}: {corrupt}")
        self._next_tx = max(self._next_tx, max_tx + 1)
        return _group_pending(records)

    def recover_journal(self) -> list[list[dict]]:
        """Open-time journal read: truncate any torn tail, return pending.

        The physical truncation keeps a later reader (or a tool reading
        the raw file) from re-classifying the same damage, and is safe by
        protocol: a record that never fully hit disk never had durable
        side effects. Body corruption raises :class:`CorruptJournalError`
        — the caller must degrade to read-only, not replay.
        """
        records, max_tx, torn, corrupt = read_journal(self.journal_path)
        if corrupt is not None:
            raise CorruptJournalError(f"{self.journal_path}: {corrupt}")
        if torn is not None:
            self.fs.truncate(self.journal_path, torn, site="journal.repair")
        self._next_tx = max(self._next_tx, max_tx + 1)
        return _group_pending(records)
