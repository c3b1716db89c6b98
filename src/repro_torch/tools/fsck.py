"""Offline checker / repairer for a NeurStore store directory.

The port of the reference's ``tools/fsck.py``: the same checks, repairs,
report, output text and exit status, on ``repro_torch``'s catalog, pages,
index parser and engine. Stores are shared between the packages, so either
fsck checks and repairs a store written by either.

Check phase (read-only, no engine): verifies the ``meta.json`` snapshot
CRC (and the ``.prev`` fallback), classifies journal damage (torn tail vs
corrupt body), verifies every model page's framing + per-record checksums,
verifies every HNSW index file's frame CRC + deserialization (parsed on
the CPU, as the engine's ``scrub`` does, so no index is uploaded to the
card), cross-checks the ``vertex_refs`` table against the references
actually present in healthy committed pages, and flags dangling base
references and orphan files. ``errors`` are integrity violations;
``warnings`` are survivable states the engine handles itself (pending
transactions, quarantined models, orphans awaiting the open-time sweep).

Repair phase (``--repair``): promotes ``meta.json.prev`` over a corrupt
``meta.json`` (the damaged file is kept as ``meta.json.corrupt``), sets
aside a body-corrupt journal, then opens a :class:`StorageEngine` on
``--device`` — which replays pending transactions, truncates any torn
journal tail and sweeps orphans — and runs ``verify_store(quarantine=True)``
so damaged models are quarantined in the catalog. With ``--drop-corrupt``
the quarantined models are deleted, corrupt index files they referenced
are removed, and the reference table is rebuilt wholesale from the
surviving pages. ``--accounting`` opens an engine on ``--device`` too.

``--device`` (default ``cuda``) is where the engines of ``--repair`` and
``--accounting`` run; without a card the tool exits with the engine's
error unless given ``--device cpu``.

Exit status: 0 if the store is clean (no errors; warnings allowed), 1
otherwise. See ``docs/durability.md`` for the corruption contract.

    python -m repro_torch.tools.fsck STORE [--repair [--drop-corrupt]] [--accounting]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ..core.catalog import (
    STATUS_COMMITTED,
    STATUS_CORRUPT,
    CatalogState,
    read_journal,
)
from ..core.engine import StorageEngine
from ..core.hnsw import HNSWIndex
from ..core.integrity import (
    CorruptMetaError,
    CorruptPageError,
    parse_meta,
    unframe_index,
)
from ..core.pages import page_dim_keys, read_record, verify_page
from ..kernels.ops import resolve_device

__all__ = ["fsck"]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# Pages are read and verified this many at a time, on threads (file reads
# and zlib's CRC release the GIL), ahead of the check's walk in catalog
# order: the report is the one a page-by-page walk gives.
_PAGE_WORKERS = 4


def _verify(path: str):
    """``(page, None)`` for a page that verifies, ``(None, error)`` for a
    missing or corrupt one."""
    try:
        return verify_page(_read(path)), None
    except (FileNotFoundError, CorruptPageError) as exc:
        return None, exc


def _verified_pages(pool: ThreadPoolExecutor, paths: list[str]):
    """``_verify`` of each path, in order, at most ``_PAGE_WORKERS`` ahead."""
    ahead: deque = deque()
    for path in paths:
        ahead.append(pool.submit(_verify, path))
        if len(ahead) >= _PAGE_WORKERS:
            yield ahead.popleft().result()
    while ahead:
        yield ahead.popleft().result()


def _load_meta(root: str, rep: dict) -> CatalogState | None:
    """Parse meta.json (or its .prev fallback), recording errors/warnings."""
    meta = os.path.join(root, "meta.json")
    prev = meta + ".prev"
    primary: str | None = None
    if os.path.exists(meta):
        try:
            return CatalogState.from_dict(
                parse_meta(_read(meta).decode("utf-8"), meta)
            )
        except (CorruptMetaError, UnicodeDecodeError) as exc:
            primary = f"meta.json corrupt: {exc}"
    elif os.path.exists(prev):
        primary = "meta.json missing but meta.json.prev exists"
    else:
        return CatalogState()  # fresh/empty store
    try:
        state = CatalogState.from_dict(
            parse_meta(_read(prev).decode("utf-8"), prev)
        )
        rep["warnings"].append(f"{primary} — last good snapshot (.prev) usable")
        return state
    except (OSError, CorruptMetaError, UnicodeDecodeError) as exc:
        rep["errors"].append(f"{primary}; fallback unusable: {exc}")
        return None


def _check(root: str, rep: dict) -> None:
    state = _load_meta(root, rep)
    if state is None:
        return  # nothing else is trustworthy without a catalog

    records, _max_tx, torn, corrupt = read_journal(
        os.path.join(root, "journal.jsonl")
    )
    if corrupt is not None:
        rep["errors"].append(f"journal body corrupt: {corrupt}")
    elif torn is not None:
        rep["warnings"].append(
            f"torn journal tail at byte {torn} (truncated at next open)"
        )
    pending = {
        int(r.get("tx", 0)) for r in records if r.get("op") != "commit"
    } - {int(r.get("tx", 0)) for r in records if r.get("op") == "commit"}
    if pending:
        rep["warnings"].append(
            f"{len(pending)} pending transaction(s) (replayed at next open)"
        )

    # Index files: frame CRC + deserialization, a parse check on the CPU.
    indexes: dict[int, HNSWIndex] = {}
    bad_dims: set[int] = set()
    index_dir = os.path.join(root, "index")
    for fname in sorted(os.listdir(index_dir)) if os.path.isdir(index_dir) else []:
        if not (fname.startswith("hnsw_") and fname.endswith(".idx")):
            continue
        dim = int(fname[len("hnsw_"):-len(".idx")])
        path = os.path.join(index_dir, fname)
        try:
            indexes[dim] = HNSWIndex.from_bytes(unframe_index(_read(path), path),
                                                device="cpu")
        except Exception as exc:
            rep["errors"].append(f"index {fname} corrupt: {exc}")
            bad_dims.add(dim)

    # Model pages: framing + per-record CRCs; derive refs from healthy ones.
    derived: dict[str, int] = {}
    referenced_pages: set[str] = set()
    models = sorted(state.models.items())
    with ThreadPoolExecutor(_PAGE_WORKERS) as pool:
        verified = _verified_pages(pool, [
            os.path.join(root, "pages", entry.page)
            for _, entry in models if entry.status == STATUS_COMMITTED])
        for name, entry in models:
            referenced_pages.add(entry.page)
            if entry.status == STATUS_CORRUPT:
                rep["warnings"].append(f"model {name!r} is quarantined")
                continue
            if entry.status != STATUS_COMMITTED:
                rep["warnings"].append(
                    f"model {name!r} has status {entry.status!r} "
                    "(rolled back at next open)"
                )
                continue
            page, exc = next(verified)
            if isinstance(exc, FileNotFoundError):
                rep["errors"].append(f"model {name!r}: page {entry.page} missing")
                continue
            if exc is not None:
                rep["errors"].append(
                    f"model {name!r}: page {entry.page} corrupt: {exc}"
                )
                continue
            dims = page_dim_keys(page)
            broken = sorted(dims & bad_dims)
            if broken:
                rep["errors"].append(
                    f"model {name!r} references corrupt index dim(s) {broken}"
                )
            for i in range(page.n_records):
                r = read_record(page, i, with_payload=False)
                key = f"{r.dim_key}:{r.vertex_id}"
                derived[key] = derived.get(key, 0) + 1
                idx = indexes.get(r.dim_key)
                if r.dim_key in bad_dims:
                    continue
                if idx is None:
                    rep["errors"].append(
                        f"model {name!r} references dim {r.dim_key} "
                        "but no index file exists"
                    )
                elif not (0 <= r.vertex_id < len(idx)) or idx.is_deleted(r.vertex_id):
                    rep["errors"].append(
                        f"model {name!r}: dangling base reference "
                        f"{r.dim_key}:{r.vertex_id}"
                    )

    # Reference table vs derived. Quarantined models and pending
    # transactions legitimately leave the table a superset (their records
    # are uncounted above); missing references are always an error.
    loose = bool(state.models) and (
        any(e.status != STATUS_COMMITTED for e in state.models.values())
        or bool(pending)
    )
    for key, count in sorted(derived.items()):
        have = int(state.vertex_refs.get(key, 0))
        if have < count:
            rep["errors"].append(
                f"vertex_refs[{key}] = {have} < {count} live references"
            )
    extra = {
        k: int(v) for k, v in state.vertex_refs.items()
        if int(v) > derived.get(k, 0)
    }
    if extra:
        msg = f"{len(extra)} leaked vertex reference(s) (e.g. {next(iter(sorted(extra)))})"
        if loose:
            rep["warnings"].append(msg + " — expected with pending/quarantined state")
        else:
            rep["warnings"].append(msg + " — rebuild with --repair --drop-corrupt")

    # Orphan files (the engine sweeps these at open).
    pages_dir = os.path.join(root, "pages")
    for fname in sorted(os.listdir(pages_dir)) if os.path.isdir(pages_dir) else []:
        if fname not in referenced_pages:
            rep["warnings"].append(
                f"orphan page file {fname} (swept at next open)"
            )


def _repair(root: str, rep: dict, drop_corrupt: bool, device="cuda") -> None:
    actions = rep["actions"]
    meta = os.path.join(root, "meta.json")
    prev = meta + ".prev"

    def _meta_ok(path: str) -> bool:
        try:
            parse_meta(_read(path).decode("utf-8"), path)
            return True
        except (OSError, CorruptMetaError, UnicodeDecodeError):
            return False

    if not _meta_ok(meta):
        if not _meta_ok(prev):
            return  # unrecoverable — leave every byte for forensics
        if os.path.exists(meta):
            os.replace(meta, meta + ".corrupt")
            actions.append("kept damaged snapshot as meta.json.corrupt")
        with open(meta, "wb") as f:
            f.write(_read(prev))
            f.flush()
            os.fsync(f.fileno())
        actions.append("promoted meta.json.prev over corrupt meta.json")

    journal = os.path.join(root, "journal.jsonl")
    _records, _max_tx, _torn, corrupt = read_journal(journal)
    if corrupt is not None:
        os.replace(journal, journal + ".corrupt")
        actions.append("set aside body-corrupt journal as journal.jsonl.corrupt")

    # Opening the engine replays pending transactions, truncates a torn
    # journal tail, and sweeps orphan files.
    eng = StorageEngine(root, device=device)
    try:
        verdict = eng.verify_store(quarantine=True)
        if verdict["quarantined"]:
            actions.append(
                f"quarantined corrupt model(s): {sorted(verdict['quarantined'])}"
            )
        if drop_corrupt:
            dropped = eng.drop_corrupt_models()
            if dropped:
                actions.append(f"dropped corrupt model(s): {sorted(dropped)}")
            for dim, status in verdict["indexes"].items():
                if not str(status).startswith("corrupt"):
                    continue
                path = eng.index_cache._path(dim)
                if os.path.exists(path):
                    os.unlink(path)
                    actions.append(f"removed corrupt index hnsw_{dim}.idx")
            eng.rebuild_vertex_refs()
            actions.append("rebuilt vertex reference table from pages")
    finally:
        eng.close()


def _check_accounting(root: str, rep: dict, engine=None, device="cuda") -> None:
    """Cross-check the incremental :class:`SpaceAccountant` against the
    full-rescan verifier; every drift line is a check *failure*.

    With ``engine`` given (a live ``StorageEngine``), its in-memory
    ledger — maintained incrementally at every commit point — is diffed
    against a fresh page rescan. Without one, a temporary engine is
    opened on ``device`` (whose open-time seed IS the rescan, so this
    degenerates to verifying the rescan is internally reproducible, e.g.
    that no page mutates between two reads).
    """
    own = engine is None
    if own:
        engine = StorageEngine(root, device=device)
    try:
        rep["errors"].extend(engine.accounting_drift())
    finally:
        if own:
            engine.close()


def fsck(root: str, repair: bool = False, drop_corrupt: bool = False,
         accounting: bool = False, device="cuda") -> dict:
    """Check (and optionally repair) the store at ``root``.

    Returns ``{"root", "errors", "warnings", "actions", "clean"}`` —
    ``clean`` means no errors (warnings allowed). With ``repair=True``
    the report reflects a fresh re-check *after* the repair actions.
    ``accounting=True`` additionally diffs the incremental space
    accountant against a full page rescan (drift = error). ``device``
    (default ``"cuda"``, which raises without a card) is where the
    engines of the repair and the accounting check run.
    """
    device = resolve_device(device)
    rep: dict = {"root": root, "errors": [], "warnings": [], "actions": []}
    _check(root, rep)
    if repair:
        _repair(root, rep, drop_corrupt, device)
        rep["errors"], rep["warnings"] = [], []
        _check(root, rep)
    if accounting:
        _check_accounting(root, rep, device=device)
    rep["clean"] = not rep["errors"]
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.fsck",
        description="Check / repair a NeurStore store"
    )
    ap.add_argument("root", help="store directory (contains meta.json)")
    ap.add_argument("--repair", action="store_true",
                    help="repair what is safely repairable")
    ap.add_argument("--drop-corrupt", action="store_true",
                    help="with --repair: delete quarantined models and "
                         "rebuild the reference table")
    ap.add_argument("--accounting", action="store_true",
                    help="cross-check the incremental space accountant "
                         "against a full page rescan (drift = failure)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines of --repair and --accounting run")
    args = ap.parse_args(argv)
    rep = fsck(args.root, repair=args.repair, drop_corrupt=args.drop_corrupt,
               accounting=args.accounting, device=args.device)
    if args.as_json:
        print(json.dumps(rep, indent=2))
    else:
        for kind in ("errors", "warnings", "actions"):
            for line in rep[kind]:
                print(f"{kind[:-1]}: {line}")
        print("clean" if rep["clean"] else "NOT clean")
    return 0 if rep["clean"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
