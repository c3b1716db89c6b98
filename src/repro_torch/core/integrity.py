"""Storage integrity primitives: typed corruption errors + checksum framing.

NeurStore's pitch is that the database — not the filesystem — owns model
weights, which makes integrity table stakes: one flipped bit in a shared
base tensor silently corrupts every fine-tune that references it. This
module centralizes the on-disk integrity vocabulary the whole stack uses
(see ``docs/durability.md`` for the end-to-end contract):

* **Typed errors.** Every detected-corruption path raises a subclass of
  :class:`IntegrityError`, never a bare ``ValueError``/``struct.error``,
  so callers can distinguish "bad bytes on disk" from programming errors.
  :class:`CorruptPageError` additionally subclasses ``ValueError`` for
  backward compatibility with pre-integrity callers that caught that.
* **CRC32 checksums** (``zlib.crc32`` — detects all single-bit flips and
  any burst ≤ 32 bits). Tensor pages carry per-record checksums plus a
  header-table checksum (``repro_torch.core.pages`` format v3); journal records
  and the ``meta.json`` snapshot embed a ``crc`` field over their own
  canonical JSON; HNSW index files are wrapped in the framed envelope
  below.
* **Index framing.** ``HNSWIndex.to_bytes`` is a pickle — a flipped bit
  can make ``pickle.loads`` return silently wrong vertex codes, which is
  the worst possible failure (every delta decoded against a wrong base).
  :func:`frame_index` prefixes magic + length + CRC so the payload is
  verified *before* it ever reaches the unpickler; legacy unframed files
  (pickle protocol-2 ``b"\\x80"`` prefix) pass through unverified.

The checksum write side is cheap (one CRC pass at memory bandwidth); the
read side is gated by ``StorageEngine(checksums=...)`` so the durability
benchmark can measure the verify overhead honestly.
"""

from __future__ import annotations

import json
import struct
import zlib

__all__ = [
    "IntegrityError",
    "CorruptPageError",
    "CorruptIndexError",
    "CorruptJournalError",
    "CorruptMetaError",
    "ReadOnlyStoreError",
    "crc32",
    "frame_index",
    "unframe_index",
    "journal_line",
    "parse_journal_record",
    "meta_payload",
    "parse_meta",
]


class IntegrityError(RuntimeError):
    """Base for every detected storage-corruption / degraded-store error."""


class CorruptPageError(IntegrityError, ValueError):
    """A tensor page failed its checksum, framing, or bounds checks.

    Also raised when loading a model the catalog has quarantined
    (``status="corrupt"``). Subclasses ``ValueError`` so pre-integrity
    callers that caught the old parse errors keep working.
    """


class CorruptIndexError(IntegrityError):
    """An HNSW index file failed its frame checksum or did not parse."""


class CorruptJournalError(IntegrityError):
    """The write-ahead journal is corrupt *before* its tail.

    A torn final record is normal (crash mid-append) and is truncated
    silently; a bad record followed by a good one means the journal body
    itself is damaged and replay would be unsound — the engine degrades
    to read-only instead of guessing.
    """


class CorruptMetaError(IntegrityError):
    """``meta.json`` (and its ``.prev`` fallback, if any) failed its CRC."""


class ReadOnlyStoreError(IntegrityError):
    """A write was attempted on a store degraded to read-only mode."""


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# ------------------------------------------------------------- index framing
_INDEX_MAGIC = b"NSIX"
_INDEX_HDR = struct.Struct("<4sHQI")  # magic, version, payload_len, crc32
_INDEX_VERSION = 1


def frame_index(payload: bytes) -> bytes:
    """Wrap serialized index bytes in a magic + length + CRC envelope."""
    return _INDEX_HDR.pack(
        _INDEX_MAGIC, _INDEX_VERSION, len(payload), crc32(payload)
    ) + payload


def unframe_index(buf: bytes, path: str = "<index>") -> bytes:
    """Verify and strip an index frame; legacy raw pickles pass through.

    Raises :class:`CorruptIndexError` on a bad frame, truncated payload,
    or CRC mismatch — the payload never reaches ``pickle.loads`` unless
    it is byte-exact what was written.
    """
    if not buf.startswith(_INDEX_MAGIC):
        if buf[:1] == b"\x80":  # legacy unframed pickle (pre-integrity store)
            return buf
        raise CorruptIndexError(f"{path}: not a NeurStore index file")
    try:
        _magic, version, length, crc = _INDEX_HDR.unpack_from(buf, 0)
    except struct.error as exc:
        raise CorruptIndexError(f"{path}: truncated index frame") from exc
    if version != _INDEX_VERSION:
        raise CorruptIndexError(f"{path}: unsupported index frame v{version}")
    payload = buf[_INDEX_HDR.size:]
    if len(payload) != length:
        raise CorruptIndexError(
            f"{path}: torn index file ({len(payload)} of {length} payload bytes)"
        )
    if crc32(payload) != crc:
        raise CorruptIndexError(f"{path}: index payload checksum mismatch")
    return payload


# ----------------------------------------------------------- journal records
def _record_crc(record: dict) -> str:
    body = {k: v for k, v in record.items() if k != "crc"}
    return f"{crc32(json.dumps(body, sort_keys=True).encode()):08x}"


def journal_line(record: dict) -> str:
    """Serialize one journal record with an embedded self-CRC.

    The ``crc`` field covers the canonical (sorted-keys) JSON of every
    other field, so the line stays plain parseable JSONL — tools and
    tests that ``json.loads`` each line keep working unchanged.
    """
    rec = {k: v for k, v in record.items() if k != "crc"}
    rec["crc"] = _record_crc(rec)
    return json.dumps(rec, sort_keys=True) + "\n"


def parse_journal_record(line: str) -> dict:
    """Parse + verify one journal line; raises ``ValueError`` on any damage.

    Legacy records without a ``crc`` field (pre-integrity stores) are
    accepted unverified. Callers decide torn-tail-vs-corrupt-body from
    *where* the bad line sits, so this deliberately raises plain
    ``ValueError`` (which ``json.JSONDecodeError`` already subclasses).
    """
    rec = json.loads(line)
    if not isinstance(rec, dict):
        raise ValueError("journal record is not an object")
    if "crc" in rec and rec["crc"] != _record_crc(rec):
        raise ValueError("journal record checksum mismatch")
    return rec


# ------------------------------------------------------------- meta snapshot
_META_FORMAT = 3


def meta_payload(state: dict) -> str:
    """Serialize the catalog snapshot with an embedded integrity stamp.

    The stamp rides as a top-level ``integrity`` key so the file stays a
    plain state dict (``meta["models"]`` etc. work as before); its CRC
    covers the canonical JSON of everything else.
    """
    body = {k: v for k, v in state.items() if k != "integrity"}
    crc = f"{crc32(json.dumps(body, sort_keys=True).encode()):08x}"
    body["integrity"] = {"format": _META_FORMAT, "crc": crc}
    return json.dumps(body)


def parse_meta(text: str, path: str = "meta.json") -> dict:
    """Parse + verify a catalog snapshot; legacy unstamped files pass.

    Raises :class:`CorruptMetaError` on JSON damage or CRC mismatch.
    """
    try:
        state = json.loads(text)
    except json.JSONDecodeError as exc:
        raise CorruptMetaError(f"{path}: does not parse: {exc}") from exc
    if not isinstance(state, dict):
        raise CorruptMetaError(f"{path}: not a snapshot object")
    stamp = state.pop("integrity", None)
    if stamp is not None:
        crc = f"{crc32(json.dumps(state, sort_keys=True).encode()):08x}"
        if stamp.get("crc") != crc:
            raise CorruptMetaError(f"{path}: snapshot checksum mismatch")
    return state
