"""Tensor pages — NeurStore's on-disk unit for compressed tensors (paper §5).

Layout (paper §5, kept byte-faithful in spirit):

* a tensor page holds the complete set of compressed tensors of one model;
* a fixed-length header records offsets and lengths of all delta tensors;
* each record keeps metadata — name, shape, reference to its base tensor
  (index dim + HNSW vertex id), quantization parameters (scale, zero point),
  single-element bit width — followed by a bit-packed payload.

Payloads are stored **planar MSB-first** (see ``bitpack.pack_bits_planar``)
so flexible loading can read only the top ``b`` bit-planes of each tensor —
the storage-level realization of paper §4.3.1.

Pages are read-only once written (paper §5) and addressed by ``bytes`` /
``memoryview`` slicing, the library analogue of the paper's ``mmap``.

Format v3 (this layer) adds integrity framing: each offset-table entry
carries a CRC32 of its record bytes, and the header + table are sealed by
a table CRC, so a single flipped bit or torn write anywhere in the page is
detected (:func:`verify_page`) instead of decoding into silently wrong
deltas. v2 pages (pre-integrity stores) still read; parse damage raises
:class:`~repro_torch.core.integrity.CorruptPageError`, never a bare
``ValueError``/``struct.error``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .bitpack import pack_bits_planar, planar_plane_bytes, unpack_bits_planar
from .integrity import CorruptPageError, crc32
from .quantize import QuantMeta

__all__ = [
    "TensorRecord", "TensorPage", "write_page", "read_page_header",
    "verify_page", "read_record", "read_record_partial", "encode_payload",
    "decode_payload", "read_page_refs", "salvage_page_refs",
    "remap_page_vertices", "page_dim_keys",
]

_MAGIC = b"NSPG"
_VERSION = 3
_LEGACY_VERSION = 2
_HDR = struct.Struct("<4sHI")           # magic, version, n_records
_OFFSET = struct.Struct("<QQ")          # v2: offset, length per record
_OFFSET3 = struct.Struct("<QQI")        # v3: offset, length, record crc32
_TABLE_CRC = struct.Struct("<I")        # v3: crc32 over header + table
_REC_FIXED = struct.Struct("<HBqQqdqBd")  # name_len, ndim, vertex, dim_key, numel, scale, zp, nbit, mid


@dataclasses.dataclass
class TensorRecord:
    """One compressed tensor: quantized delta + reference to its base."""

    name: str
    shape: tuple[int, ...]
    dim_key: int          # flattened length == which HNSW index pool entry
    vertex_id: int        # base tensor vertex in that index
    meta: QuantMeta       # delta quantization parameters
    qdelta: np.ndarray | None = None   # int64 codes (None until payload read)
    payload: bytes = b""

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def payload_nbytes(self) -> int:
        return self.meta.nbit * planar_plane_bytes(self.numel)


def encode_payload(rec: TensorRecord) -> bytes:
    """Planar-pack a record's quantized delta (all planes in one packbits).

    The engine calls this outside its global lock so the bit-packing CPU
    work never serializes concurrent saves.
    """
    if rec.qdelta is None or rec.meta.nbit == 0:
        return b""
    return pack_bits_planar(rec.qdelta, rec.meta.nbit)


def decode_payload(rec: TensorRecord) -> np.ndarray:
    """Unpack a record's payload into int64 codes (inverse of encode)."""
    if rec.meta.nbit == 0:
        return np.zeros(rec.numel, dtype=np.int64)
    return unpack_bits_planar(rec.payload, rec.meta.nbit, rec.numel)


def _encode_record(rec: TensorRecord) -> bytes:
    name_b = rec.name.encode("utf-8")
    payload = rec.payload or encode_payload(rec)
    fixed = _REC_FIXED.pack(
        len(name_b), len(rec.shape), rec.vertex_id, rec.dim_key, rec.numel,
        rec.meta.scale, rec.meta.zero_point, rec.meta.nbit, rec.meta.mid,
    )
    dims = struct.pack(f"<{len(rec.shape)}I", *rec.shape)
    return fixed + name_b + dims + payload


def _decode_record(
    buf: memoryview,
    with_payload: bool = True,
    bits: int | None = None,
    decode: bool = True,
) -> TensorRecord:
    try:
        (name_len, ndim, vertex, dim_key, numel, scale, zp, nbit, mid) = _REC_FIXED.unpack_from(buf, 0)
        off = _REC_FIXED.size
        name = bytes(buf[off:off + name_len]).decode("utf-8")
        off += name_len
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
    except (struct.error, UnicodeDecodeError) as exc:
        raise CorruptPageError(f"truncated tensor record: {exc}") from exc
    off += 4 * ndim
    meta = QuantMeta(scale=scale, zero_point=zp, nbit=nbit, mid=mid)
    rec = TensorRecord(name=name, shape=tuple(shape), dim_key=dim_key,
                       vertex_id=vertex, meta=meta)
    if with_payload and nbit > 0:
        plane = planar_plane_bytes(numel)
        b = nbit if bits is None else min(bits, nbit)
        rec.payload = bytes(buf[off:off + b * plane])
        if len(rec.payload) < b * plane:
            raise CorruptPageError(
                f"record {name!r}: truncated payload "
                f"({len(rec.payload)} of {b * plane} bytes)"
            )
        if b < nbit:
            # MSB-truncated read: widen scale, shift zero point (Alg. 2 l.6-8).
            # The stored payload holds exactly the top b planes, so the
            # record stays self-consistent with its truncated meta.
            shift = nbit - b
            rec.meta = QuantMeta(scale=scale * (1 << shift), zero_point=zp >> shift,
                                 nbit=b, mid=mid)
        if decode:
            rec.qdelta = decode_payload(rec)
    elif with_payload:
        if decode:
            rec.qdelta = np.zeros(numel, dtype=np.int64)
    return rec


@dataclasses.dataclass
class TensorPage:
    """A parsed page: header offsets plus raw buffer for lazy record reads.

    ``crcs`` is the per-record CRC32 list for v3 pages (``None`` for legacy
    v2 pages; a stored CRC of 0 means "not checksummed at write time").
    """

    buf: bytes
    offsets: list[tuple[int, int]]
    crcs: list[int] | None = None
    version: int = _VERSION

    @property
    def n_records(self) -> int:
        return len(self.offsets)


def write_page(records: list[TensorRecord], checksums: bool = True) -> bytes:
    """Serialize records into one read-only v3 tensor page.

    With ``checksums=False`` record CRCs are stored as 0 (skipped on
    verify) — the durability benchmark uses this to isolate CRC cost; the
    table CRC sealing the header is always written (it is one pass over a
    few hundred bytes and torn-header detection depends on it).
    """
    blobs = [_encode_record(r) for r in records]
    header = _HDR.pack(_MAGIC, _VERSION, len(blobs))
    base = len(header) + _OFFSET3.size * len(blobs) + _TABLE_CRC.size
    out = bytearray(header)
    off = base
    for b in blobs:
        out += _OFFSET3.pack(off, len(b), crc32(b) if checksums else 0)
        off += len(b)
    out += _TABLE_CRC.pack(crc32(out))
    for b in blobs:
        out += b
    return bytes(out)


def read_page_header(buf: bytes) -> TensorPage:
    """Parse a page header, verifying framing and bounds.

    Detects torn pages (offset table or records extending past the buffer)
    and, for v3, any damage to the header/offset table via the table CRC.
    Record payload damage is only caught by :func:`verify_page` (per-record
    CRC pass) — header parsing stays O(records)."""
    try:
        magic, version, n = _HDR.unpack_from(buf, 0)
    except struct.error as exc:
        raise CorruptPageError("truncated page header") from exc
    if magic != _MAGIC:
        raise CorruptPageError("not a NeurStore tensor page")
    offsets: list[tuple[int, int]] = []
    crcs: list[int] | None = None
    if version == _LEGACY_VERSION:
        table_end = _HDR.size + _OFFSET.size * n
        if len(buf) < table_end:
            raise CorruptPageError("torn page: offset table truncated")
        for i in range(n):
            o, l = _OFFSET.unpack_from(buf, _HDR.size + i * _OFFSET.size)
            offsets.append((o, l))
        data_start = table_end
    elif version == _VERSION:
        table_end = _HDR.size + _OFFSET3.size * n
        if len(buf) < table_end + _TABLE_CRC.size:
            raise CorruptPageError("torn page: offset table truncated")
        (stored,) = _TABLE_CRC.unpack_from(buf, table_end)
        if crc32(bytes(buf[:table_end])) != stored:
            raise CorruptPageError("page header checksum mismatch")
        crcs = []
        for i in range(n):
            o, l, c = _OFFSET3.unpack_from(buf, _HDR.size + i * _OFFSET3.size)
            offsets.append((o, l))
            crcs.append(c)
        data_start = table_end + _TABLE_CRC.size
    else:
        raise CorruptPageError(f"unsupported tensor page version {version}")
    for o, l in offsets:
        if o < data_start or o + l > len(buf):
            raise CorruptPageError("torn page: record out of bounds")
    return TensorPage(buf=buf, offsets=offsets, crcs=crcs, version=version)


def verify_page(buf: bytes) -> TensorPage:
    """Full integrity check: header/table framing plus per-record CRCs.

    Returns the parsed page on success so callers (frame admission, the
    scrubber, fsck) get the parse for free. Legacy v2 pages pass framing
    and bounds checks only — they carry no checksums to verify.
    """
    page = read_page_header(buf)
    if page.crcs is not None:
        view = memoryview(buf)  # each record's CRC without copying it out
        for i, ((o, l), c) in enumerate(zip(page.offsets, page.crcs)):
            if c and crc32(view[o:o + l]) != c:
                raise CorruptPageError(f"record {i} checksum mismatch")
    return page


def read_record(page: TensorPage, i: int, with_payload: bool = True,
                decode: bool = True) -> TensorRecord:
    """Read record i. ``decode=False`` keeps the payload as packed bytes
    (``qdelta=None``) so callers can defer bit-unpacking — the loader uses
    this to push decode work into its pipeline's dequant stage."""
    o, l = page.offsets[i]
    return _decode_record(memoryview(page.buf)[o:o + l], with_payload=with_payload,
                          decode=decode)


# Byte offset of the vertex_id field inside _REC_FIXED ("<H B q ...").
_VERTEX_OFF = struct.calcsize("<HB")


def read_page_refs(f) -> list[tuple[int, int]]:
    """``(dim_key, vertex_id)`` per record, reading headers only.

    The engine's lifecycle operations (delete/replace/vacuum) need a
    page's base references but not its payloads; this seeks to each
    record's fixed header instead of reading the whole file, so the cost
    is O(records), not O(page bytes). ``f`` is an open binary file.
    """
    f.seek(0)
    hdr = f.read(_HDR.size)
    try:
        magic, version, n = _HDR.unpack(hdr)
    except struct.error as exc:
        raise CorruptPageError("truncated page header") from exc
    if magic != _MAGIC:
        raise CorruptPageError("not a NeurStore tensor page")
    if version == _LEGACY_VERSION:
        entry = _OFFSET
        table = f.read(entry.size * n)
        if len(table) < entry.size * n:
            raise CorruptPageError("torn page: offset table truncated")
    elif version == _VERSION:
        entry = _OFFSET3
        table = f.read(entry.size * n + _TABLE_CRC.size)
        if len(table) < entry.size * n + _TABLE_CRC.size:
            raise CorruptPageError("torn page: offset table truncated")
        (stored,) = _TABLE_CRC.unpack_from(table, entry.size * n)
        if crc32(hdr + table[:entry.size * n]) != stored:
            raise CorruptPageError("page header checksum mismatch")
    else:
        raise CorruptPageError(f"unsupported tensor page version {version}")
    refs = []
    for i in range(n):
        o = entry.unpack_from(table, i * entry.size)[0]
        f.seek(o + _VERTEX_OFF)
        raw = f.read(16)
        if len(raw) < 16:
            raise CorruptPageError("torn page: record out of bounds")
        vertex, dim = struct.unpack("<qQ", raw)
        refs.append((int(dim), int(vertex)))
    return refs


def salvage_page_refs(buf: bytes) -> list[tuple[int, int]]:
    """Best-effort ``(dim_key, vertex_id)`` refs from a *damaged* page.

    Only records whose stored CRC still verifies contribute (v2 pages and
    CRC-less records: any in-bounds record). Quarantine-path reference
    accounting uses this where under-counting is the safe direction — a
    missed ref merely leaks (``rebuild_vertex_refs`` reclaims it later),
    while an invented ref could keep a dead base alive or, worse, free a
    live one on the decrement side. Never raises.
    """
    try:
        magic, version, n = _HDR.unpack_from(buf, 0)
    except struct.error:
        return []
    if magic != _MAGIC:
        return []
    if version == _VERSION:
        entry, has_crc = _OFFSET3, True
    elif version == _LEGACY_VERSION:
        entry, has_crc = _OFFSET, False
    else:
        return []
    out: list[tuple[int, int]] = []
    for i in range(n):
        base = _HDR.size + i * entry.size
        if base + entry.size > len(buf):
            break  # table itself is torn (or n is garbage)
        fields = entry.unpack_from(buf, base)
        o, l = fields[0], fields[1]
        if o + l > len(buf) or o + _VERTEX_OFF + 16 > len(buf):
            continue
        if has_crc and fields[2] and crc32(bytes(buf[o:o + l])) != fields[2]:
            continue
        vertex, dim = struct.unpack_from("<qQ", buf, o + _VERTEX_OFF)
        out.append((int(dim), int(vertex)))
    return out


def page_dim_keys(page: TensorPage) -> set[int]:
    """Distinct ``dim_key`` values referenced by a parsed page.

    Header-field reads only (no payload touch): snapshot capture uses this
    to know which HNSW indexes a model's records need *before* any tensor
    is reconstructed, so the index references can be pinned into the
    snapshot in one short critical section.
    """
    buf = page.buf
    return {
        struct.unpack_from("<qQ", buf, o + _VERTEX_OFF)[1]
        for o, _l in page.offsets
    }


def remap_page_vertices(buf: bytes, remap: dict[int, int], dim_key: int) -> tuple[bytes, bool]:
    """Patch base-vertex ids of every ``dim_key`` record in a page image.

    Index compaction renumbers vertices; pages are read-only, so the engine
    rewrites affected pages through the catalog journal. Only the 8-byte
    ``vertex_id`` field of matching records is patched in place — names,
    shapes, quantization metadata and bit-packed payloads are untouched, so
    the rewritten page is byte-identical except for the remapped ids (the
    vacuum parity bar rests on this).

    Returns ``(new_buf, changed)``; raises ``KeyError`` if a record still
    references a vertex the remap dropped (a dangling reference — the
    caller must only compact vertices with zero catalog references).
    """
    page = read_page_header(buf)
    out = bytearray(buf)
    changed_idx = []
    for i, (o, _l) in enumerate(page.offsets):
        vertex, dim = struct.unpack_from("<qQ", buf, o + _VERTEX_OFF)
        if dim != dim_key:
            continue
        nv = remap[vertex]
        if nv != vertex:
            struct.pack_into("<q", out, o + _VERTEX_OFF, nv)
            changed_idx.append(i)
    if changed_idx and page.crcs is not None:
        # Patched records invalidate their stored CRCs; re-seal them and
        # the table CRC so the rewritten page still verifies.
        for i in changed_idx:
            if page.crcs[i]:
                o, l = page.offsets[i]
                struct.pack_into(
                    "<I", out, _HDR.size + i * _OFFSET3.size + 16,
                    crc32(bytes(out[o:o + l])),
                )
        table_end = _HDR.size + _OFFSET3.size * len(page.offsets)
        _TABLE_CRC.pack_into(out, table_end, crc32(bytes(out[:table_end])))
    return bytes(out), bool(changed_idx)


def read_record_partial(page: TensorPage, i: int, bits: int,
                        decode: bool = True) -> TensorRecord:
    """Flexible loading: read only the top ``bits`` bit-planes of record i.

    I/O saved is real — only ``bits * plane_bytes`` of the payload region is
    touched, matching the paper's reduced disk I/O claim (Fig. 11).
    """
    o, l = page.offsets[i]
    return _decode_record(memoryview(page.buf)[o:o + l], with_payload=True,
                          bits=bits, decode=decode)
