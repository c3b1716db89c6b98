"""Bit-packing for n-bit quantized payloads (paper §5: "bit-packed payload").

Values are packed MSB-first so that *flexible loading* (paper §4.3.1) can
read a byte-aligned prefix of each value's bits: with ``pack_bits_planar`` the
payload is stored as ``nbit`` bit-planes ordered from most significant to
least significant, so reading the first ``b`` planes yields exactly
``extract_msb(q, b)``. This mirrors NeurStore's ability to fetch only the
most-significant bits of each delta tensor from disk.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_bits", "unpack_bits", "pack_bits_planar", "unpack_bits_planar", "planar_plane_bytes"]


def pack_bits(values: np.ndarray, nbit: int) -> bytes:
    """Pack unsigned ints (< 2^nbit) into a dense MSB-first bitstream."""
    if nbit == 0 or values.size == 0:
        return b""
    v = np.ascontiguousarray(values.ravel(), dtype=np.uint64)
    shifts = np.arange(nbit - 1, -1, -1, dtype=np.uint64)
    bits = ((v[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bits.ravel()).tobytes()


def unpack_bits(data: bytes, nbit: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns int64 values of length ``count``."""
    if nbit == 0 or count == 0:
        return np.zeros(count, dtype=np.int64)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8), count=count * nbit)
    bits = bits.reshape(count, nbit).astype(np.int64)
    weights = (1 << np.arange(nbit - 1, -1, -1, dtype=np.int64))
    return bits @ weights


def planar_plane_bytes(count: int) -> int:
    """Bytes used by one bit-plane for ``count`` values."""
    return (count + 7) // 8


# Values per chunk for planar (un)packing: multiple of 8 so every chunk
# boundary is byte-aligned within a plane; sized to keep the per-chunk bit
# matrix in L2 even at nbit=64.
_PLANE_CHUNK = 1 << 16


def _word(nbit: int):
    """The narrowest unsigned dtype that holds ``nbit``-bit values: the
    planar sweeps shift and mask words of that width (the same bits as in
    uint64, a fraction of the memory traffic)."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if nbit <= np.iinfo(dt).bits:
            return dt
    return np.uint64


def pack_bits_planar(values: np.ndarray, nbit: int) -> bytes:
    """Pack as ``nbit`` bit-planes, most-significant plane first.

    Plane ``k`` (0-based) holds bit ``nbit-1-k`` of every value. A reader
    wanting only the top ``b`` bits reads ``b * planar_plane_bytes(n)`` bytes.

    All planes of a value-chunk are built with one broadcast shift and one
    row-wise ``np.packbits`` (``axis=1`` pads each plane independently to a
    byte boundary — exactly the planar on-disk layout). Values are
    processed in byte-aligned chunks so transient memory stays bounded at
    ~9·nbit·CHUNK bytes for any input size and the working set stays
    cache-resident; only the final chunk may be ragged, and its per-row
    padding coincides with the global plane padding.
    """
    if nbit == 0 or values.size == 0:
        return b""
    word = _word(nbit)
    v = np.ascontiguousarray(values.ravel()).astype(word, copy=False)
    n = v.size
    plane_nbytes = planar_plane_bytes(n)
    shifts = np.arange(nbit - 1, -1, -1, dtype=word)[:, None]
    out = np.empty((nbit, plane_nbytes), dtype=np.uint8)
    chunk = _PLANE_CHUNK  # multiple of 8 → chunk planes stay byte-aligned
    for start in range(0, n, chunk):
        seg = v[start:start + chunk]
        bits = ((seg[None, :] >> shifts) & word(1)).astype(np.uint8)
        out[:, start // 8: start // 8 + (seg.size + 7) // 8] = np.packbits(bits, axis=1)
    return out.tobytes()


def unpack_bits_planar(data: bytes, nbit: int, count: int, b: int | None = None) -> np.ndarray:
    """Unpack the top ``b`` (default all) bit-planes into int64 values.

    Returns values of width ``min(b, nbit)`` — i.e. already MSB-truncated,
    matching :func:`repro_torch.core.quantize.extract_msb` on the full values.
    Inverse of :func:`pack_bits_planar`: per byte-aligned value-chunk, one
    ``np.unpackbits`` over the (b, chunk_bytes) view and an in-place
    shift-or fold over the ≤64 plane rows — transient memory is bounded by
    the chunk, not by ``b·count``.
    """
    if nbit == 0 or count == 0:
        return np.zeros(count, dtype=np.int64)
    b = nbit if b is None else min(b, nbit)
    if b <= 0:
        return np.zeros(count, dtype=np.int64)
    plane_nbytes = planar_plane_bytes(count)
    planes = np.frombuffer(data, dtype=np.uint8)[: b * plane_nbytes]
    planes = planes.reshape(b, plane_nbytes)
    acc = np.empty(count, dtype=_word(b))
    chunk = _PLANE_CHUNK
    for start in range(0, count, chunk):
        stop = min(start + chunk, count)
        seg = planes[:, start // 8: (stop + 7) // 8]
        bits = np.unpackbits(seg, axis=1, count=stop - start)
        out = acc[start:stop]
        out[:] = bits[0]
        for k in range(1, b):
            out <<= 1
            out |= bits[k]
    return acc.astype(np.int64)
