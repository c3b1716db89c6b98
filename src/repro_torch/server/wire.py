"""Streaming wire format for model upload/download (docs/serving.md).

A model crosses the wire as a flat sequence of length-prefixed frames —
never as one buffer — so both sides keep memory bounded by the largest
single tensor regardless of model size:

=======  ====================================================~==========
frame    content
=======  ==============================================================
0        JSON header: ``{"stream_version", "name", "architecture",
         ...}`` (upload adds ``tolerance``/``tau``, download ``bits``)
2k+1     JSON tensor meta: ``{"tensor", "shape", "dtype", "crc"}``
2k+2     raw C-order tensor bytes (CRC32-checked against the meta)
last     JSON trailer: ``{"eof": true, "n_tensors": N}``
=======  ==============================================================

Each frame is ``<u64 little-endian length><payload>``. The trailer is
load-bearing: a stream that ends without it (server died mid-stream, a
proxy truncated the body) raises :class:`WireError` instead of silently
yielding a partial model. Per-tensor CRCs extend the storage layer's
end-to-end checksum chain across the network hop.

The encoder accepts any ``(name, ndarray)`` iterable, so the server
streams straight off :meth:`LoadedModel.iter_tensors` (one record
resident at a time) and the client streams straight out of a
``SaveRequest``'s tensor mapping.
"""

from __future__ import annotations

import json
import struct
from collections.abc import Iterable, Iterator

import numpy as np

from ..core.integrity import crc32

__all__ = [
    "WireError",
    "STREAM_VERSION",
    "encode_model_stream",
    "decode_model_stream",
    "read_frame",
    "write_frame",
]

STREAM_VERSION = 1
_LEN = struct.Struct("<Q")
# One frame never exceeds this (guards a corrupted/hostile length prefix
# from driving a giant allocation). Tensors larger than 1 GiB per record
# do not exist in this store's page format either.
MAX_FRAME_BYTES = 1 << 30


class WireError(ValueError):
    """The byte stream violates the framing contract (truncation, bad
    CRC, missing trailer, oversized frame). Maps to ``invalid_request``
    on the server and is raised as-is by the client."""


def _read_exact(r, n: int) -> bytes:
    """Read exactly ``n`` bytes from a ``.read(k)`` object or fail typed."""
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = r.read(remaining)
        if not chunk:
            raise WireError(
                f"stream truncated: expected {n} more frame bytes, got "
                f"{n - remaining}")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read_frame(r) -> bytes:
    """Read one length-prefixed frame from a ``.read(n)`` source."""
    (length,) = _LEN.unpack(_read_exact(r, _LEN.size))
    if length > MAX_FRAME_BYTES:
        raise WireError(f"frame length {length} exceeds {MAX_FRAME_BYTES}")
    return _read_exact(r, length)


def write_frame(w, payload: bytes) -> None:
    """Write one frame via a ``write(bytes)`` callable-style object."""
    w.write(_LEN.pack(len(payload)))
    w.write(payload)


def _frame(payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + payload


def _parse_json(buf: bytes, what: str) -> dict:
    try:
        obj = json.loads(buf.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise WireError(f"bad {what} frame: {exc}") from exc
    if not isinstance(obj, dict):
        raise WireError(f"bad {what} frame: not an object")
    return obj


def encode_model_stream(
    header: dict, tensors: Iterable[tuple[str, np.ndarray]]
) -> Iterator[bytes]:
    """Yield the framed byte chunks of one model stream.

    Lazy: each tensor is framed as the iterable produces it, so a
    server streaming off :meth:`LoadedModel.iter_tensors` holds one
    reconstructed tensor at a time.
    """
    head = {"stream_version": STREAM_VERSION}
    head.update(header)
    yield _frame(json.dumps(head).encode("utf-8"))
    n = 0
    for name, arr in tensors:
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        meta = {
            "tensor": str(name),
            "shape": [int(s) for s in arr.shape],
            "dtype": arr.dtype.str,
            "crc": crc32(data),
        }
        yield _frame(json.dumps(meta).encode("utf-8"))
        yield _frame(data)
        n += 1
    yield _frame(json.dumps({"eof": True, "n_tensors": n}).encode("utf-8"))


def decode_model_stream(r) -> tuple[dict, Iterator[tuple[str, np.ndarray]]]:
    """Parse a model stream from a ``.read(n)`` source.

    Returns ``(header, generator)``; the generator yields
    ``(name, ndarray)`` record-by-record and validates the trailer, so
    exhausting it guarantees the stream arrived complete and intact.
    Arrays are zero-copy views over the received frame (read-only).
    """
    header = _parse_json(read_frame(r), "header")
    version = header.get("stream_version")
    if version != STREAM_VERSION:
        raise WireError(f"unsupported stream_version {version!r}")

    def records() -> Iterator[tuple[str, np.ndarray]]:
        count = 0
        while True:
            meta = _parse_json(read_frame(r), "tensor meta")
            if meta.get("eof"):
                expect = meta.get("n_tensors")
                if expect is not None and int(expect) != count:
                    raise WireError(
                        f"trailer claims {expect} tensors, stream carried "
                        f"{count}")
                return
            data = read_frame(r)
            if crc32(data) != meta.get("crc"):
                raise WireError(
                    f"tensor {meta.get('tensor')!r}: payload CRC mismatch "
                    "(bytes damaged in transit)")
            try:
                arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]))
                arr = arr.reshape([int(s) for s in meta["shape"]])
            except (KeyError, TypeError, ValueError) as exc:
                raise WireError(f"bad tensor meta: {exc}") from exc
            yield str(meta.get("tensor", "")), arr
            count += 1

    return header, records()
