"""Baseline compressors the paper evaluates against (§6.1.2).

A copy of the reference's ``repro/baselines/compressors.py``: the same
bytes for the same arrays.

* ``ZstdCompressor`` — real Zstandard (the paper's ZSTD v1.5.5 baseline).
* ``ZlibCompressor`` — LZ-family; stands in for PostgresML's PGLZ/TOAST.
* ``ElfCompressor`` — ELF [VLDB'24]: erase the exponent field of floats in
  (-1, 1) by remapping to [1, 2) — the mantissa keeps the value exactly
  recoverable given the map flag; exponent bytes then compress away.
  Implemented losslessly: map, then zstd the now-redundant exponent plane.
* ``ZfpLikeCompressor`` — fixed-accuracy float compressor in the spirit of
  ZFP: block-wise (64) common-exponent fixed-point encoding at a given
  absolute error bound.
* ``PTQ8Compressor`` — naive whole-tensor 8-bit PTQ (lossy, no deltas):
  the "quantize the model directly" strawman.

All expose compress(arr) → bytes and decompress(bytes, shape) → arr, plus
``lossless`` / error-bound metadata for the accuracy benchmarks.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    import zstandard as zstd

    # Fresh (de)compressor per call: the objects are NOT thread-safe and
    # the throughput benchmarks save from concurrent clients.
    def _zstd_c(b: bytes) -> bytes:
        return zstd.ZstdCompressor(level=3).compress(b)

    def _zstd_d(b: bytes) -> bytes:
        return zstd.ZstdDecompressor().decompress(b)
except ImportError:  # pragma: no cover
    _zstd_c = zlib.compress
    _zstd_d = zlib.decompress


class ZstdCompressor:
    name = "zstd"
    lossless = True

    def compress(self, arr: np.ndarray) -> bytes:
        return _zstd_c(np.ascontiguousarray(arr, np.float32).tobytes())

    def decompress(self, data: bytes, shape) -> np.ndarray:
        return np.frombuffer(_zstd_d(data), np.float32).reshape(shape).copy()


class ZlibCompressor:
    """PGLZ stand-in (PostgresML stores TOAST-compressed blobs)."""

    name = "pglz"
    lossless = True

    def compress(self, arr: np.ndarray) -> bytes:
        return zlib.compress(np.ascontiguousarray(arr, np.float32).tobytes(), 6)

    def decompress(self, data: bytes, shape) -> np.ndarray:
        return np.frombuffer(zlib.decompress(data), np.float32).reshape(shape).copy()


class ElfCompressor:
    """ELF: map x ∈ (-1,1) to sign·(|x|+1) ∈ [1,2) — the exponent byte of
    every mapped float becomes a constant pattern, which the entropy stage
    removes. Adding 1.0 rounds the mantissa at ulp(1)=2^-23, so roundtrip
    error ≤ 2^-24 — exactly the tolerance the NeurStore paper adopts
    "consistent with that used in ELF" (§6.1.3)."""

    name = "elf"
    lossless = False
    tolerance = 2.0 ** -24

    def compress(self, arr: np.ndarray) -> bytes:
        x = np.ascontiguousarray(arr, np.float32).ravel()
        mapped_mask = np.abs(x) < 1.0
        y = np.where(mapped_mask, np.sign(x) * (np.abs(x) + 1.0), x).astype(np.float32)
        # Byte-plane split boosts the entropy stage (exponent plane is now
        # near-constant for mapped values).
        planes = y.view(np.uint8).reshape(-1, 4).T.copy()
        flags = np.packbits(mapped_mask)
        payload = _zstd_c(planes.tobytes())
        fl = _zstd_c(flags.tobytes())
        return struct.pack("<QQ", len(payload), x.size) + payload + fl

    def decompress(self, data: bytes, shape) -> np.ndarray:
        plen, n = struct.unpack_from("<QQ", data, 0)
        off = 16
        planes = np.frombuffer(_zstd_d(data[off:off + plen]), np.uint8)
        y = planes.reshape(4, -1).T.copy().view(np.float32).ravel()
        flags = np.unpackbits(
            np.frombuffer(_zstd_d(data[off + plen:]), np.uint8), count=n
        ).astype(bool)
        x = np.where(flags, np.sign(y) * (np.abs(y) - 1.0), y)
        return x.astype(np.float32).reshape(shape)


class ZfpLikeCompressor:
    """Fixed-accuracy mode: per-64-block common exponent + fixed point at
    absolute tolerance ``p`` (captures ZFP's error-bounded behaviour)."""

    name = "zfp"
    lossless = False

    def __init__(self, tolerance: float = 5.96e-8):
        self.tolerance = tolerance

    def compress(self, arr: np.ndarray) -> bytes:
        x = np.ascontiguousarray(arr, np.float64).ravel()
        n = x.size
        pad = (-n) % 64
        xp = np.pad(x, (0, pad)).reshape(-1, 64)
        amax = np.abs(xp).max(axis=1)
        # Bits so that quantization step <= 2*tolerance within each block.
        nbits = np.ceil(np.log2(np.maximum(amax / self.tolerance, 1.0))).astype(np.int64)
        nbits = np.clip(nbits, 0, 30)
        out = bytearray(struct.pack("<QQd", n, xp.shape[0], self.tolerance))
        for blk, b, am in zip(xp, nbits, amax):
            out += struct.pack("<Bd", int(b), float(am))
            if b == 0:
                continue
            scale = am / (2 ** int(b) - 1) if am > 0 else 1.0
            q = np.round(blk / scale).astype(np.int32)
            # pack signed values: zigzag then minimal bytes (1/2/4)
            zz = ((q >> 31) ^ (q << 1)).astype(np.uint32)
            width = 1 if zz.max() < 256 else (2 if zz.max() < 65536 else 4)
            out += struct.pack("<B", width)
            out += zz.astype({1: np.uint8, 2: np.uint16, 4: np.uint32}[width]).tobytes()
        return _zstd_c(bytes(out))

    def decompress(self, data: bytes, shape) -> np.ndarray:
        raw = _zstd_d(data)
        n, nblk, tol = struct.unpack_from("<QQd", raw, 0)
        off = 24
        blocks = []
        for _ in range(nblk):
            b, am = struct.unpack_from("<Bd", raw, off)
            off += 9
            if b == 0:
                blocks.append(np.zeros(64))
                continue
            (width,) = struct.unpack_from("<B", raw, off)
            off += 1
            dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
            zz = np.frombuffer(raw, dt, 64, off).astype(np.uint32)
            off += 64 * width
            q = (zz >> 1).astype(np.int32) ^ -((zz & 1).astype(np.int32))
            scale = am / (2 ** int(b) - 1) if am > 0 else 1.0
            blocks.append(q * scale)
        x = np.concatenate(blocks)[:n]
        return x.astype(np.float32).reshape(shape)


class PTQ8Compressor:
    """Whole-tensor 8-bit PTQ — the no-delta quantization strawman."""

    name = "ptq8"
    lossless = False

    def compress(self, arr: np.ndarray) -> bytes:
        from ..core.quantize import quantize_linear

        x = np.ascontiguousarray(arr, np.float32)
        q, meta = quantize_linear(x.ravel(), nbit=8)
        head = struct.pack("<ddq", meta.scale, meta.mid, meta.zero_point)
        return head + _zstd_c(q.astype(np.uint8).tobytes())

    def decompress(self, data: bytes, shape) -> np.ndarray:
        from ..core.quantize import QuantMeta, dequantize_linear

        scale, mid, zp = struct.unpack_from("<ddq", data, 0)
        q = np.frombuffer(_zstd_d(data[24:]), np.uint8).astype(np.int64)
        meta = QuantMeta(scale=scale, zero_point=zp, nbit=8, mid=mid)
        return dequantize_linear(q, meta).astype(np.float32).reshape(shape)


ALL_COMPRESSORS = {
    c.name: c for c in [ZstdCompressor(), ZlibCompressor(), ElfCompressor(),
                        ZfpLikeCompressor(), PTQ8Compressor()]
}
