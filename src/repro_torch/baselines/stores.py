"""Baseline model *stores* (system-level comparisons, paper §6.1.2).

A copy of the reference's ``repro/baselines/stores.py``.

* ``BlobStore``  — PostgresML-like: serialize the whole model into one
  zlib(PGLZ)-compressed blob in a "model table" (a directory of blobs +
  a metadata json standing in for the relational table).
* ``FileStore``  — ELF*-like: per-tensor ELF compression into one file per
  model + a metadata record holding the path (ELF is a float-array
  transform, so it applies tensor-wise, not to the serialized container).

Both share the benchmark-facing API of ``StorageEngine``:
``save_model(name, arch, tensors)`` / ``load_model(name).materialize()``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import time
import zlib

import numpy as np

from .compressors import ElfCompressor


class _Loaded:
    def __init__(self, tensors):
        self._tensors = tensors

    def materialize(self):
        return dict(self._tensors)

    def tensor(self, name):
        return self._tensors[name]


class _BaseStore:
    name = "base"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._meta_path = os.path.join(root, "meta.json")
        self._meta = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)

    def _blob_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name.replace('/', '_')}.bin")

    def _encode(self, tensors):  # → bytes
        raise NotImplementedError

    def _decode(self, blob):    # → dict[str, np.ndarray]
        raise NotImplementedError

    def save_model(self, name, architecture, tensors):
        t0 = time.perf_counter()
        blob = self._encode(tensors)
        with open(self._blob_path(name), "wb") as f:
            f.write(blob)
        self._meta[name] = {
            "architecture": architecture,
            "original_bytes": sum(np.asarray(v).size * 4 for v in tensors.values()),
            "blob_bytes": len(blob),
        }
        with open(self._meta_path, "w") as f:
            json.dump(self._meta, f)
        return time.perf_counter() - t0

    def load_model(self, name):
        with open(self._blob_path(name), "rb") as f:
            blob = f.read()
        return _Loaded(self._decode(blob))

    def list_models(self):
        return list(self._meta)

    def storage_bytes(self):
        total = sum(os.path.getsize(os.path.join(self.root, f))
                    for f in os.listdir(self.root) if f.endswith(".bin"))
        return {"pages": total, "index": 0, "total": total}


class BlobStore(_BaseStore):
    """PostgresML-like: one PGLZ(zlib) blob per model (TOAST semantics)."""

    name = "postgresml"

    def _encode(self, tensors):
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v, np.float32) for k, v in tensors.items()})
        return zlib.compress(buf.getvalue(), 6)

    def _decode(self, blob):
        with np.load(io.BytesIO(zlib.decompress(blob))) as z:
            return {k: z[k] for k in z.files}


class FileStore(_BaseStore):
    """ELF*-like: per-tensor ELF compression, one file per model."""

    name = "elf*"
    _elf = ElfCompressor()

    def _encode(self, tensors):
        out = bytearray(struct.pack("<I", len(tensors)))
        for k, v in tensors.items():
            arr = np.asarray(v, np.float32)
            body = self._elf.compress(arr)
            kb = k.encode()
            out += struct.pack("<H", len(kb)) + kb
            out += struct.pack("<B", arr.ndim)
            out += struct.pack(f"<{arr.ndim}I", *arr.shape)
            out += struct.pack("<Q", len(body)) + body
        return bytes(out)

    def _decode(self, blob):
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        tensors = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", blob, off)
            off += 2
            k = blob[off:off + klen].decode()
            off += klen
            (ndim,) = struct.unpack_from("<B", blob, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}I", blob, off)
            off += 4 * ndim
            (blen,) = struct.unpack_from("<Q", blob, off)
            off += 8
            tensors[k] = self._elf.decompress(blob[off:off + blen], shape)
            off += blen
        return tensors
