"""Compressed-domain runtime adapter: serve matmuls straight off a snapshot.

:class:`CompressedModel` maps :meth:`LoadedModel.compressed_params` output
(int8-recentred base codes + quantized deltas, including the int4-packed
flexible-loading form at ``bits=4``) directly into the layout the fused
``dequant_matmul`` kernels expect — the full-precision weight is never
materialized. The operands are uploaded to the model's device once per
serving session; the handle's buffer-pool frame stays pinned for the life
of the session (snapshot semantics, see ``docs/concurrency.md``).

Operand-normalization details the kernels don't know about live here:

* **constant base** (``base_scale == 0``): the stored codes are all zero
  (recentred: −128) and the value lives in ``base_mid``. The kernel
  formula ``(c − bz)·bs`` reproduces it exactly with ``bz = −129``,
  ``bs = mid``.
* **zero-bit delta** (``nbit == 0``, range ≤ 2p): bin-centre dequant
  ``(q − dz + 0.5)·ds`` must yield ``delta_mid``; with all-zero codes
  that is ``dz = code_value, ds = 2·mid``.
* **int4 packing**: deltas at ``nbit <= 4`` with even K pack two unsigned
  nibble codes per byte (``kernels.ops.pack_int4`` layout) — 1.5 device
  bytes per weight element instead of 2.0.

Bytes-moved accounting (``counters``) charges each matmul its *weight
operand* traffic — the quantity the compressed path exists to shrink —
plus per-row traffic for embedding gathers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.ops import (
    KERNEL_DISPATCH_MIN_ELEMS,
    dequant_matmul_auto,
    pack_int4,
    resolve_device,
)
from .loader import KernelNotReady, LoadedModel

__all__ = ["CompressedModel", "CompressedTensor", "KernelNotReady"]


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` (a copy: frame arrays are read-only)."""
    return torch.tensor(np.ascontiguousarray(arr), device=device)


class CompressedTensor:
    """One weight's kernel-ready operands, built once per serving session."""

    __slots__ = ("name", "shape", "k", "n", "packed", "base", "delta",
                 "base_scale", "base_zp", "delta_scale", "delta_zp",
                 "operand_nbytes", "scratch")

    def __init__(self, name: str, entry: dict, device: torch.device):
        shape = entry["shape"]
        if len(shape) < 2:
            raise ValueError(
                f"tensor {name!r}: matmul weights need >= 2 dims, got {shape}")
        self.name = name
        self.shape = tuple(shape)
        self.k = shape[0]
        self.n = int(math.prod(shape[1:]))
        base = entry["base_codes"].reshape(self.k, self.n)
        if entry["base_scale"] == 0.0:
            self.base_scale = float(entry["base_mid"])
            self.base_zp = -129.0
        else:
            self.base_scale = float(entry["base_scale"])
            self.base_zp = float(entry["base_zp"])
        nbit = entry["nbit"]
        self.packed = bool(nbit <= 4 and self.k % 2 == 0)
        if self.packed:
            # Unsigned nibble codes + unsigned zero-point (int4 kernel form).
            delta = pack_int4(entry["qdelta"].reshape(self.k, self.n))
            if nbit == 0:
                self.delta_scale = 2.0 * float(entry["delta_mid"])
                self.delta_zp = 0.0
            else:
                self.delta_scale = float(entry["delta_scale"])
                self.delta_zp = float(entry["delta_zp"])
        else:
            delta = entry["qdelta_i8"].reshape(self.k, self.n)
            if nbit == 0:
                self.delta_scale = 2.0 * float(entry["delta_mid"])
                self.delta_zp = -128.0
            else:
                self.delta_scale = float(entry["delta_scale"])
                self.delta_zp = float(entry["delta_zp_i8"])
        self.operand_nbytes = base.nbytes + delta.nbytes
        self.base = _upload(base, device)
        self.delta = _upload(delta, device)
        # The CPU decomposed form caches its pre-scaled float weight here;
        # on a CUDA device the kernel reads the codes and nothing is cached.
        self.scratch: dict | None = {} if device.type == "cpu" else None


class CompressedModel:
    """Serve a :class:`LoadedModel` without materializing float weights.

    ``matmul(x, name)`` routes through ``kernels.ops.dequant_matmul_auto``
    (the CUDA kernels on a CUDA device, the decomposed gemm on the CPU);
    ``gather_rows`` dequantizes only the requested embedding rows, on the
    device; ``vector`` reconstructs small tensors (norm gains) via
    ``tensor(name)``. ``device`` defaults to the engine's. Requires a
    kernel-ready handle — open it with ``load_model(name, bits=8)`` (or
    ``bits=4``); full-precision handles raise :class:`KernelNotReady` on
    first use.
    """

    def __init__(self, lm: LoadedModel, *, device=None,
                 min_elems: int = KERNEL_DISPATCH_MIN_ELEMS,
                 force: str | None = None):
        self.lm = lm
        self.device = resolve_device(lm.engine.device if device is None else device)
        self.params = lm.compressed_params()
        self.min_elems = min_elems
        self.force = force
        self._weights: dict[str, CompressedTensor] = {}
        self._rows: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._vectors: dict[str, torch.Tensor] = {}
        self.counters = {"matmul_calls": 0, "gather_calls": 0,
                         "bytes_moved": 0, "fused_elems": 0}
        #: Names whose bytes were served through the kernel seam — the
        #: zero-materialize acceptance test asserts ``materialize()`` /
        #: ``tensor()`` are never called for these.
        self.kernel_served: set[str] = set()

    # ------------------------------------------------------------- weights
    def weight(self, name: str) -> CompressedTensor:
        w = self._weights.get(name)
        if w is None:
            entry = self.params.kernel_operands(name)
            w = self._weights[name] = CompressedTensor(name, entry, self.device)
            self.kernel_served.add(name)
        return w

    def matmul(self, x, name: str) -> torch.Tensor:
        """``x @ dq(weight)`` on compressed operands; (M, K) → (M, N)."""
        w = self.weight(name)
        y = dequant_matmul_auto(
            x, w.base, w.base_scale, w.base_zp, w.delta, w.delta_scale,
            w.delta_zp, packed=w.packed, min_elems=self.min_elems,
            force=self.force, scratch=w.scratch)
        c = self.counters
        c["matmul_calls"] += 1
        c["bytes_moved"] += w.operand_nbytes
        c["fused_elems"] += w.k * w.n
        return y

    def bytes_per_weight(self, name: str) -> float:
        """Kernel-operand bytes per weight element (2.0 int8, 1.5 int4)."""
        w = self.weight(name)
        return w.operand_nbytes / (w.k * w.n)

    # ------------------------------------------------- row-wise access
    def _row_codes(self, name: str, entry: dict):
        """(V, d) base codes and delta codes of a gathered table, on the
        device once per session (delta codes in the narrowest exact type)."""
        rows = self._rows.get(name)
        if rows is None:
            v = entry["shape"][0]
            q = entry["qdelta"].reshape(v, -1)
            qtype = np.uint8 if entry["nbit"] <= 8 else np.int32
            rows = self._rows[name] = (
                _upload(entry["base_codes"].reshape(v, -1), self.device),
                _upload(q.astype(qtype), self.device),
            )
        return rows

    def gather_rows(self, name: str, ids) -> torch.Tensor:
        """Dequantize only the gathered rows (compressed-domain embedding
        lookup) — never the full (V, d) table."""
        entry = self.params[name]
        base_codes, qdelta = self._row_codes(name, entry)
        ids = torch.as_tensor(ids, device=self.device).to(torch.int64)
        codes = base_codes[ids]
        if entry["base_scale"] == 0.0:
            base = torch.full(codes.shape, float(entry["base_mid"]),
                              dtype=torch.float32, device=self.device)
        else:
            base = ((codes.to(torch.float32) - float(entry["base_zp"]))
                    * float(entry["base_scale"]))
        q = qdelta[ids]
        nbit = entry["nbit"]
        if nbit == 0:
            delta = torch.full(q.shape, float(entry["delta_mid"]),
                               dtype=torch.float32, device=self.device)
        else:
            delta = ((q.to(torch.float32) - float(entry["delta_zp"]) + 0.5)
                     * float(entry["delta_scale"]))
        self.kernel_served.add(name)
        c = self.counters
        c["gather_calls"] += 1
        c["bytes_moved"] += codes.numel() + int(q.numel() * nbit / 8)
        return base + delta

    def vector(self, name: str) -> torch.Tensor:
        """Small tensors (norm gains, biases): full reconstruct, cached."""
        v = self._vectors.get(name)
        if v is None:
            v = self._vectors[name] = _upload(self.lm.tensor(name), self.device)
        return v

    # ------------------------------------------------------------ lifecycle
    def reset_counters(self) -> None:
        for key in self.counters:
            self.counters[key] = 0

    def close(self) -> None:
        self.lm.close()
