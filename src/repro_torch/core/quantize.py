"""Quantization primitives for NeurStore (paper §2.4, §4.2).

Two quantizers live here:

* ``quantize_linear`` — standard linear asymmetric PTQ used for *base tensors*
  stored in HNSW vertices (8-bit, paper §4.1 "each base tensor is quantized to
  8-bit using linear quantization prior to insertion").
* ``quantize_delta`` — the adaptive delta quantizer of Eq. (2)/(3):
  ``nbit = ceil(log2((dmax - dmin) / 2p))``, ``scale = 2p``,
  ``zero_point = floor(-dmin / scale)``, ``q_i = floor(d_i / scale) + zp``.

Per paper §5, delta computation and quantization run in double precision to
avoid rounding artifacts of low-precision intermediates.

Reconstruction uses bin *centres* (``+0.5`` bin) so the paper's stated bound —
"any points in between are within the distance of p to their closest
quantized number" — holds exactly: floor-binning + centre-dequant gives
``|x - dq(q(x))| <= p``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "QuantMeta",
    "quantize_linear",
    "quantize_linear_batch",
    "dequantize_linear",
    "dequantize_linear_batch",
    "delta_nbit",
    "quantize_delta",
    "dequantize_delta",
    "extract_msb",
]

# Upper bound on adaptive bit width; beyond this the tensor should become a
# new base vertex instead (engine enforces tau before we ever get here).
MAX_NBIT = 32


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    """Per-tensor quantization parameters, serialized as the record prefix."""

    scale: float
    zero_point: int
    nbit: int
    # Mid value used when nbit == 0 (range <= 2p: a single bin suffices).
    mid: float = 0.0


def quantize_linear(x: np.ndarray, nbit: int = 8) -> tuple[np.ndarray, QuantMeta]:
    """Linear asymmetric quantization of a full tensor to ``nbit`` bits.

    ``s = (max - min) / (2^b - 1)``; ``q = round(x / s) + z``;
    ``z = round(-min / s)``. Degenerate (constant) tensors quantize to a
    single level with the constant stored in ``mid``.
    """
    x64 = np.asarray(x, dtype=np.float64).ravel()
    levels = (1 << nbit) - 1
    xmin = float(x64.min())
    xmax = float(x64.max())
    if xmax <= xmin:  # constant tensor
        meta = QuantMeta(scale=0.0, zero_point=0, nbit=nbit, mid=xmin)
        return np.zeros(x64.shape, dtype=np.int64), meta
    scale = (xmax - xmin) / levels
    zero_point = int(round(-xmin / scale))
    q = np.clip(np.round(x64 / scale).astype(np.int64) + zero_point, 0, levels)
    return q, QuantMeta(scale=scale, zero_point=zero_point, nbit=nbit)


def quantize_linear_batch(
    x: np.ndarray, nbit: int = 8
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Row-wise :func:`quantize_linear` over a ``(B, D)`` block in one sweep.

    Returns ``(codes, scales, zero_points, mids)`` with per-row parameter
    arrays. Bit-exact with the per-tensor path: every operation (min/max,
    ``x / s``, round-half-even, clip) is the same float64 computation
    broadcast over rows, so ``codes[i]`` equals ``quantize_linear(x[i])[0]``
    exactly (asserted in ``tests/test_batch_ingest.py``). Constant rows get
    ``scale == 0`` with the constant in ``mids`` — same convention as the
    scalar path.
    """
    x2 = np.atleast_2d(np.asarray(x, dtype=np.float64))
    b, _d = x2.shape
    levels = (1 << nbit) - 1
    xmin = x2.min(axis=1)
    xmax = x2.max(axis=1)
    const = xmax <= xmin
    scales = np.where(const, 0.0, (xmax - xmin) / levels)
    safe = np.where(const, 1.0, scales)
    zps = np.where(const, 0, np.round(-xmin / safe)).astype(np.int64)
    # Fused float path: round yields integral float64 (exact ≤ 2^53), so
    # adding the zero-point and clipping before the single int cast is
    # value-identical to the scalar path's int64 arithmetic.
    q = np.round(x2 / safe[:, None])
    q += zps.astype(np.float64)[:, None]
    np.clip(q, 0, levels, out=q)
    codes = q.astype(np.int64)
    codes[const] = 0
    mids = np.where(const, xmin, 0.0)
    return codes, scales, zps, mids


def dequantize_linear(q: np.ndarray, meta: QuantMeta) -> np.ndarray:
    if meta.scale == 0.0:
        return np.full(q.shape, meta.mid, dtype=np.float64)
    return (q.astype(np.float64) - meta.zero_point) * meta.scale


def dequantize_linear_batch(
    codes: np.ndarray,
    scales: np.ndarray,
    zero_points: np.ndarray,
    mids: np.ndarray,
) -> np.ndarray:
    """Row-wise inverse of :func:`quantize_linear_batch` → ``(B, D)`` float64."""
    c2 = np.atleast_2d(codes)
    s = np.asarray(scales, dtype=np.float64)
    z = np.asarray(zero_points, dtype=np.float64)
    deq = (c2.astype(np.float64) - z[:, None]) * s[:, None]
    const = s == 0.0
    if const.any():
        deq[const] = np.asarray(mids, dtype=np.float64)[const, None]
    return deq


def delta_nbit(dmin: float, dmax: float, p: float) -> int:
    """Eq. (2): bit width for a delta with range [dmin, dmax] at tolerance p."""
    rng = dmax - dmin
    if rng <= 2.0 * p:
        return 0
    nbit = int(math.ceil(math.log2(rng / (2.0 * p))))
    return max(1, min(nbit, MAX_NBIT))


def quantize_delta(delta: np.ndarray, p: float) -> tuple[np.ndarray, QuantMeta]:
    """Eq. (3): adaptive linear asymmetric quantization of a delta tensor.

    ``scale = 2p``; ``zero_point = floor(-dmin / scale)``;
    ``q_i = floor(d_i / scale) + zero_point``. Values are clipped into
    ``[0, 2^nbit - 1]`` (zero_point guarantees the min lands at 0 or 1).
    """
    d64 = np.asarray(delta, dtype=np.float64).ravel()
    dmin = float(d64.min())
    dmax = float(d64.max())
    nbit = delta_nbit(dmin, dmax, p)
    if nbit == 0:
        # One bin: everything reconstructs to the range midpoint, err <= p.
        meta = QuantMeta(scale=2.0 * p, zero_point=0, nbit=0, mid=(dmin + dmax) / 2.0)
        return np.zeros(d64.shape, dtype=np.int64), meta
    scale = 2.0 * p
    # Paper writes zp = floor(-dmin/scale); that leaves q_min = -1 whenever
    # dmin/scale is non-integral (floor(x)+floor(-x) = -1), and clipping the
    # stray -1 breaks the |err| <= p guarantee. zp = -floor(dmin/scale) pins
    # q_min to exactly 0 — same quantity up to the paper's off-by-one.
    zero_point = -int(math.floor(dmin / scale))
    q = np.floor(d64 / scale).astype(np.int64) + zero_point
    qmax = int(q.max())
    while qmax > (1 << nbit) - 1 and nbit < MAX_NBIT:
        # Rare bin-alignment overflow (range/scale lands exactly on a power
        # of two): widen by one bit rather than clip and violate the bound.
        nbit += 1
    q = np.clip(q, 0, (1 << nbit) - 1)
    return q, QuantMeta(scale=scale, zero_point=zero_point, nbit=nbit)


def dequantize_delta(q: np.ndarray, meta: QuantMeta) -> np.ndarray:
    """Bin-centre reconstruction: ``(q - zp + 0.5) * scale`` (err <= p)."""
    if meta.nbit == 0:
        return np.full(q.shape, meta.mid, dtype=np.float64)
    return (q.astype(np.float64) - meta.zero_point + 0.5) * meta.scale


def extract_msb(q: np.ndarray, meta: QuantMeta, b: int) -> tuple[np.ndarray, QuantMeta]:
    """Flexible loading (Alg. 2 lines 6-8): keep the ``b`` most-significant
    bits of a quantized delta and widen the scale by ``2^(nbit-b)``.
    """
    if meta.nbit <= b:
        return q, meta
    shift = meta.nbit - b
    q_trunc = q >> shift
    meta_trunc = QuantMeta(
        scale=meta.scale * (1 << shift),
        zero_point=meta.zero_point >> shift,
        nbit=b,
        mid=meta.mid,
    )
    return q_trunc, meta_trunc
