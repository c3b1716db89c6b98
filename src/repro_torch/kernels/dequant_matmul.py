"""Fused dequantize-and-matmul on compressed weights: CUDA kernels.

The card's form of NeurStore's compression-aware inference (paper §4.3):
the weight stays in device memory as int8 base codes plus int8 (or
int4-packed) delta codes and is dequantized in registers inside the
product (``csrc/dequant_matmul.cu``), so the float weight never exists.
Device-memory bytes per weight element: 2.0 (int8 + int8), 1.5 (int8 +
int4), against 4.0 for the float32 weight.

Each wrapper takes the kernel for CUDA tensors and the plain version of
``ref.py`` for CPU tensors; a CUDA input it cannot take raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from . import ref
from ._build import load_library

__all__ = ["Plan", "dequant_matmul", "dequant_matmul_int4", "foldable", "launches", "plan"]

#: Kernel launches per wrapper (CUDA inputs only; CPU calls do not count).
launches = {"dequant_matmul": 0, "dequant_matmul_int4": 0}

_COLS = 16          # output columns a thread (one 16-byte code load a row)
_ROWS = 4           # rows of x a block (the kernel's row group)
_CLUSTER = 7        # blocks of a cluster splitting K (at most 8, the portable size)
_MIN_KBLOCK = 64    # K rows a block of a cluster takes at least

_lib = None
_sms: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("dequant_matmul")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.dequant_matmul_int8, lib.dequant_matmul_int4):
            fn.argtypes = [p, p, p, p, i, i, i, f, f, f, f, i, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of ``dq_matmul_kernel``, passed to it as its grid.

    A block takes 4 rows of x (``groups`` row groups on grid.y) and a strip
    of ``16 * tn`` output columns (``strips`` of them); ``cluster`` blocks
    of a thread block cluster split K, the block of rank r taking rows
    ``[r * kblock, min(K, (r + 1) * kblock))``, and block 0 adds their sums.
    """

    groups: int
    tn: int
    strips: int
    cluster: int
    kblock: int

    @property
    def blocks(self) -> int:
        return self.groups * self.strips * self.cluster


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, sms: int, packed: bool = False) -> Plan:
    """The launch for x (m, k) on a (k, n) weight on a card of ``sms`` SMs.

    Narrow weights (fewer 512-column strips than SMs) split K over a
    cluster of 7 blocks and take the widest strip that then gives every SM
    a block; wide ones take no cluster and the widest strip that gives
    every SM 4 blocks or more. On an H100 at the decode shapes these were
    the fastest plans that leave no SM idle (``launch/bench_dequant.py``):
    clusters of 8 ran 1.3-1.5x slower than 7, and fewer blocks, or more
    blocks in smaller clusters, left some SMs with one block more than the
    rest. K is split no finer than 64 rows a block, and in row pairs for
    the int4 kernel (``packed``).
    """
    groups = max(1, math.ceil(m / _ROWS))

    def tiles(tn: int) -> int:  # blocks of one cluster rank
        return math.ceil(n / (_COLS * tn)) * groups

    if tiles(32) >= sms:
        cluster, want = 1, 4 * sms
    else:
        cluster = max(1, min(_CLUSTER, math.ceil(k / _MIN_KBLOCK)))
        want = sms
    tn = next((t for t in (32, 16, 8, 4) if tiles(t) * cluster >= want), 2)
    unit = 2 if packed else 1
    kblock = max(unit, math.ceil(math.ceil(k / cluster) / unit) * unit)
    return Plan(groups, tn, math.ceil(n / (_COLS * tn)), max(1, math.ceil(k / kblock)), kblock)


@functools.lru_cache(maxsize=1024)
def foldable(base_zp: float, delta_zp: float, packed: bool) -> bool:
    """Whether the kernel may subtract a zero-point together with the 2^23
    offset of its code-to-float step, as its 16-byte path does: true when
    ``2^23 + 128 + bz`` and the delta's ``2^23 (+ 128 for int8) + dz`` are
    exact float32 sums (integer zero-points in range), so one rounding gives
    the same float as the reference's ``code - zp``."""
    def exact(off: float, zp: float) -> bool:
        zp32 = float(np.float32(zp))
        total = np.float32(off) + np.float32(zp32)
        return float(total) == off + zp32
    return exact(8388736.0, base_zp) and exact(8388608.0 if packed else 8388736.0, delta_zp)


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"operands on mixed devices: {[str(t.device) for t in tensors]}")


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _launch(name, fn, x, base, delta, scalars, delta_rows):
    m, k = x.shape
    if base.shape[0] != k or delta.shape != (delta_rows, base.shape[1]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, base "
                         f"{tuple(base.shape)}, delta {tuple(delta.shape)} disagree")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    for t in (x, base, delta):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    n = base.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    dev = x.device
    packed = name == "dequant_matmul_int4"
    p = plan(m, k, n, _sm_count(dev), packed)
    # The 16-byte path needs every code row to start on 16 bytes, and
    # zero-points that fold into its code-to-float subtraction.
    vec = int(n % 16 == 0 and base.data_ptr() % 16 == 0 and delta.data_ptr() % 16 == 0
              and foldable(scalars[1], scalars[3], packed))
    args = (x.data_ptr(), base.data_ptr(), delta.data_ptr(), y.data_ptr(), m, k, n, *scalars,
            p.groups, p.tn, p.strips, p.cluster, p.kblock, vec)
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
    return y


def _scalars(base_scale, base_zp, delta_scale, delta_zp):
    return tuple(float(v) for v in (base_scale, base_zp, delta_scale, delta_zp))


def dequant_matmul(x, base, base_scale, base_zp, delta, delta_scale, delta_zp):
    """y (M, N) float32 = x (M, K) @ (dq(base) + dq(delta)).

    ``base`` and ``delta`` are (K, N) int8 codes, the four quantization
    parameters scalars. CUDA tensors launch the kernel; CPU tensors take
    :func:`ref.dequant_matmul`.
    """
    if _on_cpu(x, base, delta):
        return ref.dequant_matmul(x, base, base_scale, base_zp, delta,
                                  delta_scale, delta_zp)
    if base.dtype != torch.int8 or delta.dtype != torch.int8:
        raise TypeError(f"dequant_matmul: codes must be int8, got "
                        f"{base.dtype}/{delta.dtype}")
    return _launch("dequant_matmul", _library().dequant_matmul_int8, x, base, delta,
                   _scalars(base_scale, base_zp, delta_scale, delta_zp),
                   base.shape[0])


def dequant_matmul_int4(x, base, base_scale, base_zp, packed_delta,
                        delta_scale, delta_zp):
    """As :func:`dequant_matmul` with ``packed_delta`` (K/2, N) uint8, two
    unsigned nibble codes a byte (row 2k low, 2k+1 high); K must be even."""
    if _on_cpu(x, base, packed_delta):
        return ref.dequant_matmul_int4(x, base, base_scale, base_zp, packed_delta,
                                       delta_scale, delta_zp)
    if base.dtype != torch.int8 or packed_delta.dtype != torch.uint8:
        raise TypeError(f"dequant_matmul_int4: want int8 base and uint8 packed "
                        f"delta, got {base.dtype}/{packed_delta.dtype}")
    if base.shape[0] % 2:
        raise ValueError(f"dequant_matmul_int4: K must be even, got {base.shape[0]}")
    return _launch("dequant_matmul_int4", _library().dequant_matmul_int4, x, base,
                   packed_delta, _scalars(base_scale, base_zp, delta_scale, delta_zp),
                   base.shape[0] // 2)
