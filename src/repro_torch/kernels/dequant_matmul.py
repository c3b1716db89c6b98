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
import math

import torch

from . import ref
from ._build import load_library

__all__ = ["dequant_matmul", "dequant_matmul_int4", "launches", "split_k"]

#: Kernel launches per wrapper (CUDA inputs only; CPU calls do not count).
launches = {"dequant_matmul": 0, "dequant_matmul_int4": 0}

_BLOCK_N = 512   # output columns per block (128 threads x 4)
_ROWS = 8        # rows of x per block
_TILE_K = 64     # K rows per staged tile; split-K chunks are multiples of it

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("dequant_matmul")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.dequant_matmul_int8, lib.dequant_matmul_int4):
            fn.argtypes = [p, p, p, p, p, i, i, i, f, f, f, f, i, i, i, p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_k(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """``(splits, kchunk)``: split K so the grid fills ~2 blocks per SM.

    ``kchunk`` is a multiple of the 64-row tile (so even, as the int4
    kernel's row pairs need) and ``splits * kchunk >= k``.
    """
    blocks = math.ceil(n / _BLOCK_N) * math.ceil(m / _ROWS)
    want = max(1, math.ceil(2 * sms / blocks))
    splits = min(want, math.ceil(k / _TILE_K))
    kchunk = math.ceil(math.ceil(k / splits) / _TILE_K) * _TILE_K
    return math.ceil(k / kchunk), kchunk


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"operands on mixed devices: {[str(t.device) for t in tensors]}")


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
    splits, kchunk = split_k(m, k, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else y)
    vec = int(n % 4 == 0 and base.data_ptr() % 4 == 0 and delta.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), base.data_ptr(), delta.data_ptr(), y.data_ptr(),
                 ws.data_ptr(), m, k, n, *scalars, splits, kchunk, vec, stream)
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
