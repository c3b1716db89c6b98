"""Batched quantized-L2 distance: CUDA kernel for the HNSW distance block.

The card's form of the paper's AVX2 ``QuantizedL2Space`` (§5): B float32
queries against N rows of uint8 codes with per-row scale, zero-point and
mid, from the decomposed code moments (Σc·q, Σc, Σc²), so the dequantized
rows never exist. One launch takes the whole (B, D) query block, which is
what ``HNSWIndex._distance_block`` asks for; ``csrc/quantized_l2.cu`` says
how D is split across blocks.

The wrapper takes the kernel for CUDA tensors and :func:`ref.quantized_l2`
(dense, float64) for CPU tensors; a CUDA input it cannot take raises.

Precision: as in the reference, the float32 Σc·q carries an absolute error
~``s·‖q‖·ε₃₂·√D``, so the relative error can reach ~1e-2 when a query nearly
coincides with a row; ranking, the only thing the index consumes, holds.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import ref
from ._build import load_library

__all__ = ["quantized_l2", "launches", "chunking"]

#: Kernel launches (CUDA inputs only; CPU calls do not count).
launches = {"quantized_l2": 0}

_THREADS = 256
_VEC = 8
_ROWS = 8                 # code rows per block
_QUERIES = 4             # queries per block
_MAX_PER_THREAD = 32768   # 32768 * 255**2 < 2**31: int32 moments per thread

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("quantized_l2")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantized_l2.argtypes = [p] * 11 + [i, i, ll, i, ll, i, p]
        lib.quantized_l2.restype = ctypes.c_int
        _lib = lib
    return _lib


def chunking(b: int, n: int, d: int, sms: int) -> tuple[int, int]:
    """``(nchunks, chunk)``: split D so the grid fills ~4 blocks per SM,
    with a thread's share of a chunk small enough for int32 moments."""
    tiles = math.ceil(n / _ROWS) * math.ceil(b / _QUERIES)
    target = max(1, (4 * sms) // tiles)
    step = _THREADS * _VEC
    chunk = math.ceil(math.ceil(d / target) / step) * step
    chunk = min(max(chunk, step), _THREADS * _MAX_PER_THREAD)
    return math.ceil(d / chunk), chunk


def quantized_l2(queries, codes, scales, zps, mids):
    """(B, N) float64 squared L2 from float32 ``queries`` (B, D) to uint8
    ``codes`` (N, D) with float64 ``scales``/``zps``/``mids`` (N,)."""
    tensors = (queries, codes, scales, zps, mids)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return ref.quantized_l2(queries, codes, scales, zps, mids)
    if len(devices) != 1 or queries.device.type != "cuda":
        raise ValueError(f"quantized_l2: operands on mixed devices: {devices}")
    if queries.dim() != 2 or codes.dim() != 2 or queries.shape[1] != codes.shape[1]:
        raise ValueError(f"quantized_l2: queries {tuple(queries.shape)} vs codes "
                         f"{tuple(codes.shape)}")
    n, d = codes.shape
    b = queries.shape[0]
    if any(t.shape != (n,) for t in (scales, zps, mids)):
        raise ValueError("quantized_l2: scales/zps/mids must be (N,)")
    if queries.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"quantized_l2: want float32 queries and uint8 codes, got "
                        f"{queries.dtype}/{codes.dtype}")
    if any(t.dtype != torch.float64 for t in (scales, zps, mids)):
        raise TypeError("quantized_l2: scales/zps/mids must be float64")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("quantized_l2: operands must be contiguous")
    dev = queries.device
    out = torch.empty((b, n), dtype=torch.float64, device=dev)
    if b == 0 or n == 0:
        return out
    if d == 0:
        # No columns: only the constant rows' D·mid² term, which is 0 too.
        return out.zero_()
    nchunks, chunk = chunking(b, n, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    dotp = torch.empty((nchunks, b, n), dtype=torch.float32, device=dev)
    sump = torch.empty((nchunks, n), dtype=torch.int64, device=dev)
    sqp = torch.empty((nchunks, n), dtype=torch.int64, device=dev)
    qsqp = torch.empty((nchunks, b), dtype=torch.float64, device=dev)
    qsump = torch.empty((nchunks, b), dtype=torch.float64, device=dev)
    vec = int(d % _VEC == 0 and queries.data_ptr() % 16 == 0
              and codes.data_ptr() % 8 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().quantized_l2(
            queries.data_ptr(), codes.data_ptr(), scales.data_ptr(), zps.data_ptr(),
            mids.data_ptr(), out.data_ptr(), dotp.data_ptr(), sump.data_ptr(),
            sqp.data_ptr(), qsqp.data_ptr(), qsump.data_ptr(), b, n, d, nchunks,
            chunk, vec, stream)
    if err != 0:
        raise RuntimeError(f"quantized_l2: CUDA launch failed with error {err}")
    launches["quantized_l2"] += 1
    return out
