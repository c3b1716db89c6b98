"""Batched quantized-L2 distance: CUDA kernel for the HNSW distance block.

The card's form of the paper's AVX2 ``QuantizedL2Space`` (§5): B float32
queries against N rows of uint8 codes with per-row scale, zero-point and
mid, from the decomposed code moments (Σc·q, Σc, Σc²), so the dequantized
rows never exist. One launch takes the whole (B, D) query block, which is
what ``HNSWIndex._distance_block`` asks for; ``csrc/quantized_l2.cu`` says
how the blocks split it and how the last block of a tile adds their sums.

The wrapper takes the kernel for CUDA tensors and :func:`ref.quantized_l2`
(dense, float64) for CPU tensors; a CUDA input it cannot take raises.

Precision: the kernel sums c·q, q·q and Σq in float32 over 16 elements and
in float64 beyond, so its error is far below the reference's decomposed form, whose
float32 Σc·q carries an absolute error ~``s·‖q‖·ε₃₂·√D`` (relative error
up to ~1e-2 when a query nearly coincides with a row); the contract is the
reference's: rtol 2e-3 against the plain version, with the same argmin.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import ref
from ._build import load_library

__all__ = ["Plan", "launches", "plan", "quantized_l2"]

#: Kernel launches (CUDA inputs only; CPU calls do not count).
launches = {"quantized_l2": 0}

_THREADS = 256
_STEP = 16                # elements a thread a step on the 16-byte path
_MAX_PER_THREAD = 32768   # 32768 * 255**2 < 2**31: exact uint32 moments per thread
_ROWS = 4                 # code rows a tile

_lib = None
_sms: dict[int, int] = {}
# Partials and tickets a (device, stream): calls on one stream run in turn.
_workspace: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("quantized_l2")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantized_l2.argtypes = [p] * 8 + [i, i, ll, i, i, i, ll, p]
        lib.quantized_l2.restype = ctypes.c_int
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of ``ql2_kernel``: tiles of ``qb`` queries by 4 code rows,
    each split into ``nchunks`` chunks of ``chunk`` elements of D, one
    block a chunk; ``vec`` takes the 16-byte loads."""

    qb: int
    vec: bool
    tiles: int
    nchunks: int
    chunk: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.nchunks

    @property
    def partials(self) -> int:
        """float64 partial moments a block of a tile writes."""
        return _ROWS * self.qb + 2 * self.qb + 2 * _ROWS


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, d: int, sms: int, vec: bool = True) -> Plan:
    """The launch for (b, d) queries against (n, d) codes on ``sms`` SMs.

    A tile takes 4 code rows and 1, 2 or 4 queries (B = 1, 2, more) on the
    16-byte path, 4 on the element path; D is cut into even chunks (whole 16-element
    steps on the 16-byte path, at least one step a thread) that give a
    tile's blocks one wave over the card (two blocks an SM below 4 queries
    a tile, one at 4: the kernel's launch bounds), and enough of them that
    no thread takes more than 32768 elements."""
    qb = (1 if b == 1 else 2 if b == 2 else 4) if vec else 4
    tiles = math.ceil(n / _ROWS) * math.ceil(b / qb)
    unit = _STEP if vec else 1
    wave = max(1, ((2 if qb < 4 else 1) * sms) // tiles)
    want = max(wave, math.ceil(d / (_THREADS * _MAX_PER_THREAD)))
    # At least one step for every thread of a block, in whole steps.
    chunk = max(math.ceil(math.ceil(d / want) / unit) * unit, _THREADS * unit)
    return Plan(qb, vec, tiles, math.ceil(d / chunk), chunk)


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _scratch(dev: torch.device, stream: int, p: Plan) -> tuple[int, int]:
    """Pointers to the partials and zeroed tickets ``p`` needs (none for a
    single chunk); grown, never shrunk, and kept a (device, stream)."""
    if p.nchunks == 1:
        return 0, 0
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
    part, tickets = _workspace.get(key, (None, None))
    if part is None or part.numel() < p.blocks * p.partials or tickets.numel() < p.tiles:
        part = torch.empty(max(p.blocks * p.partials, 1 << 16), dtype=torch.float64, device=dev)
        tickets = torch.zeros(max(p.tiles, 1024), dtype=torch.int32, device=dev)
        _workspace[key] = (part, tickets)
    return part.data_ptr(), tickets.data_ptr()


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
    vec = d % _STEP == 0 and queries.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0
    p = plan(b, n, d, _sm_count(dev), vec)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, tickets = _scratch(dev, stream, p)
    args = (queries.data_ptr(), codes.data_ptr(), scales.data_ptr(), zps.data_ptr(),
            mids.data_ptr(), out.data_ptr(), part, tickets, b, n, d, p.qb, int(p.vec),
            p.nchunks, p.chunk, stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _library().quantized_l2(*args)
    else:
        with torch.cuda.device(dev):
            err = _library().quantized_l2(*args)
    if err != 0:
        raise RuntimeError(f"quantized_l2: CUDA launch failed with error {err}")
    launches["quantized_l2"] += 1
    return out
