"""Dispatch seams over the port's CUDA kernels.

``quantized_l2_auto`` (the HNSW distance block) and ``dequant_matmul_auto``
(compute on compressed weights) keep the reference's signatures and its
``force=None/"kernel"/"numpy"`` contract, with one difference of place: on
a CUDA device **every** call launches the kernel (no size gate yet; the
gate for the card is still to be measured, see PERF.md), and nothing on a
CUDA device falls back to a plain path. On the CPU the decomposed forms
stay the path, as in the reference, and ``force="kernel"`` runs the kernel
wrapper, which on CPU tensors is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dequant_matmul as _dm
from . import quantized_l2 as _ql2
from .dequant_matmul import dequant_matmul, dequant_matmul_int4
from .quantized_l2 import quantized_l2

__all__ = ["dequant_matmul", "dequant_matmul_auto", "dequant_matmul_int4",
           "quantized_l2", "quantized_l2_auto", "pack_int4", "resolve_device",
           "launch_counts", "reset_launch_counts", "KERNEL_DISPATCH_MIN_ELEMS"]

# The reference's TPU gate, kept so the seams' signatures match. The port
# ignores it on CUDA devices (every call launches) and on the CPU (the
# decomposed form is always the path there).
KERNEL_DISPATCH_MIN_ELEMS = 4 << 20

_FORCES = (None, "kernel", "numpy")


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    ``"cuda"`` (the entry points' default) raises ``RuntimeError`` when no
    card is present: only an explicit ``"cpu"`` selects the plain path.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' for the plain path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**_dm.launches, **_ql2.launches}


def reset_launch_counts() -> None:
    for counts in (_dm.launches, _ql2.launches):
        for key in counts:
            counts[key] = 0


def _check_force(force) -> None:
    if force not in _FORCES:
        raise ValueError(f"force must be None, 'kernel' or 'numpy': {force!r}")


def _device_of(arr, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    return arr.device if isinstance(arr, torch.Tensor) else torch.device("cpu")


def _tensor(arr, np_dtype, dtype, dev) -> torch.Tensor:
    """``arr`` as a contiguous tensor of ``dtype`` on ``dev``; a host array
    is converted on the host first, so only the narrow type is copied."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(arr, dtype=np_dtype))
    return arr.to(device=dev, dtype=dtype).contiguous()


def quantized_l2_auto(queries, codes, scales, zps, mids, *,
                      min_elems: int = KERNEL_DISPATCH_MIN_ELEMS,
                      force: str | None = None, device=None):
    """Dispatch seam for the HNSW batched-distance block.

    Returns the (B, N) float64 distances of the (B, D) ``queries`` to the
    (N, D) uint8 ``codes`` as a numpy array, or ``None`` so the caller
    (``repro_torch.core.hnsw``) uses its numpy decomposed form.

    ``device`` (default: the device of ``codes`` when it is a tensor, else
    the CPU) decides: on CUDA the kernel always runs (host arrays are
    copied to the card; ``force="numpy"`` raises, there is no plain path
    there); on the CPU the call declines unless ``force="kernel"``, which
    runs the wrapper's plain dense version (the parity-test hook).
    ``min_elems`` is accepted for the reference's signature and unused.
    """
    _check_force(force)
    dev = _device_of(codes, device)
    if dev.type == "cuda":
        if force == "numpy":
            raise ValueError("force='numpy' on a CUDA device: the port has no "
                             "plain distance path on the card")
    elif force != "kernel":
        return None
    q = torch.atleast_2d(_tensor(queries, np.float32, torch.float32, dev))
    c = _tensor(codes, np.uint8, torch.uint8, dev)
    if q.shape[0] == 0:
        return np.zeros((0, c.shape[0]), dtype=np.float64)
    f64 = [_tensor(a, np.float64, torch.float64, dev) for a in (scales, zps, mids)]
    return quantized_l2(q, c, *f64).cpu().numpy()


def pack_int4(delta4):
    """(K, N) values in [0, 15] → (K//2, N) uint8, row 2k low / 2k+1 high.

    Takes and returns a numpy array or a tensor (kept on its device)."""
    k = delta4.shape[0]
    if k % 2:
        raise ValueError(f"pack_int4 needs an even row count, got {k}")
    if isinstance(delta4, torch.Tensor):
        d = delta4.to(torch.uint8)
        return d[0::2] | (d[1::2] << 4)
    d = np.asarray(delta4, dtype=np.uint8)
    return (d[0::2] | (d[1::2] << 4)).astype(np.uint8)


def dequant_matmul_auto(x, base, base_scale, base_zp, delta, delta_scale,
                        delta_zp, *, packed=False,
                        min_elems: int = KERNEL_DISPATCH_MIN_ELEMS,
                        force: str | None = None,
                        scratch: dict | None = None) -> torch.Tensor:
    """Dispatch seam for compute-on-compressed matmuls (the decode loop).

    ``y = x @ (dq(base) + dq(delta))`` without materializing the float
    weight. ``base`` is (K, N) int8 recentred codes; ``delta`` is (K, N)
    int8 recentred codes, or (K//2, N) uint8 nibble-packed when
    ``packed=True`` (``pack_int4`` layout, unsigned codes and zero-point).
    Returns the (M, N) float32 result as a tensor on the operands' device.

    When ``base`` is a CUDA tensor the fused kernel runs (``force=None`` or
    ``"kernel"``; ``"numpy"`` raises) and ``x`` is moved to that device if
    it is not there. On the CPU, ``force="kernel"`` runs the wrapper's
    plain version, and otherwise the decomposed form

        ``y = x@(bs·Bf + ds·Df) + (-bs·bz + ds·(0.5-dz))·rowsum(x)``

    with the pre-scaled float32 ``bs·Bf + ds·Df`` cached in the caller's
    ``scratch`` dict (valid while the operands and scales are fixed).
    ``min_elems`` is accepted for the reference's signature and unused.
    """
    _check_force(force)
    fn = dequant_matmul_int4 if packed else dequant_matmul
    dev = _device_of(base, None)
    if dev.type == "cuda":
        if force == "numpy":
            raise ValueError("force='numpy' on a CUDA device: the port has no "
                             "decomposed path on the card")
        xt = torch.as_tensor(x, device=dev).to(torch.float32).contiguous()
        return fn(xt, base, base_scale, base_zp, delta, delta_scale, delta_zp)
    base = torch.as_tensor(base)
    delta = torch.as_tensor(delta)
    x32 = torch.as_tensor(x).to(torch.float32)
    if force == "kernel":
        return fn(x32.contiguous(), base, base_scale, base_zp, delta,
                  delta_scale, delta_zp)
    ops = scratch.get("cpu") if scratch is not None else None
    if ops is None:
        bf = base.to(torch.float32) * float(np.float32(base_scale))
        if packed:
            # Unpack nibbles to the (K, N) code grid the decomposition needs.
            k2, n = delta.shape
            d = torch.stack([delta & 0xF, delta >> 4], dim=1).reshape(2 * k2, n)
            d = d.to(torch.float32)
        else:
            d = delta.to(torch.float32)
        d *= float(np.float32(delta_scale))
        bf += d
        c = np.float32(-float(base_scale) * float(base_zp)
                       + float(delta_scale) * (0.5 - float(delta_zp)))
        ops = (bf, float(c))
        if scratch is not None:
            scratch["cpu"] = ops
    wf, c = ops
    y = x32 @ wf
    y += c * x32.sum(dim=1, keepdim=True)
    return y
