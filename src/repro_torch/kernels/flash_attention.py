"""Forward flash attention (grouped GQA, causal / local window): CUDA kernel.

``csrc/flash_attention.cu`` keeps the scores, the running max and sum and
the accumulator on chip across the key sweep; only q, k, v and the output
touch device memory. It reads q (B, Sq, H, dh) and k/v (B, Sk, KV, dh)
through their strides, so no transposed or padded copy is made, and serves
all G = H / KV query heads of a KV head from one staged K/V tile.

The wrapper takes the kernel for CUDA tensors and the plain version of
``ref.py`` for CPU tensors; a CUDA input it cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import load_library
from .dequant_matmul import _on_cpu

__all__ = ["HEAD_DIMS", "flash_attention", "launches"]

#: Kernel launches (CUDA inputs only; CPU calls do not count).
launches = {"flash_attention": 0}

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("flash_attention")
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_attention_fwd.argtypes = ([p, p, p, p] + [i] * 7 + [ll] * 9
                                            + [i, i, i, f, p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention(q, k, v, *, causal=True, window=0, sk_true=None):
    """Softmax attention of q (B, Sq, H, dh) over k, v (B, Sk, KV, dh).

    Grouped GQA (query head h reads KV head h // (H // KV)), masks
    ``k_pos < sk_true`` (default Sk), causal ``q_pos >= k_pos`` and, for
    ``window > 0``, ``q_pos - k_pos < window``; masked scores take the
    bias -1e30. Returns (B, Sq, H, dh) in q's dtype. CUDA tensors (float32
    or bfloat16, one dtype, dh in ``HEAD_DIMS``, last dimension contiguous)
    launch the kernel; CPU tensors take :func:`ref.flash_attention`.
    """
    if _on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, dh) or v.shape != k.shape or kv == 0 or h % kv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    sk_true = sk if sk_true is None else int(sk_true)
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    if sk == 0:
        return o.zero_()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
            b, sq, sk, h, kv, dh, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), int(window), sk_true, 1.0 / dh ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with error {err}")
    launches["flash_attention"] += 1
    return o
