"""Plain PyTorch versions of the port's CUDA kernels.

These define the semantics the kernels must reproduce, in the reference's
own float arithmetic: each kernel wrapper falls back to its function here
only for tensors that lie on the CPU, and ``chip_smoke.py`` holds every
kernel against its plain version on the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "dequantize_weight",
    "dequant_matmul",
    "unpack_int4",
    "dequant_matmul_int4",
    "quantized_l2",
    "flash_attention",
]


def dequantize_weight(base, base_scale, base_zp, delta, delta_scale, delta_zp):
    """W = dq(base) + dq(delta) in float32: plain asymmetric dequant for the
    base, bin-centre dequant for the delta (``quantize.dequantize_delta``)."""
    b = (base.to(torch.float32) - base_zp) * base_scale
    d = (delta.to(torch.float32) - delta_zp + 0.5) * delta_scale
    return b + d


def dequant_matmul(x, base, base_scale, base_zp, delta, delta_scale, delta_zp):
    """y = x @ (dq(base) + dq(delta)); x (M, K) float, base/delta (K, N) int8."""
    w = dequantize_weight(base, base_scale, base_zp, delta, delta_scale, delta_zp)
    return x.to(torch.float32) @ w


def unpack_int4(packed):
    """(K//2, N) uint8 → (K, N) int32 in [0, 15]; row 2k = low nibble."""
    low = (packed & 0xF).to(torch.int32)
    high = (packed >> 4).to(torch.int32)
    k2, n = packed.shape
    return torch.stack([low, high], dim=1).reshape(2 * k2, n)


def dequant_matmul_int4(x, base, base_scale, base_zp, packed_delta,
                        delta_scale, delta_zp):
    """:func:`dequant_matmul` with the delta 4-bit packed, two codes a byte."""
    return dequant_matmul(x, base, base_scale, base_zp, unpack_int4(packed_delta),
                          delta_scale, delta_zp)


def quantized_l2(queries, codes, scales, zps, mids):
    """(B, N) float64 squared L2 from each query row to N quantized rows.

    Row n dequantizes as ``(codes[n] - zps[n]) * scales[n]``, or the
    constant ``mids[n]`` when ``scales[n] == 0``. Dense: every row is
    dequantized and the difference squared in float64 (the semantics of
    the reference's ``hnsw_ref.quantized_l2_batch_dense``), one query at a
    time so the temporaries stay (N, D).
    """
    q = torch.atleast_2d(queries).to(torch.float64)
    s = scales.to(torch.float64)[:, None]
    deq = (codes.to(torch.float64) - zps.to(torch.float64)[:, None]) * s
    deq = torch.where(s == 0.0, mids.to(torch.float64)[:, None], deq)
    out = torch.empty((q.shape[0], codes.shape[0]), dtype=torch.float64,
                      device=codes.device)
    for b in range(q.shape[0]):
        diff = deq - q[b]
        out[b] = (diff * diff).sum(dim=1)
    return out


def flash_attention(q, k, v, *, causal=True, window=0, sk_true=None):
    """Grouped-GQA softmax attention with causal / local / key-length masks.

    q (B, Sq, H, dh); k, v (B, Sk, KV, dh) → (B, Sq, H, dh) in q's dtype.
    Full float32 scores, the bias -1e30 where ``k_pos >= sk_true`` (default
    Sk), where ``q_pos < k_pos`` if ``causal`` and where ``q_pos - k_pos >=
    window`` if ``window > 0``, then the softmax and ``w @ v``, in the
    layout of the reference's ``flash_attention_ref`` (which has no
    ``sk_true``).
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh).to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.to(torch.float32))
    s = s / (dh ** 0.5)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = kp < (sk if sk_true is None else sk_true)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bkgqd", w, v.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)
