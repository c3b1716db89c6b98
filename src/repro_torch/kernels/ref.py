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
    "flash_attention_backward",
    "BACKWARD_CHUNK",
]

#: Keys a chunk of :func:`flash_attention_backward`: its float32 blocks are
#: at most (B, H, Sq, chunk), 134 MB at the internlm2 train shape (B 4,
#: H 16, Sq 2048), where the full scores would be 1 GB a layer; under a
#: causal mask a chunk takes only the rows at or past its first key, 56 %
#: of the (Sq, Sk) area at that shape.
BACKWARD_CHUNK = 256


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


def _blocks(sq: int, sk: int, chunk: int, causal: bool, window: int, sk_true: int):
    """(s0, s1, r0, r1, full) for each key chunk [s0, s1): the query rows
    [r0, r1) that see a key of it, and whether they see every key of it.

    Rows outside [r0, r1) add exactly 0 to the gradients through the chunk
    (p = exp(-1e30 - m) is 0), and a chunk no row sees is left out, unless
    some row sees no key at all: such a row takes a uniform softmax over
    all Sk keys, as in the forward, and then every chunk takes every row.
    The masks' bounds are non-decreasing in the row, so the rows that see a
    chunk are one range. Host arithmetic; nothing is read from the device."""
    qp = torch.arange(sq)
    hi = torch.full((sq,), sk_true)
    if causal:
        hi = torch.minimum(hi, qp + 1)
    lo = (qp - window + 1).clamp_min(0) if window > 0 else torch.zeros(sq, dtype=torch.int64)
    bounds = [(s0, min(s0 + chunk, sk)) for s0 in range(0, sk, chunk)]
    if bool((hi <= lo).any()):
        return [(s0, s1, 0, sq, False) for s0, s1 in bounds]
    out = []
    for s0, s1 in bounds:
        rows = torch.nonzero(lo.clamp_min(s0) < hi.clamp_max(s1)).flatten()
        if rows.numel():
            r0, r1 = int(rows[0]), int(rows[-1]) + 1
            full = bool(((lo[r0:r1] <= s0) & (hi[r0:r1] >= s1)).all())
            out.append((s0, s1, r0, r1, full))
    return out


def flash_attention_backward(q, k, v, do, *, causal=True, window=0, sk_true=None,
                             chunk=BACKWARD_CHUNK):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v for the output
    gradient ``do`` (B, Sq, H, dh), each in its input's dtype.

    Exact float32 arithmetic over key chunks of ``chunk`` keys (any Sk; the
    last chunk may be short), each with only the query rows that see it
    (:func:`_blocks`), never a full (Sq, Sk) block: a first sweep rebuilds
    the softmax's row max m, sum l and the float32 output o, a second forms
    p = exp(s - m) / l, dp = do vᵀ and ds = p (dp - D) with
    D = rowsum(do ∘ o), then dv = pᵀ do, dk = dsᵀ q / √dh and
    dq = ds k / √dh. Masked scores are constants (the bias -1e30), so ds is
    0 there; dk and dv of a KV head sum over its G query heads.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    sk_true = sk if sk_true is None else int(sk_true)
    f32, dev = torch.float32, q.device
    if q.numel() == 0 or sk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # Head-major float32 copies, so each block's products are batched
    # matmuls over (B, KV, G) on views: q scaled by 1/√dh once, (B, KV, G,
    # Sq, dh); k and v (B, KV, 1, Sk, dh), shared by the G query heads.
    qs = (q.reshape(b, sq, kv, g, dh).permute(0, 2, 3, 1, 4).to(f32) / dh ** 0.5).contiguous()
    dos = do.reshape(b, sq, kv, g, dh).permute(0, 2, 3, 1, 4).to(f32).contiguous()
    ks = k.permute(0, 2, 1, 3).to(f32).contiguous()[:, :, None]
    vs = v.permute(0, 2, 1, 3).to(f32).contiguous()[:, :, None]
    blocks = _blocks(sq, sk, chunk, causal, window, sk_true)

    def scores(s0, s1, r0, r1, full):
        s = torch.matmul(qs[:, :, :, r0:r1], ks[:, :, :, s0:s1].transpose(-1, -2))
        if full:
            return s, None
        qp = torch.arange(r0, r1, device=dev)[:, None]
        kp = torch.arange(s0, s1, device=dev)[None, :]
        mask = kp < sk_true
        if causal:
            mask = mask & (qp >= kp)
        if window > 0:
            mask = mask & ((qp - kp) < window)
        return s.masked_fill_(~mask, -1e30), mask

    # Sweep 1: the softmax's statistics and the float32 output.
    m = torch.full((b, kv, g, sq), -torch.inf, dtype=f32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=f32, device=dev)
    acc = torch.zeros((b, kv, g, sq, dh), dtype=f32, device=dev)
    for s0, s1, r0, r1, full in blocks:
        s, _ = scores(s0, s1, r0, r1, full)
        m_r = m[..., r0:r1]
        m_new = torch.maximum(m_r, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m_r - m_new)
        l[..., r0:r1] = l[..., r0:r1] * corr + p.sum(dim=-1)
        acc[..., r0:r1, :] = (acc[..., r0:r1, :] * corr[..., None]
                              + torch.matmul(p, vs[:, :, :, s0:s1]))
        m[..., r0:r1] = m_new
    inv_l = 1.0 / l
    d_row = (dos * acc).sum(dim=-1).mul_(inv_l)         # D = rowsum(do ∘ o)
    del acc

    # Sweep 2: the gradients.
    dq = torch.zeros_like(qs)
    dk = torch.zeros((b, kv, sk, dh), dtype=f32, device=dev)
    dv = torch.zeros((b, kv, sk, dh), dtype=f32, device=dev)
    for s0, s1, r0, r1, full in blocks:
        s, mask = scores(s0, s1, r0, r1, full)
        p = s.sub_(m[..., r0:r1, None]).exp_().mul_(inv_l[..., r0:r1, None])
        do_r = dos[:, :, :, r0:r1]
        ds = torch.matmul(do_r, vs[:, :, :, s0:s1].transpose(-1, -2))
        ds.sub_(d_row[..., r0:r1, None]).mul_(p)
        if mask is not None:
            ds.masked_fill_(~mask, 0.0)
        dv[:, :, s0:s1] = torch.matmul(p.transpose(-1, -2), do_r).sum(dim=2)
        dk[:, :, s0:s1] = torch.matmul(ds.transpose(-1, -2), qs[:, :, :, r0:r1]).sum(dim=2)
        dq[:, :, :, r0:r1] += torch.matmul(ds, ks[:, :, :, s0:s1])
    dq = dq.div_(dh ** 0.5).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
