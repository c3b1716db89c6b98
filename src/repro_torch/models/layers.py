"""Transformer layers: norms, RoPE, attention, MLPs, MoE.

The port of the reference's ``repro/models/layers.py``. Every layer has
(a) a sequence ``forward`` used by prefill and evaluation, and (b) a
single-token ``decode`` step against a cache. Parameters are plain dicts of
tensors with the reference's names and shapes (``wq`` (d_model, H, dh),
``wo`` (H, dh, d_model), ...), so the parameter tree is the checkpoint
format of both packages.

On the card, :func:`chunked_attention` is the hand-written CUDA kernel
(``kernels/flash_attention.py``, through ``ops.flash_attention``), whose
autograd function gives its gradient; on the CPU it is a plain port of the
reference's chunked scan, which autograd differentiates as XLA does the
reference's; on the ``meta`` device (``launch/dryrun.py``) the same scan
gives shapes and operation counts. The reference's sharding constraints
(``sh.constrain`` between layers) are not called here: on a mesh the port
computes each layer on local tensors, gathered by
``launch.shardings.sharded`` (data parallelism; ``distributed.sharding``
holds the rules and a ``constrain`` that redistributes DTensors, which no
layer calls, since tensor-parallel compute over ``model`` is not ported).
``MoE``'s routing and expert products are plain PyTorch, as the
reference's are plain ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops

Params = dict[str, Any]


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std²) drawn in float32 from ``gen``, then cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


# --------------------------------------------------------------------- norms
def rms_norm(x, gamma, eps=1e-6):
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


# ---------------------------------------------------------------------- rope
def rope_freqs(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: (..., S). Split-half rotation."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)               # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0):
    """Softmax attention, grouped GQA: q (B, Sq, H, dh); k, v (B, Sk, KV, dh).

    On CUDA tensors this is the flash-attention kernel, which tiles for
    itself (``chunk`` is unused) and has no query offset (``q_offset != 0``
    raises; ``forward`` never passes one); its backward is
    ``kernels.flash_attention.FlashAttentionFn``'s. On CPU tensors it is the
    reference's scan over KV chunks with running (m, l, acc); ``Sk`` must
    be a multiple of the chunk. ``window > 0`` restricts to a causal local
    window.
    """
    if q.device.type == "cuda":
        if q_offset != 0:
            raise ValueError("chunked_attention on the card has no q_offset "
                             f"(got {q_offset}); decode attends through the cache")
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh)
    scale = 1.0 / (dh ** 0.5)
    ck = min(chunk, sk)
    if sk % ck:
        raise ValueError(f"Sk {sk} is not a multiple of the chunk {ck}")
    dev = q.device  # the CPU here, or the meta device of launch/dryrun.py
    q_pos = (q_offset + torch.arange(sq, device=dev))[:, None]    # (Sq, 1)
    m = torch.full((b, kv, g, sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, sq, dh), dtype=torch.float32, device=dev)
    for k_start in range(0, sk, ck):
        k_c, v_c = k[:, k_start:k_start + ck], v[:, k_start:k_start + ck]
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_c).to(torch.float32) * scale
        k_pos = (k_start + torch.arange(ck, device=dev))[None, :]  # (1, ck)
        mask = torch.ones((sq, ck), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(v_c.dtype), v_c).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]              # (B,KV,G,Sq,dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttentionBlock:
    """GQA attention with RoPE, optional qk-norm and local window."""

    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float
    causal: bool = True
    window: int = 0
    qk_norm: bool = False
    chunk: int = 1024
    norm_eps: float = 1e-6

    def init(self, gen, d_model, dtype, device, lead=()):
        """Parameters with ``lead`` stacked axes (the period axis)."""
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        std = d_model ** -0.5
        lead = tuple(lead)
        p = {
            "wq": _normal(gen, lead + (d_model, h, dh), std, dtype, device),
            "wk": _normal(gen, lead + (d_model, kv, dh), std, dtype, device),
            "wv": _normal(gen, lead + (d_model, kv, dh), std, dtype, device),
            "wo": _normal(gen, lead + (h, dh, d_model), std * (2 * h) ** -0.5, dtype, device),
        }
        if self.qk_norm:
            p["q_norm"] = torch.ones(lead + (dh,), dtype=dtype, device=device)
            p["k_norm"] = torch.ones(lead + (dh,), dtype=dtype, device=device)
        return p

    def _qkv(self, p, x, positions):
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if self.qk_norm:
            q = rms_norm(q, p["q_norm"], self.norm_eps)
            k = rms_norm(k, p["k_norm"], self.norm_eps)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def forward(self, p, x, positions):
        """x: (B, S, D) → (B, S, D); full sequence (prefill / evaluation)."""
        q, k, v = self._qkv(p, x, positions)
        o = chunked_attention(q, k, v, causal=self.causal, window=self.window,
                              chunk=self.chunk)
        return torch.einsum("bshk,hkd->bsd", o, p["wo"])

    # ------------------------------------------------------------- decode
    def init_cache(self, batch, max_len, dtype, device, lead=()):
        # Layout (B, KV, S, dh), as the reference's: the decode einsums
        # contract over the trailing (S, dh).
        kv, dh = self.n_kv_heads, self.d_head
        length = min(max_len, self.window) if self.window else max_len
        shape = tuple(lead) + (batch, kv, length, dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, p, x, cache, pos: int):
        """x: (B, 1, D); ``pos`` the absolute position. Returns (out, cache).

        Unlike the reference, which returns a new cache, the new K/V row is
        written into ``cache`` in place (the returned dict is ``cache``): a
        full copy of the cache per token is what the in-place write saves.
        """
        pos = int(pos)
        positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
        q, k, v = self._qkv(p, x, positions)
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[2]
        slot = (pos % length) if self.window else pos
        ck[:, :, slot] = k[:, 0]                            # (B, KV, dh)
        cv[:, :, slot] = v[:, 0]
        kv, g = self.n_kv_heads, self.n_heads // self.n_kv_heads
        b = q.shape[0]
        qg = q.reshape(b, 1, kv, g, self.d_head)[:, 0]      # (B, KV, G, dh)
        scale = 1.0 / (self.d_head ** 0.5)
        s = torch.einsum("bkgd,bksd->bkgs", qg, ck).to(torch.float32) * scale
        k_idx = torch.arange(length, device=x.device)
        if self.window:
            # Ring buffer: entry j holds absolute position
            # a_j = pos - ((slot - j) mod L); valid iff a_j >= 0.
            valid = (pos - torch.remainder(slot - k_idx, length)) >= 0
        else:
            valid = k_idx <= pos
        s = torch.where(valid, s, -1e30)
        w = torch.softmax(s, dim=-1).to(cv.dtype)
        o = torch.einsum("bkgs,bksd->bkgd", w, cv)
        o = o.reshape(b, 1, self.n_heads, self.d_head)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
        return out, cache


# ---------------------------------------------------------------------- MLPs
@dataclasses.dataclass(frozen=True)
class SwiGLU:
    d_ff: int

    def init(self, gen, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        std_in, std_out = d_model ** -0.5, self.d_ff ** -0.5
        return {
            "wg": _normal(gen, lead + (d_model, self.d_ff), std_in, dtype, device),
            "wu": _normal(gen, lead + (d_model, self.d_ff), std_in, dtype, device),
            "wd": _normal(gen, lead + (self.d_ff, d_model), std_out, dtype, device),
        }

    def forward(self, p, x):
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
        return h @ p["wd"]


@dataclasses.dataclass(frozen=True)
class GeluMLP:
    d_ff: int

    def init(self, gen, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        return {
            "w1": _normal(gen, lead + (d_model, self.d_ff), d_model ** -0.5, dtype, device),
            "w2": _normal(gen, lead + (self.d_ff, d_model), self.d_ff ** -0.5, dtype, device),
        }

    def forward(self, p, x):
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


@dataclasses.dataclass(frozen=True)
class MoE:
    """Top-k routed experts with capacity-based dispatch (GShard-style, per
    batch row), optionally beside a dense SwiGLU residual (arctic)."""

    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False

    def init(self, gen, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        e, f = self.n_experts, self.d_ff
        std_in = d_model ** -0.5
        p = {
            "router": _normal(gen, lead + (d_model, e), std_in, torch.float32, device),
            "wg": _normal(gen, lead + (e, d_model, f), std_in, dtype, device),
            "wu": _normal(gen, lead + (e, d_model, f), std_in, dtype, device),
            "wd": _normal(gen, lead + (e, f, d_model), f ** -0.5, dtype, device),
        }
        if self.dense_residual:
            p["dense"] = SwiGLU(self.d_ff).init(gen, d_model, dtype, device, lead)
        return p

    def capacity(self, n_tokens: int) -> int:
        """Slots an expert has in one batch row of ``n_tokens`` tokens."""
        return max(int(self.capacity_factor * self.top_k * n_tokens / self.n_experts),
                   self.top_k)

    def route(self, p, x):
        """The routing of x (B, S, D): (gates (B, S·k) renormalised over the
        top k, float32; dest (B, S·k), each (token, choice)'s slot
        ``expert · cap + position`` or the overflow row ``E · cap`` past
        capacity; cap). Positions come from a cumsum within each row over
        the flattened (S·k) order, as in the reference."""
        b, s, _ = x.shape
        e, k = self.n_experts, self.top_k
        cap = self.capacity(s)
        gates = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)   # (B, S, E)
        top_g, top_e = torch.topk(gates, k, dim=-1)                        # (B, S, k)
        top_g = top_g / torch.clamp_min(top_g.sum(dim=-1, keepdim=True), 1e-9)
        flat_e = top_e.reshape(b, s * k)
        onehot = F.one_hot(flat_e, e)                                       # (B, S·k, E)
        pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=-1)     # (B, S·k)
        dest = torch.where(pos < cap, flat_e * cap + pos, e * cap)
        return top_g.reshape(b, s * k), dest, cap

    def forward(self, p, x):
        """x (B, S, D) → (B, S, D). Tokens past an expert's capacity in their
        row are dropped (their slot is the overflow row, which is never
        computed). Expert products are einsums over (B, E, C, D)."""
        b, s, d = x.shape
        e, k = self.n_experts, self.top_k
        gates, dest, cap = self.route(p, x)
        tok = torch.arange(s * k, device=x.device) // k
        idx = dest[..., None].expand(b, s * k, d)
        xe = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
        xe = xe.scatter_add(1, idx, x[:, tok])
        xe = xe[:, :e * cap].reshape(b, e, cap, d)
        h = F.silu(torch.einsum("becd,edf->becf", xe, p["wg"]))
        h = h * torch.einsum("becd,edf->becf", xe, p["wu"])
        ye = torch.einsum("becf,efd->becd", h, p["wd"])
        ye_flat = torch.cat([ye.reshape(b, e * cap, d),
                             torch.zeros((b, 1, d), dtype=ye.dtype, device=ye.device)], dim=1)
        y = torch.gather(ye_flat, 1, idx) * gates[..., None].to(ye.dtype)
        y = y.reshape(b, s, k, d).sum(dim=2)
        if self.dense_residual:
            y = y + SwiGLU(self.d_ff).forward(p["dense"], x)
        return y
