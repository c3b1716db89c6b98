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
gives shapes and operation counts.

The reference's sharding constraints are called where it calls them
(``sh.constrain`` on ``"heads"``, ``"kv_heads"``, ``"ffn"`` and
``"residual"``), with its names: outside a tensor-parallel step they do
nothing. Inside one (``launch.shardings.sharded`` on the ``"tp"`` route)
the activations and weights are DTensors over ``model``, the products
run through ``sh.einsum`` on each rank's shards, and the attention runs
behind a ``local_map`` seam on each rank's heads (the same kernel on the
card). Two constraints the reference leaves to GSPMD are explicit: the
sequence-sharded residual is gathered (``"residual_gathered"``) before
the column-parallel products, and the attention's output is laid out as
``wo`` is (``"heads"``) before the row-parallel one. The recurrent blocks
(``models/recurrent.py``) split their channels and heads the same way;
``MoE`` splits each expert's hidden over ``model`` and, where the step
keeps the expert weights split over the data-parallel ranks, sends each
token to its experts' rank and back (``sh.expert_exchange``, the
all-to-all that GSPMD makes of the reference's ``moe_tokens`` /
``moe_hidden`` boundary). Its routing and expert products are plain
PyTorch, as the reference's are plain ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed import sharding as sh
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
    """x: (..., S, H, dh); positions: (..., S). Split-half rotation. A
    DTensor ``x`` (whole heads: :func:`whole_heads`) is rotated on each
    rank's heads, its placement kept."""
    if not sh.compute_mesh() or not hasattr(x, "placements"):
        return _rope(x, positions, theta)
    return sh.local_seam(_rope, tuple(x.placements), [tuple(x.placements), None, None])(
        x, positions, theta)


def whole_heads(x, n_heads: int):
    """A (B, S, H, dh) DTensor with whole heads: split over heads where a
    rule shards ``d_head`` (the decode rules) and the heads divide the
    axis, else replicated; anything else as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not hasattr(x, "placements") or not any(p.is_shard(3) for p in x.placements):
        return x
    sizes = tuple(x.device_mesh.shape)
    target = tuple((Shard(2) if n_heads % n == 0 else Replicate()) if p.is_shard(3) else p
                   for p, n in zip(x.placements, sizes))
    return x.redistribute(x.device_mesh, target)


def _rope(x, positions, theta: float):
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
        # The sequence-sharded residual gathered for the column-parallel
        # products; q and k with whole heads for the norm and RoPE.
        x = sh.constrain(x, "residual_gathered")
        q = sh.constrain(sh.einsum("bsd,dhk->bshk", x, p["wq"]), "heads")
        k = sh.constrain(sh.einsum("bsd,dhk->bshk", x, p["wk"]), "kv_heads")
        v = sh.constrain(sh.einsum("bsd,dhk->bshk", x, p["wv"]), "kv_heads")
        q, k = whole_heads(q, self.n_heads), whole_heads(k, self.n_kv_heads)
        if self.qk_norm:
            q = rms_norm(q, p["q_norm"], self.norm_eps)
            k = rms_norm(k, p["k_norm"], self.norm_eps)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def forward(self, p, x, positions):
        """x: (B, S, D) → (B, S, D); full sequence (prefill / evaluation)."""
        q, k, v = self._qkv(p, x, positions)
        o = self._attend(q, k, v)
        o = sh.constrain(o, "heads")
        out = sh.einsum("bshk,hkd->bsd", o, p["wo"])
        return sh.constrain(out, "residual")

    def _attend(self, q, k, v):
        """:func:`chunked_attention` (the kernel on the card). On DTensors,
        the seam: each rank attends with its own heads. Q is split over
        heads where they divide the axis; K and V are split with it where
        the KV heads divide too, else they are whole on every rank, which
        then takes the KV heads of its own query heads (one KV head when
        its query heads share one, else one a query head), so that the
        kernel's group map (local query head j on KV head j // G) holds."""
        kw = dict(causal=self.causal, window=self.window, chunk=self.chunk)
        if not hasattr(q, "placements"):
            return chunked_attention(q, k, v, **kw)
        from torch.distributed.tensor import Partial, Replicate, Shard

        m = sh.compute_mesh().size()
        h, kv = self.n_heads, self.n_kv_heads
        g = h // kv
        q_split = h % m == 0
        kv_split = q_split and kv % m == 0
        hq = h // m if q_split else h
        first = sh.model_rank() * hq if q_split else 0
        if kv_split or not q_split:
            pick = None
        elif g % hq == 0:
            pick = slice(first // g, first // g + 1)
        else:
            pick = [(first + j) // g for j in range(hq)]

        def local(q, k, v):
            if pick is not None:
                k, v = k[:, :, pick], v[:, :, pick]
            return chunked_attention(q, k, v, **kw)

        qp = (Shard(2),) if q_split else (Replicate(),)
        kvp = (Shard(2),) if kv_split else (Replicate(),)
        kvg = (Partial(),) if pick is not None else kvp
        return sh.local_seam(local, qp, [qp, kvp, kvp], [qp, kvg, kvg])(q, k, v)

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
        On DTensors the cache stays as the rules place it
        (``sh.cache_logical``: KV heads, sequence or ``d_head`` over
        ``model``); each rank writes the row into its own shard and
        attends with the query laid out as the cache is: the scores over
        a ``d_head`` split are partial sums, reduced; over a sequence
        split they are gathered for the softmax, and the weighted values
        are partial sums.
        """
        pos = int(pos)
        positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
        q, k, v = self._qkv(p, x, positions)
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[2]
        slot = (pos % length) if self.window else pos
        _write_row(ck, k[:, 0], slot)                       # (B, KV, dh)
        _write_row(cv, v[:, 0], slot)
        kv, g = self.n_kv_heads, self.n_heads // self.n_kv_heads
        b = q.shape[0]
        q = _like_cache(q, ck)
        qg = q.reshape(b, 1, kv, g, self.d_head)[:, 0]      # (B, KV, G, dh)
        scale = 1.0 / (self.d_head ** 0.5)
        s = sh.unsplit(sh.einsum("bkgd,bksd->bkgs", qg, ck), 3).to(torch.float32) * scale
        k_idx = torch.arange(length, device=x.device)
        if self.window:
            # Ring buffer: entry j holds absolute position
            # a_j = pos - ((slot - j) mod L); valid iff a_j >= 0.
            valid = (pos - torch.remainder(slot - k_idx, length)) >= 0
        else:
            valid = k_idx <= pos
        s = torch.where(sh.replicated(valid), s, -1e30)
        w = torch.softmax(s, dim=-1).to(cv.dtype)
        o = sh.unsplit(sh.einsum("bkgs,bksd->bkgd", w, cv))
        o = sh.constrain(o.reshape(b, 1, self.n_heads, self.d_head), "heads")
        out = sh.einsum("bshk,hkd->bsd", o, p["wo"])
        return sh.constrain(out, "residual"), cache


def _write_row(cache, row, slot: int) -> None:
    """``cache[:, :, slot] = row`` (cache (B, KV, L, dh), row (B, KV, dh)),
    in place. On a DTensor cache each rank writes its own shard's part of
    the row, laid out as the shard is; over a sequence split only the rank
    holding ``slot`` writes. No rank gathers the cache."""
    if not hasattr(cache, "placements"):
        cache[:, :, slot] = row
        return
    from torch.distributed.tensor import Replicate, Shard

    local = cache.to_local()
    mesh = cache.device_mesh
    target, at = [], slot
    for axis, place in enumerate(cache.placements):
        if place.is_shard(2):
            n = local.shape[2]
            if mesh.get_local_rank(axis) != at // n:
                return
            at %= n
            target.append(Replicate())
        else:
            target.append(Shard(place.dim - (place.dim > 2)) if place.is_shard() else Replicate())
    local[:, :, at] = sh.replicated(row).redistribute(mesh, target).to_local()


def _like_cache(q, cache):
    """The (B, 1, H, dh) query of a decode step laid out as ``cache``
    (B, KV, L, dh) is over the compute mesh: its heads split with the
    cache's KV heads, its ``d_head`` with the cache's, else whole."""
    if not hasattr(q, "placements"):
        return q
    from torch.distributed.tensor import Replicate, Shard

    target = tuple(Shard(2) if p.is_shard(1) else Shard(3) if p.is_shard(3) else Replicate()
                   for p in cache.placements)
    return q if tuple(q.placements) == target else q.redistribute(q.device_mesh, target)


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
        x = sh.constrain(x, "residual_gathered")
        h = (F.silu(sh.einsum("bsd,df->bsf", x, p["wg"], local=torch.matmul))
             * sh.einsum("bsd,df->bsf", x, p["wu"], local=torch.matmul))
        h = sh.constrain(h, "ffn")
        return sh.constrain(sh.einsum("bsf,fd->bsd", h, p["wd"], local=torch.matmul), "residual")


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
        x = sh.constrain(x, "residual_gathered")
        h = F.gelu(sh.constrain(sh.einsum("bsd,df->bsf", x, p["w1"], local=torch.matmul), "ffn"),
                   approximate="tanh")
        return sh.constrain(sh.einsum("bsf,fd->bsd", h, p["w2"], local=torch.matmul), "residual")


@dataclasses.dataclass(frozen=True)
class MoE:
    """Top-k routed experts with capacity-based dispatch (GShard-style, per
    batch row), optionally beside a dense SwiGLU residual (arctic).

    At the reference's four constraints inside a tensor-parallel step:
    the dispatch (B, E, C, D) on ``"moe_tokens"`` (the batch over the data
    axes), exchanged (``sh.expert_exchange``) to (B·d, E/d, C, D), this
    rank's experts' slots from every data-parallel rank's rows, where the
    step keeps the expert weights split over d data-parallel ranks; the
    hidden (·, ·, C, F) on ``"moe_hidden"``, its columns over ``model``;
    the down-projection's partial sums reduced on ``"moe_tokens"`` and
    exchanged back; the output on ``"residual"``."""

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
        cap = self.capacity(x.shape[1])
        return (*self._route(x, p["router"], cap), cap)

    def _route(self, x, router, cap: int):
        b, s, _ = x.shape
        e, k = self.n_experts, self.top_k
        gates = torch.softmax(x.to(torch.float32) @ router, dim=-1)        # (B, S, E)
        top_g, top_e = torch.topk(gates, k, dim=-1)                        # (B, S, k)
        top_g = top_g / torch.clamp_min(top_g.sum(dim=-1, keepdim=True), 1e-9)
        flat_e = top_e.reshape(b, s * k)
        onehot = F.one_hot(flat_e, e)                                       # (B, S·k, E)
        pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=-1)     # (B, S·k)
        dest = torch.where(pos < cap, flat_e * cap + pos, e * cap)
        return top_g.reshape(b, s * k), dest

    def _dispatch(self, x, router, cap: int):
        """(gates, dest, xe): the routing, and x's rows scattered to their
        slots, (B, E, C, D) (the overflow row cut off)."""
        b, s, d = x.shape
        e, k = self.n_experts, self.top_k
        gates, dest = self._route(x, router, cap)
        tok = torch.arange(s * k, device=x.device) // k
        idx = dest[..., None].expand(b, s * k, d)
        xe = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
        xe = xe.scatter_add(1, idx, x[:, tok])
        return gates, dest, xe[:, :e * cap].reshape(b, e, cap, d)

    def _combine(self, ye, gates, dest):
        """(B, S, D): each token's experts' outputs gathered from their
        slots (a dropped pair reads the zero overflow row), weighted by
        their gates and summed over the k choices."""
        b, e, cap, d = ye.shape
        k = self.top_k
        idx = dest[..., None].expand(b, dest.shape[1], d)
        ye_flat = torch.cat([ye.reshape(b, e * cap, d),
                             torch.zeros((b, 1, d), dtype=ye.dtype, device=ye.device)], dim=1)
        y = torch.gather(ye_flat, 1, idx) * gates[..., None].to(ye.dtype)
        return y.reshape(b, dest.shape[1] // k, k, d).sum(dim=2)

    def forward(self, p, x):
        """x (B, S, D) → (B, S, D). Tokens past an expert's capacity in their
        row are dropped (their slot is the overflow row, which is never
        computed). Expert products are einsums over (B, E, C, D).

        On DTensors (a tensor-parallel step) the residual is gathered
        whole over ``model`` first (routing takes a cumsum over each whole
        row), and the routing with the scatter, and the gather with the
        gate weighting, each run behind one seam on every rank's replicated
        local tensors; the router is whole on every rank of a ``model``
        group, so all of them route alike. Between the seams, the expert
        products split each expert's hidden columns over ``model``."""
        from torch.distributed.tensor import Replicate

        x = sh.constrain(x, "residual_gathered")
        whole = (Replicate(),)
        cap = self.capacity(x.shape[1])
        dispatch = sh.local_seam(lambda x, r: self._dispatch(x, r, cap), [whole] * 3,
                                 [whole, whole])
        gates, dest, xe = dispatch(x, p["router"])
        xe = sh.expert_exchange(sh.constrain(xe, "moe_tokens"), 1, 0)
        h = F.silu(sh.einsum("becd,edf->becf", xe, p["wg"]))
        h = h * sh.einsum("becd,edf->becf", xe, p["wu"])
        h = sh.constrain(h, "moe_hidden")
        ye = sh.constrain(sh.einsum("becf,efd->becd", h, p["wd"]), "moe_tokens")
        ye = sh.expert_exchange(ye, 0, 1)
        y = sh.local_seam(self._combine, whole, [whole] * 3)(ye, gates, dest)
        if self.dense_residual:
            y = sh.constrain(y, "residual") + SwiGLU(self.d_ff).forward(p["dense"], x)
        return sh.constrain(y, "residual")
