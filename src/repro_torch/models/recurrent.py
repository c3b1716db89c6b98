"""Recurrent sequence-mix blocks: RG-LRU (Griffin / recurrentgemma) and RWKV-6.

The port of the reference's ``repro/models/recurrent.py``. Both blocks are
sub-quadratic and carry an O(1)-in-sequence decode state, kept under the
reference's names (``h``, ``conv``; ``wkv``, ``shift_tm``; ``shift_cm``)
so cache trees line up. Parameters are plain dicts of tensors with the
reference's names, shapes and dtypes (``lam`` and ``u`` float32 in any
tree), made by ``init(gen, d_model, dtype, device, lead=())``.

RG-LRU's linear recurrence h_t = a_t h_{t-1} + b_t runs as a log-depth scan
over the sequence on whole tensors: Hillis–Steele doubling with the
reference's ``associative_scan`` combine, ⌈log2 S⌉ passes (13 at 8,192
tokens), where a loop over positions would launch about 10^5 kernels a
prefill.

RWKV-6 keeps the reference's chunked linear-attention form exactly: the
state S_t = diag(w_t) S_{t-1} + k_t v_t^T advances chunk by chunk, each
chunk's own contribution a masked product, with ``logw`` clamped to
[-LOGW_CLAMP, -1e-6] so every factored exponent stays below
RWKV_CHUNK · LOGW_CLAMP = 80 < log(float32 max). The chunk loop is a
Python loop (64 chunks at 2,048 tokens).

The scan and the chunk loop run inside ``record_function`` ranges
(``rglru_scan``, ``rwkv6_chunks``), so a trace can tell their device time
from the matrix products' (``launch/profile_steps.py`` ``trace_prefill``).

``decode`` writes the new state into the cache's tensors in place and
returns the same dict, as ``AttentionBlock.decode`` does; ``forward``
returns a fresh state. Neither block reaches a kernel: the reference
computes them in plain ``jnp``.

The reference's sharding constraints stand where it puts them
(``"rnn_act"``, ``"rwkv_act"``, ``"ffn"``, ``"residual"``). Inside a
tensor-parallel step (``launch.shardings.sharded``'s ``"tp"`` route)
each rank computes its own RG-LRU channels and its own RWKV-6 heads, as
GSPMD splits the reference's blocks: the products run through
``sh.einsum`` on the rules' weight shards (``wx``, ``wgate``, ``wr``,
``wk``, ``wg`` and ``w_lora_b`` by columns; ``wo`` and the time mix's
``wv`` by rows, giving partial sums that the next constraint reduces),
and the conv, the gates and the scan, or the chunk loop and the per-head
norm, run behind one ``sh.local_seam`` each on plain local tensors, so
that the scan's passes and the chunks cost no DTensor dispatch. The
RG-LRU gates contract over every channel: the seam gathers the conv's
output whole for them (``sh.gather_shards``). ``decode`` keeps the state
as the rules place it (``rnn_state``, ``cache_conv``, ``rwkv_state``
split over ``model``; the token shifts whole) and each rank writes its
own shard in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..distributed import sharding as sh
from .layers import _normal

__all__ = ["LOGW_CLAMP", "RWKV_CHUNK", "RGLRUBlock", "RWKV6ChannelMix", "RWKV6TimeMix"]

RWKV_CHUNK = 32
LOGW_CLAMP = 2.5  # |logw| <= 2.5 → exponents <= 32 * 2.5 = 80 < log(f32max)


def _uniform(gen, shape, dtype, device) -> torch.Tensor:
    """U[0, 1) drawn in float32 from ``gen``, then cast to ``dtype``."""
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device).to(dtype)


def _shifted(x, shift):
    """x_prev: the previous token of each position, ``shift`` (B, D) before
    the first."""
    return torch.cat([sh.replicated(shift)[:, None], x[:, :-1]], dim=1)


def _zeros_like_rows(x, d):
    """The token shift before a sequence's first token: (B, d) zeros of
    ``x``'s dtype, on its device."""
    return torch.zeros((x.shape[0], d), dtype=x.dtype, device=x.device)


def _split(d: int):
    """Placements over the compute mesh (one axis) of a tensor split on
    dim ``d``."""
    from torch.distributed.tensor import Shard

    return (Shard(d),)


def _store(dst, src) -> None:
    """``dst.copy_(src)``, in place. On a DTensor cache each rank writes
    its own shard, ``src`` laid out as ``dst`` first; no rank gathers the
    cache."""
    if not hasattr(dst, "placements"):
        dst.copy_(src)
        return
    src = sh.replicated(src)
    dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())


def _mm(eq: str, x, w):
    """``x @ w`` over the last dim of ``x``; in a tensor-parallel step each
    rank's part of it (``sh.einsum``)."""
    return sh.einsum(eq, x, w, local=torch.matmul)


# ------------------------------------------------------------------- RG-LRU
@dataclasses.dataclass(frozen=True)
class RGLRUBlock:
    """Griffin recurrent block: conv4 → RG-LRU → GeLU-gated output."""

    d_rnn: int
    conv_width: int = 4
    c: float = 8.0

    def init(self, gen, d_model, dtype, device, lead=()):
        """Parameters with ``lead`` stacked axes (the period axis)."""
        lead = tuple(lead)
        r = self.d_rnn
        std, stdr = d_model ** -0.5, r ** -0.5
        lam = torch.linspace(0.5, 4.0, r, dtype=torch.float32, device=device)
        return {
            "wx": _normal(gen, lead + (d_model, r), std, dtype, device),
            "wgate": _normal(gen, lead + (d_model, r), std, dtype, device),
            "conv": _normal(gen, lead + (self.conv_width, r), 0.1, dtype, device),
            "wa": _normal(gen, lead + (r, r), stdr, dtype, device),
            "wi": _normal(gen, lead + (r, r), stdr, dtype, device),
            # Λ init so a^c ≈ 0.9..0.99 decay (Griffin §2.4).
            "lam": lam.expand(lead + (r,)).clone(),
            "wo": _normal(gen, lead + (r, d_model), stdr, dtype, device),
        }

    def _gates(self, wa, wi, lam, u):
        """u: (B, S, R) post-conv → (log_a, gated input) in float32. Behind
        the seam ``u`` and ``lam`` are this rank's channels and ``wa``,
        ``wi`` its columns: the products contract over every channel, so
        they take ``u`` gathered whole."""
        whole = sh.gather_shards(u, -1)
        r_g = torch.sigmoid(whole @ wa).to(torch.float32)
        i_g = torch.sigmoid(whole @ wi).to(torch.float32)
        log_a = -self.c * F.softplus(lam) * r_g                      # (B, S, R) < 0
        beta = torch.sqrt(1.0 - torch.exp(2.0 * log_a) + 1e-9)
        b = beta * (i_g * u.to(torch.float32))
        return log_a, b

    def _conv(self, conv, u, carry=None):
        """Causal depthwise conv of width 4. carry: (B, w-1, R) previous inputs."""
        w = self.conv_width
        if carry is None:
            carry = torch.zeros((u.shape[0], w - 1, u.shape[-1]), dtype=u.dtype,
                                device=u.device)
        ext = torch.cat([carry, u], dim=1)
        out = sum(ext[:, i:i + u.shape[1]] * conv[i] for i in range(w))
        return out, ext[:, -(w - 1):]

    @staticmethod
    def _scan(log_a, b):
        """h_t = exp(log_a_t) h_{t-1} + b_t from h_{-1} = 0, over dim 1: the
        reference's associative-scan combine (la_l + la_r, b_l e^la_r + b_r)
        applied by doubling, each pass folding in the prefix ``d`` back."""
        la, h = log_a, b
        d, s = 1, b.shape[1]
        while d < s:
            h = torch.cat([h[:, :d], h[:, :-d] * torch.exp(la[:, d:]) + h[:, d:]], dim=1)
            la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
            d *= 2
        return h

    def _recur(self, u, conv, wa, wi, lam, h0=None, carry=None):
        """The conv, the gates and the scan on local tensors (behind the
        seam, this rank's channels): u (B, S, R) = x @ wx → (h in u's
        dtype, the conv's carry for decode)."""
        dtype = u.dtype
        u, conv_out = self._conv(conv, u, carry)
        log_a, b = self._gates(wa, wi, lam, u)
        if h0 is not None:
            # Fold the incoming state into the first step: b_0 += a_0 * h0.
            b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None], b[:, 1:]], dim=1)
        # As the reference: h is cast to x's dtype before the final state is
        # taken from it (decode keeps h in float32).
        with record_function("rglru_scan"):
            h = self._scan(log_a, b).to(dtype)
        return h, conv_out

    def forward(self, p, x, state=None):
        """x: (B, S, D) → ((B, S, D), final state for decode)."""
        x = sh.constrain(x, "residual_gathered")                 # the scan needs every position
        u = sh.constrain(_mm("bsd,dr->bsr", x, p["wx"]), "rnn_act")
        g = F.gelu(_mm("bsd,dr->bsr", x, p["wgate"]), approximate="tanh")  # jax.nn.gelu: tanh
        args = [u, p["conv"], p["wa"], p["wi"], p["lam"]]
        ins = ["rnn_act", "p_conv", "p_rnn_sq", "p_rnn_sq", "p_rnn_vec"]
        if state is not None:
            args += [state["h"], state["conv"]]
            ins += ["rnn_state", "cache_conv"]
        h, conv_out = sh.local_seam(self._recur, [_split(2), _split(2)], ins)(*args)
        h = sh.constrain(h, "rnn_act")
        out = sh.constrain(_mm("bsr,rd->bsd", g * h, p["wo"]), "residual")
        return out, {"h": h[:, -1].to(torch.float32), "conv": conv_out}

    # -------------------------------------------------------------- decode
    def init_state(self, batch, dtype, device, lead=()):
        lead = tuple(lead)
        return {
            "h": torch.zeros(lead + (batch, self.d_rnn), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, self.conv_width - 1, self.d_rnn), dtype=dtype,
                                device=device),
        }

    def _step(self, u, conv, wa, wi, lam, h, carry):
        """One decode step on local tensors: (h', the conv's carry')."""
        u, carry = self._conv(conv, u, carry)
        log_a, b = self._gates(wa, wi, lam, u)
        return torch.exp(log_a[:, 0]) * h + b[:, 0], carry

    def decode(self, p, x, state):
        """x: (B, 1, D), one step; ``state`` updated in place and returned."""
        x = sh.constrain(x, "residual_gathered")
        u = _mm("bsd,dr->bsr", x, p["wx"])
        g = F.gelu(_mm("bsd,dr->bsr", x, p["wgate"]), approximate="tanh")
        h, conv_carry = sh.local_seam(
            self._step, [_split(1), _split(2)],
            ["rnn_act", "p_conv", "p_rnn_sq", "p_rnn_sq", "p_rnn_vec", "rnn_state", "cache_conv"])(
            u, p["conv"], p["wa"], p["wi"], p["lam"], state["h"], state["conv"])
        out = _mm("br,rd->bd", g[:, 0] * h.to(x.dtype), p["wo"])
        _store(state["h"], h)
        _store(state["conv"], conv_carry)
        return sh.constrain(out[:, None], "residual"), state


# -------------------------------------------------------------------- RWKV6
@dataclasses.dataclass(frozen=True)
class RWKV6TimeMix:
    """Finch time-mix: data-dependent per-channel decay, chunked training."""

    n_heads: int
    d_head: int
    lora_rank: int = 64

    def init(self, gen, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        d = d_model
        h, dh = self.n_heads, self.d_head
        if h * dh != d:
            raise ValueError(f"{h} heads of {dh} do not make d_model {d}")
        std = d ** -0.5
        return {
            "mu": _uniform(gen, lead + (5, d), dtype, device),  # r, k, v, w, g
            "wr": _normal(gen, lead + (d, d), std, dtype, device),
            "wk": _normal(gen, lead + (d, d), std, dtype, device),
            "wv": _normal(gen, lead + (d, d), std, dtype, device),
            "wg": _normal(gen, lead + (d, d), std, dtype, device),
            "w_lora_a": _normal(gen, lead + (d, self.lora_rank), std, dtype, device),
            "w_lora_b": _normal(gen, lead + (self.lora_rank, d), self.lora_rank ** -0.5,
                                dtype, device),
            "lam": torch.full(lead + (d,), -1.5, dtype=torch.float32, device=device),
            "u": _normal(gen, lead + (h, dh), 0.1, torch.float32, device),
            "ln_w": torch.ones(lead + (d,), dtype=dtype, device=device),
            "wo": _normal(gen, lead + (d, d), std, dtype, device),
        }

    def _proj(self, p, x, x_prev):
        """Token-shift lerp + projections. x, x_prev: (B, S, D) → r, k, v
        (B, S, H, dh) on ``"rwkv_act"`` (a rank's heads), the decay's LoRA
        and the gate (B, S, D) (a rank's channels)."""
        mu = p["mu"]

        def mix(i):
            return x * mu[i] + x_prev * (1 - mu[i])

        b, s, _ = x.shape
        h, dh = self.n_heads, self.d_head
        # wv maps to the rules' row split (p_ffn_out): v is a partial sum
        # until its constraint, as in the reference's GSPMD program.
        r, k, v = (sh.constrain(_mm("bsd,de->bse", mix(i), p[w]).reshape(b, s, h, dh),
                                "rwkv_act") for i, w in enumerate(("wr", "wk", "wv")))
        lora = _mm("bsl,le->bse", torch.tanh(_mm("bsd,dl->bsl", mix(3), p["w_lora_a"])),
                   p["w_lora_b"])
        g = F.silu(_mm("bsd,de->bse", mix(4), p["wg"]))
        return r, k, v, lora, g

    @staticmethod
    def _logw(lam, lora, shape):
        """The per-channel log decay, clamped, as (B, S, H, dh)."""
        logw = -torch.exp(lam + lora.to(torch.float32))
        return torch.clamp(logw, -LOGW_CLAMP, -1e-6).reshape(shape)

    @staticmethod
    def _norm_out(y, g, ln_w):
        """Per-head group norm of y (B, S, H, dh), the population variance
        (jnp.var, ddof 0), scaled by ``ln_w`` and gated by ``g`` (B, S,
        H·dh). Behind the seam: this rank's heads and its part of ``ln_w``."""
        b, s, h, dh = y.shape
        mean = y.mean(dim=-1, keepdim=True)
        var = y.var(dim=-1, keepdim=True, correction=0)
        y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(b, s, h * dh)
        y = y * sh.own_part(ln_w, h * dh)
        return y.to(g.dtype) * g

    def _seam(self, fn, with_state: bool):
        """``fn`` behind ``sh.local_seam``: its inputs r, k, v, the LoRA, the
        gate, lam, u, ln_w (and the state) → (the output, on the rank's
        channels; the state, on its heads). ln_w is whole on every rank,
        which uses its own channels of it: its gradient is a partial sum."""
        from torch.distributed.tensor import Partial

        ins = ["rwkv_act"] * 3 + [_split(2)] * 2 + ["p_rnn_vec", "p_rwkv_u", "p_vec"]
        grads = [None] * 7 + [(Partial(),)]
        if with_state:
            ins, grads = ins + ["rwkv_state"], grads + [None]
        return sh.local_seam(fn, [_split(2), _split(1)], ins, grads)

    def _chunks(self, r, k, v, lora, g, lam, u, ln_w, S=None):
        """The chunk loop and the norm on local tensors (behind the seam,
        this rank's heads): r, k, v (B, S, H, dh) → (the normed, gated
        output (B, S, H·dh), the final state)."""
        b, s, h, dh = r.shape
        logw = self._logw(lam, lora, r.shape)
        L = min(RWKV_CHUNK, s)
        n_chunks = s // L

        def resh(t):  # (C, B, H, L, dh), chunk-major
            return t.reshape(b, n_chunks, L, h, dh).permute(1, 0, 3, 2, 4)

        rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(logw)
        if S is None:
            S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
        eye = torch.eye(L, dtype=torch.float32, device=r.device)
        ys = []
        with record_function("rwkv6_chunks"):
            for c in range(n_chunks):
                wc_ = wc[c]                                   # (B, H, L, dh) float32
                c_inc = torch.cumsum(wc_, dim=2)              # inclusive Σ logw
                c_exc = c_inc - wc_                           # exclusive
                cL = c_inc[:, :, -1:]                         # (B, H, 1, dh)
                rf, kf, vf = (t[c].to(torch.float32) for t in (rc, kc, vc))
                q_t = rf * torch.exp(c_exc)                   # exponents <= 0
                k_t = kf * torch.exp(-c_inc)                  # exponents in [0, L*CLAMP]
                A = torch.einsum("bhid,bhjd->bhij", q_t, k_t)
                A = torch.where(mask, A, 0.0)
                # Diagonal bonus: A_ii = Σ_d r_id · u_d · k_id (RWKV's "u" term).
                diag = (rf * u[None, :, None, :] * kf).sum(dim=-1)  # (B, H, L)
                A = A + diag[..., None] * eye
                y = torch.einsum("bhij,bhjd->bhid", A, vf)
                y = y + torch.einsum("bhid,bhde->bhie", q_t, S)
                k_hat = kf * torch.exp(cL - c_inc)            # exponents <= 0
                S = torch.exp(cL.squeeze(2))[..., None] * S + torch.einsum(
                    "bhjd,bhje->bhde", k_hat, vf)
                ys.append(y)
        y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, dh)
        return self._norm_out(y, g, ln_w), S

    def forward(self, p, x, state=None):
        """x: (B, S, D), S a multiple of min(RWKV_CHUNK, S). Returns (out, state)."""
        b, s, d = x.shape
        L = min(RWKV_CHUNK, s)
        if s % L:
            raise ValueError(f"sequence length {s} is not a multiple of the chunk {L}")
        x = sh.constrain(x, "residual_gathered")                 # the shift crosses positions
        shift = state["shift_tm"] if state is not None else _zeros_like_rows(x, d)
        args = [*self._proj(p, x, _shifted(x, shift)), p["lam"], p["u"], p["ln_w"]]
        if state is not None:
            args.append(state["wkv"])
        y, S = self._seam(self._chunks, state is not None)(*args)
        out = sh.constrain(_mm("bsd,de->bse", y, p["wo"]), "residual")
        return out, {"wkv": S, "shift_tm": x[:, -1]}

    # -------------------------------------------------------------- decode
    def init_state(self, batch, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        h, dh = self.n_heads, self.d_head
        return {
            "wkv": torch.zeros(lead + (batch, h, dh, dh), dtype=torch.float32, device=device),
            "shift_tm": torch.zeros(lead + (batch, d_model), dtype=dtype, device=device),
        }

    def _step(self, r, k, v, lora, g, lam, u, ln_w, S):
        """One decode step on local tensors: (the normed, gated output (B,
        1, H·dh), the new state)."""
        logw = self._logw(lam, lora, r.shape)
        rf = r[:, 0].to(torch.float32)                        # (B, H, dh)
        kf = k[:, 0].to(torch.float32)
        vf = v[:, 0].to(torch.float32)
        w = torch.exp(logw[:, 0])
        # y = r · (S + diag(u) k v^T); S' = diag(w) S + k v^T
        y = torch.einsum("bhd,bhde->bhe", rf, S)
        y = y + torch.einsum("bhd,bhd,bhe->bhe", rf, u[None] * kf, vf)
        S_new = w[..., None] * S + torch.einsum("bhd,bhe->bhde", kf, vf)
        return self._norm_out(y[:, None], g, ln_w), S_new

    def decode(self, p, x, state):
        """x: (B, 1, D), one step; ``state`` updated in place and returned."""
        x = sh.constrain(x, "residual_gathered")
        args = [*self._proj(p, x, state["shift_tm"][:, None]), p["lam"], p["u"], p["ln_w"],
                state["wkv"]]
        y, S_new = self._seam(self._step, True)(*args)
        out = _mm("bsd,de->bse", y, p["wo"])
        _store(state["wkv"], S_new)
        _store(state["shift_tm"], x[:, 0])
        return sh.constrain(out, "residual"), state


@dataclasses.dataclass(frozen=True)
class RWKV6ChannelMix:
    """Finch channel-mix: token-shift + squared-ReLU MLP with receptance."""

    d_ff: int

    def init(self, gen, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        return {
            "mu": _uniform(gen, lead + (2, d_model), dtype, device),  # k, r
            "wk": _normal(gen, lead + (d_model, self.d_ff), d_model ** -0.5, dtype, device),
            "wv": _normal(gen, lead + (self.d_ff, d_model), self.d_ff ** -0.5, dtype, device),
            "wr": _normal(gen, lead + (d_model, d_model), d_model ** -0.5, dtype, device),
        }

    def forward(self, p, x, state=None):
        x = sh.constrain(x, "residual_gathered")
        shift = state["shift_cm"] if state is not None else _zeros_like_rows(x, x.shape[-1])
        x_prev = _shifted(x, shift)
        mu = p["mu"]
        xk = x * mu[0] + x_prev * (1 - mu[0])
        xr = x * mu[1] + x_prev * (1 - mu[1])
        k = torch.square(torch.relu(sh.constrain(_mm("bsd,df->bsf", xk, p["wk"]), "ffn")))
        r = torch.sigmoid(_mm("bsd,de->bse", xr, p["wr"]))
        # k @ wv is a partial sum over the rank's F columns; r is split over
        # D by wr's columns: the sum is reduce-scattered onto r's split.
        out = r * sh.laid_out_as(_mm("bsf,fd->bsd", k, p["wv"]), r)
        return sh.constrain(out, "residual"), {"shift_cm": x[:, -1]}

    def init_state(self, batch, d_model, dtype, device, lead=()):
        return {"shift_cm": torch.zeros(tuple(lead) + (batch, d_model), dtype=dtype,
                                        device=device)}

    def decode(self, p, x, state):
        """x: (B, 1, D); ``state`` updated in place and returned."""
        out, new_state = self.forward(p, x, state)
        _store(state["shift_cm"], new_state["shift_cm"])
        return out, state
