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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.profiler import record_function

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
    return torch.cat([shift[:, None], x[:, :-1]], dim=1)


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

    def _gates(self, p, u):
        """u: (B, S, R) post-conv → (log_a, gated input) in float32."""
        r_g = torch.sigmoid(u @ p["wa"]).to(torch.float32)
        i_g = torch.sigmoid(u @ p["wi"]).to(torch.float32)
        log_a = -self.c * F.softplus(p["lam"]) * r_g                 # (B, S, R) < 0
        beta = torch.sqrt(1.0 - torch.exp(2.0 * log_a) + 1e-9)
        b = beta * (i_g * u.to(torch.float32))
        return log_a, b

    def _conv(self, p, u, carry=None):
        """Causal depthwise conv of width 4. carry: (B, w-1, R) previous inputs."""
        w = self.conv_width
        if carry is None:
            carry = torch.zeros((u.shape[0], w - 1, u.shape[-1]), dtype=u.dtype,
                                device=u.device)
        ext = torch.cat([carry, u], dim=1)
        out = sum(ext[:, i:i + u.shape[1]] * p["conv"][i] for i in range(w))
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

    def forward(self, p, x, state=None):
        """x: (B, S, D) → ((B, S, D), final state for decode)."""
        u = x @ p["wx"]
        g = F.gelu(x @ p["wgate"], approximate="tanh")   # jax.nn.gelu: the tanh form
        h0 = None if state is None else state["h"]
        conv_carry = None if state is None else state["conv"]
        u, conv_out = self._conv(p, u, conv_carry)
        log_a, b = self._gates(p, u)
        if h0 is not None:
            # Fold the incoming state into the first step: b_0 += a_0 * h0.
            b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None], b[:, 1:]], dim=1)
        # As the reference: h is cast to x's dtype before the final state is
        # taken from it (decode keeps h in float32).
        with record_function("rglru_scan"):
            h = self._scan(log_a, b).to(x.dtype)
        out = (g * h) @ p["wo"]
        return out, {"h": h[:, -1].to(torch.float32), "conv": conv_out}

    # -------------------------------------------------------------- decode
    def init_state(self, batch, dtype, device, lead=()):
        lead = tuple(lead)
        return {
            "h": torch.zeros(lead + (batch, self.d_rnn), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, self.conv_width - 1, self.d_rnn), dtype=dtype,
                                device=device),
        }

    def decode(self, p, x, state):
        """x: (B, 1, D), one step; ``state`` updated in place and returned."""
        u = x @ p["wx"]
        g = F.gelu(x @ p["wgate"], approximate="tanh")
        u, conv_carry = self._conv(p, u, state["conv"])
        log_a, b = self._gates(p, u)
        h = torch.exp(log_a[:, 0]) * state["h"] + b[:, 0]
        out = (g[:, 0] * h.to(x.dtype)) @ p["wo"]
        state["h"].copy_(h)
        state["conv"].copy_(conv_carry)
        return out[:, None], state


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
        """Token-shift lerp + projections. x, x_prev: (B, S, D)."""
        mu = p["mu"]

        def mix(i):
            return x * mu[i] + x_prev * (1 - mu[i])

        b, s, _ = x.shape
        h, dh = self.n_heads, self.d_head
        r = (mix(0) @ p["wr"]).reshape(b, s, h, dh)
        k = (mix(1) @ p["wk"]).reshape(b, s, h, dh)
        v = (mix(2) @ p["wv"]).reshape(b, s, h, dh)
        lora = torch.tanh(mix(3) @ p["w_lora_a"]) @ p["w_lora_b"]
        logw = -torch.exp(p["lam"] + lora.to(torch.float32))
        logw = torch.clamp(logw, -LOGW_CLAMP, -1e-6).reshape(b, s, h, dh)
        g = F.silu(mix(4) @ p["wg"])
        return r, k, v, logw, g

    def _norm_out(self, p, y, g, b, s):
        d = self.n_heads * self.d_head
        y = y.reshape(b, s, self.n_heads, self.d_head)
        # Per-head group norm; the population variance (jnp.var, ddof 0).
        mean = y.mean(dim=-1, keepdim=True)
        var = y.var(dim=-1, keepdim=True, correction=0)
        y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
        y = y * p["ln_w"]
        return (y.to(g.dtype) * g) @ p["wo"]

    def forward(self, p, x, state=None):
        """x: (B, S, D), S a multiple of min(RWKV_CHUNK, S). Returns (out, state)."""
        b, s, d = x.shape
        h, dh = self.n_heads, self.d_head
        L = min(RWKV_CHUNK, s)
        if s % L:
            raise ValueError(f"sequence length {s} is not a multiple of the chunk {L}")
        shift = (state["shift_tm"] if state is not None
                 else torch.zeros((b, d), dtype=x.dtype, device=x.device))
        r, k, v, logw, g = self._proj(p, x, _shifted(x, shift))
        n_chunks = s // L

        def resh(t):  # (C, B, H, L, dh), chunk-major
            return t.reshape(b, n_chunks, L, h, dh).permute(1, 0, 3, 2, 4)

        rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(logw)
        S = (state["wkv"] if state is not None
             else torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device))
        u = p["u"]                                            # (H, dh)
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device), diagonal=-1)
        eye = torch.eye(L, dtype=torch.float32, device=x.device)
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
        y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h * dh)
        out = self._norm_out(p, y, g, b, s)
        return out, {"wkv": S, "shift_tm": x[:, -1]}

    # -------------------------------------------------------------- decode
    def init_state(self, batch, d_model, dtype, device, lead=()):
        lead = tuple(lead)
        h, dh = self.n_heads, self.d_head
        return {
            "wkv": torch.zeros(lead + (batch, h, dh, dh), dtype=torch.float32, device=device),
            "shift_tm": torch.zeros(lead + (batch, d_model), dtype=dtype, device=device),
        }

    def decode(self, p, x, state):
        """x: (B, 1, D), one step; ``state`` updated in place and returned."""
        b, _, d = x.shape
        h, dh = self.n_heads, self.d_head
        r, k, v, logw, g = self._proj(p, x, state["shift_tm"][:, None])
        rf = r[:, 0].to(torch.float32)                        # (B, H, dh)
        kf = k[:, 0].to(torch.float32)
        vf = v[:, 0].to(torch.float32)
        w = torch.exp(logw[:, 0])
        S = state["wkv"]
        u = p["u"]
        # y = r · (S + diag(u) k v^T); S' = diag(w) S + k v^T
        y = torch.einsum("bhd,bhde->bhe", rf, S)
        y = y + torch.einsum("bhd,bhd,bhe->bhe", rf, u[None] * kf, vf)
        S_new = w[..., None] * S + torch.einsum("bhd,bhe->bhde", kf, vf)
        out = self._norm_out(p, y.reshape(b, 1, h * dh), g, b, 1)
        state["wkv"].copy_(S_new)
        state["shift_tm"].copy_(x[:, 0])
        return out, state


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
        b, _, d = x.shape
        shift = (state["shift_cm"] if state is not None
                 else torch.zeros((b, d), dtype=x.dtype, device=x.device))
        x_prev = _shifted(x, shift)
        mu = p["mu"]
        xk = x * mu[0] + x_prev * (1 - mu[0])
        xr = x * mu[1] + x_prev * (1 - mu[1])
        k = torch.square(torch.relu(xk @ p["wk"]))
        out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
        return out, {"shift_cm": x[:, -1]}

    def init_state(self, batch, d_model, dtype, device, lead=()):
        return {"shift_cm": torch.zeros(tuple(lead) + (batch, d_model), dtype=dtype,
                                        device=device)}

    def decode(self, p, x, state):
        """x: (B, 1, D); ``state`` updated in place and returned."""
        out, new_state = self.forward(p, x, state)
        state["shift_cm"].copy_(new_state["shift_cm"])
        return out, state
