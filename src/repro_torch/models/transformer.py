"""The composable model stack: init, sequence forward, loss, decode.

The port of the reference's ``repro/models/transformer.py``. Layers are
organised as repeated *periods* (``cfg.period``) whose parameters are
stacked over a leading period axis, exactly as in the reference's tree:

    {"embed", "periods": {"slotI": {"norm1", "seq", "norm2", "mix"}},
     "final_norm", "lm_head", "tail": [layer, ...]}

so a parameter tree of either package saves to the same checkpoint names
(``CheckpointManager``) and :func:`params_from_reference` carries the
reference's parameters across leaf by leaf (:func:`opt_from_reference` its
AdamW state). Where the reference scans over periods, the port loops over
them in Python; where it wraps a period in ``jax.checkpoint``
(``cfg.remat``), the port wraps it in ``torch.utils.checkpoint``.

Block = sequence mix (attn / local_attn / rglru / rwkv6) + channel mix
(swiglu / gelu / moe / moe_dense / rwkv_cm), each pre-RMSNormed with a
residual add. The recurrent blocks carry their decode state in the cache
beside the attention layers' K/V (``h`` and ``conv``; ``wkv`` and
``shift_tm``; the channel mix's ``shift_cm``), stacked over periods in
the same way; ``decode_step`` updates every layer's cache in place.

The reference's sharding constraints stand where it puts them
(``sh.constrain``: the pre-norm outputs and the residual on
``"residual"``, the tokens, the embedding and the logits); they do nothing
outside a tensor-parallel step (``launch.shardings.sharded``'s ``"tp"``
route). Inside one the embedding table and the LM head are split over the
vocabulary: each rank looks up its own rows (a partial sum, reduced into
the residual's layout) and computes its own logits, and ``loss_fn``'s
cross entropy reduces the row max, the sum of exponentials and the gold
logit over the vocabulary shards without gathering the (B, S, V)
logits. Every block, attention, RG-LRU, RWKV-6 or channel mix, takes the
residual as the step placed it and gives back its output on
``"residual"`` (the routed experts exchange their tokens over the
data-parallel ranks in between, a decode step's one token a row too);
the decode cache's recurrent states stay split as the rules place them,
each rank writing its own shard. Under remat the recompute runs every
seam and exchange again under the step's sharding state.
"""

from __future__ import annotations

from typing import Any

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as sh
from ..kernels.ops import resolve_device
from .config import ModelConfig
from .layers import AttentionBlock, GeluMLP, MoE, SwiGLU, _normal, rms_norm
from .recurrent import RGLRUBlock, RWKV6ChannelMix, RWKV6TimeMix

Params = dict[str, Any]

__all__ = ["cache_specs", "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "opt_from_reference", "param_specs", "params_from_reference"]

# Where the shape stand-ins live: tensors with a shape and a dtype and no
# storage.
_META = torch.device("meta")


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ------------------------------------------------------------- block builders
def _seq_block(cfg: ModelConfig, kind: str):
    if kind in ("attn", "local_attn"):
        return AttentionBlock(
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head,
            rope_theta=cfg.rope_theta,
            causal=cfg.causal,
            window=cfg.window if kind == "local_attn" else 0,
            qk_norm=cfg.qk_norm,
            chunk=cfg.attn_chunk,
            norm_eps=cfg.norm_eps,
        )
    if kind == "rglru":
        return RGLRUBlock(d_rnn=cfg.d_rnn)
    if kind == "rwkv6":
        return RWKV6TimeMix(n_heads=cfg.d_model // cfg.rwkv_head_dim, d_head=cfg.rwkv_head_dim)
    raise ValueError(kind)


def _mix_block(cfg: ModelConfig, kind: str):
    if kind == "swiglu":
        return SwiGLU(cfg.d_ff)
    if kind == "gelu":
        return GeluMLP(cfg.d_ff)
    if kind in ("moe", "moe_dense"):
        return MoE(cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.capacity_factor,
                   dense_residual=(kind == "moe_dense"))
    if kind == "rwkv_cm":
        return RWKV6ChannelMix(cfg.d_ff)
    raise ValueError(kind)


def _blocks(cfg: ModelConfig, kinds, mixes):
    return [(_seq_block(cfg, b), _mix_block(cfg, m)) for b, m in zip(kinds, mixes)]


def _blocks_for_period(cfg: ModelConfig):
    return _blocks(cfg, cfg.period, cfg.mix)


def _blocks_for_tail(cfg: ModelConfig):
    return _blocks(cfg, cfg.tail, cfg.tail_mix)


def _index(tree, i: int):
    """Period ``i`` of a tree stacked over periods (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ----------------------------------------------------------------------- init
def _init_layer(gen, cfg, seq_blk, mix_blk, dtype, device, lead=()):
    ones = torch.ones(tuple(lead) + (cfg.d_model,), dtype=dtype, device=device)
    return {
        "norm1": ones,
        "seq": seq_blk.init(gen, cfg.d_model, dtype, device, lead),
        "norm2": ones.clone(),
        "mix": mix_blk.init(gen, cfg.d_model, dtype, device, lead),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``).

    Same tree, shapes, dtypes and scales as the reference's
    ``init_params``; the numbers differ (``jax.random`` is not torch's).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _build_params(cfg, gen, dev)


def _build_params(cfg: ModelConfig, gen, dev: torch.device) -> Params:
    dtype = _dtype(cfg.param_dtype)
    period_blocks = _blocks_for_period(cfg)
    tail_blocks = _blocks_for_tail(cfg)
    d = cfg.d_model
    params: Params = {
        "embed": _normal(gen, (cfg.vocab_size, d), d ** -0.5, dtype, dev),
        "periods": {f"slot{i}": _init_layer(gen, cfg, sb, mb, dtype, dev, (cfg.n_periods,))
                    for i, (sb, mb) in enumerate(period_blocks)},
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if tail_blocks:
        params["tail"] = [_init_layer(gen, cfg, sb, mb, dtype, dev)
                          for sb, mb in tail_blocks]
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, cfg.vocab_size), d ** -0.5, dtype, dev)
    return params


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree's stand-ins: :func:`init_params`'s leaves, shapes
    and dtypes as tensors on the ``meta`` device (nothing is allocated, so
    the largest config costs nothing). The reference's ``param_specs``
    gives the same as ``jax.ShapeDtypeStruct``s."""
    return _build_params(cfg, None, _META)


def params_from_reference(tree, device="cuda"):
    """The reference's parameter tree (numpy arrays, e.g. ``jax.device_get``
    of ``repro.models.init_params``) as the port's tree on ``device``.

    Dicts and lists keep their keys and order; each array becomes a tensor
    of the same dtype. bfloat16 arrays (numpy's ``bfloat16`` extension
    type) are carried across as their 16-bit patterns. Arrays are copied
    (the reference's are read-only).
    """
    dev = resolve_device(device)

    def leaf(arr):
        arr = np.array(arr)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return walk(tree)


def opt_from_reference(state, device="cuda"):
    """The reference's AdamW state (``repro.optim.adamw_init`` /
    ``adamw_update``: float32 ``m`` and ``v`` trees and an int32 scalar
    ``step``, as numpy arrays) as the port's on ``device``, for
    ``optim.adamw_update``."""
    return {"m": params_from_reference(state["m"], device),
            "v": params_from_reference(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=resolve_device(device))}


# --------------------------------------------------------- forward (sequence)
def _apply_layer(cfg, seq_blk, mix_blk, p, x, positions):
    """Pre-LN residual block. The recurrent blocks' and the RWKV channel
    mix's final states are dropped: a forward starts every layer from zero
    state, as the reference's does."""
    h = sh.constrain(rms_norm(x, p["norm1"], cfg.norm_eps), "residual")
    if isinstance(seq_blk, AttentionBlock):
        a = seq_blk.forward(p["seq"], h, positions)
    else:
        a, _ = seq_blk.forward(p["seq"], h)
    x = x + a
    h = sh.constrain(rms_norm(x, p["norm2"], cfg.norm_eps), "residual")
    if isinstance(mix_blk, RWKV6ChannelMix):
        m, _ = mix_blk.forward(p["mix"], h)
    else:
        m = mix_blk.forward(p["mix"], h)
    return sh.constrain(x + m, "residual")


def _lookup(table, tokens):
    """``table[tokens]``. Over a vocabulary-split table (a DTensor in a
    tensor-parallel step) each rank looks up the tokens in its rows and
    gives zeros for the rest: a partial sum with one term a token, which
    the caller's constraint reduces (DTensor's masked embedding)."""
    if not hasattr(table, "placements"):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    place = table.placements[0]
    if not place.is_shard(0):
        out = Shard(place.dim + tokens.ndim - 1) if place.is_shard() else Replicate()
        return sh.local_seam(lambda t, i: t[i], (out,), [tuple(table.placements),
                                                          "tokens"])(table, tokens)
    rows = table.shape[0] // sh.compute_mesh().size()
    first = sh.model_rank() * rows

    def local(t, ids):
        ids = ids - first
        inside = (ids >= 0) & (ids < rows)
        got = t[torch.where(inside, ids, 0)]
        return torch.where(inside[..., None], got, got.new_zeros(()))

    return sh.local_seam(local, (Partial(),), [(Shard(0),), "tokens"])(table, tokens)


def _embed_in(cfg: ModelConfig, params, batch):
    # Stub frontends (audio / vlm) feed precomputed embeddings; VLM decode
    # still feeds text tokens — dispatch on the batch key.
    if "embeds" in batch:
        return sh.constrain(batch["embeds"].to(_dtype(cfg.compute_dtype)), "embeds_in")
    tokens = sh.constrain(batch["tokens"], "tokens")
    x = _lookup(params["embed"], tokens)
    return sh.constrain(x.to(_dtype(cfg.compute_dtype)), "residual")


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(cfg, params, x):
    """The LM head on the final norm's output: the residual gathered over
    its sequence split, the logits split over the vocabulary."""
    x = sh.constrain(rms_norm(x, params["final_norm"], cfg.norm_eps), "residual_gathered")
    return sh.constrain(sh.einsum("bsd,dv->bsv", x, _head(cfg, params)), "logits")


def forward(params: Params, batch: dict, cfg: ModelConfig):
    """Full-sequence forward → logits (B, S, V).

    With ``cfg.remat`` and grad enabled, each period runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, so the backward runs each period's forward,
    attention launches included, a second time.
    """
    x = _embed_in(cfg, params, batch)
    b, s, _ = x.shape
    # Local on every rank (the RoPE seam takes them as they are).
    positions = torch.arange(s, device=x.device).expand(b, s)
    period_blocks = _blocks_for_period(cfg)

    def period_fn(x, p_period):
        for j, (sb, mb) in enumerate(period_blocks):
            x = _apply_layer(cfg, sb, mb, p_period[f"slot{j}"], x, positions)
        return x

    remat = cfg.remat and torch.is_grad_enabled()
    # The recompute may run on the autograd engine's thread (on the card):
    # it runs under the step's sharding state.
    state = sh.snapshot()
    in_step = lambda: (contextlib.nullcontext(), sh.resume(state))  # noqa: E731
    for i in range(cfg.n_periods):
        p_period = _index(params["periods"], i)
        if remat:
            x = checkpoint(period_fn, x, p_period, use_reentrant=False, context_fn=in_step)
        else:
            x = period_fn(x, p_period)
    for i, (sb, mb) in enumerate(_blocks_for_tail(cfg)):
        x = _apply_layer(cfg, sb, mb, params["tail"][i], x, positions)
    return _logits(cfg, params, x)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig):
    """Mean next-token cross entropy (labels already shifted). Returns
    (loss, metrics); differentiable, as the reference's (the row max is
    held out of the gradient, as its ``stop_gradient``)."""
    logits = forward(params, batch, cfg).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    mask = batch.get("mask")
    nll = _nll(logits, labels)
    if mask is None:
        loss = nll.mean()
        denom = nll.numel()
    else:
        mask = sh.replicated(mask.to(torch.float32))
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        denom = mask.sum()
    return loss, {"loss": loss, "tokens": denom}


def _nll(logits, labels):
    """``logsumexp(logits) - logits[label]`` a position (the row max held
    out of the gradient). Over vocabulary-split logits (a DTensor) each
    rank reduces its own columns and the three reductions cross the ranks
    as tensors of (B, S): the row max (an all-reduce of the maxima), the
    sum of exponentials and the gold logit (all-reduces of partial sums,
    the gold logit being zero on every rank but its column's)."""
    if not hasattr(logits, "placements"):
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        return lse - logits.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate

    last = logits.ndim - 1
    if not any(p.is_shard(last) for p in logits.placements):
        logits = sh.unsplit(logits, *range(logits.ndim))
        return sh.local_seam(_nll, (Replicate(),), [(Replicate(),), (Replicate(),)])(
            logits, labels)
    logits = sh.unsplit(logits, *range(last))
    cols = logits.shape[-1] // sh.compute_mesh().size()
    first = sh.model_rank() * cols

    def row_max(z):
        return z.amax(dim=-1, keepdim=True)

    def gold(z, ids):
        ids = ids - first
        inside = (ids >= 0) & (ids < cols)
        got = z.gather(-1, torch.where(inside, ids, 0)[..., None])[..., 0]
        return torch.where(inside, got, got.new_zeros(()))

    m = sh.unsplit(sh.local_seam(row_max, (Partial("max"),), ["logits"])(logits.detach()))
    sums = sh.local_seam(lambda z: z.sum(dim=-1), (Partial(),), ["logits"])(torch.exp(logits - m))
    lse = torch.log(sh.unsplit(sums)) + m[..., 0]
    return lse - sh.unsplit(sh.local_seam(gold, (Partial(),), ["logits", "tokens"])(
        logits, labels))


# -------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode cache tree, stacked over periods like the params: a layer's
    K/V or recurrent state, plus the RWKV channel mix's token shift."""
    return _build_cache(cfg, batch, max_len, resolve_device(device))


def _build_cache(cfg: ModelConfig, batch: int, max_len: int, dev: torch.device):
    dtype = _dtype(cfg.compute_dtype)

    def one_layer(sb, mb, lead=()):
        if isinstance(sb, AttentionBlock):
            c = sb.init_cache(batch, max_len, dtype, dev, lead)
        elif isinstance(sb, RGLRUBlock):
            c = sb.init_state(batch, dtype, dev, lead)
        else:
            c = sb.init_state(batch, cfg.d_model, dtype, dev, lead)
        if isinstance(mb, RWKV6ChannelMix):
            c.update(mb.init_state(batch, cfg.d_model, dtype, dev, lead))
        return c

    cache = {"periods": {f"slot{i}": one_layer(sb, mb, (cfg.n_periods,))
                         for i, (sb, mb) in enumerate(_blocks_for_period(cfg))}}
    tail_blocks = _blocks_for_tail(cfg)
    if tail_blocks:
        cache["tail"] = [one_layer(sb, mb) for sb, mb in tail_blocks]
    return cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """:func:`init_cache`'s tree as tensors on the ``meta`` device."""
    return _build_cache(cfg, batch, max_len, _META)


def _decode_layer(cfg, seq_blk, mix_blk, p, x, cache, pos):
    """One token through a layer; its entries of ``cache`` are updated in
    place: ``shift_cm`` by the RWKV channel mix, the rest by the sequence
    block. A mix without state (MLPs, MoE) runs its forward on the token."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if isinstance(seq_blk, AttentionBlock):
        a, _ = seq_blk.decode(p["seq"], h, cache, pos)
    else:
        a, _ = seq_blk.decode(p["seq"], h, {k: v for k, v in cache.items() if k != "shift_cm"})
    x = x + a
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if isinstance(mix_blk, RWKV6ChannelMix):
        m, _ = mix_blk.decode(p["mix"], h, {"shift_cm": cache["shift_cm"]})
    else:
        m = mix_blk.forward(p["mix"], h)
    return x + m, cache


def decode_step(params: Params, cache, batch: dict, pos, cfg: ModelConfig):
    """One token for the whole batch. batch: {"tokens": (B, 1)} (or embeds).

    ``pos`` is the absolute position (cache fill level). Returns
    (logits (B, 1, V), cache); the cache is updated in place.
    """
    x = _embed_in(cfg, params, batch)
    period_blocks = _blocks_for_period(cfg)
    for i in range(cfg.n_periods):
        p_period = _index(params["periods"], i)
        c_period = _index(cache["periods"], i)
        for j, (sb, mb) in enumerate(period_blocks):
            x, _ = _decode_layer(cfg, sb, mb, p_period[f"slot{j}"], x,
                                 c_period[f"slot{j}"], pos)
    for i, (sb, mb) in enumerate(_blocks_for_tail(cfg)):
        x, _ = _decode_layer(cfg, sb, mb, params["tail"][i], x, cache["tail"][i], pos)
    return _logits(cfg, params, x), cache
