"""Logical-axis sharding context (the rules for the production mesh).

The port of the reference's ``repro/distributed/sharding.py``. Model code
may annotate activations with *logical* names (``constrain(x,
"residual")``); the launcher activates a rule table mapping logical names
to partition specs over the live ``DeviceMesh``. Outside a mesh context the
calls are no-ops, so the same code runs single-device tests and sharded
steps unchanged.

Rule tables encode the reference's parallelism design, copied as data:
DP over (pod, data); TP over model; SP (sequence sharding of the residual
stream) over model; EP (experts) over data; FSDP parameter sharding over
data for the large 2D+ weights.

What differs from the reference:

* ``P`` is a JAX-free stand-in for ``jax.sharding.PartitionSpec``: a tuple
  of entries, one a tensor dim (``None``, a mesh axis name, or a tuple of
  names sharding that dim over several mesh axes, major first).
* :func:`placements` turns a spec into DTensor placements, one a mesh
  dimension (``Shard(d)`` or ``Replicate()``), which is what
  ``distribute_tensor`` and ``redistribute`` take.
* ``constrain`` redistributes a DTensor and returns any other tensor as it
  is: the port's models compute on local tensors
  (``launch.shardings.sharded``), so they carry no ``constrain`` calls, and
  a plain tensor inside a context is left alone.
* ``data_parallel_sum`` / ``data_parallel_size`` are the gradient
  reduction that GSPMD inserts for the reference: inside a sharded step
  they sum over the data-parallel ranks, outside one they are the identity.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["P", "ShardingCtx", "cache_logical", "constrain", "current", "data_parallel",
           "data_parallel_size", "data_parallel_sum", "mesh_axis_sizes", "placements",
           "spec", "use_mesh"]

_state = threading.local()


def _canonical(entry):
    """An entry as ``jax.sharding.PartitionSpec`` compares it: a tuple of
    one axis is that axis, an empty one None."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class P(tuple):
    """A partition spec: one entry a tensor dim. The entries are kept as
    written (the rules tell the batch's ``("data",)`` from a parameter's
    ``"data"`` by them); two specs compare equal as JAX's do, entry by
    entry in canonical form, so ``P(("data",), None) == P("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def canonical(self) -> tuple:
        return tuple(_canonical(e) for e in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self.canonical() == tuple(map(_canonical, other))

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self.canonical())

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _rules_single_pod(seq_shard: bool, serve: bool = False) -> dict:
    dp = ("data",)
    tp = "model"
    sp = tp if seq_shard else None
    # Decode: shard attention on d_head (the reference's choice: replicating
    # heads made GSPMD all-gather the full wq/wk/wv every layer).
    decode = serve and not seq_shard
    hd = tp
    return {
        # Activations.
        "residual": P(dp, sp, None),          # (B, S, D) — SP between blocks
        "residual_gathered": P(dp, None, None),
        "heads": (P(dp, None, None, tp) if decode
                  else P(dp, None, hd, None)),  # (B, S, H, dh)
        "kv_heads": (P(dp, None, None, tp) if decode
                     else P(dp, None, hd, None)),
        "ffn": P(dp, None, tp),               # (B, S, F)
        "logits": P(dp, None, tp),            # (B, S, V)
        "tokens": P(dp, None),
        "embeds_in": P(dp, None, None),
        "rnn_state": P(dp, tp),               # (B, R)
        "rnn_act": P(dp, None, tp),           # (B, S, R)
        "rwkv_state": P(dp, tp, None, None),  # (B, H, dh, dh)
        "rwkv_act": P(dp, None, tp, None),    # (B, S, H, dh)
        # MoE.
        "expert_in": P(dp, None, None),       # (E, C, D) — EP over data
        "expert_h": P(dp, None, tp),          # (E, C, F)
        # Grouped dispatch (B, E, C, D/F).
        "moe_tokens": P(dp, None, None, None),
        "moe_hidden": P(None, "data", None, tp),
        # KV cache (decode), layout (B, KV, S, dh): batch over data; heads
        # over model when they divide the axis, else sequence over model
        # (adaptive — see cache_logical()).
        "cache_bh": (P(dp, None, None, tp) if decode
                     else P(dp, tp, None, None)),   # heads/dh sharded
        "cache_bs": (P(dp, None, None, tp) if decode
                     else P(dp, None, tp, None)),   # seq/dh sharded
        "cache_conv": P(dp, None, tp),        # (B, w-1, R)
        "cache_shift": P(dp, None),           # (B, D)
        # Parameters.
        "p_embed": P(tp, "data"),             # (V, D) vocab over model
        "p_attn_qkv": (P(None, None, tp) if decode
                       else P("data", tp, None)),   # decode: dh-sharded
        "p_attn_o": (P(None, tp, None) if decode
                     else P(tp, None, "data")),
        "p_ffn_in": P("data", tp),            # (D, F)
        "p_ffn_out": P(tp, "data"),           # (F, D)
        "p_router": P("data", None),          # (D, E)
        "p_expert_in": P(dp, None, tp),       # (E, D, F) — EP + TP
        "p_expert_out": P(dp, tp, None),      # (E, F, D)
        "p_rnn_in": P("data", tp),            # (D, R)
        "p_rnn_sq": P("data", tp),            # (R, R)
        "p_rnn_vec": P(tp,),                  # (R,)
        "p_conv": P(None, tp),                # (4, R)
        "p_vec": P(None,),                    # (D,) norms
        "p_head": P("data", tp),              # (D, V)
        "p_rwkv_lora_a": P("data", None),
        "p_rwkv_lora_b": P(None, tp),
        "p_rwkv_u": P(tp, None),              # (H, dh)
        "scalar": P(),
    }


def _rules_dp(n_axes: int = 2) -> dict:
    """Pure-DP + ZeRO-3 profile: batch over the *flattened* mesh,
    parameters fully sharded over the flat mesh on their largest dim and
    gathered for compute. Select with use_mesh(profile="dp")."""
    flat = ("data", "model") if n_axes == 2 else ("pod", "data", "model")
    dp = flat
    return {
        "residual": P(dp, None, None),
        "residual_gathered": P(dp, None, None),
        "heads": P(dp, None, None, None),
        "kv_heads": P(dp, None, None, None),
        "ffn": P(dp, None, None),
        "logits": P(dp, None, None),
        "tokens": P(dp, None),
        "embeds_in": P(dp, None, None),
        "rnn_state": P(dp, None),
        "rnn_act": P(dp, None, None),
        "rwkv_state": P(dp, None, None, None),
        "rwkv_act": P(dp, None, None, None),
        "expert_in": P(None, None, None),
        "expert_h": P(None, None, None),
        "moe_tokens": P(dp, None, None, None),
        "moe_hidden": P(None, dp, None, None),
        "cache_bh": P(dp, None, None, None),
        "cache_bs": P(dp, None, None, None),
        "cache_conv": P(dp, None, None),
        "cache_shift": P(dp, None),
        # ZeRO-3: every big param sharded over the flat mesh, dim 0.
        "p_embed": P(dp, None),
        "p_attn_qkv": P(dp, None, None),
        "p_attn_o": P(None, None, dp),
        "p_ffn_in": P(dp, None),
        "p_ffn_out": P(None, dp),
        "p_router": P(dp, None),
        "p_expert_in": P(None, dp, None),
        "p_expert_out": P(None, None, dp),
        "p_rnn_in": P(dp, None),
        "p_rnn_sq": P(dp, None),
        "p_rnn_vec": P(dp,),
        "p_conv": P(None, dp),
        "p_vec": P(None,),
        "p_head": P(dp, None),
        "p_rwkv_lora_a": P(dp, None),
        "p_rwkv_lora_b": P(None, dp),
        "p_rwkv_u": P(dp, None),
        "scalar": P(),
    }


def _serving_params(rules: dict) -> dict:
    """Serving profile: no optimizer state → dense params fit replicated
    over 'data' (TP-only). Expert weights (EP over data) stay sharded."""
    out = {}
    for k, s in rules.items():
        if k.startswith("p_") and "expert" not in k:
            out[k] = P(*[None if a == "data" else a for a in tuple(s)])
        else:
            out[k] = s
    return out


def _rules_multi_pod(seq_shard: bool, serve: bool = False) -> dict:
    """Pod axis joins data-parallelism: DP over ('pod','data').

    The DP entries are the single-pod table's ``("data",)``, told from a
    parameter's FSDP ``"data"`` by being a tuple. A PartitionSpec of JAX
    0.9 keeps ``("data",)`` as ``"data"``, so there the reference's test
    below never matches and its multi-pod table leaves DP over ``data``
    alone (each pod repeats the other's batch); the port keeps the pod."""
    rules = _rules_single_pod(seq_shard, serve)
    out = {}
    for k, s in rules.items():
        new = []
        for axis in s:
            if axis == ("data",):
                new.append(("pod", "data"))
            elif axis == "data":
                # parameter FSDP axis: shard over data only (pods replicate
                # params; the gradient reduction crosses pods once a step).
                new.append("data")
            else:
                new.append(axis)
        out[k] = P(*new)
    return out


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``), or of a
    stand-in with the reference's ``axis_names`` and ``devices.shape``
    (production shapes checked without their ranks)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(s: P, mesh) -> tuple:
    """DTensor placements of ``s`` over ``mesh``, one a mesh dimension:
    ``Shard(d)`` where tensor dim ``d`` is split over it, else
    ``Replicate()``. A dim split over several axes (``("pod", "data")``)
    is split over them major first, which is DTensor's order too, so the
    axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(s):
        idx = []
        for axis in _axes(entry):
            if axis not in names:
                raise ValueError(f"{s}: the mesh has no axis {axis!r} (axes {names})")
            idx.append(names.index(axis))
        if idx != sorted(idx):
            raise ValueError(f"{s}: the axes of dim {dim} are not in the mesh's order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{s}: axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


class ShardingCtx:
    def __init__(self, mesh, rules: dict, serve: bool = False):
        self.mesh = mesh
        self.rules = rules
        self.serve = serve

    def spec(self, name: str) -> P:
        return self.rules[name]

    def constrain(self, x, name: str):
        """``x`` redistributed to the rule's placements if it is a DTensor;
        any other tensor as it is (the port computes on local tensors)."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(self.rules[name], self.mesh))


def current() -> ShardingCtx | None:
    return getattr(_state, "ctx", None)


def cache_logical(kv_heads: int) -> str:
    """Adaptive KV-cache sharding: heads over 'model' when they divide the
    axis, else sequence over 'model'."""
    ctx = current()
    if ctx is None:
        return "cache_bh"
    model_size = mesh_axis_sizes(ctx.mesh).get("model", 1)
    return "cache_bh" if kv_heads % model_size == 0 else "cache_bs"


def constrain(x, name: str):
    """Annotate x with logical sharding ``name`` (no-op without a context
    and for anything but a DTensor)."""
    ctx = current()
    if ctx is None:
        return x
    return ctx.constrain(x, name)


def spec(name: str) -> P:
    ctx = current()
    if ctx is None:
        return P()
    return ctx.spec(name)


@contextlib.contextmanager
def use_mesh(mesh, multi_pod: bool = False, seq_shard: bool = True,
             serve: bool = False, profile: str = "tp"):
    """The rule table of ``profile`` over ``mesh`` as the current context.
    ``mesh`` is a ``DeviceMesh`` with ``mesh_dim_names``; the reference's
    stand-in (``axis_names``, ``devices.shape``) serves for spec trees."""
    if profile == "dp":
        rules = _rules_dp(n_axes=3 if multi_pod else 2)
    else:
        rules = (_rules_multi_pod(seq_shard, serve) if multi_pod
                 else _rules_single_pod(seq_shard, serve))
        if serve:
            rules = _serving_params(rules)
    ctx = ShardingCtx(mesh, rules)
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


# ------------------------------------------------ data-parallel reduction
@contextlib.contextmanager
def data_parallel(mesh, dims: tuple[int, ...]):
    """Inside the block, :func:`data_parallel_sum` sums over the mesh
    dimensions ``dims`` (the ranks that each computed on their own rows of
    the batch). ``launch.shardings.sharded`` opens it around a step."""
    prev = getattr(_state, "dp", None)
    _state.dp = (mesh, tuple(dims))
    try:
        yield
    finally:
        _state.dp = prev


def data_parallel_size() -> int:
    """The number of data-parallel ranks of the current sharded step; 1
    outside one."""
    dp = getattr(_state, "dp", None)
    if dp is None:
        return 1
    mesh, dims = dp
    n = 1
    for d in dims:
        n *= mesh.size(d)
    return n


def data_parallel_sum(tree):
    """Each tensor leaf of ``tree`` summed over the data-parallel ranks of
    the current sharded step (an all-reduce over its mesh dimensions, run
    even where they have one rank); ``tree`` itself outside one."""
    dp = getattr(_state, "dp", None)
    if dp is None:
        return tree
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..tree import tree_map

    mesh, dims = dp
    partial = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    replicate = [Replicate()] * mesh.ndim

    def reduce(x):
        d = DTensor.from_local(x, mesh, partial, run_check=False)
        return d.redistribute(mesh, replicate).to_local()

    return tree_map(reduce, tree)
