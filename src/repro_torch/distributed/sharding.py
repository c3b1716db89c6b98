"""Logical-axis sharding context (the rules for the production mesh).

The port of the reference's ``repro/distributed/sharding.py``. Model code
annotates activations with *logical* names (``constrain(x,
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
* Tensor-parallel compute: inside a step that ``launch.shardings.sharded``
  runs on the ``"tp"`` route, the activations are DTensors over the
  ``model`` axis alone (:func:`tensor_parallel`; each rank's rows over the
  data-parallel axes are its local batch). There ``constrain``
  redistributes to the rule's ``model`` placement (a dim that does not
  divide over the axis is left whole, as ``fit_spec`` leaves a
  parameter), and takes a plain tensor as the same on every rank of the
  axis. GSPMD partitions every op by its operands' layouts; DTensor's own
  propagation may gather a weight to do so, so the model's products go
  through :func:`einsum`, which computes each rank's part of the product
  on its shards and says where the result lies (sharded, or a partial sum
  that a later ``constrain`` reduces), and never moves an operand that is
  already sharded. Functions that must see whole tensors (the attention
  kernel, RoPE, the cross entropy over vocabulary shards) or that loop on
  a rank's own part (the RG-LRU scan, the RWKV-6 chunk loop) run behind
  :func:`local_seam`, a ``local_map`` whose placements come from rule
  names; inside one, :func:`gather_shards` makes a split local tensor
  whole for a contraction over its split dim. Outside such a step a DTensor is redistributed over the whole
  mesh and any other tensor is returned as it is.
* ``data_parallel_sum`` / ``data_parallel_size`` are the gradient
  reduction that GSPMD inserts for the reference: inside a sharded step
  they sum over the data-parallel ranks, outside one they are the identity.
* Expert parallelism: the reference's boundary between ``moe_tokens``
  (the batch over the data axes) and ``moe_hidden`` (the experts over
  them) is GSPMD's token all-to-all. Here it is :func:`expert_exchange`,
  an all-to-all (with its gradient) over the data-parallel ranks that a
  step's expert weights are split over (:func:`expert_parallel`, which
  ``launch.shardings.sharded`` opens around a step on the ``"tp"``
  route). A DTensor is exchanged on its local tensor, never by
  ``redistribute``: on the CPU's process groups DTensor moves a shard
  from one dim to another by an all-gather and a slice.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["P", "ShardingCtx", "activate", "cache_logical", "compute_mesh", "constrain",
           "current", "data_parallel", "data_parallel_size", "data_parallel_sum", "einsum",
           "exchange_counts", "expert_exchange", "expert_parallel", "expert_part",
           "gather_shards", "laid_out_as", "local_seam", "mesh_axis_sizes", "model_rank",
           "own_part", "placements", "replicated", "reset_exchange_counts", "resume",
           "snapshot", "spec", "tensor_parallel", "unsplit", "use_mesh"]

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


def placements(s: P, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements of ``s`` over ``mesh``, one a mesh dimension:
    ``Shard(d)`` where tensor dim ``d`` is split over it, else
    ``Replicate()``. A dim split over several axes (``("pod", "data")``)
    is split over them major first, which is DTensor's order too, so the
    axes must come in the mesh's order. Given the tensor's ``ndim``, an
    entry past its dims is read as whole where its axes have one rank (the
    storage-format trees' ``_drop_misfits`` keeps such an entry, since 1
    divides every size) and raises elsewhere."""
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
        if ndim is not None and dim >= ndim:
            if any(mesh.size(i) > 1 for i in idx):
                raise ValueError(f"{s}: dim {dim} of a {ndim}-dim tensor is split")
            continue
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{s}: axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


class ShardingCtx:
    def __init__(self, mesh, rules: dict, serve: bool = False, profile: str = "tp"):
        self.mesh = mesh
        self.rules = rules
        self.serve = serve
        self.profile = profile

    def spec(self, name: str) -> P:
        return self.rules[name]

    def constrain(self, x, name: str):
        """``x`` redistributed to the rule's placements. Inside a
        tensor-parallel step: over the compute mesh (:func:`tensor_parallel`),
        a plain tensor first taken as replicated over it. Outside one: a
        DTensor over the whole mesh, any other tensor as it is."""
        from torch.distributed.tensor import DTensor

        sub = compute_mesh()
        if sub is not None:
            x = replicated(x)
            return _to(x, _compute_placements(self.rules[name], sub, tuple(x.shape)))
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
    ctx = ShardingCtx(mesh, rules, serve=serve, profile=profile)
    with activate(ctx):
        yield ctx


@contextlib.contextmanager
def activate(ctx: ShardingCtx | None):
    """``ctx`` as the current context inside the block (a step built under
    ``use_mesh`` runs under its table wherever it is called)."""
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


def data_parallel_sum(tree, like=None):
    """Each tensor leaf of ``tree`` summed over the data-parallel ranks of
    the current sharded step (an all-reduce over its mesh dimensions, run
    even where they have one rank); ``tree`` itself outside one.

    ``like`` (a tree of the same structure: the step's parameters, of
    which ``tree`` holds the gradients) names the leaves that the step
    sees split over data-parallel dims (:func:`expert_parallel`: a rank's
    own experts). Such a gradient holds this rank's experts, into which
    the exchange's backward has already summed every rank's rows: it is
    summed over the other data-parallel dims only (none, where the
    experts are split over all of them). Summed over its own, it would add
    different experts together."""
    dp = getattr(_state, "dp", None)
    if dp is None:
        return tree
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..tree import tree_map

    mesh, dims = dp
    replicate = [Replicate()] * mesh.ndim

    def reduce(x, p=None):
        over = tuple(i for i in dims if i not in _expert_dims_of(p))
        if dims and not over:
            return x
        partial = [Partial() if i in over else Replicate() for i in range(mesh.ndim)]
        # A DTensor of a tensor-parallel step: its local shard is summed,
        # its placement over ``model`` kept.
        local = x.to_local() if isinstance(x, DTensor) else x
        d = DTensor.from_local(local, mesh, partial, run_check=False)
        out = d.redistribute(mesh, replicate).to_local()
        if isinstance(x, DTensor):
            return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return out

    return tree_map(reduce, tree) if like is None else tree_map(reduce, tree, like)


# ------------------------------------------------- expert-parallel exchange
# Calls of expert_exchange inside a sharded step, counted where it runs its
# all-to-all (a group of one rank included).
_exchanges = {"calls": 0}


@contextlib.contextmanager
def expert_parallel(mesh, dims: tuple[int, ...] = (), leaves=()):
    """Inside the block, :func:`expert_exchange` exchanges over ``mesh``
    (a 1-D mesh of the data-parallel ranks that the step's expert weights
    are split over, in the order of their chunks; ``None`` closes it):
    ``dims`` are those ranks' dims of the step's mesh, ``leaves`` the
    step's inputs that it sees split over them (by ``id``: the expert
    weights and their moments, whose gradients :func:`data_parallel_sum`
    does not sum over ``dims``). ``launch.shardings.sharded`` opens it."""
    prev = getattr(_state, "ep", None)
    _state.ep = None if mesh is None else (mesh, tuple(dims), frozenset(leaves))
    try:
        yield mesh
    finally:
        _state.ep = prev


def _expert_dims_of(x) -> tuple:
    """The step-mesh dims over which the current step sees ``x`` split as
    an expert weight (a leaf :func:`expert_parallel` names), else ()."""
    ep = getattr(_state, "ep", None)
    return ep[1] if ep is not None and x is not None and id(x) in ep[2] else ()


def expert_part(x) -> tuple[int, int]:
    """(this rank's chunk, the chunks) of ``x``'s split over the
    data-parallel ranks of the current step's expert exchange, where the
    step sees ``x`` split so (a leaf :func:`expert_parallel` names); (0, 1)
    for any other tensor."""
    if not _expert_dims_of(x):
        return 0, 1
    mesh = _state.ep[0]
    return int(mesh.get_local_rank()), int(mesh.size())


def exchange_counts() -> dict:
    """{"calls": the :func:`expert_exchange` calls that exchanged}."""
    return dict(_exchanges)


def reset_exchange_counts() -> None:
    _exchanges["calls"] = 0


def expert_exchange(x, split_dim: int, concat_dim: int):
    """Inside a step with an expert exchange (:func:`expert_parallel`),
    ``x`` exchanged over its ``n`` ranks: dim ``split_dim`` is cut into
    ``n`` equal chunks, chunk ``j`` is sent to rank ``j``, and the chunks
    received are concatenated on ``concat_dim`` in the order of the
    ranks that sent them (an all-to-all, ``all_to_all_single`` of the
    functional collectives, whose backward is the reverse exchange). With
    ``(split_dim, concat_dim) = (1, 0)`` a (B, E, C, D) dispatch becomes
    (n·B, E/n, C, D): this rank's experts' slots from every rank's rows;
    ``(0, 1)`` sends them back. A DTensor (over the ``model`` submesh)
    is exchanged on its local tensor and keeps its placements, which must
    not lie on either dim. Outside such a step, ``x`` itself."""
    ep = getattr(_state, "ep", None)
    if ep is None:
        return x
    from torch.distributed.tensor import DTensor

    mesh = ep[0]
    _exchanges["calls"] += 1
    if not isinstance(x, DTensor):
        return _exchange_local(x, split_dim, concat_dim, mesh)
    dims = {split_dim % x.ndim, concat_dim % x.ndim}
    if any(p.is_shard() and p.dim % x.ndim in dims for p in x.placements):
        raise ValueError(f"expert_exchange: {x.placements} split a dim of {sorted(dims)}, "
                         "the dims it exchanges")
    out = _exchange_local(x.to_local(), split_dim, concat_dim, mesh)
    return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False)


def _exchange_local(t, split_dim: int, concat_dim: int, mesh):
    from torch.distributed._functional_collectives import all_to_all_single, wait_tensor

    n = mesh.size()
    split_dim, concat_dim = split_dim % t.ndim, concat_dim % t.ndim
    if t.shape[split_dim] % n:
        raise ValueError(f"expert_exchange: dim {split_dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    # (..., n, S/n, ...) with the n chunks leading: chunk j goes to rank j.
    parts = t.unflatten(split_dim, (n, t.shape[split_dim] // n)).movedim(split_dim, 0)
    # Waited here: a local_map that meets the asynchronous result drops
    # its gradient.
    got = wait_tensor(all_to_all_single(parts.contiguous(), None, None, mesh))
    # Chunk j came from rank j: laid before concat_dim's entries, merged.
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


# ------------------------------------------------- tensor-parallel compute
@contextlib.contextmanager
def tensor_parallel(mesh):
    """Inside the block, the step's activations are DTensors over
    ``mesh`` (the 1-D ``model`` submesh of the step's mesh):
    :func:`constrain`, :func:`einsum` and :func:`local_seam` act over it.
    ``launch.shardings.sharded`` opens it around a step on the ``"tp"``
    route; ``None`` closes it (a nested step on the gathered route)."""
    prev = getattr(_state, "tp", None)
    _state.tp = mesh
    try:
        yield mesh
    finally:
        _state.tp = prev


def compute_mesh():
    """The mesh of the current tensor-parallel step, or None outside one."""
    return getattr(_state, "tp", None)


def snapshot() -> dict:
    """The current context, data-parallel, tensor-parallel and
    expert-parallel state."""
    return {k: getattr(_state, k, None) for k in ("ctx", "dp", "tp", "ep")}


@contextlib.contextmanager
def resume(state: dict):
    """``state`` (a :func:`snapshot`) as the current state inside the
    block: a recompute that the autograd engine runs on its own thread
    (a period under remat, on the card) sees the step's tables."""
    prev = snapshot()
    for k, v in state.items():
        setattr(_state, k, v)
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(_state, k, v)


def model_rank() -> int:
    """This rank's coordinate on the compute mesh (0 outside a step)."""
    sub = compute_mesh()
    return 0 if sub is None else int(sub.get_local_rank())


def _compute_placements(s: P, mesh, shape: tuple) -> tuple:
    """The placements of spec ``s`` over the compute mesh ``mesh`` (whose
    axes are a subset of the spec's mesh): ``Shard(d)`` where tensor dim
    ``d``'s entry names the axis and its size divides over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis, n in zip(mesh.mesh_dim_names, mesh.shape):
        place = Replicate()
        for dim, entry in enumerate(s):
            if axis in _axes(entry) and dim < len(shape) and shape[dim] % n == 0:
                place = Shard(dim)
        out.append(place)
    return tuple(out)


def _to(x, target: tuple):
    """DTensor ``x`` redistributed to ``target`` unless it is there."""
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(x.device_mesh, target)


def replicated(x):
    """Inside a tensor-parallel step, the plain tensor ``x`` (the same on
    every rank of the compute mesh: a batch's rows, positions, masks) as a
    replicated DTensor; anything else as it is."""
    sub = compute_mesh()
    if sub is None or not _is_plain_tensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, sub, [Replicate()] * sub.ndim, run_check=False)


def _is_plain_tensor(x) -> bool:
    import torch
    from torch.distributed.tensor import DTensor

    return isinstance(x, torch.Tensor) and not isinstance(x, DTensor)


def unsplit(x, *dims: int):
    """DTensor ``x`` with its partial sums reduced and the tensor dims
    ``dims`` made whole (all-reduce / all-gather over the compute mesh);
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    nd = x.ndim
    whole = {d % nd for d in dims}
    target = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim in whole) else p
                   for p in x.placements)
    return _to(x, target)


def laid_out_as(x, like):
    """DTensor ``x`` redistributed to the placements of DTensor ``like``
    (a partial sum reduce-scattered onto ``like``'s split, say); anything
    else as it is."""
    if not hasattr(x, "placements") or not hasattr(like, "placements"):
        return x
    return _to(x, tuple(like.placements))


def gather_shards(x, dim: int):
    """For a function behind :func:`local_seam`: inside a tensor-parallel
    step, the local tensor ``x``, this rank's part of a tensor split over
    the compute mesh on ``dim``, made whole (an all-gather). Its gradient
    is taken as a partial sum, which the backward reduce-scatters: each
    rank contracts the whole tensor with its own columns of a weight.
    Outside one, a view of ``x``: the gradients of the whole tensor's uses
    are summed before they meet those of ``x``'s other uses, as in a step,
    so that both give the same bits at one rank."""
    sub = compute_mesh()
    if sub is None:
        return x.view_as(x)
    from torch.distributed.tensor import DTensor, Partial, Shard

    split = DTensor.from_local(x, sub, [Shard(dim % x.ndim)] * sub.ndim, run_check=False)
    return split.full_tensor(grad_placements=[Partial()] * sub.ndim)


def own_part(x, n: int):
    """For a function behind :func:`local_seam`: the ``n`` entries of the
    last dim of the whole local tensor ``x`` that this rank's part of a
    tensor split over the compute mesh on its last dim covers (a
    replicated weight met by split activations); ``x`` itself where it
    has ``n``."""
    if x.shape[-1] == n:
        return x
    first = model_rank() * n
    return x[..., first:first + n]


def _resolve(where, x):
    """Placements over the compute mesh for argument ``x``: a rule name,
    placements as given, or None (a non-tensor argument)."""
    if where is None or isinstance(where, tuple) and (not where or not isinstance(where[0], str)):
        return where
    if isinstance(where, str):
        return _compute_placements(current().rules[where], compute_mesh(), tuple(x.shape))
    return tuple(where)


def local_seam(fn, out, ins, grads=None):
    """``fn``, a function of local tensors, over the current step's
    DTensors: a ``local_map`` whose placements are rule names (resolved
    against each argument's shape, as :func:`constrain` resolves them) or
    placements tuples; ``ins`` has one entry an argument (None for a
    non-tensor or plain-tensor argument, which passes as it is), ``out``
    one an output (a rule name resolved against the first argument's
    shape, or placements), ``grads`` the placements of the inputs'
    gradients where they differ from ``ins`` (a replicated input that
    each rank uses only in part has a partial gradient). The arguments are
    redistributed to ``ins`` first. Outside a tensor-parallel step, ``fn``
    itself."""

    def call(*args):
        sub = compute_mesh()
        if sub is None or not any(not _is_plain_tensor(a) and hasattr(a, "placements")
                                  for a in args):
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map

        in_p = tuple(_resolve(w, a) for w, a in zip(ins, args))
        args = tuple(replicated(a) if p is not None else a for a, p in zip(args, in_p))
        outs = out if isinstance(out, list) else [out]
        out_p = tuple(_resolve(w, args[0]) for w in outs)
        g = None if grads is None else tuple(
            p if w is None else _resolve(w, a) for w, p, a in zip(grads, in_p, args))
        # local_map reads a tuple as one placements list an output.
        mapped = local_map(fn, out_placements=(tuple(list(o) for o in out_p)
                                               if isinstance(out, list) else list(out_p[0])),
                           in_placements=in_p, in_grad_placements=g, device_mesh=sub,
                           redistribute_inputs=True)
        return mapped(*args)

    return call


def einsum(eq: str, *operands, local=None):
    """``torch.einsum(eq, *operands)`` (or ``local(*operands)``, a function
    computing the same product, such as ``torch.matmul``); inside a
    tensor-parallel step, over DTensor operands, each rank's part of it.

    On each compute-mesh axis the operands after the first are held where
    they lie (the weights and the cache: never gathered here), and they
    must be sharded on one index letter at most. The first operand (the
    activation) follows them: it is moved to that letter (or made whole if
    its term lacks it) where it is sharded on another. Replicated operands
    that carry the letter are sliced to it (no communication). The result
    is sharded on the letter, or, where the letter is summed over, a
    partial sum (``Partial()``) that a later :func:`constrain` or
    :func:`unsplit` reduces. A partial operand is reduced first."""
    import torch

    fn = local or (lambda *xs: torch.einsum(eq, *xs))
    sub = compute_mesh()
    if sub is None or all(_is_plain_tensor(o) for o in operands):
        return fn(*operands)
    from torch.distributed.tensor import Partial, Replicate, Shard

    lhs, rhs = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    operands = [unsplit(replicated(o)) for o in operands]
    in_p, grad_p, out_p = [], [], []
    for axis in range(sub.ndim):
        held = {t[o.placements[axis].dim] for t, o in zip(terms[1:], operands[1:])
                if o.placements[axis].is_shard()}
        if len(held) > 1:
            raise ValueError(f"einsum {eq!r}: the held operands are sharded on {sorted(held)} "
                             f"over the compute mesh's axis {axis}")
        first = operands[0].placements[axis]
        letter = held.pop() if held else (terms[0][first.dim] if first.is_shard() else "")
        in_p.append([Shard(t.index(letter)) if letter and letter in t else Replicate()
                     for t in terms])
        # A replicated operand without the letter meets only this rank's
        # part of it: its gradient is a partial sum.
        grad_p.append([Shard(t.index(letter)) if letter and letter in t
                       else (Partial() if letter else Replicate()) for t in terms])
        out_p.append(Replicate() if not letter else
                     Shard(rhs.index(letter)) if letter in rhs else Partial())
    ins = [tuple(p[i] for p in in_p) for i in range(len(terms))]
    grads = [tuple(p[i] for p in grad_p) for i in range(len(terms))]
    return local_seam(fn, tuple(out_p), ins, grads)(*operands)
