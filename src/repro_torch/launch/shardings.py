"""Path-based sharding assignment for parameter / optimizer / cache trees,
and the sharded step wrapper.

The port of the reference's ``repro/launch/shardings.py``. Every leaf of
the params tree is mapped to a logical axis name (the rules in
``repro_torch.distributed.sharding``) by its path and rank; leaves under
``periods`` are stacked over periods and get a leading replicated dim. The
trees are the port's dicts and lists; a path is its dict keys and list
indices, keyed as the reference keys ``jax.tree_util`` paths.

:func:`sharded` is the counterpart of ``jax.jit(step, in_shardings,
out_shardings)``. PyTorch has no GSPMD to partition an unchanged step, so
the wrapper keeps the state at rest as DTensors placed by the spec trees
and hands the step each rank's part: its rows of the batch over the
data-parallel axes (the ``tokens`` rule's), and the other inputs gathered
over the data-parallel axes (FSDP). What it does over ``model`` is the
step's *route* (:func:`compute_route`):

* ``"tp"``, a model of attention, RG-LRU, RWKV-6 and dense or RWKV
  channel-mix blocks under a rule table that shards over a ``model`` axis
  of more than one rank: the inputs keep their ``model`` shards, as
  DTensors over the ``model`` submesh, and the model code splits each
  layer's compute over the axis at the reference's sharding constraints
  (``sh.constrain``, ``sh.einsum``, ``sh.local_seam``), as GSPMD does at
  them: heads, FFN columns and vocabulary columns, RG-LRU channels and
  RWKV-6 heads, the scans and the chunk loop on each rank's own;
* ``"gathered"``, every other step (the ``"dp"`` rules, a ``model`` axis
  of one rank, the MoE blocks, the compressed parameters, a step named no
  config): every input is gathered whole and the step runs on local
  tensors, so the ranks of a ``model`` group repeat each other's
  compute.

Either way the gradients are summed over the data-parallel ranks inside
the step (``sharding.data_parallel_sum`` in ``make_train_step``), so every
rank updates the same parameters.
"""

from __future__ import annotations

from ..distributed import sharding as sh
from ..distributed.sharding import P
from ..tree import tree_leaves, tree_map

__all__ = ["TP_MIX_BLOCKS", "TP_SEQ_BLOCKS", "batch_specs_tree", "cache_specs_tree",
           "compressed_param_specs_tree", "compute_route", "fit_spec", "local_bytes", "named",
           "opt_specs_tree", "param_specs_tree", "per_batch", "place", "sharded"]


def _key_str(entry) -> str:
    return f"[{entry}]" if isinstance(entry, int) else str(entry)


def _map_with_path(fn, tree, is_leaf=None, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` holds the
    dict keys and list indices from the root."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, is_leaf, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, is_leaf, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _logical_for_param(path: tuple, ndim: int, stacked: bool) -> str:
    keys = [_key_str(k) for k in path]
    name = keys[-1]
    base_ndim = ndim - (1 if stacked else 0)
    in_seq = "seq" in keys
    if name == "embed":
        return "p_embed"
    if name == "lm_head":
        return "p_head"
    if name in ("norm1", "norm2", "final_norm", "q_norm", "k_norm", "ln_w", "mu"):
        return "p_vec"
    if name in ("wq", "wk", "wv") and in_seq and base_ndim == 3:
        return "p_attn_qkv"
    if name == "wo" and in_seq and base_ndim == 3:
        return "p_attn_o"
    if name in ("wx", "wgate"):
        return "p_rnn_in"
    if name in ("wa", "wi") and in_seq:
        return "p_rnn_sq"
    if name == "conv":
        return "p_conv"
    if name == "lam":
        return "p_rnn_vec"
    if name == "u":
        return "p_rwkv_u"
    if name == "w_lora_a":
        return "p_rwkv_lora_a"
    if name == "w_lora_b":
        return "p_rwkv_lora_b"
    if name == "router":
        return "p_router"
    if name in ("wg", "wu") and base_ndim == 3:
        return "p_expert_in"
    if name == "wd" and base_ndim == 3:
        return "p_expert_out"
    # 2D channel/sequence projections: (D, F)-like → in; (F, D)-like → out.
    if name in ("wg", "wu", "w1", "wk", "wr", "wkx") and base_ndim == 2:
        return "p_ffn_in"
    if name in ("wd", "w2", "wv", "wo") and base_ndim == 2:
        return "p_ffn_out"
    return "p_vec"  # conservative: replicated


def _logical_for_cache(path: tuple) -> str | None:
    name = _key_str(path[-1])
    if name in ("k", "v"):
        return None  # adaptive — resolved against the live mesh below
    if name == "h":
        return "rnn_state"
    if name == "conv":
        return "cache_conv"
    if name == "wkv":
        return "rwkv_state"
    if name in ("shift_tm", "shift_cm"):
        return "cache_shift"
    raise ValueError(f"unknown cache leaf {name}")


def _spec_with_stack(spec: P, stacked: bool) -> P:
    if not stacked:
        return spec
    return P(*((None,) + tuple(spec)))


# Alternate specs tried in order when a dim is not divisible by its mesh
# axis: KV-head dims (8, 2, 1 heads) can't split over model=16 → shard
# d_head or replicate; granite's 40 experts can't split over data=16 →
# shard (D, F) instead; odd vocabs (49155, 504) replicate the vocab dim.
_ALTERNATES = {
    "p_attn_qkv": [P("data", "model", None), P("data", None, "model"),
                   P("data", None, None)],
    "p_attn_o": [P("model", None, "data"), P(None, "model", "data"),
                 P(None, None, "data")],
    "p_expert_in": [P(("data",), None, "model"), P(None, "data", "model"),
                    P(None, None, "model")],
    "p_expert_out": [P(("data",), "model", None), P(None, "model", "data"),
                     P(None, "model", None)],
    "p_embed": [P("model", "data"), P(None, "data"), P(None, "model")],
    "p_head": [P("data", "model"), P("data", None), P(None, None)],
    "p_router": [P("data", None), P(None, None)],
}


def _axis_size(mesh, axis) -> int:
    """The ranks ``axis`` (a name, a tuple of names or None) spans on
    ``mesh``: a ``DeviceMesh`` or the reference's stand-in."""
    sizes = sh.mesh_axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _fits(spec: P, shape: tuple, mesh) -> bool:
    for dim, axis in zip(shape, tuple(spec)):
        if dim % _axis_size(mesh, axis):
            return False
    return True


def _drop_misfits(spec: P, shape: tuple, mesh) -> P:
    fixed = []
    for i, axis in enumerate(tuple(spec)):
        dim = shape[i] if i < len(shape) else 1
        fixed.append(axis if dim % _axis_size(mesh, axis) == 0 else None)
    return P(*fixed)


def fit_spec(logical: str, spec: P, shape: tuple, mesh) -> P:
    """First alternate whose axes divide ``shape``; else drop offenders."""
    if _fits(spec, shape, mesh):
        return spec
    for alt in _ALTERNATES.get(logical, []):
        if _fits(alt, shape, mesh):
            return alt
    return _drop_misfits(spec, shape, mesh)


def param_specs_tree(params_tree, ctx: sh.ShardingCtx, kv_heads: int | None = None):
    """Spec tree for params (or optimizer moments — same shape)."""

    def assign(path, leaf):
        stacked = "periods" in [_key_str(k) for k in path]
        logical = _logical_for_param(path, leaf.ndim, stacked)
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        spec = fit_spec(logical, ctx.spec(logical), shape, ctx.mesh)
        return _spec_with_stack(spec, stacked)

    return _map_with_path(assign, params_tree)


def cache_specs_tree(cache_tree, ctx: sh.ShardingCtx, kv_heads: int):
    model_size = sh.mesh_axis_sizes(ctx.mesh).get("model", 1)
    kv_logical = "cache_bh" if kv_heads % model_size == 0 else "cache_bs"

    def assign(path, leaf):
        stacked = "periods" in [_key_str(k) for k in path]
        logical = _logical_for_cache(path) or kv_logical
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        spec = fit_spec(logical, ctx.spec(logical), shape, ctx.mesh)
        return _spec_with_stack(spec, stacked)

    return _map_with_path(assign, cache_tree)


def batch_specs_tree(batch_tree, ctx: sh.ShardingCtx):
    def assign(path, leaf):
        name = _key_str(path[-1])
        if name in ("tokens", "labels", "mask"):
            logical = "tokens"
        elif name == "embeds":
            logical = "embeds_in"
        else:
            return P()
        return fit_spec(logical, ctx.spec(logical), tuple(leaf.shape), ctx.mesh)

    return _map_with_path(assign, batch_tree)


def opt_specs_tree(opt_tree, params_specs):
    """Optimizer state mirrors param shardings; step is replicated."""
    return {
        "m": params_specs,
        "v": params_specs,
        "step": P(),
    }


def named(tree, mesh):
    """The DTensor placements of every spec of ``tree`` over ``mesh``."""
    return tree_map(lambda s: sh.placements(s, mesh), tree)


def compressed_param_specs_tree(qtree, ctx: sh.ShardingCtx):
    """Specs for storage-format weight trees (compressed serving).

    Each quantized group {base, packed, scales…} inherits the logical spec
    of its original tensor: ``base`` keeps the full-shape spec; ``packed``
    (dim0 halved, trailing dims flattened) keeps the dim-0 axis plus the
    first non-None trailing axis; scalars replicate.
    """
    def is_q(x):
        return isinstance(x, dict) and ("raw" in x or "base" in x)

    def assign(path, q):
        stacked = "periods" in [_key_str(k) for k in path]
        if "raw" in q:
            leaf = q["raw"]
            logical = _logical_for_param(path, leaf.ndim, stacked)
            shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
            spec = fit_spec(logical, ctx.spec(logical), shape, ctx.mesh)
            return {"raw": _spec_with_stack(spec, stacked)}
        base = q["base"]
        logical = _logical_for_param(path, base.ndim, stacked)
        shape = tuple(base.shape[1:] if stacked else base.shape)
        spec = fit_spec(logical, ctx.spec(logical), shape, ctx.mesh)
        tail_axis = next((a for a in tuple(spec)[1:] if a is not None), None)
        pshape = tuple(q["packed"].shape[1:] if stacked else q["packed"].shape)
        pspec = _drop_misfits(P(tuple(spec)[0] if spec else None, tail_axis),
                              pshape, ctx.mesh)
        out = {
            "base": _spec_with_stack(spec, stacked),
            "packed": _spec_with_stack(pspec, stacked),
        }
        for k in ("bs", "bz", "bmid", "ds", "dz"):
            out[k] = _spec_with_stack(P(), stacked)
        return out

    return _map_with_path(assign, qtree, is_leaf=is_q)


# --------------------------------------------------------- sharded steps
def place(tree, specs, mesh):
    """The tensors of ``tree`` as DTensors placed by ``specs`` over
    ``mesh``: a plain tensor, the same global tensor on every rank, is
    distributed by keeping each rank's part (no communication); a DTensor
    is redistributed where its placements differ."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, spec):
        target = sh.placements(spec, mesh)
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == tuple(target) else x.redistribute(mesh, target)
        return distribute_tensor(x, mesh, target, src_data_rank=None)

    return tree_map(one, tree, specs)


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree of DTensors (their local shards)."""
    return sum(x.to_local().numel() * x.to_local().element_size()
               for x in tree_leaves(tree))


class per_batch:
    """Marks one of :func:`sharded`'s specs as the batch's: the step sees
    this rank's rows (its part over the data-parallel axes, whole over the
    others). As an output spec, the step's result is this rank's rows, put
    back in place; ``per_batch(None)`` gathers them whole on every rank."""

    __slots__ = ("specs",)

    def __init__(self, specs=None):
        self.specs = specs


# The blocks whose compute the model code splits over ``model`` (the
# reference's sharding constraints are ported for them). A model with any
# other block (the routed experts) keeps the gathered route.
TP_SEQ_BLOCKS = frozenset({"attn", "local_attn", "rglru", "rwkv6"})
TP_MIX_BLOCKS = frozenset({"swiglu", "gelu", "rwkv_cm"})


def _recurrent_widths(cfg) -> dict[str, int]:
    """The widths that the recurrent blocks of ``cfg`` split over
    ``model``: each rank scans its own RG-LRU channels and runs its own
    RWKV-6 heads."""
    kinds = set(cfg.period) | set(cfg.tail)
    out = {}
    if "rglru" in kinds:
        out["RG-LRU channels (d_rnn)"] = cfg.d_rnn
    if "rwkv6" in kinds:
        out["RWKV-6 heads"] = cfg.d_model // cfg.rwkv_head_dim
    return out


def compute_route(ctx: sh.ShardingCtx, cfg, route: str | None = None) -> str:
    """The route a step of ``cfg`` takes under ``ctx`` (:func:`sharded`).

    By default ``"tp"`` where the table shards over a ``model`` axis of
    more than one rank and every block of the config is one that the
    model code splits (:data:`TP_SEQ_BLOCKS`, :data:`TP_MIX_BLOCKS`: all
    but the routed experts), else ``"gathered"`` (also for a step that
    names no config): on a ``model`` axis of one rank the split has
    nothing to split and costs DTensor's dispatch. ``route`` asks for a
    route instead: ``"gathered"`` always, ``"tp"`` wherever the default
    would split but for the axis' size (a one-rank check of the split
    route); anything else raises. So does the ``"tp"`` route of a config
    whose RG-LRU channels or RWKV-6 heads do not divide over ``model``:
    its scans cannot be split, and are not quietly gathered.
    """
    sizes = sh.mesh_axis_sizes(ctx.mesh)
    splits = (cfg is not None and ctx.profile == "tp" and "model" in sizes
              and (set(cfg.period) | set(cfg.tail)) <= TP_SEQ_BLOCKS
              and (set(cfg.mix) | set(cfg.tail_mix)) <= TP_MIX_BLOCKS)
    if route is None:
        route = "tp" if splits and sizes["model"] > 1 else "gathered"
    elif not (route == "gathered" or (route == "tp" and splits)):
        raise ValueError(f"route {route!r} is not open to {getattr(cfg, 'name', cfg)} under "
                         f"the {ctx.profile!r} table on a mesh of {sizes}")
    if route == "tp":
        odd = {what: n for what, n in _recurrent_widths(cfg).items() if n % sizes["model"]}
        if odd:
            raise ValueError(f"{cfg.name}'s {odd} do not divide over a model axis of "
                             f"{sizes['model']} ranks: its recurrent blocks cannot be split")
    return route


def sharded(step, in_specs: tuple, out_specs: tuple, ctx: sh.ShardingCtx, *, cfg=None,
            route: str | None = None):
    """``step`` over the DTensor state placed by spec trees on ``ctx.mesh``.

    ``in_specs`` has one entry an argument: a spec tree (the step sees the
    argument gathered over the data-parallel axes), ``per_batch(spec
    tree)`` (the step sees this rank's rows) or None (passed as it is).
    Plain tensors are placed first, as ``jit`` places host arrays.
    ``out_specs`` has one entry an output: a spec tree (the result is the
    same on every data-parallel rank, and is placed by keeping each rank's
    part), ``per_batch(...)`` as above, or None (returned as it is, a
    DTensor gathered whole). The data-parallel axes are the ``tokens``
    rule's, less any that a batch input is not split over (a batch that
    does not divide over an axis is replicated over it by ``fit_spec``).
    Inside the step, ``sharding.data_parallel_sum`` sums over them.

    The route (:func:`compute_route` of ``cfg``, the step's config, and
    ``route``) decides the ``model`` axis: on ``"tp"`` the step sees each
    input's ``model`` shard as a DTensor over the ``model`` submesh, runs
    under ``ctx``'s table and returns DTensors there; on ``"gathered"`` it
    sees whole local tensors. The inputs are
    not donated; a batch input already placed as the step sees it (a cache
    placed by the rules) is the same storage the step sees, so a step that
    updates it in place updates the input. ``call.route`` names the route.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    dp_dims = tuple(names.index(a) for a in sh._axes(ctx.spec("tokens")[0]))
    route = compute_route(ctx, cfg, route)
    tp_dims = (names.index("model"),) if route == "tp" else ()
    sub = mesh["model"] if tp_dims else None

    def seen(target, split):
        """The placements of what the step sees of a leaf placed at
        ``target``: its rows over ``split``, its ``model`` shard on the
        ``"tp"`` route, whole over every other mesh dim."""
        return [target[i] if i in split or i in tp_dims else Replicate()
                for i in range(mesh.ndim)]

    def to_step(x, split):
        local = x.redistribute(mesh, seen(x.placements, split))
        if not tp_dims:
            return local.to_local()
        return DTensor.from_local(local.to_local(), sub, [local.placements[i] for i in tp_dims],
                                  run_check=False)

    def from_step(x, split, target=None):
        """An output leaf over the whole mesh, as the step left it: its
        rows over ``split`` (on ``target``'s dims, dim 0 without one), its
        ``model`` placement kept on ``"tp"``."""
        kept = {}
        if isinstance(x, DTensor):
            kept = dict(zip(tp_dims, x.placements))
            x = x.to_local()
        rows = [kept.get(i, (target[i] if target else Shard(0)) if i in split else Replicate())
                for i in range(mesh.ndim)]
        return DTensor.from_local(x, mesh, rows, run_check=False)

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def call(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"the step takes {len(in_specs)} arguments, got {len(args)}")
        split = None
        placed_in = []
        for arg, spec in zip(args, in_specs):
            if spec is None:
                placed_in.append((arg, None))
                continue
            rows = isinstance(spec, per_batch)
            placed = place(arg, spec.specs if rows else spec, mesh)
            if rows:
                for x in tree_leaves(placed):
                    mine = tuple(i for i in dp_dims if x.placements[i].is_shard())
                    if split is not None and mine != split:
                        raise ValueError("the batch inputs are split over different "
                                         f"data-parallel axes: {split} and {mine}")
                    split = mine
            placed_in.append((placed, rows))
        split = split or ()
        local = []
        for placed, rows in placed_in:
            if rows is None:
                local.append(placed)
            elif not rows and not tp_dims:
                local.append(tree_map(lambda x: x.full_tensor(), placed))
            else:
                local.append(tree_map(lambda x, r=rows: to_step(x, split if r else ()), placed))
        with sh.activate(ctx), sh.data_parallel(mesh, split), sh.tensor_parallel(sub):
            out = step(*local)
        outs = out if isinstance(out, tuple) else (out,)
        if len(outs) != len(out_specs):
            raise TypeError(f"the step returned {len(outs)} outputs for {len(out_specs)} specs")
        placed_out = []
        for o, spec in zip(outs, out_specs):
            if spec is None:
                placed_out.append(tree_map(whole, o))
            elif isinstance(spec, per_batch) and spec.specs is None:
                placed_out.append(tree_map(
                    lambda x: from_step(whole(x), split).full_tensor(), o))
            elif isinstance(spec, per_batch):
                def back(x, s):
                    target = sh.placements(s, mesh)
                    if any(not target[i].is_shard() for i in split):
                        raise ValueError(f"output spec {s} does not split the batch over the "
                                         "data-parallel axes its inputs were split over")
                    return _to(from_step(x, split, target), target, mesh)
                placed_out.append(tree_map(back, o, spec.specs))
            elif tp_dims:
                placed_out.append(tree_map(
                    lambda x, s: _to(from_step(x, ()), sh.placements(s, mesh), mesh), o, spec))
            else:
                placed_out.append(place(o, spec, mesh))
        return tuple(placed_out) if isinstance(out, tuple) else placed_out[0]

    call.route = route
    return call


def _to(x, target, mesh):
    return x if tuple(x.placements) == tuple(target) else x.redistribute(mesh, target)
