"""The spec trees of ``launch/shardings.py`` against the reference's, leaf
by leaf by flattened path.

At smoke size on a (1, 1) mesh (a world-size-1 gloo ``DeviceMesh`` in the
port, a (1, 1) JAX mesh in the reference) for all ten configs, and at the
production shapes 16 × 16 and 2 × 16 × 16 on the published widths, through
the reference's stand-in mesh (axis names and a device-array shape): the
port's trees over its ``meta`` stand-ins against the reference's over its
``jax.ShapeDtypeStruct`` ones, for the parameters, the decode cache, every
cell's batch, the optimizer state and the storage-format (compressed)
trees, under the ``"tp"`` rules for training and for serving and the
``"dp"`` rules; and, under both ``"tp"`` tables at the production shapes,
how the tp route rebuilds each quantized leaf of the storage format
(``compressed_serve.rebuild_cases``).

On the multi-pod mesh the reference's own ``"tp"`` table has lost the pod
axis under JAX 0.9 (``tests/test_torch_sharding.py`` pins that); there the
reference's tree functions are given the port's table, so what is held is
the path rules and the fitting to the mesh.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import repro.distributed.sharding as RS
import repro.launch.compressed_serve as r_cs
import repro.launch.shardings as RSH
import repro.launch.specs as r_specs
from repro.configs import get_config as r_get_config
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import compressed_serve as cs
from repro_torch.launch import shardings as shd
from repro_torch.launch import specs as t_specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import SHAPES


class StandIn:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


MESHES = {"16x16": StandIn((16, 16), ("data", "model")),
          "2x16x16": StandIn((2, 16, 16), ("pod", "data", "model"))}
# (profile, seq_shard, serve) as the dry run picks them for train / decode.
MODES = {"tp-train": ("tp", True, False), "tp-serve": ("tp", False, True),
         "dp": ("dp", True, False)}
DECODERS = [a for a in list_archs() if get_config(a).has_decode]
CELLS = [(a, s) for a in list_archs() for s in SHAPES if get_config(a).supports_shape(s)]


def _flat(tree, spec_type) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, spec_type))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _assert_same_specs(got, want) -> None:
    g, w = _flat(got, P), _flat(want, JP)
    assert list(g) == list(w)
    for path in w:
        assert P(*g[path]) == w[path], (path, g[path], w[path])


def _contexts(mesh, mode: str):
    """The port's context over ``mesh`` and the reference's over the same
    shape with the table it is held to."""
    profile, seq_shard, serve = mode
    multi_pod = "pod" in mesh.axis_names
    with sh.use_mesh(mesh, multi_pod=multi_pod, seq_shard=seq_shard, serve=serve,
                     profile=profile) as ctx:
        pass
    if profile == "tp" and multi_pod:  # the port's table, as JAX specs
        rules = {k: JP(*s) for k, s in ctx.rules.items()}
    elif profile == "dp":
        rules = RS._rules_dp(n_axes=3 if multi_pod else 2)
    else:
        rules = RS._rules_single_pod(seq_shard, serve)
        rules = RS._serving_params(rules) if serve else rules
    return ctx, RS.ShardingCtx(mesh, rules)


@functools.cache
def _r_model_specs(arch):
    return r_specs.model_specs(r_get_config(arch))


@functools.cache
def _t_model_specs(arch):
    return t_specs.model_specs(get_config(arch))


# ----------------------------------------------------- production shapes
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_at_production_shapes(arch, mesh, mode):
    ctx, r_ctx = _contexts(MESHES[mesh], MODES[mode])
    _assert_same_specs(shd.param_specs_tree(_t_model_specs(arch), ctx),
                       RSH.param_specs_tree(_r_model_specs(arch), r_ctx))


@pytest.mark.parametrize("mode", ["tp-serve", "dp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_at_production_shapes(arch, mesh, mode):
    """The decode_32k cache (128 × 32,768)."""
    ctx, r_ctx = _contexts(MESHES[mesh], MODES[mode])
    shape = SHAPES["decode_32k"]
    cfg = get_config(arch)
    got = shd.cache_specs_tree(t_specs.decode_cache_specs(cfg, shape), ctx, cfg.n_kv_heads)
    want = RSH.cache_specs_tree(r_specs.decode_cache_specs(r_get_config(arch), shape), r_ctx,
                                cfg.n_kv_heads)
    _assert_same_specs(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_at_production_shapes(arch, shape, mesh):
    s = SHAPES[shape]
    ctx, r_ctx = _contexts(MESHES[mesh], ("tp", s.kind != "decode", not s.is_train))
    got = shd.batch_specs_tree(t_specs.batch_specs(get_config(arch), s), ctx)
    want = RSH.batch_specs_tree(r_specs.batch_specs(r_get_config(arch), s), r_ctx)
    _assert_same_specs(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_opt_specs_at_production_shapes(arch, mesh):
    ctx, r_ctx = _contexts(MESHES[mesh], MODES["tp-train"])
    got = shd.opt_specs_tree(None, shd.param_specs_tree(_t_model_specs(arch), ctx))
    want = RSH.opt_specs_tree(None, RSH.param_specs_tree(_r_model_specs(arch), r_ctx))
    _assert_same_specs(got, want)
    assert got["step"] == P()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_compressed_param_specs_at_production_shapes(arch, mesh):
    """The storage-format trees of the float32 twins (the reference leaves
    bfloat16 leaves raw, ROADMAP queue C)."""
    ctx, r_ctx = _contexts(MESHES[mesh], MODES["tp-serve"])
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32")
    r_cfg = dataclasses.replace(r_get_config(arch), param_dtype="float32")
    got = shd.compressed_param_specs_tree(cs.compressed_param_specs(cfg), ctx)
    want = RSH.compressed_param_specs_tree(r_cs.compressed_param_specs(r_cfg), r_ctx)
    _assert_same_specs(got, want)


# The quantized leaves whose packed delta a rank on the tp route must gather
# over ``model`` before it rebuilds its part (case (c) of
# ``compressed_serve.rebuild_cases``), {(arch, mesh, mode): paths}: none of
# the zoo's at the production shapes, under either "tp" table.
REBUILD_GATHERED: dict = {}
# internlm2-1.8b's leaves under the serving table on 16 x 16: the embedding's
# packed rows, the head's packed columns and the stacked wd's flattened F · D
# columns split over ``model`` as their bases are (a); the packed delta of
# the stacked attention and gate / up projections whole over ``model``, the
# bases split on d_head or F, so that each rank slices its columns (b).
INTERNLM2_SERVE_CASES = {"embed": "a", "lm_head": "a", "periods/slot0/mix/wd": "a",
                         **{f"periods/slot0/{w}": "b" for w in ("seq/wq", "seq/wk", "seq/wv",
                                                                 "seq/wo", "mix/wg", "mix/wu")}}


def _step_axes(spec, ndim: int, dp: tuple) -> set:
    """The axes over which a step on the tp route sees a leaf placed at
    ``spec`` split: ``model``, and the batch's data-parallel axes where an
    entry is written as the batch's (an expert weight's)."""
    out = set()
    for entry in tuple(spec)[:ndim]:
        if "model" in sh._axes(entry):
            out.add("model")
        if isinstance(entry, tuple) and entry and set(entry) <= set(dp):
            out.add("experts")
    return out


@pytest.mark.parametrize("mode", ["tp-train", "tp-serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rebuild_cases_at_production_shapes(arch, mesh, mode):
    """How the tp route rebuilds each quantized leaf of the zoo's storage
    format (``cs.rebuild_cases``) at the production shapes: case (a) where
    the step sees its packed delta split over every axis it sees the base
    split over, (b) where over fewer (the packed whole over ``model``, a
    rank slicing its columns and rows before it unpacks), (c) only for the
    leaves ``REBUILD_GATHERED`` names; internlm2's as the serving layout
    gives them."""
    ctx, _ = _contexts(MESHES[mesh], MODES[mode])
    qspecs = cs.compressed_param_specs(get_config(arch))
    cases = cs.rebuild_cases(qspecs, ctx)
    specs = shd.compressed_param_specs_tree(qspecs, ctx)
    dp = sh._axes(ctx.spec("tokens")[0])
    want = {}
    for (path, q), (_, s) in zip(cs._quantized_items(qspecs), cs._quantized_items(specs)):
        if "raw" in q:
            continue
        base = _step_axes(s["base"], q["base"].ndim, dp)
        packed = _step_axes(s["packed"], 2, dp)
        assert packed <= base, path
        want["/".join(map(str, path))] = "a" if packed == base else "b"
    for path in REBUILD_GATHERED.get((arch, mesh, mode), []):
        want[path] = "c"
    assert cases == want
    if (arch, mesh, mode) == ("internlm2-1.8b", "16x16", "tp-serve"):
        assert cases == INTERNLM2_SERVE_CASES


# ------------------------------------------------------ smoke, (1, 1) mesh
@pytest.fixture(scope="module")
def mesh11():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu"), \
            jax.make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_at_smoke_size(mesh11, arch, mode):
    mesh, r_mesh = mesh11
    profile, seq_shard, serve = MODES[mode]
    kw = dict(seq_shard=seq_shard, serve=serve, profile=profile)
    with sh.use_mesh(mesh, **kw) as ctx:
        got = shd.param_specs_tree(t_specs.model_specs(get_config(arch, smoke=True)), ctx)
    with RS.use_mesh(r_mesh, **kw) as r_ctx:
        want = RSH.param_specs_tree(r_specs.model_specs(r_get_config(arch, smoke=True)), r_ctx)
    _assert_same_specs(got, want)
    placements = jax.tree_util.tree_leaves(shd.named(got, mesh),
                                           is_leaf=lambda x: isinstance(x, tuple))
    assert len(placements) == len(_flat(got, P))
    assert all(len(p) == 2 for p in placements)


@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_at_smoke_size(mesh11, arch):
    mesh, r_mesh = mesh11
    cfg = get_config(arch, smoke=True)
    with sh.use_mesh(mesh, seq_shard=False, serve=True) as ctx:
        got = shd.cache_specs_tree(t_specs.decode_cache_specs(cfg, SHAPES["decode_32k"]), ctx,
                                   cfg.n_kv_heads)
    with RS.use_mesh(r_mesh, seq_shard=False, serve=True) as r_ctx:
        want = RSH.cache_specs_tree(
            r_specs.decode_cache_specs(r_get_config(arch, smoke=True), SHAPES["decode_32k"]),
            r_ctx, cfg.n_kv_heads)
    _assert_same_specs(got, want)
