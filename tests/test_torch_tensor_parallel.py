"""Tensor-parallel compute over ``model``: the ``"tp"`` route of
``launch.shardings.sharded``, on the CPU.

Spawned gloo ranks (over a ``FileStore``, each join bounded) on (1, 2) and
(2, 2) ("data", "model") meshes run the dense and recurrent smoke models'
train, prefill and serve steps under the ``"tp"`` rule tables: the
weights stay split over ``model`` as DTensors, the activations are
DTensors over the ``model`` submesh and each rank computes its heads, FFN
columns and vocabulary columns, its RG-LRU channels and its RWKV-6 heads.
Held here:

* the route is ``"tp"``, and the train step's losses within ``DP4_TOL``
  of the unsharded step with one microbatch a data-parallel rank, its
  gradients, AdamW moments and parameters after each of two steps held to
  that step's by ``adam_state_gaps`` (each leaf's gradient within
  ``GRAD_RTOL`` relative L2 error, each weight within ``DP4_TOL`` plus
  what the two runs' own moments make of its updates); the losses are
  within the train tests' tolerance of the reference's unsharded step on
  the same weights (the reference runs only in the test process, while
  the spawned ranks, which import no JAX, run);
* the prefill's last-position logits and the serve step's logits and
  tokens against the unsharded ones, under the serving table (``d_head``
  split over ``model``) and the train table (heads, or the sequence of the
  cache where the KV heads do not divide the axis);
* nine configs: internlm2-1.8b's smoke size and the same with a
  vocabulary that does not divide the axis, a glm4-like one with fewer KV
  heads than ``model`` ranks (each rank's query heads on one KV head), one
  whose ranks' query heads straddle their KV heads, recurrentgemma-9b's
  and rwkv6-7b's smoke sizes (trained at ``RECURRENT_SEQ``'s lengths), and
  the routed experts (``MOE``): granite-moe-3b-a800m's smoke size at the
  capacity factor 1.25 (its own 8.0 drops no pair), arctic-480b's (a dense
  residual beside the experts) and granite's with 5 experts, which do not
  divide over 2 data-parallel ranks (gathered over ``data``, no exchange);
  the experts that divide stay split over ``data``, and the tokens travel
  to them (``sh.expert_exchange``, an all-to-all);
* no all-gather over the ``model`` group inside a step has the shape of a
  weight split over ``model``, nor one over the ``data`` group the shape
  of an expert weight split over ``data`` (read from the recorded
  collectives, which do show such gathers on the gathered route);
* each rank's matmul FLOPs (``FlopCounterMode``) in a train step at (1, 2)
  are at most ``FLOP_SHARE`` of the unsharded step's, for internlm2,
  granite and the two recurrent models; a rank does 1/(d·m) of an MoE
  layer's expert products (forward and backward) at (1, 2) and (2, 2);
* the exchange at (2, 2): each rank receives its experts' slots from
  every data-parallel rank, in their order; its backward sends every
  rank's rows' gradients home and sums them into a rank's experts; the
  recorder sees one all-to-all each way a layer over the ``data`` group,
  and no all-reduce over it of an expert weight's gradient;
* where a sharded prefill or serve step routes a token to other experts
  than the unsharded one, the top-k margin there is printed;
* the DTensor ops a recurrent model's forward dispatches do not grow with
  the sequence (the RWKV-6 chunk loop and the RG-LRU scan's passes run on
  local tensors behind their seams);
* the compressed serve step (``COMPRESSED``, leaves of ``QUANT_SIZE``
  elements and more quantized) on the route under both tables: its tokens
  equal to the unsharded compressed step's, every leaf rebuilt from the
  ranks' parts of the storage format bit-identical to ``dequantize_leaf``
  of the whole leaf, no collective in the rebuild and no all-gather of a
  split weight or storage-format leaf; hand-made leaves of each rebuild
  case (``_crafted_tree``: the packed delta whole over ``data`` while the
  experts are split, and case (c), whose one all-gather is its packed
  part's); ``shd.place`` against ``distribute_tensor`` for each spec form;
* the route each config takes (``compute_route``: every config of the zoo
  takes ``"tp"``), and the dry run of internlm2-1.8b, recurrentgemma-9b,
  rwkv6-7b, granite-moe-3b-a800m and arctic-480b × decode_32k on the
  route: their useful-FLOP ratios and all-gather bytes against the
  gathered route's.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import compressed_serve as cs
from repro_torch.launch import shardings as shd
from repro_torch.launch.hlo_stats import StepRecorder
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import decode_step, init_cache, init_params, layers
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map

JOIN_TIMEOUT_S = 180
MESH_SHAPES = [(1, 2), (2, 2)]
# SEQ: the residual's gather over ``model`` at (2, 2), (2 · 2 rows, 24 / 2,
# 64), has no weight's gathered shape (at 32 it would be wo's, (4, 16, 64)).
TRAIN_STEPS, SERVE_STEPS, BATCH, SEQ, PROMPT, CACHE_LEN = 2, 4, 4, 24, 8, 16
# The recurrent models' train lengths (SEQ is one RWKV-6 chunk and barely
# past recurrentgemma-smoke's 16-token window): recurrentgemma's four
# windows, rwkv6's three chunks of 32. rwkv6's is not 64: at (2, 2) the
# residual's gather over ``model``, (2 · 2 rows, 64 / 2, 64), and the
# channel mix's move from its D split to the sequence split (an
# all-gather on gloo, (4, 64, 64 / 2)) would have the gathered shapes of
# its two stacked periods of wv and wr.
RECURRENT_SEQ = {"recurrentgemma-smoke": 64, "rwkv6-smoke": 96}
# The lengths of the forwards whose DTensor ops are counted: 2 and 4
# RWKV-6 chunks, 6 and 7 RG-LRU scan passes.
OP_COUNT_SEQS = (64, 128)
# Two data-parallel ranks against two microbatches, and a model axis of two
# against one rank's products: the partial sums add in another order, and
# two AdamW steps carry the difference into the parameters and moments
# (tests/test_torch_sharded_steps.py's DP4_TOL).
DP4_TOL = dict(rtol=1e-4, atol=1e-5)
# Logits of a prefill or a decode step split over two ranks against the
# unsharded step's (float32; the row-parallel products' order).
LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
# The reference's unsharded train step against the port's sharded one on
# the same weights (tests/test_torch_train.py's loss tolerance).
LOSS_RTOL = 1e-4
LR = 1e-3
# A split train run is held to the unsharded run after each step
# (``adam_state_gaps``) in two parts. Its gradients: AdamW's first moment
# after the first step is (1 - b1) g, so its relative L2 error is the
# gradient's; every leaf's first m within GRAD_RTOL relative L2 error of
# the unsharded run's, its v (a square) within 2 · GRAD_RTOL. A later
# step's gradients are taken at weights that the earlier steps moved a
# little apart (below), so its moments are held within LATER_RTOL (on
# four H100s at internlm2's widths, 2.5e-5 to 2.9e-5 at the second step
# where the first was within 1e-5). Every element of m and v within the
# state tolerance. Its weights:
# AdamW moves a weight by lr · m̂ / (√v̂ + eps) a step, which turns a
# gradient within its own rounding, or a momentum that two steps'
# gradients nearly cancel, into a difference of up to 2 lr. So each weight
# is held within the state tolerance plus lr · Σ_t |û_t - u_t|, the
# difference that the two runs' own moments make in its updates (an update
# of the wrong size or sign is past it); the weights that need that term
# are counted a leaf, printed, and at most MOVED_SHARE of their leaf.
B1, B2, EPS = 0.9, 0.95, 1e-8  # optim.adamw.adamw_update's defaults
GRAD_RTOL, LATER_RTOL = 1e-5, 1e-4
MOVED_SHARE = 1e-3
# Each rank's matmul FLOPs over the unsharded step's, at a model axis of
# two: half, plus what every rank repeats (nothing here is repeated but
# the norms, which do no matmul).
FLOP_SHARE = 0.6


def _configs() -> dict:
    glm = get_config("glm4-9b", smoke=True)
    return {
        "internlm2": get_config("internlm2-1.8b", smoke=True),
        # 4 query heads on 1 KV head: the KV heads do not divide the axis.
        "glm4_kv1": dataclasses.replace(glm, n_kv_heads=1),
        # 6 query heads on 3 KV heads: rank 0's heads 0-2 lie on KV heads
        # 0, 0, 1, rank 1's on 1, 2, 2.
        "glm4_h6kv3": dataclasses.replace(glm, n_heads=6, n_kv_heads=3),
        # A vocabulary that does not divide the axis: the embedding, the
        # head and the logits stay whole over ``model``.
        "internlm2_v255": dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                                              vocab_size=255),
        # 64 RG-LRU channels, 4 query heads on 1 KV head, window 16.
        "recurrentgemma": get_config("recurrentgemma-9b", smoke=True),
        # 4 RWKV-6 heads of 16.
        "rwkv6": get_config("rwkv6-7b", smoke=True),
        # 8 experts, top 2, at 1.25: 7 slots an expert in a row of 24
        # tokens, so pairs are dropped (its smoke factor, 8.0, drops none).
        "granite": dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True),
                                       **MOE_CUTS["granite"]),
        # 8 experts, top 2, and a dense SwiGLU residual beside them.
        "arctic": get_config("arctic-480b", smoke=True),
        # 5 experts: at 2 data-parallel ranks they do not divide, so they
        # are placed at P(None, "data", "model") (gathered over ``data``,
        # no exchange), only each expert's hidden split over ``model``.
        "granite_e5": dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True),
                                          n_experts=5),
    }


# What a config of _configs() changes of the reference's smoke config.
MOE_CUTS = {"granite": dict(capacity_factor=1.25)}
# The configs held to the reference's losses and counted for FLOPs: the
# reference's config each stands for.
ARCHS = {"internlm2": "internlm2-1.8b", "recurrentgemma": "recurrentgemma-9b",
         "rwkv6": "rwkv6-7b", "granite": "granite-moe-3b-a800m"}
RECURRENT = ("recurrentgemma", "rwkv6")
MOE = ("granite", "arctic", "granite_e5")
# The configs whose compressed serve step runs on the tp route, and the
# storage format's quantization threshold there (the reference test's: at
# the default, 65,536, every smoke leaf would stay raw).
COMPRESSED = ("internlm2", "glm4_h6kv3", "recurrentgemma", "granite", "arctic")
QUANT_SIZE = 1024


def _seq(cfg) -> int:
    return RECURRENT_SEQ.get(cfg.name, SEQ)


def _batches(cfg, n, seq=None):
    data = SyntheticLM(cfg.vocab_size, seed=3)
    return [{k: torch.from_numpy(v) for k, v in data.batch(i, BATCH, seq or _seq(cfg)).items()}
            for i in range(n)]


def _prompt(cfg):
    return torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                              (BATCH, PROMPT)))


def _full(tree):
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def _make_decode(cfg):
    """A serve step that returns the last position's logits too."""
    @torch.no_grad()
    def step(params, cache, batch, pos):
        logits, cache = decode_step(params, cache, batch, pos, cfg)
        return sh.unsplit(logits[:, -1], 1).to(torch.float32), cache
    return step


def _expert_dims(s) -> list:
    """The dims that spec ``s`` splits over ``data`` as the batch is (an
    expert weight's, which a step on the tp route keeps split)."""
    return [d for d, e in enumerate(s) if isinstance(e, tuple) and "data" in e]


def _step_shards(params, p_spec, shape) -> list:
    """Each weight's shard as a step on the tp route holds it, and its
    spec: split over ``model``, and over ``data`` where it is an expert
    weight's (gathered over ``data`` otherwise)."""
    out = []
    for x, s in zip(tree_leaves(params), tree_leaves(p_spec)):
        local = list(x.shape)
        for d in _expert_dims(s):
            local[d] //= shape[0]
        for d, e in enumerate(s):
            if "model" in sh._axes(e):
                local[d] //= shape[1]
        out.append((local, s))
    return out


def _split_weight_shapes(params, p_spec, shape) -> dict:
    """What an all-gather of a weight's shard (or of a period's slice of
    one) over the ``model`` ranks, where the weight is split over
    ``model``, or over the ``data`` ranks, where it is an expert weight
    split over them, returns: the ranks' shards stacked on dim 0 (DTensor
    gathers a shard of another dim so, then moves the parts), the shapes
    that such a gather must never have: {axis: shapes}."""
    out = {"model": set(), "data": set()}
    for local, s in _step_shards(params, p_spec, shape):
        for axis, n, split in (("model", shape[1], any("model" in sh._axes(e) for e in s)),
                               ("data", shape[0], bool(_expert_dims(s)))):
            if not split:
                continue
            for part in (list(local), list(local[1:])):
                if part:
                    part[0] *= n
                    out[axis].add(tuple(part))
    return out


def _bad_gathers(rec, groups: dict, shapes: dict) -> list:
    """The all-gathers over a group of ``groups`` ({axis: its ranks}) whose
    result has one of ``shapes[axis]``."""
    return [(axis, shape) for kind, shape, group in rec.shapes for axis, ranks in groups.items()
            if kind == "all-gather" and group == ranks and shape in shapes[axis]]


def _expert_shards(params, p_spec, shape) -> set:
    """The shapes of the expert weights' shards (and of a period's slice
    of one) as the step holds them."""
    return {t for local, s in _step_shards(params, p_spec, shape) if _expert_dims(s)
            for t in (tuple(local), tuple(local[1:]))}


@contextlib.contextmanager
def _routes():
    """Inside the block, every routing a MoE layer makes (``MoE._route``,
    on the rows it sees) is noted: its top-k experts (B, S, k) and the
    smallest gap between its k + 1 largest gates a token (B, S), the
    margin a choice has against a rounding of the gates."""
    calls, route = [], layers.MoE._route

    def spy(self, x, router, cap):
        gates = torch.softmax(x.detach().to(torch.float32) @ router.detach(), dim=-1)
        top = torch.topk(gates, self.top_k + 1, dim=-1)
        gaps = top.values[..., :-1] - top.values[..., 1:]
        calls.append((top.indices[..., :-1], gaps.min(dim=-1).values))
        return route(self, x, router, cap)

    layers.MoE._route = spy
    try:
        yield calls
    finally:
        layers.MoE._route = route


def _weights() -> dict:
    return {name: init_params(cfg, 0, device="cpu") for name, cfg in _configs().items()}


def _worker(rank, shape, store_path, out_dir):
    torch.set_num_threads(1)  # six ranks share the machine's cores
    n = shape[0] * shape[1]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        groups = {axis: tuple(dist.get_process_group_ranks(mesh.get_group(axis)))
                  for axis in ("data", "model")}
        out = {}
        weights = _weights()
        for name, cfg in _configs().items():
            res = out[name] = {}
            params = weights[name]
            with sh.use_mesh(mesh) as ctx:
                p_spec = shd.param_specs_tree(params, ctx)
                o_spec = shd.opt_specs_tree(None, p_spec)
                b_spec = shd.batch_specs_tree(_batches(cfg, 1)[0], ctx)
                step = shd.sharded(make_train_step(cfg, 1, lr=LR),
                                   (p_spec, o_spec, shd.per_batch(b_spec)),
                                   (p_spec, o_spec, None), ctx, cfg=cfg)
            split_shapes = _split_weight_shapes(params, p_spec, shape)
            p, o = shd.place(params, p_spec, mesh), shd.place(adamw_init(params), o_spec, mesh)
            rec, losses, states = StepRecorder(), [], []
            for i, b in enumerate(_batches(cfg, TRAIN_STEPS)):
                with rec if i == 0 else contextlib.nullcontext():
                    p, o, m = step(p, o, b)
                losses.append(m["loss"])
                states.append(_full([p, o]))
            res["train"] = {"route": step.route, "losses": losses, "states": states,
                            "bad_gathers": _bad_gathers(rec, groups, split_shapes)}
            if name in MOE:
                experts = _expert_shards(params, p_spec, shape)
                res["train"]["exchanges"] = _exchanges(rec, groups["data"])
                res["train"]["expert_grad_sums"] = [
                    s for kind, s, group in rec.shapes
                    if kind == "all-reduce" and group == groups["data"] and s in experts]
                res["expert_flops"] = _moe_layer_flops(cfg, params, mesh)
            if name in ARCHS and shape == (1, 2):
                b = _batches(cfg, 1)[0]
                with FlopCounterMode(display=False) as flops:
                    step(p, o, b)
                res["flops"] = flops.get_total_flops()
            if name in RECURRENT and shape == (1, 2):
                res["dtensor_ops"] = _forward_dtensor_ops(cfg, p, p_spec, mesh)
            if name == "internlm2" and shape == (1, 2):
                # The check's own control: the same step on the gathered
                # route gathers the split weights over ``model``.
                with sh.use_mesh(mesh) as ctx:
                    g_step = shd.sharded(make_train_step(cfg, 1, lr=LR),
                                         (p_spec, o_spec, shd.per_batch(b_spec)),
                                         (p_spec, o_spec, None), ctx, cfg=cfg, route="gathered")
                rec = StepRecorder()
                with rec:
                    g_step(p, o, b)
                res["gathered_route"] = g_step.route
                res["gathered_bad"] = _bad_gathers(rec, groups, split_shapes)
            for serve_rules in (True, False):
                with sh.use_mesh(mesh, seq_shard=False, serve=serve_rules) as ctx:
                    cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
                    p_spec = shd.param_specs_tree(params, ctx)
                    c_spec = shd.cache_specs_tree(cache, ctx, cfg.n_kv_heads)
                    rows = shd.per_batch(shd.batch_specs_tree({"tokens": _prompt(cfg)}, ctx))
                    prefill = shd.sharded(make_prefill_step(cfg), (p_spec, rows),
                                          (shd.per_batch(None),), ctx, cfg=cfg)
                    serve = shd.sharded(make_serve_step(cfg),
                                        (p_spec, shd.per_batch(c_spec), rows, None),
                                        (shd.per_batch(None), shd.per_batch(c_spec)), ctx,
                                        cfg=cfg)
                    decode = shd.sharded(_make_decode(cfg),
                                         (p_spec, shd.per_batch(c_spec), rows, None),
                                         (shd.per_batch(None), shd.per_batch(c_spec)), ctx,
                                         cfg=cfg)
                split_shapes = _split_weight_shapes(params, p_spec, shape)
                sp = shd.place(params, p_spec, mesh)
                rec, pre_rec = StepRecorder(), StepRecorder()
                with pre_rec, _routes() as routed:
                    logits = prefill(sp, {"tokens": _prompt(cfg)})
                toks, step_logits = [], []
                caches = [shd.place(cache, c_spec, mesh),
                          shd.place(init_cache(cfg, BATCH, CACHE_LEN, device="cpu"), c_spec,
                                    mesh)]
                for t in range(SERVE_STEPS):
                    feed = {"tokens": _prompt(cfg)[:, t:t + 1].to(torch.int32)}
                    with rec if t == 0 else contextlib.nullcontext(), _routes() as step_routed:
                        tok, caches[0] = serve(sp, caches[0], feed, t)
                    routed += step_routed
                    lg, caches[1] = decode(sp, caches[1], feed, t)
                    toks.append(tok)
                    step_logits.append(lg)
                res[f"serve_{serve_rules}"] = {
                    "routes": (prefill.route, serve.route, decode.route),
                    "prefill": logits, "tokens": torch.stack(toks, 1),
                    "logits": torch.stack(step_logits, 1), "cache": _full(caches[0]),
                    "bad_gathers": (_bad_gathers(pre_rec, groups, split_shapes)
                                    + _bad_gathers(rec, groups, split_shapes)),
                    "routed": routed, "exchanges": _exchanges(pre_rec, groups["data"])}
        cs.MIN_QUANT_SIZE = QUANT_SIZE
        for name in COMPRESSED:
            for serve_rules in (True, False):
                out[name][f"compressed_{serve_rules}"] = _compressed_serve(
                    _configs()[name], weights[name], mesh, groups, shape, serve_rules)
        out["crafted"] = _crafted_rebuild(mesh)
        out["place"] = _place_forms(mesh)
        if shape == (1, 2):
            out["recorders"] = _recorders(mesh["model"])
        if shape == (2, 2):
            out["exchange"] = _exchange_probe(mesh)
        out["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _compressed_serve(cfg, params, mesh, groups, shape, serve_rules) -> dict:
    """The compressed serve step over ``params``' storage format (leaves
    of ``QUANT_SIZE`` elements and more quantized) on the tp route,
    SERVE_STEPS tokens under the serving or the train table: its route and
    tokens; the storage format rebuilt by a step on the same route and put
    back where the plain parameters lie, gathered whole, with the
    collectives that the rebuild issued; and the all-gathers over a group,
    in the first serve step, with the shape of a split weight or of a split
    storage-format leaf."""
    qparams = cs.quantized_to_device(cs.quantize_params(params), "cpu")
    rebuild_rec = StepRecorder()

    def rebuild(q, batch):
        with rebuild_rec:
            return (cs.dequantize_params(q, torch.float32),)

    with sh.use_mesh(mesh, seq_shard=False, serve=serve_rules) as ctx:
        cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
        q_spec = shd.compressed_param_specs_tree(qparams, ctx)
        p_spec = shd.param_specs_tree(params, ctx)
        c_spec = shd.cache_specs_tree(cache, ctx, cfg.n_kv_heads)
        rows = shd.per_batch(shd.batch_specs_tree({"tokens": _prompt(cfg)}, ctx))
        serve = shd.sharded(cs.make_compressed_serve_step(cfg),
                            (q_spec, shd.per_batch(c_spec), rows, None),
                            (shd.per_batch(None), shd.per_batch(c_spec)), ctx, cfg=cfg)
        # The batch's rows: experts split over ``data`` need a batch split so.
        rebuilt = shd.sharded(rebuild, (q_spec, rows), (p_spec,), ctx, cfg=cfg)
    split = _split_weight_shapes(params, p_spec, shape)
    for axis, shapes in _split_weight_shapes(qparams, q_spec, shape).items():
        split[axis] |= shapes
    qp = shd.place(qparams, q_spec, mesh)
    cache, rec, toks = shd.place(cache, c_spec, mesh), StepRecorder(), []
    for t in range(SERVE_STEPS):
        feed = {"tokens": _prompt(cfg)[:, t:t + 1].to(torch.int32)}
        with rec if t == 0 else contextlib.nullcontext():
            tok, cache = serve(qp, cache, feed, t)
        toks.append(tok)
    return {"routes": (serve.route, rebuilt.route), "tokens": torch.stack(toks, 1),
            "rebuilt": _full(rebuilt(qp, {"tokens": _prompt(cfg)})[0]),
            "rebuild_collectives": rebuild_rec.shapes,
            "bad_gathers": _bad_gathers(rec, groups, split)}


def _crafted_tree():
    """Four quantized leaves (float32 from a seed) and their base and packed
    specs, one for each way a rank's packed part can lie (the zoo's
    production layouts have no case (c), ``tests/test_torch_shardings.py``):
    ``"c"``, ``d_head`` split with the packed columns split by rows of dim
    1 (case (c): gathered over ``model`` first); ``"expert_whole"``, 4
    experts split over the data ranks and their hidden over ``model``, the
    packed whole (case (b) over both); ``"expert_c"``, 2 experts (one a
    data rank at (2, 2): a rank reads one nibble of each byte) with the
    packed columns split over ``model`` (case (c)); and a stacked leaf
    whose hidden is split, its packed whole (case (b))."""
    gen = torch.Generator().manual_seed(13)
    leaves = {"c": ((4, 4, 6), P(None, None, "model"), P(None, "model")),
              "expert_whole": ((4, 4, 6), P(("data",), None, "model"), P(None, None)),
              "expert_c": ((2, 4, 6), P(("data",), None, "model"), P(None, "model")),
              "periods": ((2, 4, 6), P(None, None, "model"), P(None, None, None))}
    q, base_specs, specs = {}, {}, {}
    for name, (shape, base, packed) in leaves.items():
        q[name] = cs.quantized_to_device(cs.quantize_leaf(torch.randn(shape, generator=gen)),
                                         "cpu")
        base_specs[name] = base
        specs[name] = {"base": base, "packed": packed,
                       **{k: P() for k in ("bs", "bz", "bmid", "ds", "dz")}}
    q["periods"], base_specs["periods"], specs["periods"] = (
        {"w": q["periods"]}, {"w": base_specs["periods"]}, {"w": specs["periods"]})
    return q, base_specs, specs


def _crafted_rebuild(mesh) -> dict:
    """``_crafted_tree``'s leaves rebuilt on the tp route (internlm2's smoke
    config names the route; a batch split over ``data`` lets the experts
    stay split) and put back where their bases lie, gathered whole, with
    the collectives the rebuild issued."""
    q, base_specs, specs = _crafted_tree()
    rec = StepRecorder()

    def rebuild(qt, batch):
        with rec:
            return (cs.dequantize_params(qt, torch.float32),)

    with sh.use_mesh(mesh, seq_shard=False, serve=True) as ctx:
        step = shd.sharded(rebuild, (specs, shd.per_batch(P(("data",)))), (base_specs,), ctx,
                           cfg=_configs()["internlm2"])
    got = step(shd.place(q, specs, mesh), torch.zeros(BATCH, dtype=torch.int32))[0]
    return {"route": step.route, "rebuilt": _full(got), "collectives": rec.shapes}


def _place_forms(mesh) -> list:
    """(spec, shape, whether ``shd.place`` gives the DTensor that
    ``distribute_tensor`` gives: placements, shape, stride and each rank's
    local tensor with its strides) for each spec form the trees use: a dim
    over an axis, over a tuple of one axis (the batch's) and of two,
    whole, a transposed view, a 0-d scalar and an entry past its dims."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    scalar = torch.tensor(3.5)
    forms = [(x, P("data", "model", None)), (x, P(None, "model")),
             (x, P(("data",), None, "model")), (x[:, :, 0], P(("data", "model"), None)),
             (x, P()), (x[:, :, 0].t(), P("model", None)), (scalar, P()), (scalar, P(None))]
    out = []
    for t, spec in forms:
        got = shd.place(t, spec, mesh)
        want = distribute_tensor(t, mesh, sh.placements(spec, mesh, t.ndim), src_data_rank=None)
        same = (tuple(got.placements) == tuple(want.placements) and got.shape == want.shape
                and got.stride() == want.stride()
                and got.to_local().stride() == want.to_local().stride()
                and torch.equal(got.to_local(), want.to_local()))
        out.append((tuple(spec), tuple(t.shape), same))
    return out


def _exchanges(rec, data_ranks) -> list:
    """The all-to-alls ``rec`` saw, each (result shape, over the ``data``
    group)."""
    return [(shape, group == data_ranks) for kind, shape, group in rec.shapes
            if kind == "all-to-all"]


def _moe_layer_flops(cfg, params, mesh=None) -> int:
    """The FLOPs of the batched products (``aten.bmm``) of one MoE layer's
    forward and backward on a (BATCH, SEQ) residual: its expert products
    (the router's and the dense residual's products are not batched). On
    ``mesh``, each rank's own (``LocalFlopCounter``, the step on the tp
    route, its rows of the residual); else the unsharded layer's."""
    from repro_torch.launch.hlo_stats import LocalFlopCounter

    blk = tf._mix_block(cfg, cfg.mix[0])
    p = tf._index(params["periods"]["slot0"]["mix"], 0)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(BATCH, SEQ, cfg.d_model, generator=gen)

    def step(p, x):
        diff = tree_map(lambda t: t.detach().requires_grad_(True), p)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = blk.forward(diff, x)
            torch.autograd.grad(sh.unsplit(y.sum()), tree_leaves(diff) + [x])
        return ()

    if mesh is None:
        counter, run = FlopCounterMode(display=False), lambda: step(p, x)
    else:
        with sh.use_mesh(mesh) as ctx:
            p_spec = shd.param_specs_tree(p, ctx)
            split = shd.sharded(step, (p_spec, shd.per_batch(ctx.spec("residual"))), (), ctx,
                                cfg=cfg)
        placed = shd.place(p, p_spec, mesh)
        counter, run = LocalFlopCounter(display=False), lambda: split(placed, x)
    with counter:
        run()
    return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}["aten.bmm"]


def _exchange_probe(mesh) -> dict:
    """``sh.expert_exchange`` over the ``data`` ranks of ``mesh`` of a (2,
    4, 3, 5) dispatch (B, E, C, D) whose entries are coded by the data
    rank, as a DTensor replicated over ``model``, and back: what this
    rank received and got back, and for a product of the received slots
    with this rank's experts' weight (E/2, C, D) (coded the same way), the
    gradients of the dispatch and of the weight."""
    from torch.distributed.tensor import Replicate

    d = mesh.get_local_rank("data")
    sub = mesh["model"]
    x = (torch.arange(2 * 4 * 3 * 5, dtype=torch.float32).reshape(2, 4, 3, 5)
         + 1000 * d).requires_grad_(True)
    w = (torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
         + 100 * d).requires_grad_(True)
    with sh.tensor_parallel(sub), sh.expert_parallel(mesh["data"]):
        xd = DTensor.from_local(x, sub, [Replicate()], run_check=False)
        wd = DTensor.from_local(w, sub, [Replicate()], run_check=False)
        got = sh.expert_exchange(xd, 1, 0)
        back = sh.expert_exchange(got, 0, 1)
        (got * wd).sum().backward()
    return {"input": x.detach(), "weight": w.detach(), "got": got.to_local().detach(),
            "back": back.to_local().detach(), "x_grad": x.grad, "w_grad": w.grad}


def _forward_dtensor_ops(cfg, params, p_spec, mesh) -> dict:
    """{sequence length: the DTensor ops a sharded prefill (a forward)
    dispatches} at each of ``OP_COUNT_SEQS``, under the train table."""
    out = {}
    for seq in OP_COUNT_SEQS:
        tokens = _batches(cfg, 1, seq)[0]["tokens"]
        with sh.use_mesh(mesh) as ctx:
            rows = shd.per_batch(shd.batch_specs_tree({"tokens": tokens}, ctx))
            prefill = shd.sharded(make_prefill_step(cfg), (p_spec, rows),
                                  (shd.per_batch(None),), ctx, cfg=cfg)
        rec = StepRecorder()
        with rec:
            prefill(params, {"tokens": tokens})
        out[seq] = sum(rec.dtensor_ops.values())
    return out


def _recorders(sub) -> dict:
    """What the recorders see of DTensor ops over ``sub`` (two ranks): the
    all-reduce that DTensor makes inside ``exp`` of a partial sum, and an
    (8, 4) @ (4, 4) product split over its rows, counted on each rank's
    (4, 4) rows by ``LocalFlopCounter`` and at its global shape by
    ``FlopCounterMode``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch.hlo_stats import LocalFlopCounter

    partial = DTensor.from_local(torch.ones(4), sub, [Partial()], run_check=False)
    rec = StepRecorder()
    with rec:
        torch.exp(partial)
    x = DTensor.from_local(torch.ones(4, 4), sub, [Shard(0)], run_check=False)
    w = DTensor.from_local(torch.ones(4, 4), sub, [Replicate()], run_check=False)
    with LocalFlopCounter(display=False) as local:
        x @ w
    with FlopCounterMode(display=False) as whole:
        x @ w
    return {"shapes": rec.shapes, "local": local.get_total_flops(),
            "whole": whole.get_total_flops()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh shape's ranks, all spawned at once: {shape: [each
    rank's results]} and the weights they started from."""
    root = tmp_path_factory.mktemp("tp")
    ctx = mp.get_context("spawn")
    procs = {}
    for shape in MESH_SHAPES:
        d = root / f"{shape[0]}x{shape[1]}"
        d.mkdir()
        procs[shape] = [ctx.Process(target=_worker, args=(r, shape, str(d / "store"), str(d)))
                        for r in range(shape[0] * shape[1])]
    every = [p for ps in procs.values() for p in ps]
    for p in every:
        p.start()
    for p in every:
        p.join(JOIN_TIMEOUT_S)
    alive = [p.pid for p in every if p.is_alive()]
    for p in every:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"workers {alive} still running after {JOIN_TIMEOUT_S} s"
    out = {"weights": _weights()}
    for shape, ps in procs.items():
        assert [p.exitcode for p in ps] == [0] * len(ps), shape
        d = root / f"{shape[0]}x{shape[1]}"
        out[shape] = [torch.load(d / f"r{r}.pt", weights_only=False) for r in range(len(ps))]
    return out


CASES = [(shape, name) for shape in MESH_SHAPES for name in _configs()]


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else float(a.norm())


def _direction(m, v, t: int):
    """AdamW's update direction m̂ / (√v̂ + eps) after step ``t``."""
    return (m / (1 - B1 ** t)) / ((v / (1 - B2 ** t)).clamp_min(0).sqrt() + EPS)


def adam_state_gaps(got: list, want: list, lr: float, tol: dict,
                    first_rtol: float = GRAD_RTOL) -> tuple[list, list]:
    """A train run's [params, AdamW state] after each of its steps
    (``got``: trees of whole tensors) against the unsharded run's
    (``want``), by the rule above GRAD_RTOL (the first step's moments
    within ``first_rtol``): (a line for each fault, a line a leaf of what
    was seen). Each leaf of ``got`` is moved to ``want``'s device in
    turn."""
    assert len(got) == len(want)
    bad, seen = [], []
    moments = [[[tree_leaves(opt[k]) for k in ("m", "v")] for _, opt in run]
               for run in (got, want)]
    finals = [tree_leaves(run[-1][0]) for run in (got, want)]
    for i, (a, b) in enumerate(zip(*finals, strict=True)):
        drift, worst = 0.0, [0.0, 0.0]  # Σ_t |û_t - u_t|; m's and v's largest errors
        for t in range(1, len(want) + 1):
            (gm, gv), (wm, wv) = ([x[i].to(b.device).double() for x in run[t - 1]]
                                  for run in moments)
            m_rtol = first_rtol if t == 1 else LATER_RTOL
            for k, (x, y, rtol) in enumerate(((gm, wm, m_rtol), (gv, wv, 2 * m_rtol))):
                err = _rel_l2(x, y)
                worst[k] = max(worst[k], err)
                over = int(((x - y).abs() > tol["atol"] + tol["rtol"] * y.abs()).sum())
                if err > rtol or over:
                    bad.append(f"step {t} leaf {i} {'mv'[k]}: relative L2 error {err:.3e} "
                               f"(at most {rtol:.0e}), {over} elements past {tol}")
            drift = drift + (_direction(gm, gv, t) - _direction(wm, wv, t)).abs()
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"leaf {i}: {a.dtype} {tuple(a.shape)} against {b.dtype} {tuple(b.shape)}")
            continue
        a, b = a.to(b.device).double(), b.double()
        gap, plain = (a - b).abs(), tol["atol"] + tol["rtol"] * b.abs()
        moved = int((gap > plain).sum())
        past = int((gap > plain + lr * drift * (1 + 1e-6)).sum())
        seen.append(f"leaf {i} {tuple(a.shape)}: m, v relative L2 {worst[0]:.2e}, "
                    f"{worst[1]:.2e}; {moved} of {a.numel()} weights past {tol} within their "
                    f"moments' term")
        if past:
            bad.append(f"leaf {i}: {past} weights past {tol} plus their moments' term, max "
                       f"|diff| {float(gap.max()):.3e}")
        if moved > MOVED_SHARE * a.numel():
            bad.append(f"leaf {i}: {moved} of {a.numel()} weights lean on their moments' term "
                       f"(at most {MOVED_SHARE} of them)")
    return bad, seen


@pytest.mark.parametrize("shape,name", CASES)
def test_train_step_is_the_unsharded_step(ranks, shape, name):
    """Two train steps split over ``model``: every rank the same state;
    the losses within ``DP4_TOL`` of the unsharded step with a microbatch a
    data-parallel rank, and the gradients, moments and weights after each
    step held to it by ``adam_state_gaps`` at ``DP4_TOL``."""
    cfg = _configs()[name]
    plain = make_train_step(cfg, shape[0], lr=LR)
    params = ranks["weights"][name]
    opt = adamw_init(params)
    losses, want = [], []
    for b in _batches(cfg, TRAIN_STEPS):
        params, opt, m = plain(params, opt, b)
        losses.append(m["loss"])
        want.append([params, opt])
    got = [r[name]["train"] for r in ranks[shape]]
    for r in got:
        assert r["route"] == "tp"
        assert [float(x) for x in r["losses"]] == [float(x) for x in got[0]["losses"]]
        for a, b in zip(tree_leaves(r["states"]), tree_leaves(got[0]["states"]), strict=True):
            assert torch.equal(a, b)
    np.testing.assert_allclose(torch.stack(got[0]["losses"]).numpy(),
                               torch.stack(losses).numpy(), **DP4_TOL)
    bad, seen = adam_state_gaps(got[0]["states"], want, LR, DP4_TOL)
    print("\n".join(seen))
    assert not bad, bad


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_train_losses_are_the_references(ranks, shape):
    """internlm2's, recurrentgemma's and rwkv6's losses split over
    ``model`` within ``LOSS_RTOL`` of the reference's unsharded step (JAX,
    a microbatch a data-parallel rank) on the same weights and batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as r_get_config
    from repro.launch.steps import make_train_step as r_make_train_step
    from repro.optim import adamw_init as r_adamw_init

    for name, arch in ARCHS.items():
        r_cfg = dataclasses.replace(r_get_config(arch, smoke=True), **MOE_CUTS.get(name, {}))
        r_step = jax.jit(r_make_train_step(r_cfg, shape[0], lr=LR))
        p = tree_map(lambda x: x.numpy(), ranks["weights"][name])
        o = r_adamw_init(p)
        got = ranks[shape][0][name]["train"]["losses"]
        for b, loss in zip(_batches(_configs()[name], TRAIN_STEPS), got, strict=True):
            p, o, m = r_step(p, o, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=LOSS_RTOL,
                                       err_msg=name)


def _route_flips(got: list, want: list, rows: slice) -> list[str]:
    """A line for each token of a sharded rank's routings (``got``, one
    entry a MoE layer call, on its rows) whose top-k experts differ from
    the unsharded routings' (``want``, on every row; ``rows`` the rank's),
    with the unsharded gates' smallest top-k margin there."""
    out = []
    for call, ((g_e, _), (w_e, w_gap)) in enumerate(zip(got, want, strict=True)):
        w_e, w_gap = w_e[rows], w_gap[rows]
        for b, s in (g_e != w_e).any(dim=-1).nonzero().tolist():
            out.append(f"call {call} row {b} token {s}: experts {g_e[b, s].tolist()} against "
                       f"{w_e[b, s].tolist()}, top-k margin {float(w_gap[b, s]):.3e}")
    return out


@pytest.mark.parametrize("serve_rules", [True, False])
@pytest.mark.parametrize("shape,name", CASES)
def test_prefill_and_serve_are_the_unsharded_steps(ranks, shape, name, serve_rules):
    """The prefill's logits, each serve step's logits within
    ``LOGITS_TOL`` of the unsharded steps', the greedy tokens equal, and
    the final cache within ``DP4_TOL``, under the serving table (``d_head``
    split) and the train table. Where a MoE model's sharded prefill or
    serve step routes a token otherwise, the top-k margin is printed."""
    cfg = _configs()[name]
    params = ranks["weights"][name]
    with _routes() as routed:
        want_prefill = make_prefill_step(cfg)(params, {"tokens": _prompt(cfg)})
    cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    l_cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    serve = make_serve_step(cfg)
    toks, logits = [], []
    for t in range(SERVE_STEPS):
        feed = {"tokens": _prompt(cfg)[:, t:t + 1].to(torch.int32)}
        with _routes() as step_routed:
            tok, cache = serve(params, cache, feed, t)
        routed += step_routed
        with torch.no_grad():
            lg, l_cache = decode_step(params, l_cache, feed, t, cfg)
        toks.append(tok)
        logits.append(lg[:, -1].to(torch.float32))
    for r in ranks[shape]:
        d = r["coords"][0]
        rows = slice(d * BATCH // shape[0], (d + 1) * BATCH // shape[0])
        flips = _route_flips(r[name][f"serve_{serve_rules}"]["routed"], routed, rows)
        if flips:
            print(f"{name} {shape} rank coordinates {r['coords']}: routed otherwise than "
                  "unsharded at\n" + "\n".join(flips))
    for r in ranks[shape]:
        got = r[name][f"serve_{serve_rules}"]
        assert got["routes"] == ("tp", "tp", "tp")
        np.testing.assert_allclose(got["prefill"].numpy(), want_prefill.numpy(), **LOGITS_TOL)
        np.testing.assert_allclose(got["logits"].numpy(), torch.stack(logits, 1).numpy(),
                                   **LOGITS_TOL)
        assert torch.equal(got["tokens"], torch.stack(toks, 1))
        for a, b in zip(tree_leaves(got["cache"]), tree_leaves(cache), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **DP4_TOL)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_no_split_weight_is_gathered_over_model(ranks, shape):
    """No all-gather over the ``model`` group, in a train, prefill or
    serve step of any config under either table, has the shape of a weight
    split over ``model``; the control (the gathered route) has them."""
    for r in ranks[shape]:
        for name in _configs():
            assert r[name]["train"]["bad_gathers"] == [], name
            for serve_rules in (True, False):
                assert r[name][f"serve_{serve_rules}"]["bad_gathers"] == [], (name, serve_rules)
    if shape == (1, 2):
        control = ranks[shape][0]["internlm2"]
        assert control["gathered_route"] == "gathered"
        assert len(control["gathered_bad"]) > 0


def test_each_rank_does_its_share_of_the_matmuls(ranks):
    """At (1, 2) each rank's matmul FLOPs in a train step of internlm2,
    recurrentgemma, rwkv6 and granite are at most ``FLOP_SHARE`` of the
    unsharded step's on the same batch: the projections, the RG-LRU gates,
    the RWKV-6 chunk products and the expert products split too (what
    every rank repeats: RWKV-6's decay LoRA down-projection, the router).
    At (1, 2) and (2, 2) a rank does exactly 1/(d·m) of a MoE layer's
    expert products, forward and backward: its rows' share over d
    data-parallel ranks (the exchange brings every rank's rows to its
    experts, E/d of them, or each rank keeps its rows and every expert
    where they do not divide), its hidden columns' over m."""
    for name in ARCHS:
        cfg = _configs()[name]
        params = ranks["weights"][name]
        plain = make_train_step(cfg, 1, lr=LR)
        with FlopCounterMode(display=False) as flops:
            plain(params, adamw_init(params), _batches(cfg, 1)[0])
        whole = flops.get_total_flops()
        for r in ranks[(1, 2)]:
            assert 0 < r[name]["flops"] <= FLOP_SHARE * whole, (name, r[name]["flops"], whole)
    for name in MOE:
        whole = _moe_layer_flops(_configs()[name], ranks["weights"][name])
        for shape in MESH_SHAPES:
            for r in ranks[shape]:
                got = r[name]["expert_flops"]
                assert 0 < got and got * shape[0] * shape[1] == whole, (name, shape, got, whole)


def test_each_rank_receives_its_experts_rows(ranks):
    """``sh.expert_exchange`` at (2, 2), on a dispatch (B, E, C, D) coded
    by the data rank, a DTensor replicated over ``model``: data rank j
    receives experts [j·E/2, (j+1)·E/2)'s slots of every data rank's rows,
    rank 0's rows first, and the way back returns each rank its own
    dispatch. In the backward of a product of the slots received with
    this rank's experts' weight, that weight's gradient is the sum of
    every data rank's rows, and each rank's dispatch gets its own rows'
    gradients back from the ranks of its experts."""
    probes = [(r["coords"], r["exchange"]) for r in ranks[(2, 2)]]
    inputs = {c[0]: e["input"] for c, e in probes}
    weights = {c[0]: e["weight"] for c, e in probes}
    half = 2
    for (d, _), e in probes:
        mine = torch.cat([inputs[j][:, d * half:(d + 1) * half] for j in (0, 1)])
        assert torch.equal(e["got"], mine)
        assert torch.equal(e["back"], inputs[d])
        assert torch.equal(e["w_grad"], mine.sum(dim=0))
        home = torch.cat([weights[j].expand(2, half, 3, 5) for j in (0, 1)], dim=1)
        assert torch.equal(e["x_grad"], home)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_tokens_cross_the_data_axes_by_an_all_to_all(ranks, shape):
    """In a MoE model's sharded prefill the recorder sees one all-to-all
    each way a layer, over the ``data`` group, of this rank's experts'
    slots of every data rank's rows (none where the experts do not divide
    over ``data``); in the train step also one each way in the backward
    and in remat's recompute. No all-reduce over the ``data`` group in the
    train step has the shape of an expert weight's shard: an expert's
    gradient already sums every rank's rows, and a sum over the data ranks
    would add different experts together."""
    for r in ranks[shape]:
        for name in MOE:
            cfg = _configs()[name]
            split = cfg.n_experts % shape[0] == 0
            per_layer = 2 if split else 0
            cap = layers.MoE(cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.capacity_factor).capacity
            for serve_rules in (True, False):
                seen = r[name][f"serve_{serve_rules}"]["exchanges"]
                # What the all-to-all returns: a chunk from each data rank.
                slots = (shape[0], BATCH // shape[0], cfg.n_experts // shape[0], cap(PROMPT),
                         cfg.d_model)
                assert seen == [(slots, True)] * per_layer * cfg.n_layers, (name, seen)
            train = r[name]["train"]
            passes = 3 if cfg.remat else 2
            assert len(train["exchanges"]) == per_layer * passes * cfg.n_layers, name
            assert all(over_data for _, over_data in train["exchanges"]), name
            assert train["expert_grad_sums"] == [], (name, train["expert_grad_sums"])


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_dtensor_ops_do_not_grow_with_the_sequence(ranks, name):
    """A recurrent model's sharded forward at (1, 2) dispatches as many
    DTensor ops at 128 tokens as at 64: RWKV-6's chunk loop (4 chunks
    against 2) and the RG-LRU scan's passes (7 against 6) run on local
    tensors behind their seams."""
    for r in ranks[(1, 2)]:
        counts = r[name]["dtensor_ops"]
        assert counts[OP_COUNT_SEQS[0]] > 0
        assert counts[OP_COUNT_SEQS[1]] == counts[OP_COUNT_SEQS[0]], counts


@pytest.fixture
def small_quant(monkeypatch):
    """The workers' quantization threshold, in the test process."""
    monkeypatch.setattr(cs, "MIN_QUANT_SIZE", QUANT_SIZE)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


COMPRESSED_CASES = [(shape, name) for shape in MESH_SHAPES for name in COMPRESSED]


@pytest.mark.parametrize("serve_rules", [True, False])
@pytest.mark.parametrize("shape,name", COMPRESSED_CASES)
def test_compressed_serve_step_is_the_unsharded_compressed_step(ranks, small_quant, shape, name,
                                                               serve_rules):
    """The compressed serve step on the tp route under the serving and the
    train table: its greedy tokens equal the unsharded compressed step's;
    every leaf that a step on the route rebuilds from its ranks' parts of
    the storage format, put back where the plain weight lies and gathered,
    bit-identical to ``dequantize_leaf`` of the whole leaf; no collective
    in the rebuild (no leaf of these layouts is case (c),
    ``cs.rebuild_cases``); and no all-gather over a group, in a serve step,
    with the shape of a split weight or a split storage-format leaf."""
    cfg = _configs()[name]
    qparams = cs.quantized_to_device(cs.quantize_params(ranks["weights"][name]), "cpu")
    step = cs.make_compressed_serve_step(cfg)
    cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    toks = []
    for t in range(SERVE_STEPS):
        tok, cache = step(qparams, cache, {"tokens": _prompt(cfg)[:, t:t + 1].to(torch.int32)}, t)
        toks.append(tok)
    whole = tree_leaves(cs.dequantize_params(qparams, torch.float32))
    with sh.use_mesh(_StandIn(shape, ("data", "model")), seq_shard=False,
                     serve=serve_rules) as ctx:
        cases = cs.rebuild_cases(cs.compressed_param_specs(cfg), ctx)
    assert cases and "c" not in cases.values(), cases
    for r in ranks[shape]:
        got = r[name][f"compressed_{serve_rules}"]
        assert got["routes"] == ("tp", "tp")
        assert torch.equal(got["tokens"], torch.stack(toks, 1))
        rebuilt = tree_leaves(got["rebuilt"])
        assert len(rebuilt) == len(whole)
        for a, b in zip(rebuilt, whole):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        assert got["rebuild_collectives"] == []
        assert got["bad_gathers"] == []


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_each_rebuild_case_gives_the_whole_leafs_bits(ranks, shape):
    """``_crafted_tree``'s leaves rebuilt on the tp route, each rank from
    its own parts (the experts' rank taken into account where the packed
    delta is whole over ``data``), gathered: bit-identical to
    ``dequantize_leaf`` of the whole leaf. The rebuild's one collective a
    case-(c) leaf: an all-gather of its packed part over the ``model``
    group; nothing else."""
    q, _, _ = _crafted_tree()
    want = tree_leaves(cs.dequantize_params(q, torch.float32))
    for r in ranks[shape]:
        got = r["crafted"]
        assert got["route"] == "tp"
        for a, b in zip(tree_leaves(got["rebuilt"]), want, strict=True):
            assert torch.equal(_bits(a), _bits(b))
        model = tuple(sorted(c for c in range(shape[0] * shape[1])
                             if c // shape[1] == r["coords"][0]))
        assert [(kind, group) for kind, _, group in got["collectives"]] == \
            [("all-gather", model)] * 2, got["collectives"]


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_place_gives_distribute_tensors_dtensor(ranks, shape):
    """``shd.place``, which slices each rank's part of a host tensor before
    it moves it, gives every rank the DTensor ``distribute_tensor`` gives
    for every spec form in use (``_place_forms``)."""
    for r in ranks[shape]:
        assert all(same for *_, same in r["place"]), r["place"]


class _StandIn:
    """A mesh's axes and shape without its ranks (the production mesh)."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


# The configs that keep the gathered route under the "tp" tables: none, now
# that the routed experts split too.
GATHERED_ARCHS: set = set()


@pytest.mark.parametrize("arch", list_archs())
def test_each_config_takes_its_route(arch):
    """Every config of the zoo (dense, recurrent and MoE models) splits
    over a ``model`` axis of more than one rank under the ``"tp"`` tables;
    the ``"dp"`` table, a step with no config and a ``model`` axis of one
    rank keep the gathered route. Asked for, ``"tp"`` is taken at one rank
    too, and refused where the default would not split but for the axis'
    size."""
    cfg = get_config(arch)
    want = "gathered" if arch in GATHERED_ARCHS else "tp"
    for serve in (False, True):
        with sh.use_mesh(_StandIn((16, 16), ("data", "model")), serve=serve) as ctx:
            assert shd.compute_route(ctx, cfg) == want
            assert shd.compute_route(ctx, None) == "gathered"
            assert shd.compute_route(ctx, cfg, "gathered") == "gathered"
        with sh.use_mesh(_StandIn((16, 1), ("data", "model")), serve=serve) as ctx:
            assert shd.compute_route(ctx, cfg) == "gathered"
            if want == "tp":
                assert shd.compute_route(ctx, cfg, "tp") == "tp"
            else:
                with pytest.raises(ValueError):
                    shd.compute_route(ctx, cfg, "tp")
    with sh.use_mesh(_StandIn((16, 16), ("data", "model")), profile="dp") as ctx:
        assert shd.compute_route(ctx, cfg) == "gathered"
        with pytest.raises(ValueError):
            shd.compute_route(ctx, cfg, "tp")


def test_recurrent_widths_that_do_not_divide_model_are_refused():
    """The tp route of a config whose RG-LRU channels or RWKV-6 heads do
    not divide the ``model`` axis raises (its scans are not quietly
    gathered); the gathered route stays open."""
    cases = {"recurrentgemma-9b": dataclasses.replace(get_config("recurrentgemma-9b"),
                                                      d_rnn=4095),
             "rwkv6-7b": dataclasses.replace(get_config("rwkv6-7b"), d_model=4032)}
    for arch, cfg in cases.items():
        with sh.use_mesh(_StandIn((16, 16), ("data", "model"))) as ctx:
            with pytest.raises(ValueError, match="do not divide"):
                shd.compute_route(ctx, cfg)
            assert shd.compute_route(ctx, cfg, "gathered") == "gathered", arch


def test_expert_widths_that_do_not_divide_model_are_refused():
    """The tp route of a MoE config whose expert hidden (``d_ff``) does
    not divide the ``model`` axis raises (its experts are not computed
    whole on every rank); the gathered route stays open."""
    for arch in ("granite-moe-3b-a800m", "arctic-480b"):
        cfg = dataclasses.replace(get_config(arch), d_ff=500)
        with sh.use_mesh(_StandIn((16, 16), ("data", "model"))) as ctx:
            with pytest.raises(ValueError, match="do not divide"):
                shd.compute_route(ctx, cfg)
            assert shd.compute_route(ctx, cfg, "gathered") == "gathered", arch


# The gathered route's dry run of internlm2-1.8b × decode_32k, single pod,
# "tp" rules (each rank gathering every weight and running the whole
# model on its rows): its useful-FLOP ratio and its all-gather bytes a
# device a step, from this dry run before the route was split.
GATHERED_DECODE_RATIO, GATHERED_DECODE_ALL_GATHER = 0.024, 27.70e9


def _dryrun_decode_cells(archs) -> list[dict]:
    """The dry run's decode_32k records of ``archs`` (single pod, "tp"
    rules), in a process of its own: it takes the default group."""
    code = ("import json, sys; from repro_torch.launch import dryrun; print(json.dumps(["
            "dryrun.run_cell(a, 'decode_32k', False, verbose=False) for a in sys.argv[1:]]))")
    repo = Path(__file__).resolve().parents[1]
    env = {"PYTHONPATH": str(repo / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    proc = subprocess.run([sys.executable, "-c", code, *archs], env=env, cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dryrun_decode_cell_on_the_tp_route():
    """The dry run of internlm2-1.8b × decode_32k and granite's: the dense
    cell on the ``"tp"`` route with at least 4x the gathered route's
    useful-FLOP ratio and less all-gather; granite's on the ``"tp"`` route
    too."""
    dense, moe = _dryrun_decode_cells(("internlm2-1.8b", "granite-moe-3b-a800m"))
    assert dense["route"] == "tp" and moe["route"] == "tp"
    assert dense["useful_flops_ratio"] >= 4 * GATHERED_DECODE_RATIO
    assert dense["collectives"]["all-gather"] < GATHERED_DECODE_ALL_GATHER


# The same for the recurrent models, from the dry run before their blocks
# were split (each rank gathering every weight and scanning every channel
# and head): (useful-FLOP ratio, all-gather bytes a device a step).
GATHERED_RECURRENT_DECODE = {"recurrentgemma-9b": (0.068, 19.78e9),
                             "rwkv6-7b": (0.065, 14.36e9)}


def test_dryrun_recurrent_decode_cells_on_the_tp_route():
    """The dry run of recurrentgemma-9b and rwkv6-7b × decode_32k: on the
    ``"tp"`` route, each with a higher useful-FLOP ratio and less
    all-gather than its gathered route's."""
    cells = _dryrun_decode_cells(tuple(GATHERED_RECURRENT_DECODE))
    for rec, (ratio, gathered) in zip(cells, GATHERED_RECURRENT_DECODE.values(), strict=True):
        assert rec["route"] == "tp", rec["arch"]
        assert rec["useful_flops_ratio"] > ratio, rec["arch"]
        assert rec["collectives"]["all-gather"] < gathered, rec["arch"]


# The same for the MoE models, from the dry run before their experts were
# split (every rank gathering every expert whole over both axes).
GATHERED_MOE_DECODE = {"granite-moe-3b-a800m": (0.0022, 22.78e9),
                       "arctic-480b": (0.0010, 984.18e9)}


def test_dryrun_moe_decode_cells_on_the_tp_route():
    """The dry run of granite-moe-3b-a800m and arctic-480b × decode_32k:
    on the ``"tp"`` route, each with a higher useful-FLOP ratio and less
    all-gather than its gathered route's; arctic's 128 experts divide over
    ``data`` (16), so its tokens travel to them by an all-to-all (granite's
    40 do not: they are gathered over ``data``, and only each expert's
    hidden is split)."""
    cells = _dryrun_decode_cells(tuple(GATHERED_MOE_DECODE))
    for rec, (ratio, gathered) in zip(cells, GATHERED_MOE_DECODE.values(), strict=True):
        assert rec["route"] == "tp", rec["arch"]
        assert rec["useful_flops_ratio"] > ratio, rec["arch"]
        assert rec["collectives"]["all-gather"] < gathered, rec["arch"]
    assert cells[1]["collectives"]["all-to-all"] > 0


def test_recorders_see_each_ranks_local_ops(ranks):
    """``StepRecorder`` records the all-reduce DTensor makes inside an op
    (over the ``model`` group's ranks); ``LocalFlopCounter`` counts a
    rank's local product (2 · 4 · 4 · 4), ``FlopCounterMode`` the global
    one (2 · 8 · 4 · 4)."""
    for r in ranks[(1, 2)]:
        got = r["recorders"]
        assert [(kind, shape) for kind, shape, _ in got["shapes"]] == [("all-reduce", (4,))]
        assert got["shapes"][0][2] == (0, 1)
        assert (got["local"], got["whole"]) == (128, 256)
