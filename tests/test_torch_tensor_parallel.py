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
* six configs: internlm2-1.8b's smoke size and the same with a
  vocabulary that does not divide the axis, a glm4-like one with fewer KV
  heads than ``model`` ranks (each rank's query heads on one KV head), one
  whose ranks' query heads straddle their KV heads, and recurrentgemma-9b's
  and rwkv6-7b's smoke sizes (trained at ``RECURRENT_SEQ``'s lengths);
* no all-gather over the ``model`` group inside a step has the shape of a
  weight split over ``model`` (read from the recorded collectives, which
  do show such gathers on the gathered route);
* each rank's matmul FLOPs (``FlopCounterMode``) in a train step at (1, 2)
  are at most ``FLOP_SHARE`` of the unsharded step's, for internlm2 and
  the two recurrent models;
* the DTensor ops a recurrent model's forward dispatches do not grow with
  the sequence (the RWKV-6 chunk loop and the RG-LRU scan's passes run on
  local tensors behind their seams);
* the route each config takes (``compute_route``: the MoE models keep the
  gathered one), and the dry run of internlm2-1.8b, recurrentgemma-9b and
  rwkv6-7b × decode_32k on the route: their useful-FLOP ratios and
  all-gather bytes against the gathered route's.
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
from repro_torch.launch import shardings as shd
from repro_torch.launch.hlo_stats import StepRecorder
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import decode_step, init_cache, init_params
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
    }


# The configs held to the reference's losses and counted for FLOPs: the
# reference's config each stands for.
ARCHS = {"internlm2": "internlm2-1.8b", "recurrentgemma": "recurrentgemma-9b",
         "rwkv6": "rwkv6-7b"}
RECURRENT = ("recurrentgemma", "rwkv6")


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


def _split_weight_shapes(params, p_spec, m: int) -> set:
    """What an all-gather over ``model`` of a weight split over it (or of
    a period's slice of one) returns: the ranks' shards stacked on dim 0
    (DTensor gathers a shard of another dim so, then moves the parts), the
    shape that such a gather must never have."""
    out = set()
    for x, s in zip(tree_leaves(params), tree_leaves(p_spec)):
        dims = [d for d, e in enumerate(s) if "model" in sh._axes(e)]
        if not dims:
            continue
        for shape, d in ((list(x.shape), dims[0]), (list(x.shape[1:]), dims[0] - 1)):
            if d < 0:
                continue
            shape[d] //= m
            shape[0] *= m
            out.add(tuple(shape))
    return out


def _model_gathers(rec, ranks) -> list:
    return [shape for kind, shape, group in rec.shapes if kind == "all-gather" and group == ranks]


def _weights() -> dict:
    return {name: init_params(cfg, 0, device="cpu") for name, cfg in _configs().items()}


def _worker(rank, shape, store_path, out_dir):
    torch.set_num_threads(1)  # six ranks share the machine's cores
    n = shape[0] * shape[1]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        model_ranks = tuple(dist.get_process_group_ranks(mesh.get_group("model")))
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
            split_shapes = _split_weight_shapes(params, p_spec, shape[1])
            p, o = shd.place(params, p_spec, mesh), shd.place(adamw_init(params), o_spec, mesh)
            rec, losses, states = StepRecorder(), [], []
            for i, b in enumerate(_batches(cfg, TRAIN_STEPS)):
                with rec if i == 0 else contextlib.nullcontext():
                    p, o, m = step(p, o, b)
                losses.append(m["loss"])
                states.append(_full([p, o]))
            res["train"] = {"route": step.route, "losses": losses, "states": states,
                            "bad_gathers": [g for g in _model_gathers(rec, model_ranks)
                                            if g in split_shapes]}
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
                res["gathered_bad"] = [g for g in _model_gathers(rec, model_ranks)
                                       if g in split_shapes]
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
                split_shapes = _split_weight_shapes(params, p_spec, shape[1])
                sp = shd.place(params, p_spec, mesh)
                rec = StepRecorder()
                with rec:
                    logits = prefill(sp, {"tokens": _prompt(cfg)})
                toks, step_logits = [], []
                caches = [shd.place(cache, c_spec, mesh),
                          shd.place(init_cache(cfg, BATCH, CACHE_LEN, device="cpu"), c_spec,
                                    mesh)]
                for t in range(SERVE_STEPS):
                    feed = {"tokens": _prompt(cfg)[:, t:t + 1].to(torch.int32)}
                    with rec if t == 0 else contextlib.nullcontext():
                        tok, caches[0] = serve(sp, caches[0], feed, t)
                    lg, caches[1] = decode(sp, caches[1], feed, t)
                    toks.append(tok)
                    step_logits.append(lg)
                res[f"serve_{serve_rules}"] = {
                    "routes": (prefill.route, serve.route, decode.route),
                    "prefill": logits, "tokens": torch.stack(toks, 1),
                    "logits": torch.stack(step_logits, 1), "cache": _full(caches[0]),
                    "bad_gathers": [g for g in _model_gathers(rec, model_ranks)
                                    if g in split_shapes]}
        if shape == (1, 2):
            out["recorders"] = _recorders(mesh["model"])
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


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
        r_step = jax.jit(r_make_train_step(r_get_config(arch, smoke=True), shape[0], lr=LR))
        p = tree_map(lambda x: x.numpy(), ranks["weights"][name])
        o = r_adamw_init(p)
        got = ranks[shape][0][name]["train"]["losses"]
        for b, loss in zip(_batches(_configs()[name], TRAIN_STEPS), got, strict=True):
            p, o, m = r_step(p, o, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=LOSS_RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("serve_rules", [True, False])
@pytest.mark.parametrize("shape,name", CASES)
def test_prefill_and_serve_are_the_unsharded_steps(ranks, shape, name, serve_rules):
    """The prefill's logits, each serve step's logits within
    ``LOGITS_TOL`` of the unsharded steps', the greedy tokens equal, and
    the final cache within ``DP4_TOL``, under the serving table (``d_head``
    split) and the train table."""
    cfg = _configs()[name]
    params = ranks["weights"][name]
    want_prefill = make_prefill_step(cfg)(params, {"tokens": _prompt(cfg)})
    cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    l_cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    serve = make_serve_step(cfg)
    toks, logits = [], []
    for t in range(SERVE_STEPS):
        feed = {"tokens": _prompt(cfg)[:, t:t + 1].to(torch.int32)}
        tok, cache = serve(params, cache, feed, t)
        with torch.no_grad():
            lg, l_cache = decode_step(params, l_cache, feed, t, cfg)
        toks.append(tok)
        logits.append(lg[:, -1].to(torch.float32))
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
    recurrentgemma and rwkv6 are at most ``FLOP_SHARE`` of the unsharded
    step's on the same batch: the projections, the RG-LRU gates and the
    RWKV-6 chunk products split too (what every rank repeats: RWKV-6's
    decay LoRA down-projection)."""
    for name in ARCHS:
        cfg = _configs()[name]
        params = ranks["weights"][name]
        plain = make_train_step(cfg, 1, lr=LR)
        with FlopCounterMode(display=False) as flops:
            plain(params, adamw_init(params), _batches(cfg, 1)[0])
        whole = flops.get_total_flops()
        for r in ranks[(1, 2)]:
            assert 0 < r[name]["flops"] <= FLOP_SHARE * whole, (name, r[name]["flops"], whole)


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


class _StandIn:
    """A mesh's axes and shape without its ranks (the production mesh)."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


GATHERED_ARCHS = {"granite-moe-3b-a800m", "arctic-480b"}


@pytest.mark.parametrize("arch", list_archs())
def test_each_config_takes_its_route(arch):
    """Dense and recurrent models split over a ``model`` axis of more than
    one rank under the ``"tp"`` tables; the MoE models, the ``"dp"``
    table, a step with no config and a ``model`` axis of one rank keep the
    gathered route. Asked for, ``"tp"`` is taken at one rank too, and
    refused where the default would not split but for the axis' size."""
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
    useful-FLOP ratio and less all-gather; granite's on the gathered
    route."""
    dense, moe = _dryrun_decode_cells(("internlm2-1.8b", "granite-moe-3b-a800m"))
    assert dense["route"] == "tp" and moe["route"] == "gathered"
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
