"""The sharded train and serve steps and the elastic restore, on the CPU.

``launch.shardings.sharded`` keeps params, optimizer state and caches as
DTensors placed by the spec trees and runs the port's unchanged steps on
local tensors, the gradients summed over the data-parallel ranks. Held
here:

* at world size 1 (gloo over a ``HashStore``, a (1, 1) mesh), the ports of
  the reference's ``test_sharded_train_step_runs`` and
  ``test_sharded_serve_step_runs`` (which fail in the reference under JAX
  0.9): bit-identical to the unsharded steps of the port, and within the
  train and decode tests' tolerances of the reference's unsharded steps
  on the same weights (``params_from_reference``);
* at world sizes 2 and 4 (spawned gloo ranks over a ``FileStore``) on
  (2, 1), (1, 2) and (2, 2) meshes, float32 smoke configs, under the
  ``"tp"`` and ``"dp"`` rules: a data-parallel step of n ranks with one
  microbatch each against the unsharded step with n microbatches, and a
  serve step against the unsharded one on each rank's rows (the ``"tp"``
  rules split the dense smoke models' compute over ``model``: where that
  axis has two ranks, within ``TP_TOL``);
* ``restore_sharded``: the reference's elastic restore case, each rank's
  local shards against their slices of the unsharded restore at 2 and 4
  ranks, and a store written by the reference's ``CheckpointManager``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from repro.checkpoint.manager import CheckpointManager as RCheckpointManager
from repro.configs import get_config as r_get_config
from repro.launch.steps import make_serve_step as r_make_serve_step
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.optim import adamw_init as r_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.launch.train import restore_sharded
from repro_torch.models import init_cache, init_params, params_from_reference
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map
from test_torch_tensor_parallel import adam_state_gaps

# Spawned ranks each import torch, JAX and both packages; a hung rendezvous
# or collective fails the test after this many seconds.
JOIN_TIMEOUT_S = 180
TRAIN_STEPS, SERVE_STEPS, BATCH, SEQ, CACHE_LEN = 2, 4, 4, 32, 16
# A reference step against the port's: the train tests' loss tolerance and
# the f32 decode tests' (tests/test_torch_train.py, tests/test_torch_models.py).
LOSS_RTOL = 1e-4
F32 = dict(rtol=1e-4, atol=2e-5)
# The checkpoint store's reconstruction error of a float32 leaf at its
# default tolerance 2^-24 (tests/test_checkpoint.py's round trip).
STORE_ATOL = 2.0 ** -23
# Four data-parallel ranks against four microbatches: gloo's all-reduce
# adds the four gradients in another order than the microbatch loop, and
# two AdamW steps carry the difference into the parameters.
DP4_TOL = dict(rtol=1e-4, atol=1e-5)
# A step split over a ``model`` axis of two ranks ("tp" route) against the
# unsharded step: the row-parallel products (the attention's and the MLP's
# output projections) and the vocabulary-split cross entropy add the two
# ranks' partial sums in another order than one rank's product does, and
# two AdamW steps carry the difference into the parameters; the decode
# cache's K/V rows come from residuals summed so.
# AdamW turns a gradient within its own rounding into a weight up to 2 lr
# apart, so the split state is held by tests/test_torch_tensor_parallel.py's
# rule (``adam_state_gaps``): the gradients and moments of each step within
# relative L2 error GRAD_RTOL and TP_TOL, each weight within TP_TOL plus
# what the two runs' own moments make of its updates.
TP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def mesh11():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def _batches(cfg, n, batch=BATCH, seq=SEQ):
    data = SyntheticLM(cfg.vocab_size, seed=3)
    return [{k: torch.from_numpy(v) for k, v in data.batch(i, batch, seq).items()}
            for i in range(n)]


def _full(tree):
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def _assert_bits(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _sharded_train(cfg, mesh, n_micro, profile="tp"):
    with sh.use_mesh(mesh, multi_pod="pod" in mesh.mesh_dim_names, profile=profile) as ctx:
        params = init_params(cfg, 0, device="cpu")
        p_spec = shd.param_specs_tree(params, ctx)
        o_spec = shd.opt_specs_tree(None, p_spec)
        b_spec = shd.batch_specs_tree(_batches(cfg, 1)[0], ctx)
        step = shd.sharded(make_train_step(cfg, n_micro, lr=1e-3),
                           (p_spec, o_spec, shd.per_batch(b_spec)), (p_spec, o_spec, None), ctx,
                           cfg=cfg)
        return step, shd.place(params, p_spec, mesh), shd.place(adamw_init(params), o_spec, mesh)


def _sharded_serve(cfg, mesh, profile="tp"):
    with sh.use_mesh(mesh, multi_pod="pod" in mesh.mesh_dim_names, seq_shard=False, serve=True,
                     profile=profile) as ctx:
        params = init_params(cfg, 0, device="cpu")
        cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
        p_spec = shd.param_specs_tree(params, ctx)
        c_spec = shd.cache_specs_tree(cache, ctx, cfg.n_kv_heads)
        b_spec = shd.batch_specs_tree({"tokens": torch.zeros((BATCH, 1))}, ctx)
        step = shd.sharded(make_serve_step(cfg),
                           (p_spec, shd.per_batch(c_spec), shd.per_batch(b_spec), None),
                           (shd.per_batch(None), shd.per_batch(c_spec)), ctx, cfg=cfg)
        return step, shd.place(params, p_spec, mesh), shd.place(cache, c_spec, mesh)


def _prompt(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (BATCH, SERVE_STEPS))


# ------------------------------------------------------------ world size 1
def test_sharded_train_step_runs(mesh11):
    """The reference's case (internlm2 smoke, 2 microbatches, a (1, 1)
    mesh), three steps: loss, params and moments bit-identical to the
    unsharded port step; the losses within rtol 1e-4 of the reference's
    unsharded step on the same weights and batches."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    step, params, opt = _sharded_train(cfg, mesh11, 2)
    assert all(isinstance(x, DTensor) for x in tree_leaves([params, opt]))
    plain = make_train_step(cfg, 2, lr=1e-3)
    u_params = init_params(cfg, 0, device="cpu")
    u_opt = adamw_init(u_params)
    for b in _batches(cfg, 3):
        params, opt, metrics = step(params, opt, b)
        u_params, u_opt, u_metrics = plain(u_params, u_opt, b)
        assert np.isfinite(float(metrics["loss"]))
        assert torch.equal(metrics["loss"], u_metrics["loss"])
        _assert_bits(_full([params, opt]), [u_params, u_opt])
    assert int(opt["step"].full_tensor()) == 3

    r_cfg = r_get_config("internlm2-1.8b", smoke=True)
    p_ref = jax.tree.map(np.asarray, r_init_params(r_cfg, jax.random.PRNGKey(0)))
    r_step = jax.jit(r_make_train_step(r_cfg, 2, lr=1e-3))
    r_params, r_opt = p_ref, r_adamw_init(p_ref)
    step, params, opt = _sharded_train(cfg, mesh11, 2)
    with sh.use_mesh(mesh11) as ctx:
        params = shd.place(params_from_reference(p_ref, "cpu"),
                           shd.param_specs_tree(_full(params), ctx), mesh11)
    for b in _batches(cfg, 3):
        r_params, r_opt, r_m = r_step(r_params, r_opt, {k: jnp.asarray(v.numpy())
                                                        for k, v in b.items()})
        params, opt, metrics = step(params, opt, b)
        np.testing.assert_allclose(float(metrics["loss"]), float(r_m["loss"]), rtol=LOSS_RTOL)


def test_sharded_serve_step_runs(mesh11):
    """The reference's case (glm4 smoke, the serving rules): tokens of
    shape (B,), then four teacher-forced steps: tokens equal and the cache
    bit-identical to the unsharded port step; tokens equal to the
    reference's unsharded step on the same weights, its cache within the
    f32 decode tolerance."""
    cfg = get_config("glm4-9b", smoke=True)
    step, params, cache = _sharded_serve(cfg, mesh11)
    tok, cache = step(params, cache, {"tokens": torch.zeros((BATCH, 1), dtype=torch.int32)}, 0)
    assert tuple(tok.shape) == (BATCH,) and not isinstance(tok, DTensor)
    assert all(isinstance(x, DTensor) for x in tree_leaves(cache))

    r_cfg = r_get_config("glm4-9b", smoke=True)
    p_ref = jax.tree.map(np.asarray, r_init_params(r_cfg, jax.random.PRNGKey(0)))
    r_step = jax.jit(r_make_serve_step(r_cfg))
    r_cache = r_init_cache(r_cfg, BATCH, CACHE_LEN)
    u_params = params_from_reference(p_ref, "cpu")
    u_cache = init_cache(cfg, BATCH, CACHE_LEN, device="cpu")
    plain = make_serve_step(cfg)
    step, params, cache = _sharded_serve(cfg, mesh11)
    with sh.use_mesh(mesh11, seq_shard=False, serve=True) as ctx:
        params = shd.place(params_from_reference(p_ref, "cpu"),
                           shd.param_specs_tree(u_params, ctx), mesh11)
    toks = _prompt(cfg)
    for t in range(SERVE_STEPS):
        feed = toks[:, t:t + 1].astype(np.int32)
        tok, cache = step(params, cache, {"tokens": torch.from_numpy(feed)}, t)
        u_tok, u_cache = plain(u_params, u_cache, {"tokens": torch.from_numpy(feed)}, t)
        r_tok, r_cache = r_step(p_ref, r_cache, {"tokens": jnp.asarray(feed)}, jnp.int32(t))
        assert torch.equal(tok, u_tok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
    _assert_bits(_full(cache), u_cache)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(r_cache),
                                 tree_leaves(_full(cache))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32, err_msg=str(path))


def test_elastic_restore_different_mesh(mesh11, tmp_path):
    """Save unsharded → restore and shard onto a different device layout;
    every leaf a DTensor equal to the unsharded restore."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert restore_sharded(mgr, mesh11, None) == (None, None)
    mgr.save(3, params)
    _, state = mgr.restore()
    with sh.use_mesh(mesh11) as ctx:
        step, sharded = restore_sharded(mgr, mesh11, ctx)
    assert step == 3
    assert all(isinstance(x, DTensor) for x in tree_leaves(sharded))
    _assert_bits(_full(sharded), state["params"])
    mgr.close()


def test_reference_store_restores_sharded(mesh11, tmp_path):
    """A store written by the reference's ``CheckpointManager``: the port's
    sharded restore equals the reference's own restore bit for bit, and
    the saved weights within the store's 2^-23."""
    r_cfg = r_get_config("internlm2-1.8b", smoke=True)
    p_ref = jax.tree.map(np.asarray, r_init_params(r_cfg, jax.random.PRNGKey(0)))
    r_mgr = RCheckpointManager(str(tmp_path))
    r_mgr.save(5, p_ref)
    _, r_state = r_mgr.restore()
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    with sh.use_mesh(mesh11) as ctx:
        step, sharded = restore_sharded(mgr, mesh11, ctx)
    assert step == 5
    got = tree_leaves(_full(sharded))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(r_state["params"])]
    saved = [np.asarray(x) for x in jax.tree_util.tree_leaves(p_ref)]
    assert len(got) == len(want) == len(saved)
    for g, w, s in zip(got, want, saved):
        assert g.numpy().tobytes() == w.tobytes()
        np.testing.assert_allclose(g.numpy(), s, atol=STORE_ATOL, rtol=0)
    mgr.close()


# ------------------------------------------------- world sizes 2 and 4
MESH_SHAPES = [(2, 1), (1, 2), (2, 2)]


def _slice(x: torch.Tensor, placements, coord, sizes) -> torch.Tensor:
    """Rank ``coord``'s part of ``x`` under DTensor's even sharding: each
    mesh dim in order splits its tensor dim into equal chunks."""
    for p, c, n in zip(placements, coord, sizes):
        if p.is_shard():
            x = torch.chunk(x, n, dim=p.dim)[c]
    return x


def _worker(rank: int, shape: tuple, store_path: str, out_dir: str, ckpt_dir: str) -> None:
    n = shape[0] * shape[1]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        out = {"coord": [int(c) for c in mesh.get_coordinate()]}
        cfg = get_config("internlm2-1.8b", smoke=True)
        for profile in ("tp", "dp"):
            step, params, opt = _sharded_train(cfg, mesh, 1, profile)
            losses, states = [], []
            for b in _batches(cfg, TRAIN_STEPS):
                params, opt, metrics = step(params, opt, b)
                losses.append(metrics["loss"])
                states.append(_full([params, opt]))
            out[f"train_{profile}"] = {"losses": losses, "states": states}
        s_cfg = get_config("glm4-9b", smoke=True)
        toks = _prompt(s_cfg)
        for profile in ("tp", "dp"):
            step, params, cache = _sharded_serve(s_cfg, mesh, profile)
            got = []
            for t in range(SERVE_STEPS):
                feed = torch.from_numpy(toks[:, t:t + 1].astype(np.int32))
                tok, cache = step(params, cache, {"tokens": feed}, t)
                got.append(tok)
            out[f"serve_{profile}"] = {"tokens": torch.stack(got, 1), "cache": _full(cache)}
        mgr = CheckpointManager(ckpt_dir, device="cpu")
        with sh.use_mesh(mesh) as ctx:
            _, restored = restore_sharded(mgr, mesh, ctx)
        out["restore"] = tree_map(lambda x: (x.to_local(), tuple(x.placements)), restored)
        mgr.close()
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh shape's ranks, run once: {shape: [each rank's results]}
    and the store they restored ("ckpt")."""
    root = tmp_path_factory.mktemp("ranks")
    ckpt = root / "ckpt"
    mgr = CheckpointManager(str(ckpt), device="cpu")
    mgr.save(7, init_params(get_config("internlm2-1.8b", smoke=True), 1, device="cpu"))
    mgr.close()
    out = {"ckpt": str(ckpt)}
    for shape in MESH_SHAPES:
        d = root / f"{shape[0]}x{shape[1]}"
        d.mkdir()
        n = shape[0] * shape[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(r, shape, str(d / "store"), str(d), str(ckpt)))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not alive, f"{shape}: workers {alive} still running after {JOIN_TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * n, shape
        out[shape] = [torch.load(d / f"r{r}.pt", weights_only=False) for r in range(n)]
    return out


def _n_dp(shape, profile) -> int:
    return shape[0] if profile == "tp" else shape[0] * shape[1]


@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_data_parallel_train_step_is_the_microbatched_step(ranks, shape, profile):
    """n data-parallel ranks, one microbatch each, against the unsharded
    step with n microbatches (the same rows in each): the losses, params
    and moments bit-identical at n ≤ 2 (the same sums in the same order),
    within ``DP4_TOL`` at n = 4, and, where the ``"tp"`` rules split the
    step over a ``model`` axis of two, the losses within ``TP_TOL`` and
    the state of each step held by ``adam_state_gaps`` at ``TP_TOL``;
    every rank ends with the same state."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    n = _n_dp(shape, profile)
    split = profile == "tp" and shape[1] > 1
    plain = make_train_step(cfg, n, lr=1e-3)
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    losses, want = [], []
    for b in _batches(cfg, TRAIN_STEPS):
        params, opt, metrics = plain(params, opt, b)
        losses.append(metrics["loss"])
        want.append([params, opt])
    results = [r[f"train_{profile}"] for r in ranks[shape]]
    for r in results:
        _assert_bits(r["states"], results[0]["states"])
        assert [float(x) for x in r["losses"]] == [float(x) for x in results[0]["losses"]]
    got = results[0]
    if n <= 2 and not split:
        assert all(torch.equal(a, b) for a, b in zip(got["losses"], losses))
        _assert_bits(got["states"], want)
        return
    tol = TP_TOL if split else DP4_TOL
    np.testing.assert_allclose(torch.stack(got["losses"]).numpy(),
                               torch.stack(losses).numpy(), **tol)
    if split:
        bad, seen = adam_state_gaps(got["states"], want, 1e-3, TP_TOL)
        print("\n".join(seen))
        assert not bad, bad
        return
    worst = 0.0
    for a, b in zip(tree_leaves(got["states"][-1]), tree_leaves([params, opt])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **DP4_TOL)
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    print(f"{shape} {profile}: {n} ranks against {n} microbatches, max |diff| {worst:.3e}")


@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_serve_steps_are_the_unsharded_steps_on_each_ranks_rows(ranks, shape, profile):
    """Tokens gathered whole on every rank; tokens equal to the unsharded
    serve step run on each data-parallel rank's rows and to the unsharded
    step's on the whole batch; the final cache bit-identical to the
    former's, or within ``TP_TOL`` where the ``"tp"`` rules split the step
    over a ``model`` axis of two."""
    cfg = get_config("glm4-9b", smoke=True)
    n = _n_dp(shape, profile)
    params = init_params(cfg, 0, device="cpu")
    plain = make_serve_step(cfg)
    toks = _prompt(cfg)
    rows = BATCH // n

    def run(lo, hi):
        cache = init_cache(cfg, hi - lo, CACHE_LEN, device="cpu")
        out = []
        for t in range(SERVE_STEPS):
            feed = torch.from_numpy(toks[lo:hi, t:t + 1].astype(np.int32))
            tok, cache = plain(params, cache, {"tokens": feed}, t)
            out.append(tok)
        return torch.stack(out, 1), cache

    parts = [run(i * rows, (i + 1) * rows) for i in range(n)]
    want_tokens = torch.cat([p[0] for p in parts])
    want_cache = tree_map(lambda *xs: torch.cat(xs, dim=1), *[p[1] for p in parts])
    whole_tokens, _ = run(0, BATCH)
    for r in ranks[shape]:
        got = r[f"serve_{profile}"]
        assert torch.equal(got["tokens"], want_tokens)
        assert torch.equal(got["tokens"], whole_tokens)
        if profile == "tp" and shape[1] > 1:
            for a, b in zip(tree_leaves(got["cache"]), tree_leaves(want_cache), strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TP_TOL)
        else:
            _assert_bits(got["cache"], want_cache)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_restore_sharded_gives_each_rank_its_slice(ranks, shape):
    """Each rank's local shard of every restored leaf is bit-identical to
    its slice of the unsharded restore of the same store, under the
    ``"tp"`` rules (FSDP over data, TP over model)."""
    mgr = CheckpointManager(ranks["ckpt"], device="cpu")
    step, state = mgr.restore(params_only=True)
    mgr.close()
    assert step == 7
    full = tree_leaves(state["params"])
    sharded = 0
    for r in ranks[shape]:
        got = tree_leaves(r["restore"])
        assert len(got) == len(full)
        for (local, placements), whole in zip(got, full):
            expect = _slice(whole, placements, r["coord"], shape)
            assert local.dtype == whole.dtype and torch.equal(local, expect)
            sharded += any(p.is_shard() for p in placements)
    assert sharded > 0
