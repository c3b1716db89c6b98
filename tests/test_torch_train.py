"""The port's training slice against the reference's, on the CPU.

Data (``SyntheticLM``), the microbatch heuristic, AdamW, ``loss_fn``'s value
and gradients, the microbatched train step and the ``Trainer`` (loss falls,
crash restart, straggler hook, serving from its checkpoints) are held
against ``repro`` on the same inputs, made with numpy from a seed or by
the reference's ``init_params`` and carried across with
``params_from_reference`` / ``opt_from_reference``. A store written by
either package's ``Trainer`` resumes in the other with the same step,
parameters and optimizer moments. Each test states its tolerance.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs import get_config as r_get_config
from repro.data import SyntheticLM as RSyntheticLM
from repro.launch.steps import make_train_step as r_make_train_step
from repro.launch.steps import pick_microbatches as r_pick_microbatches
from repro.launch.train import Trainer as RTrainer
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.models.config import ModelConfig as RModelConfig
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticLM, make_batches
from repro_torch.launch.serve import ModelServer
from repro_torch.launch.steps import make_train_step, pick_microbatches
from repro_torch.launch.train import Trainer
from repro_torch.models import loss_fn, opt_from_reference, params_from_reference
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=512, attn_chunk=32,
             param_dtype="float32", compute_dtype="float32")
R_CFG, CFG = RModelConfig(**_TINY), ModelConfig(**_TINY)
DENSE = ["internlm2-1.8b", "qwen3-8b", "glm4-9b", "deepseek-67b", "llava-next-34b",
         "hubert-xlarge"]
# The store's reconstruction error of a float32 leaf (the reference's
# tests/test_checkpoint.py round trip, at the default tolerance 2^-24).
STORE_ATOL = 2 ** -23


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=""):
    """{path: float64 array} of a tree of tensors or arrays, and dtypes."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tree.detach().to(torch.float64).numpy(), str(tree.dtype).split(".")[1])
    else:
        arr = np.asarray(tree)
        out[prefix] = (arr.astype(np.float64), str(arr.dtype))
    return out


def _assert_trees_close(got, want, rtol=0.0, atol=0.0):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key][1] == w[key][1], (key, g[key][1], w[key][1])
        np.testing.assert_allclose(g[key][0], w[key][0], rtol=rtol, atol=atol, err_msg=key)


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 0, 1), (123, 1, 2),
                                                  (5, 3, 4), (10_000, 0, 2)])
def test_synthetic_lm_batches_are_the_reference_batches(step, shard, n_shards):
    for vocab, seed in ((512, 0), (92_544, 3)):
        want = RSyntheticLM(vocab, seed=seed).batch(step, 8, 33, shard, n_shards)
        got = SyntheticLM(vocab, seed=seed).batch(step, 8, 33, shard, n_shards)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    steps = [s for s, _ in make_batches(SyntheticLM(64), 4, 3, 2, 5)]
    assert steps == [4, 5, 6]


def test_pick_microbatches_matches_reference():
    batches = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 100, 128, 256, 384, 1000, 4096]
    for arch in list_archs():
        for smoke in (False, True):
            cfg, r_cfg = get_config(arch, smoke), r_get_config(arch, smoke)
            got = [pick_microbatches(cfg, n) for n in batches]
            assert got == [r_pick_microbatches(r_cfg, n) for n in batches], (arch, smoke)


# --------------------------------------------------------------------- AdamW
def _random_tree(rng):
    return {"embed": rng.normal(0, 1, (16, 8)).astype(np.float32),
            "periods": {"slot0": {"w": rng.normal(0, 0.1, (2, 8, 4)).astype(np.float32),
                                  "g": np.ones((2, 8), np.float32)}},
            "tail": [{"b": rng.normal(0, 1e-3, (5,)).astype(np.float32)}]}


def test_adamw_update_matches_reference():
    """Three updates on identical random trees, the moments starting from a
    restored state whose v has tiny negative entries (a lossy checkpoint):
    params, m, v and step within rtol 1e-6 / atol 1e-7."""
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    r_state = jax.tree.map(np.asarray, r_adamw_init(params))
    r_state["m"] = jax.tree.map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32),
                                r_state["m"])
    r_state["v"] = jax.tree.map(lambda a: rng.normal(0, 1e-8, a.shape).astype(np.float32),
                                r_state["v"])
    r_state["step"] = np.int32(4)
    assert min(float(a.min()) for a in jax.tree.leaves(r_state["v"])) < 0
    t_params, t_state = params_from_reference(params, "cpu"), opt_from_reference(r_state, "cpu")
    r_params = params
    for i in range(3):
        grads = jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
        r_params, r_state = r_adamw_update(r_params, grads, r_state, lr=1e-2)
        t_params, t_state = adamw_update(t_params, params_from_reference(grads, "cpu"),
                                         t_state, lr=1e-2)
        assert all(np.isfinite(a).all() for a in jax.tree.leaves(r_params))
    assert t_state["step"].dtype == torch.int32 and int(t_state["step"]) == 7
    tol = dict(rtol=1e-6, atol=1e-7)
    _assert_trees_close(t_params, jax.tree.map(np.asarray, r_params), **tol)
    _assert_trees_close(t_state, jax.tree.map(np.asarray, r_state), **tol)


def test_adamw_init_and_update_keep_the_tree_and_dtypes():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "l": [torch.zeros(2, 2)]}
    state = adamw_init(params)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    assert state["m"]["a"].dtype == torch.float32 and state["v"]["l"][0].shape == (2, 2)
    grads = {"a": torch.ones(3, dtype=torch.bfloat16), "l": [torch.ones(2, 2)]}
    new, new_state = adamw_update(params, grads, state)
    assert new["a"].dtype == torch.bfloat16 and isinstance(new["l"], list)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1  # inputs untouched
    assert torch.equal(params["a"], torch.ones(3, dtype=torch.bfloat16))


def test_tree_map_walks_dicts_and_lists_and_keeps_tuples_as_leaves():
    tree = {"b": [torch.ones(1), {"c": torch.zeros(2)}], "a": torch.full((1,), 3.0)}
    doubled = tree_map(lambda t: 2 * t, tree)
    assert isinstance(doubled["b"], list) and list(doubled) == ["b", "a"]
    assert [t.tolist() for t in tree_leaves(doubled)] == [[2.0], [0.0, 0.0], [6.0]]
    pairs = tree_map(lambda x, y: (x, y), tree, doubled)
    assert all(isinstance(p, tuple) for p in tree_leaves(pairs))
    assert torch.equal(pairs["b"][1]["c"][1], torch.zeros(2))


# ------------------------------------------------------------------ loss_fn
def _batch(cfg, rng, b=2, s=32):
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.frontend == "embeddings":
        return {"embeds": rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)), "labels": labels}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_value_and_grad_match_reference(arch, remat):
    """``loss_fn`` and its gradient with respect to every parameter against
    ``jax.value_and_grad`` of the reference's, on the dense smoke configs,
    with and without remat: rtol 1e-4 / atol 1e-6 (float32 sums in another
    order; the loss is a mean, so the gradients are small)."""
    r_cfg = dataclasses.replace(r_get_config(arch, smoke=True), remat=remat)
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    p_ref = jax.tree.map(np.asarray, r_init_params(r_cfg, jax.random.PRNGKey(1)))
    batch = _batch(cfg, np.random.default_rng(11))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    r_loss, r_grads = jax.value_and_grad(lambda p: r_loss_fn(p, jbatch, r_cfg)[0])(p_ref)
    params = params_from_reference(p_ref, "cpu")
    leaves = []
    jax.tree.map(lambda t: leaves.append(t.requires_grad_(True)), params)
    loss, _ = loss_fn(params, {k: _t(v) for k, v in batch.items()}, cfg)
    # An embeddings frontend leaves the token table unused: its gradient is
    # None here and zeros in the reference.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-4, atol=1e-6)
    want = jax.tree.leaves(r_grads)
    assert len(want) == len(grads)
    for p, g, w in zip(leaves, grads, want):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """Three steps from the same parameters on the same SyntheticLM batches:
    the losses agree within rtol 1e-4, and the optimizer's step counts."""
    p_ref = jax.tree.map(np.asarray, r_init_params(R_CFG, jax.random.PRNGKey(0)))
    r_step = jax.jit(r_make_train_step(R_CFG, n_micro, lr=1e-3))
    step = make_train_step(CFG, n_micro, lr=1e-3)
    r_params, r_opt = p_ref, r_adamw_init(p_ref)
    params = params_from_reference(p_ref, "cpu")
    opt = opt_from_reference(jax.tree.map(np.asarray, r_adamw_init(p_ref)), "cpu")
    data = SyntheticLM(CFG.vocab_size, seed=2)
    r_losses, losses = [], []
    for i in range(3):
        b = data.batch(i, 4, 32)
        r_params, r_opt, r_m = r_step(r_params, r_opt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, {k: _t(v) for k, v in b.items()})
        r_losses.append(float(r_m["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)
    assert int(opt["step"]) == int(r_opt["step"]) == 3


def test_train_step_refuses_uneven_microbatches():
    params = params_from_reference(
        jax.tree.map(np.asarray, r_init_params(R_CFG, jax.random.PRNGKey(0))), "cpu")
    b = {k: _t(v) for k, v in SyntheticLM(CFG.vocab_size).batch(0, 3, 8).items()}
    with pytest.raises(ValueError, match="equal microbatches"):
        make_train_step(CFG, 2)(params, adamw_init(params), b)


# ------------------------------------------------------------------- Trainer
# The reference's tests/test_train_serve.py, on the port (device="cpu").
def test_trainer_loss_decreases(tmp_path):
    tr = Trainer(CFG, str(tmp_path), ckpt_every=10, device="cpu")
    rep = tr.fit(steps=20, batch=4, seq=32)
    assert not rep.resumed
    assert rep.final_loss < np.mean(rep.losses[:3])
    assert tr.storage_report()["n_checkpoints"] >= 2


def test_trainer_crash_restart_resumes(tmp_path):
    tr1 = Trainer(CFG, str(tmp_path), ckpt_every=10, device="cpu")
    tr1.fit(steps=10, batch=4, seq=32)
    # "Crash": new Trainer against the same store resumes from step 10.
    tr2 = Trainer(CFG, str(tmp_path), ckpt_every=10, device="cpu")
    rep = tr2.fit(steps=5, batch=4, seq=32)
    assert rep.resumed
    assert rep.start_step == 10
    assert rep.end_step == 15


def test_trainer_straggler_hook(tmp_path):
    import time as _time

    seen = []
    tr = Trainer(CFG, str(tmp_path), ckpt_every=100, straggler_factor=1.5,
                 on_straggler=lambda s, dt, ewma: seen.append(s), device="cpu")
    orig = tr.step_fn
    calls = {"n": 0}

    def slow_step(*a):
        calls["n"] += 1
        if calls["n"] == 8:
            _time.sleep(1.0)  # synthetic straggler
        return orig(*a)

    tr.step_fn = slow_step
    # One intra-op thread: the straggler is the sleep, not a stall of the
    # CPU thread pool that other test workers share.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rep = tr.fit(steps=10, batch=4, seq=32)
    finally:
        torch.set_num_threads(threads)
    assert rep.n_stragglers >= 1, rep.step_seconds
    assert seen  # hook fired


def test_server_generates_from_checkpoints(tmp_path):
    tr = Trainer(CFG, str(tmp_path), ckpt_every=10, device="cpu")
    tr.fit(steps=10, batch=4, seq=32)
    srv = ModelServer(CFG, str(tmp_path), bits=8, device="cpu")
    step = srv.load()
    assert step == 10
    prompts = np.random.default_rng(0).integers(0, 512, (2, 4)).astype(np.int32)
    toks, stats = srv.generate(step, prompts, max_new_tokens=4)
    assert toks.shape == (2, 4)
    assert (toks >= 0).all() and (toks < 512).all()
    assert stats["tokens_per_s"] > 0
    # LRU: loading the same step again is a cache hit (no error, same id).
    assert srv.load(step) == step


# ------------------------------------------------- resume across the packages
def _state_np(params, opt):
    return {"params": jax.tree.map(np.asarray, params), "opt": jax.tree.map(np.asarray, opt)}


def test_reference_trainer_store_resumes_in_the_port(tmp_path):
    """A reference Trainer trains 3 steps (an async checkpoint at 2, the
    final one at 3); the port's Trainer resumes from its store at step 3
    with the reference's parameters and moments (equal to the reference's
    own restore, within the store's 2^-23 of its in-memory state) and goes
    on with the reference's losses (rtol 1e-4)."""
    root = tmp_path / "run"
    r_tr = RTrainer(R_CFG, str(root), ckpt_every=2)
    r_tr.fit(steps=3, batch=4, seq=32)
    r_tr.mgr.wait()
    shutil.copytree(root, tmp_path / "copy")
    _, r_restored = RCheckpointManager(str(root)).restore()

    tr = Trainer(CFG, str(root), ckpt_every=2, device="cpu")
    step, params, opt, resumed = tr._init_or_resume()
    assert resumed and step == 3
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 3
    got = {"params": params, "opt": opt}
    _assert_trees_close(got, r_restored)
    _assert_trees_close(got, _state_np(r_tr._params, r_tr._opt), atol=STORE_ATOL)

    rep = tr.fit(steps=2, batch=4, seq=32)
    r_rep = RTrainer(R_CFG, str(tmp_path / "copy"), ckpt_every=2).fit(steps=2, batch=4, seq=32)
    assert (rep.resumed, rep.start_step, rep.end_step) == (True, 3, 5)
    assert (r_rep.resumed, r_rep.start_step) == (True, 3)
    np.testing.assert_allclose(rep.losses, r_rep.losses, rtol=1e-4)


def test_port_trainer_store_resumes_in_the_reference(tmp_path):
    """The reverse: the port's Trainer writes the store, the reference's
    Trainer resumes from it at step 3 with the port's parameters and
    moments (the port's own restore exactly, its in-memory state within
    2^-23) and goes on with the port's losses (rtol 1e-4)."""
    root = tmp_path / "run"
    tr = Trainer(CFG, str(root), ckpt_every=2, device="cpu")
    tr.fit(steps=3, batch=4, seq=32)
    shutil.copytree(root, tmp_path / "copy")
    _, restored = CheckpointManager(str(root), device="cpu").restore()

    r_tr = RTrainer(R_CFG, str(root), ckpt_every=2)
    step, r_params, r_opt, resumed = r_tr._init_or_resume()
    assert resumed and step == 3
    assert np.asarray(r_opt["step"]).dtype == np.int32 and int(r_opt["step"]) == 3
    got = _state_np(r_params, r_opt)
    _assert_trees_close(got, restored)
    _assert_trees_close(got, {"params": tr._params, "opt": tr._opt}, atol=STORE_ATOL)

    r_rep = r_tr.fit(steps=2, batch=4, seq=32)
    rep = Trainer(CFG, str(tmp_path / "copy"), ckpt_every=2, device="cpu").fit(
        steps=2, batch=4, seq=32)
    assert (r_rep.resumed, r_rep.start_step, r_rep.end_step) == (True, 3, 5)
    assert (rep.resumed, rep.start_step) == (True, 3)
    np.testing.assert_allclose(rep.losses, r_rep.losses, rtol=1e-4)


def test_profile_steps_traces_a_train_step(capsys):
    """``profile_steps --train`` traces one train step of the model (the
    smoke size on the CPU: no kernel runs, so the device's busy time and
    the flash_attn share are 0) and prints one JSON object last."""
    import json

    from repro_torch.launch import profile_steps

    out = profile_steps.main(["--train", "--smoke", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    w = out["train"]
    assert w["plain_wall_ms"] > 0 and w["wall_ms"] > 0 and w["host_ops"] > 0
    assert (w["batch"], w["len"]) == (2, 16) and w["match"] == "flash_attn"
    assert w["device_busy_ms"] == 0.0 and w["match_ms"] == 0.0 and w["idle_share"] == 1.0
