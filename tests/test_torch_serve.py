"""The port's checkpoints, steps and store-backed server against the reference.

Checkpoints cross-open between the packages: a store written by
``repro.checkpoint.CheckpointManager`` restores in the port's, and the
reverse, with the same flat tensor names, manifest dtype strings and arrays.
The port's ``ModelServer`` (``device="cpu"``) generates the reference
server's tokens from the same checkpoint directory, and its prefill and
serve steps agree with each other.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.launch.serve import ModelServer as RModelServer
from repro.models import decode_step as r_decode_step
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models.config import ModelConfig as RModelConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.serve import ModelServer
from repro_torch.launch.steps import make_eval_step, make_prefill_step, make_serve_step
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    params_from_reference,
)
from repro_torch.models.config import ModelConfig

_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=512, attn_chunk=32,
             param_dtype="float32", compute_dtype="float32")
R_CFG, CFG = RModelConfig(**_TINY), ModelConfig(**_TINY)


def _ref_params(cfg=R_CFG, seed=0):
    return jax.tree.map(np.asarray, r_init_params(cfg, jax.random.PRNGKey(seed)))


def _drift(tree, seed):
    """The tree plus seeded noise of 1e-3 x each leaf's std (a next step)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + rng.normal(0, 1e-3 * float(a.std()) + 1e-6, a.shape)
                                   ).astype(a.dtype), tree)


def _flat_np(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat_np(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tree.to(torch.float32).numpy(), str(tree.dtype).split(".")[1])
    else:
        arr = np.asarray(tree)
        out[prefix] = (arr.astype(np.float32), str(arr.dtype))
    return out


def _assert_same_trees(got, want):
    g, w = _flat_np(got), _flat_np(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key][1] == w[key][1], key
        np.testing.assert_array_equal(g[key][0], w[key][0], err_msg=key)


def _manifest(root, step):
    with open(os.path.join(root, "store", "meta.json")) as f:
        meta = json.load(f)
    return meta["models"][f"ckpt-{step}"]


# --------------------------------------------------------------- checkpoints
def test_reference_checkpoints_restore_in_the_port(tmp_path):
    root = str(tmp_path)
    p0 = _ref_params()
    r_mgr = RCheckpointManager(root)
    r_mgr.save(1, p0)
    r_mgr.save(2, _drift(p0, 1))
    mgr = CheckpointManager(root, device="cpu")
    assert mgr.latest_step() == 2
    for step in (1, 2):
        for bits in (None, 8):
            _, want = r_mgr.restore(step, bits=bits)
            got_step, got = mgr.restore(step, bits=bits)
            assert got_step == step
            _assert_same_trees(got["params"], want["params"])
    assert mgr.storage_report()["n_checkpoints"] == 2


def test_port_checkpoints_restore_in_the_reference(tmp_path):
    """The port writes the reference's names and dtype strings, bfloat16
    leaves included, and the reference restores them."""
    p0 = _ref_params()
    tree = params_from_reference(p0, "cpu")
    tree["embed"] = tree["embed"].to(torch.bfloat16)
    tree["periods"]["slot0"]["norm1"] = tree["periods"]["slot0"]["norm1"].to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path / "port"), device="cpu")
    mgr.save(1, tree)
    mgr.save(2, tree, blocking=False)
    mgr.wait()
    entry = _manifest(str(tmp_path / "port"), 1)
    dtypes = entry["architecture"]["dtypes"]
    assert dtypes["params//embed"] == "bfloat16"
    assert dtypes["params//periods//slot0//norm1"] == "bfloat16"
    assert dtypes["params//periods//slot0//seq//wq"] == "float32"
    r_mgr = RCheckpointManager(str(tmp_path / "port"))
    for step in (1, 2):
        for bits in (None, 8):
            _, want = r_mgr.restore(step, bits=bits)
            _, got = mgr.restore(step, bits=bits)
            _assert_same_trees(got["params"], want["params"])
    assert want["params"]["embed"].dtype.name == "bfloat16"

    # The same float32 tree saved by each package: same names and manifest.
    r_only = RCheckpointManager(str(tmp_path / "ref"))
    r_only.save(1, p0)
    t_only = CheckpointManager(str(tmp_path / "port32"), device="cpu")
    t_only.save(1, params_from_reference(p0, "cpu"))
    r_entry, t_entry = _manifest(str(tmp_path / "ref"), 1), _manifest(str(tmp_path / "port32"), 1)
    assert t_entry["architecture"] == r_entry["architecture"]
    r_lm = r_only.engine.load_model("ckpt-1")
    t_lm = t_only.engine.load_model("ckpt-1")
    assert t_lm.tensor_names() == r_lm.tensor_names()
    for name in r_lm.tensor_names():
        np.testing.assert_array_equal(t_lm.tensor(name), r_lm.tensor(name), err_msg=name)


def test_restore_of_an_empty_store_and_tail_lists(tmp_path):
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr.restore() == (None, None)
    tree = {"tail": [{"w": torch.ones(3)}, {"w": torch.zeros(3)}], "n": torch.tensor(7)}
    mgr.save(5, tree)
    _, got = mgr.restore()
    assert isinstance(got["params"]["tail"], list)
    np.testing.assert_array_equal(got["params"]["tail"][0]["w"].numpy(), np.ones(3))
    assert int(got["params"]["n"]) == 7


def test_params_only_restore_leaves_the_optimizer_in_the_store(tmp_path):
    """What ``ModelServer.load`` restores from a training checkpoint: the
    same parameters as a whole restore, and no optimizer tensor is read
    from the store."""
    from repro_torch.optim import adamw_init

    mgr = CheckpointManager(str(tmp_path), device="cpu")
    params = params_from_reference(_ref_params(), "cpu")
    mgr.save(4, params, adamw_init(params))
    _, whole = mgr.restore(4, bits=8)
    load_model, read = mgr.engine.load_model, []

    def spied(name, **kw):
        lm = load_model(name, **kw)
        tensor = lm.tensor
        lm.tensor = lambda key: read.append(key) or tensor(key)
        return lm

    mgr.engine.load_model = spied
    step, state = mgr.restore(4, bits=8, params_only=True)
    assert step == 4 and state["opt"] is None and read
    assert all(key.startswith("params//") for key in read)
    got, want = jax.tree.leaves(state["params"]), jax.tree.leaves(whole["params"])
    assert len(got) == len(want) == len(jax.tree.leaves(params))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(whole["opt"]["step"]) == 0


# ------------------------------------------------------------------- server
def _reference_greedy(params, prompts, steps):
    """The reference's decode loop: tokens and per-step logits."""
    b, s0 = prompts.shape
    cache = r_init_cache(R_CFG, b, s0 + steps)
    for t in range(s0):
        logits, cache = r_decode_step(params, cache, {"tokens": jnp.asarray(prompts[:, t:t + 1])},
                                      jnp.int32(t), R_CFG)
    toks, all_logits = [], []
    for i in range(steps):
        all_logits.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = r_decode_step(params, cache, {"tokens": tok}, jnp.int32(s0 + i), R_CFG)
    return np.concatenate(toks, axis=1), np.stack(all_logits, axis=1)


def _assert_tokens_agree(got, want, want_logits, tol=1e-4):
    """Equal tokens while both decodes were fed the same tokens; a near tie
    (top-2 margin within ``tol``) may split them, and ends the comparison."""
    for s in range(want.shape[1]):
        top2 = np.sort(want_logits[:, s], axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tol * (1 + np.abs(top2[:, 1]))
        np.testing.assert_array_equal(got[clear, s], want[clear, s])
        if not np.array_equal(got[:, s], want[:, s]):
            break


@pytest.mark.parametrize("bits", [None, 8])
def test_port_server_generates_the_reference_tokens(tmp_path, bits):
    p0 = _ref_params()
    RCheckpointManager(str(tmp_path)).save(10, p0)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 4)).astype(np.int32)
    srv = ModelServer(CFG, str(tmp_path), bits=bits, device="cpu")
    r_srv = RModelServer(R_CFG, str(tmp_path), bits=bits)
    assert srv.load() == r_srv.load() == 10
    toks, stats = srv.generate(10, prompts, max_new_tokens=6)
    r_toks, _ = r_srv.generate(10, prompts, max_new_tokens=6)
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    assert stats["tokens_per_s"] > 0 and stats["prefill_s"] >= 0
    _, state = RCheckpointManager(str(tmp_path)).restore(10, bits=bits)
    want, want_logits = _reference_greedy(state["params"], prompts, 6)
    np.testing.assert_array_equal(r_toks, want)
    _assert_tokens_agree(toks, want, want_logits)


def test_port_server_lru(tmp_path):
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    params = params_from_reference(_ref_params(), "cpu")
    mgr.save(1, params)
    mgr.save(2, params_from_reference(_drift(_ref_params(), 3), "cpu"))
    srv = ModelServer(CFG, str(tmp_path), bits=None, max_models=1, device="cpu")
    assert srv.load(1) == 1
    first = srv._models[1]
    assert srv.load(1) == 1 and srv._models[1] is first     # cache hit, no restore
    assert srv.load() == 2 and list(srv._models) == [2]      # latest; LRU evicts 1
    assert srv.load(1) == 1 and list(srv._models) == [1]
    # bits=None restores within the store's tolerance (2^-24, relative).
    np.testing.assert_allclose(srv._models[1]["embed"].numpy(), params["embed"].numpy(),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        ModelServer(CFG, str(tmp_path / "empty"), device="cpu").load()


# -------------------------------------------------------------------- steps
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-8b", "glm4-9b", "deepseek-67b",
                                  "llava-next-34b"])
def test_prefill_decode_consistency(arch):
    """Teacher-forced forward logits equal the decode loop's (as in
    tests/test_archs.py, rtol 2e-2 / atol 2e-3), and the prefill step's
    last logits and the serve step's first greedy token follow."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    full = forward(params, {"tokens": toks}, cfg)
    cache = init_cache(cfg, 2, 33, device="cpu")
    steps = []
    for t in range(32):
        lg, cache = decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t, cfg)
        steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-3)
    last = make_prefill_step(cfg)(params, {"tokens": toks})
    assert last.dtype == torch.float32 and tuple(last.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=1e-6, atol=1e-6)
    cache = init_cache(cfg, 2, 33, device="cpu")
    serve = make_serve_step(cfg)
    for t in range(32):
        nxt, cache = serve(params, cache, {"tokens": toks[:, t:t + 1]}, t)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), full[:, -1].argmax(dim=-1).numpy())


def test_eval_step_is_the_loss():
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))}
    got = make_eval_step(cfg)(params, batch)
    assert float(got) == float(loss_fn(params, batch, cfg)[0])
    assert abs(float(got) - np.log(cfg.vocab_size)) < 3.0  # random init: near ln V


def test_profile_steps_reports_both_windows(capsys):
    """The step profiler runs its two windows and prints one JSON object
    last; on the CPU no kernel runs, so the device's busy time is 0."""
    from repro_torch.launch import profile_steps

    out = profile_steps.main(["--smoke", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    for window in ("prefill", "serve"):
        w = out[window]
        assert w["plain_wall_ms"] > 0 and w["wall_ms"] > 0 and w["host_ops"] > 0
        assert w["device_busy_ms"] == 0.0 and w["kernels"] == 0 and w["idle_share"] == 1.0
    assert profile_steps._union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_profile_steps_traces_the_compressed_decode(capsys):
    """``--compressed`` saves a decoder and its fine-tune, loads it at bits
    8 and 4 and traces one greedy decode a window, with the dq_matmul
    kernels' share of the busy time (0 on the CPU: no kernel runs)."""
    from repro_torch.launch import profile_steps

    out = profile_steps.main(["--compressed", "--smoke", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    for bits in (8, 4):
        w = out[f"compressed_bits{bits}"]
        assert w["plain_wall_ms"] > 0 and w["wall_ms"] > 0 and w["host_ops"] > 0
        assert w["steps"] == 4 and w["match"] == "dq_matmul"
        assert w["device_busy_ms"] == 0.0 and w["match_ms"] == 0.0 and w["idle_share"] == 1.0
