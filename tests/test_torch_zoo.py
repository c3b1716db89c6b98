"""The rest of the model zoo against the reference, on the CPU: the smoke
configs of recurrentgemma (RG-LRU + local attention), rwkv6 (RWKV-6 time
and channel mix), granite-moe (routed experts) and arctic (experts beside a
dense residual).

The reference's parameters (``repro.models.init_params``) are carried into
the port with ``params_from_reference``; inputs are made with numpy from a
seed. Each test states its tolerance: float32 comparisons differ only in
the order of float32 sums, bfloat16 is looser because the frameworks round
to bfloat16 at different places.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs import get_config as r_get_config
from repro.models import decode_step as r_decode_step
from repro.models import forward as r_forward
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    params_from_reference,
)

ZOO = ["recurrentgemma-9b", "rwkv6-7b", "granite-moe-3b-a800m", "arctic-480b"]
F32 = dict(rtol=1e-4, atol=2e-5)   # the reference's attention tolerance


def _t(x):
    return torch.from_numpy(np.array(x))


def _ref_params(r_cfg, seed=0):
    return jax.tree.map(np.asarray, r_init_params(r_cfg, jax.random.PRNGKey(seed)))


def _batch(cfg, rng, b=2, s=32):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))}


def _configs(arch, **changes):
    return (dataclasses.replace(r_get_config(arch, smoke=True), **changes),
            dataclasses.replace(get_config(arch, smoke=True), **changes))


def _check_model(r_cfg, cfg, *, fwd_tol, dec_tol, steps=4):
    p_ref = _ref_params(r_cfg)
    params = params_from_reference(p_ref, "cpu")
    batch = _batch(cfg, np.random.default_rng(7))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    want = np.asarray(r_forward(p_ref, jbatch, r_cfg).astype(jnp.float32))
    got = forward(params, tbatch, cfg).to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, **fwd_tol)
    r_loss, _ = r_loss_fn(p_ref, jbatch, r_cfg)
    loss, metrics = loss_fn(params, tbatch, cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), **fwd_tol)
    assert metrics["tokens"] == 2 * 32
    toks = batch["tokens"]
    r_cache = r_init_cache(r_cfg, 2, 16)
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert (jax.tree.map(lambda a: (a.shape, str(a.dtype)), r_cache)
            == jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), cache))
    for t in range(steps):
        w, r_cache = r_decode_step(p_ref, r_cache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                   jnp.int32(t), r_cfg)
        g, cache = decode_step(params, cache, {"tokens": _t(toks[:, t:t + 1])}, t, cfg)
        assert tuple(g.shape) == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w.astype(jnp.float32)), **dec_tol)
        # The decode continues the forward over the same tokens.
        np.testing.assert_allclose(g.to(torch.float32).numpy(), got[:, t:t + 1], **dec_tol)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_smoke_model_matches_reference_f32(arch):
    """float32 smoke configs: logits, loss, the cache tree and decode steps
    at rtol 1e-4 / atol 2e-5."""
    _check_model(*_configs(arch), fwd_tol=F32, dec_tol=F32)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_zoo_smoke_model_matches_reference_bf16():
    """recurrentgemma smoke in bfloat16 (float32 ``lam`` and RG-LRU state
    inside a bfloat16 tree). Every matmul output is rounded to bfloat16 at
    places that differ between XLA and PyTorch, and the RG-LRU state is
    cast to bfloat16 before the output gate, so elementwise bounds say
    little: through 5 layers the two packages' logits were 2.09e-2 apart in
    relative L2 (one logit of 4.4 off by 0.21), each 1.5-1.6e-2 from the
    float32 forward of the same parameters. Held: the port's logits no
    further from that float32 forward than 1.25x the reference's own, the
    two within 3e-2 relative L2, the loss within rtol 1e-2 and each decode
    step's logits within 3e-2 relative L2 of the reference's."""
    r_cfg, cfg = _configs("recurrentgemma-9b", param_dtype="bfloat16", compute_dtype="bfloat16")
    r_f32 = dataclasses.replace(r_cfg, param_dtype="float32", compute_dtype="float32")
    p_ref = _ref_params(r_cfg)
    params = params_from_reference(p_ref, "cpu")
    batch = _batch(cfg, np.random.default_rng(7))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    want = np.asarray(r_forward(p_ref, jbatch, r_cfg).astype(jnp.float32))
    truth = np.asarray(r_forward(jax.tree.map(lambda a: np.asarray(a, np.float32), p_ref),
                                 jbatch, r_f32))
    got = forward(params, tbatch, cfg).to(torch.float32).numpy()
    assert _rel_l2(got, truth) <= 1.25 * _rel_l2(want, truth)
    assert _rel_l2(got, want) <= 3e-2
    r_loss, _ = r_loss_fn(p_ref, jbatch, r_cfg)
    np.testing.assert_allclose(float(loss_fn(params, tbatch, cfg)[0]), float(r_loss), rtol=1e-2)
    r_cache = r_init_cache(r_cfg, 2, 16)
    cache = init_cache(cfg, 2, 16, device="cpu")
    toks = batch["tokens"]
    for t in range(4):
        w, r_cache = r_decode_step(p_ref, r_cache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                   jnp.int32(t), r_cfg)
        g, cache = decode_step(params, cache, {"tokens": _t(toks[:, t:t + 1])}, t, cfg)
        assert _rel_l2(g.to(torch.float32).numpy(), np.asarray(w.astype(jnp.float32))) <= 3e-2


def test_recurrentgemma_decode_wraps_the_window_ring():
    """40 decode steps with ``max_len`` 48: the local attention's 16-token
    ring buffer wraps twice, the RG-LRU layers carry their state, every
    step's logits within rtol 1e-4 / atol 2e-5 of the reference's."""
    r_cfg, cfg = _configs("recurrentgemma-9b")
    p_ref = _ref_params(r_cfg, seed=3)
    params = params_from_reference(p_ref, "cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 40))
    r_step = jax.jit(r_decode_step, static_argnums=(4,))
    r_cache = r_init_cache(r_cfg, 2, 48)
    cache = init_cache(cfg, 2, 48, device="cpu")
    assert cache["periods"]["slot2"]["k"].shape[3] == cfg.window
    for t in range(40):
        w, r_cache = r_step(p_ref, r_cache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jnp.int32(t), r_cfg)
        g, cache = decode_step(params, cache, {"tokens": _t(toks[:, t:t + 1])}, t, cfg)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32, err_msg=f"step {t}")
    np.testing.assert_allclose(cache["tail"][1]["h"].numpy(), np.asarray(r_cache["tail"][1]["h"]),
                               **F32)


# --------------------------------------------------------------- checkpoints
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


@pytest.mark.parametrize("arch,f32_leaf", [
    ("recurrentgemma-9b", "params//periods//slot0//seq//lam"),
    ("granite-moe-3b-a800m", "params//periods//slot0//mix//router"),
])
def test_zoo_checkpoints_cross_restore(tmp_path, arch, f32_leaf):
    """A bfloat16 smoke tree with float32 leaves (RG-LRU's ``lam``, the MoE
    router) saved by the port's ``CheckpointManager`` restores in the
    reference's with the same names, dtypes and values, and a checkpoint
    of the reference's restores in the port exactly as in the reference
    (whose own bfloat16 leaves come back as it writes them, queue C)."""
    r_cfg, _ = _configs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    p_ref = _ref_params(r_cfg, seed=2)
    tree = params_from_reference(p_ref, "cpu")
    mgr = CheckpointManager(str(tmp_path / "port"), device="cpu")
    mgr.save(1, tree)
    with open(os.path.join(tmp_path, "port", "store", "meta.json")) as f:
        dtypes = json.load(f)["models"]["ckpt-1"]["architecture"]["dtypes"]
    assert dtypes[f32_leaf] == "float32" and dtypes["params//embed"] == "bfloat16"
    _, want = RCheckpointManager(str(tmp_path / "port")).restore(1)
    _, got = mgr.restore(1)
    _assert_same_trees(got["params"], want["params"])
    # Against the saved tree: the store reconstructs within 2^-23, and a
    # bfloat16 leaf is the bfloat16 nearest that (chip_smoke's RESTORE_ATOL).
    g, w = _flat_np(got["params"]), _flat_np(tree)
    for key in w:
        assert g[key][1] == w[key][1], key
        np.testing.assert_allclose(g[key][0], w[key][0], rtol=0, atol=2.0 ** -22, err_msg=key)

    r_mgr = RCheckpointManager(str(tmp_path / "ref"))
    r_mgr.save(1, p_ref)
    _, want = r_mgr.restore(1)
    _, got = CheckpointManager(str(tmp_path / "ref"), device="cpu").restore(1)
    _assert_same_trees(got["params"], want["params"])


def test_every_arch_builds_and_decodes_in_the_port():
    """``init_params``, ``forward``, ``loss_fn``, ``init_cache`` and
    ``decode_step`` run for every smoke config on the CPU, with finite
    outputs (decode where the config has it)."""
    from repro_torch.configs import list_archs

    for arch in list_archs():
        cfg = get_config(arch, smoke=True)
        params = init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        if cfg.frontend == "embeddings":
            batch = {"embeds": torch.from_numpy(rng.normal(0, 1, (1, 32, cfg.d_model))
                                                .astype(np.float32))}
        else:
            batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32)))}
        batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32)))
        with torch.no_grad():
            assert torch.isfinite(forward(params, batch, cfg)).all(), arch
            assert torch.isfinite(loss_fn(params, batch, cfg)[0]), arch
            if cfg.has_decode:
                cache = init_cache(cfg, 1, 4, device="cpu")
                logits, _ = decode_step(params, cache, {"tokens": torch.zeros((1, 1),
                                                                              dtype=torch.int64)},
                                        0, cfg)
                assert torch.isfinite(logits).all(), arch


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_profile_steps_traces_a_recurrent_prefill(capsys, arch):
    """``profile_steps --arch`` traces the prefill and serve windows of a
    recurrent model (its SMOKE size on the CPU: no kernel runs, so every
    device share is 0) and reports the busy time's split into attention,
    GEMMs, the recurrent scans and the rest."""
    from repro_torch.launch import profile_steps

    out = profile_steps.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["arch"] == get_config(arch, smoke=True).name
    w = out["prefill"]
    assert w["plain_wall_ms"] > 0 and w["host_ops"] > 0 and w["device_busy_ms"] == 0.0
    assert sorted(w["shares"]) == ["attention", "gemm", "other", "scan"]
    assert sorted(w["ranges_ms"]) == sorted(profile_steps.SCAN_RANGES)
    assert out["serve"]["steps"] == 2
