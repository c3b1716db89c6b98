"""Delta-compressed checkpointing: round trip, delta across steps, restart,
async save, flexible-bit restore.

The unsharded cases of the reference suite ``tests/test_checkpoint.py``
held against the port: imports on ``repro_torch``, parameter trees of
tensors from the port's ``init_params``, every manager made with
``device="cpu"`` (the port's entry points default to the card). The
reference's gradient-compression and cross-pod cases are re-pointed in
``tests/test_torch_grad_compression.py`` and its elastic restore in
``tests/test_torch_sharded_steps.py``.
"""

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_map

SEED = 0


def _leaves(tree, path=()):
    """(path, leaf) pairs in path order, as ``jax.tree_util`` walks a tree:
    dict keys sorted, list items by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, path + (i,))]
    return [(path, tree)]


def _small_state():
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = init_params(cfg, SEED, device="cpu")
    opt = adamw_init(params)
    return cfg, params, opt


def test_checkpoint_roundtrip(tmp_path):
    cfg, params, opt = _small_state()
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(10, params, opt)
    step, state = mgr.restore()
    assert step == 10
    for (pa, a), (pb, b) in zip(_leaves(params), _leaves(state["params"]), strict=True):
        assert pa == pb
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=2 ** -23, rtol=0)
    assert int(state["opt"]["step"]) == int(opt["step"])


def test_checkpoint_delta_compression_across_steps(tmp_path):
    """Consecutive checkpoints delta-encode against each other: step 2+
    pages must be much smaller than step 1 (the paper's mechanism applied
    to training)."""
    cfg, params, opt = _small_state()
    mgr = CheckpointManager(str(tmp_path), tolerance=1e-6, device="cpu")
    mgr.save(0, params)
    assert "ckpt-0" in mgr.engine._meta["models"]
    # Simulate a few optimizer steps: small drift.
    for step in (1, 2):
        gen = torch.Generator().manual_seed(step)
        params = tree_map(
            lambda p: p + 1e-4 * torch.randn(p.shape, generator=gen).to(p.dtype)
            if p.is_floating_point() else p, params)
        mgr.save(step, params)
    rep = mgr.storage_report()
    m0 = mgr._manifest["meta_0"]
    m2 = mgr._manifest["meta_2"]
    assert m2["new_bases"] == 0, "drifted ckpt must reuse previous bases"
    assert m2["page_bytes"] < 0.6 * m0["original_bytes"]
    assert rep["compression_ratio"] > 1.5


def test_restart_after_simulated_crash(tmp_path):
    cfg, params, opt = _small_state()
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(5, params, opt)
    # Crash mid-save of step 6: write garbage page without manifest commit.
    with open(mgr.engine._page_path(999), "wb") as f:
        f.write(b"partial garbage")
    del mgr
    mgr2 = CheckpointManager(str(tmp_path), device="cpu")
    assert mgr2.latest_step() == 5
    step, state = mgr2.restore()
    assert step == 5 and state["params"] is not None


def test_async_save(tmp_path):
    cfg, params, opt = _small_state()
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(1, params, opt, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_flexible_bit_restore(tmp_path):
    """bits=8 restore: approximate params, bounded deviation (fast eval
    replica spin-up per paper §4.3.1)."""
    cfg, params, opt = _small_state()
    mgr = CheckpointManager(str(tmp_path), tolerance=2 ** -24, device="cpu")
    mgr.save(0, params)
    _, exact = mgr.restore()
    _, approx = mgr.restore(bits=8)
    for (pa, a), (pb, b) in zip(_leaves(exact["params"]), _leaves(approx["params"]),
                                strict=True):
        assert pa == pb
        diff = (a.double() - b.double()).abs()
        assert float(diff.mean()) < 1e-3
