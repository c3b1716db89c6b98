"""``loss_fn``'s gradients for the rest of the model zoo against the
reference's, on the CPU: the recurrentgemma, rwkv6, granite-moe and arctic
smoke configs, with and without remat (the RG-LRU scan, the RWKV-6 chunk
loop and the MoE's scatter and gather differentiated by autograd against
``jax.value_and_grad``). Kept apart from ``tests/test_torch_zoo.py`` so the
two files run on two workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro_torch.configs import get_config
from repro_torch.models import loss_fn, params_from_reference

ZOO = ["recurrentgemma-9b", "rwkv6-7b", "granite-moe-3b-a800m", "arctic-480b"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(arch, **changes):
    return (dataclasses.replace(r_get_config(arch, smoke=True), **changes),
            dataclasses.replace(get_config(arch, smoke=True), **changes))


def _ref_params(r_cfg, seed=0):
    return jax.tree.map(np.asarray, r_init_params(r_cfg, jax.random.PRNGKey(seed)))


def _batch(cfg, rng, b=2, s=32):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_loss_fn_value_and_grad_match_reference(arch, remat):
    """``loss_fn`` and its gradient with respect to every parameter against
    ``jax.value_and_grad`` of the reference's, with and without remat:
    rtol 1e-4 / atol 1e-6, as for the dense models
    (tests/test_torch_train.py)."""
    r_cfg, cfg = _configs(arch, remat=remat)
    p_ref = _ref_params(r_cfg, seed=1)
    batch = _batch(cfg, np.random.default_rng(11))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    r_loss, r_grads = jax.value_and_grad(lambda p: r_loss_fn(p, jbatch, r_cfg)[0])(p_ref)
    params = params_from_reference(p_ref, "cpu")
    leaves = []
    jax.tree.map(lambda t: leaves.append(t.requires_grad_(True)), params)
    loss, _ = loss_fn(params, {k: _t(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-4, atol=1e-6)
    want = jax.tree.leaves(r_grads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
