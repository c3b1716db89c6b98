"""The port's routed-expert layer (``MoE``) against the reference's, on the CPU.

Parameters come from the reference's ``init`` and are carried across with
``params_from_reference``; inputs are made with numpy from a seed. float32,
rtol 1e-4 / atol 2e-5: the routing (float32 router, softmax, top-k,
per-row cumsum positions, capacity) is integer-exact on both sides for
these inputs, and the expert products differ only in the order of float32
sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro_torch.models import layers, params_from_reference

F32 = dict(rtol=1e-4, atol=2e-5)
D_MODEL = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cf, dense, e=8, k=2):
    kw = dict(d_ff=48, n_experts=e, top_k=k, capacity_factor=cf, dense_residual=dense)
    r_moe, moe = r_layers.MoE(**kw), layers.MoE(**kw)
    p_ref = jax.tree.map(np.asarray, r_moe.init(jax.random.PRNGKey(int(cf * 10) + dense),
                                                D_MODEL, jnp.float32))
    return r_moe, moe, p_ref, params_from_reference(p_ref, "cpu")


def _dropped(moe, p, x):
    """Routed (token, choice) pairs past their expert's capacity."""
    _, dest, cap = moe.route(p, x)
    return int((dest == moe.n_experts * cap).sum())


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_matches_reference(cf, dense):
    """At the smoke configs' capacity factor 8.0 no token drops; at 1.0 (4
    slots an expert a row of 16 tokens, top 2 of 8) some do, and the
    dropped ones must be the reference's: its output is matched either way.
    With and without the dense SwiGLU residual (arctic)."""
    r_moe, moe, p_ref, p = _pair(cf, dense)
    x = np.random.default_rng(3).normal(0, 1, (2, 16, D_MODEL)).astype(np.float32)
    want = r_moe.forward(p_ref, jnp.asarray(x))
    got = moe.forward(p, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    dropped = _dropped(moe, p, _t(x))
    assert (dropped == 0) if cf == 8.0 else (dropped > 0), dropped


def test_moe_capacity_is_the_references():
    for s in (1, 7, 16, 2048):
        for e, k, cf in ((40, 8, 1.25), (128, 2, 1.25), (8, 2, 8.0)):
            moe = layers.MoE(16, e, k, cf)
            assert moe.capacity(s) == max(int(cf * k * s / e), k), (s, e, k, cf)


def test_moe_route_keeps_first_come_within_a_row():
    """Positions follow the flattened (token, choice) order of each row: of
    the pairs routed to one expert, the first ``cap`` keep their slots
    0 .. cap - 1 and the rest go to the overflow row; rows do not share
    slots."""
    _, moe, _, p = _pair(1.0, False)
    x = _t(np.random.default_rng(4).normal(0, 1, (2, 16, D_MODEL)).astype(np.float32))
    gates, dest, cap = moe.route(p, x)
    _, top_e = torch.topk(torch.softmax(x @ p["router"], dim=-1), moe.top_k, dim=-1)
    flat = top_e.reshape(2, -1)
    for row in range(2):
        seen: dict[int, int] = {}
        for j, e in enumerate(flat[row].tolist()):
            n = seen.get(e, 0)
            want = e * cap + n if n < cap else moe.n_experts * cap
            assert int(dest[row, j]) == want
            seen[e] = n + 1
    np.testing.assert_allclose(gates.reshape(2, 16, -1).sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_gradients_match_reference():
    """d(sum of outputs · a fixed random tensor) with respect to every
    parameter and the input, at a capacity that drops tokens, against
    ``jax.grad`` (rtol 1e-4 / atol 1e-6)."""
    r_moe, moe, p_ref, p = _pair(1.0, True)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 16, D_MODEL)).astype(np.float32)
    w = rng.normal(0, 1, (2, 16, D_MODEL)).astype(np.float32)

    def r_obj(params, xx):
        return jnp.sum(r_moe.forward(params, xx) * w)

    r_gp, r_gx = jax.grad(r_obj, argnums=(0, 1))(p_ref, jnp.asarray(x))
    leaves = jax.tree.leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    obj = (moe.forward(p, xt) * _t(w)).sum()
    grads = torch.autograd.grad(obj, leaves + [xt])
    for g, want in zip(grads, jax.tree.leaves(r_gp) + [r_gx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
