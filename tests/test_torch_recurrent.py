"""The port's recurrent blocks (RG-LRU, RWKV-6 time and channel mix) against
the reference's, on the CPU.

Parameters come from the reference's ``init`` and are carried across with
``params_from_reference``; inputs and incoming states are made with numpy
from a seed. Everything is float32 and held at rtol 1e-4 / atol 2e-5 (the
reference's attention tolerance): the two packages differ only in the order
of float32 sums (and RG-LRU's scan in its association: the reference's
``associative_scan`` tree against the port's doubling passes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as r_rec
from repro_torch.models import params_from_reference, recurrent

F32 = dict(rtol=1e-4, atol=2e-5)
D_MODEL = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _ref_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=F32):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _state_to_port(state):
    return {k: _t(v) for k, v in state.items()}


# -------------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_state_and_decode_match_reference(with_state):
    """Forward over 16 tokens (from zero state, or folding in an incoming
    h and conv carry), its final state, then 5 decode steps from it."""
    r_blk, blk = r_rec.RGLRUBlock(d_rnn=48), recurrent.RGLRUBlock(d_rnn=48)
    p_ref = _ref_tree(r_blk.init(jax.random.PRNGKey(2), D_MODEL, jnp.float32))
    p = params_from_reference(p_ref, "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 16, D_MODEL)).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rng.normal(0, 1, (2, 48)).astype(np.float32),
                 "conv": rng.normal(0, 1, (2, 3, 48)).astype(np.float32)}
    r_out, r_state = r_blk.forward(p_ref, jnp.asarray(x),
                                   None if state is None else jax.tree.map(jnp.asarray, state))
    out, new_state = blk.forward(p, _t(x), None if state is None else _state_to_port(state))
    _close(out, r_out)
    _close(new_state, r_state)
    assert new_state["h"].dtype == torch.float32
    cache = {k: v.clone() for k, v in new_state.items()}
    xs = rng.normal(0, 1, (5, 2, 1, D_MODEL)).astype(np.float32)
    for xt in xs:
        r_y, r_state = r_blk.decode(p_ref, jnp.asarray(xt), r_state)
        y, same = blk.decode(p, _t(xt), cache)
        assert same is cache  # written in place
        _close(y, r_y)
        _close(cache, r_state)


def test_rglru_decode_continues_the_forward():
    """A forward over 12 tokens equals a forward over the first 8 and 4 decode
    steps from its state: the state carries everything."""
    blk = recurrent.RGLRUBlock(d_rnn=40)
    gen = torch.Generator().manual_seed(0)
    p = blk.init(gen, D_MODEL, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 12, D_MODEL))
                         .astype(np.float32))
    full, _ = blk.forward(p, x)
    _, state = blk.forward(p, x[:, :8])
    for t in range(8, 12):
        y, state = blk.decode(p, x[:, t:t + 1], state)
        np.testing.assert_allclose(y.numpy(), full[:, t:t + 1].numpy(), **F32)


@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_rglru_scan_matches_a_sequential_loop(s):
    """The doubling scan against h_t = exp(log_a_t) h_{t-1} + b_t step by
    step, lengths that are and are not powers of two."""
    rng = np.random.default_rng(s)
    log_a = torch.from_numpy(-rng.uniform(0.01, 3.0, (2, s, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, s, 8)).astype(np.float32))
    got = recurrent.RGLRUBlock._scan(log_a, b)
    h, want = torch.zeros(2, 8), []
    for t in range(s):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, dim=1).numpy(), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------- RWKV6
@pytest.mark.parametrize("s", [32, 64, 8])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_time_mix_forward_state_and_decode_match_reference(s, with_state):
    """Chunked forward at S = 32 (one chunk), 64 (two) and 8 (a short prompt,
    one chunk of 8), from zero or an incoming state; then 4 decode steps."""
    kw = dict(n_heads=2, d_head=16)
    r_blk, blk = r_rec.RWKV6TimeMix(**kw), recurrent.RWKV6TimeMix(**kw)
    p_ref = _ref_tree(r_blk.init(jax.random.PRNGKey(5), D_MODEL, jnp.float32))
    p = params_from_reference(p_ref, "cpu")
    rng = np.random.default_rng(6 + s)
    x = rng.normal(0, 1, (2, s, D_MODEL)).astype(np.float32)
    state = None
    if with_state:
        state = {"wkv": rng.normal(0, 0.5, (2, 2, 16, 16)).astype(np.float32),
                 "shift_tm": rng.normal(0, 1, (2, D_MODEL)).astype(np.float32)}
    r_out, r_state = r_blk.forward(p_ref, jnp.asarray(x),
                                   None if state is None else jax.tree.map(jnp.asarray, state))
    out, new_state = blk.forward(p, _t(x), None if state is None else _state_to_port(state))
    _close(out, r_out)
    _close(new_state, r_state)
    cache = {k: v.clone() for k, v in new_state.items()}
    for xt in rng.normal(0, 1, (4, 2, 1, D_MODEL)).astype(np.float32):
        r_y, r_state = r_blk.decode(p_ref, jnp.asarray(xt), r_state)
        y, same = blk.decode(p, _t(xt), cache)
        assert same is cache
        _close(y, r_y)
        _close(cache, r_state)


def test_rwkv6_time_mix_refuses_a_ragged_chunk():
    blk = recurrent.RWKV6TimeMix(n_heads=2, d_head=16)
    p = blk.init(torch.Generator().manual_seed(0), D_MODEL, torch.float32, "cpu")
    with pytest.raises(ValueError, match="chunk"):
        blk.forward(p, torch.zeros((1, 40, D_MODEL)))


def test_rwkv6_norm_uses_the_population_variance():
    """``_norm_out`` normalises each head by its population variance
    (``jnp.var``, ddof 0): a head whose values are (1, -1, ..., 1, -1)
    comes out unchanged, where the unbiased variance would shrink it."""
    blk = recurrent.RWKV6TimeMix(n_heads=1, d_head=4)
    p = {"ln_w": torch.ones(4), "wo": torch.eye(4)}
    y = torch.tensor([[[1.0, -1.0, 1.0, -1.0]]])
    out = blk._norm_out(p, y, torch.ones(1, 1, 4), 1, 1)
    np.testing.assert_allclose(out.numpy(), y.numpy() / np.sqrt(1 + 1e-5), rtol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_matches_reference(with_state):
    r_blk, blk = r_rec.RWKV6ChannelMix(d_ff=64), recurrent.RWKV6ChannelMix(d_ff=64)
    p_ref = _ref_tree(r_blk.init(jax.random.PRNGKey(7), D_MODEL, jnp.float32))
    p = params_from_reference(p_ref, "cpu")
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 9, D_MODEL)).astype(np.float32)
    state = ({"shift_cm": rng.normal(0, 1, (2, D_MODEL)).astype(np.float32)}
             if with_state else None)
    r_out, r_state = r_blk.forward(p_ref, jnp.asarray(x),
                                   None if state is None else jax.tree.map(jnp.asarray, state))
    out, new_state = blk.forward(p, _t(x), None if state is None else _state_to_port(state))
    _close(out, r_out, dict(rtol=1e-5, atol=1e-6))
    _close(new_state, r_state)
    cache = {k: v.clone() for k, v in new_state.items()}
    xt = rng.normal(0, 1, (2, 1, D_MODEL)).astype(np.float32)
    r_y, r_state = r_blk.decode(p_ref, jnp.asarray(xt), r_state)
    y, same = blk.decode(p, _t(xt), cache)
    assert same is cache
    _close(y, r_y, dict(rtol=1e-5, atol=1e-6))
    _close(cache, r_state)


@pytest.mark.parametrize("cls,args", [("RGLRUBlock", dict(d_rnn=24)),
                                      ("RWKV6TimeMix", dict(n_heads=2, d_head=16)),
                                      ("RWKV6ChannelMix", dict(d_ff=40))])
def test_recurrent_init_has_the_reference_tree(cls, args):
    """Stacked over a period axis of 3: the reference's keys, shapes and
    dtypes (``lam`` and ``u`` float32 in a bfloat16 tree)."""
    r_blk, blk = getattr(r_rec, cls)(**args), getattr(recurrent, cls)(**args)
    want = jax.eval_shape(jax.vmap(lambda k: r_blk.init(k, D_MODEL, jnp.bfloat16)),
                          jax.random.split(jax.random.PRNGKey(0), 3))
    got = blk.init(torch.Generator().manual_seed(0), D_MODEL, torch.bfloat16, "cpu", (3,))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).split(".")[1] == str(want[key].dtype), key
