"""The port's model stack against the reference's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
reference's parameters (``repro.models.init_params``) are carried into the
port with ``params_from_reference``. The reference's Pallas flash-attention
kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it. Each
test states its tolerance: float32 comparisons differ only in the order of
float32 sums; bfloat16 is looser because the two frameworks round to
bfloat16 at different places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.models import decode_step as r_decode_step
from repro.models import forward as r_forward
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models import layers as r_layers
from repro.models import loss_fn as r_loss_fn
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    layers,
    loss_fn,
    params_from_reference,
)

DENSE = ["internlm2-1.8b", "qwen3-8b", "glm4-9b", "deepseek-67b", "llava-next-34b",
         "hubert-xlarge"]
F32 = dict(rtol=1e-4, atol=2e-5)   # the reference's attention tolerance


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(rng, b, sq, sk, h, kv, dh):
    return (rng.normal(0, 1, (b, sq, h, dh)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, dh)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, dh)).astype(np.float32))


# ------------------------------------------------------------ flash attention
# The shapes of tests/test_kernels.py (test_flash_attention_vs_ref and
# _non_causal_padded_keys), the longer ones halved for interpret mode.
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", [
    (2, 128, 128, 8, 4, 64, True, 0),
    (1, 128, 128, 4, 1, 128, True, 64),   # MQA + window
    (2, 128, 128, 8, 8, 64, False, 0),    # bidirectional (hubert)
    (1, 100, 128, 8, 2, 64, True, 0),     # ragged Sq
    (1, 192, 192, 8, 8, 80, False, 0),    # hubert head dim
    (1, 37, 37, 4, 2, 64, False, 0),      # ragged, not block aligned
    (2, 50, 100, 8, 4, 32, False, 0),
    (1, 100, 50, 4, 4, 64, False, 0),     # q longer than k
    (1, 128, 128, 4, 1, 256, True, 32),   # dh 256 (recurrentgemma): MQA + window
    (2, 64, 64, 4, 2, 256, True, 0),      # dh 256: GQA, causal
    (1, 37, 50, 4, 4, 256, False, 0),     # dh 256: keys padded to the block
    (1, 96, 96, 8, 1, 256, True, 16),     # dh 256: MQA, a window shorter than a block
])
def test_flash_attention_plain_matches_reference_and_pallas(b, sq, sk, h, kv, dh, causal, window):
    rng = np.random.default_rng(sq * 7 + sk + h + dh)
    q, k, v = _qkv(rng, b, sq, sk, h, kv, dh)
    want = np.asarray(r_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                causal=causal, window=window))
    pallas = np.asarray(r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal, window=window, interpret=True))
    plain = t_ref.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    before = t_ops.launch_counts()["flash_attention"]
    wrapped = t_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert t_ops.launch_counts()["flash_attention"] == before  # CPU: plain version
    np.testing.assert_allclose(plain.numpy(), want, **F32)
    np.testing.assert_allclose(plain.numpy(), pallas, **F32)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


def test_flash_attention_key_length_mask_matches_padded_reference():
    """``sk_true`` masks the tail keys as the reference kernel does for its
    zero padding: same result as attending over the unpadded keys."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 40, 64, 4, 2, 32)
    got = t_fa.flash_attention(_t(q), _t(k), _t(v), causal=False, sk_true=45)
    want = r_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k[:, :45]),
                                     jnp.asarray(v[:, :45]), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    seam = t_ops.flash_attention(_t(q), _t(k), _t(v), causal=False, sk_true=45)
    np.testing.assert_array_equal(seam.numpy(), got.numpy())


@pytest.mark.parametrize("causal,window,chunk,q_offset,sk", [
    (True, 0, 32, 0, 128),
    (True, 24, 64, 0, 128),
    (False, 0, 32, 0, 96),
    (True, 0, 16, 64, 128),     # a query block at an offset into the keys
])
def test_chunked_attention_matches_reference(causal, window, chunk, q_offset, sk):
    rng = np.random.default_rng(chunk + sk + window)
    sq = sk - q_offset
    q, k, v = _qkv(rng, 2, sq, sk, 8, 2, 32)
    want = r_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, window=window, chunk=chunk,
                                      q_offset=q_offset)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                   chunk=chunk, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if q_offset == 0:
        flat = t_ref.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), **F32)


def test_chunked_attention_refuses_ragged_chunks():
    x = torch.zeros((1, 10, 2, 32))
    with pytest.raises(ValueError):
        layers.chunked_attention(x, x, x, causal=True, chunk=4)


# ------------------------------------------------------------------- layers
def test_rms_norm_and_split_half_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 9, 4, 32)).astype(np.float32)
    gamma = rng.normal(1, 0.1, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 109), (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(gamma), 1e-6).numpy(),
        np.asarray(r_layers.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), _t(pos), 10_000.0).numpy(),
        np.asarray(r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-5, atol=1e-5)


def _ref_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("window,qk_norm,causal", [(0, False, True), (0, True, True),
                                                   (6, False, True), (0, False, False)])
def test_attention_block_forward_and_decode_match_reference(window, qk_norm, causal):
    kw = dict(n_heads=4, n_kv_heads=2, d_head=16, rope_theta=10_000.0, causal=causal,
              window=window, qk_norm=qk_norm, chunk=8)
    r_blk = r_layers.AttentionBlock(**kw)
    blk = layers.AttentionBlock(**kw)
    p_ref = _ref_tree(r_blk.init(jax.random.PRNGKey(3), 32, jnp.float32))
    if qk_norm:  # non-trivial gains
        rng = np.random.default_rng(0)
        p_ref["q_norm"] = rng.normal(1, 0.2, 16).astype(np.float32)
        p_ref["k_norm"] = rng.normal(1, 0.2, 16).astype(np.float32)
    p = params_from_reference(p_ref, "cpu")
    x = np.random.default_rng(4).normal(0, 1, (2, 16, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    want = r_blk.forward(p_ref, jnp.asarray(x), jnp.asarray(pos))
    got = blk.forward(p, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if not causal:
        return
    r_cache = r_blk.init_cache(2, 16, jnp.float32)
    cache = blk.init_cache(2, 16, torch.float32, "cpu")
    assert tuple(cache["k"].shape) == tuple(r_cache["k"].shape)
    for t in range(12):
        xt = x[:, t:t + 1]
        w_out, r_cache = r_blk.decode(p_ref, jnp.asarray(xt), r_cache, jnp.int32(t))
        g_out, cache = blk.decode(p, _t(xt), cache, t)
        np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), **F32)
        np.testing.assert_allclose(g_out.numpy(), got[:, t:t + 1].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(r_cache["k"]), **F32)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlps_match_reference(kind):
    r_cls, cls = ((r_layers.SwiGLU, layers.SwiGLU) if kind == "swiglu"
                  else (r_layers.GeluMLP, layers.GeluMLP))
    p_ref = _ref_tree(r_cls(48).init(jax.random.PRNGKey(1), 32, jnp.float32))
    x = np.random.default_rng(2).normal(0, 1, (2, 5, 32)).astype(np.float32)
    got = cls(48).forward(params_from_reference(p_ref, "cpu"), _t(x))
    want = r_cls(48).forward(p_ref, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- whole models
def _batch(cfg, rng, b=2, s=32):
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.frontend == "embeddings":
        return {"embeds": rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)), "labels": labels}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _check_model(r_cfg, cfg, *, fwd_tol, dec_tol, steps=4):
    p_ref = _ref_tree(r_init_params(r_cfg, jax.random.PRNGKey(0)))
    params = params_from_reference(p_ref, "cpu")
    jbatch, tbatch = _both(_batch(cfg, np.random.default_rng(7)))
    want = np.asarray(r_forward(p_ref, jbatch, r_cfg).astype(jnp.float32))
    got = forward(params, tbatch, cfg).to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, **fwd_tol)
    r_loss, _ = r_loss_fn(p_ref, jbatch, r_cfg)
    loss, metrics = loss_fn(params, tbatch, cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), **fwd_tol)
    assert metrics["tokens"] == 2 * 32
    if not cfg.has_decode:
        return
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, steps))
    r_cache = r_init_cache(r_cfg, 2, 16)
    cache = init_cache(cfg, 2, 16, device="cpu")
    for t in range(steps):
        w, r_cache = r_decode_step(p_ref, r_cache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                   jnp.int32(t), r_cfg)
        g, cache = decode_step(params, cache, {"tokens": _t(toks[:, t:t + 1])}, t, cfg)
        assert tuple(g.shape) == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w.astype(jnp.float32)), **dec_tol)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_model_matches_reference_f32(arch):
    """float32 smoke configs: logits, loss and decode steps, at rtol 1e-4 /
    atol 2e-5 (float32 sums in another order)."""
    _check_model(r_get_config(arch, smoke=True), get_config(arch, smoke=True),
                 fwd_tol=F32, dec_tol=F32)


def test_dense_smoke_model_matches_reference_bf16():
    """internlm2 smoke in bfloat16 (params and compute): every matmul output
    is rounded to bfloat16 (8 significant bits, relative step 2^-8..2^-7),
    at places that differ between XLA and PyTorch; through 2 layers the
    logits (|x| ~ 1) agree to a few bfloat16 steps: atol 6e-2, rtol 3e-2."""
    tol = dict(rtol=3e-2, atol=6e-2)
    r_cfg = dataclasses.replace(r_get_config("internlm2-1.8b", smoke=True),
                                param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    _check_model(r_cfg, cfg, fwd_tol=tol, dec_tol=tol)


def test_init_params_has_the_reference_tree():
    """All ten architectures: the reference's keys, shapes and dtypes
    (float32 ``lam``, ``u`` and MoE routers inside bfloat16 trees)."""
    for arch in list_archs():
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype)
            r_cfg = dataclasses.replace(r_get_config(arch, smoke=True), param_dtype=dtype)
            ref_shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                                      jax.eval_shape(lambda k, c=r_cfg: r_init_params(c, k),
                                                     jax.random.PRNGKey(0)))
            got = init_params(cfg, seed=1, device="cpu")
            got_shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                                      got)
            assert got_shapes == ref_shapes, (arch, dtype)


def test_param_counts_match_published():
    """The published parameter counts (tests/test_archs.py) through the
    port's configs, equal to the reference configs' counts."""
    expect = {
        "deepseek-67b": (67e9, 0.05),
        "arctic-480b": (480e9, 0.05),
        "qwen3-8b": (8.2e9, 0.1),
        "glm4-9b": (9.4e9, 0.1),
        "rwkv6-7b": (7.6e9, 0.1),
        "llava-next-34b": (34e9, 0.05),
        "internlm2-1.8b": (1.9e9, 0.1),
    }
    for arch, (n, tol) in expect.items():
        got = get_config(arch).n_params
        assert abs(got - n) / n < tol, (arch, got, n)
    for arch in list_archs():
        for smoke in (False, True):
            cfg, r_cfg = get_config(arch, smoke), r_get_config(arch, smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(r_cfg)
            assert (cfg.n_params, cfg.n_active_params) == (r_cfg.n_params,
                                                           r_cfg.n_active_params)


def test_entry_points_default_to_the_card():
    cfg = get_config("internlm2-1.8b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 4)
