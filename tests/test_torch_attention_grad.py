"""The port's attention backward against the reference's autodiff, on the CPU.

The reference has no backward kernel: its ``loss_fn`` differentiates plain
``repro.models.layers.chunked_attention`` through XLA autodiff. So the
port's ``FlashAttentionFn`` (on CPU tensors: the plain forward and
``ref.flash_attention_backward``) is held against ``jax.vjp`` of that
function, with the same cotangent, at rtol 1e-4 / atol 2e-5: the
reference kernel tests' own tolerance (float32 sums in another order).
Inputs are made with numpy from a seed.

``test_kernel_route_keeps_the_gradient_to_wq`` pins a fault of the port's
first attention seam: on CUDA tensors the kernel wrote a fresh tensor that
autograd did not know, so everything below the attention (``wq``, ``wk``,
``wv``) silently got no gradient. It runs the seam's kernel branch on the
CPU with a fake kernel library that writes the wrapper's fresh
``torch.empty`` output, as the kernel does;
``tests/test_torch_cuda.py`` runs the same check on the card.
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import layers, params_from_reference

F32 = dict(rtol=1e-4, atol=2e-5)   # the reference's attention tolerance


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _inputs(seed, b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, h, dh)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, dh)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, dh)).astype(np.float32),
            rng.normal(0, 1, (b, sq, h, dh)).astype(np.float32))


def _jax_vjp(q, k, v, do, *, causal, window, chunk):
    """(o, dq, dk, dv) of the reference's chunked_attention by jax.vjp."""
    fn = lambda q_, k_, v_: r_layers.chunked_attention(  # noqa: E731
        q_, k_, v_, causal=causal, window=window, chunk=chunk)
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o),) + tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _port(q, k, v, do, **masks):
    """(o, dq, dk, dv) through the port's FlashAttentionFn on CPU tensors."""
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = t_fa.flash_attention(tq, tk, tv, **masks)
    assert o.grad_fn is not None
    o.backward(_t(do))
    return o.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("chunk", [None, 24])
def test_attention_backward_matches_jax_vjp(group, causal, window, dh, chunk, monkeypatch):
    """Grouped GQA (G = 1, 2), causal / bidirectional / local window, dh 32
    and 64; the backward over one key chunk (the default, 256) and over
    chunks of 24 keys (the last one ragged, and under a causal mask each
    with only the rows that see it)."""
    if chunk is not None:
        monkeypatch.setattr(t_ref, "BACKWARD_CHUNK", chunk)
    kv = 2
    q, k, v, do = _inputs(dh + 3 * group + window, 2, 64, 64, kv * group, kv, dh)
    want = _jax_vjp(q, k, v, do, causal=causal, window=window, chunk=16)
    got = _port(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)


@pytest.mark.parametrize("causal,group,chunk", [(True, 2, 16), (False, 1, 16),
                                                (False, 2, 512)])
def test_attention_backward_keys_past_sk_true(causal, group, chunk):
    """Keys at or past ``sk_true`` are masked: the gradients of the kept keys
    and of q equal jax.vjp of chunked_attention over the first ``sk_true``
    keys alone (one chunk: 45 is ragged), and those of the masked keys are
    exactly 0. Sk = 70 leaves a ragged last chunk of the port's backward."""
    sk_true, kv = 45, 2
    q, k, v, do = _inputs(7 + group, 1, 40, 70, kv * group, kv, 32)
    want = _jax_vjp(q, k[:, :sk_true], v[:, :sk_true], do, causal=causal, window=0,
                    chunk=sk_true)
    o = t_ref.flash_attention(_t(q), _t(k), _t(v), causal=causal, sk_true=sk_true)
    dq, dk, dv = t_ref.flash_attention_backward(_t(q), _t(k), _t(v), _t(do), causal=causal,
                                                sk_true=sk_true, chunk=chunk)
    np.testing.assert_allclose(o.numpy(), want[0], **F32)
    np.testing.assert_allclose(dq.numpy(), want[1], **F32)
    np.testing.assert_allclose(dk[:, :sk_true].numpy(), want[2], **F32)
    np.testing.assert_allclose(dv[:, :sk_true].numpy(), want[3], **F32)
    assert not dk[:, sk_true:].any() and not dv[:, sk_true:].any()
    seam = _port(q, k, v, do, causal=causal, sk_true=sk_true)
    for g, w in zip(seam[1:], (dq, dk, dv)):
        np.testing.assert_allclose(g, w.numpy(), **F32)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (37, 37, True, 0),       # Sk not a multiple of any chunk
    (50, 100, False, 0),     # fewer queries than keys
    (100, 50, False, 10),    # rows 59.. see no key: a uniform softmax over all keys
    (33, 33, True, 5),       # a causal window over a ragged length
])
def test_attention_backward_ragged_sk(sq, sk, causal, window):
    """Any Sk: the reference's scan takes it in one chunk (chunk = Sk); the
    port's backward in chunks of 16 keys, the last one short."""
    q, k, v, do = _inputs(sq + sk, 2, sq, sk, 4, 2, 32)
    want = _jax_vjp(q, k, v, do, causal=causal, window=window, chunk=sk)
    got = t_ref.flash_attention_backward(_t(q), _t(k), _t(v), _t(do), causal=causal,
                                         window=window, chunk=16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32)
    seam = _port(q, k, v, do, causal=causal, window=window)
    np.testing.assert_allclose(seam[0], want[0], **F32)
    for name, g, w in zip(("dq", "dk", "dv"), seam[1:], want[1:]):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)


def test_attention_backward_returns_the_inputs_dtypes():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(3, 1, 16, 16, 4, 2, 32))
    grads = t_ref.flash_attention_backward(q, k, v, do, causal=True)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def _block_and_params(seed):
    kw = dict(n_heads=4, n_kv_heads=2, d_head=32, rope_theta=10_000.0, causal=True, chunk=16)
    r_blk = r_layers.AttentionBlock(**kw)
    p_ref = jax.tree.map(np.asarray, r_blk.init(jax.random.PRNGKey(seed), 48, jnp.float32))
    return r_blk, layers.AttentionBlock(**kw), p_ref


class _FakeKernelLibrary:
    """Stands in for the built kernel library: ``flash_attention_fwd``
    writes the plain output of the registered q, k, v through the output's
    pointer, as the CUDA kernel writes into the wrapper's fresh
    ``torch.empty``."""

    def __init__(self):
        self.tensors, self.calls = {}, 0

    def flash_attention_fwd(self, q_ptr, k_ptr, v_ptr, o_ptr, *args):
        q, k, v = (self.tensors[p] for p in (q_ptr, k_ptr, v_ptr))
        causal, window, sk_true = args[15:18]
        out = t_ref.flash_attention(q.detach(), k.detach(), v.detach(), causal=bool(causal),
                                    window=window, sk_true=sk_true).contiguous()
        ctypes.memmove(o_ptr, out.data_ptr(), out.numel() * out.element_size())
        self.calls += 1
        return 0


def test_kernel_route_keeps_the_gradient_to_wq(monkeypatch):
    """The seam's kernel branch on the CPU: ``_on_cpu`` says no and the
    built library is a fake that writes the output into the wrapper's fresh
    ``torch.empty`` (autograd does not see the write), as the kernel does;
    only the card's own calls (device guard, stream) are stubbed. The
    gradients to wq, wk, wv and wo must reach the parameters and equal
    ``jax.grad`` of the reference block within the attention tolerance
    (the gradients are O(10): a sum of 2 x 32 x 48 weighted outputs). On
    the seam without an autograd function, wq, wk and wv got none."""
    lib = _FakeKernelLibrary()
    monkeypatch.setattr(t_fa, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(t_fa, "_library", lambda route: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    r_blk, blk, p_ref = _block_and_params(5)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 32, 48)).astype(np.float32)
    cot = rng.normal(0, 1, (2, 32, 48)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))

    p = {k: v.requires_grad_(True) for k, v in params_from_reference(p_ref, "cpu").items()}
    q, k, v = blk._qkv(p, _t(x), _t(pos))
    lib.tensors = {t.data_ptr(): t for t in (q, k, v)}
    before = t_ops.launch_counts()["flash_attention_float32"]
    o = t_ops.flash_attention(q, k, v, causal=True)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    (out * _t(cot)).sum().backward()
    assert lib.calls == 1  # the kernel branch ran
    assert t_ops.launch_counts()["flash_attention_float32"] == before + 1

    def r_loss(params):
        return jnp.sum(r_blk.forward(params, jnp.asarray(x), jnp.asarray(pos)) * cot)

    want = jax.grad(r_loss)({k: jnp.asarray(v) for k, v in p_ref.items()})
    for name in ("wq", "wk", "wv", "wo"):
        assert p[name].grad is not None, f"no gradient reached {name}"
        np.testing.assert_allclose(p[name].grad.numpy(), np.asarray(want[name]),
                                   err_msg=name, **F32)
