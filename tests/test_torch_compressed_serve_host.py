"""The host-quantized half of ``launch/compressed_serve.py`` against the
reference's, on the CPU.

The three cases of ``tests/test_compressed_serve.py`` run on the port with
their ``MIN_QUANT_SIZE`` monkeypatch and bounds, on the reference's
parameters carried across by ``params_from_reference``. Beside them: the
storage-format dicts byte for byte, the reconstruction bit for bit, eight
compressed serve steps against the reference's, and the reference's
bfloat16 fault pinned both ways (ROADMAP queue C). Trees are compared leaf
by leaf in ``jax.tree_util`` order (dict keys sorted), which walks the
port's trees too: a tensor is a leaf to it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.compressed_serve as RS
import repro_torch.launch.compressed_serve as TS
from repro.configs import get_config as r_get_config
from repro.models import decode_step as r_decode_step
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import decode_step, init_cache, params_from_reference

KEY = jax.random.PRNGKey(0)
# decode_step's tolerance in tests/test_torch_models.py (float32 sums in
# another order).
F32 = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture
def small_quant(monkeypatch):
    """The reference test's threshold, in both packages."""
    monkeypatch.setattr(RS, "MIN_QUANT_SIZE", 1024)
    monkeypatch.setattr(TS, "MIN_QUANT_SIZE", 1024)


def _is_q(x):
    return isinstance(x, dict) and ("raw" in x or "base" in x)


def _leaves(tree, is_leaf=None):
    """(path, leaf) in jax.tree_util order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _ref_and_port(arch, **replace):
    r_cfg = dataclasses.replace(r_get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    p_ref = jax.tree.map(np.asarray, r_init_params(r_cfg, KEY))
    return r_cfg, cfg, p_ref, params_from_reference(p_ref, "cpu")


def _recon_ref(qref, dtype):
    return jax.tree.map(lambda q: RS.dequantize_leaf_jnp(q, dtype), qref, is_leaf=_is_q)


def _recon_port(qport, dtype):
    placed = TS.quantized_to_device(qport, "cpu")
    return jax.tree.map(lambda q: TS.dequantize_leaf(q, dtype), placed, is_leaf=_is_q)


# --------------------------------------------- tests/test_compressed_serve.py
def test_quantize_roundtrip_error_bounded(small_quant):
    _, cfg, _, params = _ref_and_port("qwen3-8b")
    recon = _recon_port(TS.quantize_params(params), torch.float32)
    for (pa, a), (_, b) in zip(_leaves(params), _leaves(recon)):
        err = (a.to(torch.float32) - b.to(torch.float32)).abs().max().item()
        # int8 base + int4 delta: error dominated by the 4-bit delta bins.
        assert err < 2e-3, (pa, err)


def test_compressed_greedy_decode_agrees(small_quant):
    _, cfg, _, params = _ref_and_port("internlm2-1.8b")
    qparams = TS.quantized_to_device(TS.quantize_params(params), "cpu")
    cache = init_cache(cfg, 2, 32, device="cpu")
    cache2 = init_cache(cfg, 2, 32, device="cpu")
    toks = {"tokens": torch.zeros((2, 1), dtype=torch.int64)}
    agree = 0
    for t in range(8):
        t1, cache = make_serve_step(cfg)(params, cache, toks, t)
        t2, cache2 = TS.make_compressed_serve_step(cfg)(qparams, cache2, toks, t)
        agree += int(torch.equal(t1, t2))
    assert agree >= 7  # ≥7/8 steps identical under 4-bit flexible loading


def test_compressed_specs_match_quantized_tree(small_quant):
    cfg = get_config("internlm2-1.8b", smoke=True)
    _, _, _, params = _ref_and_port("internlm2-1.8b")
    qparams = TS.quantize_params(params)
    specs = TS.compressed_param_specs(cfg)
    # Structures line up leaf for leaf, and so do shapes and dtypes.
    got = [(p, tuple(np.shape(x)), _dtype_name(x)) for p, x in _leaves(qparams)]
    want = [(p, tuple(s.shape), _dtype_name(s)) for p, s in _leaves(specs)]
    assert got == want
    assert all(s.device.type == "meta" for _, s in _leaves(specs))


# ------------------------------------------------------------ the port's own
@pytest.mark.parametrize("arch", list_archs())
def test_quantize_params_bytes_equal_the_reference(small_quant, arch):
    """float32 smoke trees: every storage-format dict has the reference's
    keys, dtypes, shapes and bytes; raw leaves stay as they were."""
    _, _, p_ref, params = _ref_and_port(arch)
    want = _leaves(RS.quantize_params(p_ref))
    got = _leaves(TS.quantize_params(params))
    assert [p for p, _ in got] == [p for p, _ in want]
    n_quantized = 0
    for (path, g), (_, w) in zip(got, want):
        assert _dtype_name(g) == _dtype_name(w), path
        assert tuple(np.shape(g)) == tuple(np.shape(w)), path
        assert _bytes(g) == _bytes(w), path
        n_quantized += path.endswith("['base']")
    assert n_quantized > 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "recurrentgemma-9b", "granite-moe-3b-a800m"])
def test_dequantize_leaf_matches_the_reference(small_quant, arch):
    """The reconstruction against ``dequantize_leaf_jnp`` on the same dicts.
    Bit-identical in float32: XLA on the CPU did not contract its
    multiply-add here, so the two run the same correctly rounded float32
    operations (the weaker bound, one float32 rounding of the larger
    term, is not needed). bfloat16 is then the same rounding of the same
    value."""
    _, _, p_ref, params = _ref_and_port(arch)
    qref, qport = RS.quantize_params(p_ref), TS.quantize_params(params)
    for r_dt, t_dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = _leaves(_recon_ref(qref, r_dt))
        got = _leaves(_recon_port(qport, t_dt))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            w = np.asarray(w)
            if w.dtype.name == "bfloat16":
                w = w.view(np.int16)
            assert _bytes(g) == w.tobytes(), (path, t_dt)


def test_compressed_serve_steps_match_the_reference(small_quant):
    """8 compressed serve steps of both packages over the same storage
    format, fed the same tokens: the logits of ``decode_step`` over the
    reconstructed tree within decode_step's tolerance, and the steps'
    tokens equal wherever the top-2 margin exceeds it."""
    r_cfg, cfg, p_ref, params = _ref_and_port("internlm2-1.8b")
    qref = RS.quantize_params(p_ref)
    qport = TS.quantized_to_device(TS.quantize_params(params), "cpu")
    r_step, t_step = RS.make_compressed_serve_step(r_cfg), TS.make_compressed_serve_step(cfg)
    r_recon = _recon_ref(qref, jnp.float32)
    t_recon = jax.tree.map(lambda q: TS.dequantize_leaf(q, torch.float32), qport, is_leaf=_is_q)
    r_cache, r_cache2 = r_init_cache(r_cfg, 2, 16), r_init_cache(r_cfg, 2, 16)
    cache, cache2 = init_cache(cfg, 2, 16, device="cpu"), init_cache(cfg, 2, 16, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8))
    clear = 0
    for t in range(8):
        r_batch = {"tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32)}
        batch = {"tokens": torch.from_numpy(toks[:, t:t + 1])}
        r_tok, r_cache = r_step(qref, r_cache, r_batch, jnp.int32(t))
        tok, cache = t_step(qport, cache, batch, t)
        want, r_cache2 = r_decode_step(r_recon, r_cache2, r_batch, jnp.int32(t), r_cfg)
        got, cache2 = decode_step(t_recon, cache2, batch, t, cfg)
        want = np.asarray(want)[:, -1]
        np.testing.assert_allclose(got[:, -1].numpy(), want, **F32)
        top2 = np.sort(want, axis=1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) > F32["atol"] + F32["rtol"] * np.abs(top2[:, 1])
        np.testing.assert_array_equal(tok.numpy()[margin], np.asarray(r_tok)[margin])
        np.testing.assert_array_equal(tok.numpy(), got[:, -1].argmax(-1).numpy())
        clear += int(margin.sum())
    assert clear >= 8


def test_bfloat16_leaves_are_quantized_unlike_the_reference(small_quant):
    """The reference's ``_quantizable`` tests ``np.issubdtype(dtype,
    np.floating)``, False for numpy's ``bfloat16``: its ``quantize_params``
    leaves a bfloat16 tree all raw (a recorded fault, ROADMAP queue C).
    The port quantizes every such leaf, and its dict is exactly the
    reference's ``quantize_leaf`` of the float32 upcast."""
    _, _, p_ref, params = _ref_and_port("internlm2-1.8b", param_dtype="bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    r_q = RS.quantize_params(p_ref)
    assert all("raw" in q for _, q in _leaves(r_q, is_leaf=_is_q))
    got = _leaves(TS.quantize_params(params), is_leaf=_is_q)
    n_quantized = 0
    for (path, q), (_, leaf) in zip(got, _leaves(params)):
        if "raw" in q:
            assert not TS._quantizable(leaf) and q["raw"].dtype == torch.bfloat16, path
            continue
        want = RS.quantize_leaf(np.asarray(leaf.to(torch.float32)))
        assert sorted(q) == sorted(want), path
        for k in want:
            assert _dtype_name(q[k]) == _dtype_name(want[k]), (path, k)
            assert _bytes(q[k]) == _bytes(want[k]), (path, k)
        n_quantized += 1
    assert n_quantized >= 3  # embed, lm_head and the stacked block weights


def test_quantizable_reads_min_quant_size_at_call_time(monkeypatch):
    leaf = torch.zeros((4, 512), dtype=torch.bfloat16)
    assert not TS._quantizable(leaf)
    monkeypatch.setattr(TS, "MIN_QUANT_SIZE", 2048)
    assert TS._quantizable(leaf)
    assert not TS._quantizable(torch.zeros((3, 1024)))  # odd dim 0: no nibble pairs
    assert not TS._quantizable(torch.zeros((4, 1024), dtype=torch.int32))


def test_placement_defaults_to_the_card(small_quant):
    """``quantized_to_device`` places on the card unless asked for the CPU;
    without one it raises rather than serve from the CPU."""
    _, _, _, params = _ref_and_port("internlm2-1.8b")
    qparams = TS.quantize_params(params)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.quantized_to_device(qparams)
