"""Kernel modules of the port against the reference's kernels and oracles.

The port's CUDA kernels cannot run on this machine; their plain PyTorch
versions (``repro_torch.kernels.ref``), which the wrappers take for CPU
tensors and which ``chip_smoke.py`` holds each kernel against on the card,
are held here against ``repro.kernels.ref`` and against the reference's
Pallas kernels run in interpret mode (``force="kernel"``), at the shapes of
``tests/test_kernels.py``. The wrappers' device rules and launch geometry
(pure Python) are checked too; ``tests/test_torch_cuda.py`` runs the CUDA
kernels where a card is present.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hnsw import quantized_l2_batch as r_quantized_l2_batch
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import dequant_matmul as t_dm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import quantized_l2 as t_ql2
from repro_torch.kernels import ref as t_ref


def _assert_close(got, want):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) + 1e-6
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (8, 256, 128), (64, 256, 192),
                                   (128, 128, 128), (130, 384, 250)])
def test_plain_dequant_matmul_matches_reference_oracle_and_pallas(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    base = rng.integers(-128, 128, (k, n)).astype(np.int8)
    delta = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scal = (0.013, 117.0, 3.1e-4, 64.0)
    want = r_ref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(base), scal[0], scal[1],
                                    jnp.asarray(delta), scal[2], scal[3])
    got = t_dm.dequant_matmul(torch.from_numpy(x), torch.from_numpy(base), scal[0],
                              scal[1], torch.from_numpy(delta), scal[2], scal[3])
    _assert_close(got.numpy(), want)
    pallas = r_ops.dequant_matmul_auto(x, base, *scal[:2], delta, *scal[2:], force="kernel")
    _assert_close(got.numpy(), pallas)
    w = t_ref.dequantize_weight(torch.from_numpy(base), scal[0], scal[1],
                                torch.from_numpy(delta), scal[2], scal[3])
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(r_ref.dequantize_weight_ref(
            jnp.asarray(base), scal[0], scal[1], jnp.asarray(delta), scal[2], scal[3])))


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (16, 256, 256), (64, 384, 200)])
def test_plain_dequant_matmul_int4_matches_reference_oracle_and_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    base = rng.integers(-128, 128, (k, n)).astype(np.int8)
    d4 = rng.integers(0, 16, (k, n)).astype(np.uint8)
    packed = r_ops.pack_int4(d4)
    scal = (0.02, 128.0, 5e-4, 8.0)
    want = r_ref.dequant_matmul_int4_ref(jnp.asarray(x), jnp.asarray(base), scal[0],
                                         scal[1], jnp.asarray(packed), scal[2], scal[3])
    got = t_dm.dequant_matmul_int4(torch.from_numpy(x), torch.from_numpy(base), scal[0],
                                   scal[1], torch.from_numpy(packed), scal[2], scal[3])
    _assert_close(got.numpy(), want)
    pallas = r_ops.dequant_matmul_auto(x, base, *scal[:2], packed, *scal[2:], packed=True,
                                       force="kernel")
    _assert_close(got.numpy(), pallas)
    np.testing.assert_array_equal(t_ref.unpack_int4(torch.from_numpy(packed)).numpy(), d4)


@pytest.mark.parametrize("k,n,m", [(130, 70, 1), (2, 3, 1), (64, 130, 5)])
def test_dequant_matmul_auto_parity_with_pallas(k, n, m):
    """Port seam (plain kernel version and decomposed CPU form) against the
    reference's interpret-mode Pallas kernel and decomposed numpy form, on
    odd shapes including K=2 and decode rows (M=1)."""
    from repro.launch.compressed_serve import quantize_leaf

    rng = np.random.default_rng(k * 31 + n)
    q = quantize_leaf(rng.normal(0, 0.5, (k, n)).astype(np.float32))
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    args = (x, q["base"].reshape(k, n), float(q["bs"]), float(q["bz"]), q["packed"],
            float(q["ds"]), float(q["dz"]))
    want = r_ops.dequant_matmul_auto(*args, packed=True, force="kernel")
    want_np = r_ops.dequant_matmul_auto(*args, packed=True, force="numpy")
    for force in ("kernel", "numpy", None):
        got = t_ops.dequant_matmul_auto(*args, packed=True, force=force).numpy()
        scale = float(np.abs(want).max()) + 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"force={force}")
        np.testing.assert_allclose(got, want_np, rtol=1e-4, atol=1e-4 * scale)


def test_dequant_matmul_auto_int8_paths_agree_with_reference():
    k, n, m = 96, 200, 3
    rng = np.random.default_rng(5)
    base = rng.integers(-128, 128, (k, n)).astype(np.int8)
    delta = rng.integers(-128, 128, (k, n)).astype(np.int8)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    args = (x, base, 0.013, -11.0, delta, 3.1e-4, -64.0)
    want = r_ops.dequant_matmul_auto(*args, force="kernel")
    scratch: dict = {}
    yn = t_ops.dequant_matmul_auto(*args, force="numpy", scratch=scratch)
    yn2 = t_ops.dequant_matmul_auto(*args, scratch=scratch)
    assert "cpu" in scratch  # pre-scaled CPU operand cached for the decode loop
    yk = t_ops.dequant_matmul_auto(*args, force="kernel")
    np.testing.assert_allclose(yk.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(yn.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(yn.numpy(), yn2.numpy())
    with pytest.raises(ValueError):
        t_ops.dequant_matmul_auto(*args, force="tpu")


def _ql2_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (3, d)).astype(np.float32)
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    scales = rng.uniform(1e-3, 2e-2, n)
    if n > 3:
        scales[3] = 0.0  # constant-row path
    zps = rng.integers(0, 256, n).astype(np.float64)
    mids = rng.normal(0, 0.5, n)
    return q, codes, scales, zps, mids


@pytest.mark.parametrize("n,d", [(1, 128), (7, 300), (64, 777), (130, 1000)])
def test_plain_quantized_l2_matches_host_hnsw_and_pallas(n, d):
    q, codes, scales, zps, mids = _ql2_inputs(n, d, n + d)
    got = t_ops.quantized_l2_auto(q, codes, scales, zps, mids, force="kernel")
    assert got.shape == (3, n) and got.dtype == np.float64
    want = np.stack([r_quantized_l2_batch(qb, codes, scales, zps.astype(np.int64), mids)
                     for qb in q])
    np.testing.assert_allclose(got, want, rtol=2e-3)
    np.testing.assert_array_equal(got.argmin(axis=1), want.argmin(axis=1))
    pallas = r_ops.quantized_l2_auto(q, codes, scales, zps, mids, force="kernel")
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=1e-3)
    np.testing.assert_array_equal(got.argmin(axis=1), pallas.argmin(axis=1))
    dense = r_ref.quantized_l2_batch_ref(q[0], codes, scales, zps, mids)
    np.testing.assert_allclose(got[0], dense, rtol=1e-12)


def test_quantized_l2_auto_declines_on_cpu_unless_forced():
    args = _ql2_inputs(5, 64, 1)
    assert t_ops.quantized_l2_auto(*args) is None
    assert t_ops.quantized_l2_auto(*args, force="numpy") is None
    with pytest.raises(ValueError):
        t_ops.quantized_l2_auto(*args, force="gpu")


@pytest.mark.parametrize("k", [2, 8, 130])
def test_pack_int4_byte_equal(k):
    d4 = np.random.default_rng(k).integers(0, 16, (k, 33)).astype(np.uint8)
    want = r_ops.pack_int4(d4)
    got = t_ops.pack_int4(d4)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    got_t = t_ops.pack_int4(torch.from_numpy(d4))
    assert got_t.dtype == torch.uint8 and got_t.numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        t_ops.pack_int4(d4[:1])


def test_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A non-CPU tensor (here on the meta device, standing for one the
    kernel cannot take) raises instead of taking the plain path, and a
    launch asked for on CUDA without a card raises."""
    x = torch.zeros((2, 4), device="meta")
    base = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="devices"):
        t_dm.dequant_matmul(x, base, 1.0, 0.0, base, 1.0, 0.0)
    with pytest.raises(ValueError, match="devices"):
        t_dm.dequant_matmul(torch.zeros((2, 4)), base, 1.0, 0.0, base, 1.0, 0.0)
    with pytest.raises(ValueError, match="devices"):
        t_ql2.quantized_l2(torch.zeros((1, 4), device="meta"),
                           torch.zeros((3, 4), dtype=torch.uint8),
                           *(torch.zeros(3, dtype=torch.float64),) * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.quantized_l2_auto(*_ql2_inputs(3, 16, 2), device="cuda")
    assert t_ops.launch_counts() == {"dequant_matmul": 0, "dequant_matmul_int4": 0,
                                     "quantized_l2": 0}


@pytest.mark.parametrize("m,k,n,sms", [(4, 2048, 1024, 132), (4, 2048, 92544, 132),
                                       (4, 8192, 2048, 132), (130, 384, 250, 132),
                                       (1, 2, 3, 132), (4, 130, 70, 8)])
def test_split_k_covers_k_in_even_tiles(m, k, n, sms):
    splits, kchunk = t_dm.split_k(m, k, n, sms)
    assert kchunk % 64 == 0 and splits >= 1
    assert (splits - 1) * kchunk < k <= splits * kchunk


@pytest.mark.parametrize("b,n,d", [(2, 4, 4194304), (1, 2, 189530112), (5, 1, 2048),
                                   (3, 130, 1000), (1, 1, 1)])
def test_quantized_l2_chunks_cover_d_within_int32_moments(b, n, d):
    nchunks, chunk = t_ql2.chunking(b, n, d, 132)
    assert chunk % 2048 == 0
    assert (nchunks - 1) * chunk < d <= nchunks * chunk
    assert math.ceil(chunk / 256) * 255 ** 2 < 2 ** 31  # one thread's share
