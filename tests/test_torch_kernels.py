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
from repro_torch.core.quantize import quantize_linear_batch
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
    with pytest.raises(ValueError, match="devices"):
        t_ops.flash_attention(*(torch.zeros((1, 4, 2, 32), device="meta"),) * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.quantized_l2_auto(*_ql2_inputs(3, 16, 2), device="cuda")
    assert t_ops.launch_counts() == {"dequant_matmul": 0, "dequant_matmul_int4": 0,
                                     "quantized_l2": 0, "flash_attention": 0,
                                     "flash_attention_bfloat16": 0,
                                     "flash_attention_float32": 0,
                                     "flash_attention_bfloat16_dh256": 0,
                                     "flash_attention_float32_dh256": 0}


# The decode path's (K, N) at M = 4: q/o, k/v, gate/up, down, LM head.
_PATH_SHAPES = [(4, 2048, 2048, 132), (4, 2048, 1024, 132), (4, 2048, 8192, 132),
                (4, 8192, 2048, 132), (4, 2048, 92544, 132)]


@pytest.mark.parametrize("m,k,n,sms", [(4, 2048, 1024, 132), (4, 2048, 92544, 132),
                                       (4, 8192, 2048, 132), (130, 384, 250, 132),
                                       (1, 2, 3, 132), (4, 130, 70, 8)] + _PATH_SHAPES)
def test_launch_plan_covers_k_once_and_fills_the_card(m, k, n, sms):
    """The plan's blocks (the kernel's grid) cover every row group of 4
    rows of x, every column and every K row exactly once (in even ranges
    for the int4 kernel), in clusters of at most 8, and give each SM a
    block on the decode path's shapes. The kernel gives the block of
    cluster rank r the K rows [r * kblock, min(K, (r + 1) * kblock))."""
    for packed in (False, True):
        if packed and k % 2:
            continue
        p = t_dm.plan(m, k, n, sms, packed)
        assert p.groups * 4 >= m > (p.groups - 1) * 4
        assert p.tn in (2, 4, 8, 16, 32)
        assert p.strips * 16 * p.tn >= n > (p.strips - 1) * 16 * p.tn
        assert 1 <= p.cluster <= 8
        ranges = [(r * p.kblock, min(k, (r + 1) * p.kblock)) for r in range(p.cluster)]
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a < b for a, b in ranges)  # no block without K rows
        assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
        if packed:
            assert all(a % 2 == 0 and b % 2 == 0 for a, b in ranges)
        if (m, k, n, sms) in _PATH_SHAPES:
            assert p.blocks >= sms


@pytest.mark.parametrize("zp", [-129.0, -64.0, -11.0, 0.0, 8.0, 3e7, -11.5, 0.25])
def test_code_to_float_steps_round_like_the_reference(zp):
    """The kernels' code-to-float step, replayed in float32: the float
    2^23 + u (u the code's byte, offset by 128 for signed int8) less 2^23
    (+ 128) is the code exactly, and where ``foldable`` allows, less
    2^23 (+ 128) + zp in one subtraction is bit for bit the reference's
    ``float(code) - zp``; for zero-points with a fraction it declines."""
    for codes, off in ((np.arange(-128, 128), 8388736.0), (np.arange(16), 8388608.0)):
        a = np.float32(8388608.0) + (codes - (8388608.0 - off)).astype(np.float32)
        want = codes.astype(np.float32) - np.float32(zp)
        assert np.array_equal(a - np.float32(off), codes.astype(np.float32))
        folded = a - (np.float32(off) + np.float32(zp))
        assert t_dm.foldable(zp, zp, off == 8388608.0) == (zp == int(zp))
        if t_dm.foldable(zp, zp, off == 8388608.0):
            assert np.array_equal(folded.view(np.uint32), want.view(np.uint32))


# The save probe's (B, N, D) distance blocks (chip_smoke.py L2_SHAPES).
_PROBE_SHAPES = [(2, 4, 4194304), (4, 4, 2097152), (1, 6, 16777216), (1, 2, 189530112)]


@pytest.mark.parametrize("b,n,d", [(2, 4, 4194304), (1, 2, 189530112), (5, 1, 2048),
                                   (3, 130, 1000), (1, 1, 1), (4, 4, 2097152),
                                   (1, 6, 16777216)])
def test_quantized_l2_chunks_cover_d_within_int32_moments(b, n, d):
    """The launch plan on both paths: tiles of 1, 2 or 4 queries (by B)
    on the 16-byte path and 4 on the element path cover every query and
    code row; chunks of whole block steps cover D once, with no thread
    taking more elements than its uint32 moments hold; on the save probe's
    shapes every SM gets a block."""
    for vec in (True, False):
        p = t_ql2.plan(b, n, d, 132, vec)
        assert p.qb == ({1: 1, 2: 2}.get(b, 4) if vec else 4)
        assert p.tiles == math.ceil(n / 4) * math.ceil(b / p.qb)  # tiles of 4 code rows
        assert p.partials == 4 * p.qb + 2 * p.qb + 2 * 4
        step = 16 if vec else 1  # elements a thread a step
        assert p.chunk % step == 0
        assert (p.nchunks - 1) * p.chunk < d <= p.nchunks * p.chunk
        share = math.ceil(p.chunk / (256 * step)) * step  # one thread's share of a chunk
        assert share * 255 ** 2 < 2 ** 31
        if (b, n, d) in _PROBE_SHAPES:
            assert p.blocks == (2 if p.qb < 4 else 1) * 132


def _kernel_replay(q, codes, scales, zps, mids):
    """The kernel's arithmetic in numpy (16-byte path): c·q and q·q in
    float32 over each thread step's 16 elements, as four chains of four
    added (a0 + a1) + (a2 + a3), and Σq in float32 in the same order; the
    step sums and the combination in float64, Σc and Σc² exact. numpy
    rounds each product and sum apart where the kernel's fmaf rounds once,
    so the replay's error bounds the kernel's from above."""
    b, d = q.shape
    n = codes.shape[0]
    c32 = codes.astype(np.float32).reshape(1, n, d // 16, 4, 4)
    q32 = q.astype(np.float32).reshape(b, 1, d // 16, 4, 4)

    def steps(prod):  # (..., steps, 4, 4) float32 terms -> float64 sum of step sums
        a = prod[..., 0]
        for e in range(1, 4):
            a = a + prod[..., e]
        step = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
        assert step.dtype == np.float32
        return step.astype(np.float64).sum(axis=-1)

    dot = steps(c32 * q32)
    qsq = steps(q32 * q32)
    pairs = q32[..., 0::2] + q32[..., 1::2]  # Σq: (x0 + x1) + (x2 + x3) a chain
    qsum = steps(np.concatenate([pairs, np.zeros_like(pairs)], axis=-1))
    c64 = codes.astype(np.int64)
    csum, csq = c64.sum(axis=1).astype(np.float64), (c64 * c64).sum(axis=1).astype(np.float64)
    norm = scales * scales * (csq - 2.0 * zps * csum + d * zps * zps)
    dist = qsq + norm + 2.0 * (qsum * scales * zps - scales * dot)
    const = qsq - 2.0 * mids * qsum + d * mids * mids
    return np.maximum(np.where(scales == 0.0, const, dist), 0.0)


@pytest.mark.parametrize("d", [4096, 65536])
def test_kernel_step_sums_hold_the_contract_at_near_coincident_rows(d):
    """Where a query nearly coincides with a row (its own 8-bit
    quantization), the distance is ~1e-4 of |q|² and a float32 Σc·q over
    a thread's whole share misses rtol 2e-3 (the reference's note); the
    kernel's step sums (replayed) hold rtol 2e-3 against the dense float64
    plain version there, with the same argmin, beside far and constant
    rows."""
    rng = np.random.default_rng(d)
    q = rng.normal(0.0, 1.0, (3, d)).astype(np.float32)
    rows = np.concatenate([q.astype(np.float64), rng.normal(0.5, 2.0, (2, d)),
                           np.full((1, d), 0.25)])
    codes, scales, zps, mids = quantize_linear_batch(rows, nbit=8)
    zps = zps.astype(np.float64)
    want = t_ref.quantized_l2(torch.from_numpy(q), torch.from_numpy(codes),
                              torch.from_numpy(scales), torch.from_numpy(zps),
                              torch.from_numpy(mids)).numpy()
    assert scales[-1] == 0.0 and want[0, 0] < 1e-3 * want[0, 3]
    got = _kernel_replay(q, codes, scales, zps, mids)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    np.testing.assert_array_equal(got.argmin(axis=1), [0, 1, 2])
    np.testing.assert_array_equal(got.argmin(axis=1), want.argmin(axis=1))
