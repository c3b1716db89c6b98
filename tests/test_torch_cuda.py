"""The port's CUDA kernels and entry points on the card.

Each test needs a CUDA card (marker ``cuda``) and skips without one; on
the GPU machine, which has no JAX, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX or ``repro``: the kernels are held
against their plain PyTorch versions, and the CUDA entry points against
the same calls with ``device="cpu"``. The shapes reach the paths that
``chip_smoke.py`` does not: ragged N and K, the scalar loads (N % 4 or
D % 8 not zero), more than 8 rows of x, more than 8 code rows and 4
queries a block, and K too short to split.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import CompressedModel, StorageEngine
from repro_torch.core.hnsw import HNSWIndex
from repro_torch.kernels import ops, ref
from repro_torch.launch.compressed_serve import DecoderSpec, greedy_decode, save_decoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, rtol=1e-4):
    want = want.cpu().numpy()
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=rtol, atol=1e-5 * scale)


@pytest.mark.parametrize("m,k,n", [(1, 130, 70), (1, 2, 3), (9, 64, 130),
                                   (130, 384, 250), (4, 2048, 1024), (3, 1, 5)])
def test_dequant_matmul_kernels_match_plain(cuda, m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    base = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    delta = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    args = (x, base, 0.013, -11.0, delta, 3.1e-4, -64.0)
    before = ops.launch_counts()["dequant_matmul"]
    got = ops.dequant_matmul(*[a.to(cuda) if torch.is_tensor(a) else a for a in args])
    assert ops.launch_counts()["dequant_matmul"] == before + 1
    _assert_close(got, ref.dequant_matmul(*args))
    if k % 2 == 0:
        d4 = torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8))
        args4 = (x, base, 0.02, -129.0, ops.pack_int4(d4), 2 * 0.003, 0.0)
        got4 = ops.dequant_matmul_int4(*[a.to(cuda) if torch.is_tensor(a) else a
                                         for a in args4])
        _assert_close(got4, ref.dequant_matmul_int4(*args4))


def test_dequant_matmul_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((2, 8), device=cuda)
    base = torch.zeros((8, 6), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        ops.dequant_matmul(x.double(), base, 1.0, 0.0, base, 1.0, 0.0)
    with pytest.raises(ValueError):
        ops.dequant_matmul(x[:, ::2], base[::2], 1.0, 0.0, base[::2], 1.0, 0.0)
    with pytest.raises(ValueError):
        ops.dequant_matmul(x, base, 1.0, 0.0, base[:4], 1.0, 0.0)
    with pytest.raises(ValueError):
        ops.dequant_matmul(x.cpu(), base, 1.0, 0.0, base, 1.0, 0.0)
    with pytest.raises(ValueError):
        ops.dequant_matmul_auto(x, base, 1.0, 0.0, base, 1.0, 0.0, force="numpy")


@pytest.mark.parametrize("b,n,d", [(3, 7, 300), (7, 19, 1000), (5, 3, 4096),
                                   (1, 1, 1), (2, 130, 2056)])
def test_quantized_l2_kernel_matches_plain(cuda, b, n, d):
    rng = np.random.default_rng(b * 100 + n + d)
    q = rng.normal(0, 1, (b, d)).astype(np.float32)
    codes = rng.integers(0, 256, (n, d), dtype=np.uint8)
    scales = rng.uniform(1e-3, 2e-2, n)
    scales[n // 2] = 0.0
    zps = rng.integers(0, 256, n).astype(np.float64)
    mids = rng.normal(0, 0.5, n)
    want = ops.quantized_l2_auto(q, codes, scales, zps, mids, force="kernel")
    got = ops.quantized_l2_auto(q, codes, scales, zps, mids, device="cuda")
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-9)
    np.testing.assert_array_equal(got.argmin(axis=1), want.argmin(axis=1))


def test_cuda_index_gives_the_cpu_index_ids(cuda):
    rng = np.random.default_rng(3)
    centers = rng.normal(0, 1, (5, 200))
    rows = centers[rng.integers(0, 5, 40)] + rng.normal(0, 0.05, (40, 200))
    a, b = HNSWIndex(200, device="cpu"), HNSWIndex(200, device=cuda)
    assert a.insert_batch(rows) == b.insert_batch(rows)
    queries = rows[:9] + rng.normal(0, 0.01, (9, 200))
    before = ops.launch_counts()["quantized_l2"]
    gv, gd = b.nearest_live_batch(queries)
    assert ops.launch_counts()["quantized_l2"] == before + 1
    wv, wd = a.nearest_live_batch(queries)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gd, wd, rtol=2e-3)


def test_save_load_decode_on_the_card_matches_the_cpu(cuda, tmp_path):
    spec = DecoderSpec(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=2,
                       vocab_size=96)
    prompt = np.array([[1, 5, 9], [2, 7, 4]])
    reports = {}
    for dev in ("cpu", "cuda"):
        eng = StorageEngine(str(tmp_path / dev), device=dev)
        save_decoder(eng, "a", spec, seed=3)
        reports[dev] = save_decoder(eng, "b", spec, seed=3)
        eng.close()
    assert [(e["vertex_id"], e["outcome"], e["nbit"]) for e in reports["cuda"].explain] == [
        (e["vertex_id"], e["outcome"], e["nbit"]) for e in reports["cpu"].explain]
    for bits in (8, 4):
        out = {}
        for dev in ("cpu", "cuda"):
            eng = StorageEngine(str(tmp_path / "cuda"), device=dev)
            provider = CompressedModel(eng.load_model("b", bits=bits))
            assert provider.device.type == dev
            out[dev] = greedy_decode(provider, spec, prompt, 5, return_logits=True)
            provider.close()
            eng.close()
        np.testing.assert_array_equal(out["cuda"][0].cpu().numpy(), out["cpu"][0].numpy())
        np.testing.assert_allclose(out["cuda"][1].cpu().numpy(), out["cpu"][1].numpy(),
                                   rtol=1e-4, atol=1e-4)
