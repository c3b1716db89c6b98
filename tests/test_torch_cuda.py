"""The port's CUDA kernels and entry points on the card.

Each test needs a CUDA card (marker ``cuda``) and skips without one; on
the GPU machine, which has no JAX, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX or ``repro``: the kernels are held
against their plain PyTorch versions, and the CUDA entry points against
the same calls with ``device="cpu"``. The shapes reach the paths that
``chip_smoke.py`` does not: ragged N and K, the byte loads (N % 16 not
zero), more than 8 rows of x, the decode path's shapes at batch 1 to 9,
bit-identical repeats of the in-cluster K reduction, and K too short to
split; for ``quantized_l2``, every tile shape, D % 16 not zero, D in one
chunk and in many, an unaligned query view, constant rows, rows that
nearly coincide with a query and bit-identical repeats, and a CUDA
index's device mirror; for ``flash_attention``, both
routes (bfloat16 and split tf32, both on the tensor cores, head dim 256
included), every head dim, recurrentgemma's windowed prefill shape,
groups that do not divide the 128-row tile, strided inputs, key lengths
short of Sk and past it, rows that have no real key, at head dim 256 a last
block half past the grid, a window's edge inside a key tile, one query
position at G = 16 and K/V read from a packed tensor, the bfloat16 route's alignment
rules, and for float32 rows that do not start on 16 bytes, a peaked
softmax (q and k scaled x3; at head dim 256 against the float64 result,
and x2 against the plain version too), K and V that TMA cannot take at
head dim 256 and the internlm2 prefill shape; for
training, the attention's gradients through ``FlashAttentionFn`` on both
routes against autograd of the plain version, the gradient to ``wq``
through an attention block, microbatched train steps against the CPU and
a ``Trainer`` that checkpoints and resumes on the card; for the store's
front door, an HTTP upload whose probes launch ``quantized_l2`` from the
server's handler thread, a delete and vacuum that compact a CUDA mirror,
and concurrent downloads during a save; for the model zoo, the recurrent
and MoE smoke models' forward and decode against the CPU; the
event-timed fall-back of the script's device-only times against the trace;
and for the pod-mesh layer, the sharded train step over a world-size-1
NCCL group bit-identical to the unsharded one and, on a machine with four
cards (skipped on one), over four NCCL ranks against the microbatched step
and, split over ``model`` on a (1, 4) mesh at internlm2-1.8b's widths,
against the unsharded step, beside the gathered route's memory and time;
on a (2, 2) mesh, the routed experts split over ``data`` and their hidden
over ``model``, the tokens crossing the data ranks by an NCCL all-to-all
(granite-moe-3b-a800m's widths and arctic-480b's, train steps against the
microbatched step; arctic's prefill and serve step with all 128 experts
against the gathered route); and on a (1, 4) mesh at internlm2-1.8b's
widths, the compressed serve step with each rank holding and rebuilding
only its shard of the storage format, against the gathered route.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import CompressedModel, StorageEngine
from repro_torch.core.hnsw import HNSWIndex, mirror_uploads
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch.compressed_serve import DecoderSpec, greedy_decode, save_decoder
from repro_torch.models import decode_step, forward, init_cache, init_params, layers

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
                                   (130, 384, 250), (4, 2048, 1024), (3, 1, 5),
                                   (4, 2047, 1000), (4, 2048, 1000), (2, 8190, 2056)])
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


def _dq_inputs(m, k, n, seed):
    """x, int8 base and delta, and packed int4 delta codes, on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).cuda()
    base = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).cuda()
    delta = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).cuda()
    d4 = torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8)).cuda()
    return x, base, delta, ops.pack_int4(d4)


@pytest.mark.parametrize("m", [1, 4, 8, 9])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
                                 (2048, 92544)])
def test_dequant_matmul_kernels_at_the_decode_path_shapes(cuda, k, n, m):
    """Both kernels at the compressed decode's (K, N), batch 1 to 9 (9:
    two row groups), within rtol 1e-4 / atol 1e-5 max|y| of the plain
    version on the card."""
    x, base, delta, packed = _dq_inputs(m, k, n, k + n + m)
    for fn, plain, d, scal in ((ops.dequant_matmul, ref.dequant_matmul, delta,
                                (0.013, -11.0, 3.1e-4, -64.0)),
                               (ops.dequant_matmul_int4, ref.dequant_matmul_int4, packed,
                                (0.013, -11.0, 5e-4, 8.0))):
        args = (x, base, scal[0], scal[1], d, scal[2], scal[3])
        _assert_close(fn(*args), plain(*args))


@pytest.mark.parametrize("m,k,n", [(4, 8192, 2048), (9, 2048, 1024), (4, 130, 70)])
def test_dequant_matmul_kernels_are_deterministic(cuda, m, k, n):
    """Two launches give bit-identical y: the in-cluster K reduction adds
    the blocks' sums in a fixed order, with no atomics."""
    x, base, delta, packed = _dq_inputs(m, k, n, 7)
    y1 = ops.dequant_matmul(x, base, 0.013, -11.0, delta, 3.1e-4, -64.0)
    y2 = ops.dequant_matmul(x, base, 0.013, -11.0, delta, 3.1e-4, -64.0)
    assert torch.equal(y1, y2)
    z1 = ops.dequant_matmul_int4(x, base, 0.02, -129.0, packed, 0.006, 0.0)
    z2 = ops.dequant_matmul_int4(x, base, 0.02, -129.0, packed, 0.006, 0.0)
    assert torch.equal(z1, z2)


@pytest.mark.parametrize("cluster", range(1, 8))
def test_dequant_matmul_kernels_split_ragged_k_across_a_cluster(cuda, cluster):
    """A ragged K split over a cluster of 1 to 7 blocks (the plan's kblock
    and cluster, passed to the kernel as given): every K row is added once,
    on both kernels and both paths (N = 256 takes 16-byte loads, N = 250
    byte loads)."""
    for n in (256, 250):
        k = 64 * cluster - 6
        assert dm.plan(4, k, n, 132).cluster == cluster
        assert dm.plan(4, k, n, 132, packed=True).cluster == cluster
        x, base, delta, packed = _dq_inputs(4, k, n, cluster)
        for fn, plain, d, scal in ((ops.dequant_matmul, ref.dequant_matmul, delta,
                                    (0.013, -11.0, 3.1e-4, -64.0)),
                                   (ops.dequant_matmul_int4, ref.dequant_matmul_int4, packed,
                                    (0.013, -11.0, 5e-4, 8.0))):
            args = (x, base, scal[0], scal[1], d, scal[2], scal[3])
            _assert_close(fn(*args), plain(*args))


@pytest.mark.parametrize("bz,dz", [(-11.5, -63.25), (0.25, 7.5)])
def test_dequant_matmul_fractional_zero_points_match_plain(cuda, bz, dz):
    """Zero-points with a fraction cannot share the code-to-float
    subtraction (``foldable`` is false), so the wrapper sends them to the
    byte path, which runs the reference's subtractions one by one; both
    kernels match the plain version there too."""
    assert not dm.foldable(bz, dz, False) and not dm.foldable(bz, dz, True)
    x, base, delta, packed = _dq_inputs(4, 2048, 1024, 11)
    for fn, plain, d, ds in ((ops.dequant_matmul, ref.dequant_matmul, delta, 3.1e-4),
                             (ops.dequant_matmul_int4, ref.dequant_matmul_int4, packed, 5e-4)):
        args = (x, base, 0.013, bz, d, ds, dz)
        _assert_close(fn(*args), plain(*args))


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


def _l2_inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, d)).astype(np.float32)
    codes = rng.integers(0, 256, (n, d), dtype=np.uint8)
    scales = rng.uniform(1e-3, 2e-2, n)
    scales[n // 2] = 0.0
    zps = rng.integers(0, 256, n).astype(np.float64)
    mids = rng.normal(0, 0.5, n)
    return q, codes, scales, zps, mids


# (B, N, D): D % 16 != 0 (element path), the 16-byte path at 1, 2 and 4
# queries a tile (B = 3 and 5 in tiles of 4), one code row and 130 (many
# row tiles), D in one chunk and in many (a tile's blocks added by the
# last one to finish), and the save probe's shapes cut to 2^20 columns.
@pytest.mark.parametrize("b,n,d", [(3, 7, 300), (7, 19, 1000), (5, 3, 4096),
                                   (1, 1, 1), (2, 130, 2056), (3, 130, 4096),
                                   (3, 7, 1 << 20), (1, 2, 1 << 20), (1, 6, 1 << 20),
                                   (2, 4, 1 << 20), (4, 4, 1 << 20), (5, 1, 2048),
                                   (2, 9, 65552)])
def test_quantized_l2_kernel_matches_plain(cuda, b, n, d):
    q, codes, scales, zps, mids = _l2_inputs(b, n, d, b * 100 + n + d)
    want = ops.quantized_l2_auto(q, codes, scales, zps, mids, force="kernel")
    got = ops.quantized_l2_auto(q, codes, scales, zps, mids, device="cuda")
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-9)
    np.testing.assert_array_equal(got.argmin(axis=1), want.argmin(axis=1))


def _on_card(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def test_quantized_l2_takes_an_unaligned_query_view(cuda):
    """Queries at a 4-byte offset into their storage take the element
    path and give the plain version's distances (rtol 2e-3)."""
    q, codes, scales, zps, mids = _l2_inputs(3, 5, 4096, 17)
    store = torch.zeros(q.size + 1, dtype=torch.float32, device="cuda")
    store[1:] = torch.from_numpy(q.ravel()).cuda()
    qv = store[1:].view(3, 4096)
    assert qv.is_contiguous() and qv.data_ptr() % 16 == 4
    args = (qv, *_on_card(codes, scales, zps, mids))
    got = ops.quantized_l2(*args)
    want = ref.quantized_l2(*args)
    _assert_close(got, want, rtol=2e-3)
    assert torch.equal(got.argmin(dim=1), want.argmin(dim=1))


@pytest.mark.parametrize("d", [300, 1 << 20])
def test_quantized_l2_all_constant_rows(cuda, d):
    """Rows with scale 0 are their mid everywhere: |q|^2 - 2 mid Sq + D mid^2."""
    q, codes, _, zps, mids = _l2_inputs(2, 5, d, d)
    scales = np.zeros(5)
    got = ops.quantized_l2_auto(q, codes, scales, zps, mids, device="cuda")
    want = ops.quantized_l2_auto(q, codes, scales, zps, mids, force="kernel")
    np.testing.assert_allclose(got, want, rtol=2e-3)
    np.testing.assert_array_equal(got.argmin(axis=1), want.argmin(axis=1))


@pytest.mark.parametrize("b,n,d", [(1, 2, 1 << 22), (4, 4, 1 << 21), (3, 130, 4096),
                                   (3, 7, 300)])
def test_quantized_l2_is_bit_identical_on_repeat(cuda, b, n, d):
    """The last block of a tile adds its partials in chunk order, so the
    result does not depend on which block finishes last."""
    args = _on_card(*_l2_inputs(b, n, d, 5))
    first = ops.quantized_l2(*args)
    for _ in range(3):
        assert torch.equal(ops.quantized_l2(*args), first)


@pytest.mark.parametrize("d", [4096, 1 << 20])
def test_quantized_l2_near_coincident_rows_match_plain(cuda, d):
    """A query against its own 8-bit quantization (distance ~1e-4 of
    |q|^2) beside far and constant rows: within rtol 2e-3 of the dense
    float64 plain version, with the same argmin."""
    from repro_torch.core.quantize import quantize_linear_batch

    rng = np.random.default_rng(d)
    q = rng.normal(0.0, 1.0, (3, d)).astype(np.float32)
    rows = np.concatenate([q.astype(np.float64), rng.normal(0.5, 2.0, (2, d)),
                           np.full((1, d), 0.25)])
    codes, scales, zps, mids = quantize_linear_batch(rows, nbit=8)
    args = _on_card(q, codes.astype(np.uint8), scales, zps.astype(np.float64), mids)
    got = ops.quantized_l2(*args)
    want = ref.quantized_l2(*args)
    _assert_close(got, want, rtol=2e-3)
    assert got.argmin(dim=1).tolist() == [0, 1, 2] == want.argmin(dim=1).tolist()


def _assert_mirror(idx):
    n = len(idx)
    codes, scales, zps, mids = (t.cpu() for t in idx.mirror.view(n))
    assert idx.mirror.device.type == "cuda"
    assert torch.equal(codes, torch.from_numpy(idx._codes[:n]))
    assert torch.equal(scales, torch.from_numpy(idx._scales[:n]))
    assert torch.equal(zps, torch.from_numpy(idx._zps[:n].astype(np.float64)))
    assert torch.equal(mids, torch.from_numpy(idx._mids[:n]))


def test_cuda_index_mirror_equals_its_host_arrays(cuda):
    """The mirror on the card after insert, insert_batch past the capacity,
    mark_deleted + compact, from_bytes and clone; each entering row is
    uploaded once, and the ids are the CPU index's."""
    rng = np.random.default_rng(8)
    rows = rng.normal(0, 1, (4, 300))[rng.integers(0, 4, 40)] + rng.normal(0, 0.05, (40, 300))
    before = dict(mirror_uploads)

    def uploaded():
        return {k: mirror_uploads[k] - before[k] for k in before}

    a, b = HNSWIndex(300, device="cpu"), HNSWIndex(300, device=cuda)
    for r in rows[:3]:
        assert a.insert(r) == b.insert(r)
        _assert_mirror(b)
    assert a.insert_batch(rows[3:]) == b.insert_batch(rows[3:])
    _assert_mirror(b)
    assert uploaded() == {"rows": 40 * 300, "index": 0}
    for v in (1, 22):
        a.mark_deleted(v)
        b.mark_deleted(v)
    assert a.compact() == b.compact()
    _assert_mirror(b)
    for i, make in enumerate((lambda: HNSWIndex.from_bytes(b.to_bytes(), device=cuda),
                              b.clone)):
        c = make()
        _assert_mirror(c)
        assert uploaded() == {"rows": 40 * 300, "index": (i + 1) * 38 * 300}
        np.testing.assert_array_equal(c.nearest_live_batch(rows[:6])[0],
                                      a.nearest_live_batch(rows[:6])[0])


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


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", [
    (2, 256, 256, 8, 4, 64, True, 0, None),
    (1, 256, 256, 4, 1, 128, True, 64, None),   # MQA + window
    (2, 128, 128, 8, 8, 64, False, 0, None),
    (1, 200, 256, 8, 2, 64, True, 0, None),     # ragged Sq
    (1, 384, 384, 16, 16, 80, False, 0, None),  # dh = 80
    (1, 37, 37, 4, 2, 64, False, 0, None),
    (2, 50, 100, 8, 4, 32, False, 0, None),
    (1, 100, 50, 4, 4, 64, False, 0, None),
    (1, 70, 70, 56, 8, 128, True, 0, None),     # G = 7 does not divide the tile
    (1, 130, 90, 6, 2, 32, False, 20, None),    # rows past 108 have no real key
    (2, 96, 160, 4, 2, 64, False, 0, 131),      # keys masked past sk_true
    (1, 1, 300, 8, 2, 128, True, 0, None),      # one query row
    (1, 256, 256, 16, 1, 256, True, 64, None),  # dh = 256 (recurrentgemma): MQA + window
    (2, 130, 200, 4, 2, 256, False, 0, 170),    # dh = 256: ragged, keys past sk_true
    (1, 96, 96, 8, 8, 256, True, 0, None),      # dh = 256: one head a KV head
    (1, 130, 90, 6, 2, 256, False, 20, None),   # dh = 256: rows past 108 have no real key
    (1, 100, 100, 16, 1, 256, True, 0, None),   # dh = 256: Sq * G not a multiple of 128
    (1, 36, 36, 16, 1, 256, True, 0, None),     # dh = 256: the last block half past the grid
    (1, 300, 300, 16, 1, 256, True, 100, None), # dh = 256: the window's edge inside a tile
    (1, 1, 300, 16, 1, 256, True, 0, None),     # dh = 256: one query position, G = 16
    (1, 130, 90, 6, 2, 256, False, 20, 1000),   # dh = 256: sk_true past Sk (all keys real)
    (1, 130, 90, 6, 2, 128, False, 20, 1000),   # sk_true past Sk (all keys real)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, sq, sk, h, kv, dh, causal, window,
                                              sk_true, dtype):
    rng = np.random.default_rng(sq + sk + h + dh)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, dtype)
               for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    before = ops.launch_counts()["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
    assert got.dtype == dtype and got.shape == (b, sq, h, dh)
    # float32: the reference's tolerance; bfloat16: one rounding step apart.
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("dh", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_inputs(cuda, dtype, dh):
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, 77, 8 + 2 + 2, dh)).astype(np.float32)).to(
        cuda, dtype)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dh256_reads_strided_kv(cuda, dtype):
    """K and V at head dim 256 as views into one packed (B, Sk, 2 KV, dh)
    tensor (head stride dh, position stride 2 KV dh, batch stride Sk 2 KV
    dh), with G = 8, a window and Sq != Sk."""
    rng = np.random.default_rng(257)
    q = torch.from_numpy(rng.normal(0, 1, (2, 150, 16, 256)).astype(np.float32)).to(cuda, dtype)
    kv = torch.from_numpy(rng.normal(0, 1, (2, 170, 4, 256)).astype(np.float32)).to(cuda, dtype)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    assert not k.is_contiguous() and not v.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=False, window=70)
    want = ref.flash_attention(q, k.contiguous(), v.contiguous(), causal=False, window=70)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def _exact_attention(q, k, v, *, causal, window):
    """The plain version's semantics evaluated in float64."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, sq, kv, h // kv, dh)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.double()) / dh ** 0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float64, device=q.device))
    o = torch.einsum("bkgqc,bckd->bkgqd", torch.softmax(s, dim=-1), v.double())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", [
    (1, 256, 256, 4, 1, 128, True, 64),
    (1, 384, 384, 16, 16, 80, False, 0),
])
def test_flash_attention_f32_peaked_softmax_matches_plain(cuda, b, sq, sk, h, kv, dh, causal,
                                                          window):
    # q and k scaled x3: scores reach about 40 and a few keys carry each row,
    # so an unsplit p or v would miss the tolerance (test_torch_flash_tf32.py).
    rng = np.random.default_rng(sq + sk + h + dh)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
               for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    q, k = 3 * q, 3 * k
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    exact = _exact_attention(q, k, v, causal=causal, window=window)
    tol = dict(rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
    np.testing.assert_allclose(got.double().cpu().numpy(), exact.cpu().numpy(), **tol)


@pytest.mark.parametrize("scale", [2.0, 3.0])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", [(1, 300, 300, 16, 1, True, 100),
                                                        (2, 130, 200, 4, 2, False, 0)])
def test_flash_attention_f32_dh256_peaked_softmax(cuda, b, sq, sk, h, kv, causal, window, scale):
    # q and k scaled x2 and x3 at head dim 256. The kernel is held to the
    # float64 result at both; at x3 the plain float32 version lands up to
    # 1.2x the tolerance from that result itself (its dot products are
    # twice as long as at dh 128, and its rounding grows with them), so it
    # is the yardstick only at x2.
    rng = np.random.default_rng(sq + sk + h + 256)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
               for shape in ((b, sq, h, 256), (b, sk, kv, 256), (b, sk, kv, 256)))
    q, k = scale * q, scale * k
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    exact = _exact_attention(q, k, v, causal=causal, window=window)
    tol = dict(rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got.double().cpu().numpy(), exact.cpu().numpy(), **tol)
    if scale == 2.0:
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


def test_flash_attention_bf16_dh256_peaked_softmax_matches_plain(cuda):
    # q and k scaled x3: tile maxima pass the kernel's running max by more
    # than its kStaleMax on some rows and not on others, so both branches of
    # its rescale run (tests/test_torch_flash_split.py emulates this).
    rng = np.random.default_rng(300 + 300 + 16 + 256)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
               for shape in ((1, 300, 16, 256), (1, 300, 1, 256), (1, 300, 1, 256)))
    q, k, v = (3 * q).bfloat16(), (3 * k).bfloat16(), v.bfloat16()
    got = fa.flash_attention(q, k, v, causal=True, window=100)
    want = ref.flash_attention(q, k, v, causal=True, window=100)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-5)


def test_flash_attention_f32_at_the_prefill_shape_matches_plain(cuda):
    rng = np.random.default_rng(2048)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
               for shape in ((4, 2048, 16, 128), (4, 2048, 8, 128), (4, 2048, 8, 128)))
    before = ops.launch_counts()["flash_attention_float32"]
    got = fa.flash_attention(q, k, v, causal=True)
    assert ops.launch_counts()["flash_attention_float32"] == before + 1
    want = ref.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_recurrentgemma_prefill_shape(cuda, dtype):
    """recurrentgemma-9b's local attention on an 8,192-token prompt: q (1,
    8192, 16, 256), k/v (1, 8192, 1, 256), causal, window 2048, one launch
    on the dtype's route."""
    rng = np.random.default_rng(256)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, dtype)
               for shape in ((1, 8192, 16, 256), (1, 8192, 1, 256), (1, 8192, 1, 256)))
    key = f"flash_attention_{str(dtype).split('.')[1]}"
    before = ops.launch_counts()
    got = fa.flash_attention(q, k, v, causal=True, window=2048)
    after = ops.launch_counts()
    assert after[key] == before[key] + 1
    assert after[f"{key}_dh256"] == before[f"{key}_dh256"] + 1
    want = ref.flash_attention(q, k, v, causal=True, window=2048)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def test_flash_attention_f32_reads_rows_off_16_bytes(cuda):
    # Head strides of 65 floats and a base 4 bytes past 16: single-float loads.
    rng = np.random.default_rng(65)
    qb, kb, vb = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
                  for shape in ((2, 77, 8, 65), (2, 77, 2, 65), (2, 77, 2, 65)))
    q, k, v = qb[..., 1:], kb[..., 1:], vb[..., :64]
    assert q.data_ptr() % 16 == 4 and q.stride(2) == 65
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=2e-5)


def test_flash_attention_route_follows_the_dtype(cuda):
    ops.reset_launch_counts()
    for dtype, route in ((torch.bfloat16, "flash_attention_bfloat16"),
                         (torch.float32, "flash_attention_float32"),
                         (torch.bfloat16, "flash_attention_bfloat16")):
        before = ops.launch_counts()
        q = torch.ones((1, 16, 4, 64), device=cuda, dtype=dtype)
        k = torch.ones((1, 16, 2, 64), device=cuda, dtype=dtype)
        assert fa.flash_attention(q, k, k).dtype == dtype
        assert ops.launch_counts() == {**before, route: before[route] + 1,
                                       "flash_attention": before["flash_attention"] + 1}
    assert ops.launch_counts()["flash_attention"] == 3
    assert fa.ROUTES == {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention"}


def test_flash_attention_bf16_rejects_what_tma_cannot_take(cuda):
    base = torch.zeros((1, 8, 4, 68), device=cuda, dtype=torch.bfloat16)
    q = base[..., 4:]  # dh 64 with a head stride of 68 elements (136 bytes)
    k = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, k, k)
    flat = torch.zeros(8 * 2 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    k_off = flat[4:].view(1, 8, 2, 64)  # base 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q.contiguous(), k_off, k)
    assert fa.flash_attention(q.contiguous(), k, k).shape == (1, 8, 4, 64)


def test_flash_attention_f32_dh256_rejects_what_tma_cannot_take(cuda):
    # float32 K and V at head dim 256 are read by TMA: a head stride of 257
    # floats is refused, q may take any strides (16-byte vectors or floats).
    q = torch.zeros((1, 8, 4, 256), device=cuda)
    base = torch.zeros((1, 8, 2, 257), device=cuda)
    k = torch.zeros((1, 8, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, base[..., 1:], k)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, k, base[..., :256])
    rng = np.random.default_rng(257)
    q_off = torch.from_numpy(rng.normal(0, 1, (1, 8, 4, 257)).astype(np.float32)).to(cuda)[..., 1:]
    kv = torch.from_numpy(rng.normal(0, 1, (1, 8, 2, 256)).astype(np.float32)).to(cuda)
    got = fa.flash_attention(q_off, kv, kv)
    want = ref.flash_attention(q_off.contiguous(), kv, kv)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=2e-5)


def test_flash_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :48], k[..., :48], k[..., :48])   # dh 48
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., ::2], k[..., ::2], k[..., ::2])   # strided head dim
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 64), k)    # 4 % 3
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        layers.chunked_attention(q, k, k, causal=True, q_offset=4)


def test_model_forward_on_the_card_matches_the_cpu(cuda):
    # The smoke config's head dim (16) is not one the kernel is built for: 32.
    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), d_head=32)
    params = init_params(cfg, seed=0, device="cpu")
    # 64 tokens: the CPU scan needs Sk to be a multiple of the smoke chunk (32).
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)))
    want = forward(params, {"tokens": toks}, cfg)
    gparams = _to(params, cuda)
    before = ops.launch_counts()["flash_attention"]
    got = forward(gparams, {"tokens": toks.to(cuda)}, cfg)
    assert ops.launch_counts()["flash_attention"] == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,d_head", [("recurrentgemma-9b", 256), ("rwkv6-7b", None),
                                         ("granite-moe-3b-a800m", 32), ("arctic-480b", 32)])
def test_zoo_forward_and_decode_on_the_card_match_the_cpu(cuda, arch, d_head):
    """The recurrent and MoE smoke models (float32) on the card against the
    CPU from the same parameters: the forward's logits (recurrentgemma's
    local attention through the float32 kernel at head dim 256, the MoE
    models' at 32) and 6 decode steps, within rtol/atol 1e-4."""
    cfg = get_config(arch, smoke=True)
    if d_head is not None:
        cfg = dataclasses.replace(cfg, d_head=d_head)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)))
    want = forward(params, {"tokens": toks}, cfg)
    gparams = _to(params, cuda)
    n_attn = sum(b in ("attn", "local_attn") for b, _ in cfg.layer_types())
    before = ops.launch_counts()["flash_attention_float32"]
    got = forward(gparams, {"tokens": toks.to(cuda)}, cfg)
    assert ops.launch_counts()["flash_attention_float32"] == before + n_attn
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    caches = {"cpu": init_cache(cfg, 2, 16, device="cpu"), "cuda": init_cache(cfg, 2, 16,
                                                                            device=cuda)}
    for t in range(6):
        out = {}
        for dev, p in (("cpu", params), ("cuda", gparams)):
            out[dev], caches[dev] = decode_step(p, caches[dev],
                                                {"tokens": toks[:, t:t + 1].to(dev)}, t, cfg)
        np.testing.assert_allclose(out["cuda"].cpu().numpy(), out["cpu"].numpy(),
                                   rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ------------------------------------------------------------------ training
def _plain_grads(q, k, v, do, **masks):
    """Autograd of the plain version on the card: the yardstick of
    ``FlashAttentionFn``'s backward."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = ref.flash_attention(*leaves, **masks)
    return torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,sk_true", [
    (2, 256, 256, 8, 4, 64, True, 0, None),
    (1, 256, 256, 4, 1, 128, True, 64, None),   # MQA + window
    (1, 200, 256, 8, 2, 64, False, 0, None),    # ragged Sq, bidirectional
    (1, 130, 90, 6, 2, 32, False, 20, None),    # rows that see no key
    (2, 96, 600, 4, 2, 80, False, 0, 531),      # keys past sk_true; a ragged last chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_autograd_of_plain(cuda, b, sq, sk, h, kv, dh, causal,
                                                            window, sk_true, dtype):
    """The kernel forward and the plain backward through FlashAttentionFn,
    against autograd of ``ref.flash_attention``: float32 at the reference's
    rtol 1e-4 (atol 1e-5 of the largest gradient), bfloat16 one rounding
    step apart (rtol 1e-2). Keys past ``sk_true`` get exactly 0."""
    rng = np.random.default_rng(sq + sk + dh)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, dtype)
                   for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
                                 (b, sq, h, dh)))
    masks = dict(causal=causal, window=window, sk_true=sk_true)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ops.launch_counts()["flash_attention"]
    o = fa.flash_attention(*leaves, **masks)
    assert ops.launch_counts()["flash_attention"] == before + 1 and o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    want = _plain_grads(q, k, v, do, **masks)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _assert_close(g.float(), w.float(), rtol=1e-4 if dtype == torch.float32 else 1e-2)
    if sk_true is not None:
        assert not got[1][:, sk_true:].any() and not got[2][:, sk_true:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_reaches_wq_on_the_card(cuda, dtype):
    """The fault the autograd function repairs: the kernel's output was a
    fresh tensor, so wq, wk and wv got no gradient. Through an attention
    block on the card every weight gets the gradient of the same block on
    the plain attention."""
    blk = layers.AttentionBlock(n_heads=8, n_kv_heads=4, d_head=32, rope_theta=10_000.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = blk.init(gen, 128, dtype, cuda)
    x = torch.randn((2, 64, 128), generator=gen, device=cuda).to(dtype)
    pos = torch.arange(64, device=cuda).expand(2, 64)

    def grads(attention):
        leaves = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        orig = ops.flash_attention
        ops.flash_attention = attention
        try:
            out = blk.forward(leaves, x, pos)
        finally:
            ops.flash_attention = orig
        out.float().square().sum().backward()
        return {k: t.grad for k, t in leaves.items()}

    got, want = grads(ops.flash_attention), grads(ref.flash_attention)
    for name in ("wq", "wk", "wv", "wo"):
        assert got[name] is not None, f"no gradient reached {name}"
        if dtype == torch.float32:
            _assert_close(got[name], want[name])
        else:
            # bfloat16: the kernel's output is one rounding from the plain
            # one (2^-8 relative), which the loss's gradient carries back,
            # and each gradient is rounded again: held in relative L2.
            err = (got[name].double() - want[name].double()).norm() / want[name].double().norm()
            assert float(err) < 2e-2, (name, float(err))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two microbatched train steps of a float32 smoke model (head dim 32,
    one the kernel is built for) on the card and on the CPU from the same
    parameters: the losses within rtol 1e-4, the parameters after the
    steps within rtol/atol 1e-4 of each other."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), d_head=32)
    params = init_params(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, 2, lr=1e-3)
    gparams = _to(params, cuda)
    state = {"cpu": (params, adamw_init(params)), "cuda": (gparams, adamw_init(gparams))}
    data = SyntheticLM(cfg.vocab_size, seed=1)
    losses = {"cpu": [], "cuda": []}
    before = ops.launch_counts()["flash_attention_float32"]
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i, 4, 64).items()}
        for dev in ("cpu", "cuda"):
            p, o, m = step(*state[dev], {k: t.to(dev) for k, t in batch.items()})
            state[dev] = (p, o)
            losses[dev].append(float(m["loss"]))
    # remat: each layer's attention runs twice a microbatch (forward, recompute).
    assert ops.launch_counts()["flash_attention_float32"] - before == 2 * 2 * 2 * cfg.n_layers
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    for name in ("embed", "lm_head"):
        np.testing.assert_allclose(state["cuda"][0][name].cpu().numpy(),
                                   state["cpu"][0][name].numpy(), rtol=1e-4, atol=1e-4)


def test_trainer_on_the_card_resumes(cuda, tmp_path):
    """The Trainer on the card: 3 steps with an async checkpoint at 2 and the
    final one at 3, then a second Trainer resumes at step 3 with the same
    parameters and moments (within the store's 2^-23)."""
    from repro_torch.launch.train import Trainer

    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), d_head=32)
    tr = Trainer(cfg, str(tmp_path), ckpt_every=2)
    rep = tr.fit(steps=3, batch=2, seq=64)
    assert not rep.resumed and all(np.isfinite(rep.losses))
    tr2 = Trainer(cfg, str(tmp_path), ckpt_every=2)
    step, params, opt, resumed = tr2._init_or_resume()
    assert resumed and step == 3 and int(opt["step"]) == 3
    for got, want in ((params["embed"], tr._params["embed"]),
                      (opt["m"]["embed"], tr._opt["m"]["embed"]),
                      (opt["v"]["lm_head"], tr._opt["v"]["lm_head"])):
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=2 ** -23)
    rep2 = tr2.fit(steps=1, batch=2, seq=64)
    assert (rep2.resumed, rep2.start_step, rep2.end_step) == (True, 3, 4)


def _assert_engine_mirrors(eng):
    for dim in eng.index_cache.dims():
        _assert_mirror(eng.index_cache.get(dim))


def _served_card_engine(root):
    from repro_torch.server import ModelStoreServer, StoreClient

    eng = StorageEngine(str(root), device="cuda")
    server = ModelStoreServer(eng).start()
    return eng, server, StoreClient(server.host, server.port, tenant="t0")


def _toy_models(seed=0):
    rng = np.random.default_rng(seed)
    base = {"w": rng.normal(0, 0.2, (48, 64)).astype(np.float32),
            "v": rng.normal(0, 0.2, (32, 64)).astype(np.float32),
            "g": np.ones(64, np.float32)}
    return base, {k: (x + rng.normal(0, 1e-3, x.shape)).astype(np.float32)
                  for k, x in base.items()}


def test_server_upload_launches_quantized_l2_from_a_handler_thread(cuda, tmp_path, monkeypatch):
    """An HTTP upload on a CUDA engine probes on the card from the server's
    handler thread; the mirrors stay equal to the host arrays and the
    downloads equal the engine's own loads."""
    import threading

    from repro_torch.store import SaveRequest

    seen = []
    seam = ops.quantized_l2

    def spy(queries, *rest):
        seen.append((threading.current_thread() is threading.main_thread(), queries.device))
        return seam(queries, *rest)

    monkeypatch.setattr(ops, "quantized_l2", spy)
    base, ft = _toy_models()
    eng, server, client = _served_card_engine(tmp_path)
    try:
        client.save(SaveRequest("base", base))
        before = (ops.launch_counts()["quantized_l2"], dict(mirror_uploads))
        rep = client.save(SaveRequest("ft", ft))
        assert {ex["outcome"] for ex in rep.explain} == {"delta"}
        assert ops.launch_counts()["quantized_l2"] > before[0]
        assert mirror_uploads["rows"] == before[1]["rows"]
        assert seen and all(not main and dev.type == "cuda" for main, dev in seen)
        _assert_engine_mirrors(eng)
        for bits in (None, 8, 4):
            got = client.load("ft", bits=bits).materialize()
            want = eng.load_model("t0/ft", bits=bits).materialize()
            assert {k: v.tobytes() for k, v in got.items()} == \
                {k: v.tobytes() for k, v in want.items()}
    finally:
        client.close()
        server.stop()
        eng.close()


def test_server_delete_and_vacuum_compact_a_cuda_mirror(cuda, tmp_path):
    """Delete a model of new bases over HTTP and vacuum: the compacted
    indexes are clones uploaded whole once, their mirrors equal the host
    arrays, and the surviving model downloads unchanged."""
    from repro_torch.store import SaveRequest

    base, ft = _toy_models()
    rng = np.random.default_rng(5)
    scratch = {"a": rng.normal(0, 1, (48, 64)).astype(np.float32),
               "b": rng.normal(0, 1, (32, 64)).astype(np.float32)}
    eng, server, client = _served_card_engine(tmp_path)
    try:
        client.save(SaveRequest("base", base))
        client.save(SaveRequest("ft", ft))
        want = {k: v.tobytes() for k, v in client.load("ft", bits=8).materialize().items()}
        rep = client.save(SaveRequest("scratch", scratch))
        assert rep.n_new_bases == 2
        client.delete("scratch")
        rows = {d: len(eng.index_cache.get(d)) for d in (48 * 64, 32 * 64)}
        before = dict(mirror_uploads)
        vac = client.vacuum(0.0)
        assert sorted(int(d) for d in vac["dims"]) == sorted(rows)
        assert vac["vertices_dropped"] == 2
        assert mirror_uploads["index"] - before["index"] == sum(n * d for d, n in rows.items())
        for d, n in rows.items():
            assert len(eng.index_cache.get(d)) == n - 1
        _assert_engine_mirrors(eng)
        got = {k: v.tobytes() for k, v in client.load("ft", bits=8).materialize().items()}
        assert got == want
    finally:
        client.close()
        server.stop()
        eng.close()


def test_concurrent_downloads_during_a_save_on_the_card(cuda, tmp_path):
    """Readers download over HTTP while a writer's upload probes on the
    card: every download is byte-identical and the save dedups."""
    import threading

    from repro_torch.server import StoreClient
    from repro_torch.store import SaveRequest

    base, ft = _toy_models()
    rng = np.random.default_rng(9)
    ft2 = {k: (x + rng.normal(0, 1e-3, x.shape)).astype(np.float32) for k, x in base.items()}
    eng, server, client = _served_card_engine(tmp_path)
    try:
        client.save(SaveRequest("base", base))
        client.save(SaveRequest("ft", ft))
        want = {k: v.tobytes() for k, v in client.load("ft", bits=8).materialize().items()}
        errors, got, stop = [], [], threading.Event()

        def read():
            reader = StoreClient(server.host, server.port, tenant="t0")
            try:
                while not stop.is_set():
                    got.append({k: v.tobytes()
                                for k, v in reader.load("ft", bits=8).materialize().items()})
            except Exception as exc:  # surfaced below
                errors.append(exc)
            finally:
                reader.close()

        threads = [threading.Thread(target=read) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            rep = client.save(SaveRequest("ft2", ft2))
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        assert not any(t.is_alive() for t in threads) and not errors
        assert got and all(g == want for g in got)
        assert {ex["outcome"] for ex in rep.explain} == {"delta"}
        _assert_engine_mirrors(eng)
    finally:
        client.close()
        server.stop()
        eng.close()


@pytest.mark.parametrize("kind", ["one matmul", "a chain of elementwise kernels"])
def test_queued_event_ms_agrees_with_the_trace(cuda, kind):
    """``profile_steps.queued_event_ms``, the fall-back of the script's
    device-only times, against ``kernel_ms`` on the same call: within a
    quarter of the traced time plus 50 µs (the events also hold the gaps
    between kernels on the card)."""
    from repro_torch.launch.profile_steps import kernel_ms, queued_event_ms

    gen = torch.Generator(device=cuda).manual_seed(0)
    flush = torch.zeros(32 << 20, dtype=torch.float64, device=cuda)
    if kind == "one matmul":
        a = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16, generator=gen)

        def fn():
            return a @ a
    else:
        x = torch.randn(1 << 22, device=cuda, generator=gen)

        def fn():
            for _ in range(50):
                x.mul_(1.0001)

    traced = kernel_ms(fn, 10, lambda: flush.add_(1.0))
    timed = queued_event_ms(fn, 10, lambda: flush.add_(1.0))
    assert abs(timed - traced) <= 0.25 * traced + 0.05, (timed, traced)


def test_sharded_train_step_over_nccl_is_the_unsharded_step(cuda):
    """``launch.shardings.sharded`` over a world-size-1 NCCL group and a
    (1, 1) ("data", "model") mesh: internlm2 smoke (float32, head dim 32
    for the kernel), 2 microbatches, 3 steps; loss, params and moments
    bit-identical to the unsharded step on the card, with the attention
    kernel launched on the sharded path."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), d_head=32)
    data = SyntheticLM(cfg.vocab_size, seed=3)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in data.batch(i, 4, 64).items()}
               for i in range(3)]
    params = init_params(cfg, seed=0, device=cuda)
    opt = adamw_init(params)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with sh.use_mesh(mesh) as ctx:
            p_spec = shd.param_specs_tree(params, ctx)
            o_spec = shd.opt_specs_tree(None, p_spec)
            rows = shd.per_batch(shd.batch_specs_tree(batches[0], ctx))
            step = shd.sharded(make_train_step(cfg, 2), (p_spec, o_spec, rows),
                               (p_spec, o_spec, None), ctx)
        s_params, s_opt = shd.place(params, p_spec, mesh), shd.place(opt, o_spec, mesh)
        plain = make_train_step(cfg, 2)
        for b in batches:
            before = ops.launch_counts()["flash_attention_float32"]
            s_params, s_opt, s_m = step(s_params, s_opt, b)
            assert ops.launch_counts()["flash_attention_float32"] > before
            params, opt, m = plain(params, opt, b)
            assert torch.equal(s_m["loss"], m["loss"])
            full = [x.full_tensor() for x in tree_leaves([s_params, s_opt])]
            want = tree_leaves([params, opt])
            assert all(torch.equal(a, w) for a, w in zip(full, want))
    finally:
        dist.destroy_process_group()


# A step split over ``model`` against the unsharded step on the card,
# float32 without tf32: the partial sums over the model ranks add in
# another order. The losses within TP_TOL; the gradients, moments and
# weights after each step held by tests/test_torch_tensor_parallel.py's
# ``adam_state_gaps`` at TP_TOL (AdamW turns a gradient within its own
# rounding into a weight up to 2 lr apart: each weight is held within
# TP_TOL plus what the two runs' own moments make of its updates).
TP_TOL = dict(rtol=1e-4, atol=1e-5)


def _four_rank_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One of four NCCL ranks on a (2, 2) ("data", "model") mesh, a card
    each: two sharded train steps under each rule table, the state gathered
    whole and saved by rank 0."""
    import os

    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, 4), rank=rank, world_size=4)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
        cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), d_head=32)
        data = SyntheticLM(cfg.vocab_size, seed=3)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i, 4, 64).items()}
                   for i in range(2)]
        mesh = make_mesh((2, 2), ("data", "model"))
        out = {}
        for profile in ("tp", "dp"):
            params = init_params(cfg, seed=0, device=dev)
            with sh.use_mesh(mesh, profile=profile) as ctx:
                p_spec = shd.param_specs_tree(params, ctx)
                o_spec = shd.opt_specs_tree(None, p_spec)
                rows = shd.per_batch(shd.batch_specs_tree(batches[0], ctx))
                step = shd.sharded(make_train_step(cfg, 1), (p_spec, o_spec, rows),
                                   (p_spec, o_spec, None), ctx, cfg=cfg)
            p, o = shd.place(params, p_spec, mesh), shd.place(adamw_init(params), o_spec, mesh)
            losses, states = [], []
            for b in batches:
                p, o, m = step(p, o, b)
                losses.append(m["loss"].cpu())
                states.append(tree_map(lambda x: x.full_tensor().cpu(), [p, o]))
            out[profile] = (losses, states, step.route)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "out.pt"))
    finally:
        dist.destroy_process_group()


# The (1, 4) cases, in float32 so that they are held to TP_TOL, 2 steps on 4
# x 512 batches: internlm2-1.8b's widths (d_model 2048, 16 heads on 8 KV
# heads, d_ff 8192, vocab 92,544: each divides over 4) at 2 layers; the
# recurrent models (TP4_RECURRENT): recurrentgemma-9b's widths at one period
# (rglru, rglru, local_attn; d_rnn 4096, 16 heads of 256 on 1 KV head,
# window 2048, d_ff 12,288), its vocabulary cut from 256,000 to 65,536: at
# 256,000 the embedding and the head are 2.1 B of the period's 2.75 B
# parameters, and their float32 params and moments (33 GB), the gradients and
# the new state make the unsharded step (and the gathered route, which
# gathers them whole) need about 100 GB on one card; rwkv6-7b's widths at 2
# layers (64 heads of 64, d_ff 14,336, vocab 65,536).
TP4_LAYERS, TP4_BATCH, TP4_LEN, TP4_STEPS, TP4_LR = 2, 4, 512, 2, 1e-4
TP4_RECURRENT = {"recurrentgemma-9b": dict(n_layers=3, tail=(), tail_mix=(), vocab_size=65_536),
                 "rwkv6-7b": dict(n_layers=2)}
# The recurrent models' first-step gradients are held within TP_TOL's rtol in
# relative L2 a leaf (internlm2's within GRAD_RTOL, 1e-5): at d_model 4096 in
# float32 the split products' rounding, carried through the RG-LRU's
# recurrence over 512 positions, put recurrentgemma's 1.0e-5 to 1.4e-5 apart
# on four H100s. rwkv6-7b at random weights is ill-conditioned in float32
# (chip_smoke.py phase 10 (e)): its whole-model first-step gradients were
# 2.2e-5 to 3.0e-4 apart and its second step's 1e-3, so its whole train
# state is printed and each layer is held at its own inputs (_tp4_layers):
# its output and every gradient within TP_TOL's rtol in relative L2, every
# gradient element within TP_TOL.
TP4_LAYERWISE = {"rwkv6-7b"}


# The routed experts on a (2, 2) mesh (TP4_MOE), in float32, TP4_STEPS steps
# on TP4_BATCH x TP4_LEN batches: granite-moe-3b-a800m's widths (d_model
# 1536, 24 heads on 8 KV heads, 40 experts of d_ff 512, top 8, vocab 49,155)
# at 2 layers, its capacity factor 1.25, so that pairs are dropped: 20
# experts a data rank, 256 hidden columns a model rank; arctic-480b's
# (d_model 7168, 56 heads on 8 KV heads, d_ff 4864, top 2, a dense SwiGLU
# residual beside the experts, vocab 32,000) at 1 layer with its experts cut
# from 128 to 8: at 128, a rank's float32 weights, gradients and moments of
# one layer would come to about 54 GB, and the unsharded step that the split
# one is held to would not fit on one card. The unsharded step runs 2
# microbatches, one a data-parallel rank.
TP4_MOE = {"granite-moe-3b-a800m": dict(n_layers=2),
           "arctic-480b": dict(n_layers=1, n_experts=8)}
# arctic's prefill and serve step at 1 layer with all 128 experts in bfloat16
# (a rank holds 6.7 GB of experts on the tp route, 26.8 GB once the gathered
# route has gathered them): a TP4_PREFILL prefill and one serve step, each
# route's last-position logits within FA_LOGITS_ATOL of the gathered route's
# (PERF.md section 2: the bf16 attention kernel's logits tolerance), and the
# same argmax on every row whose top-2 margin exceeds it.
TP4_PREFILL = (4, 2048)
FA_LOGITS_ATOL = 0.15
# The compressed serve step's steps a turn on the (1, 4) mesh: the decode
# of chip_smoke.py's phases 11 and 12 (f), 16 tokens at batch TP4_BATCH.
TP4_COMPRESSED_STEPS = 16


def _tp4_config(arch: str):
    cut = TP4_RECURRENT.get(arch) or TP4_MOE.get(arch) or dict(n_layers=TP4_LAYERS)
    return dataclasses.replace(get_config(arch), param_dtype="float32",
                               compute_dtype="float32", **cut)


def _tp4_worker(rank: int, store_path: str, out_dir: str, arch: str = "internlm2-1.8b",
                mesh_shape: tuple = (1, 4)) -> None:
    """One of four NCCL ranks on a ``mesh_shape`` ("data", "model") mesh:
    TP4_STEPS train steps at ``arch``'s widths (``_tp4_config``) on the
    "tp" route and on the gathered route, in turns (tp, gathered, tp,
    gathered), each from the same weights: each rank's ms a step and peak
    memory a route; rank 0 then runs the unsharded step on its card (a
    microbatch a data-parallel rank) and holds the first turn's states to
    it (the tp route's by ``adam_state_gaps``, the gathered route's bits,
    and at more than one data-parallel rank by ``adam_state_gaps`` too)."""
    import json
    import os
    import time

    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    from test_torch_tensor_parallel import GRAD_RTOL, adam_state_gaps

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, 4), rank=rank, world_size=4)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
        cfg = _tp4_config(arch)
        data = SyntheticLM(cfg.vocab_size, seed=3)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    data.batch(i, TP4_BATCH, TP4_LEN).items()} for i in range(TP4_STEPS)]
        mesh = make_mesh(mesh_shape, ("data", "model"))
        train = make_train_step(cfg, 1, lr=TP4_LR)
        params = init_params(cfg, seed=0, device=dev)
        with sh.use_mesh(mesh) as ctx:
            p_spec = shd.param_specs_tree(params, ctx)
            o_spec = shd.opt_specs_tree(None, p_spec)
            rows = shd.per_batch(shd.batch_specs_tree(batches[0], ctx))
            specs = ((p_spec, o_spec, rows), (p_spec, o_spec, None), ctx)
            steps = {route: shd.sharded(train, *specs, cfg=cfg, route=route)
                     for route in ("tp", "gathered")}
        report = {"routes": {k: v.route for k, v in steps.items()}, "ms": {}, "peak": {},
                  "exchanges": {}}
        kept = {}
        for turn in range(2):
            for route, step in steps.items():
                p = shd.place(params, p_spec, mesh)
                o = shd.place(adamw_init(params), o_spec, mesh)
                if cfg.n_experts:
                    wg = tree_leaves(p["periods"])[[k for k in _paths(p["periods"])].index(
                        "slot0/mix/wg")]
                    report.setdefault("expert_shard", {})[route] = list(wg.to_local().shape)
                losses, states, peak = [], [], 0
                sh.reset_exchange_counts()
                for b in batches:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    p, o, m = step(p, o, b)
                    torch.cuda.synchronize()
                    report["ms"].setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
                    peak = max(peak, torch.cuda.max_memory_allocated())
                    losses.append(float(m["loss"]))
                    if turn == 0:  # each step's whole state, to rank 0's host memory
                        whole = tree_map(lambda x: x.full_tensor(), [p, o])  # every rank joins
                        states.append(tree_map(lambda x: x.cpu(), whole) if rank == 0 else None)
                        del whole
                report["peak"].setdefault(route, []).append(peak)
                report["exchanges"].setdefault(route, []).append(sh.exchange_counts()["calls"])
                if turn == 0:
                    kept[route] = (losses, states)
                del p, o
                torch.cuda.empty_cache()
        if arch in TP4_LAYERWISE:
            report["layers"] = _tp4_layers(cfg, params, batches[0], mesh, rank)
        if rank == 0:
            plain = make_train_step(cfg, mesh_shape[0], lr=TP4_LR)
            u_p, u_o = params, adamw_init(params)
            losses, want = [], []
            for b in batches:
                u_p, u_o, m = plain(u_p, u_o, b)
                losses.append(float(m["loss"]))
                want.append([u_p, u_o])
            report["losses"] = losses
            first_rtol = TP_TOL["rtol"] if arch in TP4_RECURRENT else GRAD_RTOL
            bad, seen = adam_state_gaps(kept["tp"][1], want, TP4_LR, TP_TOL,
                                        first_rtol=first_rtol)
            final = tree_leaves(kept["gathered"][1][-1])
            report["against_unsharded"] = {
                "tp": {"losses": kept["tp"][0], "past_tolerance": bad, "seen": seen},
                "gathered": {"losses": kept["gathered"][0],
                             "bit_identical": all(torch.equal(a.to(b.device), b) for a, b
                                                  in zip(final, tree_leaves(want[-1]),
                                                         strict=True))}}
            if mesh_shape[0] > 1:
                # NCCL sums the data-parallel ranks' gradients, the unsharded
                # step its microbatches': held as the tp route is.
                report["against_unsharded"]["gathered"]["past_tolerance"] = adam_state_gaps(
                    kept["gathered"][1], want, TP4_LR, TP_TOL, first_rtol=first_rtol)[0]
        with open(os.path.join(out_dir, f"tp4_r{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _tp4_layers(cfg, params, batch, mesh, rank: int) -> list | None:
    """Each layer of ``cfg`` at its own inputs, on the tp route against
    the unsharded layer: the unsharded model's input to the layer and the
    gradient of the train loss at its output (each rank computes both on
    its card, from the same weights and batch) go through the layer, whose
    output ``y`` and gradients (of its parameters and its input) are
    compared. On rank 0: a list, a layer, of (what, shape, relative L2
    error, elements past TP_TOL, elements); None elsewhere. (``y``'s
    elements are not held to TP_TOL: on four H100s 1 to 109 of its 8.4 M,
    near zero, were past it at relative L2 errors of 1.6e-6 to 4.3e-6.)"""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings as shd
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_map

    b, s = batch["tokens"].shape
    positions = torch.arange(s, device=batch["tokens"].device).expand(b, s)
    layers = [(f"period {i} slot {j} {kinds}", sb, mb, tf._index(params["periods"][f"slot{j}"], i))
              for i in range(cfg.n_periods)
              for j, (kinds, (sb, mb)) in enumerate(zip(zip(cfg.period, cfg.mix),
                                                       tf._blocks_for_period(cfg)))]
    layers += [(f"tail {i}", sb, mb, params["tail"][i])
               for i, (sb, mb) in enumerate(tf._blocks_for_tail(cfg))]
    with torch.enable_grad():
        x = tf._embed_in(cfg, params, batch).detach().requires_grad_(True)
        ins, outs = [], []
        for _, sb, mb, p in layers:
            ins.append(x.detach())
            x = tf._apply_layer(cfg, sb, mb, p, x, positions)
            outs.append(x)
        loss = tf._nll(tf._logits(cfg, params, x).to(torch.float32),
                       batch["labels"].to(torch.int64)).mean()
        cots = torch.autograd.grad(loss, outs)
    del x, outs, loss

    def layer_step(sb, mb):
        def step(p, xg):
            diff = tree_map(lambda t: t.detach().requires_grad_(True), p)
            x = xg["x"].detach().requires_grad_(True)
            with torch.enable_grad():
                y = tf._apply_layer(cfg, sb, mb, diff, x, positions)
                dot = sh.unsplit((y * xg["g"]).sum())
                leaves = tree_leaves(diff)
                grads = torch.autograd.grad(dot, leaves + [x], allow_unused=True)
            placed = [torch.zeros_like(w) if g is None else
                      g if not hasattr(w, "placements") or g.placements == w.placements else
                      g.redistribute(w.device_mesh, w.placements)
                      for w, g in zip(leaves, grads)]
            it = iter(placed)
            return {"y": y.detach(), "dx": grads[-1]}, tree_map(lambda _: next(it), p)
        return step

    out = []
    for (label, sb, mb, p), x, g in zip(layers, ins, cots, strict=True):
        step = layer_step(sb, mb)
        with sh.use_mesh(mesh) as ctx:
            p_spec = shd.param_specs_tree(p, ctx)
            rows = shd.per_batch(ctx.spec("residual"))
            split = shd.sharded(step, (p_spec, shd.per_batch({"x": rows.specs, "g": rows.specs})),
                                (shd.per_batch(None), p_spec), ctx, cfg=cfg)
        got = split(shd.place(p, p_spec, mesh), {"x": x, "g": g})
        got = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, list(got))
        if rank != 0:
            continue
        want = step(p, {"x": x, "g": g})
        names = ["y", "dx"] + [f"d{k}" for k in _paths(p)]
        seen = []
        for what, a, w in zip(names, tree_leaves(got), tree_leaves(list(want)), strict=True):
            a, w = a.double(), w.double()
            rel = float((a - w).norm() / w.norm()) if float(w.norm()) > 0 else float(a.norm())
            past = int(((a - w).abs() > TP_TOL["atol"] + TP_TOL["rtol"] * w.abs()).sum())
            seen.append((what, list(w.shape), rel, past, w.numel()))
        out.append({"layer": label, "route": split.route, "seen": seen})
    return out if rank == 0 else None


def _paths(tree, prefix="") -> list:
    """The leaves' paths of a tree of dicts, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _spawn_four(target, tmp_path, *extra) -> None:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(tmp_path / "store"), str(tmp_path)) + extra)
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive and [p.exitcode for p in procs] == [0] * 4


def test_sharded_train_step_over_nccl_at_four_ranks(cuda, tmp_path):
    """Four cards, one NCCL rank each, a (2, 2) mesh: the sharded train
    step under ``"tp"`` (2 data-parallel ranks, each step split over
    ``model`` pairs) against the unsharded step with 2 microbatches on one
    card, the losses within ``TP_TOL`` and the state of each step held by
    ``adam_state_gaps`` at ``TP_TOL``; under ``"dp"`` (4 data-parallel
    ranks) within rtol 1e-4 / atol 1e-5 of the one with 4 (NCCL adds the
    four gradients in another order than the microbatch loop)."""
    from test_torch_tensor_parallel import adam_state_gaps

    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _spawn_four(_four_rank_worker, tmp_path)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), d_head=32)
    data = SyntheticLM(cfg.vocab_size, seed=3)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in data.batch(i, 4, 64).items()}
               for i in range(2)]
    for profile, n in (("tp", 2), ("dp", 4)):
        params = init_params(cfg, seed=0, device=cuda)
        opt = adamw_init(params)
        plain = make_train_step(cfg, n)
        losses, want = [], []
        for b in batches:
            params, opt, m = plain(params, opt, b)
            losses.append(m["loss"].cpu())
            want.append(tree_map(lambda x: x.cpu(), [params, opt]))
        got_losses, got_states, route = got[profile]
        assert route == ("tp" if profile == "tp" else "gathered")
        np.testing.assert_allclose(torch.stack(got_losses).numpy(),
                                   torch.stack(losses).numpy(), rtol=1e-4, atol=1e-5)
        if profile == "tp":
            bad, seen = adam_state_gaps(got_states, want, 1e-4, TP_TOL)
            print("\n".join(seen))
            assert not bad, bad
        else:
            for a, b in zip(tree_leaves(got_states[-1]), tree_leaves(want[-1])):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_tensor_parallel_train_step_at_internlm2_widths_on_four_cards(cuda, tmp_path):
    """Four cards, a (1, 4) mesh, internlm2-1.8b's widths at 2 layers in
    float32: the step split over ``model`` against the unsharded step on
    one card, the losses within ``TP_TOL`` and the state of each step held
    by ``adam_state_gaps`` at ``TP_TOL`` (the gathered route bit-identical
    to it); each rank's peak memory and ms a step on both routes are
    printed."""
    _hold_tp4(tmp_path, "internlm2-1.8b")


def _tp4_compressed_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One of four NCCL ranks on a (1, 4) mesh: internlm2-1.8b's widths at
    TP4_LAYERS layers in float32 (``_tp4_config``), quantized on the host
    (``quantize_params``: every rank the same bytes) and placed by
    ``compressed_param_specs_tree`` under the serving table, each rank
    uploading its part alone; the compressed serve step on the tp route
    and on the gathered route in turns (tp, gathered, tp, gathered), each
    turn TP4_COMPRESSED_STEPS steps fed the same prompt tokens: each
    rank's storage-format bytes, its peak memory across a turn's steps
    (reset after placing) and its ms a step; in the first turn the tokens
    and the last-position logits of ``decode_step`` over the rebuilt
    parameters. Then every leaf rebuilt on the tp route, gathered, against
    rank 0's ``dequantize_leaf`` of the whole leaf."""
    import json
    import os
    import time

    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import compressed_serve as cs
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import model_specs
    from repro_torch.tree import tree_leaves

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, 4), rank=rank, world_size=4)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
        cfg = _tp4_config("internlm2-1.8b")
        b, n = TP4_BATCH, TP4_COMPRESSED_STEPS
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (b, n))).to(dev)
        t0 = time.perf_counter()
        host = cs.quantized_to_device(cs.quantize_params(init_params(cfg, seed=0, device=dev)),
                                      "cpu")
        quantize_s = time.perf_counter() - t0
        mesh = make_mesh((1, 4), ("data", "model"))

        @torch.no_grad()
        def decode(qparams, cache, batch, pos):
            logits, cache = decode_step(cs.dequantize_params(qparams, torch.float32), cache,
                                        batch, pos, cfg)
            return sh.unsplit(logits[:, -1], 1).to(torch.float32), cache

        def rebuild(qparams, batch):
            return (cs.dequantize_params(qparams, torch.float32),)

        with sh.use_mesh(mesh, seq_shard=False, serve=True) as ctx:
            q_spec = shd.compressed_param_specs_tree(host, ctx)
            p_spec = shd.param_specs_tree(model_specs(cfg), ctx)
            c_spec = shd.cache_specs_tree(init_cache(cfg, b, n, device=dev), ctx,
                                          cfg.n_kv_heads)
            rows = shd.per_batch(shd.batch_specs_tree({"tokens": prompts[:, :1]}, ctx))
            step_specs = ((q_spec, shd.per_batch(c_spec), rows, None),
                          (shd.per_batch(None), shd.per_batch(c_spec)), ctx)
            paths = {route: (shd.sharded(cs.make_compressed_serve_step(cfg), *step_specs,
                                         cfg=cfg, route=route),
                             shd.sharded(decode, *step_specs, cfg=cfg, route=route))
                     for route in ("tp", "gathered")}
            rebuilt = shd.sharded(rebuild, (q_spec, rows), (p_spec,), ctx, cfg=cfg)
        t0 = time.perf_counter()
        placed = shd.place(host, q_spec, mesh)
        torch.cuda.synchronize()
        report = {"routes": {k: v[0].route for k, v in paths.items()},
                  "quantize_s": quantize_s, "place_s": time.perf_counter() - t0,
                  "storage_bytes": {"tp": shd.local_bytes(placed),
                                    "gathered": sum(x.numel() * x.element_size()
                                                    for x in tree_leaves(host))},
                  "ms": {}, "peak": {}}
        out = {}
        for turn in range(2):
            for route, (serve, logits_step) in paths.items():
                cache = shd.place(init_cache(cfg, b, n, device=dev), c_spec, mesh)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                toks = []
                for pos in range(n):
                    t0 = time.perf_counter()
                    tok, cache = serve(placed, cache, {"tokens": prompts[:, pos:pos + 1]}, pos)
                    torch.cuda.synchronize()
                    report["ms"].setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
                    toks.append(tok)
                report["peak"].setdefault(route, []).append(torch.cuda.max_memory_allocated())
                if turn == 0:
                    cache = shd.place(init_cache(cfg, b, n, device=dev), c_spec, mesh)
                    logits = []
                    for pos in range(n):
                        lg, cache = logits_step(placed, cache,
                                                {"tokens": prompts[:, pos:pos + 1]}, pos)
                        logits.append(lg.cpu())
                    out[route] = (torch.stack(toks, 1).cpu(), torch.stack(logits, 1))
                del cache
        got = rebuilt(placed, {"tokens": prompts[:, :1]})[0]
        same = []
        for (path, q), x in zip(cs._quantized_items(host), tree_leaves(got), strict=True):
            whole = x.full_tensor()  # every rank joins
            if rank == 0:
                on_card = {k: v.to(dev) for k, v in q.items()}
                want = cs.dequantize_leaf(on_card, torch.float32)
                same.append(("/".join(map(str, path)), bool(torch.equal(
                    whole.view(torch.int32) if whole.dtype == torch.float32 else whole,
                    want.view(torch.int32) if want.dtype == torch.float32 else want))))
                del on_card, want
            del whole
        report["rebuilt_bit_identical"] = same
        if rank == 0:
            torch.save({"report": report, "out": out}, os.path.join(out_dir, "tp4_compressed.pt"))
        with open(os.path.join(out_dir, f"tp4_compressed_r{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def test_compressed_serve_step_on_the_tp_route_on_four_cards(cuda, tmp_path):
    """Four cards, a (1, 4) mesh, internlm2-1.8b's widths at 2 layers in
    float32 on the storage format (``_tp4_compressed_worker``): each rank
    holds and rebuilds only its shard of every quantized weight on the tp
    route. Every rebuilt leaf, gathered, bit-identical to the whole leaf's
    rebuild; ``decode_step`` over the rebuilt parameters within
    ``TP_TOL`` of the gathered route's, and the tokens equal wherever the
    gathered route's logits' top-2 margin exceeds TP_TOL's atol; each
    rank's storage-format bytes, peak memory and ms a step on both routes
    printed, the tp route's bytes below a third of the gathered route's
    and its peak below half."""
    import json

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _spawn_four(_tp4_compressed_worker, tmp_path)
    got = torch.load(tmp_path / "tp4_compressed.pt", weights_only=False)
    reports = [json.loads((tmp_path / f"tp4_compressed_r{r}.json").read_text())
               for r in range(4)]
    for r, rep in enumerate(reports):
        print(f"compressed serve step, internlm2-1.8b widths, 2 layers, float32, (1, 4) rank {r}: "
              f"storage-format bytes {rep['storage_bytes']}, peak bytes {rep['peak']}, ms a step "
              f"{rep['ms']}; quantize_params {rep['quantize_s']:.3f} s, placed in "
              f"{rep['place_s']:.3f} s")
        assert rep["routes"] == {"tp": "tp", "gathered": "gathered"}
        assert rep["storage_bytes"]["tp"] * 3 < rep["storage_bytes"]["gathered"]
        assert max(rep["peak"]["tp"]) * 2 < min(rep["peak"]["gathered"])
    same = got["report"]["rebuilt_bit_identical"]
    assert same and all(ok for _, ok in same), same
    (tp_toks, tp_logits), (g_toks, g_logits) = got["out"]["tp"], got["out"]["gathered"]
    gap = float((tp_logits - g_logits).abs().max())
    top2 = torch.topk(g_logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > TP_TOL["atol"]
    print(f"tp route's logits max gap {gap:.3e} from the gathered route's; tokens equal on the "
          f"{int(clear.sum())} of {clear.numel()} steps whose top-2 margin exceeds "
          f"{TP_TOL['atol']}; every token equal {bool(torch.equal(tp_toks, g_toks))}")
    np.testing.assert_allclose(tp_logits.numpy(), g_logits.numpy(), **TP_TOL)
    assert torch.equal(tp_toks[clear], g_toks[clear])


@pytest.mark.parametrize("arch", list(TP4_MOE))
def test_expert_parallel_train_step_of_the_moe_models_on_four_cards(cuda, tmp_path, arch):
    """Four cards, a (2, 2) mesh, float32: granite-moe-3b-a800m's widths
    at 2 layers (capacity factor 1.25: pairs dropped) and arctic-480b's at
    1 layer with 8 of its 128 experts (``TP4_MOE``), the experts split over
    the 2 data-parallel ranks (20 and 4 a rank) and each expert's hidden
    over the 2 model ranks (256 and 2,432 columns), the tokens exchanged by
    an NCCL all-to-all; held to the unsharded step with 2 microbatches on
    one card as the other widths are (the losses within ``TP_TOL``, each
    step's state by ``adam_state_gaps``, the first step's gradients within
    ``GRAD_RTOL``; the gathered route by ``adam_state_gaps`` too); each
    rank's peak memory and ms a step on both routes printed, the tp
    route's peak below the gathered route's."""
    _hold_tp4(tmp_path, arch, (2, 2))


@pytest.mark.parametrize("arch", list(TP4_RECURRENT))
def test_tensor_parallel_train_step_of_the_recurrent_models_on_four_cards(cuda, tmp_path, arch):
    """Four cards, a (1, 4) mesh, float32: recurrentgemma-9b's widths at
    one period (its vocabulary cut, ``TP4_RECURRENT``) and rwkv6-7b's at 2
    layers, each rank scanning its own RG-LRU channels or running its own
    RWKV-6 heads; held to the unsharded step on one card as internlm2's
    widths are (the losses within ``TP_TOL``, each step's state by
    ``adam_state_gaps``, the first step's gradients within TP_TOL's rtol;
    rwkv6 layer by layer, ``TP4_LAYERWISE``; the gathered route
    bit-identical); each rank's peak memory and ms a step on both routes
    printed, the tp route's peak below the gathered route's."""
    _hold_tp4(tmp_path, arch)


def _hold_tp4(tmp_path, arch: str, mesh_shape: tuple = (1, 4)) -> None:
    import json

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _spawn_four(_tp4_worker, tmp_path, arch, mesh_shape)
    reports = [json.loads((tmp_path / f"tp4_r{r}.json").read_text()) for r in range(4)]
    for r, rep in enumerate(reports):
        print(f"{arch} {mesh_shape} rank {r}: ms a step {rep['ms']}, peak bytes {rep['peak']}, "
              f"exchanges {rep['exchanges']}, expert shard {rep.get('expert_shard')}")
    against = reports[0]["against_unsharded"]
    print(f"unsharded losses {reports[0]['losses']}; against them {against}")
    cfg = _tp4_config(arch)
    for r, rep in enumerate(reports):
        assert rep["routes"] == {"tp": "tp", "gathered": "gathered"}
        # Each rank holds its share of the weights and their moments.
        assert max(rep["peak"]["tp"]) < max(rep["peak"]["gathered"])
        if cfg.n_experts:
            # Its experts and their hidden columns; 2 exchanges a layer in
            # the forward, 2 in remat's recompute, on the tp route alone.
            d, m = mesh_shape
            assert rep["expert_shard"]["tp"] == [cfg.n_periods, cfg.n_experts // d,
                                                 cfg.d_model, cfg.d_ff // m]
            assert rep["exchanges"] == {"tp": [4 * cfg.n_layers * TP4_STEPS] * 2,
                                        "gathered": [0, 0]}
    for got in against.values():
        np.testing.assert_allclose(got["losses"], reports[0]["losses"], **TP_TOL)
    if mesh_shape[0] > 1:
        assert not against["gathered"]["past_tolerance"], against["gathered"]["past_tolerance"]
    else:
        assert against["gathered"]["bit_identical"]
    if arch not in TP4_LAYERWISE:
        assert not against["tp"]["past_tolerance"], against["tp"]["past_tolerance"]
        return
    bad = []
    for layer in reports[0]["layers"]:
        assert layer["route"] == "tp"
        for what, shape, rel, past, n in layer["seen"]:
            print(f"{arch} {layer['layer']} {what} {shape}: relative L2 {rel:.3e}, {past} of "
                  f"{n} elements past {TP_TOL}")
            if rel > TP_TOL["rtol"] or (past and what != "y"):
                bad.append((layer["layer"], what, rel, past))
    assert not bad, bad


def _moe_serve_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One of four NCCL ranks on a (2, 2) mesh: arctic-480b's widths at 1
    layer with all 128 experts in bfloat16, a TP4_PREFILL prefill and one
    serve step (the prompt's last token at position 0 of an empty cache)
    under the serving table, on the tp route and the gathered route in
    turns (tp, gathered, tp, gathered), from the same placed weights: each
    route's last-position logits, and each rank's ms and peak memory a
    turn."""
    import os
    import time

    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, 4), rank=rank, world_size=4)
    try:
        dev = torch.device("cuda", rank)
        cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=1)
        b = TP4_PREFILL[0]
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, TP4_PREFILL)).to(dev)
        mesh = make_mesh((2, 2), ("data", "model"))
        params = init_params(cfg, seed=0, device=dev)

        @torch.no_grad()
        def decode(params, cache, batch, pos):
            logits, cache = decode_step(params, cache, batch, pos, cfg)
            return sh.unsplit(logits[:, -1], 1).to(torch.float32), cache

        with sh.use_mesh(mesh, seq_shard=False, serve=True) as ctx:
            p_spec = shd.param_specs_tree(params, ctx)
            c_spec = shd.cache_specs_tree(init_cache(cfg, b, 16, device=dev), ctx, cfg.n_kv_heads)
            rows = shd.per_batch(shd.batch_specs_tree({"tokens": prompts}, ctx))
            paths = {route: (shd.sharded(make_prefill_step(cfg), (p_spec, rows),
                                         (shd.per_batch(None),), ctx, cfg=cfg, route=route),
                             shd.sharded(decode, (p_spec, shd.per_batch(c_spec), rows, None),
                                         (shd.per_batch(None), shd.per_batch(c_spec)), ctx,
                                         cfg=cfg, route=route))
                     for route in ("tp", "gathered")}
        placed = shd.place(params, p_spec, mesh)
        del params
        torch.cuda.empty_cache()
        report = {"routes": {k: v[0].route for k, v in paths.items()}, "prefill_ms": {},
                  "serve_ms": {}, "peak": {},
                  "expert_bytes": sum(x.to_local().numel() * x.to_local().element_size()
                                      for k, x in placed["periods"]["slot0"]["mix"].items()
                                      if k in ("wg", "wu", "wd"))}
        logits = {}
        for turn in range(2):
            for route, (prefill, serve) in paths.items():
                cache = shd.place(init_cache(cfg, b, 16, device=dev), c_spec, mesh)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                last = prefill(placed, {"tokens": prompts})
                torch.cuda.synchronize()
                report["prefill_ms"].setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                step, cache = serve(placed, cache, {"tokens": prompts[:, -1:]}, 0)
                torch.cuda.synchronize()
                report["serve_ms"].setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
                report["peak"].setdefault(route, []).append(torch.cuda.max_memory_allocated())
                if turn == 0:
                    logits[route] = (last.cpu(), step.cpu())
                del cache, last, step
        if rank == 0:
            torch.save({"report": report, "logits": logits}, os.path.join(out_dir, "moe_serve.pt"))
        else:
            torch.save({"report": report}, os.path.join(out_dir, f"moe_serve_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_expert_parallel_prefill_and_serve_of_arctic_on_four_cards(cuda, tmp_path):
    """Four cards, a (2, 2) mesh: arctic-480b's widths at 1 layer with all
    128 of its experts in bfloat16 (``TP4_PREFILL``), a prefill and a serve
    step on the tp route (64 experts a data rank, 2,432 hidden columns a
    model rank, the tokens exchanged by an NCCL all-to-all) against the
    gathered route (every expert gathered on every rank): the last-position
    logits of both within ``FA_LOGITS_ATOL``, and the same argmax on every
    row whose top-2 margin exceeds it; each rank's peak memory and ms
    printed, the tp route's peak below the gathered route's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _spawn_four(_moe_serve_worker, tmp_path)
    got = torch.load(tmp_path / "moe_serve.pt", weights_only=False)
    reports = [got["report"]] + [torch.load(tmp_path / f"moe_serve_r{r}.pt")["report"]
                                 for r in range(1, 4)]
    for r, rep in enumerate(reports):
        print(f"arctic-480b 1 layer, 128 experts, bf16, (2, 2) rank {r}: prefill ms "
              f"{rep['prefill_ms']}, serve step ms {rep['serve_ms']}, peak bytes {rep['peak']}, "
              f"expert bytes held {rep['expert_bytes']}")
        assert rep["routes"] == {"tp": "tp", "gathered": "gathered"}
        assert max(rep["peak"]["tp"]) < min(rep["peak"]["gathered"])
    for i, what in enumerate(("prefill", "serve step")):
        tp, whole = got["logits"]["tp"][i], got["logits"]["gathered"][i]
        gap = float((tp - whole).abs().max())
        top2 = torch.topk(whole, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > FA_LOGITS_ATOL
        same = torch.equal(tp.argmax(-1)[clear], whole.argmax(-1)[clear])
        print(f"arctic {what}: tp route's last-position logits max gap {gap:.4e} from the "
              f"gathered route's; argmax equal on the {int(clear.sum())} rows whose top-2 margin "
              f"exceeds {FA_LOGITS_ATOL}: {same}")
        assert gap <= FA_LOGITS_ATOL and same, what
