"""Tensor index: the port's HNSW gives the reference's neighbour ids.

On fixed seeds, ``repro_torch.core.hnsw.HNSWIndex(device="cpu")`` runs the
same numpy graph walk and decomposed distance as ``repro.core.hnsw`` and
must return the same vertex ids (and serialize to the same bytes). On a
CUDA index every distance block goes through the ``quantized_l2`` kernel
seam, with no size gate; that routing is checked here with the seam's
plain version standing in for the kernel.
"""

import numpy as np
import pytest
import torch

from repro.core import hnsw as r_hnsw
from repro_torch.core import hnsw as t_hnsw
from repro_torch.kernels import ops

DIM = 96


def _data(seed: int, n: int, centers: int = 6) -> np.ndarray:
    """Clustered rows (fine-tune-like neighbours around a few bases)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 1.0, (centers, DIM))
    pick = rng.integers(0, centers, n)
    return c[pick] + rng.normal(0.0, 0.05, (n, DIM))


def _pair(seed: int = 0):
    return (r_hnsw.HNSWIndex(DIM, m=8, ef_construction=32, seed=seed),
            t_hnsw.HNSWIndex(DIM, m=8, ef_construction=32, seed=seed, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequential_insert_and_search_same_ids(seed):
    ref, port = _pair(seed)
    rows = _data(seed, 50)
    for r in rows:
        assert port.insert(r) == ref.insert(r)
    for q in _data(seed + 100, 8):
        got, want = port.search(q, k=5), ref.search(q, k=5)
        assert [v for _, v in got] == [v for _, v in want]
        np.testing.assert_allclose([d for d, _ in got], [d for d, _ in want],
                                   rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_insert_batch_and_nearest_live_batch_same_ids(seed):
    ref, port = _pair(seed)
    rows = _data(seed, 40)
    assert port.insert_batch(rows[:25]) == ref.insert_batch(rows[:25])
    assert port.insert_batch(rows[25:], max_matrix_elems=64) == ref.insert_batch(
        rows[25:], max_matrix_elems=64)
    queries = _data(seed + 7, 12)
    for _ in range(2):
        gv, gd = port.nearest_live_batch(queries)
        wv, wd = ref.nearest_live_batch(queries)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_allclose(gd, wd, rtol=1e-12)
        for v in (int(wv[0]), int(wv[3])):  # tombstones then re-probe
            ref.mark_deleted(v)
            port.mark_deleted(v)
    assert port.to_bytes() == ref.to_bytes()


def test_state_pickle_bit_identical_and_cross_loads():
    ref, port = _pair(5)
    rows = _data(5, 30)
    ref.insert_batch(rows)
    port.insert_batch(rows)
    for v in (2, 9):
        ref.mark_deleted(v)
        port.mark_deleted(v)
    assert port.to_bytes() == ref.to_bytes()
    # Each package opens the other's index state.
    from_ref = t_hnsw.HNSWIndex.from_bytes(ref.to_bytes(), device="cpu")
    from_port = r_hnsw.HNSWIndex.from_bytes(port.to_bytes())
    assert from_ref.to_bytes() == from_port.to_bytes() == ref.to_bytes()
    assert from_ref.device == torch.device("cpu")
    assert from_ref.clone().device == torch.device("cpu")
    np.testing.assert_array_equal(from_ref.dequantize_vertex(4), ref.dequantize_vertex(4))
    assert from_ref.compact() == from_port.compact()
    assert from_ref.to_bytes() == from_port.to_bytes()


def test_quantized_l2_batch_identical():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 256, (20, DIM)).astype(np.uint8)
    scales = rng.uniform(1e-3, 2e-2, 20)
    scales[4] = 0.0
    zps = rng.integers(0, 256, 20)
    mids = rng.normal(0, 0.5, 20)
    q = rng.normal(0, 1, DIM)
    np.testing.assert_array_equal(
        t_hnsw.quantized_l2_batch(q, codes, scales, zps, mids),
        r_hnsw.quantized_l2_batch(q, codes, scales, zps, mids))


def test_cuda_index_sends_every_block_to_the_kernel_seam(monkeypatch):
    """A CUDA index never takes the numpy block path: every block, however
    small, goes to ``_offload_distances`` (here backed by the seam's plain
    version, since the card's kernel cannot run on this machine)."""
    ref, port = _pair(4)
    calls = []

    def seam(queries, codes, scales, zps, mids, device):
        assert device.type == "cuda"
        calls.append((np.atleast_2d(queries).shape[0], codes.shape[0]))
        return ops.quantized_l2_auto(queries, codes, scales, zps, mids,
                                     force="kernel", device="cpu")

    monkeypatch.setattr(t_hnsw, "_offload_distances", seam)
    port.device = torch.device("cuda")
    rows = _data(4, 20)
    ref.insert_batch(rows)
    port.insert_batch(rows)
    gv, gd = port.nearest_live_batch(rows[:5] + 0.01)
    wv, wd = ref.nearest_live_batch(rows[:5] + 0.01)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gd, wd, rtol=2e-3)
    assert calls == [(20, 20), (5, 20)]


def test_index_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_hnsw.HNSWIndex(DIM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_hnsw.HNSWIndex.from_bytes(r_hnsw.HNSWIndex(DIM).to_bytes())
