"""The HNSW index's device mirror of its codes, driven on the CPU.

A CUDA index keeps the vertex payload that the ``quantized_l2`` kernel
reads (codes, scales, zero-points, mids) in a ``CodeMirror`` on the card,
uploading each row once, when it enters the index, or once a whole index
when it is read from bytes. The helper runs on any torch device, so here it
runs on the CPU: directly, and inside an index that believes it is on the
card (its ``device`` is ``cuda``, its mirror on the CPU, and the kernel
seam backed by the plain version), held against ``repro.core.hnsw``.
Mirror contents are compared exactly (``torch.equal``); distances from the
plain dense version against the reference's decomposed form within the
kernel contract's rtol 2e-3, with the same ids.
"""

import numpy as np
import pytest
import torch

from repro.core import hnsw as r_hnsw
from repro_torch.core import hnsw as t_hnsw
from repro_torch.kernels import ops

DIM = 96


def _data(seed: int, n: int, dim: int = DIM, centers: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 1.0, (centers, dim))
    return c[rng.integers(0, centers, n)] + rng.normal(0.0, 0.05, (n, dim))


def _assert_mirrors(idx) -> None:
    """The mirror's first ``len(idx)`` rows equal the host arrays."""
    n = len(idx)
    codes, scales, zps, mids = idx.mirror.view(n)
    assert codes.dtype == torch.uint8 and scales.dtype == zps.dtype == mids.dtype == torch.float64
    assert torch.equal(codes, torch.from_numpy(idx._codes[:n]))
    assert torch.equal(scales, torch.from_numpy(idx._scales[:n]))
    assert torch.equal(zps, torch.from_numpy(idx._zps[:n].astype(np.float64)))
    assert torch.equal(mids, torch.from_numpy(idx._mids[:n]))
    assert idx.mirror.codes.shape[0] == idx._cap


@pytest.fixture
def card_on_cpu(monkeypatch):
    """Indexes built for ``cuda`` on this machine: the device resolves
    without a card, the mirror lies on the CPU, and the kernel seam (which
    records what it is given) runs the plain version."""
    calls = []

    def seam(queries, codes, scales, zps, mids, device):
        assert device.type == "cuda"
        assert isinstance(codes, torch.Tensor) and isinstance(scales, torch.Tensor)
        calls.append((np.atleast_2d(queries).shape[0], codes.clone(), codes.data_ptr()))
        return ops.quantized_l2_auto(queries, codes, scales, zps, mids, force="kernel",
                                     device="cpu")

    monkeypatch.setattr(t_hnsw.ops, "resolve_device", torch.device)
    monkeypatch.setattr(t_hnsw, "CodeMirror", lambda dim, device: _CpuMirror(dim))
    monkeypatch.setattr(t_hnsw, "_offload_distances", seam)
    return calls


def _uploads_counter():
    """A function giving the code bytes the mirrors uploaded since now."""
    before = dict(t_hnsw.mirror_uploads)
    return lambda: {k: t_hnsw.mirror_uploads[k] - before[k] for k in before}


class _CpuMirror(t_hnsw.CodeMirror):
    def __init__(self, dim):
        super().__init__(dim, "cpu")


@pytest.mark.parametrize("dim", [1, 17, DIM])
def test_code_mirror_rows_grow_gather_and_load(dim):
    """The helper alone on the CPU: rows written at their offsets, growth
    that keeps them, a gather in a given order and a whole-index load;
    the upload counts grow by the code bytes of the rows written and
    loaded, and by nothing else."""
    rng = np.random.default_rng(dim)
    codes = rng.integers(0, 256, (21, dim), dtype=np.uint8)
    scales = rng.uniform(0.0, 1e-2, 21)
    scales[4] = 0.0
    zps = rng.integers(-128, 256, 21).astype(np.int32)
    mids = rng.normal(0.0, 1.0, 21)
    uploaded = _uploads_counter()
    m = t_hnsw.CodeMirror(dim, "cpu")
    m.grow(8, 0)
    m.write(0, codes[0], scales[0], zps[0], mids[0])           # one row (insert)
    m.write(1, codes[1:6], scales[1:6], zps[1:6], mids[1:6])   # a batch
    m.grow(32, 6)                                              # past the capacity
    m.write(6, codes[6:21], scales[6:21], zps[6:21], mids[6:21])
    want = (codes, scales, zps.astype(np.float64), mids)
    for got, w in zip(m.view(21), want):
        assert torch.equal(got, torch.from_numpy(w))
    assert uploaded() == {"rows": 21 * dim, "index": 0}
    keep = np.array([0, 3, 4, 9, 20, 11])
    m.gather(keep)
    for got, w in zip(m.view(len(keep)), want):
        assert torch.equal(got, torch.from_numpy(w[keep]))
    assert m.codes.shape == (len(keep), dim)
    assert uploaded() == {"rows": 21 * dim, "index": 0}  # a gather moves no host bytes
    fresh = t_hnsw.CodeMirror(dim, "cpu")
    fresh.grow(32, 0)
    fresh.load(codes, scales, zps, mids)
    for got, w in zip(fresh.view(21), want):
        assert torch.equal(got, torch.from_numpy(w))
    assert uploaded() == {"rows": 21 * dim, "index": 21 * dim}


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_index_mirror_follows_its_host_arrays(card_on_cpu, seed):
    """A CUDA index (mirror on the CPU) through insert, insert_batch past
    its capacity, tombstones + compact, to_bytes / from_bytes and clone:
    after each step the mirror equals the host arrays, each entering row
    was uploaded once, and the ids, remaps and bytes are the reference's."""
    uploaded = _uploads_counter()
    ref = r_hnsw.HNSWIndex(DIM, m=8, ef_construction=32, seed=seed)
    idx = t_hnsw.HNSWIndex(DIM, m=8, ef_construction=32, seed=seed, device="cuda")
    assert idx.device.type == "cuda" and idx.mirror is not None
    rows = _data(seed, 40)
    for r in rows[:5]:
        assert idx.insert(r) == ref.insert(r)
        _assert_mirrors(idx)
    assert idx.insert_batch(rows[5:30], max_matrix_elems=256) == ref.insert_batch(
        rows[5:30], max_matrix_elems=256)
    _assert_mirrors(idx)
    assert idx._cap == 32
    assert idx.insert_batch(rows[30:]) == ref.insert_batch(rows[30:])
    _assert_mirrors(idx)
    assert idx._cap == 64
    assert uploaded() == {"rows": 40 * DIM, "index": 0}
    queries = rows[::7] + 0.01
    gv, gd = idx.nearest_live_batch(queries)
    wv, wd = ref.nearest_live_batch(queries)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gd, wd, rtol=2e-3)
    for v in (3, 17, 31):
        idx.mark_deleted(v)
        ref.mark_deleted(v)
    assert idx.compact() == ref.compact()
    _assert_mirrors(idx)
    assert uploaded() == {"rows": 40 * DIM, "index": 0}
    np.testing.assert_array_equal(idx.nearest_live_batch(queries)[0],
                                  ref.nearest_live_batch(queries)[0])
    data = idx.to_bytes()
    assert data == ref.to_bytes()
    for i, make in enumerate((lambda: t_hnsw.HNSWIndex.from_bytes(data, device="cuda"),
                              idx.clone)):
        back = make()
        assert back.device.type == "cuda"
        _assert_mirrors(back)
        assert uploaded() == {"rows": 40 * DIM, "index": (i + 1) * 37 * DIM}
        np.testing.assert_array_equal(back.nearest_live_batch(queries)[0],
                                      ref.nearest_live_batch(queries)[0])


def test_insert_batch_blocks_read_the_mirror_with_the_batch_rows(card_on_cpu):
    """Every distance block of ``insert_batch`` reaches the seam as views
    of the mirror (tensors, no host codes), whose rows equal the host's
    ``_codes[:n]`` at the time of the call, the batch's own rows included;
    the ids match the reference's."""
    ref = r_hnsw.HNSWIndex(DIM, m=8, ef_construction=32, seed=2)
    idx = t_hnsw.HNSWIndex(DIM, m=8, ef_construction=32, seed=2, device="cuda")
    rows = _data(2, 30)
    assert idx.insert_batch(rows[:10]) == ref.insert_batch(rows[:10])
    card_on_cpu.clear()
    assert idx.insert_batch(rows[10:], max_matrix_elems=200) == ref.insert_batch(
        rows[10:], max_matrix_elems=200)
    assert len(card_on_cpu) > 1  # the batch took several chunks
    ends = []
    for b, codes, ptr in card_on_cpu:
        n = codes.shape[0]
        assert ptr == idx.mirror.codes.data_ptr()
        assert torch.equal(codes, torch.from_numpy(idx._codes[:n]))
        ends.append(n)
    # Chunk columns reach the chunk's own end: rows of the batch itself.
    assert ends[-1] == 30 and all(n > 10 for n in ends)
    assert sum(b for b, _, _ in card_on_cpu) == 20
    assert idx.to_bytes() == ref.to_bytes()
