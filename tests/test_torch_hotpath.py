"""Hot-path regression tests: vectorized HNSW vs the frozen seed oracle,
capacity growth, dirty-aware index flushing, and planar bitpack parity.

The reference suite ``tests/test_hotpath.py`` held against the port: every
case, its imports on ``repro_torch`` (the reference's ``core/hnsw_ref.py``
oracle excepted, which needs no port), every engine and index made with
``device="cpu"`` (the port's entry points default to the card)."""

import os
import pickle

import numpy as np
import pytest

from repro_torch.core.bitpack import (
    pack_bits_planar,
    planar_plane_bytes,
    unpack_bits_planar,
)
from repro_torch.core.engine import StorageEngine
from repro_torch.core.hnsw import HNSWIndex, quantized_l2_batch
from repro.core.hnsw_ref import SeedHNSWIndex, quantized_l2_batch_dense

RNG = np.random.default_rng(11)


# --------------------------------------------------------- search parity
@pytest.mark.parametrize("dim,n", [(64, 150), (300, 80)])
def test_insert_search_parity_vs_seed(dim, n):
    """Same fixed-seed workload → identical vertex ids, identical neighbor
    ids, distances within 1e-6 relative of the seed oracle."""
    rng = np.random.default_rng(dim + n)
    new = HNSWIndex(dim, m=8, ef_construction=32, seed=5, device="cpu")
    old = SeedHNSWIndex(dim, m=8, ef_construction=32, seed=5)
    for row in rng.normal(0, 1, (n, dim)):
        assert new.insert(row) == old.insert(row)
    for _ in range(25):
        q = rng.normal(0, 1, dim)
        got = new.search(q, k=5)
        want = old.search(q, k=5)
        assert [v for _, v in got] == [v for _, v in want]
        gd = np.array([d for d, _ in got])
        wd = np.array([d for d, _ in want])
        np.testing.assert_allclose(gd, wd, rtol=1e-6)


def test_batch_distance_matches_dense_oracle():
    rng = np.random.default_rng(3)
    n, d = 200, 513
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    scales = rng.uniform(1e-3, 2e-2, n)
    scales[7] = 0.0  # constant-row path
    zps = rng.integers(0, 256, n).astype(np.int64)
    mids = rng.normal(0, 0.5, n)
    q = rng.normal(0, 1, d)
    want = quantized_l2_batch_dense(q, codes, scales, zps, mids)
    got = quantized_l2_batch(q, codes, scales, zps, mids)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_index_batch_distances_match_oracle():
    rng = np.random.default_rng(4)
    dim = 128
    idx = HNSWIndex(dim, seed=0, device="cpu")
    for row in rng.normal(0, 1, (40, dim)):
        idx.insert(row)
    idx.insert(np.full(dim, 0.75))  # constant vertex: scale == 0 path
    q = rng.normal(0, 1, dim)
    n = len(idx)
    want = quantized_l2_batch_dense(
        q, idx._codes[:n], idx._scales[:n], idx._zps[:n], idx._mids[:n]
    )
    np.testing.assert_allclose(idx.batch_distances(q), want, rtol=1e-6)


def test_near_duplicate_query_ranking_and_abs_error():
    """Near a stored vertex the decomposed distance loses *relative*
    precision (f32 dot) but keeps a small absolute error, so nearest-base
    ranking — all the engine consumes — is preserved."""
    rng = np.random.default_rng(21)
    dim = 2048
    idx = HNSWIndex(dim, seed=0, device="cpu")
    rows = rng.normal(0, 1, (8, dim))
    for r in rows:
        idx.insert(r)
    q = rows[5] + rng.normal(0, 1e-5, dim)
    n = len(idx)
    truth = quantized_l2_batch_dense(
        q, idx._codes[:n], idx._scales[:n], idx._zps[:n], idx._mids[:n]
    )
    got = idx.batch_distances(q)
    assert int(np.argmin(got)) == int(np.argmin(truth)) == 5
    assert abs(got[5] - truth[5]) < 1e-2  # absolute error stays tiny...
    assert sorted(truth)[1] > 100.0       # ...vs a huge ranking margin
    assert idx.search(q, k=1)[0][1] == 5


# ------------------------------------------------------- capacity growth
def test_capacity_doubling_preserves_vertices():
    """Vertex payloads must survive every array reallocation boundary."""
    rng = np.random.default_rng(9)
    dim = 32
    idx = HNSWIndex(dim, m=4, seed=2, device="cpu")
    rows = rng.normal(0, 1, (70, dim))  # crosses 8 → 16 → 32 → 64 → 128
    snapshots = {}
    caps = set()
    for i, row in enumerate(rows):
        vid = idx.insert(row)
        assert vid == i
        snapshots[vid] = idx.dequantize_vertex(vid).copy()
        caps.add(idx._cap)
    assert len(idx) == 70
    assert idx._cap >= 70 and len(caps) > 1, "growth path never exercised"
    for vid, snap in snapshots.items():
        np.testing.assert_array_equal(idx.dequantize_vertex(vid), snap)
    # cached norms stay consistent with the stored codes after growth
    for vid in (0, 7, 8, 63, 69):
        deq = idx.dequantize_vertex(vid)
        assert idx._norms[vid] == pytest.approx(float(deq @ deq), rel=1e-12)


def test_nbytes_counts_all_vertex_arrays():
    idx = HNSWIndex(16, seed=0, device="cpu")
    for row in np.random.default_rng(1).normal(0, 1, (10, 16)):
        idx.insert(row)
    floor = (
        idx._codes.nbytes + idx._scales.nbytes + idx._zps.nbytes
        + idx._mids.nbytes + idx._norms.nbytes
    )
    assert idx.nbytes >= floor  # mids (and norms) included, plus edges


def test_from_bytes_accepts_seed_format():
    """Old pickles (list adjacency, no cached norms) must still load."""
    rng = np.random.default_rng(6)
    dim = 24
    old = SeedHNSWIndex(dim, m=8, ef_construction=32, seed=7)
    for row in rng.normal(0, 1, (30, dim)):
        old.insert(row)
    state = {
        "dim": old.dim,
        "m": old.m,
        "ef_construction": old.ef_construction,
        "codes": old._codes,
        "scales": old._scales,
        "zps": old._zps,
        "mids": old._mids,
        "levels": old._levels,
        "neighbors": old._neighbors,
        "entry": old._entry,
        "max_level": old._max_level,
    }
    idx = HNSWIndex.from_bytes(pickle.dumps(state), device="cpu")
    for _ in range(10):
        q = rng.normal(0, 1, dim)
        got = idx.search(q, k=3)
        want = old.search(q, k=3)
        assert [v for _, v in got] == [v for _, v in want]
        np.testing.assert_allclose(
            [d for d, _ in got], [d for d, _ in want], rtol=1e-6
        )


# ------------------------------------------------------------ dirty flush
def _idx_file(root, dim):
    return os.path.join(root, "index", f"hnsw_{dim}.idx")


def test_save_reserializes_only_mutated_index(tmp_path):
    """Acceptance: a save mutating one dim's index rewrites only that file."""
    rng = np.random.default_rng(2)
    eng = StorageEngine(str(tmp_path), device="cpu")
    t64 = rng.normal(0, 0.02, 64).astype(np.float32)
    t100 = rng.normal(0, 0.02, 100).astype(np.float32)
    eng.save_model("m0", {}, {"a": t64, "b": t100})
    with open(_idx_file(str(tmp_path), 64), "rb") as f:
        blob64 = f.read()
    with open(_idx_file(str(tmp_path), 100), "rb") as f:
        blob100 = f.read()
    # Dissimilar dim-100 tensor → new vertex in the dim-100 index only;
    # dim-64 tensor is a tiny fine-tune → pure delta, index untouched.
    eng.save_model(
        "m1", {},
        {"a": t64 + rng.normal(0, 1e-5, 64).astype(np.float32),
         "b": rng.normal(0, 5.0, 100).astype(np.float32)},
    )
    with open(_idx_file(str(tmp_path), 64), "rb") as f:
        assert f.read() == blob64, "clean index was reserialized"
    with open(_idx_file(str(tmp_path), 100), "rb") as f:
        assert f.read() != blob100, "mutated index was not reserialized"
    # And both models still reconstruct.
    for name in ("m0", "m1"):
        eng.load_model(name).materialize()


def test_unchanged_save_flushes_nothing(tmp_path):
    rng = np.random.default_rng(12)
    eng = StorageEngine(str(tmp_path), device="cpu")
    base = {"w": rng.normal(0, 0.02, 80).astype(np.float32)}
    eng.save_model("base", {}, base)
    flushes_after_first = eng.index_cache.stats()["dirty_flushes"]
    r = eng.save_model(
        "ft", {}, {"w": base["w"] + rng.normal(0, 1e-5, 80).astype(np.float32)}
    )
    assert r.n_new_bases == 0
    assert eng.index_cache.stats()["dirty_flushes"] == flushes_after_first


def test_pinned_index_survives_eviction(tmp_path):
    """A save's in-flight index must not be evicted by concurrent gets."""
    rng = np.random.default_rng(0)
    eng = StorageEngine(str(tmp_path), cache_bytes=1, device="cpu")  # evict on every get
    cache = eng.index_cache
    idx64 = cache.get(64, create=True)
    idx64.insert(rng.normal(0, 1, 64))  # nonzero nbytes → over budget
    cache.mark_dirty(64)
    cache.pin(64)
    try:
        i100 = cache.get(100, create=True)
        i100.insert(rng.normal(0, 1, 100))
        cache.mark_dirty(100)
        cache.get(200, create=True)  # evicts 100, never pinned 64
        assert 100 not in cache._live
        assert cache.get(64) is idx64, "pinned index was evicted"
    finally:
        cache.unpin(64)
    cache.get(300, create=True)
    assert 64 not in cache._live, "unpinned index should evict again"
    # the evicted dirty index was persisted, not dropped
    assert cache.get(64) is not None and len(cache.get(64)) == 1


def test_cache_stats_and_create_counts_as_miss(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    cache = eng.index_cache
    assert cache.get(123) is None  # absent, no create: not a hit or miss
    cache.get(123, create=True)
    assert cache.stats()["misses"] == 1
    cache.get(123)
    s = cache.stats()
    assert s["hits"] == 1 and s["misses"] == 1
    assert set(s) >= {"hits", "misses", "evictions", "dirty_flushes"}


def test_save_preserves_record_order_across_dim_grouping(tmp_path):
    """Dim-grouped index work must not reorder page records (paper §4.1)."""
    rng = np.random.default_rng(8)
    eng = StorageEngine(str(tmp_path), device="cpu")
    tensors = {
        "l0/w": rng.normal(0, 0.02, (8, 8)).astype(np.float32),
        "l0/b": rng.normal(0, 0.02, (8,)).astype(np.float32),
        "l1/w": rng.normal(0, 0.02, (8, 8)).astype(np.float32),
        "l1/b": rng.normal(0, 0.02, (8,)).astype(np.float32),
    }
    eng.save_model("m", {}, tensors)
    lm = eng.load_model("m")
    assert lm.tensor_names() == list(tensors)
    out = lm.materialize()
    for k, v in tensors.items():
        assert np.abs(out[k] - v).max() <= 2.0 ** -24 * 1.001 + 1e-9


def test_loader_decodes_payload_lazily(tmp_path):
    rng = np.random.default_rng(13)
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {}, {"w": rng.normal(0, 0.02, 64).astype(np.float32)})
    lm = eng.load_model("m")
    assert lm._records["w"].qdelta is None, "decode should be deferred"
    assert lm.record("w").qdelta is not None
    np.testing.assert_allclose(
        lm.tensor("w"),
        eng.load_model("m").materialize()["w"],
    )


# --------------------------------------------------------- planar bitpack
def _pack_planar_loop(values, nbit):
    """The seed per-plane Python loop, kept inline as the reference."""
    v = np.ascontiguousarray(values.ravel(), dtype=np.uint64)
    out = bytearray()
    for k in range(nbit - 1, -1, -1):
        out += np.packbits(((v >> np.uint64(k)) & 1).astype(np.uint8)).tobytes()
    return bytes(out)


def _unpack_planar_loop(data, nbit, count, b=None):
    b = nbit if b is None else min(b, nbit)
    plane = planar_plane_bytes(count)
    buf = np.frombuffer(data, dtype=np.uint8)
    acc = np.zeros(count, dtype=np.int64)
    for k in range(b):
        bits = np.unpackbits(buf[k * plane:(k + 1) * plane], count=count)
        acc = (acc << 1) | bits.astype(np.int64)
    return acc


@pytest.mark.parametrize("nbit", [1, 7, 8, 17, 32])
@pytest.mark.parametrize("count", [1, 5, 8, 257])
def test_planar_pack_matches_loop_reference(nbit, count):
    rng = np.random.default_rng(nbit * 100 + count)
    v = rng.integers(0, 1 << nbit, count, dtype=np.uint64)
    packed = pack_bits_planar(v, nbit)
    assert packed == _pack_planar_loop(v, nbit), "on-disk layout changed"
    assert len(packed) == nbit * planar_plane_bytes(count)
    got = unpack_bits_planar(packed, nbit, count)
    np.testing.assert_array_equal(got, v.astype(np.int64))
    # Partial (MSB-prefix) reads agree with the loop reference too.
    for b in (1, nbit // 2, nbit):
        if b == 0:
            continue
        np.testing.assert_array_equal(
            unpack_bits_planar(packed, nbit, count, b=b),
            _unpack_planar_loop(packed, nbit, count, b=b),
        )
        np.testing.assert_array_equal(
            unpack_bits_planar(packed, nbit, count, b=b),
            v.astype(np.int64) >> (nbit - b),
        )
    # b=0 degrades to zeros (seed behavior), not an IndexError
    np.testing.assert_array_equal(
        unpack_bits_planar(packed, nbit, count, b=0),
        np.zeros(count, dtype=np.int64),
    )
