"""Batched ingestion tests: `insert_batch` vs sequential
`insert` graph-quality parity, batched-distance parity vs the frozen seed
oracle, the kernel dispatch seam, the per-group quantization hoist, and
`save_models` crash injection (all-or-nothing across the batch).

The reference suite ``tests/test_batch_ingest.py`` held against the port: every
case, its imports on ``repro_torch`` (the reference's ``core/hnsw_ref.py``
oracle excepted, which needs no port), every engine and index made with
``device="cpu"`` (the port's entry points default to the card)."""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import StorageEngine
from repro_torch.core import catalog as catmod
from repro_torch.core import hnsw as hnswmod
from repro_torch.core.catalog import InjectedCrash
from repro_torch.core.hnsw import HNSWIndex
from repro.core.hnsw_ref import quantized_l2_batch_dense
from repro_torch.core.loader import materialize_many
from repro_torch.core.quantize import (
    dequantize_linear_batch,
    quantize_linear,
    quantize_linear_batch,
)

RNG = np.random.default_rng(33)
TOL = 2.0 ** -24 * 1.001 + 1e-9  # default tolerance + fp slack


@pytest.fixture(autouse=True)
def _clear_failpoints():
    catmod.FAILPOINTS.clear()
    yield
    catmod.FAILPOINTS.clear()


# ------------------------------------------------- quantization hoist parity
def test_quantize_linear_batch_exact_parity():
    """The per-group hoisted sweep must be bit-exact with the per-tensor
    path — codes, scales, zero-points and mids all equal."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, rng.uniform(1e-3, 5.0), (24, 133))
    x[5] = 0.25          # constant row
    x[9] = -1e-12        # tiny constant row
    x[11] *= 1e6         # huge range
    codes, scales, zps, mids = quantize_linear_batch(x)
    for i in range(x.shape[0]):
        qi, meta = quantize_linear(x[i])
        assert np.array_equal(codes[i], qi), f"row {i} codes diverge"
        assert scales[i] == meta.scale
        assert zps[i] == meta.zero_point
        assert mids[i] == meta.mid
    # and the batched dequantizer inverts per-row like the scalar one
    deq = dequantize_linear_batch(codes, scales, zps, mids)
    assert deq.shape == x.shape


try:
    from hypothesis import given, strategies as st  # noqa: E402
except ImportError:
    given = None

if given is not None:
    @given(
        scale=st.floats(1e-6, 1e4),
        loc=st.floats(-10.0, 10.0),
        seed=st.integers(0, 2**31 - 1),
    )
    def test_quantize_linear_batch_parity_property(scale, loc, seed):
        """Property form of the hoist parity (examples scale with the
        hypothesis profile — the CI profile runs many more)."""
        rng = np.random.default_rng(seed)
        x = rng.normal(loc, scale, (4, 65))
        codes, scales, zps, mids = quantize_linear_batch(x)
        for i in range(4):
            qi, meta = quantize_linear(x[i])
            assert np.array_equal(codes[i], qi)
            assert (scales[i], zps[i], mids[i]) == (
                meta.scale, meta.zero_point, meta.mid
            )


# ------------------------------------------------------ batched distances
def test_multi_query_batch_distances_match_dense_oracle():
    rng = np.random.default_rng(2)
    dim = 96
    idx = HNSWIndex(dim, seed=0, device="cpu")
    for row in rng.normal(0, 1, (50, dim)):
        idx.insert(row)
    idx.insert(np.full(dim, 0.5))  # constant vertex: scale == 0 path
    n = len(idx)
    queries = rng.normal(0, 1, (9, dim))
    got = idx.batch_distances(queries)
    assert got.shape == (9, n)
    for b in range(9):
        want = quantized_l2_batch_dense(
            queries[b], idx._codes[:n], idx._scales[:n], idx._zps[:n],
            idx._mids[:n],
        )
        np.testing.assert_allclose(got[b], want, rtol=1e-6)
    # 1-D query keeps the legacy (N,) contract
    one = idx.batch_distances(queries[0])
    assert one.shape == (n,)
    # (1-row gemv and B-row gemm take different BLAS paths; both sit well
    # inside the documented 1e-6 decomposed-form budget)
    np.testing.assert_allclose(one, got[0], rtol=1e-6)


def test_kernel_dispatch_seam_is_consulted(monkeypatch):
    """The port's seam has no size gate (``kernels/ops.py``): a CPU index
    never offers a block to the kernel hook, whatever the reference's
    floor says, and computes the decomposed form; an index on the card
    offers every block, on its device mirror's rows, and the hook's
    answer wins (clamped float64). The card is stood in for on the CPU as
    ``tests/test_torch_mirror.py`` does."""
    rng = np.random.default_rng(3)
    dim = 64
    rows = rng.normal(0, 1, (40, dim))
    idx = HNSWIndex(dim, seed=0, device="cpu")
    for row in rows:
        idx.insert(row)
    q = rng.normal(0, 1, (3, dim))
    baseline = idx.batch_distances(q)

    calls = []
    answer = [7.0]

    def spy(queries, codes, scales, zps, mids, device):
        calls.append((tuple(codes.shape), device.type))
        return np.full((queries.shape[0], codes.shape[0]), answer[0])

    monkeypatch.setattr(hnswmod, "_offload_distances", spy)
    # A CPU index: the seam is never consulted, with or without a floor.
    np.testing.assert_array_equal(idx.batch_distances(q), baseline)
    monkeypatch.setattr(hnswmod.ops, "KERNEL_DISPATCH_MIN_ELEMS", 1)
    np.testing.assert_array_equal(idx.batch_distances(q), baseline)
    assert calls == []

    # An index on the card: consulted once per block, whatever its size,
    # and the hook's answer wins, clamped at 0.
    mirror = hnswmod.CodeMirror
    monkeypatch.setattr(hnswmod.ops, "resolve_device", torch.device)
    monkeypatch.setattr(hnswmod, "CodeMirror", lambda d, device: mirror(d, "cpu"))
    card = HNSWIndex(dim, seed=0, device="cuda")
    for row in rows:
        card.insert(row)
    calls.clear()
    assert (card.batch_distances(q) == 7.0).all()
    assert calls == [((40, dim), "cuda")]
    answer[0] = -7.0
    assert (card.batch_distances(q[:1]) == 0.0).all()
    assert calls[1:] == [((40, dim), "cuda")]


def test_kernel_path_parity_vs_seed_oracle():
    """ops.quantized_l2_auto(force='kernel') — the TPU route, executed in
    interpret mode here — must match the frozen seed oracle."""
    pytest.importorskip("jax")
    from repro_torch.kernels import ops

    rng = np.random.default_rng(4)
    n, d = 64, 256
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    scales = rng.uniform(1e-3, 2e-2, n)
    scales[3] = 0.0
    zps = rng.integers(0, 256, n).astype(np.int64)
    mids = rng.normal(0, 0.5, n)
    queries = rng.normal(0, 1, (2, d))

    assert ops.quantized_l2_auto(queries, codes, scales, zps, mids) is None
    assert (
        ops.quantized_l2_auto(
            queries, codes, scales, zps, mids, force="numpy"
        )
        is None
    )
    got = ops.quantized_l2_auto(queries, codes, scales, zps, mids,
                                force="kernel")
    assert got.shape == (2, n)
    for b in range(2):
        want = quantized_l2_batch_dense(queries[b], codes, scales, zps, mids)
        np.testing.assert_allclose(
            got[b], want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max())
        )


# --------------------------------------------------------- insert_batch
def _brute_topk(idx, q, k):
    return set(np.argsort(idx.batch_distances(q))[:k].tolist())


def _recall(idx, queries, k=5, ef=64):
    hits = 0
    for q in queries:
        got = {v for _, v in idx.search(q, k=k, ef=ef)}
        hits += len(got & _brute_topk(idx, q, k))
    return hits / (k * len(queries))


def test_insert_batch_recall_parity():
    """Batched construction must match sequential construction's recall@k
    on a fixed query set within tolerance, with exact distance parity vs
    the seed oracle (the acceptance bar)."""
    rng = np.random.default_rng(5)
    dim, n = 128, 300
    data = rng.normal(0, 1, (n, dim))
    seq = HNSWIndex(dim, m=8, ef_construction=32, seed=7, device="cpu")
    for row in data:
        seq.insert(row)
    bat = HNSWIndex(dim, m=8, ef_construction=32, seed=7, device="cpu")
    vids = bat.insert_batch(data)
    assert vids == list(range(n)) and len(bat) == n
    # identical quantized payloads (same codes → same stored bases)
    assert np.array_equal(bat._codes[:n], seq._codes[:n])
    np.testing.assert_array_equal(bat._scales[:n], seq._scales[:n])
    # distances from the batch-built index match the dense seed oracle
    for q in rng.normal(0, 1, (5, dim)):
        want = quantized_l2_batch_dense(
            q, bat._codes[:n], bat._scales[:n], bat._zps[:n], bat._mids[:n]
        )
        np.testing.assert_allclose(bat.batch_distances(q), want, rtol=1e-6)
    queries = rng.normal(0, 1, (40, dim))
    r_seq = _recall(seq, queries)
    r_bat = _recall(bat, queries)
    assert r_bat >= r_seq - 0.05, (r_bat, r_seq)


def test_insert_batch_incremental_and_chunked():
    """Batches onto a non-empty index, tiny-chunk matrices, empty batch."""
    rng = np.random.default_rng(6)
    dim = 48
    data = rng.normal(0, 1, (90, dim))
    idx = HNSWIndex(dim, m=8, ef_construction=32, seed=1, device="cpu")
    assert idx.insert_batch(np.empty((0, dim))) == []
    assert idx.insert_batch([]) == []
    idx.insert_batch(data[:30])
    # force many matrix chunks (cols grow mid-batch)
    idx.insert_batch(data[30:], max_matrix_elems=64)
    assert len(idx) == 90
    assert _recall(idx, rng.normal(0, 1, (20, dim))) > 0.8
    # serialization survives batched construction
    again = HNSWIndex.from_bytes(idx.to_bytes(), device="cpu")
    q = rng.normal(0, 1, dim)
    assert [v for _, v in again.search(q, k=3)] == [
        v for _, v in idx.search(q, k=3)
    ]


def test_insert_batch_levels_match_sequential_rng():
    """Level draws consume the RNG in per-item order: same seed → same
    level assignment as sequential inserts."""
    rng = np.random.default_rng(7)
    dim = 16
    data = rng.normal(0, 1, (60, dim))
    seq = HNSWIndex(dim, seed=3, device="cpu")
    for row in data:
        seq.insert(row)
    bat = HNSWIndex(dim, seed=3, device="cpu")
    bat.insert_batch(data)
    assert bat._levels == seq._levels


def test_nearest_live_batch_masks_tombstones():
    rng = np.random.default_rng(8)
    dim = 32
    idx = HNSWIndex(dim, seed=0, device="cpu")
    data = rng.normal(0, 1, (20, dim))
    idx.insert_batch(data)
    vids, dists = idx.nearest_live_batch(data[:4] + 1e-9)
    assert vids.tolist() == [0, 1, 2, 3]
    assert (dists < 1.0).all()
    idx.mark_deleted(2)
    vids2, _ = idx.nearest_live_batch(data[2:3])
    assert vids2[0] != 2
    for v in range(20):
        idx.mark_deleted(v)
    vids3, dists3 = idx.nearest_live_batch(data[:2])
    assert vids3.tolist() == [-1, -1] and np.isinf(dists3).all()


def test_insert_batch_matches_insert_on_engine_roundtrip(tmp_path):
    """A model saved through the batched engine path reconstructs within
    the paper's tolerance bound, in input order."""
    rng = np.random.default_rng(9)
    eng = StorageEngine(str(tmp_path), device="cpu")
    tensors = {
        f"l{i}/{p}": rng.normal(0, 0.02, (12, 12) if p == "w" else (12,))
        .astype(np.float32)
        for i in range(3)
        for p in ("w", "b")
    }
    eng.save_model("m", {}, tensors)
    lm = eng.load_model("m")
    assert lm.tensor_names() == list(tensors)
    out = lm.materialize()
    for k, v in tensors.items():
        assert np.abs(out[k] - v).max() <= TOL


def test_probe_falls_back_to_graph_descent_on_grown_index(tmp_path, monkeypatch):
    """Thin groups against a grown index must use the HNSW descent, not a
    full brute-force scan — and still dedup/load correctly."""
    import repro_torch.core.engine as engmod
    monkeypatch.setattr(engmod, "BRUTE_PROBE_MAX_INDEX", 4)
    monkeypatch.setattr(engmod, "BRUTE_PROBE_GROUP_FACTOR", 1)
    rng = np.random.default_rng(20)
    eng = StorageEngine(str(tmp_path), device="cpu")
    base = {"w": rng.normal(0, 5.0, 64).astype(np.float32)}
    for i in range(6):  # grow the dim-64 index past the (patched) cutoff
        eng.save_model(f"b{i}", {}, {"w": rng.normal(0, 5.0, 64)
                                     .astype(np.float32)})
    eng.save_model("base", {}, base)
    ft = {"w": (base["w"] + rng.normal(0, 1e-5, 64)).astype(np.float32)}
    r = eng.save_model("ft", {}, ft)  # descent path: must still find base
    assert r.n_new_bases == 0
    out = eng.load_model("ft").materialize()
    assert np.abs(out["w"] - ft["w"]).max() <= TOL


def test_intra_save_dedup_matches_sequential_semantics(tmp_path):
    """Two mutually-similar tensors that are dissimilar from every resident
    base must produce ONE new vertex (the second becomes a delta), as the
    sequential per-tensor path did."""
    rng = np.random.default_rng(10)
    eng = StorageEngine(str(tmp_path), device="cpu")
    t1 = rng.normal(0, 5.0, 200).astype(np.float32)
    t2 = (t1 + rng.normal(0, 1e-5, 200)).astype(np.float32)
    t3 = rng.normal(0, 5.0, 200).astype(np.float32)  # dissimilar from both
    r = eng.save_model("m", {}, {"a": t1, "b": t2, "c": t3})
    assert r.n_new_bases == 2 and r.n_deltas == 1
    out = eng.load_model("m").materialize()
    for k, v in {"a": t1, "b": t2, "c": t3}.items():
        assert np.abs(out[k] - v).max() <= TOL


# ----------------------------------------------------------- save_models
def _family(rng, n_models, dim=64):
    base = {"w0": rng.normal(0, 0.02, dim).astype(np.float32),
            "w1": rng.normal(0, 0.02, dim // 2).astype(np.float32)}
    out = [("base", {"kind": "base"}, base)]
    for i in range(n_models - 1):
        out.append((
            f"ft{i}", {},
            {k: v + rng.normal(0, 1e-5, v.shape).astype(np.float32)
             for k, v in base.items()},
        ))
    return out


def test_save_models_one_transaction_shared_bases(tmp_path):
    rng = np.random.default_rng(11)
    eng = StorageEngine(str(tmp_path), device="cpu")
    specs = _family(rng, 4)
    reports = eng.save_models(specs)
    assert [r.name for r in reports] == [s[0] for s in specs]
    # fine-tunes dedup against the bases the batch itself created
    assert reports[0].n_new_bases == 2
    assert all(r.n_new_bases == 0 for r in reports[1:])
    assert len({r.model_id for r in reports}) == 4
    for name, _a, tensors in specs:
        out = eng.load_model(name).materialize()
        for k, v in tensors.items():
            assert np.abs(out[k] - v).max() <= TOL
    # reopen: committed, journal clean
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    assert sorted(eng2.list_models()) == sorted(s[0] for s in specs)
    assert eng2.catalog.pending() == []


def test_save_models_journals_single_intent(tmp_path):
    """The whole batch rides one journal intent (one fsync'd begin)."""
    rng = np.random.default_rng(12)
    eng = StorageEngine(str(tmp_path), device="cpu")
    catmod.FAILPOINTS.add("save_batch.after_intent")
    with pytest.raises(InjectedCrash):
        eng.save_models(_family(rng, 3))
    with open(os.path.join(str(tmp_path), "journal.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert len(recs) == 1
    assert recs[0]["op"] == "save_batch"
    assert len(recs[0]["models"]) == 3


def test_save_models_rejects_duplicate_names(tmp_path):
    rng = np.random.default_rng(13)
    eng = StorageEngine(str(tmp_path), device="cpu")
    t = {"w": rng.normal(0, 1, 16).astype(np.float32)}
    with pytest.raises(ValueError):
        eng.save_models([("m", {}, t), ("m", {}, t)])
    assert eng.save_models([]) == []


def _assert_consistent(eng):
    """No orphan pages, no dangling refs, every model materializes."""
    pages_dir = os.path.join(eng.root, "pages")
    on_disk = set(os.listdir(pages_dir))
    referenced = {eng.catalog.get(n).page for n in eng.list_models()}
    assert on_disk == referenced, f"orphan pages: {on_disk - referenced}"
    derived = Counter()
    for name in eng.list_models():
        derived.update(eng._page_refs(eng.catalog.get(name).page))
    table = {
        tuple(map(int, k.split(":"))): v
        for k, v in eng.catalog.state.vertex_refs.items()
    }
    assert table == dict(derived)
    for name in eng.list_models():
        eng.load_model(name).materialize()


@pytest.mark.parametrize("point", [
    "save_batch.after_intent",
    "save_batch.after_index_flush",
    "save_batch.after_page_write",
    "save_batch.after_snapshot",
])
def test_save_models_crash_is_all_or_nothing(tmp_path, point):
    """A crash at any protocol step replays to every model committed or
    none of them — never a partial batch."""
    rng = np.random.default_rng(14)
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("pre", {}, {"w": rng.normal(0, 5.0, 48).astype(np.float32)})
    specs = _family(rng, 3, dim=48)
    catmod.FAILPOINTS.add(point)
    with pytest.raises(InjectedCrash):
        eng.save_models(specs)
    catmod.FAILPOINTS.clear()
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    names = set(eng2.list_models())
    batch = {s[0] for s in specs}
    assert "pre" in names
    committed = names & batch
    assert committed in (set(), batch), f"partial batch survived: {committed}"
    if point == "save_batch.after_snapshot":
        assert committed == batch  # snapshot switched → rolled forward
    _assert_consistent(eng2)


@pytest.mark.parametrize("point", [
    "save_batch.after_intent",
    "save_batch.after_snapshot",
])
def test_save_models_replace_crash_all_or_nothing(tmp_path, point):
    """Replaces inside a batch roll with the batch: old versions survive a
    pre-commit crash and are fully dropped after a post-commit crash."""
    rng = np.random.default_rng(15)
    eng = StorageEngine(str(tmp_path), device="cpu")
    v1 = {"w": rng.normal(0, 5.0, 40).astype(np.float32)}
    eng.save_model("m0", {}, v1)
    snap_v1 = eng.load_model("m0").materialize()
    v2 = {"w": rng.normal(0, 5.0, 40).astype(np.float32)}
    fresh = {"w": rng.normal(0, 5.0, 40).astype(np.float32)}
    catmod.FAILPOINTS.add(point)
    with pytest.raises(InjectedCrash):
        eng.save_models([("m0", {}, v2), ("m1", {}, fresh)])
    catmod.FAILPOINTS.clear()
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    _assert_consistent(eng2)
    out = eng2.load_model("m0").materialize()
    if point == "save_batch.after_intent":
        assert "m1" not in eng2.list_models()
        assert np.array_equal(out["w"], snap_v1["w"])  # old version intact
    else:
        assert "m1" in eng2.list_models()
        assert np.abs(out["w"] - v2["w"]).max() <= TOL  # new version live


# ------------------------------------------------------- multi-save loading
def test_load_models_materialize_many_shared_dequant(tmp_path, monkeypatch):
    rng = np.random.default_rng(16)
    eng = StorageEngine(str(tmp_path), device="cpu")
    specs = _family(rng, 3, dim=80)
    eng.save_models(specs)
    want = {n: eng.load_model(n).materialize() for n, _a, _t in specs}

    import repro_torch.core.loader as loader_mod
    calls = Counter()
    real = loader_mod.dequantize_linear

    def counting(codes, meta):
        calls["n"] += 1
        return real(codes, meta)

    monkeypatch.setattr(loader_mod, "dequantize_linear", counting)
    handles = eng.load_models([n for n, _a, _t in specs])
    outs = materialize_many(handles)
    # 2 distinct bases shared by 3 handles → dequantized once each, not 6×
    assert calls["n"] == 2
    for (name, _a, _t), out in zip(specs, outs):
        for k in want[name]:
            assert np.array_equal(out[k], want[name][k])
