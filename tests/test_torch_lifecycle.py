"""Model lifecycle tests: transactional catalog, delete/replace, vertex GC,
HNSW compaction, and crash recovery (journal replay at every failpoint).

The parity bar everywhere: surviving models must ``materialize()``
**bit-identically** before vs. after any lifecycle operation, and a crash
between any two protocol steps must replay to a consistent catalog — no
orphan pages, no dangling ``vertex_refs``.

The reference suite ``tests/test_lifecycle.py`` held against the port: every
case, its imports on ``repro_torch`` (the reference's ``core/hnsw_ref.py``
oracle excepted, which needs no port), every engine and index made with
``device="cpu"`` (the port's entry points default to the card).
"""

import os
from collections import Counter

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core import catalog as catmod
from repro_torch.core.catalog import STATUS_COMMITTED, InjectedCrash, ModelEntry
from repro_torch.core.hnsw import HNSWIndex
from repro.core.hnsw_ref import quantized_l2_batch_dense
from repro_torch.core.pages import read_page_header, read_record, remap_page_vertices

RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _clear_failpoints():
    catmod.FAILPOINTS.clear()
    yield
    catmod.FAILPOINTS.clear()


def _tensors(scale=0.02, d=48, seed_shift=0.0):
    return {
        "layer0/w": (RNG.normal(0, scale, (d, d)) + seed_shift).astype(np.float32),
        "layer0/b": (RNG.normal(0, scale, (d,)) + seed_shift).astype(np.float32),
    }


def _distinct(d=48):
    """Tensors far from everything else — guaranteed new base vertices."""
    return {
        "layer0/w": RNG.normal(0, 5.0, (d, d)).astype(np.float32),
        "layer0/b": RNG.normal(0, 5.0, (d,)).astype(np.float32),
    }


def assert_consistent(eng: StorageEngine) -> None:
    """The catalog invariants recovery must restore after any crash."""
    # 1) No orphan pages: files on disk == pages of committed models.
    pages_dir = os.path.join(eng.root, "pages")
    on_disk = set(os.listdir(pages_dir))
    referenced = {eng.catalog.get(n).page for n in eng.list_models()}
    assert on_disk == referenced, f"orphan pages: {on_disk - referenced}"
    # 2) No dangling vertex_refs: the table equals the page-derived counts.
    derived: Counter = Counter()
    for name in eng.list_models():
        derived.update(eng._page_refs(eng.catalog.get(name).page))
    table = {
        tuple(map(int, k.split(":"))): v
        for k, v in eng.catalog.state.vertex_refs.items()
    }
    assert table == dict(derived)
    # 3) Every referenced vertex exists and is live in its index.
    for dim, vid in table:
        idx = eng.index_cache.get(dim)
        assert idx is not None and 0 <= vid < len(idx)
        assert not idx.is_deleted(vid)
    # 4) Every committed model fully materializes.
    for name in eng.list_models():
        eng.load_model(name).materialize()


# --------------------------------------------------------------- delete/replace
def test_delete_model_basics(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("keep", {}, _tensors())
    eng.save_model("gone", {}, _distinct())
    keep = eng.load_model("keep").materialize()
    before = eng.storage_bytes()

    eng.delete_model("gone")
    assert eng.list_models() == ["keep"]
    assert eng.storage_bytes()["pages"] < before["pages"]
    out = eng.load_model("keep").materialize()
    assert all(np.array_equal(out[k], keep[k]) for k in keep)
    assert_consistent(eng)
    with pytest.raises(KeyError):
        eng.delete_model("gone")
    with pytest.raises(KeyError):
        eng.load_model("gone")


def test_delete_shared_base_keeps_vertex_live(tmp_path):
    """Deleting a fine-tune must not tombstone bases other models share."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    base = _tensors()
    eng.save_model("base", {}, base)
    ft = {k: v + RNG.normal(0, 3e-4, v.shape).astype(np.float32)
          for k, v in base.items()}
    r = eng.save_model("ft", {}, ft)
    assert r.n_new_bases == 0  # shares the base's vertices
    eng.delete_model("ft")
    rep = eng.vacuum()
    assert rep["vertices_dropped"] == 0  # still referenced by "base"
    assert_consistent(eng)


def test_replace_model(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {"v": 1}, _tensors())
    old_entry = eng.model_info("m")
    new = _distinct()
    eng.replace_model("m", {"v": 2}, new)
    entry = eng.model_info("m")
    assert entry.model_id != old_entry.model_id
    assert entry.architecture == {"v": 2}
    assert entry.status == STATUS_COMMITTED
    assert not os.path.exists(eng._page_file(old_entry.page))
    out = eng.load_model("m").materialize()
    assert all(np.abs(out[k] - new[k]).max() < 1e-5 for k in new)
    assert_consistent(eng)
    with pytest.raises(KeyError):
        eng.replace_model("nonexistent", {}, new)


def test_save_over_existing_name_is_replace(tmp_path):
    """Re-saving a name must not leak the old page or its vertex refs."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {}, _distinct())
    eng.save_model("m", {}, _distinct())
    assert eng.list_models() == ["m"]
    assert len(os.listdir(os.path.join(str(tmp_path), "pages"))) == 1
    assert_consistent(eng)


# --------------------------------------------------------------------- vacuum
def test_vacuum_reclaims_pages_and_index_bit_identical(tmp_path):
    """The acceptance bar: delete exclusive-base models, vacuum, and the
    total (pages AND index) shrinks while survivors are bit-identical."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("keep0", {}, _tensors())
    for i in range(3):
        eng.save_model(f"drop{i}", {}, _distinct())
    eng.save_model("keep1", {}, _distinct())
    before = eng.storage_bytes()
    survivors = {n: eng.load_model(n).materialize() for n in ("keep0", "keep1")}

    for i in range(3):
        eng.delete_model(f"drop{i}")
    mid = eng.storage_bytes()
    assert mid["pages"] < before["pages"]

    rep = eng.vacuum(min_dead_fraction=0.0)
    assert rep["vertices_dropped"] > 0
    after = eng.storage_bytes()
    assert after["index"] < mid["index"]
    assert after["total"] < before["total"]

    for name, snap in survivors.items():
        out = eng.load_model(name).materialize()
        for k in snap:
            assert np.array_equal(out[k], snap[k]), (name, k)
    assert_consistent(eng)

    # And across a restart (recovery is a no-op on a clean store).
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    for name, snap in survivors.items():
        out = eng2.load_model(name).materialize()
        assert all(np.array_equal(out[k], snap[k]) for k in snap)


def test_vacuum_rewrites_pages_when_ids_shift(tmp_path):
    """Deleting the oldest model shifts survivor vertex ids down, so the
    survivor's page must be rewritten with the remap — and stay identical
    at the tensor level."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("old", {}, {"w": RNG.normal(0, 5.0, (64,)).astype(np.float32)})
    eng.save_model("young", {}, {"w": RNG.normal(0, 5.0, (64,)).astype(np.float32)})
    snap = eng.load_model("young").materialize()
    eng.delete_model("old")
    rep = eng.vacuum()
    assert rep["pages_rewritten"] == 1
    out = eng.load_model("young").materialize()
    assert all(np.array_equal(out[k], snap[k]) for k in snap)
    # The rewritten page's records now reference the compacted ids.
    page, _ = eng.open_page("young")
    for i in range(page.n_records):
        rec = read_record(page, i, with_payload=False)
        idx = eng.index_cache.get(rec.dim_key)
        assert 0 <= rec.vertex_id < len(idx)
    assert_consistent(eng)


def test_vacuum_threshold_skips_mostly_live_index(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    for i in range(4):
        eng.save_model(f"m{i}", {}, _distinct())
    eng.delete_model("m0")  # 1 of 4 bases dead per dim
    rep = eng.vacuum(min_dead_fraction=0.5)
    assert rep["vertices_dropped"] == 0  # 25% dead < 50% threshold
    rep = eng.vacuum(min_dead_fraction=0.2)
    assert rep["vertices_dropped"] > 0
    assert_consistent(eng)


def test_vacuum_all_models_deleted_empties_index(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    for i in range(2):
        eng.save_model(f"m{i}", {}, _distinct())
    for i in range(2):
        eng.delete_model(f"m{i}")
    eng.vacuum()
    s = eng.storage_bytes()
    assert s["pages"] == 0
    for dim in eng.index_cache.dims():
        assert len(eng.index_cache.get(dim)) == 0
    # An empty store still accepts new saves.
    eng.save_model("fresh", {}, _tensors())
    assert_consistent(eng)


# ----------------------------------------------------------- HNSW tombstones
def test_tombstoned_vertex_excluded_but_waypoint():
    dim = 32
    idx = HNSWIndex(dim, m=8, ef_construction=32, seed=0, device="cpu")
    pts = RNG.normal(0, 1, (30, dim))
    for p in pts:
        idx.insert(p)
    victim = 7
    hit = idx.search(pts[victim], k=1)
    assert hit[0][1] == victim
    idx.mark_deleted(victim)
    hit = idx.search(pts[victim], k=1)
    assert hit and hit[0][1] != victim  # excluded, but results still flow
    # Un-deleted queries are unaffected.
    assert idx.search(pts[3], k=1)[0][1] == 3
    # exclude_deleted=False still sees the tombstone (raw graph search).
    assert idx.search(pts[victim], k=1, exclude_deleted=False)[0][1] == victim


def test_all_deleted_search_returns_empty():
    idx = HNSWIndex(16, m=4, seed=0, device="cpu")
    for _ in range(5):
        idx.insert(RNG.normal(0, 1, 16))
    for v in range(5):
        idx.mark_deleted(v)
    assert idx.search(RNG.normal(0, 1, 16), k=3) == []
    assert idx.dead_count == 5 and idx.live_count == 0


def test_compact_parity_vs_dense_oracle():
    """After delete + compact, k=1 search must agree with the frozen dense
    oracle (`hnsw_ref.quantized_l2_batch_dense`) over the survivors, and
    surviving vertex payloads must dequantize bit-identically."""
    dim = 48
    idx = HNSWIndex(dim, m=8, ef_construction=48, seed=3, device="cpu")
    centers = RNG.normal(0, 1, (24, dim)) * 4.0  # well-separated
    for c in centers:
        idx.insert(c)
    doomed = set(range(0, 24, 3))
    before = {v: idx.dequantize_vertex(v) for v in range(24) if v not in doomed}
    for v in doomed:
        idx.mark_deleted(v)
    remap = idx.compact()
    assert set(remap) == set(before)
    assert len(idx) == 24 - len(doomed)
    # Bit-identical survivor payloads under the remapped ids.
    for old, new in remap.items():
        assert np.array_equal(idx.dequantize_vertex(new), before[old])
    # Graph search agrees with brute force over the compacted arrays.
    n = len(idx)
    for old in list(before)[:8]:
        q = centers[old]
        got = idx.search(q, k=1, ef=48)[0][1]
        dense = quantized_l2_batch_dense(
            np.asarray(q, dtype=np.float64),
            idx._codes[:n], idx._scales[:n], idx._zps[:n], idx._mids[:n],
        )
        assert got == int(np.argmin(dense))


def test_compact_serialization_roundtrip():
    idx = HNSWIndex(16, m=4, seed=1, device="cpu")
    for _ in range(12):
        idx.insert(RNG.normal(0, 1, 16))
    idx.mark_deleted(2)
    idx.mark_deleted(9)
    blob = idx.to_bytes()
    idx2 = HNSWIndex.from_bytes(blob, device="cpu")
    assert idx2.dead_count == 2 and idx2.is_deleted(2) and idx2.is_deleted(9)
    idx2.compact()
    assert idx2.dead_count == 0 and len(idx2) == 10
    q = RNG.normal(0, 1, 16)
    # Re-serializes cleanly after compaction.
    idx3 = HNSWIndex.from_bytes(idx2.to_bytes(), device="cpu")
    assert idx2.search(q, k=3) == idx3.search(q, k=3)


def test_remap_page_vertices_patches_only_vid_field(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {}, _distinct())
    with open(eng._page_file(eng.model_info("m").page), "rb") as f:
        buf = f.read()
    page = read_page_header(buf)
    recs = [read_record(page, i) for i in range(page.n_records)]
    dims = {r.dim_key for r in recs}
    for dim in dims:
        shift = {r.vertex_id: r.vertex_id + 100 for r in recs if r.dim_key == dim}
        buf, changed = remap_page_vertices(buf, shift, dim)
        assert changed
    page2 = read_page_header(buf)
    for i, old in enumerate(recs):
        new = read_record(page2, i)
        assert new.vertex_id == old.vertex_id + 100
        assert new.name == old.name and new.shape == old.shape
        assert new.meta == old.meta
        assert np.array_equal(new.qdelta, old.qdelta)


def test_open_loader_survives_vacuum_remap(tmp_path):
    """A LoadedModel opened before vacuum must keep returning its own
    model's tensors after the index is compacted and ids renumbered."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    mk = lambda: {"w": RNG.normal(0, 5.0, (64,)).astype(np.float32)}
    eng.save_model("a", {}, mk())
    eng.save_model("b", {}, mk())
    eng.save_model("c", {}, mk())
    expect = eng.load_model("b").materialize()
    lm = eng.load_model("b")  # held open across the vacuum
    eng.delete_model("a")     # b's and c's vertex ids shift down on compact
    rep = eng.vacuum()
    assert rep["vertices_dropped"] == 1
    out = lm.materialize()
    assert np.array_equal(out["w"], expect["w"])
    # compressed_params sees the remapped base too (lazy: index to build).
    cp = lm.compressed_params()
    for name in cp:
        assert cp[name]["shape"] == lm.tensor(name).shape


def test_loader_over_deleted_model_keeps_its_snapshot(tmp_path):
    """Snapshot isolation: a handle opened before delete+vacuum keeps
    materializing the deleted model's weights bit-identically from its
    pinned snapshot (old index object, old page bytes) — new loads fail.

    This replaces the pre-concurrency contract where vacuum poisoned the
    handle; see docs/concurrency.md.
    """
    eng = StorageEngine(str(tmp_path), device="cpu")
    w = RNG.normal(0, 5.0, (64,)).astype(np.float32)
    eng.save_model("gone", {}, {"w": w})
    expect = eng.load_model("gone").materialize()
    lm = eng.load_model("gone")
    eng.delete_model("gone")
    rep = eng.vacuum()
    assert rep["vertices_dropped"] == 1
    out = lm.materialize()
    assert np.array_equal(out["w"], expect["w"])
    cp = lm.compressed_params()  # the compressed view stays valid too
    assert cp["w"]["base_codes"].size == expect["w"].size
    with pytest.raises(KeyError):
        eng.load_model("gone")


def test_compact_bridges_dead_chains():
    """Live regions connected only through a chain of dead waypoints must
    stay connected: contraction collapses whole dead components."""
    idx = HNSWIndex(8, m=4, seed=0, device="cpu")
    pts = RNG.normal(0, 1, (4, 8))
    for p in pts:
        idx.insert(p)
    # Force the topology live(0) — dead(1) — dead(2) — live(3) on layer 0.
    idx._neighbors[0] = {
        0: np.array([1], dtype=np.int64),
        1: np.array([0, 2], dtype=np.int64),
        2: np.array([1, 3], dtype=np.int64),
        3: np.array([2], dtype=np.int64),
    }
    idx.mark_deleted(1)
    idx.mark_deleted(2)
    remap = idx.compact()
    assert remap == {0: 0, 3: 1}
    assert 1 in idx._neighbors[0][0].tolist()
    assert 0 in idx._neighbors[0][1].tolist()


# ------------------------------------------------------------- crash recovery
SAVE_POINTS = [
    "save.after_intent",
    "save.after_index_flush",
    "save.after_page_write",
    "save.after_snapshot",
]


@pytest.mark.parametrize("point", SAVE_POINTS)
def test_crash_during_save_replays_consistent(tmp_path, point):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("keep", {}, _tensors())
    keep = eng.load_model("keep").materialize()
    catmod.FAILPOINTS.add(point)
    with pytest.raises(InjectedCrash):
        eng.save_model("doomed", {}, _distinct())
    catmod.FAILPOINTS.clear()

    eng2 = StorageEngine(str(tmp_path), device="cpu")
    if point == "save.after_snapshot":
        # Crash after the atomic snapshot switch: the save committed.
        assert eng2.list_models() == ["keep", "doomed"]
    else:
        assert eng2.list_models() == ["keep"]
    assert_consistent(eng2)
    out = eng2.load_model("keep").materialize()
    assert all(np.array_equal(out[k], keep[k]) for k in keep)


@pytest.mark.parametrize(
    "point",
    ["delete.after_intent", "delete.after_snapshot", "delete.after_index_flush"],
)
def test_crash_during_delete_replays_consistent(tmp_path, point):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("keep", {}, _tensors())
    eng.save_model("gone", {}, _distinct())
    catmod.FAILPOINTS.add(point)
    with pytest.raises(InjectedCrash):
        eng.delete_model("gone")
    catmod.FAILPOINTS.clear()

    eng2 = StorageEngine(str(tmp_path), device="cpu")
    if point == "delete.after_intent":
        assert eng2.list_models() == ["keep", "gone"]  # rolled back whole
    else:
        assert eng2.list_models() == ["keep"]  # rolled forward
    assert_consistent(eng2)


VACUUM_POINTS = [
    "vacuum.after_intent",
    "vacuum.after_sidefiles",
    "vacuum.after_switch_log",
    "vacuum.mid_switch",
]


@pytest.mark.parametrize("point", VACUUM_POINTS)
def test_crash_mid_vacuum_replays_consistent(tmp_path, point):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("old", {}, _distinct())
    eng.save_model("young", {}, _distinct())
    snap = eng.load_model("young").materialize()
    eng.delete_model("old")
    catmod.FAILPOINTS.add(point)
    with pytest.raises(InjectedCrash):
        eng.vacuum()
    catmod.FAILPOINTS.clear()

    eng2 = StorageEngine(str(tmp_path), device="cpu")
    assert eng2.list_models() == ["young"]
    assert_consistent(eng2)
    out = eng2.load_model("young").materialize()
    assert all(np.array_equal(out[k], snap[k]) for k in snap)
    # A fresh vacuum on the recovered store completes and stays consistent.
    eng2.vacuum()
    assert_consistent(eng2)
    out = eng2.load_model("young").materialize()
    assert all(np.array_equal(out[k], snap[k]) for k in snap)


def test_failed_save_does_not_block_engine_in_process(tmp_path):
    """A save that dies mid-commit must release its in-flight refs: the
    same engine instance keeps saving and vacuuming, and the next open
    sweeps the orphan page."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("keep", {}, _distinct())
    catmod.FAILPOINTS.add("save.after_page_write")
    with pytest.raises(InjectedCrash):
        eng.save_model("doomed", {}, _distinct())
    catmod.FAILPOINTS.clear()
    assert not eng._inflight
    eng.save_model("more", {}, _distinct())
    rep = eng.vacuum()
    assert rep["skipped_dims"] == []
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    assert sorted(eng2.list_models()) == ["keep", "more"]
    assert_consistent(eng2)


def test_vacuum_failure_in_process_quarantines_dim_and_survives_commits(tmp_path):
    """A vacuum that fails mid-switch without killing the process must (a)
    quarantine the half-switched dim so uses fail loudly, and (b) keep its
    journal records across later commits so reopen still replays it."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    dim = 64
    eng.save_model("old", {}, {"w": RNG.normal(0, 5.0, (dim,)).astype(np.float32)})
    eng.save_model("young", {}, {"w": RNG.normal(0, 5.0, (dim,)).astype(np.float32)})
    snap = eng.load_model("young").materialize()
    eng.delete_model("old")
    catmod.FAILPOINTS.add("vacuum.mid_switch")
    with pytest.raises(InjectedCrash):
        eng.vacuum()
    catmod.FAILPOINTS.clear()

    # The dim is quarantined: saves and loads of it fail loudly.
    with pytest.raises(RuntimeError, match="half-applied vacuum"):
        eng.save_model("new", {}, {"w": RNG.normal(0, 5.0, (dim,)).astype(np.float32)})
    with pytest.raises(RuntimeError, match="half-applied vacuum"):
        eng.load_model("young").materialize()
    assert eng.vacuum()["skipped_dims"] == [dim]

    # A commit on an unrelated dim must NOT erase the vacuum's journal
    # records (selective truncation).
    eng.save_model("other", {}, {"w": RNG.normal(0, 5.0, (dim * 2,)).astype(np.float32)})

    eng2 = StorageEngine(str(tmp_path), device="cpu")  # replays the half-switched vacuum
    assert sorted(eng2.list_models()) == ["other", "young"]
    assert_consistent(eng2)
    out = eng2.load_model("young").materialize()
    assert np.array_equal(out["w"], snap["w"])


def test_replace_crash_rolls_back_new_version(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    old = _tensors()
    eng.save_model("m", {}, old)
    snap = eng.load_model("m").materialize()
    catmod.FAILPOINTS.add("save.after_page_write")
    with pytest.raises(InjectedCrash):
        eng.replace_model("m", {}, _distinct())
    catmod.FAILPOINTS.clear()
    eng2 = StorageEngine(str(tmp_path), device="cpu")
    assert eng2.list_models() == ["m"]
    out = eng2.load_model("m").materialize()
    assert all(np.array_equal(out[k], snap[k]) for k in snap)
    assert_consistent(eng2)


# ------------------------------------------------------------ catalog format
def test_catalog_loads_seed_format_meta(tmp_path):
    """Pre-catalog stores (no status fields, no journal) open unchanged."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {"a": 1}, _tensors())
    snap = eng.load_model("m").materialize()
    # Strip the new fields back to the seed's shape.
    import json

    meta_path = os.path.join(str(tmp_path), "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    for entry in meta["models"].values():
        entry.pop("status", None)
    meta.pop("integrity", None)  # seed snapshots carry no checksum stamp
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    os.unlink(os.path.join(str(tmp_path), "journal.jsonl"))

    eng2 = StorageEngine(str(tmp_path), device="cpu")
    entry = eng2.model_info("m")
    assert isinstance(entry, ModelEntry)
    assert entry.status == STATUS_COMMITTED
    out = eng2.load_model("m").materialize()
    assert all(np.array_equal(out[k], snap[k]) for k in snap)


# ------------------------------------------------------------------ edge cases
def test_loader_double_materialize_regression(tmp_path):
    """Seed bug: the one-shot drain counter went negative on a second
    materialize() and re-dequantized shared bases on every access."""
    eng = StorageEngine(str(tmp_path), tau=10.0, device="cpu")
    t = RNG.normal(0, 0.02, (32, 32)).astype(np.float32)
    tensors = {"a": t, "b": t + 1e-5, "c": t - 1e-5}
    eng.save_model("m", {}, tensors)
    lm = eng.load_model("m")
    first = lm.materialize()
    assert not lm._deq_base  # drained → freed after the pass
    second = lm.materialize()
    for k in tensors:
        assert np.array_equal(first[k], second[k])
    assert not lm._deq_base
    assert all(v >= 0 for v in lm._remaining.values())
    # Repeated single-tensor access cycles the counter without going negative.
    for _ in range(7):
        lm.tensor("a")
    assert all(v >= 0 for v in lm._remaining.values())


def test_index_cache_trim_spills_sole_oversized_index(tmp_path):
    """Seed bug: one resident index larger than the whole budget was never
    evicted. trim() at commit boundaries spills it to disk."""
    eng = StorageEngine(str(tmp_path), cache_bytes=1, device="cpu")
    eng.save_model("m", {}, {"w": RNG.normal(0, 5.0, 256).astype(np.float32)})
    stats = eng.index_cache.stats()
    assert stats["resident"] == 0  # spilled at commit despite being the only one
    assert stats["evictions"] >= 1
    # The handle contract holds: the model loads from the on-disk index.
    out = eng.load_model("m").materialize()
    assert out["w"].shape == (256,)
