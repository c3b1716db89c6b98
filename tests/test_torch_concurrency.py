"""Concurrent read path: snapshot isolation, lock-free materialization,

The reference suite ``tests/test_concurrency.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).
engine stats counters, and the background maintenance daemon.

The headline (acceptance) test: a reader that opened a model before a
concurrent ``replace_model`` + ``vacuum`` still materializes the OLD
weights bit-identically from its pinned snapshot — old page bytes, old
index object — while a reader opening after the writer's commit sees the
new weights; and no reader holds the engine lock during dequantization
(proved by materializing while another thread owns the lock).

Run with ``PYTHONFAULTHANDLER=1`` (the CI thread-stress step does) so a
deadlock dumps tracebacks instead of hanging the job.
"""

import threading
import time

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core.loader import materialize_many
from repro_torch.core.maintenance import MaintenanceDaemon

RNG = np.random.default_rng(23)


def _model(scale=5.0, d=64):
    return {
        "w": RNG.normal(0, scale, (d, d)).astype(np.float32),
        "b": RNG.normal(0, scale, (d,)).astype(np.float32),
    }


# --------------------------------------------------------- snapshot isolation
def test_snapshot_isolation_across_replace_and_vacuum(tmp_path):
    """The acceptance bar: old-snapshot readers keep the old weights
    bit-identically across replace+vacuum; post-commit readers see new."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {}, _model())
    old_weights = eng.load_model("m").materialize()

    reader = eng.load_model("m")  # snapshot captured BEFORE the writes
    new_tensors = _model()
    eng.replace_model("m", {}, new_tensors)
    rep = eng.vacuum()  # drops the old version's now-unreferenced bases
    assert rep["vertices_dropped"] > 0

    # Old snapshot: bit-identical old weights, lock-free (see below).
    out = reader.materialize()
    for k in old_weights:
        assert np.array_equal(out[k], old_weights[k])

    # New reader: the replacement, not the snapshot.
    fresh = eng.load_model("m").materialize()
    for k in new_tensors:
        assert np.abs(fresh[k] - new_tensors[k]).max() <= 2.0 ** -24 * 1.001 + 1e-9
        assert not np.array_equal(fresh[k], old_weights[k])


def test_reader_never_takes_engine_lock_during_dequant(tmp_path):
    """Hold the engine lock in this thread; a snapshot reader in another
    thread must still complete materialize() — i.e. the read path is
    lock-free after capture."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {}, _model())
    lm = eng.load_model("m")
    result: dict = {}

    def read():
        result["out"] = lm.materialize()
        cp = lm.compressed_params()
        result["params"] = {name: cp[name] for name in cp}

    t = threading.Thread(target=read)
    with eng._lock:  # a writer mid-commit, as far as readers can tell
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "materialize() blocked on the engine lock"
    assert set(result["out"]) == {"w", "b"}
    assert set(result["params"]) == {"w", "b"}


def test_snapshot_entry_is_immune_to_vacuum_renames(tmp_path):
    """The snapshot's catalog row is a copy: vacuum re-pointing the live
    entry at a rewritten page must not change what an open handle says it
    pinned (lm.info.page names the bytes the snapshot actually holds)."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("dead", {}, _model())
    eng.save_model("m", {}, _model())
    lm = eng.load_model("m")
    pinned_page = lm.info.page
    eng.delete_model("dead")
    rep = eng.vacuum()  # renumbers m's vertices → rewrites m's page
    assert rep["pages_rewritten"] >= 1
    assert lm.info.page == pinned_page                 # snapshot view
    assert eng.model_info("m").page != pinned_page     # live catalog moved
    lm.materialize()


def test_snapshot_epoch_advances_with_writer_commits(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("a", {}, _model())
    e1 = eng.stats()["epoch"]
    lm = eng.load_model("a")
    assert lm.snapshot.epoch == e1
    eng.save_model("b", {}, _model())
    e2 = eng.stats()["epoch"]
    assert e2 > e1
    eng.delete_model("b")
    assert eng.stats()["epoch"] > e2
    # The old handle still pins the oldest epoch.
    assert eng.stats()["snapshots"]["oldest_epoch"] == e1
    lm.close()
    stats = eng.stats()
    assert stats["snapshots"]["live"] == 0
    assert stats["snapshots"]["oldest_epoch"] is None


def test_concurrent_readers_and_writer_thread_stress(tmp_path):
    """4 reader threads materialize models while a writer replaces and
    deletes concurrently; every read must be internally consistent (a
    version the catalog committed at some point, never a mix)."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    versions: dict[str, list[dict]] = {}
    for name in ("m0", "m1"):
        t = _model()
        eng.save_model(name, {}, t)
        versions[name] = [eng.load_model(name).materialize()]

    stop = threading.Event()
    errors: list[str] = []
    version_lock = threading.Lock()

    def writer():
        k = 0
        while not stop.is_set():
            name = f"m{k % 2}"
            new = _model()
            eng.replace_model(name, {}, new)
            with version_lock:
                versions[name].append(eng.load_model(name).materialize())
            eng.vacuum()
            k += 1
            time.sleep(0.002)

    def reader(seed: int):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            name = f"m{rng.integers(2)}"
            try:
                out = eng.load_model(name).materialize()
            except KeyError:
                continue
            with version_lock:
                known = list(versions[name])
            ok = any(
                all(np.array_equal(out[k], v[k]) for k in out)
                for v in known
            )
            if not ok:
                errors.append(f"{name}: read a state no commit produced")
                stop.set()
                return

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader, args=(s,)) for s in range(4)
    ]
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "stress deadlocked"
    assert not errors, errors
    # The store is still consistent and serves both models.
    for name in ("m0", "m1"):
        eng.load_model(name).materialize()


# ------------------------------------------------------------ stats satellite
def test_engine_stats_expose_pool_and_snapshot_counters(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m", {}, _model())
    lm1 = eng.load_model("m")
    lm1.materialize()
    lm2 = eng.load_model("m")
    lm2.materialize()
    stats = eng.stats()
    pool = stats["buffer_pool"]
    assert pool["misses"] == 1          # one page read for both handles
    assert pool["hits"] >= 1            # second handle hit the frame
    assert pool["decoded_misses"] == 2  # two records decoded once...
    assert pool["decoded_hits"] >= 2    # ...and shared with handle 2
    assert pool["pinned_bytes"] > 0     # live handles pin their frame
    assert pool["resident_bytes"] >= pool["pinned_bytes"] or pool["detached"]
    assert stats["epoch"] >= 1
    assert stats["snapshots"]["live"] == 2
    assert stats["index_cache"]["resident"] >= 1
    lm1.close()
    lm2.close()
    assert eng.stats()["buffer_pool"]["pinned_bytes"] == 0


def test_pool_eviction_under_tiny_budget(tmp_path):
    eng = StorageEngine(str(tmp_path), pool_bytes=1, device="cpu")
    eng.save_model("a", {}, _model())
    eng.save_model("b", {}, _model())
    a = eng.load_model("a").materialize()
    eng.load_model("b").materialize()
    stats = eng.stats()["buffer_pool"]
    assert stats["evictions"] >= 1
    assert stats["resident_bytes"] <= max(1, stats["pinned_bytes"])
    # Evicted pages reload transparently and identically.
    again = eng.load_model("a").materialize()
    for k in a:
        assert np.array_equal(again[k], a[k])


def test_materialize_many_shares_bases_lock_free(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    base = _model(scale=0.02)
    eng.save_model("base", {}, base)
    ft = {k: v + RNG.normal(0, 3e-4, v.shape).astype(np.float32)
          for k, v in base.items()}
    r = eng.save_model("ft", {}, ft)
    assert r.n_new_bases == 0
    handles = eng.load_models(["base", "ft"])
    with eng._lock:  # cross-handle sharing must not need the engine lock
        done: dict = {}
        t = threading.Thread(
            target=lambda: done.update(out=materialize_many(handles)))
        t.start()
        t.join(30)
        assert not t.is_alive()
    outs = done["out"]
    for k, v in base.items():
        assert np.abs(outs[0][k] - v).max() <= 2.0 ** -24 * 1.001 + 1e-9


# -------------------------------------------------------- maintenance daemon
def test_maintenance_step_runs_incremental_vacuum(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("keep", {}, _model())
    eng.save_model("dead1", {}, _model())
    eng.save_model("dead2", {}, _model())
    eng.delete_model("dead1")
    eng.delete_model("dead2")
    daemon = MaintenanceDaemon(eng, dead_fraction=0.25)
    # Deterministic synchronous stepping: one dim-group per step.
    dims = eng.index_cache.dims()
    dropped = 0
    reports = [daemon.step() for _ in range(len(dims))]
    dropped = sum(r["vertices_dropped"] for r in reports)
    assert dropped == 4  # both dead models' bases, both dims
    assert {r["dim_checked"] for r in reports} == set(dims)  # round-robin
    assert daemon.steps == len(dims)
    assert daemon.stats()["vacuumed_vertices"] == 4
    # Survivor is untouched.
    eng.load_model("keep").materialize()
    # A further step finds nothing to do.
    assert daemon.step()["vertices_dropped"] == 0


def test_maintenance_step_respects_dead_fraction_threshold(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    for i in range(4):
        eng.save_model(f"m{i}", {}, _model())
    eng.delete_model("m3")  # 1/4 dead per dim < 0.5 threshold
    daemon = MaintenanceDaemon(eng, dead_fraction=0.5)
    for _ in eng.index_cache.dims():
        assert daemon.step()["vertices_dropped"] == 0


def test_maintenance_step_trims_pool_pressure(tmp_path):
    eng = StorageEngine(str(tmp_path), pool_bytes=4096, device="cpu")
    for i in range(6):
        eng.save_model(f"m{i}", {}, _model())
    for i in range(6):
        eng.load_model(f"m{i}").materialize()  # handles dropped → unpinned
    daemon = MaintenanceDaemon(eng, pool_high_watermark=0.0)
    rep = daemon.step()
    assert rep["pool_bytes_trimmed"] > 0 or \
        eng.page_pool.resident_bytes() == 0


def test_maintenance_daemon_thread_lifecycle(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("a", {}, _model())
    eng.save_model("b", {}, _model())
    eng.delete_model("b")
    daemon = eng.start_maintenance(dead_fraction=0.1, interval_s=0.01)
    assert daemon.running
    assert eng.start_maintenance() is daemon  # idempotent
    deadline = time.monotonic() + 30
    while daemon.stats()["vacuumed_vertices"] < 2:
        if time.monotonic() > deadline:
            pytest.fail(f"daemon made no progress: {daemon.stats()}")
        time.sleep(0.01)
    assert daemon.errors == 0, daemon.last_error
    eng.close()
    assert not daemon.running
    assert eng.maintenance is None
    eng.load_model("a").materialize()  # store healthy after daemon work


def test_maintenance_skips_dims_with_inflight_saves(tmp_path):
    """The daemon's vacuum must coexist with writers: engine.vacuum already
    skips dims an in-flight save pins; a daemon running at full tilt while
    models save and delete must never corrupt the store."""
    eng = StorageEngine(str(tmp_path), device="cpu")
    eng.save_model("m0", {}, _model())
    daemon = eng.start_maintenance(dead_fraction=0.0, interval_s=0.001)
    for i in range(1, 12):
        eng.save_model(f"m{i}", {}, _model())
        if i % 3 == 0:
            eng.delete_model(f"m{i - 1}")
    eng.close()
    assert daemon.errors == 0, daemon.last_error
    for name in eng.list_models():
        eng.load_model(name).materialize()
