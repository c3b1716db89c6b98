"""The typed embedded facade: ``repro_torch.store.NeurStore`` + shared dataclasses.

The reference suite ``tests/test_store_api.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).

Covers satellite S1 (facade + canonical knob set) and the pieces of the
typed surface the server tests then exercise over a socket:

- facade save/load roundtrips match raw-engine access bit for bit;
- ``SaveRequest`` survives its own wire-header encoding;
- ``LoadHandle`` gives the same tensors through all three access
  patterns and releases its snapshot on close;
- ``StoreStats`` projects the engine dump onto the documented schema and
  derives the two admission signals correctly;
- legacy import paths (``repro_torch.core.StorageEngine``/``SaveReport``) stay
  importable and identical to the facade's re-exports.
"""

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core.engine import STATS_SCHEMA_VERSION
from repro_torch.core.engine import SaveReport as EngineSaveReport
from repro_torch.store import (
    DEFAULT_TAU,
    DEFAULT_TOLERANCE,
    NeurStore,
    SaveReport,
    SaveRequest,
    StoreStats,
)

RNG = np.random.default_rng(11)


def _tensors(n=3, d=32, seed=None):
    rng = np.random.default_rng(seed) if seed is not None else RNG
    return {f"t{i}": rng.standard_normal((d,)).astype(np.float32)
            for i in range(n)}


@pytest.fixture
def store(tmp_path):
    with NeurStore.open(str(tmp_path), device="cpu") as s:
        yield s


# ------------------------------------------------------------------ facade
def test_facade_roundtrip_matches_engine(store):
    tensors = _tensors(seed=1)
    report = store.save(SaveRequest("m", tensors, architecture={"k": 1}))
    assert isinstance(report, SaveReport)
    with store.load("m") as handle:
        got = handle.materialize()
    raw = store.engine.load_model("m")
    try:
        for k in tensors:
            np.testing.assert_array_equal(got[k], raw.tensor(k))
    finally:
        raw.close()


def test_facade_replace_delete_models(store):
    store.save(SaveRequest("a", _tensors(seed=2)))
    with pytest.raises(KeyError):
        store.replace(SaveRequest("missing", _tensors(seed=3)))
    store.replace(SaveRequest("a", _tensors(seed=4)))
    assert store.models() == ["a"]
    store.delete("a")
    assert store.models() == []


def test_save_many_one_epoch_and_knob_guard(store):
    reqs = [SaveRequest(f"m{i}", _tensors(seed=10 + i)) for i in range(3)]
    reports = store.save_many(reqs)
    assert [r.name for r in reports] == ["m0", "m1", "m2"]
    # Batch commit bumps the epoch once, not once per model.
    assert store.stats().epoch == 1
    with pytest.raises(ValueError, match="per-save knob"):
        store.save_many([SaveRequest("x", _tensors(), tolerance=1e-2)])


def test_load_many_consistent_snapshot(store):
    store.save_many([SaveRequest(f"m{i}", _tensors(seed=i)) for i in range(2)])
    handles = store.load_many(["m0", "m1"])
    try:
        assert {h.name for h in handles} == {"m0", "m1"}
        for h in handles:
            assert set(h.tensor_names()) == {"t0", "t1", "t2"}
    finally:
        for h in handles:
            h.close()


def test_flexible_loading_bits_knob(store):
    tensors = _tensors(seed=5)
    store.save(SaveRequest("m", tensors))
    with store.load("m", bits=2) as coarse, store.load("m") as full:
        err_coarse = np.abs(coarse.tensor("t0") - tensors["t0"]).max()
        err_full = np.abs(full.tensor("t0") - tensors["t0"]).max()
    assert coarse.bits == 2 and full.bits is None
    assert err_full <= DEFAULT_TOLERANCE
    assert err_coarse >= err_full  # fewer planes can't be more precise


# -------------------------------------------------------------- LoadHandle
def test_load_handle_access_patterns_agree(store):
    tensors = _tensors(seed=6)
    store.save(SaveRequest("m", tensors))
    with store.load("m") as h:
        streamed = dict(h.tensors())
        assert set(streamed) == set(tensors)
        mat = h.materialize()
        for k in tensors:
            np.testing.assert_array_equal(streamed[k], mat[k])
            np.testing.assert_array_equal(h.tensor(k), mat[k])


def test_load_handle_close_releases_snapshot(store):
    store.save(SaveRequest("m", _tensors(seed=7)))
    h = store.load("m")
    h.materialize()
    assert store.stats().snapshots_live >= 1
    h.close()
    assert store.stats().snapshots_live == 0


# ------------------------------------------------------------- SaveRequest
def test_save_request_wire_header_roundtrip():
    tensors = _tensors(seed=8)
    req = SaveRequest("m", tensors, architecture={"family": "demo"},
                      tolerance=1e-2, tau=0.5)
    header = req.wire_header()
    assert header["n_tensors"] == len(tensors)
    back = SaveRequest.from_wire(header, tensors)
    assert (back.name, back.architecture, back.tolerance, back.tau) == \
        ("m", {"family": "demo"}, 1e-2, 0.5)
    assert req.total_bytes() == sum(t.nbytes for t in tensors.values())


def test_save_report_dict_roundtrip(store):
    report = store.save(SaveRequest("m", _tensors(seed=9)))
    d = report.to_dict()
    back = SaveReport.from_dict(d)
    assert back == report
    # Unknown keys from a newer server are ignored, not fatal.
    d["future_field"] = 42
    assert SaveReport.from_dict(d) == report


# -------------------------------------------------------------- StoreStats
def test_store_stats_projection_and_derived_signals(store):
    store.save(SaveRequest("m", _tensors(seed=12)))
    st = store.stats()
    assert st.schema_version == STATS_SCHEMA_VERSION
    assert st.models == 1 and st.epoch == 1
    assert st.raw["buffer_pool"]["budget_bytes"] == st.pool_budget_bytes

    synthetic = StoreStats(
        schema_version=1, epoch=10, models=1, snapshots_live=2,
        oldest_epoch=4, pool_resident_bytes=75, pool_budget_bytes=100,
        pool_pinned_bytes=0, read_only=False, corrupt_models=0)
    assert synthetic.pool_utilization == 0.75
    assert synthetic.epoch_lag == 6
    no_readers = StoreStats.from_dict(
        {**synthetic.to_dict(), "oldest_epoch": None,
         "pool_budget_bytes": 0})
    assert no_readers.epoch_lag == 0
    assert no_readers.pool_utilization == 0.0


# ------------------------------------------------------- legacy import path
def test_legacy_imports_are_the_same_objects():
    from repro_torch.core import StorageEngine as LegacyEngine

    assert LegacyEngine is StorageEngine
    assert SaveReport is EngineSaveReport  # facade re-export, not a copy
    assert DEFAULT_TOLERANCE > 0 and 0 < DEFAULT_TAU
