"""Tests for the storage-introspection layer (``docs/observability.md``).

The reference suite ``tests/test_accounting.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).

The contract under test:

- **Conservation**: for every committed model, ``delta_bytes +
  metadata_bytes == page_bytes == os.path.getsize(page)``, and the
  store totals re-sum from the per-model rows; amortized shared-base
  bytes re-sum to the store base bytes (± integer rounding).
- **No drift**: the incremental :class:`SpaceAccountant` — maintained
  at save/replace/delete/vacuum commit points — matches a full page
  rescan after every mutation, across a reopen, and after a mid-save
  crash + replay (the fsck ``--accounting`` invariant).
- **EXPLAIN**: every save report carries per-tensor dedup attribution
  whose delta bytes sum to the accountant's physical delta bytes; the
  rows persist via write-behind sidecars and survive a reopen.
- **Round-trip**: ``/v1/accounting`` and ``…/models/{name}/explain``
  serve the same numbers through ``StoreClient``.
- The ``SaveRequest.total_bytes`` quota footprint is post-cast f32 and
  the slow-op threshold is configurable via env var / server knob.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core.faultfs import FaultCrash, FaultFS, FaultPlan
from repro_torch.obs.trace import (
    DEFAULT_SLOW_OP_THRESHOLD_S,
    get_slow_op_threshold,
    set_slow_op_threshold,
)
from repro_torch.server import ModelStoreServer, StoreClient
from repro_torch.store import SaveRequest

# ``repro_torch.obs`` re-exports the ``trace`` *function* under the same name
# as the module, so resolve the module itself explicitly.
trace_mod = importlib.import_module("repro_torch.obs.trace")

_FSCK_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "fsck.py",
)
_spec = importlib.util.spec_from_file_location("neurstore_fsck_a", _FSCK_PATH)
fsck_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fsck_mod)
fsck = fsck_mod.fsck

EXPLAIN_KEYS = {
    "tensor", "dim", "vertex_id", "outcome", "probe_distance",
    "delta_range", "tau", "nbit", "delta_bytes", "error_bound",
}
OUTCOMES = {"new_base", "delta", "intra_save_dedup"}


def _mk(seed, n=3, d=32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        f"t{i}": rng.normal(0, scale, (d,)).astype(np.float32)
        for i in range(n)
    }


def _finetune(tensors, seed=99, eps=1e-3):
    rng = np.random.default_rng(seed)
    return {
        k: (v + eps * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in tensors.items()
    }


def _assert_conserved(eng):
    """The accounting taxonomy must re-sum exactly to the bytes on disk."""
    rep = eng.accounting_report()
    store, per_model = rep["store"], rep["per_model"]
    n_tensors = 0
    for name, m in per_model.items():
        disk = os.path.getsize(os.path.join(eng.root, "pages", m["page"]))
        assert m["delta_bytes"] + m["metadata_bytes"] == m["page_bytes"], name
        assert m["page_bytes"] == disk, name
        assert m["physical_bytes"] == (
            m["page_bytes"] + m["shared_base_bytes"]), name
        n_tensors += m["n_tensors"]
    for key in ("page_bytes", "delta_bytes", "logical_bytes"):
        assert store[key] == sum(m[key] for m in per_model.values()), key
    assert store["models"] == len(per_model)
    assert store["physical_bytes"] == store["page_bytes"] + store["base_bytes"]
    # Shared-base amortization (numel / refcount per sharer) must re-sum
    # to the store base bytes up to one byte of rounding per tensor.
    shared = sum(m["shared_base_bytes"] for m in per_model.values())
    assert abs(shared - store["base_bytes"]) <= max(n_tensors, 1)
    # The per-dim breakdown partitions the same totals.
    per_dim = rep["per_dim"]
    assert sum(d["logical_bytes"] for d in per_dim.values()) == \
        store["logical_bytes"]
    assert sum(d["delta_bytes"] for d in per_dim.values()) == \
        store["delta_bytes"]
    assert sum(d["base_bytes"] for d in per_dim.values()) == \
        store["base_bytes"]
    return rep


# -------------------------------------------------------------- satellites
def test_total_bytes_is_post_cast_f32_footprint():
    # The store casts to f32 before quantizing: an f16 upload is not
    # half price and an f64 upload is not double.
    t16 = {"a": np.ones(10, dtype=np.float16)}
    t64 = {"b": np.ones(10, dtype=np.float64)}
    assert SaveRequest("m", t16).total_bytes() == 40
    assert SaveRequest("m", t64).total_bytes() == 40
    both = SaveRequest("m", {**t16, **t64})
    assert both.total_bytes() == 80


def test_slow_op_threshold_env_parsing(monkeypatch):
    monkeypatch.delenv("NEURSTORE_SLOW_OP_THRESHOLD_S", raising=False)
    assert trace_mod._threshold_from_env() == DEFAULT_SLOW_OP_THRESHOLD_S
    monkeypatch.setenv("NEURSTORE_SLOW_OP_THRESHOLD_S", "2.5")
    assert trace_mod._threshold_from_env() == 2.5
    for bad in ("not-a-number", "", "0", "-3", "nan"):
        monkeypatch.setenv("NEURSTORE_SLOW_OP_THRESHOLD_S", bad)
        assert trace_mod._threshold_from_env() == \
            DEFAULT_SLOW_OP_THRESHOLD_S, bad


def test_set_slow_op_threshold_returns_previous():
    prev = set_slow_op_threshold(0.5)
    try:
        assert get_slow_op_threshold() == 0.5
        assert set_slow_op_threshold(1.5) == 0.5
    finally:
        set_slow_op_threshold(prev)


def test_server_knob_sets_threshold_and_healthz_reports_it(tmp_path):
    before = get_slow_op_threshold()
    engine = StorageEngine(str(tmp_path), device="cpu")
    server = ModelStoreServer(engine, slow_op_threshold_s=0.25).start()
    try:
        assert get_slow_op_threshold() == 0.25
        c = StoreClient(server.host, server.port, tenant="acme")
        body = c._json("GET", "/v1/healthz")
        assert body["slow_op_threshold_s"] == 0.25
    finally:
        server.stop()
        engine.close()
        set_slow_op_threshold(before)


# ------------------------------------------------------------ conservation
def test_conservation_and_amortization_across_dim_groups(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    try:
        base = _mk(1, n=3, d=32)
        eng.save_model("base", {}, base)
        eng.save_model("ft", {}, _finetune(base))  # shares base vertices
        eng.save_model("other", {}, _mk(2, n=2, d=48, scale=4.0))
        rep = _assert_conserved(eng)
        assert rep["store"]["logical_bytes"] == (3 * 32 + 3 * 32 + 2 * 48) * 4
        assert set(rep["per_dim"]) == {"32", "48"} | set()
        # Deleting "ft" reclaims its page but none of the shared bases.
        assert rep["per_model"]["ft"]["reclaimable_bytes"] >= \
            rep["per_model"]["ft"]["page_bytes"]
        assert eng.accounting_drift() == []
    finally:
        eng.close()


def test_accounting_tracks_lifecycle_without_drift(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    try:
        base = _mk(3, n=2, d=24)
        eng.save_model("a", {}, base)
        eng.save_model("b", {}, _finetune(base))
        for step in (
            lambda: eng.save_model("a", {}, _mk(4, n=2, d=24, scale=2.0)),
            lambda: eng.delete_model("b"),
            lambda: eng.vacuum(),
            lambda: eng.save_model("c", {}, _mk(5, n=2, d=24)),
        ):
            step()
            assert eng.accounting_drift() == []
            _assert_conserved(eng)
    finally:
        eng.close()

    eng = StorageEngine(root, device="cpu")  # reopen reseeds the ledger from a rescan
    try:
        assert eng.accounting_drift() == []
        _assert_conserved(eng)
    finally:
        eng.close()


def test_accounting_disabled_still_reports_via_rescan(tmp_path):
    eng = StorageEngine(str(tmp_path), accounting=False, device="cpu")
    try:
        eng.save_model("m", {}, _mk(6))
        rep = _assert_conserved(eng)  # computed from a one-off rescan
        assert rep["store"]["models"] == 1
        assert eng.accounting_drift() == []  # vacuously clean
    finally:
        eng.close()


@pytest.mark.parametrize("at_call", [3, 9, 18])
def test_accounting_survives_crash_replay(tmp_path, at_call):
    """One crash schedule (the test_faultfs campaign covers the full
    space): kill the process at an arbitrary I/O call mid-workload, then
    the reopened engine's replayed ledger must match a full rescan."""
    root = str(tmp_path)
    fs = FaultFS(FaultPlan(at_call=at_call, kind="crash"))
    crashed = False
    try:
        eng = StorageEngine(root, fs=fs, device="cpu")
        base = _mk(7, n=2, d=16)
        eng.save_model("wa", {}, base)
        eng.save_model("wb", {}, _finetune(base))
        eng.save_model("wa", {}, _mk(8, n=2, d=16, scale=2.0))
        eng.delete_model("wb")
    except FaultCrash:
        crashed = True
    else:
        eng.close()
    assert crashed, "schedule never reached the fault"

    eng = StorageEngine(root, device="cpu")  # crash recovery replays the journal
    try:
        assert eng.accounting_drift() == []
        _assert_conserved(eng)
        eng.save_model("post", {}, _mk(9, n=2, d=16))
        assert eng.accounting_drift() == []
        _assert_conserved(eng)
    finally:
        eng.close()


# ----------------------------------------------------------------- EXPLAIN
def test_save_report_explain_attributes_every_tensor(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    try:
        base = _mk(10, n=4, d=64)
        rep1 = eng.save_model("base", {}, base)
        rep2 = eng.save_model("ft", {}, _finetune(base))
        for rep, tensors in ((rep1, base), (rep2, base)):
            assert [ex["tensor"] for ex in rep.explain] == list(tensors)
            for ex in rep.explain:
                assert EXPLAIN_KEYS <= set(ex)
                assert ex["outcome"] in OUTCOMES
                assert ex["dim"] == 64 and ex["delta_bytes"] >= 0
        # A fresh store has no vertices: the first save mints new bases.
        assert rep1.explain[0]["outcome"] == "new_base"
        assert rep1.explain[0]["probe_distance"] is None
        # The fine-tune lands within tau of the existing bases.
        assert all(ex["outcome"] != "new_base" for ex in rep2.explain)
        # Acceptance: per-tensor delta bytes sum to the accountant's
        # physical delta bytes for the model.
        pm = eng.accounting_report()["per_model"]
        for rep in (rep1, rep2):
            assert sum(ex["delta_bytes"] for ex in rep.explain) == \
                pm[rep.name]["delta_bytes"]
    finally:
        eng.close()


def test_explain_sidecars_are_write_behind_and_survive_reopen(tmp_path):
    root = str(tmp_path)
    explain_dir = os.path.join(root, "explain")
    eng = StorageEngine(root, device="cpu")
    rep = eng.save_model("m", {}, _mk(11, n=3, d=32))
    # Write-behind: nothing hits disk on the save path itself.
    assert os.listdir(explain_dir) == []
    before = eng.model_explain("m")  # served from memory meanwhile
    assert before["explain"] == rep.explain and not before["truncated"]
    eng.close()  # close() flushes the queue
    files = os.listdir(explain_dir)
    assert files == [f"model_{rep.model_id}.json"]

    eng = StorageEngine(root, device="cpu")
    try:
        after = eng.model_explain("m")
        assert not after["truncated"]
        assert len(after["explain"]) == len(rep.explain)
        for got, want in zip(after["explain"], rep.explain):
            for k in ("tensor", "dim", "vertex_id", "outcome", "nbit",
                      "delta_bytes"):
                assert got[k] == want[k], k
            # Sidecar floats are trimmed to 6 significant digits.
            assert got["error_bound"] == pytest.approx(
                want["error_bound"], rel=1e-4)
        assert after["accounting"]["page_bytes"] > 0
    finally:
        eng.close()


def test_explain_sidecar_lifecycle_delete_vacuum_orphans(tmp_path):
    root = str(tmp_path)
    explain_dir = os.path.join(root, "explain")
    eng = StorageEngine(root, device="cpu")
    ra = eng.save_model("a", {}, _mk(12, n=2, d=16))
    rb = eng.save_model("b", {}, _mk(13, n=2, d=16, scale=4.0))
    eng.delete_model("b")  # dequeues + unlinks b's (never-written) sidecar
    eng.vacuum()  # vacuum flushes the queue
    assert os.listdir(explain_dir) == [f"model_{ra.model_id}.json"]
    assert eng.accounting_drift() == []
    eng.close()

    # An orphan sidecar (crash between delete commit and cleanup) is
    # swept at open, like orphan pages.
    stray = os.path.join(explain_dir, "model_999.json")
    with open(stray, "w") as f:
        json.dump([], f)
    eng = StorageEngine(root, device="cpu")
    try:
        assert not os.path.exists(stray)
        assert os.path.exists(
            os.path.join(explain_dir, f"model_{ra.model_id}.json"))
        assert eng.model_explain("a")["explain"], "survivor lost its rows"
        with pytest.raises(KeyError):
            eng.model_explain("b")
    finally:
        eng.close()
    del rb


# -------------------------------------------------------------------- fsck
def test_fsck_accounting_clean_and_forced_drift(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("m", {}, _mk(14))
    eng.close()
    rep = fsck(root, accounting=True)
    assert rep["clean"], rep["errors"]

    # Forced drift: corrupt the live ledger, then the cross-check must
    # report it as an error (drift = failure, not warning).
    eng = StorageEngine(root, device="cpu")
    try:
        eng._accountant.record_delete("m")
        lines = eng.accounting_drift()
        assert lines and any("m" in ln for ln in lines)
        rep = {"root": root, "errors": [], "warnings": [], "actions": []}
        fsck_mod._check_accounting(root, rep, engine=eng)
        assert rep["errors"] == lines
    finally:
        eng.close()


# -------------------------------------------------------------- round-trip
def test_http_accounting_and_explain_roundtrip(tmp_path):
    engine = StorageEngine(str(tmp_path), device="cpu")
    server = ModelStoreServer(engine).start()
    try:
        c = StoreClient(server.host, server.port, tenant="acme")
        base = _mk(15, n=4, d=64)
        c.save(SaveRequest("base", base))
        rep = c.save(SaveRequest("ft", _finetune(base)))
        assert rep.explain and len(rep.explain) == len(base)
        for ex in rep.explain:
            assert EXPLAIN_KEYS <= set(ex)
            assert ex["outcome"] in OUTCOMES

        acct = c.accounting()
        pm = acct["per_model"]["acme/ft"]
        # Acceptance: the wire report's per-tensor delta bytes sum to the
        # accountant's physical delta bytes for the same model.
        assert sum(ex["delta_bytes"] for ex in rep.explain) == \
            pm["delta_bytes"]
        tenants = acct["per_tenant"]
        assert tenants["acme"]["models"] == 2
        assert tenants["acme"]["physical_bytes"] == sum(
            m["physical_bytes"] for m in acct["per_model"].values())

        body = c.explain("ft")
        assert body["n_tensors"] == len(base) and not body["truncated"]
        assert [ex["tensor"] for ex in body["explain"]] == list(base)
        assert body["accounting"]["page_bytes"] == pm["page_bytes"]

        # The typed stats surface quotes the same store-wide accounting.
        s = c.stats()
        assert s.logical_bytes == acct["store"]["logical_bytes"]
        assert s.physical_bytes == acct["store"]["physical_bytes"]
        assert s.compression_ratio == pytest.approx(
            acct["store"]["compression_ratio"])
        assert engine.accounting_drift() == []
    finally:
        server.stop()
        engine.close()
