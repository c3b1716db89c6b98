"""Storage-integrity tests: checksums, torn tails, degradation, fsck.

The reference suite ``tests/test_integrity.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).

The contract under test (see ``docs/durability.md``):

- every on-disk artifact (tensor pages, HNSW index files, the JSONL
  journal, ``meta.json``) carries CRCs, verified at frame admission /
  replay / open — a damaged artifact raises a **typed** error, never
  yields silently wrong tensor bytes;
- damage is contained: a corrupt page or index quarantines only the
  models it backs (the engine keeps serving the rest), while journal-body
  or catalog corruption degrades the whole store to read-only on the
  last good snapshot;
- a torn journal *tail* (the only damage an append crash can cause) is
  tolerated and truncated at open — satellite S1;
- the maintenance daemon never dies silently — satellite S2;
- random single-bit flips / truncations anywhere in the store never
  escape detection — satellite S3 (hypothesis property + seeded fallback);
- ``tools/fsck.py`` finds all of the above offline and repairs what is
  safely repairable.
"""

import importlib.util
import json
import os
import random
import shutil
import tempfile
import time

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core.catalog import (
    STATUS_CORRUPT,
    Catalog,
    read_journal,
)
from repro_torch.core.integrity import (
    CorruptIndexError,
    CorruptMetaError,
    CorruptPageError,
    IntegrityError,
    ReadOnlyStoreError,
    frame_index,
    journal_line,
    meta_payload,
    parse_journal_record,
    parse_meta,
    unframe_index,
)
from repro_torch.core.maintenance import MaintenanceDaemon
from repro_torch.core.pages import (
    TensorRecord,
    encode_payload,
    read_record,
    verify_page,
    write_page,
)
from repro_torch.core.quantize import quantize_delta

RNG = np.random.default_rng(7)

_FSCK_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "fsck.py",
)
_spec = importlib.util.spec_from_file_location("neurstore_fsck", _FSCK_PATH)
fsck_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spec and fsck_mod)
fsck = fsck_mod.fsck


def _tensors(n=2, d=16, scale=1.0, seed=None):
    rng = np.random.default_rng(seed) if seed is not None else RNG
    return {
        f"t{i}": rng.normal(0, scale, (d,)).astype(np.float32)
        for i in range(n)
    }


def _flip(path: str, byte: int, bit: int = 0) -> None:
    with open(path, "r+b") as f:
        f.seek(byte % os.path.getsize(path))
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ (1 << (bit % 8))]))


def _page_path(root: str, name: str) -> str:
    return os.path.join(root, "pages", Catalog(root).get(name).page)


# ------------------------------------------------------------ page framing
def _sample_records(k=3, d=16):
    recs = []
    for i in range(k):
        delta = RNG.normal(0, 0.01, d).astype(np.float32)
        qd, meta = quantize_delta(delta, 1e-3)
        rec = TensorRecord(
            name=f"r{i}", shape=(d,), dim_key=d, vertex_id=i,
            meta=meta, qdelta=qd,
        )
        rec.payload = encode_payload(rec)
        recs.append(rec)
    return recs


def test_page_v3_roundtrip():
    recs = _sample_records()
    buf = write_page(recs)
    page = verify_page(buf)
    assert page.n_records == len(recs)
    assert page.crcs is not None and all(c for c in page.crcs)
    for i in range(page.n_records):
        r = read_record(page, i)
        assert r.name == f"r{i}"


def test_page_without_checksums_still_parses():
    buf = write_page(_sample_records(), checksums=False)
    page = verify_page(buf)  # crc==0 sentinel: nothing to verify
    assert page.crcs is not None and not any(page.crcs)


def test_page_every_byte_flip_detected():
    """Any single bit flip anywhere in a v3 page raises CorruptPageError."""
    buf = bytes(write_page(_sample_records(k=2, d=8)))
    step = max(1, len(buf) // 64)  # sample ~64 positions across the file
    for off in range(0, len(buf), step):
        damaged = bytearray(buf)
        damaged[off] ^= 0x10
        with pytest.raises(CorruptPageError):
            verify_page(bytes(damaged))


def test_page_truncation_detected():
    buf = bytes(write_page(_sample_records()))
    for cut in (1, len(buf) // 3, len(buf) - 1):
        with pytest.raises(CorruptPageError):
            verify_page(buf[:cut])


# ------------------------------------------------------------ index framing
def test_index_frame_roundtrip_and_flip():
    payload = os.urandom(256)
    buf = frame_index(payload)
    assert unframe_index(buf) == payload
    for off in (0, 5, len(buf) // 2, len(buf) - 1):
        damaged = bytearray(buf)
        damaged[off] ^= 0x01
        with pytest.raises(CorruptIndexError):
            unframe_index(bytes(damaged))
    with pytest.raises(CorruptIndexError):
        unframe_index(buf[:-3])


# ---------------------------------------------------------- journal records
def test_journal_record_roundtrip_and_tamper():
    line = journal_line({"op": "intent", "tx": 3, "name": "m"})
    rec = parse_journal_record(line)
    assert rec["op"] == "intent" and rec["tx"] == 3
    with pytest.raises(ValueError):
        parse_journal_record(line.replace('"m"', '"x"'))
    # Legacy (no crc field) records still parse.
    assert parse_journal_record('{"op": "commit", "tx": 1}')["tx"] == 1


def test_read_journal_classifies_torn_vs_corrupt(tmp_path):
    jp = str(tmp_path / "journal.jsonl")
    good = [journal_line({"op": "intent", "tx": i}) for i in (1, 2)]
    # Damaged suffix (a torn half-written line) → torn, records intact.
    with open(jp, "w") as f:
        f.write("".join(good) + '{"op": "inte')
    records, max_tx, torn, corrupt = read_journal(jp)
    assert [r["tx"] for r in records] == [1, 2]
    assert torn is not None and corrupt is None and max_tx == 2
    # Multi-line garbage suffix is still just a torn tail.
    with open(jp, "w") as f:
        f.write("".join(good) + "garbage\nmore garbage")
    _, _, torn, corrupt = read_journal(jp)
    assert torn is not None and corrupt is None
    # Trailing blank line is clean.
    with open(jp, "w") as f:
        f.write("".join(good) + "\n")
    _, _, torn, corrupt = read_journal(jp)
    assert torn is None and corrupt is None
    # Damaged record BEFORE a valid one → body corruption.
    with open(jp, "w") as f:
        f.write("garbage\n" + good[1])
    _, _, _, corrupt = read_journal(jp)
    assert corrupt is not None


# ------------------------------------------------- S1: torn-tail tolerance
def test_reopen_truncates_torn_journal_tail(tmp_path):
    """Regression: a half-written trailing journal line must not prevent
    open — it is truncated and the committed state serves as usual."""
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    eng.save_model("b", {}, _tensors(seed=2, scale=4.0))
    base = {n: eng.load_model(n).materialize() for n in ("a", "b")}
    eng.close()

    jp = os.path.join(root, "journal.jsonl")
    with open(jp, "ab") as f:
        f.write(b'{"op": "intent", "tx": 99, "na')  # torn mid-write

    eng = StorageEngine(root, device="cpu")
    assert not eng.read_only
    for n in ("a", "b"):
        got = eng.load_model(n).materialize()
        for k in base[n]:
            np.testing.assert_array_equal(got[k], base[n][k])
    # The torn bytes are gone from disk after open.
    _, _, torn, corrupt = read_journal(jp)
    assert torn is None and corrupt is None
    eng.save_model("c", {}, _tensors(seed=3))  # store is fully writable
    eng.close()


def test_journal_body_corruption_degrades_to_read_only(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    base = eng.load_model("a").materialize()
    eng.close()

    jp = os.path.join(root, "journal.jsonl")
    with open(jp, "wb") as f:  # damaged record PRECEDES a valid one
        f.write(b"garbage\n" + journal_line({"op": "commit", "tx": 9}).encode())

    eng = StorageEngine(root, device="cpu")
    assert eng.read_only and "journal" in eng.degraded_reason
    got = eng.load_model("a").materialize()  # reads still served
    for k in base:
        np.testing.assert_array_equal(got[k], base[k])
    with pytest.raises(ReadOnlyStoreError):
        eng.save_model("x", {}, _tensors(seed=4))
    with pytest.raises(ReadOnlyStoreError):
        eng.delete_model("a")
    with pytest.raises(ReadOnlyStoreError):
        eng.vacuum()
    assert eng.stats()["integrity"]["read_only"] is True
    eng.close()


# ------------------------------------------------------- meta.json fallback
def test_meta_payload_roundtrip_and_flip():
    text = meta_payload({"models": {}, "next_id": 0})
    d = parse_meta(text)
    assert d["models"] == {} and "integrity" not in d
    with pytest.raises(CorruptMetaError):
        parse_meta(text.replace("0", "1", 1))
    # Legacy unstamped snapshots still parse.
    assert parse_meta(json.dumps({"models": {}}))["models"] == {}


def test_corrupt_meta_falls_back_to_prev_read_only(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    base = eng.load_model("a").materialize()
    eng.save_model("b", {}, _tensors(seed=2, scale=4.0))  # writes .prev
    eng.close()

    meta = os.path.join(root, "meta.json")
    assert os.path.exists(meta + ".prev")
    _flip(meta, byte=len(open(meta).read()) // 2, bit=3)

    eng = StorageEngine(root, device="cpu")
    assert eng.read_only and "last good" in eng.degraded_reason
    # "a" was committed in the prev snapshot: it must serve bit-identically.
    got = eng.load_model("a").materialize()
    for k in base:
        np.testing.assert_array_equal(got[k], base[k])
    with pytest.raises(ReadOnlyStoreError):
        eng.save_model("x", {}, _tensors(seed=5))
    eng.close()


def test_meta_and_prev_both_corrupt_is_unopenable(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    eng.save_model("b", {}, _tensors(seed=2))
    eng.close()
    meta = os.path.join(root, "meta.json")
    _flip(meta, byte=10)
    _flip(meta + ".prev", byte=10)
    with pytest.raises(CorruptMetaError):
        StorageEngine(root, device="cpu")


# --------------------------------------------------- quarantine containment
@pytest.fixture
def store_with_corrupt_page(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("good", {}, _tensors(seed=1))
    eng.save_model("bad", {}, _tensors(seed=2, scale=4.0))
    base = eng.load_model("good").materialize()
    eng.close()
    _flip(_page_path(root, "bad"), byte=-5 % os.path.getsize(
        _page_path(root, "bad")))
    return root, base


def test_corrupt_page_quarantines_only_that_model(store_with_corrupt_page):
    root, base = store_with_corrupt_page
    eng = StorageEngine(root, device="cpu")
    with pytest.raises(CorruptPageError):
        eng.load_model("bad").materialize()
    st = eng.stats()["integrity"]
    assert st["corrupt_models"] == ["bad"] and not st["read_only"]
    # Healthy model unaffected; store stays writable.
    got = eng.load_model("good").materialize()
    for k in base:
        np.testing.assert_array_equal(got[k], base[k])
    eng.save_model("new", {}, _tensors(seed=3))
    # Repeated loads report quarantine without re-reading the page.
    with pytest.raises(CorruptPageError, match="quarantined"):
        eng.load_model("bad")
    eng.close()

    # Quarantine is persisted: a fresh open still refuses the model.
    eng = StorageEngine(root, device="cpu")
    assert eng.catalog.get("bad").status == STATUS_CORRUPT
    with pytest.raises(CorruptPageError, match="quarantined"):
        eng.load_model("bad")
    # Vacuum refuses to renumber while quarantined models pin vertex ids.
    rep = eng.vacuum(min_dead_fraction=0.0)
    assert "quarantined" in rep.get("skipped_reason", "")
    # Deleting the quarantined model clears the quarantine and its refs.
    eng.delete_model("bad")
    assert eng.stats()["integrity"]["corrupt_models"] == []
    eng.vacuum(min_dead_fraction=0.0)  # now allowed
    eng.close()


def test_scrub_quarantines_latent_corruption(store_with_corrupt_page):
    root, _ = store_with_corrupt_page
    eng = StorageEngine(root, device="cpu")
    seen = 0
    for _ in range(8):  # round-robin over committed models
        seen += eng.scrub(max_models=1)["scanned"]
        if eng.stats()["integrity"]["corrupt_models"]:
            break
    assert eng.stats()["integrity"]["corrupt_models"] == ["bad"]
    assert seen >= 1
    reason = eng._corrupt_reasons["bad"]
    assert reason.startswith("scrub:")
    eng.close()


def test_verify_store_reports_and_quarantines(store_with_corrupt_page):
    root, _ = store_with_corrupt_page
    eng = StorageEngine(root, device="cpu")
    rep = eng.verify_store(quarantine=False)
    assert rep["pages"]["good"] == "ok"
    assert rep["pages"]["bad"].startswith("corrupt")
    assert not rep["quarantined"]
    rep = eng.verify_store(quarantine=True)
    assert rep["quarantined"] == ["bad"]
    eng.close()
    eng = StorageEngine(root, device="cpu")  # persisted
    assert eng.catalog.get("bad").status == STATUS_CORRUPT
    eng.close()


def test_corrupt_index_quarantines_dependent_models(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("m", {}, _tensors(seed=1))
    eng.close()
    idx_dir = os.path.join(root, "index")
    idx_file = os.path.join(idx_dir, os.listdir(idx_dir)[0])
    _flip(idx_file, byte=os.path.getsize(idx_file) - 2)
    eng = StorageEngine(root, device="cpu")
    with pytest.raises((CorruptIndexError, CorruptPageError)):
        eng.load_model("m").materialize()
    assert eng.stats()["integrity"]["corrupt_models"] == ["m"]
    eng.close()
    rep = fsck(root, repair=True, drop_corrupt=True)
    assert rep["clean"], rep
    assert any("index" in a for a in rep["actions"]), rep["actions"]


# ------------------------------------------------------------------- fsck
def test_fsck_clean_store(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    eng.close()
    rep = fsck(root)
    assert rep["clean"] and not rep["errors"] and not rep["warnings"], rep


def test_fsck_detects_and_repairs(store_with_corrupt_page):
    root, base = store_with_corrupt_page
    rep = fsck(root)
    assert not rep["clean"] and any("bad" in e for e in rep["errors"])
    # Repair without dropping: quarantines, store clean-with-warnings.
    rep = fsck(root, repair=True)
    assert rep["clean"]
    assert any("quarantined" in w for w in rep["warnings"])
    # Drop: fully clean, healthy model intact.
    rep = fsck(root, repair=True, drop_corrupt=True)
    assert rep["clean"] and not rep["warnings"], rep
    eng = StorageEngine(root, device="cpu")
    got = eng.load_model("good").materialize()
    for k in base:
        np.testing.assert_array_equal(got[k], base[k])
    assert eng.list_models() == ["good"]
    eng.close()
    assert fsck(root)["clean"]


def test_fsck_promotes_prev_snapshot(tmp_path):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    eng.save_model("b", {}, _tensors(seed=2))
    eng.close()
    meta = os.path.join(root, "meta.json")
    _flip(meta, byte=12)
    rep = fsck(root, repair=True, drop_corrupt=True)
    assert rep["clean"], rep
    assert any("promoted" in a for a in rep["actions"]), rep["actions"]
    assert os.path.exists(meta + ".corrupt")  # evidence kept
    eng = StorageEngine(root, device="cpu")
    assert not eng.read_only
    eng.load_model("a").materialize()
    eng.close()


def test_fsck_cli(tmp_path, capsys):
    root = str(tmp_path)
    eng = StorageEngine(root, device="cpu")
    eng.save_model("a", {}, _tensors(seed=1))
    eng.close()
    assert fsck_mod.main([root, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["clean"] is True
    _flip(_page_path(root, "a"), byte=-4 % os.path.getsize(
        _page_path(root, "a")))
    assert fsck_mod.main([root]) == 1
    assert fsck_mod.main([root, "--repair", "--drop-corrupt"]) == 0


# --------------------------------------------- S2: daemon failure containment
def test_daemon_backoff_math(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    d = MaintenanceDaemon(eng, interval_s=1.0, max_backoff_s=10.0)
    assert d._backoff_s() == 1.0
    d.consecutive_errors = 2
    assert d._backoff_s() == 4.0
    d.consecutive_errors = 8
    assert d._backoff_s() == 10.0  # capped
    eng.close()


def test_daemon_records_step_errors_and_recovers(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    d = MaintenanceDaemon(eng, interval_s=0.01)
    boom = {"on": True}
    real_step = d.step

    def step():
        if boom["on"]:
            raise RuntimeError("injected maintenance failure")
        return real_step()

    d.step = step
    d.start()
    deadline = time.time() + 10
    while d.errors < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert d.errors >= 3, "daemon stopped counting failures"
    assert d.consecutive_errors >= 1
    assert "injected maintenance failure" in d.last_error
    assert d.running  # it did NOT die
    boom["on"] = False
    while d.consecutive_errors != 0 and time.time() < deadline:
        time.sleep(0.01)
    assert d.consecutive_errors == 0  # reset on first success
    d.stop()
    st = d.stats()
    for key in ("errors", "last_error", "restarts", "consecutive_errors",
                "backoff_s"):
        assert key in st
    eng.close()


def test_daemon_supervisor_restarts_escaped_loop(tmp_path):
    eng = StorageEngine(str(tmp_path), device="cpu")
    d = MaintenanceDaemon(eng, interval_s=0.01, max_backoff_s=0.05)

    def step():
        raise KeyboardInterrupt("escapes the Exception handler")

    d.step = step
    d.start()
    deadline = time.time() + 10
    while d.restarts < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert d.restarts >= 2, "supervisor did not restart the loop"
    assert d.running
    d.stop()
    assert not d.running
    eng.close()


def test_engine_stats_surface_daemon_health(tmp_path):
    eng = StorageEngine(str(tmp_path), auto_maintenance=True, device="cpu")
    try:
        st = eng.stats()
        assert "maintenance" in st
        for key in ("errors", "last_error", "restarts"):
            assert key in st["maintenance"]
    finally:
        eng.close()


# --------------------------- S3: no single fault yields silently wrong bytes
class _Baseline:
    """A small store built once; trials mutate throwaway copies of it."""

    def __init__(self):
        self.root = tempfile.mkdtemp(prefix="nsint_")
        eng = StorageEngine(self.root, device="cpu")
        eng.save_model("a", {}, _tensors(seed=1))
        eng.save_model("b", {}, _tensors(seed=2, scale=4.0))
        eng.save_model("c", {}, _tensors(seed=3, scale=8.0))
        self.values = {
            n: eng.load_model(n).materialize() for n in ("a", "b", "c")
        }
        eng.close()
        self.files = []
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                p = os.path.join(dirpath, f)
                if os.path.getsize(p) > 0:
                    self.files.append(os.path.relpath(p, self.root))
        self.files.sort()


_BASELINE = None


def _baseline():
    global _BASELINE
    if _BASELINE is None:
        _BASELINE = _Baseline()
    return _BASELINE


def _check_one_fault(rel_idx: int, pos_frac: float, bit: int,
                     truncate: bool) -> None:
    """Apply one fault to a copy of the baseline store and assert the
    integrity contract: typed error, quarantine, degradation, or
    bit-identical data — never silently wrong bytes."""
    bl = _baseline()
    work = tempfile.mkdtemp(prefix="nsint_trial_")
    try:
        dst = os.path.join(work, "store")
        shutil.copytree(bl.root, dst)
        rel = bl.files[rel_idx % len(bl.files)]
        target = os.path.join(dst, rel)
        size = os.path.getsize(target)
        if truncate:
            with open(target, "r+b") as f:
                f.truncate(max(0, int(size * pos_frac)))
        else:
            _flip(target, byte=int((size - 1) * pos_frac), bit=bit)
        try:
            eng = StorageEngine(dst, device="cpu")
        except IntegrityError:
            return  # typed refusal at open is a pass
        try:
            for name, want in bl.values.items():
                try:
                    got = eng.load_model(name).materialize()
                except (IntegrityError, ValueError):
                    continue  # typed detection is a pass
                except KeyError:
                    # Degraded store serving an older snapshot, or a
                    # replay legitimately rolled the model back.
                    assert eng.read_only or name not in eng.list_models()
                    continue
                for k, v in want.items():
                    assert np.array_equal(got[k], v), (
                        f"SILENT CORRUPTION: {rel} fault gave wrong bytes "
                        f"for {name}/{k}"
                    )
        finally:
            eng.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def test_single_fault_never_silently_corrupts_seeded():
    """Seeded sweep (runs everywhere, no hypothesis needed)."""
    rng = random.Random(1234)
    for _ in range(60):
        _check_one_fault(
            rel_idx=rng.randrange(1 << 16),
            pos_frac=rng.random(),
            bit=rng.randrange(8),
            truncate=rng.random() < 0.3,
        )


try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(
        max_examples=25,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    @given(
        rel_idx=st.integers(min_value=0, max_value=1 << 16),
        pos_frac=st.floats(min_value=0.0, max_value=1.0),
        bit=st.integers(min_value=0, max_value=7),
        truncate=st.booleans(),
    )
    def test_single_fault_never_silently_corrupts_property(
        rel_idx, pos_frac, bit, truncate
    ):
        _check_one_fault(rel_idx, pos_frac, bit, truncate)

except ImportError:  # pragma: no cover - hypothesis optional locally
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_single_fault_never_silently_corrupts_property():
        """Placeholder so a missing-hypothesis env reports the skip."""
