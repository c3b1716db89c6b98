"""FaultFS unit tests + the randomized fault-injection campaign.

The reference suite ``tests/test_faultfs.py`` held against the port: every
case, imports rewired onto ``repro_torch``, every engine made with
``device="cpu"`` (the port's engines default to the card).

The campaign is the PR's acceptance test: a fixed lifecycle workload
(save, replace, delete, vacuum, load) runs under hundreds of
deterministic fault schedules — EIO, short writes, silent bit flips, and
crashes at any individual I/O call — and after every schedule the store
must *reopen* to a consistent catalog (possibly with models quarantined
or the store degraded to read-only), never serve silently wrong tensor
bytes, and come back fully clean after ``tools/fsck.py --repair
--drop-corrupt`` and after the port's ``repro_torch.tools.fsck``, each
of which the campaign runs in turn.

``FAULT_CAMPAIGN_SCHEDULES`` (default 200; CI sets it explicitly) bounds
how many (call, kind) schedules the sweep samples.
"""

import functools
import importlib.util
import os
import random
import shutil
import tempfile
import types

import numpy as np
import pytest

from repro_torch.core import StorageEngine
from repro_torch.core.faultfs import (
    FAULT_KINDS,
    FaultCrash,
    FaultFS,
    FaultInjected,
    FaultPlan,
)
from repro_torch.core.integrity import IntegrityError
from repro_torch.tools import fsck as port_fsck

_FSCK_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "fsck.py",
)
_spec = importlib.util.spec_from_file_location("neurstore_fsck_c", _FSCK_PATH)
_ref_fsck = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref_fsck)
# The port's fsck with its engines on the CPU (they default to the card).
_port_fsck = types.SimpleNamespace(
    fsck=functools.partial(port_fsck.fsck, device="cpu"),
    main=lambda argv: port_fsck.main([*argv, "--device", "cpu"]),
    _check_accounting=functools.partial(port_fsck._check_accounting, device="cpu"),
)


@pytest.fixture(params=["reference", "port"])
def fsck_mod(request):
    """Each fsck: the reference's ``tools/fsck.py`` and the port's
    ``repro_torch.tools.fsck``."""
    return _ref_fsck if request.param == "reference" else _port_fsck


# ------------------------------------------------------------- unit tests
def test_plan_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultPlan(at_call=1, kind="meteor")


def test_eio_write_leaves_file_untouched(tmp_path):
    p = str(tmp_path / "f")
    FaultFS().write_durable(p, b"before")
    fs = FaultFS(FaultPlan(at_call=1, kind="eio"))
    with pytest.raises(FaultInjected) as ei:
        fs.write_durable(p, b"after", site="page.write")
    assert ei.value.errno == 5 and ei.value.site == "page.write"
    assert open(p, "rb").read() == b"before"
    assert fs.injected == ("eio", "write", "page.write")


def test_crash_before_write_vs_short_write_vs_crash_fsync(tmp_path):
    data = b"0123456789abcdef"
    p = str(tmp_path / "f")
    fs = FaultFS(FaultPlan(at_call=1, kind="crash"))
    with pytest.raises(FaultCrash):
        fs.write_durable(p, data)
    assert not os.path.exists(p)  # crash lands before any byte

    fs = FaultFS(FaultPlan(at_call=1, kind="short_write"))
    with pytest.raises(FaultCrash):
        fs.write_durable(p, data)
    assert open(p, "rb").read() == data[: len(data) // 2]  # torn prefix

    fs = FaultFS(FaultPlan(at_call=1, kind="crash_fsync"))
    with pytest.raises(FaultCrash):
        fs.write_durable(p, data)
    assert open(p, "rb").read() == data  # all bytes landed, fsync didn't


def test_bitflip_write_is_silent_single_bit(tmp_path):
    data = bytes(range(32))
    p = str(tmp_path / "f")
    fs = FaultFS(FaultPlan(at_call=1, kind="bitflip", bit=77))
    fs.write_durable(p, data)  # no exception: the flip is silent
    got = open(p, "rb").read()
    assert len(got) == len(data)
    diff = [(a ^ b) for a, b in zip(got, data) if a != b]
    assert len(diff) == 1 and bin(diff[0]).count("1") == 1


def test_bitflip_read_is_transient(tmp_path):
    data = bytes(range(32))
    p = str(tmp_path / "f")
    FaultFS().write_durable(p, data)
    fs = FaultFS(FaultPlan(at_call=1, kind="bitflip", bit=5))
    assert fs.read_bytes(p) != data  # damaged in memory...
    assert open(p, "rb").read() == data  # ...but not on disk
    assert fs.read_bytes(p) == data  # one-shot: next read is clean


def test_replace_crash_before_vs_after_rename(tmp_path):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    for kind, expect_dst in (("crash", False), ("crash_fsync", True)):
        FaultFS().write_durable(src, b"new")
        FaultFS().write_durable(dst, b"old")
        fs = FaultFS(FaultPlan(at_call=1, kind=kind))
        with pytest.raises(FaultCrash):
            fs.replace(src, dst)
        got = open(dst, "rb").read()
        assert got == (b"new" if expect_dst else b"old"), kind


def test_site_filter_counts_only_matching_calls(tmp_path):
    p = str(tmp_path / "f")
    fs = FaultFS(FaultPlan(at_call=1, kind="eio", site="journal"))
    fs.write_durable(p, b"x", site="page.write")  # not counted
    fs.write_durable(p, b"x", site="meta.tmp")  # not counted
    assert fs.calls == 0
    with pytest.raises(FaultInjected):
        fs.append_durable(p, "y", site="journal.append")
    assert fs.calls == 1


def test_record_mode_logs_every_call(tmp_path):
    p = str(tmp_path / "f")
    fs = FaultFS(record=True)
    fs.write_durable(p, b"x", site="page.write")
    fs.read_bytes(p, site="page.read")
    fs.unlink(p, site="unlink")
    assert fs.log == [
        ("write", "page.write"), ("read", "page.read"), ("unlink", "unlink"),
    ]
    assert fs.calls == 3


def test_truncate_durable(tmp_path):
    p = str(tmp_path / "f")
    FaultFS().write_durable(p, b"0123456789")
    FaultFS().truncate(p, 4)
    assert open(p, "rb").read() == b"0123"
    fs = FaultFS(FaultPlan(at_call=1, kind="eio"))
    with pytest.raises(FaultInjected):
        fs.truncate(p, 2)
    assert open(p, "rb").read() == b"0123"


# ------------------------------------------------------------- the campaign
def _mk(seed, scale=1.0, n=2, d=16):
    rng = np.random.default_rng(seed)
    return {
        f"t{i}": rng.normal(0, scale, (d,)).astype(np.float32)
        for i in range(n)
    }


_STEPS = (
    ("save", "wa", 10, 1.0),
    ("save", "wb", 11, 4.0),
    ("save", "wa", 12, 1.0),  # replace wa
    ("delete", "wb", None, None),
    ("save", "wc", 13, 8.0),
    ("vacuum", None, None, None),
    ("loads", None, None, None),
)


def _run_workload(eng, acceptable=None):
    """Run the lifecycle workload; when ``acceptable`` is given (the
    fault-free reference run) record every materialization each model
    ever legitimately had."""

    def snap():
        if acceptable is None:
            return
        for name in eng.list_models():
            vals = eng.load_model(name).materialize()
            versions = acceptable.setdefault(name, [])
            if not any(_same(vals, v) for v in versions):
                versions.append(vals)

    for op, name, seed, scale in _STEPS:
        if op == "save":
            eng.save_model(name, {}, _mk(seed, scale))
        elif op == "delete":
            eng.delete_model(name)
        elif op == "vacuum":
            eng.vacuum(min_dead_fraction=0.0)
        elif op == "loads":
            for n in eng.list_models():
                eng.load_model(n).materialize()
        snap()


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


class _Campaign:
    """Template store + fault-free reference, built once per test run."""

    def __init__(self):
        self.template = tempfile.mkdtemp(prefix="nsfault_tpl_")
        eng = StorageEngine(self.template, device="cpu")
        # Two snapshots so meta.json.prev exists before any fault lands —
        # a single fault must never be able to destroy the only snapshot.
        eng.save_model("seed0", {}, _mk(1))
        eng.save_model("seed1", {}, _mk(2, 4.0))
        eng.close()

        # Reference run: acceptable materializations per model name.
        ref = tempfile.mkdtemp(prefix="nsfault_ref_")
        shutil.copytree(self.template, ref, dirs_exist_ok=True)
        self.acceptable: dict[str, list[dict]] = {}
        eng = StorageEngine(ref, device="cpu")
        for name in eng.list_models():
            self.acceptable[name] = [eng.load_model(name).materialize()]
        _run_workload(eng, self.acceptable)
        eng.close()
        shutil.rmtree(ref, ignore_errors=True)

        # Counting run: how many faultable I/O calls the workload makes
        # (including the engine open itself).
        cnt = tempfile.mkdtemp(prefix="nsfault_cnt_")
        shutil.copytree(self.template, cnt, dirs_exist_ok=True)
        fs = FaultFS(record=True)
        eng = StorageEngine(cnt, fs=fs, device="cpu")
        _run_workload(eng)
        eng.close()
        self.n_calls = fs.calls
        shutil.rmtree(cnt, ignore_errors=True)


_CAMPAIGN = None


def _campaign():
    global _CAMPAIGN
    if _CAMPAIGN is None:
        _CAMPAIGN = _Campaign()
    return _CAMPAIGN


def _run_trial(at_call: int, kind: str, bit: int, fsck_mod) -> None:
    camp = _campaign()
    work = tempfile.mkdtemp(prefix="nsfault_trial_")
    try:
        root = os.path.join(work, "store")
        shutil.copytree(camp.template, root)
        fs = FaultFS(FaultPlan(at_call=at_call, kind=kind, bit=bit))
        try:
            eng = StorageEngine(root, fs=fs, device="cpu")
            _run_workload(eng)
            eng.close()
        except Exception:
            # The workload died mid-flight (simulated crash, EIO, or a
            # typed integrity refusal). If no fault actually fired, this
            # is a real bug — surface it.
            if fs.injected is None:
                raise
        # "Reboot": a clean open must always succeed — degraded at worst.
        eng = StorageEngine(root, device="cpu")
        try:
            for name in eng.list_models():
                try:
                    got = eng.load_model(name).materialize()
                except (IntegrityError, ValueError):
                    continue  # typed detection / quarantine is a pass
                versions = camp.acceptable.get(name)
                assert versions is not None, f"unexpected model {name!r}"
                assert any(_same(got, v) for v in versions), (
                    f"SILENT CORRUPTION at call {at_call} kind {kind}: "
                    f"model {name!r} served bytes matching no legitimate "
                    f"version"
                )
        finally:
            eng.close()
        # fsck must repair the store to fully clean.
        rep = fsck_mod.fsck(root, repair=True, drop_corrupt=True)
        assert rep["clean"], (
            f"fsck not clean after repair (call {at_call}, {kind}): "
            f"{rep['errors']}"
        )
        assert fsck_mod.fsck(root)["clean"]
        # And the repaired store serves every surviving model.
        eng = StorageEngine(root, device="cpu")
        try:
            assert not eng.read_only
            for name in eng.list_models():
                eng.load_model(name).materialize()
        finally:
            eng.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _schedules():
    camp = _campaign()
    n = camp.n_calls
    budget = int(os.environ.get("FAULT_CAMPAIGN_SCHEDULES", "200"))
    pairs = [(c, k) for c in range(1, n + 1) for k in FAULT_KINDS]
    rng = random.Random(0xFA171)
    rng.shuffle(pairs)
    if len(pairs) > budget:
        # Keep full call-coverage with one kind each, then fill the rest
        # of the budget with the shuffled remainder.
        per_call = {}
        for c, k in pairs:
            per_call.setdefault(c, (c, k))
        chosen = list(per_call.values())[:budget]
        extra = [p for p in pairs if p not in set(chosen)]
        chosen += extra[: budget - len(chosen)]
        pairs = chosen
    return [(c, k, rng.randrange(4096)) for c, k in pairs]


def test_fault_campaign(fsck_mod):
    sched = _schedules()
    assert sched, "workload made no faultable I/O calls?"
    for at_call, kind, bit in sched:
        _run_trial(at_call, kind, bit, fsck_mod)
