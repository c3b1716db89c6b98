"""The store's front door, held across the two packages.

``repro_torch.store`` and ``repro_torch.server`` against ``repro.store`` and
``repro.server``, on the CPU (the port's engines with ``device="cpu"``):

- wire frames encoded by either package are byte-identical for the same
  tensors, for every numpy dtype a save accepts, and each package decodes
  the other's;
- the two error registries give the same code, HTTP status and raised
  class name for each failure class;
- each package's ``StoreClient`` against each package's
  ``ModelStoreServer`` gives the same save reports (counts, nbits, page
  bytes; EXPLAIN rows field for field), listings, catalog entries, stats
  and downloads at ``bits=None|8|4``, and the served streams are the same
  bytes;
- a store written through one package's server is served by the other's;
- ``NeurStore.open`` and ``python -m repro_torch.server`` run on the card
  by default: without CUDA they raise, and only ``device="cpu"`` /
  ``--device cpu`` runs here.

Tolerances: tensor and stream bytes are compared exactly; reports,
catalog entries and stats on every field but the timings
(``SaveReport.seconds``); an EXPLAIN row's ``probe_distance`` (a float32
distance from each package's ``quantized_l2``) within rtol 2e-3, its
kernel's tolerance, every other field exactly.
"""

import io
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro.server as RS
import repro.server.wire as RW
import repro.store as RST
import repro.store.errors as RE
import repro_torch.core as T
import repro_torch.server as TS
import repro_torch.server.wire as TW
import repro_torch.store as TST
import repro_torch.store.errors as TE

REPO = Path(__file__).resolve().parents[1]
PKGS = {"ref": (R, RS, RST), "port": (T, TS, TST)}
PROBE_RTOL = 2e-3

# Every numpy dtype a save accepts (the engine reads a tensor as float64),
# in both byte orders where it has one.
DTYPES = ["<f4", ">f4", "<f2", "<f8", "|i1", "|u1", "<i2", "<u2", "<i4", "<i8",
          "|b1"]


def _engine(pkg: str, root):
    core = PKGS[pkg][0]
    return core.StorageEngine(str(root)) if pkg == "ref" else \
        core.StorageEngine(str(root), device="cpu")


def _base(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.normal(0, 1, (48, 16)).astype(np.float32),
        "layer.0.w": rng.normal(0, 0.2, (16, 32)).astype(np.float32),
        "layer.0.norm": np.ones(16, np.float32),
        "layer.1.w": rng.normal(0, 0.2, (16, 32)).astype(np.float32),
        "head": rng.normal(0, 0.25, (16, 48)).astype(np.float32),
        "scalar": np.float32(0.5).reshape(()),
    }


def _finetune(base: dict, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0, 1e-3 * float(v.std() or 1.0), v.shape)).astype(np.float32)
            for k, v in base.items()}


def _arrays(dtype: str, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 40, (3, 5))
    arr = (vals > 0) if dtype == "|b1" else vals.astype(dtype)
    return [("w", arr), ("scalar", arr[0, :1].reshape(())), ("row", arr[1])]


# ------------------------------------------------------------------ wire
@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_frames_are_byte_identical(dtype):
    header = {"name": "m", "architecture": {"family": "toy"}, "bits": None}
    tensors = _arrays(dtype)
    ref = b"".join(RW.encode_model_stream(header, iter(tensors)))
    port = b"".join(TW.encode_model_stream(header, iter(tensors)))
    assert port == ref
    for decode in (RW.decode_model_stream, TW.decode_model_stream):
        head, records = decode(io.BytesIO(ref))
        assert head["name"] == "m" and head["stream_version"] == TW.STREAM_VERSION
        got = list(records)
        assert [n for n, _ in got] == [n for n, _ in tensors]
        for (_, a), (_, b) in zip(got, tensors):
            b = np.ascontiguousarray(b)  # as the encoder frames it: 0-d comes back 1-d
            assert a.dtype.str == dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


# -------------------------------------------------------------- registry
def _failures(pkg):
    """One instance of each failure class the registry maps, per package."""
    core = PKGS[pkg][0]
    errors = RE if pkg == "ref" else TE
    wire = RW if pkg == "ref" else TW
    return {
        "KeyError": KeyError("m"),
        "ValueError": ValueError("bad"),
        "RuntimeError": RuntimeError("boom"),
        "IntegrityError": core.IntegrityError("damaged"),
        "CorruptPageError": core.CorruptPageError("page"),
        "CorruptIndexError": core.CorruptIndexError("index"),
        "CorruptJournalError": core.CorruptJournalError("journal"),
        "CorruptMetaError": core.CorruptMetaError("meta"),
        "ReadOnlyStoreError": core.ReadOnlyStoreError("ro"),
        "KernelNotReady": core.KernelNotReady("not ready"),
        "QuotaExceededError": errors.QuotaExceededError("full"),
        "AdmissionRejectedError": errors.AdmissionRejectedError("shed"),
        "RemoteStoreError": errors.RemoteStoreError("remote"),
        "WireError": wire.WireError("torn"),
    }


@pytest.mark.parametrize("failure", sorted(_failures("ref")))
def test_error_registries_agree(failure):
    ref, port = _failures("ref")[failure], _failures("port")[failure]
    assert type(ref) is not type(port) or type(ref).__module__ == "builtins"
    assert TE.error_payload(port) == RE.error_payload(ref)
    code = RE.error_code_for(ref)
    assert TE.error_code_for(port) == code
    assert TE.http_status_for(code) == RE.http_status_for(code)
    raised = {}
    for name, errors in (("ref", RE), ("port", TE)):
        with pytest.raises(Exception) as info:
            errors.raise_for_code(code, "msg")
        raised[name] = type(info.value).__name__
    assert raised["ref"] == raised["port"]


def test_error_code_tables_agree():
    assert TE.ERROR_CODES == RE.ERROR_CODES
    assert {c: t.__name__ for c, t in TE._RAISERS.items()} == \
        {c: t.__name__ for c, t in RE._RAISERS.items()}
    with pytest.raises(TE.RemoteStoreError, match=r"\[newer\]"):
        TE.raise_for_code("newer", "x")


# ------------------------------------------------------ client x server
def _stream(server, tenant, name, bits):
    q = "" if bits is None else f"?bits={bits}"
    url = f"http://{server.host}:{server.port}/v1/tenants/{tenant}/models/{name}{q}"
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def _drive(client_pkg: str, server_pkg: str, root) -> dict:
    """Save, list, read and download through one client/server pair."""
    engine = _engine(server_pkg, root)
    server = PKGS[server_pkg][1].ModelStoreServer(engine).start()
    try:
        client = PKGS[client_pkg][1].StoreClient(server.host, server.port, tenant="t0")
        SaveRequest = PKGS[client_pkg][2].SaveRequest
        base = _base()
        out = {"reports": [client.save(SaveRequest("base", base, architecture={"f": "toy"})),
                           client.save(SaveRequest("ft", _finetune(base),
                                                   architecture={"f": "toy"}))]}
        out["models"] = client.models()
        out["info"] = {n: client.model_info(n) for n in out["models"]}
        out["stats"] = client.stats()
        out["downloads"] = {}
        out["streams"] = {}
        for name in out["models"]:
            for bits in (None, 8, 4):
                handle = client.load(name, bits=bits)
                out["downloads"][name, bits] = {
                    k: (v.dtype.str, v.shape, v.tobytes())
                    for k, v in handle.materialize().items()}
                out["streams"][name, bits] = _stream(server, "t0", name, bits)
        client.close()
    finally:
        server.stop()
        engine.close()
    return out


def _assert_same_reports(got, want):
    for a, b in zip(got, want):
        da, db = a.to_dict(), b.to_dict()
        ea, eb = da.pop("explain"), db.pop("explain")
        da.pop("seconds"), db.pop("seconds")
        assert da == db
        assert len(ea) == len(eb)
        for ra, rb in zip(ea, eb):
            pa, pb = ra.pop("probe_distance"), rb.pop("probe_distance")
            assert ra == rb
            assert (pa is None) == (pb is None)
            if pb is not None:
                np.testing.assert_allclose(pa, pb, rtol=PROBE_RTOL)


def _stats_fields(stats) -> dict:
    out = stats.to_dict()
    out.pop("raw")
    return out


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_client_and_server_interchange(tmp_path, client_pkg, server_pkg):
    want = _drive("ref", "ref", tmp_path / "want")
    got = _drive(client_pkg, server_pkg, tmp_path / "got")
    assert got["models"] == want["models"] == ["base", "ft"]
    assert {r.n_new_bases for r in got["reports"][1:]} == {0}
    _assert_same_reports(got["reports"], want["reports"])
    assert got["info"] == want["info"]
    assert _stats_fields(got["stats"]) == _stats_fields(want["stats"])
    assert got["downloads"] == want["downloads"]
    assert got["streams"] == want["streams"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_store_served_by_one_package_is_served_by_the_other(tmp_path, writer, reader):
    written = _drive(writer, writer, tmp_path)
    engine = _engine(reader, tmp_path)
    server = PKGS[reader][1].ModelStoreServer(engine).start()
    try:
        client = PKGS[reader][1].StoreClient(server.host, server.port, tenant="t0")
        assert client.models() == written["models"]
        for (name, bits), tensors in written["downloads"].items():
            got = {k: (v.dtype.str, v.shape, v.tobytes())
                   for k, v in client.load(name, bits=bits).materialize().items()}
            assert got == tensors, (name, bits)
            assert _stream(server, "t0", name, bits) == written["streams"][name, bits]
        # The reader saves on top of the writer's vertices: a delta each.
        SaveRequest = PKGS[reader][2].SaveRequest
        rep = client.save(SaveRequest("ft2", _finetune(_base(), seed=7)))
        assert {ex["outcome"] for ex in rep.explain} == {"delta"}
        client.close()
    finally:
        server.stop()
        engine.close()


# ------------------------------------------------------- the card default
def test_neurstore_open_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "store"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TST.NeurStore.open(str(root))
    assert not root.exists()  # refused before touching the directory
    with TST.NeurStore.open(str(root), device="cpu") as store:
        assert store.engine.device == torch.device("cpu")
        store.save(TST.SaveRequest("m", _base()))
        with store.load("m", bits=8) as handle:
            assert set(handle.materialize()) == set(_base())


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.server", *args],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_cli_refuses_without_a_card(tmp_path):
    proc = _cli("--store", str(tmp_path / "store"), "--port", "0")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0, out
    assert "device='cpu'" in err and "serving" not in out
    assert not (tmp_path / "store").exists()


def test_cli_serves_on_the_cpu_when_asked(tmp_path):
    proc = _cli("--store", str(tmp_path / "store"), "--port", "0", "--device", "cpu")
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving ") and " on http://" in line, line + proc.stderr.read()
        host, port = line.rsplit("http://", 1)[1].strip().rsplit(":", 1)
        client = TS.StoreClient(host, int(port), tenant="t0")
        assert client.healthz()
        client.save(TST.SaveRequest("m", _base()))
        assert client.models() == ["m"]
        client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
