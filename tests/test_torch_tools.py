"""The port's operator tools against the reference's ``tools/``, on the CPU.

``repro_torch.tools.fsck`` and the reference's ``tools/fsck.py`` check the
same damaged copies of one port store and give the same report; each
repairs its copy, and both repaired copies open in both packages with the
surviving models bit-identical to their loads before the damage.
``repro_torch.tools.nstat`` renders the same text as ``tools/nstat.py``
from the same metrics and accounting; ``repro_torch.tools.hillclimb``
writes the port dry run's record and fails on a failed cell;
``repro_torch.tools.make_roofline_table`` renders a port record as the
reference's ``tools/make_roofline_table.py`` renders one with its peak
device memory, which the port's dry run leaves null. Each
tool runs in a subprocess without loading ``jax``, ``repro`` or
``benchmarks``, and exits with the engine's CUDA error unless given
``--device cpu`` where there is no card.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core.catalog import Catalog
from repro_torch.core.integrity import journal_line
from repro_torch.launch import dryrun
from repro_torch.server import ModelStoreServer
from repro_torch.store import NeurStore
from repro_torch.tools import fsck as port_fsck
from repro_torch.tools import hillclimb
from repro_torch.tools import make_roofline_table as port_roofline
from repro_torch.tools import nstat as port_nstat

REPO = Path(__file__).resolve().parent.parent


def _reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_fsck = _reference_tool("fsck")
ref_nstat = _reference_tool("nstat")
ref_roofline = _reference_tool("make_roofline_table")

FSCKS = {"reference": lambda root, **kw: ref_fsck.fsck(root, **kw),
         "port": lambda root, **kw: port_fsck.fsck(root, device="cpu", **kw)}
ENGINES = {"reference": lambda root: R.StorageEngine(root),
           "port": lambda root: T.StorageEngine(root, device="cpu")}


# ------------------------------------------------------------------ stores
@pytest.fixture(scope="module")
def template(tmp_path_factory):
    """A port store of a base, its fine-tune and an unrelated model (three
    index dims, one only the unrelated model uses), and each model's
    tensors as loaded before any damage."""
    root = str(tmp_path_factory.mktemp("template") / "store")
    rng = np.random.default_rng(0)
    base = {"a": rng.normal(0, 1, (16, 8)).astype(np.float32),
            "b": rng.normal(0, 1, (24,)).astype(np.float32)}
    ft = {k: (v + rng.normal(0, 1e-3, v.shape)).astype(np.float32) for k, v in base.items()}
    eng = T.StorageEngine(root, device="cpu")
    eng.save_model("base", {}, base)
    eng.save_model("ft", {}, ft)
    eng.save_model("solo", {}, {"c": rng.normal(0, 1, (40,)).astype(np.float32)})
    loads = {name: eng.load_model(name).materialize() for name in eng.list_models()}
    eng.close()
    return root, loads


def _flip(path: str, byte: int) -> None:
    with open(path, "r+b") as f:
        f.seek(byte % os.path.getsize(path))
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 1]))


def _corrupt_page(root):
    path = os.path.join(root, "pages", Catalog(root).get("ft").page)
    _flip(path, -4)


def _torn_tail(root):
    with open(os.path.join(root, "journal.jsonl"), "ab") as f:
        f.write(b'{"op": "intent", "tx": 99, "na')


def _corrupt_journal(root):
    with open(os.path.join(root, "journal.jsonl"), "wb") as f:
        f.write(b"garbage\n" + journal_line({"op": "commit", "tx": 9}).encode())


def _corrupt_meta(root):
    assert os.path.exists(os.path.join(root, "meta.json.prev"))
    _flip(os.path.join(root, "meta.json"), 12)


def _corrupt_index(root):
    path = os.path.join(root, "index", "hnsw_40.idx")
    _flip(path, -2)


def _orphan(root):
    with open(os.path.join(root, "pages", "model_999.page"), "wb") as f:
        f.write(b"partial garbage")


DAMAGE = {"clean": lambda root: None, "corrupt_page": _corrupt_page,
          "torn_tail": _torn_tail, "corrupt_journal": _corrupt_journal,
          "corrupt_meta": _corrupt_meta, "corrupt_index": _corrupt_index,
          "orphan": _orphan}


def _copies(template, tmp_path, damage) -> dict[str, str]:
    """One damaged copy of the template store for each fsck."""
    out = {}
    for who in FSCKS:
        root = str(tmp_path / who)
        shutil.copytree(template[0], root)
        DAMAGE[damage](root)
        out[who] = root
    return out


def _same_reports(reports: dict[str, dict], roots: dict[str, str]) -> dict:
    """The reports' errors, warnings, actions and verdict, each store's path
    replaced by ``<root>``; the two must be equal."""
    norm = {}
    for who, rep in reports.items():
        assert rep["root"] == roots[who]
        norm[who] = {k: (rep[k] if k == "clean" else
                         [line.replace(roots[who], "<root>") for line in rep[k]])
                     for k in ("errors", "warnings", "actions", "clean")}
    assert norm["port"] == norm["reference"]
    return norm["port"]


# -------------------------------------------------------------------- fsck
@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_fsck_reports_and_repairs_as_the_reference(template, tmp_path, damage):
    roots = _copies(template, tmp_path, damage)
    checked = _same_reports({who: FSCKS[who](roots[who]) for who in FSCKS}, roots)
    want_clean = damage in ("clean", "torn_tail", "orphan", "corrupt_meta")
    assert checked["clean"] == want_clean, checked
    assert bool(checked["errors"] or checked["warnings"]) == (damage != "clean")

    repaired = _same_reports(
        {who: FSCKS[who](roots[who], repair=True, drop_corrupt=True) for who in FSCKS}, roots)
    assert repaired["clean"] and not repaired["errors"], repaired
    assert bool(repaired["actions"])  # at least the rebuilt reference table

    # Both repaired copies open in both packages; the survivors load
    # bit-identically to their loads before the damage, and the same
    # models survive in every open.
    survivors = None
    for root in roots.values():
        for make in ENGINES.values():
            eng = make(root)
            try:
                assert not eng.read_only
                names = eng.list_models()
                for name in names:
                    got = eng.load_model(name).materialize()
                    want = template[1][name]
                    assert got.keys() == want.keys()
                    for k in want:
                        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}/{k}")
            finally:
                eng.close()
            survivors = names if survivors is None else survivors
            assert names == survivors
    # A promoted .prev is the snapshot before the last save (solo's).
    dropped = {"corrupt_page": {"ft"}, "corrupt_index": {"solo"},
               "corrupt_meta": {"solo"}}.get(damage, set())
    assert set(survivors) == set(template[1]) - dropped


def test_fsck_accounting_drift_as_the_reference(template, tmp_path):
    """Forced accounting drift: each package's live engine with a corrupted
    ledger, cross-checked by its own fsck, gives the same drift lines; the
    same stores with no drift are clean under ``accounting=True``."""
    roots = _copies(template, tmp_path, "clean")
    _same_reports({who: FSCKS[who](roots[who], accounting=True) for who in FSCKS}, roots)
    drift = {}
    for who, mod in (("reference", ref_fsck), ("port", port_fsck)):
        eng = ENGINES[who](roots[who])
        try:
            eng._accountant.record_delete("ft")
            rep = {"root": roots[who], "errors": [], "warnings": [], "actions": []}
            mod._check_accounting(roots[who], rep, engine=eng)
            drift[who] = [line.replace(roots[who], "<root>") for line in rep["errors"]]
        finally:
            eng.close()
    assert drift["port"] == drift["reference"]
    assert drift["port"] and any("ft" in line for line in drift["port"])


def test_fsck_cli_output_and_exit_codes(template, tmp_path):
    roots = _copies(template, tmp_path, "corrupt_page")
    out = {}
    for who, mod in (("reference", ref_fsck), ("port", port_fsck)):
        extra = ["--device", "cpu"] if who == "port" else []
        runs = []
        for args in ([], ["--repair", "--drop-corrupt"], ["--json"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                runs.append((mod.main([roots[who], *args, *extra]),
                             buf.getvalue().replace(roots[who], "<root>")))
        out[who] = runs
    assert out["port"] == out["reference"]
    assert [rc for rc, _ in out["port"]] == [1, 0, 0]
    assert out["port"][0][1].endswith("NOT clean\n")
    assert json.loads(out["port"][2][1])["clean"] is True


# ------------------------------------------------------------------- nstat
@pytest.fixture(scope="module")
def busy_store(template, tmp_path_factory):
    """A copy of the template after a save, loads at two widths and a
    delete through the port's facade: its metrics text and accounting."""
    root = str(tmp_path_factory.mktemp("busy") / "store")
    shutil.copytree(template[0], root)
    with NeurStore.open(root, device="cpu") as store:
        store.engine.save_model("solo2", {"tenant": "t1"},
                                {"c": np.linspace(-1, 1, 40, dtype=np.float32)})
        for bits in (None, 8):
            store.engine.load_model("base", bits=bits).materialize()
        store.engine.delete_model("solo2")
        store.stats()
        text, report = store.metrics_text(), store.accounting()
    return root, text, report


def test_nstat_render_as_the_reference(busy_store):
    _, text, _ = busy_store
    fam_port = port_nstat.parse_prometheus_text(text)
    fam_ref = ref_nstat.parse_prometheus_text(text)
    assert fam_port == fam_ref
    # A second snapshot with every counter moved: the per-second rates.
    later = {name: {**fam, "samples": [{**s, "value": s["value"] + 3.0}
                                       for s in fam["samples"]]}
             for name, fam in fam_port.items()}
    for prev, interval in ((None, 1.0), (fam_port, 2.0)):
        got = port_nstat._render(later if prev else fam_port, prev, interval)
        want = ref_nstat._render(later if prev else fam_ref, prev, interval)
        assert got == want
        assert got.startswith("[engine]") and "  neurstore_" in got
    assert "(+1.5/s)" in port_nstat._render(later, fam_port, 2.0)


def test_nstat_render_space_as_the_reference(busy_store):
    _, _, report = busy_store
    got = port_nstat._render_space(report)
    assert got == ref_nstat._render_space(report)
    assert got.startswith("[store]  models=3") and "[per model]" in got
    empty = {"store": {"models": 0}}
    assert port_nstat._render_space(empty) == ref_nstat._render_space(empty)


def test_nstat_embedded_space_as_the_reference(template, tmp_path, capsys):
    roots = _copies(template, tmp_path, "clean")
    assert ref_nstat.main([roots["reference"], "--space"]) == 0
    want = capsys.readouterr().out
    assert port_nstat.main([roots["port"], "--space", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("[store]  models=3")


# How long a scrape waits for the server to count the requests before it.
COUNTED_DEADLINE_S = 5.0
METRICS = ("GET", "metrics", "2xx")


def _request_counts() -> dict:
    """The in-process registry's ``neurstore_server_requests_total``, by
    (method, route, status class): process-wide, so it holds the requests
    of every server this process has run."""
    from repro_torch.obs.metrics import default_registry, parse_prometheus_text

    fam = parse_prometheus_text(default_registry().render()).get(
        "neurstore_server_requests_total", {"samples": []})
    return {(s["labels"]["method"], s["labels"]["route"], s["labels"]["status"]): s["value"]
            for s in fam["samples"]}


def _await_counted(want: float) -> None:
    """Wait until the server has counted ``want`` metrics scrapes: its
    handler counts a request after it has written the answer, so a client
    can read a whole scrape and send the next before the first is
    counted."""
    deadline = time.monotonic() + COUNTED_DEADLINE_S
    while _request_counts().get(METRICS, 0.0) < want:
        assert time.monotonic() < deadline, (
            f"the server counted {_request_counts().get(METRICS, 0.0)} metrics scrapes of "
            f"{want} after {COUNTED_DEADLINE_S} s")
        time.sleep(0.01)


def test_nstat_scrapes_a_port_server(template, tmp_path, capsys):
    """``--url`` against the port's server: the request counters it renders
    are the requests made (one scrape before, so the scrape's own request
    is not yet counted), beside what this process's earlier servers
    counted. Each scrape waits until the server has counted the scrapes
    before it."""
    root = str(tmp_path / "store")
    shutil.copytree(template[0], root)
    eng = T.StorageEngine(root, device="cpu")
    server = ModelStoreServer(eng, port=0).start()
    try:
        url = f"http://{server.host}:{server.port}"
        want = _request_counts()
        assert port_nstat.main(["--url", url, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "families" in out.splitlines()[0] and "[engine]" in out
        want[METRICS] = want.get(METRICS, 0.0) + 1
        _await_counted(want[METRICS])
        assert port_nstat.main(["--url", url, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("  neurstore_server_requests_total{")]
        assert lines == [f"  neurstore_server_requests_total{{method={m},route={r},status={s}}}"
                         f" = {v:.0f}" for (m, r, s), v in sorted(want.items())]
        _await_counted(want[METRICS] + 1)
        assert port_nstat.main(["--url", url, "--space", "--device", "cpu"]) == 0
        assert capsys.readouterr().out.startswith("[store]  models=3")
    finally:
        server.stop()
        eng.close()


# --------------------------------------------------------------- hillclimb
def _env() -> dict:
    return {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", "/tmp"), "CUDA_VISIBLE_DEVICES": "",
            "OMP_NUM_THREADS": "2"}


_CHECK = """
import runpy, sys
sys.argv = [{mod!r}] + {args!r}
try:
    runpy.run_module({mod!r}, run_name="__main__")
except SystemExit as exc:
    code = exc.code
else:
    code = 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
print("LOADED", bad, flush=True)
sys.exit(code)
"""


def _run_tool(mod: str, args: list[str], cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _CHECK.format(mod=mod, args=args)],
                          env=_env(), cwd=cwd, capture_output=True, text=True, timeout=300)


def test_hillclimb_writes_run_cells_record(tmp_path):
    """One cell in a subprocess (the fake process group takes the default
    group): the record is ``run_cell``'s with its label, nothing of JAX or
    the reference is loaded, and ``make_roofline_table.fmt_row`` renders
    it."""
    out = tmp_path / "hill.json"
    proc = _run_tool("repro_torch.tools.hillclimb",
                     ["--only", "internlm2_train", "--out", str(out), "--device", "cpu"],
                     tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["label"] == "internlm2_train/dp_zero"
    assert (rec["arch"], rec["shape"], rec["multi_pod"]) == ("internlm2-1.8b", "train_4k", False)
    assert rec["per_device"]["hlo_flops"] > 0 and rec["bottleneck"] in (
        "compute", "memory", "collective")
    assert rec["model_flops"] == dryrun.model_flops(
        dryrun.get_config("internlm2-1.8b"), dryrun.SHAPES["train_4k"])
    # The reference's table divides the record's peak HBM bytes, which the
    # port's dry run leaves null; the port's renders it as "—" and the rest
    # of the row as the reference does.
    with pytest.raises(TypeError):
        ref_roofline.fmt_row(rec)
    row = port_roofline.fmt_row(rec)
    assert row.startswith("| internlm2-1.8b | train_4k | 16×16 | — | ")
    with_hbm = {**rec, "per_device": {**rec["per_device"], "peak_hbm_bytes": 3 << 30}}
    assert port_roofline.fmt_row(with_hbm) == ref_roofline.fmt_row(with_hbm)
    assert row == ref_roofline.fmt_row(with_hbm).replace("| 3.0 |", "| — |", 1)
    for other in ({"arch": "a", "shape": "s", "error": "x"},
                  {"arch": "a", "shape": "s", "skipped": True, "reason": "r"}):
        assert port_roofline.fmt_row(other) == ref_roofline.fmt_row(other)


def test_hillclimb_exits_1_when_a_cell_errors(tmp_path, monkeypatch, capsys):
    def broken(arch, shape, multi_pod, **kw):
        raise RuntimeError(f"no cell {arch}")

    out = tmp_path / "hill.json"
    monkeypatch.setattr(hillclimb, "run_cell", broken)
    assert hillclimb.main(["--only", "qwen3", "--out", str(out), "--device", "cpu"]) == 1
    recs = json.loads(out.read_text())
    assert [r["label"] for r in recs] == ["qwen3_train/dp_zero", "qwen3_decode/compressed"]
    assert all("RuntimeError('no cell qwen3-8b')" == r["error"] for r in recs)
    assert "!! qwen3_train/dp_zero failed" in capsys.readouterr().out

    calls = []
    monkeypatch.setattr(hillclimb, "run_cell",
                        lambda arch, shape, multi_pod, **kw: calls.append(kw) or {"arch": arch})
    assert hillclimb.main(["--only", "decode", "--out", str(out), "--device", "cpu"]) == 0
    assert calls == [{"compressed": True}, {"compressed": True}]


# ------------------------------------------- the tools in their own process
@pytest.mark.parametrize("tool,args", [
    ("fsck", ["--accounting"]),
    ("nstat", ["--space"]),
    ("nstat", ["--traces", "2"]),
])
def test_tool_loads_no_reference_module(template, tmp_path, tool, args):
    root = str(tmp_path / "store")
    shutil.copytree(template[0], root)
    proc = _run_tool(f"repro_torch.tools.{tool}", [root, *args, "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("tool", ["fsck", "nstat", "hillclimb"])
def test_tool_needs_a_card_unless_told_cpu(template, tmp_path, tool):
    """Without ``--device cpu`` on a machine with no card the tool exits
    non-zero with the CUDA error, before it touches the store (the
    subprocess sees no card: ``CUDA_VISIBLE_DEVICES`` is empty)."""
    root = str(tmp_path / "store")
    shutil.copytree(template[0], root)
    args = {"fsck": [root], "nstat": [root], "hillclimb": ["--out", str(tmp_path / "h.json")]}
    proc = _run_tool(f"repro_torch.tools.{tool}", args[tool], tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "h.json").exists()
