"""The port stands alone: no ``jax`` and nothing of ``repro`` in its process.

A fresh interpreter imports every ``repro_torch`` module, runs the CPU
slices end to end (save, dedup, load at bits 8 and 4, decode on compressed
weights; a dense model's prefill, a checkpoint and ``ModelServer.generate``
from it; a ``Trainer`` that checkpoints and resumes; a ``ModelStoreServer``
over a ``NeurStore`` that takes an upload through ``StoreClient`` and serves
it back at every width) and then checks
``sys.modules``. The same holds for
``chip_smoke.py``, whose source is checked for imports.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
import numpy as np
import repro_torch

mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)

from repro_torch.core import CompressedModel, StorageEngine
from repro_torch.launch.compressed_serve import DecoderSpec, greedy_decode, save_decoder

spec = DecoderSpec(d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, n_layers=1, vocab_size=40)
with tempfile.TemporaryDirectory() as root:
    eng = StorageEngine(root, device="cpu")
    save_decoder(eng, "a", spec, seed=1)
    rep = save_decoder(eng, "b", spec, seed=1)
    assert rep.n_new_bases == 0, rep
    for bits in (8, 4):
        toks = greedy_decode(CompressedModel(eng.load_model("b", bits=bits)), spec,
                             np.array([[1, 2]]), 3)
        assert tuple(toks.shape) == (1, 3)
    eng.close()

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.serve import ModelServer
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import init_params
import torch

cfg = get_config("internlm2-1.8b", smoke=True)
params = init_params(cfg, seed=0, device="cpu")
last = make_prefill_step(cfg)(params, {"tokens": torch.zeros((2, 16), dtype=torch.int64)})
assert tuple(last.shape) == (2, cfg.vocab_size) and bool(torch.isfinite(last).all())
with tempfile.TemporaryDirectory() as root:
    mgr = CheckpointManager(root, device="cpu")
    mgr.save(3, params)
    mgr.close()
    srv = ModelServer(cfg, root, bits=8, device="cpu")
    toks, stats = srv.generate(srv.load(), np.array([[1, 2, 3]]), max_new_tokens=4)
    assert toks.shape == (1, 4) and stats["tokens_per_s"] > 0
    srv.mgr.close()

from repro_torch.launch.train import Trainer

with tempfile.TemporaryDirectory() as root:
    rep = Trainer(cfg, root, ckpt_every=1, device="cpu").fit(steps=2, batch=2, seq=32)
    assert rep.end_step == 2 and all(np.isfinite(rep.losses))
    rep = Trainer(cfg, root, device="cpu").fit(steps=1, batch=2, seq=32)
    assert rep.resumed and rep.start_step == 2

from repro_torch.server import ModelStoreServer, QuotaManager, StoreClient
from repro_torch.store import NeurStore, SaveRequest

with tempfile.TemporaryDirectory() as root:
    store = NeurStore.open(root, device="cpu")
    with ModelStoreServer(store.engine, quotas=QuotaManager(default_limit=1 << 30)) as srv:
        client = StoreClient(srv.host, srv.port, tenant="t0")
        w = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
        client.save(SaveRequest("base", {"w": w}))
        rep = client.save(SaveRequest("ft", {"w": w + 1e-4}))
        assert rep.n_new_bases == 0, rep
        for bits in (None, 8, 4):
            got = client.load("ft", bits=bits).materialize()["w"]
            want = store.engine.load_model("t0/ft", bits=bits).materialize()["w"]
            assert got.tobytes() == want.tobytes()
        client.close()
    store.close()

bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(mods), "modules;", "leaked:", bad)
sys.exit(1 if bad or len(mods) < 20 else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "repro"}, f"{path}: {sorted(roots)}"


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
