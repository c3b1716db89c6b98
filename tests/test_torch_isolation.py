"""The port stands alone: no ``jax`` and nothing of ``repro`` in its process.

A fresh interpreter imports every ``repro_torch`` module, runs the CPU
slices end to end (save, dedup, load at bits 8 and 4, decode on compressed
weights; a dense model's prefill, a checkpoint and ``ModelServer.generate``
from it; a ``Trainer`` that checkpoints and resumes; a host-quantized
compressed serve step, full-size shape stand-ins on the ``meta`` device
and a world-size-1 ``cross_pod_sync`` over gloo; a sharded train step on
DTensor state and ``restore_sharded`` over a world-size-1 gloo mesh; a
``ModelStoreServer`` over a ``NeurStore`` that takes an upload through
``StoreClient`` and serves it back at every width; one dry-run cell under
a fake process group of 256 ranks) and then checks
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

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.compression import cross_pod_sync, init_error_state
from repro_torch.launch import compressed_serve as cs
from repro_torch.launch.specs import input_specs
from repro_torch.models import SHAPES, init_cache

cs.MIN_QUANT_SIZE = 1024
qparams = cs.quantized_to_device(cs.quantize_params(params), "cpu")
assert "base" in qparams["embed"] and "raw" in qparams["final_norm"]
cache = init_cache(cfg, 2, 8, device="cpu")
tok, cache = cs.make_compressed_serve_step(cfg)(
    qparams, cache, {"tokens": torch.zeros((2, 1), dtype=torch.int64)}, 0)
assert tuple(tok.shape) == (2,)
specs = input_specs(get_config("arctic-480b"), SHAPES["decode_32k"])
assert specs["params"]["embed"].device.type == "meta"
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    grads = {"w": torch.linspace(-1, 1, 16).reshape(4, 4)}
    synced, errs = cross_pod_sync(grads, init_error_state(grads), mesh)
    assert torch.allclose(synced["w"], grads["w"], atol=1 / 254)
finally:
    dist.destroy_process_group()

from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import restore_sharded
from repro_torch.optim import adamw_init

dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with sh.use_mesh(mesh) as ctx:
        p_spec = shd.param_specs_tree(params, ctx)
        o_spec = shd.opt_specs_tree(None, p_spec)
        b = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg.vocab_size).batch(0, 2, 32).items()}
        step = shd.sharded(make_train_step(cfg, 1),
                           (p_spec, o_spec, shd.per_batch(shd.batch_specs_tree(b, ctx))),
                           (p_spec, o_spec, None), ctx)
        _, _, m = step(shd.place(params, p_spec, mesh),
                       shd.place(adamw_init(params), o_spec, mesh), b)
        assert bool(torch.isfinite(m["loss"]))
        with tempfile.TemporaryDirectory() as root:
            mgr = CheckpointManager(root, device="cpu")
            mgr.save(1, params)
            step_no, placed = restore_sharded(mgr, mesh, ctx)
            assert step_no == 1 and placed["embed"].full_tensor().shape == params["embed"].shape
            mgr.close()
finally:
    dist.destroy_process_group()

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

from repro_torch.launch import dryrun

rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", False, verbose=False)
assert rec["n_devices"] == 256 and rec["per_device"]["hlo_flops"] > 0, rec

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
