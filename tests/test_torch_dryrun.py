"""The dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

The reference's own dry run (``tests/test_dryrun_integration.py``) is
skipped here, because its subprocess hangs where libtpu is importable with
no TPU. The port's runs the reference test's cell, internlm2-1.8b ×
``decode_32k``, on the ``meta`` device under a fake process group of 256
ranks (and of 512 for the multi-pod mesh), in a subprocess because the
fake group takes the process's default group. Its record has the
reference's keys, and its per-device argument bytes equal the shard bytes
that the reference's own spec trees give for the same cell; so do the
compressed decode cell's (``--compressed``, on the tp route) against the
reference's storage-format spec trees.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
from jax.sharding import PartitionSpec as JP

import repro.distributed.sharding as RS
import repro.launch.compressed_serve as r_cs
import repro.launch.shardings as RSH
import repro.launch.specs as r_specs
from repro.configs import get_config as r_get_config
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import SHAPES

REPO = Path(__file__).resolve().parents[1]

# repro/launch/dryrun.py analyse() and run_cell(): the record's keys, and
# the port's route over ``model`` (launch.shardings.compute_route).
RECORD_KEYS = {"arch", "shape", "n_devices", "per_device", "collectives", "probe",
               "roofline_s", "bottleneck", "model_flops", "useful_flops_ratio",
               "roofline_fraction", "ideal_memory_s", "bandwidth_fraction", "compile_s",
               "multi_pod", "route"}
PER_DEVICE_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_hbm_bytes",
                   "hlo_flops", "hlo_bytes", "collective_bytes"}
COLLECTIVE_KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute"}


class StandIn:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _reference_params(cfg, ctx, compressed: bool) -> tuple:
    """The reference's parameter stand-ins of a decode cell and their spec
    tree: the storage-format tree (``compressed_param_specs``) where
    ``compressed``. The reference leaves a bfloat16 leaf raw (ROADMAP queue
    C), so its tree is taken of the float32 twin, each raw leaf of which is
    the config's own leaf (the port quantizes the bfloat16 leaves to the
    same storage format)."""
    params = r_specs.model_specs(cfg)
    if not compressed:
        return params, RSH.param_specs_tree(params, ctx)
    is_q = lambda x: isinstance(x, dict) and ("raw" in x or "base" in x)  # noqa: E731
    twin = r_cs.compressed_param_specs(dataclasses.replace(cfg, param_dtype="float32"))
    tree = jax.tree.map(lambda q, leaf: {"raw": leaf} if "raw" in q else q, twin, params,
                        is_leaf=is_q)
    return tree, RSH.compressed_param_specs_tree(tree, ctx)


def _reference_shard_bytes(arch: str, shape_name: str, multi_pod: bool,
                           compressed: bool = False) -> int:
    """One device's bytes of params (their storage format where
    ``compressed``), cache and batch under the reference's spec trees for a
    decode cell (even shards: the trees fit the mesh; an entry past a
    leaf's dims, which the storage-format trees keep where its axes have
    one rank, splits nothing)."""
    shape = SHAPES[shape_name]
    cfg = r_get_config(arch)
    if multi_pod:
        mesh = StandIn((2, 16, 16), ("pod", "data", "model"))
        rules = RS._rules_multi_pod(False, True)
    else:
        mesh = StandIn((16, 16), ("data", "model"))
        rules = RS._rules_single_pod(False, True)
    ctx = RS.ShardingCtx(mesh, RS._serving_params(rules))
    trees = [_reference_params(cfg, ctx, compressed)]
    cache = r_specs.decode_cache_specs(cfg, shape)
    trees.append((cache, RSH.cache_specs_tree(cache, ctx, cfg.n_kv_heads)))
    batch = r_specs.batch_specs(cfg, shape)
    trees.append((batch, RSH.batch_specs_tree(batch, ctx)))
    total = 0
    for leaves, specs in trees:
        flat = jax.tree_util.tree_leaves(leaves)
        flat_specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
        assert len(flat) == len(flat_specs)
        for leaf, spec in zip(flat, flat_specs):
            dims = list(leaf.shape)
            for i, axis in enumerate(tuple(spec)):
                n = RSH._axis_size(mesh, axis)
                if i >= len(dims):
                    assert n == 1
                    continue
                assert dims[i] % n == 0
                dims[i] //= n
            total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


def test_dryrun_single_cell(tmp_path):
    """The reference's cell on both meshes, one subprocess: the reference's
    record keys, FLOPs, collective bytes and a bottleneck among the three;
    the argument bytes equal to the reference's spec trees' shard bytes on
    the single-pod mesh (on the multi-pod one the reference's table lost
    the pod axis under JAX 0.9, so the port's shards are half of them
    along the batch)."""
    out = tmp_path / "cell.json"
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
         "--shape", "decode_32k", "--both-meshes", "--out", str(out)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    single, multi = json.loads(out.read_text())
    for rec, n in ((single, 256), (multi, 512)):
        assert set(rec) == RECORD_KEYS
        assert set(rec["per_device"]) == PER_DEVICE_KEYS
        assert set(rec["collectives"]) >= COLLECTIVE_KINDS
        assert rec["n_devices"] == n
        assert rec["per_device"]["hlo_flops"] > 0
        assert rec["per_device"]["collective_bytes"] > 0
        assert rec["per_device"]["temp_bytes"] is None
        assert rec["per_device"]["peak_hbm_bytes"] is None
        assert set(rec["roofline_s"]) == {"compute", "memory", "collective"}
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert rec["model_flops"] == 2.0 * get_config("internlm2-1.8b").n_active_params * 128
        assert rec["route"] == "tp"  # a dense model split over ``model``
    assert not single["multi_pod"] and multi["multi_pod"]
    want = _reference_shard_bytes("internlm2-1.8b", "decode_32k", multi_pod=False)
    assert single["per_device"]["argument_bytes"] == want
    # The decode cell's output: every rank's int32 tokens and its cache shard.
    assert single["per_device"]["output_bytes"] > 4 * 128
    assert multi["per_device"]["argument_bytes"] < single["per_device"]["argument_bytes"]


def test_dryrun_skip_rules():
    assert not get_config("deepseek-67b").supports_shape("long_500k")
    assert not get_config("hubert-xlarge").supports_shape("decode_32k")
    assert get_config("rwkv6-7b").supports_shape("long_500k")
    assert get_config("recurrentgemma-9b").supports_shape("long_500k")
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", False, verbose=False)
    assert rec == {"arch": "hubert-xlarge", "shape": "decode_32k", "skipped": True,
                   "reason": "encoder-only: no decode step"}
    rec = dryrun.run_cell("qwen3-8b", "long_500k", True, verbose=False)
    assert rec["skipped"] and "sub-quadratic" in rec["reason"]


def test_model_flops_and_probe_shapes():
    """The reference's rules: a train probe runs one microbatch (256 rows
    in 8 microbatches of 32 for internlm2-1.8b) and scales by 8; a
    sub-quadratic model's 32k prefill runs at 4096 and scales by 8."""
    cfg = get_config("internlm2-1.8b")
    shape, scale = dryrun._probe_shape(SHAPES["train_4k"], cfg)
    assert (shape.global_batch, shape.seq_len, scale) == (32, 4096, 8.0)
    rg = get_config("recurrentgemma-9b")
    shape, scale = dryrun._probe_shape(SHAPES["prefill_32k"], rg)
    assert (shape.seq_len, scale) == (4096, 8.0)
    assert dryrun.model_flops(cfg, SHAPES["train_4k"]) == \
        6.0 * cfg.n_active_params * 256 * 4096


def test_microbatches_divide_every_ranks_rows():
    """The port splits the batch over the data-parallel ranks before it
    splits each rank's rows into microbatches: deepseek-67b's 16
    microbatches of 256 rows fit 16 ranks (16 rows each) but not the
    multi-pod mesh's 32 (8 rows each), where it takes 8."""
    single = StandIn((16, 16), ("data", "model"))
    multi = StandIn((2, 16, 16), ("pod", "data", "model"))
    cfg, shape = get_config("deepseek-67b"), SHAPES["train_4k"]
    assert dryrun._microbatches(cfg, shape, single, "tp") == 16
    assert dryrun._microbatches(cfg, shape, multi, "tp") == 8
    assert dryrun._microbatches(cfg, shape, multi, "dp") == 1
    assert dryrun._microbatches(get_config("internlm2-1.8b"), shape, multi, "tp") == 8


# The dry run of internlm2-1.8b × decode_32k --compressed before the
# compressed step took the tp route (the gathered route: every rank
# gathering every quantized weight whole, rebuilding the whole model and
# running it on its rows): its useful-FLOP ratio.
GATHERED_COMPRESSED_DECODE_RATIO = 0.024


def test_dryrun_compressed_decode_cell_on_the_tp_route(tmp_path):
    """internlm2-1.8b × decode_32k on the storage format (``--compressed``):
    the ``"tp"`` route, per-device argument bytes equal to the shard bytes
    of the reference's storage-format spec trees (its
    ``compressed_param_specs_tree``), and at least 4x the gathered route's
    useful-FLOP ratio."""
    out = tmp_path / "cell.json"
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
         "--shape", "decode_32k", "--compressed", "--out", str(out)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (rec,) = json.loads(out.read_text())
    assert rec["route"] == "tp"
    assert rec["per_device"]["argument_bytes"] == _reference_shard_bytes(
        "internlm2-1.8b", "decode_32k", multi_pod=False, compressed=True)
    assert rec["useful_flops_ratio"] >= 4 * GATHERED_COMPRESSED_DECODE_RATIO
