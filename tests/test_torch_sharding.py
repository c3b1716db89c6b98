"""The logical-axis rules, the sharding context, DTensor placements and the
collective statistics against the reference's, on the CPU.

``distributed/sharding.py``'s rule tables are held against the
reference's entry by entry (JAX's ``PartitionSpec`` equality, which the
port's ``P`` keeps), with one difference pinned: under JAX 0.9 the
reference's multi-pod tables lose the pod axis from data parallelism,
and the port's keep it. ``launch/hlo_stats.py``'s HLO parser is held to
the reference's on the reference's test text, and its records of real
gloo collectives (two spawned ranks) to the ring byte rules. The
reference's ``tests/test_distributed.py`` mesh cases that need no step
run here on the port.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import repro.distributed.sharding as RS
import repro.launch.hlo_stats as RH
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import hlo_stats
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh
from repro_torch.models import init_params

# Two spawned ranks each import torch and the port; a hung rendezvous or
# collective fails the test after this many seconds.
JOIN_TIMEOUT_S = 120


class StandIn:
    """The reference's stand-in mesh (``tests/test_distributed.py``): axis
    names and a device-array shape, no ranks."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


SINGLE = StandIn((16, 16), ("data", "model"))
MULTI = StandIn((2, 16, 16), ("pod", "data", "model"))


@pytest.fixture
def host_mesh():
    """A world-size-1 gloo process group and its (1, 1) ("data", "model") mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _r_rules(multi_pod, seq_shard, serve, profile):
    """The reference's ``use_mesh`` table selection, without its mesh."""
    if profile == "dp":
        return RS._rules_dp(n_axes=3 if multi_pod else 2)
    rules = (RS._rules_multi_pod(seq_shard, serve) if multi_pod
             else RS._rules_single_pod(seq_shard, serve))
    return RS._serving_params(rules) if serve else rules


def _dp_to_pod(spec: P) -> P:
    """The single-pod table's data-parallel entries over ("pod", "data")."""
    return P(*[("pod", "data") if e == ("data",) else e for e in spec])


# ------------------------------------------------------------------ rules
TP_CASES = [(mp_, seq, serve) for mp_ in (False, True) for seq in (False, True)
            for serve in (False, True)]


@pytest.mark.parametrize("multi_pod,seq_shard,serve", TP_CASES)
def test_tp_rules_match_the_reference(multi_pod, seq_shard, serve):
    """Every logical name of the ``"tp"`` table under ``use_mesh``: single
    pod equal to the reference's entry by entry; multi-pod the single-pod
    table with its data-parallel entries over ("pod", "data"), which is
    the reference's except where JAX 0.9 dropped the pod (below)."""
    mesh = MULTI if multi_pod else SINGLE
    with sh.use_mesh(mesh, multi_pod=multi_pod, seq_shard=seq_shard, serve=serve) as ctx:
        got = ctx.rules
    want = _r_rules(multi_pod, seq_shard, serve, "tp")
    assert sorted(got) == sorted(want)
    if not multi_pod:
        for name in want:
            assert got[name] == tuple(want[name]), name
        return
    single = sh._rules_single_pod(seq_shard, serve)
    single = sh._serving_params(single) if serve else single
    assert got == {k: _dp_to_pod(s) for k, s in single.items()}
    for name in want:
        pod_free = P(*["data" if e == ("pod", "data") else e for e in got[name]])
        assert pod_free == tuple(want[name]), name


def test_multi_pod_rules_keep_the_pod_axis_unlike_the_reference():
    """The reference's ``_rules_multi_pod`` looks for ``("data",)``, which a
    JAX 0.9 PartitionSpec stores as ``"data"``: its batch is split over
    ``data`` alone, so the two pods compute the same rows. The port's
    splits it over both."""
    got = sh._rules_multi_pod(True)
    want = RS._rules_multi_pod(True)
    assert tuple(want["tokens"]) == ("data", None)
    assert got["tokens"] == P(("pod", "data"), None)
    changed = sorted(k for k in got if got[k] != tuple(want[k]))
    assert changed == sorted(k for k, s in sh._rules_single_pod(True).items()
                             if ("data",) in tuple(s))
    assert "p_embed" not in changed and "p_expert_in" in changed


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dp_rules_match_the_reference(multi_pod):
    mesh = MULTI if multi_pod else SINGLE
    with sh.use_mesh(mesh, multi_pod=multi_pod, profile="dp") as ctx:
        got = ctx.rules
    want = _r_rules(multi_pod, True, False, "dp")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == tuple(want[name]), name


def test_spec_equality_is_jax_partition_specs():
    assert P(("data",), None) == P("data", None) == tuple(JP(("data",), None))
    assert P((), "model") == P(None, "model")
    assert P("data", None) != P("data")
    assert P(("pod", "data"),) == tuple(JP(("pod", "data"),))
    assert hash(P(("data",))) == hash(P("data"))
    assert {P(("data",)): 1}[P("data")] == 1


@pytest.mark.parametrize("kv_heads,want", [(16, "cache_bh"), (32, "cache_bh"),
                                           (8, "cache_bs"), (2, "cache_bs"), (1, "cache_bs")])
def test_cache_logical_matches_the_reference(kv_heads, want):
    assert sh.cache_logical(kv_heads) == "cache_bh"  # no context
    with sh.use_mesh(SINGLE):
        got = sh.cache_logical(kv_heads)
    prev = getattr(RS._state, "ctx", None)
    RS._state.ctx = RS.ShardingCtx(SINGLE, _r_rules(False, True, False, "tp"))
    try:
        assert RS.cache_logical(kv_heads) == got == want
    finally:
        RS._state.ctx = prev


def test_spec_and_constrain_without_a_context():
    x = torch.arange(6.0).reshape(2, 3)
    assert sh.current() is None
    assert sh.spec("residual") == P() == tuple(RS.spec("residual"))
    assert sh.constrain(x, "residual") is x
    with sh.use_mesh(SINGLE) as ctx:
        assert sh.current() is ctx
        assert sh.spec("tokens") == tuple(RS._rules_single_pod(True)["tokens"])
        assert sh.constrain(x, "residual") is x  # a plain tensor stays as it is
    assert sh.current() is None


def test_constrain_redistributes_a_dtensor(host_mesh):
    x = torch.arange(24.0).reshape(2, 3, 4)
    with sh.use_mesh(host_mesh) as ctx:
        d = distribute_tensor(x, host_mesh, [Replicate(), Replicate()])
        got = sh.constrain(d, "residual")
        assert tuple(got.placements) == (Shard(0), Shard(1))
        assert tuple(got.placements) == sh.placements(ctx.spec("residual"), host_mesh)
        assert torch.equal(got.full_tensor(), x)


def test_data_parallel_reduction_is_the_identity_outside_a_sharded_step():
    tree = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    assert sh.data_parallel_size() == 1
    assert sh.data_parallel_sum(tree) is tree


# -------------------------------------------------------------- placements
@pytest.mark.parametrize("spec,want", [
    (P(("data",), None), (Shard(0), Replicate())),
    (P(None, "model"), (Replicate(), Shard(1))),
    (P("model", "data"), (Shard(1), Shard(0))),
    (P(("data", "model"), None), (Shard(0), Shard(0))),
    (P(), (Replicate(), Replicate())),
    (P(None, None, "model"), (Replicate(), Shard(2))),
])
def test_placements_of_a_spec(host_mesh, spec, want):
    assert sh.placements(spec, host_mesh) == want


@pytest.mark.parametrize("spec,match", [
    (P(("model", "data"),), "mesh's order"),
    (P("pod"), "no axis"),
    (P("data", "data"), "shards two dims"),
])
def test_placements_refuse_what_dtensor_cannot_place(host_mesh, spec, match):
    with pytest.raises(ValueError, match=match):
        sh.placements(spec, host_mesh)


def test_mesh_builders_need_a_card_unless_asked_for_the_cpu(host_mesh):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_mesh((1, 1), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and host_mesh.shape == (1, 1)
    with pytest.raises(ValueError, match="model-parallel groups of 2"):
        make_host_mesh(2, device="cpu")
    with pytest.raises(RuntimeError):  # 256 ranks on a world of 1
        make_production_mesh(device="cpu")


# ------------------------------- the reference's tests/test_distributed.py
def test_param_specs_cover_every_leaf(host_mesh):
    """Every arch's every param leaf gets a valid spec (no fallthroughs that
    shard a mismatched rank)."""
    for arch in ("qwen3-8b", "rwkv6-7b", "recurrentgemma-9b", "arctic-480b"):
        cfg = get_config(arch, smoke=True)
        params = init_params(cfg, 0, device="cpu")
        with sh.use_mesh(host_mesh) as ctx:
            specs = shd.param_specs_tree(params, ctx)
        leaves = jax.tree_util.tree_leaves_with_path(params)
        spec_leaves = jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, P))
        assert [p for p, _ in leaves] == [p for p, _ in spec_leaves]
        for (path, leaf), (_, spec) in zip(leaves, spec_leaves):
            assert len(tuple(spec)) <= leaf.ndim, (path, spec, leaf.shape)
            sh.placements(spec, host_mesh)


def test_fit_spec_divisibility():
    """fit_spec drops/replaces axes whose size doesn't divide the dim."""
    from repro_torch.launch.shardings import _fits

    class FakeMesh:
        axis_names = ("data", "model")

        class devices:
            shape = (16, 16)

    assert _fits(P("data", "model"), (32, 32), FakeMesh)
    assert not _fits(P("data", "model"), (32, 8), FakeMesh)
    assert not _fits(P(("data", "model"),), (64,), FakeMesh)
    assert _fits(P(("data", "model"),), (256,), FakeMesh)
    assert shd.fit_spec("p_attn_qkv", P("data", "model", None), (2048, 8, 128), FakeMesh) \
        == P("data", None, "model")
    assert shd.fit_spec("p_vec", P("model"), (40,), FakeMesh) == P(None)


HLO = """
  %ag = bf16[16,256]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = (f32[128]{0}, f32[64]{0}) all-reduce(%a, %b), replica_groups=[2,8]<=[16], to_apply=%sum
  %rs = f32[4,32]{1,0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %done = bf16[16,256]{1,0} all-gather-done(%ag)
"""


def test_collective_stats_parser():
    stats = hlo_stats.collective_stats_from_hlo(HLO, 16)
    assert stats["count"] == 4
    ag = 16 * 256 * 2 * 3 / 4
    ar = 2 * (128 * 4 + 64 * 4) * 7 / 8
    rs = 4 * 32 * 4 * 1
    cp = 8 * 8 * 2
    np.testing.assert_allclose(stats["all-gather"], ag)
    np.testing.assert_allclose(stats["all-reduce"], ar)
    np.testing.assert_allclose(stats["reduce-scatter"], rs)
    np.testing.assert_allclose(stats["collective-permute"], cp)
    assert stats == RH.collective_stats(HLO, 16)


def test_collective_stats_of_records_match_the_parser():
    records = [("all-gather", 16 * 256 * 2, 4), ("all-reduce", (128 + 64) * 4, 8),
               ("reduce-scatter", 4 * 32 * 4, 2), ("collective-permute", 8 * 8 * 2, None)]
    assert hlo_stats.collective_stats(records, 16) == RH.collective_stats(HLO, 16)


# ------------------------------------------- recorded gloo collectives
def _collective_worker(rank: int, store_path: str, out_dir: str) -> None:
    ops = torch.ops._c10d_functional

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2)
    try:
        mesh = make_mesh((2,), ("data",), device="cpu")
        group = mesh.get_group("data")
        x = torch.arange(12, dtype=torch.float32).reshape(4, 3) + rank
        rec = hlo_stats.StepRecorder()
        with rec:
            name = group.group_name
            gathered = ops.wait_tensor(ops.all_gather_into_tensor(x, 2, name))
            scattered = ops.wait_tensor(ops.reduce_scatter_tensor(x, "sum", 2, name))
            reduced = ops.wait_tensor(ops.all_reduce(x, "sum", name))
            # and through DTensor, as the sharded steps issue them
            d = distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None).full_tensor()
            both = torch.mm(x, x.T)
        want_gather = torch.cat([x - rank, x - rank + 1])
        ok = (torch.equal(gathered, want_gather) and torch.equal(reduced, 2 * x - 2 * rank + 1)
              and torch.equal(scattered, (2 * x - 2 * rank + 1)[2 * rank:2 * rank + 2])
              and torch.equal(d, torch.cat([(x - rank)[:2], (x - rank + 1)[2:]])))
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump({"ok": ok, "records": rec.collectives, "ops": dict(rec.ops),
                       "bytes": rec.bytes_accessed, "mm": list(both.shape)}, f)
    finally:
        dist.destroy_process_group()


def _spawn(target, n: int, *args) -> None:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, *args)) for rank in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"workers {alive} still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * n


def test_recorded_gloo_collectives_give_the_ring_byte_rules(tmp_path):
    """Two ranks over gloo: an all-gather (4, 3) → (8, 3), a reduce-scatter
    (4, 3) → (2, 3), an all-reduce (4, 3) and DTensor's gather of a
    (2, 3) shard, each recorded as (kind, result bytes, group size 2)."""
    _spawn(_collective_worker, 2, str(tmp_path / "store"), str(tmp_path))
    for rank in range(2):
        got = json.loads((tmp_path / f"r{rank}.json").read_text())
        assert got["ok"]
        assert [tuple(r) for r in got["records"]] == [
            ("all-gather", 96.0, 2), ("reduce-scatter", 24.0, 2), ("all-reduce", 48.0, 2),
            ("all-gather", 48.0, 2)]
        stats = hlo_stats.collective_stats(got["records"], 2)
        assert stats["all-gather"] == 96 / 2 + 48 / 2
        assert stats["reduce-scatter"] == 24 * 1
        assert stats["all-reduce"] == 2 * 48 / 2
        assert stats["count"] == 4 and stats["total_bytes"] == 48 + 24 + 24 + 48
        assert got["ops"]["aten.mm"] == 1
        assert got["bytes"] >= 3 * 48  # the mm's two operands and its (4, 4) result
        assert hlo_stats.hlo_op_histogram(got["ops"], top=1)[0][1] >= 1
