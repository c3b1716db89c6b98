"""Multi-pod dry run: place and step every (arch × shape × mesh) cell on
the ``meta`` device under a fake process group of 256 or 512 ranks.

The port of the reference's ``repro/launch/dryrun.py``. The reference
compiles each cell for 512 host devices and reads XLA's cost and memory
analyses; the port has no compiler, so it runs the sharded step itself as
rank 0 of a fake process group (``torch.testing``'s ``FakeStore``, whose
collectives return at once) on tensors that have a shape and a dtype and
no storage. Nothing runs on a card.

Per cell it reports the reference's record keys:

* ``per_device.argument_bytes``: the exact sum of this rank's shards of
  params, optimizer state, batch and cache (``output_bytes`` likewise of
  the outputs). ``temp_bytes`` and ``peak_hbm_bytes`` have no meta-device
  counterpart (nothing allocates) and are null.
* ``hlo_flops``: ``hlo_stats.LocalFlopCounter`` (each rank's local ops)
  over the step on 1- and 2-period probes, extrapolated to the full depth
  as the reference's ``probe_costs`` does; ``hlo_bytes``: the bytes the
  step's non-view ops read and write on this rank (eager PyTorch fuses
  nothing); collective bytes from the step's recorded collectives
  (``hlo_stats``), the redistributions inside a tensor-parallel step's
  ops included.
* ``compile_s``: the seconds to place the full-depth cell's arguments on
  the fake mesh (there is no compile).
* the three roofline terms over one H100's rates (``launch/mesh.py``) and
  the dominant bottleneck. These are estimates from published rates, never
  times: nothing here is measured on a card. The attention on ``meta`` is
  the plain chunked scan: its FLOPs count every KV chunk, masked or not,
  as the reference's count of its chunked scan does, and its bytes count
  the score chunks, which the card's forward kernel keeps on chip (its
  backward, plain PyTorch, does write them), so ``hlo_bytes`` overstates a
  card's forward.

Each cell names its route over ``model`` (``launch.shardings.compute_route``,
the record's ``route``). Under ``--profile tp`` a dense model's step is
split over ``model`` (``"tp"``): each rank keeps its shards of the
weights, computes its heads, FFN columns and vocabulary columns, and the
collectives are the residual's gathers and reductions and the FSDP
gathers over ``data``; so is a recurrent model's (recurrentgemma,
rwkv6): each rank scans its own RG-LRU channels and runs its own RWKV-6
heads. The MoE models, the compressed
serving step and ``--profile dp`` take the gathered route: each rank
gathers every weight whole and runs the whole model on its rows, so the
ranks of a ``model`` group repeat each other's compute, which
``useful_flops_ratio`` shows. On the CPU's process groups DTensor moves a
shard to another dim by an all-gather and a slice (no all-to-all), and
the fake group is one of them: such a move is counted as an all-gather.

The fake group takes the process's default group, so run this as its own
process:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..configs import get_config, list_archs
from ..distributed import sharding as sh
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from . import shardings as shd
from .hlo_stats import LocalFlopCounter, StepRecorder, collective_stats
from .mesh import BF16_PEAK_FLOPS, HBM_BW, NVLINK_BW, make_production_mesh
from .specs import batch_specs, decode_cache_specs, model_specs, opt_specs
from .steps import make_prefill_step, make_serve_step, make_train_step, pick_microbatches

__all__ = ["analyse", "lower_cell", "model_flops", "probe_costs", "run_cell"]


def fake_process_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0 (replacing a fake group of another size)."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as exc:
        raise RuntimeError(
            "the dry run needs a fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), which this "
            f"torch {torch.__version__} does not have") from exc
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _probe_cfg(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    n_layers = n_periods * len(cfg.period) + len(cfg.tail)
    return dataclasses.replace(cfg, n_layers=n_layers,
                               unroll_periods=True, scan_unroll=True)


# Sub-quadratic archs (rwkv6/recurrentgemma) are linear-in-S per layer
# (windowed attention, chunked linear recurrence), so long-sequence probes
# run at this length and scale linearly (the RG-LRU doubling scan's log
# factor adds at most 3 levels at 32k, as in the reference).
_SUBQUAD_PROBE_SEQ = 4096


def _probe_shape(shape: ShapeConfig, cfg: ModelConfig,
                 n_micro: int | None = None) -> tuple[ShapeConfig, float]:
    """Probe shape + linear scale factor back to the true shape.

    Train probes run ONE microbatch so the body is seen exactly once; step
    total = n_micro × probe (+ O(N) optimizer update). Sub-quadratic archs
    probe long sequences at _SUBQUAD_PROBE_SEQ and scale by S/S_probe."""
    scale = 1.0
    s = shape.seq_len
    b = shape.global_batch
    if shape.is_train and n_micro is None:
        n_micro = pick_microbatches(cfg, shape.global_batch)
    if shape.is_train:
        b = shape.global_batch // n_micro
        scale *= n_micro
    if cfg.subquadratic and shape.kind != "decode" and s > _SUBQUAD_PROBE_SEQ:
        scale *= s / _SUBQUAD_PROBE_SEQ
        s = _SUBQUAD_PROBE_SEQ
    return dataclasses.replace(shape, seq_len=s, global_batch=b), scale


def _microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh, profile: str) -> int:
    """The microbatch count of a train cell. The port's sharded step splits
    the batch over the data-parallel ranks first and each rank splits its
    rows into microbatches, so the count must divide every rank's rows:
    ``pick_microbatches``'s, halved until it does (the reference slices the
    global batch first and would replicate a microbatch that does not
    divide over the ranks). The ``"dp"`` profile takes one, as the
    reference's does."""
    if profile == "dp":
        return 1
    with sh.use_mesh(mesh, multi_pod="pod" in sh.mesh_axis_sizes(mesh), profile=profile) as ctx:
        rows = shd.fit_spec("tokens", ctx.spec("tokens"), (shape.global_batch, shape.seq_len),
                            mesh)[0]
        n_dp = shd._axis_size(mesh, rows)
    n_micro = pick_microbatches(cfg, shape.global_batch)
    while n_micro > 1 and (shape.global_batch // n_micro) % n_dp:
        n_micro //= 2
    return n_micro


@dataclasses.dataclass
class Cell:
    """One cell placed on the mesh: the sharded step and its arguments."""

    step: object
    args: tuple
    route: str  # over ``model``: "tp" or "gathered" (shardings.compute_route)
    arg_bytes: int  # this rank's shards of the tensor arguments
    out_bytes: int  # and of the outputs, as the output specs place them


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, multi_pod: bool,
               force_single_micro: bool = False, profile: str = "tp",
               compressed: bool = False, n_micro: int | None = None) -> Cell:
    """Specs + placed stand-ins + the sharded step of one cell (a train
    cell's microbatches: ``n_micro``, else one with ``force_single_micro``,
    else :func:`_microbatches`)."""
    seq_shard = shape.kind != "decode"
    with sh.use_mesh(mesh, multi_pod=multi_pod, seq_shard=seq_shard,
                     serve=not shape.is_train, profile=profile) as ctx:
        p_specs = model_specs(cfg)
        p_spec = shd.param_specs_tree(p_specs, ctx)
        b_specs = batch_specs(cfg, shape)
        b_spec = shd.batch_specs_tree(b_specs, ctx)
        batch = shd.per_batch(b_spec)
        if shape.is_train:
            big = cfg.n_params > 100e9
            moment_dtype = torch.bfloat16 if big else torch.float32
            grad_dtype = torch.bfloat16 if big else torch.float32
            o_specs = opt_specs(cfg, moment_dtype)
            o_spec = shd.opt_specs_tree(o_specs, p_spec)
            if n_micro is None:
                n_micro = 1 if force_single_micro else _microbatches(cfg, shape, mesh, profile)
            step = shd.sharded(make_train_step(cfg, n_micro, grad_dtype=grad_dtype),
                               (p_spec, o_spec, batch), (p_spec, o_spec, None), ctx, cfg=cfg)
            args = (shd.place(p_specs, p_spec, mesh), shd.place(o_specs, o_spec, mesh),
                    shd.place(b_specs, b_spec, mesh))
            # params and moments back in place, and the float32 loss
            out_bytes = shd.local_bytes(list(args[:2])) + 4
        elif shape.kind == "prefill":
            logits = shd.fit_spec("tokens", ctx.spec("tokens"),
                                  (shape.global_batch, cfg.vocab_size), mesh)
            step = shd.sharded(make_prefill_step(cfg), (p_spec, batch),
                               (shd.per_batch(logits),), ctx, cfg=cfg)
            args = (shd.place(p_specs, p_spec, mesh), shd.place(b_specs, b_spec, mesh))
            out_bytes = shd.local_bytes(shd.place(
                _meta((shape.global_batch, cfg.vocab_size), torch.float32), logits, mesh))
        else:  # decode
            c_specs = decode_cache_specs(cfg, shape)
            c_spec = shd.cache_specs_tree(c_specs, ctx, cfg.n_kv_heads)
            if compressed:
                # NeurStore storage format as the runtime weight format.
                from .compressed_serve import (
                    compressed_param_specs,
                    make_compressed_serve_step,
                )
                p_specs = compressed_param_specs(cfg)
                p_spec = shd.compressed_param_specs_tree(p_specs, ctx)
                serve = make_compressed_serve_step(cfg)
            else:
                serve = make_serve_step(cfg)
            # The compressed parameters keep the gathered route.
            step = shd.sharded(serve, (p_spec, shd.per_batch(c_spec), batch, None),
                               (shd.per_batch(None), shd.per_batch(c_spec)), ctx,
                               cfg=None if compressed else cfg)
            args = (shd.place(p_specs, p_spec, mesh), shd.place(c_specs, c_spec, mesh),
                    shd.place(b_specs, b_spec, mesh), 0)
            # every rank's int32 tokens, and the cache back in place
            out_bytes = 4 * shape.global_batch + shd.local_bytes(args[1])
        return Cell(step, args, step.route, shd.local_bytes(list(args[:3])), out_bytes)


def _run_costs(cell: Cell, n_devices: int) -> dict:
    rec = StepRecorder()
    with LocalFlopCounter(display=False) as flops, rec:
        cell.step(*cell.args)
    colls = collective_stats(rec.collectives, n_devices)
    return {"flops": float(flops.get_total_flops()), "bytes": float(rec.bytes_accessed),
            "collective_bytes": colls["total_bytes"], "collective_kinds": colls}


def probe_costs(cfg: ModelConfig, shape: ShapeConfig, mesh, multi_pod: bool,
                n_devices: int, profile: str = "tp",
                compressed: bool = False) -> dict:
    """Cost extraction on 1- and 2-period probes, extrapolated:
    cost(P) = cost(1) + (P-1)·[cost(2) - cost(1)], the FLOPs and bytes
    scaled back for microbatching / probe sequence length (the reference's
    rule; exact where every period costs the same, as eager execution
    counts each). The collectives are not scaled on the gathered route:
    it gathers the state and reduces the gradients once a step, whatever
    its microbatches and sequence length. A train cell on the ``"tp"``
    route also moves activations each microbatch: its probes run at one
    and two microbatches, and the collectives are those of one plus
    (n_micro - 1) times the difference. A prefill cell on the ``"tp"``
    route moves only activations (the serving table keeps no weight split
    over ``data``): its collectives scale with a sub-quadratic probe's
    sequence as its FLOPs do."""
    n_micro = _microbatches(cfg, shape, mesh, profile) if shape.is_train else None
    pshape, scale = _probe_shape(shape, cfg, n_micro=n_micro)

    def one(n_periods, micro=1):
        probe = dataclasses.replace(pshape, global_batch=pshape.global_batch * micro)
        cell = lower_cell(_probe_cfg(cfg, n_periods), probe, mesh, multi_pod, profile=profile,
                          compressed=compressed, n_micro=micro)
        costs = _run_costs(cell, n_devices)
        costs["route"] = cell.route
        return costs

    p = cfg.n_periods
    c1 = one(1)
    c2 = one(2) if p > 1 else c1
    colls = [c1["collective_kinds"], c2["collective_kinds"]]
    if shape.is_train and n_micro > 1 and c1["route"] == "tp":
        d1 = one(1, 2)["collective_kinds"]
        d2 = one(2, 2)["collective_kinds"] if p > 1 else d1
        colls = [{k: c[k] + (n_micro - 1) * max(d[k] - c[k], 0.0) for k in _KINDS}
                 for c, d in ((colls[0], d1), (colls[1], d2))]

    def ext(a, b, scale=scale):
        return (a + (p - 1) * max(b - a, 0.0)) * scale

    seq_scale = scale if c1["route"] == "tp" and not shape.is_train else 1.0
    kinds = {k: ext(colls[0][k], colls[1][k], seq_scale) for k in _KINDS}
    return {
        "flops": ext(c1["flops"], c2["flops"]),
        "bytes": ext(c1["bytes"], c2["bytes"]),
        "collective_bytes": sum(kinds.values()),
        "collective_kinds": kinds,
        "probe": {"flops_1p": c1["flops"], "flops_2p": c2["flops"], "scale": scale,
                  "probe_seq": pshape.seq_len, "n_micro": n_micro},
    }


_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) / 2·N·D (fwd) with N = active params, D = tokens."""
    n = cfg.n_active_params
    if shape.is_train:
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def analyse(arg_bytes: int, out_bytes: int, costs: dict, cfg: ModelConfig,
            shape: ShapeConfig, n_devices: int) -> dict:
    flops_dev = costs["flops"]
    bytes_dev = costs["bytes"]
    coll_dev = costs["collective_bytes"]
    terms = {"compute": flops_dev / BF16_PEAK_FLOPS, "memory": bytes_dev / HBM_BW,
             "collective": coll_dev / NVLINK_BW}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_total = flops_dev * n_devices
    worst = max(terms.values())
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "n_devices": n_devices,
        "per_device": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "peak_hbm_bytes": None,
            "hlo_flops": flops_dev,
            "hlo_bytes": bytes_dev,
            "collective_bytes": coll_dev,
        },
        "collectives": costs.get("collective_kinds", {}),
        "probe": costs.get("probe", {}),
        "roofline_s": terms,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "useful_flops_ratio": mf / hlo_flops_total if hlo_flops_total else 0.0,
        "roofline_fraction": (mf / n_devices / BF16_PEAK_FLOPS / worst if worst > 0 else 0.0),
        # Decode cells are weight/cache-bandwidth bound: the ideal step is
        # one pass over the per-device arguments (params + cache).
        "ideal_memory_s": arg_bytes / HBM_BW,
        "bandwidth_fraction": (arg_bytes / HBM_BW / worst if worst > 0 else 0.0),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             probes: bool = True, profile: str = "tp", compressed: bool = False):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not cfg.supports_shape(shape_name):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": ("encoder-only: no decode step"
                           if not cfg.has_decode
                           else "full attention: long_500k needs sub-quadratic")}
    n_dev = 512 if multi_pod else 256
    fake_process_group(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    # Full depth: proves the specs place on the mesh and gives the exact
    # per-device argument bytes.
    cell = lower_cell(cfg, shape, mesh, multi_pod, profile=profile, compressed=compressed)
    dt = time.time() - t0
    if probes:
        costs = probe_costs(cfg, shape, mesh, multi_pod, n_dev, profile, compressed)
    else:
        costs = _run_costs(cell, n_dev)
    rec = analyse(cell.arg_bytes, cell.out_bytes, costs, cfg, shape, n_dev)
    rec["route"] = cell.route
    rec["compile_s"] = round(dt, 1)
    rec["multi_pod"] = multi_pod
    if verbose:
        pd = rec["per_device"]
        print(f"== {arch} × {shape_name} ({'multi' if multi_pod else 'single'}-pod, "
              f"{n_dev} ranks, profile {profile}, route {cell.route}) placed in {dt:.1f}s")
        print(f"   per-device arguments: {pd['argument_bytes'] / 2**30:.3f} GiB "
              f"(H100: 80 GB)")
        print(f"   per-step per-device: flops={pd['hlo_flops']:.3e} "
              f"bytes={pd['hlo_bytes']:.3e} collective={pd['collective_bytes']:.3e}")
        print(f"   collective MB: "
              f"{ {k: round(v / 1e6, 1) for k, v in rec['collectives'].items() if v} }")
        print(f"   roofline terms (s, estimates from one H100's published rates): "
              f"compute={rec['roofline_s']['compute']:.4f} "
              f"memory={rec['roofline_s']['memory']:.4f} "
              f"collective={rec['roofline_s']['collective']:.4f} "
              f"→ {rec['bottleneck']}-bound; "
              f"useful-FLOP ratio {rec['useful_flops_ratio']:.3f}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--profile", default="tp", choices=["tp", "dp"])
    ap.add_argument("--compressed-serve", "--compressed", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape, mp, profile=args.profile,
                                            compressed=args.compressed_serve))
                except Exception as e:  # a failure here is a bug in the system
                    results.append({"arch": arch, "shape": shape,
                                    "multi_pod": mp, "error": repr(e)[:500]})
                    print(f"!! {arch} × {shape} (multi_pod={mp}) FAILED: {e!r}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_err = sum(1 for r in results if "error" in r)
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"\n{len(results)} cells: {len(results) - n_err - n_skip} ok, "
          f"{n_skip} skipped (documented), {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
