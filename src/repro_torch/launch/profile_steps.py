"""Where the time of a prefill, a serve step or a train step goes: a trace.

    PYTHONPATH=src python -m repro_torch.launch.profile_steps [--trace PATH.json.gz]
    PYTHONPATH=src python -m repro_torch.launch.profile_steps --train
    PYTHONPATH=src python -m repro_torch.launch.profile_steps --window-probe 60
    PYTHONPATH=src python -m repro_torch.launch.profile_steps --arch recurrentgemma-9b

Builds internlm2-1.8b as published (24 layers, bfloat16, random weights
from a seed), the model of ``chip_smoke.py``'s phase 6, then runs one
``make_prefill_step`` on 4 x 2048 prompts and 16 ``make_serve_step`` tokens
at batch 4 after a teacher-forced 8-token prompt. Each window is timed
first plainly (wall clock around a synchronized run), then under
``torch.profiler`` with CPU and CUDA activities. From the trace it reports,
per window: the device's busy time (the union of its kernel intervals), its
busy share of the plain and of the profiled wall time, the kernels and the
top-level host ops issued, the median gap between one kernel's end and the
next one's start, and the kernels that take the most device time. The last
line of the output is one JSON object with those numbers.

``--arch`` builds another architecture of ``configs.list_archs()`` as
published instead (its SMOKE size with ``--smoke``). The prefill window
also splits the device's busy time into the attention kernels
(``flash_attn``), the matrix products (cuBLAS's and CUTLASS's GEMM
kernels) and the recurrent blocks' scans (the kernels launched inside the
``rglru_scan`` and ``rwkv6_chunks`` ranges of ``models/recurrent.py``),
the rest being elementwise work, norms and the MoE's routing
(:func:`trace_prefill`, which ``chip_smoke.py`` also calls).

``--train`` traces one ``make_train_step`` of the same model instead (4 x
2048 ``SyntheticLM`` tokens, one microbatch, remat as the config has it,
AdamW): the device's busy share, kernels a step and the top kernels, with
the ``flash_attn`` kernels' share of the busy time
(:func:`trace_train_step`, which ``chip_smoke.py`` also calls).

``--window-probe SECONDS`` counts how often a short trace of the kind
``kernel_ms`` takes holds no kernel with an unpadded window, and whether
the padded window (:func:`_active_kernels`) then holds every kernel
(:func:`window_probe`). Where the trace comes back without the timed
kernels even so, :func:`queued_event_ms` times the call with CUDA events
instead, behind a spin kernel that hides the host's issue time.

``--smoke --device cpu`` runs the same windows on the CPU at the config's
SMOKE size and a few tokens, as a rehearsal of the script; device shares
mean nothing there.

``--compressed`` traces the compressed decode step of ``chip_smoke.py``'s
phase 4 instead: a random base decoder at internlm2-1.8b's widths and 2
layers and a seeded fine-tune are saved through ``StorageEngine`` (host
numpy, about two minutes on the card's machine), the fine-tune is loaded
at ``bits=8`` and ``bits=4`` into ``CompressedModel``, and one greedy decode
(4 x 8 prompt, 16 tokens) is traced a window, with the share of the
device's busy time spent in ``dq_matmul`` kernels
(:func:`trace_compressed_decode`, which ``chip_smoke.py`` also calls).
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from ..configs import get_config
from ..kernels import ops
from ..models import init_cache, init_params
from .steps import make_prefill_step, make_serve_step

__all__ = ["card_state", "kernel_ms", "kernel_rounds_ms", "main", "queued_event_ms", "summarize",
           "trace_compressed_decode", "trace_prefill", "trace_train_step", "window_probe"]

ARCH, SEED = "internlm2-1.8b", 0
# The record_function ranges of models/recurrent.py: the RG-LRU scan and the
# RWKV-6 chunk loop (their kernels' device time is the scans' share).
SCAN_RANGES = ("rglru_scan", "rwkv6_chunks")
# Substrings of the matrix-product kernels' names (cuBLAS, cuBLASLt, CUTLASS).
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# Idle host seconds on each side of a kernel_ms trace's runs (_active_kernels).
WINDOW_PAD_S = 0.05
# queued_event_ms: the spin kernel's calibration length (cycles) and the
# ms it runs beyond twice the host's issue time of a round.
SPIN_CAL_CYCLES, SPIN_MARGIN_MS = 10_000_000, 1.0
# (batch, prefill length, prompt length, serve steps): published, and --smoke.
SIZES = {False: (4, 2048, 8, 16), True: (2, 16, 3, 2)}
# --compressed: internlm2-1.8b's decode widths at 2 layers (chip_smoke.py's
# phase 4), and a tiny decoder for --smoke; (batch, prompt length, steps).
COMPRESSED = {False: (dict(d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
                           vocab_size=92544, n_layers=2), (4, 8, 16)),
              True: (dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab_size=96, n_layers=2), (2, 3, 2))}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(prof, wall_s: float, reps: int, top: int = 8, match: str | None = None,
              ranges: tuple[str, ...] = ()) -> dict:
    """Device busy time, shares, kernel and host-op counts of a profiled
    window of ``reps`` repetitions that took ``wall_s`` on the wall clock;
    with ``match``, also the device time of the kernels whose name holds it
    and their share of the busy time; with ``ranges``, the device time of
    the kernels launched inside each ``record_function`` range of those
    names (whose own device-side markers are not kernels)."""
    kernels, host_ops, in_range = [], 0, dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in in_range:
                kernels.append(e)
        elif e.name in in_range:
            in_range[e.name] += e.device_time_total
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            host_ops += 1
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us = _union_us(intervals)
    gaps = [max(0.0, s2 - e1) for (_, e1), (s2, _) in zip(intervals, intervals[1:])]
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    wall_us = wall_s * 1e6
    extra = {}
    if match is not None:
        mine = sum(t for n, (t, _) in by_name.items() if match in n)
        extra = {"match": match, "match_ms": mine / reps / 1e3,
                 "match_share_of_busy": mine / busy_us if busy_us else 0.0}
    if ranges:
        extra["ranges_ms"] = {n: t / reps / 1e3 for n, t in in_range.items()}
    return {
        "wall_ms": wall_us / reps / 1e3,
        "device_busy_ms": busy_us / reps / 1e3,
        "busy_share": busy_us / wall_us if wall_us else 0.0,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else 0.0,
        "kernels": len(kernels) / reps,
        "host_ops": host_ops / reps,
        "median_gap_us": float(np.median(gaps)) if gaps else 0.0,
        "top_kernels": [{"name": n[:90], "ms": t / reps / 1e3, "count": c / reps}
                        for n, (t, c) in top_k],
        **extra,
    }


def _kernels(prof) -> list[tuple[float, float, str]]:
    """(start µs, end µs, name) of every device kernel in a trace, in order
    (the schedule's ``ProfilerStep`` ranges, which the trace also puts on
    the device, left out)."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"))


def _active_kernels(body, warmup: int, reps: int,
                    pad: float = WINDOW_PAD_S) -> list[tuple[float, float, str]]:
    """Kernels of ``reps`` runs of ``body`` traced in the active step of a
    schedule whose warm-up step (``warmup`` runs, discarded) absorbs the
    tracer's start: a trace started and stopped around a short run can
    miss every kernel.

    The active step also holds ``pad`` seconds of idle host time before
    and after the runs. The trace keeps only the card's activity whose
    timestamps, converted to the host's clock, fall inside the step's
    window, and that conversion wanders: on an H100 machine a window as
    short as the runs has come back without a kernel though the host
    logged every launch (``window_probe`` counts how often, unpadded and
    padded)."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(warmup):
            body()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(pad)
        for _ in range(reps):
            body()
        torch.cuda.synchronize()
        time.sleep(pad)
        prof.step()
    return _kernels(prof)


def kernel_rounds_ms(fn, reps: int, flush, match: str | None = None, warmup: int = 5,
                     tries: int = 3) -> list[float]:
    """Device ms of each round of (``flush()``, ``fn()``) that the tracer
    kept, host issue left out: the summed durations of the kernels ``fn``
    launches in the round (those whose name holds ``match``, or all but the
    flush's), traced by ``torch.profiler`` over ``reps`` rounds
    (:func:`_active_kernels`); kernels that start before the active step's
    first flush are not counted.

    The tracer can drop whole rounds, so the rounds it kept are returned:
    at least half of them, with a number of kernels of ``fn`` that the
    rounds divide (one a round, with ``match``). A trace that breaks this
    is taken again, up to ``tries`` times, and then raises. Where the
    rounds hold unequal numbers of ``fn``'s kernels (a kernel of ``fn``
    named like the flush's splits a round), each round is given the mean.
    Needs a CUDA card."""
    fn()
    torch.cuda.synchronize()
    rounds, mine = 0, []
    for _ in range(tries):
        # The flush's kernel names, traced anew each try.
        flush_names = {name for _, _, name in _active_kernels(flush, 2, 2)}
        ks = _active_kernels(lambda: (flush(), fn()), warmup, reps)
        starts = [s for s, _, name in ks if name in flush_names]
        mine = [(s, e - s, name) for s, e, name in ks if starts and s >= starts[0]
                and name not in flush_names and (match is None or match in name)]
        rounds = len(starts)
        per = [[] for _ in starts]
        for s, t, _ in mine:
            per[bisect.bisect_right(starts, s) - 1].append(t)
        if (2 * rounds >= reps and mine and len(mine) % rounds == 0
                and (match is None or len(mine) == rounds)):
            if len({len(ts) for ts in per}) == 1:
                return [sum(ts) / 1e3 for ts in per]
            return [sum(t for _, t, _ in mine) / rounds / 1e3] * rounds
    names = Counter(name[:60] for _, _, name in mine)
    raise RuntimeError(f"the trace holds {rounds} of {reps} flushes and {len(mine)} kernels "
                       f"of the timed call: {dict(names)}")


def kernel_ms(fn, reps: int, flush, match: str | None = None, warmup: int = 5,
              tries: int = 3) -> float:
    """Mean device ms a call of ``fn``, host issue left out: the mean over
    the rounds of :func:`kernel_rounds_ms` that the tracer kept. Needs a
    CUDA card."""
    return float(np.mean(kernel_rounds_ms(fn, reps, flush, match, warmup, tries)))


def card_state() -> str:
    """The card's SM clock, power draw and temperature, as ``nvidia-smi``
    reads them, to print beside a time (a card below its power limit, or a
    hot one, runs slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def queued_event_ms(fn, reps: int, flush, warmup: int = 3) -> float:
    """Mean device ms a call of ``fn`` from CUDA events, host issue left
    out without a trace: each round (``flush()``, an event, ``fn()``, an
    event) is queued behind a spin kernel (``torch.cuda._sleep``) that
    lasts twice the host's issue time of a round plus ``SPIN_MARGIN_MS``,
    so the card runs the round's kernels back to back. Unlike
    :func:`kernel_ms` it times every kernel of ``fn``, and the gaps between
    them on the card; a ``fn`` that waits on the card is timed with its
    waits. Needs a CUDA card."""
    for _ in range(warmup):
        flush()
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    flush()
    fn()
    issue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CAL_CYCLES)
    end.record()
    end.synchronize()
    spin = int(SPIN_CAL_CYCLES / start.elapsed_time(end) * (2 * issue_ms + SPIN_MARGIN_MS))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(spin)
        flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def window_probe(seconds: float) -> dict:
    """Short traces in a loop for ``seconds``: 5 discarded and 10 traced
    rounds of (an L2 flush, one small kernel), each with an unpadded
    window and, when that holds no kernel, again padded (``WINDOW_PAD_S``
    a side). Counts the traces, the unpadded ones that held no kernel and
    the padded retries that held all 20. Needs a CUDA card."""
    x = torch.zeros(1 << 20, device="cuda")
    flush = torch.zeros(64 << 20, device="cuda")

    def body():
        flush.add_(1.0)
        x.mul_(1.0001)

    n = empty = padded_kept_all = 0
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        n += 1
        if not _active_kernels(body, 5, 10, pad=0.0):
            empty += 1
            padded_kept_all += len(_active_kernels(body, 5, 10)) == 20
    return {"traces": n, "unpadded_empty": empty, "padded_retries_kept_all": padded_kept_all,
            "pad_s": WINDOW_PAD_S}


def _profiled(fn, reps: int, dev: torch.device) -> tuple[object, float]:
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    return prof, wall


def _window(summary: dict, plain_ms: float, **shape) -> dict:
    """A window's summary with its unprofiled wall time and the device's
    busy share of that time (the profiler slows the host, not the kernels)."""
    busy = summary["device_busy_ms"] / plain_ms if plain_ms else 0.0
    return {**shape, "plain_wall_ms": plain_ms, "busy_share_of_plain": busy, **summary}


def trace_compressed_decode(provider, spec, prompt, steps: int,
                            plain_ms: float | None = None) -> dict:
    """One greedy decode on ``provider`` traced: :func:`summarize` per
    decode step (the prompt's steps included) with the ``dq_matmul``
    kernels' share of the busy time. ``plain_ms`` is the unprofiled ms a
    step; without it one untraced decode is timed first."""
    from .compressed_serve import greedy_decode

    dev = provider.device
    n_steps = prompt.shape[1] - 1 + steps
    if plain_ms is None:
        greedy_decode(provider, spec, prompt, steps)
        _sync(dev)
        t0 = time.perf_counter()
        greedy_decode(provider, spec, prompt, steps)
        _sync(dev)
        plain_ms = (time.perf_counter() - t0) / n_steps * 1e3
    prof, wall = _profiled(lambda: greedy_decode(provider, spec, prompt, steps), 1, dev)
    return _window(summarize(prof, wall, n_steps, match="dq_matmul"), plain_ms,
                   batch=prompt.shape[0], steps=n_steps)


def trace_train_step(step_fn, params, opt, batch, plain_ms: float | None = None) -> dict:
    """One ``step_fn(params, opt, batch)`` traced (its outputs dropped):
    :func:`summarize` of the step with the ``flash_attn`` kernels' share
    of the busy time. ``plain_ms`` is the step's unprofiled ms; without it
    one untraced step is timed first."""
    dev = next(iter(batch.values())).device

    def run():
        out = step_fn(params, opt, batch)
        float(out[2]["loss"])  # the host waits for the step, as a trainer does

    if plain_ms is None:
        run()
        _sync(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
    prof, wall = _profiled(run, 1, dev)
    size, length = batch["tokens"].shape
    return _window(summarize(prof, wall, 1, match="flash_attn"), plain_ms,
                   batch=size, len=length)


def trace_prefill(prefill_fn, params, batch, plain_ms: float | None = None) -> dict:
    """One ``prefill_fn(params, batch)`` traced: :func:`summarize` of the
    step with the ``flash_attn`` kernels' share of the busy time and
    ``shares``, the busy time split into attention, GEMMs, the recurrent
    scans (``SCAN_RANGES``) and the rest. ``plain_ms`` is the step's
    unprofiled ms; without it one untraced step is timed first."""
    dev = next(iter(batch.values())).device

    def run():
        prefill_fn(params, batch)

    if plain_ms is None:
        run()
        _sync(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
    prof, wall = _profiled(run, 1, dev)
    summary = summarize(prof, wall, 1, match="flash_attn", ranges=SCAN_RANGES)
    busy = summary["device_busy_ms"]
    gemm = sum(e - s for s, e, name in _kernels(prof)
               if any(g in name.lower() for g in GEMM_NAMES)) / 1e3
    parts = {"attention": summary["match_ms"], "gemm": gemm,
             "scan": sum(summary["ranges_ms"].values())}
    parts["other"] = max(busy - sum(parts.values()), 0.0)
    summary["shares"] = {k: (v / busy if busy else 0.0) for k, v in parts.items()}
    summary["parts_ms"] = parts
    size, length = next(iter(batch.values())).shape[:2]
    return _window(summary, plain_ms, batch=size, len=length)


def _train(cfg, smoke: bool, dev: torch.device) -> dict:
    from ..data import SyntheticLM
    from ..optim import adamw_init
    from .steps import make_train_step

    batch, length = SIZES[smoke][:2]
    params = init_params(cfg, SEED, device=dev)
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, seed=SEED)
    b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0, batch, length).items()}
    return {"train": trace_train_step(make_train_step(cfg), params, opt, b)}


def _compressed(smoke: bool, dev: torch.device) -> dict:
    from ..core import CompressedModel, StorageEngine
    from .compressed_serve import DecoderSpec, decoder_architecture, init_decoder_tensors

    widths, (batch, prompt_len, steps) = COMPRESSED[smoke]
    spec = DecoderSpec(**widths)
    base = init_decoder_tensors(spec, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    ft = {k: (v + rng.normal(0.0, 1e-3 * float(v.std()), v.shape)).astype(np.float32)
          for k, v in base.items()}
    prompt = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, spec.vocab_size, (batch, prompt_len))).to(dev)
    out = {"arch": "internlm2-1.8b widths" if not smoke else "tiny decoder",
           "n_layers": spec.n_layers}
    build = Path(__file__).resolve().parents[3] / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="profile_steps_store_") as root:
        eng = StorageEngine(root, device=dev)
        eng.save_model("base", decoder_architecture(spec), base)
        eng.save_model("ft", decoder_architecture(spec), ft)
        for bits in (8, 4):
            provider = CompressedModel(eng.load_model("ft", bits=bits))
            out[f"compressed_bits{bits}"] = trace_compressed_decode(provider, spec, prompt,
                                                                    steps)
            provider.close()
        eng.close()
    return out


def _report(out: dict, windows) -> None:
    for window in windows:
        w = out[window]
        print(f"{window}: plain {w['plain_wall_ms']:.6f} ms; profiled {w['wall_ms']:.6f} ms, "
              f"device busy {w['device_busy_ms']:.6f} ms (busy share {w['busy_share']:.4f} "
              f"of the profiled time, {w['busy_share_of_plain']:.4f} of the plain time; "
              f"idle {w['idle_share']:.4f}), {w['kernels']:.1f} kernels and "
              f"{w['host_ops']:.1f} top-level host ops a step, median gap "
              f"{w['median_gap_us']:.3f} us"
              + (f"; {w['match']} {w['match_ms']:.6f} ms a step, "
                 f"{w['match_share_of_busy']:.4f} of busy" if "match" in w else "")
              + ("; shares of busy " + ", ".join(f"{k} {v:.4f}" for k, v in w["shares"].items())
                 if "shares" in w else ""),
              flush=True)
        for k in w["top_kernels"]:
            print(f"  {k['ms']:.6f} ms x{k['count']:.1f}  {k['name']}", flush=True)
    print(json.dumps(out), flush=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true", help="SMOKE size, a few tokens")
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", default=ARCH, help="an architecture of configs.list_archs()")
    p.add_argument("--trace", default=None, help="write the serve window's Chrome trace here")
    p.add_argument("--compressed", action="store_true",
                   help="trace the compressed decode step at bits 8 and 4 instead")
    p.add_argument("--train", action="store_true", help="trace one train step instead")
    p.add_argument("--window-probe", type=float, default=None, metavar="SECONDS",
                   help="count short traces that hold no kernel, unpadded and padded")
    args = p.parse_args(argv)
    if args.window_probe is not None:
        out = {"device": torch.cuda.get_device_name(), **window_probe(args.window_probe)}
        print(json.dumps(out), flush=True)
        return out
    batch, prefill_len, prompt_len, steps = SIZES[args.smoke]

    dev = ops.resolve_device(args.device)
    if args.compressed:
        out = {**_compressed(args.smoke, dev),
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
        _report(out, ("compressed_bits8", "compressed_bits4"))
        return out
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.train:
        out = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               **_train(cfg, args.smoke, dev)}
        _report(out, ("train",))
        return out
    params = init_params(cfg, SEED, device=dev)
    rng = np.random.default_rng(SEED + 1)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(f"profile_steps: {cfg.name}, {cfg.n_layers} layers, {cfg.param_dtype}, "
          f"device {out['device']}", flush=True)

    # ---- prefill: one step of batch x prefill_len
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prefill_len))).to(dev)
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": tokens})
    _sync(dev)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        _sync(dev)
        times.append(time.perf_counter() - t0)
    out["prefill"] = trace_prefill(prefill, params, {"tokens": tokens},
                                   float(np.median(times)) * 1e3)
    del tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- serve: teacher-force the prompt, then time greedy steps
    serve = make_serve_step(cfg)
    total = prompt_len + 3 * steps + 1
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len))).to(dev)
    state = {"cache": init_cache(cfg, batch, total, device=dev), "pos": 0, "tok": None}

    def step(tok):
        nxt, state["cache"] = serve(params, state["cache"], {"tokens": tok}, state["pos"])
        state["pos"] += 1
        state["tok"] = nxt[:, None].long()

    for t in range(prompt_len):
        step(prompt[:, t:t + 1])
    for _ in range(steps):  # warm
        step(state["tok"])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state["tok"])
    _sync(dev)
    plain = time.perf_counter() - t0
    prof, wall = _profiled(lambda: step(state["tok"]), steps, dev)
    out["serve"] = _window(summarize(prof, wall, steps), plain / steps * 1e3,
                           batch=batch, steps=steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    _report(out, ("prefill", "serve"))
    return out


if __name__ == "__main__":
    main()
