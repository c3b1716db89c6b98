"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each one fails the run when it does not hold):

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compile the CUDA kernels from ``src/repro_torch/csrc/``.
3. Kernels against their plain PyTorch versions, on the card, at the shapes
   the main path gives them; prints one ``{"kernels": [...]}`` line with
   launches, errors, times and bounds.
4. Main path at full width (internlm2-1.8b widths, depth cut to 2 layers):
   save a random base decoder and a seeded fine-tune through
   ``StorageEngine(device="cuda")`` (HNSW distance blocks through
   ``quantized_l2``), load the fine-tune at ``bits=8`` and ``bits=4`` and
   greedy-decode through ``CompressedModel`` (every matmul through
   ``dequant_matmul``/``_int4``), checked against the materialized forward.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX and nothing of the ``repro`` package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# The H100 SXM data sheet's memory rate and float32 (non-tensor-core) peak;
# other H100 variants use their own memory rate (see _bandwidth).
HBM_SXM = 3.35e12
FP32_PEAK = 67e12
# Decode widths of internlm2-1.8b (repro/configs/internlm2_1_8b.py): 24
# layers in the published model, cut to 2 here because the save path is
# host numpy and 24 layers would not fit the run's time limit.
WIDTHS = dict(d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92544)
N_LAYERS = 2
BATCH, PROMPT_LEN, STEPS = 4, 8, 16
MATMUL_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048), (2048, 92544)]
# Matmul calls of each (K, N) in one decode step at N_LAYERS: q,o / k,v /
# gate,up / down per layer, plus the LM head.
MATMUL_PER_STEP = {(2048, 2048): 2 * N_LAYERS, (2048, 1024): 2 * N_LAYERS,
                   (2048, 8192): 2 * N_LAYERS, (8192, 2048): N_LAYERS,
                   (2048, 92544): 1}
# (B, N, D) distance blocks of the fine-tune save's probes, with their count
# per save: q/o, k/v, MLP, embedding/LM head, norm gains.
L2_SHAPES = {(2, 4, 4194304): 2, (4, 4, 2097152): 1, (1, 6, 16777216): 6,
             (1, 2, 189530112): 2, (5, 1, 2048): 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _bandwidth(name: str) -> float:
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return HBM_SXM


def _time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median ms of ``fn`` on the card, each run after an L2 flush (a
    decode step streams every weight from device memory, so runs are
    timed cold), with CUDA events around each run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> tuple[float, float]:
    """(max abs error, max of |err| / (atol + rtol |want|)): the second is
    <= 1 exactly when allclose(got, want, rtol, atol) holds."""
    err = (got.double() - want.double()).abs()
    ratio = err / (atol + rtol * want.double().abs())
    return float(err.max()), float(ratio.max())


# ----------------------------------------------------------------- phases
def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"memory rate for bounds {_bandwidth(name) / 1e12:.2f} TB/s")
    return {"name": name, "smi": smi.splitlines()[0], "bandwidth": _bandwidth(name)}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {list(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.3f} s "
        f"({_build.BUILD_DIR.relative_to(ROOT)})")


def phase_kernels(dev_info: dict) -> list[dict]:
    from repro_torch.kernels import ops, ref

    bw = dev_info["bandwidth"]
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    flush = torch.zeros(64 << 20, dtype=torch.float32, device=dev)  # 256 MB > L2
    entries = []

    # ---- dequant_matmul (int8 delta) and dequant_matmul_int4 (packed delta)
    for name, packed in (("dequant_matmul", False), ("dequant_matmul_int4", True)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0}
        max_abs = 0.0
        for k, n in MATMUL_SHAPES:
            x = torch.from_numpy(rng.normal(0, 1, (BATCH, k)).astype(np.float32)).to(dev)
            base = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev)
            if packed:
                codes = torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8)).to(dev)
                delta = ops.pack_int4(codes)
                scal = (0.013, -11.0, 5e-4, 8.0)
                fn, plain = ops.dequant_matmul_int4, ref.dequant_matmul_int4
            else:
                delta = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev)
                scal = (0.013, -11.0, 3.1e-4, -64.0)
                fn, plain = ops.dequant_matmul, ref.dequant_matmul
            args = (x, base, scal[0], scal[1], delta, scal[2], scal[3])
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            scale = float(want.abs().max()) + 1e-6
            abs_err, ratio = _close(got, want, 1e-4, 1e-5 * scale)
            if not torch.isfinite(got).all() or ratio > 1.0:
                fail(f"{name} K={k} N={n}: max abs err {abs_err:.3e}, "
                     f"allclose ratio {ratio:.3f} (rtol 1e-4, atol 1e-5*{scale:.3g})")
            w = ref.dequantize_weight(base, *scal[:2], ref.unpack_int4(delta) if packed
                                      else delta, *scal[2:])
            ms = _time_ms(lambda: fn(*args), 20, flush)
            plain_ms = _time_ms(lambda: plain(*args), 5, flush)
            lib_ms = _time_ms(lambda: torch.matmul(x, w), 20, flush)
            del w
            nbytes = k * n * (1.5 if packed else 2) + BATCH * (k + n) * 4
            # float32 operations: 5 to dequantize each weight, 2 per row of x.
            flops = k * n * (5 + 2 * BATCH)
            mult = MATMUL_PER_STEP[(k, n)]
            bound = max(nbytes / bw, flops / FP32_PEAK) * 1e3
            log(f"shape: {name} M={BATCH} K={k} N={n} x{mult}/step: ms {ms:.6f} "
                f"plain {plain_ms:.6f} library {lib_ms:.6f} bound {bound:.6f} "
                f"abs_err {abs_err:.3e} ratio {ratio:.3f}")
            max_abs = max(max_abs, abs_err)
            tot["ms"] += mult * ms
            tot["plain_ms"] += mult * plain_ms
            tot["library_ms"] += mult * lib_ms
            tot["bytes"] += mult * nbytes
            tot["flops"] += mult * flops
        t_bytes, t_ops = tot["bytes"] / bw * 1e3, tot["flops"] / FP32_PEAK * 1e3
        entries.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/dequant_matmul.cu",
            "replaces": ("src/repro/kernels/dequant_matmul.py:135" if packed
                         else "src/repro/kernels/dequant_matmul.py:60"),
            "launches": 0, "max_abs_err": max_abs, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"],
        })

    # ---- quantized_l2
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "copy_ms": 0.0, "bytes": 0,
           "flops": 0}
    max_abs = 0.0
    for (b, n, d), mult in L2_SHAPES.items():
        base = rng.normal(0, 1, d).astype(np.float32)
        q_host = np.stack([base + rng.normal(0, 0.01 * (i + 1), d).astype(np.float32)
                           for i in range(b)])
        codes_host = rng.integers(0, 256, (n, d), dtype=np.uint8)
        scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, n)).to(dev)
        if n > 1:
            scales[n - 1] = 0.0  # a constant row
        zps = torch.from_numpy(rng.integers(0, 256, n).astype(np.float64)).to(dev)
        mids = torch.from_numpy(rng.normal(0, 0.5, n)).to(dev)
        q = torch.from_numpy(q_host).to(dev)
        codes = torch.from_numpy(codes_host).to(dev)
        args = (q, codes, scales, zps, mids)
        got = ops.quantized_l2(*args)
        want = ref.quantized_l2(*args)
        torch.cuda.synchronize()
        abs_err, ratio = _close(got, want, 2e-3, 0.0)
        if (not torch.isfinite(got).all() or ratio > 1.0
                or not torch.equal(got.argmin(dim=1), want.argmin(dim=1))):
            fail(f"quantized_l2 B={b} N={n} D={d}: max abs err {abs_err:.3e}, "
                 f"rel ratio {ratio:.3f} (rtol 2e-3), argmin "
                 f"{got.argmin(dim=1).tolist()} vs {want.argmin(dim=1).tolist()}")

        def library():
            dot = q @ codes.to(torch.float32).T
            c = codes.to(torch.float32)
            csum, csq = c.sum(dim=1, dtype=torch.float64), (c * c).sum(dim=1, dtype=torch.float64)
            q64 = q.double()
            qsq, qsum = (q64 * q64).sum(dim=1), q64.sum(dim=1)
            norm = scales * scales * (csq - 2 * zps * csum + d * zps * zps)
            dist = qsq[:, None] + norm + 2 * (qsum[:, None] * scales * zps - scales * dot.double())
            cdist = qsq[:, None] - 2 * mids * qsum[:, None] + d * mids * mids
            return torch.where(scales == 0, cdist, dist).clamp_min(0)

        ms = _time_ms(lambda: ops.quantized_l2(*args), 10, flush)
        plain_ms = _time_ms(lambda: ref.quantized_l2(*args), 3, flush)
        lib_ms = _time_ms(library, 5, flush)
        copy_ms = _time_ms(lambda: torch.from_numpy(codes_host).to(dev), 3, flush)
        nbytes = n * d + b * d * 4
        flops = 2 * b * n * d  # float32 c·q FMAs (the integer moments are cheaper)
        bound = max(nbytes / bw, flops / FP32_PEAK) * 1e3
        log(f"shape: quantized_l2 B={b} N={n} D={d} x{mult}/save: ms {ms:.6f} "
            f"plain {plain_ms:.6f} library {lib_ms:.6f} bound {bound:.6f} "
            f"host_to_device_codes_ms {copy_ms:.6f} abs_err {abs_err:.3e} ratio {ratio:.3f}")
        max_abs = max(max_abs, abs_err)
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * plain_ms
        tot["library_ms"] += mult * lib_ms
        tot["copy_ms"] += mult * copy_ms
        tot["bytes"] += mult * nbytes
        tot["flops"] += mult * flops
        del q, codes, args
    log(f"quantized_l2 per fine-tune save: kernel {tot['ms']:.6f} ms, host-to-device "
        f"code copies {tot['copy_ms']:.6f} ms")
    t_bytes, t_ops = tot["bytes"] / bw * 1e3, tot["flops"] / FP32_PEAK * 1e3
    entries.append({
        "name": "quantized_l2", "route": "cuda", "source": "src/repro_torch/csrc/quantized_l2.cu",
        "replaces": "src/repro/kernels/quantized_l2.py:82", "launches": 0,
        "max_abs_err": max_abs, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": tot["library_ms"],
    })
    del flush
    torch.cuda.empty_cache()
    return entries


def _finetune(tensors: dict, rng) -> dict:
    """The base plus seeded noise of 1e-3 x each tensor's std."""
    return {k: (v + rng.normal(0.0, 1e-3 * float(v.std()), v.shape)).astype(np.float32)
            for k, v in tensors.items()}


def _decode_checked(eng, spec, prompt, bits: int, bw: float) -> dict:
    from repro_torch.core import CompressedModel
    from repro_torch.core.loader import LoadedModel
    from repro_torch.kernels import ops
    from repro_torch.launch.compressed_serve import MaterializedProvider, greedy_decode

    kernel = "dequant_matmul_int4" if bits == 4 else "dequant_matmul"
    t0 = time.perf_counter()
    lm = eng.load_model("ft", bits=bits)
    provider = CompressedModel(lm)
    calls = {"materialize": 0, "tensor": []}
    orig_mat, orig_tensor = LoadedModel.materialize, LoadedModel.tensor

    def spy_materialize(self):
        calls["materialize"] += 1
        return orig_mat(self)

    def spy_tensor(self, name):
        calls["tensor"].append(name)
        return orig_tensor(self, name)

    LoadedModel.materialize, LoadedModel.tensor = spy_materialize, spy_tensor
    try:
        # First decode: uploads every operand once (part of the load).
        before = ops.launch_counts()
        tokens, logits = greedy_decode(provider, spec, prompt, STEPS, return_logits=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        after = ops.launch_counts()
        first_calls = provider.counters["matmul_calls"]
        served = set(provider.kernel_served)
        # Steady state: the same decode again, operands resident.
        provider.reset_counters()
        t1 = time.perf_counter()
        tokens2 = greedy_decode(provider, spec, prompt, STEPS)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
        again = ops.launch_counts()
    finally:
        LoadedModel.materialize, LoadedModel.tensor = orig_mat, orig_tensor
    launched = {k: after[k] - before[k] for k in after}
    relaunched = {k: again[k] - after[k] for k in after}
    n_steps = PROMPT_LEN - 1 + STEPS
    matmul_calls = provider.counters["matmul_calls"]
    want_calls = n_steps * (7 * spec.n_layers + 1)
    if not (launched[kernel] == first_calls == relaunched[kernel] == matmul_calls == want_calls):
        fail(f"bits={bits}: {launched[kernel]}/{relaunched[kernel]} {kernel} launches "
             f"for {first_calls}/{matmul_calls} matmuls (want {want_calls})")
    other = "dequant_matmul" if bits == 4 else "dequant_matmul_int4"
    if launched[other] or relaunched[other]:
        fail(f"bits={bits}: unexpected {other} launches")
    if calls["materialize"] or (set(calls["tensor"]) & served):
        fail(f"bits={bits}: materialize() {calls['materialize']}x, tensor() on "
             f"kernel-served {sorted(set(calls['tensor']) & served)}")
    if not torch.equal(tokens, tokens2):
        fail(f"bits={bits}: the second decode gave other tokens")
    bytes_step = provider.counters["bytes_moved"] / n_steps
    matmul_bytes = sum(provider.weight(nm).operand_nbytes for nm in provider._weights)
    provider.close()

    # The materialized forward on the card over the same bits view.
    lm_ref = eng.load_model("ft", bits=bits)
    mat = MaterializedProvider(lm_ref)
    want_tokens, want_logits = greedy_decode(mat, spec, prompt, STEPS, return_logits=True)
    mat.close()
    del mat
    if logits.shape != (BATCH, STEPS, spec.vocab_size) or not torch.isfinite(logits).all():
        fail(f"bits={bits}: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    # Compare step by step while both decodes fed the same tokens; a
    # near-tie (top-2 margin within tolerance) may legitimately split them.
    tol = 1e-4
    compared = 0
    for s in range(STEPS):
        abs_err, ratio = _close(logits[:, s], want_logits[:, s], tol, tol)
        if ratio > 1.0:
            fail(f"bits={bits} step {s}: logits differ by {abs_err:.3e} (rtol/atol {tol})")
        top2 = want_logits[:, s].topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol * (1 + top2[:, 0].abs())
        if not torch.equal(tokens[:, s][clear], want_tokens[:, s][clear]):
            fail(f"bits={bits} step {s}: tokens differ where the margin is clear")
        compared += 1
        if not torch.equal(tokens[:, s], want_tokens[:, s]):
            log(f"bits={bits}: a near-tie split the decodes at step {s}; compared {compared} steps")
            break
    tok_s = BATCH * STEPS / decode_s
    ms_step = decode_s / n_steps * 1e3
    log(f"decode bits={bits}: load {load_s:.6f} s (open + operand upload + first decode), "
        f"{tok_s:.6f} tokens/s, {ms_step:.6f} ms/step over {n_steps} steps of batch {BATCH}; "
        f"{kernel} launches {launched[kernel]} = matmul_calls {matmul_calls}; "
        f"weight-operand bytes/step {bytes_step:.0f} ({matmul_bytes} matmul operand bytes), "
        f"bound {bytes_step / bw * 1e6:.6f} us at {bw / 1e12:.2f} TB/s; "
        f"logits match the materialized forward over {compared} steps")
    return {"launches": launched, "tokens": tokens.cpu()}


def phase_main_path(dev_info: dict) -> dict[str, int]:
    from repro_torch.core import StorageEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.compressed_serve import (
        DecoderSpec,
        decoder_architecture,
        init_decoder_tensors,
    )

    spec = DecoderSpec(n_layers=N_LAYERS, **WIDTHS)
    log(f"main path: internlm2-1.8b widths {WIDTHS}, depth cut from 24 to "
        f"{N_LAYERS} layers (the save path is host numpy)")
    t0 = time.perf_counter()
    base = init_decoder_tensors(spec, seed=SEED)
    ft = _finetune(base, np.random.default_rng(SEED + 1))
    n_weights = sum(v.size for k, v in base.items() if k != "model.embed_tokens.weight"
                    and v.ndim == 2)
    log(f"weights: {sum(v.size for v in base.values())} elements, {n_weights} in matmuls; "
        f"made in {time.perf_counter() - t0:.3f} s")
    prompt = np.random.default_rng(SEED + 2).integers(0, spec.vocab_size, (BATCH, PROMPT_LEN))
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_store_") as root:
        # The main path: every count starts at 0 here and is read at the end.
        ops.reset_launch_counts()
        eng = StorageEngine(root, device="cuda")
        rep = eng.save_model("base", decoder_architecture(spec), base)
        log(f"save base: {rep.seconds:.6f} s, {rep.n_new_bases} new bases, "
            f"{rep.n_deltas} deltas, page {rep.page_bytes} bytes; "
            f"quantized_l2 launches {ops.launch_counts()['quantized_l2']}")
        del base
        before = ops.launch_counts()["quantized_l2"]
        rep = eng.save_model("ft", decoder_architecture(spec), ft)
        l2 = ops.launch_counts()["quantized_l2"] - before
        outcomes = {ex["tensor"]: ex["outcome"] for ex in rep.explain}
        log(f"save fine-tune: {rep.seconds:.6f} s, {rep.n_new_bases} new bases, "
            f"{rep.n_deltas} deltas, page {rep.page_bytes} bytes, mean nbit "
            f"{rep.mean_nbit:.3f}; quantized_l2 launches {l2}")
        del ft
        not_delta = {k: v for k, v in outcomes.items() if v != "delta"}
        if not_delta or l2 <= 0:
            fail(f"fine-tune save: non-delta outcomes {not_delta}, quantized_l2 launches {l2}")
        results = {bits: _decode_checked(eng, spec, prompt, bits, dev_info["bandwidth"])
                   for bits in (8, 4)}
        counts = ops.launch_counts()
        eng.close()
    log(f"main path launches: {counts}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    first = results[8]["tokens"][:, :4].tolist()
    log(f"tokens bits=8, first 4 per prompt: {first}")
    return counts


def main() -> int:
    dev_info = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not beside this script ({exc}); run it from the repository root")
    t0 = time.perf_counter()
    phase_build()
    entries = phase_kernels(dev_info)
    log(f"kernels phase: {time.perf_counter() - t0:.3f} s")
    t1 = time.perf_counter()
    counts = phase_main_path(dev_info)
    log(f"main path phase: {time.perf_counter() - t1:.3f} s")
    for e in entries:
        e["launches"] = counts[e["name"]]
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro"]
    if bad:
        fail(f"imported {bad}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(dev_info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
