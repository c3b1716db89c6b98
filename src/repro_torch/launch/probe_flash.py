"""What bounds the bfloat16 attention kernel at head dim 256: timed variants.

    PYTHONPATH=src python -m repro_torch.launch.probe_flash [--reps 20]

Builds diagnostic variants of ``csrc/flash_attention_sm90.cu``, each with
one part of the head-dim-256 schedule taken out, into
``build/probe_flash/`` (``nvcc``, one per variant, all started together),
and times each at recurrentgemma-9b's prefill shape (``chip_smoke.py``'s
``FA_RG_PREFILL``: q (1, 8192, 16, 256), k/v (1, 8192, 1, 256), causal,
window 2048; CUDA events around one launch after an L2 flush, the median of
``reps``, in three rounds):

=============  ==========================================================
variant        what it leaves out (its output is not attention)
=============  ==========================================================
``kernel``     nothing: the kernel as built for the port
``loads``      everything but the TMA loads: the consumers wait for each
               stage and hand it back (the rate the K/V tiles arrive at)
``quarter``    three quarters of the loads: one box of 64 columns of each
               K and V tile, the products and softmax unchanged
``products``   the softmax: p is the scores' bits (the products and the
               ring alone)
``no_turns``   the turn barriers (both warpgroups issue at will)
=============  ==========================================================

Then, from a ``kernel`` build that also writes ``clock64`` stamps for the
turns of one block (block 100, a full-window block) and ``%globaltimer``
stamps for every block: a turn's median clocks waiting for its stage, for
its turn, issuing its products, waiting for them and running the softmax;
each block's median prologue (entry to its first turn), loop and last turn
with the store; the gaps between one block's end and the next one's start
on an SM; and the SM clock under load. The last line is one JSON object
with those numbers. It needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels._build import CSRC_DIR, NVCC_FLAGS, _nvcc

__all__ = ["VARIANTS", "main", "variant_source"]

SHAPE = (1, 8192, 8192, 16, 1, 256, True, 2048)  # B, Sq, Sk, H, KV, dh, causal, window
BUILD = CSRC_DIR.parents[2] / "build" / "probe_flash"

# Each variant: (text of flash_attention_sm90.cu, its replacement) pairs,
# applied in order; each text must occur once.
_TURN_LOOP = """    const int s = j % kRing, t = pln.t_lo + j;
    mbar_wait(&full[s], (j / kRing) & 1);
    bar_sync(mine, 256);"""
_SOFTMAX_HEAD = """  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) {
    const int half = (j >> 1) & 1;"""
VARIANTS = {
    "kernel": [],
    "loads": [("  // Warpgroup 0 takes the first turn.", """  for (int j = 0; j <= n; ++j) {
    const int s = j % kRing;
    mbar_wait(&full[s], (j / kRing) & 1);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (n >= 0) {
    store_rows(o, l, p, pln, row0, col);
    return;
  }
  // Warpgroup 0 takes the first turn.""")],
    "quarter": [("mbar_expect_tx(&full[s], (j < n ? C::KV_BYTES : 0) + (j > 0 ? C::KV_BYTES : 0));"
                 "\n#pragma unroll\n        for (int jb = 0; jb < C::NBOX; ++jb) {",
                 "mbar_expect_tx(&full[s], ((j < n ? C::KV_BYTES : 0) + (j > 0 ? C::KV_BYTES : 0))"
                 " / C::NBOX);\n#pragma unroll\n        for (int jb = 0; jb < 1; ++jb) {")],
    "products": [(_SOFTMAX_HEAD, """#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ph[kk][r] = __float_as_uint(sc[kk * 8 + r]);
      pl[kk][r] = __float_as_uint(sc[kk * 8 + r + 4]);
    }
  if (k0 >= 0) return;
""" + _SOFTMAX_HEAD)],
    "no_turns": [("  if (cw == 1) bar_arrive(kTurnBar, 256);", ""),
                 ("  mbar_wait(&full[0], 0);\n  bar_sync(mine, 256);", "  mbar_wait(&full[0], 0);"),
                 (_TURN_LOOP, _TURN_LOOP.replace("\n    bar_sync(mine, 256);", "")),
                 ("  issue_s(sc, q_base, smem_addr(Ks));\n  wgmma_commit();\n"
                  "  bar_arrive(other, 256);",
                  "  issue_s(sc, q_base, smem_addr(Ks));\n  wgmma_commit();"),
                 ("    wgmma_commit();\n    bar_arrive(other, 256);", "    wgmma_commit();"),
                 ("    mbar_wait(&full[s], (n / kRing) & 1);\n    bar_sync(mine, 256);",
                  "    mbar_wait(&full[s], (n / kRing) & 1);"),
                 ("    if (cw == 0) bar_arrive(other, 256);\n", "")],
}
# The stamps of the traced build.
_STAMPS = [
    ("namespace {\n\nusing namespace hopper;", """__device__ long long g_turn[2][64][6];
__device__ long long g_block[4096][7];
extern "C" int probe_turns(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_turn, sizeof(g_turn)));
}
extern "C" int probe_blocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_block, sizeof(g_block)));
}
__device__ __forceinline__ long long probe_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long probe_sm() {
  int r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}
#define TURN(k) \\
  if (blockIdx.x == 100 && threadIdx.x % 128 == 0 && j < 64) g_turn[cw][j][k] = clock64();
#define BLOCK(k, v) \\
  if (threadIdx.x == 128 && blockIdx.x < 4096) g_block[blockIdx.x][k] = (v);
namespace {

using namespace hopper;"""),
    (_TURN_LOOP, _TURN_LOOP.replace("    mbar_wait", "    TURN(0)\n    mbar_wait")
     .replace("    bar_sync(mine, 256);", "    TURN(1)\n    bar_sync(mine, 256);\n    TURN(2)")),
    ("    wgmma_commit();\n    bar_arrive(other, 256);\n    wgmma_wait_all();",
     "    wgmma_commit();\n    bar_arrive(other, 256);\n    TURN(3)\n    wgmma_wait_all();"),
    ("    if (lane == 0) mbar_arrive(&empty[s]);\n    softmax_tile(sc, o, m, l, ph, pl, p, "
     "t * kBK, tile_needs_mask(p, pln, t), qpos, col);\n  }",
     "    TURN(4)\n    if (lane == 0) mbar_arrive(&empty[s]);\n    softmax_tile(sc, o, m, l, "
     "ph, pl, p, t * kBK, tile_needs_mask(p, pln, t), qpos, col);\n    TURN(5)\n  }"),
    ("    attend256(kmap, vmap, p, smem);",
     "    BLOCK(0, probe_sm()) BLOCK(1, probe_ns()) BLOCK(5, clock64())\n"
     "    attend256(kmap, vmap, p, smem);"),
    ("  // Turn 0: S(0) alone.\n", "  // Turn 0: S(0) alone.\n  BLOCK(2, probe_ns())\n"),
    ("  // Turn n: P(n-1) V(n-1) alone.",
     "  BLOCK(3, probe_ns())\n  // Turn n: P(n-1) V(n-1) alone."),
    ("    fence_regs(o);\n  }\n  store_rows(o, l, p, pln, row0, col);\n}",
     "    fence_regs(o);\n  }\n  store_rows(o, l, p, pln, row0, col);\n"
     "  BLOCK(4, probe_ns()) BLOCK(6, clock64())\n}"),
]


def variant_source(name: str, traced: bool = False) -> str:
    """The kernel source with variant ``name``'s edits (and the stamps)."""
    src = (CSRC_DIR / "flash_attention_sm90.cu").read_text()
    for old, new in VARIANTS[name] + (_STAMPS if traced else []):
        if src.count(old) != 1:
            raise ValueError(f"probe_flash: variant {name}: the kernel source no longer holds "
                             f"{old[:60]!r} once; update the variant")
        src = src.replace(old, new)
    return src


def _build(names: list[str]) -> dict[str, ctypes.CDLL]:
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        traced = name == "traced"
        cu = BUILD / f"{name}.cu"
        cu.write_text(variant_source("kernel" if traced else name, traced))
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(BUILD / f"lib{name}.so"),
               str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            sys.exit(f"probe_flash: nvcc failed for {name}:\n{log}")
        lib = libs[name] = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_sm90_fwd.argtypes = [p] * 4 + [i] * 6 + [ll] * 9 + [i, i, i, p]
        lib.flash_attention_sm90_fwd.restype = ctypes.c_int
    return libs


def _turns(lib) -> dict:
    buf = (ctypes.c_longlong * (2 * 64 * 6))()
    if lib.probe_turns(buf) != 0:
        sys.exit("probe_flash: reading the turn stamps failed")
    t = np.frombuffer(buf, dtype=np.int64).reshape(2, 64, 6)[:, 2:30]  # steady turns
    parts = ("wait_stage", "wait_turn", "issue", "wait_products", "softmax")
    out = {"period": float(np.median(np.diff(t[:, :, 0], axis=1)))}
    out.update({name: float(np.median(t[:, :, k + 1] - t[:, :, k]))
                for k, name in enumerate(parts)})
    return out


def _blocks(lib, n_blocks: int) -> dict:
    buf = (ctypes.c_longlong * (4096 * 7))()
    if lib.probe_blocks(buf) != 0:
        sys.exit("probe_flash: reading the block stamps failed")
    a = np.frombuffer(buf, dtype=np.int64).reshape(4096, 7)[:n_blocks]
    gaps = []
    for sm in np.unique(a[:, 0]):
        r = a[a[:, 0] == sm]
        r = r[np.argsort(r[:, 1])]
        gaps.append(float(np.sum(r[1:, 1] - r[:-1, 4])) / 1e3)
    return {"span_us": float(a[:, 4].max() - a[:, 1].min()) / 1e3,
            "prologue_us": float(np.median(a[:, 2] - a[:, 1])) / 1e3,
            "loop_us": float(np.median(a[:, 3] - a[:, 2])) / 1e3,
            "last_turn_and_store_us": float(np.median(a[:, 4] - a[:, 3])) / 1e3,
            "block_us": float(np.median(a[:, 4] - a[:, 1])) / 1e3,
            "gaps_between_blocks_us_per_sm": float(np.mean(gaps)),
            "sm_mhz": float(np.median((a[:, 6] - a[:, 5]) / (a[:, 4] - a[:, 1]) * 1e3))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("probe_flash: needs a CUDA card")
    libs = _build([*VARIANTS, "traced"])
    b, sq, sk, h, kv, dh, causal, window = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, sq, h, dh, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, sk, kv, dh, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, sk, kv, dh, device=dev, generator=gen).bfloat16()
    o = torch.empty_like(q)
    flush = torch.zeros(64 << 20, device=dev)  # 256 MB, past the 50 MB L2

    def launch(name):
        err = libs[name].flash_attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, kv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), window, sk,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            sys.exit(f"probe_flash: {name} failed to launch ({err})")

    def ms(name):
        launch(name)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            flush.add_(1.0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launch(name)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    out = {"device": torch.cuda.get_device_name(0), "shape": list(SHAPE),
           "rounds": [{name: ms(name) for name in VARIANTS} for _ in range(3)]}
    print(f"probe_flash: {out['device']}, q {(b, sq, h, dh)} k/v {(b, sk, kv, dh)} causal "
          f"window {window}; ms a launch by variant, three rounds: {out['rounds']}", flush=True)
    flush.add_(1.0)
    launch("traced")
    torch.cuda.synchronize()
    out["turn_clocks"] = _turns(libs["traced"])
    out["blocks"] = _blocks(libs["traced"], -(-sq * h // kv // 128) * kv * b)
    print(f"probe_flash: a steady turn of block 100 in SM clocks (median): {out['turn_clocks']}",
          flush=True)
    print(f"probe_flash: blocks: {out['blocks']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
