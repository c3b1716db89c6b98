"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each one fails the run when it does not hold; 5 and 8 (c) run
before 4, after which ``kernel_ms``'s traces have come back empty). A
device-only time whose traces hold no kernel of the timed call three times
in a row is taken with CUDA events behind a spin kernel instead
(``_device_ms``); the run logs each such time and lists them at its end:

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compile the CUDA kernels from ``src/repro_torch/csrc/``; log both
   attention kernels', every ``dq_matmul_kernel``'s and every
   ``ql2_kernel``'s registers, shared memory and spills (a spill of either
   attention kernel at any head dim, 256 included, of the matmuls or of
   the distances fails the run; so does a ``setmaxnreg`` that ptxas
   ignored, or float32 ``wgmma`` that it serialized; the bfloat16
   head-dim-256 kernel's registers a warpgroup after it are printed), and
   check in the SASS (``cuobjdump``; none found fails the run) that no
   integer-to-float conversion instruction turns codes into floats in
   ``dq_matmul_kernel`` and that every ``flash_attn_tf32``, at all five
   head dims, runs its products as ``HGMMA`` on tf32 operands.
3. Kernels against their plain PyTorch versions, on the card, at the shapes
   the main path gives them; prints one ``{"kernels": [...]}`` line with
   launches, errors, times and bounds. Times are host-inclusive (CUDA
   events around one Python call, ``ms``) and, for the matmuls, their
   ``torch.matmul`` yardstick and ``quantized_l2``, also device-only
   (kernel durations from a ``torch.profiler`` trace, ``device_ms`` and
   ``library_device_ms``; one ``ql2_kernel`` a call, bit-identical on
   repeat). Beside ``quantized_l2``: what the save path's host-to-device
   copies would take, of the codes (which a CUDA index now keeps on the
   card) and of the queries (host float64, converted to float32 and
   uploaded on every call).
4. Main path at full width (internlm2-1.8b widths, depth cut to 2 layers):
   save a random base decoder and a seeded fine-tune through
   ``StorageEngine(device="cuda")`` (HNSW distance blocks through
   ``quantized_l2`` on the indexes' device mirrors: the code bytes each
   save uploads, for rows entering an index and for whole indexes read
   from disk, are printed and checked, and at the end every mirror is held
   equal to its index's host arrays), load the fine-tune at ``bits=8`` and
   ``bits=4`` and greedy-decode through ``CompressedModel`` (every matmul through
   ``dequant_matmul``/``_int4``), checked against the materialized forward;
   one more decode at each width is traced (``profile_steps``: the card's
   busy share and the ``dq_matmul`` kernels' share of it).
5. ``flash_attention`` against its plain version on the card, on both
   routes: the shapes of the reference's kernel tests and the internlm2
   prefill shape in float32 (the split-tf32 tensor-core kernel) and in
   bfloat16 (the bf16 tensor-core kernel), and one 8192-token prompt in
   bfloat16; the same test shapes at head dim 256 and recurrentgemma-9b's
   prefill shape (q (1, 8192, 16, 256), k/v (1, 8192, 1, 256), causal,
   window 2048) on both routes (bfloat16: 128-row blocks, two consumer
   warpgroups taking turns on the tensor cores; float32: split tf32 on the
   tensor cores, 64-row blocks), each with kernel, plain, bound and
   ``scaled_dot_product_attention`` times; at both prefill shapes also
   device-only (``profile_steps.kernel_rounds_ms``, the median over the
   traced rounds), taken right after the host-inclusive time and before
   the plain and library runs; the card's SM clock, power and temperature
   once, after the bfloat16 head-dim-256 kernel's; at head dim 256 the
   K/V tile bytes a launch loads (from the grid and the tile plan): in
   bfloat16 at 128-row and at 64-row blocks, in float32 at the float32
   kernel's 64-row blocks. The float32 bound
   is three tf32 products an operation at the tf32 rate (one misses the
   tolerance), with the float32 CUDA-core figure beside it.
6. The model stack at the full widths and depth of internlm2-1.8b (24
   layers, bfloat16, random weights from ``SEED``): ``make_prefill_step`` on
   4 x 2048 prompts (24 ``flash_attention`` launches, all on the bfloat16
   tensor-core route), checked against the same prefill on the plain
   attention (per layer, and in the last-token logits against the library
   attention's distance); ``make_serve_step`` greedy decode of 16 tokens
   at batch 4; in float32, the 4 x 2048 prefill again (24 launches, all on
   the float32 route), timed and checked against the same prefill on the
   plain attention, and the forward's logits (24 launches on the float32
   route) against a ``decode_step`` loop over a 32-token prompt.
8. Training (internlm2-1.8b widths). (a) ``make_train_step`` at the full
   depth (24 layers, bfloat16, remat) on 4 x 2048 ``SyntheticLM`` batches,
   5 steps: ms, tokens/s, loss, peak memory and the bfloat16
   ``flash_attention`` launches of each (48: forward and remat's
   recompute), the step's operations and bound; the loss must be finite
   and fall. (e) One more step traced (``profile_steps.trace_train_step``).
   (b) ``loss_fn``'s value and gradients at 4 layers in float32 on the
   kernel route against the plain attention (autograd of
   ``ref.flash_attention``), held to ``GRAD_LOSS_RTOL`` and
   ``GRAD_LEAF_RTOL``; the same in bfloat16 printed. (c) The attention's
   forward + backward alone at the train shape, bfloat16 and float32,
   against autograd of the plain version, timed host-inclusive and
   device-only beside ``scaled_dot_product_attention``'s forward +
   backward. (d) ``Trainer`` at ``TRAINER_LAYERS`` layer: 3 steps with an
   async checkpoint and the final one, its losses held to the same steps
   on the plain attention (``TRAINER_LOSS_RTOL``), a second ``Trainer`` on
   the same store that resumes (step, params and moments held to
   ``RESTORE_ATOL``), then ``ModelServer`` generating from the last
   checkpoint: its parameters held to the trained ones (``RESTORE_ATOL``),
   its tokens and logits to the in-memory decode of the trained ones; and
   the same checkpoint loaded at ``bits=8``: its load seconds, tokens/s and
   the share of its tokens equal to the ``bits=None`` decode.
9. The store service (run right after phase 4, on its engine and store):
   ``ModelStoreServer`` with a tenant quota and the default admission
   policy, driven through ``StoreClient``: an HTTP upload of a second
   fine-tune (every tensor a delta, ``quantized_l2`` launched from the
   handler thread, no rows uploaded to the mirrors), its download at
   ``bits=None``, 8 and 4, each byte-identical to the engine's own load
   (run beside it), a quota rejection, the stats, accounting and metrics
   routes (the request counters equal the requests made), an upload of new
   bases, its delete and an admin vacuum that compacts the card's index
   mirrors (bytes uploaded for the clones and the card's peak memory
   printed), then ``STORE_READERS`` concurrent readers of the fine-tune,
   byte-identical, while a second such upload is saved and deleted and the
   maintenance daemon (as ``python -m repro_torch.server`` runs it)
   vacuums it, the mirrors held equal to their host arrays after each;
   the port's ``nstat --url`` against the server, in this process (the
   ``neurstore_server_requests_total`` series it renders equal to the
   requests made); then ``python -m repro_torch.server`` on the same store
   in a subprocess: its serving line, ``/v1/healthz``, and exit 0 on
   SIGINT; then the port's ``fsck --accounting`` on the store, on the card
   (clean, no drift; the check's and the cross-check's seconds and the
   page bytes checked printed).

10. The model zoo (run right after phase 6), each model built on the card
   by ``init_params`` from ``SEED`` and freed before the next, driven
   through ``make_prefill_step`` and ``make_serve_step``: (a)
   recurrentgemma-9b as published (38 layers, bf16): one 8192-token
   prefill (12 bf16 ``flash_attention`` launches at head dim 256, counted;
   the kernel held to ``FA_BF16_TOL`` on every attention layer's own
   inputs; the last-token logits against the prefill on the plain
   attention within ``ZOO_LOGITS_ATOL``, beside the library attention's
   and a single-bf16-p control's distances), then 16 greedy serve steps
   at batch 4; (b) rwkv6-7b as published (no kernel on its path), (c)
   granite-moe-3b-a800m as published (the tokens capacity dropped
   printed) and (d) arctic-480b at its widths, depth cut from 35 layers to
   1: a 4 x 2048 prefill and 16 serve steps each; (e) in float32, one
   model at a time, recurrentgemma-9b (its local attention on the float32
   head-dim-256 kernel), rwkv6-7b and granite-moe (capacity factor
   ``ZOO_F32_CAPACITY``, so no token drops) at full depth: the forward's
   logits over a 32-token prompt against a ``decode_step`` loop within
   ``CONSISTENCY_TOL``; (f) one traced prefill of recurrentgemma-9b (its
   8192-token prompt) and of rwkv6-7b (4 x 512, ``ZOO_TRACE``)
   (``profile_steps.trace_prefill``: busy share, top kernels, the scans'
   share against the attention's and the GEMMs').

11. Host-quantized serving and the gradient sync (run after phase 10, at
   internlm2-1.8b widths, depth cut to ``HOSTQ_LAYERS`` = 2 layers, bf16):
   (a) ``launch.compressed_serve.quantize_params`` on the host (leaves
   quantized and raw, storage-format bytes against the bfloat16 bytes and
   seconds; every leaf but the norms must be quantized); (b) the tree placed
   on the card, each leaf's float32 ``dequantize_leaf`` there bit-identical
   to the CPU's, each bfloat16 reconstruction within ``HOSTQ_BINS`` delta
   bins plus one bfloat16 rounding of the original; (c)
   ``make_compressed_serve_step`` for 16 greedy steps at batch 4, its
   tokens equal to ``make_serve_step``'s over the reconstructed parameters
   (the share equal to the original parameters' loop and both step times
   printed); (d) ``loss_fn``'s gradients on one 2 x 512 ``SyntheticLM``
   batch through ``distributed.compression.cross_pod_sync`` over a
   world-size-1 NCCL group and a ``("pod",)`` ``DeviceMesh``, every leaf
   bit-identical to the CPU's ``dequantize_grad(quantize_grad(g, 0))``,
   the new error ``g32 - deq`` within half a scale, codes in [-127, 127],
   and the reference test's 50-step 4-bit error-feedback loop on one real
   leaf within its atol (``EF_ATOL``); the sync's ms and bytes printed.

13. The operator tools and the examples (run right after phase 9): a
   few-MB store of four fine-tunes saved on the card, damaged (one page
   corrupt, a torn journal tail, a corrupt ``meta.json`` beside a good
   ``.prev``) and repaired by the port's ``fsck --repair --drop-corrupt``
   on the card: clean after, the models it keeps bit-identical to their
   loads before the damage; then ``quickstart`` (one ``dequant_matmul``
   launch), ``finetune_dedup`` (saves on ``quantized_l2``) and
   ``serve_compressed`` through their ``main()``, their numbers checked.

12. The pod-mesh layer (run after phase 11), over a world-size-1 NCCL
   group on a (1, 1) ("data", "model") and a (1, 1, 1) ("pod", "data",
   "model") ``DeviceMesh``, under the ``"tp"`` and ``"dp"`` rule tables:
   (a) ``launch.shardings.sharded`` around ``make_train_step`` at
   internlm2-1.8b's widths cut to ``POD_LAYERS`` layers (bf16, remat),
   params and AdamW moments as DTensors placed by the spec trees, 3 steps
   on 4 x 2048 ``SyntheticLM`` batches: each step's loss, params and
   moments bit-identical to the unsharded step's (4 bf16
   ``flash_attention`` launches a step, counted), ms a step of both; (b)
   the serving path at glm4-9b's widths cut to 2 layers: a sharded 4 x 512
   ``make_prefill_step`` (its first token and logits) and 16 greedy
   sharded ``make_serve_step`` tokens over a cache placed by
   ``cache_specs_tree``, the logits, tokens and final cache bit-identical
   to the unsharded path's. Under ``"tp"`` each runs, named so, on the
   tensor-parallel route (DTensor activations over ``model``, every
   attention launch through the ``local_map`` seam, counted) and on the
   gathered route, in turns, each route's median ms printed. (d) The
   recurrent models on the (1, 1) mesh under ``"tp"``, on both routes in
   turns: recurrentgemma-9b at one period (rglru, rglru, local_attn) and
   rwkv6-7b at 2 layers, bf16, remat, 2 train steps on 4 x 2048 batches
   (the vocabulary cut to ``POD_RECURRENT_TRAIN_VOCAB``), the 4 x 512
   prefill and 16 serve steps, each step's loss, params and moments and
   the final cache held to the unsharded path's by a digest of each
   leaf's bits, the prefill logits and tokens bit for bit;
   recurrentgemma's bf16 dh-256 ``flash_attention`` launches counted, on
   the tp route every one through the seam. (c)
   ``launch.train.restore_sharded`` of a smoke-size checkpoint
   the phase writes, every placed leaf bit-identical to the unsharded
   restore. Its seconds beside ``POD_BUDGET_S``.

The run prints phase 10's seconds beside its budget (``ZOO_BUDGET_S``) and
its own beside ``SCRIPT_BUDGET_S``.
Each path's launch counts are set to 0 just before it and read just after;
the run fails unless every kernel was launched on some path. The inputs
each path gives ``flash_attention``, ``quantized_l2`` and the two
``dequant_matmul`` routes are recorded (their shapes, masks and dtype),
and after the path each kernel is held
against its plain version, on random inputs, at every such input that no
earlier phase held. The last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX and nothing of the ``repro`` package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# The H100 SXM data sheet's memory rate and float32 (non-tensor-core) peak;
# other H100 variants use their own memory rate (see _bandwidth).
HBM_SXM = 3.35e12
FP32_PEAK = 67e12
BF16_TC_PEAK = 989e12  # dense bf16 tensor-core rate
TF32_TC_PEAK = 495e12  # dense tf32 tensor-core rate
# tf32 products a float32 operation takes in the float32 attention kernel
# (hi hi + hi lo + lo hi): the least that meets rtol 1e-4 on this card.
F32_SPLIT = 3
# Decode widths of internlm2-1.8b (repro/configs/internlm2_1_8b.py): 24
# layers in the published model, cut to 2 here because the save path is
# host numpy and 24 layers would not fit the run's time limit.
WIDTHS = dict(d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92544)
N_LAYERS = 2
BATCH, PROMPT_LEN, STEPS = 4, 8, 16
# The store service phase: concurrent readers of one model (cut from 4:
# each download of the 2-layer model is 20-40 s of host reconstruction on
# the H100 machine), and the byte quota of tenant t1, below the page of
# its one upload.
STORE_READERS = 2
# How long phase 9 waits for its server to count the requests made before
# it reads the request counters (_await_counted).
COUNTED_DEADLINE_S = 5.0
QUOTA_T1 = 1 << 20
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
# flash_attention shapes (B, Sq, Sk, H, KV, dh, causal, window): those of
# tests/test_kernels.py, in float32 at the reference's rtol 1e-4 / atol 2e-5.
FA_TEST_SHAPES = [(2, 256, 256, 8, 4, 64, True, 0), (1, 256, 256, 4, 1, 128, True, 64),
                  (2, 128, 128, 8, 8, 64, False, 0), (1, 200, 256, 8, 2, 64, True, 0),
                  (1, 384, 384, 16, 16, 80, False, 0), (1, 37, 37, 4, 2, 64, False, 0),
                  (2, 50, 100, 8, 4, 32, False, 0), (1, 100, 50, 4, 4, 64, False, 0)]
# The internlm2-1.8b prefill of phase 6 (one launch per layer) and a long prompt.
FA_PREFILL = (4, 2048, 2048, 16, 8, 128, True, 0)
FA_LONG = (1, 8192, 8192, 16, 8, 128, True, 0)
# The same test shapes at head dim 256, and recurrentgemma-9b's prefill of
# phase 10 (a): one 8192-token prompt, 16 heads of 256 on one KV head, a
# 2048-token window (one launch per local-attention layer, 12 a prefill).
FA_TEST_SHAPES_256 = [shape[:5] + (256,) + shape[6:] for shape in FA_TEST_SHAPES]
FA_RG_PREFILL = (1, 8192, 8192, 16, 1, 256, True, 2048)
# bfloat16 outputs: kernel and plain version both round a float32 result to
# bfloat16; their float32 sums differ in the last bits, so a rounding may
# land one bfloat16 step apart (2^-8 to 2^-7 relative).
FA_BF16_TOL = (1e-2, 1e-5)
# Phase 6 also runs the 24-layer bfloat16 prefill on the plain attention,
# with the kernel held to FA_BF16_TOL on every layer's own inputs. The
# kernel's last-token logits must land within FA_LOGITS_ATOL of the plain
# prefill's, with the same argmax on every row whose top-2 margin exceeds
# it. On an H100 the kernel's logits landed 0.1289 from the plain ones and
# a control that rounds p to bfloat16 once (_single_bf16_p) 0.1797; the
# limit lies between the two.
FA_LOGITS_ATOL = 0.15
PREFILL_BATCH, PREFILL_LEN = 4, 2048
CONSISTENCY_LEN = 32
# float32 forward (flash_attention) against the decode loop (plain attention
# over the cache) at 24 layers, and the float32 4 x 2048 prefill against the
# same prefill on the plain attention. With an IEEE float32 attention kernel
# the forward's logits (|x| up to about 5) agreed with the decode loop within
# 2.8e-5 on an H100, so 1e-3 left a margin of about 36x. The reference's
# test_prefill_decode_consistency holds 2e-2 / 2e-3, far looser than that.
CONSISTENCY_TOL = (1e-3, 1e-3)
# Phase 11 (host-quantized serving and gradient sync): internlm2-1.8b widths,
# depth cut from 24 layers to 2. The block weights are stacked (n_layers,
# ...) and a leaf is quantized only when its dim 0 is even (the int4 delta
# packs two rows of dim 0 to a byte), so at 1 layer every block weight
# would stay raw. quantize_params is host numpy, a thread a leaf: on the
# H100 machine's host it took 16.8 s for the 505 M parameters of 2 layers
# (34.4 s one leaf at a time; the embedding and the LM head are 379 M of
# them, and each is one leaf); at 24 layers it would take minutes.
HOSTQ_LAYERS = 2
# (b): a bfloat16 reconstruction against its original value w. The stored
# delta keeps the 4 most significant bits of a 2^-23-step code whose zero
# point extract_msb truncates as well (core/quantize.py), so the float32
# reconstruction lies within 1.5 delta bins (ds) of w, not the half bin of a
# plain bin-centre code (1.469 ds on the CPU at internlm2's shapes); the
# float32 roundings on the way add under 2^-13 ds, and the cast one
# bfloat16 rounding, at most 2^-8 of the value.
HOSTQ_BINS = 1.5 * (1 + 2.0 ** -7)
# (d): the gradients of loss_fn on one SyntheticLM batch, and the reference's
# error-feedback test (tests/test_checkpoint.py): 50 steps at 4 bits, the
# time-averaged transmitted gradient within EF_ATOL of the true one, on a
# real gradient leaf scaled to the same amax as that test's data (the
# loop's error is at most amax / (2 (2^(nbit-1) - 1) EF_STEPS), so at that
# amax the atol means what it means there).
HOSTQ_GRAD_BATCH, HOSTQ_GRAD_LEN = 2, 512
EF_STEPS, EF_NBIT, EF_ATOL = 50, 4, 2e-5
EF_LEAF = "periods//slot0//seq//wq"
# Phase 12 (the pod-mesh layer): the sharded train step at internlm2-1.8b's
# widths and the sharded serve path at glm4-9b's (d_model 4096, 32 heads on
# 2 KV heads of 128, d_ff 13,696, vocab 151,552), both cut to 2 layers, bf16,
# on meshes of one rank over a world-size-1 NCCL group. The serve path: a
# 4 x 512 prefill (its first token), then 16 greedy serve steps at batch 4.
# Each mesh under each rule table. Under the "tp" tables each step runs on
# both routes, asked for by name (launch.shardings.compute_route takes the
# gathered one on a model axis of one rank unless "tp" is asked for), in
# POD_TURNS turns on the (1, 1) mesh and one on (1, 1, 1): "tp" (DTensor
# activations over the model axis, the attention kernel behind the
# local_map seam) and "gathered" (weights gathered whole, local tensors).
# Every gather, reduce and partial sum is the identity at one rank, so
# every route must give the unsharded step's bits: losses, params and
# moments, prefill logits, tokens and cache.
POD_LAYERS, POD_TRAIN_STEPS, POD_PREFILL = 2, 3, (4, 512)
POD_MESHES = (((1, 1), ("data", "model")), ((1, 1, 1), ("pod", "data", "model")))
POD_PROFILES = ("tp", "dp")
POD_TURNS = 2
POD_BUDGET_S = 45.0
# Phase 12 (d): the recurrent models at their widths on the (1, 1) mesh under
# the "tp" table, bf16, remat: recurrentgemma-9b at one period (rglru, rglru,
# local_attn; no tail: d_rnn 4096, 16 heads of 256 on 1 KV head, window
# 2048, d_ff 12,288, vocab 256,000) and rwkv6-7b at 2 layers (64 heads of
# 64, d_ff 14,336, vocab 65,536); POD_RECURRENT_STEPS train steps on 4 x 2048
# batches and the serve path of (b), on both routes in POD_TURNS turns. The
# train steps cut the vocabulary to POD_RECURRENT_TRAIN_VOCAB: at 256,000
# the embedding and the head are 2.1 B of recurrentgemma's 2.75 B
# parameters, and AdamW's new float32 moments and its temporaries beside the
# old state (27.5 GB) and the gradients come to about 80 GB. The states are
# held by each leaf's digest (_digest): two of them, beside a step's own,
# do not fit on the card.
POD_RECURRENT = {"recurrentgemma-9b": dict(n_layers=3, tail=(), tail_mix=()),
                 "rwkv6-7b": dict(n_layers=2)}
POD_RECURRENT_STEPS, POD_RECURRENT_TRAIN_VOCAB = 2, 65_536
# Phase 10 (the model zoo): (batch, prompt length) of each prefill, and
# arctic-480b's depth: its 35 layers (477 B parameters) cannot be held on
# one card; one layer's 128 experts and dense residual are 14.07 B (28.1 GB
# in bf16).
ZOO_PREFILL = {"recurrentgemma-9b": (1, 8192), "rwkv6-7b": (4, 2048),
               "granite-moe-3b-a800m": (4, 2048), "arctic-480b": (4, 2048)}
ZOO_LAYERS = {"arctic-480b": 1}
# Phase 10 (f): the traced prefills, (batch, prompt length). rwkv6-7b's is
# cut from its 4 x 2048 prefill to 4 x 512: on an H100 machine the profiler
# took about 45 s to gather the 74,765 kernels of the 4 x 2048 prefill, and
# the host-bound phases 4 and 9 ran up to 25 % slower on one host than on
# another, which the run's 1,200 s limit cannot absorb. The 4 x 2048
# trace's numbers are in PERF.md.
ZOO_TRACE = {"recurrentgemma-9b": (1, 8192), "rwkv6-7b": (4, 512)}
# recurrentgemma-9b's last-token logits on the kernel against the prefill on
# the plain attention (38 layers, 12 of them attention), set as
# FA_LOGITS_ATOL was: on an H100 the kernel's logits landed 0.1406 from the
# plain ones, the library attention's 0.1367 and the single-bf16-p
# control's 0.1484; the limit lies between the kernel and
# the control. Most of the distance is the 26 RG-LRU layers' bf16 rounding,
# which all three share.
ZOO_LOGITS_ATOL = 0.147
# Phase 10 (e): rwkv6-7b at random weights is ill-conditioned in float32: its
# forward moves about as far under a one-rounding change of its input
# embeddings (2^-24 relative noise; printed beside) as its decode loop sits
# from it (3.0 against 2.6 at 32 layers on an H100): a property of the
# model at random weights, not of the port, whose forward and decode are
# the reference's (tests/test_torch_zoo.py). Each of its layers is held to
# CONSISTENCY_TOL at that layer's own inputs instead (every model's layers
# are); the whole-model distance is printed.
ZOO_F32_LAYERWISE_ONLY = ("rwkv6-7b",)
# Phase 10 (e): granite-moe in float32 at a capacity factor at which no token
# drops. Decode routes one token at a time and never drops one, so a drop
# in the forward would differ from the decode loop legitimately; the
# reference's smoke configs use 8.0 for the same reason.
ZOO_F32_CAPACITY = 8.0
# Phase 10's and the whole script's time budgets, printed beside the times
# (the run's limit is 1,200 s).
ZOO_BUDGET_S, SCRIPT_BUDGET_S = 150.0, 1100.0
# Phase 8 (training). (a): internlm2-1.8b as published (24 layers, bf16,
# remat), make_train_step on 4 x 2048 SyntheticLM batches at the Trainer's
# default learning rate. About 1.89 B parameters: bf16 params and grads and
# float32 m and v come to about 22.7 GB, the float32 logits to 3.0 GB.
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_LR = 4, 2048, 5, 3e-4
# (b): loss_fn's value and gradients at the same widths in float32, kernel
# route against the plain attention, at a cut depth. The kernel route runs
# the kernel forward and ref.flash_attention_backward; the plain route is
# autograd of ref.flash_attention, which shares no code with that backward.
# The loss within GRAD_LOSS_RTOL, every gradient leaf within GRAD_LEAF_RTOL
# relative L2 error (||g - g_ref|| / ||g_ref||): the float32 kernel sits
# within rtol 1e-4 of the plain attention.
GRAD_LAYERS, GRAD_LOSS_RTOL, GRAD_LEAF_RTOL = 4, 1e-5, 1e-3
# (d): the Trainer at internlm2 widths, depth cut to 1 layer: each
# checkpoint save of params, m and v is host numpy (on the H100 machine's
# host 128-171 s at 2 layers, 88-130 s at 1), most of it the embedding and
# the LM head.
TRAINER_LAYERS, TRAINER_BATCH, TRAINER_LEN = 1, 2, 512
# The Trainer's losses against the same steps replayed on the plain
# attention (its step_fn, init and batches), relative. A step lowers the
# loss by 3e-3 to 7e-3 relative at this size (11.921, 11.881, 11.803 on an
# H100), so a Trainer that skipped an update or took another batch or rate
# misses this; (b)'s bfloat16 loss sat 3.2e-7 from the plain one.
TRAINER_LOSS_RTOL = 1e-3
# The served logits against the in-memory decode of the trained parameters,
# relative L2 a step. The restored tensors equal the trained ones within
# RESTORE_ATOL, but the bfloat16 decode over them rounds its logits
# differently (on an H100: 2.9e-3 relative L2, one logit 3.1e-2 off, past
# rtol/atol 2^-7 elementwise); a bfloat16 rounding step is 2^-8 to 2^-7
# of a value. A restore that swapped, dropped or misplaced a tensor moves
# them by far more.
SERVED_LOGITS_RTOL = 2.0 ** -8
# A restored leaf against the trained one: the store reconstructs float32
# within 2^-23 (its default tolerance 2^-24; the reference's round-trip
# test), and a bfloat16 leaf is the bfloat16 nearest that value, at most
# 2^-23 further from it.
RESTORE_ATOL = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -22}


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


# Device times that came from CUDA events because the profiler's trace
# held no kernel of the timed call (_device_ms): (what, the trace's error).
EVENT_TIMED: list[tuple[str, str]] = []


def _device_ms(fn, reps: int, flush: torch.Tensor, match: str | None = None,
               rounds: list | None = None) -> float:
    """Median device ms of ``fn`` a run, host issue left out: the summed
    durations of the kernels it launches (those named with ``match``)
    between L2 flushes, from a ``torch.profiler`` trace
    (``profile_steps.kernel_rounds_ms``; each round's ms is appended to
    ``rounds`` when given). Where three traces in a row come back
    without the timed kernels (as one did on an H100 machine before any
    model ran), it is timed with CUDA events behind a spin kernel instead
    (``profile_steps.queued_event_ms``: all of ``fn``'s kernels and the
    gaps between them), and the fall-back is logged and listed in
    ``EVENT_TIMED``."""
    from repro_torch.launch.profile_steps import kernel_rounds_ms, queued_event_ms

    try:
        per = kernel_rounds_ms(fn, reps, lambda: flush.add_(1.0), match)
        if rounds is not None:
            rounds.extend(per)
        return float(np.median(per))
    except RuntimeError as exc:
        ms = queued_event_ms(fn, reps, lambda: flush.add_(1.0))
        what = getattr(fn, "__qualname__", "?") + (f" ({match})" if match else "")
        EVENT_TIMED.append((what, str(exc)))
        log(f"device time of {what}: the profiler's trace missed it ({exc}); "
            f"{ms:.6f} ms from CUDA events behind a spin kernel instead")
        return ms


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> tuple[float, float]:
    """(max abs error, max of |err| / (atol + rtol |want|)): the second is
    <= 1 exactly when allclose(got, want, rtol, atol) holds."""
    err = (got.double() - want.double()).abs()
    ratio = err / (atol + rtol * want.double().abs())
    return float(err.max()), float(ratio.max())


def _fa_key(q, k, causal, window, sk_true) -> tuple:
    return tuple(q.shape), tuple(k.shape), bool(causal), int(window), sk_true, q.dtype


@contextlib.contextmanager
def _recording():
    """The distinct inputs the kernels get inside the block, through the
    seams the model stack, the HNSW index and the compressed matmuls reach
    them by (``ops.flash_attention``, ``ops.quantized_l2``,
    ``ops.dequant_matmul``, ``ops.dequant_matmul_int4``): ``{"flash_attention":
    {_fa_key}, "quantized_l2": {(B, N, D)}, "dequant_matmul": {(M, K, N,
    packed)}}``. The calls pass through."""
    from repro_torch.kernels import ops

    seen = {"flash_attention": set(), "quantized_l2": set(), "dequant_matmul": set()}
    fa, ql2 = ops.flash_attention, ops.quantized_l2
    dq8, dq4 = ops.dequant_matmul, ops.dequant_matmul_int4

    def flash_attention(q, k, v, *, causal=True, window=0, sk_true=None, **kw):
        seen["flash_attention"].add(_fa_key(q, k, causal, window, sk_true))
        return fa(q, k, v, causal=causal, window=window, sk_true=sk_true, **kw)

    def quantized_l2(queries, codes, *rest):
        seen["quantized_l2"].add((queries.shape[0], *codes.shape))
        return ql2(queries, codes, *rest)

    def dequant_matmul(x, base, *rest):
        seen["dequant_matmul"].add((x.shape[0], *base.shape, False))
        return dq8(x, base, *rest)

    def dequant_matmul_int4(x, base, *rest):
        seen["dequant_matmul"].add((x.shape[0], *base.shape, True))
        return dq4(x, base, *rest)

    ops.flash_attention, ops.quantized_l2 = flash_attention, quantized_l2
    ops.dequant_matmul, ops.dequant_matmul_int4 = dequant_matmul, dequant_matmul_int4
    try:
        yield seen
    finally:
        ops.flash_attention, ops.quantized_l2 = fa, ql2
        ops.dequant_matmul, ops.dequant_matmul_int4 = dq8, dq4


def _hold_matmul(m: int, k: int, n: int, packed: bool, rng) -> tuple[float, float]:
    """``dequant_matmul`` (int8 delta) or ``dequant_matmul_int4`` (packed
    delta) against its plain version at (M, K) x (K, N), on random codes
    and phase 3's quantization parameters: (max abs err, allclose ratio at
    rtol 1e-4, atol 1e-5 x the output's largest magnitude)."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
    base = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev)
    if packed:
        delta = ops.pack_int4(torch.from_numpy(rng.integers(0, 16, (k, n), dtype=np.uint8)).to(dev))
        args = (x, base, 0.013, -11.0, delta, 5e-4, 8.0)
        got, want = ops.dequant_matmul_int4(*args), ref.dequant_matmul_int4(*args)
    else:
        delta = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev)
        args = (x, base, 0.013, -11.0, delta, 3.1e-4, -64.0)
        got, want = ops.dequant_matmul(*args), ref.dequant_matmul(*args)
    torch.cuda.synchronize()
    scale = float(want.abs().max()) + 1e-6
    abs_err, ratio = _close(got, want, 1e-4, 1e-5 * scale)
    if not torch.isfinite(got).all():
        ratio = float("inf")
    return abs_err, ratio


def _hold_recorded(label: str, seen: dict, held: dict, entries: list) -> None:
    """Hold ``flash_attention``, ``quantized_l2`` and the two
    ``dequant_matmul`` routes against their plain versions at every input
    shape a main path gave them (``_recording``)
    that no phase has held yet, on random inputs from ``SEED``. Run after
    the path's counts were read: these launches count on no path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst = {}
    for key in sorted(seen["flash_attention"] - held["flash_attention"], key=str):
        q_shape, k_shape, causal, window, sk_true, dtype = key
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in (q_shape, k_shape, k_shape))
        got = fa.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        want = ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        rtol, atol = (1e-4, 2e-5) if dtype == torch.float32 else FA_BF16_TOL
        abs_err, ratio = _close(got, want, rtol, atol)
        line = (f"{label}: flash_attention held at the path's q {q_shape} k/v {k_shape} "
                f"causal={causal} window={window} sk_true={sk_true} {dtype}: max abs err "
                f"{abs_err:.3e}, allclose ratio {ratio:.3f} (rtol {rtol}, atol {atol})")
        if got.dtype != dtype or not torch.isfinite(got).all() or ratio > 1.0:
            fail(line)
        log(line)
        entry = "flash_attention_dh256" if q_shape[-1] == 256 else "flash_attention"
        worst[entry] = max(worst.get(entry, 0.0), abs_err)
        held["flash_attention"].add(key)
        del q, k, v, got, want
    for b, n, d in sorted(seen["quantized_l2"] - held["quantized_l2"]):
        q = torch.randn(d, generator=gen, device=dev) + torch.randn(
            b, d, generator=gen, device=dev) * (0.01 * torch.arange(1, b + 1, device=dev)[:, None])
        codes = torch.empty((n, d), dtype=torch.uint8, device=dev).random_(generator=gen)
        f64 = dict(dtype=torch.float64, device=dev)
        scales = 1e-3 + 1.9e-2 * torch.rand(n, generator=gen, **f64)
        if n > 1:
            scales[n - 1] = 0.0  # a constant row
        zps = torch.randint(0, 256, (n,), generator=gen, **f64)
        mids = 0.5 * torch.randn(n, generator=gen, **f64)
        abs_err, ratio = _hold_l2((q, codes, scales, zps, mids))
        log(f"{label}: quantized_l2 held at the path's B={b} N={n} D={d}: max abs err "
            f"{abs_err:.3e}, ratio {ratio:.3f} (rtol 2e-3), same argmin")
        worst["quantized_l2"] = max(worst.get("quantized_l2", 0.0), abs_err)
        held["quantized_l2"].add((b, n, d))
        del q, codes
    rng = np.random.default_rng(SEED + 10)
    for m, k, n, packed in sorted(seen["dequant_matmul"] - held["dequant_matmul"]):
        name = "dequant_matmul_int4" if packed else "dequant_matmul"
        abs_err, ratio = _hold_matmul(m, k, n, packed, rng)
        line = (f"{label}: {name} held at the path's M={m} K={k} N={n}: max abs err "
                f"{abs_err:.3e}, allclose ratio {ratio:.3f} (rtol 1e-4, atol 1e-5 x max |y|)")
        if ratio > 1.0:
            fail(line)
        log(line)
        worst[name] = max(worst.get(name, 0.0), abs_err)
        held["dequant_matmul"].add((m, k, n, packed))
    for e in entries:
        if e["name"] in worst:
            e["max_abs_err"] = max(e["max_abs_err"], worst[e["name"]])
    torch.cuda.empty_cache()


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


def _ptxas(log_text: str, pattern: str) -> dict[str, dict]:
    """``ptxas -v``'s registers, static shared memory and spill bytes for
    each kernel of an ``nvcc`` log whose mangled name matches ``pattern``,
    keyed by the pattern's first group (the template arguments)."""
    out, key = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(pattern, line)
            key = m.group(1) if m else None
            if key is not None:
                out[key] = {}
        elif key is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes (stack frame|spill stores|spill loads)", line)
            out[key].update({k.replace(" ", "_"): int(v) for v, k in nums})
        elif key is not None and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[key]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump``, or the copy in Triton's package."""
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(c) for c in cands if c.is_file()), None)


def _sass_count(lib: Path, kernel: str, matches) -> dict[str, int] | None:
    """Instructions of the SASS of each function of ``lib`` whose name
    holds ``kernel`` for which ``matches(line)`` holds, by mangled name;
    None when no ``cuobjdump`` is found."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name is not None:
                out[name] = 0
        elif name is not None and matches(line):
            out[name] += 1
    return out


def _sass_conversions(lib: Path, kernel: str) -> dict[str, int] | None:
    """Integer-to-float conversions of values (``I2F``, ``I2FP``) in the
    SASS of each ``kernel`` function of ``lib``. ``I2F.RP`` is not
    counted: it is the reciprocal step of an integer division by a value
    known only at run time (the launch plan's strides), never a code."""
    return _sass_count(lib, kernel,
                       lambda line: re.search(r"\bI2F", line) and ".RP " not in line)


def phase_build() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {list(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.3f} s "
        f"({_build.BUILD_DIR.relative_to(ROOT)})")
    sm90_log = _build.build_log("flash_attention_sm90")
    stats = {int(k): v for k, v in _ptxas(sm90_log, r"flash_attn_sm90ILi(\d+)E").items()}
    lib = fa._library("flash_attention_sm90")
    for dh, st in sorted(stats.items()):
        st["dynamic_smem_bytes"] = lib.flash_attention_sm90_smem_bytes(dh)
        # Registers a thread after setmaxnreg (head dim 256): ptxas reports
        # the launch's allocation; the producer warpgroup then gives up
        # registers to the two consumer warpgroups.
        regs = [lib.flash_attention_sm90_setmaxnreg(dh, role) for role in (0, 1)]
        log(f"ptxas: flash_attn_sm90<{dh}>: {st}"
            + (f"; registers a thread after setmaxnreg: producer warpgroup {regs[0]}, "
               f"each of the 2 consumer warpgroups {regs[1]} (128 x {regs[0]} + 256 x "
               f"{regs[1]} = {128 * regs[0] + 256 * regs[1]} of 65536)" if regs[0] else ""))
    spilled = {d: st for d, st in stats.items() if st.get("spill_stores") or st.get("spill_loads")}
    if sorted(stats) != list(fa.HEAD_DIMS) or spilled:
        fail(f"flash_attn_sm90 build: head dims {sorted(stats)} in the ptxas log, "
             f"spills {spilled}")
    # ptxas ignores setmaxnreg where it cannot tell a warpgroup's registers
    # (C7508), and serializes wgmma where it cannot keep their registers apart.
    warned = [line.strip() for line in sm90_log.splitlines() if "warning" in line.lower()]
    for line in warned:
        log(f"ptxas warning (flash_attention_sm90.cu): {line}")
    if any("setmaxnreg" in line for line in warned):
        fail("flash_attn_sm90 build: ptxas ignored setmaxnreg")
    # The float32 route: the split-tf32 kernel at every head dim (256 with a
    # layout of its own: 64-row blocks, K/V by TMA, a converter and one
    # consumer warpgroup, no setmaxnreg).
    log32 = _build.build_log("flash_attention")
    f32 = {int(k): v for k, v in _ptxas(log32, r"flash_attn_tf32ILi(\d+)E").items()}
    lib32 = fa._library("flash_attention")
    for dh, st in sorted(f32.items()):
        st["dynamic_smem_bytes"] = lib32.flash_attention_smem_bytes(dh)
        log(f"ptxas: flash_attn_tf32<{dh}>: {st}")
    spilled = {d: st for d, st in f32.items() if st.get("spill_stores") or st.get("spill_loads")}
    if sorted(f32) != list(fa.HEAD_DIMS) or spilled:
        fail(f"flash_attention (float32) build: tf32 head dims {sorted(f32)} in the ptxas log, "
             f"spills {spilled}")
    # ptxas serializes every wgmma of a kernel where a non-wgmma instruction
    # touches registers of one in flight (C7514, an info line, no warning).
    warned = [line.strip() for line in log32.splitlines()
              if "warning" in line.lower() or "Performance Loss" in line]
    for line in warned:
        log(f"ptxas warning (flash_attention.cu): {line}")
    if any("setmaxnreg" in line or "serialized" in line for line in warned):
        fail("flash_attn_tf32 build: ptxas ignored setmaxnreg or serialized wgmma")
    hgmma = _sass_count(_build.library_path("flash_attention"), "flash_attn_tf32",
                        lambda line: "HGMMA" in line and "TF32" in line)
    if hgmma is None:
        fail("flash_attn_tf32 SASS: no cuobjdump found (CUDA toolkit or Triton's package), "
             "so the tf32 products cannot be checked")
    log(f"sass: HGMMA on tf32 operands in each flash_attn_tf32: {hgmma}")
    if len(hgmma) != len(fa.HEAD_DIMS) or not all(hgmma.values()):
        fail(f"flash_attn_tf32 SASS: tf32 HGMMA instructions {hgmma} (want all "
             f"{len(fa.HEAD_DIMS)} head dims)")
    dq = _ptxas(_build.build_log("dequant_matmul"), r"dq_matmul_kernelI(\w+?)EEv")
    for args, st in sorted(dq.items()):
        log(f"ptxas: dq_matmul_kernel<{args}>: {st}")
    spilled = {a: st for a, st in dq.items() if st.get("spill_stores") or st.get("spill_loads")}
    if not dq or spilled:
        fail(f"dq_matmul_kernel build: {len(dq)} kernels in the ptxas log, spills {spilled}")
    l2 = _ptxas(_build.build_log("quantized_l2"), r"ql2_kernelI(\w+?)EEv")
    for args, st in sorted(l2.items()):
        log(f"ptxas: ql2_kernel<{args}>: {st}")
    spilled = {a: st for a, st in l2.items() if st.get("spill_stores") or st.get("spill_loads")}
    if len(l2) != 4 or spilled:
        fail(f"ql2_kernel build: {len(l2)} kernels in the ptxas log (want 4), spills {spilled}")
    conv = _sass_conversions(_build.library_path("dequant_matmul"), "dq_matmul_kernel")
    if conv is None:
        fail("dq_matmul_kernel SASS: no cuobjdump found (CUDA toolkit or Triton's package), "
             "so the integer-to-float conversions cannot be checked")
    log(f"sass: I2F/I2FP conversions (I2F.RP of integer divisions aside) in each "
        f"dq_matmul_kernel: {conv}")
    if not conv or any(conv.values()):
        fail(f"dq_matmul_kernel SASS: integer-to-float conversions {conv}")
    return {"bfloat16": stats[FA_PREFILL[5]], "float32": f32[FA_PREFILL[5]],
            "bfloat16_dh256": stats[256], "float32_dh256": f32[256]}


def _hold_l2(args) -> tuple[float, float]:
    """``quantized_l2``'s kernel against its plain version on ``args``
    (queries, codes, scales, zps, mids on the card): within rtol 2e-3, the
    same argmin, bit-identical on a repeat. Returns (max abs err, ratio).
    The plain version runs on a few code rows at a time (each row's
    distances are its own), so its float64 temporaries stay under 2^28
    elements at any N."""
    from repro_torch.kernels import ops, ref

    q, codes = args[0], args[1]
    (b, d), n = q.shape, codes.shape[0]
    got = ops.quantized_l2(*args)
    again = ops.quantized_l2(*args)
    rows = max(1, (1 << 28) // d)
    want = torch.cat([ref.quantized_l2(q, *(a[i:i + rows] for a in args[1:]))
                      for i in range(0, n, rows)], dim=1)
    torch.cuda.synchronize()
    abs_err, ratio = _close(got, want, 2e-3, 0.0)
    if (not torch.isfinite(got).all() or ratio > 1.0 or not torch.equal(got, again)
            or not torch.equal(got.argmin(dim=1), want.argmin(dim=1))):
        fail(f"quantized_l2 B={b} N={n} D={d}: max abs err {abs_err:.3e}, "
             f"rel ratio {ratio:.3f} (rtol 2e-3), argmin "
             f"{got.argmin(dim=1).tolist()} vs {want.argmin(dim=1).tolist()}, "
             f"bit-identical on repeat {torch.equal(got, again)}")
    return abs_err, ratio


def phase_kernels(dev_info: dict, held: dict) -> list[dict]:
    from repro_torch.kernels import ops, ref

    bw = dev_info["bandwidth"]
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    flush = torch.zeros(64 << 20, dtype=torch.float32, device=dev)  # 256 MB > L2
    entries = []

    # ---- dequant_matmul (int8 delta) and dequant_matmul_int4 (packed delta)
    for name, packed in (("dequant_matmul", False), ("dequant_matmul_int4", True)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
               "library_device_ms": 0.0, "bytes": 0, "flops": 0}
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
            held["dequant_matmul"].add((BATCH, k, n, packed))
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
            dev_ms = _device_ms(lambda: fn(*args), 20, flush, "dq_matmul_kernel")
            lib_dev_ms = _device_ms(lambda: torch.matmul(x, w), 20, flush)
            del w
            nbytes = k * n * (1.5 if packed else 2) + BATCH * (k + n) * 4
            # float32 operations: 5 to dequantize each weight, 2 per row of x.
            flops = k * n * (5 + 2 * BATCH)
            mult = MATMUL_PER_STEP[(k, n)]
            bound = max(nbytes / bw, flops / FP32_PEAK) * 1e3
            log(f"shape: {name} M={BATCH} K={k} N={n} x{mult}/step: ms {ms:.6f} "
                f"device_ms {dev_ms:.6f} plain {plain_ms:.6f} library {lib_ms:.6f} "
                f"library_device_ms {lib_dev_ms:.6f} bound {bound:.6f} "
                f"({bound / dev_ms:.4f} of it on the device) "
                f"abs_err {abs_err:.3e} ratio {ratio:.3f}")
            max_abs = max(max_abs, abs_err)
            tot["ms"] += mult * ms
            tot["plain_ms"] += mult * plain_ms
            tot["library_ms"] += mult * lib_ms
            tot["device_ms"] += mult * dev_ms
            tot["library_device_ms"] += mult * lib_dev_ms
            tot["bytes"] += mult * nbytes
            tot["flops"] += mult * flops
        t_bytes, t_ops = tot["bytes"] / bw * 1e3, tot["flops"] / FP32_PEAK * 1e3
        log(f"{name} per decode step (15 calls): ms {tot['ms']:.6f} (library "
            f"{tot['library_ms']:.6f}), device_ms {tot['device_ms']:.6f} (library "
            f"{tot['library_device_ms']:.6f}), bound {max(t_bytes, t_ops):.6f}")
        entries.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/dequant_matmul.cu",
            "replaces": ("src/repro/kernels/dequant_matmul.py:135" if packed
                         else "src/repro/kernels/dequant_matmul.py:60"),
            "launches": 0, "max_abs_err": max_abs, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"], "device_ms": tot["device_ms"],
            "library_device_ms": tot["library_device_ms"],
        })

    # ---- quantized_l2
    from repro_torch.kernels.ops import _tensor

    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "copy_ms": 0.0,
           "query_copy_ms": 0.0, "bytes": 0, "flops": 0}
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
        abs_err, ratio = _hold_l2(args)
        held["quantized_l2"].add((b, n, d))

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
        # One ql2_kernel a call: kernel_ms fails on any other count.
        dev_ms = _device_ms(lambda: ops.quantized_l2(*args), 10, flush, "ql2_kernel")
        plain_ms = _time_ms(lambda: ref.quantized_l2(*args), 3, flush)
        lib_ms = _time_ms(library, 5, flush)
        # The save path's copies: the codes (a CUDA index now keeps them on
        # the card) and the queries, host float64 -> float32 -> the card.
        copy_ms = _time_ms(lambda: torch.from_numpy(codes_host).to(dev), 3, flush)
        q_host64 = q_host.astype(np.float64)
        query_copy_ms = _time_ms(lambda: _tensor(q_host64, np.float32, torch.float32, dev), 3,
                                 flush)
        nbytes = n * d + b * d * 4
        flops = 2 * b * n * d  # float32 c·q FMAs (the integer moments are cheaper)
        bound = max(nbytes / bw, flops / FP32_PEAK) * 1e3
        log(f"shape: quantized_l2 B={b} N={n} D={d} x{mult}/save: ms {ms:.6f} "
            f"device_ms {dev_ms:.6f} plain {plain_ms:.6f} library {lib_ms:.6f} bound "
            f"{bound:.6f} ({bound / dev_ms:.4f} of it on the device) "
            f"host_to_device_codes_ms {copy_ms:.6f} host_to_device_queries_ms "
            f"{query_copy_ms:.6f} abs_err {abs_err:.3e} ratio {ratio:.3f}")
        max_abs = max(max_abs, abs_err)
        tot["ms"] += mult * ms
        tot["device_ms"] += mult * dev_ms
        tot["plain_ms"] += mult * plain_ms
        tot["library_ms"] += mult * lib_ms
        tot["copy_ms"] += mult * copy_ms
        tot["query_copy_ms"] += mult * query_copy_ms
        tot["bytes"] += mult * nbytes
        tot["flops"] += mult * flops
        del q, codes, args, q_host64
    t_bytes, t_ops = tot["bytes"] / bw * 1e3, tot["flops"] / FP32_PEAK * 1e3
    log(f"quantized_l2 per fine-tune save: kernel {tot['ms']:.6f} ms, device_ms "
        f"{tot['device_ms']:.6f} ({max(t_bytes, t_ops) / tot['device_ms']:.4f} of the "
        f"{max(t_bytes, t_ops):.6f} ms bound); host-to-device copies the save path would "
        f"make: codes {tot['copy_ms']:.6f} ms (none now: the index keeps them on the card), "
        f"queries {tot['query_copy_ms']:.6f} ms (float64 -> float32 on the host, then the copy)")
    entries.append({
        "name": "quantized_l2", "route": "cuda", "source": "src/repro_torch/csrc/quantized_l2.cu",
        "replaces": "src/repro/kernels/quantized_l2.py:82", "launches": 0,
        "max_abs_err": max_abs, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": tot["library_ms"], "device_ms": tot["device_ms"],
        "host_to_device_codes_ms": tot["copy_ms"],
        "host_to_device_queries_ms": tot["query_copy_ms"],
    })
    del flush
    torch.cuda.empty_cache()
    return entries


def _attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the work this input needs."""
    q = np.arange(sq)
    hi = np.minimum(sk, q + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _sdpa(q, k, v, causal: bool, window: int):
    """The library yardstick: one scaled_dot_product_attention call in its
    (B, H, S, dh) layout on views of the same tensors (never on the port's
    path)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window > 0:
        qp = torch.arange(q.shape[1], device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (qp - kp < window) & ((qp >= kp) if causal else True)
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                enable_gqa=True)
    return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                            enable_gqa=True)


def _single_bf16_p(q, k, v, *, causal=True, window=0, sk_true=None):
    """Phase 6's control: the plain attention with p = exp(s - max) rounded
    once to bfloat16 before p @ v, as FlashAttention-2 and -3 round it
    (float32 sums; l from the unrounded p). Never on the port's path."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh).float()
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) / dh ** 0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = kp < (sk if sk_true is None else sk_true)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bkgqc,bckd->bkgqd", p.to(torch.bfloat16).float(), v.float())
    o = o / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def phase_flash_attention(dev_info: dict, ptxas: dict, held: dict) -> list[dict]:
    """Phase 5: both routes against the plain version, with times. Returns
    the kernel-line entries of the head dims up to 128 (per internlm2-1.8b
    prefill) and of head dim 256 (per recurrentgemma-9b prefill)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.profile_steps import card_state

    bw = dev_info["bandwidth"]
    rng = np.random.default_rng(SEED + 5)
    dev = torch.device("cuda")
    flush = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
    cases = [(shape, dtype) for dtype in (torch.float32, torch.bfloat16)
             for shape in FA_TEST_SHAPES + [FA_PREFILL] + FA_TEST_SHAPES_256 + [FA_RG_PREFILL]]
    cases.append((FA_LONG, torch.bfloat16))
    max_abs, main = {128: 0.0, 256: 0.0}, {}
    device_kernels = {(FA_PREFILL, torch.bfloat16): "flash_attn_sm90",
                      (FA_PREFILL, torch.float32): "flash_attn_tf32",
                      (FA_RG_PREFILL, torch.bfloat16): "flash_attn_sm90",
                      (FA_RG_PREFILL, torch.float32): "flash_attn_tf32"}
    for shape, dtype in cases:
        b, sq, sk, h, kv, dh, causal, window = shape
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, s, n, dh)).astype(np.float32))
                   .to(dev, dtype) for s, n in ((sq, h), (sk, kv), (sk, kv)))
        route, key = fa.ROUTES[dtype], f"flash_attention_{str(dtype).split('.')[1]}"
        before = ops.launch_counts()[key]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        rtol, atol = (1e-4, 2e-5) if dtype == torch.float32 else FA_BF16_TOL
        abs_err, ratio = _close(got, want, rtol, atol)
        name = f"flash_attention B={b} Sq={sq} Sk={sk} H={h} KV={kv} dh={dh} " \
               f"causal={causal} window={window} {str(dtype).split('.')[1]}"
        if (got.dtype != dtype or not torch.isfinite(got).all() or ratio > 1.0
                or ops.launch_counts()[key] != before + 1):
            fail(f"{name}: max abs err {abs_err:.3e}, allclose ratio {ratio:.3f} "
                 f"(rtol {rtol}, atol {atol}); route {route} launches "
                 f"{ops.launch_counts()[key] - before}")
        held["flash_attention"].add(_fa_key(q, k, causal, window, None))
        big = sq * sk >= 1 << 22
        call = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        kname = device_kernels.get((shape, dtype))
        dev_ms = lib_dev_ms = None
        if kname is None:
            ms = _time_ms(call, 10 if big else 20, flush)
        else:
            # Host-inclusive, then device-only, back to back before the
            # plain version's and the library's long runs; each is a median
            # over its runs. The card's state is read once in the phase,
            # right after the bfloat16 head-dim-256 kernel's.
            rounds = []
            ms = _time_ms(call, 10, flush)
            dev_ms = _device_ms(call, 10, flush, kname, rounds)
            smi = card_state() if (shape, dtype) == (FA_RG_PREFILL, torch.bfloat16) else None
            log(f"timing: {name}: host-inclusive {ms:.6f} ms, device-only {dev_ms:.6f} ms"
                + (f" (traced rounds {min(rounds):.6f}-{max(rounds):.6f})" if rounds else "")
                + f"; device-only <= host-inclusive: {dev_ms <= ms}"
                + ("" if smi is None else f"; nvidia-smi clocks.sm, power.draw, temperature "
                   f"[{smi}]"))
        plain_ms = _time_ms(lambda: ref.flash_attention(q, k, v, causal=causal, window=window),
                            3 if big else 10, flush)
        lib_ms = _time_ms(lambda: _sdpa(q, k, v, causal, window), 10 if big else 20, flush)
        esize = q.element_size()
        nbytes = (2 * b * sq * h + 2 * b * sk * kv) * dh * esize
        flops = 4 * b * h * dh * _attention_pairs(sq, sk, causal, window)
        # The bound takes the card's tensor-core peak for the operand type.
        # bfloat16: the work the inputs need (the kernel splits p into hi +
        # lo, so it issues 1.5x these operations; printed as its own figure).
        # float32: one tf32 product misses rtol 1e-4, so the least work that
        # meets it is three (hi hi + hi lo + lo hi) for each; the float32
        # CUDA-core figure of earlier slices is printed beside it.
        if dtype == torch.bfloat16:
            t_ops, peak_note = flops / BF16_TC_PEAK, f"{BF16_TC_PEAK / 1e12:.0f} TFLOP/s bf16"
        else:
            t_ops = F32_SPLIT * flops / TF32_TC_PEAK
            peak_note = (f"{F32_SPLIT} x the operations at {TF32_TC_PEAK / 1e12:.0f} TFLOP/s "
                         f"tf32; {flops / FP32_PEAK * 1e3:.6f} at the "
                         f"{FP32_PEAK / 1e12:.0f} TFLOP/s float32 CUDA-core peak")
        bound = max(nbytes / bw, t_ops) * 1e3
        if kname is not None:
            lib_dev_ms = _device_ms(lambda: _sdpa(q, k, v, causal, window), 10, flush)
        if dh == 256 and esize == 4:
            # The float32 kernel's 64-row blocks each read their tiles' K and
            # V once, as float32 (from L2), and split them on chip.
            f32_tiles = fa.kv_tile_bytes(b, sq, sk, h, kv, dh, causal=causal, window=window,
                                         block_rows=fa.F32_DH256_BLOCK_ROWS, elem_bytes=4)
            t = dev_ms or ms
            log(f"K/V tiles: {name}: {f32_tiles} bytes a launch at "
                f"{fa.F32_DH256_BLOCK_ROWS}-row blocks ({f32_tiles / t / 1e9:.3f} TB/s over the "
                f"{'device-only' if dev_ms else 'host-inclusive'} {t:.6f} ms); issued tf32 "
                f"operations {F32_SPLIT * flops:.4e} ({F32_SPLIT * flops / t / 1e9:.3f} TFLOP/s, "
                f"{F32_SPLIT * flops / t / 1e9 / (TF32_TC_PEAK / 1e12):.4f} of the tf32 peak)")
        if dh == 256 and esize == 2:
            # The K/V tiles a launch loads (from L2: one slab's K and V fit
            # there), from the grid and each block's key-tile range, at this
            # kernel's 128-row blocks and at the 64-row blocks of the
            # head-dim-256 kernel before it.
            tile_bytes = {rows: fa.kv_tile_bytes(b, sq, sk, h, kv, dh, causal=causal,
                                                 window=window, block_rows=rows)
                          for rows in (fa.BLOCK_ROWS, 64)}
            t = dev_ms or ms
            log(f"K/V tiles: {name}: {tile_bytes[fa.BLOCK_ROWS]} bytes a launch at "
                f"{fa.BLOCK_ROWS}-row blocks ({tile_bytes[fa.BLOCK_ROWS] / t / 1e9:.3f} TB/s "
                f"over the {'device-only' if dev_ms else 'host-inclusive'} {t:.6f} ms), "
                f"{tile_bytes[64]} at the 64-row blocks of the kernel before; issued "
                f"operations {1.5 * flops:.4e} ({1.5 * flops / t / 1e9:.3f} TFLOP/s, "
                f"{1.5 * flops / t / 1e9 / (BF16_TC_PEAK / 1e12):.4f} of the bf16 peak)")
        log(f"shape: {name} [{route}]: ms {ms:.6f}"
            + ("" if dev_ms is None else f" device_ms {dev_ms:.6f} (library {lib_dev_ms:.6f})")
            + f" plain {plain_ms:.6f} library {lib_ms:.6f} bound {bound:.6f} ({peak_note}; "
            f"{bound / (dev_ms or ms):.4f} of it) achieved {flops / ms / 1e9:.3f} TFLOP/s of "
            f"the work the inputs need"
            + (f", {1.5 * flops / ms / 1e9:.3f} issued with the split p" if esize == 2
               else f", {F32_SPLIT * flops / ms / 1e9:.3f} tf32 issued")
            + f"; kernel/library {ms / lib_ms:.3f}; abs_err {abs_err:.3e} ratio {ratio:.3f} "
            f"(rtol {rtol} atol {atol})")
        max_abs[256 if dh == 256 else 128] = max(max_abs[256 if dh == 256 else 128], abs_err)
        if kname is not None:
            main[shape, dtype] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bytes": nbytes, "flops": flops, "bound_ms": bound,
                           "bound_by": "bytes" if nbytes / bw >= t_ops else "operations",
                           "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        del q, k, v, got, want
    del flush
    torch.cuda.empty_cache()
    # Per internlm2-1.8b prefill: one launch per layer at the prefill shape.
    n = _internlm2().n_layers
    bf, f32 = main[FA_PREFILL, torch.bfloat16], main[FA_PREFILL, torch.float32]
    t_bytes, t_ops = n * bf["bytes"] / bw * 1e3, n * bf["flops"] / BF16_TC_PEAK * 1e3
    fp32_core_ms = n * f32["flops"] / FP32_PEAK * 1e3
    log(f"flash_attention per prefill ({n} launches at {FA_PREFILL}): bfloat16 tensor-core "
        f"kernel {n * bf['ms']:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms on the "
        f"{n * bf['flops']} operations the inputs need (the split p issues "
        f"{n * bf['flops'] // 2} more); float32 tf32 kernel {n * f32['ms']:.6f} ms "
        f"host-inclusive, {n * f32['device_ms']:.6f} device-only, bound "
        f"{n * f32['bound_ms']:.6f} ms ({F32_SPLIT} tf32 products for each operation at "
        f"{TF32_TC_PEAK / 1e12:.0f} TFLOP/s; {fp32_core_ms:.6f} at the float32 CUDA-core "
        f"peak), {n * f32['bound_ms'] / (n * f32['device_ms']):.4f} of it on the device")
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79", "launches": 0,
        "max_abs_err": max_abs[128], "ms": n * bf["ms"], "plain_ms": n * bf["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": n * bf["library_ms"],
        "ms_per_launch": bf["ms"],
        "ptxas_dh128": ptxas["bfloat16"], "f32_ptxas_dh128": ptxas["float32"],
        "device_ms": n * bf["device_ms"], "library_device_ms": n * bf["library_device_ms"],
        "f32_source": "src/repro_torch/csrc/flash_attention.cu",
        "f32_ms": n * f32["ms"], "f32_plain_ms": n * f32["plain_ms"],
        "f32_library_ms": n * f32["library_ms"], "f32_bound_ms": n * f32["bound_ms"],
        "f32_bound_by": f32["bound_by"], "f32_device_ms": n * f32["device_ms"],
        "f32_library_device_ms": n * f32["library_device_ms"],
        "f32_fp32_core_bound_ms": fp32_core_ms, "f32_ms_per_launch": f32["ms"],
        "f32_device_ms_per_launch": f32["device_ms"],
    }
    # Per recurrentgemma-9b prefill: one launch per local-attention layer.
    n = sum(kind == "local_attn" for kind, _ in _zoo_config("recurrentgemma-9b").layer_types())
    bf, f32 = main[FA_RG_PREFILL, torch.bfloat16], main[FA_RG_PREFILL, torch.float32]
    fp32_core_ms = n * f32["flops"] / FP32_PEAK * 1e3
    log(f"flash_attention per recurrentgemma-9b prefill ({n} launches at {FA_RG_PREFILL}): "
        f"bfloat16 kernel {n * bf['ms']:.6f} ms host-inclusive, {n * bf['device_ms']:.6f} "
        f"device-only, bound {n * bf['bound_ms']:.6f} ms, library {n * bf['library_ms']:.6f}; "
        f"float32 kernel (split tf32 on the tensor cores) {n * f32['ms']:.6f} ms "
        f"host-inclusive, {n * f32['device_ms']:.6f} device-only, bound "
        f"{n * f32['bound_ms']:.6f} ms "
        f"({F32_SPLIT} tf32 products for each operation; {fp32_core_ms:.6f} at the float32 "
        f"CUDA-core peak), library {n * f32['library_ms']:.6f}")
    entry256 = {
        "name": "flash_attention_dh256", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79", "launches": 0,
        "max_abs_err": max_abs[256], "ms": n * bf["ms"], "plain_ms": n * bf["plain_ms"],
        "bound_ms": n * bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": n * bf["library_ms"], "ms_per_launch": bf["ms"],
        "device_ms": n * bf["device_ms"], "library_device_ms": n * bf["library_device_ms"],
        "ptxas": ptxas["bfloat16_dh256"], "device_ms_per_launch": bf["device_ms"],
        "f32_source": "src/repro_torch/csrc/flash_attention.cu",
        "f32_kernel": "flash_attn_tf32<256>",
        "f32_ms": n * f32["ms"], "f32_plain_ms": n * f32["plain_ms"],
        "f32_library_ms": n * f32["library_ms"], "f32_bound_ms": n * f32["bound_ms"],
        "f32_bound_by": f32["bound_by"], "f32_device_ms": n * f32["device_ms"],
        "f32_library_device_ms": n * f32["library_device_ms"],
        "f32_fp32_core_bound_ms": fp32_core_ms, "f32_ms_per_launch": f32["ms"],
        "f32_device_ms_per_launch": f32["device_ms"], "f32_ptxas": ptxas["float32_dh256"],
    }
    return [entry, entry256]


def _finetune(tensors: dict, seed: int) -> dict:
    """The base plus seeded noise of 1e-3 x each tensor's std, as host
    float32 arrays. The noise is drawn on the card: drawn by numpy on the
    host, phase 4's 505 M weights took about 13 s a fine-tune."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for k, v in tensors.items():
        t = torch.from_numpy(v).to("cuda")
        noise = torch.randn(t.shape, generator=gen, device="cuda")
        out[k] = noise.mul_(1e-3 * t.std(correction=0)).add_(t).cpu().numpy()
        del t, noise
    return out


def _decode_checked(eng, spec, prompt, bits: int, bw: float) -> dict:
    from repro_torch.core import CompressedModel
    from repro_torch.core.loader import LoadedModel
    from repro_torch.kernels import ops
    from repro_torch.launch.compressed_serve import MaterializedProvider, greedy_decode
    from repro_torch.launch.profile_steps import trace_compressed_decode

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
    # The steady-state step traced (one more decode, after the checks above).
    tr = trace_compressed_decode(provider, spec, prompt, STEPS,
                                 plain_ms=decode_s / n_steps * 1e3)
    log(f"trace bits={bits} (a step): plain {tr['plain_wall_ms']:.6f} ms, profiled "
        f"{tr['wall_ms']:.6f} ms, device busy {tr['device_busy_ms']:.6f} ms ("
        f"{tr['busy_share_of_plain']:.4f} of the plain step, idle "
        f"{1 - tr['busy_share_of_plain']:.4f}), {tr['kernels']:.1f} kernels and "
        f"{tr['host_ops']:.1f} host ops, median gap {tr['median_gap_us']:.3f} us; "
        f"dq_matmul {tr['match_ms']:.6f} ms, {tr['match_share_of_busy']:.4f} of busy; top "
        + ", ".join(f"{k['name'][:40]} {k['ms']:.4f} ms x{k['count']:.0f}"
                    for k in tr["top_kernels"][:4]))
    provider.close()

    # The materialized forward on the card over the same bits view.
    lm_ref = eng.load_model("ft", bits=bits)
    mat = MaterializedProvider(lm_ref)
    want_tokens, want_logits = greedy_decode(mat, spec, prompt, STEPS, return_logits=True)
    mat.close()
    del mat
    if logits.shape != (BATCH, STEPS, spec.vocab_size) or not torch.isfinite(logits).all():
        fail(f"bits={bits}: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    compared = _check_tokens(f"bits={bits}", tokens, want_tokens, want_logits, 1e-4,
                             got_logits=logits)
    tok_s = BATCH * STEPS / decode_s
    ms_step = decode_s / n_steps * 1e3
    log(f"decode bits={bits}: load {load_s:.6f} s (open + operand upload + first decode), "
        f"{tok_s:.6f} tokens/s, {ms_step:.6f} ms/step over {n_steps} steps of batch {BATCH}; "
        f"{kernel} launches {launched[kernel]} = matmul_calls {matmul_calls}; "
        f"weight-operand bytes/step {bytes_step:.0f} ({matmul_bytes} matmul operand bytes), "
        f"bound {bytes_step / bw * 1e6:.6f} us at {bw / 1e12:.2f} TB/s; "
        f"logits match the materialized forward over {compared} steps")
    return {"launches": launched, "tokens": tokens.cpu()}


def _uploads(what: str, before: dict, want_rows: int | None) -> None:
    """Log (and check) the code bytes the index mirrors uploaded since
    ``before``: rows entering an index must be ``want_rows`` bytes; a
    whole-index upload (an index read from disk, or a vacuum's clone) gets
    its own line."""
    from repro_torch.core.hnsw import mirror_uploads

    rows = mirror_uploads["rows"] - before["rows"]
    index = mirror_uploads["index"] - before["index"]
    log(f"{what}: code bytes uploaded to the card for rows entering an index {rows}"
        + ("" if want_rows is None else f" (want {want_rows})"))
    if index:
        log(f"{what}: code bytes uploaded to the card for whole indexes (read from disk "
            f"or cloned) {index}")
    if want_rows is not None and rows != want_rows:
        fail(f"{what}: {rows} code bytes uploaded for entering rows, want {want_rows}")


def _check_mirrors(eng) -> tuple[int, int, int]:
    """Every index's device mirror equals its host arrays (torch.equal);
    returns the rows checked, their code bytes and the code bytes the
    mirrors hold on the card (their capacity: it doubles, as the host's)."""
    checked = used = held = 0
    for dim in eng.index_cache.dims():
        idx = eng.index_cache.get(dim)
        n = len(idx)
        host = (idx._codes[:n], idx._scales[:n], idx._zps[:n].astype(np.float64), idx._mids[:n])
        for name, dev_rows, want in zip(idx.mirror.FIELDS, idx.mirror.view(n), host):
            if not torch.equal(dev_rows.cpu(), torch.from_numpy(want)):
                fail(f"index dim {dim}: the device mirror's {name} differ from the host's")
        checked += n
        used += n * dim
        held += idx.mirror.codes.numel()
    return checked, used, held


def phase_main_path(dev_info: dict, keep: dict) -> dict[str, int]:
    """Phase 4. Leaves its engine open in ``keep`` (``eng``, ``spec``, the
    store's ``tmp`` directory and the ``base`` tensors) for the store
    service phase, which closes it."""
    from repro_torch.core import StorageEngine
    from repro_torch.core.hnsw import mirror_uploads
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
    ft = _finetune(base, SEED + 1)
    n_weights = sum(v.size for k, v in base.items() if k != "model.embed_tokens.weight"
                    and v.ndim == 2)
    log(f"weights: {sum(v.size for v in base.values())} elements, {n_weights} in matmuls; "
        f"made in {time.perf_counter() - t0:.3f} s")
    prompt = np.random.default_rng(SEED + 2).integers(0, spec.vocab_size, (BATCH, PROMPT_LEN))
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_store_")
    root = tmp.name
    # The main path: every count starts at 0 here and is read at the end.
    ops.reset_launch_counts()
    eng = StorageEngine(root, device="cuda")
    up = dict(mirror_uploads)
    rep = eng.save_model("base", decoder_architecture(spec), base)
    log(f"save base: {rep.seconds:.6f} s, {rep.n_new_bases} new bases, "
        f"{rep.n_deltas} deltas, page {rep.page_bytes} bytes; "
        f"quantized_l2 launches {ops.launch_counts()['quantized_l2']}")
    _uploads("save base", up, sum(ex["dim"] for ex in rep.explain
                                  if ex["outcome"] == "new_base"))
    keep["base"] = base  # phase 9 fine-tunes it again
    del base
    before = ops.launch_counts()["quantized_l2"]
    up = dict(mirror_uploads)
    rep = eng.save_model("ft", decoder_architecture(spec), ft)
    l2 = ops.launch_counts()["quantized_l2"] - before
    outcomes = {ex["tensor"]: ex["outcome"] for ex in rep.explain}
    log(f"save fine-tune: {rep.seconds:.6f} s, {rep.n_new_bases} new bases, "
        f"{rep.n_deltas} deltas, page {rep.page_bytes} bytes, mean nbit "
        f"{rep.mean_nbit:.3f}; quantized_l2 launches {l2}")
    _uploads("save fine-tune", up, 0)
    del ft
    not_delta = {k: v for k, v in outcomes.items() if v != "delta"}
    if not_delta or l2 <= 0:
        fail(f"fine-tune save: non-delta outcomes {not_delta}, quantized_l2 launches {l2}")
    up = dict(mirror_uploads)
    rows, used, held = _check_mirrors(eng)
    _uploads("mirror check", up, 0)
    log(f"index mirrors equal their host arrays: {rows} rows over "
        f"{len(eng.index_cache.dims())} indexes; the mirrors hold {held} code bytes on "
        f"the card for {used} bytes of rows (capacity doubling, at least 8 rows)")
    results = {bits: _decode_checked(eng, spec, prompt, bits, dev_info["bandwidth"])
               for bits in (8, 4)}
    counts = ops.launch_counts()
    keep.update(eng=eng, spec=spec, tmp=tmp)
    log(f"main path launches: {counts}")
    for name in ("dequant_matmul", "dequant_matmul_int4", "quantized_l2"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    first = results[8]["tokens"][:, :4].tolist()
    log(f"tokens bits=8, first 4 per prompt: {first}")
    return counts


def _same_bytes(got: np.ndarray, want: np.ndarray) -> bool:
    """Byte-identical arrays: same dtype, same shape (as the wire frames it:
    contiguous, 0-d as 1-d) and the same bytes."""
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _check_download(what: str, got: dict, want_items) -> int:
    """Hold a download against ``(name, array)`` pairs byte for byte, in
    order; returns the tensor bytes compared."""
    n = count = 0
    names = list(got)
    for count, (name, want) in enumerate(want_items, 1):
        if count > len(names) or names[count - 1] != name or not _same_bytes(got[name], want):
            fail(f"{what}: tensor {name!r} differs from the engine's own load")
        n += want.nbytes
    if count != len(names):
        fail(f"{what}: {len(names)} tensors downloaded, the engine loads {count}")
    return n


def _garbage(eng) -> dict[int, int]:
    """Vertices no catalog entry references, per index dim."""
    out = {}
    for dim in eng.index_cache.dims():
        idx = eng.index_cache.get(dim)
        live = sum(1 for c in eng.catalog.refs_for_dim(dim).values() if c > 0)
        if len(idx) > live:
            out[dim] = len(idx) - live
    return out


def _get(host: str, port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as resp:
        return resp.read().decode("utf-8")


def _serve_cli(store: str, want_models: list[str]) -> None:
    """``python -m repro_torch.server`` on the card: start it on ``store``,
    read its ``serving … on http://…`` line, check ``/v1/healthz`` and the
    listing, then SIGINT; it must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.server", "--store", store, "--port", "0"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            ready, _, _ = select.select([proc.stdout], [], [], 180)
            line = proc.stdout.readline().strip() if ready else ""
            m = re.fullmatch(r"serving (.+) on http://([0-9.]+):(\d+)", line)
            if m is None or m.group(1) != store:
                err.seek(0)
                fail(f"python -m repro_torch.server: no serving line ({line!r}); "
                     f"stderr: {err.read()[-2000:]}")
            host, port = m.group(2), int(m.group(3))
            up_s = time.perf_counter() - t0
            health = json.loads(_get(host, port, "/v1/healthz"))
            models = json.loads(_get(host, port, "/v1/tenants/t0/models"))["models"]
            if not health["ok"] or not health["maintenance"]["running"] or models != want_models:
                fail(f"python -m repro_torch.server: healthz {health}, t0 models {models}")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
            if rc != 0:
                err.seek(0)
                fail(f"python -m repro_torch.server exited {rc}: {err.read()[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    log(f"python -m repro_torch.server --store <phase 4's store>: serving after "
        f"{up_s:.3f} s, healthz ok (maintenance running, read_only {health['read_only']}), "
        f"t0 models {models}, exit 0 on SIGINT after {time.perf_counter() - t0:.3f} s")


def _fetch(client, name: str, bits) -> dict:
    """Start a download on a thread of its own; the returned box gets the
    tensors (``got``) and the seconds (``secs``), or the ``error``."""
    box: dict = {}

    def run():
        t = time.perf_counter()
        try:
            box["got"] = client.load(name, bits=bits).materialize()
        except Exception as exc:  # re-raised by _joined on the main thread
            box["error"] = exc
        box["secs"] = time.perf_counter() - t

    box["thread"] = threading.Thread(target=run, name=f"reader {name} bits={bits}")
    box["thread"].start()
    return box


def _joined(what: str, box: dict) -> tuple[dict, float]:
    box["thread"].join(900)
    if box["thread"].is_alive() or "error" in box:
        fail(f"{what}: the download did not finish: {box.get('error')!r}")
    return box.pop("got"), box["secs"]


def _nstat_requests(url: str) -> tuple[dict, float]:
    """``python -m repro_torch.tools.nstat --url URL``, run in this process:
    the ``neurstore_server_requests_total`` series it renders, by (route,
    method, status), and its seconds."""
    from repro_torch.tools import nstat

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = nstat.main(["--url", url])
    secs = time.perf_counter() - t0
    if rc != 0:
        fail(f"nstat --url {url} exited {rc}")
    rendered = {}
    for line in out.getvalue().splitlines():
        m = re.fullmatch(r"  neurstore_server_requests_total"
                         r"\{method=(\w+),route=([\w.]+),status=(\w+)\} = (\d+)", line)
        if m:
            rendered[m.group(2), m.group(1), m.group(3)] = float(m.group(4))
    return rendered, secs


def _await_counted(requests: Counter) -> None:
    """Wait, at most ``COUNTED_DEADLINE_S``, until the in-process
    registry's ``neurstore_server_requests_total`` shows the ``requests``
    made (by (route, method, status class)): the server's handler counts a
    request after it has written the answer, so a client can read a whole
    answer and scrape before it is counted. The exact comparison after the
    scrape says whether the counters are the requests."""
    from repro_torch.obs.metrics import default_registry, parse_prometheus_text

    t = time.perf_counter()
    while time.perf_counter() - t < COUNTED_DEADLINE_S:
        fam = parse_prometheus_text(default_registry().render()).get(
            "neurstore_server_requests_total", {"samples": []})
        seen = {(s["labels"]["route"], s["labels"]["method"], s["labels"]["status"]): s["value"]
                for s in fam["samples"]}
        if all(seen.get(k, 0.0) >= v for k, v in requests.items()):
            return
        time.sleep(0.01)


def _fsck_accounting(root: str) -> None:
    """``python -m repro_torch.tools.fsck ROOT --accounting`` on the card:
    its check (no engine: page framing and records, index frames parsed
    on the CPU, the reference table) and then its accounting cross-check
    (an engine on the card, its ledger against a page rescan), timed
    apart. The store must be clean (no errors; warnings, states the engine
    handles itself, are printed), with no drift."""
    from repro_torch.tools import fsck

    pages = os.path.join(root, "pages")
    page_bytes = sum(os.path.getsize(os.path.join(pages, f)) for f in os.listdir(pages))
    rep = {"root": root, "errors": [], "warnings": [], "actions": []}
    t0 = time.perf_counter()
    fsck._check(root, rep)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsck._check_accounting(root, rep, device="cuda")
    acct_s = time.perf_counter() - t0
    line = (f"fsck --accounting on phase 4's store: check {check_s:.3f} s over {page_bytes} "
            f"page bytes ({page_bytes / check_s / 1e6:.3f} MB/s), accounting cross-check "
            f"{acct_s:.3f} s; errors {rep['errors']}, warnings {rep['warnings']}")
    if rep["errors"]:
        fail(line)
    log(line)


def phase_store_service(keep: dict) -> dict[str, int]:
    """Phase 9: the store's front door, ``ModelStoreServer`` driven through
    ``StoreClient``, mounted on phase 4's engine and store (upload → dedup
    on ``quantized_l2`` from a handler thread → download at every width →
    quota → stats, accounting and metrics → delete → vacuum of the card's
    index mirrors → concurrent readers beside the maintenance daemon's own
    vacuum), then ``python -m repro_torch.server`` on the same store."""
    from repro_torch.core.hnsw import mirror_uploads
    from repro_torch.kernels import ops
    from repro_torch.launch.compressed_serve import decoder_architecture
    from repro_torch.obs.metrics import parse_prometheus_text
    from repro_torch.server import AdmissionPolicy, ModelStoreServer, QuotaManager, StoreClient
    from repro_torch.store import SaveRequest
    from repro_torch.store.errors import QuotaExceededError

    eng, spec, tmp = keep.pop("eng"), keep.pop("spec"), keep.pop("tmp")
    arch = decoder_architecture(spec)
    log(f"store service: ModelStoreServer on phase 4's engine and store (internlm2-1.8b "
        f"widths, depth cut from 24 to {spec.n_layers} layers: the save path is host numpy); "
        f"{STORE_READERS} concurrent readers (cut from 4 to bound the phase's time); each "
        f"download runs beside the engine's own load of the same model, which it is held to")
    t0 = time.perf_counter()
    ft2 = _finetune(keep.pop("base"), SEED + 3)
    rng = np.random.default_rng(SEED + 4)
    d, f = spec.d_model, spec.d_ff
    kv = spec.n_kv_heads * (d // spec.n_heads)
    # Fresh values at element counts the decoder's indexes hold (MLP, q/o,
    # k/v): each enters an existing index as a new base.
    scratch = {"scratch.mlp": rng.normal(0, 0.02, (d, f)).astype(np.float32),
               "scratch.attn": rng.normal(0, 0.02, (d, d)).astype(np.float32)}
    # Three q/o bases: over the daemon's default dead fraction (0.25) once deleted.
    scratch2 = {f"scratch2.attn{i}": rng.normal(0, 0.02, (d, d)).astype(np.float32)
                for i in range(3)}
    over_quota = {"w": rng.normal(0, 0.02, (d, kv)).astype(np.float32)}
    log(f"store service tensors made in {time.perf_counter() - t0:.3f} s; ft2 "
        f"{sum(v.nbytes for v in ft2.values())} bytes in {len(ft2)} tensors")

    ops.reset_launch_counts()
    launched_in = set()  # (thread name, current device, queries' device) a launch
    seam = ops.quantized_l2

    def quantized_l2(queries, *rest):
        launched_in.add((threading.current_thread().name, torch.cuda.current_device(),
                         str(queries.device)))
        return seam(queries, *rest)

    ops.quantized_l2 = quantized_l2
    quotas = QuotaManager(limits={"t1": QUOTA_T1})
    server = ModelStoreServer(eng, port=0, quotas=quotas, admission=AdmissionPolicy()).start()

    def connect(tenant: str = "t0"):
        return StoreClient(server.host, server.port, tenant=tenant, timeout=900)

    client = connect()
    requests: Counter = Counter()  # (route, method, status class) sent

    def write(route: str, method: str, call):
        """A write that must succeed; returns its result and seconds."""
        t = time.perf_counter()
        out = call()
        requests[route, method, "2xx"] += 1
        return out, time.perf_counter() - t

    try:
        # (2) An HTTP upload of a second fine-tune: every tensor a delta.
        pool = client.stats()
        requests["stats", "GET", "2xx"] += 1
        up = dict(mirror_uploads)
        rep, wall = write("model.upload", "POST",
                          lambda: client.save(SaveRequest("ft2", ft2, architecture=arch)))
        ft2_bytes = sum(v.nbytes for v in ft2.values())
        del ft2
        l2 = ops.launch_counts()["quantized_l2"]
        not_delta = {ex["tensor"]: ex["outcome"] for ex in rep.explain
                     if ex["outcome"] != "delta"}
        log(f"upload t0/ft2: client wall {wall:.6f} s, SaveReport.seconds {rep.seconds:.6f} s "
            f"(wire and HTTP {wall - rep.seconds:.6f} s, {ft2_bytes / wall / 1e6:.3f} MB/s of "
            f"tensors end to end), {rep.n_deltas} deltas of {rep.n_tensors}, page "
            f"{rep.page_bytes} bytes, mean nbit {rep.mean_nbit:.3f}; quantized_l2 launches "
            f"{l2} from {sorted(launched_in)}; the pool at {pool.pool_utilization:.3f} of "
            f"its budget before")
        _uploads("upload t0/ft2", up, 0)
        if not_delta or l2 <= 0 or rep.n_deltas != rep.n_tensors:
            fail(f"upload t0/ft2: non-delta outcomes {not_delta}, quantized_l2 launches {l2}")
        if not launched_in or any(t == "MainThread" or dev != "cuda:0"
                                  for t, _, dev in launched_in):
            fail(f"upload t0/ft2: quantized_l2 launched from {sorted(launched_in)}, "
                 "want handler threads and the card")
        rows = _check_mirrors(eng)[0]
        log(f"index mirrors equal their host arrays after the upload: {rows} rows")

        # (3) Downloads at every width, byte-identical to the engine's own
        # load, which runs on this thread meanwhile.
        keep8 = None
        for bits in (None, 8, 4):
            box = _fetch(client, "ft2", bits)
            t = time.perf_counter()
            lm = eng.load_model("t0/ft2", bits=bits)
            try:
                want = list(lm.iter_tensors())
            finally:
                lm.close()
            own = time.perf_counter() - t
            got, secs = _joined(f"download bits={bits}", box)
            requests["model.download", "GET", "2xx"] += 1
            n = _check_download(f"download bits={bits}", got, want)
            log(f"download t0/ft2 bits={bits}: {secs:.6f} s, {n / secs / 1e6:.3f} MB/s of "
                f"float32 tensors ({n} bytes), byte-identical to eng.load_model (its own "
                f"load beside it {own:.6f} s)")
            if bits == 8:
                keep8 = got
            del got, want

        # (4) A quota rejection, then stats, accounting and the metrics scrape.
        t1 = connect("t1")
        try:
            t1.save(SaveRequest("big", over_quota))
            fail("tenant t1: an upload over its quota was accepted")
        except QuotaExceededError as exc:
            requests["model.upload", "POST", "4xx"] += 1
            log(f"tenant t1 (quota {QUOTA_T1} bytes): upload rejected, {exc}")
        t1.close()
        stats = client.stats()
        requests["stats", "GET", "2xx"] += 1
        acct = client.accounting()
        requests["accounting", "GET", "2xx"] += 1
        _await_counted(requests)
        scraped = parse_prometheus_text(_get(server.host, server.port, "/v1/metrics"))
        served = {(s["labels"]["route"], s["labels"]["method"], s["labels"]["status"]): s["value"]
                  for s in scraped["neurstore_server_requests_total"]["samples"]}
        want = {k: float(v) for k, v in requests.items()}
        if served != want:
            fail(f"neurstore_server_requests_total {served}, requests made {want}")
        if "neurstore_server_admission_rejects_total" not in scraped or \
                stats.models != 3 or "t0" not in acct["per_tenant"]:
            fail(f"stats/accounting/metrics: models {stats.models}, per_tenant "
                 f"{sorted(acct['per_tenant'])}, families {sorted(scraped)}")
        log(f"stats: {stats.models} models, epoch {stats.epoch}, pool "
            f"{stats.pool_resident_bytes}/{stats.pool_budget_bytes} bytes, logical "
            f"{stats.logical_bytes} physical {stats.physical_bytes} bytes (ratio "
            f"{stats.compression_ratio:.6f}); {len(scraped)} metric families; "
            f"neurstore_server_requests_total equals the {sum(requests.values())} requests made")

        # (5) Upload new bases, delete them, vacuum the card's index mirrors.
        up = dict(mirror_uploads)
        rep, wall = write("model.upload", "POST",
                          lambda: client.save(SaveRequest("scratch", scratch)))
        entered = sum(v.size for v in scratch.values())
        log(f"upload t0/scratch: client wall {wall:.6f} s, {rep.n_new_bases} new bases")
        _uploads("upload t0/scratch", up, entered)
        write("model.delete", "DELETE", lambda: client.delete("scratch"))
        garbage = _garbage(eng)
        before = {dim: len(eng.index_cache.get(dim)) for dim in garbage}
        up = dict(mirror_uploads)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vac, secs = write("admin.vacuum", "POST", lambda: client.vacuum(0.0))
        torch.cuda.synchronize()
        peak, mem1 = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        index_bytes = mirror_uploads["index"] - up["index"]
        compacted = sorted(int(k) for k in vac["dims"])
        want_bytes = sum(before[dim] * dim for dim in compacted)
        log(f"vacuum: {secs:.6f} s, compacted dims {compacted} (unreferenced vertices "
            f"{garbage}), {vac['vertices_dropped']} vertices dropped, "
            f"{vac['pages_rewritten']} pages rewritten; index bytes uploaded to the card "
            f"{index_bytes} (the clones, want {want_bytes}); card memory {mem0} bytes "
            f"before, peak {peak} (+{peak - mem0}), {mem1} after")
        _uploads("vacuum", up, 0)
        if compacted != sorted(garbage) or index_bytes != want_bytes or _garbage(eng):
            fail(f"vacuum: compacted {compacted}, unreferenced {garbage} before and "
                 f"{_garbage(eng)} after, index bytes {index_bytes} want {want_bytes}")
        rows = _check_mirrors(eng)[0]
        log(f"index mirrors equal their host arrays after the vacuum: {rows} rows")

        # (6) Concurrent readers of t0/ft2, started after the vacuum, while a
        # second upload of new bases is saved and deleted and the
        # maintenance daemon, as `python -m repro_torch.server` runs it,
        # vacuums it on its own thread.
        readers = [connect() for _ in range(STORE_READERS)]
        boxes = [_fetch(r, "ft2", 8) for r in readers]
        daemon = eng.start_maintenance()
        write("model.upload", "POST", lambda: client.save(SaveRequest("scratch2", scratch2)))
        write("model.delete", "DELETE", lambda: client.delete("scratch2"))
        t = time.perf_counter()
        while _garbage(eng):
            if time.perf_counter() - t > 120 or daemon.errors:
                fail(f"maintenance daemon: unreferenced {_garbage(eng)} after "
                     f"{time.perf_counter() - t:.1f} s, {daemon.stats()}")
            time.sleep(0.1)
        took = time.perf_counter() - t
        daemon.stop()
        results = [_joined(f"concurrent download {i}", b) for i, b in enumerate(boxes)]
        wall = max(secs for _, secs in results)  # they start together
        requests["model.download", "GET", "2xx"] += STORE_READERS
        for r in readers:
            r.close()
        rows = _check_mirrors(eng)[0]
        log(f"maintenance daemon: vacuumed the deleted t0/scratch2's "
            f"{daemon.vacuumed_vertices} vertices {took:.3f} s after the delete; "
            f"{daemon.steps} steps, {daemon.pages_scrubbed} pages scrubbed, {daemon.errors} "
            f"errors; index mirrors equal their host arrays: {rows} rows")
        for i, (got, _) in enumerate(results):
            _check_download(f"concurrent download {i}", got, keep8.items())
        n = sum(v.nbytes for v in keep8.values())
        log(f"{STORE_READERS} concurrent downloads of t0/ft2 bits=8 after the vacuum, beside "
            f"the second upload and the daemon's vacuum: wall {wall:.6f} s "
            f"({STORE_READERS * n / wall / 1e6:.3f} MB/s together), each "
            + ", ".join(f"{secs:.3f}" for _, secs in results) + " s; all byte-identical")
        del results, boxes, keep8

        # (7) The port's nstat scraping the server: the request counters it
        # renders equal the requests made (step (4)'s scrape included).
        requests["metrics", "GET", "2xx"] += 1
        _await_counted(requests)
        rendered, secs = _nstat_requests(f"http://{server.host}:{server.port}")
        want = {k: float(v) for k, v in requests.items()}
        if rendered != want:
            fail(f"nstat --url: neurstore_server_requests_total {rendered}, requests made {want}")
        log(f"nstat --url: {secs:.3f} s; its neurstore_server_requests_total lines equal the "
            f"{sum(requests.values())} requests made, in {len(rendered)} (route, method, "
            f"status) series")
    finally:
        client.close()
        server.stop()
        ops.quantized_l2 = seam
    counts = ops.launch_counts()
    eng.close()
    del eng
    torch.cuda.empty_cache()
    _serve_cli(tmp.name, ["ft2"])
    _fsck_accounting(tmp.name)
    tmp.cleanup()
    return counts


def _damage_and_repair() -> None:
    """Phase 13 (a): a few-MB port store of four fine-tunes of one base,
    saved on the card, then damaged three ways: one model's page corrupt,
    a torn journal tail and a corrupt ``meta.json`` beside a good
    ``.prev`` (the snapshot before the last save). The port's ``fsck
    --repair --drop-corrupt`` on the card must leave it clean, the models
    it could keep loading bit-identically to before the damage."""
    from repro_torch.core import StorageEngine
    from repro_torch.core.catalog import Catalog
    from repro_torch.tools import fsck

    rng = np.random.default_rng(SEED + 20)
    base = {"attn": rng.normal(0, 0.02, (1024, 1024)).astype(np.float32),
            "mlp": rng.normal(0, 0.02, (1024, 512)).astype(np.float32),
            "norm": np.ones(1024, np.float32)}
    names = [f"ft{i}" for i in range(4)]
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_fsck_") as root:
        eng = StorageEngine(root, device="cuda")
        for i, name in enumerate(names):
            eng.save_model(name, {}, _finetune(base, SEED + 21 + i))
        before = {name: eng.load_model(name).materialize() for name in names}
        eng.close()
        pages = os.path.join(root, "pages")
        size = sum(os.path.getsize(os.path.join(pages, f)) for f in os.listdir(pages))
        page = os.path.join(pages, Catalog(root).get("ft1").page)
        for path, at in ((page, os.path.getsize(page) - 4), (os.path.join(root, "meta.json"), 12)):
            with open(path, "r+b") as f:
                f.seek(at)
                byte = f.read(1)[0]
                f.seek(at)
                f.write(bytes([byte ^ 1]))
        with open(os.path.join(root, "journal.jsonl"), "ab") as f:
            f.write(b'{"op": "intent", "tx": 99, "na')
        damaged = fsck.fsck(root)
        t0 = time.perf_counter()
        rep = fsck.fsck(root, repair=True, drop_corrupt=True)
        repair_s = time.perf_counter() - t0
        eng = StorageEngine(root, device="cuda")
        try:
            kept = eng.list_models()
            same = all(np.array_equal(got, before[name][k])
                       for name in kept
                       for k, got in eng.load_model(name).materialize().items())
        finally:
            eng.close()
        line = (f"fsck --repair --drop-corrupt of a damaged {size}-byte store on the card: "
                f"{repair_s:.3f} s; before: {len(damaged['errors'])} errors, "
                f"{len(damaged['warnings'])} warnings; actions {rep['actions']}; after: clean "
                f"{rep['clean']}, warnings {rep['warnings']}; models kept {kept} (the promoted "
                f".prev predates ft3; ft1's page was corrupt), bit-identical to before {same}")
        if damaged["clean"] or not rep["clean"] or kept != ["ft0", "ft2"] or not same:
            fail(line)
        log(line)


def phase_tools_examples() -> dict[str, int]:
    """Phase 13: the operator tools and the examples on the card. (a) A
    damaged store repaired by the port's fsck (``_damage_and_repair``);
    (b) ``quickstart``, ``finetune_dedup`` and ``serve_compressed`` run
    through their ``main()`` in this process, on the card: one
    ``dequant_matmul`` launch on the int8 route, and saves whose distance
    blocks run on ``quantized_l2``; their printed numbers are checked as
    the examples check them, and the kernel inputs they give are held
    against the plain versions after the path (``_recording``)."""
    from repro_torch.examples import finetune_dedup, quickstart, serve_compressed
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    _damage_and_repair()
    secs = {"fsck repair": time.perf_counter() - t_phase}
    results = {}
    for name, example in (("quickstart", quickstart), ("finetune_dedup", finetune_dedup),
                          ("serve_compressed", serve_compressed)):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        results[name] = example.main([])
        secs[name] = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in ops.launch_counts().items() if n > before[k]}
        log(f"example {name}: {secs[name]:.3f} s, launches {launched}")
        results[name]["launches"] = launched
    qs, fd, sc = (results[n] for n in ("quickstart", "finetune_dedup", "serve_compressed"))
    line = (f"examples: quickstart rel err {qs['rel_err']:.3e} (dequant_matmul launches "
            f"{qs['launches'].get('dequant_matmul', 0)}), finetune new bases "
            f"{qs['finetune_new_bases']}; finetune_dedup max err {fd['max_err']:.3e}, ratios "
            f"{ {k: round(v, 6) for k, v in fd['ratios'].items()} } (quantized_l2 launches "
            f"{fd['launches'].get('quantized_l2', 0)}); serve_compressed agreement "
            f"{sc['agreement']:.4f}, compression ratio "
            f"{sc['storage_report']['compression_ratio']:.6f}")
    if (qs["launches"].get("dequant_matmul", 0) != 1 or not qs["rel_err"] < 1e-3
            or qs["finetune_new_bases"] != 0 or fd["launches"].get("quantized_l2", 0) <= 0
            or not fd["max_err"] <= 2 ** -23 or not fd["ratios"]["neurstore"] > 1.0
            or not sc["agreement"] > 0.5):
        fail(line)
    log(line)
    counts = ops.launch_counts()
    torch.cuda.empty_cache()
    log(f"tools and examples phase (13): {time.perf_counter() - t_phase:.3f} s "
        f"({', '.join(f'{k} {v:.3f} s' for k, v in secs.items())})")
    return counts


def _internlm2():
    from repro_torch.configs import get_config

    return get_config("internlm2-1.8b")


def _zoo_config(arch: str):
    """Phase 10's configuration of ``arch``: as published, depth cut where
    ``ZOO_LAYERS`` says."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in ZOO_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=ZOO_LAYERS[arch])
    return cfg


def _greedy(params, cfg, prompts: torch.Tensor, steps: int):
    """The prompt teacher-forced through ``decode_step``, then ``steps``
    greedy tokens: (tokens (B, steps), logits (B, steps, V) float32)."""
    from repro_torch.models import decode_step, init_cache

    b, s0 = prompts.shape
    with torch.inference_mode():
        cache = init_cache(cfg, b, s0 + steps, device=prompts.device)
        for t in range(s0):
            logits, cache = decode_step(params, cache, {"tokens": prompts[:, t:t + 1]}, t, cfg)
        toks, all_logits = [], []
        for i in range(steps):
            all_logits.append(logits[:, -1].float())
            tok = torch.argmax(logits[:, -1:], dim=-1)
            toks.append(tok)
            logits, cache = decode_step(params, cache, {"tokens": tok}, s0 + i, cfg)
    return torch.cat(toks, dim=1), torch.stack(all_logits, dim=1)


def _check_tokens(what: str, got: torch.Tensor, want: torch.Tensor, want_logits: torch.Tensor,
                  tol: float, got_logits: torch.Tensor | None = None) -> int:
    """Tokens equal step by step while both decodes were fed the same
    tokens; a near tie (top-2 margin within ``tol``) may split them, and
    ends the comparison. With ``got_logits``, the logits of each compared
    step must agree within rtol = atol = ``tol`` too. Returns the number of
    steps compared."""
    compared = 0
    for s in range(want.shape[1]):
        if got_logits is not None:
            abs_err, ratio = _close(got_logits[:, s], want_logits[:, s], tol, tol)
            if ratio > 1.0:
                fail(f"{what} step {s}: logits differ by {abs_err:.3e} (rtol/atol {tol})")
        top2 = want_logits[:, s].topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol * (1 + top2[:, 0].abs())
        if not torch.equal(got[:, s][clear], want[:, s][clear]):
            fail(f"{what} step {s}: tokens differ where the margin is clear")
        compared += 1
        if not torch.equal(got[:, s], want[:, s]):
            log(f"{what}: a near tie split the decodes at step {s}; compared {compared} steps")
            break
    return compared


def phase_model_stack() -> dict[str, int]:
    """Phase 6: internlm2-1.8b at full width and depth."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = _internlm2()
    kernel_attention = ops.flash_attention
    rng = np.random.default_rng(SEED + 6)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _flatten(params).values())
    log(f"model stack: {cfg.name} as published ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_head {cfg.d_head}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.param_dtype}); {n_params} parameters initialised on the "
        f"card in {time.perf_counter() - t0:.3f} s")

    # (a) prefill: the main path of this phase, counted.
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))).to(dev)
    prefill = make_prefill_step(cfg)
    ops.reset_launch_counts()
    last = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if (counts["flash_attention_bfloat16"], counts["flash_attention_float32"]) != (cfg.n_layers, 0):
        fail(f"prefill: flash_attention launches {counts}, want {cfg.n_layers}, all on the "
             f"bfloat16 tensor-core route ({fa.ROUTES[torch.bfloat16]})")
    if tuple(last.shape) != (PREFILL_BATCH, cfg.vocab_size) or not torch.isfinite(last).all():
        fail(f"prefill: logits {tuple(last.shape)}, finite {bool(torch.isfinite(last).all())}")
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        again = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    if not torch.equal(again, last):
        fail("prefill: a second run gave other logits")
    pre_s = float(np.median(times))
    log(f"prefill {PREFILL_BATCH} x {PREFILL_LEN}: {pre_s * 1e3:.6f} ms (median of 3, "
        f"{[round(t * 1e3, 3) for t in times]}), "
        f"{PREFILL_BATCH * PREFILL_LEN / pre_s:.6f} tokens/s; launches {counts}")

    # A check, not a main path: the same prefill on the plain attention. At
    # every layer the kernel also runs on the layer's own inputs and is held
    # to FA_BF16_TOL against the plain output, which the prefill carries on.
    # The kernel's last-token logits are held to FA_LOGITS_ATOL of the plain
    # prefill's. Two more prefills are printed beside them and checked by
    # nothing: the library's bf16 attention and the single-bf16-p control.
    layer_ratios, control_ratios = [], []

    def checked(q, k, v, *, causal=True, window=0, sk_true=None):
        want = ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        got = kernel_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        layer_ratios.append(_close(got, want, *FA_BF16_TOL)[1])
        ctrl = _single_bf16_p(q, k, v, causal=causal, window=window, sk_true=sk_true)
        control_ratios.append(_close(ctrl, want, *FA_BF16_TOL)[1])
        return want

    def library(q, k, v, *, causal=True, window=0, sk_true=None):
        return _sdpa(q, k, v, causal, window).transpose(1, 2)

    try:
        ops.flash_attention = checked
        plain_last = prefill(params, {"tokens": tokens})
        ops.flash_attention = library
        lib_last = prefill(params, {"tokens": tokens})
        ops.flash_attention = _single_bf16_p
        single_last = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = kernel_attention

    def dist(x):
        d = (x.double() - plain_last.double())
        return float(d.abs().max()), float(d.pow(2).mean().sqrt())

    (abs_err, rms_err), lib_d, ctrl_d = dist(last), dist(lib_last), dist(single_last)
    top2 = plain_last.topk(2, dim=1).values
    margins = top2[:, 0] - top2[:, 1]
    clear = margins > FA_LOGITS_ATOL
    same = last.argmax(dim=1) == plain_last.argmax(dim=1)
    readings = (f"last-token logits against the plain prefill, max abs / rms: kernel "
                f"{abs_err:.6e} / {rms_err:.6e}, library attention {lib_d[0]:.6e} / "
                f"{lib_d[1]:.6e}, single-bf16-p control {ctrl_d[0]:.6e} / {ctrl_d[1]:.6e} "
                f"(FA_LOGITS_ATOL {FA_LOGITS_ATOL}); |logits| max "
                f"{float(plain_last.abs().max()):.3f}; argmax equal {same.tolist()}, top-2 "
                f"margins {[round(x, 4) for x in margins.tolist()]}")
    if (len(layer_ratios) != cfg.n_layers or max(layer_ratios) > 1.0 or abs_err > FA_LOGITS_ATOL
            or not bool(same[clear].all())):
        fail(f"prefill against the plain attention: per-layer kernel ratios {layer_ratios} "
             f"(FA_BF16_TOL {FA_BF16_TOL}); {readings}")
    log(f"prefill against the plain attention ({cfg.n_layers} layers): kernel on each layer's "
        f"inputs within FA_BF16_TOL {FA_BF16_TOL}, allclose ratio max {max(layer_ratios):.6f} "
        f"(the single-bf16-p control's {min(control_ratios):.3f} to {max(control_ratios):.3f}); "
        f"{readings}")
    del plain_last, lib_last, single_last

    # (c) greedy serving: teacher-force a prompt, then 16 greedy tokens.
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN))).to(dev)
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, BATCH, PROMPT_LEN + STEPS)
    ops.reset_launch_counts()
    with torch.inference_mode():
        for t in range(PROMPT_LEN):
            tok, cache = serve(params, cache, {"tokens": prompt[:, t:t + 1]}, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = []
        for i in range(STEPS):
            out.append(tok)
            tok, cache = serve(params, cache, {"tokens": tok[:, None].long()}, PROMPT_LEN + i)
        torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    serve_counts = ops.launch_counts()
    gen = torch.stack(out, dim=1)
    if tuple(gen.shape) != (BATCH, STEPS) or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab_size:
        fail(f"serve: tokens {tuple(gen.shape)} in [{int(gen.min())}, {int(gen.max())}]")
    log(f"serve step (greedy, batch {BATCH}, cache {PROMPT_LEN + STEPS}): "
        f"{dec_s / STEPS * 1e3:.6f} ms/step, {BATCH * STEPS / dec_s:.6f} tokens/s over "
        f"{STEPS} steps after a {PROMPT_LEN}-token prompt; first tokens "
        f"{gen[:, :4].tolist()}; launches {serve_counts}")
    del params, cache, last, again
    torch.cuda.empty_cache()

    # (b) float32, same widths and depth. The prefill of (a) in float32 (a
    # main path: 24 launches on the float32 route), held to CONSISTENCY_TOL
    # of the same prefill on the plain attention.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg32, SEED, device=dev)
    prefill32 = make_prefill_step(cfg32)
    ops.reset_launch_counts()
    last32 = prefill32(params, {"tokens": tokens})
    torch.cuda.synchronize()
    pre32_counts = ops.launch_counts()
    if (pre32_counts["flash_attention_bfloat16"], pre32_counts["flash_attention_float32"]) != (
            0, cfg.n_layers):
        fail(f"float32 prefill: flash_attention launches {pre32_counts}, want {cfg.n_layers}, "
             f"all on the float32 route ({fa.ROUTES[torch.float32]})")
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        again = prefill32(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    pre32_s = float(np.median(times))
    try:
        ops.flash_attention = ref.flash_attention
        plain32 = prefill32(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = kernel_attention
    rtol, atol = CONSISTENCY_TOL
    abs_err, ratio = _close(last32, plain32, rtol, atol)
    if (tuple(last32.shape) != (PREFILL_BATCH, cfg.vocab_size) or not torch.isfinite(last32).all()
            or not torch.equal(again, last32) or ratio > 1.0):
        fail(f"float32 prefill: logits {tuple(last32.shape)}, finite "
             f"{bool(torch.isfinite(last32).all())}, equal on repeat {torch.equal(again, last32)}; "
             f"against the plain attention max abs err {abs_err:.3e}, ratio {ratio:.3f} "
             f"(rtol {rtol}, atol {atol})")
    log(f"float32 prefill {PREFILL_BATCH} x {PREFILL_LEN} ({cfg.n_layers} layers): "
        f"{pre32_s * 1e3:.6f} ms (median of 3, {[round(t * 1e3, 3) for t in times]}), "
        f"{PREFILL_BATCH * PREFILL_LEN / pre32_s:.6f} tokens/s; last-token logits against the "
        f"plain attention's prefill: max abs err {abs_err:.3e}, allclose ratio {ratio:.6f} "
        f"(rtol {rtol}, atol {atol}); |logits| max {float(plain32.abs().max()):.3f}; "
        f"launches {pre32_counts}")
    del last32, again, plain32
    torch.cuda.empty_cache()

    # Forward against the decode loop over a short prompt.
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CONSISTENCY_LEN))).to(dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        full = forward(params, {"tokens": toks}, cfg32)
        torch.cuda.synchronize()
        f32_counts = ops.launch_counts()
        cache = init_cache(cfg32, 1, CONSISTENCY_LEN)
        steps = []
        for t in range(CONSISTENCY_LEN):
            lg, cache = decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t, cfg32)
            steps.append(lg)
        steps = torch.cat(steps, dim=1)
    if (f32_counts["flash_attention_bfloat16"], f32_counts["flash_attention_float32"]) != (
            0, cfg.n_layers):
        fail(f"float32 forward: flash_attention launches {f32_counts}, want {cfg.n_layers}, "
             f"all on the float32 route ({fa.ROUTES[torch.float32]})")
    rtol, atol = CONSISTENCY_TOL
    abs_err, ratio = _close(steps, full, rtol, atol)
    if not torch.isfinite(full).all() or ratio > 1.0:
        fail(f"float32 forward against decode: max abs err {abs_err:.3e}, ratio {ratio:.3f} "
             f"(rtol {rtol}, atol {atol})")
    log(f"float32 {cfg.n_layers} layers: forward logits over {CONSISTENCY_LEN} tokens against "
        f"the decode_step loop: max abs err {abs_err:.3e}, allclose ratio {ratio:.6f} "
        f"(rtol {rtol}, atol {atol}); |logits| max {float(full.abs().max()):.3f}; "
        f"launches {f32_counts}")
    del params, cache, full, steps
    torch.cuda.empty_cache()
    return {k: counts[k] + serve_counts[k] + pre32_counts[k] + f32_counts[k] for k in counts}


def _zoo_serve(cfg, params, rng, dev) -> dict:
    """16 greedy ``make_serve_step`` tokens at batch 4 after a teacher-forced
    ``PROMPT_LEN``-token prompt: ms a step and tokens/s over the 16."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_cache

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN))).to(dev)
    serve = make_serve_step(cfg)
    cache = init_cache(cfg, BATCH, PROMPT_LEN + STEPS, device=dev)
    with torch.inference_mode():
        for t in range(PROMPT_LEN):
            tok, cache = serve(params, cache, {"tokens": prompt[:, t:t + 1]}, t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = []
        for i in range(STEPS):
            out.append(tok)
            tok, cache = serve(params, cache, {"tokens": tok[:, None].long()}, PROMPT_LEN + i)
        torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    gen = torch.stack(out, dim=1)
    if tuple(gen.shape) != (BATCH, STEPS) or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab_size:
        fail(f"{cfg.name} serve: tokens {tuple(gen.shape)} in [{int(gen.min())}, {int(gen.max())}]")
    log(f"{cfg.name} serve step (greedy, batch {BATCH}, cache {PROMPT_LEN + STEPS}): "
        f"{dec_s / STEPS * 1e3:.6f} ms/step, {BATCH * STEPS / dec_s:.6f} tokens/s over {STEPS} "
        f"steps after a {PROMPT_LEN}-token prompt; first tokens {gen[:, :4].tolist()}; "
        f"launches {ops.launch_counts()}")
    return {"ms_per_step": dec_s / STEPS * 1e3, "tokens_per_s": BATCH * STEPS / dec_s}


def _zoo_dropped(cfg, params, tokens) -> tuple[int, int]:
    """(routed pairs dropped past capacity, routed pairs) in one prefill of
    ``tokens``: the prefill run again with every ``MoE.forward`` counting its
    routing first (``MoE.route``, the routing the forward itself takes)."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers

    seen = [0, 0]
    forward = layers.MoE.forward

    def counting(self, p, x):
        _, dest, cap = self.route(p, x)
        seen[0] += int((dest == self.n_experts * cap).sum())
        seen[1] += dest.numel()
        return forward(self, p, x)

    layers.MoE.forward = counting
    try:
        make_prefill_step(cfg)(params, {"tokens": tokens})
    finally:
        layers.MoE.forward = forward
    return seen[0], seen[1]


def _zoo_trace(cfg, prefill, params, tokens, plain_ms: float | None) -> None:
    from repro_torch.launch.profile_steps import trace_prefill

    tr = trace_prefill(prefill, params, {"tokens": tokens}, plain_ms)
    log(f"trace {cfg.name} prefill {tuple(tokens.shape)}: plain {tr['plain_wall_ms']:.6f} ms, "
        f"profiled {tr['wall_ms']:.6f} ms, device busy {tr['device_busy_ms']:.6f} ms "
        f"({tr['busy_share_of_plain']:.4f} of the plain prefill, idle "
        f"{1 - tr['busy_share_of_plain']:.4f}), {tr['kernels']:.1f} kernels and "
        f"{tr['host_ops']:.1f} host ops, median gap {tr['median_gap_us']:.3f} us; busy split "
        + ", ".join(f"{k} {tr['parts_ms'][k]:.6f} ms ({v:.4f})" for k, v in tr["shares"].items())
        + "; top " + ", ".join(f"{k['name'][:48]} {k['ms']:.4f} ms x{k['count']:.0f}"
                              for k in tr["top_kernels"][:6]))


def phase_zoo() -> dict[str, int]:
    """Phase 10: the rest of the model zoo on the card (recurrentgemma-9b,
    rwkv6-7b, granite-moe-3b-a800m, arctic-480b at one layer)."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import decode_step, forward, init_cache, init_params

    kernel_attention = ops.flash_attention
    rng = np.random.default_rng(SEED + 10)
    dev = torch.device("cuda")
    total: Counter = Counter()
    for arch in ("recurrentgemma-9b", "rwkv6-7b", "granite-moe-3b-a800m", "arctic-480b"):
        cfg = _zoo_config(arch)
        batch, length = ZOO_PREFILL[arch]
        t0 = time.perf_counter()
        params = init_params(cfg, SEED, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _flatten(params).values())
        n_attn = sum(kind in ("attn", "local_attn") for kind, _ in cfg.layer_types())
        published = get_config(arch).n_layers
        cut = (f", depth cut from {published} (one card cannot hold them)"
               if cfg.n_layers != published else ", as published")
        log(f"model zoo: {arch} ({cfg.n_layers} layers{cut}, d_model {cfg.d_model}, "
            f"{cfg.param_dtype}; blocks {sorted(set(cfg.layer_types()))}); {n_params} "
            f"parameters initialised on the card in {time.perf_counter() - t0:.3f} s"
            + ("" if n_attn else "; no kernel on this model's path (no attention layer)"))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length))).to(dev)
        prefill = make_prefill_step(cfg)
        ops.reset_launch_counts()
        last = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        total.update(counts)
        dh256 = n_attn if cfg.d_head == 256 else 0
        if (counts["flash_attention_bfloat16"], counts["flash_attention_float32"],
                counts["flash_attention_bfloat16_dh256"]) != (n_attn, 0, dh256):
            fail(f"{arch} prefill: flash_attention launches {counts}, want {n_attn} on the "
                 f"bfloat16 route ({dh256} at head dim 256)")
        if tuple(last.shape) != (batch, cfg.vocab_size) or not torch.isfinite(last).all():
            fail(f"{arch} prefill: logits {tuple(last.shape)}, finite "
                 f"{bool(torch.isfinite(last).all())}")
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        pre_s = float(np.median(times))
        log(f"{arch} prefill {batch} x {length}: {pre_s * 1e3:.6f} ms (median of 2, "
            f"{[round(t * 1e3, 3) for t in times]}), {batch * length / pre_s:.6f} tokens/s; "
            f"launches {counts}")
        if cfg.n_experts:
            dropped, routed = _zoo_dropped(cfg, params, tokens)
            log(f"{arch} prefill: capacity factor {cfg.capacity_factor} dropped {dropped} of "
                f"{routed} routed (token, expert) pairs ({dropped / routed:.6f})")
        if arch == "recurrentgemma-9b":
            _zoo_attention_check(cfg, prefill, params, tokens, last, kernel_attention)
        if arch in ZOO_TRACE:
            tb, tl = ZOO_TRACE[arch]
            _zoo_trace(cfg, prefill, params, tokens[:tb, :tl],
                       pre_s * 1e3 if (tb, tl) == (batch, length) else None)
        del last, tokens
        ops.reset_launch_counts()
        _zoo_serve(cfg, params, rng, dev)
        total.update(ops.launch_counts())
        del params
        torch.cuda.empty_cache()
        log(f"{arch}: {time.perf_counter() - t0:.3f} s in all")

    # (e) float32 at full depth, one model at a time: forward against decode.
    log("model zoo (e): float32 forward against the decode_step loop; arctic-480b's "
        "float32 layer (56 GB) is left out")
    for arch in ("recurrentgemma-9b", "rwkv6-7b", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(_zoo_config(arch), param_dtype="float32",
                                  compute_dtype="float32")
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=ZOO_F32_CAPACITY)
        t0 = time.perf_counter()
        params = init_params(cfg, SEED, device=dev)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CONSISTENCY_LEN))).to(dev)
        n_attn = sum(kind in ("attn", "local_attn") for kind, _ in cfg.layer_types())
        ops.reset_launch_counts()
        with torch.inference_mode():
            full = forward(params, {"tokens": toks}, cfg)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            cache = init_cache(cfg, 1, CONSISTENCY_LEN, device=dev)
            steps = []
            for t in range(CONSISTENCY_LEN):
                lg, cache = decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, t, cfg)
                steps.append(lg)
            steps = torch.cat(steps, dim=1)
            # The forward's own sensitivity: its input embeddings moved by one
            # float32 rounding.
            x0 = params["embed"][toks]
            gen = torch.Generator(device=dev).manual_seed(SEED)
            nudged = forward(params, {"embeds": x0 * (1 + 2.0 ** -24 * torch.randn(
                x0.shape, generator=gen, device=dev))}, cfg)
        total.update(counts)
        dh256 = n_attn if cfg.d_head == 256 else 0
        if (counts["flash_attention_bfloat16"], counts["flash_attention_float32"],
                counts["flash_attention_float32_dh256"]) != (0, n_attn, dh256):
            fail(f"{arch} float32 forward: flash_attention launches {counts}, want {n_attn} "
                 f"on the float32 route ({dh256} at head dim 256)")
        rtol, atol = CONSISTENCY_TOL
        abs_err, ratio = _close(steps, full, rtol, atol)
        self_err = float((nudged.double() - full.double()).abs().max())
        gated = arch not in ZOO_F32_LAYERWISE_ONLY
        line = (f"{arch} float32 ({cfg.n_layers} layers): forward logits over {CONSISTENCY_LEN} "
                f"tokens against the decode_step loop: max abs err {abs_err:.3e}, allclose ratio "
                f"{ratio:.6f} (rtol {rtol}, atol {atol}"
                + ("" if gated else "; printed, not held: ZOO_F32_LAYERWISE_ONLY")
                + f"); the forward against itself with its input embeddings moved by 2^-24: "
                f"{self_err:.3e}; |logits| max {float(full.abs().max()):.3f}; launches {counts}")
        if not torch.isfinite(full).all() or (gated and ratio > 1.0):
            fail(line)
        log(line)
        del cache, full, steps, nudged
        _zoo_layers_f32(cfg, params, toks)
        del params
        torch.cuda.empty_cache()
        log(f"{arch} float32: {time.perf_counter() - t0:.3f} s in all")
    return dict(total)


def _zoo_layers_f32(cfg, params, toks) -> None:
    """Each layer of a float32 model at its own inputs (the forward's
    residual stream over ``toks``): its sequence forward over the prompt
    against ``CONSISTENCY_LEN`` decode steps from a fresh state, within
    ``CONSISTENCY_TOL``."""
    from repro_torch.models import init_cache
    from repro_torch.models.transformer import (
        _apply_layer,
        _blocks_for_period,
        _blocks_for_tail,
        _decode_layer,
        _embed_in,
        _index,
    )

    rtol, atol = CONSISTENCY_TOL
    worst = (0.0, 0.0)
    with torch.inference_mode():
        x = _embed_in(cfg, params, {"tokens": toks})
        positions = torch.arange(toks.shape[1], device=toks.device)[None]
        one = init_cache(cfg, 1, toks.shape[1], device=toks.device)
        layers = [(_index(params["periods"], i)[f"slot{j}"], _index(one["periods"], i)[f"slot{j}"],
                   sb, mb) for i in range(cfg.n_periods)
                  for j, (sb, mb) in enumerate(_blocks_for_period(cfg))]
        layers += [(params["tail"][i], one["tail"][i], sb, mb)
                   for i, (sb, mb) in enumerate(_blocks_for_tail(cfg))]
        for n, (p, cache, sb, mb) in enumerate(layers):
            want = _apply_layer(cfg, sb, mb, p, x, positions)
            got = torch.cat([_decode_layer(cfg, sb, mb, p, x[:, t:t + 1], cache, t)[0]
                             for t in range(toks.shape[1])], dim=1)
            abs_err, ratio = _close(got, want, rtol, atol)
            if ratio > 1.0 or not torch.isfinite(want).all():
                fail(f"{cfg.name} float32 layer {n}: the forward against {toks.shape[1]} decode "
                     f"steps at the layer's own inputs: max abs err {abs_err:.3e}, ratio "
                     f"{ratio:.6f} (rtol {rtol}, atol {atol})")
            worst = max(worst, (ratio, abs_err))
            x = want
    log(f"{cfg.name} float32: each of its {len(layers)} layers at its own inputs, the forward "
        f"against {toks.shape[1]} decode steps: worst allclose ratio {worst[0]:.6f}, max abs err "
        f"{worst[1]:.3e} (rtol {rtol}, atol {atol}); the residual stream's |x| max "
        f"{float(x.abs().max()):.3f} at the last layer")


def _zoo_attention_check(cfg, prefill, params, tokens, last, kernel_attention) -> None:
    """recurrentgemma-9b's prefill on the plain attention, the kernel held to
    ``FA_BF16_TOL`` on every attention layer's own inputs; the last-token
    logits held to ``ZOO_LOGITS_ATOL`` of the plain prefill's, with the
    library attention's and the single-bf16-p control's distances printed
    (as phase 6 does for internlm2-1.8b)."""
    from repro_torch.kernels import ops, ref

    layer_ratios, control_ratios = [], []

    def checked(q, k, v, *, causal=True, window=0, sk_true=None):
        want = ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        got = kernel_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        layer_ratios.append(_close(got, want, *FA_BF16_TOL)[1])
        ctrl = _single_bf16_p(q, k, v, causal=causal, window=window, sk_true=sk_true)
        control_ratios.append(_close(ctrl, want, *FA_BF16_TOL)[1])
        return want

    def library(q, k, v, *, causal=True, window=0, sk_true=None):
        return _sdpa(q, k, v, causal, window).transpose(1, 2)

    try:
        ops.flash_attention = checked
        plain_last = prefill(params, {"tokens": tokens})
        ops.flash_attention = library
        lib_last = prefill(params, {"tokens": tokens})
        ops.flash_attention = _single_bf16_p
        single_last = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = kernel_attention

    def dist(x):
        d = x.double() - plain_last.double()
        return float(d.abs().max()), float(d.pow(2).mean().sqrt())

    (abs_err, rms_err), lib_d, ctrl_d = dist(last), dist(lib_last), dist(single_last)
    top2 = plain_last.topk(2, dim=1).values
    margins = top2[:, 0] - top2[:, 1]
    clear = margins > ZOO_LOGITS_ATOL
    same = last.argmax(dim=1) == plain_last.argmax(dim=1)
    n_attn = sum(kind in ("attn", "local_attn") for kind, _ in cfg.layer_types())
    readings = (f"last-token logits against the plain prefill, max abs / rms: kernel "
                f"{abs_err:.6e} / {rms_err:.6e}, library attention {lib_d[0]:.6e} / "
                f"{lib_d[1]:.6e}, single-bf16-p control {ctrl_d[0]:.6e} / {ctrl_d[1]:.6e} "
                f"(ZOO_LOGITS_ATOL {ZOO_LOGITS_ATOL}); |logits| max "
                f"{float(plain_last.abs().max()):.3f}; argmax equal {same.tolist()}, top-2 "
                f"margins {[round(x, 4) for x in margins.tolist()]}")
    if (len(layer_ratios) != n_attn or max(layer_ratios) > 1.0 or abs_err > ZOO_LOGITS_ATOL
            or not bool(same[clear].all())):
        fail(f"{cfg.name} prefill against the plain attention: per-layer kernel ratios "
             f"{layer_ratios} (FA_BF16_TOL {FA_BF16_TOL}); {readings}")
    log(f"{cfg.name} prefill against the plain attention ({n_attn} attention layers of "
        f"{cfg.n_layers}): kernel on each layer's inputs within FA_BF16_TOL {FA_BF16_TOL}, "
        f"allclose ratio max {max(layer_ratios):.6f} (the single-bf16-p control's "
        f"{min(control_ratios):.3f} to {max(control_ratios):.3f}); {readings}")
    del plain_last, lib_last, single_last
    torch.cuda.empty_cache()


def _attention_flops(b: int, h: int, dh: int, pairs: int) -> dict[str, int]:
    """Operations of attention over ``pairs`` unmasked (query, key) pairs a
    head: the forward's two products (s = q kᵀ, o = p v) and the five a
    backward needs (s again, dp = do vᵀ, dv = pᵀ do, dq = ds k, dk = dsᵀ q)."""
    unit = 2 * b * h * dh * pairs
    return {"forward": 2 * unit, "backward": 5 * unit}


def phase_attention_backward(dev_info: dict) -> dict:
    """Phase 8 (c), run beside phase 5 (before phase 4, after which
    ``kernel_ms``'s traces have come back empty): forward + backward of
    the attention through ``FlashAttentionFn`` at the train shape, bf16
    and float32, causal, against autograd of the plain version and timed
    beside ``scaled_dot_product_attention``'s forward + backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    bw = dev_info["bandwidth"]
    b, sq, sk, h, kv, dh, causal, window = FA_PREFILL
    rng = np.random.default_rng(SEED + 8)
    dev = torch.device("cuda")
    # A float64 flush: no kernel of the timed calls shares its name.
    flush = torch.zeros(32 << 20, dtype=torch.float64, device=dev)

    flops = _attention_flops(b, h, dh, _attention_pairs(sq, sk, causal, window))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        q, k, v, do = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev, dtype)
                       for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
                                     (b, sq, h, dh)))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        do_sdpa = do.transpose(1, 2)

        def port():
            o = fa.flash_attention(*leaves, causal=causal)
            return torch.autograd.grad(o, leaves, do)

        def forward():
            with torch.no_grad():
                fa.flash_attention(q, k, v, causal=causal)

        def library():
            o = _sdpa(*leaves, causal, window)
            return torch.autograd.grad(o, leaves, do_sdpa)

        def plain():
            o = ref.flash_attention(*leaves, causal=causal)
            return torch.autograd.grad(o, leaves, do)

        got, want = port(), plain()
        torch.cuda.synchronize()
        rtol = 1e-4 if dtype == torch.float32 else FA_BF16_TOL[0]
        worst = 0.0
        for g, w in zip(got, want):
            scale = float(w.float().abs().max()) + 1e-6
            abs_err, ratio = _close(g.float(), w.float(), rtol, 1e-5 * scale)
            worst = max(worst, ratio)
            if g.dtype != dtype or not torch.isfinite(g).all() or ratio > 1.0:
                fail(f"attention backward {name}: max abs err {abs_err:.3e}, allclose ratio "
                     f"{ratio:.3f} (rtol {rtol}, atol 1e-5 x {scale:.3g}) against autograd of "
                     "the plain version")
        del got, want
        ms = _time_ms(port, 5, flush)
        lib_ms = _time_ms(library, 5, flush)
        plain_ms = _time_ms(plain, 3, flush)
        dev_ms, fwd_ms, lib_dev_ms = (_device_ms(port, 10, flush),
                                      _device_ms(forward, 10, flush, "flash_attn"),
                                      _device_ms(library, 10, flush))
        need = flops["forward"] + flops["backward"]
        if dtype == torch.bfloat16:
            t_ops = need / BF16_TC_PEAK
        else:
            t_ops = F32_SPLIT * need / TF32_TC_PEAK
        nbytes = (2 * b * sq * h + 2 * b * sk * kv) * dh * q.element_size() * 2
        bound = max(nbytes / bw, t_ops) * 1e3
        log(f"attention forward + backward at the train shape {FA_PREFILL[:6]} causal {name} "
            f"through FlashAttentionFn (kernel forward, plain float32 backward): ms {ms:.6f} "
            f"device_ms {dev_ms:.6f} (forward kernel {fwd_ms:.6f}, backward "
            f"{dev_ms - fwd_ms:.6f}); scaled_dot_product_attention forward + backward ms "
            f"{lib_ms:.6f} device_ms {lib_dev_ms:.6f} (port/library {dev_ms / lib_dev_ms:.3f}); "
            f"autograd of the plain version ms {plain_ms:.6f}; bound {bound:.6f} ms on the "
            f"{need} operations the inputs need ({bound / dev_ms:.4f} of it); "
            f"gradients within rtol {rtol} of autograd of the plain version (ratio "
            f"{worst:.3f})")
        out[name] = {"ms": ms, "device_ms": dev_ms, "forward_device_ms": fwd_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bound}
        del q, k, v, do, leaves, do_sdpa
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


def _rel_l2(got: dict, want: dict) -> dict[str, float]:
    """||g - w|| / ||w|| of each leaf, in float64."""
    return {k: float((got[k].double() - want[k].double()).norm()
                     / want[k].double().norm().clamp_min(1e-30)) for k in want}


def _value_and_grad(params, batch, cfg, attention):
    """loss_fn and its gradients with ``attention`` behind the model's
    seam (``ops.flash_attention``), for the forward and for remat's
    recompute in the backward alike."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.kernels import ops
    from repro_torch.models import loss_fn
    from repro_torch.tree import tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = _flatten(leaves)
    kernel_attention = ops.flash_attention
    try:
        ops.flash_attention = attention
        loss = loss_fn(leaves, batch, cfg)[0]
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    finally:
        ops.flash_attention = kernel_attention
    grads = {k: torch.zeros_like(t) if g is None else g for (k, t), g in zip(flat.items(), grads)}
    return float(loss.detach()), grads


def _step_flops(cfg, tokens: int) -> tuple[int, int]:
    """(operations a remat train step needs, the attention's share): the
    matmuls' 2 per weight and token forward, 4 backward, and 2 more for the
    layers' recomputed forward (the LM head is not recomputed); attention
    forward twice (remat) and backward once, at ``TRAIN_LEN`` causal."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    layer = d * (2 * h + 2 * kv) * dh + 3 * d * cfg.d_ff
    head = d * cfg.vocab_size
    matmul = 2 * tokens * ((layer * cfg.n_layers + head) * 3 + layer * cfg.n_layers)
    att = _attention_flops(tokens // TRAIN_LEN, h, dh,
                           _attention_pairs(TRAIN_LEN, TRAIN_LEN, True, 0))
    att_total = cfg.n_layers * (2 * att["forward"] + att["backward"])
    return matmul + att_total, att_total


def phase_training(dev_info: dict) -> dict[str, int]:
    """Phase 8 (a), (e), (b), (d): train steps at full width and depth and
    their trace, the gradient check, the Trainer with store checkpoints."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.profile_steps import trace_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = _internlm2()
    dev = torch.device("cuda")
    bw = dev_info["bandwidth"]
    data = SyntheticLM(cfg.vocab_size, seed=SEED)

    def batch_at(step, size, length):
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step, size, length).items()}

    # (a) train steps: a main path, counted.
    params = init_params(cfg, SEED + 8, device=dev)
    opt = adamw_init(params)
    n_params = sum(t.numel() for t in _flatten(params).values())
    step_fn = make_train_step(cfg, 1, lr=TRAIN_LR)
    tokens = TRAIN_BATCH * TRAIN_LEN
    flops, att_flops = _step_flops(cfg, tokens)
    # Bytes a step must move at least: the weights read by the forward, the
    # recompute and the backward (3 p), the grads written and read (2 p), and
    # AdamW's read and write of p (2 p) and of the float32 m and v (16 a
    # parameter).
    p_bytes = sum(t.numel() * t.element_size() for t in _flatten(params).values())
    step_bytes = 7 * p_bytes + 16 * n_params
    t_ops, t_bytes = flops / BF16_TC_PEAK * 1e3, step_bytes / bw * 1e3
    log(f"training: {cfg.name} as published ({cfg.n_layers} layers, {cfg.param_dtype}, remat "
        f"{cfg.remat}), {n_params} parameters; make_train_step (1 microbatch, lr {TRAIN_LR}) on "
        f"{TRAIN_BATCH} x {TRAIN_LEN} SyntheticLM batches; {flops} operations a step "
        f"({att_flops} in the attention), bound {max(t_ops, t_bytes):.6f} ms "
        f"({t_ops:.6f} at {BF16_TC_PEAK / 1e12:.0f} TFLOP/s bf16, {t_bytes:.6f} for "
        f"{step_bytes} bytes)")
    ops.reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        batch = batch_at(i, TRAIN_BATCH, TRAIN_LEN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        losses.append(loss)
        times.append(dt)
        log(f"train step {i}: {dt * 1e3:.6f} ms, {tokens / dt:.6f} tokens/s, loss {loss:.6f}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, flash_attention "
            f"launches bf16 {launched['flash_attention_bfloat16']} float32 "
            f"{launched['flash_attention_float32']} (want {2 * cfg.n_layers} bf16: forward and "
            f"remat's recompute), {flops / dt / 1e12:.3f} TFLOP/s")
        if (launched["flash_attention_bfloat16"], launched["flash_attention_float32"]) != (
                2 * cfg.n_layers, 0):
            fail(f"train step {i}: flash_attention launches {launched}, want "
                 f"{2 * cfg.n_layers} on the bfloat16 route")
    train_counts = ops.launch_counts()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train steps: losses {losses} (want finite, the last below the first)")
    step_s = float(np.median(times[1:]))
    log(f"train steps: median {step_s * 1e3:.6f} ms of steps 1-{TRAIN_STEPS - 1} "
        f"({[round(t * 1e3, 3) for t in times]}), {tokens / step_s:.6f} tokens/s, "
        f"{flops / step_s / 1e12:.3f} TFLOP/s, {max(t_ops, t_bytes) / (step_s * 1e3):.4f} of "
        f"the bound; losses {losses}")

    # (e) one more step traced (not counted: a measurement).
    tr = trace_train_step(step_fn, params, opt, batch_at(TRAIN_STEPS, TRAIN_BATCH, TRAIN_LEN),
                          plain_ms=step_s * 1e3)
    if tr["kernels"] <= 0:
        fail("train step trace: no kernel in the trace")
    log(f"trace train step: plain {tr['plain_wall_ms']:.6f} ms, profiled {tr['wall_ms']:.6f} ms, "
        f"device busy {tr['device_busy_ms']:.6f} ms ({tr['busy_share_of_plain']:.4f} of the "
        f"plain step, idle {1 - tr['busy_share_of_plain']:.4f}), {tr['kernels']:.1f} kernels and "
        f"{tr['host_ops']:.1f} host ops a step, median gap {tr['median_gap_us']:.3f} us; "
        f"flash_attn {tr['match_ms']:.6f} ms, {tr['match_share_of_busy']:.4f} of busy; top "
        + ", ".join(f"{k['name'][:60]} {k['ms']:.4f} ms x{k['count']:.0f}"
                    for k in tr["top_kernels"]))
    del params, opt, metrics
    torch.cuda.empty_cache()

    # (b) the gradient check (a check, not counted).
    for dtype_name in ("float32", "bfloat16"):
        gcfg = dataclasses.replace(cfg, n_layers=GRAD_LAYERS, param_dtype=dtype_name,
                                   compute_dtype=dtype_name)
        params = init_params(gcfg, SEED + 9, device=dev)
        batch = batch_at(0, TRAIN_BATCH, TRAIN_LEN)
        before = ops.launch_counts()
        loss_k, g_k = _value_and_grad(params, batch, gcfg, ops.flash_attention)
        launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
        loss_p, g_p = _value_and_grad(params, batch, gcfg, ref.flash_attention)
        torch.cuda.synchronize()
        rel = _rel_l2(g_k, g_p)
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        line = (f"gradient check {dtype_name}, {GRAD_LAYERS} layers at internlm2 widths, "
                f"{TRAIN_BATCH} x {TRAIN_LEN}: loss {loss_k:.8f} on the kernel, {loss_p:.8f} on "
                f"the plain attention (relative {loss_rel:.3e}); gradient relative L2 error max "
                f"{rel[worst]:.3e} ({worst}), median {float(np.median(list(rel.values()))):.3e} "
                f"over {len(rel)} leaves; kernel launches "
                f"{launched['flash_attention_' + dtype_name]}")
        if dtype_name == "float32":
            if (loss_rel > GRAD_LOSS_RTOL or rel[worst] > GRAD_LEAF_RTOL
                    or launched["flash_attention_float32"] != 2 * GRAD_LAYERS
                    or not all(torch.isfinite(g).all() for g in g_k.values())):
                fail(f"{line} (want the loss within {GRAD_LOSS_RTOL}, every leaf within "
                     f"{GRAD_LEAF_RTOL}, {2 * GRAD_LAYERS} float32 launches)")
            line += f" (gated: loss {GRAD_LOSS_RTOL}, a leaf {GRAD_LEAF_RTOL})"
        else:
            line += " (printed, not gated)"
        log(line)
        del params, g_k, g_p
        torch.cuda.empty_cache()

    # (d) the Trainer with store checkpoints: a main path, counted.
    trainer_counts = _trainer_checkpoints(cfg, dev)
    return {k: train_counts[k] + trainer_counts[k] for k in train_counts}


def _trainer_checkpoints(cfg, dev) -> dict[str, int]:
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import ModelServer
    from repro_torch.launch.train import Trainer
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    tcfg = dataclasses.replace(cfg, n_layers=TRAINER_LAYERS)
    log(f"trainer: {cfg.name} widths, depth cut from {cfg.n_layers} layers to {TRAINER_LAYERS} "
        f"(the checkpoint saves are host numpy), {tcfg.param_dtype}; {TRAINER_BATCH} x "
        f"{TRAINER_LEN} batches")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_train_") as root:
        ops.reset_launch_counts()
        saves = []
        tr = Trainer(tcfg, root, ckpt_every=2, seed=SEED, device=dev)
        _time_saves(tr, saves)
        rep = tr.fit(steps=3, batch=TRAINER_BATCH, seq=TRAINER_LEN)
        first_counts = ops.launch_counts()
        log(f"trainer fit: steps {rep.start_step}-{rep.end_step}, losses {rep.losses}, step s "
            f"{[round(t, 4) for t in rep.step_seconds]}, checkpoint saves (step, s) {saves} "
            f"(step 2 async, step 3 blocking); launches {first_counts}")
        if rep.resumed or not all(np.isfinite(rep.losses)) or [s for s, _ in saves] != [2, 3]:
            fail(f"trainer fit: resumed {rep.resumed}, losses {rep.losses}, saves {saves}")
        # The same steps replayed on the plain attention (a check, not counted).
        params = init_params(tcfg, tr.seed, dev)
        opt = adamw_init(params)
        plain, kernel_attention = [], ops.flash_attention
        try:
            ops.flash_attention = ref.flash_attention
            for step in range(rep.start_step, rep.end_step):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in tr.data.batch(step, TRAINER_BATCH, TRAINER_LEN).items()}
                params, opt, metrics = tr.step_fn(params, opt, batch)
                plain.append(float(metrics["loss"]))
        finally:
            ops.flash_attention = kernel_attention
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rep.losses, plain))
        line = (f"trainer losses against the same steps on the plain attention {plain}: "
                f"max relative difference {loss_rel:.3e} (TRAINER_LOSS_RTOL {TRAINER_LOSS_RTOL})")
        if not loss_rel <= TRAINER_LOSS_RTOL:
            fail(line)
        log(line)
        del params, opt
        # The second Trainer's resume: what its fit runs before its first step.
        tr2 = Trainer(tcfg, root, ckpt_every=2, seed=SEED, device=dev)
        t0 = time.perf_counter()
        step, params, opt, resumed = tr2._init_or_resume()
        resume_s = time.perf_counter() - t0
        got = _flatten({"params": params, "opt": opt})
        want = _flatten({"params": tr._params, "opt": tr._opt})
        worst = {}
        for key, w in want.items():
            g = got.get(key)
            if g is None or g.dtype != w.dtype or g.device.type != dev.type:
                fail(f"resume: leaf {key} {None if g is None else (g.dtype, g.device)}, want "
                     f"{w.dtype} on the card")
            worst[key] = float((g.double() - w.double()).abs().max())
        bad = {k: d for k, d in worst.items() if d > RESTORE_ATOL.get(want[k].dtype, 0.0)}
        log(f"trainer resume: a second Trainer on the store: resumed {resumed}, start step "
            f"{step} (saved {rep.end_step}), restore {resume_s:.6f} s; restored leaves against "
            f"the first trainer's: max abs diff params "
            f"{max(d for k, d in worst.items() if k.startswith('params')):.3e}, m "
            f"{max(d for k, d in worst.items() if k.startswith('opt//m')):.3e}, v "
            f"{max(d for k, d in worst.items() if k.startswith('opt//v')):.3e}, step "
            f"{int(opt['step'])} ({opt['step'].dtype}); RESTORE_ATOL {RESTORE_ATOL}")
        if (not resumed or step != rep.end_step or bad or set(got) != set(want)
                or int(opt["step"]) != rep.end_step):
            fail(f"trainer resume: resumed {resumed}, step {step}, leaves past RESTORE_ATOL "
                 f"{bad}")
        counts = first_counts
        del params, opt

        ops.reset_launch_counts()
        srv = ModelServer(tcfg, root, bits=None, device=dev)
        t0 = time.perf_counter()
        served = srv.load()
        load_s = time.perf_counter() - t0
        prompts = np.random.default_rng(SEED + 8).integers(0, tcfg.vocab_size,
                                                            (BATCH, PROMPT_LEN))
        toks, stats = srv.generate(served, prompts, max_new_tokens=STEPS)
        for k, n in ops.launch_counts().items():
            counts[k] += n
        if served != rep.end_step or toks.shape != (BATCH, STEPS):
            fail(f"trainer server: step {served}, tokens {toks.shape}")
        # The server's parameters against the trained ones.
        restored, trained = _flatten(srv._models[served]), _flatten(tr._params)
        if sorted(restored) != sorted(trained):
            fail(f"trainer server: restored tensors {sorted(restored)}")
        diffs = {k: float((restored[k].double() - t.double()).abs().max())
                 for k, t in trained.items()}
        bad = {k: d for k, d in diffs.items() if d > RESTORE_ATOL.get(trained[k].dtype, 0.0)}
        if bad:
            fail(f"trainer server: restored tensors past RESTORE_ATOL {bad}")
        # The server's decode loop run again on its parameters, for its
        # logits: its tokens must be the server's, and its logits those of
        # the in-memory decode of the trained parameters, step by step until
        # a near tie splits the two (the first step's are the prompt's).
        prompts_t = torch.from_numpy(prompts).to(dev)
        got_toks, got_logits = _greedy(srv._models[served], tcfg, prompts_t, STEPS)
        if not torch.equal(torch.from_numpy(toks).to(dev, torch.int64), got_toks):
            fail("trainer server: its tokens differ from its decode loop's on the same "
                 "parameters")
        want_toks, want_logits = _greedy(tr._params, tcfg, prompts_t, STEPS)
        compared = _check_tokens("trainer server", got_toks, want_toks, want_logits, 2 ** -7)
        rel = [float((got_logits[:, i].double() - want_logits[:, i].double()).norm()
                     / want_logits[:, i].double().norm()) for i in range(compared)]
        max_abs = float((got_logits[:, :compared] - want_logits[:, :compared]).abs().max())
        line = (f"trainer server: step {served} loaded in {load_s:.6f} s, "
                f"{stats['tokens_per_s']:.6f} tokens/s; restored tensors against the trained "
                f"ones max abs diff {max(diffs.values()):.3e} (RESTORE_ATOL); tokens equal the "
                f"in-memory decode of the trained parameters over {compared} steps, logits "
                f"relative L2 error max {max(rel):.3e} (SERVED_LOGITS_RTOL "
                f"{SERVED_LOGITS_RTOL:.3e}), max abs {max_abs:.3e}")
        if max(rel) > SERVED_LOGITS_RTOL:
            fail(line)
        log(line)
        srv.mgr.close()
        # The same checkpoint loaded at bits=8 (the int8 planes of each
        # delta), generating from the same prompts.
        ops.reset_launch_counts()
        t8 = time.perf_counter()
        srv8 = ModelServer(tcfg, root, bits=8, device=dev)
        t0 = time.perf_counter()
        served8 = srv8.load()
        torch.cuda.synchronize()
        load8_s = time.perf_counter() - t0
        toks8, stats8 = srv8.generate(served8, prompts, max_new_tokens=STEPS)
        for k, n in ops.launch_counts().items():
            counts[k] += n
        if (served8 != rep.end_step or toks8.shape != (BATCH, STEPS) or toks8.min() < 0
                or toks8.max() >= tcfg.vocab_size):
            fail(f"trainer server bits=8: step {served8}, tokens {toks8.shape}")
        restored8 = _flatten(srv8._models[served8])
        if sorted(restored8) != sorted(trained):
            fail(f"trainer server bits=8: restored tensors {sorted(restored8)}")
        diffs8 = [float((restored8[k].double() - t.double()).abs().max())
                  for k, t in trained.items()]
        log(f"trainer server bits=8: step {served8} loaded in {load8_s:.6f} s, prompt "
            f"{stats8['prefill_s']:.6f} s, {stats8['tokens_per_s']:.6f} tokens/s "
            f"({stats8['decode_s'] / STEPS * 1e3:.6f} ms/step, batch {BATCH}); restored tensors "
            f"bit-equal to the trained ones {sum(d == 0 for d in diffs8)} of {len(diffs8)}, max "
            f"abs diff {max(diffs8):.3e}; {float((toks8 == toks).mean()):.3f} of tokens equal "
            f"the bits=None decode; {time.perf_counter() - t8:.3f} s in all")
        srv8.mgr.close()
        tr.mgr.close()
        tr2.mgr.close()
    del tr, tr2, srv, srv8, restored8
    torch.cuda.empty_cache()
    return counts


def _time_saves(trainer, saves: list) -> None:
    """Record (step, seconds) of each store save a trainer makes: the
    engine's own save timing, in whichever thread the save runs."""
    engine = trainer.mgr.engine
    save_model = engine.save_model

    def timed(name, architecture, tensors, *args, **kwargs):
        report = save_model(name, architecture, tensors, *args, **kwargs)
        saves.append((int(architecture["step"]), round(report.seconds, 6)))
        return report

    engine.save_model = timed


def _qleaves(tree, path=()):
    """(path, storage-format leaf) of a quantized tree, in the order and
    with the names of ``checkpoint.manager._flatten``."""
    from repro_torch.checkpoint.manager import SEP

    if isinstance(tree, dict) and ("raw" in tree or "base" in tree):
        yield SEP.join(path), tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _qleaves(tree[key], path + (str(key),))
    else:
        for i, item in enumerate(tree):
            yield from _qleaves(item, path + (str(i),))


def _serve_loop(step_fn, params, cfg, first: torch.Tensor, steps: int):
    """``steps`` greedy tokens from ``first`` (B, 1) through ``step_fn``
    (a serve step), each fed back: ((B, steps) tokens, median ms a step,
    host-inclusive, each step synchronized)."""
    from repro_torch.models import init_cache

    cache = init_cache(cfg, first.shape[0], steps + 1, device=first.device)
    tok, toks, times = first, [], []
    for pos in range(steps):
        t0 = time.perf_counter()
        nxt, cache = step_fn(params, cache, {"tokens": tok}, pos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        toks.append(nxt)
        tok = nxt[:, None].to(torch.int64)
    return torch.stack(toks, dim=1), float(np.median(times))


def phase_host_quantized(dev_info: dict) -> dict[str, int]:
    """Phase 11: host-quantized compressed serving and the error-feedback
    gradient sync, internlm2-1.8b widths at HOSTQ_LAYERS layers."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.compression import (
        cross_pod_sync,
        dequantize_grad,
        init_error_state,
        quantize_grad,
    )
    from repro_torch.kernels import ops
    from repro_torch.launch import compressed_serve as cs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_params

    cfg = dataclasses.replace(_internlm2(), n_layers=HOSTQ_LAYERS)
    log(f"host-quantized: {cfg.name} widths, depth cut from {_internlm2().n_layers} to "
        f"{HOSTQ_LAYERS} layers (quantize_params is host numpy), {cfg.param_dtype}")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    params = init_params(cfg, SEED + 11, device=dev)
    flat = _flatten(params)

    # (a) the storage format, on the host.
    t0 = time.perf_counter()
    qparams = cs.quantize_params(params)
    quant_s = time.perf_counter() - t0
    qflat = dict(_qleaves(qparams))
    raw = sorted(k for k, q in qflat.items() if "raw" in q)
    want_raw = sorted(k for k in flat if k.rsplit("//", 1)[-1] in ("norm1", "norm2", "final_norm"))
    stored = sum(q["raw"].numel() * q["raw"].element_size() if "raw" in q else
                 q["base"].nbytes + q["packed"].nbytes + 5 * 4 for q in qflat.values())
    bf16 = sum(t.numel() * 2 for t in flat.values())
    log(f"host-quantized (a): quantize_params {quant_s:.6f} s for "
        f"{sum(t.numel() for t in flat.values())} parameters; {len(qflat) - len(raw)} leaves "
        f"quantized, {len(raw)} raw {raw}; storage format {stored} bytes against {bf16} "
        f"bfloat16 bytes ({stored / bf16:.6f})")
    if sorted(qflat) != sorted(flat) or raw != want_raw:
        fail(f"host-quantized (a): raw leaves {raw}, want the norms {want_raw}")

    # (b) placed on the card: the reconstruction bit for bit against the CPU's,
    # and each bfloat16 reconstruction within HOSTQ_BINS delta bins plus one
    # bfloat16 rounding of the original value.
    t0 = time.perf_counter()
    placed = cs.quantized_to_device(qparams, dev)
    on_host = cs.quantized_to_device(qparams, "cpu")
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dtype = getattr(torch, cfg.compute_dtype)
    recon_params = cs._map_quantized(lambda q: cs.dequantize_leaf(q, dtype), placed)
    recon, host, worst = _flatten(recon_params), dict(_qleaves(on_host)), 0.0
    for key, q in _qleaves(placed):
        if "raw" in q:
            continue
        got = cs.dequantize_leaf(q, torch.float32).cpu().view(torch.int32)
        want = cs.dequantize_leaf(host[key], torch.float32).view(torch.int32)
        if not torch.equal(got, want):
            fail(f"host-quantized (b): {key}: {int((got != want).sum())} float32 "
                 f"reconstructions differ from the CPU's")
        del got, want
        w = flat[key].double()
        err = (recon[key].double() - w).abs()
        bound = HOSTQ_BINS * float(q["ds"]) + 2.0 ** -8 * w.abs()
        worst = max(worst, float((err / bound).max()))
        del w, err, bound
    check_s = time.perf_counter() - t0
    line = (f"host-quantized (b): placed on the card in {place_s:.6f} s; every quantized leaf's "
            f"float32 reconstruction on the card bit-identical to the CPU's; {dtype} "
            f"reconstruction against the original: max |err| / ({HOSTQ_BINS:.6f} ds + 2^-8 |w|) "
            f"{worst:.6f} ({check_s:.6f} s)")
    if worst > 1.0:
        fail(line)
    log(line)
    del on_host, host

    # (c) greedy serve steps on the storage format, on the reconstructed
    # parameters, and on the original ones.
    first = torch.from_numpy(np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (BATCH, 1))).to(dev)
    got, comp_ms = _serve_loop(cs.make_compressed_serve_step(cfg), placed, cfg, first, STEPS)
    want, recon_ms = _serve_loop(make_serve_step(cfg), recon_params, cfg, first, STEPS)
    orig, orig_ms = _serve_loop(make_serve_step(cfg), params, cfg, first, STEPS)
    same_steps = float((got == orig).all(dim=0).float().mean())
    line = (f"host-quantized (c): {STEPS} greedy steps at batch {BATCH}: compressed step "
            f"{comp_ms:.6f} ms, the serve step over the reconstructed parameters "
            f"{recon_ms:.6f} ms, over the original ones {orig_ms:.6f} ms (median, "
            f"host-inclusive); tokens equal the reconstructed parameters' serve loop "
            f"{bool(torch.equal(got, want))}; {same_steps:.6f} of steps equal the original "
            f"parameters' serve loop")
    if not torch.equal(got, want):
        fail(line)
    log(line)
    del placed, recon, recon_params, got, want, orig
    torch.cuda.empty_cache()

    # (d) the gradient sync over a world-size-1 NCCL group and a ("pod",) mesh.
    data = SyntheticLM(cfg.vocab_size, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0, HOSTQ_GRAD_BATCH, HOSTQ_GRAD_LEN).items()}
    loss, grads = _value_and_grad(params, batch, cfg, ops.flash_attention)
    counts = ops.launch_counts()
    del params, flat
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        errs = init_error_state(grads)
        sync_ms = []  # the first call sets up the NCCL communicator
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synced, new_errs = cross_pod_sync(grads, errs, mesh)
            torch.cuda.synchronize()
            sync_ms.append((time.perf_counter() - t0) * 1e3)
        worst_err = 0.0
        for key, g in grads.items():
            codes, scale, err = quantize_grad(g.cpu(), 0)
            want = dequantize_grad(codes, scale)
            on_card = quantize_grad(g, 0)
            if not (torch.equal(synced[key].cpu(), want.to(g.dtype))
                    and torch.equal(new_errs[key].cpu(), err)
                    and torch.equal(on_card[0].cpu(), codes)):
                fail(f"host-quantized (d): {key}: the sync on the card differs from the CPU path")
            if int(codes.abs().max()) > 127 or synced[key].dtype != g.dtype:
                fail(f"host-quantized (d): {key}: codes beyond [-127, 127] or dtype "
                     f"{synced[key].dtype}")
            g32 = g.cpu().to(torch.float32)
            if not torch.equal(err, g32 - want):
                fail(f"host-quantized (d): {key}: new_err is not g32 - deq")
            worst_err = max(worst_err, float(err.abs().max() / scale))
        gathered = sum(g.numel() + 4 for g in grads.values())
        f32_bytes = sum(g.numel() * 4 for g in grads.values())
        # The reference test's error-feedback loop on one real leaf.
        ref_amax = float(np.abs(np.random.default_rng(0).normal(0, 1e-3, (64, 64))
                                .astype(np.float32)).max())
        g = grads[EF_LEAF].to(torch.float32)
        g = g * (ref_amax / g.abs().max())
        err, acc = torch.zeros_like(g), torch.zeros_like(g)
        for _ in range(EF_STEPS):
            codes, scale, err = quantize_grad(g, err, nbit=EF_NBIT)
            acc += codes.to(torch.float32) * scale
        ef_err = float((acc / EF_STEPS - g).abs().max())
    finally:
        dist.destroy_process_group()
    line = (f"host-quantized (d): loss {loss:.6f}; cross_pod_sync of {len(grads)} gradient "
            f"leaves over NCCL (world size 1): {sync_ms[1]:.6f} ms (the first call, which "
            f"sets up the communicator, {sync_ms[0]:.6f} ms), {gathered} bytes gathered "
            f"against {f32_bytes} float32 bytes ({gathered / f32_bytes:.6f}); every leaf "
            f"bit-identical to the CPU path, max |new_err| / scale {worst_err:.6f}; error "
            f"feedback on {EF_LEAF} ({tuple(g.shape)}, scaled to amax {ref_amax:.6e}) over "
            f"{EF_STEPS} steps at {EF_NBIT} bits: max abs error {ef_err:.3e} (atol {EF_ATOL})")
    if worst_err > 0.5 + 2.0 ** -16 or not ef_err <= EF_ATOL:
        fail(line)
    log(line)
    del grads, synced, new_errs, g, err, acc
    torch.cuda.empty_cache()
    return counts


def _tree_gap(got, want) -> tuple[bool, float]:
    """(bit-identical, max |got - want| in float64) over two trees of
    tensors, DTensors gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    same, gap = True, 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        g = g.full_tensor() if isinstance(g, DTensor) else g
        if g.dtype != w.dtype or g.shape != w.shape:
            return False, float("inf")
        if not torch.equal(g, w):
            same = False
            gap = max(gap, float((g.double() - w.double()).abs().max()))
    return same, gap


def _digest(tree) -> list[tuple[int, int]]:
    """Each tensor leaf's bits, summed on the card as int64 plainly and
    weighted by position (DTensors by their local shards): two trees whose
    leaves differ in any bit differ here but for a collision of both sums."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    chunk = 1 << 26
    weights = torch.arange(chunk, dtype=torch.int64, device="cuda") % 65521 + 1
    out = []
    for x in tree_leaves(tree):
        x = x.to_local() if isinstance(x, DTensor) else x
        bits = x.contiguous().reshape(-1).view(ints[x.element_size()])
        plain = weighted = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(0, bits.numel(), chunk):
            part = bits[i:i + chunk].to(torch.int64)
            plain = plain + part.sum()
            weighted = weighted + (part * weights[:part.numel()]).sum() * (i // chunk + 1)
        out.append((int(plain), int(weighted)))
    return out


def _pod_recurrent(dev, mesh, seam: dict, route_ms: dict) -> None:
    """Phase 12 (d): the recurrent models' train steps and serve path on
    ``mesh`` (one rank) under the "tp" table, on the tp route (asked for by
    name) and the gathered one in turns, each held to the unsharded path's
    bits; recurrentgemma's local attention launches at head dim 256
    (forward and remat's recompute) counted, on the tp route all through
    the seam."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import adamw_init

    b = POD_PREFILL[0]
    for arch, cut in POD_RECURRENT.items():
        cfg = dataclasses.replace(get_config(arch), **cut)
        tcfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size,
                                                       POD_RECURRENT_TRAIN_VOCAB))
        attn = sum(kind == "local_attn" for kind in cfg.period) * cfg.n_periods
        log(f"pod mesh (d) {arch}: {cfg.n_layers} layers {cfg.period}, d_model {cfg.d_model}, "
            f"d_rnn {cfg.d_rnn}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} ({tcfg.vocab_size} in "
            f"the train steps), {cfg.param_dtype}, remat {cfg.remat}; {POD_RECURRENT_STEPS} "
            f"train steps at {TRAIN_BATCH} x {TRAIN_LEN}, a {POD_PREFILL[0]} x "
            f"{POD_PREFILL[1]} prefill and {STEPS} serve steps, on the tp and gathered routes "
            f"in {POD_TURNS} turns")

        def counted(run):
            """``run()``'s result, the dh-256 launches and the calls through
            the seam it made."""
            before, calls = ops.launch_counts()["flash_attention_bfloat16_dh256"], seam["calls"]
            out = run()
            return (out, ops.launch_counts()["flash_attention_bfloat16_dh256"] - before,
                    seam["calls"] - calls)

        # (d1) the train steps
        data = SyntheticLM(tcfg.vocab_size, seed=SEED + 12)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    data.batch(i, TRAIN_BATCH, TRAIN_LEN).items()}
                   for i in range(POD_RECURRENT_STEPS)]
        params0 = init_params(tcfg, SEED + 12, device=dev)

        def train(step, place=lambda t, _s: t, specs=(None, None)):
            """(each step's (loss, digest of params and moments), ms a step,
            peak bytes)."""
            torch.cuda.reset_peak_memory_stats()
            params, opt = place(params0, specs[0]), place(adamw_init(params0), specs[1])
            got, ms = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                got.append((float(m["loss"]), _digest([params, opt])))
            return got, ms, torch.cuda.max_memory_allocated()

        # The unsharded steps, twice: bit-identity below presumes a step that
        # repeats its own bits.
        plain = make_train_step(tcfg, 1, lr=TRAIN_LR)
        (want, plain_ms, plain_peak), want_launched, _ = counted(lambda: train(plain))
        repeats = train(plain)[0] == want
        log(f"pod mesh (d1) {arch}: unsharded train steps {[round(t, 3) for t in plain_ms]} ms, "
            f"losses {[round(loss, 6) for loss, _ in want]}, peak {plain_peak} bytes, "
            f"{want_launched} dh-256 launches; a second run bit-identical {repeats}")
        if not repeats or want_launched != 2 * attn * POD_RECURRENT_STEPS:
            fail(f"pod mesh (d1) {arch}: the unsharded step repeats its bits {repeats}, "
                 f"{want_launched} dh-256 launches (want {2 * attn * POD_RECURRENT_STEPS})")
        with sh.use_mesh(mesh) as ctx:
            p_spec = shd.param_specs_tree(params0, ctx)
            o_spec = shd.opt_specs_tree(None, p_spec)
            rows = shd.per_batch(shd.batch_specs_tree(batches[0], ctx))
            steps = [shd.sharded(plain, (p_spec, o_spec, rows), (p_spec, o_spec, None), ctx,
                                 cfg=tcfg, route=r) for r in _asked("tp")]
        if [st.route for st in steps] != ["tp", "gathered"]:
            fail(f"pod mesh (d1) {arch}: routes {[st.route for st in steps]}")
        placed = lambda t, s: shd.place(t, s, mesh)  # noqa: E731
        for turn in range(POD_TURNS):
            for step in steps:
                (got, ms, peak), launched, calls = counted(
                    lambda: train(step, placed, (p_spec, o_spec)))  # noqa: B023
                route_ms.setdefault(f"train {arch} {step.route}", []).extend(ms)
                line = (f"pod mesh (d1) {arch} route {step.route} turn {turn}: sharded train "
                        f"steps {[round(t, 3) for t in ms]} ms (unsharded "
                        f"{[round(t, 3) for t in plain_ms]}), peak {peak} bytes, {launched} "
                        f"dh-256 launches (want {want_launched}), {calls} through the seam; "
                        f"every step's loss and the digests of its params and moments equal to "
                        f"the unsharded step's {got == want}")
                if not (got == want and launched == want_launched
                        and calls == (launched if step.route == "tp" else 0)):
                    fail(line)
                log(line)
        del params0, batches, steps
        torch.cuda.empty_cache()

        # (d2) the serve path, under the serving rules
        params0 = init_params(cfg, SEED + 12, device=dev)
        prompts = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
            0, cfg.vocab_size, POD_PREFILL)).to(dev)

        def serve(prefill, step, params, cache):
            """(the prefill's logits, the tokens, the cache's digest, prefill
            ms, median serve ms)."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": prompts})
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            toks, times = [tok], []
            for pos in range(STEPS):
                t0 = time.perf_counter()
                tok, cache = step(params, cache, {"tokens": tok[:, None].long()}, pos)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                toks.append(tok)
            return logits, torch.stack(toks, dim=1), _digest(cache), prefill_ms, float(
                np.median(times))

        runs = [counted(lambda: serve(make_prefill_step(cfg), make_serve_step(cfg), params0,
                                      init_cache(cfg, b, STEPS, device=dev)))
                for _ in range(2)]
        want, want_launched, _ = runs[0]
        again = runs[1][0]
        repeats = (torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
                   and again[2] == want[2])
        log(f"pod mesh (d2) {arch}: unsharded prefill {again[3]:.6f} ms, serve step "
            f"{again[4]:.6f} ms, {want_launched} dh-256 launches a prefill; a second run "
            f"bit-identical {repeats}")
        if not repeats or want_launched != attn:
            fail(f"pod mesh (d2) {arch}: the unsharded path repeats its bits {repeats}, "
                 f"{want_launched} dh-256 launches (want {attn})")
        del runs, again
        with sh.use_mesh(mesh, seq_shard=False, serve=True) as ctx:
            p_spec = shd.param_specs_tree(params0, ctx)
            c_spec = shd.cache_specs_tree(init_cache(cfg, b, STEPS, device=dev), ctx,
                                          cfg.n_kv_heads)
            rows = shd.per_batch(shd.batch_specs_tree({"tokens": prompts}, ctx))
            paths = [(shd.sharded(make_prefill_step(cfg), (p_spec, rows),
                                  (shd.per_batch(None),), ctx, cfg=cfg, route=r),
                      shd.sharded(make_serve_step(cfg), (p_spec, shd.per_batch(c_spec), rows,
                                                         None),
                                  (shd.per_batch(None), shd.per_batch(c_spec)), ctx, cfg=cfg,
                                  route=r)) for r in _asked("tp")]
        if [srv.route for _, srv in paths] != ["tp", "gathered"]:
            fail(f"pod mesh (d2) {arch}: routes {[srv.route for _, srv in paths]}")
        sp = shd.place(params0, p_spec, mesh)
        for turn in range(POD_TURNS):
            for prefill, srv in paths:
                route = srv.route
                (logits, toks, cache, prefill_ms, serve_ms), launched, calls = counted(
                    lambda: serve(prefill, srv, sp,  # noqa: B023
                                  shd.place(init_cache(cfg, b, STEPS, device=dev), c_spec, mesh)))
                route_ms.setdefault(f"prefill {arch} {route}", []).append(prefill_ms)
                route_ms.setdefault(f"serve {arch} {route}", []).append(serve_ms)
                gap = float((logits - want[0]).abs().max())
                ok = torch.equal(toks, want[1]) and cache == want[2]
                line = (f"pod mesh (d2) {arch} route {route} turn {turn}: sharded prefill "
                        f"{prefill_ms:.6f} ms, serve step {serve_ms:.6f} ms; {launched} dh-256 "
                        f"launches (want {attn}), {calls} through the seam; prefill logits max "
                        f"gap {gap:.3e}; tokens and the cache's digest equal {ok}")
                if not (ok and gap == 0.0 and launched == attn
                        and calls == (launched if route == "tp" else 0)):
                    fail(line)
                log(line)
        del params0, sp, paths, want
        torch.cuda.empty_cache()


def phase_pod_mesh() -> dict[str, int]:
    """Phase 12: the sharded train and serve steps and the elastic restore
    on DTensor state, each against its unsharded counterpart; under the
    "tp" tables on the tensor-parallel route and the gathered one, in
    turns."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.launch.train import restore_sharded
    from repro_torch.models import init_cache, init_params, layers
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tcfg = dataclasses.replace(_internlm2(), n_layers=POD_LAYERS)
    scfg = dataclasses.replace(get_config("glm4-9b"), n_layers=POD_LAYERS)
    log(f"pod mesh: sharded train step at {tcfg.name} widths and serve path at {scfg.name} "
        f"widths (d_model {scfg.d_model}, {scfg.n_heads} heads on {scfg.n_kv_heads} KV heads "
        f"of {scfg.d_head}, d_ff {scfg.d_ff}, vocab {scfg.vocab_size}), depth cut to "
        f"{POD_LAYERS} layers, {tcfg.param_dtype}; meshes {[m for m, _ in POD_MESHES]} under "
        f"{POD_PROFILES} over a world-size-1 NCCL group; the \"tp\" tables on the \"tp\" and "
        f"\"gathered\" routes in {POD_TURNS} turns")
    data = SyntheticLM(tcfg.vocab_size, seed=SEED + 12)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.batch(i, TRAIN_BATCH, TRAIN_LEN).items()} for i in range(POD_TRAIN_STEPS)]
    params0 = init_params(tcfg, SEED + 12, device=dev)
    # The attention calls the seam makes: inside a tensor-parallel step,
    # on each rank's local tensors (not DTensors).
    seam = {"calls": 0}
    attention = layers.chunked_attention

    def seam_spy(q, k, v, **kw):
        if sh.compute_mesh() is not None and not isinstance(q, DTensor):
            seam["calls"] += 1
        return attention(q, k, v, **kw)

    def train_run(step, params, opt, want=None):
        """POD_TRAIN_STEPS steps: the (loss, params, opt) of each (kept when
        ``want`` is None, else each held to ``want``'s: (bit-identical,
        relative loss gap, max state gap) a step), the ms a step and the
        bf16 attention launches."""
        kept, gaps, ms, launches = [], [], [], 0
        for i, b in enumerate(batches):
            before = ops.launch_counts()["flash_attention_bfloat16"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches += ops.launch_counts()["flash_attention_bfloat16"] - before
            if want is None:
                kept.append([m["loss"], params, opt])
            else:
                same, state_gap = _tree_gap([m["loss"], params, opt], want[i])
                loss_rel = abs(float(m["loss"]) - float(want[i][0])) / abs(float(want[i][0]))
                gaps.append((same, loss_rel, _tree_gap([params, opt], want[i][1:])[1]))
        return kept, gaps, ms, launches

    # The unsharded path, twice: the second run says whether the step gives
    # the same bits twice, which bit-identity below presumes.
    plain = make_train_step(tcfg, 1, lr=TRAIN_LR)
    want, _, plain_ms, _ = train_run(plain, params0, adamw_init(params0))
    _, repeat, _, _ = train_run(plain, params0, adamw_init(params0), want)
    repeat_same = all(same for same, _, _ in repeat)
    repeat_gap = max(max(loss, gap) for _, loss, gap in repeat)
    log(f"pod mesh (a): unsharded train steps {[round(t, 3) for t in plain_ms]} ms, losses "
        f"{[round(float(w[0]), 6) for w in want]}; a second unsharded run bit-identical "
        f"{repeat_same} (max gap {repeat_gap:.3e})")

    sparams = init_params(scfg, SEED + 12, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, scfg.vocab_size, POD_PREFILL)).to(dev)
    b = POD_PREFILL[0]

    def serve_run(prefill, serve, params, cache):
        """The prefill's first token, then STEPS greedy tokens, each fed
        back: ((B, STEPS + 1) tokens, the final cache, prefill ms, median
        ms a serve step, the prefill's (B, V) logits)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, times = [tok], []
        for pos in range(STEPS):
            t0 = time.perf_counter()
            tok, cache = serve(params, cache, {"tokens": tok[:, None].long()}, pos)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
        return torch.stack(toks, dim=1), cache, prefill_ms, float(np.median(times)), logits

    # Unsharded, twice: the second run's times are warm, and its bits say
    # whether the path repeats itself.
    runs = [serve_run(make_prefill_step(scfg), make_serve_step(scfg), sparams,
                      init_cache(scfg, b, STEPS, device=dev)) for _ in range(2)]
    want_toks, want_cache = runs[0][:2]
    want_logits = runs[0][4]
    plain_prefill_ms, plain_serve_ms = runs[1][2:4]
    serve_repeats = (bool(torch.equal(runs[1][0], want_toks))
                     and _tree_gap(runs[1][1], want_cache)[0])
    log(f"pod mesh (b): unsharded prefill {plain_prefill_ms:.6f} ms (first call "
        f"{runs[0][2]:.6f}), serve step {plain_serve_ms:.6f} ms (median of {STEPS}); a second "
        f"run's tokens and cache bit-identical {serve_repeats}; tokens {want_toks[:, :4].tolist()}")
    del runs
    route_ms: dict[str, list] = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    layers.chunked_attention = seam_spy
    try:
        ops.reset_launch_counts()
        for shape, names in POD_MESHES:
            mesh = make_mesh(shape, names)
            multi_pod = "pod" in names
            for profile in POD_PROFILES:
                what = f"{shape} {profile}"
                # (a) the sharded train step, on each route of the table
                train_step = make_train_step(tcfg, 1, lr=TRAIN_LR)
                with sh.use_mesh(mesh, multi_pod=multi_pod, profile=profile) as ctx:
                    p_spec = shd.param_specs_tree(params0, ctx)
                    o_spec = shd.opt_specs_tree(None, p_spec)
                    b_spec = shd.batch_specs_tree(batches[0], ctx)
                    specs = ((p_spec, o_spec, shd.per_batch(b_spec)), (p_spec, o_spec, None), ctx)
                    # "tp" asked for by name; the default route at one rank.
                    steps = [shd.sharded(train_step, *specs, cfg=tcfg, route=r)
                             for r in _asked(profile)]
                want_routes = ["tp", "gathered"] if profile == "tp" else ["gathered"]
                if [st.route for st in steps] != want_routes:
                    fail(f"pod mesh (a) {what}: routes {[st.route for st in steps]}, want "
                         f"{want_routes}")
                for turn in range(_turns(shape, profile)):
                    for step in steps:
                        calls = seam["calls"]
                        _, gaps, ms, launches = train_run(
                            step, shd.place(params0, p_spec, mesh),
                            shd.place(adamw_init(params0), o_spec, mesh), want)
                        calls = seam["calls"] - calls
                        route_ms.setdefault(f"train {what} {step.route}", []).extend(ms)
                        same = all(s for s, _, _ in gaps)
                        loss_rel = max(loss for _, loss, _ in gaps)
                        gap = max(g for _, _, g in gaps)
                        line = (f"pod mesh (a) {what} route {step.route} turn {turn}: sharded "
                                f"train steps {[round(t, 3) for t in ms]} ms (unsharded "
                                f"{[round(t, 3) for t in plain_ms]}), {launches} bf16 "
                                f"flash_attention launches (want {2 * POD_LAYERS * POD_TRAIN_STEPS}"
                                f"), {calls} through the seam; every step's loss, params and "
                                f"moments bit-identical to the unsharded step's {same} (loss "
                                f"relative gap {loss_rel:.3e}, params and moments max gap "
                                f"{gap:.3e})")
                        # Bit-identity presumes a step that repeats its own
                        # bits; if the unsharded step did not, the sharded
                        # one may differ by as much as the unsharded repeat
                        # did.
                        ok = (launches == 2 * POD_LAYERS * POD_TRAIN_STEPS
                              and calls == (launches if step.route == "tp" else 0)
                              and (same or (not repeat_same
                                            and max(loss_rel, gap) <= repeat_gap)))
                        if not ok:
                            fail(line)
                        log(line)
                # (b) the sharded serve path, under the serving rules
                with sh.use_mesh(mesh, multi_pod=multi_pod, seq_shard=False, serve=True,
                                 profile=profile) as ctx:
                    cache = init_cache(scfg, b, STEPS, device=dev)
                    p_spec = shd.param_specs_tree(sparams, ctx)
                    c_spec = shd.cache_specs_tree(cache, ctx, scfg.n_kv_heads)
                    rows = shd.per_batch(shd.batch_specs_tree({"tokens": prompts}, ctx))
                    pre, srv = make_prefill_step(scfg), make_serve_step(scfg)
                    paths = [(shd.sharded(pre, (p_spec, rows), (shd.per_batch(None),), ctx,
                                          cfg=scfg, route=r),
                              shd.sharded(srv, (p_spec, shd.per_batch(c_spec), rows, None),
                                          (shd.per_batch(None), shd.per_batch(c_spec)), ctx,
                                          cfg=scfg, route=r))
                             for r in _asked(profile)]
                if [srv.route for _, srv in paths] != want_routes:
                    fail(f"pod mesh (b) {what}: routes {[srv.route for _, srv in paths]}, want "
                         f"{want_routes}")
                sp = shd.place(sparams, p_spec, mesh)
                for turn in range(_turns(shape, profile)):
                    for prefill, serve in paths:
                        route = serve.route
                        before = ops.launch_counts()["flash_attention_bfloat16"]
                        calls = seam["calls"]
                        toks, cache, prefill_ms, serve_ms, logits = serve_run(
                            prefill, serve, sp,
                            shd.place(init_cache(scfg, b, STEPS, device=dev), c_spec, mesh))
                        launched = ops.launch_counts()["flash_attention_bfloat16"] - before
                        calls = seam["calls"] - calls
                        route_ms.setdefault(f"prefill {what} {route}", []).append(prefill_ms)
                        route_ms.setdefault(f"serve {what} {route}", []).append(serve_ms)
                        same, gap = _tree_gap(cache, want_cache)
                        logits_gap = float((logits.float() - want_logits.float()).abs().max())
                        tokens_equal = bool(torch.equal(toks, want_toks))
                        line = (f"pod mesh (b) {what} route {route} turn {turn}: sharded prefill "
                                f"{prefill_ms:.6f} ms (unsharded {plain_prefill_ms:.6f}), serve "
                                f"step {serve_ms:.6f} ms (unsharded {plain_serve_ms:.6f}); "
                                f"{launched} bf16 flash_attention launches (want {POD_LAYERS}), "
                                f"{calls} through the seam; prefill logits max gap "
                                f"{logits_gap:.3e}; tokens equal {tokens_equal}; final cache "
                                f"bit-identical {same} (max gap {gap:.3e})")
                        ok = (tokens_equal and launched == POD_LAYERS and same
                              and logits_gap == 0.0
                              and calls == (launched if route == "tp" else 0))
                        if not ok:
                            fail(line)
                        log(line)
                del cache, paths, steps
                torch.cuda.empty_cache()
        t_rec = time.perf_counter()
        _pod_recurrent(dev, make_mesh(*POD_MESHES[0]), seam, route_ms)
        log(f"pod mesh (d), the recurrent models: {time.perf_counter() - t_rec:.3f} s")
        for key, ms in route_ms.items():
            log(f"pod mesh: {key}: median {float(np.median(ms)):.6f} ms of {len(ms)}")

        # (c) the elastic restore of a checkpoint this phase writes
        with tempfile.TemporaryDirectory() as root:
            ccfg = get_config("internlm2-1.8b", smoke=True)
            mgr = CheckpointManager(root, device=dev)
            t0 = time.perf_counter()
            mgr.save(12, init_params(ccfg, SEED + 12, device=dev))
            _, state = mgr.restore(params_only=True)
            save_s = time.perf_counter() - t0
            for shape, names in POD_MESHES:
                mesh = make_mesh(shape, names)
                t0 = time.perf_counter()
                with sh.use_mesh(mesh, multi_pod="pod" in names) as ctx:
                    step_no, placed = restore_sharded(mgr, mesh, ctx)
                restore_s = time.perf_counter() - t0
                same, gap = _tree_gap(placed, state["params"])
                n = len(tree_leaves(placed))
                line = (f"pod mesh (c) {shape}: restore_sharded of a smoke-size {ccfg.name} "
                        f"checkpoint (step {step_no}, {n} leaves; saved and restored unsharded in "
                        f"{save_s:.6f} s) in {restore_s:.6f} s, every placed leaf bit-identical "
                        f"to the unsharded restore {same} (max gap {gap:.3e})")
                if step_no != 12 or not same:
                    fail(line)
                log(line)
            mgr.close()
        counts = ops.launch_counts()
    finally:
        layers.chunked_attention = attention
        dist.destroy_process_group()
    del params0, sparams, want, want_cache
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"pod mesh phase (12): {phase_s:.3f} s of its {POD_BUDGET_S:.0f} s budget")
    return counts


def _asked(profile: str) -> tuple:
    """The routes phase 12 asks ``sharded`` for under a table: "tp" by
    name and the default (the gathered route at one rank) under "tp", the
    default under "dp"."""
    return ("tp", None) if profile == "tp" else (None,)


def _turns(shape, profile: str) -> int:
    """The turns of phase 12's routes on a mesh: POD_TURNS under the "tp"
    tables on the first mesh, one on the others and under "dp"."""
    return POD_TURNS if profile == "tp" and shape == POD_MESHES[0][0] else 1


def main() -> int:
    t_start = time.perf_counter()
    dev_info = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not beside this script ({exc}); run it from the repository root")
    t0 = time.perf_counter()
    ptxas = phase_build()
    # The inputs each kernel has been held at against its plain version.
    held = {"flash_attention": set(), "quantized_l2": set(), "dequant_matmul": set()}
    entries = phase_kernels(dev_info, held)
    log(f"kernels phase: {time.perf_counter() - t0:.3f} s")
    counts: dict[str, int] = {}

    def main_path(label, phase) -> float:
        t1 = time.perf_counter()
        with _recording() as seen:
            path_counts = phase()
        for name, n in path_counts.items():
            counts[name] = counts.get(name, 0) + n
        _hold_recorded(label, seen, held, entries)
        secs = time.perf_counter() - t1
        log(f"{label} phase: {secs:.3f} s")
        return secs

    # Phases 5 and 8 (c) run before phase 4: after phase 4, kernel_ms's
    # scheduled traces have come back without a kernel three times in a row,
    # padded or not, while phase 4's own (unscheduled) traces kept theirs.
    t1 = time.perf_counter()
    fa_entry, fa256_entry = phase_flash_attention(dev_info, ptxas, held)
    entries += [fa_entry, fa256_entry]
    log(f"flash_attention phase: {time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    fa_entry["train_shape_forward_backward"] = phase_attention_backward(dev_info)
    log(f"training phase (c), attention backward: {time.perf_counter() - t1:.3f} s")
    store: dict = {}
    main_path("main path", lambda: phase_main_path(dev_info, store))
    main_path("store service", lambda: phase_store_service(store))
    main_path("tools and examples", phase_tools_examples)
    main_path("model stack", phase_model_stack)
    zoo_s = main_path("model zoo", phase_zoo)
    log(f"model zoo phase (10): {zoo_s:.3f} s of its {ZOO_BUDGET_S:.0f} s budget")
    main_path("host-quantized", lambda: phase_host_quantized(dev_info))
    main_path("pod mesh", phase_pod_mesh)
    main_path("training", lambda: phase_training(dev_info))
    log(f"launches over all main paths: {counts}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on any main path")
    for e in entries:
        if e["name"] == "flash_attention":  # the entry's kernel is the bfloat16 route's
            e["launches"] = counts["flash_attention_bfloat16"]
            e["f32_launches"] = counts["flash_attention_float32"]
        elif e["name"] == "flash_attention_dh256":
            e["launches"] = counts["flash_attention_bfloat16_dh256"]
            e["f32_launches"] = counts["flash_attention_float32_dh256"]
        else:
            e["launches"] = counts[e["name"]]
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro"]
    if bad:
        fail(f"imported {bad}")
    log(f"device times from CUDA events, the profiler's trace having missed them: "
        f"{len(EVENT_TIMED)} {[what for what, _ in EVENT_TIMED]}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.3f} s in all, of its "
        f"{SCRIPT_BUDGET_S:.0f} s budget")
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
