"""Forward flash attention (grouped GQA, causal / local window): CUDA kernels.

Both kernels keep the scores, the running max and sum and the accumulator
on chip across the key sweep; only q, k, v and the output touch device
memory. They read q (B, Sq, H, dh) and k/v (B, Sk, KV, dh) through their
strides, so no transposed or padded copy is made, and serve all G = H / KV
query heads of a KV head from one staged K/V tile.

The route follows the dtype, and nothing else:

========  ===============================  =====================================
dtype     kernel                           held to the plain version within
========  ===============================  =====================================
bfloat16  ``csrc/flash_attention_sm90.cu``  rtol 1e-2, atol 1e-5: one bf16
          (wgmma on the bf16 tensor        rounding of the output (p split
          cores, TMA K/V ring)             into bf16 hi + lo for p @ v)
float32   ``csrc/flash_attention.cu``      rtol 1e-4, atol 2e-5: the
          (wgmma on the tf32 tensor        reference's tolerance, which one
          cores, every operand split into  tf32 product would miss
          tf32 hi + lo: three products
          for each)
========  ===============================  =====================================

At head dim 256 (recurrentgemma) both routes take a layout of their own.
The bfloat16 kernel keeps its 128-row blocks and runs two consumer
warpgroups taking turns on the tensor cores (``setmaxnreg``, a 2-stage ring
of K and V tiles). The float32 kernel, ``flash_attn_tf32<256>``, keeps the
split products on blocks of 64 rows (:data:`F32_DH256_BLOCK_ROWS`: q hi + lo
for 128 rows would not fit in shared memory) with a converter and one
consumer warpgroup: TMA brings K and V as float32, in chunks of 32 columns
and parts of 8 keys, and each converter warp splits the fills of its own
stage, so K and V need TMA's 16-byte alignment there too. Both sweep the
key tiles of one block plan (``csrc/flash_plan.cuh``): :func:`key_tiles`
mirrors the tiles each block sweeps, :func:`tile_needs_mask` the tiles on
which it applies the masks, and :func:`kv_tile_bytes` the K/V bytes a
launch reads from them.

The wrapper takes a kernel for CUDA tensors and the plain version of
``ref.py`` for CPU tensors. A CUDA input that its route's kernel cannot take
raises, and a failed build or launch raises: there is no other path.

Every call goes through :class:`FlashAttentionFn`, so the output carries a
``grad_fn`` whenever grad is enabled and an input requires it (the kernel
writes a fresh tensor that autograd would otherwise not know). Its backward:

========  ===============================  =====================================
backward  ``ref.flash_attention_backward``  dq, dk, dv in float32 from the saved
(any      (plain PyTorch, chunked over     q, k, v and the output's gradient,
dtype)    keys; both devices)              cast to the inputs' dtypes
========  ===============================  =====================================

The backward is plain PyTorch by design, not a fallback: the reference has no
backward kernel (its ``loss_fn`` differentiates plain ``chunked_attention``
through XLA autodiff and never reaches its Pallas kernel), so the port's
counterpart is the exact gradient of the same function. It recomputes the
softmax statistics key chunk by key chunk, each with only the query rows
that see it, so it never holds more than a (B, H, Sq, chunk) block of
scores. A hand-written backward kernel is a later, measured choice
(ROADMAP B5).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import ref
from ._build import load_library
from .dequant_matmul import _on_cpu

__all__ = ["BLOCK_ROWS", "F32_DH256_BLOCK_ROWS", "HEAD_DIMS", "KEY_TILE", "ROUTES",
           "FlashAttentionFn",
           "flash_attention", "key_tiles", "kv_tile_bytes", "launches", "launches_dh256",
           "tile_needs_mask"]

#: The library each dtype launches; the only dispatch there is.
ROUTES = {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention"}

#: Kernel launches by route, keyed by its dtype's name (CUDA inputs only; CPU
#: calls do not count). ``ops.launch_counts()`` gives them and their sum.
launches = {"bfloat16": 0, "float32": 0}

#: Of those, the launches at head dim 256 (recurrentgemma), which take a
#: layout of their own on both routes; ``ops.launch_counts()`` gives them as
#: ``flash_attention_<dtype>_dh256``.
launches_dh256 = {"bfloat16": 0, "float32": 0}

#: Head dims both routes are built for.
HEAD_DIMS = (32, 64, 80, 128, 256)

#: Rows of a (batch, KV head) slab that a block of the bfloat16 kernel owns
#: (row r is query position r // G of head kv * G + r % G), and keys a K/V
#: tile (``Cfg<DH>::BQ`` in ``csrc/flash_attention_sm90.cu``, ``kKeyTile``
#: in ``csrc/flash_plan.cuh``).
BLOCK_ROWS, KEY_TILE = 128, 64

#: Rows a block of the float32 kernel owns at head dim 256 (``Cfg<256>::BQ``
#: in ``csrc/flash_attention.cu``).
F32_DH256_BLOCK_ROWS = 64

_libs: dict[str, ctypes.CDLL] = {}


def key_tiles(sq: int, sk: int, g: int, *, causal: bool, window: int = 0, sk_true=None,
              block_rows: int = BLOCK_ROWS) -> np.ndarray:
    """The key tiles ``[t_lo, t_hi)`` each block sweeps, as an (n_blocks,
    2) array in row order (block i owns rows ``i * block_rows`` onwards of a
    slab of ``sq * g`` rows): the bfloat16 kernel at :data:`BLOCK_ROWS`, the
    float32 kernel at head dim 256 at :data:`F32_DH256_BLOCK_ROWS`. Mirrors
    ``plan_block`` in ``csrc/flash_plan.cuh``, with ``sk_true`` as
    :func:`flash_attention` passes it (at most ``sk``).

    A block skips the tiles masked for all its rows only when every row has
    a real key (below ``sk_true`` and, with a window, within it), because
    only then is the sweep over them wiped by ``corr = 0``; otherwise it
    sweeps every tile.
    """
    sk_true = sk if sk_true is None else min(sk, int(sk_true))
    rows = sq * g
    r0 = np.arange(0, rows, block_rows, dtype=np.int64)
    q_lo, q_hi = r0 // g, (np.minimum(r0 + block_rows, rows) - 1) // g
    n_tiles = -(-sk // KEY_TILE)
    all_real = np.full(r0.shape, sk_true >= 1)
    if window > 0:
        all_real &= q_hi < sk_true - 1 + window
    k_end = np.minimum(q_hi + 1, sk_true) if causal else np.full_like(r0, sk_true)
    t_hi = np.where(all_real, -(-k_end // KEY_TILE), n_tiles)
    lo = np.maximum(0, q_lo - window + 1) // KEY_TILE if window > 0 else 0
    t_lo = np.where(all_real, lo, 0)
    return np.stack([t_lo, t_hi], axis=1)


def tile_needs_mask(q_lo: int, q_hi: int, t: int, sk: int, *, causal: bool, window: int = 0,
                    sk_true=None) -> bool:
    """Whether a kernel of the shared block plan (the bfloat16 kernel, the
    float32 kernel at head dim 256) masks key tile ``t`` for a block whose
    rows hold query positions ``q_lo .. q_hi``: some key of the tile lies
    past ``sk`` or ``sk_true``, after some row's position (causal) or a
    window or more before it. Mirrors ``FA_TILE_NEEDS_MASK`` in
    ``csrc/flash_plan.cuh``; the kernels skip the masks elsewhere."""
    sk_true = sk if sk_true is None else min(sk, int(sk_true))
    k0 = t * KEY_TILE
    k_last = k0 + KEY_TILE - 1
    return (k_last >= sk or k_last >= sk_true or (causal and k_last > q_lo)
            or (window > 0 and q_hi - k0 >= window))


def kv_tile_bytes(b: int, sq: int, sk: int, h: int, kv: int, dh: int, *, causal: bool,
                  window: int = 0, sk_true=None, block_rows: int = BLOCK_ROWS,
                  elem_bytes: int = 2) -> int:
    """Bytes of K and V tiles (whole tiles of ``elem_bytes`` elements: 2 for
    bfloat16, 4 for float32) that the blocks of one launch load, from the
    grid and :func:`key_tiles`: each block of each (batch, KV head) slab
    loads its tiles' K and V once."""
    plan = key_tiles(sq, sk, h // kv, causal=causal, window=window, sk_true=sk_true,
                     block_rows=block_rows)
    return int((plan[:, 1] - plan[:, 0]).sum()) * b * kv * 2 * KEY_TILE * dh * elem_bytes


def _library(route: str) -> ctypes.CDLL:
    lib = _libs.get(route)
    if lib is None:
        lib = load_library(route)
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        if route == "flash_attention":
            fn = lib.flash_attention_fwd
            fn.argtypes = [p, p, p, p] + [i] * 6 + [ll] * 9 + [i, i, i, f, p]
        else:
            fn = lib.flash_attention_sm90_fwd
            fn.argtypes = [p, p, p, p] + [i] * 6 + [ll] * 9 + [i, i, i, p]
        fn.restype = ctypes.c_int
        _libs[route] = lib
    return lib


def _check_tma(**tensors) -> None:
    """Tensors that a kernel loads by TMA (K and V: both routes at head dim
    256, the bfloat16 route throughout, which also loads q in 16-byte
    vectors) need a 16-byte aligned base and the strides of dimensions
    longer than 1 in multiples of 16 bytes."""
    for name, t in tensors.items():
        step = 16 // t.element_size()
        bad = [d for d in range(3) if t.shape[d] > 1 and t.stride(d) % step]
        if t.data_ptr() % 16 or bad:
            raise ValueError(f"flash_attention: {str(t.dtype).removeprefix('torch.')} {name} "
                             f"needs a 16-byte aligned base and strides in multiples of {step} "
                             f"elements (TMA); got offset {t.data_ptr() % 16} bytes, strides "
                             f"{tuple(t.stride())}")


def flash_attention(q, k, v, *, causal=True, window=0, sk_true=None):
    """Softmax attention of q (B, Sq, H, dh) over k, v (B, Sk, KV, dh).

    Grouped GQA (query head h reads KV head h // (H // KV)), masks
    ``k_pos < sk_true`` (default Sk), causal ``q_pos >= k_pos`` and, for
    ``window > 0``, ``q_pos - k_pos < window``; masked scores take the
    bias -1e30. Returns (B, Sq, H, dh) in q's dtype. CUDA tensors (float32
    or bfloat16, one dtype, dh in ``HEAD_DIMS``, last dimension contiguous;
    bfloat16, and float32 k and v at head dim 256, also 16-byte aligned, see
    :func:`_check_tma`) launch the
    kernel of their dtype's route (:data:`ROUTES`); CPU tensors take
    :func:`ref.flash_attention`. Differentiable through
    :class:`FlashAttentionFn` on both devices.
    """
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                  None if sk_true is None else int(sk_true))


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` as an autograd function: the forward is the
    kernel launch (CUDA) or the plain version (CPU), the backward
    :func:`ref.flash_attention_backward` from the saved q, k, v on both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sk_true):
        if _on_cpu(q, k, v):
            o = ref.flash_attention(q, k, v, causal=causal, window=window, sk_true=sk_true)
        else:
            o = _launch(q, k, v, causal, window, sk_true)
        ctx.save_for_backward(q, k, v)
        ctx.masks = (causal, window, sk_true)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, sk_true = ctx.masks
        dq, dk, dv = ref.flash_attention_backward(q, k, v, do, causal=causal, window=window,
                                                  sk_true=sk_true, chunk=ref.BACKWARD_CHUNK)
        return dq, dk, dv, None, None, None


def _launch(q, k, v, causal: bool, window: int, sk_true) -> torch.Tensor:
    """One kernel launch on CUDA tensors into a fresh output; counted in
    :data:`launches`."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, dh) or v.shape != k.shape or kv == 0 or h % kv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    route = ROUTES[q.dtype]
    if route == "flash_attention_sm90":
        _check_tma(q=q, k=k, v=v)
    elif dh == 256:
        _check_tma(k=k, v=v)
    # Keys past Sk do not exist either way; the kernels' tile plans take sk_true <= Sk.
    sk_true = sk if sk_true is None else min(sk, int(sk_true))
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    if sk == 0:
        return o.zero_()
    dev = q.device
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, kv, dh,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), int(bool(causal)), int(window), sk_true)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _library(route)
        if route == "flash_attention":
            err = lib.flash_attention_fwd(*args, 1.0 / dh ** 0.5, stream)
        else:
            err = lib.flash_attention_sm90_fwd(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: the {route} kernel failed with error {err} "
                           "(> 0: CUDA error; -1: no TMA encoder in the driver; "
                           "-1000 - r: tensor map refused with driver result r)")
    route_key = str(q.dtype).removeprefix("torch.")
    launches[route_key] += 1
    if dh == 256:
        launches_dh256[route_key] += 1
    return o
