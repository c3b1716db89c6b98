"""Compressed-weight serving: NeurStore storage format as the *runtime*
weight format (paper §4.3 pushed to the serving fleet).

A llama3-shaped decoder (GQA + RMSNorm + SwiGLU) is saved through
``StorageEngine.save_model`` and served straight off the engine:
``load_model(name, bits=8|4)`` → :class:`~repro_torch.core.compressed.CompressedModel`
→ every projection and the LM head of :func:`greedy_decode` consume int8
base codes + int8/int4-packed delta codes through
``kernels.ops.dequant_matmul_auto`` (the CUDA kernels on the card). The
snapshot's buffer-pool frame stays pinned for the serving session and
``materialize()`` is never called on kernel-served tensors: device-memory
traffic per weight element is 2.0 bytes (int8 base + int8 delta) or 1.5
(int8 + int4 packed), against 4.0 for the float32 weight.
:class:`MaterializedProvider` is the materialize-then-serve baseline behind
the same provider interface.

Weights are stored **(in, out)** — ``y = x @ W`` directly, matching the
kernel's (K, N) layout (HF checkpoints store the transpose). The decode
loop keeps its KV cache on the provider's device and does attention, RoPE,
RMSNorm and SiLU in plain PyTorch with the reference's float types
(float32, with attention scores and probabilities in float64).

**Host-quantized path.** :func:`quantize_params` converts a model-stack
parameter tree (``repro_torch.models``) to the storage format from scratch
on the host (int8 base codes, an int4 delta packed two rows to a byte,
five float32 scalars per leaf), with the reference's bytes;
:func:`quantized_to_device` places it on a device, and
:func:`make_compressed_serve_step` serves it by reconstructing every leaf
in plain PyTorch (:func:`dequantize_leaf`, the reference's
``dequantize_leaf_jnp``, which XLA fuses into the consuming matmul) before
``decode_step``. :func:`compressed_param_specs` gives the same tree's
stand-ins on the ``meta`` device. On a mesh (``launch.shardings``:
``place`` the host tree by ``compressed_param_specs_tree``, each rank
uploading only its part) the step's ``"tp"`` route rebuilds on each rank
only its shard of each weight, as the reference's GSPMD partitions
``dequantize_leaf_jnp`` (:func:`dequantize_params`, :func:`rebuild_cases`).

One difference from the reference, on purpose: :func:`_quantizable` counts
bfloat16 and float16 leaves as floating. The reference's
``np.issubdtype(dtype, np.floating)`` is False for numpy's ``bfloat16``
extension type, so its ``quantize_params`` leaves every leaf of a bfloat16
tree raw; the port quantizes such a leaf from its exact float32 value.
On float32 trees the two packages give the same bytes.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.quantize import dequantize_linear, extract_msb, quantize_delta, quantize_linear
from ..distributed import sharding as sh
from ..distributed.sharding import P
from ..kernels.ops import resolve_device
from ..models import decode_step
from ..models.config import ModelConfig
from ..models.transformer import _dtype
from ..tree import tree_leaves, tree_map
from .shardings import _axis_size, _expert_axes, _map_with_path, compressed_param_specs_tree
from .specs import _spec, model_specs
from .steps import _inference

__all__ = [
    "DecoderSpec", "MaterializedProvider", "decoder_architecture",
    "greedy_decode", "init_decoder_tensors", "save_decoder",
    "spec_from_architecture", "tensors_from_reference", "quantize_params",
    "quantize_leaf", "quantized_to_device", "dequantize_leaf", "dequantize_params",
    "make_compressed_serve_step", "compressed_param_specs", "rebuild_cases",
]

# Leaves smaller than this stay raw (norm vectors, biases). Both are read
# at call time, so a caller (or a test) may change them.
MIN_QUANT_SIZE = 65_536
DELTA_BITS = 4


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    """Shape of the stored decoder (llama3 family, GQA)."""

    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    n_layers: int = 2
    vocab_size: int = 512
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def decoder_architecture(spec: DecoderSpec) -> dict:
    """Catalog ``architecture`` payload for a saved decoder."""
    return {"kind": "llama3_decoder", **dataclasses.asdict(spec)}


def spec_from_architecture(arch: dict) -> DecoderSpec:
    fields = {f.name for f in dataclasses.fields(DecoderSpec)}
    return DecoderSpec(**{k: v for k, v in dict(arch).items() if k in fields})


def init_decoder_tensors(spec: DecoderSpec, seed: int = 0) -> dict:
    """Random-init decoder weights, llama3/HF naming, (in, out) layout.

    Host numpy arrays from ``np.random.default_rng(seed)``, drawn in the
    reference's order, so both packages make identical weights."""
    rng = np.random.default_rng(seed)
    d, dh = spec.d_model, spec.head_dim
    h, kv, f = spec.n_heads, spec.n_kv_heads, spec.d_ff

    def w(k_dim, n_dim):
        return rng.normal(0.0, k_dim ** -0.5, (k_dim, n_dim)).astype(np.float32)

    tensors = {"model.embed_tokens.weight":
               rng.normal(0.0, 1.0, (spec.vocab_size, d)).astype(np.float32)}
    for i in range(spec.n_layers):
        pre = f"model.layers.{i}."
        tensors[pre + "input_layernorm.weight"] = np.ones(d, np.float32)
        tensors[pre + "self_attn.q_proj.weight"] = w(d, h * dh)
        tensors[pre + "self_attn.k_proj.weight"] = w(d, kv * dh)
        tensors[pre + "self_attn.v_proj.weight"] = w(d, kv * dh)
        tensors[pre + "self_attn.o_proj.weight"] = w(h * dh, d)
        tensors[pre + "post_attention_layernorm.weight"] = np.ones(d, np.float32)
        tensors[pre + "mlp.gate_proj.weight"] = w(d, f)
        tensors[pre + "mlp.up_proj.weight"] = w(d, f)
        tensors[pre + "mlp.down_proj.weight"] = w(f, d)
    tensors["model.norm.weight"] = np.ones(d, np.float32)
    tensors["lm_head.weight"] = w(d, spec.vocab_size)
    return tensors


def save_decoder(engine, name: str, spec: DecoderSpec, seed: int = 0):
    """Save a random-init decoder; returns the engine's SaveReport."""
    return engine.save_model(
        name, decoder_architecture(spec), init_decoder_tensors(spec, seed))


def tensors_from_reference(tensors: dict, device) -> dict[str, torch.Tensor]:
    """The reference package's decoder weights as the port's tensors.

    ``tensors`` maps names to numpy arrays in the (in, out) layout of
    ``repro.launch.compressed_serve.init_decoder_tensors`` (or of a
    ``materialize()``); both packages keep that layout, so each array is
    copied as it is, as float32, to ``device``.
    """
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(arr, dtype=np.float32), device=dev)
            for name, arr in tensors.items()}


class MaterializedProvider:
    """materialize-then-serve baseline: float32 weights, provider interface.

    Pays the full up-front de-quantization of every stored tensor
    (``LoadedModel.materialize()``), uploads the float32 weights to
    ``device`` (default: the engine's), then serves plain float32 matmuls.
    ``params`` (name → tensor, e.g. from :func:`tensors_from_reference`)
    stands in for a store: ``lm`` is then ``None``. Bytes-moved counts
    float32 weight-operand traffic per matmul.
    """

    def __init__(self, lm, device=None, params: dict | None = None):
        self.lm = lm
        if params is None:
            dev = lm.engine.device if device is None else device
            params = tensors_from_reference(lm.materialize(), dev)
        self.params = params
        self.device = next(iter(params.values())).device
        self._2d: dict[str, torch.Tensor] = {}
        self.counters = {"matmul_calls": 0, "gather_calls": 0,
                         "bytes_moved": 0, "fused_elems": 0}

    def matmul(self, x, name: str) -> torch.Tensor:
        w = self._2d.get(name)
        if w is None:
            arr = self.params[name]
            w = self._2d[name] = arr.reshape(arr.shape[0], -1)
        c = self.counters
        c["matmul_calls"] += 1
        c["bytes_moved"] += w.numel() * w.element_size()
        c["fused_elems"] += w.numel()
        return x.to(torch.float32) @ w

    def gather_rows(self, name: str, ids) -> torch.Tensor:
        rows = self.params[name][torch.as_tensor(ids, device=self.device)]
        self.counters["gather_calls"] += 1
        self.counters["bytes_moved"] += rows.numel() * rows.element_size()
        return rows

    def vector(self, name: str) -> torch.Tensor:
        return self.params[name]

    def reset_counters(self) -> None:
        for key in self.counters:
            self.counters[key] = 0

    def close(self) -> None:
        if self.lm is not None:
            self.lm.close()


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x / torch.sqrt(ms + eps)) * gamma


def _softmax(x: torch.Tensor) -> torch.Tensor:
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=-1, keepdim=True)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def _rope(x: torch.Tensor, pos: int, theta: float) -> torch.Tensor:
    """Interleaved-pair rotary embedding at one position; x (..., dh)."""
    dh = x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = pos * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x1 * cos - x2 * sin
    out[..., 1::2] = x1 * sin + x2 * cos
    return out


def _attn_block(provider, li: int, x: torch.Tensor, kc, vc, pos: int,
                spec: DecoderSpec) -> torch.Tensor:
    b = x.shape[0]
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    pre = f"model.layers.{li}."
    xn = _rms_norm(x, provider.vector(pre + "input_layernorm.weight"),
                   spec.norm_eps)
    q = provider.matmul(xn, pre + "self_attn.q_proj.weight").reshape(b, h, dh)
    k = provider.matmul(xn, pre + "self_attn.k_proj.weight").reshape(b, kv, dh)
    v = provider.matmul(xn, pre + "self_attn.v_proj.weight").reshape(b, kv, dh)
    q = _rope(q, pos, spec.rope_theta)
    k = _rope(k, pos, spec.rope_theta)
    kc[li][:, :, pos] = k
    vc[li][:, :, pos] = v
    # Grouped-query attention: g query heads share each KV head. Scores and
    # probabilities are float64, as the reference's numpy promotes them.
    g = h // kv
    qg = q.reshape(b, kv, g, dh)
    keys = kc[li][:, :, :pos + 1]
    vals = vc[li][:, :, :pos + 1]
    s = torch.einsum("bkgd,bktd->bkgt", qg, keys).to(torch.float64) / math.sqrt(dh)
    o = torch.einsum("bkgt,bktd->bkgd", _softmax(s),
                     vals.to(torch.float64)).reshape(b, h * dh)
    return provider.matmul(o, pre + "self_attn.o_proj.weight")


def _mlp_block(provider, li: int, x: torch.Tensor, spec: DecoderSpec) -> torch.Tensor:
    pre = f"model.layers.{li}."
    xn = _rms_norm(x, provider.vector(pre + "post_attention_layernorm.weight"),
                   spec.norm_eps)
    gate = provider.matmul(xn, pre + "mlp.gate_proj.weight")
    up = provider.matmul(xn, pre + "mlp.up_proj.weight")
    return provider.matmul(_silu(gate) * up, pre + "mlp.down_proj.weight")


def greedy_decode(provider, spec: DecoderSpec, prompt, steps: int,
                  return_logits: bool = False):
    """Greedy decode ``steps`` tokens after consuming ``prompt`` (B, P).

    ``provider`` is anything with the matmul/gather_rows/vector interface
    and a ``device`` (:class:`~repro_torch.core.compressed.CompressedModel`
    for compressed-domain serving, :class:`MaterializedProvider` for the
    float baseline); the decode runs on that device. Every projection and
    the LM head go through ``provider.matmul``; the embedding lookup
    through ``provider.gather_rows`` — the decode loop itself owns no
    weights. Returns (B, steps) int64 tokens, plus the per-step (B, steps,
    V) float32 logits when ``return_logits``, as tensors on the device.
    """
    dev = provider.device
    prompt = torch.atleast_2d(torch.as_tensor(prompt, device=dev)).to(torch.int64)
    b, p = prompt.shape
    total = p + steps
    shape = (spec.n_layers, b, spec.n_kv_heads, total, spec.head_dim)
    kc = torch.zeros(shape, dtype=torch.float32, device=dev)
    vc = torch.zeros(shape, dtype=torch.float32, device=dev)
    generated: list[torch.Tensor] = []
    logits_trace: list[torch.Tensor] = []
    tok = prompt[:, 0]
    pos = 0
    while len(generated) < steps:
        x = provider.gather_rows("model.embed_tokens.weight", tok)
        for li in range(spec.n_layers):
            x = x + _attn_block(provider, li, x, kc, vc, pos, spec)
            x = x + _mlp_block(provider, li, x, spec)
        x = _rms_norm(x, provider.vector("model.norm.weight"), spec.norm_eps)
        logits = provider.matmul(x, "lm_head.weight")
        nxt = torch.argmax(logits, dim=1)
        pos += 1
        if pos < p:
            tok = prompt[:, pos]
        else:
            tok = nxt
            generated.append(nxt)
            if return_logits:
                logits_trace.append(logits)
    tokens = torch.stack(generated, dim=1)
    if return_logits:
        return tokens, torch.stack(logits_trace, dim=1)
    return tokens


# --------------------------------------------------------------------------
# Host-quantized path: storage format built from scratch
# --------------------------------------------------------------------------

def _quantizable(leaf: torch.Tensor) -> bool:
    """A floating leaf (bfloat16 and float16 included) of two or more dims,
    at least ``MIN_QUANT_SIZE`` elements, with an even dim 0 (the delta is
    packed two rows of dim 0 to a byte)."""
    return (leaf.is_floating_point() and leaf.ndim >= 2 and leaf.numel() >= MIN_QUANT_SIZE
            and leaf.shape[0] % 2 == 0)


def _is_q(node) -> bool:
    """A storage-format leaf of a quantized tree (itself a dict)."""
    return isinstance(node, dict) and ("raw" in node or "base" in node)


def _map_quantized(fn, qtree):
    """``fn`` over the storage-format leaves of ``qtree``. ``tree.tree_map``
    would descend into them: they are dicts too."""
    if _is_q(qtree):
        return fn(qtree)
    if isinstance(qtree, dict):
        return {k: _map_quantized(fn, v) for k, v in qtree.items()}
    return [_map_quantized(fn, v) for v in qtree]


def quantize_leaf(arr) -> dict:
    """Host-side: tensor → int8 base + packed int4 delta (storage format).

    ``arr`` is a numpy array or a tensor on any device; a bfloat16 or
    float16 tensor is quantized from its exact float32 value. Returns numpy
    arrays and float32 scalars, as the reference's ``quantize_leaf``: the
    int4 delta of rows 2k and 2k + 1 of dim 0 shares a byte, row 2k in the
    low nibble.
    """
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu", torch.float32).numpy()
    flat = np.asarray(arr, np.float64).ravel()
    base_q, base_meta = quantize_linear(flat, nbit=8)
    base = dequantize_linear(base_q, base_meta)
    delta = flat - base
    dq, dmeta = quantize_delta(delta, p=2.0 ** -24)
    dq4, dmeta4 = extract_msb(dq, dmeta, DELTA_BITS)
    if dmeta4.nbit < DELTA_BITS:  # pad code space so packing is uniform
        dq4 = dq4 << (DELTA_BITS - dmeta4.nbit)
        dmeta4 = type(dmeta4)(scale=dmeta4.scale / (1 << (DELTA_BITS - dmeta4.nbit)),
                              zero_point=dmeta4.zero_point << (DELTA_BITS - dmeta4.nbit),
                              nbit=DELTA_BITS, mid=dmeta4.mid)
    v = dq4.astype(np.uint8).reshape(arr.shape[0], -1)
    packed = (v[0::2] | (v[1::2] << 4)).astype(np.uint8)  # pack along dim 0
    return {
        "base": (base_q.astype(np.int16) - 128).astype(np.int8).reshape(arr.shape),
        "packed": packed,
        "bs": np.float32(base_meta.scale),
        "bz": np.float32(base_meta.zero_point - 128),
        "bmid": np.float32(base_meta.mid),
        "ds": np.float32(dmeta4.scale),
        "dz": np.float32(dmeta4.zero_point),
    }


def quantize_params(params) -> dict:
    """Whole-tree storage-format conversion (host side, done once).

    ``params`` is the model stack's tree of tensors, on any device. Each
    quantizable leaf becomes :func:`quantize_leaf`'s dict, every other leaf
    ``{"raw": tensor}`` with the tensor copied to the host. The leaves are
    converted in threads, one a host core (numpy releases the interpreter
    lock on whole-array operations): each leaf's dict is what
    :func:`quantize_leaf` gives it alone, and the host holds the float64
    working copies of that many leaves at once.
    """
    def conv(leaf: torch.Tensor) -> dict:
        if _quantizable(leaf):
            return quantize_leaf(leaf)
        return {"raw": leaf.detach().cpu()}

    leaves = tree_leaves(params)
    with ThreadPoolExecutor(max_workers=max(1, min(len(leaves), os.cpu_count() or 1))) as pool:
        done = iter(list(pool.map(conv, leaves)))
    return tree_map(lambda _: next(done), params)


def quantized_to_device(qparams, device="cuda"):
    """A :func:`quantize_params` tree as tensors on ``device``: the codes
    as int8 / uint8 tensors, the scalars as 0-d float32 tensors."""
    dev = resolve_device(device)

    def place(q: dict) -> dict:
        return {k: (v.to(dev) if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v)).to(dev))
                for k, v in q.items()}

    return _map_quantized(place, qparams)


@dataclasses.dataclass(frozen=True)
class _Unpack:
    """Where a rank's part of a quantized leaf lies in the part of its
    packed delta that the rank holds (:func:`_unpack_plan`)."""

    rows: slice  # the packed rows that hold the part's rows
    view: tuple  # the packed columns as (a range of dim 1, *dims 2…)
    cols: tuple  # the part's columns in that view
    first: int  # the part's first row among the unpacked rows (0 or 1)
    n_rows: int
    exact: bool  # the held packed rows and columns are exactly the part's


def _box(shape: tuple, splits) -> list[tuple[int, int]]:
    """The index range of each dim of a tensor of ``shape`` that a rank
    holds under ``splits``: (dim, chunks, this rank's chunk), in the order
    they apply (a split over the expert ranks before ``model``'s), each an
    equal contiguous chunk of what the splits before it left (the spec
    trees split only what divides)."""
    box = [(0, n) for n in shape]
    for dim, n, i in splits:
        lo, hi = box[dim]
        size = (hi - lo) // n
        box[dim] = (lo + i * size, lo + (i + 1) * size)
    return box


def _unpack_plan(shape: tuple, part: list, held: list) -> _Unpack | None:
    """How a rank unpacks ``part`` (the box it holds of a quantized leaf of
    ``shape``) from ``held`` (the box it holds of the packed delta, of
    ``(shape[0] / 2, prod(shape[1:]))``): the packed rows of its rows, the
    packed columns viewed as dim 1's range by the dims after it, the
    part's columns there. None where ``held`` lacks some of them (its
    columns split finer than dim 1, or on another dim than the part's)."""
    (r0, r1), (lo, hi), rest = part[0], part[1], part[2:]
    p0, p1 = r0 // 2, (r1 + 1) // 2
    (h0, h1), (c0, c1) = held
    inner = math.prod(shape[2:])
    if not h0 <= p0 < p1 <= h1 or c0 % inner or c1 % inner:
        return None
    q0, q1 = c0 // inner, c1 // inner
    if not q0 <= lo < hi <= q1:
        return None
    exact = ((r0, r1, lo, hi) == (2 * h0, 2 * h1, q0, q1)
             and all(b - a == n for (a, b), n in zip(rest, shape[2:])))
    return _Unpack(slice(p0 - h0, p1 - h0), (q1 - q0,) + tuple(shape[2:]),
                   (slice(lo - q0, hi - q0),) + tuple(slice(a, b) for a, b in rest),
                   r0 - 2 * p0, r1 - r0, exact)


def _rebuild(q: dict, dtype, plan: _Unpack) -> torch.Tensor:
    """``q["base"]`` (a box of the leaf) rebuilt in ``dtype`` from the rows
    and columns of ``q["packed"]`` that ``plan`` names: the reference's
    ``dequantize_leaf_jnp``, operation for operation, on those elements.
    The base ``(base - bz) * bs``, the nibbles stacked low / high along a
    new dim 1 (row 2k the low nibble, 2k + 1 the high one), the delta
    ``(nibble - dz + 0.5) * ds``, their sum in float32, then the cast. Each
    step is its own correctly rounded float32 operation on one element (no
    fused multiply-add), so a box gives the bits the whole leaf gives
    there, and the card the CPU's."""
    base = (q["base"].to(torch.float32) - q["bz"]) * q["bs"]
    packed = q["packed"][plan.rows]
    packed = packed.reshape((packed.shape[0],) + plan.view)[(slice(None),) + plan.cols]
    low = (packed & 0xF).to(torch.float32)
    high = (packed >> 4).to(torch.float32)
    nibbles = torch.stack([low, high], dim=1).flatten(0, 1)[plan.first:plan.first + plan.n_rows]
    delta = (nibbles - q["dz"] + 0.5) * q["ds"]
    return (base + delta.reshape(base.shape)).to(dtype)


def dequantize_leaf(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """One storage-format leaf (tensors, :func:`quantized_to_device`) back
    to a tensor of ``dtype``; a raw leaf as it is (:func:`_rebuild` of
    the whole leaf)."""
    if "raw" in q:
        return q["raw"]
    shape = tuple(q["base"].shape)
    whole = [(0, n) for n in shape]
    held = [(0, shape[0] // 2), (0, math.prod(shape[1:]))]
    return _rebuild(q, dtype, _unpack_plan(shape, whole, held))


def _dequantize_shard(q: dict, dtype, stacked: bool) -> torch.Tensor:
    """Inside a tensor-parallel step: this rank's part of a quantized leaf
    rebuilt from its parts of ``base`` and ``packed`` (DTensors over the
    ``model`` submesh, split over the expert ranks where the step keeps
    them so), placed as ``base`` is, behind one ``sh.local_seam``. A rank
    unpacks only the packed rows and columns its ``base`` covers (a
    stacked ``wq`` whose ``d_head`` is split: a strided view of the packed
    ``(L/2, D, H, dh)``), with no collective, where the packed part it
    holds has them (:func:`rebuild_cases` (a) and (b)); else (c) its
    packed is first gathered over ``model``, one all-gather. A leaf's
    experts lie on its first dim after the stack, and so do its packed
    delta's (its rows, or a stacked leaf's flattened columns)."""
    from torch.distributed.tensor import Replicate

    sub = sh.compute_mesh()
    base, packed = q["base"], q["packed"]
    ep_dim = int(stacked)

    def splits(x, dim, model=True) -> list:
        i, n = sh.expert_part(x)
        out = [(dim, n, i)] if n > 1 else []
        return out + [(p.dim, sub.size(k), sub.get_local_rank(k))
                      for k, p in enumerate(x.placements) if model and p.is_shard()]

    shape = list(base.shape)
    shape[ep_dim] *= sh.expert_part(base)[1]
    shape = tuple(shape)
    pshape = (shape[0] // 2, math.prod(shape[1:]))
    part = _box(shape, splits(base, ep_dim))
    held_at = tuple(packed.placements)
    plan = _unpack_plan(shape, part, _box(pshape, splits(packed, ep_dim)))
    if plan is None:
        held_at = (Replicate(),) * sub.ndim
        plan = _unpack_plan(shape, part, _box(pshape, splits(packed, ep_dim, False)))
    whole = (Replicate(),) * sub.ndim

    def local(b, p, bz, bs, dz, ds):
        return _rebuild({"base": b, "packed": p, "bz": bz, "bs": bs, "dz": dz, "ds": ds},
                        dtype, plan)

    at = tuple(base.placements)
    return sh.local_seam(local, at, [at, held_at] + [whole] * 4)(
        base, packed, q["bz"], q["bs"], q["dz"], q["ds"])


def dequantize_params(qparams, dtype):
    """Every leaf of a placed storage-format tree in ``dtype`` (a raw leaf
    as it is): :func:`dequantize_leaf` of each, or inside a
    tensor-parallel step (``launch.shardings.sharded``'s ``"tp"`` route)
    each rank's own part of each, placed as its ``base`` is."""
    def one(path, q):
        if "raw" in q:
            return q["raw"]
        if sh.compute_mesh() is None:
            return dequantize_leaf(q, dtype)
        return _dequantize_shard(q, dtype, "periods" in path)

    return _map_with_path(one, qparams, is_leaf=_is_q)


def make_compressed_serve_step(cfg: ModelConfig):
    """serve_step over storage-format weights (greedy decode one token).

    Every leaf of the placed tree is reconstructed in ``cfg.compute_dtype``
    on its device at each step (:func:`dequantize_params`), then one
    ``decode_step``: on the card it all runs there. Inside
    ``launch.shardings.sharded`` on the ``"tp"`` route each rank rebuilds
    only its shard of each weight and ``decode_step`` runs split over
    ``model``, as the plain serve step does.
    """
    dtype = _dtype(cfg.compute_dtype)

    @_inference
    def step(qparams, cache, batch, pos):
        params = dequantize_params(qparams, dtype)
        logits, new_cache = decode_step(params, cache, batch, pos, cfg)
        next_tok = torch.argmax(sh.unsplit(logits[:, -1, :], 1), dim=-1).to(torch.int32)
        return next_tok, new_cache

    return step


def _quantized_items(tree, path=()):
    """(path, storage-format leaf) of a quantized tree, in its order."""
    if _is_q(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quantized_items(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _quantized_items(v, path + (i,))


def rebuild_cases(qspecs, ctx: sh.ShardingCtx) -> dict[str, str]:
    """{path: case} for each quantized leaf of a storage-format tree
    (:func:`compressed_param_specs`'s stand-ins) placed by
    ``compressed_param_specs_tree`` under ``ctx``, as the ``"tp"`` route
    rebuilds it (:func:`_dequantize_shard`) on every rank of ``ctx.mesh``
    (a ``DeviceMesh`` or the reference's stand-in): ``"a"`` where each
    rank's packed part is exactly the delta of its ``base`` part, ``"b"``
    where it holds more (the packed whole over an axis that splits
    ``base``) and the rank slices it before it unpacks, ``"c"`` where it
    lacks some (gathered over ``model`` first). The step sees a leaf split
    over ``model`` and, where its spec splits it as the batch is (an
    expert weight's ``P(dp, …)``), over those data-parallel ranks; every
    other axis gathered."""
    specs = compressed_param_specs_tree(qspecs, ctx)
    sizes = sh.mesh_axis_sizes(ctx.mesh)
    dp = sh._axes(ctx.spec("tokens")[0])
    m = sizes.get("model", 1)
    out = {}
    for (path, q), (_, s) in zip(_quantized_items(qspecs), _quantized_items(specs), strict=True):
        if "raw" in q:
            continue
        shape = tuple(q["base"].shape)
        pshape = (shape[0] // 2, math.prod(shape[1:]))
        n_ep = _axis_size(ctx.mesh, _expert_axes(s["base"], dp) or None)

        def splits(spec, ndim, r, e):
            entries = tuple(spec)[:ndim]
            return ([(d, n_ep, e) for d, x in enumerate(entries) if _expert_axes(P(x), dp)]
                    + [(d, m, r) for d, x in enumerate(entries) if "model" in sh._axes(x)])

        plans = [_unpack_plan(shape, _box(shape, splits(s["base"], len(shape), r, e)),
                              _box(pshape, splits(s["packed"], 2, r, e)))
                 for r in range(m) for e in range(n_ep)]
        out["/".join(map(str, path))] = ("c" if None in plans else
                                         "a" if all(p.exact for p in plans) else "b")
    return out


def compressed_param_specs(cfg: ModelConfig):
    """The storage-format tree's stand-ins on the ``meta`` device, leaf
    for leaf what :func:`quantize_params` returns for ``cfg``'s parameters."""
    def conv(leaf: torch.Tensor) -> dict:
        if _quantizable(leaf):
            n_cols = leaf.numel() // leaf.shape[0]
            return {
                "base": _spec(leaf.shape, torch.int8),
                "packed": _spec((leaf.shape[0] // 2, n_cols), torch.uint8),
                **{k: _spec((), torch.float32) for k in ("bs", "bz", "bmid", "ds", "dz")},
            }
        return {"raw": leaf}

    return tree_map(conv, model_specs(cfg))
