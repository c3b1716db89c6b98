"""Model configuration for the assigned architecture zoo.

A copy of the reference's ``repro/models/config.py``. One
:class:`ModelConfig` describes any of the 10 assigned architectures.
Layers are organised as repeated *periods* (e.g. recurrentgemma's
(rglru, rglru, attn) 2:1 pattern); parameters are stacked over the period
axis, so the parameter tree (and the checkpoint names built from it) is the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockType = Literal["attn", "local_attn", "rglru", "rwkv6"]
MixType = Literal["swiglu", "gelu", "moe", "moe_dense", "rwkv_cm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 → d_model // n_heads

    # Sequence-mix / channel-mix block types per layer period.
    period: tuple[str, ...] = ("attn",)       # BlockType per period slot
    mix: tuple[str, ...] = ("swiglu",)        # MixType per period slot
    tail: tuple[str, ...] = ()                # remainder BlockTypes
    tail_mix: tuple[str, ...] = ()

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # Recurrent / local attention
    window: int = 0              # local attention window (recurrentgemma)
    d_rnn: int = 0               # RG-LRU width (0 → d_model)
    rwkv_head_dim: int = 64

    # Features
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    has_decode: bool = True      # encoder-only → False
    subquadratic: bool = False   # eligible for long_500k
    frontend: str = "tokens"     # tokens | embeddings (audio/vlm stub)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # Precision
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # Training memory knobs (overridable per shape at launch)
    remat: bool = True
    attn_chunk: int = 1024       # flash-style KV/Q chunking
    # Dry-run probe flags: fully unroll scans so XLA cost_analysis (which
    # counts while bodies ONCE) sees every iteration. Never set in prod.
    unroll_periods: bool = False
    scan_unroll: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        assert len(self.period) == len(self.mix)
        assert len(self.tail) == len(self.tail_mix)
        n = self.n_periods * len(self.period) + len(self.tail)
        assert n == self.n_layers, (
            f"{self.name}: period×{self.n_periods}+tail covers {n} layers, "
            f"config says {self.n_layers}")

    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.period)

    @property
    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        counts = {"embed": v * d, "head": 0 if self.tie_embeddings else d * v}
        per_block = {}
        per_block["attn"] = d * h * dh + 2 * d * kv * dh + h * dh * d
        per_block["local_attn"] = per_block["attn"]
        r = self.d_rnn
        per_block["rglru"] = 2 * d * r + 4 * r + 2 * r * r + 2 * r + r * d
        hd = self.rwkv_head_dim
        nh = d // hd
        per_block["rwkv6"] = 4 * d * d + 2 * (d * 64 + 64 * d) + nh * hd + d * d
        per_mix = {
            "swiglu": 3 * d * f,
            "gelu": 2 * d * f,
            "moe": d * self.n_experts + self.n_experts * 3 * d * f,
            "moe_dense": d * self.n_experts + self.n_experts * 3 * d * f + 3 * d * f,
            "rwkv_cm": 2 * d * f + d * d,
        }
        total = counts["embed"] + counts["head"] + 2 * d  # final norm + bias-ish
        for b, m in self.layer_types():
            total += per_block[b] + per_mix[m] + 2 * d
        return total

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.n_params
        d, f = self.d_model, self.d_ff
        inactive = 0
        for _, m in self.layer_types():
            if m.startswith("moe"):
                inactive += (self.n_experts - self.top_k) * 3 * d * f
        return self.n_params - inactive

    def layer_types(self) -> list[tuple[str, str]]:
        """[(block, mix)] for all n_layers in order."""
        out = list(zip(self.period, self.mix)) * self.n_periods
        out += list(zip(self.tail, self.tail_mix))
        return out

    def supports_shape(self, shape_name: str) -> bool:
        if not self.has_decode and shape_name in ("decode_32k", "long_500k"):
            return False
        if shape_name == "long_500k" and not self.subquadratic:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
