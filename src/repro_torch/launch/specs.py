"""Input stand-ins for every (architecture × shape) cell.

The port of the reference's ``repro/launch/specs.py``. Where the reference
builds ``jax.ShapeDtypeStruct`` trees for its dry run, the port builds the
same trees as tensors on the ``meta`` device: each has the leaf's shape and
dtype and no storage, so the largest configuration at its largest shape
allocates nothing.
"""

from __future__ import annotations

import torch

from ..models import cache_specs, param_specs
from ..models.config import ModelConfig, ShapeConfig
from ..models.transformer import _META, _dtype
from ..optim import adamw_init
from ..tree import tree_map

__all__ = ["batch_specs", "decode_cache_specs", "input_specs", "model_specs", "opt_specs"]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _spec((b, 1), torch.int32)}
    specs = {}
    if cfg.frontend == "embeddings":
        specs["embeds"] = _spec((b, s, cfg.d_model), _dtype(cfg.compute_dtype))
    else:
        specs["tokens"] = _spec((b, s), torch.int32)
    if shape.is_train:
        specs["labels"] = _spec((b, s), torch.int32)
    return specs


def model_specs(cfg: ModelConfig):
    return param_specs(cfg)


def opt_specs(cfg: ModelConfig, moment_dtype=torch.float32):
    """AdamW's state for ``cfg``: float32 moments (or ``moment_dtype``)
    and an int32 ``step``."""
    out = adamw_init(param_specs(cfg))
    if moment_dtype != torch.float32:
        cast = lambda s: _spec(s.shape, moment_dtype)  # noqa: E731
        out = {"m": tree_map(cast, out["m"]), "v": tree_map(cast, out["v"]),
               "step": out["step"]}
    return out


def decode_cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return cache_specs(cfg, shape.global_batch, shape.seq_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Everything the step consumes, keyed by argument name."""
    out = {"batch": batch_specs(cfg, shape), "params": model_specs(cfg)}
    if shape.is_train:
        out["opt_state"] = opt_specs(cfg)
    if shape.kind == "decode":
        out["cache"] = decode_cache_specs(cfg, shape)
        out["pos"] = _spec((), torch.int32)
    return out
