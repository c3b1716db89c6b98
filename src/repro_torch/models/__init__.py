"""The dense model stack: GQA transformers (attention + SwiGLU / GELU MLPs).

The port of the reference's ``repro/models``; the recurrent blocks and MoE
are not ported yet.
"""

from .config import SHAPES, ModelConfig, ShapeConfig
from .transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    opt_from_reference,
    params_from_reference,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "opt_from_reference",
    "params_from_reference",
]
