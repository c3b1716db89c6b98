"""The model stack: GQA transformers (attention + SwiGLU / GELU MLPs or
routed experts) and the recurrent families (RG-LRU, RWKV-6).

The port of the reference's ``repro/models``: every architecture of
``repro_torch.configs.list_archs()`` builds, runs its forward and loss and
decodes against a cache.
"""

from .config import SHAPES, ModelConfig, ShapeConfig
from .layers import AttentionBlock, GeluMLP, MoE, SwiGLU
from .recurrent import RGLRUBlock, RWKV6ChannelMix, RWKV6TimeMix
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
    "AttentionBlock",
    "GeluMLP",
    "ModelConfig",
    "MoE",
    "RGLRUBlock",
    "RWKV6ChannelMix",
    "RWKV6TimeMix",
    "ShapeConfig",
    "SwiGLU",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "opt_from_reference",
    "params_from_reference",
]
