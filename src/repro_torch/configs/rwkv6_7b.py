"""rwkv6-7b [ssm] — Finch, data-dependent decay; attention-free.

32L d_model=4096 d_ff=14336 vocab=65536 [arXiv:2404.05892; hf].
64 heads × head_dim 64. Sub-quadratic → serves long_500k with O(1) state.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab_size=65_536,
    period=("rwkv6",),
    mix=("rwkv_cm",),
    rwkv_head_dim=64,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    period=("rwkv6",),
    mix=("rwkv_cm",),
    rwkv_head_dim=16,
    subquadratic=True,
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
