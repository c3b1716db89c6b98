"""granite-moe-3b-a800m [moe] — 40 experts top-8, tiny expert FFNs.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    mix=("moe",),
    n_experts=40,
    top_k=8,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    mix=("moe",),
    n_experts=8,
    top_k=2,
    capacity_factor=8.0,  # no token drops in smoke tests
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
