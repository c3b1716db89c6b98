"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]. The dense residual runs in
parallel with the routed experts (mix="moe_dense").
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    mix=("moe_dense",),
    n_experts=128,
    top_k=2,
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    mix=("moe_dense",),
    n_experts=8,
    top_k=2,
    capacity_factor=8.0,  # no token drops in smoke tests
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
