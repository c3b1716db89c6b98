"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 window=2048
[arXiv:2402.19427; unverified]. 38 = 12×(rglru, rglru, local_attn) + 2 tail
rglru layers. Sub-quadratic → serves long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    period=("rglru", "rglru", "local_attn"),
    mix=("swiglu", "swiglu", "swiglu"),
    tail=("rglru", "rglru"),
    tail_mix=("swiglu", "swiglu"),
    window=2048,
    d_rnn=4096,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    period=("rglru", "rglru", "local_attn"),
    mix=("swiglu", "swiglu", "swiglu"),
    tail=("rglru", "rglru"),
    tail_mix=("swiglu", "swiglu"),
    window=16,
    d_rnn=64,
    subquadratic=True,
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
