"""llava-next-34b [vlm] — decoder backbone; anyres vision tiling is a STUB.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. input_specs() provides
precomputed patch+text embeddings for train/prefill; decode feeds text
tokens through the embedding table.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    frontend="embeddings",
)

SMOKE = ModelConfig(
    name="llava-next-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    frontend="embeddings",
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
