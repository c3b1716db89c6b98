"""internlm2-1.8b [dense] — GQA decoder.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544
[arXiv:2403.17297; hf]. d_head=128 (16 heads × 128 = 2048).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
