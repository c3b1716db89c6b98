"""hubert-xlarge [audio] — encoder-only, bidirectional MHA, GELU MLP.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447;
unverified]. The conv waveform frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, D). No decode step (encoder-only) →
decode_32k and long_500k cells are skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mix=("gelu",),
    causal=False,
    has_decode=False,
    frontend="embeddings",
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    mix=("gelu",),
    causal=False,
    has_decode=False,
    frontend="embeddings",
    param_dtype="float32",
    compute_dtype="float32",
    attn_chunk=32,
)
