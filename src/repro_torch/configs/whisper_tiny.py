"""whisper-tiny [arXiv:2212.04356; unverified] — enc-dec audio backbone.

Conv/log-mel frontend is a stub: input_specs() provides precomputed frame
embeddings [B, 1500, 384].  The assigned seq shapes size the DECODER.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    rope=False,           # learned absolute positions
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    encoder_layers=4,
    encoder_seq=1500,
    source="arXiv:2212.04356",
    notes=("decode shapes size the decoder KV cache; cross-attn over 1500 "
           "stub frame embeddings",),
)
