"""starcoder2-3b [arXiv:2402.19173; hf] — dense, GQA kv=2, RoPE, biases."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    head_dim=128,
    rope=True,
    rope_theta=999999.4,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    source="arXiv:2402.19173",
    notes=("GQA kv=2", "24 heads do not divide a 16-way model axis: the "
           "sharding rules fall through to head_dim (128) sharding"),
)
