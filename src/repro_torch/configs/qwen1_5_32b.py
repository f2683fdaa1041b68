"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B; hf] — dense, MHA (kv=40), QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    rope=True,
    qkv_bias=True,
    norm="rmsnorm",
    act="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B (family config card)",
    notes=("QKV bias", "40 heads fall through to head_dim sharding on a "
           "16-way model axis"),
)
