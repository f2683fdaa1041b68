"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    rope=True,
    rope_theta=75000000.0,
    qkv_bias=False,
    norm="layernorm",
    act="swiglu",
    source="hf:CohereForAI/c4ai-command-r-plus (unverified tier)",
    notes=("GQA kv=8", "no biases anywhere"),
)
