"""mamba2-2.7b [arXiv:2405.21060; unverified] — attention-free SSD."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,             # Mamba blocks have no separate FFN
    vocab=50280,
    rope=False,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,    # d_inner=5120 -> 80 SSD heads
    ssm_chunk=128,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2405.21060 (SSD); gpt-neox vocab",
    notes=("runs long_500k: decode state is O(1) in context",),
)
