"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE.

2 shared + 64 routed experts, top-6, expert hidden 1408; layer 0 is a dense
FFN (hidden 10944) per the released config.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,            # routed expert hidden size (fine-grained)
    vocab=102400,
    head_dim=128,
    rope=True,
    norm="rmsnorm",
    act="swiglu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_every=1,
    moe_d_ff=1408,
    dense_first_layer=True,
    dense_first_d_ff=10944,
    capacity_factor=1.25,
    source="arXiv:2401.06066 / hf:deepseek-ai/deepseek-moe-16b-base",
    notes=("64 routed experts shard 4-per-device on a 16-way model axis "
           "(expert parallelism)",),
)
