"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — hybrid Mamba+attn, MoE.

1:7 attention:mamba interleave (layer 0 of every 8 is attention), MoE every
other layer, 16 experts top-2.  TPU adaptation: the Mamba mixer uses the
SSD (mamba-2 style) chunked formulation rather than the paper's selective-
scan kernel — same state-space map, matmul-friendly (DESIGN.md §7).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    rope=False,          # jamba uses no positional encoding in attn layers
    norm="rmsnorm",
    act="swiglu",
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    hybrid_period=8,
    ssm_state=128,
    ssm_head_dim=128,    # d_inner=16384 -> 128 SSD heads
    ssm_chunk=128,
    ssm_conv=4,
    ssm_expand=2,
    capacity_factor=1.25,
    source="arXiv:2403.19887 / 2408.12570",
    notes=("runs long_500k (hybrid: SSM state + O(S) attn decode)",),
)
