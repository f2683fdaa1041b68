"""chameleon-34b [arXiv:2405.09818; unverified] — early-fusion VLM.

Early fusion means VQ image tokens share the 65536-entry vocabulary: the
backbone is a dense decoder and the VQ tokenizer is the stub frontend —
input_specs() is token ids.  QK-norm per the paper's training-stability fix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    rope=True,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2405.09818",
    notes=("early fusion: modality frontend = VQ token ids",),
)
