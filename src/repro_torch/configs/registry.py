"""Registry of the 10 assigned architectures + the 4 input-shape sets.

``get(name)`` returns the exact published config; ``get_smoke(name)``
returns a reduced same-family config for CPU smoke tests (small widths, few
layers/experts, tiny vocab).  A copy of the reference's
`repro.configs.registry`, held equal to it config by config and field by
field (`tests/test_torch_models.py`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = [
    "granite_3_2b",
    "starcoder2_3b",
    "qwen1_5_32b",
    "command_r_plus_104b",
    "mamba2_2_7b",
    "jamba_1_5_large_398b",
    "deepseek_moe_16b",
    "mixtral_8x22b",
    "whisper_tiny",
    "chameleon_34b",
]

ARCHS: Dict[str, ModelConfig] = {}
for m in _MODULES:
    mod = importlib.import_module(f"repro_torch.configs.{m}")
    ARCHS[mod.CONFIG.name] = mod.CONFIG

# input shapes: name -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence mixing; only SSM/hybrid run it
# (decode itself is O(S), but the assignment says skip pure full-attention
# archs — recorded in DESIGN.md §6).
LONG_OK = {"mamba2-2.7b", "jamba-1.5-large-398b"}
SKIPS = {
    (arch, "long_500k"): "pure full-attention arch; long_500k skipped"
    for arch in ARCHS if arch not in LONG_OK
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, same structural features."""
    cfg = ARCHS[name]
    changes = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=503,
        attn_chunk=64,
        remat="none",
    )
    if cfg.n_experts:
        changes.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=64)
    if cfg.n_shared_experts:
        changes.update(n_shared_experts=1)
    if cfg.dense_first_layer:
        changes.update(dense_first_d_ff=256)
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.hybrid_period:
        changes.update(hybrid_period=4, n_layers=8, moe_every=2, moe_offset=1)
    if cfg.family == "encdec":
        changes.update(encoder_layers=2, encoder_seq=64)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
