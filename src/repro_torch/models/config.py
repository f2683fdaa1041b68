"""Architecture configuration (one instance per assigned arch).

A copy of the reference's `repro.models.config`, held field for field
equal to it by `tests/test_torch_models.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    # attention
    rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False        # chameleon
    attn_window: int = 0         # sliding-window size; 0 = full causal
    attn_chunk: int = 1024       # flash-style KV chunk (pure-JAX online softmax)
    # block
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim (fine-grained MoE)
    capacity_factor: float = 1.25
    dense_first_layer: bool = False   # deepseek-moe: layer 0 is a dense FFN
    dense_first_d_ff: int = 0
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    moe_dispatch: str = "sorted"      # sorted | dense  (§Perf baseline = dense)
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (jamba): within each block of `hybrid_period` layers, layer 0 is
    # attention, the rest are SSM; MoE on every `moe_every`-th layer.
    hybrid_period: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0         # stub frontend: precomputed frame embeddings
    # vlm (chameleon): early fusion — VQ image tokens share the vocab; the
    # tokenizer stub means input_specs() is token ids, nothing else changes.
    # numerics / compile strategy
    dtype: str = "bfloat16"
    remat: str = "dots"          # none | dots | full
    scan_layers: bool = True
    parallelism: str = "auto"    # auto | fsdp | tp  (dist/sharding.select_rules)
    # notes for DESIGN/EXPERIMENTS
    source: str = ""
    notes: Tuple[str, ...] = ()

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Pad vocab to a multiple of 256 so the logits dim shards over any
        mesh axis (production-standard embedding padding)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.dense_first_layer and i == 0:
            return False
        return (i % self.moe_every) == self.moe_offset

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.hybrid_period:
            return (i % self.hybrid_period) == 0
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), used for the
        MODEL_FLOPS = 6*N*D roofline term."""
        hd = self.hd
        d = self.d_model
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.n_layers):
            if self.is_attn_layer(i):
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                total += qkv + (self.n_heads * hd) * d
            else:  # ssm layer
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + nh) + di * d + 3 * di
            if self.is_moe_layer(i):
                h = self.moe_hidden
                total += self.n_experts * (3 * d * h) + d * self.n_experts
                total += self.n_shared_experts * 3 * d * h
            elif not self.is_attn_layer(i) and self.family == "hybrid":
                total += 3 * d * self.d_ff
            else:
                ff = (self.dense_first_d_ff
                      if (self.dense_first_layer and i == 0 and self.dense_first_d_ff)
                      else self.d_ff)
                n_mats = 3 if self.act == "swiglu" else 2
                total += n_mats * d * ff
        if self.encoder_layers:
            qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            enc = self.encoder_layers * (2 * qkv + 2 * (self.n_heads * hd) * d
                                         + 2 * d * self.d_ff)
            total += enc
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        h = self.moe_hidden
        d = self.d_model
        n_moe = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * d * h
        return total - inactive
