"""Unified model API, as the reference's `repro.models.model`:

  init_params(cfg, seed, device)      the model (`transformer.Decoder`, or
                                      `encdec.EncDec` for the encdec
                                      family), weights from a seed
  forward(cfg, params, batch)         logits + aux (train / prefill)
  loss_fn(cfg, params, batch)         scalar next-token loss + MoE aux
  decode_step(cfg, params, cache, t)  one-token serve step (no autograd)
  cache_shapes / init_cache           decode-state shapes (meta) / zeros

Every family of the reference is ported: dense, vlm, moe, ssm, hybrid
and encdec, whose ``forward`` reads ``batch["frames"]``.  The weights
are trainable (`repro_torch.train`).  ``param_specs``, ``cache_specs``
and ``input_specs`` are the reference's sharding and dry-run surface and
wait for the port's ``dist/``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The model with weights drawn from ``seed`` on ``device`` (``None``
    means the CUDA card; ``"meta"`` allocates nothing)."""
    if cfg.family != "encdec":
        T.stack_plan(cfg)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    if cfg.family == "encdec":
        return E.EncDec(cfg, gen, dev)
    return T.Decoder(cfg, gen, dev)


def forward(cfg: ModelConfig, params, batch):
    if cfg.family == "encdec":
        return E.encdec_forward(cfg, params, batch["frames"],
                                batch["tokens"])
    return T.decoder_forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross entropy (+ MoE aux) with float32 logits math."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).float()
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    loss = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux


def decode_step(cfg: ModelConfig, params, cache, tokens, active=None):
    """One token a row; ``active`` (bool ``[B]``) limits which rows'
    recurrent state advances (`transformer.decoder_decode`; the encdec
    family has none)."""
    if cfg.family == "encdec":
        return E.encdec_decode(cfg, params, cache, tokens)
    return T.decoder_decode(cfg, params, cache, tokens, active)


def cache_shapes(cfg: ModelConfig, batch: int, s_max: int):
    if cfg.family == "encdec":
        return E.encdec_cache_shapes(cfg, batch, s_max)
    return T.init_cache_shapes(cfg, batch, s_max)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """A zeroed decode cache on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)

    return zeros(cache_shapes(cfg, batch, s_max))
