"""Unified model API, as the reference's `repro.models.model`:

  init_params(cfg, seed, device)      the model (`transformer.Decoder`, or
                                      `encdec.EncDec` for the encdec
                                      family), weights from a seed
  forward(cfg, params, batch)         logits + aux (train / prefill)
  loss_fn(cfg, params, batch)         scalar next-token loss + MoE aux
  decode_step(cfg, params, cache, t)  one-token serve step (no autograd)
  cache_shapes / init_cache           decode-state shapes (meta) / zeros
  param_specs / cache_specs           logical axis names of the parameters
                                      (keyed as ``named_parameters``) and
                                      of the cache (`repro_torch.dist`)
  input_specs / input_spec_names      every input as a meta tensor, and
                                      its logical axis names

Every family of the reference is ported: dense, vlm, moe, ssm, hybrid
and encdec, whose ``forward`` reads ``batch["frames"]``.  The weights
are trainable (`repro_torch.train`).  The specs are the reference's
sharding and dry-run surface: `repro_torch.dist.sharding` resolves them
against a mesh, the data-parallel train driver stores each parameter as
they place it, and `repro_torch.launch.dryrun` sizes every cell by them.
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


def param_specs(cfg: ModelConfig):
    """Every parameter's logical axis names, keyed and ordered as the
    model's ``named_parameters()`` (a meta-device model names them)."""
    specs = (E.encdec_specs(cfg) if cfg.family == "encdec"
             else T.decoder_specs(cfg))
    model = init_params(cfg, device="meta")
    return {n: specs[n] for n, _ in model.named_parameters()}


def forward(cfg: ModelConfig, params, batch):
    if cfg.family == "encdec":
        return E.encdec_forward(cfg, params, batch["frames"],
                                batch["tokens"])
    return T.decoder_forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ModelConfig, params, batch, count=None, aux_scale=1.0):
    """Next-token cross entropy (+ MoE aux) with float32 logits math.

    The token losses are summed and divided by ``count``, the unmasked
    labels (default: this batch's); a data-parallel rank passes the count
    over every rank's batch and its share of the aux (``aux_scale``), so
    that the ranks' losses sum to the global batch's."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).float()
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    count = mask.sum() if count is None else count
    loss = ((logz - gold) * mask).sum() / torch.clamp(count, min=1.0)
    return loss + aux * aux_scale


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


def cache_specs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return E.encdec_cache_specs(cfg)
    return T.cache_specs(cfg)


def input_specs(cfg: ModelConfig, seq_len: int, batch: int,
                kind: str = "train"):
    """Every model input as a meta tensor (shape and type, no storage)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        specs = {"tokens": meta((batch, seq_len), torch.int32)}
        if kind == "train":
            specs["labels"] = meta((batch, seq_len), torch.int32)
        if cfg.family == "encdec":
            specs["frames"] = meta((batch, cfg.encoder_seq, cfg.d_model),
                                   getattr(torch, cfg.dtype))
        return specs
    if kind == "decode":
        return {"tokens": meta((batch, 1), torch.int32)}
    raise ValueError(kind)


def input_spec_names(cfg: ModelConfig, kind: str = "train"):
    names = {"tokens": ("batch", "seq") if kind != "decode"
             else ("batch", None)}
    if kind == "train":
        names["labels"] = ("batch", "seq")
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        names["frames"] = ("batch", None, None)
    return names
