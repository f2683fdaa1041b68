"""Batched serving engine: prefill and decode with continuous batching.

The reference's `repro.serve.engine` on one CUDA card: a request queue,
paged-KV bookkeeping (`kv_cache.PagedKVCache`), greedy sampling,
per-request stop handling and step-level batching.  As in the reference,
a prompt is prefilled through decode steps (one compiled graph there, one
eager step here), and the host's ``lens`` is the truth for every slot's
fill: the cache's ``len`` is overwritten from it after every step, so an
idle slot, whose ``lens`` stays where its last request left it, writes
its padding token there and nowhere else.

Recurrent (SSD) state is per slot.  The reference lets every slot's
state advance on every step, a prefill step's dummy tokens included, and
a re-admitted slot starts from its last request's state (ROADMAP C); here
an admitted slot's state is zeroed, and a step advances only the rows of
the slots it serves: the filling slot in a prefill step, the active ones
in a decode step.  So a request's tokens do not depend on what else is
batched with it.

The encdec family (whisper-tiny) decodes against cached encoder states
(``enc_out``), which the engine leaves at zero, as the reference's does:
it runs no encoder pass, and an admitted slot has no state to reset.
Every step runs with no autograd graph (`models.model.decode_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve.common import MonotonicCounter
from repro_torch.serve.kv_cache import PagedKVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``params`` (a `models.model.init_params` model) on
    ``device`` (``None``: the CUDA card), where the params must lie."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_seq: int = 512, page_size: int = 16, device=None):
        self.device = resolve_device(device)
        where = {p.device for p in params.parameters()}
        if where != {self.device}:
            raise ValueError(f"params lie on {sorted(map(str, where))}, "
                             f"the engine serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv = PagedKVCache(
            n_pages=max_batch * (max_seq // page_size + 1),
            page_size=page_size, max_seqs=max_batch,
            max_pages_per_seq=max_seq // page_size + 1)
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        self._rids = MonotonicCounter()
        self.cache = M.init_cache(cfg, max_batch, max_seq, self.device)
        self.lens = np.zeros((max_batch,), np.int32)  # host truth for fills
        self._recurrent = T.recurrent_state(self.cache)
        self._decode = lambda cache, toks, active: M.decode_step(
            cfg, params, cache, toks, active)

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        rid = self._rids.next()
        self.queue.append(Request(rid, list(prompt), max_new))
        return rid

    def _admit(self):
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue.pop(0)
            slot = next(i for i in range(self.max_batch)
                        if i not in self.slot_of.values())
            self.active[req.rid] = req
            self.slot_of[req.rid] = slot
            self.kv.add_sequence(slot, len(req.prompt))
            for t, bdim in self._recurrent:    # a fresh recurrent state
                t.select(bdim, slot).zero_()
            self._prefill_into_cache(req, slot)

    def _with_host_lens(self, cache):
        return dict(cache, len=torch.from_numpy(self.lens.copy()).to(
            self.device))

    def _step_tokens(self, toks: np.ndarray, active: np.ndarray):
        """One decode step of the whole batch, the recurrent state of the
        ``active`` slots advancing; ``(logits, new cache)``.  The host's
        lens and the mask go to the device in one copy."""
        host = torch.from_numpy(np.stack([self.lens, active]).astype(
            np.int32)).to(self.device)
        self.cache = dict(self.cache, len=host[0])
        return self._decode(self.cache, torch.from_numpy(toks).to(
            self.device), host[1] != 0)

    def _prefill_into_cache(self, req: Request, slot: int):
        """Run the prompt through decode steps to fill the cache slot."""
        self.lens[slot] = 0
        only = np.arange(self.max_batch) == slot
        for tok in req.prompt:
            toks = np.zeros((self.max_batch, 1), np.int32)
            toks[slot, 0] = tok
            _, new_cache = self._step_tokens(toks, only)
            self.lens[slot] += 1  # only this slot advances during prefill
            self.cache = self._with_host_lens(new_cache)

    @torch.inference_mode()
    def step(self) -> Dict[int, int]:
        """One decode step for every active request; returns new tokens."""
        self._admit()
        if not self.active:
            return {}
        toks = np.zeros((self.max_batch, 1), np.int32)
        active = np.zeros(self.max_batch, bool)
        for rid, req in self.active.items():
            last = req.out[-1] if req.out else req.prompt[-1]
            toks[self.slot_of[rid], 0] = last
            active[self.slot_of[rid]] = True
        logits, new_cache = self._step_tokens(toks, active)
        logits = logits.float().cpu().numpy()
        emitted = {}
        for rid, req in list(self.active.items()):
            slot = self.slot_of[rid]
            tok = int(np.argmax(logits[slot][: self.cfg.vocab]))
            req.out.append(tok)
            self.kv.append_token(slot)
            self.lens[slot] += 1
            emitted[rid] = tok
            if len(req.out) >= req.max_new:
                req.done = True
                self.kv.free_sequence(slot)
                del self.active[rid]
                del self.slot_of[rid]
        self.cache = self._with_host_lens(new_cache)
        return emitted

    def run(self, max_steps: int = 256) -> Dict[int, List[int]]:
        all_reqs: Dict[int, Request] = {}
        for _ in range(max_steps):
            if not (self.queue or self.active):
                break
            for rid, req in self.active.items():
                all_reqs[rid] = req
            self.step()
        return {rid: req.out for rid, req in all_reqs.items()}
