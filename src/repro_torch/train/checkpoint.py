"""Atomic, async checkpointing, as the reference's
`repro.train.checkpoint`, with its on-disk layout (one directory a
step):

  ckpt_dir/step_00000123.tmp/      written first
    shard_0.npz                    every tensor, gathered to the host
    manifest.json                  step, keys, shapes, dtypes (fsynced)
  ckpt_dir/step_00000123/          atomic rename: the commit

A state is a tree of tensors: dicts, lists and tuples (a `TrainState`, an
`AdamWState`), an ``nn.Module`` (its named parameters) or a tensor; a
leaf's key is its path joined by ``/``.  bf16 is stored as its ``uint16``
bits beside its dtype name, as the reference stores it; loading views
the bits back as ``torch.bfloat16``, so no ``ml_dtypes`` is needed.

The tensors are copied to the host before the writer thread starts (the
reference's ``device_get``): the optimizer updates them in place, and a
copy taken later would save a later step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``[(key, tensor)]`` in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, torch.nn.Module):
        items = [(n.replace(".", "/"), p) for n, p in tree.named_parameters()]
    elif dataclasses.is_dataclass(tree):
        items = [(str(i), getattr(tree, f.name))
                 for i, f in enumerate(dataclasses.fields(tree))]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy as numpy, bf16 as its uint16 bits; and the dtype's
    name."""
    name = str(t.dtype).split(".")[1]
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_savable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None,
         async_: bool = True) -> Optional[threading.Thread]:
    """Write ``state`` at ``step``; with ``async_`` on a thread, which is
    returned (join it before the next save)."""
    flat = _flatten(state)
    keys = [k for k, _ in flat]
    host, dtype_names = zip(*[_to_savable(t) for _, t in flat]) \
        if flat else ((), ())

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{k: v for k, v in zip(keys, host)})
        manifest = {"step": step, "keys": keys,
                    "shapes": [list(v.shape) for v in host],
                    "dtypes": list(dtype_names), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step (``.tmp`` directories are not)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", f))]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like):
    """Load ``step`` into ``like``, a state of the same tree: every tensor
    of ``like`` is overwritten in place (on its own device, in its own
    type) and ``like`` is returned.  A different key list raises."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(like)
    keys = [k for k, _ in flat]
    if keys != manifest["keys"]:
        raise ValueError("checkpoint/tree structure mismatch")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for (k, t), dn in zip(flat, manifest["dtypes"]):
            v = _from_savable(data[k], dn)
            if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
                raise ValueError(f"{k}: checkpoint holds {v.dtype} "
                                 f"{tuple(v.shape)}, the state {t.dtype} "
                                 f"{tuple(t.shape)}")
            t.copy_(v)
    return like
