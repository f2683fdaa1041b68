"""Carry a reference index's model, or a reference LM's weights, across
into the port.

The reference keeps its state as arrays; handed over as numpy, the same
model becomes a port `IndexBuild` (or, for the LM, a port `Decoder`:
`decoder_from_reference`, or `encdec_from_reference`; a training run's
state: `train_state_from_reference`).  Error bounds are re-verified through
the port's own arithmetic, never copied: the reference's table is valid
only under the arithmetic that verified it.  Integer state (radix tables,
B-tree levels, hash slots) carries no error of its own and is carried as
it is.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core import (base, btree, hashmap, pgm, radix_spline, rbs,
                              rmi)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig


def rmi_from_reference(ref_state: Mapping[str, np.ndarray], keys: np.ndarray,
                       hyper: Dict[str, Any], device=None) -> base.IndexBuild:
    """A port RMI with the reference RMI's model.

    ``ref_state`` holds the reference state's ``coeffs``, ``a2``, ``b2``,
    ``x0`` and ``inv_range`` as numpy arrays (its ``err`` is ignored: the
    table is rebuilt on ``device`` from the port's bucket assignment and
    stage-2 arithmetic); ``hyper`` is the reference build's ``hyper``.
    """
    dev = resolve_device(device)
    B = int(hyper["branching"])
    a2 = np.asarray(ref_state["a2"], np.float64)
    b2 = np.asarray(ref_state["b2"], np.float64)
    if a2.shape != (B,) or b2.shape != (B,):
        raise ValueError(f"stage-2 tables must have branching={B} rows")
    return rmi._assemble(
        np.asarray(keys), np.asarray(ref_state["coeffs"], np.float64), a2, b2,
        float(np.asarray(ref_state["x0"])),
        float(np.asarray(ref_state["inv_range"])), B,
        hyper.get("stage1", "linear"), hyper.get("last_mile", "binary"), dev)


def pgm_from_reference(ref_state, keys, hyper, device=None):
    """The reference's PGM levels; each level's error re-verified."""
    keys = np.asarray(keys)
    levels = [tuple(np.asarray(a, np.float64) for a in level)
              for level in ref_state["levels"]]
    return pgm._assemble(len(keys), base.grouped_keys(keys), levels,
                         {k: hyper[k] for k in ("eps", "eps_internal",
                                                "top_cutoff", "last_mile")},
                         resolve_device(device))


def radix_spline_from_reference(ref_state, keys, hyper, device=None):
    """The reference's spline knots; the radix table rebuilt over them
    and the bound checked over every key."""
    keys = np.asarray(keys)
    _, _, span = base.grouped_keys(keys)
    return radix_spline._assemble(
        keys, np.asarray(ref_state["kx"], np.float64),
        np.asarray(ref_state["ky"], np.float64), int(hyper["eps"]),
        int(hyper["radix_bits"]), hyper["last_mile"], span,
        resolve_device(device))


def rbs_from_reference(ref_state, keys, hyper, device=None):
    """The reference's radix table, as it is."""
    return rbs._assemble(np.asarray(keys), np.asarray(ref_state["table"]),
                         int(hyper["radix_bits"]), hyper["last_mile"],
                         resolve_device(device))


def binary_search_from_reference(ref_state, keys, hyper, device=None):
    """No state to carry."""
    return rbs.build_bs(np.asarray(keys), last_mile=hyper["last_mile"],
                        device=device)


def btree_from_reference(ref_state, keys, hyper, device=None, name="btree"):
    """The reference's sampled levels (coarse -> fine), as they are."""
    b = btree._assemble(
        len(keys), [np.asarray(level) for level in ref_state["levels"]],
        int(hyper["sample"]), int(hyper["fanout"]), hyper["last_mile"],
        resolve_device(device))
    if name == "btree":
        return b
    return base.IndexBuild(name=name, state=b.state, lookup=b.lookup,
                           size_bytes=b.size_bytes, hyper=dict(hyper),
                           meta=b.meta)


def robin_hash_from_reference(ref_state, keys, hyper, device=None):
    """The reference's slot layout, as it is."""
    return hashmap._assemble(
        len(keys), np.asarray(ref_state["slot_key"]),
        np.asarray(ref_state["slot_val"]), float(hyper["load_factor"]),
        int(hyper["probe_window"]), resolve_device(device))


FROM_REFERENCE = {
    "rmi": rmi_from_reference,
    "pgm": pgm_from_reference,
    "radix_spline": radix_spline_from_reference,
    "rbs": rbs_from_reference,
    "binary_search": binary_search_from_reference,
    "btree": btree_from_reference,
    "ibtree": lambda *a, **kw: btree_from_reference(*a, **kw, name="ibtree"),
    "robin_hash": robin_hash_from_reference,
}


def from_reference(name: str, ref_state, keys: np.ndarray,
                   hyper: Dict[str, Any], device=None) -> base.IndexBuild:
    """The port's build of the reference's ``name`` index: ``ref_state``
    is the reference build's state with every array as numpy, ``hyper``
    its ``hyper``."""
    try:
        fn = FROM_REFERENCE[name]
    except KeyError:
        raise ValueError(f"no converter for index {name!r}; "
                         f"known: {sorted(FROM_REFERENCE)}") from None
    return fn(ref_state, keys, hyper, device=device)


def reference_path(model, name: str):
    """``(path, layer)``: the reference tree's keys to the leaf behind the
    port's parameter ``name``, and the index on that leaf's leading layer
    axis (None for an unstacked leaf).

    Decoder: ``pro.{i}.*`` is ``pro{i}``; ``blocks.{n}.*`` is the
    reference's ``blocks.sub{j}`` at layer-axis index ``i`` for ``n = i *
    U + j`` (a unit of ``U`` blocks).  EncDec: ``enc.{i}.*`` and
    ``dec.{i}.*`` are ``enc``/``dec`` at layer-axis index ``i``.  Every
    other name is the same path in the tree."""
    parts = name.split(".")
    layer = None
    if parts[0] == "blocks":
        layer, j = divmod(int(parts[1]), model.unit_len)
        parts = ["blocks", f"sub{j}", *parts[2:]]
    elif parts[0] == "pro":
        parts = [f"pro{parts[1]}", *parts[2:]]
    elif parts[0] in ("enc", "dec"):
        layer = int(parts[1])
        parts = [parts[0], *parts[2:]]
    return parts, layer


def _reference_leaf(model, name: str, tree) -> np.ndarray:
    """The reference leaf behind the port's parameter ``name``
    (`reference_path`), as float32 numpy (bf16 leaves come as float32,
    exactly)."""
    parts, layer = reference_path(model, name)
    for k in parts:
        tree = tree[k]
    arr = np.asarray(tree, np.float32)
    return arr if layer is None else arr[layer]


def _from_reference(model, tree, dev, what: str):
    """Every parameter of the meta-device ``model`` from ``tree``; every
    leaf of the tree must be used."""
    state, used = {}, 0
    for name, p in model.named_parameters():
        arr = _reference_leaf(model, name, tree)
        state[name] = torch.from_numpy(np.array(arr)).to(device=dev,
                                                         dtype=p.dtype)
        used += arr.size
    leaves = sum(np.asarray(a).size for a in _leaves(tree))
    if used != leaves:
        raise ValueError(f"reference tree has {leaves} values, the port's "
                         f"{what} takes {used}")
    model.load_state_dict(state, assign=True)
    return model


def decoder_from_reference(cfg: ModelConfig, params_np,
                           device=None) -> transformer.Decoder:
    """The port's decoder with the reference's weights.

    ``params_np`` is the reference's ``init_params`` tree with every leaf
    as numpy; bf16 leaves come as float32 (exact) and are cast back to
    the parameter's type here.  The prologue's ``pro{i}`` becomes
    ``pro[i]``; the leading layer axis that the reference's ``vmap`` gives
    each ``params["blocks"][f"sub{j}"]`` is unstacked into ``blocks[i * U
    + j]`` for a unit of ``U`` blocks.  Every parameter must be in the
    tree, and every leaf of the tree must be used.
    """
    return _from_reference(transformer.Decoder(cfg, device="meta"),
                           params_np, resolve_device(device),
                           f"{cfg.name} decoder")


def encdec_from_reference(cfg: ModelConfig, params_np,
                          device=None) -> encdec.EncDec:
    """The port's encoder-decoder with the reference's weights: as
    `decoder_from_reference`, the vmapped layer axis of ``enc`` and
    ``dec`` unstacked into ``enc[i]`` and ``dec[i]``."""
    return _from_reference(encdec.EncDec(cfg, device="meta"), params_np,
                           resolve_device(device), f"{cfg.name} encdec")


def model_from_reference(cfg: ModelConfig, params_np, device=None):
    """`encdec_from_reference` or `decoder_from_reference`, by family."""
    if cfg.family == "encdec":
        return encdec_from_reference(cfg, params_np, device)
    return decoder_from_reference(cfg, params_np, device)


def train_state_from_reference(cfg: ModelConfig, state_np, device=None):
    """The port's `TrainState` continuing a reference run.

    ``state_np`` is the reference's ``TrainState`` as numpy: ``params``
    (its tree) and ``opt`` (``AdamWState(step, m, v)``, ``m``/``v`` trees
    shaped as ``params``).  The moments come in the port's parameter
    order, float32; ``step`` as an int32 scalar."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)
    params = model_from_reference(cfg, state_np.params, dev)
    step, m_np, v_np = state_np.opt

    def moments(tree):
        return [torch.from_numpy(np.array(_reference_leaf(params, name,
                                                          tree))).to(dev)
                for name, _ in params.named_parameters()]

    m, v = moments(m_np), moments(v_np)
    for tree, got in ((m_np, m), (v_np, v)):
        if sum(np.asarray(a).size for a in _leaves(tree)) != sum(
                t.numel() for t in got):
            raise ValueError("reference moments do not match the params")
    step_t = torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev)
    return TrainState(params, AdamWState(step_t, m, v))

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
