"""Carry a reference index's model across into the port.

The reference keeps its state as arrays; handed over as numpy, the same
model becomes a port `IndexBuild`.  Error bounds are re-verified through
the port's own arithmetic, never copied: the reference's table is valid
only under the arithmetic that verified it.  Integer state (radix tables,
B-tree levels, hash slots) carries no error of its own and is carried as
it is.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from repro_torch.core import (base, btree, hashmap, pgm, radix_spline, rbs,
                              rmi)
from repro_torch.kernels.common import resolve_device


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
