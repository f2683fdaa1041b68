"""Carry a reference index's model across into the port.

The reference keeps its state as arrays; handed over as numpy, the same
model becomes a port `IndexBuild`.  Error bounds are re-verified through
the port's own arithmetic, never copied: the reference's table is valid
only under the arithmetic that verified it.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from repro_torch.core import base, rmi
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
