"""The port stands alone: it loads no JAX and nothing of `repro`, and its
entry points refuse to fall back to the CPU unasked."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import pgm, rmi, spec
from repro_torch.kernels.common import encode_keys
from repro_torch.kernels.rmi_lookup import ops

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["modules"] >= 30
    assert res["bad"] == [], f"port pulled in {res['bad']}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


KEYS = np.arange(1, 1_001, dtype=np.uint64) * 7


@pytest.mark.parametrize("entry", [
    lambda: rmi.build(KEYS, branching=64),
    lambda: spec.build(spec.IndexSpec("rmi", {"branching": 64}), KEYS),
    lambda: encode_keys(KEYS),
    lambda: ops.prepare_f32_state(KEYS, branching=64),
    lambda: convert.rmi_from_reference(
        {"coeffs": np.array([1.0, 0.0]), "a2": np.zeros(4), "b2": np.zeros(4),
         "x0": np.float64(7.0), "inv_range": np.float64(1.0)},
        KEYS, {"branching": 4}),
    lambda: pgm.build(KEYS),
    lambda: spec.build(spec.IndexSpec("binary_search"), KEYS),
    lambda: spec.build(spec.IndexSpec("robin_hash"), KEYS),
    lambda: convert.from_reference(
        "rbs", {"table": np.arange(3), "kmin": np.uint64(7)}, KEYS,
        {"radix_bits": 1, "last_mile": "binary"}),
], ids=["rmi.build", "spec.build", "encode_keys", "prepare_f32_state",
        "rmi_from_reference", "pgm.build", "binary_search", "robin_hash",
        "from_reference"])
def test_device_none_raises_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_device_cpu_is_honoured(no_card):
    b = rmi.build(KEYS, branching=64, device="cpu")
    assert b.device == torch.device("cpu")
