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
from repro_torch.core import pgm, rmi, spec, tuning
from repro_torch.kernels.common import encode_keys
from repro_torch.kernels.rmi_lookup import ops
from repro_torch.mutable import DeltaBuffer, MutableIndex
from repro_torch.autotune import AutotuneConfig
from repro_torch.core.spec import Tuner
from repro_torch.configs import get_smoke
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.lookup import (IndexRegistry, LookupService,
                                      LookupServiceConfig,
                                      MutableLookupService, RoutedDispatcher,
                                      ShardedDispatcher, ShardTopology)

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
    assert res["modules"] >= 60
    assert res["bad"] == [], f"port pulled in {res['bad']}"


_IMPORT_ONE = r"""
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


@pytest.mark.parametrize("module", [
    "repro_torch.serve.lookup.topology", "repro_torch.autotune",
    "repro_torch.autotune.store", "repro_torch.autotune.objective",
    "repro_torch.autotune.retuner", "repro_torch.models.model",
    "repro_torch.serve.engine", "repro_torch.configs",
    "repro_torch.models.encdec", "repro_torch.train.train_step",
    "repro_torch.train.checkpoint", "repro_torch.data.pipeline",
    "repro_torch.launch.train"])
def test_each_new_module_alone_loads_no_jax_and_no_reference(module):
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []


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
    lambda: spec.Tuner(names=("rbs",)).tune(KEYS),
    lambda: tuning.sweep(KEYS, names=("rbs",), max_configs=1),
    lambda: LookupService(KEYS),
    lambda: IndexRegistry(),
    lambda: ShardedDispatcher(),
    lambda: DeltaBuffer.empty(),
    lambda: MutableIndex(KEYS),
    lambda: MutableLookupService(KEYS),
    lambda: LookupService(KEYS, LookupServiceConfig(executor="async")),
    lambda: LookupService(KEYS, LookupServiceConfig(shards=2)),
    lambda: LookupService(KEYS, LookupServiceConfig(executor="async",
                                                    shards=2, replicas=2)),
    lambda: RoutedDispatcher(ShardTopology.from_keys(KEYS, 2)),
    lambda: LookupService(KEYS, LookupServiceConfig(
        autotune=AutotuneConfig())),
    lambda: Tuner(names=("rbs",)).tune_shards(KEYS, (0, 500, 1000)),
], ids=["rmi.build", "spec.build", "encode_keys", "prepare_f32_state",
        "rmi_from_reference", "pgm.build", "binary_search", "robin_hash",
        "from_reference", "Tuner.tune", "tuning.sweep", "LookupService",
        "IndexRegistry", "ShardedDispatcher", "DeltaBuffer",
        "MutableIndex", "MutableLookupService", "LookupService_async",
        "LookupService_routed", "LookupService_routed_async",
        "RoutedDispatcher", "LookupService_autotune",
        "Tuner.tune_shards"])
def test_device_none_raises_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_device_cpu_is_honoured(no_card):
    b = rmi.build(KEYS, branching=64, device="cpu")
    assert b.device == torch.device("cpu")


def test_routed_service_and_retuner_honour_the_cpu(no_card):
    svc = LookupService(KEYS, LookupServiceConfig(
        executor="async", shards=2, replicas=2,
        autotune=AutotuneConfig(calibrate=False)), device="cpu")
    assert isinstance(svc.dispatcher, RoutedDispatcher)
    assert {lane.device for grp in svc.dispatcher.lanes
            for lane in grp} == {torch.device("cpu")}
    assert all(g.data.device == torch.device("cpu")
               for g in svc.generation.shards)
    assert svc.autotune.device == torch.device("cpu")
    q = KEYS[::7] + 1
    np.testing.assert_array_equal(svc.lookup(q), np.searchsorted(KEYS, q))
    d = svc.autotune.poll_once(force_trigger="workload_drift")
    assert d["action"] in ("swapped", "rejected"), d


def test_token_serving_refuses_the_cpu_unasked(no_card):
    cfg = get_smoke("granite-3-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 2, 8)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_token_driver_refuses_the_cpu_unasked():
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--mode", "tokens", "--smoke"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "tok/s" not in out.stdout


def test_training_refuses_the_cpu_unasked(no_card):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.train.optimizer import AdamW
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(get_smoke("whisper-tiny"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(PipelineConfig(vocab=64, seq_len=8, global_batch=2))
    params = M.init_params(get_smoke("granite-3-2b"), device="cpu")
    assert AdamW(lr=lambda s: 1e-3).init(params).step.device.type == "cpu"


def test_train_driver_refuses_the_cpu_unasked():
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--smoke", "--steps", "1"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "loss" not in out.stdout
