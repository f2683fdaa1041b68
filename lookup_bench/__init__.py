"""The benchmark of the PyTorch port's read path (`repro_torch`).

One run measures one cell of ``BENCHMARK.json``: one configuration (a
dataset generator, a key count and an index spec, ``configs/``) under one
traffic mix (``traffic/``).  ``run.py`` is the command; `harness` does the
work; `reference` decides ``correct``.  Per-layer metrics are small
readers under ``metrics/``, dataset generators live under ``datagen/``,
each found by the name that ``BENCHMARK.json`` or a configuration gives.
"""

import importlib.util
from pathlib import Path


def load_file(path: Path):
    """The module in ``path``, a file a name in ``BENCHMARK.json`` or a
    configuration points to (names may hold ``.`` and ``-``)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    name = "lookup_bench_" + "_".join(path.parts[-2:]).replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
