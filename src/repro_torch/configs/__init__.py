"""Assigned architecture configs.  ``get(name)`` / ``get_smoke(name)``."""
from repro_torch.configs.registry import ARCHS, SHAPES, get, get_smoke, SKIPS  # noqa: F401
