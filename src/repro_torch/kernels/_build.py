"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, which
`load` opens with ``ctypes``.  Libraries live in ``build/repro_torch_kernels/``
at the root of the checkout, keyed by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds and an unchanged one is reused.  There is no fallback: a missing
``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> {"seconds", "ptxas", "cached", "path"} for every source built
#: or found in this process (what `chip_smoke.py` reports).
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source not yet built, in parallel; return BUILD_INFO."""
    with _LOCK:
        pending = []
        for src in sorted(CSRC.glob("*.cu")):
            out = _target(src)
            if src.stem in BUILD_INFO:
                continue
            if out.exists():
                BUILD_INFO[src.stem] = dict(seconds=0.0, ptxas="", cached=True,
                                            path=str(out))
                continue
            pending.append((src, out))
        if not pending:
            return BUILD_INFO
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src, out in pending:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out)
            BUILD_INFO[src.stem] = dict(seconds=time.perf_counter() - t0,
                                        ptxas=log.strip(), cached=False,
                                        path=str(out))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        info = build_all().get(name)
        if info is None:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        lib = _LIBS[name] = ctypes.CDLL(info["path"])
    return lib
