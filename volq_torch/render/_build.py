"""Build and load the port's CUDA kernels (``volq_torch/csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``build/volq_torch/`` at the repository
root, named by the content hash of the source and of every file under
``csrc/`` it includes (an edited source or header rebuilds), and loaded
with ``ctypes``.  ``build_all`` starts one ``nvcc`` per
source at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "volq_torch"
SOURCES = ("warp_march", "warp_composite", "warp_images",
           "composite_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build "
                       "volq_torch's kernels)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _with_includes(path: Path, seen: dict) -> dict:
    """``path`` and, recursively, every file under csrc/ it includes by
    ``#include "..."`` -> their bytes, in first-seen order."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(seen[path]):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and CSRC in dep.parents:
                _with_includes(dep, seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path, data in _with_includes(CSRC / f"{name}.cu", {}).items():
        h.update(path.name.encode() + b"\0" + data)
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, verbose: bool):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, job, verbose: bool):
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    if verbose and log.strip():
        print(f"[nvcc {name}]\n{log.strip()}")
    os.replace(tmp, out)


def build_all(verbose: bool = False) -> float:
    """Compile every kernel source not yet built, one ``nvcc`` each, all
    started together.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = {name: _start(name, verbose) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job, verbose)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        job = _start(name, False)
        if job is not None:
            _finish(name, job, False)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib
