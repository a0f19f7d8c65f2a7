"""Build, load and bind the port's CUDA kernels (``volq_torch/csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``build/volq_torch/`` at the repository
root, named by the content hash of the source and of every file under
``csrc/`` it includes (an edited source or header rebuilds), and loaded
with ``ctypes``.  ``build_all`` starts one ``nvcc`` per
source at once.  Nothing here runs at import time.

``launch`` is the port's one kernel boundary: every C entry point of
every library is bound, called, checked and counted there, and nowhere
else.  ``launches`` counts the calls by C function name (always on;
``launches.clear()`` zeroes it), and under the program's tracing each
call also counts its name under the innermost open ``volq.*`` span
(``core/trace.count``).  ``check_tensor``, ``ptr`` and ``stream`` are
what every wrapper needs to hand tensors to a C function.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

from volq_torch.core import trace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "volq_torch"
SOURCES = ("warp_march", "warp_composite", "warp_images",
           "composite_chunk", "noise_bake", "sim_step", "light_bake",
           "probe_mma", "probe_stage", "probe_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
# (library, C function) -> the bound function
_bound: dict = {}
# calls of each C function, by name, since the last ``launches.clear()``
launches: Counter = Counter()


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


def _bind(lib: str, name: str, argtypes):
    """C function ``name`` of kernel library ``lib`` (built at first
    use), returning an int error code, with its argument types set."""
    fn = getattr(load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def launch(lib: str, name: str, argtypes, *args, why=None) -> None:
    """Call C function ``name`` of kernel library ``lib`` on ``args``,
    binding it with ``argtypes`` at its first call.  A non-zero return
    raises RuntimeError naming the function and the code (``why(code)``
    words it, default "CUDA error <code>"); otherwise the call counts 1
    in ``launches[name]`` and, under the program's tracing, ``name``
    under the innermost open span."""
    fn = _bound.get((lib, name))
    if fn is None:
        fn = _bound[lib, name] = _bind(lib, name, argtypes)
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} failed: "
                           + (why(err) if why else f"CUDA error {err}"))
    launches[name] += 1
    trace.count(name)


def check_tensor(t: torch.Tensor, name: str, dtypes, shape=None,
                 device=None):
    """Raise unless ``t`` has one of ``dtypes``, the given shape and
    device, and is contiguous (what the kernels take)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """Device pointer of ``t`` (NULL for an absent optional input)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
