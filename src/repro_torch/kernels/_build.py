"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Each ``kernels/<name>/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``build/repro_torch/`` at the repository root (listed in ``.gitignore``).
The library name carries a hash of the ``csrc`` directory's files (the
source and the headers it includes) and the flags, so an edited source
builds anew and an unchanged one is loaded as it is.  ``build()``
starts one ``nvcc`` per missing source, all together, and waits for all of
them.  Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {name: KERNELS_DIR / name / "csrc" / f"{name}.cu"
           for name in ("fedagg", "distill", "flash", "grouped_gemm")}

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the port's "
            "CUDA kernels are compiled from source at first use")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SOURCES[name].parent.iterdir()):
        h.update(f.name.encode() + f.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile every library in ``names`` (default: all) that is not built
    yet.  Returns {name: nvcc output} for the ones compiled now (ptxas
    prints each kernel's registers and shared memory).  Raises with the
    compiler's output if any build fails."""
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    logs, errors = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(n))
            logs[n] = out
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def kernel_fn(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of library ``name``, built and loaded
    on first use.  Every entry point returns ``cudaGetLastError()``."""
    key = (name, symbol)
    with _lock:
        if key not in _fns:
            if name not in _libs:
                build([name])
                _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(_libs[name], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return _fns[key]


def check(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
