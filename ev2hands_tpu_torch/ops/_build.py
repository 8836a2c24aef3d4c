"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` in the
repository (``build/`` is listed in ``.gitignore``), which ``ctypes`` loads.
The host batch loader ``csrc/ev2hands_loader.cpp`` compiles the same way
with ``g++`` into ``build/host/`` (``load_host``). A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
a built one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")

# Every kernel source of the port: csrc/<name>.cu
KERNELS = ("fps", "gather", "msg_dense", "msg_ball")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]
# Per-source flags. FPS must round exactly like its plain version: no
# contraction of a multiply and an add into one FMA.
_EXTRA = {"fps": ["-fmad=false"]}

# host sources (csrc/<name>.cpp), compiled with g++
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas' report (registers, shared memory, spills) of each build, by name
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _hashed(src: str, flags: list, out_dir: str, name: str) -> str:
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:12]}.so")


def _target(name: str) -> str:
    return _hashed(os.path.join(CSRC, f"{name}.cu"),
                   _ARCH + _COMMON + _EXTRA.get(name, []), BUILD_DIR, name)


def _command(name: str, out: str) -> list:
    return ([nvcc_path()] + _ARCH + _COMMON + _EXTRA.get(name, [])
            + ["-o", out, os.path.join(CSRC, f"{name}.cu")])


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name))
        _loaded[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, compiled
    with ``g++`` on first use. Raises if it does not build."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is None:
        src = os.path.join(CSRC, f"{name}.cpp")
        out = _hashed(src, HOST_FLAGS, HOST_BUILD_DIR, name)
        if not os.path.isfile(out):
            os.makedirs(HOST_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(["g++"] + HOST_FLAGS + ["-o", tmp, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{name}.cpp: g++ exit {res.returncode}:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _loaded[key] = lib
    return lib
