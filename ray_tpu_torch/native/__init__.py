"""CUDA kernels, built on demand with nvcc and bound with ctypes.

Counterpart of ray_tpu/native's content-hashed g++ builder. Each
``ray_tpu_torch/csrc/<name>.cu`` compiles into its own shared library with a
plain C interface under ``ray_tpu_torch/_build/`` (listed in .gitignore);
the library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header rebuilds and
an unchanged one is reused. ``build_all()`` starts one nvcc per stale
source, all at once, and waits for them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check()`` raises when that is not 0 (a refused launch never runs, and a
later synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's stderr of the build made by this process (ptxas register
# and shared-memory report), for the smoke run to print.
build_logs: Dict[str, str] = {}


class NativeBuildError(RuntimeError):
    pass


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise NativeBuildError("nvcc not found (needs the CUDA toolkit)")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of the flags, the source and
    every header under csrc/ (a source may include any of them)."""
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every stale source in parallel; return name -> library
    path."""
    names = list(names or sources())
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n in names:
        if os.path.exists(paths[n]):
            continue
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        build_logs[n] = out + err
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}{err}")
            continue
        os.replace(tmp, paths[n])
    if errors:
        raise NativeBuildError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _libs[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of csrc/<lib_name>.cu with its argument types set
    (pointers and the stream as c_void_p, or ctypes would pass them as
    32-bit ints) and an int return (the cudaError_t of the launch)."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
