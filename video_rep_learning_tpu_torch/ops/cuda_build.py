"""Build the package's hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with
`nvcc` for `sm_90a` into `build/kernels/<name>-<hash>.so` at the root of the
checkout (a directory `.gitignore` lists), keyed by a hash of the source and
the flags, and loaded with `ctypes`. The hash covers the headers of `csrc/` a
source includes (`#include "name.cuh"`), so an edited header rebuilds every
library that includes it. Nothing here runs at import time: the CPU
tests import every module of the package on hosts without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the CUDA kernels build only where the toolkit is")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_closure(path: Path, seen=None):
    """`path` and every `csrc/` header it includes, directly or not, in a
    fixed order."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
        _source_closure(CSRC_DIR / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """Where the shared library for `csrc/<name>.cu` lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_closure(CSRC_DIR / f"{name}.cu"):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a build of this exact source exists.
    The compiler's resource report (`-Xptxas -v`) is kept beside the library
    as `<lib>.log`."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    so.with_name(so.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` once per process."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str, symbol: str, argtypes: tuple):
    """`symbol` of `csrc/<name>.cu`'s library with its ctypes signature: a
    pointer is `ctypes.c_void_p`, an int `ctypes.c_int`, a float
    `ctypes.c_float`; it returns a cudaError_t."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (the library's own
    `vrl_cuda_error_string` names it)."""
    if err != 0:
        lib = load(name)
        lib.vrl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vrl_cuda_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: "
                           + lib.vrl_cuda_error_string(err).decode())
