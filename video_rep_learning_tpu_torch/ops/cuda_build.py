"""Build the package's hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with
`nvcc` for `sm_90a` into `build/kernels/<name>-<hash>.so` at the root of the
checkout (a directory `.gitignore` lists), keyed by a hash of the source and
the flags, and loaded with `ctypes`. Nothing here runs at import time: the CPU
tests import every module of the package on hosts without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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


def library_path(name: str) -> Path:
    """Where the shared library for `csrc/<name>.cu` lives once built."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


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
