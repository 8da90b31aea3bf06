"""Build the port's hand-written CUDA kernels from the repository's sources.

Each ``csrc/*.cu`` file has a plain C interface. ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under ``build/`` (git-ignored) at
first use; the library name carries a digest of the source, so an edited
source is rebuilt and a current one is loaded as it is. The caller binds the
library with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from csrc/ on a host with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library is current -> (library
    path, compiler log; empty when nothing was compiled)."""
    so = library_path(source)
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def load(source: str) -> ctypes.CDLL:
    so, _log = build(source)
    return ctypes.CDLL(str(so))
