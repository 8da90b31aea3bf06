"""Build the port's hand-written CUDA kernels from the repository's sources.

Each ``csrc/*.cu`` file has a plain C interface. ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under ``build/`` (git-ignored) at
first use; the library name carries a digest of the source, so an edited
source is rebuilt and a current one is loaded as it is. The caller binds the
library with ``ctypes``.

``load`` goes through the serving program cache (serving/program_cache.py),
keyed by the library's name: its per-key latch builds and binds a library
once per process however many threads launch its kernel first, and each
later load is a cache hit on the bound query. ``build`` names its
temporary file per process and thread, so two builds of one source never
write one file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

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


#: source -> its library path (the digest is read once per process)
_PATHS: Dict[str, Path] = {}


def library_path(source: str) -> Path:
    path = _PATHS.get(source)
    if path is None:
        src = CSRC_DIR / source
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        path = _PATHS[source] = BUILD_DIR / f"{src.stem}-{digest}.so"
    return path


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library is current -> (library
    path, compiler log; empty when nothing was compiled)."""
    so = library_path(source)
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(
        f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def load(source: str,
         bind: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built if need be and loaded once
    per process; ``bind`` (its ctypes signatures) runs once, on the
    loaded library."""
    from spark_rapids_tpu_torch.serving.program_cache import \
        global_program_cache

    def builder() -> ctypes.CDLL:
        lib = ctypes.CDLL(str(build(source)[0]))
        if bind is not None:
            bind(lib)
        return lib
    key = ("cuda_library", library_path(source).name)
    return global_program_cache().get_or_build(key, builder).fn
