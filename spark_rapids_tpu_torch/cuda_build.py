"""Build the port's hand-written CUDA kernels from the repository's sources.

Each ``csrc/*.cu`` file has a plain C interface. ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under ``build/`` (git-ignored) at
first use; the library name carries a digest of the source, of
``NVCC_FLAGS`` and of the toolchain identity (``shims.get().identity()``:
torch's CUDA, the ``nvcc`` release, the arch), so a library is rebuilt when
any of them changes and a current one is loaded as it is. The caller binds
the library with ``ctypes``.

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


def nvcc_path_or_none() -> Optional[str]:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def nvcc_path() -> str:
    path = nvcc_path_or_none()
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from csrc/ on a host with the CUDA toolkit")
    return path


#: (source, flags, toolchain identity) -> its library path (the source's
#: digest is read once per process)
_PATHS: Dict[Tuple[str, Tuple[str, ...], str], Path] = {}


def library_path(source: str) -> Path:
    """``build/<stem>-<digest>.so``: the digest covers the source's bytes,
    ``NVCC_FLAGS`` and the toolchain identity, which is also the program
    cache's key (``load``)."""
    from spark_rapids_tpu_torch import shims
    ident = shims.get().identity()
    key = (source, tuple(NVCC_FLAGS), ident)
    path = _PATHS.get(key)
    if path is None:
        src = CSRC_DIR / source
        h = hashlib.sha256(src.read_bytes())
        h.update("\0".join(NVCC_FLAGS).encode())
        h.update(b"\0" + ident.encode())
        path = _PATHS[key] = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
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
    loaded library. The cache key carries the library's name: the digest
    of the source, the flags and the toolchain the builder compiles
    with."""
    from spark_rapids_tpu_torch.serving.program_cache import \
        global_program_cache
    name = library_path(source).name

    def builder() -> ctypes.CDLL:
        lib = ctypes.CDLL(str(build(source)[0]))
        if bind is not None:
            bind(lib)
        return lib
    key = ("cuda_library", source, name)
    cache = global_program_cache()
    return cache.get_or_build(key, builder).fn
