"""Version shims: adapters over PyTorch and CUDA toolchain drift (the JAX
package's ``shims/``).

Reference analogs: the SparkShims trait (SparkShims.scala:58-127) and
ShimLoader (ShimLoader.scala:33-60), which picks the provider whose
``version_match`` accepts the runtime version. The JAX package's drift
surface is JAX; the port's is PyTorch and the CUDA toolchain that builds
its kernels. Supporting a new torch line means one new provider class.

The version-sensitive calls the port routes through ``get()``:

- ``record_function(name)``: the profiler's named host range
  (``torch.profiler.record_function``; torch 1.x had it only as
  ``torch.autograd.profiler.record_function``), opened by
  ``utils/metrics.py::NamedRange`` and ``utils/tracing.py``'s exec spans;
- ``identity()``: the toolchain a kernel library was built by (the
  provider, ``torch.version.cuda``, the ``nvcc`` release and the arch
  flag). ``cuda_build.library_path`` puts it in every library's name, so
  the program cache's key (the name) changes with it and a library built
  by another toolchain is never loaded as current, as the JAX package puts
  its provider's class name in every mesh program key.

Nothing else in the port reads ``torch.__version__`` or probes torch with
``hasattr``.
"""
from __future__ import annotations

import functools
import re
import subprocess
from typing import List, Optional


class TorchShims:
    """Provider interface (the SparkShims trait's role). Subclasses pin the
    version range they serve and override what drifted there."""

    @staticmethod
    def version_match(version: str) -> bool:
        raise NotImplementedError

    def record_function(self, name: str):
        """A named host range that a profiler run shows; it never
        synchronizes the device."""
        import torch.profiler
        return torch.profiler.record_function(name)

    def identity(self) -> str:
        """The toolchain identity a kernel library's name carries:
        ``<provider>-cuda<torch.version.cuda>-nvcc<release>-<arch>``. The
        ``nvcc`` release is read once per process, and only on a host that
        has ``nvcc``; elsewhere it is ``none``."""
        import torch
        from spark_rapids_tpu_torch import cuda_build
        arch = next((f.split("=")[-1] for f in cuda_build.NVCC_FLAGS
                     if f.startswith("arch=")), "none")
        return (f"{type(self).__name__}-cuda{torch.version.cuda or 'none'}"
                f"-nvcc{nvcc_release() or 'none'}-{arch}")


class Torch2Shims(TorchShims):
    """The torch 2.x line (2.13 on the CPU hosts, the card host's build)."""

    @staticmethod
    def version_match(version: str) -> bool:
        return _parse(version)[0] == 2


#: registration order = match priority (ShimLoader's provider list)
PROVIDERS: List[type] = [Torch2Shims]


def _parse(version: str):
    parts = version.split("+")[0].split(".")
    try:
        return int(parts[0]), int(parts[1])
    except (ValueError, IndexError):
        return (0, 0)


@functools.lru_cache(maxsize=None)
def nvcc_release() -> Optional[str]:
    """The ``nvcc`` release (``12.4``) from ``nvcc --version``, read once
    per process; None on a host without ``nvcc``."""
    from spark_rapids_tpu_torch import cuda_build
    path = cuda_build.nvcc_path_or_none()
    if path is None:
        return None
    with subprocess.Popen([path, "--version"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"{path} --version failed (exit "
                           f"{proc.returncode}):\n{out}")
    m = re.search(r"release (\d+\.\d+)", out)
    if m is None:
        raise RuntimeError(f"cannot read the nvcc release from {path} "
                           f"--version:\n{out}")
    return m.group(1)


@functools.lru_cache(maxsize=None)
def get() -> TorchShims:
    """The provider matching the runtime torch version (ShimLoader.getShims
    analog), made once per process; raises if no provider claims it."""
    import torch
    version = torch.__version__
    for cls in PROVIDERS:
        if cls.version_match(version):
            return cls()
    raise RuntimeError(
        f"no shim provider matches torch {version}; supported: "
        f"{[c.__name__ for c in PROVIDERS]}")
