"""GPU resource discovery (the JAX package's ``discovery.py``; the
reference's ExclusiveModeGpuDiscoveryPlugin.scala).

Spark executors discover accelerators through a resource-discovery script
that prints a JSON document ``{"name": ..., "addresses": [...]}``; the
reference's plugin also picks an unused GPU by taking an exclusive OS-level
lock per device, so co-located executors never share a card. This module is
both: ``python -m spark_rapids_tpu_torch.discovery`` prints the discovery
line for the visible CUDA devices (``torch.cuda.device_count()``), and
``acquire_exclusive()`` flock-claims one of them for the calling process
(released on process exit).

Without a GPU the script raises, as every entry point of the port does,
unless it is run with ``--device cpu``, which lists one virtual address (the
tests' mode).
"""
from __future__ import annotations

import argparse
import fcntl
import json
import os
import tempfile
from dataclasses import dataclass
from typing import List, Optional


def visible_devices(device: str = "cuda") -> List[str]:
    """Addresses of the visible CUDA devices (their ordinals as strings);
    ``device="cpu"`` gives the one virtual address ``0``."""
    if device == "cpu":
        return ["0"]
    if device != "cuda":
        raise ValueError(f"unknown device kind {device!r}")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: GPU discovery needs "
                           "a GPU (pass --device cpu for a virtual address)")
    return [str(i) for i in range(torch.cuda.device_count())]


def _lock_dir() -> str:
    d = os.path.join(tempfile.gettempdir(), "spark-rapids-gpu-locks")
    os.makedirs(d, exist_ok=True)
    return d


@dataclass
class DeviceClaim:
    address: str
    _fh: object

    def release(self) -> None:
        try:
            fcntl.flock(self._fh, fcntl.LOCK_UN)
        finally:
            self._fh.close()


def acquire_exclusive(addresses: Optional[List[str]] = None,
                      lock_dir: Optional[str] = None
                      ) -> Optional[DeviceClaim]:
    """Claim one unused device by a per-device exclusive flock on
    ``gpu-<address>.lock`` (the reference plugin's exclusive-mode selection
    loop). None when every device is claimed. A lock file that cannot even
    be opened (another user's claim on a shared host) counts as claimed;
    the holder's PID is written only once the lock is held (append mode
    never truncates a holder's record)."""
    d = lock_dir or _lock_dir()
    for addr in addresses if addresses is not None else visible_devices():
        try:
            fh = open(os.path.join(d, f"gpu-{addr}.lock"), "a")
        except OSError:
            continue    # an unopenable lock is someone else's device
        try:
            fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            fh.close()
            continue
        fh.truncate(0)
        fh.write(str(os.getpid()))
        fh.flush()
        return DeviceClaim(addr, fh)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    """Spark's resource-discovery script protocol: one JSON line."""
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.discovery",
        description="Print Spark's resource-discovery line for the GPUs.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the visible CUDA devices; cpu: "
                         "one virtual address")
    args = ap.parse_args(argv)
    print(json.dumps({"name": "gpu",
                      "addresses": visible_devices(args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
