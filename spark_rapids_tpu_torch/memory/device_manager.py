"""The process's device memory manager: one per process, holding the spill
store chain (DEVICE -> HOST -> DISK), its catalog and the device-admission
semaphore (``sql.concurrentTpuTasks`` permits, memory/semaphore.py).

The device budget is ``memory.tpu.poolSizeBytes`` when set, else
``memory.tpu.allocFraction`` of the device's memory (``torch.cuda.
mem_get_info``'s total on a GPU; 16 GiB on the CPU, the JAX package's
default when the backend reports no memory). The host budget is
``memory.host.spillStorageSize``. The session's device is part of the
manager's key: stores that hold tensors on one device are never handed to a
session on another. The permit count is part of the key too.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.store import BufferCatalog, build_store_chain

_DEFAULT_DEVICE_BYTES = 16 << 30

_log = logging.getLogger(__name__)


def _device_memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return _DEFAULT_DEVICE_BYTES


def _manager_key(conf: TpuConf, device: torch.device) -> tuple:
    return (conf.get(cfg.DEVICE_POOL_BYTES), conf.get(cfg.DEVICE_POOL_FRACTION),
            conf.get(cfg.HOST_SPILL_STORAGE_SIZE),
            conf.get(cfg.CONCURRENT_TPU_TASKS), device)


class DeviceManager:
    _instance: Optional["DeviceManager"] = None
    #: re-entrant: a dropped session's finalizer (memory/df_cache.py) peeks
    #: the manager, and the garbage collector may run it on a thread that
    #: holds this lock while it builds a manager; a plain lock waited on
    #: itself there forever (the JAX package's still does)
    _lock = threading.RLock()

    def __init__(self, conf: TpuConf, device: torch.device):
        self.conf = conf
        self.device = device
        self.key = _manager_key(conf, device)
        self.catalog = BufferCatalog()
        self.device_budget = (conf.get(cfg.DEVICE_POOL_BYTES) or int(
            _device_memory_bytes(device) * conf.get(cfg.DEVICE_POOL_FRACTION)))
        self.device_store, self.host_store, self.disk_store = \
            build_store_chain(self.catalog, self.device_budget,
                              conf.get(cfg.HOST_SPILL_STORAGE_SIZE))
        self.semaphore = TpuSemaphore(conf.get(cfg.CONCURRENT_TPU_TASKS))
        #: the exchanges' shuffle catalog over these stores, made at the
        #: first exchange (execs/exchange_execs.py _local_shuffle_env)
        self.shuffle_env = None

    def spilled_bytes(self) -> dict:
        """Bytes spilled since the manager was made, by the tier they
        landed on: {"host": ..., "disk": ...}."""
        from spark_rapids_tpu_torch.memory.buffer import StorageTier
        stores = (self.device_store, self.host_store, self.disk_store)
        return {name: sum(s.spilled_to[t] for s in stores)
                for name, t in (("host", StorageTier.HOST),
                                ("disk", StorageTier.DISK))}

    @property
    def is_idle(self) -> bool:
        return not (len(self.device_store) or len(self.host_store)
                    or len(self.disk_store)
                    or self.semaphore.active_holders)

    def _close(self) -> None:
        self.device_store.close()
        self.host_store.close()
        self.disk_store.close()

    @classmethod
    def initialize(cls, conf: TpuConf,
                   device: torch.device) -> "DeviceManager":
        """The process's manager for ``conf`` and ``device``. Other memory
        settings rebuild it when it is idle; while it holds buffers the
        existing settings win, unless the device differs, which raises."""
        device = torch.device(device)
        with cls._lock:
            inst = cls._instance
            if inst is None or inst.key == _manager_key(conf, device):
                if inst is None:
                    cls._instance = DeviceManager(conf, device)
                return cls._instance
            if inst.is_idle:
                inst._close()
                cls._instance = DeviceManager(conf, device)
            elif inst.device != device:
                raise RuntimeError(
                    f"the device manager holds buffers on {inst.device}; it "
                    f"cannot serve a session on {device} until they are "
                    f"released")
            else:
                _log.warning("DeviceManager busy; ignoring new memory "
                             "settings %s", _manager_key(conf, device))
            return cls._instance

    @classmethod
    def peek(cls) -> Optional["DeviceManager"]:
        """The current manager, without making one."""
        with cls._lock:
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst._close()
