"""Typed configuration: the keys this port reads, under the same
``spark.rapids.tpu.*`` names as the JAX package, so one conf dict drives
both engines.

Keys the port does not declare are kept as raw values and ignored, as Spark
ignores unknown keys; a declared key is converted and checked when the
``TpuConf`` is built, and a bad value raises ``ValueError`` naming the key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_PREFIX = "spark.rapids.tpu"


@dataclass(frozen=True)
class ConfEntry:
    key: str
    conf_type: type
    default: Any
    doc: str
    checker: Optional[Callable[[Any], Optional[str]]] = None

    def convert(self, raw: Any) -> Any:
        if self.conf_type is bool:
            if isinstance(raw, bool):
                return raw
            return str(raw).strip().lower() in ("true", "1", "yes", "on")
        if self.conf_type is int:
            return int(str(raw), 0) if isinstance(raw, str) else int(raw)
        if self.conf_type is float:
            return float(raw)
        return str(raw)


_REGISTRY: Dict[str, ConfEntry] = {}


def _conf(key: str, conf_type: type, default: Any, doc: str,
          checker: Optional[Callable[[Any], Optional[str]]] = None
          ) -> ConfEntry:
    entry = ConfEntry(f"{_PREFIX}.{key}", conf_type, default, doc, checker)
    _REGISTRY[entry.key] = entry
    return entry


STRING_MAX_BYTES = _conf(
    "sql.string.maxBytes", int, 256,
    "Fixed per-row byte width cap of device string columns (a [rows, width] "
    "uint8 matrix plus a length vector).",
    checker=lambda v: None if v > 0 else f"string.maxBytes must be > 0, got {v}")

ENABLE_FLOAT_AGG = _conf(
    "sql.variableFloatAgg.enabled", bool, False,
    "Allow float/double aggregations whose result can vary with evaluation "
    "order. The port has no CPU engine to fall back to, so a plan that needs "
    "one while this is off is refused.")

INCOMPATIBLE_OPS = _conf(
    "sql.incompatibleOps.enabled", bool, False,
    "Enable operators whose results differ slightly from Spark's CPU "
    "semantics. No operator of the port is gated by it yet; it is declared so "
    "that the JAX package's conf dicts validate unchanged.")

SHUFFLE_KERNEL_MODE = _conf(
    "shuffle.kernel.mode", str, "auto",
    "Map-side partition reorder strategy: 'auto' runs the partition-reorder "
    "kernel (CUDA on a GPU, its plain PyTorch version on the CPU); 'off' "
    "always uses the sort path. 'interpret' (the JAX package's Pallas "
    "interpreter mode) means 'auto' here: the tensor's device already picks "
    "the plain version on the CPU. A batch whose quota overflows falls back "
    "to the sort path.",
    checker=lambda v: (None if v in ("auto", "interpret", "off")
                       else f"shuffle.kernel.mode must be auto | interpret"
                            f" | off, got {v!r}"))

SHUFFLE_DMA_CONSOLIDATE = _conf(
    "shuffle.kernel.dmaConsolidate.enabled", bool, False,
    "Consolidate the partition-reorder kernel's quota-padded pieces with one "
    "compaction launch for all partitions (the CUDA kernel "
    "csrc/dma_compact.cu on a GPU, its plain PyTorch version on the CPU) "
    "instead of one row gather per partition. Both give the same rows in "
    "the same order. Off by default, as in the JAX package.")

BROADCAST_JOIN_THRESHOLD = _conf(
    "sql.broadcastJoinThreshold.bytes", int, 10 * 1024 * 1024,
    "Largest estimated build side, in bytes, for which a join takes the "
    "broadcast hash join (the spark.sql.autoBroadcastJoinThreshold role). A "
    "side of unknown size is never broadcast; -1 turns broadcasts off.")

DEVICE_POOL_FRACTION = _conf(
    "memory.tpu.allocFraction", float, 0.9,
    "Fraction of the device's memory that the spillable buffer store may "
    "hold (on a GPU, of torch.cuda.mem_get_info's total).",
    checker=lambda v: (None if 0.0 < v <= 1.0
                       else f"allocFraction must be in (0, 1], got {v}"))

DEVICE_POOL_BYTES = _conf(
    "memory.tpu.poolSizeBytes", int, 0,
    "Explicit device store budget in bytes; 0 derives it from allocFraction "
    "and the device's memory.")

HOST_SPILL_STORAGE_SIZE = _conf(
    "memory.host.spillStorageSize", int, 1 << 30,
    "Bytes of host memory that hold batches spilled from the device; what "
    "does not fit spills on to disk.",
    checker=lambda v: (None if v > 0
                       else f"spillStorageSize must be > 0, got {v}"))


class TpuConf:
    """Immutable snapshot of configuration overrides."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        for key, raw in (overrides or {}).items():
            entry = _REGISTRY.get(key)
            if entry is None:
                self._values[key] = raw
                continue
            val = entry.convert(raw)
            if entry.checker is not None:
                err = entry.checker(val)
                if err:
                    raise ValueError(f"{key}: {err}")
            self._values[key] = val

    def get(self, entry: ConfEntry) -> Any:
        return self._values.get(entry.key, entry.default)

    @property
    def string_max_bytes(self) -> int:
        return self.get(STRING_MAX_BYTES)
