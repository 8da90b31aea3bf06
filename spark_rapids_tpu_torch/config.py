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


def _positive(name: str) -> Callable[[Any], Optional[str]]:
    def check(v: Any) -> Optional[str]:
        return None if v > 0 else f"{name} must be > 0, got {v}"
    return check


def _non_negative(name: str) -> Callable[[Any], Optional[str]]:
    def check(v: Any) -> Optional[str]:
        return None if v >= 0 else f"{name} must be >= 0, got {v}"
    return check


def _fraction(name: str) -> Callable[[Any], Optional[str]]:
    def check(v: Any) -> Optional[str]:
        return None if 0.0 < v <= 1.0 else f"{name} must be in (0, 1], got {v}"
    return check


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

SQL_ENABLED = _conf(
    "sql.enabled", bool, True,
    "Enable (true) or disable (false) device acceleration of SQL plans. When "
    "disabled every operator runs on the CPU engine (the JAX package's key "
    "and default; spark.rapids.sql.enabled).")

EXPLAIN = _conf(
    "sql.explain", str, "NONE",
    "Explain why parts of a query were or were not placed on the device. "
    "Values: NONE, NOT_ON_TPU (print only the fallback reasons), ALL "
    "(spark.rapids.sql.explain).")

INCOMPATIBLE_OPS = _conf(
    "sql.incompatibleOps.enabled", bool, False,
    "Run on the device the operators whose results differ slightly from "
    "Spark's CPU semantics (rand's stream, byte-level regular expressions "
    "and general LIKE patterns, ASCII-only case mapping); off, they run on "
    "the CPU engine.")

HAS_NANS = _conf(
    "sql.hasNans", bool, True,
    "Assume floating point columns may contain NaN: aggregates grouping on "
    "and joins keyed on float columns then run on the CPU engine "
    "(spark.rapids.sql.hasNans).")

ENABLE_FLOAT_AGG = _conf(
    "sql.variableFloatAgg.enabled", bool, False,
    "Allow float/double aggregations whose result can vary with evaluation "
    "order on the device; off, they run on the CPU engine "
    "(spark.rapids.sql.variableFloatAgg.enabled).")

CACHED_SCAN_ENABLED = _conf(
    "sql.cachedScan.enabled", bool, True,
    "Scan df.cache() data on the device; off, the CPU engine reads the "
    "cached batches.")

UDF_COMPILER_ENABLED = _conf(
    "sql.udfCompiler.enabled", bool, False,
    "Compile Python row UDFs into columnar expression trees so they run on "
    "the device; off, a UDF runs row at a time on the CPU engine "
    "(spark.rapids.sql.udfCompiler.enabled).")

MESH_ENABLED = _conf(
    "sql.mesh.enabled", bool, False,
    "Run device subtrees over a mesh of shards (plan/mesh_rewrite.py): one "
    "logical batch whose shard i lives on shard device i, with every "
    "exchange between shards done device to device (the JAX package's "
    "jax.sharding.Mesh execution). With sql.adaptive.enabled a mesh "
    "shuffled join switches to broadcast when a side materializes under "
    "broadcastJoinThreshold; a mesh aggregation picks its merge from the "
    "observed partial-group counts (sql.mesh.aggRepartitionThreshold).")

MESH_NUM_DEVICES = _conf(
    "sql.mesh.numDevices", int, 0,
    "Shards of the mesh; 0 uses every visible device. More shards than "
    "devices place shard i on device i mod k (several shards share a "
    "device, as XLA's forced host device count lets the JAX package's "
    "CPU mesh do).")

MESH_SCAN_ASSIGNMENT = _conf(
    "sql.mesh.scan.shardAssignment", str, "rowgroup",
    "How mesh file scans split work across shards: 'rowgroup' balances "
    "statistics-clipped parquet row groups over the shards at plan time "
    "(exact footer row counts, greedy LPT) and each shard reads its own; "
    "'file' assigns whole files at run time (formats without row-group "
    "metadata always do).",
    checker=lambda v: (None if v in ("rowgroup", "file")
                       else f"sql.mesh.scan.shardAssignment must be "
                            f"rowgroup | file, got {v!r}"))

MESH_REQUIRE_ICI = _conf(
    "sql.mesh.requireIci", bool, True,
    "Clip the mesh to the largest group of devices that all reach each "
    "other as peers (torch.cuda.can_device_access_peer), so no exchange "
    "between shards goes through host memory; a repeated device and the "
    "CPU count as one group.")

MESH_AGG_REPARTITION_THRESHOLD = _conf(
    "sql.mesh.aggRepartitionThreshold", int, 8192,
    "Mesh aggregations whose total partial-group count exceeds this "
    "hash-repartition the partial buffers by key (each shard merges its "
    "own keys) instead of gathering every partial and merging once.")

ADAPTIVE_ENABLED = _conf(
    "sql.adaptive.enabled", bool, False,
    "Adaptive query execution (plan/adaptive.py): run the shuffle map "
    "stages first, then re-plan with the observed statistics: coalesce "
    "small reduce partitions into custom shuffle readers, switch shuffled "
    "hash joins to broadcast when the built side turned out small, split "
    "skewed join partitions (spark.sql.adaptive.enabled).")

ADAPTIVE_ADVISORY_PARTITION_BYTES = _conf(
    "sql.adaptive.advisoryPartitionSizeInBytes", int, 64 * 1024 * 1024,
    "Target post-shuffle partition size for adaptive coalescing "
    "(spark.sql.adaptive.advisoryPartitionSizeInBytes).",
    checker=_positive("advisoryPartitionSizeInBytes"))

ADAPTIVE_SKEW_SPLIT_ENABLED = _conf(
    "sql.adaptive.skewSplit.enabled", bool, True,
    "Skew-split readers under adaptive execution "
    "(spark.sql.adaptive.skewJoin.enabled): a reduce partition observed "
    "larger than skewedPartitionFactor x the median splits into map-id "
    "slices; the shuffled hash join above reads the other side's whole "
    "partition once per slice. A hash aggregate over a skewed exchange "
    "re-partitions by group key instead (the out-of-core grace path).")

ADAPTIVE_SKEW_FACTOR = _conf(
    "sql.adaptive.skewedPartitionFactor", float, 5.0,
    "A reduce partition is skewed when its observed size exceeds this "
    "factor times the median partition size of its shuffle "
    "(spark.sql.adaptive.skewJoin.skewedPartitionFactor).",
    checker=_positive("skewedPartitionFactor"))

ADAPTIVE_SKEW_THRESHOLD_BYTES = _conf(
    "sql.adaptive.skewedPartitionThreshold.bytes", int, 64 * 1024 * 1024,
    "Minimum observed partition size for skew handling: smaller partitions "
    "are never split however lopsided the shuffle "
    "(spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes).",
    checker=_positive("skewedPartitionThreshold.bytes"))

ADAPTIVE_REFUSION_ENABLED = _conf(
    "sql.adaptive.refusion.enabled", bool, True,
    "Re-run the whole-stage fusion pass over the adaptively rewritten plan, "
    "so chains the rewrite created (the coalesce above a coalesced shuffle "
    "reader under a lone project or filter) fuse too.")

ADAPTIVE_COST_MODEL_ENABLED = _conf(
    "sql.adaptive.costModel.enabled", bool, False,
    "Cost-based CPU-vs-device placement: at plan time, operators whose "
    "estimated row count is under costModel.minDeviceRows stay on the CPU "
    "engine; under adaptive execution, a shuffled hash join whose observed "
    "input rows are under it moves to the CPU engine.")

ADAPTIVE_COST_MODEL_MIN_DEVICE_ROWS = _conf(
    "sql.adaptive.costModel.minDeviceRows", int, 4096,
    "Row-count threshold of the cost model: operators with fewer estimated "
    "rows run on the CPU engine when sql.adaptive.costModel.enabled is on.",
    checker=_positive("costModel.minDeviceRows"))

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

REPLACE_SORT_MERGE_JOIN = _conf(
    "sql.replaceSortMergeJoin.enabled", bool, True,
    "Replace a sort-merge join (from an imported Catalyst plan) with the "
    "device shuffled hash join, dropping its join-key sorts "
    "(spark.rapids.sql.replaceSortMergeJoin.enabled).")

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


OOC_ENABLED = _conf(
    "memory.outOfCore.enabled", bool, True,
    "Out-of-core execution for the hash aggregate, the shuffled and "
    "broadcast hash joins and the sort (memory/grace.py): when an "
    "operator's working set will not fit the device budget (the planner's "
    "footprint estimate up front, or pressure while it stages its input), "
    "the input is hash- or range-partitioned by key into spillable "
    "partitions across the device -> host -> disk tiers and the operator "
    "runs once per partition. With ample budget the single pass runs "
    "unchanged.")

OOC_HEADROOM = _conf(
    "memory.outOfCore.headroomFraction", float, 0.8,
    "Fraction of the free device budget an operator's estimated working "
    "set may occupy before the out-of-core path engages; the rest is "
    "headroom for the operator's own intermediates.",
    checker=_fraction("headroomFraction"))

OOC_FANOUT = _conf(
    "memory.outOfCore.fanout", int, 8,
    "Grace partitions per recursion level when pressure triggers "
    "partitioning without a plan-time estimate or observed statistics; "
    "each level re-partitions with a depth-salted hash.",
    checker=_positive("outOfCore.fanout"))

OOC_MAX_PARTITIONS = _conf(
    "memory.outOfCore.maxPartitions", int, 256,
    "Upper bound on the grace partitions one operator makes per recursion "
    "level.", checker=_positive("outOfCore.maxPartitions"))

OOC_MAX_DEPTH = _conf(
    "memory.outOfCore.maxRecursionDepth", int, 4,
    "Bound on grace recursion depth; a partition still over budget at the "
    "deepest level (one giant key group) runs in a single pass there.",
    checker=_positive("outOfCore.maxRecursionDepth"))

OOC_FORCE_PARTITIONS = _conf(
    "memory.outOfCore.forcePartitions", int, 0,
    "Force every out-of-core-capable operator to grace-partition its input "
    "into this many partitions whatever the budget (0 disables): the "
    "degraded path's test knob.",
    checker=_non_negative("outOfCore.forcePartitions"))

MEMORY_FAULTS_PLAN = _conf(
    "memory.faults.plan", str, "",
    "Deterministic device-memory fault plan (empty: no faults), "
    "semicolon-separated specs such as "
    "'alloc_fail:op=agg,after=1;budget_clamp:fraction=0.25' "
    "(memory/faults.py): alloc_fail fails the Nth working-set admission "
    "check of a matching operator, budget_clamp shrinks the budget it "
    "sees. Keys: op (agg | join | sort | *), after, count, fraction.")

MEMORY_FAULTS_SEED = _conf(
    "memory.faults.seed", int, 0,
    "Identity of the memory fault schedule: (plan, seed) keys one "
    "process-wide set of event counters; a new seed starts a fresh run.")


SCAN_CACHE_ENABLED = _conf(
    "sql.scanCache.enabled", bool, True,
    "Keep device copies of scanned in-memory tables across actions, so "
    "repeated queries over the same DataFrame skip the host-to-device upload "
    "(memory/scan_cache.py). Cached bytes count against the device store's "
    "budget and are evicted before any buffer spills.")

SCAN_CACHE_BYTES = _conf(
    "sql.scanCache.maxBytes", int, 2 << 30,
    "Upper bound on device bytes held by the scan cache; least-recently-used "
    "tables are evicted past it.")

FUSION_ENABLED = _conf(
    "sql.fusion.enabled", bool, True,
    "Whole-stage fusion (plan/fusion.py): collapse maximal chains of Project, "
    "Filter and Expand, and the partial-aggregate fold, into "
    "one FusedStageExec or FusedAggregateStageExec. A filter becomes a mask "
    "over the downstream expressions with one compaction at the stage's "
    "end. Fused stages render with a '*(id)' prefix in the plan tree. With "
    "fusion off the filter-into-aggregate fold still runs.")

FUSION_MAX_OPS = _conf(
    "sql.fusion.maxOps", int, 16,
    "Upper bound on operators collapsed into one fused stage, and on the "
    "variants an Expand may multiply a stage into.",
    checker=_positive("fusion.maxOps"))

TRANSFER_CHUNK_ROWS = _conf(
    "transfer.chunkRows", int, 1 << 20,
    "Host-to-device uploads larger than this many rows go in row chunks, "
    "each staged in pinned host memory while the chunks before it are in "
    "flight, into one preallocated device tensor per buffer. 0 uploads every "
    "table in a single shot.",
    checker=_non_negative("transfer.chunkRows"))

TRANSFER_MAX_INFLIGHT = _conf(
    "transfer.maxInflight", int, 2,
    "Bound on in-flight transfers: at most this many upload chunks (and, "
    "with streaming collect, per-batch downloads) are outstanding before the "
    "pipeline waits on the oldest.",
    checker=_positive("transfer.maxInflight"))

TRANSFER_PIPELINE_ENABLED = _conf(
    "transfer.pipeline.enabled", bool, True,
    "Planner-inserted bounded-async dispatch between the upload and the "
    "device stage over it: a PipelinedExec keeps up to "
    "transfer.pipeline.depth batches in flight on a producer thread that "
    "shares the consuming task's semaphore hold. Skipped on single-core "
    "hosts.")

TRANSFER_PIPELINE_DEPTH = _conf(
    "transfer.pipeline.depth", int, 2,
    "How many batches a PipelinedExec keeps in flight between the producing "
    "upload and the consuming stage.",
    checker=_positive("transfer.pipeline.depth"))

TRANSFER_STREAMING_COLLECT = _conf(
    "transfer.streamingCollect.enabled", bool, True,
    "collect() starts each result batch's device-to-host copy (non_blocking, "
    "into pinned host buffers, with a CUDA event) as soon as the batch is "
    "produced and resolves the copies in order, at most "
    "transfer.maxInflight outstanding, instead of one synchronous download "
    "per batch.")

CONCURRENT_TPU_TASKS = _conf(
    "sql.concurrentTpuTasks", int, 2,
    "Number of tasks that may hold the device at once; the device-admission "
    "semaphore (memory/semaphore.py) blocks the rest "
    "(spark.rapids.sql.concurrentGpuTasks).",
    checker=_positive("concurrentTpuTasks"))


# ------------------------------------------------------------- file scans
PARQUET_ENABLED = _conf(
    "sql.format.parquet.enabled", bool, True,
    "Parquet on the device as a whole. With this (or "
    "sql.format.parquet.read.enabled) off, parquet scans run on the CPU "
    "engine.")

PARQUET_READ_ENABLED = _conf(
    "sql.format.parquet.read.enabled", bool, True,
    "Parquet scans on the device (see sql.format.parquet.enabled).")

PARQUET_WRITE_ENABLED = _conf(
    "sql.format.parquet.write.enabled", bool, True,
    "Parquet writes from the device (see sql.format.parquet.enabled); off, "
    "the write command runs on the CPU engine.")

ORC_ENABLED = _conf(
    "sql.format.orc.enabled", bool, True,
    "Enable TPU ORC scan/write as a whole.")

ORC_READ_ENABLED = _conf(
    "sql.format.orc.read.enabled", bool, True, "Enable TPU ORC scans.")

ORC_WRITE_ENABLED = _conf(
    "sql.format.orc.write.enabled", bool, True, "Enable TPU ORC writes.")

CSV_ENABLED = _conf(
    "sql.format.csv.enabled", bool, True,
    "Enable TPU CSV scanning as a whole.")

CSV_READ_ENABLED = _conf(
    "sql.format.csv.read.enabled", bool, True, "Enable TPU CSV scans.")

MAX_READER_BATCH_SIZE_ROWS = _conf(
    "sql.reader.batchSizeRows", int, 2147483647,
    "Soft cap on rows per batch produced by scans "
    "(spark.rapids.sql.reader.batchSizeRows).",
    checker=_positive("batchSizeRows"))

MAX_READER_BATCH_SIZE_BYTES = _conf(
    "sql.reader.batchSizeBytes", int, 2147483647,
    "Soft cap on bytes per batch produced by scans, from the file's "
    "average row width (spark.rapids.sql.reader.batchSizeBytes).",
    checker=_positive("batchSizeBytes"))

PARQUET_DEVICE_DICT = _conf(
    "io.parquet.deviceDictDecode.enabled", bool, True,
    "Parquet scans read fixed-width columns straight from the page bytes "
    "in the file's own dictionary encoding (io/parquet_pages.py) and "
    "strings through pyarrow's dictionary read: narrow indices and the "
    "dictionary cross the host link and decode on the device with a "
    "gather. Off, every column decodes on the host.")

PARQUET_DEVICE_RLE = _conf(
    "io.parquet.deviceRleExpand.enabled", bool, True,
    "With deviceDictDecode: a null-free column chunk whose index stream is "
    "mostly RLE runs crosses the link as (run ends, run values) and "
    "expands on the device with a searchsorted gather.")

ENCODED_DOMAIN = _conf(
    "sql.encodedDomain.enabled", bool, True,
    "Filters, group-by keys and equi-join keys run on dictionary indices "
    "where a column kept its encoding (DeviceColumn.encoding): a "
    "single-column predicate evaluates over the k dictionary values and "
    "gathers per row, grouping keys are the int32 indices and decode only "
    "for the surviving groups, and joins match on (remapped) indices.")

EXCHANGE_KEEP_ENCODINGS = _conf(
    "sql.exchange.keepEncodings", bool, True,
    "Hash and round-robin exchanges carry token-carrying dictionary "
    "columns as int32 indices through a sort-path split and re-attach the "
    "dictionary to every piece, so the encoded domain works after the "
    "exchange. Where the partition-reorder kernel would launch, the "
    "encoded split is taken only when the indices save at least a quarter "
    "of the batch's per-row bytes.")

SCAN_PREFETCH_BATCHES = _conf(
    "io.scan.prefetchBatches", int, 2,
    "Device parquet scans decode and upload this many batches ahead of the "
    "consumer on a producer thread; 0 reads serially (as does a one-core "
    "host).")


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

    def is_rule_enabled(self, conf_key: str) -> bool:
        """A per-rule switch (``spark.rapids.tpu.sql.exec.<Name>`` or
        ``...sql.expression.<Name>``): undeclared keys, kept raw."""
        raw = self._values.get(conf_key)
        if raw is None:
            return True
        return str(raw).strip().lower() in ("true", "1", "yes", "on")

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def explain(self) -> str:
        return str(self.get(EXPLAIN)).upper()

    @property
    def string_max_bytes(self) -> int:
        return self.get(STRING_MAX_BYTES)
