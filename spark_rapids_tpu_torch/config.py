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

METRICS_ENABLED = _conf(
    "metrics.enabled", bool, True,
    "Publish an action's counters as ``session.last_metrics`` (and on a "
    "served query's handle): each exec's output rows and batches, then the "
    "action's transfer, memory, serving, shuffle and adaptive sections; on "
    "the cluster path its lineage-recompute counters only. The analog of "
    "SQLMetrics.")


# ------------------------------------------------------------- the cluster
CLUSTER_EXECUTORS = _conf(
    "sql.cluster.numExecutors", int, 0,
    "Multi-executor execution: plans split into shuffle stages at their "
    "exchanges and tasks run across this many executors, each with its "
    "own shuffle environment (stores, catalogs, transport server). Map "
    "tasks write through the caching shuffle writer; reducers read local "
    "blocks from their catalog and fetch remote ones through the "
    "transport (parallel/cluster.py). 0: the single-process engine. Off "
    "under sql.mesh.enabled.")

CLUSTER_PROCESS_EXECUTORS = _conf(
    "sql.cluster.processExecutors", bool, False,
    "Run each cluster executor as an OS process of its own (a daemon per "
    "executor, tasks over a control socket, shuffle data over the TCP "
    "transport) on the session's device. A registry directory is made "
    "when none is configured.")

CLUSTER_TASK_SLOTS = _conf(
    "sql.cluster.taskSlots", int, 4,
    "Concurrent tasks per cluster executor: a stage runs one task per "
    "partition, each executor up to this many at once; device entry "
    "inside an executor is still gated by sql.concurrentTpuTasks.",
    checker=_positive("cluster.taskSlots"))


# ------------------------------------------------------------- the network shuffle
SHUFFLE_FETCH_TIMEOUT = _conf(
    "shuffle.fetch.timeoutSeconds", int, 300,
    "How long a reduce-side reader waits for remote shuffle blocks (one "
    "budget across its whole drain) before it raises "
    "ShuffleFetchFailedError, the stage-recompute signal.")

SHUFFLE_TRANSPORT_CLASS = _conf(
    "shuffle.transport.class", str,
    "spark_rapids_tpu_torch.shuffle.inprocess.InProcessTransport",
    "Fully qualified class of the shuffle transport for peer-to-peer "
    "fetches: InProcessTransport serves executors within one process, "
    "spark_rapids_tpu_torch.shuffle.tcp_port.TcpTransport executors in "
    "processes of their own (tcp.TcpTransport is the reference's text, "
    "whose kill leaves a socket open and whose server send can beat the "
    "peer's hello), FaultInjectingTransport wraps any "
    "(spark.rapids.shuffle.transport.class).")

SHUFFLE_TCP_PORT = _conf(
    "shuffle.tcp.listenPort", int, 0,
    "Listen port of the TCP shuffle transport; 0 picks an ephemeral port, "
    "published through the registry directory.")

SHUFFLE_TCP_REGISTRY = _conf(
    "shuffle.tcp.registryDir", str, "",
    "Directory where TCP-transport executors publish their host:port for "
    "peer discovery.")

SHUFFLE_TCP_WORKER_THREADS = _conf(
    "shuffle.tcp.workerThreads", int, 2,
    "Request-handler worker threads per TCP transport.",
    checker=_positive("shuffle.tcp.workerThreads"))

SHUFFLE_MAX_INFLIGHT_BYTES = _conf(
    "shuffle.maxReceiveInflightBytes", int, 1 << 30,
    "Per-client cap on bytes of shuffle data in flight "
    "(spark.rapids.shuffle.ucx.maxReceiveInflightBytes).")

SHUFFLE_BOUNCE_BUFFER_SIZE = _conf(
    "shuffle.bounceBuffers.size", int, 4 << 20,
    "Size of each bounce buffer that stages shuffle sends and receives.")

SHUFFLE_BOUNCE_BUFFER_COUNT = _conf(
    "shuffle.bounceBuffers.count", int, 32,
    "Number of bounce buffers per direction.")

SHUFFLE_COMPRESSION_CODEC = _conf(
    "shuffle.compression.codec", str, "none",
    "Codec for shuffle batches: none, copy, lz4 (always available), zlib, "
    "zstd (needs the zstandard package). A peer that lacks the requested "
    "codec negotiates the transfer down to copy.")

SHUFFLE_ZLIB_LEVEL = _conf(
    "shuffle.compression.zlib.level", int, 1,
    "zlib compression level (0-9) under shuffle.compression.codec=zlib.",
    checker=lambda v: (None if 0 <= v <= 9
                       else f"zlib.level must be in [0, 9], got {v}"))

SHUFFLE_MAX_RETRIES = _conf(
    "shuffle.maxRetries", int, 3,
    "How many times a transient shuffle failure is retried before it "
    "becomes fatal, at every level: TCP connects, metadata and transfer "
    "requests, per-block transfers (checksum mismatches too) and the "
    "reader's per-peer re-fetches. 0: the first failure surfaces as "
    "ShuffleFetchFailedError.", checker=_non_negative("maxRetries"))

SHUFFLE_RETRY_BACKOFF_MS = _conf(
    "shuffle.retryBackoffMs", int, 50,
    "Base delay between shuffle retries: attempt i sleeps about "
    "base * 2^i with a jitter drawn from the retry key and "
    "shuffle.faults.seed.", checker=_positive("retryBackoffMs"))

SHUFFLE_CONNECT_TIMEOUT = _conf(
    "shuffle.connectTimeout", float, 30.0,
    "Seconds one TCP shuffle connect attempt (registry lookup and socket) "
    "may take before it counts as a transient failure.",
    checker=_positive("connectTimeout"))

SHUFFLE_CHECKSUM_ENABLED = _conf(
    "shuffle.checksum.enabled", bool, True,
    "Verify the crc32 of every fetched shuffle buffer against the one the "
    "server computed over the bytes on the wire; a mismatch is a "
    "retryable corruption.")

SHUFFLE_RECOMPUTE_MAX_STAGE_ATTEMPTS = _conf(
    "shuffle.recompute.maxStageAttempts", int, 2,
    "How many lineage recompute rounds one stage may run after its reduce "
    "side exhausts the per-peer fetch retries; each round re-runs only "
    "the lost map tasks on surviving executors. 0: every fetch failure "
    "surfaces.", checker=_non_negative("maxStageAttempts"))

SHUFFLE_FAULTS_PLAN = _conf(
    "shuffle.faults.plan", str, "",
    "Deterministic fault-injection plan for the shuffle stack (empty: no "
    "faults), e.g. 'drop_conn:peer=exec-1,after=3;corrupt_frame:after=1'. "
    "Kinds: drop_conn, corrupt_frame, delay_frame, dup_frame, "
    "fail_request, kill_peer. Only FaultInjectingTransport "
    "(shuffle/faults.py) reads it.")

SHUFFLE_FAULTS_SEED = _conf(
    "shuffle.faults.seed", int, 0,
    "Seed of the fault plan's random choices and of the retry jitter: the "
    "same seed replays the same schedule.")

SHUFFLE_FAULTS_TRANSPORT = _conf(
    "shuffle.faults.transport.class", str,
    "spark_rapids_tpu_torch.shuffle.inprocess.InProcessTransport",
    "Transport that FaultInjectingTransport wraps.")

SERVING_SHAPE_BUCKETS = _conf(
    "serving.shapeBuckets", bool, True,
    "Bucket row-count estimates to powers of two in plan keys "
    "(serving/program_cache.py ``plan_key``), so one plan shape keeps one "
    "key whatever its exact row counts.")

SERVING_MAX_CONCURRENT = _conf(
    "serving.maxConcurrentQueries", int, 4,
    "How many submitted queries the session scheduler runs concurrently "
    "(the shared worker-pool size). Queries past the bound wait in their "
    "tenant's FIFO queue under fair-share admission; device admission "
    "within a running query is still gated by sql.concurrentTpuTasks.",
    checker=_positive("serving.maxConcurrentQueries"))

SERVING_TENANT_WEIGHTS = _conf(
    "serving.tenantWeights", str, "",
    "Per-tenant fair-share weights as 'tenant:weight,...' (e.g. "
    "'etl:3,adhoc:1'). Admission picks the queued tenant with the lowest "
    "served/weight deficit (FIFO within a tenant); unlisted tenants weigh "
    "1. The same weights drive the device-admission semaphore so a heavy "
    "tenant cannot starve the rest at either layer.")

SERVING_QUERY_TIMEOUT = _conf(
    "serving.queryTimeoutSeconds", float, 0.0,
    "Default per-query deadline for submitted queries, enforced "
    "cooperatively at exec boundaries and in the pipeline producer; a "
    "query past its deadline fails with QueryTimeoutError and releases "
    "its device-semaphore hold and catalog buffers. 0 disables; "
    "session.submit(timeout=...) overrides per query.",
    checker=_non_negative("serving.queryTimeoutSeconds"))

SERVING_CACHE_DIR = _conf(
    "serving.cache.dir", str, "",
    "Directory of the serving program-cache's on-disk key index: a "
    "restarted server counts a program an earlier process built there "
    "(a kernel library already in the build directory) as a disk hit "
    "instead of a cold build. Empty uses the kernel build directory "
    "(cuda_build.BUILD_DIR); 'off' disables the index.")

SERVING_CACHE_MAX_PROGRAMS = _conf(
    "serving.cache.maxPrograms", int, 4096,
    "Upper bound on compiled programs the in-memory cross-query cache "
    "retains; least-recently-used programs are dropped past it (their "
    "on-disk compilation-cache entries survive, so a re-miss recompiles "
    "warm).", checker=_positive("serving.cache.maxPrograms"))

# --------------------------------------------------------------------------------------
# Serving: network wire protocol, footprint admission, preemption
# --------------------------------------------------------------------------------------
SERVING_NET_PORT = _conf(
    "serving.net.listenPort", int, 0,
    "Listen port of the query service's wire transport (Arrow IPC over the "
    "TCP shuffle framing); 0 picks an ephemeral port, printed by the server "
    "process at startup.")

SERVING_NET_TRANSPORT = _conf(
    "serving.net.transportClass", str,
    "spark_rapids_tpu_torch.shuffle.tcp_port.TcpTransport",
    "Transport class the query service speaks over — the shuffle's "
    "framing/checksum/retry stack, NOT new plumbing. Any ShuffleTransport "
    "implementation works; tests swap in the in-process fabric.")

SERVING_NET_FAULTS_PLAN = _conf(
    "serving.net.faults.plan", str, "",
    "Deterministic wire-chaos plan for the query service (empty = none): "
    "the shuffle FaultPlan grammar (drop_conn / corrupt_frame / "
    "delay_frame / dup_frame / fail_request) injected by wrapping the "
    "serving transport in the FaultInjectingTransport — corrupted result "
    "frames must surface as retryable checksum failures, dropped "
    "connections as failed handles with a batches-delivered count.")

SERVING_NET_FAULTS_SEED = _conf(
    "serving.net.faults.seed", int, 0,
    "Seed for the serving wire-chaos plan's random choices; a fixed seed "
    "replays the same schedule (mirrors shuffle.faults.seed).")

SERVING_NET_POLL_MS = _conf(
    "serving.net.nextPollMs", int, 20,
    "How long a serve.next handler waits (bounded — the R010 discipline) "
    "for the query's next streamed batch before answering WAIT and "
    "releasing its transport worker thread; the client re-polls "
    "immediately, so this bounds handler occupancy, not stream latency.",
    checker=_positive("serving.net.nextPollMs"))

SERVING_NET_STREAM_DEPTH = _conf(
    "serving.net.streamQueueDepth", int, 4,
    "Bound on result batches buffered server-side per streaming query "
    "between the scheduler worker (producer) and the wire layer "
    "(consumer); a full queue backpressures the producer at its next "
    "batch boundary — bounded buffering, never an unbounded queue.",
    checker=_positive("serving.net.streamQueueDepth"))

SERVING_NET_MAX_STREAM_ROWS = _conf(
    "serving.net.maxStreamBatchRows", int, 1 << 20,
    "Result batches larger than this many rows are sliced into multiple "
    "wire frames before streaming, bounding per-frame memory on both ends "
    "(slices concatenate client-side to the bit-identical table). "
    "0 streams every exec batch whole.",
    checker=_non_negative("serving.net.maxStreamBatchRows"))

SERVING_NET_RPC_TIMEOUT = _conf(
    "serving.net.rpcTimeoutSeconds", float, 60.0,
    "Client-side bound on any single wire RPC (submit / next / fetch / "
    "cancel) and on each posted batch receive; an expired wait surfaces "
    "as a failed handle with its batches-delivered count, never a hang.",
    checker=_positive("serving.net.rpcTimeoutSeconds"))

SERVING_ADMIT_FOOTPRINT = _conf(
    "serving.admission.byFootprint.enabled", bool, True,
    "Admit RUNNING queries against the device budget using the plan's "
    "working_set_estimate (the footprint contract) instead of a "
    "bare query count: a query whose estimate does not fit the free "
    "budget waits (cancellable, visible in "
    "serving.admission_rejections_footprint) until running queries "
    "release their share. A query larger than the whole budget is "
    "admitted under a grace hint, charged the out-of-core HEADROOM "
    "share of the budget — the grace/spill layer completes it within "
    "that share, and the remaining fraction stays free so interactive "
    "queries still reach the device semaphore (where preemption can "
    "see them) alongside a whale.")

SERVING_PREEMPT_ENABLED = _conf(
    "serving.preemption.enabled", bool, False,
    "Batch-granularity preemption of RUNNING queries: when another "
    "tenant's query has starved on device admission past "
    "preemption.starvationMs, a preemptible running query yields its "
    "device-semaphore permit at its next exec-boundary checkpoint "
    "(check_cancelled sites), optionally parks spillable device state "
    "down the grace/spill tiers, and re-acquires under fair share — so a "
    "whale cannot starve interactive tenants between its batches.")

SERVING_PREEMPT_STARVATION_MS = _conf(
    "serving.preemption.starvationMs", int, 50,
    "How long another tenant's head-of-line device-admission waiter must "
    "have been blocked before a running preemptible query yields at its "
    "next batch boundary.",
    checker=_positive("serving.preemption.starvationMs"))

SERVING_PREEMPT_PARK = _conf(
    "serving.preemption.parkSpillable", bool, True,
    "On yield, shed the device store down to the out-of-core headroom "
    "watermark (memory.outOfCore.headroomFraction) — coldest-first, so "
    "the overage parked down the host/disk tiers is in practice the "
    "yielding whale's grace partitions, and the admitted tenant gets "
    "immediate HBM headroom; parked state re-admits on next access. "
    "Disabling leaves parking to the store's reactive pressure path.")

# --------------------------------------------------------------------------------------
# Serving: replica health, failover, routing (the fleet-resilience layer)
# --------------------------------------------------------------------------------------

SERVING_NET_REGISTRY = _conf(
    "serving.net.registryDir", str, "",
    "Registry directory for serving-replica discovery (the shuffle "
    "registry-dir rendezvous applied to the query service): each replica "
    "publishes <dir>/<executor_id> containing host:port and refreshes the "
    "file's mtime as a liveness heartbeat; clients scan the directory to "
    "discover replicas, skipping (and garbage-collecting) entries whose "
    "heartbeat is older than serving.health.livenessWindowSeconds. Empty "
    "disables discovery — clients then need explicit addresses.")

SERVING_HEALTH_HEARTBEAT = _conf(
    "serving.health.heartbeatSeconds", float, 1.0,
    "How often a serving replica refreshes its registry-file mtime (the "
    "liveness heartbeat). A SIGKILL'd replica stops heartbeating, so its "
    "entry ages out of the liveness window and clients stop routing to "
    "it even though the process never removed its file.",
    checker=_positive("serving.health.heartbeatSeconds"))

SERVING_HEALTH_LIVENESS_WINDOW = _conf(
    "serving.health.livenessWindowSeconds", float, 5.0,
    "Registry entries whose heartbeat mtime is older than this are "
    "considered dead: discovery scans skip them and remove the stale "
    "file (a crashed replica cannot retract its own entry). Keep this "
    "a few multiples of serving.health.heartbeatSeconds so a slow "
    "heartbeat is not mistaken for a death.",
    checker=_positive("serving.health.livenessWindowSeconds"))

SERVING_HEALTH_PROBE_INTERVAL = _conf(
    "serving.health.probeIntervalSeconds", float, 2.0,
    "How often the client re-probes each replica's serve.health RPC "
    "(liveness + the serve.stats snapshot load-aware routing scores). "
    "Probes run on the routing path when the last snapshot is older "
    "than this; 0 probes before every routing decision (tests).",
    checker=_non_negative("serving.health.probeIntervalSeconds"))

SERVING_HEALTH_PROBE_TIMEOUT = _conf(
    "serving.health.probeTimeoutSeconds", float, 5.0,
    "Bound on one serve.health probe RPC — probes must fail fast so a "
    "hung replica costs the router one bounded wait, not the full "
    "serving.net.rpcTimeoutSeconds.",
    checker=_positive("serving.health.probeTimeoutSeconds"))

SERVING_FAILOVER_ENABLED = _conf(
    "serving.failover.enabled", bool, True,
    "Resubmit a mid-stream query to a healthy replica when its replica "
    "dies (connection lost / RPC timeout / exhausted frame retries), "
    "resuming the result stream from the last delivered batch sequence "
    "number: the new replica re-runs the query and skips already-"
    "delivered frames (dedup by seq — exactly-once delivery to the "
    "caller). Only queries marked idempotent fail over (the default for "
    "pure SELECTs); non-idempotent queries surface WireQueryError with "
    "batches_delivered as before.")

SERVING_FAILOVER_MAX_ATTEMPTS = _conf(
    "serving.failover.maxAttempts", int, 3,
    "How many times one query may fail over to another replica before "
    "the client gives up and surfaces the failure.",
    checker=_positive("serving.failover.maxAttempts"))

SERVING_BREAKER_THRESHOLD = _conf(
    "serving.failover.breakerFailureThreshold", int, 3,
    "Consecutive probe/submit/stream failures against one replica that "
    "flip its client-side circuit breaker OPEN. An OPEN replica receives "
    "ZERO submissions; only health probes (on the exponential-backoff "
    "schedule) go there, and one probe success closes the breaker.",
    checker=_positive("serving.failover.breakerFailureThreshold"))

SERVING_BREAKER_BACKOFF_MS = _conf(
    "serving.failover.breakerBackoffMs", int, 200,
    "Base backoff between an OPEN breaker's health probes; successive "
    "failed probes back off exponentially with deterministic jitter "
    "(the shuffle/retry.py schedule, seeded by serving.net.faults.seed).",
    checker=_positive("serving.failover.breakerBackoffMs"))

SERVING_ROUTING_POLICY = _conf(
    "serving.routing.policy", str, "loadaware",
    "How the client picks a replica for a new submission: 'loadaware' "
    "scores each healthy replica's latest serve.health snapshot (free "
    "device budget after footprint charges, queue depth + running "
    "count, p99 wall over the stats window) and routes to the best — "
    "the whale lands on the replica with free budget; 'roundrobin' is "
    "a plain rotation. Replicas behind an OPEN breaker or DRAINING "
    "are excluded under either policy.",
    checker=lambda v: (None if v in ("loadaware", "roundrobin") else
                       f"serving.routing.policy must be 'loadaware' or "
                       f"'roundrobin', got {v!r}"))

# --------------------------------------------------------------------------------------
# Serving: elastic fleet (supervisor + autoscaler) and overload shedding
# --------------------------------------------------------------------------------------

SERVING_FLEET_MIN_REPLICAS = _conf(
    "serving.fleet.minReplicas", int, 1,
    "Lower bound on supervised replica slots: the autoscaler never "
    "scales the fleet below this many (DEGRADED crash-looping slots "
    "still count toward the bound — the controller cannot drain its "
    "way to an empty fleet).",
    checker=_positive("serving.fleet.minReplicas"))

SERVING_FLEET_MAX_REPLICAS = _conf(
    "serving.fleet.maxReplicas", int, 4,
    "Upper bound on supervised replica slots: scale-up stops here no "
    "matter the pressure — past it the front door sheds "
    "(serving.maxQueuedPerTenant / OverloadedError) instead of growing.",
    checker=_positive("serving.fleet.maxReplicas"))

SERVING_FLEET_SUPERVISE_INTERVAL = _conf(
    "serving.fleet.superviseIntervalSeconds", float, 0.2,
    "Supervisor sweep period: each tick polls every slot's process for "
    "exit, checks registry heartbeats against the liveness window, and "
    "restarts due slots on the deterministic backoff schedule.",
    checker=_positive("serving.fleet.superviseIntervalSeconds"))

SERVING_FLEET_RESTART_BACKOFF_MS = _conf(
    "serving.fleet.restartBackoffMs", int, 200,
    "Base delay before restarting a dead replica slot; successive "
    "deaths of the same slot back off exponentially with deterministic "
    "jitter (the shuffle/retry.py schedule, keyed by slot index), and "
    "the attempt counter resets after "
    "serving.fleet.stableUptimeSeconds of healthy uptime.",
    checker=_positive("serving.fleet.restartBackoffMs"))

SERVING_FLEET_STABLE_UPTIME = _conf(
    "serving.fleet.stableUptimeSeconds", float, 30.0,
    "A replica that stays up this long is considered stable: its slot's "
    "restart-backoff attempt counter resets, so the next (unrelated) "
    "death restarts fast instead of inheriting an old slow schedule.",
    checker=_positive("serving.fleet.stableUptimeSeconds"))

SERVING_FLEET_CRASH_LOOP_THRESHOLD = _conf(
    "serving.fleet.crashLoopThreshold", int, 3,
    "Crash-loop breaker: this many deaths of one slot within "
    "serving.fleet.crashLoopWindowSeconds stops the restart storm — the "
    "slot is marked DEGRADED (no further restarts, surfaced in fleet "
    "stats and excluded from the autoscaler's healthy count) instead of "
    "burning CPU forever. reset_slot() re-arms it after the operator "
    "fixes the cause.",
    checker=_positive("serving.fleet.crashLoopThreshold"))

SERVING_FLEET_CRASH_LOOP_WINDOW = _conf(
    "serving.fleet.crashLoopWindowSeconds", float, 10.0,
    "Sliding window the crash-loop breaker counts slot deaths over: "
    "deaths older than this no longer count toward the threshold.",
    checker=_positive("serving.fleet.crashLoopWindowSeconds"))

SERVING_FLEET_CONTROL_INTERVAL = _conf(
    "serving.fleet.controlIntervalSeconds", float, 1.0,
    "Autoscaler control-loop period: each tick aggregates serve.health "
    "snapshots across the fleet and makes one scaling decision "
    "(watermarks + hysteresis + cooldowns).",
    checker=_positive("serving.fleet.controlIntervalSeconds"))

SERVING_FLEET_SCALE_UP_WATERMARK = _conf(
    "serving.fleet.scaleUpWatermark", float, 0.8,
    "High watermark on the fleet pressure signal (max of normalized "
    "admission queue depth and device-budget fraction across healthy "
    "replicas): pressure at or above this for "
    "serving.fleet.scaleUpStableTicks consecutive ticks requests one "
    "more replica (bounded by maxReplicas and the up-cooldown).",
    checker=_fraction("serving.fleet.scaleUpWatermark"))

SERVING_FLEET_SCALE_DOWN_WATERMARK = _conf(
    "serving.fleet.scaleDownWatermark", float, 0.25,
    "Low watermark on the fleet pressure signal: pressure at or below "
    "this for serving.fleet.scaleDownStableTicks consecutive ticks "
    "retires one replica through the graceful-drain path (bounded by "
    "minReplicas and the down-cooldown). Keep it well under the high "
    "watermark — the dead band between them is the hysteresis that "
    "stops flapping.",
    checker=_fraction("serving.fleet.scaleDownWatermark"))

SERVING_FLEET_SCALE_UP_STABLE_TICKS = _conf(
    "serving.fleet.scaleUpStableTicks", int, 2,
    "Consecutive control ticks the pressure must hold at/above the high "
    "watermark before a scale-up fires (a one-tick spike is noise, not "
    "a trend).", checker=_positive("serving.fleet.scaleUpStableTicks"))

SERVING_FLEET_SCALE_DOWN_STABLE_TICKS = _conf(
    "serving.fleet.scaleDownStableTicks", int, 5,
    "Consecutive control ticks the pressure must hold at/below the low "
    "watermark before a scale-down fires — longer than the up "
    "requirement on purpose: growing late queues work, shrinking early "
    "sheds it.", checker=_positive("serving.fleet.scaleDownStableTicks"))

SERVING_FLEET_SCALE_UP_COOLDOWN = _conf(
    "serving.fleet.scaleUpCooldownSeconds", float, 5.0,
    "Minimum wall time between two scale-ups: a freshly started replica "
    "needs time to register and absorb load before the controller may "
    "conclude the fleet is still too small.",
    checker=_non_negative("serving.fleet.scaleUpCooldownSeconds"))

SERVING_FLEET_SCALE_DOWN_COOLDOWN = _conf(
    "serving.fleet.scaleDownCooldownSeconds", float, 30.0,
    "Minimum wall time between two scale-downs, and after any scale-up "
    "before the first scale-down — the asymmetry (longer than the up "
    "cooldown) biases the fleet toward capacity under oscillating load.",
    checker=_non_negative("serving.fleet.scaleDownCooldownSeconds"))

SERVING_FLEET_P99_OBJECTIVE = _conf(
    "serving.fleet.p99ObjectiveSeconds", float, 0.0,
    "Latency objective the autoscaler folds into fleet pressure: a "
    "replica's rolling-window p99 query wall divided by this objective "
    "becomes a pressure component alongside footprint and queue depth, "
    "so a fleet that is slow (not just full) still scales up. 0 "
    "disables the latency component.",
    checker=_non_negative("serving.fleet.p99ObjectiveSeconds"))

SERVING_MAX_QUEUED_PER_TENANT = _conf(
    "serving.maxQueuedPerTenant", int, 256,
    "Bound on one tenant's scheduler queue depth: a submission past it "
    "is shed at the front door with a structured RETRYABLE "
    "OverloadedError carrying a retry-after hint (counted in "
    "serving.sheds) instead of queueing without limit — one flooding "
    "tenant cannot OOM the scheduler. 0 disables the bound.",
    checker=_non_negative("serving.maxQueuedPerTenant"))

SERVING_QUOTA_MAX_PER_CLIENT = _conf(
    "serving.quota.maxConcurrentPerClient", int, 0,
    "Per-client concurrent-query quota at the serving wire: a client "
    "(wire peer) with this many open queries on a replica gets further "
    "submits rejected with a structured RETRYABLE QuotaExceededError "
    "(counted in serving.quota_rejections). 0 disables the quota.",
    checker=_non_negative("serving.quota.maxConcurrentPerClient"))

SERVING_OVERLOAD_RETRY_AFTER = _conf(
    "serving.overload.retryAfterSeconds", float, 0.25,
    "Base retry-after hint shipped inside OverloadedError / "
    "QuotaExceededError rejections; the server scales it with how far "
    "past the bound the tenant's queue is, and the client honors the "
    "hint (floored by its deterministic backoff schedule) before "
    "retrying.", checker=_positive("serving.overload.retryAfterSeconds"))

SERVING_OVERLOAD_CLIENT_RETRIES = _conf(
    "serving.overload.clientRetries", int, 2,
    "How many full rotation passes the client retries a submission that "
    "EVERY replica shed (each pass sleeps the max of the replicas' "
    "retry-after hints and the deterministic backoff for that attempt) "
    "before surfacing the OverloadedError to the caller.",
    checker=_non_negative("serving.overload.clientRetries"))

# --------------------------------------------------------------------------------------
# Observability (SQLMetrics / NVTX analog)
# --------------------------------------------------------------------------------------
TRACE_ENABLED = _conf(
    "trace.enabled", bool, False,
    "Structured query tracing (utils/tracing.py): record per-operator "
    "execute() spans (rows/batches/bytes, wall + self time, keyed by plan "
    "node id) and the serving lifecycle/admission/preemption/wire spans "
    "into a bounded ring buffer, and open a named torch.profiler range "
    "per operator pull (the NVTX ranges' analog). Timestamps are taken "
    "on the host at boundaries that exist anyway and no span waits on "
    "the device, so an operator's span on a GPU is the time its launches "
    "took on the host, not its device time. Feeds EXPLAIN ANALYZE "
    "(tree_string(analyze=True) / QueryHandle.explain_analyze()) and the "
    "Chrome/Perfetto trace export. Off: every hook reduces to one "
    "boolean read.")

TRACE_EXPORT_PATH = _conf(
    "trace.export.path", str, "",
    "When set (and trace.enabled), each action writes its span window as "
    "Chrome trace-event JSON to this path on completion — loadable in "
    "ui.perfetto.dev / chrome://tracing to inspect overlapped pipelines "
    "(chunked upload vs compute, streaming D2H). The file is rewritten "
    "per action (last-action semantics, like session.last_metrics); use "
    "QueryHandle.export_trace(path) for one specific query's spans.")

TRACE_BUFFER_SPANS = _conf(
    "trace.maxBufferedSpans", int, 65536,
    "Capacity of the tracing ring buffer: a long-running traced server "
    "overwrites its oldest spans past this bound instead of growing "
    "without limit. Exports and EXPLAIN ANALYZE see at most this many "
    "trailing spans.", checker=_positive("trace.maxBufferedSpans"))

SERVING_STATS_WINDOW = _conf(
    "serving.stats.windowSeconds", float, 300.0,
    "Rolling window of the serve.stats time-series (serving/stats.py): "
    "per-replica gauge samples (device budget in use, admission queue "
    "depth, running/queued per tenant) and query wall times older than "
    "this are dropped; p50/p99 query wall is computed over the window. "
    "The feed load-aware replica routing consumes (ROADMAP item 4).",
    checker=_positive("serving.stats.windowSeconds"))

SERVING_STATS_SAMPLE_INTERVAL = _conf(
    "serving.stats.sampleIntervalSeconds", float, 1.0,
    "Period of the scheduler's background gauge-sampler tick: before it, "
    "gauges were sampled only at terminal queries and stats requests, so "
    "an idle or wedged replica reported a stale time-series exactly when "
    "the autoscaler most needed truth. The daemon tick keeps the series "
    "fresh and snapshot() stamps its age (age_s) so consumers can treat "
    "a stalled sampler as unhealthy. 0 disables the tick (tests).",
    checker=_non_negative("serving.stats.sampleIntervalSeconds"))

SERVING_STATS_STALE_AFTER = _conf(
    "serving.stats.staleAfterSeconds", float, 10.0,
    "Snapshot age (serve_stats age_s — seconds since the last sampler "
    "tick) past which the autoscaler treats a replica's stats as stale: "
    "a stale replica is excluded from the pressure signal AND from the "
    "healthy count, so a wedged replica flat-lining its gauges cannot "
    "read as idle and trigger a scale-down.",
    checker=_positive("serving.stats.staleAfterSeconds"))


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

    def get_raw(self, key: str, default: Any = None) -> Any:
        """The value set for ``key``, or ``default`` when none was."""
        return self._values.get(key, default)

    def with_overrides(self, extra: Dict[str, Any]) -> "TpuConf":
        merged = dict(self._values)
        merged.update(extra)
        return TpuConf(merged)

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

    # the shuffle stack reads these (shuffle/transport.py, tcp.py, faults.py,
    # client.py, manager.py)
    @property
    def shuffle_transport_class(self) -> str:
        return self.get(SHUFFLE_TRANSPORT_CLASS)

    @property
    def shuffle_tcp_port(self) -> int:
        return self.get(SHUFFLE_TCP_PORT)

    @property
    def shuffle_tcp_registry(self) -> str:
        return self.get(SHUFFLE_TCP_REGISTRY)

    @property
    def shuffle_max_inflight_bytes(self) -> int:
        return self.get(SHUFFLE_MAX_INFLIGHT_BYTES)

    @property
    def shuffle_bounce_buffer_size(self) -> int:
        return self.get(SHUFFLE_BOUNCE_BUFFER_SIZE)

    @property
    def shuffle_bounce_buffer_count(self) -> int:
        return self.get(SHUFFLE_BOUNCE_BUFFER_COUNT)

    @property
    def shuffle_codec(self) -> str:
        return self.get(SHUFFLE_COMPRESSION_CODEC)

    @property
    def shuffle_max_retries(self) -> int:
        return self.get(SHUFFLE_MAX_RETRIES)

    @property
    def shuffle_retry_backoff_ms(self) -> int:
        return self.get(SHUFFLE_RETRY_BACKOFF_MS)

    @property
    def shuffle_connect_timeout(self) -> float:
        return self.get(SHUFFLE_CONNECT_TIMEOUT)

    @property
    def shuffle_checksum_enabled(self) -> bool:
        return self.get(SHUFFLE_CHECKSUM_ENABLED)

    @property
    def shuffle_recompute_max_stage_attempts(self) -> int:
        return self.get(SHUFFLE_RECOMPUTE_MAX_STAGE_ATTEMPTS)

    @property
    def shuffle_faults_plan(self) -> str:
        return self.get(SHUFFLE_FAULTS_PLAN)

    @property
    def shuffle_faults_seed(self) -> int:
        return self.get(SHUFFLE_FAULTS_SEED)

    @property
    def shuffle_faults_transport_class(self) -> str:
        return self.get(SHUFFLE_FAULTS_TRANSPORT)


def all_entries():
    return sorted(_REGISTRY.values(), key=lambda e: e.key)


def generate_docs() -> str:
    """The markdown reference of every key the port declares (the JAX
    package's ``config.generate_docs``, RapidsConf.help's analog):
    ``python -m spark_rapids_tpu_torch.config docs/configs-torch.md``
    writes it, and ``python -m spark_rapids_tpu_torch.analysis
    --check-configs`` fails while that file differs."""
    lines = [
        "# Configuration of the PyTorch/CUDA port",
        "",
        "The keys `spark_rapids_tpu_torch` reads, under the JAX package's "
        "names. Generated by `python -m spark_rapids_tpu_torch.config`.",
        "",
        "| Name | Description | Default |",
        "|---|---|---|",
    ]
    for entry in all_entries():
        doc = " ".join(entry.doc.split()).replace("|", "\\|")
        lines.append(f"| {entry.key} | {doc} | {entry.default} |")
    lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    text = generate_docs()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w", encoding="utf-8") as f:
            f.write(text)
    else:
        print(text)
