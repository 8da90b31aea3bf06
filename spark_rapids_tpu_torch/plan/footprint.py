"""Plan-time footprint contract: predict working sets and choose grace
partition counts up front (the JAX package's ``plan/footprint.py``).

The planner half of the out-of-core design (memory/grace.py is the runtime
half): after fusion and the pipeline pass built the final physical tree,
walk it and compare every operator's ``working_set_estimate()`` (for the
working-set operators ``working_set_factor`` times the sum of their
children's ``size_estimate()``) against the device budget. An operator
predicted over budget gets ``grace_partitions`` annotated, and execution
partitions its input at once instead of finding the pressure while it
stages. Pressure at run time triggers the same machinery when the
estimate was absent (None) or wrong: the annotation is an optimization,
never needed for a correct result.
"""
from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs.base import PhysicalExec


def device_budget_estimate(conf: TpuConf,
                           device: Optional[torch.device] = None
                           ) -> Optional[int]:
    """The device budget the store chain will enforce, without making a
    DeviceManager: a live manager's budget when one exists, else the same
    derivation the manager would apply (explicit poolSizeBytes, or
    allocFraction of the device's memory)."""
    from spark_rapids_tpu_torch.memory.device_manager import (
        DeviceManager, _device_memory_bytes)
    dm = DeviceManager.peek()
    if dm is not None:
        return dm.device_budget
    explicit = conf.get(cfg.DEVICE_POOL_BYTES)
    if explicit:
        return explicit
    return int(_device_memory_bytes(torch.device(device or "cpu"))
               * conf.get(cfg.DEVICE_POOL_FRACTION))


def _pow2_at_least(n: int) -> int:
    p = 2
    while p < n:
        p <<= 1
    return p


def choose_partitions(working_set: int, budget: int, conf: TpuConf) -> int:
    """Partition count for an operator predicted over budget: enough that
    each partition's share of the working set fits the headroom budget
    with 2x slack for estimate error and skew, a power of two, clamped to
    ``memory.outOfCore.maxPartitions``."""
    headroom = max(int(budget * conf.get(cfg.OOC_HEADROOM)), 1)
    need = -(-2 * working_set // headroom)          # ceil
    n = _pow2_at_least(max(need, 2))
    return max(2, min(n, conf.get(cfg.OOC_MAX_PARTITIONS)))


def observed_input_bytes(node: PhysicalExec,
                         partition_id: Optional[int] = None) -> Optional[int]:
    """The bytes a working-set operator's shuffle inputs really
    materialized: the summed ``StageStats`` of its executed exchanges,
    looking through the transitions and the single-partition exchange the
    planner inserts. None when an input has no executed stage behind it;
    callers then fall back to the static ``working_set_estimate``.

    With ``partition_id`` the charge is the one consumer partition the
    caller executes: the matching reduce partition of each input. Passing
    through a single-partition exchange widens it to everything, since its
    consumer reads the concatenation. The JAX package also looks through
    its coalesce exec and the adaptive custom shuffle reader; the port has
    neither yet."""
    from spark_rapids_tpu_torch.execs import tpu_execs as te
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        ShuffleExchangeExecBase, SinglePartitioning)
    total = 0
    for child in node.children:
        c = child
        pid = partition_id
        while True:
            if isinstance(c, (te.HostToDeviceExec, te.DeviceToHostExec)):
                c = c.children[0]
                continue
            if (isinstance(c, ShuffleExchangeExecBase)
                    and isinstance(c.partitioning, SinglePartitioning)):
                c = c.children[0]
                pid = None              # the concat reads every partition
                continue
            break
        if isinstance(c, ShuffleExchangeExecBase):
            st = c.stage_stats()
            if st is None:
                return None
            if pid is not None and 0 <= pid < len(st.partition_bytes):
                total += st.partition_bytes[pid]
            else:
                total += st.total_bytes
            continue
        return None
    return total


def plan_working_set_estimate(plan: PhysicalExec) -> Optional[int]:
    """Peak device working set one action of ``plan`` is predicted to
    need: the largest declared ``working_set_estimate`` of its device
    operators (one working-set operator materializes its input at a time),
    or None when none declares one."""
    best: Optional[int] = None
    stack = [plan]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        if not node.is_device:
            continue
        ws = node.working_set_estimate()
        if ws is not None and (best is None or ws > best):
            best = ws
    return best


def annotate_out_of_core(plan: PhysicalExec, conf: TpuConf,
                         device: Optional[torch.device] = None
                         ) -> PhysicalExec:
    """Annotate ``grace_partitions`` on the working-set operators whose
    footprint estimate exceeds the device budget's headroom fraction. No
    plan node changes when everything fits or out-of-core is off."""
    if not conf.get(cfg.OOC_ENABLED):
        return plan
    # forcePartitions is a run-time knob (GraceController reads it with no
    # annotation); with no budget there is nothing to predict against
    budget = device_budget_estimate(conf, device)
    if budget is None:
        return plan
    threshold = int(budget * conf.get(cfg.OOC_HEADROOM))

    def visit(node: PhysicalExec) -> PhysicalExec:
        if not node.is_device:
            return node
        ws = node.working_set_estimate()
        if ws is not None and ws > threshold:
            node.grace_partitions = choose_partitions(ws, budget, conf)
        return node

    return plan.transform_up(visit)
