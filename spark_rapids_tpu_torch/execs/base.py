"""Physical operator base classes.

A physical exec yields batches for one partition: ``HostBatch`` for the host
leaf and the download transition, ``DeviceBatch`` for everything between.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.config import TpuConf


class ExecContext:
    """Per-execution state handed down the operator tree."""

    def __init__(self, conf: TpuConf, device: torch.device,
                 partition_id: int = 0, num_partitions: int = 1,
                 device_manager=None, cleanups: Optional[List] = None):
        self.conf = conf
        self.device = device
        self.partition_id = partition_id
        self.num_partitions = num_partitions
        #: the process's memory manager (memory/device_manager.py), whose
        #: store chain holds the exchanges' map outputs
        self.device_manager = device_manager
        #: shared by the partitions of one action; the caller runs them when
        #: the action finishes (shuffle removal)
        self.cleanups = cleanups

    @property
    def string_max_bytes(self) -> int:
        return self.conf.string_max_bytes

    def for_partition(self, partition_id: int,
                      num_partitions: int) -> "ExecContext":
        return ExecContext(self.conf, self.device, partition_id,
                           num_partitions, self.device_manager, self.cleanups)


class PhysicalExec:
    """Base physical operator: ``output`` is the produced schema; ``execute``
    yields the batches of one partition."""

    def __init__(self, children: Sequence["PhysicalExec"], output: Schema):
        self.children: Tuple[PhysicalExec, ...] = tuple(children)
        self.output = output

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def num_partitions(self) -> int:
        """Output partition count; exchanges override."""
        return max((c.num_partitions for c in self.children), default=1)

    def execute(self, ctx: ExecContext) -> Iterator:
        raise NotImplementedError(self.name)

    def size_estimate(self) -> Optional[int]:
        """Estimated output bytes, or None when unknown (the JAX package's
        estimates, which the planner's broadcast choice reads: a side of
        unknown size is never broadcast). Narrowing operators pass their
        child's estimate through as an upper bound."""
        return None

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + f"{self.name} [{self.output}]"]
        lines += [c.tree_string(indent + 1) for c in self.children]
        return "\n".join(lines)

    def with_children(self, children: Sequence["PhysicalExec"]
                      ) -> "PhysicalExec":
        import copy
        node = copy.copy(self)
        node.children = tuple(children)
        return node

    def transform_up(self, fn) -> "PhysicalExec":
        kids = [c.transform_up(fn) for c in self.children]
        node = self
        if tuple(kids) != self.children:
            node = self.with_children(kids)
        return fn(node)

    def walk(self) -> Iterator["PhysicalExec"]:
        yield self
        for c in self.children:
            yield from c.walk()


class LeafExec(PhysicalExec):
    def __init__(self, output: Schema):
        super().__init__((), output)
