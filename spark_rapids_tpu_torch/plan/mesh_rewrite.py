"""Physical-plan rewrite onto the mesh (the JAX package's
``plan/mesh_rewrite.py``).

Runs after ``TpuOverrides`` when ``sql.mesh.enabled`` is set and the mesh
has at least two shards: every maximal device subtree of supported
operators is lowered onto the session's mesh, with scatters and gathers at
its edges.

- an upload becomes a mesh scatter, a device file scan a shard-local scan
  (its row groups assigned to shards here, at plan time); a download
  gathers;
- project, filter, expand, generate, sort, limit, union and the explicit
  exchanges run per shard, repartitioning over the mesh where rows move;
- a hash aggregate is the Partial mode per shard and a merge (gathered, or
  repartitioned by key past ``sql.mesh.aggRepartitionThreshold``);
- a shuffled hash join repartitions both sides by key; a broadcast hash
  join copies its build batch to every shard;
- a window with partition keys repartitions by them; a write emits one part
  file per shard;
- anything else (an unpartitioned window, the nested-loop joins, a single
  partition exchange) runs on one device behind a gather, with the
  boundary in the plan.
"""
from __future__ import annotations

import sys
from typing import List, Optional

import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.execs import mesh_execs as me
from spark_rapids_tpu_torch.execs import tpu_execs as te
from spark_rapids_tpu_torch.execs.base import PhysicalExec


def _is_mesh(node: PhysicalExec) -> bool:
    return getattr(node, "is_mesh", False)


def session_mesh(conf: TpuConf, device: torch.device):
    """The mesh a session on ``device`` runs on, or None below two shards:
    ``sql.mesh.numDevices`` shards (0: one per visible device) over the
    devices of ``device``'s kind, clipped to one peer group
    (``sql.mesh.requireIci``)."""
    from spark_rapids_tpu_torch.parallel import placement as pl
    from spark_rapids_tpu_torch.parallel.mesh import (make_mesh,
                                                      visible_devices)
    devs = visible_devices(device)
    if conf.get(cfg.MESH_REQUIRE_ICI):
        devs = pl.largest_ici_group(devs)
    n = conf.get(cfg.MESH_NUM_DEVICES) or len(devs)
    if n < 2:
        return None
    return make_mesh(n, devices=devs)


def mesh_rewrite(plan: PhysicalExec, conf: TpuConf,
                 device: torch.device) -> PhysicalExec:
    """Lower the plan's device subtrees onto the session mesh (unchanged
    when the mesh is off or has fewer than two shards)."""
    if not conf.get(cfg.MESH_ENABLED):
        return plan
    mesh = session_mesh(conf, device)
    if mesh is None:
        return plan
    return _rewrite(plan, mesh, conf)


def _gathered(node: PhysicalExec, mesh) -> PhysicalExec:
    """A mesh producer adapted for a consumer that needs device batches."""
    if isinstance(node, me.MeshScatterExec):
        # scatter-then-gather is a plain upload
        return te.HostToDeviceExec(node.children[0])
    if isinstance(node, me.MeshFileScatterExec):
        # a gathered file scan is the single-device scan
        scan = node.children[0]
        return (scan if getattr(scan, "is_device", False)
                else te.HostToDeviceExec(scan))
    if isinstance(node, me.MeshFromDeviceExec):
        return node.children[0]
    if isinstance(node, me.MeshWriteFilesExec):
        return node  # produces no rows; nothing to gather
    return me.MeshGatherExec(node, mesh) if _is_mesh(node) else node


def _meshed(node: PhysicalExec, mesh) -> Optional[PhysicalExec]:
    """A node adapted for a consumer that needs a mesh batch: mesh
    producers pass, device producers are scattered, host producers give
    None (the caller decides)."""
    if _is_mesh(node):
        return node
    if getattr(node, "is_device", False):
        return me.MeshFromDeviceExec(node, mesh)
    return None


def _rewrite(node: PhysicalExec, mesh, conf) -> PhysicalExec:
    from spark_rapids_tpu_torch.execs.exchange_execs import (
        HashPartitioning, RangePartitioning, RoundRobinPartitioning,
        TpuBroadcastExchangeExec, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.execs.expand_execs import TpuExpandExec
    from spark_rapids_tpu_torch.execs.generate_execs import TpuGenerateExec
    from spark_rapids_tpu_torch.execs.join_execs import (
        TpuBroadcastHashJoinExec, TpuShuffledHashJoinExec, _NestedLoopMixin)
    from spark_rapids_tpu_torch.execs.window_execs import TpuWindowExec
    from spark_rapids_tpu_torch.exprs.misc import Alias
    # the file package loads pyarrow: a plan holds a write only once it is
    # imported
    write_mod = sys.modules.get("spark_rapids_tpu_torch.io.write_exec")

    kids: List[PhysicalExec] = [_rewrite(c, mesh, conf)
                                for c in node.children]

    # ---- scans and transitions ---------------------------------------------
    if getattr(node, "is_file_scan", False) and getattr(node, "is_device",
                                                        False):
        return me.MeshFileScatterExec(node, mesh,
                                      me.plan_scan_shards(node, mesh, conf))
    if isinstance(node, te.HostToDeviceExec):
        if getattr(kids[0], "is_file_scan", False):
            return me.MeshFileScatterExec(
                kids[0], mesh, me.plan_scan_shards(kids[0], mesh, conf))
        return me.MeshScatterExec(kids[0], mesh)
    if isinstance(node, te.DeviceToHostExec):
        return te.DeviceToHostExec(_gathered(kids[0], mesh))
    if isinstance(node, te.TpuCoalesceBatchesExec) and _is_mesh(kids[0]):
        return kids[0]

    # ---- row-parallel, expand, window, write, aggregate --------------------
    if _is_mesh(kids[0] if kids else None):
        if isinstance(node, te.TpuProjectExec):
            return me.MeshProjectExec(node.exprs, kids[0], mesh)
        if isinstance(node, te.TpuFilterExec):
            return me.MeshFilterExec(node.condition, kids[0], mesh)
        if isinstance(node, TpuExpandExec):
            cls = (me.MeshGenerateExec if isinstance(node, TpuGenerateExec)
                   else me.MeshExpandExec)
            return cls(node.projections, kids[0], node.output, mesh)
        if isinstance(node, TpuWindowExec):
            first = (node.wexprs[0].c if isinstance(node.wexprs[0], Alias)
                     else node.wexprs[0])
            if first.part_keys:
                return me.MeshWindowExec(node.wexprs, kids[0], mesh)
            # an unpartitioned window is one frame: one device
        if write_mod is not None and isinstance(node,
                                                write_mod.TpuWriteFilesExec):
            return me.MeshWriteFilesExec(node.spec, kids[0], mesh)
        if isinstance(node, te.TpuHashAggregateExec):
            return me.MeshHashAggregateExec(node.grouping, node.aggregates,
                                            kids[0], node.output, mesh,
                                            node.pre_filter)

    # ---- joins -------------------------------------------------------------
    if isinstance(node, _NestedLoopMixin):
        pass  # the brute-force forms stay on one device
    elif isinstance(node, TpuBroadcastHashJoinExec):
        bi = 0 if node.build_side == "left" else 1
        si = 1 - bi
        build = kids[bi]
        if isinstance(build, TpuBroadcastExchangeExec):
            build = build.with_children([_gathered(build.children[0], mesh)])
        smesh = _meshed(kids[si], mesh)
        if smesh is not None:
            ordered: List[Optional[PhysicalExec]] = [None, None]
            ordered[bi], ordered[si] = build, smesh
            return me.MeshBroadcastHashJoinExec(
                ordered[0], ordered[1], node.how, node.left_keys,
                node.right_keys, node.output, mesh, node.condition,
                node.build_side)
        kids[bi] = build
    elif isinstance(node, TpuShuffledHashJoinExec):
        lm, rm = _meshed(kids[0], mesh), _meshed(kids[1], mesh)
        if lm is not None and rm is not None and (
                _is_mesh(kids[0]) or _is_mesh(kids[1])):
            return me.MeshShuffledHashJoinExec(
                lm, rm, node.how, tuple(node.left_keys),
                tuple(node.right_keys), node.output, mesh, node.condition,
                node.build_side)

    # ---- sort, limit, union --------------------------------------------------
    if isinstance(node, te.TpuSortExec) and _is_mesh(kids[0]):
        pre = (isinstance(kids[0], me.MeshShuffleExchangeExec)
               and isinstance(kids[0].partitioning, RangePartitioning)
               and tuple(kids[0].partitioning.orders) == tuple(node.orders))
        return me.MeshSortExec(node.orders, kids[0], mesh,
                               pre_partitioned=pre)
    if isinstance(node, te.TpuLimitExec) and _is_mesh(kids[0]):
        return me.MeshLimitExec(node.n, kids[0], mesh)
    if isinstance(node, te.TpuUnionExec) and (
            _is_mesh(kids[0]) or _is_mesh(kids[1])):
        lm, rm = _meshed(kids[0], mesh), _meshed(kids[1], mesh)
        if lm is not None and rm is not None:
            return me.MeshUnionExec(lm, rm, mesh)

    # ---- exchanges ---------------------------------------------------------
    if isinstance(node, TpuShuffleExchangeExec) and _is_mesh(kids[0]):
        if isinstance(node.partitioning, (HashPartitioning,
                                          RoundRobinPartitioning,
                                          RangePartitioning)):
            return me.MeshShuffleExchangeExec(node.partitioning, kids[0],
                                              mesh)
        return me.MeshGatherExec(kids[0], mesh)
    if isinstance(node, TpuBroadcastExchangeExec):
        return node.with_children([_gathered(kids[0], mesh)])

    # ---- everything else: its mesh children gathered -------------------------
    new_kids = [_gathered(c, mesh) for c in kids]
    if all(a is b for a, b in zip(new_kids, node.children)):
        return node
    return node.with_children(new_kids)
