"""The distributed aggregate over a mesh (the JAX package's
``parallel/distributed.py``).

The JAX package runs it as one SPMD program: each device partially
aggregates its shard (``group_aggregate(evaluate=False)``, the Partial
mode), the partials all-gather over the mesh axis, and every device merges
them alike (``merge_aggregate``, the Final mode), which leaves the result
replicated. The port runs the same steps: each shard's Partial mode on its
device (``partial_aggregate``), the partials gathered onto shard 0's device
in shard order so the float sums meet in one fixed order, and one merge
(``merge_gathered``). ``MeshHashAggregateExec`` runs these two steps and
slices the merged groups over the shards; ``build_distributed_aggregate``
runs them and copies the merged columns to every shard device.
"""
from __future__ import annotations

from typing import Tuple

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import Field, Schema
from spark_rapids_tpu_torch.exprs.core import EvalCtx, Expression
from spark_rapids_tpu_torch.ops.aggregate import (group_aggregate,
                                                  grouping_modes,
                                                  merge_aggregate)
from spark_rapids_tpu_torch.parallel.mesh import Mesh
from spark_rapids_tpu_torch.parallel.mesh_batch import (MeshBatch,
                                                        gather_mesh,
                                                        replicate_device_batch)


def partial_aggregate(ectx: EvalCtx, key_exprs: Tuple[Expression, ...],
                      agg_fns: Tuple, num_rows: int, capacity: int,
                      pschema: Schema, extra_mask=None) -> DeviceBatch:
    """One shard's Partial mode as a batch of ``pschema``, escalating
    through the single-device aggregate's grouping modes (one-hot, hash,
    sort) while a mode flags its result."""
    from spark_rapids_tpu_torch.execs.tpu_execs import batch_of
    modes = grouping_modes(key_exprs, agg_fns) if key_exprs else ["sort"]
    for mode in modes:
        keys, bufs, ng, flagged = group_aggregate(
            ectx, key_exprs, agg_fns, num_rows, capacity, grouping=mode,
            extra_mask=extra_mask, evaluate=False)
        if not flagged:
            break
    return batch_of(pschema, list(keys) + list(bufs), ng)


def merge_gathered(partial: MeshBatch, num_keys: int, agg_fns: Tuple,
                   schema: Schema) -> DeviceBatch:
    """Every shard's partials gathered onto shard 0's device in shard
    order, merged once -> the merged keys and results as a batch of
    ``schema``."""
    from spark_rapids_tpu_torch.execs.tpu_execs import batch_of, colvs_of
    gathered = gather_mesh(partial)
    cols = colvs_of(gathered)
    keys, res, total = merge_aggregate(cols[:num_keys], cols[num_keys:],
                                       agg_fns, gathered.num_rows,
                                       gathered.capacity)
    return batch_of(schema, list(keys) + list(res), total)


def build_distributed_aggregate(mesh: Mesh, schema: Schema,
                                key_exprs: Tuple[Expression, ...],
                                agg_fns: Tuple, local_capacity: int,
                                string_max_bytes: int = 256):
    """fn(mesh batch) -> (per shard device: the merged key and result
    columns, the group count): ``partial_aggregate`` per shard,
    ``merge_gathered``, the merged batch copied to every shard device."""

    def fn(mb: MeshBatch):
        from spark_rapids_tpu_torch.execs.tpu_execs import colvs_of
        pschema = partial_schema(key_exprs, agg_fns)
        partials = tuple(
            partial_aggregate(EvalCtx(colvs_of(b), b.capacity, b.device,
                                      string_max_bytes, d),
                              key_exprs, agg_fns, b.num_rows, b.capacity,
                              pschema)
            for d, b in enumerate(mb.shards))
        merged = merge_gathered(
            MeshBatch(pschema, partials, mesh), len(key_exprs), agg_fns,
            Schema(list(pschema.fields[:len(key_exprs)])
                   + result_fields(agg_fns)))
        return ([colvs_of(b) for b in replicate_device_batch(merged, mesh)],
                merged.num_rows)
    return fn


def partial_schema(key_exprs, agg_fns) -> Schema:
    """The Partial mode's columns: the keys (``_k<i>``), then every
    function's buffers (``_b<fn>_<buffer>``), as the JAX mesh names them."""
    fields = [Field(f"_k{i}", e.dtype(), e.nullable())
              for i, e in enumerate(key_exprs)]
    for fi, fn in enumerate(agg_fns):
        for bi, spec in enumerate(fn.buffer_specs()):
            fields.append(Field(f"_b{fi}_{bi}", spec.dtype, True))
    return Schema(fields)


def result_fields(agg_fns):
    return [Field(f"_r{i}", fn.dtype(), True) for i, fn in enumerate(agg_fns)]
