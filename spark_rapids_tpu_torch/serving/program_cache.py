"""Plan keys: the canonical signature of a physical plan.

The JAX package's ``serving/program_cache.py`` keys its cache of compiled
programs with them; here ``plan_key`` is the cluster's lineage replay key
(parallel/cluster.py checks a replayed map stage against the key its first
run recorded). The program cache itself belongs to the serving layer.
"""
from __future__ import annotations

import hashlib
from typing import Any, Tuple


def stable_key_hash(key: Any) -> str:
    """Process-independent identity of a key: tuples of operator names,
    conf scalars and capacity buckets, all with deterministic reprs."""
    return hashlib.sha1(repr(key).encode()).hexdigest()


def plan_key(plan, conf=None) -> str:
    """Canonical signature of a physical plan: operator structure, dtype
    signature and partitioning, with row-count estimates bucketed to
    powers of two (conf ``serving.shapeBuckets``). Two plans of the same
    query shape share one key, whatever their exact row counts."""
    from spark_rapids_tpu_torch import config as cfg
    from spark_rapids_tpu_torch.columnar.dtypes import bucket_capacity
    bucketed = True if conf is None else bool(
        conf.get(cfg.SERVING_SHAPE_BUCKETS))

    def walk(node) -> Tuple:
        est = node.size_estimate()
        if est is not None:
            est = (bucket_capacity(int(est)) if bucketed
                   else max(int(est), 1))
        sig = tuple(f.dtype.value for f in node.output)
        return (node.name, sig, node.num_partitions, est,
                tuple(walk(c) for c in node.children))

    return stable_key_hash(walk(plan))
