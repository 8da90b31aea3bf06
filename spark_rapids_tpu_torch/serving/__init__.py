"""The serving layer. Only ``program_cache.plan_key`` is ported so far:
the cluster's lineage replay key (parallel/cluster.py)."""
