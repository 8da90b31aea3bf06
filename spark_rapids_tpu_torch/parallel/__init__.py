"""The device mesh: one logical batch in shards, one shard per mesh
device (the JAX package's ``parallel/``)."""
