"""R003 (x64 dtype hazards) has no counterpart in the port.

The JAX package's R003 flags a module that imports ``jax`` before
``spark_rapids_tpu.device`` has turned ``jax_enable_x64`` on, and dtype-less
``jnp``/``np`` constructors whose width depends on that flag: without it
LONG and DOUBLE columns silently truncate to 32 bits. PyTorch has no such
switch: float64 and int64 are native and a tensor's dtype does not depend
on import order, so the rule has nothing to check. Its number stays
reserved, so that a suppression means the same thing in both packages, and
``--list-rules`` names it as not ported. This module registers no rule.
"""
from __future__ import annotations

#: rule id -> why the port has no counterpart (``--list-rules`` prints it)
NOT_PORTED = {"R003": "x64 dtype hazards: float64 and int64 are native in "
                      "torch"}
