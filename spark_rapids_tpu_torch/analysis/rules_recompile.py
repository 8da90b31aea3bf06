"""R001 (jit recompile hazards) has no counterpart in the port.

The JAX package's R001 flags ``jax.jit`` constructions inside loops,
invoked at once, or with unhashable static arguments: each is a trace and
an XLA compile per call. The port evaluates eagerly in PyTorch and builds
its only compiled artifacts, the CUDA kernel libraries, through the
serving program cache (``cuda_build.load``); nothing it runs is traced or
compiled per call, so the rule has nothing to check. Its number stays
reserved, so that a suppression means the same thing in both packages, and
``--list-rules`` names it as not ported. This module registers no rule.
"""
from __future__ import annotations

#: rule id -> why the port has no counterpart (``--list-rules`` prints it)
NOT_PORTED = {"R001": "jit recompile hazards: the port evaluates eagerly "
                      "and traces nothing"}
