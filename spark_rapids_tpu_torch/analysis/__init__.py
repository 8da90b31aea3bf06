"""tpu-lint over the PyTorch port: AST static analysis for hidden
host-device syncs, kernel libraries outside the program cache,
config/registry drift, exec parity, lock hygiene, races, resource leaks,
cancellation, the failure ladder and cache-key captures.

The port's counterpart of ``spark_rapids_tpu.analysis``: the engine
(``core``, ``baseline``, ``cfg``, ``dataflow``, ``callgraph``,
``exceptions``, ``captures``) is the reference's text after the package
name, and every rule keeps its number. It imports neither torch nor jax.

CLI: ``python -m spark_rapids_tpu_torch.analysis [paths]`` (see
__main__.py). Library: ``analyze_files(files)`` over ``SourceFile``
objects; rules live in rules_*.py and self-register via the ``@register``
decorator.
"""
from spark_rapids_tpu_torch.analysis.core import (AnalysisResult, Finding,
                                                  Rule, SourceFile, all_rules,
                                                  analyze_files, load_source,
                                                  register)

__all__ = ["AnalysisResult", "Finding", "Rule", "SourceFile", "all_rules",
           "analyze_files", "load_source", "register"]
