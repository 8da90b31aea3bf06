"""API validation: the Cpu-vs-Tpu exec constructor parity check (the JAX
package's ``api_validation.py``).

Reference analog: api_validation/ (ApiValidation.scala:24-50), a
reflection tool diffing the constructor signatures of Spark execs and
their GPU replacements, which catches silent API drift. Here the pairing
is CpuXExec against TpuXExec: every conversion rule in plan/overrides.py
builds the Tpu exec from the Cpu exec's fields, so a signature divergence
is exactly the bug this catches. Run as
``python -m spark_rapids_tpu_torch.api_validation``. The pairs span the
same modules as the JAX package's, the file scans and the write command
(``io/csv.py``, ``io/orc.py``, ``io/parquet.py``, ``io/write_exec.py``)
among them.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Tuple, Type

#: (cpu class, tpu class) -> params the tpu side legitimately adds
_EXTRA_OK: Dict[Tuple[str, str], Tuple[str, ...]] = {}


def exec_pairs() -> List[Tuple[Type, Type]]:
    """Every CpuXExec with a TpuXExec counterpart across the exec modules."""
    from spark_rapids_tpu_torch.execs import (cpu_execs, exchange_execs,
                                              expand_execs, generate_execs,
                                              join_execs, window_execs)
    from spark_rapids_tpu_torch.io import csv, orc, parquet, write_exec
    from spark_rapids_tpu_torch.plan import adaptive
    modules = [cpu_execs, exchange_execs, expand_execs, generate_execs,
               join_execs, window_execs, csv, orc, parquet, write_exec,
               adaptive]
    # execs may live in different modules (tpu_execs holds most Tpu ones)
    from spark_rapids_tpu_torch.execs import tpu_execs
    modules.append(tpu_execs)
    by_name: Dict[str, Type] = {}
    for m in modules:
        for name, cls in vars(m).items():
            if isinstance(cls, type) and name.startswith(("Cpu", "Tpu")):
                by_name.setdefault(name, cls)
    pairs = []
    for name, cls in sorted(by_name.items()):
        if name.startswith("Cpu"):
            other = by_name.get("Tpu" + name[3:])
            if other is not None:
                pairs.append((cls, other))
    return pairs


def validate() -> List[str]:
    """Mismatch descriptions, empty when every pair lines up."""
    problems = []
    for cpu_cls, tpu_cls in exec_pairs():
        cs = inspect.signature(cpu_cls.__init__)
        ts = inspect.signature(tpu_cls.__init__)
        cp = list(cs.parameters.values())[1:]
        tp = list(ts.parameters.values())[1:]
        extra_ok = _EXTRA_OK.get((cpu_cls.__name__, tpu_cls.__name__), ())
        tp = [p for p in tp if p.name not in extra_ok]
        if [p.name for p in cp] != [p.name for p in tp]:
            problems.append(
                f"{cpu_cls.__name__}{cs} != {tpu_cls.__name__}{ts}")
    return problems


def main() -> int:
    problems = validate()
    if problems:
        print(f"{len(problems)} constructor mismatches:")
        for p in problems:
            print(" ", p)
        return 1
    print(f"{len(exec_pairs())} Cpu/Tpu exec pairs line up")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
