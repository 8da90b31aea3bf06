"""Failure-escalation ladder: the engine's error taxonomy, declared in code.

The engine escalates a failure in three rungs: transfer retry
(shuffle/retry.py), then a lineage-scoped stage recompute
(parallel/cluster.py), then a whole-query failover (the serving layer,
not ported yet). This module is the one place that writes down how each
error class travels that ladder (retryable, permanent, cancellation or a
signal a higher rung triages) and how it crosses a process boundary. The
JAX package's linter (its rules R013-R015) reads the same markers
statically; the port keeps them as markers.

Every engine error class is registered here with:

  * a **classification** — how the ladder must treat it:
      - RETRYABLE:          safe to retry the failed operation in place
        (rung 1: transfer retry / drain redirect).
      - PERMANENT:          deterministic; retrying reproduces the failure.
      - CANCELLATION:       the caller gave up; must never be retried into
        life (R014 flags CANCELLATION → RETRYABLE conversions).
      - ESCALATION_SIGNAL:  carries structured payload that a HIGHER rung
        triages (recompute / failover); swallowing one breaks the ladder
        (R013 flags handlers that absorb a may-raised signal).
  * a **wire code** — the stable codec tag used when the exception crosses a
    process boundary (executor-daemon control socket, serving wire).  Types
    without a code degrade to OpaqueWireError, which is non-retryable by
    construction (R015 flags raise sites whose type would degrade).
  * its **home module** — classes stay defined next to the subsystem that
    raises them (no import churn); this module re-exports them lazily via
    PEP 562 ``__getattr__`` so ``from spark_rapids_tpu_torch.utils.errors import
    ShuffleFetchFailedError`` works without import cycles.

The registry is intentionally lazy: keys are ``"module.path:ClassName"``
strings, so importing this module pulls in nothing else.  Classification
lookup walks ``type(exc).__mro__`` and matches on that key, so subclasses
inherit their base's classification.
"""
from __future__ import annotations

import importlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Type

# ---------------------------------------------------------------------------
# classifications

RETRYABLE = "RETRYABLE"
PERMANENT = "PERMANENT"
CANCELLATION = "CANCELLATION"
ESCALATION_SIGNAL = "ESCALATION_SIGNAL"

CLASSIFICATIONS = (RETRYABLE, PERMANENT, CANCELLATION, ESCALATION_SIGNAL)


class OpaqueWireError(RuntimeError):
    """An exception without a registered wire codec crossed a process
    boundary.  Deliberately non-retryable (PERMANENT): an unclassified
    failure must not be retried on a hunch — register the type instead."""

    def __init__(self, message: str, wire_code: str = "OPAQUE"):
        super().__init__(message)
        self.wire_code = wire_code


# ---------------------------------------------------------------------------
# registry

@dataclass(frozen=True)
class ErrorSpec:
    """One registered engine error class.

    ``home`` is ``"module.path:ClassName"``; ``fields`` are the structured
    attributes the wire codec round-trips; ``ctor`` says how decode rebuilds
    the instance: ``"message"`` (positional message only), ``"message+fields"``
    (message plus keyword fields), or ``"fields"`` (keyword fields only — the
    class formats its own message)."""

    home: str
    classification: str
    wire_code: str
    fields: Tuple[str, ...] = ()
    ctor: str = "message"
    ladder_signal: bool = False
    doc: str = ""

    @property
    def name(self) -> str:
        return self.home.rsplit(":", 1)[1]

    @property
    def module(self) -> str:
        return self.home.rsplit(":", 1)[0]


TAXONOMY: Tuple[ErrorSpec, ...] = (
    # --- escalation signals: structured payloads a higher rung triages -----
    ErrorSpec("spark_rapids_tpu_torch.shuffle.manager:ShuffleFetchFailedError",
              ESCALATION_SIGNAL, "SHUFFLE_FETCH_FAILED",
              fields=("executor_id", "blocks"), ctor="message+fields",
              ladder_signal=True,
              doc="lost shuffle blocks; triggers lineage-scoped recompute"),
    ErrorSpec("spark_rapids_tpu_torch.memory.buffer:SpillCorruptionError",
              ESCALATION_SIGNAL, "SPILL_CORRUPTION",
              fields=("path", "expected", "actual"), ctor="fields",
              ladder_signal=True,
              doc="spill file failed checksum on unspill; buffer is lost"),
    # the serving classes come with the serving layer: until its modules
    # exist, a payload of theirs decodes as OpaqueWireError
    ErrorSpec("spark_rapids_tpu_torch.serving.client:WireQueryError",
              ESCALATION_SIGNAL, "WIRE_QUERY",
              fields=("batches_delivered", "retryable"), ctor="message+fields",
              ladder_signal=True,
              doc="serving-wire query failure; failover triages .retryable"),
    # --- retryable: rung-1 handles these in place --------------------------
    ErrorSpec("spark_rapids_tpu_torch.shuffle.table_meta:ChecksumError",
              RETRYABLE, "CHECKSUM", ladder_signal=True,
              doc="corrupt shuffle frame; transfer retry re-fetches"),
    ErrorSpec("spark_rapids_tpu_torch.serving.lifecycle:SchedulerDrainingError",
              RETRYABLE, "SCHEDULER_DRAINING",
              doc="replica refusing new work; redirect to a peer"),
    ErrorSpec("spark_rapids_tpu_torch.serving.lifecycle:OverloadedError",
              RETRYABLE, "OVERLOADED",
              fields=("retry_after_s",), ctor="message+fields",
              doc="front-door shed (tenant queue at bound); client honors "
                  "retry_after_s on its deterministic backoff"),
    ErrorSpec("spark_rapids_tpu_torch.serving.lifecycle:QuotaExceededError",
              RETRYABLE, "QUOTA_EXCEEDED",
              fields=("retry_after_s",), ctor="message+fields",
              doc="per-client concurrency quota hit; retry after own "
                  "queries finish — rerouting cannot help"),
    # --- cancellation: must never be retried into life ---------------------
    ErrorSpec("spark_rapids_tpu_torch.serving.lifecycle:QueryCancelledError",
              CANCELLATION, "QUERY_CANCELLED", ladder_signal=True,
              doc="caller cancelled; checkpoints re-raise, nothing retries"),
    ErrorSpec("spark_rapids_tpu_torch.serving.lifecycle:QueryTimeoutError",
              CANCELLATION, "QUERY_TIMEOUT",
              doc="deadline exceeded; treated as cancellation by the ladder"),
    # --- permanent: deterministic, retrying reproduces the failure ---------
    ErrorSpec("spark_rapids_tpu_torch.sql.lexer:SqlError",
              PERMANENT, "SQL", doc="malformed query text"),
    ErrorSpec("spark_rapids_tpu_torch.ops.regex:RegexError",
              PERMANENT, "REGEX", doc="unsupported/invalid regex pattern"),
    ErrorSpec("spark_rapids_tpu_torch.plan.catalyst_import:CatalystImportError",
              PERMANENT, "CATALYST_IMPORT", doc="unconvertible Catalyst plan"),
    ErrorSpec("spark_rapids_tpu_torch.udf.compiler:UdfCompileError",
              PERMANENT, "UDF_COMPILE", doc="UDF body not compilable"),
    ErrorSpec("spark_rapids_tpu_torch.utils.errors:OpaqueWireError",
              PERMANENT, "OPAQUE", doc="unregistered type crossed the wire"),
)

_BY_HOME: Dict[str, ErrorSpec] = {s.home: s for s in TAXONOMY}
_BY_NAME: Dict[str, ErrorSpec] = {s.name: s for s in TAXONOMY}
_BY_CODE: Dict[str, ErrorSpec] = {s.wire_code: s for s in TAXONOMY}
assert len(_BY_NAME) == len(TAXONOMY), "duplicate leaf class name in taxonomy"
assert len(_BY_CODE) == len(TAXONOMY), "duplicate wire code in taxonomy"


def ladder_signals() -> Tuple[str, ...]:
    """Leaf names of the classes whose swallowing breaks the ladder."""
    return tuple(s.name for s in TAXONOMY if s.ladder_signal)


def spec_for(exc: Any) -> Optional[ErrorSpec]:
    """Registered spec for an exception instance or class (MRO-aware:
    subclasses of a registered class inherit its spec)."""
    klass = exc if isinstance(exc, type) else type(exc)
    for base in klass.__mro__:
        spec = _BY_HOME.get(f"{base.__module__}:{base.__qualname__}")
        if spec is not None:
            return spec
    return None


def spec_by_name(name: str) -> Optional[ErrorSpec]:
    return _BY_NAME.get(name)


def classification_for(exc: Any) -> Optional[str]:
    spec = spec_for(exc)
    return spec.classification if spec is not None else None


def is_retryable(exc: Any) -> bool:
    return classification_for(exc) == RETRYABLE


def is_cancellation(exc: Any) -> bool:
    return classification_for(exc) == CANCELLATION


def resolve(spec: ErrorSpec) -> Type[BaseException]:
    """Import the spec's home module and return the class (lazy)."""
    mod = importlib.import_module(spec.module)
    return getattr(mod, spec.name)


# ---------------------------------------------------------------------------
# wire codec

def _tupled(v: Any) -> Any:
    # a JSON hop turns tuples into lists; structured fields (e.g. block
    # coordinates) are tuples in the engine, so coerce lists back on
    # decode.  Fields that rode a pickle transport (the executor-daemon
    # control socket) arrive untouched — including MapStatus/BlockId
    # namedtuples — and pass through unchanged.
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def encode_error(exc: BaseException, message: Optional[str] = None) -> dict:
    """Encode an exception for a process boundary.  Registered types carry
    their wire code + structured fields; anything else degrades to OPAQUE
    (non-retryable on the far side).  ``message`` overrides ``str(exc)`` —
    used by boundaries that want to ship a traceback.  Fields are shipped
    as-is: pickle transports keep full fidelity, JSON transports should
    serialize with ``default=str`` (exotic payloads degrade readably)."""
    spec = spec_for(exc)
    msg = message if message is not None else f"{type(exc).__name__}: {exc}"
    if spec is None:
        return {"code": "OPAQUE", "message": msg, "fields": {}}
    fields = {f: getattr(exc, f, None) for f in spec.fields}
    return {"code": spec.wire_code, "message": msg, "fields": fields}


def decode_error(payload: Any) -> BaseException:
    """Rebuild an exception from an encode_error payload.  Any malformed or
    unknown payload degrades to OpaqueWireError — never raises itself."""
    try:
        code = payload["code"]
        message = str(payload.get("message", ""))
        fields = {k: _tupled(v) for k, v in dict(payload.get("fields", {})).items()}
    except Exception:
        return OpaqueWireError(f"undecodable wire error payload: {payload!r}")
    spec = _BY_CODE.get(code)
    if spec is None:
        return OpaqueWireError(message, wire_code=code)
    try:
        klass = resolve(spec)
        if spec.ctor == "fields":
            exc = klass(**fields)
        elif spec.ctor == "message+fields":
            exc = klass(message, **fields)
        else:
            exc = klass(message)
    except Exception:
        return OpaqueWireError(message, wire_code=code)
    exc.wire_code = spec.wire_code
    return exc


# ---------------------------------------------------------------------------
# ladder boundary markers

def triage_boundary(fn):
    """Marks a function as a registered triage point of the failure ladder —
    a place that legitimately catches escalation signals and routes them
    (retry loop, recompute triage, failover decision, cancellation sink).
    No runtime behavior; tpu-lint R013/R014 read the decorator statically:
    handlers inside (or calling into) a triage boundary are exempt from the
    swallowed-signal rule, and classes arriving at one must be registered
    here."""
    fn.__ladder_triage_boundary__ = True
    return fn


#: context -> count of classified exceptions deliberately absorbed at a
#: terminal sink (cleanup/unwind paths where propagation would mask the
#: primary failure); keeps swallowed ladder signals observable
ABSORBED_COUNTS: Dict[str, int] = {}
_ABSORB_LOCK = threading.Lock()


@triage_boundary
def absorb(exc: BaseException, context: str) -> None:
    """Registered terminal triage: deliberately absorb ``exc`` on an
    unwind/cleanup path where propagating it would mask the primary
    failure (abandoning a stream, best-effort teardown).  The swallow is
    counted per (context, type) so a ladder signal dying here is still
    visible to operators — R013 accepts a handler that routes through
    this instead of silently ``pass``-ing."""
    key = f"{context}:{type(exc).__name__}"
    with _ABSORB_LOCK:
        ABSORBED_COUNTS[key] = ABSORBED_COUNTS.get(key, 0) + 1


def wire_boundary(fn):
    """Marks a function that serializes exceptions across a process boundary
    (executor-daemon control socket, serving wire).  No runtime behavior;
    tpu-lint R015 checks that every package exception type that may-raise
    into one has a registered wire code — unregistered types degrade to
    OpaqueWireError and lose their classification on the far side."""
    fn.__ladder_wire_boundary__ = True
    return fn


# ---------------------------------------------------------------------------
# lazy re-exports (PEP 562): the classes stay defined in their home modules

def __getattr__(name: str):
    spec = _BY_NAME.get(name)
    if spec is not None and spec.module != __name__:
        return resolve(spec)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_BY_NAME))
