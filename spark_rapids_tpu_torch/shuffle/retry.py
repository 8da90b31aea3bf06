"""Retry/backoff schedule shared by every layer of the shuffle stack.

Reference analog: Spark's RetryingBlockTransferor (network-shuffle) — a
bounded number of retries with a backoff between attempts. Two deltas for
this engine:

- **deterministic jitter**: attempt i of key k sleeps
  ``base * 2^i * (0.5 + u)`` where ``u`` is drawn from a PRNG seeded by
  ``(seed, key, i)``. Reducers retrying against one recovering peer spread
  out (no stampede), yet a fixed seed replays the exact same schedule —
  the property the fault-injection tests assert on.
- **off-thread re-issue**: transports complete transactions on their
  progress threads; sleeping there would head-of-line-block every other
  completion. ``call_later`` runs the retry continuation on a daemon timer
  thread instead.
"""
from __future__ import annotations

import random
import threading
from typing import Callable, List

#: retries are meant for *transient* faults; one attempt never waits more
#: than this regardless of the exponential schedule (10 s)
MAX_BACKOFF_MS = 10_000.0


def backoff_ms(attempt: int, base_ms: float, seed: int = 0,
               key: str = "") -> float:
    """Delay in milliseconds before retry ``attempt`` (0-based: the delay
    between the initial try and the first retry is attempt 0)."""
    rng = random.Random(f"{seed}:{key}:{attempt}")
    raw = base_ms * (2 ** attempt) * (0.5 + rng.random())
    return min(raw, MAX_BACKOFF_MS)


def backoff_schedule(max_retries: int, base_ms: float, seed: int = 0,
                     key: str = "") -> List[float]:
    """The full delay schedule (milliseconds) for ``max_retries`` retries."""
    return [backoff_ms(i, base_ms, seed, key) for i in range(max_retries)]


def call_later(delay_ms: float, fn: Callable[[], None]) -> threading.Timer:
    """Run ``fn`` after ``delay_ms`` on a daemon timer thread — never on the
    caller (which is typically a transport progress/reader thread that must
    keep draining completions)."""
    t = threading.Timer(max(delay_ms, 0.0) / 1e3, fn)
    t.daemon = True
    t.start()
    return t
