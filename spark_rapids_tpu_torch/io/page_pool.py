"""The page decode of a parquet scan's column chunks in worker processes.

The page reader (``parquet_pages.py``, the JAX package's, byte-equal) walks
pages and RLE/bit-packed runs in Python. On one thread it set the cold wall
of a parquet scan on the H100: 27.9-29.0 s for Q1 over SF-10 lineitem
against 0.99 s in memory (``PERF.md``). Every (row group, column)
chunk decodes on its own, so worker processes, which import numpy, pyarrow
and the page reader but not torch, decode them side by side while the scan
takes the results in order: the dictionaries then unify as in a serial
read, and the batches are the same.

A worker is a ``python -c`` child reading pickled requests on its stdin and
writing pickled results on its stdout, so no user's ``__main__`` is run
again in it (as multiprocessing's spawn would). Workers are made on first
use, kept idle between scans, and lent to one scan at a time, at most one
per CPU in the process. A one-core host, or a scan that finds no worker
free, has one worker that decodes in the scan's own thread: the same loop
with one worker. ``shutdown()`` stops them (interpreter exit does too).
"""
from __future__ import annotations

import atexit
import os
import pickle
import subprocess
import sys
import threading
from collections import deque
from functools import lru_cache
from typing import Iterator, List, Sequence, Tuple

_LOCK = threading.Lock()
_IDLE: List["_Worker"] = []
_MADE = 0
#: the longest one chunk's decode may take before its worker is killed
#: and the scan fails (a chunk decodes in seconds at SF 10)
_RESULT_TIMEOUT_S = 600.0


class _Worker:
    """One decode process."""

    def __init__(self):
        import spark_rapids_tpu_torch
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(spark_rapids_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "from spark_rapids_tpu_torch.io."
             "page_pool import serve; serve()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def send(self, request) -> None:
        pickle.dump(request, self.proc.stdin, protocol=5)
        self.proc.stdin.flush()

    def recv(self):
        """The next result; a worker that dies, or gives no result within
        ``_RESULT_TIMEOUT_S`` (then it is killed), fails the scan."""
        watchdog = threading.Timer(_RESULT_TIMEOUT_S, self.proc.kill)
        watchdog.daemon = True
        watchdog.start()
        try:
            kind, value = pickle.load(self.proc.stdout)
        except EOFError:
            raise RuntimeError(
                f"page-decode worker {self.proc.pid} ended without a result "
                f"(exit code {self.proc.wait()}; killed after "
                f"{_RESULT_TIMEOUT_S:.0f} s if negative)") from None
        finally:
            watchdog.cancel()
        if kind == "err":
            raise value
        return value

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def serve() -> None:
    """A worker's loop: one result per request, until stdin closes."""
    requests, results = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr         # a print must not corrupt the stream
    while True:
        try:
            request = pickle.load(requests)
        except EOFError:
            return
        try:
            reply = ("ok", _read(*request))
        except Exception as e:  # noqa: BLE001 - raised again by the scan
            reply = ("err", e)
        pickle.dump(reply, results, protocol=5)
        results.flush()


class _Inline:
    """The one worker of a scan that gets no process: each request is
    decoded in the scan's thread when its result is taken."""

    def __init__(self, pf_metadata):
        self.md = pf_metadata
        self.requests: deque = deque()

    def send(self, request) -> None:
        self.requests.append(request)

    def recv(self):
        path, _, _, rg, ci, at, want_runs = self.requests.popleft()
        from spark_rapids_tpu_torch.io.parquet_pages import read_dict_column
        return read_dict_column(path, self.md, rg, ci, at,
                                want_runs=want_runs)


def _borrow(n: int) -> List[_Worker]:
    """Up to ``n`` workers for one scan: idle ones first, then new ones
    while the process has fewer than one per CPU; none on a one-core
    host."""
    global _MADE
    cpus = os.cpu_count() or 1
    got = []
    with _LOCK:
        while _IDLE and len(got) < n:
            got.append(_IDLE.pop())
        while cpus > 1 and len(got) < n and _MADE < cpus:
            _MADE += 1
            got.append(None)
    return [w if w is not None else _Worker() for w in got]


def _give_back(workers: List[_Worker]) -> None:
    with _LOCK:
        _IDLE.extend(workers)


def shutdown() -> None:
    """Stop the idle decode processes."""
    global _MADE
    with _LOCK:
        workers = list(_IDLE)
        _IDLE.clear()
        _MADE -= len(workers)
    for w in workers:
        w.stop()


atexit.register(shutdown)


def live_workers() -> int:
    """Decode processes made and not stopped (idle or lent to a scan)."""
    with _LOCK:
        return _MADE


@lru_cache(maxsize=64)
def _footer(path: str, mtime_ns: int, size: int):
    import pyarrow.parquet as pq
    return pq.ParquetFile(path).metadata


def _read(path: str, mtime_ns: int, size: int, rg: int, col_idx: int,
          arrow_type, want_runs: bool):
    """One chunk through the page reader (in a worker)."""
    from spark_rapids_tpu_torch.io.parquet_pages import read_dict_column
    return read_dict_column(path, _footer(path, mtime_ns, size), rg,
                            col_idx, arrow_type, want_runs=want_runs)


def read_dict_columns(path: str, pf_metadata,
                      units: Sequence[Tuple[int, int, object]],
                      want_runs: bool) -> Iterator:
    """``read_dict_column`` of every (row group, column index, arrow type)
    unit, in the order given. Unit i goes to worker i mod w, two units per
    worker in flight, so each worker's results arrive in the order they
    are taken; with no worker free the scan's thread is the one worker."""
    workers = _borrow(len(units)) if len(units) > 1 else []
    inline = not workers
    if inline:
        workers = [_Inline(pf_metadata)]
    st = os.stat(path)
    w = len(workers)
    pending: deque = deque()          # indices of units sent, not taken
    healthy = True
    try:
        for i, (rg, ci, at) in enumerate(units):
            workers[i % w].send((path, st.st_mtime_ns, st.st_size, rg, ci,
                                 at, want_runs))
            pending.append(i)
            if len(pending) >= 2 * w:
                yield workers[pending.popleft() % w].recv()
        while pending:
            yield workers[pending.popleft() % w].recv()
    except GeneratorExit:
        raise                       # an early exit: drained below
    except BaseException:
        healthy = False
        raise
    finally:
        if not inline:
            _hand_back(workers, pending, healthy)


def _hand_back(workers: List[_Worker], pending: deque,
               healthy: bool) -> None:
    """After a scan: take what is still in flight, so an idle worker holds
    no stale result, and return the workers; stop them if one failed."""
    global _MADE
    w = len(workers)
    try:
        while healthy and pending:
            workers[pending.popleft() % w].recv()
    except BaseException:  # noqa: BLE001 - the workers are dropped
        healthy = False
    if healthy:
        _give_back(workers)
        return
    with _LOCK:
        _MADE -= len(workers)
    for wk in workers:
        wk.stop()
