"""Resource-lifetime helpers: deterministic close and reference counting for
what the garbage collector does not release in time (spillable buffers and
their host and disk payloads). The port's copy of the JAX package's
``utils/arm.py``."""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterable, Iterator


@contextlib.contextmanager
def closing_on_except(resource: Any) -> Iterator[Any]:
    """Close ``resource`` only if the body raises."""
    try:
        yield resource
    except BaseException:
        with contextlib.suppress(Exception):
            resource.close()
        raise


def close_all(resources: Iterable[Any]) -> None:
    """Close every resource; re-raise the first error after trying all."""
    first_err = None
    for r in resources:
        try:
            if r is not None:
                r.close()
        except Exception as e:  # noqa: BLE001 - collect and re-raise first
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


class Retainable:
    """Reference-counted resource. Subclasses override ``_on_release``.

    Constructed with refcount 1; ``retain`` adds one; ``close`` drops one and
    the final drop calls ``_on_release``. A close past zero raises.
    """

    def __init__(self) -> None:
        self._refcount = 1
        self._lock = threading.Lock()

    def retain(self) -> "Retainable":
        with self._lock:
            if self._refcount <= 0:
                raise ValueError(f"retain() after close: {self!r}")
            self._refcount += 1
        return self

    @property
    def refcount(self) -> int:
        with self._lock:
            return self._refcount

    def close(self) -> None:
        with self._lock:
            if self._refcount <= 0:
                raise ValueError(f"double close: {self!r}")
            self._refcount -= 1
            release = self._refcount == 0
        if release:
            self._on_release()

    def _on_release(self) -> None:
        pass

    def __enter__(self) -> "Retainable":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
