"""Process-default singleton registry.

Every observability layer grew the same copy-pasted tail: a module
global serving `/debug/*` when nothing was wired explicitly, a
`set_default(obj, replica=0)` install where replica 0 wins the global,
and a `replica_instances()` roll-up for `/debug/replicas` (the
per-replica discipline).  Six modules reimplemented it — flightrecorder
RECORDER, telemetry HUB, perfobs OBSERVATORY, quality QUALITY, capacity
CAPACITY, ledger LEDGER — each with its own replicas dict and its own
replica-0-wins rule.  `ProcessDefault` is that pattern once: the owning
module keeps its public `get_default`/`set_default`/`replica_instances`
signatures (callers never see this class) and delegates the state here.

The timeline store (runtime/timeline.py) registers through this helper
from day one instead of growing a seventh copy.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional


class ProcessDefault:
    """One process-wide default instance + the per-replica install
    registry behind it.

    - `get()` returns the current default, lazily constructing it via
      `factory` when none was installed (modules whose default may
      legitimately be absent — the autoscaler — pass no factory and get
      None back).
    - `set(obj, replica=0)` registers `obj` under its replica id;
      replica 0 wins the process default (single-scheduler behavior
      unchanged, sibling replicas register alongside for the
      /debug/replicas aggregate).
    - `replicas()` returns {replica id: instance}, sorted.
    """

    def __init__(self, name: str,
                 factory: Optional[Callable[[], Any]] = None) -> None:
        self.name = name
        self._factory = factory
        self._lock = threading.Lock()
        self._default: Any = None
        self._replicas: Dict[int, Any] = {}

    def get(self) -> Any:
        with self._lock:
            if self._default is None and self._factory is not None:
                self._default = self._factory()
            return self._default

    def set(self, obj: Any, replica: int = 0) -> None:
        with self._lock:
            self._replicas[int(replica)] = obj
            if int(replica) == 0:
                self._default = obj

    def reset(self) -> None:
        """Forget the default and every install (a test that built a
        Scheduler leaves nothing behind for the next)."""
        with self._lock:
            self._default = None
            self._replicas.clear()

    def replicas(self) -> Dict[int, Any]:
        """{replica id: instance} of every install this process saw."""
        with self._lock:
            return dict(sorted(self._replicas.items()))
