"""Event recording: the client-go tools/record analog.

The reference emits Kubernetes Events as the user-visible audit trail —
"Scheduled" on success (scheduler.go:268), "FailedScheduling" on fit errors
(:433), "Preempted" per victim (:325) — via an EventRecorder that aggregates
repeats (correlator semantics: same (object, reason, message) increments a
count instead of appending).  This recorder keeps a bounded in-memory log
queryable by object, the standalone analog of the events API.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"


@dataclass
class Event:
    kind: str           # involved object kind ("Pod", "Node")
    namespace: str
    name: str
    type: str           # Normal | Warning
    reason: str         # Scheduled | FailedScheduling | Preempted | ...
    message: str
    count: int = 1
    first_timestamp: float = field(default_factory=time.time)
    last_timestamp: float = field(default_factory=time.time)
    # tracing join key (utils/trace.py): the scheduling-cycle trace id
    # that produced this event, "" when the emitter carried no context —
    # what makes one decision joinable across cycle span / bind / event
    trace_id: str = ""


class EventRecorder:
    """Thread-safe aggregating recorder (tools/record EventAggregator): a
    repeat of (object, type, reason, message) bumps count/last_timestamp."""

    def __init__(self, max_events: int = 10000):
        self._lock = threading.Lock()
        self._by_key: Dict[Tuple, Event] = {}
        self._order: List[Tuple] = []
        self._max = max_events

    def _record_locked(self, key: Tuple, now: float,
                       trace_id: str = "") -> Event:
        """Aggregate-or-append one event; the caller holds self._lock.
        `key` is (kind, namespace, name, type_, reason, msg) — the Event
        constructor's field order.  trace_id is NOT part of the
        aggregation key (a repeat from a later cycle still aggregates);
        the LATEST non-empty id wins, pointing at the freshest cycle."""
        ev = self._by_key.get(key)
        if ev is not None:
            ev.count += 1
            ev.last_timestamp = now
            if trace_id:
                ev.trace_id = trace_id
            return ev
        ev = Event(*key, trace_id=trace_id)
        self._by_key[key] = ev
        self._order.append(key)
        while len(self._order) > self._max:
            old = self._order.pop(0)
            self._by_key.pop(old, None)
        return ev

    def eventf(
        self,
        kind: str,
        namespace: str,
        name: str,
        type_: str,
        reason: str,
        message_fmt: str,
        *args,
        trace_id: str = "",
    ) -> Event:
        msg = message_fmt % args if args else message_fmt
        with self._lock:
            return self._record_locked(
                (kind, namespace, name, type_, reason, msg), time.time(),
                trace_id=trace_id,
            )

    def eventf_batch(self, entries) -> None:
        """Record many pre-formatted events under ONE lock acquisition (the
        batched commit path emits a whole cycle's audit trail at once).
        entries: iterable of (kind, namespace, name, type_, reason, msg)
        or 7-tuples with a trailing trace_id, msg already formatted.
        Aggregation semantics identical to per-event eventf calls in the
        same order."""
        now = time.time()
        with self._lock:
            for entry in entries:
                entry = tuple(entry)
                trace_id = ""
                if len(entry) == 7:
                    entry, trace_id = entry[:6], entry[6]
                self._record_locked(entry, now, trace_id=trace_id)

    def events(
        self,
        namespace: Optional[str] = None,
        name: Optional[str] = None,
        reason: Optional[str] = None,
    ) -> List[Event]:
        with self._lock:
            out = [self._by_key[k] for k in self._order if k in self._by_key]
        if namespace is not None:
            out = [e for e in out if e.namespace == namespace]
        if name is not None:
            out = [e for e in out if e.name == name]
        if reason is not None:
            out = [e for e in out if e.reason == reason]
        return out
