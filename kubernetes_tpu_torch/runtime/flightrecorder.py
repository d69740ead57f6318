"""Flight recorder: always-on bounded span ring + anomaly postmortems.

The black-box model (the aviation metaphor is exact): the scheduler
records every finished cycle's root span into a small ring buffer at
negligible cost — a deque append per cycle, no serialization — so when
an anomaly fires the seconds BEFORE it are already captured.  Anomaly
triggers (wired in runtime/scheduler.py): breaker trip, shed burst,
cycle-deadline overrun, degraded cycle, unclassified device error.
Each trigger dumps a postmortem snapshot: the ring's span trees, a
caller-supplied state dict (queue depth, breaker/AIMD state), and the
metrics registry text — everything a human needs to reconstruct the
incident without having had debug logging on.

The reference has no analog (kubelet's flight-recorder-style node
problem detector is the closest cousin); PAPERS' Gavel/RL-tuning lines
both assume exactly this per-decision timeline exists.

`RECORDER` is the process-wide default (the metrics REGISTRY pattern):
the scheduler records into it unless handed its own instance, and the
health server + apiserver serve it at /debug/traces.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.utils.trace import Span, chrome_trace


class FlightRecorder:
    """Bounded ring of finished cycle spans + bounded postmortem log.

    Thread-safe: record() is called from the scheduling thread,
    postmortem() from scheduling/event paths, readers (HTTP handlers)
    from server threads.  Postmortems are throttled PER TRIGGER
    (min_interval_s) so a shed storm produces one snapshot, not one per
    dropped pod; the first firing of each trigger always lands."""

    def __init__(
        self,
        capacity: int = 64,
        postmortem_capacity: int = 16,
        postmortem_min_interval_s: float = 0.5,
    ):
        self.capacity = int(capacity)
        self._ring: "deque[Span]" = deque(maxlen=max(1, self.capacity))
        self._postmortems: "deque[dict]" = deque(
            maxlen=max(1, int(postmortem_capacity))
        )
        self.min_interval_s = float(postmortem_min_interval_s)
        self._last_fired: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.recorded_total = 0
        self.postmortem_total = 0

    # ------------------------------------------------------------ recording

    def record(self, span: Span) -> None:
        """Retire one finished cycle span into the ring (O(1), the
        always-on cost — no serialization happens here)."""
        with self._lock:
            self._ring.append(span)
            self.recorded_total += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._postmortems.clear()
            self._last_fired.clear()

    # ----------------------------------------------------------- postmortem

    def postmortem(
        self,
        trigger: str,
        detail: str = "",
        state=None,  # dict, or a () -> dict thunk (lazy, see below)
        metrics_text: Optional[Callable[[], str]] = None,
        in_flight: Optional[List[Span]] = None,
    ) -> Optional[dict]:
        """Snapshot the ring + system state for one anomaly.  Returns the
        snapshot dict, or None when this trigger fired inside its
        throttle window (the storm case — the first snapshot already
        captured the lead-up).  `metrics_text` — and `state`, which may
        be a dict OR a thunk returning one — are evaluated only when the
        snapshot actually fires: a shed storm calls this once per
        dropped pod, and the throttled calls must not pay for a state
        snapshot they discard.  `in_flight` carries the CURRENT cycle's
        (possibly unfinished) span — a breaker trip fires mid-cycle,
        before the failing cycle retires into the ring, and the
        postmortem must still contain its spans."""
        now = time.monotonic()
        with self._lock:
            last = self._last_fired.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_fired[trigger] = now
            ring = list(self._ring)
        if callable(state):
            try:
                state = state()
            except Exception as e:  # noqa: BLE001 — never lose the snapshot
                state = {"error": f"<state unavailable: {e}>"}
        ring_ids = {sp.span_id for sp in ring}
        live = [
            sp for sp in (in_flight or ())
            if sp is not None and sp.span_id not in ring_ids
        ]
        snap = {
            "trigger": trigger,
            "detail": detail,
            "time": time.time(),
            "monotonic": now,
            "state": dict(state or {}),
            "cycles": [sp.to_dict() for sp in ring],
            "in_flight": [sp.to_dict() for sp in live],
        }
        if metrics_text is not None:
            try:
                snap["metrics"] = metrics_text()
            except Exception as e:  # noqa: BLE001 — never lose the snapshot
                snap["metrics"] = f"<metrics unavailable: {e}>"
        with self._lock:
            self._postmortems.append(snap)
            self.postmortem_total += 1
        return snap

    def postmortems(self, trigger: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._postmortems)
        if trigger is not None:
            out = [p for p in out if p["trigger"] == trigger]
        return out

    # --------------------------------------------------------------- export

    def chrome_trace(self, limit: Optional[int] = None) -> dict:
        """The ring as Chrome trace-event JSON, with one instant event
        per recorded postmortem so anomalies show up ON the timeline.
        `limit` keeps only the NEWEST n cycle spans (the /debug/traces
        ?limit=N query; the handlers also halve it until the body fits
        the hard response-size cap)."""
        spans = self.spans()
        if limit is not None and limit >= 0:
            spans = spans[-limit:] if limit else []
        out = chrome_trace(spans)
        with self._lock:
            pms = list(self._postmortems)
        for pm in pms:
            out["traceEvents"].append({
                "name": f"postmortem:{pm['trigger']}",
                "cat": "ktpu.anomaly",
                "ph": "i",
                "s": "g",  # global-scope instant: draws across all tracks
                "ts": int(pm["monotonic"] * 1e6),
                "pid": 1,
                "tid": 1,
                "args": {"detail": pm["detail"]},
            })
        return out


# process-wide default (the REGISTRY pattern in utils/metrics.py): one
# ring every component records into unless wired with its own instance.
# RECORDER stays a real module binding — callers import it by value —
# while the install/replica registry rides the shared ProcessDefault
# helper (runtime/defaults.py) like its observability siblings.
RECORDER = FlightRecorder()

from kubernetes_tpu_torch.runtime.defaults import ProcessDefault  # noqa: E402

_DEFAULT = ProcessDefault("flightrecorder")
_DEFAULT.set(RECORDER)


def get_default() -> FlightRecorder:
    return _DEFAULT.get()


def set_default(rec: FlightRecorder, replica: int = 0) -> None:
    global RECORDER
    _DEFAULT.set(rec, replica)
    if int(replica) == 0:
        RECORDER = rec


def replica_instances() -> dict:
    """{replica id: FlightRecorder} of every install this process saw."""
    return _DEFAULT.replicas()
