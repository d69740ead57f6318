"""Structured tracing: span trees, cross-component context, Chrome export.

Grew out of the utiltrace analog (ref vendor/k8s.io/utils/trace/trace.go:
30-90, the dump-only-if-slow step list the reference wraps around every
scheduling cycle with a 100ms threshold, generic_scheduler.go:185-186).
That string dump answered "was this cycle slow?"; it could not answer
"WHICH phase of which cycle stalled, and what did the neighbors look
like?" — the question every perf PR and every breaker-trip postmortem
actually asks.  This module is the structured replacement:

  * `Span` — a named, attributed interval on the monotonic clock with
    child spans; the scheduler wraps every cycle in a root span with one
    child per phase (encode / dispatch / fetch / fetch_block / commit /
    bind-tail / preempt), annotated with batch width, dirty-row count,
    breaker state, and retry class.  finish() is thread-safe and
    idempotent (the async-fetch worker may race the scheduling thread).
  * trace context — every root span mints a 16-byte trace id, carried
    across component boundaries as a W3C `traceparent` header
    (00-<trace>-<span>-01) via a thread-local (`use_traceparent` /
    `current_traceparent`), so one scheduling decision is joinable end
    to end: cycle span -> apiserver bind -> extender round-trip ->
    Scheduled event.
  * Chrome `trace_event` export — `chrome_trace(spans)` emits the JSON
    object format Perfetto / chrome://tracing load directly; served at
    `/debug/traces` (runtime/health.py, apiserver/server.py) and written
    by `bench.py --trace-out`.

Device-side profiling (jax.profiler) composes with these host spans via
codec/transfer.device_annotation; this module stays dependency-free.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("kubernetes_tpu")

# the W3C Trace Context header (https://www.w3.org/TR/trace-context/);
# email.Message header lookup on the server side is case-insensitive
TRACEPARENT_HEADER = "Traceparent"


def _gen_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """version 00, sampled flag on — the only form this plane emits."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: str) -> Optional[Tuple[str, str]]:
    """-> (trace_id, span_id), or None for a missing/malformed header.
    Tolerant of future versions (parse by position, not version byte)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 3:
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


def trace_id_of(header: str) -> str:
    """Trace id from a traceparent header, or "" — the joinable key that
    gets stamped into events and bind annotations."""
    parsed = parse_traceparent(header)
    return parsed[0] if parsed else ""


# ------------------------------------------------------- thread-local context
#
# The propagation seam: outbound HTTP helpers (client/reflector
# _auth_headers, extender/client._http_post) read the CURRENT traceparent
# and attach it; the scheduler sets it around each cycle's extender
# fan-out and commit tail.  Stored as the formatted string, not the Span —
# worker threads (the extender thread pool) re-enter with the captured
# string, never the mutable span object.

_ctx = threading.local()


def current_traceparent() -> str:
    return getattr(_ctx, "header", "")


def current_trace_id() -> str:
    return trace_id_of(current_traceparent())


class use_traceparent:
    """Context manager installing a traceparent as this thread's current
    trace context (accepts a header string or a Span); restores the
    previous value on exit so nested cycles/pools compose."""

    def __init__(self, ctx):
        self._header = (
            ctx.traceparent() if isinstance(ctx, Span) else (ctx or "")
        )
        self._prev = ""

    def __enter__(self) -> "use_traceparent":
        self._prev = getattr(_ctx, "header", "")
        _ctx.header = self._header
        return self

    def __exit__(self, *exc) -> None:
        _ctx.header = self._prev


# ------------------------------------------------------------------- the span


class Span:
    """One named interval with attributes and child spans.

    Times are time.monotonic() floats.  Mutation is lock-guarded because
    the async-fetch worker can annotate/finish a child while the
    scheduling thread appends siblings; reads for export take a shallow
    snapshot under the same lock.  finish() is idempotent — the first
    end time wins, so a late duplicate (error path + finally) is safe."""

    __slots__ = (
        "name", "attrs", "trace_id", "span_id", "parent_id",
        "start", "end", "children", "_lock",
    )

    def __init__(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: str = "",
        start: Optional[float] = None,
        **attrs,
    ):
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs)
        self.trace_id = trace_id or _gen_id(16)
        self.span_id = _gen_id(8)
        self.parent_id = parent_id
        self.start = time.monotonic() if start is None else float(start)
        self.end: Optional[float] = None
        self.children: List["Span"] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ building

    def child(self, name: str, **attrs) -> "Span":
        """Start a child span NOW (same trace id, this span as parent)."""
        sp = Span(name, trace_id=self.trace_id, parent_id=self.span_id,
                  **attrs)
        with self._lock:
            self.children.append(sp)
        return sp

    def add_child(self, name: str, start: float, end: float,
                  **attrs) -> "Span":
        """Attach an already-measured child window (e.g. the async D2H
        fetch, whose start/end were stamped on the fetch worker)."""
        sp = Span(name, trace_id=self.trace_id, parent_id=self.span_id,
                  start=start, **attrs)
        sp.end = float(end)
        with self._lock:
            self.children.append(sp)
        return sp

    def annotate(self, **attrs) -> "Span":
        with self._lock:
            self.attrs.update(attrs)
        return self

    def finish(self, end: Optional[float] = None) -> "Span":
        """Close the span (idempotent, thread-safe): the FIRST end time
        sticks.  Open children are closed at the same instant so a
        crashed phase can't leave a dangling open interval."""
        t = time.monotonic() if end is None else float(end)
        with self._lock:
            if self.end is None:
                self.end = t
            kids = list(self.children)
        for c in kids:
            if c.end is None:
                c.finish(self.end)
        return self

    # ------------------------------------------------------------- queries

    @property
    def finished(self) -> bool:
        return self.end is not None

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    # -------------------------------------------------------------- export

    def to_dict(self) -> dict:
        """Nested plain-dict form (the flight-recorder postmortem body)."""
        with self._lock:
            kids = list(self.children)
            attrs = dict(self.attrs)
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": round(self.duration * 1000, 3),
            "attrs": attrs,
            "children": [c.to_dict() for c in kids],
        }

    def chrome_events(self, pid: int = 1, tid: int = 1) -> List[dict]:
        """This span tree as Chrome trace_event "X" (complete) events —
        the format chrome://tracing and Perfetto load.  ts/dur are in
        MICROSECONDS on the process monotonic clock (consistent within
        one export, which is all the viewers require); an unfinished
        span exports up to "now" so a live dump is still loadable."""
        with self._lock:
            kids = list(self.children)
            attrs = dict(self.attrs)
        end = self.end if self.end is not None else time.monotonic()
        out = [{
            "name": self.name,
            "cat": "ktpu",
            "ph": "X",
            "ts": int(self.start * 1e6),
            "dur": max(int((end - self.start) * 1e6), 1),
            "pid": pid,
            "tid": tid,
            "args": {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                **{k: _jsonable(v) for k, v in attrs.items()},
            },
        }]
        for c in kids:
            out.extend(c.chrome_events(pid=pid, tid=tid))
        return out

    def find(self, name: str) -> Optional["Span"]:
        """First descendant (or self) with this name — test convenience."""
        if self.name == name:
            return self
        with self._lock:
            kids = list(self.children)
        for c in kids:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    # ------------------------------------------------------------- logging

    def log_if_long(self, threshold_s: float) -> None:
        """The utiltrace contract on the span tree: one structured log
        line per over-threshold root span, children as +offset steps."""
        total = self.duration
        if total < threshold_s:
            return
        parts = [
            f'"{self.name}" trace={self.trace_id} {self.attrs} '
            f"(total {total * 1000:.1f}ms):"
        ]
        with self._lock:
            kids = list(self.children)
        for c in kids:
            parts.append(
                f"  +{(c.start - self.start) * 1000:.1f}ms {c.name} "
                f"({c.duration * 1000:.1f}ms)"
            )
        logger.info("\n".join(parts))


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def chrome_trace(spans) -> dict:
    """Finished spans -> the Chrome trace JSON OBJECT format (Perfetto
    and chrome://tracing both accept it; the bare-array format has no
    room for displayTimeUnit)."""
    events: List[dict] = []
    for sp in spans:
        events.extend(sp.chrome_events())
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------- legacy shim


class Trace:
    """The original dump-only-if-slow step timer, now a thin veneer over
    Span (steps become zero-width children).  Kept for callers that want
    utiltrace ergonomics without managing a span tree."""

    def __init__(self, name: str, **fields):
        self.span = Span(name, **fields)

    @property
    def name(self) -> str:
        return self.span.name

    @property
    def fields(self) -> dict:
        return self.span.attrs

    def step(self, msg: str) -> None:
        t = time.monotonic()
        self.span.add_child(msg, t, t)

    def total(self) -> float:
        return self.span.duration

    def log_if_long(self, threshold_s: float) -> None:
        self.span.finish()
        self.span.log_if_long(threshold_s)
