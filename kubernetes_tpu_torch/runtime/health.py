"""Scheduler health: the device breaker (the PyTorch port's copy of the
DeviceHealth half of the JAX package's runtime/health.py; the healthz/metrics
HTTP server is not carried).

`DeviceHealth` is the circuit breaker over the accelerator datapath
(codec/faults.py classifies the errors, the scheduler wires the policy).
The reference has no analog — its scheduler never loses a backend — but the
Borg/Omega lineage in PAPERS.md keeps serving through partial infrastructure
failure.  The port's Scheduler runs it with cpu_fallback off: a tripped
breaker requeues the batch and raises instead of degrading to a CPU engine.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from kubernetes_tpu_torch.codec.faults import FAULT_PERSISTENT
from kubernetes_tpu_torch.utils import metrics as m

# breaker states (classic Nygard circuit-breaker vocabulary)
BREAKER_CLOSED = "closed"        # device path live
BREAKER_OPEN = "open"            # device path disabled; CPU degraded mode
BREAKER_HALF_OPEN = "half_open"  # cool-down elapsed; one canary batch allowed

_STATE_GAUGE = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 1.0, BREAKER_OPEN: 2.0}


class DeviceHealth:
    """Classified-failure circuit breaker for the device datapath.

    Policy (wired by runtime/scheduler.py from SchedulerConfig knobs):

      * transient faults retry the same in-flight batch with jittered
        exponential backoff (`backoff_s`); `failure_threshold` CONSECUTIVE
        classified failures trip the breaker;
      * a persistent fault (device lost) trips it immediately;
      * while OPEN, `allow_device()` is False until `open_duration_s`
        elapses, then the state moves to HALF_OPEN and exactly the next
        cycle runs on device as a canary: success closes the breaker
        (fast path restored), any failure re-opens it.

    Single-scheduling-thread invariant: like DeviceSnapshotCache, this
    object is only mutated from the scheduling thread (dispatch/fence/
    preempt all run there), so state transitions need no lock; reads from
    other threads (healthz) see a consistent-enough snapshot.

    `clock` and the seeded rng keep tests deterministic."""

    def __init__(
        self,
        failure_threshold: int = 3,
        open_duration_s: float = 0.05,
        backoff_base_s: float = 0.005,
        backoff_max_s: float = 0.05,
        backoff_jitter: float = 0.5,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
        transitions_maxlen: int = 256,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_duration_s = float(open_duration_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_jitter = float(backoff_jitter)
        self._rng = random.Random(seed)
        self._clock = clock
        self._on_transition = on_transition
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.fault_counts: Dict[str, int] = {}
        # (from, to) audit trail — the breaker's transition history, pinned
        # by the chaos tests (open -> half_open -> closed on recovery).
        # BOUNDED: a flapping device transitions forever, and a long-lived
        # scheduler must not leak memory for it — the deque keeps the
        # recent window for postmortems while the UNBOUNDED record is the
        # scheduler_device_breaker_transitions_total counter family.
        self.transitions: deque = deque(maxlen=max(1, int(transitions_maxlen)))
        self.probes = 0  # half-open canary batches granted
        self._opened_at = 0.0
        # NB: the gauge is only written on TRANSITIONS (its zero-value
        # default already means closed): constructing a second
        # DeviceHealth must not reset another instance's exported state.
        # With multiple schedulers in one process the unlabeled gauge is
        # last-writer-wins; the per-instance truth lives in .state.

    # ------------------------------------------------------------ queries

    @property
    def device_available(self) -> bool:
        """Non-mutating: is the fast path currently trusted?  (allow_device
        may transition open->half_open; this never does — preemption and
        other secondary device users key off it so they cannot consume the
        canary probe.)"""
        return self.state == BREAKER_CLOSED

    def allow_device(self) -> bool:
        """Gate for the next scheduling cycle's engine choice.  CLOSED:
        yes.  OPEN: no, until the cool-down elapses — then HALF_OPEN and
        yes (the canary).  HALF_OPEN: yes (at most one cycle is in flight
        on the single scheduling thread)."""
        if self.state == BREAKER_OPEN and (
            self._clock() - self._opened_at >= self.open_duration_s
        ):
            self._transition(BREAKER_HALF_OPEN)
        if self.state == BREAKER_HALF_OPEN:
            self.probes += 1
            return True
        return self.state == BREAKER_CLOSED

    # ------------------------------------------------------------ updates

    def record_failure(self, fault_class: str) -> bool:
        """Account one classified device failure; returns True when the
        breaker is OPEN afterwards (callers stop retrying and degrade)."""
        self.consecutive_failures += 1
        self.fault_counts[fault_class] = (
            self.fault_counts.get(fault_class, 0) + 1
        )
        if (
            self.state == BREAKER_HALF_OPEN           # canary failed
            or fault_class == FAULT_PERSISTENT        # device lost
            or self.consecutive_failures >= self.failure_threshold
        ):
            self.trip()
        return self.state == BREAKER_OPEN

    def record_success(self) -> None:
        """A device cycle completed: reset the failure streak; a HALF_OPEN
        canary success restores the fast path."""
        self.consecutive_failures = 0
        if self.state != BREAKER_CLOSED:
            self._transition(BREAKER_CLOSED)

    def trip(self) -> None:
        """Force the breaker OPEN and (re)start the cool-down clock."""
        if self.state != BREAKER_OPEN:
            self._transition(BREAKER_OPEN)
        self._opened_at = self._clock()

    def backoff_s(self, attempt: int) -> float:
        """Jittered exponential backoff for transient-retry `attempt`
        (0-based).  Jitter is additive-proportional (delay * [1, 1+j]) from
        the seeded rng; the cap applies AFTER jitter so no sleep ever
        exceeds backoff_max_s (the fault-matrix tests run inside tier-1)."""
        base = self.backoff_base_s * (2.0 ** attempt)
        jittered = base * (1.0 + self.backoff_jitter * self._rng.random())
        return min(jittered, self.backoff_max_s)

    def _transition(self, to: str) -> None:
        frm, self.state = self.state, to
        self.transitions.append((frm, to))
        m.BREAKER_STATE.set(_STATE_GAUGE[to])
        m.BREAKER_TRANSITIONS.inc(to=to)
        if self._on_transition is not None:
            self._on_transition(frm, to)
