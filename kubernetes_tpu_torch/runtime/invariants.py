"""Online invariant checker: conservation proofs across every failure path.

The resilience stack (PRs 3/4/9/10) promises "popped pods are never
lost" on every path — retry, breaker trip, CPU degrade, mesh shrink,
gang demotion, bind failure, shed storm.  Each path carries its own
requeue guard, but the promise itself was only checked by test
assertions AFTER a scenario ran.  This module makes it a LIVE property:
a cheap, always-on checker fed from the existing commit seams, so a
chaos soak over the whole degradation ladder is pass/fail by
construction ("zero `scheduler_invariant_violations_total`") instead of
a per-scenario bookkeeping exercise.

Rules (the `rule` label on the metric):

  conservation  every pod popped from the scheduling queue ends in
                EXACTLY one of bound / requeued / shed — resolved twice,
                or re-popped while an earlier pop is unresolved, is a
                violation.  (Unschedulable verdicts requeue — the
                unschedulableQ — so "requeued" covers both.)
  double_bind   a pod reported bound while the checker still holds it
                bound from an earlier cycle (no intervening requeue/
                removal): the double-charge bug class the gang recovery
                path is guarded against.
  capacity      committed per-node usage exceeds allocatable on a row a
                cycle just committed to (checked only over the rows the
                cycle touched, so the check is O(batch), not O(N)).
  lost_pod      assert_drained() found popped-but-unresolved pods after
                the queue and pipeline drained — the direct "pods went
                missing" detector chaos soaks call at teardown.

Violations never raise into the scheduling loop: each one increments
scheduler_invariant_violations_total{rule=}, records into a bounded
ring, and fires the scheduler's flight-recorder postmortem seam — a
checker must report corruption, not add a crash path to it.

The checker deliberately tracks only pods it saw popped (note_popped):
direct schedule_cycle() callers and informer-driven re-adds resolve
keys the checker never registered, and those are ignored rather than
misread as violations.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils import metrics as m

RULE_CONSERVATION = "conservation"
RULE_DOUBLE_BIND = "double_bind"
RULE_CAPACITY = "capacity"
RULE_LOST_POD = "lost_pod"
# autoscaler actuation rules (runtime/autoscaler.py)
RULE_NODE_LIFECYCLE = "node_lifecycle"
RULE_EVICTION_BUDGET = "eviction_budget"
RULE_CAPACITY_FLOOR = "capacity_floor"

# node lifecycle states (the RULE_NODE_LIFECYCLE vocabulary): every
# node REGISTERED by an actuation must end active, drained (rolled
# back to service counts as active), or removed — a node stuck
# mid-transition at settle time is the autoscaler's lost-pod analog
NODE_REGISTERED = "registered"
NODE_ACTIVE = "active"
NODE_DRAINING = "draining"
NODE_REMOVED = "removed"

# resolution kinds for a popped pod (the conservation vocabulary)
RES_BOUND = "bound"
RES_REQUEUED = "requeued"
RES_SHED = "shed"

# small slack over the engines' f32 arithmetic: the encoder accumulates
# requests in float32, so exact <= comparisons would fire on rounding
_CAPACITY_EPS = 1e-3
_CAPACITY_REL = 1e-5


class InvariantChecker:
    """The always-on conservation checker (see module docstring).

    Thread-safe: the scheduling thread feeds pops/requeues/capacity,
    while binds may arrive from waiting-pod threads and sheds from any
    add() caller; one lock guards the tracking maps.  Cost per event is
    a dict operation — the perf budget rides the existing <2%-of-cycle
    telemetry pin."""

    def __init__(
        self,
        on_violation: Optional[Callable[[str, str], None]] = None,
        max_tracked: int = 65536,
        violations_maxlen: int = 256,
    ):
        self._lock = threading.Lock()
        self._on_violation = on_violation
        self._max_tracked = max(16, int(max_tracked))
        # pod key -> [cycle, resolution-or-None]; insertion-ordered so
        # resolved entries age out at the cap (unresolved entries are
        # exactly what assert_drained must keep)
        self._tracked: "OrderedDict[Tuple[str, str], List]" = OrderedDict()
        # unresolved-entry count, maintained incrementally: summary()
        # runs on the per-cycle telemetry seam, so it must be O(1), not
        # an O(tracked) scan (the <2%-of-cycle telemetry pin)
        self._outstanding = 0
        # pod key -> node for pods the scheduler believes bound
        self._bound: "OrderedDict[Tuple[str, str], str]" = OrderedDict()
        self.violations: deque = deque(maxlen=max(1, int(violations_maxlen)))
        self.counts: Dict[str, int] = {}
        self.events_total = 0
        # violations recorded under the lock, fired to on_violation AFTER
        # it is released: the callback is the scheduler's postmortem seam,
        # whose state dump re-enters summary() — invoking it with the
        # (non-reentrant) lock held would deadlock the scheduling thread
        # on the first real violation
        self._pending_cb: List[Tuple[str, str]] = []
        # node name -> lifecycle state for nodes an actuation registered
        # or is draining (RULE_NODE_LIFECYCLE); counts maintained
        # incrementally so summary() stays O(1)
        self._node_state: Dict[str, str] = {}
        self._node_counts: Dict[str, int] = {}

    # ------------------------------------------------------------- seams

    @staticmethod
    def _key(pod) -> Tuple[str, str]:
        return (pod.namespace, pod.name)

    def note_popped(self, pods, cycle: int = 0) -> None:
        """A batch left the queue (run_once / the express lane): each pod
        must come back through exactly one resolution seam."""
        if not pods:
            return
        with self._lock:
            self.events_total += len(pods)
            for pod in pods:
                key = self._key(pod)
                entry = self._tracked.get(key)
                if entry is not None and entry[1] is None:
                    self._violation_locked(
                        RULE_CONSERVATION,
                        f"pod {key[0]}/{key[1]} popped again while its "
                        f"cycle-{entry[0]} pop is unresolved",
                    )
                # a re-popped pod was requeued: whatever bind the checker
                # still holds was forgotten by the rollback path
                self._bound.pop(key, None)
                if entry is None or entry[1] is not None:
                    self._outstanding += 1
                self._tracked[key] = [cycle, None]
                self._tracked.move_to_end(key)
            self._prune_locked()
        self._fire_callbacks()

    def note_bound(self, pod, node: str = "") -> None:
        """A bind succeeded (batched tail / per-pod / gang / async
        waiting-pod completion)."""
        key = self._key(pod)
        with self._lock:
            self.events_total += 1
            if key in self._bound:
                self._violation_locked(
                    RULE_DOUBLE_BIND,
                    f"pod {key[0]}/{key[1]} bound to {node or '?'} while "
                    f"already bound to {self._bound[key] or '?'}",
                )
            self._bound[key] = node
            while len(self._bound) > self._max_tracked:
                self._bound.popitem(last=False)
            self._resolve_locked(key, RES_BOUND)
        self._fire_callbacks()

    def note_requeued(self, pod) -> None:
        """The pod went back into the queue (unschedulable verdict, bind
        failure rollback, gang surplus readd, batch-loss guard)."""
        key = self._key(pod)
        with self._lock:
            self.events_total += 1
            self._bound.pop(key, None)
            self._resolve_locked(key, RES_REQUEUED)
        self._fire_callbacks()

    def note_shed(self, pod) -> None:
        """The bounded queue dropped the pod (overload shedding)."""
        key = self._key(pod)
        with self._lock:
            self.events_total += 1
            entry = self._tracked.get(key)
            if entry is not None and entry[1] is None:
                # a popped pod is not IN the queue, so the queue shedding
                # it means double-tracking — still record the resolution
                # so drain checks stay meaningful
                self._violation_locked(
                    RULE_CONSERVATION,
                    f"pod {key[0]}/{key[1]} shed while popped",
                )
            if entry is not None:
                # shed ends the pod's life in this control plane: drop
                # the entry so a same-name re-create starts clean
                if entry[1] is None:
                    self._outstanding -= 1
                del self._tracked[key]
            self._bound.pop(key, None)
        self._fire_callbacks()

    def note_displaced(self, pod) -> None:
        """A BOUND pod was displaced back toward the queue by a
        cluster-lifecycle event (NodeLifecycleController eviction, a
        drain wave, a zone outage): clear the bound mark and drop the
        tracked entry so the shed-exempt displaced requeue is NOT
        misread as "resolved twice: bound then requeued" and the pod's
        next pop opens a fresh conservation window.  Mass eviction is a
        legal lifecycle transition, not a conservation bug — the rules
        resume the moment the displaced pod is popped again."""
        key = self._key(pod)
        with self._lock:
            self.events_total += 1
            self._bound.pop(key, None)
            entry = self._tracked.pop(key, None)
            if entry is not None and entry[1] is None:
                self._outstanding -= 1

    def note_removed(self, pod) -> None:
        """The pod left the cluster entirely (preemption victim delete,
        informer delete): clear every mark so a same-name successor
        starts clean."""
        key = self._key(pod)
        with self._lock:
            self._bound.pop(key, None)
            entry = self._tracked.pop(key, None)
            if entry is not None and entry[1] is None:
                self._outstanding -= 1

    def check_capacity(self, rows, requested, allocatable,
                       row_name=None) -> None:
        """Committed usage <= allocatable over the node rows a cycle just
        committed to.  `requested`/`allocatable` are the encoder's f32
        [N, R] arrays (read under the cache lock by the caller); `rows`
        the touched row indices."""
        if len(rows) == 0:
            return
        rows = np.asarray(rows, np.int64)
        req = np.asarray(requested)[rows]
        alloc = np.asarray(allocatable)[rows]
        # only columns with declared capacity: PodFitsResources compares
        # per-requested-resource (used + req <= alloc), so committed
        # usage in an undeclared (zero-allocatable) column is always 0 —
        # comparing it would only trip the checker on float dust
        over = (req > alloc * (1.0 + _CAPACITY_REL) + _CAPACITY_EPS) & (
            alloc > 0.0
        )
        with self._lock:
            self.events_total += 1
        if not over.any():
            return
        bad_rows = rows[np.flatnonzero(over.any(axis=1))]
        names = [
            (row_name(int(r)) if row_name is not None else str(int(r)))
            for r in bad_rows[:4]
        ]
        with self._lock:
            self._violation_locked(
                RULE_CAPACITY,
                f"committed usage exceeds allocatable on {len(bad_rows)} "
                f"node(s): {', '.join(names)}",
            )
        self._fire_callbacks()

    def assert_drained(self) -> bool:
        """After the queue AND pipeline drained, no popped pod may still
        be unresolved.  Returns True when clean; on failure records ONE
        lost_pod violation naming a sample and clears the stale entries
        (so a soak's next phase is judged on its own)."""
        with self._lock:
            lost = [k for k, e in self._tracked.items() if e[1] is None]
            if not lost:
                return True
            sample = ", ".join(f"{ns}/{n}" for ns, n in lost[:4])
            self._violation_locked(
                RULE_LOST_POD,
                f"{len(lost)} popped pod(s) unresolved after drain: "
                f"{sample}",
            )
            for k in lost:
                del self._tracked[k]
            self._outstanding -= len(lost)
        self._fire_callbacks()
        return False

    # --------------------------------------- autoscaler seams

    def _node_set_locked(self, name: str, state: Optional[str]) -> None:
        old = self._node_state.pop(name, None)
        if old is not None:
            self._node_counts[old] -= 1
            if not self._node_counts[old]:
                del self._node_counts[old]
        if state is not None:
            self._node_state[name] = state
            self._node_counts[state] = self._node_counts.get(state, 0) + 1

    def note_node_registered(self, name: str) -> None:
        """An actuation registered a node into the store (scale-up).
        It must be reported active (schedulable), draining, or removed
        before assert_nodes_settled — a registered node that vanishes
        from the seams is leaked capacity."""
        with self._lock:
            self.events_total += 1
            if self._node_state.get(name) in (NODE_REGISTERED,
                                              NODE_ACTIVE, NODE_DRAINING):
                self._violation_locked(
                    RULE_NODE_LIFECYCLE,
                    f"node {name} registered while already "
                    f"{self._node_state[name]}",
                )
            self._node_set_locked(name, NODE_REGISTERED)
        self._fire_callbacks()

    def note_node_active(self, name: str) -> None:
        """The node is serving (registered node confirmed schedulable,
        or a drain rolled back to service)."""
        with self._lock:
            self.events_total += 1
            self._node_set_locked(name, NODE_ACTIVE)

    def note_node_draining(self, name: str) -> None:
        """A scale-down cordoned the node; it must end removed or be
        rolled back to active."""
        with self._lock:
            self.events_total += 1
            self._node_set_locked(name, NODE_DRAINING)

    def note_node_removed(self, name: str) -> None:
        """The node left the store (drain completed + delete, or a
        faulted scale-up batch deregistered): terminal, clears the
        entry so a same-name re-registration starts clean."""
        with self._lock:
            self.events_total += 1
            if name in self._node_state:
                self._node_set_locked(name, None)
        self._fire_callbacks()

    def assert_nodes_settled(self) -> bool:
        """Node-lifecycle conservation at settle time (scenario/bench
        teardown): every node an actuation touched must be active or
        removed — anything still 'registered' (never confirmed) or
        'draining' (cordon without a completed drain OR rollback) is a
        violation.  Clears the stuck entries so a soak's next phase is
        judged on its own, mirroring assert_drained."""
        with self._lock:
            stuck = [
                n for n, s in self._node_state.items()
                if s in (NODE_REGISTERED, NODE_DRAINING)
            ]
            if not stuck:
                return True
            sample = ", ".join(
                f"{n}({self._node_state[n]})" for n in stuck[:4]
            )
            self._violation_locked(
                RULE_NODE_LIFECYCLE,
                f"{len(stuck)} node(s) stuck mid-transition after "
                f"settle: {sample}",
            )
            for n in stuck:
                self._node_set_locked(n, None)
        self._fire_callbacks()
        return False

    def note_evicted(self, pod, pdbs_matching: int,
                     budgets_debited: int) -> None:
        """An eviction was GRANTED (controllers.try_evict): every
        matching PDB must have been debited one disruption unit — an
        eviction that slipped past a matching budget is the
        thundering-drain race the debit-under-lock exists to close."""
        with self._lock:
            self.events_total += 1
            if pdbs_matching > 0 and budgets_debited < pdbs_matching:
                key = self._key(pod)
                self._violation_locked(
                    RULE_EVICTION_BUDGET,
                    f"pod {key[0]}/{key[1]} evicted with "
                    f"{budgets_debited}/{pdbs_matching} matching "
                    f"budget(s) debited",
                )
        self._fire_callbacks()

    def check_capacity_floor(self, remaining, committed,
                             detail: str = "") -> bool:
        """Scale-down guard: fleet allocatable AFTER removing the drain
        set must still cover committed usage per resource.  `remaining`
        and `committed` are f64[R] totals.  Returns True when the floor
        holds; False records a violation (the actuator also refuses the
        removal — capacity never drops below committed usage)."""
        remaining = np.asarray(remaining, np.float64)
        committed = np.asarray(committed, np.float64)
        with self._lock:
            self.events_total += 1
        under = committed > remaining * (1.0 + _CAPACITY_REL) + _CAPACITY_EPS
        if not under.any():
            return True
        with self._lock:
            self._violation_locked(
                RULE_CAPACITY_FLOOR,
                f"scale-down would drop fleet capacity below committed "
                f"usage in {int(under.sum())} resource column(s)"
                + (f" ({detail})" if detail else ""),
            )
        self._fire_callbacks()
        return False

    # ---------------------------------------------------------- internals

    def _resolve_locked(self, key, kind: str) -> None:
        entry = self._tracked.get(key)
        if entry is None:
            return  # not popped through a tracked seam: ignore
        if entry[1] is not None:
            self._violation_locked(
                RULE_CONSERVATION,
                f"pod {key[0]}/{key[1]} resolved twice: "
                f"{entry[1]} then {kind}",
            )
        else:
            self._outstanding -= 1
        entry[1] = kind

    def _prune_locked(self) -> None:
        """Age out RESOLVED entries beyond the cap (oldest first);
        unresolved entries are never pruned — they are the lost-pod
        evidence."""
        if len(self._tracked) <= self._max_tracked:
            return
        for key in list(self._tracked):
            if len(self._tracked) <= self._max_tracked:
                break
            if self._tracked[key][1] is not None:
                del self._tracked[key]

    def _violation_locked(self, rule: str, detail: str) -> None:
        self.counts[rule] = self.counts.get(rule, 0) + 1
        self.violations.append((rule, detail))
        m.INVARIANT_VIOLATIONS.inc(rule=rule)
        klog.errorf("invariant violation (%s): %s", rule, detail)
        self._pending_cb.append((rule, detail))

    def _fire_callbacks(self) -> None:
        """Deliver violations queued by _violation_locked to the
        on_violation callback OUTSIDE the lock (see _pending_cb).  Every
        public seam calls this after releasing; exceptions never escape
        (a checker must report corruption, not add a crash path)."""
        if self._on_violation is None:
            return
        with self._lock:
            if not self._pending_cb:
                return
            pending, self._pending_cb = self._pending_cb, []
        for rule, detail in pending:
            try:
                self._on_violation(rule, detail)
            except Exception as e:  # noqa: BLE001 — never crash the loop
                klog.errorf("invariant-violation callback failed: %s", e)

    # ------------------------------------------------------------ readers

    def violations_total(self) -> int:
        return sum(self.counts.values())

    def summary(self) -> dict:
        """Bounded state for /debug/cluster + the heartbeat line.  O(1)
        in the tracked population — it runs on the per-cycle telemetry
        seam (record_mesh), inside the <2%-of-cycle pin."""
        with self._lock:
            return {
                "violations": dict(self.counts),
                "violations_total": sum(self.counts.values()),
                "outstanding": self._outstanding,
                "tracked": len(self._tracked),
                "bound": len(self._bound),
                "nodes": dict(self._node_counts),
                "recent": [list(v) for v in list(self.violations)[-8:]],
            }
