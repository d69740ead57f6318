"""Scheduling queue: active / backoff / unschedulable, priority-ordered.

Mirrors SchedulingQueue / PriorityQueue semantics
(ref pkg/scheduler/internal/queue/scheduling_queue.go:57-811):
  * activeQ — heap ordered by (pod priority desc, enqueue time asc)
  * podBackoffQ — heap by backoff expiry; moved to active when expired
  * unschedulableQ — parking lot, flushed to active/backoff by
    move_all_to_active (cluster events) or the 60s leftover flush
    (flushUnschedulableQLeftover)
  * schedulingCycle / moveRequestCycle counters decide whether a failed pod
    saw the latest cluster event (scheduling_queue.go:107-137)

Heap deletion is lazy (entries carry a valid flag), so delete/re-add cannot
double-pop a pod.  Backoff mirrors pod_backoff.go: initial 1s, doubling,
max 10s.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.utils import metrics as m

UNSCHEDULABLE_TIME_LIMIT = 60.0  # flushUnschedulableQLeftover interval

# shed reasons (scheduler_queue_shed_pods_total{reason=} label values +
# the on_shed callback's second argument)
SHED_EVICTED = "evicted"   # a parked pod dropped for a higher-priority arrival
SHED_ARRIVAL = "arrival"   # the incoming pod itself rejected at capacity

# latency tiers: classified once at queue ADMISSION (_push_active),
# so requeues/backoff re-route a pod to its lane without re-deciding policy
# anywhere else.  The express lane is a small pre-compiled batch shape the
# scheduler interleaves with the bulk AIMD lane.  The canonical tier label
# values live with the metric family that carries them (utils/metrics).
TIER_BULK = m.TIER_BULK
TIER_EXPRESS = m.TIER_EXPRESS
# annotation opt-in/out: "express" forces the express lane, "bulk" forces
# the bulk lane even above the priority threshold
LATENCY_TIER_ANNOTATION = "kubernetes-tpu.io/latency-tier"


def classify_tier(pod: Pod, priority_threshold: Optional[int] = None) -> str:
    """Admission-time latency-tier classification: the pod's explicit
    annotation wins in both directions; otherwise the priority-class
    threshold (spec.priority >= threshold -> express; None disables the
    priority route); default bulk."""
    ann = pod.metadata.annotations.get(LATENCY_TIER_ANNOTATION, "")
    if ann == TIER_EXPRESS:
        return TIER_EXPRESS
    if ann == TIER_BULK:
        return TIER_BULK
    if (
        priority_threshold is not None
        and pod.spec.priority >= priority_threshold
    ):
        return TIER_EXPRESS
    return TIER_BULK


class PodBackoff:
    """ref internal/queue/pod_backoff.go PodBackoffMap."""

    def __init__(self, initial: float = 1.0, max_duration: float = 10.0):
        self.initial = initial
        self.max = max_duration
        self._attempts: Dict[Tuple[str, str], int] = {}
        self._last_update: Dict[Tuple[str, str], float] = {}

    def backoff_time(self, key: Tuple[str, str]) -> float:
        n = self._attempts.get(key, 0)
        if n == 0:
            return 0.0
        d = min(self.initial * (2 ** (n - 1)), self.max)
        return self._last_update.get(key, 0.0) + d

    def boost(self, key: Tuple[str, str], now: Optional[float] = None) -> None:
        self._attempts[key] = self._attempts.get(key, 0) + 1
        self._last_update[key] = now if now is not None else time.monotonic()

    def clear(self, key: Tuple[str, str]) -> None:
        self._attempts.pop(key, None)
        self._last_update.pop(key, None)


def _pod_key(pod: Pod) -> Tuple[str, str]:
    return (pod.namespace, pod.name)


# entry layout: [sort_key..., pod, valid]
_VALID = -1  # index of the valid flag


class PriorityQueue:
    """Blocking pop; thread-safe.  Ordering: higher .spec.priority first, then
    FIFO by add time (the default queue-sort plugin semantics).  A framework
    QueueSort plugin's LessFunc (`less`) replaces the default ordering
    (scheduling_queue.go NewPriorityQueueWithClock activeQComp /
    framework.QueueSortFunc)."""

    def __init__(self, backoff: Optional[PodBackoff] = None, less=None,
                 capacity: Optional[int] = None,
                 on_shed: Optional[Callable[[Pod, str], None]] = None,
                 tier_of: Optional[Callable[[Pod], str]] = None,
                 on_requeue: Optional[Callable[[Pod], None]] = None,
                 shards: int = 1):
        if less is not None:
            # a framework QueueSort order needs the framework's PodInfo,
            # which the port does not carry yet (ROADMAP A8)
            raise NotImplementedError(
                "a custom queue order (less) needs the scheduling framework, "
                "not ported yet (ROADMAP A8)")
        # overload protection: bound the TOTAL queue population
        # (active + backoff + unschedulable).  None = unbounded (the
        # historical behavior).  At capacity, a NEW arrival sheds the
        # lowest-priority pod — preferring longest-parked unschedulable
        # pods, never touching the backoff queue (the starvation guard:
        # pods mid-retry cannot be evicted by a flood of fresh arrivals)
        # — or is itself rejected when nothing lower-priority remains.
        # Requeues (add_unschedulable / move_all_to_active) never shed:
        # they return a pod the scheduler already popped, so the bound
        # holds without them.
        self.capacity = capacity
        self.on_shed = on_shed
        # latency-tier classifier (classify_tier partial, typically wired
        # by a Scheduler with config.express_lane): pods it maps to
        # TIER_EXPRESS enter the express heap and surface ONLY through
        # pop_express_batch — pop()/pop_batch() keep serving the bulk
        # lane.  None = single-lane (every pod bulk, the legacy behavior).
        self.tier_of = tier_of
        # requeue observer (typically the scheduler's invariant checker,
        # runtime/invariants.py): called once per pod re-admitted through
        # ANY requeue seam — add_unschedulable(_batch) and readd — so
        # "every popped pod ends bound/requeued/shed" is checkable at the
        # one place all requeue paths funnel through.  Called OUTSIDE the
        # queue lock, like on_shed.  None = no observer (the default).
        self.on_requeue = on_requeue
        self.shed_total = 0
        # lower bound on the priority of any TRACKED pod (monotone under
        # admits, reset when the queue is observed empty): lets the
        # at-capacity shed check reject a can't-win arrival WITHOUT the
        # O(population) candidate scan — the storm hot path.  A stale-LOW
        # floor is always safe: it only means candidates are >= incoming,
        # which is exactly the reject-the-arrival case.
        self._prio_floor = float("inf")
        self._less = less
        self._lock = threading.Condition()
        self._counter = itertools.count()
        # queue-sharded replicas: the bulk lane is a LIST of
        # heaps, one per stable hash-shard (shard = crc32(ns/name) % N),
        # so N scheduler replicas each drain a disjoint slice of the
        # active population without contending on pop order.  shards=1
        # (the default) is the classic single-heap queue bit-for-bit;
        # pop()/pop_batch() without a shard argument pop the GLOBAL best
        # across all heaps (same priority-FIFO order as one heap).
        # Requeues return to the owner shard by construction (the shard
        # is a pure function of the pod key); the shed candidate scan and
        # the backoff starvation guard work over the entry maps, which
        # span every shard.
        self._shards_n = max(1, int(shards))
        self._active: List[List[list]] = [
            [] for _ in range(self._shards_n)
        ]                                      # per-shard [-prio, seq, pod, valid] heaps
        # express-lane heap: same entry layout and ordering as the bulk
        # heaps (a single cross-shard lane — the express interleave is
        # served by one replica); entries of ALL heaps share
        # _active_entry, so delete/shedding/depth accounting see one
        # active population
        self._express: List[list] = []
        self._active_entry: Dict[Tuple[str, str], list] = {}
        self._backoffq: List[list] = []        # [expiry, seq, pod, valid]
        self._backoff_entry: Dict[Tuple[str, str], list] = {}
        # key -> (pod, cycle, parked_at)
        self._unschedulable: Dict[Tuple[str, str], Tuple[Pod, int, float]] = {}
        # nominatedPods map (scheduling_queue.go:107-137): pods that preempted
        # victims and expect to land on a node; consulted by the two-pass fit
        # evaluation (generic_scheduler.go:598-664 podFitsOnNode)
        self._nominated: Dict[Tuple[str, str], Tuple[Pod, str]] = {}
        self.backoff = backoff or PodBackoff()
        self.scheduling_cycle = 0
        self.move_request_cycle = -1
        self._closed = False
        # key -> monotonic first-enqueue time (cleared on delete / taken at
        # bind-commit for the e2e_scheduling_duration histogram)
        self._enqueued_at: Dict[Tuple[str, str], float] = {}
        # displaced-pod shed protection: pods re-admitted via
        # readd_displaced (a lifecycle event revoked their binding) are
        # not shed candidates until their next pop — a mass drain must
        # not convert running pods into shed ones before the scheduler
        # gets one retry at placing them.  Cleared on pop and delete.
        self._shed_protected: set = set()

    # ---- sharding ----

    @staticmethod
    def shard_of(pod, of: int) -> int:
        """STABLE hash shard of a pod (or (ns, name) key) for an N-way
        split: crc32 of "ns/name" mod N — deterministic across processes
        and runs (python's hash() is seed-randomized), so a pod always
        lands on the same shard through add/delete/readd and every
        requeue returns it to its owner replica."""
        if of <= 1:
            return 0
        key = pod if isinstance(pod, tuple) else _pod_key(pod)
        return zlib.crc32(f"{key[0]}/{key[1]}".encode()) % of

    def _set_shards_locked(self, n: int) -> None:
        """Re-shard the bulk lane to n heaps (lock held): existing valid
        entries redistribute by their stable hash; entry OBJECTS are
        preserved so _active_entry identity (lazy deletion) still holds."""
        n = max(1, int(n))
        if n == self._shards_n:
            return
        entries = [e for h in self._active for e in h if e[_VALID]]
        self._shards_n = n
        self._active = [[] for _ in range(n)]
        for e in entries:
            heapq.heappush(
                self._active[self.shard_of(_pod_key(e[2]), n)], e
            )
        self._lock.notify_all()

    def set_shards(self, n: int) -> None:
        """Configure the bulk lane's shard count (SchedulerReplicaSet
        wires N = replica count).  Idempotent; safe while populated."""
        with self._lock:
            self._set_shards_locked(n)

    @property
    def shards(self) -> int:
        return self._shards_n

    # ---- internal (lock held) ----

    def _push_active(self, pod: Pod) -> None:
        key = _pod_key(pod)
        self._prio_floor = min(self._prio_floor, pod.spec.priority)
        # first-seen enqueue stamp: survives backoff/unschedulable requeues
        # so queue-add -> bind-commit latency covers the pod's whole wait
        # (the density SLO measures create -> scheduled the same way)
        self._enqueued_at.setdefault(key, time.monotonic())
        if key in self._active_entry:
            return
        sort_key = -pod.spec.priority
        entry = [sort_key, next(self._counter), pod, True]
        if self.tier_of is not None and self.tier_of(pod) == TIER_EXPRESS:
            heap = self._express
        else:
            heap = self._active[self.shard_of(key, self._shards_n)]
        heapq.heappush(heap, entry)
        self._active_entry[key] = entry

    def _push_backoff(self, pod: Pod, expiry: float) -> None:
        key = _pod_key(pod)
        self._prio_floor = min(self._prio_floor, pod.spec.priority)
        old = self._backoff_entry.get(key)
        if old is not None:
            old[_VALID] = False
        entry = [expiry, next(self._counter), pod, True]
        heapq.heappush(self._backoffq, entry)
        self._backoff_entry[key] = entry

    def _size_locked(self) -> int:
        return (
            len(self._active_entry)
            + len(self._backoff_entry)
            + len(self._unschedulable)
        )

    def _shed_candidate_locked(self, incoming: Pod) -> Optional[Tuple[str, str]]:
        """Pick the pod a full queue drops to admit `incoming`, or None
        when the arrival itself must be rejected.  Policy: lowest
        priority first; at equal priority, an unschedulable-parked pod
        (it already failed to place) is preferred over an active one and
        the longest-parked goes first; among active pods the YOUNGEST
        arrival is dropped (long-waiters keep their place).  Backoff
        entries are never candidates — the starvation guard: a pod
        mid-retry cannot be evicted by a flood of fresh arrivals.  The
        candidate sheds only if it is strictly lower priority than the
        arrival, or equal priority AND parked unschedulable."""
        # fast path: when the arrival cannot beat the tracked-priority
        # floor there is nothing to scan for (the common storm case —
        # thousands of equal-priority arrivals/s against a full queue
        # must not pay an O(population) scan under the lock each)
        if incoming.spec.priority < self._prio_floor or (
            incoming.spec.priority == self._prio_floor
            and not self._unschedulable
        ):
            return None
        now = time.monotonic()
        best = None  # (priority, class, tiebreak) + key
        for key, (pod, _, parked) in self._unschedulable.items():
            if key in self._shed_protected:
                continue  # displaced: not sheddable before one retry
            cand = (pod.spec.priority, 0, parked)
            if best is None or cand < best[0]:
                best = (cand, key)
        for key, entry in self._active_entry.items():
            if not entry[_VALID] or key in self._shed_protected:
                continue
            cand = (entry[2].spec.priority, 1,
                    -self._enqueued_at.get(key, now))
            if best is None or cand < best[0]:
                best = (cand, key)
        if best is None:
            return None
        (prio, cls, _), key = best
        if prio < incoming.spec.priority or (
            prio == incoming.spec.priority and cls == 0
        ):
            return key
        return None

    def _drop_locked(self, key: Tuple[str, str]) -> Pod:
        """Remove a shed victim from every structure (delete(), minus the
        backoff-entry half — victims are never in the backoff queue)."""
        rec = self._unschedulable.pop(key, None)
        if rec is not None:
            pod = rec[0]
        else:
            entry = self._active_entry.pop(key)
            entry[_VALID] = False
            pod = entry[2]
        self._nominated.pop(key, None)
        self.backoff.clear(key)
        self._enqueued_at.pop(key, None)
        return pod

    # ---- producers ----

    def add(self, pod: Pod) -> None:
        shed: List[Tuple[Pod, str]] = []
        with self._lock:
            if self._size_locked() == 0:
                # natural reset point for the priority floor: an empty
                # queue tracks nothing, so the bound starts over
                self._prio_floor = float("inf")
            key = _pod_key(pod)
            tracked = (
                key in self._active_entry
                or key in self._backoff_entry
                or key in self._unschedulable
            )
            admitted = True
            if (
                not tracked
                and self.capacity is not None
                and self._size_locked() >= self.capacity
            ):
                victim = self._shed_candidate_locked(pod)
                self.shed_total += 1
                if victim is None:
                    # nothing lower-priority is sheddable: the ARRIVAL is
                    # dropped (a higher-priority pod is never evicted for
                    # a lower-priority one)
                    shed.append((pod, SHED_ARRIVAL))
                    admitted = False
                else:
                    shed.append((self._drop_locked(victim), SHED_EVICTED))
            if admitted:
                self._unschedulable.pop(key, None)
                self._push_active(pod)
                self._lock.notify()
        # metric + callback OUTSIDE the lock: on_shed typically records an
        # Event (and must never deadlock against a queue re-entry)
        for p, reason in shed:
            m.QUEUE_SHED.inc(reason=reason)
            if self.on_shed is not None:
                self.on_shed(p, reason)

    def readd(self, pod: Pod) -> None:
        """Re-admit a pod the scheduler already POPPED (a gang's surplus
        member, rollback paths): EXEMPT from capacity shedding, like
        every other requeue — the pod was admitted once, and dropping it
        here would silently lose a popped pod."""
        with self._lock:
            self._unschedulable.pop(_pod_key(pod), None)
            self._push_active(pod)
            self._lock.notify()
        if self.on_requeue is not None:
            self.on_requeue(pod)

    def readd_displaced(self, pod: Pod) -> None:
        """Re-admit a pod whose BINDING a cluster-lifecycle event revoked
        (NodeLifecycleController eviction, a drain wave, a zone outage).
        Shed-EXEMPT like every requeue — the pod was running,
        and a capacity drop here would turn a node drain into silent pod
        loss — and additionally shed-PROTECTED until its next pop: a
        displaced pod is never a shed candidate before the scheduler gets
        one retry at placing it (the mass-requeue guarantee a rolling
        drain leans on).  No on_requeue call: the pod was not popped by
        this scheduler's current conservation window — the displaced
        seam (InvariantChecker.note_displaced) already closed its bound
        mark, so this is a fresh admission, not a resolution."""
        key = _pod_key(pod)
        with self._lock:
            self._unschedulable.pop(key, None)
            self._shed_protected.add(key)
            self._push_active(pod)
            self._lock.notify()

    def _add_unschedulable_locked(self, pod: Pod, cycle: int) -> None:
        key = _pod_key(pod)
        self.backoff.boost(key)
        if self.move_request_cycle >= cycle:
            self._push_backoff(pod, self.backoff.backoff_time(key))
        else:
            self._unschedulable[key] = (pod, cycle, time.monotonic())
        self._lock.notify()

    def add_unschedulable(self, pod: Pod, cycle: int) -> None:
        """Failed-to-schedule pod (scheduling_queue.go AddUnschedulableIfNotPresent):
        if a move request happened after this pod's cycle began, it goes to
        backoff (a cluster event might have made it schedulable); otherwise it
        parks in unschedulableQ until an event or the 60s leftover flush."""
        with self._lock:
            self._add_unschedulable_locked(pod, cycle)
        if self.on_requeue is not None:
            self.on_requeue(pod)

    def add_unschedulable_batch(self, pods, cycle: int) -> None:
        """add_unschedulable for a whole failed batch under ONE lock
        acquisition (the batched commit path's loser requeue; the
        Condition wraps an RLock)."""
        if not pods:
            return
        with self._lock:
            for pod in pods:
                self._add_unschedulable_locked(pod, cycle)
        if self.on_requeue is not None:
            for pod in pods:
                self.on_requeue(pod)

    def move_all_to_active(self) -> None:
        """Cluster event: flush unschedulableQ (MoveAllToActiveQueue,
        scheduling_queue.go:73; wired from eventhandlers.go:319-378)."""
        with self._lock:
            self.move_request_cycle = self.scheduling_cycle
            for key, (pod, _, _) in list(self._unschedulable.items()):
                self._push_backoff(pod, self.backoff.backoff_time(key))
            self._unschedulable.clear()
            self._lock.notify()

    def tracks(self, pod: Pod) -> bool:
        """Membership across all three sub-queues (active/backoff/
        unschedulable) — the conservation scorer's "still queued"
        bucket (runtime/scenario.py): an unbound pod the queue does NOT
        track and that was never shed has been lost."""
        key = _pod_key(pod)
        with self._lock:
            return (
                key in self._active_entry
                or key in self._backoff_entry
                or key in self._unschedulable
            )

    def delete(self, pod: Pod) -> None:
        with self._lock:
            key = _pod_key(pod)
            self._unschedulable.pop(key, None)
            self._nominated.pop(key, None)
            entry = self._active_entry.pop(key, None)
            if entry is not None:
                entry[_VALID] = False
            entry = self._backoff_entry.pop(key, None)
            if entry is not None:
                entry[_VALID] = False
            self.backoff.clear(key)
            self._enqueued_at.pop(key, None)
            self._shed_protected.discard(key)

    def take_enqueue_time(self, pod: Pod) -> Optional[float]:
        """Pop and return the pod's first-enqueue monotonic timestamp (None
        if the pod never passed through this queue — e.g. direct
        schedule_cycle calls in tests)."""
        with self._lock:
            return self._enqueued_at.pop(_pod_key(pod), None)

    def take_enqueue_times(self, pods) -> List[Optional[float]]:
        """take_enqueue_time for a whole bound batch, one lock acquisition.

        The batched commit tail takes stamps BEFORE its bind fan-out: a
        bind's informer echo (pod update -> queue.delete) would otherwise
        race the take and drop the queue-wait from the e2e histogram."""
        with self._lock:
            return [self._enqueued_at.pop(_pod_key(p), None) for p in pods]

    def restore_enqueue_time(self, pod, t: Optional[float]) -> None:
        """Put back a stamp taken optimistically for a pod whose bind then
        failed: the requeued pod's eventual e2e must still cover its whole
        wait from FIRST enqueue (matching the per-pod loop, which only
        consumes the stamp on a successful bind)."""
        if t is None:
            return
        with self._lock:
            self._enqueued_at[_pod_key(pod)] = t

    def backlog_pods(self, limit: Optional[int] = None) -> List[Pod]:
        """READ-ONLY snapshot of every tracked pod — active (both
        lanes), backoff, and unschedulable-parked — under one lock
        acquisition, newest-admission-last within each tier.  The
        capacity planner's backlog source (runtime/capacity.py): what
        would the fleet need to place ALL of this?  `limit` bounds the
        walk (a 1M-pod storm queue must not be copied wholesale onto
        the scheduling thread)."""
        with self._lock:
            out: List[Pod] = [
                e[2] for e in self._active_entry.values() if e[_VALID]
            ]
            out += [
                e[2] for e in self._backoff_entry.values() if e[_VALID]
            ]
            out += [rec[0] for rec in self._unschedulable.values()]
        return out if limit is None else out[:limit]

    def has_nominated(self) -> bool:
        with self._lock:
            return bool(self._nominated)

    def active_depth(self) -> int:
        """Pods that will reach the active queue without an external
        cluster event (active + backoff entries): the adaptive-batch
        pressure signal (unschedulable-parked pods are excluded — they
        exert no demand until an event revives them)."""
        with self._lock:
            return len(self._active_entry) + len(self._backoff_entry)

    def has_schedulable(self) -> bool:
        """Anything that can reach the active queue WITHOUT an external
        cluster event: active entries, or backoff entries whose expiry the
        flusher will promote.  Unschedulable-parked pods don't count (they
        need move_all_to_active or the 60s leftover flush) — drain loops
        use this to stop instead of spinning on a parked remainder."""
        with self._lock:
            return bool(self._active_entry or self._backoff_entry)

    def delete_nominated_batch(self, pods) -> None:
        with self._lock:
            for pod in pods:
                self._nominated.pop(_pod_key(pod), None)

    # ---- nominated pods (UpdateNominatedPodForNode / DeleteNominatedPodIfExists) ----

    def update_nominated_pod(self, pod: Pod, node_name: str) -> None:
        with self._lock:
            self._nominated[_pod_key(pod)] = (pod, node_name)

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        with self._lock:
            self._nominated.pop(_pod_key(pod), None)

    def nominated_pods(self) -> List[Tuple[Pod, str]]:
        """Snapshot of (pod, nominated node name) pairs."""
        with self._lock:
            return list(self._nominated.values())

    def nominated_pods_for_node(self, node_name: str) -> List[Pod]:
        with self._lock:
            return [p for p, n in self._nominated.values() if n == node_name]

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # ---- consumer ----

    def _flush(self, now: float) -> None:
        # expired backoff -> active
        while self._backoffq and (
            not self._backoffq[0][_VALID] or self._backoffq[0][0] <= now
        ):
            entry = heapq.heappop(self._backoffq)
            if not entry[_VALID]:
                continue
            pod = entry[2]
            key = _pod_key(pod)
            if self._backoff_entry.get(key) is entry:
                del self._backoff_entry[key]
            self._push_active(pod)
        # unschedulable leftovers past the 60s limit -> backoff
        # (flushUnschedulableQLeftover)
        for key, (pod, _, parked) in list(self._unschedulable.items()):
            if now - parked >= UNSCHEDULABLE_TIME_LIMIT:
                del self._unschedulable[key]
                self._push_backoff(pod, self.backoff.backoff_time(key))

    def _pop_from_locked(self, heap: List[list]) -> Optional[Pod]:
        """Pop the highest-priority valid entry from one lane's heap (lock
        held); None when the heap holds only lazily-deleted entries."""
        while heap:
            entry = heapq.heappop(heap)
            if not entry[_VALID]:
                continue
            pod = entry[2]
            key = _pod_key(pod)
            if self._active_entry.get(key) is entry:
                del self._active_entry[key]
            # the displaced pod got its retry: normal shed policy resumes
            self._shed_protected.discard(key)
            self.scheduling_cycle += 1
            return pod
        return None

    def _pop_bulk_locked(self, shard: Optional[int]) -> Optional[Pod]:
        """Pop the best valid bulk entry (lock held).  shard=None pops the
        GLOBAL best across every shard heap (identical order to a single
        heap: entries compare by [sort_key, seq], and seq is unique);
        shard=i pops only shard i's heap (a replica's slice)."""
        if shard is not None:
            return self._pop_from_locked(self._active[shard])
        if self._shards_n == 1:
            return self._pop_from_locked(self._active[0])
        best_h = None
        for h in self._active:
            while h and not h[0][_VALID]:  # shed dead heads before compare
                heapq.heappop(h)
            if h and (best_h is None or h[0][:2] < best_h[0][:2]):
                best_h = h
        if best_h is None:
            return None
        return self._pop_from_locked(best_h)

    def _express_ready_locked(self) -> bool:
        """Any valid express entry pending?  (Lock held; sheds the heap's
        lazily-deleted head entries as a side effect, so the check stays
        O(dead entries), not O(heap).)"""
        h = self._express
        while h and not h[0][_VALID]:
            heapq.heappop(h)
        return bool(h)

    def pop(self, timeout: Optional[float] = None,
            yield_to_express: bool = False,
            shard: Optional[int] = None,
            of: Optional[int] = None) -> Optional[Pod]:
        """Blocking pop from the BULK lane.  With yield_to_express, an
        express arrival interrupts the wait (returns None) so the tiered
        run loop can serve the express lane instead of letting a
        latency-sensitive pod sit out the bulk poll timeout.

        shard=i (with of=N) pops only pods whose stable hash-shard is i —
        the queue re-shards itself to N heaps on first use, so N replica
        consumers drain disjoint slices; a replica's blocking wait still
        wakes on any arrival and re-checks only its own shard."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if of is not None and of != self._shards_n:
                self._set_shards_locked(of)
            if shard is not None and not (0 <= shard < self._shards_n):
                raise ValueError(
                    f"shard {shard} out of range for {self._shards_n} shards"
                )
            while True:
                self._flush(time.monotonic())
                pod = self._pop_bulk_locked(shard)
                if pod is not None:
                    return pod
                if yield_to_express and self._express_ready_locked():
                    return None
                if self._closed:
                    return None
                wait = None
                if self._backoffq:
                    wait = max(self._backoffq[0][0] - time.monotonic(), 0.01)
                if self._unschedulable:
                    oldest = min(t for _, _, t in self._unschedulable.values())
                    leftover = max(oldest + UNSCHEDULABLE_TIME_LIMIT - time.monotonic(), 0.01)
                    wait = leftover if wait is None else min(wait, leftover)
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        return None
                    wait = remain if wait is None else min(wait, remain)
                self._lock.wait(wait)

    def pop_batch(self, max_batch: int, timeout: Optional[float] = None,
                  batch_window: float = 0.0,
                  yield_to_express: bool = False,
                  shard: Optional[int] = None,
                  of: Optional[int] = None) -> List[Pod]:
        """Drain up to max_batch pods; waits `timeout` for the first pod then
        `batch_window` more for stragglers (deadline-driven batch formation).
        yield_to_express (tiered run loop): an express arrival cuts both the
        first-pod wait and the straggler window short.  shard=i, of=N:
        drain only the stable hash-shard i of an N-way split —
        the scheduler-replica consumer API."""
        out = []
        first = self.pop(timeout, yield_to_express=yield_to_express,
                         shard=shard, of=of)
        if first is None:
            return out
        out.append(first)
        deadline = time.monotonic() + batch_window
        while len(out) < max_batch:
            remain = deadline - time.monotonic()
            nxt = self.pop(max(remain, 0.0) if batch_window else 0.0,
                           yield_to_express=yield_to_express, shard=shard)
            if nxt is None:
                break
            out.append(nxt)
        return out

    def pop_express_batch(self, max_batch: int) -> List[Pod]:
        """Drain up to max_batch pods from the EXPRESS lane, non-blocking
        (the tiered run loop polls this before every bulk pop; express
        batch formation never waits — a latency tier that batches by
        timer would re-create the latency it exists to remove)."""
        out: List[Pod] = []
        with self._lock:
            self._flush(time.monotonic())
            while len(out) < max_batch:
                pod = self._pop_from_locked(self._express)
                if pod is None:
                    break
                out.append(pod)
        return out

    def express_depth(self) -> int:
        """Valid express-lane entries pending (observability/tests)."""
        with self._lock:
            self._express_ready_locked()
            return sum(1 for e in self._express if e[_VALID])

    def __len__(self) -> int:
        with self._lock:
            return (
                len(self._active_entry)
                + len(self._backoff_entry)
                + len(self._unschedulable)
            )
