"""Metrics: Prometheus-style registry mirroring the scheduler's observables.

The reference exposes latency histograms + counters on /metrics
(ref pkg/scheduler/metrics/metrics.go:31-199: e2e_scheduling_duration,
scheduling_algorithm_duration, binding_duration, schedule_attempts_total,
pending_pods, ...).  This module implements a dependency-free registry with
the same metric names, exposable in the Prometheus text format.
"""

from __future__ import annotations

import bisect
import logging
import threading
from typing import Dict, List, Optional, Tuple

_DEF_BUCKETS = [0.001 * (2 ** i) for i in range(16)]  # 1ms .. ~32s

# bounded-cardinality guard for labeled families: a family growing past
# this many children (per-pod labels, unbounded width series, ...) is a
# memory leak on /metrics — warn ONCE per family so the leak is visible
# without spamming, and keep recording (prometheus drops nothing either;
# the fix is remove() or a better label).  Families with a known-larger
# legitimate cardinality pass their own max_children.
DEFAULT_MAX_CHILDREN = 64
_logger = logging.getLogger("kubernetes_tpu")


def _label_key(label_names: Tuple[str, ...], labels: dict) -> Tuple[str, ...]:
    """THE label-set -> child-key normalization, shared by every
    labeled family (missing labels read as "")."""
    return tuple(str(labels.get(n, "")) for n in label_names)


def _warn_cardinality(name: str, max_children: int, n_children: int,
                      key) -> None:
    """The once-per-family guard message (callers track the warned
    flag; the condition and text must not drift between families)."""
    _logger.warning(
        "metric family %s grew past %d label sets "
        "(%d children; adding %r) — unbounded label cardinality? "
        "remove() retired series, or raise max_children",
        name, max_children, n_children, key,
    )


class Histogram:
    """Single-series histogram.  The observe/quantile methods ACCEPT AND
    IGNORE label kwargs so a plain Histogram can stand in for a
    LabeledHistogram (the test/density pattern of swapping a fresh
    instance over a labeled global like E2E_LATENCY)."""

    def __init__(self, name: str, help_: str = "", buckets: Optional[List[float]] = None):
        self.name = name
        self.help = help_
        self.buckets = sorted(buckets or _DEF_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, v: float, **_labels) -> None:
        with self._lock:
            i = bisect.bisect_left(self.buckets, v)
            self.counts[i] += 1
            self.sum += v
            self.total += 1

    def observe_n(self, v: float, n: int, **_labels) -> None:
        """n observations of the same value under one lock acquisition
        (the batched commit path's per-pod amortized latencies)."""
        if n <= 0:
            return
        with self._lock:
            i = bisect.bisect_left(self.buckets, v)
            self.counts[i] += n
            self.sum += v * n
            self.total += n

    def observe_batch(self, values, **_labels) -> None:
        """Many distinct observations under one lock acquisition."""
        if not values:
            return
        with self._lock:
            for v in values:
                i = bisect.bisect_left(self.buckets, v)
                self.counts[i] += 1
                self.sum += v
            self.total += len(values)

    def observe_np(self, values, **_labels) -> None:
        """Vectorized observe_batch for a numpy array: one searchsorted
        + bincount instead of a per-value bisect loop — the hot-path
        form for per-pod batch observations (placement margins,
        feasible counts) where a 2048-wide cycle would otherwise pay
        2048 locked bisects."""
        import numpy as _np

        values = _np.asarray(values)
        if values.size == 0:
            return
        idx = _np.searchsorted(self.buckets, values, side="left")
        binned = _np.bincount(idx, minlength=len(self.counts))
        total = _np.sum(values, dtype=_np.float64)
        with self._lock:
            for i, c in enumerate(binned):
                if c:
                    self.counts[i] += int(c)
            self.sum += float(total)
            self.total += int(values.size)

    def quantile(self, q: float, **_labels) -> float:
        """Approximate quantile with LINEAR INTERPOLATION inside the
        bucket (the prometheus histogram_quantile estimator): the target
        rank's position within its bucket's count scales between the
        bucket's lower and upper bound, instead of snapping every answer
        to the upper bound (which inflated p50 by up to 2x on these
        pow2-spaced buckets).  The first bucket interpolates from 0; a
        rank landing in the +Inf overflow bucket reports the highest
        finite boundary, exactly as histogram_quantile does."""
        with self._lock:
            if self.total == 0:
                return 0.0
            target = q * self.total
            acc = 0
            for i, c in enumerate(self.counts):
                if c > 0 and acc + c >= target:
                    if i >= len(self.buckets):
                        return self.buckets[-1]  # overflow bucket
                    lo = self.buckets[i - 1] if i > 0 else 0.0
                    hi = self.buckets[i]
                    return lo + (hi - lo) * (target - acc) / c
                acc += c
            return self.buckets[-1]

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        acc = 0
        for i, b in enumerate(self.buckets):
            acc += self.counts[i]
            out.append(f'{self.name}_bucket{{le="{b}"}} {acc}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {self.total}')
        out.append(f"{self.name}_sum {self.sum}")
        out.append(f"{self.name}_count {self.total}")
        return "\n".join(out)


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} counter\n"
            f"{self.name} {self.value}"
        )


class Gauge(Counter):
    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} gauge\n"
            f"{self.name} {self.value}"
        )


class LabeledCounter:
    """Counter family with label sets (e.g. schedule_attempts_total{result=})
    — the prometheus CounterVec analog (metrics.go scheduleAttempts).

    Children are created on first use and live until `remove()`d; growth
    past `max_children` logs a once-per-family cardinality warning (the
    guard that keeps a per-width/per-pod label from leaking series
    without bound)."""

    def __init__(self, name: str, help_: str = "",
                 label_names: Tuple[str, ...] = (),
                 max_children: Optional[int] = None):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.max_children = (
            max_children if max_children is not None else DEFAULT_MAX_CHILDREN
        )
        self._warned = False
        self._children: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        return _label_key(self.label_names, labels)

    def _check_cardinality_locked(self, key) -> None:
        """Call with the lock held, BEFORE inserting a new key."""
        if (
            not self._warned
            and key not in self._children
            and len(self._children) >= self.max_children
        ):
            self._warned = True
            _warn_cardinality(
                self.name, self.max_children, len(self._children), key
            )

    def inc(self, v: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._check_cardinality_locked(key)
            self._children[key] = self._children.get(key, 0.0) + v

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._children.get(key, 0.0)

    def remove(self, **labels) -> bool:
        """Retire one label set's series (the CounterVec.DeleteLabelValues
        analog): the series disappears from /metrics and a later inc()
        restarts it from zero.  Returns whether it existed."""
        key = self._key(labels)
        with self._lock:
            return self._children.pop(key, None) is not None

    def child_count(self) -> int:
        with self._lock:
            return len(self._children)

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            # an empty family exposes only HELP/TYPE (prometheus CounterVec)
            for key, v in sorted(self._children.items()):
                lbl = ",".join(
                    f'{n}="{val}"' for n, val in zip(self.label_names, key)
                )
                out.append(f"{self.name}{{{lbl}}} {v}")
        return "\n".join(out)


class LabeledHistogram:
    """Histogram family with label sets — the prometheus HistogramVec
    analog (e.g. scheduler_e2e_scheduling_duration_seconds{tier=}).

    Each distinct label set owns a child Histogram; observations without
    an explicit label fall into `default_labels` (so pre-tier callers keep
    recording, into the bulk series).  `total` aggregates children (the
    before/after counters some tests pin); `quantile` reads one child."""

    def __init__(self, name: str, help_: str = "",
                 label_names: Tuple[str, ...] = (),
                 buckets: Optional[List[float]] = None,
                 default_labels: Optional[Dict[str, str]] = None,
                 max_children: Optional[int] = None):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._buckets = buckets
        self._default = dict(default_labels or {})
        self.max_children = (
            max_children if max_children is not None else DEFAULT_MAX_CHILDREN
        )
        self._warned = False
        self._children: Dict[Tuple[str, ...], Histogram] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        return _label_key(self.label_names, {**self._default, **labels})

    def labels(self, **labels) -> Histogram:
        key = self._key(labels)
        with self._lock:
            h = self._children.get(key)
            if h is None:
                if (
                    not self._warned
                    and len(self._children) >= self.max_children
                ):
                    self._warned = True
                    _warn_cardinality(
                        self.name, self.max_children,
                        len(self._children), key,
                    )
                h = self._children[key] = Histogram(
                    self.name, self.help, buckets=self._buckets
                )
            return h

    def remove(self, **labels) -> bool:
        """Retire one label set's child histogram (observations restart
        from an empty ladder if the series comes back)."""
        with self._lock:
            return self._children.pop(self._key(labels), None) is not None

    def child_count(self) -> int:
        with self._lock:
            return len(self._children)

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)

    def observe_n(self, v: float, n: int, **labels) -> None:
        self.labels(**labels).observe_n(v, n)

    def observe_batch(self, values, **labels) -> None:
        self.labels(**labels).observe_batch(values)

    def observe_np(self, values, **labels) -> None:
        self.labels(**labels).observe_np(values)

    def quantile(self, q: float, **labels) -> float:
        return self.labels(**labels).quantile(q)

    @property
    def total(self) -> int:
        with self._lock:
            children = list(self._children.values())
        return sum(h.total for h in children)

    @property
    def sum(self) -> float:
        with self._lock:
            children = list(self._children.values())
        return sum(h.sum for h in children)

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for key, h in children:
            lbl = ",".join(
                f'{n}="{val}"' for n, val in zip(self.label_names, key)
            )
            acc = 0
            for i, b in enumerate(h.buckets):
                acc += h.counts[i]
                out.append(f'{self.name}_bucket{{{lbl},le="{b}"}} {acc}')
            out.append(f'{self.name}_bucket{{{lbl},le="+Inf"}} {h.total}')
            out.append(f"{self.name}_sum{{{lbl}}} {h.sum}")
            out.append(f"{self.name}_count{{{lbl}}} {h.total}")
        return "\n".join(out)


class LabeledGauge(LabeledCounter):
    """Gauge family with label sets (the prometheus GaugeVec analog,
    e.g. apiserver_current_inflight_requests{request_kind=})."""

    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._check_cardinality_locked(key)
            self._children[key] = float(v)

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._children.items()):
                lbl = ",".join(
                    f'{n}="{val}"' for n, val in zip(self.label_names, key)
                )
                out.append(f"{self.name}{{{lbl}}} {v}")
        return "\n".join(out)


class Registry:
    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, m):
        with self._lock:
            self._metrics[m.name] = m
        return m

    def get(self, name: str):
        return self._metrics.get(name)

    def expose(self) -> str:
        with self._lock:
            return "\n".join(m.expose() for m in self._metrics.values()) + "\n"


REGISTRY = Registry()

# the scheduler's metric families (metrics.go:86-199 names, seconds units).
# e2e carries the latency-tier label: per-tier p50/p99 is the
# express lane's acceptance figure, and single-series recording (tests,
# density, pre-tier callers) lands in the bulk child by default.
TIER_BULK, TIER_EXPRESS = "bulk", "express"
E2E_LATENCY = REGISTRY.register(LabeledHistogram(
    "scheduler_e2e_scheduling_duration_seconds",
    "Queue-add -> bind-commit latency, by latency tier",
    ("tier",), default_labels={"tier": TIER_BULK},
))
ALGO_LATENCY = REGISTRY.register(Histogram("scheduler_scheduling_algorithm_duration_seconds"))
PREDICATE_LATENCY = REGISTRY.register(Histogram("scheduler_scheduling_algorithm_predicate_evaluation_seconds"))
PRIORITY_LATENCY = REGISTRY.register(Histogram("scheduler_scheduling_algorithm_priority_evaluation_seconds"))
PREEMPTION_LATENCY = REGISTRY.register(Histogram("scheduler_scheduling_algorithm_preemption_evaluation_seconds"))
BINDING_LATENCY = REGISTRY.register(Histogram("scheduler_binding_duration_seconds"))
SCHEDULE_ATTEMPTS = REGISTRY.register(
    LabeledCounter(
        "scheduler_schedule_attempts_total",
        "Number of attempts to schedule pods, by result",
        ("result",),
    )
)
PENDING_PODS = REGISTRY.register(Gauge("scheduler_pending_pods"))
PREEMPTION_VICTIMS = REGISTRY.register(
    Gauge("scheduler_pod_preemption_victims", "Number of selected preemption victims")
)
PREEMPTION_ATTEMPTS = REGISTRY.register(
    Counter("scheduler_total_preemption_attempts", "Total preemption attempts")
)
# per-dispatch admission-webhook round-trip latency (the reference's
# apiserver_admission_webhook_admission_duration_seconds — a slow
# failurePolicy=Fail hook stalls every matching write, so it must be
# observable)
WEBHOOK_LATENCY = REGISTRY.register(Histogram(
    "apiserver_admission_webhook_admission_duration_seconds",
    "Admission webhook round-trip latency",
))

# device-fault resilience observables (no reference analog — the reference
# scheduler has no accelerator to lose; names follow the scheduler_ family)
FAULT_RETRIES = REGISTRY.register(
    LabeledCounter(
        "scheduler_device_fault_retries_total",
        "Classified device-fault retries of an in-flight batch, by class",
        ("class",),
    )
)
BREAKER_STATE = REGISTRY.register(
    Gauge(
        "scheduler_device_breaker_state",
        "Device circuit-breaker state: 0=closed 1=half_open 2=open",
    )
)
BREAKER_TRANSITIONS = REGISTRY.register(
    LabeledCounter(
        "scheduler_device_breaker_transitions_total",
        "Device circuit-breaker transitions, by target state",
        ("to",),
    )
)
DEGRADED_CYCLES = REGISTRY.register(
    Counter(
        "scheduler_degraded_cycles_total",
        "Scheduling cycles served by the CPU reference engine while the "
        "device breaker was open",
    )
)

# elastic degradation ladder: per-shard fault attribution and
# mesh shrink/rebuild.  The global breaker above stays the whole-mesh
# guard; these families track the per-device half — which shard a
# classified fault blamed, each shard's own breaker state, the live mesh
# width, and the ladder rung the control plane currently serves from.
SHARD_BREAKER_STATE = REGISTRY.register(
    LabeledGauge(
        "scheduler_device_shard_breaker_state",
        "Per-shard device circuit-breaker state, by mesh device id: "
        "0=closed 1=half_open 2=open (open = the shard is out of the "
        "live mesh)",
        ("shard",),
        max_children=512,  # the mesh device cap (parallel/mesh.py)
    )
)
SHARD_FAULTS = REGISTRY.register(
    LabeledCounter(
        "scheduler_device_shard_failures_total",
        "Classified device faults attributed to one mesh shard, by "
        "device id and fault class",
        ("shard", "class"),
        max_children=2048,  # 512 devices x 4 fault classes
    )
)
MESH_WIDTH = REGISTRY.register(
    Gauge(
        "scheduler_mesh_live_devices",
        "Devices in the live scheduling mesh (0 = unsharded single chip)",
    )
)
MESH_REBUILDS = REGISTRY.register(
    LabeledCounter(
        "scheduler_mesh_rebuilds_total",
        "Live mesh rebuilds, by direction: 'shrink' = a shard was lost "
        "and the mesh rebuilt narrower, 'restore' = a lost shard's "
        "half-open probe succeeded and the mesh rebuilt wider",
        ("direction",),
    )
)
LADDER_RUNG = REGISTRY.register(
    Gauge(
        "scheduler_degradation_rung",
        "Degradation-ladder rung currently serving cycles: 0=full_mesh "
        "1=shrunken_mesh 2=single_chip 3=cpu",
    )
)
# bounded-breaker satellite: the transitions audit list on DeviceHealth
# is now a deque(maxlen) — scheduler_device_breaker_transitions_total
# above is the unbounded record (counters never truncate)
INVARIANT_VIOLATIONS = REGISTRY.register(
    LabeledCounter(
        "scheduler_invariant_violations_total",
        "Online invariant-checker violations, by rule (conservation | "
        "double_bind | capacity | lost_pod).  Any non-zero value is a "
        "control-plane bug: each fires a flight-recorder postmortem",
        ("rule",),
    )
)

# overload protection & backpressure observables: the apiserver's
# APF-style inflight limiter (apiserver/fairness.py — reference names from
# apiserver/pkg/server/filters/maxinflight.go + util/flowcontrol metrics)
# and the scheduler's bounded-queue shedding + adaptive batch sizing
APF_INFLIGHT = REGISTRY.register(
    LabeledGauge(
        "apiserver_current_inflight_requests",
        "Inflight request slots currently held, by verb class",
        ("request_kind",),
    )
)
APF_REJECTED = REGISTRY.register(
    LabeledCounter(
        "apiserver_flowcontrol_rejected_requests_total",
        "Requests rejected with 429 TooManyRequests, by verb class and "
        "reason (queue full | timeout)",
        ("request_kind", "reason"),
    )
)
QUEUE_SHED = REGISTRY.register(
    LabeledCounter(
        "scheduler_queue_shed_pods_total",
        "Pods shed from the bounded scheduling queue, by reason: "
        "'evicted' = a parked pod dropped for a higher-priority arrival, "
        "'arrival' = the incoming pod itself rejected",
        ("reason",),
    )
)
PODS_DISPLACED = REGISTRY.register(
    LabeledCounter(
        "scheduler_pods_displaced_total",
        "Bound pods displaced back into the scheduling queue by a "
        "cluster-lifecycle event, by reason (node-lifecycle | drain | "
        "zone-outage).  Each re-enters through the shed-exempt displaced "
        "requeue path and must be rescheduled, not lost",
        ("reason",),
    )
)
ADAPTIVE_BATCH = REGISTRY.register(
    Gauge(
        "scheduler_adaptive_batch_size",
        "Current AIMD batch size (pods per scheduling cycle)",
    )
)
CYCLE_DEADLINE_EXCEEDED = REGISTRY.register(
    Counter(
        "scheduler_cycle_deadline_exceeded_total",
        "Scheduling cycles whose wall time overran the configured "
        "deadline budget (each triggers a multiplicative batch shrink)",
    )
)

# per-cycle phase accounting: the scheduler's phase_seconds
# dict was caller-only state (bench reporting); this family exposes the
# same cumulative seconds on /metrics so a dashboard can watch the
# encode/dispatch/fetch/commit split move without running the bench
CYCLE_PHASE_SECONDS = REGISTRY.register(
    LabeledCounter(
        "scheduler_cycle_phase_seconds_total",
        "Cumulative seconds spent per scheduling-cycle phase "
        "(pop|encode|dispatch|fetch|host_stall|commit|preempt) and "
        "latency tier (bulk|express); encode includes the extender/"
        "framework fan-out (the span tree at /debug/traces splits "
        "extenders out); fetch overlaps host phases and host_stall (the "
        "residual fence wait — the perf-observatory name; the scheduler's "
        "phase_seconds dict keeps fetch_block as a lockstep alias) is a "
        "subset of fetch, so phase sums exceeding wall clock means the "
        "pipeline is working",
        ("phase", "tier"),
    )
)

# device-resident megacycle: K pre-encoded batches chained
# through the cluster state in one dispatch (models/megacycle.py)
MEGACYCLES = REGISTRY.register(
    Counter(
        "scheduler_megacycles_total",
        "Megacycle launches dispatched (each chains K>=2 batches "
        "through the donated cluster state in one XLA launch; single-"
        "cycle dispatches are not counted here)",
    )
)
MEGACYCLE_DEPTH = REGISTRY.register(
    Gauge(
        "scheduler_megacycle_batches",
        "Effective megacycle depth K (batches chained per launch): the "
        "AIMD-steered current value under adaptiveBatch, else the last "
        "launched depth; 1 = single-cycle dispatch",
    )
)

# decision ledger + attribution: unschedulable verdicts by the
# dominant failing plugin (fed from the engine's attribution launch), and
# the ledger's own accounting — cycles accepted, bytes appended, records
# dropped by the bounded writer queue / max-cycles cap
UNSCHEDULABLE_REASONS = REGISTRY.register(
    LabeledCounter(
        "scheduler_unschedulable_reasons_total",
        "Unschedulable pods by dominant failing predicate/plugin "
        "(attribution path; the per-reason node counts ride the "
        "FailedScheduling event and the unschedulable-reason annotation)",
        ("plugin",),
    )
)
LEDGER_CYCLES = REGISTRY.register(
    Counter(
        "scheduler_ledger_cycles_total",
        "Scheduling cycles accepted into the decision ledger "
        "(ring and, when a ledger file is configured, the writer queue)",
    )
)
LEDGER_BYTES = REGISTRY.register(
    Counter(
        "scheduler_ledger_bytes_total",
        "Bytes appended to the decision-ledger file",
    )
)
LEDGER_DROPPED = REGISTRY.register(
    Counter(
        "scheduler_ledger_dropped_total",
        "Decision-ledger records dropped (writer queue full, max-cycles "
        "cap reached, or a failed write)",
    )
)

# cluster + device telemetry: fleet-state analytics from the
# device-resident snapshot reduction (ops/analytics.py), TPU runtime
# facts (HBM, compile cache, launch durations), and the SLO burn-rate
# evaluator (runtime/telemetry.py).  The reference exposes none of these
# — its scheduler has no device and no fleet-analytics pass — but they
# answer the operator questions PRs 5/7 left open: how utilized/
# fragmented is the fleet, how much HBM headroom does the engine have,
# are we burning a latency SLO.
CLUSTER_UTILIZATION = REGISTRY.register(
    LabeledGauge(
        "scheduler_cluster_utilization_ratio",
        "Per-resource cluster utilization statistic across valid nodes "
        "(requested/allocatable), by resource (cpu|memory|ephemeral|pods)"
        " and stat (mean|max|p50|p90|p99)",
        ("resource", "stat"),
    )
)
CLUSTER_LARGEST_FREE = REGISTRY.register(
    LabeledGauge(
        "scheduler_cluster_largest_free_capacity",
        "Largest free capacity on any single node, per resource — the "
        "biggest pod request that still fits somewhere, per dimension",
        ("resource",),
    )
)
CLUSTER_STRANDED = REGISTRY.register(
    LabeledGauge(
        "scheduler_cluster_stranded_capacity",
        "Free capacity stranded by the complementary resource: cpu = "
        "free cpu on nodes with no free memory, memory = vice versa",
        ("resource",),
    )
)
CLUSTER_FRAGMENTATION = REGISTRY.register(
    Gauge(
        "scheduler_cluster_fragmentation_index",
        "Stranded fraction of total free capacity (mean of the cpu and "
        "memory directions), 0 = none stranded, 1 = all free capacity "
        "unusable by a cpu+memory pod",
    )
)
CLUSTER_IMBALANCE = REGISTRY.register(
    Gauge(
        "scheduler_cluster_dominant_share_stddev",
        "Stddev across valid nodes of the dominant-resource share "
        "(0 = perfectly even packing)",
    )
)
CLUSTER_OCCUPANCY = REGISTRY.register(
    LabeledGauge(
        "scheduler_cluster_pods_per_node_occupancy_nodes",
        "Nodes per pod-capacity occupancy decile (decile 0 = <10% of "
        "pod slots used, 9 = >=90%)",
        ("decile",),
    )
)
CLUSTER_NODES = REGISTRY.register(
    Gauge("scheduler_cluster_nodes", "Valid nodes in the snapshot")
)
CLUSTER_PODS_RUNNING = REGISTRY.register(
    Gauge(
        "scheduler_cluster_pods_running",
        "Committed pods in the snapshot (sum of the pods column)",
    )
)
PENDING_PRESSURE = REGISTRY.register(
    LabeledGauge(
        "scheduler_pending_pressure_pods",
        "Pods pending per latency tier (bulk|express active+backoff "
        "demand; 'parked' = unschedulable pods waiting on an event)",
        ("tier",),
    )
)
DEVICE_HBM = REGISTRY.register(
    LabeledGauge(
        "ktpu_device_hbm_bytes",
        "Device memory from device.memory_stats(), by device index and "
        "kind (in_use|peak|limit); absent on backends without stats "
        "(the CPU fallback reports nothing rather than lying)",
        ("device", "kind"),
    )
)
COMPILE_CACHE_EVENTS = REGISTRY.register(
    LabeledCounter(
        "ktpu_compile_cache_events_total",
        "Persistent XLA compile-cache events (hit|miss), from "
        "jax.monitoring via utils/compilecache.py",
        ("event",),
    )
)
COMPILE_SECONDS = REGISTRY.register(
    Counter(
        "ktpu_backend_compile_seconds_total",
        "Cumulative XLA backend compile seconds this process paid "
        "(cache hits pay ~0; from jax.monitoring)",
    )
)
LAUNCH_EWMA = REGISTRY.register(
    LabeledGauge(
        "scheduler_launch_duration_ewma_seconds",
        "EWMA of the device dispatch->copy-complete window per "
        "executable batch width (the per-width launch cost the AIMD "
        "sizer is implicitly steering); stale widths are remove()d by "
        "the telemetry hub so the family stays bounded",
        ("width",),
        # the AIMD pow2 ladder tops out far below this; the guard fires
        # only if width labels start leaking non-pow2 values
        max_children=32,
    )
)
SLO_BURN_RATE = REGISTRY.register(
    LabeledGauge(
        "scheduler_slo_burn_rate",
        "Error-budget burn rate per SLO objective and window "
        "(fast|slow): 1.0 = burning exactly the budget; an alert fires "
        "when BOTH windows exceed the objective's threshold",
        ("objective", "window"),
    )
)
SLO_ALERTS = REGISTRY.register(
    LabeledCounter(
        "scheduler_slo_burn_alerts_total",
        "Multi-window SLO burn alerts fired (each dumps a throttled "
        "slo_burn flight-recorder postmortem)",
        ("objective",),
    )
)
TELEMETRY_SECONDS = REGISTRY.register(
    Counter(
        "scheduler_telemetry_seconds_total",
        "Cumulative scheduling-thread seconds spent in the telemetry "
        "hook (dispatch + materialize + gauges; the <2%-of-cycle-wall "
        "budget perf_smoke pins)",
    )
)
TELEMETRY_SAMPLES = REGISTRY.register(
    Counter(
        "scheduler_telemetry_samples_total",
        "Cluster-analytics samples materialized into the telemetry ring",
    )
)

# hot-path performance observatory (runtime/perfobs.py +
# codec/transfer.py accounting).  Transfer counters are computed from
# host-array nbytes at each wire seam — no device sync, always-on —
# and the per-phase EWMA matrix generalizes the launch EWMA to
# the full host/device cycle split served at /debug/perf.
TRANSFER_BYTES = REGISTRY.register(
    LabeledCounter(
        "ktpu_transfer_bytes_total",
        "Bytes moved across the host<->device wire, by direction "
        "(h2d|d2h) and seam (snapshot_upload|dirty_scatter|"
        "batch_replicate|upload|fetch|preempt); computed from array "
        "nbytes at the transfer call site, never from a device sync",
        ("direction", "seam"),
    )
)
TRANSFER_CALLS = REGISTRY.register(
    LabeledCounter(
        "ktpu_transfer_calls_total",
        "Host<->device transfer calls, by direction and seam (the "
        "round-trip count pairing ktpu_transfer_bytes_total)",
        ("direction", "seam"),
    )
)
PERF_PHASE_EWMA = REGISTRY.register(
    LabeledGauge(
        "scheduler_perf_phase_ewma_seconds",
        "EWMA seconds per cycle phase (host_enqueue|device_execute|"
        "d2h_materialize|host_stall|host_commit) and executable batch "
        "width — the per-cycle cost model the device-resident megacycle "
        "work (ROADMAP item 2) reads from; served at /debug/perf",
        ("phase", "width"),
        # 5 phases x the AIMD pow2 ladder (+ express width); the guard
        # fires only if width labels start leaking non-pow2 values
        max_children=128,
    )
)
PERFOBS_SECONDS = REGISTRY.register(
    Counter(
        "scheduler_perfobs_seconds_total",
        "Cumulative scheduling-thread seconds spent in the performance-"
        "observatory hook (cycle split + transfer delta + EWMA fold; "
        "the <2%-of-cycle-wall budget perf_smoke pins)",
    )
)

# placement-quality observatory (runtime/quality.py + the
# engines' quality_topk seam).  The observability stack measured speed
# (perfobs) and state (telemetry); these families measure DECISION
# QUALITY — how confident each placement was (winner margin over the
# runner-up), how constrained (feasible candidates), how dense vs a
# greedy FFD counterfactual (regret), and whether packing quality is
# drifting.  This is the per-decision reward signal ROADMAP item 4's
# learned-scoring loop consumes.
PLACEMENT_MARGIN = REGISTRY.register(
    LabeledHistogram(
        "scheduler_placement_margin",
        "Normalized winner margin per placed pod — (top-1 score minus "
        "runner-up score) / max(1, |top-1|), by latency tier; observed "
        "only for pods with >= 2 feasible candidates (a margin over "
        "nothing is not confidence)",
        ("tier",), default_labels={"tier": TIER_BULK},
        # margins live in [0, ~2]: sub-permille ties up to a clear win
        buckets=[0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.0],
        max_children=8,  # the two tiers; the guard catches label leaks
    )
)
PLACEMENT_REGRET = REGISTRY.register(
    Gauge(
        "scheduler_placement_regret",
        "Packing regret vs the greedy FFD counterfactual, from the last "
        "amortized sample: distinct nodes the live placements touched / "
        "nodes first-fit-decreasing needed for the same pods against "
        "the same pre-cycle free capacity (1.0 = as dense as FFD; > 1 "
        "is the price of spreading/affinity priorities, the yardstick "
        "the constraint-based-packing paper frames)",
    )
)
FEASIBLE_NODES = REGISTRY.register(
    Histogram(
        "scheduler_feasible_nodes",
        "Feasible candidate nodes the selector actually considered per "
        "pod (post-predicate, post-adaptive-sampling mask population)",
        buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096,
                 16384, 65536],
    )
)
QUALITY_DRIFT_ALERTS = REGISTRY.register(
    LabeledCounter(
        "scheduler_quality_drift_alerts_total",
        "Packing-quality drift alerts from the dual-window EWMA step "
        "detector, by series (margin | utilization_cpu | fragmentation);"
        " each fires a throttled quality_drift flight-recorder "
        "postmortem through the scheduler's SLO seam",
        ("series",),
        max_children=16,  # the detector series set is fixed and small
    )
)
QUALITY_REGRET_SAMPLES = REGISTRY.register(
    Counter(
        "scheduler_quality_regret_samples_total",
        "FFD-counterfactual regret samples materialized (dispatched "
        "every qualityIntervalCycles, fetched one interval later so the "
        "scheduling thread never blocks on the binpack launch)",
    )
)
QUALITY_SECONDS = REGISTRY.register(
    Counter(
        "scheduler_quality_seconds_total",
        "Cumulative scheduling-thread seconds spent in the placement-"
        "quality hook (top-k materialize + margin/drift fold + the "
        "amortized regret dispatch; the <2%-of-cycle-wall budget "
        "perf_smoke pins)",
    )
)

# --- device-resident capacity planner (runtime/capacity.py) ---
# the class-compressed what-if binpack of the live backlog over the
# node-shape catalog, solved as an amortized side-launch behind the
# scheduling loop; gauges reflect the last materialized solve
CAPACITY_SECONDS = REGISTRY.register(
    Counter(
        "scheduler_capacity_seconds_total",
        "Cumulative scheduling-thread seconds spent in the capacity-"
        "planner hook (backlog snapshot + class compression + the "
        "amortized two-stage solve dispatch; the <2%-of-cycle-wall "
        "budget perf_smoke pins)",
    )
)
CAPACITY_SOLVES = REGISTRY.register(
    Counter(
        "scheduler_capacity_solves_total",
        "Capacity what-if solves materialized (dispatched every "
        "capacityIntervalCycles, fetched one interval later so the "
        "scheduling thread never blocks on the binpack launch)",
    )
)
CAPACITY_BACKLOG = REGISTRY.register(
    LabeledGauge(
        "scheduler_capacity_backlog",
        "Pending+unschedulable backlog the last solve packed, by kind "
        "(pods = raw backlog size, classes = distinct request vectors "
        "after class compression — their ratio is the scan-axis "
        "compression the count kernel banks)",
        ("kind",),
        max_children=8,
    )
)
CAPACITY_ABSORBED = REGISTRY.register(
    Gauge(
        "scheduler_capacity_absorbed_pods",
        "Backlog pods the last solve packed into EXISTING node headroom "
        "(stage 1) — only the remainder needs new capacity",
    )
)
CAPACITY_OVERFLOW = REGISTRY.register(
    Gauge(
        "scheduler_capacity_overflow_pods",
        "Backlog pods the existing headroom could NOT absorb — the "
        "scale-up demand the shape sweep (stage 2) sizes",
    )
)
CAPACITY_RECOMMENDED = REGISTRY.register(
    LabeledGauge(
        "scheduler_capacity_recommended_nodes",
        "Nodes of the winning catalog shape the last solve recommends "
        "adding to absorb the overflow (the cheapest all-fitting shape)",
        ("shape",),
        max_children=128,  # bounded by the catalog size
    )
)
CAPACITY_DRAINABLE = REGISTRY.register(
    Gauge(
        "scheduler_capacity_drainable_nodes",
        "Valid, pod-free nodes the headroom pack left untouched — "
        "drainable without moving anything (the scale-down half of the "
        "recommendation)",
    )
)

# --- guarded autoscaler actuation (runtime/autoscaler.py) ---
# the controller that ENACTS the capacity planner's recommendation:
# paced node registration, PDB-funneled drains, hysteresis + rollback
AUTOSCALER_NODES_ADDED = REGISTRY.register(
    Counter(
        "scheduler_autoscaler_nodes_added_total",
        "Nodes the autoscaler registered from the winning catalog "
        "shape (scale-up actuations; a mid-batch fault deregisters the "
        "partial batch and does NOT count here)",
    )
)
AUTOSCALER_NODES_REMOVED = REGISTRY.register(
    Counter(
        "scheduler_autoscaler_nodes_removed_total",
        "Nodes the autoscaler drained (cordon + PDB/Retry-After "
        "eviction waves) and deleted (scale-down actuations; a rolled-"
        "back drain does NOT count here)",
    )
)
AUTOSCALER_FLAPS = REGISTRY.register(
    Counter(
        "scheduler_autoscaler_flaps_total",
        "Actuations SUPPRESSED by the hysteresis guard: a direction "
        "change (add<->remove) that would exceed the bounded changes "
        "per cooldown window held instead of flapping the fleet",
    )
)
AUTOSCALER_ROLLBACKS = REGISTRY.register(
    LabeledCounter(
        "scheduler_autoscaler_rollbacks_total",
        "Automatic actuation rollbacks, by direction: a scale-down "
        "whose drain stranded pods past the deadline un-cordoned and "
        "aborted, or a scale-up that faulted mid-batch deregistered "
        "the partial batch",
        ("direction",),
        max_children=4,
    )
)
AUTOSCALER_COST = REGISTRY.register(
    Gauge(
        "scheduler_autoscaler_cost_node_seconds",
        "Accumulated node-seconds of autoscaler-managed capacity (the "
        "banked cost objective the diurnal breathe scenario minimizes "
        "against goodput)",
    )
)
AUTOSCALER_MANAGED = REGISTRY.register(
    Gauge(
        "scheduler_autoscaler_managed_nodes",
        "Nodes currently registered and managed by the autoscaler "
        "(the breathing half of the fleet)",
    )
)

# --- queue-sharded scheduler replicas ---
REPLICAS = REGISTRY.register(
    Gauge(
        "scheduler_replicas",
        "Scheduler replicas sharing this process's queue/cache (1 = the "
        "classic single scheduling loop)",
    )
)
REPLICA_CONFLICTS = REGISTRY.register(
    LabeledCounter(
        "scheduler_replica_conflicts_total",
        "Optimistic-concurrency commit conflicts detected by the "
        "sequenced reconciler, per dispatching replica: a sequenced-"
        "earlier commit spent the winner's node headroom, so the pod "
        "was requeued to its owner shard",
        ("replica",),
    )
)
REPLICA_REQUEUED = REGISTRY.register(
    Counter(
        "scheduler_replica_requeued_pods_total",
        "Pods the conflict reconciler requeued instead of admitting "
        "(race losers back to the owner shard + namespace-quota vetoes "
        "parked unschedulable) — shed-exempt, no popped pod is lost",
    )
)

# --- metrics timeline store (runtime/timeline.py) ---
# the longitudinal layer: every family above is a point-in-time
# snapshot; the timeline store samples them all on a cadence into
# bounded series, so a scenario/autoscaler run leaves a queryable
# trajectory instead of only terminal numbers
TIMELINE_SAMPLES = REGISTRY.register(
    Counter(
        "scheduler_timeline_samples_total",
        "Sampling sweeps the timeline store completed over the whole "
        "metric registry (one sweep touches every family)",
    )
)
TIMELINE_SECONDS = REGISTRY.register(
    Counter(
        "scheduler_timeline_seconds_total",
        "Cumulative seconds the scheduling thread spent inside the "
        "timeline hook (sampling sweep + anomaly detection) — the "
        "<2%-of-cycle-wall budget perf_smoke pins",
    )
)
TIMELINE_LAG = REGISTRY.register(
    Gauge(
        "scheduler_timeline_lag_seconds",
        "How far the last sampling sweep ran behind its configured "
        "cadence (0 = on time; sampling falling behind is itself a "
        "signal, surfaced on the heartbeat line)",
    )
)
TIMELINE_SERIES = REGISTRY.register(
    Gauge(
        "scheduler_timeline_series",
        "Live series the timeline store currently retains (one per "
        "sampled family child / histogram quantile)",
    )
)
TIMELINE_EVENTS = REGISTRY.register(
    LabeledCounter(
        "scheduler_timeline_events_total",
        "Typed event annotations pushed into the timeline, by kind "
        "(breaker/shard transitions, mesh rebuilds, AIMD resizes, "
        "autoscaler rounds, SLO burns, shed bursts, chaos windows)",
        ("kind",),
        max_children=32,
    )
)
TIMELINE_ANOMALIES = REGISTRY.register(
    LabeledCounter(
        "scheduler_timeline_anomalies_total",
        "Anomaly-rule firings over sampled series, by rule and series "
        "(threshold / zscore / slope; each firing is throttled and "
        "re-arms only after the series recovers)",
        ("rule", "series"),
        max_children=64,
    )
)


def sample_families(registry: Optional[Registry] = None,
                    quantiles: Tuple[float, ...] = (0.5, 0.99),
                    ) -> List[Tuple[str, str, float]]:
    """One sampling sweep over every registered family, flattened to
    (series, kind, value) triples — THE timeline sampling protocol
    (runtime/timeline.py TimelineStore calls this on its cadence):

    - Counter           -> ("name", "counter", value): the store keeps
                           per-sample deltas, so rates fall out of the
                           timestamps
    - Gauge             -> ("name", "gauge", value)
    - Labeled families  -> one triple per live child, named with the
                           exposition label syntax: 'name{k="v",...}'
    - Histogram         -> ('name:p50'/'name:p99' gauges via the
                           interpolating quantile estimator) +
                           ('name:count', 'counter', total)
    - LabeledHistogram  -> the same per child: 'name{k="v"}:p99'

    Kinds mirror the exposition TYPE line because the store treats them
    differently: counters are monotone (delta-encoded), gauges are not.
    """
    reg = registry if registry is not None else REGISTRY
    with reg._lock:
        families = list(reg._metrics.values())
    out: List[Tuple[str, str, float]] = []

    def _lbl(names: Tuple[str, ...], key: Tuple[str, ...]) -> str:
        return "{" + ",".join(
            f'{n}="{v}"' for n, v in zip(names, key)
        ) + "}"

    def _hist(name: str, h: Histogram) -> None:
        for q in quantiles:
            out.append((f"{name}:p{int(q * 100)}", "gauge", h.quantile(q)))
        out.append((f"{name}:count", "counter", float(h.total)))

    for fam in families:
        if isinstance(fam, LabeledHistogram):
            with fam._lock:
                children = sorted(fam._children.items())
            for key, h in children:
                _hist(fam.name + _lbl(fam.label_names, key), h)
        elif isinstance(fam, Histogram):
            _hist(fam.name, fam)
        elif isinstance(fam, (LabeledGauge, LabeledCounter)):
            kind = "gauge" if isinstance(fam, LabeledGauge) else "counter"
            with fam._lock:
                children = sorted(fam._children.items())
            for key, v in children:
                out.append(
                    (fam.name + _lbl(fam.label_names, key), kind, float(v))
                )
        elif isinstance(fam, Gauge):
            out.append((fam.name, "gauge", float(fam.value)))
        elif isinstance(fam, Counter):
            out.append((fam.name, "counter", float(fam.value)))
    return out


# schedule_attempts_total result label values (metrics.go:44-52)
SCHEDULED, UNSCHEDULABLE, SCHEDULE_ERROR = "scheduled", "unschedulable", "error"
