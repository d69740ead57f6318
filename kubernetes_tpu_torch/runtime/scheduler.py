"""The scheduling service: the scheduleOne loop, batched (PyTorch port).

The port of the JAX package's runtime/scheduler.py live cycle, with the
branches of later slices removed.  Mirrors Scheduler.Run / scheduleOne (ref
pkg/scheduler/scheduler.go:250-593) with one structural change: each cycle
drains a batch from the queue and places it with a device engine
(models/speculative.py, or models/batched.py's sequential engine) —
semantically the same as running scheduleOne B times against a
continuously-updated cache.

Per cycle:
  1. queue.pop_batch                          (NextPod, scheduler.go:438-447)
  2. encode the batch, its ports, in-batch affinity and the nominated pods
     under the cache lock; cache.snapshot + the encoder's dirty rows
  3. DeviceSnapshotCache.update scatters the dirty rows into the resident
     device snapshot; the engine runs; AsyncFetch starts the winners' D2H
  4. the fence (AsyncFetch.result), then the state commit: one batched
     assume of every winner (cache + encoder delta)
  5. the tail: per pod bind via the binder callback, requeue of losers,
     events and metrics — under pipeline_commit it runs after the NEXT
     batch's dispatch
  6. preemption for every pod that failed to fit (scheduler.go:463-475):
     candidate nodes on the device, node and victims from kernel K2
     (models/preemption.py), the victims deleted and the preemptor
     nominated and requeued

Device faults are classified (codec/faults.py): transient ones retry the
same batch with backoff, a persistent one or a failure streak trips the
breaker (runtime/health.py); when the device is given up on, the batch's
popped pods are requeued and the error propagates.  A fault in the
preemption's candidate evaluation feeds the breaker and propagates too.
The port carries no CPU degradation engine and refuses every setting of a
later slice (`refused_settings`): nothing degrades quietly.

With quality_top_k > 0 (the JAX class's default, 3) both engines also
return each pod's winner-pinned top-k (kernel K3 on the card); the three
leaves ride the winners' D2H copy, and after each committed cycle the
placement-quality observatory (runtime/quality.py) folds them into margins
and feasible counts and, every quality_interval_cycles cycles, launches the
FFD regret counterfactual (kernel K4) without waiting on it.

With megacycle_batches = K > 1, a window whose pods couple to later
windows only through resources and at most one spread group
(_megacycle_ready / _megacycle_safe, as in the reference) pops up to K - 1
more such windows, and the K windows run as one megacycle
(models/megacycle.py): one dispatch chains them through the cluster state
on the device (the spread counts by kernel K6), one fence and one fetch
bring back all K winner vectors, and the K state commits land in window
order before the next dispatch encodes.  The megacycle is one retryable
unit: a classified fault relaunches all K windows with the same rotation
bases; an error that escapes requeues every window not yet committed and
still runs the committed windows' tails.

With extenders (HTTPExtender, extender/client.py; built from a Policy
profile's "extenders" entries when none are passed), each cycle fans its
pods out to the filter and prioritize verbs after the encode, 16 pods at
a time, each pod's chain in config order: a filter reply vetoes nodes in
the engine's extra mask, a prioritize reply adds score * weight to its
extra score, and a pod whose non-ignorable extender errored is masked out
and requeued as a plain error (no FitError, no preemption).  A bind-verb
extender binds the pods it manages in place of the binder, and
preempt-verb extenders vet each preemption's node and victims.  A batch
with filter or prioritize extenders never joins a megacycle.

With telemetry on (the JAX class's default), each committed cycle feeds the
telemetry hub (runtime/telemetry.py): SLO events, queue pressure, the
launch EWMA, and once every telemetry_interval_cycles the cluster analytics
of the resident snapshot (kernel K5 on the card), read one interval later.
The quality observatory then reads the sample the hub has just
materialized, and last the metrics timeline (runtime/timeline.py), also
ticked on idle polls, samples every metric once gauges have settled.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Pod, PodDisruptionBudget
from kubernetes_tpu_torch.codec import faults as device_faults
from kubernetes_tpu_torch.codec.faults import (
    FAULT_PERSISTENT,
    CorruptedFetchError,
    classify_device_error,
)
from kubernetes_tpu_torch.codec.schema import FilterConfig, PodBatch
from kubernetes_tpu_torch.codec.transfer import (
    AsyncFetch,
    DeviceSnapshotCache,
    _dc_to,
    host_fetch,
    transfer_delta,
    transfer_totals,
)
from kubernetes_tpu_torch.kernels import wrap_i32
from kubernetes_tpu_torch.models.batched import (
    batch_has_pod_affinity,
    encode_batch_affinity,
    encode_batch_ports,
    encode_nominated,
    encode_nominated_block,
    make_sequential_scheduler,
)
from kubernetes_tpu_torch.models.megacycle import (
    make_megacycle_scheduler,
    stack_windows,
)
from kubernetes_tpu_torch.models.preemption import (
    make_preempt_eval,
    pick_preemption_node,
    sorted_victim_slots,
)
from kubernetes_tpu_torch.models.speculative import make_speculative_scheduler
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.events import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    EventRecorder,
)
from kubernetes_tpu_torch.ops.select import TopKQuality
from kubernetes_tpu_torch.runtime import capacity as capacity_mod
from kubernetes_tpu_torch.runtime import quality as quality_mod
from kubernetes_tpu_torch.runtime import reconciler as reconciler_mod
from kubernetes_tpu_torch.runtime import telemetry as telemetry_mod
from kubernetes_tpu_torch.runtime import timeline as timeline_mod
from kubernetes_tpu_torch.runtime.flightrecorder import RECORDER, FlightRecorder
from kubernetes_tpu_torch.runtime.health import DeviceHealth
from kubernetes_tpu_torch.runtime.invariants import InvariantChecker
from kubernetes_tpu_torch.runtime.queue import TIER_BULK, PriorityQueue
from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils import metrics as m
from kubernetes_tpu_torch.utils.trace import (
    Span,
    current_trace_id,
    use_traceparent,
)

TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
ENGINES = ("speculative", "sequential")


@dataclass
class SchedulerConfig:
    """The JAX package's SchedulerConfig, field for field and with its
    defaults, so both classes read the same.  The port's Scheduler refuses
    every setting that belongs to a later slice (see refused_settings): in
    particular the default cpu_fallback=True is refused, so callers pass
    cpu_fallback=False."""

    batch_size: int = 256
    batch_window_s: float = 0.001
    # "speculative" (default) = parallel placement + conflict repair with
    # the hybrid exactness fallback into the sequential engine;
    # "sequential" = always the exact one-pod-at-a-time engine
    engine: str = "speculative"
    percentage_of_nodes_to_score: int = 100
    disable_preemption: bool = False
    # batched commit: apply a cycle's winners as ONE cache/encoder delta
    # under a single lock acquisition, with batched event/metric emission,
    # instead of the per-pod assume->bind loop (state-equivalent)
    batched_commit: bool = True
    # pipelined commit: overlap batch k's host bind/event/requeue tail with
    # batch k+1's device dispatch; the STATE half of the commit (assume +
    # encoder delta) still lands before batch k+1 encodes
    pipeline_commit: bool = False
    # --- device-fault resilience (runtime/health.DeviceHealth) ---
    device_retry_max: int = 2
    device_backoff_base_s: float = 0.005
    device_backoff_max_s: float = 0.05
    device_backoff_jitter: float = 0.5
    breaker_failure_threshold: int = 3
    breaker_open_s: float = 0.05
    cpu_fallback: bool = True
    # --- overload protection & backpressure ---
    queue_capacity: Optional[int] = None
    adaptive_batch: bool = False
    batch_size_min: int = 16
    cycle_deadline_s: float = 0.0
    # --- tracing (utils/trace.py spans + runtime/flightrecorder.py) ---
    trace_threshold_s: float = 0.1
    # --- latency tiers and raw-speed knobs ---
    express_lane: bool = False
    express_batch_size: int = 64
    express_priority_threshold: Optional[int] = None
    compile_cache_dir: Optional[str] = None
    prewarm_widths: bool = False
    # --- decision ledger + attribution ---
    attribution: bool = False
    decision_ledger: bool = False
    ledger_dir: Optional[str] = None
    ledger_max_cycles: int = 4096
    # --- cluster + device telemetry ---
    telemetry: bool = True
    telemetry_interval_cycles: int = 1
    slo_objectives: Optional[list] = None
    heartbeat_s: float = 0.0
    # --- multi-chip sharding and the elastic ladder ---
    shard_devices: int = 0
    mesh_shape: Optional[str] = None
    mesh_shrink: bool = True
    shard_breaker_failure_threshold: int = 2
    # online invariant checker (runtime/invariants.py): conservation of
    # popped pods, no double-bind, committed usage <= allocatable
    invariant_checks: bool = True
    # --- performance observatory ---
    profile_dir: Optional[str] = None
    # --- device-resident megacycle ---
    megacycle_batches: int = 1
    # --- placement-quality observatory ---
    quality_top_k: int = 3
    quality_interval_cycles: int = 32
    quality_drift_threshold: float = 0.25
    # --- capacity planner ---
    capacity_planner: bool = False
    capacity_interval_cycles: int = 256
    node_shape_catalog: Optional[list] = None
    # --- metrics timeline store ---
    timeline: bool = True
    timeline_interval_s: float = 1.0
    timeline_retention: int = 512
    timeline_rules: Optional[list] = None
    # --- queue-sharded scheduler replicas ---
    replicas: int = 1
    namespace_quotas: Optional[dict] = None
    # multi-scheduler: only pods whose spec.schedulerName names THIS
    # scheduler enter its queue (eventhandlers.go responsibleForPod)
    scheduler_name: str = "default-scheduler"
    weights: Optional[Sequence[float]] = None
    filter_config: FilterConfig = field(default_factory=FilterConfig)
    profile: Optional[object] = None  # a SchedulingProfile; overrides
    #                                   filter_config/weights when set


def refused_settings(config: SchedulerConfig) -> List[Tuple[str, str]]:
    """[(setting, ROADMAP item that lifts it)] for every setting of
    `config` that belongs to a later slice of the port."""
    c = config
    checks = (
        (c.cpu_fallback, "cpu_fallback=True",
         "A5 (the CPU degradation engine)"),
        (c.heartbeat_s > 0, f"heartbeat_s={c.heartbeat_s}",
         "A9 (observatories and ledger)"),
        (c.profile_dir is not None, "profile_dir",
         "A9 (observatories and ledger)"),
        (c.attribution, "attribution=True", "A9 (observatories and ledger)"),
        (c.decision_ledger, "decision_ledger=True",
         "A9 (observatories and ledger)"),
        (bool(c.shard_devices), f"shard_devices={c.shard_devices}",
         "A11 (multi-device)"),
        (c.mesh_shape is not None, "mesh_shape", "A11 (multi-device)"),
        (c.express_lane, "express_lane=True",
         "A12 (latency tiers and raw-speed knobs)"),
        (c.adaptive_batch, "adaptive_batch=True",
         "A12 (latency tiers and raw-speed knobs)"),
        (c.prewarm_widths, "prewarm_widths=True",
         "A12 (latency tiers and raw-speed knobs)"),
        (c.compile_cache_dir is not None, "compile_cache_dir",
         "A12 (latency tiers and raw-speed knobs)"),
        (c.engine not in ENGINES, f"engine={c.engine!r}", "(no engine)"),
    )
    return [(what, item) for cond, what, item in checks if cond]


@dataclass
class ScheduleResult:
    pod: Pod
    node: Optional[str]          # None = unschedulable
    generation: int = 0


@dataclass
class _InFlight:
    """One dispatched-but-unfetched cycle: the double-buffer slot of the
    pipelined commit path.  `fetch` is the AsyncFetch whose D2H copy
    started the moment the winners were dispatched."""

    pods: List[Pod]
    hosts_dev: object            # device i32[B] winners
    fetch: object                # AsyncFetch
    generation: int
    cycle: int
    t_cycle0: float
    trace: Span                  # the cycle's ROOT span
    # batch index -> message of every pod a non-ignorable extender failed:
    # requeued as a plain error, no FitError and no preemption
    ext_failed: Dict[int, str] = field(default_factory=dict)
    # re-dispatch the SAME encoded batch (transient-retry path)
    relaunch: Optional[Callable[[], Tuple[object, AsyncFetch]]] = None
    last_index0: int = 0         # selectHost rotation base for this batch
    tier: str = TIER_BULK
    width: int = 0               # the encoded (padded) batch width
    # scheduling-thread seconds from encode start to the dispatch returning
    enqueue_s: float = 0.0
    # transfer_totals() at encode time: the fence diffs against it
    xfer0: Optional[dict] = None
    # --- placement-quality observatory (quality_top_k > 0) ---
    # the host TopKQuality, set at the fence from the leaves that rode the
    # winners' copy
    quality: Optional[TopKQuality] = None
    # the encoded batch's request matrix (host ref): the regret
    # counterfactual's pod side
    quality_reqs: object = None
    # THIS cycle's pre-dispatch host snapshot refs (allocatable,
    # requested, valid; immutable under the encoder's copy-on-write): set
    # for every single cycle, but only for window 0 of a megacycle (later
    # windows placed against chained state the snapshot predates)
    quality_snapshot: Optional[tuple] = None
    # (k, K) when this cycle is window k of a K-window megacycle: its
    # winners came from one shared dispatch and fetch, whose seconds are
    # attributed 1/K to each window
    mega: Optional[Tuple[int, int]] = None
    # the capacity planner's host snapshot refs (allocatable, requested,
    # valid) of the state this cycle placed against (window 0 only)
    capacity_snapshot: Optional[tuple] = None
    # --- queue-sharded replicas ---
    # the encoded batch's request matrix (host ref): the reconciler's
    # admission scan input
    reqs: object = None
    # the reconciler's commit sequence number (-1 outside replica mode)
    commit_seq: int = -1
    # the encoder generation right after this cycle's commit (the chained
    # fence of a megacycle's next window)
    gen_after: int = -1


@dataclass
class _Staged:
    """A fetched cycle whose cache-STATE half (batched assume) has been
    applied; the side-effect tail (binds/events/metrics) is still pending
    and may overlap the next batch's device dispatch."""

    inf: _InFlight
    hosts: np.ndarray
    algo_dt: float
    batched: bool
    t_state0: float = 0.0
    state_seconds: float = 0.0
    # (batch index, pod, assumed copy, node name) per device winner
    winners: List[Tuple] = field(default_factory=list)
    fit_idx: List[int] = field(default_factory=list)
    # residual host wait at the ready fence
    stall_s: float = 0.0
    # THIS cycle's wire traffic, taken at the commit fence
    xfer_delta: Optional[dict] = None
    # replica mode: (batch index, pod) of winners a sequenced-earlier
    # commit beat to the node's headroom (readded to the owner shard) and
    # of winners a namespace quota vetoed (parked unschedulable)
    race_lost: List[Tuple] = field(default_factory=list)
    quota_lost: List[Tuple] = field(default_factory=list)


@dataclass
class _MegaFlight:
    """One dispatched megacycle: K window _InFlight records sharing one
    dispatch (stacked i32[K, B] winners, one AsyncFetch that also carries
    the stacked quality leaves, one relaunch closure).  The fault handling
    treats it as one retryable unit: a classified fault at the fence
    relaunches the whole megacycle with the same windows and rotation
    bases."""

    windows: List[_InFlight]
    fetch: object                # AsyncFetch of the stacked winners
    relaunch: Optional[Callable] = None


class _HostResult:
    """AsyncFetch-shaped handle for one megacycle window's slice of the
    fetched winners (and quality leaves), already on the host; `seconds`
    and its split carry 1/K of the shared fetch's."""

    def __init__(self, hosts: np.ndarray, extras: tuple = (),
                 seconds: float = 0.0, execute_seconds: float = 0.0,
                 materialize_seconds: float = 0.0) -> None:
        self._hosts = hosts
        self._extras = extras
        self.seconds = seconds
        self.execute_seconds = execute_seconds
        self.materialize_seconds = materialize_seconds

    def result(self) -> np.ndarray:
        return self._hosts

    def extras_result(self) -> tuple:
        return self._extras


class Scheduler:
    """Binder: callable (pod, node_name) -> bool (the POST .../binding
    analog, scheduler.go:411-435).  A False/raising binder triggers
    ForgetPod + requeue.

    device: where the engines run ("cuda" unless the caller passes "cpu");
    a CUDA device on a machine without one raises."""

    UNSCHED_REASON_ANNOTATION = "kubernetes-tpu.io/unschedulable-reason"
    POD_GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"
    _BIND_REJECT_MSG = "Binding rejected for %s/%s on %s"
    # the rung of the reference's degradation ladder that serves every
    # port cycle (one device, no CPU fallback), and its gauge value
    _RUNG = "single_chip"
    _RUNG_GAUGE = 2.0

    def __init__(
        self,
        cache: Optional[SchedulerCache] = None,
        queue: Optional[PriorityQueue] = None,
        binder: Optional[Callable[[Pod, str], bool]] = None,
        config: Optional[SchedulerConfig] = None,
        victim_deleter: Optional[Callable[[Pod], None]] = None,
        pdb_lister: Optional[Callable[[], List[PodDisruptionBudget]]] = None,
        framework=None,
        recorder: Optional[EventRecorder] = None,
        extenders: Optional[Sequence] = None,
        flight_recorder: Optional[FlightRecorder] = None,
        ledger=None,
        replica_id: int = 0,
        replica_of: int = 1,
        reconciler=None,
        snapshot_hub=None,
        share_engines_with=None,
        device="cuda",
    ):
        self.config = config if config is not None else SchedulerConfig()
        refused = refused_settings(self.config)
        if framework is not None:
            refused.append(("framework", "A8 (gang and framework plugins)"))
        if ledger is not None:
            refused.append(("ledger", "A9 (observatories and ledger)"))
        if refused:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(
                    f"{what} (ROADMAP {item})" for what, item in refused))
        self.device = torch.device(device)
        # queue-sharded replicas: this instance's replica index (= the
        # stable queue hash-shard it pops), the shared sequenced reconciler
        # and the shared snapshot hub; replica_of == 1 with neither is the
        # single-loop scheduler
        self._replica_id = int(replica_id)
        self._replica_of = max(1, int(replica_of))
        self._reconciler = reconciler
        self._hub = snapshot_hub
        self.conflicts_total = 0        # race losers this replica requeued
        self.race_requeued_total = 0
        self.quota_vetoed_total = 0
        if self._reconciler is not None and not self.config.batched_commit:
            raise ValueError(
                "replica mode requires batched_commit: the conflict "
                "reconciler admits a cycle's winners as one sequenced "
                "critical section"
            )
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Scheduler(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run on the host")
        # NB: PriorityQueue defines __len__, so `queue or PriorityQueue()`
        # would silently replace an *empty* caller-owned queue
        self.cache = cache if cache is not None else SchedulerCache()
        self.queue = (
            queue if queue is not None
            else PriorityQueue(capacity=self.config.queue_capacity)
        )
        if getattr(self.queue, "on_shed", "n/a") is None:
            self.queue.on_shed = self._on_shed
        # online invariant checker: every requeue path funnels through the
        # queue's on_requeue observer (a caller-owned observer is chained)
        self.invariants = None
        if self.config.invariant_checks:
            if hasattr(self.queue, "on_requeue"):
                self.invariants = InvariantChecker(
                    on_violation=self._on_invariant_violation
                )
                prior = self.queue.on_requeue
                if prior is None:
                    self.queue.on_requeue = self.invariants.note_requeued
                else:
                    note = self.invariants.note_requeued

                    def _chained_requeue(pod, _prior=prior, _note=note):
                        _prior(pod)
                        _note(pod)

                    self.queue.on_requeue = _chained_requeue
            else:
                klog.infof(
                    "invariant checker disabled: queue %s has no "
                    "on_requeue seam to observe",
                    type(self.queue).__name__,
                )
        self.binder = binder if binder is not None else (lambda pod, node: True)
        enc = self.cache.encoder
        prof = self.config.profile
        if prof is not None:
            self.config.filter_config = prof.filter_config
            self.config.weights = prof.weights_array()
        enc.hard_pod_affinity_weight = (
            self.config.filter_config.hard_pod_affinity_weight)
        self.config.filter_config = enc.adopt_filter_config(
            self.config.filter_config
        )
        self._unsched_key = enc.interner.intern(TAINT_NODE_UNSCHEDULABLE)
        # placement-quality top-k width: an output-only engine setting
        # (the winners are the same with it on and off)
        self._quality_k = max(0, int(self.config.quality_top_k))
        if self.device.type == "cuda":
            # the kernels (K1-K5) are built now, so a build error raises
            # here and not inside a cycle
            from kubernetes_tpu_torch.kernels._build import library

            library()
        engine_kw = dict(
            cfg=self.config.filter_config,
            weights=self.config.weights,
            unsched_taint_key=self._unsched_key,
            zone_key_id=enc.getzone_key,
            score_cfg=prof.score_config if prof is not None else None,
            percentage_of_nodes_to_score=(
                self.config.percentage_of_nodes_to_score),
            quality_topk=self._quality_k,
            device=self.device,
        )
        if share_engines_with is not None:
            # replica siblings reuse the primary's engines
            self._schedule_fn = share_engines_with._schedule_fn
            self._speculative_fn = share_engines_with._speculative_fn
            self._preempt_eval = share_engines_with._preempt_eval
        else:
            self._schedule_fn = make_sequential_scheduler(**engine_kw)
            self._speculative_fn = (
                make_speculative_scheduler(**engine_kw)
                if self.config.engine == "speculative" else None
            )
            self._preempt_eval = make_preempt_eval(
                self.config.filter_config, self._unsched_key
            )
        self._engine_kind = (
            "sequential" if self._speculative_fn is None else "speculative"
        )
        # the device-resident megacycle: the K-window driver over the same
        # engine the single cycles run, so its placements are chained
        # single-cycle placements by construction
        if share_engines_with is not None:
            self._mega_fn = share_engines_with._mega_fn
        else:
            self._mega_fn = (
                make_megacycle_scheduler(**engine_kw,
                                         engine=self._engine_kind)
                if self.config.megacycle_batches > 1 else None
            )
        self.megacycles_total = 0
        # incremental host->device snapshot upload: unchanged fields keep
        # their resident tensors between cycles, dirty rows scatter in
        self._dev_snapshot = DeviceSnapshotCache(self.device)
        self.framework = None
        # scheduler-side extender chain (core/extender.go; chained in config
        # order at generic_scheduler.go:527-554); built from the Policy's
        # "extenders" entries when not injected directly
        if extenders is None and prof is not None and prof.extender_configs:
            from kubernetes_tpu_torch.extender.client import HTTPExtender

            extenders = [HTTPExtender(c) for c in prof.extender_configs]
        self.extenders = list(extenders or [])
        # seconds of the cycles' extender fan-outs (the "extenders" span)
        self.extender_seconds = 0.0
        self._recorder_defaulted = recorder is None
        self.recorder = recorder if recorder is not None else EventRecorder()
        self.victim_deleter = victim_deleter or (
            lambda pod: self.cache.remove_pod(pod))
        self.pdb_lister = pdb_lister or (lambda: [])
        # (preemptor key, node name, victim keys) of every nomination
        self.preemptions: List[Tuple] = []
        # seconds inside preempt(), by step: "candidates" (snapshot
        # update, eval and fetch of the candidate mask), "arrays" (the
        # arena, PDB flags and victim slots, the what-if's host arrays and
        # their upload), "pick" (kernel K2 and the fetch of its result),
        # "verify" (verify_nomination) and "evict" (victim deletions,
        # events and the nomination)
        self.preempt_seconds: Dict[str, float] = {
            "candidates": 0.0, "arrays": 0.0, "pick": 0.0, "verify": 0.0,
            "evict": 0.0,
        }
        self._last_index = 0
        self._stop = threading.Event()
        self._in_cycle = False
        # classified retry/backoff + circuit breaker (runtime/health.py)
        self.device_health = DeviceHealth(
            failure_threshold=self.config.breaker_failure_threshold,
            open_duration_s=self.config.breaker_open_s,
            backoff_base_s=self.config.device_backoff_base_s,
            backoff_max_s=self.config.device_backoff_max_s,
            backoff_jitter=self.config.device_backoff_jitter,
            on_transition=self._on_breaker_transition,
        )
        # double-buffer slot for pipeline_commit
        self._in_flight: Optional[_InFlight] = None
        self._cur_span: Optional[Span] = None
        # per-phase seconds, cumulative, with the JAX class's keys: pop,
        # encode, dispatch (the engine launch: on the port it holds the
        # device rounds, one host sync a round), fetch (dispatch ->
        # copy-complete, measured on the fetch worker), host_stall and its
        # alias fetch_block (the residual wait at the fence, a SUBSET of
        # fetch), commit (assume + bind + events + requeues), preempt
        self.phase_seconds: Dict[str, float] = {
            "pop": 0.0, "encode": 0.0, "dispatch": 0.0, "fetch": 0.0,
            "host_stall": 0.0, "fetch_block": 0.0, "commit": 0.0,
            "preempt": 0.0,
        }
        # the state half of "commit" (the batched assume), so a reader can
        # split it from the bind/event tail
        self.commit_state_seconds = 0.0
        self.cycles_total = 0
        self.flight_recorder = (
            flight_recorder if flight_recorder is not None else RECORDER
        )
        self._outcome_totals = {"placed": 0, "unschedulable": 0}
        self.results: List[ScheduleResult] = []
        for ns, q in (self.config.namespace_quotas or {}).items():
            enc.set_namespace_quota(ns, q)
        # cluster + device telemetry: the analytics launch (K5 on the
        # card), memory and kernel-build facts, the launch EWMA, SLO burn
        # alerting; installed as the process default
        self.telemetry = None
        if self.config.telemetry:
            self.telemetry = telemetry_mod.TelemetryHub(
                interval_cycles=self.config.telemetry_interval_cycles,
                objectives=telemetry_mod.build_objectives(
                    self.config.slo_objectives),
                postmortem=self._postmortem,
                device=self.device,
            )
            telemetry_mod.set_default(self.telemetry,
                                      replica=self._replica_id)
        # shed watermark: per-cycle deltas feed the goodput SLO
        self._shed_seen = 0
        # placement-quality observatory: margins and feasible counts off
        # the engines' top-k, the amortized regret counterfactual, drift
        # alerts through the postmortem seam; installed as the process
        # default
        self.quality = None
        if self._quality_k > 0:
            self.quality = quality_mod.QualityObservatory(
                top_k=self._quality_k,
                interval_cycles=self.config.quality_interval_cycles,
                postmortem=self._postmortem,
                drift_threshold=self.config.quality_drift_threshold,
                device=self.device,
            )
            quality_mod.set_default(self.quality, replica=self._replica_id)
        # metrics timeline: every metric family sampled once per
        # timeline_interval_s into a bounded ring, with event annotations
        # and the online anomaly detector; ticked from the commit tail and
        # the idle poll, installed as the process default
        self.timeline = None
        if self.config.timeline:
            self.timeline = timeline_mod.TimelineStore(
                interval_s=self.config.timeline_interval_s,
                retention=self.config.timeline_retention,
                detector=timeline_mod.AnomalyDetector(
                    rules=self.config.timeline_rules,
                    postmortem=self._postmortem,
                ),
            )
            timeline_mod.set_default(self.timeline, replica=self._replica_id)
        # the capacity planner: every capacity_interval_cycles committed
        # cycles the backlog is class-compressed and packed, into the
        # existing headroom first and the overflow over the node-shape
        # catalog (kernels K9 and K8 on the card), as a side launch read
        # back one interval later; placements are identical with it on or
        # off.  Installed as the process default
        self.capacity = None
        if self.config.capacity_planner:
            self.capacity = capacity_mod.CapacityPlanner(
                catalog=self.config.node_shape_catalog,
                interval_cycles=self.config.capacity_interval_cycles,
                device=self.device,
            )
            capacity_mod.set_default(self.capacity, replica=self._replica_id)
        # the replica registry the /debug/replicas roll-up serves
        reconciler_mod.register_scheduler(self)
        m.REPLICAS.set(float(self._replica_of))

    def attach_hub(self, hub) -> None:
        """Late-bind the shared SnapshotHub (the replica set builds it FROM
        replica 0's DeviceSnapshotCache, then attaches it).  Only valid
        before any cycle dispatched."""
        self._hub = hub

    # ------------------------------------------ resident-snapshot seams
    #
    # Every touch of the resident device snapshot goes through these, so
    # replica mode can swap in the SHARED SnapshotHub: a hub launch
    # refreshes to the CURRENT cache truth and runs the engine's enqueue
    # under the hub's lock (the port's resident snapshot is scattered in
    # place).  Single mode keeps this instance's own DeviceSnapshotCache
    # and its dirty-row contract.

    def _device_launch(self, cluster, generation, dirty_rows, fn):
        """Run fn(device cluster) against the resident snapshot.  Returns
        (host cluster, generation, fn's result): in hub mode those the hub
        refreshed to, else the caller's."""
        if self._hub is not None:
            return self._hub.launch(fn)
        dev = self._dev_snapshot.update(cluster, dirty_rows=dirty_rows)
        return cluster, generation, fn(dev)

    def _device_invalidate(self) -> None:
        if self._hub is not None:
            self._hub.invalidate()
        else:
            self._dev_snapshot.invalidate()

    def _device_resident(self, fields):
        if self._hub is not None:
            return self._hub.resident(fields)
        return self._dev_snapshot.resident(fields)

    # ------------------------------------------------------------- one cycle

    def schedule_cycle(self, pods: Sequence[Pod],
                       tier: str = TIER_BULK) -> List[ScheduleResult]:
        """Place a batch of pods against the current cache state; assume+bind
        winners, requeue losers.  Returns per-pod results.  Strictly
        synchronous: any in-flight pipelined batch is drained first."""
        self.flush_pipeline()
        try:
            inf = self._encode_and_dispatch(pods, tier=tier)
        except BaseException:
            # popped pods must never be lost
            self.queue.add_unschedulable_batch(
                list(pods), self.queue.scheduling_cycle
            )
            raise
        if inf is None:
            return []
        return self._commit_tail(self._commit_state_or_requeue(inf))

    def _commit_state_or_requeue(self, inf: _InFlight) -> _Staged:
        """The resilient fence with the batch-loss guard: if the classified
        retry gives up (or the error is unclassified), the batch's popped
        pods are requeued ALL before the error propagates."""
        try:
            return self._commit_state_resilient(inf)
        except BaseException as e:
            self.queue.add_unschedulable_batch(inf.pods, inf.cycle)
            inf.trace.annotate(error=f"{type(e).__name__}: {e}")
            inf.trace.finish()
            self.flight_recorder.record(inf.trace)
            if classify_device_error(e) is None:
                self._postmortem(
                    "unclassified_error", f"{type(e).__name__}: {e}"
                )
            raise

    # -------------------------------------------------- tracing/postmortems

    def _phase(self, name: str, dt: float, tier: str = TIER_BULK) -> None:
        """One accumulation point for per-phase seconds: phase_seconds and
        the /metrics counter family move together; "host_stall" also feeds
        its alias "fetch_block"."""
        self.phase_seconds[name] += dt
        if name == "host_stall":
            self.phase_seconds["fetch_block"] += dt
        m.CYCLE_PHASE_SECONDS.inc(dt, phase=name, tier=tier)

    def _postmortem(self, trigger: str, detail: str = "") -> None:
        """Dump a flight-recorder postmortem for one anomaly trigger
        (throttled per trigger inside the recorder)."""
        snap = self.flight_recorder.postmortem(
            trigger, detail,
            state=self._postmortem_state,
            metrics_text=m.REGISTRY.expose,
            in_flight=[self._cur_span] if self._cur_span is not None else None,
        )
        # a fired postmortem is also a timeline annotation (the detector's
        # own firings already annotate themselves)
        if snap is not None and not trigger.startswith("anomaly_"):
            self._annotate("postmortem", f"{trigger}: {detail}",
                           trigger=trigger)

    def _annotate(self, kind: str, detail: str = "", **fields) -> None:
        """Push one typed event onto the timeline (no-op when it is off).
        Annotation never breaks the loop."""
        tl = getattr(self, "timeline", None)  # None mid-__init__ too
        if tl is None:
            return
        try:
            tl.annotate(kind, detail, **fields)
        except Exception as e:  # pragma: no cover - defensive
            klog.errorf("timeline annotate failed: %s", e)

    def _postmortem_state(self) -> dict:
        q = self.queue
        return {
            "queue_depth": len(q),
            "active_depth": (
                q.active_depth() if hasattr(q, "active_depth") else None
            ),
            "queue_capacity": getattr(q, "capacity", None),
            "shed_total": getattr(q, "shed_total", 0),
            "breaker": self.device_health.state,
            "consecutive_failures": self.device_health.consecutive_failures,
            "fault_counts": dict(self.device_health.fault_counts),
            "invariants": (
                self.invariants.summary()
                if self.invariants is not None else None
            ),
            "pipeline_pending": self.pipeline_pending,
            "scheduling_cycle": self.queue.scheduling_cycle,
        }

    # ----------------------------------------------- device-fault handling

    def _on_breaker_transition(self, frm: str, to: str) -> None:
        """Breaker transitions are operator-visible: one Event each."""
        reason = {
            "open": "BreakerOpen",
            "half_open": "BreakerHalfOpen",
            "closed": "BreakerClosed",
        }[to]
        self.recorder.eventf(
            "Scheduler", "", self.config.scheduler_name,
            EVENT_TYPE_WARNING if to == "open" else EVENT_TYPE_NORMAL,
            reason,
            "device breaker %s -> %s (consecutive failures: %d)",
            frm, to, self.device_health.consecutive_failures,
        )
        if to == "open":
            self._postmortem("breaker_open", f"{frm} -> {to}")
        self._annotate("breaker", f"{frm} -> {to}", to=to)
        m.LADDER_RUNG.set(self._RUNG_GAUGE)

    def _on_invariant_violation(self, rule: str, detail: str) -> None:
        self.recorder.eventf(
            "Scheduler", "", self.config.scheduler_name,
            EVENT_TYPE_WARNING, "InvariantViolation",
            "%s: %s", rule, detail,
        )
        self._postmortem("invariant_violation", f"{rule}: {detail}")

    def _on_shed(self, pod: Pod, reason: str) -> None:
        """Bounded-queue shed audit: one Warning event per dropped pod."""
        if self.invariants is not None:
            self.invariants.note_shed(pod)
        self.recorder.eventf(
            "Pod", pod.namespace, pod.name,
            EVENT_TYPE_WARNING, "SchedulingQueueFull",
            "pod shed from the scheduling queue (%s, capacity %s)",
            reason, self.queue.capacity,
        )
        self._postmortem("shed_burst", reason)

    def _note_device_fault(self, fault_class: str, err: BaseException,
                           phase: str) -> None:
        klog.errorf(
            "device fault (%s) at %s: %s", fault_class, phase, err
        )
        self.recorder.eventf(
            "Scheduler", "", self.config.scheduler_name,
            EVENT_TYPE_WARNING, "DeviceFault",
            "%s device fault at %s: %s", fault_class, phase, err,
        )

    def _fault_retry_allowed(self, fc: str, attempt: int,
                             can_relaunch: bool = True) -> bool:
        """THE retry policy, shared by the dispatch and fence wrappers:
        account the classified failure, and decide whether one more
        same-batch attempt is allowed (sleeping the jittered backoff when
        it is).  On False the device has been given up on FOR THIS BATCH —
        the resident snapshot is invalidated (an upload may have
        half-landed) and the caller raises."""
        tripped = self.device_health.record_failure(fc)
        if (
            not tripped
            and fc != FAULT_PERSISTENT
            and can_relaunch
            and attempt < self.config.device_retry_max
        ):
            m.FAULT_RETRIES.inc(**{"class": fc})
            time.sleep(self.device_health.backoff_s(attempt))
            return True
        self._device_invalidate()
        return False

    def _commit_state_resilient(self, inf: _InFlight) -> _Staged:
        """_commit_state wrapped in the classified retry/backoff/breaker
        policy: transient faults re-dispatch the SAME batch up to
        device_retry_max times with jittered backoff; a persistent fault
        (or a failure streak reaching the breaker threshold) gives up on
        the batch and raises (the caller requeues its pods)."""
        attempt = 0
        relaunch_pending = False
        while True:
            try:
                if relaunch_pending:
                    inf.hosts_dev, inf.fetch = inf.relaunch()
                    inf.quality = None
                    relaunch_pending = False
                staged = self._commit_state(inf)
            except BaseException as e:
                fc = classify_device_error(e)
                if fc is None:
                    raise
                self._note_device_fault(
                    fc, e, "dispatch" if relaunch_pending else "fence"
                )
                inf.trace.annotate(fault_class=fc, fault_attempts=attempt + 1)
                if self._fault_retry_allowed(
                    fc, attempt, can_relaunch=inf.relaunch is not None
                ):
                    attempt += 1
                    relaunch_pending = True
                    continue
                raise
            # an actual device round-trip succeeded: heal the streak (and
            # close the breaker if this was the half-open canary)
            self.device_health.record_success()
            return staged

    def _encode_and_dispatch(self, pods: Sequence[Pod],
                             tier: str = TIER_BULK) -> Optional[_InFlight]:
        """Encode the batch + snapshot under the cache lock and LAUNCH the
        engine.  Returns once the engine was launched; the winners' D2H
        copy is in flight."""
        if not pods:
            return None
        t_cycle0 = time.monotonic()
        xfer0 = transfer_totals()
        enc = self.cache.encoder
        cycle = self.queue.scheduling_cycle
        trace = Span(
            "schedule_cycle", start=t_cycle0, pods=len(pods), cycle=cycle,
            tier=tier,
        )
        self._cur_span = trace
        enc_span = trace.child("encode")
        batch_keys = {(p.namespace, p.name) for p in pods}
        with self.cache._lock, enc.batch_width(None):
            # in-batch affinity state when pods carry ANY pod-affinity terms
            # and can interact (B > 1); built BEFORE encode_pods so novel
            # term topology keys register before any TP-wide tensor is cut
            aff_state = (
                encode_batch_affinity(enc, pods)
                if len(pods) > 1 and batch_has_pod_affinity(pods)
                else None
            )
            batch = enc.encode_pods(pods)
            ports = encode_batch_ports(enc, pods)
            # two-pass evaluation: nominated pods (other than those being
            # scheduled now) are added to their nominated nodes in pass one
            nominated_pairs = [
                (p, n)
                for p, n in self.queue.nominated_pods()
                if (p.namespace, p.name) not in batch_keys
            ]
            nominated = encode_nominated(enc, nominated_pairs)
            cluster, generation = self.cache.snapshot()
            # the rows the incremental snapshot refreshed, taken under the
            # lock so the row set corresponds exactly to THIS snapshot; in
            # hub mode the dirty stream's single consumer is the hub
            dirty_rows = (
                enc.take_dirty_rows() if self._hub is None else None
            )
            # ports + anti-affinity contributions of nominated pods (the
            # non-resource half of podFitsOnNode's pass one) as a host
            # mask folded into extra_mask below
            nom_block = encode_nominated_block(
                enc, nominated_pairs, pods, batch.n_pods, cluster.n_nodes,
            )
            # point-in-time name->row map consistent with THIS snapshot;
            # extender round-trips below run outside the lock, and the live
            # node_rows dict may be mutated (rows recycled/regrown) meanwhile
            node_row_map = dict(enc.node_rows) if self.extenders else None
        enc_span.finish()
        extra_mask = extra_score = None
        ext_failed: Dict[int, str] = {}
        # bind-/preempt-only extenders don't participate in filter/score;
        # skip the fan-out (and keep extra_mask None) when none do
        if any(
            e.config.filter_verb or e.config.prioritize_verb
            for e in self.extenders
        ):
            ext_span = trace.child("extenders", n=len(self.extenders))
            extra_mask, extra_score, ext_failed = self._apply_extenders(
                pods, node_row_map, cluster.n_nodes, n_rows=batch.n_pods,
                trace_ctx=trace.traceparent(),
            )
            ext_span.finish()
            self.extender_seconds += ext_span.duration
        if nom_block is not None:
            # pass-one infeasibility from nominated ports/anti-affinity
            extra_mask = (
                ~nom_block if extra_mask is None else (extra_mask & ~nom_block)
            )
        t_disp = time.monotonic()
        self._phase("encode", t_disp - t_cycle0, tier)
        fn = self._schedule_fn
        if self._speculative_fn is not None:
            fn = self._speculative_fn
        last_index0 = self._last_index
        # hub mode: the launch refreshes to the newest resident state, and
        # the cycle carries the generation and snapshot the engine saw
        launch_box = {"cluster": cluster, "generation": generation}

        def launch():
            """(Re-)dispatch THIS encoded batch.  Captured by
            _InFlight.relaunch so the transient-retry path re-runs the same
            computation with the same rotation base; dirty_rows are
            re-passed safely — fields whose upload already landed
            identity-skip, and after an invalidate() everything re-uploads
            whole.  Hub mode refreshes to the CURRENT cache truth."""
            device_faults.check(device_faults.SITE_DISPATCH)
            c2, g2, out = self._device_launch(
                cluster, generation, dirty_rows,
                lambda dev_cluster: fn(
                    dev_cluster, batch, ports, last_index0, nominated,
                    extra_mask, extra_score, aff_state,
                ))
            launch_box["cluster"], launch_box["generation"] = c2, g2
            hosts = out[0]
            # only the compact winners buffer (i32[B] node rows) crosses
            # back, with the quality top-k's three leaves on the same
            # copy; the copy starts now and lands on the fetch worker
            extras = out[2] if self._quality_k else ()
            return hosts, AsyncFetch(hosts, extras=extras)

        disp_span = trace.child("dispatch")
        hosts_dev, fetch = self._launch_resilient(launch)
        self._last_index += len(pods)
        disp_span.finish()
        trace.annotate(
            batch=len(pods),
            dirty_rows=len(dirty_rows) if dirty_rows is not None else -1,
            breaker=self.device_health.state,
            engine=self._engine_kind,
        )
        t_disp_end = time.monotonic()
        self._phase("dispatch", t_disp_end - t_disp, tier)
        if self._replica_of > 1:
            trace.annotate(replica=self._replica_id)
        used = launch_box["cluster"]
        refs = (used.allocatable, used.requested, used.valid)
        return _InFlight(
            pods=list(pods), hosts_dev=hosts_dev, fetch=fetch,
            generation=launch_box["generation"], cycle=cycle,
            t_cycle0=t_cycle0,
            trace=trace, ext_failed=ext_failed, relaunch=launch,
            last_index0=last_index0,
            tier=tier, width=batch.n_pods, enqueue_s=t_disp_end - t_cycle0,
            xfer0=xfer0,
            quality_reqs=batch.req if self.quality is not None else None,
            quality_snapshot=refs if self.quality is not None else None,
            capacity_snapshot=refs if self.capacity is not None else None,
            reqs=batch.req if self._reconciler is not None else None,
        )

    def _launch_resilient(self, launch):
        """Run a device launch under the classified retry/backoff policy.
        Returns (hosts_dev, fetch); unclassified errors, and classified
        ones once the retries are spent, propagate (the schedule_cycle /
        _run_pipelined guards requeue the batch)."""
        attempt = 0
        while True:
            try:
                return launch()
            except BaseException as e:
                fc = classify_device_error(e)
                if fc is None:
                    raise
                self._note_device_fault(fc, e, "dispatch")
                if self._fault_retry_allowed(fc, attempt):
                    attempt += 1
                    continue
                raise

    def _validate_hosts(self, hosts, n_pods: int) -> np.ndarray:
        """Structural validation of a fetched winners buffer: a corrupted
        D2H transfer surfaces as a CLASSIFIED fault (retried like a
        transient error) instead of a KeyError deep in row_name or a
        silently-wrong placement on a never-allocated row."""
        hosts = np.asarray(hosts)
        enc = self.cache.encoder
        structural = (
            hosts.ndim == 1
            and hosts.shape[0] >= n_pods
            and hosts.dtype.kind in ("i", "u")
        )
        if structural and n_pods:
            head = hosts[:n_pods]
            # winners live in [-1, next_row): -1 = unschedulable
            structural = (
                int(head.max(initial=-1)) < max(enc._next_row, 1)
                and int(head.min(initial=0)) >= -1
            )
        if not structural:
            raise CorruptedFetchError(
                "fetched winners buffer failed validation: shape=%s "
                "dtype=%s row_range=%s live_rows<%d"
                % (
                    hosts.shape, hosts.dtype,
                    (int(hosts[:n_pods].min(initial=0)),
                     int(hosts[:n_pods].max(initial=-1)))
                    if hosts.ndim == 1 and hosts.shape[0] >= n_pods
                    else "?",
                    enc._next_row,
                )
            )
        return hosts

    def _commit_state(self, inf: _InFlight) -> _Staged:
        """Fetch the placements and apply the cache-STATE half of the
        commit.  In batched mode the whole batch of winners is assumed as
        ONE encoder delta under a single lock acquisition; the side-effect
        tail runs in _commit_tail.  In per-pod mode this only fetches."""
        pods = inf.pods
        t_fetch0 = time.monotonic()
        hosts = inf.fetch.result()  # the ready-fence
        hosts = self._validate_hosts(hosts, len(pods))
        if self._quality_k:
            # the top-k rode the winners' copy: landed with them
            inf.quality = TopKQuality(*inf.fetch.extras_result())
        t_state0 = time.monotonic()
        # "fetch" is the async window (dispatch -> copy-complete, measured
        # on the fetch worker); "host_stall" the residual wait here
        self._phase("fetch", inf.fetch.seconds, inf.tier)
        self._phase("host_stall", t_state0 - t_fetch0, inf.tier)
        inf.trace.add_child(
            "fetch", t_state0 - inf.fetch.seconds, t_state0, overlapped=True,
        )
        inf.trace.add_child("fetch_block", t_fetch0, t_state0)
        algo_dt = (time.monotonic() - inf.t_cycle0) / len(pods)
        m.ALGO_LATENCY.observe_n(algo_dt, len(pods))
        batched = self.config.batched_commit
        staged = _Staged(
            inf=inf, hosts=hosts, algo_dt=algo_dt, batched=batched,
            t_state0=t_state0, stall_s=t_state0 - t_fetch0,
        )
        if inf.xfer0 is not None:
            staged.xfer_delta = transfer_delta(inf.xfer0)
        if not batched:
            return staged
        enc = self.cache.encoder
        winners = staged.winners
        for i, pod in enumerate(pods):
            if i in inf.ext_failed:
                continue
            row = int(hosts[i])
            if row < 0:
                staged.fit_idx.append(i)
                continue
            node_name = enc.row_name(row)
            spec = copy.copy(pod.spec)
            spec.node_name = node_name
            assumed = copy.copy(pod)
            assumed.spec = spec
            winners.append((i, pod, assumed, node_name))
        if self._reconciler is not None:
            # the SEQUENCED optimistic-concurrency commit: the admission
            # check and the assume run as ONE critical section under the
            # cache lock, so the headroom the check read is exactly the
            # headroom the delta lands on; race losers readd to their
            # owner shard in the tail, quota losers park unschedulable
            with self.cache._lock:
                kept, staged.race_lost, staged.quota_lost = (
                    self._reconciler.reconcile(self, inf, winners, hosts))
                if kept is not winners:
                    staged.winners = winners = list(kept)
                self._assume_winners(winners, hosts)
                inf.gen_after = enc.generation
            if staged.race_lost or staged.quota_lost:
                self.conflicts_total += len(staged.race_lost)
                self.race_requeued_total += len(staged.race_lost)
                self.quota_vetoed_total += len(staged.quota_lost)
                inf.trace.annotate(conflicts=len(staged.race_lost),
                                   quota_vetoed=len(staged.quota_lost))
        else:
            self._assume_winners(winners, hosts)
        staged.state_seconds = time.monotonic() - t_state0
        self.commit_state_seconds += staged.state_seconds
        inf.trace.add_child(
            "commit", t_state0, time.monotonic(), winners=len(winners),
        )
        return staged

    def _assume_winners(self, winners, hosts) -> None:
        """ONE lock acquisition + one encoder delta for the whole batch,
        then the capacity invariant over exactly the rows it committed to,
        read under the cache lock."""
        enc = self.cache.encoder
        self.cache.assume_pods([a for _, _, a, _ in winners])
        if self.invariants is not None and winners:
            rows = sorted({int(hosts[i]) for i, _, _, _ in winners})
            with self.cache._lock:
                self.invariants.check_capacity(
                    rows, enc.a_requested, enc.a_allocatable,
                    row_name=enc.row_name,
                )

    def _commit_tail(self, staged: _Staged) -> List[ScheduleResult]:
        """Side-effect tail of a cycle: binds, events, metrics, requeues,
        and preemption for the pods that failed to fit.  Under
        pipeline_commit this overlaps the next batch's device
        dispatch (the state half already ran, so the next snapshot is
        exact)."""
        inf = staged.inf
        with use_traceparent(inf.trace):
            tail_span = inf.trace.child("bind-tail")
            if staged.batched:
                results, fit_errors = self._tail_batched(staged)
            else:
                results, fit_errors = self._tail_perpod(staged)
            tail_span.finish()
            if not self.config.disable_preemption:
                t_p = time.monotonic()
                p_span = inf.trace.child("preempt", failed=len(fit_errors))
                for pod in fit_errors:
                    self.preempt(pod)
                p_span.finish()
                self._phase("preempt", time.monotonic() - t_p, inf.tier)
        placed = sum(1 for r in results if r.node is not None)
        inf.trace.annotate(placed=placed, unschedulable=len(results) - placed)
        if staged.xfer_delta:
            top = max(staged.xfer_delta.items(), key=lambda kv: kv[1]["bytes"])
            inf.trace.annotate(
                transfer_bytes=sum(
                    v["bytes"] for v in staged.xfer_delta.values()),
                transfer_top_seam=top[0],
            )
        inf.trace.finish()
        self.flight_recorder.record(inf.trace)
        self._outcome_totals["placed"] += placed
        self._outcome_totals["unschedulable"] += len(results) - placed
        self.cycles_total += 1
        if self.telemetry is not None:
            # SLO events, pressure, the launch EWMA and the amortized
            # analytics launch: never fails a committed cycle, its cost
            # stamped into its own counter
            t_tel = time.perf_counter()
            try:
                self._telemetry_cycle(inf, results, placed)
            except Exception as e:  # noqa: BLE001
                klog.errorf(
                    "telemetry hook failed (cycle %d): %s", inf.cycle, e
                )
            finally:
                m.TELEMETRY_SECONDS.inc(time.perf_counter() - t_tel)
        if self.quality is not None:
            # margins off the top-k, feasible counts, drift detectors (fed
            # the sample telemetry has just materialized) and the amortized
            # regret counterfactual: never fails a committed cycle, its
            # cost stamped into its own counter
            t_q = time.perf_counter()
            try:
                self.quality.on_cycle(
                    cycle=inf.cycle, tier=inf.tier, degraded=False,
                    hosts=staged.hosts, n_pods=len(inf.pods),
                    quality=inf.quality, reqs=inf.quality_reqs,
                    snapshot=inf.quality_snapshot,
                    analytics=(
                        self.telemetry.analytics
                        if self.telemetry is not None else None
                    ),
                )
            except Exception as e:  # noqa: BLE001
                klog.errorf(
                    "quality hook failed (cycle %d): %s", inf.cycle, e
                )
            finally:
                m.QUALITY_SECONDS.inc(time.perf_counter() - t_q)
        if self.capacity is not None:
            # the amortized what-if solve over the backlog and the shape
            # catalog: never fails a committed cycle, its cost stamped into
            # its own counter
            t_cap = time.perf_counter()
            try:
                self._capacity_cycle(inf)
            except Exception as e:  # noqa: BLE001
                klog.errorf(
                    "capacity hook failed (cycle %d): %s", inf.cycle, e
                )
            finally:
                m.CAPACITY_SECONDS.inc(time.perf_counter() - t_cap)
        m.PENDING_PODS.set(float(len(self.queue)))
        # the timeline's cadence-gated sweep, after every gauge above has
        # settled, so the sample reads this cycle's state
        self._timeline_tick("timeline hook failed (cycle %d)" % inf.cycle)
        self.results.extend(results)
        if self.config.trace_threshold_s > 0:
            inf.trace.log_if_long(self.config.trace_threshold_s)
        return results

    def _capacity_cycle(self, inf: _InFlight) -> None:
        """Feed the capacity planner one committed cycle: the cycle's host
        snapshot refs, a lazy backlog reader (invoked only on due
        cycles), the node-name resolver for the drainable report, and the
        encoder's read-only extended-resource column lookup."""
        enc = self.cache.encoder

        def node_names():
            return {row: name for name, row in enc.node_rows.items()}

        self.capacity.on_cycle(
            cycle=inf.cycle,
            backlog=self._capacity_backlog,
            snapshot=inf.capacity_snapshot,
            node_names=node_names,
            res_col=enc.res_col_readonly,
        )

    def _capacity_backlog(self, cap: int):
        """The pending+unschedulable backlog in the planner's pre-grouped
        form (distinct request vectors f32[G, R], counts i[G]; at most
        `cap` pods), encoded read-only: pods group by their containers'
        requests and each distinct content encodes once."""
        enc = self.cache.encoder
        q = self.queue
        pods = q.backlog_pods(cap) if hasattr(q, "backlog_pods") else []
        if not pods:
            return np.zeros((0, enc.dims.R), np.float32)
        groups: Dict[tuple, list] = {}
        for p in pods:
            rk = (
                tuple(
                    tuple(c.requests.items()) for c in p.spec.containers
                ),
                () if not p.spec.init_containers else tuple(
                    tuple(c.requests.items())
                    for c in p.spec.init_containers
                ),
            )
            g = groups.get(rk)
            if g is None:
                groups[rk] = [enc.backlog_req_vector(p), 1]
            else:
                g[1] += 1
        vecs = np.stack([v for v, _ in groups.values()])
        counts = np.asarray([c for _, c in groups.values()], np.int64)
        return vecs, counts

    def _timeline_tick(self, what: str) -> None:
        """One cadence-gated timeline sweep (commit tail and idle poll):
        never fails the loop, its cost stamped into its own counter."""
        if self.timeline is None:
            return
        t_tl = time.perf_counter()
        try:
            self.timeline.maybe_sample()
        except Exception as e:  # noqa: BLE001
            klog.errorf("%s: %s", what, e)
        finally:
            m.TIMELINE_SECONDS.inc(time.perf_counter() - t_tl)

    def _telemetry_cycle(self, inf: _InFlight, results, placed: int) -> None:
        """Feed the telemetry hub one committed cycle: SLO good/bad events
        (deadline overrun, goodput vs shed), per-tier pending pressure, the
        ladder facts (one device: width 0, rung single_chip), the
        per-width launch EWMA, and the amortized analytics launch over the
        RESIDENT snapshot (none, and the sample is counted dropped, when a
        fault has invalidated it)."""
        hub = self.telemetry
        q = self.queue
        shed_total = getattr(q, "shed_total", 0)
        shed_delta = shed_total - self._shed_seen
        self._shed_seen = shed_total
        express = (
            q.express_depth() if hasattr(q, "express_depth") else 0
        )
        active = q.active_depth() if hasattr(q, "active_depth") else len(q)
        hub.record_pressure(
            bulk=max(0, active - express), express=express,
            parked=max(0, len(q) - active),
        )
        m.LADDER_RUNG.set(self._RUNG_GAUGE)
        hub.record_mesh(
            width=0, full_width=0, rung=self._RUNG, shard_states=None,
            invariants=(
                self.invariants.summary()
                if self.invariants is not None else None
            ),
        )
        if inf.fetch is not None:
            hub.note_launch(inf.width or len(inf.pods), inf.fetch.seconds)
        # in hub mode a sibling's refresh scatters into the resident
        # snapshot in place: read it and enqueue the analytics under the
        # hub's lock
        with (self._hub.hold() if self._hub is not None
              else contextlib.nullcontext()):
            hub.on_cycle(
                cycle=inf.cycle,
                tier=inf.tier,
                cycle_s=time.monotonic() - inf.t_cycle0,
                placed=placed,
                unschedulable=len(results) - placed,
                shed=shed_delta,
                degraded=False,
                deadline_s=self.config.cycle_deadline_s,
                resident=self._device_resident(
                    telemetry_mod.ANALYTICS_FIELDS),
                span=inf.trace,
            )

    def _tail_perpod(self, staged: _Staged):
        """The classic per-pod commit loop (batched_commit=False):
        assume/bind one pod at a time, emitting events and metrics inline.
        Returns (results, the pods that failed to fit)."""
        inf = staged.inf
        pods, hosts = inf.pods, staged.hosts
        generation, cycle = inf.generation, inf.cycle
        t_commit0 = time.monotonic()
        enc = self.cache.encoder
        n_nodes = len(enc.node_rows)
        results = []
        fit_errors: List[Pod] = []
        for i, pod in enumerate(pods):
            row = int(hosts[i])
            if i in inf.ext_failed:
                # non-ignorable extender error: plain error requeue, NOT a
                # FitError — no preemption (scheduler.go:463 preempts only
                # on core.FitError; extender errors surface as plain errors)
                self.queue.add_unschedulable(pod, cycle)
                results.append(ScheduleResult(pod, None, generation))
                m.SCHEDULE_ATTEMPTS.inc(result=m.SCHEDULE_ERROR)
                self.recorder.eventf(
                    "Pod", pod.namespace, pod.name,
                    EVENT_TYPE_WARNING, "FailedScheduling",
                    "extender error: %s", inf.ext_failed[i],
                    trace_id=inf.trace.trace_id,
                )
                continue
            if row < 0:
                # FitError path: park in unschedulableQ with backoff
                # (factory.go MakeDefaultErrorFunc), then try preemption
                # (scheduler.go:463-475)
                self.queue.add_unschedulable(pod, cycle)
                results.append(ScheduleResult(pod, None, generation))
                fit_errors.append(pod)
                m.SCHEDULE_ATTEMPTS.inc(result=m.UNSCHEDULABLE)
                self.recorder.eventf(
                    "Pod", pod.namespace, pod.name,
                    EVENT_TYPE_WARNING, "FailedScheduling",
                    "%s", "0/%d nodes are available" % n_nodes,
                    trace_id=inf.trace.trace_id,
                )
                continue
            node_name = enc.row_name(row)
            assumed = dataclasses.replace(
                pod, spec=dataclasses.replace(pod.spec, node_name=node_name)
            )
            t_pod = time.monotonic()
            outcome = self._reserve_and_bind(pod, assumed, node_name, cycle)
            if outcome == "failed":
                results.append(ScheduleResult(pod, None, generation))
                m.SCHEDULE_ATTEMPTS.inc(result=m.SCHEDULE_ERROR)
            else:
                self.queue.delete_nominated_pod_if_exists(pod)
                results.append(ScheduleResult(pod, node_name, generation))
                self._record_scheduled(
                    pod, node_name,
                    staged.algo_dt + (time.monotonic() - t_pod),
                    tier=inf.tier,
                )
        self._phase("commit", time.monotonic() - t_commit0, inf.tier)
        return results, fit_errors

    def _tail_batched(self, staged: _Staged):
        """Batched side-effect tail: per-pod bind callbacks (the only
        irreducibly per-pod step), then ONE batched emission each for
        requeues, metrics and events, in batch-index order so the audit
        trail matches the per-pod loop.  Returns (results, the pods that
        failed to fit)."""
        inf = staged.inf
        pods = inf.pods
        generation, cycle = inf.generation, inf.cycle
        t_tail0 = time.monotonic()
        B = len(pods)
        results: List[Optional[ScheduleResult]] = [None] * B
        events: List[Optional[Tuple]] = [None] * B
        n_nodes = len(self.cache.encoder.node_rows)
        tid = inf.trace.trace_id
        losers: List[Pod] = []
        for i in staged.fit_idx:
            pod = pods[i]
            results[i] = ScheduleResult(pod, None, generation)
            losers.append(pod)
            events[i] = (
                "Pod", pod.namespace, pod.name,
                EVENT_TYPE_WARNING, "FailedScheduling",
                "0/%d nodes are available" % n_nodes, tid,
            )
        for i, msg in inf.ext_failed.items():
            pod = pods[i]
            results[i] = ScheduleResult(pod, None, generation)
            losers.append(pod)
            events[i] = (
                "Pod", pod.namespace, pod.name,
                EVENT_TYPE_WARNING, "FailedScheduling",
                "extender error: %s" % msg, tid,
            )
        # optimistic-concurrency losers: a sequenced-earlier replica commit
        # spent this pod's node headroom — readd it to its OWNER shard
        # (active queue, shed-exempt), not the unschedulable parking lot
        for i, pod in staged.race_lost:
            results[i] = ScheduleResult(pod, None, generation)
            events[i] = (
                "Pod", pod.namespace, pod.name,
                EVENT_TYPE_NORMAL, "PlacementConflict",
                "lost optimistic concurrency race for node headroom; "
                "requeued", tid,
            )
        # namespace-quota vetoes park unschedulable WITH backoff
        for i, pod in staged.quota_lost:
            results[i] = ScheduleResult(pod, None, generation)
            losers.append(pod)
            events[i] = (
                "Pod", pod.namespace, pod.name,
                EVENT_TYPE_WARNING, "QuotaExceeded",
                "namespace %s placement quota exhausted" % pod.namespace,
                tid,
            )
        # enqueue stamps BEFORE the bind fan-out; failed binds restore
        # theirs so a requeued pod keeps its first-enqueue time
        winner_qts = self.queue.take_enqueue_times(
            [pod for _, pod, _, _ in staged.winners]
        )
        bind_dts: List[float] = []
        bound: List[Tuple[int, Pod, str]] = []
        bound_qts: List[Optional[float]] = []
        bound_ts: List[float] = []
        n_bind_failed = 0
        for w, (i, pod, assumed, node_name) in enumerate(staged.winners):
            t0b = time.monotonic()
            ok = self._invoke_binder(pod, assumed, node_name)
            tb = time.monotonic()
            bind_dts.append(tb - t0b)
            if ok:
                bound.append((i, pod, node_name))
                bound_qts.append(winner_qts[w])
                bound_ts.append(tb)
                if self.invariants is not None:
                    self.invariants.note_bound(pod, node_name)
                pod.metadata.annotations.pop(
                    self.UNSCHED_REASON_ANNOTATION, None
                )
                results[i] = ScheduleResult(pod, node_name, generation)
                events[i] = (
                    "Pod", pod.namespace, pod.name,
                    EVENT_TYPE_NORMAL, "Scheduled",
                    "Successfully assigned %s/%s to %s"
                    % (pod.namespace, pod.name, node_name), tid,
                )
            else:
                # optimistic rollback: ForgetPod + requeue
                self.cache.forget_pod(assumed)
                self.queue.restore_enqueue_time(pod, winner_qts[w])
                n_bind_failed += 1
                losers.append(pod)
                results[i] = ScheduleResult(pod, None, generation)
                events[i] = (
                    "Pod", pod.namespace, pod.name,
                    EVENT_TYPE_WARNING, "FailedScheduling",
                    self._BIND_REJECT_MSG
                    % (pod.namespace, pod.name, node_name), tid,
                )
        self.queue.add_unschedulable_batch(losers, cycle)
        for _, pod in staged.race_lost:
            self.queue.readd(pod)
        if staged.quota_lost:
            m.SCHEDULE_ATTEMPTS.inc(
                len(staged.quota_lost), result=m.UNSCHEDULABLE
            )
        if bound and self.queue.has_nominated():
            self.queue.delete_nominated_batch([p for _, p, _ in bound])
        m.BINDING_LATENCY.observe_batch(bind_dts)
        if staged.fit_idx:
            m.SCHEDULE_ATTEMPTS.inc(len(staged.fit_idx), result=m.UNSCHEDULABLE)
        if inf.ext_failed or n_bind_failed:
            m.SCHEDULE_ATTEMPTS.inc(
                len(inf.ext_failed) + n_bind_failed, result=m.SCHEDULE_ERROR
            )
        if bound:
            m.SCHEDULE_ATTEMPTS.inc(len(bound), result=m.SCHEDULED)
            e2es = [
                tb - qt if qt is not None
                else staged.algo_dt + (tb - staged.t_state0)
                for qt, tb in zip(bound_qts, bound_ts)
            ]
            m.E2E_LATENCY.observe_batch(e2es, tier=inf.tier)
            if klog.V(2).enabled:
                for (_, pod, node_name), e2e in zip(bound, e2es):
                    klog.V(2).infof(
                        "scheduled %s/%s to %s (%.1fms e2e)",
                        pod.namespace, pod.name, node_name, e2e * 1000,
                    )
        entries = [e for e in events if e is not None]
        eventf_batch = getattr(self.recorder, "eventf_batch", None)
        if eventf_batch is not None:
            eventf_batch(entries)
        else:  # duck-typed recorder without the batch entry point
            for kind, ns, name, type_, reason, msg, _tid in entries:
                self.recorder.eventf(kind, ns, name, type_, reason, "%s", msg)
        self._phase(
            "commit", staged.state_seconds + time.monotonic() - t_tail0,
            inf.tier,
        )
        return list(results), [pods[i] for i in staged.fit_idx]

    # ------------------------------------------------------------ extenders

    def _apply_extenders(self, pods, rows, n_nodes, n_rows=None,
                         trace_ctx=""):
        """Chain the configured HTTP extenders per pod: each filter
        round-trip intersects the feasibility mask (an extender can only
        veto, never resurrect — generic_scheduler.go:527-554), prioritize
        results add score*weight (:774-804, merged before selectHost).

        `rows` is the snapshot-consistent name->row map captured under the
        cache lock.  The extender chain is sequential per pod (each link
        sees the previous link's narrowed list), but pods fan out across a
        small thread pool — the reference's 16-goroutine analog for the
        network-bound section.  Returns (mask bool[n_rows, n_nodes], score
        f32[n_rows, n_nodes], failed{batch index: message}), host arrays
        at the engine batch width (the pad rows stay all-true / zero and
        pods.valid masks them on the device); a pod whose non-ignorable
        extender errored is fully masked and listed in failed."""
        from concurrent.futures import ThreadPoolExecutor

        from kubernetes_tpu_torch.extender.client import ExtenderError

        B, N = len(pods), n_nodes
        Bp = n_rows if n_rows is not None else B
        mask = np.ones((Bp, N), bool)
        score = np.zeros((Bp, N), np.float32)
        failed: Dict[int, str] = {}
        all_names = [n for n, r in rows.items() if r < N]

        def one_pod(i_pod):
            i, pod = i_pod
            # pool workers re-enter the CYCLE's trace context explicitly
            # (thread-locals don't cross the executor boundary), so every
            # extender round-trip carries the cycle's traceparent header
            with use_traceparent(trace_ctx):
                return _one_pod_traced(i, pod)

        def _one_pod_traced(i, pod):
            names = list(all_names)
            for ext in self.extenders:
                if not ext.is_interested(pod):
                    continue
                try:
                    ok, _failed_nodes = ext.filter(pod, names)
                except ExtenderError as e:
                    if ext.is_ignorable:
                        # skip it, let the rest decide (:534-537)
                        continue
                    failed[i] = str(e)
                    mask[i, :] = False
                    return
                okset = set(ok)
                for n in names:
                    if n not in okset:
                        mask[i, rows[n]] = False
                names = [n for n in names if n in okset]
                if not names:
                    return
            for ext in self.extenders:
                if not ext.is_interested(pod) or not ext.config.prioritize_verb:
                    continue
                try:
                    scores, weight = ext.prioritize(pod, names)
                except ExtenderError:
                    # prioritize errors are ignorable by design (:784-787)
                    continue
                for n, sc in scores.items():
                    r = rows.get(n)
                    if r is not None and r < N:
                        score[i, r] += sc * weight

        if B == 1:
            one_pod((0, pods[0]))
        else:
            with ThreadPoolExecutor(max_workers=16) as pool:
                list(pool.map(one_pod, enumerate(pods)))
        return mask, score, failed

    def _extender_preemption(self, pod, node_name, victims, res):
        """Run ProcessPreemption through every preempt-verb extender that is
        interested; each may narrow the victim set or drop the node entirely
        (return None -> abort, nothing evicted).  Non-preempt-verb extenders
        are skipped, ignorable errors skip just that extender
        (generic_scheduler.go:342-369)."""
        chain = [
            e for e in self.extenders
            if e.supports_preemption and e.is_interested(pod)
        ]
        if not chain:
            return victims
        from kubernetes_tpu_torch.extender.client import ExtenderError

        meta = {
            node_name: {
                "pods": [{"uid": v.metadata.uid or f"{v.namespace}/{v.name}"}
                         for v in victims],
                "numPDBViolations": int(getattr(res, "n_pdb_violations", 0)),
            }
        }
        for ext in chain:
            try:
                meta = ext.process_preemption(pod, meta)
            except ExtenderError:
                if ext.is_ignorable:
                    continue
                return None
            if node_name not in meta:
                return None
        keep = {
            p.get("uid") for p in meta[node_name].get("pods", [])
        }
        return [
            v for v in victims
            if (v.metadata.uid or f"{v.namespace}/{v.name}") in keep
        ]

    # ------------------------------------------------------------ megacycle
    #
    # Chain K pre-encoded windows through the cluster state in one dispatch
    # (models/megacycle.py) and commit the K winner vectors behind the next
    # dispatch.  The gates admit exactly the windows whose cross-window
    # coupling the device carry (resources + lean SelectorSpread counts)
    # reproduces bit for bit; everything else rides single cycles.

    def _megacycle_ready(self) -> bool:
        """Scheduler-level gate: can this control-plane state form a
        megacycle at all?  Attribute reads only, checked once a run_once
        before any extra pop."""
        cfg = self.config
        if self._mega_fn is None or not cfg.batched_commit:
            return False
        if any(
            e.config.filter_verb or e.config.prioritize_verb
            for e in self.extenders
        ):
            return False  # the fan-out is per-single-batch host work
        if self.queue.nominated_pods():
            return False  # two-pass nominated state is host-recomputed
        if self.cache.encoder.term_groups:
            return False  # live affinity terms: commits move topo state
        if cfg.filter_config.service_affinity_labels:
            return False  # CheckServiceAffinity reads existing-pod state
        return True

    def _megacycle_safe(self, pods: Sequence[Pod]) -> bool:
        """Pod-level gate for one window: every pod's only cross-window
        effect must be resources and at most one spread group (the
        encoder's lean shape, whose counts the device carry chains
        exactly).  Mirrors encode_pods' own group-membership rule."""
        spread = self.cache.encoder._spread
        memo: Dict[tuple, int] = {}
        for p in pods:
            if self.POD_GROUP_LABEL in p.labels:
                return False
            a = p.spec.affinity
            if a is not None and (
                a.pod_affinity is not None
                or a.pod_anti_affinity is not None
            ):
                return False
            if p.spec.volumes or p.host_ports():
                return False
            if spread:
                sig = (p.namespace, tuple(sorted(p.labels.items())))
                n = memo.get(sig)
                if n is None:
                    n = sum(
                        1 for ns, sel in spread
                        if ns == p.namespace and sel.matches(p.labels)
                    )
                    memo[sig] = n
                if n > 1:
                    return False
        return True

    def _pop_megacycle_windows(self, first: Sequence[Pod], width: int):
        """Pop up to K - 1 more windows behind the already-popped `first`
        (queue depth permitting, never blocking), keeping only
        megacycle-safe ones; the kept count is floored to a power of two.
        Returns (windows, their scheduling cycles).  Leftover windows (the
        power-of-two remainder, or the first unsafe window) are readded to
        the queue (shed-exempt, like every requeue of a popped pod) and
        pop again on the next iteration."""
        windows: List[List[Pod]] = [list(first)]
        cycles = [self.queue.scheduling_cycle]
        leftovers: List[List[Pod]] = []
        t_pop = time.monotonic()
        # a replica's later windows come from its own shard too
        mega_pop_kw = (
            {"shard": self._replica_id, "of": self._replica_of}
            if self._replica_of > 1 else {}
        )
        while len(windows) < self.config.megacycle_batches:
            w = self.queue.pop_batch(width, 0.0, 0.0, **mega_pop_kw)
            if not w:
                break
            if self.invariants is not None:
                self.invariants.note_popped(w, self.queue.scheduling_cycle)
            if self._megacycle_safe(w):
                windows.append(w)
                cycles.append(self.queue.scheduling_cycle)
            else:
                leftovers.append(w)
                break
        self._phase("pop", time.monotonic() - t_pop)
        k_eff = 1 << (len(windows).bit_length() - 1)  # power-of-two floor
        leftovers = windows[k_eff:] + leftovers
        for w in leftovers:
            for p in w:
                self.queue.readd(p)
        return windows[:k_eff], cycles[:k_eff]

    def _dispatch_megacycle(self, windows: List[List[Pod]],
                            cycles: List[int]) -> _MegaFlight:
        """Encode the K windows against ONE snapshot, stack them, and
        dispatch the megacycle.  Returns with the device computing all K
        windows; the stacked winners' copy is in flight."""
        K = len(windows)
        t_cycle0 = time.monotonic()
        xfer0 = transfer_totals()
        enc = self.cache.encoder
        spans = [
            Span(
                "schedule_cycle", start=t_cycle0, pods=len(w),
                cycle=cycles[k], tier=TIER_BULK, mega=f"{k + 1}/{K}",
            )
            for k, w in enumerate(windows)
        ]
        self._cur_span = spans[0]
        enc_span = spans[0].child("encode", windows=K)
        with self.cache._lock:
            batches = [enc.encode_pods(w) for w in windows]
            shapes = {
                tuple(np.shape(getattr(b, f.name))
                      for f in dataclasses.fields(b))
                for b in batches
            }
            if len(shapes) > 1:
                # a later window grew a sticky pad dim: one more pass
                # encodes every window at the (now stable) max shapes
                batches = [enc.encode_pods(w) for w in windows]
            ports = [encode_batch_ports(enc, w) for w in windows]
            cluster, generation = self.cache.snapshot()
            dirty_rows = (
                enc.take_dirty_rows() if self._hub is None else None
            )
        enc_span.finish()
        # each window's rotation base: the base plus the cumulative RAW pod
        # counts, the values K separate cycles would have seen (int32)
        li0: List[int] = []
        acc = self._last_index
        for w in windows:
            li0.append(wrap_i32(acc))
            acc += len(w)
        self._last_index = acc
        batch_k = stack_windows(batches)
        ports_k = stack_windows(ports)
        t_disp = time.monotonic()
        self._phase("encode", t_disp - t_cycle0)
        mega_fn = self._mega_fn
        launch_box = {"cluster": cluster, "generation": generation}

        def launch():
            """(Re-)dispatch the K encoded windows with the same bases:
            the transient-retry path's relaunch (hub mode refreshes to the
            current cache truth)."""
            device_faults.check(device_faults.SITE_DISPATCH)
            c2, g2, out = self._device_launch(
                cluster, generation, dirty_rows,
                lambda dev_cluster: mega_fn(dev_cluster, batch_k, ports_k,
                                            li0))
            launch_box["cluster"], launch_box["generation"] = c2, g2
            hosts = out[0]
            # the stacked top-k leaves ride the winners' copy
            extras = out[2] if self._quality_k else ()
            return hosts, AsyncFetch(hosts, extras=extras)

        disp_span = spans[0].child("dispatch", windows=K)
        _, fetch = self._launch_resilient(launch)
        disp_span.finish()
        t_disp_end = time.monotonic()
        self._phase("dispatch", t_disp_end - t_disp)
        used = launch_box["cluster"]
        refs = (used.allocatable, used.requested, used.valid)
        infs: List[_InFlight] = []
        for k, w in enumerate(windows):
            spans[k].annotate(
                batch=len(w),
                dirty_rows=(
                    len(dirty_rows) if k == 0 and dirty_rows is not None
                    else -1
                ),
                breaker=self.device_health.state,
                engine=self._engine_kind,
            )
            if self._replica_of > 1:
                spans[k].annotate(replica=self._replica_id)
            infs.append(_InFlight(
                pods=list(w), hosts_dev=None, fetch=None,
                generation=launch_box["generation"], cycle=cycles[k],
                t_cycle0=t_cycle0,
                trace=spans[k], relaunch=None, last_index0=li0[k],
                tier=TIER_BULK, width=batches[k].n_pods,
                enqueue_s=(t_disp_end - t_cycle0) / K,
                xfer0=xfer0 if k == 0 else None,
                quality_reqs=(
                    batches[k].req if self.quality is not None else None
                ),
                # only window 0 placed against exactly this snapshot: the
                # later windows skip the FFD counterfactual and the planner
                quality_snapshot=(
                    refs if self.quality is not None and k == 0 else None
                ),
                capacity_snapshot=(
                    refs if self.capacity is not None and k == 0 else None
                ),
                reqs=(
                    batches[k].req if self._reconciler is not None else None
                ),
                mega=(k, K),
            ))
        self.megacycles_total += 1
        m.MEGACYCLES.inc()
        m.MEGACYCLE_DEPTH.set(float(K))
        return _MegaFlight(windows=infs, fetch=fetch, relaunch=launch)

    def _commit_state_mega(self, mf: _MegaFlight,
                           staged: List[_Staged]) -> List[_Staged]:
        """The megacycle's resilient fence, then the windows' state
        commits in window order.  One retryable unit: a classified fault
        relaunches the WHOLE megacycle (same encoded windows, same bases);
        once the retries are spent the error propagates (the port has no
        CPU degradation engine).

        `staged` is the CALLER's list, appended window by window as each
        state commit lands: if an error escapes mid-loop the caller
        (_commit_state_mega_or_requeue) sees exactly which windows
        committed.  The chained fence: in replica mode window k placed
        against the state window k - 1's commit produced, so it carries the
        generation that commit left (the reconciler stamps it); without a
        reconciler every window keeps the snapshot's generation."""
        K = len(mf.windows)
        attempt = 0
        relaunch_pending = False
        t_fence0 = time.monotonic()
        while True:
            try:
                if relaunch_pending:
                    # a classified fault raised by the re-dispatch itself
                    # feeds the same retry policy
                    _, mf.fetch = mf.relaunch()
                    relaunch_pending = False
                hosts_all = np.asarray(mf.fetch.result())
                for k, inf in enumerate(mf.windows):
                    self._validate_hosts(hosts_all[k], len(inf.pods))
                qual_all = (mf.fetch.extras_result() if self._quality_k
                            else None)
                break
            except BaseException as e:
                fc = classify_device_error(e)
                if fc is None:
                    raise
                self._note_device_fault(
                    fc, e,
                    "megacycle-dispatch" if relaunch_pending
                    else "megacycle-fence",
                )
                mf.windows[0].trace.annotate(
                    fault_class=fc, fault_attempts=attempt + 1
                )
                if self._fault_retry_allowed(
                    fc, attempt, can_relaunch=mf.relaunch is not None
                ):
                    attempt += 1
                    relaunch_pending = True
                    continue
                raise
        stall = time.monotonic() - t_fence0
        self.device_health.record_success()
        self._phase("host_stall", stall)
        f = mf.fetch
        prev_gen = -1
        for k, inf in enumerate(mf.windows):
            if k > 0 and prev_gen >= 0:
                inf.generation = prev_gen
            inf.fetch = _HostResult(
                hosts_all[k],
                extras=(
                    tuple(np.asarray(x)[k] for x in qual_all)
                    if qual_all is not None else ()
                ),
                seconds=f.seconds / K,
                execute_seconds=f.execute_seconds / K,
                materialize_seconds=f.materialize_seconds / K,
            )
            st = self._commit_state(inf)
            prev_gen = inf.gen_after
            if k == 0:
                st.stall_s += stall
            staged.append(st)
        return staged

    def _commit_state_mega_or_requeue(
        self, mf: _MegaFlight
    ) -> List[_Staged]:
        """The megacycle's batch-loss guard: on an error that escaped the
        classified retry, the pods of every window whose state was NOT yet
        committed are requeued, the tails of the committed windows still
        run (their winners sit assumed and must bind), every uncommitted
        window's span is recorded with the error, and the error
        propagates."""
        staged: List[_Staged] = []
        try:
            return self._commit_state_mega(mf, staged)
        except BaseException as e:
            done = {id(st.inf) for st in staged}
            err = f"{type(e).__name__}: {e}"
            for inf in mf.windows:
                if id(inf) not in done:
                    self.queue.add_unschedulable_batch(inf.pods, inf.cycle)
                    inf.trace.annotate(error=err)
                    inf.trace.finish()
                    self.flight_recorder.record(inf.trace)
            if classify_device_error(e) is None:
                self._postmortem("unclassified_error", err)
            for st in staged:
                self._commit_tail(st)
            raise

    def _commit_state_prev(self, prev) -> List[_Staged]:
        """The in-flight slot's state commit: a megacycle yields K staged
        windows, a single cycle one."""
        if isinstance(prev, _MegaFlight):
            return self._commit_state_mega_or_requeue(prev)
        return [self._commit_state_or_requeue(prev)]

    def schedule_megacycle(
        self, windows: List[List[Pod]], cycles: Optional[List[int]] = None,
    ) -> List[ScheduleResult]:
        """Place K windows through one megacycle, synchronously (the
        schedule_cycle counterpart; the pipelined loop uses the in-flight
        slot instead).  The caller guarantees _megacycle_ready() and
        _megacycle_safe() of every window."""
        self.flush_pipeline()
        if cycles is None:
            cycles = [self.queue.scheduling_cycle] * len(windows)
        try:
            mf = self._dispatch_megacycle(windows, cycles)
        except BaseException:
            for w in windows:
                self.queue.add_unschedulable_batch(
                    list(w), self.queue.scheduling_cycle
                )
            raise
        results: List[ScheduleResult] = []
        for st in self._commit_state_mega_or_requeue(mf):
            results.extend(self._commit_tail(st))
        return results

    # ------------------------------------------------------- assume/bind

    def _record_scheduled(self, pod: Pod, node_name: str, e2e: float,
                          tier: str = TIER_BULK) -> None:
        """Scheduled event + counters, once a bind actually succeeded
        (scheduler.go:268 emits after bind, not at assume)."""
        if self.invariants is not None:
            self.invariants.note_bound(pod, node_name)
        qt = self.queue.take_enqueue_time(pod)
        if qt is not None:
            e2e = time.monotonic() - qt
        pod.metadata.annotations.pop(self.UNSCHED_REASON_ANNOTATION, None)
        klog.V(2).infof(
            "scheduled %s/%s to %s (%.1fms e2e)",
            pod.namespace, pod.name, node_name, e2e * 1000,
        )
        m.SCHEDULE_ATTEMPTS.inc(result=m.SCHEDULED)
        m.E2E_LATENCY.observe(e2e, tier=tier)
        self.recorder.eventf(
            "Pod", pod.namespace, pod.name,
            EVENT_TYPE_NORMAL, "Scheduled",
            "Successfully assigned %s/%s to %s",
            pod.namespace, pod.name, node_name,
            trace_id=current_trace_id(),
        )

    def _reserve_and_bind(self, pod: Pod, assumed: Pod, node_name: str,
                          cycle: int) -> str:
        """assume -> bind (scheduleOne, scheduler.go:507-580; the framework's
        Reserve/Permit/Prebind points are a later slice).  Returns "bound"
        or "failed"."""
        self.cache.assume_pod(assumed)
        ok = self._prebind_and_bind(pod, assumed, node_name, cycle)
        return "bound" if ok else "failed"

    def _prebind_and_bind(self, pod, assumed, node_name, cycle) -> bool:
        """The bind call, with ForgetPod + requeue on a rejected bind."""
        t0 = time.monotonic()
        ok = self._invoke_binder(pod, assumed, node_name)
        m.BINDING_LATENCY.observe(time.monotonic() - t0)
        if not ok:
            self._reject_assumed(
                pod, assumed, node_name, cycle,
                self._BIND_REJECT_MSG % (pod.namespace, pod.name, node_name),
            )
        return ok

    def _invoke_binder(self, pod, assumed, node_name) -> bool:
        """The actual bind call: a bind-verb extender binds pods it manages
        in place of the default binder (extender.go:360-387); any exception
        counts as a rejection."""
        binder_ext = next(
            (e for e in self.extenders
             if e.is_binder and e.is_interested(pod)),
            None,
        )
        try:
            if binder_ext is not None:
                binder_ext.bind(
                    pod.namespace, pod.name, pod.metadata.uid, node_name
                )
                return True
            return bool(self.binder(assumed, node_name))
        except Exception:
            return False

    def _reject_assumed(self, pod, assumed, node_name, cycle,
                        message: str = "") -> None:
        """Rollback for a pod rejected after assume (scheduler.go:416-426
        ForgetPod + requeue + FailedScheduling event)."""
        self.cache.forget_pod(assumed)
        self.queue.add_unschedulable(pod, cycle)
        self.recorder.eventf(
            "Pod", pod.namespace, pod.name,
            EVENT_TYPE_WARNING, "FailedScheduling",
            "%s", message or f"rejected after assume on {node_name}",
            trace_id=current_trace_id(),
        )

    # ---------------------------------------------------------- preemption

    def preempt(self, pod: Pod) -> Optional[str]:
        """Try to make room for a pod that failed to fit: candidate nodes
        on the device, a node and a minimal victim set from kernel K2, the
        host verify where the what-if cannot see the failure, then the
        victims deleted and the nominated node recorded so the two-pass
        evaluation protects the claim.  Mirrors Scheduler.preempt
        (scheduler.go:292-342) and genericScheduler.Preempt
        (generic_scheduler.go:310-369).  Returns the nominated node name,
        or None if preemption does not help."""
        if self.config.disable_preemption:
            return None
        m.PREEMPTION_ATTEMPTS.inc()
        t0 = time.monotonic()
        try:
            return self._preempt_inner(pod)
        finally:
            m.PREEMPTION_LATENCY.observe(time.monotonic() - t0)

    def _preempt_inner(self, pod: Pod) -> Optional[str]:
        enc = self.cache.encoder
        ps = self.preempt_seconds
        t = time.monotonic()
        with self.cache._lock:
            if not self._eligible_to_preempt(pod):
                return None
            # the preemptor alone, one row: the JAX class pads it to the
            # sticky batch width (one compiled shape for its jit cache);
            # eager torch needs no such shape, and the row is the same
            with enc.batch_width(1):
                batch = enc.encode_pods([pod])
            cluster, _ = self.cache.snapshot()
            dirty_rows = (
                enc.take_dirty_rows() if self._hub is None else None
            )
        # device work outside the cache lock.  The snapshot is a
        # point-in-time copy; the candidates may be one event stale against
        # the state re-read below, as in the reference (the pick's
        # verify/veto and the next cycle resolve races).  The resident
        # snapshot and the encoder's dirty-row stream are the scheduling
        # cycle's own: preempt runs only on the scheduling thread's commit
        # tail, interleaved with the cycles, never concurrent.
        try:
            dev_batch = _dc_to(batch, PodBatch, self.device, "preempt")
            _, _, cands = self._device_launch(
                cluster, 0, dirty_rows,
                lambda dev_cluster: host_fetch(
                    self._preempt_eval(dev_cluster, dev_batch),
                    tag="preempt")[0].copy())
        except BaseException as e:
            fc = classify_device_error(e)
            if fc is None:
                raise
            # a device fault feeds the breaker like a cycle's, and with no
            # CPU degradation engine in the port it propagates
            self._note_device_fault(fc, e, "preempt")
            self.device_health.record_failure(fc)
            self._device_invalidate()
            raise
        finally:
            t = self._tick_preempt("candidates", t)
        if not cands.any():
            # nodesWherePreemptionMightHelp came back empty: clear any
            # previous nomination (generic_scheduler.go:328-333)
            self._clear_nomination(pod)
            return None
        with self.cache._lock:
            if not self._eligible_to_preempt(pod):
                return None
            arena = enc.pods_snapshot()
            violating = self._pdb_violating_flags(enc, len(arena.node))
            slots = sorted_victim_slots(
                arena.priority, arena.valid, arena.node, pod.spec.priority,
                violating, arena.start,
            )
            ps["arrays"] += time.monotonic() - t
            row, _, victims, res = pick_preemption_node(
                enc, pod, cands, arena, slots, violating,
                self.config.filter_config.max_vols, device=self.device,
                timing=ps,
            )
            t = time.monotonic()
            if row < 0:
                self._clear_nomination(pod)
                return None
            node_name = enc.row_name(row)
        # preempt-verb extenders vet the candidate + victim set
        # (processPreemptionWithExtenders, generic_scheduler.go:342-369);
        # HTTP round-trips happen outside the cache lock
        victims = self._extender_preemption(pod, node_name, victims, res)
        if victims is None:
            self._clear_nomination(pod)
            return None
        for v in victims:
            self.victim_deleter(v)
            if self.invariants is not None:
                # the victim left the cluster: a same-name successor must
                # not read as a double-bind
                self.invariants.note_removed(v)
            self.recorder.eventf(
                "Pod", v.namespace, v.name,
                EVENT_TYPE_NORMAL, "Preempted",
                "by %s/%s on node %s", pod.namespace, pod.name, node_name,
            )
        m.PREEMPTION_VICTIMS.set(float(len(victims)))
        pod.status.nominated_node_name = node_name
        self.queue.update_nominated_pod(pod, node_name)
        self.preemptions.append((
            (pod.namespace, pod.name),
            node_name,
            [(v.namespace, v.name) for v in victims],
        ))
        # victim deletions are cluster events (eventhandlers.go ->
        # MoveAllToActiveQueue); in standalone mode emulate the move so the
        # preemptor retries promptly
        self.queue.move_all_to_active()
        self._tick_preempt("evict", t)
        return node_name

    def _tick_preempt(self, step: str, t0: float) -> float:
        now = time.monotonic()
        self.preempt_seconds[step] += now - t0
        return now

    def _eligible_to_preempt(self, pod: Pod) -> bool:
        """podEligibleToPreemptOthers (generic_scheduler.go:1159-1180): if the
        pod already nominated a node and a lower-priority pod there is still
        terminating, wait instead of preempting more."""
        nom = pod.status.nominated_node_name
        if not nom:
            return True
        enc = self.cache.encoder
        row = enc.node_rows.get(nom, -1)
        if row < 0:
            return True
        for key in enc._row_pods.get(row, ()):
            rec = enc.pods.get(key)
            if (
                rec is not None
                and rec.pod is not None
                and rec.pod.metadata.deletion_timestamp is not None
                and rec.priority < pod.spec.priority
            ):
                return False
        return True

    def _clear_nomination(self, pod: Pod) -> None:
        pod.status.nominated_node_name = ""
        self.queue.delete_nominated_pod_if_exists(pod)

    def _pdb_violating_flags(self, enc, m_cap: int) -> np.ndarray:
        """bool[M]: evicting arena pod m would violate a PodDisruptionBudget
        (filterPodsWithPDBViolation, generic_scheduler.go:990-1035)."""
        flags = np.zeros(m_cap, bool)
        pdbs = [p for p in self.pdb_lister() if p.disruptions_allowed <= 0]
        if not pdbs:
            return flags
        for rec in enc.pods.values():
            if rec.pod is None or rec.node_row < 0:
                continue
            if any(pdb.matches(rec.pod) for pdb in pdbs):
                flags[rec.m] = True
        return flags

    # ----------------------------------------------------------- run loop

    @property
    def pipeline_pending(self) -> bool:
        """True while a dispatched batch awaits its commit tail."""
        return self._in_flight is not None

    def flush_pipeline(self) -> int:
        """Drain the double-buffer slot: fetch + commit any in-flight
        pipelined batch.  Returns the number of pods placed."""
        inf, self._in_flight = self._in_flight, None
        if inf is None:
            return 0
        n = 0
        for st in self._commit_state_prev(inf):
            results = self._commit_tail(st)
            n += sum(1 for r in results if r.node is not None)
        return n

    def _run_pipelined(self, pods: Sequence[Pod],
                       mega: Optional[Tuple[List[List[Pod]], List[int]]]
                       = None) -> int:
        """Double-buffered cycle: apply the in-flight batch's STATE half
        (fetch + batched assume — the part the next snapshot must see),
        dispatch the new batch, then run the previous batch's side-effect
        tail.  With `mega` = (windows, cycles) the new dispatch is a
        megacycle, and the in-flight slot may hold one: all its K state
        commits land before the new dispatch encodes, and all K tails run
        after it."""
        prev, self._in_flight = self._in_flight, None
        n = 0
        staged: List[_Staged] = []
        dispatched = False
        try:
            if prev is not None:
                staged = self._commit_state_prev(prev)
            if mega is not None:
                self._in_flight = self._dispatch_megacycle(*mega)
            else:
                self._in_flight = self._encode_and_dispatch(pods)
            dispatched = True
        finally:
            if not dispatched:
                # batch k+1 was popped but never reached the device:
                # requeue it — popped pods must never be lost
                lost = (
                    [p for w in mega[0] for p in w]
                    if mega is not None else list(pods)
                )
                self.queue.add_unschedulable_batch(
                    lost, self.queue.scheduling_cycle
                )
            # batch k's tail MUST run even if batch k+1's dispatch raises
            for st in staged:
                results = self._commit_tail(st)
                n += sum(1 for r in results if r.node is not None)
        return n

    def run_once(self, timeout: float = 0.1) -> int:
        """Pop one cycle's batch and schedule it; returns the number of
        pods PLACED.  With config.pipeline_commit, batches double-buffer:
        the call dispatches this batch and returns the PREVIOUS batch's
        placements (flush_pipeline drains the last one)."""
        # an idle loop still samples the timeline (cadence-gated, so a
        # loop that just sampled in the commit tail pays one clock read)
        self._timeline_tick("timeline idle tick failed")
        t_pop = time.monotonic()
        # a queue-sharded replica drains only its own stable hash-shard:
        # pops are disjoint across replicas, and every requeue of a popped
        # pod lands back on this shard
        pop_kw = (
            {"shard": self._replica_id, "of": self._replica_of}
            if self._replica_of > 1 else {}
        )
        pods = self.queue.pop_batch(
            self.config.batch_size,
            # with a batch in flight, don't block in the pop
            0.0 if self.pipeline_pending else timeout,
            self.config.batch_window_s,
            **pop_kw,
        )
        if self.invariants is not None:
            self.invariants.note_popped(pods, self.queue.scheduling_cycle)
        self._phase("pop", time.monotonic() - t_pop)
        if not pods:
            # idle poll: drain any in-flight batch so binds/events/requeues
            # don't wait for the next arrival
            return self.flush_pipeline()
        self._in_cycle = True
        try:
            return self._run_popped(pods)
        finally:
            self._in_cycle = False

    @property
    def in_cycle(self) -> bool:
        """True from a non-empty pop until its cycle returns (a replica
        set's drain waits on it)."""
        return self._in_cycle

    def _run_popped(self, pods) -> int:
        """run_once past a non-empty pop."""
        if (
            not self.extenders
            and not self.queue.nominated_pods()
            and any(self.POD_GROUP_LABEL in p.labels for p in pods)
        ):
            # the JAX class schedules these as gangs (all-or-nothing);
            # placing them as plain pods would change the result
            self.queue.add_unschedulable_batch(
                list(pods), self.queue.scheduling_cycle
            )
            raise NotImplementedError(
                "pod-group (gang) pods are not ported yet (ROADMAP A8)")
        # megacycle formation: when the control plane and this window are
        # chain-safe, pop up to K - 1 more windows and dispatch them as one
        # megacycle; an ineligible window rides the single-cycle path,
        # placements identical either way
        windows = None
        if self._megacycle_ready() and self._megacycle_safe(pods):
            windows, win_cycles = self._pop_megacycle_windows(
                pods, self.config.batch_size)
        if windows is not None and len(windows) > 1:
            if self.config.pipeline_commit:
                return self._run_pipelined(pods, mega=(windows, win_cycles))
            return sum(1 for r in self.schedule_megacycle(windows, win_cycles)
                       if r.node is not None)
        if self.config.pipeline_commit and self.config.batched_commit:
            return self._run_pipelined(pods)
        return sum(1 for r in self.schedule_cycle(pods) if r.node is not None)

    def run(self) -> None:
        """wait.Until(scheduleOne) analog (scheduler.go:250-256)."""
        while not self._stop.is_set():
            self.run_once(timeout=0.5)
        self.flush_pipeline()

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
