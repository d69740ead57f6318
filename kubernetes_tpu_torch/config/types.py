"""Component configuration.

Reference: pkg/scheduler/apis/config/types.go KubeSchedulerConfiguration
(:42-108) — the versioned config object every kube-scheduler binary loads,
with AlgorithmSource (provider | policy file/ConfigMap), leader election,
client connection, and the perf knobs.  Mirrored here as a dataclass with a
from_dict loader (JSON; YAML documents parse the same once loaded).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.config.featuregates import FeatureGates
from kubernetes_tpu_torch.config.profile import (
    DEFAULT_PROVIDER,
    SchedulingProfile,
    algorithm_provider,
    profile_from_policy,
)


@dataclass
class LeaderElectionConfig:
    """component-base config.LeaderElectionConfiguration."""

    leader_elect: bool = True
    lease_duration_s: float = 15.0
    renew_deadline_s: float = 10.0
    retry_period_s: float = 2.0
    resource_namespace: str = "kube-system"
    resource_name: str = "kube-scheduler"


@dataclass
class KubeSchedulerConfiguration:
    scheduler_name: str = "default-scheduler"
    algorithm_provider: str = DEFAULT_PROVIDER
    policy: Optional[dict] = None            # legacy Policy JSON (wins if set)
    hard_pod_affinity_symmetric_weight: int = 1
    percentage_of_nodes_to_score: int = 100  # 100 = full scan (the TPU
                                             # default: one launch covers all
                                             # nodes); 0 = the reference's
                                             # adaptive formula; 1-99 fixed %
    bind_timeout_seconds: int = 100          # scheduler.go:48-53
    disable_preemption: bool = False
    leader_election: LeaderElectionConfig = field(default_factory=LeaderElectionConfig)
    healthz_bind_address: str = "0.0.0.0:10251"
    metrics_bind_address: str = "0.0.0.0:10251"
    feature_gates: FeatureGates = field(default_factory=FeatureGates)
    # TPU-specific: batch formation knobs (no reference analog; the reference
    # schedules one pod per cycle)
    batch_size: int = 256
    batch_window_s: float = 0.001
    # "speculative" (hybrid exactness fallback, the default) or
    # "sequential" (always the exact lax.scan)
    engine: str = "speculative"
    # commit-path knobs (runtime/scheduler.py SchedulerConfig): batched =
    # one encoder delta + batched event/metric emission per cycle;
    # pipelined = double-buffer cycles (batch k's bind/event tail overlaps
    # batch k+1's device dispatch)
    batched_commit: bool = True
    pipeline_commit: bool = False
    # device-fault resilience knobs (runtime/scheduler.py SchedulerConfig /
    # runtime/health.py DeviceHealth): classified retry with jittered
    # exponential backoff, circuit breaker, CPU-engine degradation
    device_retry_max: int = 2
    device_backoff_base_s: float = 0.005
    device_backoff_max_s: float = 0.05
    device_backoff_jitter: float = 0.5
    breaker_failure_threshold: int = 3
    breaker_open_s: float = 0.05
    cpu_fallback: bool = True
    # overload protection & backpressure knobs (runtime/queue.py bounded
    # shedding queue + runtime/scheduler.py AIMD adaptive batch sizing)
    queue_capacity: Optional[int] = None
    adaptive_batch: bool = False
    batch_size_min: int = 16
    cycle_deadline_s: float = 0.0
    # tracing (utils/trace.py + runtime/flightrecorder.py): cycles whose
    # root span exceeds this log the full phase breakdown (the utiltrace
    # 100ms convention, now a knob); <=0 disables the slow-cycle log
    # (flight-recorder span capture stays always-on)
    trace_threshold_s: float = 0.1
    # latency tiers (runtime/scheduler.py + runtime/queue.py): a small
    # pre-compiled express lane interleaved with the bulk AIMD lane for
    # annotation-opted-in / high-priority pods
    express_lane: bool = False
    express_batch_size: int = 64
    express_priority_threshold: Optional[int] = None
    # raw-speed knobs: persistent XLA compile cache directory
    # (utils/compilecache.py; None = process default, "off" disables) and
    # startup pre-warming of every AIMD pow2 width + the express width
    compile_cache_dir: Optional[str] = None
    prewarm_widths: bool = False
    # decision ledger + per-plugin attribution (runtime/ledger.py,
    # models/batched.py Attribution): record every cycle's inputs/outcomes
    # for /debug/decisions + bench --replay, and have unschedulable
    # events/annotations name the dominant failing predicate with
    # per-reason node counts
    attribution: bool = False
    decision_ledger: bool = False
    ledger_dir: Optional[str] = None
    ledger_max_cycles: int = 4096
    # cluster + device telemetry (runtime/telemetry.py): device-resident
    # fleet analytics every N cycles, HBM/compile-cache/launch facts,
    # multi-window SLO burn-rate alerting (sloObjectives entries:
    # {name, objective, fastWindowSeconds, slowWindowSeconds,
    # burnThreshold}), and the liveness heartbeat line (0 = off)
    telemetry: bool = True
    telemetry_interval_cycles: int = 1
    slo_objectives: Optional[list] = None
    heartbeat_s: float = 0.0
    # multi-chip sharding (runtime/scheduler.py + parallel/mesh.py): shard
    # the snapshot's node axis across shardDevices chips (pow2; 0 = the
    # single-chip path bit-for-bit); meshShape "OxI" (e.g. "2x4") selects
    # a two-level dcn x ici mesh instead of the 1D node mesh
    shard_devices: int = 0
    mesh_shape: Optional[str] = None
    # elastic degradation ladder (runtime/scheduler.py + runtime/health.py
    # ShardHealth): shard-attributed faults lose ONE device and rebuild
    # the mesh over the widest pow2 of survivors (meshShrinkEnabled)
    # after shardBreakerFailureThreshold consecutive attributed failures
    # (a persistent shard fault loses it immediately); invariantChecks
    # keeps the online conservation checker (runtime/invariants.py) on
    mesh_shrink: bool = True
    shard_breaker_failure_threshold: int = 2
    invariant_checks: bool = True
    # performance observatory (runtime/perfobs.py): directory for the
    # on-demand jax.profiler capture served at GET /debug/profile
    # (None = $KTPU_PROFILE_DIR or /tmp/ktpu_profile); the observatory
    # itself — host/device split, phase x width EWMA, transfer
    # accounting at /debug/perf — is always-on
    profile_dir: Optional[str] = None
    # device-resident megacycle (runtime/scheduler.py +
    # models/megacycle.py): chain up to this many pre-encoded batches
    # through the cluster state in ONE XLA launch, committing the K
    # winner vectors behind the next launch; 1 = single-cycle dispatch
    # bit-for-bit.  Only chain-safe batches ride a megacycle (no
    # pod-affinity/ports/volumes/gangs/nominated pods; lean spread)
    megacycle_batches: int = 1
    # placement-quality observatory (runtime/quality.py): in-launch
    # winner-pinned top-k width (qualityTopK; 0 disables the seam —
    # placements bit-identical either way), the amortized FFD-regret
    # sampling cadence (qualityIntervalCycles), and the dual-window
    # packing-drift step threshold (qualityDriftThreshold)
    quality_top_k: int = 3
    quality_interval_cycles: int = 32
    quality_drift_threshold: float = 0.25
    # device-resident capacity planner (runtime/capacity.py): every
    # capacityIntervalCycles the pending+unschedulable backlog is
    # class-compressed and what-if binpacked — existing headroom first,
    # the overflow over the nodeShapeCatalog ([{name, cpu, memory,
    # ephemeral-storage?, pods?, ...}]; null = the built-in default) —
    # as an amortized side-launch, emitting a scale-up/scale-down
    # recommendation at /debug/capacity + scheduler_capacity_* metrics
    capacity_planner: bool = False
    capacity_interval_cycles: int = 256
    node_shape_catalog: Optional[list] = None
    # guarded autoscaler actuation (runtime/autoscaler.py): a control
    # loop that ENACTS the capacity plan against the live store —
    # scale-up registers nodes from the winning catalog shape (paced,
    # batch-capped), scale-down cordons + drains through the PDB path
    # and deletes.  Dual-threshold hysteresis + a cooldown window bound
    # direction flapping; stuck drains and mid-batch registration
    # failures roll back; every actuation is recorded to a JSONL ledger
    # replayable offline (bench.py --replay).  Implies capacityPlanner.
    autoscaler: bool = False
    autoscaler_interval_s: float = 1.0
    autoscaler_dry_run: bool = False
    autoscaler_cooldown_s: float = 30.0
    autoscaler_max_nodes_per_round: int = 4
    autoscaler_drain_deadline_s: float = 30.0
    autoscaler_min_nodes: int = 1
    autoscaler_max_nodes: int = 256
    autoscaler_ledger_path: Optional[str] = None
    # metrics timeline store (runtime/timeline.py): every registered
    # metric family sampled once per timelineIntervalSeconds into a
    # bounded ring (counters as deltas, gauges as values, histograms as
    # p50/p99), interleaved with typed event annotations from the
    # breaker/shard/mesh/AIMD/shed/autoscaler/chaos seams and run
    # through the online anomaly detector (timelineRules: [{rule:
    # threshold|zscore|slope, series, ...}]; null = the conservative
    # defaults).  Served at /debug/timeline; exported by bench
    # --timeline-out and the scenario engine.
    timeline: bool = True
    timeline_interval_s: float = 1.0
    timeline_retention: int = 512
    timeline_rules: Optional[list] = None
    # queue-sharded scheduler replicas (runtime/replicas.py +
    # runtime/reconciler.py): run this many scheduler loops (threads)
    # over one queue/cache, each draining a stable hash-shard and
    # committing through the sequenced optimistic conflict reconciler;
    # 1 = the classic single loop bit-for-bit.  namespaceQuotas
    # ({namespace: {resource: quantity}}) are enforced at commit by the
    # same reconciler (placement-fairness quota; DRF tiebreak rides the
    # encoder's per-namespace usage columns).
    replicas: int = 1
    namespace_quotas: Optional[dict] = None

    def build_profile(self, interner=None) -> SchedulingProfile:
        """CreateFromConfig / CreateFromProvider (scheduler.go:162-192)."""
        if self.policy is not None:
            return profile_from_policy(
                self.policy, interner=interner, gates=self.feature_gates
            )
        return algorithm_provider(
            self.algorithm_provider,
            gates=self.feature_gates,
            hard_pod_affinity_weight=float(self.hard_pod_affinity_symmetric_weight),
        )

    @staticmethod
    def from_dict(d: dict) -> "KubeSchedulerConfiguration":
        le = d.get("leaderElection") or {}
        return KubeSchedulerConfiguration(
            scheduler_name=d.get("schedulerName", "default-scheduler"),
            algorithm_provider=(d.get("algorithmSource") or {}).get(
                "provider", DEFAULT_PROVIDER
            )
            or DEFAULT_PROVIDER,
            policy=(d.get("algorithmSource") or {}).get("policy"),
            hard_pod_affinity_symmetric_weight=int(
                d.get("hardPodAffinitySymmetricWeight", 1)
            ),
            percentage_of_nodes_to_score=int(d.get("percentageOfNodesToScore", 0)),
            bind_timeout_seconds=int(d.get("bindTimeoutSeconds", 100)),
            disable_preemption=bool(d.get("disablePreemption", False)),
            leader_election=LeaderElectionConfig(
                leader_elect=bool(le.get("leaderElect", True)),
                lease_duration_s=float(le.get("leaseDuration", 15.0)),
                renew_deadline_s=float(le.get("renewDeadline", 10.0)),
                retry_period_s=float(le.get("retryPeriod", 2.0)),
            ),
            healthz_bind_address=d.get("healthzBindAddress", "0.0.0.0:10251"),
            metrics_bind_address=d.get("metricsBindAddress", "0.0.0.0:10251"),
            feature_gates=FeatureGates(d.get("featureGates")),
            batch_size=int(d.get("batchSize", 256)),
            batch_window_s=float(d.get("batchWindowSeconds", 0.001)),
            engine=d.get("engine", "speculative"),
            batched_commit=bool(d.get("batchedCommit", True)),
            pipeline_commit=bool(d.get("pipelineCommit", False)),
            device_retry_max=int(d.get("deviceRetryMax", 2)),
            device_backoff_base_s=float(d.get("deviceBackoffBaseSeconds", 0.005)),
            device_backoff_max_s=float(d.get("deviceBackoffMaxSeconds", 0.05)),
            device_backoff_jitter=float(d.get("deviceBackoffJitter", 0.5)),
            breaker_failure_threshold=int(d.get("breakerFailureThreshold", 3)),
            breaker_open_s=float(d.get("breakerOpenSeconds", 0.05)),
            cpu_fallback=bool(d.get("cpuFallback", True)),
            queue_capacity=(
                int(d["queueCapacity"])
                if d.get("queueCapacity") is not None else None
            ),
            adaptive_batch=bool(d.get("adaptiveBatch", False)),
            batch_size_min=int(d.get("batchSizeMin", 16)),
            cycle_deadline_s=float(d.get("cycleDeadlineSeconds", 0.0)),
            trace_threshold_s=float(d.get("traceThresholdSeconds", 0.1)),
            express_lane=bool(d.get("expressLane", False)),
            express_batch_size=int(d.get("expressBatchSize", 64)),
            express_priority_threshold=(
                int(d["expressPriorityThreshold"])
                if d.get("expressPriorityThreshold") is not None else None
            ),
            compile_cache_dir=d.get("compileCacheDir"),
            prewarm_widths=bool(d.get("prewarmWidths", False)),
            attribution=bool(d.get("attribution", False)),
            decision_ledger=bool(d.get("decisionLedger", False)),
            ledger_dir=d.get("ledgerDir"),
            ledger_max_cycles=int(d.get("ledgerMaxCycles", 4096)),
            telemetry=bool(d.get("telemetry", True)),
            telemetry_interval_cycles=int(
                d.get("telemetryIntervalCycles", 1)
            ),
            slo_objectives=d.get("sloObjectives"),
            heartbeat_s=float(d.get("heartbeatSeconds", 0.0)),
            shard_devices=int(d.get("shardDevices", 0)),
            mesh_shape=d.get("meshShape"),
            mesh_shrink=bool(d.get("meshShrinkEnabled", True)),
            shard_breaker_failure_threshold=int(
                d.get("shardBreakerFailureThreshold", 2)
            ),
            invariant_checks=bool(d.get("invariantChecks", True)),
            profile_dir=d.get("profileDir"),
            megacycle_batches=int(d.get("megacycleBatches", 1)),
            quality_top_k=int(d.get("qualityTopK", 3)),
            quality_interval_cycles=int(d.get("qualityIntervalCycles", 32)),
            quality_drift_threshold=float(
                d.get("qualityDriftThreshold", 0.25)
            ),
            capacity_planner=bool(d.get("capacityPlanner", False)),
            capacity_interval_cycles=int(
                d.get("capacityIntervalCycles", 256)
            ),
            node_shape_catalog=d.get("nodeShapeCatalog"),
            autoscaler=bool(d.get("autoscaler", False)),
            autoscaler_interval_s=float(d.get("autoscalerIntervalSeconds", 1.0)),
            autoscaler_dry_run=bool(d.get("autoscalerDryRun", False)),
            autoscaler_cooldown_s=float(d.get("autoscalerCooldownSeconds", 30.0)),
            autoscaler_max_nodes_per_round=int(
                d.get("autoscalerMaxNodesPerRound", 4)
            ),
            autoscaler_drain_deadline_s=float(
                d.get("autoscalerDrainDeadlineSeconds", 30.0)
            ),
            autoscaler_min_nodes=int(d.get("autoscalerMinNodes", 1)),
            autoscaler_max_nodes=int(d.get("autoscalerMaxNodes", 256)),
            autoscaler_ledger_path=d.get("autoscalerLedgerPath"),
            timeline=bool(d.get("timeline", True)),
            timeline_interval_s=float(
                d.get("timelineIntervalSeconds", 1.0)
            ),
            timeline_retention=int(d.get("timelineRetention", 512)),
            timeline_rules=d.get("timelineRules"),
            replicas=int(d.get("replicas", 1)),
            namespace_quotas=d.get("namespaceQuotas"),
        )

    @staticmethod
    def from_file(path: str) -> "KubeSchedulerConfiguration":
        with open(path) as f:
            return KubeSchedulerConfiguration.from_dict(json.load(f))
