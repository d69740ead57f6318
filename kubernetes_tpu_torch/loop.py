"""The scheduling loops on the port: the raw loop and the live cycle.

`run_live` is the counterpart of bench.py run_live (bench.py:716-918): the
pods go through the real Scheduler (runtime/scheduler.py): queue ->
pop_batch -> encode under the cache lock -> dirty-row snapshot upload ->
engine -> AsyncFetch -> batched state commit -> bind/event tail.

`run_raw` is the raw loop: encode -> engine -> commit.

`run_preemption` drives the live Scheduler with preemption on: a full
cluster of running pods at two priorities (`preemption_fleet`,
`preemption_running_pods`) and a batch of higher-priority pods that fit
nowhere (`preemptors`, or `affinity_preemptors` with required pod-affinity
terms against the running pods' labels), through FitError -> candidates
(kernel K11's candidates mode) -> kernel K2 -> the host verify -> victims
deleted -> nomination -> the next cycle's placement.

The counterpart of bench.py run()'s timed section (bench.py:256-470) in the
JAX package.  `run_raw` adds `existing` running pods before the clock
starts, then encodes each batch of pending pods, launches the engine on the
device, and commits the winners back into the encoder with `add_pods`, in
run()'s exact order: for the plain and node-affinity workloads batch k+1 is
encoded and launched before batch k is committed (overlap_commit); the pod
(anti-)affinity workloads commit batch k first, because the encoder's pair
tensors must see it.  Batches whose pods carry pod affinity get the
in-batch affinity state.  The tail batch is padded to the batch width with
its padding marked valid=False, and the device cluster state is chained
from batch to batch.

`bench_nodes` and `pending_pod` are the port's copies of bench.py's
`_bench_nodes` fleet (32 CPU, 256Gi, 110 pods per node, 8 zones, tier a/b,
one tainted node in 50) and `_pending_pod` (the plain, node-affinity,
pod-affinity and pod-anti-affinity shapes of scheduler_bench_test.go).

`what_if_workload` is the port's copy of bench.py `_autoscale_workload`
(the BASELINE what-if: a backlog drawn from controller-stamped request
classes over a grid of candidate shapes); `shape_catalog`,
`capacity_requests`, `capacity_pod` and `capacity_running_pods` turn it
into the live capacity cell's shape catalog, pending pods and pre-filled
fleet.  `run_replicas` is the port of
bench.py run_replicas: the replica curve and the tenant storm.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api.factory import make_node, make_pod
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.encoder import SnapshotEncoder
from kubernetes_tpu_torch.models.batched import (
    batch_has_pod_affinity,
    encode_batch_affinity,
    encode_batch_ports,
    make_sequential_scheduler,
)
from kubernetes_tpu_torch.models.speculative import make_speculative_scheduler
from kubernetes_tpu_torch.runtime.quality import DRIFT_SERIES

ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
HOSTNAME_KEY = "kubernetes.io/hostname"
N_DEPLOY = 20
NODE_PODS_CAP = 110
WORKLOADS = ("plain", "node-affinity", "pod-affinity", "pod-anti-affinity")
ENGINES = ("speculative", "sequential")


def bench_nodes(n_nodes: int, pods_per_node: int = NODE_PODS_CAP,
                cpu: str = "32", mem: str = "256Gi",
                make_node=make_node, extended: int = 0) -> List[Node]:
    """The bench fleet: zone i%8, tier b on every third node, a NoSchedule
    taint on one node in 50; `cpu` and `mem` per node, and 8 of each of
    `extended` extended resources (example.com/res-j: with 13 or more the
    encoder's resource axis grows to 32 columns).  make_node: the object
    factory (the JAX package's gives the same nodes to its scheduler)."""
    extra = {f"example.com/res-{j}": "8" for j in range(extended)}
    return [
        make_node(
            f"node-{i}",
            cpu=cpu,
            mem=mem,
            pods=pods_per_node,
            labels={ZONE_KEY: f"zone-{i % 8}", "tier": "a" if i % 3 else "b"},
            taints=[{"key": "dedicated", "value": "x", "effect": "NoSchedule"}]
            if i % 50 == 0
            else [],
            allocatable_extra=extra or None,
        )
        for i in range(n_nodes)
    ]


def pending_pod(i: int, workload: str = "plain") -> Pod:
    """One pending pod of the selected workload shape."""
    d = i % N_DEPLOY
    if workload == "node-affinity":
        # required In-match on a label: only the ~2/3 tier-a nodes match
        return make_pod(
            f"pod-{i}", cpu="100m", mem="256Mi",
            labels={"app": f"dep-{d}"},
            affinity={"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "tier", "operator": "In", "values": ["a"]}
                    ]}]}}},
            owner=("ReplicaSet", f"rs-{d}"),
        )
    if workload == "pod-affinity":
        # BenchmarkSchedulingPodAffinity: zone-level required affinity to
        # the workload's own label (co-locate with mates)
        return make_pod(
            f"pod-{i}", cpu="100m", mem="256Mi",
            labels={"app": f"dep-{d}"},
            affinity={"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": f"dep-{d}"}},
                    "topologyKey": ZONE_KEY,
                }]}},
            owner=("ReplicaSet", f"rs-{d}"),
        )
    if workload == "pod-anti-affinity":
        # BenchmarkSchedulingPodAntiAffinity: hostname-level required
        # anti-affinity (one per node per group)
        return make_pod(
            f"pod-{i}", cpu="100m", mem="256Mi",
            labels={"app": f"dep-{d}"},
            affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": f"dep-{d}"}},
                    "topologyKey": HOSTNAME_KEY,
                }]}},
            owner=("ReplicaSet", f"rs-{d}"),
        )
    if workload != "plain":
        raise ValueError(f"workload {workload!r} not in {WORKLOADS}")
    return make_pod(
        f"pod-{i}",
        cpu="100m",
        mem="256Mi",
        labels={"app": f"dep-{d}"},
        node_selector={"tier": "a"} if d % 4 == 0 else None,
        owner=("ReplicaSet", f"rs-{d}"),
    )


def existing_pod(i: int, nodes: Sequence[Node]) -> Pod:
    """The i-th pod already running before the clock starts (bench.py:
    280-289): one of the 20 deployments, on node i mod len(nodes)."""
    return make_pod(
        f"existing-{i}", cpu="100m", mem="256Mi",
        labels={"app": f"dep-{i % N_DEPLOY}"},
        node_name=nodes[i % len(nodes)].name,
        owner=("ReplicaSet", f"rs-{i % N_DEPLOY}"),
    )


def build_encoder(nodes: Sequence[Node], existing: int = 0) -> SnapshotEncoder:
    """Bulk node ingest plus the 20 spread selectors of the bench, then
    `existing` running pods."""
    enc = SnapshotEncoder()
    enc.add_nodes(nodes)
    for d in range(N_DEPLOY):
        enc.add_spread_selector("default", {"app": f"dep-{d}"})
    for i in range(existing):
        enc.add_pod(existing_pod(i, nodes))
    return enc


def run_raw(nodes: Sequence[Node], pods: Sequence[Pod], batch: int,
            device="cuda", engine: str = "speculative",
            select_impl: str = "kernel", existing: int = 0) -> dict:
    """Schedule `pods` onto `nodes` in batches of `batch`, after
    `existing` running pods (existing_pod) were added outside the clock.

    When any pod carries pod (anti-)affinity, batch k is committed before
    batch k+1 is encoded (bench.py:416 keeps the overlap for the plain and
    node-affinity workloads only, where just spread scores go one batch
    stale), and batches whose pods carry it run with the in-batch affinity
    state, built from the padded pod list before the batch is encoded.

    Returns {"hosts": i32[len(pods)] node row per pod (-1 unschedulable),
    "node_names": row -> node name, "pods_per_s", "seconds", "phases":
    {"encode", "launch", "fetch", "commit"} seconds, "rounds": per batch
    (speculative engine), "redos": batches redone through the sequential
    engine, "scheduled", "unschedulable"}.  "launch" is the host's
    enqueue: a plain batch runs on the card as one CUDA graph with no host
    sync, while an affinity batch's rounds check for active pods on the
    host once a round.  The rounds and redo flags are read after the
    clock stops."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    device = torch.device(device)
    enc = build_encoder(nodes, existing)
    make = (make_speculative_scheduler if engine == "speculative"
            else make_sequential_scheduler)
    fn = make(
        unsched_taint_key=enc.interner.intern("node.kubernetes.io/unschedulable"),
        zone_key_id=enc.getzone_key,
        device=device,
        select_impl=select_impl,
    )
    row_names = {row: name for name, row in enc.node_rows.items()}
    n_pods = len(pods)
    out = np.full(n_pods, -1, np.int32)
    phases = {"encode": 0.0, "launch": 0.0, "fetch": 0.0, "commit": 0.0}
    # the engine's rounds and redo flags, read after the clock stops (on
    # the graph path they stay on the card)
    rounds: list = []
    redo_flags: list = []

    def commit(start, batch_pods, hosts_dev):
        tf = time.monotonic()
        hosts = transfer.host_fetch(hosts_dev)  # waits for the device
        tb = time.monotonic()
        phases["fetch"] += tb - tf
        committed = []
        for j, pod in enumerate(batch_pods):
            r = int(hosts[j])
            out[start + j] = r
            if r < 0:
                continue
            spec = copy.copy(pod.spec)
            spec.node_name = row_names[r]
            c = copy.copy(pod)
            c.spec = spec
            committed.append(c)
        enc.add_pods(committed)
        phases["commit"] += time.monotonic() - tb

    overlap_commit = not batch_has_pod_affinity(pods)
    state = transfer.upload_cluster(enc.snapshot(), device)
    last = 0
    in_flight = None
    t0 = time.monotonic()
    for start in range(0, n_pods, batch):
        n = min(batch, n_pods - start)
        batch_pods = list(pods[start:start + n])
        if n < batch:  # pad the tail batch to the batch width
            batch_pods += [pods[start]] * (batch - n)
        if not overlap_commit and in_flight is not None:
            commit(*in_flight)
            in_flight = None
        t_formed = time.monotonic()
        # before encode_pods: preferred terms register their topology keys
        aff = (encode_batch_affinity(enc, batch_pods)
               if batch_has_pod_affinity(batch_pods) else None)
        pb = enc.encode_pods(batch_pods)
        if n < batch:
            valid = np.array(pb.valid, bool)
            valid[n:] = False
            pb = dataclasses.replace(pb, valid=valid)
        ports = encode_batch_ports(enc, batch_pods)
        phases["encode"] += time.monotonic() - t_formed
        tp = time.monotonic()
        hosts, state = fn(state, pb, ports, last, aff_state=aff)
        phases["launch"] += time.monotonic() - tp
        if engine == "speculative":
            rounds.append(fn.last_rounds)
            redo_flags.append(fn.last_redo)
        last += n
        if in_flight is not None:
            commit(*in_flight)
        in_flight = (start, batch_pods[:n], hosts)
    if in_flight is not None:
        commit(*in_flight)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    scheduled = int((out >= 0).sum())
    return {
        "hosts": out,
        "node_names": row_names,
        "pods_per_s": scheduled / dt if dt > 0 else 0.0,
        "seconds": dt,
        "phases": phases,
        "rounds": [int(r) for r in rounds],
        "redos": sum(int(bool(r)) for r in redo_flags),
        "scheduled": scheduled,
        "unschedulable": n_pods - scheduled,
    }


PREEMPTOR_PRIORITY = 1000


def nominated_preemptors(n_nodes: int, k: int, make_pod=make_pod,
                         node_cpu_milli: int = 32000):
    """[(preemptor pod, nominated node name)] for `k` preemptors waiting for
    their victims' exit: priority 1,000, nominated to bench node 19*j mod
    n_nodes (distinct while k <= n_nodes), each claiming that node's CPU
    less 50m; every fourth carries a required hostname anti-affinity term
    matching one deployment's pending pods.  make_pod: the object factory
    (the JAX package's gives the same pods to its scheduler)."""
    out = []
    for j in range(k):
        affinity = None
        if j % 4 == 0:
            affinity = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {
                        "app": f"dep-{j % N_DEPLOY}"}},
                    "topologyKey": HOSTNAME_KEY,
                }]}}
        pod = make_pod(f"preemptor-{j}", cpu=f"{node_cpu_milli - 50}m",
                       mem="1Gi", priority=PREEMPTOR_PRIORITY,
                       affinity=affinity)
        out.append((pod, f"node-{(19 * j) % n_nodes}"))
    return out


def live_config(batch: int, engine: str = "speculative",
                batched: bool = True, pipeline: bool = True,
                preemption: bool = False, quality_top_k: int = 0,
                quality_interval_cycles: int = 32, telemetry: bool = False,
                telemetry_interval_cycles: int = 1, timeline: bool = False,
                megacycle_batches: int = 1, capacity_planner: bool = False,
                capacity_interval_cycles: int = 256,
                node_shape_catalog=None):
    """bench.py run_live's SchedulerConfig with the port's settings given
    explicitly: preemption off unless asked for, the placement-quality
    observatory at the given top-k width (0: off; the reference's default
    is 3) and interval, telemetry at the given interval and the timeline
    off unless asked for (the reference's defaults: on, interval 1), the
    megacycle depth (1: single cycles, the reference's default), the
    capacity planner off unless asked for (with its interval and shape
    catalog), the CPU degradation engine off."""
    from kubernetes_tpu_torch.runtime.scheduler import SchedulerConfig

    return SchedulerConfig(
        batch_size=batch, batch_window_s=0.0, engine=engine,
        disable_preemption=not preemption, batched_commit=batched,
        pipeline_commit=pipeline, cpu_fallback=False, telemetry=telemetry,
        telemetry_interval_cycles=telemetry_interval_cycles,
        quality_top_k=quality_top_k,
        quality_interval_cycles=quality_interval_cycles, timeline=timeline,
        megacycle_batches=megacycle_batches,
        capacity_planner=capacity_planner,
        capacity_interval_cycles=capacity_interval_cycles,
        node_shape_catalog=node_shape_catalog,
    )


def record_quality(obs) -> dict:
    """Wrap a QualityObservatory's on_cycle (the port's or the JAX
    package's: the same interface) to keep what each committed cycle
    gave it: {"topk": [(top_nodes, top_scores, feasible) of the cycle's
    pods], "regret": [each materialized regret sample]}.  Call
    finish_quality once the scheduler is drained."""
    rec: dict = {"topk": [], "regret": []}
    inner = obs.on_cycle

    def on_cycle(**kw):
        q, n = kw.get("quality"), kw["n_pods"]
        if q is not None:
            rec["topk"].append(tuple(np.array(np.asarray(x)[:n])
                                     for x in q))
        before = obs.regret_samples
        inner(**kw)
        if obs.regret_samples > before:
            rec["regret"].append(dict(obs.regret))

    obs.on_cycle = on_cycle
    return rec


REGRET_KEYS = ("cycle", "actual_nodes", "actual_placed", "ffd_nodes",
               "ffd_placed", "pods")


def quality_arrays(rec) -> dict:
    """The golden file's flat arrays of a record_quality record: the
    top-k leaves of every cycle concatenated, each cycle's pod count, and
    one i32 array a regret sample key."""
    topk = rec["topk"]
    out = dict(
        cycle_pods=np.asarray([len(t[2]) for t in topk], np.int32),
        top_nodes=np.concatenate([t[0] for t in topk]).astype(np.int32),
        top_scores=np.concatenate([t[1] for t in topk]).astype(np.float32),
        feasible=np.concatenate([t[2] for t in topk]).astype(np.int32),
    )
    for k in REGRET_KEYS:
        out["regret_" + k] = np.asarray([r[k] for r in rec["regret"]],
                                        np.int32)
    return out


def finish_quality(obs, rec: dict) -> None:
    """Materialize the regret launch still in flight into `rec`."""
    before = obs.regret_samples
    obs.finalize()
    if obs.regret_samples > before:
        rec["regret"].append(dict(obs.regret))


def record_telemetry(hub, obs=None) -> dict:
    """Wrap a TelemetryHub's on_cycle (the port's or the JAX package's: the
    same interface) to keep every sample it materializes: {"samples":
    [(cycle, source, analytics dict)], "drift": [...]}.  With `obs`, the
    scheduler's QualityObservatory, also wrap its on_cycle to keep its
    drift detectors' state after each cycle: [{series: (fast, slow,
    samples, alerts)}].  Call finish_telemetry once the scheduler is
    drained."""
    rec: dict = {"samples": [], "drift": []}
    inner = hub.on_cycle

    def on_cycle(**kw):
        before = hub.samples_total
        inner(**kw)
        _take_sample(hub, rec, before)

    hub.on_cycle = on_cycle
    if obs is not None:
        q_inner = obs.on_cycle

        def q_on_cycle(**kw):
            q_inner(**kw)
            rec["drift"].append({
                name: (obs.detectors[name].fast, obs.detectors[name].slow,
                       obs.detectors[name].n, obs.detectors[name].alerts)
                for name in DRIFT_SERIES})

        obs.on_cycle = q_on_cycle
    return rec


def _take_sample(hub, rec: dict, before: int) -> None:
    if hub.samples_total > before:
        s = hub._ring[-1]
        rec["samples"].append((s["cycle"], s["source"], s["analytics"]))


def finish_telemetry(hub, rec: dict) -> None:
    """Materialize the analytics launch still in flight into `rec`."""
    before = hub.samples_total
    hub.summary()
    _take_sample(hub, rec, before)


def telemetry_arrays(rec) -> dict:
    """The golden file's flat arrays of a record_telemetry record: each
    sample's cycle, source and analytics fields (stacked), and each
    cycle's drift detector state (NaN before a detector's first sample)."""
    from kubernetes_tpu_torch.ops.analytics import RESOURCE_NAMES, STAT_NAMES

    a = [s[2] for s in rec["samples"]]
    f32, i32 = np.float32, np.int32
    out = dict(
        sample_cycle=np.asarray([s[0] for s in rec["samples"]], i32),
        sample_source=np.asarray([s[1] for s in rec["samples"]], dtype=str),
        utilization=np.asarray(
            [[[d["utilization"][r][st] for st in STAT_NAMES]
              for r in RESOURCE_NAMES] for d in a], f32).reshape(-1, 4, 5),
        largest_free=np.asarray(
            [[d["largest_free"][r] for r in RESOURCE_NAMES] for d in a],
            f32).reshape(-1, 4),
        stranded=np.asarray(
            [[d["stranded"]["cpu"], d["stranded"]["memory"]] for d in a],
            f32).reshape(-1, 2),
        fragmentation=np.asarray([d["fragmentation"] for d in a], f32),
        imbalance=np.asarray([d["imbalance"] for d in a], f32),
        occupancy=np.asarray([d["occupancy"] for d in a], i32).reshape(
            -1, 10),
        sample_nodes=np.asarray([d["nodes"] for d in a], i32),
        pods_running=np.asarray([d["pods_running"] for d in a], f32),
    )
    drift = rec["drift"]
    for k, name in enumerate(("fast", "slow")):
        out["drift_" + name] = np.asarray(
            [[np.nan if c[s][k] is None else c[s][k] for s in DRIFT_SERIES]
             for c in drift], np.float64).reshape(-1, len(DRIFT_SERIES))
    for k, name in ((2, "samples"), (3, "alerts")):
        out["drift_" + name] = np.asarray(
            [[c[s][k] for s in DRIFT_SERIES] for c in drift],
            i32).reshape(-1, len(DRIFT_SERIES))
    return out


def capacity_arrays(samples) -> dict:
    """npz-ready form of a capacity planner's solve samples: each as
    canonical JSON (sorted keys) without its wall-clock "time"."""
    return {"capacity_samples": np.asarray(
        [json.dumps({k: v for k, v in x.items() if k != "time"},
                    sort_keys=True) for x in samples], dtype=str)}


@contextlib.contextmanager
def full_collections():
    """Counts the full (generation-2) collections of Python's cyclic
    collector inside, and their seconds: {"collections", "seconds"}."""
    out = {"collections": 0, "seconds": 0.0}
    start: List[float] = []

    def clock(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                start.append(time.perf_counter())
            elif start:
                out["collections"] += 1
                out["seconds"] += time.perf_counter() - start.pop()

    gc.callbacks.append(clock)
    try:
        yield out
    finally:
        gc.callbacks.remove(clock)


def run_live(nodes: Sequence[Node], n_pods: int, batch: int,
             workload: str = "plain", device="cuda",
             engine: str = "speculative", batched: bool = True,
             pipeline: bool = True, existing: int = 0, nominations=None,
             budget_s: float = 900.0, quality_top_k: int = 0,
             quality_interval_cycles: int = 32, telemetry: bool = False,
             telemetry_interval_cycles: int = 1,
             timeline: bool = False, megacycle_batches: int = 1,
             warmup: Optional[int] = None, sidecar=None,
             capacity_planner: bool = False,
             capacity_interval_cycles: int = 256, node_shape_catalog=None,
             make_pending=None, running: Sequence[Pod] = ()) -> dict:
    """bench.py run_live on the port: `n_pods` pending pods of `workload`
    through the live Scheduler, after a warmup of `warmup` pods (default
    `batch`; pending_pod(n_pods + j)) drained outside the clock.  `existing`
    running pods are added first; `nominations` [(pod, node name)] are
    registered on the queue (queue.update_nominated_pod) after the warmup
    and before the clock: preemptors that wait for their victims and are
    not in the active queue.

    Returns bench.py's keys (pods_per_s, seconds, placed, unschedulable,
    commit_seconds, phases, phase_sum_seconds, overlap_efficiency,
    setup_seconds; unrounded) and: "hosts" i32[n_pods + warmup] bound node
    row per pod index (-1 unbound), "bind_order" i32[] pod indices in
    binder call order (warmup included), "node_names" row -> name,
    "cycles" committed in the timed window, "megacycles" run in it (with
    megacycle_batches > 1), "launches" each kernel's launches in it
    (kernels.LAUNCHES), "commit_state_seconds" and
    "tail_seconds" (the two halves of commit), "scatter_rows" dirty rows
    scattered per update in the timed window, "transfers" the timed
    window's bytes and calls per seam, "snapshot_bytes" one full snapshot
    upload's bytes, "requested" the final requested columns,
    "unschedulable_pods" the names of every unschedulable verdict,
    "gc_full" the full collections of Python's cyclic collector in the
    timed window and their seconds (one full collection runs just before
    it), and "scheduler" the Scheduler.  With quality_top_k > 0 (the
    placement-quality observatory on, every quality_interval_cycles cycles
    a regret sample) also "quality" (the observatory's summary after the
    last regret sample landed), "quality_record" (record_quality's, warmup
    included) and "quality_seconds" (scheduler_quality_seconds_total in
    the timed window).  With telemetry on (a sample every
    telemetry_interval_cycles cycles) also "telemetry" (the hub's summary
    after the last sample landed), "telemetry_record"
    (record_telemetry's, warmup included, with the quality observatory's
    drift state when it is on) and "telemetry_seconds"
    (scheduler_telemetry_seconds_total in the timed window); with the
    timeline on, "timeline" (its summary) and "timeline_seconds"
    (scheduler_timeline_seconds_total in the timed window).

    sidecar: an ExtenderServer (extender_sidecar()) the Scheduler reaches
    through one HTTP extender with filter, prioritize and bind verbs,
    NodeCacheCapable: true, weight 1; the bind verb binds in place of the
    binder, so with pipeline off each batch's binds reach the sidecar's
    mirror before the next batch's fan-out and no reply hangs on thread
    timing.  Then also "extender_seconds" (the Scheduler's fan-out seconds)
    and the sidecar's "filter_seconds" (by part) and "filter_requests",
    all in the timed window.

    capacity_planner: the Scheduler's capacity planner at
    capacity_interval_cycles over node_shape_catalog; then also
    "capacity" (its summary after the last solve landed),
    "capacity_samples" (every solve's sample, oldest first, warmup
    included), "capacity_dispatches" (solves dispatched in the timed
    window) and "capacity_seconds" (scheduler_capacity_seconds_total in
    the timed window).  make_pending: pod i of the cell (default
    pending_pod(i, workload)); running: pods already bound to their
    nodes, added after the `existing` ones."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.utils import metrics as m
    from kubernetes_tpu_torch.codec.transfer import transfer_delta, transfer_totals
    from kubernetes_tpu_torch.runtime.cache import SchedulerCache
    from kubernetes_tpu_torch.runtime.queue import PriorityQueue
    from kubernetes_tpu_torch.runtime.scheduler import Scheduler

    warmup = batch if warmup is None else warmup
    if make_pending is None:
        def make_pending(i):
            return pending_pod(i, workload)
    t_setup = time.monotonic()
    enc = build_encoder(nodes, existing)
    for pod in running:
        enc.add_pod(pod)
    cache = SchedulerCache(enc)
    queue = PriorityQueue()
    hosts = np.full(n_pods + warmup, -1, np.int32)
    order: List[int] = []

    def record(name, node_name):
        i = int(name.rsplit("-", 1)[1])
        hosts[i] = enc.node_rows[node_name]
        order.append(i)

    def binder(pod, node_name):
        record(pod.name, node_name)
        return True

    extenders = []
    if sidecar is not None:
        from kubernetes_tpu_torch.extender.client import (
            ExtenderConfig,
            HTTPExtender,
        )

        host, port = sidecar.address[:2]
        ext = HTTPExtender(ExtenderConfig(
            url_prefix=f"http://{host}:{port}", filter_verb="filter",
            prioritize_verb="prioritize", bind_verb="bind", weight=1,
            node_cache_capable=True, http_timeout=120.0))
        ext_bind = ext.bind

        def bind(namespace, name, uid, node):
            ext_bind(namespace, name, uid, node)
            record(name, node)

        ext.bind = bind
        extenders.append(ext)
    sched = Scheduler(cache=cache, queue=queue, binder=binder,
                      config=live_config(
                          batch, engine, batched, pipeline,
                          quality_top_k=quality_top_k,
                          quality_interval_cycles=quality_interval_cycles,
                          telemetry=telemetry,
                          telemetry_interval_cycles=telemetry_interval_cycles,
                          timeline=timeline,
                          megacycle_batches=megacycle_batches,
                          capacity_planner=capacity_planner,
                          capacity_interval_cycles=capacity_interval_cycles,
                          node_shape_catalog=node_shape_catalog),
                      extenders=extenders, device=device)
    qrec = (record_quality(sched.quality) if sched.quality is not None
            else None)
    trec = (record_telemetry(sched.telemetry, sched.quality)
            if sched.telemetry is not None else None)

    def _drain(budget: float) -> int:
        """run_once until nothing schedulable remains: active/backoff
        work, an in-flight pipelined batch, or the budget.  Pods parked
        unschedulable do not keep the loop alive."""
        placed = 0
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            got = sched.run_once(timeout=0.0)
            placed += got
            if got == 0 and not sched.pipeline_pending:
                if not queue.has_schedulable():
                    break
                time.sleep(0.002)  # backoff expiries: don't hot-spin
        return placed + sched.flush_pipeline()

    for j in range(warmup):
        queue.add(make_pending(n_pods + j))
    _drain(600)
    for pod, node_name in nominations or ():
        queue.update_nominated_pod(pod, node_name)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - t_setup
    for k in sched.phase_seconds:
        sched.phase_seconds[k] = 0.0
    sched.commit_state_seconds = 0.0
    cycles0, mega0 = sched.cycles_total, sched.megacycles_total
    scatter0 = len(sched._dev_snapshot.scatter_rows)
    xfer0 = transfer_totals()
    # pod objects are built outside the clock; the queue adds are inside
    pending = [make_pending(i) for i in range(n_pods)]
    # and so is the cyclic collector's work on everything built before the
    # clock: else whether a full collection falls inside it depends on all
    # the process did before
    gc.collect()
    q_s0 = m.QUALITY_SECONDS.value
    tel_s0, tl_s0 = m.TELEMETRY_SECONDS.value, m.TIMELINE_SECONDS.value
    cap_s0 = m.CAPACITY_SECONDS.value
    cap_d0 = (sched.capacity.dispatches_total
              if sched.capacity is not None else 0)
    launches0 = kernels.settle_launches()
    ext_s0 = sched.extender_seconds
    if sidecar is not None:
        filter0 = dict(sidecar.filter_seconds)
        requests0 = sidecar.filter_requests
    with full_collections() as gc_full:
        t0 = time.monotonic()
        for p in pending:
            queue.add(p)
        t_enqueue = time.monotonic() - t0
        placed = _drain(budget_s)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.monotonic() - t0
    launches = {k: v - launches0[k]
                for k, v in kernels.settle_launches().items()}
    q_s = m.QUALITY_SECONDS.value - q_s0
    tel_s = m.TELEMETRY_SECONDS.value - tel_s0
    tl_s = m.TIMELINE_SECONDS.value - tl_s0
    cap_s = m.CAPACITY_SECONDS.value - cap_s0
    ph = dict(sched.phase_seconds)
    # "fetch" is the async D2H window measured on the fetch worker, so it
    # overlaps the host phases; host_stall and fetch_block (aliases) are a
    # SUBSET of it and are left out of the sum
    phase_sum = (sum(ph.values()) - ph["fetch_block"] - ph["host_stall"]
                 + t_enqueue)
    snap = enc.snapshot()
    extra = {}
    if qrec is not None:
        finish_quality(sched.quality, qrec)
        extra = {"quality": sched.quality.summary(),
                 "quality_record": qrec, "quality_seconds": q_s}
    if trec is not None:
        finish_telemetry(sched.telemetry, trec)
        extra.update(telemetry=sched.telemetry.summary(),
                     telemetry_record=trec, telemetry_seconds=tel_s)
    if sched.timeline is not None:
        extra.update(timeline=sched.timeline.summary(),
                     timeline_seconds=tl_s)
    if sched.capacity is not None:
        cap_d = sched.capacity.dispatches_total - cap_d0
        sched.capacity.finalize()
        extra.update(capacity=sched.capacity.summary(),
                     capacity_samples=sched.capacity.debug_payload()[
                         "samples"],
                     capacity_dispatches=cap_d, capacity_seconds=cap_s)
    if sidecar is not None:
        extra.update(
            extender_seconds=sched.extender_seconds - ext_s0,
            filter_seconds={k: v - filter0[k]
                            for k, v in sidecar.filter_seconds.items()},
            filter_requests=sidecar.filter_requests - requests0)
    return {
        **extra,
        "pods_per_s": placed / dt if dt > 0 else 0.0,
        "seconds": dt,
        "placed": placed,
        "unschedulable": n_pods - placed,
        "batched_commit": batched,
        "pipeline_commit": pipeline,
        "commit_seconds": ph["commit"],
        "phases": {"enqueue": t_enqueue, **ph},
        "phase_sum_seconds": phase_sum,
        "overlap_efficiency": phase_sum / dt if dt > 0 else 0.0,
        "setup_seconds": setup_s,
        "hosts": hosts,
        "bind_order": np.asarray(order, np.int32),
        "node_names": {row: name for name, row in enc.node_rows.items()},
        "cycles": sched.cycles_total - cycles0,
        "megacycles": sched.megacycles_total - mega0,
        "launches": launches,
        "commit_state_seconds": sched.commit_state_seconds,
        "tail_seconds": ph["commit"] - sched.commit_state_seconds,
        "scatter_rows": sched._dev_snapshot.scatter_rows[scatter0:],
        "transfers": transfer_delta(xfer0),
        "snapshot_bytes": sum(
            np.asarray(getattr(snap, f.name)).nbytes
            for f in dataclasses.fields(snap)),
        "requested": np.asarray(snap.requested),
        "unschedulable_pods": sorted(
            r.pod.name for r in sched.results if r.node is None),
        "gc_full": gc_full,
        "scheduler": sched,
    }


def run_megacycle(nodes: Sequence[Node], n_pods: int, batch: int,
                  ks: Sequence[int] = (1, 4), device="cuda",
                  engine: str = "speculative", pipeline: bool = True,
                  budget_s: float = 900.0) -> dict:
    """bench.py run_megacycle on the port: run_live of the plain workload
    once for each megacycle depth K in `ks`, each through a fresh Scheduler
    at the reference's default SchedulerConfig with only cpu_fallback off
    (live_config with telemetry at interval 1, the timeline, quality_top_k=3
    at interval 32; `pipeline` False commits each megacycle before the next
    dispatch).  Each K first drains the same warmup of
    batch * max(2, max(ks)) + batch // 2 pods outside the clock, enough to
    form the deepest megacycle and a trailing single cycle.

    Returns {"curve": [per K: k, pods_per_s, host_s_per_pod, host_seconds,
    seconds, placed, megacycles and kernel launches in the timed window],
    "identical": every K's placements (warmup included) equal the first
    K's, "runs": {K: run_live's result}}.  Host seconds are the scheduling
    thread's phase seconds in the timed window (pop, encode, dispatch,
    host_stall, commit; the port has no perf observatory yet, and its
    dispatch phase holds the speculative engine's rounds, one host sync a
    round).  Unrounded."""
    warm_n = batch * max(2, max(ks)) + max(1, batch // 2)
    curve, runs, placements = [], {}, {}
    for K in ks:
        run = run_live(nodes, n_pods, batch, device=device, engine=engine,
                       pipeline=pipeline, budget_s=budget_s,
                       quality_top_k=3, telemetry=True, timeline=True,
                       megacycle_batches=K, warmup=warm_n)
        ph = run["phases"]
        host_s = sum(ph[k] for k in ("pop", "encode", "dispatch",
                                     "host_stall", "commit"))
        placements[K] = {(r.pod.namespace, r.pod.name): r.node
                         for r in run["scheduler"].results}
        curve.append({
            "k": K, "pods_per_s": run["pods_per_s"],
            "host_s_per_pod": host_s / run["placed"] if run["placed"] else None,
            "host_seconds": host_s, "seconds": run["seconds"],
            "placed": run["placed"], "megacycles": run["megacycles"],
            "launches": run["launches"],
        })
        runs[K] = run
    return {
        "curve": curve,
        "identical": all(placements[K] == placements[ks[0]] for K in ks),
        "runs": runs,
    }


# the preemption cell: scheduler_perf's node template (4 CPU, 32Gi, 110
# pods) on the bench fleet; every node full of running pods, one in
# BATCH_NODE_EVERY holding low-priority batch pods beside production pods
PREEMPT_NODE_CPU, PREEMPT_NODE_MEM = "4", "32Gi"
BATCH_NODE_EVERY = 20
PRODUCTION_PRIORITY, BATCH_PRIORITY, PREEMPTING_PRIORITY = 1000, 0, 500


def preemption_fleet(n_nodes: int, make_node=make_node) -> List[Node]:
    """The bench fleet at scheduler_perf's node size (4 CPU, 32Gi)."""
    return bench_nodes(n_nodes, cpu=PREEMPT_NODE_CPU, mem=PREEMPT_NODE_MEM,
                       make_node=make_node)


def preemption_running_pods(nodes: Sequence[Node], seed: int = 0,
                            make_pod=make_pod,
                            labels: bool = False) -> List[Pod]:
    """The running pods that fill every node to its 4 CPU: 4 production
    pods (priority 1,000, 1 CPU / 1Gi) on each node, except every
    BATCH_NODE_EVERY-th, which holds 2 production pods and 4 batch pods
    (priority 0, 500m / 512Mi) with distinct start times from `seed`.
    labels: the batch pods carry `app: batch` and the production pods on
    the nodes of zones 0-3 `team: east` (what affinity_preemptors' terms
    select); off, the pods carry no label."""
    batch_rows = range(0, len(nodes), BATCH_NODE_EVERY)
    starts = 1.6e9 + np.random.default_rng(seed).permutation(
        4 * len(batch_rows)) * 7.0
    pods: List[Pod] = []
    k = b = 0
    for i, node in enumerate(nodes):
        batch_node = i % BATCH_NODE_EVERY == 0
        east = labels and int(node.labels[ZONE_KEY].rsplit("-", 1)[1]) < 4
        for _ in range(2 if batch_node else 4):
            pod = make_pod(f"prod-{k}", cpu="1", mem="1Gi",
                           priority=PRODUCTION_PRIORITY, node_name=node.name,
                           labels={"team": "east"} if east else None)
            pod.status.start_time = 1.5e9 + k
            pods.append(pod)
            k += 1
        if batch_node:
            for _ in range(4):
                pod = make_pod(f"batch-{b}", cpu="500m", mem="512Mi",
                               priority=BATCH_PRIORITY, node_name=node.name,
                               labels={"app": "batch"} if labels else None)
                pod.status.start_time = float(starts[b])
                pods.append(pod)
                b += 1
    return pods


def preemptors(k: int, make_pod=make_pod) -> List[Pod]:
    """`k` pending pods at priority 500 asking for 1.5 CPU / 1Gi, with no
    toleration: they fit on no full node and preempt batch pods."""
    return [make_pod(f"preemptor-{j}", cpu="1500m", mem="1Gi",
                     priority=PREEMPTING_PRIORITY) for j in range(k)]


# the kinds of affinity_preemptors, each one required pod-affinity term:
# (label selector, topology key, the pod's own labels)
MISSING_TOPOLOGY_KEY = "example.com/no-such-domain"
AFFINITY_PREEMPTOR_KINDS = (
    # a: share a node with a batch pod (the candidates are the batch
    # nodes; the verify must find one left after the eviction)
    ("host", {"app": "batch"}, HOSTNAME_KEY, None),
    # b: share a zone with a team: east pod (zones 0-3)
    ("east", {"team": "east"}, ZONE_KEY, None),
    # c: share a zone with a pod of its own label, which no running pod
    # carries: the first takes the bootstrap rule, the later ones follow
    ("fresh", {"app": "fresh"}, ZONE_KEY, {"app": "fresh"}),
    # d: a self-matching term on a key no node carries: no candidate
    ("nokey", {"app": "nokey"}, MISSING_TOPOLOGY_KEY, {"app": "nokey"}),
)


def affinity_preemptors(per_kind: int, kinds: str = "abcd",
                        make_pod=make_pod) -> List[Pod]:
    """`per_kind` preemptors of each of AFFINITY_PREEMPTOR_KINDS named by
    letter in `kinds`, at preemptors()' request and priority, each with
    one required pod-affinity term, kind by kind in turn (a0, b0, c0, d0,
    a1, ...).  Against preemption_running_pods(labels=True)."""
    table = dict(zip("abcd", AFFINITY_PREEMPTOR_KINDS))
    out = []
    for j in range(per_kind):
        for letter in kinds:
            name, selector, key, own = table[letter]
            out.append(make_pod(
                f"preemptor-{name}-{j}", cpu="1500m", mem="1Gi",
                priority=PREEMPTING_PRIORITY, labels=own,
                affinity={"podAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [{
                        "labelSelector": {"matchLabels": dict(selector)},
                        "topologyKey": key}]}}))
    return out


def run_preemption(nodes: Sequence[Node], running: Sequence[Pod],
                   pending: Sequence[Pod], batch: int, device="cuda",
                   budget_s: float = 900.0) -> dict:
    """The live Scheduler with preemption on (live_config(batch,
    preemption=True)): the `running` pods are added to the cache, the
    `pending` pods enqueued, and the queue drained until nothing
    schedulable remains.

    Returns "preemptions" (the Scheduler's list: (preemptor key, node
    name, victim keys) in order), "bindings" [(pod name, node name)] in
    binder call order, "unschedulable_pods" the names of every
    unschedulable verdict, "requested" the final requested columns,
    "node_names" row -> name, "attempts" preemption attempts, "placed",
    "seconds", "pods_per_s" (pending pods bound a second), "phases" and
    "preempt_seconds" (the Scheduler's), "cycles", "scatter_rows" dirty
    rows scattered per snapshot update, "transfers" bytes and calls per
    seam, "gc_full" as in run_live, and "scheduler"."""
    from kubernetes_tpu_torch.codec.transfer import (
        transfer_delta,
        transfer_totals,
    )
    from kubernetes_tpu_torch.runtime.cache import SchedulerCache
    from kubernetes_tpu_torch.runtime.queue import PriorityQueue
    from kubernetes_tpu_torch.runtime.scheduler import Scheduler
    from kubernetes_tpu_torch.utils import metrics

    enc = build_encoder(nodes)
    enc.add_pods(list(running))
    cache = SchedulerCache(enc)
    queue = PriorityQueue()
    bindings: List[tuple] = []

    def binder(pod, node_name):
        bindings.append((pod.name, node_name))
        return True

    sched = Scheduler(cache=cache, queue=queue, binder=binder,
                      config=live_config(batch, preemption=True),
                      device=device)
    attempts0 = metrics.PREEMPTION_ATTEMPTS.value
    xfer0 = transfer_totals()
    gc.collect()  # as in run_live: the collector's debts before the clock
    with full_collections() as gc_full:
        t0 = time.monotonic()
        for p in pending:
            queue.add(p)
        deadline = t0 + budget_s
        while time.monotonic() < deadline:
            got = sched.run_once(timeout=0.0)
            if got == 0 and not sched.pipeline_pending:
                if not queue.has_schedulable():
                    break
                time.sleep(0.002)  # backoff expiries: don't hot-spin
        sched.flush_pipeline()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.monotonic() - t0
    placed = len(bindings)
    return {
        "preemptions": list(sched.preemptions),
        "bindings": bindings,
        "unschedulable_pods": sorted(
            r.pod.name for r in sched.results if r.node is None),
        "requested": np.asarray(enc.snapshot().requested),
        "node_names": {row: name for name, row in enc.node_rows.items()},
        "attempts": int(metrics.PREEMPTION_ATTEMPTS.value - attempts0),
        "placed": placed,
        "seconds": dt,
        "pods_per_s": placed / dt if dt > 0 else 0.0,
        "phases": dict(sched.phase_seconds),
        "preempt_seconds": dict(sched.preempt_seconds),
        "cycles": sched.cycles_total,
        "scatter_rows": list(sched._dev_snapshot.scatter_rows),
        "transfers": transfer_delta(xfer0),
        "gc_full": gc_full,
        "scheduler": sched,
    }


# ------------------------------------------------------------ the extender seam
#
# drive_extender plays a stock kube-scheduler with NodeCacheCapable: true
# against a sidecar over HTTP (extender/server.py, or the JAX package's, as
# tests/make_torch_golden.py drives it); run_live(sidecar=...) runs the
# live Scheduler with one HTTP extender pointed at extender_sidecar().


def canonical_digest(obj) -> bytes:
    """sha256 of a reply body as canonical JSON (sorted keys, no spaces)."""
    import hashlib
    import json

    return hashlib.sha256(json.dumps(
        obj, sort_keys=True, separators=(",", ":")).encode()).digest()


class _JsonClient:
    """POSTs JSON to one host over one held HTTP connection (reopened when
    the server closes it, as an HTTP/1.0 server does after each reply).
    `held`: whether the last reply left the connection open."""

    def __init__(self, addr, timeout: float):
        import http.client

        self._conn = http.client.HTTPConnection(addr[0], addr[1],
                                                timeout=timeout)
        self.held = False

    def post(self, path: str, obj):
        """(reply body, seconds); a reply status other than 200 raises."""
        import json

        t0 = time.perf_counter()
        self._conn.request("POST", path, body=json.dumps(obj).encode(),
                           headers={"Content-Type": "application/json"})
        resp = self._conn.getresponse()
        data = resp.read()
        self.held = not resp.will_close
        if resp.status != 200:
            raise RuntimeError(
                f"POST {path}: HTTP {resp.status}: {data[:200]!r}")
        return json.loads(data), time.perf_counter() - t0

    def close(self) -> None:
        self._conn.close()


def _post_pipelined(addr, requests, timeout: float) -> None:
    """POST every (path, JSON object) of `requests` over one HTTP/1.1
    connection without waiting for each reply, as a watch relay streams
    its events: a writer thread sends while this thread reads the replies
    in order; a reply status other than 200 raises.  The server must hold
    the connection open (the port's sidecar does; an HTTP/1.0 server
    closes it after one reply)."""
    import json
    import socket
    import threading

    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    head = (b"POST %s HTTP/1.1\r\nHost: " + f"{addr[0]}:{addr[1]}".encode()
            + b"\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n")

    def send() -> None:
        chunk = []
        try:
            for path, obj in requests:
                body = json.dumps(obj).encode()
                chunk.append(head % (path.encode(), len(body)) + body)
                if len(chunk) == 64:
                    sock.sendall(b"".join(chunk))
                    chunk = []
            sock.sendall(b"".join(chunk))
        except OSError:
            pass   # the reader sees the connection end and raises

    writer = threading.Thread(target=send, daemon=True)
    writer.start()
    try:
        with sock.makefile("rb") as f:
            for path, _ in requests:
                status, length = f.readline(), 0
                for line in iter(f.readline, b"\r\n"):
                    if not line:
                        break
                    key, _, value = line.partition(b":")
                    if key.strip().lower() == b"content-length":
                        length = int(value)
                body = f.read(length)
                if status.split(b" ", 2)[1:2] != [b"200"]:
                    raise RuntimeError(
                        f"POST {path}: {status.strip()!r}: {body[:200]!r}")
    finally:
        sock.close()
        writer.join()


def drive_extender(addr, nodes: Sequence[Node], running: Sequence[Pod] = (),
                   pods: Sequence[Pod] = (), preemptors: Sequence[Pod] = (),
                   n_selectors: int = N_DEPLOY,
                   timeout: float = 120.0) -> dict:
    """Drive an extender sidecar at `addr` (host, port) as a stock
    kube-scheduler with NodeCacheCapable: true does.  First the sync:
    every node by /sync/node, the bench's `n_selectors` spread selectors
    by /sync/service, every running pod by /sync/pod.  Then for each of
    `pods` in order: /filter with every node name; unless it leaves no
    node, /prioritize with the filter's nodenames, the highest score taken
    (ties go to the first in filter order) and /bind to it.  Then one
    /preempt for each of `preemptors`, each reply's victims deleted by
    /sync/pod/remove before the next (running pods carry no uid, so a
    victim's uid is its namespace/name).  Objects of either package; they
    go over the wire as api/serialize.py writes them.  When the sidecar
    holds its connection after the first sync reply (HTTP/1.1 keep-alive,
    as the port's does), the rest of the sync is sent without waiting for
    each reply (_post_pipelined), as a watch relay streams its events.

    Returns "digests" {verb: [sha256 of each reply as canonical JSON]},
    "bound" [node name per pod, "" when the filter left none],
    "preempt_replies" [each /preempt reply], "latency" {verb: [seconds of
    each request, client side]} and "sync_seconds"."""
    from kubernetes_tpu_torch.api.serialize import node_to_dict, pod_to_dict

    digests = {v: [] for v in ("filter", "prioritize", "bind", "preempt")}
    latency = {v: [] for v in digests}
    client = _JsonClient(addr, timeout)
    t0 = time.perf_counter()
    sync = [("/sync/node", node_to_dict(node)) for node in nodes]
    sync += [("/sync/service", {"namespace": "default",
                                "selector": {"app": f"dep-{d}"}})
             for d in range(n_selectors)]
    sync += [("/sync/pod", pod_to_dict(pod)) for pod in running]
    if sync:
        client.post(*sync[0])
    if client.held:
        _post_pipelined(addr, sync[1:], timeout)
    else:
        for path, obj in sync[1:]:
            client.post(path, obj)
    sync_s = time.perf_counter() - t0
    names = [n.name for n in nodes]
    bound: List[str] = []

    def verb(name, args):
        reply, dt = client.post("/" + name, args)
        digests[name].append(canonical_digest(reply))
        latency[name].append(dt)
        return reply

    for pod in pods:
        wire = pod_to_dict(pod)
        feasible = verb("filter", {"pod": wire, "nodenames": names})
        ok = feasible["nodenames"]
        if not ok:
            bound.append("")
            continue
        scores = verb("prioritize", {"pod": wire, "nodenames": ok})
        best = scores[0]
        for e in scores[1:]:
            if e["score"] > best["score"]:
                best = e
        verb("bind", {"PodName": pod.name, "PodNamespace": pod.namespace,
                      "PodUID": pod.metadata.uid, "Node": best["host"]})
        bound.append(best["host"])
    replies = []
    for pod in preemptors:
        reply = verb("preempt", {"pod": pod_to_dict(pod)})
        replies.append(reply)
        # the scheduler deletes the victims through the API server, and
        # the watch relays each deletion to the sidecar
        for meta in reply["nodeNameToMetaVictims"].values():
            for victim in meta["pods"]:
                ns, _, name = victim["uid"].partition("/")
                client.post("/sync/pod/remove",
                            {"namespace": ns, "name": name})
    client.close()
    return {"digests": digests, "bound": bound, "preempt_replies": replies,
            "latency": latency, "sync_seconds": sync_s}


@contextlib.contextmanager
def extender_sidecar(nodes: Sequence[Node], existing: int = 0,
                     device="cuda"):
    """An ExtenderServer on `device`, started on a free port of 127.0.0.1,
    its mirror holding `nodes`, the bench's spread selectors and
    `existing` running pods (build_encoder's); stopped on exit.  For
    run_live(sidecar=...)."""
    from kubernetes_tpu_torch.extender.server import ExtenderServer
    from kubernetes_tpu_torch.runtime.cache import SchedulerCache

    server = ExtenderServer(
        cache=SchedulerCache(build_encoder(nodes, existing)), device=device)
    server.start()
    try:
        yield server
    finally:
        server.stop()


# ------------------------------------------- the what-if and capacity cells

WHAT_IF_SEED = 20260804   # bench.py _autoscale_workload's seed
# the live capacity cell: a running pod of this size on every node leaves
# 3.5 CPU free; the pending pods take backlog rows of at most SMALL
# milliCPU (a node holds a dozen), except the last partial batch, whose
# rows ask for more than BIG milliCPU (they fit no node and overflow to the
# shape catalog).  Small pods a dozen to a node keep the speculative
# engine's rounds free of capacity bounces, which would send every batch
# through the sequential redo
CAPACITY_FILL_CPU, CAPACITY_FILL_MEM = "28500m", "64Gi"
CAPACITY_SMALL_MILLI, CAPACITY_BIG_MILLI = 300, 3500


def what_if_workload(pods: int = 50000, classes: int = 256,
                     shapes: int = 10000, seed: int = WHAT_IF_SEED):
    """bench.py _autoscale_workload on the port: a backlog of `pods`
    request vectors drawn from `classes` distinct controller-stamped ones
    (milliCPU 50-4000, memory 64-8192 Mi, one pod slot), and a random cpu x
    memory grid of `shapes` candidate shapes (4-128 cores, 16-512 GiB, 110
    pod slots), R 8, integer units.  Returns (reqs f32[pods, 8], shapes
    f32[shapes, 8]); the defaults are BASELINE's fifth configuration."""
    rng = np.random.default_rng(seed)
    r = 8
    n_classes = max(1, classes)
    base = np.zeros((n_classes, r), np.float32)
    base[:, 0] = rng.integers(50, 4000, n_classes)       # milliCPU
    base[:, 1] = rng.integers(64, 8192, n_classes)       # memory (Mi)
    base[:, 3] = 1.0                                     # one pod slot
    reqs = base[rng.integers(0, n_classes, pods)]
    s = max(1, shapes)
    caps = np.zeros((s, r), np.float32)
    caps[:, 0] = rng.integers(4000, 128001, s)           # 4-128 cores
    caps[:, 1] = rng.integers(16 * 1024, 512 * 1024 + 1, s)  # 16G-512G
    caps[:, 3] = 110.0
    return reqs, caps


def shape_catalog(shapes: np.ndarray) -> List[dict]:
    """The planner's node-shape catalog entries for what_if_workload's
    shapes (milliCPU, MiB, pod slots)."""
    return [{"name": f"shape-{s}", "cpu": f"{int(row[0])}m",
             "memory": f"{int(row[1])}Mi", "pods": float(row[3])}
            for s, row in enumerate(shapes)]


def capacity_requests(reqs: np.ndarray, n_pods: int, warmup: int,
                      batch: int) -> np.ndarray:
    """The live capacity cell's requests, one row a pod index (the warmup's
    after the cell's), drawn in order (cycling) from what_if_workload's
    backlog `reqs`: rows of at most CAPACITY_SMALL_MILLI milliCPU, except
    for the last n_pods % batch pods (a whole batch when that is 0), which
    take rows above CAPACITY_BIG_MILLI.  So only the last batch holds pods
    that fit no node, and every solve before it sees them in the
    backlog."""
    n_big = n_pods % batch or batch
    n_small = n_pods - n_big
    small = np.resize(reqs[reqs[:, 0] <= CAPACITY_SMALL_MILLI],
                      (n_small + warmup, reqs.shape[1]))
    big = np.resize(reqs[reqs[:, 0] > CAPACITY_BIG_MILLI],
                    (n_big, reqs.shape[1]))
    return np.concatenate([small[:n_small], big, small[n_small:]])


def capacity_pod(i: int, reqs: np.ndarray, make_pod=make_pod) -> Pod:
    """Pending pod i of the live capacity cell: row i of `reqs`
    (capacity_requests') as its requests, in the plain workload's
    deployment."""
    d = i % N_DEPLOY
    return make_pod(f"pod-{i}", cpu=f"{int(reqs[i, 0])}m",
                    mem=f"{int(reqs[i, 1])}Mi", labels={"app": f"dep-{d}"},
                    owner=("ReplicaSet", f"rs-{d}"))


def capacity_running_pods(nodes: Sequence[Node],
                          make_pod=make_pod) -> List[Pod]:
    """The live capacity cell's pre-fill: one running pod of
    CAPACITY_FILL_CPU / CAPACITY_FILL_MEM on every node."""
    return [make_pod(f"fill-{k}", cpu=CAPACITY_FILL_CPU,
                     mem=CAPACITY_FILL_MEM, node_name=n.name,
                     labels={"app": "fill"})
            for k, n in enumerate(nodes)]


# ------------------------------------------------------------- replicas


def replica_config(batch: int, engine: str = "speculative",
                   namespace_quotas: Optional[dict] = None):
    """bench.py run_replicas' SchedulerConfig: the reference's defaults
    (telemetry, the timeline, quality top-k 3) with a zero batch window,
    preemption off, batched commit without the pipeline, and the CPU
    degradation engine off."""
    from kubernetes_tpu_torch.runtime.scheduler import SchedulerConfig

    return SchedulerConfig(
        batch_size=batch, batch_window_s=0.0, engine=engine,
        disable_preemption=True, batched_commit=True,
        pipeline_commit=False, cpu_fallback=False,
        namespace_quotas=namespace_quotas)


def _replica_set(nodes, n_replicas, batch, engine, device,
                 namespace_quotas=None, record_scans=False):
    from kubernetes_tpu_torch.runtime.cache import SchedulerCache
    from kubernetes_tpu_torch.runtime.queue import PriorityQueue
    from kubernetes_tpu_torch.runtime.replicas import SchedulerReplicaSet

    rs = SchedulerReplicaSet(
        replicas=n_replicas, cache=SchedulerCache(build_encoder(nodes)),
        queue=PriorityQueue(shards=n_replicas),
        binder=lambda pod, node: True,
        config=replica_config(batch, engine, namespace_quotas),
        device=device)
    if record_scans:
        rs.reconciler.recorded = []
    return rs


def run_replicas(nodes: Sequence[Node], n_pods: int, batch: int,
                 ns: Sequence[int] = (1, 2), device="cuda",
                 engine: str = "speculative", storm_pods: int = 2048,
                 storm_quota: Optional[dict] = None,
                 budget_s: float = 900.0, record_scans: bool = False) -> dict:
    """bench.py run_replicas on the port: the same plain workload drained
    by N queue-sharded replicas (a SchedulerReplicaSet on a fresh encoder
    of `nodes` for every N in `ns`), after a warmup of batch * max(ns)
    pods outside the clock; then the multi-tenant storm at max(ns): one
    flooding tenant ("flood", every other pod, with `storm_quota` as its
    namespace quota when given) against three paced ones, min(n_pods,
    storm_pods) pods offered after the same warmup.

    Returns {"curve": [per N: replicas, pods_per_s, seconds, placed,
    conflicts, requeued, fast_path, scans, kernel_calls, quota_vetoes,
    invariant_violations, drained_clean], "storm": {offered, placed, shed,
    left_in_queue, lost, per_tenant, no_tenant_starved, quota_vetoes,
    scans, kernel_calls, invariant_violations, drained_clean, seconds},
    "scans": [(inputs, admit, quota_ok) of every admission scan, every N
    and the storm] when record_scans, "launches": each kernel's launches
    over the timed windows}.  Unrounded."""
    from kubernetes_tpu_torch import kernels

    curve, scans = [], []
    launches = dict.fromkeys(kernels.LAUNCHES, 0)

    def timed(rs, pods):
        """Warm the set outside the clock, then add `pods` and drain them
        on the clock.  Returns (placed, seconds, the reconciler's stats
        over the clock)."""
        rs.prewarm()
        for j in range(warm_n):
            rs.queue.add(pending_pod(n_pods + j))
        rs.run_until_drained(budget_s=600)
        rs.stop()
        if rs.reconciler.recorded is not None:
            rs.reconciler.recorded.clear()
        for s in rs.schedulers:
            s.results.clear()
        gc.collect()
        l0 = kernels.settle_launches()
        st0 = dict(rs.reconciler.stats())
        t0 = time.monotonic()
        for p in pods:
            rs.queue.add(p)
        placed = rs.run_until_drained(budget_s=budget_s)
        dt = time.monotonic() - t0
        rs.stop()
        for k, v in kernels.settle_launches().items():
            launches[k] += v - l0[k]
        if rs.reconciler.recorded is not None:
            scans.extend(rs.reconciler.recorded)
        st = {k: v - st0[k] for k, v in rs.reconciler.stats().items()}
        return placed, dt, st

    warm_n = batch * max(ns)
    for N in ns:
        rs = _replica_set(nodes, N, batch, engine, device,
                          record_scans=record_scans)
        placed, dt, st = timed(rs, [pending_pod(i) for i in range(n_pods)])
        curve.append({
            "replicas": N, "pods_per_s": placed / dt if dt > 0 else 0.0,
            "seconds": dt, "placed": placed,
            "conflicts": st["conflicts_total"],
            "requeued": st["conflicts_total"] + st["quota_vetoes_total"],
            "fast_path": st["fast_path_total"], "scans": st["scans_total"],
            "kernel_calls": st["kernel_calls"],
            "quota_vetoes": st["quota_vetoes_total"],
            "invariant_violations": rs.invariant_violations_total(),
            "drained_clean": rs.assert_drained(),
        })
        rs.close()
    # the storm: every offered pod must be placed, parked or accounted for
    n_max = max(ns)
    rs = _replica_set(nodes, n_max, batch, engine, device,
                      namespace_quotas=({"flood": storm_quota}
                                        if storm_quota else None),
                      record_scans=record_scans)
    offered = []
    for i in range(min(n_pods, storm_pods)):
        p = pending_pod(i)
        p.metadata.namespace = ("flood" if i % 2 == 0
                                else f"tenant{i % 3}")
        offered.append(p)
    _, dt, st = timed(rs, offered)
    placed_keys, per_tenant = set(), {}
    for s in rs.schedulers:
        for r in s.results:
            if r.node is not None:
                placed_keys.add((r.pod.namespace, r.pod.name))
                per_tenant[r.pod.namespace] = (
                    per_tenant.get(r.pod.namespace, 0) + 1)
    storm_placed = sum(1 for p in offered
                       if (p.namespace, p.name) in placed_keys)
    left, shed = len(rs.queue), rs.queue.shed_total
    tenants = ["flood"] + [f"tenant{t}" for t in range(3)]
    storm = {
        "seconds": dt, "offered": len(offered), "placed": storm_placed,
        "shed": shed, "left_in_queue": left,
        "lost": len(offered) - storm_placed - shed - left,
        "per_tenant": {t: per_tenant.get(t, 0) for t in tenants},
        "no_tenant_starved": all(per_tenant.get(t, 0) > 0 for t in tenants),
        "quota_vetoes": st["quota_vetoes_total"],
        "scans": st["scans_total"], "kernel_calls": st["kernel_calls"],
        "conflicts": st["conflicts_total"],
        "invariant_violations": rs.invariant_violations_total(),
        "drained_clean": rs.assert_drained(),
    }
    rs.close()
    out = {"curve": curve, "storm": storm, "launches": launches}
    if record_scans:
        out["scans"] = scans
    return out
