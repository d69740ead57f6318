"""The scheduling loops on the port: the raw loop and the live cycle.

`run_live` is the counterpart of bench.py run_live (bench.py:716-918): the
pods go through the real Scheduler (runtime/scheduler.py): queue ->
pop_batch -> encode under the cache lock -> dirty-row snapshot upload ->
engine -> AsyncFetch -> batched state commit -> bind/event tail.

`run_raw` is the raw loop: encode -> engine -> commit.

`run_preemption` drives the live Scheduler with preemption on: a full
cluster of running pods at two priorities (`preemption_fleet`,
`preemption_running_pods`) and a batch of higher-priority pods that fit
nowhere (`preemptors`), through FitError -> candidates -> kernel K2 ->
victims deleted -> nomination -> the next cycle's placement.

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
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import time
from typing import List, Sequence

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

ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
HOSTNAME_KEY = "kubernetes.io/hostname"
N_DEPLOY = 20
NODE_PODS_CAP = 110
WORKLOADS = ("plain", "node-affinity", "pod-affinity", "pod-anti-affinity")
ENGINES = ("speculative", "sequential")


def bench_nodes(n_nodes: int, pods_per_node: int = NODE_PODS_CAP,
                cpu: str = "32", mem: str = "256Gi",
                make_node=make_node) -> List[Node]:
    """The bench fleet: zone i%8, tier b on every third node, a NoSchedule
    taint on one node in 50; `cpu` and `mem` per node.  make_node: the
    object factory (the JAX package's gives the same nodes to its
    scheduler)."""
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
    engine, "scheduled", "unschedulable"}.  "launch" includes the device
    rounds, since the speculative engine checks for active pods on the
    host once per round."""
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
    rounds: List[int] = []
    redos = 0

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
            redos += int(fn.last_redo)
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
        "rounds": rounds,
        "redos": redos,
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
                preemption: bool = False):
    """bench.py run_live's SchedulerConfig with the port's settings given
    explicitly: preemption off unless asked for, the CPU degradation
    engine and the observatories off."""
    from kubernetes_tpu_torch.runtime.scheduler import SchedulerConfig

    return SchedulerConfig(
        batch_size=batch, batch_window_s=0.0, engine=engine,
        disable_preemption=not preemption, batched_commit=batched,
        pipeline_commit=pipeline, cpu_fallback=False, telemetry=False,
        quality_top_k=0, timeline=False,
    )


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
             budget_s: float = 900.0) -> dict:
    """bench.py run_live on the port: `n_pods` pending pods of `workload`
    through the live Scheduler, after a warmup batch of `batch` pods
    (pending_pod(n_pods + j)) drained outside the clock.  `existing`
    running pods are added first; `nominations` [(pod, node name)] are
    registered on the queue (queue.update_nominated_pod) after the warmup
    and before the clock: preemptors that wait for their victims and are
    not in the active queue.

    Returns bench.py's keys (pods_per_s, seconds, placed, unschedulable,
    commit_seconds, phases, phase_sum_seconds, overlap_efficiency,
    setup_seconds; unrounded) and: "hosts" i32[n_pods + batch] bound node
    row per pod index (-1 unbound), "bind_order" i32[] pod indices in
    binder call order (warmup included), "node_names" row -> name,
    "cycles" committed in the timed window, "commit_state_seconds" and
    "tail_seconds" (the two halves of commit), "scatter_rows" dirty rows
    scattered per update in the timed window, "transfers" the timed
    window's bytes and calls per seam, "snapshot_bytes" one full snapshot
    upload's bytes, "requested" the final requested columns,
    "unschedulable_pods" the names of every unschedulable verdict,
    "gc_full" the full collections of Python's cyclic collector in the
    timed window and their seconds (one full collection runs just before
    it), and "scheduler" the Scheduler."""
    from kubernetes_tpu_torch.codec.transfer import transfer_delta, transfer_totals
    from kubernetes_tpu_torch.runtime.cache import SchedulerCache
    from kubernetes_tpu_torch.runtime.queue import PriorityQueue
    from kubernetes_tpu_torch.runtime.scheduler import Scheduler

    t_setup = time.monotonic()
    enc = build_encoder(nodes, existing)
    cache = SchedulerCache(enc)
    queue = PriorityQueue()
    hosts = np.full(n_pods + batch, -1, np.int32)
    order: List[int] = []

    def binder(pod, node_name):
        i = int(pod.name.rsplit("-", 1)[1])
        hosts[i] = enc.node_rows[node_name]
        order.append(i)
        return True

    sched = Scheduler(cache=cache, queue=queue, binder=binder,
                      config=live_config(batch, engine, batched, pipeline),
                      device=device)

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

    for j in range(batch):
        queue.add(pending_pod(n_pods + j, workload))
    _drain(600)
    for pod, node_name in nominations or ():
        queue.update_nominated_pod(pod, node_name)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - t_setup
    for k in sched.phase_seconds:
        sched.phase_seconds[k] = 0.0
    sched.commit_state_seconds = 0.0
    cycles0 = sched.cycles_total
    scatter0 = len(sched._dev_snapshot.scatter_rows)
    xfer0 = transfer_totals()
    # pod objects are built outside the clock; the queue adds are inside
    pending = [pending_pod(i, workload) for i in range(n_pods)]
    # and so is the cyclic collector's work on everything built before the
    # clock: else whether a full collection falls inside it depends on all
    # the process did before
    gc.collect()
    with full_collections() as gc_full:
        t0 = time.monotonic()
        for p in pending:
            queue.add(p)
        t_enqueue = time.monotonic() - t0
        placed = _drain(budget_s)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.monotonic() - t0
    ph = dict(sched.phase_seconds)
    # "fetch" is the async D2H window measured on the fetch worker, so it
    # overlaps the host phases; host_stall and fetch_block (aliases) are a
    # SUBSET of it and are left out of the sum
    phase_sum = (sum(ph.values()) - ph["fetch_block"] - ph["host_stall"]
                 + t_enqueue)
    snap = enc.snapshot()
    return {
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
                            make_pod=make_pod) -> List[Pod]:
    """The running pods that fill every node to its 4 CPU: 4 production
    pods (priority 1,000, 1 CPU / 1Gi) on each node, except every
    BATCH_NODE_EVERY-th, which holds 2 production pods and 4 batch pods
    (priority 0, 500m / 512Mi) with distinct start times from `seed`."""
    batch_rows = range(0, len(nodes), BATCH_NODE_EVERY)
    starts = 1.6e9 + np.random.default_rng(seed).permutation(
        4 * len(batch_rows)) * 7.0
    pods: List[Pod] = []
    k = b = 0
    for i, node in enumerate(nodes):
        batch_node = i % BATCH_NODE_EVERY == 0
        for _ in range(2 if batch_node else 4):
            pod = make_pod(f"prod-{k}", cpu="1", mem="1Gi",
                           priority=PRODUCTION_PRIORITY, node_name=node.name)
            pod.status.start_time = 1.5e9 + k
            pods.append(pod)
            k += 1
        if batch_node:
            for _ in range(4):
                pod = make_pod(f"batch-{b}", cpu="500m", mem="512Mi",
                               priority=BATCH_PRIORITY, node_name=node.name)
                pod.status.start_time = float(starts[b])
                pods.append(pod)
                b += 1
    return pods


def preemptors(k: int, make_pod=make_pod) -> List[Pod]:
    """`k` pending pods at priority 500 asking for 1.5 CPU / 1Gi, with no
    toleration: they fit on no full node and preempt batch pods."""
    return [make_pod(f"preemptor-{j}", cpu="1500m", mem="1Gi",
                     priority=PREEMPTING_PRIORITY) for j in range(k)]


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
