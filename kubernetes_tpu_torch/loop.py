"""The raw scheduling loop on the port: encode -> engine -> commit.

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

import copy
import dataclasses
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


def bench_nodes(n_nodes: int, pods_per_node: int = NODE_PODS_CAP) -> List[Node]:
    """The bench fleet: zone i%8, tier b on every third node, a NoSchedule
    taint on one node in 50."""
    return [
        make_node(
            f"node-{i}",
            cpu="32",
            mem="256Gi",
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
        hosts = transfer.fetch_hosts(hosts_dev)  # waits for the device
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
