"""Regenerate the golden files tests/data/torch_port_golden_<workload>.npz:
the JAX speculative engine's winners for one of bench.py's workloads at
full width (5,000 nodes, 10,000 pending pods, batch 2,048), computed on the
CPU.

Not a test.  It imports the JAX package; chip_smoke.py only reads the files
and requires the PyTorch port's winners on the card to equal them bit for
bit.

    python tests/make_torch_golden.py                      # plain, ~5 s
    python tests/make_torch_golden.py --workload pod-anti-affinity \
        --existing 1000                                    # ~20-30 s
    python tests/make_torch_golden.py --workload pod-affinity
    python tests/make_torch_golden.py --workload pod-anti-affinity \
        --node-pods 2 --pods 9800 \
        --out tests/data/torch_port_golden_affinity_redo.npz  # ~37 min
    python tests/make_torch_golden.py --nodes 64 --pods 300 --batch 128 \
        --out /tmp/small.npz                               # a quick small run

The loop mirrors bench.py run()'s timed section: `existing` running pods
are added first; for the plain and node-affinity workloads batch k+1 is
encoded and launched before batch k is committed (overlap_commit), the pod
(anti-)affinity workloads commit first and pass the in-batch affinity
state; the tail batch is padded to the batch width with its padding marked
valid=False, and the device state is chained between batches.

With --live, the golden is the JAX Scheduler's live cycle instead
(`jax_live`, the loop of bench.py run_live and of the port's
loop.run_live): a warmup batch, then the pods through queue -> cycle ->
commit with batched and pipelined commit; the file holds the node row bound
to every pod (warmup included) and the binder's call order.
--nominated K registers loop.nominated_preemptors(nodes, K) on the queue
before the clock.

    python tests/make_torch_golden.py --live               # ~40 s
    python tests/make_torch_golden.py --live --nominated 256

With --live --preemption K, the golden is the JAX Scheduler with
preemption on (`jax_preemption`, the loop of the port's
loop.run_preemption): the fleet at scheduler_perf's node size with every
node full of running pods (loop.preemption_running_pods), then K pending
preemptors (loop.preemptors) drained.  The file holds the preemptions in
order (preemptor, node, victims), the bindings in binder call order and
the final requested CPU per node row.

    python tests/make_torch_golden.py --live --preemption 256   # ~2-4 min

With --live --preemption K --affinity-preemptors, the running pods carry
labels (loop.preemption_running_pods(labels=True)) and the pending pods
are K // 4 preemptors of each kind of loop.affinity_preemptors (required
pod affinity to a batch pod's node, to a team: east pod's zone, to the
pod's own label's zone through the bootstrap rule, and on a topology key
no node carries); the file,
tests/data/torch_port_golden_live_preemption_affinity.npz, holds the same
arrays as the preemption golden.

    python tests/make_torch_golden.py --live --preemption 16 \
        --affinity-preemptors

With --live --quality K, the JAX Scheduler runs the live cell with the
placement-quality observatory on (quality_top_k=K, a regret sample every
--quality-interval cycles, default 1); loop.record_quality wraps its
on_cycle to catch every cycle's top-k leaves and every regret sample.  The
file, tests/data/torch_port_golden_live_quality.npz, holds the bindings
and their order, the leaves of every cycle (concatenated, with the
cycles' pod counts) and the regret samples' integers.

    python tests/make_torch_golden.py --live --quality 3   # ~1 min

With --workload live-default, the JAX Scheduler runs the live cell (plain
pods) at the reference's default SchedulerConfig with only cpu_fallback
turned off (and bench.py run_live's batch, window, commit and preemption
settings): telemetry at interval 1, the timeline, quality_top_k=3 at
interval 32.  loop.record_telemetry wraps the hub's and the observatory's
on_cycle; the file, tests/data/torch_port_golden_live_default.npz, holds
the bindings and their order, every telemetry sample's cycle, source and
analytics, the drift detectors' state after every cycle, and the quality
record (top-k leaves, regret samples).

    python tests/make_torch_golden.py --workload live-default   # ~20 s

With --megacycle K, the JAX Scheduler runs the megacycle cell
(`jax_megacycle`, the loop of bench.py run_megacycle and of the port's
loop.run_megacycle) at the same default config with megacycle_batches=K:
a warmup of batch * max(2, K) + batch // 2 pods, then the pods.  The file,
tests/data/torch_port_golden_live_megacycle.npz, holds the bindings and
their order, every window's top-k leaves, the regret samples and every
telemetry sample.

    python tests/make_torch_golden.py --megacycle 4   # ~1 min

With --extender, the golden is the JAX package's extender sidecar driven
over HTTP by loop.drive_extender (`jax_extender`), as a stock
kube-scheduler with NodeCacheCapable: true drives it: the bench fleet of
--nodes nodes, the 20 spread selectors and --existing running pods
synced, then --pods pending pods through /filter, /prioritize and /bind;
and a second sidecar synced with the preemption cell's fleet and running
pods (loop.preemption_fleet, loop.preemption_running_pods) answering one
/preempt for each of the first --preempt preemptors (loop.preemptors).
The file, tests/data/torch_port_golden_extender.npz, holds the sha256 of
every reply as canonical JSON, the bound node per pod and the /preempt
replies.

    python tests/make_torch_golden.py --extender --pods 512 \
        --existing 1000                                    # ~4-5 min

With --extender --affinity-preemptors, only the /preempt drive, on a
sidecar synced with the preemption fleet and its labelled running pods,
of --preempt // 3 preemptors of each of loop.affinity_preemptors' kinds
a-c (`jax_extender_affinity`); the file,
tests/data/torch_port_golden_extender_affinity.npz, holds the replies'
digests and the replies as canonical JSON.

    python tests/make_torch_golden.py --extender --affinity-preemptors \
        --preempt 6

With --live --extender, the golden is the JAX Scheduler in the live cell
with one HTTP extender (filter, prioritize and bind verbs) pointed at the
JAX package's sidecar in the same process (`jax_live(extender=True)`, the
loop of the port's loop.run_live(sidecar=...)), pipeline_commit off, a
warmup of --warmup pods (default --batch), then --pods pods.  The file,
tests/data/torch_port_golden_live_extender.npz, holds the bound row per
pod and the bind order.

    python tests/make_torch_golden.py --live --extender --pods 1024 \
        --batch 256 --warmup 64                            # ~6-7 min
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from kubernetes_tpu_torch.loop import (  # noqa: E402
    quality_arrays,
    telemetry_arrays,
)

def golden_path(workload: str) -> str:
    """tests/data/torch_port_golden_<workload, dashes as underscores>.npz"""
    return os.path.join(_ROOT, "tests", "data", "torch_port_golden_"
                        f"{workload.replace('-', '_')}.npz")


def live_golden_path(nominated: int = 0, preemption: int = 0,
                     quality: int = 0) -> str:
    """tests/data/torch_port_golden_live[_nominated|_preemption|_quality]
    .npz"""
    if preemption:
        return golden_path("live_preemption")
    if quality:
        return golden_path("live_quality")
    return golden_path("live_nominated" if nominated else "live")


DEFAULT_OUT = golden_path("plain")
# the full-width goldens: workload -> running pods added before the clock
GOLDENS = {"plain": 0, "pod-anti-affinity": 1000, "pod-affinity": 0}


def _jax_fleet(n_nodes: int, workload: str, node_pods: int = 110,
               existing: int = 0, extended: int = 0):
    """(bench args, JAX SnapshotEncoder) of bench.py's fleet with
    `node_pods` slots per node, `existing` running pods and `extended`
    extended resources a node (loop.bench_nodes'), the objects the port's
    loop.build_encoder builds."""
    import bench
    from kubernetes_tpu.api.factory import make_node, make_pod
    from kubernetes_tpu_torch.loop import bench_nodes

    args = SimpleNamespace(nodes=n_nodes, workload=workload)
    nodes = bench._bench_nodes(args)
    if extended:
        nodes = bench_nodes(n_nodes, node_pods, make_node=make_node,
                            extended=extended)
    elif node_pods != bench._NODE_PODS_CAP:
        nodes = [
            make_node(n.name, cpu="32", mem="256Gi", pods=node_pods,
                      labels=dict(n.labels),
                      taints=[{"key": t.key, "value": t.value,
                               "effect": t.effect} for t in n.spec.taints])
            for n in nodes
        ]
    enc = bench._build_encoder(args, nodes)
    for i in range(existing):
        enc.add_pod(make_pod(
            f"existing-{i}", cpu="100m", mem="256Mi",
            labels={"app": f"dep-{i % bench._N_DEPLOY}"},
            node_name=f"node-{i % n_nodes}",
            owner=("ReplicaSet", f"rs-{i % bench._N_DEPLOY}")))
    return args, enc


def jax_live(n_nodes: int, n_pods: int, batch: int, workload: str = "plain",
             engine: str = "speculative", batched: bool = True,
             pipeline: bool = True, existing: int = 0, nominated: int = 0,
             node_pods: int = 110, budget_s: float = 3600.0,
             quality_top_k: int = 0, quality_interval_cycles: int = 32,
             telemetry: bool = False, telemetry_interval_cycles: int = 1,
             timeline: bool = False, extended: int = 0,
             warmup=None, extender: bool = False,
             capacity_planner: bool = False,
             capacity_interval_cycles: int = 256, node_shape_catalog=None,
             make_pending=None, running=None):
    """The JAX Scheduler's live cycle under the loop of bench.py run_live
    (and of the port's loop.run_live): a warmup of `warmup` pods (default
    `batch`; index n_pods + j) drained first, `nominated` preemptors
    (loop.nominated_preemptors, built with the JAX factory) registered on
    the queue, then the `n_pods` pods enqueued and drained.  Returns (hosts
    i32[n_pods + batch] bound row per pod index, bind_order i32[] pod
    indices in binder call order, unschedulable pod names, the final
    requested column matrix, the scheduler).  With quality_top_k > 0 the
    observatory is on and the scheduler carries `quality_record`
    (loop.record_quality's, warmup included); with telemetry on it carries
    `telemetry_record` (loop.record_telemetry's).  `extended`: extended
    resources on every node (loop.bench_nodes').  With `extender`, the
    scheduler reaches a JAX ExtenderServer in this process, whose mirror
    holds the same fleet, through one HTTP extender with filter,
    prioritize and bind verbs, NodeCacheCapable: true, weight 1 (the
    port's loop.run_live(sidecar=...)); its bind verb binds in place of
    the binder.  capacity_planner, capacity_interval_cycles and
    node_shape_catalog set the Scheduler's capacity planner (the
    scheduler's `capacity` then holds every solve); make_pending(i) builds
    pod i (default bench.py's pending pod of `workload`) and
    running(nodes) the pods bound before the warmup."""
    import bench
    from kubernetes_tpu.api.factory import make_pod
    from kubernetes_tpu.runtime.cache import SchedulerCache
    from kubernetes_tpu.runtime.queue import PriorityQueue
    from kubernetes_tpu.runtime.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.loop import (
        finish_quality,
        finish_telemetry,
        nominated_preemptors,
        record_quality,
        record_telemetry,
    )

    warmup = batch if warmup is None else warmup
    args, enc = _jax_fleet(n_nodes, workload, node_pods, existing, extended)
    if make_pending is None:
        def make_pending(i):
            return bench._pending_pod(args, i)
    if running is not None:
        from kubernetes_tpu_torch.loop import bench_nodes as _nodes
        from kubernetes_tpu.api.factory import make_node

        for pod in running(_nodes(n_nodes, node_pods, make_node=make_node)):
            enc.add_pod(pod)
    cache = SchedulerCache(enc)
    queue = PriorityQueue()
    hosts = np.full(n_pods + warmup, -1, np.int32)
    order = []

    def record(name, node_name):
        i = int(name.rsplit("-", 1)[1])
        hosts[i] = enc.node_rows[node_name]
        order.append(i)

    def binder(pod, node_name):
        record(pod.name, node_name)
        return True

    extenders, server = [], None
    if extender:
        from kubernetes_tpu.extender.client import (
            ExtenderConfig,
            HTTPExtender,
        )
        from kubernetes_tpu.extender.server import ExtenderServer

        server = ExtenderServer(cache=SchedulerCache(_jax_fleet(
            n_nodes, workload, node_pods, existing, extended)[1]))
        server.start()
        host, port = server.address[:2]
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
                      extenders=extenders,
                      config=SchedulerConfig(
                          batch_size=batch, batch_window_s=0.0,
                          engine=engine, disable_preemption=True,
                          batched_commit=batched, pipeline_commit=pipeline,
                          cpu_fallback=False, telemetry=telemetry,
                          telemetry_interval_cycles=telemetry_interval_cycles,
                          quality_top_k=quality_top_k,
                          quality_interval_cycles=quality_interval_cycles,
                          timeline=timeline,
                          capacity_planner=capacity_planner,
                          capacity_interval_cycles=capacity_interval_cycles,
                          node_shape_catalog=node_shape_catalog))
    if quality_top_k:
        sched.quality_record = record_quality(sched.quality)
    if telemetry:
        sched.telemetry_record = record_telemetry(sched.telemetry,
                                                  sched.quality)

    def drain(budget):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            got = sched.run_once(timeout=0.0)
            if got == 0 and not sched.pipeline_pending:
                if not queue.has_schedulable():
                    break
                time.sleep(0.002)
        sched.flush_pipeline()

    try:
        for j in range(warmup):
            queue.add(make_pending(n_pods + j))
        drain(budget_s)
        for pod, node_name in nominated_preemptors(n_nodes, nominated,
                                                   make_pod=make_pod):
            queue.update_nominated_pod(pod, node_name)
        for i in range(n_pods):
            queue.add(make_pending(i))
        drain(budget_s)
    finally:
        if server is not None:
            server.stop()
    if quality_top_k:
        finish_quality(sched.quality, sched.quality_record)
    if telemetry:
        finish_telemetry(sched.telemetry, sched.telemetry_record)
    if capacity_planner:
        sched.capacity.finalize()
    unsched = sorted(r.pod.name for r in sched.results if r.node is None)
    return (hosts, np.asarray(order, np.int32), unsched,
            np.asarray(enc.snapshot(full=True).requested), sched)


def jax_live_default(n_nodes: int, n_pods: int, batch: int):
    """jax_live at the reference's default SchedulerConfig apart from
    cpu_fallback (and run_live's own settings): telemetry at interval 1,
    the timeline, quality_top_k=3 at interval 32, the plain workload."""
    return jax_live(n_nodes, n_pods, batch, "plain", quality_top_k=3,
                    telemetry=True, timeline=True)


def jax_live_capacity(n_nodes: int, n_pods: int, batch: int,
                      shapes: int = 64, interval: int = 1):
    """jax_live of the live capacity cell (the port's loop.run_live with the
    same settings): the bench fleet pre-filled by
    loop.capacity_running_pods, pending pod i with row i of
    loop.capacity_requests (drawn from loop.what_if_workload's backlog) as
    its requests (loop.capacity_pod), and the capacity planner every
    `interval` cycles over the first `shapes` what-if shapes
    (loop.shape_catalog)."""
    from kubernetes_tpu.api.factory import make_pod
    from kubernetes_tpu_torch import loop

    backlog, caps = loop.what_if_workload()
    reqs = loop.capacity_requests(backlog, n_pods, batch, batch)
    return jax_live(
        n_nodes, n_pods, batch, capacity_planner=True,
        capacity_interval_cycles=interval,
        node_shape_catalog=loop.shape_catalog(caps[:shapes]),
        make_pending=lambda i: loop.capacity_pod(i, reqs, make_pod=make_pod),
        running=lambda nodes: loop.capacity_running_pods(
            nodes, make_pod=make_pod))


def jax_what_if(lanes: int, max_bins: int = 2048):
    """The JAX binpack_shapes_compressed on loop.what_if_workload's backlog
    (compressed as what_if compresses it) over its first `lanes` shapes:
    (bins i32[lanes], ok bool[lanes])."""
    from kubernetes_tpu.models.binpack import (
        binpack_shapes_compressed,
        compress_classes,
    )
    from kubernetes_tpu_torch import loop

    reqs, caps = loop.what_if_workload()
    classes, counts = compress_classes(reqs, pad_to_pow2=True)
    bins, ok = binpack_shapes_compressed(classes, counts, caps[:lanes],
                                         max_bins=max_bins)
    return np.asarray(bins), np.asarray(ok)


def jax_megacycle(n_nodes: int, n_pods: int, batch: int, k: int,
                  engine: str = "speculative", pipeline: bool = True,
                  warm_k: int = 0, budget_s: float = 3600.0):
    """The JAX Scheduler under the loop of bench.py run_megacycle (and of
    the port's loop.run_megacycle) for one depth K: the reference's
    default SchedulerConfig with cpu_fallback off and run_live's batch,
    window, commit and preemption settings, megacycle_batches=k; a warmup
    of batch * max(2, warm_k or k) + batch // 2 pods (index n_pods + j),
    then `n_pods` pods.  Returns (hosts i32[n_pods + warmup] bound row per
    pod index, bind_order, the scheduler carrying `quality_record` and
    `telemetry_record`)."""
    import bench
    from kubernetes_tpu.runtime.cache import SchedulerCache
    from kubernetes_tpu.runtime.queue import PriorityQueue
    from kubernetes_tpu.runtime.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch.loop import (
        finish_quality,
        finish_telemetry,
        record_quality,
        record_telemetry,
    )

    args, enc = _jax_fleet(n_nodes, "plain")
    queue = PriorityQueue()
    warm_n = batch * max(2, warm_k or k) + max(1, batch // 2)
    hosts = np.full(n_pods + warm_n, -1, np.int32)
    order = []

    def binder(pod, node_name):
        i = int(pod.name.rsplit("-", 1)[1])
        hosts[i] = enc.node_rows[node_name]
        order.append(i)
        return True

    sched = Scheduler(cache=SchedulerCache(enc), queue=queue, binder=binder,
                      config=SchedulerConfig(
                          batch_size=batch, batch_window_s=0.0,
                          engine=engine, disable_preemption=True,
                          batched_commit=True, pipeline_commit=pipeline,
                          megacycle_batches=k, cpu_fallback=False))
    sched.quality_record = record_quality(sched.quality)
    sched.telemetry_record = record_telemetry(sched.telemetry, sched.quality)

    def drain(budget):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            got = sched.run_once(timeout=0.0)
            if got == 0 and not sched.pipeline_pending:
                if not queue.has_schedulable():
                    break
                time.sleep(0.002)
        sched.flush_pipeline()

    for j in range(warm_n):
        queue.add(bench._pending_pod(args, n_pods + j))
    drain(budget_s)
    for i in range(n_pods):
        queue.add(bench._pending_pod(args, i))
    drain(budget_s)
    finish_quality(sched.quality, sched.quality_record)
    finish_telemetry(sched.telemetry, sched.telemetry_record)
    return hosts, np.asarray(order, np.int32), sched


def jax_preemption(n_nodes: int, n_preemptors: int, batch: int,
                   budget_s: float = 3600.0, affinity: bool = False):
    """The JAX Scheduler with preemption on, under the loop of the port's
    loop.run_preemption: the same fleet, running pods and preemptors (built
    with the JAX factory), drained until nothing schedulable remains.
    affinity: the running pods labelled and n_preemptors // 4 preemptors
    of each kind of loop.affinity_preemptors in place of loop.preemptors.
    Returns (preemptions [(preemptor key, node name, victim keys)],
    bindings [(pod name, node name)] in call order, unschedulable pod
    names, the final requested column matrix, the scheduler)."""
    import bench
    from kubernetes_tpu.api.factory import make_node, make_pod
    from kubernetes_tpu.codec import SnapshotEncoder
    from kubernetes_tpu.runtime.cache import SchedulerCache
    from kubernetes_tpu.runtime.queue import PriorityQueue
    from kubernetes_tpu.runtime.scheduler import Scheduler, SchedulerConfig
    from kubernetes_tpu_torch import loop

    nodes = loop.preemption_fleet(n_nodes, make_node=make_node)
    enc = SnapshotEncoder()
    enc.add_nodes(nodes)
    for d in range(bench._N_DEPLOY):
        enc.add_spread_selector("default", {"app": f"dep-{d}"})
    enc.add_pods(loop.preemption_running_pods(nodes, make_pod=make_pod,
                                              labels=affinity))
    cache = SchedulerCache(enc)
    queue = PriorityQueue()
    bindings = []

    def binder(pod, node_name):
        bindings.append((pod.name, node_name))
        return True

    sched = Scheduler(cache=cache, queue=queue, binder=binder,
                      config=SchedulerConfig(
                          batch_size=batch, batch_window_s=0.0,
                          engine="speculative", disable_preemption=False,
                          batched_commit=True, pipeline_commit=True,
                          cpu_fallback=False, telemetry=False,
                          quality_top_k=0, timeline=False))
    pending = (loop.affinity_preemptors(n_preemptors // 4,
                                        make_pod=make_pod) if affinity
               else loop.preemptors(n_preemptors, make_pod=make_pod))
    for p in pending:
        queue.add(p)
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        got = sched.run_once(timeout=0.0)
        if got == 0 and not sched.pipeline_pending:
            if not queue.has_schedulable():
                break
            time.sleep(0.002)
    sched.flush_pipeline()
    unsched = sorted(r.pod.name for r in sched.results if r.node is None)
    return (list(sched.preemptions), bindings, unsched,
            np.asarray(enc.snapshot(full=True).requested), sched)


def jax_extender(n_nodes: int, n_pods: int, existing: int,
                 n_preempt: int, server=None):
    """loop.drive_extender against the JAX package's sidecar (or `server`,
    a class taking cache=): the bench fleet with `existing` running pods
    and `n_pods` pending pods, then a second sidecar with the preemption
    cell's fleet and running pods answering `n_preempt` /preempt
    requests.  Returns (the bench drive, the preemption drive)."""
    from kubernetes_tpu_torch import loop

    if server is None:
        from kubernetes_tpu.extender.server import ExtenderServer as server
    nodes = loop.bench_nodes(n_nodes)
    running = [loop.existing_pod(i, nodes) for i in range(existing)]
    pods = [loop.pending_pod(i) for i in range(n_pods)]
    srv = server()
    srv.start()
    try:
        main = loop.drive_extender(srv.address, nodes, running, pods)
    finally:
        srv.stop()
    fleet = loop.preemption_fleet(n_nodes)
    srv = server()
    srv.start()
    try:
        pre = loop.drive_extender(
            srv.address, fleet, loop.preemption_running_pods(fleet),
            preemptors=loop.preemptors(n_preempt))
    finally:
        srv.stop()
    return main, pre


def jax_extender_affinity(n_nodes: int, per_kind: int, server=None):
    """loop.drive_extender's /preempt against the JAX package's sidecar
    (or `server`) synced with the preemption cell's fleet and its labelled
    running pods: per_kind preemptors of each of loop.affinity_preemptors'
    kinds a-c, each reply's victims removed before the next.  Returns the
    drive."""
    from kubernetes_tpu_torch import loop

    if server is None:
        from kubernetes_tpu.extender.server import ExtenderServer as server
    fleet = loop.preemption_fleet(n_nodes)
    srv = server()
    srv.start()
    try:
        return loop.drive_extender(
            srv.address, fleet,
            loop.preemption_running_pods(fleet, labels=True),
            preemptors=loop.affinity_preemptors(per_kind, "abc"))
    finally:
        srv.stop()


def affinity_preempt_arrays(pre: dict) -> dict:
    """The affinity /preempt golden's arrays: each reply's digest (uint8
    [n, 32]) and the replies as canonical JSON."""
    import json

    return dict(
        preempt=np.asarray([list(x) for x in pre["digests"]["preempt"]],
                           np.uint8).reshape(-1, 32),
        preempt_replies=np.asarray(
            [json.dumps(r, sort_keys=True, separators=(",", ":"))
             for r in pre["preempt_replies"]], dtype=str))


def extender_arrays(main: dict, pre: dict) -> dict:
    """The extender golden's arrays: each verb's reply digests (uint8 [n,
    32]), the bound node per pod as its bench index (-1 none) and the
    /preempt replies as canonical JSON."""
    import json

    def d(v):
        return np.asarray([list(x) for x in v], np.uint8).reshape(-1, 32)

    return dict(
        filter=d(main["digests"]["filter"]),
        prioritize=d(main["digests"]["prioritize"]),
        bind=d(main["digests"]["bind"]),
        preempt=d(pre["digests"]["preempt"]),
        bound=np.asarray([int(b.rsplit("-", 1)[1]) if b else -1
                          for b in main["bound"]], np.int32),
        preempt_replies=np.asarray(
            [json.dumps(r, sort_keys=True, separators=(",", ":"))
             for r in pre["preempt_replies"]], dtype=str),
    )


def preemption_arrays(preemptions, bindings):
    """The golden file's flat arrays of a preemption run: preemptor names,
    node names, victims per preemption (counts and the flat names), bound
    pod names and node names in call order."""
    return dict(
        preemptor=np.asarray([p[0][1] for p in preemptions], dtype=str),
        preempt_node=np.asarray([p[1] for p in preemptions], dtype=str),
        victim_count=np.asarray([len(p[2]) for p in preemptions], np.int32),
        victims=np.asarray([v[1] for p in preemptions for v in p[2]],
                           dtype=str),
        bound_pod=np.asarray([b[0] for b in bindings], dtype=str),
        bound_node=np.asarray([b[1] for b in bindings], dtype=str),
    )


def jax_chained_hosts(n_nodes: int, n_pods: int, batch: int,
                      workload: str = "plain", node_pods: int = 110,
                      existing: int = 0):
    """hosts i32[n_pods] from the JAX speculative engine, chained over
    batches exactly as bench.py run() does, plus per-batch (rounds, redo).

    node_pods overrides the fleet's per-node pod cap (bench.py uses 110);
    a small cap makes demand exceed the slots and fires the hybrid redo.
    existing running pods are added first, as bench.py's --existing."""
    import jax

    import bench
    from kubernetes_tpu.models.batched import (
        batch_has_pod_affinity,
        encode_batch_affinity,
        encode_batch_ports,
    )
    from kubernetes_tpu.models.speculative import make_speculative_scheduler

    args, enc = _jax_fleet(n_nodes, workload, node_pods, existing)
    fn = make_speculative_scheduler(
        unsched_taint_key=enc.interner.intern(
            "node.kubernetes.io/unschedulable"),
        zone_key_id=enc.getzone_key,
    )
    row_names = {row: name for name, row in enc.node_rows.items()}
    out = np.full(n_pods, -1, np.int32)
    stats = []

    def commit(start, pods, hosts_dev):
        hosts = np.asarray(hosts_dev)
        committed = []
        for j, pod in enumerate(pods):
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

    state = enc.snapshot()
    last = 0
    in_flight = None
    overlap_commit = workload in ("plain", "node-affinity")
    for start in range(0, n_pods, batch):
        n = min(batch, n_pods - start)
        pods = [bench._pending_pod(args, start + j) for j in range(n)]
        if n < batch:
            pods += [bench._pending_pod(args, start) for _ in range(batch - n)]
        if not overlap_commit and in_flight is not None:
            commit(*in_flight)
            in_flight = None
        aff = (encode_batch_affinity(enc, pods)
               if batch_has_pod_affinity(pods) else None)
        b = enc.encode_pods(pods)
        if n < batch:
            valid = np.array(b.valid, bool)
            valid[n:] = False
            b = dataclasses.replace(b, valid=valid)
        ports = encode_batch_ports(enc, pods)
        hosts, state = fn(state, b, ports, np.int32(last), aff_state=aff)
        stats.append((int(fn.last_rounds), bool(fn.last_redo)))
        last += n
        if in_flight is not None:
            commit(*in_flight)
        in_flight = (start, pods[:n], hosts)
    commit(*in_flight)
    jax.block_until_ready(state.requested)
    return out, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--workload", default="plain",
                    choices=("plain", "node-affinity", "pod-affinity",
                             "pod-anti-affinity", "live-default"))
    ap.add_argument("--existing", type=int, default=0,
                    help="running pods added before the clock")
    ap.add_argument("--node-pods", type=int, default=110,
                    help="pod slots per node")
    ap.add_argument("--out", default=None,
                    help="default: tests/data/torch_port_golden_<workload>"
                         ".npz, or _live[_nominated].npz with --live")
    ap.add_argument("--live", action="store_true",
                    help="the JAX Scheduler's live cycle (bench.py "
                         "run_live's loop) instead of the raw loop")
    ap.add_argument("--nominated", type=int, default=0,
                    help="with --live: preemptors nominated before the "
                         "clock (loop.nominated_preemptors)")
    ap.add_argument("--quality", type=int, default=0,
                    help="with --live: quality_top_k (the observatory on; "
                         "writes the _live_quality golden)")
    ap.add_argument("--quality-interval", type=int, default=1,
                    help="with --live --quality: quality_interval_cycles")
    ap.add_argument("--megacycle", type=int, default=0,
                    help="the megacycle cell at this depth K (the "
                         "_live_megacycle golden)")
    ap.add_argument("--preemption", type=int, default=0,
                    help="with --live: the preemption cell with this many "
                         "preemptors (loop.run_preemption's loop)")
    ap.add_argument("--extender", action="store_true",
                    help="the extender sidecar driven over HTTP "
                         "(loop.drive_extender; the _extender golden), or "
                         "with --live the live Scheduler with an HTTP "
                         "extender (jax_live(extender=True); the "
                         "_live_extender golden)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="with --live --extender: warmup pods (default "
                         "--batch)")
    ap.add_argument("--capacity", action="store_true",
                    help="with --live: the live capacity cell "
                         "(jax_live_capacity; the _live_capacity golden)")
    ap.add_argument("--what-if", type=int, default=0, metavar="LANES",
                    help="the BASELINE what-if's first LANES shapes "
                         "(jax_what_if; the _what_if golden)")
    ap.add_argument("--preempt", type=int, default=16,
                    help="with --extender: /preempt requests of the "
                         "preemption cell's first preemptors")
    ap.add_argument("--affinity-preemptors", action="store_true",
                    help="with --live --preemption K: the running pods "
                         "labelled and K // 4 preemptors of each kind of "
                         "loop.affinity_preemptors; with --extender: only "
                         "the /preempt drive of --preempt // 3 preemptors "
                         "of each of its kinds a-c")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.what_if:
        out = args.out or golden_path("what_if")
        t0 = time.monotonic()
        bins, ok = jax_what_if(args.what_if)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(out, bins=bins, ok=ok, max_bins=np.int32(2048),
                            lanes=np.int32(args.what_if))
        print(f"wrote {out}: {args.what_if} lanes, {int(ok.sum())} fit, "
              f"{dt:.1f} s on the CPU")
        return
    if args.live and args.capacity:
        from kubernetes_tpu_torch.loop import capacity_arrays

        out = args.out or golden_path("live_capacity")
        t0 = time.monotonic()
        hosts, order, unsched, _, sched = jax_live_capacity(
            args.nodes, args.pods, args.batch)
        dt = time.monotonic() - t0
        samples = sched.capacity.debug_payload()["samples"]
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, hosts=hosts, bind_order=order,
            unschedulable=np.asarray(unsched, dtype=str),
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            batch=np.int32(args.batch), **capacity_arrays(samples))
        print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} bound, "
              f"{len(samples)} solves, overflow "
              f"{[x['overflow_pods'] for x in samples]}, absorbed "
              f"{[x['absorbed_existing'] for x in samples]}, "
              f"{dt:.1f} s on the CPU")
        return
    if args.extender and args.live:
        out = args.out or golden_path("live_extender")
        t0 = time.monotonic()
        hosts, order, _, _, _ = jax_live(
            args.nodes, args.pods, args.batch, pipeline=False,
            warmup=args.warmup, extender=True)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, hosts=hosts, bind_order=order,
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            batch=np.int32(args.batch),
            warmup=np.int32(len(hosts) - args.pods),
        )
        print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} bound "
              f"(warmup included), {dt:.1f} s on the CPU")
        return
    if args.extender and args.affinity_preemptors:
        out = args.out or golden_path("extender_affinity")
        t0 = time.monotonic()
        pre = jax_extender_affinity(args.nodes, args.preempt // 3)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, **affinity_preempt_arrays(pre),
            nodes=np.int32(args.nodes),
            per_kind=np.int32(args.preempt // 3))
        print(f"wrote {out}: {len(pre['preempt_replies'])} /preempt "
              f"replies, sync {pre['sync_seconds']:.1f} s, {dt:.1f} s on "
              f"the CPU")
        return
    if args.extender:
        out = args.out or golden_path("extender")
        t0 = time.monotonic()
        main, pre = jax_extender(args.nodes, args.pods, args.existing,
                                 args.preempt)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, **extender_arrays(main, pre),
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            existing=np.int32(args.existing),
        )
        print(f"wrote {out}: {sum(1 for b in main['bound'] if b)}/"
              f"{len(main['bound'])} bound, {len(pre['preempt_replies'])} "
              f"/preempt replies, sync {main['sync_seconds']:.1f} s + "
              f"{pre['sync_seconds']:.1f} s, {dt:.1f} s on the CPU")
        return
    if args.megacycle:
        out = args.out or golden_path("live_megacycle")
        t0 = time.monotonic()
        hosts, order, sched = jax_megacycle(
            args.nodes, args.pods, args.batch, args.megacycle)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, hosts=hosts, bind_order=order,
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            batch=np.int32(args.batch), k=np.int32(args.megacycle),
            megacycles=np.int32(sched.megacycles_total),
            **telemetry_arrays(sched.telemetry_record),
            **quality_arrays(sched.quality_record),
        )
        print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} bound, "
              f"{sched.megacycles_total} megacycles, "
              f"{len(sched.telemetry_record['samples'])} telemetry samples, "
              f"{len(sched.quality_record['regret'])} regret samples, "
              f"{dt:.1f} s on the CPU")
        return
    if args.workload == "live-default":
        out = args.out or golden_path("live_default")
        t0 = time.monotonic()
        hosts, order, unsched, _, sched = jax_live_default(
            args.nodes, args.pods, args.batch)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, hosts=hosts, bind_order=order,
            unschedulable=np.asarray(unsched, dtype=str),
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            batch=np.int32(args.batch),
            **telemetry_arrays(sched.telemetry_record),
            **quality_arrays(sched.quality_record),
        )
        print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} bound, "
              f"{len(sched.telemetry_record['samples'])} telemetry samples, "
              f"{len(sched.quality_record['regret'])} regret samples, "
              f"{dt:.1f} s on the CPU")
        return
    if args.live and args.preemption:
        out = args.out or (golden_path("live_preemption_affinity")
                           if args.affinity_preemptors else
                           live_golden_path(preemption=args.preemption))
        t0 = time.monotonic()
        preemptions, bindings, unsched, requested, sched = jax_preemption(
            args.nodes, args.preemption, args.batch,
            affinity=args.affinity_preemptors)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, **preemption_arrays(preemptions, bindings),
            unschedulable=np.asarray(unsched, dtype=str),
            requested_cpu=requested[:, 0].astype(np.float32),
            nodes=np.int32(args.nodes), batch=np.int32(args.batch),
            preemptors=np.int32(args.preemption),
        )
        print(f"wrote {out}: {len(preemptions)} preemptions, "
              f"{len(bindings)} bindings, {len(unsched)} unschedulable "
              f"verdicts, {dt:.1f} s on the CPU")
        return
    if args.live and args.quality:
        out = args.out or live_golden_path(quality=args.quality)
        t0 = time.monotonic()
        hosts, order, unsched, _, sched = jax_live(
            args.nodes, args.pods, args.batch, args.workload,
            quality_top_k=args.quality,
            quality_interval_cycles=args.quality_interval)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, hosts=hosts, bind_order=order,
            unschedulable=np.asarray(unsched, dtype=str),
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            batch=np.int32(args.batch), top_k=np.int32(args.quality),
            interval=np.int32(args.quality_interval),
            **quality_arrays(sched.quality_record),
        )
        print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} bound, "
              f"{len(sched.quality_record['topk'])} cycles of top-k, "
              f"{len(sched.quality_record['regret'])} regret samples, "
              f"{dt:.1f} s on the CPU")
        return
    if args.live:
        out = args.out or live_golden_path(args.nominated)
        t0 = time.monotonic()
        hosts, order, unsched, requested, _ = jax_live(
            args.nodes, args.pods, args.batch, args.workload,
            existing=args.existing, nominated=args.nominated,
            node_pods=args.node_pods)
        dt = time.monotonic() - t0
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, hosts=hosts, bind_order=order,
            unschedulable=np.asarray(unsched, dtype=str),
            nodes=np.int32(args.nodes), pods=np.int32(args.pods),
            batch=np.int32(args.batch), existing=np.int32(args.existing),
            node_pods=np.int32(args.node_pods),
            nominated=np.int32(args.nominated),
            workload=np.asarray(args.workload),
        )
        print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} bound "
              f"(warmup included), {len(unsched)} unschedulable verdicts, "
              f"{dt:.1f} s on the CPU")
        return
    out = args.out or golden_path(args.workload)
    t0 = time.monotonic()
    hosts, stats = jax_chained_hosts(args.nodes, args.pods, args.batch,
                                     args.workload, args.node_pods,
                                     args.existing)
    dt = time.monotonic() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(
        out, hosts=hosts,
        nodes=np.int32(args.nodes), pods=np.int32(args.pods),
        batch=np.int32(args.batch), existing=np.int32(args.existing),
        node_pods=np.int32(args.node_pods),
        rounds=np.array([r for r, _ in stats], np.int32),
        redos=np.int32(sum(int(r) for _, r in stats)),
    )
    print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} placed, "
          f"rounds/redo per batch {stats}, {dt:.1f} s on the CPU")


if __name__ == "__main__":
    main()
