"""The slice's oracle: the port's live Scheduler against the JAX Scheduler,
on CPU, binding for binding.

Both run bench.py run_live's loop (tests/make_torch_golden.py jax_live
and kubernetes_tpu_torch.loop.run_live) on the same workload, each with its
own encoder, cache and queue, with the slice's config (preemption, the CPU
degradation engine and the observatories off).  The binder records every
(pod, node) in call order: the bound row of every pod, the call order, the
unschedulable verdicts and the final requested columns must be equal.
Covered: the plain, node-affinity and pod-anti-affinity (with running pods)
workloads, a 2-slot fleet with unschedulable pods, both engines, pipelined
and not, per-pod commit, nominations registered on the queue, and injected
transient faults at dispatch and at the fence.  The port's refusals of
later slices' settings, its fault path with no CPU fallback, and the
full-width golden files are checked too (preemption itself:
tests/test_torch_preempt_live.py).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest

from kubernetes_tpu_torch import loop
from kubernetes_tpu_torch.codec import faults
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PriorityQueue
from kubernetes_tpu_torch.runtime.scheduler import (
    Scheduler,
    SchedulerConfig,
    refused_settings,
)

from make_torch_golden import jax_live, live_golden_path
from torch_port_helpers import process_state_kept


@functools.lru_cache(maxsize=None)
def _jax(n_nodes, n_pods, batch, workload="plain", engine="speculative",
         batched=True, pipeline=True, existing=0, nominated=0, node_pods=110):
    hosts, order, unsched, requested, _ = jax_live(
        n_nodes, n_pods, batch, workload, engine, batched, pipeline,
        existing, nominated, node_pods)
    return hosts, order, unsched, requested


def _port(n_nodes, n_pods, batch, workload="plain", engine="speculative",
          batched=True, pipeline=True, existing=0, nominated=0,
          node_pods=110):
    nodes = loop.bench_nodes(n_nodes, node_pods)
    return loop.run_live(
        nodes, n_pods, batch, workload, device="cpu", engine=engine,
        batched=batched, pipeline=pipeline, existing=existing,
        nominations=loop.nominated_preemptors(n_nodes, nominated))


def _assert_same(res, want):
    hosts, order, unsched, requested = want
    np.testing.assert_array_equal(res["hosts"], hosts)
    np.testing.assert_array_equal(res["bind_order"], order)
    assert res["unschedulable_pods"] == unsched
    np.testing.assert_array_equal(res["requested"], requested)


CASES = [
    # (n_nodes, n_pods, batch, workload, engine, batched, pipeline,
    #  existing, nominated, node_pods)
    (200, 500, 64, "plain", "speculative", True, True, 0, 0, 110),
    (200, 500, 64, "plain", "speculative", True, False, 0, 0, 110),
    (200, 500, 64, "plain", "sequential", True, True, 0, 0, 110),
    (200, 400, 128, "plain", "sequential", False, False, 0, 0, 110),
    (160, 400, 64, "node-affinity", "speculative", True, True, 0, 0, 110),
    (160, 400, 64, "pod-anti-affinity", "speculative", True, True, 100, 0,
     110),
    (160, 400, 64, "pod-anti-affinity", "sequential", True, False, 100, 0,
     110),
    # 2 slots a node: pods left unschedulable, batches redone
    (150, 360, 64, "plain", "speculative", True, True, 0, 0, 2),
    (200, 500, 64, "plain", "speculative", True, True, 0, 24, 110),
    (200, 500, 64, "plain", "sequential", True, False, 0, 24, 110),
]


@pytest.mark.parametrize(
    "case", CASES,
    ids=["-".join(str(x) for x in (c[3], c[4], "batched" if c[5] else
                                   "perpod", "pipe" if c[6] else "sync",
                                   f"ex{c[7]}", f"nom{c[8]}", f"slots{c[9]}"))
         for c in CASES])
def test_live_bindings_match_jax_scheduler(case):
    res = _port(*case)
    _assert_same(res, _jax(*case))
    n_pods, batch = case[1], case[2]
    assert res["placed"] + res["unschedulable"] == n_pods
    if case[9] == 110:
        assert res["placed"] == n_pods
    else:
        assert res["unschedulable_pods"]
    assert res["cycles"] >= -(-n_pods // batch)
    assert res["pods_per_s"] > 0 and res["overlap_efficiency"] > 0
    assert set(res["phases"]) == {"enqueue", "pop", "encode", "dispatch",
                                  "fetch", "host_stall", "fetch_block",
                                  "commit", "preempt"}


def test_live_scatters_dirty_rows():
    """At 200 nodes (256 rows) a 64-pod batch dirties at most N/4 rows:
    every timed cycle scatters its row fields; only group_counts (not
    row-confined, as in the reference) still uploads whole, a small part
    of a full snapshot."""
    res = _port(200, 500, 64)
    assert len(res["scatter_rows"]) == res["cycles"]
    assert max(res["scatter_rows"]) <= 64
    xf = res["transfers"]
    assert xf["h2d/dirty_scatter"]["calls"] > 0
    assert xf["h2d/snapshot_upload"]["calls"] == res["cycles"]
    assert (xf["h2d/snapshot_upload"]["bytes"] / res["cycles"]
            < res["snapshot_bytes"] / 4)


def test_live_nominations_hold():
    """The nominated nodes' claims leave 50m of CPU: no pending pod lands
    there; and the queue keeps the preemptors nominated."""
    res = _port(200, 500, 64, nominated=24)
    rows = {int(r) for r in res["hosts"][:500]}
    nominated = {f"node-{(19 * j) % 200}" for j in range(24)}
    names = res["node_names"]
    assert not {names[r] for r in rows if r >= 0} & nominated
    assert len(res["scheduler"].queue.nominated_pods()) == 24


def test_live_retries_injected_faults():
    """A transient fault at dispatch and one at the fence: the same batch
    is re-dispatched, and every binding equals the fault-free JAX run."""
    inj = faults.FaultInjector(seed=3)
    inj.arm(faults.SITE_DISPATCH, count=1)
    inj.arm(faults.SITE_FENCE, count=1)
    remove = faults.install_injector(inj)
    try:
        res = _port(200, 500, 64)
    finally:
        remove()
    assert [site for site, _ in inj.log] == ["dispatch", "fence"]
    _assert_same(res, _jax(200, 500, 64))
    health = res["scheduler"].device_health
    assert health.state == "closed" and health.fault_counts


def _small_scheduler(**kw):
    nodes = loop.bench_nodes(16)
    cache = SchedulerCache(loop.build_encoder(nodes))
    queue = PriorityQueue()
    cfg = loop.live_config(8)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return Scheduler(cache=cache, queue=queue, config=cfg, device="cpu")


def test_persistent_fault_requeues_and_raises():
    """No CPU fallback in this slice: a persistent device fault trips the
    breaker, the popped batch goes back to the queue, the error
    propagates."""
    sched = _small_scheduler()
    for i in range(8):
        sched.queue.add(loop.pending_pod(i))
    inj = faults.FaultInjector()
    inj.arm(faults.SITE_DISPATCH, kind=faults.FAULT_PERSISTENT, count=1)
    remove = faults.install_injector(inj)
    try:
        with pytest.raises(faults.PersistentDeviceError):
            sched.run_once(timeout=0.0)
    finally:
        remove()
    assert sched.device_health.state == "open"
    assert len(sched.queue) == 8 and not sched.results
    assert sched._dev_snapshot.resident(("requested",)) is None


def test_pipelined_fence_fault_requeues_both_batches():
    """Under pipeline_commit, a persistent fault at batch k's fence
    requeues batch k and the popped batch k+1 alike."""
    sched = _small_scheduler()
    for i in range(16):
        sched.queue.add(loop.pending_pod(i))
    assert sched.run_once(timeout=0.0) == 0 and sched.pipeline_pending
    inj = faults.FaultInjector()
    inj.arm(faults.SITE_FENCE, kind=faults.FAULT_PERSISTENT, count=1)
    remove = faults.install_injector(inj)
    try:
        with pytest.raises(faults.PersistentDeviceError):
            sched.run_once(timeout=0.0)
    finally:
        remove()
    assert len(sched.queue) == 16 and not sched.pipeline_pending


@pytest.mark.parametrize("field,value,item", [
    ("cpu_fallback", True, "A5"),
    ("heartbeat_s", 1.0, "A9"),
    ("attribution", True, "A9"),
    ("decision_ledger", True, "A9"),
    ("capacity_planner", True, "A10"),
    ("replicas", 2, "A10"),
    ("shard_devices", 2, "A11"),
    ("mesh_shape", "2x4", "A11"),
    ("express_lane", True, "A12"),
    ("adaptive_batch", True, "A12"),
    ("prewarm_widths", True, "A12"),
    ("compile_cache_dir", "/tmp/cache", "A12"),
])
def test_refuses_later_slice_settings(field, value, item):
    """Settings of a later slice raise, naming their ROADMAP item.  A10's
    (the capacity planner, replicas) are lifted: the Scheduler accepts
    them on the CPU and places a cycle (with the planner, its first solve
    lands)."""
    if item != "A10":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            _small_scheduler(**{field: value})
        return
    with process_state_kept():
        sched = _small_scheduler(**{field: value},
                                 capacity_interval_cycles=1)
        for i in range(8):
            sched.queue.add(loop.pending_pod(i))
        sched.run_once(timeout=0.0)
        assert sched.flush_pipeline() == 8
        if field == "capacity_planner":
            sched.capacity.finalize()
            summary = sched.capacity.summary()
            assert summary["solves"] == 1 and summary["solves_dropped"] == 0
        else:
            assert sched.config.replicas == 2 and sched._replica_of == 1


@pytest.mark.parametrize("field,value,item", [
    ("telemetry", True, "A9"),
    ("timeline", True, "A9"),
    ("megacycle_batches", 4, "A7"),
])
def test_lifted_settings_construct_and_schedule(field, value, item):
    """Settings a later slice lifted (ROADMAP `item`): the Scheduler
    constructs with them on the CPU and places a cycle (with
    megacycle_batches, two 8-pod windows in one megacycle)."""
    from kubernetes_tpu_torch.runtime import telemetry, timeline

    sched = _small_scheduler(**{field: value})
    n = 16 if field == "megacycle_batches" else 8
    try:
        for i in range(n):
            sched.queue.add(loop.pending_pod(i))
        sched.run_once(timeout=0.0)
        assert sched.flush_pipeline() == n
        if field == "telemetry":
            assert sched.telemetry.summary()["samples"] == 1
        elif field == "timeline":
            assert sched.timeline.samples_total >= 1
        else:
            assert sched.megacycles_total == 1
            assert [r.pod.name for r in sched.results] == [
                loop.pending_pod(i).name for i in range(n)]
    finally:
        telemetry._DEFAULT.reset()
        timeline._DEFAULT.reset()


def test_refuses_framework_extenders_and_default_config():
    """Framework plugins stay refused (ROADMAP A8; extenders are lifted:
    test_extender_stub_places_a_cycle, tests/test_torch_extender.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        Scheduler(config=loop.live_config(8), framework=object(),
                  device="cpu")
    # the JAX class's default that belongs to a later slice (quality_top_k=3
    # is ported: tests/test_torch_quality.py; telemetry and the timeline:
    # tests/test_torch_telemetry.py, tests/test_torch_timeline.py)
    assert {w for w, _ in refused_settings(SchedulerConfig())} == {
        "cpu_fallback=True"}
    assert refused_settings(loop.live_config(8)) == []


def test_extender_stub_places_a_cycle():
    """A filter/prioritize extender (lifted with the extender slice,
    ROADMAP A8): the Scheduler constructs with one on the CPU and places a
    cycle through it, every pod on the one node the stub approves."""
    from kubernetes_tpu_torch.extender.client import (
        ExtenderConfig,
        HTTPExtender,
    )

    calls = []

    def transport(url, payload, timeout):
        verb = url.rsplit("/", 1)[1]
        calls.append(verb)
        if verb == "filter":
            return {"nodenames": ["node-4"], "failedNodes": {}, "error": ""}
        return [{"host": n, "score": 1} for n in payload["nodenames"]]

    ext = HTTPExtender(ExtenderConfig(
        url_prefix="http://stub", filter_verb="filter",
        prioritize_verb="prioritize", node_cache_capable=True),
        transport=transport)
    cache = SchedulerCache(loop.build_encoder(loop.bench_nodes(16)))
    sched = Scheduler(cache=cache, queue=PriorityQueue(),
                      config=loop.live_config(8), extenders=[ext],
                      device="cpu")
    for i in range(8):
        sched.queue.add(loop.pending_pod(i))
    sched.run_once(timeout=0.0)
    sched.flush_pipeline()
    assert [r.node for r in sched.results] == ["node-4"] * 8
    assert calls.count("filter") == 8 and calls.count("prioritize") == 8


def test_cuda_device_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(config=loop.live_config(8))


def test_gang_pods_are_refused_and_requeued():
    sched = _small_scheduler()
    pod = loop.pending_pod(0)
    pod.metadata.labels[Scheduler.POD_GROUP_LABEL] = "g"
    sched.queue.add(pod)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        sched.run_once(timeout=0.0)
    assert len(sched.queue) == 1


@pytest.mark.parametrize("nominated", [0, 256])
def test_live_golden_files(nominated):
    """The full-width goldens chip_smoke.py phases 11 and 12 read: every
    pod (warmup included) bound once, in a recorded order."""
    path = live_golden_path(nominated)
    data = np.load(path)
    hosts, order = data["hosts"], data["bind_order"]
    assert hosts.dtype == np.int32 and hosts.shape == (12048,)
    assert int(data["nodes"]) == 5000 and int(data["batch"]) == 2048
    assert int(data["pods"]) == 10000
    assert int(data["nominated"]) == nominated
    assert (hosts >= 0).all() and hosts.max() < 5000
    assert sorted(order.tolist()) == list(range(12048))
    assert data["unschedulable"].size == 0
    if nominated:
        # the timed pods (the warmup ran before the nominations)
        rows = {(19 * j) % 5000 for j in range(nominated)}
        assert not rows & set(hosts[:10000].tolist())
    assert os.path.getsize(path) < 1 << 20
