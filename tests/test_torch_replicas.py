"""The replica slice of the port against the JAX package, on CPU.

  * K10's plain twin (runtime/reconciler.py admit_scan_plain) against the
    jitted JAX ConflictReconciler._kernel on every case of
    kernels/k10_cases.py, bit for bit;
  * the reconciler's edge matrix on both packages' replica sets, built
    alike (mirroring tests/test_replicas.py): the zero-conflict fast path
    (no scan runs), the all-N conflict (exactly the sequenced winner
    admits), the DRF tiebreak, the quota veto and the stale-fence requeue
    of a pod carrying host ports — the winners, race losers, quota losers,
    commit sequence numbers and queue states equal;
  * the hub's fence: a dispatch after a sibling's commit refreshes the
    shared resident snapshot to the new generation, and a cycle whose
    generation went stale takes the scan, never the fast path;
  * a threaded port SchedulerReplicaSet draining a multi-tenant burst
    with clean invariants, the /debug/replicas roll-up, and the refusals.
K10 runs only on the card: chip_smoke.py holds it against its twin on the
same cases and replays phase 22's scans through the twin.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import factory as jfactory
from kubernetes_tpu.codec.encoder import SnapshotEncoder as JaxEncoder
from kubernetes_tpu.codec.schema import PadDims as JaxDims
from kubernetes_tpu.runtime.cache import SchedulerCache as JaxCache
from kubernetes_tpu.runtime.queue import PriorityQueue as JaxQueue
from kubernetes_tpu.runtime.reconciler import ConflictReconciler as JaxRecon
from kubernetes_tpu.runtime.replicas import SchedulerReplicaSet as JaxSet
from kubernetes_tpu.runtime.scheduler import SchedulerConfig as JaxConfig
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api import factory as tfactory
from kubernetes_tpu_torch.codec.encoder import SnapshotEncoder
from kubernetes_tpu_torch.codec.schema import PadDims
from kubernetes_tpu_torch.kernels import k10_cases
from kubernetes_tpu_torch.runtime import reconciler as trec
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PriorityQueue
from kubernetes_tpu_torch.runtime.replicas import SchedulerReplicaSet
from kubernetes_tpu_torch.runtime.scheduler import (
    Scheduler,
    SchedulerConfig,
)

from torch_port_helpers import process_state_kept

K10_CASES = dict(k10_cases.cases())
K10_KEYS = ("u_node", "u_ns", "order", "reqs", "node_head", "ns_head")


@pytest.fixture(autouse=True)
def _kept():
    with process_state_kept():
        yield


# ------------------------------------------------------------------ K10


@pytest.mark.parametrize("name", list(K10_CASES))
def test_admit_scan_twin_matches_jax(name):
    c = K10_CASES[name]
    bp, r = c["reqs"].shape
    want = JaxRecon()._kernel(bp, r)(c["u_node"], c["u_ns"], c["reqs"],
                                     c["node_head"], c["ns_head"],
                                     c["order"])
    got = trec.admit_scan_plain(*(torch.from_numpy(c[k]) for k in K10_KEYS))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name


def test_k10_wrapper_refuses_cpu_tensors():
    c = K10_CASES["bp1"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.reconcile_admit(*(torch.from_numpy(c[k]) for k in K10_KEYS))


@pytest.mark.cuda
def test_k10_matches_plain_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K10 has no CPU mode")
    for name, c in K10_CASES.items():
        args = [torch.from_numpy(c[k]).cuda() for k in K10_KEYS]
        got = kernels.reconcile_admit(*args)
        want = trec.admit_scan_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


# ------------------------------------------------- the two packages


JAX = SimpleNamespace(
    name="jax", Encoder=JaxEncoder, dims=JaxDims(N=16, B=16, TP=32),
    Cache=JaxCache, Queue=JaxQueue, Set=JaxSet, Config=JaxConfig,
    make_node=jfactory.make_node, make_pod=jfactory.make_pod, kw={})
PORT = SimpleNamespace(
    name="port", Encoder=SnapshotEncoder, dims=PadDims(N=16, B=16, TP=32),
    Cache=SchedulerCache, Queue=PriorityQueue, Set=SchedulerReplicaSet,
    Config=SchedulerConfig, make_node=tfactory.make_node,
    make_pod=tfactory.make_pod, kw={"device": "cpu"})


def _replica_set(pkg, n=2, nodes=4, cpu="8", **cfg_kw):
    """tests/test_replicas.py's replica set, in either package."""
    cfg = dict(batch_size=8, batch_window_s=0.0, engine="sequential",
               disable_preemption=True, telemetry=True, quality_top_k=0,
               cpu_fallback=False)
    cfg.update(cfg_kw)
    rs = pkg.Set(replicas=n, cache=pkg.Cache(pkg.Encoder(pkg.dims)),
                 config=pkg.Config(**cfg), **pkg.kw)
    for i in range(nodes):
        rs.cache.add_node(pkg.make_node(f"n{i}", cpu=cpu, mem="32Gi"))
    return rs


def _drive(rs, rounds=40):
    for _ in range(rounds):
        for s in rs.schedulers:
            s.run_once(timeout=0.0)
        if not rs.queue.has_schedulable() and not any(
                s.pipeline_pending for s in rs.schedulers):
            break
    for s in rs.schedulers:
        s.flush_pipeline()


def _lists(st):
    return ([w[1].name for w in st.winners],
            [p.name for _, p in st.race_lost],
            [p.name for _, p in st.quota_lost])


def _both(scenario):
    """scenario(pkg) on both packages; returns (jax result, port result)."""
    return scenario(JAX), scenario(PORT)


def test_fast_path_runs_no_scan():
    def scenario(pkg):
        rs = _replica_set(pkg)
        for i in range(4):
            rs.queue.add(pkg.make_pod(f"p{i}", cpu="100m"))
        _drive(rs)
        st = rs.reconciler.stats()
        return rs.placed_total, st["scans_total"], st["kernel_calls"], \
            st["fast_path_total"] >= 1
    jres, tres = _both(scenario)
    assert tres == jres == (4, 0, 0, True)


def test_all_n_conflict_admits_the_sequenced_winner():
    def scenario(pkg):
        rs = _replica_set(pkg, n=3, nodes=1, cpu="4")
        pods = [pkg.make_pod(f"c{i}", cpu="3", namespace=f"t{i}")
                for i in range(3)]
        infs = [s._encode_and_dispatch([p])
                for s, p in zip(rs.schedulers, pods)]
        gens = {inf.generation for inf in infs}
        staged = [s._commit_state(inf)
                  for s, inf in zip(rs.schedulers, infs)]
        lists = [_lists(st) for st in staged]
        for s, st in zip(rs.schedulers, staged):
            s._commit_tail(st)
        return (len(gens), lists, len(rs.queue),
                rs.reconciler.conflicts_total,
                [inf.commit_seq for inf in infs],
                rs.invariant_violations_total())
    jres, tres = _both(scenario)
    assert tres == jres
    assert tres[1] == [(["c0"], [], []), ([], ["c1"], []), ([], ["c2"], [])]


def test_drf_tiebreak_prefers_smaller_dominant_share():
    def scenario(pkg):
        rs = _replica_set(pkg, n=2, nodes=1, cpu="8")
        r0 = rs.schedulers[0]
        rs.cache.add_pod(pkg.make_pod("seed", cpu="2", namespace="hog",
                                      node_name="n0"))
        inf = r0._encode_and_dispatch([
            pkg.make_pod("hog-pod", cpu="3", namespace="hog"),
            pkg.make_pod("tiny-pod", cpu="3", namespace="tiny")])
        rs.cache.add_pod(pkg.make_pod("bump", cpu="1500m", namespace="zz",
                                      node_name="n0"))
        st = r0._commit_state(inf)
        lists = _lists(st)
        r0._commit_tail(st)
        return lists, rs.reconciler.stats()["scans_total"]
    jres, tres = _both(scenario)
    assert tres == jres == ((["tiny-pod"], ["hog-pod"], []), 1)


def test_quota_veto_parks_unschedulable():
    def scenario(pkg):
        rs = _replica_set(pkg, n=2, nodes=2, cpu="8",
                          namespace_quotas={"capped": {"cpu": "1"}})
        r0 = rs.schedulers[0]
        inf = r0._encode_and_dispatch([
            pkg.make_pod("q1", cpu="900m", namespace="capped"),
            pkg.make_pod("q2", cpu="900m", namespace="capped"),
            pkg.make_pod("free", cpu="900m", namespace="open")])
        st = r0._commit_state(inf)
        lists = _lists(st)
        r0._commit_tail(st)
        evs = [e.name for e in r0.recorder.events()
               if e.reason == "QuotaExceeded"]
        return (sorted(lists[0]), lists[1], lists[2], len(rs.queue),
                rs.queue.active_depth(), rs.reconciler.quota_vetoes_total,
                evs)
    jres, tres = _both(scenario)
    assert tres == jres == (["free", "q1"], [], ["q2"], 1, 0, 1, ["q2"])


def test_stale_fence_requeues_a_port_carrying_winner():
    def scenario(pkg):
        rs = _replica_set(pkg, n=2, nodes=2, cpu="8")
        r0 = rs.schedulers[0]
        porty = pkg.make_pod("porty", cpu="100m", ports=[
            {"containerPort": 80, "hostPort": 8080}])
        inf = r0._encode_and_dispatch(
            [porty, pkg.make_pod("lean", cpu="100m", namespace="t2")])
        rs.cache.add_pod(pkg.make_pod("bump", cpu="100m", namespace="zz",
                                      node_name="n0"))
        st = r0._commit_state(inf)
        lists = _lists(st)
        r0._commit_tail(st)
        shard = pkg.Queue.shard_of(porty, 2)
        got = rs.queue.pop_batch(4, 0.0, 0.0, shard=shard, of=2)
        repl = rs.schedulers[shard]
        inf2 = repl._encode_and_dispatch(got)
        st2 = repl._commit_state(inf2)
        lists2 = _lists(st2)
        repl._commit_tail(st2)
        stats = rs.reconciler.stats()
        return (lists, [p.name for p in got], lists2,
                stats["strict_requeues_total"], stats["scans_total"],
                rs.invariant_violations_total())
    jres, tres = _both(scenario)
    assert tres == jres
    assert tres[:3] == ((["lean"], ["porty"], []), ["porty"],
                        (["porty"], [], []))


# ---------------------------------------------------------- the hub


def test_hub_fence_refreshes_and_stale_cycles_scan():
    """Replica 1 dispatches after replica 0's commit: the hub refreshes the
    shared resident snapshot to the new generation (its requested rows
    equal the host's), and the cycle, committed next, takes the fast path.
    A cycle dispatched before a sibling's commit carries the old
    generation and takes the scan, never the fast path."""
    rs = _replica_set(PORT, n=2, nodes=2, cpu="8")
    r0, r1 = rs.schedulers
    inf0 = r0._encode_and_dispatch([tfactory.make_pod("a", cpu="1")])
    stale = r1._encode_and_dispatch([tfactory.make_pod("b", cpu="1",
                                                       namespace="t1")])
    assert inf0.generation == stale.generation
    r0._commit_tail(r0._commit_state(inf0))
    refreshes = rs.hub.refreshes
    fresh = r1._encode_and_dispatch([tfactory.make_pod("c", cpu="1",
                                                       namespace="t2")])
    assert rs.hub.refreshes == refreshes + 1
    assert fresh.generation == rs.cache.generation == rs.hub.generation
    host, _ = rs.cache.snapshot()
    dev = rs.hub.resident(("requested",))[0]
    assert np.array_equal(dev.numpy(), np.asarray(host.requested))
    fast0, scans0 = rs.reconciler.fast_path_total, rs.reconciler.scans_total
    r1._commit_tail(r1._commit_state(fresh))
    assert rs.reconciler.fast_path_total == fast0 + 1
    st = r1._commit_state(stale)                 # siblings committed since
    assert rs.reconciler.scans_total == scans0 + 1
    assert rs.reconciler.fast_path_total == fast0 + 1
    assert [w[1].name for w in st.winners] == ["b"]
    r1._commit_tail(st)
    assert rs.reconciler.kernel_calls == rs.reconciler.scans_total
    assert rs.invariant_violations_total() == 0


def test_hub_launch_holds_the_refresh_out():
    """A hub launch runs the engine's enqueue under the hub's lock: a
    sibling's refresh (the in-place scatter) cannot interleave."""
    import threading

    rs = _replica_set(PORT, n=2, nodes=2, cpu="8")
    order = []
    inside = threading.Event()
    release = threading.Event()

    def slow(dev):
        inside.set()
        release.wait(5)
        order.append("launch")
        return dev

    t = threading.Thread(target=lambda: rs.hub.launch(slow))
    t.start()
    assert inside.wait(5)
    rs.cache.add_pod(tfactory.make_pod("x", cpu="1", node_name="n0"))
    t2 = threading.Thread(
        target=lambda: (rs.hub.refresh(), order.append("refresh")))
    t2.start()
    t2.join(0.2)
    assert order == []
    release.set()
    t.join(5)
    t2.join(5)
    assert order == ["launch", "refresh"]


# ------------------------------------------------ threads and roll-up


def test_threaded_replicas_drain_a_tenant_burst_clean():
    """Three replica threads, the interpreter switching threads every
    10 us: every pod placed or parked by its tenant's quota, exactly,
    with a clean invariant checker (a lost update would break the
    counts)."""
    import sys

    rs = _replica_set(PORT, n=3, nodes=8, cpu="16", batch_size=16,
                      namespace_quotas={"tenant3": {"cpu": "500m"}})
    offered = 120
    for i in range(offered):
        rs.queue.add(tfactory.make_pod(f"s{i}", cpu="50m",
                                       namespace=f"tenant{i % 4}",
                                       priority=i % 3))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = []
    try:
        rs.run_until_drained(budget_s=60)
        threads = list(rs._threads)
    finally:
        rs.stop()
        sys.setswitchinterval(switch)
    assert len(threads) == 3 and not any(t.is_alive() for t in threads)
    placed, left = rs.placed_total, len(rs.queue)
    assert placed + left + rs.queue.shed_total == offered
    assert left == 30 - 10                   # tenant3's quota: 10 pods
    assert rs.reconciler.quota_vetoes_total == left
    assert rs.invariant_violations_total() == 0 and rs.assert_drained()
    per = {}
    for s in rs.schedulers:
        for r in s.results:
            if r.node is not None:
                per[r.pod.namespace] = per.get(r.pod.namespace, 0) + 1
    assert per == {"tenant0": 30, "tenant1": 30, "tenant2": 30,
                   "tenant3": 10}
    body = trec.debug_payload()
    assert body["replicas"] == 3
    assert body["reconciler"]["quota_vetoes_total"] == left
    assert body["tenants"]["tenant3"]["quota"][0] == 500.0
    rs.close()


def test_replica_set_refusals():
    with pytest.raises(ValueError, match="batched_commit"):
        _replica_set(PORT, batched_commit=False)
    nodes_cache = SchedulerCache(SnapshotEncoder(PORT.dims))
    with pytest.raises(ValueError, match="batched_commit"):
        Scheduler(cache=nodes_cache, reconciler=trec.ConflictReconciler(),
                  config=SchedulerConfig(batched_commit=False,
                                         cpu_fallback=False),
                  device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        _replica_set(PORT, shard_devices=2)
