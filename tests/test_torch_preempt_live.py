"""Preemption through the live Scheduler: the port against the JAX
Scheduler, on CPU, event for event.

Both schedulers take the same events (nodes and running pods added,
preemptors queued or preempted directly, cycles run), each with its own
cache and queue, the JAX one with disable_preemption=False, cpu_fallback=
False and the observatories off.  The binder's calls, the victims deleted,
the `preemptions` list and the nominated-pod map must be equal.  Covered:
tests/test_preempt_e2e.py's scenarios (FitError -> preempt -> nominate ->
bind, the disable gate, the nominated claim held against a cheaper pod,
the PDB choice, the host-side anti-affinity veto through
verify_nomination, nominated host-port and anti-affinity claims, both
engines), KTPU_PREEMPT_VERIFY=always, and chip_smoke.py's live preemption
cell at 64 nodes through loop.run_preemption against the golden maker's
jax_preemption.  A device fault inside the candidate evaluation is
classified, reaches the breaker and propagates, with no CPU fallback; a
preempt-verb extender is refused.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from kubernetes_tpu.api import factory as jax_factory
from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.runtime import cache as jax_cache
from kubernetes_tpu.runtime import queue as jax_queue
from kubernetes_tpu.runtime import scheduler as jax_sched
from kubernetes_tpu_torch import loop
from kubernetes_tpu_torch.api import factory as port_factory
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.codec import faults
from kubernetes_tpu_torch.runtime import cache as port_cache
from kubernetes_tpu_torch.runtime import queue as port_queue
from kubernetes_tpu_torch.runtime import scheduler as port_sched

from make_torch_golden import golden_path, jax_preemption, live_golden_path

ZONE = "failure-domain.beta.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
PKGS = {
    "jax": (jax_factory, jax_types, jax_cache, jax_queue, jax_sched),
    "port": (port_factory, port_types, port_cache, port_queue, port_sched),
}


def _world(pkg, engine="sequential", disable=False, pdbs=None):
    f, t, c, q, s = PKGS[pkg]
    w = SimpleNamespace(bound=[], deleted=[], f=f, t=t)
    w.cache = c.SchedulerCache()
    w.queue = q.PriorityQueue(backoff=q.PodBackoff(initial=0.01,
                                                   max_duration=0.05))
    cfg = s.SchedulerConfig(engine=engine, disable_preemption=disable,
                            cpu_fallback=False, telemetry=False,
                            quality_top_k=0, timeline=False)
    kw = {"device": "cpu"} if pkg == "port" else {}
    w.sched = s.Scheduler(
        cache=w.cache, queue=w.queue,
        binder=lambda pod, node: w.bound.append((pod.name, node)) or True,
        config=cfg,
        victim_deleter=lambda pod: (w.deleted.append(pod.name)
                                    or w.cache.remove_pod(pod)),
        pdb_lister=(lambda: pdbs(w)) if pdbs else None, **kw)
    return w


def _drain(w, cycles=4, settle=0.06):
    for _ in range(cycles):
        w.sched.run_once(timeout=0.05)
        time.sleep(settle)  # let backoff expire


def _state(w):
    return (w.bound, w.deleted, w.sched.preemptions,
            sorted((p.name, n) for p, n in w.queue.nominated_pods()))


def _anti(app, key):
    return {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": app}},
            "topologyKey": key}]}}


def _end_to_end(w):
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n("n1", cpu="1", mem="4Gi"))
    w.cache.add_node(n("n2", cpu="1", mem="4Gi"))
    w.cache.add_pod(p("low-a", cpu="600m", node_name="n1", priority=1))
    w.cache.add_pod(p("low-b", cpu="600m", node_name="n2", priority=2))
    w.queue.add(p("boss", cpu="800m", priority=100))
    _drain(w)
    return {"deleted": ["low-a"], "bound": [("boss", "n1")]}


def _claim_protected(w):
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n("n1", cpu="1", mem="4Gi"))
    w.cache.add_pod(p("low", cpu="900m", node_name="n1", priority=1))
    boss = p("boss", cpu="800m", priority=100)
    w.nominated = w.sched.preempt(boss)
    w.queue.add(p("cheeky", cpu="800m", priority=0))
    w.sched.run_once(timeout=0.05)
    w.queue.add(boss)
    w.sched.run_once(timeout=0.05)
    return {"deleted": ["low"], "bound": [("boss", "n1")]}


def _pdb_choice(w):
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n("n1", cpu="1", mem="4Gi"))
    w.cache.add_node(n("n2", cpu="1", mem="4Gi"))
    w.cache.add_pod(p("prot", cpu="900m", node_name="n1", priority=1,
                      labels={"app": "guarded"}))
    w.cache.add_pod(p("plain", cpu="900m", node_name="n2", priority=5))
    w.nominated = w.sched.preempt(p("boss", cpu="800m", priority=100))
    return {"deleted": ["plain"], "bound": []}


def _anti_affinity_veto(w):
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n("n1", cpu="1", mem="4Gi", labels={ZONE: "z1"}))
    w.cache.add_node(n("n2", cpu="1", mem="4Gi", labels={ZONE: "z1"}))
    w.cache.add_pod(p("low", cpu="900m", node_name="n1", priority=1))
    w.cache.add_pod(p("guard", cpu="100m", node_name="n2", priority=1000,
                      affinity=_anti("boss", ZONE)))
    w.nominated = w.sched.preempt(
        p("boss", cpu="800m", priority=100, labels={"app": "boss"}))
    return {"deleted": [], "bound": []}


def _nominated_host_port(w):
    n, p = w.f.make_node, w.f.make_pod
    port = [{"hostPort": 8080, "protocol": "TCP"}]
    w.cache.add_node(n("nx", cpu="2", mem="4Gi"))
    w.cache.add_node(n("ny", cpu="2", mem="4Gi"))
    boss = p("boss", cpu="100m", priority=100, ports=port)
    boss.status.nominated_node_name = "nx"
    w.queue.update_nominated_pod(boss, "nx")
    w.queue.add(p("worker", cpu="100m", priority=1, ports=port))
    _drain(w, cycles=2)
    return {"deleted": [], "bound": [("worker", "ny")]}


def _nominated_anti_affinity(w):
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n("za1", cpu="2", mem="4Gi", labels={"zone": "a"}))
    w.cache.add_node(n("zb1", cpu="2", mem="4Gi", labels={"zone": "b"}))
    guard = p("guard", cpu="100m", priority=50, labels={"app": "guard"},
              affinity=_anti("web", "zone"))
    guard.status.nominated_node_name = "za1"
    w.queue.update_nominated_pod(guard, "za1")
    w.queue.add(p("web", cpu="100m", priority=1, labels={"app": "web"}))
    _drain(w, cycles=2)
    return {"deleted": [], "bound": [("web", "zb1")]}


def _waiter_and_sneak(w):
    """The speculative scenario: boss preempts and binds, then a waiting
    preemptor's claim on n2 keeps a cheaper pod off it."""
    want = _end_to_end(w)
    p = w.f.make_pod
    w.queue.update_nominated_pod(p("waiter", cpu="900m", priority=100), "n2")
    w.cache.remove_pod(p("low-b", cpu="600m", node_name="n2", priority=2))
    w.queue.add(p("sneak", cpu="900m", priority=0))
    _drain(w, cycles=3)
    assert ("sneak", "n2") not in w.bound
    return want


def _aff(selector, key):
    return {"podAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": selector},
            "topologyKey": key}]}}


def _batch_node(w, name, batch_pods, zone="z1"):
    """A 2-CPU node full: `batch_pods` batch pods (app: batch, priority 0,
    500m) and a production pod (priority 1,000) taking the rest."""
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n(name, cpu="2", mem="8Gi", labels={ZONE: zone}))
    for i in range(batch_pods):
        w.cache.add_pod(p(f"{name}-batch-{i}", cpu="500m", node_name=name,
                          priority=0, labels={"app": "batch"}))
    w.cache.add_pod(p(f"{name}-prod", cpu=f"{2000 - 500 * batch_pods}m",
                      node_name=name, priority=1000, labels={"team": "east"}
                      if zone == "z2" else None))


def _plain_node(w, name, zone):
    """A 2-CPU node full of one low-priority pod with no label."""
    n, p = w.f.make_node, w.f.make_pod
    w.cache.add_node(n(name, cpu="2", mem="8Gi", labels={ZONE: zone}))
    w.cache.add_pod(p(f"{name}-low", cpu="2", node_name=name, priority=1))


def _affinity_host(w):
    """Kind a: hostname affinity to a batch pod.  The what-if picks n0
    first (its two victims tie n1's, the lower row wins), which would
    lose both its batch pods, so the verify vetoes it; n1 keeps one."""
    p = w.f.make_pod
    _batch_node(w, "n0", 2)
    _batch_node(w, "n1", 3)
    _plain_node(w, "n2", "z1")
    w.nominated = w.sched.preempt(p("boss", cpu="1", priority=100,
                                    affinity=_aff({"app": "batch"}, HOST)))
    return {"deleted": ["n1-batch-1", "n1-batch-2"], "bound": []}


def _affinity_host_veto(w):
    """Kind a where every candidate's pick loses its last batch pod: the
    verify vetoes the only candidate and nothing is preempted."""
    p = w.f.make_pod
    _batch_node(w, "n0", 2)
    _plain_node(w, "n1", "z1")
    w.queue.add(p("boss", cpu="1", priority=100,
                  affinity=_aff({"app": "batch"}, HOST)))
    _drain(w, cycles=2)
    return {"deleted": [], "bound": []}


def _affinity_zone(w):
    """Kind b: zone affinity to a team: east pod, which only zone z2
    holds: the first node (z1) is no candidate."""
    p = w.f.make_pod
    _plain_node(w, "n0", "z1")
    _batch_node(w, "n1", 2, zone="z2")
    _plain_node(w, "n2", "z2")
    w.queue.add(p("boss", cpu="1", priority=100,
                  affinity=_aff({"team": "east"}, ZONE)))
    _drain(w)
    return {"deleted": ["n1-batch-0", "n1-batch-1"], "bound": [("boss",
                                                                "n1")]}


def _affinity_bootstrap(w):
    """Kind c: zone affinity to the pod's own label, which no running pod
    carries: both preemptors take the bootstrap rule in the first cycle
    (n0 in z1, n1 in z2); once the first is bound on n0, the second
    follows it into z1, to the room n0 has left."""
    p = w.f.make_pod
    for i, zone in enumerate(("z1", "z2", "z1", "z2")):
        _plain_node(w, f"n{i}", zone)
    for name in ("fresh-0", "fresh-1"):
        w.queue.add(p(name, cpu="1", priority=100, labels={"app": "fresh"},
                      affinity=_aff({"app": "fresh"}, ZONE)))
    _drain(w, cycles=6)
    return {"deleted": ["n0-low", "n1-low"],
            "bound": [("fresh-0", "n0"), ("fresh-1", "n0")]}


def _affinity_missing_key(w):
    """Kind d: a self-matching term on a topology key no node carries: no
    node is a candidate, nothing is preempted or nominated."""
    p = w.f.make_pod
    _batch_node(w, "n0", 3)
    _plain_node(w, "n1", "z1")
    w.nominated = w.sched.preempt(p(
        "boss", cpu="1", priority=100, labels={"app": "boss"},
        affinity=_aff({"app": "boss"}, "example.com/no-such-domain")))
    return {"deleted": [], "bound": []}


SCENARIOS = {
    "affinity-host": _affinity_host,
    "affinity-host-veto": _affinity_host_veto,
    "affinity-zone": _affinity_zone,
    "affinity-bootstrap": _affinity_bootstrap,
    "affinity-missing-key": _affinity_missing_key,
    "end-to-end": _end_to_end,
    "claim-protected": _claim_protected,
    "pdb-choice": _pdb_choice,
    "anti-affinity-veto": _anti_affinity_veto,
    "nominated-host-port": _nominated_host_port,
    "nominated-anti-affinity": _nominated_anti_affinity,
    "waiter-and-sneak": _waiter_and_sneak,
}


def _guard_pdb(w):
    return [w.t.PodDisruptionBudget(
        metadata=w.t.ObjectMeta(name="guard", namespace="default"),
        selector={"matchLabels": {"app": "guarded"}},
        disruptions_allowed=0)]


def _both(which, engine, verify=False, monkeypatch=None):
    if verify:
        monkeypatch.setenv("KTPU_PREEMPT_VERIFY", "always")
    pdbs = _guard_pdb if which == "pdb-choice" else None
    out = {}
    for pkg in ("jax", "port"):
        w = _world(pkg, engine, pdbs=pdbs)
        want = SCENARIOS[which](w)
        out[pkg] = (w, want)
    return out


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
@pytest.mark.parametrize("which", sorted(SCENARIOS))
def test_scenarios_match_jax_scheduler(which, engine):
    out = _both(which, engine)
    (jw, _), (pw, want) = out["jax"], out["port"]
    assert _state(pw) == _state(jw)
    assert getattr(pw, "nominated", None) == getattr(jw, "nominated", None)
    assert pw.deleted == want["deleted"]
    for b in want["bound"]:
        assert b in pw.bound
    if which == "claim-protected":
        assert pw.nominated == "n1" and ("cheeky", "n1") not in pw.bound
        assert pw.queue.nominated_pods() == []
    if which in ("anti-affinity-veto", "affinity-missing-key",
                 "affinity-host-veto"):
        assert getattr(pw, "nominated", None) is None
        assert pw.sched.preemptions == []
    if which.startswith("affinity-") and which != "affinity-missing-key":
        # the what-if cannot see the affinity terms: every pick is verified
        assert pw.sched.preempt_seconds["verify"] > 0
    if which == "affinity-host":
        assert pw.nominated == "n1"


@pytest.mark.parametrize("which", ["end-to-end", "pdb-choice",
                                   "anti-affinity-veto"])
def test_verify_always_matches_jax_scheduler(which, monkeypatch):
    """KTPU_PREEMPT_VERIFY=always: verify_nomination (the port's cpuref
    copy) runs on every pick, in both packages alike."""
    out = _both(which, "sequential", verify=True, monkeypatch=monkeypatch)
    assert _state(out["port"][0]) == _state(out["jax"][0])
    assert out["port"][0].sched.preempt_seconds["verify"] > 0 or \
        not out["port"][0].sched.preemptions


def test_disable_preemption_is_not_a_noop():
    for pkg in ("jax", "port"):
        w = _world(pkg, disable=True)
        w.cache.add_node(w.f.make_node("n1", cpu="1", mem="4Gi"))
        w.cache.add_pod(w.f.make_pod("low", cpu="900m", node_name="n1",
                                     priority=1))
        w.queue.add(w.f.make_pod("boss", cpu="800m", priority=100))
        _drain(w, cycles=2)
        assert (w.deleted, w.bound, w.sched.preemptions) == ([], [], [])
        assert w.sched.preempt(w.f.make_pod("x", priority=9)) is None


@pytest.mark.parametrize("n_nodes,k", [(64, 5), (120, 9)])
def test_live_preemption_cell_matches_jax(n_nodes, k):
    """chip_smoke.py's live preemption cell, cut to n_nodes: every node
    full, batch nodes every 20th row (the first tainted), k preemptors at
    1.5 CPU.  Preemptions in order, bindings in call order, unschedulable
    verdicts and the requested columns equal the JAX Scheduler's."""
    jpre, jbind, junsched, jreq, _ = jax_preemption(n_nodes, k, 2048)
    nodes = loop.preemption_fleet(n_nodes)
    res = loop.run_preemption(nodes, loop.preemption_running_pods(nodes),
                              loop.preemptors(k), 2048, device="cpu")
    assert res["preemptions"] == jpre
    assert res["bindings"] == jbind
    assert res["unschedulable_pods"] == junsched
    np.testing.assert_array_equal(res["requested"], jreq)
    usable = len([i for i in range(0, n_nodes, loop.BATCH_NODE_EVERY)
                  if i % 50])
    assert len(jpre) == min(k, usable) and len(jbind) == len(jpre)
    assert all(len(v) == 3 for _, _, v in jpre)
    # every preemptor's node ends at exactly its 4 CPU
    rows = {name: row for row, name in res["node_names"].items()}
    cpu = res["requested"][:, 0]
    assert all(cpu[rows[node]] == 4000.0 for _, node in jbind)
    assert res["attempts"] == k + (k - len(jpre))
    assert res["phases"]["preempt"] > 0


def _small_scheduler():
    nodes = loop.preemption_fleet(24)
    enc = loop.build_encoder(nodes)
    enc.add_pods(loop.preemption_running_pods(nodes))
    return port_sched.Scheduler(
        cache=port_cache.SchedulerCache(enc),
        queue=port_queue.PriorityQueue(),
        config=loop.live_config(8, preemption=True), device="cpu")


@pytest.mark.parametrize("site", [faults.SITE_SNAPSHOT_UPDATE,
                                  faults.SITE_FETCH])
def test_preempt_device_fault_reaches_breaker_and_propagates(site):
    """No CPU fallback: a persistent fault in the candidate evaluation is
    classified, trips the breaker, drops the resident snapshot and
    propagates; nothing is evicted or nominated."""
    sched = _small_scheduler()
    pod = loop.preemptors(1)[0]
    inj = faults.FaultInjector()
    inj.arm(site, kind=faults.FAULT_PERSISTENT, count=1)
    remove = faults.install_injector(inj)
    try:
        with pytest.raises(faults.PersistentDeviceError):
            sched.preempt(pod)
    finally:
        remove()
    assert [s for s, _ in inj.log] == [site]
    assert sched.device_health.state == "open"
    assert sched.device_health.fault_counts
    assert sched._dev_snapshot.resident(("requested",)) is None
    assert sched.preemptions == [] and not sched.queue.nominated_pods()
    # the next attempt runs clean and nominates
    assert sched.preempt(pod) == "node-20"


def test_accepts_preemption_and_refuses_preempt_verb_extenders():
    """disable_preemption=False (the JAX class's default) is accepted with
    cpu_fallback=False; a preempt-verb extender, refused until the
    extender slice lifted it (ROADMAP A8's extender half), is accepted and
    vets each preemption: one that drops the node vetoes it
    (tests/test_torch_extender.py holds the chain to the JAX Scheduler)."""
    cfg = loop.live_config(8, preemption=True)
    assert not cfg.disable_preemption and not cfg.cpu_fallback
    assert port_sched.refused_settings(cfg) == []
    sched = port_sched.Scheduler(config=cfg, device="cpu")
    assert sched.preemptions == [] and sched._preempt_eval is not None
    ext = SimpleNamespace(
        config=SimpleNamespace(filter_verb="", prioritize_verb=""),
        supports_preemption=True, is_ignorable=False,
        is_interested=lambda pod: True,
        process_preemption=lambda pod, meta: {})
    sched = port_sched.Scheduler(config=cfg, extenders=[ext], device="cpu")
    assert sched.extenders == [ext]
    assert sched._extender_preemption(loop.pending_pod(0), "node-1", [],
                                      None) is None


def test_live_preemption_golden_file():
    """The full-width golden chip_smoke.py phase 13 reads: 200 preemptions
    of 3 batch pods each, on distinct untainted batch nodes; the 200
    preemptors bound, in a recorded order; 312 unschedulable verdicts (256
    in the first cycle, the 56 left over in the second); every node at
    most its 4 CPU."""
    path = live_golden_path(preemption=256)
    data = np.load(path)
    assert int(data["nodes"]) == 5000 and int(data["batch"]) == 2048
    assert int(data["preemptors"]) == 256
    nodes = data["preempt_node"].tolist()
    assert len(nodes) == 200 == len(set(nodes))
    rows = [int(n.split("-")[1]) for n in nodes]
    assert all(r % 20 == 0 and r % 50 for r in rows)
    assert data["victim_count"].tolist() == [3] * 200
    assert all(v.startswith("batch-") for v in data["victims"].tolist())
    assert sorted(data["bound_pod"].tolist()) == sorted(
        data["preemptor"].tolist())
    assert sorted(data["bound_node"].tolist()) == sorted(nodes)
    assert data["unschedulable"].size == 312
    cpu = data["requested_cpu"]
    assert cpu.shape == (6144,) and cpu[:5000].max() == 4000.0
    assert os.path.getsize(path) < 1 << 20


def test_live_preemption_affinity_cell_matches_jax():
    """chip_smoke.py phase 13b's cell cut to 200 nodes (10 batch nodes,
    rows 0 and 100 tainted): the running pods labelled and four
    preemptors of each kind of loop.affinity_preemptors.  Preemptions in
    order, bindings in call order, verdicts and the requested columns
    equal the JAX Scheduler's; picks are verified on the host; kind d
    preempts nothing."""
    jpre, jbind, junsched, jreq, _ = jax_preemption(200, 16, 2048,
                                                    affinity=True)
    nodes = loop.preemption_fleet(200)
    res = loop.run_preemption(
        nodes, loop.preemption_running_pods(nodes, labels=True),
        loop.affinity_preemptors(4), 2048, device="cpu")
    assert res["preemptions"] == jpre
    assert res["bindings"] == jbind
    assert res["unschedulable_pods"] == junsched
    np.testing.assert_array_equal(res["requested"], jreq)
    assert res["preempt_seconds"]["verify"] > 0
    assert jpre and not any("nokey" in p[0][1] for p in jpre)
    assert {n for n in junsched if "nokey" in n} == {
        f"preemptor-nokey-{j}" for j in range(4)}


def test_live_preemption_affinity_golden_file():
    """The full-width golden chip_smoke.py phase 13b reads: preemptions of
    3 batch pods each on untainted batch nodes, none by kind d; every
    bound pod a preemptor; kinds b and c bound in zone 0 (b's team: east
    zones hold batch nodes in zone 0 only; c follows its first pod's
    zone); every kind d pod unschedulable; every node at most its 4
    CPU."""
    path = golden_path("live_preemption_affinity")
    data = np.load(path)
    assert set(data.files) == {
        "preemptor", "preempt_node", "victim_count", "victims", "bound_pod",
        "bound_node", "unschedulable", "requested_cpu", "nodes", "batch",
        "preemptors"}
    assert int(data["nodes"]) == 5000 and int(data["batch"]) == 2048
    assert int(data["preemptors"]) == 16
    names = {p.name for p in loop.affinity_preemptors(4)}
    pre = data["preemptor"].tolist()
    assert pre and set(pre) <= names
    assert not any("nokey" in n for n in pre)
    rows = [int(n.split("-")[1]) for n in data["preempt_node"].tolist()]
    assert all(r % 20 == 0 and r % 50 for r in rows)
    assert set(data["victim_count"].tolist()) == {3}
    assert data["victims"].size == 3 * len(pre)
    assert all(v.startswith("batch-") for v in data["victims"].tolist())
    bound = dict(zip(data["bound_pod"].tolist(),
                     data["bound_node"].tolist()))
    assert bound and set(bound) <= names
    for name, node in bound.items():
        if "east" in name or "fresh" in name:
            assert int(node.split("-")[1]) % 8 == 0, (name, node)
    unsched = set(data["unschedulable"].tolist())
    assert {f"preemptor-nokey-{j}" for j in range(4)} <= unsched
    cpu = data["requested_cpu"]
    assert cpu.shape == (6144,) and cpu[:5000].max() == 4000.0
    assert os.path.getsize(path) < 1 << 20
