"""The port's preemption ops against the JAX package's, on CPU, bit for bit.

K2's plain twin (models/preemption.py preempt_one_plain) against the jitted
JAX preempt_one on every case of kernels/k2_cases.py, all four outputs;
the order-f32 case is checked to be one where slot-order addition would
change the answer.  preemption_candidates (through make_preempt_eval),
sorted_victim_slots and dense_start_ranks against the JAX functions on
twin inputs.  Then tests/test_preemption.py's scenarios (basic, reprieve,
impossible, unresolvable, PDB criterion, start-time criterion, host ports,
shared-volume identity credit, randomized seeds) run through both
packages' encoders and pickers, and a cluster with more potential victims
than the 1,024-slot cap holds shows the port giving the reference's
answer.  The `cuda`-marked test holds K2 against the twin on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import factory as jax_factory
from kubernetes_tpu.api import resource as jax_resource
from kubernetes_tpu.api import storage as jax_storage
from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.codec import SnapshotEncoder as JaxEncoder
from kubernetes_tpu.codec.schema import FilterConfig as JaxFilterConfig
from kubernetes_tpu.models import preemption as jp
from kubernetes_tpu.ops import filter_batch as jax_filter_batch
from kubernetes_tpu.ops.predicates import (
    required_affinity_ok as jax_required_affinity_ok,
)
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api import factory as port_factory
from kubernetes_tpu_torch.api import resource as port_resource
from kubernetes_tpu_torch.api import storage as port_storage
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.codec import SnapshotEncoder as PortEncoder
from kubernetes_tpu_torch.codec.schema import FilterConfig, PadDims
from kubernetes_tpu_torch.codec.schema import pods_to_torch, cluster_to_torch
from kubernetes_tpu_torch.kernels import k2_cases
from kubernetes_tpu_torch.models import preemption as pp

from fixtures import TEST_DIMS
from torch_port_helpers import UNSCHED_KEY, twin_world


@functools.lru_cache(maxsize=None)
def _cases():
    return dict(k2_cases.cases())


def _jax_pick(c):
    a = [c[k] for k in k2_cases.ARGS]
    res = jp.preempt_one(*a[:10], vol_tables=tuple(a[10:]), has_vols=True)
    return [np.asarray(x) for x in res]


def _port_pick(c):
    a = [torch.from_numpy(np.ascontiguousarray(c[k])) for k in k2_cases.ARGS]
    res = pp.preempt_one(*a[:10], tuple(a[10:]))
    return [x.numpy() for x in res]


@pytest.mark.parametrize("name", k2_cases.NAMES)
def test_plain_twin_matches_jax_preempt_one(name):
    c = _cases()[name]
    want, got = _jax_pick(c), _port_pick(c)
    for w, g, what in zip(want, got, pp.PreemptionResult._fields):
        assert w.dtype == g.dtype and w.shape == g.shape, (name, what)
        np.testing.assert_array_equal(g, w, err_msg=f"{name}: {what}")
    expect = {"no-candidate": -1, "impossible": -1, "all-tie": 2,
              "order-f32": 0, "crowded": 0}
    if name in expect:
        assert int(got[0]) == expect[name]
    if name == "pdb-all":
        assert int(got[3]) > 0
    if int(got[0]) < 0:
        assert not got[1].any() and int(got[2]) == 0


def test_cases_cover_the_kernel_hazards():
    cs = _cases()
    assert [n for n, _ in k2_cases.cases()] == list(k2_cases.NAMES)
    full = cs["full-width"]
    assert full["requested"].shape == (6144, k2_cases.E)
    assert full["pods_node"].shape == (32768,)
    # more potential victims than the cap: the slots are cut at 1,024
    low = ((full["pods_node"] >= 0)
           & (full["pods_priority"] < k2_cases.PREEMPTOR_PRIORITY)).sum()
    assert low > 1024 and full["victim_slots"].shape == (1024,)
    assert (full["victim_slots"] >= 0).all()
    crowded = cs["crowded"]
    on0 = crowded["pods_node"][crowded["victim_slots"][
        crowded["victim_slots"] >= 0]] == 0
    assert on0.sum() > 32
    vols = cs["random-0"]
    assert (vols["slot_vids"] >= 0).any() and vols["freed_vol_init"].any()
    ports = cs["pdb-ports"]
    assert ports["pods_req"][:, k2_cases.R].any()
    assert ports["pod_req"][k2_cases.R] > 0


def test_redesign_cases_hold_their_edges():
    """The cases of K2's bucketed design: a 110-victim row, victims on the
    edges of row ranges with two listed pods outside [0, N) that change
    the answer, an identity whose evicted count falls below its total
    partway through, 1,024 slots on 1,024 rows, rows that need no victim
    with and without a pod on them, and two wider column sets that give
    their base cases' answers."""
    cs = _cases()

    def listed_rows(c):
        s = c["victim_slots"]
        return c["pods_node"][s[s >= 0]]

    heavy = cs["heavy-node"]
    assert (listed_rows(heavy) == 40).sum() == 110
    assert int(_port_pick(heavy)[0]) == 40

    edge = cs["block-edge"]
    n = edge["requested"].shape[0]
    rows = listed_rows(edge)
    assert n == 300 and {-1, n} <= set(rows.tolist())
    assert {0, 31, 32, 63, 64, 127, 128, n - 1} <= set(rows.tolist())
    got = _port_pick(edge)
    assert int(got[0]) == 31 and int(got[2]) == 1
    # without the two pods outside the segments, row N-1 keeps one victim
    # and wins: the reprieve row and the segment row must stay apart
    cut = dict(edge)
    slots = edge["victim_slots"].copy()
    out = (slots >= 0) & ((edge["pods_node"][np.maximum(slots, 0)] < 0)
                          | (edge["pods_node"][np.maximum(slots, 0)] >= n))
    assert out.sum() == 2
    slots[out] = -1
    cut["victim_slots"] = slots
    assert int(_port_pick(cut)[0]) == n - 1 == int(_jax_pick(cut)[0])

    vols = cs["shared-vols"]
    x = int(vols["slot_vids"][0, 0])
    assert vols["vid_listed"][x] == vols["vid_total"][x] == 3
    got = _port_pick(vols)
    assert int(got[0]) == 33 and np.nonzero(got[1])[0].tolist() == [3]

    spread = cs["spread-1024"]
    rows = listed_rows(spread)
    assert rows.size == 1024 == np.unique(rows).size
    assert int(_port_pick(spread)[2]) == 1

    empty = cs["empty-row"]
    got = _port_pick(empty)
    assert int(got[0]) == 40 and int(got[2]) == 0
    assert not (empty["pods_node"] == 40).any()

    for name, base in (("wide-31", "random-0"), ("wide-60", "random-2")):
        assert cs[name]["requested"].shape[1] == int(name[5:])
        for w, b in zip(_port_pick(cs[name]), _port_pick(cs[base])):
            np.testing.assert_array_equal(w, b)


def test_order_f32_case_depends_on_the_order_of_addition():
    """freed must add a node's victims in ascending arena index: summed in
    slot order, the node would not fit and the answer would be -1."""
    c = _cases()["order-f32"]
    f32 = np.float32
    slots = c["victim_slots"][c["victim_slots"] >= 0]
    mem = c["pods_req"][:, 1]

    def fits(order):
        freed = f32(0)
        for m in order:
            freed = f32(freed + mem[m])
        return not (f32(f32(c["requested"][0, 1] - freed) + c["pod_req"][1])
                    > c["allocatable"][0, 1])

    assert fits(sorted(slots)) and not fits(slots)
    assert slots.tolist() != sorted(slots.tolist())
    assert int(_port_pick(c)[0]) == 0 == int(_jax_pick(c)[0])


def test_exact_prio_sum_matches_jax():
    rng = np.random.default_rng(3)
    prio = rng.integers(-2**31, 2**31, 400, dtype=np.int64).astype(np.int32)
    prio[:4] = (np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1)
    vic = rng.random(400) < 0.7
    seg = rng.integers(0, 9, 400).astype(np.int32)
    want = jp._exact_prio_sum(vic, prio, seg, 9)
    got = pp._exact_prio_sum(torch.from_numpy(vic), torch.from_numpy(prio),
                             torch.from_numpy(seg.astype(np.int64)), 9)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_sorted_victim_slots_and_start_ranks_match_jax(seed):
    rng = np.random.default_rng(seed)
    M = 3000
    prio = rng.integers(0, 6, M).astype(np.int32) * 10
    node = rng.integers(-1, 50, M).astype(np.int32)
    valid = rng.random(M) < 0.9
    viol = rng.random(M) < 0.2
    start = 1.6e9 + rng.integers(0, 500, M) * 0.25
    for cap, preemptor in ((1024, 35), (64, 35), (1024, 5), (1024, 0)):
        want = jp.sorted_victim_slots(prio, valid, node, preemptor, viol,
                                      start, cap=cap)
        got = pp.sorted_victim_slots(prio, valid, node, preemptor, viol,
                                     start, cap=cap)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pp.dense_start_ranks(start),
                                  jp.dense_start_ranks(start))


@pytest.mark.parametrize("seed", range(2))
def test_preemption_candidates_match_jax(seed):
    """The port's candidate evaluation against filter_batch +
    required_affinity_ok + preemption_candidates of the JAX package on
    twin encoders, pods with (anti-)affinity terms included."""
    je, pe, jpods, ppods = twin_world(seed + 40, n_nodes=48, n_existing=90,
                                      n_pending=12)
    run = pp.make_preempt_eval(FilterConfig(), pe.interner.intern(UNSCHED_KEY))
    jcl, pcl = je.snapshot(), cluster_to_torch(pe.snapshot(), "cpu")
    ukey = je.interner.intern(UNSCHED_KEY)
    for jpod, ppod in zip(jpods, ppods):
        jb, pb = je.encode_pods([jpod]), pe.encode_pods([ppod])
        _, per = jax_filter_batch(jcl, jb, JaxFilterConfig(), ukey)
        want = jp.preemption_candidates(
            np.asarray(per), np.asarray(jcl.valid),
            np.asarray(jax_required_affinity_ok(jcl, jb)))
        got = run(pcl, pods_to_torch(pb, "cpu"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ test_preemption.py's
# scenarios through both packages

JAX = dict(f=jax_factory, t=jax_types, s=jax_storage, r=jax_resource,
           enc=lambda: JaxEncoder(TEST_DIMS))
PORT = dict(f=port_factory, t=port_types, s=port_storage, r=port_resource,
            enc=lambda: PortEncoder(PadDims(**dataclasses.asdict(TEST_DIMS))))


def _pdb(P, name, labels):
    return P["t"].PodDisruptionBudget(
        metadata=P["t"].ObjectMeta(name=name, namespace="default"),
        selector={"matchLabels": labels}, disruptions_allowed=0)


def _pvc_world(P, n_vols, cap, pods):
    """A node with `cap` EBS attachments, volumes ebs1..n, and pods given
    as (name, claim index, priority, node) — the shared-volume scenarios."""
    mk = P["f"]
    node = mk.make_node("n1", cpu="8", mem="16Gi")
    node.status.allocatable["attachable-volumes-aws-ebs"] = (
        P["r"].parse_quantity(str(cap)))
    pvs = [P["s"].PersistentVolume.from_dict({
        "metadata": {"name": f"ebs{i}"},
        "spec": {"awsElasticBlockStore": {"volumeID": f"v{i}"}}})
        for i in range(1, n_vols + 1)]
    pvcs = [P["s"].PersistentVolumeClaim.from_dict({
        "metadata": {"name": f"c{i}", "namespace": "default"},
        "spec": {"volumeName": f"ebs{i}"}}) for i in range(1, n_vols + 1)]

    def pvc_pod(name, claim, prio, on=None):
        return mk.make_pod(name, cpu="100m", priority=prio, node_name=on,
                           volumes=[{"persistentVolumeClaim": {
                               "claimName": f"c{claim}"}}])

    existing = [pvc_pod(n, c, p, "n1") for n, c, p in pods[:-1]]
    name, claim, prio = pods[-1]
    return [node], existing, pvc_pod(name, claim, prio), [], pvs, pvcs


def _scenario(P, which, seed=0):
    """(nodes, existing, preemptor, pdbs, pvs, pvcs) of one scenario of
    tests/test_preemption.py, built with package P's objects."""
    mk = P["f"]
    n, p = mk.make_node, mk.make_pod
    two = [n("n1", cpu="1", mem="4Gi"), n("n2", cpu="1", mem="4Gi")]
    port = [{"hostPort": 8080, "protocol": "TCP"}]
    if which == "basic":
        return two, [p("low-a", cpu="600m", node_name="n1", priority=1),
                     p("low-b", cpu="600m", node_name="n2", priority=2)], \
            p("high", cpu="800m", priority=100), [], [], []
    if which == "reprieve":
        return [n("n1", cpu="2", mem="4Gi")], [
            p("keep", cpu="500m", node_name="n1", priority=50),
            p("evict", cpu="1", node_name="n1", priority=1)], \
            p("high", cpu="1400m", priority=100), [], [], []
    if which == "impossible":
        return [n("n1", cpu="1", mem="4Gi")], [
            p("top", cpu="900m", node_name="n1", priority=1000)], \
            p("mid", cpu="500m", priority=100), [], [], []
    if which == "unresolvable":
        return [n("n1", cpu="4", mem="8Gi", labels={"disk": "ssd"}),
                n("n2", cpu="1", mem="4Gi")], [
            p("low", cpu="900m", node_name="n2", priority=1)], \
            p("high", cpu="500m", priority=100,
              node_selector={"disk": "nvme"}), [], [], []
    if which == "pdb":
        return two, [p("prot", cpu="900m", node_name="n1", priority=1,
                       labels={"app": "guarded"}),
                     p("plain", cpu="900m", node_name="n2", priority=5)], \
            p("high", cpu="800m", priority=100), \
            [_pdb(P, "pdb", {"app": "guarded"})], [], []
    if which == "start-time":
        old = p("old", cpu="900m", node_name="n1", priority=1)
        old.status.start_time = 100.0
        young = p("young", cpu="900m", node_name="n2", priority=1)
        young.status.start_time = 500.0
        return two, [old, young], p("high", cpu="800m", priority=10), \
            [], [], []
    if which == "host-port":
        return [n("n1", cpu="4", mem="8Gi")], [
            p("holder", cpu="100m", node_name="n1", priority=1, ports=port)], \
            p("high", cpu="100m", priority=100, ports=port), [], [], []
    if which == "port-held-higher":
        return [n("n1", cpu="4", mem="8Gi")], [
            p("portly", cpu="100m", node_name="n1", priority=1000,
              ports=port),
            p("filler", cpu="100m", node_name="n1", priority=1)], \
            p("high", cpu="100m", priority=100, ports=port), [], [], []
    if which == "shared-volume":
        return _pvc_world(P, 3, 2, [("shared-a", 1, 1), ("shared-b", 1, 2),
                                    ("keeper", 2, 1000), ("boss", 3, 2000)])
    if which == "shared-volume-nonvictim":
        return _pvc_world(P, 2, 1, [("victim", 1, 1), ("keeper", 1, 5000),
                                    ("boss", 2, 2000)])
    if which == "randomized":
        rng = np.random.default_rng(4000 + seed)
        nodes = [n(f"n{i}", cpu=str(int(rng.integers(1, 4))), mem="8Gi")
                 for i in range(6)]
        existing = [p(f"e{i}", cpu=f"{int(rng.integers(1, 8)) * 100}m",
                      node_name=f"n{int(rng.integers(6))}",
                      priority=int(rng.integers(0, 5)) * 10)
                    for i in range(14)]
        return nodes, existing, p("boss", cpu="900m", priority=1000), \
            [], [], []
    raise ValueError(which)


def _encode(P, nodes, existing, pvs, pvcs):
    enc = P["enc"]()
    for pv in pvs:
        enc.add_pv(pv)
    for pvc in pvcs:
        enc.add_pvc(pvc)
    for node in nodes:
        enc.add_node(node)
    for pod in existing:
        enc.add_pod(pod)
    return enc


def _violating(enc, pdbs):
    arena = enc.pods_snapshot()
    flags = np.zeros(len(arena.node), bool)
    for rec in enc.pods.values():
        if rec.pod is not None and rec.node_row >= 0:
            flags[rec.m] = any(b.matches(rec.pod) for b in pdbs)
    return arena, flags


def _jax_preempt(nodes, existing, pre, pdbs, pvs, pvcs):
    """tests/test_preemption.py run_device_preempt, by pick_preemption_node
    (the scheduler's loop: pick, verify, veto)."""
    enc = _encode(JAX, nodes, existing, pvs, pvcs)
    cluster, batch = enc.snapshot(), enc.encode_pods([pre])
    _, per = jax_filter_batch(cluster, batch, JaxFilterConfig(), 0)
    cands = jp.preemption_candidates(
        np.asarray(per), np.asarray(cluster.valid),
        np.asarray(jax_required_affinity_ok(cluster, batch)))[0]
    arena, viol = _violating(enc, pdbs)
    slots = jp.sorted_victim_slots(arena.priority, arena.valid, arena.node,
                                   pre.spec.priority, viol, arena.start)
    row, vm, _, res = jp.pick_preemption_node(
        enc, pre, cands, arena, slots, viol, JaxFilterConfig().max_vols)
    return row, sorted(arena.keys[m] for m in vm), res


def _port_preempt(nodes, existing, pre, pdbs, pvs, pvcs):
    enc = _encode(PORT, nodes, existing, pvs, pvcs)
    run = pp.make_preempt_eval(FilterConfig(), 0)
    cands = run(cluster_to_torch(enc.snapshot(), "cpu"),
                pods_to_torch(enc.encode_pods([pre]), "cpu"))[0].numpy()
    arena, viol = _violating(enc, pdbs)
    slots = pp.sorted_victim_slots(arena.priority, arena.valid, arena.node,
                                   pre.spec.priority, viol, arena.start)
    row, vm, _, res = pp.pick_preemption_node(
        enc, pre, cands, arena, slots, viol, FilterConfig().max_vols,
        device="cpu")
    return row, sorted(arena.keys[m] for m in vm), res


SCENARIOS = ["basic", "reprieve", "impossible", "unresolvable", "pdb",
             "start-time", "host-port", "port-held-higher", "shared-volume",
             "shared-volume-nonvictim"] + [f"randomized-{s}" for s in range(4)]
EXPECTED = {"basic": ("n1", {"low-a"}), "reprieve": ("n1", {"evict"}),
            "impossible": (None, set()), "unresolvable": (None, set()),
            "pdb": ("n2", {"plain"}), "start-time": ("n2", {"young"}),
            "host-port": ("n1", {"holder"}), "port-held-higher": (None, set()),
            "shared-volume": ("n1", {"shared-a", "shared-b"}),
            "shared-volume-nonvictim": (None, set())}


@pytest.mark.parametrize("which", SCENARIOS)
def test_scenarios_match_jax(which):
    name, _, seed = which.partition("-") if which.startswith("randomized") \
        else (which, "", "0")
    jrow, jvic, jres = _jax_preempt(*_scenario(JAX, name, int(seed)))
    prow, pvic, pres = _port_preempt(*_scenario(PORT, name, int(seed)))
    assert (prow, pvic) == (jrow, jvic)
    if jres is not None:
        for w, g in zip(jres, pres):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if which in EXPECTED:
        node, victims = EXPECTED[which]
        assert (f"n{prow + 1}" if prow >= 0 else None) == node
        assert {k[1] for k in pvic} == victims


def test_victim_cap_binds_like_the_reference():
    """1,200 potential victims on 600 nodes (2 a node), with the start
    times interleaved so the 1,024 most important slots hold both victims
    of only some nodes: the preemptor needs both gone, so only those nodes
    are possible.  The port keeps the reference's cap and gives its
    answer."""
    out = []
    for P in (JAX, PORT):
        mk = P["f"]
        nodes = [mk.make_node(f"n{i}", cpu="1", mem="4Gi") for i in range(600)]
        existing = []
        for i in range(1200):
            pod = mk.make_pod(f"v{i}", cpu="500m", node_name=f"n{i % 600}",
                              priority=1)
            # node k's two victims start at k and 1,200 - k: late nodes
            # hold one early and one late victim, cut by the cap
            pod.status.start_time = float(i if i < 600 else 1800 - i)
            existing.append(pod)
        pre = mk.make_pod("boss", cpu="800m", priority=100)
        out.append((nodes, existing, pre, [], [], []))
    jrow, jvic, _ = _jax_preempt(*out[0])
    prow, pvic, _ = _port_preempt(*out[1])
    assert (prow, pvic) == (jrow, jvic)
    enc = _encode(PORT, *[out[1][i] for i in (0, 1, 4, 5)])
    arena = enc.pods_snapshot()
    assert len(pp.sorted_victim_slots(arena.priority, arena.valid, arena.node,
                                      100)) == 1024


@pytest.mark.cuda
def test_k2_matches_plain_twin_on_card():
    """K2 against its twin on every k2_cases case (the list chip_smoke.py
    checks), all four outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU mode")
    for name, c in k2_cases.cases():
        a = [torch.from_numpy(np.ascontiguousarray(c[k])).cuda()
             for k in k2_cases.ARGS]
        got = kernels.preempt_one(*a)
        want = pp.preempt_one_plain(*a[:10], tuple(a[10:]))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), name


def test_k2_wrapper_refuses_cpu_tensors_and_bad_shapes():
    c = _cases()["random-0"]
    a = [torch.from_numpy(np.ascontiguousarray(c[k])) for k in k2_cases.ARGS]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.preempt_one(*a)
    with pytest.raises(TypeError, match="15 tensors"):
        kernels.preempt_one(*a[:10])
