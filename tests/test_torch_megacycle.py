"""The megacycle slice of the port against the JAX package, on CPU.

Everything here is bit for bit:
  * K6's plain twin (models/megacycle.py commit_group_counts_plain)
    against the jitted JAX _commit_group_counts on every case of
    kernels/k6_cases.py;
  * the port's megacycle driver against K chained single cycles of the
    port and against the JAX make_megacycle_scheduler, both engines, with
    and without the quality top-k: winners, the final requested,
    nonzero_req and group_counts, the stacked top-k leaves;
  * the port's Scheduler with megacycle_batches=4 against the JAX
    Scheduler (tests/make_torch_golden.py jax_megacycle, the loop of
    loop.run_megacycle), both engines, pipelined and not: bindings and
    their order, every window's top-k leaves, the regret samples and every
    telemetry sample; and against the port's own single cycles;
  * the gates (_megacycle_safe, _megacycle_ready) on the JAX suite's
    matrix, two back-to-back megacycles over the resident snapshot, and
    the fault handling (a transient fault retries the whole megacycle, an
    escaped error requeues the windows not committed).
K6 runs only on the card: chip_smoke.py holds it against its twin on the
same cases.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.codec import SnapshotEncoder as JaxEncoder
from kubernetes_tpu.models import megacycle as jmega
from kubernetes_tpu.models.batched import encode_batch_ports
from kubernetes_tpu.runtime.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.runtime.scheduler import SchedulerConfig as JaxConfig
from kubernetes_tpu_torch import kernels, loop
from kubernetes_tpu_torch.codec import faults
from kubernetes_tpu_torch.codec.schema import cluster_to_torch
from kubernetes_tpu_torch.kernels import k6_cases
from kubernetes_tpu_torch.models import megacycle as tmega
from kubernetes_tpu_torch.models.batched import make_sequential_scheduler
from kubernetes_tpu_torch.models.speculative import make_speculative_scheduler
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PodBackoff, PriorityQueue
from kubernetes_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig

import fixtures
from torch_port_helpers import (
    port_factory_in_fixtures,
    process_state_kept,
)

ZONE = "failure-domain.beta.kubernetes.io/zone"
K6_CASES = dict(k6_cases.cases())


@pytest.fixture(autouse=True)
def _kept():
    with process_state_kept():
        yield


# ------------------------------------------------------------------ K6


def _jax_commit(c):
    N = c["gc"].shape[0]

    def run(gc, hosts, gids, gvalid):
        pods = SimpleNamespace(group_ids=gids, group_valid=gvalid)
        return jmega._commit_group_counts(gc, hosts, pods, N)

    return np.asarray(jax.jit(run)(c["gc"], c["hosts"], c["group_ids"],
                                   c["group_valid"]))


@pytest.mark.parametrize("name", list(K6_CASES))
def test_k6_twin_matches_the_reference(name):
    """The twin (and the CPU dispatch) against the jitted JAX
    _commit_group_counts, bit for bit; gc is not written."""
    c = K6_CASES[name]
    want = _jax_commit(c)
    gc = torch.from_numpy(c["gc"].copy())
    args = (torch.from_numpy(c["hosts"]), torch.from_numpy(c["group_ids"]),
            torch.from_numpy(c["group_valid"]))
    got = tmega.commit_group_counts_plain(gc, *args)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    pods = SimpleNamespace(group_ids=args[1], group_valid=args[2])
    again = tmega.commit_group_counts(gc, args[0], pods)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    np.testing.assert_array_equal(gc.numpy(), c["gc"])


def test_k6_cases_cover_the_shapes():
    live = K6_CASES["live"]
    assert list(K6_CASES)[-1] == "live"
    assert live["gc"].shape == (6144, 32) and live["hosts"].shape == (2048,)
    Bs = {c["hosts"].shape[0] for c in K6_CASES.values()}
    Ns = {c["gc"].shape[0] for c in K6_CASES.values()}
    assert {1, 7, 2048} <= Bs and {12, 6144} <= Ns
    assert max(c["gc"].shape[1] for c in K6_CASES.values()) == 64
    assert (K6_CASES["all-unschedulable"]["hosts"] < 0).all()
    edge = _jax_commit(K6_CASES["near-exact-edge"])
    assert edge.max() == k6_cases.EXACT_MAX


def test_k6_wrapper_refuses_cpu_tensors():
    c = K6_CASES["duplicate-slots"]
    args = [torch.from_numpy(c[k]) for k in ("gc", "hosts", "group_ids",
                                              "group_valid")]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.commit_group_counts(*args)


# ------------------------------------------------------- the raw driver


def _encoder(n_nodes=12, n_groups=4):
    enc = JaxEncoder()
    for i in range(n_nodes):
        enc.add_node(fixtures.make_node(f"n{i}", cpu="16", mem="32Gi",
                                        labels={ZONE: f"z{i % 3}"}))
    for d in range(n_groups):
        enc.add_spread_selector("default", {"app": f"dep-{d}"})
    return enc


def _windows(K=4, W=8, n_groups=4):
    return [[fixtures.make_pod(f"p{k}-{i}", cpu="300m", mem="128Mi",
                               labels={"app": f"dep-{(k + i) % n_groups}"})
             for i in range(W)] for k in range(K)]


def _encoded(enc, windows):
    # the second pass encodes every window at the stable pad shapes, as
    # the schedulers' _dispatch_megacycle does after a sticky-dim growth
    batches = [enc.encode_pods(w) for w in windows]
    batches = [enc.encode_pods(w) for w in windows]
    return batches, [encode_batch_ports(enc, w) for w in windows]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("quality", [0, 3])
@pytest.mark.parametrize("engine", ["sequential", "speculative"])
def test_raw_megacycle_matches_chained_cycles_and_jax(engine, quality):
    """One megacycle over 4 windows of 8 pods on 12 nodes in 4 spread
    groups equals the JAX megacycle and 4 chained single cycles of the
    port (resources through the engine, spread counts through K6's
    twin): winners, the final carry and the stacked top-k leaves."""
    enc = _encoder()
    batches, ports = _encoded(enc, _windows())
    cluster = enc.snapshot()
    li0 = np.cumsum([0] + [8] * 3).astype(np.int32)
    kw = dict(zone_key_id=enc.getzone_key, quality_topk=quality)
    jfn = jmega.make_megacycle_scheduler(engine=engine, **kw)
    jout = jfn(cluster, jmega.stack_windows(batches),
               jmega.stack_windows(ports), li0)
    tfn = tmega.make_megacycle_scheduler(engine=engine, device="cpu", **kw)
    assert tmega.make_megacycle_scheduler(engine=engine, device="cpu",
                                          **kw) is tfn
    tout = tfn(cluster, tmega.stack_windows(batches),
               tmega.stack_windows(ports), li0)
    np.testing.assert_array_equal(np.asarray(jout[0]), tout[0].numpy())
    assert (tout[0].numpy() >= 0).sum() > 0
    for f in ("requested", "nonzero_req", "group_counts"):
        np.testing.assert_array_equal(_bits(getattr(jout[1], f)),
                                      _bits(getattr(tout[1], f).numpy()))
    if quality:
        for j, t in zip(jout[2], tout[2]):
            np.testing.assert_array_equal(_bits(j), _bits(t.numpy()))
    # K chained single cycles of the port
    make = (make_speculative_scheduler if engine == "speculative"
            else make_sequential_scheduler)
    one = make(device="cpu", **kw)
    cl = cluster_to_torch(cluster, "cpu")
    for k, (b, p) in enumerate(zip(batches, ports)):
        out = one(cl, b, p, int(li0[k]))
        np.testing.assert_array_equal(out[0].numpy(), tout[0][k].numpy())
        gc = tmega.commit_group_counts_plain(
            cl.group_counts, out[0], torch.from_numpy(b.group_ids),
            torch.from_numpy(b.group_valid))
        cl = dataclasses.replace(out[1], group_counts=gc)
    for f in ("requested", "nonzero_req", "group_counts"):
        np.testing.assert_array_equal(getattr(cl, f).numpy(),
                                      getattr(tout[1], f).numpy())


def test_rotation_bases_wrap_as_int32():
    """Bases past 2^31 go in as the int32 values the reference's i32[K]
    array holds."""
    enc = _encoder()
    batches, ports = _encoded(enc, _windows(K=2))
    cluster = enc.snapshot()
    li0 = np.asarray([2**31 - 5, 2**31 + 3], np.int64)
    jfn = jmega.make_megacycle_scheduler(engine="sequential",
                                         zone_key_id=enc.getzone_key)
    jh, _ = jfn(cluster, jmega.stack_windows(batches),
                jmega.stack_windows(ports),
                np.asarray([kernels.wrap_i32(x) for x in li0], np.int32))
    tfn = tmega.make_megacycle_scheduler(engine="sequential", device="cpu",
                                         zone_key_id=enc.getzone_key)
    th, _ = tfn(cluster, tmega.stack_windows(batches),
                tmega.stack_windows(ports), li0)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())


# ------------------------------------------------- the live Scheduler

# (n_nodes, n_pods, batch): run_megacycle's cell cut to the CPU
SMALL = (64, 600, 64)


def _jax_cell(engine, pipeline, k=4):
    from make_torch_golden import jax_megacycle

    hosts, order, sched = jax_megacycle(*SMALL, k, engine=engine,
                                        pipeline=pipeline, warm_k=4)
    return hosts, order, sched


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("engine", ["speculative", "sequential"])
def test_live_megacycle_matches_jax_scheduler(engine, pipeline):
    """megacycle_batches=4 at the reference's default config (cpu_fallback
    off): the bindings and their order, every window's top-k leaves, the
    regret samples and every telemetry sample equal the JAX Scheduler's,
    and K = 4 places as K = 1."""
    n_nodes, n_pods, batch = SMALL
    hosts, order, jsched = _jax_cell(engine, pipeline)
    res = loop.run_megacycle(loop.bench_nodes(n_nodes), n_pods, batch,
                             ks=(1, 4), device="cpu", engine=engine,
                             pipeline=pipeline)
    run = res["runs"][4]
    assert res["identical"]
    assert res["curve"][1]["megacycles"] > 0
    assert run["scheduler"].megacycles_total == jsched.megacycles_total
    np.testing.assert_array_equal(run["hosts"], hosts)
    np.testing.assert_array_equal(run["bind_order"], order)
    want_q = loop.quality_arrays(jsched.quality_record)
    got_q = loop.quality_arrays(run["quality_record"])
    assert set(want_q) == set(got_q)
    for k in want_q:
        np.testing.assert_array_equal(_bits(got_q[k]), _bits(want_q[k]),
                                      err_msg=k)
    assert got_q["regret_cycle"].size > 0
    want_t = loop.telemetry_arrays(jsched.telemetry_record)
    got_t = loop.telemetry_arrays(run["telemetry_record"])
    for k in want_t:
        if want_t[k].dtype.kind == "f":
            np.testing.assert_array_equal(want_t[k], got_t[k], err_msg=k)
        else:
            np.testing.assert_array_equal(_bits(want_t[k]),
                                          _bits(got_t[k]), err_msg=k)
    assert run["quality"]["regret_dropped"] == 0
    assert run["telemetry"]["samples_dropped"] == 0
    assert (run["hosts"] >= 0).all()


def _live(K, engine="speculative", nodes=8, pipeline=True, port=True):
    cfg_kw = dict(batch_size=32, batch_window_s=0.0, engine=engine,
                  disable_preemption=True, batched_commit=True,
                  pipeline_commit=pipeline, megacycle_batches=K,
                  device_backoff_base_s=0.001, device_backoff_max_s=0.005,
                  breaker_open_s=0.02, cpu_fallback=False, telemetry=False,
                  timeline=False, quality_top_k=0)
    if port:
        with port_factory_in_fixtures():
            node = fixtures.make_node
        cache = SchedulerCache()
        queue = PriorityQueue(
            backoff=PodBackoff(initial=0.01, max_duration=0.05))
        sched = Scheduler(cache=cache, queue=queue,
                          binder=lambda p, n: True,
                          config=SchedulerConfig(**cfg_kw), device="cpu")
    else:
        from kubernetes_tpu.runtime.cache import SchedulerCache as JCache
        from kubernetes_tpu.runtime.queue import (
            PodBackoff as JBackoff,
            PriorityQueue as JQueue,
        )

        node = fixtures.make_node
        cache = JCache()
        queue = JQueue(backoff=JBackoff(initial=0.01, max_duration=0.05))
        sched = JaxScheduler(cache=cache, queue=queue,
                             binder=lambda p, n: True,
                             config=JaxConfig(**cfg_kw))
    for i in range(nodes):
        cache.add_node(node(f"n{i}", cpu="64", mem="128Gi",
                            labels={ZONE: f"z{i % 4}"}))
    for d in range(4):
        cache.encoder.add_spread_selector("default", {"app": f"dep-{d}"})
    return sched, queue


def _drain(sched, queue, budget_s=60.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        got = sched.run_once(timeout=0.0)
        if got == 0 and not sched.pipeline_pending:
            if not queue.has_schedulable():
                break
            time.sleep(0.002)
    sched.flush_pipeline()


def _feed(queue, n, prefix="p", port=True):
    if port:
        with port_factory_in_fixtures():
            make = fixtures.make_pod
    else:
        make = fixtures.make_pod
    for i in range(n):
        queue.add(make(f"{prefix}{i}", cpu="100m", mem="64Mi",
                       labels={"app": f"dep-{i % 4}"}))


def _placements(sched):
    return {(r.pod.namespace, r.pod.name): r.node
            for r in sched.results if r.node is not None}


def test_megacycle_gates_match_the_reference():
    """_megacycle_safe on the JAX suite's matrix (plain, gang, host port,
    pod affinity, two spread groups) and _megacycle_ready before and
    after a nomination: the JAX answers."""
    answers = []
    for port in (True, False):
        sched, _ = _live(4, port=port)
        if port:
            with port_factory_in_fixtures():
                make = fixtures.make_pod
        else:
            make = fixtures.make_pod
        aff = {"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {"matchLabels": {"app": "dep-0"}},
                "topologyKey": ZONE}]}}
        got = [
            sched._megacycle_safe([make("ok", cpu="50m",
                                        labels={"app": "dep-0"})]),
            sched._megacycle_safe([make(
                "g", cpu="50m",
                labels={Scheduler.POD_GROUP_LABEL: "grp"})]),
            sched._megacycle_safe([make("p", cpu="50m",
                                        ports=[{"hostPort": 80}])]),
            sched._megacycle_safe([make("a", cpu="50m", affinity=aff)]),
        ]
        sched.cache.encoder.add_spread_selector("default", {"tier": "x"})
        got.append(sched._megacycle_safe([make(
            "m", cpu="50m", labels={"app": "dep-0", "tier": "x"})]))
        got.append(sched._megacycle_ready())
        sched.queue.update_nominated_pod(make("nom", cpu="1m"), "n0")
        got.append(sched._megacycle_ready())
        answers.append(got)
    assert answers[0] == answers[1] == [True, False, False, False, False,
                                        True, False]


def test_ineligible_windows_ride_single_cycles():
    """Host-port pods never form a megacycle and place as with K = 1."""
    def feed_ports(queue):
        with port_factory_in_fixtures():
            for i in range(40):
                queue.add(fixtures.make_pod(f"hp{i}", cpu="50m", mem="32Mi",
                                            ports=[{"hostPort": 8000 + i}]))

    s1, q1 = _live(1)
    feed_ports(q1)
    _drain(s1, q1)
    s4, q4 = _live(4)
    feed_ports(q4)
    _drain(s4, q4)
    assert s4.megacycles_total == 0
    assert _placements(s1) == _placements(s4) and len(_placements(s4)) == 40


def test_back_to_back_megacycles_keep_resident_snapshot_coherent():
    """Two megacycles through the live scheduler: the second's dirty-row
    refresh of the resident snapshot reflects the first's host commits
    (placements equal one long single-cycle run)."""
    s, q = _live(2)
    _feed(q, 128, prefix="a")
    _drain(s, q)
    first = s.megacycles_total
    _feed(q, 128, prefix="b")
    _drain(s, q)
    assert s.megacycles_total > first >= 1
    s1, q1 = _live(1)
    _feed(q1, 128, prefix="a")
    _drain(s1, q1)
    _feed(q1, 128, prefix="b")
    _drain(s1, q1)
    assert _placements(s) == _placements(s1)
    assert len(_placements(s)) == 256


def test_transient_fault_retries_the_whole_megacycle():
    """A transient fence fault relaunches all K windows: the placements of
    the unfaulted run, every popped pod resolved once."""
    s_ref, q_ref = _live(4, "sequential")
    _feed(q_ref, 120)
    _drain(s_ref, q_ref)
    s, q = _live(4, "sequential")
    _feed(q, 120)
    inj = faults.FaultInjector(seed=11)
    inj.arm(faults.SITE_FENCE, kind=faults.FAULT_TRANSIENT, count=1)
    remove = faults.install_injector(inj)
    try:
        _drain(s, q)
    finally:
        remove()
    assert s.megacycles_total > 0
    assert _placements(s) == _placements(s_ref)
    assert s.invariants.violations_total() == 0
    assert s.invariants.assert_drained()
    assert s.device_health.state == "closed"


def test_escaped_error_requeues_uncommitted_windows(monkeypatch):
    """An unclassified error in window 2's state commit: windows 0 and 1
    committed and their tails bound their pods; windows 2 and 3 went back
    to the queue; the error propagated; the next drain places the rest."""
    s, q = _live(4, pipeline=False)
    _feed(q, 128)
    inner = s._commit_state
    seen = []

    def commit(inf):
        seen.append(inf.mega)
        if inf.mega == (2, 4) and len(seen) == 3:
            raise RuntimeError("injected commit error")
        return inner(inf)

    monkeypatch.setattr(s, "_commit_state", commit)
    with pytest.raises(RuntimeError, match="injected"):
        s.run_once(timeout=0.0)
    assert seen == [(0, 4), (1, 4), (2, 4)]
    assert len(_placements(s)) == 64
    assert len(q) == 64
    monkeypatch.undo()
    # the requeued windows wait unschedulable for a cluster event
    q.move_all_to_active()
    time.sleep(0.06)
    _drain(s, q)
    assert len(_placements(s)) == 128
    assert s.invariants.violations_total() == 0
    assert s.invariants.assert_drained()


def test_megacycle_golden_file():
    """The full-width golden chip_smoke.py phase 16 reads: every pod
    (warmup of 4 x 2,048 + 1,024 included) bound once, in a recorded
    order, by K = 4 megacycles, with the observatories' records."""
    import os

    from make_torch_golden import golden_path

    path = golden_path("live_megacycle")
    data = np.load(path)
    hosts, order = data["hosts"], data["bind_order"]
    assert int(data["k"]) == 4 and int(data["batch"]) == 2048
    assert int(data["nodes"]) == 5000 and int(data["pods"]) == 10000
    assert hosts.shape == (10000 + 4 * 2048 + 1024,)
    assert (hosts >= 0).all() and hosts.max() < 5000
    assert sorted(order.tolist()) == list(range(hosts.size))
    assert int(data["megacycles"]) >= 2
    assert int(data["cycle_pods"].sum()) == hosts.size
    assert data["sample_cycle"].size > 0 and data["regret_cycle"].size > 0
    assert set(data["sample_source"].tolist()) == {"device"}
    assert os.path.getsize(path) < 1 << 20
