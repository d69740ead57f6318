"""The telemetry slice: kernel K5's plain twin, the port's telemetry hub, and
the port's Scheduler with telemetry on, against the JAX package.

  * `cluster_analytics_plain` (K5's twin) bit for bit against the jitted
    JAX `cluster_analytics` on every CPU-sized kernels/k5_cases.py case and
    on the JAX suite's own cases (randomized snapshots, an empty cluster,
    an encoder snapshot with a recycled row, the hand-checked cluster), and
    against the numpy reference `cluster_analytics_np` (bit for bit, apart
    from the sign of a zero utilization statistic where numpy's max and
    unstable sort meet -0.0 beside 0.0: equal in value there);
  * `analytics_to_dict`, the 40-word packing, the dispatcher on CPU tensors;
  * the SLO evaluator, and the hub's interval, ring, EWMA and width pruning
    against the JAX TelemetryHub under the same injected clock; a due
    sample with no resident snapshot is dropped and counted where the JAX
    hub takes its host route;
  * the port's Scheduler and the JAX Scheduler with telemetry at interval 1
    and 4, pipelined and not, on test_torch_live.py's workloads: equal
    bindings, every sample's cycle, source and analytics, and the quality
    drift detectors' state after every cycle; which cycle's snapshot each
    sample reflects; telemetry off leaves the bindings unchanged; a faulted
    sample is counted, not raised;
  * the reference's default SchedulerConfig with cpu_fallback off
    constructs and schedules; K5 against its twin on the card (cuda).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import analytics as jax_analytics
from kubernetes_tpu.runtime import telemetry as jax_telemetry
from kubernetes_tpu_torch import kernels, loop
from kubernetes_tpu_torch.kernels import k5_cases
from kubernetes_tpu_torch.ops import analytics
from kubernetes_tpu_torch.runtime import quality, telemetry
from kubernetes_tpu_torch.runtime import timeline as port_timeline
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PriorityQueue
from kubernetes_tpu_torch.runtime.scheduler import (
    Scheduler,
    SchedulerConfig,
    refused_settings,
)

import fixtures
from make_torch_golden import golden_path, jax_live
from torch_port_helpers import process_state_kept

CPU_CASES = k5_cases.cases(k5_cases.CPU_MAX_N)
# cases holding -0.0 beside 0.0 in requested: numpy's max and its unstable
# sort may give the other zero (the jitted reference and the port agree)
SIGNED_ZERO = {"signed-zero-16", "signed-zero-100", "signed-zero-512"}


@pytest.fixture(autouse=True)
def _no_process_defaults_left():
    """A Scheduler of either package installs its hub, timeline and
    observatories as process defaults; put back what was there before each
    test."""
    with process_state_kept():
        yield


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _twin(a, r, v) -> analytics.ClusterAnalytics:
    return analytics.cluster_analytics_plain(
        torch.from_numpy(np.ascontiguousarray(a)),
        torch.from_numpy(np.ascontiguousarray(r)),
        torch.from_numpy(np.ascontiguousarray(v)))


def _assert_bit_equal(got, want, what):
    for f in dataclasses.fields(analytics.ClusterAnalytics):
        g = np.asarray(getattr(got, f.name))
        w = np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f.name)
        assert np.array_equal(_bits(g), _bits(w)), (
            f"{what}: {f.name} port {g!r} reference {w!r}")


def _twin_np(tw) -> analytics.ClusterAnalytics:
    return analytics.ClusterAnalytics(**{
        f.name: getattr(tw, f.name).numpy()
        for f in dataclasses.fields(tw)})


# ------------------------------------------------------------ K5's twin


@pytest.mark.parametrize("name,case", CPU_CASES,
                         ids=[n for n, _ in CPU_CASES])
def test_twin_bit_equal_to_jitted_jax_and_numpy(name, case):
    a, r, v = case
    tw = _twin_np(_twin(a, r, v))
    _assert_bit_equal(tw, jax_analytics.cluster_analytics(a, r, v),
                      f"{name} vs jitted JAX")
    ref = jax_analytics.cluster_analytics_np(a, r, v)
    if name in SIGNED_ZERO:
        # equal in value; the numpy reference's zero may carry either sign
        for f in dataclasses.fields(ref):
            assert np.array_equal(np.asarray(getattr(tw, f.name)),
                                  np.asarray(getattr(ref, f.name)))
        assert not np.array_equal(_bits(tw.utilization),
                                  _bits(ref.utilization))
    else:
        _assert_bit_equal(tw, ref, f"{name} vs numpy")
    # the port's own numpy copy is the reference's
    _assert_bit_equal(analytics.cluster_analytics_np(a, r, v), ref,
                      f"{name} numpy copy")


@pytest.mark.parametrize("n", k5_cases.WIDE_N)
def test_twin_past_the_one_launch_width(n):
    """The cases K5 takes through its multi-block sequence (past 16,384
    rows): the twin bit for bit against the jitted JAX reference, -0.0
    beside 0.0 and recycled rows included."""
    a, r, v = dict(k5_cases.cases())[f"wide-{n}"]
    assert a.shape[0] == n > k5_cases.MAX_N
    zeros = r[v, :4] == 0.0
    assert np.signbit(r[v, :4][zeros]).any()
    assert (~np.signbit(r[v, :4][zeros])).any()
    _assert_bit_equal(_twin_np(_twin(a, r, v)),
                      jax_analytics.cluster_analytics(a, r, v), f"wide-{n}")


def test_hub_and_observatory_default_to_the_card():
    """Built on their own, the hub and the quality observatory run on the
    card, as every other entry point of the port does."""
    assert telemetry.TelemetryHub().device == torch.device("cuda")
    assert quality.QualityObservatory().device == torch.device("cuda")


def test_twin_on_the_jax_suites_random_snapshots():
    """tests/test_telemetry.py's randomized trials: overcommitted nodes,
    zero-capacity columns, invalid rows."""
    rng = np.random.default_rng(0)
    for trial in range(8):
        N = int(rng.choice([8, 16, 64, 257, 512, 1000]))
        alloc = (rng.uniform(0, 1e4, (N, 8))
                 * rng.integers(0, 2, (N, 8))).astype(np.float32)
        req = (alloc * rng.uniform(0, 1.5, (N, 8))).astype(np.float32)
        valid = rng.random(N) < 0.8
        _assert_bit_equal(_twin_np(_twin(alloc, req, valid)),
                          jax_analytics.cluster_analytics(alloc, req, valid),
                          f"trial {trial}")


def test_twin_on_an_empty_cluster_and_the_known_cluster():
    zeros = np.zeros((16, 8), np.float32)
    d = analytics.analytics_to_dict(_twin(zeros, zeros, np.zeros(16, bool)))
    assert d["nodes"] == 0 and d["fragmentation"] == 0.0
    assert sum(d["occupancy"]) == 0
    a, r, v = dict(CPU_CASES)["known"]
    d = analytics.analytics_to_dict(_twin(a, r, v))
    assert d == jax_analytics.analytics_to_dict(
        jax_analytics.cluster_analytics(a, r, v))
    assert d["nodes"] == 3 and d["occupancy"][5] == 1
    assert d["stranded"] == {"cpu": 2000.0, "memory": 4.0}


def test_twin_on_encoder_snapshots_with_a_recycled_row():
    """Both packages' encoders after node adds, pod commits and a node
    removal: the same snapshot, the same analytics."""
    from kubernetes_tpu.codec import SnapshotEncoder as JaxEncoder
    from kubernetes_tpu_torch.api import factory
    from kubernetes_tpu_torch.codec import SnapshotEncoder as PortEncoder

    snaps = []
    for enc, mk_node, mk_pod in (
            (JaxEncoder(), fixtures.make_node, fixtures.make_pod),
            (PortEncoder(), factory.make_node, factory.make_pod)):
        enc.add_nodes([mk_node(f"n-{i}", cpu="8", mem="16Gi", pods=10)
                       for i in range(6)])
        for i in range(8):
            enc.add_pod(mk_pod(f"p-{i}", cpu="1", mem="1Gi",
                               node_name=f"n-{i % 6}"))
        enc.remove_node("n-3")
        s = enc.snapshot()
        snaps.append((np.asarray(s.allocatable), np.asarray(s.requested),
                      np.asarray(s.valid)))
    for x, y in zip(*snaps):
        assert np.array_equal(x, y)
    tw = _twin(*snaps[1])
    _assert_bit_equal(_twin_np(tw), jax_analytics.cluster_analytics(
        *snaps[0]), "encoder snapshot")
    d = analytics.analytics_to_dict(tw)
    assert d["nodes"] == 5 and d["pods_running"] == 7.0


@pytest.mark.parametrize("name", ["known", "random-257", "signed-zero-100",
                                  "full-width"])
def test_pack_dict_and_dispatcher(name):
    a, r, v = dict(CPU_CASES)[name]
    ts = [torch.from_numpy(np.ascontiguousarray(x)) for x in (a, r, v)]
    tw = analytics.cluster_analytics_plain(*ts)
    buf = analytics.cluster_analytics(*ts)
    assert buf.dtype == torch.int32 and buf.shape == (analytics.PACKED_WORDS,)
    assert torch.equal(buf, analytics.pack(tw))
    _assert_bit_equal(analytics.unpack(buf.numpy()), _twin_np(tw), "unpack")
    _assert_bit_equal(_twin_np(analytics.unpack(buf)), _twin_np(tw),
                      "unpack of a tensor")
    assert analytics.analytics_to_dict(tw) == jax_analytics.analytics_to_dict(
        jax_analytics.cluster_analytics(a, r, v))


def test_kernel_wrapper_takes_cuda_tensors_only():
    a, r, v = (torch.from_numpy(np.ascontiguousarray(x))
               for x in dict(CPU_CASES)["known"])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.cluster_analytics(a, r, v)


@pytest.mark.cuda
def test_k5_bit_identical_to_twin_on_the_card():
    """K5 against its twin on every case (chip_smoke.py phase K5 runs the
    same check with the timings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU mode")
    for name, (a, r, v) in k5_cases.cases():
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in (a, r, v)]
        got = kernels.cluster_analytics(*(t.cuda() for t in host)).cpu()
        want = analytics.pack(analytics.cluster_analytics_plain(*host))
        assert torch.equal(got, want), name


# -------------------------------------------------------- SLO and the hub


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def test_slo_evaluator_matches_the_reference():
    """The same synthetic history through both evaluators: equal burn
    rates, newly fired alerts and snapshots at every step."""
    objs = [dict(name="o", objective=0.9, fastWindowSeconds=10.0,
                 slowWindowSeconds=100.0),
            dict(name="p", objective=0.99, fastWindowSeconds=5.0,
                 slowWindowSeconds=30.0, burnThreshold=2.0)]
    clocks = (_Clock(), _Clock())
    evs = (telemetry.SLOEvaluator(telemetry.build_objectives(objs),
                                  clock=clocks[0]),
           jax_telemetry.SLOEvaluator(jax_telemetry.build_objectives(objs),
                                      clock=clocks[1]))
    rng = np.random.default_rng(5)
    for step in range(200):
        dt = float(rng.choice([0.5, 1.0, 7.0, 40.0]))
        good, bad = float(rng.integers(0, 10)), float(rng.integers(0, 4))
        name = "o" if step % 3 else "p"
        out = []
        for clk, ev in zip(clocks, evs):
            clk.t += dt
            ev.observe(name, good=good, bad=bad)
            out.append((ev.burn_rates("o"), ev.burn_rates("p"),
                        ev.evaluate(), ev.snapshot(), ev.alerts_total))
        assert out[0] == out[1], step
    assert evs[0].alerts_total > 0
    assert telemetry.build_objectives(None) == tuple(
        telemetry.SLOObjective(o.name, o.objective, o.fast_window_s,
                               o.slow_window_s, o.burn_threshold)
        for o in jax_telemetry.DEFAULT_OBJECTIVES)


def test_hub_interval_ring_and_ewma_match_the_reference():
    """Both hubs under one injected clock, fed the same cycles: the same
    samples (cycle, source, analytics) at the same calls, the same EWMA per
    width and pruning, SLO postmortems and accounting.  Where a due cycle
    has no resident snapshot the JAX hub takes its host route and the
    port's drops the sample, counted; every other sample is the same."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    pm = ([], [])
    clocks = (_Clock(), _Clock())
    hubs = (
        telemetry.TelemetryHub(interval_cycles=3, ring_capacity=4,
                               postmortem=lambda t, d: pm[0].append(t),
                               clock=clocks[0], device="cpu"),
        jax_telemetry.TelemetryHub(interval_cycles=3, ring_capacity=4,
                                   postmortem=lambda t, d: pm[1].append(t),
                                   clock=clocks[1]),
    )
    seen = ([], [])
    for cycle in range(14):
        a, r, v = k5_cases._random(rng, 37 + cycle)
        route = "host" if cycle % 5 == 4 else "device"
        for k, (clk, hub) in enumerate(zip(clocks, hubs)):
            clk.t += 0.5
            hub.note_launch(64 if cycle % 2 else 128, 0.001 * (cycle + 1))
            if cycle == 13:
                hub.prune_widths([64])
            kw = {}
            if route == "device":
                kw["resident"] = (
                    (torch.from_numpy(a), torch.from_numpy(r),
                     torch.from_numpy(v)) if k == 0
                    else (jnp.asarray(a), jnp.asarray(r), jnp.asarray(v)))
            elif k == 1:
                kw["host_snapshot"] = (a, r, v)
            before = hub.samples_total
            hub.on_cycle(cycle=cycle, tier="bulk", cycle_s=0.01,
                         placed=3, unschedulable=1, shed=cycle % 3,
                         deadline_s=0.005, **kw)
            if hub.samples_total > before:
                s = hub._ring[-1]
                seen[k].append((cycle, s["cycle"], s["source"],
                                s["analytics"]))
    # due cycles 0, 3, 6, 9, 12; cycle 9 has no resident snapshot, so the
    # JAX host sample the call of cycle 12 reads is the port's drop
    assert len(seen[1]) == 4 and seen[1][3][1:3] == (9, "host")
    assert seen[0] == seen[1][:3]
    assert {s[2] for s in seen[0]} == {"device"}
    assert hubs[0].samples_dropped == 1
    summaries = [h.summary() for h in hubs]
    for key in ("analytics", "cycle", "cycles", "launch_ewma_s", "slo"):
        assert summaries[0][key] == summaries[1][key], key
    assert summaries[0]["cycle"] == 12
    assert summaries[0]["samples"] == summaries[1]["samples"] - 1 == 4
    assert summaries[0]["samples_dropped"] == 1
    assert summaries[0]["launch_ewma_s"].keys() == {"64"}
    assert len(hubs[0]._ring) == 4 and len(hubs[1]._ring) == 4
    assert [s["cycle"] for s in hubs[0]._ring] == [0, 3, 6, 12]
    assert pm[0] == pm[1] and pm[0] and set(pm[0]) == {"slo_burn"}


def test_device_memory_and_compile_stats_on_the_cpu():
    assert telemetry.device_memory_stats("cpu") == {}
    assert telemetry.device_memory_stats(None) == {}
    stats = telemetry.compile_stats()
    assert set(stats) == {"cache_hits", "cache_misses", "compile_seconds"}


def test_a_faulted_sample_is_counted_not_raised(monkeypatch):
    hub = telemetry.TelemetryHub(interval_cycles=1, device="cpu")
    a, r, v = (torch.from_numpy(np.ascontiguousarray(x))
               for x in dict(CPU_CASES)["known"])

    def boom(*args):
        raise RuntimeError("injected launch failure")

    kw = dict(tier="bulk", cycle_s=0.0, placed=1, unschedulable=0)
    hub.on_cycle(cycle=0, resident=(a, r, v), **kw)
    monkeypatch.setattr(telemetry, "cluster_analytics", boom)
    hub.on_cycle(cycle=1, resident=(a, r, v), **kw)   # dispatch faults
    assert hub.samples_dropped == 1 and hub.samples_total == 1
    monkeypatch.undo()
    hub.on_cycle(cycle=2, resident=(a, r, v), **kw)
    monkeypatch.setattr(telemetry.PinnedCopy, "result", boom)
    assert hub.summary()["samples_dropped"] == 2       # read faults
    assert hub.samples_total == 1 and hub.analytics_cycle == 0


# ------------------------------------------------ the Scheduler, end to end


def test_default_config_constructs_and_schedules():
    """The reference's default SchedulerConfig with cpu_fallback off runs
    on the port: telemetry at interval 1, the timeline, quality top-3."""
    assert [w for w, _ in refused_settings(SchedulerConfig())] == [
        "cpu_fallback=True"]
    cfg = SchedulerConfig(cpu_fallback=False, batch_window_s=0.0)
    sched = Scheduler(cache=SchedulerCache(loop.build_encoder(
        loop.bench_nodes(16))), queue=PriorityQueue(), config=cfg,
        device="cpu")
    assert sched.telemetry is telemetry.get_default()
    assert sched.timeline is port_timeline.get_default()
    for i in range(24):
        sched.queue.add(loop.pending_pod(i))
    assert sched.run_once(timeout=0.0) == 24
    s = sched.telemetry.summary()
    # the snapshot the (unpipelined) cycle was dispatched against
    assert s["samples"] == 1 and s["analytics"]["nodes"] == 16
    assert s["analytics"]["pods_running"] == 0.0
    assert sched.timeline.samples_total == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Scheduler(config=SchedulerConfig(cpu_fallback=False))


@functools.lru_cache(maxsize=None)
def _jax_run(case, interval):
    n, p, b, wl, pipe, existing, node_pods = case
    out = jax_live(n, p, b, wl, pipeline=pipe, existing=existing,
                   node_pods=node_pods, quality_top_k=3,
                   quality_interval_cycles=1, telemetry=True,
                   telemetry_interval_cycles=interval)
    sched = out[4]
    return (out[0], out[1], loop.telemetry_arrays(sched.telemetry_record),
            loop.quality_arrays(sched.quality_record))


def _port_run(case, interval, telemetry_on=True):
    n, p, b, wl, pipe, existing, node_pods = case
    return loop.run_live(loop.bench_nodes(n, node_pods), p, b, wl,
                         device="cpu", pipeline=pipe, existing=existing,
                         quality_top_k=3, quality_interval_cycles=1,
                         telemetry=telemetry_on,
                         telemetry_interval_cycles=interval)


def _assert_arrays_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == np.float64:
            assert np.array_equal(g, w, equal_nan=True), k
        else:
            assert np.array_equal(_bits(g), _bits(w)), k


LIVE_CASES = [
    # (n_nodes, n_pods, batch, workload, pipeline, existing, node_pods)
    (200, 500, 64, "plain", True, 0, 110),
    (200, 500, 64, "plain", False, 0, 110),
    (160, 400, 64, "pod-anti-affinity", True, 100, 110),
    (150, 360, 64, "plain", True, 0, 2),
]


@pytest.mark.parametrize("interval", [1, 4])
@pytest.mark.parametrize(
    "case", LIVE_CASES,
    ids=[f"{c[3]}-{'pipe' if c[4] else 'sync'}-ex{c[5]}-slots{c[6]}"
         for c in LIVE_CASES])
def test_scheduler_telemetry_matches_jax_scheduler(case, interval):
    hosts, order, want, want_q = _jax_run(case, interval)
    res = _port_run(case, interval)
    np.testing.assert_array_equal(res["hosts"], hosts)
    np.testing.assert_array_equal(res["bind_order"], order)
    got = loop.telemetry_arrays(res["telemetry_record"])
    _assert_arrays_equal(got, want)
    _assert_arrays_equal(loop.quality_arrays(res["quality_record"]), want_q)
    assert set(got["sample_source"].tolist()) == {"device"}
    assert res["telemetry"]["samples_dropped"] == 0
    cycles = res["scheduler"].telemetry.cycles_total
    assert len(got["sample_cycle"]) == -(-cycles // interval)
    # the drift detectors were fed the telemetry series
    assert (got["drift_samples"][-1, 1:] > 0).all()


@pytest.mark.parametrize("pipeline", [True, False])
def test_each_sample_reflects_the_snapshot_resident_at_its_hook(pipeline):
    """A sample is the resident snapshot as of its cycle's telemetry hook:
    with pipeline_commit, the snapshot the NEXT cycle was dispatched
    against (it already holds this cycle's commits), except at the final
    flush; without it, the cycle's own.  Held against the numpy reference
    over the host snapshot each dispatch uploaded."""
    sched = Scheduler(
        cache=SchedulerCache(loop.build_encoder(loop.bench_nodes(64))),
        queue=PriorityQueue(), device="cpu",
        config=loop.live_config(32, pipeline=pipeline, telemetry=True))
    uploaded, dispatched = [], []
    update = sched._dev_snapshot.update

    def uploading(cluster, **kw):
        uploaded.append((cluster.allocatable, cluster.requested,
                         cluster.valid))
        return update(cluster, **kw)

    sched._dev_snapshot.update = uploading
    dispatch = sched._encode_and_dispatch

    def recording(pods, **kw):
        n = len(uploaded)
        inf = dispatch(pods, **kw)
        if inf is not None:
            assert len(uploaded) == n + 1
            dispatched.append((inf.cycle, uploaded[-1]))
        return inf

    sched._encode_and_dispatch = recording
    at_hook = {}
    hub = sched.telemetry
    on_cycle = hub.on_cycle

    def hooked(**kw):
        at_hook[kw["cycle"]] = dispatched[-1]
        on_cycle(**kw)

    hub.on_cycle = hooked
    for i in range(150):
        sched.queue.add(loop.pending_pod(i))
    while sched.run_once(timeout=0.0) or sched.pipeline_pending:
        pass
    sched.flush_pipeline()
    hub.summary()
    cycles = [c for c, _ in dispatched]
    assert len(cycles) == 5
    for k, c in enumerate(cycles):
        want = cycles[k + 1] if pipeline and k + 1 < len(cycles) else c
        assert at_hook[c][0] == want, (c, at_hook[c][0])
    samples = list(hub._ring)
    assert [s["cycle"] for s in samples] == cycles
    for s in samples:
        snap = at_hook[s["cycle"]][1]
        assert s["analytics"] == analytics.analytics_to_dict(
            analytics.cluster_analytics_np(*snap))
    placed_before = np.cumsum([0] + [32] * 4)
    pods = [s["analytics"]["pods_running"] for s in samples]
    if pipeline:
        assert pods == [32.0, 64.0, 96.0, 128.0, 128.0]
    else:
        assert pods == placed_before.astype(float).tolist()


def test_no_process_default_outlives_its_test():
    """A JAX and a port Scheduler with telemetry and the timeline on leave
    neither package's process defaults changed once the fixture's
    context closes."""
    from kubernetes_tpu.runtime import timeline as jax_timeline

    regs = (jax_telemetry._DEFAULT, jax_timeline._DEFAULT,
            telemetry._DEFAULT, port_timeline._DEFAULT)
    before = [(d._default, dict(d._replicas)) for d in regs]
    with process_state_kept():
        jax_live(32, 40, 16, telemetry=True, timeline=True)
        loop.run_live(loop.bench_nodes(32), 40, 16, device="cpu",
                      telemetry=True, timeline=True)
        assert all(d._default is not None for d in regs)
    assert [(d._default, dict(d._replicas)) for d in regs] == before


def test_telemetry_off_leaves_the_bindings_unchanged():
    case = LIVE_CASES[0]
    on, off = _port_run(case, 1), _port_run(case, 1, telemetry_on=False)
    np.testing.assert_array_equal(on["hosts"], off["hosts"])
    np.testing.assert_array_equal(on["bind_order"], off["bind_order"])
    assert "telemetry" in on and "telemetry" not in off
    assert off["scheduler"].telemetry is None


def test_live_default_golden_file():
    """The full-width golden chip_smoke.py phase 15 reads: every pod bound,
    one device sample a committed cycle, the drift state of every cycle."""
    data = np.load(golden_path("live_default"))
    assert data["hosts"].shape == (12048,) and (data["hosts"] >= 0).all()
    assert sorted(data["bind_order"].tolist()) == list(range(12048))
    n = len(data["sample_cycle"])
    assert n == len(data["cycle_pods"]) == len(data["drift_fast"]) == 6
    assert set(data["sample_source"].tolist()) == {"device"}
    assert data["utilization"].shape == (n, 4, 5)
    assert (data["sample_nodes"] == 5000).all()
    # the last sample is the final batch's own dispatch snapshot: the
    # warmup and four full batches committed, 1,808 pods still to come
    assert data["pods_running"][-1] == 2048.0 + 4 * 2048
    assert len(data["regret_cycle"]) == 1
