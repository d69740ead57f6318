"""The metrics timeline on the port: runtime/timeline.py against the JAX
package's, store for store and scheduler for scheduler.

  * Both TimelineStores over their own registries holding the same
    families, driven by the same values under an injected clock: the same
    series, kinds and points (counters as deltas with a first-sighting
    baseline, gauges as values, histograms as quantiles and counts), the
    same cadence gating and lag, the same anomalies from threshold, z-score
    and slope rules (edge-triggered, re-armed on recovery), annotations,
    query bodies, JSONL export and HTML report; the default rules stay quiet
    on a healthy trajectory.
  * The port's Scheduler and the JAX Scheduler with the timeline on, on the
    same live workload, each store's clock a fake one: the same unlabeled
    series, and the same points on the series the cycle drives (attempt
    counters, pending pods, telemetry and timeline counters, the cluster
    gauges); no anomaly on this healthy run; the idle poll samples too;
    breaker transitions and postmortems land as annotations.
  * The timeline off leaves the bindings unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest

from kubernetes_tpu.runtime import timeline as jax_timeline
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu_torch import loop
from kubernetes_tpu_torch.codec import faults
from kubernetes_tpu_torch.runtime import timeline
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PriorityQueue
from kubernetes_tpu_torch.runtime.scheduler import Scheduler
from kubernetes_tpu_torch.utils import metrics as port_metrics

from make_torch_golden import jax_live
from torch_port_helpers import process_state_kept


@pytest.fixture(autouse=True)
def _no_process_defaults_left():
    """A Scheduler of either package installs its timeline, hub and
    observatories as process defaults, and a rule that fires counts into
    its package's process-wide anomaly counter, labelled by series name (a
    labelled child's name holds quotes that a later /metrics scrape in the
    same process would print as a malformed label): each goes back to what
    it held before the test."""
    with process_state_kept():
        yield


class _Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class _TickClock:
    """Advances one second at every read: every sweep is due."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


RULES = [
    {"rule": "threshold", "series": "t_errors_total", "op": ">",
     "value": 0.0},
    {"rule": "zscore", "series": "t_depth", "window": 16, "z": 4.0,
     "min_samples": 8},
    {"rule": "slope", "series": "t_backlog", "window": 8, "per_second": 5.0,
     "min_samples": 4},
    {"rule": "threshold", "series": "t_shed_total*", "op": ">=",
     "value": 2.0, "name": "shed"},
]


def _world(mod, metrics, clock):
    reg = metrics.Registry()
    fams = dict(
        errors=reg.register(metrics.Counter("t_errors_total")),
        depth=reg.register(metrics.Gauge("t_depth")),
        backlog=reg.register(metrics.Gauge("t_backlog")),
        lat=reg.register(metrics.Histogram("t_latency_seconds")),
        shed=reg.register(metrics.LabeledCounter(
            "t_shed_total", "", ("reason",))),
    )
    fams["errors"].inc(3.0)   # a total from before the store attached
    pm = []
    store = mod.TimelineStore(
        clock=clock, registry=reg, interval_s=1.0, retention=32,
        detector=mod.AnomalyDetector(
            rules=RULES, postmortem=lambda t, d: pm.append((t, d))))
    return store, fams, pm


def _drive(store, fams, clock, rng_seed=7):
    rng = np.random.default_rng(rng_seed)
    swept = []
    for i in range(90):
        clock.t += float(rng.choice([0.25, 0.5, 1.0, 1.5]))
        fams["depth"].set(5000.0 if 60 <= i < 63 else 50.0 + (i % 7))
        fams["backlog"].set(10.0 if i < 40 else 10.0 + 10.0 * (i - 40))
        fams["lat"].observe(0.001 * (1 + i % 13))
        if i in (20, 21, 70):
            fams["errors"].inc()
        if i % 9 == 0:
            fams["shed"].inc(2.0, reason="full" if i % 2 else "deadline")
        if i == 30:
            store.annotate("breaker", "closed -> open", to="open")
        swept.append(store.maybe_sample())
    return swept


@pytest.mark.parametrize("seed", [7, 19, 31])
def test_store_matches_the_reference(tmp_path, seed):
    clocks = (_Clock(), _Clock())
    worlds = (_world(timeline, port_metrics, clocks[0]),
              _world(jax_timeline, jax_metrics, clocks[1]))
    swept = [_drive(s, f, c, seed) for (s, f, _), c in zip(worlds, clocks)]
    assert swept[0] == swept[1] and 0 < sum(swept[0]) < 90
    (port, _, pm_port), (ref, _, pm_ref) = worlds
    assert port.series_names() == ref.series_names()
    for name in ref.series_names():
        assert port.series_points(name) == ref.series_points(name), name
    assert port.summary() == ref.summary()
    assert port.anomalies() == ref.anomalies()
    assert port.events() == ref.events()
    assert port.detector.snapshot() == ref.detector.snapshot()
    assert pm_port == pm_ref
    fired = {a["rule"] for a in port.anomalies()}
    assert {"threshold", "slope", "shed"} <= fired
    if seed == 7:
        assert "zscore" in fired
    for q in ("", "series=t_depth,t_shed_total*", "window=20&step=3",
              "limit=5"):
        assert port.debug_payload(query=q) == ref.debug_payload(query=q), q
    assert port.debug_payload(limit=2) == ref.debug_payload(limit=2)
    paths = [str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")]
    assert port.export_jsonl(paths[0]) == ref.export_jsonl(paths[1])
    loaded = timeline.load_jsonl(paths[0])
    assert loaded == jax_timeline.load_jsonl(paths[1])
    assert timeline.render_html(loaded) == jax_timeline.render_html(loaded)


def test_default_rules_quiet_on_healthy_run():
    reg = port_metrics.Registry()
    deg = reg.register(port_metrics.Counter(
        "scheduler_degraded_cycles_total"))
    reg.register(port_metrics.Counter("scheduler_invariant_violations_total"))
    pend = reg.register(port_metrics.Gauge("scheduler_pending_pods"))
    deg.inc(3.0)
    clk = _Clock()
    st = timeline.TimelineStore(clock=clk, registry=reg, interval_s=1.0,
                                retention=256,
                                detector=timeline.AnomalyDetector())
    for i in range(128):
        pend.set(50.0 + (i % 7))
        st.maybe_sample()
        clk.t += 1.0
    assert st.detector.anomalies_total == 0 and st.anomalies() == []
    assert timeline.DEFAULT_RULES == jax_timeline.DEFAULT_RULES


# the series the live cycle drives, compared point for point
DRIVEN = (
    'scheduler_schedule_attempts_total{result="scheduled"}',
    "scheduler_pending_pods",
    "scheduler_telemetry_samples_total",
    "scheduler_timeline_samples_total",
    "scheduler_cluster_nodes",
    "scheduler_cluster_pods_running",
    "scheduler_cluster_fragmentation_index",
    'scheduler_cluster_utilization_ratio{resource="cpu",stat="mean"}',
    'scheduler_cluster_utilization_ratio{resource="pods",stat="p99"}',
    'scheduler_cluster_pods_per_node_occupancy_nodes{decile="0"}',
    'scheduler_e2e_scheduling_duration_seconds{tier="bulk"}:count',
    "scheduler_degradation_rung",
)


def _with_tick_clock(sched):
    sched.timeline.clock = _TickClock()
    return sched


def test_scheduler_timeline_matches_jax_scheduler(monkeypatch):
    """Both Schedulers on one live workload, each timeline reading a clock
    that advances a second a read, so each sweep is due: the same sweeps at
    the same points of the cycle."""
    from kubernetes_tpu.runtime import scheduler as jax_sched_mod
    from kubernetes_tpu_torch.runtime import scheduler as port_sched_mod

    stores = {}
    for name, mod in (("port", port_sched_mod), ("jax", jax_sched_mod)):
        orig = mod.Scheduler.__init__

        def init(self, *a, _orig=orig, _name=name, **kw):
            _orig(self, *a, **kw)
            _with_tick_clock(self)
            stores[_name] = self.timeline

        monkeypatch.setattr(mod.Scheduler, "__init__", init)
    n, p, b = 120, 300, 32
    want = jax_live(n, p, b, quality_top_k=3, telemetry=True, timeline=True)
    res = loop.run_live(loop.bench_nodes(n), p, b, device="cpu",
                        quality_top_k=3, telemetry=True, timeline=True)
    np.testing.assert_array_equal(res["hosts"], want[0])
    np.testing.assert_array_equal(res["bind_order"], want[1])
    port, ref = stores["port"], stores["jax"]
    assert port.samples_total == ref.samples_total > 2 * -(-p // b)
    names = set(port.series_names())
    ref_names = set(ref.series_names())
    assert ({s for s in names if "{" not in s}
            == {s for s in ref_names if "{" not in s})
    # a gauge holds what earlier work in the process left until this run
    # sets it, and a labeled child appears when first set: compare every
    # series from the first sweep after a telemetry sample
    tel = port.series_points(DRIVEN[2])
    assert tel == ref.series_points(DRIVEN[2])
    t0 = next(t for t, v in tel if v > 0)
    for s in DRIVEN:
        assert s in names and s in ref_names, s
        pts = [p for p in port.series_points(s) if p[0] >= t0]
        assert pts == [p for p in ref.series_points(s) if p[0] >= t0], s
        assert len(pts) > 2, s
    assert port.detector.anomalies_total == ref.detector.anomalies_total == 0
    assert res["timeline"]["samples"] == port.samples_total


def _small(**kw):
    cfg = loop.live_config(8, timeline=True, **kw)
    return Scheduler(cache=SchedulerCache(loop.build_encoder(
        loop.bench_nodes(16))), queue=PriorityQueue(), config=cfg,
        device="cpu")


def test_idle_poll_samples_and_annotations_land():
    sched = _small()
    clk = _Clock()
    sched.timeline.clock = clk
    assert sched.run_once(timeout=0.0) == 0          # idle: one sweep
    assert sched.timeline.samples_total == 1
    clk.t += 0.5
    sched.run_once(timeout=0.0)                      # inside the cadence
    assert sched.timeline.samples_total == 1
    clk.t += 1.0
    for i in range(8):
        sched.queue.add(loop.pending_pod(i))
    sched.run_once(timeout=0.0)
    sched.flush_pipeline()
    assert sched.timeline.samples_total == 2
    # a persistent fault: the breaker opens, its postmortem and transition
    # land on the timeline
    for i in range(8, 16):
        sched.queue.add(loop.pending_pod(i))
    inj = faults.FaultInjector()
    inj.arm(faults.SITE_DISPATCH, kind=faults.FAULT_PERSISTENT, count=1)
    remove = faults.install_injector(inj)
    try:
        with pytest.raises(faults.PersistentDeviceError):
            sched.run_once(timeout=0.0)
    finally:
        remove()
    kinds = [e["kind"] for e in sched.timeline.events()]
    assert "breaker" in kinds and "postmortem" in kinds


def test_timeline_off_leaves_the_bindings_unchanged():
    on = loop.run_live(loop.bench_nodes(120), 300, 32, device="cpu",
                       telemetry=True, timeline=True)
    off = loop.run_live(loop.bench_nodes(120), 300, 32, device="cpu",
                        telemetry=True, timeline=False)
    np.testing.assert_array_equal(on["hosts"], off["hosts"])
    np.testing.assert_array_equal(on["bind_order"], off["bind_order"])
    assert on["scheduler"].timeline is timeline.get_default()
    assert off["scheduler"].timeline is None and "timeline" not in off
