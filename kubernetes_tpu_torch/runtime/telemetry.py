"""Cluster + device telemetry hub and multi-window SLO burn alerting
(PyTorch port of the JAX package's runtime/telemetry.py).

  * **Cluster analytics.**  Every `interval_cycles` committed cycles the
    hub launches ops/analytics.cluster_analytics over the
    DEVICE-RESIDENT snapshot tensors (DeviceSnapshotCache.resident): kernel
    K5 on the card, on the stream the snapshot's in-place scatter uses, so
    it reads the tensors as of the hook's call.  Its 40-word output is
    copied into pinned host memory behind the launch with a CUDA event
    after it, and read one interval later in `_materialize_pending`, so the
    scheduling thread never waits on the analytics.  A sample is taken
    only from the resident tensors: the reference's host route (numpy
    over the cycle's host snapshot once a fault dropped the resident
    copy) is not ported, so that the card never hands its work to the
    CPU.  A due sample with no resident snapshot, or whose launch or
    read faults, is lost and counted in `samples_dropped`.
  * **Device runtime.**  `device_memory_stats`: the scheduler's CUDA
    device's allocator bytes in use and peak (torch.cuda.memory_stats) and
    its memory size (torch.cuda.mem_get_info); {} for a CPU device, as the
    reference reports nothing on XLA:CPU.  `compile_stats` keeps the
    reference's keys, which here describe the build of the port's kernel
    library (kernels/_build.py; there is no jit compile cache):
    `cache_misses` counts builds that compiled the library in this
    process, `cache_hits` loads of a library an earlier process built,
    `compile_seconds` the seconds those took; all 0 until a CUDA path
    needed the library.  A launch-duration EWMA per encoded batch width.
  * **SLO burn rates.**  The SRE-workbook multi-window scheme: each
    objective tracks good/bad events over a FAST and a SLOW window;
    burn = (bad fraction) / (error budget).  An alert fires when BOTH
    windows exceed the threshold, incrementing
    scheduler_slo_burn_alerts_total and dumping a throttled `slo_burn`
    flight-recorder postmortem through the scheduler's seam; the alert
    re-arms when the fast window recovers.

Samples land in a bounded ring.  `get_default` / `set_default` follow the
flight recorder's pattern (runtime/defaults.py): a Scheduler built with
config.telemetry installs its hub as the process default.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kubernetes_tpu_torch.codec.transfer import PinnedCopy
from kubernetes_tpu_torch.ops.analytics import (
    analytics_to_dict,
    cluster_analytics,
    unpack,
)
from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils import metrics as m

# the snapshot fields the analytics launch consumes, in kernel-argument
# order (DeviceSnapshotCache.resident is keyed on these names)
ANALYTICS_FIELDS = ("allocatable", "requested", "valid")


def device_memory_stats(device=None) -> Dict[str, Dict[str, int]]:
    """{device index: {in_use, peak, limit}} of a CUDA device from the
    caching allocator's counters and the device's memory size, updating
    the ktpu_device_hbm_bytes gauges.  A CPU device (or none) yields {}."""
    out: Dict[str, Dict[str, int]] = {}
    if device is None or torch.device(device).type != "cuda":
        return out
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(idx)
    _, total = torch.cuda.mem_get_info(idx)
    entry = {
        "in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak": int(stats.get("allocated_bytes.all.peak", 0)),
        "limit": int(total),
    }
    out[str(idx)] = entry
    for kind, v in entry.items():
        m.DEVICE_HBM.set(v, device=str(idx), kind=kind)
    return out


def compile_stats() -> dict:
    """The reference's compile keys, read as the kernel library's build
    (see the module docstring)."""
    from kubernetes_tpu_torch.kernels._build import BUILD_STATS

    return {
        "cache_hits": int(BUILD_STATS["loads"]),
        "cache_misses": int(BUILD_STATS["builds"]),
        "compile_seconds": round(float(BUILD_STATS["seconds"]), 3),
    }


# ------------------------------------------------------------------- SLO


@dataclass(frozen=True)
class SLOObjective:
    """One service-level objective watched by the burn evaluator.

    `objective` is the target GOOD fraction (0.99 = a 1% error budget);
    burn rate = observed bad fraction / (1 - objective), so burn 1.0
    means spending the budget exactly as fast as allowed."""

    name: str
    objective: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 1.0

    @staticmethod
    def from_dict(d: dict) -> "SLOObjective":
        """The KubeSchedulerConfiguration `sloObjectives` entry shape."""
        return SLOObjective(
            name=str(d["name"]),
            objective=float(d.get("objective", 0.99)),
            fast_window_s=float(d.get("fastWindowSeconds", 60.0)),
            slow_window_s=float(d.get("slowWindowSeconds", 300.0)),
            burn_threshold=float(d.get("burnThreshold", 1.0)),
        )


# the objectives a telemetry-enabled scheduler watches by default:
#  * cycle_deadline — cycles finishing inside cycleDeadlineSeconds
#    (observed only when a deadline is configured)
#  * goodput — offered pods served (scheduled OR a verdict) vs shed
#  * degraded — cycles served by the device fast path vs a fallback
DEFAULT_OBJECTIVES: Tuple[SLOObjective, ...] = (
    SLOObjective("cycle_deadline", objective=0.99),
    SLOObjective("goodput", objective=0.99),
    SLOObjective("degraded", objective=0.99),
)


def build_objectives(raw: Optional[list]) -> Tuple[SLOObjective, ...]:
    """Config `sloObjectives` (list of dicts) -> objectives; None/empty
    keeps the defaults."""
    if not raw:
        return DEFAULT_OBJECTIVES
    return tuple(
        o if isinstance(o, SLOObjective) else SLOObjective.from_dict(o)
        for o in raw
    )


class _Window:
    """One rolling window: a deque of (t, good, bad) plus RUNNING sums
    maintained on add/expiry, so a burn-rate read is O(1)."""

    __slots__ = ("seconds", "events", "good", "bad")

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.events: deque = deque()
        self.good = 0.0
        self.bad = 0.0

    def add(self, t: float, good: float, bad: float) -> None:
        self.events.append((t, good, bad))
        self.good += good
        self.bad += bad

    def prune(self, now: float) -> None:
        horizon = now - self.seconds
        ev = self.events
        while ev and ev[0][0] < horizon:
            _, g, b = ev.popleft()
            self.good -= g
            self.bad -= b
        if not ev:
            # zero the sums whenever the window empties so float
            # accumulation error cannot drift them over long uptimes
            self.good = 0.0
            self.bad = 0.0

    def burn(self, budget: float) -> float:
        total = self.good + self.bad
        frac = self.bad / total if total > 0 else 0.0
        return frac / budget


class SLOEvaluator:
    """Multi-window burn-rate math over per-objective good/bad event
    streams.  Thread-safe; `clock` keeps the window tests deterministic."""

    def __init__(
        self,
        objectives: Tuple[SLOObjective, ...] = DEFAULT_OBJECTIVES,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.objectives: Dict[str, SLOObjective] = {
            o.name: o for o in objectives
        }
        self._clock = clock
        self._lock = threading.Lock()
        self._windows: Dict[str, Tuple[_Window, _Window]] = {
            name: (_Window(o.fast_window_s), _Window(o.slow_window_s))
            for name, o in self.objectives.items()
        }
        # alert hysteresis: fire once on crossing, re-arm when the FAST
        # window recovers
        self._alert_active: Dict[str, bool] = {}
        # last rates computed by evaluate(), reused by snapshot()
        self._last_rates: Dict[str, Tuple[float, float]] = {}
        self.alerts_total = 0

    def observe(self, name: str, good: float = 0.0, bad: float = 0.0,
                t: Optional[float] = None) -> None:
        """Record `good` successes and `bad` budget-burning events for
        one objective (unknown names are ignored)."""
        windows = self._windows.get(name)
        if windows is None or (good == 0.0 and bad == 0.0):
            return
        now = self._clock() if t is None else t
        with self._lock:
            for w in windows:
                w.add(now, float(good), float(bad))
                w.prune(now)

    def burn_rates(self, name: str,
                   t: Optional[float] = None) -> Tuple[float, float]:
        """(fast, slow) burn rates for one objective; 0.0 with no
        events."""
        obj = self.objectives[name]
        now = self._clock() if t is None else t
        budget = max(1.0 - obj.objective, 1e-9)
        fast, slow = self._windows[name]
        with self._lock:
            fast.prune(now)
            slow.prune(now)
            return fast.burn(budget), slow.burn(budget)

    def evaluate(self, t: Optional[float] = None) -> List[Tuple[str, float, float]]:
        """Update every objective's burn gauges; return the objectives
        whose alert NEWLY fired (both windows over threshold while the
        alert was armed)."""
        fired: List[Tuple[str, float, float]] = []
        for name, obj in self.objectives.items():
            fast, slow = self.burn_rates(name, t)
            self._last_rates[name] = (fast, slow)
            m.SLO_BURN_RATE.set(fast, objective=name, window="fast")
            m.SLO_BURN_RATE.set(slow, objective=name, window="slow")
            burning = (
                fast >= obj.burn_threshold and slow >= obj.burn_threshold
            )
            if burning and not self._alert_active.get(name, False):
                self._alert_active[name] = True
                self.alerts_total += 1
                m.SLO_ALERTS.inc(objective=name)
                fired.append((name, fast, slow))
            elif fast < obj.burn_threshold:
                self._alert_active[name] = False
        return fired

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{objective: {fast, slow, threshold, objective}} for samples,
        from evaluate()'s cached rates when available."""
        out: Dict[str, Dict[str, float]] = {}
        for name, obj in self.objectives.items():
            cached = self._last_rates.get(name)
            fast, slow = (
                cached if cached is not None else self.burn_rates(name)
            )
            out[name] = {
                "fast": round(fast, 4),
                "slow": round(slow, 4),
                "threshold": obj.burn_threshold,
                "objective": obj.objective,
            }
        return out


# ------------------------------------------------------------------- hub


class TelemetryHub:
    """Per-scheduler telemetry aggregation point.

    The scheduling thread calls `on_cycle` once per committed cycle
    (runtime/scheduler.py stamps the call's cost into
    scheduler_telemetry_seconds_total); readers come from other threads
    and take the hub lock only around ring/summary state.

    Analytics cadence is AMORTIZED: on each due cycle the hub first
    materializes the launch dispatched one interval ago and only then
    dispatches the next.  `device` (the card unless the caller passes
    "cpu") is the scheduler's (where the memory
    statistics are read)."""

    def __init__(
        self,
        interval_cycles: int = 1,
        objectives: Tuple[SLOObjective, ...] = DEFAULT_OBJECTIVES,
        ring_capacity: int = 512,
        postmortem: Optional[Callable[[str, str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        ewma_alpha: float = 0.2,
        device="cuda",
    ):
        self.interval_cycles = max(1, int(interval_cycles))
        self.slo = SLOEvaluator(objectives, clock=clock)
        self.device = torch.device(device)
        self._postmortem = postmortem
        self._clock = clock
        self._ewma_alpha = float(ewma_alpha)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring_capacity)))
        # in-flight analytics: (cycle, tier, the PinnedCopy of the packed
        # sample)
        self._pending: Optional[Tuple[int, str, PinnedCopy]] = None
        self.analytics: Optional[dict] = None  # last materialized sample
        self.analytics_cycle = -1
        self.samples_total = 0
        # samples lost: no resident snapshot at their hook, or a fault in
        # their launch or its read
        self.samples_dropped = 0
        self._cycles_since_dispatch = self.interval_cycles  # first is due
        self._launch_ewma: Dict[int, float] = {}
        self._pressure: Optional[Dict[str, int]] = None
        self.last_hbm: Dict[str, Dict[str, int]] = {}
        # mesh/ladder facts stamped by the scheduler every committed cycle
        self._mesh: Optional[dict] = None
        self.cycles_total = 0

    # ------------------------------------------------------ hot-path API

    def note_launch(self, width: int, seconds: float) -> None:
        """Fold one device launch window (dispatch -> copy-complete)
        into the per-width EWMA."""
        with self._lock:
            prev = self._launch_ewma.get(width)
            cur = (
                seconds if prev is None
                else prev + self._ewma_alpha * (seconds - prev)
            )
            self._launch_ewma[width] = cur
        m.LAUNCH_EWMA.set(cur, width=str(width))

    def prune_widths(self, keep) -> None:
        """Retire EWMA series for widths no longer dispatchable."""
        keep = set(int(w) for w in keep)
        with self._lock:
            stale = [w for w in self._launch_ewma if w not in keep]
            for w in stale:
                del self._launch_ewma[w]
        for w in stale:
            m.LAUNCH_EWMA.remove(width=str(w))

    def _ewma_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                str(w): round(s, 6)
                for w, s in sorted(self._launch_ewma.items())
            }

    def on_cycle(
        self,
        cycle: int,
        tier: str,
        cycle_s: float,
        placed: int,
        unschedulable: int,
        shed: int = 0,
        degraded: bool = False,
        deadline_s: float = 0.0,
        resident: Optional[tuple] = None,
        span=None,
    ) -> None:
        """One committed scheduling cycle's telemetry: SLO events, burn
        evaluation (slo_burn postmortems through the scheduler's seam),
        and the amortized analytics launch.  `resident` is
        DeviceSnapshotCache.resident(ANALYTICS_FIELDS); None (a fault
        dropped the resident snapshot) loses this interval's sample."""
        self.cycles_total += 1
        now = self._clock()
        if deadline_s > 0:
            over = cycle_s > deadline_s
            self.slo.observe(
                "cycle_deadline", good=0.0 if over else 1.0,
                bad=1.0 if over else 0.0, t=now,
            )
        served = placed + unschedulable
        self.slo.observe("goodput", good=float(served), bad=float(shed),
                         t=now)
        self.slo.observe(
            "degraded", good=0.0 if degraded else 1.0,
            bad=1.0 if degraded else 0.0, t=now,
        )
        for name, fast, slow in self.slo.evaluate(now):
            if self._postmortem is not None:
                self._postmortem(
                    "slo_burn",
                    f"objective {name}: burn fast={fast:.1f} "
                    f"slow={slow:.1f} >= "
                    f"{self.slo.objectives[name].burn_threshold}",
                )
        self._cycles_since_dispatch += 1
        if self._cycles_since_dispatch < self.interval_cycles:
            return
        self._cycles_since_dispatch = 0
        # materialize the PREVIOUS interval's launch, then dispatch the next
        sample = self._materialize_pending()
        if sample is not None and span is not None:
            span.annotate(
                cluster_util_cpu=sample["analytics"]["utilization"]["cpu"][
                    "mean"
                ],
                cluster_fragmentation=sample["analytics"]["fragmentation"],
            )
        if resident is None:
            self._drop("dispatch", cycle, "no resident snapshot")
            return
        try:
            out = PinnedCopy(cluster_analytics(*resident))
        except Exception as e:  # noqa: BLE001 — a faulted launch
            # costs one sample, never the cycle; the loss is counted
            self._drop("dispatch", cycle, e)
            return
        with self._lock:
            self._pending = (cycle, tier, out)

    def record_mesh(
        self,
        width: int,
        full_width: int = 0,
        rung: str = "single_chip",
        shard_states: Optional[Dict[int, str]] = None,
        invariants: Optional[dict] = None,
    ) -> None:
        """Per-cycle ladder facts from the scheduler, joined into every
        sample and the summary."""
        with self._lock:
            self._mesh = {
                "width": int(width),
                "full_width": int(full_width),
                "rung": rung,
                "shards": (
                    {str(k): v for k, v in shard_states.items()}
                    if shard_states else None
                ),
                "invariants": invariants,
            }

    def record_pressure(self, bulk: int, express: int, parked: int) -> None:
        """Per-tier pending pressure (queue depths, stamped by the
        scheduler alongside on_cycle)."""
        m.PENDING_PRESSURE.set(float(bulk), tier="bulk")
        m.PENDING_PRESSURE.set(float(express), tier="express")
        m.PENDING_PRESSURE.set(float(parked), tier="parked")
        with self._lock:
            self._pressure = {
                "bulk": int(bulk), "express": int(express),
                "parked": int(parked),
            }

    # ------------------------------------------------------ materialize

    def _drop(self, where: str, cycle: int, err) -> None:
        with self._lock:
            self.samples_dropped += 1
        klog.errorf("telemetry sample of cycle %d dropped at %s: %s",
                    cycle, where, err)

    def _materialize_pending(self) -> Optional[dict]:
        """Read the in-flight analytics launch (if any) into a ring
        sample, updating the cluster gauges."""
        with self._lock:  # readers race the scheduling thread here
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        cycle, tier, out = pending
        try:
            host = unpack(out.result())
        except Exception as e:  # noqa: BLE001 — a faulted launch loses
            #                     one sample, counted, never the stream
            self._drop("read", cycle, e)
            return None
        a = analytics_to_dict(host)
        self._set_cluster_gauges(a)
        sample = {
            "time": time.time(),
            "cycle": cycle,
            "tier": tier,
            "source": "device",
            "analytics": a,
            "pending": self._pressure,
            "mesh": self._mesh,
            "hbm": device_memory_stats(self.device),
            "compile": compile_stats(),
            "launch_ewma_s": self._ewma_snapshot(),
            "slo": self.slo.snapshot(),
        }
        with self._lock:
            self.last_hbm = sample["hbm"]
            self.analytics = a
            self.analytics_cycle = cycle
            self._ring.append(sample)
            self.samples_total += 1
        m.TELEMETRY_SAMPLES.inc()
        return sample

    @staticmethod
    def _set_cluster_gauges(a: dict) -> None:
        for res, stats in a["utilization"].items():
            for stat, v in stats.items():
                m.CLUSTER_UTILIZATION.set(v, resource=res, stat=stat)
        for res, v in a["largest_free"].items():
            m.CLUSTER_LARGEST_FREE.set(v, resource=res)
        for res, v in a["stranded"].items():
            m.CLUSTER_STRANDED.set(v, resource=res)
        m.CLUSTER_FRAGMENTATION.set(a["fragmentation"])
        m.CLUSTER_IMBALANCE.set(a["imbalance"])
        for i, n in enumerate(a["occupancy"]):
            m.CLUSTER_OCCUPANCY.set(float(n), decile=str(i))
        m.CLUSTER_NODES.set(float(a["nodes"]))
        m.CLUSTER_PODS_RUNNING.set(a["pods_running"])

    # ----------------------------------------------------------- readers

    def hbm_in_use(self) -> int:
        """Total live bytes from the last sample (0 on a CPU device)."""
        with self._lock:
            return sum(d.get("in_use", 0) for d in self.last_hbm.values())

    def summary(self) -> dict:
        """Latest materialized analytics + hub accounting (materializes
        the launch in flight first)."""
        self._materialize_pending()
        with self._lock:
            out = {
                "analytics": self.analytics,
                "cycle": self.analytics_cycle,
                "samples": self.samples_total,
                "samples_dropped": self.samples_dropped,
                "cycles": self.cycles_total,
                "pending": self._pressure,
                "mesh": self._mesh,
                "hbm": dict(self.last_hbm),
                "launch_ewma_s": {
                    str(w): round(s, 6)
                    for w, s in sorted(self._launch_ewma.items())
                },
            }
        out["compile"] = compile_stats()
        out["slo"] = self.slo.snapshot()
        return out

    def debug_payload(self, limit: Optional[int] = None) -> dict:
        """The /debug/cluster body (the endpoint itself waits for the
        port's health server): newest samples + the summary."""
        self._materialize_pending()
        with self._lock:
            samples = list(self._ring)
        if limit is not None and limit >= 0:
            samples = samples[-limit:] if limit else []
        return {
            "summary": self.summary(),
            "samples": samples,
            "interval_cycles": self.interval_cycles,
        }


# process-wide default: a Scheduler built with config.telemetry installs
# its own here (replica 0 wins, siblings register alongside)
from kubernetes_tpu_torch.runtime.defaults import ProcessDefault  # noqa: E402

_DEFAULT = ProcessDefault("telemetry", TelemetryHub)


def get_default() -> TelemetryHub:
    return _DEFAULT.get()


def set_default(hub: TelemetryHub, replica: int = 0) -> None:
    _DEFAULT.set(hub, replica)


def replica_instances() -> dict:
    """{replica id: TelemetryHub} of every install this process saw."""
    return _DEFAULT.replicas()


def __getattr__(name):  # legacy alias: telemetry.HUB
    if name == "HUB":
        return _DEFAULT.get()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
