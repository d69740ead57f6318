"""Placement-quality observatory: margins, regret, packing drift (PyTorch
port of the JAX package's runtime/quality.py).

Three pieces, as in the reference:

  * **In-launch top-k.**  The engines' `quality_topk` variant
    (ops/select.select_topk_batch, kernel K3; models/batched.py and
    models/speculative.py) also returns, per pod, the K best feasible node
    rows with the WINNER PINNED at column 0, their total scores and the
    feasible-candidate count, read off the exact (mask, score, winner)
    state the placement used, so placements are identical with quality on
    and off.  The scheduler copies the three leaves to the host with the
    winners (codec/transfer.py AsyncFetch), so quality costs one more D2H
    copy, never a second sync.

  * **Per-decision records.**  `on_cycle` folds each committed cycle into
    margin (top-1 minus runner-up, normalized) and feasible counts.  Every
    `interval_cycles` committed cycles the cycle's placed pod requests are
    packed first-fit-decreasing into the PRE-CYCLE free capacity
    (models/binpack.py, kernel K4) as a dispatch-now / read-next-interval
    side launch, so the scheduling thread never waits on it, and the
    **regret ratio** (nodes the live placements touched / nodes FFD
    needed) lands in `scheduler_placement_regret`.  A side launch that
    faults costs that sample, never the cycle; the sample is counted in
    `regret_dropped`.

  * **Packing-drift detection.**  A dual-window EWMA step detector per
    series (margin, and the telemetry series utilization_cpu and
    fragmentation, fed the hub's last sample when telemetry is on): a
    fast EWMA stepping away from the slow one past the
    threshold fires `scheduler_quality_drift_alerts_total{series=}` once
    (re-armed when the windows reconverge) plus a throttled
    `quality_drift` flight-recorder postmortem through the scheduler's
    postmortem seam.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from kubernetes_tpu_torch.codec.transfer import PinnedCopy
from kubernetes_tpu_torch.models.binpack import binpack_ffd
from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils import metrics as m

# drift-detector series fed by the scheduler's quality hook
DRIFT_SERIES = ("margin", "utilization_cpu", "fragmentation")


def _p50(values) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), 50))


def normalized_margin(top1, top2):
    """THE margin formula — (top-1 − runner-up) / max(1, |top-1|) —
    shared by the live observatory, its ring examples, and the ledger's
    offline replay recompute (runtime/ledger.py), so the three surfaces
    stay bit-comparable by construction."""
    top1 = np.asarray(top1, np.float32)
    top2 = np.asarray(top2, np.float32)
    return (top1 - top2) / np.maximum(np.abs(top1), 1.0)


class StepDetector:
    """Dual-window EWMA step detector for one quality series.

    A fast EWMA tracks the recent level, a slow EWMA the baseline; a
    relative deviation past `threshold` is a step (drift), fired ONCE
    per excursion (hysteresis: the alert re-arms when the deviation
    falls below threshold/2).  `min_samples` suppresses the warm-up
    where both windows are still converging on the workload's level.
    Deviation is |fast - slow| / max(|slow|, floor) — the floor keeps
    near-zero baselines (an idle cluster's fragmentation) from reading
    every wiggle as a 100x step."""

    __slots__ = ("name", "fast_alpha", "slow_alpha", "threshold",
                 "min_samples", "floor", "fast", "slow", "n", "active",
                 "alerts")

    def __init__(self, name: str, fast_alpha: float = 0.3,
                 slow_alpha: float = 0.03, threshold: float = 0.25,
                 min_samples: int = 32, floor: float = 0.05):
        self.name = name
        self.fast_alpha = float(fast_alpha)
        self.slow_alpha = float(slow_alpha)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.floor = float(floor)
        self.fast: Optional[float] = None
        self.slow: Optional[float] = None
        self.n = 0
        self.active = False
        self.alerts = 0

    def deviation(self) -> float:
        if self.fast is None or self.slow is None:
            return 0.0
        return abs(self.fast - self.slow) / max(abs(self.slow), self.floor)

    def update(self, v: float) -> bool:
        """Fold one sample; True when a drift alert NEWLY fires."""
        v = float(v)
        if self.fast is None:
            self.fast = self.slow = v
        else:
            self.fast += self.fast_alpha * (v - self.fast)
            self.slow += self.slow_alpha * (v - self.slow)
        self.n += 1
        if self.n < self.min_samples:
            return False
        dev = self.deviation()
        if dev > self.threshold and not self.active:
            self.active = True
            self.alerts += 1
            return True
        if dev < self.threshold / 2:
            self.active = False
        return False

    def snapshot(self) -> dict:
        return {
            "fast": round(self.fast, 6) if self.fast is not None else None,
            "slow": round(self.slow, 6) if self.slow is not None else None,
            "deviation": round(self.deviation(), 4),
            "threshold": self.threshold,
            "active": self.active,
            "alerts": self.alerts,
            "samples": self.n,
        }


def _ffd_counterfactual(alloc, used, valid, reqs):
    """The regret side launch: FFD the cycle's PLACED pod requests into
    each node's PRE-CYCLE free capacity (per-bin capacities: a full node
    is a zero row no pod fits; the caller zero-masks pods the live run did
    NOT place, so both sides of the ratio pack the SAME pod set).  FFD
    order is dominant share of the largest free shape, descending, stable.
    Returns (nodes FFD touched, pods FFD placed, real pods) as i32 0-d
    tensors on the inputs' device, without a host sync: on the card the
    scan is kernel K4, around it plain torch.  The JAX program sorts with
    its own sort primitive too; -0.0 keys (zero-request rows) are read as
    0.0, as that sort orders them."""
    f32 = torch.float32
    free = torch.where(
        valid[:, None],
        torch.clamp_min(alloc.to(f32) - used.to(f32), 0.0),
        0.0,
    )
    reqs = reqs.to(f32)
    cap_ref = torch.clamp_min(torch.amax(free, dim=0), 1e-30)
    key = torch.amax(reqs / cap_ref[None, :], dim=-1)
    order = torch.argsort(-key + 0.0, stable=True).to(torch.int32)
    used_bins, _loads, placed = binpack_ffd(
        reqs, free, max_bins=free.shape[0], order=order
    )
    real = torch.any(reqs > 0, dim=-1)
    return (
        used_bins,
        torch.sum(placed & real[order.long()], dtype=torch.int32),
        torch.sum(real, dtype=torch.int32),
    )


def _upload(a, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on the card through a pinned buffer and a
    non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


class QualityObservatory:
    """Per-scheduler placement-quality aggregation point.

    The scheduling thread calls `on_cycle` once per committed cycle
    (runtime/scheduler.py stamps the call's cost into
    scheduler_quality_seconds_total — the <2% budget perf_smoke pins);
    readers (/debug/quality, heartbeat, bench) come from other threads
    and take the lock only around ring/summary state.  A cycle without a
    top-k (quality=None) contributes only to the cycle count.  `device`
    is where the regret counterfactual runs (the scheduler's; the card
    unless the caller passes "cpu")."""

    def __init__(
        self,
        top_k: int = 3,
        interval_cycles: int = 32,
        ring_capacity: int = 256,
        margin_window: int = 4096,
        postmortem: Optional[Callable[[str, str], None]] = None,
        drift_threshold: float = 0.25,
        drift_min_samples: int = 32,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        self.top_k = max(0, int(top_k))
        self.device = torch.device(device)
        self.interval_cycles = max(1, int(interval_cycles))
        self._postmortem = postmortem
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring_capacity)))
        # sliding margin/feasible reservoirs: the p50s the heartbeat,
        # summary, and bench gate read (bounded; O(window log window)
        # only on reads, never on the hot path)
        self._margins: deque = deque(maxlen=max(16, int(margin_window)))
        self._feasible: deque = deque(maxlen=max(16, int(margin_window)))
        self.cycles_total = 0
        self.decisions_total = 0
        self.margin_count = 0
        self._margin_sum = 0.0
        self._cycles_since_regret = self.interval_cycles  # first is due
        # in-flight regret counterfactual: (cycle, device outs, actual
        # facts) — dispatched on one due cycle, materialized on the next
        # (the telemetry hub's amortization pattern)
        self._pending_regret: Optional[Tuple[int, tuple, dict]] = None
        self.regret: Optional[dict] = None  # last materialized sample
        self.regret_samples = 0
        # regret samples lost to a fault in their side launch or its read
        self.regret_dropped = 0
        self.detectors: Dict[str, StepDetector] = {
            name: StepDetector(
                name, threshold=drift_threshold,
                min_samples=drift_min_samples,
            )
            for name in DRIFT_SERIES
        }
        self.drift_alerts_total = 0

    # ------------------------------------------------------ hot-path API

    def on_cycle(
        self,
        cycle: int,
        tier: str,
        degraded: bool,
        hosts,
        n_pods: int,
        quality=None,
        reqs=None,
        snapshot: Optional[tuple] = None,
        attrib=None,
        analytics: Optional[dict] = None,
    ) -> None:
        """Fold one committed cycle into the quality model.

        `quality` is the host-materialized ops/select.TopKQuality (None
        on degraded cycles); `reqs` the encoded batch's request matrix
        (f32[B, R] host ref); `snapshot` the cycle's PRE-dispatch host
        snapshot refs (allocatable, requested, valid — immutable by the
        encoder's cow contract); `attrib` the engine's Attribution when the
        sequential attribution seam is active; `analytics` the
        telemetry hub's last materialized sample dict (drift input)."""
        self.cycles_total += 1
        hosts = np.asarray(hosts)[:n_pods]
        margins = np.empty(0, np.float32)
        sample: dict = {
            "time": time.time(),
            "cycle": int(cycle),
            "tier": tier,
            "degraded": bool(degraded),
            "pods": int(n_pods),
            "placed": int((hosts >= 0).sum()),
        }
        fired: List[str] = []
        if quality is not None and n_pods:
            self.decisions_total += n_pods
            tn = np.asarray(quality.top_nodes)[:n_pods]
            ts = np.asarray(quality.top_scores)[:n_pods]
            feas = np.asarray(quality.feasible)[:n_pods]
            placed = hosts >= 0
            # winner == top-1 is the engines' pinning contract; enforce
            # it here so a future engine change cannot silently report
            # margins about placements it did not make
            if placed.any() and not np.array_equal(
                tn[placed, 0], hosts[placed]
            ):
                raise AssertionError(
                    "quality top-1 diverged from committed winners"
                )
            if tn.shape[1] >= 2:
                two = placed & (tn[:, 1] >= 0)
                if two.any():
                    margins = normalized_margin(ts[two, 0], ts[two, 1])
            fcounts = feas  # 0-feasible rows ARE the unschedulable story
            # vectorized metric folds: a 2048-wide cycle must not pay
            # per-pod locked bisects (the <2% hot-path budget)
            m.PLACEMENT_MARGIN.observe_np(margins, tier=tier)
            m.FEASIBLE_NODES.observe_np(fcounts)
            margin_sum = float(margins.sum()) if margins.size else 0.0
            with self._lock:
                self._margins.extend(margins.tolist())
                self._feasible.extend(fcounts.tolist())
                self.margin_count += int(margins.size)
                self._margin_sum += margin_sum
            sample["margin_mean"] = (
                round(margin_sum / margins.size, 6)
                if margins.size else None
            )
            sample["margin_min"] = (
                round(float(margins.min()), 6) if margins.size else None
            )
            if len(fcounts):
                # cheap exact median (partition, not a full percentile)
                mid = len(fcounts) // 2
                sample["feasible_p50"] = int(
                    np.partition(fcounts, mid)[mid]
                )
            else:
                sample["feasible_p50"] = 0
            sample["examples"] = self._examples(hosts, tn, ts, attrib)
        # ---- drift detectors: per-cycle margin level + the analytics
        # series the telemetry hub materializes (no extra device work here)
        if margins.size:
            fired += self._drift(
                "margin", sample["margin_mean"] or 0.0
            )
        if analytics:
            try:
                fired += self._drift(
                    "utilization_cpu",
                    float(analytics["utilization"]["cpu"]["mean"]),
                )
                fired += self._drift(
                    "fragmentation", float(analytics["fragmentation"])
                )
            except (KeyError, TypeError):
                pass
        if fired and self._postmortem is not None:
            detail = "; ".join(
                f"series {name}: fast={self.detectors[name].fast:.4f} "
                f"slow={self.detectors[name].slow:.4f} "
                f"deviation={self.detectors[name].deviation():.2f} > "
                f"{self.detectors[name].threshold}"
                for name in fired
            )
            self._postmortem("quality_drift", detail)
        # ---- amortized regret counterfactual (materialize the previous
        # interval's launch, then dispatch the next — the scheduling
        # thread never waits on the binpack compute).  The cadence
        # counter resets ONLY on an actual dispatch: a due cycle that
        # cannot sample (degraded, no snapshot — e.g. megacycle windows
        # k>0 — or an empty batch) leaves the interval due, so the next
        # eligible cycle samples instead of the cadence silently
        # starving when the due slot keeps landing on ineligible cycles
        self._cycles_since_regret += 1
        if self._cycles_since_regret >= self.interval_cycles:
            self._materialize_regret()
            if (
                quality is not None and reqs is not None
                and snapshot is not None and n_pods
                and self._dispatch_regret(cycle, hosts, reqs, snapshot)
            ):
                self._cycles_since_regret = 0
        with self._lock:
            self._ring.append(sample)

    def _examples(self, hosts, tn, ts, attrib) -> List[dict]:
        """Up to 4 per-decision examples for the ring sample: winner vs
        runner-up, margin, and — when the attribution output rode the same
        launch — the weighted per-plugin score components of both rows.
        Candidates are pre-filtered VECTORIZED: a wide cycle with no
        runner-ups anywhere (nodeSelector-pinned fleets, 1-wide top-k)
        must not pay a per-pod Python walk on the scheduling thread."""
        from kubernetes_tpu_torch.codec.schema import SCORE_COMPONENTS

        if tn.shape[1] < 2:
            return []
        idxs = np.flatnonzero((hosts >= 0) & (tn[:, 1] >= 0))[:4]
        out: List[dict] = []
        for i in idxs:
            ex = {
                "pod_index": int(i),
                "winner": int(tn[i, 0]),
                "runner_up": int(tn[i, 1]),
                "margin": round(
                    float(normalized_margin(ts[i, 0], ts[i, 1])), 6,
                ),
            }
            if attrib is not None:
                # attribution's own top-k is score-ordered, not winner-
                # pinned: match rows by node id before naming components
                atn = np.asarray(attrib.top_nodes)[i]
                comp = np.asarray(attrib.top_components)[i]

                def _components(node):
                    rows = np.flatnonzero(atn == node)
                    if not len(rows):
                        return None
                    c = comp[rows[0]]
                    return {
                        SCORE_COMPONENTS[j]: round(float(c[j]), 4)
                        for j in range(len(SCORE_COMPONENTS))
                        if abs(float(c[j])) > 1e-9
                    }

                w, r = _components(tn[i, 0]), _components(tn[i, 1])
                if w is not None:
                    ex["winner_components"] = w
                if r is not None:
                    ex["runner_up_components"] = r
            out.append(ex)
        return out

    def _drift(self, name: str, value: float) -> List[str]:
        det = self.detectors[name]
        if det.update(value):
            self.drift_alerts_total += 1
            m.QUALITY_DRIFT_ALERTS.inc(series=name)
            return [name]
        return []

    # ------------------------------------------------------------ regret

    def _dispatch_regret(self, cycle: int, hosts, reqs, snapshot) -> bool:
        """Launch the FFD counterfactual for THIS cycle — the pods the
        live run PLACED (unplaced rows zero-masked so both sides pack
        the same set) vs the pre-cycle free capacity; the result
        materializes one interval from now.  Returns whether a launch
        actually dispatched (the cadence counter resets only then)."""
        placed_mask = hosts >= 0
        if not placed_mask.any():
            return False
        alloc, used, valid = snapshot
        reqs = np.asarray(reqs, np.float32)
        masked = np.zeros_like(reqs)
        n = len(hosts)
        masked[:n][placed_mask] = reqs[:n][placed_mask]
        try:
            # the host snapshot refs go up through pinned staging, so the
            # copies and the launch queue behind the stream's work without
            # the host waiting on it
            args = [_upload(a, self.device)
                    for a in (alloc, used, valid, masked)]
            # its three scalars come back through pinned memory, read one
            # interval later
            outs = PinnedCopy(torch.stack(
                [o.reshape(()) for o in _ffd_counterfactual(*args)]))
        except Exception as e:  # noqa: BLE001 — a faulted side launch
            # costs one sample, never the cycle; the loss is counted
            self._drop_regret("dispatch", cycle, e)
            return False
        actual = {
            "nodes": int(len(set(int(h) for h in hosts if h >= 0))),
            "placed": int(placed_mask.sum()),
        }
        with self._lock:  # /debug/quality readers race the swap below
            self._pending_regret = (cycle, outs, actual)
        return True

    def _materialize_regret(self) -> Optional[dict]:
        with self._lock:  # one consumer wins: the scheduling thread and
            # HTTP readers (debug_payload/finalize) both materialize —
            # an unlocked swap could drop a freshly dispatched sample or
            # double-count one into the regret counters
            pending, self._pending_regret = self._pending_regret, None
        if pending is None:
            return None
        cycle, outs, actual = pending
        try:
            ffd_nodes, ffd_placed, real = (int(x) for x in outs.result())
        except Exception as e:  # noqa: BLE001 — one lost sample, counted
            self._drop_regret("read", cycle, e)
            return None
        ratio = actual["nodes"] / max(ffd_nodes, 1)
        sample = {
            "cycle": cycle,
            "ratio": round(ratio, 4),
            "actual_nodes": actual["nodes"],
            "actual_placed": actual["placed"],
            "ffd_nodes": ffd_nodes,
            "ffd_placed": ffd_placed,
            "pods": real,
        }
        with self._lock:
            self.regret = sample
            self.regret_samples += 1
        m.PLACEMENT_REGRET.set(ratio)
        m.QUALITY_REGRET_SAMPLES.inc()
        return sample

    def _drop_regret(self, where: str, cycle: int, err: Exception) -> None:
        with self._lock:
            self.regret_dropped += 1
        klog.errorf("quality regret sample of cycle %d dropped at %s: %s",
                    cycle, where, err)

    def finalize(self) -> None:
        """Materialize any in-flight regret launch (bench/test exit —
        the amortization would otherwise leave the last sample in
        flight forever on a drained queue)."""
        self._materialize_regret()

    # ----------------------------------------------------------- readers

    def margin_p50(self) -> float:
        with self._lock:
            vals = list(self._margins)
        return _p50(vals)

    def heartbeat_fields(self) -> Tuple[float, float]:
        """(sliding margin p50, last regret ratio) — the two heartbeat
        satellites (0.0 while nothing was measured yet)."""
        with self._lock:
            regret = self.regret["ratio"] if self.regret else 0.0
        return self.margin_p50(), float(regret)

    def summary(self) -> dict:
        with self._lock:
            margins = list(self._margins)
            feas = list(self._feasible)
            regret = dict(self.regret) if self.regret else None
            cycles = self.cycles_total
            decisions = self.decisions_total
            count = self.margin_count
            msum = self._margin_sum
        return {
            "cycles": cycles,
            "decisions": decisions,
            "top_k": self.top_k,
            "interval_cycles": self.interval_cycles,
            "margin": {
                "p50": round(_p50(margins), 6),
                "mean": round(msum / count, 6) if count else 0.0,
                "count": count,
                "window": len(margins),
            },
            "feasible": {
                "p50": round(_p50(feas), 1),
                "min": min(feas) if feas else 0,
                "window": len(feas),
            },
            "regret": regret,
            "regret_samples": self.regret_samples,
            "regret_dropped": self.regret_dropped,
            "drift": {
                name: det.snapshot() for name, det in self.detectors.items()
            },
            "drift_alerts_total": self.drift_alerts_total,
        }

    def debug_payload(self, limit: Optional[int] = None) -> dict:
        """GET /debug/quality body: summary + the newest `limit`
        per-cycle samples (the shared debug_body halves the limit until
        the body fits the 4MB cap, like its siblings)."""
        self._materialize_regret()
        with self._lock:
            samples = list(self._ring)
        if limit is not None and limit >= 0:
            samples = samples[-limit:] if limit else []
        return {"summary": self.summary(), "samples": samples}


# process-wide default: the observatory /debug/quality serves when
# none was wired explicitly; a Scheduler with quality enabled installs
# its own here at construction.  Replica 0 wins the default, siblings
# register alongside (runtime/defaults.py ProcessDefault)
from kubernetes_tpu_torch.runtime.defaults import ProcessDefault  # noqa: E402

_DEFAULT = ProcessDefault("quality", QualityObservatory)


def get_default() -> QualityObservatory:
    return _DEFAULT.get()


def set_default(obs: QualityObservatory, replica: int = 0) -> None:
    _DEFAULT.set(obs, replica)


def replica_instances() -> dict:
    """{replica id: QualityObservatory} of every install this process
    saw."""
    return _DEFAULT.replicas()


def __getattr__(name):  # legacy alias: quality.QUALITY
    if name == "QUALITY":
        return _DEFAULT.get()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
