"""Metrics timeline store + online anomaly detection (PyTorch port: a copy
of the JAX package's runtime/timeline.py with the imports rewritten).

Every observability layer before this one is instant-scope: /metrics is
a point-in-time snapshot, the /debug/* rings hold the last few cycles.
A diurnal scenario or a multi-hour autoscaler run left no queryable
history of how utilization, burn rates, mesh width, or queue depth
EVOLVED — and the learned-scoring line (PAPERS.md "Learning to Score",
Gavel's policy evaluation) tunes on exactly such outcome trajectories.

`TimelineStore` closes that gap in-process and dependency-free:

- it samples EVERY registered metric family through the
  utils/metrics.py sampling protocol (`sample_families`) on a
  configurable cadence — counters stored as per-sample deltas (rates
  fall out of the timestamps), gauges as values, histograms as selected
  quantiles — into bounded per-series rings;
- typed event annotations from the existing seams (breaker/shard
  transitions, mesh rebuilds, AIMD resizes, autoscaler rounds, SLO
  burns, shed bursts, scenario chaos windows) interleave with the
  samples, so an excursion and its cause land on one timeline;
- an `AnomalyDetector` runs rule-based checks (static threshold,
  z-score vs a trailing window, least-squares slope) over configured
  series after every sweep, edge-triggered with re-arm hysteresis (a
  storm fires each rule ONCE, not once per sample) — each firing
  increments scheduler_timeline_anomalies_total{rule,series}, annotates
  the timeline, and (when wired) dumps a throttled flight-recorder
  postmortem;
- the whole store's query body (`debug_payload`, what the reference
  serves at GET /debug/timeline; the port's endpoint waits for its health
  server) filters by ?series=&window=&step=&limit=, exports as a JSONL
  artifact (`export_jsonl`), and renders to a static self-contained HTML
  report (inline SVG sparklines per series with annotation lanes).

The scheduler drives `maybe_sample()` from its commit tail AND its idle
poll path (an idle scheduler still has a trajectory), its cost stamped
into scheduler_timeline_seconds_total.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics as m
from kubernetes_tpu_torch.utils.metrics import sample_families

# ------------------------------------------------------------ anomaly rules

# the default rule set: quiet on a healthy run by construction —
# degraded cycles and invariant violations are zero-delta unless
# something actually broke, and the z-score guard needs a long trailing
# window before it can fire at all
DEFAULT_RULES: List[dict] = [
    {"rule": "threshold", "series": "scheduler_degraded_cycles_total",
     "op": ">", "value": 0.0},
    {"rule": "threshold", "series": "scheduler_invariant_violations_total",
     "op": ">", "value": 0.0},
    {"rule": "zscore", "series": "scheduler_pending_pods",
     "window": 64, "z": 6.0, "min_samples": 16},
]

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def _rule_name(rule: dict) -> str:
    return str(rule.get("name") or rule.get("rule", "threshold"))


class AnomalyDetector:
    """Rule-based online checks over the store's sampled series.

    Edge-triggered with re-arm hysteresis, per (rule, series): a rule
    whose condition holds fires ONCE and disarms; it re-arms only after
    observing the condition false again.  A seeded chaos storm that
    keeps a series hot for hundreds of samples therefore produces one
    anomaly, not hundreds — the exactly-once-throttled discipline the
    flight recorder applies to postmortems, applied to detection.

    `postmortem(trigger, detail)` — when wired (the scheduler passes
    its own `_postmortem`) — dumps the flight-recorder snapshot; the
    recorder's own per-trigger min-interval throttle still applies on
    top, so even rapid re-arm/re-fire cycles cannot storm snapshots.
    """

    def __init__(
        self,
        rules: Optional[List[dict]] = None,
        postmortem: Optional[Callable[[str, str], None]] = None,
    ):
        self.rules = [dict(r) for r in (rules if rules is not None
                                        else DEFAULT_RULES)]
        self.postmortem = postmortem
        self._disarmed: Dict[Tuple[str, str], bool] = {}
        self.anomalies_total = 0
        self.fired: "deque[dict]" = deque(maxlen=64)
        self._lock = threading.Lock()

    # ------------------------------------------------------------ evaluation

    def _condition(self, rule: dict, points: List[Tuple[float, float]]
                   ) -> Tuple[bool, str]:
        """(fires?, detail) for one rule over one series' point tail.
        Counters arrive as per-sample deltas (the store's encoding), so
        a threshold of >0 on a *_total family means 'it moved'."""
        kind = rule.get("rule", "threshold")
        if not points:
            return False, ""
        if kind == "threshold":
            op = _OPS.get(str(rule.get("op", ">")), _OPS[">"])
            bound = float(rule.get("value", 0.0))
            last = points[-1][1]
            return op(last, bound), (
                f"value {last:g} {rule.get('op', '>')} {bound:g}"
            )
        window = int(rule.get("window", 32))
        tail = points[-window:]
        if kind == "zscore":
            min_samples = int(rule.get("min_samples", 8))
            if len(tail) < max(2, min_samples):
                return False, ""
            base = [v for _, v in tail[:-1]]
            mean = sum(base) / len(base)
            var = sum((v - mean) ** 2 for v in base) / len(base)
            std = var ** 0.5
            if std <= 0.0:
                return False, ""
            z = abs(tail[-1][1] - mean) / std
            bound = float(rule.get("z", 4.0))
            return z >= bound, (
                f"z={z:.2f} >= {bound:g} (mean {mean:g}, std {std:g})"
            )
        if kind == "slope":
            min_samples = int(rule.get("min_samples", 4))
            if len(tail) < max(2, min_samples):
                return False, ""
            # least-squares slope in value-units per second
            n = len(tail)
            t0 = tail[0][0]
            xs = [t - t0 for t, _ in tail]
            ys = [v for _, v in tail]
            mx = sum(xs) / n
            my = sum(ys) / n
            denom = sum((x - mx) ** 2 for x in xs)
            if denom <= 0.0:
                return False, ""
            slope = sum((x - mx) * (y - my)
                        for x, y in zip(xs, ys)) / denom
            bound = float(rule.get("per_second", 1.0))
            if bound >= 0:
                return slope >= bound, f"slope {slope:g}/s >= {bound:g}/s"
            return slope <= bound, f"slope {slope:g}/s <= {bound:g}/s"
        return False, ""

    def observe(self, store: "TimelineStore", now: float) -> List[dict]:
        """Run every rule after one sampling sweep.  Returns the
        anomalies that FIRED this sweep (edge-triggered)."""
        fired: List[dict] = []
        for rule in self.rules:
            pattern = str(rule.get("series", ""))
            if not pattern:
                continue
            name = _rule_name(rule)
            for series in store.match_series(pattern):
                points = store.series_points(series)
                hot, detail = self._condition(rule, points)
                key = (name, series)
                with self._lock:
                    disarmed = self._disarmed.get(key, False)
                    if hot and not disarmed:
                        self._disarmed[key] = True
                        self.anomalies_total += 1
                    elif not hot and disarmed:
                        self._disarmed[key] = False  # recovered: re-arm
                        continue
                    else:
                        continue
                anom = {"t": now, "rule": name, "series": series,
                        "detail": detail}
                self.fired.append(anom)
                fired.append(anom)
                m.TIMELINE_ANOMALIES.inc(rule=name, series=series)
                if self.postmortem is not None:
                    try:
                        self.postmortem(
                            f"anomaly_{name}", f"{series}: {detail}"
                        )
                    except Exception:  # noqa: BLE001 — detection never raises
                        pass
        return fired

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rules": [dict(r) for r in self.rules],
                "anomalies_total": self.anomalies_total,
                "disarmed": sorted(
                    f"{r}:{s}" for (r, s), d in self._disarmed.items() if d
                ),
            }


# ------------------------------------------------------------------ store

class TimelineStore:
    """Bounded in-process time-series store over the metric registry.

    Thread-safe: `maybe_sample` runs on the scheduling thread,
    `annotate` from scheduler/autoscaler/scenario threads, readers
    (HTTP handlers, exports) from server threads.
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        retention: int = 512,
        quantiles: Tuple[float, ...] = (0.5, 0.99),
        clock: Callable[[], float] = time.monotonic,
        detector: Optional[AnomalyDetector] = None,
        registry=None,
    ):
        self.interval_s = max(0.0, float(interval_s))
        self.retention = max(2, int(retention))
        self.quantiles = tuple(quantiles)
        self.clock = clock
        self.detector = detector if detector is not None else AnomalyDetector()
        self._registry = registry
        self._series: Dict[str, "deque[Tuple[float, float]]"] = {}
        self._kinds: Dict[str, str] = {}
        self._counter_base: Dict[str, float] = {}
        self._events: "deque[dict]" = deque(maxlen=self.retention)
        self._anomalies: "deque[dict]" = deque(maxlen=64)
        self._last_sample: Optional[float] = None
        self.lag_s = 0.0
        self.samples_total = 0
        self._wall_anchor = (time.time(), clock())
        self._lock = threading.Lock()

    # -------------------------------------------------------------- sampling

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """One cadence-gated sampling sweep.  Returns whether a sweep
        ran.  Lag — how far past the due time this sweep actually fired
        — is tracked as both a gauge and a store field: the scheduler's
        heartbeat surfaces it (sampling falling behind its cadence is
        itself a signal)."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            if (self._last_sample is not None
                    and now - self._last_sample < self.interval_s):
                return False
            if self._last_sample is None:
                self.lag_s = 0.0
            else:
                self.lag_s = max(
                    0.0, (now - self._last_sample) - self.interval_s
                )
            self._last_sample = now
        triples = sample_families(self._registry, quantiles=self.quantiles)
        with self._lock:
            for name, kind, value in triples:
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self.retention)
                    self._kinds[name] = kind
                if kind == "counter":
                    # per-sample delta; the first sighting establishes
                    # the baseline (a pre-existing cumulative total must
                    # not read as a spike)
                    base = self._counter_base.get(name)
                    self._counter_base[name] = value
                    point = 0.0 if base is None else value - base
                else:
                    point = value
                ring.append((now, point))
            self.samples_total += 1
            n_series = len(self._series)
        m.TIMELINE_SAMPLES.inc()
        m.TIMELINE_LAG.set(self.lag_s)
        m.TIMELINE_SERIES.set(float(n_series))
        if self.detector is not None:
            for anom in self.detector.observe(self, now):
                with self._lock:
                    self._anomalies.append(anom)
                self.annotate(
                    "anomaly", f"{anom['rule']} {anom['series']}: "
                    f"{anom['detail']}", t=now,
                )
        return True

    # ------------------------------------------------------------ annotation

    def annotate(self, kind: str, detail: str = "",
                 t: Optional[float] = None, **fields) -> dict:
        """Push one typed event annotation onto the timeline (breaker
        transition, mesh rebuild, AIMD resize, autoscaler round, SLO
        burn, shed burst, chaos window edge, ...)."""
        ev = {"t": self.clock() if t is None else float(t),
              "kind": str(kind), "detail": str(detail)}
        if fields:
            ev.update(fields)
        with self._lock:
            self._events.append(ev)
        m.TIMELINE_EVENTS.inc(kind=str(kind))
        return ev

    # --------------------------------------------------------------- readers

    def match_series(self, pattern: str) -> List[str]:
        """Series names matching `pattern`: exact, or prefix when the
        pattern ends with '*' (so a rule can cover every child of a
        labeled family: 'scheduler_queue_shed_pods_total*')."""
        with self._lock:
            names = list(self._series)
        if pattern.endswith("*"):
            prefix = pattern[:-1]
            return [n for n in names if n.startswith(prefix)]
        return [n for n in names if n == pattern]

    def series_points(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            return list(ring) if ring is not None else []

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def anomalies(self) -> List[dict]:
        with self._lock:
            return list(self._anomalies)

    def summary(self) -> dict:
        det = self.detector
        with self._lock:
            out = {
                "samples": self.samples_total,
                "series": len(self._series),
                "events": len(self._events),
                "lag_s": round(self.lag_s, 6),
                "interval_s": self.interval_s,
                "retention": self.retention,
            }
        out["anomalies"] = det.anomalies_total if det is not None else 0
        return out

    # ----------------------------------------------------------------- query

    def debug_payload(self, limit: Optional[int] = None,
                      query: str = "") -> dict:
        """GET /debug/timeline body.

        Query contract: `?series=a,b*` filters series (comma list,
        exact or '*'-prefix), `?window=S` keeps only the last S seconds,
        `?step=S` downsamples to one point (the newest) per S-second
        bucket, `?limit=N` bounds points per series AND events (the
        shared debug_body halves it until the body fits the 4MB cap).
        """
        from urllib.parse import parse_qs

        q = parse_qs(query or "")

        def _qfloat(key: str) -> Optional[float]:
            try:
                v = q.get(key)
                return float(v[0]) if v else None
            except (ValueError, TypeError):
                return None

        window = _qfloat("window")
        step = _qfloat("step")
        patterns = []
        for raw in q.get("series", []):
            patterns.extend(p for p in raw.split(",") if p)
        names = self.series_names()
        if patterns:
            keep = set()
            for p in patterns:
                keep.update(self.match_series(p))
            names = [n for n in names if n in keep]
        now = self.clock()
        cutoff = (now - window) if window is not None else None
        series_out: Dict[str, dict] = {}
        for name in names:
            pts = self.series_points(name)
            if cutoff is not None:
                pts = [p for p in pts if p[0] >= cutoff]
            if step is not None and step > 0 and pts:
                buckets: Dict[int, Tuple[float, float]] = {}
                for t, v in pts:  # newest point per bucket wins
                    buckets[int(t // step)] = (t, v)
                pts = [buckets[k] for k in sorted(buckets)]
            if limit is not None and limit >= 0:
                pts = pts[-limit:] if limit else []
            series_out[name] = {
                "kind": self._kinds.get(name, "gauge"),
                "points": [[round(t, 6), v] for t, v in pts],
            }
        events = self.events()
        anomalies = self.anomalies()
        if cutoff is not None:
            events = [e for e in events if e["t"] >= cutoff]
            anomalies = [a for a in anomalies if a["t"] >= cutoff]
        if limit is not None and limit >= 0:
            events = events[-limit:] if limit else []
            anomalies = anomalies[-limit:] if limit else []
        det = self.detector
        return {
            "summary": self.summary(),
            "detector": det.snapshot() if det is not None else None,
            "series": series_out,
            "events": events,
            "anomalies": anomalies,
        }

    # ---------------------------------------------------------------- export

    def export_jsonl(self, path: str) -> int:
        """Bank the whole store as a JSONL artifact: one `meta` line
        (with the wall-clock anchor so monotonic timestamps convert),
        one `series` line per series, one `event`/`anomaly` line each.
        Returns the number of lines written."""
        wall, mono = self._wall_anchor
        det = self.detector
        lines: List[dict] = [{
            "kind": "meta",
            "summary": self.summary(),
            "detector": det.snapshot() if det is not None else None,
            "wall_anchor": wall,
            "monotonic_anchor": mono,
        }]
        for name in self.series_names():
            lines.append({
                "kind": "series",
                "name": name,
                "type": self._kinds.get(name, "gauge"),
                "points": [[round(t, 6), v]
                           for t, v in self.series_points(name)],
            })
        for ev in self.events():
            # annotations carry their own typed "kind" — nest them so
            # the envelope marker survives the round trip
            lines.append({"kind": "event", "event": ev})
        for anom in self.anomalies():
            lines.append({"kind": "anomaly", **anom})
        with open(path, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
        return len(lines)


def load_jsonl(path: str) -> dict:
    """A banked JSONL artifact back into the debug_payload shape (the
    HTML renderer accepts either, so reports render live OR offline)."""
    meta: dict = {}
    series: Dict[str, dict] = {}
    events: List[dict] = []
    anomalies: List[dict] = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            rec = json.loads(raw)
            kind = rec.get("kind")
            if kind == "meta":
                meta = rec
            elif kind == "series":
                series[rec["name"]] = {
                    "kind": rec.get("type", "gauge"),
                    "points": rec.get("points", []),
                }
            elif kind == "event":
                events.append(rec.get("event", {}))
            elif kind == "anomaly":
                anomalies.append(
                    {k: v for k, v in rec.items() if k != "kind"}
                )
    return {
        "summary": meta.get("summary", {}),
        "detector": meta.get("detector"),
        "series": series,
        "events": events,
        "anomalies": anomalies,
    }


# ------------------------------------------------------------- HTML report

_HTML_HEAD = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font: 13px/1.4 system-ui, sans-serif; margin: 24px;
       background: #fafafa; color: #222; }}
h1 {{ font-size: 18px; }} h2 {{ font-size: 13px; margin: 18px 0 2px;
      font-weight: 600; }}
.meta {{ color: #666; margin-bottom: 12px; }}
.row {{ background: #fff; border: 1px solid #e2e2e2; border-radius: 4px;
        padding: 6px 10px; margin-bottom: 6px; }}
.minmax {{ color: #888; font-size: 11px; }}
svg {{ display: block; }}
.lane {{ margin: 12px 0; }}
.ev {{ display: inline-block; margin-right: 10px; font-size: 11px; }}
.dot {{ display: inline-block; width: 8px; height: 8px;
        border-radius: 50%; margin-right: 3px; }}
</style></head><body>
"""

_LANE_COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#17becf", "#bcbd22", "#7f7f7f",
]


def _event_color(kind: str) -> str:
    if kind == "anomaly":
        return "#d62728"
    return _LANE_COLORS[hash(kind) % len(_LANE_COLORS)]


def _svg_sparkline(points: List[List[float]], events: List[dict],
                   t0: float, t1: float, width: int = 640,
                   height: int = 48) -> str:
    """One series as an inline SVG polyline with vertical annotation
    rules at event times — no external assets, renders from file://."""
    span = max(t1 - t0, 1e-9)
    vals = [v for _, v in points]
    lo, hi = min(vals), max(vals)
    vspan = max(hi - lo, 1e-9)

    def x(t: float) -> float:
        return round((t - t0) / span * (width - 2) + 1, 2)

    def y(v: float) -> float:
        return round(height - 3 - (v - lo) / vspan * (height - 6), 2)

    parts = [f'<svg width="{width}" height="{height}" '
             f'viewBox="0 0 {width} {height}">']
    for ev in events:
        t = ev.get("t")
        if t is None or not (t0 <= t <= t1):
            continue
        color = _event_color(str(ev.get("kind", "")))
        parts.append(
            f'<line x1="{x(t)}" y1="0" x2="{x(t)}" y2="{height}" '
            f'stroke="{color}" stroke-width="1" opacity="0.45">'
            f'<title>{_esc(ev.get("kind", ""))}: '
            f'{_esc(ev.get("detail", ""))}</title></line>'
        )
    pts = " ".join(f"{x(t)},{y(v)}" for t, v in points)
    parts.append(f'<polyline points="{pts}" fill="none" '
                 f'stroke="#1f77b4" stroke-width="1.2"/>')
    parts.append("</svg>")
    return "".join(parts)


def _esc(s) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def render_html(payload: dict, title: str = "kubernetes_tpu timeline",
                max_series: int = 200) -> str:
    """debug_payload/load_jsonl dict -> one self-contained HTML page:
    a sparkline per series (flat-zero series are folded away), shared
    time axis, annotation rules through every chart, and an event/
    anomaly legend lane.  Dependency-free by design — the artifact
    must open from a CI tarball with no server behind it."""
    series = payload.get("series", {})
    events = list(payload.get("events", []))
    anomalies = payload.get("anomalies", [])
    for anom in anomalies:
        events.append({"t": anom.get("t"), "kind": "anomaly",
                       "detail": f"{anom.get('rule')} {anom.get('series')}"})
    all_t = [p[0] for s in series.values() for p in s.get("points", [])]
    all_t += [e["t"] for e in events if e.get("t") is not None]
    t0, t1 = (min(all_t), max(all_t)) if all_t else (0.0, 1.0)
    out = [_HTML_HEAD.format(title=_esc(title))]
    out.append(f"<h1>{_esc(title)}</h1>")
    summ = payload.get("summary", {})
    out.append(
        '<div class="meta">'
        f"samples={summ.get('samples', '?')} "
        f"series={len(series)} events={len(events)} "
        f"anomalies={summ.get('anomalies', len(anomalies))} "
        f"span={t1 - t0:.1f}s</div>"
    )
    if events:
        kinds = sorted({str(e.get("kind", "")) for e in events})
        lane = "".join(
            f'<span class="ev"><span class="dot" style="background:'
            f'{_event_color(k)}"></span>{_esc(k)}</span>'
            for k in kinds
        )
        out.append(f'<div class="lane">{lane}</div>')
    shown = 0
    for name in sorted(series):
        pts = series[name].get("points", [])
        if len(pts) < 2:
            continue
        vals = [v for _, v in pts]
        if min(vals) == max(vals) == 0.0:
            continue  # flat zero: noise in a 70-family registry
        if shown >= max_series:
            out.append(f"<p class='meta'>… {len(series) - shown} more "
                       "series elided (max_series)</p>")
            break
        shown += 1
        out.append(f"<h2>{_esc(name)}</h2>")
        out.append(
            '<div class="row">'
            + _svg_sparkline(pts, events, t0, t1)
            + f'<div class="minmax">min {min(vals):g} · '
            f"max {max(vals):g} · last {vals[-1]:g} · "
            f"kind {series[name].get('kind', 'gauge')}</div></div>"
        )
    if anomalies:
        out.append("<h2>anomalies</h2>")
        for anom in anomalies:
            out.append(
                f'<div class="row">t={anom.get("t", 0):.3f} '
                f"<b>{_esc(anom.get('rule'))}</b> "
                f"{_esc(anom.get('series'))}: "
                f"{_esc(anom.get('detail', ''))}</div>"
            )
    out.append("</body></html>\n")
    return "\n".join(out)


# --------------------------------------------------------- process default
# /debug/timeline serves the default store; a Scheduler with timeline
# enabled installs its own here (replica 0 wins, siblings register
# alongside — runtime/defaults.py ProcessDefault, which this store uses
# from day one instead of growing a seventh copy of the pattern)

from kubernetes_tpu_torch.runtime.defaults import ProcessDefault  # noqa: E402

_DEFAULT = ProcessDefault("timeline", TimelineStore)


def get_default() -> TimelineStore:
    return _DEFAULT.get()


def set_default(store: TimelineStore, replica: int = 0) -> None:
    _DEFAULT.set(store, replica)


def replica_instances() -> dict:
    """{replica id: TimelineStore} of every install this process saw."""
    return _DEFAULT.replicas()
