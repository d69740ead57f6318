"""Optimistic cross-replica conflict reconciler + shared snapshot hub
(PyTorch port of the JAX package's runtime/reconciler.py).

N `Scheduler` replicas (threads in one process) each pop a stable
hash-shard of the PriorityQueue and dispatch engine launches against the
SAME resident device snapshot; nothing is locked during the device window,
and every cycle's winners pass through the SEQUENCED commit check here
before they assume:

  * zero-conflict fast path: if the encoder generation at commit still
    equals the generation the cycle dispatched against (and no namespace
    quota is set), the whole batch admits with ONE integer comparison;
  * conflict scan: otherwise the candidate winners run through the
    admission scan (kernel K10 on the card, `admit_scan_plain` on CPU
    tensors): candidates in dominant-resource-fairness order are
    prefix-admitted against the LIVE node headroom and the tenant's quota
    headroom, so two replicas spending one node's headroom beyond
    allocatable admit exactly the sequenced winner and requeue only the
    losers; a quota veto parks the pod unschedulable.

`SnapshotHub` is the shared-device-state half: one DeviceSnapshotCache all
replicas dispatch through.  The port's resident snapshot is written IN
PLACE by the dirty-row scatter (codec/transfer.py), where the reference
relies on immutable device buffers, so the hub holds its lock from the
refresh (snapshot + take_dirty_rows + scatter) through the engine's whole
enqueue (`SnapshotHub.launch`): every replica enqueues on the same CUDA
stream, so no launch can read rows newer than, or torn against, the
generation it is tagged with.  Readers of the resident tensors outside a
launch (the telemetry analytics) take the same lock (`SnapshotHub.hold`).

The module also keeps the process-level replica registry serving the
/debug/replicas roll-up.  On the card nothing falls back: an error of
K10 raises out of the commit.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.codec.schema import _pow2
from kubernetes_tpu_torch.utils import metrics as m

# same slack vocabulary as the invariant checker's capacity rule
_EPS = 1e-3


def _lean_pod(pod) -> bool:
    """Can this pod's engine verdicts be trusted across a STALE generation
    fence?  Resources and node-static constraints are re-checked (or do
    not depend on other pods); host ports, pod-(anti-)affinity and volumes
    have no re-check here, so such a winner requeues instead."""
    if pod.spec.volumes or pod.host_ports():
        return False
    a = pod.spec.affinity
    if a is not None and (
        a.pod_affinity is not None or a.pod_anti_affinity is not None
    ):
        return False
    return True


def admit_scan_plain(u_node: torch.Tensor, u_ns: torch.Tensor,
                     order: torch.Tensor, reqs: torch.Tensor,
                     node_head: torch.Tensor, ns_head: torch.Tensor):
    """K10's plain twin: the DRF-ordered prefix admit.  Slots u_node, u_ns,
    order i32[Bp] and rows reqs, node_head, ns_head f32[Bp, R]; candidate
    order[k] is admitted when, in f32, every column of its request is <=
    (headroom - spent) + 1e-3 for its node segment and its tenant segment,
    and then adds its request to both spent rows.  Returns (admit
    bool[Bp], quota_ok bool[Bp]) in candidate order."""
    Bp, R = reqs.shape
    dev = reqs.device
    spent_n = torch.zeros((Bp, R), dtype=torch.float32, device=dev)
    spent_t = torch.zeros((Bp, R), dtype=torch.float32, device=dev)
    admit = torch.zeros(Bp, dtype=torch.bool, device=dev)
    quota_ok = torch.zeros(Bp, dtype=torch.bool, device=dev)
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    un_all = u_node.clamp(0, Bp - 1).tolist()
    ut_all = u_ns.clamp(0, Bp - 1).tolist()
    for j in order.clamp(0, Bp - 1).tolist():
        un, ut = un_all[j], ut_all[j]
        rq = reqs[j]
        node_ok = bool(torch.all(rq <= (node_head[j] - spent_n[un]) + eps))
        ns_ok = bool(torch.all(rq <= (ns_head[j] - spent_t[ut]) + eps))
        if node_ok and ns_ok:
            spent_n[un] += rq
            spent_t[ut] += rq
        admit[j] = node_ok and ns_ok
        quota_ok[j] = ns_ok
    return admit, quota_ok


def admit_scan(u_node, u_ns, order, reqs, node_head, ns_head):
    """admit_scan_plain's contract: CUDA tensors launch K10, CPU tensors
    take the plain twin."""
    if reqs.is_cuda:
        return kernels.reconcile_admit(u_node, u_ns, order, reqs, node_head,
                                       ns_head)
    return admit_scan_plain(u_node, u_ns, order, reqs, node_head, ns_head)


class SnapshotHub:
    """THE resident device snapshot N replicas share.

    `launch(fn)` is the dispatch surface: under the hub's lock it takes the
    cache lock for the snapshot and the dirty rows (single consumer —
    replicas in hub mode never take them themselves), scatters the delta
    into the one DeviceSnapshotCache, records the generation, and runs
    `fn(device cluster)` (the engine's enqueue) before releasing the lock.
    When nothing committed since the previous refresh the resident state is
    reused as is (`refresh_hits`)."""

    def __init__(self, cache, devcache):
        self.cache = cache
        self.dev = devcache
        self._lock = threading.RLock()  # dev + generation + launches
        self.generation = -1
        self.refreshes = 0
        self.refresh_hits = 0
        self.launches = 0
        self._last = None  # (cluster, gen, dev) of the newest refresh

    def refresh(self):
        """Atomic host snapshot -> device scatter.  Returns (host
        ClusterTensors, generation, device ClusterTensors).  The caller
        that then reads the device tensors holds the hub's lock (launch /
        hold): a sibling's refresh scatters in place."""
        with self._lock:
            with self.cache._lock:
                gen = self.cache.generation
                if gen == self.generation and self._last is not None:
                    self.refresh_hits += 1
                    return self._last
                cluster, gen = self.cache.snapshot()
                dirty = self.cache.encoder.take_dirty_rows()
            dev = self.dev.update(cluster, dirty_rows=dirty)
            self.generation = gen
            self.refreshes += 1
            self._last = (cluster, gen, dev)
            return self._last

    def launch(self, fn):
        """Refresh, then run fn(device cluster) under the hub's lock.
        Returns (host cluster, generation, fn's result)."""
        with self._lock:
            cluster, gen, dev = self.refresh()
            self.launches += 1
            return cluster, gen, fn(dev)

    @contextlib.contextmanager
    def hold(self):
        """Hold the hub's lock: no refresh scatters while held."""
        with self._lock:
            yield

    def invalidate(self) -> None:
        """Device fault: drop every resident buffer (the next refresh
        re-uploads the whole snapshot) and poison the generation."""
        with self._lock:
            self.dev.invalidate()
            self.generation = -1
            self._last = None

    def resident(self, names):
        with self._lock:
            return self.dev.resident(names)


class ConflictReconciler:
    """Sequenced commit admission for optimistic replica cycles.

    One instance is shared by every replica; reconcile() runs under the
    cache lock (the commit critical section), stamps the cycle's commit
    sequence number, and returns the admitted winners plus the two loser
    classes (race-conflicted -> readd to the owner shard; quota-vetoed ->
    park unschedulable with backoff).  The admission scan runs on the
    committing scheduler's device: K10 on the card, the twin on the CPU.
    `kernel_calls` counts the scans that ran the admission function."""

    def __init__(self):
        self._seq_lock = threading.Lock()
        self.commit_seq = 0
        self.fast_path_total = 0
        self.scans_total = 0
        self.conflicts_total = 0
        self.quota_vetoes_total = 0
        self.strict_requeues_total = 0
        self.kernel_calls = 0
        # (inputs, admit, quota_ok) of every scan, when a caller asks to
        # keep them (a list; the chip cell replays them through the twin)
        self.recorded: Optional[list] = None

    def prewarm(self, max_width: int, r: int, device="cuda") -> None:
        """Run the admission function once at every width of the pow2
        ladder up to max_width (on the card: the kernel library's build and
        K10's first launches, outside a timed window)."""
        dev = torch.device(device)
        w = 1
        while w <= _pow2(max(1, max_width)):
            z = torch.zeros((w, r), dtype=torch.float32, device=dev)
            u = torch.zeros(w, dtype=torch.int32, device=dev)
            o = torch.arange(w, dtype=torch.int32, device=dev)
            admit_scan(u, u, o, z, z, z)
            w *= 2

    def next_seq(self) -> int:
        with self._seq_lock:
            self.commit_seq += 1
            return self.commit_seq

    def reconcile(self, sched, inf, winners, hosts):
        """Admission for one cycle's winners.  MUST run under the cache
        lock (the caller then assumes the admitted pods in the same
        critical section).  Returns (kept_winners, race_lost, quota_lost);
        the loser lists hold (batch_index, pod) pairs.  Fast path:
        generation unchanged since dispatch and no quota configured ->
        the input winners list is returned AS IS."""
        enc = sched.cache.encoder
        inf.commit_seq = self.next_seq()
        if not winners:
            return winners, [], []
        gen_now = enc.generation
        quotas = enc.ns_quota_set
        stale = gen_now != inf.generation
        if not stale and not quotas:
            self.fast_path_total += 1
            return winners, [], []
        self.scans_total += 1
        strict: list = []
        if stale:
            strict_all = bool(sched.queue.has_nominated())
            scanned = []
            for w in winners:
                if strict_all or not _lean_pod(w[1]):
                    strict.append((w[0], w[1]))
                else:
                    scanned.append(w)
            winners = scanned
        if strict:
            self.strict_requeues_total += len(strict)
            self.conflicts_total += len(strict)
            m.REPLICA_CONFLICTS.inc(
                len(strict), replica=str(sched._replica_id)
            )
            m.REPLICA_REQUEUED.inc(len(strict))
        if not winners:
            return [], strict, []
        B = len(winners)
        R = enc.dims.R
        idx = np.fromiter((w[0] for w in winners), np.int64, B)
        rows = np.asarray(hosts, np.int64)[idx]
        reqs_src = np.asarray(inf.reqs, np.float32)
        reqs = np.zeros((B, R), np.float32)
        rc = min(R, reqs_src.shape[1])
        reqs[:, :rc] = reqs_src[idx][:, :rc]
        t_rows = np.fromiter(
            (enc._ns_row(w[1].namespace) for w in winners), np.int64, B
        )
        caps = enc.capacity_totals()
        with np.errstate(divide="ignore", invalid="ignore"):
            shares_t = np.where(
                caps > 0.0, enc.a_ns_usage[t_rows] / caps, 0.0
            )
        shares = shares_t.max(axis=1)
        order = np.lexsort((idx, shares)).astype(np.int32)
        node_head = (
            enc.a_allocatable[rows] - enc.a_requested[rows]
        ).astype(np.float32)
        ns_head = (
            enc.a_ns_quota[t_rows, :R] - enc.a_ns_usage[t_rows, :R]
        ).astype(np.float32)
        u_node = np.zeros(B, np.int32)
        seen: Dict[int, int] = {}
        for j in range(B):
            u_node[j] = seen.setdefault(int(rows[j]), j)
        u_ns = np.zeros(B, np.int32)
        seen = {}
        for j in range(B):
            u_ns[j] = seen.setdefault(int(t_rows[j]), j)
        # pad to the pow2 ladder, as the reference does: pad slots point at
        # a dummy segment with zero request and +inf headroom
        Bp = _pow2(B)
        if Bp != B:
            pad = Bp - B
            u_node = np.concatenate([u_node, np.full(pad, B, np.int32)])
            u_ns = np.concatenate([u_ns, np.full(pad, B, np.int32)])
            reqs = np.vstack([reqs, np.zeros((pad, R), np.float32)])
            inf_head = np.full((pad, R), np.inf, np.float32)
            node_head = np.vstack([node_head, inf_head])
            ns_head = np.vstack([ns_head, inf_head])
            order = np.concatenate(
                [order, np.arange(B, Bp, dtype=np.int32)]
            )
            u_node = np.minimum(u_node, Bp - 1)
            u_ns = np.minimum(u_ns, Bp - 1)
        args = (u_node, u_ns, order, reqs, node_head, ns_head)
        self.kernel_calls += 1
        dev = torch.device(sched.device)
        admit, quota_ok = admit_scan(
            *(torch.from_numpy(a).to(dev) for a in args)
        )
        admit = admit.cpu().numpy()
        quota_ok = quota_ok.cpu().numpy()
        if self.recorded is not None:
            self.recorded.append((args, admit, quota_ok))
        admit, quota_ok = admit[:B], quota_ok[:B]
        kept, race_lost, quota_lost = [], list(strict), []
        for j, w in enumerate(winners):
            if admit[j]:
                kept.append(w)
            elif not quota_ok[j]:
                quota_lost.append((w[0], w[1]))
            else:
                race_lost.append((w[0], w[1]))
        n_scan_lost = len(race_lost) - len(strict)
        if n_scan_lost:
            self.conflicts_total += n_scan_lost
            m.REPLICA_CONFLICTS.inc(
                n_scan_lost, replica=str(sched._replica_id)
            )
        if quota_lost:
            self.quota_vetoes_total += len(quota_lost)
        if n_scan_lost or quota_lost:
            m.REPLICA_REQUEUED.inc(n_scan_lost + len(quota_lost))
        return kept, race_lost, quota_lost

    def stats(self) -> dict:
        return {
            "commit_seq": self.commit_seq,
            "fast_path_total": self.fast_path_total,
            "scans_total": self.scans_total,
            "conflicts_total": self.conflicts_total,
            "strict_requeues_total": self.strict_requeues_total,
            "quota_vetoes_total": self.quota_vetoes_total,
            "kernel_calls": self.kernel_calls,
        }


# ---------------------------------------------------- replica registry
#
# Every Scheduler registers itself under its replica id (latest wins), and
# the /debug/replicas roll-up serves this registry.

_REG_LOCK = threading.Lock()
_SCHEDULERS: Dict[int, object] = {}  # replica id -> weakref(Scheduler)


def register_scheduler(sched) -> None:
    import weakref

    with _REG_LOCK:
        _SCHEDULERS[int(getattr(sched, "_replica_id", 0))] = weakref.ref(
            sched
        )


def registered_schedulers() -> Dict[int, object]:
    """Live registered schedulers by replica id, weakly held."""
    with _REG_LOCK:
        out = {}
        for rid, ref in sorted(_SCHEDULERS.items()):
            s = ref()
            if s is not None:
                out[rid] = s
        return out


def debug_payload(limit: Optional[int] = None) -> dict:
    """The /debug/replicas body: per-replica cycle/outcome/conflict facts,
    the shared reconciler's sequencing stats, and the tenant usage/quota
    table (`limit` bounds the tenant table)."""
    per: Dict[str, dict] = {}
    recon = None
    tenants: Dict[str, dict] = {}
    n_live = 0
    for rid, s in registered_schedulers().items():
        try:
            per[str(rid)] = {
                "replica_of": getattr(s, "_replica_of", 1),
                "cycles": s.cycles_total,
                "queue_cycles": s.queue.scheduling_cycle,
                "placed": s._outcome_totals.get("placed", 0),
                "unschedulable": s._outcome_totals.get("unschedulable", 0),
                "conflicts": getattr(s, "conflicts_total", 0),
                "race_requeued": getattr(s, "race_requeued_total", 0),
                "quota_vetoed": getattr(s, "quota_vetoed_total", 0),
                "megacycles": getattr(s, "megacycles_total", 0),
                "breaker": s.device_health.state,
                "engine": getattr(s, "_engine_kind", "?"),
                "queue_shard": getattr(s, "_replica_id", 0),
            }
            n_live += 1
            if recon is None and getattr(s, "_reconciler", None) is not None:
                recon = s._reconciler
            if not tenants:
                tenants = s.cache.encoder.namespace_usage()
        except Exception as e:  # noqa: BLE001 — a debug read never throws
            per[str(rid)] = {"error": str(e)}
    if limit is not None and limit >= 0 and len(tenants) > limit:
        tenants = dict(list(tenants.items())[:limit])
    return {
        "replicas": n_live,
        "per_replica": per,
        "reconciler": recon.stats() if recon is not None else None,
        "tenants": tenants,
    }
