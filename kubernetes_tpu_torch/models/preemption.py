"""Preemption as a what-if over all nodes at once (PyTorch port).

The counterpart of the JAX package's models/preemption.py.  Reference flow
(core/generic_scheduler.go): Preempt (:310-369) -> nodesWherePreemption-
MightHelp (:65-123) -> selectNodesForPreemption over every node
(:964-998) -> selectVictimsOnNode's remove-all-lower-priority + reprieve
loop (:1054-1128) -> pickOneNodeForPreemption's six criteria (:837-962).

  * candidates: the nodes where the pod does not fit and no unresolvable
    predicate failed (nodesWherePreemptionMightHelp), `make_preempt_eval`:
    on CUDA tensors one launch of kernel K11 in its candidates mode
    (kernels/filter_pass.cu), on CPU tensors `preempt_eval_plain`, its
    twin (filter_batch_plain, required_affinity_ok and
    `preemption_candidates`);
  * `preempt_one`: the "remove every listed victim, does the pod fit?"
    what-if over the extended resource axis (resources, host ports, disk
    conflicts and the identity-deduped volume budgets), the reprieve in
    victim-slot order, the per-node keys and the lexicographic pick.  CUDA
    tensors launch kernel K2 (kernels/preempt_one.cu); CPU tensors take
    `preempt_one_plain`, its plain twin, which is also what chip_smoke.py
    holds K2 against;
  * `pick_preemption_node`: the host loop pick -> verify -> veto, with
    `verify_nomination` re-running the object-level predicates
    (cpuref.CPUScheduler) where the counting what-if cannot see the
    failure.

The JAX version's reprieve is one lax.scan over the victim slots.  Steps on
different nodes are independent (the volume tables key every identity by
its node), so the port walks each node's own slots in slot order, all nodes
at once: a node row's lanes in K2, a vector step a slot rank in the twin.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.codec.schema import PRED_INDEX
from kubernetes_tpu_torch.codec.transfer import _h2d_packed, host_fetch

# Failures preemption can NEVER fix (generic_scheduler.go:65-123
# unresolvablePredicateFailureErrors): evicting pods does not change node
# labels/taints/conditions/name or volume topology.  The Max*VolumeCount
# predicates are NOT here (attach budgets free up when victims leave) while
# CheckVolumeBinding/NoVolumeZoneConflict ARE.  The required-affinity-rules
# component of MatchInterPodAffinity is unresolvable too and handled through
# `aff_rules_ok` (the anti-affinity components of that row are resolvable).
UNRESOLVABLE = (
    "CheckNodeCondition",
    "CheckNodeUnschedulable",
    "PodFitsHost",
    "PodMatchNodeSelector",
    "PodToleratesNodeTaints",
    "PodToleratesNodeNoExecuteTaints",
    "CheckNodeLabelPresence",
    "CheckNodeMemoryPressure",
    "CheckNodePIDPressure",
    "CheckNodeDiskPressure",
    "NoVolumeZoneConflict",
    "CheckVolumeBinding",
)

INT_MIN = np.iinfo(np.int32).min
INT_MAX = np.iinfo(np.int32).max
_F32_MAX = float(np.finfo(np.float32).max)


class PreemptionResult(NamedTuple):
    node: torch.Tensor              # i32 chosen node row (-1 = helps nowhere)
    victim_mask: torch.Tensor       # bool[M] pods to evict (on the chosen node)
    n_victims: torch.Tensor         # i32
    n_pdb_violations: torch.Tensor  # i32 victims whose eviction violates a PDB


def preemption_candidates(per_pred, valid, aff_rules_ok=None):
    """bool[B, N]: nodes where preemption might help — the pod does not fit,
    but no unresolvable predicate failed (nodesWherePreemptionMightHelp).
    aff_rules_ok: bool[B, N] from ops.predicates.required_affinity_ok;
    nodes failing the pod's required affinity rules are excluded."""
    fits = torch.all(per_pred, dim=1)
    idx = torch.tensor([PRED_INDEX[p] for p in UNRESOLVABLE],
                       device=per_pred.device)
    hard_fail = torch.any(~per_pred[:, idx, :], dim=1)
    if aff_rules_ok is not None:
        hard_fail = hard_fail | ~aff_rules_ok
    return (~fits) & (~hard_fail) & valid[None]


def sorted_victim_slots(pods_priority, pods_valid, pods_node, pod_priority,
                        pods_violating=None, pods_start=None, cap: int = 1024):
    """Host helper: arena indices of potential victims in reprieve order
    (generic_scheduler.go:1085-1115): PDB-violating victims first, then
    non-violating; within each group highest priority first, then earliest
    start time (util.MoreImportantPod).  -1-padded to a power of two, and
    cut at `cap` slots, as in the JAX package."""
    prio = np.asarray(pods_priority)
    ok = (np.asarray(pods_valid) & (np.asarray(pods_node) >= 0)
          & (prio < pod_priority))
    idx = np.nonzero(ok)[0]
    viol = (np.asarray(pods_violating)[idx] if pods_violating is not None
            else np.zeros(len(idx), bool))
    start = (np.asarray(pods_start)[idx] if pods_start is not None
             else np.zeros(len(idx), np.float32))
    order = np.lexsort((start, -prio[idx], ~viol))  # violating group first
    idx = idx[order]
    k = 1
    while k < max(len(idx), 1) and k < cap:
        k *= 2
    idx = idx[:k]
    out = np.full(k, -1, np.int32)
    out[: len(idx)] = idx
    return out


def dense_start_ranks(starts) -> np.ndarray:
    """f32[M] dense ranks of f64 start times: rank comparisons on the device
    are exactly the f64 time comparisons."""
    starts = np.asarray(starts, np.float64)
    _, inv = np.unique(starts, return_inverse=True)
    return inv.astype(np.float32)


# UNRESOLVABLE as K11's bit mask (bit k: predicate k of PREDICATE_ORDER)
UNRESOLVABLE_MASK = sum(1 << PRED_INDEX[p] for p in UNRESOLVABLE)


def preempt_eval_plain(cluster, batch, cfg, unsched_taint_key: int):
    """K11's candidates mode's plain twin: bool[B, N], the JAX package's
    jitted make_preempt_eval (filter_batch, required_affinity_ok and
    preemption_candidates), bit for bit, in plain PyTorch."""
    from kubernetes_tpu_torch.ops.predicates import (
        filter_batch_plain,
        required_affinity_ok,
    )

    _, per_pred = filter_batch_plain(cluster, batch, cfg, unsched_taint_key)
    aff_ok = required_affinity_ok(cluster, batch)
    return preemption_candidates(per_pred, cluster.valid, aff_ok)


def preempt_eval(cluster, batch, cfg, unsched_taint_key: int):
    """The candidates of one preemption attempt, bool[B, N]: on CUDA
    tensors one K11 launch in candidates mode (its input preparation, the
    node-pair table's read and the terms' key slots, beside it; it
    launches or raises), on CPU tensors preempt_eval_plain."""
    if not cluster.valid.is_cuda:
        return preempt_eval_plain(cluster, batch, cfg, unsched_taint_key)
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops.predicates import pair_inputs

    node_pair, aff_slot = pair_inputs(cluster, batch)
    return kernels.filter_pass(cluster, batch, cfg, unsched_taint_key,
                               node_pair, aff_slot, kernels.K11_CANDIDATES,
                               UNRESOLVABLE_MASK)


def make_preempt_eval(cfg, unsched_taint_key: int):
    """Candidate evaluation on the device of the snapshot it is given:
    run(cluster, batch) -> bool[B, N] (preempt_eval)."""

    def run(cluster, batch):
        return preempt_eval(cluster, batch, cfg, unsched_taint_key)

    return run


def _exact_prio_sum(vic, prio, seg, n_segments):
    """Per-node victim priority sums as (hi, lo) int32 pairs, exact for any
    i32 priorities: each offset priority u = prio + 2^31 (the sign bit
    flipped on the uint32 view) splits into hi = u >> 16 and lo = u &
    0xffff; after the carry is normalised, (hi_sum, lo_sum) orders as the
    exact 48-bit sum (pickOneNodeForPreemption criterion 3).  vic bool[K],
    prio i32[K], seg i64[K] in [0, n_segments)."""
    offs = prio.to(torch.int64) + (1 << 31)
    hi = (offs >> 16).to(torch.int32) * vic.to(torch.int32)
    lo = (offs & 0xFFFF).to(torch.int32) * vic.to(torch.int32)
    z = torch.zeros(n_segments, dtype=torch.int32, device=prio.device)
    hi_sum = z.clone().index_add_(0, seg, hi)
    lo_sum = z.index_add_(0, seg, lo)
    return hi_sum + (lo_sum >> 16), lo_sum & 0xFFFF


def _rank_table(key_node, key_order, valid, n_rows):
    """i64[n_rows, W] table of the entries whose key_node is a row, each
    row's entries in ascending key_order, -1-padded (W >= 1)."""
    pos = torch.nonzero(valid).flatten()
    table = torch.full((n_rows, 1), -1, dtype=torch.int64,
                       device=valid.device)
    if pos.numel() == 0:
        return table
    node = key_node[pos]
    order = torch.argsort(node * (int(key_order.max()) + 1)
                          + key_order[pos], stable=True)
    node, pos = node[order], pos[order]
    first = torch.searchsorted(node, node)
    rank = torch.arange(node.numel(), device=node.device) - first
    width = int(rank.max()) + 1
    table = torch.full((n_rows, width), -1, dtype=torch.int64,
                       device=valid.device)
    table[node, rank] = pos
    return table


def preempt_one_plain(requested, allocatable, pod_req, candidates, pods_node,
                      pods_priority, pods_req, pods_violating, pods_start,
                      victim_slots, vol_tables) -> PreemptionResult:
    """K2's plain twin: the JAX package's jitted preempt_one with has_vols
    (models/preemption.py:308), bit for bit, in plain PyTorch.

    requested, allocatable f32[N, E]; pod_req f32[E]; candidates bool[N];
    pods_node, pods_priority i32[M]; pods_req f32[M, E] (volume columns
    zeroed); pods_violating bool[M]; pods_start f32[M] (dense ranks);
    victim_slots i32[Kv] (distinct arena indices, -1 pads); vol_tables the
    five tensors of encoder.victim_volume_tables (slot_vids i32[Kv, VM],
    vid_type, vid_total, vid_listed i32[V], freed_vol_init f32[N, VT]),
    whose volume identities are node-local.

    The reference adds a node's listed requests in ascending arena index
    (its segment_sum), then the initial volume credit; the reprieve re-adds
    victims in slot order while `requested - freed + pod_req <=
    allocatable` holds on every requested column; nodes tie-break on the
    lowest row."""
    slot_vids, vid_type, vid_total, vid_listed, freed_vol_init = vol_tables
    dev = requested.device
    N, E = requested.shape
    VT = freed_vol_init.shape[1]
    RV = E - VT
    slot_ok = victim_slots >= 0
    m = victim_slots.clamp(min=0).to(torch.int64)
    node_m = pods_node.to(torch.int64)[m]
    seg_ok = slot_ok & (node_m >= 0) & (node_m < N)      # listed, in a segment
    rep_node = node_m.clamp(0, N - 1)                    # the scan's row
    K = victim_slots.shape[0]
    kpos = torch.arange(K, device=dev)

    # freed_all: each node's listed requests in ascending arena index
    req_pad = torch.cat([pods_req, pods_req.new_zeros((1, E))])
    m_pad = torch.cat([m, m.new_full((1,), pods_req.shape[0])])
    by_m = _rank_table(rep_node, m, seg_ok, N)
    freed = torch.zeros((N, E), dtype=torch.float32, device=dev)
    for j in range(by_m.shape[1]):
        freed = freed + req_pad[m_pad[by_m[:, j]]]
    freed = torch.cat([freed[:, :RV], freed[:, RV:] + freed_vol_init], 1)
    need = pod_req > 0

    def fits(rows, nodes):
        return ~torch.any(need & (requested[nodes] - rows + pod_req
                                  > allocatable[nodes]), dim=-1)

    possible = candidates & fits(freed, torch.arange(N, device=dev))

    # the reprieve: rank j of every node's slots, all nodes at once
    by_slot = _rank_table(rep_node, kpos, slot_ok, N)
    evicted = vid_listed.clone()
    kept = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    for j in range(by_slot.shape[1]):
        ks = by_slot[:, j]
        rows = torch.nonzero((ks >= 0) & possible).flatten()
        if rows.numel() == 0:
            continue
        k = ks[rows]
        new_row = freed[rows] - pods_req[m[k]]
        vids = slot_vids[k].to(torch.int64)              # [n, VM]
        has = vids >= 0
        vv = vids.clamp(min=0)
        full = has & (evicted[vv] >= vid_total[vv])
        t = vid_type.to(torch.int64)[vv]
        in_t = full & (t >= 0) & (t < VT)
        delta = torch.zeros((rows.numel(), VT + 1), dtype=torch.float32,
                            device=dev)
        delta.scatter_add_(1, torch.where(in_t, t, VT),
                           in_t.to(torch.float32))
        new_row = torch.cat([new_row[:, :RV],
                             new_row[:, RV:] + (-delta[:, :VT])], 1)
        keep = fits(new_row, rows)
        freed[rows] = torch.where(keep[:, None], new_row, freed[rows])
        dec = has & keep[:, None]
        evicted.index_add_(0, vv[dec], torch.full_like(vv[dec], -1,
                                                       dtype=evicted.dtype))
        kept[k] = keep

    # per-node keys over the final victims
    vic = seg_ok & ~kept[:K]
    seg = torch.where(seg_ok, node_m, N)
    prio = pods_priority[m]
    ones = vic.to(torch.int32)
    z = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    n_victims = z.clone().index_add_(0, seg, ones)[:N]
    viol = pods_violating[m]
    n_viol = z.clone().index_add_(0, seg, (vic & viol).to(torch.int32))[:N]
    max_prio = torch.full((N + 1,), INT_MIN, dtype=torch.int32, device=dev)
    max_prio = max_prio.scatter_reduce(
        0, seg, torch.where(vic, prio, INT_MIN), "amax")[:N]
    sum_hi, sum_lo = _exact_prio_sum(vic, prio, seg, N + 1)
    sum_hi, sum_lo = sum_hi[:N], sum_lo[:N]
    # criterion 5: the earliest start among the node's highest-priority
    # victims; F32_MAX on a node with pods but no such victim, +inf on a
    # node with no pod at all (the reference's empty-segment minimum)
    arena_node = pods_node.to(torch.int64)
    on = (arena_node >= 0) & (arena_node < N)
    has_pod = torch.zeros(N, dtype=torch.bool, device=dev)
    has_pod[arena_node[on]] = True
    is_top = vic & (prio == max_prio[rep_node])
    earliest = torch.where(has_pod, _F32_MAX, float("inf")).to(torch.float32)
    earliest = torch.cat([earliest, earliest.new_full((1,), float("inf"))])
    earliest = earliest.scatter_reduce(
        0, seg, torch.where(is_top, pods_start[m], _F32_MAX), "amin")[:N]

    # lexicographic pick (pickOneNodeForPreemption criteria 1-6)
    best = possible
    for key in (n_viol, max_prio, sum_hi, sum_lo, n_victims):
        low = torch.where(best, key, INT_MAX).min()
        best = best & (key == low)
    m5 = torch.where(best, earliest, -_F32_MAX).max()
    best = best & (earliest == m5)
    ok = possible.any()
    node = torch.where(ok, best.to(torch.uint8).argmax().to(torch.int32),
                       torch.tensor(-1, dtype=torch.int32, device=dev))
    victim_mask = torch.zeros(pods_node.shape[0], dtype=torch.bool,
                              device=dev)
    chosen = vic & (node_m == node.to(torch.int64)) & ok
    victim_mask[m[chosen]] = True
    n_out = victim_mask.sum().to(torch.int32)
    viol_out = (victim_mask & pods_violating).sum().to(torch.int32)
    return PreemptionResult(node, victim_mask, n_out, viol_out)


def preempt_one(requested, allocatable, pod_req, candidates, pods_node,
                pods_priority, pods_req, pods_violating, pods_start,
                victim_slots, vol_tables) -> PreemptionResult:
    """The node and victims for one preemptor.  CUDA tensors launch kernel
    K2 (kernels/preempt_one.cu); CPU tensors take preempt_one_plain."""
    if requested.is_cuda:
        from kubernetes_tpu_torch import kernels

        return PreemptionResult(*kernels.preempt_one(
            requested, allocatable, pod_req, candidates, pods_node,
            pods_priority, pods_req, pods_violating, pods_start,
            victim_slots, *vol_tables))
    return preempt_one_plain(requested, allocatable, pod_req, candidates,
                             pods_node, pods_priority, pods_req,
                             pods_violating, pods_start, victim_slots,
                             vol_tables)


def preempt_inputs(encoder, pod, cands, arena, slots, violating, max_vols,
                   device):
    """The host arrays of one preemption what-if, uploaded to `device`:
    (requested, allocatable, pod_req, candidates, pods_node,
    pods_priority, pods_req, pods_violating, pods_start, victim_slots,
    vol_tables) in preempt_one's order.  The per-pod volume-count columns
    are zeroed: the identity tables carry the volume credit."""
    pod_req_ext, requested_ext, allocatable_ext, pods_ext = (
        encoder.preemption_arrays(pod, max_vols))
    vol_tables = encoder.victim_volume_tables(slots)
    pods_ext = pods_ext.copy()
    pods_ext[:, requested_ext.shape[1] - vol_tables[4].shape[1]:] = 0.0
    f32, i32 = np.float32, np.int32
    up = _h2d_packed(
        [np.asarray(a, t) for a, t in (
            (requested_ext, f32), (allocatable_ext, f32), (pod_req_ext, f32),
            (cands, np.bool_), (arena.node, i32), (arena.priority, i32),
            (pods_ext, f32), (violating, np.bool_),
            (dense_start_ranks(arena.start), f32), (slots, i32))]
        + [np.asarray(a, f32 if i == 4 else i32)
           for i, a in enumerate(vol_tables)],
        torch.device(device), "preempt")
    return (*up[:10], tuple(up[10:]))


def _tick(timing, key, t0):
    now = time.monotonic()
    if timing is not None:
        timing[key] = timing.get(key, 0.0) + now - t0
    return now


def pick_preemption_node(encoder, pod, cands, arena, slots, violating,
                         max_vols, device="cuda",
                         timing: Optional[dict] = None):
    """The host driver of the pick -> verify -> veto loop:

      1. preempt_one picks (node, victims) over the extended what-if arrays
         (K2 on the card);
      2. verify_nomination re-runs the object-level predicates with the
         victims removed, where the what-if cannot model the failure;
      3. a veto masks the node and re-picks.

    Returns (node_row, victim_arena_indices, victim_pods, PreemptionResult)
    with node_row == -1 when preemption helps nowhere.  The verify runs
    when required (anti-)affinity terms live in the cluster or on the
    preemptor, service-affinity pins are configured, or the pick has no
    victims; KTPU_PREEMPT_VERIFY=always runs it on every pick.  timing:
    optional dict, seconds added under "arrays" (the what-if's host arrays
    and their upload), "pick" (K2 or its twin and the fetch of its result)
    and "verify"."""
    t = time.monotonic()
    cands = np.asarray(cands).copy()
    args = list(preempt_inputs(encoder, pod, cands, arena, slots, violating,
                               max_vols, device))
    aff = pod.spec.affinity
    need_verify = (
        os.environ.get("KTPU_PREEMPT_VERIFY", "") == "always"
        or encoder.has_required_pod_terms()
        or (aff is not None
            and (aff.pod_affinity is not None
                 or aff.pod_anti_affinity is not None))
        or bool(encoder.service_affinity_keys)
    )
    t = _tick(timing, "arrays", t)
    while cands.any():
        res = preempt_one(*args)
        row = int(host_fetch(res.node, tag="preempt"))
        if row < 0:
            _tick(timing, "pick", t)
            return -1, [], [], None
        victim_ms = np.nonzero(host_fetch(res.victim_mask, tag="preempt"))[0]
        t = _tick(timing, "pick", t)
        victims = [
            encoder.pods[arena.keys[m]].pod
            for m in victim_ms
            if arena.keys[m] in encoder.pods
            and encoder.pods[arena.keys[m]].pod is not None
        ]
        if not (need_verify or len(victims) == 0):
            return row, victim_ms, victims, res
        ok = verify_nomination(encoder, pod, row, victims, max_vols)
        t = _tick(timing, "verify", t)
        if ok:
            return row, victim_ms, victims, res
        cands[row] = False
        args[3][row] = False
    return -1, [], [], None


def verify_nomination(encoder, pod, row: int, victims, max_vols) -> bool:
    """Host-side nomination gate: the full object-level predicate set on the
    picked node with the victims removed (selectVictimsOnNode's
    podFitsOnNode what-if, generic_scheduler.go:1096-1100), covering what
    the counting what-if cannot (inter-pod anti-affinity after the
    removal), and vetoing the zero-victim false positive unless the pod
    genuinely fits."""
    from kubernetes_tpu_torch.cpuref import CPUScheduler

    node = encoder._row_node.get(row)
    if node is None:
        return False
    vic = {(v.namespace, v.name) for v in victims}
    remaining = [
        rec.pod
        for rec in encoder.pods.values()
        if rec.pod is not None and rec.node_row >= 0 and rec.key not in vic
    ]
    nodes = [n for n in encoder._row_node.values() if n is not None]
    ref = CPUScheduler(
        nodes,
        remaining,
        services=list(encoder._service_selectors),
        max_vols=max_vols,
        pvs=list(encoder.pvs.values()),
        pvcs=list(encoder.pvcs.values()),
        storage_classes=list(encoder.storage_classes.values()),
        service_affinity_labels=[
            encoder.interner.string(k) for k in encoder.service_affinity_keys
        ],
    )
    return all(ref.predicates(pod, node).values())
