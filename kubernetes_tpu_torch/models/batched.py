"""Sequential-commit batch scheduling (PyTorch port).

The counterpart of the JAX package's models/batched.py: B pods are placed
strictly one at a time, each step filtering and scoring pod i against the
current device state, picking a host (argmax + round-robin tie-break, kernel
K1 on the card) and committing it, so pod i+1 sees pod i's resources, ports
and spreading counts exactly as if the reference had scheduled them one by
one (scheduler.go:438 scheduleOne).

The JAX version runs the steps under `lax.scan`; here they are a Python loop
over B with all state on the device.  Nothing in the loop reads a device
value back (no .item(), no bool()), so the host only enqueues work.

Dynamic state across steps (everything else is precomputed once per batch):
  requested[N, R], nonzero[N, 2]  — PodFitsResources + resource scores
  hosts so far [B]                — SelectorSpreadPriority in-batch counts,
                                    through the AND-match cross matrix
  port_used[N, PV]                — PodFitsHostPorts within the batch over a
                                    batch-local port vocabulary
  extra_aff/anti/forb/pref        — in-batch inter-pod affinity pair state
                                    (predicateMetadata.AddPod analogue) when
                                    aff_state is given
Nominated pods, attribution and quality top-k are later slices of the port:
the entry point raises NotImplementedError for them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api import labels as klabels
from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    DEFAULT_PRIORITY_WEIGHTS,
    FilterConfig,
    PRED_INDEX,
    PRIO_INDEX,
    PodBatch,
    ScoreConfig,
    _pow2,
)
from kubernetes_tpu_torch.ops.predicates import filter_batch
from kubernetes_tpu_torch.ops.priorities import (
    MAX_PRIORITY,
    balanced_allocation_score,
    image_locality,
    inter_pod_affinity_score,
    least_requested_score,
    most_requested_score,
    node_affinity,
    node_capacity2,
    node_label_priority,
    node_prefer_avoid_pods,
    pod_spread_match,
    resource_limits,
    rtc_score,
    rtc_tables,
    spread_counts,
    spread_score_from_counts,
    taint_toleration,
    zone_layout,
)
from kubernetes_tpu_torch.ops.select import (
    SELECT_IMPLS,
    limit_feasible,
    num_feasible_nodes_device,
    select_host,
)


@dataclass
class BatchPortState:
    """Batch-local host-port vocabulary (see module docstring)."""

    pod_ports: Any      # bool[B, PV]  ports requested by each pod
    conflict: Any       # bool[PV, PV] do two batch ports conflict


def encode_batch_ports(encoder, pods: Sequence) -> BatchPortState:
    """Host-side precompute of the batch port vocabulary (numpy).

    Conflict semantics mirror nodeinfo/host_ports.go CheckConflict:
    same protocol+port and (same IP or either wildcard)."""
    vocab = {}
    plist = []
    for pod in pods:
        for pp, ip in encoder._pod_ports(pod):
            if (pp, ip) not in vocab:
                vocab[(pp, ip)] = len(plist)
                plist.append((pp, ip))
    PV = _pow2(max(len(plist), 1))
    B = encoder.batch_pad(len(pods))
    pod_ports = np.zeros((B, PV), bool)
    for b, pod in enumerate(pods):
        for pp, ip in encoder._pod_ports(pod):
            pod_ports[b, vocab[(pp, ip)]] = True
    conflict = np.zeros((PV, PV), bool)
    for i, (pp1, ip1) in enumerate(plist):
        for j, (pp2, ip2) in enumerate(plist):
            conflict[i, j] = pp1 == pp2 and (ip1 == ip2 or ip1 == 0 or ip2 == 0)
    # NB: conflicts vs EXISTING node occupancy are the static
    # PodFitsHostPorts predicate's job; only in-batch claims live here
    return BatchPortState(pod_ports=pod_ports, conflict=conflict)


@dataclass
class BatchAffinityState:
    """In-batch inter-pod-affinity cross-match tensors.

    The per-pod pair tensors in PodBatch are computed against the PRE-batch
    snapshot; these matrices let the engines update affinity state as
    co-batched pods land (the tensorization of predicateMetadata's
    incremental AddPod, ref algorithm/predicates/metadata.go:64-94).

    Orientation: step axis first.  aff_match[j, i, t] = "batch pod j matches
    pod i's required-affinity term t" (namespaces + selector); anti_match
    likewise for pod i's anti terms; anti_own[j, t, i] = "pod i matches pod
    j's anti term t"; aff_own[j, t, i] = "pod i matches pod j's affinity
    term t" (the hard-affinity symmetric score)."""

    aff_match: Any      # bool[B, B, PT]
    anti_match: Any     # bool[B, B, AT]
    anti_own: Any       # bool[B, AT, B]
    aff_own: Any        # bool[B, PT, B]
    # preferred (soft) terms, both directions of the IPA score
    pref_topo_key: Any  # i32[B, PP]  topology key id of each preferred term
    pref_weight: Any    # f32[B, PP]  signed weight (+affinity / -anti)
    pref_match: Any     # bool[B, B, PP]  [j, i, t]: j matches i's term t
    pref_own: Any       # bool[B, PP, B]  [j, t, i]: i matches j's term t


class LeanBatchAffinity(NamedTuple):
    """Factored form of BatchAffinityState, what crosses the host->device
    link: match[owner i, term t, candidate j] = gm[i, t, group(j)], with G
    label groups padded to a power of two (the last group column is
    all-False and absorbs padding pods).  densify_batch_affinity rebuilds
    the dense tensors on the device."""

    gid: Any            # i32[B]      candidate j -> label-group id
    aff_gm: Any         # bool[B, PT, G]
    anti_gm: Any        # bool[B, AT, G]
    pref_gm: Any        # bool[B, PP, G]
    pref_topo_key: Any  # i32[B, PP]
    pref_weight: Any    # f32[B, PP]


def densify_batch_affinity(lean: LeanBatchAffinity) -> BatchAffinityState:
    """The dense cross-match tensors from the factors, on the factors'
    device: one gather along the group axis per family, then transposes."""
    gid = lean.gid.to(torch.int64)
    aff_own = lean.aff_gm.index_select(2, gid)      # [owner i, t, cand j]
    anti_own = lean.anti_gm.index_select(2, gid)
    pref_own = lean.pref_gm.index_select(2, gid)
    return BatchAffinityState(
        aff_match=aff_own.permute(2, 0, 1).contiguous(),   # [step j, i, t]
        anti_match=anti_own.permute(2, 0, 1).contiguous(),
        anti_own=anti_own,
        aff_own=aff_own,
        pref_topo_key=lean.pref_topo_key,
        pref_weight=lean.pref_weight,
        pref_match=pref_own.permute(2, 0, 1).contiguous(),
        pref_own=pref_own,
    )


def batch_has_pod_affinity(pods: Sequence) -> bool:
    """True if any pod carries pod-(anti-)affinity terms (required or
    preferred): the signal to run the engines with aff_state, so co-batched
    pods see each other in the filter and in the IPA score."""
    for p in pods:
        a = p.spec.affinity
        if a is not None and (
            a.pod_affinity is not None or a.pod_anti_affinity is not None
        ):
            return True
    return False


def encode_batch_affinity(encoder, pods: Sequence) -> LeanBatchAffinity:
    """Host-side (numpy) precompute of the in-batch cross-match factors;
    term slot order matches SnapshotEncoder._encode_pod_affinity
    (required[:PT] / required[:AT] in spec order).

    Candidates are grouped by (namespace, label signature) and each
    distinct (selector, namespaces) term's group-match vector is memoized,
    so only the factors cross the link.  Call it before encode_pods: it
    registers the preferred terms' topology keys."""
    d = encoder.dims
    B = encoder.batch_pad(len(pods))
    nb = len(pods)
    gid_of: dict = {}
    pod_gid = np.empty(max(nb, 1), np.int32)
    reps: list = []  # one (namespace, labels) representative per group
    for j, p in enumerate(pods):
        sig = (p.namespace, tuple(sorted(p.labels.items())))
        g = gid_of.get(sig)
        if g is None:
            g = gid_of[sig] = len(reps)
            reps.append((p.namespace, p.labels))
        pod_gid[j] = g
    # the LAST group column stays all-False in every gm tensor and absorbs
    # batch-padding pods, so they can never match a term
    G = _pow2(len(reps) + 1)
    gid = np.full(B, G - 1, np.int32)
    if nb:
        gid[:nb] = pod_gid[:nb]
    match_memo: dict = {}

    def term_gvec(term, owner_ns):
        """bool[G] group-match vector of one term, memoized by
        (requirements, namespaces)."""
        sel = klabels.selector_from_label_selector(term.label_selector)
        if sel is None:
            return None
        nss = term.namespaces or (owner_ns,)
        key = (tuple(sel.requirements), frozenset(nss))
        vec = match_memo.get(key)
        if vec is None:
            vec = np.zeros(G, bool)
            vec[: len(reps)] = np.fromiter(
                ((ns in nss) and sel.matches(lbls) for ns, lbls in reps),
                bool, count=len(reps),
            )
            match_memo[key] = vec
        return vec

    A = np.zeros((B, d.PT, G), bool)   # [owner i, term t, group g]
    N = np.zeros((B, d.AT, G), bool)

    def fill(out, terms, i, owner, slot=None):
        for t, term in enumerate(terms):
            vec = term_gvec(term, owner.namespace)
            if vec is not None:
                out[i, slot if slot is not None else t, :] = vec

    # preferred terms: owner-major lists of signed weights
    pref_lists = []
    for pod in pods:
        terms = []
        a = pod.spec.affinity
        if a is not None:
            if a.pod_affinity is not None:
                terms += [(+float(w.weight), w.term)
                          for w in a.pod_affinity.preferred]
            if a.pod_anti_affinity is not None:
                terms += [(-float(w.weight), w.term)
                          for w in a.pod_anti_affinity.preferred]
        pref_lists.append(terms)
    PP = _pow2(max([len(t) for t in pref_lists] + [1]))
    P = np.zeros((B, PP, G), bool)
    p_key = np.zeros((B, PP), np.int32)
    p_w = np.zeros((B, PP), np.float32)
    for i, pod in enumerate(pods):
        a = pod.spec.affinity
        if a is None:
            continue
        if a.pod_affinity is not None:
            fill(A, a.pod_affinity.required[: d.PT], i, pod)
        if a.pod_anti_affinity is not None:
            fill(N, a.pod_anti_affinity.required[: d.AT], i, pod)
        for t, (w, term) in enumerate(pref_lists[i][:PP]):
            p_w[i, t] = w
            p_key[i, t] = encoder.register_topology_key(term.topology_key)
            fill(P, [term], i, pod, slot=t)
    return LeanBatchAffinity(gid=gid, aff_gm=A, anti_gm=N, pref_gm=P,
                             pref_topo_key=p_key, pref_weight=p_w)


def check_exact_matmul(device) -> None:
    """The engines' count products (spread counts, incidence hits, prefix
    sums of requests) must be exact f32, as the reference's
    lax.Precision.HIGHEST products are: refuse to run with TF32 matmuls
    enabled on the card."""
    if torch.device(device).type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul."
            "allow_tf32 / float32_matmul_precision); the engines need "
            "exact f32 count products")


def reject_later_slices(nominated=None, attribution=False,
                        quality_topk=0) -> None:
    """The engine features this slice of the port does not carry yet: raise
    instead of ignoring them."""
    if nominated is not None:
        raise NotImplementedError("nominated pods are not ported yet")
    if attribution:
        raise NotImplementedError("attribution is not ported yet")
    if quality_topk:
        raise NotImplementedError("quality_topk is not ported yet")


def _dynamic_scores(cluster, req_cpu_mem, requested2, zone_key_id, counts,
                    rtc_xs=None, rtc_ys=None, need_most=True, zones=None):
    """The state-dependent priorities, recomputed per step from the shared
    scoring cores in ops/priorities.py.

    req_cpu_mem: f32[2] nonzero request of the current pod;
    requested2: f32[N, 2] current nonzero usage;
    counts: f32[N] pods matching ALL the pod's spread selectors per node.
    most / rtc are None when their weight is 0 (they would add 0); zones is
    the batch's zone_layout."""
    cap = node_capacity2(cluster)                            # [N, 2]
    req = requested2 + req_cpu_mem[None, :]
    least = least_requested_score(req, cap)                  # [N]
    most = most_requested_score(req, cap) if need_most else None
    balanced = balanced_allocation_score(req, cap)
    spread = spread_score_from_counts(counts, cluster, zone_key_id, zones)
    rtc = rtc_score(req, cap, rtc_xs, rtc_ys) if rtc_xs is not None else None
    return least, most, balanced, spread, rtc


def _weighted(w, index_name):
    return float(w[PRIO_INDEX[index_name]])


def static_pass(cluster: ClusterTensors, pods: PodBatch, cfg: FilterConfig,
                unsched_taint_key: int, w, score_cfg, extra_mask=None,
                extra_score=None, in_batch_affinity=False):
    """(static_mask bool[B, N], static_score f32[B, N]): every predicate
    except the resource fit (recomputed per step), and the
    state-independent priorities, in one batched pass.  With
    in_batch_affinity, MatchInterPodAffinity and the IPA score are left
    out too: the steps evaluate them against the in-batch pair state."""
    _, per_pred = filter_batch(cluster, pods, cfg, unsched_taint_key)
    keep = torch.ones(per_pred.shape[1], dtype=torch.bool,
                      device=per_pred.device)
    keep[PRED_INDEX["PodFitsResources"]] = False
    keep[PRED_INDEX["GeneralPredicates"]] = False
    if in_batch_affinity:
        keep[PRED_INDEX["MatchInterPodAffinity"]] = False
    static_mask = (
        torch.all(per_pred | ~keep[None, :, None], dim=1)
        & cluster.valid[None]
        & pods.valid[:, None]
    )
    if extra_mask is not None:
        static_mask = static_mask & extra_mask
    ipa = (torch.zeros((), dtype=torch.float32, device=cluster.valid.device)
           if in_batch_affinity else inter_pod_affinity_score(cluster, pods))
    static_score = (
        _weighted(w, "InterPodAffinityPriority") * ipa
        + _weighted(w, "NodePreferAvoidPodsPriority")
        * node_prefer_avoid_pods(cluster, pods)
        + _weighted(w, "NodeAffinityPriority") * node_affinity(cluster, pods)
        + _weighted(w, "TaintTolerationPriority")
        * taint_toleration(cluster, pods)
        + _weighted(w, "ImageLocalityPriority") * image_locality(cluster, pods)
    )
    if _weighted(w, "NodeLabelPriority"):
        static_score = static_score + _weighted(w, "NodeLabelPriority") * (
            node_label_priority(cluster, pods, score_cfg))
    if _weighted(w, "ResourceLimitsPriority"):
        static_score = static_score + _weighted(w, "ResourceLimitsPriority") * (
            resource_limits(cluster, pods))
    if extra_score is not None:
        static_score = static_score + extra_score
    return static_mask, static_score


def topology_key_pairs(key_ids, cluster: ClusterTensors):
    """bool[..., TP]: the topology-pair slots of each term's key
    (key_ids i32[...])."""
    return key_ids[..., None] == cluster.pair_topo_key


def ipa_normalize(raw, valid):
    """InterPodAffinityPriority's fScore = floor(10 * (raw - min) / (max -
    min)) of raw pair-weight sums f32[..., N], min and max taken over the
    valid nodes of the last axis (interpod_affinity.go); 0 off the valid
    nodes and where every valid node scores the same."""
    big = 3.4e38
    mn = torch.amin(torch.where(valid, raw, big), dim=-1, keepdim=True)
    mx = torch.amax(torch.where(valid, raw, -big), dim=-1, keepdim=True)
    spr = mx - mn
    ipa = torch.where(spr > 0, torch.floor(MAX_PRIORITY * (raw - mn) / spr),
                      0.0)
    return torch.where(valid, ipa, 0.0)


def make_sequential_scheduler(
    cfg: FilterConfig = FilterConfig(),
    weights=None,
    unsched_taint_key: int = 0,
    zone_key_id: int = 5,
    score_cfg: Optional[ScoreConfig] = None,
    percentage_of_nodes_to_score: int = 100,
    attribution: bool = False,
    quality_topk: int = 0,
    device="cuda",
    select_impl: str = "kernel",
):
    """Build the sequential-commit scheduler.

    Returns fn(cluster, pods, ports: BatchPortState, last_index0,
    nominated=None, extra_mask=None, extra_score=None, aff_state=None) ->
      (hosts i32[B] (-1 = unschedulable), new_cluster) where new_cluster has
      the committed requested/nonzero columns and shares every other leaf.
    Inputs may be numpy (as the encoder emits them) or tensors; they are
    moved to `device` first.  aff_state (LeanBatchAffinity or
    BatchAffinityState) moves MatchInterPodAffinity and the IPA score into
    the steps, against the pre-batch pair tensors plus the pairs of the
    pods committed so far.  select_impl="plain" selects with K1's plain
    twin on the card (comparisons only)."""
    reject_later_slices(attribution=attribution, quality_topk=quality_topk)
    if select_impl not in SELECT_IMPLS:
        raise ValueError(f"select_impl {select_impl!r} not in {SELECT_IMPLS}")
    if score_cfg is None:
        score_cfg = ScoreConfig()
    device = torch.device(device)
    w = np.asarray(
        DEFAULT_PRIORITY_WEIGHTS if weights is None else weights, np.float32
    )
    w_least = _weighted(w, "LeastRequestedPriority")
    w_most = _weighted(w, "MostRequestedPriority")
    w_bal = _weighted(w, "BalancedResourceAllocation")
    w_spread = _weighted(w, "SelectorSpreadPriority")
    w_rtc = _weighted(w, "RequestedToCapacityRatioPriority")
    w_ipa = _weighted(w, "InterPodAffinityPriority")
    hard_w = float(cfg.hard_pod_affinity_weight)
    f32 = torch.float32

    def schedule(cluster, pods, ports, last_index0: int, extra_mask=None,
                 extra_score=None, aff: Optional[BatchAffinityState] = None):
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        static_mask, static_score = static_pass(
            cluster, pods, cfg, unsched_taint_key, w, score_cfg,
            extra_mask, extra_score, in_batch_affinity=aff is not None)
        feas_limit = (
            num_feasible_nodes_device(
                torch.sum(cluster.valid, dtype=torch.int32),
                percentage_of_nodes_to_score)
            if percentage_of_nodes_to_score < 100  # 0 = adaptive
            else None
        )
        rtc_xs, rtc_ys = (rtc_tables(score_cfg, dev) if w_rtc
                          else (None, None))
        # in-batch spread cross-matches (countMatchingPods AND semantics),
        # the same helper the speculative engine uses
        spread_match = pod_spread_match(pods, cluster.group_counts.shape[1])
        spread_base = spread_counts(cluster, pods)            # [B, N]
        zones = zone_layout(cluster, zone_key_id)
        conflict_f = ports.conflict.to(torch.float32)
        node_ids = torch.arange(N, device=dev)
        requested = cluster.requested
        nonzero2 = cluster.nonzero_req
        port_used = torch.zeros((N, ports.pod_ports.shape[1]),
                                dtype=torch.bool, device=dev)
        hosts = torch.full((B,), -1, dtype=torch.int64, device=dev)
        if aff is not None:
            topo_t = cluster.topo_pairs.to(f32).T                 # [TP, N]
            TP = topo_t.shape[0]
            PT = pods.aff_term_pairs.shape[1]
            AT = pods.anti_term_pairs.shape[1]
            aff_kp = topology_key_pairs(pods.aff_term_topo_key, cluster)
            anti_kp = topology_key_pairs(pods.anti_term_topo_key, cluster)
            pref_kp = topology_key_pairs(aff.pref_topo_key, cluster)
            # the pairs of the pods committed so far, per later pod
            extra_aff = torch.zeros((B, PT, TP), dtype=torch.bool, device=dev)
            extra_anti = torch.zeros((B, AT, TP), dtype=torch.bool,
                                     device=dev)
            extra_forb = torch.zeros((B, TP), dtype=torch.bool, device=dev)
            extra_pref = torch.zeros((B, TP), dtype=f32, device=dev)
        for b in range(B):
            req = pods.req[b]
            nz2 = pods.nonzero_req[b]
            pport = ports.pod_ports[b]
            # dynamic resource fit (PodFitsResources on current state)
            fit = ~torch.any(
                (req[None, :] > 0)
                & (requested + req[None, :] > cluster.allocatable),
                dim=-1,
            )
            # in-batch port conflicts: used claims x conflict matrix
            claimed_conflict = (port_used.to(torch.float32) @ conflict_f) > 0
            port_bad = torch.any(pport[None, :] & claimed_conflict, dim=-1)
            mask = static_mask[b] & fit & ~port_bad
            if aff is not None:
                # MatchInterPodAffinity against (pre-batch | in-batch)
                # pairs, and the IPA score's raw sums: the node hits of
                # every term row, of the rows' topology keys and of the
                # weights in one product with the topology (integer
                # counts and sums: exact)
                aff_pairs = pods.aff_term_pairs[b] | extra_aff[b]   # [PT, TP]
                anti_pairs = pods.anti_term_pairs[b] | extra_anti[b]
                forb = pods.forbidden_pairs[b] | extra_forb[b]      # [TP]
                prefw = pods.pref_pair_weights[b] + extra_pref[b]
                rows = torch.cat([
                    aff_pairs.to(f32), aff_kp[b].to(f32),
                    anti_pairs.to(f32), forb.to(f32)[None],
                    prefw[None]])
                hit = rows @ topo_t                                 # [K, N]
                aff_hit = hit[:PT] > 0
                node_has_key = hit[PT:2 * PT] > 0
                anti_hit = hit[2 * PT:2 * PT + AT] > 0
                viol1 = hit[2 * PT + AT] > 0
                raw = hit[2 * PT + AT + 1]
                any_match = torch.any(aff_pairs, dim=-1)            # [PT]
                bootstrap = (~any_match[:, None]
                             & pods.aff_term_self[b][:, None] & node_has_key)
                term_ok = (aff_hit | bootstrap
                           | ~pods.aff_term_valid[b][:, None])
                aff_ok = torch.all(term_ok, dim=0)                  # [N]
                viol2 = torch.any(
                    anti_hit & pods.anti_term_valid[b][:, None], dim=0)
                mask = mask & aff_ok & ~viol1 & ~viol2
            # spread counts: pre-batch base + earlier in-batch commits whose
            # pod covers this pod's selector set (integer sums: exact)
            placed = hosts >= 0
            extra = torch.zeros(N, dtype=torch.float32, device=dev)
            extra.index_add_(0, torch.clamp_min(hosts, 0),
                             spread_match[b] * placed)
            least, most, balanced, spread, rtc = _dynamic_scores(
                cluster, nz2, nonzero2, zone_key_id, spread_base[b] + extra,
                rtc_xs, rtc_ys, need_most=bool(w_most), zones=zones)
            # integer-valued addends: the weighted sum is exact in any
            # order, and a zero-weight term adds exactly 0
            total = static_score[b] + w_least * least
            if w_most:
                total = total + w_most * most
            total = total + w_bal * balanced + w_spread * spread
            if w_rtc:
                total = total + w_rtc * rtc
            if aff is not None:
                # the IPA score over (pre-batch | in-batch) raw pair
                # weights, renormalized per step
                total = total + w_ipa * ipa_normalize(raw, cluster.valid)
            last_idx = last_index0 + b
            if feas_limit is not None:
                # adaptive node sampling with the rotating start offset
                mask = limit_feasible(mask, feas_limit, last_idx)
            host, feasible = select_host(total, mask, last_idx, select_impl)
            # commit
            onehot = (node_ids == host) & feasible                # [N]
            requested = requested + onehot[:, None] * req[None, :]
            nonzero2 = nonzero2 + onehot[:, None] * nz2[None, :]
            port_used = port_used | (onehot[:, None] & pport[None, :])
            hosts[b] = torch.where(feasible, host.to(torch.int64), -1)
            if aff is not None:
                # predicateMetadata.AddPod analogue: the committed pod's
                # topology pairs flow into later pods' affinity state
                node_pairs = cluster.topo_pairs.index_select(
                    0, host.reshape(1).to(torch.int64))[0] & feasible  # [TP]
                extra_aff = extra_aff | (
                    aff.aff_match[b][:, :, None] & aff_kp & node_pairs)
                extra_anti = extra_anti | (
                    aff.anti_match[b][:, :, None] & anti_kp & node_pairs)
                # its anti terms forbid their domains to matching pods
                keyed_anti = (anti_kp[b] & node_pairs).to(f32)    # [AT, TP]
                extra_forb = extra_forb | (
                    aff.anti_own[b].T.to(f32) @ keyed_anti > 0)
                # hard-affinity symmetry: its required affinity terms add
                # hard_w per matching later pod per pair
                keyed_aff = (aff_kp[b] & node_pairs).to(f32)      # [PT, TP]
                extra_pref = extra_pref + hard_w * (
                    aff.aff_own[b].T.to(f32) @ keyed_aff)
                # preferred terms, both directions: later pods' own terms
                # that it matches, then its terms that match later pods
                kp = (pref_kp & node_pairs).to(f32)               # [B, PP, TP]
                extra_pref = extra_pref + torch.einsum(
                    "it,itp->ip",
                    aff.pref_match[b].to(f32) * aff.pref_weight, kp)
                keyed_pref = (pref_kp[b] & node_pairs).to(f32)    # [PP, TP]
                extra_pref = extra_pref + torch.einsum(
                    "ti,t,tp->ip", aff.pref_own[b].to(f32),
                    aff.pref_weight[b], keyed_pref)
        new_cluster = dataclasses.replace(
            cluster, requested=requested, nonzero_req=nonzero2)
        return hosts.to(torch.int32), new_cluster

    def schedule_entry(cluster, pods, ports, last_index0, nominated=None,
                       extra_mask=None, extra_score=None, aff_state=None):
        """Host entry: move the inputs to the device (a lean affinity state
        is densified there), then run the steps."""
        reject_later_slices(nominated=nominated)
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods, ports, extra_mask, extra_score = transfer.upload_batch(
            pods, ports, device, extra_mask, extra_score)
        aff = transfer.upload_affinity(aff_state, device)
        return schedule(cluster, pods, ports, int(last_index0), extra_mask,
                        extra_score, aff)

    schedule_entry.engine_kind = "sequential"
    return schedule_entry
