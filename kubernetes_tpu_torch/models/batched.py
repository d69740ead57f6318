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
Nominated pods (preemptors awaiting their victims) join each step's
resource fit on their nominated node (podFitsOnNode's pass one) when
`nominated` is given; their port and anti-affinity claims arrive as the
host mask of encode_nominated_block, folded into extra_mask by the caller.
Attribution and quality top-k are later slices of the port: the entry point
raises NotImplementedError for them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api import labels as klabels
from kubernetes_tpu_torch.api.nodeaffinity import _term_matches_pod
from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    DEFAULT_PRIORITY_WEIGHTS,
    FilterConfig,
    PREDICATE_ORDER,
    PRIO_INDEX,
    PodBatch,
    ScoreConfig,
    _pow2,
)
from kubernetes_tpu_torch.ops.predicates import filter_batch
from kubernetes_tpu_torch.ops.priorities import (
    MAX_PRIORITY,
    balanced_allocation_score,
    least_requested_score,
    most_requested_score,
    node_capacity2,
    pod_spread_match,
    rtc_score,
    rtc_tables,
    score_batch,
    spread_counts,
    spread_score_from_counts,
    zone_layout,
)
from kubernetes_tpu_torch.ops.select import (
    SELECT_IMPLS,
    TopKQuality,
    limit_feasible,
    num_feasible_nodes_device,
    select_host,
    select_topk,
)


@dataclass
class BatchPortState:
    """Batch-local host-port vocabulary (see module docstring)."""

    pod_ports: Any      # bool[B, PV]  ports requested by each pod
    conflict: Any       # bool[PV, PV] do two batch ports conflict


@dataclass
class NominatedState:
    """Nominated pods (preemptors awaiting their victims' graceful exit).

    The two-pass fit evaluation (ref generic_scheduler.go:598-664
    podFitsOnNode) adds nominated pods with priority >= the scheduled pod's
    to their nominated node before filtering, so a preempted-for claim is
    visible to later cycles; the pod must ALSO fit without them (pass two).
    Resource claims live here (they interact with the engines' running
    state); port claims and anti-affinity contributions are host-computed
    per cycle into the extra_mask (encode_nominated_block)."""

    node: Any   # i32[K] nominated node row (-1 = unused slot)
    prio: Any   # i32[K]
    req: Any    # f32[K, R]


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


def encode_nominated(encoder, nominated_pairs, k_min: int = 8):
    """Host helper: (pod, node_name) pairs -> NominatedState (power-of-two
    padded), or None when empty."""
    pairs = [
        (p, encoder.node_rows.get(n, -1)) for p, n in nominated_pairs
    ]
    pairs = [(p, r) for p, r in pairs if r >= 0]
    if not pairs:
        return None
    K = _pow2(len(pairs), k_min)
    node = np.full(K, -1, np.int32)
    prio = np.zeros(K, np.int32)
    req = np.zeros((K, encoder.dims.R), np.float32)
    for i, (p, r) in enumerate(pairs):
        node[i] = r
        prio[i] = p.spec.priority
        v = encoder._req_vector(p.resource_request())
        req[i, : v.shape[0]] = v
    return NominatedState(node=node, prio=prio, req=req)


def encode_nominated_block(encoder, nominated_pairs, pods: Sequence,
                           n_pods: int, n_nodes: int):
    """Host precompute of the pass-one effects nominated pods have BEYOND
    resources: host-port claims and required anti-affinity (both
    directions).

    Returns bool[n_pods, n_nodes] with True = infeasible in pass one, or
    None when no nominated pod contributes.  Folded into the engines'
    extra_mask, so both engines see it without new device plumbing.

    Required AFFINITY that only a nominated pod satisfies needs no
    tensor: podFitsOnNode's second pass (WITHOUT nominated pods,
    generic_scheduler.go:598-664) must also succeed, so a nominated pod
    can never flip an affinity-infeasible node feasible.  What CAN flip
    feasible->infeasible — port conflicts and anti-affinity — is exactly
    what this mask carries."""
    pairs = [
        (p, encoder.node_rows.get(n, -1)) for p, n in nominated_pairs
    ]
    pairs = [(p, r) for p, r in pairs if 0 <= r < n_nodes]
    if not pairs:
        return None

    def anti_terms(pod):
        aff = pod.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            return ()
        return aff.pod_anti_affinity.required

    # rows sharing a topology (key, value) — the domain an anti term blocks
    def rows_in_domain(key: str, value):
        if value is None:
            return []
        return [
            row for row, node in encoder._row_node.items()
            if row < n_nodes and node.labels.get(key) == value
        ]

    block = np.zeros((n_pods, n_nodes), bool)
    any_block = False
    domain_cache: dict = {}

    def domain_rows(key: str, value):
        # hoisted per (key, value): the blocked rows depend only on the
        # nominated pod's node + term key, not on the batch pod
        if value is None:
            return []
        ck = (key, value)
        if ck not in domain_cache:
            domain_cache[ck] = rows_in_domain(key, value)
        return domain_cache[ck]

    for k_pod, r in pairs:
        k_node = encoder._row_node.get(r)
        if k_node is None:
            continue
        k_prio = k_pod.spec.priority
        k_ports = list(encoder._pod_ports(k_pod))
        k_anti = anti_terms(k_pod)
        for b, pod in enumerate(pods):
            if b >= n_pods:
                break
            if k_prio < pod.spec.priority:
                continue  # only >=-priority nominated pods join pass one
            # host-port claim on the nominated node (host_ports.go
            # CheckConflict: same port and same-or-wildcard IP)
            for pp1, ip1 in encoder._pod_ports(pod):
                if any(pp1 == pp2 and (ip1 == ip2 or ip1 == 0 or ip2 == 0)
                       for pp2, ip2 in k_ports):
                    block[b, r] = True
                    any_block = True
                    break
            # nominated pod's anti terms reject this pod across the domain
            for t in k_anti:
                if _term_matches_pod(t, k_pod, pod):
                    for row in domain_rows(
                            t.topology_key, k_node.labels.get(t.topology_key)):
                        block[b, row] = True
                        any_block = True
            # this pod's anti terms reject nodes whose domain now holds
            # a matching nominated pod
            for t in anti_terms(pod):
                if _term_matches_pod(t, pod, k_pod):
                    for row in domain_rows(
                            t.topology_key, k_node.labels.get(t.topology_key)):
                        block[b, row] = True
                        any_block = True
    return block if any_block else None


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


def reject_later_slices(attribution=False) -> None:
    """The engine features this slice of the port does not carry yet: raise
    instead of ignoring them."""
    if attribution:
        raise NotImplementedError("attribution is not ported yet")


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


# the priorities static_pass scores once a batch (the steps recompute the
# state-dependent ones: spread, least, balanced, most, RTC)
_STATIC_PRIORITIES = (
    "InterPodAffinityPriority", "NodePreferAvoidPodsPriority",
    "NodeAffinityPriority", "TaintTolerationPriority",
    "ImageLocalityPriority", "NodeLabelPriority", "ResourceLimitsPriority")


def static_profile(cfg: FilterConfig, w, in_batch_affinity=False):
    """(FilterConfig, f32[12] weights) of static_pass's one filter pass and
    one score pass: the profile without the resource fit (and, with
    in_batch_affinity, without MatchInterPodAffinity), and the weights of
    the state-independent priorities alone (others zeroed; the IPA weight
    too with in_batch_affinity)."""
    drop = {"PodFitsResources", "GeneralPredicates"}
    if in_batch_affinity:
        drop.add("MatchInterPodAffinity")
    names = cfg.enabled if cfg.enabled is not None else PREDICATE_ORDER
    static_cfg = dataclasses.replace(
        cfg, enabled=tuple(n for n in names if n not in drop))
    w_static = np.zeros(len(PRIO_INDEX), np.float32)
    for name in _STATIC_PRIORITIES:
        if not (in_batch_affinity and name == "InterPodAffinityPriority"):
            w_static[PRIO_INDEX[name]] = _weighted(w, name)
    return static_cfg, w_static


def static_pass(cluster: ClusterTensors, pods: PodBatch, cfg: FilterConfig,
                unsched_taint_key: int, w, score_cfg, extra_mask=None,
                extra_score=None, in_batch_affinity=False):
    """(static_mask bool[B, N], static_score f32[B, N]): every predicate
    except the resource fit (recomputed per step), and the
    state-independent priorities, in one batched pass.  With
    in_batch_affinity, MatchInterPodAffinity and the IPA score are left
    out too: the steps evaluate them against the in-batch pair state.

    The mask is one filter pass in mask mode with those predicates taken
    out of the profile (a disabled predicate reads all true), the score one
    score pass with every other priority's weight zeroed (static_profile):
    on CUDA tensors one K11 and one K12 launch.  The weighted rows add in
    PRIORITY_ORDER from 0, the order this sum has always taken, so the
    total is the same bit for bit."""
    static_cfg, w_static = static_profile(cfg, w, in_batch_affinity)
    static_mask, _ = filter_batch(cluster, pods, static_cfg,
                                  unsched_taint_key, need_per=False)
    if extra_mask is not None:
        static_mask = static_mask & extra_mask
    static_score, _ = score_batch(cluster, pods, weights=w_static,
                                  score_cfg=score_cfg, need_per=False)
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
    twin on the card (comparisons only).

    With quality_topk=K > 0 (output-only: the winners are the same) the
    call also returns an ops/select.TopKQuality as its last output: per
    pod, the winner-pinned top min(K, N) node rows, their scores and the
    feasible count, off each step's exact (total, mask, host, feasible)
    (kernel K3 at B=1 on the card)."""
    reject_later_slices(attribution=attribution)
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

    def schedule(cluster, pods, ports, last_index0: int, nom=None,
                 extra_mask=None, extra_score=None,
                 aff: Optional[BatchAffinityState] = None):
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        # quality top-k width, clamped to the arena (a 2-node cluster
        # cannot rank 3 rows)
        tkq = min(quality_topk, N) if quality_topk else 0
        if tkq:
            top_nodes = torch.full((B, tkq), -1, dtype=torch.int32,
                                   device=dev)
            top_scores = torch.zeros((B, tkq), dtype=f32, device=dev)
            top_feas = torch.zeros(B, dtype=torch.int32, device=dev)
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
        if nom is not None:
            onehot_nom = (nom.node[:, None] == node_ids[None, :]).to(f32)
            nom_live = nom.node >= 0                                # [K]
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
            if nom is not None:
                # two-pass nominated evaluation (podFitsOnNode,
                # generic_scheduler.go:598-664): pass one adds nominated
                # pods with priority >= this pod's to their nominated node;
                # the no-nominated pass is `fit` itself (resource fit is
                # monotone, so pass one implies pass two here).  The claim
                # sums whole request columns: exact in f32
                w_nom = ((nom.prio >= pods.priority[b]) & nom_live).to(f32)
                extra_nom = torch.einsum("k,kn,kr->nr", w_nom, onehot_nom,
                                         nom.req)                   # [N, R]
                fit_nom = ~torch.any(
                    (req[None, :] > 0)
                    & (requested + extra_nom + req[None, :]
                       > cluster.allocatable),
                    dim=-1,
                )
                fit = fit & fit_nom
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
            if tkq:
                # the winner-pinned ranking and feasible count off the
                # exact (mask, total, host) the selection used, the
                # sampling cut included
                q = select_topk(total, mask, host, feasible, tkq)
                top_nodes[b] = q.top_nodes
                top_scores[b] = q.top_scores
                top_feas[b] = q.feasible
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
        if tkq:
            return (hosts.to(torch.int32), new_cluster,
                    TopKQuality(top_nodes, top_scores, top_feas))
        return hosts.to(torch.int32), new_cluster

    def schedule_entry(cluster, pods, ports, last_index0, nominated=None,
                       extra_mask=None, extra_score=None, aff_state=None):
        """Host entry: move the inputs to the device (a lean affinity state
        is densified there), then run the steps.  nominated: a
        NominatedState (the port's or the JAX package's) or None."""
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods, ports, extra_mask, extra_score = transfer.upload_batch(
            pods, ports, device, extra_mask, extra_score)
        nom = transfer.upload_nominated(nominated, device)
        aff = transfer.upload_affinity(aff_state, device)
        return schedule(cluster, pods, ports, int(last_index0), nom,
                        extra_mask, extra_score, aff)

    schedule_entry.engine_kind = "sequential"
    # quality variants append a TopKQuality as the LAST output; 0 = off
    schedule_entry.quality_topk = quality_topk
    return schedule_entry
