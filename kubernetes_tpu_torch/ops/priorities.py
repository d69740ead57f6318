"""Score priorities as batched tensor functions (PyTorch port).

The counterpart of the JAX package's ops/priorities.py: each function
mirrors one reference priority (pkg/scheduler/algorithm/priorities/*) on
the whole pods x nodes grid, including the Map/Reduce normalization
(priorities/types.go:28-34, reduce.go NormalizeReduce) and the weighted sum
(core/generic_scheduler.go:767-772).  Reference scores are int64 on a 0..10
scale with integer truncation, reproduced with floor().

Floors make the last bit of an f32 expression matter, so this module
computes each floored expression the way the compiled reference program
does on the CPU, not merely the way its source reads:

  * XLA contracts `a * x + b * y` into fma(a, x, round(b * y)); the
    SelectorSpread blend and the interpolation in RequestedToCapacityRatio
    use `fma_f32`, an exactly rounded fused multiply-add built from f32
    operations only;
  * XLA turns a division by a constant into a multiplication by its f32
    reciprocal and folds constant factors into it; ImageLocality uses that
    folded factor.

Everything stays f32: f64 would move the port towards the numpy cpuref and
away from the JAX reference.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    DEFAULT_PRIORITY_WEIGHTS,
    PAD,
    PodBatch,
    PRIO_INDEX,
    RES_MEMORY,
    RES_MILLICPU,
    ScoreConfig,
)
from kubernetes_tpu_torch.ops.predicates import _eval_exprs, tolerated_taints

MAX_PRIORITY = 10.0
_PREFER_NO_SCHEDULE = 1

# ImageLocality thresholds (priorities/image_locality.go:33-36)
_IMG_MIN = 23.0 * 1024 * 1024
_IMG_MAX = 1000.0 * 1024 * 1024
# 10 * (s - MIN) / (MAX - MIN) as the compiled reference evaluates it:
# (s - MIN) * (f32(1 / (MAX - MIN)) * 10), rounded in f32 at each step
_IMG_SCALE = float(
    np.float32(np.float32(1.0) / np.float32(_IMG_MAX - _IMG_MIN))
    * np.float32(MAX_PRIORITY))

# SelectorSpread zone weighting (priorities/selector_spreading.go:34)
_ZONE_WEIGHT = 2.0 / 3.0
# the node term's weight as the compiled reference holds it (f32)
_NODE_WEIGHT_F32 = float(np.float32(1.0 - _ZONE_WEIGHT))


# ------------------------------------------------ exactly rounded f32 FMA


def _two_sum(a, b):
    """s + err == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """Veltkamp split of an f32 tensor into two 12-bit halves."""
    t = a * 4097.0
    hi = t - (t - a)
    return hi, a - hi


def _split_host(a: float):
    """_split of an f32 constant, in numpy f32 arithmetic on the host."""
    a = np.float32(a)
    t = np.float32(a * np.float32(4097.0))
    hi = np.float32(t - np.float32(t - a))
    return float(hi), float(np.float32(a - hi))


def _two_prod(a, b):
    """p + err == a * b exactly (Dekker), with no fused operations.  a is an
    f32 tensor or an f32 constant (split on the host, so no scalar tensor
    is made on the device)."""
    if isinstance(a, torch.Tensor):
        ah, al = _split(a)
    else:
        if float(np.float32(a)) != a:
            raise ValueError(f"{a!r} is not an f32 value")
        ah, al = _split_host(a)
    p = a * b
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _round_to_odd_sum(a, b):
    """a + b rounded to odd: when inexact, the neighbour with an odd last
    significand bit."""
    s, err = _two_sum(a, b)
    even = (s.view(torch.int32) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def fma_f32(a, b, c):
    """RN(a * b + c) with a single rounding, from f32 adds and multiplies
    only (Boldo & Melquiond's emulated FMA: exact product, exact sum with
    the addend, the two error terms rounded to odd, one final rounding).
    It reproduces the hardware FMA that XLA emits on the CPU, identically
    on both torch devices.  a: an f32 tensor or constant; b, c: f32
    tensors."""
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(c, ph)
    return th + _round_to_odd_sum(tl, pl)


def _fdiv_floor(a, b):
    """Integer-division semantics of the reference's int64 math (operands are
    non-negative here, so trunc == floor)."""
    return torch.floor(a / torch.clamp_min(b, 1e-30))


def _normalize_reduce(counts, max_priority=MAX_PRIORITY, reverse=False):
    """reduce.go NormalizeReduce over the node axis: score = max_priority *
    count / maxCount (floored), reversed if asked; all-max when maxCount==0
    and reverse."""
    maxc = torch.amax(counts, dim=-1, keepdim=True)
    score = _fdiv_floor(max_priority * counts, maxc)
    if reverse:
        score = max_priority - score
    return torch.where(maxc > 0, score, max_priority if reverse else 0.0)


# ----------------------------------------------------------------- resources
# State-parameterized cores, shared with the sequential engine
# (models/batched.py) where `requested` is the per-step state.


def node_capacity2(cluster: ClusterTensors):
    """(milliCPU, memory) allocatable -> f32[N, 2]."""
    return torch.stack(
        [cluster.allocatable[:, RES_MILLICPU], cluster.allocatable[:, RES_MEMORY]],
        dim=-1,
    )


def least_requested_score(req2, cap2):
    """least_requested.go leastRequestedScore over (cpu, mem) pairs:
    ((cap-req)*10/cap + ...)/2, int-floored at each step.
    req2 [..., N, 2], cap2 [N, 2] -> [..., N]."""
    per = _fdiv_floor((cap2 - req2) * MAX_PRIORITY, cap2)
    per = torch.where((cap2 == 0) | (req2 > cap2), 0.0, per)
    return torch.floor(torch.sum(per, dim=-1) / 2.0)


def most_requested_score(req2, cap2):
    per = _fdiv_floor(req2 * MAX_PRIORITY, cap2)
    per = torch.where((cap2 == 0) | (req2 > cap2), 0.0, per)
    return torch.floor(torch.sum(per, dim=-1) / 2.0)


def balanced_allocation_score(req2, cap2):
    """balanced_resource_allocation.go:41-67:
    int64((1 - |cpuFraction - memFraction|) * 10); 0 if either fraction >= 1."""
    frac = req2 / torch.clamp_min(cap2, 1e-30)
    over = torch.any((frac >= 1.0) | (cap2 == 0), dim=-1)
    diff = torch.abs(frac[..., 0] - frac[..., 1])
    return torch.where(over, 0.0, torch.floor((1.0 - diff) * MAX_PRIORITY))


def _requested_with_pod(cluster: ClusterTensors, pods: PodBatch):
    """nonzero-request (cpu, mem) per (pod, node) if the pod were placed
    (resource_allocation.go:49-58)."""
    return pods.nonzero_req[:, None, :] + cluster.nonzero_req[None]   # [B, N, 2]


def least_requested(cluster: ClusterTensors, pods: PodBatch):
    """LeastRequestedPriority (priorities/least_requested.go)."""
    return least_requested_score(
        _requested_with_pod(cluster, pods), node_capacity2(cluster)[None]
    )


def most_requested(cluster: ClusterTensors, pods: PodBatch):
    """MostRequestedPriority (priorities/most_requested.go)."""
    return most_requested_score(
        _requested_with_pod(cluster, pods), node_capacity2(cluster)[None]
    )


def balanced_allocation(cluster: ClusterTensors, pods: PodBatch):
    """BalancedResourceAllocation (balanced_resource_allocation.go:41-67)."""
    return balanced_allocation_score(
        _requested_with_pod(cluster, pods), node_capacity2(cluster)[None]
    )


# ------------------------------------------------------------ node affinity


def node_affinity(cluster: ClusterTensors, pods: PodBatch):
    """NodeAffinityPriority (priorities/node_affinity.go): sum the weights of
    matching preferredDuringScheduling terms, then NormalizeReduce(10, false)."""
    if pods.pref_weight.shape[1] == 0:
        # affinity-lean batch: no preferred terms anywhere -> all-zero counts
        return torch.zeros((pods.n_pods, cluster.n_nodes), dtype=torch.float32,
                           device=cluster.valid.device)
    m = _eval_exprs(
        cluster,
        pods.pref_expr_key,
        pods.pref_expr_op,
        pods.pref_expr_vals,
        pods.pref_expr_nval,
        pods.pref_expr_num,
        pods.pref_expr_valid,
    )                                                        # [B, PS, E, N]
    term_ok = torch.all(m, dim=2) & pods.pref_term_valid[..., None]
    counts = torch.sum(
        torch.where(term_ok, pods.pref_weight[..., None], 0.0), dim=1)
    return _normalize_reduce(counts)


# ---------------------------------------------------------- taint toleration


def taint_toleration(cluster: ClusterTensors, pods: PodBatch):
    """TaintTolerationPriority (priorities/taint_toleration.go): count
    intolerable PreferNoSchedule taints, NormalizeReduce(10, true)."""
    tolerated = tolerated_taints(
        pods, cluster.taint_key, cluster.taint_val, cluster.taint_effect)
    prefer = cluster.taint_effect == _PREFER_NO_SCHEDULE     # [N, T]
    counts = torch.sum((prefer[None] & ~tolerated).to(torch.float32), dim=-1)
    return _normalize_reduce(counts, reverse=True)


# ------------------------------------------------------------- image locality


def image_locality(cluster: ClusterTensors, pods: PodBatch):
    """ImageLocalityPriority (priorities/image_locality.go): sum spread-scaled
    sizes of the pod's images present on the node, clamp to [23MB, 1000MB],
    scale to 0..10."""
    nid = cluster.image_id[None]                             # [1, N, I]
    nsize = cluster.image_size[None]
    summed = torch.zeros((pods.n_pods, cluster.n_nodes), dtype=torch.float32,
                         device=nid.device)
    for c in range(pods.image_ids.shape[1]):
        pid = pods.image_ids[:, c, None, None]               # [B, 1, 1]
        hit = (pid != PAD) & (pid == nid)
        summed = summed + torch.sum(torch.where(hit, nsize, 0.0), dim=-1)
    clamped = torch.clamp(summed, _IMG_MIN, _IMG_MAX)
    return torch.floor((clamped - _IMG_MIN) * _IMG_SCALE)


# -------------------------------------------------------- prefer-avoid-pods


def node_prefer_avoid_pods(cluster: ClusterTensors, pods: PodBatch):
    """NodePreferAvoidPodsPriority (priorities/node_prefer_avoid_pods.go):
    0 if the node's preferAvoidPods annotation names the pod's RC/RS
    controller, else 10.  Registered with weight 10000."""
    owner = pods.owner_uid[:, None, None]                    # [B, 1, 1]
    avoid = (owner != PAD) & (owner == cluster.avoid_owner[None])   # [B, N, A]
    return torch.where(torch.any(avoid, dim=-1), 0.0, MAX_PRIORITY)


# ------------------------------------------------------------ selector spread


def zone_layout(cluster: ClusterTensors, zone_key_id: int):
    """(node_in_zone bool[N], zone_of_node i64[N], have_zones bool) from the
    synthetic GetZoneKey topology pairs; GetZoneKey gives each node at most
    ONE zone pair, so the argmax column is exact.  It depends on the
    snapshot only, so per-pod loops compute it once."""
    zmask = cluster.pair_topo_key == zone_key_id             # [TP]
    zpairs_b = cluster.topo_pairs & zmask[None]              # [N, TP] bool
    node_in_zone = torch.any(zpairs_b, dim=-1)               # [N]
    zone_of_node = torch.argmax(zpairs_b.to(torch.uint8), dim=-1)  # [N]
    return node_in_zone, zone_of_node, torch.any(node_in_zone)


def spread_score_from_counts(counts, cluster: ClusterTensors, zone_key_id: int,
                             zones=None):
    """The SelectorSpread reduce (selector_spreading.go:95-140) given per-node
    matching-pod counts [..., N]: fScore = (1-2/3)*nodeScore + 2/3*zoneScore,
    int-truncated.  Zone aggregation is a segment-sum over each node's zone
    pair id (index_add_ + gather).  The counts are integers, so the sums are
    exact in any order.  zones: zone_layout(cluster, zone_key_id), when the
    caller already has it."""
    max_node = torch.amax(counts, dim=-1, keepdim=True)
    node_score = torch.where(
        max_node > 0,
        MAX_PRIORITY * (max_node - counts) / torch.clamp_min(max_node, 1.0),
        MAX_PRIORITY,
    )
    node_in_zone, zone_of_node, have_zones = (
        zones if zones is not None else zone_layout(cluster, zone_key_id))
    TP = cluster.topo_pairs.shape[1]
    lead = counts.shape[:-1]
    n = counts.shape[-1]
    flat = counts.reshape((-1, n))
    contrib = torch.where(node_in_zone[None, :], flat, 0.0)
    zsums = torch.zeros((flat.shape[0], TP), dtype=flat.dtype,
                        device=flat.device)
    zsums.index_add_(1, zone_of_node, contrib)               # [M, TP]
    zcount_per_node = zsums[:, zone_of_node].reshape(lead + (n,))
    max_zone = torch.amax(zsums, dim=-1).reshape(lead + (1,))
    zone_score = torch.where(
        max_zone > 0,
        MAX_PRIORITY * (max_zone - zcount_per_node)
        / torch.clamp_min(max_zone, 1.0),
        MAX_PRIORITY,
    )
    # the compiled reference fuses the node term into an FMA whose addend
    # is the rounded zone term: fma(1/3, node, round(2/3 * zone))
    blended = torch.where(
        have_zones & node_in_zone,
        fma_f32(_NODE_WEIGHT_F32, node_score, _ZONE_WEIGHT * zone_score),
        node_score,
    )
    return torch.floor(blended)


def pod_group_onehot(pods: PodBatch, n_groups: int):
    """[B, G] one-hot of each pod's spread groups."""
    groups = torch.arange(n_groups, device=pods.group_ids.device)
    return (
        (pods.group_ids[:, :, None] == groups[None, None])
        & pods.group_valid[..., None]
    ).to(torch.float32).sum(dim=1)


def pod_spread_match(pods: PodBatch, n_groups: int):
    """f32[B, B] [i, j]: committing pod j raises pod i's spread count at
    j's node — j matches ALL of i's selectors ("i's group set is a subset
    of j's" over the one-hots).  Shared by both engines."""
    onehot = pod_group_onehot(pods, n_groups)                # [B, G]
    has_groups = torch.any(pods.group_valid, dim=1)          # [B]
    return (
        has_groups[:, None]
        & (torch.matmul(onehot, (1.0 - onehot).T) == 0)
    ).to(torch.float32)


def selector_spread(cluster: ClusterTensors, pods: PodBatch,
                    zone_key_id: int = 5):
    """SelectorSpreadPriority (priorities/selector_spreading.go:77-140)."""
    counts = spread_counts(cluster, pods)
    return spread_score_from_counts(counts, cluster, zone_key_id)


def spread_counts(cluster: ClusterTensors, pods: PodBatch):
    """f32[B, N] matching-pod counts: derived from the snapshot's per-group
    columns for spread-lean batches, else the host-computed AND counts."""
    if pods.spread_counts.shape[-1] != cluster.n_nodes:
        onehot = pod_group_onehot(pods, cluster.group_counts.shape[1])
        return onehot @ cluster.group_counts.T               # [B, N]
    return pods.spread_counts


# --------------------------------------------------------- inter-pod affinity


def inter_pod_affinity_score(cluster: ClusterTensors, pods: PodBatch):
    """InterPodAffinityPriority (priorities/interpod_affinity.go): signed
    weight sums over topology pairs, then the min/max normalize
    fScore = 10 * (sum - min) / (max - min)."""
    if pods.pref_pair_weights.shape[-1] != cluster.topo_pairs.shape[-1]:
        # lean batch: no affinity exposure anywhere -> score 0 everywhere
        return torch.zeros((pods.n_pods, cluster.n_nodes), dtype=torch.float32,
                           device=cluster.valid.device)
    sums = pods.pref_pair_weights @ cluster.topo_pairs.to(torch.float32).T
    valid = cluster.valid[None]
    big = 3.4e38
    mn = torch.amin(torch.where(valid, sums, big), dim=-1, keepdim=True)
    mx = torch.amax(torch.where(valid, sums, -big), dim=-1, keepdim=True)
    spread = mx - mn
    score = torch.where(
        spread > 0,
        torch.floor(MAX_PRIORITY * (sums - mn) / torch.clamp_min(spread, 1e-30)),
        0.0,
    )
    return torch.where(valid, score, 0.0)


# --------------------------------------------------- policy-driven priorities


def node_label_priority(cluster: ClusterTensors, pods: PodBatch, score_cfg):
    """NodeLabelPriority (priorities/node_label.go): per configured
    (key, presence) pref: 10 when presence matches, else 0, weighted."""
    total = torch.zeros((pods.n_pods, cluster.n_nodes), dtype=torch.float32,
                        device=cluster.valid.device)
    for key_id, presence, weight in score_cfg.label_prefs:
        present = torch.any(cluster.label_keys == key_id, dim=-1)  # [N]
        score = torch.where(present == bool(presence), MAX_PRIORITY, 0.0)
        total = total + weight * score[None, :]
    return total


def interp(x, xs, ys):
    """jnp.interp(x, xs, ys) with constant extrapolation, in the order the
    compiled reference evaluates it (the final multiply-add fused)."""
    n = xs.shape[0]
    i = torch.clamp(torch.searchsorted(xs, x.contiguous(), right=True),
                    1, n - 1)
    df = ys[i] - ys[i - 1]
    dx = xs[i] - xs[i - 1]
    delta = x - xs[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(
        dx0, ys[i - 1],
        fma_f32(delta / torch.where(dx0, 1.0, dx), df, ys[i - 1]))
    f = torch.where(x < xs[0], ys[0], f)
    return torch.where(x > xs[-1], ys[-1], f)


def rtc_tables(score_cfg, device):
    """(xs, ys) f32 tensors of the RequestedToCapacityRatio curve."""
    xs = torch.tensor([p[0] for p in score_cfg.rtc_shape], dtype=torch.float32,
                      device=device)
    ys = torch.tensor([p[1] for p in score_cfg.rtc_shape], dtype=torch.float32,
                      device=device)
    return xs, ys


def rtc_score(req2, cap2, xs, ys):
    """Utilization% through the piecewise-linear curve, averaged over
    (cpu, mem).  req2 [..., N, 2], cap2 [N, 2] -> [..., N]."""
    util = torch.where(cap2 > 0, req2 * 100.0 / torch.clamp_min(cap2, 1e-30),
                       100.0)
    return torch.floor(torch.sum(interp(util, xs, ys), dim=-1) / 2.0)


def requested_to_capacity_ratio(cluster: ClusterTensors, pods: PodBatch,
                                score_cfg):
    """RequestedToCapacityRatioPriority (priorities/
    requested_to_capacity_ratio.go)."""
    xs, ys = rtc_tables(score_cfg, cluster.valid.device)
    return rtc_score(_requested_with_pod(cluster, pods),
                     node_capacity2(cluster)[None], xs, ys)


def resource_limits(cluster: ClusterTensors, pods: PodBatch):
    """ResourceLimitsPriority (priorities/resource_limits.go, feature-gated):
    1 if the node's allocatable satisfies the pod's cpu+mem limits and at
    least one limit is set, else 0."""
    cap = node_capacity2(cluster)[None]                      # [1, N, 2]
    lim = pods.limits2[:, None, :]                           # [B, 1, 2]
    ok = torch.all((lim == 0) | (cap >= lim), dim=-1)
    any_lim = torch.any(pods.limits2 > 0, dim=-1)[:, None]
    return torch.where(ok & any_lim, 1.0, 0.0)


# ------------------------------------------------------------------ combined


def score_batch(cluster: ClusterTensors, pods: PodBatch, weights=None,
                score_cfg=None, zone_key_id: int = 5,
                skip_zero_weight: bool = False, need_per: bool = True):
    """All priorities + weighted sum -> (total f32[B, N], per f32[B, P, N]).

    weights follows PRIORITY_ORDER; defaults to the stock weights.  With
    need_per=False (the engines' hot path) only the weighted total of the
    nonzero-weight priorities is accumulated."""
    if score_cfg is None:
        score_cfg = ScoreConfig()
    if weights is None:
        weights = DEFAULT_PRIORITY_WEIGHTS
    w_host = np.asarray(weights, np.float32)
    makers = {
        "SelectorSpreadPriority":
            lambda: selector_spread(cluster, pods, zone_key_id),
        "InterPodAffinityPriority":
            lambda: inter_pod_affinity_score(cluster, pods),
        "LeastRequestedPriority": lambda: least_requested(cluster, pods),
        "BalancedResourceAllocation":
            lambda: balanced_allocation(cluster, pods),
        "NodePreferAvoidPodsPriority":
            lambda: node_prefer_avoid_pods(cluster, pods),
        "NodeAffinityPriority": lambda: node_affinity(cluster, pods),
        "TaintTolerationPriority": lambda: taint_toleration(cluster, pods),
        "ImageLocalityPriority": lambda: image_locality(cluster, pods),
        "MostRequestedPriority": lambda: most_requested(cluster, pods),
        "NodeLabelPriority":
            lambda: node_label_priority(cluster, pods, score_cfg),
        "RequestedToCapacityRatioPriority":
            lambda: requested_to_capacity_ratio(cluster, pods, score_cfg),
        "ResourceLimitsPriority": lambda: resource_limits(cluster, pods),
    }
    order = [name for name, _ in sorted(PRIO_INDEX.items(), key=lambda kv: kv[1])]
    dev = cluster.valid.device
    if not need_per:
        total = torch.zeros((pods.n_pods, cluster.n_nodes),
                            dtype=torch.float32, device=dev)
        for name in order:
            w_i = float(w_host[PRIO_INDEX[name]])
            if w_i != 0.0:
                total = total + w_i * makers[name]()
        return total, None
    zero = torch.zeros((pods.n_pods, cluster.n_nodes), dtype=torch.float32,
                       device=dev)
    per = [
        makers[name]()
        if not skip_zero_weight or w_host[PRIO_INDEX[name]] != 0.0 else zero
        for name in order
    ]
    stack = torch.stack(per, dim=1)                          # [B, P, N]
    # the weighted sum of integer-valued scores is exact in any order
    w = torch.as_tensor(w_host, device=dev)
    total = torch.einsum("bpn,p->bn", stack, w)
    return total, stack

