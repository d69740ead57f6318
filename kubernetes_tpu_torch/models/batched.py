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
In-batch pod (anti-)affinity (aff_state), nominated pods, attribution and
quality top-k are later slices of the port: the entry point raises
NotImplementedError for them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

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


def reject_later_slices(nominated=None, aff_state=None, attribution=False,
                        quality_topk=0) -> None:
    """The engine features this slice of the port does not carry yet: raise
    instead of ignoring them."""
    if aff_state is not None:
        raise NotImplementedError(
            "in-batch pod (anti-)affinity (aff_state) is not ported yet")
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
                extra_score=None):
    """(static_mask bool[B, N], static_score f32[B, N]): every predicate
    except the resource fit (recomputed per step), and the
    state-independent priorities, in one batched pass."""
    _, per_pred = filter_batch(cluster, pods, cfg, unsched_taint_key)
    keep = torch.ones(per_pred.shape[1], dtype=torch.bool,
                      device=per_pred.device)
    keep[PRED_INDEX["PodFitsResources"]] = False
    keep[PRED_INDEX["GeneralPredicates"]] = False
    static_mask = (
        torch.all(per_pred | ~keep[None, :, None], dim=1)
        & cluster.valid[None]
        & pods.valid[:, None]
    )
    if extra_mask is not None:
        static_mask = static_mask & extra_mask
    static_score = (
        _weighted(w, "InterPodAffinityPriority")
        * inter_pod_affinity_score(cluster, pods)
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
    moved to `device` first.  select_impl="plain" selects with K1's plain
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

    def schedule(cluster, pods, ports, last_index0: int, extra_mask=None,
                 extra_score=None):
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        static_mask, static_score = static_pass(
            cluster, pods, cfg, unsched_taint_key, w, score_cfg,
            extra_mask, extra_score)
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
        new_cluster = dataclasses.replace(
            cluster, requested=requested, nonzero_req=nonzero2)
        return hosts.to(torch.int32), new_cluster

    def schedule_entry(cluster, pods, ports, last_index0, nominated=None,
                       extra_mask=None, extra_score=None, aff_state=None):
        """Host entry: move the inputs to the device, then run the steps."""
        reject_later_slices(nominated=nominated, aff_state=aff_state)
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods, ports, extra_mask, extra_score = transfer.upload_batch(
            pods, ports, device, extra_mask, extra_score)
        return schedule(cluster, pods, ports, int(last_index0), extra_mask,
                        extra_score)

    schedule_entry.engine_kind = "sequential"
    return schedule_entry
