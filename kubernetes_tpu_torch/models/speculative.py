"""Speculative parallel placement: the high-throughput engine (PyTorch port).

The counterpart of the JAX package's models/speculative.py, following its
host-driven-rounds path (`_host_rounds`): the whole batch is placed in a few
propose-and-commit rounds instead of B sequential steps.

  round r:
    1. mask/score every remaining pod against the current device state
       (filter_batch + score_batch over the pods x nodes grid) and pick a
       host per pod with the per-pod staggered tie-break (kernel K1);
    2. commit in batch order: pod b is accepted iff its proposed node still
       fits the resources of b PLUS every earlier same-node proposer this
       round, and none of b's host ports conflict with ports already
       claimed on the node or wanted by an earlier same-node proposer.
       "Earlier same-node proposer" is a strictly-lower-triangle incidence
       product.  Really-bounced pods get emask[b, node] = False and go to
       round r+1 against the updated state.

The host checks `active.any()` once per round.  After the rounds, the hybrid
exactness check runs on the host as in the reference (:838-853): any real
capacity/port bounce, or any pod left unscheduled, discards the speculative
result and redoes the batch through the sequential engine, so the
scheduled/unschedulable split always matches one-at-a-time semantics.

In-batch pod (anti-)affinity (aff_state), nominated pods and quality top-k
are later slices of the port: the entry point raises NotImplementedError for
them.  Reference semantics: core/generic_scheduler.go Schedule (:184-254) /
selectHost (:284-296).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    DEFAULT_PRIORITY_WEIGHTS,
    FilterConfig,
    PodBatch,
    PRIO_INDEX,
)
from kubernetes_tpu_torch.models.batched import (
    check_exact_matmul,
    make_sequential_scheduler,
    reject_later_slices,
)
from kubernetes_tpu_torch.ops.predicates import filter_batch
from kubernetes_tpu_torch.ops.priorities import (
    MAX_PRIORITY,
    pod_group_onehot,
    pod_spread_match,
    score_batch,
    spread_counts,
    spread_score_from_counts,
)
from kubernetes_tpu_torch.ops.select import (
    SELECT_IMPLS,
    limit_feasible,
    num_feasible_nodes_device,
    rotation_counters,
    select_hosts_batch,
)


def make_speculative_scheduler(
    cfg: FilterConfig = FilterConfig(),
    weights=None,
    unsched_taint_key: int = 0,
    zone_key_id: int = 5,
    score_cfg=None,
    percentage_of_nodes_to_score: int = 100,
    quality_topk: int = 0,
    device="cuda",
    select_impl: str = "kernel",
):
    """Same call contract as make_sequential_scheduler:
    fn(cluster, pods, ports, last_index0, nominated=None, extra_mask=None,
    extra_score=None, aff_state=None) -> (hosts i32[B] (-1 unschedulable),
    new_cluster with committed requested/nonzero columns).  hosts stays on
    the device so the caller can overlap its fetch with the next batch.

    After each call, fn.last_rounds holds the rounds used and fn.last_redo
    whether the batch was redone through the sequential engine."""
    reject_later_slices(quality_topk=quality_topk)
    if select_impl not in SELECT_IMPLS:
        raise ValueError(f"select_impl {select_impl!r} not in {SELECT_IMPLS}")
    device = torch.device(device)
    w_all = np.asarray(
        DEFAULT_PRIORITY_WEIGHTS if weights is None else weights, np.float32
    )
    exact_scan = make_sequential_scheduler(
        cfg=cfg, weights=weights, unsched_taint_key=unsched_taint_key,
        zone_key_id=zone_key_id, score_cfg=score_cfg,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score,
        device=device, select_impl=select_impl,
    )

    def _round(cluster: ClusterTensors, pods: PodBatch, pod_ports, conflict,
               escore, tril, c):
        """One propose-and-commit round; c is the carry dict (tensors plus
        the host-side rotation counter "li")."""
        B = pods.valid.shape[0]
        N = cluster.allocatable.shape[0]
        dev = cluster.valid.device
        reqf = pods.req
        nzf = pods.nonzero_req
        pports = pod_ports
        pports_f = pod_ports.to(torch.float32)
        conflict_f = conflict.to(torch.float32)
        cl = dataclasses.replace(cluster, requested=c["req"],
                                 nonzero_req=c["nz"])
        mask, _ = filter_batch(cl, pods, cfg, unsched_taint_key,
                               need_per=False)
        # spread freshness: base snapshot counts plus the in-batch commits
        # accumulated in the carry
        lean_spread = pods.spread_counts.shape[-1] != N
        w_use = w_all
        if lean_spread:
            # every pod in <= 1 spread group: the SelectorSpread score is a
            # function of the pod's GROUP, computed once per group over
            # [G, N] and broadcast with a one-hot product (exact: one
            # nonzero term per row)
            counts_g = cluster.group_counts.T + c["spread"]   # [G, N]
            scores_g = spread_score_from_counts(
                counts_g, cluster, zone_key_id)               # [G, N]
            onehot_g = pod_group_onehot(
                pods, cluster.group_counts.shape[1])          # [B, G]
            has_g = torch.any(onehot_g > 0, dim=-1)
            sp = torch.matmul(onehot_g, scores_g)
            # a groupless pod has zero counts everywhere -> score 10
            sp = torch.where(has_g[:, None], sp, MAX_PRIORITY)
            w_use = np.array(w_use, np.float32)
            w_spread = float(w_use[PRIO_INDEX["SelectorSpreadPriority"]])
            w_use[PRIO_INDEX["SelectorSpreadPriority"]] = 0.0
            pods_r = pods
        else:
            pods_r = dataclasses.replace(
                pods, spread_counts=spread_counts(cl, pods) + c["spread"])
        total, _ = score_batch(
            cl, pods_r, weights=w_use, score_cfg=score_cfg,
            zone_key_id=zone_key_id, skip_zero_weight=True, need_per=False,
        )
        if lean_spread:
            total = total + w_spread * sp
        mask = mask & c["active"][:, None] & c["emask"] & pods.valid[:, None]
        if percentage_of_nodes_to_score < 100:  # 0 = adaptive
            lim = num_feasible_nodes_device(
                torch.sum(cl.valid, dtype=torch.int32),
                percentage_of_nodes_to_score)
            mask = limit_feasible(mask, lim,
                                  rotation_counters(c["li"], B, dev))
        if escore is not None:
            total = total + escore
        hosts, feasible = select_hosts_batch(total, mask, c["li"],
                                             select_impl)
        hosts_l = hosts.to(torch.int64)
        prop = c["active"] & feasible            # proposers this round
        # earlier same-node proposers (batch order = commit order)
        same = (
            (hosts[:, None] == hosts[None, :])
            & prop[:, None] & prop[None, :]
        )
        prior = same.to(torch.float32) * tril                # [B, B]
        # request columns are multiples of 100m / 256Mi: the prefix sums
        # are exact in any summation order
        cum_req = torch.matmul(prior, reqf)                  # [B, R]
        node_req = c["req"][hosts_l]                         # [B, R]
        alloc_h = cluster.allocatable[hosts_l]
        over = (reqf > 0) & (node_req + cum_req + reqf > alloc_h)
        fits = ~torch.any(over, dim=1)
        # ports: conflict with claims already on the node OR with an
        # earlier same-node proposer's wanted ports
        prior_ports = torch.matmul(prior, pports_f) > 0
        claimed_h = c["claimed"][hosts_l]                    # [B, PV]
        blocked = torch.matmul(
            (claimed_h | prior_ports).to(torch.float32), conflict_f) > 0
        pconf = torch.any(pports & blocked, dim=1)
        accept = prop & fits & ~pconf
        accf = accept[:, None].to(torch.float32)
        # the accept pass is conservative (earlier proposers count even if
        # they bounce themselves); ban the node only when the bounce also
        # holds against the accepted-only prior state
        prior_acc = prior * accept[None, :].to(torch.float32)
        cum_acc = torch.matmul(prior_acc, reqf)
        over_acc = (reqf > 0) & (node_req + cum_acc + reqf > alloc_h)
        fits_acc = ~torch.any(over_acc, dim=1)
        prior_ports_acc = torch.matmul(prior_acc, pports_f) > 0
        blocked_acc = torch.matmul(
            (claimed_h | prior_ports_acc).to(torch.float32), conflict_f) > 0
        pconf_acc = torch.any(pports & blocked_acc, dim=1)
        real_bounce = prop & ~accept & (~fits_acc | pconf_acc)
        node_ids = torch.arange(N, dtype=torch.int64, device=dev)
        acc_node = accf * (hosts_l[:, None] == node_ids[None, :]).to(
            torch.float32)                                   # [B, N]
        if lean_spread:
            # group-granular commit counts ([G, N] carry)
            spread_next = c["spread"] + torch.matmul(onehot_g.T, acc_node)
        else:
            # the SAME AND-subset match the sequential engine uses
            spread_match = pod_spread_match(
                pods, cluster.group_counts.shape[1])         # [B, B] [i, j]
            spread_next = c["spread"] + torch.matmul(spread_match, acc_node)
        # committed state lands via scatter-add on the node axis (integer
        # multiples again: exact in any order)
        claimed_add = torch.zeros_like(c["claimed"], dtype=torch.float32)
        claimed_add.index_add_(0, hosts_l, (pports & accept[:, None]).to(
            torch.float32))
        return {
            "hosts": torch.where(accept, hosts, c["hosts"]),
            "req": c["req"].index_add(0, hosts_l, reqf * accf),
            "nz": c["nz"].index_add(0, hosts_l, nzf * accf),
            "spread": spread_next,
            "claimed": c["claimed"] | (claimed_add > 0),
            # really-bounced proposers never re-pick the node that bounced
            # them
            "emask": c["emask"] & ~(
                real_bounce[:, None] & (node_ids[None, :] == hosts_l[:, None])
            ),
            "li": c["li"] + B,
            # contention signals for the hybrid redo: any REAL
            # capacity/port bounce (plain batches need no order-inversion
            # term: it is subsumed, see the reference's _round)
            "inv": c["inv"] | torch.any(real_bounce),
            # retired: accepted, or nothing feasible this round
            "active": c["active"] & feasible & ~accept,
        }

    def _init_carry(cluster, pods, pod_ports, last_index0, emask0):
        B = pods.valid.shape[0]
        N = cluster.allocatable.shape[0]
        dev = cluster.valid.device
        lean_spread = pods.spread_counts.shape[-1] != N
        S = cluster.group_counts.shape[1] if lean_spread else B
        return {
            "hosts": torch.full((B,), -1, dtype=torch.int32, device=dev),
            "req": cluster.requested.to(torch.float32),
            "nz": cluster.nonzero_req.to(torch.float32),
            "spread": torch.zeros((S, N), dtype=torch.float32, device=dev),
            "claimed": torch.zeros((N, pod_ports.shape[1]), dtype=torch.bool,
                                   device=dev),
            "emask": emask0,
            "active": pods.valid,
            "li": last_index0,
            "inv": torch.zeros((), dtype=torch.bool, device=dev),
        }

    def schedule(cluster, pods, ports, last_index0, nominated=None,
                 extra_mask=None, extra_score=None, aff_state=None):
        reject_later_slices(nominated=nominated, aff_state=aff_state)
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods, ports, emask, escore = transfer.upload_batch(
            pods, ports, device, extra_mask, extra_score)
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        emask0 = (torch.ones((B, N), dtype=torch.bool, device=dev)
                  if emask is None else emask)
        tril = torch.tril(torch.ones((B, B), dtype=torch.float32, device=dev),
                          diagonal=-1)
        c = _init_carry(cluster, pods, ports.pod_ports, int(last_index0),
                        emask0)
        rounds = 0
        while bool(c["active"].any()):       # one host sync per round
            c = _round(cluster, pods, ports.pod_ports, ports.conflict,
                       escore, tril, c)
            rounds += 1
        schedule.last_rounds = rounds
        schedule.last_redo = False
        # the contention sentinels, checked on the host: a real bounce, or
        # a pod left unscheduled
        if bool(c["inv"]) or bool(torch.any(pods.valid & (c["hosts"] < 0))):
            # contention: the split could deviate from one-at-a-time
            # semantics, so redo the WHOLE batch through the exact
            # sequential engine (the speculative commits above never
            # touched the caller's cluster)
            schedule.last_redo = True
            return exact_scan(cluster, pods, ports, last_index0,
                              extra_mask=emask, extra_score=escore)
        new_cluster = dataclasses.replace(cluster, requested=c["req"],
                                          nonzero_req=c["nz"])
        return c["hosts"], new_cluster

    schedule.engine_kind = "speculative"
    schedule.last_rounds = 0
    schedule.last_redo = False
    return schedule
