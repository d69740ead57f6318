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
capacity/port bounce, any order inversion with interference (affinity
batches), or any pod left unscheduled, discards the speculative result and
redoes the batch through the sequential engine, so the
scheduled/unschedulable split always matches one-at-a-time semantics.

In-batch REQUIRED (anti-)affinity (aff_state): the carry holds the
per-topology-pair extras the sequential engine threads through its steps
(xaff/xanti/xforb/xpref), updated once a round from that round's accepted
placements.  Two orderings keep it faithful to the sequential semantics:
  * bootstrap gating: a pod whose required affinity term matches nothing
    may self-bootstrap only if no earlier-in-batch pod that could satisfy
    the term is still pending, so one group founder places first and its
    mates follow into its domain;
  * deferred retirement: a pod with no feasible node stays active while the
    round commits anything (its mates may open domains); a commit-free
    round retires only the first infeasible pod in batch order.
Within a round, a pod is bounced when an earlier proposer shares a
topology domain with it under either pod's anti-affinity terms.

Nominated pods and quality top-k are later slices of the port: the entry
point raises NotImplementedError for them.  Reference semantics:
core/generic_scheduler.go Schedule (:184-254) / selectHost (:284-296).
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
    ipa_normalize,
    make_sequential_scheduler,
    reject_later_slices,
    topology_key_pairs,
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
    w_ipa = float(w_all[PRIO_INDEX["InterPodAffinityPriority"]])
    # affinity batches move the IPA score out of score_batch into the
    # per-round dynamic evaluation (it must see in-batch commits)
    w_no_ipa = w_all.copy()
    w_no_ipa[PRIO_INDEX["InterPodAffinityPriority"]] = 0.0
    hard_w = float(cfg.hard_pod_affinity_weight)
    f32 = torch.float32
    exact_scan = make_sequential_scheduler(
        cfg=cfg, weights=weights, unsched_taint_key=unsched_taint_key,
        zone_key_id=zone_key_id, score_cfg=score_cfg,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score,
        device=device, select_impl=select_impl,
    )

    def _affinity_context(cluster, pods, aff, tril):
        """The state-independent affinity tensors of a batch, made once a
        batch: the topology as f32, each term's key-pair slots, and which
        pods are related through required terms in either direction."""
        a_any = torch.any(aff.aff_match, dim=2)    # [x, y]: x sats y's aff
        n_any = torch.any(aff.anti_match, dim=2)   # [x, y]: x matches y's anti
        return {
            "topo": cluster.topo_pairs.to(f32),                  # [N, TP]
            "aff_kp": topology_key_pairs(pods.aff_term_topo_key, cluster),
            "anti_kp": topology_key_pairs(pods.anti_term_topo_key, cluster),
            "pref_kp": topology_key_pairs(aff.pref_topo_key, cluster),
            "rel": a_any | a_any.T | n_any | n_any.T,
            "later": tril.T > 0,                                 # [i, j]: j > i
        }

    def _round(cluster: ClusterTensors, pods: PodBatch, pod_ports, conflict,
               escore, tril, aff, ax, c):
        """One propose-and-commit round; c is the carry dict (tensors plus
        the host-side rotation counter "li"); aff the dense
        BatchAffinityState or None, ax its _affinity_context."""
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
        if aff is not None:
            # bootstrap gating: pod i may self-bootstrap term t only when
            # no EARLIER-in-batch pod that could satisfy t is still
            # pending; the gate folds into aff_term_self, so the shared
            # MatchInterPodAffinity predicate evaluates the unioned
            # (pre-batch | in-batch) state unchanged
            earlier_alive = tril * c["active"].to(f32)[None, :]
            cb = torch.einsum("jit,ij->it", aff.aff_match.to(f32),
                              earlier_alive) <= 0             # [B, PT]
            pods_eval = dataclasses.replace(
                pods,
                aff_term_pairs=pods.aff_term_pairs | c["xaff"],
                anti_term_pairs=pods.anti_term_pairs | c["xanti"],
                forbidden_pairs=pods.forbidden_pairs | c["xforb"],
                aff_term_self=pods.aff_term_self & cb,
            )
        else:
            pods_eval = pods
        mask, _ = filter_batch(cl, pods_eval, cfg, unsched_taint_key,
                               need_per=False)
        # spread freshness: base snapshot counts plus the in-batch commits
        # accumulated in the carry
        lean_spread = pods.spread_counts.shape[-1] != N
        w_use = w_no_ipa if aff is not None else w_all
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
        if aff is not None:
            # dynamic IPA score over (pre-batch | in-batch) raw pair
            # weights, renormalized per pod
            topo = ax["topo"]
            raw = torch.matmul(pods.pref_pair_weights + c["xpref"],
                               topo.T)                        # [B, N]
            total = total + w_ipa * ipa_normalize(raw, cluster.valid[None])
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
        if aff is not None:
            # same-round required-anti ordering: pod b is rejected when an
            # earlier proposer j shares a topology domain with b under one
            # of b's anti terms (j matches it) or one of j's (b matches
            # it).  D[o, t, c] = "candidate c's proposed node is in owner
            # o's term-t domain at o's proposed node".
            H = topo[hosts_l]                                 # [B, TP]
            a_own = ax["anti_kp"].to(f32) * H[:, None, :]     # [B, AT, TP]
            D = torch.einsum("otp,cp->otc", a_own, H) > 0     # [B, AT, B]
            # am1[b, t, j] = "pod j matches pod b's required anti term t"
            am1 = aff.anti_match.permute(1, 2, 0)             # [B, AT, B]
            v1 = torch.any(D & am1, dim=1)                    # [b, j]
            v2 = torch.any(D & aff.anti_own, dim=1)           # [j, b]
            conf_ba = v1 | v2.T                               # [b, j]
            earlier_prop = (tril > 0) & prop[None, :]
            aviol = torch.any(conf_ba & earlier_prop, dim=1)
            accept = accept & ~aviol
            # order-inversion sentinel: a later pod committing while an
            # earlier one is passed over, where the commit can interfere
            # with what the earlier pod would have got one at a time (j's
            # node was feasible for i this round, or i and j are related
            # through required terms in either direction): the hybrid
            # check then redoes the batch
            passed_over = c["active"] & ~accept               # [i]
            interf = mask[:, hosts_l] | ax["rel"]             # [i, j]
            inv_new = torch.any(passed_over[:, None] & accept[None, :]
                                & ax["later"] & interf)
        else:
            # plain batches: the inversion term is subsumed by the other
            # two sentinels (see the reference's _round)
            inv_new = torch.zeros((), dtype=torch.bool, device=dev)
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
        if aff is not None:
            # an anti-violation against an ACCEPTED peer needs no emask
            # ban: next round's xanti/xforb exclude the whole domain
            aviol_acc = torch.any(
                conf_ba & (tril > 0) & accept[None, :], dim=1)
            real_bounce = real_bounce & ~aviol_acc
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
        out = {
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
            # the contention signals of the hybrid redo: order inversion
            # with interference, and any REAL capacity/port bounce
            "inv": c["inv"] | inv_new | torch.any(real_bounce),
        }
        if aff is None:
            # retired: accepted, or nothing feasible this round
            out["active"] = c["active"] & feasible & ~accept
            return out
        # deferred retirement: while the round commits anything, an
        # infeasible pod stays active (a mate's landing may open its
        # domain next round).  A commit-free round retires only the FIRST
        # infeasible pod in batch order, the pod the sequential engine
        # would fail next.
        inf = c["active"] & ~feasible
        first_inf = inf & (torch.cumsum(inf.to(torch.int32), 0) == 1)
        out["active"] = ((c["active"] & feasible & ~accept)
                         | torch.where(torch.any(accept), inf,
                                       inf & ~first_inf))
        # predicateMetadata.AddPod analogue, batched over this round's
        # accepted placements: their topology pairs flow into the pending
        # pods' affinity state for the next round
        aff_kp, anti_kp, pref_kp = ax["aff_kp"], ax["anti_kp"], ax["pref_kp"]
        accN = accf * H                                       # [B(j), TP]
        out["xaff"] = c["xaff"] | (
            (torch.einsum("jit,jp->itp", aff.aff_match.to(f32), accN) > 0)
            & aff_kp)
        out["xanti"] = c["xanti"] | (
            (torch.einsum("jit,jp->itp", aff.anti_match.to(f32), accN) > 0)
            & anti_kp)
        keyed_anti = anti_kp.to(f32) * accN[:, None, :]
        out["xforb"] = c["xforb"] | (
            torch.einsum("jti,jtp->ip", aff.anti_own.to(f32), keyed_anti)
            > 0)
        # the JAX order of the three xpref terms: the hard-affinity
        # symmetric weight, then the pending pods' own preferred terms
        # that the accepted pods match, then the accepted pods' preferred
        # terms over the landing domain
        keyed_aff = aff_kp.to(f32) * accN[:, None, :]
        xpref = c["xpref"] + hard_w * torch.einsum(
            "jti,jtp->ip", aff.aff_own.to(f32), keyed_aff)
        m1 = torch.einsum("jit,jp->itp", aff.pref_match.to(f32), accN)
        xpref = xpref + torch.sum(
            m1 * aff.pref_weight[:, :, None] * pref_kp.to(f32), dim=1)
        keyed_pref = pref_kp.to(f32) * accN[:, None, :]
        out["xpref"] = xpref + torch.einsum(
            "jti,jt,jtp->ip", aff.pref_own.to(f32), aff.pref_weight,
            keyed_pref)
        return out

    def _init_carry(cluster, pods, pod_ports, last_index0, emask0, has_aff):
        B = pods.valid.shape[0]
        N = cluster.allocatable.shape[0]
        dev = cluster.valid.device
        lean_spread = pods.spread_counts.shape[-1] != N
        S = cluster.group_counts.shape[1] if lean_spread else B
        c = {
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
        if has_aff:
            TP = cluster.topo_pairs.shape[1]
            PT = pods.aff_term_pairs.shape[1]
            AT = pods.anti_term_pairs.shape[1]
            c["xaff"] = torch.zeros((B, PT, TP), dtype=torch.bool, device=dev)
            c["xanti"] = torch.zeros((B, AT, TP), dtype=torch.bool,
                                     device=dev)
            c["xforb"] = torch.zeros((B, TP), dtype=torch.bool, device=dev)
            c["xpref"] = torch.zeros((B, TP), dtype=f32, device=dev)
        return c

    def schedule(cluster, pods, ports, last_index0, nominated=None,
                 extra_mask=None, extra_score=None, aff_state=None):
        reject_later_slices(nominated=nominated)
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods, ports, emask, escore = transfer.upload_batch(
            pods, ports, device, extra_mask, extra_score)
        # densified on the device once a batch, not once a round
        aff = transfer.upload_affinity(aff_state, device)
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        emask0 = (torch.ones((B, N), dtype=torch.bool, device=dev)
                  if emask is None else emask)
        tril = torch.tril(torch.ones((B, B), dtype=torch.float32, device=dev),
                          diagonal=-1)
        ax = (None if aff is None
              else _affinity_context(cluster, pods, aff, tril))
        c = _init_carry(cluster, pods, ports.pod_ports, int(last_index0),
                        emask0, aff is not None)
        rounds = 0
        while bool(c["active"].any()):       # one host sync per round
            c = _round(cluster, pods, ports.pod_ports, ports.conflict,
                       escore, tril, aff, ax, c)
            rounds += 1
        schedule.last_rounds = rounds
        schedule.last_redo = False
        # the contention sentinels, checked on the host: a real bounce or
        # an order inversion, or a pod left unscheduled
        if bool(c["inv"]) or bool(torch.any(pods.valid & (c["hosts"] < 0))):
            # contention: the split could deviate from one-at-a-time
            # semantics, so redo the WHOLE batch through the exact
            # sequential engine (the speculative commits above never
            # touched the caller's cluster)
            schedule.last_redo = True
            return exact_scan(cluster, pods, ports, last_index0,
                              extra_mask=emask, extra_score=escore,
                              aff_state=aff)
        new_cluster = dataclasses.replace(cluster, requested=c["req"],
                                          nonzero_req=c["nz"])
        return c["hosts"], new_cluster

    schedule.engine_kind = "speculative"
    schedule.last_rounds = 0
    schedule.last_redo = False
    return schedule
