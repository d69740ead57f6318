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

After the rounds, the hybrid exactness check (the reference's :838-853):
any real capacity/port bounce, any order inversion with interference
(affinity batches), or any pod left unscheduled, discards the speculative
result and redoes the batch through the sequential engine, so the
scheduled/unschedulable split always matches one-at-a-time semantics.

A batch runs on the card as one CUDA graph (the reference's
lax.while_loop and lax.cond, `batch_graph`): a WHILE node over the round
(K11, K12, kernel K15 for the fold between the score pass and the
selector, K1, [K3], kernel K14 for the acceptance and the carry update,
and for a batch with in-batch pod affinity kernel K16 for its pair commit
and bootstrap gate), then an IF node over the exact redo (the static pass
and K13), with no host sync; fn.last_rounds and fn.last_redo are then
device scalars.  Their twins are round_fold_plain, round_commit_plain and
round_pairs_plain (an affinity batch's round is `_round`), which the CPU
path and select_impl="plain" run with the host checking `active.any()`
once a round.

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
topology domain with it under either pod's anti-affinity terms.  The carry
holds the unions (the pods' own pairs or'ed with the in-batch ones, the
preferred weights summed), so the filter and the fold read one row each.

Nominated pods (`nominated`): at commit, the resource claims of nominated
pods with priority >= the proposer's on its proposed node join the fit
check (podFitsOnNode's pass one, one exact [B, K] @ [K, R] product a round);
a proposer bounced by a claim is a real bounce, so the hybrid check redoes
the batch through the sequential engine, which applies the claims in every
step's fit.  Their port and anti-affinity claims come in through
extra_mask (models/batched.py encode_nominated_block).

Quality top-k (quality_topk=K > 0, output-only): each pod's winner-pinned
top-k rows, scores and feasible count are taken at the round that accepts
it (kernel K3 beside K1 each round on the card); a hybrid redo returns the
sequential engine's instead.  Reference semantics:
core/generic_scheduler.go Schedule (:184-254) / selectHost (:284-296).
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    DEFAULT_PRIORITY_WEIGHTS,
    FilterConfig,
    PodBatch,
    PRIO_INDEX,
    ScoreConfig,
)
from kubernetes_tpu_torch.models.batched import (
    check_exact_matmul,
    ipa_normalize,
    make_sequential_scheduler,
    static_profile,
    topology_key_pairs,
)
from kubernetes_tpu_torch.ops.predicates import (
    batch_pairs,
    filter_batch,
    pair_inputs,
    union_rows,
)
from kubernetes_tpu_torch.ops.priorities import (
    MAX_PRIORITY,
    ipa_gathers,
    pod_group_onehot,
    pod_spread_match,
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
    rotation_counters,
    select_hosts_batch,
    select_topk_batch,
)


def plain_carry(cluster: ClusterTensors, pods: PodBatch, pod_ports,
                last_index0: int, emask0, tk: int, on_device: bool) -> dict:
    """The carry of a batch's rounds (an affinity batch's adds the pair
    state, affinity_carry): hosts, the committed requests
    (req, nz), the spread counts (a spread-lean batch's [G, N] group
    columns, else each pod's [B, N] row; the snapshot's counts plus the
    batch's commits), claimed ports, emask, active, the inversion flag and
    with tk the top-k rows.  on_device: the kernels' carry, updated in
    place (fresh tensors, the rotation counter a device scalar "li_dev",
    the round count "rounds" and the "any pod active" flag "any"); else
    the twin's, with the counter "li" on the host."""
    B = pods.valid.shape[0]
    N = cluster.allocatable.shape[0]
    dev = cluster.valid.device
    if pods.spread_counts.shape[-1] != N:
        spread = cluster.group_counts.T.contiguous()           # [G, N]
    else:
        spread = spread_counts(cluster, pods)                  # [B, N]
    c = {
        "hosts": torch.full((B,), -1, dtype=torch.int32, device=dev),
        "req": cluster.requested.to(torch.float32),
        "nz": cluster.nonzero_req.to(torch.float32),
        "spread": spread,
        "claimed": torch.zeros((N, pod_ports.shape[1]), dtype=torch.bool,
                               device=dev),
        "emask": emask0,
        "active": pods.valid,
        "inv": torch.zeros((), dtype=torch.bool, device=dev),
    }
    if tk:
        c["topn"] = torch.full((B, tk), -1, dtype=torch.int32, device=dev)
        c["tops"] = torch.zeros((B, tk), dtype=torch.float32, device=dev)
        c["feas"] = torch.zeros(B, dtype=torch.int32, device=dev)
    if not on_device:
        c["li"] = int(last_index0)
        return c
    for k in ("req", "nz", "spread", "emask", "active"):
        c[k] = c[k].clone(memory_format=torch.contiguous_format)
    c["li_dev"] = torch.full((), kernels.wrap_i32(last_index0),
                             dtype=torch.int32, device=dev)
    c["rounds"] = torch.zeros((), dtype=torch.int32, device=dev)
    c["any"] = torch.zeros((), dtype=torch.bool, device=dev)
    return c


def round_fold_plain(total, mask, c, pods: PodBatch, cluster: ClusterTensors,
                     zone_key_id: int, zones, feas_limit, li: int, escore,
                     w_spread: float, w_ipa=None):
    """Kernel K15's plain twin: a round's fold between the score pass
    (total) and the selector, for the carry c.  A spread-lean batch adds
    w_spread times each pod's SelectorSpread score over the carried group
    counts (one score a group, broadcast with a one-hot product: exact,
    one nonzero term a row; a groupless pod scores 10); the mask takes
    active, emask and the pods' validity; with w_ipa (a batch with
    in-batch pod affinity, K15's affinity mode) w_ipa times the IPA score
    over the carried pair weights c["upref"] (their product with the
    topology, renormalized per pod) adds; then with a sampling limit the
    mask keeps the first feasible nodes from the rotated start li + b;
    escore adds last.  Returns (total, mask)."""
    B = mask.shape[0]
    if pods.spread_counts.shape[-1] != mask.shape[1]:
        scores_g = spread_score_from_counts(
            c["spread"], cluster, zone_key_id, zones)         # [G, N]
        onehot_g = pod_group_onehot(
            pods, cluster.group_counts.shape[1])              # [B, G]
        has_g = torch.any(onehot_g > 0, dim=-1)
        sp = torch.matmul(onehot_g, scores_g)
        # a groupless pod has zero counts everywhere -> score 10
        sp = torch.where(has_g[:, None], sp, MAX_PRIORITY)
        total = total + w_spread * sp
    mask = mask & c["active"][:, None] & c["emask"] & pods.valid[:, None]
    if w_ipa is not None:
        # the IPA score over (pre-batch | in-batch) raw pair weights,
        # renormalized per pod
        raw = torch.matmul(c["upref"],
                           cluster.topo_pairs.to(torch.float32).T)  # [B, N]
        total = total + w_ipa * ipa_normalize(raw, cluster.valid[None])
    if feas_limit is not None:
        mask = limit_feasible(mask, feas_limit,
                              rotation_counters(li, B, mask.device))
    if escore is not None:
        total = total + escore
    return total, mask


def round_commit_plain(c, hosts, feasible, top, pods: PodBatch, ports,
                       cluster: ClusterTensors, nom, spread_match, tril,
                       aff=None):
    """Kernel K14's plain twin: the acceptance and the carry update of a
    round, as a new carry.  hosts / feasible: the selector's picks; top:
    the round's TopKQuality or None; nom: the NominatedState or None;
    spread_match: f32[B, B] for per-pod spread counts, None for a
    spread-lean batch; tril: f32[B, B], ones strictly below the diagonal;
    aff: None, or for a batch with in-batch pod affinity (K14's affinity
    mode) {"aff": the dense BatchAffinityState, "mask": the round's mask,
    "rel": bool[B, B] pods related through required terms}: the same
    round's anti order, the inversion sentinel and the deferred
    retirement; the new carry then holds the round's "accept" too."""
    B = pods.valid.shape[0]
    N = cluster.allocatable.shape[0]
    dev = cluster.valid.device
    reqf = pods.req
    pports = ports.pod_ports
    pports_f = pports.to(torch.float32)
    conflict_f = ports.conflict.to(torch.float32)
    hosts_l = hosts.to(torch.int64)
    prop = c["active"] & feasible            # proposers this round
    # earlier same-node proposers (batch order = commit order)
    same = (hosts[:, None] == hosts[None, :]) & prop[:, None] & prop[None, :]
    prior = same.to(torch.float32) * tril                # [B, B]
    # request columns are multiples of 100m / 256Mi: the prefix sums are
    # exact in any summation order
    cum_req = torch.matmul(prior, reqf)                  # [B, R]
    node_req = c["req"][hosts_l]                         # [B, R]
    alloc_h = cluster.allocatable[hosts_l]
    if nom is not None:
        # podFitsOnNode pass one: nominated pods with priority >= this
        # pod's claim resources on their nominated node (resource fit is
        # monotone, so pass one implies the no-nominated pass two)
        nw = (
            (nom.prio[None, :] >= pods.priority[:, None])
            & (nom.node[None, :] >= 0)
            & (nom.node[None, :] == hosts[:, None])
        ).to(torch.float32)                              # [B, K]
        nom_extra = torch.matmul(nw, nom.req)            # [B, R]
        held = node_req + cum_req + nom_extra
    else:
        nom_extra = None
        held = node_req + cum_req
    over = (reqf > 0) & (held + reqf > alloc_h)
    fits = ~torch.any(over, dim=1)
    # ports: conflict with claims already on the node OR with an earlier
    # same-node proposer's wanted ports
    prior_ports = torch.matmul(prior, pports_f) > 0
    claimed_h = c["claimed"][hosts_l]                    # [B, PV]
    blocked = torch.matmul(
        (claimed_h | prior_ports).to(torch.float32), conflict_f) > 0
    pconf = torch.any(pports & blocked, dim=1)
    accept = prop & fits & ~pconf
    if aff is not None:
        # same-round required-anti ordering: pod b is rejected when an
        # earlier proposer j shares a topology domain with b under one of
        # b's anti terms (j matches it) or one of j's (b matches it).
        # D[o, t, c] = "candidate c's proposed node is in owner o's term-t
        # domain at o's proposed node".
        a = aff["aff"]
        H = cluster.topo_pairs.to(torch.float32)[hosts_l]    # [B, TP]
        anti_kp = topology_key_pairs(pods.anti_term_topo_key, cluster)
        a_own = anti_kp.to(torch.float32) * H[:, None, :]     # [B, AT, TP]
        D = torch.einsum("otp,cp->otc", a_own, H) > 0         # [B, AT, B]
        # am1[b, t, j] = "pod j matches pod b's required anti term t"
        am1 = a.anti_match.permute(1, 2, 0)                   # [B, AT, B]
        v1 = torch.any(D & am1, dim=1)                        # [b, j]
        v2 = torch.any(D & a.anti_own, dim=1)                 # [j, b]
        conf_ba = v1 | v2.T                                   # [b, j]
        earlier_prop = (tril > 0) & prop[None, :]
        accept = accept & ~torch.any(conf_ba & earlier_prop, dim=1)
        # order-inversion sentinel: a later pod committing while an
        # earlier one is passed over, where the commit can interfere with
        # what the earlier pod would have got one at a time (j's node was
        # feasible for i this round, or i and j are related through
        # required terms in either direction): the hybrid check then
        # redoes the batch
        passed_over = c["active"] & ~accept                   # [i]
        interf = aff["mask"][:, hosts_l] | aff["rel"]         # [i, j]
        inv_new = torch.any(passed_over[:, None] & accept[None, :]
                            & (tril.T > 0) & interf)
    accf = accept[:, None].to(torch.float32)
    # the accept pass is conservative (earlier proposers count even if they
    # bounce themselves); ban the node only when the bounce also holds
    # against the accepted-only prior state
    prior_acc = prior * accept[None, :].to(torch.float32)
    cum_acc = torch.matmul(prior_acc, reqf)
    held_acc = node_req + cum_acc
    if nom_extra is not None:
        held_acc = held_acc + nom_extra
    over_acc = (reqf > 0) & (held_acc + reqf > alloc_h)
    fits_acc = ~torch.any(over_acc, dim=1)
    prior_ports_acc = torch.matmul(prior_acc, pports_f) > 0
    blocked_acc = torch.matmul(
        (claimed_h | prior_ports_acc).to(torch.float32), conflict_f) > 0
    pconf_acc = torch.any(pports & blocked_acc, dim=1)
    real_bounce = prop & ~accept & (~fits_acc | pconf_acc)
    if aff is not None:
        # an anti-violation against an ACCEPTED peer needs no emask ban:
        # next round's pair state excludes the whole domain
        real_bounce = real_bounce & ~torch.any(
            conf_ba & (tril > 0) & accept[None, :], dim=1)
    node_ids = torch.arange(N, dtype=torch.int64, device=dev)
    acc_node = accf * (hosts_l[:, None] == node_ids[None, :]).to(
        torch.float32)                                   # [B, N]
    if spread_match is None:
        # group-granular commit counts ([G, N] carry)
        onehot_g = pod_group_onehot(pods, cluster.group_counts.shape[1])
        spread_next = c["spread"] + torch.matmul(onehot_g.T, acc_node)
    else:
        # the SAME AND-subset match the sequential engine uses
        spread_next = c["spread"] + torch.matmul(spread_match, acc_node)
    # committed state lands via scatter-add on the node axis (integer
    # multiples again: exact in any order)
    claimed_add = torch.zeros_like(c["claimed"], dtype=torch.float32)
    claimed_add.index_add_(0, hosts_l, (pports & accept[:, None]).to(
        torch.float32))
    out = {
        "hosts": torch.where(accept, hosts, c["hosts"]),
        "req": c["req"].index_add(0, hosts_l, reqf * accf),
        "nz": c["nz"].index_add(0, hosts_l, pods.nonzero_req * accf),
        "spread": spread_next,
        "claimed": c["claimed"] | (claimed_add > 0),
        # really-bounced proposers never re-pick the node that bounced them
        "emask": c["emask"] & ~(
            real_bounce[:, None] & (node_ids[None, :] == hosts_l[:, None])),
        # retired: accepted, or nothing feasible this round
        "active": c["active"] & feasible & ~accept,
        "li": c["li"] + B,
        # the contention signal of the hybrid redo: any REAL capacity/port
        # bounce (the inversion term is subsumed for plain batches, see the
        # reference's _round)
        "inv": c["inv"] | torch.any(real_bounce),
    }
    if top is not None:
        upd = accept[:, None]
        out["topn"] = torch.where(upd, top.top_nodes, c["topn"])
        out["tops"] = torch.where(upd, top.top_scores, c["tops"])
        out["feas"] = torch.where(accept, top.feasible, c["feas"])
    if aff is not None:
        out["inv"] = out["inv"] | inv_new
        # deferred retirement: while the round commits anything, an
        # infeasible pod stays active (a mate's landing may open its
        # domain next round).  A commit-free round retires only the FIRST
        # infeasible pod in batch order, the pod the sequential engine
        # would fail next.
        inf = c["active"] & ~feasible
        first_inf = inf & (torch.cumsum(inf.to(torch.int32), 0) == 1)
        out["active"] = out["active"] | torch.where(
            torch.any(accept), inf, inf & ~first_inf)
        out["accept"] = accept
    return out


def affinity_carry(c: dict, pods: PodBatch, tp: int) -> dict:
    """The carry c of a batch with in-batch pod affinity, in place: the
    unions the rounds add to from the pods' own pairs ("uaff", "uanti",
    "uforb"; OR is idempotent) and preferred weights ("upref"; integer
    sums), tp pairs wide (a lean batch's width-1 placeholders broadcast),
    and the gated aff_term_self ("self", set by the first round_pairs
    call)."""
    c.update(union_rows(pods, tp))
    c["self"] = pods.aff_term_self.clone()
    return c


def related_pods(aff) -> torch.Tensor:
    """bool[B, B]: pods i and j related through required terms in either
    direction (one satisfies or matches the other's affinity or anti
    term), the inversion sentinel's interference."""
    a_any = torch.any(aff.aff_match, dim=2)    # [x, y]: x sats y's aff
    n_any = torch.any(aff.anti_match, dim=2)   # [x, y]: x matches y's anti
    return a_any | a_any.T | n_any | n_any.T


def round_pairs_plain(c, hosts, accept, pods: PodBatch, aff,
                      cluster: ClusterTensors, hard_w: float) -> dict:
    """Kernel K16's plain twin: the predicateMetadata.AddPod analogue,
    batched over a round's accepted placements (hosts and accept; None:
    none, the first round), whose topology pairs flow into the pending
    pods' union state for the next round, then the next round's bootstrap
    gate over c["active"]: pod i may self-bootstrap term t only when no
    EARLIER-in-batch pod that could satisfy t is still pending (the gate
    folds into aff_term_self, so the shared MatchInterPodAffinity
    predicate evaluates the unioned state unchanged).  Returns the new
    "uaff", "uanti", "uforb", "upref" and "self"."""
    f32 = torch.float32
    out = {k: c[k] for k in ("uaff", "uanti", "uforb", "upref")}
    if accept is not None:
        aff_kp = topology_key_pairs(pods.aff_term_topo_key, cluster)
        anti_kp = topology_key_pairs(pods.anti_term_topo_key, cluster)
        pref_kp = topology_key_pairs(aff.pref_topo_key, cluster)
        H = cluster.topo_pairs.to(f32)[hosts.to(torch.int64)]   # [B, TP]
        accN = accept[:, None].to(f32) * H                      # [B(j), TP]
        out["uaff"] = c["uaff"] | (
            (torch.einsum("jit,jp->itp", aff.aff_match.to(f32), accN) > 0)
            & aff_kp)
        out["uanti"] = c["uanti"] | (
            (torch.einsum("jit,jp->itp", aff.anti_match.to(f32), accN) > 0)
            & anti_kp)
        keyed_anti = anti_kp.to(f32) * accN[:, None, :]
        out["uforb"] = c["uforb"] | (
            torch.einsum("jti,jtp->ip", aff.anti_own.to(f32), keyed_anti)
            > 0)
        # the JAX order of the three weight terms: the hard-affinity
        # symmetric weight, then the pending pods' own preferred terms
        # that the accepted pods match, then the accepted pods' preferred
        # terms over the landing domain
        keyed_aff = aff_kp.to(f32) * accN[:, None, :]
        upref = c["upref"] + hard_w * torch.einsum(
            "jti,jtp->ip", aff.aff_own.to(f32), keyed_aff)
        m1 = torch.einsum("jit,jp->itp", aff.pref_match.to(f32), accN)
        upref = upref + torch.sum(
            m1 * aff.pref_weight[:, :, None] * pref_kp.to(f32), dim=1)
        keyed_pref = pref_kp.to(f32) * accN[:, None, :]
        out["upref"] = upref + torch.einsum(
            "jti,jt,jtp->ip", aff.pref_own.to(f32), aff.pref_weight,
            keyed_pref)
    B = pods.valid.shape[0]
    tril = torch.tril(torch.ones((B, B), dtype=f32,
                                 device=pods.valid.device), diagonal=-1)
    earlier_alive = tril * c["active"].to(f32)[None, :]
    cb = torch.einsum("jit,ij->it", aff.aff_match.to(f32),
                      earlier_alive) <= 0                     # [B, PT]
    out["self"] = pods.aff_term_self & cb
    return out


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
    whether the batch was redone through the sequential engine: 0-d
    tensors on the card through the kernels (read them after the clock
    stops: reading syncs), a Python int and bool otherwise.

    quality_topk=K > 0 (output-only): the call returns (hosts, new_cluster,
    ops/select.TopKQuality).  Each pod's top-k is captured at the round
    that accepts it, off that round's (mask, total, hosts); bounced pods
    keep -1 until their round, pods retired as infeasible keep -1 for
    good; a hybrid redo returns the sequential engine's TopKQuality."""
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
    if score_cfg is None:
        score_cfg = ScoreConfig()
    w_rtc = float(w_all[PRIO_INDEX["RequestedToCapacityRatioPriority"]])
    # the sequential engine's state-dependent weights (K13 in the graph)
    weights5 = tuple(float(w_all[PRIO_INDEX[k]]) for k in (
        "LeastRequestedPriority", "MostRequestedPriority",
        "BalancedResourceAllocation", "SelectorSpreadPriority",
        "RequestedToCapacityRatioPriority"))
    exact_scan = make_sequential_scheduler(
        cfg=cfg, weights=weights, unsched_taint_key=unsched_taint_key,
        zone_key_id=zone_key_id, score_cfg=score_cfg,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score,
        quality_topk=quality_topk, device=device, select_impl=select_impl,
    )

    def _round(cluster, pods, ports, escore, nom, tril, aff, st, c):
        """One propose-and-commit round of an affinity batch through the
        twins (the CPU, select_impl="plain"): the filter pass against the
        carried unions and the gated aff_term_self, the score pass without
        the IPA score, round_fold_plain with it, the selector,
        round_commit_plain and round_pairs_plain in their affinity mode; c
        is the carry dict (tensors plus the host-side rotation counter
        "li"), nom the NominatedState on the device or None, aff the dense
        BatchAffinityState."""
        pods_eval = dataclasses.replace(
            pods, aff_term_pairs=c["uaff"], anti_term_pairs=c["uanti"],
            forbidden_pairs=c["uforb"], aff_term_self=c["self"])
        total, mask = plain_passes(cluster, pods_eval, st, c)
        total, mask = round_fold_plain(
            total, mask, c, pods, cluster, zone_key_id, st["zones"],
            st["feas_limit"], c["li"], escore, st["w_spread"], w_ipa)
        hosts, feasible = select_hosts_batch(total, mask, c["li"],
                                             select_impl)
        top = (select_topk_batch(total, mask, hosts, feasible,
                                 c["topn"].shape[1])
               if quality_topk else None)
        out = round_commit_plain(
            c, hosts, feasible, top, pods, ports, cluster, nom,
            st["spread_match"], tril,
            {"aff": aff, "mask": mask, "rel": st["rel"]})
        out.update(round_pairs_plain({**c, "active": out["active"]}, hosts,
                                     out["accept"], pods, aff, cluster,
                                     hard_w))
        return out

    def plain_setup(cluster, pods, affinity: bool = False):
        """What a batch's rounds share, made once a batch: the score
        pass's weights (a spread-lean batch scores SelectorSpread in the
        fold, so its weight moves there; an affinity batch scores
        InterPodAffinity there, against the in-batch state), the zone
        layout, the sampling limit, and for per-pod spread counts the
        AND-subset match."""
        N = cluster.n_nodes
        lean = pods.spread_counts.shape[-1] != N
        w_use = np.array(w_no_ipa if affinity else w_all, np.float32)
        w_spread = 0.0
        if lean:
            w_spread = float(w_use[PRIO_INDEX["SelectorSpreadPriority"]])
            w_use[PRIO_INDEX["SelectorSpreadPriority"]] = 0.0
        zones = zone_layout(cluster, zone_key_id)
        return {
            "w_use": w_use,
            "w_spread": w_spread,
            "zones": zones,
            "feas_limit": (
                num_feasible_nodes_device(
                    torch.sum(cluster.valid, dtype=torch.int32),
                    percentage_of_nodes_to_score)
                if percentage_of_nodes_to_score < 100 else None),  # 0 = adaptive
            "spread_match": (None if lean else pod_spread_match(
                pods, cluster.group_counts.shape[1])),
        }

    def plain_passes(cluster, pods, st, c):
        """A round's filter and score passes against the carry (K11 and
        K12 on CUDA tensors): (total, mask)."""
        cl = dataclasses.replace(cluster, requested=c["req"],
                                 nonzero_req=c["nz"])
        mask, _ = filter_batch(cl, pods, cfg, unsched_taint_key,
                               need_per=False)
        if st["spread_match"] is not None:
            pods = dataclasses.replace(pods, spread_counts=c["spread"])
        total, _ = score_batch(
            cl, pods, weights=st["w_use"], score_cfg=score_cfg,
            zone_key_id=zone_key_id, skip_zero_weight=True, need_per=False)
        return total, mask

    def plain_round_plain(cluster, pods, ports, escore, nom, tril, st, c):
        """One round of a plain batch through the twins."""
        total, mask = plain_passes(cluster, pods, st, c)
        total, mask = round_fold_plain(
            total, mask, c, pods, cluster, zone_key_id, st["zones"],
            st["feas_limit"], c["li"], escore, st["w_spread"])
        hosts, feasible = select_hosts_batch(total, mask, c["li"],
                                             select_impl)
        top = (select_topk_batch(total, mask, hosts, feasible,
                                 c["topn"].shape[1])
               if quality_topk else None)
        return round_commit_plain(c, hosts, feasible, top, pods, ports,
                                  cluster, nom, st["spread_match"], tril)

    def batch_graph(cluster, pods, ports, last_index0, nom, emask, escore,
                    st, c, tk, aff):
        """A batch on the card as one CUDA graph launch
        (kernels/round_graph.cu): WHILE any pod is active, a round (K11,
        K12, K15, K1, [K3], K14, and with in-batch pod affinity K16 after
        K14, one more K16 launch before the loop for the first round's
        bootstrap gate); then IF the round's sentinels call for it, the
        exact redo (the static pass, K11 and K12, and K13, in its affinity
        mode for an affinity batch) over the carry's outputs.  Every
        buffer is allocated before the capture and nothing reads the card:
        the returned redo flag (i32[], 0 or 1) and c["rounds"] stay there.
        The graph is built a call; its build seconds add to GRAPH_STATS,
        and the launches its capture records are counted when they settle
        (kernels.graph_launched)."""
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        t0 = time.perf_counter()
        # the round's launches, prepared (every output allocated here)
        cl = dataclasses.replace(cluster, requested=c["req"],
                                 nonzero_req=c["nz"])
        pods_f = pods if aff is None else dataclasses.replace(
            pods, aff_term_pairs=c["uaff"], anti_term_pairs=c["uanti"],
            forbidden_pairs=c["uforb"], aff_term_self=c["self"])
        pods_r = (pods_f if st["spread_match"] is None
                  else dataclasses.replace(pods_f, spread_counts=c["spread"]))
        # the batch's node pairs and key slots, once a batch
        bp = (None if aff is None
              else batch_pairs(cluster, pods, aff.pref_topo_key))
        a11, k11, mask0 = kernels.filter_pass_prepare(
            cl, pods_f, cfg, unsched_taint_key,
            *(pair_inputs(cluster, pods_f) if aff is None
              else (bp.node_pair, bp.aff_slot)), False)
        a12, k12, (total0, _) = kernels.score_pass_prepare(
            cl, pods_r, st["w_use"], False, False, score_cfg, zone_key_id,
            ipa_gathers(cluster, pods, st["w_use"]))
        a15, k15, (total, mask) = kernels.round_fold_prepare(
            total0, mask0, c, pods, st["zone_of_node"],
            cluster.topo_pairs.shape[1], escore, st["feas_limit"],
            st["w_spread"],
            None if aff is None else (bp.node_pair, cluster.valid, w_ipa))
        k1, (hosts, feasible) = kernels.select_hosts_prepare(
            total, mask, c["li_dev"])
        k3, top = (kernels.select_topk_prepare(total, mask, hosts, feasible,
                                               tk)
                   if tk else (None, None))
        a14, k14 = kernels.round_commit_prepare(
            c, hosts, feasible, TopKQuality(*top) if tk else None, pods,
            ports, cluster, st["nom_lists"], st["spread_match"],
            st["scratch"], aff=None if aff is None else {
                "mask": mask, "rel": related_pods(aff),
                "node_pair": bp.node_pair, "anti_slot": bp.anti_slot,
                "anti_match": aff.anti_match, "anti_own": aff.anti_own})
        if aff is not None:
            a16, k16 = kernels.round_pairs_prepare(
                c, hosts, st["scratch"]["accept"], pods, aff, bp, hard_w)
            a16g, k16g = kernels.round_pairs_prepare(
                c, None, None, pods, aff, bp, hard_w)
        # the redo's launches, writing over the carry's outputs
        static_cfg, w_static = static_profile(cfg, w_all, aff is not None)
        a11s, k11s, smask = kernels.filter_pass_prepare(
            cluster, pods, static_cfg, unsched_taint_key,
            *pair_inputs(cluster, pods), False)
        a12s, k12s, (sscore, _) = kernels.score_pass_prepare(
            cluster, pods, w_static, False, False, score_cfg, zone_key_id,
            ipa_gathers(cluster, pods, w_static))
        a13, k13, _ = kernels.seq_scan_prepare(
            cluster, pods, ports, smask, sscore, emask, escore,
            pod_spread_match(pods, cluster.group_counts.shape[1]), nom,
            st["feas_limit"], st["rtc"], st["weights5"], zone_key_id,
            last_index0, tk,
            out=(c["hosts"], c["req"], c["nz"],
                 (c["topn"], c["tops"], c["feas"]) if tk else None),
            aff=aff, pairs=bp,
            unions=(None if aff is None
                    else union_rows(pods, cluster.topo_pairs.shape[1])),
            ipa=(w_ipa, hard_w))
        redo = torch.zeros((), dtype=torch.int32, device=dev)
        keep = (k11, k12, k15, k14, k11s, k12s, k13, hosts, top, redo,
                (k16, k16g) if aff is not None else None)
        # the capture: it records the launches of each body, and
        # settle_launches counts them from the card's rounds and redo flag
        cap, body = kernels.graph_streams(dev)
        lib = kernels.library()
        t1 = time.perf_counter()
        with kernels.GRAPH_LOCK, kernels.capturing() as rec:
            err = lib.graph_begin(cap.cuda_stream)
            try:
                kernels.check_graph(lib, err)
                if aff is not None:
                    with torch.cuda.stream(cap):
                        kernels.round_pairs_launch(a16g)   # the first gate
                h_while = kernels.graph_handle(lib, cap)
                kernels.check_graph(lib, lib.graph_init_launch(
                    h_while, c["active"].data_ptr(), B, cap.cuda_stream))
                kernels.check_graph(lib, lib.graph_cond_begin(
                    cap.cuda_stream, body.cuda_stream, h_while, 1))
                a14.cond = h_while
                rec.into("while")
                with torch.cuda.stream(body):
                    kernels.filter_pass_launch(a11)
                    kernels.score_pass_launch(a12)
                    kernels.round_fold_launch(a15)
                    k1()
                    if k3 is not None:
                        k3()
                    kernels.round_commit_launch(a14)
                    if aff is not None:
                        kernels.round_pairs_launch(a16)
                kernels.check_graph(lib, lib.graph_cond_end(
                    body.cuda_stream))
                rec.into("once")
                h_if = kernels.graph_handle(lib, cap)
                kernels.check_graph(lib, lib.graph_flag_launch(
                    h_if, c["inv"].data_ptr(), pods.valid.data_ptr(),
                    c["hosts"].data_ptr(), B, redo.data_ptr(),
                    cap.cuda_stream))
                kernels.check_graph(lib, lib.graph_cond_begin(
                    cap.cuda_stream, body.cuda_stream, h_if, 0))
                rec.into("if")
                with torch.cuda.stream(body):
                    kernels.filter_pass_launch(a11s)
                    kernels.score_pass_launch(a12s)
                    kernels.seq_scan_launch(a13)
                kernels.check_graph(lib, lib.graph_cond_end(
                    body.cuda_stream))
                rec.into("once")
                t2 = time.perf_counter()
                exec_ = ctypes.c_void_p()
                kernels.check_graph(lib, lib.graph_end(
                    cap.cuda_stream, ctypes.byref(exec_)))
            except BaseException:
                lib.graph_abort(cap.cuda_stream, body.cuda_stream)
                raise
        t3 = time.perf_counter()
        stats = kernels.GRAPH_STATS
        stats["builds"] += 1
        stats["seconds"] += t3 - t0
        stats["prepare"] += t1 - t0
        stats["capture"] += t2 - t1
        stats["instantiate"] += t3 - t2
        main = torch.cuda.current_stream(dev)
        kernels.check_graph(lib, lib.graph_launch(exec_, main.cuda_stream))
        # an instance destroyed in flight is freed when it completes
        kernels.check_graph(lib, lib.graph_destroy(exec_))
        kernels.LAUNCHES["round_graph"] += 1
        kernels.graph_launched(c["rounds"], redo, rec.launched)
        # the buffers the graph reads and writes outlive its run: the
        # caching allocator reuses them only for work queued after it
        del keep
        return redo

    def schedule_rounds(cluster, pods, ports, last_index0, nom, emask,
                        escore, aff):
        """The rounds of a batch (aff: its dense BatchAffinityState or
        None): (hosts, carry, redo).  On the card through the kernels, one
        CUDA graph that runs the redo itself when it is due (redo and the
        rounds then device scalars); else the twins' rounds with one host
        sync a round."""
        B, N = pods.n_pods, cluster.n_nodes
        dev = cluster.valid.device
        emask0 = (torch.ones((B, N), dtype=torch.bool, device=dev)
                  if emask is None else emask)
        tk = min(quality_topk, N) if quality_topk else 0
        st = plain_setup(cluster, pods, aff is not None)
        rounds = 0
        if dev.type == "cuda" and select_impl == "kernel":
            c = plain_carry(cluster, pods, ports.pod_ports, last_index0,
                            emask0, tk, on_device=True)
            if aff is not None:
                affinity_carry(c, pods, cluster.topo_pairs.shape[1])
            node_in_zone, zone_of, _ = st["zones"]
            st["zone_of_node"] = torch.where(
                node_in_zone, zone_of, -1).to(torch.int32)
            st["nom_lists"] = (
                None if nom is None
                else (nom, *kernels.nominated_lists(nom.node, N)))
            st["scratch"] = kernels.round_commit_scratch(
                B, pods.req.shape[1], ports.pod_ports.shape[1], dev)
            st["rtc"] = rtc_tables(score_cfg, dev) if w_rtc else None
            st["weights5"] = weights5
            # the rounds and the redo in one graph: no host sync
            redo = batch_graph(cluster, pods, ports, last_index0, nom,
                               emask, escore, st, c, tk, aff)
            return c, c["rounds"], redo
        c = plain_carry(cluster, pods, ports.pod_ports, last_index0, emask0,
                        tk, on_device=False)
        tril = torch.tril(torch.ones((B, B), dtype=torch.float32,
                                     device=dev), diagonal=-1)
        if aff is not None:
            affinity_carry(c, pods, cluster.topo_pairs.shape[1])
            st["rel"] = related_pods(aff)
            c.update(round_pairs_plain(c, None, None, pods, aff, cluster,
                                       hard_w))
        while bool(c["active"].any()):       # one host sync per round
            c = (plain_round_plain(cluster, pods, ports, escore, nom, tril,
                                   st, c) if aff is None else
                 _round(cluster, pods, ports, escore, nom, tril, aff, st, c))
            rounds += 1
        # the contention sentinels, checked on the host: a real bounce or
        # an order inversion, or a pod left unscheduled
        redo = (bool(c["inv"])
                or bool(torch.any(pods.valid & (c["hosts"] < 0))))
        return c, rounds, redo

    def schedule(cluster, pods, ports, last_index0, nominated=None,
                 extra_mask=None, extra_score=None, aff_state=None):
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods, ports, emask, escore = transfer.upload_batch(
            pods, ports, device, extra_mask, extra_score)
        nom = transfer.upload_nominated(nominated, device)
        # densified on the device once a batch, not once a round
        aff = transfer.upload_affinity(aff_state, device)
        c, rounds, redo = schedule_rounds(cluster, pods, ports, last_index0,
                                          nom, emask, escore, aff)
        schedule.last_rounds = rounds
        schedule.last_redo = redo
        if isinstance(redo, torch.Tensor):
            # the graph ran the redo itself when it was due: the carry
            # holds the outputs either way
            return outputs(cluster, c)
        if redo:
            # contention: the split could deviate from one-at-a-time
            # semantics, so redo the WHOLE batch through the exact
            # sequential engine (the speculative commits above never
            # touched the caller's cluster)
            return exact_scan(cluster, pods, ports, last_index0,
                              nominated=nom, extra_mask=emask,
                              extra_score=escore, aff_state=aff)
        return outputs(cluster, c)

    def outputs(cluster, c):
        new_cluster = dataclasses.replace(cluster, requested=c["req"],
                                          nonzero_req=c["nz"])
        if quality_topk:
            return (c["hosts"], new_cluster,
                    TopKQuality(c["topn"], c["tops"], c["feas"]))
        return c["hosts"], new_cluster

    schedule.engine_kind = "speculative"
    # quality variants return (hosts, new_cluster, TopKQuality); 0 = off
    schedule.quality_topk = quality_topk
    schedule.last_rounds = 0
    schedule.last_redo = False
    return schedule
