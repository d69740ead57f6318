"""Filter predicates as batched tensor functions (PyTorch port).

The counterpart of the JAX package's ops/predicates.py: each predicate
mirrors one reference FitPredicate
(pkg/scheduler/algorithm/predicates/predicates.go) over the whole
pods x nodes grid, `(ClusterTensors, PodBatch) -> bool[B, N]`, and
`filter_batch` stacks them in the reference's mandatory order
(predicates.go:142-151) so the first failing predicate per (pod, node) can
be attributed.

On CUDA tensors the stack and the mask are kernel K11
(kernels/filter_pass.cu, `filter_batch` and `predicate_stack` dispatch to
it; it launches or raises) and the fold of a stack kernel K7; the
topology-pair incidence products stay exact f32 matrix products
(`pair_hits`), as the reference leaves them to XLA.  On CPU tensors they
are the plain twins below (`filter_batch_plain`, `predicate_stack_plain`),
integer/bool/f32 tensor math.  Where the JAX version broadcasts a small
pod-side axis (ports, tolerations) into a 4-D grid, the twins loop over
that axis and OR the [B, N, *] slices, so eager PyTorch never
materializes the [B, Q, N, P] grid at full width; the verdicts are the
same.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    FilterConfig,
    FIELD_NODE_NAME_ID,
    NUM_PREDICATES,
    PAD,
    PodBatch,
    NUM_VOL_TYPES,
    PRED_INDEX,
    VOL_CSI,
)

# taint effect codes
_NO_SCHEDULE, _PREFER_NO_SCHEDULE, _NO_EXECUTE = 0, 1, 2
# toleration ops
_TOL_EQUAL, _TOL_EXISTS = 0, 1
# selector ops
_IN, _NOT_IN, _EXISTS, _DOES_NOT_EXIST, _GT, _LT = 0, 1, 2, 3, 4, 5

_NEG_INF = float("-inf")


def _ones(B: int, N: int, device) -> torch.Tensor:
    return torch.ones((B, N), dtype=torch.bool, device=device)


def exact_bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) > 0 for 0/1 incidence tensors given as bool or f32.  The
    product counts hits, so it must be exact: f32 on both devices (the
    engines refuse to run with TF32 matmuls enabled)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)) > 0


def node_label_value(cluster: ClusterTensors, keys: torch.Tensor):
    """Look up node label values for interned keys.

    keys: i32[...]; returns (val i32[..., N], num f32[..., N]) with PAD/nan
    for absent keys.  The pseudo-key FIELD_NODE_NAME_ID resolves to the node
    name (NodeSelectorTerm.matchFields support).  The max over label slots
    runs as a loop over L, which never builds the [..., N, L] grid.
    """
    lk = cluster.label_keys            # [N, L]
    lv = cluster.label_vals
    ln = cluster.label_nums
    k = keys[..., None]                # [..., 1]
    shape = keys.shape + (lk.shape[0],)
    val = torch.full(shape, PAD, dtype=torch.int32, device=lk.device)
    num = torch.full(shape, _NEG_INF, dtype=torch.float32, device=lk.device)
    for slot in range(lk.shape[1]):
        hit = lk[:, slot] == k                               # [..., N]
        val = torch.maximum(val, torch.where(hit, lv[:, slot], PAD))
        n_slot = ln[:, slot]
        num = torch.maximum(
            num, torch.where(hit & ~torch.isnan(n_slot), n_slot, _NEG_INF))
    num = torch.where(torch.isfinite(num), num, float("nan"))
    is_field = k == FIELD_NODE_NAME_ID
    val = torch.where(is_field, cluster.node_name_id, val)
    return val, num


def _eval_exprs(cluster, key, op, vals, nval, num, valid):
    """Evaluate selector expressions against all nodes.

    key/op/num: i32/f32[..., E]; vals i32[..., E, V]; returns match
    bool[..., E, N] (invalid expressions evaluate True so they AND away).
    ref v1helper.MatchNodeSelectorTerms / labels.Requirement.Matches.
    """
    node_val, node_num = node_label_value(cluster, key)   # [..., E, N]
    has = node_val != PAD
    V = vals.shape[-1]
    in_set = torch.zeros_like(has)
    for v in range(V):
        vvalid = (v < nval)[..., None]                     # [..., E, 1]
        in_set = in_set | ((node_val == vals[..., v, None]) & vvalid)
    numx = num[..., None]
    num_ok = ~torch.isnan(numx) & ~torch.isnan(node_num)
    gt = num_ok & (node_num > numx)
    lt = num_ok & (node_num < numx)
    opx = op[..., None]
    match = torch.where(
        opx == _IN, has & in_set,
        torch.where(
            opx == _NOT_IN, ~(has & in_set),
            torch.where(
                opx == _EXISTS, has,
                torch.where(
                    opx == _DOES_NOT_EXIST, ~has,
                    torch.where(opx == _GT, has & gt, has & lt),
                ),
            ),
        ),
    )
    return match | ~valid[..., None]


# --------------------------------------------------------------- predicates


def pod_fits_resources(cluster: ClusterTensors, pods: PodBatch):
    """PodFitsResources (predicates.go:764-857): for every resource the pod
    requests, requested + podRequest <= allocatable; the pod-count column
    encodes allowedPodNumber."""
    req = pods.req[:, None, :]                  # [B, 1, R]
    used = cluster.requested[None]              # [1, N, R]
    alloc = cluster.allocatable[None]
    over = (req > 0) & (used + req > alloc)
    return ~torch.any(over, dim=-1)


def pod_fits_host(cluster: ClusterTensors, pods: PodBatch):
    """PodFitsHost (predicates.go:901-921): spec.nodeName pinning."""
    want = pods.node_name_req[:, None]
    return (want == PAD) | (want == cluster.node_name_id[None])


def pod_fits_host_ports(cluster: ClusterTensors, pods: PodBatch):
    """PodFitsHostPorts (predicates.go:1069-1110) with the hostIP/wildcard
    conflict rule of nodeinfo/host_ports.go CheckConflict."""
    npp = cluster.port_pp[None]                 # [1, N, P]
    nip = cluster.port_ip[None]
    nused = cluster.port_used[None]
    conflict = torch.zeros(
        (pods.n_pods, cluster.n_nodes), dtype=torch.bool,
        device=npp.device)
    for q in range(pods.port_pp.shape[1]):
        pp = pods.port_pp[:, q, None, None]     # [B, 1, 1]
        ip = pods.port_ip[:, q, None, None]
        pv = pods.port_valid[:, q, None, None]
        ip_clash = (ip == nip) | (ip == 0) | (nip == 0)
        hit = pv & nused & (pp == npp) & ip_clash
        conflict = conflict | torch.any(hit, dim=-1)
    return ~conflict


def pod_match_node_selector(cluster: ClusterTensors, pods: PodBatch):
    """PodMatchNodeSelector (predicates.go:889-899): spec.nodeSelector AND
    nodeAffinity.requiredDuringScheduling (OR of terms)."""
    # plain nodeSelector map: every entry key==value
    val, _ = node_label_value(cluster, pods.ns_keys)       # [B, NS, N]
    ok = (val == pods.ns_vals[..., None]) | ~pods.ns_valid[..., None]
    sel_ok = torch.all(ok, dim=1)                           # [B, N]
    if pods.expr_key.shape[1] == 0:
        # affinity-lean batch (no pod carries required nodeAffinity): the
        # encoder emitted zero-width term tensors, skip the expr grid
        return sel_ok
    m = _eval_exprs(
        cluster,
        pods.expr_key,
        pods.expr_op,
        pods.expr_vals,
        pods.expr_nval,
        pods.expr_num,
        pods.expr_valid,
    )                                                       # [B, S, E, N]
    # a term with ZERO requirements matches nothing (v1helper semantics)
    term_nonempty = torch.any(pods.expr_valid, dim=2)       # [B, S]
    term_ok = (
        torch.all(m, dim=2)
        & pods.term_valid[..., None]
        & term_nonempty[..., None]
    )
    any_term = torch.any(term_ok, dim=1)                    # [B, N]
    aff_ok = torch.where(pods.has_req_affinity[:, None], any_term, True)
    return sel_ok & aff_ok


def tolerated_taints(pods: PodBatch, taint_key, taint_val, taint_effect):
    """bool[B, N, T]: taint t of node n is tolerated by some toleration of
    pod b.  ref v1/toleration.go ToleratesTaint."""
    ntk = taint_key[None]                       # [1, N, T]
    ntv = taint_val[None]
    nte = taint_effect[None]
    B = pods.n_pods
    out = torch.zeros((B,) + tuple(taint_key.shape), dtype=torch.bool,
                      device=taint_key.device)
    for j in range(pods.tol_key.shape[1]):
        tk = pods.tol_key[:, j, None, None]     # [B, 1, 1]
        to = pods.tol_op[:, j, None, None]
        tv = pods.tol_val[:, j, None, None]
        te = pods.tol_effect[:, j, None, None]
        tvalid = pods.tol_valid[:, j, None, None]
        eff_ok = (te == PAD) | (te == nte)
        key_ok = (tk == 0) | (tk == ntk)
        op_ok = (to == _TOL_EXISTS) | (tv == ntv)
        out = out | (tvalid & eff_ok & key_ok & op_ok)
    return out


def _tolerates(pods: PodBatch, taint_key, taint_val, taint_effect, considered):
    """bool[B, N]: every considered taint is tolerated by some toleration.
    ref TolerationsTolerateTaintsWithFilter."""
    tolerated = tolerated_taints(pods, taint_key, taint_val, taint_effect)
    return ~torch.any(considered[None] & ~tolerated, dim=-1)


def pod_tolerates_node_taints(cluster: ClusterTensors, pods: PodBatch):
    """PodToleratesNodeTaints (predicates.go:1531-1540): NoSchedule+NoExecute."""
    eff = cluster.taint_effect
    considered = (eff == _NO_SCHEDULE) | (eff == _NO_EXECUTE)
    return _tolerates(pods, cluster.taint_key, cluster.taint_val, eff, considered)


def pod_tolerates_no_execute_taints(cluster: ClusterTensors, pods: PodBatch):
    """PodToleratesNodeNoExecuteTaints (predicates.go:1543-1547)."""
    eff = cluster.taint_effect
    return _tolerates(pods, cluster.taint_key, cluster.taint_val, eff,
                      eff == _NO_EXECUTE)


def check_node_unschedulable(cluster: ClusterTensors, pods: PodBatch,
                             unsched_taint_key):
    """CheckNodeUnschedulablePredicate (predicates.go:1511-1529): fails on
    .spec.unschedulable unless the pod tolerates the unschedulable taint."""
    tk = pods.tol_key
    te = pods.tol_effect
    to = pods.tol_op
    tv = pods.tol_val
    tol = (
        pods.tol_valid
        & ((te == PAD) | (te == _NO_SCHEDULE))
        & ((tk == 0) | (tk == unsched_taint_key))
        & ((to == _TOL_EXISTS) | (tv == 0))
    )
    tolerates = torch.any(tol, dim=1)           # [B]
    return ~(cluster.unschedulable[None] & ~tolerates[:, None])


def _node_only(flag_ok: torch.Tensor, pods: PodBatch):
    """A per-node verdict broadcast to [B, N]."""
    return flag_ok[None].expand(pods.n_pods, -1)


def check_node_condition(cluster: ClusterTensors, pods: PodBatch):
    """CheckNodeConditionPredicate (predicates.go:1610-1649)."""
    return _node_only(~cluster.not_ready, pods)


def check_node_memory_pressure(cluster: ClusterTensors, pods: PodBatch):
    """CheckNodeMemoryPressurePredicate (predicates.go:1568-1588): only
    BestEffort pods are repelled."""
    return ~(pods.best_effort[:, None] & cluster.mem_pressure[None])


def check_node_disk_pressure(cluster: ClusterTensors, pods: PodBatch):
    return _node_only(~cluster.disk_pressure, pods)


def check_node_pid_pressure(cluster: ClusterTensors, pods: PodBatch):
    return _node_only(~cluster.pid_pressure, pods)


def no_disk_conflict(cluster: ClusterTensors, pods: PodBatch):
    """NoDiskConflict (predicates.go:288-328): exclusive GCE-PD/EBS/RBD/ISCSI
    volume ids must not collide with volumes in use on the node."""
    nv = cluster.disk_vol_ids[None]             # [1, N, DVN]
    clash = torch.zeros((pods.n_pods, cluster.n_nodes), dtype=torch.bool,
                        device=nv.device)
    for d in range(pods.disk_vol_ids.shape[1]):
        pv = pods.disk_vol_ids[:, d, None, None]  # [B, 1, 1]
        clash = clash | torch.any((pv != PAD) & (pv == nv), dim=-1)
    return ~clash


def max_volume_counts(cluster: ClusterTensors, pods: PodBatch, max_vols):
    """MaxEBS/GCE/CSI/Azure/Cinder volume-count filters (predicates.go:330-614)
    -> bool[B, VT, N], one slice per filter column.  A pod volume already
    mounted on the node attaches nothing new; per-node attachable limits
    override the static defaults."""
    new = pods.new_vol_counts[:, :, None]       # [B, VT, 1]
    if pods.vol_overlap.shape[-1] == cluster.n_nodes:
        new = torch.clamp_min(new - pods.vol_overlap, 0.0)
    used = cluster.vol_counts.T[None]           # [1, VT, N]
    VT = new.shape[1]
    base = list(max_vols)
    if VT > len(base):
        # columns past the base types are per-CSI-driver: each inherits
        # the CSI default limit
        base = base + [float(max_vols[VOL_CSI])] * (VT - len(base))
    default = torch.tensor(base, dtype=torch.float32,
                           device=new.device)[None, :, None]
    node_lim = cluster.vol_limits.T[None]       # [1, VT, N] (inf = unset)
    limit = torch.minimum(default, node_lim)
    return ~((new > 0) & (used + new > limit))


def _is_lean(pair_tensor, cluster: ClusterTensors) -> bool:
    """True when the encoder emitted a width-1 placeholder instead of the
    TP-wide pair tensor: the batch provably carries none of these terms."""
    return pair_tensor.shape[-1] != cluster.topo_pairs.shape[-1]


def _pair_terms_ok(cluster: ClusterTensors, term_pairs, term_valid):
    """AND over terms of 'node belongs to one of the term's allowed pairs'.
    term_pairs bool[B, K, TP], term_valid bool[B, K] -> bool[B, N]."""
    if _is_lean(term_pairs, cluster):
        return _ones(term_pairs.shape[0], cluster.n_nodes,
                     term_pairs.device)
    hit = exact_bool_matmul(term_pairs, cluster.topo_pairs.T)  # [B, K, N]
    return torch.all(hit | ~term_valid[..., None], dim=1)


def no_volume_zone_conflict(cluster: ClusterTensors, pods: PodBatch):
    """NoVolumeZoneConflict (predicates.go:616-741)."""
    return _pair_terms_ok(cluster, pods.vol_zone_pairs, pods.vol_zone_valid)


def check_volume_binding(cluster: ClusterTensors, pods: PodBatch):
    """CheckVolumeBinding (predicates.go:1651-1700)."""
    ok = _pair_terms_ok(cluster, pods.vol_bind_pairs, pods.vol_bind_valid)
    return ok & ~pods.vol_fail_all[:, None]


def _node_label_value(cluster: ClusterTensors, key_id: int):
    """i32[N]: the node's value id for label `key_id` (PAD when absent)."""
    hit = cluster.label_keys == key_id                       # [N, L]
    val = torch.amax(torch.where(hit, cluster.label_vals, PAD), dim=1)
    return torch.where(torch.any(hit, dim=1), val, PAD)


def check_service_affinity(cluster: ClusterTensors, pods: PodBatch,
                           cfg: FilterConfig):
    """CheckServiceAffinity (predicates.go:993-1067); see the JAX package's
    docstring for the d0/d1 reduction of FilterOutPods."""
    B, N = pods.n_pods, cluster.n_nodes
    dev = cluster.valid.device
    ok = _ones(B, N, dev)
    if not cfg.service_affinity_labels:
        return ok
    narange = torch.arange(N, dtype=torch.int32, device=dev)[None]
    d0 = pods.svc_aff_d0[:, None]
    d1 = pods.svc_aff_d1[:, None]
    src = torch.where(d0 == narange, d1, d0)                 # [B, N]
    has_src = src >= 0
    src_c = torch.clamp_min(src, 0).long()
    for j, key_id in enumerate(cfg.service_affinity_labels):
        vals = _node_label_value(cluster, key_id)            # [N]
        fixed = pods.svc_aff_fixed[:, j][:, None]            # [B, 1]
        v_src = torch.where(has_src, vals[src_c], PAD)       # [B, N]
        ok_fixed = vals[None] == fixed
        ok_backfill = ~has_src | (v_src == PAD) | (vals[None] == v_src)
        ok = ok & torch.where(fixed != PAD, ok_fixed, ok_backfill)
    return ok


def check_node_label_presence(cluster: ClusterTensors, pods: PodBatch,
                              cfg: FilterConfig):
    """CheckNodeLabelPresence (predicates.go:923-967), policy-configured."""
    ok = _ones(pods.n_pods, cluster.n_nodes, cluster.valid.device)
    for key_id in cfg.label_presence_keys:
        present = torch.any(cluster.label_keys == key_id, dim=-1)  # [N]
        ok = ok & (present[None] == cfg.label_presence_present)
    return ok


def required_affinity_ok(cluster: ClusterTensors, pods: PodBatch):
    """bool[B, N]: the pod's required affinity rules alone hold on the node
    (component 3 of MatchInterPodAffinity)."""
    if _is_lean(pods.aff_term_pairs, cluster):
        return _ones(pods.n_pods, cluster.n_nodes, cluster.valid.device)
    topo_t = cluster.topo_pairs.T                            # [TP, N]
    aff_hit = exact_bool_matmul(pods.aff_term_pairs, topo_t)  # [B, PT, N]
    any_match = torch.any(pods.aff_term_pairs, dim=-1)       # [B, PT]
    key_pairs = (
        pods.aff_term_topo_key[:, :, None] == cluster.pair_topo_key[None, None]
    )                                                        # [B, PT, TP]
    node_has_key = exact_bool_matmul(key_pairs, topo_t)      # [B, PT, N]
    bootstrap = (
        ~any_match[..., None] & pods.aff_term_self[..., None] & node_has_key
    )
    term_ok = aff_hit | bootstrap | ~pods.aff_term_valid[..., None]
    return torch.all(term_ok, dim=1)


def match_inter_pod_affinity(cluster: ClusterTensors, pods: PodBatch):
    """MatchInterPodAffinity (predicates.go:1196-1509) via topology-pair
    incidence tensors: existing pods' anti-affinity (forbidden pairs), the
    pod's own anti-affinity terms, and its required affinity terms with the
    first-pod bootstrap rule."""
    if _is_lean(pods.aff_term_pairs, cluster):
        return _ones(pods.n_pods, cluster.n_nodes, cluster.valid.device)
    topo_t = cluster.topo_pairs.T                            # [TP, N]
    viol1 = exact_bool_matmul(pods.forbidden_pairs, topo_t)  # [B, N]
    anti_hit = exact_bool_matmul(pods.anti_term_pairs, topo_t)  # [B, AT, N]
    viol2 = torch.any(anti_hit & pods.anti_term_valid[..., None], dim=1)
    aff_ok = required_affinity_ok(cluster, pods)
    return ~viol1 & ~viol2 & aff_ok


# ------------------------------------------------------------ the full stack


def _predicate_rows(cluster: ClusterTensors, pods: PodBatch,
                    cfg: FilterConfig, unsched_taint_key: int):
    """Every predicate's bool[B, N] verdict, one at a time in
    PREDICATE_ORDER; a predicate the profile disables reads all true."""
    B, N = pods.n_pods, cluster.n_nodes
    ones = _ones(B, N, cluster.valid.device)
    res = pod_fits_resources(cluster, pods)
    host = pod_fits_host(cluster, pods)
    ports = pod_fits_host_ports(cluster, pods)
    sel = pod_match_node_selector(cluster, pods)
    vols = max_volume_counts(cluster, pods, cfg.max_vols)
    per = {
        "CheckNodeCondition": lambda: check_node_condition(cluster, pods),
        "CheckNodeUnschedulable":
            lambda: check_node_unschedulable(cluster, pods, unsched_taint_key),
        "GeneralPredicates": lambda: res & host & ports & sel,
        "PodFitsHost": lambda: host,
        "PodFitsHostPorts": lambda: ports,
        "PodMatchNodeSelector": lambda: sel,
        "PodFitsResources": lambda: res,
        "NoDiskConflict": lambda: no_disk_conflict(cluster, pods),
        "PodToleratesNodeTaints":
            lambda: pod_tolerates_node_taints(cluster, pods),
        "PodToleratesNodeNoExecuteTaints":
            lambda: pod_tolerates_no_execute_taints(cluster, pods),
        "CheckNodeLabelPresence":
            lambda: check_node_label_presence(cluster, pods, cfg),
        "CheckServiceAffinity":
            lambda: check_service_affinity(cluster, pods, cfg),
        "MaxEBSVolumeCount": lambda: vols[:, 0],
        "MaxGCEPDVolumeCount": lambda: vols[:, 1],
        # the named CSI predicate folds the generic column AND every
        # per-driver column (one verdict, per-driver accounting)
        "MaxCSIVolumeCount": lambda: (
            vols[:, VOL_CSI] & torch.all(vols[:, NUM_VOL_TYPES:], dim=1)
            if vols.shape[1] > NUM_VOL_TYPES else vols[:, VOL_CSI]
        ),
        "MaxAzureDiskVolumeCount": lambda: vols[:, 3],
        "MaxCinderVolumeCount": lambda: vols[:, 4],
        "CheckVolumeBinding": lambda: check_volume_binding(cluster, pods),
        "NoVolumeZoneConflict": lambda: no_volume_zone_conflict(cluster, pods),
        "CheckNodeMemoryPressure":
            lambda: check_node_memory_pressure(cluster, pods),
        "CheckNodePIDPressure": lambda: check_node_pid_pressure(cluster, pods),
        "CheckNodeDiskPressure":
            lambda: check_node_disk_pressure(cluster, pods),
        "MatchInterPodAffinity":
            lambda: match_inter_pod_affinity(cluster, pods),
    }
    enabled = set(cfg.enabled) if cfg.enabled is not None else None
    for name, _ in sorted(PRED_INDEX.items(), key=lambda kv: kv[1]):
        # disabled by the provider/Policy profile: never filters, never
        # appears in failure attribution
        yield ones if enabled is not None and name not in enabled \
            else per[name]()


def predicate_stack_plain(cluster: ClusterTensors, pods: PodBatch,
                          cfg: FilterConfig, unsched_taint_key: int = 0):
    """K11's plain twin in stack mode: bool[B, K, N], every predicate's
    verdict, rows in PREDICATE_ORDER."""
    return torch.stack(
        list(_predicate_rows(cluster, pods, cfg, unsched_taint_key)), dim=1)


def filter_batch_plain(cluster: ClusterTensors, pods: PodBatch,
                       cfg: FilterConfig, unsched_taint_key: int = 0,
                       need_per: bool = True):
    """K11's plain twin: every predicate; returns (mask bool[B, N],
    per_pred bool[B, K, N]).

    per_pred rows follow PREDICATE_ORDER.  With need_per=False, per_pred is
    None and the stack is never materialized (the engines' hot path)."""
    alive = cluster.valid[None] & pods.valid[:, None]
    if need_per:
        stack = predicate_stack_plain(cluster, pods, cfg, unsched_taint_key)
        return torch.all(stack, dim=1) & alive, stack
    # hot path: fold the AND pairwise instead of materializing the
    # [B, K, N] stack
    mask = alive
    for row in _predicate_rows(cluster, pods, cfg, unsched_taint_key):
        mask = mask & row
    return mask, None


def pair_hits(cluster: ClusterTensors, pods: PodBatch):
    """The topology-pair incidence products K11 reads, as one exact f32
    product (hits f32[B, X, N], offsets): row offsets["forb"] is the
    existing pods' forbidden pairs, then the pod's anti-affinity terms
    ("anti"), its required affinity terms ("aff") and their topology keys'
    pairs ("key"), the volume zone ("vz") and binding ("vb") terms; a
    family the batch is lean in has no rows and no key.  (None, {}) when
    the batch is lean in all of them."""
    parts, offsets, x = [], {}, 0
    topo = cluster.topo_pairs

    def add(name, t):
        nonlocal x
        offsets[name] = x
        parts.append(t)
        x += t.shape[1]

    if not _is_lean(pods.aff_term_pairs, cluster):
        add("forb", pods.forbidden_pairs[:, None])
        add("anti", pods.anti_term_pairs)
        add("aff", pods.aff_term_pairs)
        add("key", pods.aff_term_topo_key[:, :, None]
            == cluster.pair_topo_key[None, None])
    if not _is_lean(pods.vol_zone_pairs, cluster):
        add("vz", pods.vol_zone_pairs)
    if not _is_lean(pods.vol_bind_pairs, cluster):
        add("vb", pods.vol_bind_pairs)
    if not parts:
        return None, offsets
    pairs = torch.cat(parts, dim=1).to(torch.float32)        # [B, X, TP]
    return torch.matmul(pairs, topo.T.to(torch.float32)), offsets


def _filter_pass(cluster, pods, cfg, unsched_taint_key, stack):
    from kubernetes_tpu_torch import kernels

    hits, offsets = pair_hits(cluster, pods)
    return kernels.filter_pass(cluster, pods, cfg, unsched_taint_key, hits,
                               offsets, stack)


def predicate_stack(cluster: ClusterTensors, pods: PodBatch,
                    cfg: FilterConfig, unsched_taint_key: int = 0):
    """bool[B, K, N]: every predicate's verdict, rows in PREDICATE_ORDER.
    K11 in stack mode on CUDA tensors (it launches or raises), its plain
    twin on CPU tensors."""
    if cluster.valid.is_cuda:
        return _filter_pass(cluster, pods, cfg, unsched_taint_key, True)
    return predicate_stack_plain(cluster, pods, cfg, unsched_taint_key)


def filter_batch(cluster: ClusterTensors, pods: PodBatch, cfg: FilterConfig,
                 unsched_taint_key: int = 0, need_per: bool = True):
    """Run every predicate; returns (mask bool[B, N], per_pred bool[B, K, N]
    or None without need_per), see filter_batch_plain.  On CUDA tensors:
    K11 in mask mode, or with need_per K11 in stack mode folded by K7 (each
    launches or raises); on CPU tensors the plain twin."""
    if not cluster.valid.is_cuda:
        return filter_batch_plain(cluster, pods, cfg, unsched_taint_key,
                                  need_per)
    if not need_per:
        return _filter_pass(cluster, pods, cfg, unsched_taint_key,
                            False), None
    stack = _filter_pass(cluster, pods, cfg, unsched_taint_key, True)
    mask, _ = fold_predicates(stack, cluster.valid, pods.valid)
    return mask, stack


def first_failure(per_pred):
    """i32[B, N]: index (in PREDICATE_ORDER) of the first failing predicate,
    or NUM_PREDICATES if the node fits."""
    failed = ~per_pred                               # [B, K, N]
    idx = torch.argmax(failed.to(torch.uint8), dim=1)  # first True along K
    any_fail = torch.any(failed, dim=1)
    return torch.where(any_fail, idx, NUM_PREDICATES).to(torch.int32)


def fold_predicates_plain(per_pred, valid, pod_valid):
    """K7's plain twin: (mask bool[B, N], failure i32[B, N]) of one filter
    pass, the reference's `jnp.all(stack, 1) & alive` and first_failure
    (failure ignores valid and pod_valid)."""
    mask = torch.all(per_pred, dim=1) & valid[None] & pod_valid[:, None]
    return mask, first_failure(per_pred)


def fold_predicates(per_pred, valid, pod_valid):
    """The fold of one filter pass: K7 on CUDA tensors (it launches or
    raises), its plain twin on CPU tensors."""
    if per_pred.is_cuda:
        from kubernetes_tpu_torch import kernels

        return kernels.fold_predicates(per_pred, valid, pod_valid)
    return fold_predicates_plain(per_pred, valid, pod_valid)
