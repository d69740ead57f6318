"""Static tensor schema for device-resident cluster state (PyTorch port).

A copy of the JAX package's codec/schema.py with the same dataclasses,
field names, dtypes and constants, minus the pytree registration.  The
encoder fills these dataclasses with numpy arrays; `cluster_to_torch`,
`pods_to_torch` and `ports_to_torch` move them onto a torch device and
`to_numpy` brings them back.  Those converters take the JAX encoder's
dataclasses as well as the port's own (they read fields by name), which is
how state is carried across from the reference.

Cluster state is a columnar struct-of-arrays over the node axis N, pending
pods a struct-of-arrays over the batch axis B.  All strings are interned
int32 ids (codec/interner.py); all variable-length lists are padded to the
static widths declared in `PadDims`.

The mapping from the reference:
  NodeInfo (pkg/scheduler/nodeinfo/node_info.go:47-148)  -> rows of ClusterTensors
  NodeInfoSnapshot (internal/cache/interface.go:125-128) -> ClusterTensors + generation
  predicateMetadata topology-pair maps (algorithm/predicates/metadata.go:64-94)
      -> the [*, TP] topology-pair incidence tensors
  priorityMetadata selectors (algorithm/priorities/metadata.go)
      -> the spread-group count columns
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

import numpy as np
import torch

PAD = -1  # universal padding id
WILDCARD = 0  # interner id of "" — wildcard IP for host ports

# A reserved pseudo-label key id representing the node-name field, used to
# fold NodeSelectorTerm.matchFields (metadata.name) into the same expression
# encoding as matchExpressions.  Interners reserve id 0 for ""; encoders
# intern this sentinel string first, so its id is always 1 (asserted there).
FIELD_NODE_NAME = "__field:metadata.name"
FIELD_NODE_NAME_ID = 1

# Taint effects (ref core/v1/types.go TaintEffect)
EFFECT_CODES = {"NoSchedule": 0, "PreferNoSchedule": 1, "NoExecute": 2}
# Toleration operators (ref core/v1/types.go TolerationOperator); empty
# operator defaults to Equal (toleration.go ToleratesTaint)
TOL_OP_CODES = {"Equal": 0, "": 0, "Exists": 1}
# Node-selector operators (ref core/v1/types.go NodeSelectorOperator)
SEL_OP_CODES = {"In": 0, "NotIn": 1, "Exists": 2, "DoesNotExist": 3, "Gt": 4, "Lt": 5}

# Resource columns. Fixed layout of the resource axis R; extended resources
# (device plugins etc.) occupy columns >= RES_EXT0.
# ref nodeinfo.Resource (node_info.go:139-148): MilliCPU, Memory,
# EphemeralStorage, AllowedPodNumber, ScalarResources.
RES_MILLICPU = 0
RES_MEMORY = 1
RES_EPHEMERAL = 2
RES_PODS = 3
RES_EXT0 = 4

# Predicate codes, in the reference's mandatory evaluation order
# (algorithm/predicates/predicates.go:142-151 predicatesOrdering).  The device
# path evaluates ALL of them in one launch; this order is used only to
# attribute the *first* failure reason for FitError parity
# (generic_scheduler.go podFitsOnNode short-circuit semantics).
PREDICATE_ORDER = (
    "CheckNodeCondition",
    "CheckNodeUnschedulable",
    "GeneralPredicates",      # = HostName + HostPorts + Resources + NodeSelector
    "PodFitsHost",
    "PodFitsHostPorts",
    "PodMatchNodeSelector",
    "PodFitsResources",
    "NoDiskConflict",
    "PodToleratesNodeTaints",
    "PodToleratesNodeNoExecuteTaints",
    "CheckNodeLabelPresence",
    "CheckServiceAffinity",
    "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount",
    "MaxCSIVolumeCount",
    "MaxAzureDiskVolumeCount",
    "MaxCinderVolumeCount",
    "CheckVolumeBinding",
    "NoVolumeZoneConflict",
    "CheckNodeMemoryPressure",
    "CheckNodePIDPressure",
    "CheckNodeDiskPressure",
    "MatchInterPodAffinity",
)
PRED_INDEX = {name: i for i, name in enumerate(PREDICATE_ORDER)}
NUM_PREDICATES = len(PREDICATE_ORDER)

# --- decision attribution (the explain/ledger axis) ---------------------
# The attribution launch collapses the per-plugin sub-masks into one
# first-failing-predicate code per (pod, node) in PREDICATE_ORDER — the
# reference's podFitsOnNode short-circuit attribution — plus one extra
# code for nodes every predicate passed but the extra mask vetoed (an
# extender filter verdict, a tensor Filter plugin, or a nominated-pod
# port/anti-affinity block).  The aggregate GeneralPredicates row never
# attributes: its constituents (host/ports/selector/resources) follow it
# in PREDICATE_ORDER and name the precise reason instead.
REASON_EXTENDER = NUM_PREDICATES
NUM_REASONS = NUM_PREDICATES + 1
REASON_EXTENDER_NAME = "ExtenderFilter"

# kubectl-describe-parity message per reason (the FitError reason strings
# of algorithm/predicates/error.go, phrased for the "N node(s) ..." event
# format); predicates without a bespoke string fall back to their name.
REASON_MESSAGES = {
    "CheckNodeCondition": "node(s) were not ready",
    "CheckNodeUnschedulable": "node(s) were unschedulable",
    "PodFitsHost": "node(s) didn't match the requested hostname",
    "PodFitsHostPorts": "node(s) didn't have free ports for the requested "
                        "pod ports",
    "PodMatchNodeSelector": "node(s) didn't match node selector",
    "PodFitsResources": "Insufficient resources",
    "NoDiskConflict": "node(s) had no available volume zone",
    "PodToleratesNodeTaints": "node(s) had taints that the pod didn't "
                              "tolerate",
    "PodToleratesNodeNoExecuteTaints": "node(s) had NoExecute taints that "
                                       "the pod didn't tolerate",
    "CheckVolumeBinding": "node(s) didn't find available persistent "
                          "volumes to bind",
    "NoVolumeZoneConflict": "node(s) had volume node affinity conflict",
    "CheckNodeMemoryPressure": "node(s) had memory pressure",
    "CheckNodePIDPressure": "node(s) had pid pressure",
    "CheckNodeDiskPressure": "node(s) had disk pressure",
    "MatchInterPodAffinity": "node(s) didn't match pod "
                             "affinity/anti-affinity",
    REASON_EXTENDER_NAME: "node(s) were filtered by an extender or plugin",
}


def reason_name(code: int) -> str:
    """Reason code (attribution counts axis) -> predicate/plugin name."""
    if 0 <= code < NUM_PREDICATES:
        return PREDICATE_ORDER[code]
    return REASON_EXTENDER_NAME


def reason_message(code: int) -> str:
    name = reason_name(code)
    return REASON_MESSAGES.get(name, f"node(s) failed {name}")

# Priority (score) functions.  The first eight are the default provider set
# (algorithmprovider/defaults/defaults.go defaultPriorities(): all weight 1;
# NodePreferAvoidPods weight 10000, register_priorities.go:87); the tail are
# registered-but-default-off functions selectable via Policy / providers /
# feature gates (MostRequested: ClusterAutoscalerProvider; NodeLabel +
# RequestedToCapacityRatio: policy arguments; ResourceLimits: the
# ResourceLimitsPriorityFunction feature gate).
PRIORITY_ORDER = (
    "SelectorSpreadPriority",
    "InterPodAffinityPriority",
    "LeastRequestedPriority",
    "BalancedResourceAllocation",
    "NodePreferAvoidPodsPriority",
    "NodeAffinityPriority",
    "TaintTolerationPriority",
    "ImageLocalityPriority",
    "MostRequestedPriority",
    "NodeLabelPriority",
    "RequestedToCapacityRatioPriority",
    "ResourceLimitsPriority",
)
PRIO_INDEX = {name: i for i, name in enumerate(PRIORITY_ORDER)}
NUM_PRIORITIES = len(PRIORITY_ORDER)
# attribution score-breakdown axis: every priority plugin plus one
# "Extra" slot for the extender-prioritize / tensor-Score contribution
SCORE_COMPONENTS = PRIORITY_ORDER + ("Extra",)
NUM_SCORE_COMPONENTS = len(SCORE_COMPONENTS)
DEFAULT_PRIORITY_WEIGHTS = np.array(
    [1.0, 1.0, 1.0, 1.0, 10000.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0],
    dtype=np.float32,
)

# Volume filter types for MaxVolumeCount predicates
# (predicates.go EBS/GCE/AzureDisk/Cinder VolumeFilterType + CSI)
VOL_EBS, VOL_GCE, VOL_CSI, VOL_AZURE, VOL_CINDER = 0, 1, 2, 3, 4
NUM_VOL_TYPES = 5


def _pow2(n: int, floor: int = 1) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def aimd_pow2_widths(batch_size_min: int, batch_size: int) -> "list[int]":
    """The distinct pow2 ENCODE widths the AIMD batch sizer can visit while
    ramping from batch_size_min to batch_size: the additive-increase steps
    land on arbitrary integers, but encode_pods pads every batch to a pow2
    bucket, so these are exactly the batch shapes the runtime launches.

    THE shared source for compile pre-warming — the scheduler's startup
    prewarm and bench.py's warmup sweep both import this, so the two can
    never drift (a width missing here is a mid-storm compile stall)."""
    lo = _pow2(max(1, batch_size_min))
    hi = _pow2(max(1, batch_size))
    # a floor above the cap (e.g. batch_size 8 with the default min 16)
    # still dispatches at the cap width — never return an empty ladder
    lo = min(lo, hi)
    out = []
    w = lo
    while w <= hi:
        out.append(w)
        w *= 2
    return out


@dataclass(frozen=True)
class PadDims:
    """Static pad widths.  Every field is a maximum-over-the-snapshot, rounded
    up to a power of two by `SnapshotEncoder.fit()`."""

    N: int = 8        # nodes (padded; `valid` masks the tail)
    B: int = 1        # pod batch
    R: int = 8        # resource columns (4 core + extended)
    L: int = 8        # labels per node
    T: int = 4        # taints per node
    P: int = 8        # occupied host-ports per node
    Q: int = 4        # host-ports per pod
    TT: int = 4       # tolerations per pod
    NS: int = 4       # plain nodeSelector (map) entries per pod
    S: int = 2        # required node-affinity terms per pod
    E: int = 4        # expressions per node-affinity term
    V: int = 4        # values per expression
    PS: int = 2       # preferred node-affinity terms per pod
    TP: int = 16      # topology-pair vocabulary size
    PT: int = 2       # required pod-affinity terms per pod
    AT: int = 2       # required pod-anti-affinity terms per pod
    G: int = 16       # spread-group vocabulary (services/RCs/RSs/SSs)
    GP: int = 4       # spread groups per pod
    I: int = 8        # images per node
    C: int = 4        # containers (images) per pod
    A: int = 2        # prefer-avoid owner uids per node
    DV: int = 4       # disk-conflict volume ids per pod
    DVN: int = 8      # disk-conflict volume ids per node
    VZ: int = 2       # volume zone-restriction terms per pod (bound PV labels)
    VB: int = 2       # volume binding-restriction terms per pod
    VT: int = NUM_VOL_TYPES  # attach-count filter columns (base types + one per
                      #   distinct CSI driver — csi_volume_predicate.go
                      #   counts and limits PER DRIVER)

    def bump(self, **kw: int) -> "PadDims":
        return dataclasses.replace(
            self, **{k: _pow2(v) for k, v in kw.items() if v > getattr(self, k)}
        )


@dataclass
class ClusterTensors:
    """Struct-of-arrays cluster snapshot, node axis N.

    Dynamic fields (mutated by the on-device commit step of batched
    scheduling): requested, nonzero_req, port_used.
    Everything else is static per snapshot.
    """

    # -- resources (PodFitsResources, resource scores) --
    allocatable: Any        # f32[N, R]
    requested: Any          # f32[N, R]   (col RES_PODS counts pods)
    nonzero_req: Any        # f32[N, 2]   (milliCPU, memory) with nonzero defaults
    # -- node status / spec --
    valid: Any              # bool[N]     padding mask
    unschedulable: Any      # bool[N]     (.spec.unschedulable)
    not_ready: Any          # bool[N]     CheckNodeCondition (Ready!="True" | net unavailable)
    mem_pressure: Any       # bool[N]
    disk_pressure: Any      # bool[N]
    pid_pressure: Any       # bool[N]
    node_name_id: Any       # i32[N]
    # -- labels --
    label_keys: Any         # i32[N, L]  (PAD-filled)
    label_vals: Any         # i32[N, L]
    label_nums: Any         # f32[N, L]  numeric value of label (nan if not an int) for Gt/Lt
    # -- taints --
    taint_key: Any          # i32[N, T]
    taint_val: Any          # i32[N, T]
    taint_effect: Any       # i32[N, T]  (EFFECT_CODES, PAD)
    # -- host ports (occupied by existing pods) --
    port_pp: Any            # i32[N, P]  interned "proto/port" id, PAD empty
    port_ip: Any            # i32[N, P]  interned IP, WILDCARD = 0.0.0.0/""
    port_used: Any          # bool[N, P] slot occupancy
    # -- topology --
    topo_pairs: Any         # bool[N, TP] node belongs to topology pair tp
    #   (includes the synthetic GetZoneKey pair grouping nodes by region+zone)
    # -- spreading (SelectorSpread) --
    group_counts: Any       # f32[N, G]  zero-filled shape carrier (G = spread
                            #   groups); per-pod counts live in
                            #   PodBatch.spread_counts
    # -- inter-pod affinity state --
    pair_topo_key: Any      # i32[TP]    topology-key id of each pair (PAD unused)
    # -- images (ImageLocality) --
    image_id: Any           # i32[N, I]
    image_size: Any         # f32[N, I]  bytes
    # -- NodePreferAvoidPods --
    avoid_owner: Any        # i32[N, A]  controller-owner uid ids to avoid
    # -- volumes --
    vol_counts: Any         # f32[N, VT] attached unique volumes per filter
                            #   column (5 base types + per-CSI-driver)
    vol_limits: Any         # f32[N, VT] per-node attachable limits
    disk_vol_ids: Any       # i32[N, DVN] interned volume ids in use (NoDiskConflict)

    @property
    def n_nodes(self) -> int:
        return self.allocatable.shape[0]


@dataclass
class PodBatch:
    """Struct-of-arrays pending-pod batch, batch axis B.

    The per-pod topology-pair tensors (forbidden_pairs, aff_term_pairs, ...)
    are the tensorization of predicateMetadata's topologyPairsMaps
    (algorithm/predicates/metadata.go:64-94): host code matches label
    selectors against existing pods (vectorized numpy) and the device reduces
    pair incidence per node.
    """

    valid: Any              # bool[B]
    req: Any                # f32[B, R]  resource request (col RES_PODS = 1)
    nonzero_req: Any        # f32[B, 2]
    limits2: Any            # f32[B, 2]  (milliCPU, memory) limits (ResourceLimitsPriority)
    priority: Any           # i32[B]
    best_effort: Any        # bool[B]    QoS BestEffort (no requests/limits at all)
    ns_id: Any              # i32[B]     namespace id
    owner_uid: Any          # i32[B]     controller owner uid id (PAD none)
    node_name_req: Any      # i32[B]     .spec.nodeName / PAD (PodFitsHost)
    # host ports requested
    port_pp: Any            # i32[B, Q]
    port_ip: Any            # i32[B, Q]
    port_valid: Any         # bool[B, Q]
    # tolerations
    tol_key: Any            # i32[B, TT]  (PAD slot invalid; WILDCARD key = all keys)
    tol_op: Any             # i32[B, TT]  TOL_OP_CODES
    tol_val: Any            # i32[B, TT]
    tol_effect: Any         # i32[B, TT]  EFFECT_CODES; PAD = matches all effects
    tol_valid: Any          # bool[B, TT]
    # plain nodeSelector map (AND of key==value)
    ns_keys: Any            # i32[B, NS]
    ns_vals: Any            # i32[B, NS]
    ns_valid: Any           # bool[B, NS]
    # required node affinity: OR over S terms of AND over E exprs
    has_req_affinity: Any   # bool[B]
    term_valid: Any         # bool[B, S]
    expr_key: Any           # i32[B, S, E]
    expr_op: Any            # i32[B, S, E]  SEL_OP_CODES
    expr_vals: Any          # i32[B, S, E, V]
    expr_nval: Any          # i32[B, S, E]  number of valid values
    expr_num: Any           # f32[B, S, E]  numeric value for Gt/Lt (nan if invalid)
    expr_valid: Any         # bool[B, S, E]
    # preferred node affinity (score): PS terms, each AND of E exprs, weighted
    pref_weight: Any        # f32[B, PS]
    pref_term_valid: Any    # bool[B, PS]
    pref_expr_key: Any      # i32[B, PS, E]
    pref_expr_op: Any       # i32[B, PS, E]
    pref_expr_vals: Any     # i32[B, PS, E, V]
    pref_expr_nval: Any     # i32[B, PS, E]
    pref_expr_num: Any      # f32[B, PS, E]
    pref_expr_valid: Any    # bool[B, PS, E]
    # inter-pod affinity (precomputed pair incidence)
    forbidden_pairs: Any    # bool[B, TP] existing anti-affinity violated here
    aff_term_pairs: Any     # bool[B, PT, TP] pairs satisfying required affinity term
    aff_term_valid: Any     # bool[B, PT]
    aff_term_self: Any      # bool[B, PT] term's selector matches the pod itself
    aff_term_topo_key: Any  # i32[B, PT]  topology key id of the term
    anti_term_pairs: Any    # bool[B, AT, TP] pairs violating pod's own anti-affinity
    anti_term_valid: Any    # bool[B, AT]
    anti_term_topo_key: Any # i32[B, AT]
    anti_term_self: Any     # bool[B, AT] term matches the pod itself (self-anti-affinity)
    pref_pair_weights: Any  # f32[B, TP] combined soft affinity weight per pair
    # spreading
    group_ids: Any          # i32[B, GP]
    group_valid: Any        # bool[B, GP]
    spread_counts: Any      # f32[B, N] existing pods per node matching ALL of
                            #   the pod's spread selectors (countMatchingPods
                            #   AND semantics, selector_spreading.go:165-187);
                            #   [B, 1] placeholder for spread-lean batches
    # CheckServiceAffinity (predicates.go:993-1067), policy-configured:
    svc_aff_fixed: Any      # i32[B, SA] value id the pod's nodeSelector pins
                            #   for configured label j (PAD = not pinned)
    svc_aff_d0: Any         # i32[B] node row of the FIRST same-ns pod whose
                            #   labels superset-match the pod's (-1 = none)
    svc_aff_d1: Any         # i32[B] first such pod on a DIFFERENT node than
                            #   d0 (-1 = none) — FilterOutPods(evaluated
                            #   node) reduces to d0-unless-thats-you-else-d1
    # images
    image_ids: Any          # i32[B, C]  (PAD empty)
    image_bytes: Any        # f32[B, C]  total size if known (0 otherwise)
    # volumes
    new_vol_counts: Any     # f32[B, VT] unique volumes the pod
                            #   references (per attach-count filter type)
    vol_overlap: Any        # f32[B, VT, N] of those, how many are already
                            #   mounted per node (subtract: they attach
                            #   nothing new); [B, VT, 1] lean placeholder
    disk_vol_ids: Any       # i32[B, DV] exclusive-use volume ids (NoDiskConflict)
    # volume topology restrictions, as hostname-pair sets (exact: the host
    # evaluates PV zone labels / nodeAffinity / binding candidates against
    # every node and emits the allowed-node pair set per volume)
    vol_zone_pairs: Any     # bool[B, VZ, TP] NoVolumeZoneConflict terms
    vol_zone_valid: Any     # bool[B, VZ]
    vol_bind_pairs: Any     # bool[B, VB, TP] CheckVolumeBinding terms
    vol_bind_valid: Any     # bool[B, VB]
    vol_fail_all: Any       # bool[B] unbound PVC with no candidate PV / missing PVC

    @property
    def n_pods(self) -> int:
        return self.req.shape[0]


@dataclass(frozen=True)
class FilterConfig:
    """Static knobs threaded through the kernels.

    max_vols mirrors DefaultMaxEBSVolumes=39/aws, GCE/Azure=16
    (predicates.go:109-115); hard_pod_affinity_weight ref
    apis/config/types.go HardPodAffinitySymmetricWeight default 1.
    `enabled` selects the active predicate set (None = all): the analog of
    the provider/Policy predicate registry (factory/plugins.go); disabled
    predicates neither filter nor appear in failure attribution.
    """

    max_vols: tuple = (39.0, 16.0, 1e9, 16.0, 1e9)
    hard_pod_affinity_weight: float = 1.0
    # CheckNodeLabelPresence / CheckServiceAffinity are policy-configured and
    # default-off (defaults.go defaultPredicates has neither); encoded as
    # always-pass unless configured.
    label_presence_keys: tuple = ()
    label_presence_present: bool = True
    # CheckServiceAffinity homogeneity labels (interned key ids; the Policy
    # serviceAffinity argument, predicates.go:993-1067)
    service_affinity_labels: tuple = ()
    enabled: Optional[tuple] = None  # tuple of predicate names, or None=all


@dataclass(frozen=True)
class ScoreConfig:
    """Static arguments for the policy-driven priorities.

    label_prefs: ((key_id, presence, weight), ...) — NodeLabelPriority
    (priorities/node_label.go): presence=True scores 10 when the label
    exists.  rtc_shape: ((utilization%, score), ...) ascending — the
    RequestedToCapacityRatio piecewise-linear curve
    (priorities/requested_to_capacity_ratio.go).
    """

    label_prefs: tuple = ()
    rtc_shape: tuple = ((0.0, 10.0), (100.0, 0.0))


# ------------------------------------------------ host <-> device converters


def _to_tensor(a, device) -> torch.Tensor:
    """One field -> a tensor on `device` with the same dtype (numpy arrays,
    JAX arrays and tensors alike).  Read-only numpy views are copied so
    torch never aliases memory it may not write."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device)


def _convert(src, cls, fn):
    return cls(**{f.name: fn(getattr(src, f.name)) for f in fields(cls)})


def cluster_to_torch(ct, device="cuda") -> ClusterTensors:
    """A ClusterTensors of numpy (or JAX) arrays -> the port's
    ClusterTensors of tensors on `device`, field for field."""
    return _convert(ct, ClusterTensors, lambda a: _to_tensor(a, device))


def pods_to_torch(pb, device="cuda") -> PodBatch:
    """A PodBatch of numpy (or JAX) arrays -> tensors on `device`."""
    return _convert(pb, PodBatch, lambda a: _to_tensor(a, device))


def ports_to_torch(bps, device="cuda"):
    """A BatchPortState (pod_ports, conflict) -> tensors on `device`."""
    from kubernetes_tpu_torch.models.batched import BatchPortState

    return _convert(bps, BatchPortState, lambda a: _to_tensor(a, device))


def to_numpy(obj):
    """A dataclass of tensors -> the same dataclass of numpy arrays."""

    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    return _convert(obj, type(obj), conv)
