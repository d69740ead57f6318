"""Object-level golden scheduler, mirroring pkg/scheduler/algorithm semantics.

Every function cites the reference Go code it reproduces.  Integer score math
uses Python ints, matching the reference's int64 truncation exactly.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api import labels as klabels
from kubernetes_tpu_torch.api.resource import Quantity
from kubernetes_tpu_torch.codec.schema import NUM_VOL_TYPES, VOL_CSI
from kubernetes_tpu_torch.api.types import (
    DEFAULT_MEMORY_REQUEST,
    DEFAULT_MILLI_CPU_REQUEST,
    Node,
    Pod,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    Taint,
)

MAX_PRIORITY = 10
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
REGION_KEY = "failure-domain.beta.kubernetes.io/region"
ZONE_WEIGHTING = 2.0 / 3.0
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"


# ------------------------------------------------------------------ helpers


def get_zone_key(node: Node) -> Optional[str]:
    """ref pkg/util/node/node.go:126-143 GetZoneKey: region + ":\\x00:" + zone,
    None when both labels are absent/empty (node belongs to no zone)."""
    region = node.labels.get(REGION_KEY, "")
    zone = node.labels.get(ZONE_KEY, "")
    if not region and not zone:
        return None
    return region + ":\x00:" + zone


def pod_requests(pod: Pod) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, q in pod.resource_request().items():
        out[k] = q.milli if k == RESOURCE_CPU else float(q)
    return out


def nonzero_requests(pod: Pod) -> Tuple[float, float]:
    """ref pkg/scheduler/util/non_zero.go GetNonzeroRequests."""
    cpu = 0.0
    mem = 0.0
    for c in pod.spec.containers:
        cpu += (
            c.requests[RESOURCE_CPU].milli
            if RESOURCE_CPU in c.requests
            else DEFAULT_MILLI_CPU_REQUEST
        )
        mem += (
            float(c.requests[RESOURCE_MEMORY])
            if RESOURCE_MEMORY in c.requests
            else DEFAULT_MEMORY_REQUEST
        )
    return cpu, mem


from kubernetes_tpu_torch.api.types import is_best_effort  # noqa: F401 (shared QoS rule)


def node_allocatable(node: Node) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, q in node.status.allocatable.items():
        out[k] = q.milli if k == RESOURCE_CPU else float(q)
    return out


def tolerations_tolerate(pod: Pod, taint: Taint) -> bool:
    return any(t.tolerates(taint) for t in pod.spec.tolerations)


def match_node_selector_term(pod_term, node: Node) -> bool:
    """ref v1helper.MatchNodeSelectorTerms: AND of matchExpressions (as label
    requirements) and matchFields (metadata.name); a term with an invalid
    label value never matches (NodeSelectorRequirementsAsSelector error)."""
    for expr in pod_term.match_expressions:
        if klabels.requirement_is_unbuildable(
            expr.key, expr.operator, expr.values
        ):
            return False
        req = klabels.Requirement(expr.key, expr.operator, tuple(expr.values))
        if not req.matches(node.labels):
            return False
    for expr in pod_term.match_fields:
        fields = {"metadata.name": node.name}
        req = klabels.Requirement(expr.key, expr.operator, tuple(expr.values))
        if not req.matches(fields):
            return False
    return bool(pod_term.match_expressions or pod_term.match_fields)


def _term_namespaces(term, pod: Pod):
    return set(term.namespaces) if term.namespaces else {pod.namespace}


def _term_matches_pod(term, src_pod: Pod, dst_pod: Pod) -> bool:
    """Does `term` (belonging to src_pod) select dst_pod?
    ref predicates.go podMatchesPodAffinityTerms."""
    if dst_pod.namespace not in _term_namespaces(term, src_pod):
        return False
    sel = klabels.selector_from_label_selector(term.label_selector)
    if sel is None:
        return False
    return sel.matches(dst_pod.labels)


def _topo_value(node: Optional[Node], key: str) -> Optional[str]:
    if node is None:
        return None
    return node.labels.get(key)


# ---------------------------------------------------------------- predicates


class CPUScheduler:
    """Golden scheduler over plain objects.  `nodes` is the cluster; `pods`
    are the scheduled/assumed pods (with spec.node_name set); `services` are
    (namespace, selector-dict) pairs for SelectorSpread."""

    def __init__(
        self,
        nodes: Sequence[Node],
        pods: Sequence[Pod] = (),
        services: Sequence[Tuple[str, Dict[str, str]]] = (),
        max_vols: Tuple[float, ...] = (39, 16, 1e9, 16, 1e9),
        pvs: Sequence = (),
        pvcs: Sequence = (),
        storage_classes: Sequence = (),
        service_affinity_labels: Sequence[str] = (),
    ):
        self.service_affinity_labels = list(service_affinity_labels)
        self.nodes = list(nodes)
        self.pods = list(pods)
        self.services = list(services)
        self.max_vols = max_vols
        self.pvs = {pv.name: pv for pv in pvs}
        self.pvcs = {(c.namespace, c.name): c for c in pvcs}
        self.storage_classes = {s.name: s for s in storage_classes}
        self.by_node: Dict[str, List[Pod]] = defaultdict(list)
        for p in self.pods:
            if p.spec.node_name:
                self.by_node[p.spec.node_name].append(p)
        self.node_by_name = {n.name: n for n in self.nodes}

    # ---- individual predicates (each returns True = fits) ----

    def pod_fits_resources(self, pod: Pod, node: Node) -> bool:
        alloc = node_allocatable(node)
        used: Dict[str, float] = defaultdict(float)
        for p in self.by_node[node.name]:
            for k, v in pod_requests(p).items():
                used[k] += v
        used[RESOURCE_PODS] += len(self.by_node[node.name])
        req = pod_requests(pod)
        req[RESOURCE_PODS] = 1
        for k, v in req.items():
            if v <= 0:
                continue
            if used.get(k, 0.0) + v > alloc.get(k, 0.0):
                return False
        return True

    def pod_fits_host(self, pod: Pod, node: Node) -> bool:
        return not pod.spec.node_name or pod.spec.node_name == node.name

    def pod_fits_host_ports(self, pod: Pod, node: Node) -> bool:
        want = [(p.protocol or "TCP", p.host_ip or "0.0.0.0", p.host_port) for p in pod.host_ports()]
        if not want:
            return True
        have = []
        for p in self.by_node[node.name]:
            for cp in p.host_ports():
                have.append((cp.protocol or "TCP", cp.host_ip or "0.0.0.0", cp.host_port))
        for proto, ip, port in want:
            for hproto, hip, hport in have:
                if proto == hproto and port == hport:
                    if ip == hip or ip == "0.0.0.0" or hip == "0.0.0.0":
                        return False
        return True

    def pod_match_node_selector(self, pod: Pod, node: Node) -> bool:
        for k, v in pod.spec.node_selector.items():
            if node.labels.get(k) != v:
                return False
        aff = pod.spec.affinity
        na = aff.node_affinity if aff else None
        if na and na.required is not None:
            if not any(match_node_selector_term(t, node) for t in na.required.terms):
                return False
        return True

    def check_service_affinity(self, pod: Pod, node: Node) -> bool:
        """ref predicates.go:993-1067 checkServiceAffinity: configured labels
        must be homogenous across a service's pods.  Pinned by the pod's own
        nodeSelector where present; otherwise backfilled from the node of the
        first same-namespace pod whose labels superset-match the pod's own
        (serviceAffinityMetadataProducer), excluding pods on the evaluated
        node (FilterOutPods)."""
        cfg = self.service_affinity_labels
        if not cfg:
            return True
        affinity = {
            k: pod.spec.node_selector[k]
            for k in cfg if k in pod.spec.node_selector
        }
        if len(cfg) > len(affinity):
            services = [
                (ns, sel) for ns, sel in self.services
                if ns == pod.namespace
                and klabels.selector_from_match_labels(sel).matches(pod.labels)
            ]
            if services:
                matches = [
                    p for p in self.pods
                    if p.namespace == pod.namespace
                    and all(
                        p.labels.get(k) == v for k, v in pod.labels.items()
                    )
                    and p.spec.node_name
                    and p.spec.node_name != node.name
                ]
                if matches:
                    src = self.node_by_name.get(matches[0].spec.node_name)
                    if src is not None:
                        for k in cfg:
                            if k not in affinity and k in src.labels:
                                affinity[k] = src.labels[k]
        return all(node.labels.get(k) == v for k, v in affinity.items())

    def pod_tolerates_node_taints(self, pod: Pod, node: Node, effects=(TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE)) -> bool:
        for t in node.spec.taints:
            if t.effect in effects and not tolerations_tolerate(pod, t):
                return False
        return True

    def check_node_unschedulable(self, pod: Pod, node: Node) -> bool:
        if not node.spec.unschedulable:
            return True
        return tolerations_tolerate(
            pod, Taint(key=TAINT_NODE_UNSCHEDULABLE, effect=TAINT_NO_SCHEDULE)
        )

    def check_node_condition(self, pod: Pod, node: Node) -> bool:
        c = node.status.conditions
        return not (
            c.get("Ready", "True") != "True"
            or c.get("OutOfDisk", "False") == "True"
            or c.get("NetworkUnavailable", "False") == "True"
        )

    def check_node_memory_pressure(self, pod: Pod, node: Node) -> bool:
        if node.status.conditions.get("MemoryPressure", "False") != "True":
            return True
        return not is_best_effort(pod)

    def check_node_disk_pressure(self, pod: Pod, node: Node) -> bool:
        return node.status.conditions.get("DiskPressure", "False") != "True"

    def check_node_pid_pressure(self, pod: Pod, node: Node) -> bool:
        return node.status.conditions.get("PIDPressure", "False") != "True"

    @staticmethod
    def _disk_vols(pod: Pod) -> Tuple[List[str], List[str]]:
        """(check tokens, advertise tokens) for NoDiskConflict
        (predicates.go isVolumeConflict :295-328): GCE-PD / RBD / ISCSI
        mounts that are BOTH read-only don't conflict, so an ro-allowance
        volume V advertises "V#any" (+"V#rw" when mounted read-write) and
        checks "V#any" when read-write but only "V#rw" when read-only;
        EBS conflicts regardless of access mode (one token both ways)."""
        check, adv = [], []

        def allow_ro(base: str, ro: bool) -> None:
            adv.append(base + "#any")
            if not ro:
                adv.append(base + "#rw")
            check.append(base + ("#rw" if ro else "#any"))

        for v in pod.spec.volumes:
            if "gcePersistentDisk" in v:
                g = v["gcePersistentDisk"]
                allow_ro("gce/" + g.get("pdName", ""), bool(g.get("readOnly")))
            elif "awsElasticBlockStore" in v:
                t = "ebs/" + v["awsElasticBlockStore"].get("volumeID", "")
                check.append(t)
                adv.append(t)
            elif "rbd" in v:
                # monitor OVERLAP + pool + image (haveOverlap, :264-272):
                # one token per monitor
                r = v["rbd"]
                # no monitors -> no tokens (haveOverlap([], x) is false)
                for mon in r.get("monitors", []) or ():
                    allow_ro(
                        "rbd/%s/%s/%s" % (mon, r.get("pool", "rbd"), r.get("image", "")),
                        bool(r.get("readOnly")),
                    )
            elif "iscsi" in v:
                # IQN alone (:253-262 — multi-path portals, same LUNs)
                r = v["iscsi"]
                allow_ro("iscsi/%s" % r.get("iqn", ""),
                         bool(r.get("readOnly")))
        return check, adv

    def no_disk_conflict(self, pod: Pod, node: Node) -> bool:
        mine = set(self._disk_vols(pod)[0])
        if not mine:
            return True
        for p in self.by_node[node.name]:
            if mine & set(self._disk_vols(p)[1]):
                return False
        return True

    def max_volume_counts(self, pod: Pod, node: Node) -> bool:
        return all(self.max_volume_counts_full(pod, node))

    # ---- volume predicates (object-level, independent of the encoder) ----

    def _pod_pvcs(self, pod: Pod):
        for v in pod.spec.volumes:
            claim = v.get("persistentVolumeClaim")
            if claim:
                yield self.pvcs.get((pod.namespace, claim.get("claimName", "")))

    @staticmethod
    def _pv_zone_ok(pv, node: Node) -> bool:
        for key in (
            "kubernetes.io/hostname",
            ZONE_KEY,
            REGION_KEY,
        ):
            val = pv.labels.get(key)
            if val is not None and node.labels.get(key) not in set(val.split("__")):
                return False
        return True

    @staticmethod
    def _pv_affinity_ok(pv, node: Node) -> bool:
        if pv.node_affinity is None:
            return True
        return any(
            match_node_selector_term(t, node) for t in pv.node_affinity.terms
        )

    def _pv_candidates(self, pvc):
        for pv in self.pvs.values():
            if pv.phase != "Available":
                continue
            if pv.storage_class != pvc.storage_class:
                continue
            if pvc.request is not None and pv.capacity is not None and pv.capacity < pvc.request:
                continue
            if pvc.access_modes and not set(pvc.access_modes) <= set(pv.access_modes):
                continue
            yield pv

    def no_volume_zone_conflict(self, pod: Pod, node: Node) -> bool:
        """ref predicates.go:616-741."""
        for pvc in self._pod_pvcs(pod):
            if pvc is None or not pvc.volume_name:
                continue
            pv = self.pvs.get(pvc.volume_name)
            if pv is not None and not self._pv_zone_ok(pv, node):
                return False
        return True

    def check_volume_binding(self, pod: Pod, node: Node) -> bool:
        """ref predicates.go:1651-1700 via the volume binder semantics."""
        for pvc in self._pod_pvcs(pod):
            if pvc is None:
                return False  # ErrMissingPVC
            if pvc.volume_name:
                pv = self.pvs.get(pvc.volume_name)
                if pv is None:
                    return False
                if not self._pv_affinity_ok(pv, node):
                    return False
            else:
                ok = any(
                    self._pv_affinity_ok(pv, node) and self._pv_zone_ok(pv, node)
                    for pv in self._pv_candidates(pvc)
                )
                if not ok:
                    sc = self.storage_classes.get(pvc.storage_class)
                    if sc is None or not sc.provisioner:
                        return False
        return True

    def _vol_cols_count(self) -> int:
        """5 base columns + one per distinct CSI driver across the PV set
        (csi_volume_predicate.go accounts per driver)."""
        return NUM_VOL_TYPES + len(self._csi_driver_cols())

    def _csi_driver_cols(self) -> Dict[str, int]:
        drivers = sorted({
            pv.csi_driver for pv in self.pvs.values()
            if pv.source_kind == "csi" and pv.csi_driver
        })
        return {d: NUM_VOL_TYPES + i for i, d in enumerate(drivers)}

    def _vol_ids_with_pvc(self, pod: Pod, driver_cols=None) -> List[set]:
        """Per-column UNIQUE volume identities (direct + PVC-resolved) — the
        filterVolumes map keys (predicates.go:330-430); columns past the
        base types are per-CSI-driver.  driver_cols may be precomputed by
        the caller (one scan per verdict, not per pod)."""
        if driver_cols is None:
            driver_cols = self._csi_driver_cols()
        ids: List[set] = [
            set() for _ in range(NUM_VOL_TYPES + len(driver_cols))
        ]
        for v in pod.spec.volumes:
            if "awsElasticBlockStore" in v:
                ids[0].add("ebs/" + v["awsElasticBlockStore"].get("volumeID", ""))
            elif "gcePersistentDisk" in v:
                ids[1].add("gce/" + v["gcePersistentDisk"].get("pdName", ""))
            elif "azureDisk" in v:
                ids[3].add("azd/" + v["azureDisk"].get("diskName", ""))
            elif "cinder" in v:
                ids[4].add("cinder/" + v["cinder"].get("volumeID", ""))
        kind_col = {
            "awsElasticBlockStore": 0,
            "gcePersistentDisk": 1,
            "csi": 2,
            "azureDisk": 3,
            "cinder": 4,
        }
        prefix = ["ebs/", "gce/", "csi/", "azd/", "cinder/"]
        for pvc in self._pod_pvcs(pod):
            if pvc is not None and pvc.volume_name:
                pv = self.pvs.get(pvc.volume_name)
                if pv is not None and pv.source_kind in kind_col:
                    col = kind_col[pv.source_kind]
                    if pv.source_kind == "csi" and pv.csi_driver:
                        col = driver_cols[pv.csi_driver]
                    ident = getattr(pv, "source_id", "") or ("pvname/" + pv.name)
                    ids[col].add(
                        ("csi/" if col >= NUM_VOL_TYPES else prefix[col])
                        + ident
                    )
        return ids

    def max_volume_counts_full(self, pod: Pod, node: Node) -> List[bool]:
        """Per-filter-type verdicts [EBS, GCE, CSI, Azure, Cinder]: used is
        the node's DISTINCT attached set, and pod volumes already mounted
        there attach nothing new (the already-mounted subtraction,
        predicates.go:349-363)."""
        driver_cols = self._csi_driver_cols()
        VT = NUM_VOL_TYPES + len(driver_cols)
        pod_ids = self._vol_ids_with_pvc(pod, driver_cols)
        node_ids: List[set] = [set() for _ in range(VT)]
        for p in self.by_node[node.name]:
            for i, x in enumerate(self._vol_ids_with_pvc(p, driver_cols)):
                node_ids[i] |= x
        used = [float(len(x)) for x in node_ids]
        new = [float(len(pod_ids[i] - node_ids[i])) for i in range(VT)]
        # per-driver columns inherit the CSI default cap
        limits = list(self.max_vols) + [
            float(self.max_vols[VOL_CSI])
            for _ in range(VT - NUM_VOL_TYPES)
        ]
        limit_keys = {
            "attachable-volumes-aws-ebs": 0,
            "attachable-volumes-gce-pd": 1,
            "attachable-volumes-azure-disk": 3,
        }
        for k, q in node.status.allocatable.items():
            if k in limit_keys:
                limits[limit_keys[k]] = min(limits[limit_keys[k]], float(q))
            elif k.startswith("attachable-volumes-csi-"):
                # a per-driver cap applies ONLY to that driver's column;
                # a cap for a driver with no volumes constrains nothing
                driver = k[len("attachable-volumes-csi-"):]
                col = driver_cols.get(driver)
                if col is not None:
                    limits[col] = min(limits[col], float(q))
            elif k.startswith("attachable-volumes-") and "csi" in k:
                limits[2] = min(limits[2], float(q))
        return [
            not (new[i] > 0 and used[i] + new[i] > limits[i])
            for i in range(VT)
        ]

    def match_inter_pod_affinity(self, pod: Pod, node: Node) -> bool:
        """ref predicates.go InterPodAffinityMatches (:1196-1509)."""
        # 1. existing pods' required anti-affinity
        for other in self.pods:
            onode = self.node_by_name.get(other.spec.node_name)
            if onode is None:
                continue
            aff = other.spec.affinity
            if not (aff and aff.pod_anti_affinity):
                continue
            for term in aff.pod_anti_affinity.required:
                if not _term_matches_pod(term, other, pod):
                    continue
                tv = _topo_value(onode, term.topology_key)
                if tv is not None and _topo_value(node, term.topology_key) == tv:
                    return False
        aff = pod.spec.affinity
        if aff is None:
            return True
        # 2. own anti-affinity
        if aff.pod_anti_affinity:
            for term in aff.pod_anti_affinity.required:
                for other in self.pods:
                    onode = self.node_by_name.get(other.spec.node_name)
                    if onode is None:
                        continue
                    if not _term_matches_pod(term, pod, other):
                        continue
                    tv = _topo_value(onode, term.topology_key)
                    if tv is not None and _topo_value(node, term.topology_key) == tv:
                        return False
        # 3. own required affinity
        if aff.pod_affinity:
            for term in aff.pod_affinity.required:
                matches_any = False
                satisfied = False
                for other in self.pods:
                    onode = self.node_by_name.get(other.spec.node_name)
                    if onode is None or not _term_matches_pod(term, pod, other):
                        continue
                    matches_any = True
                    tv = _topo_value(onode, term.topology_key)
                    if tv is not None and _topo_value(node, term.topology_key) == tv:
                        satisfied = True
                        break
                if satisfied:
                    continue
                # first-pod bootstrap: no matching pod anywhere and the term
                # matches the incoming pod itself, on nodes having the key
                if (
                    not matches_any
                    and _term_matches_pod(term, pod, pod)
                    and _topo_value(node, term.topology_key) is not None
                ):
                    continue
                return False
        return True

    # ---- combined filter, reference ordering ----

    def predicates(self, pod: Pod, node: Node) -> Dict[str, bool]:
        res = self.pod_fits_resources(pod, node)
        host = self.pod_fits_host(pod, node)
        ports = self.pod_fits_host_ports(pod, node)
        sel = self.pod_match_node_selector(pod, node)
        vols = self.max_volume_counts_full(pod, node)
        return {
            "CheckNodeCondition": self.check_node_condition(pod, node),
            "CheckNodeUnschedulable": self.check_node_unschedulable(pod, node),
            "GeneralPredicates": res and host and ports and sel,
            "PodFitsHost": host,
            "PodFitsHostPorts": ports,
            "PodMatchNodeSelector": sel,
            "PodFitsResources": res,
            "NoDiskConflict": self.no_disk_conflict(pod, node),
            "PodToleratesNodeTaints": self.pod_tolerates_node_taints(pod, node),
            "PodToleratesNodeNoExecuteTaints": self.pod_tolerates_node_taints(
                pod, node, effects=(TAINT_NO_EXECUTE,)
            ),
            "CheckNodeLabelPresence": True,
            "CheckServiceAffinity": self.check_service_affinity(pod, node),
            "MaxEBSVolumeCount": vols[0],
            "MaxGCEPDVolumeCount": vols[1],
            # the named CSI predicate folds the generic column and every
            # per-driver column
            "MaxCSIVolumeCount": (
                vols[VOL_CSI] and all(vols[NUM_VOL_TYPES:])
            ),
            "MaxAzureDiskVolumeCount": vols[3],
            "MaxCinderVolumeCount": vols[4],
            "CheckVolumeBinding": self.check_volume_binding(pod, node),
            "NoVolumeZoneConflict": self.no_volume_zone_conflict(pod, node),
            "CheckNodeMemoryPressure": self.check_node_memory_pressure(pod, node),
            "CheckNodePIDPressure": self.check_node_pid_pressure(pod, node),
            "CheckNodeDiskPressure": self.check_node_disk_pressure(pod, node),
            "MatchInterPodAffinity": self.match_inter_pod_affinity(pod, node),
        }

    def fits(self, pod: Pod, node: Node) -> bool:
        return all(self.predicates(pod, node).values())

    # ------------------------------------------------------------ priorities

    def _used_nonzero(self, node: Node) -> Tuple[float, float]:
        cpu = mem = 0.0
        for p in self.by_node[node.name]:
            c, m = nonzero_requests(p)
            cpu += c
            mem += m
        return cpu, mem

    @staticmethod
    def _least_score(requested: float, capacity: float) -> int:
        if capacity == 0 or requested > capacity:
            return 0
        return int((capacity - requested) * MAX_PRIORITY // capacity)

    @staticmethod
    def _most_score(requested: float, capacity: float) -> int:
        if capacity == 0 or requested > capacity:
            return 0
        return int(requested * MAX_PRIORITY // capacity)

    def least_requested(self, pod: Pod, node: Node) -> int:
        pc, pm = nonzero_requests(pod)
        uc, um = self._used_nonzero(node)
        alloc = node_allocatable(node)
        return (
            self._least_score(pc + uc, alloc.get(RESOURCE_CPU, 0.0))
            + self._least_score(pm + um, alloc.get(RESOURCE_MEMORY, 0.0))
        ) // 2

    def most_requested(self, pod: Pod, node: Node) -> int:
        pc, pm = nonzero_requests(pod)
        uc, um = self._used_nonzero(node)
        alloc = node_allocatable(node)
        return (
            self._most_score(pc + uc, alloc.get(RESOURCE_CPU, 0.0))
            + self._most_score(pm + um, alloc.get(RESOURCE_MEMORY, 0.0))
        ) // 2

    def balanced_allocation(self, pod: Pod, node: Node) -> int:
        pc, pm = nonzero_requests(pod)
        uc, um = self._used_nonzero(node)
        alloc = node_allocatable(node)
        ccap = alloc.get(RESOURCE_CPU, 0.0)
        mcap = alloc.get(RESOURCE_MEMORY, 0.0)
        if ccap == 0 or mcap == 0:
            return 0
        cf = (pc + uc) / ccap
        mf = (pm + um) / mcap
        if cf >= 1 or mf >= 1:
            return 0
        return int((1 - abs(cf - mf)) * MAX_PRIORITY)

    def node_affinity_counts(self, pod: Pod) -> Dict[str, int]:
        counts = {}
        aff = pod.spec.affinity
        na = aff.node_affinity if aff else None
        for node in self.nodes:
            c = 0
            if na:
                for pt in na.preferred:
                    term = pt.preference
                    # an unbuildable requirement voids the term (device
                    # encodes it as match-nothing; the Go map function
                    # would error the whole priority)
                    ok = all(
                        not klabels.requirement_is_unbuildable(
                            e.key, e.operator, e.values
                        )
                        and klabels.Requirement(
                            e.key, e.operator, tuple(e.values)
                        ).matches(node.labels)
                        for e in term.match_expressions
                    ) and bool(term.match_expressions)
                    if ok:
                        c += pt.weight
            counts[node.name] = c
        return counts

    def taint_tol_counts(self, pod: Pod) -> Dict[str, int]:
        counts = {}
        for node in self.nodes:
            c = 0
            for t in node.spec.taints:
                if t.effect == TAINT_PREFER_NO_SCHEDULE and not tolerations_tolerate(pod, t):
                    c += 1
            counts[node.name] = c
        return counts

    @staticmethod
    def _normalize(counts: Dict[str, int], reverse: bool) -> Dict[str, int]:
        maxc = max(counts.values()) if counts else 0
        if maxc == 0:
            return {k: (MAX_PRIORITY if reverse else 0) for k in counts}
        out = {}
        for k, v in counts.items():
            s = MAX_PRIORITY * v // maxc
            out[k] = MAX_PRIORITY - s if reverse else s
        return out

    def selector_spread(self, pod: Pod) -> Dict[str, int]:
        """ref priorities/selector_spreading.go CalculateSpreadPriorityMap/Reduce."""
        selectors = [
            klabels.selector_from_match_labels(sel)
            for ns, sel in self.services
            if ns == pod.namespace and klabels.selector_from_match_labels(sel).matches(pod.labels)
        ]
        counts: Dict[str, int] = {}
        for node in self.nodes:
            c = 0
            if selectors:
                for p in self.by_node[node.name]:
                    if p.namespace != pod.namespace:
                        continue
                    # countMatchingPods (selector_spreading.go:165-187): the
                    # existing pod counts once iff it matches ALL selectors
                    if all(sel.matches(p.labels) for sel in selectors):
                        c += 1
            counts[node.name] = c
        max_node = max(counts.values()) if counts else 0
        zone_counts: Dict[str, int] = defaultdict(int)
        have_zones = False
        for node in self.nodes:
            z = get_zone_key(node)
            if z is not None:
                have_zones = True
                zone_counts[z] += counts[node.name]
        max_zone = max(zone_counts.values()) if zone_counts else 0
        out = {}
        for node in self.nodes:
            if max_node > 0:
                f = MAX_PRIORITY * (max_node - counts[node.name]) / max_node
            else:
                f = MAX_PRIORITY
            z = get_zone_key(node)
            if have_zones and z is not None:
                if max_zone > 0:
                    zs = MAX_PRIORITY * (max_zone - zone_counts[z]) / max_zone
                else:
                    zs = MAX_PRIORITY
                f = (1 - ZONE_WEIGHTING) * f + ZONE_WEIGHTING * zs
            out[node.name] = int(f)
        return out

    @staticmethod
    def _normalized_image(name: str) -> str:
        """image_locality.go:99-109 normalizedImageName."""
        if name.rfind(":") <= name.rfind("/"):
            return name + ":latest"
        return name

    def image_locality(self, pod: Pod) -> Dict[str, int]:
        mb = 1024 * 1024
        min_t, max_t = 23 * mb, 1000 * mb
        total = max(len(self.nodes), 1)
        num_nodes: Dict[str, int] = defaultdict(int)
        for node in self.nodes:
            for img in node.status.images:
                for nm in img.names:  # every name keys the same state
                    num_nodes[nm] += 1
        out = {}
        for node in self.nodes:
            sizes = {}
            for img in node.status.images:
                for nm in img.names:
                    sizes[nm] = img.size_bytes
            s = 0
            for c in pod.spec.containers:
                key = self._normalized_image(c.image)
                if key in sizes:
                    s += int(sizes[key] * (num_nodes[key] / total))
            s = min(max(s, min_t), max_t)
            out[node.name] = int(MAX_PRIORITY * (s - min_t) // (max_t - min_t))
        return out

    def node_prefer_avoid(self, pod: Pod) -> Dict[str, int]:
        out = {}
        owner = pod.metadata.owner_uid
        applies = pod.metadata.owner_kind in ("ReplicationController", "ReplicaSet")
        for node in self.nodes:
            score = MAX_PRIORITY
            ann = node.metadata.annotations.get(
                "scheduler.alpha.kubernetes.io/preferAvoidPods"
            )
            if ann and applies and owner:
                try:
                    avoid = json.loads(ann)
                    for e in avoid.get("preferAvoidPods", []):
                        uid = e.get("podSignature", {}).get("podController", {}).get("uid", "")
                        if uid == owner:
                            score = 0
                except ValueError:
                    pass
            out[node.name] = score
        return out

    def inter_pod_affinity_score(self, pod: Pod, hard_weight: float = 1.0) -> Dict[str, int]:
        """ref priorities/interpod_affinity.go CalculateInterPodAffinityPriority."""
        sums: Dict[str, float] = {n.name: 0.0 for n in self.nodes}

        def bump(topo_key: str, anchor_node: Node, w: float):
            tv = _topo_value(anchor_node, topo_key)
            if tv is None:
                return
            for node in self.nodes:
                if _topo_value(node, topo_key) == tv:
                    sums[node.name] += w

        aff = pod.spec.affinity
        for other in self.pods:
            onode = self.node_by_name.get(other.spec.node_name)
            if onode is None:
                continue
            # incoming pod's preferred terms matching the existing pod
            if aff and aff.pod_affinity:
                for wt in aff.pod_affinity.preferred:
                    if _term_matches_pod(wt.term, pod, other):
                        bump(wt.term.topology_key, onode, float(wt.weight))
            if aff and aff.pod_anti_affinity:
                for wt in aff.pod_anti_affinity.preferred:
                    if _term_matches_pod(wt.term, pod, other):
                        bump(wt.term.topology_key, onode, -float(wt.weight))
            oaff = other.spec.affinity
            # existing pods' preferred terms matching the incoming pod
            if oaff and oaff.pod_affinity:
                for wt in oaff.pod_affinity.preferred:
                    if _term_matches_pod(wt.term, other, pod):
                        bump(wt.term.topology_key, onode, float(wt.weight))
                if hard_weight > 0:
                    for term in oaff.pod_affinity.required:
                        if _term_matches_pod(term, other, pod):
                            bump(term.topology_key, onode, hard_weight)
            if oaff and oaff.pod_anti_affinity:
                for wt in oaff.pod_anti_affinity.preferred:
                    if _term_matches_pod(wt.term, other, pod):
                        bump(wt.term.topology_key, onode, -float(wt.weight))
        mx = max(sums.values()) if sums else 0.0
        mn = min(sums.values()) if sums else 0.0
        out = {}
        for name, s in sums.items():
            if mx - mn > 0:
                out[name] = int(MAX_PRIORITY * (s - mn) / (mx - mn))
            else:
                out[name] = 0
        return out

    def node_label_priority(self, pod: Pod, label_prefs=()) -> Dict[str, float]:
        out = {}
        for node in self.nodes:
            s = 0.0
            for key, presence, weight in label_prefs:
                present = key in node.labels
                s += weight * (MAX_PRIORITY if present == bool(presence) else 0)
            out[node.name] = s
        return out

    def requested_to_capacity_ratio(
        self, pod: Pod, shape=((0.0, 10.0), (100.0, 0.0))
    ) -> Dict[str, int]:
        """priorities/requested_to_capacity_ratio.go piecewise-linear curve."""

        def curve(u: float) -> float:
            pts = list(shape)
            if u <= pts[0][0]:
                return pts[0][1]
            for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
                if u <= x1:
                    return y0 + (y1 - y0) * (u - x0) / (x1 - x0)
            return pts[-1][1]

        pc, pm = nonzero_requests(pod)
        out = {}
        for node in self.nodes:
            uc, um = self._used_nonzero(node)
            alloc = node_allocatable(node)
            ccap = alloc.get(RESOURCE_CPU, 0.0)
            mcap = alloc.get(RESOURCE_MEMORY, 0.0)
            cu = (pc + uc) * 100.0 / ccap if ccap > 0 else 100.0
            mu = (pm + um) * 100.0 / mcap if mcap > 0 else 100.0
            out[node.name] = int((curve(cu) + curve(mu)) // 2)
        return out

    def resource_limits(self, pod: Pod) -> Dict[str, int]:
        """priorities/resource_limits.go (feature-gated)."""
        lim_cpu = lim_mem = 0.0
        for c in pod.spec.containers:
            if RESOURCE_CPU in c.limits:
                lim_cpu += c.limits[RESOURCE_CPU].milli
            if RESOURCE_MEMORY in c.limits:
                lim_mem += float(c.limits[RESOURCE_MEMORY])
        out = {}
        for node in self.nodes:
            alloc = node_allocatable(node)
            ok = (lim_cpu == 0 or alloc.get(RESOURCE_CPU, 0.0) >= lim_cpu) and (
                lim_mem == 0 or alloc.get(RESOURCE_MEMORY, 0.0) >= lim_mem
            )
            out[node.name] = 1 if ok and (lim_cpu > 0 or lim_mem > 0) else 0
        return out

    def priorities(
        self, pod: Pod, label_prefs=(), rtc_shape=((0.0, 10.0), (100.0, 0.0))
    ) -> Dict[str, Dict[str, int]]:
        na = self._normalize(self.node_affinity_counts(pod), reverse=False)
        tt = self._normalize(self.taint_tol_counts(pod), reverse=True)
        out = {
            "SelectorSpreadPriority": self.selector_spread(pod),
            "InterPodAffinityPriority": self.inter_pod_affinity_score(pod),
            "LeastRequestedPriority": {
                n.name: self.least_requested(pod, n) for n in self.nodes
            },
            "BalancedResourceAllocation": {
                n.name: self.balanced_allocation(pod, n) for n in self.nodes
            },
            "NodePreferAvoidPodsPriority": self.node_prefer_avoid(pod),
            "NodeAffinityPriority": na,
            "TaintTolerationPriority": tt,
            "ImageLocalityPriority": self.image_locality(pod),
            "MostRequestedPriority": {
                n.name: self.most_requested(pod, n) for n in self.nodes
            },
            "NodeLabelPriority": self.node_label_priority(pod, label_prefs),
            "RequestedToCapacityRatioPriority": self.requested_to_capacity_ratio(
                pod, rtc_shape
            ),
            "ResourceLimitsPriority": self.resource_limits(pod),
        }
        return out

    def total_scores(self, pod: Pod, weights: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        from kubernetes_tpu_torch.codec.schema import DEFAULT_PRIORITY_WEIGHTS, PRIORITY_ORDER

        if weights is None:
            weights = dict(zip(PRIORITY_ORDER, DEFAULT_PRIORITY_WEIGHTS))
        per = self.priorities(pod)
        totals: Dict[str, float] = defaultdict(float)
        for pname, scores in per.items():
            for node, s in scores.items():
                totals[node] += s * weights.get(pname, 1.0)
        return dict(totals)

    # ------------------------------------------------------------ preemption

    def _clone_without(self, removed) -> "CPUScheduler":
        """A what-if copy with a victim set removed (nodeInfoCopy +
        meta.RemovePod analog: the clone re-derives ALL state, so ports,
        disk volumes, volume counts, and affinity pair maps reflect the
        removal)."""
        return CPUScheduler(
            self.nodes,
            [p for p in self.pods if (p.namespace, p.name) not in removed],
            self.services,
            self.max_vols,
            list(self.pvs.values()),
            list(self.pvcs.values()),
            list(self.storage_classes.values()),
            service_affinity_labels=self.service_affinity_labels,
        )

    def _fits_minus(self, pod: Pod, node: Node, removed) -> bool:
        """podFitsOnNode with a victim set removed: the full predicate set
        (selectVictimsOnNode re-runs every predicate, not just resources)."""
        return self._clone_without(removed).fits(pod, node)

    @staticmethod
    def _pdb_violating(pod: Pod, pdbs) -> bool:
        """filterPodsWithPDBViolation: evicting `pod` violates a PDB if any
        matching PDB has disruptionsAllowed <= 0."""
        return any(pdb.matches(pod) and pdb.disruptions_allowed <= 0 for pdb in pdbs)

    def select_victims_on_node(self, pod: Pod, node: Node, pdbs=()):
        """selectVictimsOnNode (generic_scheduler.go:1054-1128): evict all
        lower-priority pods, then reprieve — PDB-violating victims first,
        then non-violating, highest priority first (ties: earliest start) —
        while the preemptor still fits.  Returns (victim key set,
        num PDB violations) or (None, 0) if impossible."""
        potential = [
            p
            for p in self.by_node[node.name]
            if p.spec.priority < pod.spec.priority
        ]
        removed = {(p.namespace, p.name) for p in potential}
        if not self._fits_minus(pod, node, removed):
            return None, 0
        # MoreImportantPod order: priority desc, then earlier start
        order = sorted(
            potential, key=lambda q: (-q.spec.priority, q.status.start_time)
        )
        violating = [p for p in order if self._pdb_violating(p, pdbs)]
        non_violating = [p for p in order if not self._pdb_violating(p, pdbs)]
        n_viol = 0
        for group, count_violations in ((violating, True), (non_violating, False)):
            for p in group:
                key = (p.namespace, p.name)
                removed.discard(key)
                if not self._fits_minus(pod, node, removed):
                    removed.add(key)
                    if count_violations:
                        n_viol += 1
        return removed, n_viol

    # ErrPodAffinityRulesNotMatch analog: required affinity rules alone
    def _affinity_rules_ok(self, pod: Pod, node: Node) -> bool:
        aff = pod.spec.affinity
        pa = aff.pod_affinity if aff else None
        if pa is None or not pa.required:
            return True
        for term in pa.required:
            matches_somewhere = False
            domain_ok = False
            tval = _topo_value(node, term.topology_key)
            for p in self.pods:
                if not p.spec.node_name:
                    continue
                if _term_matches_pod(term, pod, p):
                    matches_somewhere = True
                    pnode = self.node_by_name.get(p.spec.node_name)
                    if (
                        tval is not None
                        and _topo_value(pnode, term.topology_key) == tval
                    ):
                        domain_ok = True
            if not domain_ok:
                # first-pod bootstrap: no matching pod anywhere and the term
                # matches the incoming pod itself on a node carrying the key
                if not (
                    not matches_somewhere
                    and _term_matches_pod(term, pod, pod)
                    and tval is not None
                ):
                    return False
        return True

    UNRESOLVABLE = (
        "CheckNodeCondition", "CheckNodeUnschedulable", "PodFitsHost",
        "PodMatchNodeSelector", "PodToleratesNodeTaints",
        "PodToleratesNodeNoExecuteTaints", "CheckNodeLabelPresence",
        "CheckNodeMemoryPressure", "CheckNodePIDPressure",
        "CheckNodeDiskPressure", "NoVolumeZoneConflict", "CheckVolumeBinding",
    )

    def preempt(self, pod: Pod, pdbs=()):
        """Preempt (:310-369) + pickOneNodeForPreemption criteria 1-6
        (generic_scheduler.go:837-962)."""
        best = None
        for i, node in enumerate(self.nodes):
            preds = self.predicates(pod, node)
            if all(preds.values()):
                continue
            # nodesWherePreemptionMightHelp: no unresolvable failure
            if not all(preds[p] for p in self.UNRESOLVABLE if p in preds):
                continue
            if not self._affinity_rules_ok(pod, node):
                continue
            victims, n_viol = self.select_victims_on_node(pod, node, pdbs)
            if victims is None:
                continue
            vic_pods = [
                p for p in self.by_node[node.name] if (p.namespace, p.name) in victims
            ]
            max_p = max((p.spec.priority for p in vic_pods), default=-(2**31))
            sum_p = sum(p.spec.priority + 2**31 for p in vic_pods)
            top = [p for p in vic_pods if p.spec.priority == max_p]
            earliest_top = min(
                (p.status.start_time for p in top), default=float("inf")
            )
            # criteria: min violations, min max prio, min sum, min count,
            # LATEST earliest-start (negate), first index
            key = (n_viol, max_p, sum_p, len(vic_pods), -earliest_top, i)
            if best is None or key < best[0]:
                best = (key, node.name, victims, n_viol)
        if best is None:
            return None, set()
        return best[1], best[2]

    # ------------------------------------------------------------- schedule

    def schedule(self, pod: Pod, last_index: int = 0) -> Tuple[Optional[str], int]:
        """Full schedule cycle: filter + score + selectHost round-robin
        (generic_scheduler.go:184-296).  Returns (node name or None, ties)."""
        feasible = [n for n in self.nodes if self.fits(pod, n)]
        if not feasible:
            return None, 0
        totals = self.total_scores(pod)
        best = max(totals[n.name] for n in feasible)
        ties = [n.name for n in feasible if totals[n.name] == best]
        return ties[last_index % len(ties)], len(ties)


def run_predicates(pod: Pod, nodes, pods=(), services=()) -> Dict[str, Dict[str, bool]]:
    s = CPUScheduler(nodes, pods, services)
    return {n.name: s.predicates(pod, n) for n in nodes}


def run_priorities(pod: Pod, nodes, pods=(), services=()) -> Dict[str, Dict[str, int]]:
    return CPUScheduler(nodes, pods, services).priorities(pod)
