"""The scheduler-relevant slice of the Kubernetes object model.

Reference: staging/src/k8s.io/api/core/v1/types.go (Pod, Node, Affinity,
Taint/Toleration, ContainerPort, ...).  Modeled as plain dataclasses with
`from_dict` codecs that accept the familiar JSON/YAML wire shapes, so test
fixtures read like the reference's table-driven tests.

Only fields the scheduling pipeline consumes are present; adding more is a
matter of widening these dataclasses (no generated deepcopy machinery needed —
Python values are immutable-by-convention here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from kubernetes_tpu_torch.api.resource import Quantity, parse_quantity

# Taint effects (ref core/v1/types.go TaintEffect)
TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

# Toleration operators (ref core/v1/types.go TolerationOperator)
TOLERATION_OP_EQUAL = "Equal"
TOLERATION_OP_EXISTS = "Exists"

# Resource names the scheduler cares about (ref core/v1/types.go ResourceName,
# scheduler nodeinfo.Resource pkg/scheduler/nodeinfo/node_info.go:139-148)
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"

# Non-zero defaults used by scoring when a pod declares no request
# (ref pkg/scheduler/util/non_zero.go:28-32)
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def is_best_effort(pod: "Pod") -> bool:
    """QoS BestEffort: no container requests or limits (qos.GetPodQOS
    slice — the class CheckNodeMemoryPressure repels and the kubelet
    eviction manager ranks first)."""
    return all(not c.requests and not c.limits for c in pod.spec.containers)


def qos_class(pod: "Pod") -> str:
    """GetPodQOS (pkg/apis/core/v1/helper/qos/qos.go:37-95): Guaranteed =
    every container has limits == requests for cpu+memory; BestEffort = no
    requests/limits anywhere; Burstable = the rest."""
    if is_best_effort(pod):
        return "BestEffort"
    # only the supported compute resources participate (qos.go
    # supportedQoSComputeResources = {cpu, memory}): an extended-resource
    # request must not demote a pod out of Guaranteed
    for c in pod.spec.containers:
        for res in ("cpu", "memory"):
            if res not in c.limits:
                return "Burstable"
            if res in c.requests and c.requests[res] != c.limits[res]:
                return "Burstable"
    return "Guaranteed"


def parse_time(v) -> Optional[float]:
    """Timestamp codec: the Kubernetes wire format serializes times as
    RFC3339 strings (metav1.Time); tests and internal callers may pass epoch
    seconds directly.  Returns epoch seconds or None."""
    if v is None or v == "":
        return None
    if isinstance(v, (int, float)):
        return float(v)
    from datetime import datetime, timezone

    s = str(v)
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(s)
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = ""
    owner_uid: str = ""   # flattened controller ownerReference UID
    owner_kind: str = ""  # its kind (ReplicationController / ReplicaSet / ...)
    # epoch seconds when a graceful delete began, None if not deleting
    # (ref metav1.ObjectMeta.DeletionTimestamp; consulted by
    # podEligibleToPreemptOthers, generic_scheduler.go:1159-1180)
    deletion_timestamp: Optional[float] = None
    # deletion is deferred until every finalizer is removed
    # (ref metav1.ObjectMeta.Finalizers; store semantics in
    # runtime/cluster.py delete/update)
    finalizers: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ObjectMeta":
        d = d or {}
        owner_uid = ""
        owner_kind = ""
        for ref in d.get("ownerReferences") or []:
            if ref.get("controller"):
                owner_uid = ref.get("uid", "")
                owner_kind = ref.get("kind", "")
        return ObjectMeta(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            uid=d.get("uid", ""),
            owner_uid=owner_uid,
            owner_kind=owner_kind,
            deletion_timestamp=parse_time(d.get("deletionTimestamp")),
            finalizers=tuple(d.get("finalizers") or ()),
        )


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE

    @staticmethod
    def from_dict(d: dict) -> "Taint":
        return Taint(d["key"], d.get("value", ""), d.get("effect", TAINT_NO_SCHEDULE))


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        """ref staging/src/k8s.io/api/core/v1/toleration.go ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        # Equal (or empty ≡ Equal)
        return self.value == taint.value

    @staticmethod
    def from_dict(d: dict) -> "Toleration":
        return Toleration(
            key=d.get("key", ""),
            operator=d.get("operator", TOLERATION_OP_EQUAL),
            value=d.get("value", ""),
            effect=d.get("effect", ""),
        )


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "NodeSelectorRequirement":
        return NodeSelectorRequirement(
            d["key"], d["operator"], tuple(d.get("values") or ())
        )

    def to_dict(self) -> dict:
        out = {"key": self.key, "operator": self.operator}
        if self.values:
            out["values"] = list(self.values)
        return out


@dataclass(frozen=True)
class NodeSelectorTerm:
    match_expressions: Tuple[NodeSelectorRequirement, ...] = ()
    match_fields: Tuple[NodeSelectorRequirement, ...] = ()  # metadata.name only

    @staticmethod
    def from_dict(d: dict) -> "NodeSelectorTerm":
        return NodeSelectorTerm(
            tuple(
                NodeSelectorRequirement.from_dict(e)
                for e in d.get("matchExpressions") or ()
            ),
            tuple(
                NodeSelectorRequirement.from_dict(e)
                for e in d.get("matchFields") or ()
            ),
        )

    def to_dict(self) -> dict:
        out: dict = {}
        if self.match_expressions:
            out["matchExpressions"] = [
                e.to_dict() for e in self.match_expressions
            ]
        if self.match_fields:
            out["matchFields"] = [e.to_dict() for e in self.match_fields]
        return out


@dataclass(frozen=True)
class NodeSelector:
    """OR of terms; each term is an AND of expressions
    (ref core/v1/types.go NodeSelector)."""

    terms: Tuple[NodeSelectorTerm, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "NodeSelector":
        return NodeSelector(
            tuple(NodeSelectorTerm.from_dict(t) for t in d.get("nodeSelectorTerms") or ())
        )

    def to_dict(self) -> dict:
        return {"nodeSelectorTerms": [t.to_dict() for t in self.terms]}


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm

    @staticmethod
    def from_dict(d: dict) -> "PreferredSchedulingTerm":
        return PreferredSchedulingTerm(
            int(d["weight"]), NodeSelectorTerm.from_dict(d["preference"])
        )


@dataclass(frozen=True)
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: Tuple[PreferredSchedulingTerm, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "NodeAffinity":
        req = d.get("requiredDuringSchedulingIgnoredDuringExecution")
        return NodeAffinity(
            required=NodeSelector.from_dict(req) if req is not None else None,
            preferred=tuple(
                PreferredSchedulingTerm.from_dict(t)
                for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or ()
            ),
        )


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: Optional[dict]  # raw metav1.LabelSelector dict
    topology_key: str
    namespaces: Tuple[str, ...] = ()  # empty => the pod's own namespace

    @staticmethod
    def from_dict(d: dict) -> "PodAffinityTerm":
        return PodAffinityTerm(
            label_selector=d.get("labelSelector"),
            topology_key=d.get("topologyKey", ""),
            namespaces=tuple(d.get("namespaces") or ()),
        )


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm

    @staticmethod
    def from_dict(d: dict) -> "WeightedPodAffinityTerm":
        return WeightedPodAffinityTerm(
            int(d["weight"]), PodAffinityTerm.from_dict(d["podAffinityTerm"])
        )


@dataclass(frozen=True)
class PodAffinity:
    required: Tuple[PodAffinityTerm, ...] = ()
    preferred: Tuple[WeightedPodAffinityTerm, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "PodAffinity":
        return PodAffinity(
            required=tuple(
                PodAffinityTerm.from_dict(t)
                for t in d.get("requiredDuringSchedulingIgnoredDuringExecution") or ()
            ),
            preferred=tuple(
                WeightedPodAffinityTerm.from_dict(t)
                for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or ()
            ),
        )


PodAntiAffinity = PodAffinity  # same shape


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["Affinity"]:
        if not d:
            return None
        return Affinity(
            node_affinity=NodeAffinity.from_dict(d["nodeAffinity"])
            if d.get("nodeAffinity")
            else None,
            pod_affinity=PodAffinity.from_dict(d["podAffinity"])
            if d.get("podAffinity")
            else None,
            pod_anti_affinity=PodAffinity.from_dict(d["podAntiAffinity"])
            if d.get("podAntiAffinity")
            else None,
        )


@dataclass(frozen=True)
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""

    @staticmethod
    def from_dict(d: dict) -> "ContainerPort":
        return ContainerPort(
            host_port=int(d.get("hostPort", 0)),
            container_port=int(d.get("containerPort", 0)),
            protocol=d.get("protocol", "TCP"),
            host_ip=d.get("hostIP", ""),
        )


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: Dict[str, Quantity] = field(default_factory=dict)
    limits: Dict[str, Quantity] = field(default_factory=dict)
    ports: Tuple[ContainerPort, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "Container":
        res = d.get("resources") or {}
        return Container(
            name=d.get("name", ""),
            image=d.get("image", ""),
            requests={
                k: parse_quantity(v) for k, v in (res.get("requests") or {}).items()
            },
            limits={
                k: parse_quantity(v) for k, v in (res.get("limits") or {}).items()
            },
            ports=tuple(ContainerPort.from_dict(p) for p in d.get("ports") or ()),
        )


@dataclass
class PodSpec:
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: Tuple[Toleration, ...] = ()
    containers: Tuple[Container, ...] = ()
    init_containers: Tuple[Container, ...] = ()
    priority: int = 0
    scheduler_name: str = "default-scheduler"
    volumes: Tuple[dict, ...] = ()  # raw volume dicts (gcePersistentDisk, ...)
    service_account_name: str = ""  # injected by ServiceAccount admission

    @staticmethod
    def from_dict(d: Optional[dict]) -> "PodSpec":
        d = d or {}
        return PodSpec(
            node_name=d.get("nodeName", ""),
            node_selector=dict(d.get("nodeSelector") or {}),
            affinity=Affinity.from_dict(d.get("affinity")),
            tolerations=tuple(
                Toleration.from_dict(t) for t in d.get("tolerations") or ()
            ),
            containers=tuple(Container.from_dict(c) for c in d.get("containers") or ()),
            init_containers=tuple(
                Container.from_dict(c) for c in d.get("initContainers") or ()
            ),
            priority=int(d.get("priority") or 0),
            scheduler_name=d.get("schedulerName", "default-scheduler"),
            volumes=tuple(d.get("volumes") or ()),
            service_account_name=d.get("serviceAccountName", ""),
        )


@dataclass
class PodStatus:
    phase: str = "Pending"
    # epoch seconds the pod started running; 0 = unknown (ref v1.PodStatus
    # .StartTime, consumed by pickOneNodeForPreemption criterion 5 via
    # util.GetEarliestPodStartTime)
    start_time: float = 0.0
    # node name this pod preempted victims on and expects to land on
    # (ref v1.PodStatus.NominatedNodeName, scheduler.go:310-312)
    nominated_node_name: str = ""
    # aggregate readiness (the Ready condition; endpoints only route to
    # ready pods — pkg/controller/endpoint includes a pod iff
    # podutil.IsPodReady)
    ready: bool = True
    # total container restarts (statusManager; incremented by the kubelet
    # when a liveness probe fails and the container is recreated)
    restart_count: int = 0
    # terminal-phase attribution (ref v1.PodStatus.Reason/Message, e.g.
    # UnexpectedAdmissionError when kubelet admission rejects the pod)
    reason: str = ""
    message: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def labels(self) -> Dict[str, str]:
        return self.metadata.labels

    def resource_request(self) -> Dict[str, Quantity]:
        """Effective request: max(sum(containers), max(initContainers)) per
        resource — ref pkg/scheduler/nodeinfo/util.go / predicates
        GetResourceRequest (predicates.go:744-762)."""
        total: Dict[str, Quantity] = {}
        for c in self.spec.containers:
            for k, q in c.requests.items():
                total[k] = total.get(k, Quantity(0)) + q  # type: ignore[arg-type]
        for c in self.spec.init_containers:
            for k, q in c.requests.items():
                if k not in total or total[k] < q:
                    total[k] = q
        return total

    def host_ports(self) -> List[ContainerPort]:
        return [
            p for c in self.spec.containers for p in c.ports if p.host_port > 0
        ]

    @staticmethod
    def from_dict(d: dict) -> "Pod":
        st = d.get("status") or {}
        return Pod(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=PodSpec.from_dict(d.get("spec")),
            status=PodStatus(
                phase=st.get("phase", "Pending"),
                start_time=parse_time(st.get("startTime")) or 0.0,
                nominated_node_name=st.get("nominatedNodeName", ""),
                ready=not any(
                    c.get("type") == "Ready" and c.get("status") == "False"
                    for c in st.get("conditions") or []
                ),
                restart_count=sum(
                    int(cs.get("restartCount", 0))
                    for cs in st.get("containerStatuses") or []
                ),
                reason=st.get("reason", ""),
                message=st.get("message", ""),
            ),
        )


@dataclass
class PodDisruptionBudget:
    """The preemption-relevant slice of policy/v1beta1 PodDisruptionBudget
    (ref staging/src/k8s.io/api/policy/v1beta1/types.go): a label selector
    over pods plus the controller-maintained disruptions-allowed count.
    Preemption groups victims by whether evicting them would violate a PDB
    (generic_scheduler.go filterPodsWithPDBViolation: a pod is violating if
    ANY matching PDB has PodDisruptionsAllowed <= 0)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[dict] = None  # raw metav1.LabelSelector dict
    disruptions_allowed: int = 0     # status.disruptionsAllowed
    # spec.minAvailable / spec.maxUnavailable: int or percent string
    # ("50%"); at most one set (validation).  The disruption controller
    # derives disruptions_allowed from these.
    min_available: object = None
    max_unavailable: object = None

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def matches(self, pod: "Pod") -> bool:
        if pod.namespace != self.metadata.namespace or self.selector is None:
            return False
        for k, v in (self.selector.get("matchLabels") or {}).items():
            if pod.labels.get(k) != v:
                return False
        for e in self.selector.get("matchExpressions") or ():
            op, key, vals = e.get("operator"), e.get("key"), e.get("values") or ()
            has = key in pod.labels
            if op == "In" and not (has and pod.labels[key] in vals):
                return False
            if op == "NotIn" and has and pod.labels[key] in vals:
                return False
            if op == "Exists" and not has:
                return False
            if op == "DoesNotExist" and has:
                return False
        return True

    @staticmethod
    def from_dict(d: dict) -> "PodDisruptionBudget":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return PodDisruptionBudget(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            selector=spec.get("selector"),
            disruptions_allowed=int(
                status.get("disruptionsAllowed", status.get("PodDisruptionsAllowed", 0))
            ),
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
        )


@dataclass(frozen=True)
class ContainerImage:
    names: Tuple[str, ...] = ()
    size_bytes: int = 0

    @staticmethod
    def from_dict(d: dict) -> "ContainerImage":
        return ContainerImage(tuple(d.get("names") or ()), int(d.get("sizeBytes", 0)))


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: Tuple[Taint, ...] = ()
    pod_cidr: str = ""   # assigned by the nodeipam controller

    @staticmethod
    def from_dict(d: Optional[dict]) -> "NodeSpec":
        d = d or {}
        return NodeSpec(
            unschedulable=bool(d.get("unschedulable", False)),
            taints=tuple(Taint.from_dict(t) for t in d.get("taints") or ()),
            pod_cidr=d.get("podCIDR", ""),
        )


@dataclass
class NodeStatus:
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    images: Tuple[ContainerImage, ...] = ()
    # condition type -> status ("True"/"False"/"Unknown"), e.g. {"Ready": "True"}
    conditions: Dict[str, str] = field(default_factory=dict)
    # PV names attached to this node (status.volumesAttached[].name,
    # maintained by the attach-detach controller)
    volumes_attached: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "NodeStatus":
        d = d or {}
        # allocatable defaults to capacity when absent (the kubelet computes
        # allocatable = capacity - reserved; a registration that reports
        # only capacity means "nothing reserved" — v1.NodeStatus semantics)
        alloc = d.get("allocatable") or d.get("capacity") or {}
        return NodeStatus(
            allocatable={k: parse_quantity(v) for k, v in alloc.items()},
            capacity={
                k: parse_quantity(v) for k, v in (d.get("capacity") or {}).items()
            },
            images=tuple(ContainerImage.from_dict(i) for i in d.get("images") or ()),
            conditions={
                c["type"]: c["status"] for c in d.get("conditions") or []
            },
            volumes_attached=tuple(
                v.get("name", "") for v in d.get("volumesAttached") or ()
            ),
        )


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def labels(self) -> Dict[str, str]:
        return self.metadata.labels

    @staticmethod
    def from_dict(d: dict) -> "Node":
        return Node(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=NodeSpec.from_dict(d.get("spec")),
            status=NodeStatus.from_dict(d.get("status")),
        )
