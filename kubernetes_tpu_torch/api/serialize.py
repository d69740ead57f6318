"""Wire serializers: Pod and Node objects -> Kubernetes JSON dicts.

The port's copy of the pod and node half of the JAX package's
api/serialize.py: the inverse of the from_dict codecs in api/types.py,
shaped like the v1 wire format (staging/src/k8s.io/api/core/v1/types.go
JSON tags) so `Pod.from_dict(pod_to_dict(p))` round-trips every field the
model carries.  loop.py's extender drivers send the bench objects over the
extender seam's sync endpoints in this form.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import (
    Affinity,
    Container,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorTerm,
    PodAffinity,
    Pod,
)


def _drop_empty(d: dict) -> dict:
    return {k: v for k, v in d.items() if v not in (None, "", {}, [], ())}


def meta_to_dict(m) -> dict:
    out = {
        "name": m.name,
        "namespace": m.namespace,
        "labels": dict(m.labels),
        "annotations": dict(m.annotations),
        "uid": m.uid,
    }
    if m.owner_uid:
        out["ownerReferences"] = [
            {"kind": m.owner_kind, "uid": m.owner_uid, "controller": True}
        ]
    if m.deletion_timestamp is not None:
        out["deletionTimestamp"] = m.deletion_timestamp
    if m.finalizers:
        out["finalizers"] = list(m.finalizers)
    return _drop_empty(out)


def _container_to_dict(c: Container) -> dict:
    return _drop_empty({
        "name": c.name,
        "image": c.image,
        "resources": _drop_empty({
            "requests": {k: str(q) for k, q in c.requests.items()},
            "limits": {k: str(q) for k, q in c.limits.items()},
        }),
        "ports": [
            _drop_empty({
                "hostPort": p.host_port,
                "containerPort": p.container_port,
                "protocol": p.protocol,
                "hostIP": p.host_ip,
            })
            for p in c.ports
        ],
    })


def _nst_to_dict(t: NodeSelectorTerm) -> dict:
    return _drop_empty({
        "matchExpressions": [
            _drop_empty({"key": e.key, "operator": e.operator,
                         "values": list(e.values)})
            for e in t.match_expressions
        ],
        "matchFields": [
            _drop_empty({"key": e.key, "operator": e.operator,
                         "values": list(e.values)})
            for e in t.match_fields
        ],
    })


def _node_affinity_to_dict(na: NodeAffinity) -> dict:
    out = {}
    if na.required is not None:
        out["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": [_nst_to_dict(t) for t in na.required.terms]
        }
    if na.preferred:
        out["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": p.weight, "preference": _nst_to_dict(p.preference)}
            for p in na.preferred
        ]
    return out


def _pod_affinity_to_dict(pa: PodAffinity) -> dict:
    def term(t):
        return _drop_empty({
            "labelSelector": t.label_selector,
            "topologyKey": t.topology_key,
            "namespaces": list(t.namespaces),
        })

    out = {}
    if pa.required:
        out["requiredDuringSchedulingIgnoredDuringExecution"] = [
            term(t) for t in pa.required
        ]
    if pa.preferred:
        out["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": w.weight, "podAffinityTerm": term(w.term)}
            for w in pa.preferred
        ]
    return out


def _affinity_to_dict(a: Optional[Affinity]) -> Optional[dict]:
    if a is None:
        return None
    out = {}
    if a.node_affinity is not None:
        out["nodeAffinity"] = _node_affinity_to_dict(a.node_affinity)
    if a.pod_affinity is not None:
        out["podAffinity"] = _pod_affinity_to_dict(a.pod_affinity)
    if a.pod_anti_affinity is not None:
        out["podAntiAffinity"] = _pod_affinity_to_dict(a.pod_anti_affinity)
    return out or None


def pod_to_dict(pod: Pod) -> dict:
    spec = _drop_empty({
        "nodeName": pod.spec.node_name,
        "nodeSelector": dict(pod.spec.node_selector),
        "affinity": _affinity_to_dict(pod.spec.affinity),
        "tolerations": [
            _drop_empty({
                "key": t.key, "operator": t.operator,
                "value": t.value, "effect": t.effect,
            })
            for t in pod.spec.tolerations
        ],
        "containers": [_container_to_dict(c) for c in pod.spec.containers],
        "initContainers": [
            _container_to_dict(c) for c in pod.spec.init_containers
        ],
        "priority": pod.spec.priority,
        "volumes": [dict(v) for v in pod.spec.volumes],
        "serviceAccountName": pod.spec.service_account_name,
    })
    spec["schedulerName"] = pod.spec.scheduler_name
    return {
        "kind": "Pod",
        "apiVersion": "v1",
        "metadata": meta_to_dict(pod.metadata),
        "spec": spec,
        "status": _drop_empty({
            "phase": pod.status.phase,
            "reason": pod.status.reason or None,
            "message": pod.status.message or None,
            "startTime": pod.status.start_time or None,
            "nominatedNodeName": pod.status.nominated_node_name,
            "conditions": (
                [{"type": "Ready", "status": "False"}]
                if not pod.status.ready else None
            ),
            "containerStatuses": (
                [{"restartCount": pod.status.restart_count}]
                if pod.status.restart_count else None
            ),
        }),
    }


def node_to_dict(node: Node) -> dict:
    return {
        "kind": "Node",
        "apiVersion": "v1",
        "metadata": meta_to_dict(node.metadata),
        "spec": _drop_empty({
            "unschedulable": node.spec.unschedulable or None,
            "podCIDR": node.spec.pod_cidr,
            "taints": [
                _drop_empty({"key": t.key, "value": t.value,
                             "effect": t.effect})
                for t in node.spec.taints
            ],
        }),
        "status": _drop_empty({
            "allocatable": {
                k: str(q) for k, q in node.status.allocatable.items()
            },
            "capacity": {k: str(q) for k, q in node.status.capacity.items()},
            "images": [
                {"names": list(i.names), "sizeBytes": i.size_bytes}
                for i in node.status.images
            ],
            "conditions": [
                {"type": k, "status": v}
                for k, v in sorted(node.status.conditions.items())
            ],
            "volumesAttached": [
                {"name": n, "devicePath": ""}
                for n in node.status.volumes_attached
            ],
        }),
    }
