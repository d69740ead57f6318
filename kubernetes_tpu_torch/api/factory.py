"""Object factories: build well-formed Node/Pod objects from the small
set of knobs the scheduler cares about.

The package-level analog of the reference's fixture helpers
(pkg/scheduler/algorithm/predicates/testing_helper.go, test/utils/runners.go
node/pod strategies) — shared by the test suite, bench.py, and the
sustained-density harness.  Memory values are Mi-granular so float32
device math stays exact for score parity.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Node, Pod

ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
REGION_KEY = "failure-domain.beta.kubernetes.io/region"
HOSTNAME_KEY = "kubernetes.io/hostname"


def make_node(
    name: str,
    cpu: str = "4",
    mem: str = "8Gi",
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    taints: Sequence[dict] = (),
    unschedulable: bool = False,
    conditions: Sequence[dict] = (),
    images: Sequence[dict] = (),
    annotations: Optional[Dict[str, str]] = None,
    allocatable_extra: Optional[Dict[str, str]] = None,
) -> Node:
    lab = {HOSTNAME_KEY: name}
    lab.update(labels or {})
    return Node.from_dict(
        {
            "metadata": {"name": name, "labels": lab, "annotations": annotations or {}},
            "spec": {"unschedulable": unschedulable, "taints": list(taints)},
            "status": {
                "allocatable": {
                    "cpu": cpu, "memory": mem, "pods": pods,
                    **(allocatable_extra or {}),
                },
                "conditions": list(conditions) or [{"type": "Ready", "status": "True"}],
                "images": list(images),
            },
        }
    )


def make_pod(
    name: str,
    namespace: str = "default",
    cpu: Optional[str] = None,
    mem: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    node_name: str = "",
    node_selector: Optional[Dict[str, str]] = None,
    tolerations: Sequence[dict] = (),
    affinity: Optional[dict] = None,
    ports: Sequence[dict] = (),
    priority: int = 0,
    images: Sequence[str] = (),
    owner: Optional[Tuple[str, str]] = None,  # (kind, uid)
    volumes: Sequence[dict] = (),
    requests: Optional[Dict[str, str]] = None,  # full request dict (extended
                                                # resources, ephemeral-storage…)
    limits: Optional[Dict[str, str]] = None,    # container limits dict
    init_requests: Sequence[Dict[str, str]] = (),  # one init container each
    extra_containers: Sequence[Dict[str, str]] = (),  # request dict each
    annotations: Optional[Dict[str, str]] = None,
) -> Pod:
    req = dict(requests or {})
    if cpu is not None:
        req["cpu"] = cpu
    if mem is not None:
        req["memory"] = mem
    resources: dict = {}
    if req:
        resources["requests"] = req
    if limits:
        resources["limits"] = dict(limits)
    containers = [
        {
            "name": "c0",
            "image": images[0] if images else "",
            "resources": resources,
            "ports": list(ports),
        }
    ]
    for i, img in enumerate(images[1:], 1):
        containers.append({"name": f"c{i}", "image": img})
    for i, r in enumerate(extra_containers):
        containers.append(
            {"name": f"x{i}", "image": "", "resources": {"requests": dict(r)}}
        )
    init_containers = [
        {"name": f"i{i}", "image": "", "resources": {"requests": dict(r)}}
        for i, r in enumerate(init_requests)
    ]
    meta: dict = {"name": name, "namespace": namespace, "labels": labels or {}}
    if annotations:
        meta["annotations"] = dict(annotations)
    if owner:
        meta["ownerReferences"] = [
            {"kind": owner[0], "uid": owner[1], "controller": True}
        ]
    return Pod.from_dict(
        {
            "metadata": meta,
            "spec": {
                "nodeName": node_name,
                "nodeSelector": node_selector or {},
                "tolerations": list(tolerations),
                "affinity": affinity,
                "containers": containers,
                "initContainers": init_containers,
                "priority": priority,
                "volumes": list(volumes),
            },
        }
    )


# ------------------------------------------------------- randomized clusters

