"""Storage object model: PV / PVC / StorageClass (scheduler-relevant slice).

Reference: staging/src/k8s.io/api/core/v1/types.go (PersistentVolume,
PersistentVolumeClaim) and storage/v1 StorageClass.  The scheduler consumes:
  * PVC -> bound PV (spec.volumeName) or its storageClassName for binding;
  * PV zone/region labels (NoVolumeZoneConflict, predicates.go:616-741);
  * PV spec.nodeAffinity.required (CheckVolumeBinding via the volume binder);
  * the PV's source type (MaxVolumeCount filters, csi for MaxCSIVolumeCount);
  * StorageClass.volumeBindingMode: Immediate vs WaitForFirstConsumer
    (delayed binding — the scheduler picks the node first).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.api.resource import Quantity, parse_quantity
from kubernetes_tpu_torch.api.types import NodeSelector, ObjectMeta

IMMEDIATE = "Immediate"
WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# volume source kinds the filters care about
SRC_EBS = "awsElasticBlockStore"
SRC_GCE = "gcePersistentDisk"
SRC_AZURE = "azureDisk"
SRC_CINDER = "cinder"
SRC_CSI = "csi"

# which spec field carries each source kind's volume identity
_SRC_ID_FIELD = {
    SRC_EBS: "volumeID", SRC_GCE: "pdName", SRC_AZURE: "diskName",
    SRC_CINDER: "volumeID", SRC_CSI: "volumeHandle",
}


def _storage_meta(meta: "ObjectMeta", namespaced: bool) -> dict:
    out = {"name": meta.name, "labels": dict(meta.labels)}
    if namespaced:
        out["namespace"] = meta.namespace
    if meta.deletion_timestamp is not None:
        out["deletionTimestamp"] = meta.deletion_timestamp
    if meta.finalizers:
        out["finalizers"] = list(meta.finalizers)
    return out


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: Optional[Quantity] = None
    access_modes: Tuple[str, ...] = ()
    storage_class: str = ""
    node_affinity: Optional[NodeSelector] = None  # spec.nodeAffinity.required
    source_kind: str = ""                          # SRC_* ("" unknown)
    csi_driver: str = ""
    # the underlying volume identity (EBS volumeID / GCE pdName / Azure
    # diskName / Cinder volumeID / CSI volumeHandle): attach-count dedup
    # keys by THIS, so a PV and a direct volume over the same disk (or two
    # PVs over one disk) count once (filterVolumes FilterPersistentVolume)
    source_id: str = ""
    phase: str = "Available"                       # Available | Bound | ...
    claim_ref: str = ""                            # "ns/name" of bound PVC
    # persistentVolumeReclaimPolicy: Retain | Delete (Recycle deprecated);
    # manual PVs default Retain, dynamically provisioned ones Delete
    reclaim_policy: str = "Retain"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return ""  # cluster-scoped

    @property
    def labels(self) -> Dict[str, str]:
        return self.metadata.labels

    def to_dict(self) -> dict:
        src: Dict[str, dict] = {}
        if self.source_kind:
            src[self.source_kind] = {
                _SRC_ID_FIELD[self.source_kind]: self.source_id}
            if self.source_kind == SRC_CSI and self.csi_driver:
                src[self.source_kind]["driver"] = self.csi_driver
        spec = {
            "capacity": ({"storage": str(self.capacity)}
                         if self.capacity is not None else {}),
            "accessModes": list(self.access_modes),
            "storageClassName": self.storage_class,
            "persistentVolumeReclaimPolicy": self.reclaim_policy,
            **src,
        }
        if self.node_affinity is not None:
            spec["nodeAffinity"] = {"required": self.node_affinity.to_dict()}
        if self.claim_ref:
            ns, _, nm = self.claim_ref.partition("/")
            spec["claimRef"] = {"namespace": ns, "name": nm}
        return {
            "kind": "PersistentVolume", "apiVersion": "v1",
            "metadata": _storage_meta(self.metadata, namespaced=False),
            "spec": spec,
            "status": {"phase": self.phase},
        }

    @staticmethod
    def from_dict(d: dict) -> "PersistentVolume":
        spec = d.get("spec") or {}
        source_kind = ""
        csi_driver = ""
        source_id = ""
        for k in (SRC_EBS, SRC_GCE, SRC_AZURE, SRC_CINDER, SRC_CSI):
            if k in spec:
                source_kind = k
                source_id = spec[k].get(_SRC_ID_FIELD[k], "")
                if k == SRC_CSI:
                    csi_driver = spec[k].get("driver", "")
                break
        na = None
        aff = (spec.get("nodeAffinity") or {}).get("required")
        if aff:
            na = NodeSelector.from_dict(aff)
        cap = (spec.get("capacity") or {}).get("storage")
        cr = spec.get("claimRef") or {}
        return PersistentVolume(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            capacity=parse_quantity(cap) if cap is not None else None,
            access_modes=tuple(spec.get("accessModes") or ()),
            storage_class=spec.get("storageClassName", ""),
            node_affinity=na,
            source_kind=source_kind,
            csi_driver=csi_driver,
            source_id=source_id,
            phase=(d.get("status") or {}).get("phase", "Available"),
            claim_ref=f"{cr.get('namespace', '')}/{cr.get('name', '')}" if cr else "",
            reclaim_policy=spec.get("persistentVolumeReclaimPolicy", "Retain"),
        )


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class: str = ""
    volume_name: str = ""         # bound PV
    request: Optional[Quantity] = None
    access_modes: Tuple[str, ...] = ()
    phase: str = "Pending"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @staticmethod
    def from_dict(d: dict) -> "PersistentVolumeClaim":
        spec = d.get("spec") or {}
        req = ((spec.get("resources") or {}).get("requests") or {}).get("storage")
        return PersistentVolumeClaim(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            storage_class=spec.get("storageClassName", ""),
            volume_name=spec.get("volumeName", ""),
            request=parse_quantity(req) if req is not None else None,
            access_modes=tuple(spec.get("accessModes") or ()),
            phase=(d.get("status") or {}).get("phase", "Pending"),
        )

    def to_dict(self) -> dict:
        return {
            "kind": "PersistentVolumeClaim", "apiVersion": "v1",
            "metadata": _storage_meta(self.metadata, namespaced=True),
            "spec": {
                "storageClassName": self.storage_class,
                "volumeName": self.volume_name,
                "accessModes": list(self.access_modes),
                "resources": {"requests": (
                    {"storage": str(self.request)}
                    if self.request is not None else {}
                )},
            },
            "status": {"phase": self.phase},
        }


@dataclass
class StorageClass:
    name: str = ""
    provisioner: str = ""
    binding_mode: str = IMMEDIATE

    @property
    def namespace(self) -> str:
        return ""  # cluster-scoped

    @staticmethod
    def from_dict(d: dict) -> "StorageClass":
        return StorageClass(
            name=(d.get("metadata") or {}).get("name", ""),
            provisioner=d.get("provisioner", ""),
            binding_mode=d.get("volumeBindingMode", IMMEDIATE),
        )

    def to_dict(self) -> dict:
        return {
            "kind": "StorageClass", "apiVersion": "storage.k8s.io/v1",
            "metadata": {"name": self.name},
            "provisioner": self.provisioner,
            "volumeBindingMode": self.binding_mode,
        }
