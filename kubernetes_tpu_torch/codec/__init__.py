"""Tensor schema + snapshot codec: the device mirror of the scheduler cache
(the port's counterpart of kubernetes_tpu/codec)."""

from kubernetes_tpu_torch.codec.interner import Interner
from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    PodBatch,
    PadDims,
    FIELD_NODE_NAME,
    PAD,
    WILDCARD,
    cluster_to_torch,
    pods_to_torch,
    ports_to_torch,
    to_numpy,
)
from kubernetes_tpu_torch.codec.encoder import SnapshotEncoder
