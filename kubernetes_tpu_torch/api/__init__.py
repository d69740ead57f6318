"""Object model: the scheduler-relevant slice of the Kubernetes API (the
port's copy of kubernetes_tpu/api; see that package for the reference
mapping)."""

from kubernetes_tpu_torch.api.resource import Quantity, parse_quantity
from kubernetes_tpu_torch.api.labels import (
    Requirement,
    Selector,
    selector_from_label_selector,
    selector_from_match_labels,
)
from kubernetes_tpu_torch.api.types import Node, Pod
