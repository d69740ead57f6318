"""The Filter/Score/select pipeline as tensor functions
`(ClusterTensors, PodBatch) -> [B, N]` (the port's counterpart of
kubernetes_tpu/ops)."""

from kubernetes_tpu_torch.ops.predicates import filter_batch, first_failure
from kubernetes_tpu_torch.ops.priorities import score_batch
from kubernetes_tpu_torch.ops.select import (
    select_host,
    select_hosts_batch,
    select_hosts_batch_plain,
    num_feasible_nodes_to_find,
)
