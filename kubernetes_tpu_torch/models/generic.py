"""One-launch independent scheduling of a pod batch (PyTorch port).

The counterpart of the JAX package's models/generic.py: the analog of
genericScheduler.Schedule (core/generic_scheduler.go:184-254) for B pods at
once *without* inter-pod commit effects: every pod sees the same snapshot.
This is the semantics a stock kube-scheduler gets from the extender seam
(one pod per HTTP call, extender/server.py).

On CUDA tensors every step is a hand-written kernel: the predicate stack
(B1) is K11 in stack mode (ops/predicates.py predicate_stack), the fold of
the stack into the mask and the FitError attribution K7
(ops/predicates.py fold_predicates), the priorities (B2) K12
(ops/priorities.py score_batch) and the selection K1.
"""

from __future__ import annotations

from kubernetes_tpu_torch.codec.schema import ClusterTensors, FilterConfig, PodBatch
from kubernetes_tpu_torch.ops.predicates import fold_predicates, predicate_stack
from kubernetes_tpu_torch.ops.priorities import score_batch
from kubernetes_tpu_torch.ops.select import select_hosts_batch


def schedule_batch_independent(
    cluster: ClusterTensors,
    pods: PodBatch,
    last_index0: int = 0,
    cfg: FilterConfig = FilterConfig(),
    unsched_taint_key: int = 0,
    zone_key_id: int = 5,
    need_per_prio: bool = True,
):
    """Filter + Score + selectHost for every pod against one snapshot, on
    the tensors' device.

    Returns dict with hosts i32[B] (winning node row), feasible bool[B],
    mask bool[B,N], scores f32[B,N], per_pred bool[B,K,N], per_prio
    f32[B,P,N], failure i32[B,N] (first failing predicate index, FitError
    attribution).  need_per_prio=False leaves per_prio None and computes
    only the weighted total (the sidecar reads no priority row)."""
    per_pred = predicate_stack(cluster, pods, cfg, unsched_taint_key)
    mask, failure = fold_predicates(per_pred, cluster.valid, pods.valid)
    total, per_prio = score_batch(cluster, pods, zone_key_id=zone_key_id,
                                  need_per=need_per_prio)
    hosts, feasible = select_hosts_batch(total, mask, last_index0)
    return {
        "hosts": hosts,
        "feasible": feasible,
        "mask": mask,
        "scores": total,
        "per_pred": per_pred,
        "per_prio": per_prio,
        "failure": failure,
    }
