"""Host <-> device transfer for the raw scheduling loop (PyTorch port).

The counterpart of the parts of the JAX package's codec/transfer.py that the
raw loop needs:

  * `upload_cluster`: the snapshot goes to resident device tensors once and
    is then chained between batches (the engines return a new
    ClusterTensors that shares every static leaf);
  * `upload_batch`: per batch, the PodBatch / port / extra tensors are
    copied from pinned host memory with non_blocking=True, so the copy
    overlaps whatever the host does next;
  * `upload_affinity`: per batch, the in-batch affinity state's factors
    (LeanBatchAffinity) are copied the same way and densified on the
    device, once a batch;
  * `fetch_hosts`: the winners come back as numpy.

Tensors already on the target device pass through untouched.
"""

from __future__ import annotations

from dataclasses import fields
import numpy as np
import torch

from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    PodBatch,
    cluster_to_torch,
)


def _h2d(a, device: torch.device) -> torch.Tensor:
    """One host array (numpy, or a tensor anywhere) -> a tensor on device;
    CUDA destinations go through pinned memory, asynchronously."""
    if isinstance(a, torch.Tensor):
        if a.device == device:
            return a
        t = a
    else:
        a = np.asarray(a)
        if not a.flags.writeable or not a.flags.c_contiguous:
            a = np.array(a, copy=True, order="C")
        t = torch.from_numpy(a)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _dc_to(obj, cls, device: torch.device):
    """A dataclass of arrays (the port's or the JAX package's, read field
    by field) -> the port's `cls` of tensors on device."""
    return cls(**{f.name: _h2d(getattr(obj, f.name), device)
                  for f in fields(cls)})


def upload_cluster(cluster, device) -> ClusterTensors:
    """The snapshot as resident tensors on `device` (a no-op rebuild of the
    dataclass when every leaf already lives there)."""
    return cluster_to_torch(cluster, torch.device(device))


def upload_batch(pods, ports, device, extra_mask=None,
                 extra_score=None):
    """(PodBatch, BatchPortState, extra_mask, extra_score) on `device`,
    copied from pinned host memory without blocking the host."""
    from kubernetes_tpu_torch.models.batched import BatchPortState

    device = torch.device(device)
    pods_t = _dc_to(pods, PodBatch, device)
    ports_t = _dc_to(ports, BatchPortState, device)
    emask = (None if extra_mask is None
             else _h2d(extra_mask, device).to(torch.bool))
    escore = (None if extra_score is None
              else _h2d(extra_score, device).to(torch.float32))
    return pods_t, ports_t, emask, escore


def upload_affinity(aff_state, device):
    """The in-batch affinity state as a dense BatchAffinityState on
    `device` (None passes through).  The factored form (a
    LeanBatchAffinity, the port's or the JAX package's) crosses the link
    from pinned memory without blocking and is densified on the device; a
    dense state is copied field by field."""
    from kubernetes_tpu_torch.models.batched import (
        BatchAffinityState,
        LeanBatchAffinity,
        densify_batch_affinity,
    )

    if aff_state is None:
        return None
    device = torch.device(device)
    if hasattr(aff_state, "aff_gm"):
        return densify_batch_affinity(LeanBatchAffinity(
            *(_h2d(getattr(aff_state, f), device)
              for f in LeanBatchAffinity._fields)))
    return _dc_to(aff_state, BatchAffinityState, device)


def fetch_hosts(hosts: torch.Tensor) -> np.ndarray:
    """Winners back on the host (blocks until the device has produced them)."""
    return hosts.detach().cpu().numpy()
