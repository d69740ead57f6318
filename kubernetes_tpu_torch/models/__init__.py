"""Scheduling engines composed from ops/: the sequential one-pod-at-a-time
engine (batched.py) and the speculative propose-and-commit engine
(speculative.py), with the JAX package's call contract."""

from kubernetes_tpu_torch.models.batched import (
    BatchPortState,
    encode_batch_ports,
    make_sequential_scheduler,
)
from kubernetes_tpu_torch.models.speculative import make_speculative_scheduler
