"""Scheduling engines composed from ops/: the sequential one-pod-at-a-time
engine (batched.py) and the speculative propose-and-commit engine
(speculative.py), with the JAX package's call contract; binpack.py holds
the first-fit scan of the quality observatory's regret (kernel K4)."""

from kubernetes_tpu_torch.models.batched import (
    BatchPortState,
    encode_batch_ports,
    make_sequential_scheduler,
)
from kubernetes_tpu_torch.models.speculative import make_speculative_scheduler
