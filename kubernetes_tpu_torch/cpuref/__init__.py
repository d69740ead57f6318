"""Pure-Python golden implementation of the scheduling pipeline.

The port's copy of the JAX package's cpuref/reference.py, with its imports
rewritten to the port's api/ and codec/ modules.  The port uses
`CPUScheduler` for the host-side nomination check of preemption
(models/preemption.py verify_nomination); the CPU degradation engine that
the JAX package builds on it (cpuref/adapter.py) is ROADMAP A5 and not
ported.
"""

from kubernetes_tpu_torch.cpuref.reference import (  # noqa: F401
    CPUScheduler,
    run_predicates,
    run_priorities,
)
