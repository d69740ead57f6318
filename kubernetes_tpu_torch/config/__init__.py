"""Scheduler configuration (PyTorch port): the port's copy of the JAX
package's config/ (feature gates, algorithm providers and Policy profiles,
KubeSchedulerConfiguration), which imports no device code."""

from kubernetes_tpu_torch.config.featuregates import FeatureGates, DEFAULT_GATES
from kubernetes_tpu_torch.config.profile import (
    SchedulingProfile,
    algorithm_provider,
    profile_from_policy,
    DEFAULT_PROVIDER,
    CLUSTER_AUTOSCALER_PROVIDER,
)
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
