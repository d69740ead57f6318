"""Host-side control loop: queue, cache, and the scheduling service (the
port's counterpart of kubernetes_tpu/runtime).

The control plane stays on the host (Python); the Filter/Score math runs on
the device through models/.  queue.py, cache.py, events.py,
flightrecorder.py, defaults.py, invariants.py and health.py's breaker are
copies of the JAX package's modules with the imports rewritten;
scheduler.py is the live cycle's port; quality.py the placement-quality
observatory's, with its regret counterfactual in torch around kernel K4;
telemetry.py the telemetry hub's, with the cluster analytics on kernel K5;
timeline.py is a copy of the metrics timeline; capacity.py the capacity
planner's, its two stages on kernels K9 and K8; reconciler.py and
replicas.py the replicas' snapshot hub, conflict reconciler (its admission
scan on kernel K10) and replica set.
"""

from kubernetes_tpu_torch.runtime.queue import PriorityQueue, PodBackoff
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.flightrecorder import RECORDER, FlightRecorder
from kubernetes_tpu_torch.runtime.health import DeviceHealth
from kubernetes_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.runtime.replicas import SchedulerReplicaSet
