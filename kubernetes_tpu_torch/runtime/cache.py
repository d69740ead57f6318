"""Scheduler cache: assume/confirm/expire over the tensor encoder.

Mirrors the Cache contract (ref pkg/scheduler/internal/cache/cache.go,
interface.go:60-110): optimistic AssumePod immediately charges the pod to its
node so the next cycle sees it; the informer's AddPod confirms it; ForgetPod
rolls it back (bind failure, scheduler.go:416-426); assumed pods expire after
a TTL if never confirmed.  snapshot() is UpdateNodeInfoSnapshot: the encoder
arenas already ARE the incrementally-maintained snapshot, so this is a copy
tagged with the generation counter (interface.go:125-128).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.codec.encoder import SnapshotEncoder
from kubernetes_tpu_torch.codec.schema import ClusterTensors


class SchedulerCache:
    def __init__(self, encoder: Optional[SnapshotEncoder] = None, assume_ttl: float = 30.0):
        self.encoder = encoder or SnapshotEncoder()
        self.assume_ttl = assume_ttl
        self._lock = threading.RLock()
        self._assumed: Dict[Tuple[str, str], Tuple[Pod, float]] = {}

    # ---- nodes ----

    def add_node(self, node: Node) -> None:
        with self._lock:
            self.encoder.add_node(node)

    def add_nodes(self, nodes) -> None:
        """Batched node ingest: one lock acquisition + one columnar encoder
        apply for a whole node list (informer initial list / failover
        re-sync — the cold-start wall; see encoder.add_nodes)."""
        if not nodes:
            return
        with self._lock:
            self.encoder.add_nodes(nodes)

    def update_node(self, node: Node) -> None:
        with self._lock:
            self.encoder.update_node(node)

    def update_nodes(self, nodes) -> None:
        """Batched upsert (informer re-list): new nodes bulk-encode,
        unchanged nodes are skipped, changed nodes re-encode per row."""
        if not nodes:
            return
        with self._lock:
            self.encoder.update_nodes(nodes)

    def remove_node(self, name: str) -> None:
        with self._lock:
            self.encoder.remove_node(name)

    # ---- pods ----

    def assume_pod(self, pod: Pod) -> None:
        """Charge the pod to its node optimistically (cache.go AssumePod)."""
        with self._lock:
            key = (pod.namespace, pod.name)
            self.encoder.add_pod(pod)
            self._assumed[key] = (pod, time.monotonic() + self.assume_ttl)

    def assume_pods(self, pods) -> None:
        """Batched AssumePod: one lock acquisition + one encoder delta
        apply for a whole commit batch (the per-pod loop held/released the
        lock and paid the numpy small-op overhead B times; the batched
        encoder apply is state-equivalent — see encoder.add_pods)."""
        if not pods:
            return
        with self._lock:
            deadline = time.monotonic() + self.assume_ttl
            self.encoder.add_pods(pods)
            for pod in pods:
                self._assumed[(pod.namespace, pod.name)] = (pod, deadline)

    def forget_pod(self, pod: Pod) -> None:
        """Roll back an assumed pod (cache.go ForgetPod)."""
        with self._lock:
            key = (pod.namespace, pod.name)
            if key in self._assumed:
                self._assumed.pop(key)
                self.encoder.remove_pod(pod)

    def add_pod(self, pod: Pod) -> None:
        """Confirm from the watch (cache.go AddPod): replaces any assumed copy."""
        with self._lock:
            key = (pod.namespace, pod.name)
            self._assumed.pop(key, None)
            self.encoder.add_pod(pod)  # add_pod replaces an existing record

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            self._assumed.pop((pod.namespace, pod.name), None)
            self.encoder.remove_pod(pod)

    def cleanup_expired(self, now: Optional[float] = None) -> int:
        """Expire assumed-but-never-confirmed pods (cache.go cleanupAssumedPods)."""
        now = now if now is not None else time.monotonic()
        n = 0
        with self._lock:
            for key, (pod, deadline) in list(self._assumed.items()):
                if deadline <= now:
                    self._assumed.pop(key)
                    self.encoder.remove_pod(pod)
                    n += 1
        return n

    # ---- snapshot ----

    @property
    def generation(self) -> int:
        return self.encoder.generation

    def snapshot(self) -> Tuple[ClusterTensors, int]:
        with self._lock:
            return self.encoder.snapshot(), self.encoder.generation
