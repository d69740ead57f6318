"""SchedulerReplicaSet: N scheduler replicas over one process's state
(PyTorch port of the JAX package's runtime/replicas.py).

The replica set builds N `Scheduler` instances (threads) sharing:

  * ONE SchedulerCache/SnapshotEncoder (commits serialize under the cache
    lock; everything else overlaps),
  * ONE PriorityQueue, hash-sharded N ways (each replica pops only its
    stable shard; requeues return to the owner shard),
  * ONE SnapshotHub — THE resident device snapshot every replica
    dispatches against (runtime/reconciler.py: on the port the hub holds
    its lock from the refresh through the engine's enqueue),
  * ONE ConflictReconciler sequencing every commit: zero-conflict cycles
    admit on the generation fence; conflicted cycles run the admission
    scan (kernel K10 on the card), keep the sequenced winner per node, and
    requeue only the losers (DRF-tiebroken, quota-enforced).

Replica 0 is the primary: it owns the engines (siblings reuse them) and
the default observability installs.  Replicas require batched_commit;
device-mesh sharding is not combined with them (ROADMAP A11).  Replicas
are Python threads sharing one CUDA context and the GIL.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PriorityQueue
from kubernetes_tpu_torch.runtime.reconciler import (
    ConflictReconciler,
    SnapshotHub,
)
from kubernetes_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import metrics as m


class SchedulerReplicaSet:
    """N queue-sharded scheduler replicas with optimistic conflict
    reconciliation (see module docstring).  device: where every replica
    runs ("cuda" unless the caller passes "cpu")."""

    def __init__(
        self,
        replicas: int = 2,
        cache: Optional[SchedulerCache] = None,
        queue: Optional[PriorityQueue] = None,
        binder: Optional[Callable] = None,
        config: Optional[SchedulerConfig] = None,
        recorder=None,
        victim_deleter=None,
        pdb_lister=None,
        device="cuda",
    ):
        n = max(1, int(replicas))
        config = config if config is not None else SchedulerConfig()
        if not config.batched_commit:
            raise ValueError(
                "SchedulerReplicaSet requires batched_commit (the "
                "reconciler admits winners as one sequenced delta)"
            )
        if config.shard_devices or config.mesh_shape:
            raise ValueError(
                "SchedulerReplicaSet does not combine with device-mesh "
                "sharding: the mesh shards the node tensor, replicas "
                "shard the queue — pick one scale-out axis per process"
            )
        self.n = n
        self.cache = cache if cache is not None else SchedulerCache()
        self.queue = (
            queue if queue is not None
            else PriorityQueue(capacity=config.queue_capacity, shards=n)
        )
        if hasattr(self.queue, "set_shards"):
            self.queue.set_shards(n)
        self.reconciler = ConflictReconciler()
        self.config = config
        cfg0 = dataclasses.replace(config, replicas=n)
        r0 = Scheduler(
            cache=self.cache, queue=self.queue, binder=binder,
            config=cfg0, recorder=recorder,
            victim_deleter=victim_deleter, pdb_lister=pdb_lister,
            replica_id=0, replica_of=n, reconciler=self.reconciler,
            device=device,
        )
        self._assemble(r0)

    def _assemble(self, r0: Scheduler) -> None:
        """Attach the shared hub to the primary and build the siblings
        around it."""
        n = self.n
        self.hub = SnapshotHub(self.cache, r0._dev_snapshot)
        r0.attach_hub(self.hub)
        self.schedulers: List[Scheduler] = [r0]
        for i in range(1, n):
            cfg_i = dataclasses.replace(
                r0.config,
                express_lane=False,
                decision_ledger=False,
                heartbeat_s=0.0,
            )
            self.schedulers.append(
                Scheduler(
                    cache=self.cache, queue=self.queue,
                    binder=r0.binder, config=cfg_i,
                    recorder=r0.recorder,
                    victim_deleter=r0.victim_deleter,
                    pdb_lister=r0.pdb_lister,
                    replica_id=i, replica_of=n,
                    reconciler=self.reconciler, snapshot_hub=self.hub,
                    share_engines_with=r0, device=r0.device,
                )
            )
        self._threads: List[threading.Thread] = []
        m.REPLICAS.set(float(n))

    @classmethod
    def from_primary(cls, primary: Scheduler,
                     replicas: int) -> "SchedulerReplicaSet":
        """Wrap an already-built scheduler as replica 0 of an N-way set.
        Must run before the primary serves its first cycle."""
        n = max(1, int(replicas))
        cfg = primary.config
        if not cfg.batched_commit:
            raise ValueError("replicas require batched_commit")
        if cfg.shard_devices or cfg.mesh_shape:
            raise ValueError(
                "replicas do not combine with device-mesh sharding"
            )
        self = cls.__new__(cls)
        self.n = n
        self.cache = primary.cache
        self.queue = primary.queue
        if hasattr(self.queue, "set_shards"):
            self.queue.set_shards(n)
        self.reconciler = ConflictReconciler()
        self.config = cfg
        cfg.replicas = n
        primary._replica_of = n
        primary._reconciler = self.reconciler
        self._assemble(primary)
        return self

    # ------------------------------------------------------------ running

    @property
    def primary(self) -> Scheduler:
        return self.schedulers[0]

    def prewarm(self) -> None:
        """Run the admission scan once at every width of the pow2 ladder
        up to the batch size (outside a timed window)."""
        self.reconciler.prewarm(
            self.config.batch_size, self.cache.encoder.dims.R,
            device=self.primary.device,
        )

    def start(self) -> None:
        """One daemon thread per replica running its scheduling loop.
        Restartable: stop() only parks the loops."""
        if self._threads:
            return
        for s in self.schedulers:
            s._stop.clear()
        for s in self.schedulers:
            t = threading.Thread(
                target=s.run, name=f"scheduler-replica-{s._replica_id}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Park every replica loop WITHOUT closing the shared queue; loops
        exit within their pop timeout and flush in-flight work."""
        for s in self.schedulers:
            s._stop.set()
        for t in self._threads:
            t.join(timeout_s)
        self._threads = []

    def close(self) -> None:
        """Terminal stop: park the loops AND close the shared queue."""
        self.stop()
        self.queue.close()

    def run_until_drained(self, budget_s: float = 60.0,
                          poll_s: float = 0.01) -> int:
        """start() (if not already running), then wait until nothing
        schedulable remains, no replica is inside a cycle or holds a
        pipelined batch (seen on two polls in a row: a pop that just
        emptied the queue may not have marked its cycle yet), or the
        budget expires.  Returns pods placed across all replicas during
        the wait."""
        placed0 = self.placed_total
        self.start()
        deadline = time.monotonic() + budget_s
        idle = 0
        while time.monotonic() < deadline:
            busy = self.queue.has_schedulable() or any(
                s.pipeline_pending or s.in_cycle for s in self.schedulers
            )
            idle = 0 if busy else idle + 1
            if idle >= 2:
                break
            time.sleep(poll_s)
        return self.placed_total - placed0

    # ---------------------------------------------------------- aggregate

    @property
    def placed_total(self) -> int:
        return sum(s._outcome_totals["placed"] for s in self.schedulers)

    @property
    def unschedulable_total(self) -> int:
        return sum(
            s._outcome_totals["unschedulable"] for s in self.schedulers
        )

    @property
    def conflicts_total(self) -> int:
        return self.reconciler.conflicts_total

    def assert_drained(self) -> bool:
        """Every replica's invariant checker confirms no popped pod is
        unresolved.  True when clean."""
        ok = True
        for s in self.schedulers:
            if s.invariants is not None:
                ok = s.invariants.assert_drained() and ok
        return ok

    def invariant_violations_total(self) -> int:
        return sum(
            s.invariants.violations_total()
            for s in self.schedulers if s.invariants is not None
        )

    def summary(self) -> dict:
        return {
            "replicas": self.n,
            "placed": self.placed_total,
            "unschedulable": self.unschedulable_total,
            "conflicts": self.conflicts_total,
            "quota_vetoes": self.reconciler.quota_vetoes_total,
            "reconciler": self.reconciler.stats(),
            "hub_refreshes": self.hub.refreshes,
            "invariant_violations": self.invariant_violations_total(),
            "per_replica": {
                str(s._replica_id): {
                    "placed": s._outcome_totals["placed"],
                    "unschedulable": s._outcome_totals["unschedulable"],
                    "conflicts": s.conflicts_total,
                    "cycles_results": len(s.results),
                }
                for s in self.schedulers
            },
        }
