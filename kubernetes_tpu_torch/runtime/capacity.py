"""Device-resident capacity planner (PyTorch port of the JAX package's
runtime/capacity.py): class-compressed what-if binpack of the live backlog
over a candidate node-shape catalog.

  * **Snapshot.**  Every `interval_cycles` committed cycles the planner
    takes the cycle's host cluster refs (allocatable / requested / valid,
    immutable by the encoder's copy-on-write contract) and the
    pending+unschedulable backlog's request vectors, QUANTIZES both to
    per-resource power-of-two quanta so every value is an exact integer
    below 2**24 (requests round up, capacities down), and CLASS-COMPRESSES
    the backlog into (vector -> count) classes.
  * **Two-stage solve, one side launch.**  Stage 1 packs the classes into
    the EXISTING headroom: the FFD order against the fleet's largest free
    shape (kernel K9), the count scan into the per-node free rows (kernel
    K8, per-bin mode), and plain torch on the device for the scatter back
    to class order, the leftover and the touched nodes.  Stage 2 packs the
    leftover over the shape catalog (K9, then K8 in uniform mode, every
    shape a lane).  Both stages are enqueued behind the scheduling loop
    without a sync and read back one interval later.
  * **Recommendation.**  "add 37 x shape-C nodes" (the cheapest shape that
    fits the whole overflow, runners-up included), or the valid, pod-free
    nodes stage 1 left untouched ("drainable").

Placements are identical with the planner on or off: it only reads the
immutable snapshot refs and the queue's backlog.  A solve that is lost (a
failed backlog walk, launch or read-back) is counted in `solves_dropped`
and logged, never raised into the cycle; nothing falls back to the CPU.
The device-mesh form of stage 2 waits for ROADMAP A11.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.codec.schema import (
    RES_EPHEMERAL,
    RES_MEMORY,
    RES_MILLICPU,
    RES_PODS,
)
from kubernetes_tpu_torch.codec.transfer import _h2d_packed
from kubernetes_tpu_torch.models.binpack import (
    INT_EXACT_LIMIT,
    binpack_counts,
    binpack_shapes_compressed,
    compress_classes,
    ffd_order_batch,
)
from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils import metrics as m

# a small general-purpose default catalog (GCE-flavored names)
DEFAULT_SHAPE_CATALOG: Tuple[dict, ...] = (
    {"name": "c2-standard-8", "cpu": "8", "memory": "32Gi"},
    {"name": "c2-standard-16", "cpu": "16", "memory": "64Gi"},
    {"name": "c2-standard-30", "cpu": "30", "memory": "120Gi"},
    {"name": "m1-highmem-16", "cpu": "16", "memory": "128Gi"},
)

# catalog entry keys that are NOT resource quantities
_META_KEYS = frozenset({"name", "pods"})

# default allocatable-pods slots per catalog node (the kubelet default)
DEFAULT_SHAPE_PODS = 110.0


def catalog_vectors(
    catalog,
    r: int,
    res_col: Optional[Callable[[str], Optional[int]]] = None,
) -> Tuple[List[str], np.ndarray]:
    """Shape-catalog entries ({name, cpu, memory, ephemeral-storage?,
    pods?, <extended>...}) -> (names, capacities f32[S, r]) in the
    snapshot encoder's resource-column units (cpu in milli, bytes for
    memory/ephemeral).  `res_col` maps extended resource names to columns
    read-only (unknown names are skipped)."""
    from kubernetes_tpu_torch.api.resource import parse_quantity

    names: List[str] = []
    caps = np.zeros((len(catalog), r), np.float32)
    for i, entry in enumerate(catalog):
        names.append(str(entry.get("name", f"shape-{i}")))
        caps[i, RES_PODS] = float(entry.get("pods", DEFAULT_SHAPE_PODS))
        for key, val in entry.items():
            if key in _META_KEYS:
                continue
            if key == "cpu":
                caps[i, RES_MILLICPU] = float(parse_quantity(val).milli)
            elif key == "memory":
                caps[i, RES_MEMORY] = float(parse_quantity(val))
            elif key == "ephemeral-storage":
                caps[i, RES_EPHEMERAL] = float(parse_quantity(val))
            else:
                col = res_col(key) if res_col is not None else None
                if col is not None and 0 <= col < r:
                    caps[i, col] = float(parse_quantity(val))
    return names, caps


def quantize_columns(*arrays) -> np.ndarray:
    """Per-resource power-of-two quanta making every value in `arrays` fit
    the count scan's integer-exactness contract (< 2**24 after
    division)."""
    r = arrays[0].shape[-1]
    maxv = np.zeros(r, np.float64)
    for a in arrays:
        if a.size:
            maxv = np.maximum(maxv, a.reshape(-1, r).max(axis=0))
    quanta = np.ones(r, np.float64)
    over = maxv >= INT_EXACT_LIMIT
    if over.any():
        quanta[over] = 2.0 ** np.ceil(
            np.log2(maxv[over] / (INT_EXACT_LIMIT - 1.0))
        )
    return quanta


def stage1(free: torch.Tensor, classes: torch.Tensor, counts: torch.Tensor):
    """Pack the classes (f32[C, R], counts i32[C]) into the existing
    headroom free f32[N, R] (one bin a node row): the FFD order against
    the fleet's largest free shape (K9 on the card), the per-bin count scan
    (K8), then the class-indexed leftover, the pods absorbed and the rows
    the pack touched.  Returns (leftover i32[C], absorbed i64[], touched
    bool[N]) on the tensors' device, without a sync."""
    ref = torch.maximum(free.amax(0), torch.ones((), dtype=torch.float32,
                                                 device=free.device))
    order = ffd_order_batch(classes, ref[None, :])
    _, placed_c, _, touched = binpack_counts(
        classes, counts, free, order, free.shape[0], per_bin=True)
    placed = torch.zeros_like(counts).scatter(0, order[0].to(torch.int64),
                                              placed_c[0])
    real = (classes > 0).any(-1)
    zero = torch.zeros_like(counts)
    leftover = torch.where(real, counts - placed, zero)
    absorbed = torch.where(real, placed, zero).to(torch.int64).sum()
    return leftover, absorbed, touched


class CapacityPlanner:
    """Per-scheduler capacity-planning aggregation point.

    The scheduling thread calls `on_cycle` once per committed cycle (the
    Scheduler stamps its cost into scheduler_capacity_seconds_total);
    readers come from other threads and take the lock only around
    ring/summary state.  device: where the solves run ("cuda" unless the
    caller passes "cpu")."""

    def __init__(
        self,
        catalog=None,
        interval_cycles: int = 256,
        ring_capacity: int = 128,
        max_bins: int = 1024,
        backlog_cap: int = 65536,
        mesh=None,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "not ported yet: the planner's device mesh (ROADMAP A11 "
                "(multi-device))")
        self.catalog = list(catalog) if catalog else list(
            DEFAULT_SHAPE_CATALOG
        )
        self.interval_cycles = max(1, int(interval_cycles))
        self.max_bins = max(1, int(max_bins))
        self.backlog_cap = max(1, int(backlog_cap))
        self.device = torch.device(device)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring_capacity)))
        self.cycles_total = 0
        self.solves_total = 0
        self.solves_dropped = 0
        self.dispatches_total = 0
        self._cycles_since = self.interval_cycles  # first cycle is due
        # in-flight solve: (cycle, device outs tuple, meta dict)
        self._pending: Optional[Tuple[int, tuple, dict]] = None
        self.recommendation: Optional[dict] = None
        self._reco_shape: Optional[str] = None
        self._caps_cache: Dict[int, Tuple[List[str], np.ndarray]] = {}

    def _dropped(self, what: str, cycle, err: BaseException) -> None:
        with self._lock:
            self.solves_dropped += 1
        klog.errorf("capacity solve dropped (cycle %s, %s): %s: %s",
                    cycle, what, type(err).__name__, err)

    # ------------------------------------------------------ hot-path API

    def on_cycle(
        self,
        cycle: int,
        backlog: Callable[[int], np.ndarray],
        snapshot: Optional[tuple],
        node_names: Optional[Callable[[], Dict[int, str]]] = None,
        res_col: Optional[Callable[[str], Optional[int]]] = None,
    ) -> None:
        """Fold one committed cycle: materialize the solve in flight, then
        dispatch the next one on due cycles.  `backlog` is a callable
        returning the pending+unschedulable request matrix f32[P, R] or
        the pre-grouped (vectors f32[G, R], counts i[G]), invoked only on
        due cycles; `snapshot` the cycle's host (allocatable, requested,
        valid) refs.  The cadence counter resets only on a dispatch, so a
        due cycle without a snapshot leaves the interval due."""
        self.cycles_total += 1
        self._cycles_since += 1
        if self._cycles_since < self.interval_cycles:
            return
        self._materialize_pending()
        if snapshot is None:
            return
        try:
            reqs = backlog(self.backlog_cap)
        except Exception as e:  # noqa: BLE001 — one lost solve, counted
            self._dropped("backlog walk", cycle, e)
            return
        if self._dispatch(cycle, reqs, snapshot, node_names, res_col):
            self._cycles_since = 0

    # ------------------------------------------------------ solve launch

    def _shape_caps(self, r: int, res_col) -> Tuple[List[str], np.ndarray]:
        hit = self._caps_cache.get(r)
        if hit is None:
            hit = catalog_vectors(self.catalog, r, res_col=res_col)
            self._caps_cache[r] = hit
        return hit

    def _dispatch(self, cycle: int, reqs, snapshot, node_names,
                  res_col) -> bool:
        """Quantize + compress + enqueue the two-stage solve; the result is
        read back one interval from now.  Returns whether it dispatched."""
        alloc, used, valid = (np.asarray(x) for x in snapshot)
        if isinstance(reqs, tuple):
            reqs, req_counts = reqs
            req_counts = np.asarray(req_counts, np.int64)
        else:
            req_counts = None
        reqs = np.asarray(reqs, np.float32)
        if reqs.ndim != 2 or reqs.shape[1] != alloc.shape[1]:
            reqs = np.zeros((0, alloc.shape[1]), np.float32)
            req_counts = None
        names, caps = self._shape_caps(alloc.shape[1], res_col)
        if not len(names):
            return False
        free = np.where(
            valid[:, None],
            np.maximum(alloc.astype(np.float64) - used.astype(np.float64),
                       0.0),
            0.0,
        )
        quanta = quantize_columns(free, caps.astype(np.float64),
                                  reqs.astype(np.float64))
        free_q = np.floor(free / quanta).astype(np.float32)
        caps_q = np.floor(caps.astype(np.float64) / quanta).astype(
            np.float32
        )
        reqs_q = np.ceil(reqs.astype(np.float64) / quanta).astype(
            np.float32
        )
        classes, counts = compress_classes(
            reqs_q, pad_to_pow2=True, weights=req_counts
        )
        backlog_pods = int(counts.sum())
        n_classes = int(np.sum(np.any(classes > 0, axis=-1)))
        meta = {
            "backlog_pods": backlog_pods,
            "classes": max(n_classes, 1 if backlog_pods else 0),
            "shapes": len(names),
            "shape_names": names,
            "quanta": [float(q) for q in quanta],
            "node_names": node_names,
            "valid": valid,
            "pod_free": used[:, RES_PODS] <= 0,
        }
        try:
            free_d, cls_d, cnt_d, caps_d = _h2d_packed(
                [free_q, classes, counts, caps_q], self.device, "capacity")
            leftover, absorbed, touched = stage1(free_d, cls_d, cnt_d)
            bins, ok = binpack_shapes_compressed(
                cls_d, leftover, caps_d, max_bins=self.max_bins)
        except Exception as e:  # noqa: BLE001 — one lost solve, counted
            self._dropped("dispatch", cycle, e)
            return False
        with self._lock:
            self._pending = (
                cycle, (leftover, absorbed, touched, bins, ok), meta,
            )
            self.dispatches_total += 1
        return True

    # ------------------------------------------------------ materialize

    def _materialize_pending(self) -> Optional[dict]:
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        cycle, outs, meta = pending
        try:
            leftover, absorbed, touched, bins, ok = (
                x.cpu().numpy() for x in outs
            )
        except Exception as e:  # noqa: BLE001 — one lost solve, counted
            self._dropped("read-back", cycle, e)
            return None
        names: List[str] = meta["shape_names"]
        s = len(names)
        bins, ok = bins[:s], ok[:s]
        overflow = int(leftover.sum())
        fits = np.flatnonzero(ok & (bins > 0)) if overflow else (
            np.empty(0, np.int64)
        )
        scale_up = None
        runners_up: List[dict] = []
        if overflow and len(fits):
            ranked = fits[np.argsort(bins[fits], kind="stable")]
            best = int(ranked[0])
            scale_up = {
                "shape": names[best],
                "count": int(bins[best]),
                "shape_index": best,
            }
            runners_up = [
                {"shape": names[int(i)], "count": int(bins[int(i)])}
                for i in ranked[1:4]
            ]
        drain_rows = np.flatnonzero(
            meta["valid"] & meta["pod_free"] & ~touched[: len(meta["valid"])]
        )
        drain_names: List[str] = []
        resolve = meta.get("node_names")
        if resolve is not None and len(drain_rows):
            try:
                by_row = resolve()
                drain_names = [
                    by_row[int(r)] for r in drain_rows[:16]
                    if int(r) in by_row
                ]
            except Exception:  # noqa: BLE001 — names are advisory
                drain_names = []
        backlog_pods = meta["backlog_pods"]
        n_classes = meta["classes"]
        sample = {
            "time": time.time(),
            "cycle": int(cycle),
            "backlog_pods": backlog_pods,
            "classes": n_classes,
            "compression_x": round(backlog_pods / max(n_classes, 1), 1),
            "absorbed_existing": int(absorbed),
            "overflow_pods": overflow,
            "shapes_evaluated": s,
            "shapes_fitting": int(len(fits)),
            "scale_up": scale_up,
            "runners_up": runners_up,
            "drainable": {
                "count": int(len(drain_rows)),
                "nodes": drain_names,
            },
            "quanta": meta["quanta"],
        }
        with self._lock:
            self.recommendation = sample
            self._ring.append(sample)
            self.solves_total += 1
        m.CAPACITY_SOLVES.inc()
        m.CAPACITY_BACKLOG.set(float(backlog_pods), kind="pods")
        m.CAPACITY_BACKLOG.set(float(n_classes), kind="classes")
        m.CAPACITY_OVERFLOW.set(float(overflow))
        m.CAPACITY_ABSORBED.set(float(absorbed))
        m.CAPACITY_DRAINABLE.set(float(len(drain_rows)))
        new_shape = scale_up["shape"] if scale_up is not None else None
        if self._reco_shape is not None and self._reco_shape != new_shape:
            m.CAPACITY_RECOMMENDED.remove(shape=self._reco_shape)
        if scale_up is not None:
            m.CAPACITY_RECOMMENDED.set(
                float(scale_up["count"]), shape=new_shape
            )
        self._reco_shape = new_shape
        return sample

    def finalize(self) -> None:
        """Materialize any in-flight solve (the last sample of a drained
        queue would otherwise stay in flight)."""
        self._materialize_pending()

    # ----------------------------------------------------------- readers

    def summary(self) -> dict:
        with self._lock:
            reco = dict(self.recommendation) if self.recommendation else None
            return {
                "cycles": self.cycles_total,
                "solves": self.solves_total,
                "solves_dropped": self.solves_dropped,
                "interval_cycles": self.interval_cycles,
                "catalog_shapes": len(self.catalog),
                "max_bins": self.max_bins,
                "backlog_cap": self.backlog_cap,
                "sharded": False,
                "recommendation": reco,
            }

    def debug_payload(self, limit: Optional[int] = None) -> dict:
        """The /debug/capacity body: summary + the newest `limit` solve
        samples."""
        self._materialize_pending()
        with self._lock:
            samples = list(self._ring)
        if limit is not None and limit >= 0:
            samples = samples[-limit:] if limit else []
        return {"summary": self.summary(), "samples": samples}


# process-wide default: a Scheduler with capacity_planner enabled installs
# its own here; replica 0 wins the default, siblings register alongside
from kubernetes_tpu_torch.runtime.defaults import ProcessDefault  # noqa: E402

_DEFAULT = ProcessDefault("capacity", CapacityPlanner)


def get_default() -> CapacityPlanner:
    return _DEFAULT.get()


def set_default(planner: CapacityPlanner, replica: int = 0) -> None:
    _DEFAULT.set(planner, replica)


def replica_instances() -> dict:
    """{replica id: CapacityPlanner} of every install this process saw."""
    return _DEFAULT.replicas()
