"""Host <-> device transfer (PyTorch port).

The counterpart of the JAX package's codec/transfer.py:

  * `upload_cluster`: the snapshot as resident device tensors, once (the raw
    loop chains the engines' returned ClusterTensors between batches);
  * `DeviceSnapshotCache`: the live cycle's incremental snapshot upload.
    Unchanged fields keep their resident tensors (identity skip, then a
    memcmp fallback); a changed row-indexed field uploads only the
    encoder's dirty rows and scatters them into the resident tensor in
    place (`_scatter_rows`, an `index_copy_`);
  * `upload_batch` / `upload_affinity` / `upload_nominated`: the per-batch
    state (PodBatch, ports, extra mask/score, the in-batch affinity factors,
    the nominated pods) copied from pinned host memory with
    non_blocking=True, so the copy overlaps whatever the host does next;
  * `AsyncFetch` / `host_fetch`: the winners come back to
    numpy.  On CUDA, AsyncFetch copies on a side stream into a pinned host
    buffer and a shared worker thread waits on its CUDA event, so the
    scheduling thread only blocks at `result()`, the ready-fence;
  * `PinnedCopy`: a side launch's small output copied into pinned memory
    behind it with a CUDA event, read an interval later (the quality
    regret's and the telemetry analytics');
  * `transfer_totals` / `transfer_delta`: bytes and calls per direction and
    seam, counted from host array sizes (never a device sync).

Tensors already on the target device pass through untouched.
"""

from __future__ import annotations

import threading
import time
from dataclasses import fields
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.codec import faults
from kubernetes_tpu_torch.codec.schema import (
    ClusterTensors,
    PodBatch,
    _pow2,
    cluster_to_torch,
)

# ------------------------------------------------------ transfer accounting

_XFER_LOCK = threading.Lock()
# (direction, seam) -> [bytes, calls]; the fetch worker and the scheduling
# thread both note here
_XFER_TOTALS: "dict[Tuple[str, str], list]" = {}


def note_transfer(direction: str, seam: str, nbytes: int) -> None:
    """Account one transfer at a wire seam.  Zero-byte calls still count
    a call."""
    with _XFER_LOCK:
        cell = _XFER_TOTALS.get((direction, seam))
        if cell is None:
            cell = _XFER_TOTALS[(direction, seam)] = [0, 0]
        cell[0] += int(nbytes)
        cell[1] += 1


def transfer_totals() -> "dict[str, dict]":
    """Snapshot of cumulative transfer accounting:
    {"h2d/snapshot_upload": {"bytes": B, "calls": C}, ...}."""
    with _XFER_LOCK:
        return {
            f"{d}/{s}": {"bytes": v[0], "calls": v[1]}
            for (d, s), v in _XFER_TOTALS.items()
        }


def transfer_delta(prev: "dict[str, dict]") -> "dict[str, dict]":
    """Non-zero per-seam deltas of transfer_totals() since `prev`."""
    out: dict = {}
    for key, cur in transfer_totals().items():
        p = prev.get(key, {"bytes": 0, "calls": 0})
        db, dc = cur["bytes"] - p["bytes"], cur["calls"] - p["calls"]
        if db or dc:
            out[key] = {"bytes": db, "calls": dc}
    return out


# ------------------------------------------------------------ host -> device


def _h2d_packed(values, device: torch.device,
                seam: "str | None" = None) -> list:
    """Arrays (numpy, anything np.asarray takes, or tensors) -> tensors on
    `device`, in order.  A tensor already on `device` passes through; the
    host values cross in ONE copy from one staging buffer (pinned for a
    CUDA device, so the copy does not block the host), each a 16-byte
    aligned view of the copy with its dtype and shape, sharing no memory
    with the host arrays.  A batch's ~60 small fields thus pay one staging
    and one copy, not one each.  The host bytes are accounted under `seam`
    as one call."""
    out = list(values)
    layout, off, nbytes = [], 0, 0
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            if v.device == device:
                continue
            if v.device.type != "cpu":
                out[i] = v.to(device)
                continue
            a = v.numpy()
        else:
            a = np.asarray(v)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        off = (off + 15) & ~15
        layout.append((i, off, a))
        off += a.nbytes
        nbytes += a.nbytes
    if not layout:
        return out
    host = torch.empty(max(off, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    staged = host.numpy()
    for _, o, a in layout:
        staged[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    if seam is not None:
        note_transfer("h2d", seam, nbytes)
    dev = host.to(device, non_blocking=True)   # no copy on the CPU
    for i, o, a in layout:
        out[i] = (dev[o:o + a.nbytes]
                  .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
                  .view(a.shape))
    return out


def _dc_to(obj, cls, device: torch.device, seam: "str | None" = None):
    """A dataclass of arrays (the port's or the JAX package's, read field
    by field) -> the port's `cls` of tensors on device, its host fields in
    one packed copy (_h2d_packed)."""
    names = [f.name for f in fields(cls)]
    return cls(**dict(zip(names, _h2d_packed(
        [getattr(obj, n) for n in names], torch.device(device), seam))))


def upload_cluster(cluster, device) -> ClusterTensors:
    """The snapshot as resident tensors on `device` (a no-op rebuild of the
    dataclass when every leaf already lives there)."""
    return cluster_to_torch(cluster, torch.device(device))


def upload_batch(pods, ports, device, extra_mask=None,
                 extra_score=None):
    """(PodBatch, BatchPortState, extra_mask, extra_score) on `device`,
    in one copy from pinned host memory without blocking the host."""
    from kubernetes_tpu_torch.models.batched import BatchPortState

    device = torch.device(device)
    pf = [f.name for f in fields(PodBatch)]
    qf = [f.name for f in fields(BatchPortState)]
    vals = _h2d_packed(
        [getattr(pods, n) for n in pf] + [getattr(ports, n) for n in qf]
        + [x for x in (extra_mask, extra_score) if x is not None],
        device, "batch")
    pods_t = PodBatch(**dict(zip(pf, vals)))
    ports_t = BatchPortState(**dict(zip(qf, vals[len(pf):])))
    extra = iter(vals[len(pf) + len(qf):])
    emask = (None if extra_mask is None
             else next(extra).to(torch.bool))
    escore = (None if extra_score is None
              else next(extra).to(torch.float32))
    return pods_t, ports_t, emask, escore


def upload_affinity(aff_state, device):
    """The in-batch affinity state as a dense BatchAffinityState on
    `device` (None passes through).  The factored form (a
    LeanBatchAffinity, the port's or the JAX package's) crosses the link
    from pinned memory without blocking and is densified on the device; a
    dense state is copied in one packed copy."""
    from kubernetes_tpu_torch.models.batched import (
        BatchAffinityState,
        LeanBatchAffinity,
        densify_batch_affinity,
    )

    if aff_state is None:
        return None
    device = torch.device(device)
    if hasattr(aff_state, "aff_gm"):
        return densify_batch_affinity(LeanBatchAffinity(*_h2d_packed(
            [getattr(aff_state, f) for f in LeanBatchAffinity._fields],
            device, "affinity")))
    return _dc_to(aff_state, BatchAffinityState, device, "affinity")


def upload_nominated(nominated, device):
    """The nominated pods' state carried across cycles (a NominatedState,
    the port's or the JAX package's, read field by field) as tensors on
    `device`; None passes through."""
    from kubernetes_tpu_torch.models.batched import NominatedState

    if nominated is None:
        return None
    return _dc_to(nominated, NominatedState, torch.device(device),
                  "nominated")


# ----------------------------------------------- device-resident snapshot

# fields whose leading axis is NOT the node-row axis, or which the encoder
# recomputes wholesale so their diffs are NOT confined to dirty rows
# (image_size rescales every row when the node count moves; group_counts
# can shift many rows when a spread selector registers) — never scattered
_NON_ROW_FIELDS = frozenset({"pair_topo_key", "image_size", "group_counts"})
# scatter only pays while the dirty set stays a small fraction of N
_SCATTER_MAX_FRAC = 4


def _scatter_rows(dev: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Row scatter into a resident device tensor, in place (duplicate
    indices carry identical values, so pad-by-repeat is safe).  rows:
    int64 row indices on dev's device; vals: [len(rows), ...] rows."""
    faults.check(faults.SITE_SCATTER)
    return dev.index_copy_(0, rows, vals)


class DeviceSnapshotCache:
    """Incremental cluster-snapshot upload (the host-side analog is the
    generation-numbered incremental NodeInfo snapshot,
    internal/cache/cache.go:210-222).

    The scheduler takes a fresh host snapshot every cycle, but between
    cycles most cluster tensor fields are byte-identical — label/taint/
    topology tensors only move on node events, while requested/nonzero move
    on every commit.  update() skips any field whose host array is the
    SAME OBJECT as last time (the encoder's incremental snapshot reuses
    unchanged leaves by identity); non-identical fields fall back to
    content comparison before re-uploading.  When the caller passes
    `dirty_rows` (the encoder's take_dirty_rows()), a changed row-indexed
    field uploads only those rows (padded to a power-of-two bucket) and
    scatters them into the resident tensor in place — the dirty set is
    exactly the rows the incremental snapshot rewrote, so host arrays
    cannot differ elsewhere.

    Resident tensors are written in place by later updates: a caller must
    never hand an engine's output cluster back here (the host commit is
    the truth), and the engines never write their input tensors.

    `scatter_rows` records the dirty-row count of every update that
    scattered."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self._host: dict = {}   # field -> last-uploaded host array
        self._dev: dict = {}    # field -> resident device tensor
        self.scatter_rows: List[int] = []

    def resident(self, names: "tuple[str, ...]"):
        """Resident tensors for the named snapshot fields, or None when any
        is absent (before the first update(), or after invalidate())."""
        out = []
        for n in names:
            dev = self._dev.get(n)
            if dev is None:
                return None
            out.append(dev)
        return tuple(out)

    def invalidate(self) -> None:
        """Drop every resident tensor: the next update() re-uploads the
        whole snapshot.  Called after a device fault — an upload may have
        half-landed and the encoder's dirty-row stream may have been
        consumed by the failed cycle, so the incremental invariant
        (_host == device contents) cannot be trusted until rebuilt."""
        self._host.clear()
        self._dev.clear()

    def update(self, cluster, dirty_rows=None) -> ClusterTensors:
        """Host ClusterTensors (numpy) -> the port's ClusterTensors of
        resident tensors, uploading only changes.  dirty_rows: optional
        i32[] of node rows touched since the previous update (None =
        unknown, full content comparison).

        Fault discipline: _host only records arrays whose copy was issued
        without raising — a raising upload leaves the already-committed
        fields coherent and the failed or remaining fields untouched, so a
        retry after a transient fault re-uploads exactly what is missing.
        The whole-tensor uploads therefore commit together at the end."""
        faults.check(faults.SITE_SNAPSHOT_UPDATE)
        device = self.device
        staged: dict = {}
        scatter = []    # (field, host array, its padded dirty rows)
        rows_arr = rows_p = None
        if dirty_rows is not None and len(dirty_rows) > 0:
            rows_arr = np.asarray(dirty_rows, np.int32)
            # pad rows to a pow2 bucket (repeat the first row), as the
            # reference does for its compiled scatter shapes
            pad = _pow2(len(rows_arr)) - len(rows_arr)
            rows_p = np.concatenate([rows_arr, np.repeat(rows_arr[:1], pad)])
        for f in fields(cluster):
            host = np.asarray(getattr(cluster, f.name))
            prev = self._host.get(f.name)
            if prev is host:
                continue  # identity: unchanged leaf reused by the encoder
            if (
                prev is not None
                and rows_arr is not None
                and f.name not in _NON_ROW_FIELDS
                and f.name in self._dev
                and prev.shape == host.shape
                and prev.dtype == host.dtype
                and host.ndim >= 1
                and len(rows_arr) <= host.shape[0] // _SCATTER_MAX_FRAC
            ):
                sub = host[rows_p]
                if np.array_equal(prev[rows_arr], sub[:len(rows_arr)]):
                    self._host[f.name] = host
                    continue
                # the delta that actually crosses the link: the padded
                # row-index vector + the padded row values
                note_transfer("h2d", "dirty_scatter",
                              rows_p.nbytes + sub.nbytes)
                scatter.append((f.name, host, sub))
                continue
            if (
                prev is None
                or prev.shape != host.shape
                or prev.dtype != host.dtype
                or not np.array_equal(prev, host)
            ):
                staged[f.name] = host
            else:
                self._host[f.name] = host  # content-equal: no upload needed
        if scatter:
            # the row indices and every changed field's rows in one copy
            vals = _h2d_packed([rows_p] + [v for _, _, v in scatter], device)
            rows_dev = vals[0].to(torch.int64)
            for (name, host, _), v in zip(scatter, vals[1:]):
                _scatter_rows(self._dev[name], rows_dev, v)
                self._host[name] = host
            self.scatter_rows.append(len(rows_arr))
        if staged:
            note_transfer("h2d", "snapshot_upload",
                          sum(a.nbytes for a in staged.values()))
            # copies that share no memory with the host arrays: the
            # dirty-row scatter writes into them in place, and the
            # encoder's snapshot arrays are immutable by its copy-on-write
            # contract
            self._dev.update(zip(staged, _h2d_packed(list(staged.values()),
                                                     device)))
            self._host.update(staged)
        from kubernetes_tpu_torch.ops.predicates import (
            build_node_pairs,
            has_node_pairs,
        )

        out = ClusterTensors(**self._dev)
        # the node-pair table, made again when the pair tensors change
        pairs = ("topo_pairs", "pair_topo_key")
        if (not has_node_pairs(out) or any(n in staged for n in pairs)
                or any(n in pairs for n, _, _ in scatter)):
            build_node_pairs(out, tuple(self._host[n] for n in pairs))
        return out


# ---------------------------------------------------------------- D2H fences
#
# Every device->host materialization the runtime performs goes through the
# helpers below, which report each sync that actually BLOCKS the calling
# thread to the registered listeners.

_SYNC_LISTENERS: List[Callable[[str], None]] = []


def on_blocking_sync(fn: Callable[[str], None]) -> Callable[[], None]:
    """Register a listener called with a tag on every blocking device sync
    performed through this module's fetch helpers.  Returns a remover."""
    _SYNC_LISTENERS.append(fn)

    def remove() -> None:
        try:
            _SYNC_LISTENERS.remove(fn)
        except ValueError:
            pass

    return remove


def _note_sync(tag: str) -> None:
    for fn in _SYNC_LISTENERS:
        fn(tag)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_fetch(x, tag: str = "fetch") -> np.ndarray:
    """The canonical BLOCKING device->host sync point, with the fence
    listeners notified first."""
    _note_sync(tag)
    faults.check(faults.SITE_FETCH)
    out = faults.corrupt(faults.SITE_FETCH, _to_host(x))
    note_transfer("d2h", tag, out.nbytes)
    return out


class _FetchWorker:
    """One persistent daemon thread draining AsyncFetch jobs: no per-cycle
    thread create/teardown, and a daemon thread cannot let a hung fetch
    block interpreter exit."""

    def __init__(self) -> None:
        import queue as _q

        self._jobs: Any = _q.SimpleQueue()
        self.thread = threading.Thread(
            target=self._drain, daemon=True, name="ktpu-torch-async-fetch"
        )
        self.thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        self._jobs.put(fn)

    def _drain(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                job()
            except BaseException:  # noqa: BLE001
                # A raising job must never kill the shared worker: every
                # fetch queued BEHIND it would hang forever at result().
                # AsyncFetch._run routes its own errors into the owning
                # handle; this guard covers foreign submit() callers.
                import traceback

                traceback.print_exc()


_FETCH_WORKER: "_FetchWorker | None" = None
_FETCH_WORKER_LOCK = threading.Lock()


def _fetch_worker() -> _FetchWorker:
    global _FETCH_WORKER
    w = _FETCH_WORKER
    if w is None or not w.thread.is_alive():  # first use, or post-fork
        with _FETCH_WORKER_LOCK:
            w = _FETCH_WORKER
            if w is None or not w.thread.is_alive():
                w = _FETCH_WORKER = _FetchWorker()
    return w


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    """The D2H side stream of a CUDA device (one per device, made once)."""
    s = _SIDE_STREAMS.get(device.index)
    if s is None:
        s = _SIDE_STREAMS[device.index] = torch.cuda.Stream(device=device)
    return s


class PinnedCopy:
    """A small device result copied into pinned host memory behind the work
    that produces it on the current stream, with a CUDA event after the
    copy: `result()` waits on that event only, so a caller that reads it an
    interval later finds it landed and never syncs the stream.  A CPU
    tensor is its own copy."""

    def __init__(self, t: torch.Tensor) -> None:
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return np.array(self._host.numpy())


class AsyncFetch:
    """Fetch-in-flight handle for a device result (the D2H half of the
    double-buffered commit pipeline).

    For a CUDA tensor the copy starts at once: a side stream waits for the
    stream that produces the tensor, copies it into a pinned host buffer
    (record_stream keeps the source alive for the side stream), and records
    a CUDA event; the shared fetch worker waits on that event, so the
    scheduling thread does not block while it dispatches the next batch or
    runs the previous batch's tail.  A CPU tensor or an array-like is
    materialized on the worker.

    result() is the ready-fence: it returns the host array, blocking only
    if the copy hasn't landed yet (and only that case is reported to the
    sync listeners).  A device error — asynchronous and sticky on CUDA,
    surfacing at the event wait — is caught on the worker and re-raised
    HERE, so the caller's classified-retry wrapper owns the batch's
    recovery.  `seconds` is the window from dispatch to copy-complete;
    `execute_seconds` the wait until the producing work was done and
    `materialize_seconds` the residual copy after it.

    `extras` are more tensors of the same launch (the quality top-k
    leaves) that ride the same copy: queued on the side stream before the
    copy event, so the fence waits on one copy for all of them and never
    on a compute sync; `extras_result()` returns them as host arrays after
    result()."""

    def __init__(self, dev, tag: str = "fetch", extras=()) -> None:
        self._dev = dev
        self._tag = tag
        self._extras = tuple(extras)
        self._extras_out: tuple = ()
        self._done = threading.Event()
        self._out: Any = None
        self._err: Any = None
        self.seconds = 0.0
        self.execute_seconds = 0.0
        self.materialize_seconds = 0.0
        self._t0 = time.monotonic()
        self._ready_ev = self._copy_ev = self._pinned = None
        if isinstance(dev, torch.Tensor) and dev.is_cuda:
            cur = torch.cuda.current_stream(dev.device)
            side = _side_stream(dev.device)
            self._ready_ev = torch.cuda.Event()
            self._ready_ev.record(cur)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._pinned = torch.empty(dev.shape, dtype=dev.dtype,
                                           pin_memory=True)
                self._pinned.copy_(dev, non_blocking=True)
                dev.record_stream(side)
                pinned = []
                for x in self._extras:
                    p = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    p.copy_(x, non_blocking=True)
                    x.record_stream(side)
                    pinned.append(p)
                self._extras = tuple(pinned)
                self._copy_ev = torch.cuda.Event()
                self._copy_ev.record(side)
            self._dev = None  # the side stream holds it until the copy
        _fetch_worker().submit(self._run)

    def _run(self) -> None:
        try:
            faults.check(faults.SITE_FETCH)
            t_wait0 = time.monotonic()
            if self._copy_ev is not None:
                self._ready_ev.synchronize()
                self.execute_seconds = time.monotonic() - t_wait0
                self._copy_ev.synchronize()
                host = np.array(self._pinned.numpy())
                extras = tuple(np.array(p.numpy()) for p in self._extras)
            else:
                host = _to_host(self._dev)
                extras = tuple(_to_host(x) for x in self._extras)
                self.execute_seconds = time.monotonic() - t_wait0
            self._out = faults.corrupt(faults.SITE_FETCH, host)
            self._extras_out = extras
            self.materialize_seconds = (
                time.monotonic() - t_wait0 - self.execute_seconds)
            note_transfer("d2h", self._tag, self._out.nbytes
                          + sum(x.nbytes for x in extras))
        except BaseException as e:  # noqa: BLE001 — re-raised in result()
            self._err = e
        finally:
            self._pinned = self._dev = None
            self._extras = ()
            self.seconds = time.monotonic() - self._t0
            self._done.set()

    def ready(self) -> bool:
        """Non-blocking fence probe: has the host copy landed?"""
        return self._done.is_set()

    def result(self) -> np.ndarray:
        """The ready-fence: host array, blocking (and reporting a blocking
        sync) only when the copy is still in flight.  Fence-site faults
        inject HERE — synchronously on the calling thread, where the
        scheduler's classified-retry wrapper owns recovery."""
        faults.check(faults.SITE_FENCE)
        if not self._done.is_set():
            _note_sync(self._tag)
            self._done.wait()
        if self._err is not None:
            raise self._err
        return self._out

    def extras_result(self) -> tuple:
        """The extras as host arrays, in the order given.  Call it after
        result(), which owns the fence, its fault sites and its errors."""
        if not self._done.is_set() or self._err is not None:
            raise RuntimeError("extras_result() before a successful "
                               "result()")
        return self._extras_out
