"""The port's live-cycle transfer layer (kubernetes_tpu_torch/codec/
transfer.py) and its CUDA fault classifier, on CPU.

Mirrors tests/test_transfer.py (unchanged fields reused, a regrow, the
shared fetch worker surviving a raising job, an error routed into its
handle, invalidate forcing a full upload) and
tests/test_batched_commit.py's dirty-row scatter: the resident snapshot
after scatters equals the host snapshot through commits, node updates,
removes and adds, and a fresh full snapshot at the end.  Scatters write the resident tensors in place and never
the encoder's host arrays.  codec/faults.py's CUDA classifier is held on
synthetic exceptions of each class.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.factory import make_node, make_pod
from kubernetes_tpu_torch.codec import SnapshotEncoder, faults, transfer
from kubernetes_tpu_torch.codec.transfer import AsyncFetch, DeviceSnapshotCache

from fixtures import TEST_DIMS, ZONE_KEY


def _encoder(n=4, **kw):
    enc = SnapshotEncoder(TEST_DIMS)
    for i in range(n):
        enc.add_node(make_node(f"n{i}", cpu="4", mem="8Gi", **kw))
    return enc


def _assert_resident_equals(dev, full, msg=""):
    for f in dataclasses.fields(full):
        np.testing.assert_array_equal(
            getattr(dev, f.name).numpy(), np.asarray(getattr(full, f.name)),
            err_msg=f"{msg}: field {f.name}")


def test_device_snapshot_cache_reuses_unchanged_fields():
    enc = _encoder()
    cache = DeviceSnapshotCache("cpu")
    d1 = cache.update(enc.snapshot())
    # a pod commit moves requested/nonzero but not the label/taint tensors
    enc.add_pod(make_pod("p0", cpu="500m", mem="512Mi", node_name="n1"))
    x0 = transfer.transfer_totals()
    d2 = cache.update(enc.snapshot())
    assert d2.label_keys is d1.label_keys          # resident tensor reused
    assert d2.taint_key is d1.taint_key
    assert d2.requested is not d1.requested        # changed -> re-uploaded
    assert d2.requested[enc.node_rows["n1"], 0] == 500.0
    _assert_resident_equals(d2, enc.snapshot(), "after a commit")
    d = transfer.transfer_delta(x0)
    assert d["h2d/snapshot_upload"]["calls"] == 1 and not cache.scatter_rows


def test_device_snapshot_cache_handles_regrow():
    enc = _encoder(1)
    cache = DeviceSnapshotCache("cpu")
    d1 = cache.update(enc.snapshot())
    n1 = d1.valid.shape[0]
    for i in range(1, 3 * n1):  # force at least one node-arena regrow
        enc.add_node(make_node(f"n{i}", cpu="4", mem="8Gi"))
    d2 = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    assert d2.valid.shape[0] > n1
    assert int(d2.valid.sum()) == 3 * n1
    _assert_resident_equals(d2, enc.snapshot(full=True), "after a regrow")


def test_device_snapshot_cache_dirty_row_scatter():
    """update(cluster, dirty_rows=...) leaves the resident contents equal to
    a fresh full upload through adds/commits/updates/removes."""
    enc = SnapshotEncoder(TEST_DIMS)
    for i in range(8):
        enc.add_node(make_node(f"n{i}", cpu="4", mem="8Gi",
                               labels={ZONE_KEY: f"z-{i % 2}"}))
    cache = DeviceSnapshotCache("cpu")

    def sync_and_check(msg):
        # against the incremental host snapshot: a full=True snapshot here
        # would restart the encoder's dirty-row stream and skip the scatter
        snap = enc.snapshot()
        dev = cache.update(snap, dirty_rows=enc.take_dirty_rows())
        _assert_resident_equals(dev, snap, msg)
        return dev

    sync_and_check("initial (full upload)")
    enc.add_pod(make_pod("p0", cpu="500m", mem="512Mi", node_name="n3"))
    sync_and_check("single-row commit")
    enc.add_pods([
        make_pod(f"q{i}", cpu="100m", mem="64Mi", node_name=f"n{i}")
        for i in range(2)
    ])
    sync_and_check("two-row batched commit")
    enc.update_node(make_node("n5", cpu="2", mem="4Gi",
                              labels={ZONE_KEY: "z-7"}))
    sync_and_check("node update")
    enc.remove_pod(make_pod("q0", node_name="n0"))
    sync_and_check("pod remove")
    enc.remove_node("n7")
    sync_and_check("node remove")
    enc.add_node(make_node("n8", cpu="2", mem="4Gi",
                           labels={ZONE_KEY: "z-1"}))
    dev = sync_and_check("node add (row reuse)")
    assert len(cache.scatter_rows) >= 4
    _assert_resident_equals(dev, enc.snapshot(full=True), "full at the end")


def test_scatter_never_writes_the_encoders_arrays():
    """The resident tensors share no memory with the encoder's snapshot
    arrays: a scatter leaves an older host snapshot untouched."""
    enc = _encoder(8)
    cache = DeviceSnapshotCache("cpu")
    s0 = enc.snapshot()
    d0 = cache.update(s0, dirty_rows=enc.take_dirty_rows())
    before = np.array(s0.requested, copy=True)
    enc.add_pod(make_pod("p", cpu="1", mem="1Gi", node_name="n2"))
    d1 = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    # scattered in place: the resident tensor object stays
    assert cache.scatter_rows == [1] and d1.requested is d0.requested
    assert d1.requested[enc.node_rows["n2"], 0] == 1000.0
    np.testing.assert_array_equal(np.asarray(s0.requested), before)


def test_scatter_is_accounted_and_bounded():
    """The dirty rows and their values cross as one padded delta; a dirty
    set past N/4 uploads the changed fields whole."""
    enc = _encoder(16)
    cache = DeviceSnapshotCache("cpu")
    cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    x0 = transfer.transfer_totals()
    enc.add_pods([make_pod(f"a{i}", cpu="100m", node_name=f"n{i}")
                  for i in range(3)])
    cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    d = transfer.transfer_delta(x0)
    assert d["h2d/dirty_scatter"]["calls"] >= 1
    assert "h2d/snapshot_upload" not in d
    assert cache.scatter_rows == [3]
    N = enc.snapshot().n_nodes
    x1 = transfer.transfer_totals()
    enc.add_pods([make_pod(f"b{i}", cpu="100m", node_name=f"n{i}")
                  for i in range(N // 4 + 1)])
    dev = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    d = transfer.transfer_delta(x1)
    assert d["h2d/snapshot_upload"]["calls"] == 1
    assert "h2d/dirty_scatter" not in d and cache.scatter_rows == [3]
    _assert_resident_equals(dev, enc.snapshot(full=True), "past N/4")


def test_device_snapshot_cache_invalidate_forces_full_reupload():
    enc = _encoder()
    cache = DeviceSnapshotCache("cpu")
    d1 = cache.update(enc.snapshot())
    assert cache.resident(("requested", "valid"))[0] is d1.requested
    cache.invalidate()
    assert cache.resident(("requested",)) is None
    d2 = cache.update(enc.snapshot())
    assert d2.label_keys is not d1.label_keys
    np.testing.assert_array_equal(d2.requested.numpy(),
                                  d1.requested.numpy())


def test_faulted_update_reuploads_what_is_missing():
    """A snapshot_update fault leaves the cache as it was; the retry with
    the same dirty rows lands the same contents."""
    enc = _encoder(8)
    cache = DeviceSnapshotCache("cpu")
    cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    enc.add_pod(make_pod("p", cpu="1", node_name="n4"))
    snap, rows = enc.snapshot(), enc.take_dirty_rows()
    inj = faults.FaultInjector()
    inj.arm(faults.SITE_SNAPSHOT_UPDATE, count=1)
    remove = faults.install_injector(inj)
    try:
        with pytest.raises(faults.TransientDeviceError):
            cache.update(snap, dirty_rows=rows)
        dev = cache.update(snap, dirty_rows=rows)
    finally:
        remove()
    _assert_resident_equals(dev, enc.snapshot(full=True), "after retry")


# ------------------------------------------------------- fetch worker


def test_fetch_worker_survives_raising_job():
    """A job that raises on the shared fetch worker must not kill it: a
    fetch queued behind the poison job still completes."""
    w = transfer._fetch_worker()
    w.submit(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    f = AsyncFetch(np.arange(8, dtype=np.int32))
    t0 = time.monotonic()
    out = f.result()
    assert time.monotonic() - t0 < 2.0
    np.testing.assert_array_equal(out, np.arange(8, dtype=np.int32))
    assert w.thread.is_alive()


def test_async_fetch_routes_job_error_into_handle():
    """An error raised while materializing re-raises at result() — the
    owning handle, not the worker thread, owns the failure."""

    class Evil:
        def __array__(self, *a, **k):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    f = AsyncFetch(Evil())
    with pytest.raises(RuntimeError) as ei:
        f.result()
    assert faults.classify_device_error(ei.value) == faults.FAULT_PERSISTENT
    g = AsyncFetch(torch.ones(3, dtype=torch.int32))
    np.testing.assert_array_equal(g.result(), np.ones(3, np.int32))
    assert g.ready() and g.seconds >= g.execute_seconds >= 0.0


def test_async_fetch_fence_fault_and_sync_listener():
    """A fence-site fault fires at result() on the calling thread; a fetch
    still in flight there reports one blocking sync."""
    seen = []
    remove_l = transfer.on_blocking_sync(seen.append)
    inj = faults.FaultInjector()
    inj.arm(faults.SITE_FENCE, count=1)
    remove_i = faults.install_injector(inj)
    try:
        f = AsyncFetch(torch.arange(4, dtype=torch.int32))
        with pytest.raises(faults.TransientDeviceError):
            f.result()
        np.testing.assert_array_equal(f.result(), np.arange(4))
    finally:
        remove_i()
        remove_l()
    assert set(seen) <= {"fetch"}


@pytest.mark.cuda
def test_async_fetch_side_stream_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.arange(2048, dtype=torch.int32, device="cuda") * 3
    f = AsyncFetch(x)
    np.testing.assert_array_equal(f.result(), np.arange(2048) * 3)
    assert f.materialize_seconds >= 0.0


# ----------------------------------------------- the CUDA classifier

CLASSIFY_CASES = [
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     faults.FAULT_TRANSIENT),
    (type("OutOfMemoryError", (RuntimeError,), {})("no room"),
     faults.FAULT_TRANSIENT),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     faults.FAULT_PERSISTENT),
    (type("AcceleratorError", (RuntimeError,), {})(
        "CUDA error: device-side assert triggered"), faults.FAULT_PERSISTENT),
    (RuntimeError("CUDA error: unspecified launch failure"),
     faults.FAULT_PERSISTENT),
    (RuntimeError("CUDA error: misaligned address"), faults.FAULT_PERSISTENT),
    (faults.TransientDeviceError("injected"), faults.FAULT_TRANSIENT),
    (faults.PersistentDeviceError("injected"), faults.FAULT_PERSISTENT),
    (faults.CorruptedFetchError("rows out of range"), faults.FAULT_TRANSIENT),
    (RuntimeError("CUDA error: invalid argument"), None),
    (RuntimeError("shape mismatch"), None),
    (ValueError("CUDA out of memory"), None),
    (KeyError("node-3"), None),
]


@pytest.mark.parametrize("err,want", CLASSIFY_CASES,
                         ids=[f"{type(e).__name__}-{i}"
                              for i, (e, _) in enumerate(CLASSIFY_CASES)])
def test_classify_cuda_errors(err, want):
    assert faults.classify_device_error(err) == want
    if not isinstance(err, faults.DeviceFault):
        assert faults.classify_cuda_error(err) == want
