"""The capacity slice of the port against the JAX package, on CPU.

Everything here is bit for bit (integer and order work, f32 loads):
  * the what-if sweeps: the port's binpack_shapes (K9's twin, then K4's a
    lane) and binpack_shapes_compressed (K9's and K8's twins) against the
    JAX ones and each other, and `what_if` on integer and fractional
    backlogs (the fractional route takes the per-pod sweep);
  * the planner's stage 1 (runtime/capacity.py stage1) against the JAX
    `_stage1_kernel`; catalog_vectors and quantize_columns;
  * the planner against the JAX planner on the same cycles (mirroring
    tests/test_capacity.py's planner tests): every solve sample, the
    recommendation, the amortization, the pre-grouped backlog and the
    gauge it clears; a failed backlog walk is counted as a dropped solve;
  * a live port Scheduler with the planner every cycle against the JAX
    Scheduler on the live capacity cell at a small size (bindings, their
    order and every solve), and against itself with the planner off;
  * the two goldens chip_smoke.py reads (sizes and keys).
K8 and K9 run only on the card (chip_smoke.py phases K8, K9, 20, 21);
tests/test_torch_counts.py holds their twins on every case.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import binpack as jbin
from kubernetes_tpu.runtime import capacity as jcap
from kubernetes_tpu_torch import loop
from kubernetes_tpu_torch.models import binpack as tbin
from kubernetes_tpu_torch.runtime import capacity as tcap

from make_torch_golden import golden_path, jax_live_capacity
from torch_port_helpers import process_state_kept

R = 8


@pytest.fixture(autouse=True)
def _kept():
    with process_state_kept():
        yield


def _backlog(rng, n_classes, n_pods):
    base = np.zeros((n_classes, R), np.float32)
    base[:, 0] = rng.integers(50, 4000, n_classes)
    base[:, 1] = rng.integers(64, 8192, n_classes)
    base[:, 3] = 1.0
    return base[rng.integers(0, n_classes, n_pods)]


def _shapes(rng, s):
    shapes = np.zeros((s, R), np.float32)
    shapes[:, 0] = rng.integers(4000, 128001, s)
    shapes[:, 1] = rng.integers(16 * 1024, 512 * 1024 + 1, s)
    shapes[:, 3] = 110.0
    return shapes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(xs):
    return tuple(np.asarray(x) for x in xs)


# ------------------------------------------------------------ sweeps


@pytest.mark.parametrize("n_classes,n_pods,max_bins", [
    (4, 300, 64), (32, 240, 64), (200, 200, 64), (1, 7, 8), (8, 300, 4),
])
def test_sweeps_match_jax_and_each_other(n_classes, n_pods, max_bins):
    rng = np.random.default_rng(n_classes * 1000 + n_pods)
    reqs = _backlog(rng, n_classes, n_pods)
    shapes = _shapes(rng, 5)
    want = _np(jbin.binpack_shapes(reqs, shapes, max_bins=max_bins))
    got = _np(tbin.binpack_shapes(_t(reqs), _t(shapes), max_bins=max_bins))
    assert all(np.array_equal(w, g) and w.dtype == g.dtype
               for w, g in zip(want, got))
    classes, counts = tbin.compress_classes(reqs, pad_to_pow2=True)
    jc, jn = jbin.compress_classes(reqs, pad_to_pow2=True)
    assert np.array_equal(classes, jc) and np.array_equal(counts, jn)
    wantc = _np(jbin.binpack_shapes_compressed(classes, counts, shapes,
                                               max_bins=max_bins))
    gotc = _np(tbin.binpack_shapes_compressed(_t(classes), _t(counts),
                                              _t(shapes), max_bins=max_bins))
    assert all(np.array_equal(w, g) and w.dtype == g.dtype
               for w, g in zip(wantc, gotc))
    # the identity the reference pins: compressed == per pod
    assert all(np.array_equal(a, b) for a, b in zip(got, gotc))


def test_what_if_integer_and_fractional():
    rng = np.random.default_rng(7)
    reqs = _backlog(rng, 6, 120)
    shapes = _shapes(rng, 6)
    for compress in (True, False):
        assert tbin.what_if(reqs, shapes, max_bins=32, compress=compress,
                            device="cpu") == jbin.what_if(
            reqs, shapes, max_bins=32, compress=compress)
    frac = (reqs / 3.0).astype(np.float32)   # outside the count domain
    assert not tbin.int_exact(frac) and tbin.int_exact(reqs, shapes)
    assert tbin.what_if(frac, shapes, max_bins=32, device="cpu") == \
        jbin.what_if(frac, shapes, max_bins=32)


def test_what_if_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rng = np.random.default_rng(1)
    with pytest.raises((RuntimeError, AssertionError)):
        tbin.what_if(_backlog(rng, 2, 4), _shapes(rng, 2))


# ------------------------------------------------------------ stage 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage1_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 300))
    free = rng.integers(0, 4000, (n, R)).astype(np.float32)
    free[rng.random(n) < 0.3] = 0.0
    classes, counts = tbin.compress_classes(
        _backlog(rng, int(rng.integers(1, 40)), 300) / 4.0,
        pad_to_pow2=True)
    classes = np.ceil(classes).astype(np.float32)
    want = _np(jcap._stage1_kernel()(free, classes, counts))
    got = tcap.stage1(_t(free), _t(classes), _t(counts))
    assert np.array_equal(want[0], got[0].numpy())
    assert int(want[1]) == int(got[1])
    assert np.array_equal(want[2], got[2].numpy())


def test_catalog_vectors_and_quanta_match_jax():
    catalog = [{"name": "s", "cpu": "8", "memory": "32Gi", "pods": 64},
               {"name": "t", "cpu": "500m", "memory": "1Mi"},
               {"name": "u", "cpu": "96", "memory": "768Gi",
                "ephemeral-storage": "100Gi", "example.com/gpu": "8"}]
    col = {"example.com/gpu": 5}.get
    names, caps = tcap.catalog_vectors(catalog, R, res_col=col)
    jnames, jcaps = jcap.catalog_vectors(catalog, R, res_col=col)
    assert names == jnames and np.array_equal(caps, jcaps)
    assert caps[2, 5] == 8.0
    rng = np.random.default_rng(3)
    free = rng.random((50, R)) * 2.0 ** rng.integers(0, 40, R)
    q = tcap.quantize_columns(free, caps.astype(np.float64))
    assert np.array_equal(q, jcap.quantize_columns(
        free, caps.astype(np.float64)))
    assert (free.max(0) / q < 2 ** 24).all()


# --------------------------------------------------- planner vs planner


def _snapshot(n_nodes=6, cpu=8000.0, mem=32 * 2 ** 30, used_frac=0.9,
              n_empty=2):
    alloc = np.zeros((n_nodes, R), np.float32)
    alloc[:, 0] = cpu
    alloc[:, 1] = mem
    alloc[:, 3] = 110.0
    used = np.zeros((n_nodes, R), np.float32)
    busy = n_nodes - n_empty
    used[:busy, 0] = cpu * used_frac
    used[:busy, 1] = mem * used_frac
    used[:busy, 3] = 20.0
    return alloc, used, np.ones(n_nodes, bool)


def _samples(p):
    return [{k: v for k, v in x.items() if k != "time"}
            for x in p.debug_payload()["samples"]]


def _pair(**kw):
    return (jcap.CapacityPlanner(**kw),
            tcap.CapacityPlanner(device="cpu", **kw))


def _run_both(cycles, **kw):
    """Feed both planners the same on_cycle calls; returns them."""
    jp, tp = _pair(**kw)
    for args, kwargs in cycles:
        jp.on_cycle(*args, **kwargs)
        tp.on_cycle(*args, **kwargs)
    jp.finalize()
    tp.finalize()
    return jp, tp


def test_planner_scale_up_matches_jax():
    snap = _snapshot()
    backlog = np.zeros((500, R), np.float32)
    backlog[:, 0] = 1000.0
    backlog[:, 1] = 4 * 2 ** 30
    backlog[:, 3] = 1.0
    jp, tp = _run_both([((1, lambda cap: backlog, snap), {})],
                       interval_cycles=1, max_bins=256)
    assert _samples(tp) == _samples(jp)
    reco = tp.recommendation
    assert reco["absorbed_existing"] > 0 and reco["scale_up"] is not None
    assert reco["overflow_pods"] == 500 - reco["absorbed_existing"]
    assert tp.summary()["solves_dropped"] == 0


def test_planner_drainable_matches_jax():
    snap = _snapshot(n_empty=2)
    names = {"node_names": lambda: {i: f"node-{i}" for i in range(6)}}
    jp, tp = _run_both(
        [((1, lambda cap: np.zeros((0, R), np.float32), snap), names)],
        interval_cycles=1)
    assert _samples(tp) == _samples(jp)
    assert set(tp.recommendation["drainable"]["nodes"]) == {"node-4",
                                                            "node-5"}


def test_planner_amortization_and_ring_match_jax():
    snap = _snapshot()
    rng = np.random.default_rng(5)
    backlogs = [_backlog(rng, 3, int(rng.integers(1, 60))) for _ in range(9)]
    for b in backlogs:
        b[:, 1] *= 2 ** 20
    cycles = [((c, (lambda cap, b=b: b), snap), {})
              for c, b in enumerate(backlogs)]
    jp, tp = _pair(interval_cycles=2, ring_capacity=3)
    for i, (args, kwargs) in enumerate(cycles):
        jp.on_cycle(*args, **kwargs)
        tp.on_cycle(*args, **kwargs)
        # dispatched on one due cycle, read back on the next
        assert tp.solves_total == jp.solves_total, i
        assert tp.recommendation == jp.recommendation or (
            {k: v for k, v in tp.recommendation.items() if k != "time"}
            == {k: v for k, v in jp.recommendation.items() if k != "time"})
    jp.finalize()
    tp.finalize()
    assert _samples(tp) == _samples(jp) and len(_samples(tp)) == 3
    assert tp.debug_payload(limit=2)["samples"] == \
        tp.debug_payload()["samples"][-2:]


def test_planner_pregrouped_backlog_clears_stale_gauge():
    from kubernetes_tpu_torch.utils import metrics as m

    snap = _snapshot(n_empty=0)
    vec = np.zeros((1, R), np.float32)
    vec[0, 0] = 1000.0
    vec[0, 1] = 4 * 2 ** 30
    vec[0, 3] = 1.0
    jp, tp = _run_both([
        ((1, lambda cap: (vec, np.asarray([300])), snap), {}),
        ((2, lambda cap: np.zeros((0, R), np.float32), snap), {}),
    ], interval_cycles=1, max_bins=256)
    s = _samples(tp)
    assert s == _samples(jp) and s[0]["backlog_pods"] == 300
    first = s[0]["scale_up"]["shape"]
    assert tp.recommendation["scale_up"] is None
    assert (f'scheduler_capacity_recommended_nodes{{shape="{first}"}}'
            not in m.REGISTRY.expose())


def test_planner_failed_walk_is_a_counted_drop():
    """A raising backlog walk costs one solve, never the cycle: counted in
    solves_dropped (the reference drops it silently)."""
    seen = {}

    def walk(cap):
        seen["cap"] = cap
        raise RuntimeError("queue exploded")

    p = tcap.CapacityPlanner(interval_cycles=1, backlog_cap=123,
                             device="cpu")
    p.on_cycle(1, walk, _snapshot())
    assert seen["cap"] == 123
    assert p.solves_total == 0 and p.summary()["solves_dropped"] == 1


def test_planner_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="A11"):
        tcap.CapacityPlanner(mesh=object(), device="cpu")


# ------------------------------------------------------ live cell


def test_live_capacity_cell_matches_jax_scheduler():
    """The live capacity cell at 32 nodes, 144 pods, batch 32, a catalog
    of 8 shapes, a solve every cycle: the port's bindings, order and
    every solve equal the JAX Scheduler's; planner off, the same
    placements."""
    n, pods, batch, shapes = 32, 144, 32, 8
    hosts, order, _, _, jsched = jax_live_capacity(n, pods, batch,
                                                   shapes=shapes)
    want = loop.capacity_arrays(jsched.capacity.debug_payload()["samples"])
    backlog, caps = loop.what_if_workload()
    reqs = loop.capacity_requests(backlog, pods, batch, batch)
    nodes = loop.bench_nodes(n)
    kw = dict(device="cpu", make_pending=lambda i: loop.capacity_pod(i, reqs),
              running=loop.capacity_running_pods(nodes))
    res = loop.run_live(nodes, pods, batch, capacity_planner=True,
                        capacity_interval_cycles=1,
                        node_shape_catalog=loop.shape_catalog(caps[:shapes]),
                        **kw)
    assert np.array_equal(res["hosts"], hosts)
    assert np.array_equal(res["bind_order"], order)
    got = loop.capacity_arrays(res["capacity_samples"])
    assert np.array_equal(got["capacity_samples"], want["capacity_samples"])
    assert res["capacity"]["solves_dropped"] == 0
    solves = [json.loads(x) for x in got["capacity_samples"]]
    assert max(x["overflow_pods"] for x in solves) > 0
    off = loop.run_live(nodes, pods, batch, **kw)
    assert np.array_equal(off["hosts"], res["hosts"])
    assert np.array_equal(off["bind_order"], res["bind_order"])


# ----------------------------------------------------------- goldens


def test_capacity_goldens_sizes_and_keys():
    wi = np.load(golden_path("what_if"))
    assert set(wi.files) == {"bins", "ok", "max_bins", "lanes"}
    assert int(wi["lanes"]) >= 256 and wi["bins"].shape == (int(wi["lanes"]),)
    assert wi["ok"].dtype == bool and int(wi["max_bins"]) == 2048
    assert 0 < int(wi["ok"].sum()) < int(wi["lanes"])
    lc = np.load(golden_path("live_capacity"))
    assert {"hosts", "bind_order", "unschedulable", "capacity_samples",
            "nodes", "pods", "batch"} <= set(lc.files)
    assert lc["hosts"].shape == (int(lc["pods"]) + int(lc["batch"]),)
    solves = [json.loads(x) for x in lc["capacity_samples"]]
    assert solves and max(x["overflow_pods"] for x in solves) > 0
    assert max(x["absorbed_existing"] for x in solves) > 0
    for name in ("what_if", "live_capacity"):
        assert os.path.getsize(golden_path(name)) < (1 << 20)
