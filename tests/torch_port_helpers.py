"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

`twin_world` draws one randomized cluster with tests/fixtures.py twice from
the same seed: once with the JAX package's object factory and once with the
port's, so both encoders see objects built from identical arguments.

Importing it caps torch's intra-op threads at TORCH_TEST_THREADS: the tests
run under pytest-xdist with several workers, and torch's default (one
thread per core in every worker) oversubscribes the cores and slows the
wall-clock tests of the JAX package that share the machine.  A run of the
whole suite imports every test module in every process (pytest-xdist's
workers each collect them all), so the cap holds there in every worker.
"""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

import fixtures
from kubernetes_tpu.codec import SnapshotEncoder as JaxEncoder
from kubernetes_tpu_torch.api import factory as port_factory
from kubernetes_tpu_torch.codec import SnapshotEncoder as PortEncoder

UNSCHED_KEY = "node.kubernetes.io/unschedulable"
TORCH_TEST_THREADS = 2

torch.set_num_threads(min(TORCH_TEST_THREADS, torch.get_num_threads()))


@contextmanager
def port_factory_in_fixtures():
    """Route fixtures.py's make_node/make_pod to the port's factory."""
    with mock.patch.object(fixtures, "make_node", port_factory.make_node), \
            mock.patch.object(fixtures, "make_pod", port_factory.make_pod):
        yield


def _draw(seed, n_nodes, n_existing, n_pending, with_affinity):
    rng = np.random.default_rng(seed)
    nodes, existing, services = fixtures.random_cluster(
        rng, n_nodes=n_nodes, n_pods=n_existing, with_affinity=with_affinity)
    pending = [fixtures.random_pending_pod(rng, i, with_affinity)
               for i in range(n_pending)]
    return nodes, existing, services, pending


def _encoder(cls, nodes, existing, services):
    enc = cls()
    for n in nodes:
        enc.add_node(n)
    for p in existing:
        enc.add_pod(p)
    for ns, sel in services:
        enc.add_spread_selector(ns, sel)
    return enc


def twin_world(seed, n_nodes=64, n_existing=96, n_pending=48,
               with_affinity=True):
    """(jax_encoder, port_encoder, jax_pending_pods, port_pending_pods)."""
    jn, je, js, jp = _draw(seed, n_nodes, n_existing, n_pending, with_affinity)
    with port_factory_in_fixtures():
        pn, pe, ps, pp = _draw(seed, n_nodes, n_existing, n_pending,
                               with_affinity)
    return (_encoder(JaxEncoder, jn, je, js), _encoder(PortEncoder, pn, pe, ps),
            jp, pp)


def engine_keys(enc):
    """The engine-maker keywords both packages take from an encoder."""
    return dict(unsched_taint_key=enc.interner.intern(UNSCHED_KEY),
                zone_key_id=enc.getzone_key)


def assert_fields_equal(a, b, cls, what=""):
    """Every dataclass field of a and b (numpy-convertible) identical, NaN
    in the same places."""
    from dataclasses import fields

    for f in fields(cls):
        x = np.asarray(getattr(a, f.name))
        y = np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, (what, f.name, x.dtype, y.dtype)
        assert x.shape == y.shape, (what, f.name, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (
            what, f.name)


@contextmanager
def process_state_kept():
    """Put back, on leaving, every process-wide default both packages'
    runtimes keep (telemetry hub, timeline, quality and performance
    observatories, ledger, capacity planner, flight recorder, autoscaler)
    and both timeline anomaly counters' children, as they were on
    entering.  A Scheduler of either package installs its observers as
    process defaults, and a timeline rule that fires counts into its
    package's counter under a series name holding quotes; a test that
    built one leaves neither behind for a later test file in the same
    worker process."""
    import importlib

    registries = []
    for pkg in ("kubernetes_tpu", "kubernetes_tpu_torch"):
        for name in ("telemetry", "timeline", "quality", "perfobs", "ledger",
                     "capacity", "flightrecorder", "autoscaler"):
            try:
                mod = importlib.import_module(f"{pkg}.runtime.{name}")
            except ImportError:
                continue          # the port has no copy of this module
            registries.append(mod._DEFAULT)
    counters = [importlib.import_module(f"{pkg}.utils.metrics")
                .TIMELINE_ANOMALIES
                for pkg in ("kubernetes_tpu", "kubernetes_tpu_torch")]
    held = [(d._default, dict(d._replicas)) for d in registries]
    children = [dict(c._children) for c in counters]
    try:
        yield
    finally:
        for d, (default, replicas) in zip(registries, held):
            with d._lock:
                d._default, d._replicas = default, replicas
        for c, kids in zip(counters, children):
            with c._lock:
                c._children = kids
