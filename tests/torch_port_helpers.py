"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

`twin_world` draws one randomized cluster with tests/fixtures.py twice from
the same seed: once with the JAX package's object factory and once with the
port's, so both encoders see objects built from identical arguments.
"""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import numpy as np

import fixtures
from kubernetes_tpu.codec import SnapshotEncoder as JaxEncoder
from kubernetes_tpu_torch.api import factory as port_factory
from kubernetes_tpu_torch.codec import SnapshotEncoder as PortEncoder

UNSCHED_KEY = "node.kubernetes.io/unschedulable"


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
