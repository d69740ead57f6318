"""Nominated pods in the PyTorch port against the JAX package, on CPU, bit
for bit.

Both port engines take the same JAX-encoded batches and NominatedState as
both (jitted) JAX engines and must give their hosts, committed requested /
nonzero_req columns, rounds and redo flags: a nominated preemptor's resource
claim blocks a lower-priority pod and does not block a higher-priority one,
nominations ride along with in-batch affinity, and a 2-slot world redoes a
batch with nominations present.  encode_nominated and
encode_nominated_block (host ports, anti-affinity in both directions) are
held cell for cell against the JAX functions on twin encoders.
"""

from __future__ import annotations

import numpy as np
import pytest

from kubernetes_tpu.api.factory import make_node as jax_node
from kubernetes_tpu.api.factory import make_pod as jax_pod
from kubernetes_tpu.codec import SnapshotEncoder as JaxEncoder
from kubernetes_tpu.models import batched as jb
from kubernetes_tpu.models.speculative import (
    make_speculative_scheduler as jax_spec,
)
from kubernetes_tpu_torch.api.factory import make_node as port_node
from kubernetes_tpu_torch.api.factory import make_pod as port_pod
from kubernetes_tpu_torch.codec import SnapshotEncoder as PortEncoder
from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.schema import (
    cluster_to_torch,
    pods_to_torch,
    ports_to_torch,
)
from kubernetes_tpu_torch.models import batched as pb
from kubernetes_tpu_torch.models.speculative import (
    make_speculative_scheduler as port_spec,
)

from fixtures import HOSTNAME_KEY, TEST_DIMS, ZONE_KEY
from torch_port_helpers import engine_keys

MAKERS = {"sequential": (jb.make_sequential_scheduler,
                         pb.make_sequential_scheduler),
          "speculative": (jax_spec, port_spec)}
ENGINES = sorted(MAKERS)


def _anti(app, key=HOSTNAME_KEY):
    return {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": app}},
            "topologyKey": key}]}}


def _encoder(nodes, existing=()):
    enc = JaxEncoder(TEST_DIMS)
    for n in nodes:
        enc.add_node(n)
    for p in existing:
        enc.add_pod(p)
    return enc


def _both(enc, pods, nominated_pairs, engine, extra_mask=None,
          with_affinity=False, last=0):
    """One batch through the JAX engine and the port's on the same
    JAX-encoded inputs (the NominatedState the JAX package's, read by the
    port field by field); every output compared.  Returns the hosts."""
    jmake, pmake = MAKERS[engine]
    kw = engine_keys(enc)
    jfn, pfn = jmake(**kw), pmake(device="cpu", **kw)
    aff = jb.encode_batch_affinity(enc, pods) if with_affinity else None
    b = enc.encode_pods(pods)
    ports = jb.encode_batch_ports(enc, pods)
    nom = jb.encode_nominated(enc, nominated_pairs)
    cluster = enc.snapshot()
    jh, jc = jfn(cluster, b, ports, np.int32(last), nom, extra_mask, None,
                 aff)
    th, tc = pfn(cluster_to_torch(cluster, "cpu"), pods_to_torch(b, "cpu"),
                 ports_to_torch(ports, "cpu"), last, nom, extra_mask, None,
                 aff)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(jc.requested),
                                  tc.requested.numpy())
    np.testing.assert_array_equal(np.asarray(jc.nonzero_req),
                                  tc.nonzero_req.numpy())
    if engine == "speculative":
        assert pfn.last_redo == bool(np.asarray(jfn.last_redo))
        assert pfn.last_rounds == int(jfn.last_rounds)
    return th.numpy()[:len(pods)], pfn


@pytest.mark.parametrize("engine", ENGINES)
def test_nominated_resources_block_placement(engine):
    """tests/test_speculative.py's scenario: a preemptor (priority 100)
    nominated onto "big" claiming 3 cpu keeps a 2-cpu priority-0 pod off
    "big" (it fits nowhere else), while a priority-200 pod ignores the
    claim and lands on "big"."""
    enc = _encoder([jax_node("big", cpu="4", mem="8Gi"),
                    jax_node("small", cpu="1", mem="2Gi")])
    pairs = [(jax_pod("preemptor", cpu="3", mem="1Gi", priority=100), "big")]
    h, _ = _both(enc, [jax_pod("victim-squeezer", cpu="2", mem="1Gi")],
                 pairs, engine)
    assert h[0] == -1
    h, _ = _both(enc, [jax_pod("boss", cpu="2", mem="1Gi", priority=200)],
                 pairs, engine)
    assert h[0] == enc.node_rows["big"]


@pytest.mark.parametrize("engine", ENGINES)
def test_lower_priority_nomination_does_not_block(engine):
    """A nomination below the pod's priority does not join pass one: the
    pod takes the claimed headroom; at equal priority it does not."""
    enc = _encoder([jax_node("only", cpu="4", mem="8Gi")])
    pairs = [(jax_pod("low", cpu="3", mem="1Gi", priority=5), "only")]
    h, _ = _both(enc, [jax_pod("p", cpu="2", mem="1Gi", priority=10)],
                 pairs, engine)
    assert h[0] == enc.node_rows["only"]
    h, _ = _both(enc, [jax_pod("q", cpu="2", mem="1Gi", priority=5)],
                 pairs, engine)
    assert h[0] == -1


@pytest.mark.parametrize("engine", ENGINES)
def test_nominations_in_a_mixed_batch(engine):
    """Several nominations (one on an unknown node, dropped) over a batch
    of mixed priorities and sizes: the claims bound in-batch commits too."""
    nodes = [jax_node(f"n{i}", cpu="4", mem="8Gi",
                      labels={ZONE_KEY: f"z{i % 2}"}) for i in range(5)]
    enc = _encoder(nodes)
    pairs = [(jax_pod("k0", cpu="3500m", mem="1Gi", priority=50), "n0"),
             (jax_pod("k1", cpu="2", mem="6Gi", priority=50), "n1"),
             (jax_pod("k2", cpu="1", mem="1Gi", priority=0), "n2"),
             (jax_pod("k3", cpu="1", mem="1Gi", priority=99), "gone")]
    pods = [jax_pod(f"p{i}", cpu=f"{(i % 3 + 1) * 500}m", mem="1Gi",
                    priority=(0, 50, 100)[i % 3]) for i in range(12)]
    _both(enc, pods, pairs, engine)


def _twins():
    """(JAX encoder, port encoder) over the same 6-node, 3-zone fleet."""
    encs = []
    for make_node, cls in ((jax_node, JaxEncoder), (port_node, PortEncoder)):
        enc = cls(TEST_DIMS)
        for i in range(6):
            enc.add_node(make_node(f"n{i}", cpu="4", mem="8Gi",
                                   labels={ZONE_KEY: f"z{i % 3}",
                                           HOSTNAME_KEY: f"n{i}"}))
        encs.append(enc)
    return encs


def _block_world(make_pod):
    """Nominated pods with a host port and anti terms (hostname and zone)
    against batch pods with ports, labels and their own anti terms, across
    priorities."""
    noms = [
        (make_pod("k-port", cpu="100m", priority=10,
                  ports=[{"containerPort": 80, "hostPort": 8080}]), "n0"),
        (make_pod("k-anti-host", cpu="100m", priority=10,
                  labels={"app": "k"}, affinity=_anti("web")), "n1"),
        (make_pod("k-anti-zone", cpu="100m", priority=10,
                  labels={"app": "k"}, affinity=_anti("db", ZONE_KEY)),
         "n2"),
        (make_pod("k-low", cpu="100m", priority=0, labels={"app": "web"},
                  ports=[{"containerPort": 80, "hostPort": 9090}]), "n3"),
        (make_pod("k-lost", cpu="100m", priority=10), "nowhere"),
    ]
    pods = [
        make_pod("web-0", cpu="100m", labels={"app": "web"}),
        make_pod("port-0", cpu="100m",
                 ports=[{"containerPort": 80, "hostPort": 8080}]),
        make_pod("port-ip", cpu="100m", ports=[{
            "containerPort": 80, "hostPort": 8080, "hostIP": "10.0.0.1"}]),
        make_pod("db-0", cpu="100m", labels={"app": "db"}),
        make_pod("hater", cpu="100m", labels={"app": "x"},
                 affinity=_anti("k", ZONE_KEY)),
        make_pod("hi-prio", cpu="100m", priority=50, labels={"app": "web"},
                 ports=[{"containerPort": 80, "hostPort": 8080}]),
        make_pod("low-port", cpu="100m",
                 ports=[{"containerPort": 80, "hostPort": 9090}]),
    ]
    return noms, pods


def test_encode_nominated_block_matches_jax():
    """Cell for cell on twin encoders: the host-port claim, the nominated
    pods' anti terms over their domain (hostname and zone), the batch
    pods' anti terms against nominated pods, and the priority rule."""
    jenc, penc = _twins()
    jnoms, jpods = _block_world(jax_pod)
    pnoms, ppods = _block_world(port_pod)
    jb_, pb_ = (enc.encode_pods(p) for enc, p in ((jenc, jpods),
                                                  (penc, ppods)))
    N = jenc.snapshot().n_nodes
    jm = jb.encode_nominated_block(jenc, jnoms, jpods, jb_.n_pods, N)
    pm = pb.encode_nominated_block(penc, pnoms, ppods, pb_.n_pods, N)
    assert jm is not None and pm.dtype == jm.dtype and pm.shape == jm.shape
    np.testing.assert_array_equal(pm, jm)
    # each rule fired somewhere (so none is vacuously equal)
    r = penc.node_rows
    assert pm[1, r["n0"]] and pm[2, r["n0"]]              # port claim
    assert pm[0, r["n1"]] and not pm[0, r["n4"]]           # hostname anti
    zone_rows = [r[f"n{i}"] for i in (2, 5)]
    assert pm[3, zone_rows].all()                          # zone anti
    assert pm[4, zone_rows + [r["n1"], r["n4"]]].all()     # pod's own anti
    assert not pm[5].any()                                 # priority rule
    assert pm[6, r["n3"]] and pm[6].sum() == 1             # equal priority
    jn = jb.encode_nominated(jenc, jnoms)
    pn = pb.encode_nominated(penc, pnoms)
    for f in ("node", "prio", "req"):
        np.testing.assert_array_equal(getattr(pn, f), getattr(jn, f),
                                      err_msg=f)
    assert pb.encode_nominated(penc, []) is None
    assert pb.encode_nominated_block(penc, [], ppods, pb_.n_pods, N) is None


@pytest.mark.parametrize("engine", ENGINES)
def test_nominated_block_as_extra_mask(engine):
    """The block folded into extra_mask the way the live cycle folds it,
    with the resource claims: both engines agree with JAX."""
    jenc, _ = _twins()
    noms, pods = _block_world(jax_pod)
    b = jenc.encode_pods(pods)
    block = jb.encode_nominated_block(jenc, noms, pods, b.n_pods,
                                      jenc.snapshot().n_nodes)
    _both(jenc, pods, noms, engine, extra_mask=~block)


@pytest.mark.parametrize("engine", ENGINES)
def test_nominations_with_in_batch_affinity(engine):
    """Nominations and in-batch anti-affinity in one batch: the claims hold
    while the anti group spreads one per node."""
    nodes = [jax_node(f"n{i}", cpu="2", mem="8Gi",
                      labels={ZONE_KEY: f"z{i % 2}"}) for i in range(6)]
    enc = _encoder(nodes)
    pairs = [(jax_pod("k0", cpu="1950m", mem="1Gi", priority=10), "n0"),
             (jax_pod("k1", cpu="1950m", mem="1Gi", priority=10), "n3")]
    pods = [jax_pod(f"s{i}", cpu="100m", labels={"app": "s"},
                    affinity=_anti("s")) for i in range(5)]
    pods += [jax_pod(f"f{i}", cpu="500m") for i in range(3)]
    h, _ = _both(enc, pods, pairs, engine, with_affinity=True)
    rows = {enc.node_rows["n0"], enc.node_rows["n3"]}
    assert not rows & set(h[:5].tolist())
    assert len(set(h[:5].tolist()) - {-1}) == 4 and (h[:5] == -1).sum() == 1


def test_two_slot_world_redoes_with_nominations():
    """2 pod slots per node and nominations on some nodes: proposals onto a
    claimed node bounce, the hybrid check redoes the batch through the
    sequential engine, which applies the claims in every step."""
    nodes = [jax_node(f"n{i}", cpu="4", mem="8Gi", pods=2,
                      labels={ZONE_KEY: f"z{i % 3}"}) for i in range(8)]
    enc = _encoder(nodes)
    pairs = [(jax_pod(f"k{i}", cpu="3950m", mem="1Gi", priority=10),
              f"n{2 * i}") for i in range(3)]
    pods = [jax_pod(f"p{i}", cpu="100m", mem="256Mi") for i in range(14)]
    h, pfn = _both(enc, pods, pairs, "speculative")
    assert pfn.last_redo
    claimed = {enc.node_rows[f"n{2 * i}"] for i in range(3)}
    assert not claimed & set(h.tolist())
    assert (h >= 0).sum() == 10   # 5 free nodes x 2 slots
    _both(enc, pods, pairs, "sequential")


def test_upload_nominated_reads_either_package():
    enc = _encoder([jax_node("a", cpu="4", mem="8Gi")])
    nom = jb.encode_nominated(enc, [(jax_pod("k", cpu="1", priority=3), "a")])
    t = transfer.upload_nominated(nom, "cpu")
    assert isinstance(t, pb.NominatedState)
    for f in ("node", "prio", "req"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(nom, f)))
    assert transfer.upload_nominated(None, "cpu") is None
    again = transfer.upload_nominated(t, "cpu")
    assert again.req is t.req   # tensors on the device pass through
