"""In-batch pod (anti-)affinity in the PyTorch port against the JAX package,
on CPU, bit for bit.

The port's encode_batch_affinity and densify_batch_affinity are held field
by field against the JAX package's on randomized batches (preferred terms,
namespaces, padding).  Both engines then run the scenarios of
tests/test_inbatch_affinity.py with aff_state, fed the same JAX-encoded
batches, and must give the JAX engines' hosts, committed requested /
nonzero_req columns, rounds and redo flags; so must a 2-slot world where
the hybrid redo fires and deferred retirement runs many rounds.  The IPA
score's normalization is pinned on a floor-boundary cell.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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


def _term(app, key, namespaces=None):
    t = {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}
    if namespaces:
        t["namespaces"] = list(namespaces)
    return t


def _anti(app, key=ZONE_KEY):
    return {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [_term(app, key)]}}


def _aff(app, key=ZONE_KEY):
    return {"podAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [_term(app, key)]}}


def _prefer(app, weight=100, anti=False, key=HOSTNAME_KEY):
    kind = "podAntiAffinity" if anti else "podAffinity"
    return {kind: {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": weight, "podAffinityTerm": _term(app, key)}]}}


# ------------------------------------------------------------ the encoder


def _random_affinity(rng):
    """Required and preferred terms in both directions, some with explicit
    namespaces."""
    apps = [f"app-{k}" for k in range(4)]
    nss = ["default", "team-a", "team-b"]

    def term():
        ns = (list(rng.choice(nss, size=int(rng.integers(1, 3)),
                              replace=False))
              if rng.random() < 0.3 else None)
        key = ZONE_KEY if rng.random() < 0.5 else HOSTNAME_KEY
        return _term(str(rng.choice(apps)), key, ns)

    out = {}
    for kind in ("podAffinity", "podAntiAffinity"):
        if rng.random() < 0.6:
            body = {}
            if rng.random() < 0.6:
                body["requiredDuringSchedulingIgnoredDuringExecution"] = [
                    term() for _ in range(int(rng.integers(1, 3)))]
            if rng.random() < 0.6:
                body["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": int(rng.integers(1, 101)),
                     "podAffinityTerm": term()}
                    for _ in range(int(rng.integers(1, 4)))]
            if body:
                out[kind] = body
    return out or None


def _random_pending(make_pod, seed, n):
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n):
        pods.append(make_pod(
            f"p{i}", namespace=str(rng.choice(["default", "team-a",
                                               "team-b"])),
            cpu="100m", labels={"app": f"app-{rng.integers(4)}",
                                "tier": str(rng.choice(["x", "y"]))},
            affinity=_random_affinity(rng)))
    return pods


def _fleet(make_node, n=10):
    return [make_node(f"n{i}", cpu="4", mem="8Gi",
                      labels={ZONE_KEY: f"z{i % 3}"}) for i in range(n)]


@pytest.mark.parametrize("seed,n_pods", [(1, 5), (2, 13), (3, 16), (4, 1)])
def test_encode_batch_affinity_matches_jax(seed, n_pods):
    """Field by field, with the batch padded past n_pods (the padding pods
    take the all-False last group)."""
    jenc, penc = JaxEncoder(TEST_DIMS), PortEncoder(TEST_DIMS)
    for enc, mk in ((jenc, jax_node), (penc, port_node)):
        for n in _fleet(mk):
            enc.add_node(n)
    jpods = _random_pending(jax_pod, seed, n_pods)
    ppods = _random_pending(port_pod, seed, n_pods)
    jl = jb.encode_batch_affinity(jenc, jpods)
    pl = pb.encode_batch_affinity(penc, ppods)
    assert type(pl).__name__ == "LeanBatchAffinity"
    assert pl._fields == jl._fields
    for f in jl._fields:
        x, y = np.asarray(getattr(jl, f)), np.asarray(getattr(pl, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert pl.gid.shape[0] == penc.batch_pad(n_pods)
    assert not pl.aff_gm[..., -1].any() and not pl.anti_gm[..., -1].any()
    assert (pl.gid[n_pods:] == pl.aff_gm.shape[-1] - 1).all()
    # the preferred terms registered their topology keys in both encoders
    assert jenc.topo_keys == penc.topo_keys
    # densified on the device: the JAX package's (jitted) and the port's
    jd = jax.jit(jb.densify_batch_affinity)(jl)
    pd = pb.densify_batch_affinity(pb.LeanBatchAffinity(
        *(torch.from_numpy(np.asarray(a)) for a in pl)))
    for f in ("aff_match", "anti_match", "anti_own", "aff_own",
              "pref_topo_key", "pref_weight", "pref_match", "pref_own"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, f)),
                                      getattr(pd, f).numpy(), err_msg=f)


def test_batch_has_pod_affinity_detector():
    assert not pb.batch_has_pod_affinity([port_pod("a"), port_pod("b")])
    assert pb.batch_has_pod_affinity(
        [port_pod("a"), port_pod("b", affinity=_anti("x"))])
    assert pb.batch_has_pod_affinity(
        [port_pod("a", affinity=_prefer("x"))])


# ------------------------------------------------------------ the engines


def _chain(enc, batches, engine, dense=False):
    """Both packages' engines over `batches` with aff_state, each chaining
    its own cluster state; every batch's hosts, committed columns, rounds
    and redo flag compared.  Returns (hosts per batch, rounds, redos)."""
    jmake, pmake = MAKERS[engine]
    kw = engine_keys(enc)
    jfn = jmake(**kw)
    pfn = pmake(device="cpu", **kw)
    jstate = enc.snapshot()
    pstate = cluster_to_torch(jstate, "cpu")
    last = 0
    out, rounds, redos = [], [], 0
    for pods in batches:
        aff = jb.encode_batch_affinity(enc, pods)   # before encode_pods
        b = enc.encode_pods(pods)
        ports = jb.encode_batch_ports(enc, pods)
        jh, jstate = jfn(jstate, b, ports, np.int32(last), aff_state=aff)
        paff = (jax.tree_util.tree_map(np.asarray,
                                       jb.densify_batch_affinity(aff))
                if dense else aff)
        th, pstate = pfn(pstate, pods_to_torch(b, "cpu"),
                         ports_to_torch(ports, "cpu"), last, aff_state=paff)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(np.asarray(jstate.requested),
                                      pstate.requested.numpy())
        np.testing.assert_array_equal(np.asarray(jstate.nonzero_req),
                                      pstate.nonzero_req.numpy())
        if engine == "speculative":
            assert pfn.last_redo == bool(np.asarray(jfn.last_redo))
            assert pfn.last_rounds == int(jfn.last_rounds)
            rounds.append(pfn.last_rounds)
            redos += int(pfn.last_redo)
        out.append(th.numpy()[:len(pods)])
        last += len(pods)
    return out, rounds, redos


def _encoder(nodes, existing=()):
    enc = JaxEncoder(TEST_DIMS)
    for n in nodes:
        enc.add_node(n)
    for p in existing:
        enc.add_pod(p)
    return enc


def _names(enc, hosts):
    return [enc.row_name(int(r)) if r >= 0 else None for r in hosts]


def _spreads():
    nodes = [jax_node(f"n{i}", cpu="4", mem="8Gi") for i in range(3)]
    pods = [jax_pod(f"p{i}", cpu="100m", labels={"app": "x"},
                    affinity=_anti("x", HOSTNAME_KEY)) for i in range(3)]
    return nodes, [pods], lambda names: len({n for n in names[0]}) == 3


def _zone_exhaustion():
    nodes = [jax_node("n0", cpu="4", mem="8Gi", labels={ZONE_KEY: "z0"}),
             jax_node("n1", cpu="4", mem="8Gi", labels={ZONE_KEY: "z1"}),
             jax_node("n2", cpu="4", mem="8Gi", labels={ZONE_KEY: "z0"})]
    pods = [jax_pod(f"p{i}", cpu="100m", labels={"app": "z"},
                    affinity=_anti("z")) for i in range(3)]
    return nodes, [pods], lambda names: names[0][2] is None


def _chain_scenario():
    zone = {"n0": "z0", "n1": "z1"}
    nodes = [jax_node(n, cpu="4", mem="8Gi", labels={ZONE_KEY: z})
             for n, z in zone.items()]
    pods = [jax_pod("leader", cpu="100m", labels={"app": "ring"},
                    affinity=_aff("ring")),
            jax_pod("f1", cpu="100m", labels={"app": "follower"},
                    affinity=_aff("ring")),
            jax_pod("f2", cpu="100m", labels={"app": "follower"},
                    affinity=_aff("ring"))]
    return nodes, [pods], lambda names: (
        names[0][0] is not None
        and zone[names[0][1]] == zone[names[0][2]] == zone[names[0][0]])


def _mixed():
    nodes = [jax_node(f"n{i}", cpu="4", mem="8Gi") for i in range(3)]
    pods = [jax_pod("plain-a", cpu="100m"),
            jax_pod("anti-1", cpu="100m", labels={"app": "s"},
                    affinity=_anti("s", HOSTNAME_KEY)),
            jax_pod("plain-b", cpu="100m"),
            jax_pod("anti-2", cpu="100m", labels={"app": "s"},
                    affinity=_anti("s", HOSTNAME_KEY))]
    return nodes, [pods], lambda names: names[0][1] != names[0][3]


def _randomized(seed):
    def build():
        rng = np.random.default_rng(7000 + seed)
        nodes = [jax_node(f"n{i}", cpu="2", mem="8Gi",
                          labels={ZONE_KEY: f"z{i % 3}"}) for i in range(6)]
        pods = []
        for i in range(8):
            app = str(rng.choice(["a", "b", "c"]))
            kind = rng.random()
            affinity = None
            if kind < 0.4:
                affinity = _anti(app, HOSTNAME_KEY if rng.random() < 0.5
                                 else ZONE_KEY)
            elif kind < 0.7:
                affinity = _aff(app, ZONE_KEY)
            pods.append(jax_pod(
                f"p{i}", cpu=f"{int(rng.integers(1, 4)) * 100}m",
                labels={"app": app}, affinity=affinity))
        return nodes, [pods], lambda names: True
    return build


def _preferred():
    nodes = [jax_node(f"n{i}", cpu="8", mem="16Gi") for i in range(6)]
    pods = [jax_pod("web-0", cpu="100m", labels={"app": "web"}),
            jax_pod("web-1", cpu="100m", labels={"app": "web"},
                    affinity=_prefer("web")),
            jax_pod("web-2", cpu="100m", labels={"app": "web"},
                    affinity=_prefer("web")),
            jax_pod("loner", cpu="100m", labels={"app": "loner"},
                    affinity=_prefer("web", anti=True))]
    return nodes, [pods], lambda names: (
        names[0][0] == names[0][1] == names[0][2]
        and names[0][3] != names[0][0])


SCENARIOS = {"spreads": _spreads, "zone_exhaustion": _zone_exhaustion,
             "chain": _chain_scenario, "mixed": _mixed,
             "random0": _randomized(0), "random1": _randomized(1),
             "random2": _randomized(2), "preferred": _preferred}


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_inbatch_scenarios_match_jax(scenario, engine):
    nodes, batches, holds = SCENARIOS[scenario]()
    enc = _encoder(nodes)
    hosts, _, _ = _chain(enc, batches, engine)
    # preferred terms are scores: the speculative engine places the whole
    # batch in its first round, so only one-at-a-time placement co-locates
    if engine == "sequential" or scenario != "preferred":
        assert holds([_names(enc, h) for h in hosts])


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
def test_dense_affinity_state_accepted(engine):
    """A dense BatchAffinityState gives what the lean one gives."""
    nodes, batches, _ = _chain_scenario()
    lean, _, _ = _chain(_encoder(nodes), batches, engine)
    dense, _, _ = _chain(_encoder(nodes), batches, engine, dense=True)
    np.testing.assert_array_equal(lean[0], dense[0])


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
def test_affinity_state_on_a_lean_batch(engine):
    """aff_state on a batch without pod-affinity terms and a cluster
    without term groups: the encoder's width-1 pair placeholders broadcast
    against the carry."""
    nodes = [jax_node(f"n{i}", cpu="2", mem="4Gi",
                      labels={ZONE_KEY: f"z{i % 2}"}) for i in range(4)]
    pods = [jax_pod(f"p{i}", cpu="500m", labels={"app": "w"})
            for i in range(10)]
    enc = _encoder(nodes)
    assert enc.encode_pods(pods).aff_term_pairs.shape[-1] == 1
    _chain(enc, [pods[:6], pods[6:]], engine)


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
def test_existing_pods_and_chained_batches(engine):
    """Existing pods' affinity terms (the encoder's pair tensors and term
    groups) plus in-batch state over chained batches, preferred terms
    included."""
    rng = np.random.default_rng(11)
    nodes = [jax_node(f"n{i}", cpu="4", mem="8Gi",
                      labels={ZONE_KEY: f"z{i % 3}"}) for i in range(9)]
    existing = [jax_pod(f"e{i}", cpu="200m", labels={"app": f"a{i % 3}"},
                        node_name=f"n{int(rng.integers(9))}",
                        affinity=_anti(f"a{i % 3}", HOSTNAME_KEY)
                        if i % 2 else _prefer(f"a{(i + 1) % 3}", 40))
                for i in range(6)]
    pods = []
    for i in range(24):
        app = f"a{int(rng.integers(3))}"
        r = rng.random()
        affinity = (_anti(app, HOSTNAME_KEY) if r < 0.35 else
                    _aff(app) if r < 0.55 else
                    _prefer(app, int(rng.integers(1, 101)),
                            anti=r < 0.75) if r < 0.9 else None)
        pods.append(jax_pod(f"p{i}", cpu="300m", labels={"app": app},
                            affinity=affinity))
    _chain(_encoder(nodes, existing), [pods[:8], pods[8:16], pods[16:]],
           engine)


def test_two_slot_redo_and_deferred_retirement():
    """2 pod slots per node and hostname anti-affinity per app: demand
    exceeds what the anti terms allow, so pods are left unschedulable, the
    hybrid check redoes batches, and deferred retirement runs many rounds
    (a commit-free round retires one infeasible pod)."""
    nodes = [jax_node(f"n{i}", cpu="8", mem="16Gi", pods=2,
                      labels={ZONE_KEY: f"z{i % 3}"}) for i in range(10)]
    pods = [jax_pod(f"p{i}", cpu="100m", labels={"app": f"a{i % 4}"},
                    affinity=_anti(f"a{i % 4}", HOSTNAME_KEY))
            for i in range(44)]
    hosts, rounds, redos = _chain(_encoder(nodes), [pods[:16], pods[16:32],
                                                    pods[32:]], "speculative")
    assert redos > 0
    assert max(rounds) >= 4
    placed = np.concatenate(hosts)
    assert (placed < 0).any()
    seq, _, _ = _chain(_encoder(nodes), [pods[:16], pods[16:32], pods[32:]],
                       "sequential")
    assert int((placed >= 0).sum()) == int((np.concatenate(seq) >= 0).sum())


def test_preferred_terms_across_rounds():
    """Group founders bootstrap in round 1 and their mates place in round
    2, where the mates' scores hold the round-1 commits' preferred terms
    in both directions (their own terms the founders match, and the
    founders' terms that match them) and the hard-affinity weight."""
    nodes = [jax_node(f"n{i}", cpu="4", mem="8Gi",
                      labels={ZONE_KEY: f"z{i % 2}"}) for i in range(8)]

    def pod(i, app, prefer_app, weight, anti):
        affinity = {"podAffinity": _aff(app)["podAffinity"]}
        kind = "podAntiAffinity" if anti else "podAffinity"
        affinity.setdefault(kind, {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": weight,
             "podAffinityTerm": _term(prefer_app, HOSTNAME_KEY)}]
        return jax_pod(f"p{i}", cpu="100m", labels={"app": app},
                       affinity=affinity)

    pods = ([pod(i, "g1", "g1", 30 + i, False) for i in range(4)]
            + [pod(4 + i, "g2", "g1", 20 + i, True) for i in range(4)])
    for engine in MAKERS:
        hosts, rounds, redos = _chain(_encoder(nodes), [pods], engine)
        assert (hosts[0] >= 0).all()
    assert rounds == [2] and redos == 0
    # the hard-affinity weight: x waits a round for its founder q, then
    # matches f's required hostname term, which draws it to f's node
    one_zone = [jax_node(f"n{i}", cpu="4", mem="8Gi",
                         labels={ZONE_KEY: "z0"}) for i in range(4)]
    pods = [jax_pod("f", cpu="100m", labels={"app": "m"},
                    affinity=_aff("m", HOSTNAME_KEY)),
            jax_pod("q", cpu="100m", labels={"app": "q"},
                    affinity=_aff("q")),
            jax_pod("x", cpu="100m", labels={"app": "m"},
                    affinity=_aff("q"))]
    enc = _encoder(one_zone)
    for engine in MAKERS:
        hosts, rounds, redos = _chain(enc, [pods], engine)
        assert hosts[0][2] == hosts[0][0]
    assert rounds == [2] and redos == 0


def _asymmetric_world(seed):
    """Pods whose required terms name OTHER apps, on a few nodes of 2-3
    slots: relations through the terms run one way only."""
    rng = np.random.default_rng(seed)
    nodes = [jax_node(f"n{i}", cpu="2", mem="8Gi",
                      pods=int(rng.integers(2, 4)),
                      labels={ZONE_KEY: f"z{i % 3}"})
             for i in range(int(rng.integers(5, 9)))]
    pods = []
    for i in range(int(rng.integers(10, 16))):
        app = f"a{int(rng.integers(3))}"
        r = rng.random()
        other = f"a{int(rng.integers(3))}"
        key = HOSTNAME_KEY if rng.random() < 0.5 else ZONE_KEY
        affinity = (_anti(other, key) if r < 0.35 else
                    _aff(other) if r < 0.6 else None)
        pods.append(jax_pod(f"p{i}", cpu=f"{int(rng.integers(1, 6)) * 100}m",
                            labels={"app": app}, affinity=affinity))
    return nodes, pods


@pytest.mark.parametrize("seed", [21, 28, 29])
def test_one_way_relations_trip_the_inversion_sentinel(seed):
    """A later pod accepted while an earlier one is passed over, the two
    related only through the EARLIER pod's terms: the order-inversion
    sentinel must see the relation in both directions and redo the batch,
    as the JAX engine does."""
    nodes, pods = _asymmetric_world(seed)
    _, rounds, redos = _chain(_encoder(nodes), [pods], "speculative")
    assert redos == 1 and rounds[0] >= 2


# ------------------------------------------------------------ IPA's floor


def _jax_ipa(raw, valid):
    """The speculative engine's IPA normalization, as the JAX package
    writes it (models/speculative.py _round), compiled."""
    big = jnp.float32(3.4e38)
    mn = jnp.min(jnp.where(valid[None], raw, big), axis=1, keepdims=True)
    mx = jnp.max(jnp.where(valid[None], raw, -big), axis=1, keepdims=True)
    spr = mx - mn
    ipa = jnp.where(spr > 0, jnp.floor(10.0 * (raw - mn) / spr), 0.0)
    return jnp.where(valid[None], ipa, 0.0)


def test_ipa_normalize_floor_boundary():
    """A node at 7 of a spread of 10 scores 7: (raw - min) / spread * 10
    would give 6.9999998 and floor to 6.  Random integer sums, half of
    them on floor boundaries, agree with the compiled reference."""
    rng = np.random.default_rng(5)
    N = 64
    raw = rng.integers(-300, 300, (2048, N)).astype(np.float32)
    spr = rng.integers(1, 400, 1024)
    k = rng.integers(0, 11, (1024, N))
    raw[::2] = (np.floor(k * spr[:, None] / 10.0)
                - rng.integers(0, 50, (1024, 1))).astype(np.float32)
    raw[0] = 0.0
    raw[0, :4] = [3.0, -7.0, -4.0, 0.0]
    valid = np.ones(N, bool)
    valid[-3:] = False
    raw[0, -3:] = [99.0, -99.0, 5.0]        # off the valid nodes
    want = np.asarray(jax.jit(_jax_ipa)(raw, valid))
    got = pb.ipa_normalize(torch.from_numpy(raw),
                           torch.from_numpy(valid)[None]).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[0, :4].tolist() == [10.0, 0.0, 3.0, 7.0]
    assert (got[:, -3:] == 0).all()


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
def test_ipa_floor_boundary_cell_in_engines(engine):
    """The same cell through the engines: existing pods put the pending
    pods' preferred sums at 3, -7, -4 and 0 on four hostname domains (so
    the fourth node scores exactly 7 of 10), and in-batch commits move
    them between pods."""
    nodes = [jax_node(f"n{i}", cpu="8", mem="16Gi") for i in range(4)]
    existing = [jax_pod("ea0", cpu="100m", labels={"app": "a"},
                        node_name="n0"),
                jax_pod("eb1", cpu="100m", labels={"app": "b"},
                        node_name="n1"),
                jax_pod("ea2", cpu="100m", labels={"app": "a"},
                        node_name="n2"),
                jax_pod("eb2", cpu="100m", labels={"app": "b"},
                        node_name="n2")]
    both = {"podAffinity": _prefer("a", 3)["podAffinity"],
            "podAntiAffinity": _prefer("b", 7, anti=True)["podAntiAffinity"]}
    pods = [jax_pod(f"p{i}", cpu="100m", labels={"app": "ab"[i % 2]},
                    affinity=both) for i in range(6)]
    enc = _encoder(nodes, existing)
    b = enc.encode_pods(pods)
    raw = np.asarray(b.pref_pair_weights) @ np.asarray(
        enc.snapshot().topo_pairs, np.float32).T
    assert raw[0, :4].tolist() == [3.0, -7.0, -4.0, 0.0]
    _chain(_encoder(nodes, existing), [pods], engine)
