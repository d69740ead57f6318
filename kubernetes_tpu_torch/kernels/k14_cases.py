"""The cases kernels K14 (round_commit.cu) and K15 (round_fold.cu) are
held to, in one place: kernels/k13_cases.py's worlds, run through the
speculative engine, whose plain rounds are K15 between the score pass and
the selector and K14 after it.

tests/test_torch_round_commit.py runs the port's speculative engine on
the CPU (its rounds through the twins, models/speculative.py
round_fold_plain and round_commit_plain) against the jitted JAX
speculative engine on every case, bit for bit: hosts, the committed
columns, the top-k, the rounds and the redo flag; chip_smoke.py runs the
engine on the card through the kernels and through the twins on all of
them and holds the two equal.  The cases add to K13's: a first round
that bounces on the 2-slot fleet (the batch is redone), nominated claims
that bounce a proposer, in-batch ports that bounce one, shipped per-pod
spread counts, and a plain batch that needs no redo.  numpy only.

`affinity_cases` are the affinity mode's (K15's IPA score, K14's anti
order, inversion sentinel and deferred retirement, K16's pair commit and
gate, and K13's affinity mode when the batch is redone): K13's random
affinity worlds (kernels/k13_cases.py affinity_cases), and batches the
port's encoder makes from objects, as the engines get them: hostname
anti-affinity with existing pods (the same round's anti conflicts, with
accepted and with bounced peers), zone affinity to the pod's own app from
nothing (the bootstrap gate), the IPA floor-boundary cell (preferred sums
3, -7, -4 and 0 on four hostname domains), a 2-slot fleet of anti pods
whose rounds retire infeasible pods late and are redone, and random
required and preferred terms in both directions with namespaces.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels.k11_cases import world
from kubernetes_tpu_torch.kernels.k13_cases import (
    WRAP, cases as k13_cases, open_world, run_case, scan_case)

__all__ = ["cases", "run_case"]


def cases():
    """[(name, case)] of every K14 / K15 case, in a fixed order."""
    out = list(k13_cases())
    w = open_world(world(320, 24, 40))
    w["cluster"]["requested"][:] = 0.0
    out.append(("no-redo", scan_case(w, 420, topk=3)))
    w = open_world(world(321, 32, 12))
    w["cluster"]["allocatable"][:, 3] = 3.0       # three pod slots a node
    out.append(("bounce-and-redo", scan_case(w, 421, last_index0=WRAP)))
    w = open_world(world(322, 24, 40, lean_spread=False))
    out.append(("dense-spread-rounds", scan_case(w, 422, pct=0)))
    return out


HOSTNAME_KEY = "kubernetes.io/hostname"
ZONE = "failure-domain.beta.kubernetes.io/zone"


def encoded_case(nodes, existing, pending, *, topk=0, pct=100,
                 last_index0=0, hard_w=None) -> dict:
    """A K14 case from objects: the port's encoder makes the snapshot (the
    nodes and the existing pods), the batch, its ports and its in-batch
    affinity state (the lean factors densified as densify_batch_affinity
    does), all as numpy arrays."""
    from dataclasses import fields

    from kubernetes_tpu_torch.codec import SnapshotEncoder
    from kubernetes_tpu_torch.kernels.k12_cases import RTC, STOCK
    from kubernetes_tpu_torch.models.batched import (
        encode_batch_affinity, encode_batch_ports)

    enc = SnapshotEncoder()
    for n in nodes:
        enc.add_node(n)
    for p in existing:
        enc.add_pod(p)
    lean = encode_batch_affinity(enc, pending)
    pb, ports = enc.encode_pods(pending), encode_batch_ports(enc, pending)
    ct = enc.snapshot()
    gid = np.asarray(lean.gid)

    def own(gm):
        return np.ascontiguousarray(np.asarray(gm)[:, :, gid])

    aff_own, anti_own, pref_own = (own(lean.aff_gm), own(lean.anti_gm),
                                   own(lean.pref_gm))
    cfg = {} if hard_w is None else {"hard_pod_affinity_weight": hard_w}
    return {
        "cluster": {f.name: np.asarray(getattr(ct, f.name))
                    for f in fields(ct)},
        "pods": {f.name: np.asarray(getattr(pb, f.name))
                 for f in fields(pb)},
        "cfg": cfg,
        "unsched_key": enc.interner.intern("node.kubernetes.io/unschedulable"),
        "ports": {"pod_ports": np.asarray(ports.pod_ports),
                  "conflict": np.asarray(ports.conflict)},
        "last_index0": int(last_index0), "nominated": None,
        "extra_mask": None, "extra_score": None, "pct": int(pct),
        "topk": int(topk), "weights": np.asarray(STOCK, np.float32),
        "score_cfg": {"label_prefs": (), "rtc_shape": RTC},
        "zone_key": enc.getzone_key,
        "aff": {"aff_match": aff_own.transpose(2, 0, 1).copy(),
                "anti_match": anti_own.transpose(2, 0, 1).copy(),
                "anti_own": anti_own,
                "aff_own": aff_own,
                "pref_topo_key": np.asarray(lean.pref_topo_key),
                "pref_weight": np.asarray(lean.pref_weight),
                "pref_match": pref_own.transpose(2, 0, 1).copy(),
                "pref_own": pref_own}}


def _term(app, key):
    return {"labelSelector": {"matchLabels": {"app": app}},
            "topologyKey": key}


def _fleet(n, zones=3, pods=110, cpu="4"):
    from kubernetes_tpu_torch.api.factory import make_node

    return [make_node(f"n{i}", cpu=cpu, mem="16Gi", pods=pods,
                      labels={ZONE: f"z{i % zones}"}) for i in range(n)]


def _pod(name, app, affinity=None, node_name="", namespace="default"):
    from kubernetes_tpu_torch.api.factory import make_pod

    return make_pod(name, namespace=namespace, cpu="100m", mem="128Mi",
                    labels={"app": app}, affinity=affinity,
                    node_name=node_name)


def _random_affinity(rng):
    """Required and preferred terms in both directions (up to 2 of each
    required kind), some with explicit namespaces."""
    def term():
        t = _term(f"app-{rng.integers(4)}",
                  ZONE if rng.random() < 0.5 else HOSTNAME_KEY)
        if rng.random() < 0.3:
            t["namespaces"] = list(rng.choice(
                ["default", "team-a", "team-b"],
                size=int(rng.integers(1, 3)), replace=False))
        return t

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


def affinity_cases():
    """[(name, case)] of the affinity mode's cases, in a fixed order."""
    from kubernetes_tpu_torch.kernels.k13_cases import (
        affinity_cases as k13_affinity)

    out = list(k13_affinity())
    # hostname anti-affinity to the pod's own app, with existing pods of
    # those apps on a third of the nodes
    nodes = _fleet(12)
    anti = lambda app: {"podAntiAffinity": {                 # noqa: E731
        "requiredDuringSchedulingIgnoredDuringExecution": [
            _term(app, HOSTNAME_KEY)]}}
    existing = [_pod(f"e{i}", f"app-{i % 3}", node_name=f"n{i * 3}")
                for i in range(4)]
    pending = [_pod(f"p{i}", f"app-{i % 3}", anti(f"app-{i % 3}"))
               for i in range(20)]
    out.append(("anti-host-existing", encoded_case(nodes, existing,
                                                   pending, topk=3)))
    # zone affinity to the pod's own app from nothing: one founder a
    # group bootstraps, its mates follow into its zone
    aff = lambda app: {"podAffinity": {                      # noqa: E731
        "requiredDuringSchedulingIgnoredDuringExecution": [
            _term(app, ZONE)]}}
    pending = [_pod(f"p{i}", f"app-{i % 4}", aff(f"app-{i % 4}"))
               for i in range(16)]
    out.append(("zone-affinity-bootstrap", encoded_case(
        _fleet(9), [], pending, last_index0=5)))
    # the IPA floor-boundary cell
    pref = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution":
            [{"weight": 3, "podAffinityTerm": _term("a", HOSTNAME_KEY)}]},
            "podAntiAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution":
            [{"weight": 7, "podAffinityTerm": _term("b", HOSTNAME_KEY)}]}}
    existing = [_pod("ea0", "a", node_name="n0"),
                _pod("eb1", "b", node_name="n1"),
                _pod("ea2", "a", node_name="n2"),
                _pod("eb2", "b", node_name="n2")]
    pending = [_pod(f"p{i}", "ab"[i % 2], pref) for i in range(6)]
    out.append(("ipa-floor-boundary", encoded_case(
        _fleet(4, zones=1, cpu="8"), existing, pending, hard_w=5)))
    # a 2-slot fleet of hostname-anti pods: late retirement and the redo
    pending = [_pod(f"p{i}", f"app-{i % 5}", anti(f"app-{i % 5}"))
               for i in range(24)]
    out.append(("anti-two-slots", encoded_case(
        _fleet(10, pods=2), [], pending)))
    # random required and preferred terms, namespaces, both directions
    rng = np.random.default_rng(440)
    pending = [_pod(f"p{i}", f"app-{rng.integers(4)}", _random_affinity(rng),
                    namespace=str(rng.choice(["default", "team-a"])))
               for i in range(24)]
    existing = [_pod(f"e{i}", f"app-{i % 4}", _random_affinity(rng),
                     node_name=f"n{int(rng.integers(10))}")
                for i in range(8)]
    out.append(("random-terms", encoded_case(_fleet(10), existing, pending,
                                             topk=3, pct=50)))
    return out


def spread_lean(case) -> bool:
    return case["pods"]["spread_counts"].shape[1] != np.asarray(
        case["cluster"]["valid"]).shape[0]
