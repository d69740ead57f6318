"""The cases kernel K13 (seq_scan.cu) is held to, in one place.

tests/test_torch_seq_scan.py runs the port's sequential engine on the CPU
(its step loop, models/batched.py scan_plain, K13's plain twin) against the
jitted JAX sequential engine on every case, bit for bit: hosts, the
committed requested and nonzero_req columns and the top-k;
chip_smoke.py runs the engine on the card through K13 and through the twin
on all of them and holds the two equal.  numpy only.

A case is a kernels/k11_cases.py world ("cluster", "pods", "cfg",
"unsched_key") plus "ports" (BatchPortState's pod_ports and conflict),
"last_index0", "nominated" (NominatedState's node, prio and req, or None),
"extra_mask" / "extra_score" (or None), "pct" (percentage_of_nodes_to_score),
"topk", "weights", "score_cfg" and "zone_key".  The corners: a 2-slot
fleet where later pods find the early pods' nodes full; nominated claims
of higher and lower priority, and dead slots; in-batch host ports with
wildcard conflicts; quality top-3 and a width past N; sampling at 50% and
the adaptive 0, from a rotation counter that wraps int32 inside the batch;
R = 32; shipped per-pod spread counts; NaN and tied totals; every
state-dependent priority on.

`affinity_cases` are K13's affinity mode's: worlds not lean in the pair
terms (`affinity_world`) with an in-batch affinity state "aff" (the
BatchAffinityState's dense fields, drawn as the encoder's cross matches
are: each owner's valid terms against the batch's pods, the match
tensors the own tensors transposed), PT = AT = 2: required affinity and
anti terms on three topology keys (zone, a hostname-like key shared by a
few nodes, a rack key on a third of the nodes), preferred terms of both
signs on those keys and on a key no node has, the hard affinity weight,
volume zone and binding terms, bootstrapped terms (no pair matches them),
a 2-slot fleet, sampling and the top-k.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels.k11_cases import PAD, ZONE_KEY, world
from kubernetes_tpu_torch.kernels.k12_cases import EVERY, RTC, STOCK

WRAP = (1 << 31) - 7      # a counter that wraps int32 inside a batch


def open_world(w: dict) -> dict:
    """Most nodes feasible for most pods: node conditions, taints, host
    ports, volume limits and the pods' selectors switched off, so that
    sampling has feasible nodes to cut."""
    c, p = w["cluster"], w["pods"]
    for k in ("unschedulable", "not_ready", "mem_pressure", "disk_pressure",
              "pid_pressure", "port_used"):
        c[k][:] = False
    c["taint_effect"][:] = PAD
    c["vol_limits"][:] = np.inf
    c["allocatable"][:] = np.maximum(c["allocatable"], 1.0) * 4.0
    for k in ("ns_valid", "has_req_affinity", "port_valid", "vol_fail_all"):
        p[k][:] = False
    p["node_name_req"][:] = PAD
    p["valid"][:] = True
    return w


def scan_case(w: dict, seed: int, *, PV=4, p_port=0.0, last_index0=0,
              nominated=0, extra=False, pct=100, topk=0, weights=STOCK,
              rtc=RTC) -> dict:
    rng = np.random.default_rng(seed)
    B, N = w["pods"]["valid"].shape[0], w["cluster"]["valid"].shape[0]
    R = w["cluster"]["allocatable"].shape[1]
    conflict = rng.random((PV, PV)) < 0.3
    conflict = conflict | conflict.T | np.eye(PV, dtype=bool)
    w.update(ports={"pod_ports": rng.random((B, PV)) < p_port,
                    "conflict": conflict},
             last_index0=int(last_index0), nominated=None,
             extra_mask=None, extra_score=None, pct=int(pct),
             topk=int(topk), weights=np.asarray(weights, np.float32),
             score_cfg={"label_prefs": (), "rtc_shape": tuple(rtc)},
             zone_key=ZONE_KEY)
    if nominated:
        K = nominated
        node = rng.integers(0, N, K).astype(np.int32)
        node[rng.random(K) < 0.25] = -1          # dead slots
        req = (rng.integers(0, 3, (K, R)) * (rng.random((K, R)) < 0.6)
               ).astype(np.float32)
        req[:, 0] *= 500.0
        req[:, 1] *= 1024.0
        w["nominated"] = {"node": node,
                          "prio": rng.integers(0, 3, K).astype(np.int32),
                          "req": req}
    if extra:
        w["extra_mask"] = rng.random((B, N)) < 0.9
        w["extra_score"] = rng.integers(0, 3, (B, N)).astype(np.float32)
    return w


def affinity_world(seed: int, B: int, N: int, *, p_match=0.3, PP=2,
                   hard_w=None, **kw) -> dict:
    """A k11_cases world not lean in the pair terms (PT = AT = 2) with an
    in-batch affinity state "aff" drawn from seed: each pod's valid terms
    match a share p_match of the batch; preferred terms weigh -100..100
    on keys 5-8 (8: no pair); hard_w (or the FilterConfig default) in
    "cfg"."""
    w = world(seed, B, N, lean_affinity=False, **kw)
    rng = np.random.default_rng(seed + 7919)
    p = w["pods"]
    PT, AT = p["aff_term_valid"].shape[1], p["anti_term_valid"].shape[1]

    def own(valid, T):
        return (rng.random((B, T, B)) < p_match) & valid[:, :, None]

    aff_own = own(p["aff_term_valid"], PT)
    anti_own = own(p["anti_term_valid"], AT)
    weight = (rng.integers(1, 101, (B, PP))
              * rng.choice((-1, 1), (B, PP))
              * (rng.random((B, PP)) < 0.7)).astype(np.float32)
    pref_own = own(weight != 0, PP)
    w["aff"] = {"aff_match": aff_own.transpose(2, 0, 1).copy(),
                "anti_match": anti_own.transpose(2, 0, 1).copy(),
                "anti_own": anti_own, "aff_own": aff_own,
                "pref_topo_key": rng.integers(5, 9, (B, PP)).astype(np.int32),
                "pref_weight": weight,
                "pref_match": pref_own.transpose(2, 0, 1).copy(),
                "pref_own": pref_own}
    if hard_w is not None:
        w["cfg"] = dict(w["cfg"], hard_pod_affinity_weight=hard_w)
    return w


def affinity_cases():
    """[(name, case)] of K13's affinity-mode cases, in a fixed order; small
    enough for the jitted JAX engine on the CPU."""
    out = [("aff-b24-n40", scan_case(open_world(affinity_world(
        330, 24, 40)), 430))]
    w = open_world(affinity_world(331, 24, 16, hard_w=7,
                                  lean_volumes=False))
    w["cluster"]["allocatable"][:, 3] = 2.0      # two pod slots a node
    w["cluster"]["requested"][:, 3] = 0.0
    out.append(("aff-two-slots-volumes", scan_case(w, 431)))
    out.append(("aff-dense-matches", scan_case(open_world(affinity_world(
        332, 24, 40, p_match=0.7)), 432, topk=3, extra=True)))
    out.append(("aff-sample-wrap", scan_case(open_world(affinity_world(
        333, 24, 90)), 433, pct=50, last_index0=WRAP, weights=EVERY)))
    # the cluster's edges: 150 nodes over 16 blocks of 32 threads, the
    # later pods' pair commits (pod i on the cluster's thread i) spread
    # over three blocks; 16,400 nodes, more tie words a block (33) than
    # its select partial carries, and three nodes a thread
    out.append(("aff-across-blocks", scan_case(open_world(affinity_world(
        334, 80, 150)), 434, topk=3)))
    out.append(("aff-wide-blocks", scan_case(open_world(affinity_world(
        335, 8, 16400)), 435)))
    return out


def many_zones(w: dict, Z: int = 70) -> dict:
    """The world's first Z topology pairs made zone pairs (more than K13
    keeps in a partial: its zone sums go through the workspace), nine
    nodes in ten in one of them."""
    c = w["cluster"]
    N = c["topo_pairs"].shape[0]
    rng = np.random.default_rng(7 * Z + N)
    c["pair_topo_key"][:Z] = ZONE_KEY
    c["topo_pairs"][:, :Z] = False
    on = rng.random(N) < 0.9
    c["topo_pairs"][np.flatnonzero(on), rng.integers(0, Z, N)[on]] = True
    return w


def identical_nodes(w: dict) -> dict:
    """Every node a copy of node 0's resources, nothing requested: ties."""
    c = w["cluster"]
    c["allocatable"][:] = c["allocatable"][0]
    c["requested"][:] = 0.0
    c["nonzero_req"][:] = c["nonzero_req"][0]
    return w


def cases():
    """[(name, case)] of every K13 case, in a fixed order; small enough
    for the jitted JAX engine on the CPU."""
    out = [("plain-b24-n40", scan_case(world(300, 24, 40), 400))]
    w = world(301, 24, 16)
    w["cluster"]["allocatable"][:, 3] = 2.0      # two pod slots a node
    w["cluster"]["requested"][:, 3] = 0.0
    out.append(("two-slots", scan_case(w, 401)))
    out.append(("nominated", scan_case(open_world(world(302, 24, 40)), 402,
                                       nominated=16)))
    out.append(("host-ports", scan_case(world(303, 24, 40), 403, PV=8,
                                        p_port=0.35, extra=True)))
    out.append(("quality-top3", scan_case(world(304, 24, 40), 404, topk=3,
                                          extra=True)))
    out.append(("quality-past-n", scan_case(world(305, 6, 5), 405, topk=8)))
    out.append(("sample-50-wrap", scan_case(
        open_world(world(306, 24, 260)), 406, pct=50, last_index0=WRAP,
        topk=3)))
    out.append(("sample-adaptive", scan_case(
        open_world(world(307, 24, 260)), 407, pct=0, last_index0=-5)))
    out.append(("r32-ports-top3", scan_case(
        open_world(world(308, 24, 40, R=32)), 408, p_port=0.3, topk=3)))
    out.append(("dense-spread", scan_case(
        world(309, 24, 40, lean_spread=False), 409, weights=EVERY)))
    w = scan_case(open_world(world(310, 24, 40)), 410, extra=True,
                  last_index0=WRAP)
    w["extra_score"][:] = 0.0                     # tied totals
    w["extra_score"][3, 7] = np.nan               # a NaN row max
    w["extra_score"][5, :] = np.nan
    w["cluster"]["allocatable"][:] = w["cluster"]["allocatable"][0]
    w["cluster"]["requested"][:] = 0.0
    w["cluster"]["nonzero_req"][:] = w["cluster"]["nonzero_req"][0]
    out.append(("nan-and-ties", w))
    out.append(("every-priority", scan_case(world(311, 24, 40), 411,
                                            weights=EVERY, nominated=8)))
    # the cluster's edges (K13 spreads the nodes over 16 blocks of
    # ceil(N / 16) nodes, up to 384 threads a block): fewer nodes than
    # blocks; 6,500 nodes, two a thread, a ragged last block and partial
    # warps (and three spread groups a pod, more than K13 gathers a step
    # ahead); identical nodes tied across blocks, the counter picking a
    # tie in a later block; a sampled row whose rotated start falls inside
    # a block, with 70 zone pairs and a top-12 (more than a partial
    # carries: both go through the workspace); and N x R past the blocks'
    # shared memory, the carried state in the global workspace
    out.append(("cluster-short", scan_case(open_world(world(312, 24, 11)),
                                           412, topk=3)))
    out.append(("cluster-ragged", scan_case(world(313, 24, 6500, GP=3), 413,
                                            extra=True)))
    w = identical_nodes(scan_case(open_world(world(314, 24, 100)), 414,
                                  last_index0=77))
    out.append(("ties-across-blocks", w))
    out.append(("sample-mid-block", scan_case(
        many_zones(open_world(world(315, 24, 300, TP=160))), 415, pct=50,
        last_index0=45, topk=12)))
    out.append(("global-state", scan_case(open_world(world(
        316, 24, 1800, R=256)), 416)))
    return out


def run_case(case, engine: str = "sequential", device="cpu",
             select_impl: str = "kernel"):
    """The case through the port's engine ("sequential" or
    "speculative") on `device`, with its in-batch affinity state "aff"
    where it has one: (the engine's outputs, the engine).  On CUDA tensors
    select_impl "kernel" takes K13 (and K14, K15, K16), "plain" the
    twins."""
    import torch

    from kubernetes_tpu_torch.codec import schema as ts
    from kubernetes_tpu_torch.models import batched, speculative

    ct = ts.cluster_to_torch(ts.ClusterTensors(**{
        k: torch.from_numpy(np.array(v))
        for k, v in case["cluster"].items()}), device)
    pb = ts.pods_to_torch(ts.PodBatch(**{
        k: torch.from_numpy(np.array(v))
        for k, v in case["pods"].items()}), device)
    make = (batched.make_sequential_scheduler if engine == "sequential"
            else speculative.make_speculative_scheduler)
    fn = make(cfg=ts.FilterConfig(**case["cfg"]), weights=case["weights"],
              unsched_taint_key=case["unsched_key"],
              zone_key_id=case["zone_key"],
              score_cfg=ts.ScoreConfig(**case["score_cfg"]),
              percentage_of_nodes_to_score=case["pct"],
              quality_topk=case["topk"], device=device,
              select_impl=select_impl)
    nom = (None if case["nominated"] is None
           else batched.NominatedState(**case["nominated"]))
    aff = (None if case.get("aff") is None
           else batched.BatchAffinityState(**case["aff"]))
    out = fn(ct, pb, batched.BatchPortState(**case["ports"]),
             case["last_index0"], nominated=nom,
             extra_mask=case["extra_mask"], extra_score=case["extra_score"],
             aff_state=aff)
    return out, fn
