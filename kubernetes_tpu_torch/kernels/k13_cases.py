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
    return out


def run_case(case, engine: str = "sequential", device="cpu",
             select_impl: str = "kernel"):
    """The case through the port's engine ("sequential" or
    "speculative") on `device`: (the engine's outputs, the engine).  On
    CUDA tensors select_impl "kernel" takes K13 (and K14, K15), "plain"
    the twins."""
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
    out = fn(ct, pb, batched.BatchPortState(**case["ports"]),
             case["last_index0"], nominated=nom,
             extra_mask=case["extra_mask"], extra_score=case["extra_score"])
    return out, fn
