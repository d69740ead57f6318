"""The cases kernel K16 (round_pairs.cu) is held to, in one place.

A case is a kernels/k14_cases.py affinity case (its snapshot, batch and
in-batch affinity state "aff") plus one round's outcome, "round": the
node each pod proposed ("hosts"), which pods the round accepted
("accept"), which stay active after it ("active"), and the carried
unions' extra pairs and weights from earlier rounds ("extra": bool and
f32 rows or'ed and added onto the pods' own).  tests/test_torch_round_pairs.py
holds K16's plain twin (models/speculative.py round_pairs_plain) against
a loop over the accepted pods and their terms on every case on the CPU;
chip_smoke.py and tests/test_torch_scan_cuda.py hold the kernel against
the twin on the card, bit for bit, with the commit and the gate alone.
The corners: no pod accepted, every pod accepted, accepted pods sharing a
node (so a pair gains twice), terms on a key no node has, and the hard
affinity weight.  numpy only.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels import k14_cases

__all__ = ["cases", "round_state"]


def cases():
    """[(name, case)] of every K16 case, in a fixed order."""
    out = []
    for i, (name, case) in enumerate(k14_cases.affinity_cases()):
        rng = np.random.default_rng(460 + i)
        p = case["pods"]
        B, TP = p["valid"].shape[0], case["cluster"]["topo_pairs"].shape[1]
        N = case["cluster"]["valid"].shape[0]
        valid = p["valid"]
        share = (0.0, 1.0, 0.5)[i % 3]
        accept = valid & (rng.random(B) < share)
        active = valid & ~accept & (rng.random(B) < 0.7)
        # a handful of nodes, so accepted pods share them
        hosts = rng.integers(0, max(1, min(N, 5)), B).astype(np.int32)
        PT, AT = p["aff_term_valid"].shape[1], p["anti_term_valid"].shape[1]
        extra = {"uaff": rng.random((B, PT, TP)) < 0.05,
                 "uanti": rng.random((B, AT, TP)) < 0.05,
                 "uforb": rng.random((B, TP)) < 0.05,
                 "upref": (rng.integers(-20, 21, (B, TP))
                           * (rng.random((B, TP)) < 0.1)).astype(np.float32)}
        out.append((name, dict(case, round={
            "hosts": hosts, "accept": accept, "active": active,
            "extra": extra})))
    return out


def round_state(case, device="cpu"):
    """(cluster, pods, aff, carry, hosts, accept, hard_w): the case as the
    port's tensors on `device`, the carry holding the unions (the pods'
    own pair rows, the extra or'ed and added) and the gated aff_term_self
    (the pods' own), and "active"."""
    import torch

    from kubernetes_tpu_torch.codec import schema as ts
    from kubernetes_tpu_torch.models import batched, speculative

    ct = ts.cluster_to_torch(ts.ClusterTensors(**{
        k: torch.from_numpy(np.array(v))
        for k, v in case["cluster"].items()}), device)
    pb = ts.pods_to_torch(ts.PodBatch(**{
        k: torch.from_numpy(np.array(v))
        for k, v in case["pods"].items()}), device)
    aff = batched.BatchAffinityState(**{
        k: torch.from_numpy(np.array(v)).to(device)
        for k, v in case["aff"].items()})
    r = case["round"]
    c = speculative.affinity_carry({}, pb, ct.topo_pairs.shape[1])
    for k, v in r["extra"].items():
        x = torch.from_numpy(np.array(v)).to(device)
        c[k] = c[k] + x if k == "upref" else c[k] | x
    c["active"] = torch.from_numpy(np.array(r["active"])).to(device)
    hard_w = float(case["cfg"].get("hard_pod_affinity_weight", 1.0))
    return (ct, pb, aff, c, torch.from_numpy(np.array(r["hosts"])).to(device),
            torch.from_numpy(np.array(r["accept"])).to(device), hard_w)
