"""The cases kernel K10 (reconcile_admit.cu) is held to, in one place.

tests/test_torch_replicas.py holds K10's plain twin
(runtime/reconciler.py admit_scan_plain) against the JAX package's jitted
ConflictReconciler._kernel on these cases on the CPU; chip_smoke.py holds
the kernel against its twin on the card on all of them, bit for bit.
numpy only: one seed gives the same arrays on every machine.

Each case is a dict of the scan's inputs as the reconciler builds them:
u_node, u_ns (first-occurrence segment slots), order (the DRF order, a
permutation) i32[Bp] and reqs, node_head, ns_head f32[Bp, R].  B real
candidates are padded to Bp = the next power of two with zero requests,
+inf headroom and the dummy segment B (clamped to Bp - 1).  The cases
cover every candidate on one node, every candidate in one tenant, quota
vetoes (finite tenant headroom), an unset quota (+inf headroom), stale
rows (a node whose headroom a sibling already spent below zero), requests
exactly at the headroom plus the 1e-3 slack, Bp 1 and 2,048 and R from 1
to 33.
"""

from __future__ import annotations

import numpy as np


def build(rng, b: int, r: int, n_nodes: int, n_tenants: int,
          quota: bool = True, head_hi: float = 12.0):
    """B candidates on random nodes and tenants, padded as the reconciler
    pads them."""
    rows = rng.integers(0, n_nodes, b)
    tenants = rng.integers(0, n_tenants, b)
    reqs = rng.integers(0, 4, (b, r)).astype(np.float32)
    node_row_head = rng.integers(0, int(head_hi), (n_nodes, r)).astype(
        np.float32)
    ten_head = (rng.integers(0, int(3 * head_hi), (n_tenants, r)).astype(
        np.float32) if quota else np.full((n_tenants, r), np.inf, np.float32))
    node_head = node_row_head[rows]
    ns_head = ten_head[tenants]
    shares = rng.random(n_tenants)[tenants]
    order = np.lexsort((np.arange(b), shares)).astype(np.int32)
    u_node = np.zeros(b, np.int32)
    seen: dict = {}
    for j in range(b):
        u_node[j] = seen.setdefault(int(rows[j]), j)
    u_ns = np.zeros(b, np.int32)
    seen = {}
    for j in range(b):
        u_ns[j] = seen.setdefault(int(tenants[j]), j)
    bp = 1
    while bp < b:
        bp *= 2
    if bp != b:
        pad = bp - b
        u_node = np.minimum(np.concatenate(
            [u_node, np.full(pad, b, np.int32)]), bp - 1)
        u_ns = np.minimum(np.concatenate(
            [u_ns, np.full(pad, b, np.int32)]), bp - 1)
        reqs = np.vstack([reqs, np.zeros((pad, r), np.float32)])
        inf_head = np.full((pad, r), np.inf, np.float32)
        node_head = np.vstack([node_head, inf_head])
        ns_head = np.vstack([ns_head, inf_head])
        order = np.concatenate([order, np.arange(b, bp, dtype=np.int32)])
    return dict(u_node=u_node, u_ns=u_ns, order=order, reqs=reqs,
                node_head=node_head, ns_head=ns_head)


def cases():
    """[(name, case dict)] in a fixed order, Bp 2,048 x R 8 last."""
    rng = np.random.default_rng(20261105)
    out = [("bp1", build(rng, 1, 8, 1, 1))]
    for b, r in ((3, 1), (7, 4), (100, 8), (300, 33)):
        out.append((f"b{b}-r{r}", build(rng, b, r, max(1, b // 4), 3)))
    out.append(("one-node", build(rng, 64, 8, 1, 4, head_hi=40.0)))
    out.append(("one-tenant", build(rng, 64, 8, 16, 1, head_hi=30.0)))
    out.append(("no-quota", build(rng, 200, 8, 20, 5, quota=False)))
    c = build(rng, 128, 8, 32, 4)
    c["ns_head"][c["ns_head"] != np.inf] = np.minimum(
        c["ns_head"][c["ns_head"] != np.inf], 2.0)
    out.append(("quota-vetoes", c))
    c = build(rng, 64, 4, 8, 2)
    real = np.isfinite(c["node_head"][:, 0])
    c["node_head"][real & (c["u_node"] % 2 == 0)] = -3.0
    out.append(("stale-rows", c))
    # requests exactly at headroom + slack, and just past it
    c = build(rng, 16, 2, 16, 16, quota=False)
    c["node_head"][:16] = np.float32(1.0)
    c["reqs"][:16] = np.float32(1.0) + np.float32(1e-3)
    c["reqs"][8:16] = np.nextafter(c["reqs"][8:16], np.float32(2.0))
    out.append(("slack-edge", c))
    out.append(("bp2048", build(rng, 2048, 8, 1200, 6, head_hi=16.0)))
    return out
