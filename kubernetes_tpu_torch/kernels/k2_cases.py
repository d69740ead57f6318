"""The cases kernel K2 (preempt_one.cu) is held to, in one place.

tests/test_torch_preemption.py holds K2's plain twin (models/preemption.py
preempt_one_plain) against the JAX package's jitted preempt_one on these
inputs on the CPU, all four outputs bit for bit; chip_smoke.py holds the
kernel against its twin on the card.  The inputs come from numpy with one
seed each, so every machine sees the same arrays; the victim slots come
from the port's sorted_victim_slots (the reference's order and cap).

Every case is a dict of preempt_one's inputs in its argument order
(`ARGS`), with the five volume tables last.  The small cases share one
shape (N=64, M=256, Kv=256, VM=4, V=256; pads are -1 slots and sentinel
volume rows), so a jitted reference compiles once for all of them:
  random-*      random arenas: priorities over five levels, start-time
                ties, PDB-violating pods, shared node-local volumes
  pdb-ports     half the pods PDB-protected, host-port and disk-conflict
                columns in play
  pdb-all       every pod PDB-protected: the pick counts violations
  crowded       one candidate node holding about 100 potential victims
                (more than a warp has lanes)
  all-tie       identical nodes and victims: the first row must win
  no-candidate  no candidate node: node -1, an all-false mask
  impossible    nothing frees enough: node -1
  order-f32     three victims whose f32 request sum depends on the order of
                addition; the node fits with the reference's order
                (ascending arena index) and not with slot order
and one case at the live cell's full shape (N=6,144 rows of which 5,000
nodes, M=32,768, 20,500 running pods with 2,000 potential victims, so the
1,024-slot cap binds).
"""

from __future__ import annotations

import numpy as np

ARGS = ("requested", "allocatable", "pod_req", "candidates", "pods_node",
        "pods_priority", "pods_req", "pods_violating", "pods_start",
        "victim_slots", "slot_vids", "vid_type", "vid_total", "vid_listed",
        "freed_vol_init")
R, VT = 8, 5
E = R + 2 + VT
SMALL = dict(kv=256, vm=4, nv=256)
PREEMPTOR_PRIORITY = 100
NAMES = ("random-0", "random-1", "random-2", "random-3", "pdb-ports",
         "pdb-all", "crowded", "all-tie", "no-candidate", "impossible",
         "order-f32", "full-width")


def _pad_to(a: np.ndarray, n: int, fill, axis: int = 0) -> np.ndarray:
    if a.shape[axis] > n:
        raise ValueError(f"{a.shape} does not fit {n} on axis {axis}")
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths, constant_values=fill)


def _volume_tables(slots, pods_node, holds, n_rows, vid_types):
    """encoder.victim_volume_tables' format: per listed slot the indices
    of the (node, vid) identities its pod holds, their type, holders among
    all assigned pods, holders among the listed slots, and the initial
    credit (an identity every holder of which is listed frees one
    attachment)."""
    total: dict = {}
    for m, vids in holds.items():
        for vid in vids:
            key = (int(pods_node[m]), vid)
            total[key] = total.get(key, 0) + 1
    index: dict = {}
    types, totals, listed, per_slot = [], [], [], []
    for s in slots.tolist():
        vids = []
        if s >= 0:
            for vid in holds.get(s, ()):
                key = (int(pods_node[s]), vid)
                j = index.get(key)
                if j is None:
                    j = index[key] = len(types)
                    types.append(vid_types[vid])
                    totals.append(total[key])
                    listed.append(0)
                listed[j] += 1
                vids.append(j)
        per_slot.append(vids)
    vm = 1
    while vm < max((len(v) for v in per_slot), default=1):
        vm *= 2
    nv = 1
    while nv < max(len(types), 1):
        nv *= 2
    slot_vids = np.full((len(per_slot), vm), -1, np.int32)
    for i, vids in enumerate(per_slot):
        slot_vids[i, :len(vids)] = vids
    t_arr = np.full(nv + 1, VT, np.int32)
    t_arr[:len(types)] = types
    tot = np.full(nv + 1, 1 << 30, np.int32)
    tot[:len(totals)] = totals
    lst = np.zeros(nv + 1, np.int32)
    lst[:len(listed)] = listed
    init = np.zeros((n_rows, VT), np.float32)
    for (row, vid), j in index.items():
        if listed[j] >= totals[j]:
            init[row, vid_types[vid]] += 1.0
    return slot_vids, t_arr, tot, lst, init


def _finish(arrs: dict, holds: dict, vid_types, n_rows: int, shape: dict):
    """Slots, volume tables and the pads of `shape` (kv, vm, nv: the sizes
    the slot and volume arrays are padded to; None keeps them)."""
    from kubernetes_tpu_torch.models.preemption import (
        dense_start_ranks,
        sorted_victim_slots,
    )

    node, prio = arrs["pods_node"], arrs["pods_priority"]
    slots = sorted_victim_slots(prio, node >= 0, node, PREEMPTOR_PRIORITY,
                                arrs["pods_violating"], arrs.pop("start"))
    arrs["pods_start"] = dense_start_ranks(arrs.pop("start_f64"))
    sv, vt, tot, lst, init = _volume_tables(slots, node, holds, n_rows,
                                            vid_types)
    if shape.get("kv"):
        slots = _pad_to(slots, shape["kv"], -1)
        sv = _pad_to(sv, shape["kv"], -1)
    if shape.get("vm"):
        sv = _pad_to(sv, shape["vm"], -1, axis=1)
    if shape.get("nv"):
        # the sentinel must stay the last row
        n = shape["nv"]
        vt = np.concatenate([_pad_to(vt[:-1], n - 1, VT), vt[-1:]])
        tot = np.concatenate([_pad_to(tot[:-1], n - 1, 1 << 30), tot[-1:]])
        lst = np.concatenate([_pad_to(lst[:-1], n - 1, 0), lst[-1:]])
    arrs.update(victim_slots=slots.astype(np.int32), slot_vids=sv,
                vid_type=vt, vid_total=tot, vid_listed=lst,
                freed_vol_init=init)
    return {k: arrs[k] for k in ARGS}


def random_case(seed: int, n_nodes: int = 50, n_rows: int = 64,
                m_cap: int = 256, n_pods: int = 150, viol_frac: float = 0.1,
                ports: bool = False, levels=(0, 1, 2, 5, 1000),
                starts: int = 40, cand_frac: float = 0.9,
                need_cpu: float = 600.0, shape: dict = SMALL) -> dict:
    """A random arena: n_pods pods on n_nodes of n_rows rows, at random
    arena indices of m_cap; nodes nearly full, the preemptor (priority
    100) asking for more than most nodes have left."""
    rng = np.random.default_rng(seed)
    M = m_cap
    where = rng.permutation(M)[:n_pods]
    node = np.full(M, -1, np.int32)
    node[where] = rng.integers(0, n_nodes, n_pods)
    prio = np.zeros(M, np.int32)
    prio[where] = rng.choice(np.asarray(levels, np.int32), n_pods)
    req = np.zeros((M, E), np.float32)
    req[where, 0] = rng.integers(1, 9, n_pods) * 100.0         # cpu milli
    req[where, 1] = rng.integers(1, 9, n_pods) * 2.0 ** 28     # memory
    req[where, 3] = 1.0                                         # pods
    if ports:
        req[where, R] = rng.random(n_pods) < 0.3
        req[where, R + 1] = rng.random(n_pods) < 0.2
    viol = np.zeros(M, bool)
    viol[where] = rng.random(n_pods) < viol_frac
    start = np.zeros(M, np.float64)
    start[where] = 1.6e9 + rng.integers(0, starts, n_pods) * 17.0
    vid_types = [v % VT for v in range(3)]
    holds = {}
    for m in where.tolist():
        k = int(rng.integers(0, 3))
        if k:
            holds[m] = sorted(rng.choice(3, k, replace=False).tolist())
    on = node >= 0
    requested = np.zeros((n_rows, E), np.float32)
    np.add.at(requested, node[on], req[on])
    attached = np.zeros((n_rows, VT), np.float32)
    seen = {(int(node[m]), v) for m, vids in holds.items() for v in vids}
    for row, v in seen:
        attached[row, vid_types[v]] += 1.0
    requested[:, R + 2:] = attached
    alloc = np.zeros((n_rows, E), np.float32)
    alloc[:, :R] = requested[:, :R] + rng.integers(0, 4, (n_rows, 1)) * 100.0
    alloc[:, 1] = requested[:, 1] + 2.0 ** 30
    alloc[:, 3] = 110.0
    alloc[:, R] = alloc[:, R + 1] = 0.5
    alloc[:, R + 2:] = attached + rng.integers(0, 2, (n_rows, VT))
    pod_req = np.zeros(E, np.float32)
    pod_req[0], pod_req[1], pod_req[3] = need_cpu, 2.0 ** 29, 1.0
    if ports:
        pod_req[R] = pod_req[R + 1] = 0.25
    pod_req[R + 2] = 1.0                     # one new attachment of type 0
    cand = np.zeros(n_rows, bool)
    cand[:n_nodes] = rng.random(n_nodes) < cand_frac
    arrs = dict(requested=requested, allocatable=alloc, pod_req=pod_req,
                candidates=cand, pods_node=node, pods_priority=prio,
                pods_req=req, pods_violating=viol, start=start,
                start_f64=start)
    return _finish(arrs, holds, vid_types, n_rows, shape)


def crowded_case(seed: int = 7) -> dict:
    """Node 0, the one candidate, holds about 100 potential victims of mixed
    priority, node 1 the rest: the reprieve walks more slots on one node
    than a warp has lanes."""
    case = random_case(seed, n_nodes=2, n_pods=120, levels=(0, 3, 7))
    node = case["pods_node"]
    on = node >= 0
    case["pods_node"] = np.where(on, np.where(np.arange(len(node)) % 7 == 0,
                                              1, 0), -1).astype(np.int32)
    return _refinish(case, seed)


def _refinish(case: dict, seed: int) -> dict:
    """Rebuild a case's slots, node sums and tables after its pods moved."""
    rng = np.random.default_rng(seed + 1)
    node, req = case["pods_node"], case["pods_req"]
    n_rows = case["requested"].shape[0]
    on = node >= 0
    requested = np.zeros_like(case["requested"])
    np.add.at(requested, node[on], req[on])
    alloc = case["allocatable"].copy()
    alloc[:, 0] = requested[:, 0] + 200.0
    alloc[:, 1] = requested[:, 1] + 2.0 ** 30
    alloc[:, 3] = 200.0
    alloc[:, R + 2:] = 16.0
    case["requested"], case["allocatable"] = requested, alloc
    start = case["pods_start"].astype(np.float64)
    arrs = dict(case, start=start, start_f64=start)
    arrs["candidates"] = np.arange(n_rows) == 0
    return _finish(arrs, {}, [0], n_rows, SMALL)


def all_tie_case() -> dict:
    """Eight identical full nodes, each with the same four victims (one
    priority, one start rank): every criterion ties, the first row wins."""
    M, n_nodes, n_rows = 256, 8, 64
    node = np.full(M, -1, np.int32)
    prio = np.zeros(M, np.int32)
    req = np.zeros((M, E), np.float32)
    for i in range(n_nodes * 4):
        node[3 + i * 5] = i % n_nodes
        prio[3 + i * 5] = 7
        req[3 + i * 5, 0] = 500.0
        req[3 + i * 5, 3] = 1.0
    requested = np.zeros((n_rows, E), np.float32)
    on = node >= 0
    np.add.at(requested, node[on], req[on])
    alloc = np.zeros((n_rows, E), np.float32)
    alloc[:, 0] = 2000.0
    alloc[:, 3] = 110.0
    alloc[:, R] = alloc[:, R + 1] = 0.5
    alloc[:, R + 2:] = 16.0
    pod_req = np.zeros(E, np.float32)
    pod_req[0], pod_req[3] = 1500.0, 1.0
    cand = np.zeros(n_rows, bool)
    cand[2:n_nodes] = True           # rows 0 and 1 are not candidates
    start = np.zeros(M, np.float64)
    arrs = dict(requested=requested, allocatable=alloc, pod_req=pod_req,
                candidates=cand, pods_node=node, pods_priority=prio,
                pods_req=req, pods_violating=np.zeros(M, bool), start=start,
                start_f64=start)
    return _finish(arrs, {}, [0], n_rows, SMALL)


def order_f32_case() -> dict:
    """Three victims on node 0 whose f32 memory requests sum to different
    values in ascending arena index and in slot order (priority 1, 5, 9 at
    arena indices 0, 1, 2, so slot order is 2, 1, 0).  The node's
    requested memory is the reference's sum and the preemptor asks for 1
    of 1 left after the eviction: it fits with the reference's order of
    addition and not with slot order."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    while True:
        a, b, c = (f32(x) for x in rng.uniform(1e8, 9e8, 3))
        by_m = f32(f32(f32(f32(0) + a) + b) + c)
        by_slot = f32(f32(f32(f32(0) + c) + b) + a)
        if by_slot < by_m:
            break
    M, n_rows = 256, 64
    node = np.full(M, -1, np.int32)
    node[:3] = 0
    prio = np.zeros(M, np.int32)
    prio[:3] = (1, 5, 9)
    req = np.zeros((M, E), np.float32)
    req[:3, 1] = (a, b, c)
    requested = np.zeros((n_rows, E), np.float32)
    requested[0, 1] = by_m
    pod_req = np.zeros(E, np.float32)
    pod_req[1] = 1.0
    alloc = np.zeros((n_rows, E), np.float32)
    alloc[:, 1] = 1.0
    alloc[:, R] = alloc[:, R + 1] = 0.5
    alloc[:, R + 2:] = 16.0
    cand = np.zeros(n_rows, bool)
    cand[0] = True
    start = np.zeros(M, np.float64)
    arrs = dict(requested=requested, allocatable=alloc, pod_req=pod_req,
                candidates=cand, pods_node=node, pods_priority=prio,
                pods_req=req, pods_violating=np.zeros(M, bool), start=start,
                start_f64=start)
    return _finish(arrs, {}, [0], n_rows, SMALL)


def full_width_case(seed: int = 5) -> dict:
    """The live cell's shape: 5,000 nodes in 6,144 rows, an arena of 32,768
    with 20,500 running pods, 2,000 of them below the preemptor's priority
    (so sorted_victim_slots keeps 1,024), nodes at 4 CPU."""
    rng = np.random.default_rng(seed)
    n_nodes, n_rows, M, n_pods, n_low = 5000, 6144, 32768, 20500, 2000
    where = rng.permutation(M)[:n_pods]
    node = np.full(M, -1, np.int32)
    node[where] = rng.integers(0, n_nodes, n_pods)
    prio = np.zeros(M, np.int32)
    prio[where] = 1000
    low = where[:n_low]
    prio[low] = rng.choice(np.asarray([0, 10, 20], np.int32), n_low)
    req = np.zeros((M, E), np.float32)
    req[where, 0] = rng.choice(np.asarray([500.0, 1000.0], np.float32),
                               n_pods)
    req[where, 1] = 2.0 ** 29
    req[where, 3] = 1.0
    viol = np.zeros(M, bool)
    viol[low] = rng.random(n_low) < 0.05
    start = np.zeros(M, np.float64)
    start[where] = 1.6e9 + rng.permutation(n_pods) * 3.0
    requested = np.zeros((n_rows, E), np.float32)
    on = node >= 0
    np.add.at(requested, node[on], req[on])
    alloc = np.zeros((n_rows, E), np.float32)
    alloc[:n_nodes, 0] = np.maximum(4000.0, requested[:n_nodes, 0])
    alloc[:n_nodes, 1] = 2.0 ** 35
    alloc[:n_nodes, 3] = 110.0
    alloc[:, R] = alloc[:, R + 1] = 0.5
    alloc[:, R + 2:] = 16.0
    pod_req = np.zeros(E, np.float32)
    pod_req[0], pod_req[1], pod_req[3] = 1500.0, 2.0 ** 30, 1.0
    cand = np.zeros(n_rows, bool)
    cand[:n_nodes] = requested[:n_nodes, 0] + 1500.0 > alloc[:n_nodes, 0]
    cand[:n_nodes:50] = False                       # tainted nodes
    arrs = dict(requested=requested, allocatable=alloc, pod_req=pod_req,
                candidates=cand, pods_node=node, pods_priority=prio,
                pods_req=req, pods_violating=viol, start=start,
                start_f64=start)
    return _finish(arrs, {}, [0], n_rows, {})


def no_candidate_case() -> dict:
    case = random_case(3)
    case["candidates"] = np.zeros_like(case["candidates"])
    return case


def impossible_case() -> dict:
    case = random_case(4)
    case["pod_req"] = case["pod_req"].copy()
    case["pod_req"][0] = 1e6
    return case


def cases() -> list:
    """[(name, case)] in a fixed order: the small cases, then full width."""
    out = [(f"random-{s}", random_case(s, need_cpu=600.0 + 500.0 * s))
           for s in range(4)]
    out += [("pdb-ports", random_case(21, viol_frac=0.5, ports=True,
                                      need_cpu=1100.0)),
            ("pdb-all", random_case(22, viol_frac=1.0, need_cpu=1600.0)),
            ("crowded", crowded_case()),
            ("all-tie", all_tie_case()),
            ("no-candidate", no_candidate_case()),
            ("impossible", impossible_case()),
            ("order-f32", order_f32_case()),
            ("full-width", full_width_case())]
    return out
