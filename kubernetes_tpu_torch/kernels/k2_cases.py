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
  heavy-node    110 victims on one row (the kubelet's pod cap)
  shared-vols   one volume identity held by three victims on a row, whose
                evicted count falls below its total partway through the
                reprieve
  empty-row     rows that need no victim, with and without a pod on them
                (criterion 5's F32_MAX and +inf)
and cases of their own shapes:
  block-edge    N = 300, victims on the first and last rows of 16-, 32- and
                64-row ranges, two listed pods outside [0, N)
  spread-1024   the 1,024-slot cap over 1,024 distinct rows of 1,100
  wide-31       random-0 with E = 31 and random-2 with E = 60 (copies of
  wide-60       the CPU column): the kernel's warp-a-row layouts
  wide-66       random-1 with E = 66 and shared-vols with E = 130: past
  wide-130      64 columns (the encoder's R of 64 and 128 give such E), the
                wide variant's freed sums in the workspace
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
         "order-f32", "heavy-node", "block-edge", "shared-vols",
         "spread-1024", "empty-row", "wide-31", "wide-60", "wide-66",
         "wide-130", "full-width")


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


def _arena(n_rows: int, M: int, pods, slack, cand_rows, need_cpu: float,
           holds=None, vid_types=(0,), vol_limit=None, need_vols: float = 0.0,
           shape: dict = SMALL) -> dict:
    """A case from a list of pods (row, priority, cpu milli, start): pod i
    at arena index i, requesting its CPU, 256Mi and one pod slot.  A row's
    allocatable CPU is its requested CPU plus slack[row] (a dict, default
    0), its pod cap 110; volume columns are the row's attached identities
    plus vol_limit[row] (default 16).  The preemptor asks for need_cpu, 128Mi,
    one pod slot and need_vols attachments of type 0; cand_rows are the
    candidates."""
    node = np.full(M, -1, np.int32)
    prio = np.zeros(M, np.int32)
    req = np.zeros((M, E), np.float32)
    start = np.zeros(M, np.float64)
    for i, (row, p, cpu, s) in enumerate(pods):
        node[i], prio[i] = row, p
        req[i, 0], req[i, 1], req[i, 3] = cpu, 2.0 ** 28, 1.0
        start[i] = 1.6e9 + s
    holds = holds or {}
    on = (node >= 0) & (node < n_rows)
    requested = np.zeros((n_rows, E), np.float32)
    np.add.at(requested, node[on], req[on])
    attached = np.zeros((n_rows, VT), np.float32)
    for row, v in {(int(node[m]), v) for m, vids in holds.items()
                   for v in vids if 0 <= node[m] < n_rows}:
        attached[row, vid_types[v]] += 1.0
    requested[:, R + 2:] = attached
    alloc = np.zeros((n_rows, E), np.float32)
    alloc[:, 0] = requested[:, 0]
    for row, s in slack.items():
        alloc[row, 0] += s
    alloc[:, 1] = requested[:, 1] + 2.0 ** 30
    alloc[:, 3] = 110.0
    alloc[:, R] = alloc[:, R + 1] = 0.5
    alloc[:, R + 2:] = attached + 16.0
    for row, lim in (vol_limit or {}).items():
        alloc[row, R + 2:] = attached[row] + lim
    pod_req = np.zeros(E, np.float32)
    pod_req[0], pod_req[1], pod_req[3] = need_cpu, 2.0 ** 27, 1.0
    pod_req[R + 2] = need_vols
    cand = np.zeros(n_rows, bool)
    cand[list(cand_rows)] = True
    arrs = dict(requested=requested, allocatable=alloc, pod_req=pod_req,
                candidates=cand, pods_node=node, pods_priority=prio,
                pods_req=req, pods_violating=np.zeros(M, bool), start=start,
                start_f64=start)
    return _finish(arrs, holds, list(vid_types), n_rows, shape)


def heavy_node_case(seed: int = 31) -> dict:
    """Row 40 holds 110 potential victims (the kubelet's pod cap, more than
    a warp has lanes), of priority 0-50, mixed CPU and shared node-local
    volumes; it is full on CPU and has room for one more attachment, and
    the preemptor needs 1.5 CPU and one attachment, so the reprieve walks
    all 110 and keeps most.  Rows 3 and 50 hold a few victims of priority
    60-70 each and are candidates too: row 40 wins."""
    rng = np.random.default_rng(seed)
    pods = [(40, int(rng.choice([0, 3, 7, 50])),
             float(rng.integers(1, 4) * 100), float(rng.integers(0, 30)))
            for _ in range(110)]
    pods += [(int(r), int(rng.choice([60, 70])), 400.0, float(i))
             for i, r in enumerate([3, 3, 3, 50, 50, 50, 50])]
    pods += [(int(r), 1000, 500.0, 0.0) for r in rng.integers(0, 64, 40)]
    holds = {}
    for m in range(110):
        k = int(rng.integers(0, 3))
        if k:
            holds[m] = sorted(rng.choice(3, k, replace=False).tolist())
    return _arena(64, 256, pods, {40: 0.0, 3: 300.0, 50: 100.0},
                  (3, 40, 50), 1500.0, holds, (0, 1, 2),
                  vol_limit={40: 1.0, 3: 1.0, 50: 1.0}, need_vols=1.0)


def block_edge_case() -> dict:
    """N = 300 rows, victims only on rows at the edges of 16-, 32- and
    64-row ranges and on the last row: 0, 15, 16, 31, 32, 63, 64, 95, 96,
    127, 128, 255, 256, 299.  Each such row holds a production pod and two
    victims and has room for one victim back.  Rows 31 and 32 tie on every
    criterion and beat the others on the highest victim priority, so row 31
    wins across the 31 | 32 boundary.  Two listed pods lie outside [0, N):
    one unassigned (node -1, reprieved on row 0) and one on node N
    (reprieved on row N-1); both come first in slot order and are not in
    any node's segment.  On row 299 the second one is re-admitted and
    takes the room one of the row's own victims would have had, so row
    299 ends with two victims; counted by segment alone it would keep one
    victim with the latest start and win."""
    rows = (0, 15, 16, 31, 32, 63, 64, 95, 96, 127, 128, 255, 256, 299)
    pods = []
    for r in rows:
        p = 3 if r in (31, 32, 299) else (5 if r < 31 else 4)
        s = 50.0 if r == 299 else 10.0
        pods += [(r, 1000, 1000.0, 0.0), (r, p, 500.0, s), (r, p, 500.0, s)]
    pods += [(int(r), 1000, 1000.0, 0.0) for r in range(1, 299, 7)]
    out = len(pods)
    pods += [(-1, 60, 500.0, 1.0), (300, 60, 500.0, 1.0)]
    case = _arena(300, 512, pods, {r: 500.0 for r in rows}, rows, 1000.0,
                  shape={})
    slots = case["victim_slots"]
    listed = np.concatenate([[out, out + 1],
                             slots[(slots >= 0) & (slots < out)]])
    k = len(slots)
    while k < len(listed):
        k *= 2
    case["victim_slots"] = _pad_to(listed.astype(np.int32), k, -1)
    case["slot_vids"] = np.full((k, case["slot_vids"].shape[1]), -1,
                                np.int32)
    return case


def shared_vols_case() -> dict:
    """Row 33 holds five victims A-E (priority 9 down to 5, 300m each)
    beside production pods, and must free 300m and one type-0 attachment.
    A, B and C hold one volume identity X, D alone holds Y, E holds Z with
    a production pod (so Z is never freed).  X and Y are fully listed: the
    initial credit is two attachments.  Reprieving A re-attaches X (its
    evicted count 3 is at its total), after which the count is 2, below
    the total, and B and C come back with no volume delta; D re-attaches Y
    and no longer fits; E comes back.  Row 34, the other candidate, cannot
    free enough CPU."""
    pods = [(33, p, 300.0, 0.0) for p in (9, 8, 7, 6, 5)]
    pods += [(33, 1000, 1000.0, 0.0), (34, 4, 300.0, 0.0),
             (34, 1000, 1000.0, 0.0)]
    pods += [(r, 1000, 500.0, 0.0) for r in range(0, 64, 3)]
    holds = {0: [0], 1: [0], 2: [0], 3: [1], 4: [2], 5: [2], 6: [1]}
    return _arena(64, 256, pods, {33: 700.0, 34: 0.0}, (33, 34), 1000.0,
                  holds, (0, 0, 0), vol_limit={33: 0.0, 34: 0.0},
                  need_vols=1.0)


def empty_row_case() -> dict:
    """Candidate rows the preemptor fits on with no victim: row 5 holds
    only production pods (none listed), row 7 holds two victims that are
    both re-admitted, rows 40 and 60 hold no pod at all.  Row 3 needs one
    victim.  With no victim the earliest-start key is F32_MAX on a row that
    holds a pod and +inf on a row that holds none (the reference's empty
    segment), so row 40 wins over the lower rows 5 and 7."""
    pods = [(5, 1000, 1000.0, 0.0), (5, 1000, 1000.0, 3.0),
            (7, 20, 300.0, 1.0), (7, 30, 300.0, 2.0), (7, 1000, 500.0, 0.0),
            (3, 10, 800.0, 4.0), (3, 1000, 1000.0, 0.0)]
    pods += [(r, 1000, 500.0, 0.0) for r in range(8, 32, 2)]
    return _arena(64, 256, pods, {5: 1000.0, 7: 2000.0, 40: 4000.0,
                                  60: 4000.0, 3: 200.0},
                  (3, 5, 7, 40, 60), 1000.0)


def spread_case(seed: int = 41) -> dict:
    """The 1,024-slot cap over 1,024 distinct rows of 1,100, one victim
    each (priority 0-9, distinct starts) beside a production pod, every
    row full: each of them is possible with its one victim, and the pick
    is the latest-started of the priority-0 victims, found across every
    block's range."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(1100)[:1024]
    prio = rng.integers(0, 10, 1024)
    starts = rng.permutation(1024).astype(np.float64)
    pods = [(int(r), int(p), 500.0, float(s))
            for r, p, s in zip(rows, prio, starts)]
    pods += [(int(r), 1000, 1000.0, 0.0) for r in range(1100)]
    return _arena(1100, 4096, pods, {}, rows.tolist(), 500.0, shape={})


def wide_case(base: dict, e: int) -> dict:
    """A case with e columns: base's with e - E copies of its CPU column put
    before the volume columns (so the fit test and freed see them as
    resources, and the answer is base's)."""
    extra = e - E

    def widen(a):
        dup = np.repeat(a[..., :1], extra, axis=-1)
        return np.concatenate([a[..., :R + 2], dup, a[..., R + 2:]], -1)

    case = dict(base)
    for k in ("requested", "allocatable", "pod_req", "pods_req"):
        case[k] = np.ascontiguousarray(widen(base[k]))
    return case


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
            ("heavy-node", heavy_node_case()),
            ("block-edge", block_edge_case()),
            ("shared-vols", shared_vols_case()),
            ("spread-1024", spread_case()),
            ("empty-row", empty_row_case()),
            ("wide-31", wide_case(random_case(0, need_cpu=600.0), 31)),
            ("wide-60", wide_case(random_case(2, need_cpu=1600.0), 60)),
            ("wide-66", wide_case(random_case(1, need_cpu=1100.0), 66)),
            ("wide-130", wide_case(shared_vols_case(), 130)),
            ("full-width", full_width_case())]
    return out
