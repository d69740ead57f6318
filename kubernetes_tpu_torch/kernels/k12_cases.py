"""The cases kernel K12 (score_pass.cu) is held to, in one place.

tests/test_torch_score_pass.py holds K12's plain twin (ops/priorities.py
score_batch_plain) against the jitted JAX score_batch on every case on the
CPU, the total and every priority row, with need_per on and off;
chip_smoke.py holds the kernel against its twin on the card on all of
them, bit for bit.  numpy only.

A case is a kernels/k11_cases.py world (its "cluster" and "pods") plus
"weights" (12 f32 in PRIORITY_ORDER), "score_cfg" (the ScoreConfig's
keywords), "zone_key" and "skip_zero_weight".  The corners: the stock
weights, every priority on, a Policy's weights (MostRequested, NodeLabel,
RequestedToCapacityRatio, ResourceLimits), skip_zero_weight; shipped
multi-group spread counts and the group-column path of spread-lean
batches; fleets without zones; padding rows; N not a multiple of 4;
normalizations whose maximum is 0 (no preferred term matches, no
PreferNoSchedule taint) and the reversed one; InterPodAffinity with and
without spread between the valid nodes; ImageLocality below and above
its clamps; the RTC curve's end points, a vertical step and utilization
past 100%; and a snapshot past the shared-memory tile of one block
(NodeAffinity sums and zone slots above 96 KB).

The cases after it pin the edges of the kernel's layout (a cluster of
blocks over the node axis, a tile of pods a cluster:
kernels.score_pass_paths); each names the edges it pins in "pins", and
PINS holds the path's condition for each, which the CPU tests and
chip_smoke.py check: N below the cluster's blocks, N not a multiple of
blocks x threads, two or more nodes a thread, each reduction's extreme
in the last block alone, a block of invalid nodes, InterPodAffinity with
min == max != 0, a zone key whose pairs hold no node, zones in every
block, B not a multiple of the pod tile, and the workspace at many zone
pairs.  Every snapshot here keeps the node-pair invariant (a node in at
most one pair a topology key): K12 reads each node's zone from the
node-pair table.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels.k11_cases import ZONE_KEY, world

# the layout edge a case pins: the path's condition for it, on
# (path, B, N) (path: kernels.ScorePassPath)
PINS = {
    "blocks-without-nodes": lambda p, B, N: N <= (p.cluster - 1) * p.slice,
    "ragged-last-block": lambda p, B, N: (
        N % (p.cluster * p.threads * p.per_thread) != 0
        and (p.cluster - 1) * p.slice < N < p.cluster * p.slice),
    "nodes-a-thread": lambda p, B, N: p.per_thread >= 2,
    "last-block": lambda p, B, N: (p.cluster - 1) * p.slice < N,
    "tiles": lambda p, B, N: p.tiles >= 2 and B % p.tile != 0,
    "workspace": lambda p, B, N: not p.smem,
    "shared-memory": lambda p, B, N: p.smem,
}

STOCK = (1.0, 1.0, 1.0, 1.0, 10000.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0)
EVERY = (1.0, 1.0, 1.0, 1.0, 10000.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
POLICY = (2.0, 0.0, 0.0, 1.0, 10000.0, 3.0, 0.0, 1.0, 2.0, 1.0, 5.0, 1.0)
RTC = ((0.0, 0.0), (30.0, 7.0), (100.0, 10.0))
RTC_STEP = ((10.0, 10.0), (50.0, 4.0), (50.0, 8.0), (90.0, 0.0))


def score_case(w, *, weights=STOCK, label_prefs=(), rtc_shape=RTC,
               skip_zero_weight=False) -> dict:
    w.update(weights=np.asarray(weights, np.float32),
             score_cfg={"label_prefs": tuple(label_prefs),
                        "rtc_shape": tuple(rtc_shape)},
             zone_key=ZONE_KEY, skip_zero_weight=skip_zero_weight)
    return w


def cases():
    """[(name, case)] of every K12 case, in a fixed order."""
    out = []
    for i, (b, n) in enumerate(((1, 1), (1, 5), (7, 3), (7, 64),
                                (33, 130), (16, 1000))):
        out.append((f"stock-b{b}-n{n}",
                    score_case(world(210 + i, b, n))))
    out.append(("every-priority", score_case(
        world(220, 9, 77), weights=EVERY,
        label_prefs=((3, True, 2.0), (4, False, 1.0)))))
    out.append(("policy-skip-zero", score_case(
        world(221, 9, 77), weights=POLICY, label_prefs=((2, True, 3.0),),
        rtc_shape=RTC_STEP, skip_zero_weight=True)))
    out.append(("dense-spread", score_case(
        world(222, 12, 90, lean_spread=False), weights=EVERY)))
    c = world(223, 6, 40, zones=False)
    # the three pairs the zone key would have belong to a key of their
    # own, so no node lies in two pairs of one key
    c["cluster"]["pair_topo_key"][:3] = 8
    out.append(("no-zones", score_case(c, weights=EVERY)))
    out.append(("affinity-ipa", score_case(
        world(224, 10, 66, lean_affinity=False), weights=EVERY)))
    c = world(225, 5, 33, lean_affinity=False)
    c["pods"]["pref_pair_weights"][:] = 0.0
    out.append(("ipa-zero-spread", score_case(c, weights=EVERY)))
    c = world(226, 6, 37)
    c["pods"]["pref_term_valid"][:] = False
    c["cluster"]["taint_effect"][c["cluster"]["taint_effect"] == 1] = 0
    out.append(("zero-maxima", score_case(c, weights=EVERY)))
    c = world(227, 6, 37, C=4)
    sizes = c["cluster"]["image_size"]
    sizes[::3] = np.float32(1 << 20)          # below the 23 MB clamp
    sizes[1::3] = np.float32(900 << 20)       # pairs sum past 1,000 MB
    c["pods"]["image_ids"][:, :2] = c["cluster"]["image_id"][0, :2]
    out.append(("image-clamps", score_case(c, weights=EVERY)))
    c = world(228, 8, 29)
    c["pods"]["nonzero_req"][::2] = 0.0
    c["pods"]["nonzero_req"][1::4] *= 50.0    # past the node's capacity
    c["cluster"]["allocatable"][::5, :2] = 0.0
    out.append(("rtc-ends", score_case(c, weights=EVERY,
                                       rtc_shape=RTC_STEP)))
    out.append(("padding-rows", score_case(
        world(229, 8, 77, n_valid=50), weights=EVERY)))
    out.append(("past-the-smem-tile", score_case(
        world(230, 2, 30001, TP=64), weights=EVERY)))
    out += layout_cases()
    return out


def _pinned(case, *pins):
    case["pins"] = pins
    return case


def _zones(c, n_zones: int, zone_of, TP: int):
    """The case's snapshot re-laid with n_zones zone pairs (pairs
    [0, n_zones)), node n in zone zone_of(n) (-1: none), a pair of key 6
    a node after them (node n's own while they last), one pair of key 7
    on some nodes; the IPA weights follow the pair axis."""
    cl = c["cluster"]
    N = cl["valid"].shape[0]
    rng = np.random.default_rng(N + n_zones)
    key = np.full(TP, -1, np.int32)
    key[:n_zones] = ZONE_KEY
    host = max(TP - n_zones - 4, 1)
    key[n_zones:n_zones + host] = 6
    key[n_zones + host:TP - 2] = 7
    topo = np.zeros((N, TP), bool)
    for n in range(N):
        z = zone_of(n)
        if z >= 0:
            topo[n, z] = True
        topo[n, n_zones + n % host] = True
    topo[rng.random(N) < 0.3, n_zones + host] = True
    cl["topo_pairs"], cl["pair_topo_key"] = topo, key
    w = c["pods"]["pref_pair_weights"]
    if w.shape[-1] > 1:
        c["pods"]["pref_pair_weights"] = (
            rng.integers(-3, 4, (w.shape[0], TP))
            * (rng.random((w.shape[0], TP)) < 0.4)).astype(np.float32)
    return c


def layout_cases():
    """[(name, case)] of the cases that pin the kernel's layout edges, in
    a fixed order (each case's "pins" names them, PINS checks them)."""
    out = []
    out.append(("n-below-the-cluster", _pinned(score_case(
        world(231, 3, 5, lean_affinity=False), weights=EVERY),
        "blocks-without-nodes")))
    out.append(("n-ragged", _pinned(score_case(
        world(232, 5, 1000, lean_affinity=False, lean_spread=False),
        weights=EVERY), "ragged-last-block")))
    out.append(("n16400-nodes-a-thread", _pinned(score_case(
        world(233, 1, 16400), weights=EVERY), "nodes-a-thread",
        "ragged-last-block")))
    # every reduction's extreme in the last block's nodes alone (nodes
    # 960-999 of 1,000 at 64 a block)
    c = world(234, 3, 1000, TP=2048, lean_affinity=False, lean_spread=False)
    cl, pods = c["cluster"], c["pods"]
    last = np.arange(1000) >= 960
    cl["valid"][960:] = True
    pods["spread_counts"][:] = np.minimum(pods["spread_counts"], 2.0)
    pods["spread_counts"][:, 990] = 9.0
    cl["taint_effect"][:] = 0
    cl["taint_effect"][last, :2] = 1
    cl["label_keys"][:, 1] = np.where(last, 9, -1)
    cl["label_vals"][:, 1] = np.where(last, 1, -1)
    pods["pref_term_valid"][:] = True
    pods["pref_expr_valid"][:] = False
    pods["pref_expr_valid"][:, :, 0] = True
    pods["pref_expr_key"][:, :, 0] = 9
    pods["pref_expr_op"][:, :, 0] = 2              # Exists
    w = np.zeros_like(pods["pref_pair_weights"])
    host = 3 + np.arange(1000) % (2048 // 2 - 3)
    w[:, host[990]] = 3.0
    w[:, host[995]] = -3.0
    pods["pref_pair_weights"] = w
    out.append(("extremes-in-the-last-block", _pinned(score_case(
        c, weights=EVERY), "last-block")))
    # a block whose nodes are all invalid, its IPA sums all NaN
    c = world(235, 4, 500, lean_affinity=False)
    c["cluster"]["valid"][64:96] = False
    out.append(("invalid-block", _pinned(score_case(c, weights=EVERY),
                                         "last-block")))
    # IPA with min == max != 0: every node in one zone pair of weight 2
    c = world(236, 4, 300, lean_affinity=False)
    cl = c["cluster"]
    cl["topo_pairs"][:, :3] = False
    cl["topo_pairs"][np.arange(300), np.arange(300) % 3] = True
    c["pods"]["pref_pair_weights"][:] = 0.0
    c["pods"]["pref_pair_weights"][:, :3] = 2.0
    out.append(("ipa-min-equals-max", score_case(c, weights=EVERY)))
    # the zone key's pairs hold no node: zones on, have_zones false
    c = world(237, 5, 200)
    c["cluster"]["topo_pairs"][:, :3] = False
    out.append(("zone-pairs-without-nodes", score_case(c, weights=EVERY)))
    # 40 zones across the 16 blocks, each block's nodes in several
    c = _zones(world(238, 6, 1000, lean_affinity=False, TP=1200), 40,
               lambda n: -1 if n % 11 == 0 else (n * 7) % 40, 1200)
    out.append(("zones-in-every-block", _pinned(score_case(
        c, weights=EVERY), "last-block", "shared-memory")))
    out.append(("b37-ragged-tile", _pinned(score_case(
        world(239, 37, 300, lean_affinity=False, lean_spread=False),
        weights=EVERY), "tiles")))
    # 12,000 zone pairs: a tile's zone partials pass the shared memory
    c = _zones(world(240, 3, 200, TP=12400), 12000,
               lambda n: (n * 53) % 12000 if n % 9 else -1, 12400)
    out.append(("workspace-many-zones", _pinned(score_case(
        c, weights=EVERY), "workspace")))
    return out
