"""The cases kernel K11 (filter_pass.cu) is held to, in one place.

tests/test_torch_filter_pass.py holds K11's plain twin (ops/predicates.py
filter_batch_plain and predicate_stack_plain) against the jitted JAX
filter_batch and first_failure on every case on the CPU; chip_smoke.py
holds the kernel against its twin on the card on all of them, bit for bit,
in mask and stack mode.  kernels/k12_cases.py draws K12's cases from the
same worlds.  numpy only: one seed gives the same arrays on every machine.

A case is a dict: "cluster" and "pods", the fields of the schema's
ClusterTensors and PodBatch as numpy arrays (the shapes the encoder
emits, lean placeholders included), "cfg", the FilterConfig's keywords,
and "unsched_key".  `world` draws the snapshot and the batch from a small
vocabulary of ids, so that labels, taints, ports, volumes and pairs
match often; its keywords turn on the corners:

  * every selector operator (In, NotIn, Exists, DoesNotExist, Gt, Lt, and
    an unknown code), NaN and infinite numeric labels, the node-name
    field, empty terms and invalid expressions;
  * wildcard toleration keys, PAD toleration effects, Exists and Equal;
  * wildcard host IPs on either side;
  * per-CSI-driver attach columns (VT > 5), per-node limits and overlap;
  * profile subsets (`enabled`), label presence, service affinity;
  * padding rows (`n_valid`), invalid pods, N not a multiple of 4;
  * non-lean affinity and volume-topology terms (pair products), and
    batches lean in them.
"""

from __future__ import annotations

import numpy as np

PAD = -1
FIELD_NODE_NAME_ID = 1
ZONE_KEY = 5                # the zone pairs' topology key id
PREDICATE_ORDER_LEN = 23


def world(seed: int, B: int, N: int, *, L=6, T=4, P=4, Q=2, TT=3, NS=2,
          S=2, E=3, V=3, PS=2, TP=24, PT=2, AT=2, G=6, GP=2, I=4, C=2, A=2,
          DV=2, DVN=3, VZ=2, VB=2, VT=5, R=5, SA=1, n_valid=None,
          lean_affinity=True, lean_volumes=True, lean_spread=True,
          lean_overlap=True, zones=True, pod_validity=True) -> dict:
    """One snapshot of N node rows and a batch of B pods drawn from seed.
    The S and PS axes are 0 (the encoder's affinity-lean widths) when S or
    PS is 0; a lean family carries the encoder's width-1 placeholder."""
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, shape).astype(i32)

    def flags(p, *shape):
        return rng.random(shape) < p

    def padded(lo, hi, p_pad, *shape):
        x = ints(lo, hi, *shape)
        x[flags(p_pad, *shape)] = PAD
        return x

    valid = np.ones(N, bool)
    if n_valid is not None:
        valid[n_valid:] = False
    valid[flags(0.05, N)] = False
    allocatable = rng.integers(0, 9, (N, R)).astype(f32)
    allocatable[:, 0] *= 500.0
    allocatable[:, 1] *= 1024.0
    requested = np.minimum(allocatable,
                           rng.integers(0, 6, (N, R)).astype(f32))
    requested[:, 0] *= 250.0
    requested[:, 1] *= 512.0
    nonzero = np.stack([requested[:, 0] + 100.0,
                        requested[:, 1] + 200.0], 1).astype(f32)
    label_keys = padded(2, 9, 0.3, N, L)
    label_keys[:, 0] = np.where(flags(0.5, N), ZONE_KEY, label_keys[:, 0])
    label_vals = ints(0, 5, N, L)
    label_nums = label_vals.astype(f32)
    label_nums[flags(0.2, N, L)] = np.nan
    label_nums[flags(0.05, N, L)] = np.inf
    label_nums[flags(0.05, N, L)] = -np.inf
    label_vals[label_keys == PAD] = PAD
    # topology pairs: a zone pair a node (from its zone label), a hostname
    # pair a node for the first N pairs past the zones, a rack key
    n_zone_pairs = 3
    pair_topo_key = np.full(TP, PAD, i32)
    pair_topo_key[:n_zone_pairs] = ZONE_KEY if zones else 6
    pair_topo_key[n_zone_pairs:TP // 2] = 6
    pair_topo_key[TP // 2:TP - 2] = 7
    topo_pairs = np.zeros((N, TP), bool)
    zone = ints(0, n_zone_pairs, N)
    in_zone = flags(0.8, N)
    topo_pairs[np.arange(N)[in_zone], zone[in_zone]] = True
    topo_pairs[np.arange(N), n_zone_pairs + np.arange(N) % (TP // 2 - 3)] = \
        True
    topo_pairs[flags(0.3, N), TP // 2] = True
    cluster = dict(
        allocatable=allocatable, requested=requested, nonzero_req=nonzero,
        valid=valid, unschedulable=flags(0.1, N), not_ready=flags(0.05, N),
        mem_pressure=flags(0.1, N), disk_pressure=flags(0.05, N),
        pid_pressure=flags(0.05, N),
        node_name_id=(100 + np.arange(N)).astype(i32),
        label_keys=label_keys, label_vals=label_vals, label_nums=label_nums,
        taint_key=padded(2, 6, 0.4, N, T), taint_val=ints(0, 3, N, T),
        taint_effect=padded(0, 3, 0.7, N, T),
        port_pp=padded(0, 6, 0.3, N, P), port_ip=ints(0, 3, N, P),
        port_used=flags(0.4, N, P), topo_pairs=topo_pairs,
        group_counts=ints(0, 4, N, G).astype(f32),
        pair_topo_key=pair_topo_key,
        image_id=np.stack([rng.permutation(12)[:I] for _ in range(N)])
        .astype(i32),
        image_size=(rng.integers(1, 60, (N, I)) * (16 << 20)).astype(f32),
        avoid_owner=padded(0, 5, 0.6, N, A),
        vol_counts=ints(0, 4, N, VT).astype(f32),
        vol_limits=np.where(flags(0.7, N, VT), np.inf,
                            rng.integers(1, 6, (N, VT))).astype(f32),
        disk_vol_ids=padded(0, 10, 0.5, N, DVN))
    cluster["image_id"][flags(0.2, N, I)] = PAD

    pod_valid = flags(0.9, B) if pod_validity else np.ones(B, bool)
    pod_valid[:1] = True
    req = (rng.integers(0, 4, (B, R)) * flags(0.3, B, R)).astype(f32)
    req[:, 0] *= 250.0
    req[:, 1] *= 512.0
    req[:, 3] = 1.0
    SL, PSL = S, PS
    expr_key = padded(1, 9, 0.1, B, SL, E)
    expr_op = ints(0, 7, B, SL, E)
    pref_key = padded(1, 9, 0.1, B, PSL, E)
    pods = dict(
        valid=pod_valid, req=req,
        nonzero_req=np.stack([req[:, 0] + 100.0, req[:, 1] + 200.0], 1)
        .astype(f32),
        limits2=(rng.integers(0, 4, (B, 2)) * 1000.0).astype(f32),
        priority=ints(0, 3, B), best_effort=flags(0.3, B),
        ns_id=ints(0, 3, B), owner_uid=padded(0, 5, 0.3, B),
        node_name_req=np.where(flags(0.1, B),
                               100 + rng.integers(0, max(N, 1), B),
                               PAD).astype(i32),
        port_pp=padded(0, 6, 0.5, B, Q), port_ip=ints(0, 3, B, Q),
        port_valid=flags(0.3, B, Q),
        tol_key=padded(0, 6, 0.2, B, TT), tol_op=ints(0, 2, B, TT),
        tol_val=ints(0, 3, B, TT), tol_effect=padded(0, 3, 0.3, B, TT),
        tol_valid=flags(0.6, B, TT),
        ns_keys=padded(2, 9, 0.2, B, NS), ns_vals=ints(0, 5, B, NS),
        ns_valid=flags(0.15, B, NS),
        has_req_affinity=flags(0.35, B), term_valid=flags(0.7, B, SL),
        expr_key=expr_key, expr_op=expr_op,
        expr_vals=ints(0, 5, B, SL, E, V), expr_nval=ints(0, V + 1, B, SL, E),
        expr_num=np.where(flags(0.3, B, SL, E), np.nan,
                          rng.integers(-1, 6, (B, SL, E))).astype(f32),
        expr_valid=flags(0.6, B, SL, E),
        pref_weight=rng.integers(1, 100, (B, PSL)).astype(f32),
        pref_term_valid=flags(0.8, B, PSL),
        pref_expr_key=pref_key, pref_expr_op=ints(0, 7, B, PSL, E),
        pref_expr_vals=ints(0, 5, B, PSL, E, V),
        pref_expr_nval=ints(0, V + 1, B, PSL, E),
        pref_expr_num=np.where(flags(0.3, B, PSL, E), np.nan,
                               rng.integers(-1, 6, (B, PSL, E))).astype(f32),
        pref_expr_valid=flags(0.6, B, PSL, E),
        group_ids=padded(0, G, 0.3, B, GP), group_valid=flags(0.7, B, GP),
        svc_aff_fixed=padded(0, 4, 0.6, B, SA),
        svc_aff_d0=ints(-1, max(N, 1), B), svc_aff_d1=ints(-1, max(N, 1), B),
        image_ids=padded(0, 12, 0.3, B, C),
        image_bytes=np.zeros((B, C), f32),
        new_vol_counts=(rng.integers(0, 3, (B, VT))
                        * flags(0.5, B, VT)).astype(f32),
        disk_vol_ids=padded(0, 10, 0.6, B, DV),
        vol_fail_all=flags(0.05, B))
    pods["expr_key"][flags(0.1, B, SL, E)] = FIELD_NODE_NAME_ID
    pods["expr_vals"][..., 0] = np.where(
        pods["expr_key"] == FIELD_NODE_NAME_ID,
        100 + rng.integers(0, max(N, 1), (B, SL, E)),
        pods["expr_vals"][..., 0])
    tpa = 1 if lean_affinity else TP
    tpv = 1 if lean_volumes else TP

    def pairs(*shape, p=0.15):
        return flags(p, *shape) if shape[-1] > 1 else np.zeros(shape, bool)

    pods.update(
        forbidden_pairs=pairs(B, tpa, p=0.05),
        aff_term_pairs=pairs(B, PT, tpa, p=0.1),
        aff_term_valid=flags(0.5, B, PT), aff_term_self=flags(0.5, B, PT),
        aff_term_topo_key=ints(5, 8, B, PT),
        anti_term_pairs=pairs(B, AT, tpa, p=0.05),
        anti_term_valid=flags(0.5, B, AT),
        anti_term_topo_key=ints(5, 8, B, AT),
        anti_term_self=flags(0.5, B, AT),
        pref_pair_weights=(rng.integers(-3, 4, (B, tpa))
                           * flags(0.4, B, tpa)).astype(f32),
        vol_zone_pairs=pairs(B, VZ, tpv, p=0.4),
        vol_zone_valid=flags(0.3, B, VZ),
        vol_bind_pairs=pairs(B, VB, tpv, p=0.4),
        vol_bind_valid=flags(0.3, B, VB))
    if not lean_affinity:
        # terms that match no pair at all, for the bootstrap rule
        pods["aff_term_pairs"][flags(0.4, B)] = False
    pods["spread_counts"] = (np.zeros((B, 1), f32) if lean_spread else
                             rng.integers(0, 6, (B, N)).astype(f32))
    pods["vol_overlap"] = (np.zeros((B, VT, 1), f32) if lean_overlap else
                           rng.integers(0, 2, (B, VT, N)).astype(f32))
    return {"cluster": cluster, "pods": pods, "cfg": {},
            "unsched_key": 3}


SMALL = ((1, 1), (1, 5), (7, 3), (7, 64), (33, 130), (16, 1000))


def cases():
    """[(name, case)] of every K11 case, in a fixed order; the sizes stay
    small enough for the jitted JAX reference on the CPU."""
    out = []
    for i, (b, n) in enumerate(SMALL):
        out.append((f"lean-b{b}-n{n}", world(110 + i, b, n)))
    for i, (b, n) in enumerate(((1, 7), (9, 66), (33, 257))):
        out.append((f"affinity-b{b}-n{n}", world(
            120 + i, b, n, lean_affinity=False, lean_volumes=False,
            lean_overlap=False)))
    out.append(("selector-lean-s0", world(130, 12, 50, S=0, PS=0)))
    out.append(("csi-drivers", world(131, 9, 41, VT=8, lean_overlap=False)))
    c = world(132, 10, 45)
    c["cfg"] = {"enabled": ("CheckNodeCondition", "PodFitsHost",
                            "PodToleratesNodeTaints", "MaxCSIVolumeCount",
                            "MatchInterPodAffinity", "NotAPredicate")}
    out.append(("enabled-subset", c))
    c = world(133, 10, 45, lean_affinity=False)
    c["cfg"] = {"enabled": ("GeneralPredicates", "CheckServiceAffinity")}
    out.append(("general-only", c))
    c = world(134, 11, 39, SA=2)
    c["cfg"] = {"label_presence_keys": (2, 4), "label_presence_present":
                False, "service_affinity_labels": (3, 4)}
    out.append(("presence-and-service", c))
    c = world(135, 11, 39, SA=2)
    c["cfg"] = {"label_presence_keys": (3,), "label_presence_present": True,
                "service_affinity_labels": (2,),
                "max_vols": (1.0, 2.0, 3.0, 0.0, 1e9)}
    out.append(("presence-service-limits", c))
    out.append(("padding-rows", world(136, 8, 77, n_valid=50)))
    out.append(("no-zones", world(137, 5, 30, zones=False)))
    out.append(("all-pods-valid", world(138, 6, 12, pod_validity=False)))
    return out
