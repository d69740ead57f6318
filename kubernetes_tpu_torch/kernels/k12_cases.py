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
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels.k11_cases import ZONE_KEY, world

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
    out.append(("no-zones", score_case(
        world(223, 6, 40, zones=False), weights=EVERY)))
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
    return out
