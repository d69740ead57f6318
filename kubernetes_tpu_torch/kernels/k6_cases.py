"""The cases kernel K6 (commit_group_counts.cu) is held to, in one place.

tests/test_torch_megacycle.py holds K6's plain twin against the JAX
reference's models/megacycle.py _commit_group_counts on these cases on the
CPU; chip_smoke.py holds the kernel against its twin on the card on all of
them, bit for bit.  numpy only: one seed gives the same arrays on every
machine.

Each case is a dict: gc f32[N, G] (the carried spread counts), hosts i32[B]
(a window's winners, -1 unschedulable), group_ids i32[B, S] and
group_valid bool[B, S] (the pods' spread-group slots, PodBatch's fields).
They cover B in {1, 7, 2,048}, N in {12, 6,144}, G up to 64, one and two
slots a pod, every pod unschedulable, every pod on one node, a group
listed twice in a pod's valid slots (it counts twice), invalid slots that
hold a group id, group ids outside [0, G) (they count nowhere), winners
past the last row, and counts near 2^24 - 2 (the last integers an f32
count keeps exact).  The live cell's shape (N 6,144 with 5,000 real nodes,
G 32, B 2,048, one slot) comes last.
"""

from __future__ import annotations

import numpy as np

EXACT_MAX = float(1 << 24)


def _case(rng, n: int, g: int, b: int, s: int, n_real=None,
          sched_frac: float = 0.9, base_max: int = 50):
    n_real = n if n_real is None else n_real
    gc = np.zeros((n, g), np.float32)
    gc[:n_real] = rng.integers(0, base_max + 1, (n_real, g))
    hosts = rng.integers(0, n_real, b).astype(np.int32)
    hosts[rng.random(b) >= sched_frac] = -1
    gids = rng.integers(0, g, (b, s)).astype(np.int32)
    valid = rng.random((b, s)) < 0.8
    return dict(gc=gc, hosts=hosts, group_ids=gids, group_valid=valid)


def live_case():
    """The live cell's shape: 5,000 bench nodes padded to 6,144 rows, the
    20 deployments' selectors padded to 32 groups, a 2,048-pod window, one
    group slot a pod, every pod placed."""
    rng = np.random.default_rng(20261021)
    c = _case(rng, 6144, 32, 2048, 1, n_real=5000, sched_frac=1.0,
              base_max=110)
    c["gc"][:, 20:] = 0.0
    c["group_ids"][:, 0] = np.arange(2048) % 20
    c["group_valid"][:] = True
    return c


def cases():
    """[(name, case dict)] in a fixed order, the live cell's shape last."""
    rng = np.random.default_rng(20261020)
    out = []
    for n in (12, 6144):
        for b in (1, 7, 2048):
            for g, s in ((4, 1), (32, 2), (64, 1)):
                out.append((f"n{n}-b{b}-g{g}-s{s}", _case(rng, n, g, b, s)))
    c = _case(rng, 12, 4, 7, 2)
    c["hosts"][:] = -1
    out.append(("all-unschedulable", c))
    c = _case(rng, 6144, 32, 2048, 2)
    c["hosts"][:] = 4097
    out.append(("all-on-one-node", c))
    c = _case(rng, 12, 4, 7, 2)
    c["group_ids"][:, 1] = c["group_ids"][:, 0]
    c["group_valid"][:] = True
    out.append(("duplicate-slots", c))
    c = _case(rng, 12, 8, 64, 2)
    c["group_valid"][:, 1] = False
    c["group_ids"][:, 1] = rng.integers(0, 8, 64)
    out.append(("invalid-slots-hold-ids", c))
    c = _case(rng, 12, 4, 32, 2)
    c["group_ids"][::3, 0] = 4
    c["group_ids"][1::3, 1] = -1
    c["group_valid"][:] = True
    out.append(("ids-outside-groups", c))
    c = _case(rng, 12, 4, 16, 1)
    c["hosts"][::4] = 12
    out.append(("hosts-past-last-row", c))
    # counts near the f32 exactness edge: two adds onto 2^24 - 2
    c = _case(rng, 12, 4, 7, 2)
    c["gc"][:] = EXACT_MAX - 2.0
    c["hosts"][:] = [0, 1, 2, 3, 4, 5, 6]
    c["group_ids"][:] = [[0, 1], [1, 1], [2, 3], [3, 3], [0, 0], [1, 2],
                         [2, 2]]
    c["group_valid"][:] = True
    out.append(("near-exact-edge", c))
    out.append(("live", live_case()))
    return out
