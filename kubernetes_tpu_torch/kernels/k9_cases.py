"""The cases kernel K9 (ffd_order.cu) is held to, in one place.

tests/test_torch_counts.py holds K9's plain twin (models/binpack.py
ffd_order_plain) against the JAX package's models/binpack.py ffd_order,
vmapped over the lanes and jitted, on these cases on the CPU; chip_smoke.py
holds the kernel against its twin on the card on all of them, bit for bit.
numpy only: one seed gives the same arrays on every machine.

Each case is a dict: reqs f32[C, R] (the items) and caps f32[S, R] (one
capacity a lane).  They cover ties in the dominant fraction between
different vectors, duplicate vectors (they keep their input order), zero
request rows, zero-capacity columns (the 1e-30 clamp makes them huge
fractions), -0.0 beside 0.0 in requests and capacities (the reference
canonicalises both to one key), C 1, a C that is no power of two, R from 1
to 64, the planner's backlog cap C 65,536 (one lane) and the per-pod
sweep's P 50,000 pods of 256 classes over 4 shapes (the last case).
"""

from __future__ import annotations

import numpy as np


def sweep_pods(n_pods: int = 50000, n_classes: int = 256,
               seed: int = 20261101):
    """A duplicate-heavy backlog in integer units (milliCPU, MiB, one pod
    slot): n_pods rows drawn from n_classes distinct vectors, R 8."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n_classes, 8), np.float32)
    base[:, 0] = rng.integers(50, 4000, n_classes)
    base[:, 1] = rng.integers(64, 8192, n_classes)
    base[:, 3] = 1.0
    return base[rng.integers(0, n_classes, n_pods)]


def sweep_shapes(n_shapes: int, seed: int = 20261102):
    """Candidate shapes in the same units: 4-128 cores, 16-512 GiB, 110
    pod slots."""
    rng = np.random.default_rng(seed)
    caps = np.zeros((n_shapes, 8), np.float32)
    caps[:, 0] = rng.integers(4000, 128001, n_shapes)
    caps[:, 1] = rng.integers(16 * 1024, 512 * 1024 + 1, n_shapes)
    caps[:, 3] = 110.0
    return caps


def _rand(rng, c: int, r: int, s: int, distinct: int = 0, hi: int = 9):
    if distinct:
        base = rng.integers(0, hi, (distinct, r)).astype(np.float32)
        reqs = base[rng.integers(0, distinct, c)]
    else:
        reqs = rng.integers(0, hi, (c, r)).astype(np.float32)
    caps = rng.integers(1, 3 * hi, (s, r)).astype(np.float32)
    return dict(reqs=reqs, caps=caps)


def cases():
    """[(name, case dict)] in a fixed order, the per-pod sweep last."""
    rng = np.random.default_rng(20261103)
    out = []
    for c, r, s in ((1, 1, 1), (1, 8, 3), (7, 3, 2), (255, 8, 5),
                    (777, 5, 3), (256, 1, 4), (64, 17, 3), (64, 64, 2)):
        out.append((f"c{c}-r{r}-s{s}", _rand(rng, c, r, s)))
    # every vector appears many times: duplicates keep their input order
    out.append(("duplicates", _rand(rng, 500, 4, 3, distinct=6)))
    # equal dominant fractions, different shapes: the columns decide
    c = dict(reqs=np.array([[2, 4], [4, 2], [4, 4], [4, 1], [1, 4], [4, 4],
                            [0, 4], [4, 0]], np.float32),
             caps=np.array([[8, 8], [4, 8], [8, 4]], np.float32))
    out.append(("dominant-ties", c))
    c = _rand(rng, 300, 6, 4)
    c["reqs"][::5] = 0.0
    out.append(("zero-rows", c))
    c = _rand(rng, 300, 6, 4)
    c["caps"][:, 1] = 0.0
    c["caps"][2, :] = 0.0
    out.append(("zero-capacity-columns", c))
    c = _rand(rng, 200, 4, 3, hi=3)
    neg = rng.random(c["reqs"].shape) < 0.3
    c["reqs"] = np.where(neg & (c["reqs"] == 0), np.float32(-0.0),
                         c["reqs"]).astype(np.float32)
    c["caps"][1, 2] = -0.0
    c["caps"][2, 0] = 0.0
    out.append(("signed-zeros", c))
    # fractions that round: a third, a tenth, under a large capacity
    c = dict(reqs=rng.integers(1, 1000, (400, 3)).astype(np.float32) / 3.0,
             caps=np.array([[3.0, 10.0, 7.0], [1e7, 3e-3, 0.1]],
                           np.float32))
    out.append(("rounded-fractions", c))
    c = _rand(rng, 65536, 8, 1, distinct=4096, hi=4000)
    out.append(("c65536", c))
    out.append(("p50000", dict(reqs=sweep_pods(),
                               caps=sweep_shapes(4))))
    return out
