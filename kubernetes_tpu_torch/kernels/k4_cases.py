"""The cases kernel K4 (binpack_ffd.cu) is held to, in one place.

tests/test_torch_quality.py holds K4's plain twin against the JAX
reference's binpack_ffd on these cases on the CPU; chip_smoke.py holds the
kernel against its twin on the card on all of them.  numpy only: one seed
gives the same arrays on every machine.

Each case is a dict: reqs f32[P, R], cap f32[N, R] (per-bin) or f32[R]
(every bin), order i32[P] or None, max_bins (the 1-D form's bin count, or
None).  They cover full bins (zero capacity rows), zero request rows (the
padding of a batch), pods that fit nowhere, duplicate requests, values that
are not integers (the f32 add and compare must round as the reference's),
12 columns (K4's 512-thread variant), 32, 64 and 128 columns (its wide
variant: the encoder's R with 13 or more extended resource names), a bin
matrix too big for K4's shared memory, and the regret's full width
(N 6,144, P 2,048, R 8, the live cell's free capacity).  `full_width(r)`
widens the last to r columns for the card's timings.
"""

from __future__ import annotations

import numpy as np

GI = float(1 << 30)
MI = float(1 << 20)


def _fleet_free(rng, n_real: int, n: int, r: int, used_frac: float):
    """The live cell's free capacity: bench nodes (32 CPU, 256Gi, 110
    pods) with some pods placed, padded rows of zero."""
    cap = np.zeros((n, r), np.float32)
    cap[:n_real, 0] = 32000.0
    cap[:n_real, 1] = 256 * GI
    cap[:n_real, 3] = 110.0
    k = rng.integers(0, int(110 * used_frac) + 1, n_real).astype(np.float32)
    cap[:n_real, 0] -= 100.0 * k
    cap[:n_real, 1] -= 256 * MI * k
    cap[:n_real, 3] -= k
    return cap


def _pods(P: int, r: int, n_real: int):
    reqs = np.zeros((P, r), np.float32)
    reqs[:n_real, 0] = 100.0
    reqs[:n_real, 1] = 256 * MI
    reqs[:n_real, 3] = 1.0
    return reqs


def _ffd_order(reqs, cap):
    """The regret's order (dominant share of the largest free shape,
    descending, stable), in numpy: good enough for a case's order."""
    ref = np.maximum(cap.max(axis=0) if cap.ndim == 2 else cap, 1e-30)
    key = (reqs / ref[None, :]).max(axis=-1)
    return np.argsort(-key, kind="stable").astype(np.int32)


def cases():
    """[(name, case dict)] in a fixed order, the full width last."""
    rng = np.random.default_rng(20261019)
    out = []
    # full bins: every other bin has no room at all
    cap = rng.integers(2, 9, (64, 3)).astype(np.float32)
    cap[::2] = 0.0
    reqs = rng.integers(0, 4, (200, 3)).astype(np.float32)
    out.append(("full-bins", dict(reqs=reqs, cap=cap, order=None,
                                  max_bins=None)))
    # zero rows (padding) between real pods, in an FFD order
    reqs = rng.integers(1, 5, (96, 2)).astype(np.float32)
    reqs[rng.random(96) < 0.4] = 0.0
    cap = np.full((40, 2), 8.0, np.float32)
    out.append(("zero-rows", dict(reqs=reqs, cap=cap,
                                  order=_ffd_order(reqs, cap),
                                  max_bins=None)))
    # overflow: more demand than all bins hold; some pods fit nowhere
    reqs = rng.integers(3, 7, (300, 2)).astype(np.float32)
    cap = np.full((20, 2), 10.0, np.float32)
    out.append(("overflow", dict(reqs=reqs, cap=cap, order=None,
                                 max_bins=None)))
    # a pod larger than any bin, first in line
    reqs = np.concatenate([np.full((1, 2), 50.0, np.float32),
                           np.ones((30, 2), np.float32)])
    out.append(("too-large", dict(reqs=reqs, cap=np.full((4, 2), 9.0,
                                                         np.float32),
                                  order=None, max_bins=None)))
    # duplicate requests: one shape many times, in a permuted order
    reqs = np.tile(np.array([[2.0, 3.0, 0.0, 1.0]], np.float32), (500, 1))
    cap = np.tile(np.array([[7.0, 10.0, 0.0, 4.0]], np.float32), (90, 1))
    out.append(("duplicates", dict(reqs=reqs, cap=cap,
                                   order=rng.permutation(500).astype(
                                       np.int32),
                                   max_bins=None)))
    # values that are not integers: the adds and compares round in f32
    reqs = (rng.random((400, 3)) * 0.37).astype(np.float32)
    cap = (1.0 + rng.random((128, 3))).astype(np.float32)
    out.append(("non-integer", dict(reqs=reqs, cap=cap,
                                    order=_ffd_order(reqs, cap),
                                    max_bins=None)))
    # one capacity for every bin (the autoscaler's what-if form)
    reqs = rng.integers(0, 5, (256, 3)).astype(np.float32)
    out.append(("one-capacity", dict(reqs=reqs,
                                     cap=np.array([8.0, 8.0, 8.0],
                                                  np.float32),
                                     order=None, max_bins=300)))
    # 12 columns (K4's wider variant), bins past its first 512
    reqs = rng.integers(0, 4, (600, 12)).astype(np.float32)
    reqs[:, 7:] = 0.0
    cap = rng.integers(0, 12, (1500, 12)).astype(np.float32)
    cap[:, 7:] = 0.0
    out.append(("wide-columns", dict(reqs=reqs, cap=cap,
                                     order=_ffd_order(reqs, cap),
                                     max_bins=None)))
    # past 16 columns: sparse extended resources that some bins hold;
    # 64 columns over 1,500 bins are past K4's shared memory
    for r, n, p in ((32, 200, 300), (64, 1500, 256), (128, 100, 200)):
        reqs = _pods(p, r, p)
        ext = rng.random((p, r - 4)) < 0.05
        reqs[:, 4:] = np.where(ext, rng.integers(1, 4, (p, r - 4)), 0)
        cap = _fleet_free(rng, n, n, r, 0.5)
        cap[:, 4:] = np.where(rng.random((n, r - 4)) < 0.3,
                              rng.integers(0, 6, (n, r - 4)), 0)
        out.append((f"cols-{r}", dict(reqs=reqs, cap=cap,
                                      order=_ffd_order(reqs, cap),
                                      max_bins=None)))
    # 8,192 bins of 8 columns: past K4's shared memory, a workspace
    cap = _fleet_free(rng, 8000, 8192, 8, 0.98)
    reqs = _pods(700, 8, 640)
    reqs[:640, 0] = rng.integers(1, 40, 640).astype(np.float32) * 100.0
    out.append(("workspace", dict(reqs=reqs, cap=cap,
                                  order=_ffd_order(reqs, cap),
                                  max_bins=None)))
    # the regret at the live cell's full width: a batch of 2,048 (1,952
    # placed, 96 masked to zero) into 5,000 nodes' free capacity, padded
    # to 6,144 rows
    cap = _fleet_free(rng, 5000, 6144, 8, 0.4)
    reqs = _pods(2048, 8, 2048)
    reqs[rng.permutation(2048)[:96]] = 0.0
    out.append(("full-width", dict(reqs=reqs, cap=cap,
                                   order=_ffd_order(reqs, cap),
                                   max_bins=None)))
    return out


def full_width(r: int) -> dict:
    """The full-width case with r >= 8 columns: its first eight, and past
    them extended resources that one node in ten holds and one pod in
    twenty requests."""
    c = dict(cases())["full-width"]
    rng = np.random.default_rng(20261022)
    P, N = c["reqs"].shape[0], c["cap"].shape[0]
    reqs = np.zeros((P, r), np.float32)
    cap = np.zeros((N, r), np.float32)
    reqs[:, :8], cap[:, :8] = c["reqs"], c["cap"]
    reqs[:, 8:] = np.where(rng.random((P, r - 8)) < 0.05 / (r - 8) * 4,
                           1.0, 0.0) * (c["reqs"][:, :1] > 0)
    cap[:5000, 8:] = np.where(rng.random((5000, r - 8)) < 0.1, 4.0, 0.0)
    return dict(reqs=reqs, cap=cap, order=_ffd_order(reqs, cap),
                max_bins=None)
