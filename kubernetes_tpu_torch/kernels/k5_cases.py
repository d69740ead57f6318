"""The cases kernel K5 (cluster_analytics.cu) is held to, in one place.

tests/test_torch_telemetry.py holds K5's plain twin against the jitted JAX
reference's cluster_analytics on the cases up to CPU_MAX_N rows on the CPU;
chip_smoke.py holds the kernel against its twin on the card on all of
them.  numpy only: one seed gives the same arrays on every machine.

Each case is (allocatable f32[N, R], requested f32[N, R], valid bool[N]).
They cover the hazards of an order-pinned fold and a sort on the card: no
rows, one row (valid, invalid, a -0.0 request), rows not a power of two,
every row invalid, a resource column with no capacity anywhere, nodes
over-committed (free clamped at 0, occupancy past 100%), recycled rows
(invalid but holding old values), -0.0 beside 0.0 in `requested` (the
sort's tie and the maxima's order), quantile ties (a homogeneous fleet),
occupancy exactly on decile edges, magnitudes from 1e-3 to 1e9 in one
column (the add order shows), R = 4 and R = 5 (row strides), the live
cell's full width (5,000 bench nodes padded to 6,144, R 8), K5's widest
one-launch shape (16,384 rows), and past it the multi-block sequence's
(16,385 and 40,000 rows, signed zeros and recycled rows among them).
"""

from __future__ import annotations

import numpy as np

GI = float(1 << 30)
MI = float(1 << 20)
CPU_MAX_N = 8192     # the CPU tests take the cases up to this many rows
MAX_N = 16384        # K5 takes up to this many rows in one launch
WIDE_N = (16385, 40000)  # past it: the multi-block sequence


def _random(rng, n: int, r: int = 8, valid_frac: float = 0.8,
            over: float = 1.5):
    alloc = (rng.uniform(0, 1e4, (n, r))
             * rng.integers(0, 2, (n, r))).astype(np.float32)
    req = (alloc * rng.uniform(0, over, (n, r))).astype(np.float32)
    valid = rng.random(n) < valid_frac
    return alloc, req, valid


def _fleet(rng, n_real: int, n: int, r: int = 8):
    """The bench fleet (32 CPU, 256Gi, 110 pods a node) with 100m/256Mi
    pods placed, padded rows of zero and invalid."""
    alloc = np.zeros((n, r), np.float32)
    req = np.zeros((n, r), np.float32)
    alloc[:n_real, 0] = 32000.0
    alloc[:n_real, 1] = 256 * GI
    alloc[:n_real, 2] = 100 * GI
    alloc[:n_real, 3] = 110.0
    k = rng.integers(0, 111, n_real).astype(np.float32)
    req[:n_real, 0] = 100.0 * k
    req[:n_real, 1] = 256 * MI * k
    req[:n_real, 3] = k
    valid = np.zeros(n, bool)
    valid[:n_real] = True
    return alloc, req, valid


def _known():
    """The JAX suite's hand-checked 4-node cluster (one row invalid)."""
    R = 8
    alloc = np.zeros((4, R), np.float32)
    req = np.zeros((4, R), np.float32)
    valid = np.array([True, True, True, False])
    alloc[0, :4] = (4000, 8.0, 10.0, 10)
    req[0, :4] = (2000, 8.0, 0.0, 5)
    alloc[1, :4] = (4000, 8.0, 10.0, 10)
    req[1, :4] = (4000, 4.0, 0.0, 9)
    alloc[2, :4] = (2000, 4.0, 10.0, 10)
    alloc[3, :4] = (1000, 1.0, 1.0, 1)
    req[3, :4] = (1000, 1.0, 1.0, 1)
    return alloc, req, valid


def _wide(rng, n: int):
    """A fleet of n rows past the one-launch width: recycled rows, -0.0
    requests beside 0.0, over-committed nodes."""
    al, rq, va = _fleet(rng, n - 300, n)
    zero = rng.random(n) < 0.3
    rq[zero, :4] = 0.0
    rq[zero & (rng.random(n) < 0.5), :4] = -0.0
    over = rng.random(n) < 0.02
    rq[over, 0] = al[over, 0] * np.float32(1.25)
    va[rng.choice(n - 300, 500, replace=False)] = False
    al[n - 200:] = al[0]
    rq[n - 200:] = rq[0]
    return al, rq, va


def cases(max_n=None):
    """[(name, (allocatable, requested, valid))] in a fixed order, the
    live cell's full width last among those up to CPU_MAX_N rows (the
    widest one-launch case and the multi-block ones after it), those up to
    max_n rows (None: all)."""
    rng = np.random.default_rng(20261017)
    out = []
    out.append(("empty", (np.zeros((0, 8), np.float32),
                          np.zeros((0, 8), np.float32), np.zeros(0, bool))))
    a = np.zeros((1, 8), np.float32)
    a[0, :4] = (4000, 8 * GI, 0, 110)
    r = np.zeros((1, 8), np.float32)
    r[0, :4] = (1500, 3 * GI, 0, 7)
    out.append(("one-row", (a, r, np.ones(1, bool))))
    out.append(("one-row-invalid", (a, r, np.zeros(1, bool))))
    rz = r.copy()
    rz[0, :4] = (-0.0, -0.0, -0.0, -0.0)
    out.append(("one-row-negative-zero", (a, rz, np.ones(1, bool))))
    out.append(("known", _known()))
    for n in (2, 3, 7, 8, 33, 64, 257, 1000, 1024, 1025, 4096):
        out.append((f"random-{n}", _random(rng, n)))
    al, rq, _ = _random(rng, 300)
    out.append(("all-invalid", (al, rq, np.zeros(300, bool))))
    al, rq, va = _random(rng, 500)
    al[:, 2] = 0.0
    rq[:, 2] = rng.uniform(0, 10, 500).astype(np.float32)
    out.append(("no-capacity-column", (al, rq, va)))
    al, rq, va = _random(rng, 700, over=1.0)
    rq = (al * rng.uniform(1.0, 3.0, al.shape)).astype(np.float32)
    rq[:, 1] = al[:, 1] * np.float32(2.0)
    out.append(("over-committed", (al, rq, va)))
    # recycled rows: invalid rows still holding a removed node's values
    al, rq, _ = _fleet(rng, 900, 1024)
    va = np.ones(1024, bool)
    va[rng.choice(900, 120, replace=False)] = False
    va[900:] = False
    al[950:] = al[0]
    rq[950:] = rq[0]
    out.append(("recycled-rows", (al, rq, va)))
    # -0.0 beside 0.0: requests of zero with either sign, valid rows only
    for n in (16, 100, 512):
        al, rq, va = _fleet(rng, n, n)
        zero_rows = rng.random(n) < 0.6
        rq[zero_rows, :4] = 0.0
        neg = zero_rows & (rng.random(n) < 0.5)
        rq[neg, :4] = -0.0
        out.append((f"signed-zero-{n}", (al, rq, va)))
    al, rq, va = _fleet(rng, 64, 64)
    rq[:, :4] = -0.0
    out.append(("all-negative-zero", (al, rq, va)))
    # a homogeneous fleet: every quantile a tie
    al, rq, va = _fleet(rng, 2000, 2048)
    rq[:2000] = rq[0]
    out.append(("homogeneous", (al, rq, va)))
    # occupancy on the decile edges and past 100%
    n = 256
    al = np.zeros((n, 8), np.float32)
    al[:, :4] = (1000.0, 1000.0, 1000.0, 110.0)
    rq = np.zeros((n, 8), np.float32)
    rq[:, 3] = np.arange(n, dtype=np.float32) % 140
    rq[:, 0] = (np.arange(n) % 11).astype(np.float32) * 100.0
    out.append(("decile-edges", (al, rq, np.ones(n, bool))))
    # magnitudes across twelve decades in one column
    n = 3000
    al = np.exp(rng.uniform(np.log(1e-3), np.log(1e9), (n, 8))).astype(
        np.float32)
    rq = (al * rng.uniform(0, 1.2, (n, 8))).astype(np.float32)
    out.append(("magnitudes", (al, rq, rng.random(n) < 0.9)))
    al, rq, va = _random(rng, 333, r=4)
    out.append(("four-columns", (al, rq, va)))
    al, rq, va = _random(rng, 333, r=5)
    out.append(("five-columns", (al, rq, va)))
    out.append(("full-width", _fleet(rng, 5000, 6144)))
    out.append(("widest", _fleet(rng, 15000, MAX_N)))
    for n in WIDE_N:
        out.append((f"wide-{n}", _wide(rng, n)))
    return [(name, c) for name, c in out
            if max_n is None or c[0].shape[0] <= max_n]


def full_width_case():
    """The live cell's shape: 5,000 bench nodes padded to 6,144 rows."""
    return dict(cases(CPU_MAX_N))["full-width"]
