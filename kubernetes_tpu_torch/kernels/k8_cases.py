"""The cases kernel K8 (binpack_counts.cu) is held to, in one place.

tests/test_torch_counts.py holds K8's plain twin (models/binpack.py
binpack_counts_plain) against the JAX package's models/binpack.py
binpack_ffd_counts, vmapped over the lanes and jitted, on these cases on
the CPU; chip_smoke.py holds the kernel against its twin on the card on
all of them, bit for bit.  numpy only: one seed gives the same arrays on
every machine.

Each case is a dict: reqs f32[C, R] and counts i32[C] (the classes),
caps (f32[S, R] uniform, or f32[n_bins, R] per-bin), per_bin, n_bins and
order i32[S, C] (each lane's class order, a permutation unless the case
says otherwise).  They cover full bins and zero rows (full nodes) in
per-bin mode, zero-request and zero-count classes, every class
overflowing the bins, counts near the int32 clip (the prefix sum wraps as
the reference's int32 cumsum does), fractional requests and capacities
(the int32 admission truncates them), negative order entries (they wrap
once), max_bins 1 and 2,048, R 4, 8, 32 and 64 (loads in shared memory or
the workspace), lanes past the kernel's grid (1,500 lanes; 265 with the
loads in the workspace), and per-bin mode at N 6,144 (shared memory),
16,385 and 40,000 rows (the workspace).
"""

from __future__ import annotations

import numpy as np

I32_MAX = 2 ** 31 - 1


def _classes(rng, c: int, r: int, hi: int = 6, count_hi: int = 12):
    reqs = np.zeros((c, r), np.float32)
    reqs[:, : min(r, 4)] = rng.integers(0, hi, (c, min(r, 4)))
    reqs[rng.random((c, r)) < 0.1] = 0.0
    counts = rng.integers(0, count_hi, c).astype(np.int32)
    return reqs, counts


def _orders(rng, s: int, c: int):
    return np.stack([rng.permutation(c) for _ in range(s)]).astype(np.int32)


def uniform(rng, c: int, r: int, s: int, n_bins: int, hi: int = 6,
            cap_hi: int = 24, count_hi: int = 12):
    reqs, counts = _classes(rng, c, r, hi, count_hi)
    caps = rng.integers(1, cap_hi, (s, r)).astype(np.float32)
    return dict(reqs=reqs, counts=counts, caps=caps, per_bin=False,
                n_bins=n_bins, order=_orders(rng, s, c))


def per_bin(rng, c: int, r: int, n: int, hi: int = 6, cap_hi: int = 24,
            count_hi: int = 12, full_frac: float = 0.2):
    reqs, counts = _classes(rng, c, r, hi, count_hi)
    caps = rng.integers(0, cap_hi, (n, r)).astype(np.float32)
    caps[rng.random(n) < full_frac] = 0.0
    return dict(reqs=reqs, counts=counts, caps=caps, per_bin=True,
                n_bins=n, order=_orders(rng, 1, c))


def cases():
    """[(name, case dict)] in a fixed order."""
    rng = np.random.default_rng(20261104)
    out = []
    for r in (4, 8, 32, 64):
        for nb in (1, 37, 2048):
            out.append((f"uniform-r{r}-bins{nb}", uniform(rng, 24, r, 3, nb)))
    out.append(("per-bin-small", per_bin(rng, 40, 8, 50)))
    c = per_bin(rng, 40, 8, 64, full_frac=0.6)
    c["caps"][-8:] = 0.0
    out.append(("per-bin-full-rows", c))
    c = uniform(rng, 32, 8, 4, 64)
    c["reqs"][::4] = 0.0
    c["counts"][1::4] = 0
    out.append(("zero-classes", c))
    out.append(("all-overflow", uniform(rng, 16, 4, 3, 4, hi=6, cap_hi=8,
                                        count_hi=200)))
    # counts near the int32 clip: one-unit requests into bins of 2^24 - 1,
    # so the bins' admissions sum past 2^31 and the prefix wraps
    c = uniform(rng, 6, 4, 2, 300)
    c["reqs"][:] = 0.0
    c["reqs"][:, 0] = 1.0
    c["caps"][:] = float(2 ** 24 - 1)
    c["counts"][:] = [I32_MAX, I32_MAX - 5, 2 ** 30, 7, 0, I32_MAX]
    out.append(("int32-clip", c))
    c = uniform(rng, 20, 4, 3, 40)
    c["reqs"] = (c["reqs"] * 0.7).astype(np.float32)
    c["caps"] = (c["caps"] + 0.5).astype(np.float32)
    out.append(("fractional", c))
    c = uniform(rng, 12, 4, 2, 20)
    c["order"][:, ::3] -= 12
    out.append(("order-negative", c))
    out.append(("lanes-1500", uniform(rng, 16, 4, 1500, 8)))
    out.append(("lanes-265-workspace", uniform(rng, 4, 64, 265, 832)))
    out.append(("per-bin-6144", per_bin(rng, 64, 8, 6144, hi=4000,
                                        cap_hi=32000, count_hi=400)))
    out.append(("per-bin-16385", per_bin(rng, 64, 8, 16385, hi=4000,
                                         cap_hi=32000, count_hi=400)))
    out.append(("per-bin-40000", per_bin(rng, 32, 8, 40000, hi=4000,
                                         cap_hi=32000, count_hi=2000)))
    return out
