"""The cases kernel K7 (fold_predicates.cu) is held to, in one place.

tests/test_torch_extender.py holds K7's plain twin against the JAX
reference's fold (`jnp.all(stack, 1) & alive` and first_failure) on the
cases with B * N <= 2^20 on the CPU; chip_smoke.py holds the kernel against
its twin on the card on all of them, bit for bit.  numpy only: one seed
gives the same arrays on every machine.

Each case is a dict: per_pred bool[B, K, N] (K = 23 predicate rows, the
reference's NUM_PREDICATES), valid bool[N] (node rows) and pod_valid
bool[B].  They cover B in {1, 7, 33, 2,048} x N in {1, 3, 4, 5, 6,144,
6,145, 70,000} (all but B 2,048 at N 70,000, a 3.3 GB stack), per-predicate
fail rates from 0 to 1, rows where every predicate passes and rows where
every predicate fails, invalid nodes (a padded tail and scattered rows),
invalid pods, and a disabled predicate (an all-true row).  The extender's
shape (B 1, N 6,144 with 5,000 valid rows) and the attribution shape (B
2,048 at the same N) come last.
"""

from __future__ import annotations

import numpy as np

K = 23                      # NUM_PREDICATES
BS = (1, 7, 33, 2048)
NS = (1, 3, 4, 5, 6144, 6145, 70000)
MAX_ELEMS = 1 << 24         # B * N above this is left out
RATES = (0.0, 0.0, 0.0, 0.0, 0.002, 0.01, 0.1, 0.5, 0.9, 1.0)


def make_case(seed: int, b: int, n: int, n_valid=None) -> dict:
    """One stack with a fail rate drawn per predicate; row 0 of every
    pod passes everything, the last pod row fails everything (B > 2),
    predicate 5 is disabled (all true), every 7th node from row 3 and the
    rows past n_valid are invalid, and every 5th pod from row 4 is
    invalid."""
    rng = np.random.default_rng(seed)
    rates = rng.choice(RATES, K)
    thr = np.round(rates * 256).astype(np.int16)[None, :, None]
    per_pred = rng.integers(0, 256, (b, K, n), dtype=np.uint8) >= thr
    per_pred[:, 5, :] = True
    per_pred[0] = True
    if b > 2:
        per_pred[-1] = False
    valid = np.ones(n, bool)
    valid[3::7] = False
    if n_valid is not None:
        valid[n_valid:] = False
    pod_valid = np.ones(b, bool)
    pod_valid[4::5] = False
    return dict(per_pred=per_pred, valid=valid, pod_valid=pod_valid)


def extender_case() -> dict:
    """The extender's shape: one pod against 5,000 bench nodes padded to
    6,144 rows, most predicates passing."""
    rng = np.random.default_rng(20261101)
    per_pred = np.ones((1, K, 6144), bool)
    per_pred[0, 6] = rng.random(6144) >= 0.02      # resources
    per_pred[0, 8] = np.arange(6144) % 50 != 0      # the tainted nodes
    per_pred[0, 5] = np.arange(6144) % 3 != 0       # a node selector
    valid = np.arange(6144) < 5000
    return dict(per_pred=per_pred, valid=valid,
                pod_valid=np.ones(1, bool))


def attribution_case() -> dict:
    """A batch-wide attribution at the live width: 2,048 pods against the
    same 6,144 rows."""
    return make_case(20261102, 2048, 6144, n_valid=5000)


def shapes():
    """[(name, B, N)] of every case, in cases() order."""
    out = [(f"b{b}-n{n}", b, n) for b in BS for n in NS
           if b * n <= MAX_ELEMS]
    return out + [("extender", 1, 6144), ("attribution", 2048, 6144)]


def cases(max_elems: int = MAX_ELEMS):
    """(name, case dict) of every case with B * N <= max_elems, built one
    at a time, the extender's and the attribution shape last."""
    for i, (name, b, n) in enumerate(shapes()):
        if b * n > max_elems:
            continue
        if name == "extender":
            yield name, extender_case()
        elif name == "attribution":
            yield name, attribution_case()
        else:
            yield name, make_case(20261100 + i, b, n)
