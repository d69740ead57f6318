"""The cases kernel K3 (select_topk.cu) is held to, in one place.

tests/test_torch_quality.py holds K3's plain twin against the JAX
reference's select_topk_batch on these rows on the CPU; chip_smoke.py holds
the kernel against its twin on the card on all of them.  numpy only: one
seed gives the same rows on every machine.  The winner of each row comes
from the selector (K1 or its twin) run on the same rows with `last_index0`,
as the engines call them.

Widths cover one to three nodes (K > N clamps), rows around a warp and a
block, the main path's 6,144, an unaligned 6,147, rows on both sides of the
width K3 keeps in shared memory (40,960) and K1's widest, 70,000.  Each
batch's first rows are the special cases of `CASES`: K1's (NaN, signed
zeros, all masked out, the filler value masked in, ...) and K3's own
(ties around the rotated winner, fewer feasible nodes than K, ties
equal in value but not in sign).
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels import k1_cases

BATCHES = (1, 7, 33, 2048)
WIDTHS = (1, 2, 3, 300, 1023, 1025, 6144, 6147, 40960, 41000, 70000)
KS = (1, 2, 3, 8)
LAST_INDICES = (0, 5, 2**31 - 1)
SMEM_MAX_N = 40960   # K3 keeps rows up to this width in shared memory
TOP = k1_cases.TOP


def _two_feasible(s, m):
    m[:] = False
    m[[0, len(m) - 1]] = True


def _ties_at_top(s, m):
    """Five nodes tie at the top: the rotated winner sits among them and
    the runner-ups are the other four, lower node first."""
    idx = np.unique(np.linspace(0, len(s) - 1, 5).astype(np.int64))
    s[idx] = TOP
    m[idx] = True


def _ties_below_top(s, m):
    """One best node, then a tie for second place on both sides of it."""
    mid = len(s) // 2
    s[mid] = TOP + 1
    m[mid] = True
    idx = [i for i in (0, mid - 1, mid + 1, len(s) - 1)
           if i != mid and 0 <= i < len(s)]
    s[idx] = TOP
    m[idx] = True


def _signed_zero_top(s, m):
    """0.0 and -0.0 at the top: equal to the selector, ordered (-0.0
    below) by the runner-up ranking."""
    m[:] = True
    s[:] = -1.0
    s[::3] = -0.0
    s[1::3] = 0.0


CASES = k1_cases.CASES + (_two_feasible, _ties_at_top, _ties_below_top,
                          _signed_zero_top)


def shifts(B: int) -> range:
    """The case shifts that give every case a row at batch size B."""
    return range(0, len(CASES), B) if B < len(CASES) else range(1)


def rows(B: int, N: int, shift: int = 0, seed: int = 20261018):
    """(scores f32[B, N], mask bool[B, N]): tie-dense random rows (integer
    scores 0..5, 70% feasible) whose row b < len(CASES) is special case
    (b + shift) % len(CASES)."""
    rng = np.random.default_rng([seed, B, N, shift])
    r = rng.integers(0, 60, (B, N), dtype=np.int8)
    scores = (r % 6).astype(np.float32)
    mask = r < 42
    for b in range(min(B, len(CASES))):
        case = CASES[(b + shift) % len(CASES)]
        if case is k1_cases._continuous:
            case(scores[b], mask[b], rng)
        else:
            case(scores[b], mask[b])
    return scores, mask


def shapes():
    """Every (B, N) the cases cover, smallest first."""
    return sorted(((B, N) for B in BATCHES for N in WIDTHS),
                  key=lambda bn: (bn[0] * bn[1], bn))
