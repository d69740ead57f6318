"""The cases kernel K1 (select_hosts.cu) is held to, in one place.

tests/test_torch_select.py holds K1's plain twin against the JAX reference
on these rows on the CPU; chip_smoke.py and the `cuda`-marked test hold the
kernel against its twin on the card.  numpy only: one seed gives the same
rows on every machine.

Widths cover one and three nodes, rows around a warp's 1,024 nodes, the
main path's 5,120 and 6,144, an odd width whose rows start unaligned for
float4 loads (6,147), and rows past the one-read limit of 8,192 (20,000 and
70,000).  Each batch's first rows are the special cases of `CASES`; the
rest are tie-dense random rows.
"""

from __future__ import annotations

import numpy as np

BATCHES = (1, 7, 33, 2048)
WIDTHS = (1, 3, 300, 1023, 1024, 1025, 5120, 6144, 6147, 20000, 70000)
NEG = np.float32(-3.4e38)   # the masked-out filler
TOP = np.float32(9.0)       # above every random score
# node indices where a vector (4), a warp (32 or 128 nodes) or a tile
# (256, 1024 nodes) ends, in both the float4 and the scalar layouts
BOUNDARIES = (3, 4, 31, 32, 127, 128, 255, 256, 1023, 1024, 4095, 4096,
              8191, 8192)


def last_indices(B: int) -> tuple:
    """The rotation counters every shape runs with: small, large, negative,
    and counters that wrap int32 inside the batch."""
    out = (0, 1, 5, 37, 123457, 2**31 - 64, 2**31 - 1, -3, -5,
           2**31 - B, 2**31 - B // 2 - 1)
    return tuple(dict.fromkeys(out))


def _all_false(s, m):
    m[:] = False


def _one_feasible(s, m):
    m[:] = False
    m[len(m) // 3] = True


def _nan_in(s, m):
    s[min(7, len(s) - 1)] = np.nan
    m[min(7, len(s) - 1)] = True


def _nan_out(s, m):
    s[min(9, len(s) - 1)] = np.nan
    m[min(9, len(s) - 1)] = False


def _signed_zero(s, m):
    s[:] = 0.0
    s[::2] = -0.0


def _minus_inf(s, m):
    s[:] = -np.inf


def _filler(s, m):
    s[:] = NEG                     # masked-in values tie the filler


def _all_tied(s, m):
    m[:] = True
    s[:] = 1.0


def _boundary_ties(s, m):
    idx = [i for i in BOUNDARIES if i < len(s)] or [len(s) - 1]
    s[idx] = TOP
    m[idx] = True


def _last_only(s, m):
    s[-1] = TOP
    m[-1] = True


def _first_and_last(s, m):
    s[[0, -1]] = TOP
    m[[0, -1]] = True


def _last_lane(n):
    """The last lane of the row's last whole float4 vector."""
    return (n // 4) * 4 - 1 if n >= 4 else n - 1


def _nan_last_lane_in(s, m):
    s[_last_lane(len(s))] = np.nan
    m[_last_lane(len(s))] = True


def _nan_last_lane_out(s, m):
    s[_last_lane(len(s))] = np.nan
    m[_last_lane(len(s))] = False


def _continuous(s, m, rng):
    s[:] = rng.standard_normal(len(s)).astype(np.float32)


def _all_minus_inf_in(s, m):
    m[:] = True
    s[:] = -np.inf


def _filler_in_but_one(s, m):
    m[:] = True
    s[:] = NEG
    m[len(m) // 2] = False


CASES = (_all_false, _one_feasible, _nan_in, _nan_out, _signed_zero,
         _minus_inf, _filler, _all_tied, _boundary_ties, _last_only,
         _first_and_last, _nan_last_lane_in, _nan_last_lane_out, _continuous,
         _all_minus_inf_in, _filler_in_but_one)


def shifts(B: int) -> range:
    """The case shifts that give every case a row at batch size B."""
    return range(0, len(CASES), B) if B < len(CASES) else range(1)


def rows(B: int, N: int, shift: int = 0, seed: int = 20261017):
    """(scores f32[B, N], mask bool[B, N]): tie-dense random rows (integer
    scores 0..5, 70% feasible) whose row b < len(CASES) is special case
    (b + shift) % len(CASES)."""
    rng = np.random.default_rng([seed, B, N, shift])
    r = rng.integers(0, 60, (B, N), dtype=np.int8)
    scores = (r % 6).astype(np.float32)
    mask = r < 42                  # score and mask independent
    for b in range(min(B, len(CASES))):
        case = CASES[(b + shift) % len(CASES)]
        if case is _continuous:
            case(scores[b], mask[b], rng)
        else:
            case(scores[b], mask[b])
    return scores, mask


def shapes():
    """Every (B, N) the cases cover, smallest first."""
    return sorted(((B, N) for B in BATCHES for N in WIDTHS),
                  key=lambda bn: (bn[0] * bn[1], bn))
