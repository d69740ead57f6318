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

The cases of `layout_cases` (part of `cases()`) pin the edges of the
kernel's layout (kernels.binpack_counts_paths: a warp or a block a lane,
the held columns, chunk summaries of 32 bins, the class table staged or
not, shared memory or the workspace); each names the edges it pins in
"pins", and PINS holds the path's condition for each, which the CPU
tests, the `cuda` test and chip_smoke.py check: bins 31, 32, 33 (a warp
a lane) and 1,023, 1,024, 1,025 (a block a lane, one or two words of
chunk flags), a class that fits only the last chunk, a lane no chunk
admits from its first step, a column only the last class in the order
requests, unrequested columns of zero and non-zero capacity, negative
remainders from fractional per-bin capacities, per-bin zero rows at a
chunk edge, the int32 edges of the multiplier division (dividends
-2^31 and 2^31 - 128, divisors 1 to 2^31 - 128, 2^24 - 1 and 2^24), a
class table too large to stage, the workspace a warp a lane and a
block a lane with every one of 8 columns held, a block a lane's
workspace at one, two and three held columns (three as the live
capacity cell's stage 1 holds them, over 16,385 node rows), and 2^19
node rows (the summaries in the workspace too).
"""

from __future__ import annotations

import numpy as np

I32_MAX = 2 ** 31 - 1
F32_BELOW_2_31 = 2147483520.0   # the largest float32 below 2^31

# the layout edge a case pins: the path's condition for it, on
# (path, case) (path: kernels.BinpackCountsPath)
PINS = {
    "warp-a-lane": lambda p, c: not p.block and p.lanes >= 2,
    "block-a-lane": lambda p, c: p.block,
    "shared-memory": lambda p, c: p.tier == 0,
    "workspace": lambda p, c: p.tier >= 1,
    "summaries-in-workspace": lambda p, c: p.tier == 2,
    "staged": lambda p, c: p.staged,
    "unstaged": lambda p, c: not p.staged,
    "held-below-r": lambda p, c: p.held < c["reqs"].shape[1],
    "held-1": lambda p, c: p.held == 1,
    "held-2": lambda p, c: p.held == 2,
    "held-3": lambda p, c: p.held == 3,
    "chunk-edge": lambda p, c: c["n_bins"] % 32 in (31, 0, 1),
    "two-words": lambda p, c: c["n_bins"] > 32 * 32,
}


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
    return out + layout_cases()


def _pinned(case, *pins):
    case["pins"] = pins
    return case


def _last_chunk_only(rng):
    """Per-bin, 1,000 bins: every bin fits the small classes, only the
    last chunk's bins (992-999) fit class 0, which goes last."""
    c = per_bin(rng, 12, 4, 1000, hi=3, cap_hi=6, count_hi=6,
                full_frac=0.1)
    c["reqs"][0] = [40, 3, 0, 1]
    c["counts"][0] = 7
    c["caps"][992:] = [90, 9, 5, 4]
    c["order"][0] = np.roll(np.arange(12), -1)
    return c


def _none_admits(rng):
    """Uniform, 140 lanes (a warp a lane): every class asks more of some
    column than any bin holds, so no chunk admits from the first step."""
    c = uniform(rng, 10, 4, 140, 96)
    c["reqs"][:, 1] = 30.0
    c["caps"][:, 1] = rng.integers(1, 30, 140)
    return c


def _last_class_column(rng):
    """R 8: column 5 requested only by the class the order takes last;
    columns 6 and 7 by none, 6 with zero capacity, 7 with a non-zero
    one."""
    c = uniform(rng, 16, 8, 140, 64)
    c["reqs"][:, 4:] = 0.0
    last = int(c["order"][0, -1])
    c["order"][:] = c["order"][0]
    c["reqs"][last, 5] = 2.0
    c["caps"][:, 5] = 9.0
    c["caps"][:, 6] = 0.0
    c["caps"][:, 7] = 100.0
    return c


def _negative_remainders(rng):
    """Per-bin, 640 bins of fractional capacities, some below zero (int
    truncates toward zero: -1.7 holds -1), zero rows at the chunk edges
    31, 32, 63, 64, 319 and 320, and a class with a negative request in
    one column (its load falls below zero)."""
    c = per_bin(rng, 20, 4, 640, hi=5, cap_hi=20, full_frac=0.05)
    c["caps"] = (rng.uniform(-3.0, 20.0, (640, 4))).astype(np.float32)
    c["caps"][[31, 32, 63, 64, 319, 320]] = 0.0
    c["reqs"][3] = [2.0, -1.5, 1.0, 0.0]
    c["counts"][3] = 40
    return c


def _division_edges(rng):
    """The int32 edges of the multiplier division: capacities 2^31 - 128,
    -2^31, 2^24 - 1 and 2^24 in column 0 (rem from -2^31 to 2^31 - 128),
    requests 1, 2, 3, 7, 2^24 - 1, 2^24, 2^24 + 1, 2^30 + 1 and 2^31 - 128
    there, one unit of column 1 each."""
    n = 160
    c = per_bin(rng, 9, 2, n, full_frac=0.0)
    c["caps"][:, 1] = 1000.0
    c["caps"][:, 0] = np.resize(np.array(
        [F32_BELOW_2_31, -2.0 ** 31, 2.0 ** 24 - 1, 2.0 ** 24, 7.0, 1.0,
         2.0 ** 30 + 1, 2.0 ** 24 + 2], np.float32), n)
    c["reqs"][:] = 0.0
    c["reqs"][:, 0] = [1.0, 2.0, 3.0, 7.0, 2.0 ** 24 - 1, 2.0 ** 24,
                       2.0 ** 24 + 2, 2.0 ** 30 + 1, F32_BELOW_2_31]
    c["reqs"][:, 1] = 1.0
    c["counts"][:] = [5, 9, 40, 3, 2, 2, 3, 2, 2]
    c["order"][0] = np.arange(9)[::-1]
    return c


def _many_classes(rng):
    """2,100 classes of one held column (the class table takes 33,600
    bytes, past the 32 KB it is staged in), 140 lanes of 48 bins."""
    c = uniform(rng, 2100, 2, 140, 48, hi=4, cap_hi=16, count_hi=3)
    c["reqs"][:, 1] = 0.0
    return c


def _capacity_rows(rng, n: int):
    """Per-bin over n node rows as the planner's stage 1 sees the live
    capacity cell: 64 classes of milliCPU 50-4000, memory 64-8192 Mi and
    one pod slot (columns 0, 1 and 3 of 8: three held), the nodes'
    headroom after their running pods (0-3,500 milliCPU, 0-32 Gi, 0-109
    slots), a tenth of the rows full."""
    c = per_bin(rng, 64, 8, n, count_hi=400, full_frac=0.1)
    c["reqs"][:] = 0.0
    c["reqs"][:, 0] = rng.integers(50, 4000, 64)
    c["reqs"][:, 1] = rng.integers(64, 8192, 64)
    c["reqs"][:, 3] = 1.0
    full = c["caps"][:, 0] == 0.0
    c["caps"][:] = 0.0
    c["caps"][:, 0] = rng.integers(0, 3501, n)
    c["caps"][:, 1] = rng.integers(0, 32 * 1024 + 1, n)
    c["caps"][:, 3] = rng.integers(0, 110, n)
    c["caps"][full] = 0.0
    return c


def layout_cases():
    """[(name, case)] of the cases that pin K8's layout edges, in a fixed
    order (each case's "pins" names them, PINS checks them)."""
    rng = np.random.default_rng(20261218)
    out = []
    for nb in (31, 32, 33):
        out.append((f"warp-bins{nb}", _pinned(
            uniform(rng, 24, 3, 140, nb, count_hi=20), "warp-a-lane",
            "chunk-edge", "staged")))
    for nb in (1023, 1024, 1025):
        c = per_bin(rng, 24, 4, nb, hi=5, cap_hi=30, count_hi=60)
        c["caps"][[31, 32, 991, 992, 1022]] = 0.0
        out.append((f"block-bins{nb}", _pinned(
            c, "block-a-lane", "chunk-edge", "shared-memory",
            *(("two-words",) if nb > 1024 else ()))))
    out.append(("block-uniform-bins1025", _pinned(
        uniform(rng, 24, 4, 3, 1025, count_hi=300), "block-a-lane",
        "chunk-edge", "two-words")))
    out.append(("last-chunk-only", _pinned(_last_chunk_only(rng),
                                           "block-a-lane")))
    out.append(("none-admits", _pinned(_none_admits(rng), "warp-a-lane")))
    out.append(("last-class-column", _pinned(_last_class_column(rng),
                                             "warp-a-lane", "held-below-r")))
    out.append(("negative-remainders", _pinned(_negative_remainders(rng),
                                               "block-a-lane")))
    out.append(("division-edges", _pinned(_division_edges(rng),
                                          "block-a-lane")))
    out.append(("unstaged-table", _pinned(_many_classes(rng), "warp-a-lane",
                                          "unstaged", "held-below-r")))
    # every column held: a lane's 8,192 bins x 8 columns pass shared memory
    c = uniform(rng, 4, 8, 140, 8192, hi=5, cap_hi=40, count_hi=50)
    c["reqs"][:, 4:] = 1.0
    out.append(("warp-workspace", _pinned(c, "warp-a-lane", "workspace")))
    # every one of 8 columns held (past the columns kept in registers),
    # the loads in the workspace
    c = per_bin(rng, 8, 8, 16385, hi=4000, cap_hi=32000, count_hi=400)
    c["reqs"][:, 4:] = rng.integers(1, 50, (8, 4))
    out.append(("per-bin-wide-workspace", _pinned(
        c, "block-a-lane", "workspace")))
    # 2^19 node rows: the summaries too pass shared memory
    out.append(("per-bin-524288", _pinned(per_bin(
        rng, 6, 4, 2 ** 19, hi=4000, cap_hi=32000, count_hi=3000),
        "block-a-lane", "summaries-in-workspace")))
    # the loads in the workspace at one, two and three held columns (each
    # its own registers' path): three as the live capacity cell's stage 1
    # holds them, over 16,385 node rows
    c = per_bin(rng, 12, 4, 30000, hi=4000, cap_hi=32000, count_hi=400)
    c["reqs"][:, 1:] = 0.0
    out.append(("per-bin-held1-workspace", _pinned(
        c, "block-a-lane", "workspace", "held-1", "held-below-r")))
    c = per_bin(rng, 12, 4, 16385, hi=4000, cap_hi=32000, count_hi=400)
    c["reqs"][:, 2:] = 0.0
    out.append(("per-bin-held2-workspace", _pinned(
        c, "block-a-lane", "workspace", "held-2", "held-below-r")))
    out.append(("per-bin-capacity-16385", _pinned(
        _capacity_rows(rng, 16385), "block-a-lane", "workspace", "held-3",
        "held-below-r")))
    return out
