"""The cases kernels K14 (round_commit.cu) and K15 (round_fold.cu) are
held to, in one place: kernels/k13_cases.py's worlds, run through the
speculative engine, whose plain rounds are K15 between the score pass and
the selector and K14 after it.

tests/test_torch_round_commit.py runs the port's speculative engine on
the CPU (its rounds through the twins, models/speculative.py
round_fold_plain and round_commit_plain) against the jitted JAX
speculative engine on every case, bit for bit: hosts, the committed
columns, the top-k, the rounds and the redo flag; chip_smoke.py runs the
engine on the card through the kernels and through the twins on all of
them and holds the two equal.  The cases add to K13's: a first round
that bounces on the 2-slot fleet (the batch is redone), nominated claims
that bounce a proposer, in-batch ports that bounce one, shipped per-pod
spread counts, and a plain batch that needs no redo.  numpy only.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.kernels.k11_cases import world
from kubernetes_tpu_torch.kernels.k13_cases import (
    WRAP, cases as k13_cases, open_world, run_case, scan_case)

__all__ = ["cases", "run_case"]


def cases():
    """[(name, case)] of every K14 / K15 case, in a fixed order."""
    out = list(k13_cases())
    w = open_world(world(320, 24, 40))
    w["cluster"]["requested"][:] = 0.0
    out.append(("no-redo", scan_case(w, 420, topk=3)))
    w = open_world(world(321, 32, 12))
    w["cluster"]["allocatable"][:, 3] = 3.0       # three pod slots a node
    out.append(("bounce-and-redo", scan_case(w, 421, last_index0=WRAP)))
    w = open_world(world(322, 24, 40, lean_spread=False))
    out.append(("dense-spread-rounds", scan_case(w, 422, pct=0)))
    return out


def spread_lean(case) -> bool:
    return case["pods"]["spread_counts"].shape[1] != np.asarray(
        case["cluster"]["valid"]).shape[0]
