"""Timing helpers for kernel K1 on the card: L2 cold or warm, and its bound.

chip_smoke.py times K1 with these, and tools/k1_compare.py times K1's
variants, or K1 against another K1 source, in turns in one process.  Cold
means FLUSH_BYTES are written between launches, outside the CUDA events, so
no input is left in the 50 MB L2; warm means launches back to back on the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 20_000_000    # an idle kernel that lets the host queue ahead


def bound_ms(B: int, N: int) -> float:
    """K1's least time on the card: its bytes (scores and mask read once,
    hosts and feasible written once) over the memory rate."""
    return (B * N * 5 + B * 5) / HBM_BYTES_PER_S * 1e3


def time_ms(fn, reps: int = 50, cold: bool = True) -> float:
    """Median device milliseconds of fn() between two CUDA events.  Cold:
    FLUSH_BYTES are written before each launch, outside the events."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()                                   # warm-up: builds, first launch
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in events:
        if cold:
            flush.fill_(1)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))
