"""Timing helpers for the kernels on the card: L2 cold or warm, K1's and
K2's bounds, and the stream operations of one call.

chip_smoke.py times K1 and K2 with these; tools/k1_compare.py and
tools/k2_compare.py time a kernel against its variants or an older source
in turns in one process.  Cold means FLUSH_BYTES are written between
launches, outside the CUDA events, so no input is left in the 50 MB L2;
warm means launches back to back on the same inputs.
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


def k2_bound_ms(a) -> float:
    """K2's least time on the card: the bytes it must move over the memory
    rate, counted from this call's data (a: preempt_one's 15 tensors).
    Read once: the candidate mask, pod_req, the arena's node column (which
    candidate rows hold a pod), the slot list, the volume tables, and for
    the candidate rows only their [E] rows of the two node tables and their
    initial credit, and for the listed pods on candidate rows their
    priority, request row, PDB flag, start and volume ids; no other row
    changes the result.  Written once: the M-byte mask and three int32
    scalars."""
    req, _, _, cand, node, _, _ = a[:7]
    slots, slot_vids, vt, tot, lst, init = a[9:]
    N, E = req.shape
    n_cand = int(cand.sum())
    m = slots[slots >= 0].long()
    on = node[m].long()
    on = on[(on >= 0) & (on < N)]
    listed = int(cand[on].sum())
    nbytes = (N + E * 4 + node.numel() * 4 + slots.numel() * 4
              + (vt.numel() + tot.numel() + lst.numel()) * 4
              + n_cand * (2 * E * 4 + init.shape[1] * 4)
              + listed * (4 + E * 4 + 1 + 4 + slot_vids.shape[1] * 4)
              + node.numel() + 3 * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def stream_ops(fn) -> dict:
    """{name: count} of the device activities (kernel launches, memsets
    and copies) of one warm fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops[e.name] = ops.get(e.name, 0) + 1
    return ops


def time_ms(fn, reps: int = 50, cold: bool = True, before=None) -> float:
    """Median device milliseconds of fn() between two CUDA events.  Cold:
    FLUSH_BYTES are written before each launch, outside the events.
    before(), if given, runs before each launch (and its flush), outside
    the events: it puts back what fn() writes in place."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    if before is not None:
        before()
    fn()                                   # warm-up: builds, first launch
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in events:
        if before is not None:
            before()
        if cold:
            flush.fill_(1)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))
