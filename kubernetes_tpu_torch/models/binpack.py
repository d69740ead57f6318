"""First-fit binpack (PyTorch port of the JAX package's models/binpack.py).

Only the piece the placement-quality observatory needs is ported:
`binpack_ffd`, the first-fit scan the regret counterfactual runs over each
node's remaining free capacity (runtime/quality.py), and `placed_by_pod`.
The class-compressed counts, the shape sweep and the capacity planner's
callers come with a later slice (ROADMAP A10).

  * one step per pod, in `order`; state = the bin load matrix [max_bins, R];
  * per step: fits = load + req <= cap over every bin, the pod goes into
    the FIRST bin that fits (opening a new bin is fitting into a zero row).

`binpack_ffd` launches kernel K4 (kernels/binpack_ffd.cu) on CUDA tensors;
`binpack_ffd_plain` is its plain twin, which CPU tensors take.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch import kernels

# integer-exactness ceiling of the reference's count-carrying kernel: all
# request / capacity values integer-valued and strictly below this
INT_EXACT_LIMIT = float(2 ** 24)


def _bins(pod_reqs, capacity, max_bins):
    """(capacity as [max_bins, R], max_bins) as the reference reads them:
    a 2-D capacity is one row a bin (max_bins must equal its rows), a 1-D
    one is every bin's."""
    if capacity.dim() == 2:
        if max_bins is not None and max_bins != capacity.shape[0]:
            raise ValueError(f"max_bins {max_bins} != capacity rows "
                             f"{capacity.shape[0]}")
        return capacity, capacity.shape[0]
    nb = 1024 if max_bins is None else int(max_bins)
    return capacity[None, :].expand(nb, pod_reqs.shape[1]), nb


def _order(pod_reqs, order):
    if order is None:
        return torch.arange(pod_reqs.shape[0], dtype=torch.int32,
                            device=pod_reqs.device)
    return order.to(torch.int32)


def binpack_ffd_plain(pod_reqs, capacity, max_bins=None, order=None):
    """K4's plain twin: first-fit of pod_reqs f32[P, R] into bins of
    `capacity`, f32[max_bins, R] (per-bin: a zero row is a full bin) or
    f32[R] (every bin; max_bins bins, 1,024 if not given).  Pods are taken
    in `order` i32[P] (default: their own order; a negative entry wraps
    once and an entry out of range clamps, as the reference indexes); zero
    rows are skipped.  Returns (n_bins i32[], loads f32[max_bins, R],
    placed bool[P]); placed[k] refers to pod order[k] (see
    placed_by_pod)."""
    cap, nb = _bins(pod_reqs, capacity, max_bins)
    P = pod_reqs.shape[0]
    loads = torch.zeros((nb, pod_reqs.shape[1]), dtype=torch.float32,
                        device=pod_reqs.device)
    # a pod without a positive request is skipped (placed, nothing added)
    real = torch.any(pod_reqs > 0, dim=-1).tolist()
    placed = []
    for oi in _order(pod_reqs, order).tolist():
        oi = min(max(oi + P if oi < 0 else oi, 0), P - 1)
        if not real[oi]:
            placed.append(True)
            continue
        req = pod_reqs[oi]
        fits = torch.all(loads + req[None, :] <= cap, dim=-1)
        idx = int(torch.argmax(fits.to(torch.uint8)))   # the first fit
        ok = bool(fits[idx])
        if ok:
            loads[idx] = loads[idx] + req
        placed.append(ok)
    placed = torch.tensor(placed, dtype=torch.bool, device=pod_reqs.device)
    used = torch.sum(torch.any(loads > 0, dim=-1), dtype=torch.int32)
    return used, loads, placed


def binpack_ffd(pod_reqs, capacity, max_bins=None, order=None):
    """binpack_ffd_plain's contract: CUDA tensors launch K4, CPU tensors
    take the plain twin."""
    if pod_reqs.is_cuda:
        if capacity.dim() != 2 and max_bins is None:
            max_bins = 1024
        return kernels.binpack_ffd(pod_reqs, capacity,
                                   _order(pod_reqs, order), max_bins)
    return binpack_ffd_plain(pod_reqs, capacity, max_bins, order)


def placed_by_pod(placed, order=None):
    """Scatter binpack_ffd's scan-position-aligned `placed` flags back to
    POD indices: out[p] says whether pod p (row p of pod_reqs) was placed.
    With the default identity order the flags pass through unchanged."""
    placed = np.asarray(placed)
    if order is None:
        return placed.copy()
    order = np.asarray(order)
    if order.shape[0] != placed.shape[0]:
        raise ValueError(
            f"order length {order.shape[0]} != placed length "
            f"{placed.shape[0]} (placed is scan-position aligned)"
        )
    out = np.empty_like(placed)
    out[order] = placed
    return out
